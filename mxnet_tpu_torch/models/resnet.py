"""ResNet v2 (pre-activation): the symbol factory of
mxnet_tpu/models/resnet.py, built with the port's symbol API.

Reference: example/image-classification/symbols/resnet.py — the network
behind the headline BASELINE numbers (ResNet-50: 109 img/s on K80,
top-1 0.7527).  Same architecture: pre-act units, bottleneck for
depth >= 50, stem/stage layout per num_layers, BN momentum 0.9,
eps 2e-5, fix_gamma=False.
"""
from .. import symbol as sym

BN_MOM = 0.9
BN_EPS = 2e-5


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + '_bn1')
        act1 = sym.Activation(bn1, act_type='relu', name=name + '_relu1')
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + '_conv1')
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + '_bn2')
        act2 = sym.Activation(bn2, act_type='relu', name=name + '_relu2')
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + '_conv2')
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + '_bn3')
        act3 = sym.Activation(bn3, act_type='relu', name=name + '_relu3')
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + '_conv3')
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + '_sc')
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=BN_EPS, momentum=BN_MOM,
                        name=name + '_bn1')
    act1 = sym.Activation(bn1, act_type='relu', name=name + '_relu1')
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + '_conv1')
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=BN_EPS, momentum=BN_MOM,
                        name=name + '_bn2')
    act2 = sym.Activation(bn2, act_type='relu', name=name + '_relu2')
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + '_conv2')
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + '_sc')
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, dtype='float32'):
    num_unit = len(units)
    assert num_unit == num_stages
    data = sym.Variable('data')
    if dtype != 'float32':
        # mixed precision (reference --dtype float16 flow,
        # common/fit.py): cast after data, cast back before the loss;
        # params downstream allocate in the compute dtype via infer_type
        data = sym.Cast(data, dtype=dtype, name='cast_data')
    data = sym.BatchNorm(data, fix_gamma=True, eps=BN_EPS, momentum=BN_MOM,
                         name='bn_data')
    (nchannel, height, width) = image_shape
    if height <= 32:  # CIFAR
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name='conv0')
    else:  # ImageNet
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name='conv0')
        body = sym.BatchNorm(body, fix_gamma=False, eps=BN_EPS,
                             momentum=BN_MOM, name='bn0')
        body = sym.Activation(body, act_type='relu', name='relu0')
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type='max')

    for i in range(num_stages):
        stride = (1, 1) if (i == 0 and height > 32) else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name='stage%d_unit%d' % (i + 1, 1),
                             bottle_neck=bottle_neck)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name='stage%d_unit%d' % (i + 1, j + 2),
                                 bottle_neck=bottle_neck)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=BN_EPS, momentum=BN_MOM,
                        name='bn1')
    relu1 = sym.Activation(bn1, act_type='relu', name='relu1')
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type='avg', name='pool1')
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name='fc1')
    if dtype != 'float32':
        fc1 = sym.Cast(fc1, dtype='float32', name='cast_out')
    return sym.SoftmaxOutput(fc1, name='softmax')


def get_symbol(num_classes=1000, num_layers=50, image_shape='3,224,224',
               dtype='float32', **kwargs):
    """Stage layout per depth (reference resnet.py get_symbol)."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(','))
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError('no experiments done on num_layers %d'
                             % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        if num_layers == 18:
            units = [2, 2, 2, 2]
        elif num_layers == 34:
            units = [3, 4, 6, 3]
        elif num_layers == 50:
            units = [3, 4, 6, 3]
        elif num_layers == 101:
            units = [3, 4, 23, 3]
        elif num_layers == 152:
            units = [3, 8, 36, 3]
        elif num_layers == 200:
            units = [3, 24, 36, 3]
        elif num_layers == 269:
            units = [3, 30, 48, 8]
        else:
            raise ValueError('no experiments done on num_layers %d'
                             % num_layers)
    return resnet(dtype=dtype, units=units, num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=image_shape, bottle_neck=bottle_neck)
