"""ResNeXt: the symbol factory of mxnet_tpu/models/resnext.py (reference
example/image-classification/symbols/resnext.py): ResNet bottlenecks
with grouped 3x3 convolutions (cardinality). The 1x1 convs form conv ->
BatchNorm pairs for the conv + statistics kernel; the grouped convs
run as F.conv2d."""
from .. import symbol as sym


def _bottleneck(data, num_filter, stride, dim_match, name, num_group,
                bottle_neck_width):
    mid = int(num_filter * bottle_neck_width * num_group / 256)
    c1 = sym.Convolution(data, num_filter=mid, kernel=(1, 1),
                         no_bias=True, name=name + '_conv1')
    b1 = sym.BatchNorm(c1, fix_gamma=False, eps=2e-5, name=name + '_bn1')
    a1 = sym.Activation(b1, act_type='relu', name=name + '_relu1')
    c2 = sym.Convolution(a1, num_filter=mid, kernel=(3, 3),
                         stride=stride, pad=(1, 1), num_group=num_group,
                         no_bias=True, name=name + '_conv2')
    b2 = sym.BatchNorm(c2, fix_gamma=False, eps=2e-5, name=name + '_bn2')
    a2 = sym.Activation(b2, act_type='relu', name=name + '_relu2')
    c3 = sym.Convolution(a2, num_filter=num_filter, kernel=(1, 1),
                         no_bias=True, name=name + '_conv3')
    b3 = sym.BatchNorm(c3, fix_gamma=False, eps=2e-5, name=name + '_bn3')
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True,
                             name=name + '_sc')
        shortcut = sym.BatchNorm(sc, fix_gamma=False, eps=2e-5,
                                 name=name + '_sc_bn')
    return sym.Activation(b3 + shortcut, act_type='relu',
                          name=name + '_relu')


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               bottle_neck_width=4, image_shape='3,224,224',
               dtype='float32', **kwargs):
    """ResNeXt-{50,101,152} (num_group x bottle_neck_width d,
    e.g. 32x4d, 64x4d)."""
    stages = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
              152: [3, 8, 36, 3]}[num_layers]
    filters = [256, 512, 1024, 2048]

    data = sym.Variable('data')
    if dtype != 'float32':
        # mixed precision, same flow as models/resnet.py
        data = sym.Cast(data, dtype=dtype, name='cast_data')
    x = sym.Convolution(data, num_filter=64, kernel=(7, 7), stride=(2, 2),
                        pad=(3, 3), no_bias=True, name='conv0')
    x = sym.BatchNorm(x, fix_gamma=False, eps=2e-5, name='bn0')
    x = sym.Activation(x, act_type='relu', name='relu0')
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type='max', name='pool0')
    for i, (n, f) in enumerate(zip(stages, filters)):
        stride = (1, 1) if i == 0 else (2, 2)
        x = _bottleneck(x, f, stride, False,
                        'stage%d_unit1' % (i + 1), num_group,
                        bottle_neck_width)
        for j in range(1, n):
            x = _bottleneck(x, f, (1, 1), True,
                            'stage%d_unit%d' % (i + 1, j + 1), num_group,
                            bottle_neck_width)
    x = sym.Pooling(x, kernel=(7, 7), global_pool=True, pool_type='avg',
                    name='pool1')
    x = sym.Flatten(x)
    x = sym.FullyConnected(x, num_hidden=num_classes, name='fc1')
    if dtype != 'float32':
        x = sym.Cast(x, dtype='float32', name='cast_out')
    return sym.SoftmaxOutput(x, name='softmax')
