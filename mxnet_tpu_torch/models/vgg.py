"""VGG 11/13/16/19: the symbol factory of mxnet_tpu/models/vgg.py
(reference example/image-classification/symbols/vgg.py)."""
from .. import symbol as sym

VGG_SPEC = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype='float32', **kwargs):
    if num_layers not in VGG_SPEC:
        raise ValueError('invalid num_layers %d' % num_layers)
    layers, filters = VGG_SPEC[num_layers]
    body = sym.Variable('data')
    if dtype != 'float32':
        # mixed precision, same flow as models/resnet.py
        body = sym.Cast(body, dtype=dtype, name='cast_data')
    for i, num in enumerate(layers):
        for j in range(num):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters[i],
                                   name='conv%d_%d' % (i + 1, j + 1))
            if batch_norm:
                body = sym.BatchNorm(body, name='bn%d_%d' % (i + 1, j + 1))
            body = sym.Activation(body, act_type='relu',
                                  name='relu%d_%d' % (i + 1, j + 1))
        body = sym.Pooling(body, pool_type='max', kernel=(2, 2),
                           stride=(2, 2), name='pool%d' % (i + 1))
    flatten = sym.Flatten(body, name='flatten')
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name='fc6')
    relu6 = sym.Activation(fc6, act_type='relu', name='relu6')
    drop6 = sym.Dropout(relu6, p=0.5, name='drop6')
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name='fc7')
    relu7 = sym.Activation(fc7, act_type='relu', name='relu7')
    drop7 = sym.Dropout(relu7, p=0.5, name='drop7')
    fc8 = sym.FullyConnected(drop7, num_hidden=num_classes, name='fc8')
    if dtype != 'float32':
        fc8 = sym.Cast(fc8, dtype='float32', name='cast_out')
    return sym.SoftmaxOutput(fc8, name='softmax')
