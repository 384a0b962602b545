"""Inception-BN: the symbol factory of mxnet_tpu/models/inception_bn.py
(reference example/image-classification/symbols/inception-bn.py, the
network of the reference's 152 img/s, top-1 0.7245 baseline)."""
from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                name=None, suffix=''):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name='conv_%s%s' % (name, suffix))
    bn = sym.BatchNorm(conv, name='bn_%s%s' % (name, suffix))
    act = sym.Activation(bn, act_type='relu',
                         name='relu_%s%s' % (name, suffix))
    return act


def InceptionFactoryA(data, num_1x1, num_3x3red, num_3x3, num_d3x3red,
                      num_d3x3, pool, proj, name):
    c1x1 = ConvFactory(data, num_1x1, (1, 1), name=('%s_1x1' % name))
    c3x3r = ConvFactory(data, num_3x3red, (1, 1),
                        name=('%s_3x3' % name), suffix='_reduce')
    c3x3 = ConvFactory(c3x3r, num_3x3, (3, 3), pad=(1, 1),
                       name=('%s_3x3' % name))
    cd3x3r = ConvFactory(data, num_d3x3red, (1, 1),
                         name=('%s_double_3x3' % name), suffix='_reduce')
    cd3x3 = ConvFactory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_0' % name))
    cd3x3 = ConvFactory(cd3x3, num_d3x3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_1' % name))
    pooling = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool, name=('%s_pool_%s_pool'
                                                % (pool, name)))
    cproj = ConvFactory(pooling, proj, (1, 1), name=('%s_proj' % name))
    return sym.Concat(c1x1, c3x3, cd3x3, cproj,
                      name='ch_concat_%s_chconcat' % name)


def InceptionFactoryB(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3,
                      name):
    c3x3r = ConvFactory(data, num_3x3red, (1, 1),
                        name=('%s_3x3' % name), suffix='_reduce')
    c3x3 = ConvFactory(c3x3r, num_3x3, (3, 3), pad=(1, 1), stride=(2, 2),
                       name=('%s_3x3' % name))
    cd3x3r = ConvFactory(data, num_d3x3red, (1, 1),
                         name=('%s_double_3x3' % name), suffix='_reduce')
    cd3x3 = ConvFactory(cd3x3r, num_d3x3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_0' % name))
    cd3x3 = ConvFactory(cd3x3, num_d3x3, (3, 3), pad=(1, 1), stride=(2, 2),
                        name=('%s_double_3x3_1' % name))
    pooling = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type='max',
                          name=('max_pool_%s_pool' % name))
    return sym.Concat(c3x3, cd3x3, pooling,
                      name='ch_concat_%s_chconcat' % name)


def get_symbol(num_classes=1000, dtype='float32', **kwargs):
    data = sym.Variable('data')
    if dtype != 'float32':
        # mixed precision, same flow as models/resnet.py: cast the
        # input once; params downstream allocate in the compute dtype
        data = sym.Cast(data, dtype=dtype, name='cast_data')
    conv1 = ConvFactory(data, 64, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                        name='conv1')
    pool1 = sym.Pooling(conv1, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type='max')
    conv2red = ConvFactory(pool1, 64, kernel=(1, 1), name='conv2red')
    conv2 = ConvFactory(conv2red, 192, kernel=(3, 3), pad=(1, 1),
                        name='conv2')
    pool2 = sym.Pooling(conv2, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type='max')
    in3a = InceptionFactoryA(pool2, 64, 64, 64, 64, 96, 'avg', 32, '3a')
    in3b = InceptionFactoryA(in3a, 64, 64, 96, 64, 96, 'avg', 64, '3b')
    in3c = InceptionFactoryB(in3b, 128, 160, 64, 96, '3c')
    in4a = InceptionFactoryA(in3c, 224, 64, 96, 96, 128, 'avg', 128, '4a')
    in4b = InceptionFactoryA(in4a, 192, 96, 128, 96, 128, 'avg', 128, '4b')
    in4c = InceptionFactoryA(in4b, 160, 128, 160, 128, 160, 'avg', 128, '4c')
    in4d = InceptionFactoryA(in4c, 96, 128, 192, 160, 192, 'avg', 128, '4d')
    in4e = InceptionFactoryB(in4d, 128, 192, 192, 256, '4e')
    in5a = InceptionFactoryA(in4e, 352, 192, 320, 160, 224, 'avg', 128, '5a')
    in5b = InceptionFactoryA(in5a, 352, 192, 320, 192, 224, 'max', 128, '5b')
    avg = sym.Pooling(in5b, kernel=(7, 7), stride=(1, 1), global_pool=True,
                      pool_type='avg')
    flatten = sym.Flatten(avg)
    fc1 = sym.FullyConnected(flatten, num_hidden=num_classes)
    if dtype != 'float32':
        fc1 = sym.Cast(fc1, dtype='float32', name='cast_out')
    return sym.SoftmaxOutput(fc1, name='softmax')
