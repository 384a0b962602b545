"""Inception-v3: the symbol factory of mxnet_tpu/models/inception_v3.py
(reference example/image-classification/symbols/inception-v3.py), for
299x299 input. Every conv is a no-bias conv -> BatchNorm pair, which a
bf16 train step runs on the conv + statistics kernel."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, suffix=''):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name='%s%s_conv2d' % (name, suffix))
    bn = sym.BatchNorm(c, eps=2e-5, fix_gamma=False,
                       name='%s%s_batchnorm' % (name, suffix))
    return sym.Activation(bn, act_type='relu',
                          name='%s%s_relu' % (name, suffix))


def _pool(data, kernel, stride, pool_type, pad=(0, 0), name=None):
    return sym.Pooling(data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def _inception_a(data, n1, n5r, n5, n3r, n3, proj, name):
    t1 = _conv(data, n1, name='%s_conv' % name)
    t5 = _conv(data, n5r, name='%s_tower' % name, suffix='_conv')
    t5 = _conv(t5, n5, kernel=(5, 5), pad=(2, 2),
               name='%s_tower' % name, suffix='_conv_1')
    t3 = _conv(data, n3r, name='%s_tower_1' % name, suffix='_conv')
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1),
               name='%s_tower_1' % name, suffix='_conv_1')
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1),
               name='%s_tower_1' % name, suffix='_conv_2')
    tp = _pool(data, (3, 3), (1, 1), 'avg', pad=(1, 1),
               name='%s_pool' % name)
    tp = _conv(tp, proj, name='%s_tower_2' % name, suffix='_conv')
    return sym.Concat(t1, t5, t3, tp, name='ch_concat_%s_chconcat' % name)


def _inception_b(data, n3r, n3, name):
    t3 = _conv(data, n3, kernel=(3, 3), stride=(2, 2),
               name='%s_conv' % name)
    td = _conv(data, n3r, name='%s_tower' % name, suffix='_conv')
    td = _conv(td, n3, kernel=(3, 3), pad=(1, 1),
               name='%s_tower' % name, suffix='_conv_1')
    td = _conv(td, n3, kernel=(3, 3), stride=(2, 2),
               name='%s_tower' % name, suffix='_conv_2')
    tp = _pool(data, (3, 3), (2, 2), 'max', name='max_pool_%s_pool' % name)
    return sym.Concat(t3, td, tp, name='ch_concat_%s_chconcat' % name)


def _inception_c(data, n1, n7r, n7, name):
    t1 = _conv(data, n1, name='%s_conv' % name)
    t7 = _conv(data, n7r, name='%s_tower' % name, suffix='_conv')
    t7 = _conv(t7, n7r, kernel=(1, 7), pad=(0, 3),
               name='%s_tower' % name, suffix='_conv_1')
    t7 = _conv(t7, n7, kernel=(7, 1), pad=(3, 0),
               name='%s_tower' % name, suffix='_conv_2')
    td = _conv(data, n7r, name='%s_tower_1' % name, suffix='_conv')
    td = _conv(td, n7r, kernel=(7, 1), pad=(3, 0),
               name='%s_tower_1' % name, suffix='_conv_1')
    td = _conv(td, n7r, kernel=(1, 7), pad=(0, 3),
               name='%s_tower_1' % name, suffix='_conv_2')
    td = _conv(td, n7r, kernel=(7, 1), pad=(3, 0),
               name='%s_tower_1' % name, suffix='_conv_3')
    td = _conv(td, n7, kernel=(1, 7), pad=(0, 3),
               name='%s_tower_1' % name, suffix='_conv_4')
    tp = _pool(data, (3, 3), (1, 1), 'avg', pad=(1, 1),
               name='%s_pool' % name)
    tp = _conv(tp, n1, name='%s_tower_2' % name, suffix='_conv')
    return sym.Concat(t1, t7, td, tp, name='ch_concat_%s_chconcat' % name)


def _inception_d(data, n3r, n3, n7r, n7, name):
    t3 = _conv(data, n3r, name='%s_tower' % name, suffix='_conv')
    t3 = _conv(t3, n3, kernel=(3, 3), stride=(2, 2),
               name='%s_tower' % name, suffix='_conv_1')
    t7 = _conv(data, n7r, name='%s_tower_1' % name, suffix='_conv')
    t7 = _conv(t7, n7r, kernel=(1, 7), pad=(0, 3),
               name='%s_tower_1' % name, suffix='_conv_1')
    t7 = _conv(t7, n7r, kernel=(7, 1), pad=(3, 0),
               name='%s_tower_1' % name, suffix='_conv_2')
    t7 = _conv(t7, n7, kernel=(3, 3), stride=(2, 2),
               name='%s_tower_1' % name, suffix='_conv_3')
    tp = _pool(data, (3, 3), (2, 2), 'max', name='max_pool_%s_pool' % name)
    return sym.Concat(t3, t7, tp, name='ch_concat_%s_chconcat' % name)


def _inception_e(data, n1, n3, n3x3, proj, name, pool_type='avg'):
    t1 = _conv(data, n1, name='%s_conv' % name)
    t3 = _conv(data, n3, name='%s_tower' % name, suffix='_conv')
    t3a = _conv(t3, n3x3, kernel=(1, 3), pad=(0, 1),
                name='%s_tower' % name, suffix='_mixed_conv')
    t3b = _conv(t3, n3x3, kernel=(3, 1), pad=(1, 0),
                name='%s_tower' % name, suffix='_mixed_conv_1')
    td = _conv(data, 448, name='%s_tower_1' % name, suffix='_conv')
    td = _conv(td, n3x3, kernel=(3, 3), pad=(1, 1),
               name='%s_tower_1' % name, suffix='_conv_1')
    tda = _conv(td, n3x3, kernel=(1, 3), pad=(0, 1),
                name='%s_tower_1' % name, suffix='_mixed_conv')
    tdb = _conv(td, n3x3, kernel=(3, 1), pad=(1, 0),
                name='%s_tower_1' % name, suffix='_mixed_conv_1')
    tp = _pool(data, (3, 3), (1, 1), pool_type, pad=(1, 1),
               name='%s_pool' % name)
    tp = _conv(tp, proj, name='%s_tower_2' % name, suffix='_conv')
    return sym.Concat(t1, t3a, t3b, tda, tdb, tp,
                      name='ch_concat_%s_chconcat' % name)


def get_symbol(num_classes=1000, dtype='float32', **kwargs):
    data = sym.Variable('data')
    if dtype != 'float32':
        # mixed precision, same flow as models/resnet.py
        data = sym.Cast(data, dtype=dtype, name='cast_data')
    # stem
    x = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name='conv')
    x = _conv(x, 32, kernel=(3, 3), name='conv_1')
    x = _conv(x, 64, kernel=(3, 3), pad=(1, 1), name='conv_2')
    x = _pool(x, (3, 3), (2, 2), 'max', name='pool')
    x = _conv(x, 80, name='conv_3')
    x = _conv(x, 192, kernel=(3, 3), name='conv_4')
    x = _pool(x, (3, 3), (2, 2), 'max', name='pool1')
    # inception blocks
    x = _inception_a(x, 64, 48, 64, 64, 96, 32, 'mixed')
    x = _inception_a(x, 64, 48, 64, 64, 96, 64, 'mixed_1')
    x = _inception_a(x, 64, 48, 64, 64, 96, 64, 'mixed_2')
    x = _inception_b(x, 64, 96, 'mixed_3')
    x = _inception_c(x, 192, 128, 192, 'mixed_4')
    x = _inception_c(x, 192, 160, 192, 'mixed_5')
    x = _inception_c(x, 192, 160, 192, 'mixed_6')
    x = _inception_c(x, 192, 192, 192, 'mixed_7')
    x = _inception_d(x, 192, 320, 192, 192, 'mixed_8')
    x = _inception_e(x, 320, 384, 384, 192, 'mixed_9', 'avg')
    x = _inception_e(x, 320, 384, 384, 192, 'mixed_10', 'max')
    # head
    x = sym.Pooling(x, kernel=(8, 8), stride=(1, 1), pool_type='avg',
                    global_pool=True, name='global_pool')
    x = sym.Flatten(x, name='flatten')
    x = sym.FullyConnected(x, num_hidden=num_classes, name='fc1')
    if dtype != 'float32':
        x = sym.Cast(x, dtype='float32', name='cast_out')
    return sym.SoftmaxOutput(x, name='softmax')
