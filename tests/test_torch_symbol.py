"""The port's symbol layer (mxnet_tpu_torch.symbol) against the JAX
package's, on the CPU: the same graphs, built in each package under a
fresh name manager, give the same JSON string (and each package loads
the other's), the same argument, aux and output names, and the same
shape and dtype inference, for the bfloat16 ResNet-50 symbol and three
small graphs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import resnet as jresnet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet


def _mlp(pkg):
    sym = pkg.symbol
    data = sym.Variable('data')
    fc1 = sym.FullyConnected(data, num_hidden=16)
    act = sym.Activation(fc1, act_type='tanh')
    fc2 = sym.FullyConnected(act, num_hidden=3, no_bias=True,
                             flatten=False)
    return sym.SoftmaxOutput(fc2, normalization='batch', use_ignore=True)


def _convnet(pkg):
    sym = pkg.symbol
    data = sym.Variable('data', lr_mult=0.5)
    with pkg.AttrScope(ctx_group='stage1'):
        conv = sym.Convolution(data, num_filter=8, kernel=(3, 3),
                               stride=(2, 2), pad=(1, 1))
    bn = sym.BatchNorm(conv, fix_gamma=False, output_mean_var=True,
                       eps=1e-4)
    act = sym.Activation(bn[0], act_type='relu')
    pool = sym.Pooling(act, kernel=(3, 3), stride=(2, 2),
                       pooling_convention='full', pool_type='avg')
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=5, name='head')
    out = sym.SoftmaxOutput(fc, name='softmax')
    return sym.Group([out, sym.BlockGrad(bn[1])])


def _arith(pkg):
    sym = pkg.symbol
    a = sym.Variable('a')
    b = sym.Variable('b', shape=(3, 4))
    c = sym.Variable('c', dtype='float16')
    d = (a + b) * 2.0 - b / (a + 1.0)
    e = sym.Cast(d, dtype='float16') * c
    return sym.Group([e, sym.sum(d, axis=1), -a])


def _resnet50(pkg):
    zoo = jresnet if pkg is jmx else tresnet
    return zoo.get_symbol(num_classes=1000, num_layers=50,
                          image_shape='3,224,224', dtype='bfloat16')


# graph factory, full shapes, a partial shape set
GRAPHS = {
    'mlp': (_mlp, dict(data=(8, 20)), dict(data=(0, 20))),
    'convnet': (_convnet, dict(data=(4, 3, 16, 16)),
                dict(data=(4, 3, 16, 0))),
    'arith': (_arith, dict(a=(3, 4), c=(3, 4)), dict(c=(0, 4))),
    'resnet50_bf16': (_resnet50, dict(data=(256, 3, 224, 224)),
                      dict(data=(0, 3, 224, 224))),
}


def _build(pkg, name):
    with pkg.NameManager():
        return GRAPHS[name][0](pkg)


def _dtype_names(types):
    return [np.dtype(t).name if not isinstance(t, torch.dtype)
            else str(t).replace('torch.', '') for t in types]


@pytest.fixture(scope='module', params=sorted(GRAPHS))
def pair(request):
    return request.param, _build(jmx, request.param), \
        _build(mx, request.param)


def test_tojson_is_the_same_string(pair):
    _, ref, got = pair
    assert got.tojson() == ref.tojson()


def test_each_package_loads_the_others_json(pair):
    _, ref, got = pair
    assert tsym.load_json(ref.tojson()).tojson() == ref.tojson()
    assert jsym.load_json(got.tojson()).tojson() == got.tojson()


def test_names_match(pair):
    _, ref, got = pair
    assert got.list_arguments() == ref.list_arguments()
    assert got.list_auxiliary_states() == ref.list_auxiliary_states()
    assert got.list_outputs() == ref.list_outputs()
    assert got.get_internals().list_outputs() == \
        ref.get_internals().list_outputs()
    assert got.attr_dict() == ref.attr_dict()


def test_infer_shape_matches(pair):
    name, ref, got = pair
    full, partial = GRAPHS[name][1:]
    assert got.infer_shape(**full) == ref.infer_shape(**full)
    assert got.infer_shape_partial(**partial) == \
        ref.infer_shape_partial(**partial)


def test_infer_type_matches(pair):
    _, ref, got = pair
    for mine, theirs in zip(got.infer_type(), ref.infer_type()):
        assert _dtype_names(mine) == _dtype_names(theirs)


def test_resnet50_counts_33_conv_bn_pairs():
    from mxnet_tpu_torch.executor import conv_bn_pairs
    s = _build(mx, 'resnet50_bf16')
    topo = s._topo()
    pairs = conv_bn_pairs(topo, s._outputs)
    convs = [n for n in topo if n.op is not None
             and n.op.name == 'Convolution']
    assert (len(convs), len(pairs)) == (53, 33)
    names = {topo[c].name: topo[b].name for c, b in pairs.items()}
    assert names['conv0'] == 'bn0'
    assert names['stage3_unit1_conv2'] == 'stage3_unit1_bn3'
    assert not any(k.endswith(('_conv3', '_sc')) for k in names)


def test_save_load_and_arithmetic_eval(tmp_path):
    s = _build(mx, 'arith')
    path = str(tmp_path / 'arith-symbol.json')
    s.save(path)
    again = tsym.load(path)
    assert again.tojson() == s.tojson()
    assert len(json.loads(again.tojson())['heads']) == 3
    rng = np.random.RandomState(0)
    vals = {k: rng.rand(3, 4).astype(np.float32) + 0.5 for k in 'abc'}
    with mx.cpu():
        outs = again.eval(ctx=mx.cpu(), **{
            k: mx.nd.array(v, dtype='float16' if k == 'c' else None)
            for k, v in vals.items()})
    jouts = _build(jmx, 'arith').eval(ctx=jmx.cpu(), **{
        k: jmx.nd.array(v, dtype='float16' if k == 'c' else None)
        for k, v in vals.items()})
    for mine, theirs in zip(outs, jouts):
        np.testing.assert_allclose(mine.asnumpy(),
                                   theirs.asnumpy().astype(mine.dtype),
                                   rtol=1e-3, atol=1e-3)


def test_prefix_and_attr_scope_name_nodes_as_jax():
    def build(pkg):
        with pkg.NameManager():
            with pkg.Prefix('net_'):
                with pkg.AttrScope(lr_mult='2'):
                    x = pkg.symbol.Variable('x')
                    y = pkg.symbol.Activation(x, act_type='sigmoid')
                return pkg.symbol.FullyConnected(y, num_hidden=2)
    ref, got = build(jmx), build(mx)
    assert got.tojson() == ref.tojson()
    assert got.list_arguments() == ['x', 'net_fullyconnected0_weight',
                                    'net_fullyconnected0_bias']
    assert got.get_internals()['net_activation0_output'].attr('lr_mult') \
        == '2'
