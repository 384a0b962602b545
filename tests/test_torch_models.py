"""The port's symbol factories (`models/`) against the JAX package's, on
the CPU.

- Each factory's `tojson()` string-equal to the JAX package's at full
  width (its default input size and classes), in float32 and, where the
  factory takes a dtype, bfloat16.
- Forward and gradients of each network at full width and a cut input
  size, batch 2, float32, the same seeded numpy weights in both
  packages: the output within atol 1e-5. Dropout draws from each
  package's own generator, so its p is set to 0 in both graphs for the
  comparison. The networks without BatchNorm (LeNet, MLP, AlexNet,
  VGG-16) hold every gradient within rtol 1e-3 / atol 1e-5
  (test_torch_resnet.py's float32 bounds). The BatchNorm networks hold
  each moving statistic within 1e-3 in relative norm (a few elements of
  the last layers' means differ by up to 3e-5 of 0.1). They are chaotic
  at initialisation:
  scaling the input by 1 + 2^-22 moves the JAX package's own gradients
  by a median 0.0018 (Inception-BN), 0.05 (Inception-v3) and 0.024
  (ResNeXt-50) in relative norm, so no elementwise bound holds there.
  Their gradients are held by the median over parameters of the
  relative-norm error, within twice the JAX package's own median
  under that perturbation (measured in the test) plus 0.005: a wrong
  graph or op gives errors of order 1.
- The bf16 train forward of Inception-v3 and ResNeXt-50 takes the conv ->
  BatchNorm pair route at every pair `executor.conv_bn_pairs` finds (94
  and 37), each one call of the conv + statistics Function (its plain
  version on the CPU); ResNeXt's grouped convs stay off it.
- `get_symbol('ssd')` builds the JAX package's SSD training symbol
  (tests/test_torch_ssd.py holds the SSD itself).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import cuda_conv, executor

# (factory, kwargs) at full width: each network's JSON
JSON_CASES = {
    'lenet': ('lenet', {}),
    'mlp': ('mlp', {}),
    'alexnet': ('alexnet', {}),
    'alexnet_bf16': ('alexnet', dict(dtype='bfloat16')),
    'vgg16': ('vgg', {}),
    'vgg11_bn_bf16': ('vgg', dict(num_layers=11, batch_norm=True,
                                  dtype='bfloat16')),
    'inception_bn': ('inception-bn', {}),
    'inception_bn_bf16': ('inception_bn', dict(dtype='bfloat16')),
    'inception_v3': ('inception-v3', {}),
    'inception_v3_bf16': ('inception_v3', dict(dtype='bfloat16')),
    'resnext50': ('resnext', {}),
    'resnext101_64x4d_bf16': ('resnext', dict(num_layers=101, num_group=64,
                                              dtype='bfloat16')),
}

# (factory, input shape at batch 2, has BatchNorm): full width, a cut
# input size (the BatchNorm networks' last maps at least 2 x 2, where
# the statistics of 2 images at 1 x 1 make the forward itself chaotic)
STEP_CASES = {
    'lenet': ('lenet', (2, 1, 28, 28), False),
    'mlp': ('mlp', (2, 1, 28, 28), False),
    'alexnet': ('alexnet', (2, 3, 67, 67), False),
    'vgg16': ('vgg', (2, 3, 32, 32), False),
    'inception_bn': ('inception-bn', (2, 3, 64, 64), True),
    'inception_v3': ('inception-v3', (2, 3, 107, 107), True),
    'resnext50': ('resnext', (2, 3, 96, 96), True),
}
# the input's relative perturbation that measures the JAX package's own
# spread, and the BatchNorm networks' gradient gate on it
CHAOS_PERTURBATION = 2.0 ** -22
CHAOS_FACTOR, CHAOS_SLACK = 2.0, 0.005
BN_AUX_REL = 1e-3
F32_OUT = dict(rtol=0.0, atol=1e-5)
F32_STATE = dict(rtol=1e-3, atol=1e-5)
NO_GRAD = ('data', 'softmax_label')

# the train-mode pairs of each network: every conv of Inception-v3; the
# stem, conv1 and conv3 of each of ResNeXt-50's 16 units and the four
# projection shortcuts (the grouped conv2 stays off the route)
ROUTE_CASES = {
    'inception_v3': ('inception-v3', (2, 3, 75, 75), 94),
    'resnext50': ('resnext', (2, 3, 32, 32), 1 + 2 * 16 + 4),
}


def _factory(pkg, network, **kwargs):
    """pkg's symbol of `network`, its automatic names counted from 0 in
    a name manager of its own (as a fresh process counts them)."""
    models = mx.models if pkg is mx else jmodels
    with pkg.NameManager():
        return models.get_symbol(network, **kwargs)


@pytest.mark.parametrize('case', sorted(JSON_CASES))
def test_factory_json_equals_jax(case):
    network, kwargs = JSON_CASES[case]
    assert _factory(mx, network, **kwargs).tojson() == \
        _factory(jmx, network, **kwargs).tojson()


def test_ssd_raises_naming_its_item():
    """get_symbol('ssd') no longer raises (Queue A 4c is ported): it
    builds the JAX package's training symbol, JSON for JSON."""
    assert _factory(mx, 'ssd', num_classes=20).tojson() == \
        _factory(jmx, 'ssd', num_classes=20).tojson()


def no_dropout(pkg, symbol):
    """The symbol with every Dropout's p set to 0."""
    return pkg.sym.load_json(symbol.tojson().replace('"p": "0.5"',
                                                     '"p": "0"'))


def seeded_params(symbol, shapes, seed):
    """He-normal weights, gamma near 1, small beta, biases and moving
    statistics, normal images and integer labels, from numpy, by name."""
    arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**shapes)
    classes = out_shapes[0][1]
    rng = np.random.RandomState(seed)
    args, auxs = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == 'softmax_label':
            args[name] = rng.randint(0, classes, shape)
        elif name.endswith('_weight'):
            fan_in = int(np.prod(shape[1:]))
            args[name] = rng.randn(*shape) * math.sqrt(2.0 / fan_in)
        elif name.endswith('_gamma'):
            args[name] = 1.0 + 0.1 * rng.randn(*shape)
        else:                   # data, betas, biases
            args[name] = rng.randn(*shape) * (1.0 if name == 'data' else 0.1)
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        auxs[name] = 0.1 * rng.randn(*shape) if name.endswith('_mean') \
            else 1.0 + 0.1 * rng.rand(*shape)
    return ({k: np.asarray(v, np.float32) for k, v in args.items()},
            {k: np.asarray(v, np.float32) for k, v in auxs.items()})


def _grad_req(symbol):
    return {n: 'null' if n in NO_GRAD else 'write'
            for n in symbol.list_arguments()}


def _f32(a):
    return np.asarray(a.asnumpy(), np.float32)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) /
                 max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize('case', sorted(STEP_CASES))
def test_factory_step_matches_jax(case):
    network, shape, has_bn = STEP_CASES[case]
    js = no_dropout(jmx, _factory(jmx, network))
    ts = no_dropout(mx, _factory(mx, network))
    args, auxs = seeded_params(js, dict(data=shape), seed=0)

    jex = js.simple_bind(jmx.cpu(), grad_req=_grad_req(js), data=shape)
    jex.copy_params_from(args, auxs)
    jex.forward_backward()
    j_out = _f32(jex.outputs[0])
    j_grads = {n: _f32(g) for n, g in jex.grad_dict.items()}
    j_auxs = {n: _f32(a) for n, a in jex.aux_dict.items()}
    tex = ts.simple_bind(mx.cpu(), grad_req=_grad_req(ts), data=shape)
    tex.copy_params_from(*executor.params_from_jax(args, auxs, mx.cpu()))
    tex.forward_backward()

    out = _f32(tex.outputs[0])
    assert out.shape == (shape[0], 10 if network in ('lenet', 'mlp')
                         else 1000)
    np.testing.assert_allclose(out, j_out, **F32_OUT)
    for name, a in j_auxs.items():
        assert _rel(_f32(tex.aux_dict[name]), a) <= BN_AUX_REL, name
    assert set(tex.grad_dict) == set(j_grads)
    t_grads = {n: _f32(g) for n, g in tex.grad_dict.items()}
    if not has_bn:
        for name, g in j_grads.items():
            np.testing.assert_allclose(t_grads[name], g, err_msg=name,
                                       **F32_STATE)
        return
    # the JAX package's own spread: the same step on the input scaled by
    # 1 + CHAOS_PERTURBATION, from the same parameters and statistics
    nudged = dict(args, data=args['data'] *
                  np.float32(1.0 + CHAOS_PERTURBATION))
    jex.copy_params_from(nudged, auxs)
    jex.forward_backward()
    own = np.median([_rel(_f32(jex.grad_dict[n]), g)
                     for n, g in j_grads.items()])
    port = np.median([_rel(t_grads[n], g) for n, g in j_grads.items()])
    for name, g in t_grads.items():
        assert np.isfinite(g).all(), name
    assert port <= CHAOS_FACTOR * own + CHAOS_SLACK, (port, own)


@pytest.mark.parametrize('case', sorted(ROUTE_CASES))
def test_bf16_train_forward_takes_the_pair_route(case, monkeypatch):
    network, shape, pairs = ROUTE_CASES[case]
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    symbol = mx.models.get_symbol(network, dtype='bfloat16')
    ex = symbol.simple_bind(mx.cpu(), grad_req=_grad_req(symbol),
                            data=shape)
    assert len(ex.pairs) == pairs
    assert not ex._split_conv
    grouped = [n.name for n in ex._topo if n.op is not None and
               n.op.name == 'Convolution' and
               int(n.attrs.get('num_group', 1)) != 1]
    routed = {ex._topo[ci].name for ci in ex.pairs}
    assert not routed & set(grouped)
    assert len(grouped) == (16 if network == 'resnext' else 0)
    args, auxs = seeded_params(symbol, dict(data=shape), seed=1)
    ex.copy_params_from(*executor.params_from_jax(args, auxs, mx.cpu()))
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    ex.forward_backward()
    assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == pairs
    assert np.isfinite(_f32(ex.outputs[0])).all()
    for name, g in ex.grad_dict.items():
        assert np.isfinite(_f32(g)).all(), name
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    ex.forward(is_train=False)
    assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == 0


# -- chip_smoke.py's gate of phase 16 ------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize('case', sorted(ROUTE_CASES))
def test_chip_smoke_counts_the_pairs_from_the_graph(case):
    """phase 16's count of the pairs from the JSON equals the executor's
    (the launches a step it gates), at full size."""
    network, _, pairs = ROUTE_CASES[case]
    symbol = mx.models.get_symbol(network, dtype='bfloat16')
    assert _chip_smoke().graph_pairs(symbol) == pairs
    topo = symbol._topo()
    assert len(executor.conv_bn_pairs(topo, symbol._outputs)) == pairs


def test_phase16_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    steps = cs.FACTORY_STEPS

    def bf16(pairs, grouped):
        return dict(pairs_from_graph=pairs, pairs_routed=pairs,
                    stem_split=False, step_launches=[pairs] * steps,
                    losses=[6.9] * steps, distinct_shapes=2,
                    kernel_checks=[dict(ok=True), dict(ok=True)],
                    grouped_convs=grouped,
                    conditioned=dict(launches_route=pairs,
                                     launches_unfused=0, loss_err=1e-4,
                                     out_rel=1e-3, aux_rel={'bn': 1e-3}))
    run = dict(bf16=dict(inception_v3=bf16(94, 0), resnext50=bf16(37, 16)),
               f32=dict(lenet=dict(ok=True), vgg16=dict(ok=True)))
    assert cs.factories_gate(run) == []

    def bad(name, **kw):
        r = dict(run, bf16=dict(run['bf16']))
        r['bf16'][name] = dict(r['bf16'][name], **kw)
        return cs.factories_gate(r)
    assert bad('inception_v3', pairs_routed=93)
    assert bad('inception_v3', step_launches=[94, 0, 94])
    assert bad('resnext50', stem_split=True)
    assert bad('resnext50', grouped_convs=0)
    assert bad('resnext50', kernel_checks=[dict(ok=True), dict(ok=False)])
    assert bad('resnext50', distinct_shapes=3)
    assert bad('inception_v3', losses=[6.9, float('nan'), 6.9])
    cond = run['bf16']['inception_v3']['conditioned']
    assert bad('inception_v3', conditioned=dict(cond, out_rel=0.5))
    assert bad('inception_v3', conditioned=dict(cond, loss_err=0.1))
    assert bad('inception_v3', conditioned=dict(cond, aux_rel={'bn': 0.5}))
    assert bad('inception_v3', conditioned=dict(cond, launches_unfused=1))
    assert cs.factories_gate(dict(run, f32=dict(lenet=dict(ok=False))))
