"""A cut ResNet through `forward_backward` in the port's executor against
the JAX package's, on the CPU, and the conv -> BatchNorm pair route.

The network is `resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
filter_list=[8, 32, 64, 128, 256], num_classes=10, image_shape=(3, 64,
64), bottle_neck=True)` at batch 4, its weights seeded He-normal from
numpy and carried across by `executor.params_from_jax`:

- float32: outputs within atol 1e-5, every gradient and moving statistic
  within rtol 1e-3 / atol 1e-5;
- bfloat16, with the layout pass forced on and the pair route engaged
  (the stem conv0 -> bn0 and conv1 -> bn2, conv2 -> bn3 of each of the
  four units: nine pairs, each one call of the conv + statistics
  Function, which takes its plain version on the CPU), and with it off:
  outputs within 0.02 and moving statistics within 0.02 in relative
  norm. The whole network's bf16 gradients are not held to a bound:
  at initialisation it amplifies rounding into them (see the test);
  the executor's route is held to the gradient bound, 0.05, on a
  one-pair graph below.

Then the pair route's statistics on the same bf16 y against the JAX
BatchNorm's sums of the rounded y, the gradient reaching the statistics,
and chip_smoke.py's gate of phase 9.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import cuda_conv, executor
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg

REPO = Path(__file__).resolve().parents[1]
CUT = dict(units=[1, 1, 1, 1], num_stages=4, filter_list=[8, 32, 64, 128, 256],
           num_classes=10, image_shape=(3, 64, 64), bottle_neck=True)
BATCH = 4
SHAPES = dict(data=(BATCH, 3, 64, 64))
# the stem's pair and two in each unit
CUT_PAIRS = 1 + 2 * len(CUT['units'])
# every argument but the data and the label
NO_GRAD = ('data', 'softmax_label')
F32_OUT = dict(rtol=0.0, atol=1e-5)
F32_STATE = dict(rtol=1e-3, atol=1e-5)
BF16_OUT, BF16_GRAD, BF16_AUX = 0.02, 0.05, 0.02


def seeded_params(symbol, shapes, seed):
    """He-normal weights, gamma near 1, small beta and moving statistics,
    normal images and integer labels, from numpy, by name."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args, auxs = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == 'softmax_label':
            args[name] = rng.randint(0, CUT['num_classes'],
                                     shape).astype(np.float32)
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


def _jax_step(dtype):
    """The JAX executor's step at its default, the stem split on, as the
    port's executor runs it."""
    s = jresnet.resnet(dtype=dtype, **CUT)
    ex = s.simple_bind(jmx.cpu(), grad_req=_grad_req(s), **SHAPES)
    assert ex._split_conv
    args, auxs = seeded_params(s, SHAPES, seed=0)
    ex.copy_params_from(args, auxs)
    arg_np = {n: a.asnumpy() for n, a in ex.arg_dict.items()}
    aux_np = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    ex.forward_backward()
    return dict(args=arg_np, auxs=aux_np,
                out=_f32(ex.outputs[0]),
                grads={n: _f32(g) for n, g in ex.grad_dict.items()},
                aux_after={n: _f32(a) for n, a in ex.aux_dict.items()})


@pytest.fixture(scope='module')
def jax_f32():
    return _jax_step('float32')


@pytest.fixture(scope='module')
def jax_bf16():
    return _jax_step('bfloat16')


def _port_step(ref, dtype, layout, pair_route=True, monkeypatch=None):
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', layout)
    s = tresnet.resnet(dtype=dtype, **CUT)
    ex = s.simple_bind(mx.cpu(), grad_req=_grad_req(s), **SHAPES)
    arg_params, aux_params = executor.params_from_jax(ref['args'],
                                                      ref['auxs'], mx.cpu())
    for name, a in arg_params.items():
        assert a.dtype == ex.arg_dict[name].dtype, name
    ex.copy_params_from(arg_params, aux_params)
    ex._pair_route = pair_route
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    ex.forward_backward()
    return ex, cuda_conv.CONV_BN_STATS_PLAIN_CALLS


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize('layout', ['0', '1'])
def test_cut_resnet_float32_matches_jax(jax_f32, layout, monkeypatch):
    ex, calls = _port_step(jax_f32, 'float32', layout,
                           monkeypatch=monkeypatch)
    assert calls == 0            # float32 pairs stay unfused
    assert ex._layout_opt == (layout == '1')
    np.testing.assert_allclose(_f32(ex.outputs[0]), jax_f32['out'],
                               **F32_OUT)
    assert set(ex.grad_dict) == set(jax_f32['grads'])
    for name, g in jax_f32['grads'].items():
        np.testing.assert_allclose(_f32(ex.grad_dict[name]), g,
                                   err_msg=name, **F32_STATE)
    for name, a in jax_f32['aux_after'].items():
        np.testing.assert_allclose(_f32(ex.aux_dict[name]), a,
                                   err_msg=name, **F32_STATE)


def _state(out, grads, auxs):
    """Every compared quantity by name: the output, each gradient but
    bn_data_gamma's (fix_gamma: exactly zero), each moving statistic."""
    q = {'output': out}
    q.update(('grad ' + n, g) for n, g in grads.items()
             if n != 'bn_data_gamma')
    q.update(('aux ' + n, a) for n, a in auxs.items())
    return q


def _bound(name):
    if name.startswith('grad '):
        return BF16_GRAD
    return BF16_OUT if name == 'output' else BF16_AUX


@pytest.mark.parametrize('pair_route', [True, False])
def test_cut_resnet_bfloat16_matches_jax(jax_bf16, pair_route, monkeypatch):
    """The port in bf16 against the JAX package in bf16: the output within
    BF16_OUT and every moving statistic within BF16_AUX, and every
    gradient finite. The gradients are not compared: this cut net at
    batch 4 amplifies any rounding into them (rounding only its
    parameters to bf16 moves the float32 gradients by up to 44 %; the
    JAX package's own bf16 run is 0.14-1.0 apart from its float32 one,
    as the port's is from JAX's), so no bound that a wrong gradient would
    fail holds here. test_executor_pair_route_matches_the_unfused_pair
    holds the route's gradients."""
    ex, calls = _port_step(jax_bf16, 'bfloat16', '1', pair_route,
                           monkeypatch)
    # the stem's conv0 -> bn0 leaves the route under the stem split
    assert ex._split_conv and len(ex.pairs) == CUT_PAIRS - 1
    assert calls == (CUT_PAIRS - 1 if pair_route else 0)
    assert ex.arg_dict['conv0_weight'].dtype == torch.bfloat16
    gamma = _f32(ex.grad_dict['bn_data_gamma'])
    assert not gamma.any() and not jax_bf16['grads']['bn_data_gamma'].any()
    ref = _state(jax_bf16['out'], jax_bf16['grads'], jax_bf16['aux_after'])
    got = _state(_f32(ex.outputs[0]),
                 {n: _f32(g) for n, g in ex.grad_dict.items()},
                 {n: _f32(a) for n, a in ex.aux_dict.items()})
    assert set(got) == set(ref)
    bad = {}
    for name, want in ref.items():
        assert np.isfinite(got[name]).all(), name
        if name.startswith('grad '):
            continue
        err = _rel(got[name], want)
        if err > _bound(name):
            bad[name] = err
    assert not bad, bad
    # eval mode never takes the route
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    ex.forward(is_train=False)
    assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == 0


# (kernel, stride, pad, Cin, Cout) of one conv -> BatchNorm pair: the
# stem's 7x7 at Cin 3 (zero-padded to 8 on the route), a v2 unit's 3x3
# stride 2 and a 1x1
PAIR_CASES = {
    'stem_7x7_s2_cin3': ((7, 7), (2, 2), (3, 3), 3, 16),
    '3x3_s2': ((3, 3), (2, 2), (1, 1), 16, 32),
    '1x1': ((1, 1), (1, 1), (0, 0), 32, 16),
}
PAIR_BATCH, PAIR_SIZE = 8, 32


def _pair_softmax_symbol(kernel, stride, pad, cout):
    """bf16 data -> conv -> BatchNorm -> float32 -> SoftmaxOutput over the
    channels at every pixel."""
    data = mx.sym.Cast(mx.sym.Variable('data'), dtype='bfloat16')
    conv = mx.sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                              num_filter=cout, no_bias=True, name='conv')
    bn = mx.sym.BatchNorm(conv, fix_gamma=False, name='bn')
    return mx.sym.SoftmaxOutput(mx.sym.Cast(bn, dtype='float32'),
                                multi_output=True, name='softmax')


@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_executor_pair_route_matches_the_unfused_pair(case, monkeypatch):
    """A bf16 conv -> BatchNorm -> SoftmaxOutput graph through the
    executor with the pair route on (one call of the conv + statistics
    Function, the BatchNorm on its sums) and off: the output within
    BF16_OUT, the moving statistics within BF16_AUX and the gradients of
    the data, the weight, gamma and beta within BF16_GRAD in relative
    norm. One pair deep, bf16 rounding is not amplified, so a gradient
    cut at the statistics fails here."""
    kernel, stride, pad, cin, cout = PAIR_CASES[case]
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    sym = _pair_softmax_symbol(kernel, stride, pad, cout)
    shape = (PAIR_BATCH, cin, PAIR_SIZE, PAIR_SIZE)
    req = {n: 'null' if n == 'softmax_label' else 'write'
           for n in sym.list_arguments()}
    rng = np.random.RandomState(5)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=shape)
    args = {}
    for name, s in zip(sym.list_arguments(), arg_shapes):
        if name == 'softmax_label':
            args[name] = rng.randint(0, cout, s)
        elif name == 'conv_weight':
            args[name] = rng.randn(*s) * math.sqrt(2.0 / np.prod(s[1:]))
        elif name == 'bn_gamma':
            args[name] = 1.0 + 0.1 * rng.randn(*s)
        else:
            args[name] = rng.randn(*s) * (1.0 if name == 'data' else 0.1)
    auxs = dict(bn_moving_mean=0.1 * rng.randn(cout),
                bn_moving_var=1.0 + 0.1 * rng.rand(cout))
    states = {}
    for route in (True, False):
        ex = sym.simple_bind(mx.cpu(), grad_req=req, data=shape)
        ex.copy_params_from({k: np.float32(v) for k, v in args.items()},
                            {k: np.float32(v) for k, v in auxs.items()})
        ex._pair_route = route
        cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
        ex.forward_backward()
        assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == (1 if route else 0)
        states[route] = _state(
            _f32(ex.outputs[0]),
            {n: _f32(g) for n, g in ex.grad_dict.items()},
            {n: _f32(a) for n, a in ex.aux_dict.items()})
    got, ref = states[True], states[False]
    assert set(got) == set(ref) and 'grad data' in got
    errs = {name: _rel(got[name], want) for name, want in ref.items()}
    assert all(np.isfinite(v).all() for v in got.values())
    bad = {name: err for name, err in errs.items() if err > _bound(name)}
    assert not bad, (bad, errs)


def test_pair_route_raises_rather_than_unfusing(monkeypatch):
    """A failure of the conv + statistics Function (a kernel that does not
    build or launch) reaches the caller; nothing falls back to cuDNN."""
    def broken(*args, **kwargs):
        raise RuntimeError('conv + BN statistics kernel failed to launch')

    s = tresnet.resnet(dtype='bfloat16', **CUT)
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    ex = s.simple_bind(mx.cpu(), grad_req=_grad_req(s), **SHAPES)
    monkeypatch.setattr(cuda_conv, 'conv2d_bn_stats', broken)
    with pytest.raises(RuntimeError, match='failed to launch'):
        ex.forward_backward()
    ex.forward(is_train=False)      # eval mode takes no pair
    assert ex.outputs[0].shape == (BATCH, CUT['num_classes'])


def test_shape_inference_never_reaches_the_pair_route():
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    s = tresnet.get_symbol(num_classes=1000, num_layers=50,
                           image_shape='3,224,224', dtype='bfloat16')
    _, outs, _ = s.infer_shape(data=(256, 3, 224, 224))
    assert outs == [(256, 1000)]
    assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == 0


def test_pair_statistics_match_jax_sums_of_the_rounded_y():
    """mean = s1 / m and var = s2 / m - mean^2 from the kernel's sums of
    the float32 y, against the JAX BatchNorm's one-pass statistics of the
    same y rounded to bf16, at m = 4096 rows."""
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(4, 32, 32, 16) + 0.5,
                     dtype=torch.float32).to(torch.bfloat16)
    w = torch.tensor(rng.randn(3, 3, 16, 32) * 0.1,
                     dtype=torch.float32).to(torch.bfloat16)
    y, s1, s2 = cuda_conv.conv2d_bn_stats(x, w, (1, 1), (1, 1))
    m = y.shape[0] * y.shape[1] * y.shape[2]
    assert m >= 4096
    mean = (s1 / m).numpy()
    var = torch.clamp(s2 / m - (s1 / m) ** 2, min=0.0).numpy()
    yj = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    c = y.shape[3]
    outs, _ = jreg.get('BatchNorm').apply(
        dict(fix_gamma=False, output_mean_var=True, axis=3),
        [yj, jnp.ones(c), jnp.zeros(c)], [jnp.zeros(c), jnp.ones(c)],
        jreg.OpContext(is_train=True))
    jmean, jvar = np.asarray(outs[1]), np.asarray(outs[2])
    assert (np.abs(mean - jmean) <= 1e-3 * np.sqrt(jvar)).all()
    assert (np.abs(var - jvar) <= 1e-3 * jvar).all()


def _bn_after_conv(x, w, gamma, beta, sums_route, detach_sums=False):
    """BatchNorm (train, NHWC) of the conv of x: on the pair route's sums,
    or on F.conv2d and BatchNorm's own statistics."""
    attrs = dict(fix_gamma=False, eps=1e-3, __layout__='NHWC')
    c = w.shape[3]
    ctx = treg.OpContext(is_train=True, device=torch.device('cpu'))
    auxs = [torch.zeros(c), torch.ones(c)]
    if sums_route:
        y, s1, s2 = cuda_conv.conv2d_bn_stats(x, w, (2, 2), (1, 1))
        sums = (s1.detach(), s2.detach()) if detach_sums else (s1, s2)
        outs, _ = tnn.batch_norm(attrs, [y, gamma, beta], auxs, ctx,
                                 sums=sums)
    else:
        y = tnn._convolution(dict(kernel=(3, 3), num_filter=c,
                                  stride=(2, 2), pad=(1, 1), no_bias=True,
                                  __layout__='NHWC'),
                             x, w.permute(3, 2, 0, 1))
        outs, _ = tnn.batch_norm(attrs, [y, gamma, beta], auxs, ctx)
    return outs[0]


def test_pair_route_gradient_reaches_the_statistics():
    """In float32 the pair route (sums from the conv Function) and the
    unfused conv + BatchNorm give the same output and gradients; with the
    sums detached the data gradient is another one."""
    rng = np.random.RandomState(2)
    x0 = torch.tensor(rng.randn(4, 9, 9, 6) + 1.0, dtype=torch.float32)
    w0 = torch.tensor(rng.randn(3, 3, 6, 8) * 0.3, dtype=torch.float32)
    g0 = torch.tensor(1.0 + 0.1 * rng.randn(8), dtype=torch.float32)
    b0 = torch.tensor(0.1 * rng.randn(8), dtype=torch.float32)
    cot = torch.tensor(rng.randn(4, 5, 5, 8), dtype=torch.float32)

    def grads(**kw):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, g0, b0)]
        out = _bn_after_conv(*leaves, **kw)
        return [out] + list(torch.autograd.grad(out, leaves, cot))

    ref = grads(sums_route=False)
    for got, want in zip(grads(sums_route=True), ref):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-4,
                                   atol=1e-5)
    cut = grads(sums_route=True, detach_sums=True)
    assert _rel(cut[1].numpy(), ref[1].numpy()) > 0.1


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 9
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _passing_run(cs):
    pairs = cs.route_pairs(cs.RESNET_PAIRS, True)
    grads = {'conv0_weight': 0.7, 'fc1_weight': 0.02}
    pair = dict(x=[256, 56, 56, 64], w=[3, 3, 64, 64], stride=[1, 1],
                launches_route=1, launches_unfused=0, finite=True,
                rel_err={'output': 1e-3, 'grad data': 2e-3,
                         'grad conv_weight': 2e-3, 'grad bn_gamma': 1e-4,
                         'grad bn_beta': 0.0, 'aux bn_moving_mean': 1e-3,
                         'aux bn_moving_var': 1e-4})
    return dict(
        stem_split=True,
        eval_launches=0, train_launches=[pairs] * (1 + cs.RESNET_STEPS),
        grad_finite=True, grad_zero=['bn_data_gamma'],
        bn_data_gamma_zero=True,
        unfused=dict(loss_err=1e-4, out_rel=0.01, grad_rel=grads,
                     aux_rel={'bn0_moving_mean': 1e-3}, launches=0),
        unfused_split=dict(loss_err=1e-4, out_rel=0.005, grad_rel=grads,
                           aux_rel={'bn0_moving_mean': 1e-3}, launches=0),
        cut=dict(out_rel=1e-3, grad_rel=grads, aux_rel={'bn0_moving_var':
                                                        1e-3},
                 launches=cs.route_pairs(cs.CUT_RESNET_PAIRS, True)),
        losses=[2.4, 2.3, 2.1, 1.9, 1.6],
        kernel_checks=[dict(shape='conv0', ok=True)],
        pair_checks=[pair])


def _with_pair(run, **changes):
    pair = dict(run['pair_checks'][0], **changes)
    return dict(run, pair_checks=[pair])


def test_phase9_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = _passing_run(cs)
    assert cs.resnet_gate(run) == []
    no_kernel = dict(run, train_launches=[0] * len(run['train_launches']))
    assert any('launch' in m for m in cs.resnet_gate(no_kernel))
    eval_kernel = dict(run, eval_launches=3)
    assert cs.resnet_gate(eval_kernel)
    good = run['pair_checks'][0]['rel_err']
    for name in ('grad data', 'grad conv_weight', 'grad bn_gamma'):
        diverged = _with_pair(run, rel_err=dict(good, **{name: 0.5}))
        assert any(name in m for m in cs.resnet_gate(diverged)), name
    # a gradient cut at the statistics: the route's dx all wrong
    cut_grad = _with_pair(run, rel_err=dict(good, **{'grad data': 1.0}))
    assert cs.resnet_gate(cut_grad)
    unlaunched = _with_pair(run, launches_route=0)
    assert any('launched' in m for m in cs.resnet_gate(unlaunched))
    assert cs.resnet_gate(dict(run, pair_checks=[]))
    assert cs.resnet_gate(_with_pair(run, finite=False))
    cut = dict(run, cut=dict(run['cut'], out_rel=0.3))
    assert cs.resnet_gate(cut)
    stats = dict(run, unfused=dict(run['unfused'], aux_rel={
        'bn0_moving_mean': 0.05}))
    assert any('bn0_moving_mean' in m for m in cs.resnet_gate(stats))
    loss = dict(run, unfused=dict(run['unfused'], loss_err=0.01))
    assert any('loss' in m for m in cs.resnet_gate(loss))
    split = dict(run, unfused_split=dict(run['unfused_split'], out_rel=0.05))
    assert any('unfused_split' in m for m in cs.resnet_gate(split))
    zero_grad = dict(run, grad_zero=['bn_data_gamma', 'fc1_weight'])
    assert any('fc1_weight' in m for m in cs.resnet_gate(zero_grad))
    flat = dict(run, losses=[2.4, 2.4, 2.4, 2.4, 2.5])
    assert cs.resnet_gate(flat)
    bad_kernel = dict(run, kernel_checks=[dict(shape='conv0', ok=False)])
    assert cs.resnet_gate(bad_kernel)


def test_phase9_pair_checks_on_the_cpu_pass_the_gate():
    """chip_smoke.py's one-pair executor checks, run on cpu(0) at small
    pair shapes (the stem's Cin 3 among them), give rows the gate takes:
    one route launch, none unfused, every quantity within its bound."""
    cs = _chip_smoke()
    shapes = {((4, 32, 32, 3), (7, 7, 3, 16), (2, 2), (3, 3)): ['conv0'],
              ((4, 16, 16, 16), (3, 3, 16, 16), (2, 2), (1, 1)): ['conv2']}
    rows = cs.pair_executor_checks(torch, mx, cuda_conv, shapes, mx.cpu())
    assert len(rows) == 2
    run = dict(_passing_run(cs), pair_checks=rows)
    assert cs.resnet_gate(run) == [], rows
