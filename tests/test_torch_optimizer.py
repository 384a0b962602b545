"""The port's optimizers, optimizer ops, FusedSGD, lr schedules and
initializers against the JAX package's, on the CPU.

Seeded numpy weights and gradients go through both packages:
- every optimizer over 5 updates through the per-key Updater, with lr
  and wd multipliers, clip_gradient and rescale_grad: float32 weights
  and states within rtol 1e-5 / atol 1e-6; SGD's bf16 weights with
  float32 masters within one bf16 step, the masters within rtol 1e-5;
- every registered optimizer op over 5 calls, the same bounds;
- FusedSGD against the per-key Updater in each package, and the port's
  against the JAX package's; their state pickles read across both ways;
- every lr scheduler gives the same lr at each num_update in 0-200;
- the deterministic initializers are equal exactly, the random ones
  held to shape, dtype, bounds and moments, and the name dispatch sends
  each name to the same initializer.
"""
import json
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt

NAMES = ['fc_weight', 'fc_bias', 'bn_gamma', 'bn_beta']
SHAPES = [(6, 5), (6,), (6,), (6,)]
STEPS = 5
F32 = dict(rtol=1e-5, atol=1e-6)
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
LR_MULT = {'fc_weight': 0.5}
WD_MULT = {'bn_gamma': 2.0}

# name -> (registered name, kwargs)
OPTIMIZERS = {
    'sgd': ('sgd', dict(learning_rate=0.1)),
    'sgd_momentum': ('sgd', dict(learning_rate=0.1, momentum=0.9)),
    'nag': ('nag', dict(learning_rate=0.1, momentum=0.9)),
    'nag_no_momentum': ('nag', dict(learning_rate=0.1)),
    'sgld': ('sgld', dict(learning_rate=0.1)),
    'dcasgd': ('dcasgd', dict(learning_rate=0.1, momentum=0.9)),
    'dcasgd_no_momentum': ('dcasgd', dict(learning_rate=0.1)),
    'adam': ('adam', dict(learning_rate=0.01)),
    'adagrad': ('adagrad', dict(learning_rate=0.1)),
    'rmsprop': ('rmsprop', dict(learning_rate=0.01)),
    'rmsprop_centered': ('rmsprop', dict(learning_rate=0.01, centered=True,
                                         clip_weights=0.5)),
    'adadelta': ('adadelta', dict()),
    'ftrl': ('ftrl', dict(learning_rate=0.1)),
    'adamax': ('adamax', dict()),
    'nadam': ('nadam', dict()),
    'signum': ('signum', dict()),
    'signum_no_momentum': ('signum', dict(momentum=0.0)),
    'test': ('test', dict()),
}


def _seeded(seed=0):
    rng = np.random.RandomState(seed)
    weights = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return weights, grads


def _zero_noise(monkeypatch):
    """SGLD's noise replaced by zeros in both packages: what stays is
    the deterministic part of its update."""
    monkeypatch.setattr(jmx.nd, 'random_normal',
                        lambda loc, scale, shape, **kw: jmx.nd.zeros(shape))
    monkeypatch.setattr(mx.nd, 'random_normal',
                        lambda loc, scale, shape, ctx=None, **kw:
                        mx.nd.zeros(shape, ctx))


def _make(pkg, registered, kwargs):
    opt = pkg.create(registered, param_idx2name=dict(enumerate(NAMES)),
                     **dict(COMMON, **kwargs))
    opt.set_lr_mult(LR_MULT)
    opt.set_wd_mult(WD_MULT)
    return opt


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _leaves(s)]
    return [np.asarray(state.asnumpy(), np.float32)]


def _run_updater(pkg, nd, registered, kwargs, dtype, ctx):
    weights, grads = _seeded()
    opt = _make(pkg, registered, kwargs)
    up = pkg.get_updater(opt)
    ws = [nd.array(w, ctx=ctx, dtype=dtype) for w in weights]
    for step in grads:
        for i, g in enumerate(step):
            up(i, nd.array(g, ctx=ctx, dtype=dtype), ws[i])
    return ([np.asarray(w.asnumpy(), np.float32) for w in ws],
            [_leaves(up.states[i]) for i in range(len(NAMES))], opt)


@pytest.mark.parametrize('case', sorted(OPTIMIZERS))
def test_optimizer_matches_jax(case, monkeypatch):
    _zero_noise(monkeypatch)
    registered, kwargs = OPTIMIZERS[case]
    jw, js, jo = _run_updater(jopt, jmx.nd, registered, kwargs, np.float32,
                              jmx.cpu())
    tw, ts, to = _run_updater(topt, mx.nd, registered, kwargs, np.float32,
                              mx.cpu())
    for name, a, b in zip(NAMES, tw, jw):
        np.testing.assert_allclose(a, b, err_msg=name, **F32)
    for name, a, b in zip(NAMES, ts, js):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, err_msg=name, **F32)
    assert to._index_update_count == jo._index_update_count
    assert to.num_update == jo.num_update


def test_sgld_noise_has_the_scale_of_sqrt_lr():
    """With its noise, SGLD's weights move from the deterministic update
    by N(0, lr) per step."""
    lr = 0.04
    mx.random.seed(3)
    with mx.cpu():
        opt = topt.create('sgld', learning_rate=lr)
        w = mx.nd.zeros((200, 200))
        opt.update(0, w, mx.nd.zeros((200, 200)), None)
    x = w.asnumpy()
    assert abs(x.mean()) < 0.005
    assert abs(x.std() - math.sqrt(lr)) < 0.01


def _bf16_steps(got, ref):
    """|got - ref| in bf16 steps at |ref|."""
    _, exp = np.frexp(np.abs(ref))
    spacing = np.ldexp(1.0, exp - 8)
    return np.max(np.abs(got - ref) / np.where(ref == 0, 2.0 ** -133,
                                                spacing))


@pytest.mark.parametrize('momentum', [0.0, 0.9])
def test_sgd_bfloat16_with_masters_matches_jax(momentum):
    kwargs = dict(learning_rate=0.1, momentum=momentum, multi_precision=True)
    jw, js, _ = _run_updater(jopt, jmx.nd, 'sgd', kwargs, jnp.bfloat16,
                             jmx.cpu())
    tw, ts, _ = _run_updater(topt, mx.nd, 'sgd', kwargs, 'bfloat16',
                             mx.cpu())
    for name, a, b in zip(NAMES, tw, jw):
        assert _bf16_steps(a, b) <= 1.0, name
    for name, a, b in zip(NAMES, ts, js):
        assert len(a) == len(b) == (2 if momentum else 1), name
        for x, y in zip(a, b):     # momentum and master, float32
            np.testing.assert_allclose(x, y, err_msg=name, **F32)


# op name -> (state names, kwargs, multi-precision)
OPS = {
    'sgd_update': ((), dict(lr=0.1, wd=0.01), False),
    'sgd_mom_update': (('mom',), dict(lr=0.1, wd=0.01, momentum=0.9),
                       False),
    'mp_sgd_update': (('weight32',), dict(lr=0.1, wd=0.01), True),
    'mp_sgd_mom_update': (('mom', 'weight32'),
                          dict(lr=0.1, wd=0.01, momentum=0.9), True),
    'adam_update': (('mean', 'var'), dict(lr=0.01, wd=0.01), False),
    'rmsprop_update': (('n',), dict(lr=0.01, wd=0.01, clip_weights=0.6),
                       False),
    'rmspropalex_update': (('n', 'g', 'delta'),
                           dict(lr=0.01, wd=0.01, clip_weights=0.6), False),
}


def _run_op(nd, ctx, op, low, weights, grads):
    states_names, kwargs, mp = OPS[op]
    kwargs = dict(kwargs, rescale_grad=0.5, clip_gradient=0.8)
    w = nd.array(weights, ctx=ctx, dtype=low if mp else np.float32)
    states = []
    for s in states_names:
        states.append(nd.array(weights, ctx=ctx) if s == 'weight32'
                      else nd.zeros(weights.shape, ctx))
    fn = getattr(nd, op)
    for g in grads:
        fn(w, nd.array(g, ctx=ctx, dtype=low if mp else np.float32),
           *states, out=w, **kwargs)
    return (np.asarray(w.asnumpy(), np.float32),
            [np.asarray(s.asnumpy(), np.float32) for s in states])


@pytest.mark.parametrize('op', sorted(OPS))
def test_optimizer_op_matches_jax(op):
    rng = np.random.RandomState(1)
    weights = rng.randn(7, 3).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) for _ in range(STEPS)]
    jw, js = _run_op(jmx.nd, jmx.cpu(), op, jnp.bfloat16, weights, grads)
    tw, ts = _run_op(mx.nd, mx.cpu(), op, 'bfloat16', weights, grads)
    if OPS[op][2]:
        assert _bf16_steps(tw, jw) <= 1.0
    else:
        np.testing.assert_allclose(tw, jw, **F32)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, **F32)


def test_sparse_optimizer_ops_are_registered_and_raise():
    """The rows-only ops (parallel/embedding) against the JAX package's
    over 3 calls, padded ids (== vocab) included: equal weights and
    momenta, and the rows no id touched unchanged. A call with ids past
    the table raises nothing: the padding is inert."""
    V, D = 10, 4
    rng = np.random.RandomState(0)
    w0 = rng.randn(V, D).astype(np.float32)
    uids = np.array([1, 3, 5, V - 1, V, V], dtype=np.int32)
    rows = [rng.randn(6, D).astype(np.float32) for _ in range(3)]
    outs = {}
    for name, pkg, ctx in (('jax', jmx, jmx.cpu()), ('port', mx, mx.cpu())):
        with ctx:
            w = pkg.nd.array(w0.copy())
            wm = pkg.nd.array(w0.copy())
            m = pkg.nd.zeros((V, D))
            for r in rows:
                pkg.nd.sparse_sgd_update(w, pkg.nd.array(uids),
                                         pkg.nd.array(r), out=w, lr=0.1,
                                         wd=0.01, rescale_grad=0.5)
                pkg.nd.sparse_sgd_mom_update(wm, pkg.nd.array(uids),
                                             pkg.nd.array(r), m, out=wm,
                                             lr=0.1, wd=0.01, momentum=0.9)
            outs[name] = (w.asnumpy(), wm.asnumpy(), m.asnumpy())
    for a, b in zip(outs['port'], outs['jax']):
        np.testing.assert_allclose(a, b, **F32)
    assert mx.ops.exists('sparse_sgd_mom_update')
    w, wm, m = outs['port']
    untouched = [0, 2, 4, 6, 7, 8]
    np.testing.assert_array_equal(w[untouched], w0[untouched])
    np.testing.assert_array_equal(wm[untouched], w0[untouched])
    np.testing.assert_array_equal(m[untouched], 0.0)
    assert np.abs(w[V - 1] - w0[V - 1]).max() > 0


# -- FusedSGD ---------------------------------------------------------------

FUSED = {
    'sgd_f32': ('sgd', dict(momentum=0.9), np.float32),
    'sgd_no_momentum_f32': ('sgd', dict(), np.float32),
    'nag_f32': ('nag', dict(momentum=0.9), np.float32),
    'sgd_mp_bf16': ('sgd', dict(momentum=0.9, multi_precision=True),
                    'bfloat16'),
}


def _fused(pkg, nd, ctx, registered, kwargs, dtype, steps=STEPS,
           states=None):
    weights, grads = _seeded(2)
    opt = _make(pkg, registered, dict(kwargs, learning_rate=0.1))
    fu = pkg.FusedSGD(opt, NAMES)
    if states is not None:
        fu.set_states(states)
    ws = [nd.array(w, ctx=ctx, dtype=dtype) for w in weights]
    for step in grads[:steps]:
        fu(ws, [nd.array(g, ctx=ctx, dtype=dtype) for g in step])
    return fu, [np.asarray(w.asnumpy(), np.float32) for w in ws]


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == 'bfloat16' else dtype


def _assert_weights(got, ref, dtype):
    for name, a, b in zip(NAMES, got, ref):
        if dtype == 'bfloat16':
            assert _bf16_steps(a, b) <= 1.0, name
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **F32)


@pytest.mark.parametrize('case', sorted(FUSED))
def test_fused_sgd_matches_jax_and_the_per_key_updater(case):
    registered, kwargs, dtype = FUSED[case]
    jfu, jw = _fused(jopt, jmx.nd, jmx.cpu(), registered, kwargs,
                     _jdtype(dtype))
    tfu, tw = _fused(topt, mx.nd, mx.cpu(), registered, kwargs, dtype)
    _assert_weights(tw, jw, dtype)
    for n in NAMES:
        np.testing.assert_allclose(tfu.states[n].numpy(),
                                   np.asarray(jfu.states[n], np.float32),
                                   err_msg=n, **F32)
        jm = jfu.masters[n]
        assert (tfu.masters[n] is None) == (jm is None), n
        if jm is not None:
            assert tfu.masters[n].dtype == torch.float32
            np.testing.assert_allclose(tfu.masters[n].numpy(),
                                       np.asarray(jm), err_msg=n, **F32)
    assert tfu.optimizer._index_update_count == \
        jfu.optimizer._index_update_count
    # the per-key Updater of each package gives the fused update
    for pkg, nd, ctx, fused_w, dt in (
            (topt, mx.nd, mx.cpu(), tw, dtype),
            (jopt, jmx.nd, jmx.cpu(), jw, _jdtype(dtype))):
        kw = dict(kwargs, learning_rate=0.1)
        per_key, _, _ = _run_updater_on(pkg, nd, registered, kw, dt, ctx)
        _assert_weights(per_key, fused_w, dtype)


def _run_updater_on(pkg, nd, registered, kwargs, dtype, ctx):
    weights, grads = _seeded(2)
    opt = _make(pkg, registered, kwargs)
    up = pkg.get_updater(opt)
    ws = [nd.array(w, ctx=ctx, dtype=dtype) for w in weights]
    for step in grads:
        for i, g in enumerate(step):
            up(i, nd.array(g, ctx=ctx, dtype=dtype), ws[i])
    return [np.asarray(w.asnumpy(), np.float32) for w in ws], up, opt


def test_fused_sgd_updates_the_bound_tensors_in_place():
    """The weights' own tensors are updated: a reference taken before the
    step sees the new values, and the gradients are left as they were."""
    with mx.cpu():
        opt = topt.create('sgd', learning_rate=0.1, momentum=0.9,
                          multi_precision=True)
        w = mx.nd.array(np.ones((3, 2)), dtype='bfloat16')
        g = mx.nd.array(np.full((3, 2), 2.0), dtype='bfloat16')
        before = w.handle
        topt.FusedSGD(opt, ['w'])([w], [g])
    assert w.handle is before
    assert float(before[0, 0]) == pytest.approx(0.8, abs=2 ** -7)
    assert (g.asnumpy() == 2.0).all()


@pytest.mark.parametrize('case', ['sgd_f32', 'sgd_mp_bf16'])
@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_fused_sgd_states_read_across(case, direction):
    """Two steps in one package, its get_states read by the other's
    set_states, then three more steps in both from the same weights."""
    registered, kwargs, dtype = FUSED[case]
    src = (jopt, jmx.nd, jmx.cpu(), _jdtype(dtype)) \
        if direction == 'jax_to_port' else (topt, mx.nd, mx.cpu(), dtype)
    fu, _ = _fused(src[0], src[1], src[2], registered, kwargs, src[3],
                   steps=2)
    payload = fu.get_states()
    states, counts, masters = pickle.loads(payload)
    for v in list(states.values()) + list(masters.values()):
        assert v is None or np.asarray(v).dtype == np.float32
    assert counts == {n: 2 for n in NAMES}
    jfu, jw = _fused(jopt, jmx.nd, jmx.cpu(), registered, kwargs,
                     _jdtype(dtype), states=payload)
    tfu, tw = _fused(topt, mx.nd, mx.cpu(), registered, kwargs, dtype,
                     states=payload)
    _assert_weights(tw, jw, dtype)
    assert tfu.optimizer._index_update_count == {n: 2 + STEPS
                                                 for n in NAMES}


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_updater_states_read_across(direction):
    """The per-key Updater's pickle (momentum and float32 master pairs of
    multi-precision SGD) read by the other package, then one more update
    in both."""
    kwargs = dict(learning_rate=0.1, momentum=0.9, multi_precision=True)
    if direction == 'jax_to_port':
        _, up, _ = _run_updater_on(jopt, jmx.nd, 'sgd', kwargs, jnp.bfloat16,
                                   jmx.cpu())
    else:
        _, up, _ = _run_updater_on(topt, mx.nd, 'sgd', kwargs, 'bfloat16',
                                   mx.cpu())
    payload = up.get_states()
    weights, grads = _seeded(5)
    out = {}
    for key, pkg, nd, ctx, dt in (('jax', jopt, jmx.nd, jmx.cpu(),
                                   jnp.bfloat16),
                                  ('port', topt, mx.nd, mx.cpu(),
                                   'bfloat16')):
        opt = _make(pkg, 'sgd', kwargs)
        reader = pkg.get_updater(opt)
        reader.set_states(payload)
        ws = [nd.array(w, ctx=ctx, dtype=dt) for w in weights]
        for i, g in enumerate(grads[0]):
            reader(i, nd.array(g, ctx=ctx, dtype=dt), ws[i])
        out[key] = ([np.asarray(w.asnumpy(), np.float32) for w in ws],
                    [_leaves(reader.states[i]) for i in range(len(NAMES))])
        assert opt._index_update_count == {i: STEPS + 1
                                           for i in range(len(NAMES))}
    _assert_weights(out['port'][0], out['jax'][0], 'bfloat16')
    for a, b in zip(out['port'][1], out['jax'][1]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **F32)


def test_wd_decays_only_weights_and_gammas_and_symbol_mults_apply():
    data = mx.sym.Variable('data')
    w = mx.sym.Variable('fc_weight', lr_mult=0.25, wd_mult=3.0)
    fc = mx.sym.FullyConnected(data, weight=w, num_hidden=4, name='fc')
    names = fc.list_arguments()[1:]
    for pkg, s in ((topt, fc), (jopt, _jax_fc())):
        opt = pkg.create('sgd', learning_rate=0.1, wd=0.5, sym=s,
                         param_idx2name=dict(enumerate(names)))
        assert opt._get_wd('fc_bias') == 0.0
        assert opt._get_wd('fc_weight') == pytest.approx(1.5)
        assert opt._get_lr('fc_weight') == pytest.approx(0.025)
        assert opt._get_lr(1) == pytest.approx(0.1)


def _jax_fc():
    data = jmx.sym.Variable('data')
    w = jmx.sym.Variable('fc_weight', lr_mult=0.25, wd_mult=3.0)
    return jmx.sym.FullyConnected(data, weight=w, num_hidden=4, name='fc')


# -- lr schedules -----------------------------------------------------------

SCHEDULES = {
    'factor': ('FactorScheduler', dict(step=7, factor=0.9)),
    'factor_floor': ('FactorScheduler', dict(step=3, factor=0.5,
                                             stop_factor_lr=1e-4)),
    'multifactor': ('MultiFactorScheduler', dict(step=[5, 50, 120],
                                                 factor=0.3)),
    'poly': ('PolyScheduler', dict(max_update=150, base_lr=0.2, pwr=2)),
    'cosine': ('CosineScheduler', dict(max_update=180, base_lr=0.3,
                                       final_lr=0.01, warmup_steps=20,
                                       warmup_begin_lr=0.001)),
}


@pytest.mark.parametrize('case', sorted(SCHEDULES))
def test_lr_scheduler_matches_jax(case):
    cls, kwargs = SCHEDULES[case]
    out = []
    for mod in (jlrs, tlrs):
        sched = getattr(mod, cls)(**kwargs)
        if 'base_lr' not in kwargs:
            sched.base_lr = 0.1      # what the optimizer sets
        pure = [sched.lr_at(n) for n in range(201)]
        live = [sched(n) for n in range(201)]
        out.append((pure, live))
    assert out[0] == out[1]


def test_scheduler_drives_the_optimizer_lr_as_in_jax():
    lrs = []
    for pkg, lrs_mod in ((jopt, jlrs), (topt, tlrs)):
        sched = lrs_mod.MultiFactorScheduler(step=[3, 6], factor=0.1)
        opt = pkg.create('sgd', learning_rate=0.5, lr_scheduler=sched)
        seq = []
        for _ in range(10):
            opt._update_count(0)
            seq.append(opt._get_lr(0))
        lrs.append(seq)
    assert lrs[0] == lrs[1]


# -- initializers -----------------------------------------------------------

DETERMINISTIC = {
    'zero': (lambda p: p.Zero(), (3, 4)),
    'one': (lambda p: p.One(), (3, 4)),
    'constant': (lambda p: p.Constant(0.3), (5,)),
    'bilinear': (lambda p: p.Bilinear(), (2, 1, 4, 4)),
    'lstm_bias': (lambda p: p.LSTMBias(forget_bias=2.0), (12,)),
    'orthogonal_uniform': (lambda p: p.Orthogonal(), (4, 6)),
    'orthogonal_normal': (lambda p: p.Orthogonal(scale=1.0,
                                                 rand_type='normal'),
                          (6, 2, 2)),
    'by_name': (lambda p: p.create('constant', value=-1.5), (2, 3)),
    'spec': (lambda p: p.create('constant,value=0.25'), (2, 3)),
}


def _init_both(make, shape, name='layer_weight', dtype=np.float32):
    out = []
    for p, nd, ctx in ((jinit, jmx.nd, jmx.cpu()), (tinit, mx.nd, mx.cpu())):
        np.random.seed(11)
        arr = nd.zeros(shape, ctx, dtype=dtype)
        make(p)(p.InitDesc(name), arr)
        out.append(np.asarray(arr.asnumpy(), np.float32))
    return out


@pytest.mark.parametrize('case', sorted(DETERMINISTIC))
def test_deterministic_initializer_matches_jax(case):
    make, shape = DETERMINISTIC[case]
    ref, got = _init_both(make, shape)
    np.testing.assert_array_equal(got, ref)


def test_load_and_mixed_match_jax():
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = []
    for p, nd, ctx in ((jinit, jmx.nd, jmx.cpu()), (tinit, mx.nd, mx.cpu())):
        load = p.Load({'arg:a_weight': nd.array(src, ctx=ctx)},
                      default_init=p.Constant(7.0))
        mixed = p.Mixed(['^a_', '.*'], [load, p.One()])
        arrs = {n: nd.zeros((2, 3), ctx) for n in ('a_weight', 'b_weight')}
        for n, a in arrs.items():
            mixed(n, a)
        fallback = nd.zeros((2, 3), ctx)
        load('c_weight', fallback)
        out.append([arrs['a_weight'].asnumpy(), arrs['b_weight'].asnumpy(),
                    fallback.asnumpy()])
        with pytest.raises(ValueError):
            p.Mixed(['^z'], [p.One()])('a_weight', nd.zeros((1,), ctx))
    for a, b in zip(out[1], out[0]):
        np.testing.assert_array_equal(a, b)


# name -> (initializer, expected std, uniform half-width or None)
def _xavier_scale(shape, factor_type, magnitude):
    hw = np.prod(shape[2:]) if len(shape) > 2 else 1.
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {'avg': (fan_in + fan_out) / 2.0, 'in': fan_in,
              'out': fan_out}[factor_type]
    return math.sqrt(magnitude / factor)


RANDOM_SHAPE = (128, 64, 3, 3)
RANDOM = {
    'uniform': (lambda p: p.Uniform(0.1), 0.1 / math.sqrt(3), 0.1),
    'normal': (lambda p: p.Normal(0.05), 0.05, None),
    'xavier_default': (lambda p: p.Xavier(),
                       _xavier_scale(RANDOM_SHAPE, 'avg', 3) / math.sqrt(3),
                       _xavier_scale(RANDOM_SHAPE, 'avg', 3)),
    'xavier_gaussian_in_2': (
        lambda p: p.Xavier(rnd_type='gaussian', factor_type='in',
                           magnitude=2),
        _xavier_scale(RANDOM_SHAPE, 'in', 2), None),
    'xavier_uniform_out': (
        lambda p: p.Xavier(factor_type='out', magnitude=6),
        _xavier_scale(RANDOM_SHAPE, 'out', 6) / math.sqrt(3),
        _xavier_scale(RANDOM_SHAPE, 'out', 6)),
    'msra_prelu': (lambda p: p.MSRAPrelu(),
                   _xavier_scale(RANDOM_SHAPE, 'avg', 2.0 / 1.0625), None),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(RANDOM))
def test_random_initializer_shape_dtype_bounds_and_moments(case, dtype):
    make, std, bound = RANDOM[case]
    mx.random.seed(4)
    with mx.cpu():
        arr = mx.nd.zeros(RANDOM_SHAPE, dtype=dtype)
        make(tinit)(tinit.InitDesc('conv_weight'), arr)
    assert arr.shape == RANDOM_SHAPE
    assert arr.handle.dtype == getattr(torch, dtype)
    x = arr.asnumpy().astype(np.float64)
    n = x.size
    assert abs(x.mean()) < 5 * std / math.sqrt(n)
    assert abs(x.std() / std - 1) < 0.02
    if bound is not None:
        assert np.abs(x).max() <= bound * (1 + 2 ** -8)
    # the JAX package's draw has the same moments
    jarr = jmx.nd.zeros(RANDOM_SHAPE)
    make(jinit)(jinit.InitDesc('conv_weight'), jarr)
    assert abs(jarr.asnumpy().std() / std - 1) < 0.02


class _Recorder:
    """An initializer class per package whose weight fill is 7 and whose
    default fill is -1, so every dispatch target shows in the values."""

    @staticmethod
    def make(p):
        class Rec(p.Initializer):
            def _init_weight(self, name, arr):
                arr[:] = 7.0

            def _init_default(self, name, arr):
                arr[:] = -1.0
        return Rec()


DISPATCH_NAMES = ['fc_weight', 'fc_bias', 'bn_gamma', 'bn_beta',
                  'bn_moving_mean', 'bn_moving_var', 'x_running_mean',
                  'y_running_var', 'z_moving_inv_var', 'w_moving_avg',
                  'UPPER_WEIGHT', 'Gamma', 'stuff', 'weight_bias']


def test_name_dispatch_matches_jax():
    for name in DISPATCH_NAMES:
        ref, got = _init_both(_Recorder.make, (3,), name=name)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    # the variable's __init__ attribute wins over the name
    out = []
    for p, nd, ctx in ((jinit, jmx.nd, jmx.cpu()), (tinit, mx.nd, mx.cpu())):
        arr = nd.zeros((2,), ctx)
        desc = p.InitDesc('fc_bias', attrs={
            '__init__': json.dumps(['constant', {'value': 0.5}])})
        _Recorder.make(p)(desc, arr)
        out.append(arr.asnumpy())
        with pytest.raises(ValueError):
            p.Uniform()(p.InitDesc('stuff'), nd.zeros((2,), ctx))
    np.testing.assert_array_equal(out[1], out[0])
    assert tinit.Xavier(magnitude=2).dumps() == \
        jinit.Xavier(magnitude=2).dumps()


def test_fused_rnn_initializer_raises():
    """FusedRNN against the JAX initializer: its dumps() and the flat
    vector it gives under Orthogonal (numpy's global draws) and LSTMBias
    are the JAX initializer's, bit for bit; without an inner init and a
    global initializer in scope it raises, as the JAX one does."""
    assert tinit.FusedRNN(None, 8, 1, 'lstm').dumps() == \
        jinit.FusedRNN(None, 8, 1, 'lstm').dumps()
    out = []
    for p, ctx in ((tinit, mx.cpu()), (jinit, jmx.cpu())):
        fused = p.FusedRNN(p.Orthogonal(), 8, 2, 'lstm', bidirectional=True,
                           forget_bias=1.5)
        arr = (mx if p is tinit else jmx).nd.zeros((2816,), ctx=ctx)
        np.random.seed(5)
        p.Uniform()(p.InitDesc('lstm_parameters',
                               attrs={'__init__': fused.dumps()}), arr)
        out.append(arr.asnumpy())
    np.testing.assert_array_equal(out[0], out[1])
    for p, ctx in ((tinit, mx.cpu()), (jinit, jmx.cpu())):
        arr = (mx if p is tinit else jmx).nd.zeros((2816,), ctx=ctx)
        with pytest.raises(AssertionError, match='global initializer'):
            p.FusedRNN(None, 8, 2, 'lstm', bidirectional=True)._init_weight(
                p.InitDesc('lstm_parameters'), arr)
