"""Parity of the port's imperative core (mxnet_tpu_torch.nd, random and
contexts) with the JAX package's, on the CPU.

Every op name that mxnet_tpu/ops/tensor.py registers runs in both
packages on the same seeded float32 inputs (the case table of
mxnet_tpu_torch/tools/op_consistency.py, whose cases follow
tests/test_ndarray.py), exact for data movement and integer results and
within rtol 1e-5 / atol 1e-6 for float math.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.tools import op_consistency as oc

REPO = Path(__file__).resolve().parent.parent
N = 8
# the CPU comparison with the JAX package: exact stays exact, float math
# and reductions at float32 elementwise tolerance
CPU_TOL = {oc.EXACT: oc.EXACT, oc.FLOAT: oc.FLOAT, oc.REDUCE: oc.FLOAT}


def _names(registry, module):
    """The names, aliases included, that `module` registers."""
    ops = {n for n, op in registry._OP_REGISTRY.items()
           if op.fcompute.__module__ == module}
    return sorted(ops | {a for a, n in registry._OP_ALIASES.items()
                         if n in ops})


TENSOR_NAMES = _names(jreg, 'mxnet_tpu.ops.tensor')


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize('module', ['tensor', 'random_ops'])
def test_registers_the_names_of_its_jax_namesake(module):
    assert _names(reg, 'mxnet_tpu_torch.ops.' + module) == \
        _names(jreg, 'mxnet_tpu.ops.' + module)


def test_op_table_covers_every_tensor_op():
    assert sorted(oc.CASES) == TENSOR_NAMES
    assert len(TENSOR_NAMES) > 150


@pytest.mark.parametrize('name', TENSOR_NAMES)
def test_op_matches_jax(name):
    arrays, attrs, tol = oc.case(name, N)
    got = oc.call(nd, name, [nd.array(a) for a in arrays], attrs)
    ref = oc.call(jnd, name, [jnd.array(a) for a in arrays], attrs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        why = oc.mismatch(g.asnumpy(), r.asnumpy(), CPU_TOL[tol])
        assert why is None, why


@pytest.mark.parametrize('name', sorted(oc.VARIANTS))
def test_op_variant_matches_jax(name):
    """topk on ties in both directions, at k 1, 3 and 7 and every
    ret_typ; each index op with indices -n <= i < 0 and past the end."""
    arrays, attrs, tol = oc.case(name, N)
    op = oc.op_of(name)
    got = oc.call(nd, op, [nd.array(a) for a in arrays], attrs)
    ref = oc.call(jnd, op, [jnd.array(a) for a in arrays], attrs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        why = oc.mismatch(g.asnumpy(), r.asnumpy(), CPU_TOL[tol])
        assert why is None, why


def test_topk_breaks_ties_as_jax():
    x = np.array([[1, 2, 2, 0, 2, 1], [3, 3, 1, 3, 0, 0]], np.float32)
    for kw in (dict(k=3, ret_typ='both'), dict(k=2, ret_typ='mask'),
               dict(k=3, ret_typ='indices', is_ascend=True)):
        got = nd.topk(nd.array(x), **kw)
        ref = jnd.topk(jnd.array(x), **kw)
        for g, r in zip(*(o if isinstance(o, list) else [o]
                          for o in (got, ref))):
            np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())
    np.testing.assert_array_equal(
        nd.topk(nd.array(x), k=3).asnumpy(), [[1, 2, 4], [0, 1, 3]])


def test_pick_counts_from_the_end_and_fills_past_it():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for idx, want in (([0, 1, -1], [0, 5, 11]), ([0, 1, 4], [0, 5, np.nan]),
                      ([-4, -5, 2], [0, np.nan, 10])):
        got = nd.pick(nd.array(x), nd.array(idx), axis=1).asnumpy()
        ref = jnd.pick(jnd.array(x), jnd.array(idx), axis=1).asnumpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)


def _integer_inputs(name, dtype):
    """The case's inputs as integers of `dtype`: index arrays keep their
    values (clipped at 0 for uint8), the others are rounded after scaling
    by 3, so that each domain (positive divisors, nonzero bases) holds,
    NaN taken as 0, and taken in magnitude for uint8."""
    arrays, attrs, tol = oc.case(name, N)
    kinds = oc.CASES[name][0]
    out = []
    for kind, a in zip(kinds, arrays):
        if 'idx' in kind or kind in ('nd_perm', 'mask'):
            v = a if dtype == 'int32' else np.maximum(a, 0)
        else:
            v = np.rint(np.nan_to_num(a) * 3)
            v = v if dtype == 'int32' else np.abs(v)
        out.append(v.astype(dtype))
    return out, attrs, tol


@pytest.mark.parametrize('dtype', ['int32', 'uint8'])
@pytest.mark.parametrize('name', TENSOR_NAMES)
def test_op_matches_jax_at_integer_dtype(name, dtype):
    """Result dtype and value of every op at int32 and uint8 inputs
    against the JAX package's (sums in int32 or uint32, rint and hypot in
    float32, integer powers and remainders by 0 as jnp computes them).
    An op that JAX refuses at that dtype (sigmoid) has nothing to hold the
    port to."""
    arrays, attrs, tol = _integer_inputs(name, dtype)
    try:
        ref = oc.call(jnd, name, [jnd.array(a, dtype=dtype) for a in arrays],
                      attrs)
    except TypeError:
        return
    got = oc.call(nd, name, [nd.array(a, dtype=dtype) for a in arrays],
                  attrs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        why = oc.mismatch(g.asnumpy(), r.asnumpy(), CPU_TOL[tol])
        assert why is None, why


def _pair(seed=0, shape=(3, 4)):
    rs = np.random.RandomState(seed)
    a = (rs.rand(*shape) + 0.5).astype(np.float32)
    b = (rs.rand(*shape) + 0.5).astype(np.float32)
    return a, b


DUNDER = {
    'add': lambda a, b: a + b, 'sub': lambda a, b: a - b,
    'mul': lambda a, b: a * b, 'div': lambda a, b: a / b,
    'mod': lambda a, b: a % b, 'pow': lambda a, b: a ** b,
    'add_scalar': lambda a, b: a + 1, 'radd': lambda a, b: 2.5 + a,
    'rsub': lambda a, b: 1 - a, 'rmul': lambda a, b: 2 * a,
    'rdiv': lambda a, b: 6 / a, 'rmod': lambda a, b: 3 % a,
    'pow_scalar': lambda a, b: a ** 2, 'rpow': lambda a, b: 2 ** a,
    'neg': lambda a, b: -a, 'abs': lambda a, b: abs(a - 1),
    'gt': lambda a, b: a > b, 'ge': lambda a, b: a >= 1.0,
    'lt': lambda a, b: a < b, 'le': lambda a, b: a <= b,
    'eq': lambda a, b: a == a, 'ne': lambda a, b: a != b,
    'broadcast_add': lambda a, b: a + b[:1],
    'broadcast_gt': lambda a, b: a > b[:1],
}


@pytest.mark.parametrize('name', sorted(DUNDER))
def test_dunder_operators_match_jax(name):
    a, b = _pair()
    fn = DUNDER[name]
    got = fn(nd.array(a), nd.array(b)).asnumpy()
    ref = fn(jnd.array(a), jnd.array(b)).asnumpy()
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('op', ['iadd', 'isub', 'imul', 'itruediv'])
def test_inplace_operators_match_jax(op):
    a, b = _pair(1)
    out = []
    for pkg in (nd, jnd):
        x = pkg.array(a)
        x = getattr(x, '__%s__' % op)(pkg.array(b))
        x = getattr(x, '__%s__' % op)(2)
        out.append(x.asnumpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)


GETITEM = [1, (slice(1, 3),), (slice(None), 2), (1, slice(0, 4, 2)),
           (slice(None, None, -1),), (slice(None), slice(3, 0, -2))]


@pytest.mark.parametrize('key', GETITEM, ids=str)
def test_getitem_matches_jax(key):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    key = key[0] if isinstance(key, tuple) and len(key) == 1 else key
    got = nd.array(a)[key].asnumpy()
    np.testing.assert_array_equal(got, jnd.array(a)[key].asnumpy())


def test_getitem_by_index_array():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([2, 0], np.int32)
    got = nd.array(a)[nd.array(idx)].asnumpy()
    np.testing.assert_array_equal(got, jnd.array(a)[jnd.array(idx)].asnumpy())


SETITEM = [
    ('all', slice(None), 0.0), ('row', 1, 5.0), ('block', (slice(0, 2), 1), 7),
    ('array', slice(None), np.full((3, 4), 2.5, np.float32)),
    ('row_list', 2, [1.0, 2.0, 3.0, 4.0]),
]


@pytest.mark.parametrize('what,key,value', SETITEM, ids=[s[0] for s in SETITEM])
def test_setitem_matches_jax(what, key, value):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = []
    for pkg in (nd, jnd):
        x = pkg.array(a)
        x[key] = value
        out.append(x.asnumpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_setitem_from_an_ndarray():
    x = nd.array(np.zeros((3, 4), np.float32))
    x[1] = nd.array(np.ones((4,), np.float32))
    np.testing.assert_array_equal(x.asnumpy()[1], np.ones(4))


VIEWS = {
    'reshape': lambda x: x.reshape((4, 3)),
    'transpose': lambda x: x.T,
    'expand_dims': lambda x: x.expand_dims(0),
    'getitem': lambda x: x[1],
    'slice_axis': lambda x: nd.slice_axis(x, axis=0, begin=0, end=2),
    'broadcast_to': lambda x: x[0:1].broadcast_to((3, 4)),
    'identity': lambda x: nd.identity(x),
    'BlockGrad': lambda x: nd.BlockGrad(x),
    'flatten': lambda x: x.flatten(),
    'split': lambda x: x.split(num_outputs=2, axis=1)[0],
    'detach_copy': lambda x: x.copy(),
}


@pytest.mark.parametrize('name', sorted(VIEWS))
def test_results_do_not_alias_their_input(name):
    """An op's result is new storage, as JAX arrays never alias: writing
    into it leaves its input unchanged, and writing into the input
    leaves it unchanged."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = nd.array(a)
    y = VIEWS[name](x)
    before = y.asnumpy().copy()
    y[:] = -1.0
    np.testing.assert_array_equal(x.asnumpy(), a)
    y = VIEWS[name](x)
    x[:] = 100.0
    np.testing.assert_array_equal(y.asnumpy(), before)


RESHAPES = [((2, 3, 4), (-2,)), ((2, 3, 4), (0, -3)),
            ((2, 3, 4), (-4, 1, 2, 0, 0)), ((2, 3, 4), (0, -1)),
            ((2, 3, 4), (-3, 2, 2)), ((2, 3, 4), (6, -1)),
            ((2, 3, 4), (-4, -1, 1, 3, 4))]


@pytest.mark.parametrize('shape,spec', RESHAPES, ids=str)
def test_reshape_special_codes_match_jax(shape, spec):
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = nd.array(a).reshape(spec)
    ref = jnd.array(a).reshape(spec)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_reshape_reverse_matches_jax():
    a = np.zeros((10, 5, 4), np.float32)
    got = nd.Reshape(nd.array(a), shape=(-1, 0), reverse=True)
    ref = jnd.Reshape(jnd.array(a), shape=(-1, 0), reverse=True)
    assert got.shape == ref.shape == (50, 4)


def _save_arrays(pkg):
    rs = np.random.RandomState(3)
    return {'arg:w': pkg.array(rs.rand(3, 4).astype(np.float32)),
            'arg:i': pkg.array(rs.randint(-9, 9, (5,)).astype(np.int32)),
            'aux:h': pkg.array(rs.rand(2, 2).astype(np.float16)),
            'aux:u': pkg.array(rs.randint(0, 255, (7,)).astype(np.uint8)),
            'aux:s': pkg.array(np.float32(2.5))}


@pytest.mark.parametrize('form', ['dict', 'list'])
def test_save_is_byte_identical_to_jax(tmp_path, form):
    files = []
    for pkg, tag in ((nd, 'port'), (jnd, 'jax')):
        data = _save_arrays(pkg)
        if form == 'list':
            data = list(data.values())
        fname = str(tmp_path / ('%s.params' % tag))
        pkg.save(fname, data)
        files.append(open(fname, 'rb').read())
    assert files[0][:8] == b'MXTPU001'
    assert files[0] == files[1]


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
@pytest.mark.parametrize('form', ['dict', 'list'])
def test_load_reads_the_other_package_bit_for_bit(tmp_path, writer, reader,
                                                  form):
    pkgs = {'port': nd, 'jax': jnd}
    data = _save_arrays(pkgs[writer])
    if form == 'list':
        data = list(data.values())
    fname = str(tmp_path / 'x.params')
    pkgs[writer].save(fname, data)
    loaded = pkgs[reader].load(fname)
    if form == 'dict':
        assert sorted(loaded) == sorted(data)
        pairs = [(loaded[k], data[k]) for k in data]
    else:
        assert len(loaded) == len(data)
        pairs = list(zip(loaded, data))
    for got, want in pairs:
        g, w = got.asnumpy(), want.asnumpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_bfloat16_saves_as_float32_as_in_jax(tmp_path):
    a = np.array([1.0, 2.5, -3.0], np.float32)
    port, jax_file = str(tmp_path / 'p'), str(tmp_path / 'j')
    nd.save(port, [nd.array(a, dtype='bfloat16')])
    import jax.numpy as jnp
    jnd.save(jax_file, [jnd.array(a, dtype=jnp.bfloat16)])
    assert open(port, 'rb').read() == open(jax_file, 'rb').read()
    x = nd.array(a, dtype='bfloat16')
    assert x.dtype == torch.bfloat16 and x.asnumpy().dtype == np.float32


@pytest.mark.parametrize('cut', [4, 8, 20, 40, -1])
def test_truncated_file_raises_the_jax_message(tmp_path, cut):
    fname = str(tmp_path / 'full.params')
    nd.save(fname, _save_arrays(nd))
    blob = open(fname, 'rb').read()
    short = str(tmp_path / 'short.params')
    with open(short, 'wb') as f:
        f.write(blob[:cut])
    with pytest.raises(mx.MXNetError, match='Truncated or corrupt') as got:
        nd.load(short)
    with pytest.raises(jmx.MXNetError) as ref:
        jnd.load(short)
    assert str(got.value) == str(ref.value)


SAMPLES = 100000


def _moments_within_5_sigma(x, mean, var):
    why = oc.moments_mismatch(x, mean, var)
    assert why is None, why


@pytest.mark.parametrize('name', sorted(oc.SAMPLERS))
def test_sampler_shape_dtype_and_moments(name):
    kwargs, mean, var = oc.SAMPLERS[name]
    mx.random.seed(7)
    x = getattr(mx.random, name)(shape=(SAMPLES // 10, 10), **kwargs)
    assert x.shape == (SAMPLES // 10, 10) and x.dtype == np.float32
    _moments_within_5_sigma(x.asnumpy(), mean, var)
    ref = getattr(jmx.random, name)(shape=(4, 10), **kwargs)
    assert ref.dtype == x.dtype


def test_run_samplers_on_a_context():
    assert oc.run_samplers(mx, mx.cpu(), 20000, seed=3) == {}


# multi-distribution sampler -> (parameters, mean, variance) per element
MSAMPLERS = {
    'sample_uniform': ([[0.0, 2.0], [1.0, 5.0]],
                       lambda l, h: ((l + h) / 2, (h - l) ** 2 / 12)),
    'sample_normal': ([[0.0, -3.0], [1.0, 2.0]], lambda m, s: (m, s * s)),
    'sample_gamma': ([[1.0, 4.0], [2.0, 0.5]],
                     lambda a, b: (a * b, a * b * b)),
    'sample_exponential': ([[1.0, 4.0]], lambda lam: (1 / lam, 1 / lam ** 2)),
    'sample_poisson': ([[1.0, 6.0]], lambda lam: (lam, lam)),
    'sample_negative_binomial': (
        [[2.0, 5.0], [0.5, 0.3]],
        lambda k, p: (k * (1 - p) / p, k * (1 - p) / p ** 2)),
    'sample_generalized_negative_binomial': (
        [[1.0, 3.0], [0.2, 1.0]],
        lambda mu, a: (mu, mu + a * mu * mu)),
}


@pytest.mark.parametrize('name', sorted(MSAMPLERS))
def test_multi_sampler_moments(name):
    params, moments = MSAMPLERS[name]
    mx.random.seed(11)
    arrays = [nd.array(np.array(p, np.float32)) for p in params]
    x = getattr(nd, name)(*arrays, shape=(SAMPLES,))
    assert x.shape == (2, SAMPLES) and x.dtype == np.float32
    ref = getattr(jnd, name)(*[jnd.array(np.array(p, np.float32))
                               for p in params], shape=(3,))
    assert ref.shape == (2, 3)
    for i in range(2):
        mean, var = moments(*[np.float64(p[i]) for p in params])
        _moments_within_5_sigma(x.asnumpy()[i], mean, var)


def test_multinomial_frequencies_and_log_probs():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    mx.random.seed(3)
    draws, logp = nd.random.multinomial(nd.array(probs), shape=SAMPLES,
                                        get_prob=True)
    assert draws.shape == (2, SAMPLES) and draws.dtype == np.int32
    ref = jnd.sample_multinomial(jnd.array(probs), shape=4)
    assert ref.dtype == draws.dtype
    d = draws.asnumpy()
    for row in range(2):
        for k in range(3):
            p = probs[row, k]
            freq = (d[row] == k).mean()
            assert abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / SAMPLES)
    np.testing.assert_allclose(logp.asnumpy(),
                               np.log(probs)[np.arange(2)[:, None], d],
                               rtol=1e-5)


def test_seed_repeats_the_stream_and_touches_no_global_state():
    torch.manual_seed(123)
    state = torch.get_rng_state()
    mx.random.seed(42)
    a = nd.uniform(low=0, high=1, shape=(100,)).asnumpy()
    mx.random.seed(42)
    b = nd.uniform(low=0, high=1, shape=(100,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert torch.equal(torch.get_rng_state(), state)
    assert 0 <= a.min() and a.max() <= 1


def test_default_context_needs_cuda_and_cpu_scope_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from mxnet_tpu_torch.context import Context
    monkeypatch.setattr(Context._default_ctx, 'value', None, raising=False)
    with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
        nd.ones((2,))
    with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
        mx.current_context()
    with mx.cpu():
        assert mx.current_context() == mx.cpu(0)
        x = nd.ones((2,)) * 3
        assert x.context == mx.cpu(0)
        np.testing.assert_array_equal(x.asnumpy(), [3, 3])


def test_contexts():
    assert mx.tpu(1) == mx.gpu(1) and str(mx.tpu(1)) == 'gpu(1)'
    assert mx.gpu(2).torch_device == torch.device('cuda', 2)
    assert mx.cpu().torch_device == torch.device('cpu')
    assert mx.Context('cpu_pinned', 0) == mx.cpu(0)
    assert mx.num_gpus() == torch.cuda.device_count()


def test_inputs_on_two_contexts_raise():
    a = nd.ones((2,))
    b = nd.NDArray(torch.ones(2), mx.gpu(0))   # labelled, never launched
    with pytest.raises(mx.MXNetError, match='not moved between devices'):
        a + b


def test_copyto_and_astype_match_jax():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    x = nd.array(a)
    y = x.copyto(mx.cpu(0))
    z = nd.zeros((2, 3), dtype='int32')
    x.copyto(z)
    assert z.dtype == np.int32
    np.testing.assert_array_equal(z.asnumpy(), jnd.array(a).astype(
        np.int32).asnumpy())
    y[:] = 0
    np.testing.assert_array_equal(x.asnumpy(), a)
    assert x.astype('int32').dtype == jnd.array(a).astype('int32').dtype


def test_creation_dtypes_match_jax():
    for make in (lambda p: p.array([1, 2]), lambda p: p.array(np.arange(3)),
                 lambda p: p.array(np.arange(3.0)),
                 lambda p: p.arange(0, 5), lambda p: p.zeros((2, 2)),
                 lambda p: p.ones((2,), dtype='int32'),
                 lambda p: p.full((2,), 3.5)):
        got, ref = make(nd), make(jnd)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_package_surface_and_import_builds_nothing():
    """`import mxnet_tpu_torch as mx` gives the JAX package's imperative
    names, and importing every module of the port compiles nothing and
    imports neither JAX nor the JAX package."""
    for name in ('nd', 'autograd', 'random', 'rtc', 'cpu', 'gpu', 'tpu',
                 'Context', 'current_context', 'MXNetError'):
        assert hasattr(mx, name), name
    code = (
        'import sys\n'
        'before = set(sys.modules)\n'
        'import mxnet_tpu_torch as mx, mxnet_tpu_torch.tools.op_consistency\n'
        'from mxnet_tpu_torch import _build, _nvrtc, rtc\n'
        'added = set(sys.modules) - before\n'
        "bad = sorted(m for m in added if m == 'jax' or "
        "m.startswith('jax.') or m == 'mxnet_tpu' or "
        "m.startswith('mxnet_tpu.'))\n"
        'print(repr(bad), _build._lib, sorted(_nvrtc._libs), '
        'rtc.RTC_COMPILES)\n')
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[] None [] 0'
