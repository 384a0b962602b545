"""Every registered tensor op on two contexts from the same seeded
inputs: the reference's check_consistency pattern (test_utils.py, cpu
against gpu), for chip_smoke.py's phase 7, and the table of cases the
CPU tests run against the JAX package; and the samplers' moments on one
context (`SAMPLERS`, `run_samplers`).

`CASES` has one entry for each name, aliases included, that
`ops/tensor.py` registers: the inputs it takes (by kind, made by
`inputs`), its attrs and its tolerance class. Inputs are float32, n x n
where the op takes a matrix, and drawn inside each op's domain: positive
where a sum, product or divisor must stay away from 0, in (-0.9, 0.9)
for arcsin, on a grid of quarters where comparisons need ties, and so
on. Index arrays are float32, as the JAX package takes them.

Tolerances: data movement, selections and integer results are exact;
elementwise float math rtol 1e-5, atol 1e-6 (the two devices' libm
differ by a few ulp); reductions and products rtol 1e-4, on positive
inputs so that no sum is near 0, with TF32 off (the caller sets it).
"""
import zlib

import numpy as np

EXACT, FLOAT, REDUCE = 'exact', 'float', 'reduce'
TOL = {EXACT: dict(rtol=0.0, atol=0.0), FLOAT: dict(rtol=1e-5, atol=1e-6),
       REDUCE: dict(rtol=1e-4, atol=0.0)}


def inputs(kinds, n, rng):
    """numpy float32 inputs of the given kinds for size n (n even)."""
    def uni(lo, hi, shape=(n, n)):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def grid(shape=(n, n)):       # quarters in [-2, 2]: ties and halves
        return (rng.integers(-8, 9, shape) / 4.0).astype(np.float32)

    make = {
        'm': lambda: uni(-1, 1), 'p': lambda: uni(0.5, 2.0),
        'q': lambda: uni(1.5, 2.5), 'u': lambda: uni(-0.9, 0.9),
        'h': lambda: uni(1.1, 3.0), 'g': lambda: uni(2.5, 4.5),
        'w': lambda: uni(-100, 100), 'r': grid,
        'near1': lambda: uni(0.99, 1.01),
        'row': lambda: uni(-1, 1, (1, n)), 'rowp': lambda: uni(0.5, 2, (1, n)),
        'rowq': lambda: uni(1.5, 2.5, (1, n)), 'rowr': lambda: grid((1, n)),
        'col': lambda: uni(-1, 1, (n, 1)),
        'nan': lambda: np.where(rng.random((n, n)) < 0.05, np.nan,
                                uni(0.5, 2.0)).astype(np.float32),
        'nan1': lambda: np.where(rng.random((n, n)) < 0.05, np.nan,
                                 uni(0.99, 1.01)).astype(np.float32),
        'mask': lambda: (rng.random((n, n)) < 0.5).astype(np.float32),
        'idx': lambda: rng.integers(0, n, (n,)).astype(np.float32),
        'idx_out': lambda: rng.integers(-2, n + 2, (n,)).astype(np.float32),
        'nd_idx': lambda: rng.integers(0, n, (2, n)).astype(np.float32),
        'nd_perm': lambda: np.stack([np.arange(n), rng.permutation(n)])
        .astype(np.float32),
        'vec': lambda: uni(-1, 1, (n,)),
        'half': lambda: uni(-1, 1, (n // 2, n // 2)),
        'batch': lambda: uni(-1, 1, (2, n, n)),
        'batchp': lambda: uni(0.5, 2.0, (2, n, n)),
        'nchw': lambda: uni(-1, 1, (1, 4, n, n)),
        'nchw16': lambda: uni(-1, 1, (1, 16, n // 2, n // 2)),
    }
    return [make[k]() for k in kinds]


def _cases():
    c = {}

    def add(names, kinds, tol, **attrs):
        for name in names.split():
            c[name] = (tuple(kinds.split()), attrs, tol)

    # elementwise binary, same shape
    add('elemwise_add _add _plus _Plus _grad_add', 'm m', EXACT)
    add('elemwise_sub _sub _minus _Minus', 'm m', EXACT)
    add('elemwise_mul _mul _Mul', 'm m', EXACT)
    add('elemwise_div _div _Div', 'm p', FLOAT)
    add('_power _Power', 'p m', FLOAT)
    add('_maximum _Maximum maximum _minimum _Minimum minimum', 'm m', EXACT)
    add('_hypot', 'm m', FLOAT)
    add('_mod _Mod', 'm q', FLOAT)
    add('_equal _not_equal _greater _greater_equal _lesser _lesser_equal',
        'r r', EXACT)
    # scalar
    add('_plus_scalar _minus_scalar _rminus_scalar', 'm', EXACT, scalar=0.5)
    add('_mul_scalar', 'm', EXACT, scalar=1.5)
    add('_div_scalar', 'm', FLOAT, scalar=3.0)
    add('_rdiv_scalar', 'p', FLOAT, scalar=2.0)
    add('_power_scalar', 'p', FLOAT, scalar=1.5)
    add('_rpower_scalar', 'm', FLOAT, scalar=2.0)
    add('_maximum_scalar _minimum_scalar', 'm', EXACT, scalar=0.1)
    add('_mod_scalar', 'm', FLOAT, scalar=0.3)
    add('_rmod_scalar', 'q', FLOAT, scalar=3.0)
    add('_hypot_scalar', 'm', FLOAT, scalar=0.5)
    add('_equal_scalar _not_equal_scalar _greater_scalar '
        '_greater_equal_scalar _lesser_scalar _lesser_equal_scalar', 'r',
        EXACT, scalar=0.25)
    # unary
    add('negative abs sign round rint ceil floor trunc fix zeros_like '
        'ones_like relu _copy identity BlockGrad stop_gradient make_loss '
        'MakeLoss _CrossDeviceCopy', 'r', EXACT)
    add('square exp expm1 sin cos tan arctan degrees radians sinh cosh tanh '
        'arcsinh sigmoid softsign', 'm', FLOAT)
    add('reciprocal sqrt rsqrt cbrt rcbrt log log10 log2 log1p', 'p', FLOAT)
    add('arcsin arccos arctanh', 'u', FLOAT)
    add('arccosh', 'h', FLOAT)
    add('gamma gammaln', 'g', FLOAT)
    add('Cast', 'w', EXACT, dtype='int32')
    add('cast', 'm', EXACT, dtype='float16')
    add('clip', 'm', EXACT, a_min=-0.5, a_max=0.5)
    add('_identity_with_attr_like_rhs', 'm m', EXACT)
    add('_NoGradient', '', EXACT)
    # broadcast
    add('broadcast_add broadcast_plus broadcast_sub broadcast_minus '
        'broadcast_mul broadcast_maximum broadcast_minimum', 'm row', EXACT)
    add('broadcast_div', 'm rowp', FLOAT)
    add('broadcast_mod', 'm rowq', FLOAT)
    add('broadcast_power', 'p row', FLOAT)
    add('broadcast_hypot', 'm col', FLOAT)
    add('broadcast_equal broadcast_not_equal broadcast_greater '
        'broadcast_greater_equal broadcast_lesser broadcast_lesser_equal',
        'r rowr', EXACT)
    add('broadcast_to', 'row', EXACT, shape=None)
    add('broadcast_axis broadcast_axes', 'col', EXACT, axis=1, size=None)
    # reductions
    add('sum mean', 'p', REDUCE, axis=1)
    add('sum_axis', 'p', REDUCE, axis=0, keepdims=True)
    add('prod', 'near1', REDUCE, axis=1)
    add('nansum', 'nan', REDUCE, axis=0)
    add('nanprod', 'nan1', REDUCE, axis=1)
    add('norm', 'm', REDUCE)
    add('max min', 'm', EXACT, axis=1)
    add('max_axis min_axis', 'm', EXACT, axis=0, keepdims=True)
    add('argmax', 'm', EXACT, axis=1)
    add('argmin', 'm', EXACT, axis=0, keepdims=True)
    add('argmax_channel', 'm', EXACT)
    # matrix
    add('dot', 'p p', REDUCE, transpose_b=True)
    add('batch_dot', 'batchp batchp', REDUCE)
    add('transpose', 'm', EXACT)
    add('SwapAxis swapaxes', 'batch', EXACT, dim1=0, dim2=2)
    add('expand_dims', 'm', EXACT, axis=-1)
    add('Reshape', 'm', EXACT, shape=(-4, 2, -1, -2))
    add('reshape', 'batch', EXACT, shape=(-3, 0))
    add('Flatten flatten', 'batch', EXACT)
    add('Concat', 'm m', EXACT, num_args=2, dim=1)
    add('concat', 'm m', EXACT, num_args=2, dim=0)
    add('SliceChannel', 'm', EXACT, num_outputs=2, axis=1)
    add('split', 'm', EXACT, num_outputs=2, axis=0, squeeze_axis=False)
    add('slice crop', 'm', EXACT, begin=(1, None), end=(-1, None),
        step=(1, -2))
    add('slice_axis', 'm', EXACT, axis=1, begin=1, end=-1)
    add('reverse', 'm', EXACT, axis=1)
    add('flip', 'm', EXACT, axis=(0, 1))
    add('tile', 'm', EXACT, reps=(2, 1))
    add('repeat', 'm', EXACT, repeats=2, axis=0)
    add('Pad', 'm', EXACT, pad_width=(1, 2, 3, 4), mode='constant',
        constant_value=0.5)
    add('pad', 'm', EXACT, pad_width=(2, 1, 1, 2), mode='reflect')
    add('stack', 'm m', EXACT, num_args=2, axis=1)
    add('space_to_depth', 'nchw', EXACT, block_size=2)
    add('depth_to_space', 'nchw16', EXACT, block_size=2)
    add('add_n ElementWiseSum _sum', 'm m m', FLOAT, num_args=3)
    # indexing
    add('Embedding', 'idx_out m', EXACT, input_dim=None, output_dim=None)
    add('take', 'm idx_out', EXACT, axis=0, mode='clip')
    add('batch_take', 'm idx', EXACT)
    add('pick', 'm idx', EXACT, axis=1)
    add('one_hot', 'idx_out', EXACT, depth=None)
    add('where', 'mask m m', EXACT)
    add('gather_nd', 'm nd_idx', EXACT)
    add('scatter_nd', 'vec nd_perm', EXACT, shape=None)
    add('_backward_gather_nd scatter_nd_acc', 'vec nd_idx', FLOAT, shape=None)
    # ordering
    add('sort', 'm', EXACT, axis=1, is_ascend=False)
    add('argsort', 'm', EXACT, axis=1)
    add('topk', 'm', EXACT, axis=1, k=3, ret_typ='both')
    # init
    add('_zeros zeros _ones ones', '', EXACT, shape=None)
    add('_full full', '', EXACT, shape=None, value=2.5)
    add('_arange arange', '', EXACT, start=0, stop=None, step=0.5)
    add('_eye eye', '', EXACT, N=None, k=1)
    # slice-assign
    add('_slice_assign _crop_assign', 'm half', EXACT, begin=(1, 2),
        end=None)
    add('_crop_assign_scalar', 'm', EXACT, begin=(1, 2), end=None,
        scalar=3.0)
    return c


CASES = _cases()

# attrs that take the size n: name of the attr -> its value for size n
_SIZED = {'size': lambda n: n, 'input_dim': lambda n: n,
          'output_dim': lambda n: n, 'depth': lambda n: n,
          'N': lambda n: n, 'stop': lambda n: float(n),
          'shape': lambda n: (n, n),
          'end': lambda n: (1 + n // 2, 2 + n // 2)}


def case(name, n, seed=0):
    """(numpy inputs, attrs, tolerance class) of op `name` at size n,
    from a generator seeded by seed and the name."""
    kinds, attrs, tol = CASES[name]
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    attrs = {k: (_SIZED[k](n) if v is None else v) for k, v in attrs.items()}
    return inputs(kinds, n, rng), attrs, tol


def call(nd, name, arrays, attrs):
    """nd.<name>(*arrays, **attrs) through the generated wrapper, or
    through invoke where a hand-written function (zeros, full, arange)
    holds the name. Returns a list of outputs."""
    fn = getattr(nd, name)
    if getattr(fn, '__name__', None) != name or \
            not (fn.__doc__ or '').startswith('Auto-generated'):
        out = nd.invoke(name, list(arrays), dict(attrs))
    else:
        out = fn(*arrays, **attrs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def mismatch(got, ref, tol):
    """None if `got` matches `ref` (numpy) under tolerance class `tol`,
    else a description."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return 'shape/dtype %s %s vs %s %s' % (got.shape, got.dtype,
                                               ref.shape, ref.dtype)
    t = TOL[tol]
    if t['rtol'] == 0 and t['atol'] == 0:
        same = np.array_equal(got, ref, equal_nan=got.dtype.kind == 'f')
        return None if same else 'not equal: %d of %d elements differ' % (
            int((got != ref).sum()), got.size)
    g, r = got.astype(np.float64), ref.astype(np.float64)
    ok = np.isclose(g, r, rtol=t['rtol'], atol=t['atol'], equal_nan=True)
    if ok.all():
        return None
    err = np.abs(g - r)
    return 'max |diff| %.3g, max rel %.3g, %d elements over rtol %g ' \
        'atol %g' % (np.nanmax(err), np.nanmax(err / np.maximum(np.abs(r),
                                                               1e-30)),
                     int((~ok).sum()), t['rtol'], t['atol'])


def run(nd, ctx_a, ctx_b, n, seed=0):
    """Every CASES op on ctx_a and ctx_b from the same inputs; returns
    (count run, {name: mismatch})."""
    bad = {}
    names = sorted(CASES)
    for name in names:
        arrays, attrs, tol = case(name, n, seed)
        outs = []
        for ctx in (ctx_a, ctx_b):
            with ctx:
                xs = [nd.array(a, ctx=ctx) for a in arrays]
                outs.append([o.asnumpy() for o in call(nd, name, xs, attrs)])
        for got, ref in zip(*outs):
            why = mismatch(got, ref, tol)
            if why:
                bad[name] = why
    return len(names), bad


# sampler of mx.random -> (kwargs, mean, variance) of its distribution
SAMPLERS = {
    'uniform': (dict(low=-1.0, high=3.0), 1.0, 16.0 / 12),
    'normal': (dict(loc=2.0, scale=0.5), 2.0, 0.25),
    'gamma': (dict(alpha=2.0, beta=1.5), 3.0, 4.5),
    'exponential': (dict(lam=2.0), 0.5, 0.25),
    'poisson': (dict(lam=3.0), 3.0, 3.0),
    'negative_binomial': (dict(k=3, p=0.4), 4.5, 11.25),
    'generalized_negative_binomial': (dict(mu=2.0, alpha=0.5), 2.0, 4.0),
}


def moments_mismatch(x, mean, var, sigmas=5.0):
    """None if the sample x's mean and variance lie within `sigmas`
    standard errors of the distribution's (the variance's from the
    sample's fourth moment), else a description."""
    x = np.asarray(x, np.float64).reshape(-1)
    n = x.size
    m, v = x.mean(), x.var()
    m4 = ((x - m) ** 4).mean()
    if abs(m - mean) > sigmas * np.sqrt(var / n):
        return 'mean %.5g, expected %.5g' % (m, mean)
    if abs(v - var) > sigmas * np.sqrt(max(m4 - v * v, 1e-12) / n):
        return 'variance %.5g, expected %.5g' % (v, var)
    return None


def run_samplers(mx, ctx, samples, seed=0):
    """Every SAMPLERS sampler of `mx.random` on ctx, `samples` draws
    each after `mx.random.seed(seed)`, and multinomial draws' frequencies:
    {name: mismatch} of shape, dtype, context and moments (empty when all
    hold)."""
    bad = {}
    mx.random.seed(seed)
    for name, (kwargs, mean, var) in sorted(SAMPLERS.items()):
        x = getattr(mx.random, name)(shape=(samples,), ctx=ctx, **kwargs)
        if x.shape != (samples,) or x.dtype != np.float32 or \
                x.context != ctx:
            bad[name] = 'shape %s, dtype %s on %s' % (x.shape, x.dtype,
                                                      x.context)
            continue
        why = moments_mismatch(x.asnumpy(), mean, var)
        if why:
            bad[name] = why
    probs = np.array([0.1, 0.2, 0.7], np.float32)
    draws = mx.random.multinomial(mx.nd.array(probs, ctx=ctx),
                                  shape=samples).asnumpy()
    freq = np.array([(draws == k).mean() for k in range(3)])
    if draws.dtype != np.int32 or \
            (np.abs(freq - probs) > 5 * np.sqrt(probs * (1 - probs) /
                                                samples)).any():
        bad['multinomial'] = 'dtype %s, frequencies %s for %s' % (
            draws.dtype, freq, probs)
    return bad
