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

`VARIANTS` holds further cases of some ops, run beside `CASES`: `topk`
on integer-valued inputs full of ties, in both directions, at k = 1, 3
and 7, for each `ret_typ`, and each index op with indices that count
from the end (-1) and that run past it (>= n).

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
        'idx_wrap': lambda: rng.integers(-n - 2, n + 2, (n,))
        .astype(np.float32),
        'nd_idx_out': lambda: rng.integers(-n - 2, n + 2, (2, n))
        .astype(np.float32),
        'nd_perm_out': lambda: _perm_out(n, rng),
        'ties': lambda: rng.integers(0, 4, (n, n)).astype(np.float32),
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


def _perm_out(n, rng):
    """(2, n) indices into an n x n array that hit no position twice:
    rows 0..n-1 against a permutation of the columns, two of them written
    as the equal row - n (counted from the end), one column moved past
    the end and one row before -n (both dropped by a scatter)."""
    idx = np.stack([np.arange(n), rng.permutation(n)])
    at = rng.choice(n, 4, replace=False)
    idx[0, at[:2]] -= n
    idx[1, at[2]] += n
    idx[0, at[3]] = -n - 1
    return idx.astype(np.float32)


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


def _variants():
    v = {}
    for asc in (False, True):
        for k in (1, 3, 7):
            for ret in ('indices', 'mask', 'both'):
                v['topk/%s/k%d/%s' % ('asc' if asc else 'desc', k, ret)] = (
                    'topk', ('ties',), dict(axis=1, k=k, ret_typ=ret,
                                            is_ascend=asc), EXACT)
    v['pick/out_of_range'] = ('pick', ('m', 'idx_wrap'), dict(axis=1), EXACT)
    v['batch_take/out_of_range'] = ('batch_take', ('m', 'idx_wrap'), {},
                                    EXACT)
    v['gather_nd/out_of_range'] = ('gather_nd', ('m', 'nd_idx_out'), {},
                                   EXACT)
    v['scatter_nd/out_of_range'] = ('scatter_nd', ('vec', 'nd_perm_out'),
                                    dict(shape=None), EXACT)
    v['scatter_nd_acc/out_of_range'] = ('scatter_nd_acc',
                                        ('vec', 'nd_idx_out'),
                                        dict(shape=None), FLOAT)
    return v


# name -> (op, input kinds, attrs, tolerance class)
VARIANTS = _variants()

# attrs that take the size n: name of the attr -> its value for size n
_SIZED = {'size': lambda n: n, 'input_dim': lambda n: n,
          'output_dim': lambda n: n, 'depth': lambda n: n,
          'N': lambda n: n, 'stop': lambda n: float(n),
          'shape': lambda n: (n, n),
          'end': lambda n: (1 + n // 2, 2 + n // 2)}


def op_of(name):
    """The op that case `name` (of CASES or VARIANTS) runs."""
    return VARIANTS[name][0] if name in VARIANTS else name


def case(name, n, seed=0):
    """(numpy inputs, attrs, tolerance class) of case `name` (of CASES or
    VARIANTS) at size n, from a generator seeded by seed and the name."""
    kinds, attrs, tol = VARIANTS[name][1:] if name in VARIANTS \
        else CASES[name]
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
    """Every case of CASES and VARIANTS on ctx_a and ctx_b from the same
    inputs; returns (count run, {name: mismatch})."""
    bad = {}
    names = sorted(CASES) + sorted(VARIANTS)
    for name in names:
        arrays, attrs, tol = case(name, n, seed)
        outs = []
        for ctx in (ctx_a, ctx_b):
            with ctx:
                xs = [nd.array(a, ctx=ctx) for a in arrays]
                outs.append([o.asnumpy() for o in call(nd, op_of(name), xs,
                                                       attrs)])
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


# ---------------------------------------------------------------------------
# The ops of ops/extra.py, ops/spatial.py and ops/contrib_ops.py: one case
# for each name (aliases included), at two sizes. 'small' is the CPU
# tests' (against the JAX package); 'example' is the size of the example
# that uses the op, for the card against cpu(0): MultiBoxPrior on SSD300's
# six feature maps, MultiBoxTarget and MultiBoxDetection at SSD300's 8,732
# anchors, Proposal and MultiProposal at Faster R-CNN's RPN (stride 16, 9
# anchors, pre-NMS 6000, post-NMS 300, a 600 x 1000 image), ROIPooling
# and PSROIPooling with 300 rois, DeformableConvolution at a 512-channel
# 3x3 layer of 38 x 50, ctc_loss at examples/ctc/lstm_ocr.py's lengths
# and the linalg ops on a batch of 512 64 x 64 SPD matrices.
#
# A case is a dict: `calls`, a list of (numpy args, numpy auxs, attrs)
# each run through the op; `train`, the op context's mode; `grad`, the
# indices of the args the gradient is taken for; `tol`, the class of the
# float outputs and gradients (FLOAT, or REDUCE for products and sums:
# rtol 1e-4 and an atol of 1e-5 of the largest magnitude);
# `exact`, a function of the outputs (and new auxs) giving the arrays
# that must be equal: integer results, masks, ids, kept rows and order,
# selections and maxima; `card_tol`, the float class on the card against
# cpu(0) where it differs: REDUCE where a position computed in float
# scales an ulp by the image's width (the samplers), where a gradient
# sums over a batch, channels or overlapping bins (MultiBoxTarget's
# anchors, the sampler's grid, ROIPooling's data), where a box is a difference of large terms
# (Proposal) and where CUDA's exp and log round otherwise (ctc_loss).
# ---------------------------------------------------------------------------

CONTRIB_ALIASES = {
    '_contrib_MultiBoxPrior': 'MultiBoxPrior',
    '_contrib_MultiBoxTarget': 'MultiBoxTarget',
    '_contrib_MultiBoxDetection': 'MultiBoxDetection',
    '_contrib_Proposal': 'Proposal', 'MultiProposal': 'Proposal',
    '_contrib_MultiProposal': 'Proposal',
    '_contrib_PSROIPooling': 'PSROIPooling',
    '_contrib_DeformableConvolution': 'DeformableConvolution',
    '_contrib_DeformablePSROIPooling': 'DeformablePSROIPooling',
    '_contrib_ctc_loss': 'ctc_loss', 'CTCLoss': 'ctc_loss',
    '_contrib_CTCLoss': 'ctc_loss',
    '_contrib_fft': 'fft', '_contrib_ifft': 'ifft',
    '_contrib_count_sketch': 'count_sketch',
    '_contrib_quantize': 'quantize', '_contrib_dequantize': 'dequantize',
}

SSD300_MAPS = ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))
SSD300_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                (.71, .79), (.88, .961))
SSD300_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
                 (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5))


def _f32(x):
    return np.asarray(x, np.float32)


def _normal(rng, shape, scale=1.0):
    return _f32(rng.standard_normal(shape) * scale)


def _spd(rng, b, n):
    x = rng.standard_normal((b, n, n))
    return _f32(x @ np.swapaxes(x, 1, 2) / n + np.eye(n))


def _lower(rng, b, n):
    """Well-conditioned lower-triangular matrices."""
    return _f32(np.tril(rng.uniform(-0.5, 0.5, (b, n, n))) +
                2.0 * np.eye(n))


def _ssd_anchors(maps, sizes, ratios):
    """The anchors MultiBoxPrior makes over `maps`, concatenated."""
    from ..ops import contrib_ops
    return np.concatenate([
        contrib_ops.multibox_prior(h, w, s, r, False, (-1.0, -1.0),
                                   (0.5, 0.5))[0]
        for (h, w), s, r in zip(maps, sizes, ratios)])[None]


def _det_labels(rng, b, g, classes, ties=False, empty_image=False):
    """(b, g, 5) labels: 1..g boxes an image, class ids in [0, classes),
    corners in (0, 1), the rest -1; with ties the first two boxes of
    each image are the same box."""
    lab = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        n = 0 if empty_image and i == b - 1 else rng.integers(1, g + 1)
        for j in range(n):
            w, h = rng.uniform(0.1, 0.5, 2)
            x, y = rng.uniform(0.0, 1.0 - w), rng.uniform(0.0, 1.0 - h)
            lab[i, j] = [rng.integers(0, classes), x, y, x + w, y + h]
        if ties and n >= 2:
            lab[i, 1, 1:] = lab[i, 0, 1:]
    return lab


def _rois(rng, r, batch, height, width, scale):
    """(r, 5) rois [batch, x1, y1, x2, y2] in image pixels (feature map
    height x width at spatial_scale `scale`), some corners on .5."""
    img_h, img_w = height / scale, width / scale
    x1 = rng.uniform(0, img_w * 0.7, r)
    y1 = rng.uniform(0, img_h * 0.7, r)
    x2 = np.minimum(x1 + rng.uniform(8, img_w * 0.5, r), img_w - 1)
    y2 = np.minimum(y1 + rng.uniform(8, img_h * 0.5, r), img_h - 1)
    x1[:r // 4] = np.floor(x1[:r // 4]) + 0.5
    return _f32(np.stack([rng.integers(0, batch, r), x1, y1, x2, y2], 1))


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return _f32(e / e.sum(axis=axis, keepdims=True))


def _rpn_inputs(rng, b, h, w, stride):
    a = 9
    score = rng.uniform(0.0, 1.0, (b, a, h, w))
    cls_prob = _f32(np.concatenate([1.0 - score, score], 1))
    bbox = _normal(rng, (b, 4 * a, h, w), 0.1)
    im_info = _f32([[h * stride, w * stride, 1.0]] * b)
    return [cls_prob, bbox, im_info]


def _first(outs, auxs):
    return [outs[0]]


def _contrib_builders():
    """op -> fn(rng, example) -> case dict (see the section's comment)."""
    b = {}

    def case(calls, grad=(), tol=FLOAT, exact=None, train=False,
             card_tol=None):
        return dict(calls=calls, grad=tuple(grad), tol=tol, exact=exact,
                    train=train, card_tol=card_tol or tol)

    def one(args, attrs, auxs=()):
        return [(list(args), list(auxs), dict(attrs))]

    # --- ops/extra.py ------------------------------------------------------
    def svm(rng, ex):
        n, k = (512, 1000) if ex else (8, 5)
        return case(one([_normal(rng, (n, k)),
                         _f32(rng.integers(0, k, n))],
                        dict(margin=1.0, regularization_coefficient=0.5)),
                    grad=[0])
    b['SVMOutput'] = svm
    b['smooth_l1'] = lambda rng, ex: case(
        one([_normal(rng, (32, 34928) if ex else (4, 24), 2.0)],
            dict(scalar=1.0)), grad=[0])
    b['IdentityAttachKLSparseReg'] = lambda rng, ex: case(
        one([_normal(rng, (256, 1024) if ex else (6, 10))],
            dict(sparseness_target=0.1, penalty=0.001, momentum=0.9),
            auxs=[_f32(rng.uniform(0.1, 0.9, 1024 if ex else 10))]),
        grad=[0], train=True, exact=None)
    def lin(shape_fn, attrs, grad, tol=REDUCE):
        def build(rng, ex):
            batch, n = (512, 64) if ex else (3, 5)
            return case(one(shape_fn(rng, batch, n), attrs), grad=grad,
                        tol=tol)
        return build
    b['linalg_gemm'] = lin(lambda rng, k, n: [
        _normal(rng, (k, n, n)), _normal(rng, (k, n, n)),
        _normal(rng, (k, n, n))],
        dict(transpose_b=True, alpha=0.5, beta=2.0), [0, 1, 2])
    b['linalg_gemm2'] = lin(lambda rng, k, n: [
        _normal(rng, (k, n, n)), _normal(rng, (k, n, n))],
        dict(transpose_a=True, alpha=1.5), [0, 1])
    b['linalg_potrf'] = lin(lambda rng, k, n: [_spd(rng, k, n)], {}, [0])
    b['linalg_potri'] = lin(lambda rng, k, n: [
        _f32(np.linalg.cholesky(_spd(rng, k, n).astype(np.float64)))],
        {}, [0])
    b['linalg_trmm'] = lin(lambda rng, k, n: [
        _lower(rng, k, n), _normal(rng, (k, n, n))],
        dict(transpose=True, rightside=True, alpha=2.0), [0, 1])
    b['linalg_trsm'] = lin(lambda rng, k, n: [
        _lower(rng, k, n), _normal(rng, (k, n, n))],
        dict(alpha=0.5), [0, 1])
    b['linalg_sumlogdiag'] = lin(lambda rng, k, n: [_spd(rng, k, n)], {},
                                 [0])
    b['linalg_syrk'] = lin(lambda rng, k, n: [_normal(rng, (k, n, n))],
                           dict(alpha=0.3), [0])

    def lsoftmax(rng, ex):
        n, d, h = (256, 512, 1000) if ex else (6, 8, 5)
        return case(one([_normal(rng, (n, d)), _normal(rng, (h, d)),
                         _f32(rng.integers(0, h, n))],
                        dict(num_hidden=h, margin=3, beta=1.0)),
                    grad=[0, 1], tol=REDUCE, train=True)
    b['LSoftmax'] = lsoftmax
    b['MultiLogistic'] = lambda rng, ex: case(
        one([_normal(rng, (256, 1000) if ex else (4, 6)),
             _f32(rng.integers(0, 2, (256, 1000) if ex else (4, 6)))],
            dict(grad_scale=0.5, weight=2.0)), grad=[0])
    b['WeightedL1'] = lambda rng, ex: case(
        one([_normal(rng, (256, 1000) if ex else (4, 6)),
             _normal(rng, (256, 1000) if ex else (4, 6))],
            dict(grad_scale=0.5)), grad=[0])

    # --- ops/spatial.py ----------------------------------------------------
    def theta(rng, n):
        return _f32(np.tile([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], (n, 1)) +
                    rng.uniform(-0.2, 0.2, (n, 6)))

    def grid_gen(rng, ex):
        n, h, w = (8, 64, 96) if ex else (2, 5, 7)
        return case(one([theta(rng, n)], dict(transform_type='affine',
                                               target_shape=(h, w))) +
                    one([_normal(rng, (n, 2, h, w), 2.0)],
                        dict(transform_type='warp')), grad=[0],
                    card_tol=REDUCE)
    b['GridGenerator'] = grid_gen

    def sampler(rng, ex):
        n, c, h, w = (8, 64, 64, 96) if ex else (2, 3, 6, 7)
        return case(one([_normal(rng, (n, c, h, w)),
                         _f32(rng.uniform(-1.1, 1.1, (n, 2, h, w)))], {}),
                    grad=[0, 1], card_tol=REDUCE)
    b['BilinearSampler'] = sampler

    def transformer(rng, ex):
        n, c, h, w = (8, 64, 64, 96) if ex else (2, 3, 6, 7)
        return case(one([_normal(rng, (n, c, h, w)), theta(rng, n)],
                        dict(target_shape=(h - 1, w + 1))), grad=[0, 1],
                    card_tol=REDUCE)
    b['SpatialTransformer'] = transformer

    def roi_pool(rng, ex):
        n, c, h, w, r, scale = (1, 512, 38, 50, 300, 1 / 16.) if ex \
            else (2, 3, 12, 15, 6, 0.5)
        return case(one([_normal(rng, (n, c, h, w)),
                         _rois(rng, r, n, h, w, scale)],
                        dict(pooled_size=(7, 7) if ex else (3, 2),
                             spatial_scale=scale)),
                    grad=[0], exact=_first, card_tol=REDUCE)
    b['ROIPooling'] = roi_pool

    def corr(rng, ex):
        # FlowNetC's: kernel 1, displacement 20 at stride 2, 256 channels
        n, c, h, w = (1, 256, 48, 64) if ex else (1, 3, 9, 10)
        md, s2, pad = (20, 2, 20) if ex else (2, 1, 2)
        x1, x2 = _normal(rng, (n, c, h, w)), _normal(rng, (n, c, h, w))
        # a 3x3 kernel by absolute differences, at a smaller size
        y1, y2 = (_normal(rng, (1, 32, 24, 32)), _normal(rng, (1, 32, 24, 32))
                  ) if ex else (x1, x2)
        return case(one([x1, x2], dict(kernel_size=1, max_displacement=md,
                                       stride1=1, stride2=s2, pad_size=pad))
                    + one([y1, y2], dict(kernel_size=3, max_displacement=4,
                                         stride1=2, stride2=1 if ex else s2,
                                         pad_size=4, is_multiply=False)),
                    grad=[0, 1], tol=REDUCE)
    b['Correlation'] = corr

    def corr1d(rng, ex):
        n, c, h, w = (1, 64, 48, 96) if ex else (1, 3, 6, 12)
        md = 40 if ex else 3
        x1, x2 = _normal(rng, (n, c, h, w)), _normal(rng, (n, c, h, w))
        return case([(list((x1, x2)), [], dict(
            kernel_size=1, max_displacement=md, stride1=1, stride2=1,
            pad_size=md, single_side=side)) for side in (0, -1, 1)],
            grad=[0, 1], tol=REDUCE)
    b['Correlation1D'] = corr1d

    # --- ops/contrib_ops.py ------------------------------------------------
    def prior(rng, ex):
        maps = SSD300_MAPS if ex else ((4, 4), (2, 3))
        calls = []
        for (h, w), s, r in zip(maps, SSD300_SIZES, SSD300_RATIOS):
            calls += one([np.zeros((1, 4, h, w), np.float32)],
                         dict(sizes=s, ratios=r, clip=False,
                              steps=(-1.0, -1.0)))
        calls += one([np.zeros((1, 2, 3, 5), np.float32)],
                     dict(sizes=(0.3, 0.6), ratios=(1, 2), clip=True,
                          steps=(0.25, 0.2), offsets=(0.5, 0.25)))
        return case(calls, exact=_first)
    b['MultiBoxPrior'] = prior

    def target(rng, ex, ties=False, neg_ratio=3.0):
        if ex:
            anchors = _ssd_anchors(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS)
            bsz, g, classes = 32, 6, 20
        else:
            anchors = _ssd_anchors(((4, 4), (2, 2)), SSD300_SIZES[:2],
                                   SSD300_RATIOS[:2])
            bsz, g, classes = 3, 4, 3
        lab = _det_labels(rng, bsz, g, classes, ties=ties,
                          empty_image=True)
        cls_pred = _normal(rng, (bsz, classes + 1, anchors.shape[1]))
        return case(one([anchors, lab, cls_pred], dict(
            overlap_threshold=0.5, ignore_label=-1,
            negative_mining_ratio=neg_ratio, negative_mining_thresh=0.5,
            minimum_negative_samples=0, variances=(0.1, 0.1, 0.2, 0.2))),
            grad=[0, 1], exact=lambda outs, auxs: [outs[1], outs[2]],
            card_tol=REDUCE)
    b['MultiBoxTarget'] = target

    def detection(rng, ex, topk=None, ties=False, force=False):
        if ex:
            anchors = _ssd_anchors(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS)
            # every box a candidate with topk -1: its (A, A) overlaps at
            # two images, not 32
            bsz, classes = (2 if topk == -1 else 32), 21
            topk = 400 if topk is None else topk
        else:
            anchors = _ssd_anchors(((4, 4), (2, 2)), SSD300_SIZES[:2],
                                   SSD300_RATIOS[:2])
            bsz, classes = 2, 4
            topk = 20 if topk is None else topk
        a = anchors.shape[1]
        logits = _normal(rng, (bsz, classes, a), 2.0)
        if ties:
            # pairs of anchors with the same scores: ties in the sort
            logits[:, :, 1::2] = logits[:, :, 0:-1:2]
        return case(one([_softmax(logits, 1), _normal(rng, (bsz, 4 * a), 0.5),
                         anchors],
                        dict(threshold=0.01, nms_threshold=0.45,
                             nms_topk=topk, clip=True,
                             force_suppress=force,
                             variances=(0.1, 0.1, 0.2, 0.2))),
                    grad=[0, 1],
                    exact=lambda outs, auxs: [outs[0][..., 0]])
    b['MultiBoxDetection'] = detection

    def prop(rng, ex, batch=1, score=False):
        if ex:
            h, w, pre, post = 38, 63, 6000, 300
        else:
            h, w, pre, post = 5, 7, 120, 30
        return case(one(_rpn_inputs(rng, batch, h, w, 16), dict(
            feature_stride=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
            rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post, threshold=0.7,
            rpn_min_size=16, output_score=score)),
            grad=[0, 1], exact=lambda outs, auxs: [outs[0][:, 0]],
            card_tol=REDUCE)
    b['Proposal'] = prop

    def psroi(rng, ex):
        n, h, w, r, dim, p, scale = (1, 38, 63, 300, 21, 7, 1 / 16.) if ex \
            else (2, 9, 11, 5, 2, 3, 0.5)
        return case(one([_normal(rng, (n, dim * p * p, h, w)),
                         _rois(rng, r, n, h, w, scale)],
                        dict(spatial_scale=scale, output_dim=dim,
                             pooled_size=p, group_size=p)), grad=[0])
    b['PSROIPooling'] = psroi

    def dconv(rng, ex):
        n, c, h, w, f = (1, 512, 38, 50, 512) if ex else (2, 4, 6, 7, 3)
        g = 1 if ex else 2
        return case(one([_normal(rng, (n, c, h, w)),
                         _normal(rng, (n, 2 * g * 9, h, w), 1.5),
                         _normal(rng, (f, c, 3, 3), 0.1),
                         _normal(rng, (f,), 0.1)],
                        dict(kernel=(3, 3), pad=(1, 1), num_filter=f,
                             num_deformable_group=g)),
                    grad=[0, 1, 2, 3], tol=REDUCE)
    b['DeformableConvolution'] = dconv

    def dpsroi(rng, ex):
        n, h, w, r, dim, p, scale = (1, 38, 63, 300, 21, 7, 1 / 16.) if ex \
            else (1, 9, 11, 4, 2, 3, 0.5)
        return case(one([_normal(rng, (n, dim * p * p, h, w)),
                         _rois(rng, r, n, h, w, scale),
                         _normal(rng, (r, 2, p, p))],
                        dict(spatial_scale=scale, output_dim=dim,
                             pooled_size=p, group_size=p, part_size=p,
                             sample_per_part=4, trans_std=0.1)),
                    grad=[0, 2], card_tol=REDUCE)
    b['DeformablePSROIPooling'] = dpsroi

    def ctc(rng, ex):
        t, n, c, num_l = (18, 64, 11, 3) if ex else (6, 3, 5, 3)
        lab = _f32(rng.integers(1, c, (n, num_l)))
        lab[0, 1:] = 0                     # a shorter label
        lab[1, 1] = lab[1, 0]              # a repeat: no skip
        return case(one([_normal(rng, (t, n, c)), lab], {}), grad=[0],
                    card_tol=REDUCE)
    b['ctc_loss'] = ctc
    b['fft'] = lambda rng, ex: case(
        one([_normal(rng, (256, 1024) if ex else (3, 8))], {}), grad=[0],
        tol=REDUCE)
    b['ifft'] = lambda rng, ex: case(
        one([_normal(rng, (256, 2048) if ex else (3, 16))], {}), grad=[0],
        tol=REDUCE)

    def sketch(rng, ex):
        n, d, out = (64, 2048, 16000) if ex else (4, 10, 6)
        return case(one([_normal(rng, (n, d)),
                         _f32(rng.integers(0, out, (1, d))),
                         _f32(rng.choice([-1.0, 1.0], (1, d)))],
                        dict(out_dim=out)), grad=[0])
    b['count_sketch'] = sketch

    def quant(rng, ex):
        shape = (1024, 1024) if ex else (5, 7)
        x = _f32(rng.uniform(-1.2, 0.9, shape))
        x.flat[:4] = [-1.0, 0.5 / 127, -0.5 / 127, 0.0]     # .5 ties
        lo, hi = _f32([-1.0]), _f32([0.8])
        return case(one([x, lo, hi], dict(out_type='uint8')) +
                    one([x, lo, hi], dict(out_type='int8')),
                    exact=lambda outs, auxs: outs)
    b['quantize'] = quant

    def dequant(rng, ex):
        shape = (1024, 1024) if ex else (5, 7)
        lo, hi = _f32([-1.0]), _f32([0.8])
        return case(one([rng.integers(0, 256, shape).astype(np.uint8), lo,
                         hi], dict(out_type='float32')) +
                    one([rng.integers(-127, 128, shape).astype(np.int8), lo,
                         hi], dict(out_type='float32')))
    b['dequantize'] = dequant
    return b


_CONTRIB_BUILDERS = _contrib_builders()
CONTRIB_NAMES = tuple(sorted(set(_CONTRIB_BUILDERS) | set(CONTRIB_ALIASES)))

# further cases beside one per name: name -> (op, builder keyword args)
CONTRIB_VARIANTS = {
    'MultiBoxTarget/ties': ('MultiBoxTarget', dict(ties=True)),
    'MultiBoxTarget/no_mining': ('MultiBoxTarget', dict(neg_ratio=-1.0)),
    'MultiBoxDetection/topk_all': ('MultiBoxDetection', dict(topk=-1)),
    'MultiBoxDetection/ties': ('MultiBoxDetection', dict(ties=True)),
    'MultiBoxDetection/force_suppress': ('MultiBoxDetection',
                                         dict(force=True)),
    'MultiProposal/score': ('Proposal', dict(batch=2, score=True)),
}


def contrib_op(name):
    """The registered op that contrib case `name` runs."""
    if name in CONTRIB_VARIANTS:
        return CONTRIB_VARIANTS[name][0]
    return CONTRIB_ALIASES.get(name, name)


def contrib_case(name, example=False, seed=0):
    """The case dict of `name` (of CONTRIB_NAMES or CONTRIB_VARIANTS), its
    inputs drawn from a generator seeded by seed and the name. MultiProposal
    and its alias run at batch 2, Proposal at batch 1."""
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    op = contrib_op(name)
    kwargs = CONTRIB_VARIANTS[name][1] if name in CONTRIB_VARIANTS else {}
    if name in ('MultiProposal', '_contrib_MultiProposal'):
        kwargs = dict(batch=2)
    return _CONTRIB_BUILDERS[op](rng, example, **kwargs)


def contrib_cotangents(shapes, seed=0):
    """The seeded float32 cotangents of outputs of these shapes."""
    rng = np.random.default_rng(seed)
    return [_normal(rng, s) for s in shapes]


def run_contrib_call(torch, op, args, auxs, attrs, train, grad, device,
                     seed=0):
    """One call of `op` (an OpDef of the port's registry) on torch tensors
    on `device`: (outputs, new auxs, gradients of grad's args against
    seeded cotangents), all as numpy."""
    from ..ops.registry import OpContext
    xs = [torch.tensor(a, device=device, requires_grad=i in grad)
          for i, a in enumerate(args)]
    ax = [torch.tensor(a, device=device) for a in auxs]
    ctx = OpContext(is_train=train, device=torch.device(device))
    with torch.enable_grad():
        outs, new_auxs = op.apply(attrs, xs, ax, ctx)
    grads = []
    if grad:
        cots = contrib_cotangents([tuple(o.shape) for o in outs], seed)
        live = [(o, torch.tensor(c, device=device))
                for o, c in zip(outs, cots) if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in live],
                                  [xs[i] for i in grad],
                                  [c for _, c in live], allow_unused=True)
        grads = [np.zeros(args[i].shape, np.float32) if g is None
                 else g.detach().cpu().numpy() for i, g in zip(grad, got)]
    return ([o.detach().cpu().numpy() for o in outs],
            [a.detach().cpu().numpy() for a in new_auxs], grads)


def run_contrib(torch, dev_a, dev_b, example=True, names=None, seed=0):
    """Every contrib case (CONTRIB_NAMES and CONTRIB_VARIANTS) on torch
    devices dev_a and dev_b from the same inputs, forward and gradient:
    ({name: mismatch}, {name: host ms of one call on dev_a, its first
    call excluded}). Integer and `exact` results must be equal; floats
    within the case's tolerance class."""
    import time
    from ..ops import registry
    bad, host_ms = {}, {}
    names = names or (CONTRIB_NAMES + tuple(sorted(CONTRIB_VARIANTS)))
    for name in names:
        c = contrib_case(name, example, seed)
        op = registry.get(contrib_op(name))
        for k, (args, auxs, attrs) in enumerate(c['calls']):
            res = []
            for dev in (dev_a, dev_b):
                res.append(run_contrib_call(torch, op, args, auxs, attrs,
                                            c['train'], c['grad'], dev))
            if k == 0 and name not in CONTRIB_ALIASES:
                t0 = time.perf_counter()
                run_contrib_call(torch, op, args, auxs, attrs, c['train'],
                                 (), dev_a)
                if 'cuda' in str(dev_a):
                    torch.cuda.synchronize()
                host_ms[name] = (time.perf_counter() - t0) * 1e3
            why = contrib_mismatch(c, res[0], res[1], c['card_tol'])
            if why:
                bad['%s[%d]' % (name, k)] = why
    return bad, host_ms


def contrib_mismatch(c, got, ref, tol=None):
    """None if one call's (outputs, auxs, grads) `got` matches `ref` under
    case c (its float class, or `tol`), else a description."""
    outs, auxs, grads = got
    routs, rauxs, rgrads = ref
    if len(outs) != len(routs) or len(grads) != len(rgrads):
        return 'output count %d vs %d' % (len(outs), len(routs))
    if c['exact'] is not None:
        for i, (g, r) in enumerate(zip(c['exact'](outs, auxs),
                                       c['exact'](routs, rauxs))):
            why = mismatch(np.asarray(g), np.asarray(r), EXACT)
            if why:
                return 'exact result %d: %s' % (i, why)
    for kind, mine, theirs in (('output', outs, routs),
                               ('aux', auxs, rauxs),
                               ('gradient', grads, rgrads)):
        for i, (g, r) in enumerate(zip(mine, theirs)):
            kind_tol = EXACT if g.dtype.kind in 'iub' else (tol or c['tol'])
            if kind_tol == REDUCE and g.shape == r.shape and r.size:
                # sums of products: rtol 1e-4 and, for the elements near
                # 0, 1e-5 of the largest magnitude
                g64, r64 = g.astype(np.float64), r.astype(np.float64)
                atol = 1e-5 * float(np.abs(r64).max())
                if not np.allclose(g64, r64, rtol=1e-4, atol=atol,
                                   equal_nan=True):
                    return '%s %d: max |diff| %.3g (atol %.3g)' % (
                        kind, i, float(np.abs(g64 - r64).max()), atol)
                continue
            why = mismatch(g, r, kind_tol)
            if why:
                return '%s %d: %s' % (kind, i, why)
    return None
