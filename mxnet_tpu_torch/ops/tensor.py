"""Tensor operators (elemwise / broadcast / reduce / matrix / init / index):
the counterpart of mxnet_tpu/ops/tensor.py, over torch tensors.

Every registration of the JAX module is here under the same name and
aliases, with the JAX package's semantics and dtypes: floor-mod for
`_mod` (torch.remainder), comparisons and arg-reductions in the input's
dtype, float32 `arange`, `one_hot` and the like, integer sums in int32,
and a scalar operand cast to the data's dtype first. Each op returns new
storage, never a view of an input; `ndarray.invoke` copies an output
that shares an input's storage, as JAX arrays never alias.
"""
import torch

from .registry import (register, astuple, asbool, asint, asfloat,
                       normalize_axis)
from ..base import parse_attr_value, torch_dtype, MXNetError


def _dtype(attrs, default=torch.float32):
    d = attrs.get('dtype', None)
    return default if d is None else torch_dtype(d)


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _int_sum_dtype(dtype):
    """The dtype of a sum or product: the JAX package (x64 off) sums
    integers in int32, unsigned ones in uint32, where torch would take
    int64."""
    if dtype.is_floating_point or dtype == torch.int64:
        return None
    return torch.uint32 if dtype in _UNSIGNED else torch.int32


def _int_summed(fn, x, **kw):
    """fn(x, dtype=..., **kw) in `_int_sum_dtype`. torch sums in no
    uint32, so an unsigned sum or product runs in int64 and keeps its low
    32 bits, which are the uint32 result."""
    dt = _int_sum_dtype(x.dtype)
    if dt == torch.uint32:
        return fn(x, dtype=torch.int64, **kw).to(torch.uint32)
    return fn(x, dtype=dt, **kw)


def _inexact(fn):
    """fn on integer operands taken as float32, as jnp promotes them for
    an inexact function (hypot, rint)."""
    def _fn(*ts):
        return fn(*[t if not isinstance(t, torch.Tensor) or
                    t.is_floating_point() else t.to(torch.float32)
                    for t in ts])
    return _fn


def _int_pow(x, e):
    """x ** e for integer x and e as jnp.power computes it: binary
    exponentiation over the low 6 bits of e, wrapping, so that a negative
    or large exponent gives jnp's bits; 0 ** e is 0 for e != 0."""
    acc = torch.where((x == 0) & (e != 0), torch.zeros_like(x),
                      torch.ones_like(x))
    e = e.to(acc.dtype)
    for _ in range(6):
        acc = torch.where((e & 1) != 0, acc * x, acc)
        x = x * x
        e = e >> 1 if e.dtype in _UNSIGNED else \
            (e >> 1) & torch.iinfo(e.dtype).max
    return acc


def _pow(x, e):
    """torch.pow, with integer ** integer as `_int_pow`."""
    if x.is_floating_point() or e.is_floating_point():
        return torch.pow(x, e)
    return _int_pow(*torch.broadcast_tensors(x, e))


def _mod(x, d):
    """torch.remainder, with an integer remainder by 0 giving 0 as jnp's
    does (torch raises, or on the card returns garbage)."""
    if x.is_floating_point() or d.is_floating_point():
        return torch.remainder(x, d)
    zero = d == 0
    return torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device),
                       torch.remainder(x, torch.where(zero, 1, d)))


# ---------------------------------------------------------------------------
# Elementwise binary (same-shape)
# ---------------------------------------------------------------------------

def _reg_binary(name, fn, aliases=()):
    @register(name, input_names=('lhs', 'rhs'), aliases=aliases)
    def _op(attrs, lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    return _op


_reg_binary('elemwise_add', torch.add, aliases=('_add', '_plus', '_Plus'))
_reg_binary('elemwise_sub', torch.sub, aliases=('_sub', '_minus', '_Minus'))
_reg_binary('elemwise_mul', torch.mul, aliases=('_mul', '_Mul'))
_reg_binary('elemwise_div', torch.true_divide, aliases=('_div', '_Div'))
_reg_binary('_power', _pow, aliases=('_Power',))
_reg_binary('_maximum', torch.maximum, aliases=('_Maximum', 'maximum'))
_reg_binary('_minimum', torch.minimum, aliases=('_Minimum', 'minimum'))
_reg_binary('_hypot', _inexact(torch.hypot))
_reg_binary('_mod', _mod, aliases=('_Mod',))

_COMPARE = [('equal', torch.eq), ('not_equal', torch.ne),
            ('greater', torch.gt), ('greater_equal', torch.ge),
            ('lesser', torch.lt), ('lesser_equal', torch.le)]

for _n, _f in _COMPARE:
    def _cmp(attrs, lhs, rhs, _f=_f):
        return _f(lhs, rhs).to(lhs.dtype)
    register('_' + _n, input_names=('lhs', 'rhs'))(_cmp)


# ---------------------------------------------------------------------------
# Scalar ops
# ---------------------------------------------------------------------------

def _scalar(attrs, data):
    """The scalar attr in the data's kind, as the JAX package casts it to
    the data's dtype: an integer array takes the scalar truncated."""
    s = asfloat(attrs['scalar'])
    return s if data.is_floating_point() else int(s)


def _reg_scalar(name, fn):
    @register(name, input_names=('data',))
    def _op(attrs, data, _fn=fn):
        return _fn(data, _scalar(attrs, data))
    return _op


_reg_scalar('_plus_scalar', torch.add)
_reg_scalar('_minus_scalar', torch.sub)
_reg_scalar('_rminus_scalar', lambda x, s: s - x)
_reg_scalar('_mul_scalar', torch.mul)
_reg_scalar('_div_scalar', torch.true_divide)
_reg_scalar('_rdiv_scalar', lambda x, s: s / x)
_reg_scalar('_power_scalar', lambda x, s: _pow(x, torch.full_like(x, s)))
_reg_scalar('_rpower_scalar', lambda x, s: _pow(torch.full_like(x, s), x))
_reg_scalar('_maximum_scalar', lambda x, s: torch.clamp(x, min=s))
_reg_scalar('_minimum_scalar', lambda x, s: torch.clamp(x, max=s))
_reg_scalar('_mod_scalar', lambda x, s: _mod(x, torch.full_like(x, s)))
# remainder(Scalar, Tensor) has no derivative in torch; the tensor form
# has, so the scalar is filled out first
_reg_scalar('_rmod_scalar', lambda x, s: _mod(torch.full_like(x, s), x))
_reg_scalar('_hypot_scalar', lambda x, s: _inexact(torch.hypot)(
    x, torch.full((), s, dtype=x.dtype, device=x.device)))
for _n, _f in _COMPARE:
    _reg_scalar('_%s_scalar' % _n, lambda x, s, _f=_f: _f(x, s).to(x.dtype))


# ---------------------------------------------------------------------------
# Elementwise unary
# ---------------------------------------------------------------------------

def _reg_unary(name, fn, aliases=()):
    @register(name, input_names=('data',), aliases=aliases)
    def _op(attrs, data, _fn=fn):
        return _fn(data)
    return _op


def _cbrt(x):
    # torch has no cbrt; |x|^(1/3) with x's sign, as jnp.cbrt
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    'negative': torch.neg, 'reciprocal': torch.reciprocal,
    'abs': torch.abs, 'sign': torch.sign, 'round': torch.round,
    'rint': _inexact(torch.round), 'ceil': torch.ceil, 'floor': torch.floor,
    'trunc': torch.trunc, 'fix': torch.trunc,
    'square': torch.square, 'sqrt': torch.sqrt,
    'rsqrt': lambda x: 1.0 / torch.sqrt(x),
    'cbrt': _cbrt, 'rcbrt': lambda x: 1.0 / _cbrt(x),
    'exp': torch.exp, 'log': torch.log, 'log10': torch.log10,
    'log2': torch.log2, 'log1p': torch.log1p, 'expm1': torch.expm1,
    'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'arcsin': torch.asin, 'arccos': torch.acos, 'arctan': torch.atan,
    'degrees': torch.rad2deg, 'radians': torch.deg2rad,
    'sinh': torch.sinh, 'cosh': torch.cosh, 'tanh': torch.tanh,
    'arcsinh': torch.asinh, 'arccosh': torch.acosh, 'arctanh': torch.atanh,
    'sigmoid': torch.sigmoid, 'relu': torch.relu,
    'softsign': lambda x: x / (1 + torch.abs(x)),
    'zeros_like': torch.zeros_like, 'ones_like': torch.ones_like,
    # exp(gammaln(x)), as the JAX package computes gamma
    'gamma': lambda x: torch.exp(torch.lgamma(x)), 'gammaln': torch.lgamma,
}
for _n, _f in _UNARY.items():
    _reg_unary(_n, _f)

_reg_unary('_copy', lambda x: x, aliases=('identity',))


class _StopGradient(torch.autograd.Function):
    """BlockGrad: the identity, with no gradient (lax.stop_gradient)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return None


@register('BlockGrad', input_names=('data',), aliases=('stop_gradient',))
def _block_grad(attrs, data):
    return _StopGradient.apply(data)


# ---------------------------------------------------------------------------
# Graph-plumbing ops, registered as their plain functional meaning
# ---------------------------------------------------------------------------

_reg_binary('_grad_add', torch.add)


@register('_identity_with_attr_like_rhs', input_names=('lhs', 'rhs'))
def _identity_like_rhs(attrs, lhs, rhs):
    return lhs


@register('_CrossDeviceCopy', input_names=('data',))
def _cross_device_copy(attrs, data):
    return data


@register('_NoGradient', input_names=(), simple=False)
def _no_gradient(attrs, inputs, auxs, op_ctx):
    # placeholder head-grad for outputs whose gradient is undefined
    return [torch.zeros((1,), dtype=torch.float32,
                        device=op_ctx.device)], []


class _MakeLoss(torch.autograd.Function):
    """The identity whose gradient is grad_scale * ones, whatever the
    head gradient (the reference's MakeLoss, make_loss-inl.h)."""

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


@register('make_loss', input_names=('data',), aliases=('MakeLoss',))
def _make_loss(attrs, data):
    return _MakeLoss.apply(data, asfloat(attrs.get('grad_scale', 1.0)))


@register('Cast', input_names=('data',), aliases=('cast',))
def _cast(attrs, data):
    return data.to(_dtype(attrs))


@register('clip', input_names=('data',))
def _clip(attrs, data):
    return torch.clamp(data, asfloat(attrs['a_min']), asfloat(attrs['a_max']))


# ---------------------------------------------------------------------------
# Broadcast binary
# ---------------------------------------------------------------------------

def _reg_broadcast(name, fn, aliases=()):
    @register(name, input_names=('lhs', 'rhs'), aliases=aliases)
    def _op(attrs, lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    return _op


for _n, _f in [('broadcast_add', torch.add), ('broadcast_plus', torch.add),
               ('broadcast_sub', torch.sub), ('broadcast_minus', torch.sub),
               ('broadcast_mul', torch.mul),
               ('broadcast_div', torch.true_divide),
               ('broadcast_mod', _mod),
               ('broadcast_power', _pow),
               ('broadcast_maximum', torch.maximum),
               ('broadcast_minimum', torch.minimum),
               ('broadcast_hypot', _inexact(torch.hypot))]:
    _reg_broadcast(_n, _f)

for _n, _f in _COMPARE:
    _reg_broadcast('broadcast_' + _n,
                   lambda a, b, _f=_f: _f(a, b).to(a.dtype))


@register('broadcast_to', input_names=('data',))
def _broadcast_to(attrs, data):
    shape = astuple(attrs['shape'])
    shape = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, shape)


@register('broadcast_axis', input_names=('data',), aliases=('broadcast_axes',))
def _broadcast_axis(attrs, data):
    axes = astuple(attrs['axis'])
    sizes = astuple(attrs['size'])
    shape = list(data.shape)
    for ax, sz in zip(axes, sizes):
        shape[normalize_axis(ax, data.ndim)] = sz
    return torch.broadcast_to(data, tuple(shape))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _red_axes(attrs, ndim):
    axis = parse_attr_value(attrs.get('axis', None))
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (normalize_axis(axis, ndim),)
    else:
        axes = tuple(normalize_axis(a, ndim) for a in axis)
    if asbool(attrs.get('exclude', False)):
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _over_last(fn, data, axes, keepdims):
    """fn(x, dim=-1) over several axes: the reduced axes are moved last
    and flattened into one (for torch reductions that take one dim)."""
    if not axes:
        return data.clone()
    keep = [a for a in range(data.ndim) if a not in axes]
    x = data.permute(keep + list(axes)).reshape(
        [data.shape[a] for a in keep] + [-1])
    out = fn(x, dim=-1)
    if keepdims:
        out = out.reshape([1 if a in axes else data.shape[a]
                           for a in range(data.ndim)])
    return out


def _sum(x, axes, keepdims):
    if not axes:
        return x.clone()
    return _int_summed(torch.sum, x, dim=axes, keepdim=keepdims)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=axes, keepdim=keepdims) if axes else x.clone()


def _prod(x, axes, keepdims):
    return _over_last(lambda t, dim: _int_summed(torch.prod, t, dim=dim), x,
                      axes, keepdims)


def _nansum(x, axes, keepdims):
    if not x.is_floating_point():
        return _sum(x, axes, keepdims)
    if not axes:
        return torch.nan_to_num(x, nan=0.0)
    return torch.nansum(x, dim=axes, keepdim=keepdims)


def _nanprod(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _max(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims) if axes else x.clone()


def _min(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims) if axes else x.clone()


def _reg_reduce(name, fn, aliases=()):
    @register(name, input_names=('data',), aliases=aliases)
    def _op(attrs, data, _fn=fn):
        axes = _red_axes(attrs, data.ndim)
        keepdims = asbool(attrs.get('keepdims', False))
        return _fn(data, axes, keepdims)
    return _op


_reg_reduce('sum', _sum, aliases=('sum_axis',))
_reg_reduce('mean', _mean)
_reg_reduce('prod', _prod)
_reg_reduce('nansum', _nansum)
_reg_reduce('nanprod', _nanprod)
_reg_reduce('max', _max, aliases=('max_axis',))
_reg_reduce('min', _min, aliases=('min_axis',))


@register('norm', input_names=('data',))
def _norm(attrs, data):
    # the reference's 0.11 norm: L2 over the whole array, shape (1,)
    return torch.sqrt(torch.sum(torch.square(data))).reshape((1,))


def _reg_arg_reduce(name, fn):
    @register(name, input_names=('data',))
    def _op(attrs, data, _fn=fn):
        axis = parse_attr_value(attrs.get('axis', None))
        keepdims = asbool(attrs.get('keepdims', False))
        if axis is None:
            out = _fn(data.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * data.ndim)
            return out.to(data.dtype)
        out = _fn(data, dim=normalize_axis(axis, data.ndim),
                  keepdim=keepdims)
        # the reference returns indices in the input's float dtype
        return out.to(data.dtype)
    return _op


_reg_arg_reduce('argmax', torch.argmax)
_reg_arg_reduce('argmin', torch.argmin)


@register('argmax_channel', input_names=('data',))
def _argmax_channel(attrs, data):
    return torch.argmax(data, dim=1).to(data.dtype)


# ---------------------------------------------------------------------------
# Matrix / linear algebra
# ---------------------------------------------------------------------------

@register('dot', input_names=('lhs', 'rhs'))
def _dot(attrs, lhs, rhs):
    if asbool(attrs.get('transpose_a', False)) and lhs.ndim > 1:
        lhs = torch.movedim(lhs, 0, -1)
    if asbool(attrs.get('transpose_b', False)) and rhs.ndim > 1:
        rhs = torch.movedim(rhs, -1, 0)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs).reshape((1,))
    return torch.tensordot(lhs, rhs, dims=1)


@register('batch_dot', input_names=('lhs', 'rhs'))
def _batch_dot(attrs, lhs, rhs):
    if asbool(attrs.get('transpose_a', False)):
        lhs = torch.swapaxes(lhs, -1, -2)
    if asbool(attrs.get('transpose_b', False)):
        rhs = torch.swapaxes(rhs, -1, -2)
    return torch.matmul(lhs, rhs)


@register('transpose', input_names=('data',))
def _transpose(attrs, data):
    axes = parse_attr_value(attrs.get('axes', None))
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(tuple(axes))


@register('SwapAxis', input_names=('data',), aliases=('swapaxes',))
def _swapaxes(attrs, data):
    return torch.swapaxes(data, asint(attrs.get('dim1', 0)),
                          asint(attrs.get('dim2', 0)))


@register('expand_dims', input_names=('data',))
def _expand_dims(attrs, data):
    return torch.unsqueeze(data, asint(attrs['axis']))


def _reshape_target(shape_spec, ishape, reverse=False):
    """The reference's Reshape special codes 0, -1, -2, -3, -4
    (src/operator/tensor/matrix_op-inl.h ReshapeInferShape)."""
    if reverse:
        rev = _reshape_target(tuple(reversed(shape_spec)),
                              tuple(reversed(ishape)), False)
        return tuple(reversed(rev))
    out = []
    src = list(ishape)
    i = 0  # position in src
    spec = list(shape_spec)
    j = 0
    infer_at = None
    while j < len(spec):
        s = spec[j]
        if s > 0:
            out.append(s)
            i += 1
        elif s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            if infer_at is not None:
                raise ValueError('only one -1 allowed in reshape')
            infer_at = len(out)
            out.append(1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            raise ValueError('bad reshape code %d' % s)
        j += 1
    if infer_at is not None:
        known = 1
        for k, d in enumerate(out):
            if k != infer_at:
                known *= d
        total = 1
        for d in ishape:
            total *= d
        out[infer_at] = total // max(known, 1)
    return tuple(out)


@register('Reshape', input_names=('data',), aliases=('reshape',))
def _reshape(attrs, data):
    shape = astuple(attrs['shape'])
    reverse = asbool(attrs.get('reverse', False))
    return torch.reshape(data, _reshape_target(shape, tuple(data.shape),
                                               reverse))


@register('Flatten', input_names=('data',), aliases=('flatten',))
def _flatten(attrs, data):
    return torch.reshape(data, (data.shape[0], -1))


def _concat_names(attrs):
    return ['arg%d' % i for i in range(asint(attrs.get('num_args', 1)))]


@register('Concat', input_names=_concat_names, aliases=('concat',))
def _concat(attrs, *args):
    return torch.cat(args, dim=asint(attrs.get('dim', 1)))


@register('SliceChannel', input_names=('data',), aliases=('split',),
          num_outputs=lambda attrs: asint(attrs['num_outputs']))
def _slice_channel(attrs, data):
    n = asint(attrs['num_outputs'])
    axis = normalize_axis(attrs.get('axis', 1), data.ndim)
    if data.shape[axis] % n:
        raise ValueError('SliceChannel: axis %d of size %d does not split '
                         'into %d equal parts' % (axis, data.shape[axis], n))
    outs = torch.split(data, data.shape[axis] // n, dim=axis)
    if asbool(attrs.get('squeeze_axis', False)):
        outs = [torch.squeeze(o, dim=axis) for o in outs]
    return tuple(outs)


def _index_axis(data, axis, sl):
    """data[..., sl, ...] on `axis` for a Python slice of any step; torch
    slicing takes no negative step, so that one gathers its indices."""
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * data.ndim
        idx[axis] = sl
        return data[tuple(idx)]
    rows = list(range(*sl.indices(data.shape[axis])))
    return torch.index_select(
        data, axis, torch.tensor(rows, dtype=torch.long, device=data.device))


@register('slice', input_names=('data',), aliases=('crop',))
def _slice(attrs, data):
    begin = parse_attr_value(attrs['begin'])
    end = parse_attr_value(attrs['end'])
    if isinstance(begin, int):
        begin = (begin,)
    if isinstance(end, int):
        end = (end,)
    step = parse_attr_value(attrs.get('step', None)) or (None,) * len(begin)
    if isinstance(step, int):
        step = (step,)
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        data = _index_axis(data, axis, slice(b, e, s))
    return data


@register('slice_axis', input_names=('data',))
def _slice_axis(attrs, data):
    axis = normalize_axis(attrs['axis'], data.ndim)
    begin = asint(attrs.get('begin', 0))
    end = parse_attr_value(attrs.get('end', None))
    return _index_axis(data, axis,
                       slice(begin, None if end is None else int(end)))


@register('reverse', input_names=('data',), aliases=('flip',))
def _reverse(attrs, data):
    axis = parse_attr_value(attrs['axis'])
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(data, dims=tuple(axis))


@register('tile', input_names=('data',))
def _tile(attrs, data):
    return torch.tile(data, astuple(attrs['reps']))


@register('repeat', input_names=('data',))
def _repeat(attrs, data):
    repeats = asint(attrs['repeats'])
    axis = parse_attr_value(attrs.get('axis', None))
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=int(axis))


def _pad_rows(n, lo, hi, mode):
    """Source rows of an axis of size n padded by (lo, hi), as numpy's
    'edge' or 'reflect' pad picks them."""
    rows = []
    for i in range(-lo, n + hi):
        if mode == 'edge':
            rows.append(min(max(i, 0), n - 1))
            continue
        period = 2 * (n - 1)
        j = abs(i) % period if period else 0
        rows.append(period - j if j >= n else j)
    return rows


@register('Pad', input_names=('data',), aliases=('pad',))
def _pad(attrs, data):
    pw = astuple(attrs['pad_width'])
    mode = str(parse_attr_value(attrs.get('mode', 'constant')))
    pads = [(pw[2 * i], pw[2 * i + 1]) for i in range(data.ndim)]
    if mode == 'constant':
        cv = asfloat(attrs.get('constant_value', 0.0))
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return torch.nn.functional.pad(data, flat, mode='constant', value=cv)
    mode = {'edge': 'edge', 'reflect': 'reflect'}[mode]
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            rows = _pad_rows(data.shape[axis], lo, hi, mode)
            data = torch.index_select(data, axis, torch.tensor(
                rows, dtype=torch.long, device=data.device))
    return data


@register('stack', input_names=_concat_names)
def _stack(attrs, *args):
    return torch.stack(args, dim=asint(attrs.get('axis', 0)))


@register('space_to_depth', input_names=('data',))
def _space_to_depth(attrs, data):
    bs = asint(attrs['block_size'])
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


@register('depth_to_space', input_names=('data',))
def _depth_to_space(attrs, data):
    bs = asint(attrs['block_size'])
    n, c, h, w = data.shape
    x = data.reshape(n, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (bs * bs), h * bs, w * bs)


# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------

def _as_index(t):
    """An index array as the JAX package takes it: truncated to int32
    (so -0.5 reads row 0), widened to the long torch indexes with."""
    return t.to(torch.int32).long()


@register('Embedding', input_names=('data', 'weight'))
def _embedding(attrs, data, weight):
    # the reference clips out-of-range ids to the table's edge
    idx = _as_index(data).clamp(0, weight.shape[0] - 1)
    return weight[idx]


def _take_along(a, idx, axis):
    """jnp.take(a, idx, axis) for in-range (clipped or wrapped) idx."""
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape) +
                       tuple(a.shape[axis + 1:]))


@register('take', input_names=('a', 'indices'))
def _take(attrs, a, indices):
    axis = normalize_axis(attrs.get('axis', 0), a.ndim)
    mode = str(parse_attr_value(attrs.get('mode', 'clip')))
    if mode not in ('clip', 'wrap'):
        raise MXNetError(
            "take: unsupported mode %r — this backend implements 'clip' "
            "and 'wrap', as the JAX package does" % mode)
    n = a.shape[axis]
    idx = _as_index(indices)
    idx = idx.clamp(0, n - 1) if mode == 'clip' else torch.remainder(idx, n)
    return _take_along(a, idx, axis)


def _fill_value(dtype):
    """What jnp's gather gives past the end: NaN for a float, the most
    negative value of a signed integer, the largest of an unsigned one."""
    if dtype.is_floating_point:
        return float('nan')
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if dtype in _UNSIGNED else info.min


def _take_filled(data, idx, axis):
    """torch.gather(data, axis, idx) as jnp.take_along_axis reads it: an
    index -n <= i < 0 counts from the end, and one out of [-n, n) gives
    `_fill_value`. All on the device: no host sync, no device assert."""
    n = data.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    out = torch.gather(data, axis, idx.clamp(0, max(n - 1, 0)))
    return torch.where(inside, out, torch.full(
        (), _fill_value(data.dtype), dtype=data.dtype, device=data.device))


@register('batch_take', input_names=('a', 'indices'))
def _batch_take(attrs, a, indices):
    return _take_filled(a, _as_index(indices)[:, None], 1)[:, 0]


@register('pick', input_names=('data', 'index'))
def _pick(attrs, data, index):
    """Pick elements along `axis` by per-position index (axis -1 by
    default; the flattened axis=None mode is not supported)."""
    axis = normalize_axis(parse_attr_value(attrs.get('axis', -1)),
                          data.ndim)
    keepdims = asbool(attrs.get('keepdims', False))
    out = _take_filled(data, _as_index(index).unsqueeze(axis), axis)
    return out if keepdims else torch.squeeze(out, dim=axis)


def _one_hot_of(idx, depth, dtype):
    """one_hot as jax.nn.one_hot: an index out of [0, depth) gives a row
    of zeros."""
    classes = torch.arange(depth, device=idx.device)
    return (idx.unsqueeze(-1) == classes).to(dtype)


@register('one_hot', input_names=('indices',))
def _one_hot(attrs, indices):
    depth = asint(attrs['depth'])
    on = asfloat(attrs.get('on_value', 1.0))
    off = asfloat(attrs.get('off_value', 0.0))
    dt = _dtype(attrs)
    oh = _one_hot_of(_as_index(indices), depth, dt)
    return (oh * (on - off) + off).to(dt)


@register('where', input_names=('condition', 'x', 'y'))
def _where(attrs, condition, x, y):
    cond = condition.to(torch.bool)
    if condition.ndim != x.ndim:
        cond = cond.reshape(tuple(condition.shape) +
                            (1,) * (x.ndim - condition.ndim))
    return torch.where(cond, x, y)


def _nd_index(indices, shape):
    """The rows of an index array over the leading dims of `shape`, each
    with -n <= i < 0 counted from the end, and whether each position is
    inside [0, n) in every dim."""
    idx = _as_index(indices)
    rows, inside = [], True
    for i, n in enumerate(shape[:idx.shape[0]]):
        r = torch.where(idx[i] < 0, idx[i] + n, idx[i])
        inside = inside & (r >= 0) & (r < n)
        rows.append(r)
    return rows, inside


@register('gather_nd', input_names=('data', 'indices'))
def _gather_nd(attrs, data, indices):
    """data[indices], an index out of range clamped to the edge, as jnp's
    indexing reads it."""
    rows, _ = _nd_index(indices, data.shape)
    return data[tuple(r.clamp(0, max(n - 1, 0))
                      for r, n in zip(rows, data.shape))]


def _scatter(attrs, data, indices, accumulate):
    """zeros(shape) with data put at indices, as jnp's .at[] does: an
    update out of range is dropped. Each dropped update goes to one extra
    slot past the end of every indexed dim, which is sliced off: no host
    sync."""
    shape = astuple(attrs['shape'])
    rows, inside = _nd_index(indices, shape)
    m = len(rows)
    out = torch.zeros([n + 1 for n in shape[:m]] + list(shape[m:]),
                      dtype=data.dtype, device=data.device)
    rows = tuple(torch.where(inside, r, n) for r, n in zip(rows, shape))
    out = out.index_put(rows, data, accumulate=accumulate)
    return out[tuple(slice(0, n) for n in shape[:m])].clone()


@register('scatter_nd', input_names=('data', 'indices'))
def _scatter_nd(attrs, data, indices):
    return _scatter(attrs, data, indices, accumulate=False)


@register('_backward_gather_nd', input_names=('data', 'indices'),
          aliases=('scatter_nd_acc',))
def _backward_gather_nd(attrs, data, indices):
    """Accumulating scatter (the reference's gather_nd gradient):
    duplicate indices add instead of scatter_nd's undefined last-wins."""
    return _scatter(attrs, data, indices, accumulate=True)


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------

@register('sort', input_names=('data',))
def _sort(attrs, data):
    axis = parse_attr_value(attrs.get('axis', -1))
    is_ascend = asbool(attrs.get('is_ascend', True))
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.sort(data, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, dims=(int(axis),))


@register('argsort', input_names=('data',))
def _argsort(attrs, data):
    axis = parse_attr_value(attrs.get('axis', -1))
    is_ascend = asbool(attrs.get('is_ascend', True))
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.argsort(data, dim=int(axis), stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(int(axis),))
    return out.to(_dtype(attrs, data.dtype))


@register('topk', input_names=('data',),
          num_outputs=lambda attrs: 2 if str(parse_attr_value(
              attrs.get('ret_typ', 'indices'))) == 'both' else 1)
def _topk(attrs, data):
    axis = parse_attr_value(attrs.get('axis', -1))
    k = asint(attrs.get('k', 1))
    ret_typ = str(parse_attr_value(attrs.get('ret_typ', 'indices')))
    is_ascend = asbool(attrs.get('is_ascend', False))
    if axis is None:
        data, axis = data.reshape(-1), 0
    axis = normalize_axis(axis, data.ndim)
    # a stable sort narrowed to k: among equal values the lower index
    # comes first, as in jax.lax.top_k (torch.topk breaks ties otherwise)
    vals, idx = torch.sort(data, dim=axis, descending=not is_ascend,
                           stable=True)
    vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    if ret_typ == 'value':
        return vals
    if ret_typ == 'indices':
        return idx.to(data.dtype)
    if ret_typ == 'mask':
        oh = _one_hot_of(torch.movedim(idx, axis, -1), data.shape[axis],
                         data.dtype)
        return torch.movedim(oh.sum(dim=-2), -1, axis)
    return vals, idx.to(data.dtype)


# ---------------------------------------------------------------------------
# Init ops: made on the device of the invocation (op_ctx.device)
# ---------------------------------------------------------------------------

@register('_zeros', input_names=(), aliases=('zeros',), simple=False)
def _zeros(attrs, inputs, auxs, op_ctx):
    return [torch.zeros(astuple(attrs['shape']), dtype=_dtype(attrs),
                        device=op_ctx.device)], []


@register('_ones', input_names=(), aliases=('ones',), simple=False)
def _ones(attrs, inputs, auxs, op_ctx):
    return [torch.ones(astuple(attrs['shape']), dtype=_dtype(attrs),
                       device=op_ctx.device)], []


@register('_full', input_names=(), aliases=('full',), simple=False)
def _full(attrs, inputs, auxs, op_ctx):
    return [torch.full(astuple(attrs['shape']), asfloat(attrs['value']),
                       dtype=_dtype(attrs), device=op_ctx.device)], []


@register('_arange', input_names=(), aliases=('arange',), simple=False)
def _arange(attrs, inputs, auxs, op_ctx):
    start = asfloat(attrs.get('start', 0))
    stop = parse_attr_value(attrs.get('stop', None))
    step = asfloat(attrs.get('step', 1.0))
    repeat = asint(attrs.get('repeat', 1))
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, float(stop), step, dtype=_dtype(attrs),
                       device=op_ctx.device)
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return [out], []


@register('_eye', input_names=(), aliases=('eye',), simple=False)
def _eye(attrs, inputs, auxs, op_ctx):
    n = asint(attrs['N'])
    m = parse_attr_value(attrs.get('M', None))
    m = int(m) if m else n
    k = asint(attrs.get('k', 0))
    rows = torch.arange(n, device=op_ctx.device)[:, None]
    cols = torch.arange(m, device=op_ctx.device)[None, :]
    return [(cols - rows == k).to(_dtype(attrs))], []


# ---------------------------------------------------------------------------
# N-ary sum
# ---------------------------------------------------------------------------

@register('add_n', input_names=_concat_names,
          aliases=('ElementWiseSum', '_sum'))
def _add_n(attrs, *args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# Slice-assign: the functional form of lhs[begin:end] = rhs
# ---------------------------------------------------------------------------

def _assign_slices(attrs, shape):
    begin = astuple(attrs['begin'])
    end = astuple(attrs['end'])
    idx = tuple(slice(int(b), int(e)) for b, e in zip(begin, end))
    return idx + tuple(slice(None) for _ in range(len(shape) - len(idx)))


@register('_slice_assign', input_names=('lhs', 'rhs'),
          aliases=('_crop_assign',))
def _slice_assign(attrs, lhs, rhs):
    out = lhs.clone()
    out[_assign_slices(attrs, lhs.shape)] = rhs.to(lhs.dtype)
    return out


@register('_crop_assign_scalar', input_names=('data',))
def _crop_assign_scalar(attrs, data):
    out = data.clone()
    out[_assign_slices(attrs, data.shape)] = asfloat(attrs.get('scalar', 0.0))
    return out
