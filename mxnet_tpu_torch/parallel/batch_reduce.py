"""The registered ops that reduce over the batch axis, made global under
a data mesh.

The JAX Module over a data mesh is one GSPMD program: an op that reduces
a batch-carrying tensor over axis 0 gives the one-device answer on the
global batch. In the port each rank of the mesh holds its rows of the
batch (module/executor_group.py), so each of these ops runs here on
this rank's rows and meets the other ranks in a collective. Forward and
backward follow the convention of `collectives.py`: a value replicated
over the data axis carries the same whole cotangent on every rank.

- sum, sum_axis, nansum, softmax_cross_entropy: the local op, then
  `allreduce_sum` (its backward the identity). mean: the local sum over
  the reduced axes, summed, over the global count. norm (L2 over the
  whole array, the op's own definition in both packages): the square
  root of the summed squares.
- prod, nanprod: the ranks' partial products multiplied in axis order
  (the same bits on every rank); the backward gives each element the
  product of all the others, as torch's and JAX's do with zeros.
- max, max_axis, min, min_axis: the extremum over the ranks; the
  cotangent splits evenly over the ties, counted over every rank, as
  JAX's VJP of max and min splits it.
- sort and argsort over axis 0: the global order over the gathered batch
  (stable, so ties keep the batch order), each rank keeping its block;
  argsort's indices are global. Over every axis (axis=None) the
  flattened result is replicated.
- topk over axis 0 (or every axis): the replicated (k, ...) result over
  the gathered batch; ret_typ='mask' over axis 0 is this rank's block.

The executor (executor.py) tells a batch-carrying value from a
replicated one, routes each of these ops here when its input carries the
batch, and keeps the gradients of the parameters that enter replicated
math from being summed over the mesh twice (`root_grad`).
"""
import torch
import torch.distributed as dist

from . import collectives as C
from ..ops.registry import asbool, normalize_axis
from ..base import parse_attr_value


def _axes(attrs, ndim):
    from ..ops.tensor import _red_axes
    return _red_axes(attrs, ndim)


def _sort_axis(attrs):
    return parse_attr_value(attrs.get('axis', -1))


def output_replicated(name, attrs, ndim):
    """Whether op `name`, reducing a batch-carrying input over axis 0,
    gives a replicated value (else this rank's block of a batch-carrying
    one)."""
    if name in ('sort', 'argsort'):
        return _sort_axis(attrs) is None
    if name == 'topk':
        return _sort_axis(attrs) is None or str(parse_attr_value(
            attrs.get('ret_typ', 'indices'))) != 'mask'
    return True


def _reduce_wire(x, mesh, op):
    """x reduced by `op` (a dist.ReduceOp) over the data axis, with no
    gradient."""
    w = C._to_wire(mesh, x.detach())
    if w is x:
        w = w.clone()
    dist.all_reduce(w, op=op, group=mesh.group('data'))
    return C._from_wire(mesh, w)


class _ValueOf(torch.autograd.Function):
    """Forward: `value`; backward: the cotangent goes to `expr`, whose
    value equals `value` up to the order of its arithmetic."""

    @staticmethod
    def forward(ctx, expr, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Extreme(torch.autograd.Function):
    """max or min over `axes` (axis 0 among them) of the global batch; the
    cotangent split over the ties of every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes, keepdims, largest):
        local = torch.amax(x, dim=axes, keepdim=True) if largest else \
            torch.amin(x, dim=axes, keepdim=True)
        best = _reduce_wire(local, mesh, dist.ReduceOp.MAX if largest
                            else dist.ReduceOp.MIN)
        mask = (x == best)
        count = _reduce_wire(mask.sum(dim=axes, keepdim=True).to(x.dtype),
                             mesh, dist.ReduceOp.SUM)
        ctx.save_for_backward(mask, count)
        ctx.axes, ctx.keepdims = axes, keepdims
        return best if keepdims else best.squeeze(axes)

    @staticmethod
    def backward(ctx, g):
        mask, count = ctx.saved_tensors
        if not ctx.keepdims:
            for a in sorted(ctx.axes):
                g = g.unsqueeze(a)
        return g * mask.to(g.dtype) / count.to(g.dtype), None, None, None, \
            None


class _RootGrad(torch.autograd.Function):
    """The identity whose gradient is kept by data index 0 only: a
    replicated value whose every use is replicated math gets its whole
    gradient on every rank, and the in-step all-reduce then sums it
    once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.root = mesh.axis_index('data') == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.root else torch.zeros_like(g)), None


def root_grad(x, mesh):
    """x, whose gradient stays on data index 0 alone (_RootGrad)."""
    if not x.requires_grad:
        return x
    return _RootGrad.apply(x, mesh)


def enter_batch(x, mesh):
    """A replicated value that enters per-rank math: its cotangent is
    summed over the data axis (collectives.copy_to_axis)."""
    if not x.requires_grad:
        return x
    return C.copy_to_axis(x, 'data', mesh)


def global_reduce(op, attrs, vals, mesh):
    """The outputs of registered op `op` on the global batch, from this
    rank's rows `vals` (the op's inputs, the first carrying the
    batch)."""
    name = op.name
    x = vals[0]
    ndim = x.ndim
    dp = mesh.axis_size('data')
    if name in ('sum', 'nansum', 'softmax_cross_entropy'):
        local, _ = op.apply(attrs, vals, [], None)
        return [C.allreduce_sum(local[0], 'data', mesh)]
    if name == 'mean':
        axes = _axes(attrs, ndim)
        keepdims = asbool(attrs.get('keepdims', False))
        if not x.is_floating_point():
            x = x.float()
        # a 16-bit input sums in float32, as the one-device mean does
        wide = x.float() if x.dtype in (torch.float16, torch.bfloat16) \
            else x
        total = C.allreduce_sum(torch.sum(wide, dim=axes, keepdim=keepdims),
                                'data', mesh)
        count = dp
        for a in axes:
            count *= x.shape[a]
        return [(total / count).to(x.dtype)]
    if name == 'norm':
        ss = C.allreduce_sum(torch.sum(torch.square(x)), 'data', mesh)
        return [torch.sqrt(ss).reshape((1,))]
    if name in ('prod', 'nanprod'):
        local, _ = op.apply(attrs, vals, [], None)
        local = local[0]
        parts = C._all_gather(local.detach().unsqueeze(0), mesh, 'data', 0)
        me = mesh.axis_index('data')
        value = parts[0]
        others = None
        for j in range(dp):
            if j:
                value = value * parts[j]
            if j != me:
                others = parts[j] if others is None else others * parts[j]
        return [_ValueOf.apply(local * others, value)]
    if name in ('max', 'min'):
        axes = _axes(attrs, ndim)
        return [_Extreme.apply(x, mesh, axes,
                               asbool(attrs.get('keepdims', False)),
                               name == 'max')]
    if name in ('sort', 'argsort', 'topk'):
        full = C.allgather(x, 'data', 0, mesh=mesh)
        outs, _ = op.apply(attrs, [full], [], None)
        if output_replicated(name, attrs, ndim):
            return outs
        return [C.shard(o, 'data', 0, mesh=mesh) for o in outs]
    raise ValueError('%s has no global form over the batch' % name)


def reduces_batch(name, attrs, ndim):
    """Whether registered op `name` reduces axis 0 of an input of `ndim`
    dimensions (the ops global_reduce takes)."""
    if name in ('sort', 'argsort', 'topk'):
        axis = _sort_axis(attrs)
        return axis is None or normalize_axis(axis, ndim) == 0
    if name == 'softmax_cross_entropy':
        return True
    if name in ('norm',):
        return True
    if name in ('sum', 'mean', 'prod', 'nansum', 'nanprod', 'max', 'min'):
        return 0 in _axes(attrs, ndim)
    return False
