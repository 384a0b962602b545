"""Collectives over an axis of the mesh: the counterpart of
mxnet_tpu/parallel/collectives.py.

The JAX forms run inside shard_map over a named axis; here they run in
every rank's process over that axis's group of the mesh (`mesh=`, or
the current mesh of `mesh.use_mesh`). Over an axis of one rank each is
the identity, as a collective over a one-device axis is in JAX.

The collectives that carry a gradient are `torch.autograd.Function`s.
Their backward follows one convention: a value replicated over an axis
carries the same whole cotangent on every rank of it. So `allreduce_sum`
(the row-parallel output) is the identity backward, and `copy_to_axis`,
where a replicated value enters per-rank math (the column-parallel
input), all-reduces its cotangent: Megatron's pair. `allgather` slices
its cotangent, and `shard`, which takes this rank's block of a
replicated value, all-gathers it; `reduce_scatter` all-gathers,
`ppermute` and `all_to_all` send the cotangent back the way the value
came. With them a sharded step's gradient is the one-device gradient.
The JAX package's sharded step transposes its psums into psums again
(`check_vma=False`), which multiplies its gradients by the mesh size
(ROADMAP Queue C, findings in the JAX package); the port does not copy
that.

A gloo group carries CUDA tensors through pinned host memory: each
collective copies its payload to the host and the result back. That
copy is the wire; the math before and after stays on the card.
`profiler.mesh_stats()['mesh_staged_bytes']` counts it, and an NCCL
group never stages.

Also home of `GradReducePlan`, the JAX package's bucketing of gradients
for the in-step all-reduce: the same buckets for the same shapes, dtypes
and knobs (MXNET_TPU_REDUCE_BUCKETS, MXNET_TPU_ZERO_BUCKET_MB), one
explicit all-reduce a bucket. `GradReduce` binds a plan to the data axis
of a mesh for one backward at a time: with MXNET_TPU_INTERLEAVE_REDUCE on
(the default) a bucket's all-reduce starts, asynchronously, from the
gradient hooks as soon as the backward has made the bucket's last
gradient; off, every bucket is reduced after the backward. The buckets
are issued in the plan's order on every rank either way, and both
schedules give the same bits.

`allreduce_sum_sync` is the data-parallel statistic sum (SyncBatchNorm's):
its backward sums the cotangent over the axis too, since each rank's loss
covers only its own rows. `reduce_scatter_flat` and `all_gather_flat`
carry the ZeRO-1 buckets (parallel/zero.py): NCCL's reduce-scatter and
all-gather, and on gloo, which has no reduce-scatter, the all-reduce's own
block (`profiler.comm_stats` counts which one the wire carried).
"""
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import profiler
from .mesh import current_mesh

_ZERO_BUCKET_MB = 32.0      # the JAX package's zero.DEFAULT_BUCKET_MB


def _mesh(mesh):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError('collectives run over an axis of a mesh: pass '
                         'mesh= or enter mesh.use_mesh(mesh)')
    return mesh


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


# -- the wire: one collective on one axis's group --------------------------

def _nbytes(t):
    return t.numel() * t.element_size()


def _pinned(shape, dtype):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _to_wire(mesh, t):
    """The tensor handed to the backend: t itself, or a pinned host copy
    of it on a gloo group (counted as staged)."""
    t = t.contiguous()
    profiler.add_mesh_stats(collectives=1, payload_bytes=_nbytes(t))
    if not mesh.staged:
        return t
    host = _pinned(t.shape, t.dtype)
    host.copy_(t)
    profiler.add_mesh_stats(staged_bytes=_nbytes(t))
    return host


def _wire_empty(mesh, shape, dtype):
    if mesh.staged:
        return _pinned(shape, dtype)
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def _from_wire(mesh, t):
    if not mesh.staged:
        return t
    profiler.add_mesh_stats(staged_bytes=_nbytes(t))
    return t.to(mesh.device, non_blocking=True)


def _all_reduce(x, mesh, axis):
    w = _to_wire(mesh, x)
    if w is x:
        w = w.clone()
    dist.all_reduce(w, group=mesh.group(axis))
    return _from_wire(mesh, w)


def _broadcast(x, mesh, axis):
    """Axis index 0's x on every rank of the axis."""
    w = _to_wire(mesh, x)
    if w is x:
        w = w.clone()
    dist.broadcast(w, src=mesh.axis_ranks(axis)[0], group=mesh.group(axis))
    return _from_wire(mesh, w)


def _all_gather(x, mesh, axis, dim):
    """The axis's blocks concatenated along `dim`, by axis index."""
    w = _to_wire(mesh, x)
    n = mesh.axis_size(axis)
    parts = [_wire_empty(mesh, w.shape, w.dtype) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return _from_wire(mesh, torch.cat(parts, dim=dim))


def _block(x, mesh, axis, dim):
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[dim] % n:
        raise ValueError('dimension %d of size %d does not divide over '
                         'axis %r of %d' % (dim, x.shape[dim], axis, n))
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def _ppermute(x, mesh, axis, perm):
    """JAX's ppermute over axis indices: (src, dst) pairs; a rank no pair
    sends to gets zeros."""
    me = mesh.axis_index(axis)
    ranks, group = mesh.axis_ranks(axis), mesh.group(axis)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if len(sends) > 1 or len(recvs) > 1:
        raise ValueError('ppermute: %r is not a permutation' % (perm,))
    if recvs and recvs[0] == me:
        return x.clone()
    ops, out = [], None
    if sends:
        w = _to_wire(mesh, x)
        ops.append(dist.P2POp(dist.isend, w, ranks[sends[0]], group))
    if recvs:
        out = _wire_empty(mesh, x.shape, x.dtype)
        ops.append(dist.P2POp(dist.irecv, out, ranks[recvs[0]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if out is None:
        return torch.zeros_like(x)
    return _from_wire(mesh, out)


def _all_to_all(x, mesh, axis, split_axis, concat_axis):
    n = mesh.axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError('all_to_all: dimension %d of size %d does not '
                         'split over %d' % (split_axis,
                                            x.shape[split_axis], n))
    # the n blocks of split_axis stacked first: block j goes to index j
    blocks = torch.stack(x.chunk(n, dim=split_axis))
    w = _to_wire(mesh, blocks)
    out = _wire_empty(mesh, w.shape, w.dtype)
    dist.all_to_all_single(out, w, group=mesh.group(axis))
    got = _from_wire(mesh, out)
    return torch.cat(got.unbind(0), dim=concat_axis)


# -- autograd Functions -----------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        # gloo has no reduce-scatter: the all-reduce's own block
        return _block(_all_reduce(x, mesh, axis), mesh, axis,
                      dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.mesh, ctx.axis, back), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, mesh, axis, concat_axis, split_axis), None,
                None, None, None)


# -- the shard_map forms ----------------------------------------------------

def allreduce_sum(x, axis_name, mesh=None):
    """Sum over the axis (or each of a tuple of axes); the gradient passes
    through unchanged (the result is replicated)."""
    mesh = _mesh(mesh)
    for axis in _axes(axis_name):
        if mesh.axis_size(axis) > 1:
            x = _AllReduceSum.apply(x, mesh, axis)
    return x


def allreduce_sum_sync(x, axis_name='data', mesh=None):
    """Sum over the axis whose gradient is summed over the axis as well:
    a statistic of the batch that every rank's rows feed and every
    rank's loss reads (BatchNorm's sums under a data mesh). Each rank
    holds only its own loss's part of the statistic's cotangent, so the
    backward adds them up."""
    mesh = _mesh(mesh)
    for axis in _axes(axis_name):
        if mesh.axis_size(axis) > 1:
            x = _SyncSum.apply(x, mesh, axis)
    return x


def allreduce_mean(x, axis_name, mesh=None):
    mesh = _mesh(mesh)
    n = int(np.prod([mesh.axis_size(a) for a in _axes(axis_name)]))
    return allreduce_sum(x, axis_name, mesh) / n


def copy_to_axis(x, axis_name, mesh=None):
    """The identity, whose gradient is summed over the axis: where a value
    replicated over the axis enters per-rank math (Megatron's f)."""
    mesh = _mesh(mesh)
    for axis in _axes(axis_name):
        if mesh.axis_size(axis) > 1:
            x = _CopyToAxis.apply(x, mesh, axis)
    return x


def allgather(x, axis_name, axis=0, tiled=True, mesh=None):
    """The axis's blocks joined along `axis` (tiled) or stacked in a new
    leading `axis` (not tiled), by axis index."""
    mesh = _mesh(mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    if mesh.axis_size(axis_name) == 1:
        return x
    return _AllGather.apply(x, mesh, axis_name, axis)


def shard(x, axis_name, dim=0, mesh=None):
    """This rank's block of x along `dim` (x replicated over the axis);
    its gradient is all-gathered."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis_name) == 1:
        return x
    return _Shard.apply(x, mesh, axis_name, dim)


def reduce_scatter(x, axis_name, scatter_dimension=0, tiled=True,
                   mesh=None):
    """This rank's block of the axis's sum, along scatter_dimension."""
    if not tiled:
        raise ValueError('reduce_scatter takes tiled=True only')
    mesh = _mesh(mesh)
    if mesh.axis_size(axis_name) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis_name, scatter_dimension)


def ppermute(x, axis_name, perm, mesh=None):
    """Send x along the (source, destination) pairs of axis indices in
    perm; a rank no pair sends to gets zeros."""
    mesh = _mesh(mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if mesh.axis_size(axis_name) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis_name, perm)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True,
               mesh=None):
    if not tiled:
        raise ValueError('all_to_all takes tiled=True only')
    mesh = _mesh(mesh)
    if mesh.axis_size(axis_name) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis_name, split_axis, concat_axis)


def axis_index(axis_name, mesh=None):
    return _mesh(mesh).axis_index(axis_name)


def axis_size(axis_name, mesh=None):
    mesh = _mesh(mesh)
    return int(np.prod([mesh.axis_size(a) for a in _axes(axis_name)]))


def quantized_allreduce(x, axis_name, mesh=None):
    """The int8-wire all-reduce (JAX collectives.quantized_allreduce):
    each rank quantizes x to symmetric int8 with its own scale
    (quantization.symmetric_scale / quantize_int8_math, the JAX
    package's codes bit for bit), all-gathers the codes and the scales,
    and every rank dequantizes and sums them in float32 in axis order,
    so all get the same bits. Not differentiable."""
    from ..quantization import quantize_int8_math, symmetric_scale
    mesh = _mesh(mesh)
    x = x.detach()
    scale = torch.as_tensor(symmetric_scale(x), dtype=torch.float32,
                            device=x.device).reshape(1)
    q = quantize_int8_math(x, scale)
    if mesh.axis_size(axis_name) == 1:
        qs, ss = q.unsqueeze(0), scale
    else:
        qs = _all_gather(q.unsqueeze(0), mesh, axis_name, 0)    # int8 wire
        ss = _all_gather(scale, mesh, axis_name, 0)
    deq = qs.to(torch.float32) * ss.reshape((-1,) + (1,) * x.ndim)
    return deq.sum(dim=0).to(x.dtype)


def barrier_all_hosts(name='mxnet_tpu_barrier', timeout=None):
    """Host-level barrier: the dist runtime's health-checked barrier when
    it is up (it names the ranks that failed to arrive within `timeout`),
    else torch.distributed.barrier on the default group."""
    from .. import dist as dist_runtime
    rt = dist_runtime.runtime()
    if rt is not None:
        rt.barrier(name, timeout=timeout)
        return
    dist.barrier()


# -- the GSPMD constraint forms ---------------------------------------------

def allreduce_bucket(x, mesh, axis='data'):
    """The explicit all-reduce over the data group (identity without a
    mesh): the JAX GSPMD constraint that lowers to one."""
    if mesh is None:
        return x
    return allreduce_sum(x, axis, mesh)


def reduce_scatter_bucket(x, mesh, axis='data'):
    """This rank's flat block of the sum over the data group (identity
    without a mesh), as the JAX constraint's psum_scatter leaves it."""
    if mesh is None:
        return x
    return reduce_scatter(x, axis, 0, mesh=mesh)


def allgather_bucket(x, mesh, axis='data'):
    """The data group's flat blocks joined (identity without a mesh)."""
    if mesh is None:
        return x
    return allgather(x, axis, 0, mesh=mesh)


def row_shard_constraint(x, mesh, axis='data'):
    """A sparse embedding table (or its momentum) pinned row-striped over
    `axis`: this rank's rows [r*s, min(n, (r+1)*s)), s = ceil(n / N), of
    the full table `x` (parallel/embedding.stripe_range); `x` itself
    without a mesh or over an axis of one rank."""
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] <= 1:
        return x
    from .embedding import stripe_range
    n = mesh.axis_size(axis)
    lo, hi = stripe_range(x.shape[0], n, mesh.axis_index(axis))
    return x[lo:hi]


def _expert_mesh(axis):
    """The mesh an expert-parallel block runs over: the fused step's data
    mesh for 'data', else the current mesh, when `axis` has more than
    one rank on it; else None."""
    from .mesh import current_data_mesh
    for mesh in ((current_data_mesh() if axis == 'data' else None),
                 current_mesh()):
        if mesh is not None and mesh.shape.get(axis, 1) > 1:
            return mesh
    return None


def expert_range(n, axis='data'):
    """(lo, hi): the experts of n this rank computes over `axis` of the
    expert mesh (contiguous, as even as n allows); (0, n) without one."""
    mesh = _expert_mesh(axis)
    if mesh is None:
        return 0, n
    size, i = mesh.axis_size(axis), mesh.axis_index(axis)
    return i * n // size, (i + 1) * n // size


class _ExpertShard(torch.autograd.Function):
    """This rank's experts of the sum over the axis; the cotangent of
    every rank's block is every rank's input's."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, lo, hi):
        ctx.args = (mesh, axis, dim, lo, hi, tuple(x.shape))
        return _all_reduce(x, mesh, axis).narrow(dim, lo, hi - lo) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, lo, hi, shape = ctx.args
        full = g.new_zeros(shape)
        full.narrow(dim, lo, hi - lo).copy_(g)
        return _all_reduce(full, mesh, axis), None, None, None, None, None


class _ExpertGather(torch.autograd.Function):
    """Every rank's experts joined; each rank's cotangent covers only its
    own tokens, so a block's is their sum over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, lo, n):
        ctx.args = (mesh, axis, dim, lo, x.shape[dim])
        shape = list(x.shape)
        shape[dim] = n
        full = x.new_zeros(shape)
        full.narrow(dim, lo, x.shape[dim]).copy_(x)
        return _all_reduce(full, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, lo, size = ctx.args
        return (_all_reduce(g, mesh, axis).narrow(dim, lo, size)
                .contiguous(), None, None, None, None, None)


def expert_shard(x, dim=0, axis='data'):
    """The expert-parallel dispatch of gluon.nn.MoE: over the fused
    step's data mesh (or the current mesh's `axis`), this rank's experts
    (expert_range) of the sum over the axis of every rank's (E, C, D)
    buffer, which holds each rank's tokens at their global slots; the
    identity without one. Its gradient gives every rank the whole
    buffer's cotangent."""
    mesh = _expert_mesh(axis)
    if mesh is None:
        return x
    lo, hi = expert_range(x.shape[dim], axis)
    return _ExpertShard.apply(x, mesh, axis, dim, lo, hi)


def expert_gather(x, num_experts, dim=0, axis='data'):
    """The inverse of expert_shard: every rank's experts' outputs joined
    into the (E, C, D) buffer on every rank; the identity without a
    mesh. Its gradient sums each block's cotangent over the axis."""
    mesh = _expert_mesh(axis)
    if mesh is None:
        return x
    lo, _ = expert_range(num_experts, axis)
    return _ExpertGather.apply(x, mesh, axis, dim, lo, num_experts)


def replicate_constraint(x):
    """A parameter held whole on every rank: the identity. In the JAX
    package it pins the expert weights replicated against the sharded
    dispatch; here every rank holds them whole already, and their
    gradients are summed over the data mesh with every other
    parameter's (GradReduce)."""
    return x


# -- the ZeRO-1 wire ---------------------------------------------------------

def reduce_scatter_flat(x, mesh, axis='data'):
    """This rank's block of the sum of the flat `x` over the axis (x's
    length a multiple of the axis size): NCCL's reduce-scatter, or on
    gloo the all-reduce's own block. Not differentiable; the identity
    without a mesh or over one rank."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    n = mesh.axis_size(axis)
    if mesh.backend == 'nccl':
        x = x.contiguous()
        out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
        profiler.add_mesh_stats(collectives=1, payload_bytes=_nbytes(x))
        dist.reduce_scatter_tensor(out, x, group=mesh.group(axis))
        profiler.add_comm_wire(reduce_scatter=1)
        return out
    profiler.add_comm_wire(reduce_scatter_as_all_reduce=1)
    return _block(_all_reduce(x, mesh, axis), mesh, axis, 0).contiguous()


def all_gather_flat(x, mesh, axis='data'):
    """The axis's flat blocks joined by axis index (NCCL's
    all_gather_into_tensor, gloo's all_gather). Not differentiable; the
    identity without a mesh or over one rank."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    if mesh.backend == 'nccl':
        x = x.contiguous()
        out = torch.empty(x.numel() * mesh.axis_size(axis), dtype=x.dtype,
                          device=x.device)
        profiler.add_mesh_stats(collectives=1, payload_bytes=_nbytes(x))
        dist.all_gather_into_tensor(out, x, group=mesh.group(axis))
        return out
    return _all_gather(x, mesh, axis, 0)


# -- the gradient-reduction plan --------------------------------------------

def interleave_reduce_enabled(explicit=None):
    """The gradient-reduction schedule: an explicit value wins, else
    MXNET_TPU_INTERLEAVE_REDUCE (default on: each bucket reduced from
    the backward's hooks as soon as it is whole; 0: every bucket after
    the backward)."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get('MXNET_TPU_INTERLEAVE_REDUCE', '1').strip() \
        not in ('0',)


def grad_barrier(grads):
    """The end-of-backward schedule's barrier: the identity on values.
    The torch step reaches it only once autograd has returned every
    gradient, so there is nothing to order."""
    return list(grads)


def reduce_bucket_count():
    """MXNET_TPU_REDUCE_BUCKETS as an int, or None (fill buckets by the
    bucket-MB target instead)."""
    v = os.environ.get('MXNET_TPU_REDUCE_BUCKETS', '').strip()
    if not v:
        return None
    n = int(v)
    if n < 1:
        raise ValueError('MXNET_TPU_REDUCE_BUCKETS must be >= 1, got %d' % n)
    return n


def bucket_bytes():
    """Bucket fill target in bytes (MXNET_TPU_ZERO_BUCKET_MB, as the JAX
    package's zero.bucket_bytes reads it)."""
    try:
        mb = float(os.environ.get('MXNET_TPU_ZERO_BUCKET_MB',
                                  str(_ZERO_BUCKET_MB)))
    except ValueError:
        mb = _ZERO_BUCKET_MB
    return max(1, int(mb * (1 << 20)))


def _dtype_key(dtype):
    """(itemsize, name) of a numpy or torch dtype: equal keys, one
    bucket."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize, str(dtype).split('.')[-1]
    dt = np.dtype(dtype)
    return dt.itemsize, dt.name


class GradReducePlan:
    """Static bucketing of gradients for the in-step all-reduce, the JAX
    plan's: buckets over the REVERSED parameter order (the backward
    makes the last layer's gradients first), same-dtype runs joined into
    flat buffers, a dtype change closing the bucket; filled to
    bucket_bytes() or split into MXNET_TPU_REDUCE_BUCKETS equal-byte
    shares."""

    def __init__(self, shapes, dtypes, max_bytes=None, n_buckets=None,
                 interleave=None):
        if max_bytes is None:
            max_bytes = bucket_bytes()
        if n_buckets is None:
            n_buckets = reduce_bucket_count()
        self.interleave = interleave_reduce_enabled(interleave)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        keys = [_dtype_key(d) for d in dtypes]
        sizes = [int(np.prod(s)) if len(s) else 1 for s in self.shapes]
        rev = list(range(len(self.shapes)))[::-1]
        if n_buckets is not None:
            total = sum(sizes[i] * keys[i][0] for i in rev)
            target = max(1, -(-total // n_buckets))
        else:
            target = max_bytes
        buckets = []
        cur, cur_bytes, cur_dt = [], 0, None
        for i in rev:
            nbytes = sizes[i] * keys[i][0]
            if cur and (keys[i] != cur_dt or cur_bytes >= target):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
            cur_dt = keys[i]
        if cur:
            buckets.append(cur)
        self.buckets = buckets
        self.key = ('gradreduce', self.interleave,
                    tuple(tuple(b) for b in buckets),
                    tuple((s, k[1]) for s, k in zip(self.shapes, keys)))

    @property
    def n_buckets(self):
        return len(self.buckets)

    def apply(self, grads, mesh, axis='data'):
        """All-reduce `grads` (aligned with the plan's parameters) over
        `axis` (or each of a tuple of axes), one collective a bucket;
        the identity without a mesh. Values equal per-parameter
        all-reduces."""
        grads = list(grads)
        if mesh is None:
            return grads
        out = list(grads)
        for b in self.buckets:
            flat = torch.cat([grads[i].reshape(-1) for i in b])
            red = allreduce_sum(flat, axis, mesh)
            off = 0
            for i in b:
                n = grads[i].numel()
                out[i] = red[off:off + n].reshape(grads[i].shape)
                off += n
        return out


class GradReduce:
    """A GradReducePlan bound to `axis` of `mesh`: the in-step all-reduce
    of the gradients at `positions` of an executor's differentiable
    arguments (aligned with the plan's parameters). `begin(leaves)`
    starts one backward's pass; its `finish(grads)` returns the grads
    with those positions summed over the axis."""

    def __init__(self, plan, mesh, positions, axis='data'):
        self.plan, self.mesh, self.axis = plan, mesh, axis
        self.positions = list(positions)
        self.key = (plan.key, axis)

    def begin(self, leaves):
        return _ReducePass(self, leaves)


class _ReducePass:
    """One backward's bucketed all-reduce. Interleaved, each plan leaf
    gets a hook that files its gradient; buckets are issued (async_op)
    in the plan's order as soon as each is whole, so every rank issues
    the same collectives in the same order. `finish` issues what is
    left (a parameter no output reaches has no hook call: its zeros go
    in then), waits for the collectives in order and unpacks."""

    def __init__(self, red, leaves):
        self.red = red
        plan = red.plan
        self.grads = [None] * len(red.positions)
        self.missing = [len(b) for b in plan.buckets]
        self.bucket_of = {}
        for k, b in enumerate(plan.buckets):
            for i in b:
                self.bucket_of[i] = k
        self.issued = []            # (bucket, work or None, wire tensor)
        self.next = 0
        self.leaves = [leaves[p] for p in red.positions]
        if plan.interleave:
            for i, t in enumerate(self.leaves):
                t.register_hook(functools.partial(self._ready, i))

    def _ready(self, i, g):
        if self.grads[i] is None:
            self.missing[self.bucket_of[i]] -= 1
        self.grads[i] = g
        self._issue_ready(async_op=True)

    def _issue_ready(self, async_op):
        plan = self.red.plan
        while self.next < len(plan.buckets) and \
                self.missing[self.next] == 0:
            self._issue(self.next, async_op)
            self.next += 1

    def _issue(self, k, async_op):
        mesh, axis = self.red.mesh, self.red.axis
        b = self.red.plan.buckets[k]
        flat = torch.cat([self.grads[i].reshape(-1) for i in b])
        wire = _to_wire(mesh, flat)
        profiler.add_reduce_stats(buckets_issued=1)
        work = dist.all_reduce(wire, group=mesh.group(axis),
                               async_op=async_op)
        self.issued.append((k, work, wire))

    def finish(self, grads):
        """grads: autograd's gradients of every leaf of the executor
        (zeros where it had none); returns them with the plan's
        positions all-reduced."""
        out = list(grads)
        for i, p in enumerate(self.red.positions):
            if self.grads[i] is None:
                self.missing[self.bucket_of[i]] -= 1
                self.grads[i] = grads[p]
        self._issue_ready(async_op=self.red.plan.interleave)
        for k, work, wire in self.issued:
            if work is not None:
                work.wait()
            red = _from_wire(self.red.mesh, wire)
            off = 0
            for i in self.red.plan.buckets[k]:
                n = self.grads[i].numel()
                out[self.red.positions[i]] = \
                    red[off:off + n].view(self.grads[i].shape)
                off += n
        self.grads = None
        return out
