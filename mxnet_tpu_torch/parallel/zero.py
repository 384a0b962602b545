"""ZeRO stage 1: the optimizer state sharded over the data axis, the
counterpart of mxnet_tpu/parallel/zero.py (Rajbhandari et al., "ZeRO:
Memory Optimizations Toward Training Trillion Parameter Models", SC'20,
stage P_os).

Every rank of a data mesh holds the same weights and, without ZeRO, the
same momenta and float32 masters, and runs the same update on them.
With ZeRO-1 each rank owns 1/N of that state: the gradients are
reduce-scattered instead of all-reduced (the same bytes on the wire),
the update runs on this rank's block only, and the updated block is
all-gathered back into the weights, in the weight's dtype.

The parameters are flattened into a few contiguous buckets, grouped by
weight dtype and precision class (a float32-master parameter never
shares a bucket with one updated in its own dtype), filled greedily up to
MXNET_TPU_ZERO_BUCKET_MB and padded to a multiple of the data size: the
JAX package's layout, bucket for bucket. The update is elementwise, so
running it on a bucket with per-element lr and wd vectors is the
per-parameter update. The JAX package writes that update with
`optimizer.sgd_update_math`; here it is written operation by operation
as the port's replicated FusedSGD rounds it (a scalar's product taken in
float32 and rounded to the accumulator's dtype), so that one rank with
ZeRO gives the replicated step's bits.

The JAX package's step is one GSPMD program whose sharding constraints
XLA lowers to the collectives; here each rank calls them
(`collectives.reduce_scatter_flat`, `collectives.all_gather_flat`).

Knobs: MXNET_TPU_ZERO=1 turns the sharded update on (default 0),
MXNET_TPU_ZERO_BUCKET_MB=N sets the bucket fill target in MiB (32).
"""
import os

import torch

from . import collectives

DEFAULT_BUCKET_MB = 32.0


def zero_stage(explicit=None):
    """The ZeRO stage: an explicit value wins, else MXNET_TPU_ZERO. Only
    0 (replicated) and 1 (sharded optimizer state) exist."""
    if explicit is not None:
        stage = int(explicit)
    else:
        v = os.environ.get('MXNET_TPU_ZERO', '0').strip()
        stage = 0 if v in ('', '0') else int(v)
    if stage not in (0, 1):
        raise ValueError('MXNET_TPU_ZERO must be 0 or 1 (ZeRO stage-1 '
                         'optimizer-state sharding), got %r' % stage)
    return stage


def bucket_bytes():
    """Bucket fill target in bytes (MXNET_TPU_ZERO_BUCKET_MB)."""
    return collectives.bucket_bytes()


def _torch_dtype(d):
    if isinstance(d, torch.dtype):
        return d
    from ..base import torch_dtype
    return torch_dtype(d)


def _dtype_name(d):
    return str(d).split('.')[-1]


class _Bucket:
    """One flat buffer: a run of parameters of one dtype and precision
    class, padded to a multiple of the data size."""

    __slots__ = ('index', 'param_idx', 'sizes', 'shapes', 'offsets',
                 'w_dtype', 'acc_dtype', 'mp', 'size', 'padded')

    def __init__(self, index, w_dtype, acc_dtype, mp):
        self.index = index
        self.param_idx = []
        self.sizes = []
        self.shapes = []
        self.offsets = []
        self.w_dtype = w_dtype
        self.acc_dtype = acc_dtype
        self.mp = mp
        self.size = 0
        self.padded = 0


class ZeroBucketLayout:
    """The flatten-and-bucket plan of one parameter list, derived from
    (shapes, dtypes, mp flags, data size, bucket byte target) as the JAX
    package derives it; `key` names it in the updater's cache key."""

    def __init__(self, shapes, dtypes, mp_flags, dp, max_bytes=None):
        if max_bytes is None:
            max_bytes = bucket_bytes()
        self.dp = max(1, int(dp))
        self.n_params = len(shapes)
        self.buckets = []
        open_buckets = {}       # (weight dtype, mp) -> bucket being filled
        for i, (shape, dtype, mp) in enumerate(zip(shapes, dtypes,
                                                   mp_flags)):
            w_dt = _torch_dtype(dtype)
            acc_dt = torch.float32 if mp else w_dt
            gkey = (w_dt, bool(mp))
            b = open_buckets.get(gkey)
            size = 1
            for d in shape:
                size *= int(d)
            if b is None or b.size * acc_dt.itemsize >= max_bytes:
                b = _Bucket(len(self.buckets), w_dt, acc_dt, bool(mp))
                self.buckets.append(b)
                open_buckets[gkey] = b
            b.param_idx.append(i)
            b.offsets.append(b.size)
            b.sizes.append(size)
            b.shapes.append(tuple(int(d) for d in shape))
            b.size += size
        for b in self.buckets:
            b.padded = -(-b.size // self.dp) * self.dp
        self.key = ('zero1', self.dp, tuple(
            (_dtype_name(b.w_dtype), _dtype_name(b.acc_dtype), b.mp,
             b.padded, tuple(b.param_idx), tuple(b.sizes))
            for b in self.buckets))

    def pack(self, b, vals):
        """The tensors of bucket `b`'s parameters joined into its flat
        buffer in the accumulation dtype, zero-padded."""
        parts = [v.reshape(-1).to(b.acc_dtype) for v in vals]
        if b.padded > b.size:
            parts.append(torch.zeros(b.padded - b.size, dtype=b.acc_dtype,
                                     device=parts[0].device))
        return torch.cat(parts)

    def pack_scalars(self, b, scalars, device=None):
        """The per-element float32 vector of per-parameter scalars (lr,
        wd): float32 is where torch takes a Python scalar's product, so
        the update rounds as the replicated one does."""
        parts = [torch.full((n,), float(s), dtype=torch.float32,
                            device=device)
                 for s, n in zip(scalars, b.sizes)]
        if b.padded > b.size:
            parts.append(torch.zeros(b.padded - b.size,
                                     dtype=torch.float32, device=device))
        return torch.cat(parts)

    def unpack(self, b, flat):
        """A full (gathered) bucket split back into per-parameter views."""
        return [flat[o:o + n].view(shape)
                for o, n, shape in zip(b.offsets, b.sizes, b.shapes)]

    def shard_range(self, b, index):
        """(lo, hi): the elements of bucket `b` that data index `index`
        owns."""
        n = b.padded // self.dp
        return index * n, (index + 1) * n

    def state_bytes_per_device(self):
        """Optimizer-state bytes each rank holds: its 1/dp block of the
        momenta and, for float32-master buckets, of the masters."""
        total = 0
        for b in self.buckets:
            shard = b.padded // self.dp
            total += shard * b.acc_dtype.itemsize
            if b.mp:
                total += shard * 4
        return total

    def comm_bytes_per_step(self):
        """(bytes_reduce_scattered, bytes_all_gathered) of one step: the
        gradient buckets in the accumulation dtype, the updated buckets
        in the weight dtype; (0, 0) at data size 1."""
        if self.dp <= 1:
            return 0, 0
        rs = sum(b.padded * b.acc_dtype.itemsize for b in self.buckets)
        ag = sum(b.padded * b.w_dtype.itemsize for b in self.buckets)
        return rs, ag


def make_sharded_sgd_step(layout, mesh, hyper):
    """`sharded_sgd_step` bound to a layout, mesh and hyperparameters by
    value: FusedSGD rebinds it whenever it rebuilds the layout."""
    def step_math(ws, gs, moms, masters, lrs, wds):
        return sharded_sgd_step(layout, mesh, hyper, ws, gs, moms,
                                masters, lrs, wds)
    return step_math


def _shard_update(acc, g, m, lr, wd, hyper):
    """The SGD / NAG update of one bucket's block, each operation rounded
    as FusedSGD.step_math's torch._foreach_* calls round it (lr and wd
    float32 vectors, each product rounded to acc's dtype)."""
    dt = acc.dtype
    g = g * hyper['rescale']
    if hyper['clip'] is not None:
        g = g.clamp(-hyper['clip'], hyper['clip'])
    g = g + (acc * wd).to(dt)
    momentum = hyper['momentum']
    if momentum == 0.0:
        return acc - (g * lr).to(dt), m
    if hyper['nesterov']:
        m = m * momentum + g
        step = ((m * momentum + g) * lr).to(dt)
        return acc - step, m
    m = m * momentum - (g * lr).to(dt)
    return acc + m, m


def sharded_sgd_step(layout, mesh, hyper, ws, gs, moms, masters, lrs,
                     wds):
    """The ZeRO-1 whole-model SGD / NAG update. ws, gs, lrs and wds are
    per parameter in the layout's order, gs this rank's own gradients
    (not yet summed over the data axis); moms and masters are per
    bucket, this rank's blocks. Each bucket's gradients are
    reduce-scattered, the block updated, and the updated bucket
    all-gathered into the weights, which are written in place. Every
    bucket is reduce-scattered before the first update, under either
    schedule (hyper['interleave']); the values do not depend on it.
    Returns (ws, new_moms, new_masters)."""
    if not hyper.get('interleave', True):
        gs = collectives.grad_barrier(gs)
    index = 0 if mesh is None else mesh.axis_index('data')
    device = ws[0].device if ws else None
    shards = [collectives.reduce_scatter_flat(
        layout.pack(b, [gs[i] for i in b.param_idx]), mesh)
        for b in layout.buckets]
    new_moms, new_masters = [], []
    for b, g in zip(layout.buckets, shards):
        lo, hi = layout.shard_range(b, index)
        if b.mp:
            acc = masters[b.index]
        else:
            # the replicated weight's own block: a local slice
            acc = layout.pack(b, [ws[i] for i in b.param_idx])[lo:hi]
        lr = layout.pack_scalars(b, [lrs[i] for i in b.param_idx],
                                 device)[lo:hi]
        wd = layout.pack_scalars(b, [wds[i] for i in b.param_idx],
                                 device)[lo:hi]
        acc, nm = _shard_update(acc, g, moms[b.index], lr, wd, hyper)
        new_moms.append(nm)
        if b.mp:
            new_masters.append(acc)
            full = collectives.all_gather_flat(acc.to(b.w_dtype), mesh)
        else:
            new_masters.append(None)
            full = collectives.all_gather_flat(acc, mesh)
        for i, v in zip(b.param_idx, layout.unpack(b, full)):
            ws[i].copy_(v)
    return ws, new_moms, new_masters
