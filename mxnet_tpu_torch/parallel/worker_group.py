"""A worker of several ranks: the port's form of the JAX package's hybrid
worker (one process over several devices, a data mesh inside it, the
workers synced through the parameter servers or the dist runtime's host
all-reduce).

A process of the port is one rank (module/executor_group.py), so a
worker is a group of ranks: `tools.launch --ranks-per-worker R` starts R
processes for each worker. Each of them has the worker's DMLC_WORKER_ID,
its rank in the group (MXNET_TPU_WORKER_RANK, of MXNET_TPU_WORKER_RANKS)
and the group's own rendezvous, torchrun's variables (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE). `init()` makes
the group the default torch.distributed group, so the data mesh of a
Module over the worker's contexts spans the group's ranks only, never
the whole job. Across workers only the group's rank 0, the leader, talks
to the servers or the dist runtime, once a key and step, and hands what
it got to the others over the group (`broadcast_host`), so every rank of
every worker ends each step with the same bits. The servers and the
runtime count workers, not ranks.

`kvstore.create('dist_*')`, `dist.initialize()` and a Module over
several contexts call `init()`; without MXNET_TPU_WORKER_RANKS above 1
it does nothing.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh

_GROUP = {'info': None}


class WorkerGroup:
    """This process's place in its worker: `rank` in the group of `size`
    ranks; `host_group` carries host arrays (gloo)."""

    def __init__(self, rank, size, host_group):
        self.rank, self.size, self.host_group = rank, size, host_group

    @property
    def leader(self):
        return self.rank == 0


def _env_int(name, default=None):
    value = os.environ.get(name)
    return default if value in (None, '') else int(value)


def configured():
    """Whether the launcher made this process a rank of a worker of
    several ranks."""
    return _env_int('MXNET_TPU_WORKER_RANKS', 1) > 1


def init(device=None):
    """Join this worker's group (idempotent): the default process group
    over the worker's ranks, from the launcher's variables, on `device`
    (MXNET_TPU_DIST_DEVICE, else the rank's card). Returns the
    WorkerGroup, or None outside such a worker."""
    if _GROUP['info'] is not None:
        return _GROUP['info']
    if not configured():
        return None
    size = _env_int('MXNET_TPU_WORKER_RANKS')
    rank = _env_int('MXNET_TPU_WORKER_RANK')
    if not dist.is_initialized():
        pmesh.init_process_group(
            device=device or os.environ.get('MXNET_TPU_DIST_DEVICE') or None,
            rank=rank, world_size=size)
    if dist.get_world_size() != size or dist.get_rank() != rank:
        raise RuntimeError(
            'this process is rank %d of a worker of %d ranks, but the '
            'default process group has it as rank %d of %d'
            % (rank, size, dist.get_rank(), dist.get_world_size()))
    host = dist.group.WORLD if dist.get_backend() == 'gloo' else \
        dist.new_group(backend='gloo')
    _GROUP['info'] = WorkerGroup(rank, size, host)
    return _GROUP['info']


def current():
    """The WorkerGroup this process joined, or None."""
    return _GROUP['info']


def reset():
    """Forget the group (mesh.destroy_process_group)."""
    _GROUP['info'] = None


def _as_tensor(a):
    if torch.is_tensor(a):
        return a.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(a))


def broadcast_host(arrays):
    """The leader's list of host arrays (numpy, or torch CPU tensors for
    bfloat16) on every rank of the group; the others pass None. Their
    shapes and dtypes go first, then one broadcast for each dtype, the
    arrays joined."""
    grp = _GROUP['info']
    if grp is None or grp.size == 1:
        return list(arrays)
    tensors = [_as_tensor(a) for a in arrays] if grp.leader else None
    box = [[(tuple(t.shape), t.dtype, torch.is_tensor(a))
            for t, a in zip(tensors, arrays)] if grp.leader else None]
    dist.broadcast_object_list(box, src=0, group=grp.host_group)
    meta = box[0]
    by_dtype = {}
    for i, (_, dtype, _) in enumerate(meta):
        by_dtype.setdefault(dtype, []).append(i)
    out = [None] * len(meta)
    for dtype in sorted(by_dtype, key=str):
        idx = by_dtype[dtype]
        sizes = [int(np.prod(meta[i][0], dtype=np.int64)) for i in idx]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]) \
            if grp.leader else torch.empty(sum(sizes), dtype=dtype)
        dist.broadcast(flat, src=0, group=grp.host_group)
        off = 0
        for i, n in zip(idx, sizes):
            out[i] = flat[off:off + n].view(meta[i][0]).clone()
            off += n
    return [o if meta[i][2] else o.numpy() for i, o in enumerate(out)]


def barrier():
    """Every rank of the group at this point."""
    grp = _GROUP['info']
    if grp is not None and grp.size > 1:
        dist.barrier(group=grp.host_group)
