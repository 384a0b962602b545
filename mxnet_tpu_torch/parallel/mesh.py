"""Device mesh over torch.distributed: the counterpart of
mxnet_tpu/parallel/mesh.py.

The JAX package is single-controller: one process holds a
`jax.sharding.Mesh` over every device and `shard_map` runs the step's
body on each. The port is multi-controller, PyTorch's idiom: every rank
is a process in the default `torch.distributed` group, the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dimensions over
those ranks, and the step is the `shard_map` body run on this rank's
shards. Collectives over an axis (`collectives.py`) use that axis's
group of the DeviceMesh.

Process setup (`init_process_group`) reads the variables torchrun sets
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR /
MASTER_PORT), or takes them with a `file://` or `tcp://` init method.
The backend is NCCL when every rank has a GPU of its own and gloo on
the CPU or when several ranks share one card (NCCL refuses two ranks on
one GPU); a gloo group carries CUDA tensors through pinned host memory
(collectives.py). A rank's device is `cuda:LOCAL_RANK % device_count`
unless the caller passes one, and without CUDA the entry points raise
unless they are given `device='cpu'`.

A rank leaves through `destroy_process_group`, which init_process_group
also registers to run at the interpreter's exit. It drops every mesh's
DeviceMesh, whose registry holds the gloo groups, so that their worker
threads are joined while the interpreter is whole: a gloo thread that
outlives it, and drops the last reference to a tensor that Python made,
takes the GIL during finalization and aborts the process ("terminate
called without an active exception").
"""
import atexit
import gc
import os
import socket
import threading
import weakref

import numpy as np
import torch
import torch.distributed as dist

_state = threading.local()
# this process's rank device, set by init_process_group; whether the
# exit teardown is registered
_PROC = {'device': None, 'atexit': False}
# every Mesh made in this process: destroy_process_group releases their
# process groups
_MESHES = weakref.WeakSet()


class P(tuple):
    """A partition spec: one entry per dimension of a tensor, each an
    axis name, a tuple of axis names, or None (not sharded); the port's
    counterpart of `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return 'P(%s)' % ', '.join(map(repr, self))


def _env_int(name, default=None):
    value = os.environ.get(name)
    return default if value in (None, '') else int(value)


def default_device(device=None):
    """The rank's device: `device` when given, else the one
    init_process_group chose, else `cuda:LOCAL_RANK % device_count`;
    RuntimeError without CUDA (pass device='cpu' to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if _PROC['device'] is not None:
        return _PROC['device']
    if not torch.cuda.is_available():
        raise RuntimeError(
            'mxnet_tpu_torch.parallel runs each rank on '
            'cuda:LOCAL_RANK % device_count unless a device is given, and '
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            'on the CPU')
    return torch.device('cuda', _env_int('LOCAL_RANK', 0) %
                        torch.cuda.device_count())


def choose_backend(device, local_world_size):
    """gloo on the CPU and when the host's ranks outnumber its cards
    (NCCL takes one GPU per rank); NCCL otherwise."""
    if torch.device(device).type != 'cuda':
        return 'gloo'
    if local_world_size > torch.cuda.device_count():
        return 'gloo'
    return 'nccl'


def init_process_group(device=None, init_method=None, rank=None,
                       world_size=None, local_world_size=None):
    """Join the default process group and return this rank's device.
    rank, world_size and local_world_size default to RANK, WORLD_SIZE and
    LOCAL_WORLD_SIZE (torchrun's; the local world defaults to the whole
    world); init_method to 'env://' (MASTER_ADDR / MASTER_PORT). A
    gloo group whose ranks are all on this host talks over the loopback
    interface (GLOO_SOCKET_IFNAME=lo unless it is set)."""
    rank = _env_int('RANK') if rank is None else int(rank)
    world_size = _env_int('WORLD_SIZE') if world_size is None \
        else int(world_size)
    if rank is None or world_size is None:
        raise ValueError('init_process_group needs rank and world_size, '
                         'or RANK and WORLD_SIZE in the environment')
    if local_world_size is None:
        local_world_size = _env_int('LOCAL_WORLD_SIZE', world_size)
    if init_method is None:
        if not os.environ.get('MASTER_ADDR'):
            raise ValueError('init_process_group needs an init_method '
                             "('file://...', 'tcp://host:port') or "
                             'MASTER_ADDR / MASTER_PORT')
        init_method = 'env://'
    device = default_device(device)
    backend = choose_backend(device, local_world_size)
    if backend == 'gloo' and local_world_size == world_size:
        os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _PROC['device'] = device
    if not _PROC['atexit']:
        atexit.register(destroy_process_group)
        _PROC['atexit'] = True
    return device


def destroy_process_group():
    """Leave the default group (the counterpart of init_process_group;
    idempotent). Every mesh made in this process lets go of its
    DeviceMesh, and the process groups they held are destroyed here,
    their worker threads joined (the module docstring)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    for mesh in list(_MESHES):
        mesh.device_mesh = None
    from . import worker_group
    worker_group.reset()
    _PROC['device'] = None
    _WORLD_MESH.clear()
    # a mesh in a reference cycle (a fused step and its trainer) goes
    # now, not at the interpreter's exit
    gc.collect()


def _spawned_rank(rank, fn, world_size, init_file, device, args):
    os.environ['LOCAL_RANK'] = str(rank)
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) //
                                     world_size)))
    init_process_group(device=device, init_method='file://' + init_file,
                       rank=rank, world_size=world_size)
    try:
        fn(rank, *args)
    finally:
        destroy_process_group()


def spawn(fn, world_size, init_file, args=(), device=None):
    """Run fn(rank, *args) in world_size new processes on this host, each
    in the default group (a `file://` rendezvous at init_file, which must
    not exist yet), on `device` or cuda:rank % device_count. fn must be
    importable by name (a module's top-level function). A rank whose fn
    returned leaves its group and exits through the interpreter. Raises
    when a rank fails."""
    import torch.multiprocessing as mp
    mp.spawn(_spawned_rank, args=(fn, world_size, str(init_file), device,
                                  tuple(args)),
             nprocs=world_size, join=True)


class Mesh:
    """Named axes over the ranks of the default group (rank r of the
    mesh is global rank r, row-major over the axes). `group(axis)` is the
    process group of the ranks that differ from this one only along
    `axis`; `coordinate` this rank's index along each axis (None off the
    mesh); `device` its device; `staged` whether its collectives carry
    CUDA tensors through host memory (gloo)."""

    def __init__(self, shape, device=None):
        from torch.distributed.device_mesh import DeviceMesh
        self.axis_names = tuple(shape)
        self.shape = {a: int(s) for a, s in shape.items()}
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.device = default_device(device)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        layout = torch.arange(self.size).reshape(
            tuple(self.shape.values()))
        self.device_mesh = DeviceMesh(
            'cuda' if self.device.type == 'cuda' else 'cpu', layout,
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coordinate = None if coord is None else dict(
            zip(self.axis_names, (int(c) for c in coord)))
        self.staged = self.backend == 'gloo' and self.device.type == 'cuda'
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, '%s/%s' % (socket.gethostname(),
                                                 self.device))
        self.devices = tuple(names[:self.size])
        _MESHES.add(self)

    def _check_axis(self, axis):
        if axis not in self.shape:
            raise ValueError('mesh has no axis %r (axes %s)'
                             % (axis, self.axis_names))
        if self.coordinate is None:
            raise ValueError('rank %d is not on this mesh of %d ranks'
                             % (self.rank, self.size))

    def group(self, axis):
        self._check_axis(axis)
        if self.device_mesh is None:
            raise RuntimeError('this mesh\'s process group was destroyed '
                               '(destroy_process_group)')
        return self.device_mesh.get_group(axis)

    def axis_size(self, axis):
        self._check_axis(axis)
        return self.shape[axis]

    def axis_index(self, axis):
        self._check_axis(axis)
        return self.coordinate[axis]

    def axis_ranks(self, axis):
        """Global ranks along `axis` through this rank, by axis index."""
        self._check_axis(axis)
        return dist.get_process_group_ranks(self.group(axis))

    def __repr__(self):
        return 'Mesh(%s, device=%s, backend=%s)' % (
            self.shape, self.device, self.backend)


def make_mesh(shape=None, axis_names=None, device=None):
    """A Mesh over the initialized default group. shape: dict axis->size
    (e.g. {'data': 2, 'sp': 2, 'model': 2}), or None for a 1-D 'data'
    mesh (or `axis_names[0]`) over every rank. Every rank of the group
    makes it, in the same order as its other meshes."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh runs over the default process group; '
                           'call mesh.init_process_group first')
    world = dist.get_world_size()
    if shape is None:
        axis_names = tuple(axis_names or ('data',))
        if len(axis_names) != 1:
            raise ValueError('shape required for multi-axis mesh')
        shape = {axis_names[0]: world}
    n = int(np.prod(list(shape.values()), dtype=np.int64))
    if n > world:
        raise ValueError('mesh needs %d devices, have %d' % (n, world))
    return Mesh(dict(shape), device)


def current_mesh():
    return getattr(_state, 'mesh', None)


def set_current_mesh(mesh):
    _state.mesh = mesh


class use_mesh:
    """Scoped current mesh (per thread): the mesh that
    `transformer.attention`, `collectives.expert_shard` and the
    collectives called without `mesh=` use."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = current_mesh()
        set_current_mesh(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        set_current_mesh(self._prev)


def current_data_mesh():
    """The data mesh of the executor whose graph this thread is walking,
    when its 'data' axis has more than one rank, else None: the ops that
    reduce over the batch (BatchNorm, the loss heads' normalization,
    Dropout's mask) read it."""
    return getattr(_state, 'data_mesh', None)


class data_mesh_scope:
    """Scoped current data mesh (per thread; None or a data axis of one
    rank leaves the ops one-device)."""

    def __init__(self, mesh):
        if mesh is not None and mesh.shape.get('data', 1) <= 1:
            mesh = None
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = current_data_mesh()
        _state.data_mesh = self._mesh
        return self._mesh

    def __exit__(self, *exc):
        _state.data_mesh = self._prev


_WORLD_MESH = {}


def shared_mesh(shape, device=None):
    """make_mesh(shape, device=device) made once per default group (a
    collective: every rank asks for it at the same point); the meshes
    are dropped with the group (destroy_process_group)."""
    key = (id(dist.group.WORLD), dist.get_world_size(),
           tuple(shape.items()), None if device is None else str(device))
    mesh = _WORLD_MESH.get(key)
    if mesh is None:
        mesh = _WORLD_MESH[key] = make_mesh(shape, device=device)
    return mesh


def world_data_mesh():
    """The 1-D 'data' mesh over every rank of the default group, made
    once per group (make_mesh is a collective: every rank asks for it at
    the same point), or None when no group is up."""
    if not dist.is_initialized():
        return None
    key = (id(dist.group.WORLD), dist.get_world_size())
    mesh = _WORLD_MESH.get(key)
    if mesh is None:
        mesh = _WORLD_MESH[key] = make_mesh()
    return mesh


def data_sharding(mesh, ndim=None, axis='data'):
    """Batch-dim sharding: first axis over the data axis."""
    return P(axis)


def replicated(mesh):
    return P()


def flat_sharding(mesh, axis='data'):
    """1-D sharding over `axis` (the ZeRO-1 flat buffers' placement):
    data_sharding's spec, named for the flat-buffer reading."""
    return data_sharding(mesh, axis=axis)


def shard_batch(mesh, tensor, axis='data', dim=0):
    """This rank's block of `tensor` along dimension `dim` (the batch
    dim; dim=1 for K-stacked bulk batches), on the mesh's device. The
    block's gradient is all-gathered back (collectives.shard)."""
    from . import collectives
    return collectives.shard(tensor.to(mesh.device), axis, dim, mesh=mesh)


def replicate_params(mesh, arrays):
    """Every mesh rank gets the mesh root's (coordinate all 0) values:
    broadcast from index 0 along each axis in turn, on the mesh's
    device."""
    from . import collectives
    out = []
    for a in arrays:
        t = torch.as_tensor(a).to(mesh.device).clone()
        for axis in mesh.axis_names:
            if mesh.shape[axis] > 1:
                t = collectives._broadcast(t, mesh, axis)
        out.append(t)
    return out


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh for cache keys (None when no mesh):
    its axis names and sizes and each rank's host and device."""
    if mesh is None:
        return None
    return (mesh.axis_names, tuple(mesh.shape.values()), mesh.devices)
