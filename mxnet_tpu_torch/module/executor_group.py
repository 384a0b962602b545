"""DataParallelExecutorGroup: the executor of a Module, the counterpart
of mxnet_tpu/module/executor_group.py (reference
python/mxnet/module/executor_group.py).

One context: one executor over the whole batch. Several contexts are a
'data' mesh. The JAX package is single-controller: it places the batch
sharded over the mesh and XLA partitions one program, which computes the
one-device step on the global batch. The port is multi-controller, as
torch's DistributedDataParallel is: a Module over N contexts is N
processes, every rank running the same script and building the same
Module, each of them one rank of the mesh (parallel/mesh.py). The group
takes the current mesh when it has a 'data' axis, else the 1-D 'data'
mesh over the default process group (torchrun, `parallel.spawn`,
`tools/launch.py`, or `dist.initialize` with MXNET_TPU_DIST_JAX=1), whose
size must be N. One context in a process group of one rank is a mesh of
one rank; one context among several ranks is a Module of its own on each.

The rank's executor is bound on the mesh's device (several ranks may
share a card) at its 1/N rows of the batch: the bound shapes the Module
reports stay global, and a global batch is cut to this rank's rows on
the host before it moves (a batch staged with `io.prefetch_to_device(
mesh=)` arrives cut). Weights and aux states are replicated: set_params
broadcasts data index 0's. Every reduction over the batch is global
(executor.py, ops/nn.py): BatchNorm's statistics, the loss heads'
normalization, and the gradients of the parameters, all-reduced in the
backward (`collectives.GradReduce`) unless ZeRO-1 reduce-scatters them
in the update (`use_grad_reduce(False)`). `get_outputs`,
`get_input_grads` and `update_metric` gather this rank's rows back into
the global batch, so that every rank sees the JAX package's values; an
output that reduces over the batch is replicated (executor.py) and comes
back as it is.
"""
import torch
import torch.distributed as dist

from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context
from ..executor import Executor, _tensor_of
from ..parallel import collectives
from ..parallel import mesh as pmesh

LAUNCH_HINT = (
    '%s over %d contexts runs as %d processes, one rank of a data '
    'mesh each, every rank running the same script: launch it with '
    'torchrun --nproc-per-node %d, mxnet_tpu_torch.parallel.mesh.spawn, '
    'or python -m mxnet_tpu_torch.tools.launch -n %d with '
    'MXNET_TPU_DIST_JAX=1 (then mxnet_tpu_torch.dist.initialize())')


def _name_shape(d):
    return (d[0], d[1]) if isinstance(d, (list, tuple)) else \
        (d.name, d.shape)


def data_mesh_for(contexts, what='a Module'):
    """The data mesh `what` (a Module, a fused Gluon step) over
    `contexts` runs on, or None (one device). Raises when several
    contexts have no process group to run on, or a data axis of another
    size."""
    from ..parallel import worker_group
    n = len(contexts)
    mesh = pmesh.current_mesh()
    if n > 1 and not dist.is_initialized():
        # a rank of a worker of several ranks joins its worker's group
        worker_group.init()
    if mesh is None or 'data' not in mesh.shape:
        mesh = pmesh.world_data_mesh()
    if mesh is None:
        if n > 1:
            raise MXNetError(LAUNCH_HINT % (what, n, n, n, n) +
                             ' (no torch.distributed process group is up '
                             'in this process)')
        return None
    size = mesh.shape['data']
    if n == 1 and size > 1:
        return None
    if size != n:
        raise MXNetError('%s over %d contexts needs a data mesh of %d '
                         'ranks; this one has %d (%s)'
                         % (what, n, n, size, LAUNCH_HINT % (what, n, n, n, n)))
    return mesh


def pipe_mesh_for(contexts, num_stages, what):
    """The {'data', 'pipe'} mesh `what` (a pipelined Module or fused Gluon
    step) over `contexts` runs on: one rank a context of the default
    process group (raises naming the launchers when there is none, or
    one of another size)."""
    from ..parallel import pipeline as pipe_mod
    n = len(contexts)
    if not dist.is_initialized():
        raise MXNetError(LAUNCH_HINT % (what, n, n, n, n) +
                         ' (no torch.distributed process group is up in '
                         'this process)')
    if dist.get_world_size() != n:
        raise MXNetError('%s over %d contexts needs %d ranks; the process '
                         'group has %d (%s)'
                         % (what, n, n, dist.get_world_size(),
                            LAUNCH_HINT % (what, n, n, n, n)))
    return pipe_mod.make_pipe_mesh(n, num_stages)


def _rows(value, lo, hi):
    """Rows lo:hi of a batch array (NDArray, tensor or numpy), sliced
    where it lies."""
    if isinstance(value, nd.NDArray):
        return value._data[lo:hi]
    return value[lo:hi]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req='write', state_names=None):
        if workload and len(set(workload)) > 1:
            raise MXNetError('non-uniform work_load_list %s: every context '
                             'takes the same share of the batch'
                             % (list(workload),))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.mesh = shared_group.mesh if shared_group is not None \
            else data_mesh_for(contexts)
        self.dp = 1 if self.mesh is None else self.mesh.shape['data']
        self.context = contexts[0] if self.mesh is None else \
            Context.from_device(self.mesh.device)
        self._reduce_grads = True
        # sparse embedding tables training rows-only: name -> vocab; under
        # a data mesh each rank's executor holds its stripe of them
        self.sparse_tables = {}
        self._set_shapes(data_shapes, label_shapes)

        input_names = set(self.data_names) | set(self.label_names)
        req = {}
        for name in self.arg_names:
            if name in self.fixed_param_names:
                req[name] = 'null'
            elif name in input_names:
                req[name] = grad_req if (
                    inputs_need_grad and name in self.data_names) else 'null'
            elif not for_training:
                req[name] = 'null'
            else:
                req[name] = grad_req
        self.grad_req = req
        shared_exec = shared_group.executor if shared_group is not None \
            else None
        self.executor = Executor._simple_bind(
            symbol, self.context, grad_req=req, shared_exec=shared_exec,
            shape_kwargs=self._local_shapes())
        self._attach()

    def _set_shapes(self, data_shapes, label_shapes):
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else []
        self.data_names = [_name_shape(d)[0] for d in self.data_shapes]
        self.label_names = [_name_shape(d)[0] for d in self.label_shapes]
        self.batch_size = _name_shape(self.data_shapes[0])[1][0]
        if self.batch_size % self.dp:
            raise MXNetError('batch size %d not divisible by %d data ranks'
                             % (self.batch_size, self.dp))
        self.local_batch = self.batch_size // self.dp

    def _local_shapes(self):
        """The bound shapes: this rank's rows of each input."""
        out = {}
        for d in self.data_shapes + self.label_shapes:
            name, shape = _name_shape(d)
            shape = tuple(shape)
            out[name] = (shape[0] // self.dp,) + shape[1:]
        return out

    def _attach(self):
        """Make the executor a rank of the mesh and give it the in-step
        all-reduce of the parameters' gradients."""
        ex = self.executor
        if self.mesh is None:
            return
        ex.set_data_mesh(self.mesh, self.data_names + self.label_names)
        ex.grad_reduce = None
        if self.dp > 1 and self.for_training and self._reduce_grads:
            # a sparse table's row gradients are reduced in its backward
            params = set(self.param_names) - set(self.sparse_tables)
            pos = [j for j, n in enumerate(ex._diff_names) if n in params]
            names = [ex._diff_names[j] for j in pos]
            if names:
                plan = collectives.GradReducePlan(
                    [ex.arg_dict[n].shape for n in names],
                    [ex.arg_dict[n]._data.dtype for n in names])
                ex.grad_reduce = collectives.GradReduce(plan, self.mesh, pos)

    def set_sparse_tables(self, tables):
        """Train `tables` ({weight name: vocab}) rows-only; under a data
        mesh each rank keeps its stripe of each (parallel/embedding)."""
        from ..parallel import embedding as embed_mod
        ex = self.executor
        for name, vocab in tables.items():
            t = ex.arg_dict[name]._data
            if t.shape[0] == vocab:
                ex.arg_dict[name]._data = embed_mod.stripe_of(t, self.mesh)
        self.sparse_tables = dict(tables)
        ex.set_sparse_tables(bool(tables))
        self._attach()

    def full_param(self, name):
        """The full value of parameter `name`: a striped table assembled
        from every rank (a collective), else the bound tensor."""
        t = self.executor.arg_dict[name]._data
        vocab = self.sparse_tables.get(name)
        if vocab is not None and t.shape[0] != vocab:
            from ..parallel import embedding as embed_mod
            t = embed_mod.unstripe(t, vocab, self.mesh)
        return t

    def use_grad_reduce(self, on):
        """on: the backward all-reduces the parameters' gradients over the
        data axis; off (ZeRO-1): they stay this rank's own, for the
        sharded update to reduce-scatter."""
        self._reduce_grads = bool(on)
        self._attach()

    @property
    def reduce_plan(self):
        red = self.executor.grad_reduce
        return getattr(red, 'plan', None)

    # -- the batch ---------------------------------------------------------
    def local_rows(self, value):
        """This rank's rows of a global batch array (anything else as it
        is)."""
        if self.mesh is None or self.dp == 1 or \
                tuple(value.shape)[0] != self.batch_size:
            return value
        lo = self.mesh.axis_index('data') * self.local_batch
        return _rows(value, lo, lo + self.local_batch)

    def _place_input(self, name, value):
        """Commit a batch array to the executor's device in the bound
        dtype: a global batch cut to this rank's rows on the host first,
        one already cut (io.prefetch_to_device(mesh=)) as it is. A batch
        from a host-side iterator is copied here, in the step; one staged
        on the device is bound without a copy."""
        dst = self.executor.arg_dict[name]
        shape = tuple(value.shape)
        if shape != dst.shape:
            if self.dp > 1 and shape[1:] == dst.shape[1:] and \
                    shape[0] == self.batch_size:
                value = self.local_rows(value)
            else:
                raise MXNetError('input %s shape %s != bound %s'
                                 % (name, shape, self._global(dst.shape)))
        dst._data = _tensor_of(value, dst._data.dtype,
                               self.context.torch_device)

    def _global(self, shape):
        return (shape[0] * self.dp,) + tuple(shape[1:])

    def load_data_batch(self, data_batch):
        for name, value in zip(self.data_names, data_batch.data):
            self._place_input(name, value)
        if self.label_names and data_batch.label:
            for name, value in zip(self.label_names, data_batch.label):
                self._place_input(name, value)

    def forward(self, data_batch=None, is_train=None):
        if data_batch is not None:
            self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        return self.executor.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, 're-bind with for_training=True'
        if out_grads is not None and self.dp > 1:
            # a replicated output's head gradient is whole on every rank
            rep = self.executor.replicated_outputs()
            out_grads = [g if r else self.local_rows(g) for g, r in zip(
                [out_grads] if isinstance(out_grads, nd.NDArray)
                else out_grads, rep)]
        self.executor.backward(out_grads=out_grads)

    def forward_backward(self, data_batch=None):
        if data_batch is not None:
            self.load_data_batch(data_batch)
        return self.executor.forward_backward()

    # -- the global batch back ---------------------------------------------
    def gather_rows(self, arrays, replicated=None):
        """NDArrays (or tensors) of this rank's rows joined into the
        global batch, by data index; arrays without this rank's batch as
        their first dimension, and those `replicated` flags (a value
        every rank holds whole), as they are. A collective: every rank
        calls it."""
        if self.dp == 1:
            return list(arrays)
        out = []
        for j, a in enumerate(arrays):
            t = a._data if isinstance(a, nd.NDArray) else a
            if t is None or t.dim() == 0 or t.shape[0] != self.local_batch \
                    or (replicated is not None and replicated[j]):
                out.append(a)
                continue
            with torch.no_grad():
                full = collectives.allgather(
                    t.detach().to(self.mesh.device), 'data', 0,
                    mesh=self.mesh)
            out.append(nd.NDArray(full, self.context)
                       if isinstance(a, nd.NDArray) else full)
        return out

    def get_outputs(self, merge_multi_context=True):
        outs = self.executor.outputs
        if self.dp == 1:
            return outs
        cached = getattr(self, '_gathered', None)
        if cached is None or cached[0] is not outs:
            cached = (outs, self.gather_rows(
                outs, self.executor.replicated_outputs()))
            self._gathered = cached
        return cached[1]

    def get_input_grads(self, merge_multi_context=True):
        return self.gather_rows(
            [self.executor.grad_dict.get(n) for n in self.data_names])

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            if name in self.sparse_tables:
                arg_params[name] = nd.NDArray(
                    self.full_param(name).clone(), self.context)
            elif name in self.executor.arg_dict:
                arg_params[name] = self.executor.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = self.executor.aux_dict[name].copy()

    def set_params(self, arg_params, aux_params, allow_extra=False):
        striped = {k for k, v in self.sparse_tables.items()
                   if self.dp > 1 and k in arg_params}
        self.executor.copy_params_from(
            {k: v for k, v in arg_params.items()
             if k in self.executor.arg_dict and k not in striped},
            {k: v for k, v in (aux_params or {}).items()
             if k in self.executor.aux_dict})
        self.broadcast_params()
        if striped:
            from ..parallel import embedding as embed_mod
            ex = self.executor
            for k in sorted(striped):
                full, = pmesh.replicate_params(self.mesh, [_tensor_of(
                    arg_params[k], ex.arg_dict[k]._data.dtype,
                    self.mesh.device)])
                ex.arg_dict[k]._data = embed_mod.stripe_of(full, self.mesh)

    def broadcast_params(self):
        """Data index 0's weights and aux states on every rank (one
        broadcast per dtype, the arrays joined): the replicas start
        equal, as DistributedDataParallel makes them."""
        if self.dp == 1:
            return
        ex = self.executor
        # a striped table's stripes differ by rank (set_params replicates
        # it whole before cutting)
        arrays = [ex.arg_dict[n] for n in self.param_names
                  if n in ex.arg_dict and n not in self.sparse_tables] + \
            [ex.aux_dict[n] for n in self.aux_names]
        by_dtype = {}
        for a in arrays:
            by_dtype.setdefault(a._data.dtype, []).append(a)
        for dtype in sorted(by_dtype, key=str):
            group = by_dtype[dtype]
            flat = torch.cat([a._data.reshape(-1) for a in group])
            flat = collectives._broadcast(flat, self.mesh, 'data')
            off = 0
            for a in group:
                n = a._data.numel()
                a._data = flat[off:off + n].view(a._data.shape).clone()
                off += n

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes (Executor.reshape: the arrays whose
        shapes did not change, the parameters among them, are shared)."""
        self._set_shapes(data_shapes, label_shapes)
        self.executor = self.executor.reshape(**self._local_shapes())
        self.executor.set_sparse_tables(bool(self.sparse_tables))
        self._attach()

    @property
    def param_arrays(self):
        return [self.executor.arg_dict[n] for n in self.param_names]

    @property
    def grad_arrays(self):
        return [self.executor.grad_dict.get(n) for n in self.param_names]

    @property
    def aux_arrays(self):
        return [self.executor.aux_dict[n] for n in self.aux_names]

    def update_metric(self, eval_metric, labels):
        """The metric over the global batch: the gathered outputs
        against the labels (a rank's rows of them gathered too)."""
        preds = dict(zip(self.symbol.list_outputs(), self.get_outputs()))
        if isinstance(labels, (list, tuple)):
            labels = dict(zip(self.label_names, self.gather_rows(labels)))
        eval_metric.update_dict(labels, preds)

    def install_monitor(self, mon):
        mon.install(self.executor)
