"""Gluon Trainer, the counterpart of mxnet_tpu/gluon/trainer.py
(reference python/mxnet/gluon/trainer.py:26): an Optimizer applied to a
set of Parameters through the per-key `Updater`, one per context.

On one context the Trainer creates no store, as the JAX package's does
(trainer.py:85-91); over several contexts (cpu(0)..cpu(n), gpu(0)) it
keeps a KVStore as the distribution facade and sums each step's
gradients over the contexts in one stacked reduction per dtype
(`_batched_reduce_grads`), written back to every context's gradient.
`step_fused` runs the whole step of `gluon.fuse_step` (gluon/fused.py),
whose FusedSGD holds the fused path's optimizer state: switching between
`step` and the fused step carries the momenta and masters across, and
`save_states` / `load_states` write and read whichever path ran last in
the one format both take (the JAX package's).
"""
import torch

from .. import kvstore as kvs
from .. import optimizer as opt
from .. import profiler
from ..base import atomic_file
from .parameter import ParameterDict, Parameter


class Trainer(object):
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device'):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                'First argument must be a list or dict of Parameters, '
                'got %s.' % type(params))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    'First argument must be a list or dict of Parameters, '
                    'got list of %s.' % type(param))
            if param.grad_req != 'null':
                self._params.append(param)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get('rescale_grad', 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        # the fused step (gluon/fused.py) registers itself here; its
        # FusedSGD holds the fused path's optimizer state
        self._fused_step = None
        self._fused_updater = None
        self._pending_fused_states = None
        self._last_update_mode = None   # 'fused' | 'unfused' | None

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            assert contexts is None or contexts == ctx, \
                'All Parameters must be initialized on the same set of ' \
                'contexts, but Parameter %s is initialized on %s while ' \
                'previous Parameters are initialized on %s.' % (
                    param.name, str(ctx), str(contexts))
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                'optimizer_params must be None if optimizer is an ' \
                'Optimizer instance'
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        lr_mult = {i: p.lr_mult for i, p in enumerate(self._params)}
        wd_mult = {i: p.wd_mult for i, p in enumerate(self._params)}
        self._optimizer.set_lr_mult(lr_mult)
        self._optimizer.set_wd_mult(wd_mult)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        if self._kv_type and len(self._contexts) > 1:
            # the store is the distribution facade (rank, size,
            # barrier); the gradients' sum is _batched_reduce_grads
            self._kvstore = kvs.create(self._kv_type)
        self._kv_initialized = True

    def _batched_reduce_grads(self):
        """Sum every parameter's gradients over the contexts in one
        stacked reduction per dtype (each context's gradients flattened
        and joined on the first context's device, stacked, summed), and
        write the sum back to every context's gradient (its own copy on
        each)."""
        work = [p for p in self._params
                if p.grad_req != 'null' and len(p.list_grad()) > 1]
        if not work:
            return
        groups = {}
        for p in work:
            groups.setdefault(p.list_grad()[0]._data.dtype, []).append(p)
        with profiler.scope('trainer_batched_reduce', 'kvstore'):
            for params in groups.values():
                glists = [p.list_grad() for p in params]
                ndev = len(glists[0])
                dev0 = glists[0][0]._data.device
                flats = [torch.cat([gl[d]._data.to(dev0).reshape(-1)
                                    for gl in glists])
                         for d in range(ndev)]
                total = torch.stack(flats).sum(0)
                for d in range(ndev):
                    tot_d = total if d == 0 else total.to(
                        glists[0][d]._data.device, copy=True)
                    off = 0
                    for gl in glists:
                        n = gl[0].size
                        gl[d]._data = tot_d[off:off + n].reshape(
                            gl[0].shape)
                        off += n

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step on the recorded gradients, scaled by
        1/batch_size (reference trainer.py step:116)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._last_update_mode == 'fused' and \
                self._fused_updater is not None:
            # the fused path trained last: its momenta and update counts
            # carry over, one state history for both paths
            states = self._fused_updater.get_states()
            for updater in self._updaters:
                updater.set_states(states)
        if self._kvstore is not None:
            self._batched_reduce_grads()
        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            for upd, d, g in zip(self._updaters, param.list_data(),
                                 param.list_grad()):
                upd(i, g, d)
        self._last_update_mode = 'unfused'

    def step_fused(self, batch_size, *args):
        """One fused step (forward, loss, backward, reduce, update) of the
        FusedStep `gluon.fuse_step(net, loss, trainer)` attached; args
        are its inputs then the label. Returns the per-sample loss."""
        if self._fused_step is None:
            raise ValueError(
                'step_fused: no fused step attached to this Trainer; '
                'build one with gluon.fuse_step(net, loss, trainer)')
        return self._fused_step(*args, batch_size=batch_size)

    def save_states(self, fname):
        """Checkpoint the optimizer states of the path that ran last (the
        fused updater before any step once it exists), in the format
        both paths read."""
        assert self._optimizer is not None
        if self._last_update_mode == 'fused' or (
                self._last_update_mode is None and
                self._fused_updater is not None):
            updater = self._fused_updater
        else:
            updater = self._updaters[0]
        with atomic_file(fname) as f:
            f.write(updater.get_states())

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, 'rb') as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
        if self._fused_updater is not None:
            self._fused_updater.set_states(states)
        else:
            # the fused updater takes them when fuse_step builds it
            self._pending_fused_states = states
        self._last_update_mode = None
