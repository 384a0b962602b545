"""Gluon Trainer, the counterpart of mxnet_tpu/gluon/trainer.py
(reference python/mxnet/gluon/trainer.py:26): an Optimizer applied to a
set of Parameters through the per-key `Updater`, one per context.

On one context the Trainer creates no store, as the JAX package's does
(trainer.py:85-91); a kvstore over several contexts needs the port's
KVStore (Queue A 5), and `step_fused`, the whole-step program of
`gluon.fuse_step`, needs gluon/fused.py (Queue A 6): both raise.
`save_states` and `load_states` write and read the Updater's states,
the JAX package's format.
"""
from .. import optimizer as opt
from ..base import atomic_file, unported
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
            raise unported('the Trainer\'s kvstore over %d contexts'
                           % len(self._contexts), '5')
        self._kv_initialized = True

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
        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            for upd, d, g in zip(self._updaters, param.list_data(),
                                 param.list_grad()):
                upd(i, g, d)

    def step_fused(self, batch_size, *args):
        raise unported('Trainer.step_fused (gluon/fused.py)', '6')

    def save_states(self, fname):
        """Checkpoint the optimizer states (the Updater's format)."""
        assert self._optimizer is not None
        with atomic_file(fname) as f:
            f.write(self._updaters[0].get_states())

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, 'rb') as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
