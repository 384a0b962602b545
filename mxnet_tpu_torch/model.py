"""Model helpers: the counterpart of mxnet_tpu/model.py (reference
python/mxnet/model.py): the kvstore decision, the per-key update loop,
checkpoints and the legacy FeedForward.

Checkpoints are `prefix-symbol.json` (the symbol's JSON) and
`prefix-%04d.params` (`nd.save` of 'arg:' and 'aux:' entries), both
byte-compatible with the JAX package's. One device with no store or a
non-dist store name runs without one, as the JAX package decides.
"""
import logging
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

BatchEndParam = namedtuple('BatchEndParams',
                           ['epoch', 'nbatch', 'eval_metric', 'locals'])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) (reference model.py:57): no store
    for None, or for one device with a store name that is not dist; a
    KVStore object as it is; else `kvstore.create(name)`, with the
    reference's >16M-element heuristic turning update_on_kvstore off
    for a 'local' store."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, kvs.KVStore):
        return kvstore, True
    if not isinstance(kvstore, str):
        raise TypeError('kvstore must be KVStore, str or None')
    if num_device == 1 and 'dist' not in kvstore:
        return None, False
    kv = kvs.create(kvstore)
    update_on_kvstore = True
    if kvstore == 'local' and arg_params:
        biggest = max(p.size for p in arg_params.values())
        update_on_kvstore = biggest <= 1024 * 1024 * 16
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init every parameter on the store, and pull it back onto the
    devices when the store updates (reference model.py:96)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push the gradients, pull the weights (reference model.py:106), as
    one `push_pull_all`, so that a dist store batches the step's round."""
    names, grads, args = [], [], []
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list is None or (isinstance(grad_list, list) and
                                 grad_list[0] is None):
            continue
        names.append(param_names[index])
        grads.append(grad_list)
        args.append(arg_list)
    kvstore.push_pull_all(names, grads, args)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum the gradients through the store where there is one (push and
    pull back into the gradients), then run the per-key updater
    (reference model.py:118)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list is None or (isinstance(grad_list, list) and
                                 grad_list[0] is None):
            continue
        index_name = param_names[index] if param_names is not None \
            else index
        if kvstore:
            kvstore.push(index_name, grad_list, priority=-index)
            kvstore.pull(index_name, grad_list, priority=-index)
        if isinstance(arg_list, list):
            for k, (w, g) in enumerate(zip(arg_list, grad_list)):
                updater(index * num_device + k, g, w)
        else:
            updater(index, grad_list, arg_list)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json and prefix-%04d.params."""
    if symbol is not None:
        symbol.save('%s-symbol.json' % prefix)
    save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
    save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
    param_name = '%s-%04d.params' % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; the arrays on
    `ctx` (default: the current context)."""
    param_file = '%s-%04d.params' % (prefix, epoch)
    loaded = nd.load(param_file, ctx=ctx)
    split = {'arg': {}, 'aux': {}}
    for key, value in loaded.items():
        kind, _, name = key.partition(':')
        if kind not in split:
            raise MXNetError('invalid checkpoint key %r in %s '
                             '(expected arg:/aux: prefix)'
                             % (key, param_file))
        split[kind][name] = value
    return (sym.load('%s-symbol.json' % prefix),
            split['arg'], split['aux'])


class FeedForward:
    """The legacy model API, a thin layer over mx.mod.Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer='sgd', initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _label_name(self):
        labels = [n for n in self.symbol.list_arguments()
                  if n.endswith('label')]
        return labels[0] if labels else 'softmax_label'

    def _as_iter(self, X, y=None, batch_size=None, shuffle=False):
        from . import io as mxio
        if isinstance(X, mxio.DataIter):
            return X
        import numpy as np
        return mxio.NDArrayIter(np.asarray(X),
                                np.asarray(y) if y is not None else None,
                                batch_size=batch_size or
                                self.numpy_batch_size,
                                shuffle=shuffle,
                                label_name=self._label_name())

    def _make_module(self, data_iter):
        from . import module as mod
        label_names = [d.name if hasattr(d, 'name') else d[0]
                       for d in (data_iter.provide_label or [])] or None
        self._module = mod.Module(self.symbol, label_names=label_names,
                                  context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None,
            kvstore='local', logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        data = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and isinstance(eval_data, tuple):
            eval_data = self._as_iter(*eval_data)
        module = self._make_module(data)
        module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                   epoch_end_callback=epoch_end_callback,
                   batch_end_callback=batch_end_callback, kvstore=kvstore,
                   optimizer=self.optimizer,
                   optimizer_params=self.kwargs,
                   initializer=self.initializer,
                   arg_params=self.arg_params, aux_params=self.aux_params,
                   allow_missing=True, begin_epoch=self.begin_epoch,
                   num_epoch=self.num_epoch, monitor=monitor,
                   eval_end_callback=eval_end_callback,
                   eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = module.get_params()
        return self

    def _bound_module(self, data):
        if self._module is None or not self._module.binded:
            module = self._make_module(data)
            module.bind(data_shapes=data.provide_data,
                        label_shapes=data.provide_label,
                        for_training=False)
            # an unlabeled iterator leaves the label unbound: it stays
            # zero, which loss ops ignore at inference
            module.set_params(self.arg_params, self.aux_params or {},
                              allow_missing=True,
                              allow_extra=self.allow_extra_params)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        if return_data:
            raise NotImplementedError(
                'return_data=True is not supported; iterate the data '
                'iterator alongside predict() instead')
        data = self._as_iter(X)
        if reset:
            data.reset()
        outs = self._bound_module(data).predict(data, num_batch=num_batch)
        outs = outs if isinstance(outs, list) else [outs]
        arrs = [o.asnumpy() for o in outs]
        return arrs[0] if len(arrs) == 1 else arrs

    def score(self, X, eval_metric='acc', num_batch=None, **kwargs):
        data = self._as_iter(X)
        res = self._bound_module(data).score(data, eval_metric,
                                             num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer='sgd', initializer=None,
               eval_data=None, eval_metric='acc', epoch_end_callback=None,
               batch_end_callback=None, kvstore='local', logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Build and train in one call."""
        from . import initializer as init_mod
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer or
                            init_mod.Uniform(0.01), **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
