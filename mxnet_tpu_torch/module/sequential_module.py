"""SequentialModule, a chain of modules whose outputs feed the next
one's inputs: the counterpart of mxnet_tpu/module/sequential_module.py
(reference python/mxnet/module/sequential_module.py)."""
import logging

from ..initializer import Uniform
from .base_module import BaseModule


class SequentialModule(BaseModule):
    META_TAKE_LABELS = 'take_labels'
    META_AUTO_WIRING = 'auto_wiring'

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules, self._metas = [], []
        self._probe_inited = set()
        self._data_shapes = self._label_shapes = None
        self._meta_keys = {getattr(SequentialModule, attr)
                           for attr in dir(SequentialModule)
                           if attr.startswith('META_')}

    def add(self, module, **kwargs):
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, ('Unknown meta "%s", a typo?'
                                            % key)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if len(self._modules) > 0:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if len(self._modules) > 0:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        merged = ({}, {})
        for module in self._modules:
            for acc, part in zip(merged, module.get_params()):
                acc.update(part)
        return merged

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        for i_layer, module in enumerate(self._modules):
            # every sub-module sees the FULL dicts, so the other
            # layers' params are expected "extras" at this level —
            # the sequential-level allow_extra check runs below
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, allow_extra=True,
                               force_init=(force_init or
                                           i_layer in self._probe_inited))
        self._probe_inited.clear()

        # No parameter name may be produced by two different layers
        # (checked separately for args and auxes).
        owners = {'arg': {}, 'aux': {}}
        for i_layer, module in enumerate(self._modules):
            for kind, part in zip(('arg', 'aux'), module.get_params()):
                seen = owners[kind]
                for name in part:
                    if name in seen:
                        prev = seen[name]
                        raise AssertionError(
                            'Duplicated parameter names: name "%s" in layer '
                            '%d (%s) is already used in layer %d (%s).'
                            % (name, i_layer, type(module), prev,
                               type(self._modules[prev])))
                    seen[name] = i_layer
        if not allow_extra:
            known = set(owners['arg']) | set(owners['aux'])
            extra = [n for n in list(arg_params or ()) +
                     list(aux_params or ()) if n not in known]
            if extra:
                raise ValueError(
                    'init_params got parameters no layer knows (pass '
                    'allow_extra=True to ignore them): %s'
                    % sorted(extra))
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        if self.binded and not force_rebind:
            self.logger.warning('Already binded, ignoring bind()')
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, 'Shared module is not supported'
        assert self._modules, 'Attempting to bind an empty SequentialModule'
        self.binded = True
        self._label_shapes = label_shapes

        # Thread data shapes through the chain: each layer binds on the
        # previous layer's (dummy-forward-probed) output shapes.
        feed_shapes = data_shapes
        label_consumed = False
        for i_layer, (meta, module) in enumerate(
                zip(self._metas, self._modules)):
            takes_labels = bool(meta.get(self.META_TAKE_LABELS))
            label_consumed = label_consumed or takes_labels
            wants_grad = bool(inputs_need_grad or
                              (for_training and i_layer > 0))
            if meta.get(self.META_AUTO_WIRING, False):
                names = module.data_names
                assert len(names) == len(feed_shapes)
                # entries may be plain (name, shape) pairs or full
                # DataDesc 4-tuples (NDArrayIter.provide_data)
                feed_shapes = [(n, d[1]) for n, d
                               in zip(names, feed_shapes)]
            module.bind(data_shapes=feed_shapes,
                        label_shapes=label_shapes if takes_labels else None,
                        for_training=for_training,
                        inputs_need_grad=wants_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            # the probe forward needs SOME parameter values; modules
            # probe-initialized here are remembered so init_params can
            # force the caller's initializer over the probe values —
            # resetting params_initialized from outside would not reach
            # the inner modules of composite BaseModule subclasses
            if not module.params_initialized:
                module.init_params()
                self._probe_inited.add(i_layer)
            module.forward(_DummyBatch(feed_shapes), is_train=False)
            feed_shapes = [(name, out.shape) for name, out in
                           zip(module.output_names, module.get_outputs())]
        if not label_consumed:
            self._label_shapes = None

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring.')
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        data_batch = _copy_batch(data_batch)
        for i_layer, module in enumerate(self._modules):
            module.forward(data_batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            data_batch.data = module.get_outputs()
            if hasattr(data_batch, 'provide_data'):
                data_batch.provide_data = [
                    (name, x.shape) for name, x in
                    zip(module.output_names, module.get_outputs())]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)


class _DummyBatch:
    """Zeros of the given shapes on the host, for the probe forward."""

    def __init__(self, data_shapes):
        from .. import ndarray as nd
        from ..context import cpu
        self.data = [nd.zeros(shape, cpu())
                     for _, shape in
                     [(d[0], d[1]) if isinstance(d, (list, tuple))
                      else (d.name, d.shape) for d in data_shapes]]
        self.label = None
        self.pad = 0


def _copy_batch(batch):
    import copy
    new_batch = copy.copy(batch)
    new_batch.data = list(batch.data)
    return new_batch
