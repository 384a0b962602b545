"""DataParallelExecutorGroup: the executor of a Module, the counterpart
of mxnet_tpu/module/executor_group.py (reference
python/mxnet/module/executor_group.py).

The port binds one context: one executor over the whole batch. Several
contexts (a data mesh in the JAX package) need the port's parallel/
and raise.
"""
from ..base import MXNetError, unported
from ..executor import Executor, _tensor_of


def _name_shape(d):
    return (d[0], d[1]) if isinstance(d, (list, tuple)) else \
        (d.name, d.shape)


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req='write', state_names=None):
        if len(contexts) != 1:
            raise unported('a Module over %d contexts (data-parallel '
                           'mesh)' % len(contexts), '6')
        if workload and len(set(workload)) > 1:
            raise MXNetError('non-uniform work_load_list %s: one context '
                             'takes the whole batch' % (list(workload),))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else []
        self.data_names = [_name_shape(d)[0] for d in self.data_shapes]
        self.label_names = [_name_shape(d)[0] for d in self.label_shapes]
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.batch_size = _name_shape(self.data_shapes[0])[1][0]

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
        shapes = dict(_name_shape(d)
                      for d in self.data_shapes + self.label_shapes)
        shared_exec = shared_group.executor if shared_group is not None \
            else None
        self.executor = Executor._simple_bind(
            symbol, contexts[0], grad_req=req, shared_exec=shared_exec,
            shape_kwargs=shapes)

    def _place_input(self, name, value):
        """Commit a batch array to the executor's device in the bound
        dtype. A batch from a host-side iterator is copied here, in the
        step; one staged by io.prefetch_to_device is already there."""
        dst = self.executor.arg_dict[name]
        if tuple(value.shape) != dst.shape:
            raise MXNetError('input %s shape %s != bound %s'
                             % (name, tuple(value.shape), dst.shape))
        dst._data = _tensor_of(value, dst._data.dtype,
                               self.contexts[0].torch_device)

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
        self.executor.backward(out_grads=out_grads)

    def forward_backward(self, data_batch=None):
        if data_batch is not None:
            self.load_data_batch(data_batch)
        return self.executor.forward_backward()

    def get_outputs(self, merge_multi_context=True):
        return self.executor.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self.executor.grad_dict.get(n) for n in self.data_names]

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            if name in self.executor.arg_dict:
                arg_params[name] = self.executor.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = self.executor.aux_dict[name].copy()

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.executor.copy_params_from(
            {k: v for k, v in arg_params.items()
             if k in self.executor.arg_dict},
            {k: v for k, v in (aux_params or {}).items()
             if k in self.executor.aux_dict})

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes (Executor.reshape: the arrays whose
        shapes did not change, the parameters among them, are shared)."""
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else []
        self.batch_size = _name_shape(self.data_shapes[0])[1][0]
        shapes = dict(_name_shape(d)
                      for d in self.data_shapes + self.label_shapes)
        self.executor = self.executor.reshape(**shapes)

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
        preds = dict(zip(self.symbol.list_outputs(), self.executor.outputs))
        if isinstance(labels, (list, tuple)):
            labels = dict(zip(self.label_names, labels))
        eval_metric.update_dict(labels, preds)

    def install_monitor(self, mon):
        mon.install(self.executor)

