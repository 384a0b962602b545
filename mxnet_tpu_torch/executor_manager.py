"""Legacy pre-Module multi-device executor manager: the counterpart of
mxnet_tpu/executor_manager.py (reference
python/mxnet/executor_manager.py).

The reference's DataParallelExecutorManager slices each batch across
devices and runs one executor per device. Here it is a facade over
DataParallelExecutorGroup (module/executor_group.py) for scripts written
against the pre-Module API: several contexts are ranks of a data mesh,
one process each, and in one process they raise naming the launchers,
as the Module does.
"""
import logging

from .module.executor_group import DataParallelExecutorGroup


def _split_input_slice(batch_size, work_load_list):
    """Slice ranges proportional to work_load_list
    (reference executor_manager.py _split_input_slice)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Reject duplicated argument names (reference _check_arguments)."""
    names = symbol.list_arguments()
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ValueError('Find duplicated argument name(s): %s' % dup)
    aux = symbol.list_auxiliary_states()
    if len(set(aux)) != len(aux):
        raise ValueError('Find duplicated auxiliary state names')
    return names


class DataParallelExecutorManager(object):
    """Compatibility facade (reference DataParallelExecutorManager)."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        self.logger = logger or logging
        _check_arguments(symbol)
        data_shapes = train_data.provide_data
        label_shapes = train_data.provide_label
        input_names = [d[0] if isinstance(d, (list, tuple)) else d.name
                       for d in data_shapes + (label_shapes or [])]
        params = [n for n in symbol.list_arguments()
                  if n not in input_names]
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.ctx, work_load_list or [1] * len(self.ctx),
            data_shapes, label_shapes, params,
            for_training=True, inputs_need_grad=False)
        self._arg_names = symbol.list_arguments()
        self._param_names = self.execgrp.param_names
        self._aux_names = symbol.list_auxiliary_states()

    @property
    def param_names(self):
        return self._param_names

    @property
    def aux_names(self):
        return self._aux_names

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    def install_monitor(self, monitor):
        monitor.install(self.execgrp.executor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self.execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.execgrp.forward(is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
