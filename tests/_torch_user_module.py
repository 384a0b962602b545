"""A user program written for the JAX package: a SequentialModule whose
middle layer is a user BaseModule subclass (the shape of
examples/stochastic_depth/sd_mnist.py's StochasticDepthModule, with the
gate fixed open), bound at a few rows.

`run(seed)` returns the chain's eval output, its train-mode output and
the gradient of the user layer's input, on parameters and data made
from `seed` with numpy. tests/test_torch_tools.py runs it on the JAX
package in its own process, and on the port in a child interpreter
(tests/_torch_examples_child.py) through the finder of
mxnet_tpu_torch.tools.run_script, and compares the two.
"""
import logging

import numpy as np

import mxnet_tpu as mx
from mxnet_tpu import sym
from mxnet_tpu.module.base_module import BaseModule

ROWS, CHANNELS, SIDE, CLASSES = 4, 4, 6, 3


class Residual(BaseModule):
    """out = x + rate * f(x), f a Module of its own."""

    def __init__(self, symbol, rate, logger=logging):
        super().__init__(logger=logger)
        self._mod = mx.mod.Module(symbol, data_names=('data',),
                                  label_names=[], logger=logger)
        self._rate = rate
        self._outputs = self._input_grads = None

    @property
    def data_names(self):
        return self._mod.data_names

    @property
    def output_names(self):
        return self._mod.output_names

    @property
    def data_shapes(self):
        return self._mod.data_shapes

    @property
    def label_shapes(self):
        return self._mod.label_shapes

    @property
    def output_shapes(self):
        return self._mod.output_shapes

    def get_params(self):
        return self._mod.get_params()

    def init_params(self, *args, **kwargs):
        self._mod.init_params(*args, **kwargs)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, **kwargs):
        self._mod.bind(data_shapes, label_shapes, for_training,
                       for_training or inputs_need_grad, **kwargs)
        self.binded = True

    def init_optimizer(self, *args, **kwargs):
        self._mod.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._mod.forward(data_batch, is_train=is_train)
        self._outputs = [x + self._rate * f for x, f in
                         zip(data_batch.data, self._mod.get_outputs())]

    def get_outputs(self, merge_multi_context=True):
        return self._outputs

    def backward(self, out_grads=None):
        self._mod.backward(out_grads=[self._rate * g for g in out_grads])
        self._input_grads = [g + f for g, f in
                             zip(out_grads, self._mod.get_input_grads())]

    def get_input_grads(self, merge_multi_context=True):
        return self._input_grads

    def update(self):
        self._mod.update()

    def update_metric(self, eval_metric, labels):
        pass


def chain():
    stem = sym.Activation(sym.Convolution(
        sym.Variable('data'), num_filter=CHANNELS, kernel=(3, 3),
        pad=(1, 1), name='stem_conv'), act_type='relu')
    body = sym.Convolution(sym.Activation(sym.Convolution(
        sym.Variable('data'), num_filter=CHANNELS, kernel=(3, 3),
        pad=(1, 1), name='body_conv1'), act_type='relu'),
        num_filter=CHANNELS, kernel=(3, 3), pad=(1, 1), name='body_conv2')
    head = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Flatten(sym.Pooling(sym.Variable('data'), pool_type='max',
                                kernel=(2, 2), stride=(2, 2))),
        num_hidden=CLASSES, name='head_fc'), name='softmax')
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(stem, label_names=[]), auto_wiring=True)
    residual = Residual(body, 0.5)
    seq.add(residual, auto_wiring=True)
    seq.add(mx.mod.Module(head, label_names=['softmax_label']),
            take_labels=True, auto_wiring=True)
    return seq, residual


def run(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(ROWS, CHANNELS - 1, SIDE, SIDE).astype(np.float32)
    y = rs.randint(0, CLASSES, ROWS).astype(np.float32)
    shapes = {'stem_conv_weight': (CHANNELS, CHANNELS - 1, 3, 3),
              'body_conv1_weight': (CHANNELS, CHANNELS, 3, 3),
              'body_conv2_weight': (CHANNELS, CHANNELS, 3, 3),
              'head_fc_weight': (CLASSES, CHANNELS * (SIDE // 2) ** 2)}
    params = {n: rs.randn(*s).astype(np.float32) * 0.3
              for n, s in sorted(shapes.items())}
    for n in ('stem_conv_bias', 'body_conv1_bias', 'body_conv2_bias'):
        params[n] = rs.randn(CHANNELS).astype(np.float32) * 0.1
    params['head_fc_bias'] = rs.randn(CLASSES).astype(np.float32) * 0.1

    seq, residual = chain()
    seq.bind(data_shapes=[('data', x.shape)],
             label_shapes=[('softmax_label', y.shape)])
    seq.init_params(arg_params={n: mx.nd.array(v)
                                for n, v in params.items()},
                    force_init=True)
    batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])
    seq.forward(batch, is_train=False)
    eval_out = seq.get_outputs()[0].asnumpy().copy()
    seq.forward(batch, is_train=True)
    train_out = seq.get_outputs()[0].asnumpy().copy()
    seq.backward()
    dx = residual.get_input_grads()[0].asnumpy().copy()
    return {'eval': eval_out, 'train': train_out, 'residual_dx': dx}
