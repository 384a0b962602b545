"""Operator registry and implementations (see registry.py).

Importing this package registers the ops the port has so far: the
tensor ops (`tensor`), the samplers (`random_ops`), the layers of
ResNet-50 (`nn`), the optimizer updates (`optimizer_ops`) and the fused
RNN (`rnn_op`), under the names of their JAX namesakes in
mxnet_tpu/ops/.
"""
from . import registry
from . import tensor
from . import random_ops
from . import nn
from . import optimizer_ops
from . import rnn_op

from .registry import get, exists, list_ops, register, OpDef, OpContext

# Same-shape ops outside the tensor.py wrapper families, marked for
# bidirectional shape unification (nnvm ElemwiseShape) as the JAX
# package marks them: only ops whose every input shares the output shape.
for _same_name in ('Activation', 'Dropout', 'Cast',
                   'BlockGrad', 'SoftmaxActivation', 'softmax',
                   'log_softmax', 'identity', '_copy', 'relu',
                   'sigmoid', 'make_loss', 'negative'):
    if exists(_same_name):
        get(_same_name).shape_rule = 'same'
del _same_name
