"""Operator registry and implementations (see registry.py).

Importing this package registers the ops: the tensor ops (`tensor`),
the samplers (`random_ops`), the layers (`nn`), the optimizer updates
(`optimizer_ops`), the fused RNN (`rnn_op`), the spatial ops
(`spatial`), the losses and linalg family (`extra`) and the contrib ops
(`contrib_ops`: MultiBox, Proposal, the PSROI and deformable ops, CTC,
FFT, count-sketch, quantize), under the names of their JAX namesakes in
mxnet_tpu/ops/. Custom, _Native and _NDArray are registered by the
package's `operator` module, as in the JAX package.
"""
from . import registry
from . import tensor
from . import random_ops
from . import nn
from . import optimizer_ops
from . import rnn_op
from . import spatial
from . import extra
from . import contrib_ops

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
