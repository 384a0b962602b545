"""Gluon, the imperative neural-network API: the counterpart of
mxnet_tpu/gluon/ (reference python/mxnet/gluon/).

`fuse_step` / `FusedStep` (gluon/fused.py) train a net one whole step a
call; their pipelined mode (pipeline=) is not ported yet (ROADMAP Queue
A 6d).
"""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError, params_from_jax
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from . import data
from . import model_zoo
from . import rnn

from .fused import FusedStep, fuse_step
