"""Gluon, the imperative neural-network API: the counterpart of
mxnet_tpu/gluon/ (reference python/mxnet/gluon/).

`fused` (FusedStep, fuse_step) waits for the port's parallel/ (Queue A
6): it raises.
"""
from ..base import unported
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


class FusedStep:
    """The whole-step program of gluon/fused.py: constructing one
    raises."""

    def __init__(self, *args, **kwargs):
        raise unported('gluon.FusedStep (gluon/fused.py)', '6')


def fuse_step(*args, **kwargs):
    raise unported('gluon.fuse_step (gluon/fused.py)', '6')

