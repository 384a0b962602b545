"""Operator registry and implementations (see registry.py).

Importing this package registers the ops the port has so far: the
tensor ops (`tensor`) and the samplers (`random_ops`), under the names
of their JAX namesakes in mxnet_tpu/ops/.
"""
from . import registry
from . import tensor
from . import random_ops

from .registry import get, exists, list_ops, register, OpDef, OpContext
