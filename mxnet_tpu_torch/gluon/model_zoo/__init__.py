"""Gluon model zoo, the counterpart of mxnet_tpu/gluon/model_zoo/
(reference python/mxnet/gluon/model_zoo/)."""
from . import vision
from .vision import get_model
