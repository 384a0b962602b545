"""Contrib namespace (`mx.contrib.ndarray` / `mx.contrib.symbol` /
`mx.contrib.autograd`): the counterpart of mxnet_tpu/contrib (reference
python/mxnet/contrib). The contrib operators are registered in
ops/contrib_ops.py and reachable both here and on the main nd and sym
modules (the reference exposes them with a `_contrib_` prefix through
the same codegen)."""
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import autograd
