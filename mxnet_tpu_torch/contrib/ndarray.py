"""Imperative contrib operators (reference python/mxnet/contrib/ndarray
codegen of `_contrib_*` ops)."""
from .. import ndarray as _nd
from ._names import CONTRIB_OPS as _CONTRIB_OPS

for _name in _CONTRIB_OPS:
    globals()[_name] = getattr(_nd, _name)

del _nd, _name
