"""Symbolic contrib operators (reference python/mxnet/contrib/symbol
codegen of `_contrib_*` ops)."""
from .. import symbol as _sym
from ._names import CONTRIB_OPS as _CONTRIB_OPS

for _name in _CONTRIB_OPS:
    globals()[_name] = getattr(_sym, _name)

del _sym, _name
