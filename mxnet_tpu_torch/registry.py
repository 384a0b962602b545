"""Generic class registry (reference python/mxnet/registry.py): the
register / alias / create factories keyed by a nickname that the
optimizers, initializers, metrics and iterators use."""
from .base import get_register_func, get_alias_func, get_create_func

register = get_register_func
alias = get_alias_func
create = get_create_func

__all__ = ['register', 'alias', 'create', 'get_register_func',
           'get_alias_func', 'get_create_func']
