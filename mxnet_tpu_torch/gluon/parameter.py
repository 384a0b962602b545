"""Gluon Parameter and ParameterDict, the counterpart of
mxnet_tpu/gluon/parameter.py (reference python/mxnet/gluon/parameter.py):
a Parameter with deferred shape initialization and grad_req, its data
an NDArray per context, its gradient attached as `NDArray.attach_grad`
attaches one; a ParameterDict with prefix namespacing and a shared
fall-through dict. `params_from_jax` loads the JAX package's parameters
(numpy arrays by name) into a ParameterDict.
"""
import numpy as np

from .. import ndarray as nd
from .. import autograd
from ..base import MXNetError
from ..context import Context, current_context, cpu
from .. import initializer as init


class DeferredInitializationError(MXNetError):
    """Raised when parameter data is requested before shapes are known."""


# Bound by block.py at import (a circular import otherwise): while a
# hybridized block's cached function runs, parameters resolve to the
# arrays it was given, so that blocks which read their weights through
# Parameter.data() run on them too.
_lookup_param_substitution = None


class Parameter(object):
    """A trainable parameter: holds data (per context) and gradient.

    Mirrors reference gluon/parameter.py Parameter: shape entries of 0
    mean unknown and are completed on first forward (deferred init).
    """

    def __init__(self, name, grad_req='write', shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, sparse_grad=False):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        # a table the fused step trains rows-only (gluon/fused.py,
        # parallel/embedding.py); its gradient elsewhere is dense
        self.sparse_grad = bool(sparse_grad)
        if not differentiable:
            grad_req = 'null'
        self._grad_req = grad_req
        self._data = None          # dict ctx -> NDArray
        self._grad = None          # dict ctx -> NDArray
        self._deferred_init = ()   # (init, ctx_list, default_init)

    def __repr__(self):
        return 'Parameter %s (shape=%s, dtype=%s)' % (
            self.name, self.shape, getattr(self.dtype, '__name__', self.dtype))

    # -- grad_req ----------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ('write', 'add', 'null'), \
            "grad_req must be one of write, add, null, but got %s" % req
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == 'null':
            self._grad = None
        elif self._data is not None:
            self._init_grad()

    # -- init --------------------------------------------------------------
    def _shape_known(self):
        return self.shape is not None and all(
            s is not None and s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            default_init = _default_uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, list(ctx), default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape %s. Set allow_deferred_init=True or specify the "
                "full shape." % (self.name, self.shape))
        self._deferred_init = (init, list(ctx), default_init)
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        initializer, ctx_list, default_init = self._deferred_init
        self._deferred_init = ()
        assert self._shape_known()
        with autograd.pause():
            data = nd.zeros(self.shape, dtype=self.dtype, ctx=cpu())
            initr = initializer if initializer is not None \
                else (self.init if self.init is not None else default_init)
            # a parameter-specific init bypasses the name-pattern
            # dispatch via the InitDesc __init__ attr (an explicit init
            # wins whatever the name)
            attrs = {}
            if initializer is not None or self.init is not None:
                attrs['__init__'] = init.create(initr).dumps()
            init.create(initr)(init.InitDesc(self.name, attrs), data)
            self._data = {c: data.copyto(c) for c in ctx_list}
        if self._grad_req != 'null':
            self._init_grad()

    def _init_grad(self):
        self._grad = {}
        for c, d in self._data.items():
            g = nd.zeros(d.shape, dtype=d.dtype, ctx=c)
            self._grad[c] = g
            d.grad_req = self._grad_req
            d._grad = g

    def _finish_lazy(self):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet because "
                    "its shape is unknown (deferred init pending). Run a "
                    "forward pass first or specify the shape." % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. You should "
                "initialize parameters (block.collect_params"
                "().initialize(...)) before use." % self.name)

    def _load_init(self, data, ctx):
        """Set data from a loaded NDArray, validating shape/dtype."""
        if self.shape is not None and self._shape_known():
            if tuple(data.shape) != tuple(self.shape):
                raise ValueError(
                    'Failed loading Parameter %s: shape %s incompatible '
                    'with saved %s' % (self.name, self.shape, data.shape))
        self.shape = tuple(data.shape)
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is None:
            self._deferred_init = (None, list(ctx), _default_uniform())
            self._finish_deferred_init()
        self.set_data(data)

    # -- data access -------------------------------------------------------
    def _check_and_get(self, store, ctx):
        self._finish_lazy()
        if ctx is None:
            if len(store) == 1:
                return list(store.values())[0]
            ctx = current_context()
        if ctx in store:
            return store[ctx]
        raise RuntimeError(
            "Parameter %s was not initialized on context %s. It was only "
            "initialized on %s." % (self.name, ctx, list(store)))

    def data(self, ctx=None):
        if _lookup_param_substitution is not None:
            sub = _lookup_param_substitution(self)
            if sub is not None:
                return sub
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        self._finish_lazy()
        return list(self._data.values())

    def grad(self, ctx=None):
        if self._grad is None:
            if self._grad_req == 'null':
                raise RuntimeError(
                    "Cannot get gradient array for Parameter %s because "
                    "grad_req='null'" % self.name)
            self._finish_lazy()
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._grad is None:
            self.grad()         # raises: grad_req 'null', or no data yet
        return list(self._grad.values())

    def list_ctx(self):
        if self._data is None and self._deferred_init:
            return list(self._deferred_init[1])
        self._finish_lazy()
        return list(self._data.keys())

    def set_data(self, data):
        self._finish_lazy()
        if not isinstance(data, nd.NDArray):
            data = nd.array(data)
        for c in list(self._data):
            old = self._data[c]
            new = data.copyto(c).astype(self.dtype)
            # keep grad attachment live on the new array
            new.grad_req = old.grad_req
            new._grad = old._grad
            self._data[c] = new

    def zero_grad(self):
        if self._grad is None:
            return
        for c, g in self._grad.items():
            g._data = nd.zeros(g.shape, dtype=g.dtype, ctx=c)._data

    def reset_ctx(self, ctx):
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None:
            data = list(self._data.values())[0]
            self._data = {c: data.copyto(c) for c in ctx}
            if self._grad_req != 'null':
                self._init_grad()
        elif self._deferred_init:
            i, _, d = self._deferred_init
            self._deferred_init = (i, list(ctx), d)

    def var(self):
        """Symbol variable for this parameter (for symbolic export)."""
        from .. import symbol
        return symbol.Variable(self.name, shape=self.shape)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            with autograd.pause():
                self._data = {c: d.astype(dtype) for c, d in self._data.items()}
                if self._grad is not None:
                    self._init_grad()


class Constant(Parameter):
    """A constant (non-trainable) parameter, initialized from `value`."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(value)
        self.value = value

        class _CInit(init.Initializer):
            def __call__(self, _, arr):
                arr[:] = value.asnumpy()
        super(Constant, self).__init__(
            name, grad_req='null', shape=value.shape, dtype=value.dtype,
            init=_CInit())


def _default_uniform():
    return init.Uniform(0.07)


class ParameterDict(object):
    """Ordered dict of Parameters with prefix namespacing and a shared
    fall-through dict (reference gluon/parameter.py ParameterDict)."""

    def __init__(self, prefix='', shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = '\n'.join('  %r' % p for p in self._params.values())
        return 'ParameterDict %s(\n%s\n)' % (self._prefix, s)

    def __len__(self):
        return len(self._params)

    def __iter__(self):
        """Iterate parameter names."""
        return iter(self._params)

    def items(self):
        """(name, Parameter) pairs, insertion-ordered."""
        return self._params.items()

    def keys(self):
        """Parameter names, insertion-ordered."""
        return self._params.keys()

    def values(self):
        """Parameter objects, insertion-ordered."""
        return self._params.values()

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """Get (create if needed) a parameter named prefix+name."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if v is None:
                    continue
                existing = getattr(param, k, None)
                if k == 'shape' and existing is not None:
                    v = tuple(v)
                    if len(v) != len(existing) or any(
                            x not in (0, y) and y not in (0, x)
                            for x, y in zip(existing, v)):
                        raise AssertionError(
                            'Parameter %s: shape mismatch %s vs %s'
                            % (name, existing, v))
                    # merge: prefer known (nonzero) dims
                    param.shape = tuple(x if x != 0 else y
                                        for x, y in zip(existing, v))
                elif existing is None or k in ('init', 'dtype'):
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError('No constant named %s' % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    'Cannot update self with other because they have '
                    'different Parameters with the same name %s' % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for _, v in self.items():
            v.initialize(init=None, ctx=ctx, default_init=init or
                         _default_uniform(), force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=''):
        arg_dict = {}
        for param in self.values():
            block = param.list_data()
            weight = sum(w.copyto(cpu()) for w in block) / len(block)
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix %s is to be stripped before saving, but "
                    "Parameter %s does not start with it." % (
                        strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = weight
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=''):
        # read on the host; each parameter's data goes to its contexts
        arg_dict = nd.load(filename, ctx=cpu())
        if not isinstance(arg_dict, dict):
            raise ValueError('Loaded file does not contain a parameter dict')
        arg_dict = {restore_prefix + k.split(':', 1)[-1]: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError('Parameter %s is missing in file %s'
                                  % (name, filename))
        for name, val in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError('Parameter %s loaded from file %s is not '
                                  'present in this ParameterDict'
                                  % (name, filename))
                continue
            self[name]._load_init(val, ctx or [current_context()])


def params_from_jax(param_dict, arrays, ctx=None):
    """Load the JAX package's parameters into `param_dict`: `arrays` maps
    each parameter's full name to a numpy array (its `.data().asnumpy()`
    there), set on `ctx` (default: the contexts each parameter lives on,
    or the current context), in the parameter's dtype. Deferred shapes
    are completed from the arrays. The Gluon side of carrying weights
    across the two packages."""
    missing = [n for n in param_dict.keys() if n not in arrays]
    if missing:
        raise MXNetError('params_from_jax: no array for %s' % missing)
    for name, param in param_dict.items():
        a = np.asarray(arrays[name])
        if ctx is not None:
            where = ctx
        elif param._data is not None:
            where = param.list_ctx()
        elif param._deferred_init:
            where = param._deferred_init[1]
        else:
            where = [current_context()]
        param._load_init(nd.array(a, ctx=cpu(), dtype=a.dtype), where)
