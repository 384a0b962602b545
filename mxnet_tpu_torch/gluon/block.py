"""Gluon Block and HybridBlock, the counterpart of
mxnet_tpu/gluon/block.py (reference python/mxnet/gluon/block.py:
Block:115, HybridBlock:283, hybridize's CachedOp).

A Block runs imperative NDArray ops as it is called, each recorded by
autograd. `hybridize` keeps the JAX package's cache, keyed by the call's
argument structure, the positions of its NDArrays, its other arguments
and train mode, each entry a `_CachedFn`. The JAX package jits the
imperative path there; the port has nothing to compile, so an entry's
function replays the same registry ops on the arrays it is given, the
parameters substituted by them (a hybridized forward equals the
imperative one bit for bit). Its non-trainable parameters (BatchNorm's
moving statistics) are committed after the call, and under
`autograd.record()` the call is one node of autograd (`_CachedCall`),
whose backward differentiates the replay's own graph.
"""
from contextlib import contextmanager

import torch

from .. import ndarray as nd
from .. import autograd
from . import parameter as _parameter_mod
from .parameter import Parameter, ParameterDict, DeferredInitializationError


def _pretty_name(name):
    """CamelCase -> the lowercase alias of auto-prefixes."""
    return name.lower()


class _BlockScope(object):
    """Name/parameter scoping for blocks (reference block.py _BlockScope)."""
    _current = None

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    _global_counter = {}

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope._current
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                prefix = '%s%d_' % (_pretty_name(hint), count)
                _BlockScope._global_counter[hint] = count + 1
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = '%s%d_' % (_pretty_name(hint), count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix,
                                   shared=parent._shared)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = _BlockScope._current
        _BlockScope._current = self
        return self

    def __exit__(self, ptype, value, trace):
        _BlockScope._current = self._old_scope


class Block(object):
    """Base class for all neural network layers and models
    (reference gluon/block.py:115)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ''
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith('_') \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        s = '{name}(\n{modstr}\n)'
        modstr = '\n'.join('  ({key}): {block}'.format(
            key=i, block='\n  '.join(repr(b).split('\n')))
            for i, b in enumerate(self._children))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """Returns a ParameterDict of this block's and children's params."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children:
            ret.update(child.collect_params())
        return ret

    def save_params(self, filename):
        """The parameters as an MXTPU001 file (nd.save), names stripped of
        this block's prefix: the JAX package's format, so a file saved by
        either package loads in the other."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, restore_prefix=self.prefix)

    def register_child(self, block):
        self._children.append(block)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            old = getattr(self, name, None)
            if isinstance(old, Block) and old in self._children:
                self._children[self._children.index(old)] = value
            else:
                self.register_child(value)
        super(Block, self).__setattr__(name, value)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def hybridize(self, active=True):
        for child in self._children:
            child.hybridize(active)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


def _flatten(obj):
    """(leaves, structure) of nested lists and tuples; any other object
    is a leaf."""
    if isinstance(obj, (list, tuple)):
        leaves, subs = [], []
        for item in obj:
            sub_leaves, sub = _flatten(item)
            leaves.extend(sub_leaves)
            subs.append(sub)
        return leaves, (type(obj).__name__, tuple(subs))
    return [obj], None


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, subs = node
        items = [build(s) for s in subs]
        return tuple(items) if kind == 'tuple' else items
    return build(structure)


class _CachedFn(object):
    """One entry of a hybridized block's cache, the counterpart of the
    reference CachedOp (c_api_ndarray.cc:464). `full(tensors)` takes
    [inputs..., params...] and returns (outputs, aux_updates), the
    post-forward values of the non-trainable (grad_req 'null')
    parameters, such as BatchNorm's moving statistics."""

    def __init__(self, full, aux_params):
        self.full = full
        self.aux_params = aux_params   # list of (name, Parameter)
        self.out_structure = None


class _CachedCall(torch.autograd.Function):
    """A hybridized call as one autograd node: the forward runs the
    cached function with grad enabled on leaves of its own, and the
    backward differentiates that graph."""

    @staticmethod
    def forward(ctx, cached, *tensors):
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in tensors]
        with torch.enable_grad(), autograd._nested_recording(leaves):
            outs, aux = cached.full(leaves)
        ctx.leaves, ctx.outs = leaves, outs
        aux = tuple(a.detach() for a in aux)
        ctx.mark_non_differentiable(*aux)
        return tuple(o.detach() for o in outs) + aux

    @staticmethod
    def backward(ctx, *grads):
        outs, leaves = ctx.outs, ctx.leaves
        live = [(o, g) for o, g in zip(outs, grads)
                if o.requires_grad and g is not None]
        want = [i for i, t in enumerate(leaves) if t.requires_grad]
        result = [None] * len(leaves)
        if live and want:
            gs = torch.autograd.grad([o for o, _ in live],
                                     [leaves[i] for i in want],
                                     [g for _, g in live],
                                     allow_unused=True)
            for i, g in zip(want, gs):
                result[i] = g
        return (None,) + tuple(result)


class HybridBlock(Block):
    """A Block whose forward is written over a namespace F (mx.nd); a
    hybridized one runs it through its cache (reference
    gluon/block.py:283)."""

    def __init__(self, prefix=None, params=None):
        super(HybridBlock, self).__init__(prefix, params)
        self._active = False
        self._cached_fn = None
        self._reg_params = {}

    def __setattr__(self, name, value):
        super(HybridBlock, self).__setattr__(name, value)
        if isinstance(value, Parameter):
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (str(block), str(type(block))))
        super(HybridBlock, self).register_child(block)
        self._cached_fn = None

    def hybridize(self, active=True):
        self._active = active
        self._cached_fn = None
        super(HybridBlock, self).hybridize(active)

    def cast(self, dtype):
        self._cached_fn = None
        super(HybridBlock, self).cast(dtype)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes (layers do it on their first
        forward)."""
        self._deferred_infer_shape(*args)

    def _deferred_infer_shape(self, *args):
        params = self.collect_params()
        pending = [p for p in params.values() if p._deferred_init]
        if not pending:
            return
        raise DeferredInitializationError(
            'Parameters %s have unknown shape. Layers complete shapes on '
            'first forward.' % [p.name for p in pending])

    def _collect_params_with_prefix(self, prefix=''):
        if prefix:
            prefix += '.'
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for i, child in enumerate(self._children):
            ret.update(child._collect_params_with_prefix(prefix + str(i)))
        return ret

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, x, *args):
        if not isinstance(x, nd.NDArray):
            raise ValueError(
                'HybridBlock forward input must be NDArray, got %s'
                % type(x))
        if self._active and not _TRACING:
            return self._call_cached(x, *args)
        ctx = x.context
        params = {}
        try:
            for k, v in self._reg_params.items():
                sub = _lookup_param_substitution(v)
                params[k] = sub if sub is not None else v.data(ctx)
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            for k, v in self._reg_params.items():
                params[k] = v.data(ctx)
        return self.hybrid_forward(nd, x, *args, **params)

    def _infer_param_shapes(self, x, *args):
        """Complete this layer's deferred parameter shapes from the input.
        Leaf layers with deferred-init params override this
        (reference: gluon parameter deferred init on first forward)."""
        raise DeferredInitializationError(
            '%s has parameters with unknown shape and does not implement '
            'shape inference from inputs.' % type(self).__name__)

    # -- hybridized path ---------------------------------------------------
    def _call_cached(self, x, *args):
        ctx = x.context
        try:
            params = self._param_arrays(ctx)
        except DeferredInitializationError:
            # the first forward runs imperatively so that each leaf layer
            # completes its deferred shapes from its real input
            self._active = False
            try:
                return self.forward(x, *args)
            finally:
                self._active = True
        # NDArray leaves of the arguments are the function's inputs;
        # everything else is part of the cache key
        leaves, structure = _flatten((x,) + args)
        nd_pos = tuple(i for i, l in enumerate(leaves)
                       if isinstance(l, nd.NDArray))
        inputs = [leaves[i] for i in nd_pos]
        static = tuple((i, l) for i, l in enumerate(leaves)
                       if not isinstance(l, nd.NDArray))
        is_train = autograd.is_training()
        key = (structure, nd_pos, repr(static), is_train)
        if self._cached_fn is None:
            self._cached_fn = {}
        if key not in self._cached_fn:
            self._cached_fn[key] = self._build_cache(
                structure, nd_pos, static, is_train)
        cached = self._cached_fn[key]
        if autograd.is_recording():
            plist = self._param_list()
            tensors = [autograd._enter(a) for a in inputs] + [
                autograd._enter(a) if p.grad_req != 'null'
                else a._data.detach()
                for (_, p), a in zip(plist, params)]
            with torch.enable_grad():
                flat = _CachedCall.apply(cached, *tensors)
            n_out = len(flat) - len(cached.aux_params)
            outs, aux_updates = flat[:n_out], flat[n_out:]
            autograd._recorded(outs)
        else:
            with autograd.pause(train_mode=is_train):
                outs, aux_updates = cached.full(
                    [a._data for a in inputs + params])
        if is_train:
            for (_, p), new in zip(cached.aux_params, aux_updates):
                p.data(ctx)._data = new.detach()
        out_arrays = [nd.NDArray(o, ctx) for o in outs]
        return _unflatten(cached.out_structure, out_arrays)

    def _param_list(self):
        params = self._collect_params_with_prefix()
        return sorted(params.items())

    def _param_arrays(self, ctx):
        return [p.data(ctx) for _, p in self._param_list()]

    def _build_cache(self, structure, nd_pos, static, is_train):
        """The cached function of (inputs..., params...) for one argument
        structure: the block's forward over NDArrays of the given
        tensors, its parameters substituted by them."""
        plist = self._param_list()
        aux_params = [(k, p) for k, p in plist if p.grad_req == 'null']
        n_in = len(nd_pos)
        n_leaves = len(nd_pos) + len(static)
        cached = _CachedFn(None, aux_params)

        def full(flat):
            leaves = [None] * n_leaves
            for i, pos in enumerate(nd_pos):
                leaves[pos] = nd.NDArray(flat[i])
            for pos, val in static:
                leaves[pos] = val
            call_args = _unflatten(structure, leaves)
            sub = {p: nd.NDArray(v)
                   for (_, p), v in zip(plist, flat[n_in:])}
            with param_trace(sub, train_mode=is_train):
                out = self.forward(*call_args)
            aux_updates = [sub[p]._data for _, p in aux_params]
            out_leaves, cached.out_structure = _flatten(out)
            return [o._data for o in out_leaves], aux_updates

        cached.full = full
        return cached

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


# while True, hybridized blocks take their imperative path (their ops
# run inside an enclosing cached function)
_TRACING = False


def _set_tracing(value):
    global _TRACING
    _TRACING = value


# the parameter substitution stack of cached functions
_SUBSTITUTION = []

# the fused step's conv -> BatchNorm pair route (gluon/fused.py): while
# set, a HybridSequential offers it each child with the child after it,
# and takes its output for the two where it gives one
_PAIR_ROUTE = [None]


def _push_param_substitution(sub):
    _SUBSTITUTION.append(sub)
    return len(_SUBSTITUTION) - 1


def _pop_param_substitution(token):
    del _SUBSTITUTION[token:]


def _lookup_param_substitution(param):
    for sub in reversed(_SUBSTITUTION):
        if param in sub:
            return sub[param]
    return None


# parameter.py consults the substitution stack from Parameter.data(), so
# blocks that read their weights directly (SymbolBlock, custom Blocks)
# take the substituted arrays too; bound here to avoid a circular import
_parameter_mod._lookup_param_substitution = _lookup_param_substitution


@contextmanager
def param_trace(sub, train_mode=True):
    """Run block code on the arrays of `sub` (a dict Parameter ->
    NDArray): Parameters resolve to them, hybridized blocks take their
    imperative path, and train mode is `train_mode`. Mutable aux updates
    land in `sub` (read sub[param]._data after the block ran). The
    recording state is the caller's (_CachedCall records into a nested
    one)."""
    token = _push_param_substitution(sub)
    old_tracing = _TRACING
    old_train = autograd.set_training(train_mode)
    _set_tracing(True)
    try:
        yield
    finally:
        _set_tracing(old_tracing)
        autograd.set_training(old_train)
        _pop_param_substitution(token)


class SymbolBlock(HybridBlock):
    """Wrap a Symbol into a callable Block
    (reference gluon/block.py SymbolBlock)."""

    def __init__(self, outputs, inputs, params=None):
        super(SymbolBlock, self).__init__(prefix='', params=params)
        from .. import symbol as _sym
        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name if hasattr(i, 'name') else str(i)
                             for i in inputs]
        arg_names = outputs.list_arguments()
        aux_names = outputs.list_auxiliary_states()
        for name in arg_names:
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in aux_names:
            self.params.get(name, grad_req='null', allow_deferred_init=True)

    def forward(self, *args):
        ctx = args[0].context
        arg_dict = dict(zip(self._input_names, args))
        for name, p in self.params.items():
            arg_dict[name] = p.data(ctx)
        outs = self._symbol.eval(ctx=ctx, **arg_dict)
        if not isinstance(outs, (list, tuple)):
            return outs
        return outs[0] if len(outs) == 1 else list(outs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
