"""Operator registry: the counterpart of mxnet_tpu/ops/registry.py.

Every op is a function over `torch.Tensor`s, registered under the names
and aliases of its JAX namesake, and drives the imperative `nd.<op>`
wrappers (`ndarray._init_module`), the symbolic `sym.<op>` constructors
(`symbol._init_module`) and the symbol's shape and dtype inference.
Autograd is torch's: an op's compute runs under `torch.enable_grad()`
while `autograd.record()` is on or an executor differentiates its
graph, and ops whose JAX gradient is a custom VJP (`BlockGrad`,
`make_loss`, `SoftmaxOutput`) use a `torch.autograd.Function`.

Forward shape inference runs the op's compute on `torch.device('meta')`
tensors, where the JAX package runs `jax.eval_shape`: an op whose
compute reads values (`.item()`, numpy) cannot run there and needs an
`infer_shape` of its own.
"""
import functools

import torch


class OpContext:
    """Per-invocation execution context: train/test mode, the
    torch.Generator a sampler draws from, the device its outputs are
    made on (an op with no inputs, such as `_zeros` or a sampler, has no
    other way to know it), and, for shape-carrying init ops such as
    zeros(shape=(0, H)), the bidirectionally inferred output shapes."""
    __slots__ = ('is_train', 'rng', 'device', 'out_shapes')

    def __init__(self, is_train=False, rng=None, device=None,
                 out_shapes=None):
        self.is_train = is_train
        self.rng = rng
        self.device = device
        self.out_shapes = out_shapes


# ---------------------------------------------------------------------------
# Partial shapes: the reference TShape convention, a 0 in a dimension
# means "unknown"; None is a completely unknown shape.
# ---------------------------------------------------------------------------

def shape_is_complete(s):
    return s is not None and all(d != 0 for d in s)


def merge_shape(a, b):
    """Unify two partial shapes. Returns the merged shape, or None if
    they conflict (callers keep their existing value on conflict, so
    backward propagation is strictly additive)."""
    if a is None:
        return tuple(b) if b is not None else None
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        return None
    out = []
    for da, db in zip(a, b):
        if da == 0:
            out.append(db)
        elif db == 0 or db == da:
            out.append(da)
        else:
            return None
    return tuple(out)


class OpDef:
    """A registered operator.

    Canonical compute signature:
        fcompute(attrs, inputs, auxs, op_ctx) -> (outputs, new_auxs)
    where inputs/auxs/outputs are lists of torch tensors and attrs is a
    dict of parsed Python values. The last `num_aux` input names are aux
    states (BatchNorm's moving statistics), which a mutable_aux op
    returns updated in train mode (every call with aux_always).

    infer_shape(attrs, in_shapes) -> completed in_shapes (None where
    still unknown): it back-fills parameter shapes (FullyConnected's
    weight = (num_hidden, D)); forward output shapes come from running
    the compute on meta tensors.
    """

    def __init__(self, name, fcompute, input_names=('data',), num_aux=0,
                 num_outputs=1, output_names=None, infer_shape=None,
                 infer_dtype=None, needs_rng=False, mode_dependent=False,
                 mutable_aux=False, hint=None, shape_rule=None,
                 needs_out_shapes=False, infer_shape_bwd=None,
                 aux_always=False):
        self.name = name
        self.fcompute = fcompute
        self._input_names = input_names
        self.num_aux = num_aux
        self._num_outputs = num_outputs
        self._output_names = output_names
        self.infer_shape_fn = infer_shape
        self.infer_dtype_fn = infer_dtype
        self.needs_rng = needs_rng
        # the compute reads op_ctx.is_train (the fused RNN's dropout); a
        # registration flag kept as the JAX package keeps it
        self.mode_dependent = mode_dependent
        self.mutable_aux = mutable_aux
        # aux states mutate whatever the mode (optimizer update ops)
        self.aux_always = aux_always
        self.hint = hint or name.lstrip('_').lower()
        # 'same': all (non-aux) inputs and outputs share one shape, which
        # unifies in both directions (nnvm ElemwiseShape)
        self.shape_rule = shape_rule
        # op-specific backward rule: fn(attrs, in_shapes, out_shapes)
        # -> in_shapes (FullyConnected: batch dim out -> data)
        self.infer_shape_bwd_fn = infer_shape_bwd
        # the compute wants the inferred output shapes (init ops whose
        # attr shape may hold unknown 0 dims)
        self.needs_out_shapes = needs_out_shapes

    # -- metadata ----------------------------------------------------------
    def input_names(self, attrs):
        names = self._input_names
        if callable(names):
            names = names(attrs)
        return list(names)

    def arg_names(self, attrs):
        """Non-aux input names."""
        names = self.input_names(attrs)
        return names[:-self.num_aux] if self.num_aux else names

    def aux_names(self, attrs):
        names = self.input_names(attrs)
        return names[-self.num_aux:] if self.num_aux else []

    def num_outputs(self, attrs):
        n = self._num_outputs
        return n(attrs) if callable(n) else n

    def output_names(self, attrs):
        if self._output_names is None:
            n = self.num_outputs(attrs)
            if n == 1:
                return ['output']
            return ['output%d' % i for i in range(n)]
        names = self._output_names
        if callable(names):
            names = names(attrs)
        return list(names)

    # -- compute -----------------------------------------------------------
    def apply(self, attrs, inputs, auxs, op_ctx):
        outs, new_auxs = self.fcompute(attrs, list(inputs), list(auxs),
                                       op_ctx)
        return list(outs), list(new_auxs)

    # -- inference ---------------------------------------------------------
    def infer_shape(self, attrs, in_shapes, in_dtypes=None,
                    out_shapes=None):
        """Bidirectional per-op shape inference (the nnvm InferShape
        role), as the JAX package's OpDef.infer_shape.

        in_shapes/out_shapes may be None (unknown) or partial (0 dims
        unknown). Returns (in_shapes, out_shapes) with everything this op
        could deduce filled in; out_shapes is None while the outputs
        cannot be determined. Once every input is complete the compute
        runs on meta tensors for the output shapes; shape_rule='same'
        also unifies inputs and outputs in both directions."""
        in_shapes = list(in_shapes)
        if self.infer_shape_fn is not None:
            in_shapes = self.infer_shape_fn(attrs, in_shapes)
        if self.infer_shape_bwd_fn is not None and out_shapes and \
                any(s is not None for s in out_shapes):
            in_shapes = self.infer_shape_bwd_fn(attrs, in_shapes,
                                                out_shapes)
        n_arg = len(in_shapes) - self.num_aux
        if self.shape_rule == 'same':
            unified = None
            for s in in_shapes[:n_arg] + list(out_shapes or []):
                m = merge_shape(unified, s)
                if m is not None:
                    unified = m
            if unified is not None:
                for i in range(n_arg):
                    m = merge_shape(in_shapes[i], unified)
                    if m is not None:
                        in_shapes[i] = m
                if not any(shape_is_complete(s)
                           for s in in_shapes[:n_arg]) or \
                        not all(shape_is_complete(s) for s in in_shapes):
                    # the compute cannot run yet: report what is known
                    return in_shapes, [unified] * self.num_outputs(attrs)
        if not all(shape_is_complete(s) for s in in_shapes):
            return in_shapes, None
        if in_dtypes is None:
            in_dtypes = [torch.float32] * len(in_shapes)
        meta = torch.device('meta')
        vals = [torch.empty(tuple(s), dtype=dt, device=meta)
                for s, dt in zip(in_shapes, in_dtypes)]
        ctx = OpContext(is_train=False, device=meta,
                        out_shapes=list(out_shapes) if out_shapes else None)
        with torch.no_grad():
            outs, _ = self.apply(attrs, vals[:n_arg], vals[n_arg:], ctx)
        return in_shapes, [tuple(o.shape) for o in outs]

    def infer_dtype(self, attrs, in_dtypes):
        """(in_dtypes, out_dtypes) as torch dtypes, None where unknown:
        the op's own rule, else the first known input dtype (float32
        when none is known) for every input and output."""
        in_dtypes = list(in_dtypes)
        if self.infer_dtype_fn is not None:
            return self.infer_dtype_fn(attrs, in_dtypes)
        known = [d for d in in_dtypes if d is not None]
        d = known[0] if known else torch.float32
        in_dtypes = [d if x is None else x for x in in_dtypes]
        return in_dtypes, [d] * self.num_outputs(attrs)


_OP_REGISTRY = {}
_OP_ALIASES = {}
# bumped by every register(), so that what the C API caches of the
# registry (its op names and op infos) keys on generation(), not len()
_GENERATION = [0]


def generation():
    """Monotonic registry mutation stamp: changes whenever register()
    runs. The dict sizes are folded in as a tripwire for direct del/pop
    edits (tests), as the JAX package's generation() does."""
    return (_GENERATION[0] << 20) + len(_OP_REGISTRY) + len(_OP_ALIASES)


def register(name, input_names=('data',), num_aux=0, num_outputs=1,
             output_names=None, infer_shape=None, infer_dtype=None,
             needs_rng=False, mode_dependent=False, mutable_aux=False,
             aliases=(), hint=None, simple=True, shape_rule=None,
             needs_out_shapes=False, infer_shape_bwd=None,
             aux_always=False):
    """Decorator registering an op.

    With simple=True (default) the decorated function has signature
    `fn(attrs, *inputs) -> out | tuple(outs)` and is adapted to the
    canonical form. With simple=False it has the canonical signature
    `fn(attrs, inputs, auxs, op_ctx) -> (outs, new_auxs)`.
    """
    def do_register(fn):
        if simple:
            @functools.wraps(fn)
            def fcompute(attrs, inputs, auxs, op_ctx):
                out = fn(attrs, *inputs)
                if not isinstance(out, (tuple, list)):
                    out = (out,)
                return list(out), []
        else:
            fcompute = fn
        op = OpDef(name, fcompute, input_names=input_names, num_aux=num_aux,
                   num_outputs=num_outputs, output_names=output_names,
                   infer_shape=infer_shape, infer_dtype=infer_dtype,
                   needs_rng=needs_rng, mode_dependent=mode_dependent,
                   mutable_aux=mutable_aux, hint=hint,
                   shape_rule=shape_rule, needs_out_shapes=needs_out_shapes,
                   infer_shape_bwd=infer_shape_bwd, aux_always=aux_always)
        _OP_REGISTRY[name] = op
        for alias in aliases:
            _OP_ALIASES[alias] = name
        _GENERATION[0] += 1
        fn.op = op
        return fn
    return do_register


def get(name):
    if name in _OP_REGISTRY:
        return _OP_REGISTRY[name]
    if name in _OP_ALIASES:
        return _OP_REGISTRY[_OP_ALIASES[name]]
    raise KeyError('Operator %s is not registered' % name)


def exists(name):
    return name in _OP_REGISTRY or name in _OP_ALIASES


def list_ops():
    return sorted(_OP_REGISTRY.keys()) + sorted(_OP_ALIASES.keys())


# ---------------------------------------------------------------------------
# Shared helpers for op implementations
# ---------------------------------------------------------------------------

def astuple(v, n=None):
    """Parse kernel/stride/pad style attrs: an int, a tuple, or a
    '(1, 2)' string."""
    from ..base import parse_attr_value
    v = parse_attr_value(v)
    if isinstance(v, (int, float)):
        v = (int(v),) * (n or 1)
    v = tuple(int(x) for x in v)
    if n is not None and len(v) == 1:
        v = v * n
    return v


def asbool(v):
    from ..base import parse_attr_value
    v = parse_attr_value(v)
    if isinstance(v, str):
        return v.lower() in ('true', '1')
    return bool(v)


def asint(v):
    from ..base import parse_attr_value
    return int(parse_attr_value(v))


def asfloat(v):
    from ..base import parse_attr_value
    return float(parse_attr_value(v))


def normalize_axis(axis, ndim):
    axis = asint(axis)
    return axis + ndim if axis < 0 else axis
