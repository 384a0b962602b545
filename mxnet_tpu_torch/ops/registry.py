"""Operator registry: the counterpart of mxnet_tpu/ops/registry.py.

Every op is a function over `torch.Tensor`s, registered under the names
and aliases of its JAX namesake, and drives the imperative `nd.<op>`
wrappers (`ndarray._init_module`). Autograd is torch's: an op's compute
runs under `torch.enable_grad()` while `autograd.record()` is on, and
ops whose JAX gradient is a custom VJP (`BlockGrad`, `make_loss`) use a
`torch.autograd.Function`.

Shape inference (`infer_shape`, partial shapes, `infer_dtype`) serves
the symbol layer, which the port does not have yet; it is left out.
"""
import functools


class OpContext:
    """Per-invocation execution context: train/test mode, the
    torch.Generator a sampler draws from, and the device its outputs are
    made on (an op with no inputs, such as `_zeros` or a sampler, has no
    other way to know it)."""
    __slots__ = ('is_train', 'rng', 'device')

    def __init__(self, is_train=False, rng=None, device=None):
        self.is_train = is_train
        self.rng = rng
        self.device = device


class OpDef:
    """A registered operator.

    Canonical compute signature:
        fcompute(attrs, inputs, auxs, op_ctx) -> (outputs, new_auxs)
    where inputs/auxs/outputs are lists of torch tensors and attrs is a
    dict of parsed Python values. No op of the port keeps aux states yet
    (the JAX package's are in ops/nn.py), so `auxs` arrives empty.
    """

    def __init__(self, name, fcompute, input_names=('data',), num_outputs=1,
                 needs_rng=False):
        self.name = name
        self.fcompute = fcompute
        self._input_names = input_names
        self._num_outputs = num_outputs
        self.needs_rng = needs_rng

    def input_names(self, attrs):
        names = self._input_names
        if callable(names):
            names = names(attrs)
        return list(names)

    def num_outputs(self, attrs):
        n = self._num_outputs
        return n(attrs) if callable(n) else n

    def apply(self, attrs, inputs, auxs, op_ctx):
        outs, new_auxs = self.fcompute(attrs, list(inputs), list(auxs),
                                       op_ctx)
        return list(outs), list(new_auxs)


_OP_REGISTRY = {}
_OP_ALIASES = {}


def register(name, input_names=('data',), num_outputs=1, needs_rng=False,
             aliases=(), simple=True):
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
        op = OpDef(name, fcompute, input_names=input_names,
                   num_outputs=num_outputs, needs_rng=needs_rng)
        _OP_REGISTRY[name] = op
        for alias in aliases:
            _OP_ALIASES[alias] = name
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
