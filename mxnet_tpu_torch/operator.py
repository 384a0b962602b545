"""Python custom operators (`mx.operator.CustomOp` / `CustomOpProp`): the
counterpart of mxnet_tpu/operator.py (reference python/mxnet/operator.py
:413 register; C side src/operator/custom/custom.cc).

Users implement forward and backward in numpy-land Python; the framework
runs them inside its graphs. The JAX op is a `jax.pure_callback` under a
`jax.custom_vjp`; here it is a `torch.autograd.Function` whose forward
copies the inputs to the host, runs the user's `forward` and puts the
outputs back on the op's device, and whose backward does the same with
the user's `backward`. The host arrays are numpy, except bfloat16, which
numpy lacks: the user gets the torch CPU tensor `_hostarray` gives (the
card's host may have no ml_dtypes). Shapes and dtypes come from the
prop's `infer_shape` and `infer_type`, on the meta device too, where the
symbol's inference runs an op. The JAX package's departures from the
reference hold: an operator instance for each call (it should be
stateless), and no auxiliary states.

The legacy pre-CustomOp ops, PythonOp with NumpyOp (`_Native`) and
NDArrayOp (`_NDArray`), ride the same Function through an adapter prop,
as in the JAX package.
"""
import numpy as np
import torch

from . import _hostarray as ha
from .base import parse_attr_value
from .ops.registry import register as _register_op


class CustomOp(object):
    """Base class for user ops (reference operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs: write results via self.assign(out_data[i],
        req[i], value)."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into in_grad."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Honor the write/add/null request (reference CustomOp.assign);
        `dst` a numpy array, or a torch CPU tensor for bfloat16."""
        if req in ('null', 0):
            return
        if ha.is_torch(dst):
            src = torch.as_tensor(np.asarray(ha.to_float32(src)
                                             if ha.is_torch(src) else src,
                                             np.float32))
            src = src.reshape(dst.shape).to(dst.dtype)
            if req in ('add', 'add_to', 3):
                src = dst + src
            dst[...] = src
            return
        if req in ('add', 'add_to', 3):
            dst[:] = dst + np.asarray(src, dst.dtype).reshape(dst.shape)
        else:
            dst[:] = np.asarray(src, dst.dtype).reshape(dst.shape)


class CustomOpProp(object):
    """Operator properties: arity, shapes, types, op factory
    (reference operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ['data']

    def list_outputs(self):
        return ['output']

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        """Default: all same as first input."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        head = out_grad if self.need_top_grad() else []
        return list(head) + list(in_data) + list(out_data)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_PROP_REGISTRY = {}


def register(reg_name):
    """Register a CustomOpProp subclass under `op_type`
    (reference operator.py register :413)."""
    def do_register(prop_cls):
        _PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop_cls(op_type):
    if op_type not in _PROP_REGISTRY:
        raise KeyError('Custom op type %s is not registered '
                       '(mx.operator.register)' % op_type)
    return _PROP_REGISTRY[op_type]


def _make_prop(attrs):
    op_type = str(parse_attr_value(attrs['op_type']))
    kwargs = {k: str(parse_attr_value(v)) for k, v in attrs.items()
              if k not in ('op_type',)}
    return get_prop_cls(op_type)(**kwargs)


def _custom_input_names(attrs):
    return list(_make_prop(attrs).list_arguments())


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _custom_infer_shape(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        return in_shapes
    prop = _make_prop(attrs)
    new_in, _, _ = prop.infer_shape([list(s) for s in in_shapes])
    return [tuple(s) for s in new_in]


def _np_dtype(dtype):
    """The numpy-side name of a torch dtype (bfloat16 stays a torch
    dtype: numpy has none)."""
    name = ha.dtype_name(dtype)
    return dtype if name in ha.TORCH_ONLY else np.dtype(name)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _custom_infer_dtype(attrs, in_dtypes):
    known = [d for d in in_dtypes if d is not None]
    d = known[0] if known else torch.float32
    in_dtypes = [d if x is None else x for x in in_dtypes]
    _, outs, _ = _make_prop(attrs).infer_type(
        [_np_dtype(t) for t in in_dtypes])
    return in_dtypes, [_torch_dtype(t) for t in outs]


def _shapes_dtypes(prop, inputs):
    _, out_shapes, _ = prop.infer_shape([list(x.shape) for x in inputs])
    _, out_types, _ = prop.infer_type([_np_dtype(x.dtype) for x in inputs])
    return [tuple(s) for s in out_shapes], out_types


def _host_zeros(shape, dtype):
    if isinstance(dtype, torch.dtype):
        return torch.zeros(shape, dtype=dtype)
    return np.zeros(shape, dtype)


def _host(x):
    """A host copy of tensor x for the user's code (which may write it)."""
    return ha.copy(ha.host(x))


def _to_device(a, device):
    return torch.as_tensor(a if ha.is_torch(a) else np.ascontiguousarray(a)
                           ).to(device)


class _CustomFunction(torch.autograd.Function):
    """The user's forward on the host in the forward, its backward on the
    host in the backward; a fresh operator instance each time."""

    @staticmethod
    def forward(ctx, prop, is_train, *inputs):
        out_shapes, out_types = _shapes_dtypes(prop, inputs)
        op = prop.create_operator(None, [tuple(x.shape) for x in inputs],
                                  [_np_dtype(x.dtype) for x in inputs])
        in_data = [_host(x) for x in inputs]
        out_data = [_host_zeros(s, t) for s, t in zip(out_shapes, out_types)]
        op.forward(is_train, ['write'] * len(out_data), in_data, out_data, [])
        device = inputs[0].device
        outs = [_to_device(o, device) for o in out_data]
        ctx.prop = prop
        ctx.save_for_backward(*inputs, *outs)
        ctx.n_in = len(inputs)
        for o in outs:
            if not o.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        inputs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outs)]
        op = ctx.prop.create_operator(None,
                                      [tuple(x.shape) for x in inputs],
                                      [_np_dtype(x.dtype) for x in inputs])
        in_grad = [_host_zeros(tuple(x.shape), _np_dtype(x.dtype))
                   for x in inputs]
        op.backward(['write'] * len(inputs), [_host(g) for g in grads],
                    [_host(x) for x in inputs], [_host(o) for o in outs],
                    in_grad, [])
        device = inputs[0].device
        return (None, None) + tuple(_to_device(g, device) for g in in_grad)


def _run_custom(prop, inputs, is_train):
    if inputs[0].device.type == 'meta':
        out_shapes, out_types = _shapes_dtypes(prop, inputs)
        return [torch.empty(s, dtype=_torch_dtype(t), device='meta')
                for s, t in zip(out_shapes, out_types)]
    return list(_CustomFunction.apply(prop, bool(is_train), *inputs))


def _custom_compute(attrs, inputs, auxs, op_ctx):
    is_train = bool(op_ctx.is_train) if op_ctx is not None else False
    return _run_custom(_make_prop(attrs), inputs, is_train), []


_register_op('Custom', input_names=_custom_input_names,
             num_outputs=_custom_num_outputs,
             infer_shape=_custom_infer_shape,
             infer_dtype=_custom_infer_dtype, mode_dependent=True,
             hint='custom', simple=False)(_custom_compute)


# ---------------------------------------------------------------------------
# Legacy pre-CustomOp python op bridges: PythonOp / NumpyOp (_Native) /
# NDArrayOp (_NDArray) — reference python/mxnet/operator.py:36-382 with
# C sides src/operator/custom/native_op.cc and ndarray_op.cc. The
# v0.8-era API: the op INSTANCE (not a Prop class) carries
# forward/backward/infer_shape, and get_symbol() captures it. Instances
# are kept in a process-level table; the symbol attr carries the handle.
# ---------------------------------------------------------------------------

class PythonOp(object):
    """Base class for legacy python ops (reference operator.py:36)."""

    def __init__(self, need_top_grad=True):
        self.info_, self.need_top_grad_ = None, need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        """Subclasses (NumpyOp / NDArrayOp) build the bound symbol."""
        raise NotImplementedError('use NumpyOp or NDArrayOp')

    def forward(self, in_data, out_data):
        """Write outputs into out_data (host arrays)."""
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        """Write input gradients into in_grad."""
        raise NotImplementedError

    def infer_shape(self, in_shape):
        """Returns (in_shape, out_shape)."""
        return in_shape, [in_shape[0]] * len(self.list_outputs())

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def need_top_grad(self):
        return self.need_top_grad_


_LEGACY_OPS = {}


def _legacy_instance(attrs):
    return _LEGACY_OPS[int(parse_attr_value(attrs['info']))]


def _legacy_input_names(attrs):
    return list(_legacy_instance(attrs).list_arguments())


def _legacy_num_outputs(attrs):
    return len(_legacy_instance(attrs).list_outputs())


def _legacy_infer_shape(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        return in_shapes
    op = _legacy_instance(attrs)
    new_in, _ = op.infer_shape([list(s) for s in in_shapes])
    return [tuple(s) for s in new_in]


@register('_legacy_bridge')
class _LegacyAdapterProp(CustomOpProp):
    """Adapts a legacy PythonOp instance onto the CustomOp bridge, so
    _Native and _NDArray share one Function (device placement and
    per-tensor dtypes included)."""

    def __init__(self, info, **kwargs):
        super().__init__(need_top_grad=True)
        self._legacy = _LEGACY_OPS[int(info)]

    def list_arguments(self):
        return self._legacy.list_arguments()

    def list_outputs(self):
        return self._legacy.list_outputs()

    def infer_shape(self, in_shape):
        ins, outs = self._legacy.infer_shape(in_shape)
        return ins, outs, []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        legacy = self._legacy

        class _Adapter(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                legacy.forward(in_data, out_data)

            def backward(self, req, out_grad, in_data, out_data,
                         in_grad, aux):
                legacy.backward(out_grad, in_data, out_data, in_grad)

        return _Adapter()


def _legacy_compute(attrs, inputs, auxs, op_ctx):
    prop = _LegacyAdapterProp(str(parse_attr_value(attrs['info'])))
    is_train = bool(op_ctx.is_train) if op_ctx is not None else False
    return _run_custom(prop, inputs, is_train), []


for _legacy_name in ('_Native', '_NDArray'):
    _register_op(_legacy_name, input_names=_legacy_input_names,
                 num_outputs=_legacy_num_outputs,
                 infer_shape=_legacy_infer_shape, mode_dependent=True,
                 hint=_legacy_name.lstrip('_').lower(),
                 simple=False)(_legacy_compute)


class NumpyOp(PythonOp):
    """Legacy numpy-function op (reference operator.py:143; C side
    native_op.cc). forward/backward receive host arrays."""

    def get_symbol(self, *args, **kwargs):
        from . import symbol as _sym
        self.info_ = max(_LEGACY_OPS) + 1 if _LEGACY_OPS else 0
        _LEGACY_OPS[self.info_] = self
        return _sym._Native(*args, **dict(kwargs, info=str(self.info_)))


class NDArrayOp(PythonOp):
    """Legacy NDArray-function op (reference operator.py:243; C side
    ndarray_op.cc). The same flow as NumpyOp here — the callback receives
    host arrays either way; kept as a distinct class and op name for
    script compatibility."""

    def get_symbol(self, *args, **kwargs):
        from . import symbol as _sym
        self.info_ = max(_LEGACY_OPS) + 1 if _LEGACY_OPS else 0
        _LEGACY_OPS[self.info_] = self
        return _sym._NDArray(*args, **dict(kwargs, info=str(self.info_)))
