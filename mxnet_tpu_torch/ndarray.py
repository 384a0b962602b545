"""NDArray: the imperative tensor API, the counterpart of
mxnet_tpu/ndarray.py.

An NDArray wraps a `torch.Tensor` with its `Context`. Every op of the
registry is an `nd.<op>` function generated at import, as the reference
generates `mx.nd.*` (python/mxnet/ndarray.py:2624 _init_ndarray_module),
and runs through `invoke` on the device of its inputs (or of its `ctx`
attr, or the current context). Nothing moves between devices on its
own: inputs on two devices raise, and a gpu array is never computed on
the CPU. Torch launches asynchronously on the device's current stream;
`wait_to_read` and `waitall` synchronise.

JAX arrays never alias, and neither do these: an op's result is new
storage (invoke copies one that shares an input's), indexing copies, and
`a[key] = v` swaps in a new tensor. The one write into an array's own
storage is `mx.rtc`'s `push(..., outs=[a])`, which the caller asks for.

`asnumpy` of a bfloat16 array returns float32 (numpy has no bfloat16
without ml_dtypes), and `dtype` is `torch.bfloat16` for such an array;
every other dtype is numpy's scalar type, as in the JAX package.
`save`/`load` read and write the JAX package's MXTPU001 files byte for
byte.
"""
import struct
import sys

import numpy as np
import torch

from . import autograd as _autograd
from . import profiler as _profiler
from . import random as _random
from .base import MXNetError, numpy_dtype, torch_dtype
from .context import Context, current_context
from .ops import registry as _reg
from .ops.tensor import _index_axis

# builtins that op codegen will shadow at module level (nd.slice, nd.sum)
_py_slice = slice


class NDArray:
    """An n-dimensional array on a device (CPU or GPU)."""
    __slots__ = ('_data', '_ctx', 'grad_req', '_grad', '__weakref__')

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else \
            Context.from_device(data.device)
        self.grad_req = None
        self._grad = None

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def handle(self):
        return self._data

    # -- data access -------------------------------------------------------
    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError('The current array is not a scalar')
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of unsized object')
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError('The truth value of an NDArray with multiple '
                         'elements is ambiguous.')

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return '%s\n<NDArray %s @%s>' % (
            str(self.asnumpy()), 'x'.join(map(str, self.shape)), self._ctx)

    # -- conversion / movement --------------------------------------------
    def astype(self, dtype, copy=True):
        return NDArray(self._data.detach().to(torch_dtype(dtype), copy=True),
                       self._ctx)

    def copy(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def copyto(self, other):
        """Copy to another NDArray (its data replaced) or a Context (a new
        array). Reference: CopyFromTo (ndarray.h:471)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError('shape mismatch in copyto')
            other._data = self._data.detach().to(
                other._ctx.torch_device, other._data.dtype, copy=True)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), other)
        raise TypeError('copyto does not support type %s' % type(other))

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def to_dlpack(self):
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    # -- shape manipulation ------------------------------------------------
    def reshape(self, shape, **kwargs):
        if isinstance(shape, int):
            shape = (shape,)
        return invoke('Reshape', [self], {'shape': tuple(shape), **kwargs})

    def expand_dims(self, axis):
        return invoke('expand_dims', [self], {'axis': axis})

    def flatten(self):
        return invoke('Flatten', [self], {})

    def transpose(self, axes=None):
        return invoke('transpose', [self], {'axes': axes})

    @property
    def T(self):
        return self.transpose()

    def broadcast_to(self, shape):
        return invoke('broadcast_to', [self], {'shape': tuple(shape)})

    def flip(self, axis):
        return invoke('reverse', [self], {'axis': axis})

    def tile(self, reps):
        return invoke('tile', [self], {'reps': reps})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke('SliceChannel', [self],
                      {'num_outputs': num_outputs, 'axis': axis,
                       'squeeze_axis': squeeze_axis})

    # -- reductions (method forms) ----------------------------------------
    def sum(self, axis=None, keepdims=False):
        return invoke('sum', [self], {'axis': axis, 'keepdims': keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke('mean', [self], {'axis': axis, 'keepdims': keepdims})

    def max(self, axis=None, keepdims=False):
        return invoke('max', [self], {'axis': axis, 'keepdims': keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke('min', [self], {'axis': axis, 'keepdims': keepdims})

    def argmax(self, axis=None, keepdims=False):
        return invoke('argmax', [self], {'axis': axis, 'keepdims': keepdims})

    def argmin(self, axis=None, keepdims=False):
        return invoke('argmin', [self], {'axis': axis, 'keepdims': keepdims})

    def norm(self):
        return invoke('norm', [self], {})

    def abs(self):
        return invoke('abs', [self], {})

    def square(self):
        return invoke('square', [self], {})

    def sqrt(self):
        return invoke('sqrt', [self], {})

    def exp(self):
        return invoke('exp', [self], {})

    def log(self):
        return invoke('log', [self], {})

    def clip(self, a_min, a_max):
        return invoke('clip', [self], {'a_min': a_min, 'a_max': a_max})

    def sort(self, axis=-1, is_ascend=True):
        return invoke('sort', [self], {'axis': axis, 'is_ascend': is_ascend})

    def topk(self, **kwargs):
        return invoke('topk', [self], kwargs)

    def one_hot(self, depth, **kwargs):
        return invoke('one_hot', [self], {'depth': depth, **kwargs})

    def astuple(self):
        return tuple(self.asnumpy())

    # -- indexing ----------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            key = key._data.detach()
            if key.device != self._data.device:
                raise MXNetError('index on %s for an array on %s'
                                 % (key.device, self._data.device))
            if not key.is_floating_point() and key.dtype != torch.bool:
                key = key.long()
        return key

    def __getitem__(self, key):
        key = self._key(key)
        out = self._data.detach()
        parts = key if isinstance(key, tuple) else (key,)
        if any(isinstance(k, _py_slice) and k.step is not None and k.step < 0
               for k in parts):
            # torch slices take no negative step: walk the axes, as
            # ops.tensor's slice does
            axis = 0
            for k in parts:
                if isinstance(k, _py_slice):
                    out = _index_axis(out, axis, k)
                    axis += 1
                else:
                    out = out.select(axis, int(k))
        else:
            out = out[key]
        return NDArray(out.clone(memory_format=torch.contiguous_format),
                       self._ctx)

    def __setitem__(self, key, value):
        dev, dt = self._data.device, self._data.dtype
        if isinstance(value, NDArray):
            if value._data.device != dev:
                raise MXNetError('assigning an array on %s into one on %s'
                                 % (value._data.device, dev))
            value = value._data.detach().to(dt)
        elif isinstance(value, (np.ndarray, list, tuple, float, int,
                                np.generic)):
            value = torch.as_tensor(np.asarray(value), device=dev).to(dt)
        if isinstance(key, _py_slice) and key == _py_slice(None):
            new = torch.broadcast_to(value, self.shape).to(dt).clone(
                memory_format=torch.contiguous_format)
        else:
            new = self._data.detach().clone()
            new[self._key(key)] = value
        self._data = new

    # -- arithmetic --------------------------------------------------------
    def _binary(self, other, elem_op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            if other.shape == self.shape:
                op = elem_op
            else:
                op = elem_op.replace('elemwise', 'broadcast') \
                    if elem_op.startswith('elemwise') else 'broadcast' + elem_op
            lhs, rhs = (other, self) if reverse else (self, other)
            return invoke(op, [lhs, rhs], {})
        if isinstance(other, (int, float, np.floating, np.integer)):
            return invoke(scalar_op, [self], {'scalar': float(other)})
        raise TypeError('unsupported operand type %s' % type(other))

    def __add__(self, other):
        return self._binary(other, 'elemwise_add', '_plus_scalar')

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, 'elemwise_sub', '_minus_scalar')

    def __rsub__(self, other):
        if isinstance(other, (int, float)):
            return invoke('_rminus_scalar', [self], {'scalar': float(other)})
        return self._binary(other, 'elemwise_sub', '_minus_scalar',
                            reverse=True)

    def __mul__(self, other):
        return self._binary(other, 'elemwise_mul', '_mul_scalar')

    __rmul__ = __mul__

    def __div__(self, other):
        return self._binary(other, 'elemwise_div', '_div_scalar')

    __truediv__ = __div__

    def __rdiv__(self, other):
        if isinstance(other, (int, float)):
            return invoke('_rdiv_scalar', [self], {'scalar': float(other)})
        return self._binary(other, 'elemwise_div', '_div_scalar',
                            reverse=True)

    __rtruediv__ = __rdiv__

    def __mod__(self, other):
        return self._binary(other, '_mod', '_mod_scalar')

    def __rmod__(self, other):
        if isinstance(other, (int, float)):
            return invoke('_rmod_scalar', [self], {'scalar': float(other)})
        return self._binary(other, '_mod', '_mod_scalar', reverse=True)

    def __pow__(self, other):
        return self._binary(other, '_power', '_power_scalar')

    def __rpow__(self, other):
        return invoke('_rpower_scalar', [self], {'scalar': float(other)})

    def __neg__(self):
        return invoke('negative', [self], {})

    def __abs__(self):
        return invoke('abs', [self], {})

    def __iadd__(self, other):
        self._data = self.__add__(other)._data
        return self

    def __isub__(self, other):
        self._data = self.__sub__(other)._data
        return self

    def __imul__(self, other):
        self._data = self.__mul__(other)._data
        return self

    def __itruediv__(self, other):
        self._data = self.__truediv__(other)._data
        return self

    def _cmp(self, other, op, scalar_op):
        if isinstance(other, NDArray):
            name = op if other.shape == self.shape else \
                op.replace('_', 'broadcast_', 1)
            return invoke(name, [self, other], {})
        return invoke(scalar_op, [self], {'scalar': float(other)})

    def __eq__(self, other):
        if other is None:
            return False
        return self._cmp(other, '_equal', '_equal_scalar')

    def __ne__(self, other):
        if other is None:
            return True
        return self._cmp(other, '_not_equal', '_not_equal_scalar')

    def __gt__(self, other):
        return self._cmp(other, '_greater', '_greater_scalar')

    def __ge__(self, other):
        return self._cmp(other, '_greater_equal', '_greater_equal_scalar')

    def __lt__(self, other):
        return self._cmp(other, '_lesser', '_lesser_scalar')

    def __le__(self, other):
        return self._cmp(other, '_lesser_equal', '_lesser_equal_scalar')

    __hash__ = None

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req='write'):
        """Attach a gradient buffer (reference: autograd MarkVariables)."""
        self._grad = NDArray(torch.zeros_like(self._data.detach()),
                             self._ctx)
        self.grad_req = grad_req
        _autograd.mark_variable(self)

    @property
    def grad(self):
        return self._grad

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _autograd.backward([self], [out_grad], retain_graph=retain_graph)


# ---------------------------------------------------------------------------
# Imperative invoke: the equivalent of MXImperativeInvoke
# (reference src/c_api/c_api_ndarray.cc:423)
# ---------------------------------------------------------------------------

def _owned(outs, inputs):
    """The outputs, each in storage of its own: one that shares an
    input's storage (a view, or the input itself) is copied."""
    taken = {t.untyped_storage().data_ptr() for t in inputs}
    return [o.clone(memory_format=torch.contiguous_format)
            if o.untyped_storage().data_ptr() in taken else o for o in outs]


def _run(op, attrs, inputs, ctx, auxs=()):
    """Apply `op` on the device of `ctx`, recorded for autograd while
    `autograd.record()` is on; returns its output tensors. The aux
    states (`auxs`, NDArrays) take no gradient; a mutable_aux op's new
    values are written into them in train mode (every call with
    aux_always), as the JAX package's invoke does."""
    for x in list(inputs) + list(auxs):
        if x._ctx != ctx:
            raise MXNetError(
                'operator %s: inputs on %s and %s; arrays are not moved '
                'between devices implicitly, use copyto or as_in_context'
                % (op.name, ctx, x._ctx))
    device = ctx.torch_device
    is_train = _autograd.is_training()
    op_ctx = _reg.OpContext(
        is_train=is_train,
        rng=_random.generator(device) if op.needs_rng else None,
        device=device)
    recording = _autograd.is_recording()
    data = [_autograd._enter(x) if recording else x._data for x in inputs]
    aux_data = [x._data.detach() for x in auxs]
    with torch.set_grad_enabled(recording):
        if _profiler.is_running() and _profiler.mode() == 'all':
            # a span per imperative op under mode='all' (reference
            # kAllOperator), the device synchronised inside it
            with _profiler.scope(op.name, 'imperative'):
                outs, new_auxs = op.apply(attrs, data, aux_data, op_ctx)
                _profiler.synchronize(outs)
        else:
            outs, new_auxs = op.apply(attrs, data, aux_data, op_ctx)
    outs = _owned(outs, data + aux_data)
    if op.mutable_aux and (is_train or op.aux_always):
        for holder, new in zip(auxs, new_auxs):
            holder._data = new.detach()
    if recording:
        _autograd._recorded(outs)
    return outs


def invoke(op_name, inputs, attrs, out=None):
    op = _reg.get(op_name)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    n_aux = op.num_aux
    args = inputs[:len(inputs) - n_aux] if n_aux else inputs
    auxs = inputs[len(inputs) - n_aux:] if n_aux else []
    ctx = args[0]._ctx if args else _attr_ctx(attrs)
    results = [NDArray(o, ctx) for o in _run(op, attrs, args, ctx, auxs)]
    if out is not None:
        outlist = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outlist, results):
            dst._data = src._data
        return out
    if len(results) == 1:
        return results[0]
    return results


def invoke_fn(fcompute, inputs, attrs=None, name='_fn'):
    """Run an ad-hoc torch op through the imperative machinery, recorded
    and differentiable like any registered op.

    `fcompute(attrs, in_tensors, aux_tensors, op_ctx) -> (outs, new_auxs)`
    is the canonical registry compute signature."""
    op = _reg.OpDef(name, fcompute,
                    input_names=tuple('arg%d' % i
                                      for i in range(len(inputs))),
                    needs_rng=True)
    ctx = inputs[0]._ctx if inputs else current_context()
    return [NDArray(o, ctx) for o in _run(op, dict(attrs or {}),
                                          list(inputs), ctx)]


def _attr_ctx(attrs):
    ctx = attrs.pop('ctx', None) if isinstance(attrs, dict) else None
    if isinstance(ctx, str):
        dt, rest = ctx.split('(')
        return Context(dt, int(rest.rstrip(')')))
    return ctx if ctx is not None else current_context()


# ---------------------------------------------------------------------------
# Array creation
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An array on `ctx` (default: the current context) from an NDArray,
    a numpy array, or a Python list or scalar. As in the JAX package,
    float64 and int64 sources narrow to float32 and int32 unless `dtype`
    says otherwise, and lists default to float32."""
    ctx = ctx or current_context()
    dtype = torch_dtype(dtype)
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
        return NDArray(src.to(ctx.torch_device, dtype or src.dtype,
                              copy=True), ctx)
    if isinstance(source_array, np.ndarray):
        src = source_array
    else:
        src = np.asarray(source_array, dtype=np.float32)
    if dtype is None:
        dtype = torch_dtype({np.dtype(np.float64): np.float32,
                             np.dtype(np.int64): np.int32}.get(src.dtype,
                                                               src.dtype))
    # np.array, not np.ascontiguousarray, which makes a 0-d array 1-d
    host = torch.from_numpy(np.array(src, order='C'))
    return NDArray(host.to(ctx.torch_device, dtype, copy=True), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _filled(fill, shape, ctx, dtype):
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(fill(tuple(shape), dtype=torch_dtype(dtype or 'float32'),
                        device=ctx.torch_device), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _filled(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None):
    return _filled(lambda s, **kw: torch.full(s, val, **kw), shape, ctx,
                   dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return invoke('_arange', [], {'start': start, 'stop': stop, 'step': step,
                                  'repeat': repeat, 'dtype': dtype,
                                  'ctx': str(ctx) if ctx else None})


def concatenate(arrays, axis=0, always_copy=True):
    return invoke('Concat', list(arrays),
                  {'num_args': len(arrays), 'dim': axis})


def stack(*arrays, **kwargs):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return invoke('stack', list(arrays),
                  {'num_args': len(arrays), 'axis': kwargs.get('axis', 0)})


def from_dlpack(capsule):
    return NDArray(torch.utils.dlpack.from_dlpack(capsule))


def moveaxis(tensor, source, destination):
    moved = torch.movedim(tensor._data.detach(), source, destination)
    return NDArray(moved.clone(memory_format=torch.contiguous_format),
                   tensor._ctx)


def waitall():
    """Block until all work launched on the GPUs is done (reference
    MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# Save / load: the JAX package's MXTPU001 container, byte for byte. Magic,
# entry count, then per entry its name, numpy dtype string, shape and raw
# little-endian payload, each length an int64.
# ---------------------------------------------------------------------------

_SAVE_MAGIC = b'MXTPU001'


def save(fname, data):
    """Write via a same-directory temp file + os.replace (crash-safe): a
    process killed mid-save leaves the previous file or the complete new
    one under `fname`, never a torn blob. bfloat16 arrays are written as
    float32, as the JAX package writes them."""
    from .base import atomic_file
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = list(data.items())
    else:
        items = [('', v) for v in data]
    with atomic_file(fname) as f:
        f.write(_SAVE_MAGIC)
        f.write(struct.pack('<q', len(items)))
        for name, arr in items:
            if not isinstance(arr, NDArray):
                raise TypeError('save only supports NDArray values')
            nb = name.encode('utf-8')
            a = arr.asnumpy()
            dt = np.dtype(a.dtype).str.encode('utf-8')
            f.write(struct.pack('<q', len(nb)))
            f.write(nb)
            f.write(struct.pack('<q', len(dt)))
            f.write(dt)
            f.write(struct.pack('<q', a.ndim))
            f.write(struct.pack('<%dq' % a.ndim, *a.shape))
            raw = np.ascontiguousarray(a).tobytes()
            f.write(struct.pack('<q', len(raw)))
            f.write(raw)


def _load_fail(fname, why):
    raise MXNetError('Truncated or corrupt NDArray file %s: %s '
                     '(a crash mid-write, torn copy, or not an '
                     'MXTPU params blob)' % (fname, why))


def load(fname, ctx=None):
    """Load a save() blob onto `ctx` (default: the current context).
    Every length field is validated before it is trusted, so a truncated
    or bit-flipped file raises a clear MXNetError naming the file."""
    with open(fname, 'rb') as f:
        return _load_stream(f, fname, ctx)


def load_buffer(buf, ctx=None):
    """load() of a save() blob held in memory (bytes)."""
    import io
    return _load_stream(io.BytesIO(bytes(buf)), '<buffer>', ctx)


def _load_stream(f, fname, ctx):
    """The entries of a save() blob read from the file object `f`
    (`fname` names it in errors), on `ctx`."""
    def read_exact(f, n, what):
        b = f.read(n)
        if len(b) != n:
            _load_fail(fname, 'expected %d more byte(s) for %s, file '
                       'ends after %d' % (n, what, len(b)))
        return b

    def read_len(f, what, limit=1 << 40):
        v, = struct.unpack('<q', read_exact(f, 8, what))
        if v < 0 or v > limit:
            _load_fail(fname, 'implausible %s %d' % (what, v))
        return v

    ctx = ctx or current_context()
    magic = f.read(len(_SAVE_MAGIC))
    if magic != _SAVE_MAGIC:
        _load_fail(fname, 'bad magic %r' % magic[:16])
    n = read_len(f, 'entry count', limit=1 << 32)
    items = []
    named = False
    for i in range(n):
        what = 'entry %d/%d' % (i + 1, n)
        ln = read_len(f, '%s name length' % what, limit=1 << 20)
        try:
            name = read_exact(f, ln, '%s name' % what) \
                .decode('utf-8')
        except UnicodeDecodeError as e:
            _load_fail(fname, 'bad name for %s (%s)' % (what, e))
        ld = read_len(f, '%s dtype length' % what, limit=1 << 10)
        try:
            dt = np.dtype(read_exact(f, ld, '%s dtype' % what)
                          .decode('utf-8'))
        except (TypeError, ValueError, UnicodeDecodeError) as e:
            _load_fail(fname, 'bad dtype for %s (%s)' % (what, e))
        ndim = read_len(f, '%s ndim' % what, limit=64)
        shape = struct.unpack(
            '<%dq' % ndim,
            read_exact(f, 8 * ndim, '%s shape' % what)) \
            if ndim else ()
        if any(s < 0 for s in shape):
            _load_fail(fname, 'negative dim in %s shape %s'
                       % (what, shape))
        lr = read_len(f, '%s payload length' % what)
        expect = int(np.prod(shape, dtype=np.int64)) * dt.itemsize \
            if shape else dt.itemsize
        if lr != expect:
            _load_fail(fname, '%s payload is %d bytes but shape %s '
                       'dtype %s needs %d' % (what, lr, shape,
                                              dt.name, expect))
        a = np.frombuffer(read_exact(f, lr, '%s payload' % what),
                          dtype=dt).reshape(shape)
        if name:
            named = True
        # the stored dtype exactly (no float64/int64 narrowing), in
        # the host's byte order
        host = torch.from_numpy(a.astype(dt.newbyteorder('='), copy=True))
        items.append((name, NDArray(host.to(ctx.torch_device), ctx)))
    if named:
        return dict(items)
    return [v for _, v in items]


# ---------------------------------------------------------------------------
# Operator codegen: mirror of _init_ndarray_module (reference
# python/mxnet/ndarray.py:2624)
# ---------------------------------------------------------------------------

def _make_op_func(op_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        out = kwargs.pop('out', None)
        kwargs.pop('name', None)
        inputs = [a for a in args if isinstance(a, NDArray)]
        extra = [a for a in args if not isinstance(a, NDArray)]
        if extra:
            raise TypeError(
                'Operator %s: positional arguments must be NDArrays; pass '
                'attributes as keywords (got positional %r)' % (op_name, extra))
        # named tensor kwargs (e.g. data=x, weight=w)
        try:
            names = op.input_names(kwargs)
        except (KeyError, TypeError, ValueError):
            names = None
        for nm in names or ():
            if nm in kwargs and isinstance(kwargs[nm], NDArray):
                inputs.append(kwargs.pop(nm))
        return invoke(op_name, inputs, dict(kwargs), out=out)

    fn.__name__ = op_name
    fn.__doc__ = 'Auto-generated wrapper for operator %s.' % op_name
    return fn


def _init_module():
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        if hasattr(mod, name):  # keep hand-written wrappers (zeros, ones)
            continue
        setattr(mod, name, _make_op_func(name))

    # the samplers with the reference's positional signatures
    # (python/mxnet/random.py: uniform(low, high, shape, ...)), on
    # mx.random, as random_<name> here, and as nd.random.<name>
    def uniform(low=0.0, high=1.0, shape=(), dtype=None, ctx=None, out=None):
        return invoke('_random_uniform',
                      [], {'low': low, 'high': high, 'shape': shape,
                           'dtype': dtype, 'ctx': ctx}, out=out)

    def normal(loc=0.0, scale=1.0, shape=(), dtype=None, ctx=None, out=None):
        return invoke('_random_normal',
                      [], {'loc': loc, 'scale': scale, 'shape': shape,
                           'dtype': dtype, 'ctx': ctx}, out=out)

    def gamma(alpha=1.0, beta=1.0, shape=(), dtype=None, ctx=None, out=None):
        return invoke('_random_gamma',
                      [], {'alpha': alpha, 'beta': beta, 'shape': shape,
                           'dtype': dtype, 'ctx': ctx}, out=out)

    def exponential(lam=1.0, shape=(), dtype=None, ctx=None, out=None):
        return invoke('_random_exponential',
                      [], {'lam': lam, 'shape': shape, 'dtype': dtype,
                           'ctx': ctx}, out=out)

    def poisson(lam=1.0, shape=(), dtype=None, ctx=None, out=None):
        return invoke('_random_poisson',
                      [], {'lam': lam, 'shape': shape, 'dtype': dtype,
                           'ctx': ctx}, out=out)

    def negative_binomial(k=1, p=1.0, shape=(), dtype=None, ctx=None,
                          out=None):
        return invoke('_random_negative_binomial',
                      [], {'k': k, 'p': p, 'shape': shape, 'dtype': dtype,
                           'ctx': ctx}, out=out)

    def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype=None,
                                      ctx=None, out=None):
        return invoke('_random_generalized_negative_binomial',
                      [], {'mu': mu, 'alpha': alpha, 'shape': shape,
                           'dtype': dtype, 'ctx': ctx}, out=out)

    def multinomial(data, shape=1, get_prob=False, dtype=None, out=None):
        return invoke('_sample_multinomial',
                      [data], {'shape': shape, 'get_prob': get_prob,
                               'dtype': dtype}, out=out)

    for f in (uniform, normal, gamma, exponential, poisson,
              negative_binomial, generalized_negative_binomial, multinomial):
        setattr(_random, f.__name__, f)
        setattr(mod, 'random_' + f.__name__, f)


_init_module()
random = _random


def __getattr__(name):
    """Ops registered after import resolve on first access."""
    if _reg.exists(name):
        fn = _make_op_func(name)
        setattr(sys.modules[__name__], name, fn)
        return fn
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
