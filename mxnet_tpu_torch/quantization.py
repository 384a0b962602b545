"""Shared low-precision core, the counterpart of mxnet_tpu/quantization.py:
symmetric int8, uint8-affine contrib semantics, calibration, weight
quantization for the serving engine, and the error-feedback wire
format.

int8 is symmetric: the range +-max(|a|) maps onto +-127 (the -128 code
is never produced, so negation stays exact). uint8 is an affine map of
[min_range, max_range] onto [0, 255].

Rounding is half away from zero, as the reference's Sign(x) * Min(|x| *
127/range + 0.5, 127): floor(|x| * inv + 0.5) with its sign, never
`torch.round`, which rounds half to even. Every step is one IEEE float32
operation in the same order as the JAX package's numpy code (max, the
division by 127, the reciprocal, the product, the +0.5, the floor), so
codes and scales equal the JAX package's bit for bit, exact ties
included, on numpy arrays and on torch tensors alike (CPU or CUDA).

The `*_math` helpers take and return whatever their input is: numpy
arrays (the host wire and paging paths) or torch tensors.
`quantize_weights` and `dequantize_weight`, the serving engine's, work
on torch tensors where they lie. A bfloat16 array is held on the host
as its bits (numpy uint16), the bytes the JAX package's ml_dtypes
arrays hold; the port needs no ml_dtypes.
"""
import os
import threading

import numpy as np
import torch

from .base import MXNetError

# int8 symmetric code range: +-127 (-128 is never produced, so
# |deq(q)| <= real_range exactly)
INT8_RANGE = 127.0
UINT8_RANGE = 255.0

# estimate of a model's resident-byte ratio after weight quantization
# (biases, aux and scales stay fp), for budget pre-enforcement
EST_BYTES_RATIO = {'int8': 0.30, 'bf16': 0.55}


def _is_torch(a):
    return isinstance(a, torch.Tensor)


def _f32(x, like):
    """x as float32 in the array world of `like`."""
    if _is_torch(like):
        return torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return np.float32(x) if np.isscalar(x) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# bfloat16 on the host: its bits in numpy uint16
# ---------------------------------------------------------------------------

def bf16_bits(a):
    """float32 numpy values rounded to bfloat16 (nearest, ties to even,
    as ml_dtypes and torch round), as their uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits):
    """uint16 bfloat16 bits (or an ml_dtypes bfloat16 array) to
    float32."""
    bits = np.asarray(bits)
    if bits.dtype.name == 'bfloat16':
        bits = bits.view(np.uint16)
    return (bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# symmetric int8 (the reference's signed quantize mode)
# ---------------------------------------------------------------------------

def _amax(a, axis):
    if _is_torch(a):
        x = a.abs().to(torch.float32)
        if axis is None:
            return x.max()
        red = tuple(i for i in range(a.ndim) if i != axis)
        return x.amax(dim=red)
    if axis is None:
        return np.max(np.abs(a))
    red = tuple(i for i in range(a.ndim) if i != axis)
    return np.max(np.abs(a), axis=red)


def symmetric_scale(a, axis=None, percentile=None):
    """Per-tensor (axis=None) or per-channel (axis=int) symmetric
    dequantization scale: real_range / 127, the range the max-abs over
    the reduced axes. A zero range gives scale 0.0, which quantizes to
    code 0 and dequantizes to exact zeros. `percentile` (e.g. 99.99)
    clips the range at that percentile of |a| (numpy arrays only)."""
    if axis is None and (a.numel() if _is_torch(a)
                         else getattr(a, 'size', 1)) == 0:
        # an empty bucket has no range: scale 0 round-trips it exactly
        return np.float32(0.0)
    if percentile is not None and not _is_torch(a):
        if axis is None:
            amax = np.percentile(np.abs(a), float(percentile))
        else:
            red = tuple(i for i in range(a.ndim) if i != axis)
            amax = np.percentile(np.abs(a), float(percentile), axis=red)
        return np.asarray(amax / INT8_RANGE, np.float32)
    amax = _amax(a, axis)
    if _is_torch(amax):
        return (amax / INT8_RANGE).to(torch.float32)
    return (amax / INT8_RANGE).astype(np.float32)


def quantize_int8_math(a, scale):
    """x -> int8 codes under symmetric `scale` (broadcastable), rounding
    half away from zero, saturating at +-127."""
    if _is_torch(a):
        s = torch.as_tensor(scale, dtype=torch.float32, device=a.device)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        inv = torch.where(s > 0, 1.0 / safe, torch.zeros_like(s))
        x = a.to(torch.float32)
        q = torch.sign(x) * torch.clamp(
            torch.floor(x.abs() * inv + 0.5), max=INT8_RANGE)
        return q.to(torch.int8)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0),
                   0.0).astype(np.float32)
    q = np.sign(a) * np.minimum(np.floor(np.abs(a) * inv + 0.5),
                                INT8_RANGE)
    return q.astype(np.int8)


def dequantize_int8_math(q, scale):
    """int8 codes -> float32 under symmetric `scale`."""
    if _is_torch(q):
        return q.to(torch.float32) * torch.as_tensor(
            scale, dtype=torch.float32, device=q.device)
    return q.astype(np.float32) * scale


def _channel_shape(a, axis):
    shape = [1] * a.ndim
    shape[axis] = -1
    return shape


def quantize_int8(a, axis=None, percentile=None):
    """(codes, scale) of one array; `axis` selects per-channel scales
    (the weight convention: axis 0 = output channels); `percentile`
    clips the range (see symmetric_scale)."""
    s = symmetric_scale(a, axis=axis, percentile=percentile)
    if axis is None:
        return quantize_int8_math(a, s), s
    return quantize_int8_math(a, s.reshape(_channel_shape(a, axis))), s


def dequantize_int8(q, scale, axis=None, dtype=np.float32):
    """Invert quantize_int8 (scale in the per-tensor or per-channel form
    it returned). `dtype` is a numpy dtype for numpy codes, a torch dtype
    (or a name) for torch codes."""
    if axis is not None and getattr(scale, 'ndim', 0) == 1:
        scale = scale.reshape(_channel_shape(q, axis))
    out = dequantize_int8_math(q, scale)
    if _is_torch(out):
        from .base import torch_dtype
        return out.to(torch_dtype(dtype))
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# uint8 affine (the reference's default contrib mode)
# ---------------------------------------------------------------------------

def quantize_uint8_math(a, min_range, max_range):
    """Affine [min_range, max_range] -> [0, 255]; a zero range maps
    everything to code 0."""
    if _is_torch(a):
        lo = _f32(min_range, a)
        span = _f32(max_range, a) - lo
        scale = torch.where(span > 0, UINT8_RANGE / torch.where(
            span > 0, span, torch.ones_like(span)), torch.zeros_like(span))
        q = torch.clamp(torch.floor((a - lo) * scale + 0.5), 0.0,
                        UINT8_RANGE)
        return q.to(torch.uint8)
    span = max_range - min_range
    scale = np.where(span > 0, UINT8_RANGE /
                     np.where(span > 0, span, 1.0), 0.0)
    q = np.clip(np.floor((a - min_range) * scale + 0.5), 0.0,
                UINT8_RANGE)
    return q.astype(np.uint8)


def dequantize_uint8_math(q, min_range, max_range):
    scale = (max_range - min_range) / UINT8_RANGE
    if _is_torch(q):
        return q.to(torch.float32) * scale + min_range
    return q.astype(np.float32) * scale + min_range


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def calibrate(batches, mode='minmax', percentile=99.99):
    """Observed (min, max) range over host batches: 'minmax' the exact
    extremes, 'percentile' the range covering `percentile` percent of
    the values (outliers clipped). Returns python floats."""
    if mode not in ('minmax', 'percentile'):
        raise MXNetError("calibrate: mode must be 'minmax' or "
                         "'percentile', got %r" % (mode,))
    batches = list(batches)
    if not batches:
        raise MXNetError('calibrate: no batches given')
    if mode == 'minmax':
        lo = min(float(np.min(np.asarray(b))) for b in batches)
        hi = max(float(np.max(np.asarray(b))) for b in batches)
        return lo, hi
    flat = np.concatenate([np.asarray(b, np.float32).reshape(-1)
                           for b in batches])
    p = float(percentile)
    lo = float(np.percentile(flat, 100.0 - p))
    hi = float(np.percentile(flat, p))
    if hi < lo:
        lo, hi = hi, lo
    return lo, hi


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

_FLOAT_NAMES = ('float32', 'bfloat16', 'float16')


def _dtype_name(dtype):
    from .base import dtype_name
    return dtype_name(dtype)


class QuantConfig(object):
    """Weight-quantization policy of the serving engine.

    dtype : 'int8' or 'bf16'
        Storage dtype of quantized weights: int8 with symmetric scales,
        or a plain cast to bfloat16 (no scales).
    per_channel : bool
        int8 scales per output channel (axis 0, the FC (hidden, in) and
        Conv (filters, C, H, W) convention) instead of per tensor.
    min_size / min_ndim : int
        Only arrays with >= min_size elements and >= min_ndim dims are
        quantized (matmul and conv weights); biases, BatchNorm gammas and
        other small vectors stay fp.
    parity_tol : float
        The engine's build gate: max |fp - quant| over the calibration
        batch's outputs, relative to the largest |fp| output, above which
        the engine refuses to build (QuantParityError).
    calibration / percentile :
        How the int8 range is taken ('minmax' or 'percentile').

    Which sources are quantized: float32 arrays for both dtypes, as in
    the JAX package; and for int8 also bfloat16 and float16 arrays, the
    weights of a model that computes in 16 bits (the port's bf16
    ResNet-50), which the JAX package's engine would leave as they are.
    Their scales are taken on the float32 values of the 16-bit ones.
    """

    def __init__(self, dtype='int8', per_channel=True, min_size=1024,
                 min_ndim=2, parity_tol=0.05, calibration='minmax',
                 percentile=99.99):
        if dtype not in ('int8', 'bf16'):
            raise MXNetError("QuantConfig: dtype must be 'int8' or "
                             "'bf16', got %r" % (dtype,))
        self.dtype = dtype
        self.per_channel = bool(per_channel)
        self.min_size = int(min_size)
        self.min_ndim = int(min_ndim)
        self.parity_tol = float(parity_tol)
        self.calibration = calibration
        self.percentile = float(percentile)

    # env spellings that mean "no quantization"
    OFF_VALUES = ('', '0', 'off', 'none', 'fp32', 'false')

    @classmethod
    def resolve(cls, value):
        """None -> None, a QuantConfig passes through, 'int8'/'bf16'
        build a default config."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(dtype=value)
        raise MXNetError('quantize= expects a QuantConfig or '
                         "'int8'/'bf16', got %r" % (value,))

    @classmethod
    def from_env(cls, env='MXNET_TPU_SERVE_QUANTIZE'):
        """The env-default config, or None when unset or off."""
        v = os.environ.get(env, '').strip().lower()
        if v in cls.OFF_VALUES:
            return None
        return cls.resolve(v)

    def wants(self, shape, dtype):
        """Should an array of (shape, dtype) be quantized under this
        config? (See the class docstring for the source dtypes.)"""
        size = int(np.prod(shape)) if len(shape) else 1
        name = _dtype_name(dtype)
        ok = name == 'float32' or (self.dtype == 'int8' and
                                   name in _FLOAT_NAMES)
        return ok and len(shape) >= self.min_ndim and size >= self.min_size

    def est_ratio(self):
        """Resident-byte ratio estimate against fp32 (EST_BYTES_RATIO)."""
        return EST_BYTES_RATIO[self.dtype]

    def key(self, names=()):
        """Hashable identity for program cache keys: two engines over the
        same graph with different quantization never share a serve
        program."""
        return ('quant', self.dtype, self.per_channel, tuple(names))

    def describe(self):
        return {'dtype': self.dtype, 'per_channel': self.per_channel,
                'min_size': self.min_size,
                'parity_tol': self.parity_tol}


class QuantParityError(MXNetError):
    """The fp-against-quantized parity gate at engine build failed: the
    quantized outputs differ from the fp ones beyond
    QuantConfig.parity_tol on the calibration batch. The engine is not
    built."""

    def __init__(self, model, measured, tol):
        self.measured = float(measured)
        self.tol = float(tol)
        super(QuantParityError, self).__init__(
            'int8 parity gate failed for %s: relative output '
            'difference %.4g > parity_tol %.4g on the calibration '
            'batch; serve this model fp, or loosen '
            'QuantConfig(parity_tol=) deliberately'
            % (model, self.measured, self.tol))


# ---------------------------------------------------------------------------
# weight-dict helpers (the serving engine's)
# ---------------------------------------------------------------------------

def quantize_weights(arrays, config):
    """Split a {name: tensor} dict (torch tensors, or numpy arrays, which
    are taken to torch) by config.wants: returns (quantized,
    passthrough_names), quantized mapping name -> (codes, scale,
    orig_dtype_name), each a tensor on its source's device; scale is None
    for bf16, else a float32 scalar (per tensor) or a 1-D vector (per
    channel, axis 0), in the config's calibration mode."""
    out = {}
    passthrough = []
    percentile = config.percentile \
        if config.calibration == 'percentile' else None
    for name, a in arrays.items():
        if not _is_torch(a):
            a = torch.from_numpy(np.ascontiguousarray(a))
        orig = _dtype_name(a.dtype)
        if not config.wants(tuple(a.shape), orig):
            passthrough.append(name)
            continue
        if config.dtype == 'bf16':
            out[name] = (a.to(torch.bfloat16), None, orig)
            continue
        axis = 0 if config.per_channel else None
        if percentile is not None:
            # np.percentile's interpolation, on the host
            host = a.detach().float().cpu().numpy()
            s = torch.from_numpy(np.asarray(symmetric_scale(
                host, axis=axis, percentile=percentile))).to(a.device)
            shape = _channel_shape(a, axis) if axis is not None else ()
            q = quantize_int8_math(a, s.reshape(shape))
        else:
            q, s = quantize_int8(a, axis=axis)
        out[name] = (q, s, orig)
    return out, passthrough


def dequantize_weight(q, scale, config, dtype=torch.float32):
    """Invert one quantize_weights entry to a tensor of `dtype`."""
    from .base import torch_dtype
    if config.dtype == 'bf16':
        return q.to(torch_dtype(dtype))
    axis = 0 if config.per_channel else None
    return dequantize_int8(q, scale, axis=axis, dtype=dtype)


def quantized_nbytes(quantized, passthrough_arrays=()):
    """Bytes of a quantize_weights result (codes and scales), plus any
    passthrough arrays."""
    def nbytes(a):
        if _is_torch(a):
            return a.numel() * a.element_size()
        return np.asarray(a).nbytes
    total = 0
    for q, s, _dt in quantized.values():
        total += nbytes(q) + (0 if s is None else nbytes(s))
    for a in passthrough_arrays:
        total += nbytes(a)
    return total


# ---------------------------------------------------------------------------
# collective wire format (for dist.allreduce's int8/bf16 buckets)
# ---------------------------------------------------------------------------

WIRE_DTYPES = ('fp32', 'bf16', 'int8')


def wire_dtype_from_env(explicit=None, env='MXNET_TPU_DIST_WIRE_DTYPE'):
    """Resolve a wire dtype: the explicit value, else the env knob, else
    fp32 (identity)."""
    v = explicit if explicit is not None else \
        os.environ.get(env, '').strip().lower()
    if v in ('', 'fp32', 'float32', '0'):
        return 'fp32'
    if v in ('bf16', 'bfloat16'):
        return 'bf16'
    if v in ('int8', 'i8'):
        return 'int8'
    raise MXNetError('wire dtype must be fp32/bf16/int8, got %r' % (v,))


class WireCodec(object):
    """Stateful encoder of one allreduce stream: packs float arrays into
    wire payloads with one scale per bucket (array), carrying the
    quantization error forward as an error-feedback residual, as the JAX
    package's. Host numpy in and out; a bf16 payload is the uint16 bits,
    byte for byte the JAX package's ml_dtypes payload.

    int8:  int8 codes + one float32 scale per bucket.
    bf16:  bfloat16 bits, no scales, residual still carried.
    fp32:  identity (no residual, no scales).
    """

    def __init__(self, wire='int8', error_feedback=True):
        if wire not in WIRE_DTYPES:
            raise MXNetError('WireCodec: wire must be one of %s'
                             % (WIRE_DTYPES,))
        self.wire = wire
        self.error_feedback = bool(error_feedback) and wire != 'fp32'
        self._residual = None
        self._shapes = None
        # encode mutates the residual: callers of one stream serialize
        self.lock = threading.Lock()

    def _reset_if_changed(self, arrays):
        shapes = tuple((tuple(a.shape), np.dtype(a.dtype).str)
                       for a in arrays)
        if shapes != self._shapes:
            self._shapes = shapes
            self._residual = [np.zeros(a.shape, np.float32)
                              for a in arrays] \
                if self.error_feedback else None

    def encode(self, arrays):
        """arrays (list of numpy float arrays) -> (payloads, scales); the
        scales a float32 vector (one per bucket; empty for bf16/fp32).
        Mutates the residual."""
        arrays = [np.asarray(a) for a in arrays]
        if self.wire == 'fp32':
            return arrays, np.zeros((0,), np.float32)
        self._reset_if_changed(arrays)
        payloads, scales = [], []
        for i, a in enumerate(arrays):
            x = a.astype(np.float32)
            if self.error_feedback:
                x = x + self._residual[i]
            if self.wire == 'bf16':
                q = bf16_bits(x)
                deq = bf16_to_f32(q)
            else:
                s = symmetric_scale(x)
                q = quantize_int8_math(x, s)
                deq = dequantize_int8_math(q, s)
                scales.append(float(s))
            if self.error_feedback:
                self._residual[i] = x - deq
            payloads.append(q)
        return payloads, np.asarray(scales, np.float32)

    def decode(self, payloads, scales, dtypes):
        """Invert encode (scales as the peer produced them; `dtypes` the
        original dtypes to cast back to)."""
        if self.wire == 'fp32':
            return [np.asarray(p) for p in payloads]
        out = []
        for i, p in enumerate(payloads):
            p = np.asarray(p)
            if self.wire == 'bf16':
                v = bf16_to_f32(p)
            else:
                v = dequantize_int8_math(p, np.float32(scales[i]))
            out.append(v.astype(dtypes[i]))
        return out

    def residual_norm(self):
        """L2 norm of the carried residual (0.0 before traffic or for
        fp32)."""
        if not self._residual:
            return 0.0
        return float(np.sqrt(sum(float(np.vdot(r, r))
                                 for r in self._residual)))

    @staticmethod
    def wire_nbytes(payloads, scales):
        return sum(np.asarray(p).nbytes for p in payloads) + \
            np.asarray(scales).nbytes

    @staticmethod
    def fp32_nbytes(arrays):
        return sum(int(np.prod(a.shape)) * 4 for a in arrays)


def encode_ring_chunk(x, wire):
    """Stateless fresh-scale encode of one ring chunk (the ring's
    travelling partial sums carry no residual). Returns (payload,
    scale); scale is None for fp32/bf16."""
    x = np.asarray(x, np.float32)
    if wire == 'fp32':
        return x, None
    if wire == 'bf16':
        return bf16_bits(x), None
    s = symmetric_scale(x)
    return quantize_int8_math(x, s), float(s)


def decode_ring_chunk(payload, scale, wire):
    """Invert encode_ring_chunk back to float32."""
    p = np.asarray(payload)
    if wire == 'fp32':
        return p.astype(np.float32, copy=False)
    if wire == 'bf16':
        return bf16_to_f32(p)
    return dequantize_int8_math(p, np.float32(0.0 if scale is None
                                              else scale))
