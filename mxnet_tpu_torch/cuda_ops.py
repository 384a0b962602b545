"""Hand-written CUDA kernels for hot ops: the counterpart of
mxnet_tpu/pallas_ops.py.

`flash_attention` and `flash_attention_with_lse` keep the contracts of
their JAX namesakes: (batch, heads, seq, head_dim) inputs, q_len may
differ from kv_len, causal rows suffix-align to the keys (row i sees
keys up to kv_len - q_len + i), and causal with q_len > kv_len is
rejected. Both are differentiable through one `torch.autograd.Function`,
the counterpart of the custom VJPs `_flash` and `_flash_lse`: its
forward is the forward kernel (`csrc/flash_attention.cu`), its backward
the dK/dV and dQ kernels (`csrc/flash_attention_bwd.cu`), and the lse is
differentiable, its cotangent folding into D = rowsum(dO * O) - glse.
The kernels take any length, so the JAX package's tiling limits
(`_fit_block`, the dense forward fallback, the `_blocked_backward` XLA
fallback) have no counterpart here.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
versions (`flash_attention_reference`, `flash_attention_bwd_reference`);
CUDA tensors launch the kernels or raise. There is no fallback from one
to the other.
"""
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build

# Launches of each kernel, counted by its wrapper where it launches; a
# run resets them to see which kernels its path used.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DKDV_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widest head the kernels' shared-memory tiles take (csrc/*.cu, DP 256)
MAX_HEAD_DIM = 256


def _validate_attn_shapes(q, k, v, causal, fn):
    """Rectangular attention contract: same (batch, heads, head_dim),
    k/v identical, and causal requires tq <= tk (rows suffix-align to
    the keys; tq > tk would leave the leading rows with no visible key).
    Raises the same ValueErrors as mxnet_tpu.pallas_ops."""
    if k.shape != v.shape:
        raise ValueError('%s requires identical k/v shapes; got %s / %s'
                         % (fn, tuple(k.shape), tuple(v.shape)))
    if q.ndim != 4 or k.ndim != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(
            '%s wants (batch, heads, seq, head_dim) with matching '
            'batch/heads/head_dim; got q %s vs k %s'
            % (fn, tuple(q.shape), tuple(k.shape)))
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            '%s: causal masking needs q_len <= kv_len (suffix '
            'alignment); got q_len=%d kv_len=%d'
            % (fn, q.shape[2], k.shape[2]))


def _acc_dtype(dtype):
    """The type the plain versions sum in: float32, or float64 for
    float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal, scale):
    """Scaled scores q.k in the summing type, -inf past the suffix-aligned
    causal diagonal."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum('bhqd,bhkd->bhqk', q.to(acc), k.to(acc)) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        mask = rows >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float('-inf'))
    return s


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch attention with the kernel's contract: dense scores
    in float32 (float64 for float64 inputs), suffix-aligned causal mask.
    Returns (out, lse): out in q's dtype and shape, lse
    (batch*heads, q_len, 1) in the summing type."""
    b, h, tq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum('bhqk,bhkd->bhqd', torch.exp(s - lse[..., None]),
                       v.to(s.dtype)).to(q.dtype)
    return out, lse.reshape(b * h, tq, 1)


def attention_bwd_delta(o, do, glse=None):
    """D = rowsum(dO * O) - glse, (batch*heads, q_len, 1), in the summing
    type: the backward's preprocess (pallas_ops.py:_flash_bwd_impl, pass
    0), where the logsumexp cotangent glse folds in."""
    b, h, tq, _ = o.shape
    acc = _acc_dtype(o.dtype)
    dd = (do.to(acc) * o.to(acc)).sum(-1).reshape(b * h, tq, 1)
    if glse is not None:
        dd = dd - glse.to(acc).reshape(b * h, tq, 1)
    return dd


def _probs_and_dscores(q, k, v, do, lse, dd, causal, scale):
    """p = exp(s - lse) and ds = p * (dp - D), recomputed as both kernels
    do; p, ds (batch, heads, q_len, kv_len) in the summing type."""
    b, h, tq, _ = q.shape
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, h, tq, 1).to(s.dtype))
    dp = torch.einsum('bhqd,bhkd->bhqk', do.to(s.dtype), v.to(s.dtype))
    return p, p * (dp - dd.reshape(b, h, tq, 1).to(s.dtype))


def flash_attention_bwd_dkdv_reference(q, k, v, do, lse, dd, causal, scale):
    """Plain version of the dK/dV kernel: (dk, dv) in k's and v's dtype,
    from D = `attention_bwd_delta(...)`. p is rounded to dO's dtype
    before dV = p^T dO and ds to q's before dK = ds^T q * scale, as in
    pallas_ops._bwd_dkdv_kernel."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, dd, causal, scale)
    acc = p.dtype
    dv = torch.einsum('bhqk,bhqd->bhkd', p.to(do.dtype).to(acc), do.to(acc))
    dk = torch.einsum('bhqk,bhqd->bhkd', ds.to(q.dtype).to(acc),
                      q.to(acc)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, dd, causal, scale):
    """Plain version of the dQ kernel: dq in q's dtype. ds is rounded to
    k's dtype before dQ = ds k * scale, as in pallas_ops._bwd_dq_kernel."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, dd, causal, scale)
    acc = ds.dtype
    dq = torch.einsum('bhqk,bhkd->bhqd', ds.to(k.dtype).to(acc),
                      k.to(acc)) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, glse=None,
                                  causal=False, scale=None):
    """Plain PyTorch backward of `flash_attention_with_lse`: (dq, dk, dv)
    from the forward's inputs, output o and lse, the output's cotangent
    do and the lse's cotangent glse (None for zero). It recomputes p from
    lse with the kernels' formula and roundings; it is not autograd
    through the plain forward."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dd = attention_bwd_delta(o, do, glse)
    dk, dv = flash_attention_bwd_dkdv_reference(q, k, v, do, lse, dd,
                                                causal, scale)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, dd, causal,
                                          scale)
    return dq, dk, dv


def _check_kernel_inputs(q, k, v, what):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError('%s kernel takes float32 or bfloat16 q, k, v of '
                        'one dtype; got %s, %s, %s'
                        % (what, q.dtype, k.dtype, v.dtype))
    b, h, tq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError('%s kernel takes head_dim from 1 to %d; got %d'
                         % (what, MAX_HEAD_DIM, d))
    if b * h == 0 or tq == 0 or k.shape[2] == 0:
        raise ValueError('%s kernel takes no empty inputs; got q %s, k %s'
                         % (what, tuple(q.shape), tuple(k.shape)))


def _launch(entry, what, *args, device):
    """Call C entry point `entry` of the kernel library on the device's
    current stream; raise on a CUDA error."""
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check(lib, err, what)


def _flash_fwd_cuda(q, k, v, causal, scale):
    """Forward kernel on contiguous (batch, heads, seq, head_dim) CUDA
    tensors: (out, lse (batch*heads, q_len, 1) float32)."""
    global FLASH_FWD_LAUNCHES
    _check_kernel_inputs(q, k, v, 'flash attention')
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq, 1), dtype=torch.float32, device=q.device)
    _launch('mxt_flash_attention_fwd', 'flash attention forward',
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, k.shape[2], d, scale, int(causal),
            _KERNEL_DTYPES[q.dtype], device=q.device)
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def _check_bwd_inputs(q, k, v, do, lse, dd, what):
    _check_kernel_inputs(q, k, v, what)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError('%s kernel takes dO of q\'s shape and dtype; got %s '
                        '%s for q %s %s' % (what, tuple(do.shape), do.dtype,
                                            tuple(q.shape), q.dtype))
    rows = (q.shape[0] * q.shape[1], q.shape[2], 1)
    for name, t in (('lse', lse), ('D', dd)):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise TypeError('%s kernel takes %s float32 of shape %s; got %s '
                            '%s' % (what, name, rows, t.dtype,
                                    tuple(t.shape)))
    tensors = (q, k, v, do, lse, dd)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('%s kernel takes contiguous tensors' % what)
    for t in tensors:
        if t.device != q.device or t.device.type != 'cuda':
            raise ValueError('%s kernel takes tensors on one CUDA device; '
                             'got %s and %s' % (what, q.device, t.device))


def flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, dd, causal, scale):
    """The dK/dV kernel on contiguous CUDA tensors: q, dO (batch, heads,
    q_len, head_dim), k, v (batch, heads, kv_len, head_dim), lse and
    D = `attention_bwd_delta(...)` (batch*heads, q_len, 1) float32.
    Returns (dk, dv)."""
    global FLASH_BWD_DKDV_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, dd, 'flash attention dK/dV')
    b, h, tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('mxt_flash_attention_bwd_dkdv', 'flash attention dK/dV',
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, tq, k.shape[2], d, scale, int(causal),
            _KERNEL_DTYPES[q.dtype], device=q.device)
    FLASH_BWD_DKDV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd, causal, scale):
    """The dQ kernel, on the inputs of `flash_attention_bwd_dkdv_cuda`.
    Returns dq."""
    global FLASH_BWD_DQ_LAUNCHES
    _check_bwd_inputs(q, k, v, do, lse, dd, 'flash attention dQ')
    b, h, tq, d = q.shape
    dq = torch.empty_like(q)
    _launch('mxt_flash_attention_bwd_dq', 'flash attention dQ',
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            b * h, tq, k.shape[2], d, scale, int(causal),
            _KERNEL_DTYPES[q.dtype], device=q.device)
    FLASH_BWD_DQ_LAUNCHES += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    """(out, lse) of attention, differentiable in q, k and v through both
    outputs: the custom VJPs `_flash` / `_flash_lse` of pallas_ops."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        # the kernels read (batch*heads, seq, head_dim) row-major; the
        # copies are kept for the backward
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == 'cpu':
            out, lse = flash_attention_reference(q, k, v, causal, scale)
        else:
            out, lse = _flash_fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        # an unused output's cotangent arrives as None: an unused lse
        # adds nothing to D
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, glse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if do is None:
            do = torch.zeros_like(out)
        if q.device.type == 'cpu':
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, do, glse, causal, scale)
        else:
            # dO arrives as the transpose of the heads' merge
            do = do.contiguous()
            dd = attention_bwd_delta(out, do, glse).contiguous()
            dk, dv = flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, dd,
                                                   causal, scale)
            dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, dd, causal,
                                             scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """Attention that also returns the per-row logsumexp
    (batch*heads, q_len, 1) float32, the merge currency of ring
    attention. Counterpart of pallas_ops.flash_attention_with_lse; both
    outputs are differentiable."""
    _validate_attn_shapes(q, k, v, causal, 'flash_attention_with_lse')
    return _flash(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention. q: (batch, heads, q_len, head_dim); k, v:
    (batch, heads, kv_len, head_dim). Returns q's shape and dtype.
    Counterpart of pallas_ops.flash_attention; differentiable."""
    _validate_attn_shapes(q, k, v, causal, 'flash_attention')
    return _flash(q, k, v, causal, scale)[0]


def _flash(q, k, v, causal, scale):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError('flash attention: q, k, v on different devices: '
                         '%s' % sorted(map(str, devices)))
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError('flash attention runs on cuda or cpu tensors; got '
                         '%s' % q.device)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
