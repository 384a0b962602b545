"""Hand-written CUDA kernels for hot ops: the counterpart of
mxnet_tpu/pallas_ops.py.

`flash_attention` and `flash_attention_with_lse` keep the contracts of
their JAX namesakes: (batch, heads, seq, head_dim) inputs, q_len may
differ from kv_len, causal rows suffix-align to the keys (row i sees
keys up to kv_len - q_len + i), and causal with q_len > kv_len is
rejected. The kernel (`csrc/flash_attention.cu`) takes any length, so
the JAX package's tiling limits (`_fit_block`, the dense fallback) have
no counterpart here.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
version, `flash_attention_reference`; CUDA tensors launch the kernel or
raise. There is no fallback from one to the other.
"""
import math

import torch

from . import _build

# Launches of the flash-attention forward kernel, counted by the wrapper
# where it launches; a run resets it to see which kernels its path used.
FLASH_FWD_LAUNCHES = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch attention with the kernel's contract: dense scores
    in float32, suffix-aligned causal mask. Returns (out, lse): out in
    q's dtype and shape, lse (batch*heads, q_len, 1) float32."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        mask = rows >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float('-inf'))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum('bhqk,bhkd->bhqd', torch.exp(s - lse[..., None]),
                       v.float()).to(q.dtype)
    return out, lse.reshape(b * h, tq, 1)


def _flash_fwd_cuda(q, k, v, causal, scale):
    global FLASH_FWD_LAUNCHES
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError('flash attention kernel takes float32 or bfloat16 '
                        'q, k, v of one dtype; got %s, %s, %s'
                        % (q.dtype, k.dtype, v.dtype))
    if d % 8 or d > 128:
        raise ValueError('flash attention kernel takes head_dim a multiple '
                         'of 8 up to 128; got %d' % d)
    if b * h == 0 or tq == 0 or tk == 0:
        raise ValueError('flash attention kernel takes no empty inputs; '
                         'got q %s, k %s' % (tuple(q.shape), tuple(k.shape)))
    # the kernel reads (batch*heads, seq, head_dim) row-major
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq, 1), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, scale, int(causal),
            _KERNEL_DTYPES[q.dtype], stream)
    _build.check(lib, err, 'flash attention forward')
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """Attention that also returns the per-row logsumexp
    (batch*heads, q_len, 1) float32, the merge currency of ring
    attention. Counterpart of pallas_ops.flash_attention_with_lse;
    forward only for now."""
    _validate_attn_shapes(q, k, v, causal, 'flash_attention_with_lse')
    return _flash_fwd(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention. q: (batch, heads, q_len, head_dim); k, v:
    (batch, heads, kv_len, head_dim). Returns q's shape and dtype.
    Counterpart of pallas_ops.flash_attention; forward only for now."""
    _validate_attn_shapes(q, k, v, causal, 'flash_attention')
    return _flash_fwd(q, k, v, causal, scale)[0]


def _flash_fwd(q, k, v, causal, scale):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError('flash attention: q, k, v on different devices: '
                         '%s' % sorted(map(str, devices)))
    if q.device.type == 'cpu':
        return flash_attention_reference(q, k, v, bool(causal), float(scale))
    if q.device.type != 'cuda':
        raise ValueError('flash attention runs on cuda or cpu tensors; got '
                         '%s' % q.device)
    return _flash_fwd_cuda(q, k, v, bool(causal), float(scale))
