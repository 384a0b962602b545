"""Attention on one device: the counterpart of
mxnet_tpu/parallel/ring_attention.py:full_attention.

On one device the JAX LM's ring is a single hop, and its logsumexp merge
is the identity (w = exp(lse - lse) = 1), so the port's LM calls
`full_attention` directly. The ring across devices waits for the
multi-GPU slice.
"""
import math

import torch

from .. import cuda_ops


def full_attention(q, k, v, causal=False, scale=None, use_flash=False):
    """Single-device attention; q_len may differ from kv_len
    (cross-attention / KV-cache decode: causal rows suffix-align to the
    keys). use_flash=True routes (B, H, Tq, D) inputs through the flash
    kernel (cuda_ops.flash_attention), under the same predicate as the
    JAX package; otherwise scores and softmax are taken densely in the
    inputs' dtype."""
    if use_flash and q.ndim == 4 and k.shape == v.shape and \
            q.shape[:2] == k.shape[:2] and q.shape[-1] == k.shape[-1] \
            and (not causal or q.shape[2] <= k.shape[2]):
        return cuda_ops.flash_attention(q, k, v, causal=causal, scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if causal and q.shape[-2] > k.shape[-2]:
        raise ValueError(
            'full_attention: causal masking needs q_len <= kv_len '
            '(suffix alignment — the leading rows would see no keys); '
            'got q_len=%d kv_len=%d' % (q.shape[-2], k.shape[-2]))
    s = torch.einsum('...qd,...kd->...qk', q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        # suffix alignment: query row i attends keys <= tk - tq + i
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        mask = rows >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float('-inf'))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('...qk,...kd->...qd', p, v)
