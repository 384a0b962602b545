"""Ring attention across the ranks of a sequence axis, and attention on
one device: the counterpart of mxnet_tpu/parallel/ring_attention.py.

The sequence is sharded over a mesh axis; keys and values rotate around
the ring (each rank sends its block to the previous rank, so at hop j
rank i holds block (i + j) % n) while each rank accumulates its queries'
attention over the blocks it sees. The plain ring is the JAX `_block_attn`
online softmax over the hops; with `use_flash` every hop on the card runs
the hand-written flash forward with its logsumexp
(`cuda_ops._flash_fwd_cuda`) and the hops merge by lse in float32, as
JAX's `_ring_attention_flash` does. Under causal masking a hop whose
block lies after this rank's queries runs nothing, so sp-rank i runs
i + 1 hops.

The whole ring is one `torch.autograd.Function`: if each hop's transfer
were an autograd node of its own, a rank whose received block feeds
nothing (sp-rank 0 under causal masking) would never run that node's
backward while its neighbour waits for it. The backward is a ring of its
own: the blocks rotate again, and each block's dK and dV accumulate in
float32 as they travel with it, one more transfer bringing them home;
every rank makes the same sends and receives whatever its hops are.
Each hop's gradient comes from the dK/dV and dQ kernels
(`cuda_ops.flash_attention_bwd_dkdv_cuda`, `..._dq_cuda`) on the card,
or their plain versions, with the merged lse and D = rowsum(dO * O) of
the merged output: p = exp(s - lse) is then each key's share of the
whole softmax row. The last hop's blocks are not sent on (JAX's scan
sends and drops them).

On a CPU tensor a hop takes the kernels' plain versions
(`cuda_ops.flash_attention_reference` and the backward references); on
a CUDA tensor it launches the kernels or raises.
"""
import math

import torch

from .. import cuda_ops, profiler
from . import collectives


def _merge_lse(o_u, m, l, o_new, lse_new):
    """Fold one hop's normalised output and lse into the running
    (unnormalised output, max, weight sum), float32 (JAX :96-103)."""
    m2 = torch.maximum(m, lse_new)
    safe_m2 = torch.where(torch.isfinite(m2), m2, torch.zeros_like(m2))
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m2),
                       torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse_new), torch.exp(lse_new - safe_m2),
                    torch.zeros_like(lse_new))
    return o_u * corr + o_new * w, m2, l * corr + w


def _block_attn(q, k, v, scale, q_pos, k_pos, causal, m, l, o):
    """One block's contribution with online-softmax accumulation (JAX
    _block_attn): m, l, o float32, scores in the inputs' type."""
    s = torch.einsum('...qd,...kd->...qk', q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask, float('-inf'))
    m_new = torch.maximum(m, s.amax(dim=-1).float())
    safe_m = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    if causal:
        p = p.masked_fill(~mask, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum('...qk,...kd->...qd', p, v)
    return m_new, l_new, o_new


def _hop_kind(my_idx, k_idx, causal):
    """'full', 'diag' or None (a block after the queries: no work)."""
    if not causal or k_idx < my_idx:
        return 'full'
    return 'diag' if k_idx == my_idx else None


def _flash_hop(q, kb, vb, diag, scale):
    if q.device.type == 'cpu':
        return cuda_ops.flash_attention_reference(q, kb, vb, diag, scale)
    return cuda_ops._flash_fwd_cuda(q, kb, vb, diag, scale)


def _rotate(mesh, axis, *blocks):
    """Every block one rank back around the ring (rank i gets rank
    i + 1's)."""
    n = mesh.axis_size(axis)
    perm = tuple((j, (j - 1) % n) for j in range(n))
    return [collectives._ppermute(b, mesh, axis, perm) for b in blocks]


def ring_forward(q, k, v, mesh, axis, causal, scale, use_flash):
    """The ring's forward on contiguous [B, H, T_local, D] shards:
    (out in q's dtype, merged lse (B*H, T_local, 1) float32), no
    autograd."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    b, h, t, d = q.shape
    if use_flash:
        o_u = torch.zeros((b * h, t, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b * h, t, 1), float('-inf'), device=q.device)
        l = torch.zeros((b * h, t, 1), device=q.device)
    else:
        q_pos = me * t + torch.arange(t, device=q.device)
        m = torch.full(q.shape[:-1], float('-inf'), device=q.device)
        l = torch.zeros(q.shape[:-1], device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for j in range(n):
        k_idx = (me + j) % n
        kind = _hop_kind(me, k_idx, causal)
        if kind is not None:
            profiler.add_mesh_stats(ring_hops=1)
            if use_flash:
                out, lse = _flash_hop(q, kb, vb, kind == 'diag', scale)
                o_u, m, l = _merge_lse(
                    o_u, m, l, out.float().reshape(b * h, t, d), lse)
            else:
                k_pos = k_idx * t + torch.arange(t, device=q.device)
                m, l, o = _block_attn(q, kb, vb, scale, q_pos, k_pos,
                                      causal, m, l, o)
        if j < n - 1:
            kb, vb = _rotate(mesh, axis, kb, vb)
    if use_flash:
        out = (o_u / torch.clamp(l, min=1e-37)).reshape(q.shape)
        lse = m + torch.log(l)
    else:
        out = o / torch.clamp(l, min=1e-37)[..., None]
        lse = (m + torch.log(l)).reshape(b * h, t, 1)
    return out.to(q.dtype), lse


def _hop_backward(q, kb, vb, do, lse, dd, diag, scale, use_flash):
    """(dq, dk, dv) of one hop from the merged lse and D: the kernels on
    the card with use_flash, their plain versions otherwise."""
    if use_flash and q.device.type == 'cuda':
        dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(
            q, kb, vb, do, lse, dd, diag, scale)
        dq = cuda_ops.flash_attention_bwd_dq_cuda(q, kb, vb, do, lse, dd,
                                                  diag, scale)
    else:
        dk, dv = cuda_ops.flash_attention_bwd_dkdv_reference(
            q, kb, vb, do, lse, dd, diag, scale)
        dq = cuda_ops.flash_attention_bwd_dq_reference(q, kb, vb, do, lse,
                                                       dd, diag, scale)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """Ring attention over `axis`, differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, use_flash):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ring_forward(q, k, v, mesh, axis, causal, scale,
                                use_flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale, use_flash)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, use_flash = ctx.args
        n, me = mesh.axis_size(axis), mesh.axis_index(axis)
        do = do.contiguous()
        dd = cuda_ops.attention_bwd_delta(out, do).float().contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        for j in range(n):
            kind = _hop_kind(me, (me + j) % n, causal)
            if kind is not None:
                g_q, g_k, g_v = _hop_backward(q, kb, vb, do, lse, dd,
                                              kind == 'diag', scale,
                                              use_flash)
                dq += g_q.float()
                dkb += g_k.float()
                dvb += g_v.float()
            if j < n - 1:
                kb, vb, dkb, dvb = _rotate(mesh, axis, kb, vb, dkb, dvb)
            elif n > 1:
                dkb, dvb = _rotate(mesh, axis, dkb, dvb)   # home
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None, None, None, None)


def ring_attention(q, k, v, axis_name, causal=False, scale=None,
                   use_flash=False, mesh=None):
    """Attention over a sequence sharded on `axis_name` of `mesh` (or the
    current mesh). q, k, v: this rank's [B, H, T_local, D] shards;
    returns its [B, H, T_local, D] output shard. use_flash runs each hop
    through the flash kernels (4-D shards, one dtype)."""
    mesh = collectives._mesh(mesh)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash and q.ndim != 4:
        raise ValueError('use_flash needs [B, H, T_local, D] shards; got '
                         '%s' % (tuple(q.shape),))
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError('ring_attention takes q, k, v of one shape; got '
                         '%s %s %s' % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    shape = q.shape
    if q.ndim != 4:     # [..., T_local, D] as [1, ..., T_local, D]
        q, k, v = (t.reshape(1, -1, *shape[-2:]) for t in (q, k, v))
    out = _Ring.apply(q, k, v, mesh, axis_name, bool(causal), float(scale),
                      bool(use_flash))
    return out.reshape(shape)


def ring_self_attention(q, k, v, mesh, seq_axis='sp', causal=False,
                        scale=None, use_flash=False):
    """Global [B, H, T, D] arrays, T sharded over `seq_axis`: each rank
    takes its T block, runs the ring and all-gathers the output along T
    (JAX's out_specs), so every rank returns the whole output."""
    local = [collectives.shard(t, seq_axis, 2, mesh=mesh) for t in (q, k, v)]
    out = ring_attention(*local, seq_axis, causal=causal, scale=scale,
                         use_flash=use_flash, mesh=mesh)
    return collectives.allgather(out, seq_axis, 2, mesh=mesh)


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
