"""Rank-side code of the multi-process tests of mxnet_tpu_torch.parallel
(test_torch_mesh.py, test_torch_collectives.py,
test_torch_ring_attention.py, test_torch_transformer.py).

`run(suite, world, tmp_path, **inputs)` writes the inputs to an .npz and
runs `suite` in `world` processes on the CPU (mesh.spawn: a gloo group
over a file:// rendezvous under tmp_path, so that parallel test workers
cannot collide); each rank writes r<rank>.npz, which `run` returns as
dicts. This module imports no JAX: the tests compare its results with
the JAX package in the parent process.
"""
import os
import sys

import numpy as np
import torch

from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.parallel import collectives as C
from mxnet_tpu_torch.parallel import mesh as M
from mxnet_tpu_torch.parallel.ring_attention import (ring_attention,
                                                    ring_self_attention)
from mxnet_tpu_torch.parallel import transformer as tfm


def run(suite, world, tmp_path, **inputs):
    tmp_path = str(tmp_path)
    np.savez(os.path.join(tmp_path, 'inputs.npz'), **inputs)
    M.spawn(suite, world, os.path.join(tmp_path, 'rendezvous'),
            args=(tmp_path,), device='cpu')
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp_path, 'r%d.npz' % r)) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _inputs(tmp_path):
    with np.load(os.path.join(tmp_path, 'inputs.npz')) as z:
        return {k: z[k] for k in z.files}


def _save(tmp_path, rank, res):
    np.savez(os.path.join(tmp_path, 'r%d.npz' % rank),
             **{k: np.asarray(v.detach().numpy() if torch.is_tensor(v)
                              else v) for k, v in res.items()})


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# -- mesh --------------------------------------------------------------------

def mesh_suite(rank, tmp_path):
    res = {}
    m = M.make_mesh({'data': 1, 'sp': 2, 'model': 2}, device='cpu')
    res['axis_names'] = np.array(m.axis_names)
    res['sizes'] = np.array(list(m.shape.values()))
    res['size'] = m.size
    res['coordinate'] = np.array([m.coordinate[a] for a in m.axis_names])
    for a in m.axis_names:
        res['ranks_' + a] = np.array(m.axis_ranks(a))
    res['devices'] = np.array(m.devices)
    res['fingerprint'] = repr(M.mesh_fingerprint(m))
    res['staged'] = m.staged
    res['backend'] = m.backend
    flat = M.make_mesh(device='cpu')
    res['flat_names'] = np.array(flat.axis_names)
    res['flat_size'] = flat.shape['data']
    try:
        M.make_mesh({'data': 8}, device='cpu')
    except ValueError as e:
        res['too_big'] = str(e)
    half = M.make_mesh({'sp': 2}, device='cpu')
    res['half_on_mesh'] = half.coordinate is not None
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    res['batch_block'] = M.shard_batch(flat, x)
    res['batch_block_dim1'] = M.shard_batch(
        flat, torch.arange(16.0).reshape(2, 8), dim=1)
    res['replicated'] = M.replicate_params(
        m, [torch.full((3,), float(rank)), np.arange(2.0) + rank])[0]
    with M.use_mesh(m):
        res['current_is_m'] = M.current_mesh() is m
    res['current_after'] = M.current_mesh() is None
    _save(tmp_path, rank, res)


# -- collectives ---------------------------------------------------------------

def _grad(y, x, c):
    return torch.autograd.grad(y, x, grad_outputs=c)[0]


def collectives_suite(rank, tmp_path):
    inp = _inputs(tmp_path)
    res = {}
    d = M.make_mesh({'data': 4}, device='cpu')
    dm = M.make_mesh({'data': 2, 'model': 2}, device='cpu')
    # the JAX test_collectives_api: allreduce of a block sum
    ones = torch.ones((2, 2))
    res['api'] = ones * 0 + C.allreduce_sum(ones.sum(), 'data', mesh=d)
    x = _t(inp['X'][2 * rank:2 * rank + 2], True)
    c = _t(inp['C'][rank])              # this rank's cotangent, (2, 3)
    cf = _t(inp['CF'][rank])            # an (8, 3) one
    with M.use_mesh(d):
        y = C.allreduce_sum(x, 'data')
        res['sum'], res['sum_grad'] = y, _grad(y, x, c)
        y = C.allreduce_mean(x, 'data')
        res['mean'], res['mean_grad'] = y, _grad(y, x, c)
        y = C.copy_to_axis(x, 'data')
        res['copy'], res['copy_grad'] = y, _grad(y, x, c)
        y = C.allgather(x, 'data', 0)
        res['gather'], res['gather_grad'] = y, _grad(y, x, cf)
        y = C.allgather(x, 'data', 0, tiled=False)
        res['gather_stacked'] = y
        xf = _t(inp['X'], True)
        y = C.shard(xf, 'data', 0)
        res['shard'], res['shard_grad'] = y, _grad(y, xf, c)
        xr = _t(inp['XR'][rank], True)  # a rank's own (8, 3) partial
        y = C.reduce_scatter(xr, 'data', 0)
        res['rs'], res['rs_grad'] = y, _grad(y, xr, c)
        perm = [(j, (j + 1) % 4) for j in range(4)]
        y = C.ppermute(x, 'data', perm)
        res['pp'], res['pp_grad'] = y, _grad(y, x, c)
        y = C.ppermute(x, 'data', [(0, 1)])
        res['pp_partial'] = y
        xa = _t(inp['XA'][rank], True)  # (4, 2, 3)
        y = C.all_to_all(xa, 'data', 0, 1)
        res['a2a'] = y
        res['a2a_grad'] = _grad(y, xa, _t(inp['CA'][rank]))
        res['axis_index'] = C.axis_index('data')
        res['axis_size'] = C.axis_size('data')
        res['quant'] = C.quantized_allreduce(_t(inp['XQ'][rank]), 'data')
        plan = C.GradReducePlan([g.shape for g in inp['G'][rank]],
                                [np.float32] * len(inp['G'][rank]),
                                n_buckets=2)
        red = plan.apply([_t(g) for g in inp['G'][rank]], d)
        for i, g in enumerate(red):
            res['plan_%d' % i] = g
        res['plan_buckets'] = np.array([len(b) for b in plan.buckets])
        C.barrier_all_hosts()
    res['two_axes'] = C.allreduce_sum(x.detach(), ('data', 'model'),
                                      mesh=dm)
    res['model_only'] = C.allreduce_sum(x.detach(), 'model', mesh=dm)
    # the staged wire on the CPU: plain host buffers stand in for pinned
    # ones, and every byte is counted going out and back
    pinned = C._pinned
    C._pinned = lambda shape, dtype: torch.empty(shape, dtype=dtype)
    d.staged = True
    before = profiler.mesh_stats()
    res['staged_sum'] = C.allreduce_sum(x.detach(), 'data', mesh=d)
    res['staged_gather'] = C.allgather(x.detach(), 'data', 0, mesh=d)
    after = profiler.mesh_stats()
    C._pinned, d.staged = pinned, False
    for k in ('collectives', 'payload_bytes', 'staged_bytes'):
        res['staged_' + k] = after['mesh_' + k] - before['mesh_' + k]
    before = profiler.mesh_stats()
    C.allreduce_sum(x.detach(), 'data', mesh=d)
    after = profiler.mesh_stats()
    res['unstaged_staged_bytes'] = after['mesh_staged_bytes'] - \
        before['mesh_staged_bytes']
    for name, fn in (('row', lambda: C.row_shard_constraint(x, d)),
                     ('expert', lambda: C.expert_shard(
                         torch.zeros(4, 2), 0)),
                     ('replicate', lambda: C.replicate_constraint(x))):
        try:
            with M.use_mesh(d):
                fn()
        except Exception as e:          # the test checks what it says
            res['refusal_' + name] = str(e)
    _save(tmp_path, rank, res)


# -- ring attention --------------------------------------------------------------

def ring_suite(rank, tmp_path):
    inp = _inputs(tmp_path)
    res = {}
    mesh = M.make_mesh({'sp': 4}, device='cpu')
    g = _t(inp['g'])
    for use_flash in (False, True):
        for causal in (False, True):
            tag = '%s_%s' % ('flash' if use_flash else 'plain',
                             'causal' if causal else 'full')
            q, k, v = (_t(inp[n], True) for n in 'qkv')
            hops = profiler.mesh_stats()['mesh_ring_hops']
            out = ring_self_attention(q, k, v, mesh, 'sp', causal=causal,
                                        use_flash=use_flash)
            res['hops_' + tag] = profiler.mesh_stats()['mesh_ring_hops'] - \
                hops
            dq, dk, dv = torch.autograd.grad((out * g).sum(), (q, k, v))
            res.update({'out_' + tag: out, 'dq_' + tag: dq,
                        'dk_' + tag: dk, 'dv_' + tag: dv})
    # a ring of one hop (sp = 1): the flash forward's own output
    one = M.make_mesh({'data': 4, 'sp': 1}, device='cpu')
    q, k, v = (_t(inp[n], True) for n in 'qkv')
    out = ring_attention(q, k, v, 'sp', causal=True, use_flash=True,
                         mesh=one)
    res['one_out'] = out
    res.update(zip(('one_dq', 'one_dk', 'one_dv'), torch.autograd.grad(
        (out * g).sum(), (q, k, v))))
    # a shard's ring on [T_local, D] (no batch or heads)
    t_local = inp['q'].shape[2] // 4
    blk = slice(rank * t_local, (rank + 1) * t_local)
    q2, k2, v2 = (_t(inp[n][0, 0, blk]) for n in 'qkv')
    res['ring_2d'] = ring_attention(q2, k2, v2, 'sp', causal=True,
                                      mesh=mesh)
    # the dispatch over the current mesh, __graft_entry__ phase (j)'s shape
    qj, kj, vj = (_t(a) for a in inp['qkv_j'])
    with M.use_mesh(mesh):
        res['attn_ring'] = tfm.attention(qj, kj, vj, causal=True,
                                         impl='ring')
        res['attn_auto'] = tfm.attention(qj, kj, vj, causal=True)
        res['attn_full'] = tfm.attention(qj, kj, vj, causal=True,
                                         impl='full')
    _save(tmp_path, rank, res)


# -- the sharded LM step -----------------------------------------------------------

STEP_MESHES = {'222': {'data': 2, 'sp': 2, 'model': 2},
               '141': {'data': 1, 'sp': 4, 'model': 1}}


def _tree(inp, prefix='p_'):
    leaves = [inp[k] for k in sorted(
        (k for k in inp if k.startswith(prefix)),
        key=lambda k: int(k[len(prefix):]))]
    return tfm.tree_from_leaves([_t(a) for a in leaves])


def step_suite(rank, tmp_path):
    inp = _inputs(tmp_path)
    res = {}
    cfg0 = {k: int(inp['cfg_' + k]) for k in ('vocab', 'dim', 'heads',
                                               'layers', 'mlp_mult')}
    tokens, targets = _t(inp['tokens']), _t(inp['targets'])
    steps, lr = int(inp['steps']), float(inp['lr'])
    meshes = {tag: M.make_mesh(shape, device='cpu')
              for tag, shape in STEP_MESHES.items()}
    for tag, mesh in meshes.items():
        if mesh.coordinate is None:
            continue
        for use_flash in (False, True):
            cfg = tfm.lm_config(use_flash=use_flash, **cfg0)
            local = tfm.place_params(_tree(inp), cfg, mesh)
            if use_flash:
                res['wqkv_local_%s' % tag] = local['layers'][0]['wqkv']
                res['coord_%s' % tag] = np.array(
                    [mesh.coordinate[a] for a in mesh.axis_names])
            step = tfm.make_train_step(cfg, mesh, lr=lr)
            key = '%s_%s' % (tag, 'flash' if use_flash else 'plain')
            losses = []
            for _ in range(steps):
                loss, local = step(local, tokens, targets)
                losses.append(float(loss))
            res['loss_' + key] = np.array(losses)
            for i, w in enumerate(tfm.tree_leaves(
                    tfm.gather_params(local, cfg, mesh))):
                res['w_%s_%d' % (key, i)] = w
    if rank == 0:
        # the port's one-device step from the same tree
        cfg = tfm.lm_config(use_flash=True, **cfg0)
        model = tfm.TransformerLM(cfg, _tree(inp))
        step = tfm.make_train_step(cfg, lr=lr)
        res['loss_one'] = np.array([float(step(model, tokens.long(),
                                               targets.long()))
                                    for _ in range(steps)])
        one = {'embed': model.embed, 'ln_f': model.ln_f,
               'layers': [{k: getattr(b, k) for k in tfm._LAYER_KEYS}
                          for b in model.layers]}
        for i, w in enumerate(tfm.tree_leaves(one)):
            res['w_one_%d' % i] = w
    _save(tmp_path, rank, res)


# -- chip_smoke.py's float32 update gate against planted faults ------------------

GATE_MESH = {'data': 1, 'sp': 2, 'model': 2}
GATE_FAULTS = ('clean', 'past_dkdv_dropped', 'grads_not_reduced',
               'update_skipped')


def _drop_past_dkdv(hop_backward):
    """A ring backward whose past (unmasked) hops lose their dK and dV."""
    def broken(q, kb, vb, do, lse, dd, diag, scale, use_flash):
        dq, dk, dv = hop_backward(q, kb, vb, do, lse, dd, diag, scale,
                                  use_flash)
        if not diag:
            dk, dv = torch.zeros_like(dk), torch.zeros_like(dv)
        return dq, dk, dv
    return broken


def gate_suite(rank, tmp_path):
    """One float32 step of the LM at GATE_MESH, the ring on the flash
    kernels' plain versions, as it is and with each fault of GATE_FAULTS
    planted; rank 0 adds the one-device step from the same tree."""
    # the module (the package's `ring_attention` is the function)
    ra = sys.modules['mxnet_tpu_torch.parallel.ring_attention']
    inp = _inputs(tmp_path)
    res = {}
    cfg = tfm.lm_config(use_flash=True, **{
        k: int(inp['cfg_' + k]) for k in ('vocab', 'dim', 'heads', 'layers',
                                          'mlp_mult')})
    tokens, targets = _t(inp['tokens']), _t(inp['targets'])
    lr = float(inp['lr'])
    mesh = M.make_mesh(GATE_MESH, device='cpu')
    hop_backward, apply = ra._hop_backward, C.GradReducePlan.apply
    for fault in GATE_FAULTS:
        if fault == 'past_dkdv_dropped':
            ra._hop_backward = _drop_past_dkdv(hop_backward)
        elif fault == 'grads_not_reduced':
            C.GradReducePlan.apply = lambda self, grads, *a, **k: grads
        try:
            step = tfm.make_train_step(
                cfg, mesh, lr=0.0 if fault == 'update_skipped' else lr)
            _, local = step(tfm.place_params(_tree(inp), cfg, mesh),
                            tokens, targets)
        finally:
            ra._hop_backward, C.GradReducePlan.apply = hop_backward, apply
        for i, w in enumerate(tfm.tree_leaves(
                tfm.gather_params(local, cfg, mesh))):
            res['w_%s_%d' % (fault, i)] = w
    if rank == 0:
        model = tfm.TransformerLM(cfg, _tree(inp))
        tfm.make_train_step(cfg, lr=lr)(model, tokens.long(),
                                        targets.long())
        for i, w in enumerate(model.parameters()):
            res['w_one_%d' % i] = w
    _save(tmp_path, rank, res)
