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
    # a sparse table's stripe over the data axis: rows [r*s, (r+1)*s)
    res['row_stripe'] = C.row_shard_constraint(
        torch.arange(20.0).reshape(10, 2), d)
    # the expert-parallel pair over the data axis: this rank's experts of
    # the sum of every rank's buffer, and every rank's blocks joined back
    buf = torch.arange(8.0).reshape(4, 2) * (rank + 1)
    with M.use_mesh(d):
        block = C.expert_shard(buf.requires_grad_(), 0)
        back = C.expert_gather(block, 4)
        res['expert_range'] = np.array(C.expert_range(4))
        res['replicate_is_x'] = C.replicate_constraint(x) is x
    res['expert_block'] = block
    res['expert_back'] = back
    res['expert_grad'], = torch.autograd.grad(
        (back * (rank + 1)).sum(), buf)
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


# -- Module data parallelism and ZeRO-1 (test_torch_module_dp.py,
# test_torch_zero.py) --------------------------------------------------------
# The nets, parameters and steps are written once for either package
# (`pkg` is mxnet_tpu_torch here, the JAX package in the parent).

DP_BATCH, DP_FEAT, DP_CLASSES = 16, 12, 5
DP_IMAGE = (3, 4, 4)
DP_OPT = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}


def dp_mlp(pkg, dtype='float32', normalization='null', use_ignore=False,
           dropout=0.0):
    S = pkg.sym
    data = S.Variable('data')
    x = data if dtype == 'float32' else S.Cast(data, dtype=dtype)
    if dropout:
        x = S.Dropout(x, p=dropout)
    fc1 = S.FullyConnected(x, name='fc1', num_hidden=24)
    act = S.Activation(fc1, act_type='relu')
    fc2 = S.FullyConnected(act, name='fc2', num_hidden=DP_CLASSES)
    if dtype != 'float32':
        fc2 = S.Cast(fc2, dtype='float32')
    return S.SoftmaxOutput(fc2, name='softmax', normalization=normalization,
                           use_ignore=use_ignore, ignore_label=-1)


def dp_bn_net(pkg, dtype='float32'):
    """Two conv -> BatchNorm pairs (the pair route in bfloat16) and a
    classifier."""
    S = pkg.sym
    data = S.Variable('data')
    x = data if dtype == 'float32' else S.Cast(data, dtype=dtype)
    x = S.Convolution(x, name='c1', num_filter=8, kernel=(3, 3), pad=(1, 1),
                      no_bias=True)
    x = S.BatchNorm(x, name='bn1', fix_gamma=False)
    x = S.Activation(x, act_type='relu')
    x = S.Convolution(x, name='c2', num_filter=8, kernel=(1, 1),
                      no_bias=True)
    x = S.BatchNorm(x, name='bn2', fix_gamma=False)
    x = S.Activation(x, act_type='relu')
    x = S.Pooling(x, global_pool=True, pool_type='avg', kernel=(1, 1))
    fc = S.FullyConnected(S.Flatten(x), name='fc', num_hidden=DP_CLASSES)
    if dtype != 'float32':
        fc = S.Cast(fc, dtype='float32')
    return S.SoftmaxOutput(fc, name='softmax')


def dp_seq_net(pkg, key):
    """A bucketing net over (batch, key) inputs whose parameters do not
    depend on the key."""
    S = pkg.sym
    x = S.mean(S.Variable('data'), axis=1, keepdims=True)
    fc1 = S.FullyConnected(x, name='fc1', num_hidden=24)
    act = S.Activation(fc1, act_type='relu')
    fc2 = S.FullyConnected(act, name='fc2', num_hidden=DP_CLASSES)
    return S.SoftmaxOutput(fc2, name='softmax')


def dp_params(net, data_shape, seed=3):
    """(args, auxs) as numpy: uniform weights, gammas near 1, moving
    means 0 and variances 1."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    args = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ('data', 'softmax_label'):
            continue
        v = (rs.rand(*shape).astype(np.float32) - 0.5) * 0.4
        args[name] = v + 1.0 if name.endswith('_gamma') else v
    auxs = {name: (np.zeros if name.endswith('mean') else np.ones)(
        shape, np.float32)
        for name, shape in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def dp_module(pkg, net, ctxs, data_shape, args, auxs, zero=0, opt=None,
              inputs_need_grad=False, bind_only=False):
    mod = pkg.mod.Module(net, context=ctxs)
    mod.bind(data_shapes=[pkg.io.DataDesc('data', data_shape)],
             label_shapes=[pkg.io.DataDesc('softmax_label',
                                           (data_shape[0],))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(initializer=None,
                    arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in auxs.items()})
    if not bind_only:
        mod.init_optimizer(optimizer='sgd',
                           optimizer_params=dict(opt or DP_OPT), zero=zero)
    return mod


def dp_batches(pkg, X, y):
    return [pkg.io.DataBatch(data=[pkg.nd.array(x)], label=[pkg.nd.array(t)])
            for x, t in zip(X, y)]


def _f32(a):
    return a.asnumpy().astype(np.float32)


def dp_result(mod, prefix, res):
    """The module's parameters, aux states and optimizer states into res
    (the states from get_states: full per-parameter arrays)."""
    import pickle
    args, auxs = mod.get_params()
    for k, v in args.items():
        res['%s__p__%s' % (prefix, k)] = _f32(v)
    for k, v in auxs.items():
        res['%s__a__%s' % (prefix, k)] = _f32(v)
    fu = getattr(mod, '_fused_updater', None)
    if fu is not None:
        moms, _, masters = pickle.loads(fu.get_states())
        for k, v in moms.items():
            res['%s__m__%s' % (prefix, k)] = np.asarray(v, np.float32)
        for k, v in (masters or {}).items():
            if v is not None:
                res['%s__w__%s' % (prefix, k)] = np.asarray(v, np.float32)


def dp_train(pkg, mod, batches, res, prefix, metric=None):
    outs = []
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        outs.append(_f32(mod.get_outputs()[0]))
        if metric is not None:
            mod.update_metric(metric, b.label)
    res[prefix + '__out'] = np.stack(outs)
    if metric is not None:
        res[prefix + '__metric'] = np.float64(metric.get()[1])
    dp_result(mod, prefix, res)


class _env:
    """Environment variables set for a block (None: unset)."""

    def __init__(self, **kv):
        self.kv, self.prev = kv, {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.prev[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _planted_sum(kind):
    """BatchNorm's statistic sum with a fault planted: 'local' leaves
    every rank its own rows' statistics, 'identity_backward' sums with
    the Megatron form, whose backward does not sum the cotangent."""
    if kind == 'local':
        return lambda x, mesh: x * mesh.axis_size('data')
    return lambda x, mesh: C.allreduce_sum(x, 'data', mesh)


# the registered ops that reduce over the batch axis (executor.py,
# parallel/batch_reduce.py): one graph a case, a parameter before the
# reduction (fc1, or w1 for the ties) and one after (w2)
BR_HIDDEN = 6
BR_CASES = ('sum', 'sum_axis', 'mean', 'prod', 'nansum', 'nanprod', 'max',
            'max_axis', 'min', 'min_axis', 'norm', 'norm_ord1',
            'softmax_cross_entropy', 'sort', 'argsort', 'topk', 'max_ties',
            'min_ties', 'chain', 'center')
# tied rows: 3, 5 (data index 0) and 12 (index 1) hold the maximum of
# every column, 1 and 9 the minimum
BR_TIE_MAX, BR_TIE_MIN = (3, 5, 12), (1, 9)


def br_net(pkg, case):
    """The case's graph and whether its data gradient is checked."""
    S = pkg.sym
    data = S.Variable('data')
    ties = case.endswith('_ties')
    if ties:
        h = S.broadcast_mul(data, S.Variable('w1', shape=(1, DP_FEAT)))
        width = DP_FEAT
    else:
        h = S.tanh(S.FullyConnected(data, name='fc1', num_hidden=BR_HIDDEN))
        width = BR_HIDDEN
    vec = (1, width)
    if case in ('sum', 'sum_axis', 'mean', 'nansum', 'max', 'max_axis',
                'min', 'min_axis'):
        r = getattr(S, case)(h, axis=0, keepdims=True)
    elif case in ('prod', 'nanprod'):
        r = getattr(S, case)(h * 0.3 + 1.0, axis=0, keepdims=True)
    elif case in ('norm', 'norm_ord1'):
        r = S.norm(h, ord=1 if case == 'norm_ord1' else 2)
        vec = (1,)
    elif case == 'softmax_cross_entropy':
        r = S.softmax_cross_entropy(h, S.Variable('softmax_label'))
        vec = (1,)
    elif case in ('sort', 'argsort'):
        r = getattr(S, case)(h, axis=0)
    elif case == 'topk':
        r = S.topk(h, axis=0, k=3, ret_typ='value')
    elif ties:
        r = getattr(S, case[:3])(h, axis=0, keepdims=True)
    elif case == 'chain':
        r = S.sum(S.max(h, axis=0, keepdims=True), axis=1, keepdims=True)
        vec = (1, 1)
    else:   # center: a replicated mean enters the batch-carrying rows
        c = S.broadcast_sub(h, S.mean(h, axis=0, keepdims=True))
        r = S.sum(S.square(c), axis=0, keepdims=True)
    z = S.broadcast_mul(r, S.Variable('w2', shape=vec))
    return S.MakeLoss(z, name='loss'), ties


def br_inputs(X):
    """The data of a case: X with the tied rows set."""
    X = np.array(X, np.float32)
    X[list(BR_TIE_MAX)] = 2.0
    X[list(BR_TIE_MIN)] = -1.0
    return X


def br_params(net, case):
    rs = np.random.RandomState(5)
    shapes = {'data': (DP_BATCH, DP_FEAT)}
    if 'softmax_label' in net.list_arguments():
        shapes['softmax_label'] = (DP_BATCH,)
    arg_shapes, _, _ = net.infer_shape(**shapes)
    args = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ('data', 'softmax_label'):
            continue
        v = (rs.rand(*shape).astype(np.float32) - 0.5) * 0.8
        args[name] = v + 1.0 if name == 'w1' else v
    return args


def br_step(pkg, case, ctxs, X, y, res, prefix):
    """One SGD step of the case's Module: the outputs, the parameters'
    gradients, the data's gradient for the ties, the updated
    parameters."""
    net, ties = br_net(pkg, case)
    mod = pkg.mod.Module(net, context=ctxs)
    label = [pkg.io.DataDesc('softmax_label', (DP_BATCH,))] \
        if case == 'softmax_cross_entropy' else None
    mod.bind(data_shapes=[pkg.io.DataDesc('data', (DP_BATCH, DP_FEAT))],
             label_shapes=label, inputs_need_grad=ties)
    mod.init_params(initializer=None, arg_params={
        k: pkg.nd.array(v) for k, v in br_params(net, case).items()})
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1})
    X = br_inputs(X) if ties else X
    mod.forward_backward(pkg.io.DataBatch(
        data=[pkg.nd.array(X)],
        label=[pkg.nd.array(y)] if label else None))
    res[prefix + '__out'] = _f32(mod.get_outputs()[0])
    grads = dict(zip(mod._param_names, mod._exec_group.grad_arrays))
    for k, g in grads.items():
        res['%s__g__%s' % (prefix, k)] = _f32(g)
    if ties:
        res[prefix + '__igrad'] = _f32(mod.get_input_grads()[0])
    mod.update()
    for k, v in mod.get_params()[0].items():
        res['%s__p__%s' % (prefix, k)] = _f32(v)


def module_dp_suite(rank, tmp_path):
    """Module over two contexts (two gloo ranks): the MLP with ZeRO 0
    and 1 under both reduce schedules, bfloat16 with float32 masters,
    clipping, the loss heads' normalizations, the BatchNorm nets in
    float32 and bfloat16 with planted faults, bulk_step with the device
    metric fold, fit on the mesh's staging, Dropout, the input
    gradients, BucketingModule, and ZeRO checkpoints both ways."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic, profiler
    from mxnet_tpu_torch.ops import nn as ops_nn
    inp = _inputs(tmp_path)
    res = {}
    ctxs = [mx.cpu(0), mx.cpu(1)]
    mlp_shape = (DP_BATCH, DP_FEAT)
    bn_shape = (DP_BATCH,) + DP_IMAGE
    with mx.cpu():
        batches = dp_batches(mx, inp['X'], inp['y'])
        for zero in (0, 1):
            for il in (1, 0):
                with _env(MXNET_TPU_INTERLEAVE_REDUCE=il):
                    profiler.clear()
                    net = dp_mlp(mx)
                    mod = dp_module(mx, net, ctxs, mlp_shape,
                                    *dp_params(net, mlp_shape), zero=zero)
                    tag = 'mlp_z%d_i%d' % (zero, il)
                    dp_train(mx, mod, batches, res, tag,
                             metric=mx.metric.Accuracy())
                    st = profiler.comm_stats()
                    for k in ('reduce_buckets_issued',
                              'optimizer_state_bytes_per_device',
                              'bytes_reduce_scattered',
                              'bytes_all_gathered',
                              'zero_wire_all_reduce'):
                        res['%s__stat__%s' % (tag, k)] = st[k]
                    res[tag + '__state_bytes'] = \
                        mod._fused_updater.state_bytes_per_device()
        for case, kw in (('bf16', dict(dtype='bfloat16')), ('clip', {})):
            for zero in (0, 1):
                net = dp_mlp(mx, **kw)
                opt = dict(DP_OPT, multi_precision=True) \
                    if case == 'bf16' else dict(DP_OPT, clip_gradient=0.05)
                mod = dp_module(mx, net, ctxs, mlp_shape,
                                *dp_params(net, mlp_shape), zero=zero,
                                opt=opt)
                dp_train(mx, mod, batches, res, '%s_z%d' % (case, zero))
        ign = dp_batches(mx, inp['X'], inp['y_ign'])
        for norm in ('batch', 'valid'):
            net = dp_mlp(mx, normalization=norm, use_ignore=True)
            mod = dp_module(mx, net, ctxs, mlp_shape,
                            *dp_params(net, mlp_shape))
            dp_train(mx, mod, ign, res, 'norm_' + norm)
        bn_batches = dp_batches(mx, inp['Xi'], inp['y'])[:3]
        sync_sum = ops_nn._sync_sum
        for dtype in ('float32', 'bfloat16'):
            for plant in ('clean', 'local', 'identity_backward'):
                if plant != 'clean':
                    ops_nn._sync_sum = _planted_sum(plant)
                try:
                    net = dp_bn_net(mx, dtype)
                    mod = dp_module(mx, net, ctxs, bn_shape,
                                    *dp_params(net, bn_shape),
                                    opt=dict(DP_OPT, multi_precision=True))
                    dp_train(mx, mod, bn_batches, res,
                             'bn_%s_%s' % (dtype, plant))
                finally:
                    ops_nn._sync_sum = sync_sum
        for zero in (0, 1):
            net = dp_mlp(mx)
            mod = dp_module(mx, net, ctxs, mlp_shape,
                            *dp_params(net, mlp_shape), zero=zero)
            metric = mx.metric.Accuracy()
            profiler.clear()
            mod.bulk_step(batches=batches, eval_metric=metric)
            res['bulk_z%d__metric' % zero] = np.float64(metric.get()[1])
            res['bulk_z%d__dispatches' % zero] = \
                mod._exec_group.executor.fused_dispatches
            res['bulk_z%d__metric_steps' % zero] = \
                profiler.comm_stats()['scan_fused_metric_steps']
            dp_result(mod, 'bulk_z%d' % zero, res)
        net = dp_mlp(mx)
        mod = dp_module(mx, net, ctxs, mlp_shape, *dp_params(net, mlp_shape),
                        bind_only=True)
        it = mx.io.NDArrayIter(inp['X'].reshape(-1, DP_FEAT),
                               inp['y'].reshape(-1), batch_size=DP_BATCH)
        profiler.clear()
        mod.fit(it, num_epoch=1, optimizer_params=dict(DP_OPT),
                eval_metric='acc', bulk=2)
        res['fit__staged_bytes'] = profiler.mesh_stats()['mesh_staged_bytes']
        dp_result(mod, 'fit', res)
        mx.random.seed(7)
        net = dp_mlp(mx, dropout=0.3)
        mod = dp_module(mx, net, ctxs, mlp_shape, *dp_params(net, mlp_shape))
        dp_train(mx, mod, batches[:2], res, 'dropout')
        net = dp_mlp(mx)
        mod = dp_module(mx, net, ctxs, mlp_shape, *dp_params(net, mlp_shape),
                        inputs_need_grad=True)
        mod.forward_backward(batches[0])
        res['igrad'] = _f32(mod.get_input_grads()[0])
        for case in BR_CASES:
            br_step(mx, case, ctxs, inp['X'][0], inp['y'][0], res,
                    'br_' + case)
        for zero in (0, 1):
            bmod = mx.mod.BucketingModule(
                lambda key: (dp_seq_net(mx, key), ('data',),
                             ('softmax_label',)),
                default_bucket_key=8, context=ctxs)
            bmod.bind(data_shapes=[mx.io.DataDesc('data', (DP_BATCH, 8))],
                      label_shapes=[mx.io.DataDesc('softmax_label',
                                                   (DP_BATCH,))])
            bargs, _ = dp_params(dp_seq_net(mx, 8), (DP_BATCH, 8))
            bmod.init_params(initializer=None, arg_params={
                k: mx.nd.array(v) for k, v in bargs.items()})
            bmod.init_optimizer(optimizer='sgd',
                                optimizer_params=dict(DP_OPT), zero=zero)
            for i, key in enumerate((8, 4, 8, 4)):
                x = inp['Xs'][i][:, :key]
                bmod.forward_backward(mx.io.DataBatch(
                    data=[mx.nd.array(x)], label=[mx.nd.array(inp['y'][i])],
                    bucket_key=key,
                    provide_data=[mx.io.DataDesc('data', x.shape)],
                    provide_label=[mx.io.DataDesc('softmax_label',
                                                  (DP_BATCH,))]))
                bmod.update()
            dp_result(bmod, 'bucketing_z%d' % zero, res)
        # ZeRO checkpoints: the port's two ranks commit one; the JAX
        # package's (eight devices) restores here at data 2
        net = dp_mlp(mx)
        mod = dp_module(mx, net, ctxs, mlp_shape, *dp_params(net, mlp_shape),
                        zero=1)
        for b in batches[:2]:
            mod.forward_backward(b)
            mod.update()
        mgr = elastic.CheckpointManager(os.path.join(tmp_path, 'ckpt_port'),
                                        async_=False)
        mgr.attach(mod)
        mgr._step = 2
        mgr.save(sync=True)
        dp_result(mod, 'ckpt_saved', res)
        mod = dp_module(mx, net, ctxs, mlp_shape,
                        *dp_params(net, mlp_shape, seed=9), zero=1)
        info = elastic.resume(elastic.CheckpointManager(
            os.path.join(tmp_path, 'ckpt_jax')), mod)
        res['ckpt_jax__step'] = -1 if info is None else info.step
        dp_result(mod, 'ckpt_jax', res)
    _save(tmp_path, rank, res)


def zero_suite(rank, tmp_path):
    """ZeRO-1 over four ranks (tests/test_zero.py and the dryrun's ZeRO
    and schedule phases on the port): parity with the replicated update,
    clipping, bfloat16 masters, bulk, tiny buckets, the env knob, state
    bytes and shard shapes, the comm counters, the cache keys, states
    across modes, a relayout mid-run, and both schedules."""
    import pickle
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import exec_cache, profiler
    from mxnet_tpu_torch import optimizer as opt_mod
    inp = _inputs(tmp_path)
    res = {}
    n = M.make_mesh(device='cpu').shape['data']
    ctxs = [mx.cpu(i) for i in range(n)]
    shape = (DP_BATCH, DP_FEAT)

    def run(tag, zero, dtype='float32', opt=None, bulk=False, steps=4,
            **env):
        with _env(**env):
            net = dp_mlp(mx, dtype)
            kw = dict(DP_OPT, multi_precision=dtype != 'float32')
            kw.update(opt or {})
            mod = dp_module(mx, net, ctxs, shape, *dp_params(net, shape),
                            zero=zero, opt=kw)
            batches = dp_batches(mx, inp['X'], inp['y'])[:steps]
            if bulk:
                mod.bulk_step(batches=batches)
                dp_result(mod, tag, res)
            elif batches:
                dp_train(mx, mod, batches, res, tag)
        return mod

    with mx.cpu():
        for zero in (0, 1):
            run('base_z%d' % zero, zero)
            run('clip_z%d' % zero, zero, opt={'clip_gradient': 0.05})
            run('bf16_z%d' % zero, zero, dtype='bfloat16')
            exec_cache.clear()
            run('bulk_z%d' % zero, zero, bulk=True)
            with exec_cache._LOCK:
                res['bulk_z%d__multistep_keys' % zero] = len(
                    [k for k in exec_cache._CACHE if isinstance(k, tuple)
                     and len(k) > 1 and k[1] == 'multistep'])
        run('tiny_z1', 1, MXNET_TPU_ZERO_BUCKET_MB='0.0001')
        mod = run('env_knob', None, steps=1, MXNET_TPU_ZERO=1)
        res['env_knob__zero'] = mod._fused_updater.zero
        for zero in (0, 1):
            profiler.clear()
            mod = run('acct_z%d' % zero, zero, steps=3)
            fu = mod._fused_updater
            st = profiler.comm_stats()
            res['acct_z%d__rs_ag' % zero] = np.array(
                fu.comm_bytes_per_step())
            res['acct_z%d__stats' % zero] = np.array(
                [st['bytes_reduce_scattered'], st['bytes_all_gathered'],
                 st['optimizer_state_bytes_per_device'],
                 st['zero_wire_all_reduce'],
                 st['zero_wire_reduce_scatter'],
                 st['reduce_buckets_issued']])
            res['acct_z%d__state_bytes' % zero] = fu.state_bytes_per_device()
            res['acct_z%d__n_buckets' % zero] = len(fu._layout.buckets) \
                if fu.zero else mod._exec_group.reduce_plan.n_buckets
            if zero:
                res['acct_z1__shard_sizes'] = np.array(
                    [m.numel() for m in fu._zero_moms])
                res['acct_z1__padded'] = np.array(
                    [b.padded for b in fu._layout.buckets])
                ex = mod._exec_group.executor
                res['acct_z1__weights_full'] = all(
                    tuple(ex.arg_dict[k].shape) == tuple(v.shape)
                    for k, v in mod.get_params()[0].items())
                blob = fu.get_states()
                states, _, _ = pickle.loads(blob)
                rep = opt_mod.FusedSGD(opt_mod.SGD(momentum=0.9),
                                       list(states))
                rep.set_states(blob)
                res['cross__equal'] = all(
                    np.array_equal(np.asarray(rep.states[k]), states[k])
                    for k in states)
                res['cross__moved'] = any(np.abs(v).sum() > 0
                                          for v in states.values())
                fresh = run('fresh', 1, steps=0)
                fresh._fused_updater.set_states(blob)
                again, _, _ = pickle.loads(fresh._fused_updater.get_states())
                res['staged__equal'] = all(
                    np.array_equal(again[k], states[k]) for k in states)
                b = dp_batches(mx, inp['X'], inp['y'])[0]
                fresh.forward_backward(b)
                fresh.update()
                after, _, _ = pickle.loads(
                    fresh._fused_updater.get_states())
                res['staged__keys'] = sorted(after) == sorted(states)
        # the bucket target shrunk after two steps: the layout rebuilds
        net = dp_mlp(mx)
        mod = dp_module(mx, net, ctxs, shape, *dp_params(net, shape), zero=1)
        for i, b in enumerate(dp_batches(mx, inp['X'], inp['y'])):
            with _env(MXNET_TPU_ZERO_BUCKET_MB='0.0001' if i >= 2 else None):
                mod.forward_backward(b)
                mod.update()
        dp_result(mod, 'relayout', res)
        for zero in (0, 1):
            for il in (1, 0):
                profiler.clear()
                run('sched_z%d_i%d' % (zero, il), zero,
                    MXNET_TPU_INTERLEAVE_REDUCE=il)
                res['sched_z%d_i%d__buckets' % (zero, il)] = \
                    profiler.comm_stats()['reduce_buckets_issued']
        # the dryrun's (e3) epoch-fused metric bulk against the host loop
        net = dp_mlp(mx)
        host = mx.metric.Accuracy()
        mod = dp_module(mx, net, ctxs, shape, *dp_params(net, shape))
        dp_train(mx, mod, dp_batches(mx, inp['X'], inp['y']), res, 'host',
                 metric=host)
        dev = mx.metric.Accuracy()
        mod = dp_module(mx, net, ctxs, shape, *dp_params(net, shape))
        profiler.clear()
        mod.bulk_step(batches=dp_batches(mx, inp['X'], inp['y']),
                      eval_metric=dev)
        res['fold__metric'] = np.float64(dev.get()[1])
        res['fold__dispatches'] = mod._exec_group.executor.fused_dispatches
        res['fold__metric_steps'] = \
            profiler.comm_stats()['scan_fused_metric_steps']
        dp_result(mod, 'fold', res)
    _save(tmp_path, rank, res)


# -- the fused Gluon step and sparse tables over a data mesh -----------------

GF_BATCH, GF_FEAT, GF_NCLS = 8, 6, 4
GF_OPT_MOM = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
SP_VOCAB, SP_DIM, SP_BATCH = 64, 8, 16


def gf_seed_params(pkg, net, seed):
    rs = np.random.RandomState(seed)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(
            (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.4))


def gf_mlp(pkg, seed, ctx=None, in_units=GF_FEAT):
    """tests/test_gluon_fused.py's net: Dense(16, relu) -> Dense(4)."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation='relu', in_units=in_units))
        net.add(nn.Dense(GF_NCLS, in_units=16))
    net.initialize(ctx=ctx)
    if in_units:
        gf_seed_params(pkg, net, seed)
    return net


def gf_pvals(net, fused=None):
    """Parameter values in sorted-name order (a striped table whole,
    through the fused step: a collective)."""
    out = []
    for _, p in sorted(net.collect_params().items()):
        if fused is not None and getattr(p, 'sparse_grad', False):
            v = fused.full_param(p)
        else:
            v = p.list_data()[0]._data
        out.append(np.array(v.detach().float().cpu().numpy()))
    return out


def sp_net(pkg, sparse, seed=3, ctxs=None):
    """tests/test_sparse_embed.py's net: Embedding -> Dense(4)."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Embedding(SP_VOCAB, SP_DIM, sparse_grad=sparse))
    net.add(nn.Dense(4, flatten=False, in_units=SP_DIM))
    net.initialize(force_reinit=True, ctx=ctxs)
    rs = np.random.RandomState(seed)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array(
            (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.2))
    return net


def sp_train(pkg, net, opt, ids, targets, upto=None, start=0, **fuse_kw):
    tr = pkg.gluon.Trainer(net.collect_params(), 'sgd', dict(opt))
    fs = pkg.gluon.fuse_step(net, pkg.gluon.loss.L2Loss(), tr, **fuse_kw)
    upto = len(ids) if upto is None else upto
    for x, y in zip(ids[start:upto], targets[start:upto]):
        fs(pkg.nd.array(x), pkg.nd.array(y))
    return fs, tr


def _put(res, prefix, vals):
    for i, v in enumerate(vals):
        res['%s__%d' % (prefix, i)] = v


def gluon_fused_suite(rank, tmp_path):
    """The fused Gluon step over two contexts (two gloo ranks): the MLP
    with momentum and wd under ZeRO 0 and 1, eager eval and set_data
    after it; the sparse net's tables striped, ZeRO 0 and 1; an elastic
    checkpoint of the striped tables at data 2; the JAX package's
    checkpoint (tmp_path/jax_ckpt) restored at data 2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic
    inp = _inputs(tmp_path)
    res = {}
    ctxs = [mx.cpu(0), mx.cpu(1)]
    with mx.cpu():
        for zero in (0, 1):
            net = gf_mlp(mx, 3, ctx=ctxs)
            tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                                  dict(GF_OPT_MOM))
            fs = mx.gluon.fuse_step(net, mx.gluon.loss.
                                    SoftmaxCrossEntropyLoss(), tr, zero=zero)
            for x, y in zip(inp['X'][:3], inp['y'][:3]):
                loss = fs(mx.nd.array(x), mx.nd.array(y))
            _put(res, 'mlp_z%d' % zero, gf_pvals(net))
            res['mlp_z%d_loss' % zero] = loss.asnumpy()
            res['mlp_z%d_state_bytes' % zero] = \
                tr._fused_updater.state_bytes_per_device()
            res['mlp_z%d_dp' % zero] = fs._dp
        # eager eval after the mesh steps, and set_data honoured
        res['eval_shape'] = np.array(net(mx.nd.array(inp['X'][0])).shape)
        w0 = net[0].weight
        w0.set_data(mx.nd.zeros(w0.shape))
        res['set_data_max'] = float(fs._gather_param(w0).abs().max())
        fs(mx.nd.array(inp['X'][0]), mx.nd.array(inp['y'][0]))
        # sparse tables striped over the two ranks, ZeRO 0 and 1
        opt = {'learning_rate': 0.1, 'momentum': 0.9}
        for zero in (0, 1):
            net = sp_net(mx, True, ctxs=ctxs)
            fs, tr = sp_train(mx, net, opt, inp['ids'][:3], inp['tg'][:3],
                              zero=zero)
            _put(res, 'sp_z%d' % zero, gf_pvals(net, fs))
            table = next(p for p in tr._params if p.sparse_grad)
            res['sp_z%d_rows' % zero] = fs._gather_param(table).shape[0]
        # an elastic checkpoint of the striped tables at data 2, step 3
        net = sp_net(mx, True, ctxs=ctxs)
        mgr = elastic.CheckpointManager(os.path.join(tmp_path, 'port_ckpt'),
                                        async_=False, every_n_steps=3)
        fs, _ = sp_train(mx, net, opt, inp['ids'], inp['tg'], upto=3,
                         checkpoint=mgr)
        mgr.close()
        # the JAX package's checkpoint (step 3) restored at data 2
        net = sp_net(mx, True, seed=99, ctxs=ctxs)
        mgr = elastic.CheckpointManager(os.path.join(tmp_path, 'jax_ckpt'),
                                        async_=False)
        fs, _ = sp_train(mx, net, opt, inp['ids'], inp['tg'], start=3,
                         checkpoint=mgr)
        res['jax_resume_step'] = mgr.last_resume.step
        _put(res, 'from_jax', gf_pvals(net, fs))
        mgr.close()
        # a Module's sparse tables striped: one step, the full tables
        mod = mf_module(mx, ctxs)
        ex = mod._exec_group.executor
        res['mf_rows'] = np.array([ex.arg_dict[n]._data.shape[0]
                                   for n in sorted(mod._exec_group.
                                                   sparse_tables)])
        mf_step(mx, mod, inp)
        args, _ = mod.get_params()
        for k, v in args.items():
            res['mf__' + k] = v.asnumpy()
    _save(tmp_path, rank, res)


# -- pipeline and expert parallelism ---------------------------------------

PP_BATCH, PP_FEAT, PP_UNITS, PP_NCLS = 8, 6, 12, 4
PP_OPT = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
PP_LM = dict(vocab=64, dim=32, heads=4, layers=4, mlp_mult=4)
PP_LM_HYPER = dict(momentum=0.9, clip=None, nesterov=False)
PP_LM_LR, PP_LM_WD, PP_LM_STEPS, PP_LM_MICRO = 0.1, 1e-3, 2, 2


def pp_net(pkg, ctx=None, body=4, act='tanh', moe=False, bn=False):
    """tests/test_pipeline_train.py's nets: a stem Dense, `body`
    identical Dense layers (act, or relu / tanh alternating for
    act='mixed'), a head Dense; moe: two MoE blocks for the body; bn:
    two BatchNorms."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        if moe:
            net.add(nn.MoE(PP_FEAT, 2 * PP_FEAT, num_experts=2))
            net.add(nn.MoE(PP_FEAT, 2 * PP_FEAT, num_experts=2))
            net.add(nn.Dense(PP_NCLS, in_units=PP_FEAT))
        elif bn:
            net.add(nn.Dense(PP_UNITS, in_units=PP_FEAT))
            net.add(nn.BatchNorm(in_channels=PP_UNITS))
            net.add(nn.BatchNorm(in_channels=PP_UNITS))
            net.add(nn.Dense(PP_NCLS, in_units=PP_UNITS))
        else:
            net.add(nn.Dense(PP_UNITS, activation='relu', in_units=PP_FEAT))
            for i in range(body):
                a = act if act != 'mixed' else ('tanh', 'relu')[i % 2]
                net.add(nn.Dense(PP_UNITS, activation=a, in_units=PP_UNITS))
            net.add(nn.Dense(PP_NCLS, in_units=PP_UNITS))
    net.initialize(ctx=ctx)
    if not (moe or bn):
        rs = np.random.RandomState(5)
        for _, p in sorted(net.collect_params().items()):
            p.set_data(pkg.nd.array(
                (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.4))
    return net


def pp_batches(k=3, seed=42):
    rs = np.random.RandomState(seed)
    return [(rs.rand(PP_BATCH, PP_FEAT).astype(np.float32),
             (rs.rand(PP_BATCH) * PP_NCLS).astype(np.float32))
            for _ in range(k)]


def pp_pvals(net):
    return [np.array(p.list_data()[0]._data.detach().float().cpu().numpy()
                     if hasattr(p.list_data()[0]._data, 'detach')
                     else p.list_data()[0].asnumpy(), np.float32)
            for _, p in sorted(net.collect_params().items())]


def pp_train(pkg, ctx, pipeline=None, zero=None, bulk=False, k=3):
    """The pipelined (or one-device) fused step over pp_batches(k);
    (net, step, last loss)."""
    net = pp_net(pkg, ctx)
    tr = pkg.gluon.Trainer(net.collect_params(), 'sgd', dict(PP_OPT))
    fs = pkg.gluon.fuse_step(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                             tr, pipeline=pipeline, zero=zero)
    bs = pp_batches(k)
    if bulk:
        loss = fs.bulk(pkg.nd.array(np.stack([x for x, _ in bs])),
                       pkg.nd.array(np.stack([y for _, y in bs])))
    else:
        for x, y in bs:
            loss = fs(pkg.nd.array(x), pkg.nd.array(y))
    if pipeline is not None and hasattr(fs, 'sync_params') and \
            type(fs).__module__.startswith('mxnet_tpu_torch'):
        fs.sync_params()
    return net, fs, loss


def pp_chain_symbol(pkg):
    S = pkg.sym
    d = S.Variable('data')
    h = S.FullyConnected(d, name='stem', num_hidden=PP_UNITS)
    h = S.Activation(h, act_type='relu')
    for i in range(4):
        h = S.FullyConnected(h, name='body%d' % i, num_hidden=PP_UNITS)
        h = S.Activation(h, act_type='tanh')
    h = S.FullyConnected(h, name='out', num_hidden=PP_NCLS)
    return S.SoftmaxOutput(h, name='softmax')


def pp_fit(pkg, ctx, pipeline=None, bulk=None):
    """Module.fit of the chain over three batches, one epoch; the
    parameters by name."""
    sym = pp_chain_symbol(pkg)
    arg_shapes, _, _ = sym.infer_shape(data=(PP_BATCH, PP_FEAT))
    rs = np.random.RandomState(5)
    args = {n: pkg.nd.array((rs.rand(*sh).astype(np.float32) - 0.5) * 0.4)
            for n, sh in zip(sym.list_arguments(), arg_shapes)
            if n not in ('data', 'softmax_label')}
    bs = pp_batches(3)
    X = np.concatenate([x for x, _ in bs])
    y = np.concatenate([t for _, t in bs])
    it = pkg.io.NDArrayIter(X, y, batch_size=PP_BATCH)
    mod = pkg.mod.Module(sym, context=ctx)
    mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=dict(PP_OPT),
            arg_params={k: v.copy() for k, v in args.items()},
            initializer=None, pipeline=pipeline, bulk=bulk)
    ap, _ = mod.get_params()
    return {k: np.array(v.asnumpy(), np.float32) for k, v in ap.items()}


def chip_smoke():
    """chip_smoke.py at the repo's root, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pp_lm_planted(inp, mesh):
    """chip_smoke's phase-32 plants (PIPE_PLANTS) in the float32
    pipelined LM on `mesh`: for each, whether this rank's final leaves
    pass chip_smoke.updates_within at MESH_UPDATE_RTOL against the clean
    run's, and the clean run against itself."""
    cs = chip_smoke()
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel import pipeline as pp
    cfg = tfm.lm_config(use_flash=True, **PP_LM)
    S = mesh.shape['pipe']
    rows = inp['lm_tok'].shape[0] // (mesh.shape['data'] * PP_LM_MICRO)
    stages, stem, head = tfm.pipe_lm_leaves(_tree(inp, 'lmp_'), S)
    init = ([w[None].clone() for w in stages[mesh.axis_index('pipe')]],
            stem, head)
    old = [w[0] for w in init[0]] + stem + head
    tokens, targets = torch.from_numpy(inp['lm_tok']), \
        torch.from_numpy(inp['lm_tgt'])

    def run(plant):
        fns = tfm.pipe_lm_fns(cfg, S)
        if plant in ('drop', 'double'):
            fns = cs.pipe_planted_fns(torch, fns, plant, rows=rows)
        step = pp.make_pipe_step_fn(mesh, S, PP_LM_MICRO, *fns, dict(
            PP_LM_HYPER, rescale=1.0 / mesh.shape['data']))
        ws, st, hd = ([w.clone() for w in t] for t in init)
        opt = pp.init_pipe_opt_state(mesh, None, S, ws, st, hd)
        n = len(ws) + len(st) + len(hd)
        rng = 0
        with cs.pipe_unsummed(collectives) if plant == 'unsummed' else \
                cs.contextlib.nullcontext():
            for _ in range(PP_LM_STEPS):
                _, ws, st, hd, opt, rng = step(
                    ws, st, hd, opt, rng, tokens, targets,
                    [PP_LM_LR] * n, [PP_LM_WD] * n)
        return [w[0] for w in ws] + st + hd

    clean = run(None)
    out = {'clean': cs.updates_within(torch, clean, old, clean,
                                      cs.MESH_UPDATE_RTOL)['ok']}
    for plant in cs.PIPE_PLANTS:
        out[plant] = cs.updates_within(torch, run(plant), old, clean,
                                       cs.MESH_UPDATE_RTOL)['ok']
    return out


def pp_lm_run(inp, mesh, use_flash, zero=False, bulk=False):
    """PP_LM_STEPS steps of the pipelined LM (transformer.pipe_lm_fns)
    on `mesh` from the numpy tree in inp ('lmp_*'); every stage's leaves
    gathered over 'pipe', the stem and head leaves, the losses."""
    from mxnet_tpu_torch.parallel import pipeline as pp
    from mxnet_tpu_torch.parallel import zero as zmod
    cfg = tfm.lm_config(use_flash=use_flash, **PP_LM)
    S = mesh.shape['pipe']
    dp = mesh.shape['data']
    stages, stem, head = tfm.pipe_lm_leaves(_tree(inp, 'lmp_'), S)
    stage_ws = [w[None].clone() for w in stages[mesh.axis_index('pipe')]]
    hyper = dict(PP_LM_HYPER, rescale=1.0 / dp)
    layout = None
    if zero:
        ws = stage_ws + stem + head
        layout = zmod.ZeroBucketLayout(
            [tuple(w.shape[1:]) for w in stage_ws] +
            [tuple(w.shape) for w in stem + head],
            [w.dtype for w in ws], [False] * len(ws), dp)
    step = pp.make_pipe_step_fn(mesh, S, PP_LM_MICRO, *tfm.pipe_lm_fns(
        cfg, S), hyper, layout=layout, bulk=bulk)
    opt = pp.init_pipe_opt_state(mesh, layout, S, stage_ws, stem, head)
    n = len(stage_ws) + len(stem) + len(head)
    tokens, targets = torch.from_numpy(inp['lm_tok']), \
        torch.from_numpy(inp['lm_tgt'])
    losses = []
    rng = 0
    if bulk:
        lrs = np.full((PP_LM_STEPS, n), PP_LM_LR, np.float32)
        wds = np.full((PP_LM_STEPS, n), PP_LM_WD, np.float32)
        leaves, stage_ws, stem, head, opt, rng = step(
            stage_ws, stem, head, opt, rng,
            tokens[None].expand(PP_LM_STEPS, -1, -1),
            targets[None].expand(PP_LM_STEPS, -1, -1), lrs, wds)
        losses = leaves[0].reshape(PP_LM_STEPS, -1)
    else:
        for _ in range(PP_LM_STEPS):
            leaves, stage_ws, stem, head, opt, rng = step(
                stage_ws, stem, head, opt, rng, tokens, targets,
                [PP_LM_LR] * n, [PP_LM_WD] * n)
            losses.append(leaves[0].reshape(-1))
        losses = torch.stack(losses)
    # each data rank's mean NLL: the first's, and their mean (the
    # global batch's)
    out = {'losses': losses[:, 0].numpy(),
           'losses_mean': losses.mean(dim=1).numpy()}
    for j, w in enumerate(stage_ws):
        out['stage%d' % j] = C._all_gather(w.contiguous(), mesh, 'pipe', 0) \
            .numpy()
    for j, w in enumerate(stem + head):
        out['edge%d' % j] = w.numpy()
    return out


def pipeline_suite(rank, tmp_path):
    """The pipelined trainers over four gloo ranks: the Gluon step at
    dp x pipe 2 x 2 and 1 x 4, ZeRO-1, bulk, a re-created trainer, the
    int8 and bf16 wires, sync_params, the refusals and the counters;
    Module.fit(pipeline=); pipeline_run and make_pipeline_train_step
    over a pipe axis of 4; the pipelined LM (make_pipe_step_fn) at 2 x 2
    and 1 x 4, flash and plain, ZeRO-1 and bulk."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import exec_cache
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import pipeline as pp
    inp = _inputs(tmp_path)
    res = {}
    ctx4 = [mx.cpu(i) for i in range(4)]

    def err(fn):
        try:
            fn()
        except (ValueError, MXNetError, NotImplementedError) as e:
            return '%s: %s' % (type(e).__name__, e)
        return 'no error'

    with mx.cpu():
        for name, kw in (('g22', dict(pipeline=(2, 2))),
                         ('g14', dict(pipeline=(4, 2))),
                         ('g22b', dict(pipeline=(2, 2), bulk=True)),
                         ('g22z', dict(pipeline=(2, 2), zero=1))):
            net, fs, loss = pp_train(mx, ctx4, **kw)
            _put(res, name, pp_pvals(net))
            res[name + '_loss'] = loss.asnumpy()
            res[name + '_acct'] = np.array(fs._pipe_state_accounting())
        res['repl_bytes'] = sum(int(np.prod(p.shape)) * 4 for p in
                                net.collect_params().values())
        # a re-created ZeRO trainer: the same bits, the same computation's
        # fingerprint and step signatures, nothing in exec_cache
        def keys(fs):
            d = fs._dispatch
            return repr((d.fingerprint, sorted(map(repr, d.fns))))

        key0, n_cached = keys(fs), exec_cache.size()
        net, fs, _ = pp_train(mx, ctx4, pipeline=(2, 2), zero=1)
        _put(res, 'g22z2', pp_pvals(net))
        res['recreate_same_key'] = keys(fs) == key0
        res['recreate_cache_entries'] = exec_cache.size() - n_cached
        # sync_params, then an eager forward, then a step on the step
        # function already built
        net, fs, _ = pp_train(mx, ctx4, pipeline=(2, 2), k=2)
        _put(res, 'sync', pp_pvals(net))
        x, y = pp_batches(1)[0]
        res['eager_shape'] = np.array(net(mx.nd.array(x)).shape)
        n_fns = len(fs._dispatch.fns)
        fs(mx.nd.array(x), mx.nd.array(y))
        res['resync_new_fns'] = len(fs._dispatch.fns) - n_fns
        # the int8 and bf16 wires of the data-axis sum
        for wire in ('int8', 'bf16'):
            os.environ['MXNET_TPU_DIST_WIRE_DTYPE'] = wire
            try:
                for run in (0, 1):
                    net, _, _ = pp_train(mx, ctx4, pipeline=(2, 2))
                    _put(res, 'w%s%d' % (wire, run), pp_pvals(net))
            finally:
                del os.environ['MXNET_TPU_DIST_WIRE_DTYPE']
        # MXNET_TPU_PIPE picks the mode
        os.environ['MXNET_TPU_PIPE'] = '2,2'
        try:
            net = pp_net(mx, ctx4)
            tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(PP_OPT))
            res['env_kind'] = type(mx.gluon.fuse_step(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)).__name__
        finally:
            del os.environ['MXNET_TPU_PIPE']
        # refusals that need the mesh
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

        def step_of(net):
            tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(PP_OPT))
            return mx.gluon.fuse_step(net, loss, tr, pipeline=(2, 2))

        fs = step_of(pp_net(mx, ctx4))
        res['err_batch'] = err(lambda: fs(
            mx.nd.array(np.zeros((6, PP_FEAT), np.float32)),
            mx.nd.array(np.zeros((6,), np.float32))))
        x, y = (mx.nd.array(a) for a in pp_batches(1)[0])
        fs = step_of(pp_net(mx, ctx4, body=2, act='mixed'))
        res['err_hetero'] = err(lambda: fs(x, y))
        fs = step_of(pp_net(mx, ctx4, bn=True))
        res['err_aux'] = err(lambda: fs(x, y))
        fs = step_of(pp_net(mx, ctx4, moe=True))
        res['err_moe'] = err(lambda: fs(x, y))
        # the partition's, the loss's and the trainer's refusals
        fs = step_of(pp_net(mx, ctx4, body=3))
        res['err_odd_run'] = err(lambda: fs(x, y))
        net = pp_net(mx, ctx4, body=1)
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(PP_OPT))
        fs = mx.gluon.fuse_step(net, loss, tr, pipeline=(4, 2))
        res['err_few_children'] = err(lambda: fs(x, y))
        net = pp_net(mx, ctx4)
        res['err_mp'] = err(lambda: mx.gluon.fuse_step(
            net, loss, mx.gluon.Trainer(net.collect_params(), 'sgd', dict(
                PP_OPT, multi_precision=True)), pipeline=(2, 2)))

        class ParamLoss(mx.gluon.loss.SoftmaxCrossEntropyLoss):
            def __init__(self):
                super(ParamLoss, self).__init__()
                self.scale = self.params.get('scale', shape=(1,))

        net = pp_net(mx, ctx4)
        fs = mx.gluon.fuse_step(net, ParamLoss(), mx.gluon.Trainer(
            net.collect_params(), 'sgd', dict(PP_OPT)), pipeline=(2, 2))
        res['err_loss_params'] = err(lambda: fs(x, y))
        net = pp_net(mx, ctx4)
        params = net.collect_params()
        fs = mx.gluon.fuse_step(net, loss, mx.gluon.Trainer(
            [p for k, p in sorted(params.items()) if 'dense0' not in k],
            'sgd', dict(PP_OPT)), pipeline=(2, 2))
        res['err_trainer_params'] = err(lambda: fs(x, y))
        net = pp_net(mx, ctx4)
        net[1].weight.lr_mult = 2.0
        fs = step_of(net)
        res['err_lr_mult'] = err(lambda: fs(x, y))
        # the counters, the summary and the profile's lanes
        profiler.clear()
        profiler.profiler_set_state('run')
        try:
            pp_train(mx, ctx4, pipeline=(2, 2), k=2)
        finally:
            profiler.profiler_set_state('stop')
        st = profiler.pipe_stats()
        for key, v in st.items():
            res['pipe_stat_' + key] = v
        res['summary'] = profiler.summary(print_out=False)
        fname = os.path.join(tmp_path, 'prof%d.json' % rank)
        profiler.profiler_set_config(filename=fname)
        profiler.dump_profile()
        import json
        with open(fname) as f:
            lanes = {e.get('name'): e.get('args') for e in
                     json.load(f)['traceEvents'] if e.get('ph') == 'M'}
        res['lane_pipe_steps'] = lanes['pipeline']['pipe_steps']
        res['lane_moe_keys'] = np.array(sorted(lanes['moe']))
        # Module.fit(pipeline=)
        for name, kw in (('m22', dict(pipeline=(2, 2))),
                         ('m22b', dict(pipeline=(2, 2), bulk=3))):
            for k, v in pp_fit(mx, ctx4, **kw).items():
                res['%s__%s' % (name, k)] = v
        sym = pp_chain_symbol(mx)
        X = np.concatenate([a for a, _ in pp_batches(3)])
        Y = np.concatenate([b for _, b in pp_batches(3)])
        it = mx.io.NDArrayIter(X, Y, batch_size=PP_BATCH)
        mod = mx.mod.Module(sym, context=ctx4)
        res['err_monitor'] = err(lambda: mod.fit(
            it, num_epoch=1, pipeline=(2, 2), monitor=mx.monitor.Monitor(1)))
        d = mx.sym.Variable('data')
        a = mx.sym.FullyConnected(d, name='a', num_hidden=PP_UNITS)
        b = mx.sym.FullyConnected(d, name='b', num_hidden=PP_UNITS)
        mod2 = mx.mod.Module(mx.sym.SoftmaxOutput(a + b, name='softmax'),
                             context=ctx4)
        it.reset()
        res['err_branch'] = err(lambda: mod2.fit(
            it, num_epoch=1, optimizer='sgd', optimizer_params=dict(PP_OPT),
            pipeline=(2, 2)))
        # the Module path's restrictions
        h = mx.sym.BatchNorm(mx.sym.FullyConnected(
            mx.sym.Variable('data'), name='fc', num_hidden=PP_UNITS),
            name='bn')
        cases = {
            'aux': (mx.sym.SoftmaxOutput(h, name='softmax'), {}, {}),
            'fixed': (sym, {'fixed_param_names': ['stem_weight']}, {}),
            'mp': (sym, {}, {'optimizer_params': dict(
                PP_OPT, multi_precision=True)}),
            'ckpt': (sym, {}, {'checkpoint': object()})}
        for name, (msym, mkw, fkw) in sorted(cases.items()):
            it.reset()
            fkw.setdefault('optimizer_params', dict(PP_OPT))
            m = mx.mod.Module(msym, context=ctx4, **mkw)
            res['err_mod_' + name] = err(lambda: m.fit(
                it, num_epoch=1, optimizer='sgd', pipeline=(2, 2), **fkw))
    # pipeline_run and the plain pipeline step over a pipe axis of 4
    mesh = M.make_mesh({'pipe': 4}, device='cpu')
    ws = [_t(inp['seq_w%d' % s]) for s in range(4)]
    bs = [_t(inp['seq_b%d' % s]) for s in range(4)]
    me = mesh.axis_index('pipe')
    micro = _t(inp['seq_x'], grad=True)
    w, b = ws[me].clone().requires_grad_(), bs[me].clone().requires_grad_()
    outs = pp.pipeline_run(lambda p, v: torch.tanh(v @ p['w'] + p['b']),
                           {'w': w, 'b': b}, micro, 4, 'pipe', mesh=mesh)
    res['run_out'] = C.allreduce_sum(outs, 'pipe', mesh)
    gw, gb, gx = torch.autograd.grad((outs * _t(inp['seq_g'])).sum(),
                                     [w, b, micro])
    res['run_gw'], res['run_gb'], res['run_gx'] = gw, gb, gx
    step = pp.make_pipeline_train_step(
        lambda p, v: v @ p['w'], lambda yv, tv: ((yv - tv) ** 2).mean(),
        mesh, num_micro=4, lr=0.05)
    params = pp.place_pipeline_params(pp.stack_stage_params(
        [{'w': inp['learn_w%d' % s]} for s in range(4)]), mesh)
    losses = []
    for _ in range(30):
        loss, params = step(params, inp['learn_x'], inp['learn_t'])
        losses.append(float(loss))
    res['learn_losses'] = np.array(losses)
    step = pp.make_pipeline_train_step(
        lambda p, v: v @ p['w'], lambda yv, tv: ((yv - tv) ** 2).mean(),
        mesh, num_micro=8, lr=1.0)
    params = pp.place_pipeline_params(pp.stack_stage_params(
        [{'w': inp['grad_w%d' % s]} for s in range(4)]), mesh)
    _, newp = step(params, inp['grad_x'], inp['grad_t'])
    res['grad_pipe'] = inp['grad_w%d' % me] - newp['w'][0].numpy()
    # the pipelined LM through make_pipe_step_fn
    m22 = pp.make_pipe_mesh(4, 2, device='cpu')
    for flash in (0, 1):
        for k, v in pp_lm_run(inp, m22, bool(flash)).items():
            res['lm22f%d_%s' % (flash, k)] = v
    for k, v in pp_lm_run(inp, m22, True, zero=True).items():
        res['lm22z_%s' % k] = v
    for k, v in pp_lm_run(inp, m22, True, bulk=True).items():
        res['lm22b_%s' % k] = v
    m14 = pp.make_pipe_mesh(4, 4, device='cpu')
    for k, v in pp_lm_run(inp, m14, True).items():
        res['lm14_%s' % k] = v
    for k, v in pp_lm_planted(inp, m22).items():
        res['planted_%s' % k] = v
    _save(tmp_path, rank, res)


def moe_suite(rank, tmp_path):
    """gluon.nn.MoE through the fused step over a data mesh of all the
    ranks: three steps under the profiler, two runs of two steps (the
    same bits twice), and make_moe_train_step over an 'expert' axis of
    all the ranks."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import moe as pmoe
    inp = _inputs(tmp_path)
    n = torch.distributed.get_world_size()
    res = {}
    with mx.cpu():
        ctxs = [mx.cpu(i) for i in range(n)]
        profiler.clear()
        profiler.profiler_set_state('run')
        try:
            net, losses = moe_train(mx, ctxs, k=3)
        finally:
            profiler.profiler_set_state('stop')
        st = profiler.moe_stats()
        for key in ('moe_routed_tokens', 'moe_dropped_tokens',
                    'moe_dispatches', 'moe_drop_frac'):
            res[key] = st[key]
        res['per_expert_routed'] = sum(e['routed'] for e in
                                       st['moe_experts'].values())
        res['per_expert_dropped'] = sum(e['dropped'] for e in
                                        st['moe_experts'].values())
        res['summary'] = profiler.summary(print_out=False)
        res['losses_finite'] = all(np.isfinite(l.asnumpy()).all()
                                   for l in losses)
        for _, p in net.collect_params().items():
            kind = getattr(p, '_moe_counter', None)
            if kind:
                res['block_' + kind] = float(p.list_data()[0].asnumpy().sum())
        for run in (0, 1):
            net, _ = moe_train(mx, ctxs, k=2)
            _put(res, 'par%d' % run, pp_pvals(net))
    mesh = M.make_mesh({'expert': n}, device='cpu')
    E, D, H, Cap = 8, 4, 8, 16
    params = pmoe.place_moe_params(
        {k: inp['moe_' + k] for k in ('router', 'w1', 'w2')}, mesh)
    step = pmoe.make_moe_train_step(mesh, D, H, E, Cap, lr=2.0)
    losses = []
    for _ in range(40):
        loss, params = step(params, inp['moe_x'], inp['moe_y'])
        losses.append(float(loss))
    res['moe_losses'] = np.array(losses)
    _save(tmp_path, rank, res)


def moe_net(pkg, ctx):
    """tests/test_pipeline_train.py's MoE net: Dense(relu), MoE(4
    experts, capacity factor 1), Dense; seeded."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(PP_FEAT, activation='relu', in_units=PP_FEAT))
        net.add(nn.MoE(PP_FEAT, 2 * PP_FEAT, num_experts=4,
                       capacity_factor=1.0))
        net.add(nn.Dense(PP_NCLS, in_units=PP_FEAT))
    net.initialize(ctx=ctx)
    rs = np.random.RandomState(9)
    for _, p in sorted(net.collect_params().items()):
        if p.grad_req == 'null':
            continue
        p.set_data(pkg.nd.array(
            (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.4))
    return net


def moe_train(pkg, ctx, k=3):
    net = moe_net(pkg, ctx)
    tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                           {'learning_rate': 0.05, 'momentum': 0.9})
    fs = pkg.gluon.fuse_step(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                             tr)
    losses = [fs(pkg.nd.array(x), pkg.nd.array(y))
              for x, y in pp_batches(k)]
    return net, losses


MF_VOCABS, MF_RANK, MF_BATCH = (50, 20), 4, 16


def mf_module(pkg, ctxs):
    """A factorization Module: user . item through
    LinearRegressionOutput, both tables sparse_grad, seeded."""
    s = pkg.sym
    u = s.Embedding(s.Variable('user'), input_dim=MF_VOCABS[0],
                    output_dim=MF_RANK, sparse_grad=True, name='user_embed')
    v = s.Embedding(s.Variable('item'), input_dim=MF_VOCABS[1],
                    output_dim=MF_RANK, sparse_grad=True, name='item_embed')
    net = s.LinearRegressionOutput(s.sum(u * v, axis=1), s.Variable('score'),
                                   name='lro')
    mod = pkg.mod.Module(net, data_names=['user', 'item'],
                         label_names=['score'], context=ctxs)
    mod.bind(data_shapes=[pkg.io.DataDesc('user', (MF_BATCH,)),
                          pkg.io.DataDesc('item', (MF_BATCH,))],
             label_shapes=[pkg.io.DataDesc('score', (MF_BATCH,))])
    rs = np.random.RandomState(1)
    mod.init_params(initializer=None, arg_params={
        'user_embed_weight': pkg.nd.array(
            rs.randn(MF_VOCABS[0], MF_RANK).astype(np.float32)),
        'item_embed_weight': pkg.nd.array(
            rs.randn(MF_VOCABS[1], MF_RANK).astype(np.float32))})
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(
        learning_rate=0.5, momentum=0.9))
    return mod


def mf_step(pkg, mod, inp):
    b = pkg.io.DataBatch(data=[pkg.nd.array(inp['mf_user']),
                               pkg.nd.array(inp['mf_item'])],
                         label=[pkg.nd.array(inp['mf_score'])])
    mod.forward_backward(b)
    mod.update()


def launch_worker(out_dir):
    """A worker of tools/launch.py with MXNET_TPU_DIST_JAX=1: the dist
    runtime and one torch.distributed group, a Module over the workers'
    two contexts with ZeRO-1, three steps; writes r<rank>.npz."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    rt = dist.initialize()
    inp = dict(np.load(os.path.join(out_dir, 'inputs.npz')))
    res = {'host_span': dist.host_span_active(),
           'world': torch.distributed.get_world_size()}
    with mx.cpu():
        net = dp_mlp(mx)
        shape = (DP_BATCH, DP_FEAT)
        mod = dp_module(mx, net, [mx.cpu(0), mx.cpu(1)], shape,
                        *dp_params(net, shape), zero=1)
        dp_train(mx, mod, dp_batches(mx, inp['X'], inp['y'])[:3], res, 'w')
    _save(out_dir, rt.rank, res)
    dist.shutdown()
    print('WORKER_OK %d' % rt.rank)


if __name__ == '__main__':
    launch_worker(sys.argv[1])
