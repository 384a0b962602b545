"""Transformer LM: the counterpart of mxnet_tpu/parallel/transformer.py,
on one device and at dp x tp x sp over a mesh.

The block is the JAX package's own: pre-norm RMSNorm (eps inside the
rsqrt, no mean subtraction), fused QKV projection, causal attention with
no position embedding, tanh-approximated GELU MLP, no biases, and the
output projection tied to the input embedding. Parameters keep the JAX
tree's names and shapes, so `params_from_jax` loads a JAX tree as it is.

`TransformerLM.forward` scores a batch of token sequences (logits) and
`TransformerLM.loss` gives the mean next-token NLL: the serving path.
`make_train_step(cfg)` is the one-device training path: forward,
backward (attention's gradient from the flash backward kernels when
`use_flash`) and a plain SGD update.

`make_train_step(cfg, mesh)` is the sharded step, the body of the JAX
package's shard_map run on this rank's shards: the batch over 'data',
the sequence over 'sp' (ring attention, ring_attention.py), attention
heads and the MLP's hidden units over 'model' (Megatron: the
column-parallel inputs pass `collectives.copy_to_axis`, the row-parallel
outputs `collectives.allreduce_sum`). Its loss is the mean over every
global token and its update w - lr * g with g the one-device gradient.
It departs from the JAX package where that is faulty (ROADMAP Queue C,
findings in the JAX package): `place_params` gives model shard s the
q, k and v columns of its own heads, where the JAX `P(None, 'model')`
split of wqkv hands shard 0 all of q's first heads and part of k; and
the gradients are the one-device gradient, where the JAX step's are
that times the mesh size.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from . import collectives
from .mesh import P, current_mesh
from .ring_attention import (full_attention, ring_attention,
                             ring_self_attention)

_LAYER_KEYS = ('ln1', 'wqkv', 'wo', 'ln2', 'w1', 'w2')


def attention(q, k, v, causal=False, scale=None, impl='auto',
              seq_axis='sp', use_flash=False):
    """Attention dispatch of the JAX package's `attention`: the ring over
    the current mesh's `seq_axis` (mesh.use_mesh) when it has more than
    one rank and divides T, else `full_attention`. q, k, v are global
    [B, H, T, D] arrays; the ring takes each rank's T block and
    all-gathers the output (ring_self_attention). impl: 'auto', 'ring'
    (raise when the mesh cannot carry it) or 'full'."""
    if impl not in ('auto', 'ring', 'full'):
        raise ValueError("attention impl must be 'auto', 'ring' or "
                         "'full', got %r" % (impl,))
    mesh = current_mesh()
    n = 0
    if mesh is not None and seq_axis in mesh.shape:
        n = mesh.shape[seq_axis]
    can_ring = (n > 1 and q.ndim == 4 and q.shape == k.shape
                and k.shape == v.shape and q.shape[-2] % n == 0)
    if impl == 'ring' and not can_ring:
        raise ValueError(
            "attention(impl='ring'): needs an active mesh with a "
            "'%s' axis > 1 dividing T, and identical 4-D q/k/v; got "
            "mesh=%r q=%s k=%s v=%s"
            % (seq_axis, None if mesh is None else dict(mesh.shape),
               tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if impl == 'full' or not can_ring:
        return full_attention(q, k, v, causal=causal, scale=scale,
                              use_flash=use_flash)
    return ring_self_attention(q, k, v, mesh, seq_axis=seq_axis,
                               causal=causal, scale=scale,
                               use_flash=use_flash)


def lm_config(vocab=64, dim=32, heads=4, layers=2, mlp_mult=4,
              use_flash=False):
    """The JAX package's config dict. use_flash routes attention through
    the flash kernel (cuda_ops)."""
    return dict(vocab=vocab, dim=dim, heads=heads, layers=layers,
                mlp_mult=mlp_mult, head_dim=dim // heads,
                use_flash=use_flash)


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    """Parameter tree with the JAX `init_params` names and shapes:
    weights normal * 0.02, norm scales one. Numbers are drawn on the CPU
    from `generator` (a CPU torch.Generator), then moved; they differ
    from JAX's for the same seed."""
    device = resolve_device(device)
    D, V, H = cfg['dim'], cfg['vocab'], cfg['mlp_mult'] * cfg['dim']

    def normal(*shape):
        w = torch.randn(shape, generator=generator) * 0.02
        return w.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    params = {'embed': normal(V, D), 'ln_f': ones(D), 'layers': []}
    for _ in range(cfg['layers']):
        params['layers'].append({
            'ln1': ones(D), 'wqkv': normal(D, 3 * D), 'wo': normal(D, D),
            'ln2': ones(D), 'w1': normal(D, H), 'w2': normal(H, D)})
    return params


def params_from_jax(tree, dtype=None, device=None):
    """The JAX parameter tree `{'embed', 'ln_f', 'layers': [{'ln1',
    'wqkv', 'wo', 'ln2', 'w1', 'w2'}]}`, as numpy arrays, to the port's
    tree on `device`. No weight is transposed or permuted: the columns
    of wqkv are q | k | v, each head-major, as the JAX forward splits
    them. dtype None keeps each array's own."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a))   # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return {'embed': conv(tree['embed']), 'ln_f': conv(tree['ln_f']),
            'layers': [{key: conv(lp[key]) for key in _LAYER_KEYS}
                       for lp in tree['layers']]}


def _rmsnorm(x, scale):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def block_apply(lp, x, heads, head_dim, use_flash):
    """One block on x (batch, seq, dim) with its parameters `lp` (a dict
    of _LAYER_KEYS, or their tensors in that order): the function a
    pipeline stage of the LM runs."""
    if not isinstance(lp, dict):
        lp = dict(zip(_LAYER_KEYS, lp))
    b, t, _ = x.shape
    h = _rmsnorm(x, lp['ln1'])
    q, k, v = (h @ lp['wqkv']).chunk(3, dim=-1)

    def split_heads(z):
        return z.reshape(b, t, heads, head_dim).transpose(1, 2)

    att = full_attention(split_heads(q), split_heads(k), split_heads(v),
                         causal=True, use_flash=use_flash)
    att = att.transpose(1, 2).reshape(b, t, heads * head_dim)
    x = x + att @ lp['wo']
    h = _rmsnorm(x, lp['ln2'])
    y = F.gelu(h @ lp['w1'], approximate='tanh')   # jax.nn.gelu's default
    return x + y @ lp['w2']


class _Block(nn.Module):
    def __init__(self, lp):
        super().__init__()
        for key in _LAYER_KEYS:
            self.register_parameter(key, nn.Parameter(lp[key]))

    def forward(self, x, heads, head_dim, use_flash):
        return block_apply({key: getattr(self, key) for key in _LAYER_KEYS},
                           x, heads, head_dim, use_flash)


class TransformerLM(nn.Module):
    """The LM of `cfg` (lm_config) over a parameter tree from
    `init_params` or `params_from_jax`; it runs where the tree lies."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = dict(cfg)
        self.embed = nn.Parameter(params['embed'])
        self.ln_f = nn.Parameter(params['ln_f'])
        self.layers = nn.ModuleList(_Block(lp) for lp in params['layers'])

    def forward(self, tokens):
        """tokens (batch, seq) int64 -> logits (batch, seq, vocab) in the
        parameters' dtype."""
        cfg = self.cfg
        x = self.embed[tokens]
        for block in self.layers:
            x = block(x, cfg['heads'], cfg['head_dim'], cfg['use_flash'])
        x = _rmsnorm(x, self.ln_f)
        return x @ self.embed.t()

    def loss(self, tokens, targets):
        """Mean next-token NLL of `targets` (counterpart of the JAX
        `_local_loss`)."""
        return nll(self.forward(tokens), targets)


def nll(logits, targets):
    """Mean negative log-likelihood of `targets` (batch, seq) under
    `logits` (batch, seq, vocab), taken in float32."""
    return F.cross_entropy(logits.float().flatten(0, 1), targets.flatten())


def pipe_lm_fns(cfg, num_stages):
    """(stem_fn, stage_fn, head_fn) of the LM cut into num_stages stages of
    layers / num_stages blocks each, for pipeline.make_pipe_step_fn: the
    stem is the embedding lookup (stem leaves [embed]), a stage its
    blocks (six leaves a block, _LAYER_KEYS order), the head RMSNorm
    ln_f, the logits x @ head_w^T and the mean NLL (head leaves [ln_f,
    head_w]). The head's projection is a leaf of its own: the engine
    updates stem and head leaves apart, so an LM tied there trains as
    the untied one (pipe_lm_leaves starts head_w equal to embed). The
    loss leaves are ([nll],) and the differentiated total the nll."""
    if cfg['layers'] % num_stages:
        raise ValueError('%d layers do not split into %d stages'
                         % (cfg['layers'], num_stages))
    per = cfg['layers'] // num_stages
    n = len(_LAYER_KEYS)

    def stem_fn(ws, tokens, rng):
        return ws[0][tokens]

    def stage_fn(ws, x, rng):
        for i in range(per):
            x = block_apply(ws[i * n:(i + 1) * n], x, cfg['heads'],
                            cfg['head_dim'], cfg['use_flash'])
        return x

    def head_fn(ws, x, targets, rng):
        loss = nll(_rmsnorm(x, ws[0]) @ ws[1].t(), targets)
        return [loss], loss

    return stem_fn, stage_fn, head_fn


def pipe_lm_leaves(params, num_stages):
    """The LM tree (init_params / params_from_jax) as the pipelined LM's
    leaves: ([stage s's leaves for each s], [embed], [ln_f, head_w]),
    head_w a copy of embed."""
    layers = params['layers']
    per = len(layers) // num_stages
    stages = []
    for s in range(num_stages):
        leaves = []
        for lp in layers[s * per:(s + 1) * per]:
            leaves.extend(lp[key] for key in _LAYER_KEYS)
        stages.append(leaves)
    return stages, [params['embed']], [params['ln_f'],
                                       params['embed'].clone()]


def make_train_step(cfg, mesh=None, lr=0.1):
    """The train step of the JAX package's `make_train_step`.

    mesh None: the step at dp = tp = sp = 1, `step(model, tokens,
    targets) -> loss`: the mean NLL (`nll`), its gradient, and every
    parameter updated as w <- w - lr * g in the parameter's own dtype,
    with no master weights, momentum or clipping. The update is made in
    place under no_grad, the counterpart of the JAX step's donated
    parameters (`donate_argnums=(0,)`); the returned loss is the one
    before it. `model` is a TransformerLM built for `cfg`.

    With a mesh: `step(local_params, tokens, targets) -> (loss,
    new_local_params)`, the JAX signature. local_params is this rank's
    tree from `place_params`; tokens and targets are the global (B, T)
    arrays, of which the step takes this rank's P('data', 'sp') block.
    The loss is the mean over every global token, the same on every
    rank; the update is w - lr * g with g the one-device gradient (the
    gradients summed over 'data' and 'sp' by a GradReducePlan, one
    all-reduce a bucket). An axis the mesh lacks counts as one rank."""
    cfg = dict(cfg)
    if mesh is not None:
        return _sharded_step(cfg, mesh, lr)

    def step(model, tokens, targets):
        if model.cfg != cfg:
            raise ValueError('make_train_step: the model was built for %s, '
                             'the step for %s' % (model.cfg, cfg))
        model.zero_grad(set_to_none=True)
        loss = model.loss(tokens, targets)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(lr * p.grad)
        return loss.detach()

    return step


def param_specs(cfg):
    """Megatron-style tensor-parallel shardings over 'model' (the JAX
    layout; `place_params` orders wqkv's columns within it)."""
    layer = {
        'ln1': P(), 'wqkv': P(None, 'model'), 'wo': P('model', None),
        'ln2': P(), 'w1': P(None, 'model'), 'w2': P('model', None),
    }
    return {'embed': P(), 'ln_f': P(),
            'layers': [dict(layer) for _ in range(cfg['layers'])]}


def _axis(mesh, name):
    """`name` when the mesh has it with more than one rank, else None."""
    return name if mesh.shape.get(name, 1) > 1 else None


def _model_shard(cfg, mesh):
    """(shards, this rank's index) along 'model'; heads must divide."""
    n = mesh.shape.get('model', 1)
    if cfg['heads'] % n or (cfg['mlp_mult'] * cfg['dim']) % n:
        raise ValueError('%d heads and %d hidden units do not divide over '
                         'model = %d' % (cfg['heads'],
                                         cfg['mlp_mult'] * cfg['dim'], n))
    return n, (mesh.axis_index('model') if n > 1 else 0)


def place_params(params, cfg, mesh):
    """This rank's shards of the global tree `params`, on the mesh's
    device: wqkv's columns [q_s | k_s | v_s] of model shard s's heads
    (each a contiguous block of q's, k's and v's columns), wo's rows of
    the same heads, w1's columns and w2's rows in contiguous blocks; the
    rest whole."""
    n, s = _model_shard(cfg, mesh)
    d, hid = cfg['dim'], cfg['mlp_mult'] * cfg['dim']
    cols = slice(s * d // n, (s + 1) * d // n)
    hcols = slice(s * hid // n, (s + 1) * hid // n)

    def put(t):
        return t.detach().to(mesh.device).contiguous().clone()

    layers = []
    for lp in params['layers']:
        q, k, v = lp['wqkv'].chunk(3, dim=1)
        layers.append({
            'ln1': put(lp['ln1']),
            'wqkv': put(torch.cat([q[:, cols], k[:, cols], v[:, cols]], 1)),
            'wo': put(lp['wo'][cols]), 'ln2': put(lp['ln2']),
            'w1': put(lp['w1'][:, hcols]), 'w2': put(lp['w2'][hcols])})
    return {'embed': put(params['embed']), 'ln_f': put(params['ln_f']),
            'layers': layers}


def gather_params(local, cfg, mesh):
    """The global tree from every rank's `place_params` shards (the
    inverse of place_params), on every rank: checkpoints and tests read
    the sharded step's parameters through it."""
    n, _ = _model_shard(cfg, mesh)

    def gather(t, dim):
        t = t.detach()
        if n == 1:
            return t.clone()
        return collectives._all_gather(t, mesh, 'model', dim)

    layers = []
    for lp in local['layers']:
        blocks = gather(lp['wqkv'], 1).chunk(n, dim=1)
        q, k, v = (torch.cat([blk.chunk(3, dim=1)[i] for blk in blocks], 1)
                   for i in range(3))
        layers.append({
            'ln1': lp['ln1'].detach().clone(),
            'wqkv': torch.cat([q, k, v], 1), 'wo': gather(lp['wo'], 0),
            'ln2': lp['ln2'].detach().clone(), 'w1': gather(lp['w1'], 1),
            'w2': gather(lp['w2'], 0)})
    return {'embed': local['embed'].detach().clone(),
            'ln_f': local['ln_f'].detach().clone(), 'layers': layers}


def tree_leaves(tree):
    """The tree's tensors in a fixed order: embed, ln_f, then each
    layer's ln1, wqkv, wo, ln2, w1, w2."""
    leaves = [tree['embed'], tree['ln_f']]
    for lp in tree['layers']:
        leaves.extend(lp[key] for key in _LAYER_KEYS)
    return leaves


def tree_from_leaves(leaves):
    """The inverse of tree_leaves."""
    leaves = list(leaves)
    tree = {'embed': leaves[0], 'ln_f': leaves[1], 'layers': []}
    for i in range(2, len(leaves), len(_LAYER_KEYS)):
        tree['layers'].append(dict(zip(_LAYER_KEYS,
                                       leaves[i:i + len(_LAYER_KEYS)])))
    return tree


def _local_forward(cfg, mesh, params, tokens):
    """This rank's logits (B_local, T_local, vocab): the JAX
    `_local_forward` with its psums as Megatron's pair."""
    model, sp = _axis(mesh, 'model'), _axis(mesh, 'sp')
    heads = cfg['heads'] // mesh.shape.get('model', 1)
    dh = cfg['head_dim']
    x = params['embed'][tokens]
    b, t, _ = x.shape

    def split_heads(z):
        return z.reshape(b, t, heads, dh).transpose(1, 2)

    for lp in params['layers']:
        h = _rmsnorm(x, lp['ln1'])
        if model:
            h = collectives.copy_to_axis(h, model, mesh)
        q, k, v = (split_heads(z) for z in (h @ lp['wqkv']).chunk(3, -1))
        if sp:
            att = ring_attention(q, k, v, sp, causal=True,
                                 use_flash=cfg['use_flash'], mesh=mesh)
        else:
            att = full_attention(q, k, v, causal=True,
                                 use_flash=cfg['use_flash'])
        o = att.transpose(1, 2).reshape(b, t, heads * dh) @ lp['wo']
        x = x + (collectives.allreduce_sum(o, model, mesh) if model else o)
        h = _rmsnorm(x, lp['ln2'])
        if model:
            h = collectives.copy_to_axis(h, model, mesh)
        y = F.gelu(h @ lp['w1'], approximate='tanh') @ lp['w2']
        x = x + (collectives.allreduce_sum(y, model, mesh) if model else y)
    x = _rmsnorm(x, params['ln_f'])
    return x @ params['embed'].t()


def _sharded_step(cfg, mesh, lr):
    red = tuple(a for a in ('data', 'sp') if _axis(mesh, a))
    plan = []

    def block(t):
        t = torch.as_tensor(t).to(mesh.device)
        for dim, axis in enumerate(('data', 'sp')):
            if _axis(mesh, axis):
                t = collectives._block(t, mesh, axis, dim)
        return t.long()

    def step(local_params, tokens, targets):
        tok, tgt = block(tokens), block(targets)
        leaves = [w.detach().requires_grad_() for w in
                  tree_leaves(local_params)]
        logits = _local_forward(cfg, mesh, tree_from_leaves(leaves), tok)
        # the global mean: this block's mean times its share of tokens
        share = tok.numel() / float(np.prod(tuple(tokens.shape)))
        loss = nll(logits, tgt) * share
        if red:
            loss = collectives.allreduce_sum(loss, red, mesh)
        grads = torch.autograd.grad(loss, leaves)
        if red:
            if not plan:
                plan.append(collectives.GradReducePlan(
                    [g.shape for g in grads], [g.dtype for g in grads]))
            grads = plan[0].apply(grads, mesh, red)
        with torch.no_grad():
            new = [w - lr * g for w, g in zip(leaves, grads)]
        return loss.detach(), tree_from_leaves([w.detach() for w in new])

    return step
