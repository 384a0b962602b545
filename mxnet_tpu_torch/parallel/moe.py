"""Expert parallelism: switch-routed mixture of experts, the counterpart of
mxnet_tpu/parallel/moe.py.

Tokens are routed top-1 (Switch Transformer, Fedus et al. 2021) to one of
E two-matmul FFN experts, each taking at most `capacity` tokens; the
overflow is dropped from the expert path (the caller's residual carries
it). `switch_route` is the routing of one device's tokens, `moe_ffn` the
shard_map form over an 'expert' axis of the mesh, run on every rank of
it: each rank routes its own tokens at the local capacity, one
`collectives.all_to_all` sends each expert's bucket to the rank holding
that expert, the experts run, and a second all_to_all brings the
results back. `make_moe_train_step` is the JAX package's toy regression
step over that path, with its gradient scaling (the router's gradient
averaged over the axis, the experts' divided by its size).

The scatter into the (E, C, D) dispatch buffer writes each kept token to
its own (expert, position) slot and each dropped token to a spare row of
its own, which is cut off: no slot is written twice, so the buffer does
not depend on the order the card writes in, and two runs give the same
bits. (The JAX package adds the dropped tokens as zeros at slot C - 1;
the values are the same.)

`gluon.nn.MoE` (gluon/nn/moe.py) runs the same routing inside the fused
Gluon step, with the global semantics of the JAX package's GSPMD step
over a data mesh.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import collectives
from .mesh import P


def capacity_for(num_tokens, num_experts, capacity_factor=1.0):
    """The static per-expert capacity of a capacity factor (Switch
    Transformer eq. 3): ceil(cf * T / E), at least 1."""
    return max(1, int(math.ceil(
        int(num_tokens) * float(capacity_factor) / int(num_experts))))


def route(x, router_w, num_experts):
    """(probs (T, E), gate (T,), expert (T,) int64, onehot (T, E) int32)
    of top-1 routing: the softmax of x @ router_w, its largest
    probability and the first expert that has it."""
    probs = torch.softmax(x @ router_w, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, num_experts).to(torch.int32)
    return probs, gate, expert, onehot


def positions(onehot, offset=None):
    """Each token's 0-based position in its expert's bucket, in token
    order (offset: (E,) tokens of the same expert ahead of these, from
    other ranks)."""
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    if offset is not None:
        pos = pos + (onehot.to(offset.dtype) * offset).sum(dim=-1)
    return pos


def slot_index(expert, pos, keep, num_experts, capacity):
    """Row of each token in a flat (E * C + T) dispatch buffer: its
    (expert, position) slot when kept, else a spare row of its own past
    E * C, so that no row is written twice."""
    n = expert.shape[0]
    spare = num_experts * capacity + torch.arange(n, device=expert.device)
    return torch.where(keep, expert * capacity + pos, spare)


def dispatch(x, idx, num_experts, capacity):
    """The (E, C, D) buffer of the tokens x at their rows idx
    (slot_index); differentiable in x."""
    rows = num_experts * capacity + x.shape[0]
    buf = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_copy(0, idx, x)
    return buf[:num_experts * capacity].reshape(
        (num_experts, capacity) + tuple(x.shape[1:]))


def combine_rows(y, idx, gate, keep):
    """Each token's expert output y[expert, position] times its gate (0
    for a dropped token): the JAX package's einsum('tec,ecd->td',
    combine, y), whose other terms are exact zeros."""
    e, c = y.shape[0], y.shape[1]
    flat = torch.cat([y.reshape(e * c, -1),
                      y.new_zeros((1, y.shape[-1]))])
    rows = torch.where(keep, idx, torch.full_like(idx, e * c))
    return flat.index_select(0, rows) * torch.where(
        keep, gate, torch.zeros_like(gate))[:, None]


def switch_route(x, router_w, num_experts, capacity, with_counts=False):
    """Top-1 routing with per-expert capacity, the JAX package's: x (T,
    D) -> (dispatch (E, C, D), combine (T, E, C), aux_loss); with
    with_counts (routed (E,), dropped (E,)) int32 token counts follow.
    aux_loss is the Switch load-balancing loss (eq. 4), E sum(density *
    density_proxy)."""
    T, D = x.shape
    E, C = int(num_experts), int(capacity)
    probs, gate, expert, onehot = route(x, router_w, E)
    pos = positions(onehot)
    keep = pos < C
    density = onehot.to(x.dtype).mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * E
    idx = slot_index(expert, pos, keep, E, C)
    disp = dispatch(x, idx, E, C)
    comb = torch.zeros((T, E * C + T), dtype=x.dtype, device=x.device)
    comb = comb.scatter(1, idx[:, None], torch.where(
        keep, gate, torch.zeros_like(gate))[:, None])
    comb = comb[:, :E * C].reshape(T, E, C)
    if with_counts:
        assigned = onehot.sum(dim=0)
        routed = (onehot * keep[:, None].to(torch.int32)).sum(dim=0)
        return disp, comb, aux, (routed.to(torch.int32),
                                 (assigned - routed).to(torch.int32))
    return disp, comb, aux


def expert_ffn(buckets, w1, w2):
    """The experts on their buckets: relu(b @ w1) @ w2 per expert,
    (e, n, D) -> (e, n, D)."""
    h = torch.relu(torch.bmm(buckets, w1))
    return torch.bmm(h, w2)


def moe_ffn(x, params, num_experts_total, capacity, axis_name='expert',
            mesh=None):
    """The shard_map body, run on every rank of `axis_name`: x (T, D) this
    rank's tokens; params {'router': (D, E), 'w1': (E_local, D, H),
    'w2': (E_local, H, D)}, the expert weights this rank's block.
    Returns (y (T, D), aux_loss)."""
    mesh = collectives._mesh(mesh)
    e_local = params['w1'].shape[0]
    n_dev = num_experts_total // e_local
    disp, comb, aux = switch_route(x, params['router'], num_experts_total,
                                   capacity)
    d = disp.shape[-1]
    disp = disp.reshape(n_dev, e_local, capacity, d)
    recv = collectives.all_to_all(disp, axis_name, 0, 0, mesh=mesh)
    buckets = recv.transpose(0, 1).reshape(e_local, n_dev * capacity, d)
    y = expert_ffn(buckets, params['w1'], params['w2'])
    y = y.reshape(e_local, n_dev, capacity, d).transpose(0, 1)
    back = collectives.all_to_all(y.contiguous(), axis_name, 0, 0,
                                  mesh=mesh)
    back = back.reshape(num_experts_total, capacity, d)
    out = torch.einsum('tec,ecd->td', comb, back)
    return out, aux


def init_moe_params(dim, hidden, num_experts, generator=None,
                    dtype=torch.float32, device=None):
    """{'router', 'w1', 'w2'}: normal * 0.02, drawn on the CPU from
    `generator` and moved (the numbers differ from jax.random's)."""
    from ..context import resolve_device
    device = resolve_device(device)

    def normal(*shape):
        w = torch.randn(shape, generator=generator) * 0.02
        return w.to(device=device, dtype=dtype)

    return {'router': normal(dim, num_experts),
            'w1': normal(num_experts, dim, hidden),
            'w2': normal(num_experts, hidden, dim)}


def params_from_jax(tree, dtype=None, device=None):
    """The JAX package's {'router', 'w1', 'w2'} tree, as numpy arrays (or
    anything np.array takes), to torch tensors on `device` (dtype None
    keeps each array's own)."""
    from ..context import resolve_device
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return {k: conv(tree[k]) for k in ('router', 'w1', 'w2')}


def moe_param_specs(axis_name='expert'):
    return {'router': P(), 'w1': P(axis_name), 'w2': P(axis_name)}


def place_moe_params(params, mesh, axis_name='expert'):
    """This rank's block of a global tree: the router whole, the experts
    of its index along `axis_name`, on the mesh's device."""
    out = {}
    for k, spec in moe_param_specs(axis_name).items():
        t = torch.as_tensor(params[k]).to(mesh.device)
        if spec and mesh.axis_size(axis_name) > 1:
            t = collectives._block(t, mesh, axis_name, 0)
        out[k] = t.contiguous().clone()
    return out


def make_moe_train_step(mesh, dim, hidden, num_experts, capacity,
                        axis_name='expert', lr=0.1, aux_weight=0.01):
    """The JAX package's toy MoE regression step over the expert path
    (router, all_to_all, experts, all_to_all): step(local_params, x, y)
    -> (loss, new_local_params). local_params is this rank's block
    (place_moe_params); x and y the global (B, D) arrays, of which the
    step takes this rank's block along `axis_name`. The loss is the mean
    over the axis of each rank's mean squared error plus aux_weight
    times its auxiliary loss; the router's gradient is averaged over the
    axis and the experts' divided by its size, as in the JAX step."""
    n = mesh.axis_size(axis_name)

    def step(params, x, y):
        xs = collectives._block(torch.as_tensor(x).to(mesh.device), mesh,
                                axis_name, 0)
        ys = collectives._block(torch.as_tensor(y).to(mesh.device), mesh,
                                axis_name, 0)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        out, aux = moe_ffn(xs, leaves, num_experts, capacity, axis_name,
                           mesh)
        loss = ((out - ys) ** 2).mean() + aux_weight * aux
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        with torch.no_grad():
            if n > 1:
                grads['router'] = collectives._all_reduce(
                    grads['router'], mesh, axis_name) / n
                loss = collectives._all_reduce(loss.detach(), mesh,
                                               axis_name) / n
            grads['w1'] = grads['w1'] / n
            grads['w2'] = grads['w2'] / n
            new = {k: leaves[k] - lr * grads[k] for k in names}
        return loss.detach(), {k: v.detach() for k, v in new.items()}

    return step
