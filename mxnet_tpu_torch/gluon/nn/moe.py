"""The mixture-of-experts layer of the fused Gluon step, the counterpart of
mxnet_tpu/gluon/nn/moe.py.

`MoE` routes each token top-1 (Switch Transformer) to one of
`num_experts` two-matmul FFN experts of a static per-expert capacity,
ceil(capacity_factor * T / E); the overflow passes through the residual,
and the load-balancing auxiliary loss rides `aux_loss_scope` into the
fused step's total (parallel/moe.py holds the routing).

Over a data mesh the layer keeps the JAX package's global semantics (its
fused step traces the global batch under GSPMD): T counts every rank's
tokens, a token's position in its expert's bucket is its place in the
global token order (each rank's counts are all-gathered and offset by
the ranks before it), every rank writes its kept tokens into the global
(E, C, D) buffer, `collectives.expert_shard` sums the buffers and hands
each rank its slice of the experts (`expert_range`), the rank runs those
experts on the replicated weights, `collectives.expert_gather` joins the
outputs, and each rank combines its own tokens. The auxiliary loss's
density and density proxy are means over the global tokens, and the
counters are global.

Observability: `routed_count` and `dropped_count` are aux parameters
((E,) float32 cumulative token counts, grad_req='null') that the fused
step threads like BatchNorm's moving statistics, and it feeds their
per-dispatch deltas to profiler.add_moe_stats when the profiler runs.

Training the layer under `autograd.record()` raises: the JAX package's
layer is raw jnp, invisible to its tape, so its weights would get no
gradient there; train it through `gluon.fuse_step`. Inference outside a
recording runs.
"""
from contextlib import contextmanager

import torch

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ...parallel import collectives
from ...parallel import moe as moe_mod
from ..block import HybridBlock, _lookup_param_substitution

# the collector of the auxiliary losses: the fused step opens a scope
# around the net's forward and adds the collected scalars to its total
_AUX_STACK = []


@contextmanager
def aux_loss_scope(collector):
    """Collect every MoE auxiliary loss noted while the scope is open into
    `collector` (a list)."""
    _AUX_STACK.append(collector)
    try:
        yield collector
    finally:
        _AUX_STACK.pop()


def _note_aux_loss(value):
    if _AUX_STACK:
        _AUX_STACK[-1].append(value)


class MoE(HybridBlock):
    """Switch-routed mixture-of-experts FFN with residual.

    units: the token feature dim (input and output: the residual needs
    it); hidden: each expert's hidden dim; num_experts: E;
    capacity_factor: the capacity ceil(cf * T / E) a forward;
    aux_loss_weight: the weight of the load-balancing loss added to the
    fused step's total (0 leaves it out).

    Input (B, units) or (B, T, units); the output has its shape, x plus
    the gate-weighted expert output."""

    def __init__(self, units, hidden, num_experts, capacity_factor=1.0,
                 aux_loss_weight=0.01, weight_initializer=None, **kwargs):
        super(MoE, self).__init__(**kwargs)
        self._units = int(units)
        self._hidden = int(hidden)
        self._num_experts = int(num_experts)
        self._capacity_factor = float(capacity_factor)
        self._aux_loss_weight = float(aux_loss_weight)
        with self.name_scope():
            # names ending in 'weight' take the initializer's weight rule
            self.router = self.params.get(
                'router_weight', shape=(units, num_experts),
                init=weight_initializer)
            self.expert_w1 = self.params.get(
                'expert1_weight', shape=(num_experts, units, hidden),
                init=weight_initializer)
            self.expert_w2 = self.params.get(
                'expert2_weight', shape=(num_experts, hidden, units),
                init=weight_initializer)
            self.routed_count = self.params.get(
                'routed_count', shape=(num_experts,), grad_req='null',
                init='zeros', differentiable=False)
            self.dropped_count = self.params.get(
                'dropped_count', shape=(num_experts,), grad_req='null',
                init='zeros', differentiable=False)
        # the fused step finds the counters by this mark
        self.routed_count._moe_counter = 'routed'
        self.dropped_count._moe_counter = 'dropped'

    def forward(self, x):
        if not isinstance(x, nd.NDArray):
            raise ValueError('MoE forward input must be NDArray, got %s'
                             % type(x))
        if autograd.is_recording() and \
                _lookup_param_substitution(self.router) is None:
            raise MXNetError(
                'gluon.nn.MoE does not train under autograd.record(): its '
                'routing is outside the tape (in the JAX package too, '
                'where its weights get no gradient); train it through '
                'gluon.fuse_step')
        ctx = x.context
        xd = x._data
        if xd.shape[-1] != self._units:
            raise ValueError('MoE(units=%d) got input feature dim %d'
                             % (self._units, xd.shape[-1]))
        with torch.set_grad_enabled(autograd.is_recording()):
            out, aux, routed, dropped = self._route_and_run(
                xd.reshape(-1, self._units), ctx)
            out = out.reshape(xd.shape)
        if autograd.is_training():
            rc = self.routed_count.data(ctx)
            rc._data = rc._data + routed.to(rc._data.dtype)
            dc = self.dropped_count.data(ctx)
            dc._data = dc._data + dropped.to(dc._data.dtype)
            if self._aux_loss_weight:
                _note_aux_loss(aux * self._aux_loss_weight)
        if autograd.is_recording():
            autograd._recorded([out])
        return nd.NDArray(out, ctx)

    def _route_and_run(self, tok, ctx):
        """(tok + expert output, aux loss, routed (E,), dropped (E,)) of
        this rank's tokens, with the global view over an expert mesh."""
        E = self._num_experts
        router = self.router.data(ctx)._data
        w1 = collectives.replicate_constraint(self.expert_w1.data(ctx)._data)
        w2 = collectives.replicate_constraint(self.expert_w2.data(ctx)._data)
        mesh = collectives._expert_mesh('data')
        n = 1 if mesh is None else mesh.axis_size('data')
        probs, gate, expert, onehot = moe_mod.route(tok, router, E)
        counts = onehot.sum(dim=0).to(torch.int64)
        offset = None
        if mesh is None:
            assigned = counts
        else:
            per_rank = collectives._all_gather(counts[None], mesh, 'data', 0)
            assigned = per_rank.sum(dim=0)
            offset = per_rank[:mesh.axis_index('data')].sum(dim=0)
        total = tok.shape[0] * n
        C = moe_mod.capacity_for(total, E, self._capacity_factor)
        pos = moe_mod.positions(onehot, offset)
        keep = pos < C
        # the Switch loss over the global tokens: density from the counts,
        # the proxy's sum over the ranks with its cotangent passed through
        density = assigned.to(tok.dtype) / total
        proxy = probs.sum(dim=0)
        if mesh is not None:
            proxy = collectives.allreduce_sum(proxy, 'data', mesh)
        aux = (density * (proxy / total)).sum() * E
        idx = moe_mod.slot_index(expert, pos, keep, E, C)
        disp = moe_mod.dispatch(tok, idx, E, C)
        # each rank its slice of the experts, of every rank's tokens
        disp = collectives.expert_shard(disp)
        lo, hi = collectives.expert_range(E)
        y = moe_mod.expert_ffn(disp, w1[lo:hi], w2[lo:hi])
        y = collectives.expert_gather(y, E)
        out = tok + moe_mod.combine_rows(y, idx, gate, keep)
        routed = assigned.clamp(max=C)
        return out, aux, routed, assigned - routed

    def __repr__(self):
        return ('MoE(units=%d, hidden=%d, experts=%d, capacity_factor=%g)'
                % (self._units, self._hidden, self._num_experts,
                   self._capacity_factor))
