"""Pipeline parallelism: GPipe over a 'pipe' axis of the mesh, the
counterpart of mxnet_tpu/parallel/pipeline.py.

A rank at pipe index s holds stage s's parameters only (in the JAX
package: row s of the stacked (S, ...) leaf, sharded P('pipe')); stem and
head parameters are whole on every rank. M microbatches stream through
the S stages in the fill-drain schedule of T = M + S - 1 ticks.

The JAX package writes the schedule as one scan of ppermutes and lets
autodiff derive the reverse schedule. The port runs it explicitly, one
process a rank: in the fill, stage s takes microbatch i (from the stem on
stage 0, else received from stage s - 1), runs its stage and sends the
activation on, keeping each microbatch's graph; the last stage runs the
head on the whole local batch. In the drain, for each microbatch in
reverse, a stage receives the output's cotangent from stage s + 1 (the
head's on the last stage), takes `torch.autograd.grad` through that
microbatch's saved graph, and sends the input's cotangent to stage
s - 1. Every rank posts its sends and receives in that order, so the
point-to-point pairs of a gloo group always match; the autograd engine
never orders them. A stage runs nothing on the ticks where it has no
microbatch (the JAX scan computes on those bubble ticks and throws the
result away): each stage runs its stage function M times a step forward
and M times backward.

`make_pipe_step_fn` builds the dp x pipe training step on that schedule:
stem and head gradients (non-zero on their owning stage only) summed over
'pipe', the data-axis reduction (a sum, on the int8 or bf16 wire of
MXNET_TPU_DIST_WIRE_DTYPE read once at build, or under ZeRO-1 a
reduce-scatter, the shard's update and an all-gather), and
`optimizer.sgd_update_math` with the hyperparameters baked in; `bulk`
runs K steps back to back in one call. `gluon.fuse_step(pipeline=)`
(gluon/fused.py, PipelinedStep) and `Module.fit(pipeline=)`
(module/pipeline_fit.py) train through it.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from . import mesh as pmesh


def pipe_spec(explicit=None):
    """The pipelined mode: an explicit (num_stages, num_micro) wins, else
    MXNET_TPU_PIPE='stages,micro'. (S, M), or None when off. S >= 2 (one
    stage is data parallelism) and M >= 1."""
    if explicit is None:
        v = os.environ.get('MXNET_TPU_PIPE', '').strip()
        if not v or v == '0':
            return None
        parts = v.split(',')
        if len(parts) != 2:
            raise ValueError(
                "MXNET_TPU_PIPE must be 'stages,micro', got %r" % v)
        explicit = (int(parts[0]), int(parts[1]))
    s, m = int(explicit[0]), int(explicit[1])
    if s < 2:
        raise ValueError('pipeline needs >= 2 stages, got %d' % s)
    if m < 1:
        raise ValueError('pipeline needs >= 1 microbatch, got %d' % m)
    return (s, m)


def make_pipe_mesh(devices, num_stages, data_axis='data', pipe_axis='pipe',
                   device=None):
    """The {data: n / S, pipe: S} mesh over the first n ranks of the
    default group, n = len(devices) (contexts, devices or a count); rank
    (d, s) holds stage s and the d-th data block of every microbatch.
    Made once per group and shape (make_mesh is a collective: every rank
    asks for it at the same point)."""
    n = devices if isinstance(devices, int) else len(devices)
    if n % num_stages:
        raise ValueError('pipeline: %d devices do not divide into %d stages'
                         % (n, num_stages))
    return pmesh.shared_mesh({data_axis: n // num_stages,
                              pipe_axis: int(num_stages)}, device=device)


def bubble_fraction(num_stages, num_micro):
    """GPipe's bubble: (S-1)/(M+S-1) of the schedule's ticks find a stage
    without a microbatch."""
    return (num_stages - 1) / float(num_micro + num_stages - 1)


# -- point to point over the pipe axis ----------------------------------------

def _send(x, mesh, axis, dst):
    ranks, group = mesh.axis_ranks(axis), mesh.group(axis)
    w = collectives._to_wire(mesh, x.detach())
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, w, ranks[dst],
                                                  group)]):
        req.wait()


def _recv(shape, dtype, mesh, axis, src):
    ranks, group = mesh.axis_ranks(axis), mesh.group(axis)
    _note_recv(mesh, shape, dtype)
    out = collectives._wire_empty(mesh, shape, dtype)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, out,
                                                  ranks[src], group)]):
        req.wait()
    return collectives._from_wire(mesh, out)


def _note_recv(mesh, shape, dtype):
    """A receive counts as a collective of its payload, as a send does
    (collectives._to_wire), without a staged copy on its way out."""
    from .. import profiler
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    profiler.add_mesh_stats(collectives=1, payload_bytes=n)


def _broadcast_from(x, mesh, axis, index):
    """Axis index `index`'s x on every rank of the axis."""
    w = collectives._to_wire(mesh, x)
    if w is x:
        w = w.clone()
    dist.broadcast(w, src=mesh.axis_ranks(axis)[index],
                   group=mesh.group(axis))
    return collectives._from_wire(mesh, w)


# -- the schedule ---------------------------------------------------------------

class GPipeSchedule:
    """The fill-drain schedule of one step on this rank (module
    docstring). `fill` runs the forward and keeps each microbatch's
    graph; `drain` runs the backward in reverse microbatch order."""

    def __init__(self, mesh, num_stages, num_micro, axis='pipe'):
        self.mesh, self.axis = mesh, axis
        self.S, self.M = int(num_stages), int(num_micro)
        if mesh.shape.get(axis, 1) != self.S:
            raise ValueError('pipeline of %d stages over a %r axis of %d'
                             % (self.S, axis, mesh.shape.get(axis, 1)))
        self.s = mesh.axis_index(axis)
        self.saved = []
        self.runs = 0               # stage calls, forward and backward

    @property
    def first(self):
        return self.s == 0

    @property
    def last(self):
        return self.s == self.S - 1

    def fill(self, stage, ingest, act_shape, act_dtype):
        """stage(inp) -> out for each microbatch i; ingest(i) -> stage 0's
        input (with its graph into the stem). Returns the last stage's
        outputs (M tensors), None elsewhere."""
        self.saved = []
        outs = []
        for i in range(self.M):
            if self.first:
                inp = ingest(i)
            else:
                inp = _recv(act_shape, act_dtype, self.mesh, self.axis,
                            self.s - 1).requires_grad_(True)
            out = stage(inp)
            self.runs += 1
            if not self.last:
                _send(out, self.mesh, self.axis, self.s + 1)
            else:
                outs.append(out)
            self.saved.append((inp, out))
        return outs if self.last else None

    def drain(self, g_outs, ws, first_targets=()):
        """The backward: g_outs the cotangents of the last stage's outputs
        (None elsewhere); grads of ws summed over the microbatches, and on
        stage 0 of first_targets (the stem's parameters, or the
        microbatches) summed likewise. Returns (g_ws, g_first)."""
        g_ws = [None] * len(ws)
        g_first = [None] * len(first_targets)
        for i in reversed(range(self.M)):
            inp, out = self.saved[i]
            if self.last:
                g = g_outs[i]
            else:
                g = _recv(tuple(out.shape), out.dtype, self.mesh, self.axis,
                          self.s + 1)
            extra = list(first_targets) if self.first else [inp]
            targets = list(ws) + extra
            live = [j for j, t in enumerate(targets) if t.requires_grad]
            got = _vjp(out, [targets[j] for j in live], g)
            self.runs += 1
            grads = [None] * len(targets)
            for j, gj in zip(live, got):
                grads[j] = gj
            for j in range(len(ws)):
                g_ws[j] = _acc(g_ws[j], grads[j])
            if self.first:
                for j in range(len(first_targets)):
                    g_first[j] = _acc(g_first[j], grads[len(ws) + j])
            else:
                gi = grads[len(ws)]
                _send(torch.zeros_like(inp) if gi is None else gi,
                      self.mesh, self.axis, self.s - 1)
            self.saved[i] = None
        self.saved = []
        g_ws = [torch.zeros_like(w) if g is None else g.to(w.dtype)
                for w, g in zip(ws, g_ws)]
        g_first = [torch.zeros_like(t) if g is None else g.to(t.dtype)
                   for t, g in zip(first_targets, g_first)]
        return g_ws, g_first


def _vjp(out, targets, g):
    """The gradients of `targets` for the cotangent g of `out` (None where
    out does not reach one), through the gradient of sum(out * g), whose
    cotangent of out is g bit for bit: torch.autograd.grad given
    grad_outputs imports torch's symbolic-shapes module (sympy) on its
    first call, seconds of a worker process's first step."""
    return torch.autograd.grad((out * g).sum(), targets, allow_unused=True)


def _acc(a, b):
    """a + b, a 16-bit gradient summed in float32 (the drain rounds the
    sum over the microbatches once, as a whole-batch backward rounds its
    gradient once)."""
    if b is None:
        return a
    if b.dtype in (torch.bfloat16, torch.float16):
        b = b.float()
    return b if a is None else a + b


def _leaves(tree):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], ('dict', keys)
    if isinstance(tree, (list, tuple)):
        return list(tree), ('list', len(tree))
    return [tree], ('one', None)


def _tree(leaves, spec):
    kind, keys = spec
    if kind == 'dict':
        return dict(zip(keys, leaves))
    if kind == 'list':
        return list(leaves)
    return leaves[0]


class _PipelineRun(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, stage_fn, spec, ingest, n_ingest, micro, *args):
        leaves = [a.detach().requires_grad_(a.is_floating_point())
                  for a in args[:len(args) - n_ingest]]
        ingest_params = list(args[len(args) - n_ingest:])
        params = _tree(leaves, spec)
        with torch.enable_grad():
            mb = micro.detach().requires_grad_(micro.is_floating_point())
            first = ingest(mb[0]) if ingest is not None else mb[0]
            outs = sched.fill(
                lambda x: stage_fn(params, x),
                lambda i: ingest(mb[i]) if ingest is not None else mb[i],
                tuple(first.shape), first.dtype)
        ctx.sched, ctx.leaves, ctx.mb = sched, leaves, mb
        ctx.ingest_params = ingest_params
        ctx.act = (tuple(first.shape), first.dtype)
        if outs is None:
            return torch.zeros((sched.M,) + ctx.act[0], dtype=ctx.act[1],
                               device=micro.device)
        return torch.stack([o.detach() for o in outs])

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        firsts = [ctx.mb] + ctx.ingest_params
        with torch.enable_grad():
            g_ws, g_first = sched.drain(
                list(g.unbind(0)) if sched.last else None, ctx.leaves,
                [t for t in firsts])
        if not sched.first:
            g_first = [torch.zeros_like(t) for t in firsts]
        g_mb = g_first[0] if ctx.mb.is_floating_point() else None
        return (None, None, None, None, None, g_mb) + \
            tuple(g_ws) + tuple(g_first[1:])


def pipeline_run(stage_fn, params, microbatches, num_stages,
                 axis_name='pipe', ingest=None, ingest_params=(), mesh=None):
    """Stream microbatches (M, mb, ...) through the stages (the shard_map
    body, run on every rank of `axis_name`): stage_fn(params, x) -> y is
    this rank's stage on its parameter tree `params` (a dict, list or
    tensor); only stage 0 reads the microbatches, through
    ingest(mb) -> activation when given (the stem), whose parameters
    `ingest_params` then take their gradients through this call.
    Returns (M, mb, ...): the last stage's outputs there, zeros on the
    other stages (the JAX package leaves garbage). Differentiable: the
    backward is the explicit drain."""
    mesh = collectives._mesh(mesh)
    sched = GPipeSchedule(mesh, num_stages, microbatches.shape[0], axis_name)
    leaves, spec = _leaves(params)
    ingest_params = list(ingest_params)
    return _PipelineRun.apply(sched, stage_fn, spec, ingest,
                              len(ingest_params), microbatches,
                              *leaves, *ingest_params)


def make_pipeline_train_step(stage_fn, loss_fn, mesh, num_micro,
                             axis_name='pipe', lr=0.1):
    """The JAX package's plain pipeline train step: step(params, x,
    targets) -> (loss, new_params), params this rank's stage tree with a
    leading stage dim of 1 (place_pipeline_params), x and targets the
    global batch (only stage 0 reads x). loss_fn(y, targets) on the last
    stage, shared over the axis; new params w - lr * g."""
    S = mesh.axis_size(axis_name)

    def step(params, x, targets):
        leaves, spec = _leaves(params)
        ws = [w[0].detach().requires_grad_() for w in leaves]
        x = torch.as_tensor(x).to(mesh.device)
        targets = torch.as_tensor(targets).to(mesh.device)
        mb = x.shape[0] // num_micro
        micro = x.reshape((num_micro, mb) + tuple(x.shape[1:]))
        outs = pipeline_run(lambda p, v: stage_fn(p, v), _tree(ws, spec),
                            micro, S, axis_name, mesh=mesh)
        last = mesh.axis_index(axis_name) == S - 1
        if last:
            loss = loss_fn(outs.reshape((-1,) + tuple(outs.shape[2:])),
                           targets)
        else:
            loss = (outs * 0).sum()
        grads = torch.autograd.grad(loss, ws)
        shared = _broadcast_from(loss.detach().reshape(1), mesh, axis_name,
                                 S - 1)[0]
        with torch.no_grad():
            new = [(w - lr * g)[None] for w, g in zip(ws, grads)]
        return shared, _tree(new, spec)

    return step


# -- the engine of the two pipelined trainers ----------------------------------

def check_stage_homogeneity(stage_traces, err):
    """Require every stage to run the same computation as stage 0 before
    a step runs stage 0's code with every stage's weights: the trainers'
    structural partition is necessary, not sufficient (two Dense(D)
    blocks with different activations match). stage_traces: per stage
    (fn, ws, act, rng), fn(ws, act, rng) run once on those inputs under
    `op_trace`; err(stage_idx) -> the exception to raise."""
    fps = [op_trace(fn, ws, act, rng) for fn, ws, act, rng in stage_traces]
    for s, fp in enumerate(fps[1:], start=1):
        if fp != fps[0]:
            raise err(s)
    return fps[0]


def op_trace(fn, *args):
    """The sequence of torch functions fn(*args) calls, each with its
    arguments' shapes, dtypes and non-tensor values (the tensors' values
    left out): the port's counterpart of a traced jaxpr with its
    addresses scrubbed. Runs fn once, without gradients, under a
    TorchFunctionMode (a dispatch-level mode would import torch's
    compiler stack, seconds of a worker's first step)."""
    from torch.overrides import TorchFunctionMode

    def desc(a):
        if isinstance(a, torch.Tensor):
            return ('T', tuple(a.shape), str(a.dtype))
        if isinstance(a, (list, tuple)):
            return tuple(desc(b) for b in a)
        if isinstance(a, (int, float, bool, str, type(None))):
            return a
        if isinstance(a, (torch.dtype, torch.device, torch.memory_format,
                          torch.layout)):
            return str(a)
        return type(a).__name__

    class _Rec(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ops.append((getattr(func, '__qualname__', None) or
                             getattr(func, '__name__', str(func)),
                             desc(args), tuple(
                                 (k, desc(v)) for k, v in
                                 sorted(kwargs.items()))))
            return func(*args, **kwargs)

    rec = _Rec()
    with torch.no_grad(), rec:
        fn(*args)
    return tuple(rec.ops)


def grouped_schedule_rows(opt, n_params, group_idx, k, err):
    """(k, n_leaf) float32 lr and wd rows in leaf order: the update count
    bumps for every parameter each step (the host optimizer's
    semantics); each stacked group must resolve to one lr and wd, else
    err(sorted_lrs, sorted_wds) is raised (a per-stage lr_mult cannot
    share a stacked update)."""
    n_leaf = len(group_idx)
    k = max(1, int(k))
    lrs = np.empty((k, n_leaf), np.float32)
    wds = np.empty((k, n_leaf), np.float32)
    for s in range(k):
        per_lr, per_wd = {}, {}
        for i in range(n_params):
            opt._update_count(i)
            per_lr[i] = opt._get_lr(i)
            per_wd[i] = opt._get_wd(i)
        for j, idxs in enumerate(group_idx):
            glr = {per_lr[i] for i in idxs}
            gwd = {per_wd[i] for i in idxs}
            if len(glr) > 1 or len(gwd) > 1:
                raise err(sorted(glr), sorted(gwd))
            lrs[s, j] = glr.pop()
            wds[s, j] = gwd.pop()
    return lrs, wds


def init_pipe_opt_state(mesh, layout, num_stages, stage_ws, stem_ws,
                        head_ws):
    """Fresh momenta for the pipelined update, this rank's: under ZeRO-1
    one (padded / dp,) block of each bucket (the rank's block of the JAX
    package's (S, padded) buffer sharded P('pipe', 'data')); else zeros
    like each weight (stage leaves with their stage dim of 1)."""
    if layout is not None:
        return [torch.zeros(b.padded // layout.dp, dtype=b.acc_dtype,
                            device=mesh.device) for b in layout.buckets]
    return ([torch.zeros_like(w) for w in stage_ws],
            [torch.zeros_like(w) for w in stem_ws],
            [torch.zeros_like(w) for w in head_ws])


def pipe_residency(local_shapes, local_dts, layout):
    """(param_bytes, opt_state_bytes) resident on a rank from the local
    leaf shapes [stage (stage dim dropped)..., stem..., head...]:
    replicated momenta mirror the weights, ZeRO's are the layout's
    blocks."""
    param_b = sum(int(np.prod(s)) * _itemsize(dt)
                  for s, dt in zip(local_shapes, local_dts))
    state_b = layout.state_bytes_per_device() if layout is not None \
        else param_b
    return param_b, state_b


def _itemsize(dt):
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    return np.dtype(dt).itemsize


def measured_bubble(runs, num_stages, num_micro, k=1):
    """The share of the schedule's stage ticks (M + S - 1 forward and as
    many backward, k steps) in which this rank ran no stage, from the
    stage calls it made (GPipeSchedule.runs): (S-1)/(M+S-1) when every
    microbatch ran once each way and no bubble tick ran anything."""
    ticks = 2 * (int(num_micro) + int(num_stages) - 1) * int(k)
    return 1.0 - float(runs) / ticks


def note_pipe_counters(num_stages, num_micro, k, layout, dp, param_b,
                       state_b, bubble):
    """A pipelined dispatch of k steps into the profiler (the engine's
    step calls it with what it ran and holds: the bubble from its stage
    calls, the bytes of the leaves and momenta it returned): the pipe_*
    family, the optimizer-state gauge and the ZeRO bytes."""
    from .. import profiler
    profiler.set_optimizer_state_bytes(state_b)
    profiler.note_pipe_dispatch(num_stages, num_micro, k, bubble,
                                param_bytes=param_b, state_bytes=state_b)
    if layout is not None and dp > 1:
        rs, ag = layout.comm_bytes_per_step()
        profiler.add_comm_bytes(reduce_scattered=rs * k,
                                all_gathered=ag * k)


def _nbytes(tensors):
    out = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            out += _nbytes(t)
        else:
            out += t.numel() * t.element_size()
    return out


def next_rng(rng):
    """The step's next seed (the JAX package splits its key)."""
    return (int(rng) * 6364136223846793005 + 1442695040888963407) % (1 << 63)


def make_pipe_step_fn(mesh, num_stages, num_micro, stem_fn, stage_fn,
                      head_fn, hyper, layout=None, bulk=False,
                      data_axis='data', pipe_axis='pipe'):
    """The dp x pipe training step of the JAX package's engine, on this
    rank (module docstring).

    stem_fn(stem_ws, mb, rng) -> act     the input layers (run by stage 0)
    stage_fn(stage_ws, act, rng) -> act  this rank's stage
    head_fn(head_ws, acts, label, rng) -> (loss_leaves, total)
                                         the output layers and the loss
                                         (run by the last stage on its
                                         whole local batch)
    The leaves are flat lists: stage_ws this rank's stage leaves, each
    with a leading stage dim of 1 (place_pipeline_params); stem_ws and
    head_ws whole. `hyper`: {'momentum', 'rescale', 'clip', 'nesterov'},
    taken by value. `layout`: a zero.ZeroBucketLayout over the local
    leaf order [stage..., stem..., head...] for the ZeRO-1 update (None:
    replicated momenta). `bulk`: K steps a call (inputs with a leading K
    axis, lr and wd as (K, n) rows).

    step(stage_ws, stem_ws, head_ws, opt, rng, data, label, lrs, wds)
      -> (loss_leaves, new_stage_ws, new_stem_ws, new_head_ws, new_opt,
          new_rng)
    data and label are the global batch (this rank takes its block over
    `data_axis`); the loss leaves are the last stage's, shared over
    'pipe' and joined over 'data' along dim 0 (the global batch's). opt
    is (stage_moms, stem_moms, head_moms) mirroring the weights, or
    under ZeRO-1 this rank's block of each bucket (init_pipe_opt_state).
    rng is an int seed, passed to the three functions and advanced once
    a step.

    Gradients: the loss total is this rank's local batch's and is not
    summed over 'pipe' (the drain carries each stage's own gradient);
    stem and head gradients, non-zero on their owning stage only, are
    summed over 'pipe'; then the data-axis sum or reduce-scatter.

    Each call is one dispatch of the profiler's pipe_* family
    (note_pipe_counters): the bubble from the stage calls this rank
    made, the parameter and optimizer-state bytes of what it returned."""
    from ..optimizer import sgd_update_math
    from ..quantization import wire_dtype_from_env

    S, M = int(num_stages), int(num_micro)
    dp = mesh.shape.get(data_axis, 1)
    momentum = hyper['momentum']
    rescale = hyper['rescale']
    clip = hyper['clip']
    nesterov = hyper['nesterov']
    wire = wire_dtype_from_env(None) if dp > 1 and layout is None else None
    probe = {}

    def dp_reduce(g):
        if dp <= 1:
            return g
        if wire == 'int8':
            return collectives.quantized_allreduce(g, data_axis, mesh)
        if wire == 'bf16':
            return collectives._all_reduce(g.to(torch.bfloat16), mesh,
                                           data_axis).to(g.dtype)
        return collectives._all_reduce(g, mesh, data_axis)

    def pipe_sum(g):
        return collectives._all_reduce(g, mesh, pipe_axis)

    def block(t):
        t = torch.as_tensor(t).to(mesh.device)
        if dp > 1:
            t = collectives._block(t, mesh, data_axis, 0)
        return t

    def one_step(stage_ws, stem_ws, head_ws, opt, rng, data, label, lrs,
                 wds, runs):
        sched = GPipeSchedule(mesh, S, M, pipe_axis)
        runs.append(sched)
        sub = int(rng)
        data, label = block(data), block(label)
        b_local = data.shape[0]
        if b_local % M:
            raise ValueError('pipeline: a local batch of %d rows does not '
                             'split into %d microbatches' % (b_local, M))
        micro = data.reshape((M, b_local // M) + tuple(data.shape[1:]))
        sws = [w[0].detach().requires_grad_(True) for w in stage_ws]
        stem = [w.detach().requires_grad_(True) for w in stem_ws]
        head = [w.detach().requires_grad_(True) for w in head_ws]
        key = (tuple(micro.shape), str(micro.dtype), tuple(label.shape),
               str(label.dtype))
        if key not in probe:
            with torch.no_grad():
                act = stem_fn(stem_ws, micro[0], sub)
            probe[key] = [(tuple(act.shape), act.dtype), None]
        act_shape, act_dtype = probe[key][0]
        with torch.enable_grad():
            outs = sched.fill(lambda x: stage_fn(sws, x, sub),
                              lambda i: stem_fn(stem, micro[i], sub),
                              act_shape, act_dtype)
            g_head = [None] * len(head)
            if sched.last:
                out_leaves = [o.detach().requires_grad_(True) for o in outs]
                acts = torch.cat(out_leaves) if out_leaves[0].ndim else \
                    torch.stack(out_leaves)
                leaves, total = head_fn(head, acts, label, sub)
                leaves = [l.detach() for l in leaves]
                targets = head + out_leaves
                got = torch.autograd.grad(total, targets, allow_unused=True)
                g_head = list(got[:len(head)])
                g_outs = list(got[len(head):])
                g_outs = [torch.zeros_like(o) if g is None else g
                          for o, g in zip(out_leaves, g_outs)]
            else:
                leaves, g_outs = None, None
            g_stage, g_stem = sched.drain(g_outs, sws, stem)
        g_head = [torch.zeros_like(w) if g is None else g
                  for w, g in zip(head, g_head)]
        if S > 1:
            g_stem = [pipe_sum(g) for g in g_stem]
            g_head = [pipe_sum(g) for g in g_head]
            leaves = _share_leaves(leaves, probe[key], mesh, pipe_axis, S)
        if dp > 1:
            leaves = [collectives._all_gather(
                l.reshape(1) if l.ndim == 0 else l.contiguous(), mesh,
                data_axis, 0) for l in leaves]
        n_stage, n_stem = len(sws), len(stem)
        with torch.no_grad():
            ws_all = [w.detach() for w in sws + stem + head]
            gs_all = g_stage + g_stem + g_head
            if layout is None:
                moms = [m[0] for m in opt[0]] + list(opt[1]) + list(opt[2])
                new_w, new_m = [], []
                for j, (w, g, m) in enumerate(zip(ws_all, gs_all, moms)):
                    nw, nm = sgd_update_math(
                        w, dp_reduce(g).to(w.dtype), m, lrs[j], wds[j],
                        momentum=momentum, rescale=rescale, clip=clip,
                        nesterov=nesterov)
                    new_w.append(nw)
                    new_m.append(nm)
                new_opt = ([m[None] for m in new_m[:n_stage]],
                           new_m[n_stage:n_stage + n_stem],
                           new_m[n_stage + n_stem:])
            else:
                d = mesh.axis_index(data_axis) if dp > 1 else 0
                new_w = [None] * len(ws_all)
                new_opt = []
                for b in layout.buckets:
                    shard = b.padded // layout.dp
                    lo = d * shard
                    gsh = collectives.reduce_scatter_flat(
                        layout.pack(b, [gs_all[i] for i in b.param_idx]),
                        mesh if dp > 1 else None, data_axis)
                    wsh = layout.pack(b, [ws_all[i] for i in b.param_idx])[
                        lo:lo + shard]
                    lrv = layout.pack_scalars(
                        b, [lrs[i] for i in b.param_idx],
                        mesh.device)[lo:lo + shard]
                    wdv = layout.pack_scalars(
                        b, [wds[i] for i in b.param_idx],
                        mesh.device)[lo:lo + shard]
                    nwsh, nm = sgd_update_math(
                        wsh, gsh, opt[b.index], lrv, wdv, momentum=momentum,
                        rescale=rescale, clip=clip, nesterov=nesterov)
                    full = collectives.all_gather_flat(
                        nwsh.to(b.w_dtype), mesh if dp > 1 else None,
                        data_axis)
                    for i, v in zip(b.param_idx, layout.unpack(b, full)):
                        new_w[i] = v.clone()
                    new_opt.append(nm)
            new_stage = [w[None] for w in new_w[:n_stage]]
            new_stem = new_w[n_stage:n_stage + n_stem]
            new_head = new_w[n_stage + n_stem:]
        return (leaves, new_stage, new_stem, new_head, new_opt,
                next_rng(rng))

    def noted(k, runs, out):
        _, new_stage, new_stem, new_head, new_opt, _ = out
        note_pipe_counters(
            S, M, k, layout, dp, _nbytes([new_stage, new_stem, new_head]),
            _nbytes(new_opt),
            measured_bubble(sum(r.runs for r in runs), S, M, k))
        return out

    def step(stage_ws, stem_ws, head_ws, opt, rng, data, label, lrs, wds):
        runs = []
        if not bulk:
            return noted(1, runs, one_step(stage_ws, stem_ws, head_ws, opt,
                                           rng, data, label, lrs, wds, runs))
        per = []
        for k in range(int(data.shape[0])):
            (leaves, stage_ws, stem_ws, head_ws, opt,
             rng) = one_step(stage_ws, stem_ws, head_ws, opt, rng, data[k],
                             label[k], [float(v) for v in lrs[k]],
                             [float(v) for v in wds[k]], runs)
            per.append(leaves)
        stacked = [torch.stack(col) for col in zip(*per)]
        return noted(len(per), runs, (stacked, stage_ws, stem_ws, head_ws,
                                      opt, rng))

    return step


class PipeDispatch:
    """What the two pipelined trainers (gluon.fuse_step(pipeline=) and
    Module.fit(pipeline=)) do around make_pipe_step_fn on each dispatch:
    the batch check, the ZeRO-1 layout, the momenta and the step seed
    made at the first dispatch, the lr / wd rows, one step function per
    input signature and hyperparameters (the stages' homogeneity checked
    once, before the first is built), and the call under a profiler
    scope. `what` names the entry point in errors, raised as `err`."""

    def __init__(self, mesh, num_stages, num_micro, zero, what, err,
                 data_axis='data'):
        self.mesh = mesh
        self.S, self.M = int(num_stages), int(num_micro)
        self.dp = mesh.shape.get(data_axis, 1)
        self.zero = zero
        self.what, self.err = what, err
        self.layout = None
        self.opt = None
        self.rng = None
        self.fingerprint = None
        self.fns = {}

    def check_batch(self, batch):
        if batch % (self.dp * self.M):
            raise self.err(
                '%s(pipeline=(%d, %d)): batch %d must divide by '
                'dp*num_micro = %d' % (self.what, self.S, self.M, batch,
                                       self.dp * self.M))

    def step_key(self, hyper):
        """The step's hyperparameters and mode: the ZeRO stage and
        layout, the data-axis wire, momentum / rescale / clip /
        nesterov."""
        from ..quantization import wire_dtype_from_env
        wire = wire_dtype_from_env(None) if self.dp > 1 and \
            not self.zero else None
        return (self.S, self.M, self.zero,
                self.layout.key if self.layout is not None else None,
                ('wire', wire), tuple(sorted(hyper.items())))

    def run(self, ws, data, label, bulk, hyper, schedules, make_fns,
            fingerprint, scope):
        """One dispatch: ws = (stage_ws, stem_ws, head_ws) this rank's
        leaves, data and label the global batch (K of them under
        `bulk`); schedules(k) -> the (k, n_leaf) lr and wd rows;
        make_fns() -> (stem_fn, stage_fn, head_fn); fingerprint(mb,
        stem_fn) checks the stages and names the computation. Returns
        (loss_leaves, new_stage_ws, new_stem_ws, new_head_ws)."""
        from .. import profiler
        from . import zero as zero_mod
        stage_ws, stem_ws, head_ws = ws
        k = int(data.shape[0]) if bulk else 1
        batch = int(data.shape[1 if bulk else 0])
        self.check_batch(batch)
        if self.zero and self.layout is None:
            shapes = [tuple(w.shape[1:]) for w in stage_ws] + \
                [tuple(w.shape) for w in stem_ws + head_ws]
            dts = [w.dtype for w in stage_ws + stem_ws + head_ws]
            self.layout = zero_mod.ZeroBucketLayout(
                shapes, dts, [False] * len(dts), self.dp)
        if self.opt is None:
            self.opt = init_pipe_opt_state(self.mesh, self.layout, self.S,
                                           stage_ws, stem_ws, head_ws)
        if self.rng is None:
            from .. import random as _random
            self.rng = int(torch.randint(
                0, 1 << 62, (1,),
                generator=_random.generator(torch.device('cpu'))))
        lr_rows, wd_rows = schedules(k)
        if bulk:
            lrs, wds = lr_rows, wd_rows
        else:
            lrs = [float(v) for v in lr_rows[0]]
            wds = [float(v) for v in wd_rows[0]]
        sig = ('bulk' if bulk else 'step', k,
               ((tuple(data.shape), str(data.dtype)),
                (tuple(label.shape), str(label.dtype))),
               self.step_key(hyper))
        step_fn = self.fns.get(sig)
        if step_fn is None:
            stem_fn, stage_fn, head_fn = make_fns()
            if self.fingerprint is None:
                mb = (data[0] if bulk else data)[:batch // (self.dp * self.M)]
                self.fingerprint = fingerprint(mb, stem_fn)
            step_fn = self.fns[sig] = make_pipe_step_fn(
                self.mesh, self.S, self.M, stem_fn, stage_fn, head_fn,
                hyper, layout=self.layout, bulk=bulk)
        synced = profiler.is_running()
        with profiler.scope(*scope):
            (leaves, new_stage, new_stem, new_head, self.opt,
             self.rng) = step_fn(stage_ws, stem_ws, head_ws, self.opt,
                                 self.rng, data, label, lrs, wds)
            if synced:
                profiler.synchronize(list(leaves))
        return leaves, new_stage, new_stem, new_head


def _share_leaves(leaves, probed, mesh, axis, S):
    """The last stage's loss leaves on every rank of the pipe axis: their
    shapes and dtypes broadcast once (probed[1] keeps them), then one
    broadcast a leaf from the last stage (the JAX package's psum of the
    leaves masked to the last stage)."""
    last = mesh.axis_index(axis) == S - 1
    if probed[1] is None:
        desc = [[(tuple(l.shape), str(l.dtype).split('.')[-1])
                 for l in leaves] if last else None]
        dist.broadcast_object_list(desc, src=mesh.axis_ranks(axis)[S - 1],
                                   group=mesh.group(axis))
        probed[1] = desc[0]
    out = []
    for j, (shape, dt) in enumerate(probed[1]):
        t = leaves[j] if last else torch.zeros(
            shape, dtype=getattr(torch, dt), device=mesh.device)
        out.append(_broadcast_from(t.contiguous(), mesh, axis, S - 1))
    return out


def stack_stage_params(per_stage_params):
    """[stage 0 tree, stage 1 tree, ...] -> one tree whose leaves have a
    leading stage dim (numpy arrays, from the JAX package too, or
    tensors)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_stage_params([p[j] for p in per_stage_params])
                for j in range(len(first))]
    return torch.stack([torch.as_tensor(np.array(p)) if not
                        isinstance(p, torch.Tensor) else p
                        for p in per_stage_params])


def place_pipeline_params(params, mesh, axis_name='pipe'):
    """This rank's row of each stacked (S, ...) leaf, keeping the stage
    dim (1, ...), on the mesh's device (the rank's block of P('pipe')).
    Takes tensors or numpy arrays."""
    if isinstance(params, dict):
        return {k: place_pipeline_params(v, mesh, axis_name)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [place_pipeline_params(v, mesh, axis_name) for v in params]
    t = params if isinstance(params, torch.Tensor) else \
        torch.from_numpy(np.array(params))
    i = mesh.axis_index(axis_name) if mesh.axis_size(axis_name) > 1 else 0
    return t[i:i + 1].to(mesh.device).contiguous().clone()
