"""The fused Gluon train step: the counterpart of mxnet_tpu/gluon/fused.py.

    net = nn.HybridSequential(); ...; net.initialize()
    trainer = gluon.Trainer(net.collect_params(), 'sgd', {...})
    fused = gluon.fuse_step(net, loss_fn, trainer)
    for x, y in batches:
        loss = fused(x, y)

One call is the whole step: the block's forward under
`block.param_trace` with its parameters substituted, the loss, the
backward from `loss.backward()`'s ones-head by torch autograd, the
gradients' all-reduce over the data mesh (`collectives.GradReduce`,
started from the backward's hooks when interleaved), the trainer's
`optimizer.FusedSGD` update in place (float32 masters, ZeRO-1), the
BatchNorm moving statistics, and in the same call the metric's device
fold, the weight-EMA arm and the checkpoint hook. `fused.bulk(xs, ys)`
runs K steps (inputs stacked on a leading K axis) back to back with no
host synchronisation among them, lr and wd evaluated at every step.
Torch has nothing to compile: the "program" of a step is the function
that runs it, kept in the port's exec_cache under the JAX package's key
(a fingerprint of the net's structure, the optimizer's step key, the
mode, K and the placement), so a re-created net and Trainer of the same
architecture hit the cache as they do there.

The pair route. Inside the step, a HybridSequential offers each Conv2D
and the BatchNorm right after it to `_PairRoute`: a 2-D conv with no
bias, no activation, groups 1 and dilation 1, then a BatchNorm on axis 1
without use_global_stats, on bfloat16 data and weight, runs as one pair
on `cuda_conv.conv2d_bn_stats` through the executor's `pair_conv` and
`pair_batch_norm` (the conditions of the executor's `conv_bn_pairs`;
float32 pairs stay unfused there too, since float32 BatchNorm takes the
two-pass variance). The BatchNorm takes its mean and variance from the
kernel's s1, s2 and count, summed over the data mesh. The pair's output
is the kernel's NHWC tensor seen as NCHW (channels-last strides), so
the next pair's NHWC view is the same bytes and no permute copy is
made. A bf16 resnet50_v1 has 21 such pairs (the stem, the 16 3x3 convs,
the 4 projections; the bottlenecks' 1x1 convs carry a bias).

Several contexts. A trainer over N contexts is N ranks of a 'data' mesh,
as a Module is (module/executor_group.py): every rank runs the same
script with the global batch, the step cuts this rank's rows, BatchNorm's
statistics and the metric are global, and the returned loss is the
global batch's. In one process several contexts raise, naming the
launchers. Sparse embedding tables (Embedding(sparse_grad=True)) train
rows-only (parallel/embedding.py) and, under a mesh, stripe their rows
over the ranks: a rank's table and momentum hold ~1/N of the rows.
`full_param(p)` assembles a striped table (a collective).

`step_ahead` (MXNET_TPU_TRAIN_STEP_AHEAD, default 1): the host returns
from step t once step t - k has finished on the device (a CUDA event),
so it runs at most k steps ahead; 0 waits for every step. The depth
changes when the host waits, never a bit of what is computed.

Counters: profiler.gluon_fused_stats(), the 'gluon_fused' span
category, the overlap_* counters and, with sparse tables, embed_stats().
"""
import contextlib
import hashlib
import os
import time
from collections import deque

import numpy as np
import torch

from .. import autograd
from .. import exec_cache
from .. import metric as metric_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from .. import profiler
from ..base import MXNetError
from ..context import Context
from ..ops.registry import OpContext, normalize_axis
from ..parallel import collectives
from ..parallel import embedding as embed_mod
from ..parallel import mesh as pmesh
from ..parallel import zero as zero_mod
from . import block as block_mod


def resolve_step_ahead(step_ahead=None):
    """How many fused steps may be in flight behind the host
    (MXNET_TPU_TRAIN_STEP_AHEAD, default 1; 0, 'off', 'none' or 'false':
    wait for every step)."""
    if step_ahead is not None:
        return max(0, int(step_ahead))
    raw = (os.environ.get('MXNET_TPU_TRAIN_STEP_AHEAD', '') or '') \
        .strip().lower()
    if raw in ('0', 'off', 'none', 'false'):
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 1


def fuse_step(net, loss, trainer, mesh=None, zero=None, metric=None,
              ema_decay=None, interleave=None, checkpoint=None,
              pipeline=None, step_ahead=None):
    """Build (and register on `trainer`) the FusedStep of `net` trained
    by `trainer` on `loss` (a gluon loss, any callable of (out, label),
    or None when the net's output is the loss). mesh: a mesh with a
    'data' axis (default: the data mesh of the trainer's contexts when
    there are several); zero: the ZeRO stage (None: MXNET_TPU_ZERO);
    metric: an EvalMetric with a device fold, updated inside the step;
    ema_decay: a float in (0, 1) adding a weight EMA (FusedStep.ema());
    interleave: the gradient reduction schedule (None:
    MXNET_TPU_INTERLEAVE_REDUCE); checkpoint: an
    elastic.CheckpointManager restored before the first step and fed
    every step; step_ahead: see resolve_step_ahead. pipeline: (stages,
    micro), or None for MXNET_TPU_PIPE='stages,micro': the dp x pipe GPipe
    mode (PipelinedStep), which takes none of metric, ema_decay,
    checkpoint, mesh and interleave. After this call
    `trainer.step_fused(batch_size, *args)` runs the step too."""
    from ..parallel import pipeline as pipe_mod
    spec = pipe_mod.pipe_spec(pipeline)
    if spec is not None:
        sparse = [p.name for p in trainer._params
                  if getattr(p, 'sparse_grad', False)]
        if sparse:
            raise MXNetError(
                'fuse_step: the pipelined mode (pipeline=%r) does not take '
                'sparse_grad embedding tables (%s): their row-sharded COO '
                'update has no stage placement' % (spec, ', '.join(sparse)))
        for bad, name in ((metric, 'metric'), (ema_decay, 'ema_decay'),
                          (checkpoint, 'checkpoint'), (mesh, 'mesh'),
                          (interleave, 'interleave')):
            if bad is not None:
                raise ValueError(
                    'fuse_step: %s= does not compose with the pipelined '
                    'mode yet (pipeline=%r)' % (name, spec))
        return PipelinedStep(net, loss, trainer, spec, zero=zero)
    return FusedStep(net, loss, trainer, mesh=mesh, zero=zero,
                     metric=metric, ema_decay=ema_decay,
                     interleave=interleave, checkpoint=checkpoint,
                     step_ahead=step_ahead)


def _block_signature(block):
    """The structure of a block tree without its names: each block's
    class, its attributes of plain types and its children's."""
    items = [type(block).__name__]
    for k, v in sorted(vars(block).items()):
        if k in ('_prefix', '_name', '_scope', '_params', '_children',
                 '_reg_params', '_cached_fn', '_empty_prefix') or \
                isinstance(v, (block_mod.Block,)):
            continue
        if isinstance(v, (bool, int, float, str, tuple, list, dict,
                          type(None), np.dtype, type)):
            items.append((k, repr(v)))
    items.append(tuple(_block_signature(c)
                       for c in getattr(block, '_children', ())))
    return tuple(items)


class _PairRoute:
    """The conv -> BatchNorm pair route of one fused step (module
    docstring); `pairs` counts the pairs it ran and `shapes` maps each
    pair's (x NHWC, w HWIO, stride, pad) as the kernel gets them to their
    number. `dtypes` are the data dtypes it routes: bfloat16, as the
    executor's route (a test or a check may add float32, whose pairs then
    take the one-pass variance from the kernel's sums)."""

    dtypes = (torch.bfloat16,)

    def __init__(self, device):
        self.device = device
        self.pairs = 0
        self.shapes = {}

    def __call__(self, conv, bn, x):
        from .nn.conv_layers import Conv2D
        from .nn.basic_layers import BatchNorm
        if type(conv) is not Conv2D or type(bn) is not BatchNorm or \
                not isinstance(x, nd.NDArray) or x.ndim != 4:
            return None
        kw = conv._kwargs
        if conv._transposed or conv.act is not None or \
                not kw['no_bias'] or len(kw['kernel']) != 2 or \
                kw['num_group'] != 1 or any(d != 1 for d in kw['dilate']):
            return None
        bkw = bn._kwargs
        if normalize_axis(bkw['axis'], 4) != 1 or bkw['use_global_stats']:
            return None
        sub = block_mod._lookup_param_substitution
        w = sub(conv.weight)
        if w is None or x._data.dtype not in self.dtypes or \
                w._data.dtype != x._data.dtype:
            return None
        from ..executor import pair_conv, pair_batch_norm
        from ..ops.nn import conv_params
        _, stride, _, pad, _ = conv_params(kw)
        xt = x._data.permute(0, 2, 3, 1)
        if not xt.is_contiguous():
            xt = xt.contiguous()
        y, sums = pair_conv(xt, w._data, stride, pad)
        o, c, kh, kw = w.shape
        key = (tuple(xt.shape), (kh, kw, c, o), tuple(stride), tuple(pad))
        self.shapes[key] = self.shapes.get(key, 0) + 1
        gamma, beta, rmean, rvar = (sub(p) for p in (
            bn.gamma, bn.beta, bn.running_mean, bn.running_var))
        op_ctx = OpContext(is_train=True, rng=None, device=self.device)
        outs, updated = pair_batch_norm(
            bkw, [y, gamma._data, beta._data],
            [rmean._data.detach(), rvar._data.detach()], op_ctx, sums)
        rmean._data = updated[0].detach()
        rvar._data = updated[1].detach()
        out = outs[0].permute(0, 3, 1, 2)
        autograd._recorded([out])
        self.pairs += 1
        return nd.NDArray(out, x._ctx)


class _pair_scope:
    def __init__(self, route):
        self._route = route

    def __enter__(self):
        self._prev = block_mod._PAIR_ROUTE[0]
        block_mod._PAIR_ROUTE[0] = self._route
        return self._route

    def __exit__(self, *exc):
        block_mod._PAIR_ROUTE[0] = self._prev
        return False


def _run_program(fs, bulk, k, arrays, full_arrays, rungs):
    """The body every cached program runs (it keeps nothing of the net
    or the trainer: the step it is handed carries them)."""
    return fs._execute(bulk, k, arrays, full_arrays, rungs)


class FusedStep:
    """One whole training step a call (module docstring):
    `loss = fused(x, y)`; `losses = fused.bulk(xs, ys)` for K steps."""

    def __init__(self, net, loss, trainer, mesh=None, zero=None,
                 metric=None, ema_decay=None, interleave=None,
                 checkpoint=None, step_ahead=None):
        self._checkpoint = checkpoint
        self._step_ahead = resolve_step_ahead(step_ahead)
        self._inflight = deque()
        self._ckpt_resume_tried = False
        self._net = net
        self._loss = loss
        self._trainer = trainer
        self._metric = metric
        self._metric_fold = None
        if metric is not None:
            if loss is None:
                raise ValueError(
                    'fuse_step: device-resident metrics need the net '
                    'output and a label (loss=None nets expose neither)')
            self._metric_fold = metric_mod.device_fold(metric)
            if self._metric_fold is None:
                raise ValueError(
                    'fuse_step: metric %r has no device fold (see '
                    'metric.device_fold); update it on the host loop '
                    'instead' % (getattr(metric, 'name', metric),))
            for leaf in self._metric_fold.leaves:
                if leaf.output_names is not None or \
                        leaf.label_names is not None:
                    raise ValueError(
                        'fuse_step: metric %r declares output_names/'
                        'label_names; name routing only applies on the '
                        'Module path (bulk_step/fit)' % leaf.name)
        if ema_decay is not None and not 0.0 < float(ema_decay) < 1.0:
            raise ValueError('ema_decay must be in (0, 1), got %r'
                             % (ema_decay,))
        self._ema_decay = None if ema_decay is None else float(ema_decay)
        self._ema_state = None
        self._interleave = collectives.interleave_reduce_enabled(interleave)
        self._reduce_plan = None
        self._moe_aux = []
        if type(trainer._optimizer) not in (opt_mod.SGD, opt_mod.NAG):
            raise ValueError(
                'fuse_step: optimizer %s has no fused whole-model update '
                '(SGD and NAG fuse); use trainer.step instead'
                % type(trainer._optimizer).__name__)
        ctxs = list(trainer._contexts) or [None]
        self._ctxs = ctxs
        if mesh is None and len(ctxs) > 1:
            from ..module.executor_group import data_mesh_for
            mesh = data_mesh_for(ctxs, 'a fused Gluon step')
        if mesh is not None and mesh.shape.get('data', 1) <= 1:
            mesh = None
        if mesh is not None and 'data' not in mesh.shape:
            raise ValueError("fuse_step runs over the 'data' axis of a "
                             'mesh; its axes are %s' % (mesh.axis_names,))
        self._mesh = mesh
        self._dp = 1 if mesh is None else mesh.axis_size('data')
        self._rank = 0 if mesh is None else mesh.axis_index('data')
        if mesh is not None:
            self._device = mesh.device
            self._ctx = Context.from_device(mesh.device)
        else:
            self._ctx = ctxs[0]
            self._device = ctxs[0].torch_device if ctxs[0] is not None \
                else None
        self._zero = zero_mod.zero_stage(zero)
        self._params = None
        self._aux_params = None
        self._frozen_params = None
        self._splan = None
        self._sparse_pos = frozenset()
        self._programs = {}
        self._loss_structure = None
        self._placed = False
        self._deferred_done = False
        # mesh mode: id(param) -> the tensor the step keeps for it (its
        # stripe for a sparse table); a slot holding another tensor was
        # replaced by user code (set_data, load_params)
        self._repl = {}
        # the pairs the last step ran on the kernel, and their shapes
        self.routed_pairs = 0
        self.routed_shapes = {}
        trainer._fused_step = self

    # -- parameters --------------------------------------------------------
    def _collect_params(self):
        if self._params is not None:
            return
        allp = dict(self._net.collect_params().items())
        if hasattr(self._loss, 'collect_params'):
            for name, p in self._loss.collect_params().items():
                allp.setdefault(name, p)
        trainable = {id(p) for p in self._trainer._params}
        aux, frozen = [], []
        for name in sorted(allp):
            p = allp[name]
            if id(p) in trainable:
                continue
            (aux if p.grad_req == 'null' else frozen).append(p)
        self._params = list(self._trainer._params)
        self._aux_params = aux
        self._frozen_params = frozen

    def _make_sparse_plan(self):
        self._splan = embed_mod.gluon_sparse_plan(self._params)
        self._sparse_pos = frozenset(self._splan.positions) \
            if self._splan else frozenset()
        if self._splan and self._ema_decay is not None:
            raise MXNetError(
                'fuse_step: ema_decay does not compose with sparse_grad '
                'embedding tables: the EMA arm (ema <- d*ema + (1-d)*w) '
                'reads and writes every table row every step, the '
                'traffic the sparse tier removes; drop ema_decay or set '
                'sparse_grad=False')

    def _finish_deferred(self, arrays, bulk):
        """Parameters of deferred shape complete on one eager forward of
        the first batch."""
        if self._deferred_done:
            return
        if any(p._deferred_init for p in
               self._net.collect_params().values()):
            n_data = len(arrays) if self._loss is None else len(arrays) - 1
            with autograd.pause(train_mode=False):
                self._net(*[nd.NDArray(a[0] if bulk else a, self._ctx)
                            for a in arrays[:n_data]])
        self._deferred_done = True

    def _all_params(self):
        return self._params + self._aux_params + self._frozen_params

    def _bind(self, p, t):
        """Every context slot of `p` holds tensor `t`."""
        for arr in p.list_data():
            arr._data = t
        self._repl[id(p)] = t

    def _place(self):
        """Under a mesh: the parameters replicated from data rank 0 on
        the mesh's device, each sparse table cut to this rank's stripe."""
        if self._mesh is not None:
            for p in self._all_params():
                self._gather_param(p)
        self._placed = True

    def _gather_param(self, p):
        """The tensor the step trains for `p` (under a mesh: this rank's,
        re-replicated from data rank 0 when user code replaced it)."""
        cur = p.list_data()[0]._data
        if self._mesh is None:
            return cur
        kept = self._repl.get(id(p))
        if kept is not None and cur is kept:
            return kept
        t, = pmesh.replicate_params(self._mesh, [cur])
        if id(p) in self._sparse_ids():
            t = embed_mod.stripe_of(t, self._mesh)
        self._bind(p, t)
        return t

    def _sparse_ids(self):
        return {id(self._params[j]) for j in self._sparse_pos}

    def full_param(self, p):
        """The full value of `p`: a striped sparse table assembled from
        every rank (a collective: every rank calls it); else its
        tensor."""
        t = self._gather_param(p) if self._placed else \
            p.list_data()[0]._data
        if id(p) in self._sparse_ids() and t.shape[0] != p.shape[0]:
            return embed_mod.unstripe(t, p.shape[0], self._mesh)
        return t

    # -- optimizer -------------------------------------------------------
    def _ensure_updater(self, batch_size):
        """The trainer's FusedSGD, rebuilt when rescale_grad changes (the
        update reads it at construction); its states carry over."""
        tr = self._trainer
        rescale = tr._scale / batch_size
        fu = tr._fused_updater
        if fu is not None and fu.optimizer is tr._optimizer and \
                fu.rescale == float(rescale):
            return fu
        tr._optimizer.rescale_grad = rescale
        sp = tuple(self._splan.positions) if self._splan else ()
        new = opt_mod.create_fused_updater(
            tr._optimizer, list(range(len(self._params))), zero=self._zero,
            mesh=self._mesh, interleave=self._interleave, sparse_idx=sp,
            sparse_vocab={j: int(self._params[j].shape[0]) for j in sp})
        if fu is not None:
            new.transfer_states_from(fu)
        elif tr._pending_fused_states is not None:
            new.set_states(tr._pending_fused_states)
            tr._pending_fused_states = None
        tr._fused_updater = new
        return new

    # -- sparse tables ---------------------------------------------------
    def _dispatch_rungs(self, full_arrays, shapes, bulk):
        """Per-table rungs of one call: facts published by an equivalent
        step adopted, then host-counted uniques where a table's ids are
        inputs."""
        plan = self._splan
        plan.set_sig(shapes)
        if not plan.srcs:
            facts = exec_cache.get(plan.facts_key())
            if facts is not None:
                plan.src.update(facts[0])
                plan.srcs.update(facts[1])
                plan.slots.update(facts[2])
        host_ids = {}
        for srcs in plan.srcs.values():
            for kidx in srcs:
                if kidx is not None and kidx < len(full_arrays) and \
                        kidx not in host_ids:
                    host_ids[kidx] = full_arrays[kidx].detach().cpu().numpy()
        return plan.pick_rungs(host_ids, bulk=bulk)

    def _sparse_rows(self, ws, ins, full_ins, rungs, capture):
        """(overrides, [(uids, rows, lo)]) of one step: each table's ids
        over the global batch deduplicated at its rung and its rows
        gathered as a leaf. `capture` runs the forward once with no
        gradient to find the ids (derived ids, or the first step)."""
        plan = self._splan
        if capture:
            watch = {id(ws[e['pos']]): e['pos'] for e in plan.entries}
            ins_map = {id(t): j for j, t in enumerate(ins)}
            from .. import random as _random
            gen = _random.generator(self._device or torch.device('cpu'))
            state = gen.get_state()
            with embed_mod.capture_scope(watch, ins_map) as cs, \
                    torch.no_grad():
                self._forward(ws, ins, {}, record=False)
            gen.set_state(state)
        out_ov, out_rows = {}, []
        for e, rung in zip(plan.entries, rungs):
            pos = e['pos']
            if capture:
                ids = cs.records.get(pos)
                if not ids:
                    raise MXNetError(
                        'sparse embedding: table %s (sparse_grad=True) was '
                        'never looked up in the forward; unused sparse '
                        'tables cannot ride the fused step' % e['name'])
                plan.note_sources(pos, cs.sources[pos])
                glob = [embed_mod.gather_global_ids(t, self._mesh)
                        for t in ids]
            else:
                glob = [full_ins[k].reshape(-1) for k in plan.srcs[pos]]
            plan.note_slots(pos, sum(int(t.numel()) for t in glob))
            eff = min(int(rung), plan.capacity(e))
            uids, invs = embed_mod.dedup_ids(glob, eff, e['vocab'])
            local = []
            for inv in invs:
                n = inv.numel() // self._dp
                local.append(inv[self._rank * n:(self._rank + 1) * n])
            rows = embed_mod.striped_gather(ws[pos], uids, e['vocab'],
                                            self._mesh)
            rows = rows.detach().requires_grad_(True)
            out_ov[id(ws[pos])] = embed_mod._Override(rows, local, e['dim'])
            lo = 0 if self._mesh is None else embed_mod.stripe_range(
                e['vocab'], self._dp, self._rank)[0]
            out_rows.append((uids, rows, lo))
        return out_ov, out_rows

    # -- the step ----------------------------------------------------------
    def _forward(self, ws, ins, sub_extra, record=True):
        """The forward and loss on `ins` with the parameters bound to ws
        (aux and frozen values from sub_extra, or their own): (loss
        leaves, net outputs, sub)."""
        ctx = self._ctx
        sub = {p: nd.NDArray(w, ctx) for p, w in zip(self._params, ws)}
        for p in self._aux_params:
            sub[p] = nd.NDArray(sub_extra.get(p, self._gather_param(p))
                                .detach(), ctx)
        for p in self._frozen_params:
            sub[p] = nd.NDArray(self._gather_param(p).detach(), ctx)
        in_nd = [nd.NDArray(t, ctx) for t in ins]
        from .nn import moe as moe_mod
        moe_aux = []
        with block_mod.param_trace(sub, train_mode=True), \
                moe_mod.aux_loss_scope(moe_aux):
            if self._loss is not None:
                out = self._net(*in_nd[:-1])
                outs = list(out) if isinstance(out, (list, tuple)) \
                    else [out]
                l = self._loss(*outs, in_nd[-1])
            else:
                outs = []
                l = self._net(*in_nd)
        leaves, self._loss_structure = block_mod._flatten(l)
        self._moe_aux = moe_aux
        return leaves, outs, sub

    def _one_step(self, ins, full_ins, moms, masters, lrs, wds, mcarry,
                  rungs, capture):
        """One train step on this rank's inputs `ins` (`full_ins`: the
        global batch's, for the sparse ids); returns (loss leaves, moms,
        masters, mcarry)."""
        ws = [self._gather_param(p) for p in self._params]
        sparse = self._sparse_pos
        dense = [j for j in range(len(ws)) if j not in sparse]
        leaves = list(ws)
        for j in dense:
            leaves[j] = ws[j].detach().requires_grad_(True)
        ov, srows = ({}, [])
        if self._splan:
            ov, srows = self._sparse_rows(ws, ins, full_ins, rungs, capture)
        red = self._reduce_pass([leaves[j] for j in dense])
        route = _PairRoute(self._device)
        known = [leaves[j] for j in dense] + [r for _, r, _ in srows] + \
            list(ins) + [ws[j] for j in sparse]
        with pmesh.data_mesh_scope(self._mesh), \
                autograd._nested_recording(known), torch.enable_grad(), \
                embed_mod.override_scope(ov), _pair_scope(route):
            loss_leaves, outs, sub = self._forward(leaves, ins, {})
            total = None
            for x in loss_leaves:
                s = x._data.sum().float()
                total = s if total is None else total + s
            # MoE auxiliary losses join the differentiated total, not the
            # reported loss
            for a in self._moe_aux:
                total = total + a.sum().float()
        self.routed_pairs = route.pairs
        self.routed_shapes = route.shapes
        targets = [leaves[j] for j in dense] + [r for _, r, _ in srows]
        grads = list(torch.autograd.grad(total, targets, allow_unused=True))
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(targets, grads)]
        gs = [None] * len(ws)
        dg = grads[:len(dense)]
        if red is not None:
            dg = red.finish(dg)
        for j, g in zip(dense, dg):
            gs[j] = g
        for e, (uids, rows, lo), g in zip(
                self._splan.entries if self._splan else (), srows,
                grads[len(dense):]):
            if self._mesh is not None:
                g = collectives._all_reduce(g, self._mesh, 'data')
            gs[e['pos']] = (uids, g, lo)
        with torch.no_grad():
            _, moms, masters = self._updater.step_math(
                ws, gs, moms, masters, lrs, wds)
            for p in self._aux_params:
                new = sub[p]._data.detach()
                if self._mesh is None:
                    for arr in p.list_data():
                        arr._data = new
                else:
                    self._bind(p, new)
            if self._ema_decay is not None:
                d = self._ema_decay
                self._ema_state = [d * e + (1.0 - d) * w
                                   for e, w in zip(self._ema_state, ws)]
            if self._metric_fold is not None:
                mcarry = self._metric_fold.update(
                    mcarry, {'label': ins[-1]},
                    {'output%d' % i: o._data.detach()
                     for i, o in enumerate(outs)})
        return ([x._data.detach() for x in loss_leaves], moms, masters,
                mcarry)

    def _reduce_pass(self, dense_leaves):
        """The gradient all-reduce of one backward over the data mesh
        (None without a mesh, or under ZeRO, whose update
        reduce-scatters)."""
        if self._mesh is None or self._zero:
            return None
        if self._reduce_plan is None:
            self._reduce_plan = collectives.GradReducePlan(
                [t.shape for t in dense_leaves],
                [t.dtype for t in dense_leaves],
                interleave=self._interleave)
        red = collectives.GradReduce(self._reduce_plan, self._mesh,
                                     range(len(dense_leaves)))
        return red.begin(dense_leaves)

    def _execute(self, bulk, k, arrays, full_arrays, rungs):
        """K steps (1 unless bulk) on this rank's `arrays`."""
        fu = self._updater
        weights = [nd.NDArray(self._gather_param(p), self._ctx)
                   for p in self._params]
        moms, masters, lr_rows, wd_rows = fu.host_prep_steps(weights, k)
        mcarry = self._metric_fold.init(self._device) \
            if self._metric_fold is not None else ()
        losses = []
        for i in range(k):
            ins = [a[i] for a in arrays] if bulk else list(arrays)
            full = [a[i] for a in full_arrays] if bulk else list(full_arrays)
            capture = bool(self._splan) and not self._splan.direct()
            loss, moms, masters, mcarry = self._one_step(
                ins, full, moms, masters, lr_rows[i], wd_rows[i], mcarry,
                rungs, capture)
            losses.append(loss)
        fu.commit(moms, masters)
        if self._metric_fold is not None:
            self._metric_fold.commit(
                metric_mod.DeviceFold.global_carry(mcarry, self._mesh))
        return losses

    # -- execution ---------------------------------------------------------
    def __call__(self, *args, batch_size=None):
        """One fused step: args are the net inputs then the label (none
        when loss is None); batch_size defaults to the first input's
        leading dim. Returns the per-sample loss (the global batch's)."""
        return self._run(args, bulk=False, batch_size=batch_size)

    def bulk(self, *args, batch_size=None):
        """K fused steps in one call, each input stacked on a leading K
        axis; lr and wd evaluated at every step. Returns the losses
        stacked on a leading K axis."""
        return self._run(args, bulk=True, batch_size=batch_size)

    def _tensor(self, a):
        if isinstance(a, nd.NDArray):
            return a._data
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.asarray(a))

    def _fingerprint(self, shapes):
        params = [(tuple(p.shape), str(p.list_data()[0]._data.dtype),
                   p.grad_req, bool(getattr(p, 'sparse_grad', False)))
                  for p in self._all_params()]
        sig = repr((_block_signature(self._net),
                    _block_signature(self._loss)
                    if isinstance(self._loss, block_mod.Block)
                    else type(self._loss).__name__, params, shapes,
                    len(self._params), len(self._aux_params)))
        return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()

    def _full_step_key(self, fkey, rungs):
        return (fkey, ('ema', self._ema_decay),
                ('metric', self._metric_fold.key
                 if self._metric_fold is not None else None),
                ('reduce', self._interleave if self._mesh is not None
                 else None),
                ('embed', self._splan.key(rungs) if self._splan else None))

    def _placement(self):
        if self._mesh is not None:
            return ('mesh',) + pmesh.mesh_fingerprint(self._mesh)
        return ('dev', str(self._device))

    def _program(self, fkey, bulk, k, shapes, rungs):
        local = ('bulk' if bulk else 'step', k, shapes,
                 self._full_step_key(fkey, rungs))
        prog = self._programs.get(local)
        if prog is None:
            key = exec_cache.gluon_step_key(
                self._fingerprint(shapes), self._full_step_key(fkey, rungs),
                'bulk' if bulk else 'step', k, self._placement())
            prog = exec_cache.get(key, count=True)
            if prog is None:
                prog = exec_cache.put(key, exec_cache.TimedJit(_run_program))
            self._programs[local] = prog
        return prog

    def _run(self, args, bulk, batch_size):
        if self._loss is not None and len(args) < 2:
            raise ValueError('fused step needs (inputs..., label); got %d '
                             'argument(s)' % len(args))
        full_arrays = [self._tensor(a) for a in args]
        k = int(full_arrays[0].shape[0]) if bulk else 1
        if bulk and k == 0:
            raise ValueError('bulk: stacked inputs have K=0 steps')
        bdim = 1 if bulk else 0
        if batch_size is None:
            batch_size = int(full_arrays[0].shape[bdim])
        self._collect_params()
        self._finish_deferred(full_arrays, bulk)
        if self._splan is None:
            self._make_sparse_plan()
        if self._checkpoint is not None and not self._ckpt_resume_tried:
            self._ckpt_resume_tried = True
            if not self._placed:
                self._place()
            self._checkpoint.attach(self)
            from .. import dist
            rt = dist.runtime()
            if rt is not None:
                rt.watch(self._checkpoint)
            if self._checkpoint.last_resume is None:
                self._checkpoint.restore(metric=self._metric)
        fu = self._ensure_updater(batch_size)
        self._updater = fu
        tr = self._trainer
        if tr._last_update_mode == 'unfused' and tr._updaters and \
                tr._updaters[0].states:
            fu.set_states(tr._updaters[0].get_states())
        if not self._placed:
            self._place()
        if self._ema_decay is not None and self._ema_state is None:
            self._ema_state = [self._gather_param(p).clone()
                               for p in self._params]
        dev = self._device
        if dev is not None:
            full_arrays = [a.to(dev, non_blocking=True) for a in full_arrays]
        arrays = full_arrays
        if self._mesh is not None:
            arrays = []
            for a in full_arrays:
                n = a.shape[bdim]
                if n % self._dp:
                    raise MXNetError('batch size %d not divisible by %d '
                                     'data ranks' % (n, self._dp))
                lo = self._rank * (n // self._dp)
                arrays.append(a.narrow(bdim, lo, n // self._dp))
        shapes = tuple((tuple(a.shape), str(a.dtype)) for a in full_arrays)
        rungs = self._dispatch_rungs(full_arrays, shapes, bulk) \
            if self._splan else None
        fkey = fu.cache_key()
        prog = self._program(fkey, bulk, k, shapes, rungs)
        t0 = time.perf_counter()
        synced = profiler.is_running()
        # the MoE counters before the dispatch (read when the profiler
        # runs, as in the JAX package)
        moe_idx = [p for p in self._aux_params
                   if getattr(p, '_moe_counter', None)]
        moe_pre = [self._gather_param(p).clone() for p in moe_idx] \
            if moe_idx and synced else None
        with profiler.scope('gluon_fused_%s' % ('bulk' if bulk else 'step'),
                            'gluon_fused'):
            losses = prog(self, bulk, k, arrays, full_arrays, rungs)
            if synced:
                profiler.synchronize([t for l in losses for t in l])
        if moe_pre is not None:
            self._note_moe_counters(moe_idx, moe_pre)
        if self._splan is not None:
            exec_cache.put(self._splan.facts_key(),
                           (dict(self._splan.src), dict(self._splan.srcs),
                            dict(self._splan.slots)))
            self._note_embed_counters(k, rungs)
        tr._last_update_mode = 'fused'
        profiler.add_gluon_fused_stats(steps=k, dispatches=1)
        if self._metric_fold is not None:
            profiler.add_reduce_stats(metric_steps=k)
        rs, ag = fu.comm_bytes_per_step()
        if rs or ag:
            profiler.add_comm_bytes(reduce_scattered=rs * k,
                                    all_gathered=ag * k)
        profiler.set_optimizer_state_bytes(fu.state_bytes_per_device())
        if self._checkpoint is not None:
            self._checkpoint.step_end(steps=k, batch_size=batch_size,
                                      metric=self._metric, target=self)
        self._bound_ahead(losses, synced, t0)
        return self._losses_out(losses, bulk)

    def _bound_ahead(self, losses, synced, t0):
        """Let at most step_ahead calls run on the device behind the
        host: wait for the oldest call's event beyond that depth."""
        if not synced:
            ev = None
            if self._device is not None and self._device.type == 'cuda':
                ev = torch.cuda.Event()
                ev.record()
            self._inflight.append(ev)
            while len(self._inflight) > self._step_ahead:
                tw = time.perf_counter()
                ev = self._inflight.popleft()
                if ev is not None:
                    ev.synchronize()
                profiler.add_overlap_stats(
                    dispatch_wait_ms=(time.perf_counter() - tw) * 1e3)
        profiler.add_overlap_stats(train_steps=len(losses),
                                   steps_ahead=len(self._inflight))

    def _losses_out(self, losses, bulk):
        """The losses as NDArrays in the loss's structure, the global
        batch's under a mesh; bulk stacks the steps."""
        def glob(t):
            if self._mesh is None:
                return t
            return collectives._all_gather(t.contiguous(), self._mesh,
                                           'data', 0)
        per_leaf = list(zip(*losses))
        if bulk:
            vals = [torch.stack([glob(t) for t in leaf])
                    for leaf in per_leaf]
        else:
            vals = [glob(leaf[0]) for leaf in per_leaf]
        out = [nd.NDArray(v, self._ctx) for v in vals]
        return block_mod._unflatten(self._loss_structure, out)

    def _note_embed_counters(self, k, rungs):
        mom = bool(float(getattr(self._trainer._optimizer, 'momentum',
                                 0.0) or 0.0))
        plan = self._splan
        profiler.add_embed_stats(
            steps=k, dispatches=1, lookups=k * len(plan.entries),
            unique_rows=k * sum(rungs),
            touched_bytes=k * plan.touched_bytes(rungs, mom),
            dense_equiv_bytes=k * plan.dense_equiv_bytes(mom),
            max_rung=max(rungs))

    def _note_moe_counters(self, params, pre):
        """profiler.add_moe_stats from the dispatch's deltas of the MoE
        blocks' cumulative counts (per-expert tables summed over blocks
        by expert index)."""
        totals = {'routed': 0.0, 'dropped': 0.0}
        for p, before in zip(params, pre):
            delta = (self._gather_param(p) - before).cpu().numpy()
            totals[p._moe_counter] += float(delta.sum())
            profiler.add_moe_stats(**{'per_expert_%s' % p._moe_counter:
                                      delta})
        profiler.add_moe_stats(routed=totals['routed'],
                               dropped=totals['dropped'], dispatches=1)

    def ema(self):
        """The weight EMA as {parameter name: NDArray}; before the first
        step it equals the weights."""
        if self._ema_decay is None:
            raise ValueError('fuse_step was built without ema_decay')
        self._collect_params()
        vals = self._ema_state if self._ema_state is not None else \
            [self._gather_param(p) for p in self._params]
        return {p.name: nd.NDArray(v.clone(), self._ctx)
                for p, v in zip(self._params, vals)}


# -- the dp x pipe pipelined mode ----------------------------------------------

def _child_struct_sig(block):
    """The structure of one child for the stage partition: its class and
    its parameters' (relative name, shape, dtype, grad_req). Equal
    signatures are stacking-compatible; whether they compute the same is
    the homogeneity check's to say."""
    plist = sorted(block._collect_params_with_prefix().items())
    psig = tuple((name, tuple(p.shape) if p.shape else None,
                  str(np.dtype(p.dtype)) if p.dtype else None, p.grad_req)
                 for name, p in plist)
    return (type(block).__name__, psig)


def _partition_pipeline_children(net, num_stages):
    """(stem children, [stage children...], head children) of a
    Sequential-style net: the longest run of consecutive structurally
    identical children is the stage body (its length must divide by
    num_stages), what comes before it the stem (run by stage 0), what
    comes after it the head (run with the loss by the last stage)."""
    children = list(getattr(net, '_children', ()))
    if len(children) < num_stages:
        raise ValueError(
            'fuse_step(pipeline=(%d, ...)): net has %d children; the '
            'pipelined mode partitions a Sequential of repeated blocks - '
            'need at least one block per stage'
            % (num_stages, len(children)))
    sigs = [_child_struct_sig(c) for c in children]
    best_start, best_len = 0, 1
    start = 0
    for i in range(1, len(sigs) + 1):
        if i == len(sigs) or sigs[i] != sigs[start]:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = i
    if best_len % num_stages:
        raise ValueError(
            'fuse_step(pipeline): the longest run of identical children '
            'has length %d, not divisible into %d stages - stack a '
            'multiple of %d identical blocks'
            % (best_len, num_stages, num_stages))
    per = best_len // num_stages
    stages = [children[best_start + s * per:best_start + (s + 1) * per]
              for s in range(num_stages)]
    return (children[:best_start], stages,
            children[best_start + best_len:])


def _ordered_child_params(children):
    """The parameters of a run of children in structural order (each
    child's relative names: aligned across identical stages whatever
    their prefixes)."""
    out = []
    for c in children:
        out.extend(p for _, p in
                   sorted(c._collect_params_with_prefix().items()))
    return out


class PipelinedStep(FusedStep):
    """GPipe dp x pipe training, one whole step a call (the pipeline=(S,
    M) mode of fuse_step).

    The net's children partition into a stem, S architecturally
    identical stages and a head (_partition_pipeline_children). A trainer
    over N contexts is N ranks of the {'data': N / S, 'pipe': S} mesh
    (parallel/pipeline.make_pipe_mesh), each its own process running the
    same script with the global batch; in one process several contexts
    raise, naming the launchers. Rank (d, s) trains stage s's parameters
    only and the stem and head whole, and every step runs
    parallel/pipeline.make_pipe_step_fn: the fill-drain schedule of M
    microbatches of this rank's rows, stem and head gradients summed
    over 'pipe', the data-axis sum (or ZeRO-1's reduce-scatter and
    all-gather, which also shard the momenta: a rank's optimizer state
    is about 1/(dp S) of one device's) and the SGD / NAG update. `bulk`
    runs K steps a call.

    After a step a rank's parameters of the other stages are stale: call
    `sync_params()` (a collective over 'pipe') before reading them or
    running the net eagerly; the next step re-places what user code
    changed. The dispatch (parallel/pipeline.PipeDispatch) builds one
    step function per input signature and hyperparameters, after holding
    every stage's op trace against stage 0's."""

    def __init__(self, net, loss, trainer, pipeline, zero=None):
        from ..parallel import pipeline as pipe_mod
        self._pipe_mod = pipe_mod
        self._pipe_s, self._pipe_m = pipe_mod.pipe_spec(pipeline)
        S = self._pipe_s
        if loss is None:
            raise ValueError(
                'fuse_step(pipeline): loss=None nets are not supported - '
                'the pipelined head needs an explicit loss on the last '
                'stage')
        ctxs = list(trainer._contexts)
        if len(ctxs) < S or len(ctxs) % S:
            raise ValueError(
                'fuse_step(pipeline=(%d, %d)): %d trainer contexts do not '
                'divide into %d pipeline stages'
                % (S, self._pipe_m, len(ctxs), S))
        from ..module.executor_group import pipe_mesh_for
        mesh = pipe_mesh_for(ctxs, S, 'a pipelined fused Gluon step')
        super().__init__(net, loss, trainer, mesh=mesh, zero=zero)
        if bool(getattr(trainer._optimizer, 'multi_precision', False)):
            raise ValueError('fuse_step(pipeline): multi_precision is not '
                             'composed with the pipelined update yet')
        if any(getattr(p, 'sparse_grad', False) for p in trainer._params):
            raise MXNetError(
                'fuse_step(pipeline): sparse_grad embedding tables are not '
                'composed with the pipelined schedule yet')
        self._mesh = mesh
        self._dp = mesh.shape['data']
        self._stage = mesh.axis_index('pipe')
        self._device = mesh.device
        self._ctx = Context.from_device(mesh.device)
        self._partitioned = False
        self._dispatch = pipe_mod.PipeDispatch(
            mesh, S, self._pipe_m, self._zero, 'fuse_step', ValueError)
        self._structure_shared = False

    # -- partition ---------------------------------------------------------
    def _partition(self):
        if self._partitioned:
            return
        stem, stages, head = _partition_pipeline_children(
            self._net, self._pipe_s)
        plists = [_ordered_child_params(cs) for cs in stages]
        n_leaf = len(plists[0])
        for s, pl in enumerate(plists):
            if len(pl) != n_leaf:
                raise ValueError('pipeline stage %d has %d parameters, '
                                 'stage 0 has %d' % (s, len(pl), n_leaf))
        groups = []
        for j in range(n_leaf):
            group = [plists[s][j] for s in range(self._pipe_s)]
            shapes = {tuple(p.shape) for p in group}
            dts = {str(np.dtype(p.dtype)) for p in group}
            if len(shapes) != 1 or len(dts) != 1:
                raise ValueError(
                    'pipeline stages are not stacking-compatible: leaf %d '
                    'has shapes %s dtypes %s'
                    % (j, sorted(shapes), sorted(dts)))
            groups.append(group)
        stem_params = _ordered_child_params(stem)
        head_params = _ordered_child_params(head)
        allp = [p for g in groups for p in g] + stem_params + head_params
        if any(p.grad_req == 'null' for p in allp):
            raise ValueError(
                'fuse_step(pipeline): grad_req=null (aux) parameters '
                '(BatchNorm running stats, MoE counters) are not composed '
                'with the pipelined schedule yet')
        if hasattr(self._loss, 'collect_params') and \
                list(self._loss.collect_params().items()):
            raise ValueError('fuse_step(pipeline): losses with their own '
                             'parameters are not supported')
        trainable = {id(p) for p in self._trainer._params}
        missing = [p.name for p in allp if id(p) not in trainable]
        if missing or len(self._trainer._params) != len(allp):
            raise ValueError(
                "fuse_step(pipeline): the trainer must own exactly the "
                "net's parameters (missing from trainer: %s; trainer has "
                "%d params, net has %d)"
                % (missing, len(self._trainer._params), len(allp)))
        tr_idx = {id(p): i for i, p in enumerate(self._trainer._params)}
        self._stem_children, self._stage_children, self._head_children = \
            stem, stages, head
        self._stage_groups = groups
        self._stem_params2 = stem_params
        self._head_params2 = head_params
        self._group_tr_idx = ([[tr_idx[id(p)] for p in g] for g in groups] +
                              [[tr_idx[id(p)]] for p in stem_params] +
                              [[tr_idx[id(p)]] for p in head_params])
        self._partitioned = True

    # -- placement -----------------------------------------------------------
    def _own_stage_params(self):
        return [g[self._stage] for g in self._stage_groups]

    def _gather_pipe(self, p, over):
        """The tensor the step trains for `p`: kept from the last step, or
        (first step, or user code replaced it) broadcast from index 0 of
        the axes `over`."""
        cur = p.list_data()[0]._data
        kept = self._repl.get(id(p))
        if kept is not None and cur is kept:
            return kept
        t = cur.detach().to(self._mesh.device).clone()
        for axis in over:
            if self._mesh.shape[axis] > 1:
                t = collectives._broadcast(t, self._mesh, axis)
        self._bind(p, t)
        return t

    def _stage_leaves(self):
        return [self._gather_pipe(p, ('data',))[None]
                for p in self._own_stage_params()]

    def _edge_leaves(self, params):
        return [self._gather_pipe(p, ('data', 'pipe')) for p in params]

    def sync_params(self):
        """Every stage's trained weights on every rank (one all-gather over
        'pipe' a stage leaf; every rank calls it), for eager evaluation,
        predict or save outside the step. The stem and head are current
        on every rank already."""
        self._collect_params()
        if not self._partitioned:
            return
        for group in self._stage_groups:
            mine = self._gather_pipe(group[self._stage], ('data',))
            rows = collectives._all_gather(mine[None].contiguous(),
                                           self._mesh, 'pipe', 0)
            for s, p in enumerate(group):
                if s == self._stage:
                    continue
                self._bind(p, rows[s].clone())

    def ema(self):
        raise ValueError('fuse_step(pipeline) has no EMA arm')

    # -- the stage, stem and head bodies --------------------------------------
    def _seq_forward(self, children, params, values, x, record=True):
        """A run of children applied to x with their parameters bound to
        `values` (tensors)."""
        ctx = self._ctx
        sub = {p: nd.NDArray(v, ctx) for p, v in zip(params, values)}
        scope = autograd._nested_recording(list(values) + [x]) if record \
            else contextlib.nullcontext()
        with scope, block_mod.param_trace(sub, train_mode=True):
            out = nd.NDArray(x, ctx)
            for c in children:
                out = c(out)
        return out._data

    def _make_fns(self):
        stage0 = self._stage_children[self._stage]
        stage_params = self._own_stage_params()
        stem, stem_params = self._stem_children, self._stem_params2
        head, head_params = self._head_children, self._head_params2
        seq = self._seq_forward
        outer = self

        def stem_fn(ws, mb, rng):
            if not stem:
                return mb
            return seq(stem, stem_params, ws, mb)

        def stage_fn(ws, act, rng):
            return seq(stage0, stage_params, ws, act)

        def head_fn(ws, acts, label, rng):
            ctx = outer._ctx
            sub = {p: nd.NDArray(v, ctx) for p, v in zip(head_params, ws)}
            with autograd._nested_recording(list(ws) + [acts, label]), \
                    block_mod.param_trace(sub, train_mode=True):
                out = nd.NDArray(acts, ctx)
                for c in head:
                    out = c(out)
                l = outer._loss(out, nd.NDArray(label, ctx))
            leaves, outer._loss_structure = block_mod._flatten(l)
            leaves = [x._data for x in leaves]
            total = None
            for x in leaves:
                s = x.sum().float()
                total = s if total is None else total + s
            return leaves, total

        return stem_fn, stage_fn, head_fn

    def _fingerprint_stages(self, mb, stem_fn):
        """The op trace of every stage on stem(mb) (check_stage_
        homogeneity: each must equal stage 0's), and the fingerprint of
        the step's computation: that trace with the stem, head and loss
        structure and the input shapes."""
        with torch.no_grad():
            act = stem_fn(self._edge_leaves(self._stem_params2), mb, 0)

        def trace(children):
            params = _ordered_child_params(children)
            ws = [torch.zeros_like(p.list_data()[0]._data,
                                   device=act.device) for p in params]

            def fn(w, x, rng, _c=children, _p=params):
                return self._seq_forward(_c, _p, w, x, record=False)

            return (fn, ws, act, 0)

        fp = self._pipe_mod.check_stage_homogeneity(
            [trace(c) for c in self._stage_children],
            lambda s: ValueError(
                'fuse_step(pipeline): stage %d traces a different '
                'computation than stage 0 - pipeline stages must be '
                'architecturally identical (same layer types, activations '
                'and shapes)' % s))
        sig = repr((fp, [_block_signature(c) for c in self._stem_children],
                    [_block_signature(c) for c in self._head_children],
                    _block_signature(self._loss)
                    if isinstance(self._loss, block_mod.Block)
                    else type(self._loss).__name__))
        return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()

    # -- schedules -----------------------------------------------------------
    def _pipe_hyper(self, batch_size):
        tr = self._trainer
        opt = tr._optimizer
        rescale = float(tr._scale / batch_size)
        opt.rescale_grad = rescale
        clip = opt.clip_gradient
        return {'momentum': float(getattr(opt, 'momentum', 0.0) or 0.0),
                'rescale': rescale,
                'clip': None if clip is None else float(clip),
                'nesterov': isinstance(opt, opt_mod.NAG)}

    def _pipe_schedules(self, k):
        return self._pipe_mod.grouped_schedule_rows(
            self._trainer._optimizer, len(self._trainer._params),
            self._group_tr_idx, k,
            lambda lrs, wds: ValueError(
                'fuse_step(pipeline): stage parameters of one stacked group '
                'have diverging lr/wd (%s / %s) - per-stage lr_mult does '
                'not compose with stacked stages' % (lrs, wds)))

    def _pipe_state_accounting(self):
        """(param_bytes, opt_state_bytes) resident on this rank
        (parallel/pipeline.pipe_residency)."""
        self._partition()
        leaves = self._own_stage_params() + self._stem_params2 + \
            self._head_params2
        return self._pipe_mod.pipe_residency(
            [tuple(p.shape) for p in leaves],
            [p.list_data()[0]._data.dtype for p in leaves],
            self._dispatch.layout)

    # -- the step ------------------------------------------------------------
    def _run(self, args, bulk, batch_size):
        if len(args) != 2:
            raise ValueError('pipelined fused step takes exactly (data, '
                             'label); got %d argument(s)' % len(args))
        arrays = [self._tensor(a) for a in args]
        k = int(arrays[0].shape[0]) if bulk else 1
        if bulk and k == 0:
            raise ValueError('bulk: stacked inputs have K=0 steps')
        B = int(arrays[0].shape[1 if bulk else 0])
        if batch_size is None:
            batch_size = B
        self._dispatch.check_batch(B)
        self._collect_params()
        self._finish_deferred(arrays, bulk)
        self._partition()
        arrays = [a.to(self._device) for a in arrays]
        ws = (self._stage_leaves(), self._edge_leaves(self._stem_params2),
              self._edge_leaves(self._head_params2))
        t0 = time.perf_counter()
        synced = profiler.is_running()
        loss_out, new_stage, new_stem, new_head = self._dispatch.run(
            ws, arrays[0], arrays[1], bulk, self._pipe_hyper(batch_size),
            self._pipe_schedules, self._make_fns, self._fingerprint_stages,
            ('gluon_pipe_%s' % ('bulk' if bulk else 'step'), 'gluon_fused'))
        for p, w in zip(self._own_stage_params(), new_stage):
            self._bind(p, w[0])
        for p, w in zip(self._stem_params2 + self._head_params2,
                        new_stem + new_head):
            self._bind(p, w)
        self._share_structure()
        self._trainer._last_update_mode = 'fused'
        profiler.add_gluon_fused_stats(steps=k, dispatches=1)
        self._bound_ahead([loss_out] * k, synced, t0)
        out = [nd.NDArray(v, self._ctx) for v in loss_out]
        return block_mod._unflatten(self._loss_structure, out)

    def _share_structure(self):
        """The loss's structure (the last stage runs the loss) on every
        rank, once."""
        if self._structure_shared:
            return
        import torch.distributed as dist
        S = self._pipe_s
        obj = [self._loss_structure if self._stage == S - 1 else None]
        dist.broadcast_object_list(obj, src=self._mesh.axis_ranks('pipe')[
            S - 1], group=self._mesh.group('pipe'))
        self._loss_structure = obj[0]
        self._structure_shared = True
