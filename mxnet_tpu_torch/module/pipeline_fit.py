"""GPipe dp x pipe training for the symbolic Module, the counterpart of
mxnet_tpu/module/pipeline_fit.py.

`Module.fit(pipeline=(num_stages, num_micro))`, or MXNET_TPU_PIPE =
'stages,micro', lands here: the symbol's op chain partitions into a stem,
`num_stages` architecturally identical stages and a head (the longest
run of identical parameter-anchored segments, the rule the Gluon
PipelinedStep applies to a Sequential's children), and every step runs
parallel/pipeline.make_pipe_step_fn, the engine the Gluon path runs:
the fill-drain schedule, the gradients summed over the data axis (or
ZeRO-1's reduce-scatter with MXNET_TPU_ZERO=1) and the SGD / NAG update,
in one call; fit(bulk=K) runs K steps a call.

A Module over N contexts is N ranks of the {'data': N / S, 'pipe': S}
mesh, one process each running the same script (in one process several
contexts raise, naming the launchers). Rank (d, s) trains stage s's
parameters and the stem and head; `sync_to_module` gathers every stage
over 'pipe' into the module's parameters at each epoch's end, so
callbacks, validation and get_params see them.

The stages evaluate through the op registry's own `apply` (the compute
the executor runs) as a function of (parameter values, activation): a
chain evaluator, not the Executor (no layout pass, context groups or
monitor). The gradient is the executor's: a loss op's backward ignores
its head gradient, so differentiating the sum of the outputs gives it.

Restrictions, each raising MXNetError: a chain (every op one graph
input), one output, exactly one data and one label, no auxiliary state
(BatchNorm), no ops that need their output shapes, no fixed or state
parameters, plain SGD or NAG without multi_precision, and no dist
kvstore (the step reduces over its own mesh only).
"""
import hashlib
import time

import numpy as np
import torch

from .. import ndarray as nd
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..ops.registry import OpContext
from ..parallel import collectives
from ..parallel import pipeline as pipe_mod
from ..parallel import zero as zero_mod


# -- the symbol's chain ---------------------------------------------------------

def _spine_nodes(symbol, data_set, label_set, param_set):
    """The symbol's op chain, input first. Each op has exactly one graph
    input (an op node or the data variable); every other input must be a
    parameter or a label."""
    if len(symbol._outputs) != 1:
        raise MXNetError('fit(pipeline): the symbol must have exactly one '
                         'output, got %d' % len(symbol._outputs))
    node = symbol._outputs[0][0]
    spine = []
    while True:
        if node.op.num_aux:
            raise MXNetError(
                'fit(pipeline): op %r (%s) carries auxiliary state - '
                'BatchNorm & co are not composed with the pipelined '
                'schedule yet' % (node.name, node.op.name))
        if node.op.needs_out_shapes:
            raise MXNetError(
                'fit(pipeline): op %r (%s) needs inferred output shapes at '
                'execution time; not supported in the pipelined evaluator'
                % (node.name, node.op.name))
        spine.append(node)
        preds = []
        for src, soi in node.inputs:
            if src.op is not None or src.name in data_set:
                preds.append((src, soi))
            elif src.name not in param_set and src.name not in label_set:
                raise MXNetError(
                    'fit(pipeline): input %r of node %r is neither data, '
                    'label nor parameter (state inputs are not supported)'
                    % (src.name, node.name))
        if len(preds) != 1:
            raise MXNetError(
                'fit(pipeline): node %r has %d graph inputs - the '
                'pipelined mode partitions a single-chain symbol'
                % (node.name, len(preds)))
        src, _ = preds[0]
        if src.op is None:
            break
        node = src
    spine.reverse()
    return spine


def _segments(spine, param_set):
    """The spine in parameter-anchored segments: one starts at each op
    that takes a parameter; parameter-free ops (activations, reshapes)
    join the segment before them."""
    segs = []
    for node in spine:
        has_param = any(src.op is None and src.name in param_set
                        for src, _ in node.inputs)
        if has_param or not segs:
            segs.append([node])
        else:
            segs[-1].append(node)
    return segs


def _canon_attrs(node):
    return tuple(sorted((k, str(v)) for k, v in node.attrs.items()))


def _seg_sig(seg, param_shapes, param_set, label_set):
    """The structure of one segment: op names, hyperparameters and each
    input's kind (spine, parameter shape and dtype, label). Necessary,
    not sufficient: the op trace of each stage decides."""
    sig = []
    for node in seg:
        ins = []
        for src, _ in node.inputs:
            if src.op is None and src.name in param_set:
                ins.append(('param',) + param_shapes[src.name])
            elif src.op is None and src.name in label_set:
                ins.append('label')
            else:
                ins.append('spine')
        sig.append((node.op.name, _canon_attrs(node), tuple(ins)))
    return tuple(sig)


def _partition_spine(symbol, num_stages, data_names, label_names,
                     param_names, param_shapes):
    """(stem nodes, [stage nodes...], head nodes) by the longest run of
    identical segments (its length must divide by num_stages)."""
    data_set, label_set = set(data_names), set(label_names)
    param_set = set(param_names)
    spine = _spine_nodes(symbol, data_set, label_set, param_set)
    segs = _segments(spine, param_set)
    sigs = [_seg_sig(s, param_shapes, param_set, label_set) for s in segs]
    best_start, best_len = 0, 1
    start = 0
    for i in range(1, len(sigs) + 1):
        if i == len(sigs) or sigs[i] != sigs[start]:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = i
    if best_len % num_stages:
        raise MXNetError(
            'fit(pipeline): the longest run of identical layer segments has '
            'length %d, not divisible into %d stages - stack a multiple of '
            '%d identical layers' % (best_len, num_stages, num_stages))
    per = best_len // num_stages

    def flat(ss):
        return [n for seg in ss for n in seg]

    stages = [flat(segs[best_start + s * per:best_start + (s + 1) * per])
              for s in range(num_stages)]
    return (flat(segs[:best_start]), stages,
            flat(segs[best_start + best_len:]))


def _run_params(nodes, param_set):
    """The parameters a run of nodes takes, in the order it takes them."""
    names = []
    for node in nodes:
        for src, _ in node.inputs:
            if src.op is None and src.name in param_set and \
                    src.name not in names:
                names.append(src.name)
    return names


def _eval_nodes(nodes, pnames, pvals, x, rng, device, label=None,
                label_set=(), out_idx=0):
    """A run of the chain as a function: parameters by name, the
    incoming activation `x` for the graph input from outside the run
    (the previous stage's output or the data), labels by name. Each op
    runs through the registry's apply."""
    inside = {id(n) for n in nodes}
    byp = dict(zip(pnames, pvals))
    env = {}
    for i, node in enumerate(nodes):
        args = []
        for src, soi in node.inputs:
            if src.op is not None and id(src) in inside:
                args.append(env[(id(src), soi)])
            elif src.op is not None:
                args.append(x)
            elif src.name in byp:
                args.append(byp[src.name])
            elif src.name in label_set:
                args.append(label)
            else:
                args.append(x)
        gen = None
        if node.op.needs_rng:
            gen = torch.Generator(device=device)
            gen.manual_seed((int(rng) + 1000003 * i) % (1 << 62))
        outs, _ = node.op.apply(node.attrs, args, [], OpContext(
            is_train=True, rng=gen, device=device))
        for j, o in enumerate(outs):
            env[(id(node), j)] = o
    return env[(id(nodes[-1]), out_idx)]


# -- the trainer ------------------------------------------------------------------

class ModulePipeTrainer:
    """The dp x pipe state of one pipelined Module.fit: this rank's stage
    leaves (each with its stage dim of 1), the stem and head leaves, the
    momenta (ZeRO-1 blocks under MXNET_TPU_ZERO=1), the step seed and the
    step functions (parallel/pipeline.PipeDispatch). `sync_to_module()`
    writes the trained weights into the module's parameters."""

    def __init__(self, module, spec, zero=None):
        self._mod = module
        self._pipe_s, self._pipe_m = pipe_mod.pipe_spec(spec)
        S = self._pipe_s
        if module._aux_names:
            raise MXNetError('fit(pipeline): auxiliary states %s are not '
                             'composed with the pipelined schedule yet'
                             % module._aux_names)
        if module._fixed_param_names or module._state_names:
            raise MXNetError('fit(pipeline): fixed_param_names / '
                             'state_names are not supported')
        if len(module._data_names) != 1 or len(module._label_names) != 1:
            raise MXNetError(
                'fit(pipeline): exactly one data and one label input '
                'required, got data=%s label=%s'
                % (module._data_names, module._label_names))
        kv = module._kvstore
        if kv is not None and str(getattr(kv, 'type', '')).startswith(
                'dist'):
            raise MXNetError(
                'fit(pipeline): kvstore %r is not composed with the '
                'pipelined mode - the pipelined step reduces gradients only '
                'over its own mesh data axis, so cross-host sync would be '
                'silently skipped' % kv.type)
        opt = module._optimizer
        if type(opt) not in (opt_mod.SGD, opt_mod.NAG):
            raise MXNetError(
                'fit(pipeline): only plain SGD/NAG compose with the '
                'pipelined fused update, got %s' % type(opt).__name__)
        if getattr(opt, 'multi_precision', False):
            raise MXNetError('fit(pipeline): multi_precision is not '
                             'composed with the pipelined update yet')
        ctxs = list(module._context)
        if len(ctxs) < S or len(ctxs) % S:
            raise MXNetError(
                'fit(pipeline=(%d, %d)): %d contexts do not divide into %d '
                'pipeline stages' % (S, self._pipe_m, len(ctxs), S))
        from .executor_group import pipe_mesh_for
        self._mesh = pipe_mesh_for(ctxs, S, 'a pipelined Module')
        self._dp = self._mesh.shape['data']
        self._stage = self._mesh.axis_index('pipe')
        self._device = self._mesh.device

        arg_params = module._arg_params
        pshapes = {n: (tuple(a.shape), str(a._data.dtype))
                   for n, a in arg_params.items()}
        stem, stages, head = _partition_spine(
            module._symbol, S, module._data_names, module._label_names,
            module._param_names, pshapes)
        pset = set(module._param_names)
        self._stem_nodes, self._stage_nodes, self._head_nodes = \
            stem, stages, head
        self._label_set = set(module._label_names)
        self._out_idx = module._symbol._outputs[0][1]
        self._stage_pnames = [_run_params(ns, pset) for ns in stages]
        n_leaf = len(self._stage_pnames[0])
        for s, pl in enumerate(self._stage_pnames):
            if len(pl) != n_leaf:
                raise MXNetError('pipeline stage %d consumes %d parameters, '
                                 'stage 0 consumes %d' % (s, len(pl), n_leaf))
        self._stem_pnames = _run_params(stem, pset)
        self._head_pnames = _run_params(head, pset)
        covered = ({n for pl in self._stage_pnames for n in pl} |
                   set(self._stem_pnames) | set(self._head_pnames))
        missing = [n for n in module._param_names if n not in covered]
        if missing:
            raise MXNetError('fit(pipeline): parameters %s are not consumed '
                             'by the symbol chain' % missing)
        # leaf order [stage groups..., stem..., head...]: the engine's and
        # the lr / wd rows'
        self._group_names = (
            [[self._stage_pnames[s][j] for s in range(S)]
             for j in range(n_leaf)] +
            [[n] for n in self._stem_pnames] +
            [[n] for n in self._head_pnames])
        pidx = {n: i for i, n in enumerate(module._param_names)}
        self._group_pidx = [[pidx[n] for n in g] for g in self._group_names]

        # this rank's stage row, the stem and head whole: rank (0, s)'s
        # values on every data rank, rank (0, 0)'s stem and head
        def host(n, over):
            t = arg_params[n]._data.detach().to(self._device).clone()
            for axis in over:
                if self._mesh.shape[axis] > 1:
                    t = collectives._broadcast(t, self._mesh, axis)
            return t

        self._stage_ws = [host(n, ('data',))[None]
                          for n in self._stage_pnames[self._stage]]
        self._stem_ws = [host(n, ('data', 'pipe'))
                         for n in self._stem_pnames]
        self._head_ws = [host(n, ('data', 'pipe'))
                         for n in self._head_pnames]
        self._dispatch = pipe_mod.PipeDispatch(
            self._mesh, S, self._pipe_m, zero_mod.zero_stage(zero), 'fit',
            MXNetError)
        self._synced = True

    def state_accounting(self):
        """(param_bytes, opt_state_bytes) resident on this rank
        (parallel/pipeline.pipe_residency)."""
        ws = self._stage_ws + self._stem_ws + self._head_ws
        shapes = [tuple(w.shape[1:]) for w in self._stage_ws] + \
            [tuple(w.shape) for w in self._stem_ws + self._head_ws]
        return pipe_mod.pipe_residency(shapes, [w.dtype for w in ws],
                                       self._dispatch.layout)

    # -- the stage, stem and head bodies ----------------------------------
    def _make_fns(self):
        stem_nodes, stem_pnames = self._stem_nodes, self._stem_pnames
        stage_nodes = self._stage_nodes[self._stage]
        stage_pnames = self._stage_pnames[self._stage]
        head_nodes, head_pnames = self._head_nodes, self._head_pnames
        label_set, out_idx = self._label_set, self._out_idx
        device = self._device

        def stem_fn(ws, mb, rng):
            if not stem_nodes:
                return mb
            return _eval_nodes(stem_nodes, stem_pnames, ws, mb, rng, device)

        def stage_fn(ws, act, rng):
            return _eval_nodes(stage_nodes, stage_pnames, ws, act, rng,
                               device)

        def head_fn(ws, acts, label, rng):
            out = _eval_nodes(head_nodes, head_pnames, ws, acts, rng, device,
                              label=label, label_set=label_set,
                              out_idx=out_idx)
            # the executor's gradient: a loss op's backward ignores its
            # head gradient
            return (out,), out.sum().float()

        return stem_fn, stage_fn, head_fn

    def _fingerprint(self, mb, stem_fn):
        """Every stage's op trace held against stage 0's, and the
        fingerprint of the computation."""
        with torch.no_grad():
            act = stem_fn(self._stem_ws, mb, 0)
        arg = self._mod._arg_params

        def trace(nodes, pnames):
            ws = [torch.zeros_like(arg[n]._data, device=act.device)
                  for n in pnames]

            def fn(w, x, rng, _n=nodes, _p=pnames):
                return _eval_nodes(_n, _p, w, x, rng, self._device)

            return (fn, ws, act, 0)

        fp = pipe_mod.check_stage_homogeneity(
            [trace(n, p) for n, p in zip(self._stage_nodes,
                                         self._stage_pnames)],
            lambda s: MXNetError(
                'fit(pipeline): stage %d traces a different computation '
                'than stage 0 - pipeline stages must be architecturally '
                'identical (same ops, hyperparams and shapes)' % s))
        sig = repr((fp, [(n.op.name, _canon_attrs(n))
                         for n in self._stem_nodes + self._head_nodes]))
        return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()

    def _hyper(self):
        opt = self._mod._optimizer
        clip = opt.clip_gradient
        return {'momentum': float(getattr(opt, 'momentum', 0.0) or 0.0),
                'rescale': float(opt.rescale_grad),
                'clip': None if clip is None else float(clip),
                'nesterov': isinstance(opt, opt_mod.NAG)}

    def _schedules(self, k):
        return pipe_mod.grouped_schedule_rows(
            self._mod._optimizer, len(self._mod._param_names),
            self._group_pidx, k,
            lambda lrs, wds: MXNetError(
                'fit(pipeline): stage parameters of one stacked group have '
                'diverging lr/wd (%s / %s) - per-stage lr_mult does not '
                'compose with stacked stages' % (lrs, wds)))

    # -- a dispatch ---------------------------------------------------------
    @staticmethod
    def _in(v):
        return v._data if isinstance(v, nd.NDArray) else \
            torch.as_tensor(np.asarray(v))

    def dispatch(self, group):
        """One dispatch over a group of DataBatch: one step, or K > 1 in
        one bulk call. Returns the last stage's outputs ((B, ...) or (K,
        B, ...), the global batch's) for the host metric."""
        k = len(group)
        bulk = k > 1
        for b in group:
            if len(b.data) != 1 or not b.label or len(b.label) != 1:
                raise MXNetError('fit(pipeline): each batch must carry '
                                 'exactly one data and one label array')
        if bulk:
            data = torch.stack([self._in(b.data[0]) for b in group])
            label = torch.stack([self._in(b.label[0]) for b in group])
        else:
            data = self._in(group[0].data[0])
            label = self._in(group[0].label[0])
        data, label = data.to(self._device), label.to(self._device)
        (leaves, self._stage_ws, self._stem_ws,
         self._head_ws) = self._dispatch.run(
            (self._stage_ws, self._stem_ws, self._head_ws), data, label,
            bulk, self._hyper(), self._schedules, self._make_fns,
            self._fingerprint,
            ('module_pipe_%s' % ('bulk' if bulk else 'step'), 'fused_step'))
        self._synced = False
        self._mod._params_dirty = True
        return leaves[0]

    def sync_to_module(self):
        """The trained weights into the module's parameters and its
        executor (every stage's rows gathered over 'pipe': a collective)."""
        if self._synced:
            return
        mod = self._mod
        for j, names in enumerate(zip(*self._stage_pnames)):
            rows = collectives._all_gather(
                self._stage_ws[j].contiguous(), self._mesh, 'pipe', 0) \
                if self._pipe_s > 1 else self._stage_ws[j]
            for s, name in enumerate(names):
                mod._arg_params[name]._data = rows[s].detach().to(
                    mod._arg_params[name]._data.device).clone()
        for names, ws in ((self._stem_pnames, self._stem_ws),
                          (self._head_pnames, self._head_ws)):
            for name, w in zip(names, ws):
                mod._arg_params[name]._data = w.detach().to(
                    mod._arg_params[name]._data.device).clone()
        mod._exec_group.set_params(mod._arg_params, mod._aux_params)
        mod._params_dirty = False
        self._synced = True


# -- the fit loop ------------------------------------------------------------------

def fit_pipeline(module, train_data, spec, eval_data, eval_metric,
                 validation_metric, epoch_end_callback, batch_end_callback,
                 eval_end_callback, eval_batch_end_callback, begin_epoch,
                 num_epoch, bulk):
    """The pipelined epoch loop behind Module.fit(pipeline=...): batches
    group into dispatches of K = bulk (1 without), the metric updates on
    the host from each dispatch's outputs, and the weights sync into the
    module at every epoch's end."""
    from .base_module import BatchEndParam, _as_list, _fire
    trainer = ModulePipeTrainer(module, spec)
    k_bulk = int(bulk) if bulk is not None and int(bulk) > 1 else 1
    from ..context import Context
    ctx0 = Context.from_device(trainer._device)
    for epoch in range(begin_epoch, num_epoch):
        tic = time.time()
        eval_metric.reset()
        state = {'nbatch': 0}
        group = []

        def flush():
            if not group:
                return
            outs = trainer.dispatch(group)
            for i, b in enumerate(group):
                pred = outs[i] if len(group) > 1 else outs
                eval_metric.update(b.label, [nd.NDArray(pred, ctx0)])
            state['nbatch'] += len(group)
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=state['nbatch'] - 1,
                                    eval_metric=eval_metric,
                                    locals=locals()))
            del group[:]

        for data_batch in train_data:
            group.append(data_batch)
            if len(group) >= k_bulk:
                flush()
        flush()
        for name, val in eval_metric.get_name_value():
            module.logger.info('Epoch[%d] Train-%s=%f', epoch, name, val)
        module.logger.info('Epoch[%d] Time cost=%.3f', epoch,
                           time.time() - tic)
        trainer.sync_to_module()
        arg_snap, aux_snap = module.get_params()
        if epoch_end_callback is not None:
            for callback in _as_list(epoch_end_callback):
                callback(epoch, module.symbol, arg_snap, aux_snap)
        if eval_data:
            for name, val in module.score(
                    eval_data, validation_metric,
                    score_end_callback=eval_end_callback,
                    batch_end_callback=eval_batch_end_callback, epoch=epoch):
                module.logger.info('Epoch[%d] Validation-%s=%f', epoch,
                                   name, val)
        train_data.reset()
    return trainer
