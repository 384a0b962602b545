"""BucketingModule: one Module per bucket key, sharing one parameter
set; the counterpart of mxnet_tpu/module/bucketing_module.py (reference
python/mxnet/module/bucketing_module.py, switch_bucket :336).

Each bucket key binds its own Module (its executor bound at that key's
shapes) with the default bucket's module as `shared_module`, so there is
one master copy of the weights, and every bucket borrows the default
bucket's optimizer: one FusedSGD state for all of them. In train mode a
bucket's conv -> BatchNorm pairs take the executor's pair route, as any
Module's do.

  * bucket_ladder= : a batch whose bucket_key is not a rung is padded up
    to the smallest rung that covers it (exec_cache.ladder_rung), its
    data with pad_value and its labels with mask_label. That is exact
    for losses and metrics that mask mask_label (SoftmaxOutput with
    use_ignore, Perplexity or Accuracy with ignore_label); the padding
    is counted in the profiler's train_pad_waste_rows. Padded rows do
    reach ops that mix the batch, such as BatchNorm's batch statistics.
  * warmup_buckets= / MXNET_TPU_WARMUP_BUCKETS=1 : at init_optimizer
    (and with the bulk programs, at fit(bulk=K)) every rung's Module is
    bound and its fused train programs are built and run once on copies
    of its state (Module.warmup_fused). The programs key into exec_cache,
    whose counters count their builds: none is built by the steps after
    the warm-up, and an equivalent module built later finds them all.
  * fit(bulk=K) : consecutive batches of one rung group into K-step
    dispatches (bulk_step).
"""
import logging
import os

import numpy as np
import torch

from .. import exec_cache
from .. import ndarray as nd
from .. import profiler
from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch, DataDesc
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, bucket_ladder=None, mask_label=None,
                 pad_value=0, warmup_buckets=None):
        """bucket_ladder: optional rung keys (the default_bucket_key
        always joins); batches with other keys pad up to the smallest
        covering rung — requires mask_label.  mask_label: label value
        padded positions carry (must be the loss's ignore_label / the
        metric's ignore_label for exact masked semantics).  pad_value:
        fill for padded DATA positions (masked-out by the loss, so the
        value only needs to be in-domain — e.g. a valid token id).
        warmup_buckets: True / list of keys → warm the rungs' train
        programs at init_optimizer time (None defers to the
        MXNET_TPU_WARMUP_BUCKETS env knob; see warmup_buckets())."""
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._mask_label = mask_label
        self._pad_value = pad_value
        self._warmup_cfg = warmup_buckets
        self._ladder = None
        self._ladder_set = frozenset()
        if bucket_ladder is not None:
            self._ladder = exec_cache.train_ladder(
                tuple(bucket_ladder) + (default_bucket_key,))
            self._ladder_set = frozenset(self._ladder)
        self._last_pad_labels = None
        self._compile_t0 = None
        self._warmed = set()        # (key, bulk) configs already warmed
        self._in_warmup = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._warmed = set()

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        """Bind the default bucket (reference bucketing_module.py bind)."""
        assert shared_module is None, \
            'shared_module for BucketingModule is not supported'
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning('Already binded, ignoring bind()')
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        symbol, data_names, label_names = self._call_sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names,
                        logger=self.logger, context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch to (or create) the bucket's module
        (reference bucketing_module.py:336)."""
        assert self.binded, 'call bind before switching bucket'
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            module.bind(data_shapes, label_shapes, self._curr_module.
                        for_training, self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key])
            if self.optimizer_initialized:
                module.borrow_optimizer(
                    self._buckets[self._default_bucket_key])
            if self._monitor is not None:
                # buckets created AFTER install_monitor get the monitor
                # too (the install loop alone missed them)
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        if bucket_key != self._curr_bucket_key and not self._in_warmup:
            # warmup's rung sweep is not a training-time switch; only
            # real batch routing counts toward train_bucket_switches
            profiler.add_bucket_stats(switches=1)
        self._curr_bucket_key = bucket_key
        self._curr_module = self._buckets[bucket_key]

    # -- bucket ladder: rung mapping + pad-to-rung ------------------------
    def _rung_for(self, bucket_key):
        """The ladder rung `bucket_key` executes on — the key itself
        when no ladder is configured or the key is a rung."""
        if self._ladder is None or bucket_key in self._ladder_set:
            return bucket_key
        rung = exec_cache.ladder_rung(self._ladder, bucket_key)
        if rung is None:
            raise MXNetError(
                'bucket key %r exceeds every ladder rung %s'
                % (bucket_key, list(self._ladder)))
        if self._mask_label is None:
            raise MXNetError(
                'bucket key %r is not a ladder rung and no mask_label '
                'is configured: cannot pad with exact loss semantics '
                '(pass mask_label= and build the loss with '
                'use_ignore/ignore_label on it)' % (bucket_key,))
        return rung

    @staticmethod
    def _desc_parts(d):
        if isinstance(d, DataDesc):
            return d.name, tuple(d.shape), d.layout, d.dtype
        return d[0], tuple(d[1]), None, None

    @staticmethod
    def _pad_target(shape, layout, key, rung):
        """`shape` with the bucket-dependent extent(s) substituted
        key→rung: the axis the DataDesc layout marks 'T', else the
        unique axis whose extent equals the key component (no
        matching axis → shape unchanged, e.g. a per-sequence label)."""
        olds = tuple(key) if isinstance(key, (tuple, list)) else (key,)
        news = tuple(rung) if isinstance(rung, (tuple, list)) else (rung,)
        shape = list(shape)
        for old, new in zip(olds, news):
            if old == new:
                continue
            axes = [i for i, d in enumerate(shape) if d == old]
            if not axes:
                continue
            if len(axes) > 1 and layout:
                t = layout.find('T')
                if 0 <= t < len(shape) and shape[t] == old:
                    axes = [t]
            if len(axes) > 1:
                raise MXNetError(
                    'ambiguous bucket axis: extent %r appears %d times '
                    "in shape %s and no 'T' layout disambiguates — pass "
                    'DataDesc layouts' % (old, len(axes), tuple(shape)))
            shape[axes[0]] = new
        return tuple(shape)

    def _pad_arrays(self, arrays, descs, key, rung, fill):
        """Pad each array up to its rung-substituted shape.  Returns
        (arrays, descs, padded_elems, total_elems)."""
        out_arr, out_desc, padded, total = [], [], 0, 0
        for a, d in zip(arrays, descs or [None] * len(arrays)):
            if d is not None:
                name, shape, layout, dtype = self._desc_parts(d)
            else:
                name, shape, layout, dtype = None, tuple(a.shape), None, None
            target = self._pad_target(shape, layout, key, rung)
            total += int(np.prod(shape))
            if target == tuple(shape):
                out_arr.append(a)
                out_desc.append(d)
                continue
            data = a._data if isinstance(a, nd.NDArray) else \
                torch.as_tensor(np.asarray(a))
            pads = []
            for s, t in zip(data.shape, target):
                if t < s:
                    raise MXNetError(
                        'ladder rung %r is narrower than the batch '
                        '(%s vs %s)' % (rung, tuple(data.shape), target))
                pads.append((0, t - s))
            # F.pad takes the last dim's (before, after) first
            flat = [p for pair in reversed(pads) for p in pair]
            out_arr.append(nd.NDArray(
                torch.nn.functional.pad(data, flat,
                                        value=np.asarray(fill).item()),
                a.context if isinstance(a, nd.NDArray) else None))
            padded += int(np.prod(target) - np.prod(shape))
            if isinstance(d, DataDesc):
                out_desc.append(DataDesc(name, target, dtype, layout))
            elif d is not None:
                out_desc.append(DataDesc(name, target))
            else:
                out_desc.append(None)
        return out_arr, out_desc, padded, total

    def _map_batch(self, data_batch):
        """Route a batch onto its ladder rung: identity when the key is
        a rung, else pad data (pad_value) and labels (mask_label) up to
        the rung shape.  Feeds the profiler pad-waste counters and
        remembers the padded labels for update_metric (the caller's
        unpadded labels no longer match the padded outputs)."""
        key = data_batch.bucket_key
        rung = self._rung_for(key)
        if rung == key:
            self._last_pad_labels = None
            labels = data_batch.label or []
            rows = sum(int(np.prod(l.shape)) for l in labels)
            profiler.add_bucket_stats(rows=rows)
            return data_batch
        data, ddesc, dpad, _ = self._pad_arrays(
            data_batch.data, data_batch.provide_data, key, rung,
            self._pad_value)
        label, ldesc = None, None
        lpad = ltot = 0
        if data_batch.label:
            label, ldesc, lpad, ltot = self._pad_arrays(
                data_batch.label, data_batch.provide_label, key, rung,
                self._mask_label)
        # "rows" = label positions (the entries a masked loss/metric
        # sees); data-only batches fall back to data elements
        profiler.add_bucket_stats(
            pad_rows=(lpad if data_batch.label else dpad),
            rows=(ltot if data_batch.label else 0))
        mapped = DataBatch(data=data, label=label, pad=data_batch.pad,
                           index=data_batch.index, bucket_key=rung,
                           provide_data=ddesc, provide_label=ldesc)
        self._last_pad_labels = label
        return mapped

    def _shapes_for(self, key):
        """Bind shapes for bucket `key`: a bound bucket's own, else the
        default bucket's bound shapes with the key substituted (warmup
        has no batch to read shapes from)."""
        if key in self._buckets:
            mod = self._buckets[key]
            return mod.data_shapes, mod.label_shapes or None
        base = self._buckets[self._default_bucket_key]

        def sub(descs):
            out = []
            for d in descs or []:
                name, shape, layout, dtype = self._desc_parts(d)
                tgt = self._pad_target(shape, layout,
                                       self._default_bucket_key, key)
                out.append(DataDesc(name, tgt, dtype, layout)
                           if isinstance(d, DataDesc)
                           else DataDesc(name, tgt))
            return out or None
        return sub(base.data_shapes), sub(base.label_shapes)

    # -- ladder warm-up ----------------------------------------------------
    def _warmup_enabled(self):
        if self._warmup_cfg is None:
            return os.environ.get('MXNET_TPU_WARMUP_BUCKETS',
                                  '0') not in ('0', '')
        return bool(self._warmup_cfg)

    def _warmup_keys(self):
        if isinstance(self._warmup_cfg, (list, tuple)):
            return list(self._warmup_cfg)
        if self._ladder is not None:
            return list(self._ladder)
        return list(self._buckets)

    def warmup_buckets(self, keys=None, bulk=None, eval_metric=None):
        """Bind every rung's Module and build and run once its fused
        train programs (Module.warmup_fused per rung: the one-step
        program, plus the K-step program when bulk=K is given), so that
        the training steps build none. The programs key into the
        process-wide exec_cache, so an equivalent module built later
        finds them all. No parameter, optimizer or schedule state
        changes. keys defaults to the configured ladder (or the
        warmup_buckets= list). Returns the keys whose programs were
        warmed (a setup that cannot fuse warms nothing)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        keys = list(keys) if keys is not None else self._warmup_keys()
        prev_key = self._curr_bucket_key
        warmed = []
        bulk_tag = None
        if bulk and int(bulk) > 1:
            # the bulk program's identity includes the metric fold
            # baked into its scan — a different metric is a different
            # program, so it must not be skipped as already-warmed
            from .. import metric as metric_mod
            fold = metric_mod.device_fold(eval_metric) \
                if eval_metric is not None else None
            bulk_tag = (int(bulk), fold.key if fold is not None else None)
        self._in_warmup = True
        try:
            for key in keys:
                # skip configs this module already warmed (fit() warms
                # once at init_optimizer and again — with the bulk
                # programs — via the _warmup_for_fit hook; only the
                # not-yet-warmed part runs each time)
                need_single = (key, None) not in self._warmed
                need_bulk = bulk_tag is not None and \
                    (key, bulk_tag) not in self._warmed
                if not need_single and not need_bulk:
                    warmed.append(key)
                    continue
                data_shapes, label_shapes = self._shapes_for(key)
                t0 = exec_cache.stats()['total_compile_s']
                self.switch_bucket(key, data_shapes, label_shapes)
                ok = self._curr_module.warmup_fused(
                    bulk=bulk if need_bulk else None,
                    eval_metric=eval_metric, single=need_single)
                dc = exec_cache.stats()['total_compile_s'] - t0
                profiler.note_bucket_warmup(key, compiled=dc > 0.0)
                if ok:
                    warmed.append(key)
                    self._warmed.add((key, None))
                    if need_bulk:
                        self._warmed.add((key, bulk_tag))
        finally:
            self._in_warmup = False
        if prev_key is not None and prev_key != self._curr_bucket_key:
            self._curr_bucket_key = prev_key
            self._curr_module = self._buckets[prev_key]
        return warmed

    def _warmup_for_fit(self, bulk=None, eval_metric=None):
        """fit() hook (base_module.py): warm the ladder — including the
        bulk programs when fit(bulk=K) engages — when warmup is
        configured on (warmup_buckets= / MXNET_TPU_WARMUP_BUCKETS)."""
        if self._warmup_enabled():
            self.warmup_buckets(bulk=bulk, eval_metric=eval_metric)

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False, zero=None):
        """The default bucket's optimizer, borrowed by every other bucket
        (one optimizer state for all); zero= is forwarded to the inner
        Module, which refuses ZeRO (Queue A 6)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, ignoring.')
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init,
                                         zero=zero)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True
        if self._warmup_enabled():
            self.warmup_buckets()

    # -- per-batch ---------------------------------------------------------
    def _note_rung_dispatch(self, steps):
        """Per-rung accounting around one train dispatch: a build time
        billed to exec_cache during it means the rung built a program
        (the counter the warm-up drives to zero)."""
        t0, self._compile_t0 = self._compile_t0, None
        dc = (exec_cache.stats()['total_compile_s'] - t0) \
            if t0 is not None else 0.0
        profiler.note_bucket_dispatch(self._curr_bucket_key, steps=steps,
                                      compiled=dc > 0.0)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        data_batch = self._map_batch(data_batch)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        data_batch = self._map_batch(data_batch)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._compile_t0 = exec_cache.stats()['total_compile_s']
        self._curr_module.forward_backward(data_batch)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()
        self._note_rung_dispatch(steps=1)

    def bulk_step(self, batches=None, batch=None, repeat=None,
                  scan_dtype=None, eval_metric=None):
        """K training steps of one rung as one dispatch (Module.bulk_step
        on the rung's module). All batches must map to one rung (fit's
        epoch loop groups consecutive batches of a rung; see
        _fit_epoch_bulk)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._compile_t0 = exec_cache.stats()['total_compile_s']
        if batches is None:
            assert batch is not None and repeat is not None
            b = self._map_batch(batch)
            self.switch_bucket(b.bucket_key, b.provide_data,
                               b.provide_label)
            self._params_dirty = True
            self._curr_module.bulk_step(batch=b, repeat=repeat,
                                        scan_dtype=scan_dtype,
                                        eval_metric=eval_metric)
            self._note_rung_dispatch(steps=repeat)
            return
        mapped = [self._map_batch(b) for b in batches]
        rungs = {b.bucket_key for b in mapped}
        if len(rungs) != 1:
            raise MXNetError(
                'bulk_step: batches span ladder rungs %s — group '
                'same-rung batches per dispatch' % sorted(rungs))
        self.switch_bucket(mapped[0].bucket_key, mapped[0].provide_data,
                           mapped[0].provide_label)
        self._params_dirty = True
        self._curr_module.bulk_step(batches=mapped, scan_dtype=scan_dtype,
                                    eval_metric=eval_metric)
        self._note_rung_dispatch(steps=len(mapped))

    # fit(bulk=K): BaseModule._fit_epoch_bulk with two hooks, grouping
    # by rung and running a group short of K step by step (only the
    # K-step program is warmed, as in the JAX package).
    def _bulk_group_key(self, data_batch):
        return self._rung_for(data_batch.bucket_key)

    def _bulk_dispatch_group(self, group, bulk, eval_metric):
        if len(group) >= bulk:
            self.bulk_step(batches=group, eval_metric=eval_metric)
        else:
            for b in group:
                self.forward_backward(b)
                self.update()
                self.update_metric(eval_metric, b.label)

    def get_outputs(self, merge_multi_context=True):
        """Outputs of the LAST forward.  Ladder caveat: a batch that
        was padded up to its rung returns RUNG-shaped outputs — the
        padded positions are interleaved per the graph's own reshape
        and are NOT sliced back out (which positions are pad is
        graph-specific).  score()/fit() are exact (ignore-aware
        metrics skip the mask_label positions); callers consuming raw
        predictions (predict / iter_predict) should run exact buckets
        (no ladder) or mask by label positions themselves."""
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        if self._last_pad_labels is not None:
            # outputs carry the rung shape; the caller's unpadded
            # labels no longer match — use the padded ones (masked
            # positions hold mask_label, which ignore-aware metrics
            # skip)
            labels = self._last_pad_labels
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon     # buckets created later get it too
        for mod in self._buckets.values():
            mod.install_monitor(mon)
