"""BaseModule, the high-level training interface: the counterpart of
mxnet_tpu/module/base_module.py (reference
python/mxnet/module/base_module.py: fit, score, predict).

`fit`'s epoch and batch loop, its callbacks, metrics and epoch-end
parameter sync are the JAX package's serialized loop, the one it runs
when its step-ahead overlap is 0: each batch runs forward_backward,
update and update_metric, whose read of the outputs waits for the
device. `monitor=` installs a `monitor.Monitor` on the executor and
ticks it around each batch. `bulk=K` runs the epoch in K-step
dispatches (`bulk_step`), the metric folded on the device; a monitor,
or a metric with no device fold (fit warns), keeps the per-batch loop.
`checkpoint=` runs the elastic runtime (auto-resume, the per-step
cadence, preemption; `elastic.CheckpointManager`). `pipeline=(S, M)`
(or MXNET_TPU_PIPE) trains a Module through the GPipe engine
(module/pipeline_fit.py); other module types raise. The overlap is not
ported.
"""
import logging
import threading
import time
from collections import namedtuple

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..initializer import Uniform

BatchEndParam = namedtuple('BatchEndParams',
                           ['epoch', 'nbatch', 'eval_metric', 'locals'])


def _as_list(obj):
    if isinstance(obj, list):
        return obj
    return [obj]


def _fire(callbacks, *cb_args):
    """Call a callback or each of a list of callbacks (None: none)."""
    if callbacks is None:
        return
    for cb in _as_list(callbacks):
        cb(*cb_args)


def _trim_pad(arrays, pad):
    """Drop the trailing `pad` rows that a padded last batch carries."""
    if not pad:
        return list(arrays)
    return [a[:a.shape[0] - pad] for a in arrays]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        for flag in ('binded', 'for_training', 'inputs_need_grad',
                     'params_initialized', 'optimizer_initialized'):
            setattr(self, flag, False)
        self._symbol = None

    # -- the interface Module implements -----------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- shared high-level logic -------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a data iterator: the metric's name-value pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for eval_batch in eval_data:
            if num_batch is not None and seen >= num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=seen,
                                    eval_metric=eval_metric,
                                    locals=locals()))
            seen += 1
        if score_end_callback:
            _fire(score_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=seen,
                                eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        stream = (enumerate(eval_data) if num_batch is None
                  else zip(range(num_batch), eval_data))
        for nbatch, eval_batch in stream:
            self.forward(eval_batch, is_train=False)
            yield (_trim_pad(self.get_outputs(), eval_batch.pad),
                   nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over an iterator, padding dropped, batches joined
        unless merge_batches is False."""
        collected = [[out.copy() for out in outputs]
                     for outputs, _, _ in self.iter_predict(
                         eval_data, num_batch=num_batch, reset=reset)]
        if not collected or not merge_batches:
            return collected
        widths = {len(outs) for outs in collected}
        assert len(widths) == 1, \
            'Cannot merge batches: different number of outputs'
        merged = [nd.concatenate(list(column)) for column in zip(*collected)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None,
            kvstore='local', optimizer='sgd',
            optimizer_params=(('learning_rate', 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, bulk=None, checkpoint=None, pipeline=None):
        """Train: bind, init_params, init_optimizer, then the epoch loop
        with its callbacks and validation.

        checkpoint: an elastic.CheckpointManager. Training resumes from
        the newest intact checkpoint in its directory (parameters,
        optimizer state, RNG, the epoch's partial metric; the iterator
        fast-forwards to the consumed-sample watermark, so the run
        continues as the uninterrupted one would), every step feeds its
        cadence, SIGTERM and SIGINT (armed here when fit runs on the
        main thread) or a peer's death seen by the dist runtime commit
        a final checkpoint at the next step boundary and raise
        elastic.Preempted."""
        assert num_epoch is not None, 'please specify number of epochs'
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        validation_metric = validation_metric or eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        from ..parallel import pipeline as pipe_mod
        pipe_spec = pipe_mod.pipe_spec(pipeline)
        if pipe_spec is not None:
            for bad, name in ((monitor, 'monitor'),
                              (checkpoint, 'checkpoint')):
                if bad is not None:
                    raise ValueError(
                        'fit(pipeline=%r): %s= does not compose with the '
                        'pipelined mode yet' % (pipe_spec, name))
            return self._fit_pipeline(
                train_data, pipe_spec, eval_data, eval_metric,
                validation_metric, epoch_end_callback, batch_end_callback,
                eval_end_callback, eval_batch_end_callback, begin_epoch,
                num_epoch, bulk)
        use_bulk = bulk is not None and int(bulk) > 1 and \
            hasattr(self, 'bulk_step') and monitor is None
        if use_bulk and metric_mod.device_fold(eval_metric) is None:
            self.logger.warning(
                'fit(bulk=%d): metric %s has no device fold; '
                'falling back to per-batch metric updates', int(bulk),
                eval_metric.name)
            use_bulk = False
        # the ladder warm-up hook (BucketingModule): every rung's train
        # programs before the first batch
        warm = getattr(self, '_warmup_for_fit', None)
        if warm is not None:
            warm(bulk=int(bulk) if use_bulk else None,
                 eval_metric=eval_metric if use_bulk else None)
        # elastic resume: restore the newest intact checkpoint and
        # fast-forward the RAW iterator to its watermark, before the
        # staging wrapper hides the position
        resume_info = None
        signals_installed_here = False
        watched_runtime = None
        batch_size = getattr(train_data, 'batch_size', 0)
        if checkpoint is not None:
            from .. import dist, elastic
            checkpoint.attach(self)
            if not checkpoint._old_handlers and \
                    threading.current_thread() is \
                    threading.main_thread():
                checkpoint.install_signal_handlers()
                signals_installed_here = True
            # a peer's death seen by the heartbeats preempts the
            # manager: the next step boundary commits and raises
            watched_runtime = dist.runtime()
            if watched_runtime is not None:
                watched_runtime.watch(checkpoint)
            resume_info = checkpoint.restore()
            if resume_info is not None:
                begin_epoch = max(begin_epoch, resume_info.epoch)
                elastic.fast_forward(
                    train_data, epochs=resume_info.epoch,
                    batches=resume_info.batches_in_epoch,
                    batch_size=batch_size)

        def ckpt_step(nbatch_done, steps, epoch):
            """nbatch_done: the batches consumed this epoch, the resumed
            epoch's offset included (the manifest's watermark)."""
            if checkpoint is not None:
                checkpoint.step_end(epoch=epoch,
                                    batches_in_epoch=nbatch_done,
                                    batch_size=batch_size, steps=steps,
                                    metric=eval_metric)

        # stage upcoming batches on the device so that the copy of batch
        # N+1 overlaps step N (Module's hook; the default is identity)
        staged = self._wrap_train_iter(train_data)
        try:
            self._fit_epochs(staged, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch,
                             num_epoch, monitor,
                             int(bulk) if use_bulk else None,
                             resume_info=resume_info,
                             checkpoint=checkpoint, ckpt_step=ckpt_step)
        finally:
            if staged is not train_data:
                staged.close()      # the staging thread fit started
            if signals_installed_here:
                # fit armed the handlers, fit disarms them
                checkpoint.uninstall_signal_handlers()
            if watched_runtime is not None:
                watched_runtime.unwatch(checkpoint)

    def _fit_pipeline(self, train_data, spec, eval_data, eval_metric,
                      validation_metric, epoch_end_callback,
                      batch_end_callback, eval_end_callback,
                      eval_batch_end_callback, begin_epoch, num_epoch,
                      bulk):
        """fit(pipeline=...): Module implements it
        (module/pipeline_fit.py); other module types do not partition
        into pipeline stages."""
        raise NotImplementedError(
            'fit(pipeline=...) is only supported on Module (%s does not '
            'partition into pipeline stages)' % type(self).__name__)

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    monitor=None, bulk=None, resume_info=None,
                    checkpoint=None, ckpt_step=None):
        """The epoch loop of fit, batch by batch, or in K-step dispatches
        with bulk=K; the resumed epoch continues at its watermark with
        its partial metric, and each step (dispatch) ends at the
        checkpoint's step_end."""
        for epoch in range(begin_epoch, num_epoch):
            epoch_start = time.time()
            eval_metric.reset()
            epoch_off = 0
            if resume_info is not None and epoch == resume_info.epoch:
                from .. import elastic
                elastic._restore_metric(
                    eval_metric, resume_info.manifest.get('metric'))
                epoch_off = resume_info.batches_in_epoch
            if bulk is not None:
                self._fit_epoch_bulk(train_data, bulk, eval_metric,
                                     batch_end_callback, epoch,
                                     step_cb=ckpt_step, nbatch0=epoch_off,
                                     checkpoint=checkpoint)
            else:
                for nbatch, data_batch in enumerate(train_data):
                    nbatch += epoch_off
                    if monitor is not None:
                        monitor.tic()
                    aux = self._aux_snapshot(checkpoint)
                    try:
                        self.forward_backward(data_batch)
                        self.update()
                    except MXNetError:
                        self._peer_death_preempt(checkpoint, ckpt_step,
                                                 nbatch, epoch, aux)
                        raise
                    self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        _fire(batch_end_callback,
                              BatchEndParam(epoch=epoch, nbatch=nbatch,
                                            eval_metric=eval_metric,
                                            locals=locals()))
                    if ckpt_step is not None:
                        ckpt_step(nbatch + 1, 1, epoch)
            for name, val in eval_metric.get_name_value():
                self.logger.info('Epoch[%d] Train-%s=%f', epoch, name, val)
            self.logger.info('Epoch[%d] Time cost=%.3f', epoch,
                             time.time() - epoch_start)

            # a host copy of the parameters for the epoch's callbacks
            arg_snap, aux_snap = self.get_params()
            self.set_params(arg_snap, aux_snap)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_snap, aux_snap)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info('Epoch[%d] Validation-%s=%f',
                                     epoch, name, val)
            train_data.reset()
            if checkpoint is not None and checkpoint.preempted:
                # a signal after the epoch's last step_end: commit the
                # epoch boundary as the final checkpoint and unwind
                from .. import elastic
                ckpt = checkpoint.save(epoch=epoch + 1,
                                       batches_in_epoch=0,
                                       batch_size=0, sync=True)
                raise elastic.Preempted(
                    checkpoint.step, ckpt,
                    dead_ranks=checkpoint.preempt_dead_ranks)
        if checkpoint is not None:
            checkpoint.wait()   # drain pending async commits

    def _aux_snapshot(self, checkpoint):
        """Copies of the auxiliary states (BatchNorm's moving statistics)
        before a step, when a peer's death could fail it: the step's
        forward has updated them by the time its cross-process sum
        fails. None otherwise."""
        if checkpoint is None:
            return None
        from .. import dist
        if dist.runtime() is None:
            return None
        eg = getattr(self, '_exec_group', None)
        if eg is None:
            mod = getattr(self, '_curr_module', None)
            eg = getattr(mod, '_exec_group', None)
        if eg is None:
            return None
        return [(a, a._data.clone()) for a in eg.aux_arrays]

    @staticmethod
    def _peer_death_preempt(checkpoint, step_cb, nbatch, epoch, aux=None):
        """A cross-process step that failed because a peer died (the
        heartbeats say so) becomes a coordinated preemption: the
        parameters are the consistent state after the previous step
        (the batched cross-process sum fails before any key updates),
        the auxiliary states go back to their copies from before the
        step, and the final checkpoint is committed and Preempted
        raised. The caller re-raises the original error when no manager
        is wired or no peer is dead."""
        if checkpoint is None or step_cb is None:
            return
        from .. import dist
        dead = dist.detect_dead()
        if not dead:
            return
        for a, saved in aux or ():
            a._data = saved
        checkpoint.request_preempt(dead_ranks=dead)
        step_cb(nbatch, 0, epoch)   # commits and raises Preempted

    def _fit_epoch_bulk(self, train_data, bulk, eval_metric,
                        batch_end_callback, epoch, step_cb=None,
                        nbatch0=0, checkpoint=None):
        """One fit epoch in dispatches of up to `bulk` batches, for
        Module and BucketingModule alike: consecutive batches group while
        `_bulk_group_key` stays the same (the ladder rung; the base key
        never splits), and `_bulk_dispatch_group` runs a group. Callbacks
        and step_cb(nbatch_done, steps, epoch) fire once a dispatch, with
        nbatch at its last batch; nbatch0 is the resumed epoch's
        watermark."""
        state = {'nbatch': int(nbatch0)}
        group = []
        group_key = [None]

        def flush():
            if not group:
                return
            k = len(group)
            aux = self._aux_snapshot(checkpoint)
            try:
                self._bulk_dispatch_group(list(group), bulk, eval_metric)
            except MXNetError:
                self._peer_death_preempt(checkpoint, step_cb,
                                         state['nbatch'], epoch, aux)
                raise
            state['nbatch'] += k
            del group[:]
            if batch_end_callback is not None:
                _fire(batch_end_callback,
                      BatchEndParam(epoch=epoch,
                                    nbatch=state['nbatch'] - 1,
                                    eval_metric=eval_metric,
                                    locals=locals()))
            if step_cb is not None:
                step_cb(state['nbatch'], k, epoch)

        for data_batch in train_data:
            key = self._bulk_group_key(data_batch)
            if group and key != group_key[0]:
                flush()
            group_key[0] = key
            group.append(data_batch)
            if len(group) >= bulk:
                flush()
        flush()

    def _bulk_group_key(self, data_batch):
        """Consecutive batches join one dispatch while this stays the
        same; the base key never splits."""
        return None

    def _bulk_dispatch_group(self, group, bulk, eval_metric):
        """Run one group of _fit_epoch_bulk: a single batch per step, a
        larger group (a trailing partial one included) as one
        bulk_step."""
        if len(group) == 1:
            self.forward_backward(group[0])
            self.update()
            self.update_metric(eval_metric, group[0].label)
        else:
            self.bulk_step(batches=group, eval_metric=eval_metric)

    def _wrap_train_iter(self, train_data):
        """Hook to decorate the training iterator (Module stages batches
        on the device). Default: as it is."""
        return train_data

    # -- properties --------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError
