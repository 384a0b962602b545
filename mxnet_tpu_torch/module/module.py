"""Module: a symbol, its executor and an optimizer; the counterpart of
mxnet_tpu/module/module.py (reference python/mxnet/module/module.py).

`current_context()` (gpu(0)) when no context is given. Several contexts
are a data mesh of as many ranks, one process each
(module/executor_group.py): every rank runs the same script, and its
step equals the JAX package's one program over the global batch. With
SGD or NAG the update is `optimizer.FusedSGD` over the whole parameter
list, in place on the executor's tensors, and with `zero=1` (or
MXNET_TPU_ZERO=1, or a store's zero_stage) its ZeRO-1 form, the
optimizer state sharded over the data axis (parallel/zero.py); any
other optimizer takes the per-key `Updater`. `rescale_grad` is 1 /
global batch. Checkpoints, parameter files and optimizer-state files are
the JAX package's formats.

The JAX package defers `forward_backward` to `update`, so that XLA sees
forward, backward and the update as one program; torch has no such
program, so `forward_backward` runs at once and `update` applies the
update to the gradients it left.

`bulk_step` runs K train steps as one dispatch of the executor's
multistep program (`Executor.make_fused_multistep`): the lr and wd
schedule evaluated on the host for every step index before it, the
batches stacked on the device (in `scan_dtype` where given), the metric
folded on the device (`metric.device_fold`), and no host
synchronisation among the steps. A step that cannot fuse takes the
per-step loop, as in the JAX package.

A store (`kvstore=` a name or a KVStore) takes the JAX package's
routing: `dist*_sync` multiplies the batch of rescale_grad by the
number of workers; the parameter-server store and the dist runtime's
store update key by key (the servers' optimizer, or the store's updater
after the cross-process sum), with no FusedSGD; a local store over one
device is no store at all.

`fit(pipeline=(S, M))` trains over a {'data', 'pipe'} mesh of the
contexts' ranks through the GPipe engine (module/pipeline_fit.py).

A worker of several ranks (`tools.launch --ranks-per-worker`,
parallel/worker_group.py), the JAX package's hybrid worker: the Module
over the worker's contexts is a data mesh of the worker's ranks, which
sums the gradients in the step, and the workers sync through the
parameter server or the dist runtime's host all-reduce key by key; the
batch of rescale_grad is the worker's times the number of workers.
"""
import logging
import os

import torch

from .. import context as ctx_mod
from .. import initializer as init_mod
from .. import io as mxio
from .. import metric as metric_mod
from .. import model as model_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from ..base import MXNetError, atomic_file, torch_dtype
from ..executor import _tensor_of
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=('data',),
                 label_names=('softmax_label',), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = list(context)
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + list(state_names or [])
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names, self._label_names = data_names, label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()

        self._arg_params = self._aux_params = None
        self._params_dirty = False

        self._optimizer = self._kvstore = self._updater = None
        self._fused_updater = None
        self._bulk_cache_key = self._bulk_step_fn = None
        self._update_on_kvstore = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = self._label_shapes = None

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint `prefix`, `epoch`; its parameters
        and (with load_optimizer_states) optimizer states are set at
        bind and init_optimizer."""
        sym, args, auxs = model_mod.load_checkpoint(
            prefix, epoch, ctx=ctx_mod.cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = '%s-%04d.states' % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save('%s-symbol.json' % prefix)
        param_name = '%s-%04d.params' % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = '%s-%04d.states' % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
        save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        buckets = {'arg': {}, 'aux': {}}
        for key, value in nd.load(fname, ctx=ctx_mod.cpu()).items():
            kind, _, name = key.partition(':')
            if kind not in buckets:
                raise ValueError('Invalid param file ' + fname)
            buckets[kind][name] = value
        self.set_params(buckets['arg'], buckets['aux'])

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._exec_group.executor.outputs
        return [(n, o.shape) for n, o in zip(self._output_names, outs)] \
            if outs else None

    # -- parameters --------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): copies of the bound values, taken
        again after each update."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=init_mod.Uniform(0.01),
                    arg_params=None, aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        ctx = self._exec_group.context
        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(arr.shape, ctx, dtype=arr._data.dtype)
                for name, arr in zip(
                    self._param_names, self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(arr.shape, ctx, dtype=arr._data.dtype)
                for name, arr in zip(
                    self._aux_names, self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    if tuple(cache_arr.shape) != arr.shape:
                        raise MXNetError(
                            'shape mismatch for %s: %s vs %s'
                            % (name, cache_arr.shape, arr.shape))
                    if isinstance(cache_arr, nd.NDArray):
                        cache_arr.as_in_context(arr.context).copyto(arr)
                    else:
                        arr[:] = cache_arr
            else:
                if not allow_missing and cache is not None:
                    raise RuntimeError('%s is not presented' % name)
                if initializer is not None:
                    # `name` is an InitDesc with the variable's attrs
                    # (the __init__ attr dispatches inside)
                    initializer(name, arr)

        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            _impl(init_mod.InitDesc(name, attrs.get(name, None)), arr,
                  arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(init_mod.InitDesc(name, attrs.get(name, None)), arr,
                  aux_params)
        if not allow_extra:
            self._check_extra_params(arg_params, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def _check_extra_params(self, arg_params, aux_params):
        """Parameters the symbol does not know fail loudly unless
        allow_extra."""
        extra = []
        if arg_params:
            extra += [n for n in arg_params if n not in self._param_names
                      and n not in self._data_names
                      and n not in self._label_names
                      and n not in self._state_names]
        if aux_params:
            extra += [n for n in aux_params if n not in self._aux_names]
        if extra:
            raise MXNetError(
                'set_params/init_params got parameters not in the '
                'symbol (pass allow_extra=True to ignore them): %s'
                % sorted(extra))

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init,
                             allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        if not allow_extra:
            self._check_extra_params(arg_params, aux_params)
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning('Already binded, ignoring bind()')
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else []
        shared_group = shared_module._exec_group if shared_module else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
            # the loaded values live on the host; get_params copies the
            # bound ones back
            self._params_dirty = True

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False, zero=None):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning('optimizer already initialized, '
                                'ignoring...')
            return
        from ..parallel import zero as zero_mod
        eg = self._exec_group
        kvstore, update_on_kvstore = model_mod._create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if zero is None and kvstore is not None:
            zero = kvstore.zero_stage
        zero = zero_mod.zero_stage(zero)
        # the batch of a data mesh over the workers is the global batch
        # already; a worker's own mesh (parallel/worker_group.py) holds
        # its share
        from ..parallel import worker_group
        group = worker_group.current()
        batch_size = eg.batch_size
        if kvstore and 'dist' in kvstore.type and \
                '_sync' in kvstore.type and (eg.mesh is None or
                                             group is not None):
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            optimizer_params = dict(optimizer_params)
            if 'rescale_grad' not in optimizer_params:
                optimizer_params['rescale_grad'] = rescale_grad
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            # the initialized parameters to the store
            model_mod._initialize_kvstore(
                kvstore=kvstore,
                param_arrays=self._exec_group.param_arrays,
                arg_params=self._arg_params,
                param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        # the parameter-server store updates on its servers and the
        # dist runtime's store after its cross-process sum, key by key;
        # otherwise FusedSGD takes the whole list at once (a store is
        # then the parameters' facade only)
        from .. import dist
        from .. import kvstore as kvs_mod
        ps = isinstance(kvstore, kvs_mod.KVStoreDistPS)
        host_span = kvstore is not None and kvstore._is_dist and \
            not ps and dist.host_span_active()
        if eg.dp > 1 and (ps or host_span) and (
                group is None or group.size != eg.dp):
            # the data mesh must be the worker's own: one over the
            # workers would sum the gradients twice
            raise MXNetError(
                'a Module over %d contexts syncs through the %s only as a '
                'worker of %d ranks (tools.launch --ranks-per-worker %d)'
                % (eg.dp, 'parameter server' if ps else
                   "dist runtime's host all-reduce", eg.dp, eg.dp))
        self._fused_updater = None
        ex = eg.executor
        # sparse_grad Embedding tables train rows-only in the fused
        # update; their positions are in the order of the parameters with
        # a gradient, the order update() and the fused step hand it
        sparse_idx, sparse_vocab = (), {}
        if kvstore is None or (not ps and not host_span):
            if not ex._grouped and type(optimizer) in (opt_mod.SGD,
                                                       opt_mod.NAG):
                ents = {e['weight']: e for e in ex._sparse_embed_entries()}
                fnames = [n for n, g in zip(self._param_names,
                                            eg.grad_arrays) if g is not None]
                sparse_idx = tuple(j for j, n in enumerate(fnames)
                                   if n in ents)
                sparse_vocab = {j: ents[fnames[j]]['vocab']
                                for j in sparse_idx}
            self._fused_updater = opt_mod.create_fused_updater(
                optimizer, self._param_names, zero=zero, mesh=eg.mesh,
                sparse_idx=sparse_idx, sparse_vocab=sparse_vocab)
            if sparse_idx:
                eg.set_sparse_tables({e['weight']: e['vocab'] for e in
                                      ex._sparse_embed_entries()})
        if zero and self._fused_updater is None:
            self.logger.warning(
                'ZeRO stage-1 requested but %s; running without the '
                'sharded update',
                'the parameter-server store updates on its servers' if ps
                else "the dist runtime's store updates key by key"
                if host_span else 'the %s optimizer has no fused update'
                % type(optimizer).__name__)
        # ZeRO-1 reduce-scatters this rank's own gradients in the update
        eg.use_grad_reduce(not (self._fused_updater is not None and
                                self._fused_updater.zero))
        if self._fused_updater is not None:
            self._update_on_kvstore = False
        elif update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
            if host_span and not ex._grouped:
                # sparse_grad tables cross the processes as COO rows
                try:
                    entries = ex._sparse_embed_entries()
                except MXNetError:
                    entries = ()
                for e in entries:
                    kvstore.mark_sparse(e['weight'], e['vocab'])
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer and its state (the buckets
        of a BucketingModule)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self._fused_updater = shared_module._fused_updater
        fu = self._fused_updater
        self._exec_group.use_grad_reduce(not (fu is not None and fu.zero))
        self.optimizer_initialized = True

    # -- per batch ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """Train-mode forward and backward of one batch, run at once (the
        JAX package defers them to update() only to give XLA one
        program)."""
        assert self.binded and self.params_initialized
        self._exec_group.forward_backward(data_batch)

    def _fusable_step(self):
        """True when a train step can run as the executor's fused
        program: a fused updater, no input gradients, an executor that is
        neither grouped nor monitored, and every differentiable argument
        a grad_req 'write' parameter the updater owns."""
        if self._fused_updater is None or not self.optimizer_initialized \
                or self.inputs_need_grad:
            return False
        eg = self._exec_group
        ex = eg.executor
        if ex._grouped or ex._monitor_callback is not None:
            return False
        fnames = [n for n, g in zip(self._param_names, eg.grad_arrays)
                  if g is not None]
        if ex._diff_names != fnames:
            return False
        return all(ex._grad_req.get(n) == 'write' for n in fnames)

    def _scan_names(self, ex, fnames):
        eg = self._exec_group
        return [n for n in eg.data_names + eg.label_names
                if n in ex.arg_dict and n not in set(fnames)]

    def _ensure_bulk_program(self, ex, fu, scan_names, k, stacked,
                             scan_dtype, fold):
        """The executor's K-step program with the fold's metric update in
        it, kept while the executor, updater, K and fold stay."""
        plan = self._exec_group.reduce_plan
        fkey = (fu.cache_key(), fold.key if fold is not None else None,
                'lrstack', plan.key if plan is not None else None)
        cache_key = (id(ex), id(fu), 'stacked' if stacked else 'repeat',
                     k, str(scan_dtype), fkey)
        if self._bulk_cache_key != cache_key:
            metric_arg = None
            if fold is not None:
                eg = self._exec_group
                order = [n for n in ex._arg_names if n in set(scan_names)]
                label_pos = {n: i for i, n in enumerate(order)
                             if n in eg.label_names}
                out_names = self._symbol.list_outputs()

                def m_update(mc, outs, sv):
                    label = {n: sv[i] for n, i in label_pos.items()}
                    return fold.update(mc, label, dict(zip(out_names, outs)))
                metric_arg = (fold.init, m_update)
            self._bulk_step_fn = ex.make_fused_multistep(
                fu.step_math, scan_names, repeat=None if stacked else k,
                step_key=fkey, metric=metric_arg, lr_stacked=True,
                grad_reduce=self._ensure_reduce_plan(
                    ex, fu, ex._diff_names))
            self._bulk_cache_key = cache_key
        return self._bulk_step_fn

    def _stack_batches(self, batches, scan_names, scan_dtype):
        """{name: (K, ...) tensor} of the batches' data and labels on the
        executor's device, the data in scan_dtype where given."""
        eg = self._exec_group
        ex = eg.executor
        device = eg.context.torch_device
        data_set = set(eg.data_names)
        per_name = {n: [] for n in scan_names}
        for b in batches:
            vals = dict(zip(eg.data_names, b.data))
            if eg.label_names and b.label:
                vals.update(zip(eg.label_names, b.label))
            for n in scan_names:
                store = scan_dtype if (scan_dtype is not None and
                                       n in data_set) \
                    else ex.arg_dict[n]._data.dtype
                per_name[n].append(_tensor_of(eg.local_rows(vals[n]), store,
                                              device))
        return {n: torch.stack(v) for n, v in per_name.items()}

    def warmup_fused(self, bulk=None, eval_metric=None, scan_dtype=None,
                     single=True):
        """Build this module's fused train programs and run each once on
        copies of its state (Executor.warm_fused_multistep): the one-step
        program and, for bulk=K > 1, the K-step program with
        eval_metric's fold. The programs key into exec_cache, so an
        equivalent module built later finds them. No parameter, aux,
        optimizer or schedule state changes. Returns False, warming
        nothing, when the step cannot fuse."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if not self._fusable_step():
            return False
        eg = self._exec_group
        ex = eg.executor
        fu = self._fused_updater
        fnames = ex._diff_names
        fu.param_names = list(fnames)
        weights = [ex.arg_dict[n] for n in fnames]
        scan_names = self._scan_names(ex, fnames)
        device = eg.context.torch_device
        plan = [(1, None)] if single else []
        if bulk is not None and int(bulk) > 1:
            plan.append((int(bulk), metric_mod.device_fold(eval_metric)
                         if eval_metric is not None else None))
        for k, fold in plan:
            stacks = {n: torch.zeros(
                (k,) + tuple(ex.arg_dict[n].shape),
                dtype=(torch_dtype(scan_dtype) if scan_dtype is not None
                       and n in eg.data_names
                       else ex.arg_dict[n]._data.dtype), device=device)
                for n in scan_names}
            moms, masters, lrs, wds = fu.host_prep_steps(weights, k,
                                                         advance=False)
            fn = self._ensure_bulk_program(ex, fu, scan_names, k, True,
                                           scan_dtype if k > 1 else None,
                                           fold)
            ex.warm_fused_multistep(fn, fnames, scan_names, stacks, moms,
                                    masters, lrs, wds)
        return True

    def bulk_step(self, batches=None, batch=None, repeat=None,
                  scan_dtype=None, eval_metric=None):
        """K full train steps (forward, backward, update) as one dispatch
        of the executor's multistep program: `batches` (a list of
        DataBatch, stacked on the device) or `batch` with `repeat=K` (the
        one batch K times).

        lr and wd are evaluated on the host at every step index before
        the dispatch, so a scheduler boundary crossed inside it takes
        effect at its step, as in the per-step loop. `eval_metric` needs
        a device fold (metric.device_fold): its sums run on the device
        inside the dispatch, and one pair of device scalars per leaf
        metric reaches it, read at its next get(). Only the last step's
        outputs are kept, and monitors do not fire. `scan_dtype` is the
        storage dtype of the stacked data (labels keep theirs); each step
        casts its slice back. A step that cannot fuse takes the per-step
        loop."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        k = len(batches) if batches is not None else repeat
        if batches is None:
            assert batch is not None and repeat is not None
        if k == 0:
            return
        if not self._fusable_step():
            for b in (batches if batches is not None else [batch] * k):
                self._single_step(b)
                if eval_metric is not None:
                    self.update_metric(eval_metric, b.label)
            return
        eg = self._exec_group
        ex = eg.executor
        fu = self._fused_updater
        fnames = ex._diff_names
        fu.param_names = list(fnames)
        fold = None
        if eval_metric is not None:
            fold = metric_mod.device_fold(eval_metric)
            if fold is None:
                raise ValueError(
                    'bulk_step: metric %r has no device fold (see '
                    'metric.device_fold); run the per-step loop for '
                    'host-only metrics'
                    % (getattr(eval_metric, 'name', eval_metric),))
        scan_names = self._scan_names(ex, fnames)
        scan_stacks = None
        if batches is not None:
            if k == 1:
                self._single_step(batches[0])
                if eval_metric is not None:
                    self.update_metric(eval_metric, batches[0].label)
                return
            eg.load_data_batch(batches[0])   # shape checks
            scan_stacks = self._stack_batches(batches, scan_names,
                                              scan_dtype)
        else:
            eg.load_data_batch(batch)
        weights = [ex.arg_dict[n] for n in fnames]
        moms, masters, lrs, wds = fu.host_prep_steps(weights, k)
        fn = self._ensure_bulk_program(ex, fu, scan_names, k,
                                       batches is not None, scan_dtype,
                                       fold)
        new_moms, new_masters, mcarry = ex.run_fused_multistep(
            fn, fnames, scan_names, scan_stacks, moms, masters, lrs, wds,
            zero=bool(fu.zero))
        fu.commit(new_moms, new_masters)
        if fold is not None:
            fold.commit(fold.global_carry(mcarry, eg.mesh))
        self._params_dirty = True
        self._note_step_counters(k, metric_steps=k if fold is not None
                                 else 0)

    def _note_step_counters(self, k, metric_steps=0):
        """The profiler's comm_stats after k fused steps: the ZeRO
        payload bytes, this rank's optimizer-state bytes, and the steps
        whose metric folded on the device."""
        from .. import profiler
        fu = self._fused_updater
        if fu is None:
            return
        rs, ag = fu.comm_bytes_per_step()
        if rs or ag:
            profiler.add_comm_bytes(reduce_scattered=rs * k,
                                    all_gathered=ag * k)
        profiler.set_optimizer_state_bytes(fu.state_bytes_per_device())
        if metric_steps:
            profiler.add_reduce_stats(metric_steps=metric_steps)
        if fu.sparse_idx:
            # the rows-only update's bytes against the dense update's (the
            # JAX package's Module path counts none; its Gluon path does)
            from ..parallel import embedding as embed_mod
            ents = self._exec_group.executor._sparse_embed_entries()
            ex = self._exec_group.executor
            plan = embed_mod.SparseEmbedPlan([
                {'pos': e['dpos'], 'vocab': e['vocab'], 'dim': e['dim'],
                 'dtype': embed_mod._np_dtype(
                     ex.arg_dict[e['weight']]._data.dtype)} for e in ents])
            rungs = [e['rung'] for e in ents]
            mom = fu.momentum != 0.0
            profiler.add_embed_stats(
                steps=k, dispatches=1,
                lookups=k * sum(len(e['ids']) for e in ents),
                unique_rows=k * sum(rungs),
                touched_bytes=k * plan.touched_bytes(rungs, mom),
                dense_equiv_bytes=k * plan.dense_equiv_bytes(mom),
                max_rung=max(rungs))

    def _ensure_reduce_plan(self, ex, fu, fnames):
        """The in-step all-reduce of the gradients (collectives.
        GradReduce over the data axis), or None where none applies: one
        rank, or ZeRO, whose sharded update reduce-scatters them."""
        eg = self._exec_group
        if eg.dp == 1 or fu.zero:
            return None
        return ex.grad_reduce

    def _single_step(self, data_batch):
        self.forward_backward(data_batch)
        self.update()

    def _fit_pipeline(self, train_data, spec, eval_data, eval_metric,
                      validation_metric, epoch_end_callback,
                      batch_end_callback, eval_end_callback,
                      eval_batch_end_callback, begin_epoch, num_epoch,
                      bulk):
        """fit(pipeline=(S, M)): the dp x pipe GPipe mode, the symbol's
        chain partitioned into stages (module/pipeline_fit.py)."""
        from .pipeline_fit import fit_pipeline
        return fit_pipeline(
            self, train_data, spec, eval_data, eval_metric,
            validation_metric, epoch_end_callback, batch_end_callback,
            eval_end_callback, eval_batch_end_callback, begin_epoch,
            num_epoch, bulk)

    def update(self):
        """The optimizer's update of every parameter with a gradient."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        eg = self._exec_group
        if self._fused_updater is not None:
            names, weights, grads = [], [], []
            for n, w, g in zip(self._param_names, eg.param_arrays,
                               eg.grad_arrays):
                if g is not None:
                    names.append(n)
                    weights.append(w)
                    grads.append(g)
            fu = self._fused_updater
            fu.param_names = names
            if fu.sparse_idx:
                sg = eg.executor.sparse_grads
                grads = [sg[n] if n in sg else g
                         for n, g in zip(names, grads)]
            fu(weights, grads)
            self._note_step_counters(1)
            return
        if self._update_on_kvstore:
            model_mod._update_params_on_kvstore(
                eg.param_arrays, eg.grad_arrays, self._kvstore,
                self._param_names)
        else:
            model_mod._update_params(eg.param_arrays, eg.grad_arrays,
                                     updater=self._updater,
                                     num_device=1,
                                     kvstore=self._kvstore,
                                     param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    # -- optimizer states --------------------------------------------------
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        updater = self._fused_updater or self._updater
        with atomic_file(fname) as fout:
            fout.write(updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        updater = self._fused_updater or self._updater
        with open(fname, 'rb') as fin:
            updater.set_states(fin.read())

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

    def _wrap_train_iter(self, train_data):
        """fit's input pipeline: an image iterator left at its default
        worker count takes MXNET_TPU_DECODE_WORKERS decode workers (an
        explicit preprocess_threads wins), then upcoming batches are
        staged on the module's device (io.prefetch_to_device),
        MXNET_TPU_PREFETCH of them (default 2; 0 turns staging off)."""
        from ..image.image import decode_workers_from_env
        workers = decode_workers_from_env()
        if workers >= 2 and \
                getattr(train_data, '_workers_explicit', None) is False:
            train_data.set_preprocess_threads(workers)
        try:
            depth = int(os.environ.get('MXNET_TPU_PREFETCH', '2'))
        except ValueError:
            depth = 2
        if depth <= 0 or not self.binded or \
                isinstance(train_data, mxio.PrefetchToDeviceIter):
            return train_data
        eg = self._exec_group
        return mxio.prefetch_to_device(
            train_data, size=depth, device=eg.context,
            mesh=eg.mesh if eg.dp > 1 else None)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, sharing the parameters."""
        assert self.binded
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes) if label_shapes else []
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
