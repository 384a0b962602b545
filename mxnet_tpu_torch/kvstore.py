"""KVStore: the distribution facade, the counterpart of mxnet_tpu/kvstore.py
(reference include/mxnet/kvstore.h, python/mxnet/kvstore.py).

The API of the reference (named keys, init/push/pull, the updater,
rank/size/barrier) over three data paths:

- 'local' and 'device': one process; a key's values from several
  contexts (cpu(0)..cpu(n), gpu(0)) are summed on the first one's
  device, and the updater runs where the stored weight lies (moved once
  to the gradient's device, so that a card's updates stay on the card).
- 'dist_sync' and 'dist_device_sync' without parameter servers: the
  worker processes of a job started by `tools.launch -s 0`; each step's
  gradients are summed across the processes through the dist runtime's
  host allreduce (`dist.allreduce`, star or ring), then each process
  runs the same update, so the replicas stay bit-equal.
- 'dist_*' with parameter servers (`KVStoreDistPS`, when
  DMLC_PS_ROOT_URI and DMLC_NUM_SERVER > 0 are set): gradients go to
  the `kvstore_server` processes, which run the optimizer and answer
  pulls with the reference's sync semantics.

A worker of several ranks (`tools.launch --ranks-per-worker`,
parallel/worker_group.py) is one worker to the servers and the runtime:
its ranks' data mesh sums their gradients in the step, its leader
pushes them once and the pulled weights reach every rank from it.

Sparse embedding keys (`mark_sparse`): on the dist runtime's host
all-reduce their gradient crosses the processes as deduplicated (unique
ids, rows) pairs (`dist.allreduce_coo`) instead of a dense (vocab, dim)
array, and the store applies it rows-only (`_apply_sparse_coo`,
parallel/embedding.sparse_row_update, lazy momentum). 'dist_async'
without servers runs with synchronous semantics, as in the JAX package.
"""
import os
import pickle
import warnings

import torch

from . import _hostarray as ha
from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError


def _ctype_key_value(keys, vals):
    if isinstance(keys, (int, str)):
        keys = [keys]
        vals = [vals]
    out_vals = []
    for v in vals:
        out_vals.append(v if isinstance(v, list) else [v])
    return keys, out_vals


def _on_device(host_array, like):
    """An NDArray of a host array, on `like`'s device and context."""
    return nd.NDArray(ha.to_tensor(host_array, device=like._data.device),
                      like.context)


class KVStore:
    """The single-process store and the serverless dist store (the
    module docstring)."""

    def __init__(self, kv_type='local', zero=None):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._zero = zero
        self._pending = {}
        self._sparse_meta = {}    # key -> vocab (mark_sparse)
        self._sparse_state = {}   # key -> momentum of a sparse key
        self._is_dist = 'dist' in kv_type
        if 'async' in kv_type and type(self) is KVStore:
            warnings.warn('dist_async without parameter servers runs with '
                          'synchronous allreduce semantics; use '
                          'tools.launch -s N for true async.')

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        keys, vals = _ctype_key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k in self._store:
                raise MXNetError('key %s already initialized' % str(k))
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Push gradients; the values of several contexts are summed."""
        from . import profiler
        with profiler.scope('kvstore_push', 'kvstore'):
            self._push_impl(key, value, priority)

    @staticmethod
    def _merge_local(vlist):
        """The sum of a key's values over contexts, on the first one's
        device (one stacked reduction)."""
        if len(vlist) == 1:
            return vlist[0]
        dev = vlist[0]._data.device
        return nd.NDArray(
            torch.stack([v._data.to(dev) for v in vlist]).sum(0),
            vlist[0].context)

    def _cross_host_sum(self, merged_list):
        """The cross-process leg: sum the merged gradients across the
        worker processes through the dist runtime's allreduce, all of a
        step's keys in one round (MXNET_TPU_DIST_WIRE_DTYPE compresses
        it). Identity without a dist store or a runtime. No world-1
        short cut: a world-1 relaunch of an elastic job takes the same
        host round trip as its larger predecessor, so its arithmetic
        is the same."""
        if not self._is_dist:
            return merged_list
        from . import dist
        if not dist.host_span_active():
            return merged_list
        sums = dist.allreduce([ha.host(v) for v in merged_list],
                              name='kv_grad')
        return [_on_device(s, v) for s, v in zip(sums, merged_list)]

    def _push_impl(self, key, value, priority=0, _cross_summed=False):
        keys, vals = _ctype_key_value(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError('key %s not initialized' % str(k))
            merged = self._merge_local(vlist)
            if not _cross_summed:
                merged = self._cross_host_sum([merged])[0]
            if self._updater is not None:
                stored = self._store[k]
                if stored._data.device != merged._data.device:
                    # the store's weight follows its gradient once, so
                    # the updater's state lives where the gradients do
                    stored = self._store[k] = stored.as_in_context(
                        merged.context)
                self._updater(self._key_index(k), merged, stored)
            else:
                self._pending[k] = merged

    def pull(self, key, out=None, priority=0):
        from . import profiler
        with profiler.scope('kvstore_pull', 'kvstore'):
            self._pull_impl(key, out, priority)

    def _pull_impl(self, key, out=None, priority=0):
        keys, outs = _ctype_key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError('key %s not initialized' % str(k))
            src = self._store[k]
            if self._updater is None and k in self._pending:
                src = self._pending[k]
            for o in olist:
                # the destination keeps its device and dtype
                val = src._data
                if (val.device, val.dtype) != (o._data.device,
                                               o._data.dtype):
                    val = val.to(o._data.device, o._data.dtype)
                o._data = val

    def push_pull_all(self, keys, grad_lists, out_lists):
        """Push every gradient, then pull every weight: a step's round
        as one call, so that the dist paths batch it (all dense keys'
        cross-process sums in one allreduce round; with
        MXNET_TPU_DIST_OVERLAP=1 one async round per key, each waited
        at its update). Local semantics equal the per-key loop."""
        from . import dist
        if self._is_dist and dist.host_span_active():
            merged = [self._merge_local(g if isinstance(g, list)
                                        else [g]) for g in grad_lists]
            # a marked key crosses as COO rows when its gradient is 2-D
            sparse = [str(k) in self._sparse_meta and m.ndim == 2
                      for k, m in zip(keys, merged)]
            if dist.overlap_active():
                self._push_pull_overlapped(keys, merged, out_lists, sparse)
                return
            summed = iter(self._cross_host_sum(
                [m for m, sp in zip(merged, sparse) if not sp]))
            for k, m, sp, o in zip(keys, merged, sparse, out_lists):
                if sp:
                    self._apply_sparse_coo(k, *self._coo_cross_host(k, m))
                else:
                    self._push_impl(k, next(summed), _cross_summed=True)
                self.pull(k, o)
            return
        for k, g, o in zip(keys, grad_lists, out_lists):
            self.push(k, g)
            self.pull(k, o)

    def _push_pull_overlapped(self, keys, merged, out_lists, sparse):
        """MXNET_TPU_DIST_OVERLAP=1: every dense key's cross-process round
        launched up front (the runtime's FIFO worker keeps the launch
        order the same on every rank), each waited at its update; sparse
        keys' COO rounds stay synchronous."""
        from . import dist
        handles = [None if sp else
                   dist.allreduce_async([ha.host(m)], name='kv_grad:%s' % k)
                   for k, m, sp in zip(keys, merged, sparse)]
        for k, m, sp, h, o in zip(keys, merged, sparse, handles, out_lists):
            if sp:
                self._apply_sparse_coo(k, *self._coo_cross_host(k, m))
            else:
                self._push_impl(k, _on_device(h.wait()[0], m),
                                _cross_summed=True)
            self.pull(k, o)

    def mark_sparse(self, key, vocab):
        """Declare `key` a sparse embedding table of `vocab` rows: on the
        dist runtime's host all-reduce its gradient crosses as COO (unique
        ids, rows) pairs and applies rows-only. Module.init_optimizer
        marks its sparse_grad tables."""
        self._sparse_meta[str(key)] = int(vocab)

    def _coo_cross_host(self, key, merged):
        """The touched rows of one marked key's gradient (an embedding's
        backward writes only those; every other row is exact zeros),
        summed over the processes by dist.allreduce_coo. A touched row
        whose gradient is all zero drops out: its lazy update would
        change nothing."""
        import numpy as np
        from . import dist
        g = ha.host(merged._data).astype(np.float32)
        nz = np.flatnonzero(np.any(g != 0.0, axis=1))
        return dist.allreduce_coo(nz, np.ascontiguousarray(g[nz]),
                                  name='kv_grad_coo:%s' % key,
                                  vocab=self._sparse_meta[str(key)])

    def _apply_sparse_coo(self, key, uids, rows):
        """The rows-only update of the stored weight by the summed COO
        gradient (parallel/embedding.sparse_row_update, the fused
        update's arithmetic), its momentum kept per key with lazy
        semantics. An optimizer other than plain-precision SGD applies a
        dense gradient made of the rows (the wire carried COO all the
        same)."""
        import numpy as np
        stored = self._store[key]
        opt_ = self._optimizer
        sgd = type(opt_).__name__ == 'SGD' and \
            not getattr(opt_, 'multi_precision', False)
        if self._updater is None or not sgd:
            dense = np.zeros(stored.shape, np.float32)
            if len(uids):
                dense[np.asarray(uids)] = np.asarray(rows)
            self._push_impl(key, _on_device(dense, stored),
                            _cross_summed=True)
            return
        from .parallel.embedding import sparse_row_update
        index = self._key_index(key)
        lr = opt_._get_lr(index)
        wd = opt_._get_wd(index)
        opt_._update_count(index)
        if not len(uids):
            return
        mom = float(getattr(opt_, 'momentum', 0.0) or 0.0)
        w = stored._data.clone()
        m = self._sparse_state.get(key)
        if m is None:
            m = torch.zeros_like(w) if mom != 0.0 else w
        dev = w.device
        sparse_row_update(
            w, m, torch.as_tensor(np.asarray(uids), device=dev).long(),
            torch.as_tensor(np.asarray(rows), device=dev), lr, wd,
            momentum=mom, rescale=float(getattr(opt_, 'rescale_grad', 1.0)),
            clip=getattr(opt_, 'clip_gradient', None))
        self._store[key] = nd.NDArray(w, stored.context)
        if mom != 0.0:
            self._sparse_state[key] = m

    # -- updater / optimizer ----------------------------------------------
    @property
    def zero_stage(self):
        """The ZeRO stage asked for: the constructor's, else
        MXNET_TPU_ZERO (parallel.zero.zero_stage); Module.init_optimizer
        takes it when it is given no `zero`."""
        from .parallel import zero as zero_mod
        return zero_mod.zero_stage(self._zero)

    def _key_index(self, key):
        return key

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Drive `optimizer` through this store's updater. The pickle
        round trip of the reference's server channel is exercised (the
        symbol is dropped from it, as on the wire), but the caller's
        object keeps driving, so that changes to it (lr decay,
        set_wd_mult) take effect."""
        sym_ref = getattr(optimizer, 'sym', None)
        optimizer.sym = None
        try:
            pickle.loads(pickle.dumps(optimizer))
        finally:
            optimizer.sym = sym_ref
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    @property
    def updater(self):
        return self._updater

    # -- optimizer state checkpointing (reference kvstore.py:323-346) -----
    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError('Cannot save states for distributed training')
        from .base import atomic_file
        with atomic_file(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError('Cannot load states for distributed training')
        with open(fname, 'rb') as fin:
            self._updater.set_states(fin.read())

    # -- topology ----------------------------------------------------------
    @property
    def rank(self):
        if self._is_dist:
            from . import dist
            return dist.rank()
        return 0

    @property
    def num_workers(self):
        if self._is_dist:
            from . import dist
            return dist.world()
        return 1

    def get_rank(self):
        return self.rank

    def get_group_size(self):
        return self.num_workers

    @property
    def num_dead_node(self):
        """Real cross-process deaths from the dist runtime's heartbeat
        table, plus the virtual hosts MXNET_TPU_FAULT_DEAD_HOST
        declares (reference KVStore::get_num_dead_node)."""
        from . import elastic
        return elastic.num_dead_node()

    def barrier(self, timeout=None):
        """Global barrier across workers. A rank that does not arrive
        within `timeout` (default MXNET_TPU_BARRIER_TIMEOUT_S) or that
        is dead fails it with an error naming the ranks, never a
        hang."""
        from . import elastic
        elastic.check_barrier()
        if self._is_dist:
            from . import dist
            rt = dist.runtime()
            if rt is not None:
                rt.barrier('kvstore_barrier', timeout=timeout)

    def send_command_to_servers(self, head, body):
        pass  # no server processes

    _send_command_to_servers = send_command_to_servers

    def run_server(self, controller):
        pass  # kept for launcher compatibility (reference RunServer)


class KVStoreDistPS(KVStore):
    """`dist_*` store over parameter-server processes (reference
    KVStoreDist, kvstore_dist.h:50), chosen when the DMLC_PS_ROOT_URI
    contract of `tools.launch -s N` (N > 0) is present. The servers run
    the optimizer with the reference's sync accumulation
    (kvstore_server.py)."""

    def __init__(self, kv_type, zero=None):
        super().__init__(kv_type, zero=zero)
        from . import kvstore_server as ps
        from .parallel import worker_group
        host = os.environ['DMLC_PS_ROOT_URI']
        port = int(os.environ['DMLC_PS_ROOT_PORT'])
        self._num_servers = int(os.environ.get('DMLC_NUM_SERVER', '1'))
        self._num_workers_env = int(os.environ.get('DMLC_NUM_WORKER', '1'))
        self._rank = int(os.environ.get('DMLC_WORKER_ID', '0'))
        # a worker of several ranks (parallel/worker_group.py): its
        # leader alone speaks to the servers
        self._group = worker_group.init()
        self._leader = self._group is None or self._group.leader
        self._client = ps.DistServerClient(
            host, port, self._num_servers, rank=self._rank) \
            if self._leader else None
        # push frames this rank sent: one a key and step for a worker
        self.pushes = 0
        self._update_on_kvstore = True
        if 'async' in kv_type and self._rank == 0 and self._leader:
            # reference: rank 0 sends the sync/async mode command to the
            # servers (kvstore.cc:48-52 kSyncMode)
            self._client.set_sync_mode(False)
        self.barrier()

    def init(self, key, value):
        keys, vals = _ctype_key_value(key, value)
        for k, vlist in zip(keys, vals):
            # only rank 0 initializes (reference kvstore_dist.h:96)
            if self.rank == 0 and self._leader:
                self._client.init(k, ha.host(vlist[0]))
        self.barrier()

    def _merge_grads(self, value):
        """A key's gradient summed over contexts, as a host array."""
        vlist = value if isinstance(value, list) else [value]
        return ha.host(self._merge_local(vlist))

    @staticmethod
    def _write(outs, val):
        for o in (outs if isinstance(outs, list) else [outs]):
            o._data = ha.to_tensor(val, device=o._data.device,
                                   dtype=o._data.dtype)

    def _from_leader(self, vals):
        """The leader's pulled values on every rank of the worker."""
        if self._group is None:
            return vals
        from .parallel import worker_group
        return worker_group.broadcast_host(vals)

    def push(self, key, value, priority=0):
        """Push gradients (the values of several contexts summed); in a
        worker of several ranks, whose gradients the data mesh already
        summed, the leader's push is the worker's."""
        keys, vals = _ctype_key_value(key, value)
        for k, vlist in zip(keys, vals):
            if self._leader:
                self._client.push(k, self._merge_grads(vlist))
                self.pushes += 1

    def pull(self, key, out=None, priority=0):
        keys, outs = _ctype_key_value(key, out)
        for k, olist in zip(keys, outs):
            val = self._client.pull(k) if self._leader else None
            self._write(olist, self._from_leader([val])[0])

    def push_pull_all(self, keys, grad_lists, out_lists):
        """A step's round: every gradient in one frame per server, every
        weight back in its reply (2 x #servers round trips, not 2 x
        #keys)."""
        vals = None
        if self._leader:
            pairs = [(k, self._merge_grads(value))
                     for k, value in zip(keys, grad_lists)]
            got = self._client.push_pull_multi(pairs)
            self.pushes += len(pairs)
            vals = [got[k] for k in keys]
        vals = self._from_leader(vals)
        for val, out in zip(vals, out_lists):
            self._write(out, val)

    def set_optimizer(self, optimizer):
        """Pickle the optimizer to the servers, from rank 0 only, as the
        reference does (every re-send would rebuild the server updater
        and drop its state)."""
        err = None
        if self.rank == 0 and self._leader:
            sym_ref = getattr(optimizer, 'sym', None)
            optimizer.sym = None
            try:
                blob = pickle.dumps(optimizer)
            finally:
                optimizer.sym = sym_ref
            try:
                self._client.set_optimizer(blob)
            except MXNetError as e:
                # a refusal (no DMLC_PS_TOKEN) must not strand the other
                # ranks, already heading into the barrier: join it, then
                # raise
                err = e
        self.barrier()
        if err is not None:
            raise err
        if self._leader and not self._client.has_updater():
            raise MXNetError(
                'set_optimizer did not install a server-side updater '
                '(rank 0 was refused: is DMLC_PS_TOKEN set?)')
        self._optimizer = optimizer
        self._update_on_kvstore = True

    def set_updater(self, updater):
        # the updater runs on the servers: a worker-side one would never
        # run
        raise MXNetError(
            'dist kvstore runs the updater on the servers; use '
            'set_optimizer instead (reference update_on_kvstore path)')

    _set_updater = set_updater

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers_env

    def barrier(self, timeout=None):
        """PS-store barrier; `timeout` bounds each server's wait (None
        blocks, as the reference). A worker's ranks meet behind their
        leader."""
        from . import elastic
        from .parallel import worker_group
        elastic.check_barrier()
        if self._leader:
            self._client.barrier(timeout=timeout)
        worker_group.barrier()

    def send_heartbeat(self):
        """Stamp liveness on the servers (ps-lite heartbeats)."""
        if self._leader:
            self._client.heartbeat(self._rank)

    def get_num_dead_node(self, node_id=0, timeout_sec=60):
        """Workers silent on the servers longer than timeout_sec
        (reference KVStore::get_num_dead_node, kvstore.h:287), plus the
        injected dead virtual hosts."""
        from . import elastic
        dead = self._client.num_dead(timeout_sec) if self._leader else 0
        return dead + elastic.num_dead_node()

    @property
    def num_dead_node(self):
        return self.get_num_dead_node()

    def send_command_to_servers(self, head, body):
        if head == 'stop' and self._leader:
            self._client.stop_servers()

    _send_command_to_servers = send_command_to_servers

    def stop_servers(self):
        """Rank-0 teardown (reference ~KVStoreDist sends kStopServer)."""
        if self.rank == 0 and self._leader:
            self._client.stop_servers()

    def close(self):
        if self._leader:
            self._client.close()


def create(name='local', zero=None):
    """A KVStore (reference kvstore.py:411): local, device,
    local_allreduce_*, dist_sync, dist_device_sync, dist_async.
    `dist_*` takes the parameter servers when DMLC_PS_ROOT_URI and
    DMLC_NUM_SERVER > 0 are set (`tools.launch -s N`), else the dist
    runtime's allreduce."""
    if not isinstance(name, str):
        raise TypeError('name must be a string')
    if 'dist' in name and os.environ.get('DMLC_PS_ROOT_URI') and \
            int(os.environ.get('DMLC_NUM_SERVER', '0')) > 0:
        return KVStoreDistPS(name, zero=zero)
    return KVStore(name, zero=zero)
