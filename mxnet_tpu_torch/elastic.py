"""Elastic training: async checkpoints, preemption-safe resume and fault
injection, the counterpart of mxnet_tpu/elastic.py.

- `CheckpointManager` snapshots parameters and optimizer state on the
  TRAINING thread as device-side copies made on its current stream
  (FusedSGD and the per-key updaters update in place, so the snapshot
  of step N must be taken before step N+1 is queued), records a CUDA
  event behind them, and hands them to a writer thread that waits on
  the event before copying to the host and writing, while training
  goes on.
- A checkpoint is a directory of self-checksummed shard files and a
  rank-0 `manifest.json` (step, epoch, the consumed-sample watermark,
  the ladder rung, the RNG states, the optimizer's schedule). Every
  file goes to a temp name and is `os.replace`d, the manifest last, so
  a crash leaves the previous checkpoint set or a complete new one.
  Retention keeps the newest K; the cadence is by steps or seconds;
  `incremental=K` writes K delta commits between full bases
  (`delta.py`), replayed at resume.
- `restore` is mode-portable: the optimizer state goes through the
  updaters' `set_states`, so FusedSGD, the per-key updater and a
  store's updater restore from one another's checkpoints. A torn or
  incomplete newest checkpoint falls back to the newest intact one.
- SIGTERM and SIGINT, or a peer's death seen by the dist runtime's
  heartbeats, commit a final checkpoint at the next step boundary and
  raise `Preempted`; the process exits `dist.PREEMPTED_EXIT` and
  `tools.launch --elastic` relaunches it.
- The MXNET_TPU_FAULT_* knobs inject the failures the recovery path
  must survive (kill at a step, torn checkpoint, slow or failed write,
  dead virtual host).

Shard files and deltas are byte-compatible with the JAX package's in
both directions; arrays are host arrays (`_hostarray`). The RNG entry
differs by nature: the port stores each device's torch.Generator state
('rng:torch:<device>'), and the JAX package's key ('rng:step') is
skipped at restore with a logged warning. Under ZeRO-1 each rank writes
its own block of every optimizer-state bucket ('zmom:<bucket>:<lo>:<hi>'
and 'zmaster:...', manifest mode 'zero'); a restore reassembles the
buckets and the restoring updater re-buckets them, at any data width
and stage. Counters:
profiler.ckpt_stats() and profiler.delta_stats().
"""
import json
import logging
import os
import pickle
import queue
import signal
import struct
import threading
import time
import zlib

import numpy as np

from . import _hostarray as ha
from .base import MXNetError, atomic_file

_CKPT_MAGIC = b'MXTPUCKv1\n'
_CKPT_END = b'MXTPUCKEND'
_MANIFEST = 'manifest.json'
_STEP_DIR = 'step-%08d'
_DELTA_DIR = 'delta-%08d'
_DELTA_FILE = 'delta-r00000.bin'
FORMAT_VERSION = 1


class Preempted(MXNetError):
    """Raised (out of fit / step_end) after a preemption signal — or
    after heartbeat loss revealed dead ranks (dist runtime) — once the
    final checkpoint has been committed.  `dead_ranks` carries the set
    of ranks whose death triggered the coordinated restart (empty for
    signal-driven preemptions); a tools/launch.py --elastic supervisor
    relaunches at equal-or-reduced world size and resumes."""

    def __init__(self, step, checkpoint_dir=None, dead_ranks=None):
        self.dead_ranks = frozenset(int(r) for r in (dead_ranks or ()))
        msg = ('training preempted at step %d (final checkpoint: %s)'
               % (step, checkpoint_dir))
        if self.dead_ranks:
            msg += '; dead rank(s): %s' % sorted(self.dead_ranks)
        super().__init__(msg)
        self.step = step
        self.checkpoint_dir = checkpoint_dir


# ---------------------------------------------------------------------------
# Fault injection (MXNET_TPU_FAULT_* knobs)
# ---------------------------------------------------------------------------

def fault_knob(name, default=None):
    """Raw value of MXNET_TPU_FAULT_<name>, or `default` when unset /
    empty.  Read lazily at each use so tests and the dryrun harness
    can flip knobs mid-process."""
    v = os.environ.get('MXNET_TPU_FAULT_' + name, '')
    return v if v.strip() else default


def _fault_int(name):
    v = fault_knob(name)
    try:
        return None if v is None else int(v)
    except ValueError:
        return None


def _fault_rank_set(name):
    """Comma-separated rank list of MXNET_TPU_FAULT_<name> as a
    frozenset (non-integer entries ignored) — the one parser every
    rank-list fault knob shares."""
    v = fault_knob(name)
    if v is None:
        return frozenset()
    out = set()
    for part in str(v).split(','):
        part = part.strip()
        if part:
            try:
                out.add(int(part))
            except ValueError:
                pass
    return frozenset(out)


def dead_hosts():
    """Virtual ranks declared dead via MXNET_TPU_FAULT_DEAD_HOST
    (comma-separated rank list).  Their checkpoint shards are withheld
    (the host died before its write landed) and the KVStore facade
    reports them through num_dead_node / fails barrier."""
    return _fault_rank_set('DEAD_HOST')


def heartbeat_drop_ranks():
    """Ranks whose heartbeats are suppressed WITHOUT killing the
    process (MXNET_TPU_FAULT_HEARTBEAT_DROP, comma-separated rank
    list) — the injected network partition the dist runtime's
    detection path must catch: everyone else declares the silent rank
    dead within the deadline."""
    return _fault_rank_set('HEARTBEAT_DROP')


def barrier_stall_s(rank):
    """Injected late barrier arrival (MXNET_TPU_FAULT_BARRIER_STALL_S):
    'R:SECS' stalls only rank R; a bare 'SECS' stalls every rank.
    Returns the stall for `rank` in seconds, or None."""
    v = fault_knob('BARRIER_STALL_S')
    if v is None:
        return None
    try:
        if ':' in str(v):
            r, secs = str(v).split(':', 1)
            return float(secs) if int(r) == int(rank) else None
        return float(v)
    except ValueError:
        return None


def ring_stall_s(rank):
    """Injected late arrival at a ring allreduce round
    (MXNET_TPU_FAULT_RING_STALL_S, same 'R:SECS' grammar as
    barrier_stall_s).  Falls back to MXNET_TPU_FAULT_BARRIER_STALL_S —
    the barrier-stall knob extends to ring hops, so one injection
    exercises both collective shapes (docs/DIST.md fault table)."""
    v = fault_knob('RING_STALL_S')
    if v is None:
        return barrier_stall_s(rank)
    try:
        if ':' in str(v):
            r, secs = str(v).split(':', 1)
            return float(secs) if int(r) == int(rank) else None
        return float(v)
    except ValueError:
        return None


def num_dead_node():
    """Dead-node count the KVStore facade reports: REAL cross-process
    deaths detected by the dist runtime's heartbeat table, plus any
    virtual hosts the fault harness injects.  0 outside failures."""
    from . import dist
    return len(dead_hosts() | dist.dead_ranks())


def check_barrier():
    """Raise when a barrier cannot logically complete because a host
    is dead — injected (MXNET_TPU_FAULT_DEAD_HOST) or REAL
    (heartbeat-detected by the dist runtime).  The honest
    ps::Postoffice::Barrier semantics: a dead host would hang the
    collective; failing fast with the rank set named is the
    recoverable behavior."""
    dead = dead_hosts()
    if dead:
        raise MXNetError(
            'barrier failed: %d dead node(s) %s (MXNET_TPU_FAULT_'
            'DEAD_HOST) — recover via elastic checkpoint resume'
            % (len(dead), sorted(dead)))
    from . import dist
    real = dist.dead_ranks()
    if real:
        raise MXNetError(
            'barrier failed: rank(s) %s are dead (heartbeat loss) — '
            'recover via coordinated elastic restart'
            % sorted(real))


# ---------------------------------------------------------------------------
# Self-checksummed shard files
# ---------------------------------------------------------------------------

def write_shard_file(path, entries):
    """Write named arrays as one self-checksummed blob: magic + JSON
    header (names/dtypes/shapes/sizes) + raw payloads + crc32/length
    trailer.  Torn writes (truncation, bit flips) fail validation at
    read time without any out-of-band checksum.  Committed via temp +
    os.replace so a crash mid-write never leaves a torn file under
    the final name.  Returns (bytes_written, crc32)."""
    header = []
    payloads = []
    for name, arr in entries:
        a = ha.contiguous(ha.host(arr))
        # a uint8 view of the array's buffer: crc32 and f.write take it
        # as it is, so the payload is never duplicated in host memory
        raw = memoryview(ha.raw_bytes(a))
        header.append({'name': name, 'dtype': ha.dtype_name(a),
                       'shape': list(a.shape), 'nbytes': ha.nbytes(a)})
        payloads.append(raw)
    hb = json.dumps(header).encode('utf-8')
    crc = 0
    with atomic_file(path) as f:
        def put(b):
            nonlocal crc
            crc = zlib.crc32(b, crc)
            f.write(b)
        put(_CKPT_MAGIC)
        put(struct.pack('<q', len(hb)))
        put(hb)
        for raw in payloads:
            put(raw)
        body_len = f.tell()
        f.write(struct.pack('<Iq', crc & 0xffffffff, body_len))
        f.write(_CKPT_END)
    return os.path.getsize(path), crc & 0xffffffff


def read_shard_file(path):
    """Read + validate a shard file; returns {name: host array}.
    Raises MXNetError on truncation / checksum mismatch / bad magic."""
    trailer = struct.calcsize('<Iq') + len(_CKPT_END)
    try:
        with open(path, 'rb') as f:
            blob = f.read()
    except OSError as e:
        raise MXNetError('checkpoint shard %s unreadable: %s'
                         % (path, e))
    if len(blob) < len(_CKPT_MAGIC) + 8 + trailer or \
            not blob.startswith(_CKPT_MAGIC) or \
            not blob.endswith(_CKPT_END):
        raise MXNetError('checkpoint shard %s is torn or not a '
                         'checkpoint file' % path)
    crc_stored, body_len = struct.unpack(
        '<Iq', blob[-trailer:-len(_CKPT_END)])
    # memoryview slices are views, not copies: a multi-GB shard is
    # held ONCE in host memory (the frombuffer arrays below are views
    # into the same blob)
    body = memoryview(blob)[:-trailer]
    if body_len != len(body) or \
            (zlib.crc32(body) & 0xffffffff) != crc_stored:
        raise MXNetError('checkpoint shard %s failed checksum/length '
                         'validation (torn write?)' % path)
    off = len(_CKPT_MAGIC)
    hlen, = struct.unpack('<q', body[off:off + 8])
    off += 8
    header = json.loads(bytes(body[off:off + hlen]).decode('utf-8'))
    off += hlen
    out = {}
    for ent in header:
        raw = body[off:off + ent['nbytes']]
        off += ent['nbytes']
        out[ent['name']] = ha.from_buffer(raw, ent['dtype'],
                                          ent['shape'])
    return out


# ---------------------------------------------------------------------------
# Snapshot capture (train-thread side: cheap async device copies)
# ---------------------------------------------------------------------------

def _device_snap(x):
    """A fresh copy of tensor x's current value, made on the calling
    thread's current stream: queued behind the in-flight step, so it
    reads the post-step value, and a tensor the next in-place update
    cannot touch. The writer waits on the save's event before it copies
    the snapshot to the host."""
    data = getattr(x, '_data', None)
    t = data if data is not None else x
    if ha.is_torch(t):
        return t.detach().clone()
    return ha.copy(ha.host(t))


def _local_full(arr):
    """One full local copy of a parameter or state tensor (replicated on
    every rank of a data mesh)."""
    return _device_snap(arr)


def _torch_world():
    """The world size of the torch.distributed group (1 when none)."""
    import torch.distributed as tdist
    return tdist.get_world_size() if tdist.is_initialized() else 1


_STORE_ROUNDS = {}


def _store_barrier(name, world, timeout):
    """A barrier of the torch.distributed group through its key-value
    store, which is safe from the checkpoint writer's thread while the
    training thread runs collectives on the group; best-effort, as the
    runtime's live-only barrier is."""
    import torch.distributed as tdist
    from torch.distributed import distributed_c10d
    store = distributed_c10d._get_default_store()
    rnd = _STORE_ROUNDS[name] = _STORE_ROUNDS.get(name, 0) + 1
    key = 'mxt/%s/%d' % (name, rnd)
    store.add(key, 1)
    deadline = time.monotonic() + timeout
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            logging.warning('elastic: store barrier %s timed out on rank %d',
                            key, tdist.get_rank())
            return
        time.sleep(0.01)


def _np32(v):
    """A loaded entry as numpy, bfloat16 (a torch CPU tensor on the
    host) widened to float32 (exactly)."""
    v = ha.host(v)
    if ha.is_torch(v):
        return v.float().numpy()
    return np.asarray(v)


def _snap_event(entries):
    """A CUDA event recorded on the current stream behind the device
    snapshots in `entries`, or None when none lies on a card."""
    for _, a in entries:
        if ha.is_torch(a) and a.is_cuda:
            import torch
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(a.device))
            return ev
    return None


def _to_host(entries, event):
    """The snapshot entries as host arrays, once `event` completed."""
    if event is not None:
        event.synchronize()
    return [(n, ha.host(a)) for n, a in entries]


def _sched_state(opt):
    """JSON-safe snapshot of the stateful lr scheduler (FactorScheduler
    mutates base_lr/count inside __call__ — update counts alone would
    leave a resumed schedule permanently behind)."""
    sched = getattr(opt, 'lr_scheduler', None)
    if sched is None:
        return None
    out = {}
    for k, v in sched.__dict__.items():
        if isinstance(v, (int, float, bool, str)) or v is None:
            out[k] = v
    return out


def _metric_state(metric):
    """Accumulated (sum_metric, num_inst) pairs for a metric tree —
    pending device deltas are drained first, so the values are the
    exact host-visible accumulation at snapshot time."""
    if metric is None:
        return None
    if hasattr(metric, 'metrics'):       # CompositeEvalMetric
        return {'composite': [_metric_state(m) for m in metric.metrics]}
    try:
        metric._drain_device()
    except Exception:
        pass
    return {'sum_metric': float(getattr(metric, 'sum_metric', 0.0)),
            'num_inst': int(getattr(metric, 'num_inst', 0))}


def _restore_metric(metric, state):
    if metric is None or state is None:
        return
    if 'composite' in state and hasattr(metric, 'metrics'):
        for m, s in zip(metric.metrics, state['composite']):
            _restore_metric(m, s)
        return
    metric.sum_metric = state.get('sum_metric', 0.0)
    metric.num_inst = state.get('num_inst', 0)
    metric._pending_device = None


# ---------------------------------------------------------------------------
# Target adapters: Module / BucketingModule / gluon FusedStep / Trainer
# ---------------------------------------------------------------------------

def _updater_of(target):
    """(fused_updater, per_key_updater) of the training target."""
    if hasattr(target, '_curr_module'):          # BucketingModule
        target = target._buckets[target._default_bucket_key]
    if hasattr(target, '_trainer'):              # gluon FusedStep
        target = target._trainer
    if hasattr(target, '_updaters'):             # gluon Trainer
        per_key = target._updaters[0] if target._updaters else None
        return target._fused_updater, per_key
    per_key = getattr(target, '_updater', None)
    if per_key is None:
        # update_on_kvstore: the optimizer state lives in the STORE's
        # local updater (kvstore.set_optimizer), e.g. the dist_sync
        # host-allreduce path — without this, momenta silently vanish
        # from every update_on_kvstore checkpoint
        kv = getattr(target, '_kvstore', None)
        per_key = getattr(kv, '_updater', None) if kv is not None \
            else None
    return getattr(target, '_fused_updater', None), per_key


def _capture_params(target):
    """[(namespaced name, device-copy)] of every parameter + aux the
    target trains, read straight off the device buffers (the host
    mirror can be stale mid-epoch)."""
    entries = []
    if hasattr(target, '_trainer'):              # gluon FusedStep
        # positional names: a re-created net gets fresh auto-prefixes,
        # so the trainer's order (and the sorted aux and frozen order)
        # is the identity, as FusedSGD's integer state keys are; a
        # striped sparse table is assembled whole (every rank calls)
        target._collect_params()
        for kind, plist in (('gparam', target._params),
                            ('gaux', target._aux_params),
                            ('gfrozen', target._frozen_params)):
            for i, p in enumerate(plist):
                entries.append(('%s:%d:%s' % (kind, i, p.name),
                                _local_full(target.full_param(p))))
        return entries
    mod = getattr(target, '_curr_module', target)   # BucketingModule
    eg = mod._exec_group
    ex = eg.executor
    for n in mod._param_names:
        if n in eg.sparse_tables:
            # a striped table whole, from every rank (a collective)
            entries.append(('param:%s' % n, _local_full(eg.full_param(n))))
        elif n in ex.arg_dict:
            entries.append(('param:%s' % n,
                            _local_full(ex.arg_dict[n]._data)))
    for n in mod._aux_names:
        if n in ex.aux_dict:
            entries.append(('aux:%s' % n,
                            _local_full(ex.aux_dict[n]._data)))
    return entries


def _capture_rng(target):
    """The state of every torch.Generator the port's samplers have drawn
    from (one per device, `random.generator`), as uint8 arrays."""
    from . import random as rnd
    with rnd._lock:
        gens = sorted(rnd._generators.items(), key=lambda kv: str(kv[0]))
    return [('rng:torch:%s' % dev, gen.get_state().numpy().copy())
            for dev, gen in gens]


def _capture_optimizer(target):
    """(entries, opt_meta): optimizer state as shard-file entries plus
    the JSON manifest metadata needed to reassemble them.  ZeRO-1
    buckets contribute only their LOCAL 1/dp shards; replicated state
    contributes full per-param arrays; optimizers without a fused path
    fall back to the per-key Updater's pickled states blob."""
    fu, per_key = _updater_of(target)
    entries = []
    if fu is not None:
        opt = fu.optimizer
        meta = {'counts': [[k, int(v)] for k, v in
                           opt._index_update_count.items()],
                'num_update': int(opt.num_update),
                'sched': _sched_state(opt),
                'param_names': list(fu.param_names)}
        if fu.zero and fu._staged is not None:
            # restored but not yet bucketed: the per-name staged values
            staged_moms, staged_masters = fu._staged
            meta['mode'] = 'replicated'
            for n, v in staged_moms.items():
                entries.append(('mom:%s' % n, _local_full(v)))
            for n, v in staged_masters.items():
                if v is not None:
                    entries.append(('master:%s' % n, _local_full(v)))
            return entries, meta
        if fu.zero and fu._zero_moms is not None:
            # this rank's block of each bucket, named by its range
            lay = fu._layout
            index = 0 if fu.mesh is None else fu.mesh.axis_index('data')
            meta['mode'] = 'zero'
            meta['param_names'] = list(fu._layout_names)
            meta['zero_buckets'] = [
                {'index': b.index, 'size': b.size, 'padded': b.padded,
                 'sizes': list(b.sizes), 'offsets': list(b.offsets),
                 'shapes': [list(x) for x in b.shapes],
                 'param_idx': list(b.param_idx),
                 'acc_dtype': str(b.acc_dtype).split('.')[-1],
                 'mp': bool(b.mp)}
                for b in lay.buckets]
            sparse_moms = fu._full_sparse(
                {fu.param_names[j]: fu.states[fu.param_names[j]]
                 for j in fu.sparse_idx if fu.param_names[j] in fu.states})
            for n, v in sparse_moms.items():
                entries.append(('mom:%s' % n, _local_full(v)))
            for b, mom, mas in zip(lay.buckets, fu._zero_moms,
                                   fu._zero_masters):
                lo, hi = lay.shard_range(b, index)
                entries.append(('zmom:%d:%d:%d' % (b.index, lo, hi),
                                _device_snap(mom)))
                if b.mp and mas is not None:
                    entries.append(('zmaster:%d:%d:%d' % (b.index, lo, hi),
                                    _device_snap(mas)))
            return entries, meta
        meta['mode'] = 'replicated'
        # striped sparse momenta whole (a collective over the data axis)
        moms = fu._full_sparse(dict(fu.states))
        for n in fu.param_names:
            v = moms.get(n)
            if v is not None:
                entries.append(('mom:%s' % n, _local_full(v)))
            m = fu.masters.get(n)
            if m is not None:
                entries.append(('master:%s' % n, _local_full(m)))
        return entries, meta
    if per_key is not None and getattr(per_key, 'states', None):
        blob = np.frombuffer(per_key.get_states(), dtype=np.uint8)
        return [('optblob', blob)], {'mode': 'pickle'}
    return [], {'mode': 'none'}


def _assemble_optimizer(meta, arrays):
    """Rebuild per-param (moms, masters) dicts from loaded shard
    entries: ZeRO flat buckets are reassembled from their per-rank
    pieces and unpacked with the manifest's layout — independent of
    the dp width / zero stage of either run (re-sharding happens in
    the restoring updater's own host_prep)."""
    mode = meta.get('mode', 'none')
    if mode == 'none':
        return None
    if mode == 'pickle':
        return {'blob': arrays['optblob'].tobytes()}
    names = meta.get('param_names', [])
    moms = {}
    masters = {}
    if mode == 'replicated':
        for key, v in arrays.items():
            if key.startswith('mom:'):
                moms[key[4:]] = v
            elif key.startswith('master:'):
                masters[key[7:]] = v
    else:
        # 'zero': each bucket reassembled from its per-rank blocks and
        # unpacked by the manifest's layout, whatever the data width and
        # stage of either run (the restoring updater re-buckets)
        for key, v in arrays.items():
            if key.startswith('mom:'):
                moms[key[4:]] = v
            elif key.startswith('master:'):
                masters[key[7:]] = v
        for b in meta['zero_buckets']:
            for kind, dest in (('zmom', moms), ('zmaster', masters)):
                pieces = []
                for key, v in arrays.items():
                    parts = key.split(':')
                    if parts[0] != kind or int(parts[1]) != b['index']:
                        continue
                    pieces.append((int(parts[2]), int(parts[3]), v))
                if not pieces:
                    continue
                pieces.sort(key=lambda p: p[0])
                dt = np.float32 if b['acc_dtype'] == 'bfloat16' \
                    else np.dtype(b['acc_dtype'])
                flat = np.zeros((b['padded'],), dtype=dt)
                covered = 0
                for lo, hi, v in pieces:
                    flat[lo:hi] = _np32(v).reshape(-1)
                    covered += hi - lo
                if covered < b['size']:
                    raise MXNetError(
                        'checkpoint bucket %d incomplete: %d of %d '
                        'elements covered' % (b['index'], covered,
                                              b['size']))
                for i, off, n, shape in zip(b['param_idx'], b['offsets'],
                                            b['sizes'], b['shapes']):
                    dest[names[i]] = flat[off:off + n].reshape(shape)
    # normalize gluon integer param names (JSON round-trips keys fine
    # as list pairs, but entry names are strings)
    def fix(d):
        out = {}
        name_set = {str(n): n for n in names}
        for k, v in d.items():
            out[name_set.get(k, k)] = v
        return out
    counts = {}
    for kv in meta.get('counts') or []:
        counts[kv[0]] = kv[1]
    return {'moms': fix(moms), 'masters': fix(masters),
            'counts': counts,
            'num_update': meta.get('num_update'),
            'sched': meta.get('sched')}


def _restore_optimizer(target, meta, arrays):
    _apply_optimizer(target, _assemble_optimizer(meta, arrays))


def _apply_optimizer(target, asm):
    """Install a pre-assembled (and therefore pre-VALIDATED) optimizer
    state — assembly is split out so restore() can reject an
    incomplete checkpoint BEFORE any target mutation."""
    if asm is None:
        return
    fu, per_key = _updater_of(target)
    if 'blob' in asm:
        for u in (fu, per_key):
            if u is not None:
                u.set_states(asm['blob'])
        return
    payload = pickle.dumps((
        {n: ha.host(v) for n, v in asm['moms'].items()},
        dict(asm['counts']),
        {n: ha.host(v) for n, v in asm['masters'].items()}))
    applied = False
    for u in (fu, per_key):
        if u is not None:
            u.set_states(payload)
            applied = True
    tr = target._trainer if hasattr(target, '_trainer') else \
        target if hasattr(target, '_updaters') else None
    if tr is not None:
        if tr._fused_updater is None:
            # the fused updater takes them when fuse_step builds it
            tr._pending_fused_states = payload
            applied = True
        tr._last_update_mode = None
    if not applied:
        raise MXNetError('restore: target has no optimizer to restore '
                         'into (call init_optimizer first)')
    opt = fu.optimizer if fu is not None else \
        per_key.optimizer if per_key is not None else tr._optimizer
    if opt is not None:
        if asm['num_update'] is not None:
            opt.num_update = int(asm['num_update'])
        if asm['sched'] and getattr(opt, 'lr_scheduler', None) \
                is not None:
            opt.lr_scheduler.__dict__.update(asm['sched'])


def _host_nd(v):
    from . import ndarray as nd
    from .context import cpu
    return nd.NDArray(ha.to_tensor(ha.copy(ha.host(v))), cpu())


def _restore_params(target, arrays):
    if hasattr(target, '_trainer'):              # gluon FusedStep
        target._collect_params()
        lists = {'gparam': target._params, 'gaux': target._aux_params,
                 'gfrozen': target._frozen_params}
        for key, v in arrays.items():
            parts = key.split(':', 2)
            plist = lists.get(parts[0])
            if plist is None:
                continue
            i = int(parts[1])
            if i >= len(plist):
                raise MXNetError(
                    'checkpoint parameter %s has no positional match in '
                    'the restoring net (%d %s params)'
                    % (key, len(plist), parts[0][1:]))
            # the step re-replicates (and re-stripes) a replaced slot
            plist[i].set_data(_host_nd(v))
        return
    args = {k[6:]: _host_nd(v) for k, v in arrays.items()
            if k.startswith('param:')}
    auxs = {k[4:]: _host_nd(v) for k, v in arrays.items()
            if k.startswith('aux:')}
    target.set_params(args, auxs, allow_missing=True, force_init=True)
    kv = getattr(target, '_kvstore', None)
    if kv is not None and getattr(target, '_update_on_kvstore', False):
        # update_on_kvstore: the STORE's copy of the weights is what
        # the updater reads and the post-step pull hands back — left
        # stale (init-time values from _initialize_kvstore, which ran
        # before this restore), the very first resumed step would
        # silently overwrite the restored parameters
        from . import kvstore as kvs_mod
        if type(kv) is kvs_mod.KVStore and hasattr(kv, '_store'):
            for name, v in args.items():
                if name in kv._store:
                    kv._store[name] = v.copy()


def _restore_rng(target, arrays):
    """Set each device's torch.Generator from its 'rng:torch:<device>'
    entry. A JAX package's key ('rng:step') has no torch counterpart:
    it is skipped with a logged warning (parameters and optimizer state
    still restore)."""
    import torch
    from . import random as rnd
    if 'rng:step' in arrays:
        logging.warning('elastic: skipping the checkpoint\'s JAX RNG key '
                        '(rng:step): the port\'s generators are '
                        'torch.Generator states')
    for key, v in arrays.items():
        if not key.startswith('rng:torch:'):
            continue
        dev = torch.device(key[len('rng:torch:'):])
        if dev.type == 'cuda' and not torch.cuda.is_available():
            logging.warning('elastic: skipping %s (no CUDA here)', key)
            continue
        state = torch.from_numpy(np.array(ha.host(v), np.uint8))
        rnd.generator(dev).set_state(state)


# ---------------------------------------------------------------------------
# ResumeInfo + checkpoint discovery
# ---------------------------------------------------------------------------

class ResumeInfo(object):
    """What a restored checkpoint says about where training was."""

    __slots__ = ('step', 'epoch', 'batches_in_epoch', 'samples_consumed',
                 'rung', 'directory', 'manifest')

    def __init__(self, manifest, directory):
        self.manifest = manifest
        self.directory = directory
        self.step = int(manifest.get('step', 0))
        self.epoch = int(manifest.get('epoch', 0))
        self.batches_in_epoch = int(manifest.get('batches_in_epoch', 0))
        self.samples_consumed = int(manifest.get('samples_consumed', 0))
        self.rung = manifest.get('rung')

    def __repr__(self):
        return ('ResumeInfo(step=%d, epoch=%d, batches_in_epoch=%d, '
                'samples_consumed=%d, rung=%r)'
                % (self.step, self.epoch, self.batches_in_epoch,
                   self.samples_consumed, self.rung))


def list_checkpoints(directory):
    """Step numbers of the checkpoint dirs under `directory` that have
    a manifest, newest first (manifest presence only — validation
    happens at load)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith('step-'):
            try:
                s = int(n[5:])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(directory, n, _MANIFEST)):
                steps.append(s)
    return sorted(steps, reverse=True)


def list_deltas(directory):
    """Step numbers of the DELTA checkpoint dirs under `directory`
    that have a manifest, newest first (chain integrity is only
    established at load)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith('delta-'):
            try:
                s = int(n[6:])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(directory, n, _MANIFEST)):
                steps.append(s)
    return sorted(steps, reverse=True)


def _read_manifest(ckpt_dir):
    mpath = os.path.join(ckpt_dir, _MANIFEST)
    try:
        with open(mpath, 'r') as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError('checkpoint manifest %s unreadable: %s'
                         % (mpath, e))
    if manifest.get('format') != FORMAT_VERSION:
        raise MXNetError('checkpoint %s has unsupported format %r'
                         % (ckpt_dir, manifest.get('format')))
    return manifest


def _load_one(ckpt_dir):
    """(manifest, arrays) for one checkpoint dir; raises MXNetError on
    any validation failure (torn manifest, missing shard, checksum)."""
    manifest = _read_manifest(ckpt_dir)
    arrays = {}
    for fname in manifest.get('files', []):
        fpath = os.path.join(ckpt_dir, fname)
        if not os.path.isfile(fpath):
            raise MXNetError('checkpoint %s is missing shard %s (host '
                             'died before its write landed?)'
                             % (ckpt_dir, fname))
        arrays.update(read_shard_file(fpath))
    return manifest, arrays


def _load_delta_chain(directory, step):
    """(manifest, arrays) reconstructed for the delta checkpoint at
    `step`: load its full base, then replay every delta in the chain
    in order.  Raises MXNetError (DeltaChainError is one) on any break
    — a torn base or delta payload, a fingerprint mismatch, a missing
    chain member — so load_newest_intact falls back past it the same
    way it falls back past a torn full checkpoint."""
    from . import delta as delta_mod
    tip_dir = os.path.join(directory, _DELTA_DIR % step)
    tip = _read_manifest(tip_dir)
    dm = tip.get('delta') or {}
    base_step = dm.get('base_step')
    chain = dm.get('chain') or []
    if base_step is None or not chain or chain[-1] != step:
        raise MXNetError('delta checkpoint %s has a malformed chain '
                         'record' % tip_dir)
    base_dir = os.path.join(directory, _STEP_DIR % int(base_step))
    base_manifest, state = _load_one(base_dir)
    fp = base_manifest.get('fp') or delta_mod.fingerprint(state)
    for s in chain:
        ddir = os.path.join(directory, _DELTA_DIR % int(s))
        man = tip if int(s) == int(step) else _read_manifest(ddir)
        meta = man.get('delta') or {}
        arrays = {}
        for fname in man.get('files', []):
            fpath = os.path.join(ddir, fname)
            if not os.path.isfile(fpath):
                raise MXNetError('delta checkpoint %s is missing '
                                 'payload %s' % (ddir, fname))
            arrays.update(read_shard_file(fpath))
        state = delta_mod.apply_delta(state, meta, arrays,
                                      expect_fp=fp)
        fp = meta.get('new_fp')
    return tip, state


def load_state(ckpt_dir):
    """(manifest, arrays) for a committed checkpoint dir of EITHER
    kind — a full `step-*` dir loads directly, a `delta-*` dir replays
    its chain from the base.  The mode-portable entry point callers
    (the push channel's serving export) use so they never care which
    role a commit happened to get."""
    norm = os.path.normpath(ckpt_dir)
    base = os.path.basename(norm)
    if base.startswith('delta-'):
        return _load_delta_chain(os.path.dirname(norm), int(base[6:]))
    return _load_one(ckpt_dir)


def load_newest_intact(directory, validate=None):
    """(manifest, arrays, ckpt_dir) of the newest checkpoint that
    validates end-to-end, falling back past torn/incomplete ones
    (counted in profiler ckpt_torn_fallbacks).  Full and delta commits
    compete by step number; a delta candidate replays base + chain and
    a break anywhere (torn delta payload, reaped base, fingerprint
    mismatch) falls back to the next-newest candidate — which is
    exactly the newest intact base+prefix, since every chain prefix is
    itself a committed delta checkpoint.  None when the directory
    holds no intact checkpoint.  `validate(manifest, arrays)` may run
    extra pre-acceptance checks — an MXNetError it raises falls back
    the same way (restore() assembly-validates the optimizer here,
    BEFORE any target mutation)."""
    from . import profiler
    cands = sorted([(s, 'full') for s in list_checkpoints(directory)]
                   + [(s, 'delta') for s in list_deltas(directory)],
                   reverse=True)
    for step, kind in cands:
        if kind == 'full':
            ckpt_dir = os.path.join(directory, _STEP_DIR % step)
        else:
            ckpt_dir = os.path.join(directory, _DELTA_DIR % step)
        try:
            if kind == 'full':
                manifest, arrays = _load_one(ckpt_dir)
            else:
                manifest, arrays = _load_delta_chain(directory, step)
            if validate is not None:
                validate(manifest, arrays)
            return manifest, arrays, ckpt_dir
        except MXNetError as e:
            logging.warning('elastic: skipping checkpoint %s: %s',
                            ckpt_dir, e)
            profiler.add_ckpt_stats(torn_fallbacks=1)
            if kind == 'delta':
                profiler.add_delta_stats(fallbacks=1)
    return None


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class _DeltaFallback(Exception):
    """Internal: a delta-role commit can't extend the chain (no
    resident base, shape/name change, encoder refusal) — the writer
    falls back to a full base in the same commit slot."""


class CheckpointManager(object):
    """Async, sharded, crash-safe checkpoints with cadence, retention,
    preemption handling and fault injection (module docstring).

    directory: checkpoint root (one `step-NNNNNNNN/` dir per commit).
    every_n_steps / every_n_secs: cadence (either or both; None
    disables that trigger — explicit save()/preemption still work).
    keep: retention — newest K checkpoints survive (older pruned
    after each commit).  async_: write on the background thread
    (False: every save commits synchronously before returning).
    rank/world: per-rank shard-file identity; default the dist
    runtime's rank and world, else 0 and 1.  A world > process count (virtual
    hosts) splits the local entries round-robin into per-rank files —
    the dryrun/test harness for multi-host layouts on one process.

    on_commit: optional callable(step_dir, manifest) fired on the LEAD
    rank after a checkpoint's manifest commits (from the writer thread
    for async saves — the training thread is never blocked by the
    hook).  This is the trainer-side half of the train->serve loop:
    wire `fleet_supervisor.CheckpointPusher(...).attach(mgr)` and every
    commit pushes into a live fleet as a canary; the canary VERDICT
    flows back as a typed PushVerdict — step_end() logs each one, and
    the pusher's consecutive-rollback stop arrives via request_stop()
    (raised at the next step boundary, Preempted-style).  A hook that
    raises is logged and training continues (a broken push path must
    never take the training run down with it).  docs/ELASTIC.md has
    the commit->push->canary->verdict state machine.

    incremental: K > 0 turns on INCREMENTAL checkpointing — K delta
    commits (`delta-NNNNNNNN/` dirs holding only what changed since
    the previous commit: touched table rows, dense diffs) between full
    bases.  delta_config: a delta.DeltaConfig (default keeps dense
    diffs raw/exact, so chain replay at resume is bit-identical to a
    full checkpoint).  Ignored on real multi-process runs.

    on_verdict: optional callable(verdict, consecutive_rollbacks=N)
    the attached CheckpointPusher fires for every canary verdict.
    When set, the pusher's consecutive-rollback limit DOESN'T raise
    RollbackStop — the hook owns the response instead (LrBackoff cuts
    the learning rate and lets training continue).
    """

    def __init__(self, directory, every_n_steps=None, every_n_secs=None,
                 keep=3, async_=True, rank=None, world=None,
                 deadline=30.0, on_commit=None, incremental=None,
                 delta_config=None, on_verdict=None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.every_n_steps = every_n_steps
        self.every_n_secs = every_n_secs
        self.keep = max(1, int(keep))
        self.async_ = bool(async_)
        self.deadline = float(deadline)
        if rank is None or world is None:
            from . import dist
            rt = dist.runtime()
            if rt is not None:
                # the dist runtime's rank/world IS the multi-host
                # identity (each launched process owns its shard file)
                rank = rt.rank if rank is None else rank
                world = rt.world if world is None else world
            elif _torch_world() > 1:
                # the ranks of a torch.distributed group (a data mesh)
                import torch.distributed as tdist
                rank = tdist.get_rank() if rank is None else rank
                world = tdist.get_world_size() if world is None else world
            else:
                rank, world = rank or 0, world or 1
        self.rank = int(rank)
        self.world = max(1, int(world))
        self._target = None
        self._step = 0
        self._last_save_step = None
        self._last_save_time = time.monotonic()
        self._preempt = threading.Event()
        self._preempt_signum = None
        self._preempt_dead = frozenset()
        self._old_handlers = {}
        self._queue = queue.Queue(maxsize=2)
        self._idle = threading.Event()
        self._idle.set()
        self._writer = None
        self._writer_err = None
        self._resumed = None
        self._lock = threading.Lock()
        self.on_commit = on_commit
        self.on_verdict = on_verdict
        self._stop_exc = None
        # incremental (delta) checkpointing: K delta commits between
        # full bases.  Gated OFF on real multi-process runs — deltas
        # are computed against a process-local chain state, which a
        # per-rank shard split does not carry.  The default delta
        # config keeps dense diffs RAW (exact), so a chain replay is
        # bit-identical to a full checkpoint — the kill/resume parity
        # contract survives incremental mode unchanged.
        self.incremental = max(0, int(incremental or 0))
        self._delta_cfg = None
        if self.incremental:
            from . import delta as delta_mod
            self._delta_cfg = delta_mod.DeltaConfig.resolve(
                delta_config, dense='raw')
        self._chain = None       # writer-thread chain state (no lock:
        self._commit_seq = 0     # only touched under self._lock / save)
        self.retain_refs = None  # callable -> steps the fleet pins

    # -- target ------------------------------------------------------------
    def attach(self, target):
        """Declare the training object checkpoints are taken from /
        restored into: a Module or a BucketingModule."""
        self._target = target
        return self

    def _require_target(self, target=None):
        t = target if target is not None else self._target
        if t is None:
            raise MXNetError('CheckpointManager: no target attached '
                             '(call attach(module_or_fused_step))')
        return t

    # -- properties --------------------------------------------------------
    @property
    def step(self):
        return self._step

    @property
    def preempted(self):
        return self._preempt.is_set()

    @property
    def last_resume(self):
        """ResumeInfo of the restore this manager performed (None when
        training started fresh)."""
        return self._resumed

    # -- signal handling ---------------------------------------------------
    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT)):
        """Arm preemption-safe shutdown: the first signal marks the
        run preempted — the next step_end() drains the in-flight
        dispatch, commits a final checkpoint within the deadline and
        raises Preempted.  A second signal restores the default
        handler (a stuck drain can still be killed)."""
        def _handler(signum, frame):
            if self._preempt.is_set():
                signal.signal(signum,
                              self._old_handlers.get(signum,
                                                     signal.SIG_DFL))
                return
            self._preempt_signum = signum
            self._preempt.set()
        for s in signals:
            self._old_handlers[s] = signal.signal(s, _handler)
        return self

    def uninstall_signal_handlers(self):
        for s, h in self._old_handlers.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._old_handlers = {}

    def request_preempt(self, dead_ranks=None):
        """Programmatic preemption (what the signal handler — and the
        dist runtime's heartbeat thread on detecting dead ranks —
        does): the next step_end drains the in-flight dispatch,
        commits a final checkpoint and raises Preempted carrying
        `dead_ranks`."""
        if dead_ranks:
            self._preempt_dead = frozenset(
                int(r) for r in dead_ranks)
        self._preempt.set()

    @property
    def preempt_dead_ranks(self):
        """Dead ranks attached to a pending/raised preemption (empty
        for signal-driven ones)."""
        return self._preempt_dead

    def request_stop(self, reason):
        """Ask the training loop to stop at the next step boundary —
        the Preempted-style unwind for NON-preemption stop conditions
        (e.g. the train->serve pusher's consecutive-rollback limit: a
        diverging run must stop burning fleet pushes).  `reason` is
        the exception instance step_end() will raise (e.g.
        fleet_supervisor.RollbackStop), or a string wrapped in
        MXNetError.  Unlike a preemption, no extra final checkpoint is
        committed — every state this run produced is already on disk
        (the commits are what triggered the verdicts)."""
        self._stop_exc = reason if isinstance(reason, BaseException) \
            else MXNetError(str(reason))

    # -- cadence -----------------------------------------------------------
    def _due(self):
        if self.every_n_steps is not None and \
                self._step - (self._last_save_step or 0) >= \
                int(self.every_n_steps) and \
                self._step != self._last_save_step:
            return True
        if self.every_n_secs is not None and \
                time.monotonic() - self._last_save_time >= \
                float(self.every_n_secs):
            return True
        return False

    def will_act(self, steps=1):
        """Would the NEXT `step_end(steps=steps)` act — commit a
        preemption/stop unwind, or take a cadence checkpoint?  The
        drain predicate for overlapped training loops: deferred work
        (queued metric folds, callback backlogs) only needs flushing
        when the coming boundary actually CONSUMES it, so the async
        pipeline stays unbroken across the common no-op steps.
        Conservative by design: a True may still end in a skipped
        async save (writer busy), which costs one early drain, never
        a checkpoint that saw half-folded state."""
        if self._preempt.is_set() or self._stop_exc is not None:
            return True
        if self.every_n_steps is not None:
            nxt = self._step + int(steps)
            if nxt - (self._last_save_step or 0) >= \
                    int(self.every_n_steps) and \
                    nxt != self._last_save_step:
                return True
        if self.every_n_secs is not None and \
                time.monotonic() - self._last_save_time >= \
                float(self.every_n_secs):
            return True
        return False

    def step_end(self, epoch=0, batches_in_epoch=0, batch_size=0,
                 steps=1, metric=None, rung=None, target=None):
        """Per-step bookkeeping hook (Module.fit calls it after every
        optimizer step or bulk dispatch):
        advances the step counter, fires the fault knobs, commits the
        final checkpoint + raises Preempted after a preemption signal,
        and takes a cadence checkpoint when due.  steps: how many
        optimizer steps the dispatch carried (bulk dispatches pass
        K)."""
        self._step += int(steps)
        kill_at = _fault_int('KILL_AT_STEP')
        kill_rank = _fault_int('KILL_RANK')
        if kill_at is not None and self._step >= kill_at and \
                (kill_rank is None or kill_rank == self.rank):
            # simulated preemption WITHOUT warning: SIGKILL self (the
            # resume path must work from the last cadence checkpoint).
            # KILL_RANK gates the kill to one rank of a launched job —
            # the machine-loss half of the coordinated-restart matrix.
            logging.warning('elastic: MXNET_TPU_FAULT_KILL_AT_STEP=%d '
                            'firing at step %d (rank %d)', kill_at,
                            self._step, self.rank)
            os.kill(os.getpid(), signal.SIGKILL)
        samples = int(batches_in_epoch) * int(batch_size)
        # train->serve loop feedback: verdicts the push hook collected
        # since the last boundary surface in the TRAINING loop's log
        # stream (ordered with its step/epoch lines) — the typed
        # PushVerdict objects stay readable on the pusher itself
        poll = getattr(self.on_commit, 'poll_verdicts', None)
        if poll is not None:
            try:
                for v in poll():
                    logging.log(
                        logging.WARNING
                        if getattr(v, 'kind', '') == 'rolled_back'
                        else logging.INFO,
                        'elastic: train->serve push verdict: %s', v)
            except Exception:
                logging.exception('elastic: verdict poll failed')
        if self._preempt.is_set():
            ckpt = self.save(epoch=epoch,
                             batches_in_epoch=batches_in_epoch,
                             batch_size=batch_size, metric=metric,
                             rung=rung, target=target, sync=True)
            raise Preempted(self._step, ckpt,
                            dead_ranks=self._preempt_dead)
        if self._stop_exc is not None:
            exc, self._stop_exc = self._stop_exc, None
            raise exc
        if self._due():
            self.save(epoch=epoch, batches_in_epoch=batches_in_epoch,
                      batch_size=batch_size, metric=metric, rung=rung,
                      target=target, sync=not self.async_)
        return samples

    # -- save --------------------------------------------------------------
    def save(self, epoch=0, batches_in_epoch=0, batch_size=0,
             metric=None, rung=None, target=None, sync=False):
        """Take a checkpoint of the attached target at the current
        step.  The device-side snapshot happens on the CALLING thread
        (cheap async copies); serialization + file I/O happen on the
        background writer unless sync=True (which also drains the
        writer within the deadline).  Returns the checkpoint dir path
        (the path it WILL commit to, for async saves), or None when a
        previous async write is still in flight (the snapshot is
        skipped — training must not stall on a slow filesystem)."""
        from . import profiler
        t = self._require_target(target)
        if not sync and not self._idle.is_set() and \
                not self._multiprocess():
            # never stall training on a slow filesystem: drop this
            # cadence snapshot (retried next step while still due).
            # MULTIPROCESS runs must NOT skip independently: every
            # rank has to take the same snapshots or the cross-rank
            # shard sets (and the commit-barrier generations) diverge
            # and no checkpoint ever assembles complete — there the
            # bounded writer queue absorbs the lag instead (the
            # enqueue below blocks only once two writes are pending)
            logging.info('elastic: skipping checkpoint at step %d '
                         '(previous write still in flight)',
                         self._step)
            profiler.add_ckpt_stats(skipped=1)
            return None
        t0 = time.perf_counter()
        entries = _capture_params(t)
        entries += _capture_rng(t)
        opt_entries, opt_meta = _capture_optimizer(t)
        entries += opt_entries
        if rung is None and hasattr(t, '_curr_bucket_key'):
            rung = t._curr_bucket_key
        manifest = {
            'format': FORMAT_VERSION,
            'step': self._step,
            'epoch': int(epoch),
            'batches_in_epoch': int(batches_in_epoch),
            'batch_size': int(batch_size),
            'samples_consumed': int(batches_in_epoch) * int(batch_size),
            'rung': list(rung) if isinstance(rung, (tuple, list))
            else rung,
            'world': self.world,
            'opt': opt_meta,
            'metric': _metric_state(metric),
            'time': time.time(),
        }
        snap_ms = (time.perf_counter() - t0) * 1e3
        # incremental mode: every (K+1)-th commit is a full base, the
        # K between are deltas against the writer's chain state.  The
        # role is decided HERE (calling thread) so the dir path this
        # save returns is the one that commits; the writer still falls
        # back to a full base when the chain can't extend (first
        # commit, post-restore, shape/name change, failed base write).
        role = 'full'
        if self.incremental > 0 and not self._multiprocess():
            if self._commit_seq % (self.incremental + 1) != 0:
                role = 'delta'
            self._commit_seq += 1
        dir_fmt = _DELTA_DIR if role == 'delta' else _STEP_DIR
        step_dir = os.path.join(self.directory, dir_fmt % self._step)
        job = (dict(manifest), list(entries), step_dir, snap_ms, role,
               _snap_event(entries))
        self._last_save_step = self._step
        self._last_save_time = time.monotonic()
        if sync:
            # drain any in-flight async write first: one writer at a
            # time keeps commit/prune ordering simple and makes the
            # final preemption checkpoint strictly newest.  If the
            # drain times out (hung filesystem past the deadline) the
            # sync write proceeds anyway — _write_checkpoint's lock
            # still serializes it against the stalled writer, so the
            # two can never interleave file writes or prune each
            # other's in-progress dir
            if not self.wait():
                logging.warning(
                    'elastic: async write still in flight past the '
                    'deadline; final checkpoint queues behind it')
            self._write_checkpoint(*job[:5], background=False,
                                   event=job[5])
        else:
            self._ensure_writer()
            self._idle.clear()
            self._queue.put(job)
        return step_dir

    def _ensure_writer(self):
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop,
                                            name='elastic-ckpt-writer',
                                            daemon=True)
            self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._write_checkpoint(*job[:5], background=True,
                                       event=job[5])
            except BaseException as e:        # noqa: B036
                from . import profiler
                profiler.add_ckpt_stats(failed_writes=1)
                self._writer_err = e
                logging.warning('elastic: async checkpoint write '
                                'failed: %s', e)
            finally:
                if self._queue.empty():
                    self._idle.set()
                self._queue.task_done()

    @staticmethod
    def _multiprocess():
        """True on a real multi-process run (the dist runtime's world, or
        the torch.distributed group's, is above 1), where each process
        owns exactly its rank's shard file. The single-process case,
        including the virtual-host harness, splits entries itself."""
        from . import dist
        rt = dist.runtime()
        if rt is not None:
            return rt.world > 1
        return _torch_world() > 1

    def _rank_of_entry(self, name, ordinal):
        """Which virtual rank's shard file an entry lands in
        (single-process only): manifest scalars / params / rng are
        rank-0; ZeRO bucket shards spread round-robin over the world
        (the virtual-host harness for multi-host layouts).  On a real
        multi-process run every local entry belongs to self.rank —
        see _write_checkpoint."""
        if self.world <= 1:
            return 0
        if name.startswith(('zmom:', 'zmaster:')):
            return ordinal % self.world
        return 0

    def _barrier(self):
        """Cross-process sync before the lead-rank manifest commit
        (all shards must be durable first).  Under the dist runtime
        this is a LIVE-ONLY coordinator barrier — survivors of a dead
        rank can still commit their final checkpoint.  No-op
        single-process; best-effort either way (a failed barrier must
        not lose the checkpoint a survivor is about to commit)."""
        if not self._multiprocess():
            return
        from . import dist
        rt = dist.runtime()
        if rt is None:
            _store_barrier('elastic_ckpt', self.world, self.deadline)
            return
        try:
            # bounded by the manager deadline: a desynced peer (skipped
            # cadence save) must not pin the writer thread for the full
            # barrier default
            rt.barrier('elastic_ckpt', live_only=True,
                       timeout=self.deadline)
        except Exception as e:
            logging.warning('elastic: checkpoint barrier failed: %s', e)

    def _write_checkpoint(self, manifest, entries, step_dir, snap_ms,
                          role='full', background=False, event=None):
        """Materialize the snapshot to host and commit it: per-rank
        self-checksummed shard files first, manifest last (temp +
        os.replace each) — the manifest IS the commit point.  Fault
        knobs: WRITE_DELAY_MS sleeps first (slow filesystem),
        WRITE_FAIL raises (failed host write), TORN_CKPT truncates a
        shard AFTER commit (crash mid-write on a non-atomic store),
        DEAD_HOST withholds that rank's file while the manifest still
        lists it.

        Serialized on self._lock: the background writer and a
        sync/final save must never interleave shard writes or run
        _prune while the other is mid-write (prune reaps
        manifest-less dirs — an in-progress one must not qualify)."""
        delay = _fault_int('WRITE_DELAY_MS')
        if delay:
            time.sleep(delay / 1e3)
        entries = _to_host(entries, event)
        with self._lock:
            self._write_checkpoint_locked(manifest, entries, step_dir,
                                          snap_ms, role, background)

    def _write_checkpoint_locked(self, manifest, entries, step_dir,
                                 snap_ms, role, background):
        from . import profiler
        t0 = time.perf_counter()
        if fault_knob('WRITE_FAIL') is not None:
            raise MXNetError('injected host write failure '
                             '(MXNET_TPU_FAULT_WRITE_FAIL)')
        if role == 'delta':
            try:
                return self._write_delta_locked(manifest, entries,
                                                step_dir, snap_ms,
                                                background)
            except _DeltaFallback as e:
                # chain can't extend — write a full base instead (and
                # under the full dir name; the caller's returned delta
                # path simply never commits, like a skipped save)
                logging.info('elastic: delta commit at step %d '
                             'infeasible (%s) — writing a full base',
                             manifest['step'], e)
                profiler.add_delta_stats(rebases=1)
                step_dir = os.path.join(self.directory,
                                        _STEP_DIR % manifest['step'])
        os.makedirs(step_dir, exist_ok=True)
        lead = 0
        if self._multiprocess():
            # real multi-process run: THIS process writes exactly its
            # rank's file.  Replicated entries (params / rng / full
            # momenta) are identical everywhere, so only the LEAD rank
            # — the lowest LIVE one; rank 0 may be the casualty —
            # keeps them; other ranks contribute their local ZeRO
            # shards.  The manifest (lead rank, after the live-only
            # barrier) lists every LIVE rank's file: a dead rank's
            # unique shards are gone with its machine (an older
            # complete checkpoint covers them at resume), while listing
            # a file that can never land would make every post-death
            # checkpoint permanently unloadable.
            from . import dist
            gone = dead_hosts() | dist.dead_ranks()
            live = [r for r in range(self.world) if r not in gone]
            lead = min(live) if live else self.rank
            own = list(entries) if self.rank == lead else \
                [e for e in entries
                 if e[0].startswith(('zmom:', 'zmaster:'))]
            by_rank = {self.rank: own}
            files = ['state-r%05d.bin' % r for r in live]
        else:
            by_rank = {}
            zcount = 0
            for name, arr in entries:
                if name.startswith(('zmom:', 'zmaster:')):
                    r = self._rank_of_entry(name, zcount)
                    zcount += 1
                else:
                    r = self._rank_of_entry(name, 0)
                by_rank.setdefault(r, []).append((name, arr))
            files = ['state-r%05d.bin' % r for r in sorted(by_rank)]
        dead = dead_hosts()
        total_bytes = 0
        for r in sorted(by_rank):
            fname = 'state-r%05d.bin' % r
            if r in dead:
                logging.warning('elastic: withholding shard %s (dead '
                                'virtual host %d)', fname, r)
                continue
            nbytes, _crc = write_shard_file(
                os.path.join(step_dir, fname), by_rank[r])
            total_bytes += nbytes
        manifest['files'] = files
        new_chain = None
        if self.incremental > 0 and not self._multiprocess():
            # this full commit becomes the chain base for the next K
            # delta commits: keep its state resident on the writer and
            # stamp its fingerprint into the manifest BEFORE the
            # commit point (chain replay at resume re-checks it)
            from . import delta as delta_mod
            state = {n: ha.host(a) for n, a in entries}
            manifest['fp'] = delta_mod.fingerprint(state)
            new_chain = {'fp': manifest['fp'],
                         'base_step': manifest['step'],
                         'seq': 0, 'chain': [], 'state': state}
        self._barrier()     # all ranks' shards durable before commit
        if self.rank == lead:
            with atomic_file(os.path.join(step_dir, _MANIFEST),
                             mode='w') as f:
                json.dump(manifest, f)
        if new_chain is not None:
            self._chain = new_chain
        if fault_knob('TORN_CKPT') is not None and by_rank:
            # simulate a crash mid-write on a store without atomic
            # rename: truncate the newest shard file IN PLACE after
            # commit — resume must detect it and fall back
            victim = os.path.join(step_dir,
                                  'state-r%05d.bin' % sorted(by_rank)[0])
            if os.path.isfile(victim):
                sz = os.path.getsize(victim)
                with open(victim, 'r+b') as f:
                    f.truncate(max(1, sz // 2))
                logging.warning('elastic: MXNET_TPU_FAULT_TORN_CKPT '
                                'truncated %s', victim)
        commit_ms = (time.perf_counter() - t0) * 1e3
        profiler.add_ckpt_stats(
            snapshots=1, bytes=total_bytes,
            async_overlap_ms=commit_ms if background else 0.0,
            commit_ms=commit_ms + snap_ms)
        if self.rank == lead:
            # one pruner: concurrent ranks racing unlinks over the
            # shared directory is pure noise (the lead also wrote the
            # manifest, so its view of "newest" is authoritative)
            self._prune()
            hook = self.on_commit
            if hook is not None:
                # the train->serve push hook: fired AFTER the manifest
                # commit (the checkpoint is durable — a push must never
                # advertise a prefix a crash could leave torn) and only
                # on the lead rank (one fleet push per commit, not one
                # per rank).  Runs on the writer thread for async
                # saves; a raising hook is contained — a broken push
                # path must never fail the checkpoint or the run
                try:
                    hook(step_dir, dict(manifest))
                except Exception:
                    logging.exception(
                        'elastic: on_commit hook failed for %s '
                        '(training continues)', step_dir)

    def _write_delta_locked(self, manifest, entries, delta_dir,
                            snap_ms, background):
        """Commit a DELTA checkpoint: one payload file of the state's
        diff against the writer's resident chain state (touched rows
        for tables, raw/int8 diffs for dense params — see delta.py),
        then the manifest (kind='delta', carrying the chain record:
        base step, base/new fingerprints, sequence number and the full
        member list) via the same temp+replace commit point.  The
        resident chain advances only past a committed delta — a write
        that dies anywhere leaves the chain (and every already-
        committed prefix) intact."""
        from . import profiler
        from . import delta as delta_mod
        t0 = time.perf_counter()
        chain = self._chain
        if chain is None:
            raise _DeltaFallback('no resident chain base')
        current = {n: ha.host(a) for n, a in entries}
        try:
            d_entries, meta, new_state = delta_mod.make_delta(
                chain['state'], current, seq=chain['seq'] + 1,
                base_fp=chain['fp'], config=self._delta_cfg)
        except MXNetError as e:
            raise _DeltaFallback(str(e))
        os.makedirs(delta_dir, exist_ok=True)
        nbytes, _crc = write_shard_file(
            os.path.join(delta_dir, _DELTA_FILE), d_entries)
        manifest['kind'] = 'delta'
        manifest['files'] = [_DELTA_FILE]
        manifest['delta'] = dict(
            meta, base_step=chain['base_step'],
            chain=list(chain['chain']) + [manifest['step']])
        with atomic_file(os.path.join(delta_dir, _MANIFEST),
                         mode='w') as f:
            json.dump(manifest, f)
        chain['state'] = new_state
        chain['fp'] = meta['new_fp']
        chain['seq'] = meta['seq']
        chain['chain'] = list(manifest['delta']['chain'])
        if fault_knob('TORN_CKPT') is not None:
            victim = os.path.join(delta_dir, _DELTA_FILE)
            if os.path.isfile(victim):
                sz = os.path.getsize(victim)
                with open(victim, 'r+b') as f:
                    f.truncate(max(1, sz // 2))
                logging.warning('elastic: MXNET_TPU_FAULT_TORN_CKPT '
                                'truncated %s', victim)
        commit_ms = (time.perf_counter() - t0) * 1e3
        profiler.add_ckpt_stats(
            snapshots=1, bytes=nbytes,
            async_overlap_ms=commit_ms if background else 0.0,
            commit_ms=commit_ms + snap_ms)
        profiler.add_delta_stats(
            committed=1, bytes=meta['bytes'],
            full_bytes=meta['full_bytes'], chain_len=meta['seq'])
        self._prune()
        hook = self.on_commit
        if hook is not None:
            try:
                hook(delta_dir, dict(manifest))
            except Exception:
                logging.exception(
                    'elastic: on_commit hook failed for %s '
                    '(training continues)', delta_dir)

    def _prune(self):
        """Retention, chain-aware: keep the newest `keep` COMMITS of
        either kind, then close over chains — a kept (or fleet-pinned,
        or live-chain) delta pins its base and every chain
        predecessor, so replaying any survivor always works.  The old
        rule counted only full `step-*` dirs, which let a base slide
        out of the window while deltas chained on it were still
        retained — every one of them silently unloadable."""
        fulls = list_checkpoints(self.directory)
        deltas = list_deltas(self.directory)
        commits = sorted([(s, 'full') for s in fulls]
                         + [(s, 'delta') for s in deltas],
                         reverse=True)
        keep_steps = {s for s, _k in commits[:self.keep]}
        if self.retain_refs is not None:
            # steps the fleet still references (queued / in-flight
            # pushes — the PR 14 rule).  Contained: if we can't tell
            # what's pinned, deleting anything is the wrong call
            try:
                keep_steps.update(int(s) for s in self.retain_refs())
            except Exception:
                logging.exception('elastic: retain_refs failed — '
                                  'skipping this prune')
                return
        if self._chain is not None:
            # the writer's LIVE chain: its base and members must
            # survive even when newer commits push them out of the
            # window (the next delta still extends this chain)
            keep_steps.add(self._chain['base_step'])
            keep_steps.update(self._chain['chain'])
        delta_set = set(deltas)
        for s in list(keep_steps):
            if s not in delta_set:
                continue
            try:
                dm = _read_manifest(os.path.join(
                    self.directory, _DELTA_DIR % s)).get('delta') or {}
            except MXNetError:
                continue
            if dm.get('base_step') is not None:
                keep_steps.add(int(dm['base_step']))
            keep_steps.update(int(c) for c in dm.get('chain') or [])
        doomed = [os.path.join(self.directory, _STEP_DIR % s)
                  for s in fulls if s not in keep_steps]
        doomed += [os.path.join(self.directory, _DELTA_DIR % s)
                   for s in deltas if s not in keep_steps]
        # orphans: dirs a SIGKILL left without a manifest (shard
        # files and atomic_file temps committed, commit point never
        # reached).  They can never become valid, and a resumed run's
        # step numbers may never realign to overwrite them — so any
        # manifest-less dir OLDER than the newest real commit is
        # garbage (newer ones might be a write in flight; left alone)
        newest = commits[0][0] if commits else None
        valid = set(fulls)
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for n in names:
            if n.startswith('step-'):
                base, known = n[5:], valid
            elif n.startswith('delta-'):
                base, known = n[6:], delta_set
            else:
                continue
            try:
                s = int(base)
            except ValueError:
                continue
            if s not in known and newest is not None and s < newest:
                doomed.append(os.path.join(self.directory, n))
        for d in doomed:
            try:
                for n in os.listdir(d):
                    os.unlink(os.path.join(d, n))
                os.rmdir(d)
            except OSError as e:
                logging.warning('elastic: retention prune of %s '
                                'failed: %s', d, e)

    def wait(self, timeout=None):
        """Block until pending async writes are committed (deadline
        default).  Returns True when drained, False on timeout."""
        timeout = self.deadline if timeout is None else timeout
        ok = self._idle.wait(timeout)
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            logging.warning('elastic: previous async write failed: %s',
                            err)
        return ok

    def close(self, timeout=None):
        """Drain and stop the writer thread (idempotent).  timeout
        bounds the drain + join (default: the manager deadline)."""
        timeout = self.deadline if timeout is None else timeout
        self.wait(timeout)
        if self._writer is not None and self._writer.is_alive():
            self._queue.put(None)
            self._writer.join(timeout=timeout)
        self._writer = None
        self.uninstall_signal_handlers()

    def __del__(self):
        try:
            # bounded: interpreter exit must not stall for the full
            # deadline behind a pending write (daemon writers are
            # frozen at finalization anyway — an un-close()d manager's
            # in-flight checkpoint is already best-effort)
            self.close(timeout=2.0)
        except Exception:
            pass

    # -- resume ------------------------------------------------------------
    def resumable(self):
        """True when the directory holds at least one checkpoint —
        full or delta (its integrity is only established by
        restore())."""
        return bool(list_checkpoints(self.directory)
                    or list_deltas(self.directory))

    def restore(self, target=None, metric=None):
        """Restore the newest INTACT checkpoint into the target
        (params, aux, optimizer state — re-sharded for the target's
        mode — RNG key, metric accumulation) and return its
        ResumeInfo.  Returns None when no intact checkpoint exists.
        The target must be bound / initialized (Module: bind +
        init_params + init_optimizer first)."""
        from . import profiler
        t = self._require_target(target)
        asm_box = {}

        def _validate(manifest, arrays):
            # assemble the optimizer state BEFORE mutating the
            # target: a live-only final checkpoint can list (and
            # checksum-validate) only the surviving ranks' files
            # while a dead rank's UNIQUE ZeRO shards are gone —
            # bucket-coverage validation must make such a checkpoint
            # fall back to an older complete one, not crash the
            # resume after params were overwritten
            asm_box['asm'] = _assemble_optimizer(
                manifest.get('opt', {}), arrays)

        loaded = load_newest_intact(self.directory, validate=_validate)
        if loaded is None:
            return None
        manifest, arrays, ckpt_dir = loaded
        _restore_params(t, arrays)
        _apply_optimizer(t, asm_box['asm'])
        _restore_rng(t, arrays)
        if metric is not None:
            _restore_metric(metric, manifest.get('metric'))
        info = ResumeInfo(manifest, ckpt_dir)
        self._step = info.step
        self._last_save_step = info.step
        self._last_save_time = time.monotonic()
        self._resumed = info
        # the restored state is not the writer's chain state — the
        # first post-resume commit starts a fresh full base
        self._chain = None
        self._commit_seq = 0
        profiler.add_ckpt_stats(restores=1)
        logging.info('elastic: resumed from %s (%r)', ckpt_dir, info)
        return info


# ---------------------------------------------------------------------------
# LrBackoff — canary verdicts as a training signal
# ---------------------------------------------------------------------------

class LrBackoff(object):
    """Turn canary rollbacks into a LEARNING-RATE signal instead of a
    stop: installed as `CheckpointManager.on_verdict`, it cuts the
    optimizer's learning rate by `factor` every time the push
    channel's consecutive-rollback streak reaches a multiple of
    `after` — a run whose recent steps keep failing canary judgment is
    probably stepping too hard, and backing off is cheaper than
    killing it.  The presence of an on_verdict hook also disarms the
    pusher's RollbackStop (the hook owns the response).

        mgr = CheckpointManager(dir, incremental=4)
        elastic.LrBackoff(mgr, factor=0.5, after=3)
        fleet_supervisor.CheckpointPusher(sup, 'm', sym).attach(mgr)

    Works against whatever optimizer the attached target carries:
    cuts `lr_scheduler.base_lr` when a scheduler drives the lr (the
    scheduler's own shape is preserved — only its baseline drops),
    else the optimizer's flat `lr`.  Never below `min_lr`."""

    def __init__(self, manager, factor=0.5, after=3, min_lr=0.0):
        self.manager = manager
        self.factor = float(factor)
        self.after = max(1, int(after))
        self.min_lr = float(min_lr)
        self.backoffs = 0
        manager.on_verdict = self

    def _optimizer(self):
        t = self.manager._target
        if t is None:
            return None
        try:
            fu, per_key = _updater_of(t)
        except Exception:
            return None
        for u in (fu, per_key):
            if u is not None and \
                    getattr(u, 'optimizer', None) is not None:
                return u.optimizer
        return None

    def __call__(self, verdict, consecutive_rollbacks=0):
        n = int(consecutive_rollbacks)
        if n < self.after or n % self.after != 0:
            return
        opt = self._optimizer()
        if opt is None:
            logging.warning('elastic: lr backoff due (%d consecutive '
                            'rollbacks) but no optimizer is reachable '
                            'from the attached target', n)
            return
        sched = getattr(opt, 'lr_scheduler', None)
        if sched is not None and hasattr(sched, 'base_lr'):
            new = max(self.min_lr, float(sched.base_lr) * self.factor)
            sched.base_lr = new
        else:
            new = max(self.min_lr, float(opt.lr) * self.factor)
            opt.lr = new
        self.backoffs += 1
        from . import profiler
        profiler.add_loop_stats(lr_backoffs=1)
        logging.warning('elastic: canary lr backoff #%d (%d '
                        'consecutive rollbacks): lr -> %g',
                        self.backoffs, n, new)


# ---------------------------------------------------------------------------
# Data-pipeline fast-forward (the PR-3 consumed-sample watermark)
# ---------------------------------------------------------------------------

def fast_forward(data_iter, epochs=0, batches=0, batch_size=None):
    """Advance a data iterator to the resume point: `epochs` completed
    epochs (reset() per epoch, so epoch-seeded augmentation streams
    and shuffles line up with an uninterrupted run) then `batches`
    consumed batches of the current epoch.  Iterators exposing the
    positional consumed-sample watermark (ImageIter's parallel
    pipeline) jump straight to the position without re-decoding; any
    other DataIter is drained batch-by-batch — identical samples
    either way (per-sample seeded streams / deterministic order).
    Returns the number of batches skipped."""
    for _ in range(int(epochs)):
        data_iter.reset()
    batches = int(batches)
    if batches <= 0:
        return 0
    seq = getattr(data_iter, 'seq', None)
    parallel = getattr(data_iter, '_parallel', None)
    if seq is not None and batch_size and \
            hasattr(data_iter, '_next_pos') and \
            hasattr(data_iter, 'cur') and \
            parallel is not None and parallel():
        # positional jump — PARALLEL pipeline only: its augmentation
        # streams are per-sample seeded (position-addressable), so
        # skipping re-decodes nothing and changes nothing.  The
        # sequential path draws from the process-global RNG, which
        # only a real drain replays — it falls through below.
        # (Same watermark-based restart ImageIter uses for pool
        # restarts: close/_discard_inflight.)
        pos = min(int(batches) * int(batch_size), len(seq))
        data_iter.cur = pos
        data_iter._next_pos = pos
        data_iter._discard_inflight()
        return batches
    skipped = 0
    for _ in range(batches):
        try:
            next(data_iter)
        except StopIteration:
            break
        skipped += 1
    return skipped


def resume(manager, target, data_iter=None, metric=None,
           batch_size=None):
    """One-call preemption recovery: restore the newest intact
    checkpoint into `target` via `manager` and fast-forward
    `data_iter` to the consumed-sample watermark so the continuation
    is bit-identical to the uninterrupted run.  Returns the
    ResumeInfo (None = nothing to resume; training starts fresh)."""
    info = manager.attach(target).restore(metric=metric)
    if info is None:
        return None
    if data_iter is not None:
        bs = batch_size or info.manifest.get('batch_size') or \
            getattr(data_iter, 'batch_size', 0)
        fast_forward(data_iter, epochs=info.epoch,
                     batches=info.batches_in_epoch, batch_size=bs)
    return info
