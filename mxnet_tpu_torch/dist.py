"""The distributed runtime: coordinator bootstrap, health-checked
barriers, the host-level allreduce and the coordinated elastic restart;
the counterpart of mxnet_tpu/dist.py (reference ps-lite tracker stack).

- Bootstrap: `dist.initialize()` reads the DMLC_* env contract that
  `mxnet_tpu_torch.tools.launch` exports (DMLC_PS_ROOT_URI,
  MXNET_TPU_DIST_PORT, DMLC_WORKER_ID, DMLC_NUM_WORKER). Rank 0 hosts
  the coordinator; every rank connects with retry and backoff under
  the MXNET_TPU_DIST_INIT_TIMEOUT_S deadline, and a missing rank is
  named, never waited on forever.
- Health: a heartbeat thread per process (MXNET_TPU_DIST_HEARTBEAT_S)
  feeds the coordinator's liveness table; a rank silent longer than
  MXNET_TPU_DIST_DEAD_AFTER_S is dead, and every survivor learns it on
  its next heartbeat. Barriers carry a timeout
  (MXNET_TPU_BARRIER_TIMEOUT_S) whose error names the absent ranks.
- Coordinated elastic restart: a CheckpointManager registered with
  `runtime.watch(mgr)` (Module.fit does it) is preempted when a rank
  dies; the next step boundary commits a final checkpoint and raises
  `elastic.Preempted`, the process exits PREEMPTED_EXIT, and
  `tools.launch --elastic` relaunches at the same or a smaller world.
- Data parallelism: the KVStore `dist_sync` facade sums each step's
  gradients across the worker processes through `dist.allreduce`, on
  the 'star' (through the coordinator, in rank order) or the 'ring'
  (peer-to-peer chunked reduce-scatter and all-gather, in a fixed
  rotation order; MXNET_TPU_DIST_TOPOLOGY), optionally on a compressed
  int8 or bf16 wire with error feedback (MXNET_TPU_DIST_WIRE_DTYPE,
  `quantization.WireCodec`). `allreduce_async` overlaps a round with
  the caller; `allreduce_coo` sums sparse (ids, rows) pairs. A worker of
  several ranks (`tools.launch --ranks-per-worker`,
  parallel/worker_group.py) is one rank of the runtime: its leader takes
  part, and the others get each result from it (`_WorkerRuntime`).

Everything rides host sockets with the kvstore_server framing, whose
frames equal the JAX package's, so results are bit for bit the JAX
runtime's for the same inputs. Arrays are host arrays (`_hostarray`):
numpy, and torch CPU tensors for bfloat16, whose sums round as
ml_dtypes' do. With MXNET_TPU_DIST_JAX=1 (the JAX package's
jax.distributed mode) `initialize` also brings up one torch.distributed
process group across the workers, from the same variables at port + 1
(MXNET_TPU_DIST_JAX_ADDR overrides the address): a Module over the
workers' contexts is then one data mesh whose gradients meet in the
step's collectives (module/executor_group.py), and `host_span_active`
is False, so no host allreduce runs on the way. A rank's device is
cuda:LOCAL_RANK % device_count, or MXNET_TPU_DIST_DEVICE ('cpu' on the
CPU).

Fault injection: MXNET_TPU_FAULT_HEARTBEAT_DROP suppresses a rank's
heartbeats without killing it; MXNET_TPU_FAULT_BARRIER_STALL_S and
MXNET_TPU_FAULT_RING_STALL_S make a rank arrive late;
MXNET_TPU_FAULT_KILL_RANK gates KILL_AT_STEP to one rank. Counters:
profiler.dist_stats().
"""
import logging
import os
import socket
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from . import _hostarray as ha
from .base import MXNetError
from .kvstore_server import _recv_msg, _send_msg, _tune_sock_bufs

# bound on live wire-codec streams per endpoint: each stream pins
# gradient-sized float32 error-feedback residuals, and a long-lived
# process whose allreduce signatures change over time (incremental
# key registration, rebinds) must not leak every stale stream's
# buffers forever — LRU-evicted past the cap (an evicted stream just
# restarts its error feedback, nothing corrupts)
_WIRE_CODEC_CAP = 32


def _wire_codec(cache, key, wire):
    """Fetch-or-create the LRU-bounded WireCodec for one stream
    (caller holds the lock guarding `cache`)."""
    from .quantization import WireCodec
    codec = cache.get(key)
    if codec is None:
        codec = cache[key] = WireCodec(wire)
    cache.move_to_end(key)
    while len(cache) > _WIRE_CODEC_CAP:
        cache.popitem(last=False)
    return codec

# exit code a preempted worker should use so a supervising
# tools/launch.py --elastic treats it as restartable (EX_TEMPFAIL)
PREEMPTED_EXIT = 75


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------

def _env_float(name, default):
    v = os.environ.get(name, '').strip()
    if not v:
        return float(default)
    try:
        return float(v)
    except ValueError:
        logging.warning('dist: ignoring non-numeric %s=%r', name, v)
        return float(default)


def init_timeout_s():
    """Hard deadline for bootstrap (connect retry + startup barrier)."""
    return _env_float('MXNET_TPU_DIST_INIT_TIMEOUT_S', 60.0)


def barrier_timeout_s():
    """Default barrier deadline: a rank that has not arrived by then
    is named in the MXNetError instead of hanging the job."""
    return _env_float('MXNET_TPU_BARRIER_TIMEOUT_S', 60.0)


def heartbeat_interval_s():
    return _env_float('MXNET_TPU_DIST_HEARTBEAT_S', 1.0)


def dead_after_s():
    """Silence threshold before a rank is declared dead (default 5
    heartbeat intervals)."""
    return _env_float('MXNET_TPU_DIST_DEAD_AFTER_S',
                      5.0 * heartbeat_interval_s())


def topology_from_env(explicit=None):
    """Resolve the cross-host allreduce topology: an explicit API
    value wins, else MXNET_TPU_DIST_TOPOLOGY, else 'star'.  'star' is
    the coordinator-mediated sum (rank-order, one ingress point);
    'ring' is the peer-to-peer chunked reduce-scatter + all-gather
    (fixed rotation order, ~2 × bytes/world per host).  Every rank
    must resolve the same value — the ring hop protocol checks and
    names a mismatch instead of desyncing."""
    v = explicit if explicit is not None else \
        os.environ.get('MXNET_TPU_DIST_TOPOLOGY', '')
    v = str(v).strip().lower()
    if v in ('', 'star', 'coordinator'):
        return 'star'
    if v == 'ring':
        return 'ring'
    raise MXNetError("dist topology must be 'star' or 'ring', got %r "
                     '(MXNET_TPU_DIST_TOPOLOGY)' % (v,))


def overlap_active():
    """True when MXNET_TPU_DIST_OVERLAP=1: the KVStore dist_sync path
    launches each key's cross-process reduction asynchronously as soon
    as its local merge lands (allreduce_async) and waits per key at
    the optimizer boundary, instead of one blocking batched round."""
    return os.environ.get('MXNET_TPU_DIST_OVERLAP', '').strip() in \
        ('1', 'true')


def _merge_coo(ids_list, rows_list):
    """Deterministically merge COO (ids, rows) contributions: rows of
    duplicate ids are summed in the ORDER GIVEN (stable sort +
    sequential reduceat — no atomics, no arrival-order dependence), so
    callers that fix the list order (rank order on star, rotation
    order on ring) get bitwise-reproducible sums.  Returns
    (sorted unique int64 ids, float rows) with zero-size handled."""
    ids = np.concatenate([np.asarray(i, np.int64).ravel()
                          for i in ids_list]) if ids_list else \
        np.zeros(0, np.int64)
    rows = np.concatenate([ha.host(r) for r in rows_list], axis=0) \
        if rows_list else np.zeros((0, 0), np.float32)
    if ids.size == 0:
        return ids, rows
    order = np.argsort(ids, kind='stable')
    ids, rows = ids[order], rows[order]
    uids, starts = np.unique(ids, return_index=True)
    out = np.add.reduceat(rows, starts, axis=0)
    return uids, out.astype(rows.dtype, copy=False)


def _f32_in(a):
    """A host array as the float32 numpy a WireCodec takes (exact for
    bfloat16; numpy arrays pass as they are)."""
    return ha.to_float32(a) if ha.is_torch(a) else a


def _cast_like(v, like):
    """A decoded float32 numpy array back in `like`'s dtype and kind."""
    return ha.from_float32(v, like) if ha.is_torch(like) else \
        np.asarray(v).astype(like.dtype, copy=False)


def _wire_out(payloads, wire):
    """Codec payloads as they go on the wire: a bf16 wire's uint16 bits
    as bfloat16 arrays, the JAX package's frame."""
    if wire != 'bf16':
        return list(payloads)
    return [ha.from_bits(p, 'bfloat16')
            if isinstance(p, np.ndarray) and p.dtype == np.uint16 else p
            for p in payloads]


def _wire_in(payloads):
    """Wire payloads as the codec decodes them (bfloat16 as its bits)."""
    return [ha.bits(p) for p in payloads]


def _cat(parts):
    return torch.cat(parts) if ha.is_torch(parts[0]) else \
        np.concatenate(parts)


def _kind_f(name):
    """A group the ring's compressed wires quantize: numpy's float kinds.
    bfloat16 rides the ring raw, as in the JAX package (whose ml_dtypes
    bfloat16 has numpy kind 'V'); the star compresses it."""
    return name not in ha.TORCH_ONLY and np.dtype(name).kind == 'f'


# ---------------------------------------------------------------------------
# coordinator (the collapsed scheduler/tracker role)
# ---------------------------------------------------------------------------

class Coordinator(object):
    """Rank-0-hosted control-plane service: liveness table, named
    barriers with deadlines, and the host-level allreduce.  One
    handler thread per connection; all state under one condition
    variable.  Gradients pass through it only on the star topology."""

    def __init__(self, port=0, world=1, bind_addr=None,
                 dead_after=None):
        from .kvstore_server import KVStoreServer
        self.world = int(world)
        self.dead_after = dead_after_s() if dead_after is None \
            else float(dead_after)
        self._cv = threading.Condition()
        self._last_seen = {}          # rank -> time.monotonic()
        self._last_scan = None        # time.monotonic() of the last scan
        self._registered = set()
        self._departed = set()        # clean byes (not deaths)
        self._dead = set()            # sticky
        self._barriers = {}           # name -> {'gen': int, 'arrived': set}
        self._reduces = {}            # (name, round) -> round state
        # downstream wire codecs: one per compressed-allreduce stream,
        # carrying the RESULT quantization's error-feedback residual
        # (the rank-side codecs carry the contribution residuals) —
        # only ever touched by a round's single summer, which rounds
        # of one stream serialize (ranks block fetching round n before
        # contributing n+1).  LRU-bounded (_WIRE_CODEC_CAP).
        self._wire_codecs = OrderedDict()
        # ring rendezvous table: rank -> (host, port) of that rank's
        # peer-to-peer ring listener.  The HOST is the source address
        # of the rank's control connection — the address peers can
        # actually reach it at (a rank cannot reliably know its own
        # externally-visible address behind NAT/multi-homed hosts).
        self._ring_addrs = {}
        self._stopped = False
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if bind_addr is None:
            bind_addr = os.environ.get(
                'DMLC_PS_BIND_URI',
                os.environ.get('DMLC_PS_ROOT_URI', '127.0.0.1'))
        # same trust boundary as the PS servers: a non-loopback bind
        # without a real DMLC_PS_TOKEN refuses to start (the derived
        # frame key authenticates nothing off-host)
        KVStoreServer._check_bind_policy(bind_addr)
        try:
            self.listener.bind((bind_addr, port))
        except OSError as e:
            import errno
            if e.errno != errno.EADDRNOTAVAIL and \
                    not isinstance(e, socket.gaierror):
                raise
            # rank 0 on a different host than the advertised rendezvous
            # address: fall back to all interfaces (token required)
            KVStoreServer._check_bind_policy('')
            self.listener.bind(('', port))
        self.listener.listen(4 * self.world + 8)
        self.port = self.listener.getsockname()[1]
        self._accept_thread = None

    # -- liveness ----------------------------------------------------------
    def _scan_dead_locked(self):
        """Mark registered ranks silent past the threshold dead.
        Called under self._cv from every handler that cares — the
        clients' heartbeat cadence is the clock, no timer thread.

        Scans come at least once a heartbeat interval while any rank
        lives (rank 0, whose process hosts this, heartbeats too). A gap between two scans of over half the threshold means this
        process was not running its handlers (its GIL held by a long
        call, its host starved of CPU): the heartbeats of that gap wait
        unread in the sockets, so the gap is counted as no rank's
        silence."""
        now = time.monotonic()
        last, self._last_scan = self._last_scan, now
        if last is not None and now - last > 0.5 * self.dead_after:
            gap = now - last
            logging.warning('dist coordinator: no handler ran for %.1fs; '
                            'that gap counts as no rank\'s silence', gap)
            for r, t in self._last_seen.items():
                self._last_seen[r] = min(now, t + gap)
        newly = [r for r, t in self._last_seen.items()
                 if r not in self._departed and r not in self._dead and
                 now - t > self.dead_after]
        if newly:
            self._dead.update(newly)
            logging.warning('dist coordinator: rank(s) %s declared dead '
                            '(no heartbeat for > %.1fs)', sorted(newly),
                            self.dead_after)
            self._cv.notify_all()

    def _members_locked(self, live_only):
        """Ranks a barrier/allreduce must hear from."""
        members = set(range(self.world)) - self._departed
        if live_only:
            members -= self._dead
        return members

    # -- handlers ----------------------------------------------------------
    def _handle_hello(self, rank):
        rank = int(rank)
        if not 0 <= rank < self.world:
            return ('err', 'rank %d outside world size %d'
                           % (rank, self.world))
        with self._cv:
            self._registered.add(rank)
            self._departed.discard(rank)
            self._last_seen[rank] = time.monotonic()
            self._cv.notify_all()
        return ('ok', self.world)

    def _handle_heartbeat(self, rank):
        with self._cv:
            self._last_seen[int(rank)] = time.monotonic()
            self._scan_dead_locked()
            return ('ok', sorted(self._dead))

    def _handle_dead(self):
        with self._cv:
            self._scan_dead_locked()
            return ('ok', sorted(self._dead))

    def _handle_bye(self, rank):
        with self._cv:
            self._departed.add(int(rank))
            self._cv.notify_all()
        return ('ok',)

    def _handle_barrier(self, name, rank, timeout, live_only):
        """Health-checked barrier: completes when every member rank
        has arrived for the current generation; FAILS (instead of
        hanging) when a member is dead (live_only=False) or the
        deadline passes — the error names the offending ranks."""
        rank = int(rank)
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            ent = self._barriers.setdefault(
                str(name), {'gen': 0, 'arrived': set()})
            gen = ent['gen']
            ent['arrived'].add(rank)
            self._last_seen[rank] = time.monotonic()
            self._cv.notify_all()
            while True:
                self._scan_dead_locked()
                if ent['gen'] != gen:
                    return ('ok',)          # released by another arriver
                members = self._members_locked(live_only)
                if not live_only:
                    dead_members = sorted(self._dead & members)
                    if dead_members:
                        return ('err',
                                'barrier %r failed: rank(s) %s are dead '
                                '(no heartbeat for > %.1fs) — recover '
                                'via coordinated elastic restart'
                                % (name, dead_members, self.dead_after))
                if ent['arrived'] >= members:
                    ent['gen'] += 1
                    ent['arrived'] = set()
                    self._cv.notify_all()
                    return ('ok',)
                now = time.monotonic()
                if now >= deadline:
                    absent = sorted(members - ent['arrived'])
                    return ('err',
                            'barrier %r timed out after %.1fs: rank(s) '
                            '%s never arrived (%d of %d present).  Set '
                            'MXNET_TPU_BARRIER_TIMEOUT_S to wait '
                            'longer.' % (name, float(timeout), absent,
                                         len(ent['arrived']),
                                         len(members)))
                self._cv.wait(min(0.2, deadline - now))

    def _handle_ring_addr(self, rank, port, host):
        """Register one rank's ring listener endpoint (re-registration
        overwrites — a rebuilt link may land on a new ephemeral
        port)."""
        rank = int(rank)
        with self._cv:
            self._ring_addrs[rank] = (str(host), int(port))
            self._last_seen[rank] = time.monotonic()
            self._cv.notify_all()
        return ('ok',)

    def _handle_ring_peers(self, timeout):
        """Block until EVERY member rank has registered a ring
        listener, then return the full (rank, host, port) table.  A
        ring cannot form around a hole, so this fails fast naming dead
        or absent ranks instead of hanging."""
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            while True:
                self._scan_dead_locked()
                members = self._members_locked(live_only=False)
                dead = sorted(self._dead & members)
                if dead:
                    return ('err',
                            'ring setup failed: rank(s) %s are dead '
                            '(no heartbeat for > %.1fs) — recover via '
                            'coordinated elastic restart'
                            % (dead, self.dead_after))
                if members <= set(self._ring_addrs):
                    return ('ok', sorted(
                        (r, h, p)
                        for r, (h, p) in self._ring_addrs.items()
                        if r in members))
                now = time.monotonic()
                if now >= deadline:
                    absent = sorted(members - set(self._ring_addrs))
                    return ('err',
                            'ring setup timed out after %.1fs: rank(s)'
                            ' %s never registered a ring listener — '
                            'are they running with '
                            'MXNET_TPU_DIST_TOPOLOGY=ring too?'
                            % (float(timeout), absent))
                self._cv.wait(min(0.2, deadline - now))

    def _handle_allreduce(self, name, rnd, rank, values, timeout,
                          wire='fp32', scales=None, kind='dense'):
        """Host-level sum over live ranks: each rank contributes a
        tuple of arrays for (name, round); the last contributor sums
        (deterministic rank order — every rank receives IDENTICAL
        bytes) and all waiters are released with the result.  A rank
        dying mid-round fails the round with an actionable error.

        Compressed rounds (`wire` 'int8'/'bf16'; docs/DIST.md wire
        format): contributions arrive as codes + per-bucket scales,
        are dequantized and summed in float32 (still rank order), and
        the RESULT is re-quantized through a per-stream coordinator
        codec whose error-feedback residual carries the downstream
        quantization error into the next round — every rank receives
        the identical compressed bytes, so per-mode determinism
        holds."""
        rank = int(rank)
        key = (str(name), int(rnd), str(kind))
        deadline = time.monotonic() + float(timeout)
        wire = str(wire or 'fp32')
        values = tuple(ha.contiguous(v) for v in values)
        with self._cv:
            ent = self._reduces.setdefault(
                key, {'parts': {}, 'result': None, 'error': None,
                      'summing': False, 'fetched': set(),
                      'wire': wire})
            if ent['wire'] != wire:
                # fail the WHOLE round, not just this rank: peers
                # that already contributed wake and get the
                # actionable error now, and the entry stays as a
                # TOMBSTONE (parts freed, error set) so ranks
                # arriving even later fail fast with the real cause
                # instead of timing out on a fresh entry that can
                # never complete.  Tombstones are tiny; prune old
                # ones if a retry loop accumulates them.
                msg = ('allreduce %r: rank %d sent wire dtype %r but '
                       'the round opened with %r — every rank must '
                       'resolve the same MXNET_TPU_DIST_WIRE_DTYPE'
                       % (name, rank, wire, ent['wire']))
                ent['error'] = msg
                ent['parts'] = {}
                if len(self._reduces) > 256:
                    stale = [k for k, e in self._reduces.items()
                             if e.get('error') and k != key][:128]
                    for k in stale:
                        self._reduces.pop(k, None)
                self._cv.notify_all()
                return ('err', msg)
            ent['parts'][rank] = (values, scales)
            self._last_seen[rank] = time.monotonic()
            self._cv.notify_all()
            while ent['result'] is None:
                if ent['error'] is not None:
                    ent['parts'] = {}   # dead round: free any arrays
                    return ('err', ent['error'])
                self._scan_dead_locked()
                members = self._members_locked(live_only=False)
                dead_members = sorted(self._dead & members)
                if dead_members:
                    self._reduces.pop(key, None)
                    return ('err',
                            'allreduce %r failed: rank(s) %s died '
                            'mid-round — recover via coordinated '
                            'elastic restart' % (name, dead_members))
                if set(ent['parts']) >= members and \
                        not ent['summing']:
                    # this handler computes the sum OUTSIDE the lock:
                    # a multi-MB accumulation must not block the
                    # heartbeat handlers behind the condition variable
                    # (live ranks would be falsely declared dead).
                    # RANK order, not arrival order — every run sums
                    # identically, so restart parity stays bitwise.
                    ent['summing'] = True
                    ent['members'] = set(ent['parts'])
                    parts = ent['parts']
                    self._cv.release()
                    err = result = None
                    try:
                        result = self._sum_parts(name, wire, parts,
                                                 kind)
                    except Exception as e:   # mismatched shapes etc.
                        err = ('allreduce %r failed to sum: %s'
                               % (name, e))
                    finally:
                        self._cv.acquire()
                    if err is not None:
                        ent['error'] = err
                        self._cv.notify_all()
                        return ('err', err)
                    ent['result'] = result
                    ent['parts'] = {}    # free the per-rank copies
                    self._cv.notify_all()
                    break
                now = time.monotonic()
                if now >= deadline:
                    absent = sorted(members - set(ent['parts']))
                    return ('err',
                            'allreduce %r timed out after %.1fs: '
                            'rank(s) %s never contributed'
                            % (name, float(timeout), absent))
                self._cv.wait(min(0.2, deadline - now))
            result = ent['result']
            ent['fetched'].add(rank)
            if ent['fetched'] >= ent['members']:
                self._reduces.pop(key, None)
            return ('ok', result)

    def _sum_parts(self, name, wire, parts, kind='dense'):
        """Rank-order sum of one round's contributions (runs OUTSIDE
        the condition variable — see the summing block).  fp32 rounds
        sum raw arrays; compressed rounds dequantize each rank's
        codes first, sum in float32, and re-quantize the result
        through the stream's coordinator-side error-feedback codec.
        COO rounds ('allreduce_coo') merge each rank's (uids, rows)
        pair in rank order via _merge_coo — still one deterministic
        byte stream every rank fetches."""
        ranks = sorted(parts)
        if kind == 'coo':
            return _merge_coo([parts[r][0][0] for r in ranks],
                              [parts[r][0][1] for r in ranks])
        if wire == 'fp32':
            sums = []
            for i in range(len(parts[ranks[0]][0])):
                acc = ha.copy(parts[ranks[0]][0][i])
                for r in ranks[1:]:
                    acc += parts[r][0][i]
                sums.append(acc)
            return tuple(sums)
        from .quantization import WireCodec
        dec = WireCodec(wire, error_feedback=False)
        n = len(parts[ranks[0]][0])
        dtypes = [np.float32] * n
        sums = None
        for r in ranks:
            vals, scs = parts[r]
            d = dec.decode(_wire_in(vals), scs, dtypes)
            if sums is None:
                sums = d
            else:
                for i in range(n):
                    sums[i] = sums[i] + d[i]
        ckey = (str(name), wire,
                tuple(tuple(s.shape) for s in sums))
        with self._cv:      # dict access only; encode stays outside
            codec = _wire_codec(self._wire_codecs, ckey, wire)
        payloads, out_scales = codec.encode(sums)
        return (tuple(_wire_out(payloads, wire)), out_scales)

    # -- connection loop ---------------------------------------------------
    def _serve_conn(self, conn):
        try:
            peer_host = conn.getpeername()[0]
        except OSError:
            peer_host = '127.0.0.1'
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == 'hello':
                    reply = self._handle_hello(msg[1])
                elif op == 'heartbeat':
                    reply = self._handle_heartbeat(msg[1])
                elif op == 'dead':
                    reply = self._handle_dead()
                elif op == 'barrier':
                    reply = self._handle_barrier(msg[1], msg[2], msg[3],
                                                 bool(msg[4]))
                elif op == 'allreduce':
                    # 6-field frames are legacy fp32 rounds; 8-field
                    # frames carry (wire, scales) for compressed ones
                    reply = self._handle_allreduce(msg[1], msg[2],
                                                   msg[3], msg[4],
                                                   msg[5], *msg[6:8])
                elif op == 'allreduce_coo':
                    reply = self._handle_allreduce(
                        msg[1], msg[2], msg[3], (msg[4], msg[5]),
                        msg[6], kind='coo')
                elif op == 'ring_addr':
                    reply = self._handle_ring_addr(msg[1], msg[2],
                                                   peer_host)
                elif op == 'ring_peers':
                    reply = self._handle_ring_peers(msg[1])
                elif op == 'bye':
                    reply = self._handle_bye(msg[1])
                elif op == 'stop':
                    with self._cv:
                        self._stopped = True
                        self._cv.notify_all()
                    _send_msg(conn, ('ok',))
                    break
                else:
                    reply = ('err', 'unknown dist op %r' % (op,))
                _send_msg(conn, reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def start(self):
        """Begin accepting connections (daemon accept thread)."""
        if self._accept_thread is not None:
            return self
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='dist-coordinator',
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        self.listener.settimeout(0.2)
        while True:
            with self._cv:
                if self._stopped:
                    break
            try:
                conn, _ = self.listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _tune_sock_bufs(conn)
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        try:
            self.listener.close()
        except OSError:
            pass

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        try:
            self.listener.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# ring transport (peer-to-peer links; coordinator does rendezvous only)
# ---------------------------------------------------------------------------

class _RingLink(object):
    """One rank's peer-to-peer ring transport: a listener its LEFT
    neighbor ((rank-1) % world) dials, and an outbound connection to
    its RIGHT neighbor ((rank+1) % world).  Endpoints rendezvous
    through the coordinator ('ring_addr'/'ring_peers'); frames ride
    the kvstore_server codec (length-prefixed, HMAC-tagged), so the
    DMLC_PS_TOKEN trust boundary is unchanged.  The listener port
    comes from the tools/launch.py contract
    (MXNET_TPU_DIST_RING_PORT + rank) when exported, else ephemeral
    (fine single-host; the rendezvous carries whatever was bound)."""

    def __init__(self, rt, deadline):
        from .kvstore_server import KVStoreServer
        self.rank = rt.rank
        self.world = rt.world
        self.left_rank = (rt.rank - 1) % rt.world
        self.right_rank = (rt.rank + 1) % rt.world
        self.left = self.right = None
        base = os.environ.get('MXNET_TPU_DIST_RING_PORT', '').strip()
        port = (int(base) + rt.rank) if base else 0
        # the listener lives on THIS host (unlike the coordinator's
        # advertised root address): loopback when the whole job is
        # loopback, else all interfaces — which demands a real token
        bind_addr = os.environ.get('DMLC_PS_BIND_URI', '').strip()
        if not bind_addr and rt.address in ('127.0.0.1', 'localhost'):
            bind_addr = '127.0.0.1'
        KVStoreServer._check_bind_policy(bind_addr)
        self.listener = socket.socket(socket.AF_INET,
                                      socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((bind_addr, port))
            self.listener.listen(4)
            self.port = self.listener.getsockname()[1]
            self._rendezvous(rt, deadline)
        except MXNetError:
            self.close()
            raise
        except OSError as e:
            self.close()
            raise MXNetError(
                'ring setup: rank %d could not bind its ring listener '
                '(port %s): %s — tools/launch.py probes and exports '
                'MXNET_TPU_DIST_RING_PORT precisely to avoid this'
                % (rt.rank, port or 'ephemeral', e))

    def _rendezvous(self, rt, deadline):
        """Register our listener, fetch the full table, then
        concurrently accept-left and connect-right (every rank does
        both at once — sequencing would deadlock the cycle)."""
        rt._rpc('ring_addr', self.rank, self.port)
        budget = max(1.0, deadline - time.monotonic())
        peers = rt._rpc('ring_peers', budget, timeout=budget + 15.0)
        table = {int(r): (str(h), int(p)) for r, h, p in peers}
        rhost, rport = table[self.right_rank]
        box = {}

        def accept_left():
            self.listener.settimeout(0.25)
            while time.monotonic() < deadline:
                try:
                    conn, _ = self.listener.accept()
                except socket.timeout:
                    continue
                except OSError as e:
                    box['aerr'] = e
                    return
                try:
                    conn.settimeout(
                        max(1.0, deadline - time.monotonic()))
                    hello = _recv_msg(conn)
                    if hello[0] == 'ring_hello' and \
                            int(hello[1]) == self.left_rank:
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                        _tune_sock_bufs(conn)
                        conn.settimeout(None)
                        box['left'] = conn
                        return
                    conn.close()    # stray dialer: keep listening
                except (ConnectionError, OSError, ValueError,
                        MXNetError):
                    conn.close()    # bad frame/auth: keep listening
            box['aerr'] = 'timed out'

        t = threading.Thread(target=accept_left, daemon=True,
                             name='dist-ring-accept')
        t.start()
        delay, last = 0.05, None
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise MXNetError(
                    'ring setup: rank %d could not connect to right '
                    'neighbor rank %d at %s:%d (last error: %s)'
                    % (self.rank, self.right_rank, rhost, rport, last))
            try:
                s = socket.create_connection(
                    (rhost, rport), timeout=min(5.0, max(0.1, budget)))
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _tune_sock_bufs(s)
                _send_msg(s, ('ring_hello', self.rank))
                s.settimeout(None)
                self.right = s
                break
            except OSError as e:
                last = e
                time.sleep(min(delay, max(0.0, budget)))
                delay = min(1.0, delay * 2)
        t.join(max(0.1, deadline - time.monotonic()))
        left = box.get('left')
        if left is None:
            raise MXNetError(
                'ring setup: rank %d never heard from left neighbor '
                'rank %d on its ring listener (port %d): %s'
                % (self.rank, self.left_rank, self.port,
                   box.get('aerr', 'timed out')))
        self.left = left

    def close(self):
        for s in (self.left, self.right, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.left = self.right = None


class AllreduceHandle(object):
    """Ticket for one in-flight `allreduce_async` round: `wait()` at
    the optimizer boundary blocks to the result (re-raising the
    round's error there, where the caller can act on it) and records
    the wall time the round overlapped with the caller's other work
    (profiler `dist_overlap_ms`)."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._t_launch = time.perf_counter()
        self._t_done = None
        self._counted = False

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        from . import profiler
        t_wait = time.perf_counter()
        self._event.wait(timeout)
        if not self._event.is_set():
            raise MXNetError(
                'allreduce_async: round still in flight after %.1fs'
                % float(timeout))
        if not self._counted:
            self._counted = True
            # overlap = time the round ran while the caller was busy
            # elsewhere: from launch to whichever came first, the
            # round finishing or the caller showing up to wait
            profiler.add_dist_stats(overlap_ms=max(
                0.0, (min(self._t_done, t_wait) - self._t_launch))
                * 1e3)
        if self._error is not None:
            raise self._error
        return self._result


# ---------------------------------------------------------------------------
# per-process runtime (client + optional embedded coordinator)
# ---------------------------------------------------------------------------

class DistRuntime(object):
    """One process's view of the job: rank/world, the coordinator
    connections (one for control RPCs, one the heartbeat thread owns —
    a long barrier must never starve liveness), the locally-known dead
    set, and the watched CheckpointManagers to preempt on death."""

    def __init__(self, rank, world, address='127.0.0.1', port=None,
                 start_coordinator=None, timeout=None,
                 heartbeat=True, hb_interval=None, dead_after=None):
        self.rank = int(rank)
        self.world = max(1, int(world))
        self.address = address
        self.coordinator = None
        self._owns_coordinator = False
        self._closed = False
        self._hb_stop = threading.Event()
        self._hb_thread = None
        # control RPCs use one socket PER THREAD (threading.local): a
        # writer thread waiting out a checkpoint-commit barrier must
        # never stall the train thread's per-step allreduce behind a
        # shared-socket lock
        self._tls = threading.local()
        self._socks = []
        self._socks_lock = threading.Lock()
        self._known_dead = set()
        self._dead_lock = threading.Lock()
        self._watched = weakref.WeakSet()
        self._round = {}              # allreduce name -> round counter
        self._round_lock = threading.Lock()
        self._wire_codecs = OrderedDict()   # (name, wire, shapes) ->
        self._wire_lock = threading.Lock()  # codec; LRU-bounded
        # ring transport: built lazily on the first ring round, torn
        # down (and rebuilt) after any failed round — a failed hop
        # leaves the lockstep protocol at an unknown position, so the
        # link must not be reused.  _ring_lock serializes WHOLE rounds
        # (the hop sequence is stateful).
        self._ring_link = None
        self._ring_lock = threading.Lock()
        # async rounds drain through ONE FIFO worker: rounds must
        # launch in the same order on every rank (the ring's lockstep
        # hops and the star's round pairing both key off launch
        # order), which a pool would scramble
        self._async_q = None
        self._async_thread = None
        self._async_lock = threading.Lock()
        self._hb_interval = heartbeat_interval_s() if hb_interval is None \
            else float(hb_interval)
        self._dead_after = dead_after_s() if dead_after is None \
            else float(dead_after)
        timeout = init_timeout_s() if timeout is None else float(timeout)
        deadline = time.monotonic() + timeout
        if start_coordinator is None:
            start_coordinator = self.rank == 0
        if start_coordinator:
            self.coordinator = self._bind_coordinator(port, deadline)
            self._owns_coordinator = True
            port = self.coordinator.port
            self.address = '127.0.0.1'   # connect to ourselves locally
        if port is None:
            raise MXNetError('dist: no coordinator port (set '
                             'MXNET_TPU_DIST_PORT or DMLC_PS_ROOT_PORT)')
        self.port = int(port)
        self._hb_sock = None
        try:
            self._tls.sock = self._connect_retry(deadline, 'control')
            with self._socks_lock:
                self._socks.append(self._tls.sock)
            self._rpc('hello', self.rank)
            self._hb_sock = self._connect_retry(deadline, 'heartbeat')
            # startup barrier: every rank must check in before training
            # starts (the reference's worker+server+scheduler barrier
            # role).  A missing rank is NAMED within the remaining
            # init deadline.
            remaining = max(1.0, deadline - time.monotonic())
            self.barrier('__startup__', timeout=remaining)
        except BaseException:
            # failed bootstrap must not leak the embedded coordinator
            # or half-open sockets (the error is the deliverable)
            for s in self._socks + [self._hb_sock]:
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            if self._owns_coordinator and self.coordinator is not None:
                self.coordinator.stop()
            raise
        if heartbeat:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name='dist-heartbeat', daemon=True)
            self._hb_thread.start()

    # -- bootstrap ---------------------------------------------------------
    def _bind_coordinator(self, port, deadline):
        """Bind-with-retry: a just-died previous round's coordinator
        may briefly linger on the port (elastic relaunch)."""
        delay = 0.1
        while True:
            try:
                return Coordinator(port=port or 0, world=self.world,
                                   dead_after=self._dead_after).start()
            except OSError as e:
                if time.monotonic() >= deadline:
                    raise MXNetError(
                        'dist.initialize: rank 0 could not bind the '
                        'coordinator port %s: %s' % (port, e))
                time.sleep(delay)
                delay = min(2.0, delay * 2)

    def _connect_retry(self, deadline, purpose):
        """Connect with exponential backoff under the hard deadline —
        a late-starting coordinator is tolerated, a permanently absent
        one produces a clear error naming the address, never a hang."""
        delay = 0.05
        last_err = None
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise MXNetError(
                    'dist.initialize: rank %d could not reach the '
                    'coordinator at %s:%d within the '
                    'MXNET_TPU_DIST_INIT_TIMEOUT_S deadline (%s '
                    'connection; last error: %s).  Is rank 0 up?'
                    % (self.rank, self.address, self.port, purpose,
                       last_err))
            try:
                s = socket.create_connection(
                    (self.address, self.port),
                    timeout=min(5.0, max(0.1, budget)))
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _tune_sock_bufs(s)
                s.settimeout(None)
                return s
            except OSError as e:
                last_err = e
                time.sleep(min(delay, max(0.0, budget)))
                delay = min(2.0, delay * 2)

    # -- RPC plumbing ------------------------------------------------------
    def _control_sock(self):
        """This thread's control connection (created on first use —
        the coordinator serves one handler thread per connection, so
        per-thread sockets need no client-side locking)."""
        s = getattr(self._tls, 'sock', None)
        if s is None:
            s = self._connect_retry(time.monotonic() + 5.0,
                                    'control (reconnect)')
            self._tls.sock = s
            with self._socks_lock:
                self._socks.append(s)
        return s

    def _drop_sock(self, sock):
        """A timed-out or errored connection is DESYNCHRONIZED — a
        late reply would be read as the NEXT request's answer — so it
        must be closed and forgotten; the next call reconnects
        fresh."""
        try:
            sock.close()
        except OSError:
            pass
        if getattr(self._tls, 'sock', None) is sock:
            self._tls.sock = None
        if self._hb_sock is sock:
            self._hb_sock = None
        with self._socks_lock:
            try:
                self._socks.remove(sock)
            except ValueError:
                pass

    def _rpc(self, *msg, **kw):
        sock = kw.pop('sock', None)
        timeout = kw.pop('timeout', None)
        assert not kw
        sock = self._control_sock() if sock is None else sock
        old = sock.gettimeout()
        try:
            sock.settimeout(timeout)
            _send_msg(sock, msg)
            reply = _recv_msg(sock)
        except socket.timeout:
            self._drop_sock(sock)
            raise MXNetError(
                'dist: coordinator at %s:%d did not answer %r '
                'within %.1fs' % (self.address, self.port, msg[0],
                                  timeout))
        except (ConnectionError, OSError) as e:
            self._drop_sock(sock)
            raise MXNetError(
                'dist: lost the coordinator at %s:%d during %r: %s'
                % (self.address, self.port, msg[0], e))
        finally:
            try:
                sock.settimeout(old)
            except OSError:
                pass
        if reply[0] != 'ok':
            raise MXNetError(reply[1])
        return reply[1] if len(reply) > 1 else None

    # -- health ------------------------------------------------------------
    def _note_dead(self, ranks):
        """Record newly-learned deaths; preempt every watched
        CheckpointManager ONCE per new set (their next step_end drains
        the in-flight dispatch, commits the final checkpoint and
        raises elastic.Preempted with the dead-rank set)."""
        from . import profiler
        with self._dead_lock:
            new = set(int(r) for r in ranks) - self._known_dead
            if not new:
                return
            self._known_dead.update(new)
            dead_now = frozenset(self._known_dead)
        profiler.add_dist_stats(dead_hosts_detected=len(new))
        logging.warning('dist: rank %d learned of dead rank(s) %s — '
                        'requesting coordinated preemption',
                        self.rank, sorted(new))
        for mgr in list(self._watched):
            try:
                mgr.request_preempt(dead_ranks=dead_now)
            except Exception as e:   # never kill the heartbeat thread
                logging.warning('dist: preempt request failed: %s', e)

    def _hb_loop(self):
        from . import elastic, profiler
        miss_since = None
        # a WEDGED (not vanished) coordinator blocks each attempt for
        # the full RPC timeout, so the miss budget must be WALL TIME,
        # not a miss count — and the per-attempt timeout must not
        # dwarf the configured death deadline
        rpc_timeout = max(2 * self._hb_interval,
                          min(5.0, self._dead_after))
        while not self._hb_stop.wait(self._hb_interval):
            if self.rank in elastic.heartbeat_drop_ranks():
                # injected network partition: this rank neither sends
                # heartbeats nor learns the dead set (it will be the
                # one DECLARED dead by everyone else)
                profiler.add_dist_stats(heartbeats_missed=1)
                continue
            try:
                if self._hb_sock is None:   # dropped after a timeout
                    self._hb_sock = self._connect_retry(
                        time.monotonic() + rpc_timeout,
                        'heartbeat (reconnect)')
                dead = self._rpc('heartbeat', self.rank,
                                 sock=self._hb_sock,
                                 timeout=rpc_timeout)
                profiler.add_dist_stats(heartbeats_sent=1)
                miss_since = None
                if dead:
                    self._note_dead(dead)
            except MXNetError:
                if self._closed:
                    return
                profiler.add_dist_stats(heartbeats_missed=1)
                if miss_since is None:
                    miss_since = time.monotonic()
                # the coordinator (rank 0) is unreachable: after the
                # same silence threshold a dead WORKER gets, declare
                # rank 0 dead and preempt — survivors must not spin
                # forever against a vanished coordinator
                if time.monotonic() - miss_since >= self._dead_after \
                        and self.rank != 0:
                    self._note_dead([0])
                    return

    def dead_ranks(self):
        """Locally-known dead ranks (kept fresh by the heartbeat
        thread; cheap — no RPC)."""
        with self._dead_lock:
            return frozenset(self._known_dead)

    def poll_dead(self):
        """Explicitly query the coordinator's liveness table."""
        dead = self._rpc('dead', timeout=30.0) or ()
        if dead:
            self._note_dead(dead)
        return self.dead_ranks()

    def num_dead(self):
        return len(self.dead_ranks())

    def watch(self, manager):
        """Register a CheckpointManager for coordinated preemption on
        heartbeat-detected death (weakly held)."""
        self._watched.add(manager)
        return manager

    def unwatch(self, manager):
        self._watched.discard(manager)

    # -- barriers ----------------------------------------------------------
    def barrier(self, name='user', timeout=None, live_only=False):
        """Global health-checked barrier.  Raises MXNetError naming
        the ranks that failed to arrive within `timeout` (default
        MXNET_TPU_BARRIER_TIMEOUT_S) or that died while waiting —
        never hangs.  live_only=True lets the barrier complete over
        the surviving ranks (the elastic checkpoint-commit barrier)."""
        from . import elastic, profiler
        timeout = barrier_timeout_s() if timeout is None else \
            float(timeout)
        stall = elastic.barrier_stall_s(self.rank)
        if stall:
            logging.warning('dist: MXNET_TPU_FAULT_BARRIER_STALL_S '
                            'delaying rank %d by %.1fs', self.rank,
                            stall)
            time.sleep(stall)
        t0 = time.perf_counter()
        try:
            self._rpc('barrier', str(name), self.rank, float(timeout),
                      bool(live_only), timeout=timeout + 15.0)
        finally:
            profiler.add_dist_stats(
                barriers=1,
                barrier_wait_ms=(time.perf_counter() - t0) * 1e3)

    # -- host-level allreduce (the cross-process dp leg) -------------------
    def _next_round(self, name):
        with self._round_lock:
            rnd = self._round[name] = self._round.get(name, 0) + 1
        return rnd

    def allreduce(self, arrays, name='grad', timeout=None, wire=None,
                  topology=None):
        """Sum `arrays` (list of np.ndarray) across all ranks; every
        rank receives bit-identical results.  Identity at world 1.
        Raises (naming ranks) on death/timeout instead of hanging.

        `topology` (default MXNET_TPU_DIST_TOPOLOGY, else 'star')
        picks the transport: 'star' ships every rank's bytes through
        the rank-0 coordinator which sums in RANK order; 'ring' runs a
        peer-to-peer chunked reduce-scatter + all-gather summing each
        chunk in fixed ROTATION order — ~2 × bytes/world per host
        instead of (world-1) × bytes ingress at rank 0.  Each mode is
        bitwise-deterministic run-to-run (restart parity needs the
        SAME topology; at world 2 the two orders coincide, so star and
        ring agree bitwise there).

        `wire` ('int8'/'bf16'; default MXNET_TPU_DIST_WIRE_DTYPE, else
        fp32) compresses the round both directions: contributions go
        up as int8 codes + per-bucket scales (~1/4 the bytes), sums
        happen in float32, and the result is re-quantized down.  The
        quantization error is NOT lost: the contribution error and the
        result error each carry forward as error-feedback residuals
        into the next round of the same stream (same name + shapes),
        so a training run's gradient bias cancels over steps instead
        of accumulating (docs/DIST.md).  On the ring, the per-stream
        codecs quantize each rank's CONTRIBUTION chunks and the owned
        RESULT chunk; the transient partial sums traveling the
        reduce-scatter hops use stateless fresh scales.  Per mode the
        results are bitwise-deterministic — every rank decodes the
        identical compressed bytes.  dist_tx_bytes / dist_rx_bytes
        count the ACTUAL wire payload per direction (attributed per
        topology); quant_wire_bytes_saved and
        quant_error_feedback_norm land in profiler.quant_stats()."""
        from .quantization import wire_dtype_from_env
        arrays = [ha.host(a) for a in arrays]
        if self.world <= 1:
            return arrays
        wire = wire_dtype_from_env(wire)
        timeout = barrier_timeout_s() if timeout is None else \
            float(timeout)
        if topology_from_env(topology) == 'ring':
            return self._ring_round(
                lambda link, deadline: self._ring_dense(
                    link, deadline, arrays, name, wire),
                name, timeout)
        return self._star_allreduce(arrays, name, timeout, wire)

    def _star_allreduce(self, arrays, name, timeout, wire):
        """Coordinator-mediated sum (the 'star' topology)."""
        from . import profiler
        from .quantization import WireCodec
        rnd = self._next_round(name)
        if wire == 'fp32':
            out = self._rpc('allreduce', str(name), rnd, self.rank,
                            tuple(arrays), float(timeout),
                            timeout=timeout + 15.0)
            # actual wire payload per direction (contribution up +
            # result down), so the compressed modes' byte counters
            # A/B against this one like-for-like
            nbytes = sum(ha.nbytes(a) for a in arrays)
            profiler.add_dist_stats(allreduce_rounds=1,
                                    tx_bytes=nbytes, rx_bytes=nbytes,
                                    topology='star')
            return [ha.host(v) for v in out]
        ckey = (str(name), wire,
                tuple((tuple(a.shape), ha.dtype_name(a))
                      for a in arrays))
        with self._wire_lock:       # dict access only
            codec = _wire_codec(self._wire_codecs, ckey, wire)
        # the multi-MB encode serializes per STREAM (codec.lock —
        # encode mutates that stream's residual), never across
        # streams; decode is stateless and runs lock-free
        with codec.lock:
            payloads, scales = codec.encode([_f32_in(a) for a in arrays])
        up = WireCodec.wire_nbytes(payloads, scales)
        out = self._rpc('allreduce', str(name), rnd, self.rank,
                        tuple(_wire_out(payloads, wire)), float(timeout),
                        wire, scales, timeout=timeout + 15.0)
        r_payloads, r_scales = out
        r_payloads = _wire_in(r_payloads)
        down = WireCodec.wire_nbytes(r_payloads, np.asarray(r_scales))
        dec = codec.decode(r_payloads, r_scales,
                           [np.float32] * len(arrays))
        dec = [_cast_like(v, a) for v, a in zip(dec, arrays)]
        with codec.lock:
            ef = codec.residual_norm()
        fp_bytes = sum(ha.nbytes(a) for a in arrays)
        profiler.add_dist_stats(allreduce_rounds=1, tx_bytes=up,
                                rx_bytes=down, topology='star')
        profiler.add_quant_stats(
            wire_bytes_saved=max(0, 2 * fp_bytes - up - down),
            error_feedback_norm=ef)
        return dec

    # -- ring topology -----------------------------------------------------
    def _ring_round(self, fn, name, timeout):
        """Run one ring collective end-to-end under the ring lock (the
        hop sequence is stateful lockstep — rounds must not
        interleave), building the peer links on first use and tearing
        them down on ANY failure: a failed hop leaves the protocol at
        an unknown position, so the next round (or the relaunched
        process) must rebuild from a clean rendezvous."""
        from . import elastic
        stall = elastic.ring_stall_s(self.rank)
        if stall:
            logging.warning('dist: ring stall fault delaying rank %d '
                            'by %.1fs', self.rank, stall)
            time.sleep(stall)
        with self._ring_lock:
            deadline = time.monotonic() + float(timeout)
            if self._ring_link is None:
                self._ring_link = _RingLink(self, deadline)
            link = self._ring_link
            try:
                return fn(link, deadline)
            except BaseException:
                link.close()
                self._ring_link = None
                raise

    def _ring_death_verdict(self, name, deadline):
        """A ring link just broke mid-round.  A reset socket usually
        means the PEER PROCESS died, and its ECONNRESET beats the
        coordinator's heartbeat declaration by up to a heartbeat
        window — so wait the declaration out (bounded by dead_after
        AND by the round's own deadline) and return the coordinator's
        verdict.  This keeps the ring's failure contract identical to
        the star path's: the raised error names the dead rank and
        `dist.detect_dead()` is already populated when the caller's
        except-handler runs (the elastic preempt flow depends on
        that).  Always polls at least once, even past the deadline."""
        stop = min(deadline, time.monotonic() + self._dead_after + 2.0)
        while True:
            try:
                dead = self.poll_dead()
            except Exception:
                return self.dead_ranks()
            if dead or time.monotonic() >= stop:
                return dead
            time.sleep(0.2)

    def _ring_hop(self, link, out_msg, expect, deadline, name):
        """One lockstep ring hop: ship `out_msg` to the right neighbor
        while waiting on the left — concurrently, so two large chunks
        never deadlock both ranks in blocking sends against full
        socket buffers.  NAMES the stalled or dead neighbor instead of
        hanging: the heartbeat-fed dead set is polled while waiting,
        and the deadline converts a silent peer into an MXNetError
        carrying its rank."""
        import select
        send_err = []

        def _send():
            try:
                _send_msg(link.right, out_msg)
            except (ConnectionError, OSError) as e:
                send_err.append(e)

        t = threading.Thread(target=_send, daemon=True,
                             name='dist-ring-send')
        t.start()
        try:
            while True:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    raise socket.timeout()
                dead = self.dead_ranks()
                if dead:
                    raise MXNetError(
                        'ring allreduce %r failed: rank(s) %s are '
                        'dead — recover via coordinated elastic '
                        'restart' % (name, sorted(dead)))
                ready, _, _ = select.select([link.left], [], [],
                                            min(0.25, budget))
                if ready:
                    break
            link.left.settimeout(
                max(1.0, deadline - time.monotonic()))
            msg = _recv_msg(link.left)
            link.left.settimeout(None)
        except socket.timeout:
            raise MXNetError(
                'ring allreduce %r: no frame from left neighbor rank '
                '%d within the deadline — it is stalled or dead '
                '(known dead: %s); recover via coordinated elastic '
                'restart or raise MXNET_TPU_BARRIER_TIMEOUT_S'
                % (name, link.left_rank,
                   sorted(self.dead_ranks()) or 'none yet'))
        except (ConnectionError, OSError) as e:
            dead = self._ring_death_verdict(name, deadline)
            if dead:
                raise MXNetError(
                    'ring allreduce %r failed: rank(s) %s are dead '
                    '(link to left neighbor rank %d reset) — recover '
                    'via coordinated elastic restart'
                    % (name, sorted(dead), link.left_rank))
            raise MXNetError(
                'ring allreduce %r: lost the link to left neighbor '
                'rank %d: %s' % (name, link.left_rank, e))
        finally:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        if send_err:
            dead = self._ring_death_verdict(name, deadline)
            if dead:
                raise MXNetError(
                    'ring allreduce %r failed: rank(s) %s are dead '
                    '(send to right neighbor rank %d failed) — '
                    'recover via coordinated elastic restart'
                    % (name, sorted(dead), link.right_rank))
            raise MXNetError(
                'ring allreduce %r: could not send to right neighbor '
                'rank %d: %s' % (name, link.right_rank, send_err[0]))
        if t.is_alive():
            raise MXNetError(
                'ring allreduce %r: send to right neighbor rank %d '
                'stalled past the deadline — it is wedged or dead'
                % (name, link.right_rank))
        got = tuple(msg[:len(expect)])
        if got != tuple(expect):
            extra = ''
            if len(expect) >= 5 and got[:4] == tuple(expect)[:4]:
                extra = (' — every rank must resolve the same '
                         'MXNET_TPU_DIST_WIRE_DTYPE')
            raise MXNetError(
                'ring allreduce %r: protocol desync with left '
                'neighbor rank %d (got %r, expected %r)%s'
                % (name, link.left_rank, got, tuple(expect), extra))
        return msg

    def _ring_dense(self, link, deadline, arrays, name, wire):
        """Chunked ring reduce-scatter + all-gather.  Arrays group by
        dtype into flat buffers split into `world` chunks at FIXED
        divmod boundaries; at reduce-scatter step s each rank sends
        chunk (rank-s) mod w right and folds the incoming chunk
        (rank-s-1) mod w as incoming + own, so chunk c's sum always
        accumulates in rotation order c, c+1, ... — after w-1 steps
        rank r owns the finished chunk (r+1) mod w.  The all-gather
        then circulates each owner's ENCODED chunk verbatim (the owner
        decodes its own encoding), so every rank decodes identical
        bytes — the PR 9/13 bitwise invariant, per topology mode.

        Compressed wires quantize float groups only (integer groups
        ride raw): contributions through the per-stream 'ring-up'
        error-feedback codec, traveling partials with stateless fresh
        scales (transient — no residual to carry), the owned result
        chunk through the 'ring-down' codec."""
        from . import profiler
        from .quantization import (decode_ring_chunk,
                                   encode_ring_chunk)
        rnd = self._next_round('ring:' + str(name))
        w = self.world
        comp = wire != 'fp32'
        gkeys, metas, offs, groups = [], [], {}, {}
        for a in arrays:
            k = ha.dtype_name(a)
            if k not in groups:
                groups[k], offs[k] = [], 0
                gkeys.append(k)
            size = int(np.prod(a.shape)) if a.shape else 1
            metas.append((k, offs[k], size, tuple(a.shape), a))
            offs[k] += size
            groups[k].append(ha.contiguous(a).reshape(-1))
        fset, flats = set(), {}
        for k in gkeys:
            flat = _cat(groups[k]) if len(groups[k]) > 1 \
                else groups[k][0]
            if comp and _kind_f(k):
                fset.add(k)
                flat = ha.to_float32(flat)
            flats[k] = flat

        def split(flat):
            out, off = [], 0
            base, extra = divmod(flat.shape[0], w)
            for c in range(w):
                sz = base + (1 if c < extra else 0)
                out.append(flat[off:off + sz])
                off += sz
            return out

        acc = {k: split(flats[k]) for k in gkeys}
        up_payloads = up_scales = up_codec = None
        bidx = {}
        if fset:
            buckets, pos = [], 0
            for c in range(w):
                for k in gkeys:
                    if k in fset:
                        bidx[(k, c)] = pos
                        buckets.append(acc[k][c])
                        pos += 1
            ckey = (str(name), 'ring-up', wire,
                    tuple(b.shape[0] for b in buckets))
            with self._wire_lock:
                up_codec = _wire_codec(self._wire_codecs, ckey, wire)
            with up_codec.lock:
                up_payloads, up_scales = up_codec.encode(buckets)
            # accumulate from the DECODED contribution — the same
            # values every peer decodes, so partial sums match
            # bitwise across ranks
            deq = up_codec.decode(up_payloads, up_scales,
                                  [np.float32] * len(buckets))
            for (k, c), i in bidx.items():
                acc[k][c] = deq[i]

        def enc(c, contribution):
            payloads, scales = [], []
            for k in gkeys:
                x = acc[k][c]
                if k not in fset:
                    payloads.append(x)
                    scales.append(None)
                elif contribution:
                    i = bidx[(k, c)]
                    payloads.append(up_payloads[i])
                    scales.append(float(up_scales[i])
                                  if wire == 'int8' else None)
                else:
                    p, s = encode_ring_chunk(x, wire)
                    payloads.append(p)
                    scales.append(s)
            return tuple(payloads), tuple(scales)

        def dec(payloads, scales):
            return [decode_ring_chunk(ha.bits(p), s, wire) if k in fset
                    else ha.host(p)
                    for k, p, s in zip(gkeys, payloads, scales)]

        def nbytes(payloads, scales):
            wireb = sum(ha.nbytes(p) for p in payloads) + \
                4 * sum(1 for s in scales if s is not None)
            fpb = sum(4 * int(np.prod(p.shape)) if k in fset
                      else ha.nbytes(p)
                      for k, p in zip(gkeys, payloads))
            return wireb, fpb

        def wire_of(payloads):
            return tuple(_wire_out(payloads, wire)) if fset else payloads

        tx = rx = fp_eq = 0
        for s in range(w - 1):
            send_idx = (self.rank - s) % w
            recv_idx = (self.rank - s - 1) % w
            payloads, scales = enc(send_idx, contribution=(s == 0))
            msg = self._ring_hop(
                link, ('rs', str(name), rnd, s, wire, wire_of(payloads),
                       scales),
                ('rs', str(name), rnd, s, wire), deadline, name)
            b, f = nbytes(payloads, scales)
            b2, f2 = nbytes(msg[5], msg[6])
            tx, rx, fp_eq = tx + b, rx + b2, fp_eq + f + f2
            for k, v in zip(gkeys, dec(msg[5], msg[6])):
                acc[k][recv_idx] = v + acc[k][recv_idx]
        own_idx = (self.rank + 1) % w
        enc_store = [None] * w
        if fset:
            fbuckets = [acc[k][own_idx] for k in gkeys if k in fset]
            dkey = (str(name), 'ring-down', wire,
                    tuple(b.shape[0] for b in fbuckets))
            with self._wire_lock:
                down_codec = _wire_codec(self._wire_codecs, dkey,
                                         wire)
            with down_codec.lock:
                d_payloads, d_scales = down_codec.encode(fbuckets)
            payloads, scales, i = [], [], 0
            for k in gkeys:
                if k in fset:
                    payloads.append(d_payloads[i])
                    scales.append(float(d_scales[i])
                                  if wire == 'int8' else None)
                    i += 1
                else:
                    payloads.append(acc[k][own_idx])
                    scales.append(None)
            enc_store[own_idx] = (tuple(payloads), tuple(scales))
        else:
            enc_store[own_idx] = enc(own_idx, contribution=False)
        final = {k: [None] * w for k in gkeys}
        for k, v in zip(gkeys, dec(*enc_store[own_idx])):
            final[k][own_idx] = v
        for s in range(w - 1):
            send_idx = (self.rank + 1 - s) % w
            recv_idx = (self.rank - s) % w
            payloads, scales = enc_store[send_idx]
            msg = self._ring_hop(
                link, ('ag', str(name), rnd, s, wire, wire_of(payloads),
                       scales),
                ('ag', str(name), rnd, s, wire), deadline, name)
            b, f = nbytes(payloads, scales)
            in_p, in_s = tuple(msg[5]), tuple(msg[6])
            b2, f2 = nbytes(in_p, in_s)
            tx, rx, fp_eq = tx + b, rx + b2, fp_eq + f + f2
            enc_store[recv_idx] = (in_p, in_s)
            for k, v in zip(gkeys, dec(in_p, in_s)):
                final[k][recv_idx] = v
        out_flat = {k: (_cat(final[k]) if w > 1
                        else final[k][0]) for k in gkeys}
        out = [_cast_like(out_flat[k][off:off + size].reshape(shape), a)
               if k in fset else
               ha.copy(out_flat[k][off:off + size].reshape(shape))
               for k, off, size, shape, a in metas]
        profiler.add_dist_stats(allreduce_rounds=1, tx_bytes=tx,
                                rx_bytes=rx, topology='ring')
        if comp:
            ef = 0.0
            if up_codec is not None:
                with up_codec.lock:
                    ef = up_codec.residual_norm()
            profiler.add_quant_stats(
                wire_bytes_saved=max(0, fp_eq - tx - rx),
                error_feedback_norm=ef)
        return out

    # -- sparse COO allreduce ----------------------------------------------
    def allreduce_coo(self, uids, rows, name='embed', vocab=None,
                      timeout=None, topology=None):
        """Sparse cross-rank sum: every rank contributes COO
        (unique_ids, rows) and receives the SORTED union with
        duplicate ids' rows summed deterministically (rank order on
        star; rotation order per id-range chunk on ring — each
        bitwise-reproducible per mode).  The wire carries
        rows-touched bytes instead of a re-densified (vocab, dim)
        gradient.  `vocab` (row-id upper bound) is required on the
        ring topology — it fixes the id-range chunk boundaries.
        Identity (plus local dedup + sort) at world 1."""
        from . import profiler
        uids = np.ascontiguousarray(np.asarray(uids,
                                               np.int64).ravel())
        rows = np.ascontiguousarray(ha.host(rows))
        if rows.ndim != 2 or rows.shape[0] != uids.shape[0]:
            raise MXNetError(
                'allreduce_coo: rows must be (len(uids), dim); got '
                'ids %r, rows %r' % (uids.shape, rows.shape))
        uids, rows = _merge_coo([uids], [rows])
        if self.world <= 1:
            return uids, rows
        timeout = barrier_timeout_s() if timeout is None else \
            float(timeout)
        if topology_from_env(topology) == 'ring':
            if vocab is None:
                raise MXNetError('allreduce_coo on the ring topology '
                                 'needs vocab= (the id-range chunk '
                                 'bound)')
            return self._ring_round(
                lambda link, deadline: self._ring_coo(
                    link, deadline, uids, rows, name, int(vocab)),
                name, timeout)
        rnd = self._next_round('coo:' + str(name))
        out = self._rpc('allreduce_coo', str(name), rnd, self.rank,
                        uids, rows, float(timeout),
                        timeout=timeout + 15.0)
        out_ids = np.asarray(out[0], np.int64)
        out_rows = np.asarray(out[1])
        profiler.add_dist_stats(
            allreduce_rounds=1,
            tx_bytes=uids.nbytes + rows.nbytes,
            rx_bytes=out_ids.nbytes + out_rows.nbytes,
            topology='sparse')
        return out_ids, out_rows

    def _ring_coo(self, link, deadline, uids, rows, name, vocab):
        """Ring leg of allreduce_coo: chunk by FIXED id ranges
        (ceil(vocab/world) wide — identical boundaries everywhere),
        reduce-scatter merging incoming-before-own per range, then
        all-gather the merged owner ranges verbatim; concatenating
        the ranges in order rebuilds the same sorted union on every
        rank."""
        from . import profiler
        rnd = self._next_round('coo-ring:' + str(name))
        w = self.world
        span = max(1, -(-max(1, int(vocab)) // w))
        if uids.size and int(uids[-1]) >= vocab:
            raise MXNetError(
                'allreduce_coo: id %d outside vocab %d — the ring '
                'chunking needs every id < vocab'
                % (int(uids[-1]), vocab))
        ids_c, rows_c = [], []
        for c in range(w):
            m = (uids >= c * span) & (uids < (c + 1) * span)
            ids_c.append(uids[m])
            rows_c.append(rows[m])
        tx = rx = 0
        for s in range(w - 1):
            send_idx = (self.rank - s) % w
            recv_idx = (self.rank - s - 1) % w
            msg = self._ring_hop(
                link, ('crs', str(name), rnd, s, ids_c[send_idx],
                       rows_c[send_idx]),
                ('crs', str(name), rnd, s), deadline, name)
            tx += ids_c[send_idx].nbytes + rows_c[send_idx].nbytes
            in_ids = np.asarray(msg[4], np.int64)
            in_rows = np.asarray(msg[5])
            rx += in_ids.nbytes + in_rows.nbytes
            ids_c[recv_idx], rows_c[recv_idx] = _merge_coo(
                [in_ids, ids_c[recv_idx]],
                [in_rows, rows_c[recv_idx]])
        for s in range(w - 1):
            send_idx = (self.rank + 1 - s) % w
            recv_idx = (self.rank - s) % w
            msg = self._ring_hop(
                link, ('cag', str(name), rnd, s, ids_c[send_idx],
                       rows_c[send_idx]),
                ('cag', str(name), rnd, s), deadline, name)
            tx += ids_c[send_idx].nbytes + rows_c[send_idx].nbytes
            in_ids = np.asarray(msg[4], np.int64)
            in_rows = np.asarray(msg[5])
            rx += in_ids.nbytes + in_rows.nbytes
            ids_c[recv_idx], rows_c[recv_idx] = in_ids, in_rows
        out_ids = np.concatenate(ids_c)
        out_rows = np.concatenate(rows_c, axis=0)
        profiler.add_dist_stats(allreduce_rounds=1, tx_bytes=tx,
                                rx_bytes=rx, topology='sparse')
        return out_ids, out_rows

    # -- async overlap -----------------------------------------------------
    def allreduce_async(self, arrays, name='grad', timeout=None,
                        wire=None, topology=None):
        """Launch the cross-host sum in the background and return an
        AllreduceHandle to `wait()` at the optimizer boundary — the
        host analog of GradReducePlan's backward-interleaved reduction.
        ONE dedicated FIFO worker drains launches, so rounds run in
        launch order; callers must launch streams in the same order on
        every rank (both topologies pair rounds by that order — the
        KVStore overlap path iterates its canonical key order for
        exactly this reason).  Mixing synchronous allreduce calls from
        other threads while async rounds are in flight is not
        supported on the ring topology."""
        arrays = [ha.host(a) for a in arrays]
        handle = AllreduceHandle()
        if self.world <= 1:
            handle._result = arrays
            handle._t_done = time.perf_counter()
            handle._event.set()
            return handle
        self._ensure_async_worker()
        self._async_q.put((handle, arrays, name, timeout, wire,
                           topology))
        return handle

    def _ensure_async_worker(self):
        import queue
        with self._async_lock:
            if self._async_q is None:
                self._async_q = queue.Queue()
            if self._async_thread is None or \
                    not self._async_thread.is_alive():
                self._async_thread = threading.Thread(
                    target=self._async_loop, name='dist-async-reduce',
                    daemon=True)
                self._async_thread.start()

    def _async_loop(self):
        while True:
            item = self._async_q.get()
            if item is None:
                return
            handle, arrays, name, timeout, wire, topology = item
            try:
                handle._result = self.allreduce(
                    arrays, name=name, timeout=timeout, wire=wire,
                    topology=topology)
            except BaseException as e:  # delivered at wait()
                handle._error = e
            finally:
                handle._t_done = time.perf_counter()
                handle._event.set()

    # -- teardown ----------------------------------------------------------
    def shutdown(self):
        """Clean exit: deregister (a bye is not a death), stop the
        heartbeat thread, close sockets, stop an owned coordinator."""
        if self._closed:
            return
        self._closed = True
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        if self._async_q is not None:
            self._async_q.put(None)     # drains queued rounds first
            if self._async_thread is not None:
                self._async_thread.join(timeout=10.0)
        with self._ring_lock:
            if self._ring_link is not None:
                self._ring_link.close()
                self._ring_link = None
        try:
            self._rpc('bye', self.rank, timeout=5.0)
        except MXNetError:
            pass
        with self._socks_lock:
            socks = list(self._socks) + [self._hb_sock]
        for s in socks:
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass
        if self._owns_coordinator and self.coordinator is not None:
            # wait (bounded) until every peer has said bye or been
            # declared dead before the listener dies: a slower rank
            # may still be fetching the last round's allreduce result
            # or entering its final barrier, and killing the
            # coordinator under it would turn a clean finish into a
            # crash at the very last step
            coord = self.coordinator
            deadline = time.monotonic() + 10.0
            others = set(range(self.world)) - {self.rank}
            with coord._cv:
                while time.monotonic() < deadline and \
                        not others <= (coord._departed | coord._dead):
                    coord._cv.wait(0.2)
            coord.stop()


class _WorkerRuntime(object):
    """The runtime of a worker of several ranks (parallel/worker_group.py):
    the group's leader holds the worker's DistRuntime, and every result
    it gets (a sum, a barrier's passing) reaches the other ranks of the
    group from it, so the job's other workers see one rank per worker.
    An async round runs at once and returns a finished handle."""

    def __init__(self, inner, rank, world):
        self._inner = inner
        self.rank, self.world = rank, world
        self.address = inner.address if inner is not None else None
        self.port = inner.port if inner is not None else None

    # the liveness table is the leader's (no collective: a rank reads it
    # whenever it likes)
    def dead_ranks(self):
        return self._inner.dead_ranks() if self._inner is not None \
            else frozenset()

    def poll_dead(self):
        return self._inner.poll_dead() if self._inner is not None \
            else frozenset()

    def num_dead(self):
        return len(self.dead_ranks())

    def watch(self, manager):
        if self._inner is not None:
            self._inner.watch(manager)
        return manager

    def unwatch(self, manager):
        if self._inner is not None:
            self._inner.unwatch(manager)

    def barrier(self, name='user', timeout=None, live_only=False):
        from .parallel import worker_group
        if self._inner is not None:
            self._inner.barrier(name, timeout=timeout, live_only=live_only)
        worker_group.barrier()

    def allreduce(self, arrays, name='grad', timeout=None, wire=None,
                  topology=None):
        from .parallel import worker_group
        out = None
        if self._inner is not None:
            out = self._inner.allreduce(arrays, name=name, timeout=timeout,
                                        wire=wire, topology=topology)
        return worker_group.broadcast_host(out)

    def allreduce_async(self, arrays, name='grad', timeout=None, wire=None,
                        topology=None):
        h = AllreduceHandle()
        h._result = self.allreduce(arrays, name=name, timeout=timeout,
                                   wire=wire, topology=topology)
        h._t_done = time.perf_counter()
        h._event.set()
        return h

    def allreduce_coo(self, uids, rows, name='embed', vocab=None,
                      topology=None):
        from .parallel import worker_group
        out = None
        if self._inner is not None:
            out = self._inner.allreduce_coo(uids, rows, name=name,
                                            vocab=vocab, topology=topology)
        return tuple(worker_group.broadcast_host(
            None if out is None else [np.asarray(out[0]), out[1]]))

    def shutdown(self):
        if self._inner is not None:
            self._inner.shutdown()


# ---------------------------------------------------------------------------
# process-level singleton
# ---------------------------------------------------------------------------

_RUNTIME = None
# the torch.distributed group that MXNET_TPU_DIST_JAX=1 brought up
_SPMD = {'group': False, 'owned': False}


def _init_spmd(rank, world, address, port):
    """One torch.distributed group across the workers (MXNET_TPU_DIST_JAX
    =1): tcp rendezvous at MXNET_TPU_DIST_JAX_ADDR, else the coordinator's
    address at port + 1."""
    import torch.distributed as tdist
    from .parallel import mesh as pmesh
    if tdist.is_initialized():
        _SPMD['group'] = True
        return
    _SPMD['owned'] = True
    addr = os.environ.get('MXNET_TPU_DIST_JAX_ADDR') or \
        '%s:%d' % (address, (port or 9090) + 1)
    local = os.environ.get('LOCAL_RANK')
    if local is None:
        os.environ['LOCAL_RANK'] = str(rank)
    device = os.environ.get('MXNET_TPU_DIST_DEVICE') or None
    pmesh.init_process_group(device=device, init_method='tcp://' + addr,
                             rank=rank, world_size=world)
    _SPMD['group'] = True


def initialize(rank=None, world=None, address=None, port=None,
               timeout=None, heartbeat=True):
    """Bootstrap this process into the job (idempotent).  Defaults
    come from the tools.launch env contract: DMLC_WORKER_ID /
    DMLC_NUM_WORKER / DMLC_PS_ROOT_URI / MXNET_TPU_DIST_PORT (falling
    back to DMLC_PS_ROOT_PORT).  Rank 0 hosts the coordinator.
    Cross-process data parallelism rides `dist.allreduce` through the
    KVStore facade; with MXNET_TPU_DIST_JAX=1 the workers also join one
    torch.distributed group (module docstring), over which a Module's
    data mesh reduces in the step.  Returns the DistRuntime."""
    global _RUNTIME
    if _RUNTIME is not None:
        return _RUNTIME
    from . import profiler
    env = os.environ
    rank = int(env.get('DMLC_WORKER_ID', 0)) if rank is None else int(rank)
    world = int(env.get('DMLC_NUM_WORKER', 1)) if world is None \
        else int(world)
    address = address or env.get('DMLC_PS_ROOT_URI', '127.0.0.1')
    if port is None:
        p = env.get('MXNET_TPU_DIST_PORT') or env.get('DMLC_PS_ROOT_PORT')
        port = int(p) if p else None
    from .parallel import worker_group
    spmd = env.get('MXNET_TPU_DIST_JAX', '').strip() in ('1', 'true')
    group = worker_group.init()
    if group is not None:
        if spmd:
            raise MXNetError(
                'MXNET_TPU_DIST_JAX=1 makes the workers one process group; '
                'a worker of several ranks (tools.launch '
                '--ranks-per-worker) has a group of its own')
        # the worker's leader is its rank in the job's runtime
        _RUNTIME = _WorkerRuntime(
            DistRuntime(rank, world, address=address, port=port,
                        timeout=timeout, heartbeat=heartbeat)
            if group.leader else None, rank, world)
    else:
        _RUNTIME = DistRuntime(rank, world, address=address, port=port,
                               timeout=timeout, heartbeat=heartbeat)
    if spmd:
        _init_spmd(rank, world, _RUNTIME.address, _RUNTIME.port)
    restarts = env.get('MXNET_TPU_DIST_RESTART_COUNT', '').strip()
    if restarts:
        try:
            profiler.add_dist_stats(restarts=int(restarts))
        except ValueError:
            pass
    logging.info('dist: initialized rank %d of %d (coordinator %s:%s)',
                 _RUNTIME.rank, _RUNTIME.world, _RUNTIME.address,
                 _RUNTIME.port)
    return _RUNTIME


def runtime():
    """The process's DistRuntime, or None before initialize()."""
    return _RUNTIME


def rank():
    return _RUNTIME.rank if _RUNTIME is not None else 0


def world():
    return _RUNTIME.world if _RUNTIME is not None else 1


def dead_ranks():
    """Real cross-process deaths this process knows of (empty set when
    the runtime is not initialized)."""
    return _RUNTIME.dead_ranks() if _RUNTIME is not None else frozenset()


def detect_dead():
    """Dead ranks, refreshing from the coordinator when the local
    heartbeat view is still empty — a cross-host step can fail on a
    death the coordinator noticed before this rank's next heartbeat
    reply delivered it.  An unreachable coordinator counts as rank 0
    dead (it lives in rank 0's process)."""
    if _RUNTIME is None:
        return frozenset()
    dead = _RUNTIME.dead_ranks()
    if dead:
        return dead
    try:
        return _RUNTIME.poll_dead()
    except MXNetError:
        return frozenset() if _RUNTIME.rank == 0 else frozenset({0})


def barrier(name='user', timeout=None):
    if _RUNTIME is None:
        return
    _RUNTIME.barrier(name, timeout=timeout)


def allreduce(arrays, name='grad', wire=None, topology=None):
    """Cross-rank sum (identity before initialize()).  `wire` opts
    into the compressed int8/bf16 bucket wire format (default
    MXNET_TPU_DIST_WIRE_DTYPE); `topology` picks star vs ring (default
    MXNET_TPU_DIST_TOPOLOGY) — see DistRuntime.allreduce."""
    if _RUNTIME is None:
        return [ha.host(a) for a in arrays]
    return _RUNTIME.allreduce(arrays, name=name, wire=wire,
                              topology=topology)


def allreduce_async(arrays, name='grad', wire=None, topology=None):
    """Background cross-rank sum; returns an AllreduceHandle whose
    wait() yields what allreduce() would have (already-complete before
    initialize()) — see DistRuntime.allreduce_async."""
    if _RUNTIME is None:
        h = AllreduceHandle()
        h._result = [ha.host(a) for a in arrays]
        h._t_done = time.perf_counter()
        h._event.set()
        return h
    return _RUNTIME.allreduce_async(arrays, name=name, wire=wire,
                                    topology=topology)


def allreduce_coo(uids, rows, name='embed', vocab=None, topology=None):
    """Sparse COO cross-rank sum of (unique_ids, rows) pairs (local
    dedup + sort before initialize()) — see
    DistRuntime.allreduce_coo."""
    if _RUNTIME is None:
        return _merge_coo([np.asarray(uids, np.int64).ravel()],
                          [ha.host(rows)])
    return _RUNTIME.allreduce_coo(uids, rows, name=name, vocab=vocab,
                                  topology=topology)


def host_span_active():
    """True when cross-process data parallelism rides the host-level
    `dist.allreduce` through the KVStore facade: the runtime is up and
    the workers are not one torch.distributed group
    (MXNET_TPU_DIST_JAX=1), whose data mesh reduces in the step. A
    worker of several ranks reduces over its own group in the step, and
    across the workers here."""
    return _RUNTIME is not None and not _SPMD['group']


def shutdown():
    """Tear down the process runtime (idempotent)."""
    global _RUNTIME
    rt, _RUNTIME = _RUNTIME, None
    if rt is not None:
        rt.shutdown()
    if _SPMD['owned']:
        from .parallel import mesh as pmesh
        pmesh.destroy_process_group()
    _SPMD['group'] = _SPMD['owned'] = False
