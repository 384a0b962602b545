"""Self-healing serving fleet: replica supervisor, routing front with
retry-on-replica-death, canary hot-swap with auto-rollback, shadow
replay, and the train->serve loop that feeds it. The counterpart of
mxnet_tpu/fleet_supervisor.py.

`serving_fleet` serves many models from one process; this module is the
multi-process tier above it:

  * **ReplicaServer**: one serving replica, a ModelRegistry behind the
    HTTP front, with admin ops (`POST /v1/models/<n>:load`, `:unload`,
    `:delta`) so that a supervisor can hot-swap model versions on a live
    replica, and the fault-injection hooks the kill, detect, restart
    and rollback paths are tested through. It runs in-process (tests)
    or as a subprocess (config in MXNET_TPU_FLEET_REPLICA_CONFIG).
  * **FleetRouter**: the fleet's public surface. It spreads
    `/v1/models/<name>:predict` across live replicas (round robin) and
    retries a request on replica death: a refused connection was never
    delivered and is always redispatched; a connection lost after
    delivery is redispatched only for idempotent requests (the default;
    `X-Mxtpu-Non-Idempotent: 1` marks one that must never run twice),
    within the model's SLO deadline. A dead fleet answers fast typed
    503s. It also holds the deployment state: the canary split (a share
    of traffic to a candidate arm, per-arm latency and error windows,
    auto-rollback and auto-promote) and the shadow tee (logged traffic
    replayed to the candidate, whose answers are compared and dropped).
  * **FleetSupervisor**: spawns N localhost replica processes, probes
    `/healthz` on a heartbeat, declares a replica silent past
    DEAD_AFTER dead, SIGKILLs and respawns it with exponential backoff
    under a restart budget, reconciles a respawned replica to the
    intended model set, scales from the counter windows (ScalePolicy),
    and drives continuous deployment: `push(name, prefix, epoch)` loads
    the candidate on every live replica and opens the canary split.
  * **CheckpointPusher / PushVerdict / RollbackStop**: the train->serve
    loop. Wired as an elastic.CheckpointManager `on_commit` hook, each
    committed checkpoint is exported to the serving format
    (serving.export_serving_checkpoint) and pushed as a canary from a
    bounded asynchronous queue (a wedged or dead fleet skips and
    counts, and never stalls a training step); the verdict flows back
    to the trainer as a typed PushVerdict, and N consecutive rollbacks
    raise RollbackStop out of the training loop. With `delta=True` a
    commit goes out as an int8 weight delta against the promoted chain
    once a full push has been promoted.

Where the port departs from the JAX package:

  * a replica's device is a Context, not the process's JAX platform:
    `FleetSupervisor(ctx=)` and `ReplicaServer(ctx=)` take it (default
    the calling thread's `with ctx:` context, else `gpu(0)`), and a
    spawned replica gets it as a context string ('gpu(0)', 'cpu(0)') in
    its JSON config. A replica asked for the card on a host without
    CUDA raises at boot, so its spawn fails; it never serves on the CPU
    in its place. Tests pass `mx.cpu()`;
  * the spawned replica command imports `mxnet_tpu_torch.
    fleet_supervisor`.

Env knobs (the JAX package's docs/SERVING.md has the full table):
  MXNET_TPU_FLEET_HEARTBEAT_S        health-probe cadence (0.5)
  MXNET_TPU_FLEET_DEAD_AFTER_S       silence before declared dead (5x)
  MXNET_TPU_FLEET_SPAWN_TIMEOUT_S    replica boot deadline (120)
  MXNET_TPU_FLEET_RESTART_BACKOFF_S  first respawn delay (0.5, x2 to 10)
  MXNET_TPU_FLEET_MAX_RESTARTS       restarts per slot per window (5)
  MXNET_TPU_FLEET_RESTART_WINDOW_S   restart-budget window (60)
  MXNET_TPU_FLEET_PROXY_TIMEOUT_S    router attempt/budget cap (30)
  MXNET_TPU_FLEET_DRAIN_S            retire draining grace (5)
  MXNET_TPU_FLEET_CANARY_FRAC        candidate traffic share (0.1)
  MXNET_TPU_FLEET_CANARY_MIN_SAMPLES canary window before judging (20)
  MXNET_TPU_FLEET_CANARY_REGRESS_FACTOR  rollback when cand p99 >
                                     factor x stable p99 (2.0)
  MXNET_TPU_FLEET_CANARY_ERR_FRAC    rollback error-rate knob (0.05)
  MXNET_TPU_FLEET_CANARY_PROMOTE_SAMPLES healthy samples to promote (200)
  MXNET_TPU_FLEET_REQUEST_LOG        shadow/replay log capacity (64)
  MXNET_TPU_FLEET_SHADOW_RTOL        divergence tolerance (1e-4)

Fault injection (mirrors the elastic/dist MXNET_TPU_FAULT_* matrix):
  MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S  'SECS' or 'IDX:SECS' — the
      replica process hard-exits after SECS (crash injection)
  MXNET_TPU_FAULT_REPLICA_WEDGE      'IDX[,IDX...]' or 'IDX:SECS' —
      the replica stops answering /healthz WITHOUT exiting (wedge)
  MXNET_TPU_FAULT_CANARY_DEGRADE_MS  'MS' inflates every canary-arm
      ('@' in the served name) predict by MS ms; 'SUBSTR:MS' only arms
      whose name contains SUBSTR (regression injection)
  MXNET_TPU_FAULT_PUSH_FAIL          fail the Nth CheckpointPusher
      push attempt with an injected error (degradation drill)

Counters: profiler.fleet_supervisor_stats() (replica_spawns/restarts/
retires, replicas_live, router_requests/retries/503, canary_pushes/
promotions/rollbacks, shadow_requests/divergences) — in summary(),
dump_profile, and the router's /statsz.
"""
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque

import http.client
import numpy as np

from . import delta as delta_mod
from . import profiler
from .base import MXNetError
from .elastic import fault_knob
from .serving import _env_int
from .context import Context
from .serving_fleet import (BudgetExceeded, HttpFront, ModelRegistry,
                            SLO, _default_ctx, _env_float, _FleetHandler,
                            _FleetHTTPServer, _predict_model)

__all__ = ['ReplicaServer', 'FleetRouter', 'FleetSupervisor',
           'ScalePolicy', 'post_with_backoff', 'run_replica',
           'PushVerdict', 'RollbackStop', 'CheckpointPusher']


def _resolve_ctx(ctx):
    """A Context from a Context, its string ('gpu(0)', 'cpu(0)') or
    None (the calling thread's `with ctx:` context, else gpu(0))."""
    if ctx is None:
        return _default_ctx()
    if isinstance(ctx, Context):
        return ctx
    s = str(ctx).strip()
    try:
        kind, rest = s.split('(', 1)
        return Context(kind, int(rest.rstrip(')') or 0))
    except (ValueError, KeyError):
        raise MXNetError('bad replica context %r (want gpu(N) or cpu(N))'
                         % (ctx,))


def _check_device(ctx):
    """A replica asked for the card raises where there is none: it never
    serves on the CPU in its place."""
    if ctx.device_type == 'gpu':
        import torch
        if not torch.cuda.is_available():
            raise MXNetError(
                'fleet replica on %s: torch.cuda.is_available() is False '
                '(pass ctx=mx.cpu() to serve on the CPU)' % ctx)


# ---------------------------------------------------------------------------
# env knobs (read lazily, dist.py style, so tests can flip them)
# ---------------------------------------------------------------------------

def heartbeat_interval_s():
    return _env_float('MXNET_TPU_FLEET_HEARTBEAT_S', 0.5)


def dead_after_s():
    """Silence threshold before a replica is declared dead (default 5
    probe intervals — the dist.py liveness pattern)."""
    return _env_float('MXNET_TPU_FLEET_DEAD_AFTER_S',
                      5.0 * heartbeat_interval_s())


def spawn_timeout_s():
    return _env_float('MXNET_TPU_FLEET_SPAWN_TIMEOUT_S', 120.0)


def restart_backoff_s():
    return _env_float('MXNET_TPU_FLEET_RESTART_BACKOFF_S', 0.5)


def max_restarts():
    return _env_int('MXNET_TPU_FLEET_MAX_RESTARTS', 5)


def restart_window_s():
    return _env_float('MXNET_TPU_FLEET_RESTART_WINDOW_S', 60.0)


def proxy_timeout_s():
    return _env_float('MXNET_TPU_FLEET_PROXY_TIMEOUT_S', 30.0)


def drain_s():
    return _env_float('MXNET_TPU_FLEET_DRAIN_S', 5.0)


def canary_frac():
    return _env_float('MXNET_TPU_FLEET_CANARY_FRAC', 0.1)


def canary_min_samples():
    return _env_int('MXNET_TPU_FLEET_CANARY_MIN_SAMPLES', 20)


def canary_regress_factor():
    return _env_float('MXNET_TPU_FLEET_CANARY_REGRESS_FACTOR', 2.0)


def canary_err_frac():
    return _env_float('MXNET_TPU_FLEET_CANARY_ERR_FRAC', 0.05)


def canary_promote_samples():
    return _env_int('MXNET_TPU_FLEET_CANARY_PROMOTE_SAMPLES', 200)


def request_log_cap():
    return _env_int('MXNET_TPU_FLEET_REQUEST_LOG', 64)


def latency_window_s():
    """Age horizon for the router's SCALING latency window: p99 is
    computed over samples newer than this.  The window is
    request-driven, so without a time bound a low-rps trickle keeps
    peak-era latencies alive for hours and blocks scale-down (the
    window frozen by a trickle)."""
    return _env_float('MXNET_TPU_FLEET_LATENCY_WINDOW_S', 60.0)


def shadow_rtol():
    return _env_float('MXNET_TPU_FLEET_SHADOW_RTOL', 1e-4)


# ---------------------------------------------------------------------------
# fault-injection knob parsers (the elastic/dist fault-matrix idiom)
# ---------------------------------------------------------------------------

def replica_kill_after_s(index):
    """MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S: 'SECS' kills every
    replica after SECS; 'IDX:SECS' only replica IDX.  None = off."""
    v = fault_knob('REPLICA_KILL_AFTER_S')
    if v is None:
        return None
    try:
        if ':' in str(v):
            i, secs = str(v).split(':', 1)
            return float(secs) if int(i) == int(index) else None
        return float(v)
    except ValueError:
        return None


def replica_wedged(index, age_s):
    """MXNET_TPU_FAULT_REPLICA_WEDGE: 'IDX[,IDX...]' wedges those
    replica indices from the start; 'IDX:SECS' wedges replica IDX once
    it is older than SECS.  A wedged replica stops answering /healthz
    WITHOUT exiting — the hang the supervisor must detect by probe
    timeout, not by process death."""
    v = fault_knob('REPLICA_WEDGE')
    if v is None:
        return False
    s = str(v)
    try:
        if ':' in s:
            i, secs = s.split(':', 1)
            return int(i) == int(index) and float(age_s) >= float(secs)
        return int(index) in set(int(p) for p in s.split(',')
                                 if p.strip())
    except ValueError:
        return False


def canary_degrade_ms(name=None):
    """MXNET_TPU_FAULT_CANARY_DEGRADE_MS: milliseconds of injected
    latency for canary-arm predicts (served names containing '@') —
    the regression the auto-rollback path is tested with.  A bare
    'MS' degrades every canary arm; 'SUBSTR:MS' degrades only arms
    whose served name contains SUBSTR (e.g. '@v1:100' — lets a
    closed-loop drill roll back the first push and promote a later
    one from the same replica processes, whose env is fixed at
    spawn)."""
    v = fault_knob('CANARY_DEGRADE_MS')
    if v is None:
        return 0.0
    s = str(v)
    try:
        if ':' in s:
            sub, ms = s.rsplit(':', 1)
            return float(ms) if name is not None and sub in name \
                else 0.0
        return float(s)
    except ValueError:
        return 0.0


def push_fail_n():
    """MXNET_TPU_FAULT_PUSH_FAIL: 1-based ordinal of the push attempt
    the CheckpointPusher fails with an injected error (the Nth push) —
    the degradation path of the train->serve loop, drillable without a
    broken fleet.  None = off."""
    from .elastic import _fault_int
    return _fault_int('PUSH_FAIL')


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

class _NotDelivered(Exception):
    """The request never reached a replica (connect refused/timed
    out): redispatching can never double-execute anything."""


class _MaybeExecuted(Exception):
    """The connection died AFTER the request was sent: the replica may
    have executed it — only idempotent requests may redispatch."""


def _http_json(method, host, port, path, payload=None, timeout=5.0,
               headers=None):
    """One JSON round trip; returns (status, headers-dict, body-dict).
    Raises OSError family on transport failure."""
    body = None if payload is None else json.dumps(payload).encode()
    hdrs = {'Content-Type': 'application/json'}
    hdrs.update(headers or {})
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body, hdrs if body is not None
                     else (headers or {}))
        resp = conn.getresponse()
        raw = resp.read()
        try:
            data = json.loads(raw) if raw else {}
        except ValueError:
            data = {'raw': raw.decode('utf-8', 'replace')}
        return resp.status, dict(resp.getheaders()), data
    finally:
        conn.close()


def post_with_backoff(url, payload, deadline_s=30.0, timeout_s=None,
                      max_sleep_s=5.0):
    """Closed-loop client helper honoring the fleet's backpressure
    contract (a client that retries at once hammers through 429s):

      * 429 -> sleep per the body's `retry_after_ms` (preferred: ms
        resolution) or the Retry-After header, capped, then retry;
      * 503 / connection errors -> exponential backoff retry (the
        fleet may be mid-restart);
      * anything else -> returned as-is.

    Returns (status, body_dict).  Raises MXNetError when `deadline_s`
    passes without a non-backoff answer — bounded, never a hot loop.
    Used by the fleet bench's clients and usable by any caller of the
    HTTP front."""
    from urllib.parse import urlsplit
    u = urlsplit(url)
    host, port = u.hostname, u.port or 80
    path = u.path + (('?' + u.query) if u.query else '')
    t_end = time.monotonic() + float(deadline_s)
    delay = 0.05
    last = None
    while True:
        left = t_end - time.monotonic()
        if left <= 0:
            raise MXNetError(
                'post_with_backoff: no answer from %s within %.1fs '
                '(last: %s)' % (url, deadline_s, last))
        try:
            status, hdrs, body = _http_json(
                'POST', host, port, path, payload,
                timeout=min(left, timeout_s or proxy_timeout_s()))
        except (OSError, http.client.HTTPException) as e:
            last = repr(e)
            time.sleep(min(delay, max(0.0, t_end - time.monotonic())))
            delay = min(max_sleep_s, delay * 2)
            continue
        if status == 429:
            ra_ms = body.get('retry_after_ms')
            if ra_ms is None:
                try:
                    ra_ms = float(hdrs.get('Retry-After', 1)) * 1000.0
                except ValueError:
                    ra_ms = 1000.0
            last = '429 retry_after_ms=%s' % ra_ms
            time.sleep(min(max_sleep_s, max(0.001, ra_ms / 1e3),
                           max(0.0, t_end - time.monotonic())))
            continue
        if status == 503:
            last = '503 %s' % (body.get('error'),)
            time.sleep(min(delay, max(0.0, t_end - time.monotonic())))
            delay = min(max_sleep_s, delay * 2)
            continue
        return status, body


# ---------------------------------------------------------------------------
# replica: registry + front + admin ops + fault hooks
# ---------------------------------------------------------------------------

class _ReplicaHandler(_FleetHandler):
    """The replica-side HTTP handler: everything _FleetHandler serves,
    plus supervisor admin ops and the fault-injection hooks.

      POST /v1/models/<name>:load    {prefix, epoch, input_shapes,...}
      POST /v1/models/<name>:unload
      POST /v1/models/<name>:delta   {prefix, ..., delta: {base, path,
                                      meta, parity_tol}}
    """

    def do_GET(self):
        rs = getattr(self.server.front, 'replica', None)
        if rs is not None and self.path == '/healthz' and rs.wedged():
            # injected wedge: hold the probe open forever — the
            # supervisor must detect this by probe TIMEOUT, the
            # failure mode process death cannot exercise
            time.sleep(3600)
            return
        _FleetHandler.do_GET(self)

    def do_POST(self):
        name = _predict_model(self.path)
        if name is not None:
            d = canary_degrade_ms(name)
            if d > 0 and '@' in name:
                time.sleep(d / 1e3)
            return _FleetHandler.do_POST(self)
        admin = _admin_model(self.path)
        raw = self._read_body()         # drain-before-reply contract
        if admin is None:
            self._reply(404, {'error': 'not found', 'path': self.path})
            return
        mname, op = admin
        rs = getattr(self.server.front, 'replica', None)
        if rs is None:
            self._reply(503, {'error': 'no replica attached'})
            return
        try:
            if op == 'load':
                try:
                    spec = json.loads(raw or b'{}')
                except ValueError as e:
                    self._reply(400, {'error': 'bad request',
                                      'detail': str(e)})
                    return
                rs.load_model(mname, spec)
                self._reply(200, {'status': 'loaded', 'model': mname})
            elif op == 'delta':
                try:
                    spec = json.loads(raw or b'{}')
                except ValueError as e:
                    self._reply(400, {'error': 'bad request',
                                      'detail': str(e)})
                    return
                fp = rs.apply_delta(mname, spec)
                self._reply(200, {'status': 'delta', 'model': mname,
                                  'fp': fp})
            else:
                rs.unload_model(mname)
                self._reply(200, {'status': 'unloaded',
                                  'model': mname})
        except BudgetExceeded as e:
            self._reply(507, {'error': 'insufficient storage',
                              'model': mname,
                              'need_bytes': e.need_bytes,
                              'budget_bytes': e.budget_bytes})
        except (delta_mod.DeltaChainError,
                delta_mod.DeltaParityError) as e:
            # typed delta refusal: NOTHING was mutated/registered on
            # this replica — 409 tells the supervisor (and through it
            # the pusher) that a FULL push is required
            self._reply(409, {'error': 'delta refused',
                              'kind': 'parity' if isinstance(
                                  e, delta_mod.DeltaParityError)
                              else 'chain',
                              'model': mname, 'detail': str(e)})
        except MXNetError as e:
            msg = str(e)
            if 'already registered' in msg:
                # idempotent load: a supervisor retry after a lost
                # reply must not fail the push
                self._reply(200, {'status': 'already', 'model': mname})
            elif 'unknown model' in msg:
                self._reply(404, {'error': 'unknown model',
                                  'model': mname})
            else:
                self._reply(400, {'error': 'bad request',
                                  'detail': msg})


def _admin_model(path):
    """(name, op) from /v1/models/<name>:load|:unload|:delta, else
    None."""
    prefix = '/v1/models/'
    if not path.startswith(prefix):
        return None
    rest = path[len(prefix):]
    for op in ('load', 'unload', 'delta'):
        suffix = ':' + op
        if rest.endswith(suffix):
            name = rest[:-len(suffix)]
            if name and '/' not in name:
                return name, op
    return None


class ReplicaServer(object):
    """One serving replica: a ModelRegistry behind the admin-extended
    HTTP front.  `models` is a list of spec dicts::

        {'name': 'm', 'prefix': '/ckpt/m', 'epoch': 0,
         'input_shapes': {'data': [1, 784]},
         'deadline_ms': 20, 'priority': 1,          # optional SLO
         'max_batch': 8, 'max_wait_us': None}       # engine kwargs

    (tests may pass {'name': ..., 'loader': callable} instead of a
    prefix).  Models register lazily — weights load on first use, so
    a replica boots fast and warms from the exec cache.

    `ctx` is the device of the checkpoint loads (a Context or its
    string; default the calling thread's `with ctx:` context, else
    gpu(0)); a gpu context on a host without CUDA raises here.

    `tick_chunk` in a spec forwards to the registry (loader=
    sequence models only): a ContinuousEngine loader receives it and
    runs K ticks per dispatch, so a supervisor hot-swap lands on a
    chunked engine whose export/admit sequence migration halts at a
    chunk boundary (ContinuousEngine docs)."""

    _ENGINE_KEYS = ('max_batch', 'max_wait_us', 'batch_buckets',
                    'est_bytes', 'tick_chunk')

    def __init__(self, models=(), budget_bytes=None, host='127.0.0.1',
                 port=0, index=0, max_inflight=None, ctx=None):
        self.index = int(index)
        self._t0 = time.monotonic()
        self.ctx = _resolve_ctx(ctx)
        _check_device(self.ctx)
        self.registry = ModelRegistry(budget_bytes=budget_bytes,
                                      ctx=self.ctx)
        for spec in models or ():
            self.load_model(spec['name'], spec, warm=False)
        self.front = HttpFront(self.registry, host=host, port=port,
                               max_inflight=max_inflight,
                               handler_cls=_ReplicaHandler)
        self.front.replica = self

    @property
    def address(self):
        return self.front.address

    def start(self):
        self.front.start()
        return self

    def wedged(self):
        return replica_wedged(self.index,
                              time.monotonic() - self._t0)

    def load_model(self, name, spec, warm=True):
        """Register (and by default make resident) one model from a
        wire spec — the supervisor's hot-swap op."""
        slo = SLO(deadline_ms=spec.get('deadline_ms'),
                  priority=int(spec.get('priority', 0) or 0),
                  service_ms_hint=spec.get('service_ms_hint'))
        kwargs = {k: spec[k] for k in self._ENGINE_KEYS
                  if spec.get(k) is not None}
        if spec.get('loader') is not None:
            self.registry.register(name, loader=spec['loader'],
                                   slo=slo, **kwargs)
        else:
            shapes = {k: tuple(int(d) for d in v)
                      for k, v in dict(spec['input_shapes']).items()}
            self.registry.register(name, prefix=spec['prefix'],
                                   epoch=int(spec.get('epoch', 0)),
                                   input_shapes=shapes, slo=slo,
                                   **kwargs)
        if warm:
            self.registry.engine(name)
        return self

    def apply_delta(self, name, spec):
        """Admit candidate arm `name` by DELTA — the replica side of
        the pusher's delta channel.  The resident base arm's weights
        plus the pushed delta payload become the candidate's weights;
        the full export named by ``spec['prefix']`` is only read for
        its (tiny) symbol json — the params file is never opened,
        which is the byte saving.  All of delta.apply_delta's gates
        run first: a chain break (base fingerprint / crc mismatch) or
        a lossy-parity refusal raises the typed error with NOTHING
        registered, and the handler's 409 sends the pusher to its
        full-push fallback."""
        from .predictor import Predictor
        from . import symbol as sym_mod
        dspec = dict(spec.get('delta') or {})
        base = dspec.get('base')
        if not base:
            raise delta_mod.DeltaChainError(
                'delta push for %r names no base arm' % name)
        prefix = spec.get('prefix')
        if not prefix or not spec.get('input_shapes'):
            raise delta_mod.DeltaChainError(
                'delta push for %r needs prefix= and input_shapes= in '
                'the spec (loader-registered bases take full pushes)'
                % name)
        meta = dspec.get('meta') or {}
        arrays = delta_mod.read_delta_file(str(dspec.get('path')
                                               or ''))
        try:
            eng = self.registry.engine(base)
        except MXNetError as e:
            raise delta_mod.DeltaChainError(
                'delta base arm %r is not resident on replica %d (%s)'
                % (base, self.index, e))
        state = eng._resident_host_state()
        tol = dspec.get('parity_tol')
        if tol is None:
            tol = delta_mod.DeltaConfig().parity_tol
        # expect_fp: the RESIDENT state's true fingerprint — a replica
        # whose base diverged from the encoder's chain (quantized
        # resident form, missed promote, fresh respawn mid-chain)
        # refuses here instead of serving silently wrong weights
        new_state = delta_mod.apply_delta(
            state, meta, arrays,
            expect_fp=delta_mod.fingerprint(state),
            parity_tol=float(tol))
        args = {n[len('arg:'):]: v for n, v in new_state.items()
                if n.startswith('arg:')}
        auxs = {n[len('aux:'):]: v for n, v in new_state.items()
                if n.startswith('aux:')}
        sym = sym_mod.load('%s-symbol.json' % prefix)
        shapes = {k: tuple(int(d) for d in v)
                  for k, v in dict(spec['input_shapes']).items()}
        slo = SLO(deadline_ms=spec.get('deadline_ms'),
                  priority=int(spec.get('priority', 0) or 0),
                  service_ms_hint=spec.get('service_ms_hint'))
        kwargs = {k: spec[k] for k in self._ENGINE_KEYS
                  if spec.get(k) is not None}

        def loader(_sym=sym, _a=args, _x=auxs, _s=shapes, _c=self.ctx):
            return Predictor(symbol=_sym, arg_params=_a, aux_params=_x,
                             input_shapes=_s, ctx=_c)
        self.registry.register(name, loader=loader, slo=slo, **kwargs)
        self.registry.engine(name)      # warm: never route cold
        profiler.add_delta_stats(applied=1)
        return meta.get('new_fp')

    def unload_model(self, name):
        self.registry.unregister(name)
        return self

    def warm_all(self):
        """Make every registered model resident + AOT-warmed.  The
        subprocess entry runs this BEFORE announcing its port: a
        replica must never enter the routing pool cold — lazy first-
        request loads would inject ~100ms outliers into the canary
        windows and the fleet's tail latency right after a restart."""
        for name in self.registry.models():
            self.registry.engine(name)
        return self

    def close(self):
        self.front.close()
        self.registry.close()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def run_replica(config, index=0, out=None):
    """Subprocess replica entrypoint: serve `config` until SIGTERM/
    SIGINT, announcing the bound port as 'MXTPU_REPLICA_PORT=<port>'
    on stdout (the supervisor's spawn handshake).  Installs the
    injected-crash timer (MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S).
    config['ctx'] is the device's context string (default gpu(0)); a
    replica that cannot reach it raises before the handshake."""
    out = out or sys.stdout
    rs = ReplicaServer(models=config.get('models', ()),
                       budget_bytes=config.get('budget_bytes'),
                       host=config.get('host', '127.0.0.1'),
                       index=index, ctx=config.get('ctx')).start()
    if config.get('warm_at_boot', True):
        rs.warm_all()                   # never enter the pool cold
    host, port = rs.address
    out.write('MXTPU_REPLICA_PORT=%d\n' % port)
    out.flush()
    k = replica_kill_after_s(index)
    if k is not None:
        t = threading.Timer(k, lambda: os._exit(17))
        t.daemon = True
        t.start()
    stop = threading.Event()
    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, lambda *_: stop.set())
    stop.wait()
    rs.close()


def _replica_main():
    cfg = json.loads(
        os.environ.get('MXNET_TPU_FLEET_REPLICA_CONFIG', '{}') or '{}')
    idx = int(os.environ.get('MXNET_TPU_FLEET_REPLICA_INDEX', '0'))
    run_replica(cfg, index=idx)


# ---------------------------------------------------------------------------
# scale policy (pure decision from the counter windows)
# ---------------------------------------------------------------------------

class ScalePolicy(object):
    """Hysteresis over the fleet's counter-window observations: a
    sustained hot signal (p99 over the SLO deadline, or backlog at/
    above `backlog_hot` rows) for `up_after` consecutive windows asks
    for +1 replica; a sustained fully-idle fleet (no requests, no
    backlog) for `down_after` windows asks for -1.  Any mixed window
    resets both streaks — one throttle spike never flips the fleet."""

    def __init__(self, up_after=3, down_after=10, backlog_hot=64):
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.backlog_hot = int(backlog_hot)
        self._hot = 0
        self._idle = 0

    def decide(self, obs):
        """obs: {'p99_over_deadline': bool, 'backlog_rows': int,
        'requests_delta': int} -> +1 (spawn), -1 (retire), 0."""
        backlog = int(obs.get('backlog_rows', 0))
        hot = bool(obs.get('p99_over_deadline')) or \
            backlog >= self.backlog_hot
        idle = not hot and backlog == 0 and \
            int(obs.get('requests_delta', 0)) == 0
        if hot:
            self._hot += 1
            self._idle = 0
        elif idle:
            self._idle += 1
            self._hot = 0
        else:
            self._hot = self._idle = 0
        if self._hot >= self.up_after:
            self._hot = 0
            return 1
        if self._idle >= self.down_after:
            self._idle = 0
            return -1
        return 0


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class _RouterHandler(_FleetHandler):
    """The fleet's public handler: /healthz, /statsz, and proxied
    predicts.  Reuses _FleetHandler's reply/drain plumbing but never
    touches a registry — everything goes through server.router."""

    def do_GET(self):
        router = self.server.router
        if self.path == '/healthz':
            n = len(router.backends())
            if router.closed or n == 0:
                self._reply(503, {'status': 'no-live-replicas',
                                  'backends': n})
            else:
                self._reply(200, {'status': 'ok', 'backends': n})
        elif self.path == '/statsz':
            self._reply(200, router.statsz())
        else:
            self._reply(404, {'error': 'not found', 'path': self.path})

    def do_POST(self):
        router = self.server.router
        raw = self._read_body()         # drain-before-reply contract
        name = _predict_model(self.path)
        if name is None:
            self._reply(404, {'error': 'not found', 'path': self.path})
            return
        idempotent = self.headers.get('X-Mxtpu-Non-Idempotent',
                                      '') != '1'
        status, body, hdrs = router.dispatch(name, raw,
                                             idempotent=idempotent)
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


class FleetRouter(object):
    """Routes `/v1/models/<name>:predict` across live replicas with
    retry-on-replica-death, fast 503s for a dead fleet, and the
    continuous-deployment state (canary split / shadow tee).  Backend
    membership is owned by the FleetSupervisor (or tests) via
    add_backend/remove_backend; `deadlines` maps public model names to
    their SLO deadline_ms — the retry budget for that model's
    requests."""

    def __init__(self, host='127.0.0.1', port=0, deadlines=None,
                 on_event=None):
        self._lock = threading.Lock()
        self._backends = []             # [{'id','host','port'}]
        self._rr = 0
        self._req_mark = 0
        self._deadline_ms = dict(deadlines or {})
        self._alias = {}                # public name -> served arm
        self._canary = {}               # public name -> canary state
        self._reqlog = {}               # public name -> deque of bodies
        self._lat_w = {}                # public name -> deque of ms
        self._n_requests = 0
        self._n_retries = 0
        self._n_503 = 0
        self.on_event = on_event        # (kind, name, info) callback
        self.extra_stats = None         # merged into /statsz
        self._closed = False
        self._shadow_q = deque()
        self._shadow_busy = False
        self._shadow_cond = threading.Condition()
        self._shadow_thread = threading.Thread(
            target=self._shadow_loop, name='mxtpu-fleet-shadow',
            daemon=True)
        self._shadow_thread.start()
        self._server = _FleetHTTPServer((host, int(port)),
                                        _RouterHandler)
        self._server.router = self
        self._thread = None

    # -- membership -----------------------------------------------------
    @property
    def address(self):
        return self._server.server_address[:2]

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name='mxtpu-fleet-router', daemon=True)
            self._thread.start()
        return self

    def add_backend(self, bid, host, port):
        with self._lock:
            self._backends = [b for b in self._backends
                              if b['id'] != bid] + \
                [{'id': bid, 'host': host, 'port': int(port)}]
        return self

    def remove_backend(self, bid):
        with self._lock:
            self._backends = [b for b in self._backends
                              if b['id'] != bid]
        return self

    def backends(self):
        with self._lock:
            return list(self._backends)

    def set_deadline(self, name, deadline_ms):
        with self._lock:
            self._deadline_ms[name] = deadline_ms

    # -- dispatch -------------------------------------------------------
    def dispatch(self, name, raw, idempotent=True):
        """Proxy one predict body.  Returns (status, body_bytes,
        extra_headers).  Never hangs: bounded by the model's SLO
        deadline (or the proxy-timeout knob), and a fully-dead fleet
        answers a fast typed 503."""
        profiler.add_fleet_supervisor_stats(router_requests=1)
        with self._lock:
            self._n_requests += 1
        arm, is_canary = self._pick_arm(name)
        deadline_ms = self._deadline_ms.get(name)
        budget_s = (deadline_ms / 1e3) if deadline_ms \
            else proxy_timeout_s()
        t_end = time.monotonic() + budget_s
        tried = set()
        path = '/v1/models/%s:predict' % arm
        while True:
            b = self._pick_backend(exclude=tried)
            left = t_end - time.monotonic()
            if b is None or left <= 0:
                return self._unavailable(
                    name, 'no live replicas' if not tried else
                    ('deadline exhausted after %d attempt(s)'
                     % len(tried)) if left <= 0 else
                    'all replicas failed')
            tried.add(b['id'])
            t0 = time.perf_counter()
            try:
                status, hdrs, body = self._proxy(
                    b, path, raw, timeout=min(left, proxy_timeout_s()))
            except _NotDelivered as e:
                # never reached a replica: ALWAYS safe to redispatch
                self._note_backend_error(b, e)
                with self._lock:
                    self._n_retries += 1
                profiler.add_fleet_supervisor_stats(router_retries=1)
                continue
            except _MaybeExecuted as e:
                # transport failure, NOT a model answer: recording it
                # into the canary windows would let an unrelated
                # replica crash mid-push fake an error-rate regression
                # and roll back a healthy candidate (the retried
                # request records its real outcome once, below)
                self._note_backend_error(b, e)
                if not idempotent:
                    # the replica may have executed the submit: a
                    # redispatch could double-execute — fail typed
                    # instead, within the deadline
                    return 502, json.dumps(
                        {'error': 'replica failed mid-request',
                         'model': name, 'retriable': False,
                         'detail': str(e)}).encode(), {}
                with self._lock:
                    self._n_retries += 1
                profiler.add_fleet_supervisor_stats(router_retries=1)
                continue
            lat_ms = (time.perf_counter() - t0) * 1e3
            if status == 404:
                if self._arm_stale(name, arm, is_canary):
                    # the deploy state moved while this request was in
                    # flight (promote flipped the alias / rollback
                    # cleared the canary) and the replica already
                    # unloaded the superseded arm: re-resolve and
                    # retry — returning the 404 would LOSE an accepted
                    # request across every hot-swap
                    arm, is_canary = self._pick_arm(name)
                    path = '/v1/models/%s:predict' % arm
                    tried.clear()
                    with self._lock:
                        self._n_retries += 1
                    profiler.add_fleet_supervisor_stats(
                        router_retries=1)
                    continue
                if is_canary:
                    # THIS backend does not serve the (current)
                    # candidate arm — e.g. its :load timed out during
                    # the push fan-out.  Recording it here would let
                    # ONE lagging replica's 404s fake an error-rate
                    # regression and roll back a healthy candidate, so
                    # try another backend first.  Only when EVERY
                    # backend 404'd is the miss recorded as a
                    # candidate failure (a candidate served NOWHERE —
                    # its loaders all died — must still accumulate
                    # samples, or the canary never decides, the push
                    # stays pending forever and the pusher silently
                    # skips every future commit); the request itself
                    # falls back to the stable arm either way
                    with self._lock:
                        self._n_retries += 1
                        remaining = [bb for bb in self._backends
                                     if bb['id'] not in tried]
                    profiler.add_fleet_supervisor_stats(
                        router_retries=1)
                    if not remaining:
                        self._record_arm(name, True, lat_ms, ok=False)
                        self._maybe_decide(name)
                        arm = self.stable_arm(name)
                        is_canary = False
                        path = '/v1/models/%s:predict' % arm
                        tried.clear()
                    continue
            # canary health: 5xx is a failure, and so are 429 (the
            # arm sheds — a candidate that cannot serve within its
            # SLO would otherwise log fast "healthy" samples and get
            # PROMOTED) and, for the STABLE arm, 404 (model truly
            # unknown; canary-arm 404s retry above instead).  Other
            # 4xx are the client's fault and arm-independent.
            self._record_arm(name, is_canary, lat_ms,
                             ok=status < 500 and
                             status not in (404, 429))
            if is_canary:
                self._maybe_decide(name)
            elif status == 200:
                self._log_and_tee(name, raw, body)
            out_hdrs = {}
            if 'Retry-After' in hdrs:
                out_hdrs['Retry-After'] = hdrs['Retry-After']
            return status, body, out_hdrs

    def _unavailable(self, name, why):
        with self._lock:
            self._n_503 += 1
        profiler.add_fleet_supervisor_stats(router_503=1)
        return 503, json.dumps({'error': 'fleet unavailable',
                                'model': name,
                                'detail': why}).encode(), \
            {'Retry-After': '1'}

    def _proxy(self, backend, path, raw, timeout):
        conn = http.client.HTTPConnection(backend['host'],
                                          backend['port'],
                                          timeout=max(0.05, timeout))
        try:
            try:
                conn.connect()
            except (OSError, socket.timeout) as e:
                raise _NotDelivered(e)
            try:
                conn.request('POST', path, raw,
                             {'Content-Type': 'application/json'})
                resp = conn.getresponse()
                body = resp.read()
                return resp.status, dict(resp.getheaders()), body
            except (OSError, socket.timeout,
                    http.client.HTTPException) as e:
                raise _MaybeExecuted(e)
        finally:
            conn.close()

    def _pick_backend(self, exclude=()):
        with self._lock:
            cands = [b for b in self._backends
                     if b['id'] not in exclude]
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    def _note_backend_error(self, backend, err):
        if self.on_event is not None:
            try:
                self.on_event('backend_error', backend['id'],
                              {'error': str(err)})
            except Exception:           # observer must not break serve
                logging.exception('fleet router: on_event failed')

    # -- per-model windows (scaling + canary signals) -------------------
    def _record_arm(self, name, is_canary, lat_ms, ok):
        with self._lock:
            w = self._lat_w.get(name)
            if w is None:
                w = self._lat_w[name] = deque(maxlen=256)
            w.append((time.monotonic(), lat_ms))
            c = self._canary.get(name)
            if c is not None and c['state'] == 'running':
                (c['cand_w'] if is_canary
                 else c['stable_w']).append((lat_ms, ok))

    def latency_p99_ms(self, name):
        """Scaling-signal p99 over the RECENT window only (samples
        within LATENCY_WINDOW_S): the deque is request-driven, and
        peak-era samples surviving into a low-traffic period would
        read as a hot fleet for hours."""
        horizon = time.monotonic() - latency_window_s()
        with self._lock:
            w = [l for t, l in self._lat_w.get(name, ())
                 if t >= horizon]
        return float(np.percentile(w, 99)) if w else 0.0

    def requests_delta(self):
        """Total proxied requests since the previous call — the scale
        loop's idle signal."""
        with self._lock:
            n = self._n_requests
            delta = n - self._req_mark
            self._req_mark = n
        return delta

    # -- canary / shadow ------------------------------------------------
    def start_canary(self, name, candidate, frac=None, mode='canary'):
        """Open a canary split (or shadow tee) for `name`: `frac` of
        traffic (canary mode) goes to the `candidate` arm, everything
        else to the stable arm; per-arm windows feed auto-rollback /
        auto-promote.  Shadow mode serves 100% stable and tees logged
        bodies to the candidate asynchronously."""
        if mode not in ('canary', 'shadow'):
            raise MXNetError('canary mode must be canary|shadow')
        with self._lock:
            self._canary[name] = {
                'candidate': candidate,
                'frac': canary_frac() if frac is None else float(frac),
                'mode': mode, 'acc': 0.0, 'state': 'running',
                'stable_w': deque(maxlen=512),
                'cand_w': deque(maxlen=512),
                'shadow_requests': 0, 'shadow_divergences': 0,
                'started': time.time(),
            }
        profiler.add_fleet_supervisor_stats(canary_pushes=1)
        return self

    def _pick_arm(self, name):
        with self._lock:
            stable = self._alias.get(name, name)
            c = self._canary.get(name)
            if c is not None and c['state'] == 'running' and \
                    c['mode'] == 'canary' and c['frac'] > 0:
                c['acc'] += c['frac']
                if c['acc'] >= 1.0:
                    c['acc'] -= 1.0
                    return c['candidate'], True
            return stable, False

    def stable_arm(self, name):
        with self._lock:
            return self._alias.get(name, name)

    def _arm_stale(self, name, arm, was_canary):
        """True when `arm` is no longer what `name` resolves to — the
        request raced a promote (alias flipped, old stable unloading)
        or a rollback (canary cleared, candidate unloading).  A 404
        for a STALE arm is a transition artifact to retry, not an
        answer; a 404 for the CURRENT arm is a real unknown-model."""
        with self._lock:
            if was_canary:
                c = self._canary.get(name)
                return c is None or c['state'] != 'running' or \
                    c['candidate'] != arm
            return self._alias.get(name, name) != arm

    def _maybe_decide(self, name):
        with self._lock:
            c = self._canary.get(name)
            if c is None or c['state'] != 'running':
                return
            decision = self._decide_locked(c)
            if decision is None:
                return
            c['state'] = 'rolled_back' if decision == 'rollback' \
                else 'promoted'
            c['decided'] = time.time()
            candidate = c['candidate']
            old_stable = self._alias.get(name, name)
            if decision == 'promote':
                self._alias[name] = candidate
        report = self.canary_report(name)
        if decision == 'rollback':
            profiler.add_fleet_supervisor_stats(canary_rollbacks=1)
            self._async_unload(candidate)
        else:
            profiler.add_fleet_supervisor_stats(canary_promotions=1)
            self._async_unload(old_stable)
        if self.on_event is not None:
            try:
                self.on_event(decision, name,
                              {'candidate': candidate,
                               'report': report})
            except Exception:
                logging.exception('fleet router: on_event failed')

    def _decide_locked(self, c):
        cand = list(c['cand_w'])
        n = len(cand)
        if n < canary_min_samples():
            return None
        errs = sum(1 for _l, ok in cand if not ok) / float(n)
        if errs > canary_err_frac():
            return 'rollback'
        stable = [l for l, ok in c['stable_w'] if ok]
        if stable:
            lats = [l for l, _ in cand]
            f = canary_regress_factor()
            # judge BOTH tails: p99 is the SLO-facing signal, but a
            # single cold-start/throttle outlier in the small stable
            # window inflates its p99 to ~max and would mask a real
            # regression — the median ratio is robust to that (a true
            # degrade shifts the whole distribution, an outlier
            # doesn't), so either tripping rolls back
            c50 = float(np.percentile(lats, 50))
            s50 = max(0.5, float(np.percentile(stable, 50)))
            c99 = float(np.percentile(lats, 99))
            s99 = max(1.0, float(np.percentile(stable, 99)))
            if c50 > f * s50 or c99 > f * s99:
                return 'rollback'
        if n >= canary_promote_samples():
            return 'promote'
        return None

    def canary_report(self, name):
        """Per-arm window snapshot for `name`'s canary (None when no
        push is active) — also embedded in /statsz."""
        with self._lock:
            c = self._canary.get(name)
            if c is None:
                return None
            cand = list(c['cand_w'])
            stable = list(c['stable_w'])
            out = {'candidate': c['candidate'], 'mode': c['mode'],
                   'state': c['state'], 'frac': c['frac'],
                   'cand_samples': len(cand),
                   'stable_samples': len(stable),
                   'shadow_requests': c['shadow_requests'],
                   'shadow_divergences': c['shadow_divergences']}
        for key, w in (('cand', cand), ('stable', stable)):
            lats = [l for l, _ in w]
            out[key + '_p50_ms'] = round(
                float(np.percentile(lats, 50)), 3) if lats else 0.0
            out[key + '_p99_ms'] = round(
                float(np.percentile(lats, 99)), 3) if lats else 0.0
            out[key + '_err_frac'] = round(
                sum(1 for _l, ok in w if not ok) / float(len(w)),
                4) if w else 0.0
        return out

    def promote(self, name):
        """Manually promote an active canary/shadow candidate (the
        shadow mode never auto-promotes — its divergence report is
        advisory)."""
        with self._lock:
            c = self._canary.get(name)
            if c is None or c['state'] != 'running':
                raise MXNetError('no running canary for %r' % name)
            c['state'] = 'promoted'
            candidate = c['candidate']
            old_stable = self._alias.get(name, name)
            self._alias[name] = candidate
        profiler.add_fleet_supervisor_stats(canary_promotions=1)
        self._async_unload(old_stable)
        if self.on_event is not None:
            try:
                self.on_event('promote', name,
                              {'candidate': candidate,
                               'report': self.canary_report(name)})
            except Exception:
                logging.exception('fleet router: on_event failed')
        return self

    def clear_canary(self, name, unload=True):
        """Abort an active push (counts as a rollback when it was
        still running)."""
        with self._lock:
            c = self._canary.get(name)
            if c is None:
                return self
            was_running = c['state'] == 'running'
            c['state'] = 'rolled_back' if was_running else c['state']
            candidate = c['candidate']
        if was_running:
            profiler.add_fleet_supervisor_stats(canary_rollbacks=1)
            if unload:
                self._async_unload(candidate)
            # the supervisor must learn of the abort too, or its
            # _pending entry goes stale: future push() calls refuse
            # forever and every respawned replica keeps loading the
            # dead candidate arm
            if self.on_event is not None:
                try:
                    self.on_event('rollback', name,
                                  {'candidate': candidate,
                                   'report': self.canary_report(name)})
                except Exception:
                    logging.exception('fleet router: on_event failed')
        return self

    def _async_unload(self, arm):
        """Best-effort: drop a superseded arm from every backend (the
        supervisor keeps the desired set for future spawns)."""
        backends = self.backends()

        def work():
            for b in backends:
                try:
                    _http_json('POST', b['host'], b['port'],
                               '/v1/models/%s:unload' % arm,
                               payload={}, timeout=10.0)
                except (OSError, http.client.HTTPException):
                    pass

        threading.Thread(target=work, name='mxtpu-fleet-unload',
                         daemon=True).start()

    # -- shadow tee -----------------------------------------------------
    def _log_and_tee(self, name, raw, stable_body):
        cap = request_log_cap()
        if cap <= 0:
            return
        with self._lock:
            log = self._reqlog.get(name)
            if log is None or log.maxlen != cap:
                log = self._reqlog[name] = deque(log or (), maxlen=cap)
            log.append(raw)
            c = self._canary.get(name)
            tee = c is not None and c['state'] == 'running' and \
                c['mode'] == 'shadow'
        if tee:
            with self._shadow_cond:
                if len(self._shadow_q) < 4 * cap:   # bounded: drop
                    self._shadow_q.append(
                        (name, raw, stable_body))
                    self._shadow_cond.notify()

    def _shadow_loop(self):
        while True:
            with self._shadow_cond:
                while not self._shadow_q and not self._closed:
                    self._shadow_cond.wait(0.2)
                if self._closed and not self._shadow_q:
                    return
                if not self._shadow_q:
                    continue
                name, raw, stable_body = self._shadow_q.popleft()
                self._shadow_busy = True
            try:
                with self._lock:
                    c = self._canary.get(name)
                    candidate = c['candidate'] if c is not None \
                        else None
                b = self._pick_backend()
                if candidate is None or b is None:
                    continue
                try:
                    status, _h, body = self._proxy(
                        b, '/v1/models/%s:predict' % candidate, raw,
                        timeout=proxy_timeout_s())
                    diverged = status != 200 or \
                        not _outputs_close(stable_body, body)
                except (_NotDelivered, _MaybeExecuted):
                    # transport failure: the candidate was never
                    # consulted — counting a divergence here would let
                    # a restarting replica discredit an identical-
                    # weights candidate (same principle as the canary
                    # windows and replay(): transport is not a model
                    # answer)
                    continue
                profiler.add_fleet_supervisor_stats(
                    shadow_requests=1,
                    shadow_divergences=1 if diverged else 0)
                with self._lock:
                    c = self._canary.get(name)
                    if c is not None:
                        c['shadow_requests'] += 1
                        if diverged:
                            c['shadow_divergences'] += 1
            finally:
                with self._shadow_cond:
                    self._shadow_busy = False
                    self._shadow_cond.notify_all()

    def shadow_drain(self, timeout=30.0):
        """Block until the shadow tee queue is empty AND the worker
        has finished its in-flight item (tests/bench)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._shadow_cond:
                if not self._shadow_q and not self._shadow_busy:
                    return True
            time.sleep(0.01)
        return False

    def replay(self, name, arm=None):
        """Replay `name`'s logged bodies against `arm` (default: the
        active candidate) AND the stable arm, comparing outputs.
        Returns {'replayed': n, 'divergences': d}."""
        with self._lock:
            bodies = list(self._reqlog.get(name, ()))
            c = self._canary.get(name)
            if arm is None:
                if c is None:
                    raise MXNetError('replay(%r): no candidate arm '
                                     'active and none given' % name)
                arm = c['candidate']
            stable = self._alias.get(name, name)
        replayed = divergences = 0
        for raw in bodies:
            b = self._pick_backend()
            if b is None:
                break
            try:
                s1, _h1, body1 = self._proxy(
                    b, '/v1/models/%s:predict' % stable, raw,
                    timeout=proxy_timeout_s())
                b2 = self._pick_backend() or b
                s2, _h2, body2 = self._proxy(
                    b2, '/v1/models/%s:predict' % arm, raw,
                    timeout=proxy_timeout_s())
            except (_NotDelivered, _MaybeExecuted):
                continue
            replayed += 1
            if s1 != 200 or s2 != 200 or \
                    not _outputs_close(body1, body2):
                divergences += 1
        profiler.add_fleet_supervisor_stats(
            shadow_requests=replayed, shadow_divergences=divergences)
        return {'replayed': replayed, 'divergences': divergences}

    # -- observability / lifecycle --------------------------------------
    def stats(self):
        with self._lock:
            return {'requests': self._n_requests,
                    'retries': self._n_retries,
                    'unavailable_503': self._n_503,
                    'backends': [b['id'] for b in self._backends]}

    def statsz(self):
        with self._lock:                # promote mutates _alias under
            aliases = dict(self._alias)  # the lock; copy under it too
            names = list(self._canary)
        out = {'router': self.stats(),
               'aliases': aliases,
               'fleet_supervisor': profiler.fleet_supervisor_stats()}
        canary = {}
        for n in names:
            r = self.canary_report(n)
            if r is not None:
                canary[n] = r
        out['canary'] = canary
        if self.extra_stats is not None:
            try:
                out['supervisor'] = self.extra_stats()
            except Exception as e:
                out['supervisor'] = {'error': str(e)}
        return out

    @property
    def closed(self):
        return self._closed

    def close(self):
        if self._closed:
            return self
        self._closed = True
        with self._shadow_cond:
            self._shadow_cond.notify_all()
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()
        self._shadow_thread.join(timeout=5)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _outputs_close(body_a, body_b, rtol=None):
    """Compare two predict response bodies' 'outputs' numerically
    (the shadow divergence test).  Shape/parse mismatch = divergent."""
    try:
        a = json.loads(body_a)['outputs']
        b = json.loads(body_b)['outputs']
        if len(a) != len(b):
            return False
        tol = shadow_rtol() if rtol is None else rtol
        for u, v in zip(a, b):
            ua, va = np.asarray(u, np.float64), np.asarray(v,
                                                           np.float64)
            if ua.shape != va.shape or \
                    not np.allclose(ua, va, rtol=tol, atol=tol):
                return False
        return True
    except (ValueError, KeyError, TypeError):
        return False


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class _Replica(object):
    __slots__ = ('index', 'gen', 'proc', 'host', 'port', 'last_ok',
                 'spawned_at', 'restart_times', 'next_attempt',
                 'backoff', 'cfg_names')

    def __init__(self, index, gen=0):
        self.index = index
        self.gen = gen                  # spawn generation: a respawn
        self.proc = None                # gets a FRESH router id, so a
        self.host = None                # request that excluded the
        self.port = None                # dead incarnation can still
        self.last_ok = 0.0              # reach the recovered one
        self.spawned_at = 0.0
        self.restart_times = deque()    # restart-budget window
        self.next_attempt = 0.0         # respawn backoff schedule
        self.backoff = 0.0
        self.cfg_names = ()             # arm names in the spawn config

    @property
    def bid(self):
        return 'r%dg%d' % (self.index, self.gen)


class FleetSupervisor(object):
    """Spawns, health-checks, restarts, and scales a localhost replica
    fleet behind a FleetRouter, and drives continuous deployment
    (canary push / shadow replay) across it.

    Parameters
    ----------
    models : list of spec dicts (see ReplicaServer)
        The desired model set every replica serves.  Each needs a
        `prefix` checkpoint loader (replicas are separate processes —
        live objects cannot cross).
    replicas : int
        Initial fleet size (also min unless min_replicas given).
    autoscale : bool
        Drive spawn/retire from the ScalePolicy over the counter
        windows (p99-vs-deadline at the router, backlog from /statsz).
    ctx : Context or str, optional
        The replicas' device (default the calling thread's `with ctx:`
        context, else gpu(0)); a replica that cannot reach it fails its
        spawn.
    """

    def __init__(self, models, replicas=2, host='127.0.0.1',
                 router_port=0, budget_bytes=None, autoscale=False,
                 min_replicas=None, max_replicas=None, python=None,
                 env=None, scale_policy=None, ctx=None):
        if not models:
            raise MXNetError('FleetSupervisor needs at least one '
                             'model spec')
        self._models = {}
        for m in models:
            spec = dict(m)
            spec['serve_name'] = spec['name']
            self._models[spec['name']] = spec
        self.n_replicas = int(replicas)
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else max(1, self.n_replicas // 2))
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else 2 * self.n_replicas)
        self.host = host
        self.budget_bytes = budget_bytes
        self.ctx = _resolve_ctx(ctx)
        self.autoscale = bool(autoscale)
        self._python = python or sys.executable
        self._env = dict(env or {})
        self._policy = scale_policy or ScalePolicy()
        self._lock = threading.Lock()
        self._replicas = []             # live _Replica objects
        self._dead_pending = []         # awaiting backoff respawn
        self._next_index = 0
        self._spawn_gen = 0
        self._pending = {}              # public name -> candidate spec
        self._push_seq = 0
        self._verdict_cbs = []          # PushVerdict listeners
        self._stop = threading.Event()
        self._loop_thread = None
        self._started = False
        self._n_restarts = 0
        self._n_retired = 0
        self._abandoned = 0
        self.router = FleetRouter(
            host=host, port=router_port,
            deadlines={m['name']: m.get('deadline_ms')
                       for m in models if m.get('deadline_ms')},
            on_event=self._on_router_event)
        self.router.extra_stats = self._sup_stats

    # -- lifecycle ------------------------------------------------------
    def start(self):
        """Spawn the initial fleet (in parallel), start the router and
        the health/scale loop."""
        if self._started:
            return self
        self._started = True
        procs = [self._spawn_proc(self._take_index())
                 for _ in range(self.n_replicas)]
        try:
            for rep in procs:
                self._finish_spawn(rep)
        except BaseException:
            # a failed handshake must not orphan the siblings that
            # already spawned (they are separate OS processes — only
            # this list knows about them yet) nor latch _started
            for rep in procs:
                if rep.proc is not None and rep.proc.poll() is None:
                    try:
                        rep.proc.kill()
                    except OSError:
                        pass
            with self._lock:
                reps, self._replicas = self._replicas, []
            for r in reps:
                self.router.remove_backend(r.bid)
            profiler.add_fleet_supervisor_stats(replicas_live=0)
            self._started = False
            raise
        self.router.start()
        self._loop_thread = threading.Thread(
            target=self._loop, name='mxtpu-fleet-supervisor',
            daemon=True)
        self._loop_thread.start()
        return self

    def _take_index(self):
        with self._lock:
            i = self._next_index
            self._next_index += 1
        return i

    def _replica_config(self):
        """The wire config a fresh replica serves: every desired
        model under its CURRENT arm name, plus any active push's
        candidate (a new replica must be able to answer canary-arm
        traffic)."""
        specs = []
        with self._lock:
            for m in self._models.values():
                spec = {k: v for k, v in m.items()
                        if k not in ('name', 'serve_name')}
                spec['name'] = m['serve_name']
                specs.append(spec)
            for cand in self._pending.values():
                specs.append(dict(cand))
        return {'models': specs, 'budget_bytes': self.budget_bytes,
                'host': self.host, 'ctx': str(self.ctx)}

    def _spawn_proc(self, index):
        """Start one replica subprocess (non-blocking half)."""
        with self._lock:
            self._spawn_gen += 1
            gen = self._spawn_gen
        rep = _Replica(index, gen=gen)
        env = dict(os.environ)
        env.update(self._env)
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env['PYTHONPATH'] = pkg_parent + os.pathsep + \
            env.get('PYTHONPATH', '')
        config = self._replica_config()
        rep.cfg_names = tuple(m['name'] for m in config['models'])
        env['MXNET_TPU_FLEET_REPLICA_CONFIG'] = json.dumps(config)
        env['MXNET_TPU_FLEET_REPLICA_INDEX'] = str(index)
        # -c (not -m): runpy would import the module a second time
        # under __main__ after the package import already loaded it
        rep.proc = subprocess.Popen(
            [self._python, '-c',
             'from mxnet_tpu_torch.fleet_supervisor import _replica_main; '
             '_replica_main()'],
            env=env, stdout=subprocess.PIPE, text=True)
        rep.spawned_at = time.monotonic()
        return rep

    def _finish_spawn(self, rep):
        """Blocking half: wait for the port handshake, register the
        replica with the router.  The handshake read happens on a
        side thread so the SPAWN_TIMEOUT_S deadline is enforced even
        against a replica that hangs during boot WITHOUT printing or
        exiting — a bare readline() would block this (single)
        supervisor loop thread forever and stop fleet-wide health
        probing."""
        deadline = rep.spawned_at + spawn_timeout_s()
        holder = {}
        got = threading.Event()

        def read_port():
            while True:
                line = rep.proc.stdout.readline()
                if not line:
                    break               # EOF: process died
                if line.startswith('MXTPU_REPLICA_PORT='):
                    holder['port'] = int(line.strip().split('=', 1)[1])
                    break
            got.set()

        threading.Thread(target=read_port, daemon=True).start()
        got.wait(timeout=max(0.1, deadline - time.monotonic()))
        port = holder.get('port')
        if port is None:
            try:
                rep.proc.kill()         # also unblocks the reader
            except OSError:
                pass
            raise MXNetError(
                'fleet replica %d failed to start within %.0fs '
                '(exit code %s)' % (rep.index, spawn_timeout_s(),
                                    rep.proc.poll()))
        # keep draining the child's stdout so the pipe never fills
        t = threading.Thread(target=_drain, args=(rep.proc.stdout,),
                             daemon=True)
        t.start()
        rep.host, rep.port = self.host, port
        rep.last_ok = time.monotonic()
        # membership FIRST (under the lock, refusing when stop() has
        # begun — a respawn finishing after stop()'s sweep would leak
        # a live process forever), THEN reconcile, THEN routing:
        #
        #  * a push can resolve (rollback/promote) while this replica
        #    was booting with the spawn-time arm set baked into its
        #    config — the reconcile drops arms the desired set no
        #    longer names and loads arms it missed;
        #  * appending to _replicas BEFORE computing `desired` closes
        #    the push() race: a push that lands after the append sees
        #    this replica in replicas() and loads the candidate
        #    itself (the :load op is idempotent — 'already' — so both
        #    sides doing it is fine), one that landed before is in
        #    _pending and therefore in `desired`;
        #  * add_backend comes LAST so the router never routes
        #    canary-arm traffic to a replica that has not reconciled
        #    yet (its 404s would be recorded as candidate failures
        #    and could roll back a healthy push).
        with self._lock:
            if self._stop.is_set():
                try:
                    rep.proc.kill()
                except OSError:
                    pass
                raise MXNetError('fleet supervisor stopping: replica '
                                 '%d spawn abandoned' % rep.index)
            self._replicas.append(rep)
            live = len(self._replicas)
            desired = self._desired_arms_locked()
        self._reconcile(self.host, port, rep.cfg_names, desired=desired)
        # second, cheap pass against the LIVE desired set: a push can
        # resolve (rollback/promote) during the first pass's :load
        # calls, and the superseded arm's _async_unload only reaches
        # POOLED backends — without this, a rolled-back candidate
        # stays resident on the booting replica forever (arm names
        # are never reused), wasting registry budget
        self._reconcile(self.host, port, tuple(desired))
        self.router.add_backend(rep.bid, rep.host, rep.port)
        profiler.add_fleet_supervisor_stats(replica_spawns=1,
                                            replicas_live=live)
        logging.info('fleet supervisor: replica %d up on %s:%d',
                     rep.index, rep.host, rep.port)
        return rep

    def _desired_arms_locked(self):
        """arm name -> wire spec of everything a replica must serve
        RIGHT NOW: the desired model set under its current arm names
        plus any active push's candidate.  Caller holds self._lock."""
        desired = {}
        for m in self._models.values():
            desired[m['serve_name']] = {
                k: v for k, v in m.items()
                if k not in ('name', 'serve_name', 'tag')}
        for c in self._pending.values():
            desired[c['name']] = {k: v for k, v in c.items()
                                  if k not in ('name', 'tag')}
        return desired

    def _reconcile(self, host, port, cfg_names, desired=None):
        """Converge one replica to the fleet's INTENDED model set: drop
        arms the desired set no longer names, load arms it misses.
        Runs on every spawn/respawn BEFORE the replica enters the
        routing pool — the replica-respawn-vs-push race closer: a push
        can start, resolve (promote/rollback), or fan out WHILE a
        replica is booting with the spawn-time arm set baked into its
        config, and this pass (computed against the live desired set,
        under the same lock discipline as the push bookkeeping) makes
        the recovered replica serve the fleet's intended models, not
        the pre-push ones.  The :load op is idempotent ('already'), so
        racing push() doing the same load is harmless."""
        if desired is None:
            with self._lock:
                desired = self._desired_arms_locked()
        for arm in set(cfg_names) - set(desired):
            try:
                _http_json('POST', host, port,
                           '/v1/models/%s:unload' % arm, payload={},
                           timeout=10.0)
            except (OSError, http.client.HTTPException):
                pass
        for arm in set(desired) - set(cfg_names):
            try:
                _http_json('POST', host, port,
                           '/v1/models/%s:load' % arm,
                           payload=desired[arm], timeout=60.0)
            except (OSError, http.client.HTTPException):
                pass
        return self

    def spawn_replica(self):
        """Add one replica to the fleet (blocking until healthy)."""
        return self._finish_spawn(self._spawn_proc(self._take_index()))

    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def live_replicas(self):
        return len(self.replicas())

    def wait_healthy(self, timeout=None):
        """Block until every current replica answers /healthz (raises
        past `timeout`, default the spawn deadline)."""
        deadline = time.monotonic() + (timeout or spawn_timeout_s())
        while True:
            pending = [r for r in self.replicas()
                       if not self._probe(r)]
            if not pending:
                return self
            if time.monotonic() >= deadline:
                raise MXNetError(
                    'fleet not healthy within deadline: replica(s) %s '
                    'unresponsive' % [r.index for r in pending])
            time.sleep(0.1)

    def stop(self):
        """Stop the loops, close the router, terminate the replicas
        (SIGTERM, then SIGKILL stragglers)."""
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        self.router.close()
        with self._lock:
            reps, self._replicas = self._replicas, []
        for r in reps:
            if r.proc is not None and r.proc.poll() is None:
                try:
                    r.proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 5.0
        for r in reps:
            if r.proc is None:
                continue
            try:
                r.proc.wait(timeout=max(0.1,
                                        deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    r.proc.kill()
                    r.proc.wait(timeout=5)
                except OSError:
                    pass
        profiler.add_fleet_supervisor_stats(replicas_live=0)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- health / restart / scale loop ----------------------------------
    def _probe(self, rep, timeout=None):
        try:
            status, _h, _b = _http_json(
                'GET', rep.host, rep.port, '/healthz',
                timeout=timeout or min(2.0, dead_after_s()))
            return status == 200
        except (OSError, http.client.HTTPException, ValueError):
            return False

    def _loop(self):
        last_scale = time.monotonic()
        while not self._stop.wait(heartbeat_interval_s()):
            try:
                self._health_once()
                if self.autoscale and \
                        time.monotonic() - last_scale >= \
                        2 * heartbeat_interval_s():
                    last_scale = time.monotonic()
                    self._scale_once()
            except Exception:           # the loop must survive
                logging.exception('fleet supervisor loop error')

    def _health_once(self):
        """One liveness pass: probe every replica, declare the silent
        ones dead (process exit OR wedge — silence past DEAD_AFTER),
        kill + respawn under the backoff/budget rules."""
        now = time.monotonic()
        for rep in self.replicas():
            exited = rep.proc is not None and rep.proc.poll() is not None
            if not exited:
                if self._probe(rep):
                    rep.last_ok = time.monotonic()
                    rep.backoff = 0.0
                    continue
                if now - rep.last_ok <= dead_after_s():
                    continue            # not silent long enough yet
            self._declare_dead(rep, 'exited code %s' % rep.proc.poll()
                               if exited else
                               'no /healthz for > %.1fs (wedged?)'
                               % dead_after_s())
        self._respawn_due()

    def _declare_dead(self, rep, why):
        logging.warning('fleet supervisor: replica %d dead (%s) — '
                        'restarting', rep.index, why)
        self.router.remove_backend(rep.bid)
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
            live = len(self._replicas)
        profiler.add_fleet_supervisor_stats(replicas_live=live)
        if rep.proc is not None and rep.proc.poll() is None:
            try:
                rep.proc.kill()        # SIGKILL: it is wedged, not
                rep.proc.wait(timeout=10)   # listening to SIGTERM
            except OSError:
                pass
        # restart budget: at most MAX_RESTARTS per window, with
        # exponential backoff between attempts (the launch.py
        # --elastic / dist.py reconnect discipline)
        now = time.monotonic()
        rep.restart_times.append(now)
        while rep.restart_times and \
                now - rep.restart_times[0] > restart_window_s():
            rep.restart_times.popleft()
        if len(rep.restart_times) > max_restarts():
            logging.error(
                'fleet supervisor: replica slot %d exhausted its '
                'restart budget (%d in %.0fs) — abandoning the slot',
                rep.index, len(rep.restart_times), restart_window_s())
            with self._lock:
                self._abandoned += 1
            return
        rep.backoff = min(10.0, (rep.backoff * 2) or
                          restart_backoff_s())
        rep.next_attempt = now + rep.backoff
        with self._lock:
            self._dead_pending.append(rep)

    def _respawn_due(self):
        with self._lock:
            pending = list(self._dead_pending)
        now = time.monotonic()
        for rep in pending:
            if now < rep.next_attempt:
                continue
            with self._lock:
                self._dead_pending.remove(rep)
            try:
                fresh = self._spawn_proc(rep.index)
                fresh.restart_times = rep.restart_times
                fresh.backoff = rep.backoff
                self._finish_spawn(fresh)
                with self._lock:
                    self._n_restarts += 1
                profiler.add_fleet_supervisor_stats(replica_restarts=1)
            except Exception:
                # ANY spawn failure (handshake MXNetError, but also a
                # transient Popen OSError) re-queues the slot — losing
                # it here would silently shrink the fleet with neither
                # a restart nor an abandoned_slots count
                logging.exception('fleet supervisor: respawn of '
                                  'replica %d failed', rep.index)
                rep.backoff = min(10.0, (rep.backoff * 2) or
                                  restart_backoff_s())
                rep.next_attempt = time.monotonic() + rep.backoff
                with self._lock:
                    self._dead_pending.append(rep)

    def _scale_obs(self):
        """One observation for the ScalePolicy from the counter
        windows: router-observed p99 vs each model's deadline, summed
        replica backlog rows (/statsz), and the request delta."""
        delta = self.router.requests_delta()
        over = False
        # the latency window is request-driven: with ZERO new requests
        # it is frozen at the last busy period's values, and treating
        # that as "hot" would block scale-down FOREVER on an idle
        # fleet
        if delta > 0:
            for name, m in list(self._models.items()):
                d = m.get('deadline_ms')
                if d and self.router.latency_p99_ms(name) > float(d):
                    over = True
                    break
        backlog = 0
        for rep in self.replicas():
            try:
                # tight timeout: this runs on the SINGLE supervisor
                # loop thread — a wedged replica must not stall the
                # next health pass past the death deadline
                _s, _h, st = _http_json(
                    'GET', rep.host, rep.port, '/statsz',
                    timeout=min(1.0, dead_after_s() / 2))
                for mm in st.get('models', {}).values():
                    eng = mm.get('engine') or {}
                    backlog += int(eng.get('backlog_rows', 0) or 0)
            except (OSError, http.client.HTTPException, ValueError):
                pass
        return {'p99_over_deadline': over, 'backlog_rows': backlog,
                'requests_delta': delta}

    def _scale_once(self):
        delta = self._policy.decide(self._scale_obs())
        live = self.live_replicas()
        if delta > 0 and live < self.max_replicas:
            logging.info('fleet supervisor: scaling up (%d -> %d)',
                         live, live + 1)
            try:
                self.spawn_replica()
            except MXNetError:
                logging.exception('fleet supervisor: scale-up spawn '
                                  'failed')
        elif delta < 0 and live > self.min_replicas:
            self.retire_replica()

    def retire_replica(self):
        """Retire one replica with connection draining: the router
        stops routing to it first, in-flight requests get the drain
        grace, then SIGTERM (the replica's clean shutdown path)."""
        with self._lock:
            if not self._replicas:
                return None
            rep = self._replicas.pop()  # newest first
            live = len(self._replicas)
        self.router.remove_backend(rep.bid)
        profiler.add_fleet_supervisor_stats(replicas_live=live)
        logging.info('fleet supervisor: retiring replica %d '
                     '(draining %.1fs)', rep.index, drain_s())

        def finish():
            time.sleep(drain_s())
            if rep.proc is not None and rep.proc.poll() is None:
                try:
                    rep.proc.terminate()
                    rep.proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    try:
                        rep.proc.kill()
                    except OSError:
                        pass
            with self._lock:
                self._n_retired += 1
            profiler.add_fleet_supervisor_stats(replica_retires=1)

        threading.Thread(target=finish, name='mxtpu-fleet-retire',
                         daemon=True).start()
        return rep

    # -- continuous deployment ------------------------------------------
    def push(self, name, prefix, epoch=0, frac=None, mode='canary',
             tag=None, delta=None):
        """Hot-swap `name` to the `prefix`/`epoch` checkpoint behind a
        canary split (or shadow tee): the candidate is loaded on every
        live replica under a versioned arm name, then `frac` of
        traffic (canary) — or a tee of all logged traffic (shadow) —
        exercises it.  Auto-rollback/auto-promote per the knobs; the
        decision lands in the supervisor's desired model set so future
        spawns serve the surviving version.  Returns the arm name.

        A replica that DIES mid-fan-out (transport failure, not a
        refusal) does not abort the push: the candidate is already in
        `_pending`, so the respawn's `_reconcile` pass loads it when
        the replica rejoins the pool — the fleet converges to the
        intended model set.  A replica that REFUSES the load (507
        BudgetExceeded, 400) aborts and unwinds: the fleet must never
        route to an arm only some replicas will serve.

        `delta=` ({path, meta, parity_tol}, built by the
        CheckpointPusher's delta channel) fans out `:delta` instead of
        `:load`: each replica builds the candidate from its RESIDENT
        stable arm plus the delta payload, never opening the full
        params file.  A 409 refusal (chain break / parity) raises the
        typed DeltaChainError — the caller's signal to retry as a full
        push.  The pending spec stays the FULL spec either way, so a
        respawn mid-push reconciles with a plain `:load`."""
        with self._lock:
            m = self._models.get(name)
            if m is None:
                raise MXNetError('push(%r): unknown model (have %s)'
                                 % (name, sorted(self._models)))
            if name in self._pending:
                raise MXNetError('push(%r): a push is already active '
                                 '(%s)' % (name,
                                           self._pending[name]['name']))
            self._push_seq += 1
            cand_name = '%s@v%d' % (name, self._push_seq)
            spec = {k: v for k, v in m.items()
                    if k not in ('name', 'serve_name', 'tag')}
            spec['name'] = cand_name
            spec['prefix'] = prefix
            spec['epoch'] = int(epoch)
            # opaque caller correlation (e.g. the pusher's train
            # step), attached to this push's verdict — stored BEFORE
            # the canary opens so even an instant decision carries it
            spec['tag'] = tag
            self._pending[name] = spec
            if delta is not None:
                # the replica applies the delta against the arm it is
                # CURRENTLY serving for this model — name it here, at
                # the single point that knows the promoted arm
                delta = dict(delta)
                delta.setdefault('base', m.get('serve_name') or name)
        op = ':delta' if delta is not None else ':load'
        payload = {k: v for k, v in spec.items()
                   if k not in ('name', 'tag')}
        if delta is not None:
            payload['delta'] = delta
        loaded = []
        try:
            for rep in self.replicas():
                try:
                    status, _h, body = _http_json(
                        'POST', rep.host, rep.port,
                        '/v1/models/%s%s' % (cand_name, op),
                        payload=payload,
                        timeout=spawn_timeout_s())
                except (OSError, http.client.HTTPException) as e:
                    # replica unreachable mid-fan-out: if it is DYING,
                    # the health loop declares it dead and the respawn
                    # reconciles against _pending (which names this
                    # candidate); if it is alive-but-blipped (one load
                    # timed out), the bounded background retry below
                    # converges it without waiting for a death —
                    # meanwhile the router retries its canary-arm 404s
                    # to other backends instead of recording them
                    logging.warning(
                        'push(%r): replica %d unreachable (%r) — '
                        'retry/reconcile will converge it',
                        name, rep.index, e)
                    self._retry_load_async(rep, cand_name, spec)
                    continue
                if status == 409 and delta is not None:
                    raise delta_mod.DeltaChainError(
                        'push(%r): replica %d refused the delta (%s) '
                        '— full push required' % (name, rep.index,
                                                  body))
                if status != 200:
                    raise MXNetError(
                        'push(%r): replica %d refused the candidate '
                        '(%s: %s)' % (name, rep.index, status, body))
                loaded.append(rep)
            if not loaded:
                raise MXNetError(
                    'push(%r): no live replica accepted the candidate'
                    % name)
        except Exception:
            # undo half a push: the fleet must never route to an arm
            # only some replicas can serve.  Unwind against the
            # CURRENT replica set, not the fan-out's `loaded` snapshot
            # — a replica that finished spawning DURING the fan-out
            # loaded the then-pending candidate via its reconcile
            # passes and would otherwise keep the aborted arm
            # resident forever (arm names are never reused)
            with self._lock:
                self._pending.pop(name, None)
            for rep in self.replicas():
                try:
                    _http_json('POST', rep.host, rep.port,
                               '/v1/models/%s:unload' % cand_name,
                               payload={}, timeout=10.0)
                except (OSError, http.client.HTTPException):
                    pass
            raise
        self.router.start_canary(name, cand_name, frac=frac,
                                 mode=mode)
        return cand_name

    def push_active(self, name):
        """True while a push for `name` is still being judged (its
        candidate arm is in the pending set)."""
        with self._lock:
            return name in self._pending

    def active_prefixes(self, name):
        """Checkpoint prefixes the fleet still NEEDS for `name`: the
        current serve prefix (respawns warm from it) plus any pending
        candidate's.  The CheckpointPusher's export retention must
        never delete these."""
        out = set()
        with self._lock:
            m = self._models.get(name)
            if m is not None and m.get('prefix'):
                out.add(m['prefix'])
            c = self._pending.get(name)
            if c is not None and c.get('prefix'):
                out.add(c['prefix'])
        return out

    def on_push_verdict(self, cb):
        """Register a callback(PushVerdict) fired on every canary
        decision (promote/rollback) — the feedback channel of the
        train->serve loop (CheckpointPusher registers itself here).
        Callbacks run on the router's decision thread; exceptions are
        contained."""
        with self._lock:
            self._verdict_cbs.append(cb)
        return self

    def _notify_verdict(self, kind, name, cand, report, tag=None):
        with self._lock:
            cbs = list(self._verdict_cbs)
        if not cbs:
            return
        v = PushVerdict('promoted' if kind == 'promote'
                        else 'rolled_back', name, cand, step=tag,
                        report=report)
        for cb in cbs:
            try:
                cb(v)
            except Exception:       # observer must not break deploys
                logging.exception('fleet supervisor: push-verdict '
                                  'callback failed')

    def _retry_load_async(self, rep, arm, spec, attempts=3,
                          delay_s=2.0):
        """Bounded background :load retries for a replica that was
        unreachable during a push fan-out but may be alive (a timed-out
        load / connection blip — /healthz still answering, so no
        respawn would ever reconcile it).  Gives up once the arm is no
        longer pending/desired or the attempts run out (a truly dead
        replica is the health loop's job)."""
        payload = {k: v for k, v in spec.items() if k != 'name'}

        def work():
            for _ in range(attempts):
                time.sleep(delay_s)
                with self._lock:
                    if rep not in self._replicas or \
                            arm not in self._desired_arms_locked():
                        return          # died/rolled back: moot
                try:
                    _http_json('POST', rep.host, rep.port,
                               '/v1/models/%s:load' % arm,
                               payload=payload,
                               timeout=spawn_timeout_s())
                    logging.info('push retry: replica %d converged '
                                 'to %r', rep.index, arm)
                    return
                except (OSError, http.client.HTTPException):
                    continue

        threading.Thread(target=work, name='mxtpu-push-retry',
                         daemon=True).start()

    def _on_router_event(self, kind, name, info):
        tag = None
        if kind == 'promote':
            with self._lock:
                m = self._models.get(name)
                cand = self._pending.pop(name, None)
                if cand is not None:
                    tag = cand.get('tag')
                if m is not None and cand is not None:
                    m['serve_name'] = cand['name']
                    m['prefix'] = cand['prefix']
                    m['epoch'] = cand['epoch']
        elif kind == 'rollback':
            with self._lock:
                cand = self._pending.pop(name, None)
                if cand is not None:
                    tag = cand.get('tag')
        if kind in ('promote', 'rollback'):
            self._notify_verdict(kind, name,
                                 (info or {}).get('candidate'),
                                 (info or {}).get('report'), tag=tag)

    # -- observability --------------------------------------------------
    def _sup_stats(self):
        with self._lock:
            reps = list(self._replicas)
            out = {'desired_replicas': self.n_replicas,
                   'min_replicas': self.min_replicas,
                   'max_replicas': self.max_replicas,
                   'restarts': self._n_restarts,
                   'retired': self._n_retired,
                   'abandoned_slots': self._abandoned,
                   'models': {n: m['serve_name']
                              for n, m in self._models.items()}}
        out['replicas'] = [
            {'index': r.index, 'port': r.port,
             'alive': r.proc is not None and r.proc.poll() is None}
            for r in reps]
        return out

    def stats(self):
        return self._sup_stats()


# ---------------------------------------------------------------------------
# train->serve loop: commit -> push -> canary -> verdict
# ---------------------------------------------------------------------------

class PushVerdict(object):
    """The typed outcome of one train->serve push, fed BACK to the
    training loop (the feedback half of the loop: a parameter-server
    push/pull at checkpoint granularity).

    kind:      'promoted' | 'rolled_back' (canary decision) |
               'failed' (the push never reached a judgeable state:
               registry BudgetExceeded/507, dead fleet, injected
               MXNET_TPU_FAULT_PUSH_FAIL, torn source checkpoint)
    model:     the public model name
    candidate: the versioned arm name ('m@vN'; None for failures
               before an arm existed)
    step:      the training step whose commit produced the candidate
               (None when the pusher could not correlate it)
    report:    the router's per-arm canary window snapshot — the
               regression stats a rollback was decided on (None for
               failures)
    error:     the failure detail for kind='failed'
    """

    __slots__ = ('kind', 'model', 'candidate', 'step', 'report',
                 'error')

    def __init__(self, kind, model, candidate, step=None, report=None,
                 error=None):
        self.kind = kind
        self.model = model
        self.candidate = candidate
        self.step = step
        self.report = report
        self.error = error

    def __repr__(self):
        extra = ''
        if self.report:
            extra = ' cand_p50=%.1fms stable_p50=%.1fms err=%.3f' % (
                self.report.get('cand_p50_ms', 0.0),
                self.report.get('stable_p50_ms', 0.0),
                self.report.get('cand_err_frac', 0.0))
        if self.error:
            extra = ' error=%s' % (self.error,)
        return ('PushVerdict(%s, model=%r, candidate=%r, step=%s%s)'
                % (self.kind, self.model, self.candidate, self.step,
                   extra))


class RollbackStop(MXNetError):
    """Raised out of the training loop (via
    elastic.CheckpointManager.request_stop -> step_end) after N
    CONSECUTIVE canary rollbacks: a run whose every fresh checkpoint
    regresses the fleet is diverging — stop it instead of burning
    pushes and canary traffic on it.  `verdicts` carries the rollback
    PushVerdicts the decision was made on."""

    def __init__(self, model, verdicts):
        self.model = model
        self.verdicts = list(verdicts)
        super().__init__(
            'training stopped: %d consecutive canary rollbacks for '
            'model %r (last: %s)' % (len(self.verdicts), model,
                                     self.verdicts[-1]
                                     if self.verdicts else None))


class CheckpointPusher(object):
    """The glue that closes the train->serve loop: wire one of these
    between an elastic.CheckpointManager and a FleetSupervisor and
    every committed checkpoint is exported to the serving format and
    pushed into the live fleet as a canary, with the verdict fed back
    to the trainer::

        sup = FleetSupervisor(models=[...], replicas=2).start()
        pusher = CheckpointPusher(sup, 'm', symbol=net)
        mgr = elastic.CheckpointManager(ckdir, every_n_steps=100)
        pusher.attach(mgr)
        mod.fit(data, checkpoint=mgr, ...)   # commits now feed serving

    Robustness contract (the whole point):

      * **training never stalls** — on_commit only enqueues into a
        BOUNDED queue; the export + HTTP fan-out run on this worker
        thread.  A slow/wedged/dead fleet means commits skip with a
        counter (loop_push_queue_skipped — the checkpoint writer's
        skip discipline), never a blocked train step.
      * **push failures degrade gracefully** — BudgetExceeded/507, a
        dead fleet, a pruned source checkpoint, or the injected
        MXNET_TPU_FAULT_PUSH_FAIL produce a kind='failed' PushVerdict
        + loop_push_failures; nothing raises into the training loop.
      * **one candidate at a time** — while a push is still being
        judged, newer commits skip (counted); the canary keeps a
        stable window.
      * **divergence stop** — `max_consecutive_rollbacks` (default
        MXNET_TPU_LOOP_MAX_ROLLBACKS, 3; 0 disables) consecutive
        rollbacks call the attached manager's request_stop with a
        RollbackStop, raised Preempted-style at the next step
        boundary.
      * **export retention** — exported serving prefixes are pruned
        keep-last-2 EXCEPT any the supervisor still references (the
        current serve prefix / a pending candidate: respawned
        replicas warm from them).  The SOURCE checkpoints of queued/
        in-flight pushes are pinned via the manager's retain_refs
        hook until their export lands.
      * **delta channel** — `delta=True` (or MXNET_TPU_LOOP_DELTA=1)
        ships per-commit weight DELTAS (delta.make_delta, int8 dense
        diffs + touched-rows, `delta-%08d.bin` next to the exports)
        once a full push has been promoted: replicas rebuild the
        candidate from their resident stable arm + the payload and
        never open the full params file.  The chain only advances on
        a PROMOTE; any refusal (409 chain/parity), encode failure or
        rebase-cadence expiry (`delta_rebase`, default
        MXNET_TPU_LOOP_DELTA_REBASE=16 deltas per full base) falls
        back to a full push — counted delta_pushes/
        delta_push_fallbacks (profiler.delta_stats()).  The full
        serving export is STILL written every push either way:
        respawns and reconciles always full-load.
      * **verdict hook** — when the attached manager carries an
        `on_verdict` callable (e.g. elastic.LrBackoff), every verdict
        is forwarded to it with the consecutive-rollback count, and
        the hook REPLACES the RollbackStop at the threshold: the run
        backs off instead of stopping.

    Verdicts: `poll_verdicts()` drains new-since-last-poll (the
    manager's step_end logs them in the training loop's stream);
    `verdicts()` / `last_verdict` keep the full history.
    """

    def __init__(self, supervisor, model, symbol=None, mode='canary',
                 frac=None, push_dir=None, queue_depth=None,
                 max_consecutive_rollbacks=None, delta=None,
                 delta_rebase=None, delta_config=None):
        import queue as _queue
        import tempfile
        self.supervisor = supervisor
        self.model = model
        self.symbol = symbol
        self.mode = mode
        self.frac = frac
        self.push_dir = push_dir or tempfile.mkdtemp(
            prefix='mxtpu_push_')
        os.makedirs(self.push_dir, exist_ok=True)
        if queue_depth is None:
            queue_depth = _env_int('MXNET_TPU_LOOP_PUSH_QUEUE', 1)
        if max_consecutive_rollbacks is None:
            max_consecutive_rollbacks = _env_int(
                'MXNET_TPU_LOOP_MAX_ROLLBACKS', 3)
        self.max_consecutive_rollbacks = int(max_consecutive_rollbacks)
        if delta is None:
            delta = _env_int('MXNET_TPU_LOOP_DELTA', 0) != 0
        self.delta = bool(delta)
        if delta_rebase is None:
            delta_rebase = _env_int('MXNET_TPU_LOOP_DELTA_REBASE', 16)
        self.delta_rebase = max(1, int(delta_rebase))
        self._delta_cfg = delta_mod.DeltaConfig.resolve(
            delta_config, dense='int8')
        self._base = None       # promoted chain {state, fp, seq}
        self._staged = None     # this push's chain state, pre-verdict
        self._retained = set()  # steps whose source ckpt we still need
        self._q = _queue.Queue(maxsize=max(1, int(queue_depth)))
        self._lock = threading.Lock()
        self._mgr = None
        self._history = []
        self._unlogged = deque()
        self._arm_steps = {}            # candidate arm -> train step
        self._chained = None            # pre-existing on_commit hook
        self._consec_rb = 0
        self._n_attempts = 0
        self._exports = []              # exported prefixes, oldest first
        self._closed = False
        reg = getattr(supervisor, 'on_push_verdict', None)
        if reg is not None:
            reg(self._on_verdict)
        self._worker = threading.Thread(target=self._worker_loop,
                                        name='mxtpu-loop-pusher',
                                        daemon=True)
        self._worker.start()

    # -- wiring ---------------------------------------------------------
    def attach(self, manager):
        """Wire this pusher as `manager`'s on_commit hook (and remember
        the manager for the consecutive-rollback stop).  The pusher
        itself is installed (it is callable), so the manager's
        step_end() also finds poll_verdicts() and logs each verdict in
        the training stream.  An on_commit hook the manager already
        carries is CHAINED, not overwritten — it keeps firing before
        each enqueue (contained: its exceptions cannot skip the
        push).  Returns the manager so
        `pusher.attach(CheckpointManager(...))` chains."""
        prior = getattr(manager, 'on_commit', None)
        if prior is not None and prior is not self:
            self._chained = prior
        manager.on_commit = self
        self._mgr = manager
        if getattr(manager, 'retain_refs', None) is None:
            # incremental managers prune aggressively (deltas are
            # tiny); pin the source commits of queued/in-flight pushes
            # until their serving export lands on disk
            manager.retain_refs = self._retained_steps
        return manager

    def __call__(self, step_dir, manifest):
        chained = self._chained
        if chained is not None:
            try:
                chained(step_dir, manifest)
            except Exception:
                logging.exception('loop pusher: chained on_commit '
                                  'hook failed (push continues)')
        return self.on_commit(step_dir, manifest)

    # -- commit side (called from the checkpoint writer thread) ---------
    def on_commit(self, step_dir, manifest):
        """Enqueue one committed checkpoint for pushing.  NEVER blocks:
        a full queue or a still-judged previous push skips with a
        counter — a wedged fleet must not stall training."""
        if self._closed:
            return
        active = getattr(self.supervisor, 'push_active', None)
        if active is not None and active(self.model):
            profiler.add_loop_stats(push_queue_skipped=1)
            logging.info('loop pusher: skipping commit %s (a push for '
                         '%r is still being judged)', step_dir,
                         self.model)
            return
        try:
            self._q.put_nowait((step_dir, dict(manifest)))
        except Exception:               # queue.Full
            profiler.add_loop_stats(push_queue_skipped=1)
            logging.info('loop pusher: skipping commit %s (push queue '
                         'full)', step_dir)
            return
        with self._lock:
            self._retained.add(int(manifest.get('step', 0)))

    # -- worker ---------------------------------------------------------
    def _worker_loop(self):
        import queue as _queue
        while True:
            try:
                # bounded get: close() may find the queue FULL and be
                # unable to deliver the None sentinel — the timeout
                # lets the worker notice _closed and exit instead of
                # blocking forever
                job = self._q.get(timeout=0.5)
            except _queue.Empty:
                if self._closed:
                    return
                continue
            if job is None or self._closed:
                # a job queued before close() must not push into a
                # fleet that is tearing down
                return
            step_dir, manifest = job
            try:
                self._push_one(step_dir, manifest)
            except Exception as e:
                profiler.add_loop_stats(push_failures=1)
                logging.warning('loop pusher: push of %s failed: %s',
                                step_dir, e)
                self._record(PushVerdict(
                    'failed', self.model, None,
                    step=manifest.get('step'), error=str(e)))
            finally:
                with self._lock:
                    self._retained.discard(
                        int(manifest.get('step', 0)))

    def _push_one(self, step_dir, manifest):
        from .serving import export_serving_checkpoint
        # re-check at DEQUEUE time: a commit can pass the enqueue-time
        # check while the worker is between dequeue and push() for the
        # previous one — that is the normal one-candidate-at-a-time
        # skip, not a failure (and must not consume a PUSH_FAIL
        # attempt or export orphan files)
        active = getattr(self.supervisor, 'push_active', None)
        if active is not None and active(self.model):
            profiler.add_loop_stats(push_queue_skipped=1)
            logging.info('loop pusher: skipping commit %s at dequeue '
                         '(a push for %r is still being judged)',
                         step_dir, self.model)
            return
        self._n_attempts += 1
        n = push_fail_n()
        if n is not None and self._n_attempts == n:
            raise MXNetError('injected push failure '
                             '(MXNET_TPU_FAULT_PUSH_FAIL=%d)' % n)
        step = int(manifest.get('step', 0))
        prefix = os.path.join(self.push_dir, 'push-%08d' % step)
        if self.symbol is None:
            raise MXNetError('CheckpointPusher needs the serving '
                             'symbol= to export checkpoints')
        export_serving_checkpoint(step_dir, self.symbol, prefix,
                                  epoch=0)
        with self._lock:
            # recorded BEFORE the push so a failing push's export is
            # still retention-managed, never orphaned in push_dir
            self._exports.append(prefix)
        dspec = meta = None
        if self.delta:
            dspec, meta = self._encode_delta(step_dir, step)
        delta_pushed = False
        try:
            # tag= rides the push so the verdict carries the train
            # step even when the canary decides before push() returns.
            # delta= only when one is going out: stub/legacy
            # supervisors without the kwarg keep working
            kw = {'delta': dspec} if dspec is not None else {}
            try:
                cand = self.supervisor.push(self.model, prefix,
                                            epoch=0, frac=self.frac,
                                            mode=self.mode, tag=step,
                                            **kw)
                delta_pushed = dspec is not None
            except MXNetError as e:
                if dspec is None:
                    raise
                # typed 409 refusal (chain break on a replica, parity
                # gate) or any delta-path failure: the full export is
                # already on disk — retry as a plain full push, which
                # also REBASES the chain on promote
                profiler.add_delta_stats(push_fallbacks=1)
                logging.warning(
                    'loop pusher: delta push of step %d refused (%s) '
                    '— falling back to a full push', step, e)
                with self._lock:
                    if self._staged is not None:
                        self._staged = dict(self._staged,
                                            state=self._staged['full'],
                                            fp=self._staged['full_fp'],
                                            seq=0)
                cand = self.supervisor.push(self.model, prefix,
                                            epoch=0, frac=self.frac,
                                            mode=self.mode, tag=step)
        finally:
            self._prune_exports()
        if delta_pushed:
            full_b = int(meta['full_bytes'])
            try:
                full_b = os.path.getsize(prefix + '-0000.params')
            except OSError:
                pass
            profiler.add_delta_stats(pushes=1, bytes=meta['bytes'],
                                     full_bytes=full_b)
            logging.info('loop pusher: step %d went out as delta seq '
                         '%d (%d bytes vs %d full)', step,
                         meta['seq'], meta['bytes'], full_b)
        with self._lock:
            # fallback correlation for tag-less push paths; bounded —
            # a verdict that raced ahead of this insert (tag already
            # carried its step) would otherwise leak the entry
            self._arm_steps[cand] = step
            while len(self._arm_steps) > 8:
                self._arm_steps.pop(next(iter(self._arm_steps)))
        profiler.add_loop_stats(pushes=1)
        logging.info('loop pusher: pushed step %d as %r (mode=%s)',
                     step, cand, self.mode)

    def _encode_delta(self, step_dir, step):
        """Encode this commit against the fleet's PROMOTED chain state
        (delta channel).  Returns (delta_spec, meta) when a delta can
        go out, (None, None) for the full-push legs (no promoted base
        yet, rebase cadence reached, shape/name-set change).  Either
        way the would-be chain state is STAGED so the promote verdict
        can advance it — a full push rebases the chain to seq 0.
        Never raises: any failure just means 'push full this time'."""
        from .elastic import write_shard_file
        from .serving import serving_state
        try:
            cur = serving_state(step_dir)
        except MXNetError as e:
            logging.warning('loop pusher: cannot read %s for the '
                            'delta channel (%s) — pushing full',
                            step_dir, e)
            with self._lock:
                self._staged = None
            return None, None
        full_fp = delta_mod.fingerprint(cur)
        with self._lock:
            base = self._base
        if base is not None and base['seq'] < self.delta_rebase:
            try:
                entries, meta, new_state = delta_mod.make_delta(
                    base['state'], cur, seq=base['seq'] + 1,
                    base_fp=base['fp'], config=self._delta_cfg)
                path = os.path.join(self.push_dir,
                                    'delta-%08d.bin' % step)
                write_shard_file(path, entries)
                with self._lock:
                    self._staged = {'step': step, 'state': new_state,
                                    'fp': meta['new_fp'],
                                    'seq': int(meta['seq']),
                                    'full': cur, 'full_fp': full_fp}
                return ({'path': path, 'meta': meta,
                         'parity_tol': self._delta_cfg.parity_tol},
                        meta)
            except MXNetError as e:
                # shape/dtype/name-set change between commits: the
                # chain cannot express it — rebase via a full push
                logging.info('loop pusher: delta encode failed for '
                             'step %d (%s) — rebasing with a full '
                             'push', step, e)
        with self._lock:
            self._staged = {'step': step, 'state': cur, 'fp': full_fp,
                            'seq': 0, 'full': cur, 'full_fp': full_fp}
        return None, None

    def _retained_steps(self):
        """Steps whose SOURCE checkpoint the pusher still needs (queued
        or in-flight, not yet exported to the serving format) — wired
        as the manager's retain_refs so retention cannot prune a
        commit out from under its own push."""
        with self._lock:
            return set(self._retained)

    def _prune_exports(self):
        """Keep-last-2 export retention, never deleting a prefix the
        supervisor still references (current serve arm / pending
        candidate — respawns warm from those files)."""
        keep = set()
        ref = getattr(self.supervisor, 'active_prefixes', None)
        if ref is not None:
            try:
                keep = set(ref(self.model))
            except Exception:
                return                  # cannot tell: delete nothing
        with self._lock:
            prunable = [p for p in self._exports[:-2]
                        if p not in keep]
            self._exports = [p for p in self._exports
                             if p not in prunable]
        for p in prunable:
            for suffix in ('-symbol.json', '-0000.params'):
                try:
                    os.unlink(p + suffix)
                except OSError:
                    pass
        # push_dir itself persists: the fleet loads from it

    # -- verdict side (called from the router decision thread) ----------
    def _on_verdict(self, v):
        if v.model != self.model or self._closed:
            # the supervisor has no deregistration: a CLOSED pusher
            # must not keep counting verdicts (double counters, a
            # stale rollback streak aborting a later healthy run)
            return
        with self._lock:
            # the push() tag is the primary step correlation (set
            # before the canary opens, so even an instant verdict
            # carries it); the map is the fallback for push paths
            # without tag support, and is always popped to stay
            # bounded
            mapped = self._arm_steps.pop(v.candidate, None)
            if v.step is None:
                v.step = mapped
        self._record(v)

    def _record(self, v):
        stop_exc = None
        with self._lock:
            self._history.append(v)
            self._unlogged.append(v)
            if v.kind == 'rolled_back':
                self._consec_rb += 1
                if self.max_consecutive_rollbacks > 0 and \
                        self._consec_rb >= \
                        self.max_consecutive_rollbacks:
                    stop_exc = RollbackStop(
                        self.model,
                        [h for h in self._history
                         if h.kind == 'rolled_back'
                         ][-self._consec_rb:])
            elif v.kind == 'promoted':
                self._consec_rb = 0
            consec = self._consec_rb
            # delta chain state machine: the fleet only ADVANCES on a
            # promote (a rollback reverts every replica to the stable
            # arm, so the encoder's base must stay put too)
            if v.kind == 'promoted':
                staged = self._staged
                if staged is not None and (v.step is None or
                                           staged['step'] == v.step):
                    self._base = {'state': staged['state'],
                                  'fp': staged['fp'],
                                  'seq': staged['seq']}
                self._staged = None
            elif v.kind in ('rolled_back', 'failed'):
                self._staged = None
        profiler.add_loop_stats(
            consecutive_rollbacks=consec,
            verdicts_promoted=1 if v.kind == 'promoted' else 0,
            verdicts_rolled_back=1 if v.kind == 'rolled_back' else 0)
        hook = getattr(self._mgr, 'on_verdict', None) \
            if self._mgr is not None else None
        if hook is not None:
            try:
                hook(v, consecutive_rollbacks=consec)
            except Exception:   # observer must not break the loop
                logging.exception('loop pusher: manager on_verdict '
                                  'hook failed')
        if stop_exc is not None and self._mgr is not None:
            if hook is not None:
                # an installed verdict hook (elastic.LrBackoff) OWNS
                # the divergence response: keep training and let it
                # act instead of stopping the run
                logging.warning('loop pusher: %d consecutive '
                                'rollbacks — deferring to the '
                                "manager's on_verdict hook instead of "
                                'stopping', consec)
            else:
                logging.warning('loop pusher: %s — requesting '
                                'training stop', stop_exc)
                self._mgr.request_stop(stop_exc)

    # -- trainer-facing surface -----------------------------------------
    def poll_verdicts(self):
        """Drain verdicts recorded since the last poll (the
        CheckpointManager's step_end logs these into the training
        stream).  History stays on verdicts()/last_verdict."""
        out = []
        with self._lock:
            while self._unlogged:
                out.append(self._unlogged.popleft())
        return out

    def verdicts(self):
        with self._lock:
            return list(self._history)

    @property
    def last_verdict(self):
        with self._lock:
            return self._history[-1] if self._history else None

    @property
    def consecutive_rollbacks(self):
        with self._lock:
            return self._consec_rb

    def close(self, timeout=10):
        """Stop the worker (bounded — a worker wedged inside a dead
        fleet's push is abandoned as a daemon thread; it can never
        touch training).  The push_dir is NOT deleted: the fleet's
        desired set may reference exported prefixes."""
        self._closed = True
        try:
            self._q.put_nowait(None)
        except Exception:
            pass
        self._worker.join(timeout=timeout)
        return self


def _drain(stream):
    try:
        for _line in stream:
            pass
    except (OSError, ValueError):
        pass


if __name__ == '__main__':
    _replica_main()
