"""The port's self-healing fleet (mxnet_tpu_torch/fleet_supervisor.py:
ReplicaServer, FleetRouter, FleetSupervisor, canary and shadow
deployment) on the CPU, then held against the JAX package's.

- the 20 contracts of tests/test_fleet_supervisor.py on the port, with
  every replica on mx.cpu(): the replica-death window (requests in
  flight when a replica dies complete by retry on a survivor or fail
  typed within the deadline, never hang, never run a non-idempotent
  request twice), fast 503s from a dead fleet, the Retry-After client
  helper, canary auto-rollback under the injected degrade and
  auto-promote, shadow divergences and replay, the admin load/unload
  ops, the fault knobs, ScalePolicy's hysteresis, wedge detection, the
  restart budget, push against a dead or refusing replica, respawn
  reconcile, a SIGKILL drill with real replica processes, and the
  fleet_supervisor_* profiler family;
- against the JAX package on the same inputs: ScalePolicy.decide over
  one sequence of observations, the fault-knob parsers, _outputs_close,
  and an in-process ReplicaServer of each package on one checkpoint
  (the JAX drill's tolerance, rtol 1e-4 and atol 1e-5);
- a replica asked for the card without CUDA raises at boot, and a
  supervisor whose replicas cannot reach it fails its start; the
  serve_fleet tool starts a CPU fleet and stops it.

Every thread join and wait has a timeout.
"""
import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mxnet_tpu import fleet_supervisor as jfs

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import model as model_mod, nd, profiler
from mxnet_tpu_torch import fleet_supervisor as fs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.fleet_supervisor import (FleetRouter, FleetSupervisor,
                                              ReplicaServer, ScalePolicy,
                                              post_with_backoff)
from mxnet_tpu_torch.predictor import Predictor

CPU = mx.cpu()
DIM = 6
HID = 8
OUT = 3
# the JAX drill's tolerance for a served answer against a direct forward
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _mlp(pkg=mx):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=HID, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu')
    return pkg.sym.FullyConnected(act, num_hidden=OUT, name='fc2')


def _np_params(seed=7):
    rs = np.random.RandomState(seed)
    return {
        'fc1_weight': rs.randn(HID, DIM).astype(np.float32) * .5,
        'fc1_bias': rs.randn(HID).astype(np.float32) * .1,
        'fc2_weight': rs.randn(OUT, HID).astype(np.float32) * .5,
        'fc2_bias': rs.randn(OUT).astype(np.float32) * .1,
    }


def _params(seed=7):
    return {k: nd.array(v, ctx=CPU) for k, v in _np_params(seed).items()}


def _loader(seed):
    return lambda: Predictor(symbol=_mlp(), arg_params=_params(seed),
                             input_shapes={'data': (1, DIM)}, ctx=CPU)


def _spec(seed, name='m'):
    return {'name': name, 'loader': _loader(seed), 'max_batch': 4,
            'max_wait_us': 0}


def _replica(models, index=0, **kw):
    return ReplicaServer(models=models, index=index, ctx=CPU, **kw)


def _x(rows=1, seed=0):
    return np.random.RandomState(seed).randn(rows, DIM).astype(
        np.float32)


def _post_router(router, name='m', seed=0, headers=None, timeout=30):
    host, port = router.address
    req = urllib.request.Request(
        'http://%s:%d/v1/models/%s:predict' % (host, port, name),
        data=json.dumps({'instances': _x(seed=seed).tolist()}).encode(),
        headers=dict({'Content-Type': 'application/json'},
                     **(headers or {})))
    return urllib.request.urlopen(req, timeout=timeout)


# ---------------------------------------------------------------------------
# raw-socket stub backends: precise fault shapes the router must handle
# ---------------------------------------------------------------------------

class _Stub(object):
    """Minimal raw HTTP backend with a scripted behavior per request
    (last entry repeats): 'ok' answers 200, 'drop' reads the full
    request then closes the connection without replying (the crash
    after delivery), '429' answers the overload contract, 'sleep'
    stalls 2 s then answers (a wedged service)."""

    def __init__(self, script=('ok',)):
        self.script = list(script)
        self.received = []
        self._lock = threading.Lock()
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(('127.0.0.1', 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            buf = b''
            while b'\r\n\r\n' not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                buf += chunk
            head, _, body = buf.partition(b'\r\n\r\n')
            n = 0
            for line in head.split(b'\r\n'):
                if line.lower().startswith(b'content-length:'):
                    n = int(line.split(b':', 1)[1])
            while len(body) < n:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                body += chunk
            with self._lock:
                mode = self.script.pop(0) if len(self.script) > 1 \
                    else self.script[0]
                self.received.append(body)
            if mode == 'drop':
                conn.close()
                return
            if mode == 'sleep':
                time.sleep(2.0)
                mode = 'ok'
            if mode == '429':
                payload = (b'{"error": "overloaded", '
                           b'"retry_after_ms": 150}')
                status = b'429 Too Many Requests'
            else:
                payload = b'{"outputs": [[[1.0, 2.0, 3.0]]]}'
                status = b'200 OK'
            conn.sendall(
                b'HTTP/1.1 ' + status +
                b'\r\nContent-Type: application/json'
                b'\r\nContent-Length: ' + str(len(payload)).encode() +
                b'\r\nConnection: close\r\n\r\n' + payload)
            conn.close()
        except OSError:
            pass

    def n_received(self):
        with self._lock:
            return len(self.received)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


def _refused_port():
    """A port with no listener: connecting is refused at once."""
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the client helper
# ---------------------------------------------------------------------------

def test_post_with_backoff_honors_retry_after():
    stub = _Stub(script=['429', '429', 'ok'])
    try:
        t0 = time.monotonic()
        status, body = post_with_backoff(
            'http://127.0.0.1:%d/v1/models/m:predict' % stub.port,
            {'instances': [[0.0]]}, deadline_s=30)
        dt = time.monotonic() - t0
        assert status == 200 and 'outputs' in body
        assert stub.n_received() == 3       # two 429s then success
        assert dt >= 0.25                   # retry_after_ms=150, twice
    finally:
        stub.close()


def test_post_with_backoff_deadline_is_bounded():
    port = _refused_port()
    t0 = time.monotonic()
    with pytest.raises(MXNetError, match='within'):
        post_with_backoff('http://127.0.0.1:%d/x' % port, {},
                          deadline_s=0.5)
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# router: the replica-death window
# ---------------------------------------------------------------------------

def test_router_retries_refused_replica_to_survivor():
    profiler.clear()
    ok = _Stub(script=['ok'])
    with FleetRouter(port=0) as router:
        router.start()
        # insertion [ok, dead]: round robin picks index 1 (dead) first
        router.add_backend('ok', '127.0.0.1', ok.port)
        router.add_backend('dead', '127.0.0.1', _refused_port())
        resp = _post_router(router)
        assert resp.status == 200
        assert json.loads(resp.read())['outputs']
        assert router.stats()['retries'] == 1
        assert ok.n_received() == 1
    ok.close()
    assert profiler.fleet_supervisor_stats()[
        'fleet_supervisor_router_retries'] >= 1


def test_router_replica_death_mid_request_retries_idempotent():
    ok = _Stub(script=['ok'])
    dropper = _Stub(script=['drop'])
    with FleetRouter(port=0) as router:
        router.start()
        router.add_backend('ok', '127.0.0.1', ok.port)
        router.add_backend('dropper', '127.0.0.1', dropper.port)
        t0 = time.monotonic()
        resp = _post_router(router)
        assert resp.status == 200
        assert time.monotonic() - t0 < 10.0
        assert dropper.n_received() == 1    # delivered once
        assert ok.n_received() == 1         # retried to the survivor
        assert router.stats()['retries'] == 1
    ok.close()
    dropper.close()


def test_router_never_double_executes_non_idempotent():
    ok = _Stub(script=['ok'])
    dropper = _Stub(script=['drop'])
    with FleetRouter(port=0) as router:
        router.start()
        router.add_backend('ok', '127.0.0.1', ok.port)
        router.add_backend('dropper', '127.0.0.1', dropper.port)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_router(router,
                         headers={'X-Mxtpu-Non-Idempotent': '1'})
        assert ei.value.code == 502
        body = json.loads(ei.value.read())
        assert body['retriable'] is False
        assert dropper.n_received() == 1
        assert ok.n_received() == 0         # never run twice
        # never delivered (connection refused): still safe to redispatch
        router.remove_backend('dropper')
        router.add_backend('dead', '127.0.0.1', _refused_port())
        resp = _post_router(router,
                            headers={'X-Mxtpu-Non-Idempotent': '1'})
        assert resp.status == 200
        assert ok.n_received() == 1
    ok.close()
    dropper.close()


def test_router_dead_fleet_fast_503_and_deadline_bound():
    profiler.clear()
    with FleetRouter(port=0, deadlines={'m': 500.0}) as router:
        router.start()
        host, port = router.address
        # (1) zero backends: fast typed 503 + Retry-After
        t0 = time.monotonic()
        status, hdrs, body = fs._http_json(
            'POST', host, port, '/v1/models/m:predict',
            {'instances': _x().tolist()}, timeout=10)
        assert status == 503 and body['error'] == 'fleet unavailable'
        assert 'Retry-After' in hdrs
        assert time.monotonic() - t0 < 2.0
        # (2) every backend refused
        router.add_backend('d1', '127.0.0.1', _refused_port())
        router.add_backend('d2', '127.0.0.1', _refused_port())
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/m:predict',
            {'instances': _x().tolist()}, timeout=10)
        assert status == 503
        # (3) a wedged replica: the 500 ms deadline bounds the wait
        slow = _Stub(script=['sleep'])
        router.remove_backend('d1')
        router.remove_backend('d2')
        router.add_backend('slow', '127.0.0.1', slow.port)
        t0 = time.monotonic()
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/m:predict',
            {'instances': _x().tolist()}, timeout=10)
        dt = time.monotonic() - t0
        assert status == 503
        assert 0.4 <= dt < 1.9, dt          # the deadline, not the stall
        slow.close()
    assert profiler.fleet_supervisor_stats()[
        'fleet_supervisor_router_503'] >= 3


# ---------------------------------------------------------------------------
# canary / shadow deployment (in-process replicas)
# ---------------------------------------------------------------------------

def _two_replica_router():
    r1 = _replica([_spec(1)], index=0).start()
    r2 = _replica([_spec(1)], index=1).start()
    router = FleetRouter(port=0).start()
    router.add_backend('r0', *r1.address)
    router.add_backend('r1', *r2.address)
    return r1, r2, router


def _wait_gone(replicas, arm, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline and any(
            arm in r.registry.models() for r in replicas):
        time.sleep(0.05)
    return all(arm not in r.registry.models() for r in replicas)


def test_canary_auto_rollback_on_injected_degrade(monkeypatch):
    profiler.clear()
    monkeypatch.setenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS', '60')
    monkeypatch.setenv('MXNET_TPU_FLEET_CANARY_MIN_SAMPLES', '5')
    r1, r2, router = _two_replica_router()
    try:
        for r in (r1, r2):
            r.load_model('m@v1', _spec(2, name='m@v1'))
        router.start_canary('m', 'm@v1', frac=0.5)
        for i in range(40):
            assert _post_router(router, seed=i).status == 200
            if router.canary_report('m')['state'] != 'running':
                break
        rep = router.canary_report('m')
        assert rep['state'] == 'rolled_back'
        assert rep['cand_p50_ms'] > rep['stable_p50_ms']
        assert router.stable_arm('m') == 'm'
        before = rep['cand_samples']
        for i in range(4):
            assert _post_router(router, seed=i).status == 200
        assert router.canary_report('m')['cand_samples'] == before
        assert _wait_gone((r1, r2), 'm@v1')
        st = router.statsz()
        assert st['fleet_supervisor'][
            'fleet_supervisor_canary_rollbacks'] >= 1
        assert st['canary']['m']['state'] == 'rolled_back'
    finally:
        router.close()
        r1.close()
        r2.close()


def test_canary_auto_promote_when_healthy(monkeypatch):
    monkeypatch.delenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS',
                       raising=False)
    monkeypatch.setenv('MXNET_TPU_FLEET_CANARY_MIN_SAMPLES', '4')
    monkeypatch.setenv('MXNET_TPU_FLEET_CANARY_PROMOTE_SAMPLES', '8')
    # identical arms: a throttle spike in the tiny windows must not fake
    # a regression here
    monkeypatch.setenv('MXNET_TPU_FLEET_CANARY_REGRESS_FACTOR', '8')
    events = []
    r1, r2, router = _two_replica_router()
    router.on_event = lambda kind, name, info: events.append(
        (kind, name, info['candidate']))
    try:
        for r in (r1, r2):
            r.load_model('m@v1', _spec(1, name='m@v1'))
        router.start_canary('m', 'm@v1', frac=0.5)
        for i in range(60):
            assert _post_router(router, seed=i).status == 200
            if router.canary_report('m')['state'] != 'running':
                break
        assert router.canary_report('m')['state'] == 'promoted'
        assert router.stable_arm('m') == 'm@v1'
        assert events == [('promote', 'm', 'm@v1')]
        _wait_gone((r1, r2), 'm')
        assert _post_router(router).status == 200
    finally:
        router.close()
        r1.close()
        r2.close()


def test_canary_served_nowhere_rolls_back_and_serves_stable(
        monkeypatch):
    monkeypatch.delenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS',
                       raising=False)
    monkeypatch.setenv('MXNET_TPU_FLEET_CANARY_MIN_SAMPLES', '4')
    r1, r2, router = _two_replica_router()
    try:
        router.start_canary('m', 'm@ghost', frac=1.0)   # served nowhere
        for i in range(16):
            assert _post_router(router, seed=i).status == 200
            if router.canary_report('m')['state'] != 'running':
                break
        rep = router.canary_report('m')
        assert rep['state'] == 'rolled_back'
        assert rep['cand_err_frac'] == 1.0
        assert router.stable_arm('m') == 'm'
    finally:
        router.close()
        r1.close()
        r2.close()


def test_shadow_tee_counts_divergences(monkeypatch):
    profiler.clear()
    monkeypatch.delenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS',
                       raising=False)
    r1, r2, router = _two_replica_router()
    try:
        for r in (r1, r2):
            r.load_model('m@same', _spec(1, name='m@same'))
        router.start_canary('m', 'm@same', mode='shadow')
        for i in range(6):
            assert _post_router(router, seed=i).status == 200
        assert router.shadow_drain(timeout=30)
        rep = router.canary_report('m')
        assert rep['mode'] == 'shadow'
        assert rep['shadow_requests'] >= 6
        assert rep['shadow_divergences'] == 0
        assert rep['cand_samples'] == 0     # the candidate never served
        for r in (r1, r2):
            r.load_model('m@diff', _spec(2, name='m@diff'))
        router.start_canary('m', 'm@diff', mode='shadow')
        for i in range(6):
            assert _post_router(router, seed=i).status == 200
        assert router.shadow_drain(timeout=30)
        rep = router.canary_report('m')
        assert rep['shadow_divergences'] >= 5
        out = router.replay('m', arm='m@diff')
        assert out['replayed'] >= 6
        assert out['divergences'] == out['replayed']
        out = router.replay('m', arm='m@same')
        assert out['divergences'] == 0
        fsn = profiler.fleet_supervisor_stats()
        assert fsn['fleet_supervisor_shadow_requests'] >= 12
        assert fsn['fleet_supervisor_shadow_divergences'] >= 5
    finally:
        router.close()
        r1.close()
        r2.close()


# ---------------------------------------------------------------------------
# replica admin ops + fault knobs
# ---------------------------------------------------------------------------

def test_replica_admin_load_unload_roundtrip(tmp_path):
    prefix = str(tmp_path / 'admin_m')
    model_mod.save_checkpoint(prefix, 2, _mlp(), _params(9), {})
    with _replica([], index=0) as rs:
        rs.start()
        host, port = rs.address
        spec = {'prefix': prefix, 'epoch': 2,
                'input_shapes': {'data': [1, DIM]},
                'max_batch': 4, 'max_wait_us': 0}
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/hot:load', spec)
        assert status == 200 and body['status'] == 'loaded'
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/hot:load', spec)
        assert status == 200 and body['status'] == 'already'
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/hot:predict',
            {'instances': _x().tolist()})
        assert status == 200
        assert np.asarray(body['outputs'][0]).shape == (1, OUT)
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/hot:unload', {})
        assert status == 200
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/hot:predict',
            {'instances': _x().tolist()})
        assert status == 404
        status, _h, body = fs._http_json(
            'POST', host, port, '/v1/models/ghost:unload', {})
        assert status == 404


def test_fault_knob_parsers(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S', '3.5')
    assert fs.replica_kill_after_s(0) == 3.5
    assert fs.replica_kill_after_s(2) == 3.5
    monkeypatch.setenv('MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S', '1:2.0')
    assert fs.replica_kill_after_s(0) is None
    assert fs.replica_kill_after_s(1) == 2.0
    monkeypatch.delenv('MXNET_TPU_FAULT_REPLICA_KILL_AFTER_S')
    assert fs.replica_kill_after_s(0) is None
    monkeypatch.setenv('MXNET_TPU_FAULT_REPLICA_WEDGE', '0,2')
    assert fs.replica_wedged(0, 0.0) and fs.replica_wedged(2, 99.0)
    assert not fs.replica_wedged(1, 99.0)
    monkeypatch.setenv('MXNET_TPU_FAULT_REPLICA_WEDGE', '1:5')
    assert not fs.replica_wedged(1, 4.0)
    assert fs.replica_wedged(1, 6.0)
    assert not fs.replica_wedged(0, 6.0)
    monkeypatch.setenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS', '80')
    assert fs.canary_degrade_ms() == 80.0
    assert fs.canary_degrade_ms('m@v1') == 80.0
    monkeypatch.setenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS', '@v1:90')
    assert fs.canary_degrade_ms('m@v1') == 90.0
    assert fs.canary_degrade_ms('m@v2') == 0.0
    assert fs.canary_degrade_ms() == 0.0
    monkeypatch.delenv('MXNET_TPU_FAULT_CANARY_DEGRADE_MS')
    assert fs.canary_degrade_ms() == 0.0
    monkeypatch.setenv('MXNET_TPU_FAULT_PUSH_FAIL', '2')
    assert fs.push_fail_n() == 2
    monkeypatch.delenv('MXNET_TPU_FAULT_PUSH_FAIL')
    assert fs.push_fail_n() is None


# ---------------------------------------------------------------------------
# scale policy
# ---------------------------------------------------------------------------

def test_scale_policy_hysteresis():
    p = ScalePolicy(up_after=3, down_after=4, backlog_hot=64)
    hot = {'p99_over_deadline': True, 'backlog_rows': 0,
           'requests_delta': 5}
    idle = {'p99_over_deadline': False, 'backlog_rows': 0,
            'requests_delta': 0}
    busy = {'p99_over_deadline': False, 'backlog_rows': 3,
            'requests_delta': 9}
    assert [p.decide(hot) for _ in range(3)] == [0, 0, 1]
    assert [p.decide(idle) for _ in range(3)] == [0, 0, 0]
    assert p.decide(busy) == 0
    assert [p.decide(idle) for _ in range(4)] == [0, 0, 0, -1]
    deep = {'p99_over_deadline': False, 'backlog_rows': 100,
            'requests_delta': 1}
    assert [p.decide(deep) for _ in range(3)] == [0, 0, 1]


# ---------------------------------------------------------------------------
# supervisor: wedge detection, restart budget (no subprocesses)
# ---------------------------------------------------------------------------

def _fake_supervisor(tmp_path):
    return FleetSupervisor(
        models=[{'name': 'm', 'prefix': str(tmp_path / 'nope'),
                 'input_shapes': {'data': [1, DIM]}}], replicas=1,
        ctx=CPU)


def test_supervisor_declares_wedged_replica_dead(monkeypatch,
                                                tmp_path):
    profiler.clear()
    monkeypatch.setenv('MXNET_TPU_FLEET_DEAD_AFTER_S', '0.3')
    monkeypatch.setenv('MXNET_TPU_FAULT_REPLICA_WEDGE', '7')
    wedged = _replica([_spec(1)], index=7).start()
    sup = _fake_supervisor(tmp_path)
    try:
        rep = fs._Replica(7)
        rep.host, rep.port = wedged.address
        rep.last_ok = time.monotonic() - 10.0
        sup._replicas.append(rep)
        sup.router.add_backend(rep.bid, rep.host, rep.port)
        monkeypatch.setattr(sup, '_respawn_due', lambda: None)
        t0 = time.monotonic()
        sup._health_once()
        assert time.monotonic() - t0 < 5.0    # by probe timeout
        assert sup.router.backends() == []
        assert sup._dead_pending and \
            sup._dead_pending[0].index == 7
        assert rep.backoff >= fs.restart_backoff_s()
        assert rep.next_attempt > t0
    finally:
        sup.router.close()
        wedged.close()


def test_supervisor_restart_budget_abandons_slot(monkeypatch,
                                                 tmp_path):
    monkeypatch.setenv('MXNET_TPU_FLEET_MAX_RESTARTS', '1')
    sup = _fake_supervisor(tmp_path)
    try:
        rep = fs._Replica(0)
        rep.host, rep.port = '127.0.0.1', _refused_port()
        sup._declare_dead(rep, 'test kill 1')
        assert len(sup._dead_pending) == 1
        sup._dead_pending.clear()
        sup._declare_dead(rep, 'test kill 2')
        assert sup._dead_pending == []
        assert sup.stats()['abandoned_slots'] == 1
    finally:
        sup.router.close()


# ---------------------------------------------------------------------------
# push against replica death and respawn
# ---------------------------------------------------------------------------

def _ckpt_prefix(tmp_path, tag, seed):
    prefix = str(tmp_path / tag)
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(seed), {})
    return prefix


def _push_spec(prefix):
    return {'name': 'm', 'prefix': prefix, 'epoch': 0,
            'input_shapes': {'data': [1, DIM]},
            'max_batch': 4, 'max_wait_us': 0}


def _fake_rep(index, host, port):
    rep = fs._Replica(index)
    rep.host, rep.port = host, port
    return rep


def test_push_survives_dead_replica_mid_fanout(tmp_path):
    prefix_a = _ckpt_prefix(tmp_path, 'stable', 1)
    prefix_b = _ckpt_prefix(tmp_path, 'cand', 2)
    live = _replica([_push_spec(prefix_a)], index=0).start()
    sup = FleetSupervisor(models=[_push_spec(prefix_a)], replicas=2,
                          ctx=CPU)
    try:
        sup._replicas = [
            _fake_rep(0, '127.0.0.1', _refused_port()),   # dead first
            _fake_rep(1, *live.address)]
        cand = sup.push('m', prefix_b, epoch=0, frac=0.5)
        assert cand in live.registry.models()
        assert sup.push_active('m')
        assert prefix_b in sup.active_prefixes('m')
        rep = sup.router.canary_report('m')
        assert rep is not None and rep['state'] == 'running'
    finally:
        sup.router.close()
        live.close()


def test_push_refused_by_live_replica_still_unwinds(tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv('MXNET_TPU_SERVE_STRICT_BUDGET', '1')
    prefix_a = _ckpt_prefix(tmp_path, 'stable2', 1)
    prefix_b = _ckpt_prefix(tmp_path, 'cand2', 2)
    live = _replica([], index=0, budget_bytes=1).start()   # any load 507
    sup = FleetSupervisor(models=[_push_spec(prefix_a)], replicas=1,
                          ctx=CPU)
    try:
        sup._replicas = [_fake_rep(0, *live.address)]
        with pytest.raises(MXNetError, match='refused'):
            sup.push('m', prefix_b, epoch=0)
        assert not sup.push_active('m')
    finally:
        sup.router.close()
        live.close()


def test_respawn_reconciles_to_pushed_and_promoted_model(tmp_path):
    prefix_a = _ckpt_prefix(tmp_path, 'stable3', 1)
    prefix_b = _ckpt_prefix(tmp_path, 'cand3', 2)
    live = _replica([_push_spec(prefix_a)], index=0).start()
    sup = FleetSupervisor(models=[_push_spec(prefix_a)], replicas=1,
                          ctx=CPU)
    try:
        sup._replicas = [_fake_rep(0, *live.address)]
        cand = sup.push('m', prefix_b, epoch=0, frac=0.5)
        rejoin = _replica([_push_spec(prefix_a)], index=1).start()
        try:
            sup._reconcile(*rejoin.address, cfg_names=('m',))
            assert set(rejoin.registry.models()) == {'m', cand}
            sup._on_router_event('promote', 'm',
                                 {'candidate': cand, 'report': None})
            assert not sup.push_active('m')
            assert sup.active_prefixes('m') == {prefix_b}
            sup._reconcile(*rejoin.address, cfg_names=('m', cand))
            assert set(rejoin.registry.models()) == {cand}
        finally:
            rejoin.close()
    finally:
        sup.router.close()
        live.close()


# ---------------------------------------------------------------------------
# the end-to-end drill: real replica processes, SIGKILL mid-load
# ---------------------------------------------------------------------------

def test_supervisor_sigkill_respawn_e2e(monkeypatch, tmp_path):
    prefix = str(tmp_path / 'fleet_m')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(1), {})
    monkeypatch.setenv('MXNET_TPU_FLEET_HEARTBEAT_S', '0.2')
    monkeypatch.setenv('MXNET_TPU_FLEET_DEAD_AFTER_S', '1.0')
    sup = FleetSupervisor(
        models=[{'name': 'm', 'prefix': prefix, 'epoch': 0,
                 'input_shapes': {'data': [1, DIM]},
                 'max_batch': 4, 'max_wait_us': 0,
                 'deadline_ms': 10000}],
        replicas=2, ctx=CPU)
    try:
        sup.start()
        sup.wait_healthy(timeout=120)
        host, port = sup.router.address
        url = 'http://%s:%d/v1/models/m:predict' % (host, port)
        x = _x().tolist()
        failures = []
        done = threading.Event()

        def client():
            for _ in range(30):
                try:
                    st, _ = post_with_backoff(url, {'instances': x},
                                              deadline_s=60)
                    if st != 200:
                        failures.append(st)
                except Exception as e:
                    failures.append(repr(e))
            done.set()

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.3)                 # requests in flight
        victim = sup.replicas()[0]
        victim.proc.send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        t.join(timeout=180)
        assert done.is_set(), 'client hung through the replica death'
        assert not failures, failures[:3]
        respawned = False
        while time.monotonic() - t_kill < 90:
            live = sup.replicas()
            if len(live) >= 2 and all(sup._probe(r) for r in live):
                respawned = True
                break
            time.sleep(0.2)
        assert respawned, 'replica not respawned within the window'
        assert sup.stats()['restarts'] >= 1
        st = json.loads(urllib.request.urlopen(
            'http://%s:%d/statsz' % (host, port), timeout=30).read())
        assert st['fleet_supervisor'][
            'fleet_supervisor_replica_restarts'] >= 1
        assert st['supervisor']['restarts'] >= 1
        assert len([r for r in st['supervisor']['replicas']
                    if r['alive']]) >= 2
        # the answers are the checkpoint's, from the respawned fleet too
        want = Predictor.from_checkpoint(prefix, 0, {'data': (1, DIM)},
                                         ctx=CPU).predict(_x())
        st, body = post_with_backoff(url, {'instances': x}, deadline_s=60)
        assert st == 200
        np.testing.assert_allclose(np.asarray(body['outputs'][0]), want,
                                   **JAX_TOL)
    finally:
        sup.stop()


# ---------------------------------------------------------------------------
# profiler family
# ---------------------------------------------------------------------------

def test_fleet_supervisor_counters_in_summary_and_dump(tmp_path):
    profiler.clear()
    profiler.add_fleet_supervisor_stats(
        replica_spawns=3, replica_restarts=1, replica_retires=1,
        router_requests=10, router_retries=2, router_503=1,
        canary_pushes=1, canary_rollbacks=1, shadow_requests=4,
        shadow_divergences=2, replicas_live=2)
    fsn = profiler.fleet_supervisor_stats()
    assert fsn['fleet_supervisor_replica_spawns'] == 3
    assert fsn['fleet_supervisor_replicas_live'] == 2   # gauge
    profiler.add_fleet_supervisor_stats(replicas_live=3)
    assert profiler.fleet_supervisor_stats()[
        'fleet_supervisor_replicas_live'] == 3
    text = profiler.summary(print_out=False)
    for key in ('fleet_supervisor_replica_restarts',
                'fleet_supervisor_replicas_live',
                'fleet_supervisor_router_retries',
                'fleet_supervisor_canary_rollbacks',
                'fleet_supervisor_shadow_divergences'):
        assert key in text
    out = tmp_path / 'fleet_sup_profile.json'
    profiler.profiler_set_config(filename=str(out))
    profiler.dump_profile()
    events = json.loads(out.read_text())['traceEvents']
    meta = [e for e in events if e.get('name') == 'fleet_supervisor']
    assert meta and \
        meta[0]['args']['fleet_supervisor_replica_spawns'] == 3
    profiler.clear()
    assert profiler.fleet_supervisor_stats()[
        'fleet_supervisor_replica_spawns'] == 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _observations(n=60, seed=5):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = rs.randint(4)
        out.append({'p99_over_deadline': bool(kind == 0),
                    'backlog_rows': int(rs.choice([0, 0, 3, 70])),
                    'requests_delta': int(rs.choice([0, 0, 5]))})
    return out


@pytest.mark.parametrize('kw', [dict(), dict(up_after=2, down_after=3,
                                             backlog_hot=50)])
def test_scale_policy_decides_as_jax(kw):
    obs = _observations()
    ours = ScalePolicy(**kw)
    theirs = jfs.ScalePolicy(**kw)
    assert [ours.decide(o) for o in obs] == [theirs.decide(o) for o in obs]


KNOB_CASES = [
    ('REPLICA_KILL_AFTER_S', v) for v in ('3.5', '1:2.0', 'x', '')] + [
    ('REPLICA_WEDGE', v) for v in ('0,2', '1:5', 'bad', '')] + [
    ('CANARY_DEGRADE_MS', v) for v in ('80', '@v1:90', 'nope', '')] + [
    ('PUSH_FAIL', v) for v in ('2', 'two', '')]


@pytest.mark.parametrize('knob,value', KNOB_CASES)
def test_fault_knob_parsers_match_jax(knob, value, monkeypatch):
    monkeypatch.setenv('MXNET_TPU_FAULT_' + knob, value)
    if knob == 'REPLICA_KILL_AFTER_S':
        for i in (0, 1, 2):
            assert fs.replica_kill_after_s(i) == jfs.replica_kill_after_s(i)
    elif knob == 'REPLICA_WEDGE':
        for i in (0, 1, 2):
            for age in (0.0, 4.0, 6.0):
                assert fs.replica_wedged(i, age) == \
                    jfs.replica_wedged(i, age)
    elif knob == 'CANARY_DEGRADE_MS':
        for name in (None, 'm', 'm@v1', 'm@v2'):
            assert fs.canary_degrade_ms(name) == \
                jfs.canary_degrade_ms(name)
    else:
        assert fs.push_fail_n() == jfs.push_fail_n()


def _body(outs):
    return json.dumps({'outputs': outs}).encode()


OUTPUT_CASES = {
    'equal': ([[[1.0, 2.0]]], [[[1.0, 2.0]]]),
    'within': ([[[1.0, 2.0]]], [[[1.00005, 2.0]]]),
    'beyond': ([[[1.0, 2.0]]], [[[1.01, 2.0]]]),
    'shape': ([[[1.0, 2.0]]], [[[1.0, 2.0, 3.0]]]),
    'count': ([[[1.0]], [[2.0]]], [[[1.0]]]),
    'garbage': (None, [[[1.0]]]),
}


@pytest.mark.parametrize('case', sorted(OUTPUT_CASES))
@pytest.mark.parametrize('rtol', [None, 1e-2])
def test_outputs_close_matches_jax(case, rtol):
    a, b = OUTPUT_CASES[case]
    ba = b'not json' if a is None else _body(a)
    bb = _body(b)
    assert fs._outputs_close(ba, bb, rtol=rtol) == \
        jfs._outputs_close(ba, bb, rtol=rtol)


def test_replica_server_answers_as_jax(tmp_path):
    """One MXTPU001 checkpoint served by an in-process ReplicaServer of
    each package: the same answers over HTTP, within the JAX drill's
    tolerance, and the same admin replies."""
    prefix = str(tmp_path / 'both')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(4), {})
    spec = {'name': 'm', 'prefix': prefix, 'epoch': 0,
            'input_shapes': {'data': [1, DIM]}, 'max_batch': 4,
            'max_wait_us': 0}
    ours = _replica([spec], index=0).start()
    theirs = jfs.ReplicaServer(models=[spec], index=0).start()
    try:
        for seed in range(4):
            body = {'instances': _x(seed=seed).tolist()}
            s1, _h, b1 = fs._http_json('POST', *ours.address,
                                       '/v1/models/m:predict', body)
            s2, _h, b2 = fs._http_json('POST', *theirs.address,
                                       '/v1/models/m:predict', body)
            assert s1 == s2 == 200
            np.testing.assert_allclose(np.asarray(b1['outputs'][0]),
                                       np.asarray(b2['outputs'][0]),
                                       **JAX_TOL)
        for path in ('/v1/models/m:unload', '/v1/models/ghost:unload'):
            s1, _h, b1 = fs._http_json('POST', *ours.address, path, {})
            s2, _h, b2 = fs._http_json('POST', *theirs.address, path, {})
            assert (s1, b1) == (s2, b2)
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# the device: no CPU in place of the card
# ---------------------------------------------------------------------------

def test_replica_on_the_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for ctx in (mx.gpu(0), 'gpu(0)'):
        with pytest.raises(MXNetError, match='is_available'):
            ReplicaServer(models=[], ctx=ctx)
    with pytest.raises(MXNetError, match='bad replica context'):
        ReplicaServer(models=[], ctx='tpu0')


def test_supervisor_spawn_fails_when_replicas_cannot_reach_the_card(
        tmp_path, monkeypatch):
    """A supervisor with the default device on a host without CUDA:
    each replica raises at boot, so the fleet does not start."""
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA: the refusal is for one without')
    prefix = _ckpt_prefix(tmp_path, 'nocard', 1)
    monkeypatch.setenv('MXNET_TPU_FLEET_SPAWN_TIMEOUT_S', '60')
    sup = FleetSupervisor(models=[_push_spec(prefix)], replicas=1)
    assert str(sup.ctx) == 'gpu(0)'
    try:
        with pytest.raises(MXNetError, match='failed to start'):
            sup.start()
        assert sup.live_replicas() == 0
    finally:
        sup.stop()


def test_serve_fleet_tool_starts_and_stops_a_cpu_fleet(tmp_path):
    from mxnet_tpu_torch.tools import serve_fleet
    prefix = _ckpt_prefix(tmp_path, 'tool', 3)
    ready, stop = {}, threading.Event()
    done = threading.Event()

    def run():
        with mx.cpu():
            try:
                serve_fleet.main(['--model', 'm=%s:0:data=1x%d'
                                  % (prefix, DIM), '--replicas', '1',
                                  '--port', '0', '--max-batch', '4'],
                                 stop=stop, on_ready=ready.update)
            finally:
                done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 120
    while not ready and time.time() < deadline and not done.is_set():
        time.sleep(0.05)
    try:
        assert ready, 'the fleet never came up'
        assert str(ready['supervisor'].ctx) == 'cpu(0)'
        host, port = ready['address']
        st, body = post_with_backoff(
            'http://%s:%d/v1/models/m:predict' % (host, port),
            {'instances': _x().tolist()}, deadline_s=60)
        assert st == 200
        want = Predictor.from_checkpoint(prefix, 0, {'data': (1, DIM)},
                                         ctx=CPU).predict(_x())
        np.testing.assert_allclose(np.asarray(body['outputs'][0]), want,
                                   **JAX_TOL)
    finally:
        stop.set()
        t.join(timeout=60)
    assert done.is_set() and not t.is_alive()
    with pytest.raises(SystemExit):
        serve_fleet.main(['--replicas', '1'])     # --model is required


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 24
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


def _good_router_run():
    return dict(sent=16, answers=16, unequal=[], launches_per_call=[24] * 40,
                shadow_requests=16, shadow_divergences=0, close_hung=0,
                in_flight_at_close=2, close_untyped=[], close_max_s=0.2,
                after_close_ok=8, after_close_unequal=0,
                other_launches=dict(conv_bn_stats=0, flash_bwd_dkdv=0,
                                    flash_bwd_dq=0, rtc=0))


def test_router_gate_passes_a_good_run():
    assert CS.router_gate(_good_router_run()) == []


@pytest.mark.parametrize('edit, word', [
    (lambda r: r.update(answers=15), 'through the router'),
    (lambda r: r.update(unequal=[3]), 'bit-equal'),
    (lambda r: r.update(launches_per_call=[24, 23]), 'flash launches'),
    (lambda r: r.update(shadow_divergences=1), 'divergences'),
    (lambda r: r.update(shadow_requests=0), 'shadow'),
    (lambda r: r.update(close_hung=1), 'hung'),
    (lambda r: r.update(in_flight_at_close=0), 'in flight'),
    (lambda r: r.update(close_untyped=[{'code': 500}]), 'typed'),
    (lambda r: r.update(close_max_s=99.0), 'deadline'),
    (lambda r: r.update(after_close_ok=0), 'survivor'),
    (lambda r: r['other_launches'].update(conv_bn_stats=1), 'conv_bn'),
])
def test_router_gate_fails_a_bad_run(edit, word):
    run = _good_router_run()
    edit(run)
    bad = CS.router_gate(run)
    assert bad and any(word in b for b in bad), bad
