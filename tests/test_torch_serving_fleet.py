"""The port's serving fleet (mxnet_tpu_torch/serving_fleet.py:
ModelRegistry, SLO batching and shedding, HttpFront, ContinuousEngine)
on the CPU, then held against the JAX package's.

- the 43 contracts of tests/test_serving_fleet.py on the port (the three
  re-created-engine zero-build tests are cases of one test): registry
  LRU paging with no program built on a re-warm, pinned and priority
  eviction, checkpoint loaders, strict budgets, SLO holds and typed
  sheds, the HTTP front's 200/400/404/429 mapping and keep-alive,
  continuous batching bit-equal against solo runs, chunked against
  unchunked, staged against serialized, tick_chunk='auto', close() and
  eviction races, the profiler's fleet counters;
- against the JAX package on the same seeded inputs: registry answers
  (a loader= Predictor and a prefix= checkpoint, 1e-5), ContinuousEngine
  outputs for the JAX tests' cell and a cut PTB scorer cell over mixed
  lengths at K = 1, 4 and 'auto' (1e-5), the deterministic counters, the
  stats() key sets, both fronts' /healthz, /statsz and predict replies,
  a tiny LM scorer registered by source= (the JAX one on Pallas flash in
  interpret mode, the port's on plain attention), fault_knob and the
  SWAP_DROP_STATE drill;
- the default device without CUDA, the refusals of apply_delta,
  tools/serve_http.py, and chip_smoke.py's gate of phase 20.

Every thread join and wait has a timeout.
"""
import http.client
import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import serving_fleet as jfleet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler, sym
from mxnet_tpu_torch import model as model_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import (TICK_CHUNK_KNOB, InferenceEngine,
                                     chunk_for_deadline, resolve_tick_chunk)
from mxnet_tpu_torch.serving_fleet import (SLO, BudgetExceeded,
                                           ContinuousEngine, HttpFront,
                                           ModelRegistry, Overloaded)

REPO = Path(__file__).resolve().parents[1]
CPU = mx.cpu()
DIM = 6
HID = 8
OUT = 3
F32 = dict(rtol=2e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_S = 60


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


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


def _params(seed=7, pkg=mx):
    kw = dict(ctx=CPU) if pkg is mx else {}
    return {k: pkg.nd.array(v, **kw) for k, v in _np_params(seed).items()}


def _loader(seed, pkg=mx):
    if pkg is mx:
        return lambda: Predictor(symbol=_mlp(), arg_params=_params(seed),
                                 input_shapes={'data': (1, DIM)}, ctx=CPU)
    from mxnet_tpu.predictor import Predictor as JPredictor
    return lambda: JPredictor(symbol=_mlp(jmx),
                              arg_params=_params(seed, jmx),
                              input_shapes={'data': (1, DIM)})


def _ref(seed, x):
    return Predictor(symbol=_mlp(), arg_params=_params(seed),
                     input_shapes={'data': (x.shape[0], DIM)},
                     ctx=CPU).forward(data=x)[0].asnumpy()


def _x(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, DIM).astype(np.float32)


def _registry(**kw):
    return ModelRegistry(ctx=CPU, **kw)


def _join(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), 'a thread hung'


# ---------------------------------------------------------------------------
# registry: residency, paging, re-warm
# ---------------------------------------------------------------------------

def test_registry_infer_parity_and_unknown_model():
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=4, max_wait_us=0)
        x = _x(2, seed=3)
        out = reg.infer('m', x)
        np.testing.assert_allclose(out[0], _ref(1, x), **F32)
        np.testing.assert_allclose(reg.predict('m', x), out[0])
        with pytest.raises(MXNetError, match='unknown model'):
            reg.infer('nope', x)
        with pytest.raises(MXNetError, match='already registered'):
            reg.register('m', loader=_loader(1))
    with pytest.raises(MXNetError, match='closed'):
        reg.infer('m', x)


def test_registry_lru_evict_rewarm_zero_compiles():
    # the budget fits ONE model: alternating traffic pages m1/m2 in and
    # out, and once both warmed, a re-warm builds no program
    x = _x(2, seed=5)
    ref1, ref2 = _ref(1, x), _ref(2, x)
    with _registry(budget_bytes=400) as reg:
        reg.register('m1', loader=_loader(1), max_batch=4, max_wait_us=0)
        reg.register('m2', loader=_loader(2), max_batch=4, max_wait_us=0)
        np.testing.assert_allclose(reg.infer('m1', x)[0], ref1, **F32)
        np.testing.assert_allclose(reg.infer('m2', x)[0], ref2, **F32)
        st = reg.stats()
        assert st['evictions'] >= 1
        assert st['resident_bytes'] <= 400
        before = exec_cache.stats()['misses']
        for _ in range(2):
            np.testing.assert_allclose(reg.infer('m1', x)[0], ref1, **F32)
            np.testing.assert_allclose(reg.infer('m2', x)[0], ref2, **F32)
        assert exec_cache.stats()['misses'] == before
        st = reg.stats()
        assert st['evictions'] >= 4
        assert st['models']['m2']['resident']
        assert not st['models']['m1']['resident']
        assert st['models']['m2']['engine']['compiles_after_warmup'] == 0


def test_registry_pinned_source_never_evicted():
    pred = _loader(1)()
    with _registry(budget_bytes=400) as reg:
        reg.register('pinned', source=pred, max_batch=4, max_wait_us=0)
        reg.register('pageable', loader=_loader(2), max_batch=4,
                     max_wait_us=0)
        x = _x(1)
        reg.infer('pageable', x)
        reg.infer('pinned', x)           # over budget: pageable pays
        st = reg.stats()
        assert st['models']['pinned']['resident']
        assert st['models']['pinned']['pinned']
        assert not st['models']['pageable']['resident']
        reg.budget_bytes = 1
        reg._enforce_budget()
        assert reg.stats()['models']['pinned']['resident']
        with pytest.raises(MXNetError, match='pinned'):
            reg.evict('pinned')
        assert reg.stats()['models']['pinned']['resident']


def test_registry_priority_evict_order():
    with _registry() as reg:
        reg.register('low', loader=_loader(1), slo=SLO(priority=0),
                     max_batch=2, max_wait_us=0)
        reg.register('high', loader=_loader(2), slo=SLO(priority=2),
                     max_batch=2, max_wait_us=0)
        x = _x(1)
        reg.infer('high', x)
        time.sleep(0.01)
        reg.infer('low', x)           # most recent, lowest priority
        reg.budget_bytes = 400
        reg._enforce_budget()
        st = reg.stats()
        assert not st['models']['low']['resident']
        assert st['models']['high']['resident']


def test_registry_prefix_loader_from_checkpoint(tmp_path):
    prefix = str(tmp_path / 'fleet_model')
    model_mod.save_checkpoint(prefix, 3, _mlp(), _params(9), {})
    x = _x(2, seed=1)
    with _registry() as reg:
        reg.register('ckpt', prefix=prefix, epoch=3,
                     input_shapes={'data': (1, DIM)}, max_batch=4,
                     max_wait_us=0)
        np.testing.assert_allclose(reg.infer('ckpt', x)[0], _ref(9, x),
                                   **F32)
        reg.evict('ckpt')
        assert not reg.stats()['models']['ckpt']['resident']
        np.testing.assert_allclose(reg.infer('ckpt', x)[0], _ref(9, x),
                                   **F32)
    with pytest.raises(MXNetError, match='exactly one of'):
        _registry().register('bad', prefix=prefix, loader=_loader(1))


def test_registry_unregister_removes_and_frees():
    x = _x(1)
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=2, max_wait_us=0)
        reg.infer('m', x)
        assert reg.stats()['resident_bytes'] > 0
        reg.unregister('m')
        assert reg.stats()['resident_bytes'] == 0
        with pytest.raises(MXNetError, match='unknown model'):
            reg.infer('m', x)
        with pytest.raises(MXNetError, match='unknown model'):
            reg.unregister('m')
        reg.register('m', loader=_loader(2), max_batch=2, max_wait_us=0)
        np.testing.assert_allclose(reg.infer('m', x)[0], _ref(2, x), **F32)
        reg.register('pinned', source=_loader(1)(), max_batch=2,
                     max_wait_us=0)
        reg.infer('pinned', x)
        reg.unregister('pinned')
        assert 'pinned' not in reg.models()


def test_registry_strict_budget_refuses_typed(monkeypatch):
    x = _x(1)
    monkeypatch.delenv('MXNET_TPU_SERVE_STRICT_BUDGET', raising=False)
    with _registry(budget_bytes=400) as reg:
        reg.register('pinned', source=_loader(1)(), max_batch=2,
                     max_wait_us=0)
        reg.register('extra', loader=_loader(2), max_batch=2,
                     max_wait_us=0)
        reg.infer('pinned', x)
        reg.infer('extra', x)            # non-strict: overshoot stands
        assert reg.stats()['resident_bytes'] > 400
    monkeypatch.setenv('MXNET_TPU_SERVE_STRICT_BUDGET', '1')
    with _registry(budget_bytes=400) as reg:
        reg.register('pinned', source=_loader(1)(), max_batch=2,
                     max_wait_us=0)
        reg.register('extra', loader=_loader(2), max_batch=2,
                     max_wait_us=0)
        reg.infer('pinned', x)
        with pytest.raises(BudgetExceeded) as ei:
            reg.infer('extra', x)
        assert isinstance(ei.value, MXNetError)
        assert ei.value.budget_bytes == 400
        st = reg.stats()
        assert st['strict_budget'] is True
        assert not st['models']['extra']['resident']
        assert st['resident_bytes'] <= 400
        np.testing.assert_allclose(reg.infer('pinned', x)[0], _ref(1, x),
                                   **F32)


def test_registry_strict_budget_preload_refusal(monkeypatch, tmp_path):
    monkeypatch.setenv('MXNET_TPU_SERVE_STRICT_BUDGET', '1')
    prefix = str(tmp_path / 'big')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(3), {})
    with _registry(budget_bytes=100) as reg:   # < params bytes
        reg.register('big', prefix=prefix, epoch=0,
                     input_shapes={'data': (1, DIM)}, max_batch=2,
                     max_wait_us=0)
        with pytest.raises(BudgetExceeded):
            reg.infer('big', _x(1))
        st = reg.stats()
        assert st['loads'] == 0          # refused before loading
        assert st['resident_bytes'] == 0


def test_registry_preload_eviction_keeps_peak_under_budget(tmp_path):
    # the budget sits above one model's estimate (its ~588-byte param
    # file) and below two models' bytes
    prefix = str(tmp_path / 'est')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(4), {})
    assert os.path.getsize(prefix + '-0000.params') < 620
    x = _x(1)
    with _registry(budget_bytes=620) as reg:
        for name in ('a', 'b'):
            reg.register(name, prefix=prefix, epoch=0,
                         input_shapes={'data': (1, DIM)}, max_batch=2,
                         max_wait_us=0)
        reg.infer('a', x)
        reg.infer('b', x)                # evicts 'a' BEFORE loading
        reg.infer('a', x)
        st = reg.stats()
        assert st['evictions'] >= 2
        assert st['peak_resident_bytes'] <= 620
        reg.budget_bytes = 200           # an estimate over the budget
        out = reg.infer('b', x)
        assert out[0].shape == (1, OUT)


def test_registry_concurrent_loads_keep_peak_under_budget(tmp_path):
    # the port serializes loads: three models first used at once from
    # three threads, each with a known size, never overshoot together
    # (the JAX package loads them concurrently, and two loads that both
    # passed the pre-load check overshoot)
    import sys
    prefix = str(tmp_path / 'conc')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(4), {})
    x = _x(1, seed=4)
    ref = _ref(4, x)
    errors = []
    names = ('a', 'b', 'c')
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # thread switches at every turn
    try:
        with _registry(budget_bytes=620) as reg:
            for name in names:
                reg.register(name, prefix=prefix, epoch=0,
                             input_shapes={'data': (1, DIM)}, max_batch=2,
                             max_wait_us=0)

            def traffic(name):
                try:
                    for _ in range(4):
                        np.testing.assert_allclose(reg.infer(name, x)[0],
                                                   ref, **F32)
                except Exception as e:
                    errors.append(e)

            # more threads than this machine's cores, over three models
            ts = [threading.Thread(target=traffic, args=(names[i % 3],))
                  for i in range(max(8, 2 * (os.cpu_count() or 1)))]
            for t in ts:
                t.start()
            _join(ts, 120)
            st = reg.stats()
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert st['evictions'] >= 2
    assert st['peak_resident_bytes'] <= 620
    # the ledger holds exactly the resident models' bytes: a lost update
    # of the byte count under the races would break it
    assert st['resident_bytes'] == sum(
        m['bytes'] for m in st['models'].values() if m['resident'])


def test_reloaded_symbol_takes_its_shapes_from_the_json_memo(monkeypatch):
    # a re-warm loads the checkpoint's symbol again (another object, the
    # same JSON): its binds' shape inference is served from the memo, and
    # a graph that differs in one attribute is not
    from mxnet_tpu_torch import symbol as sym_mod
    from mxnet_tpu_torch.ops import registry
    calls = []
    real = registry.OpDef.infer_shape

    def counting(self, *args, **kwargs):
        calls.append(self.name)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(registry.OpDef, 'infer_shape', counting)
    js = _mlp().tojson()
    first = sym.load_json(js).infer_shape(data=(5, DIM))
    n_first = len(calls)
    assert n_first > 0
    again = sym.load_json(js).infer_shape(data=(5, DIM))
    assert again == first and len(calls) == n_first
    other = sym.load_json(js.replace('"num_hidden": "%d"' % OUT,
                                     '"num_hidden": "%d"' % (OUT + 1)))
    assert other.infer_shape(data=(5, DIM))[1] == [(5, OUT + 1)]
    assert len(calls) > n_first
    assert sym.load_json(js).infer_shape(data=(7, DIM))[1] == [(7, OUT)]
    assert len(sym_mod._JSON_SHAPES) <= sym_mod._JSON_SHAPES_MAX


# ---------------------------------------------------------------------------
# SLO: deadline-derived holds, shed-on-backlog
# ---------------------------------------------------------------------------

def test_slo_deadline_drives_batcher_hold():
    assert SLO(deadline_ms=40).wait_us() == 10000
    assert SLO().wait_us() is None
    with _registry() as reg:
        reg.register('m', loader=_loader(1), slo=SLO(deadline_ms=40),
                     max_batch=8)
        assert reg.engine('m').max_wait_us == 10000
        reg.register('m2', loader=_loader(2), slo=SLO(deadline_ms=40),
                     max_batch=8, max_wait_us=123)
        assert reg.engine('m2').max_wait_us == 123


def test_shed_on_backlog_typed_error():
    profiler.clear()
    with _registry() as reg:
        reg.register('m', loader=_loader(1),
                     slo=SLO(deadline_ms=1.0, service_ms_hint=500.0),
                     max_batch=4, max_wait_us=0)
        with pytest.raises(Overloaded) as ei:
            reg.infer('m', _x(1))
        e = ei.value
        assert e.model == 'm'
        assert e.est_ms > e.deadline_ms == 1.0
        assert e.retry_after_ms >= 1.0
        assert isinstance(e, MXNetError)
        assert reg.engine('m').stats()['requests'] == 0
        assert reg.stats()['shed_requests'] == 1
    assert profiler.fleet_stats()['fleet_shed_requests'] == 1


def test_shed_hard_queue_cap():
    with _registry() as reg:
        reg.max_queue_rows = 0
        reg.register('m', loader=_loader(1), max_batch=4,
                     max_wait_us=1000000)
        eng = reg.engine('m')
        t = threading.Thread(target=lambda: eng.infer(_x(1)))
        t.start()                        # parks one row in the queue
        deadline = time.time() + 10
        while time.time() < deadline and eng.backlog_rows() == 0:
            time.sleep(0.005)
        with pytest.raises(Overloaded):
            reg.infer('m', _x(1))
        eng.close()                      # drains the parked request
        _join([t], 30)


class _ClosingEngine(object):
    """An engine-like tenant that is evicted under every request: its
    infer() closes it and raises the closed error after `delay_s`."""

    def __init__(self, delay_s):
        self.delay_s = delay_s
        self.closed = False

    def infer(self, *args):
        time.sleep(self.delay_s)
        self.closed = True
        raise MXNetError('_ClosingEngine is closed')

    def close(self):
        self.closed = True


def test_eviction_race_past_the_deadline_sheds_typed():
    # the retry window is the tenant's deadline; once it has run out the
    # port sheds with Overloaded (HTTP 429), where the JAX package
    # re-raises the closed error (HTTP 503 'closing')
    loads = []

    def loader():
        loads.append(1)
        return _ClosingEngine(0.01)

    with _registry() as reg:
        reg.register('m', loader=loader, slo=SLO(deadline_ms=25.0))
        with pytest.raises(Overloaded) as ei:
            reg.infer('m', _x(1))
        assert ei.value.deadline_ms == 25.0
        assert reg.stats()['shed_requests'] == 1
        assert len(loads) >= 2           # it did retry within the window
        with HttpFront(reg, port=0).start() as front:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('http://%s:%d/v1/models/m:predict' % front.address,
                      {'instances': _x(1).tolist()})
            assert ei.value.code == 429
            assert 'Retry-After' in ei.value.headers


def test_submit_then_close_still_answers():
    # submit() enqueues and returns a waiter; a close() after it drains
    # the queue, so the request is answered (the registry enqueues the
    # request that caused a load this way before the next load can evict)
    x = _x(2, seed=6)
    eng = InferenceEngine(_loader(1)(), max_batch=4, max_wait_us=100000)
    wait = eng.submit(x)
    eng.close()
    np.testing.assert_allclose(wait()[0], _ref(1, x), **F32)
    with pytest.raises(MXNetError, match='closed'):
        eng.submit(x)
    ceng = _cont(slots=2)
    seq = _seqs([5], seed=3)[0]
    cwait = ceng.submit(seq)
    ceng.close()
    with _cont(slots=2) as ref:
        _bit_equal([cwait()], [ref.infer(seq)])
    with pytest.raises(MXNetError, match='closed'):
        ceng.submit(seq)


def test_measured_service_rate_takes_over_hint():
    with _registry() as reg:
        reg.register('m', loader=_loader(1),
                     slo=SLO(deadline_ms=60000.0, service_ms_hint=50000.0),
                     max_batch=4, max_wait_us=0)
        out = reg.infer('m', _x(1))
        assert out[0].shape == (1, OUT)
        est = reg.engine('m').service_estimate()
        assert est is not None
        svc_ms, rows = est
        assert 0 < svc_ms < 50000.0 and rows >= 1.0


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    return urllib.request.urlopen(req, timeout=30)


def _get(url):
    return urllib.request.urlopen(url, timeout=30)


def test_http_predict_healthz_statsz_roundtrip():
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=4, max_wait_us=0)
        with HttpFront(reg, port=0).start() as front:
            base = 'http://%s:%d' % front.address
            x = _x(2, seed=8)
            resp = _post('%s/v1/models/m:predict' % base,
                         {'instances': x.tolist()})
            assert resp.status == 200
            outs = json.loads(resp.read())['outputs']
            np.testing.assert_allclose(np.asarray(outs[0]), _ref(1, x),
                                       rtol=2e-6, atol=1e-5)
            resp = _post('%s/v1/models/m:predict' % base,
                         {'inputs': {'data': x.tolist()}})
            assert resp.status == 200
            h = _get('%s/healthz' % base)
            assert h.status == 200
            assert json.loads(h.read())['models'] == ['m']
            st = json.loads(_get('%s/statsz' % base).read())
            assert st['models']['m']['resident']
            assert st['models']['m']['engine']['requests'] >= 2
            assert st['http']['requests'] >= 2
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('%s/v1/models/ghost:predict' % base,
                      {'instances': x.tolist()})
            assert ei.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('%s/v1/models/m:predict' % base, {'bogus': 1})
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get('%s/nothing' % base)
            assert ei.value.code == 404


def test_http_backpressure_429_and_shed_mapping():
    profiler.clear()
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=4, max_wait_us=0)
        reg.register('shed', loader=_loader(2),
                     slo=SLO(deadline_ms=1.0, service_ms_hint=500.0),
                     max_batch=4, max_wait_us=0)
        with HttpFront(reg, port=0, max_inflight=0).start() as front:
            base = 'http://%s:%d' % front.address
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('%s/v1/models/m:predict' % base,
                      {'instances': _x(1).tolist()})
            assert ei.value.code == 429
            assert int(ei.value.headers['Retry-After']) >= 1
            assert _get('%s/healthz' % base).status == 200
        with HttpFront(reg, port=0).start() as front:
            base = 'http://%s:%d' % front.address
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('%s/v1/models/shed:predict' % base,
                      {'instances': _x(1).tolist()})
            assert ei.value.code == 429
            body = json.loads(ei.value.read())
            assert body['error'] == 'overloaded'
            assert body['deadline_ms'] == 1.0
            assert 'Retry-After' in ei.value.headers
    fl = profiler.fleet_stats()
    assert fl['fleet_http_requests'] >= 2
    assert fl['fleet_http_429'] >= 2


def test_http_keepalive_survives_early_replies():
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=4, max_wait_us=0)
        with HttpFront(reg, port=0).start() as front:
            host, port = front.address
            conn = http.client.HTTPConnection(host, port, timeout=30)
            try:
                body = json.dumps({'instances': _x(1).tolist()}).encode()
                conn.request('POST', '/v1/models/ghost:predict', body,
                             {'Content-Type': 'application/json'})
                r = conn.getresponse()
                assert r.status == 404
                r.read()
                conn.request('POST', '/v1/models/m:predict', body,
                             {'Content-Type': 'application/json'})
                r = conn.getresponse()
                assert r.status == 200
                out = json.loads(r.read())['outputs']
                assert np.asarray(out[0]).shape == (1, OUT)
            finally:
                conn.close()


def test_http_priority_reserve_admits_interactive_tenant():
    with _registry() as reg:
        reg.register('batch', loader=_loader(1), max_batch=4,
                     max_wait_us=0)
        reg.register('inter', loader=_loader(2), slo=SLO(priority=1),
                     max_batch=4, max_wait_us=0)
        with HttpFront(reg, port=0, max_inflight=1,
                       priority_reserve=1).start() as front:
            base = 'http://%s:%d' % front.address
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post('%s/v1/models/batch:predict' % base,
                      {'instances': _x(1).tolist()})
            assert ei.value.code == 429
            resp = _post('%s/v1/models/inter:predict' % base,
                         {'instances': _x(1).tolist()})
            assert resp.status == 200


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

CDIM, CHID, COUT = 5, 4, 2


def _cell(pkg=mx):
    data = pkg.sym.Variable('data')
    h_in = pkg.sym.Variable('h')
    pre = pkg.sym.FullyConnected(data, num_hidden=CHID, name='ix') + \
        pkg.sym.FullyConnected(h_in, num_hidden=CHID, no_bias=True,
                               name='hh')
    h_new = pkg.sym.Activation(pre, act_type='tanh')
    head = pkg.sym.FullyConnected(h_new, num_hidden=COUT, name='out')
    return pkg.sym.Group([head, h_new])


def _np_cell_params(seed=3):
    rs = np.random.RandomState(seed)
    return {
        'ix_weight': rs.randn(CHID, CDIM).astype(np.float32) * .3,
        'ix_bias': np.zeros(CHID, np.float32),
        'hh_weight': rs.randn(CHID, CHID).astype(np.float32) * .3,
        'out_weight': rs.randn(COUT, CHID).astype(np.float32) * .3,
        'out_bias': np.zeros(COUT, np.float32),
    }


def _cont(slots=2, convoy=False, pkg=mx, **kw):
    if pkg is mx:
        kw.setdefault('ctx', CPU)
        params = {k: mx.nd.array(v, ctx=CPU)
                  for k, v in _np_cell_params().items()}
        engine = ContinuousEngine
    else:
        params = {k: jmx.nd.array(v) for k, v in _np_cell_params().items()}
        engine = jfleet.ContinuousEngine
    return engine(_cell(pkg), arg_params=params, data_shape=(CDIM,),
                  state_shapes={'h': (CHID,)}, state_outputs={'h': 1},
                  slots=slots, convoy=convoy, **kw)


def _seqs(lens, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(L, CDIM).astype(np.float32) for L in lens]


def _bit_equal(a, b):
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


def test_continuous_matches_host_recurrence():
    p = _np_cell_params()
    seq = _seqs([6])[0]
    with _cont(slots=3) as eng:
        out = eng.infer(seq)
    assert [o.shape for o in out] == [(6, COUT)]
    h = np.zeros(CHID, np.float32)
    ys = []
    for t in range(6):
        h = np.tanh(seq[t] @ p['ix_weight'].T + p['ix_bias'] +
                    h @ p['hh_weight'].T)
        ys.append(h @ p['out_weight'].T + p['out_bias'])
    np.testing.assert_allclose(out[0], np.stack(ys), rtol=1e-5, atol=1e-5)


def test_continuous_admit_retire_bit_parity_vs_solo():
    seqs = _seqs([3, 9, 2, 6, 4], seed=4)
    with _cont(slots=2) as eng:
        solo = [eng.infer(s) for s in seqs]
        res = [None] * len(seqs)

        def client(i):
            res[i] = eng.infer(seqs[i])

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(seqs))]
        for t in ts:
            t.start()
        _join(ts)
        st = eng.stats()
    _bit_equal(res, solo)
    assert st['admitted'] == st['retired'] == 2 * len(seqs)
    assert st['compiles_after_warmup'] == 0


def test_continuous_beats_convoy_ticks_deterministic():
    seqs = _seqs([2, 8, 2, 8], seed=6)
    with _cont(slots=2) as eng:
        cont_res = eng.infer_many(seqs)
        cont = eng.stats()
    with _cont(slots=2, convoy=True) as eng:
        conv_res = eng.infer_many(seqs)
        conv = eng.stats()
    assert cont['ticks'] == 12
    assert conv['ticks'] == 16
    assert cont['utilization'] > conv['utilization']
    _bit_equal(cont_res, conv_res)


RECREATE_CASES = {
    # engine kwargs of the first and the re-created engine
    'unchunked': (dict(slots=2), dict(slots=2), 3),
    'chunked': (dict(slots=4, tick_chunk=4), dict(slots=4, tick_chunk=4),
                6),
    # a hint starts the second on another K than the hintless climb
    'auto_k_change': (dict(slots=4, tick_chunk='auto',
                           slo=SLO(deadline_ms=200.0)),
                      dict(slots=4, tick_chunk='auto',
                           slo=SLO(deadline_ms=200.0), tick_ms_hint=0.5),
                      8),
}


@pytest.mark.parametrize('case', sorted(RECREATE_CASES))
def test_recreated_engine_zero_compiles(case):
    first, second, length = RECREATE_CASES[case]
    with _cont(**first) as eng:
        eng.infer(_seqs([length])[0])
    before = exec_cache.stats()['misses']
    with _cont(**second) as eng:
        eng.infer(_seqs([length])[0])
        assert eng.stats()['compiles_after_warmup'] == 0
    assert exec_cache.stats()['misses'] == before


def test_continuous_rejects_bad_specs():
    with pytest.raises(MXNetError, match='data_shape'):
        ContinuousEngine(_cell(), ctx=CPU)
    with pytest.raises(MXNetError, match='same states'):
        ContinuousEngine(_cell(), data_shape=(CDIM,),
                         state_shapes={'h': (CHID,)},
                         state_outputs={'g': 1}, ctx=CPU)
    with pytest.raises(MXNetError, match='out of range'):
        ContinuousEngine(_cell(), data_shape=(CDIM,),
                         state_shapes={'h': (CHID,)},
                         state_outputs={'h': 5}, ctx=CPU)
    with _cont(slots=2) as eng:
        with pytest.raises(MXNetError, match='sequence shape'):
            eng.infer(np.zeros((4, CDIM + 1), np.float32))
        with pytest.raises(MXNetError, match='sequence shape'):
            eng.infer(np.zeros((0, CDIM), np.float32))


def test_continuous_close_rejects_new_and_drains():
    eng = _cont(slots=2)
    res = {}

    def client():
        res['out'] = eng.infer(_seqs([30])[0])

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline and eng.stats()['admitted'] == 0:
        time.sleep(0.005)
    eng.close()                          # the in-flight sequence finishes
    _join([t], 30)
    assert res['out'][0].shape == (30, COUT)
    with pytest.raises(MXNetError, match='closed'):
        eng.infer(_seqs([2])[0])
    eng.close()                          # idempotent


# ---------------------------------------------------------------------------
# chunked continuous serving (tick_chunk=K)
# ---------------------------------------------------------------------------

def test_chunked_matches_unchunked_bitwise():
    # the unchunked reference at the same width: torch's CPU GEMMs round
    # a 2-row and a 4-row product otherwise, and the bit parity the port
    # claims is that of one width (the JAX test's reference runs at 2)
    seqs = _seqs([3, 9, 2, 6, 4], seed=4)
    with _cont(slots=4) as eng:
        ref = eng.infer_many(seqs)
    with _cont(slots=4, tick_chunk=4) as eng:
        got = eng.infer_many(seqs)
        st = eng.stats()
    _bit_equal(ref, got)
    assert st['tick_chunk'] == 4
    assert st['ticks'] == 4 * st['chunks']
    assert st['compiles_after_warmup'] == 0


def test_chunk_admit_quantization_and_boundary_wait():
    seqs = _seqs([2, 6, 4, 4, 4], seed=8)
    with _cont(slots=4, tick_chunk=4) as eng:
        res = eng.infer_many(seqs)
        st = eng.stats()
    with _cont(slots=4) as eng:         # the same width
        ref = eng.infer_many(seqs)
    _bit_equal(ref, res)
    assert st['chunks'] == 2 and st['ticks'] == 8
    assert st['admitted'] == 5 and st['retired'] == 5
    assert st['boundary_wait_ms'] > 0


def test_chunked_programs_never_alias_unchunked():
    with _cont(slots=4) as eng:
        eng.infer(_seqs([5])[0])
    with _cont(slots=4, tick_chunk=4) as eng:
        eng.infer(_seqs([5])[0])
    before = exec_cache.stats()['misses']
    with _cont(slots=4) as eng:
        a = eng.infer(_seqs([5])[0])
    with _cont(slots=4, tick_chunk=4) as eng:
        b = eng.infer(_seqs([5])[0])
    assert exec_cache.stats()['misses'] == before
    _bit_equal([a], [b])


@pytest.mark.parametrize('cell_kind', ['cell', 'ptb'])
def test_chunk_lone_and_exact_fill_fast_paths(cell_kind):
    # the lone rung is on only where its probe is bit-equal to the full
    # program: torch's CPU GEMMs may round a 1- or 2-row product
    # otherwise, and then the rung stays off (the JAX package's XLA CPU
    # enables it); either way the counts follow and the bits are the
    # full program's
    make = _cont if cell_kind == 'cell' else _ptb_engine
    seqs = _seqs if cell_kind == 'cell' else _ptb_seqs
    with make(slots=4, tick_chunk=4) as eng:
        st0 = eng.stats()
        exact_seqs = seqs([8] * 4, seed=9)
        res = eng.infer_many(exact_seqs)     # 2 exact-fill chunks
        lone_seq = seqs([8], seed=10)[0]
        lone_res = eng.infer(lone_seq)       # 2 lone chunks when on
        st = eng.stats()
    on = st0['lone_fast_path']
    assert st0['lone_fast_path_width'] == 0 if not on else \
        st0['lone_fast_path_width'] in (1, 2)
    assert st['exact_fill_admits'] == 2
    assert st['lone_fast_path_hits'] == (2 if on else 0)
    with make(slots=4) as eng:          # the same width
        ref = eng.infer_many(exact_seqs)
        lone_ref = eng.infer(lone_seq)
    _bit_equal(ref, res)
    _bit_equal([lone_ref], [lone_res])


@pytest.mark.parametrize('width', [1, 2])
def test_lone_rung_program_reads_and_writes_one_lane(width):
    # the rung's mechanics, apart from GEMM rounding: K ticks of one lane
    # of a width-row window at batch `width` give the full program's
    # values for that slot, and only that slot's state row is written
    from mxnet_tpu_torch import serving_fleet as sf
    K, slot = 4, 3
    eng = _cont(slots=4, tick_chunk=K)
    try:
        ex = eng._ex
        full = sf._make_cont_chunk_step(ex, 'data', ['h'], [1], None,
                                        torch.device('cpu'), K)
        lone = sf._make_cont_lone_step(ex, 'data', ['h'], [1], None,
                                       torch.device('cpu'), K, width)
        xs = torch.from_numpy(np.stack(_seqs([K] * 4, seed=2), axis=1))
        h0 = torch.from_numpy(np.random.RandomState(1).randn(
            4, CHID).astype(np.float32))
        fstate, lstate = [h0.clone()], [h0.clone()]
        reset = torch.tensor([False, True, False, False])
        fouts = full(ex, xs, reset, fstate, eng._weights(), eng._aux(),
                     eng._rng)
        start = min(slot, 4 - width)
        lane = slot - start
        lxs = torch.zeros((K, width, CDIM))
        lxs[:, lane] = xs[:, slot]
        louts = lone(eng._lone_executor(width), lxs,
                     torch.zeros(width, dtype=torch.bool), start, lane,
                     lstate, eng._weights(), eng._aux(), eng._rng)
        assert louts[0].shape == (K, width, COUT)
        np.testing.assert_allclose(louts[0][:, lane].numpy(),
                                   fouts[0][:, slot].numpy(), **F32)
        np.testing.assert_allclose(lstate[0][slot].numpy(),
                                   fstate[0][slot].numpy(), **F32)
        others = [i for i in range(4) if i != slot]
        assert torch.equal(lstate[0][others], h0[others])
    finally:
        eng.close()


def test_tick_chunk_knob_parse_and_reject(monkeypatch):
    monkeypatch.delenv(TICK_CHUNK_KNOB, raising=False)
    assert resolve_tick_chunk(None) == 1
    for off in (0, '0', 'off', 'none', 'false', '', 1, '1'):
        assert resolve_tick_chunk(off) == 1
    assert resolve_tick_chunk(4, slots=8) == 4
    assert resolve_tick_chunk('6', slots=8) == 6
    monkeypatch.setenv(TICK_CHUNK_KNOB, '4')
    assert resolve_tick_chunk(None, slots=8) == 4
    monkeypatch.setenv(TICK_CHUNK_KNOB, 'off')
    assert resolve_tick_chunk(None, slots=8) == 1
    monkeypatch.delenv(TICK_CHUNK_KNOB)
    with pytest.raises(MXNetError, match=TICK_CHUNK_KNOB):
        resolve_tick_chunk('garbage')
    with pytest.raises(MXNetError, match='K <= slots'):
        resolve_tick_chunk(8, slots=4)
    with pytest.raises(MXNetError, match='>= 0'):
        resolve_tick_chunk(-2)
    with pytest.raises(MXNetError, match=TICK_CHUNK_KNOB):
        _cont(slots=2, tick_chunk=5)
    monkeypatch.setenv(TICK_CHUNK_KNOB, '2')
    with _cont(slots=2) as eng:
        assert eng.stats()['tick_chunk'] == 2


def test_tick_chunk_slo_derived_default(monkeypatch):
    monkeypatch.delenv(TICK_CHUNK_KNOB, raising=False)
    monkeypatch.delenv('MXNET_TPU_SERVE_WAIT_FRACTION', raising=False)
    assert chunk_for_deadline(40.0, 1.0) == 11
    assert chunk_for_deadline(40.0, 1.0, slots=4) == 4
    assert resolve_tick_chunk(None, slots=4, slo=SLO(deadline_ms=40.0),
                              tick_ms_hint=1.0) == 4
    assert resolve_tick_chunk(None, slots=4,
                              slo=SLO(deadline_ms=40.0)) == 1
    with _cont(slots=4, slo=SLO(deadline_ms=40.0),
               tick_ms_hint=1.0) as eng:
        assert eng.stats()['tick_chunk'] == 4


def test_registry_forwards_tick_chunk():
    seen = {}

    def cont_loader(tick_chunk=None):
        seen['tick_chunk'] = tick_chunk
        return _cont(slots=4, tick_chunk=tick_chunk)

    with _registry() as reg:
        reg.register('seq', loader=cont_loader, tick_chunk=4)
        eng = reg.engine('seq')
        assert seen['tick_chunk'] == 4
        assert eng.stats()['tick_chunk'] == 4
        reg.register('seq2', loader=cont_loader, tick_chunk='off')
        reg.engine('seq2')
        assert seen['tick_chunk'] is None
        with pytest.raises(MXNetError, match='tick_chunk'):
            reg.register('ckpt', prefix='/nonexistent/model',
                         tick_chunk=4)
        with pytest.raises(MXNetError, match=TICK_CHUNK_KNOB):
            reg.register('bad', loader=cont_loader, tick_chunk='garbage')


def test_chunk_profiler_counters_flow():
    profiler.clear()
    with _cont(slots=4, tick_chunk=4) as eng:
        eng.infer_many(_seqs([6, 6], seed=11))
    fs = profiler.fleet_stats()
    assert fs['cont_chunks_dispatched'] >= 2
    assert fs['cont_chunk_ticks'] == 4 * fs['cont_chunks_dispatched']
    assert isinstance(fs['cont_boundary_wait_ms'], float)
    for key in ('cont_lone_fast_path', 'cont_exact_fill_admits'):
        assert key in fs
    text = profiler.summary(print_out=False)
    assert 'cont_chunks_dispatched' in text
    assert 'cont_boundary_wait_ms' in text
    profiler.clear()
    assert profiler.fleet_stats()['cont_boundary_wait_ms'] == 0.0
    profiler.add_fleet_stats(cont_boundary_wait_ms=0.5)
    assert profiler.fleet_stats()['cont_boundary_wait_ms'] == 0.5
    profiler.clear()


# ---------------------------------------------------------------------------
# staged chunks (stage_ahead) and tick_chunk='auto'
# ---------------------------------------------------------------------------

def test_staged_chunks_bit_parity_vs_serialized():
    seqs = _seqs([3, 9, 2, 6, 4], seed=4)
    with _cont(slots=4, tick_chunk=4, stage_ahead=0) as eng:
        ref = eng.infer_many(seqs)
        st0 = eng.stats()
    with _cont(slots=4, tick_chunk=4, stage_ahead=1) as eng:
        got = eng.infer_many(seqs)
        res = [None] * len(seqs)
        ts = [threading.Thread(target=lambda i=i:
                               res.__setitem__(i, eng.infer(seqs[i])))
              for i in range(len(seqs))]
        for t in ts:
            t.start()
        _join(ts)
        st1 = eng.stats()
    assert st0['stage_ahead'] == 0 and st0['staged_chunks'] == 0
    assert st1['stage_ahead'] == 1 and st1['staged_chunks'] >= 1
    assert st1['stage_overlap_ms'] >= 0.0
    assert st1['compiles_after_warmup'] == 0
    _bit_equal(ref, got)
    _bit_equal(res, ref)


def test_stage_ahead_env_knob(monkeypatch):
    seqs = _seqs([6, 6], seed=5)
    monkeypatch.setenv('MXNET_TPU_SERVE_STAGE_AHEAD', 'off')
    with _cont(slots=4, tick_chunk=4) as eng:
        a = eng.infer_many(seqs)
        st = eng.stats()
        assert st['stage_ahead'] == 0 and st['staged_chunks'] == 0
    monkeypatch.setenv('MXNET_TPU_SERVE_STAGE_AHEAD', '2')
    with _cont(slots=4, tick_chunk=4) as eng:
        b = eng.infer_many(seqs)
        st = eng.stats()
        assert st['stage_ahead'] == 2 and st['staged_chunks'] >= 1
    _bit_equal(a, b)


def test_tick_chunk_auto_requires_deadline():
    with pytest.raises(MXNetError, match="'auto' needs an SLO"):
        resolve_tick_chunk('auto', slots=4)
    with pytest.raises(MXNetError, match="'auto' needs an SLO"):
        _cont(slots=4, tick_chunk='auto')
    with pytest.raises(MXNetError, match="'auto' needs an SLO"):
        _cont(slots=4, tick_chunk='auto', slo=SLO(priority=1))


def test_tick_chunk_auto_converges_to_rung_zero_compiles():
    seqs = _seqs([8, 8, 8, 8], seed=6)
    with _cont(slots=4, tick_chunk=4) as eng:
        ref = eng.infer_many(seqs)
    with _cont(slots=4, tick_chunk='auto',
               slo=SLO(deadline_ms=200.0)) as eng:
        got = eng.infer_many(seqs)
        st = eng.stats()
    assert st['auto_tick_chunk'] is True
    assert st['tick_chunk'] == 4, st
    assert st['auto_k_decisions'] >= 1
    assert st['tick_ms_ema'] > 0.0
    assert st['compiles_after_warmup'] == 0
    _bit_equal(ref, got)


def test_registry_forwards_auto_tick_chunk():
    seen = {}

    def cont_loader(tick_chunk=None):
        seen['tick_chunk'] = tick_chunk
        return _cont(slots=4, tick_chunk=tick_chunk,
                     slo=SLO(deadline_ms=200.0))

    with _registry() as reg:
        reg.register('seq', loader=cont_loader, tick_chunk='auto')
        eng = reg.engine('seq')
        assert seen['tick_chunk'] == 'auto'
        assert eng.stats()['auto_tick_chunk'] is True


def test_overlap_profiler_counters_flow():
    profiler.clear()
    with _cont(slots=4, tick_chunk='auto', stage_ahead=1,
               slo=SLO(deadline_ms=200.0)) as eng:
        eng.infer_many(_seqs([8, 8, 8, 8], seed=7))
    ov = profiler.overlap_stats()
    assert ov['overlap_stage_chunks'] >= 1
    assert ov['overlap_auto_k_decisions'] >= 1
    assert ov['overlap_auto_k'] == 4
    assert isinstance(ov['overlap_stage_overlap_ms'], float)
    text = profiler.summary(print_out=False)
    assert 'overlap_stage_chunks' in text
    assert 'overlap_auto_k' in text
    profiler.clear()


# ---------------------------------------------------------------------------
# close() against eviction, and per-engine counters
# ---------------------------------------------------------------------------

def test_engine_close_safe_under_concurrent_infer_storm():
    eng = InferenceEngine(_loader(1)(), max_batch=4, max_wait_us=500)
    x = _x(1, seed=2)
    ref = _ref(1, x)
    results = []
    errors = []

    def client():
        for _ in range(20):
            try:
                results.append(eng.infer(x)[0])
            except MXNetError as e:
                assert 'closed' in str(e)
                errors.append(e)
                return

    ts = [threading.Thread(target=client) for _ in range(6)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    closers = [threading.Thread(target=eng.close) for _ in range(3)]
    for c in closers:
        c.start()
    _join(ts + closers)
    assert results
    for out in results:
        np.testing.assert_allclose(out, ref, **F32)
    eng.close()


def test_registry_eviction_race_is_absorbed():
    x = _x(1, seed=7)
    ref1, ref2 = _ref(1, x), _ref(2, x)
    with _registry(budget_bytes=400) as reg:
        reg.register('m1', loader=_loader(1), max_batch=2, max_wait_us=0)
        reg.register('m2', loader=_loader(2), max_batch=2, max_wait_us=0)
        errors = []

        def traffic(name, ref):
            try:
                for _ in range(12):
                    np.testing.assert_allclose(reg.infer(name, x)[0], ref,
                                               **F32)
            except Exception as e:
                errors.append(e)

        ts = [threading.Thread(target=traffic, args=('m1', ref1)),
              threading.Thread(target=traffic, args=('m2', ref2))]
        for t in ts:
            t.start()
        _join(ts, 120)
        assert not errors, errors
        assert reg.stats()['evictions'] >= 1


def test_per_engine_counter_scoping():
    profiler.clear()
    e1 = InferenceEngine(_loader(1)(), max_batch=4, max_wait_us=0)
    e2 = InferenceEngine(_loader(2)(), max_batch=4, max_wait_us=0)
    try:
        for i in range(3):
            e1.infer(_x(1, seed=i))
        e2.infer(_x(2, seed=9))
        s1, s2 = e1.stats(), e2.stats()
        assert s1['requests'] == 3 and s2['requests'] == 1
        assert s1['latency_p50_ms'] > 0 and s2['latency_p50_ms'] > 0
        assert s1['latency_p99_ms'] >= s1['latency_p50_ms']
        assert s1['service_ms_ema'] > 0
        assert s2['rows_per_batch_ema'] == pytest.approx(2.0)
        assert s1['backlog_rows'] == 0
        assert s1['serve_requests'] >= 4
    finally:
        e1.close()
        e2.close()


def test_fleet_counters_in_summary_and_dump(tmp_path):
    profiler.clear()
    with _registry(budget_bytes=400) as reg:
        reg.register('m1', loader=_loader(1), max_batch=2, max_wait_us=0)
        reg.register('m2', loader=_loader(2), max_batch=2, max_wait_us=0)
        reg.infer('m1', _x(1))
        reg.infer('m2', _x(1))
    with _cont(slots=2) as eng:
        eng.infer(_seqs([3])[0])
    fl = profiler.fleet_stats()
    assert fl['fleet_loads'] >= 2
    assert fl['fleet_evictions'] >= 1
    assert fl['cont_ticks'] >= 3
    assert 0 < fl['cont_utilization'] <= 1
    text = profiler.summary(print_out=False)
    for key in ('fleet_loads', 'fleet_evictions', 'fleet_http_requests',
                'fleet_resident_bytes', 'cont_utilization'):
        assert key in text
    out = tmp_path / 'fleet_profile.json'
    profiler.profiler_set_config(filename=str(out))
    profiler.dump_profile()
    events = json.loads(out.read_text())['traceEvents']
    meta = [e for e in events if e.get('name') == 'fleet']
    assert meta and meta[0]['args']['fleet_loads'] >= 2
    assert [e for e in events if e.get('name') == 'loop']
    assert [e for e in events if e.get('name') == 'overlap']


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['loader', 'prefix'])
def test_registry_answers_match_jax(kind, tmp_path):
    x = _x(3, seed=21)
    answers = {}
    for pkg, reg in ((mx, _registry()), (jmx, jfleet.ModelRegistry())):
        with reg:
            if kind == 'loader':
                reg.register('m', loader=_loader(5, pkg), max_batch=4,
                             max_wait_us=0)
            else:
                prefix = str(tmp_path / ('%s_ckpt' % pkg.__name__))
                pkg.model.save_checkpoint(prefix, 2, _mlp(pkg),
                                          _params(5, pkg), {})
                reg.register('m', prefix=prefix, epoch=2,
                             input_shapes={'data': (1, DIM)}, max_batch=4,
                             max_wait_us=0)
            answers[pkg.__name__] = reg.infer('m', x)[0]
    np.testing.assert_allclose(answers['mxnet_tpu_torch'],
                               answers['mxnet_tpu'], **JAX_TOL)


CUT_PTB = dict(vocab=50, embed=8, hidden=8, layers=2)


def _ptb_engine(pkg=mx, **kw):
    cell = CS.fleet_cell(pkg, **CUT_PTB)
    shapes, outs = CS.fleet_cell_states(CUT_PTB['hidden'],
                                        CUT_PTB['layers'])
    np_params = CS.fleet_cell_params(mx, CS.fleet_cell(mx, **CUT_PTB),
                                     CUT_PTB['hidden'], CUT_PTB['layers'],
                                     seed=31)
    if pkg is mx:
        kw.setdefault('ctx', CPU)
        params = {k: mx.nd.array(v, ctx=CPU) for k, v in np_params.items()}
        engine = ContinuousEngine
    else:
        params = {k: jmx.nd.array(v) for k, v in np_params.items()}
        engine = jfleet.ContinuousEngine
    return engine(cell, arg_params=params, data_shape=(2,),
                  state_shapes=shapes, state_outputs=outs, **kw)


def _ptb_seqs(lens, seed):
    rs = np.random.RandomState(seed)
    return [np.stack([rs.randint(0, CUT_PTB['vocab'], n),
                      rs.randint(0, CUT_PTB['vocab'], n)],
                     axis=1).astype(np.float32) for n in lens]


CONT_LENS = [3, 9, 2, 6, 4, 1, 7]


def _cont_engine(cell_kind, pkg, **kw):
    if cell_kind == 'cell':
        return _cont(pkg=pkg, **kw)
    return _ptb_engine(pkg, **kw)


def _cont_inputs(cell_kind):
    return _seqs(CONT_LENS, seed=12) if cell_kind == 'cell' \
        else _ptb_seqs(CONT_LENS, seed=12)


@pytest.mark.parametrize('tick_chunk', [1, 4, 'auto'])
@pytest.mark.parametrize('cell_kind', ['cell', 'ptb'])
def test_continuous_outputs_match_jax(cell_kind, tick_chunk):
    seqs = _cont_inputs(cell_kind)
    kw = dict(slots=4, tick_chunk=tick_chunk)
    if tick_chunk == 'auto':
        kw['slo'] = None
    got = {}
    for pkg in (mx, jmx):
        ekw = dict(kw)
        if tick_chunk == 'auto':
            ekw['slo'] = (SLO if pkg is mx else jfleet.SLO)(
                deadline_ms=200.0)
        with _cont_engine(cell_kind, pkg, **ekw) as eng:
            got[pkg.__name__] = eng.infer_many(seqs)
            assert eng.stats()['retired'] == len(seqs)
    for a, b in zip(got['mxnet_tpu_torch'], got['mxnet_tpu']):
        for u, v in zip(a, b):
            assert u.shape == v.shape
            np.testing.assert_allclose(u, v, **JAX_TOL)


COUNTER_CASES = {
    'chunked': (dict(slots=4, tick_chunk=4), [3, 9, 2, 6, 4]),
    'unchunked': (dict(slots=2), [3, 9, 2, 6, 4]),
    'convoy': (dict(slots=2, convoy=True), [2, 8, 2, 8]),
}


@pytest.mark.parametrize('case', sorted(COUNTER_CASES))
def test_deterministic_counters_match_jax(case):
    kw, lens = COUNTER_CASES[case]
    seqs = _seqs(lens, seed=6)
    keys = ('ticks', 'chunks', 'admitted', 'retired', 'active_row_ticks',
            'slot_ticks', 'exact_fill_admits')
    stats = {}
    for pkg in (mx, jmx):
        with _cont(pkg=pkg, stage_ahead=0, **kw) as eng:
            eng.infer_many(seqs)
            stats[pkg.__name__] = {k: eng.stats()[k] for k in keys}
    assert stats['mxnet_tpu_torch'] == stats['mxnet_tpu']


def test_stats_key_sets_match_jax():
    x = _x(1)
    keys = {}
    for pkg, reg in ((mx, _registry()), (jmx, jfleet.ModelRegistry())):
        with reg:
            reg.register('m', loader=_loader(1, pkg), max_batch=2,
                         max_wait_us=0)
            reg.infer('m', x)
            st = reg.stats()
        with _cont(pkg=pkg, slots=2) as eng:
            eng.infer(_seqs([3])[0])
            cst = eng.stats()
        with _cont(pkg=pkg, slots=4, tick_chunk='auto',
                   slo=(SLO if pkg is mx else jfleet.SLO)(
                       deadline_ms=200.0)) as eng:
            eng.infer(_seqs([3])[0])
            ast = eng.stats()
        keys[pkg.__name__] = [set(st), set(st['models']['m']),
                              set(st['models']['m']['engine']), set(cst),
                              set(ast)]
    # the port's InferenceEngine adds host_ms, the host time of a
    # dispatch split by stage (serving.py)
    keys['mxnet_tpu'][2].add('host_ms')
    assert keys['mxnet_tpu_torch'] == keys['mxnet_tpu']


def _front_replies(pkg, reg, x):
    """(status, JSON) of /healthz, /statsz, a predict, an unknown model
    and a bad body, from a front over `reg`."""
    front_cls = HttpFront if pkg is mx else jfleet.HttpFront
    out = {}
    with front_cls(reg, port=0).start() as front:
        base = 'http://%s:%d' % front.address
        for key, fn in (
                ('healthz', lambda: _get('%s/healthz' % base)),
                ('predict', lambda: _post('%s/v1/models/m:predict' % base,
                                          {'instances': x.tolist()})),
                ('statsz', lambda: _get('%s/statsz' % base)),
                ('ghost', lambda: _post(
                    '%s/v1/models/ghost:predict' % base,
                    {'instances': x.tolist()})),
                ('bad', lambda: _post('%s/v1/models/m:predict' % base,
                                      {'bogus': 1}))):
            try:
                r = fn()
                out[key] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                out[key] = (e.code, json.loads(e.read()))
    return out


def test_http_replies_match_jax():
    x = _x(2, seed=14)
    replies = {}
    for pkg, reg in ((mx, _registry()), (jmx, jfleet.ModelRegistry())):
        with reg:
            reg.register('m', loader=_loader(3, pkg), max_batch=4,
                         max_wait_us=0)
            replies[pkg.__name__] = _front_replies(pkg, reg, x)
    got, ref = replies['mxnet_tpu_torch'], replies['mxnet_tpu']
    for key in ref:
        assert got[key][0] == ref[key][0], key
        assert set(got[key][1]) == set(ref[key][1]), key
    assert got['healthz'] == ref['healthz']
    np.testing.assert_allclose(np.asarray(got['predict'][1]['outputs'][0]),
                               np.asarray(ref['predict'][1]['outputs'][0]),
                               **JAX_TOL)
    gs, rs = got['statsz'][1], ref['statsz'][1]
    for part in ('fleet', 'http'):
        assert set(gs[part]) == set(rs[part]), part
    assert set(gs['models']['m']) == set(rs['models']['m'])
    for k in ('loads', 'evictions', 'resident_bytes', 'budget_bytes'):
        assert gs[k] == rs[k], k
    assert gs['http']['requests'] == rs['http']['requests']


# a tiny LM scorer registered by source=, in each package
LM_CFG = dict(vocab=97, dim=64, heads=4, layers=2)
LM_T = 24
LM_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_torch_transformer.py's


class _JaxScorer(object):
    """The JAX LM's per-token log p(targets), on Pallas flash attention
    (interpret mode on the CPU)."""

    def __init__(self, cfg, params):
        import jax
        from jax.sharding import PartitionSpec as P
        from mxnet_tpu.parallel import make_mesh
        from mxnet_tpu.parallel import transformer as jax_tfm
        from mxnet_tpu.parallel._compat import shard_map
        mesh = make_mesh({'data': 1, 'sp': 1, 'model': 1},
                         devices=jax.devices()[:1])
        tok = P('data', 'sp')
        self._fwd = shard_map(
            lambda p, t: jax_tfm._local_forward(cfg, p, t), mesh=mesh,
            in_specs=(jax_tfm.param_specs(cfg), tok), out_specs=tok,
            check_vma=False)
        self._params = params
        self._closed = False

    def infer(self, tokens, targets):
        import jax
        import jax.numpy as jnp
        logits = self._fwd(self._params, jnp.asarray(
            np.asarray(tokens).reshape(1, -1), jnp.int32))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tgt = np.asarray(targets).reshape(1, -1, 1).astype(np.int32)
        return [np.asarray(jnp.take_along_axis(logp, tgt, axis=-1))[..., 0]]

    @property
    def closed(self):
        return self._closed

    def close(self):
        self._closed = True


def test_lm_scorer_by_source_matches_jax():
    import jax
    from mxnet_tpu.parallel import transformer as jax_tfm
    from mxnet_tpu_torch.parallel import transformer as tfm
    jcfg = jax_tfm.lm_config(use_flash=True, **LM_CFG)
    jparams = jax_tfm.init_params(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = tfm.TransformerLM(tfm.lm_config(use_flash=False, **LM_CFG),
                              tfm.params_from_jax(np_params, device='cpu'))
    rs = np.random.RandomState(5)
    tok = rs.randint(0, LM_CFG['vocab'], LM_T + 1)
    tokens, targets = tok[:-1], tok[1:]
    scores = {}
    for pkg, reg, scorer in (
            (mx, _registry(), CS.FleetScorer(torch, model)),
            (jmx, jfleet.ModelRegistry(), _JaxScorer(jcfg, jparams))):
        with reg:
            reg.register('lm', source=scorer, slo=(
                SLO if pkg is mx else jfleet.SLO)(priority=1))
            out = reg.infer('lm', tokens=tokens, targets=targets)[0]
            assert reg.stats()['models']['lm']['pinned']
        assert out.shape == (1, LM_T) and out.dtype == np.float32
        scores[pkg.__name__] = out
    np.testing.assert_allclose(scores['mxnet_tpu_torch'],
                               scores['mxnet_tpu'], **LM_TOL)
    assert np.all(scores['mxnet_tpu_torch'] < 0)


# ---------------------------------------------------------------------------
# the default device, fault knobs, refusals
# ---------------------------------------------------------------------------

def test_continuous_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(MXNetError, match='(?i)cuda'):
        ContinuousEngine(_cell(), arg_params={
            k: mx.nd.array(v, ctx=CPU)
            for k, v in _np_cell_params().items()},
            data_shape=(CDIM,), state_shapes={'h': (CHID,)},
            state_outputs={'h': 1}, slots=2)


def test_registry_prefix_default_device_needs_cuda(monkeypatch, tmp_path):
    prefix = str(tmp_path / 'gpu_default')
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(1), {})
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with ModelRegistry() as reg:
        reg.register('m', prefix=prefix, epoch=0,
                     input_shapes={'data': (1, DIM)}, max_batch=2,
                     max_wait_us=0)
        with pytest.raises(MXNetError, match='(?i)cuda'):
            reg.infer('m', _x(1))
        assert reg.stats()['loads'] == 0


def test_fault_knob_matches_jax(monkeypatch):
    from mxnet_tpu import elastic as jelastic
    from mxnet_tpu_torch import elastic
    for value in (None, '', '  ', '1', 'drop'):
        if value is None:
            monkeypatch.delenv('MXNET_TPU_FAULT_SWAP_DROP_STATE',
                               raising=False)
        else:
            monkeypatch.setenv('MXNET_TPU_FAULT_SWAP_DROP_STATE', value)
        for default in (None, 'x'):
            assert elastic.fault_knob('SWAP_DROP_STATE', default) == \
                jelastic.fault_knob('SWAP_DROP_STATE', default)
    # the rest of the elastic module is here too (Queue A item 5)
    assert isinstance(elastic.CheckpointManager, type)
    with pytest.raises(AttributeError):
        elastic.no_such_name


def _swap_run(pkg, seqs, drop, monkeypatch):
    """Half the sequences submitted, the engine's state exported after a
    few chunks and admitted into a fresh engine, which completes every
    request: (answers, export's dropped count, loop counters)."""
    if drop:
        monkeypatch.setenv('MXNET_TPU_FAULT_SWAP_DROP_STATE', '1')
    else:
        monkeypatch.delenv('MXNET_TPU_FAULT_SWAP_DROP_STATE', raising=False)
    prof = profiler if pkg is mx else jmx.profiler
    prof.clear()
    old = _cont(pkg=pkg, slots=2, tick_chunk=2, stage_ahead=0)
    res = [None] * len(seqs)

    def client(i):
        res[i] = old.infer(seqs[i])

    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(seqs))]
    for t in ts:
        t.start()
    deadline = time.time() + 10
    while time.time() < deadline and old.stats()['chunks'] < 2:
        time.sleep(0.002)
    exported = old.export_state()
    new = _cont(pkg=pkg, slots=2, tick_chunk=2, stage_ahead=0)
    new.admit_state(exported)
    _join(ts)
    new.close()
    old.close()
    return res, exported['dropped'], prof.loop_stats()


@pytest.mark.parametrize('drop', [False, True])
def test_export_admit_state_swap_matches_jax(drop, monkeypatch):
    # long enough that slots are in flight when the export lands
    seqs = _seqs([200, 200, 50, 90], seed=15)
    with _cont(slots=2) as eng:
        solo = [eng.infer(s) for s in seqs]
    got, dropped, loop = _swap_run(mx, seqs, drop, monkeypatch)
    jgot, jdropped, jloop = _swap_run(jmx, seqs, drop, monkeypatch)
    # the hand-over completes every request with the unswapped bits
    _bit_equal(got, solo)
    for a, b in zip(got, jgot):
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, **JAX_TOL)
    if drop:
        assert dropped >= 1 and loop['loop_swap_dropped_slots'] == dropped
    else:
        assert dropped == 0 and loop['loop_swap_migrated_slots'] >= 1
    assert (dropped > 0) == (jdropped > 0)
    assert set(loop) == set(jloop)


def test_apply_delta_on_a_resident_model():
    """ModelRegistry.apply_delta (Queue A item 5) on a resident model:
    the answers become the new weights', bit for bit, and a delta off the
    resident chain is refused with the answers unchanged."""
    from mxnet_tpu_torch import delta
    base = {'arg:' + k: v for k, v in _params(1).items()}
    new = {'arg:' + k: v for k, v in _params(2).items()}
    fp = delta.fingerprint(base)
    ent, meta, _ = delta.make_delta(base, new, seq=1, base_fp=fp,
                                    config='raw')
    with _registry() as reg:
        reg.register('m', loader=_loader(1), max_batch=2, max_wait_us=0)
        reg.register('ref', loader=_loader(2), max_batch=2, max_wait_us=0)
        before = reg.infer('m', _x(1))[0]
        with pytest.raises(delta.DeltaChainError):
            reg.apply_delta('m', dict(ent), meta, expect_fp='0' * 16)
        np.testing.assert_array_equal(reg.infer('m', _x(1))[0], before)
        assert reg.apply_delta('m', dict(ent), meta, expect_fp=fp) == \
            meta['new_fp']
        np.testing.assert_array_equal(reg.infer('m', _x(1))[0],
                                      reg.infer('ref', _x(1))[0])
        with pytest.raises(MXNetError, match='neither resident'):
            reg.register('cold', loader=_loader(3), max_batch=2)
            reg.apply_delta('cold', dict(ent), meta)


def test_page_dtype_round_trip_on_host_image(tmp_path):
    # an int8 image of an evicted prefix= model pages in without the
    # checkpoint, and its answers stay within the int8 engine's gate
    prefix = str(tmp_path / 'paged')
    big = dict(_np_params(2))
    model_mod.save_checkpoint(prefix, 0, _mlp(), _params(2), {})
    x = _x(4, seed=3)
    ref = _ref(2, x)
    with _registry() as reg:
        reg.register('p', prefix=prefix, epoch=0, page_dtype='int8',
                     input_shapes={'data': (1, DIM)}, max_batch=4,
                     max_wait_us=0)
        np.testing.assert_allclose(reg.infer('p', x)[0], ref, **F32)
        reg.evict('p')
        st = reg.stats()
        assert st['paged_bytes'] > 0 and st['models']['p']['paged']
        os.remove(prefix + '-0000.params')    # the image alone serves
        out = reg.infer('p', x)[0]
        st = reg.stats()
        assert st['page_ins'] == 1 and st['paged_bytes'] == 0
        assert big['fc1_weight'].size < 1024   # small arrays stay fp
        np.testing.assert_allclose(out, ref, **F32)


# ---------------------------------------------------------------------------
# tools/serve_http.py
# ---------------------------------------------------------------------------

def _tool(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_http_parse_model_spec_matches_jax():
    port_tool = _tool(REPO / 'mxnet_tpu_torch' / 'tools' / 'serve_http.py',
                      'port_serve_http')
    jax_tool = _tool(REPO / 'tools' / 'serve_http.py', 'jax_serve_http')
    for spec in ('mnist=/ckpt/mnist:0:data=1x784',
                 'rank=/a:b/rank:3:data=1x256,mask=1x256',
                 'm=/x/y:12:data=2x3x224x224'):
        assert port_tool.parse_model_spec(spec) == \
            jax_tool.parse_model_spec(spec)
    for bad in ('nospec', 'm=/x:notanint:data=1x2', 'm=/x:0:data'):
        with pytest.raises(SystemExit):
            port_tool.parse_model_spec(bad)
    assert port_tool.parse_kv(['a=1', 'b=2.5'], float) == \
        jax_tool.parse_kv(['a=1', 'b=2.5'], float)


def test_serve_http_tool_starts_and_stops_a_front(tmp_path):
    from mxnet_tpu_torch.tools import serve_http
    prefix = str(tmp_path / 'tool')
    model_mod.save_checkpoint(prefix, 1, _mlp(), _params(6), {})
    x = _x(2, seed=2)
    stop = threading.Event()
    ready = {}

    def run():
        with CPU:       # the registry's device, resolved at construction
            serve_http.main(
                ['--model', 'm=%s:1:data=1x%d' % (prefix, DIM), '--port',
                 '0', '--deadline-ms', 'm=500', '--priority', 'm=1',
                 '--max-batch', '4', '--warm'],
                stop=stop, on_ready=ready.update)

    t = threading.Thread(target=run)
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and 'address' not in ready:
        time.sleep(0.01)
    try:
        assert 'address' in ready
        base = 'http://%s:%d' % ready['address']
        resp = _post('%s/v1/models/m:predict' % base,
                     {'instances': x.tolist()})
        np.testing.assert_allclose(
            np.asarray(json.loads(resp.read())['outputs'][0]), _ref(6, x),
            rtol=2e-6, atol=1e-5)
        st = json.loads(_get('%s/statsz' % base).read())
        assert st['models']['m']['priority'] == 1
        assert st['models']['m']['deadline_ms'] == 500.0
    finally:
        stop.set()
        _join([t], 30)


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 20
# ---------------------------------------------------------------------------

def _good_fleet_run():
    return dict(
        http=dict(codes={'200': 900, '429': 40}, retry_after_missing=0,
                  healthz_ok=True, statsz_ok=True),
        burst=dict(overloaded=3, codes={'200': 300, '429': 120}),
        answers=dict(resnet_max_rel_err=0.01, resnet_tol=0.035,
                     resnet_answers=800, gpt2_bit_equal=True,
                     gpt2_answers=20, ptb_bit_equal=True, ptb_answers=256),
        registry=dict(cycles={'resnet50': 4, 'resnet50-int8': 5,
                              'resnet50-paged': 5},
                      compiles_after_warmup=0, peak_resident_bytes=900,
                      budget_bytes=1000, evict_freed_share=0.98),
        ptb=dict(co_resident_vs_solo=True, k4_vs_k1=True, k16_vs_k1=True,
                 staged_vs_serialized=True, swap_vs_unswapped=True,
                 unroll_rel_err=2e-7, unroll_tol=1e-5, cpu_err=1e-7,
                 cpu_bound=1e-6),
        flash=dict(kernel_ok=True, per_request=[24] * 20, layers=24,
                   bwd_launches=(0, 0), conv_launches=0),
        tenants={t: dict(answered=10) for t in CS.FLEET_PRIORITY})


def test_fleet_gate_passes_a_good_run():
    assert CS.fleet_gate(_good_fleet_run()) == []


@pytest.mark.parametrize('edit, word', [
    (lambda r: r['http']['codes'].update({'503': 1}), '5xx'),
    (lambda r: r['http'].update(retry_after_missing=1), 'Retry-After'),
    (lambda r: r['burst'].update(overloaded=0), 'Overloaded'),
    (lambda r: r['answers'].update(resnet_max_rel_err=0.2), 'serial'),
    (lambda r: r['answers'].update(gpt2_bit_equal=False), 'gpt2'),
    (lambda r: r['registry']['cycles'].update({'resnet50': 2}), 'cycles'),
    (lambda r: r['registry'].update(compiles_after_warmup=1), 'rung'),
    (lambda r: r['registry'].update(peak_resident_bytes=1001), 'budget'),
    (lambda r: r['registry'].update(evict_freed_share=0.5), 'allocator'),
    (lambda r: r['ptb'].update(k16_vs_k1=False), 'K=16'),
    (lambda r: r['ptb'].update(unroll_rel_err=1e-4), 'unroll'),
    (lambda r: r['ptb'].update(cpu_err=1e-3), 'cpu(0)'),
    (lambda r: r['flash'].update(per_request=[24, 23]), 'flash'),
    (lambda r: r['flash'].update(bwd_launches=(1, 0)), 'backward'),
    (lambda r: r['tenants']['resnet50-paged'].update(answered=0),
     'answered nothing'),
])
def test_fleet_gate_fails_a_bad_run(edit, word):
    run = _good_fleet_run()
    edit(run)
    bad = CS.fleet_gate(run)
    assert bad and any(word in b for b in bad), bad
