"""The port's train->serve loop (fleet_supervisor.CheckpointPusher,
PushVerdict, RollbackStop) on the CPU, then held against the JAX
package's.

- the 8 pusher contracts of tests/test_train_serve_loop.py on the port
  (the swap tests are in test_torch_serving_fleet.py): on_commit fires
  after the manifest commits and a pre-existing hook is chained; a
  commit is exported to the serving format and pushed, and the verdict
  flows back correlated to its step; N consecutive rollbacks raise
  RollbackStop at the next step boundary and a promote resets the
  streak; a wedged fleet never stalls training; a failed push is a typed
  'failed' verdict; MXNET_TPU_FAULT_PUSH_FAIL fails the Nth push;
- against the JAX package: the two packages' `_encode_delta`, on the
  same two commits with the same promoted base, write byte-equal delta
  files and the same meta;
- the JAX package's closed-loop drill on the small MLP head with two CPU
  replica processes: a Module.fit whose commits push into the fleet, the
  first candidate degraded and rolled back (the trainer sees the
  verdict), a replica SIGKILLed while a later push is judged and
  respawned, a clean candidate promoted, at least one push as a delta
  and one in full, zero lost requests, and the fleet's answers equal to
  a direct Predictor over the last promoted export (rtol 1e-4, atol
  1e-5, the JAX drill's).

Every thread join and wait has a timeout.
"""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import fleet_supervisor as jfs

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic, model as model_mod, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.fleet_supervisor import (CheckpointPusher,
                                              FleetSupervisor, PushVerdict,
                                              RollbackStop,
                                              post_with_backoff)
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import export_serving_checkpoint
from mxnet_tpu_torch.serving_fleet import BudgetExceeded

CPU = mx.cpu()
DIM, HID, OUT = 6, 8, 3
DRILL_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in list(os.environ):
        if k.startswith('MXNET_TPU_FAULT_'):
            monkeypatch.delenv(k, raising=False)


def _head(pkg=mx, hid=HID):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=hid, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu')
    return pkg.sym.FullyConnected(act, num_hidden=OUT, name='fc2')


def _module(seed=3, hid=HID, dim=DIM):
    net = mx.sym.SoftmaxOutput(_head(hid=hid), name='softmax')
    mod = mx.mod.Module(net, context=CPU)
    mod.bind(data_shapes=[mx.io.DataDesc('data', (4, dim))],
             label_shapes=[mx.io.DataDesc('softmax_label', (4,))])
    mx.random.seed(seed)
    mod.init_params(initializer=mx.init.Xavier())
    return mod


class _StubSupervisor(object):
    """Scripted fleet: push() accepts, raises or wedges; verdicts are
    fired on demand through the on_push_verdict channel the real
    FleetSupervisor serves."""

    def __init__(self, fail=None, block=None):
        self.fail = fail
        self.block = block
        self.pushes = []                # (name, prefix, cand)
        self.tags = {}
        self._cbs = []
        self._seq = 0
        self._active = set()

    def on_push_verdict(self, cb):
        self._cbs.append(cb)
        return self

    def push_active(self, name):
        return name in self._active

    def active_prefixes(self, name):
        return set()

    def push(self, name, prefix, epoch=0, frac=None, mode='canary',
             tag=None):
        if self.block is not None:
            self.block.wait()
        if self.fail is not None:
            raise self.fail
        self._seq += 1
        cand = '%s@v%d' % (name, self._seq)
        self.pushes.append((name, prefix, cand))
        self._active.add(name)
        self.tags[cand] = tag
        return cand

    def decide(self, kind, cand, model='m', report=None):
        self._active.discard(model)
        v = PushVerdict(kind, model, cand, report=report)
        for cb in self._cbs:
            cb(v)
        return v


def _wait(pred, timeout=30, msg='condition'):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError('timed out waiting for %s' % msg)


def _mgr_with_pusher(tmp_path, sup, **pk):
    pusher = CheckpointPusher(sup, 'm', symbol=_head(),
                              push_dir=str(tmp_path / 'push'), **pk)
    mgr = pusher.attach(elastic.CheckpointManager(
        str(tmp_path / 'ck'), every_n_steps=1))
    mgr.attach(_module())
    return mgr, pusher


# ---------------------------------------------------------------------------
# commit hook + export + promote feedback
# ---------------------------------------------------------------------------

def test_on_commit_fires_after_manifest_commit(tmp_path):
    mod = _module()
    seen = []

    def hook(step_dir, manifest):
        assert os.path.isfile(os.path.join(step_dir, 'manifest.json'))
        seen.append((step_dir, manifest['step']))

    mgr = elastic.CheckpointManager(str(tmp_path / 'ck'),
                                    on_commit=hook)
    mgr.attach(mod)
    mgr._step = 5
    mgr.save(sync=True)
    assert seen and seen[0][1] == 5
    # a raising hook is contained: the commit (and training) survive
    mgr.on_commit = lambda *_a: 1 / 0
    mgr._step = 6
    mgr.save(sync=True)
    assert elastic.list_checkpoints(str(tmp_path / 'ck')) == [6, 5]
    # pusher.attach chains a pre-existing hook instead of dropping it
    mgr.on_commit = hook
    pusher = CheckpointPusher(_StubSupervisor(), 'm', symbol=_head(),
                              push_dir=str(tmp_path / 'push'))
    pusher.attach(mgr)
    mgr._step = 7
    mgr.save(sync=True)
    assert seen[-1][1] == 7
    _wait(lambda: len(pusher.supervisor.pushes) == 1,
          msg='chained push')
    pusher.close()
    mgr.close()


def test_pusher_promote_verdict_flows_back(tmp_path):
    profiler.clear()
    sup = _StubSupervisor()
    mgr, pusher = _mgr_with_pusher(tmp_path, sup)
    mod = mgr._target
    mgr.step_end()                       # step 1: commit -> push
    mgr.wait()
    _wait(lambda: len(sup.pushes) == 1, msg='push')
    name, prefix, cand = sup.pushes[0]
    assert name == 'm'
    _s, args, _aux = model_mod.load_checkpoint(prefix, 0, ctx=CPU)
    want, _ = mod.get_params()
    for n in ('fc1_weight', 'fc1_bias', 'fc2_weight', 'fc2_bias'):
        np.testing.assert_array_equal(args[n].asnumpy(),
                                      want[n].asnumpy())
    sup.decide('promoted', cand,
               report={'cand_p50_ms': 1.0, 'stable_p50_ms': 1.0,
                       'cand_err_frac': 0.0})
    _wait(lambda: pusher.last_verdict is not None, msg='verdict')
    v = pusher.last_verdict
    assert v.kind == 'promoted' and v.candidate == cand
    assert v.step == 1
    assert pusher.consecutive_rollbacks == 0
    mgr.step_end()
    assert pusher.poll_verdicts() == []  # drained by step_end
    assert pusher.verdicts()[-1] is v
    st = profiler.loop_stats()
    assert st['loop_pushes'] == 1
    assert st['loop_verdicts_promoted'] == 1
    pusher.close()
    mgr.close()


def test_export_serving_checkpoint_validates_and_serves(tmp_path):
    mod = _module(seed=9)
    mgr = elastic.CheckpointManager(str(tmp_path / 'ck'))
    mgr.attach(mod)
    mgr._step = 3
    step_dir = mgr.save(sync=True)
    prefix = str(tmp_path / 'serve_m')
    export_serving_checkpoint(step_dir, _head(), prefix)
    _s, args, auxs = model_mod.load_checkpoint(prefix, 0, ctx=CPU)
    pred = Predictor(symbol=_head(), arg_params=args, aux_params=auxs,
                     input_shapes={'data': (1, DIM)}, ctx=CPU)
    x = np.random.RandomState(0).randn(1, DIM).astype(np.float32)
    out = pred.forward(data=mx.nd.array(x, ctx=CPU))[0].asnumpy()
    assert out.shape == (1, OUT) and np.isfinite(out).all()
    with pytest.raises(MXNetError):
        export_serving_checkpoint(str(tmp_path), _head(),
                                  str(tmp_path / 'bad'))
    mgr.close()


# ---------------------------------------------------------------------------
# rollback feedback: consecutive-rollback stop
# ---------------------------------------------------------------------------

def test_consecutive_rollbacks_stop_training(tmp_path):
    profiler.clear()
    sup = _StubSupervisor()
    mgr, pusher = _mgr_with_pusher(tmp_path, sup,
                                   max_consecutive_rollbacks=3)
    for i in range(3):
        mgr.step_end()
        mgr.wait()
        _wait(lambda: len(sup.pushes) == i + 1, msg='push %d' % i)
        sup.decide('rolled_back', sup.pushes[-1][2])
        _wait(lambda: len(pusher.verdicts()) == i + 1, msg='verdict')
    assert pusher.consecutive_rollbacks == 3
    assert profiler.loop_stats()['loop_consecutive_rollbacks'] == 3
    with pytest.raises(RollbackStop) as ei:
        mgr.step_end()
    assert ei.value.model == 'm'
    assert len(ei.value.verdicts) == 3
    assert all(v.kind == 'rolled_back' for v in ei.value.verdicts)
    pusher.close()
    mgr.close()


def test_promote_resets_rollback_streak(tmp_path):
    sup = _StubSupervisor()
    mgr, pusher = _mgr_with_pusher(tmp_path, sup,
                                   max_consecutive_rollbacks=2)
    for i, kind in enumerate(('rolled_back', 'promoted',
                              'rolled_back')):
        mgr.step_end()
        mgr.wait()
        _wait(lambda: len(sup.pushes) == i + 1, msg='push %d' % i)
        sup.decide(kind, sup.pushes[-1][2])
        _wait(lambda: len(pusher.verdicts()) == i + 1,
              msg='verdict %d' % i)
    assert pusher.consecutive_rollbacks == 1
    mgr.step_end()                               # no stop raised
    pusher.close()
    mgr.close()


# ---------------------------------------------------------------------------
# degradation: wedged fleet, typed failures, fault knob
# ---------------------------------------------------------------------------

def test_wedged_fleet_never_stalls_training(tmp_path):
    profiler.clear()
    release = threading.Event()
    sup = _StubSupervisor(block=release)     # push wedges
    mgr, pusher = _mgr_with_pusher(tmp_path, sup)
    t0 = time.monotonic()
    for _ in range(6):
        mgr.step_end()
        mgr.wait()
    dt = time.monotonic() - t0
    assert dt < 20.0, 'training stalled on a wedged fleet (%.1fs)' % dt
    assert elastic.list_checkpoints(str(tmp_path / 'ck'))
    _wait(lambda: profiler.loop_stats()['loop_push_queue_skipped'] >= 3,
          msg='skip counter')
    release.set()
    pusher.close()
    mgr.close()


def test_push_failure_is_typed_not_fatal(tmp_path):
    profiler.clear()
    sup = _StubSupervisor(fail=BudgetExceeded('m', 100, 10, 0))
    mgr, pusher = _mgr_with_pusher(tmp_path, sup)
    mgr.step_end()
    mgr.wait()
    _wait(lambda: pusher.last_verdict is not None, msg='failed verdict')
    v = pusher.last_verdict
    assert v.kind == 'failed' and v.error
    assert pusher.consecutive_rollbacks == 0
    assert profiler.loop_stats()['loop_push_failures'] == 1
    mgr.step_end()
    pusher.close()
    mgr.close()


def test_fault_push_fail_knob(tmp_path, monkeypatch):
    profiler.clear()
    monkeypatch.setenv('MXNET_TPU_FAULT_PUSH_FAIL', '2')
    sup = _StubSupervisor()
    mgr, pusher = _mgr_with_pusher(tmp_path, sup)
    mgr.step_end()
    mgr.wait()
    _wait(lambda: len(sup.pushes) == 1, msg='push 1')
    sup.decide('promoted', sup.pushes[-1][2])
    mgr.step_end()
    mgr.wait()
    _wait(lambda: any(v.kind == 'failed' and 'PUSH_FAIL' in v.error
                      for v in pusher.verdicts()),
          msg='injected failure')
    assert len(sup.pushes) == 1
    sup.decide('promoted', 'unused')
    mgr.step_end()
    mgr.wait()
    _wait(lambda: len(sup.pushes) == 2, msg='push 3')
    pusher.close()
    mgr.close()


# ---------------------------------------------------------------------------
# the delta channel against the JAX package
# ---------------------------------------------------------------------------

WIDE = 64       # fc1 of 64 x 32: dense enough for the int8 kind


def _two_commits(tmp_path):
    """Two elastic commits of one Module: the second after every weight
    moved by a seeded step (fc1's 2048 elements take the int8 kind, the
    smaller arrays the raw one)."""
    mod = _module(seed=4, hid=WIDE, dim=32)
    mgr = elastic.CheckpointManager(str(tmp_path / 'ck'), async_=False)
    mgr.attach(mod)
    mgr._step = 1
    d1 = mgr.save(sync=True)
    args, auxs = mod.get_params()
    rs = np.random.RandomState(11)
    moved = {}
    for n, a in args.items():
        v = a.asnumpy()
        step = rs.randn(*v.shape).astype(np.float32) * 0.01
        moved[n] = mx.nd.array(v + step, ctx=CPU)
    mod.set_params(moved, auxs)
    mgr._step = 2
    d2 = mgr.save(sync=True)
    mgr.close()
    return d1, d2


def test_encode_delta_writes_the_jax_packages_bytes(tmp_path):
    d1, d2 = _two_commits(tmp_path)
    from mxnet_tpu import delta as jdelta
    from mxnet_tpu import serving as jserving
    from mxnet_tpu_torch import delta, serving
    ours = CheckpointPusher(_StubSupervisor(), 'm',
                            symbol=_head(hid=WIDE),
                            push_dir=str(tmp_path / 'p_torch'), delta=True)
    theirs = jfs.CheckpointPusher(_StubSupervisor(), 'm',
                                  symbol=_head(jmx, hid=WIDE),
                                  push_dir=str(tmp_path / 'p_jax'),
                                  delta=True)
    try:
        base = serving.serving_state(d1)
        jbase = jserving.serving_state(d1)
        assert delta.fingerprint(base) == jdelta.fingerprint(jbase)
        ours._base = {'state': base, 'fp': delta.fingerprint(base),
                      'seq': 0}
        theirs._base = {'state': jbase, 'fp': jdelta.fingerprint(jbase),
                        'seq': 0}
        spec, meta = ours._encode_delta(d2, 2)
        jspec, jmeta = theirs._encode_delta(d2, 2)
        assert spec is not None and jspec is not None
        kinds = {e['kind'] for e in meta['entries'].values()}
        assert 'int8' in kinds and 'raw' in kinds
        assert json.loads(json.dumps(meta)) == json.loads(json.dumps(jmeta))
        with open(spec['path'], 'rb') as f, open(jspec['path'], 'rb') as g:
            assert f.read() == g.read()
        assert os.path.basename(spec['path']) == \
            os.path.basename(jspec['path']) == 'delta-00000002.bin'
        assert ours._staged['fp'] == theirs._staged['fp'] == \
            meta['new_fp']
        # with no promoted base, both push in full and stage a rebase
        ours._base = theirs._base = None
        assert ours._encode_delta(d2, 3) == (None, None)
        assert theirs._encode_delta(d2, 3) == (None, None)
        assert ours._staged['seq'] == theirs._staged['seq'] == 0
    finally:
        ours.close()
        theirs.close()


def test_a_model_served_with_its_loss_head_matches_its_commit(tmp_path):
    """A replica serving the training symbol (SoftmaxOutput and its
    softmax_label argument) holds the commit's fingerprint in the port,
    so a delta applies; the JAX package's resident state counts the
    label, and its fingerprint never matches."""
    from mxnet_tpu import serving as jserving
    from mxnet_tpu import delta as jdelta
    from mxnet_tpu.predictor import Predictor as JPredictor
    from mxnet_tpu_torch import delta, serving
    d1, d2 = _two_commits(tmp_path)
    net = mx.sym.SoftmaxOutput(_head(hid=WIDE), name='softmax')
    prefix = str(tmp_path / 'served')
    export_serving_checkpoint(d1, net, prefix)
    eng = Predictor.from_checkpoint(prefix, 0, {'data': (1, 32)},
                                    ctx=CPU).serve(max_batch=1)
    jnet = jmx.sym.SoftmaxOutput(_head(jmx, hid=WIDE), name='softmax')
    jprefix = str(tmp_path / 'jserved')
    jserving.export_serving_checkpoint(d1, jnet, jprefix)
    jeng = JPredictor.from_checkpoint(jprefix, 0, {'data': (1, 32)}) \
        .serve(max_batch=1)
    try:
        base = serving.serving_state(d1)
        fp = delta.fingerprint(base)
        assert delta.fingerprint(eng._resident_host_state()) == fp
        assert 'arg:softmax_label' in jeng._resident_host_state()
        assert jdelta.fingerprint(jeng._resident_host_state()) != fp
        entries, meta, _ = delta.make_delta(
            base, serving.serving_state(d2), seq=1, base_fp=fp)
        x = np.random.RandomState(5).randn(1, 32).astype(np.float32)
        assert eng.apply_delta(dict(entries), meta, expect_fp=fp) == \
            meta['new_fp']
        full = str(tmp_path / 'full')
        export_serving_checkpoint(d2, net, full)
        want = Predictor.from_checkpoint(full, 0, {'data': (1, 32)},
                                         ctx=CPU).predict(x)
        np.testing.assert_allclose(eng.predict(x), want, rtol=1e-2,
                                   atol=1e-3)
        with pytest.raises(jdelta.DeltaChainError):
            jeng.apply_delta(dict(entries), meta, expect_fp=jdelta
                             .fingerprint(jeng._resident_host_state()))
    finally:
        eng.close()
        jeng.close()


# ---------------------------------------------------------------------------
# the closed-loop drill on two CPU replica processes
# ---------------------------------------------------------------------------

class _DrillDone(Exception):
    pass


def test_closed_loop_drill_on_two_cpu_replicas(tmp_path, monkeypatch):
    knobs = {'MXNET_TPU_FLEET_HEARTBEAT_S': '0.25',
             'MXNET_TPU_FLEET_DEAD_AFTER_S': '1.5',
             'MXNET_TPU_FLEET_CANARY_MIN_SAMPLES': '6',
             'MXNET_TPU_FLEET_CANARY_PROMOTE_SAMPLES': '12'}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    profiler.clear()
    rngk = np.random.RandomState(17)
    probe = _head().simple_bind(CPU, grad_req='null', data=(1, DIM))
    args0 = {k: mx.nd.array(rngk.randn(*v.shape).astype(np.float32) * .2,
                            ctx=CPU)
             for k, v in probe.arg_dict.items() if k != 'data'}
    prefix0 = str(tmp_path / 'initial_m')
    model_mod.save_checkpoint(prefix0, 0, _head(), args0, {})
    sup = pusher = None
    stop_clients = threading.Event()
    clients = []
    try:
        sup = FleetSupervisor(
            models=[{'name': 'm', 'prefix': prefix0, 'epoch': 0,
                     'input_shapes': {'data': [1, DIM]},
                     'max_batch': 8, 'max_wait_us': 0,
                     'deadline_ms': 10000}],
            replicas=2, ctx=CPU,
            env={'MXNET_TPU_FAULT_CANARY_DEGRADE_MS': '@v1:100'})
        sup.start()
        sup.wait_healthy()
        host, port = sup.router.address
        url = 'http://%s:%d/v1/models/m:predict' % (host, port)
        xk = rngk.randn(1, DIM).astype(np.float32)
        failures, n_ok = [], [0]

        def client():
            while not stop_clients.is_set():
                try:
                    st, _ = post_with_backoff(
                        url, {'instances': xk.tolist()}, deadline_s=60)
                    if st != 200:
                        failures.append(st)
                    else:
                        n_ok[0] += 1
                except Exception as e:
                    failures.append(repr(e))
                time.sleep(0.01)

        clients = [threading.Thread(target=client) for _ in range(2)]
        for t in clients:
            t.start()
        pusher = CheckpointPusher(sup, 'm', symbol=_head(), frac=0.5,
                                  max_consecutive_rollbacks=0, delta=True,
                                  push_dir=str(tmp_path / 'push'))
        mgr = pusher.attach(elastic.CheckpointManager(
            str(tmp_path / 'ck'), every_n_steps=2))
        state = {'killed': False, 'restarts_at_kill': 0}

        def on_batch(param):
            time.sleep(0.05)            # pace: the canary needs time
            verds = pusher.verdicts()
            rolled = any(v.kind == 'rolled_back' for v in verds)
            promoted = any(v.kind == 'promoted' for v in verds)
            reps = sup.replicas()
            if rolled and not state['killed'] and \
                    sup.push_active('m') and reps:
                state['restarts_at_kill'] = sup.stats()['restarts']
                reps[0].proc.send_signal(signal.SIGKILL)
                state['killed'] = True
            if rolled and promoted and state['killed'] and \
                    profiler.delta_stats()['delta_pushes'] >= 1:
                mgr.request_stop(_DrillDone())

        xs = rngk.rand(12 * 8, DIM).astype(np.float32)
        ys = (rngk.rand(12 * 8) * OUT).astype(np.float32)
        it = mx.io.NDArrayIter(xs, ys, batch_size=8)
        modk = mx.mod.Module(mx.sym.SoftmaxOutput(_head(), name='softmax'),
                             context=CPU)
        with pytest.raises(_DrillDone):
            modk.fit(it, num_epoch=60, optimizer='sgd',
                     optimizer_params={'learning_rate': 0.05},
                     arg_params=args0, checkpoint=mgr,
                     batch_end_callback=on_batch)
        # the clients keep the last candidate's canary judged
        _wait(lambda: not sup.push_active('m'), timeout=60,
              msg='the last push judged')
        stop_clients.set()
        for t in clients:
            t.join(timeout=120)
        verds = pusher.verdicts()
        rolled = [v for v in verds if v.kind == 'rolled_back']
        assert rolled and rolled[0].candidate == 'm@v1', verds
        promoted = [v for v in verds if v.kind == 'promoted'][-1]
        assert not failures, failures[:5]
        assert n_ok[0] > 0
        deadline = time.time() + 90
        while time.time() < deadline:
            live = sup.replicas()
            if len(live) >= 2 and all(sup._probe(r) for r in live) and \
                    sup.stats()['restarts'] > state['restarts_at_kill']:
                break
            time.sleep(0.2)
        assert sup.stats()['restarts'] > state['restarts_at_kill']
        ds = profiler.delta_stats()
        lp = profiler.loop_stats()
        assert ds['delta_pushes'] >= 1                   # a delta
        assert lp['loop_pushes'] > ds['delta_pushes']    # and a full push
        assert ds['delta_parity_refusals'] == 0
        assert ds['delta_push_fallbacks'] == 0           # none refused
        # the fleet's model is the last promoted export: the desired set
        # names it, every replica serves it, answers equal its weights
        assert sup.stats()['models']['m'] == promoted.candidate
        pprefix = os.path.join(pusher.push_dir,
                               'push-%08d' % promoted.step)
        ref = Predictor.from_checkpoint(pprefix, 0, {'data': (1, DIM)},
                                        ctx=CPU)
        want = ref.predict(xk)
        st, body = post_with_backoff(url, {'instances': xk.tolist()},
                                     deadline_s=60)
        assert st == 200
        np.testing.assert_allclose(np.asarray(body['outputs'][0]), want,
                                   **DRILL_TOL)
        from mxnet_tpu_torch.fleet_supervisor import _http_json
        for rep in sup.replicas():
            s2, _h, b2 = _http_json(
                'POST', rep.host, rep.port,
                '/v1/models/%s:predict' % promoted.candidate,
                {'instances': xk.tolist()}, timeout=30)
            assert s2 == 200, (rep.index, s2, b2)
        assert lp['loop_verdicts_rolled_back'] >= 1
        assert lp['loop_verdicts_promoted'] >= 1
    finally:
        stop_clients.set()
        for t in clients:
            if t.is_alive():
                t.join(timeout=30)
        if pusher is not None:
            pusher.close()
        if sup is not None:
            sup.stop()


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 23
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


def _good_loop_run():
    return dict(
        launches_per_step=[32] * 12,
        verdicts=[dict(kind='rolled_back', candidate='resnet50@v1', step=2),
                  dict(kind='promoted', candidate='resnet50@v2', step=8),
                  dict(kind='promoted', candidate='resnet50@v3', step=12)],
        killed=True, respawn_s=14.2, restarts=1, reconciled=True,
        replica_codes={0: 200, 1: 200}, promotions=2, delta_pushes=1,
        full_pushes=2, lost=[], non_200=0, client_ok=300,
        client_rcs=[0, 0],
        models_match=True, fleet_model='resnet50@v3',
        last_promoted='resnet50@v3', final_rel_err=0.01, push_fallbacks=0)


def test_loop_gate_passes_a_good_run():
    assert CS.loop_gate(_good_loop_run()) == []


@pytest.mark.parametrize('edit, word', [
    (lambda r: r.update(launches_per_step=[32, 31]), 'conv launches'),
    (lambda r: r.update(launches_per_step=[]), 'conv launches'),
    (lambda r: r['verdicts'].pop(0), 'rolled'),
    (lambda r: r.update(killed=False), 'SIGKILL'),
    (lambda r: r.update(respawn_s=None), 'respawn'),
    (lambda r: r.update(reconciled=False), 'promoted arm'),
    (lambda r: r.update(promotions=0), 'promoted'),
    (lambda r: r.update(delta_pushes=0), 'delta'),
    (lambda r: r.update(full_pushes=0), 'full'),
    (lambda r: r.update(lost=['ConnectionError']), 'lost'),
    (lambda r: r.update(non_200=1), 'otherwise than 200'),
    (lambda r: r.update(client_ok=0), 'answered'),
    (lambda r: r.update(client_rcs=[0, 1]), 'client exited'),
    (lambda r: r.update(models_match=False), 'last promoted'),
    (lambda r: r.update(final_rel_err=0.2), 'direct Predictor'),
    (lambda r: r.update(push_fallbacks=1), 'refused'),
])
def test_loop_gate_fails_a_bad_run(edit, word):
    run = _good_loop_run()
    edit(run)
    bad = CS.loop_gate(run)
    assert bad and any(word in b for b in bad), bad
