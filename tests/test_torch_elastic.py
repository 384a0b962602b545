"""The port's elastic checkpoints against the JAX package's, on the CPU.

- shard files are byte-equal across the packages in both directions,
  bfloat16 included, and each package reads the other's; a torn file
  is refused;
- a CheckpointManager round trip restores bit for bit (FusedSGD's
  momenta, the per-key updater's states, a store's updater);
- a SIGKILL at a step in a subprocess, then a resume, ends bit-equal to
  the straight run; a torn newest checkpoint falls back to the newest
  intact one; an incremental (delta-chain) resume is bit-equal; SIGTERM
  commits a final checkpoint and raises Preempted;
- a JAX-written checkpoint restores into the port within the JAX test's
  rtol 2e-6 / atol 1e-7 (tests/test_elastic.py), its JAX RNG key skipped
  with a logged warning;
- fit(checkpoint=) resumes mid-epoch; BucketingModule records its rung;
  LrBackoff and fast_forward.
"""
import json
import logging
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import ml_dtypes

import mxnet_tpu as jmx
from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _hostarray as ha
from mxnet_tpu_torch import elastic, profiler
from mxnet_tpu_torch.base import MXNetError

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in list(os.environ):
        if k.startswith('MXNET_TPU_FAULT_'):
            monkeypatch.delenv(k, raising=False)


def _mlp(pkg):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, name='fc1', num_hidden=16)
    act = pkg.sym.Activation(fc1, act_type='relu')
    fc2 = pkg.sym.FullyConnected(act, name='fc2', num_hidden=4)
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _module(pkg=mx, optimizer='sgd', seed=5, bsz=8, params=None,
            opt_params=None):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.bind(data_shapes=[('data', (bsz, 6))],
             label_shapes=[('softmax_label', (bsz,))])
    if params is None:
        rng = np.random.RandomState(seed)
        params = {'fc1_weight': rng.randn(16, 6) * 0.4,
                  'fc1_bias': rng.randn(16) * 0.1,
                  'fc2_weight': rng.randn(4, 16) * 0.4,
                  'fc2_bias': rng.randn(4) * 0.1}
    mod.init_params(arg_params={k: pkg.nd.array(np.asarray(v, np.float32),
                                                ctx=ctx)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params or
                       {'learning_rate': 0.1, 'momentum': 0.9})
    return mod


def _batches(pkg, n, bsz=8, seed=0):
    rng = np.random.RandomState(seed)
    ctx = pkg.cpu()
    return [pkg.io.DataBatch(
        data=[pkg.nd.array(rng.rand(bsz, 6).astype(np.float32), ctx=ctx)],
        label=[pkg.nd.array((rng.rand(bsz) * 4).astype(np.float32),
                            ctx=ctx)])
        for _ in range(n)]


def _train(mod, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()


def _params(mod):
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items()) +
            list(auxs.items())}


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- shard files -------------------------------------------------------------

def _entries():
    rng = np.random.RandomState(1)
    b = rng.randn(3, 4).astype(np.float32)
    jb = b.astype(ml_dtypes.bfloat16)
    tb = ha.host(jb)
    common = [('param:w', rng.randn(5, 2).astype(np.float32)),
              ('idx', np.arange(7, dtype=np.int64)),
              ('zero_d', np.asarray(2.5, np.float64)),
              ('empty', np.zeros((0, 3), np.float32))]
    return common + [('bf', jb)], common + [('bf', tb)]


def test_shard_files_are_byte_equal_both_ways(tmp_path):
    jent, tent = _entries()
    jpath, tpath = tmp_path / 'j.bin', tmp_path / 't.bin'
    jelastic.write_shard_file(str(jpath), jent)
    n, crc = elastic.write_shard_file(str(tpath), tent)
    assert jpath.read_bytes() == tpath.read_bytes()
    assert n == tpath.stat().st_size
    got = elastic.read_shard_file(str(jpath))
    back = jelastic.read_shard_file(str(tpath))
    assert got['bf'].dtype == torch.bfloat16
    assert back['bf'].dtype == ml_dtypes.bfloat16
    for name, v in tent:
        assert ha.raw_bytes(got[name]).tobytes() == \
            ha.raw_bytes(v).tobytes(), name
        assert tuple(got[name].shape) == tuple(back[name].shape)
    # a torn file is refused
    data = tpath.read_bytes()
    tpath.write_bytes(data[:len(data) // 2])
    with pytest.raises(MXNetError, match='torn'):
        elastic.read_shard_file(str(tpath))
    tpath.write_bytes(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(MXNetError, match='checksum'):
        elastic.read_shard_file(str(tpath))


# -- the manager --------------------------------------------------------------

@pytest.mark.parametrize('optimizer', ['sgd', 'adam'])
def test_manager_round_trip_is_bit_equal(tmp_path, optimizer):
    with mx.cpu():
        mod = _module(optimizer=optimizer,
                      opt_params={'learning_rate': 0.05} if
                      optimizer == 'adam' else None)
        batches = _batches(mx, 6)
        _train(mod, batches[:3])
        mgr = elastic.CheckpointManager(str(tmp_path), async_=False)
        mgr.attach(mod)
        mgr._step = 3
        ck = mgr.save(sync=True)
        man = json.loads((Path(ck) / 'manifest.json').read_text())
        assert man['opt']['mode'] == ('replicated' if optimizer == 'sgd'
                                      else 'pickle')
        _train(mod, batches[3:])
        other = _module(optimizer=optimizer, seed=9,
                        opt_params={'learning_rate': 0.05} if
                        optimizer == 'adam' else None)
        info = elastic.resume(elastic.CheckpointManager(str(tmp_path)),
                              other)
        assert info.step == 3
        _train(other, batches[3:])
        _assert_equal(_params(other), _params(mod))
        mgr.close()


def test_async_snapshot_is_the_step_it_was_taken_at(tmp_path, monkeypatch):
    """The writer waits (a slow filesystem) while training goes on: the
    committed checkpoint still holds the step of its save."""
    monkeypatch.setenv('MXNET_TPU_FAULT_WRITE_DELAY_MS', '300')
    with mx.cpu():
        mod = _module()
        batches = _batches(mx, 4)
        _train(mod, batches[:2])
        want = _params(mod)
        mgr = elastic.CheckpointManager(str(tmp_path)).attach(mod)
        mgr._step = 2
        mgr.save()                      # async
        _train(mod, batches[2:])        # in-place updates meanwhile
        assert mgr.wait(10)
        _, arrays, _ = elastic.load_newest_intact(str(tmp_path))
        got = {k[6:]: ha.to_float32(v) for k, v in arrays.items()
               if k.startswith('param:')}
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert profiler.ckpt_stats()['ckpt_async_overlap_ms'] > 0
        mgr.close()


FIT_WORKER = r'''
import sys, time
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic
sys.path.insert(0, sys.argv[3])
import test_torch_elastic as T
with mx.cpu():
    mod = mx.mod.Module(T._mlp(mx), context=mx.cpu())
    mgr = elastic.CheckpointManager(sys.argv[1], every_n_steps=2,
                                    incremental=int(sys.argv[4]))
    T._fit(mod, mgr, cb=lambda p: time.sleep(0.05))
    if mgr.last_resume is not None:
        print('RESUMED step=%d' % mgr.last_resume.step)
    np.savez(sys.argv[2], **T._params(mod))
    mgr.close()
    print('FIT_WORKER_DONE')
'''


def _fit_iter():
    rng = np.random.RandomState(3)
    X = rng.rand(64, 6).astype(np.float32)
    y = (rng.rand(64) * 4).astype(np.float32)
    return mx.io.NDArrayIter(X, y, batch_size=8)


def _fit(mod, ckpt=None, cb=None, epochs=2):
    np.random.seed(0)
    mx.random.seed(7)
    mod.fit(_fit_iter(), num_epoch=epochs, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
            initializer=mx.init.Xavier(), checkpoint=ckpt,
            batch_end_callback=cb)


def _straight():
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        _fit(mod)
        return _params(mod)


def test_sigkill_in_a_subprocess_then_resume_is_bit_equal(tmp_path):
    worker = tmp_path / 'worker.py'
    worker.write_text(FIT_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO),
               MXNET_TPU_FAULT_KILL_AT_STEP='11')
    ck = tmp_path / 'ck'
    res = subprocess.run([sys.executable, str(worker), str(ck),
                          str(tmp_path / 'out.npz'),
                          str(REPO / 'tests'), '0'],
                         capture_output=True, text=True, timeout=180,
                         env=env)
    assert res.returncode == -signal.SIGKILL, (res.stdout, res.stderr)
    assert 'FIT_WORKER_DONE' not in res.stdout
    assert elastic.list_checkpoints(str(ck))
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mgr = elastic.CheckpointManager(str(ck), every_n_steps=2)
        _fit(mod, mgr)
        assert mgr.last_resume is not None and \
            8 <= mgr.last_resume.step <= 11
        mgr.close()
        _assert_equal(_params(mod), _straight())


def test_delta_chain_resume_is_bit_equal(tmp_path):
    ck = str(tmp_path / 'ck')
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mgr = elastic.CheckpointManager(ck, every_n_steps=2, incremental=3,
                                        async_=False)
        _fit(mod, mgr, epochs=1)
        mgr.close()
        assert elastic.list_deltas(ck), os.listdir(ck)
        newest = max(elastic.list_checkpoints(ck) + elastic.list_deltas(ck))
        assert newest in elastic.list_deltas(ck)
        assert profiler.delta_stats()['delta_committed'] >= 1
        mod2 = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mgr2 = elastic.CheckpointManager(ck, every_n_steps=2, incremental=3)
        _fit(mod2, mgr2)
        assert mgr2.last_resume.directory.endswith('delta-%08d' % newest)
        mgr2.close()
        _assert_equal(_params(mod2), _straight())


def test_torn_newest_checkpoint_falls_back(tmp_path, monkeypatch):
    ck = str(tmp_path / 'ck')
    with mx.cpu():
        mod = _module()
        batches = _batches(mx, 4)
        mgr = elastic.CheckpointManager(ck, async_=False).attach(mod)
        _train(mod, batches[:2])
        mgr._step = 2
        mgr.save(sync=True)
        want = _params(mod)
        _train(mod, batches[2:])
        mgr._step = 4
        monkeypatch.setenv('MXNET_TPU_FAULT_TORN_CKPT', '1')
        mgr.save(sync=True)
        monkeypatch.delenv('MXNET_TPU_FAULT_TORN_CKPT')
        before = profiler.ckpt_stats()['ckpt_torn_fallbacks']
        other = _module(seed=8)
        info = elastic.resume(elastic.CheckpointManager(ck), other)
        assert info.step == 2
        assert profiler.ckpt_stats()['ckpt_torn_fallbacks'] == before + 1
        _assert_equal(_params(other), want)
        mgr.close()


def test_sigterm_commits_and_raises_preempted(tmp_path):
    with mx.cpu():
        mod = _module()
        mgr = elastic.CheckpointManager(str(tmp_path)).attach(mod)
        mgr.install_signal_handlers()
        try:
            _train(mod, _batches(mx, 1))
            os.kill(os.getpid(), signal.SIGTERM)
            assert mgr.preempted
            with pytest.raises(elastic.Preempted) as excinfo:
                mgr.step_end(epoch=0, batches_in_epoch=1, batch_size=8)
            assert excinfo.value.step == 1
            assert elastic.list_checkpoints(str(tmp_path)) == [1]
        finally:
            mgr.close()
        assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None) \
            or callable(signal.getsignal(signal.SIGTERM))


def test_a_jax_checkpoint_restores_into_the_port(tmp_path, caplog):
    rng = np.random.RandomState(2)
    params = {'fc1_weight': rng.randn(16, 6) * 0.4,
              'fc1_bias': rng.randn(16) * 0.1,
              'fc2_weight': rng.randn(4, 16) * 0.4,
              'fc2_bias': rng.randn(4) * 0.1}
    jmod = _module(jmx, params=params)
    jb = _batches(jmx, 5)
    _train(jmod, jb[:3])
    jmgr = jelastic.CheckpointManager(str(tmp_path), async_=False, rank=0,
                                      world=1).attach(jmod)
    jmgr._step = 3
    jmgr.save(sync=True)
    jmgr.close()
    with mx.cpu():
        tmod = _module(mx, params={k: v * 0 for k, v in params.items()})
        with caplog.at_level(logging.WARNING):
            info = elastic.resume(elastic.CheckpointManager(str(tmp_path)),
                                  tmod)
        assert info.step == 3
        if 'rng:step' in jelastic.load_newest_intact(str(tmp_path))[1]:
            assert any('rng:step' in r.getMessage() for r in caplog.records)
        got = _params(tmod)
        for k, v in _params(jmod).items():
            np.testing.assert_allclose(got[k], v, rtol=2e-6, atol=1e-7,
                                       err_msg=k)
        # the momenta came across: both continue alike
        _train(jmod, jb[3:])
        _train(tmod, _batches(mx, 5)[3:])
        for k, v in _params(jmod).items():
            np.testing.assert_allclose(_params(tmod)[k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # and the port's checkpoint restores into the JAX package
    tdir = tmp_path / 'port'
    with mx.cpu():
        tm = elastic.CheckpointManager(str(tdir), async_=False).attach(tmod)
        tm._step = 9
        tm.save(sync=True)
        tm.close()
    jmod2 = _module(jmx, params={k: v * 0 for k, v in params.items()})
    assert jelastic.resume(jelastic.CheckpointManager(str(tdir), rank=0,
                                                      world=1),
                           jmod2).step == 9
    for k, v in _params(tmod).items():
        np.testing.assert_allclose(_params(jmod2)[k], v, rtol=2e-6,
                                   atol=1e-7, err_msg=k)


def test_rng_states_round_trip(tmp_path):
    with mx.cpu():
        mod = _module()
        mx.random.seed(4)
        mx.nd.random.uniform(shape=(3,))
        mgr = elastic.CheckpointManager(str(tmp_path), async_=False)
        mgr.attach(mod)
        mgr.save(sync=True)
        want = mx.nd.random.uniform(shape=(5,)).asnumpy()
        mx.random.seed(99)
        elastic.CheckpointManager(str(tmp_path)).attach(mod).restore()
        np.testing.assert_array_equal(
            mx.nd.random.uniform(shape=(5,)).asnumpy(), want)
        mgr.close()


def test_fit_resumes_mid_epoch_and_watermark(tmp_path):
    ck = str(tmp_path / 'ck')
    with mx.cpu():
        first = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mgr = elastic.CheckpointManager(ck, every_n_steps=3, async_=False)
        calls = []

        def stop(param):
            calls.append(param.nbatch)
            if len(calls) == 11:
                mgr.request_preempt()
        with pytest.raises(elastic.Preempted) as excinfo:
            _fit(first, mgr, cb=stop)
        assert excinfo.value.step == 11
        man = json.loads((Path(excinfo.value.checkpoint_dir) /
                          'manifest.json').read_text())
        assert man['epoch'] == 1 and man['batches_in_epoch'] == 3
        assert man['samples_consumed'] == 24
        resumed = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mgr2 = elastic.CheckpointManager(ck, every_n_steps=3)
        _fit(resumed, mgr2)
        mgr2.close()
        _assert_equal(_params(resumed), _straight())


def test_bucketing_module_records_its_rung(tmp_path):
    with mx.cpu():
        def sym_gen(key):
            data = mx.sym.Variable('data')
            net = mx.sym.FullyConnected(data, num_hidden=4, name='fc')
            return mx.sym.SoftmaxOutput(net, name='softmax'), \
                ('data',), ('softmax_label',)
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                     context=mx.cpu())
        mod.bind(data_shapes=[('data', (8, 6))],
                 label_shapes=[('softmax_label', (8,))])
        mod.init_params()
        mod.init_optimizer(optimizer_params={'learning_rate': 0.1,
                                             'momentum': 0.9})
        b = _batches(mx, 1)[0]
        mod.forward_backward(mx.io.DataBatch(
            b.data, b.label, bucket_key=6,
            provide_data=[('data', (8, 6))],
            provide_label=[('softmax_label', (8,))]))
        mod.update()
        mgr = elastic.CheckpointManager(str(tmp_path), async_=False)
        d = mgr.attach(mod).save(sync=True)
        man = json.loads((Path(d) / 'manifest.json').read_text())
        assert man['rung'] == 6
        assert elastic.CheckpointManager(str(tmp_path)).attach(
            mod).restore().rung == 6
        mgr.close()


def test_lr_backoff_and_fast_forward():
    with mx.cpu():
        mod = _module()
        mgr = elastic.CheckpointManager(os.path.join(
            os.environ.get('TMPDIR', '/tmp'), 'lrb%d' % os.getpid()))
        mgr.attach(mod)
        backoff = elastic.LrBackoff(mgr, factor=0.5, after=2)
        assert mgr.on_verdict is backoff
        lr0 = mod._optimizer.lr
        backoff(None, consecutive_rollbacks=1)
        backoff(None, consecutive_rollbacks=2)
        assert mod._optimizer.lr == lr0 * 0.5 and backoff.backoffs == 1
        mgr.close()
        it, ref = _fit_iter(), _fit_iter()
        assert elastic.fast_forward(it, epochs=1, batches=3) == 3
        ref.reset()
        for _ in range(3):
            next(ref)
        np.testing.assert_array_equal(next(it).data[0].asnumpy(),
                                      next(ref).data[0].asnumpy())


@pytest.mark.parametrize('name', ['Preempted', 'dead_hosts',
                                  'heartbeat_drop_ranks', 'barrier_stall_s',
                                  'ring_stall_s', 'num_dead_node',
                                  'check_barrier', 'write_shard_file',
                                  'read_shard_file', 'ResumeInfo',
                                  'list_checkpoints', 'list_deltas',
                                  'load_state', 'load_newest_intact',
                                  'CheckpointManager', 'LrBackoff',
                                  'fast_forward', 'resume'])
def test_every_public_name_of_the_jax_module_is_here(name):
    assert callable(getattr(elastic, name))
    assert callable(getattr(jelastic, name))


def test_fault_knobs_parse_as_the_jax_package(monkeypatch):
    for knob, value in (('DEAD_HOST', '1, 3,x'), ('HEARTBEAT_DROP', '0'),
                        ('BARRIER_STALL_S', '1:0.5'),
                        ('RING_STALL_S', '2.5')):
        monkeypatch.setenv('MXNET_TPU_FAULT_' + knob, value)
    assert elastic.dead_hosts() == jelastic.dead_hosts() == {1, 3}
    assert elastic.heartbeat_drop_ranks() == {0}
    for r in (0, 1, 2):
        assert elastic.barrier_stall_s(r) == jelastic.barrier_stall_s(r)
        assert elastic.ring_stall_s(r) == jelastic.ring_stall_s(r)
    assert elastic.num_dead_node() == 2
    with pytest.raises(MXNetError, match='DEAD_HOST'):
        elastic.check_barrier()
