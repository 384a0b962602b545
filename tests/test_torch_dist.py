"""The port's distributed runtime against the JAX package's, on the CPU.

In-process runtimes (one coordinator, a runtime per virtual rank on a
thread) exercise the cross-process protocol:

- barriers time out naming the absent ranks; a rank whose heartbeats
  are dropped (MXNET_TPU_FAULT_HEARTBEAT_DROP) is declared dead, fails
  barriers and allreduces naming it, and preempts a watched
  CheckpointManager with the dead-rank set;
- `allreduce` and `allreduce_async` on the star and on the ring, on the
  fp32, int8 and bf16 wires, with float32 and bfloat16 arrays, are bit
  for bit the JAX DistRuntime's for the same inputs, and so is
  `allreduce_coo`;
- MXNET_TPU_DIST_JAX=1 brings up one torch.distributed group across the
  workers, and the dist store's facade then runs no host all-reduce.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import ml_dtypes

import mxnet_tpu as jmx
from mxnet_tpu import dist as jdist

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _hostarray as ha
from mxnet_tpu_torch import dist, elastic, profiler
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_PS_MAC', 'hmac')
    for k in ('MXNET_TPU_FAULT_HEARTBEAT_DROP', 'MXNET_TPU_DIST_TOPOLOGY',
              'MXNET_TPU_DIST_WIRE_DTYPE', 'MXNET_TPU_DIST_RING_PORT',
              'MXNET_TPU_FAULT_BARRIER_STALL_S',
              'MXNET_TPU_FAULT_RING_STALL_S', 'DMLC_PS_BIND_URI'):
        monkeypatch.delenv(k, raising=False)


def _pair(pkg, dead_after=30.0, hb=0.1, world=2):
    """A coordinator and `world` in-process runtimes of `pkg`'s dist."""
    coord = pkg.Coordinator(port=0, world=world, bind_addr='127.0.0.1',
                            dead_after=dead_after).start()
    rts = [None] * world
    errs = [None] * world

    def mk(r):
        try:
            rts[r] = pkg.DistRuntime(
                r, world, address='127.0.0.1', port=coord.port,
                start_coordinator=False, timeout=15, hb_interval=hb,
                dead_after=dead_after)
        except BaseException as e:
            errs[r] = e
    ts = [threading.Thread(target=mk, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(e is None for e in errs), errs
    return coord, rts


def _teardown(coord, rts):
    for rt in reversed(rts):
        if rt is not None:
            rt.shutdown()
    coord.stop()


def _on_all(rts, fn):
    """fn(rank, runtime) on a thread per rank; the results by rank."""
    out = [None] * len(rts)
    errs = [None] * len(rts)

    def run(r):
        try:
            out[r] = fn(r, rts[r])
        except BaseException as e:
            errs[r] = e
    ts = [threading.Thread(target=run, args=(r,)) for r in range(len(rts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert all(e is None for e in errs), errs
    return out


def test_barrier_timeout_names_absent_ranks():
    coord, rts = _pair(dist)
    try:
        with pytest.raises(MXNetError) as excinfo:
            rts[0].barrier('late', timeout=1.0)
        msg = str(excinfo.value)
        assert '[1]' in msg and 'never arrived' in msg
        assert 'MXNET_TPU_BARRIER_TIMEOUT_S' in msg
        assert _on_all(rts, lambda r, rt: rt.barrier('both', timeout=10)) \
            == [None, None]
    finally:
        _teardown(coord, rts)


def test_heartbeat_loss_fails_barrier_and_allreduce(monkeypatch):
    coord, rts = _pair(dist, dead_after=0.5)
    monkeypatch.setenv('MXNET_TPU_FAULT_HEARTBEAT_DROP', '1')
    try:
        with pytest.raises(MXNetError, match=r'\[1\] are dead'):
            rts[0].barrier('doomed', timeout=15)
        with pytest.raises(MXNetError, match=r'\[1\] died'):
            rts[0].allreduce([np.ones(2, np.float32)], name='g2',
                             timeout=15)
    finally:
        _teardown(coord, rts)


def test_a_stalled_coordinator_blames_no_rank():
    """A gap between two of the coordinator's scans (its process not
    running its handlers) counts as no rank's silence; a rank silent
    while the scans go on is declared dead as before."""
    coord = dist.Coordinator(port=0, world=2, bind_addr='127.0.0.1',
                             dead_after=1.0)
    try:
        for r in (0, 1):
            coord._handle_hello(r)
        assert coord._handle_dead() == ('ok', [])
        # no handler ran for 3 s: both ranks' heartbeats wait unread
        with coord._cv:
            coord._last_scan -= 3.0
            for r in (0, 1):
                coord._last_seen[r] -= 3.0
        assert coord._handle_heartbeat(0) == ('ok', [])
        assert coord._handle_heartbeat(1) == ('ok', [])
        # rank 1 silent for 3 s while rank 0's heartbeats are handled
        with coord._cv:
            coord._last_seen[1] -= 3.0
        assert coord._handle_heartbeat(0) == ('ok', [1])
    finally:
        coord.stop()


def test_heartbeat_loss_preempts_a_watched_manager(monkeypatch, tmp_path):
    profiler.clear()
    coord, rts = _pair(dist, dead_after=0.5)
    with mx.cpu():
        data = mx.sym.Variable('data')
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            data, num_hidden=4, name='fc'), name='softmax')
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[('data', (8, 6))],
                 label_shapes=[('softmax_label', (8,))])
        mod.init_params()
        mod.init_optimizer()
    mgr = elastic.CheckpointManager(str(tmp_path / 'ck'), rank=0, world=1)
    mgr.attach(mod)
    rts[0].watch(mgr)
    monkeypatch.setenv('MXNET_TPU_FAULT_HEARTBEAT_DROP', '1')
    monkeypatch.setattr(dist, '_RUNTIME', rts[0])
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not mgr.preempted:
            time.sleep(0.05)
        assert mgr.preempted and mgr.preempt_dead_ranks == frozenset({1})
        with pytest.raises(elastic.Preempted) as excinfo:
            mgr.step_end(epoch=0, batches_in_epoch=3, batch_size=8)
        assert excinfo.value.dead_ranks == frozenset({1})
        assert os.path.isdir(excinfo.value.checkpoint_dir)
        kv = mx.kvstore.KVStore('dist_sync')
        assert kv.num_dead_node == 1
        assert kv.rank == 0 and kv.num_workers == 2
        with pytest.raises(MXNetError, match=r'\[1\]'):
            kv.barrier()
        st = profiler.dist_stats()
        assert st['dist_dead_hosts_detected'] >= 1
        assert st['dist_heartbeats_sent'] > 0
        assert st['dist_heartbeats_missed'] > 0
    finally:
        _teardown(coord, rts)
        mgr.close()


def _inputs(rank, dtype):
    rng = np.random.RandomState(20 + rank)
    a = (rng.randn(7, 5) * 3).astype(np.float32)
    b = (rng.randn(13) * 0.1).astype(np.float32)
    ints = (np.arange(6, dtype=np.int64) + rank) * 3
    if dtype == 'bfloat16':
        jb = a.astype(ml_dtypes.bfloat16)
        tb = torch.from_numpy(jb.view(np.uint16).copy().view(np.int16)) \
            .view(torch.bfloat16)
        return [jb, b, ints], [tb, b, ints]
    return [a, b, ints], [a, b, ints]


def _bits(x):
    """Host bytes of a result, whichever package made it."""
    if isinstance(x, torch.Tensor):
        return ha.raw_bytes(x).tobytes(), ha.dtype_name(x), tuple(x.shape)
    x = np.ascontiguousarray(x)
    return x.view(np.uint8).tobytes(), x.dtype.name, x.shape


def _rounds(pkg, topology, wire, dtype, use_async):
    coord, rts = _pair(pkg)
    try:
        def fn(r, rt):
            outs = []
            for rnd in range(2):     # error feedback carries between rounds
                arrays = _inputs(r + 2 * rnd, dtype)[0 if pkg is jdist
                                                     else 1]
                if use_async:
                    outs.append(rt.allreduce_async(
                        arrays, name='g', wire=wire,
                        topology=topology).wait(60))
                else:
                    outs.append(rt.allreduce(arrays, name='g', wire=wire,
                                             topology=topology))
            return outs
        return _on_all(rts, fn)
    finally:
        _teardown(coord, rts)


@pytest.mark.parametrize('use_async', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('wire', ['fp32', 'int8', 'bf16'])
@pytest.mark.parametrize('topology', ['star', 'ring'])
def test_allreduce_is_bit_equal_to_jax(topology, wire, dtype, use_async):
    got = _rounds(dist, topology, wire, dtype, use_async)
    ref = _rounds(jdist, topology, wire, dtype, use_async)
    for r in range(2):
        for g_round, r_round in zip(got[r], ref[r]):
            for g, e in zip(g_round, r_round):
                assert _bits(g) == _bits(e)
    # every rank holds the same bytes
    for a, b in zip(got[0], got[1]):
        assert [_bits(x) for x in a] == [_bits(x) for x in b]


def _coo(pkg, topology):
    coord, rts = _pair(pkg)
    try:
        def fn(r, rt):
            rng = np.random.RandomState(40 + r)
            ids = rng.randint(0, 30, 12)
            rows = rng.randn(12, 4).astype(np.float32)
            return rt.allreduce_coo(ids, rows, name='emb', vocab=30,
                                    topology=topology)
        return _on_all(rts, fn)
    finally:
        _teardown(coord, rts)


@pytest.mark.parametrize('topology', ['star', 'ring'])
def test_allreduce_coo_is_bit_equal_to_jax(topology):
    got, ref = _coo(dist, topology), _coo(jdist, topology)
    for g, e in zip(got, ref):
        np.testing.assert_array_equal(g[0], e[0])
        assert _bits(g[1]) == _bits(e[1])
    # no runtime: the local dedup and sort, as the JAX package's
    ids, rows = np.array([5, 1, 5]), np.ones((3, 2), np.float32)
    a, b = dist.allreduce_coo(ids, rows), jdist.allreduce_coo(ids, rows)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_world_one_and_no_runtime_are_identity():
    t = torch.arange(4, dtype=torch.bfloat16)
    out = dist.allreduce([t, np.ones(3, np.float32)])
    assert torch.equal(out[0], t) and np.array_equal(out[1], np.ones(3))
    assert dist.rank() == 0 and dist.world() == 1
    assert not dist.host_span_active() and dist.dead_ranks() == frozenset()
    h = dist.allreduce_async([np.ones(2, np.float32)])
    np.testing.assert_array_equal(h.wait()[0], np.ones(2))


def test_dist_jax_mode_brings_up_one_process_group(monkeypatch):
    """MXNET_TPU_DIST_JAX=1: initialize also joins the workers into one
    torch.distributed group (at MXNET_TPU_DIST_JAX_ADDR here), over which
    a Module's data mesh reduces in the step, so the host allreduce is
    off; shutdown leaves the group. Two workers through the launcher:
    tests/test_torch_module_dp.py."""
    import socket
    import torch.distributed as tdist
    from mxnet_tpu_torch.parallel import mesh as pmesh
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        free = s.getsockname()[1]
    monkeypatch.setenv('MXNET_TPU_DIST_JAX', '1')
    monkeypatch.setenv('MXNET_TPU_DIST_JAX_ADDR', '127.0.0.1:%d' % free)
    monkeypatch.setenv('MXNET_TPU_DIST_DEVICE', 'cpu')
    monkeypatch.setenv('LOCAL_RANK', '0')
    # init_process_group sets it for a one-host gloo group: restored
    monkeypatch.setenv('GLOO_SOCKET_IFNAME', 'lo')
    rt = dist.initialize(rank=0, world=1, port=0)
    try:
        assert dist.runtime() is rt and tdist.is_initialized()
        assert tdist.get_world_size() == 1
        assert not dist.host_span_active()
        mesh = pmesh.world_data_mesh()
        assert mesh.shape == {'data': 1} and mesh.device.type == 'cpu'
    finally:
        dist.shutdown()
    assert dist.runtime() is None and not tdist.is_initialized()


def test_initialize_from_the_env_contract_and_kvstore_facade(monkeypatch):
    monkeypatch.setenv('DMLC_WORKER_ID', '0')
    monkeypatch.setenv('DMLC_NUM_WORKER', '1')
    monkeypatch.setenv('MXNET_TPU_DIST_PORT', '0')
    monkeypatch.setenv('MXNET_TPU_DIST_RESTART_COUNT', '2')
    profiler.clear()
    rt = dist.initialize()
    try:
        assert dist.initialize() is rt and dist.runtime() is rt
        assert dist.host_span_active()
        kv = mx.kvstore.create('dist_sync')
        assert type(kv) is mx.kvstore.KVStore
        assert kv.rank == 0 and kv.num_workers == 1
        kv.barrier()
        assert profiler.dist_stats()['dist_restarts'] == 2
    finally:
        dist.shutdown()
    assert dist.runtime() is None
