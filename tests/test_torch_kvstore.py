"""The port's parameter server and KVStore against the JAX package's, on
the CPU.

- PS frames are byte-equal for the same objects (bfloat16 arrays among
  them, torch tensors on the port's side, ml_dtypes arrays on the JAX
  package's), and each package decodes the other's; key sharding agrees;
- a port client works against a JAX server thread and a JAX client
  against a port server (init, push, pull, barrier, two clients in sync
  mode);
- the server's plain-SGD fast path is bit-equal to the JAX server's, and
  its generic path (Adam; SGD with multi_precision on bfloat16) within
  the JAX test's rtol 1e-6;
- the local store on one context and on several, against the JAX
  package's;
- Module.fit(kvstore='dist_sync') through an in-process server, on an MLP
  and on the cut ResNet, against the JAX package's run;
- one real `tools.launch -n 2 -s 1` job with neither ml_dtypes nor
  cryptography importable: the ranks end bit-equal.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import ml_dtypes

import mxnet_tpu as jmx
from mxnet_tpu import kvstore_server as jps

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _hostarray as ha
from mxnet_tpu_torch import kvstore_server as tps

REPO = Path(__file__).resolve().parents[1]
TOKEN = 'kvstore-test-token'


@pytest.fixture(autouse=True)
def _ps_env(monkeypatch):
    monkeypatch.setenv('DMLC_PS_TOKEN', TOKEN)
    monkeypatch.setenv('MXNET_TPU_PS_MAC', 'hmac')
    for k in ('DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', 'DMLC_NUM_SERVER',
              'DMLC_NUM_WORKER', 'DMLC_WORKER_ID', 'DMLC_PS_BIND_URI'):
        monkeypatch.delenv(k, raising=False)


def _bf16(x):
    """The same bfloat16 values as (an ml_dtypes array, a torch tensor)."""
    a = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(a.view(np.uint16).copy().view(np.int16)).view(
        torch.bfloat16)
    return a, t


def _objects():
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 5).astype(np.float32)
    jb, tb = _bf16(rng.randn(4, 2))
    i8 = rng.randint(-100, 100, (7,)).astype(np.int8)
    zero_d = np.asarray(3.5, np.float64)
    return {
        'scalars': (('ok', 3, -1.5, True, False, None, 'txt', b'raw'),) * 2,
        'push': (('push', 'fc1_weight', f32),) * 2,
        'bf16': (('push_pull_multi', (('w', jb, 2),)),
                 ('push_pull_multi', (('w', tb, 2),))),
        'nested': (('ok', {'a': (i8, zero_d), 7: [f32, 'x']}),) * 2,
    }


@pytest.mark.parametrize('case', sorted(_objects()))
def test_frames_are_byte_equal(case):
    jobj, tobj = _objects()[case]
    jframe = b''.join(bytes(p) for p in jps._build_frame(jobj))
    tframe = b''.join(bytes(p) for p in tps._build_frame(tobj))
    assert jframe == tframe
    # each package decodes the other's payload
    payload = jframe[8 + 1 + 16 + 32:]
    got = tps._decode(payload)
    back = jps._decode(payload)
    assert tps._encode(got) == jps._encode(back) == payload


def test_bf16_decodes_to_torch_and_ml_dtypes():
    jb, tb = _bf16([1.0, -2.5, 3.140625])
    payload = jps._encode(('x', jb))
    got = tps._decode(payload)[1]
    assert got.dtype == torch.bfloat16 and torch.equal(got, tb)
    back = jps._decode(tps._encode(('x', tb)))[1]
    assert back.dtype == jb.dtype and np.array_equal(back.view(np.uint16),
                                                     jb.view(np.uint16))


@pytest.mark.parametrize('servers', [1, 2, 3, 7])
def test_key_to_server_agrees(servers):
    keys = list(range(-3, 300)) + ['fc1_weight', 'conv0_weight', 'k%d' % 9,
                                   '', 'stage3_unit1_conv2_weight']
    for k in keys:
        assert tps._key_to_server(k, servers) == \
            jps._key_to_server(k, servers), k


def test_mac_agrees_and_a_wrong_token_is_refused(monkeypatch):
    parts = [memoryview(b'abc'), memoryview(np.arange(5, dtype=np.uint8))]
    assert tps._frame_tag(tps._ALG_HMAC, b'\0' * 16, parts) == \
        jps._frame_tag(jps._ALG_HMAC, b'\0' * 16, parts)
    a, b = _socketpair()
    try:
        tps._send_msg(a, ('ok', 1))
        monkeypatch.setenv('DMLC_PS_TOKEN', 'another')
        with pytest.raises(ConnectionError, match='MAC'):
            tps._recv_msg(b)
    finally:
        a.close()
        b.close()


def _socketpair():
    import socket
    return socket.socketpair()


class _Server:
    """A package's KVStoreServer on an ephemeral loopback port, served by
    a thread."""

    def __init__(self, ps, workers, sync=True):
        self.server = ps.KVStoreServer(0, workers, sync_mode=sync)
        self.port = self.server.port
        self.thread = threading.Thread(target=self.server.run, daemon=True)
        self.thread.start()

    def client(self, ps, rank):
        return ps.DistServerClient('127.0.0.1', self.port, 1, rank=rank)

    def stop(self, ps):
        c = ps.DistServerClient('127.0.0.1', self.port, 1)
        c.stop_servers()
        c.close()
        self.thread.join(10)


def _both(f0, f1):
    """f0() here and f1() on a thread at once (a barrier or a sync round
    of two clients); their results."""
    out = [None, None]

    def second():
        out[1] = f1()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    out[0] = f0()
    t.join(30)
    assert not t.is_alive()
    return out


def _host_f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v, np.float32)


@pytest.mark.parametrize('server_pkg,client_pkg',
                         [('jax', 'torch'), ('torch', 'jax')])
def test_client_of_one_package_against_the_others_server(server_pkg,
                                                         client_pkg):
    sp = jps if server_pkg == 'jax' else tps
    cp = tps if client_pkg == 'torch' else jps
    srv = _Server(sp, workers=2)
    c0, c1 = srv.client(cp, 0), srv.client(cp, 1)
    try:
        rng = np.random.RandomState(1)
        w = rng.randn(4, 3).astype(np.float32)
        c0.init('w', w)
        _both(c0.barrier, c1.barrier)
        np.testing.assert_array_equal(c1.pull('w'), w)
        g0, g1 = rng.randn(4, 3).astype(np.float32), \
            rng.randn(4, 3).astype(np.float32)
        # sync mode: the round completes with both pushes; no updater,
        # so the store takes the sum
        c0.push('w', g0)
        c1.push('w', g1)
        np.testing.assert_array_equal(c0.pull('w'), g0 + g1)
        np.testing.assert_array_equal(c1.pull('w'), g0 + g1)
        # a bf16 key through the multi-key round
        jb, tb = _bf16(rng.randn(6))
        c0.init('b', jb if cp is jps else tb)
        _both(c0.barrier, c1.barrier)
        got = _both(
            lambda: c0.push_pull_multi([('b', jb if cp is jps else tb)]),
            lambda: c1.push_pull_multi([('b', jb if cp is jps else tb)]))
        want = (torch.from_numpy(_host_f32(tb)) * 2).numpy()
        for g in got:
            np.testing.assert_array_equal(_host_f32(g['b']), want)
        assert c0.num_dead(60.0) == 0
    finally:
        c0.close()
        c1.close()
        srv.stop(sp)


def _opt_rounds(ps, opt_pkg, optimizer, weights, pushes):
    """One server of `ps` with `optimizer` pickled over its channel, two
    clients pushing `pushes` (a list of rounds of (g0, g1) by key); the
    weights pulled after each round."""
    srv = _Server(ps, workers=2)
    c0, c1 = srv.client(ps, 0), srv.client(ps, 1)
    try:
        for k, w in weights.items():
            c0.init(k, w)
        import pickle
        c0.set_optimizer(pickle.dumps(optimizer))
        out = []
        for rnd in pushes:
            for k, (g0, g1) in rnd.items():
                c0.push(k, g0)
                c1.push(k, g1)
            out.append({k: c0.pull(k) for k in rnd})
        return out
    finally:
        c0.close()
        c1.close()
        srv.stop(ps)


def _sgd_case(seed=2, rounds=3):
    rng = np.random.RandomState(seed)
    weights = {'a': rng.randn(5, 4).astype(np.float32),
               'b': rng.randn(7).astype(np.float32)}
    pushes = [{k: (rng.randn(*w.shape).astype(np.float32) * 3,
                   rng.randn(*w.shape).astype(np.float32) * 3)
               for k, w in weights.items()} for _ in range(rounds)]
    return weights, pushes


@pytest.mark.parametrize('momentum,clip', [(0.0, None), (0.9, None),
                                           (0.9, 2.0)])
def test_server_fast_path_is_bit_equal_to_jax(momentum, clip):
    weights, pushes = _sgd_case()
    kw = dict(learning_rate=0.05, momentum=momentum, wd=1e-3,
              rescale_grad=0.5, clip_gradient=clip)
    got = _opt_rounds(tps, mx, mx.optimizer.SGD(**kw), weights, pushes)
    ref = _opt_rounds(jps, jmx, jmx.optimizer.SGD(**kw), weights, pushes)
    for g, r in zip(got, ref):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize('case', ['adam', 'sgd_mp_bf16'])
def test_server_generic_path_matches_jax(case):
    weights, pushes = _sgd_case(seed=3, rounds=2)
    if case == 'adam':
        kw = dict(learning_rate=0.01, wd=1e-3, rescale_grad=0.5)
        t_opt, j_opt = mx.optimizer.Adam(**kw), jmx.optimizer.Adam(**kw)
        t_w, j_w, t_p, j_p = weights, weights, pushes, pushes
    else:
        kw = dict(learning_rate=0.05, momentum=0.9, wd=1e-3,
                  rescale_grad=0.5, multi_precision=True)
        t_opt, j_opt = mx.optimizer.SGD(**kw), jmx.optimizer.SGD(**kw)
        j_w = {k: _bf16(v)[0] for k, v in weights.items()}
        t_w = {k: _bf16(v)[1] for k, v in weights.items()}
        j_p = [{k: (_bf16(a)[0], _bf16(b)[0]) for k, (a, b) in r.items()}
               for r in pushes]
        t_p = [{k: (_bf16(a)[1], _bf16(b)[1]) for k, (a, b) in r.items()}
               for r in pushes]
    got = _opt_rounds(tps, mx, t_opt, t_w, t_p)
    ref = _opt_rounds(jps, jmx, j_opt, j_w, j_p)
    for g, r in zip(got, ref):
        for k in r:
            if case == 'sgd_mp_bf16':
                assert g[k].dtype == torch.bfloat16
            np.testing.assert_allclose(_host_f32(g[k]), _host_f32(r[k]),
                                       rtol=1e-6)


def test_server_updates_on_the_host_only():
    srv = _Server(tps, workers=1)
    try:
        c = srv.client(tps, 0)
        c.init('w', torch.ones(3, dtype=torch.bfloat16))
        import pickle
        c.set_optimizer(pickle.dumps(mx.optimizer.SGD(
            learning_rate=0.5, multi_precision=True)))
        c.push('w', torch.ones(3, dtype=torch.bfloat16))
        out = c.pull('w')
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), [0.5] * 3)
        rep = srv.server.report()
        assert rep['rounds'] == 1 and rep['keys'] == 1
        c.close()
    finally:
        srv.stop(tps)


# -- the local store ----------------------------------------------------------

@pytest.mark.parametrize('ncontexts', [1, 2, 3])
def test_local_store_matches_jax(ncontexts):
    rng = np.random.RandomState(4)
    w = rng.randn(6, 3).astype(np.float32)
    grads = [[rng.randn(6, 3).astype(np.float32) for _ in range(ncontexts)]
             for _ in range(3)]
    out = []
    for pkg in (mx, jmx):
        # the JAX package's store cannot stack values of several devices
        # (ROADMAP Queue C): its reference sums them on cpu(0)
        ctxs = [pkg.cpu(i if pkg is mx else 0) for i in range(ncontexts)]
        kv = pkg.kvstore.create('local')
        kv.init(3, pkg.nd.array(w, ctx=ctxs[0]))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                           wd=1e-3))
        outs = [pkg.nd.zeros((6, 3), ctx=c) for c in ctxs]
        seen = []
        for rnd in grads:
            kv.push(3, [pkg.nd.array(g, ctx=c) for g, c in zip(rnd, ctxs)])
            kv.pull(3, out=outs)
            seen.append([o.asnumpy() for o in outs])
        assert kv.rank == 0 and kv.num_workers == 1 and kv.type == 'local'
        out.append(seen)
    for t, j in zip(*out):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_local_store_without_updater_and_its_states(tmp_path):
    kv = mx.kv.create('device')
    kv.init(['a', 'b'], [mx.nd.ones((2,), ctx=mx.cpu()),
                         mx.nd.zeros((3,), ctx=mx.cpu())])
    with pytest.raises(mx.MXNetError, match='already initialized'):
        kv.init('a', mx.nd.ones((2,), ctx=mx.cpu()))
    kv.push('a', [mx.nd.ones((2,), ctx=mx.cpu(0)),
                  mx.nd.ones((2,), ctx=mx.cpu(1))])
    o = mx.nd.zeros((2,), ctx=mx.cpu())
    kv.pull('a', out=o)
    np.testing.assert_array_equal(o.asnumpy(), [2, 2])
    with pytest.raises(mx.MXNetError, match='Cannot save'):
        kv.save_optimizer_states(str(tmp_path / 's'))
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.5))
    kv.push('b', mx.nd.ones((3,), ctx=mx.cpu()))
    kv.save_optimizer_states(str(tmp_path / 's'))
    kv2 = mx.kv.create('local')
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.5))
    kv2.load_optimizer_states(str(tmp_path / 's'))
    assert set(kv2.updater.states) == {'b'}
    assert kv.num_dead_node == 0
    kv.barrier()


@pytest.mark.parametrize('what', ['mark_sparse'])
def test_item_6_parts_raise(what, monkeypatch):
    """A marked sparse key's COO gradient applies rows-only, as in the
    JAX package's store: twice with momentum 0.9 and wd, equal tables,
    and the untouched rows (weight and lazy momentum) unchanged."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(12, 3).astype(np.float32)
    coo = [(np.array([1, 4, 7]), rng.randn(3, 3).astype(np.float32)),
           (np.array([4, 11]), rng.randn(2, 3).astype(np.float32))]
    out = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        with ctx:
            kv = pkg.kvstore.create('local')
            kv.init('emb', pkg.nd.array(w0))
            kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                               momentum=0.9, wd=0.01))
            kv.mark_sparse('emb', 12)
            assert kv._sparse_meta == {'emb': 12}
            for uids, rows in coo:
                kv._apply_sparse_coo('emb', uids, rows)
            o = pkg.nd.zeros((12, 3))
            kv.pull('emb', out=o)
            out.append(o.asnumpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)
    untouched = [0, 2, 3, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(out[1][untouched], w0[untouched])
    assert np.abs(out[1][[1, 4, 7, 11]] - w0[[1, 4, 7, 11]]).min() > 0


def test_zero_stage_facade(monkeypatch):
    """tests/test_zero.py::test_kvstore_zero_stage_facade on the port:
    the constructor's stage, else MXNET_TPU_ZERO; the JAX package's
    store answers the same."""
    monkeypatch.delenv('MXNET_TPU_ZERO', raising=False)
    assert mx.kv.create('local', zero=1).zero_stage == 1
    monkeypatch.setenv('MXNET_TPU_ZERO', '1')
    assert mx.kv.create('local').zero_stage == 1
    assert jmx.kvstore.create('local').zero_stage == 1
    monkeypatch.delenv('MXNET_TPU_ZERO')
    assert mx.kv.create('local').zero_stage == 0
    with pytest.raises(ValueError):
        mx.kv.create('local', zero=2).zero_stage


# -- Module through an in-process parameter server ---------------------------

def _mlp(pkg):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, name='fc1', num_hidden=16)
    act = pkg.sym.Activation(fc1, act_type='relu')
    fc2 = pkg.sym.FullyConnected(act, name='fc2', num_hidden=3)
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _ps_env_for(monkeypatch, port):
    monkeypatch.setenv('DMLC_PS_ROOT_URI', '127.0.0.1')
    monkeypatch.setenv('DMLC_PS_ROOT_PORT', str(port))
    monkeypatch.setenv('DMLC_NUM_SERVER', '1')
    monkeypatch.setenv('DMLC_NUM_WORKER', '1')
    monkeypatch.setenv('DMLC_WORKER_ID', '0')


def _fit_through_ps(pkg, ps, monkeypatch, symbol, X, y, params, batch,
                    opt, epochs, ctx_bind=None):
    srv = _Server(ps, workers=1)
    try:
        _ps_env_for(monkeypatch, srv.port)
        ctx = pkg.cpu()
        kv = pkg.kvstore.create('dist_sync')
        assert type(kv).__name__ == 'KVStoreDistPS'
        assert kv.num_workers == 1 and kv.rank == 0
        it = pkg.io.NDArrayIter(X, y, batch_size=batch)
        mod = pkg.mod.Module(symbol, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        args, auxs = params
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in args.items()},
                        aux_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in auxs.items()},
                        allow_missing=False)
        mod.fit(it, num_epoch=epochs, kvstore=kv, optimizer='sgd',
                optimizer_params=dict(opt))
        assert mod._update_on_kvstore
        got = {k: np.asarray(v.asnumpy(), np.float32)
               for k, v in mod.get_params()[0].items()}
        kv.close()
        return got
    finally:
        srv.stop(ps)


def test_module_fit_through_a_ps_matches_jax_on_the_mlp(monkeypatch):
    rng = np.random.RandomState(5)
    X = rng.randn(48, 6).astype(np.float32)
    y = (np.arange(48) % 3).astype(np.float32)
    params = ({'fc1_weight': rng.randn(16, 6).astype(np.float32) * 0.3,
               'fc1_bias': np.zeros(16, np.float32),
               'fc2_weight': rng.randn(3, 16).astype(np.float32) * 0.3,
               'fc2_bias': np.zeros(3, np.float32)}, {})
    opt = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
    got = _fit_through_ps(mx, tps, monkeypatch, _mlp(mx), X, y, params, 12,
                          opt, 2)
    ref = _fit_through_ps(jmx, jps, monkeypatch, _mlp(jmx), X, y, params, 12,
                          opt, 2)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_module_fit_through_a_ps_matches_jax_on_the_cut_resnet(monkeypatch):
    from test_torch_resnet import BATCH, CUT, F32_STATE, SHAPES, \
        seeded_params
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    jsym = jmx.models.resnet.resnet(dtype='float32', **CUT)
    args, auxs = seeded_params(jsym, SHAPES, seed=0)
    xs, ys = [], []
    for seed in (1, 2):
        a, _ = seeded_params(jsym, SHAPES, seed=seed)
        xs.append(a['data'])
        ys.append(a['softmax_label'])
    X, y = np.concatenate(xs), np.concatenate(ys)
    params = ({k: v for k, v in args.items()
               if k not in ('data', 'softmax_label')}, auxs)
    opt = dict(learning_rate=0.1 * BATCH / 256, momentum=0.9, wd=1e-4)
    got = _fit_through_ps(mx, tps, monkeypatch,
                          mx.models.resnet.resnet(dtype='float32', **CUT),
                          X, y, params, BATCH, opt, 1)
    ref = _fit_through_ps(jmx, jps, monkeypatch, jsym, X, y, params, BATCH,
                          opt, 1)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **F32_STATE)


# -- the launcher, with neither ml_dtypes nor cryptography -------------------

HIDE = {'ml_dtypes.py': 'raise ImportError("hidden for the test")\n',
        'cryptography/__init__.py':
            'raise ImportError("hidden for the test")\n'}

WORKER = r'''
import os, sys
import numpy as np
import mxnet_tpu_torch as mx
for mod in ('ml_dtypes', 'cryptography', 'jax', 'mxnet_tpu'):
    assert mod not in sys.modules, mod
rank = int(os.environ['DMLC_WORKER_ID'])
rng = np.random.RandomState(10 + rank)
X = rng.randn(24, 5).astype(np.float32)
y = (np.arange(24) % 3).astype(np.float32)
with mx.cpu():
    data = mx.sym.Variable('data')
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name='fc1'),
                          act_type='relu'), num_hidden=3, name='fc2'),
        name='softmax')
    kv = mx.kv.create('dist_sync')
    np.random.seed(0)
    mx.random.seed(0)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=6), num_epoch=2, kvstore=kv,
            optimizer='sgd', optimizer_params={'learning_rate': 0.1,
                                               'momentum': 0.9},
            initializer=mx.init.Xavier())
    args, _ = mod.get_params()
    np.savez(os.path.join(sys.argv[1], 'r%d.npz' % rank),
             **{k: v.asnumpy() for k, v in args.items()})
    kv.barrier()
    if rank == 0:
        kv.stop_servers()
    print('WORKER_OK', rank, type(kv).__name__)
'''


def test_launcher_ps_job_without_ml_dtypes_or_cryptography(tmp_path):
    hide = tmp_path / 'hide'
    for name, text in HIDE.items():
        (hide / name).parent.mkdir(parents=True, exist_ok=True)
        (hide / name).write_text(text)
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('DMLC_', 'MXNET_TPU_'))}
    env['PYTHONPATH'] = os.pathsep.join([str(hide), str(REPO)])
    env['MXNET_TPU_PS_REPORT'] = str(tmp_path / 'server.json')
    res = subprocess.run(
        [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n', '2',
         '-s', '1', '--launcher', 'local', sys.executable, str(worker),
         str(tmp_path)], capture_output=True, text=True, timeout=240,
        env=env, cwd=str(tmp_path))
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert 'WORKER_OK 0 KVStoreDistPS' in res.stdout
    assert 'WORKER_OK 1 KVStoreDistPS' in res.stdout
    a, b = np.load(tmp_path / 'r0.npz'), np.load(tmp_path / 'r1.npz')
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    import json
    deadline = 10
    import time
    while not (tmp_path / 'server.json').exists() and deadline > 0:
        time.sleep(0.2)
        deadline -= 0.2
    report = json.loads((tmp_path / 'server.json').read_text())
    assert report['cuda_initialized'] is False and report['rounds'] > 0
