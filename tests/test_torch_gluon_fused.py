"""The fused Gluon step on the port (mxnet_tpu_torch.gluon.fused) held
against the JAX package's FusedStep, on the CPU: the counterparts of
tests/test_gluon_fused.py's 23 tests, the fused cases of
tests/test_overlap_fusion.py (the metric fold, the EMA arm, bulk with
lr schedules, the reduce schedules), the pair route on a small v1 ResNet,
and the data mesh over two gloo ranks (tests/_torch_parallel_ranks.py,
`gluon_fused_suite`) against the port's one-rank step and the JAX
package's.

The same numpy seeds go through both packages. Tolerances are the JAX
tests' own: float32-ulp agreement between two programs (atol 5e-8 /
rtol 1e-6 for plain SGD, 1e-6 / 1e-5 with momentum, wd and clipping),
bit for bit within one package where the JAX tests ask it (determinism,
bulk against single steps, step_ahead), one bfloat16 step for bf16
weights with float32 masters.
"""
import os
import tempfile
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu.gluon import fused as jfused

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import fused as tfused

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import (GF_BATCH as BATCH, GF_FEAT as FEAT,
                                   GF_NCLS as NCLS, GF_OPT_MOM as OPT_MOM,
                                   gf_mlp, gf_pvals, gf_seed_params)

OPT_PLAIN = {'learning_rate': 0.1}
PKGS = {'jax': jmx, 'port': mx}
PLAIN = dict(atol=5e-8, rtol=1e-6)
STEP = dict(atol=1e-6, rtol=1e-5)
BF16 = dict(atol=2e-3, rtol=1e-2)


def _batches(k=3, seed=42):
    rs = np.random.RandomState(seed)
    return [(rs.rand(BATCH, FEAT).astype(np.float32),
             (rs.rand(BATCH) * NCLS).astype(np.float32)) for _ in range(k)]


def _loss(pkg):
    return pkg.gluon.loss.SoftmaxCrossEntropyLoss()


def _imperative(pkg, net, trainer, batches, dtype=None):
    loss = _loss(pkg)
    for x, y in batches:
        x = pkg.nd.array(x)
        if dtype:
            x = x.astype(dtype)
        with pkg.autograd.record():
            l = loss(net(x), pkg.nd.array(y))
        l.backward()
        trainer.step(BATCH)


def _fused(pkg, net, trainer, batches, dtype=None, **kw):
    fs = pkg.gluon.fuse_step(net, _loss(pkg), trainer, **kw)
    for x, y in batches:
        x = pkg.nd.array(x)
        if dtype:
            x = x.astype(dtype)
        fs(x, pkg.nd.array(y))
    return fs


def _vals(net):
    """Copies: the port's fused update writes the weights in place, and
    asnumpy() of a CPU array shares its memory."""
    return [np.array(p.list_data()[0].asnumpy(), np.float32)
            for _, p in sorted(net.collect_params().items())]


def _close(a_vals, b_vals, tol):
    for a, b in zip(a_vals, b_vals):
        np.testing.assert_allclose(a, b, **tol)


def _both(fn):
    """fn(pkg) in each package on its CPU: {'jax': ..., 'port': ...}."""
    out = {}
    for name, pkg in PKGS.items():
        with pkg.cpu():
            out[name] = fn(pkg)
    return out


def _trainer(pkg, net, opt):
    return pkg.gluon.Trainer(net.collect_params(), 'sgd', dict(opt))


# -- parity against the JAX package and the imperative path -------------------

def test_fused_parity_plain_sgd():
    batches = _batches()

    def run(pkg):
        ni = gf_mlp(pkg, 1)
        _imperative(pkg, ni, _trainer(pkg, ni, OPT_PLAIN), batches)
        nf = gf_mlp(pkg, 1)
        fs = _fused(pkg, nf, _trainer(pkg, nf, OPT_PLAIN), batches)
        vals = _vals(nf)
        shape = fs(pkg.nd.array(batches[0][0]),
                   pkg.nd.array(batches[0][1])).shape
        return _vals(ni), vals, shape
    out = _both(run)
    _close(out['port'][0], out['port'][1], PLAIN)
    _close(out['port'][1], out['jax'][1], PLAIN)
    assert out['port'][2] == out['jax'][2] == (BATCH,)


def test_fused_determinism_bitwise():
    batches = _batches()
    runs = []
    with mx.cpu():
        for _ in range(2):
            mx.random.seed(11)
            net = gf_mlp(mx, 1)
            _fused(mx, net, _trainer(mx, net, OPT_MOM), batches)
            runs.append(_vals(net))
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


def test_fused_parity_momentum_wd_clip():
    kw = dict(OPT_MOM, clip_gradient=0.05)
    batches = _batches()

    def run(pkg):
        ni = gf_mlp(pkg, 2)
        _imperative(pkg, ni, _trainer(pkg, ni, kw), batches)
        nf = gf_mlp(pkg, 2)
        _fused(pkg, nf, _trainer(pkg, nf, kw), batches)
        return _vals(ni), _vals(nf)
    out = _both(run)
    _close(out['port'][0], out['port'][1], STEP)
    _close(out['port'][1], out['jax'][1], STEP)


def test_fused_bf16_fp32_masters():
    kw = {'learning_rate': 0.1, 'momentum': 0.9, 'multi_precision': True}
    batches = _batches()

    def run(pkg):
        nets = []
        for arm in ('imperative', 'fused'):
            net = gf_mlp(pkg, 5)
            net.cast('bfloat16')
            tr = _trainer(pkg, net, kw)
            if arm == 'imperative':
                _imperative(pkg, net, tr, batches, 'bfloat16')
            else:
                _fused(pkg, net, tr, batches, 'bfloat16')
                masters = sum(m is not None
                              for m in tr._fused_updater.masters.values())
            nets.append(_vals(net))
        return nets, masters
    out = _both(run)
    assert out['port'][1] == out['jax'][1] == 4
    _close(out['port'][0][0], out['port'][0][1], BF16)
    _close(out['port'][0][1], out['jax'][0][1], BF16)


def test_fused_deferred_init():
    x, y = _batches(1)[0]

    def run(pkg):
        net = gf_mlp(pkg, 0, in_units=0)
        fs = pkg.gluon.fuse_step(net, _loss(pkg),
                                 _trainer(pkg, net, OPT_PLAIN))
        missing = net[0].weight.shape is None or 0 in net[0].weight.shape
        fs(pkg.nd.array(x), pkg.nd.array(y))
        return missing, tuple(net[0].weight.shape)
    out = _both(run)
    assert out['port'] == out['jax'] == (True, (16, FEAT))


def _bn_net(pkg, seed):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, in_units=FEAT))
        net.add(nn.BatchNorm(in_channels=16))
        net.add(nn.Dense(NCLS, in_units=16))
    net.initialize()
    gf_seed_params(pkg, net, seed)
    return net


def test_fused_batchnorm_aux_updates():
    batches = _batches()

    def run(pkg):
        ni = _bn_net(pkg, 4)
        _imperative(pkg, ni, _trainer(pkg, ni, OPT_PLAIN), batches)
        nf = _bn_net(pkg, 4)
        fs = _fused(pkg, nf, _trainer(pkg, nf, OPT_PLAIN), batches)
        return (_vals(ni), _vals(nf), len(fs._aux_params),
                nf[1].running_mean.data().asnumpy())
    out = _both(run)
    assert out['port'][2] == out['jax'][2] == 2
    assert not np.allclose(out['port'][3], 0.0)
    np.testing.assert_allclose(out['port'][3], out['jax'][3], **STEP)
    _close(out['port'][0], out['port'][1], STEP)
    _close(out['port'][1], out['jax'][1], STEP)


def test_fused_frozen_params_stay_frozen():
    batches = _batches()

    def run(pkg):
        net = gf_mlp(pkg, 6)
        sub = {k: v for k, v in net.collect_params().items()
               if 'dense1' in k}
        tr = pkg.gluon.Trainer(sub, 'sgd', dict(OPT_PLAIN))
        before = _vals(net)
        fs = _fused(pkg, net, tr, batches)
        names = [k.split('_', 1)[1]
                 for k, _ in sorted(net.collect_params().items())]
        return (len(fs._frozen_params), names,
                [not np.array_equal(a, b)
                 for a, b in zip(before, _vals(net))], _vals(net))
    out = _both(run)
    assert out['port'][0] == out['jax'][0] == 2
    assert out['port'][2] == out['jax'][2] == [
        'dense1' in n for n in out['port'][1]]
    _close(out['port'][3], out['jax'][3], PLAIN)


def test_fused_loss_none():
    x = _batches(1)[0][0]

    def run(pkg):
        class SelfLoss(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.fc = pkg.gluon.nn.Dense(1, in_units=FEAT)

            def hybrid_forward(self, F, x):
                return F.square(self.fc(x))

        net = SelfLoss()
        net.initialize()
        gf_seed_params(pkg, net, 7)
        fs = pkg.gluon.fuse_step(net, None, _trainer(pkg, net, OPT_PLAIN))
        l = fs(pkg.nd.array(x))
        return l.shape, l.asnumpy(), _vals(net)
    out = _both(run)
    assert out['port'][0] == out['jax'][0] == (BATCH, 1)
    np.testing.assert_allclose(out['port'][1], out['jax'][1], **PLAIN)
    _close(out['port'][2], out['jax'][2], PLAIN)


# -- the data mesh: two gloo ranks ---------------------------------------------

MESH_INPUTS = None


def _sparse_inputs():
    from _torch_parallel_ranks import SP_BATCH, SP_VOCAB
    rs = np.random.RandomState(0)
    ids = np.stack([rs.randint(0, SP_VOCAB, size=(SP_BATCH,))
                    .astype(np.float32) for _ in range(6)])
    tg = np.stack([rs.randn(SP_BATCH, 4).astype(np.float32)
                   for _ in range(6)])
    return ids, tg


@pytest.fixture(scope='module')
def mesh_run(tmp_path_factory):
    """One spawn of two ranks; the JAX package's striped-table checkpoint
    (two devices, step 3) made first, for the ranks to restore."""
    from mxnet_tpu import elastic as jelastic
    from _torch_parallel_ranks import sp_net, sp_train
    tmp = tmp_path_factory.mktemp('gluon_fused')
    ids, tg = _sparse_inputs()
    X = np.stack([x for x, _ in _batches(3)])
    y = np.stack([y for _, y in _batches(3)])
    with jmx.cpu():
        net = sp_net(jmx, True, ctxs=[jmx.cpu(0), jmx.cpu(1)])
        mgr = jelastic.CheckpointManager(str(tmp / 'jax_ckpt'), async_=False,
                                         every_n_steps=3)
        sp_train(jmx, net, {'learning_rate': 0.1, 'momentum': 0.9}, ids, tg,
                 upto=3, checkpoint=mgr)
        mgr.close()
    rs = np.random.RandomState(2)
    mf = dict(mf_user=rs.randint(0, ranks.MF_VOCABS[0], ranks.MF_BATCH)
              .astype(np.float32),
              mf_item=rs.randint(0, ranks.MF_VOCABS[1], ranks.MF_BATCH)
              .astype(np.float32),
              mf_score=rs.randn(ranks.MF_BATCH).astype(np.float32))
    res = ranks.run(ranks.gluon_fused_suite, 2, tmp, X=X, y=y, ids=ids,
                    tg=tg, **mf)
    return res, tmp, ids, tg, mf


def _got(res, prefix, n):
    return [res['%s__%d' % (prefix, i)] for i in range(n)]


def test_fused_mesh_multi_device(mesh_run):
    """Two ranks equal the one-rank step on the global batch and the JAX
    package's four-device mesh; eager eval and set_data after it."""
    res = mesh_run[0]
    batches = _batches()

    def run(pkg):
        ctxs = [pkg.cpu(i) for i in range(4)] if pkg is jmx else None
        net = gf_mlp(pkg, 3, ctx=ctxs)
        _fused(pkg, net, _trainer(pkg, net, OPT_MOM), batches)
        return _vals(net)
    out = _both(run)
    assert int(res[0]['mlp_z0_dp']) == 2
    for r in res:
        _close(_got(r, 'mlp_z0', 4), out['port'], STEP)
        _close(_got(r, 'mlp_z0', 4), out['jax'], STEP)
    assert tuple(res[0]['eval_shape']) == (BATCH, NCLS)
    assert float(res[0]['set_data_max']) == 0.0


def test_fused_zero_parity_and_sharded_state(mesh_run):
    res = mesh_run[0]
    for r in res:
        _close(_got(r, 'mlp_z1', 4), _got(r, 'mlp_z0', 4), STEP)
        repl, shard = int(r['mlp_z0_state_bytes']), \
            int(r['mlp_z1_state_bytes'])
        assert 0 < shard <= -(-repl // 2) + 2 * 16


def test_fused_sparse_tables_stripe_over_the_mesh(mesh_run):
    """Each rank holds half of the table's rows (ZeRO 0 and 1 alike) and
    the two equal each other, the one-rank step and the JAX package's
    two-device ZeRO-1 run."""
    from _torch_parallel_ranks import SP_VOCAB, sp_net, sp_train
    res, _, ids, tg, _ = mesh_run
    opt = {'learning_rate': 0.1, 'momentum': 0.9}

    def run(pkg):
        ctxs = [pkg.cpu(0), pkg.cpu(1)] if pkg is jmx else None
        net = sp_net(pkg, True, ctxs=ctxs)
        fs, _ = sp_train(pkg, net, opt, ids[:3], tg[:3],
                         **({'zero': 1} if pkg is jmx else {}))
        return [np.asarray(np.asarray(fs._repl[id(p)][0])
                           if pkg is jmx and id(p) in fs._repl
                           else p.list_data()[0].asnumpy(), np.float32)
                for _, p in sorted(net.collect_params().items())]
    out = _both(run)
    for r in res:
        assert int(r['sp_z0_rows']) == int(r['sp_z1_rows']) == SP_VOCAB // 2
        _close(_got(r, 'sp_z1', 3), _got(r, 'sp_z0', 3), STEP)
        _close(_got(r, 'sp_z0', 3), out['port'], STEP)
        _close(_got(r, 'sp_z0', 3), out['jax'], STEP)


def test_checkpoints_cross_packages_and_data_widths(mesh_run):
    """The JAX package's striped checkpoint restores into the port at
    data 1 and 2, and the port's (data 2) into the JAX package at one
    device; each resumed run equals the JAX package's uninterrupted
    one."""
    from mxnet_tpu import elastic as jelastic
    from mxnet_tpu_torch import elastic
    from _torch_parallel_ranks import sp_net, sp_train
    res, tmp, ids, tg, _ = mesh_run
    opt = {'learning_rate': 0.1, 'momentum': 0.9}
    with jmx.cpu():
        net = sp_net(jmx, True, ctxs=[jmx.cpu(0), jmx.cpu(1)])
        fs, _ = sp_train(jmx, net, opt, ids, tg)
        truth = [np.asarray(np.asarray(fs._repl[id(p)][0])
                            if id(p) in fs._repl
                            else p.list_data()[0].asnumpy(), np.float32)
                 for _, p in sorted(net.collect_params().items())]
    # JAX -> port at data 2 (the ranks) and at data 1 (here)
    assert int(res[0]['jax_resume_step']) == 3
    for r in res:
        _close(_got(r, 'from_jax', 3), truth, dict(atol=1e-5, rtol=1e-5))
    with mx.cpu():
        net = sp_net(mx, True, seed=98)
        mgr = elastic.CheckpointManager(str(tmp / 'jax_ckpt'), async_=False)
        sp_train(mx, net, opt, ids, tg, start=3, checkpoint=mgr)
        assert mgr.last_resume.step == 3
        mgr.close()
        _close(gf_pvals(net), truth, dict(atol=1e-5, rtol=1e-5))
    # port (data 2) -> JAX at one device
    assert elastic.list_checkpoints(str(tmp / 'port_ckpt')) == [3]
    with jmx.cpu():
        net = sp_net(jmx, True, seed=97)
        mgr = jelastic.CheckpointManager(str(tmp / 'port_ckpt'),
                                         async_=False)
        sp_train(jmx, net, opt, ids, tg, start=3, checkpoint=mgr)
        assert mgr.last_resume.step == 3
        mgr.close()
        _close(_vals(net), truth, dict(atol=1e-5, rtol=1e-5))


def test_module_sparse_tables_stripe_over_the_mesh(mesh_run):
    """A Module's sparse tables over two ranks: each holds half of each
    table's rows, and one step (momentum 0.9) equals the port's one-rank
    Module and the JAX package's fused Module step on the global batch."""
    res, mf = mesh_run[0], mesh_run[4]
    out = {}
    for name, pkg in PKGS.items():
        with pkg.cpu():
            mod = ranks.mf_module(pkg, [pkg.cpu()])
            ranks.mf_step(pkg, mod, mf)
            out[name] = {k: v.asnumpy()
                         for k, v in mod.get_params()[0].items()}
    for r in res:
        assert list(r['mf_rows']) == [v // 2 for v in
                                      sorted(ranks.MF_VOCABS)]
        for k in out['port']:
            np.testing.assert_allclose(r['mf__' + k], out['port'][k],
                                       err_msg=k, **STEP)
            np.testing.assert_allclose(r['mf__' + k], out['jax'][k],
                                       err_msg=k, **STEP)


def test_several_contexts_in_one_process_raise():
    with mx.cpu():
        net = gf_mlp(mx, 3, ctx=[mx.cpu(0), mx.cpu(1)])
        tr = _trainer(mx, net, OPT_PLAIN)
        with pytest.raises(MXNetError, match='a fused Gluon step over 2 '
                                             'contexts runs as 2 processes'):
            mx.gluon.fuse_step(net, _loss(mx), tr)


# -- bulking, the cache, counters ----------------------------------------------

def test_bulk_matches_single_steps():
    k = 3
    batches = _batches(k)

    def run(pkg):
        n1 = gf_mlp(pkg, 8)
        _fused(pkg, n1, _trainer(pkg, n1, OPT_MOM), batches)
        nb = gf_mlp(pkg, 8)
        tr = _trainer(pkg, nb, OPT_MOM)
        fs = pkg.gluon.fuse_step(nb, _loss(pkg), tr)
        losses = fs.bulk(pkg.nd.array(np.stack([x for x, _ in batches])),
                         pkg.nd.array(np.stack([y for _, y in batches])))
        return (_vals(n1), _vals(nb), losses.shape,
                tr._optimizer.num_update)
    out = _both(run)
    for a, b in zip(out['port'][0], out['port'][1]):
        assert np.array_equal(a, b)
    _close(out['port'][1], out['jax'][1], STEP)
    assert out['port'][2:] == out['jax'][2:] == ((k, BATCH), k)


def test_trainer_recreation_zero_compiles():
    batches = _batches(2)
    with mx.cpu():
        net = gf_mlp(mx, 1)
        _fused(mx, net, _trainer(mx, net, OPT_MOM), batches)
        st0 = exec_cache.stats()
        net2 = gf_mlp(mx, 77)
        _fused(mx, net2, _trainer(mx, net2, OPT_MOM), batches)
        st1 = exec_cache.stats()
    assert st1['misses'] == st0['misses']
    assert st1['hits'] >= st0['hits'] + 1
    assert st1['total_compile_s'] == st0['total_compile_s']


def test_fused_counters_and_summary(tmp_path):
    batches = _batches(2)
    profiler.clear()
    with mx.cpu():
        net = gf_mlp(mx, 1)
        fs = _fused(mx, net, _trainer(mx, net, OPT_MOM), batches)
        fs.bulk(mx.nd.array(np.stack([x for x, _ in batches])),
                mx.nd.array(np.stack([y for _, y in batches])))
    st = profiler.gluon_fused_stats()
    assert st['gluon_fused_steps'] == 4
    assert st['gluon_fused_dispatches'] == 3
    assert st['gluon_fused_steps_per_dispatch'] == pytest.approx(4 / 3)
    assert 'gluon_fused_steps=4' in profiler.summary(print_out=False)
    fname = str(tmp_path / 'prof.json')
    profiler.profiler_set_config(filename=fname)
    profiler.dump_profile()
    import json
    with open(fname) as f:
        events = json.load(f)['traceEvents']
    meta = [e for e in events if e.get('name') == 'gluon_fused']
    assert meta and meta[0]['args']['gluon_fused_steps'] == 4
    profiler.clear()


def test_step_ahead_loss_bit_parity_and_counters(monkeypatch):
    monkeypatch.delenv('MXNET_TPU_TRAIN_STEP_AHEAD', raising=False)
    for fn in (jfused.resolve_step_ahead, tfused.resolve_step_ahead):
        assert fn() == 1 and fn(3) == 3
    for off in ('0', 'off', 'none', 'false'):
        monkeypatch.setenv('MXNET_TPU_TRAIN_STEP_AHEAD', off)
        assert tfused.resolve_step_ahead() == 0
    monkeypatch.setenv('MXNET_TPU_TRAIN_STEP_AHEAD', '2')
    assert tfused.resolve_step_ahead() == 2
    monkeypatch.delenv('MXNET_TPU_TRAIN_STEP_AHEAD')
    batches = _batches(k=4)
    curves, params = {}, {}
    with mx.cpu():
        for ahead in (0, 1):
            profiler.clear()
            net = gf_mlp(mx, 3)
            fs = mx.gluon.fuse_step(net, _loss(mx),
                                    _trainer(mx, net, OPT_MOM),
                                    step_ahead=ahead)
            curves[ahead] = [fs(mx.nd.array(x), mx.nd.array(y))
                             .asnumpy().copy() for x, y in batches]
            params[ahead] = _vals(net)
            ov = profiler.overlap_stats()
            assert ov['overlap_train_steps'] == len(batches)
            assert ov['overlap_steps_ahead'] == ahead
            if ahead == 0:
                assert fs._inflight == deque()
    for a, b in zip(curves[0], curves[1]):
        assert np.array_equal(a, b)
    for a, b in zip(params[0], params[1]):
        assert np.array_equal(a, b)
    profiler.clear()


def test_step_fused_entry_and_unsupported_optimizer():
    x, y = _batches(1)[0]

    def run(pkg):
        net = gf_mlp(pkg, 1)
        tr = _trainer(pkg, net, OPT_PLAIN)
        with pytest.raises(ValueError, match='no fused step'):
            tr.step_fused(BATCH, pkg.nd.array(x), pkg.nd.array(y))
        pkg.gluon.fuse_step(net, _loss(pkg), tr)
        l = tr.step_fused(BATCH, pkg.nd.array(x), pkg.nd.array(y))
        net2 = gf_mlp(pkg, 1)
        tr2 = pkg.gluon.Trainer(net2.collect_params(), 'adam')
        with pytest.raises(ValueError, match='no fused whole-model update'):
            pkg.gluon.fuse_step(net2, _loss(pkg), tr2)
        return l.asnumpy(), _vals(net)
    out = _both(run)
    np.testing.assert_allclose(out['port'][0], out['jax'][0], **PLAIN)
    _close(out['port'][1], out['jax'][1], PLAIN)


# -- checkpoints and mode switches ---------------------------------------------

def _save_load(pkg, save, load):
    fd, name = tempfile.mkstemp()
    os.close(fd)
    try:
        save(name)
        load(name)
    finally:
        os.remove(name)


def test_checkpoint_roundtrip_fused():
    batches = _batches(5)
    with mx.cpu():
        truth_net = gf_mlp(mx, 3)
        _fused(mx, truth_net, _trainer(mx, truth_net, OPT_MOM), batches)
        n1 = gf_mlp(mx, 3)
        t1 = _trainer(mx, n1, OPT_MOM)
        _fused(mx, n1, t1, batches[:3])
        n2 = gf_mlp(mx, 99)
        for (_, a), (_, b) in zip(sorted(n1.collect_params().items()),
                                  sorted(n2.collect_params().items())):
            b.set_data(a.data())
        t2 = _trainer(mx, n2, OPT_MOM)
        _save_load(mx, t1.save_states, t2.load_states)
        _fused(mx, n2, t2, batches[3:])
        _close(_vals(truth_net), _vals(n2), dict(atol=1e-7, rtol=0))


def test_checkpoint_save_before_first_step():
    batches = _batches()
    with mx.cpu():
        net = gf_mlp(mx, 3)
        tr = _trainer(mx, net, OPT_MOM)
        mx.gluon.fuse_step(net, _loss(mx), tr)
        net2 = gf_mlp(mx, 3)
        tr2 = _trainer(mx, net2, OPT_MOM)
        _save_load(mx, tr.save_states, tr2.load_states)
        _fused(mx, net2, tr2, batches)
        _fused(mx, net, tr, batches)
        _close(_vals(net), _vals(net2), dict(atol=1e-7, rtol=0))


def test_checkpoint_cross_mode():
    """A fused run's states restore into the per-key path, and a port
    file into the JAX package's trainer (the one format both take)."""
    batches = _batches(5)
    with mx.cpu():
        truth_net = gf_mlp(mx, 3)
        _fused(mx, truth_net, _trainer(mx, truth_net, OPT_MOM), batches)
        n1 = gf_mlp(mx, 3)
        t1 = _trainer(mx, n1, OPT_MOM)
        _fused(mx, n1, t1, batches[:3])
        mid = _vals(n1)
        fd, fname = tempfile.mkstemp()
        os.close(fd)
        t1.save_states(fname)
        n2 = gf_mlp(mx, 98)
        for (_, p), v in zip(sorted(n2.collect_params().items()), mid):
            p.set_data(mx.nd.array(v))
        t2 = _trainer(mx, n2, OPT_MOM)
        t2.load_states(fname)
        _imperative(mx, n2, t2, batches[3:])
        _close(_vals(truth_net), _vals(n2), STEP)
    with jmx.cpu():
        nj = gf_mlp(jmx, 97)
        for (_, p), v in zip(sorted(nj.collect_params().items()), mid):
            p.set_data(jmx.nd.array(v))
        tj = _trainer(jmx, nj, OPT_MOM)
        tj.load_states(fname)
        _fused(jmx, nj, tj, batches[3:])
        _close(_vals(truth_net), _vals(nj), STEP)
    os.remove(fname)


def test_checkpoint_unfused_to_fused():
    batches = _batches(5)
    with mx.cpu():
        truth_net = gf_mlp(mx, 3)
        _imperative(mx, truth_net, _trainer(mx, truth_net, OPT_PLAIN),
                    batches)
        n1 = gf_mlp(mx, 3)
        t1 = _trainer(mx, n1, OPT_PLAIN)
        _imperative(mx, n1, t1, batches[:3])
        n2 = gf_mlp(mx, 97)
        for (_, p), v in zip(sorted(n2.collect_params().items()),
                             _vals(n1)):
            p.set_data(mx.nd.array(v))
        t2 = _trainer(mx, n2, OPT_PLAIN)
        _save_load(mx, t1.save_states, t2.load_states)
        _fused(mx, n2, t2, batches[3:])
        _close(_vals(truth_net), _vals(n2), STEP)


MP = {'learning_rate': 0.1, 'momentum': 0.9, 'multi_precision': True}


def test_checkpoint_unfused_mp_to_fused():
    batches = _batches(4)
    with mx.cpu():
        truth_net = gf_mlp(mx, 5)
        truth_net.cast('bfloat16')
        _imperative(mx, truth_net, _trainer(mx, truth_net, MP), batches,
                    'bfloat16')
        n1 = gf_mlp(mx, 5)
        n1.cast('bfloat16')
        t1 = _trainer(mx, n1, MP)
        _imperative(mx, n1, t1, batches[:2], 'bfloat16')
        n2 = gf_mlp(mx, 96)
        n2.cast('bfloat16')
        for (_, a), (_, b) in zip(sorted(n1.collect_params().items()),
                                  sorted(n2.collect_params().items())):
            b.set_data(a.data())
        t2 = _trainer(mx, n2, MP)
        _save_load(mx, t1.save_states, t2.load_states)
        _fused(mx, n2, t2, batches[2:], 'bfloat16')
        assert sum(m is not None
                   for m in t2._fused_updater.masters.values()) == 4
        _close(_vals(truth_net), _vals(n2), dict(atol=2e-2, rtol=5e-2))


def test_mode_switch_shares_optimizer_state():
    batches = _batches(4)
    with mx.cpu():
        truth_net = gf_mlp(mx, 3)
        _imperative(mx, truth_net, _trainer(mx, truth_net, OPT_MOM),
                    batches)
        truth = _vals(truth_net)
        n1 = gf_mlp(mx, 3)
        t1 = _trainer(mx, n1, OPT_MOM)
        _imperative(mx, n1, t1, batches[:2])
        _fused(mx, n1, t1, batches[2:])
        _close(truth, _vals(n1), STEP)
        n2 = gf_mlp(mx, 3)
        t2 = _trainer(mx, n2, OPT_MOM)
        _fused(mx, n2, t2, batches[:2])
        _imperative(mx, n2, t2, batches[2:])
        _close(truth, _vals(n2), STEP)


def test_mode_switch_mp_keeps_masters_and_dtype():
    batches = _batches(4)
    with mx.cpu():
        truth_net = gf_mlp(mx, 5)
        truth_net.cast('bfloat16')
        _imperative(mx, truth_net, _trainer(mx, truth_net, MP), batches,
                    'bfloat16')
        net = gf_mlp(mx, 5)
        net.cast('bfloat16')
        tr = _trainer(mx, net, MP)
        _fused(mx, net, tr, batches[:2], 'bfloat16')
        _imperative(mx, net, tr, batches[2:], 'bfloat16')
        for _, p in sorted(net.collect_params().items()):
            assert p.data().dtype == np.dtype('bfloat16') or \
                str(p.data()._data.dtype) == 'torch.bfloat16', p.name
        _close(_vals(truth_net), _vals(net), dict(atol=2e-2, rtol=5e-2))


def test_trainer_step_batched_multi_device_reduce():
    """The unfused Trainer.step over two contexts in one process (the
    stacked reduction) equals one context's step, as in the JAX
    package."""
    batches = _batches()
    with mx.cpu():
        ctx2 = [mx.cpu(0), mx.cpu(1)]
        nm = gf_mlp(mx, 3, ctx=ctx2)
        tm = _trainer(mx, nm, OPT_MOM)
        ns = gf_mlp(mx, 3)
        ts = _trainer(mx, ns, OPT_MOM)
        loss = _loss(mx)
        for x, y in batches:
            xs = mx.gluon.utils.split_and_load(x, ctx2)
            ys = mx.gluon.utils.split_and_load(y, ctx2)
            with mx.autograd.record():
                losses = [loss(nm(xi), yi) for xi, yi in zip(xs, ys)]
            mx.autograd.backward(losses)
            tm.step(BATCH)
            with mx.autograd.record():
                l = loss(ns(mx.nd.array(x)), mx.nd.array(y))
            l.backward()
            ts.step(BATCH)
        _close(_vals(nm), _vals(ns), STEP)
        p = nm[0].weight
        assert np.array_equal(p.data(ctx2[0]).asnumpy(),
                              p.data(ctx2[1]).asnumpy())


# -- the epoch-fusion arms (tests/test_overlap_fusion.py's fused cases) --------

def test_metric_fold_ema_and_schedules_match_the_jax_step():
    """A device-folded Accuracy, the weight EMA and a FactorScheduler
    through bulk and single steps: the metric, the EMA and the weights
    equal the JAX package's."""
    batches = _batches(4)

    def run(pkg):
        net = gf_mlp(pkg, 4)
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                               dict(OPT_MOM, lr_scheduler=sched))
        acc = pkg.metric.Accuracy()
        fs = pkg.gluon.fuse_step(net, _loss(pkg), tr, metric=acc,
                                 ema_decay=0.9)
        fs.bulk(pkg.nd.array(np.stack([x for x, _ in batches[:3]])),
                pkg.nd.array(np.stack([y for _, y in batches[:3]])))
        fs(pkg.nd.array(batches[3][0]), pkg.nd.array(batches[3][1]))
        ema = fs.ema()
        return (acc.get()[1], [np.array(ema[p.name].asnumpy(), np.float32)
                               for p in tr._params], _vals(net))
    out = _both(run)
    assert out['port'][0] == pytest.approx(out['jax'][0])
    _close(out['port'][1], out['jax'][1], STEP)
    _close(out['port'][2], out['jax'][2], STEP)


@pytest.mark.parametrize('interleave', [True, False])
def test_reduce_schedules_give_the_same_bits(interleave):
    """Without a mesh both reduce schedules are the one-device step, bit
    for bit, as the JAX package asks of them."""
    batches = _batches()
    with mx.cpu():
        n0 = gf_mlp(mx, 3)
        _fused(mx, n0, _trainer(mx, n0, OPT_MOM), batches)
        n1 = gf_mlp(mx, 3)
        fs = _fused(mx, n1, _trainer(mx, n1, OPT_MOM), batches,
                    interleave=interleave)
        assert fs._interleave is interleave
        for a, b in zip(_vals(n0), _vals(n1)):
            assert np.array_equal(a, b)


def test_pipeline_and_metric_refusals():
    with mx.cpu():
        net = gf_mlp(mx, 1)
        tr = _trainer(mx, net, OPT_PLAIN)
        with pytest.raises(ValueError, match='do not divide'):
            mx.gluon.fuse_step(net, _loss(mx), tr, pipeline=(2, 2))
        with pytest.raises(ValueError, match='loss=None'):
            mx.gluon.fuse_step(net, None, tr, metric=mx.metric.Accuracy())
        with pytest.raises(ValueError, match='ema_decay'):
            mx.gluon.fuse_step(net, _loss(mx), tr, ema_decay=1.5)


# -- the conv -> BatchNorm pair route ------------------------------------------

V1 = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=4)


def _v1_net(pkg, dtype='float32'):
    vision = pkg.gluon.model_zoo.vision
    net = vision.ResNetV1(vision.BottleneckV1, V1['layers'], V1['channels'],
                          classes=V1['classes'])
    net.initialize()
    net(pkg.nd.zeros((1, 3, 32, 32)))
    rs = np.random.RandomState(0)
    for _, p in sorted(net.collect_params().items()):
        if 'running' not in p.name:
            p.set_data(pkg.nd.array(
                (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.4))
    if dtype != 'float32':
        net.cast(dtype)
    return net


def _v1_run(pkg, dtype='float32', route=None):
    rs = np.random.RandomState(1)
    x = rs.rand(16, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 4, 16).astype(np.float32)
    net = _v1_net(pkg, dtype)
    fs = pkg.gluon.fuse_step(net, _loss(pkg), _trainer(
        pkg, net, {'learning_rate': 0.1, 'momentum': 0.9}))
    calls = None
    if route is not None:
        from mxnet_tpu_torch import cuda_conv
        saved = tfused._PairRoute.dtypes
        tfused._PairRoute.dtypes = route
        calls = cuda_conv.CONV_BN_STATS_PLAIN_CALLS
    try:
        xs = pkg.nd.array(x).astype(dtype)
        loss = fs(xs, pkg.nd.array(y)).asnumpy()
    finally:
        if route is not None:
            tfused._PairRoute.dtypes = saved
            calls = cuda_conv.CONV_BN_STATS_PLAIN_CALLS - calls
    vals = {k[len(net.prefix):]: np.array(v.list_data()[0].asnumpy(),
                                          np.float32)
            for k, v in net.collect_params().items()}
    return loss, vals, calls, getattr(fs, 'routed_pairs', None)


def test_pair_route_float32_v1_resnet_matches_the_jax_step():
    """A float32 v1 ResNet's fused step with its 9 conv -> BatchNorm
    pairs on the kernel's plain version (the route opened to float32)
    equals the JAX package's FusedStep, moving statistics included, and
    the port's unrouted step; the pairs are counted."""
    with jmx.cpu():
        jl, jv, _, _ = _v1_run(jmx)
    with mx.cpu():
        tl, tv, calls, pairs = _v1_run(
            mx, route=(torch.bfloat16, torch.float32))
        ul, uv, calls0, pairs0 = _v1_run(mx, route=(torch.bfloat16,))
    assert (pairs, calls) == (9, 9) and (pairs0, calls0) == (0, 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for k in jv:
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tv[k], jv[k], err_msg=k, **tol)
        np.testing.assert_allclose(uv[k], jv[k], err_msg=k, **tol)


def test_pair_route_bf16_routes_every_pair_and_stays_near_unrouted():
    """In bf16 the route takes the 9 pairs on its own; the loss stays
    within bf16 rounding of the unrouted step's and the JAX package's."""
    with jmx.cpu():
        jl, _, _, _ = _v1_run(jmx, 'bfloat16')
    with mx.cpu():
        tl, _, calls, pairs = _v1_run(mx, 'bfloat16',
                                      route=(torch.bfloat16,))
        ul, _, _, upairs = _v1_run(mx, 'bfloat16', route=())
    assert (pairs, calls, upairs) == (9, 9, 0)
    np.testing.assert_allclose(tl.astype(np.float32),
                               ul.astype(np.float32), rtol=0.1, atol=0.1)
    np.testing.assert_allclose(tl.astype(np.float32),
                               np.asarray(jl, np.float32), rtol=0.1,
                               atol=0.1)
