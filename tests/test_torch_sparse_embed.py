"""The sparse embedding tier on the port (mxnet_tpu_torch.parallel.
embedding and the fused paths) held against the JAX package's, on the
CPU: the counterparts of tests/test_sparse_embed.py's 20 tests, the
Module path's sparse plan, the hot-row cache, and the gates of
chip_smoke.py's phases 30-31 (the store's COO path:
tests/test_torch_kvstore.py; the data mesh: test_torch_gluon_fused.py).

Parity contract, as the JAX tests state it: with plain SGD the rows-only
update equals the dense step bit for bit on the touched rows; with
momentum and wd the semantics are lazy (an untouched row keeps its weight
and momentum), so momentum parity is asserted on full-coverage id
streams, and elsewhere touched rows against the JAX package's and the
untouched ones for no change. The same numpy seeds go through both
packages; tolerances are the JAX tests' (atol 1e-6 between programs,
1e-5 for the hot-row engine) or tighter.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.parallel import embedding as jemb

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import embedding as temb

from _torch_parallel_ranks import SP_BATCH as BATCH, SP_DIM as DIM, \
    SP_VOCAB as VOCAB, sp_net, sp_train

PKGS = {'jax': jmx, 'port': mx}
STEP = dict(atol=1e-6, rtol=0)


def _batches(n=4, lo=0, hi=VOCAB, batch=BATCH, seed=0):
    rs = np.random.RandomState(seed)
    return ([rs.randint(lo, hi, size=(batch,)).astype(np.float32)
             for _ in range(n)],
            [rs.randn(batch, 4).astype(np.float32) for _ in range(n)])


def _full_coverage(n=4, seed=0):
    rs = np.random.RandomState(seed)
    ids = np.arange(VOCAB, dtype=np.float32)
    return [ids] * n, [rs.randn(VOCAB, 4).astype(np.float32)
                       for _ in range(n)]


def _vals(pkg, net, fused=None):
    out = []
    for _, p in sorted(net.collect_params().items()):
        if pkg is jmx and fused is not None and id(p) in fused._repl:
            v = np.asarray(fused._repl[id(p)][0])
        else:
            v = p.list_data()[0].asnumpy()
        out.append(np.array(v, np.float32))
    return out


def _run(pkg, sparse, opt, ids, tg, seed=3, **kw):
    net = sp_net(pkg, sparse, seed=seed)
    fs, tr = sp_train(pkg, net, opt, ids, tg, **kw)
    return _vals(pkg, net, fs), fs, tr


def _both(fn):
    out = {}
    for name, pkg in PKGS.items():
        with pkg.cpu():
            out[name] = fn(pkg)
    return out


# -- the Gluon fused path ------------------------------------------------------

def test_gluon_parity_plain_sgd_bitwise():
    ids, tg = _batches(4)
    opt = {'learning_rate': 0.1, 'wd': 0.0}
    out = _both(lambda pkg: (_run(pkg, False, opt, ids, tg)[0],
                             _run(pkg, True, opt, ids, tg)[0]))
    for a, b in zip(*out['port']):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out['port'][1], out['jax'][1]):
        np.testing.assert_allclose(a, b, **STEP)


def test_gluon_parity_momentum_full_coverage():
    ids, tg = _full_coverage(4)
    opt = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
    out = _both(lambda pkg: (_run(pkg, False, opt, ids, tg)[0],
                             _run(pkg, True, opt, ids, tg)[0]))
    for a, b in zip(*out['port']):
        np.testing.assert_allclose(a, b, **STEP)
    for a, b in zip(out['port'][1], out['jax'][1]):
        np.testing.assert_allclose(a, b, **STEP)


def test_gluon_lazy_momentum_untouched_rows_frozen():
    ids, tg = _batches(3, lo=0, hi=8)
    opt = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}

    def run(pkg):
        w0 = _vals(pkg, sp_net(pkg, True))[0]
        return w0, _run(pkg, True, opt, ids, tg)[0][0]
    out = _both(run)
    w0, w1 = out['port']
    np.testing.assert_array_equal(w0[8:], w1[8:])
    assert np.abs(w1[:8] - w0[:8]).max() > 0
    np.testing.assert_allclose(w1, out['jax'][1], **STEP)


def test_gluon_bulk_matches_single_sparse():
    ids, tg = _batches(3)
    with mx.cpu():
        single, _, _ = _run(mx, True, {'learning_rate': 0.1}, ids, tg,
                            seed=8)
        net = sp_net(mx, True, seed=8)
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1})
        fs = mx.gluon.fuse_step(net, mx.gluon.loss.L2Loss(), tr)
        losses = fs.bulk(mx.nd.array(np.stack(ids)),
                         mx.nd.array(np.stack(tg)))
        assert losses.shape[0] == 3
        for a, b in zip(single, _vals(mx, net)):
            np.testing.assert_array_equal(a, b)


def test_gluon_zero1_sparse_parity():
    """zero=1 with a sparse table (its momentum beside the buckets) on
    one device equals zero=0, as on the JAX package's 2-device mesh
    (the port's two ranks: test_torch_gluon_fused.py)."""
    ids, tg = _batches(3)
    opt = {'learning_rate': 0.1, 'momentum': 0.9}
    with mx.cpu():
        a, _, _ = _run(mx, True, opt, ids, tg, zero=0)
        b, _, tr = _run(mx, True, opt, ids, tg, zero=1)
        assert tr._fused_updater.zero == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_table_stripes_one_over_dp():
    """Rank r of a data axis of N holds rows [r*s, (r+1)*s), s =
    ceil(vocab / N), and the per-rank bytes the plan reports are that
    stripe (the ranks themselves: test_torch_gluon_fused.py)."""
    for n in (2, 3, 4):
        s = -(-VOCAB // n)
        spans = [temb.stripe_range(VOCAB, n, r) for r in range(n)]
        assert spans[0] == (0, s) and spans[-1][1] == VOCAB
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        plan = temb.SparseEmbedPlan([{'pos': 0, 'vocab': VOCAB,
                                      'dim': DIM,
                                      'dtype': np.dtype(np.float32)}])
        assert plan.per_device_table_bytes(n) == s * DIM * 4
        jplan = jemb.SparseEmbedPlan([{'pos': 0, 'vocab': VOCAB,
                                       'dim': DIM,
                                       'dtype': np.dtype(np.float32)}])
        assert jplan.per_device_table_bytes(n) == \
            plan.per_device_table_bytes(n)


def test_ladder_zero_steady_state_compiles():
    few = _batches(3, lo=0, hi=4, seed=1)
    many = _batches(3, lo=0, hi=VOCAB, seed=2)
    ids, tg = few[0] + many[0], few[1] + many[1]
    with mx.cpu():
        net = sp_net(mx, True)
        fs, _ = sp_train(mx, net, {'learning_rate': 0.1}, ids, tg)
        st0 = exec_cache.stats()
        for x, y in zip(few[0] + many[0] + few[0], few[1] + many[1] +
                        few[1]):
            fs(mx.nd.array(x), mx.nd.array(y))
        st1 = exec_cache.stats()
        assert st1['misses'] == st0['misses']
        assert st1['total_compile_s'] == st0['total_compile_s']
        net2 = sp_net(mx, True, seed=99)
        sp_train(mx, net2, {'learning_rate': 0.1}, ids, tg)
        st2 = exec_cache.stats()
        assert st2['misses'] == st1['misses']
        assert st2['total_compile_s'] == st1['total_compile_s']


def test_ladder_and_rungs_match_the_jax_package():
    for cap in (1, 8, 9, 100, 4096):
        assert temb.unique_ladder(cap) == jemb.unique_ladder(cap)
        for u in (1, 5, 8, 33, cap):
            ladder = temb.unique_ladder(cap)
            assert temb.pick_rung(ladder, u) == jemb.pick_rung(ladder, u)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 50, size=40)
    tu, tinv = temb.dedup_ids([torch.as_tensor(ids)], 64, 50)
    ju, jinv = jemb.dedup_ids([jnp.asarray(ids)], 64, 50)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv[0].numpy(), np.asarray(jinv[0]))


def test_embed_counters_flow():
    ids, tg = _batches(3)

    def run(pkg):
        # no trace facts published by an earlier step: the first step
        # runs at the table's capacity in both packages
        pkg.exec_cache.clear()
        pkg.profiler.clear()
        _run(pkg, True, {'learning_rate': 0.1}, ids, tg)
        st = pkg.profiler.embed_stats()
        pkg.profiler.clear()
        return st
    out = _both(run)
    st = out['port']
    assert st['embed_steps'] >= 3 and st['embed_dispatches'] >= 3
    assert 0 < st['embed_touched_bytes'] < st['embed_dense_equiv_bytes']
    for k in ('embed_steps', 'embed_lookups', 'embed_unique_rows',
              'embed_touched_bytes', 'embed_dense_equiv_bytes',
              'embed_max_rung'):
        assert st[k] == out['jax'][k], k
    with mx.cpu():
        _run(mx, True, {'learning_rate': 0.1}, ids, tg)
    assert 'embed' in profiler.summary(print_out=False)
    profiler.clear()


# -- the Module path -------------------------------------------------------------

def _module(pkg, sparse, vocab=50, dim=4, seed=7, opt=None):
    s = pkg.sym
    emb = s.Embedding(s.Variable('data'), name='emb', input_dim=vocab,
                      output_dim=dim, sparse_grad=sparse)
    net = s.SoftmaxOutput(s.FullyConnected(s.Flatten(emb), name='fc',
                                           num_hidden=3), name='softmax')
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc('data', (8, 6))],
             label_shapes=[pkg.io.DataDesc('softmax_label', (8,))])
    rs = np.random.RandomState(seed)
    mod.init_params(initializer=None, arg_params={
        'emb_weight': pkg.nd.array(rs.randn(vocab, dim).astype(np.float32)),
        'fc_weight': pkg.nd.array((rs.randn(3, 6 * dim) * .1)
                                  .astype(np.float32)),
        'fc_bias': pkg.nd.zeros((3,))})
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(
        opt or {'learning_rate': 0.1}))
    return mod


def _module_batches(pkg, n=4, vocab=50, seed=0):
    rs = np.random.RandomState(seed)
    return [pkg.io.DataBatch(
        data=[pkg.nd.array(rs.randint(0, vocab, size=(8, 6))
                           .astype(np.float32))],
        label=[pkg.nd.array((rs.rand(8) * 3).astype(np.float32))])
        for _ in range(n)]


def _module_run(pkg, sparse, opt=None):
    mod = _module(pkg, sparse, opt=opt)
    for b in _module_batches(pkg):
        mod.forward_backward(b)
        mod.update()
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def test_module_parity_plain_sgd_bitwise():
    out = _both(lambda pkg: (_module_run(pkg, False),
                             _module_run(pkg, True)))
    pa, pb = out['port']
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        np.testing.assert_allclose(pb[k], out['jax'][1][k], err_msg=k,
                                   **STEP)


def test_module_rows_only_with_momentum_matches_the_jax_package():
    """Momentum and wd through the Module path's rows-only update (lazy)
    equal the JAX package's fused Module step, and the plan's static
    rung is its min(vocab, id slots)."""
    opt = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
    out = _both(lambda pkg: _module_run(pkg, True, opt))
    for k in out['port']:
        np.testing.assert_allclose(out['port'][k], out['jax'][k],
                                   err_msg=k, **STEP)
    with mx.cpu():
        ex = _module(mx, True)._exec_group.executor
    ents = ex._sparse_embed_entries()
    assert [(e['weight'], e['rung']) for e in ents] == [('emb_weight', 48)]
    assert ex.sparse_diff_positions() == (0,)


@pytest.mark.parametrize('derived', [True, False])
def test_module_refuses_graph_derived_ids(derived):
    """Computed ids, and ids that are a differentiable argument, are
    refused when the updater is planned (init_optimizer)."""
    s = mx.sym
    data = s.Variable('data')
    ids = data * 1.0 if derived else data
    emb = s.Embedding(ids, name='emb', input_dim=50, output_dim=4,
                      sparse_grad=True)
    net = s.SoftmaxOutput(s.FullyConnected(s.Flatten(emb), name='fc',
                                           num_hidden=3), name='softmax')
    with mx.cpu():
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[mx.io.DataDesc('data', (8, 6))],
                 label_shapes=[mx.io.DataDesc('softmax_label', (8,))],
                 inputs_need_grad=not derived)
        mod.init_params(initializer=mx.init.Xavier())
        with pytest.raises(MXNetError,
                           match='graph-derived' if derived else
                           'differentiable arg'):
            mod.init_optimizer(optimizer='sgd',
                               optimizer_params={'learning_rate': 0.1})


# -- elastic checkpoints across data widths --------------------------------------

def test_checkpoint_restores_across_dp_width_change(tmp_path):
    """A table checkpointed whole at step 3 restores into a fresh net
    and finishes as the uninterrupted run (the data-width and
    cross-package cases: test_torch_gluon_fused.py's ranks)."""
    from mxnet_tpu_torch import elastic
    ids, tg = _batches(6)
    opt = {'learning_rate': 0.1, 'momentum': 0.9}
    with mx.cpu():
        truth, _, _ = _run(mx, True, opt, ids, tg)
        net = sp_net(mx, True)
        mgr = elastic.CheckpointManager(str(tmp_path), async_=False,
                                        every_n_steps=3)
        sp_train(mx, net, opt, ids, tg, upto=3, checkpoint=mgr)
        mgr.close()
        assert elastic.list_checkpoints(str(tmp_path)) == [3]
        net = sp_net(mx, True, seed=99)
        mgr = elastic.CheckpointManager(str(tmp_path), async_=False)
        sp_train(mx, net, opt, ids, tg, start=3, checkpoint=mgr)
        assert mgr.last_resume.step == 3
        mgr.close()
        for a, b in zip(truth, _vals(mx, net)):
            np.testing.assert_allclose(a, b, atol=1e-5)


# -- the hot-row serving cache ---------------------------------------------------

def _pred_module(pkg, vocab=200, dim=8, seed=11):
    s = pkg.sym
    emb = s.Embedding(s.Variable('data'), name='emb', input_dim=vocab,
                      output_dim=dim)
    net = s.FullyConnected(s.Flatten(emb), name='fc', num_hidden=3)
    mod = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc('data', (8, 4))],
             for_training=False)
    rs = np.random.RandomState(seed)
    mod.init_params(initializer=None, arg_params={
        'emb_weight': pkg.nd.array(rs.randn(vocab, dim).astype(np.float32)),
        'fc_weight': pkg.nd.array(rs.randn(3, 4 * dim).astype(np.float32)),
        'fc_bias': pkg.nd.zeros((3,))})
    return mod


def _engine(pkg, **kw):
    return pkg.serving.InferenceEngine(_pred_module(pkg), max_batch=8,
                                       quantize=False, **kw)


def test_hot_row_cache_parity_counters_eviction():
    vocab, dim, cap = 200, 8, 48
    rng = np.random.RandomState(5)
    bs = [rng.randint(0, vocab, size=(8, 4)).astype(np.float32)
          for _ in range(6)]
    bs.append(bs[0].copy())

    def run(pkg):
        ref = _engine(pkg)
        want = [np.asarray(ref.predict(b)) for b in bs]
        ref.close()
        eng = _engine(pkg, hot_rows=cap)
        try:
            got = [np.asarray(eng.predict(b)) for b in bs]
            st = eng.stats()['hot_rows']['emb_weight']
            shape = tuple(eng._hotrows['emb_weight'].arg._data.shape)
        finally:
            eng.close()
        return want, got, st, shape
    out = _both(run)
    want, got, st, shape = out['port']
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    for g, j in zip(got, out['jax'][1]):
        np.testing.assert_allclose(g, j, atol=1e-5)
    assert st['capacity'] == cap and shape == (cap, dim)
    assert st['hits'] > 0 and st['misses'] > 0 and st['evictions'] > 0
    assert st['resident'] <= cap
    assert st['resident_bytes'] == cap * dim * 4
    assert st['table_bytes'] == vocab * dim * 4
    for k in ('hits', 'misses', 'evictions', 'resident'):
        assert st[k] == out['jax'][2][k], k


def test_hot_row_prefetch_hits_and_budget(monkeypatch):
    cap = 48
    rng = np.random.RandomState(6)
    b1 = rng.randint(0, 100, size=(8, 4)).astype(np.float32)
    b2 = rng.randint(100, 120, size=(8, 4)).astype(np.float32)
    with mx.cpu():
        ref = _engine(mx)
        want = np.asarray(ref.predict(b2))
        ref.close()
        profiler.clear()
        eng = _engine(mx, hot_rows=cap)
        try:
            assert eng._hotrow_peek == 8
            eng.predict(b1)
            st0 = eng.stats()['hot_rows']['emb_weight']
            eng._hotrow_prefetch([(b2,)])
            st1 = eng.stats()['hot_rows']['emb_weight']
            assert st1['prefetch_rows'] > st0['prefetch_rows']
            got = np.asarray(eng.predict(b2))
            st2 = eng.stats()['hot_rows']['emb_weight']
            assert st2['prefetch_hits'] > 0
            assert st2['misses'] == st1['misses']
            assert st2['resident'] <= cap
            np.testing.assert_array_equal(want, got)
            es = profiler.embed_stats()
            assert es['hotrow_prefetched'] >= st1['prefetch_rows']
            assert es['hotrow_prefetch_hits'] >= st2['prefetch_hits']
        finally:
            eng.close()
            profiler.clear()
        monkeypatch.setenv('MXNET_TPU_SERVE_HOTROW_PREFETCH', 'off')
        eng = _engine(mx, hot_rows=cap)
        try:
            assert eng._hotrow_peek == 0
        finally:
            eng.close()


def test_hot_row_refusals():
    with mx.cpu():
        with pytest.raises(MXNetError, match='worst'):
            _engine(mx, hot_rows=8)
        with pytest.raises(MXNetError, match='nope'):
            _engine(mx, hot_rows={'nope': 64})


# -- the op contracts ------------------------------------------------------------

def test_embedding_clips_out_of_range_ids():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([-3, 0, 3, 9], dtype=np.float32)
    out = _both(lambda pkg: pkg.nd.Embedding(
        pkg.nd.array(ids), pkg.nd.array(w), input_dim=4,
        output_dim=3).asnumpy())
    np.testing.assert_array_equal(out['port'], out['jax'])
    np.testing.assert_array_equal(out['port'][0], w[0])
    np.testing.assert_array_equal(out['port'][3], w[3])


def test_take_unknown_mode_raises():
    with mx.cpu():
        a = mx.nd.array(np.arange(6, dtype=np.float32))
        idx = mx.nd.array(np.array([0, 5], dtype=np.float32))
        assert mx.nd.take(a, idx, mode='clip').shape == (2,)
        with pytest.raises(MXNetError, match='mode'):
            mx.nd.take(a, idx, mode='raise')


def test_backward_gather_nd_accumulates_duplicates():
    data = np.array([1.0, 2.0, 4.0], dtype=np.float32)
    idx = np.array([[1, 1, 2]], dtype=np.float32)
    with mx.cpu():
        acc = mx.nd._backward_gather_nd(mx.nd.array(data), mx.nd.array(idx),
                                        shape=(4,)).asnumpy()
        alias = mx.nd.scatter_nd_acc(mx.nd.array(data), mx.nd.array(idx),
                                     shape=(4,)).asnumpy()
        last = mx.nd.scatter_nd(mx.nd.array(data), mx.nd.array(idx),
                                shape=(4,)).asnumpy()
    np.testing.assert_array_equal(acc, [0.0, 3.0, 4.0, 0.0])
    np.testing.assert_array_equal(alias, acc)
    assert last[1] in (1.0, 2.0) and last[2] == 4.0 and last[0] == 0.0


def test_sparse_sgd_update_ops():
    V, D, R = 10, 4, 6
    rng = np.random.RandomState(0)
    w0 = rng.randn(V, D).astype(np.float32)
    uids = np.array([1, 3, 5, 7, V, V], dtype=np.int32)
    rows = rng.randn(R, D).astype(np.float32)
    gd = np.zeros((V, D), np.float32)
    gd[uids[:4]] = rows[:4]
    with mx.cpu():
        w = mx.nd.array(w0.copy())
        mx.nd.sparse_sgd_update(w, mx.nd.array(uids), mx.nd.array(rows),
                                out=w, lr=0.1, wd=0.0, rescale_grad=0.5)
        wref = mx.nd.array(w0.copy())
        mx.nd.sgd_update(wref, mx.nd.array(gd), out=wref, lr=0.1, wd=0.0,
                         rescale_grad=0.5)
        np.testing.assert_array_equal(w.asnumpy(), wref.asnumpy())
        uids_all = np.arange(V, dtype=np.int32)
        rows_all = rng.randn(V, D).astype(np.float32)
        w, m = mx.nd.array(w0.copy()), mx.nd.zeros((V, D))
        wref, mref = mx.nd.array(w0.copy()), mx.nd.zeros((V, D))
        for _ in range(3):
            mx.nd.sparse_sgd_mom_update(w, mx.nd.array(uids_all),
                                        mx.nd.array(rows_all), m, out=w,
                                        lr=0.1, wd=0.01, momentum=0.9)
            mx.nd.sgd_mom_update(wref, mx.nd.array(rows_all), mref,
                                 out=wref, lr=0.1, wd=0.01, momentum=0.9)
        np.testing.assert_allclose(w.asnumpy(), wref.asnumpy(), atol=1e-6)
        np.testing.assert_allclose(m.asnumpy(), mref.asnumpy(), atol=1e-6)
        w, m = mx.nd.array(w0.copy()), mx.nd.zeros((V, D))
        mx.nd.sparse_sgd_mom_update(w, mx.nd.array(uids), mx.nd.array(rows),
                                    m, out=w, lr=0.1, momentum=0.9)
        np.testing.assert_array_equal(m.asnumpy()[0], np.zeros(D))
        np.testing.assert_array_equal(w.asnumpy()[0], w0[0])
        np.testing.assert_array_equal(w.asnumpy()[V - 1], w0[V - 1])
        assert np.abs(m.asnumpy()[3]).max() > 0


# -- refusals ------------------------------------------------------------------

def test_ema_refuses_sparse_tables():
    ids, tg = _batches(1)
    with mx.cpu():
        net = sp_net(mx, True)
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1})
        fused = mx.gluon.fuse_step(net, mx.gluon.loss.L2Loss(), tr,
                                   ema_decay=0.99)
        with pytest.raises(MXNetError, match='ema_decay'):
            fused(mx.nd.array(ids[0]), mx.nd.array(tg[0]))


def test_pipeline_refuses_sparse_tables():
    with mx.cpu():
        net = sp_net(mx, True)
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1})
        with pytest.raises(MXNetError, match='pipeline'):
            mx.gluon.fuse_step(net, mx.gluon.loss.L2Loss(), tr,
                               pipeline=(2, 2))


# -- chip_smoke.py's gates of phases 30 and 31 ---------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _gf_run(cs):
    ok = dict(ok=True, max_err_over_bound=0.04)
    shapes = [1, 3, 4, 6, 3, 1, 1, 1, 1]
    return dict(
        pairs_in_code=cs.GF_PAIRS,
        launches_per_step=[cs.GF_PAIRS] * cs.GF_STEPS,
        routed_per_step=[cs.GF_PAIRS] * cs.GF_STEPS,
        bulk_launches=cs.GF_PAIRS * cs.GF_BULK,
        kernel_checks=[dict(x=[1], w=[1], pairs=n, ok=True)
                       for n in shapes],
        losses=[7.570, 7.384, 7.539], unfused_loss=7.5625,
        bulk_equal=True, bulk_differ=[], step_ahead_equal=True,
        cut_routed=9, cut_updates=ok,
        cut_planted_updates=dict(ok=False, max_err_over_bound=5e4))


def test_phase30_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    assert cs.gf_gate(_gf_run(cs)) == []
    bad = {
        'launches_per_step': [cs.GF_PAIRS, cs.GF_PAIRS - 1, cs.GF_PAIRS],
        'unfused_loss': 7.8,
        'bulk_equal': False,
        'step_ahead_equal': False,
        'cut_updates': dict(ok=False, max_err_over_bound=3.0),
        'cut_planted_updates': dict(ok=True, max_err_over_bound=0.5),
        'pairs_in_code': 20,
        'losses': [float('nan'), 1.0, 1.0],
    }
    for key, value in bad.items():
        run = _gf_run(cs)
        run[key] = value
        assert cs.gf_gate(run), key
    run = _gf_run(cs)
    run['kernel_checks'][2]['ok'] = False
    assert cs.gf_gate(run)


def _mf_run(cs):
    rungs = [4096, 4096]
    expected = cs.MF_STEPS * sum(2 * r * cs.MF['rank'] * 4 * 2
                                 for r in rungs)
    w1 = (cs.MF['users'] + cs.MF['items']) * cs.MF['rank'] * 4
    rank = lambda r: dict(rank=r, data=cs.MF_RANKS, backend='gloo',
                          striped=['item_embed_weight', 'user_embed_weight'],
                          table_bytes=w1 // 2)
    return dict(
        untouched_changed=[], touched_changed=True, plain_sgd_differ=[],
        embed_stats=dict(embed_touched_bytes=expected,
                         embed_dense_equiv_bytes=20 * expected,
                         embed_steps=cs.MF_STEPS),
        touched_bytes_expected=expected, same_bits_twice=True,
        world1_table_bytes=w1, ranks=[rank(0), rank(1)],
        rank_updates=dict(ok=True), restore=dict(ok=True),
        serve=dict(equal=True, pinned=True, hits=3603,
                   device_table_bytes=2 * cs.MF_HOT_ROWS * cs.MF['rank']
                   * 4))


def test_phase31_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    assert cs.mf_gate(_mf_run(cs)) == []
    for key, value in (('untouched_changed', ['user_embed_weight']),
                       ('touched_changed', False),
                       ('plain_sgd_differ', ['item_embed_weight']),
                       ('same_bits_twice', False),
                       ('rank_updates', dict(ok=False)),
                       ('restore', dict(ok=False))):
        run = _mf_run(cs)
        run[key] = value
        assert cs.mf_gate(run), key
    run = _mf_run(cs)
    run['embed_stats']['embed_touched_bytes'] += 1
    assert cs.mf_gate(run)
    run = _mf_run(cs)
    run['ranks'][1]['table_bytes'] = run['world1_table_bytes']
    assert cs.mf_gate(run)
    for key in ('equal', 'pinned'):
        run = _mf_run(cs)
        run['serve'][key] = False
        assert cs.mf_gate(run), key
    run = _mf_run(cs)
    run['serve']['device_table_bytes'] *= 10
    assert cs.mf_gate(run)
