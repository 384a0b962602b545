"""The port's Module against the JAX package's, on the CPU.

- The MLP of tests/test_module.py through `fit` for 3 epochs (momentum
  SGD with weight decay, numpy-seeded shuffle), its starting weights
  carried across with `set_params`: parameters within rtol 1e-4 / atol
  1e-5, the score above 0.95 as the JAX test asks, predictions alike;
- checkpoints with optimizer states: a resumed fit equals the
  uninterrupted one exactly, and each package resumes from the other's
  files;
- the cut ResNet of tests/test_torch_resnet.py for 2 Module steps of
  multi-precision momentum SGD: float32 within F32_STATE, bf16 (the pair
  route on) weights and moving statistics within 0.02 in relative norm;
- the executor's fused train step against the JAX package's;
- every feature cut from this slice raises, naming its ROADMAP item,
  and the store features of Queue A item 5 work;
- SequentialModule, FeedForward and the callbacks;
- chip_smoke.py's gate of phase 10.
"""
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from test_torch_resnet import (BATCH, CUT, F32_STATE, SHAPES, _f32, _rel,
                               seeded_params)

REPO = Path(__file__).resolve().parents[1]
MLP_OPT = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-3}
PARAMS = dict(rtol=1e-4, atol=1e-5)


def _blobs(n=400, dim=10, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 3
    X = np.zeros((n, dim), dtype=np.float32)
    y = np.zeros((n,), dtype=np.float32)
    for i in range(n):
        c = i % classes
        X[i] = centers[c] + rng.randn(dim) * 0.5
        y[i] = c
    return X, y


def _mlp(pkg, classes=3):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, name='fc1', num_hidden=32)
    act = pkg.sym.Activation(fc1, act_type='relu')
    fc2 = pkg.sym.FullyConnected(act, name='fc2', num_hidden=classes)
    return pkg.sym.SoftmaxOutput(fc2, name='softmax')


def _np_params(mod):
    args, auxs = mod.get_params()
    return {k: np.asarray(v.asnumpy(), np.float32)
            for k, v in list(args.items()) + list(auxs.items())}


@pytest.fixture(scope='module')
def start():
    """The JAX module's Xavier-initialised MLP weights, as numpy."""
    X, y = _blobs()
    mod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
    it = jmx.io.NDArrayIter(X, y, batch_size=40)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(jmx.init.Xavier())
    return _np_params(mod)


def _fit(pkg, start, epochs, shuffle=True, begin_epoch=0, mod=None,
         **fit_kwargs):
    X, y = _blobs()
    np.random.seed(3)
    it = pkg.io.NDArrayIter(X, y, batch_size=40, shuffle=shuffle)
    if mod is None:
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.set_params({k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in start.items()}, {})
    mod.fit(it, num_epoch=begin_epoch + epochs, begin_epoch=begin_epoch,
            optimizer_params=MLP_OPT, **fit_kwargs)
    return mod


def test_mlp_fit_matches_jax(start):
    jm = _fit(jmx, start, 3)
    tm = _fit(mx, start, 3)
    ref, got = _np_params(jm), _np_params(tm)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **PARAMS)
    X, y = _blobs()
    score = tm.score(mx.io.NDArrayIter(X, y, batch_size=40), 'acc')
    assert score[0][1] > 0.95, score
    assert score == [(n, v) for n, v in jm.score(
        jmx.io.NDArrayIter(X, y, batch_size=40), 'acc')]
    # 110 rows: the last batch padded by 10, which predict drops
    tp = tm.predict(mx.io.NDArrayIter(X[:110], y[:110], batch_size=40))
    jp = jm.predict(jmx.io.NDArrayIter(X[:110], y[:110], batch_size=40))
    assert tp.shape == (110, 3)
    np.testing.assert_allclose(tp.asnumpy(), jp.asnumpy(), **PARAMS)
    outs = list(tm.iter_predict(mx.io.NDArrayIter(X[:110], y[:110],
                                                  batch_size=40)))
    assert [o[0][0].shape[0] for o in outs] == [40, 40, 30]


def test_training_leaves_the_arrays_handed_to_callbacks(start):
    """FusedSGD updates the bound tensors in place, so the executor must
    bind copies of what it is given: fit binds the parameters it hands to
    each epoch's callbacks, and those arrays must keep their values."""
    seen = []

    def keep(epoch, symbol, arg_params, aux_params):
        seen.append({k: (v, v.asnumpy()) for k, v in arg_params.items()})
    mod = _fit(mx, start, 2, epoch_end_callback=keep)
    assert len(seen) == 2
    for epoch in seen:
        for k, (arr, values) in epoch.items():
            np.testing.assert_array_equal(arr.asnumpy(), values, err_msg=k)
    assert not np.array_equal(seen[0]['fc1_weight'][1],
                              _np_params(mod)['fc1_weight'])


def test_resumed_fit_equals_the_uninterrupted_one(start, tmp_path):
    whole = _fit(mx, start, 3, shuffle=False)
    half = _fit(mx, start, 2, shuffle=False)
    prefix = str(tmp_path / 'mlp')
    half.save_checkpoint(prefix, 2, save_optimizer_states=True)
    resumed = mx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                 context=mx.cpu())
    X, y = _blobs()
    it = mx.io.NDArrayIter(X, y, batch_size=40)
    resumed.bind(it.provide_data, it.provide_label)
    _fit(mx, None, 1, shuffle=False, begin_epoch=2, mod=resumed)
    ref, got = _np_params(whole), _np_params(resumed)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert resumed._optimizer._index_update_count == \
        whole._optimizer._index_update_count


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_package_resumes_from_the_others_checkpoint(start, writer,
                                                         tmp_path):
    """Two epochs in one package, save_checkpoint with the optimizer
    states, Module.load in both, one more epoch in each: the same
    parameters."""
    src = jmx if writer == 'jax' else mx
    prefix = str(tmp_path / 'mlp')
    _fit(src, start, 2, shuffle=False).save_checkpoint(
        prefix, 2, save_optimizer_states=True)
    out = []
    for pkg in (jmx, mx):
        mod = pkg.mod.Module.load(prefix, 2, load_optimizer_states=True,
                                  context=pkg.cpu())
        X, y = _blobs()
        it = pkg.io.NDArrayIter(X, y, batch_size=40)
        mod.bind(it.provide_data, it.provide_label)
        _fit(pkg, None, 1, shuffle=False, begin_epoch=2, mod=mod)
        out.append(_np_params(mod))
    for k in out[0]:
        np.testing.assert_allclose(out[1][k], out[0][k], err_msg=k,
                                   **PARAMS)


# -- the cut ResNet ----------------------------------------------------------

# phase 10's optimizer, its lr scaled to batch 4 (lr / batch as at 0.1
# and 256): at 0.1 itself two steps move the cut net's weights by more
# than the bf16 gradients of either package agree (test_torch_resnet.py)
RESNET_OPT = dict(learning_rate=0.1 * BATCH / 256, momentum=0.9, wd=1e-4,
                  multi_precision=True)


def _resnet_steps(pkg, dtype, params, batches, monkeypatch):
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    symbol = pkg.models.resnet.resnet(dtype=dtype, **CUT)
    mod = pkg.mod.Module(symbol, context=pkg.cpu())
    mod.bind([('data', SHAPES['data'])], [('softmax_label', (BATCH,))])
    args, auxs = params
    ctx = pkg.cpu()
    mod.set_params({k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()
                    if k not in ('data', 'softmax_label')},
                   {k: pkg.nd.array(v, ctx=ctx) for k, v in auxs.items()})
    mod.init_optimizer(optimizer='sgd', optimizer_params=RESNET_OPT)
    for x, y in batches:
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=ctx)], [pkg.nd.array(y, ctx=ctx)]))
        mod.update()
    return mod


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cut_resnet_module_steps_match_jax(dtype, monkeypatch):
    symbol = jmx.models.resnet.resnet(dtype=dtype, **CUT)
    params = seeded_params(symbol, SHAPES, seed=0)
    batches = []
    for seed in (1, 2):
        a, _ = seeded_params(symbol, SHAPES, seed=seed)
        batches.append((a['data'], a['softmax_label']))
    from mxnet_tpu_torch import cuda_conv
    jm = _resnet_steps(jmx, dtype, params, batches, monkeypatch)
    cuda_conv.CONV_BN_STATS_PLAIN_CALLS = 0
    tm = _resnet_steps(mx, dtype, params, batches, monkeypatch)
    # the units' pairs: the stem's conv0 -> bn0 leaves the route under
    # the stem split, on in both packages
    pairs = 2 * len(CUT['units'])
    assert cuda_conv.CONV_BN_STATS_PLAIN_CALLS == \
        (2 * pairs if dtype == 'bfloat16' else 0)
    ref, got = _np_params(jm), _np_params(tm)
    assert sorted(got) == sorted(ref)
    fu = tm._fused_updater
    low = sorted(n for n, w in tm._exec_group.executor.arg_dict.items()
                 if n in fu.param_names and w.handle.dtype == torch.bfloat16)
    assert sorted(n for n, m in fu.masters.items() if m is not None) == low
    assert bool(low) == (dtype == 'bfloat16')
    bad = {}
    for k in ref:
        assert np.isfinite(got[k]).all(), k
        if dtype == 'float32':
            np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                       **F32_STATE)
        elif _rel(got[k], ref[k]) > 0.02:
            bad[k] = _rel(got[k], ref[k])
    assert not bad, bad


def test_fused_train_step_matches_jax():
    """The executor's whole train step with FusedSGD's update (one XLA
    dispatch in the JAX package; forward_backward, then step_math in
    place here), twice, on the MLP."""
    X, y = _blobs(n=40)
    rng = np.random.RandomState(6)
    w = {'fc1_weight': rng.randn(32, 10) * 0.3, 'fc1_bias': rng.randn(32),
         'fc2_weight': rng.randn(3, 32) * 0.3, 'fc2_bias': rng.randn(3)}
    out = []
    for pkg in (jmx, mx):
        ctx = pkg.cpu()
        ex = _mlp(pkg).simple_bind(ctx, data=(40, 10))
        ex.copy_params_from({k: pkg.nd.array(v.astype(np.float32), ctx=ctx)
                             for k, v in w.items()})
        ex.copy_params_from({'data': pkg.nd.array(X, ctx=ctx),
                             'softmax_label': pkg.nd.array(y, ctx=ctx)})
        names = [n for n in ex._diff_names]
        opt = pkg.optimizer.create('sgd', learning_rate=0.1, momentum=0.9,
                                   wd=0.01, rescale_grad=1 / 40.)
        fu = pkg.optimizer.FusedSGD(opt, names)
        step = ex.make_fused_train_step(fu.step_math)
        for _ in range(2):
            weights = [ex.arg_dict[n] for n in names]
            moms, masters, lrs, wds = fu.host_prep(weights)
            new_moms, new_masters = ex.run_fused_train_step(
                step, names, moms, masters, lrs, wds)
            fu.commit(new_moms, new_masters)
        out.append(({n: ex.arg_dict[n].asnumpy() for n in names},
                    {n: np.asarray(fu.states[n]) for n in names},
                    ex.outputs[0].asnumpy()))
    for (jd, td) in zip(out[0], out[1]):
        if isinstance(jd, dict):
            for k in jd:
                np.testing.assert_allclose(td[k], jd[k], err_msg=k, **PARAMS)
        else:
            np.testing.assert_allclose(td, jd, **PARAMS)


# -- what the slice cut ------------------------------------------------------

def _bound_mlp():
    X, y = _blobs(n=80)
    it = mx.io.NDArrayIter(X, y, batch_size=40)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    return mod, it


def _cut(case):
    mod, it = _bound_mlp()
    if case == 'pipeline':
        mod.fit(it, num_epoch=1, pipeline=(2, 2))


CUTS = {'pipeline': None, 'sparse_fused': None}


def _sparse_fused_rows_only():
    """FusedSGD(sparse_idx=) takes a table's (ids, row gradients) pair
    and updates those rows only, as the JAX package's sparse_row_update
    does: touched rows equal the JAX update, the padded id (vocab) and
    the untouched rows write nothing, and multi_precision is refused."""
    import jax.numpy as jnp
    from mxnet_tpu.parallel import embedding as jemb
    rng = np.random.RandomState(2)
    w0 = rng.randn(6, 3).astype(np.float32)
    uids = np.array([1, 4, 6], np.int64)       # 6 == vocab: padding
    rows = rng.randn(3, 3).astype(np.float32)
    with mx.cpu():
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
        fu = mx.optimizer.FusedSGD(opt, ['w'], sparse_idx=(0,))
        w = mx.nd.array(w0)
        for _ in range(2):
            fu([w], [(torch.as_tensor(uids), torch.as_tensor(rows))])
    jw, jm = jnp.asarray(w0), jnp.zeros((6, 3))
    for _ in range(2):
        jw, jm = jemb.sparse_row_update(
            jw, jm, jnp.asarray(uids, jnp.int32), jnp.asarray(rows), 0.1,
            0.01, momentum=0.9)
    np.testing.assert_allclose(w.asnumpy(), np.asarray(jw), **PARAMS)
    np.testing.assert_allclose(fu.states['w'].numpy(), np.asarray(jm),
                               **PARAMS)
    np.testing.assert_array_equal(w.asnumpy()[[0, 2, 3, 5]],
                                  w0[[0, 2, 3, 5]])
    with pytest.raises(mx.MXNetError, match='multi_precision'):
        mx.optimizer.FusedSGD(mx.optimizer.SGD(multi_precision=True),
                              ['w'], sparse_idx=(0,))


@pytest.mark.parametrize('case', sorted(CUTS))
def test_cut_feature_raises_naming_its_roadmap_item(case):
    """Both are ported: the pipelined fit (6d) refuses one context as the
    JAX package's does (tests/test_torch_pipeline.py holds it against
    the JAX package over four ranks); the sparse fused update (6c) is
    checked against the JAX package's."""
    if case == 'pipeline':
        with pytest.raises(mx.MXNetError, match='do not divide'):
            _cut(case)
        return
    if CUTS[case] is None:
        _sparse_fused_rows_only()
        return
    with pytest.raises(mx.MXNetError, match='Queue A %s\\)' % CUTS[case]):
        _cut(case)


class _StubMesh:
    """What io's staging reads of a data mesh: its shape, this rank's
    index and its device."""
    shape = {'data': 2}
    device = torch.device('cpu')

    def axis_index(self, axis):
        return 1


@pytest.mark.parametrize('case', ['contexts', 'zero', 'zero_fused',
                                  'mesh_staging', 'batch_reduce',
                                  'hybrid_worker'])
def test_item_6b_feature_works(case):
    """The features of Queue A item 6b that this slice's cut refused.
    Several contexts in one process name the launchers (each context is
    a rank of its own process; tests/test_torch_module_dp.py runs
    them); ZeRO-1 over one device equals the replicated update bit for
    bit; FusedSGD(zero=1) buckets and keys its layout; staging over a
    data mesh moves this rank's rows only. The two refusals item 6b
    kept last are gone: every registered op that reduces over the batch
    has a global form (the CPU ranks of test_torch_module_dp.py hold
    them against the JAX Module), and a worker of several ranks syncs
    through the parameter server or the host all-reduce
    (test_torch_hybrid.py). Item 7b's last refusal (io.py's native
    pipeline) is gone too, and with it base.unported: nothing in the
    port refuses a feature as not ported."""
    if case == 'batch_reduce':
        from mxnet_tpu_torch.parallel import batch_reduce
        for name, attrs, ndim in (
                ('sum', {'axis': 0}, 2), ('mean', {}, 3),
                ('max', {'axis': (0, 1)}, 2), ('prod', {'axis': 0}, 1),
                ('norm', {'ord': 1}, 2), ('softmax_cross_entropy', {}, 2),
                ('sort', {'axis': 0}, 2), ('argsort', {'axis': None}, 2),
                ('topk', {'axis': 0, 'k': 2}, 2)):
            assert batch_reduce.reduces_batch(name, attrs, ndim), name
        assert not batch_reduce.reduces_batch('sum', {'axis': 1}, 2)
        assert not batch_reduce.reduces_batch('sort', {}, 2)
        assert batch_reduce.output_replicated('topk', {'axis': 0}, 2)
        assert not batch_reduce.output_replicated('sort', {'axis': 0}, 2)
        assert not batch_reduce.output_replicated(
            'topk', {'axis': 0, 'ret_typ': 'mask'}, 2)
        import subprocess
        sites = subprocess.run(
            ['grep', '-rn', 'unported(', 'mxnet_tpu_torch',
             '--include=*.py'], cwd=str(REPO), capture_output=True,
            text=True).stdout.splitlines()
        assert sites == []
    elif case == 'hybrid_worker':
        from mxnet_tpu_torch.parallel import worker_group
        from mxnet_tpu_torch.tools import launch
        assert not worker_group.configured()
        assert worker_group.init() is None
        env = launch._group_env(1, 1, 2, 2, '127.0.0.1', 9000)
        assert (env['MXNET_TPU_WORKER_RANK'], env['RANK'],
                env['WORLD_SIZE'], env['LOCAL_RANK'],
                env['LOCAL_WORLD_SIZE'], env['MASTER_PORT']) == \
            ('1', '1', '2', '3', '4', '9000')
    elif case == 'contexts':
        mod = mx.mod.Module(_mlp(mx), context=[mx.cpu(0), mx.cpu(1)])
        with pytest.raises(mx.MXNetError, match='torchrun.*launch -n 2'):
            mod.bind([('data', (40, 10))], [('softmax_label', (40,))])
    elif case == 'zero':
        out = {}
        start = _bound_mlp()[0].get_params()
        for zero in (0, 1):
            mod, it = _bound_mlp()
            mod.set_params(*start)
            mod.init_optimizer(optimizer_params={'learning_rate': 0.1,
                                                 'momentum': 0.9},
                               zero=zero)
            assert mod._fused_updater.zero == zero
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
            out[zero] = {k: v.asnumpy()
                         for k, v in mod.get_params()[0].items()}
        for k in out[0]:
            np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)
    elif case == 'zero_fused':
        fu = mx.optimizer.FusedSGD(mx.optimizer.SGD(momentum=0.9), ['w'],
                                   zero=1)
        plain = mx.optimizer.FusedSGD(mx.optimizer.SGD(momentum=0.9),
                                      ['w'])
        assert fu.cache_key() != plain.cache_key()
        moms, masters, _, _ = fu.host_prep(
            [mx.nd.ones((3, 5), ctx=mx.cpu())])
        assert [m.shape for m in moms] == [(15,)] and masters == [None]
        assert any('zero' in str(part) for part in fu.cache_key())
    else:
        X, y = _blobs(n=80)
        it = mx.io.NDArrayIter(X, y, batch_size=40)
        staged = mx.io.prefetch_to_device(it, mesh=_StubMesh())
        batch = next(iter(staged))
        np.testing.assert_array_equal(batch.data[0].asnumpy(), X[20:40])
        np.testing.assert_array_equal(batch.label[0].asnumpy(), y[20:40])
        staged.close()


def _store_step(mod, batch):
    mod.forward_backward(batch)
    mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize('case', ['dist_kvstore', 'kvstore_object',
                                  'checkpoint', 'kvstore_update'])
def test_store_feature_works(case, tmp_path):
    """The features of Queue A item 5 that this slice's cut refused: a
    dist store name and a KVStore object at init_optimizer (without a
    dist runtime the dist store is the parameters' facade and FusedSGD
    updates; a local store object over one device too), fit(checkpoint=)
    and the per-key update through a store."""
    mod, it = _bound_mlp()
    ref, _ = _bound_mlp()
    ref.set_params(*mod.get_params())
    ref.init_optimizer(optimizer_params={'learning_rate': 0.1})
    if case in ('dist_kvstore', 'kvstore_object'):
        kv = 'dist_sync' if case == 'dist_kvstore' else \
            mx.kvstore.create('local')
        mod.init_optimizer(kvstore=kv,
                           optimizer_params={'learning_rate': 0.1})
        assert type(mod._kvstore) is mx.kvstore.KVStore
        assert mod._fused_updater is not None
        assert not mod._update_on_kvstore
        assert mod._optimizer.rescale_grad == 1 / 40.
        batch = next(iter(it))
        got, want = _store_step(mod, batch), _store_step(ref, batch)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    elif case == 'checkpoint':
        mgr = mx.elastic.CheckpointManager(str(tmp_path), every_n_steps=1,
                                           async_=False)
        mod.fit(it, num_epoch=1, checkpoint=mgr)
        assert mx.elastic.list_checkpoints(str(tmp_path))[0] == 2
        mgr.close()
    else:
        kv = mx.kvstore.create('local')
        g = mx.nd.array(np.ones((3,), np.float32), ctx=mx.cpu())
        w = mx.nd.array(np.zeros((3,), np.float32), ctx=mx.cpu())
        kv.init('w', g.copy())
        upd = mx.optimizer.get_updater(mx.optimizer.SGD(learning_rate=0.5))
        mx.model._update_params([w], [g], upd, 1, kvstore=kv,
                                param_names=['w'])
        np.testing.assert_array_equal(w.asnumpy(), [-0.5] * 3)


def test_module_without_a_context_takes_gpu0(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        mx.mod.Module(_mlp(mx))
    with mx.cpu():
        assert mx.mod.Module(_mlp(mx))._context == [mx.cpu()]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert mx.mod.Module(_mlp(mx))._context == [mx.gpu(0)]


def test_init_optimizer_takes_fused_sgd_for_sgd_and_the_updater_else():
    mod, _ = _bound_mlp()
    mod.init_optimizer(optimizer='nag', optimizer_params={'momentum': 0.9})
    assert isinstance(mod._fused_updater, mx.optimizer.FusedSGD)
    assert mod._optimizer.rescale_grad == 1 / 40.
    mod.init_optimizer(optimizer='adam', force_init=True)
    assert mod._fused_updater is None
    assert isinstance(mod._updater, mx.optimizer.Updater)


# -- SequentialModule, FeedForward, callbacks --------------------------------

def _seq(pkg):
    d = pkg.sym.Variable('data')
    first = pkg.sym.Activation(pkg.sym.FullyConnected(d, name='fc1',
                                                      num_hidden=16),
                               act_type='relu')
    d2 = pkg.sym.Variable('data')
    second = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(d2, name='fc2', num_hidden=3), name='softmax')
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(first, label_names=None, context=pkg.cpu()))
    seq.add(pkg.mod.Module(second, context=pkg.cpu()), take_labels=True,
            auto_wiring=True)
    return seq


def test_sequential_module_matches_jax():
    X, y = _blobs(n=120)
    rng = np.random.RandomState(8)
    start = {'fc1_weight': rng.randn(16, 10) * 0.3, 'fc1_bias': np.zeros(16),
             'fc2_weight': rng.randn(3, 16) * 0.3, 'fc2_bias': np.zeros(3)}
    out = []
    for pkg in (jmx, mx):
        seq = _seq(pkg)
        it = pkg.io.NDArrayIter(X, y, batch_size=40)
        seq.bind(it.provide_data, it.provide_label)
        seq.init_params(arg_params={k: pkg.nd.array(v.astype(np.float32),
                                                    ctx=pkg.cpu())
                                    for k, v in start.items()},
                        force_init=True)
        seq.fit(it, num_epoch=2, optimizer_params={'learning_rate': 0.1})
        out.append((_np_params(seq),
                    seq.score(pkg.io.NDArrayIter(X, y, batch_size=40),
                              'acc')))
    for k in out[0][0]:
        np.testing.assert_allclose(out[1][0][k], out[0][0][k], err_msg=k,
                                   **PARAMS)
    assert out[1][1] == out[0][1]


def test_feedforward_and_callbacks(tmp_path, caplog):
    X, y = _blobs(n=120)
    prefix = str(tmp_path / 'ff')
    mx.random.seed(2)
    with caplog.at_level(logging.INFO):
        with mx.cpu():
            model = mx.FeedForward.create(
                _mlp(mx), X, y, ctx=mx.cpu(), num_epoch=3,
                initializer=mx.init.Xavier(), learning_rate=0.1,
                momentum=0.9, numpy_batch_size=40,
                eval_data=(X, y),
                batch_end_callback=[mx.callback.Speedometer(40, 1),
                                    mx.callback.log_train_metric(1),
                                    mx.callback.ProgressBar(3)],
                epoch_end_callback=mx.callback.do_checkpoint(prefix),
                eval_end_callback=mx.callback.LogValidationMetricsCallback())
    assert any('Speed:' in r.getMessage() for r in caplog.records)
    assert any('Validation-accuracy' in r.getMessage()
               for r in caplog.records)
    assert model.score(mx.io.NDArrayIter(X, y, batch_size=40)) > 0.95
    assert model.predict(X).shape == (120, 3)
    # do_checkpoint's files are the JAX package's
    sym, args, _ = jmx.model.load_checkpoint(prefix, 3)
    arg_params = model.arg_params
    for k, v in args.items():
        np.testing.assert_array_equal(v.asnumpy(), arg_params[k].asnumpy())
    model.save(str(tmp_path / 'saved'), 3)
    loaded = mx.FeedForward.load(str(tmp_path / 'saved'), 3, ctx=mx.cpu(),
                                  numpy_batch_size=40)
    np.testing.assert_array_equal(loaded.predict(X), model.predict(X))
    # module_checkpoint saves the module's states too
    mod, it = _bound_mlp()
    mod.init_optimizer(optimizer_params={'momentum': 0.9})
    mx.callback.module_checkpoint(mod, str(tmp_path / 'm'), 1, True)(0)
    assert (tmp_path / 'm-0001.states').exists()


# -- chip_smoke.py's phase 10 gate ---------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _passing_run(cs):
    steps = cs.MODULE_EPOCHS * cs.MODULE_BATCHES
    base = cs.MODULE_OPT['learning_rate']
    wd = cs.MODULE_OPT['wd']
    pairs = cs.route_pairs(cs.RESNET_PAIRS, True)
    return dict(
        stem_split=True,
        train_launches=[pairs] * steps,
        fit_launches=pairs * steps, eval_launches=0,
        route_off=dict(launches=0),
        lrs=[base if i < cs.MODULE_LR_STEP else base * cs.MODULE_LR_FACTOR
             for i in range(steps)],
        wd={'conv0_weight': wd, 'bn0_gamma': wd, 'bn0_beta': 0.0,
            'fc1_bias': 0.0, 'fc1_weight': wd},
        masters=['conv0_weight', 'fc1_bias', 'fc1_weight'],
        low_precision_params=['conv0_weight', 'fc1_bias', 'fc1_weight'],
        master_dtypes=['float32'], finite=True,
        update=dict(weight_steps_max=0.0, weight_steps_worst='conv0_weight',
                    state_rel_max=6e-8, state_rel_worst='mom bn0_gamma'),
        prefetch_equal=True, losses=[6.8, 6.7, 6.6, 6.5, 6.4],
        resume=dict(differ=[], compared=471, same_symbol=True),
        speedometer=[1300.0], score=[('accuracy', 0.0)], score_finite=True)


def test_phase10_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = _passing_run(cs)
    assert cs.module_gate(run) == []
    wrong_launches = dict(run, train_launches=[cs.RESNET_PAIRS] +
                          run['train_launches'][1:])
    assert any('launched' in m for m in cs.module_gate(wrong_launches))
    assert cs.module_gate(dict(run, eval_launches=2))
    decayed_bias = dict(run, wd=dict(run['wd'], fc1_bias=1e-4))
    assert any('fc1_bias' in m for m in cs.module_gate(decayed_bias))
    missing_master = dict(run, masters=run['masters'][1:])
    assert any('master' in m for m in cs.module_gate(missing_master))
    differs = dict(run, resume=dict(run['resume'],
                                    differ=['master conv0_weight']))
    assert any('resumed' in m for m in cs.module_gate(differs))
    flat = dict(run, losses=[6.8, 6.8, 6.9, 6.8, 6.85])
    assert any('loss' in m for m in cs.module_gate(flat))
    off_update = dict(run, update=dict(run['update'], weight_steps_max=3.0))
    assert cs.module_gate(off_update)
    off_state = dict(run, update=dict(run['update'], state_rel_max=1e-3))
    assert cs.module_gate(off_state)
    assert cs.module_gate(dict(run, prefetch_equal=False))
    no_decay = dict(run, lrs=[0.1] * len(run['lrs']))
    assert any('lr' in m for m in cs.module_gate(no_decay))
    assert cs.module_gate(dict(run, finite=False))
