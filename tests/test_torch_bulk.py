"""The device metric fold, Module.bulk_step and fit(bulk=) in the port
against the per-step loop and the JAX package, on the CPU.

- Every metric with a device fold: its `_device_delta` on torch tensors
  against its host `update` on the same values (integer sums exact,
  float sums within rtol 1e-6), against the JAX package's fold, in the
  JAX package's dtypes (int32 counts and accuracy sums); a composite
  folds each leaf; the metrics with no fold give None.
- bulk_step on the MLP of tests/test_torch_module.py: equal bit for bit
  to the per-step loop (weights, momenta, the metric's sums) from one
  state, with a FactorScheduler boundary inside the dispatch; within
  rtol 1e-4 / atol 1e-5 (test_module.py's bound) of the JAX package's
  bulk_step; scan_dtype, repeat mode, the per-step fallback of a step
  that cannot fuse and the refusal of a host-only metric.
- fit(bulk=K) against the per-batch fit: the same parameters and metric,
  with one dispatch every K batches; a host-only metric makes fit warn
  and take the per-batch loop.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric as tmetric

from test_torch_module import _blobs, _mlp, _np_params

PARAMS = dict(rtol=1e-4, atol=1e-5)
OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
BATCH = 40


def _metric_cases():
    rs = np.random.RandomState(0)
    probs = rs.dirichlet(np.ones(6), size=12).astype(np.float32)
    labels = rs.randint(0, 6, size=12).astype(np.float32)
    masked = labels.copy()
    masked[9:] = 0
    reg_pred = rs.randn(12, 1).astype(np.float32)
    reg_label = rs.randn(12).astype(np.float32)
    return {
        'acc': (lambda m: m.Accuracy(), labels, probs),
        'acc_ignore': (lambda m: m.Accuracy(ignore_label=0), masked, probs),
        'top_k': (lambda m: m.TopKAccuracy(top_k=3), labels, probs),
        'perplexity': (lambda m: m.Perplexity(), labels, probs),
        'perplexity_ignore': (lambda m: m.Perplexity(ignore_label=0),
                              masked, probs),
        'mae': (lambda m: m.MAE(), reg_label, reg_pred),
        'mse': (lambda m: m.MSE(), reg_label, reg_pred),
        'rmse': (lambda m: m.RMSE(), reg_label, reg_pred),
        'ce': (lambda m: m.CrossEntropy(), labels, probs),
        'loss': (lambda m: m.Loss(), labels, reg_pred),
    }


@pytest.mark.parametrize('case', sorted(_metric_cases()))
def test_device_delta_matches_host_update_and_jax(case):
    make, labels, preds = _metric_cases()[case]
    # two batches: the fold sums their pairs on the device
    halves = [(labels[:6], preds[:6]), (labels[6:], preds[6:])]
    dev = make(tmetric)
    fold = tmetric.device_fold(dev)
    assert fold is not None and fold.key == (dev.device_key(),)
    carry = fold.init(torch.device('cpu'))
    assert carry[0][0].dtype == getattr(torch, dev._device_sum_dtype)
    assert carry[0][1].dtype == torch.int32
    for lab, pred in halves:
        carry = fold.update(carry, {'softmax_label': torch.from_numpy(lab)},
                            {'softmax_output': torch.from_numpy(pred)})
    assert carry[0][1].dtype == torch.int32
    fold.commit(carry)
    host = make(tmetric)
    with mx.cpu():
        for lab, pred in halves:
            host.update([mx.nd.array(lab)], [mx.nd.array(pred)])
    dn, dv = dev.get()
    hn, hv = host.get()
    assert dn == hn and dev.num_inst == host.num_inst
    if dev._device_sum_dtype == 'int32':
        assert dev.sum_metric == host.sum_metric
    else:
        np.testing.assert_allclose(dev.sum_metric, host.sum_metric,
                                   rtol=1e-6)
    jm = make(jmx.metric)
    jfold = jmx.metric.device_fold(jm)
    jcarry = jfold.init()
    for lab, pred in halves:
        jcarry = jfold.update(jcarry, {'softmax_label': jnp.asarray(lab)},
                              {'softmax_output': jnp.asarray(pred)})
    jfold.commit(jcarry)
    assert jm.get()[0] == dn and jm.num_inst == dev.num_inst
    np.testing.assert_allclose(dv, jm.get()[1], rtol=1e-6)
    assert dev.device_key() == jm.device_key()


def test_composite_folds_each_leaf_and_host_only_metrics_have_none():
    comp = tmetric.create(['acc', tmetric.TopKAccuracy(top_k=2)])
    fold = tmetric.device_fold(comp)
    assert [type(m).__name__ for m in fold.leaves] == ['Accuracy',
                                                       'TopKAccuracy']
    for m in (tmetric.F1(), tmetric.CustomMetric(lambda l, p: 0.0),
              tmetric.CompositeEvalMetric(['acc'], output_names=['x'])):
        assert tmetric.device_fold(m) is None
    assert tmetric.device_fold(None) is None
    # an update_device without a read keeps one pending pair
    acc = tmetric.Accuracy()
    for _ in range(3):
        acc.update_device(torch.tensor(2, dtype=torch.int32),
                          torch.tensor(4, dtype=torch.int32))
    assert acc.num_inst == 0 and acc._pending_device is not None
    assert acc.get() == ('accuracy', 0.5) and acc.num_inst == 12
    acc.reset()
    assert acc._pending_device is None


# -- bulk_step ---------------------------------------------------------------

def _sched(pkg):
    # halves the lr after every 2 updates: a boundary inside a K=4 bulk
    return pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)


def _bound(pkg, start, opt=OPT, sched=True):
    X, y = _blobs(n=4 * BATCH)
    ctx = pkg.cpu()
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.set_params({k: pkg.nd.array(v, ctx=ctx) for k, v in start.items()},
                   {})
    params = dict(opt, lr_scheduler=_sched(pkg)) if sched else dict(opt)
    mod.init_optimizer(optimizer='sgd', optimizer_params=params)
    batches = [pkg.io.DataBatch([pkg.nd.array(X[i:i + BATCH], ctx=ctx)],
                                [pkg.nd.array(y[i:i + BATCH], ctx=ctx)])
               for i in range(0, 4 * BATCH, BATCH)]
    return mod, batches


@pytest.fixture(scope='module')
def start():
    X, y = _blobs()
    mod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
    it = jmx.io.NDArrayIter(X, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(jmx.init.Xavier())
    return _np_params(mod)


def _state(mod):
    fu = mod._fused_updater
    return dict({'arg ' + k: v for k, v in _np_params(mod).items()},
                **{'mom ' + k: np.asarray(v) for k, v in fu.states.items()})


def test_bulk_step_equals_the_per_step_loop_bit_for_bit(start):
    bulk, batches = _bound(mx, start)
    steps, _ = _bound(mx, start)
    mb = tmetric.create(['acc', 'ce'])
    ms = tmetric.create(['acc', 'ce'])
    ex = bulk._exec_group.executor
    d0 = ex.fused_dispatches
    lrs = []
    fu = bulk._fused_updater
    prep = fu.host_prep_steps

    def spy(weights, k, advance=True):
        out = prep(weights, k, advance)
        lrs.append([row[0] for row in out[2]])
        return out
    fu.host_prep_steps = spy
    bulk.bulk_step(batches=batches, eval_metric=mb)
    assert ex.fused_dispatches - d0 == 1
    assert lrs == [[0.1, 0.1, 0.05, 0.05]]  # the decay inside the dispatch
    for b in batches:
        steps.forward_backward(b)
        steps.update()
        steps.update_metric(ms, b.label)
    got, want = _state(bulk), _state(steps)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mb.metrics[0].get() == ms.metrics[0].get()
    np.testing.assert_allclose(mb.metrics[1].get()[1], ms.metrics[1].get()[1],
                               rtol=1e-6)
    # only the last step's outputs are kept
    np.testing.assert_array_equal(bulk.get_outputs()[0].asnumpy(),
                                  steps.get_outputs()[0].asnumpy())
    assert bulk._optimizer.num_update == steps._optimizer.num_update == 4


def test_bulk_step_matches_jax(start):
    out = {}
    for pkg in (jmx, mx):
        mod, batches = _bound(pkg, start)
        metric = pkg.metric.create(['acc', 'ce'])
        mod.bulk_step(batches=batches, eval_metric=metric)
        out[pkg] = (_np_params(mod), metric.get_name_value())
    (jp, jv), (tp, tv) = out[jmx], out[mx]
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], err_msg=k, **PARAMS)
    assert [n for n, _ in tv] == [n for n, _ in jv]
    np.testing.assert_allclose([v for _, v in tv], [v for _, v in jv],
                               rtol=1e-5)


def test_bulk_step_repeat_and_scan_dtype(start):
    rep, batches = _bound(mx, start, sched=False)
    loop, _ = _bound(mx, start, sched=False)
    rep.bulk_step(batch=batches[0], repeat=3)
    for _ in range(3):
        loop.forward_backward(batches[0])
        loop.update()
    got, want = _state(rep), _state(loop)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # float16 stacks of float32 data: each step casts its slice back
    narrow, batches = _bound(mx, start, sched=False)
    cast, _ = _bound(mx, start, sched=False)
    narrow.bulk_step(batches=batches, scan_dtype='float16')
    for b in batches:
        x16 = b.data[0].asnumpy().astype(np.float16).astype(np.float32)
        cast.forward_backward(mx.io.DataBatch([mx.nd.array(
            x16, ctx=mx.cpu())], b.label))
        cast.update()
    got, want = _state(narrow), _state(cast)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_step_that_cannot_fuse_takes_the_per_step_loop(start):
    mod, batches = _bound(mx, start, sched=False)
    ref, _ = _bound(mx, start, sched=False)
    mod.install_monitor(mx.mon.Monitor(100))
    assert not mod._fusable_step()
    ex = mod._exec_group.executor
    metric, rmetric = tmetric.create('acc'), tmetric.create('acc')
    mod.bulk_step(batches=batches[:2], eval_metric=metric)
    assert ex.fused_dispatches == 0
    for b in batches[:2]:
        ref.forward_backward(b)
        ref.update()
        ref.update_metric(rmetric, b.label)
    got, want = _state(mod), _state(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert metric.get() == rmetric.get()


def test_host_only_metric_is_refused_by_bulk_step(start):
    mod, batches = _bound(mx, start)
    with pytest.raises(ValueError, match='device fold'):
        mod.bulk_step(batches=batches, eval_metric=tmetric.F1())


def _fit(start, bulk, metric, caplog=None):
    X, y = _blobs(n=7 * BATCH)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    it = mx.io.NDArrayIter(X, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in start.items()}, {})
    ends = []
    mod.fit(it, eval_metric=metric, num_epoch=2, bulk=bulk,
            optimizer_params=dict(OPT, lr_scheduler=_sched(mx)),
            batch_end_callback=lambda p: ends.append((p.epoch, p.nbatch)))
    return mod, ends


def test_fit_bulk_equals_the_per_batch_fit(start, monkeypatch):
    monkeypatch.setenv('MXNET_TPU_PREFETCH', '0')
    mb = tmetric.create(['acc', 'ce'])
    bulk, ends = _fit(start, 3, mb)
    ms = tmetric.create(['acc', 'ce'])
    steps, step_ends = _fit(start, None, ms)
    # 7 batches an epoch: dispatches of 3, 3, then one batch per step
    assert ends == [(e, n) for e in (0, 1) for n in (2, 5, 6)]
    assert step_ends == [(e, n) for e in (0, 1) for n in range(7)]
    assert bulk._exec_group.executor.fused_dispatches == 4
    got, want = _state(bulk), _state(steps)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mb.metrics[0].get() == ms.metrics[0].get()
    np.testing.assert_allclose(mb.metrics[1].get()[1],
                               ms.metrics[1].get()[1], rtol=1e-6)


def test_fit_bulk_with_a_host_only_metric_warns_and_steps(start, caplog):
    with caplog.at_level(logging.WARNING):
        mod, ends = _fit(start, 3, tmetric.np_metric(
            lambda label, pred: float((pred.argmax(1) == label).mean())))
    assert any('no device fold' in r.getMessage() for r in caplog.records)
    assert mod._exec_group.executor.fused_dispatches == 0
    assert len(ends) == 14
