"""The port's metrics against the JAX package's, on the CPU: each metric
(by name, with its options) is updated with the same seeded predictions
and labels, over two batches, in both packages, and its get() must be
the same (rtol 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric as tmetric

BATCH, CLASSES = 16, 5


def _probs(rng, classes=CLASSES, rows=BATCH):
    p = rng.rand(rows, classes).astype(np.float32) + 0.05
    return p / p.sum(1, keepdims=True)


def _classify(rng, classes=CLASSES):
    return [_probs(rng, classes)], \
        [rng.randint(0, classes, BATCH).astype(np.float32)]


def _binary(rng):
    return _classify(rng, 2)


def _regress(rng):
    return [rng.randn(BATCH, 1).astype(np.float32)], \
        [rng.randn(BATCH).astype(np.float32)]


def _sequence(rng):
    probs = _probs(rng, CLASSES, BATCH * 3).reshape(BATCH, 3, CLASSES)
    label = rng.randint(0, CLASSES, (BATCH, 3)).astype(np.float32)
    label[0, :2] = 0        # a few positions to ignore
    return [probs], [label]


def _two_heads(rng):
    preds, labels = _classify(rng)
    more, more_labels = _classify(rng)
    return preds + more, labels + more_labels


def _mae_of(label, pred):
    return float(np.abs(label.reshape(-1, 1) - pred).mean())


def _sum_count(label, pred):
    return float((pred.argmax(1) == label).sum()), label.shape[0]


# name -> (make(metric module), data(rng))
CASES = {
    'acc': (lambda m: m.create('acc'), _classify),
    'acc_ignore_label': (lambda m: m.Accuracy(ignore_label=2), _classify),
    'top_k_3': (lambda m: m.create('top_k_accuracy', top_k=3), _classify),
    'f1': (lambda m: m.create('f1'), _binary),
    'perplexity': (lambda m: m.Perplexity(ignore_label=None), _sequence),
    'perplexity_ignore': (lambda m: m.Perplexity(ignore_label=0), _sequence),
    'mae': (lambda m: m.create('mae'), _regress),
    'mse': (lambda m: m.create('mse'), _regress),
    'rmse': (lambda m: m.create('rmse'), _regress),
    'ce': (lambda m: m.create('ce'), _classify),
    'loss': (lambda m: m.create('loss'), _regress),
    'torch': (lambda m: m.create('torch'), _regress),
    'custom': (lambda m: m.create(_mae_of), _regress),
    'np_metric_pair': (lambda m: m.np_metric(_sum_count), _classify),
    'composite': (lambda m: m.create(['acc', 'ce',
                                      m.TopKAccuracy(top_k=2)]), _classify),
    'composite_routed': (lambda m: m.CompositeEvalMetric(
        [m.Accuracy(output_names=['a_output'], label_names=['a_label']),
         m.CrossEntropy(output_names=['b_output'],
                        label_names=['b_label'])]), _two_heads),
    'spec_string': (lambda m: m.create('acc,axis=1'), _classify),
}


def _run(pkg_metric, nd, ctx, make, data, routed):
    metric = make(pkg_metric)
    rng = np.random.RandomState(7)
    for _ in range(2):
        preds, labels = data(rng)
        p = [nd.array(x, ctx=ctx) for x in preds]
        lab = [nd.array(x, ctx=ctx) for x in labels]
        if routed:
            metric.update_dict(dict(zip(['a_label', 'b_label'], lab)),
                               dict(zip(['a_output', 'b_output'], p)))
        else:
            metric.update(lab, p)
    return metric.get(), metric.get_name_value()


@pytest.mark.parametrize('case', sorted(CASES))
def test_metric_matches_jax(case):
    make, data = CASES[case]
    routed = case == 'composite_routed'
    (jn, jv), jpairs = _run(jmetric, jmx.nd, jmx.cpu(), make, data, routed)
    (tn, tv), tpairs = _run(tmetric, mx.nd, mx.cpu(), make, data, routed)
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64),
                               np.asarray(jv, np.float64), rtol=1e-6)
    assert [n for n, _ in tpairs] == [n for n, _ in jpairs]


def test_reset_config_and_the_unported_device_fold():
    m = tmetric.create('acc')
    with mx.cpu():
        m.update([mx.nd.array([1, 0])], [mx.nd.array([[0.1, 0.9],
                                                      [0.8, 0.2]])])
    assert m.get() == ('accuracy', 1.0)
    m.reset()
    name, value = m.get()
    assert name == 'accuracy' and np.isnan(value)
    assert m.get_config() == jmetric.create('acc').get_config()
    # the device fold is ported (tests/test_torch_bulk.py): a leaf metric
    # folds, a host-only one has none
    assert tmetric.device_fold(m).leaves == [m]
    assert tmetric.device_fold(tmetric.np_metric(lambda l, p: 0.0)) is None
    with pytest.raises(ValueError):
        tmetric.create('no_such_metric')
