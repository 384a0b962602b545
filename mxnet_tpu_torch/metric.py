"""Evaluation metrics: the counterpart of mxnet_tpu/metric.py (reference
python/mxnet/metric.py).

Every metric accumulates on the host, from outputs and labels read back
as numpy (`asnumpy` waits for the device), the JAX package's host loop.
The device-resident fold (`DeviceFold`, `device_fold`) serves only
`fit(bulk=)` and is not ported: `device_fold` raises.
"""
import math

import numpy as np

from . import base
from .ndarray import NDArray


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _column(label):
    """Regression metrics compare column vectors; lift 1-D labels."""
    arr = _as_numpy(label)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError('Shape of labels {} does not match shape of '
                         'predictions {}'.format(label_shape, pred_shape))


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return 'EvalMetric: {}'.format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({'metric': self.__class__.__name__, 'name': self.name,
                       'output_names': self.output_names,
                       'label_names': self.label_names})
        return config

    def update_dict(self, label, pred):
        picked_preds = (list(pred.values()) if self.output_names is None
                        else [pred[name] for name in self.output_names])
        picked_labels = (list(label.values()) if self.label_names is None
                         else [label[name] for name in self.label_names])
        self.update(picked_labels, picked_preds)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


register = base.get_register_func(EvalMetric, 'metric')
alias = base.get_alias_func(EvalMetric, 'metric')
_create = base.get_create_func(EvalMetric, 'metric')


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _create(metric, *args, **kwargs)


@register
@alias('composite')
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name='composite', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(m) for m in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, label, pred):
        # The composite's own names restrict what children may see;
        # then each child's output_names/label_names routing applies
        # (a child filtering to one head must not see the others).
        if self.output_names is not None:
            pred = {k: v for k, v in pred.items()
                    if k in self.output_names}
        if self.label_names is not None:
            label = {k: v for k, v in label.items()
                     if k in self.label_names}
        for metric in self.metrics:
            metric.update_dict(label, pred)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, np.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
@alias('acc')
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name='accuracy', output_names=None,
                 label_names=None, ignore_label=None):
        """ignore_label: positions whose label equals it are excluded
        from both the hit count and the instance count (padded
        positions of a batch carry it)."""
        super().__init__(name, output_names, label_names, axis=axis,
                         ignore_label=ignore_label)
        self.axis = axis
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = pred_label.asnumpy() if isinstance(pred_label, NDArray) \
                else np.asarray(pred_label)
            lab = label.asnumpy() if isinstance(label, NDArray) \
                else np.asarray(label)
            if pred.shape != lab.shape:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int32).reshape(-1)
            lab = lab.astype(np.int32).reshape(-1)
            check_label_shapes(lab, pred)
            if self.ignore_label is not None:
                keep = lab != int(self.ignore_label)
                self.sum_metric += ((pred == lab) & keep).sum()
                self.num_inst += int(keep.sum())
            else:
                self.sum_metric += (pred == lab).sum()
                self.num_inst += len(pred)


@register
@alias('top_k_accuracy', 'top_k_acc')
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name='top_k_accuracy', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, 'Please use Accuracy if top_k is no more than 1'
        self.name += '_%d' % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = pred_label.asnumpy().astype(np.float32)
            lab = label.asnumpy().astype(np.int32)
            assert len(pred.shape) <= 2, 'Predictions should be no more than 2 dims'
            pred = np.argsort(pred, axis=1)
            num_samples = pred.shape[0]
            num_classes = pred.shape[1]
            top_k = min(num_classes, self.top_k)
            for j in range(top_k):
                self.sum_metric += (pred[:, num_classes - 1 - j].flat ==
                                    lab.flat).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    def __init__(self, name='f1', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy()
            label = label.asnumpy().astype(np.int32)
            pred_label = np.argmax(pred, axis=1)
            check_label_shapes(label, pred_label)
            if len(np.unique(label)) > 2:
                raise ValueError('F1 currently only supports binary '
                                 'classification.')
            true_pos = ((pred_label == 1) & (label == 1)).sum()
            false_pos = ((pred_label == 1) & (label == 0)).sum()
            false_neg = ((pred_label == 0) & (label == 1)).sum()
            precision = true_pos / (true_pos + false_pos) \
                if true_pos + false_pos > 0 else 0.
            recall = true_pos / (true_pos + false_neg) \
                if true_pos + false_neg > 0 else 0.
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.
            self.sum_metric += f1
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name='perplexity',
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            probs = pred.asnumpy()
            lab = label.asnumpy().astype(np.int32).reshape(-1)
            probs = probs.reshape(-1, probs.shape[-1])
            picked = probs[np.arange(lab.shape[0]), lab]
            if self.ignore_label is not None:
                ignore = (lab == self.ignore_label)
                picked = np.where(ignore, 1.0, picked)
                num -= ignore.sum()
            loss -= np.log(np.maximum(1e-10, picked)).sum()
            num += lab.shape[0]
        self.sum_metric += math.exp(loss / max(num, 1)) * max(num, 1)
        self.num_inst += max(num, 1)


class _RegressionMetric(EvalMetric):
    """Scaffold for metrics that average a per-batch error statistic."""

    def _measure(self, diff):
        raise NotImplementedError

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            diff = _column(label) - _as_numpy(pred)
            self.sum_metric += self._measure(diff)
            self.num_inst += 1


@register
class MAE(_RegressionMetric):
    def __init__(self, name='mae', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return np.abs(diff).mean()


@register
class MSE(_RegressionMetric):
    def __init__(self, name='mse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return (diff ** 2.0).mean()


@register
class RMSE(_RegressionMetric):
    def __init__(self, name='rmse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return np.sqrt((diff ** 2.0).mean())


@register
@alias('ce')
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name='cross-entropy', output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            prob = _as_numpy(pred)
            idx = _as_numpy(label).ravel().astype(np.int64)
            assert idx.shape[0] == prob.shape[0]
            picked = prob[np.arange(idx.shape[0]), idx]
            self.sum_metric += -np.log(picked + self.eps).sum()
            self.num_inst += idx.shape[0]


@register
class Loss(EvalMetric):
    """Mean of the raw outputs (for make_loss graphs)."""

    def __init__(self, name='loss', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += pred.asnumpy().sum()
            self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name='torch', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            fname = feval.__name__
            name = 'custom(%s)' % fname if '<' in fname else fname
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            verdict = self._feval(_as_numpy(label), _as_numpy(pred))
            delta, count = (verdict if isinstance(verdict, tuple)
                            else (verdict, 1))
            self.sum_metric += delta
            self.num_inst += count


def device_fold(metric):
    """The device-resident metric fold of fit(bulk=): not ported."""
    raise base.unported('the device-resident metric fold (fit bulk=)', '2')


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
