"""Evaluation metrics: the counterpart of mxnet_tpu/metric.py (reference
python/mxnet/metric.py).

`update` accumulates on the host, from outputs and labels read back as
numpy (`asnumpy` waits for the device), the JAX package's host loop.

The device-resident fold serves `Module.bulk_step` and `fit(bulk=)`.
A metric with `_device_delta` gives, from device tensors, the (sum,
count) pair its `update` would add, as torch ops that read nothing
back: `device_fold` builds the `DeviceFold` of a metric (None when any
part of it accumulates only on the host), whose carry holds one pair of
0-d device tensors per leaf metric, in the JAX package's dtypes (int32
counts; int32 sums for the accuracies, float32 for the rest).
`update_device` adds a dispatch's pair to a running device pair with no
synchronisation, and `get()` is the first read on the host. The integer
sums equal the host loop's; the float ones agree to float32 rounding.
"""
import math

import numpy as np
import torch

from . import base
from .ndarray import NDArray


def _count(n, like):
    """The count `n` as a 0-d int32 tensor on `like`'s device: a fill,
    not a copy from the host (which would synchronise)."""
    return torch.full((), int(n), dtype=torch.int32, device=like.device)


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

    # -- device-resident accumulation: `_device_delta(labels, preds)` on
    # device tensors returns the (sum, count) pair `update` would add;
    # None = this metric accumulates only on the host
    _device_delta = None
    _device_sum_dtype = 'float32'

    def update_device(self, dsum, dcount):
        """Add a (sum, count) pair of device tensors to the running
        device pair, with no synchronisation: the pending state stays
        one pair however many dispatches run, and `get()` reads it."""
        pend = self._pending_device
        if pend is None:
            self._pending_device = (dsum, dcount)
        else:
            self._pending_device = (pend[0] + dsum, pend[1] + dcount)

    def _drain_device(self):
        pend = getattr(self, '_pending_device', None)
        if pend is not None:
            self._pending_device = None
            self.sum_metric += float(pend[0].item())
            self.num_inst += int(pend[1].item())

    def device_key(self):
        """Hashable identity of this metric's device fold: its math and
        its output_names / label_names routing."""
        return (type(self).__name__,
                tuple(sorted(self._kwargs.items())),
                None if self.output_names is None
                else tuple(self.output_names),
                None if self.label_names is None
                else tuple(self.label_names))

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._pending_device = None

    def get(self):
        self._drain_device()
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

    _device_sum_dtype = 'int32'

    def _device_delta(self, labels, preds):
        ds = dc = None
        for label, pred in zip(labels, preds):
            if tuple(pred.shape) != tuple(label.shape):
                pred = torch.argmax(pred, dim=self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            lab = label.to(torch.int32).reshape(-1)
            if self.ignore_label is not None:
                keep = lab != int(self.ignore_label)
                s = ((pred == lab) & keep).sum(dtype=torch.int32)
                c = keep.sum(dtype=torch.int32)
            else:
                s = (pred == lab).sum(dtype=torch.int32)
                c = _count(pred.numel(), pred)
            ds = s if ds is None else ds + s
            dc = c if dc is None else dc + c
        return ds, dc


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

    _device_sum_dtype = 'int32'

    def _device_delta(self, labels, preds):
        # ties between equal scores may rank otherwise than numpy's
        # unstable argsort (as in the JAX package); real scores do not tie
        ds, dc = None, 0
        for label, pred in zip(labels, preds):
            pred = pred.to(torch.float32)
            lab = label.to(torch.int32).reshape(-1)
            order = torch.argsort(pred, dim=1, stable=True)
            num_samples, num_classes = pred.shape
            for j in range(min(num_classes, self.top_k)):
                s = (order[:, num_classes - 1 - j] == lab).sum(
                    dtype=torch.int32)
                ds = s if ds is None else ds + s
            dc += num_samples
        return ds, _count(dc, ds)


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

    def _device_delta(self, labels, preds):
        # one exp of the step's mean loss, weighted by its count, as
        # `update`; ignored positions (-1 included, which indexes the last
        # column as in numpy before it is masked) add nothing
        loss = num = None
        for label, pred in zip(labels, preds):
            lab = label.reshape(-1).to(torch.int64)
            probs = pred.reshape(-1, pred.shape[-1])
            picked = probs[torch.arange(lab.shape[0], device=lab.device),
                           lab].to(torch.float32)
            n = _count(lab.shape[0], lab)
            if self.ignore_label is not None:
                ignore = lab == int(self.ignore_label)
                picked = torch.where(ignore, torch.ones_like(picked),
                                     picked)
                n = n - ignore.sum(dtype=torch.int32)
            term = -torch.log(torch.clamp(picked, min=1e-10)).sum()
            loss = term if loss is None else loss + term
            num = n if num is None else num + n
        n = torch.clamp(num, min=1)
        nf = n.to(torch.float32)
        return torch.exp(loss / nf) * nf, n


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

    def _device_measure(self, diff):
        raise NotImplementedError

    def _device_delta(self, labels, preds):
        ds, dc = None, 0
        for label, pred in zip(labels, preds):
            lab = label.reshape(-1, 1) if label.ndim == 1 else label
            s = self._device_measure(lab - pred).to(torch.float32)
            ds = s if ds is None else ds + s
            dc += 1
        return ds, _count(dc, ds)


@register
class MAE(_RegressionMetric):
    def __init__(self, name='mae', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return np.abs(diff).mean()

    def _device_measure(self, diff):
        return diff.abs().mean()


@register
class MSE(_RegressionMetric):
    def __init__(self, name='mse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return (diff ** 2.0).mean()

    def _device_measure(self, diff):
        return (diff ** 2.0).mean()


@register
class RMSE(_RegressionMetric):
    def __init__(self, name='rmse', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _measure(self, diff):
        return np.sqrt((diff ** 2.0).mean())

    def _device_measure(self, diff):
        return torch.sqrt((diff ** 2.0).mean())


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

    def _device_delta(self, labels, preds):
        ds, dc = None, 0
        for label, pred in zip(labels, preds):
            idx = label.reshape(-1).to(torch.int64)
            picked = pred[torch.arange(idx.shape[0], device=idx.device),
                          idx]
            s = -torch.log(picked + self.eps).sum().to(torch.float32)
            ds = s if ds is None else ds + s
            dc += idx.shape[0]
        return ds, _count(dc, ds)


@register
class Loss(EvalMetric):
    """Mean of the raw outputs (for make_loss graphs)."""

    def __init__(self, name='loss', output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += pred.asnumpy().sum()
            self.num_inst += pred.size

    def _device_delta(self, labels, preds):
        ds, dc = None, 0
        for pred in preds:
            s = pred.sum().to(torch.float32)
            ds = s if ds is None else ds + s
            dc += pred.numel()
        return ds, _count(dc, ds)


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


class DeviceFold:
    """The device-resident running sums of one (possibly composite)
    metric, built by `device_fold`. `init(device)` is the zero carry, a
    (sum, count) pair of 0-d tensors per leaf metric in its sum dtype;
    `update(carry, label_dict, pred_dict)` adds a step's pairs, each
    leaf's update_dict routing applied, with torch ops that read nothing
    back; `commit(carry)` queues the carry on the leaf metrics
    (`update_device`)."""

    def __init__(self, leaves):
        self.leaves = leaves
        self.key = tuple(m.device_key() for m in leaves)

    def init(self, device):
        return tuple((torch.zeros((), dtype=getattr(torch,
                                                    m._device_sum_dtype),
                                  device=device),
                      torch.zeros((), dtype=torch.int32, device=device))
                     for m in self.leaves)

    def update(self, carry, label, pred):
        out = []
        for m, (s, c) in zip(self.leaves, carry):
            picked_preds = (list(pred.values()) if m.output_names is None
                            else [pred[n] for n in m.output_names])
            picked_labels = (list(label.values())
                             if m.label_names is None
                             else [label[n] for n in m.label_names])
            ds, dc = m._device_delta(picked_labels, picked_preds)
            out.append((s + ds.to(s.dtype), c + dc.to(c.dtype)))
        return tuple(out)

    def commit(self, carry):
        for m, (s, c) in zip(self.leaves, carry):
            m.update_device(s, c)

    @staticmethod
    def global_carry(carry, mesh):
        """The carry summed over the data axis of `mesh` (each rank's
        carry holds its rows' pairs), so every rank commits the global
        batch's; the carry itself without a mesh."""
        if mesh is None or mesh.shape.get('data', 1) <= 1:
            return carry
        from .parallel.collectives import _all_reduce
        flat = [t for pair in carry for t in pair]
        out = [_all_reduce(t, mesh, 'data') for t in flat]
        return tuple((out[2 * i], out[2 * i + 1])
                     for i in range(len(carry)))


def device_fold(metric):
    """The device-resident fold of `metric`, or None when any part of it
    accumulates only on the host (CustomMetric, F1, a composite with
    name filters of its own): the caller then takes the per-batch host
    update."""
    if metric is None:
        return None
    leaves = []
    stack = [metric]
    while stack:
        m = stack.pop(0)
        if isinstance(m, CompositeEvalMetric):
            if m.output_names is not None or m.label_names is not None:
                return None
            stack = list(m.metrics) + stack
            continue
        if getattr(m, '_device_delta', None) is None:
            return None
        leaves.append(m)
    return DeviceFold(leaves)


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
