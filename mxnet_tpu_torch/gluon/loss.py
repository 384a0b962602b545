"""Gluon losses, the counterpart of mxnet_tpu/gluon/loss.py (reference
python/mxnet/gluon/loss.py: the Loss base with sample weighting, L2, L1,
sigmoid BCE, softmax CE, KL divergence, Huber and hinge)."""
from .block import HybridBlock


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (float, int)), 'weight must be a number'
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base class: per-sample loss averaged over all but batch_axis."""

    def __init__(self, weight, batch_axis, **kwargs):
        super(Loss, self).__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return '%s(batch_axis=%s, w=%s)' % (
            self.__class__.__name__, self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _mean_other_axes(self, F, loss):
        axes = [i for i in range(loss.ndim) if i != self._batch_axis]
        if not axes:
            return loss
        return F.mean(loss, axis=tuple(axes))


class L2Loss(Loss):
    r"""0.5 * (pred - label)^2, averaged per sample."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super(L2Loss, self).__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_other_axes(F, loss)


class L1Loss(Loss):
    r"""|pred - label|, averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super(L1Loss, self).__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    r"""BCE with optional fused sigmoid (from_sigmoid=False applies the
    numerically stable log-sum-exp form)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super(SigmoidBinaryCrossEntropyLoss, self).__init__(
            weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            max_val = F.maximum(-pred, F.zeros_like(pred))
            loss = pred - pred * label + max_val + \
                F.log(F.exp(-max_val) + F.exp(-pred - max_val))
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label +
                     F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    r"""Softmax + cross entropy; label is class index unless
    sparse_label=False (then one-hot/probabilities)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super(SoftmaxCrossEntropyLoss, self).__init__(
            weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    r"""Kullback-Leibler divergence; pred is log-probabilities if
    from_logits=True (default, matching reference)."""

    def __init__(self, from_logits=True, weight=None, batch_axis=0,
                 **kwargs):
        super(KLDivLoss, self).__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)


class HuberLoss(Loss):
    r"""Smoothed L1: quadratic within rho, linear outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super(HuberLoss, self).__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)


class HingeLoss(Loss):
    r"""max(0, margin - pred*label); label in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super(HingeLoss, self).__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.maximum(self._margin - pred * label, F.zeros_like(pred))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_other_axes(F, loss)
