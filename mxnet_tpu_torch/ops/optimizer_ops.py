"""Standalone optimizer-update operators: the counterpart of
mxnet_tpu/ops/optimizer_ops.py (reference src/operator/optimizer_op.cc:
sgd_update, sgd_mom_update, mp_sgd_update, mp_sgd_mom_update,
adam_update, rmsprop_update, rmspropalex_update).

The state tensors (momentum, mean, var, n, g, delta, weight32) are aux
inputs mutated on every call (`aux_always`), so
`nd.sgd_mom_update(w, g, mom, out=w, lr=...)` updates the weight through
`out=` and the momentum in its holder, as in the JAX package and the
reference. Each op is the JAX op's arithmetic in the same order on torch
tensors. The whole-model update Module uses is `optimizer.FusedSGD`.

`sparse_sgd_update` and `sparse_sgd_mom_update` are the rows-only
updates of sparse embedding tables (parallel/embedding.sparse_row_update)
from the (unique ids, row gradients) pair the fused sparse backward makes.
"""
import torch

from .registry import register, asfloat


def _opt_infer_shape(attrs, in_shapes):
    """Every state tensor has the weight's shape: back-filled, so that a
    symbolic bind needs only the weight and gradient shapes."""
    w = in_shapes[0]
    if w is not None:
        in_shapes = [w if s is None else s for s in in_shapes]
    return in_shapes


def _prep_grad(grad, attrs, dtype):
    rescale = asfloat(attrs.get('rescale_grad', 1.0))
    clip = asfloat(attrs.get('clip_gradient', -1.0))
    g = grad.to(dtype) * rescale
    if clip >= 0.0:
        g = g.clamp(-clip, clip)
    return g


def _hypers(attrs, *names):
    return [asfloat(attrs[n]) if n == 'lr' else asfloat(attrs.get(n, d))
            for n, d in names]


@register('sgd_update', input_names=('weight', 'grad'), hint='sgd_update',
          infer_shape=_opt_infer_shape)
def _sgd_update(attrs, weight, grad):
    """weight = (1 - lr*wd)*weight - lr*clip(rescale*grad)."""
    lr, wd = _hypers(attrs, ('lr', None), ('wd', 0.0))
    g = _prep_grad(grad, attrs, weight.dtype)
    return (1.0 - lr * wd) * weight - lr * g


@register('sgd_mom_update', input_names=('weight', 'grad', 'mom'),
          num_aux=1, mutable_aux=True, aux_always=True, simple=False,
          hint='sgd_mom_update', infer_shape=_opt_infer_shape)
def _sgd_mom_update(attrs, inputs, auxs, op_ctx):
    """mom = momentum*mom - lr*wd*weight - lr*clip(rescale*grad);
    weight += mom."""
    weight, grad = inputs
    mom, = auxs
    lr, wd, momentum = _hypers(attrs, ('lr', None), ('wd', 0.0),
                               ('momentum', 0.0))
    g = _prep_grad(grad, attrs, weight.dtype)
    new_mom = momentum * mom - lr * wd * weight - lr * g
    return [weight + new_mom], [new_mom]


@register('mp_sgd_update', input_names=('weight', 'grad', 'weight32'),
          num_aux=1, mutable_aux=True, aux_always=True, simple=False,
          hint='mp_sgd_update', infer_shape=_opt_infer_shape)
def _mp_sgd_update(attrs, inputs, auxs, op_ctx):
    """Multi-precision SGD: the math on the float32 master, the
    low-precision weight its cast."""
    weight, grad = inputs
    weight32, = auxs
    lr, wd = _hypers(attrs, ('lr', None), ('wd', 0.0))
    g = _prep_grad(grad, attrs, torch.float32)
    w = (1.0 - lr * wd) * weight32 - lr * g
    return [w.to(weight.dtype)], [w]


@register('mp_sgd_mom_update',
          input_names=('weight', 'grad', 'mom', 'weight32'),
          num_aux=2, mutable_aux=True, aux_always=True, simple=False,
          hint='mp_sgd_mom_update', infer_shape=_opt_infer_shape)
def _mp_sgd_mom_update(attrs, inputs, auxs, op_ctx):
    """Multi-precision momentum SGD: momentum and master in float32."""
    weight, grad = inputs
    mom, weight32 = auxs
    lr, wd, momentum = _hypers(attrs, ('lr', None), ('wd', 0.0),
                               ('momentum', 0.0))
    g = _prep_grad(grad, attrs, torch.float32)
    new_mom = momentum * mom - lr * wd * weight32 - lr * g
    w = weight32 + new_mom
    return [w.to(weight.dtype)], [new_mom, w]


def _sparse_update(attrs, weight, uids, grad_rows, mom=None):
    from ..parallel.embedding import sparse_row_update
    lr, wd, momentum = _hypers(attrs, ('lr', None), ('wd', 0.0),
                               ('momentum', 0.0))
    clip = asfloat(attrs.get('clip_gradient', -1.0))
    w = weight.clone()
    m = mom.clone() if mom is not None else w
    sparse_row_update(
        w, m, uids.to(torch.int32).long(), grad_rows, lr, wd,
        momentum=momentum if mom is not None else 0.0,
        rescale=asfloat(attrs.get('rescale_grad', 1.0)),
        clip=clip if clip >= 0.0 else None)
    return w, m


@register('sparse_sgd_update', input_names=('weight', 'uids', 'grad_rows'),
          hint='sparse_sgd_update')
def _sparse_sgd_update(attrs, weight, uids, grad_rows):
    """Rows-only SGD (docs/SPARSE.md): `uids` the touched row ids, unique
    as parallel.embedding.dedup_ids makes them (entries == vocab are
    padding and write nothing), `grad_rows` their summed row gradients.
    The same rescale / clip / wd arithmetic as sgd_update on those rows
    only."""
    return _sparse_update(attrs, weight, uids, grad_rows)[0]


@register('sparse_sgd_mom_update',
          input_names=('weight', 'uids', 'grad_rows', 'mom'), num_aux=1,
          mutable_aux=True, aux_always=True, simple=False,
          hint='sparse_sgd_mom_update')
def _sparse_sgd_mom_update(attrs, inputs, auxs, op_ctx):
    """Rows-only momentum SGD with lazy semantics: an untouched row keeps
    its weight and its momentum (no decay), so it equals sgd_mom_update
    only where every row is touched every step."""
    weight, uids, grad_rows = inputs
    mom, = auxs
    w, m = _sparse_update(attrs, weight, uids, grad_rows, mom)
    return [w], [m]


def _wd_grad(grad, weight, attrs):
    """rescale*grad + wd*weight, then clipped: the gradient of the Adam
    and RMSProp ops, weight decay folded in."""
    rescale, wd, clip = _hypers(attrs, ('rescale_grad', 1.0), ('wd', 0.0),
                                ('clip_gradient', -1.0))
    g = grad.to(weight.dtype) * rescale + wd * weight
    if clip >= 0.0:
        g = g.clamp(-clip, clip)
    return g


def _clip_weights(out, attrs):
    clip_w = asfloat(attrs.get('clip_weights', -1.0))
    return out.clamp(-clip_w, clip_w) if clip_w >= 0.0 else out


@register('adam_update', input_names=('weight', 'grad', 'mean', 'var'),
          num_aux=2, mutable_aux=True, aux_always=True, simple=False,
          hint='adam_update', infer_shape=_opt_infer_shape)
def _adam_update(attrs, inputs, auxs, op_ctx):
    """mean and var moving averages, then weight -= lr*mean/(sqrt(var) +
    eps); wd folds into the gradient."""
    weight, grad = inputs
    mean, var = auxs
    lr, beta1, beta2, eps = _hypers(attrs, ('lr', None), ('beta1', 0.9),
                                    ('beta2', 0.999), ('epsilon', 1e-8))
    g = _wd_grad(grad, weight, attrs)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g.square()
    out = weight - lr * new_mean / (new_var.sqrt() + eps)
    return [out], [new_mean, new_var]


@register('rmsprop_update', input_names=('weight', 'grad', 'n'),
          num_aux=1, mutable_aux=True, aux_always=True, simple=False,
          hint='rmsprop_update', infer_shape=_opt_infer_shape)
def _rmsprop_update(attrs, inputs, auxs, op_ctx):
    """Tieleman and Hinton's RMSProp."""
    weight, grad = inputs
    n, = auxs
    lr, gamma1, eps = _hypers(attrs, ('lr', None), ('gamma1', 0.95),
                              ('epsilon', 1e-8))
    g = _wd_grad(grad, weight, attrs)
    new_n = (1.0 - gamma1) * g.square() + gamma1 * n
    out = weight - lr * g / (new_n + eps).sqrt()
    return [_clip_weights(out, attrs)], [new_n]


@register('rmspropalex_update',
          input_names=('weight', 'grad', 'n', 'g', 'delta'),
          num_aux=3, mutable_aux=True, aux_always=True, simple=False,
          hint='rmspropalex_update', infer_shape=_opt_infer_shape)
def _rmspropalex_update(attrs, inputs, auxs, op_ctx):
    """Graves' RMSProp (arxiv 1308.0850, eq. 38-45)."""
    weight, grad = inputs
    n, g_state, delta = auxs
    lr, gamma1, gamma2, eps = _hypers(attrs, ('lr', None), ('gamma1', 0.95),
                                      ('gamma2', 0.9), ('epsilon', 1e-8))
    g = _wd_grad(grad, weight, attrs)
    new_n = (1.0 - gamma1) * g.square() + gamma1 * n
    new_g = (1.0 - gamma1) * g + gamma1 * g_state
    # n - g^2 is a variance, but dips below 0 in float math once the
    # gradient's sign alternates: clamped before the sqrt
    variance = (new_n - new_g.square()).clamp_min(0.0)
    new_delta = gamma2 * delta - lr * g / (variance + eps).sqrt()
    out = weight + new_delta
    return [_clip_weights(out, attrs)], [new_n, new_g, new_delta]
