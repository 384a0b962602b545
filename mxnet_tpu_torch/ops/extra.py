"""The remaining loss, regularisation and linear-algebra ops: the
counterpart of mxnet_tpu/ops/extra.py over torch tensors.

SVMOutput (reference svm_output-inl.h), smooth_l1, the KL-sparsity
regulariser IdentityAttachKLSparseReg with its moving-average aux state,
the linalg family (la_op.cc: gemm, gemm2, potrf, potri, trmm, trsm,
sumlogdiag, syrk, on torch.linalg with the same transpose / rightside /
alpha attrs), and the fork's LSoftmax, MultiLogistic and WeightedL1.
The loss ops ignore the head gradient except as a scale, each through a
`torch.autograd.Function`, as the JAX package's custom VJPs do.
"""
import math

import torch

from .registry import register, asbool, asint, asfloat


# ---------------------------------------------------------------------------
# SVMOutput: forward the identity, backward the (squared) hinge gradient
# ---------------------------------------------------------------------------

class _SVMOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, params):
        ctx.save_for_backward(data, label)
        ctx.params = params
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.params
        k = data.shape[-1]
        onehot = (label.to(torch.int32).long().unsqueeze(-1) ==
                  torch.arange(k, device=data.device)).to(data.dtype)
        score_y = torch.sum(data * onehot, dim=-1, keepdim=True)
        viol = ((margin + data - score_y) > 0) & (onehot == 0)
        if use_linear:
            gj = viol.to(data.dtype) * reg_coef
        else:
            gj = viol.to(data.dtype) * 2.0 * reg_coef * \
                (margin + data - score_y)
        gy = -gj.sum(dim=-1, keepdim=True)
        # the head cotangent scales it (ones from the executor)
        return (gj + onehot * gy) * g, torch.zeros_like(label), None


@register('SVMOutput', input_names=('data', 'label'), hint='svmoutput',
          infer_shape=lambda attrs, s: (
              s if s[0] is None or s[1] is not None
              else [s[0], (s[0][0],)]))
def _svm_output(attrs, data, label):
    params = (asfloat(attrs.get('margin', 1.0)),
              asfloat(attrs.get('regularization_coefficient', 1.0)),
              asbool(attrs.get('use_linear', False)))
    return _SVMOutput.apply(data, label, params)


# ---------------------------------------------------------------------------
# smooth_l1: 0.5 (sigma x)^2 where |x| < 1/sigma^2, else |x| - 0.5/sigma^2
# ---------------------------------------------------------------------------

@register('smooth_l1', input_names=('data',))
def _smooth_l1(attrs, data):
    sigma = asfloat(attrs.get('scalar', 1.0))
    s2 = sigma * sigma
    absx = torch.abs(data)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * data * data,
                       absx - 0.5 / s2)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg: the identity, whose backward adds the
# KL-sparsity penalty's gradient at the moving average of the mean
# activation (an aux state)
# ---------------------------------------------------------------------------

class _KLSparse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, moving_avg, params):
        ctx.save_for_backward(moving_avg)
        ctx.params = params
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        moving_avg, = ctx.saved_tensors
        rho, penalty = ctx.params
        kl_grad = penalty * (-rho / moving_avg +
                             (1.0 - rho) / (1.0 - moving_avg))
        return g + kl_grad[None, :], torch.zeros_like(moving_avg), None


def _kl_sparse_compute(attrs, inputs, auxs, op_ctx):
    data = inputs[0]
    moving_avg = auxs[0]
    rho = asfloat(attrs.get('sparseness_target', 0.1))
    penalty = asfloat(attrs.get('penalty', 0.001))
    momentum = asfloat(attrs.get('momentum', 0.9))
    if op_ctx.is_train:
        avg = torch.sigmoid(data.detach()).mean(dim=0)
        moving_avg = momentum * moving_avg + (1.0 - momentum) * avg
    out = _KLSparse.apply(data, moving_avg, (rho, penalty))
    return [out], [moving_avg]


register('IdentityAttachKLSparseReg', input_names=('data', 'moving_avg'),
         num_aux=1, mode_dependent=True, mutable_aux=True, simple=False,
         hint='identityattachklsparsereg',
         infer_shape=lambda attrs, s: (
             s if s[0] is None or s[1] is not None
             else [s[0], (s[0][1],)]))(_kl_sparse_compute)


# ---------------------------------------------------------------------------
# The linear-algebra family (la_op.cc), on torch.linalg
# ---------------------------------------------------------------------------

def _tr(x, transpose):
    return torch.swapaxes(x, -1, -2) if transpose else x


def _solve_lower(a, b, lower):
    """x with a x = b, a triangular (jax.scipy.linalg.solve_triangular)."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register('linalg_gemm', input_names=('A', 'B', 'C'), hint='linalg_gemm')
def _linalg_gemm(attrs, a, b, c):
    ta = asbool(attrs.get('transpose_a', False))
    tb = asbool(attrs.get('transpose_b', False))
    alpha = asfloat(attrs.get('alpha', 1.0))
    beta = asfloat(attrs.get('beta', 1.0))
    return alpha * torch.matmul(_tr(a, ta), _tr(b, tb)) + beta * c


@register('linalg_gemm2', input_names=('A', 'B'), hint='linalg_gemm2')
def _linalg_gemm2(attrs, a, b):
    ta = asbool(attrs.get('transpose_a', False))
    tb = asbool(attrs.get('transpose_b', False))
    alpha = asfloat(attrs.get('alpha', 1.0))
    return alpha * torch.matmul(_tr(a, ta), _tr(b, tb))


@register('linalg_potrf', input_names=('A',), hint='linalg_potrf')
def _linalg_potrf(attrs, a):
    # jnp.linalg.cholesky symmetrises its input: the same value on a
    # symmetric matrix, and a symmetric gradient
    return torch.linalg.cholesky((a + torch.swapaxes(a, -1, -2)) / 2)


@register('linalg_potri', input_names=('A',), hint='linalg_potri')
def _linalg_potri(attrs, a):
    # the input is the Cholesky factor L; the output inv(L L^T)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    linv = _solve_lower(a, eye, True)
    return torch.matmul(torch.swapaxes(linv, -1, -2), linv)


@register('linalg_trmm', input_names=('A', 'B'), hint='linalg_trmm')
def _linalg_trmm(attrs, a, b):
    ta = asbool(attrs.get('transpose', False))
    rightside = asbool(attrs.get('rightside', False))
    alpha = asfloat(attrs.get('alpha', 1.0))
    at = _tr(a, ta)
    return alpha * (torch.matmul(b, at) if rightside
                    else torch.matmul(at, b))


@register('linalg_trsm', input_names=('A', 'B'), hint='linalg_trsm')
def _linalg_trsm(attrs, a, b):
    ta = asbool(attrs.get('transpose', False))
    rightside = asbool(attrs.get('rightside', False))
    alpha = asfloat(attrs.get('alpha', 1.0))
    if rightside:
        # X A^(T) = alpha B  <=>  A^(T)^T X^T = alpha B^T
        xt = _solve_lower(_tr(a, not ta), torch.swapaxes(alpha * b, -1, -2),
                          ta)
        return torch.swapaxes(xt, -1, -2)
    return _solve_lower(_tr(a, ta), alpha * b, not ta)


@register('linalg_sumlogdiag', input_names=('A',), hint='linalg_sumlogdiag')
def _linalg_sumlogdiag(attrs, a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(dim=-1)


@register('linalg_syrk', input_names=('A',), hint='linalg_syrk')
def _linalg_syrk(attrs, a):
    ta = asbool(attrs.get('transpose', False))
    alpha = asfloat(attrs.get('alpha', 1.0))
    at = _tr(a, ta)
    return alpha * torch.matmul(at, torch.swapaxes(at, -1, -2))


# ---------------------------------------------------------------------------
# The fork's LSoftmax, MultiLogistic and WeightedL1
# ---------------------------------------------------------------------------

def _lsoftmax_infer_shape(attrs, in_shapes):
    num_hidden = asint(attrs['num_hidden'])
    if in_shapes[0] is not None:
        n, d = in_shapes[0]
        if in_shapes[1] is None:
            in_shapes[1] = (num_hidden, d)
        if in_shapes[2] is None:
            in_shapes[2] = (n,)
    return in_shapes


@register('LSoftmax', input_names=('data', 'weight', 'label'),
          num_outputs=3,
          output_names=('output', 'data_norm', 'weight_norm'),
          infer_shape=_lsoftmax_infer_shape, mode_dependent=True,
          simple=False, hint='lsoftmax')
def _lsoftmax(attrs, inputs, auxs, op_ctx):
    """Large-Margin Softmax inner product (Liu et al. 2016): out = x.w^T,
    but in train mode the label column becomes
    (((-1)^k cos(m theta) - 2k)|x||w_yi| + beta fo) / (1 + beta), with the
    angle bin k a constant of the gradient."""
    x, w, label = inputs
    margin = asint(attrs.get('margin', 2))
    beta = asfloat(attrs.get('beta', 1.0))
    out = x @ w.T
    x_norm = torch.sqrt(torch.sum(torch.square(x), dim=1))
    w_norm = torch.sqrt(torch.sum(torch.square(w), dim=1))
    if not op_ctx.is_train:
        return [out, x_norm, w_norm], []
    n = x.shape[0]
    yi = label.to(torch.int32).long()
    rows = torch.arange(n, device=x.device)
    fo = out[rows, yi]
    wn_yi = w_norm[yi]
    cos_t = fo / (x_norm * wn_yi)
    ktab = torch.cos(torch.arange(1, margin + 1, device=x.device,
                                  dtype=x.dtype) * (math.pi / margin))
    k = torch.sum(cos_t.detach()[:, None] < ktab[None, :], dim=1)
    sin2_t = 1.0 - cos_t * cos_t
    cos_mt = torch.zeros_like(cos_t)
    for p in range(margin // 2 + 1):
        term = ((-1.0) ** p) * math.comb(margin, 2 * p) * \
            torch.pow(cos_t, margin - 2 * p) * torch.pow(sin2_t, p)
        cos_mt = cos_mt + term
    sign_k = 1.0 - 2.0 * (k % 2).to(out.dtype)
    f = (sign_k * cos_mt - 2.0 * k.to(out.dtype)) * (wn_yi * x_norm)
    newval = (f + beta * fo) / (1.0 + beta)
    out = out.index_put((rows, yi), newval)
    return [out, x_norm, w_norm], []


class _RegLoss(torch.autograd.Function):
    """A loss op whose forward is elementwise and whose backward is a
    function of (out, label), scaled by the head cotangent."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, params):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.params = grad, params
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        return (ctx.grad(ctx.params, out, label) * g,
                torch.zeros_like(label), None, None, None)


def _multi_logistic_grad(params, out, label):
    return params[0] * ((out - label) * label * params[1] +
                        (out - label) * (1 - label))


@register('MultiLogistic', input_names=('data', 'label'),
          hint='multilogistic',
          infer_shape=lambda attrs, s: (
              s if s[0] is None or s[1] is not None else [s[0], s[0]]))
def _multi_logistic(attrs, data, label):
    """Multi-label logistic output with positive-class weighting
    (reference multi_logistic-inl.h)."""
    params = (asfloat(attrs.get('grad_scale', 1.0)),
              asfloat(attrs.get('weight', 1.0)))
    return _RegLoss.apply(data, label, torch.sigmoid, _multi_logistic_grad,
                          params)


def _weighted_l1_grad(params, out, label):
    return params[0] * torch.sign(out - label) * (label > 0).to(out.dtype)


@register('WeightedL1', input_names=('data', 'label'), hint='weightedl1',
          infer_shape=lambda attrs, s: (
              s if s[0] is None or s[1] is not None else [s[0], s[0]]))
def _weighted_l1(attrs, data, label):
    """L1 regression masked to positive labels (reference
    weighted_l1-inl.h)."""
    params = (asfloat(attrs.get('grad_scale', 1.0)),)
    return _RegLoss.apply(data, label, torch.clone, _weighted_l1_grad,
                          params)
