"""Neural-network layer operators: the counterpart of mxnet_tpu/ops/nn.py
over torch tensors: FullyConnected, Activation, LeakyReLU, the softmax
family, SoftmaxOutput and the regression outputs, Convolution,
Deconvolution, Pooling, BatchNorm, InstanceNorm, L2Normalization, LRN,
Dropout, the sequence ops, UpSampling and Crop.

Each keeps its JAX namesake's names, attrs, shape and dtype rules and
values. Convolution and Pooling take the executor's NHWC layout pass
(the private `__layout__='NHWC'` attr: the data arrives channels-last
and the output leaves channels-last), and BatchNorm re-targets its
channel axis under it. SoftmaxOutput and the regression outputs ignore
the head gradient except as a scale, as the reference's loss ops do,
each through a `torch.autograd.Function`. Dropout draws its mask from
the op context's generator and is the identity when not training.

The executor's conv -> BatchNorm pair route hands BatchNorm the sums of
the conv kernel (`cuda_conv.conv2d_bn_stats`) through `batch_norm`'s
`sums`, in place of its own.

Under a data mesh (a Module over several contexts: each rank holds 1/N
of the batch's rows, `parallel.mesh.current_data_mesh`) every reduction
over the batch is made global, so that the step is the one-device step
on the global batch: BatchNorm's statistics are summed over the data
axis (`collectives.allreduce_sum_sync`, whose backward sums the
cotangent too), SoftmaxOutput's 'batch' and 'valid' normalizations
count the global batch, and Dropout draws the global batch's mask and
keeps this rank's rows.
"""
import math

import torch
import torch.nn.functional as F

from .registry import (register, astuple, asbool, asint, asfloat,
                       normalize_axis)
from ..base import parse_attr_value


def _data_mesh():
    from ..parallel.mesh import current_data_mesh
    return current_data_mesh()


def _sync_sum(x, mesh):
    from ..parallel.collectives import allreduce_sum_sync
    return allreduce_sum_sync(x, 'data', mesh)


# ---------------------------------------------------------------------------
# FullyConnected: reference src/operator/fully_connected-inl.h
# ---------------------------------------------------------------------------

def _fc_names(attrs):
    if asbool(attrs.get('no_bias', False)):
        return ['data', 'weight']
    return ['data', 'weight', 'bias']


def _fc_infer_shape(attrs, in_shapes):
    num_hidden = asint(attrs['num_hidden'])
    flatten = asbool(attrs.get('flatten', True))
    if in_shapes[0] is not None and in_shapes[1] is None:
        d = in_shapes[0]
        # the feature dims must be known (the batch may still be 0)
        # before the weight's shape can be filled in
        if all(x != 0 for x in d[1:]):
            in_dim = math.prod(d[1:]) if flatten else d[-1]
            in_shapes[1] = (num_hidden, in_dim)
    if len(in_shapes) > 2 and in_shapes[2] is None:
        in_shapes[2] = (num_hidden,)
    return in_shapes


def _fc_infer_shape_bwd(attrs, in_shapes, out_shapes):
    """The batch dim flows from the output back to the data."""
    out = out_shapes[0] if out_shapes else None
    d = in_shapes[0]
    if out is not None and out[0] != 0 and d is not None and d[0] == 0:
        in_shapes[0] = (out[0],) + tuple(d[1:])
    return in_shapes


@register('FullyConnected', input_names=_fc_names,
          infer_shape=_fc_infer_shape, infer_shape_bwd=_fc_infer_shape_bwd,
          hint='fullyconnected')
def _fully_connected(attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) \
        if asbool(attrs.get('flatten', True)) else data
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Activation: reference src/operator/activation-inl.h
# ---------------------------------------------------------------------------

_ACTS = {
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    # jax.nn.softplus is logaddexp(x, 0)
    'softrelu': lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    'softsign': lambda x: x / (1 + torch.abs(x)),
}


@register('Activation', input_names=('data',), hint='activation')
def _activation(attrs, data):
    return _ACTS[str(parse_attr_value(attrs['act_type']))](data)


# ---------------------------------------------------------------------------
# SoftmaxOutput: its backward is softmax(x) - onehot(label), whatever the
# head gradient beyond a scale (reference softmax_output-inl.h)
# ---------------------------------------------------------------------------

def _softmax_axis(params, ndim):
    multi_output, preserve_shape = params[3], params[5]
    if preserve_shape or (not multi_output and ndim <= 2):
        return ndim - 1
    return 1


class _SoftmaxOutput(torch.autograd.Function):
    """softmax of data along the class axis; the custom VJP of
    mxnet_tpu/ops/nn.py's _softmax_output_fn."""

    @staticmethod
    def forward(ctx, data, label, params, mesh):
        out = torch.softmax(data, dim=_softmax_axis(params, data.ndim))
        ctx.save_for_backward(out, label)
        ctx.params = params
        ctx.mesh = mesh
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, _, normalization,
         _) = ctx.params
        axis = _softmax_axis(ctx.params, out.ndim)
        k = out.shape[axis]
        lab = label.to(torch.int32).long()
        # jax.nn.one_hot: an out-of-range class is a row of zeros
        onehot = (lab.unsqueeze(-1) == torch.arange(
            k, device=out.device)).to(out.dtype)
        grad = out - torch.movedim(onehot, -1, axis)
        # under a data mesh the counts are the global batch's
        mesh = ctx.mesh
        n = 1 if mesh is None else mesh.axis_size('data')
        valid = None
        if use_ignore:
            mask = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * mask.unsqueeze(axis)
            count = mask.sum()
            if mesh is not None:
                from ..parallel.collectives import _all_reduce
                count = _all_reduce(count, mesh, 'data')
            valid = torch.clamp(count, min=1.0)
        grad = grad * grad_scale
        if normalization == 'batch':
            grad = grad / (out.shape[0] * n)
        elif normalization == 'valid':
            grad = grad / (valid if valid is not None else lab.numel() * n)
        # the head cotangent scales it: ones from the executor, so the
        # identity there, and a zero cotangent gives a zero gradient
        return grad * g, torch.zeros_like(label), None, None


def _softmax_label_shape(attrs, dshape):
    if asbool(attrs.get('multi_output', False)) or len(dshape) > 2:
        return (dshape[0],) + tuple(dshape[2:])
    return (dshape[0],)


@register('SoftmaxOutput', input_names=('data', 'label'),
          aliases=('Softmax',), hint='softmaxoutput',
          infer_shape=lambda attrs, s: (
              s if s[0] is None or s[1] is not None
              else [s[0], _softmax_label_shape(attrs, s[0])]))
def _softmax_output(attrs, data, label):
    params = (asfloat(attrs.get('grad_scale', 1.0)),
              asfloat(attrs.get('ignore_label', -1.0)),
              asbool(attrs.get('use_ignore', False)),
              asbool(attrs.get('multi_output', False)),
              str(parse_attr_value(attrs.get('normalization', 'null'))),
              asbool(attrs.get('preserve_shape', False)))
    return _SoftmaxOutput.apply(data, label, params, _data_mesh())


# ---------------------------------------------------------------------------
# Convolution: reference src/operator/convolution-inl.h
# ---------------------------------------------------------------------------

def _conv_names(attrs):
    if asbool(attrs.get('no_bias', False)):
        return ['data', 'weight']
    return ['data', 'weight', 'bias']


def _conv_infer_shape(attrs, in_shapes):
    kernel = astuple(attrs['kernel'])
    num_filter = asint(attrs['num_filter'])
    num_group = asint(attrs.get('num_group', 1))
    if in_shapes[0] is not None and in_shapes[1] is None:
        c = in_shapes[0][1]
        in_shapes[1] = (num_filter, c // num_group) + kernel
    if len(in_shapes) > 2 and in_shapes[2] is None:
        in_shapes[2] = (num_filter,)
    return in_shapes


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_params(attrs):
    """(kernel, stride, dilate, pad, num_group) of a Convolution's attrs,
    each spatial one a tuple of the kernel's rank."""
    kernel = astuple(attrs['kernel'])
    nd = len(kernel)
    return (kernel, astuple(attrs.get('stride', (1,) * nd), nd),
            astuple(attrs.get('dilate', (1,) * nd), nd),
            astuple(attrs.get('pad', (0,) * nd), nd),
            asint(attrs.get('num_group', 1)))


@register('Convolution', input_names=_conv_names,
          infer_shape=_conv_infer_shape, hint='convolution',
          aliases=('Convolution_v1',))
def _convolution(attrs, data, weight, bias=None):
    kernel, stride, dilate, pad, num_group = conv_params(attrs)
    nhwc_io = attrs.get('__layout__') == 'NHWC' and len(kernel) == 2
    # the executor's layout pass: NHWC data is an NCHW tensor in the
    # channels-last memory format, which cuDNN takes as it lies and
    # answers in kind, so the output's NHWC view is contiguous
    x = data.permute(0, 3, 1, 2) if nhwc_io else data
    out = _CONV[len(kernel)](x, weight, bias, stride=stride, padding=pad,
                             dilation=dilate, groups=num_group)
    return out.permute(0, 2, 3, 1) if nhwc_io else out


# ---------------------------------------------------------------------------
# Pooling: reference src/operator/pooling-inl.h
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _pool_pads(attrs, sizes, kernel, stride, pad):
    """(lo, hi) padding per spatial dim: the JAX package's asymmetric
    padding, hi = max((out - 1) * s + k - size - p, p), with out rounded
    down ('valid') or up ('full')."""
    convention = str(parse_attr_value(attrs.get('pooling_convention',
                                                'valid')))
    pads = []
    for size, k, s, p in zip(sizes, kernel, stride, pad):
        if convention == 'full':
            out = int(math.ceil((size + 2 * p - k) / s)) + 1
        else:
            out = (size + 2 * p - k) // s + 1
        pads.append((p, max((out - 1) * s + k - size - p, p)))
    return pads


def _window_sum(x, kernel, stride):
    """Sum over each window of the spatial dims of an NC... tensor (no
    padding): an average pool scaled back, exact for 2-D and 3-D
    (divisor_override=1), otherwise a strided view summed."""
    nd = len(kernel)
    if nd == 2:
        return F.avg_pool2d(x, kernel, stride, divisor_override=1)
    if nd == 3:
        return F.avg_pool3d(x, kernel, stride, divisor_override=1)
    for i, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, s)
    return x.sum(tuple(range(x.ndim - nd, x.ndim)))


@register('Pooling', input_names=('data',), hint='pooling',
          aliases=('Pooling_v1',))
def _pooling(attrs, data):
    pool_type = str(parse_attr_value(attrs.get('pool_type', 'max')))
    nhwc_io = attrs.get('__layout__') == 'NHWC' and data.ndim == 4
    nspatial = data.ndim - 2
    sp0 = 1 if nhwc_io else 2
    if asbool(attrs.get('global_pool', False)):
        axes = tuple(range(sp0, sp0 + nspatial))
        if pool_type == 'max':
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type == 'sum':
            return torch.sum(data, dim=axes, keepdim=True)
        return torch.mean(data, dim=axes, keepdim=True)
    kernel = astuple(attrs['kernel'])
    stride = astuple(attrs.get('stride', (1,) * nspatial), nspatial)
    pad = astuple(attrs.get('pad', (0,) * nspatial), nspatial)
    sizes = data.shape[sp0:sp0 + nspatial]
    pads = _pool_pads(attrs, sizes, kernel, stride, pad)
    # F.pad takes (lo, hi) pairs from the last dim back; under NHWC the
    # channel dim comes last and takes none
    flat = [q for lo_hi in reversed(pads) for q in lo_hi]
    if nhwc_io:
        flat = [0, 0] + flat
    if pool_type == 'max':
        fill = -math.inf if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
    else:
        fill = 0
    x = F.pad(data, flat, value=fill)
    if nhwc_io:
        x = x.permute(0, 3, 1, 2)      # channels-last NCHW view
    if pool_type == 'max':
        out = _MAX_POOL[nspatial](x, kernel, stride)
    else:
        out = _window_sum(x, kernel, stride)
        if pool_type == 'avg':
            # cuDNN COUNT_INCLUDE_PADDING, the reference default
            out = out / float(math.prod(kernel))
    return out.permute(0, 2, 3, 1) if nhwc_io else out


# ---------------------------------------------------------------------------
# BatchNorm: reference src/operator/batch_norm-inl.h (aux moving stats)
# ---------------------------------------------------------------------------

def _bn_infer_shape(attrs, in_shapes):
    if in_shapes[0] is not None:
        axis = normalize_axis(attrs.get('axis', 1), len(in_shapes[0]))
        c = (in_shapes[0][axis],)
        for i in range(1, len(in_shapes)):
            if in_shapes[i] is None:
                in_shapes[i] = c
    return in_shapes


def _bn_infer_dtype(attrs, in_dtypes):
    """Scale, shift and the moving statistics stay float32 whatever the
    compute dtype; the output follows the data."""
    d = in_dtypes[0] if in_dtypes[0] is not None else torch.float32
    f32 = torch.float32
    n_out = 3 if asbool(attrs.get('output_mean_var', False)) else 1
    return [d, f32, f32, f32, f32], [d] + [f32] * (n_out - 1)


def bn_axis(attrs, ndim):
    """The channel axis of a BatchNorm: its attr, or 3 when the layout
    pass hands it NHWC data for axis 1."""
    axis = normalize_axis(attrs.get('axis', 1), ndim)
    if attrs.get('__layout__') == 'NHWC' and axis == 1 and ndim == 4:
        return 3
    return axis


def batch_norm(attrs, inputs, auxs, op_ctx, sums=None):
    """BatchNorm as the JAX package's _bn_compute: in train mode (without
    use_global_stats) the batch statistics, float32 data by the two-pass
    variance and lower precision by the one-pass sums, the moving
    statistics updated from them without a gradient; else the moving
    statistics. The normalisation is a per-channel scale and shift in
    the data's dtype, differentiable through mean and var.

    `sums` = (s1, s2), the float32 sum and sum of squares of the data per
    channel taken elsewhere (the conv kernel of the executor's pair
    route), replaces the one-pass sums; the gradient reaches them.

    Under a data mesh the statistics are the global batch's: the sums
    (one (2, C) all-reduce), or for float32 the mean and then the sum of
    squared deviations from it (two), each summed over the data axis
    with a backward that sums too; the moving statistics follow from
    them and are the same on every rank."""
    data, gamma, beta = inputs
    moving_mean, moving_var = auxs
    in_dtype = data.dtype
    eps = asfloat(attrs.get('eps', 1e-3))
    momentum = asfloat(attrs.get('momentum', 0.9))
    fix_gamma = asbool(attrs.get('fix_gamma', True))
    use_global = asbool(attrs.get('use_global_stats', False))
    output_mean_var = asbool(attrs.get('output_mean_var', False))
    axis = bn_axis(attrs, data.ndim)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    if fix_gamma:
        # ones, with no gradient: gamma's gradient is zero
        gamma = torch.ones_like(gamma).detach()
    gamma = gamma.to(torch.float32)
    beta = beta.to(torch.float32)
    red = tuple(i for i in range(data.ndim) if i != axis)

    def apply(mean, var):
        scale = gamma * torch.rsqrt(var + eps)
        shift = beta - mean * scale
        return data * scale.to(in_dtype).reshape(bshape) + \
            shift.to(in_dtype).reshape(bshape)

    if op_ctx.is_train and not use_global:
        nelem = math.prod(data.shape[i] for i in red)
        mesh = _data_mesh()
        if mesh is not None:
            nelem *= mesh.axis_size('data')
        if sums is None and data.dtype != torch.float32:
            # low precision: one pass over the data for both sums
            dataf = data.to(torch.float32)
            sums = (torch.sum(dataf, dim=red),
                    torch.sum(dataf * dataf, dim=red))
        if sums is not None:
            if mesh is not None:
                s12 = _sync_sum(torch.stack(sums), mesh)
                sums = (s12[0], s12[1])
            mean = sums[0] / nelem
            var = torch.clamp(sums[1] / nelem - mean * mean, min=0.0)
        elif mesh is not None:
            # float32 over the mesh: the two-pass variance, each pass's
            # sum global
            mean = _sync_sum(torch.sum(data, dim=red), mesh) / nelem
            dev = data - mean.reshape(bshape)
            var = _sync_sum(torch.sum(dev * dev, dim=red), mesh) / nelem
        else:
            # full precision: the two-pass variance, which does not cancel
            # when |mean| >> std
            mean = torch.mean(data, dim=red)
            var = torch.var(data, dim=red, unbiased=False)
        smean, svar = mean.detach(), var.detach()
        new_mean = moving_mean * momentum + smean * (1 - momentum)
        new_var = moving_var * momentum + svar * (1 - momentum)
        outs = [apply(mean, var), mean, var] if output_mean_var \
            else [apply(mean, var)]
        return outs, [new_mean, new_var]
    out = apply(moving_mean, moving_var)
    outs = [out, moving_mean, moving_var] if output_mean_var else [out]
    return outs, [moving_mean, moving_var]


register('BatchNorm', input_names=('data', 'gamma', 'beta',
                                   'moving_mean', 'moving_var'),
         num_aux=2, mutable_aux=True, mode_dependent=True,
         infer_shape=_bn_infer_shape, infer_dtype=_bn_infer_dtype,
         hint='batchnorm',
         num_outputs=lambda attrs: 3 if asbool(
             attrs.get('output_mean_var', False)) else 1,
         output_names=lambda attrs: (
             ['output', 'mean', 'var']
             if asbool(attrs.get('output_mean_var', False)) else ['output']),
         aliases=('BatchNorm_v1',), simple=False)(batch_norm)


# ---------------------------------------------------------------------------
# LeakyReLU: reference src/operator/leaky_relu-inl.h
# ---------------------------------------------------------------------------

def _leaky_act(attrs):
    return str(parse_attr_value(attrs.get('act_type', 'leaky')))


@register('LeakyReLU', input_names=lambda attrs: (
    ['data', 'gamma'] if _leaky_act(attrs) == 'prelu' else ['data']),
    hint='leakyrelu',
    infer_shape=lambda attrs, s: (
        s if len(s) < 2 or s[1] is not None or s[0] is None
        else [s[0], (s[0][1],)]))
def _leaky_relu(attrs, data, gamma=None):
    act = _leaky_act(attrs)
    slope = asfloat(attrs.get('slope', 0.25))
    if act == 'prelu':
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data >= 0, data, g * data)
    if act == 'elu':
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act == 'rrelu':
        # the mean slope, train mode as test mode (the JAX package's)
        lo = asfloat(attrs.get('lower_bound', 0.125))
        hi = asfloat(attrs.get('upper_bound', 0.334))
        slope = (lo + hi) / 2.0
    return torch.where(data >= 0, data, slope * data)


# ---------------------------------------------------------------------------
# Softmax family: reference src/operator/tensor/nn/softmax.cc
# ---------------------------------------------------------------------------

@register('softmax', input_names=('data',))
def _softmax(attrs, data):
    axis = asint(attrs.get('axis', -1))
    t = parse_attr_value(attrs.get('temperature', None))
    x = data / t if t else data
    return torch.softmax(x, dim=axis)


@register('log_softmax', input_names=('data',))
def _log_softmax(attrs, data):
    return torch.log_softmax(data, dim=asint(attrs.get('axis', -1)))


@register('SoftmaxActivation', input_names=('data',),
          hint='softmaxactivation')
def _softmax_activation(attrs, data):
    if str(parse_attr_value(attrs.get('mode', 'instance'))) == 'channel':
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


# ---------------------------------------------------------------------------
# Regression outputs: reference src/operator/regression_output-inl.h; the
# backward ignores the head gradient but as a scale: f(out) - label
# (linear, logistic), sign(out - label) (MAE), times grad_scale
# ---------------------------------------------------------------------------

_REGRESSIONS = {
    'LinearRegressionOutput': (lambda x: x, lambda out, lab: out - lab),
    'LogisticRegressionOutput': (torch.sigmoid,
                                 lambda out, lab: out - lab),
    'MAERegressionOutput': (lambda x: x,
                            lambda out, lab: torch.sign(out - lab)),
}


class _RegressionOutput(torch.autograd.Function):
    """A regression output op: its forward and the reference's
    gradient, the custom VJP of mxnet_tpu/ops/nn.py's _make_regression
    (no batch normalisation: the optimizer's rescale_grad carries it)."""

    @staticmethod
    def forward(ctx, data, label, name, grad_scale):
        out = _REGRESSIONS[name][0](data)
        ctx.save_for_backward(out, label)
        ctx.name, ctx.grad_scale = name, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        lab = label.reshape(out.shape)
        grad = _REGRESSIONS[ctx.name][1](out, lab) * ctx.grad_scale * g
        return grad, torch.zeros_like(label), None, None


def _register_regression(name):
    @register(name, input_names=('data', 'label'), hint=name.lower(),
              infer_shape=lambda attrs, s: (
                  s if s[0] is None or s[1] is not None else [s[0], s[0]]))
    def op(attrs, data, label):
        return _RegressionOutput.apply(
            data, label, name, asfloat(attrs.get('grad_scale', 1.0)))
    return op


for _name in _REGRESSIONS:
    _register_regression(_name)


@register('softmax_cross_entropy', input_names=('data', 'label'))
def _softmax_cross_entropy(attrs, data, label):
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int32).long()
    nll = -torch.gather(logp, -1, lab[:, None])
    return nll.sum().reshape((1,))


# ---------------------------------------------------------------------------
# Deconvolution: reference src/operator/deconvolution-inl.h; weight
# (C_in, num_filter // group, *kernel), output (i-1)*s + k - 2p + adj,
# torch's transposed convolution exactly
# ---------------------------------------------------------------------------

def _deconv_infer_shape(attrs, in_shapes):
    kernel = astuple(attrs['kernel'])
    num_filter = asint(attrs['num_filter'])
    num_group = asint(attrs.get('num_group', 1))
    if in_shapes[0] is not None and in_shapes[1] is None:
        c = in_shapes[0][1]
        in_shapes[1] = (c, num_filter // num_group) + kernel
    if len(in_shapes) > 2 and in_shapes[2] is None:
        in_shapes[2] = (num_filter,)
    return in_shapes


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register('Deconvolution', input_names=_conv_names,
          infer_shape=_deconv_infer_shape, hint='deconvolution')
def _deconvolution(attrs, data, weight, bias=None):
    kernel = astuple(attrs['kernel'])
    nd = len(kernel)
    stride = astuple(attrs.get('stride', (1,) * nd), nd)
    pad = astuple(attrs.get('pad', (0,) * nd), nd)
    adj = astuple(attrs.get('adj', (0,) * nd), nd)
    return _DECONV[nd](data, weight, bias, stride=stride, padding=pad,
                       output_padding=adj,
                       groups=asint(attrs.get('num_group', 1)))


# ---------------------------------------------------------------------------
# InstanceNorm, L2Normalization, LRN
# ---------------------------------------------------------------------------

def _in_infer_shape(attrs, in_shapes):
    if in_shapes[0] is not None:
        c = (in_shapes[0][1],)
        for i in (1, 2):
            if in_shapes[i] is None:
                in_shapes[i] = c
    return in_shapes


@register('InstanceNorm', input_names=('data', 'gamma', 'beta'),
          infer_shape=_in_infer_shape, hint='instancenorm')
def _instance_norm(attrs, data, gamma, beta):
    eps = asfloat(attrs.get('eps', 1e-3))
    red = tuple(range(2, data.ndim))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.var(data, dim=red, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape))


@register('L2Normalization', input_names=('data',), hint='l2normalization')
def _l2_normalization(attrs, data):
    eps = asfloat(attrs.get('eps', 1e-10))
    mode = str(parse_attr_value(attrs.get('mode', 'instance')))
    if mode == 'instance':
        red = tuple(range(1, data.ndim))
    elif mode == 'channel':
        red = (1,)
    else:  # spatial
        red = tuple(range(2, data.ndim))
    norm = torch.sqrt(torch.sum(data * data, dim=red, keepdim=True) + eps)
    return data / norm


@register('LRN', input_names=('data',), hint='lrn')
def _lrn(attrs, data):
    """Local response normalisation across channels (reference
    src/operator/lrn-inl.h): the channel window padded so that the output
    keeps the channel count for odd and even nsize."""
    nsize = asint(attrs['nsize'])
    alpha = asfloat(attrs.get('alpha', 1e-4))
    beta = asfloat(attrs.get('beta', 0.75))
    knorm = asfloat(attrs.get('knorm', 2.0))
    lo, hi = nsize // 2, (nsize - 1) // 2
    sq = F.pad(data * data, (0, 0, 0, 0, lo, hi))
    c = data.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, nsize):
        acc = acc + sq[:, i:i + c]
    return data / torch.pow(knorm + alpha / nsize * acc, beta)


# ---------------------------------------------------------------------------
# Dropout: reference src/operator/dropout-inl.h; the mask drawn from the op
# context's generator, identity when not training (mode 'always': always)
# ---------------------------------------------------------------------------

def dropout(data, p, rng):
    """data with each element kept with probability 1 - p and scaled by
    1 / (1 - p), the mask drawn from the generator `rng`."""
    keep = 1.0 - p
    if data.device.type == 'meta':
        return data / keep
    u = torch.rand(data.shape, generator=rng, device=data.device)
    return torch.where(u < keep, data / keep, torch.zeros_like(data))


def _dropout_compute(attrs, inputs, auxs, op_ctx):
    data, = inputs
    p = asfloat(attrs.get('p', 0.5))
    mode = str(parse_attr_value(attrs.get('mode', 'training')))
    if (op_ctx.is_train or mode == 'always') and p > 0:
        mesh = _data_mesh()
        if mesh is None or data.device.type == 'meta':
            return [dropout(data, p, op_ctx.rng)], []
        # the global batch's mask, drawn as the one device draws it
        # (every rank's generator in the same state), and this rank's
        # rows of it
        n, i = mesh.axis_size('data'), mesh.axis_index('data')
        b = data.shape[0]
        u = torch.rand((b * n,) + tuple(data.shape[1:]),
                       generator=op_ctx.rng, device=data.device)
        keep = 1.0 - p
        return [torch.where(u[i * b:(i + 1) * b] < keep, data / keep,
                            torch.zeros_like(data))], []
    return [data], []


register('Dropout', input_names=('data',), needs_rng=True,
         mode_dependent=True, hint='dropout', simple=False)(_dropout_compute)


# ---------------------------------------------------------------------------
# Sequence ops: reference src/operator/sequence_{last,mask,reverse}-inl.h,
# layout (max_sequence_length, batch, ...)
# ---------------------------------------------------------------------------

def _seq_names(attrs):
    if asbool(attrs.get('use_sequence_length', False)):
        return ['data', 'sequence_length']
    return ['data']


@register('SequenceLast', input_names=_seq_names, hint='sequencelast')
def _sequence_last(attrs, data, sequence_length=None):
    if sequence_length is None:
        return data[-1]
    idx = sequence_length.to(torch.int32).long() - 1
    batch = torch.arange(data.shape[1], device=data.device)
    return data[idx, batch]


@register('SequenceMask', input_names=_seq_names, hint='sequencemask')
def _sequence_mask(attrs, data, sequence_length=None):
    if sequence_length is None:
        return data
    value = asfloat(attrs.get('value', 0.0))
    steps = torch.arange(data.shape[0], device=data.device)
    mask = steps[:, None] < sequence_length.to(torch.int32)[None, :]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full_like(data, value))


@register('SequenceReverse', input_names=_seq_names,
          hint='sequencereverse')
def _sequence_reverse(attrs, data, sequence_length=None):
    if sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.to(torch.int32).long()[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[src, batch]


# ---------------------------------------------------------------------------
# UpSampling (nearest, bilinear) and Crop: reference
# src/operator/upsampling-inl.h, crop-inl.h
# ---------------------------------------------------------------------------

def _upsampling_type(attrs):
    return str(parse_attr_value(attrs.get('sample_type', 'nearest')))


def _upsampling_infer_shape(attrs, in_shapes):
    """The bilinear form's weight, which the compute does not read: the
    reference's (C, 1, 2 s - s % 2, 2 s - s % 2)."""
    if _upsampling_type(attrs) != 'nearest' and in_shapes[0] is not None \
            and in_shapes[1] is None:
        s = asint(attrs['scale'])
        k = 2 * s - s % 2
        in_shapes[1] = (in_shapes[0][1], 1, k, k)
    return in_shapes


@register('UpSampling', input_names=lambda attrs: (
    ['arg%d' % i for i in range(asint(attrs.get('num_args', 1)))]
    if _upsampling_type(attrs) == 'nearest' else ['data', 'weight']),
    hint='upsampling', infer_shape=_upsampling_infer_shape)
def _upsampling(attrs, *args):
    scale = asint(attrs['scale'])
    if _upsampling_type(attrs) == 'nearest':
        outs = [x.repeat_interleave(scale, dim=2)
                .repeat_interleave(scale, dim=3) for x in args]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    # half-pixel bilinear, the edges clamped (jax.image.resize's bilinear
    # when enlarging)
    return F.interpolate(args[0], scale_factor=scale, mode='bilinear',
                         align_corners=False)


@register('Crop', input_names=lambda attrs: (
    ['data', 'crop_like'] if asint(attrs.get('num_args', 1)) > 1
    else ['data']), hint='crop')
def _crop(attrs, data, crop_like=None):
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = astuple(attrs['h_w'], 2)
    if asbool(attrs.get('center_crop', False)):
        oh = (data.shape[2] - th) // 2
        ow = (data.shape[3] - tw) // 2
    else:
        oh, ow = astuple(attrs.get('offset', (0, 0)), 2)
    return data[:, :, oh:oh + th, ow:ow + tw]
