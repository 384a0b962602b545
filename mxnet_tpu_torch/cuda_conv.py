"""Convolution with fused BatchNorm statistics on a hand-written CUDA
kernel: the counterpart of mxnet_tpu/pallas_conv.py.

`conv2d_bn_stats(x, w, stride, pad)` keeps its JAX namesake's contract:
NHWC x, HWIO w, groups 1, no bias; it returns (y, s1, s2), y in x's
dtype and s1 = sum(y), s2 = sum(y * y) per output channel in float32,
summed from the float32 accumulators before y is rounded. It is
differentiable through one `torch.autograd.Function`, the counterpart of
the custom VJP: the statistics' cotangents fold into dy
(dy + ds1 + 2 * y * ds2) and dx, dw are the transposed convolutions.

The kernel is an implicit GEMM that takes any kernel size, stride and
padding and ragged sizes, so the JAX package's gates (Cin < 8, Cout % 64,
a power-of-two batch, 1x1 strides only, the VMEM budget) have no
counterpart: `supported` states the kernel's own limits, and
`conv2d_bn_stats` raises ValueError on what it refuses. The library's C
entry (`csrc/conv_bn_stats.cu`) routes by dtype: bfloat16 to the
tensor-core kernel (`csrc/conv_bn_stats_sm90.cu`: bf16 wgmma fed by TMA),
float32 to the FMA kernel beside the entry.

Dispatch is by the tensors' device: CPU tensors take the plain version
(`conv_bn_stats_plain`), CUDA tensors launch the kernel of their dtype or
raise. There is no fallback from one to the other. The float32 backward and the plain
version go through cuDNN on the card, in TF32 unless
`torch.backends.cudnn.allow_tf32` is False.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .context import resolve_device
from .cuda_ops import _KERNEL_DTYPES, _launch

# Launches of the kernel, counted by its wrapper where it launches; a run
# resets it to see whether its path used the kernel.
CONV_BN_STATS_LAUNCHES = 0
# Calls of the autograd Function on CPU tensors, which take the plain
# version: the CPU tests' view of the same path.
CONV_BN_STATS_PLAIN_CALLS = 0

# (H, Cin, Cout, K, stride, count): every conv feeding a BatchNorm in the
# ResNet-50 body (the 7x7 stem excluded), as in the JAX package's
# tools/bench_conv_bn.py; pad K // 2, square images and kernels.
RESNET50_CONVS = [
    (56, 64, 64, 1, 1, 1), (56, 64, 64, 3, 1, 3), (56, 64, 256, 1, 1, 3),
    (56, 256, 64, 1, 1, 2), (56, 256, 128, 1, 2, 1),
    (56, 256, 512, 1, 2, 1),
    (28, 128, 128, 3, 1, 4), (28, 128, 512, 1, 1, 4),
    (28, 512, 128, 1, 1, 3), (28, 512, 256, 1, 2, 1),
    (28, 512, 1024, 1, 2, 1),
    (14, 256, 256, 3, 1, 6), (14, 256, 1024, 1, 1, 6),
    (14, 1024, 256, 1, 1, 5), (14, 1024, 512, 1, 2, 1),
    (14, 1024, 2048, 1, 2, 1),
    (7, 512, 512, 3, 1, 3), (7, 512, 2048, 1, 1, 3),
    (7, 2048, 512, 1, 1, 2),
]

_INT_MAX = 2 ** 31 - 1
# the kernel's row index is an int and runs up to a tile past M; 1024 is
# above any tile height it uses
_M_LIMIT = _INT_MAX - 1024


def _out_size(size, k, s, p):
    return (size + 2 * p - k) // s + 1


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def supported(x_shape, w_shape, stride, pad, dtype):
    """Whether the CUDA kernel takes this conv: 4-D NHWC x and HWIO w,
    groups 1, float32 or bfloat16, stride >= 1, pad >= 0, a nonempty
    output, and every size, the output rows N*Ho*Wo and the depth
    kh*kw*Cin within the kernel's int indices. Shared memory does not
    depend on the shape."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, h, wd, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if wcin != cin:
        return False   # grouped conv
    if _dtype_name(dtype) not in ('float32', 'bfloat16'):
        return False
    (sh, sw), (ph, pw) = _pair(stride), _pair(pad)
    if min(n, h, wd, cin, kh, kw, cout, sh, sw) < 1 or min(ph, pw) < 0:
        return False
    if max(h + 2 * ph, wd + 2 * pw, cout) > _INT_MAX:
        return False
    ho, wo = _out_size(h, kh, sh, ph), _out_size(wd, kw, sw, pw)
    if ho < 1 or wo < 1:
        return False
    return n * ho * wo <= _M_LIMIT and kh * kw * cin <= _INT_MAX


def _conv_acc(x, w, stride, pad):
    """NHWC x HWIO conv in float32 (float64 for float64 inputs) of the
    upcast inputs, NHWC out."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2),
                 w.to(acc).permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_bn_stats_plain(x, w, stride=(1, 1), pad=(0, 0)):
    """Plain version of the kernel: the float32 conv of the upcast inputs,
    s1 and s2 summed from that float32 y, and y rounded to x's dtype, as
    pallas_conv._conv_bn_kernel sums its accumulator. Returns (y
    contiguous NHWC, s1, s2)."""
    yf = _conv_acc(x, w, _pair(stride), _pair(pad))
    return (yf.to(x.dtype).contiguous(), yf.sum((0, 1, 2)),
            (yf * yf).sum((0, 1, 2)))


def reference_conv_bn_stats(x, w, stride=(1, 1), pad=(0, 0)):
    """The unfused oracle of pallas_conv.reference_conv_bn_stats: the conv
    rounded to x's dtype, then the statistics of that rounded y. In
    bfloat16 it is not the kernel's function (the kernel sums before
    rounding); in float32 it is."""
    y = _conv_acc(x, w, _pair(stride), _pair(pad)).to(x.dtype)
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    return y.contiguous(), yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def _check_kernel_inputs(x, w, stride, pad):
    if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES:
        raise TypeError('conv + BN statistics kernel takes float32 or '
                        'bfloat16 x and w of one dtype; got %s, %s'
                        % (x.dtype, w.dtype))
    if not supported(tuple(x.shape), tuple(w.shape), stride, pad, x.dtype):
        raise ValueError('conv + BN statistics kernel does not take x %s, '
                         'w %s, stride %s, pad %s (see cuda_conv.supported)'
                         % (tuple(x.shape), tuple(w.shape), stride, pad))
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError('conv + BN statistics kernel takes contiguous NHWC '
                         'x and HWIO w')
    if x.device.type != 'cuda' or w.device != x.device:
        raise ValueError('conv + BN statistics kernel takes tensors on one '
                         'CUDA device; got %s and %s' % (x.device, w.device))


def _partials(m, cout, dtype, device):
    """Scratch for the kernel's per-tile statistics: (2, ceil(m / rows),
    cout) float32, rows the M-tile height of dtype's kernel."""
    rows = _build.library().mxt_conv_bn_stats_block_rows(
        _KERNEL_DTYPES[dtype])
    if rows < 1:
        raise TypeError('conv + BN statistics kernel has no %s route' % dtype)
    return torch.empty((2, -(-m // rows), cout), dtype=torch.float32,
                       device=device)


def conv_bn_stats_cuda(x, w, stride=(1, 1), pad=(0, 0)):
    """The kernel on contiguous CUDA tensors: NHWC x, HWIO w, both float32
    (the FMA kernel) or both bfloat16 (the tensor-core kernel). Returns
    (y, s1, s2)."""
    global CONV_BN_STATS_LAUNCHES
    stride, pad = _pair(stride), _pair(pad)
    _check_kernel_inputs(x, w, stride, pad)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho = _out_size(h, kh, stride[0], pad[0])
    wo = _out_size(wd, kw, stride[1], pad[1])
    dev = x.device
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=dev)
    s1 = torch.empty((cout,), dtype=torch.float32, device=dev)
    s2 = torch.empty((cout,), dtype=torch.float32, device=dev)
    part = _partials(n * ho * wo, cout, x.dtype, dev)
    _launch('mxt_conv_bn_stats', 'conv + BN statistics', x.data_ptr(),
            w.data_ptr(), y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            part.data_ptr(), n, h, wd, cin, cout, kh, kw, stride[0],
            stride[1], pad[0], pad[1], _KERNEL_DTYPES[x.dtype], device=dev)
    CONV_BN_STATS_LAUNCHES += 1
    return y, s1, s2


class _ConvBnStats(torch.autograd.Function):
    """(y, s1, s2) of the conv, differentiable in x and w through all three
    outputs: the custom VJP of pallas_conv.conv2d_bn_stats."""

    @staticmethod
    def forward(ctx, x, w, stride, pad):
        global CONV_BN_STATS_PLAIN_CALLS
        x, w = x.contiguous(), w.contiguous()
        if x.device.type == 'cpu':
            y, s1, s2 = conv_bn_stats_plain(x, w, stride, pad)
            CONV_BN_STATS_PLAIN_CALLS += 1
        else:
            y, s1, s2 = conv_bn_stats_cuda(x, w, stride, pad)
        ctx.save_for_backward(x, w, y)
        ctx.stride, ctx.pad = stride, pad
        # an unused output's cotangent arrives as None and adds nothing
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds1, ds2):
        x, w, y = ctx.saved_tensors
        # the statistics' gradients fold into dy, in float32, cast to y's
        # dtype (pallas_conv._bwd): d/dy (s1.ds1 + s2.ds2) = ds1 + 2 y ds2;
        # a cotangent that arrives as None adds nothing
        acc = torch.promote_types(y.dtype, torch.float32)
        tot = dy.to(acc) if dy is not None else torch.zeros(
            y.shape, dtype=acc, device=y.device)
        if ds1 is not None:
            tot = tot + ds1.to(acc)
        if ds2 is not None:
            tot = tot + 2.0 * y.to(acc) * ds2.to(acc)
        # the transposed convs, on NCHW / OIHW views of NHWC / HWIO
        dyn = tot.to(y.dtype).permute(0, 3, 1, 2)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                xn.shape, wn, dyn, ctx.stride,
                ctx.pad).permute(0, 2, 3, 1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                xn, wn.shape, dyn, ctx.stride,
                ctx.pad).permute(2, 3, 1, 0).contiguous()
        return dx, dw, None, None


def conv2d_bn_stats(x, w, stride=(1, 1), pad=(0, 0)):
    """Fused NHWC conv + per-channel (sum(y), sum(y * y)) in one pass.
    Counterpart of pallas_conv.conv2d_bn_stats: x (N, H, W, Cin), w (kh,
    kw, Cin, Cout), both float32 or both bfloat16. Returns (y, s1, s2),
    y (N, Ho, Wo, Cout) in x's dtype, s1 and s2 (Cout,) float32; mean and
    biased variance follow as s1 / m and s2 / m - mean^2, m = N*Ho*Wo.
    Differentiable in x and w."""
    stride, pad = _pair(stride), _pair(pad)
    if x.device != w.device:
        raise ValueError('conv2d_bn_stats: x and w on different devices: '
                         '%s, %s' % (x.device, w.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('conv2d_bn_stats runs on cuda or cpu tensors; got '
                         '%s' % x.device)
    if x.dtype != w.dtype or not supported(tuple(x.shape), tuple(w.shape),
                                           stride, pad, x.dtype):
        raise ValueError(
            'conv2d_bn_stats does not take x %s %s, w %s %s, stride %s, '
            'pad %s (see cuda_conv.supported)'
            % (tuple(x.shape), x.dtype, tuple(w.shape), w.dtype, stride, pad))
    return _ConvBnStats.apply(x, w, stride, pad)


def weight_from_jax(w_hwio, dtype=None, device=None):
    """A JAX HWIO conv weight, given as a numpy array, to a tensor on
    `device` in the same (kh, kw, Cin, Cout) layout: nothing is
    transposed. dtype None keeps the array's own."""
    device = resolve_device(device)
    t = torch.from_numpy(np.array(w_hwio))   # a writable copy
    if t.ndim != 4:
        raise ValueError('weight_from_jax takes a 4-D HWIO weight; got '
                         'shape %s' % (tuple(t.shape),))
    return t.to(device=device, dtype=dtype or t.dtype)
