"""Spatial and vision ops: the counterpart of mxnet_tpu/ops/spatial.py
over torch tensors: GridGenerator, BilinearSampler, SpatialTransformer,
ROIPooling, Correlation and Correlation1D (reference
src/operator/{grid_generator,bilinear_sampler,spatial_transformer,
roi_pooling,correlation}-inl.h).

Sampling is the JAX package's: gathers at floor(x) and floor(y) with
bilinear weights, zeros outside the image. ROIPooling keeps the JAX
package's bins step by step (roi corners rounded half to even, bins
from floor and ceil, empty bins 0) but takes each bin's max from a 2-D
sparse table of range maxima, so that 300 rois over a 512-channel map
need no (rois, channels, H, W) gather; a max is exact, so the values
are the JAX package's.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register, astuple, asbool, asint, asfloat
from ..base import parse_attr_value


def exact_div(x, d):
    """x / d, a true division on every device: CUDA multiplies by the
    reciprocal of a Python scalar divisor, an ulp away from the quotient,
    and a floor or ceil after it would then pick another pixel."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# GridGenerator
# ---------------------------------------------------------------------------

def _linspace(n, dtype, device):
    """jnp.linspace(-1, 1, n): -1 (1 - i/(n-1)) + i/(n-1), the last 1."""
    if n <= 1:
        return torch.zeros((n,), dtype=dtype, device=device)
    step = exact_div(torch.arange(n - 1, dtype=dtype, device=device), n - 1)
    return torch.cat([-1.0 * (1 - step) + step,
                      torch.ones((1,), dtype=dtype, device=device)])


def _regular_grid(h, w, dtype, device):
    """The normalised sampling grid in [-1, 1]: (x, y), each (h, w)."""
    ys = _linspace(h, dtype, device)
    xs = _linspace(w, dtype, device)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    return gx, gy


def _affine_grid(theta, h, w):
    """theta (N, 2, 3) over the regular grid -> (N, 2, h, w), as
    elementwise products and sums (the same bits on every device)."""
    gx, gy = _regular_grid(h, w, theta.dtype, theta.device)
    t = theta[:, :, :, None, None]
    return t[:, :, 0] * gx + t[:, :, 1] * gy + t[:, :, 2]


@register('GridGenerator', input_names=('data',), hint='gridgenerator')
def _grid_generator(attrs, data):
    ttype = str(parse_attr_value(attrs['transform_type']))
    if ttype == 'affine':
        h, w = astuple(attrs['target_shape'], 2)
        return _affine_grid(data.reshape(data.shape[0], 2, 3), h, w)
    # 'warp': data is a flow field (n, 2, h, w) in pixels
    _, _, h, w = data.shape
    gx, gy = _regular_grid(h, w, data.dtype, data.device)
    fx = exact_div(data[:, 0] * 2.0, max(w - 1, 1))
    fy = exact_div(data[:, 1] * 2.0, max(h - 1, 1))
    return torch.stack([gx[None] + fx, gy[None] + fy], 1)


# ---------------------------------------------------------------------------
# BilinearSampler and SpatialTransformer
# ---------------------------------------------------------------------------

def _bilinear_sample(data, grid):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) normalised to [-1, 1] ->
    (N, C, Ho, Wo); samples outside the image read 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    bidx = torch.arange(n, device=data.device)[:, None, None]

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        v = data[bidx, :, yc, xc].permute(0, 3, 1, 2)   # (N, C, Ho, Wo)
        return v * inb.to(data.dtype)[:, None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
            v10 * (1 - wx) * wy + v11 * wx * wy)


@register('BilinearSampler', input_names=('data', 'grid'),
          hint='bilinearsampler')
def _bilinear_sampler(attrs, data, grid):
    return _bilinear_sample(data, grid)


def _st_infer_shape(attrs, in_shapes):
    if len(in_shapes) > 1 and in_shapes[1] is None and \
            in_shapes[0] is not None:
        in_shapes[1] = (in_shapes[0][0], 6)
    return in_shapes


@register('SpatialTransformer', input_names=('data', 'loc'),
          infer_shape=_st_infer_shape, hint='spatialtransformer')
def _spatial_transformer(attrs, data, loc):
    h, w = astuple(attrs['target_shape'], 2)
    grid = _affine_grid(loc.reshape(data.shape[0], 2, 3), h, w)
    return _bilinear_sample(data, grid)


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

def range_max_table(x):
    """The 2-D sparse table of x (N, C, H, W): (KH, KW, N, C, H, W) where
    [kh, kw, n, c, i, j] is the max of x[n, c, i:i + 2^kh, j:j + 2^kw]
    (-inf past the edge)."""
    n, c, h, w = x.shape
    kh_n = int(math.floor(math.log2(max(h, 1)))) + 1
    kw_n = int(math.floor(math.log2(max(w, 1)))) + 1
    neg = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    rows = [x]
    for k in range(1, kh_n):
        s = 1 << (k - 1)
        prev = rows[-1]
        rows.append(torch.cat([torch.maximum(prev[:, :, :h - s],
                                             prev[:, :, s:]),
                               neg.expand(n, c, s, w)], dim=2))
    table = []
    for base in rows:
        cols = [base]
        for k in range(1, kw_n):
            s = 1 << (k - 1)
            prev = cols[-1]
            cols.append(torch.cat([torch.maximum(prev[..., :w - s],
                                                 prev[..., s:]),
                                   neg.expand(n, c, h, s)], dim=3))
        table.append(torch.stack(cols))
    return torch.stack(table)


def range_max(table, batch, hs, he, ws, we):
    """The max of x[batch, :, hs:he, ws:we] from range_max_table(x), for
    long index tensors of one broadcast shape S; -> S + (C,). Each range
    must be nonempty."""
    _, _, _, _, h, w = table.shape
    # floor(log2(length)) by table, in integers
    lut = torch.tensor([max(i.bit_length() - 1, 0)
                        for i in range(max(h, w) + 1)], device=hs.device)
    kh = lut[he - hs]
    kw = lut[we - ws]
    h2 = he - (1 << kh)
    w2 = we - (1 << kw)
    return torch.maximum(
        torch.maximum(table[kh, kw, batch, :, hs, ws],
                      table[kh, kw, batch, :, hs, w2]),
        torch.maximum(table[kh, kw, batch, :, h2, ws],
                      table[kh, kw, batch, :, h2, w2]))


@register('ROIPooling', input_names=('data', 'rois'), hint='roipooling')
def _roi_pooling(attrs, data, rois):
    ph, pw = astuple(attrs['pooled_size'], 2)
    scale = asfloat(attrs['spatial_scale'])
    _, _, h, w = data.shape
    dt, dev = data.dtype, data.device
    batch = rois[:, 0].to(torch.int32).long()
    # the reference rounds the roi's corners to the integer grid
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    bin_h = exact_div(torch.clamp(y2 - y1 + 1.0, min=1.0), ph)
    bin_w = exact_div(torch.clamp(x2 - x1 + 1.0, min=1.0), pw)
    pi = torch.arange(ph, dtype=dt, device=dev)
    pj = torch.arange(pw, dtype=dt, device=dev)
    # bin [start, end): floor(p bin) + y1 .. ceil((p + 1) bin) + y1
    hstart = torch.clamp(torch.floor(pi[None] * bin_h[:, None]) +
                         y1[:, None], 0, h)              # (R, PH)
    hend = torch.clamp(torch.ceil((pi[None] + 1) * bin_h[:, None]) +
                       y1[:, None], 0, h)
    wstart = torch.clamp(torch.floor(pj[None] * bin_w[:, None]) +
                         x1[:, None], 0, w)              # (R, PW)
    wend = torch.clamp(torch.ceil((pj[None] + 1) * bin_w[:, None]) +
                       x1[:, None], 0, w)
    hs, he = hstart.long()[:, :, None], hend.long()[:, :, None]
    ws, we = wstart.long()[:, None, :], wend.long()[:, None, :]
    empty = (he <= hs) | (we <= ws)                      # (R, PH, PW)
    # an empty bin reads a one-pixel range in bounds, then pools to 0
    hs_c = torch.clamp(hs, max=h - 1)
    ws_c = torch.clamp(ws, max=w - 1)
    he_c = torch.maximum(he, hs_c + 1)
    we_c = torch.maximum(we, ws_c + 1)
    out = range_max(range_max_table(data), batch[:, None, None], hs_c,
                    he_c, ws_c, we_c)                     # (R, PH, PW, C)
    out = torch.where(empty[..., None], torch.zeros((), dtype=dt,
                                                    device=dev), out)
    return out.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# Correlation (FlowNet) and Correlation1D
# ---------------------------------------------------------------------------

@register('Correlation', input_names=('data1', 'data2'), hint='correlation')
def _correlation(attrs, data1, data2):
    kernel = asint(attrs.get('kernel_size', 1))
    max_disp = asint(attrs.get('max_displacement', 1))
    stride1 = asint(attrs.get('stride1', 1))
    stride2 = asint(attrs.get('stride2', 1))
    pad = asint(attrs.get('pad_size', 0))
    is_mult = asbool(attrs.get('is_multiply', True))

    _, c, h, w = data1.shape
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    ph, pw = h + 2 * pad, w + 2 * pad
    border = max_disp + kernel // 2
    out_h = int(np.ceil((ph - 2 * border) / float(stride1)))
    out_w = int(np.ceil((pw - 2 * border) / float(stride1)))
    krad = kernel // 2
    ys = border + torch.arange(out_h, device=data1.device) * stride1
    xs = border + torch.arange(out_w, device=data1.device) * stride1
    outs = []
    for dy in range(-(max_disp // stride2), max_disp // stride2 + 1):
        for dx in range(-(max_disp // stride2), max_disp // stride2 + 1):
            oy, ox = dy * stride2, dx * stride2
            acc = 0.0
            for ky in range(-krad, krad + 1):
                for kx in range(-krad, krad + 1):
                    a = p1[:, :, ys[:, None] + ky, xs[None] + kx]
                    b = p2[:, :, ys[:, None] + ky + oy, xs[None] + kx + ox]
                    acc = acc + (a * b if is_mult else torch.abs(a - b))
            outs.append(acc.sum(dim=1))
    out = torch.stack(outs, dim=1)          # (N, grid*grid, out_h, out_w)
    return exact_div(out, c * kernel * kernel)


@register('Correlation1D', input_names=('data1', 'data2'),
          hint='correlation1d')
def _correlation1d(attrs, data1, data2):
    """The stereo cost volume: correlation with displacements along the
    width only (reference correlation1D.cu). single_side 0 takes
    [-r, r], -1 [-w, -1], 1 [0, w-1]; averaged over kernel^2 C."""
    kernel = asint(attrs.get('kernel_size', 1))
    max_disp = asint(attrs.get('max_displacement', 1))
    stride1 = asint(attrs.get('stride1', 1))
    stride2 = asint(attrs.get('stride2', 1))
    pad = asint(attrs.get('pad_size', 0))
    single_side = asint(attrs.get('single_side', 0))

    _, c, h, w = data1.shape
    # width-only padding (correlation1D.cc)
    p1 = F.pad(data1, (pad, pad))
    p2 = F.pad(data2, (pad, pad))
    pw = w + 2 * pad
    krad = kernel // 2
    border = max_disp + krad
    out_h = int(np.ceil((h - 2 * krad) / float(stride1)))
    out_w = int(np.ceil((pw - 2 * border) / float(stride1)))
    radius = max_disp // stride2
    if single_side == 0:
        grid_w = 2 * radius + 1
        x_shift = -radius
    else:
        grid_w = radius + 1
        x_shift = -grid_w if single_side == -1 else 0
    dev = data1.device
    ys = torch.arange(out_h, device=dev) * stride1
    xs = max_disp + torch.arange(out_w, device=dev) * stride1
    outs = []
    for tc in range(grid_w):
        s2o = (tc + x_shift) * stride2
        acc = 0.0
        for ky in range(kernel):
            for kx in range(kernel):
                a = p1[:, :, ys[:, None] + ky, xs[None] + kx]
                xb = xs[None] + kx + s2o
                b = p2[:, :, ys[:, None] + ky, torch.clamp(xb, 0, pw - 1)]
                valid = ((xb >= 0) & (xb < pw)).to(a.dtype)
                acc = acc + (a * b) * valid
        outs.append(acc.sum(dim=1))
    out = torch.stack(outs, dim=1)            # (N, grid_w, out_h, out_w)
    return exact_div(out, c * kernel * kernel)
