"""Microbenchmark of the conv + BatchNorm-statistics kernel on the card:
the counterpart of tools/bench_conv_bn.py.

At every distinct conv feeding a BatchNorm in the ResNet-50 body
(`cuda_conv.RESNET50_CONVS`: 19 shapes, 51 convs by count), batch 256 in
bfloat16 unless told otherwise, it runs `cuda_conv.conv2d_bn_stats` once
for its result, holds that against the plain version, and times, with
CUDA events over a run of launches after a warm-up, queued behind a
spin of the card so that they run back to back (device time, not the
host's pace):

- kernel: the conv + statistics kernel (`cuda_conv.conv_bn_stats_cuda`;
  y is written to device memory): the tensor-core kernel in bfloat16,
  the FMA kernel in float32;
- library: the yardstick, cuDNN `F.conv2d` on channels-last tensors and
  the float32 sum and sum of squares of its output (the counterpart of
  the JAX tool's XLA column); timed only, never called by the port;
- cudnn: cuDNN's conv alone, the yardstick without its statistics;
- backward: the autograd Function's backward on the result call's graph
  (the statistics' cotangents folded into dy, then cuDNN's transposed
  convs for dx and dw), for seeded cotangents of y, s1 and s2;
- plain: the kernel's plain version (`cuda_conv.conv_bn_stats_plain`,
  a float32 cuDNN conv, in TF32 unless `torch.backends.cudnn.allow_tf32`
  is False; `main` sets it False);
- bound: the larger of the operations over the card's peak rate for the
  dtype and the bytes (x's pixels the conv reads, w and y, each once)
  over its memory rate.

It prints one line per shape and count-weighted totals. `run` returns
the rows and totals for a caller such as chip_smoke.py.

    python -m mxnet_tpu_torch.tools.bench_conv_bn [--batch 256]
        [--dtype bfloat16] [--device cuda:0]

It needs a CUDA device and fails without one.
"""
import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from .. import cuda_conv
from ..context import resolve_device

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
# timed launches a shape, after one warm-up: the kernel and the yardstick
# take 0.1-2 ms a launch at batch 256, the plain version up to 4 ms
ITERS, PLAIN_ITERS = 10, 3
SEED = 0
# clock cycles the card spins before a timed run (about 50 ms), so that
# the host has queued every launch of the run before the first starts and
# the events time the device alone, not the host's pace between launches
LEAD_CYCLES = 100_000_000


def conv_geometry(batch, h, cin, cout, k, stride):
    """(x shape, w shape, stride, pad) of one RESNET50_CONVS entry."""
    return ((batch, h, h, cin), (k, k, cin, cout), (stride, stride),
            (k // 2, k // 2))


def _touched(size, k, s, p):
    """Input positions along one axis that some output position reads."""
    out = cuda_conv._out_size(size, k, s, p)
    seen = set()
    for o in range(out):
        start = o * s - p
        seen.update(range(max(start, 0), min(start + k, size)))
    return len(seen)


def conv_bound(x_shape, w_shape, stride, pad, dtype_name):
    """Least time of one conv + statistics on the card: the x pixels the
    conv reads, w, y, s1 and s2 moved once, against the conv's
    2 * M * Cout * kh * kw * Cin operations and the statistics' 3 * M *
    Cout (M = N * Ho * Wo) at the dtype's peak rate. Returns dict(
    bound_ms, bound_by, bytes, flops)."""
    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    (sh, sw), (ph, pw) = stride, pad
    ho = cuda_conv._out_size(h, kh, sh, ph)
    wo = cuda_conv._out_size(wd, kw, sw, pw)
    m = n * ho * wo
    itemsize = 2 if dtype_name == 'bfloat16' else 4
    pixels = n * _touched(h, kh, sh, ph) * _touched(wd, kw, sw, pw)
    nbytes = (pixels * cin + kh * kw * cin * cout + m * cout) * itemsize \
        + 2 * cout * 4
    flops = 2.0 * m * cout * kh * kw * cin + 3.0 * m * cout
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bytes=nbytes, flops=flops)


def yardstick(x_cl, w_cl, stride, pad):
    """cuDNN's conv on channels-last NCHW views, then the float32 sum and
    sum of squares of its output per channel: what PyTorch offers for
    conv + BatchNorm statistics. Never called by the port."""
    y = F.conv2d(x_cl, w_cl, stride=stride, padding=pad)
    s1 = y.sum((0, 2, 3), dtype=torch.float32)
    s2 = torch.linalg.vector_norm(y, 2, (0, 2, 3),
                                  dtype=torch.float32).square()
    return y, s1, s2


def cuda_ms(fn, iters):
    """Mean device time of fn over iters launches, after one warm-up, the
    launches queued behind a spin of LEAD_CYCLES so that they run back to
    back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(y, s1, s2, ref):
    """The kernel's (y, s1, s2) against the plain version's: y's largest
    error and the share of its elements that differ, and each statistic's
    largest error over its scale (sum |y| for s1, sum y^2 for s2, from the
    plain version's y)."""
    py, p1, p2 = ref
    yf, pf = y.float(), py.float()
    err = (yf - pf).abs()
    scale1 = pf.abs().sum((0, 1, 2)).clamp_min(1e-30)
    scale2 = (pf * pf).sum((0, 1, 2)).clamp_min(1e-30)
    return dict(y_max_abs_err=float(err.max()),
                y_max_abs=float(pf.abs().max()),
                y_share_differ=float((err > 0).float().mean()),
                y_finite=bool(torch.isfinite(yf).all()),
                s1_err=float(((s1 - p1).abs() / scale1).max()),
                s2_err=float(((s2 - p2).abs() / scale2).max()))


def bench_shape(shape, batch, dtype, device, seed):
    """One RESNET50_CONVS entry on the current CUDA device: the result
    call's launches and errors, and the times beside the bound."""
    h, cin, cout, k, s, count = shape
    xs, ws, stride, pad = conv_geometry(batch, h, cin, cout, k, s)
    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(xs, generator=gen, device=device, dtype=tdtype)
    w = torch.randn(ws, generator=gen, device=device, dtype=tdtype) * 0.05

    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    xl, wl = x.requires_grad_(True), w.requires_grad_(True)
    y, s1, s2 = cuda_conv.conv2d_bn_stats(xl, wl, stride, pad)
    torch.cuda.synchronize()
    launches = cuda_conv.CONV_BN_STATS_LAUNCHES - before
    x, w = x.detach(), w.detach()
    errors = compare(y.detach(), s1.detach(), s2.detach(),
                     cuda_conv.conv_bn_stats_plain(x, w, stride, pad))
    cot = (torch.randn(y.shape, generator=gen, device=device, dtype=tdtype),
           torch.randn(s1.shape, generator=gen, device=device),
           torch.randn(s2.shape, generator=gen, device=device) * 0.1)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(
        (y, s1, s2), (xl, wl), cot, retain_graph=True), ITERS)
    del y, s1, s2, xl, wl, cot

    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    ms = cuda_ms(lambda: cuda_conv.conv_bn_stats_cuda(x, w, stride, pad),
                 ITERS)
    timed = cuda_conv.CONV_BN_STATS_LAUNCHES - before
    x_cl = x.permute(0, 3, 1, 2)        # NHWC memory: channels-last NCHW
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = cuda_ms(lambda: yardstick(x_cl, w_cl, stride, pad), ITERS)
    cudnn_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, stride=stride,
                                        padding=pad), ITERS)
    plain_ms = cuda_ms(lambda: cuda_conv.conv_bn_stats_plain(
        x, w, stride, pad), PLAIN_ITERS)
    bound = conv_bound(xs, ws, stride, pad, dtype)
    return dict(shape=[h, cin, cout, k, s], count=count, x=list(xs),
                w=list(ws), stride=list(stride), pad=list(pad), dtype=dtype,
                launches=launches, timed_launches=timed, ms=ms,
                library_ms=library_ms, cudnn_ms=cudnn_ms,
                backward_ms=backward_ms, plain_ms=plain_ms,
                tflops=bound['flops'] / ms / 1e9, **bound, **errors)


def run(batch=256, dtype='bfloat16', device=None, log=print):
    """Each shape of RESNET50_CONVS on `device` (default cuda:0), by
    `bench_shape`, each line of the report passed to `log`. Returns
    dict(rows, totals), totals weighted by each shape's count."""
    device = resolve_device(device)
    if device.type != 'cuda':
        raise RuntimeError('bench_conv_bn times the kernel on a CUDA '
                           'device; got %s' % device)
    rows = []
    with torch.cuda.device(device):
        for i, shape in enumerate(cuda_conv.RESNET50_CONVS):
            row = bench_shape(shape, batch, dtype, device, SEED + i)
            rows.append(row)
            log('%-24s kernel %8.4f ms  cudnn+stats %7.4f ms  cudnn %7.4f '
                'ms  backward %7.4f ms  plain %8.3f ms  bound %6.4f ms (%s)  '
                'x%d  s2 err %.1e'
                % (tuple(row['shape']), row['ms'], row['library_ms'],
                   row['cudnn_ms'], row['backward_ms'], row['plain_ms'],
                   row['bound_ms'], row['bound_by'], row['count'],
                   row['s2_err']))
    totals = {key: sum(r['count'] * r[key] for r in rows)
              for key in ('ms', 'library_ms', 'cudnn_ms', 'backward_ms',
                          'plain_ms', 'bound_ms', 'flops', 'bytes')}
    totals.update(convs=sum(r['count'] for r in rows), shapes=len(rows),
                  tflops=totals['flops'] / totals['ms'] / 1e9,
                  kernel_over_library=totals['ms'] / totals['library_ms'],
                  kernel_over_bound=totals['ms'] / totals['bound_ms'])
    log('TOTAL (count-weighted, %d convs): kernel %.3f ms, cudnn+stats '
        '%.3f ms, cudnn %.3f ms, backward %.3f ms, plain %.3f ms, bound '
        '%.3f ms; kernel %.1f TFLOP/s'
        % (totals['convs'], totals['ms'], totals['library_ms'],
           totals['cudnn_ms'], totals['backward_ms'], totals['plain_ms'],
           totals['bound_ms'], totals['tflops']))
    return dict(rows=rows, totals=totals)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    ap.add_argument('--device', default=None,
                    help='a CUDA device (default cuda:0)')
    args = ap.parse_args(argv)
    # float32 convs and products in full float32 (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    if device.type != 'cuda':
        raise SystemExit('bench_conv_bn: needs a CUDA device; got %s' % device)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print('device: %s | %s | batch %d %s, cudnn.allow_tf32 False'
          % (torch.cuda.get_device_name(device), smi, args.batch,
             args.dtype))
    result = run(args.batch, args.dtype, device)
    print(json.dumps(result['totals']))


if __name__ == '__main__':
    main()
