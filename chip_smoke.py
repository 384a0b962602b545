#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --forward-case lm    # build, one case of phase 2
    python3 chip_smoke.py --backward-case lm   # build, one case of phase 4
    python3 chip_smoke.py --conv-case main     # build, one case of phase 6
    python3 chip_smoke.py --phases 7,8         # build, phases 7 and 8 only
    python3 chip_smoke.py --mutants            # phases 2, 4 and 6 against
                                               # broken kernels

Phases, each of which exits non-zero on failure:

1. build: compile every kernel from mxnet_tpu_torch/csrc with nvcc; the
   SASS of every instance of the tensor-core kernels (SM90_KERNELS), in
   bf16 and float16, must hold HGMMA, and ptxas must report no
   serialised wgmma (C7520);
2. kernels: launch the forward kernel on the card at the LM's shapes in
   bf16 and float16 (and decode-shaped cases, a ragged float32 one,
   head_dim 192, a ragged head_dim 100 in both dtypes, and head_dim 320),
   hold it against its plain PyTorch version (16-bit: the online
   recurrence at the kernel's 64-key tile, element by element, the same
   bits on a second launch), and time it beside its bound, the plain
   version and, where one exists, one PyTorch call that computes the
   same function;
3. lm: the transformer LM forward at GPT-2-medium width (vocab 50257,
   dim 1024, 16 heads, 24 layers, bf16, seeded random weights) answers
   four requests of 8 x 1024 tokens on the flash kernel; the launch
   count must rise by one per layer per request, the logits must be
   finite, the mean NLL near ln(vocab), and one request must agree with
   the same model on plain attention; then the same check for one
   request at dim 768 with 4 heads (head_dim 192) and 2 layers, and for
   one request in float16 at full width and 4 layers;
4. backward kernels: launch the dK/dV and dQ kernels on the card at the
   shapes of phase 2 (and a rectangular float32 case with a nonzero lse
   cotangent), hold each against its plain PyTorch version element by
   element, check that the autograd Function gives the kernels'
   gradients, and time each beside its bound, its plain version and the
   backward of scaled_dot_product_attention;
5. train: the train step at the widths of phase 3, bf16, on one batch
   of 8 x 1024 tokens. Every parameter's gradient must be finite and
   nonzero on the flash path and on plain attention and agree between
   the two; then a warm-up step, whose update must be w - lr * g, and
   four timed steps, each of which must launch the forward, dK/dV and
   dQ kernels once per layer; a torch.profiler breakdown of one step;
   then one float16 step at full width and 4 layers, whose gradients
   must agree with plain attention's and which must launch each kernel
   once per layer; last, five float32 steps at full width and 4 layers
   on one batch, whose loss must fall;
6. conv + BatchNorm statistics: the kernel against its plain version,
   element by element, at the main ResNet-50 shape (3x3, 64 -> 64 at
   56^2, batch 256, bf16), a strided 1x1, a ragged float32 case and a
   stem-like 7x7 stride-2 one, and the same bits on a second run; the autograd Function's dx and dw
   against the fold of the statistics' cotangents and the transposed
   convs on the plain version's y; then the bench path
   (mxnet_tpu_torch.tools.bench_conv_bn) over all 19 conv shapes of the
   ResNet-50 body at batch 256 in bf16, each of whose result calls must
   launch the kernel once, timed beside its bound, its plain version and
   cuDNN's conv with the statistics summed after it;
7. the NDArray core: every op that mxnet_tpu_torch/ops/tensor.py
   registers (aliases included) runs once on gpu(0) and once on cpu(0)
   on the same seeded float32 inputs, n x n = 1024 x 1024 where it takes
   a matrix, and the two must agree (tools/op_consistency.py: exact for
   data movement and integer results, rtol 1e-5 / atol 1e-6 for
   elementwise float math, rtol 1e-4 for reductions and products, TF32
   off); each sampler of mx.random on gpu(0), its mean and variance
   within 5 standard errors of its distribution's; then the host time
   of one small nd op beside the same torch call;
8. mx.rtc: each RTC_CASES kernel, CUDA source compiled by NVRTC for
   sm_90a, pushed on gpu(0) and held against its plain version; a second
   push at the same key compiles nothing; saxpy1 timed beside its bound,
   its plain version and torch.addcmul; then the imperative training
   loop (logistic regression under autograd.record() with the SGD step
   through sgd_update's Rtc), whose accuracy must pass 0.9 in 100 steps,
   each launching the kernel once.

It prints one JSON line with every kernel's numbers, then the card's
name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. It imports neither JAX nor mxnet_tpu, and
needs a CUDA device and the repository beside it.

--mutants builds each of FWD_MUTANTS and BWD_MUTANTS (a rounding left
out, a tile skipped, the causal mask widened, the forward's running
correction left out) and CONV_MUTANTS (a tap skipped, the padding one
pixel off, one M tile's statistics left out) in a copy of the port
under build/mutants/ and fails unless phase 2's LM case fails every
forward mutant, phase 4's LM case every backward mutant, phase 6's main
case every conv mutant, and the unchanged copy passes all three.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 and fp16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}

GPT2_MEDIUM = dict(vocab=50257, dim=1024, heads=16, layers=24, mlp_mult=4)
BATCH, SEQ, REQUESTS = 8, 1024, 4

# the float32 forward kernel against its plain version, max |difference|
# allowed: the JAX package's own flash tolerance (tests/test_parallel.py);
# lse is float32 from the same inputs in both.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_TOL = {'float32': dict(rtol=2e-4, atol=2e-5),
           'bfloat16': dict(rtol=0.0, atol=1e-3),
           'float16': dict(rtol=0.0, atol=1e-3)}
# the 16-bit forward kernel against the online plain version at its
# 64-key tile (cuda_ops.flash_attention_online_reference), element by
# element, as BWD_TOL below: both round p to v's type before P.V and the
# output to q's, so they differ only where another fp32 summing order of
# s or of P.V moves a value across a rounding: one 16-bit step of the
# value plus 1e-3 of the largest. The share that differs at all is set
# from a CPU emulation of that order (s summed in 16-product blocks as
# the tensor cores add; `python tests/test_torch_flash_forward_sm90.py`):
# 0.04-0.11 % of bf16 outputs, but 0.96 % of float16 ones at
# (1, 8, 512, 64) and 2.98 % at decode, since a float16 step is 8 times
# finer; p left unrounded moves over 37 % in both.
FWD_TOL = {'bfloat16': dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3,
                            differ=1e-2),
           'float16': dict(rtol=2.0 ** -10, atol=0.0, atol_of_max=1e-3,
                           differ=0.1)}
# the kernel's key tile (BN in csrc/flash_attention_sm90.cu)
FWD_BLOCK_K = 64
# flash against plain attention through 24 bf16 layers: logits of size
# up to about 4, where a bf16 step is 1/32
LM_LOGIT_ATOL = 0.125
LM_NLL_ATOL = 5e-3
# a backward kernel against its plain version, element by element:
# |got - ref| <= rtol * |ref| + atol + atol_of_max * max|ref|, and at
# most a share `differ` of the elements may differ at all. float32 at
# the JAX package's flash-gradient tolerance (tests/test_parallel.py);
# every element may differ there, in the last bits of another summing
# order. bfloat16: the kernel and its plain version take the same
# roundings (p and ds to bf16 before their products, the gradient on
# output), so they differ only where another fp32 summing order moves a
# value across a bf16 rounding: one bf16 step of the value (2^-7 of it
# at most), plus 1e-3 of the largest gradient for elements near 0 and
# for a flipped rounding of one p or ds. Such flips are rare, under
# 0.1 % of the elements when the sums run in float64 instead, while a
# missing rounding of p or ds moves over 30 % of its gradient by a step
# (both emulated on the CPU in tests/test_torch_flash_backward.py), so
# at most 1 % may differ.
# float16: one float16 step, and at most 5 %: the same emulation moves
# 0.3-0.7 % of float16 gradients, where a rounding left out moves 40 %
# (tests/test_torch_flash_forward_sm90.py, the backward's emulation).
BWD_TOL = {'float32': dict(rtol=2e-4, atol=2e-5, atol_of_max=0.0,
                           differ=1.0),
           'bfloat16': dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3,
                            differ=1e-2),
           'float16': dict(rtol=2.0 ** -10, atol=0.0, atol_of_max=1e-3,
                           differ=5e-2)}
# the LM's gradients on the flash kernels against plain attention, both
# bf16, as ||g_flash - g_plain|| / ||g_plain|| per parameter: plain
# attention rounds its scores and softmax to bf16 (2^-8) where the
# kernels keep fp32, and those differences add through 24 layers of
# backward (0.018 at most on an H100 at this seed, about five bf16
# steps); a gradient that is cut or wrong gives about 1
GRAD_REL_TOL = 0.05
TRAIN_STEPS = 4
LR = 0.1                 # the JAX package's make_train_step default
FP32_LAYERS, FP32_STEPS = 4, 5

# phase 2: name -> (q shape, kv length, dtype, iterations), all causal.
# 16-bit runs on the tensor-core kernel, float32 on the FMA one: the LM's
# shape and decode (a 64-row tile of which 48 rows are padding) in both
# 16-bit types, a ragged float32 one, head_dim 192 (column groups of 128
# and 64), a ragged head_dim of 100 (not a multiple of 8: plain loads
# instead of TMA) in both kernels, and head_dim 320 in both (the
# contraction in chunks of 128; column groups of 256 in the FMA kernel)
FWD_CASES = {
    'lm': ((BATCH, 16, SEQ, 64), SEQ, 'bfloat16', 20),
    'lm_f16': ((BATCH, 16, SEQ, 64), SEQ, 'float16', 20),
    'decode': ((BATCH, 16, 16, 64), SEQ, 'bfloat16', 50),
    'decode_f16': ((BATCH, 16, 16, 64), SEQ, 'float16', 50),
    'ragged_f32': ((2, 4, 1000, 128), 1000, 'float32', 20),
    'head192': ((BATCH, 4, SEQ, 192), SEQ, 'bfloat16', 10),
    'head100_f32': ((2, 3, 300, 100), 300, 'float32', 20),
    'head100': ((2, 3, 300, 100), 300, 'bfloat16', 20),
    'head320': ((2, 4, 512, 320), 512, 'bfloat16', 10),
    'head320_f32': ((1, 2, 200, 320), 200, 'float32', 10),
}
# phase 4: name -> (q shape, kv length, dtype, lse cotangent, iterations),
# all causal. 16-bit runs on the tensor-core kernels, float32 on the FMA
# ones: the LM's shape (bf16 and float16), decode, head_dim 192 (groups of
# 128 and 64), a ragged head_dim of 100 (plain loads instead of TMA;
# columns padded to 112; bf16 and float16), rectangular with an lse
# cotangent, head_dim 320 (the contraction in chunks of 128), and float32
# cases of each kind
BWD_CASES = {
    'lm': ((BATCH, 16, SEQ, 64), SEQ, 'bfloat16', False, 10),
    'lm_f16': ((BATCH, 16, SEQ, 64), SEQ, 'float16', False, 10),
    'decode': ((BATCH, 16, 16, 64), SEQ, 'bfloat16', False, 20),
    'ragged_f32': ((2, 4, 1000, 128), 1000, 'float32', False, 10),
    'rect_glse_f32': ((2, 4, 300, 64), 700, 'float32', True, 10),
    'head192': ((BATCH, 4, SEQ, 192), SEQ, 'bfloat16', False, 5),
    'head100_f32': ((2, 3, 300, 100), 300, 'float32', False, 10),
    'head100': ((2, 3, 300, 100), 300, 'bfloat16', False, 10),
    'head100_f16': ((2, 3, 300, 100), 300, 'float16', False, 10),
    'rect_glse': ((2, 4, 300, 64), 700, 'bfloat16', True, 10),
    'head320': ((2, 4, 512, 320), 512, 'bfloat16', False, 5),
    'head320_f32': ((1, 2, 200, 320), 200, 'float32', False, 5),
}
# output columns of one block of the backward kernels: the tensor-core
# (16-bit) kernels' groups, the FMA (float32) kernels' groups
BWD_GROUP = {'bfloat16': 128, 'float16': 128, 'float32': 256}
# phase 3's second model: head_dim 192 through the whole LM
LM_WIDE_HEADS = dict(GPT2_MEDIUM, dim=768, heads=4, layers=2)
# phases 3 and 5 in float16: full width, cut depth. The train step's
# embedding is drawn at std 0.05, not 0.02: at 0.02 the activations'
# mean square (4e-4) makes RMSNorm's backward overflow float16
# (rsqrt(var)^3 = 1.25e5 > 65504) into NaN gradients, in the JAX package
# as in the port (tests/test_torch_flash_forward_sm90.py), on either
# attention path; at 0.05 (8e3) every gradient is finite.
# The flash and plain gradients are compared on the loss times
# F16_LOSS_SCALE, as float16 training scales its loss (torch.amp's
# GradScaler): the loss is a mean over 8192 tokens, and without the scale
# most of layer 0's float16 gradients fall below float16's smallest normal
# (6.1e-5), where each path rounds them to a few bits and the two differ
# by 7.55 % in relative norm (an H100 run of this script), with no kernel
# at fault (the plain versions alone on the CPU:
# `python tests/test_torch_flash_forward_sm90.py`).
F16_LAYERS = 4
F16_EMBED_STD = 0.05
F16_LOSS_SCALE = 2.0 ** 12
# --mutants: edits of csrc/flash_attention_bwd_sm90.cu (text,
# replacement), the kernels of phase 4's bf16 LM case, each of which that
# case must catch: p or ds rounded toward zero (fp32 bits cut to bf16), the
# first q tile of dK/dV or the last k tile of dQ skipped, the causal mask
# one key wide
_TRUNCATE = ('[](float lo, float hi) { return (__float_as_uint(lo) >> 16) | '
             '(__float_as_uint(hi) & 0xffff0000u); }(')
BWD_MUTANTS = {
    'p_truncated': ('pt[ks][i] = pack2_rn<T16>(', 'pt[ks][i] = ' + _TRUNCATE),
    'dkdv_ds_truncated': ('dst[ks][i] = pack2_rn<T16>(',
                          'dst[ks][i] = ' + _TRUNCATE),
    'dq_ds_truncated': ('ds[ks][i] = pack2_rn<T16>(',
                        'ds[ks][i] = ' + _TRUNCATE),
    'dkdv_q_tile_skipped': ('max(r0 - offset, 0) / BN : 0;',
                            'max(r0 - offset, 0) / BN + 1 : 0;'),
    'dq_k_tile_skipped': ('return make_int2(0, last + 1);',
                          'return make_int2(0, last);'),
    'mask_one_key_wide': ('k <= q + offset)', 'k <= q + offset + 1)'),
}
# --mutants: edits of csrc/flash_attention_sm90.cu, the kernel of phase
# 2's bf16 LM case, each of which that case must catch: p rounded toward
# zero, the running correction of acc left out, the last live k tile (the
# diagonal's) skipped, the causal mask one key wide
FWD_MUTANTS = {
    'fwd_p_truncated': ('pa[ks][i] = pack2_rn<T16>(',
                        'pa[ks][i] = ' + _TRUNCATE),
    'fwd_correction_left_out': ('e < 2; ++e) acc[4 * j + 2 * h + e] *= corr;',
                                'e < 2; ++e) (void)corr;'),
    'fwd_last_tile_skipped': ('const int last = last_k_tile(r0, p);',
                              'const int last = last_k_tile(r0, p) - 1;'),
    'fwd_mask_one_key_wide': ('(!p.causal || k <= q + offset));',
                              '(!p.causal || k <= q + offset + 1));'),
}
# the tensor-core kernels, every instance of which (bf16 and float16) must
# hold tensor-core instructions (HGMMA) in its SASS
SM90_KERNELS = ('flash_fwd_sm90', 'flash_bwd_dkdv_sm90', 'flash_bwd_dq_sm90')
# a 16-bit type as it appears in a mangled instance name
SM90_TYPES = {'bfloat16': '__nv_bfloat16', 'float16': '6__half'}

# phase 6: name -> (x NHWC, w HWIO, stride, pad, dtype): the main
# ResNet-50 shape, a strided 1x1 of the ResNet-50 body, a ragged float32
# case (M = 507 and Cout = 96 fill no tile, Cin = 24 no chunk), and a
# stem-like 7x7 stride-2 conv on a non-square image whose Cin = 3 and
# Cout = 30 take the kernel's element-wise loads and stores
CONV_BATCH = 256
CONV_CASES = {
    'main': ((CONV_BATCH, 56, 56, 64), (3, 3, 64, 64), (1, 1), (1, 1),
             'bfloat16'),
    'strided': ((CONV_BATCH, 56, 56, 256), (1, 1, 256, 512), (2, 2), (0, 0),
                'bfloat16'),
    'ragged_f32': ((3, 13, 13, 24), (3, 3, 24, 96), (1, 1), (1, 1),
                   'float32'),
    'odd_bf16': ((2, 15, 17, 3), (7, 7, 3, 30), (2, 2), (3, 3), 'bfloat16'),
}
CONV_GRAD_CASE = 'strided'
# the conv's y against its plain version, element by element. bf16: both
# round the same fp32 sum of the same products, taken in another order,
# so they differ only where that order moves a value across a rounding:
# one bf16 step of the value (2^-7 of it at most), plus 1e-3 of the
# largest for values near 0, and at most 1 % of the elements may differ
# at all (a tap skipped or the padding moved changes most of them).
# float32: two summing orders of the K = kh*kw*Cin products each lie
# within K * 2^-24 of the sum of the products' magnitudes, (|x| conv |w|)
# at that element, so |got - ref| <= 2 * K * 2^-24 * (|x| conv |w|).
CONV_Y_TOL = dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3, differ=1e-2)
CONV_F32_ORDERS = 2
# s1 and s2 against the plain version's, relative to sum |y| and sum y^2
# per channel: the kernel's longest chain of float32 additions (8 rows, 16
# row groups, a 128-row tile's partials in 8 groups of up to 784 at
# batch 256, 8 groups) is under 1,024 adds, so it lies within 2^-14 of
# the exact sum on that scale, and the plain version's tree sums closer.
# One 128-row tile of 802,816 left out moves s2 by about 1.6e-4 of it.
CONV_STATS_RTOL = 2.0 ** -14
# --mutants: edits of csrc/conv_bn_stats.cu, each of which phase 6's main
# case must catch
CONV_MUTANTS = {
    'conv_tap_skipped': ('wi >= 0 && wi < s.w;',
                         'wi >= 0 && wi < s.w && tap != taps / 2;'),
    'conv_pad_off_by_one': ('const int hbase = ho * s.sh - s.ph;',
                            'const int hbase = ho * s.sh - s.ph + 1;'),
    'conv_partial_left_out': (
        'for (int b = g; b < m_tiles; b += FIN_GROUPS) {',
        'for (int b = g; b < m_tiles; b += FIN_GROUPS) {'
        ' if (b == m_tiles / 2) continue;'),
}

ALL_PHASES = frozenset(range(2, 9))
# phase 7: the imperative NDArray path's size (n x n inputs)
ND_SIZE = 1024
ND_HOST_CALLS = 2000
# draws of each sampler on the card, held to its mean and variance
# within 5 standard errors
ND_SAMPLES = 1 << 20

# phase 8: the kernels of mx.rtc's path, CUDA bodies compiled by NVRTC,
# each beside its plain PyTorch version (`rtc_plain`). name -> inputs,
# outputs, dtype, shape on the card, and the largest difference from the
# plain version allowed, in units in the last place of the plain value:
# - ref_exp, the reference's GPU test kernel (tests/python/gpu/test_rtc.py):
#   one block of 10 threads through shared memory, y = expf(5 x); x * 5.0
#   is exact in double, so the two differ only by their expf (CUDA's is
#   within 2 ulp);
# - saxpy1, the JAX test's function (tests/test_observability.py), over
#   2^26 elements with a grid-stride loop; NVRTC contracts x * y + 1.0f to
#   one FMA, rounded once, where the plain version rounds x * y and then
#   the sum: the two may differ by 1 ulp of the result plus half an ulp of
#   x * y (`rtc_slack`), which is many ulps of a result near 0;
# - dbl2d, a 2-D bf16 kernel over (3000, 1000) on a 2-D grid of 32 x 16
#   blocks whose edge blocks are ragged in both dimensions, guarded by
#   x_dims[]; doubling is exact;
# - sgd_update, w = w - lr g in place (outs=[w]), with __fmul_rn and
#   __fsub_rn, which NVRTC never contracts, so it rounds as the plain
#   version does and must be exact. RTC_LR is the 0.1f in its body.
RTC_LR = 0.1
RTC_CASES = {
    'ref_exp': dict(ins=('x',), outs=('y',), dtype='float32', shape=(10,),
                    ulp=2, body="""
    __shared__ float s_rec[10];
    s_rec[threadIdx.x] = x[threadIdx.x];
    y[threadIdx.x] = expf(s_rec[threadIdx.x] * 5.0);"""),
    'saxpy1': dict(ins=('x', 'y'), outs=('out',), dtype='float32',
                   shape=(1 << 26,), ulp=1, body="""
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < x_dims[0]; i += (long long)blockDim.x * gridDim.x)
      out[i] = x[i] * y[i] + 1.0f;"""),
    'dbl2d': dict(ins=('x',), outs=('out',), dtype='bfloat16',
                  shape=(3000, 1000), ulp=0, body="""
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < x_dims[0] && c < x_dims[1])
      out[r * x_dims[1] + c] =
          __float2bfloat16(2.0f * __bfloat162float(x[r * x_dims[1] + c]));"""),
    'sgd_update': dict(ins=('w', 'g'), outs=('out',), dtype='float32',
                       shape=(1024,), ulp=0, in_place=True, body="""
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < w_dims[0]; i += (long long)blockDim.x * gridDim.x)
      out[i] = __fsub_rn(w[i], __fmul_rn(0.1f, g[i]));"""),
}
# saxpy1's grid: at most 16 blocks of 256 threads an SM on the H100's 132
RTC_GRID_BLOCKS = 132 * 16
# the imperative loop: logistic regression on two seeded Gaussian blobs
SGD_ROWS, SGD_FEATURES, SGD_STEPS = 8192, 1024, 100


def rtc_launch_dims(name, shape):
    """(grid_dims, block_dims) of RTC_CASES[name] at `shape`."""
    if name == 'ref_exp':
        return (1,), (shape[0],)
    if name == 'dbl2d':
        return (-(-shape[1] // 32), -(-shape[0] // 16)), (32, 16)
    return (min(-(-shape[0] // 256), RTC_GRID_BLOCKS),), (256,)


def rtc_inputs(name, shape, seed):
    """Seeded float32 numpy inputs of RTC_CASES[name] at `shape`, uniform
    in [-1, 1)."""
    rng = np.random.default_rng([seed, len(name), shape[0]])
    return [rng.uniform(-1, 1, shape).astype(np.float32)
            for _ in RTC_CASES[name]['ins']]


def rtc_plain(name, *ins):
    """The plain PyTorch version of RTC_CASES[name] on torch tensors."""
    if name == 'ref_exp':
        x, = ins
        return (x * 5.0).exp()
    if name == 'saxpy1':
        x, y = ins
        return x * y + 1.0
    if name == 'dbl2d':
        x, = ins
        return x * 2
    w, g = ins
    return w - RTC_LR * g


def ulp_of(torch, t):
    """The spacing of float32 values at |t|, element by element."""
    mag = t.float().abs()
    return torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag


def rtc_slack(torch, name, ins):
    """The rounding the plain version of RTC_CASES[name] takes that its
    kernel does not, element by element: half an ulp of saxpy1's x * y,
    which the FMA keeps unrounded; None for the other cases."""
    if name != 'saxpy1':
        return None
    x, y = ins
    return 0.5 * ulp_of(torch, x * y)


def ulp_mismatch(torch, got, ref, ulps, slack=None):
    """got against ref, element by element: |got - ref| within `ulps`
    units in the last place of ref plus `slack` (0 ulps and no slack: the
    same bits). The largest difference in ulps of ref, and ok when no
    element is over its limit."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if ulps == 0 and slack is None:
        same = torch.equal(got, ref)
        return dict(max_abs_err=float(err.max()),
                    max_ulps=0.0 if same else None, ok=same)
    ulp = ulp_of(torch, ref)
    limit = ulps * ulp + (0 if slack is None else slack)
    return dict(max_abs_err=float(err.max()),
                max_ulps=float((err / ulp).max()),
                over_limit=int((err > limit).sum()),
                ok=bool(torch.isfinite(got).all()) and
                bool((err <= limit).all()))


def fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, iters):
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event):
    """A profiler event's own device time in us (the attribute was
    self_cuda_time_total before torch 2.4)."""
    return getattr(event, 'self_device_time_total', None) or \
        getattr(event, 'self_cuda_time_total', 0)


def device_events(torch, fn, iters=1):
    """The kernels fn launches over iters calls, by name, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')]


def profiled_ms(torch, fn, iters):
    """Mean device time of fn over iters calls, summed over its kernels,
    after one warm-up: for a call whose host work may outlast its
    kernels, where CUDA events around the calls would time the host."""
    fn()
    torch.cuda.synchronize()
    return sum(device_us(e) for e in device_events(torch, fn, iters)) \
        / 1e3 / iters


def attention_bound(b, h, tq, tk, d, dtype_name, causal):
    """Least time for one attention forward: q, k, v read once, O and
    lse written once, against the two products over the live (row, key)
    pairs of this shape."""
    itemsize = 4 if dtype_name == 'float32' else 2
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + b * h * tq * 4
    flops = 4.0 * b * h * live_pairs(tq, tk, causal) * d
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


def live_pairs(tq, tk, causal):
    """(row, key) pairs that causal masking leaves, per (batch, head)."""
    if not causal:
        return tq * tk
    offset = tk - tq
    return sum(min(tk, i + offset + 1) for i in range(tq))


def backward_bounds(b, h, tq, tk, d, dtype_name, causal):
    """Least time of each backward kernel and of the whole backward:
    q, k, v, dO, lse and D read once, the kernel's gradients written
    once, against its products over the live pairs (S, dP, dV, dK for
    dK/dV; S, dP, dQ for dQ; five for the function)."""
    itemsize = 4 if dtype_name == 'float32' else 2
    reads = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + 2 * b * h * tq * 4
    per_product = 2.0 * b * h * live_pairs(tq, tk, causal) * d
    out = {}
    for name, writes, products in (
            ('dkdv', 2 * b * h * tk * d, 4), ('dq', b * h * tq * d, 3),
            ('whole', b * h * (tq + 2 * tk) * d, 5)):
        nbytes = reads + writes * itemsize
        flops = products * per_product
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by='bytes' if t_bytes >= t_ops
                         else 'operations', bytes=nbytes, flops=flops)
    return out


def backward_flops_done(b, h, tq, tk, d, dtype_name, causal):
    """The operations each backward kernel really does over the live
    pairs: S and dP once per column group of BWD_GROUP (each group sums
    them over the whole head), then dV and dK, or dQ, once."""
    groups = -(-d // BWD_GROUP[dtype_name])
    per_product = 2.0 * b * h * live_pairs(tq, tk, causal) * d
    return dict(dkdv=(2 * groups + 2) * per_product,
                dq=(2 * groups + 1) * per_product)


def sass_check(lib_path, build_log):
    """Phase 1: the tensor-core kernels run on the tensor cores: every
    instance of each of SM90_KERNELS, in each 16-bit type, in the built
    library's SASS (cuobjdump -sass) holds HGMMA instructions, and ptxas
    serialised no wgmma (warning C7520) in the build log."""
    import os
    import shutil
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    functions = sass.split('Function : ')[1:]
    found = {}
    for name in SM90_KERNELS:
        found[name] = {}
        for dtype_name, mangled in SM90_TYPES.items():
            bodies = [f for f in functions
                      if name in f.split('\n', 1)[0] and
                      mangled in f.split('\n', 1)[0]]
            found[name][dtype_name] = dict(
                instances=len(bodies),
                with_hgmma=sum('HGMMA' in f for f in bodies),
                hgmma=sum(f.count('HGMMA') for f in bodies))
    serialised = [line for line in build_log.splitlines()
                  if 'C7520' in line or 'serialized' in line]
    print('sass ' + json.dumps(dict(found, c7520_lines=serialised)))
    for name, rows in found.items():
        for dtype_name, row in rows.items():
            if row['instances'] == 0 or \
                    row['with_hgmma'] != row['instances']:
                fail('%s (%s): %d of %d instances hold HGMMA in the SASS'
                     % (name, dtype_name, row['with_hgmma'],
                        row['instances']))
    if serialised:
        fail('ptxas serialised wgmma: %s' % serialised[:4])
    return found


def kernel_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, iters):
    """Phase 2, one shape: the forward kernel against its plain version
    (16-bit: the online recurrence at the kernel's tile, element by
    element under FWD_TOL, and the same bits on a second launch; float32:
    the dense version under F32_TOL), and the times."""
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)

    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    again = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    same_bits = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    del again
    if dtype_name == 'float32':
        plain = lambda: cuda_ops.flash_attention_reference(q, k, v, causal)
    else:
        plain = lambda: cuda_ops.flash_attention_online_reference(
            q, k, v, causal, block_k=FWD_BLOCK_K)
    ref_out, ref_lse = plain()
    lse_err = (lse - ref_lse).abs()
    ltol = LSE_TOL[dtype_name]
    ok_lse = bool((lse_err <= ltol['atol'] + ltol['rtol'] *
                   ref_lse.abs()).all())
    if dtype_name == 'float32':
        tol = F32_TOL
        err = (out.float() - ref_out.float()).abs()
        ok_out = bool((err <= tol['atol'] + tol['rtol'] *
                       ref_out.float().abs()).all())
        check = dict(max_abs_err=float(err.max()))
    else:
        tol = FWD_TOL[dtype_name]
        check = grad_mismatch(torch, out, ref_out, tol)
        ok_out = check['ok']
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())

    ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal), iters)
    plain_ms = cuda_ms(torch, plain, max(2, iters // 4))
    library_ms = None
    if tq == tk:   # SDPA's is_causal aligns top-left: same function only
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(
        b, h, tq, tk, d, dtype_name, causal)
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, **check, tol=tol,
               plain='dense' if dtype_name == 'float32' else
               'online, %d-key tiles' % FWD_BLOCK_K,
               lse_max_abs_err=float(lse_err.max()), lse_tol=ltol,
               same_bits_twice=same_bits, ms=ms, tflops=flops / ms / 1e9,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    print('kernel case ' + json.dumps(row))
    if not (ok_out and ok_lse):
        fail('%s: kernel disagrees with its plain version: out %s '
             '(tol %s), lse %.3g (tol %s)' % (name, check, tol,
                                             row['lse_max_abs_err'], ltol))
    if not finite:
        fail('%s: non-finite kernel output' % name)
    if not same_bits:
        fail('%s: a second launch of the forward kernel gave other bits'
             % name)
    return row


def grad_mismatch(torch, got, ref, tol):
    """A gradient against its plain version under `tol` (a BWD_TOL
    entry): the largest error and reference, the elements over their
    tolerance and the share that differ at all; ok when finite, none is
    over and no more than tol['differ'] differ."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    size = float(ref.abs().max())
    limit = tol['rtol'] * ref.abs() + tol['atol'] + tol['atol_of_max'] * size
    over = int((err > limit).sum())
    differ = float((err > 0).float().mean())
    finite = bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(err.max()), max_abs_ref=size,
                over_tol=over, share_differ=differ, finite=finite,
                ok=finite and over == 0 and differ <= tol['differ'])


def bwd_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, with_glse,
             iters):
    """Phase 4, one shape: each backward kernel against its plain
    version on the same inputs (the kernel forward's out and lse, a
    seeded dO and lse cotangent), the autograd Function against the
    kernels, and the times."""
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    do = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    glse = None
    if with_glse:
        glse = torch.randn((b * h, tq, 1), generator=gen, device='cuda')
    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    dd = cuda_ops.attention_bwd_delta(out, do, glse).contiguous()
    args = (q, k, v, do, lse, dd, causal, scale)

    dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
    dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
    again = (cuda_ops.flash_attention_bwd_dq_cuda(*args),
             *cuda_ops.flash_attention_bwd_dkdv_cuda(*args))
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
    del again
    ref_dk, ref_dv = cuda_ops.flash_attention_bwd_dkdv_reference(*args)
    ref_dq = cuda_ops.flash_attention_bwd_dq_reference(*args)
    errs = {gname: grad_mismatch(torch, got, ref, BWD_TOL[dtype_name])
            for gname, got, ref in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                                    ('dv', dv, ref_dv))}
    ok = all(e['ok'] for e in errs.values())

    # the Function's backward is these kernels on these inputs
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o2, l2 = cuda_ops.flash_attention_with_lse(*leaves, causal=causal)
    outs, cots = ((o2, l2), (do, glse)) if with_glse else ((o2,), (do,))
    fn_grads = torch.autograd.grad(outs, leaves, cots)
    same = all(torch.equal(a, b) for a, b in zip(fn_grads, (dq, dk, dv)))

    dkdv_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dkdv_cuda(
        *args), iters)
    dq_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dq_cuda(
        *args), iters)
    plain_iters = max(2, iters // 4)
    dkdv_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dkdv_reference(*args),
        plain_iters)
    dq_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dq_reference(*args),
        plain_iters)
    library_ms = None
    if tq == tk and not with_glse:   # SDPA's is_causal aligns top-left
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=causal)
        # device time: the autograd engine's host work per call can
        # outlast these kernels
        library_ms = profiled_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (sq, sk, sv), do, retain_graph=True), iters)
    bounds = backward_bounds(b, h, tq, tk, d, dtype_name, causal)
    done = backward_flops_done(b, h, tq, tk, d, dtype_name, causal)
    rates = {key: dict(tflops=bounds[key]['flops'] / ms / 1e9,
                       tflops_done=done[key] / ms / 1e9,
                       flops_done=done[key])
             for key, ms in (('dkdv', dkdv_ms), ('dq', dq_ms))}
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, glse=with_glse, tol=BWD_TOL[dtype_name],
               errors=errs, same_bits_twice=same_bits,
               function_equals_kernels=same,
               dkdv_ms=dkdv_ms, dq_ms=dq_ms, dkdv_plain_ms=dkdv_plain_ms,
               dq_plain_ms=dq_plain_ms, sdpa_backward_ms=library_ms,
               bounds=bounds, rates=rates)
    print('backward case ' + json.dumps(row))
    if not ok:
        fail('%s: a backward kernel disagrees with its plain version: %s'
             % (name, errs))
    if not same_bits:
        fail('%s: a second launch of the backward kernels gave other bits'
             % name)
    if not same:
        fail('%s: the autograd Function does not give the kernels\' '
             'gradients' % name)
    return row


def reset_counts(cuda_ops):
    cuda_ops.FLASH_FWD_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DKDV_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DQ_LAUNCHES = 0


def read_counts(cuda_ops):
    return (cuda_ops.FLASH_FWD_LAUNCHES, cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
            cuda_ops.FLASH_BWD_DQ_LAUNCHES)


def profile_device(torch, fn, label, top):
    """Run fn once under torch.profiler; print and return the device time
    (ms), the heaviest `top` kernels, and the share of PyTorch's copy
    kernel (direct_copy_kernel_cuda: .contiguous(), dtype casts)."""
    events = device_events(torch, fn)
    total_us = sum(device_us(e) for e in events)
    print('%s: device time %.3f ms in %d kernels' % (
        label, total_us / 1e3, len(events)))
    rows = []
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        print('  %9.3f ms  %5d x  %s' % (device_us(e) / 1e3, e.count,
                                          e.key[:110]))
        rows.append(dict(kernel=e.key[:200], ms=device_us(e) / 1e3,
                         count=e.count))
    copies = [e for e in events if 'direct_copy_kernel' in e.key]
    copy = dict(ms=sum(device_us(e) for e in copies) / 1e3,
                launches=sum(e.count for e in copies))
    copy['share'] = copy['ms'] / max(total_us / 1e3, 1e-9)
    print('  copies (direct_copy_kernel_cuda): %.3f ms in %d launches, '
          '%.1f %% of the device time' % (copy['ms'], copy['launches'],
                                          100 * copy['share']))
    return total_us / 1e3, rows, copy


def wrapper_copy_ms(torch):
    """Device time of the flash wrapper's own copies for one layer at the
    LM's shape: q, k and v, each a (batch, heads, seq, head_dim) view of
    the (batch, seq, 3 * dim) projection, made contiguous in the forward
    (cuda_ops._FlashAttention.forward), and dO made contiguous in the
    backward; bf16, CUDA events over 50 runs."""
    b, t, h = BATCH, SEQ, GPT2_MEDIUM['heads']
    dh = GPT2_MEDIUM['dim'] // h
    x = torch.randn((b, t, 3 * h * dh), device='cuda', dtype=torch.bfloat16)
    views = [z.reshape(b, t, h, dh).transpose(1, 2) for z in x.chunk(3, -1)]
    fwd = cuda_ms(torch, lambda: [z.contiguous() for z in views], 50)
    bwd = cuda_ms(torch, lambda: views[0].contiguous(), 50)
    return dict(forward_ms_per_layer=fwd, backward_ms_per_layer=bwd,
                layers=GPT2_MEDIUM['layers'],
                step_ms=(fwd + bwd) * GPT2_MEDIUM['layers'])


def flash_vs_plain_grads(torch, tfm, cfg, params, tokens, targets,
                         loss_scale=1.0):
    """Every parameter's gradient of the loss (times loss_scale) on the
    flash kernels and on plain attention, same weights: (the check's row,
    what is wrong). Each must be finite and nonzero, and the two within
    GRAD_REL_TOL in relative norm; the losses within LM_NLL_ATOL."""
    grads, losses, peaks = {}, {}, {}
    for use_flash in (True, False):
        model = tfm.TransformerLM(dict(cfg, use_flash=use_flash), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(tokens, targets)
        (loss * loss_scale).backward()
        torch.cuda.synchronize()
        peaks[use_flash] = torch.cuda.max_memory_allocated()
        losses[use_flash] = loss.item()
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    bad, rel = [], {}
    for name, gf in grads[True].items():
        gp = grads[False][name]
        if gf is None or gp is None:
            bad.append('%s: no gradient (flash %s, plain %s)' % (
                name, gf is None, gp is None))
            continue
        gf, gp = gf.float(), gp.float()
        if not (bool(torch.isfinite(gf).all()) and
                bool(torch.isfinite(gp).all())):
            bad.append('%s: non-finite gradient' % name)
        if not (float(gf.abs().max()) > 0 and float(gp.abs().max()) > 0):
            bad.append('%s: zero gradient' % name)
        rel[name] = float((gf - gp).norm() / gp.norm())
        if not rel[name] <= GRAD_REL_TOL:
            bad.append('%s: flash vs plain gradient %.4g (tol %g)' % (
                name, rel[name], GRAD_REL_TOL))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    grad_check = dict(parameters=len(grads[True]), loss_flash=losses[True],
                      loss_plain=losses[False], rel_err_max=worst[0][1],
                      rel_err_worst=worst, rel_tol=GRAD_REL_TOL,
                      wqkv_grad_norm_flash=float(
                          grads[True]['layers.0.wqkv'].float().norm()),
                      peak_bytes_flash=peaks[True],
                      peak_bytes_plain=peaks[False], loss_scale=loss_scale)
    if abs(losses[True] - losses[False]) > LM_NLL_ATOL:
        bad.append('loss flash %.5f vs plain %.5f (tol %g)' % (
            losses[True], losses[False], LM_NLL_ATOL))
    return grad_check, bad


def train_phase(torch, cuda_ops, tfm, params, batch):
    """Phase 5: the bf16 train step at full width and depth on `params`
    (updated in place), then one float16 step and the float32 loss check
    at cut depth."""
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = batch

    # gradients on the flash kernels and on plain attention, same weights
    grad_check, bad = flash_vs_plain_grads(torch, tfm, cfg, params, tokens,
                                           targets)
    print('train grad check ' + json.dumps(grad_check))
    if bad:
        fail('train gradients: ' + '; '.join(bad[:10]))

    # the warm-up step, whose update is checked on layer 0's wqkv
    model = tfm.TransformerLM(cfg, params)
    step = tfm.make_train_step(cfg, lr=LR)
    w = model.layers[0].wqkv
    before = w.detach().clone()
    step(model, tokens, targets)
    torch.cuda.synchronize()
    update_exact = torch.equal(w.detach(), before - LR * w.grad)
    moved = int((w.detach() != before).sum())
    del before

    # the main path: TRAIN_STEPS steps, counted and timed
    reset_counts(cuda_ops)
    times, step_losses, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        counts = read_counts(cuda_ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(float(loss))
        per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                counts)])
    launches = read_counts(cuda_ops)
    peak_step = torch.cuda.max_memory_allocated()
    dev_ms, top, copies = profile_device(
        torch, lambda: step(model, tokens, targets),
        'train profile, one step', 12)
    del model
    wrapper_copies = wrapper_copy_ms(torch)

    step_ms = sorted(times)[len(times) // 2] * 1e3
    train = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
                 batch=BATCH, seq=SEQ, lr=LR, steps=TRAIN_STEPS,
                 step_ms=[t * 1e3 for t in times], step_ms_median=step_ms,
                 tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
                 losses=step_losses, launches=launches,
                 launches_per_step=per_step, update_exact=update_exact,
                 wqkv_elements_moved=moved, peak_bytes_step=peak_step,
                 profiled_device_ms=dev_ms,
                 device_busy_share=dev_ms / step_ms, profile_top=top,
                 copies=copies, flash_wrapper_copies=wrapper_copies)
    print('train ' + json.dumps(train))
    want = [cfg['layers']] * 3
    if per_step != [want] * TRAIN_STEPS:
        fail('launches (fwd, dK/dV, dQ) per step %s, expected %s each'
             % (per_step, want))
    if not update_exact:
        fail('the update of layers.0.wqkv is not w - lr * g')
    if not all(math.isfinite(x) for x in step_losses):
        fail('non-finite train loss %s' % step_losses)

    f16 = train_f16_check(torch, cuda_ops, tfm, batch)

    # float32 at full width, cut depth: the loss falls on one batch
    cfg32 = tfm.lm_config(use_flash=True,
                          **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    model = tfm.TransformerLM(cfg32, tfm.params_from_jax(
        seeded_tree(cfg32, SEED + 3), dtype=torch.float32, device='cuda'))
    step = tfm.make_train_step(cfg32, lr=LR)
    counts = read_counts(cuda_ops)
    fp32_losses = [float(step(model, tokens, targets))
                   for _ in range(FP32_STEPS)]
    fp32_launches = [a - b for a, b in zip(read_counts(cuda_ops), counts)]
    del model
    fp32 = dict(config='gpt2-medium widths, %d layers, float32'
                % FP32_LAYERS, lr=LR, losses=fp32_losses,
                launches=fp32_launches)
    print('train fp32 ' + json.dumps(fp32))
    if not all(math.isfinite(x) for x in fp32_losses) or \
            not fp32_losses[-1] < fp32_losses[0]:
        fail('float32 loss did not fall over %d steps: %s'
             % (FP32_STEPS, fp32_losses))
    if fp32_launches != [FP32_LAYERS * FP32_STEPS] * 3:
        fail('float32 steps launched %s kernels, expected %d each'
             % (fp32_launches, FP32_LAYERS * FP32_STEPS))
    return dict(train, grad_check=grad_check, fp32=fp32, f16=f16)


def train_f16_check(torch, cuda_ops, tfm, batch):
    """Phase 5 in float16: at full width and F16_LAYERS layers, every
    gradient of the loss times F16_LOSS_SCALE on the flash kernels
    against plain attention's, then one train step (unscaled, as
    make_train_step takes it), which must launch the forward, dK/dV and
    dQ kernels once per layer and give a finite loss."""
    cfg = tfm.lm_config(use_flash=True,
                        **dict(GPT2_MEDIUM, layers=F16_LAYERS))
    params = tfm.params_from_jax(
        seeded_tree(cfg, SEED + 8, embed_std=F16_EMBED_STD),
        dtype=torch.float16, device='cuda')
    tokens, targets = batch
    grad_check, bad = flash_vs_plain_grads(torch, tfm, cfg, params, tokens,
                                           targets, F16_LOSS_SCALE)
    model = tfm.TransformerLM(cfg, params)
    step = tfm.make_train_step(cfg, lr=LR)
    counts = read_counts(cuda_ops)
    loss = float(step(model, tokens, targets))
    launches = [a - b for a, b in zip(read_counts(cuda_ops), counts)]
    del model
    row = dict(config='gpt2-medium widths, %d layers, float16'
               % F16_LAYERS, grad_check=grad_check, step_loss=loss,
               launches=launches)
    print('train f16 ' + json.dumps(row))
    if bad:
        fail('float16 train gradients: ' + '; '.join(bad[:10]))
    if launches != [F16_LAYERS] * 3 or not math.isfinite(loss):
        fail('float16 step: launches (fwd, dK/dV, dQ) %s, expected %d '
             'each; loss %s' % (launches, F16_LAYERS, loss))
    return row


def seeded_tree(cfg, seed, embed_std=0.02):
    """A JAX-layout parameter tree of numpy float32 arrays: weights
    normal * 0.02, norm scales one (the JAX package's init_params); the
    embedding normal * embed_std."""
    rng = np.random.default_rng(seed)
    D, V, H = cfg['dim'], cfg['vocab'], cfg['mlp_mult'] * cfg['dim']

    def normal(*shape, std=0.02):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(std)
        return w

    ones = lambda n: np.ones((n,), np.float32)
    return {'embed': normal(V, D, std=embed_std), 'ln_f': ones(D),
            'layers': [{'ln1': ones(D), 'wqkv': normal(D, 3 * D),
                        'wo': normal(D, D), 'ln2': ones(D),
                        'w1': normal(D, H), 'w2': normal(H, D)}
                       for _ in range(cfg['layers'])]}


def backward_phase(torch, cuda_ops, names):
    """Phase 4: the named BWD_CASES, in order."""
    rows = []
    for name in names:
        shape_q, tk, dtype_name, with_glse, iters = BWD_CASES[name]
        rows.append(bwd_case(torch, cuda_ops, name, shape_q, tk,
                             getattr(torch, dtype_name), True, with_glse,
                             iters))
    return rows


def conv_inputs(torch, name, seed):
    """Seeded x and w of CONV_CASES[name] on the card: w scaled by 0.05,
    so y is of size about 1 at the ResNet-50 depths."""
    xs, ws, stride, pad, dtype_name = CONV_CASES[name]
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(xs, generator=gen, device='cuda', dtype=dtype)
    w = torch.randn(ws, generator=gen, device='cuda', dtype=dtype) * 0.05
    return x, w, stride, pad, dtype_name


def conv_y_mismatch(torch, cuda_conv, got, ref, x, w, stride, pad):
    """y against the plain version's under CONV_Y_TOL (bf16) or the
    float32 depth bound; the fields of `grad_mismatch`."""
    if got.dtype == torch.bfloat16:
        return grad_mismatch(torch, got, ref, CONV_Y_TOL)
    depth = w.shape[0] * w.shape[1] * w.shape[2]
    magnitude = cuda_conv.conv_bn_stats_plain(x.abs(), w.abs(), stride,
                                              pad)[0]
    limit = CONV_F32_ORDERS * depth * 2.0 ** -24 * magnitude
    err = (got - ref).abs()
    over = int((err > limit).sum())
    finite = bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(err.max()),
                max_abs_ref=float(ref.abs().max()), over_tol=over,
                share_differ=float((err > 0).float().mean()), finite=finite,
                ok=finite and over == 0)


def stats_mismatch(torch, got, ref, scale):
    """A statistic against the plain version's, as the largest
    |got - ref| / scale over the channels; ok when finite and within
    CONV_STATS_RTOL."""
    err = float(((got - ref).abs() / scale.clamp_min(1e-30)).max())
    finite = bool(torch.isfinite(got).all())
    return dict(rel_err=err, ok=finite and err <= CONV_STATS_RTOL)


def conv_case(torch, cuda_conv, name):
    """Phase 6, one case: the kernel against its plain version on the same
    inputs, element by element, and the same bits on a second run."""
    x, w, stride, pad, dtype_name = conv_inputs(torch, name, SEED + 4)
    y, s1, s2 = cuda_conv.conv_bn_stats_cuda(x, w, stride, pad)
    again = cuda_conv.conv_bn_stats_cuda(x, w, stride, pad)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    del again
    py, p1, p2 = cuda_conv.conv_bn_stats_plain(x, w, stride, pad)
    pf = py.float()
    y_check = conv_y_mismatch(torch, cuda_conv, y, py, x, w, stride, pad)
    s1_check = stats_mismatch(torch, s1, p1, pf.abs().sum((0, 1, 2)))
    s2_check = stats_mismatch(torch, s2, p2, (pf * pf).sum((0, 1, 2)))
    ok = y_check['ok'] and s1_check['ok'] and s2_check['ok']
    row = dict(case=name, x=list(x.shape), w=list(w.shape),
               stride=list(stride), pad=list(pad), dtype=dtype_name,
               y=y_check, s1=s1_check, s2=s2_check,
               y_tol=CONV_Y_TOL if dtype_name == 'bfloat16' else
               '%d * K * 2^-24 * (|x| conv |w|)' % CONV_F32_ORDERS,
               stats_rtol=CONV_STATS_RTOL, same_bits_twice=same_bits)
    print('conv case ' + json.dumps(row))
    if not ok:
        fail('conv %s: the kernel disagrees with its plain version: y %s, '
             's1 %s, s2 %s' % (name, y_check, s1_check, s2_check))
    if not same_bits:
        fail('conv %s: a second run of the kernel gave other bits' % name)
    return row


def conv_grad_check(torch, cuda_conv):
    """Phase 6: dx and dw of the autograd Function on the card (kernel
    forward, seeded dy, ds1, ds2) against the statistics' cotangents
    folded into dy on the plain version's y, dy + ds1 + 2 y ds2, and
    PyTorch's transposed convs, written out here."""
    name = CONV_GRAD_CASE
    x, w, stride, pad, dtype_name = conv_inputs(torch, name, SEED + 5)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y, s1, s2 = cuda_conv.conv2d_bn_stats(xl, wl, stride, pad)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    dy = torch.randn(y.shape, generator=gen, device='cuda', dtype=y.dtype)
    ds1 = torch.randn(s1.shape, generator=gen, device='cuda')
    ds2 = torch.randn(s2.shape, generator=gen, device='cuda') * 0.1
    dx, dw = torch.autograd.grad((y, s1, s2), (xl, wl), (dy, ds1, ds2))

    py = cuda_conv.conv_bn_stats_plain(x, w, stride, pad)[0]
    tot = (dy.float() + ds1 + 2.0 * py.float() * ds2).to(y.dtype)
    tot = tot.permute(0, 3, 1, 2)
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    ref_dx = torch.nn.grad.conv2d_input(xn.shape, wn, tot, stride,
                                        pad).permute(0, 2, 3, 1)
    ref_dw = torch.nn.grad.conv2d_weight(xn, wn.shape, tot, stride,
                                         pad).permute(2, 3, 1, 0)
    tol = BWD_TOL[dtype_name]
    errs = {'dx': grad_mismatch(torch, dx, ref_dx, tol),
            'dw': grad_mismatch(torch, dw, ref_dw, tol)}
    row = dict(case=name, tol=tol, errors=errs)
    print('conv grad check ' + json.dumps(row))
    if not all(e['ok'] for e in errs.values()):
        fail('conv gradients of the Function disagree with the fold and '
             'transposes on the plain version: %s' % errs)
    return row


def conv_bench_phase(torch, cuda_ops, cuda_conv, bench_conv_bn):
    """Phase 6's path: the bench over every ResNet-50 conv shape at batch
    CONV_BATCH in bf16, its launch counts read from zero."""
    reset_counts(cuda_ops)
    cuda_conv.CONV_BN_STATS_LAUNCHES = 0
    bench = bench_conv_bn.run(batch=CONV_BATCH, dtype='bfloat16',
                              log=lambda line: print('conv bench ' + line))
    launches = cuda_conv.CONV_BN_STATS_LAUNCHES
    flash = read_counts(cuda_ops)
    rows = bench['rows']
    print('conv bench ' + json.dumps(dict(bench, launches=launches)))
    bad = []
    for r in rows:
        where = tuple(r['shape'])
        if r['launches'] != 1:
            bad.append('%s: the result call launched %d kernels, expected 1'
                       % (where, r['launches']))
        if not r['y_finite'] or r['y_share_differ'] > CONV_Y_TOL['differ'] \
                or r['y_max_abs_err'] > (CONV_Y_TOL['rtol'] +
                                         CONV_Y_TOL['atol_of_max']) * \
                r['y_max_abs']:
            bad.append('%s: y disagrees with the plain version: max err %.3g '
                       'of max %.3g, %.2g differ' % (
                           where, r['y_max_abs_err'], r['y_max_abs'],
                           r['y_share_differ']))
        if not max(r['s1_err'], r['s2_err']) <= CONV_STATS_RTOL:
            bad.append('%s: statistics disagree with the plain version: s1 '
                       '%.3g, s2 %.3g (tol %g)' % (where, r['s1_err'],
                                                   r['s2_err'],
                                                   CONV_STATS_RTOL))
    if len(rows) != len(cuda_conv.RESNET50_CONVS):
        bad.append('%d shapes ran of %d' % (len(rows),
                                             len(cuda_conv.RESNET50_CONVS)))
    counted = sum(r['launches'] + r['timed_launches'] for r in rows)
    if launches != counted:
        bad.append('the bench launched %d kernels; its rows count %d'
                   % (launches, counted))
    if flash != (0, 0, 0):
        bad.append('the bench launched flash kernels: %s' % (flash,))
    if bad:
        fail('conv bench: ' + '; '.join(bad))
    return dict(bench, launches=launches,
                launches_per_body_forward=sum(r['count'] * r['launches']
                                              for r in rows))


def conv_phase(torch, cuda_ops, cuda_conv, bench_conv_bn):
    """Phase 6: CONV_CASES, the gradient check and the bench path."""
    cases = [conv_case(torch, cuda_conv, name) for name in CONV_CASES]
    grad = conv_grad_check(torch, cuda_conv)
    bench = conv_bench_phase(torch, cuda_ops, cuda_conv, bench_conv_bn)
    return dict(cases=cases, grad=grad, bench=bench)


def conv_kernel_entry(conv):
    """The conv_bn_stats entry of the kernels line: times at the main
    case's shape from the bench, errors from the cases."""
    xs, ws = CONV_CASES['main'][:2]
    main_shape = [xs[1], xs[3], ws[3], ws[0], CONV_CASES['main'][2][0]]
    bench = conv['bench']
    row = next(r for r in bench['rows'] if r['shape'] == main_shape)
    cases = [dict(case=c['case'], x=c['x'], w=c['w'], dtype=c['dtype'],
                  max_abs_err=c['y']['max_abs_err'],
                  share_differ=c['y']['share_differ'],
                  s1_rel_err=c['s1']['rel_err'],
                  s2_rel_err=c['s2']['rel_err'], y_tol=c['y_tol'],
                  stats_rtol=c['stats_rtol'],
                  same_bits_twice=c['same_bits_twice'])
             for c in conv['cases']]
    return dict(
        name='conv_bn_stats', route='cuda',
        source='mxnet_tpu_torch/csrc/conv_bn_stats.cu',
        replaces='mxnet_tpu/pallas_conv.py:101',
        launches=bench['launches'],
        launches_by_path=dict(conv_bn_bench=bench['launches']),
        launches_per_body_forward=bench['launches_per_body_forward'],
        max_abs_err=cases[0]['max_abs_err'], ms=row['ms'],
        plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
        bound_by=row['bound_by'], library_ms=row['library_ms'],
        library_call='cuDNN F.conv2d on channels-last tensors, then the '
                     'float32 sum and sum of squares of y per channel',
        main_shape=dict(x=list(xs), w=list(ws), dtype='bfloat16'),
        totals=bench['totals'], grad_check=conv['grad']['errors'],
        cases=cases)


def mutant_check(root):
    """--mutants: build each of FWD_MUTANTS, BWD_MUTANTS and CONV_MUTANTS
    in its own copy of the port under build/mutants/ and run there, all
    at once, phase 2's LM case (a forward mutant), phase 4's LM case (a
    backward mutant) or phase 6's main case (a conv mutant); each must
    fail its case and the copy with no edit must pass all three. Times
    from these runs mean nothing: they share the card."""
    import shutil
    base = root / 'build' / 'mutants'
    shutil.rmtree(base, ignore_errors=True)
    fwd = ('flash_attention_sm90.cu', ['--forward-case', 'lm'])
    bwd = ('flash_attention_bwd_sm90.cu', ['--backward-case', 'lm'])
    conv = ('conv_bn_stats.cu', ['--conv-case', 'main'])
    plan = [('unchanged', None, None, fwd[1] + bwd[1] + conv[1])]
    plan += [(name, edit, fwd[0], fwd[1])
             for name, edit in FWD_MUTANTS.items()]
    plan += [(name, edit, bwd[0], bwd[1])
             for name, edit in BWD_MUTANTS.items()]
    plan += [(name, edit, conv[0], conv[1])
             for name, edit in CONV_MUTANTS.items()]
    runs = []
    for name, edit, source, case in plan:
        copy = base / name
        shutil.copytree(root / 'mxnet_tpu_torch', copy / 'mxnet_tpu_torch',
                        ignore=shutil.ignore_patterns('__pycache__'))
        shutil.copy2(root / 'chip_smoke.py', copy)
        if edit:
            src = copy / 'mxnet_tpu_torch' / 'csrc' / source
            text = src.read_text()
            if text.count(edit[0]) != 1:
                fail('mutant %s: %r is not in the source once' % (name,
                                                                    edit[0]))
            src.write_text(text.replace(edit[0], edit[1]))
        with open(copy / 'run.log', 'w') as log:
            runs.append((name, copy, subprocess.Popen(
                [sys.executable, 'chip_smoke.py'] + case,
                cwd=copy, stdout=log, stderr=subprocess.STDOUT)))
    try:
        rcs = [proc.wait(timeout=600) for _, _, proc in runs]
    finally:
        for _, _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wrong = []
    for (name, copy, _), rc in zip(runs, rcs):
        text = (copy / 'run.log').read_text()
        errors = {}
        for line in text.splitlines():
            if line.startswith('kernel case '):
                row = json.loads(line[len('kernel case '):])
                errors.update(out={k: row.get(k) for k in (
                    'max_abs_err', 'over_tol', 'share_differ')},
                    lse=row['lse_max_abs_err'])
            elif line.startswith('backward case '):
                row = json.loads(line[len('backward case '):])
                errors.update({g: {k: e[k] for k in (
                    'max_abs_err', 'over_tol', 'share_differ')}
                    for g, e in row['errors'].items()})
            elif line.startswith('conv case '):
                row = json.loads(line[len('conv case '):])
                errors.update(y={k: row['y'][k] for k in (
                    'max_abs_err', 'over_tol', 'share_differ')},
                    s1=row['s1']['rel_err'], s2=row['s2']['rel_err'])
        failed_check = rc == 1 and 'disagrees with its plain' in text
        print('mutant ' + json.dumps(dict(mutant=name, rc=rc,
                                          caught=failed_check,
                                          errors=errors)))
        if (name == 'unchanged') != (rc == 0) or \
                (name != 'unchanged' and not failed_check):
            wrong.append('%s (rc %d):\n%s' % (name, rc, text[-3000:]))
    if wrong:
        fail('mutant check: ' + '\n'.join(wrong))
    print('mutants: all %d forward mutants caught by phase 2\'s LM case, '
          'all %d backward mutants by phase 4\'s and all %d conv mutants '
          'by the main conv case; the unchanged copy passes all three'
          % (len(FWD_MUTANTS), len(BWD_MUTANTS), len(CONV_MUTANTS)))


def lm_variant_check(torch, cuda_ops, tfm, request, widths, dtype, seed,
                     label):
    """Phase 3 at other widths or in another dtype: one request through
    the LM of `widths` on the flash kernel and on plain attention, same
    seeded weights, at phase 3's tolerances."""
    cfg = tfm.lm_config(use_flash=True, **widths)
    params = tfm.params_from_jax(seeded_tree(cfg, seed), dtype=dtype,
                                 device='cuda')
    tokens, targets = request
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    with torch.inference_mode():
        before = cuda_ops.FLASH_FWD_LAUNCHES
        flash_logits = model(tokens).float()
        launches = cuda_ops.FLASH_FWD_LAUNCHES - before
        dense_logits = dense(tokens).float()
        finite = bool(torch.isfinite(flash_logits).all())
        err = float((flash_logits - dense_logits).abs().max())
        nll_flash = float(tfm.nll(flash_logits, targets))
        nll_plain = float(tfm.nll(dense_logits, targets))
    row = dict(config='dim %d, %d heads of %d, %d layers, %s' % (
        cfg['dim'], cfg['heads'], cfg['head_dim'], cfg['layers'],
        str(dtype).split('.')[-1]),
        launches=launches, max_abs_logit_err=err, logit_atol=LM_LOGIT_ATOL,
        nll_flash=nll_flash, nll_plain=nll_plain, nll_atol=LM_NLL_ATOL)
    print('lm %s ' % label + json.dumps(row))
    if launches != cfg['layers'] or not finite:
        fail('%s LM: %d flash launches (expected %d), finite %s'
             % (label, launches, cfg['layers'], finite))
    if err > LM_LOGIT_ATOL or abs(nll_flash - nll_plain) > LM_NLL_ATOL:
        fail('%s LM: flash and plain attention disagree: logits %.4g (tol '
             '%g), nll %.5f vs %.5f (tol %g)' % (
                 label, err, LM_LOGIT_ATOL, nll_flash, nll_plain,
                 LM_NLL_ATOL))
    return row


def host_us(torch, fn, calls):
    """Host time of one call of fn in us, over `calls` calls after 100
    warm-up calls; the device is synchronised after the clock stops."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def tensor_op_names():
    """Every name, aliases included, that the port's ops/tensor.py
    registers."""
    from mxnet_tpu_torch.ops import registry
    ops = {n for n, op in registry._OP_REGISTRY.items()
           if op.fcompute.__module__ == 'mxnet_tpu_torch.ops.tensor'}
    return ops | {a for a, n in registry._OP_ALIASES.items() if n in ops}


def nd_phase(torch, mx):
    """Phase 7: every tensor op on gpu(0) against cpu(0) on the same
    seeded inputs (tools/op_consistency.py), the samplers' moments on
    gpu(0), then the host time of a small nd op beside the same torch
    call."""
    from mxnet_tpu_torch.tools import op_consistency as oc
    names = tensor_op_names()
    t0 = time.perf_counter()
    count, bad = oc.run(mx.nd, mx.gpu(0), mx.cpu(0), ND_SIZE, seed=SEED)
    seconds = time.perf_counter() - t0
    samplers = oc.run_samplers(mx, mx.gpu(0), ND_SAMPLES, seed=SEED)
    a = mx.nd.ones((16,), ctx=mx.gpu(0))
    b = mx.nd.ones((16,), ctx=mx.gpu(0))
    ta, tb = a.handle, b.handle
    nd_us = host_us(torch, lambda: a + b, ND_HOST_CALLS)
    torch_us = host_us(torch, lambda: ta + tb, ND_HOST_CALLS)
    row = dict(ops_run=count, ops_registered=len(names),
               size=[ND_SIZE, ND_SIZE], tol=oc.TOL, tf32=False,
               mismatches=bad, seconds=seconds,
               samplers=sorted(oc.SAMPLERS) + ['multinomial'],
               sampler_draws=ND_SAMPLES, sampler_mismatches=samplers,
               host_us_nd_add_16=nd_us, host_us_torch_add_16=torch_us,
               host_calls=ND_HOST_CALLS)
    print('ndarray ' + json.dumps(row))
    if set(oc.CASES) != names or count != len(names) + len(oc.VARIANTS):
        fail('phase 7 ran %d cases; ops/tensor.py registers %d ops, and %d '
             'variants (missing %s)' % (count, len(names), len(oc.VARIANTS),
                                        sorted(names - set(oc.CASES))[:10]))
    if bad:
        fail('ops disagree between gpu(0) and cpu(0): %s' % bad)
    if samplers:
        fail('samplers on gpu(0) off their distributions: %s' % samplers)
    return row


def rtc_case(torch, mx, name):
    """Phase 8, one RTC_CASES kernel: pushed on gpu(0), held against its
    plain version on the same inputs; the first push compiles once, a
    second at the same key compiles nothing."""
    from mxnet_tpu_torch import rtc
    spec = RTC_CASES[name]
    shape = spec['shape']
    arrays = [mx.nd.array(a, ctx=mx.gpu(0), dtype=spec['dtype'])
              for a in rtc_inputs(name, shape, SEED + 9)]
    plain_ins = [a.handle.clone() for a in arrays]
    plain = rtc_plain(name, *plain_ins)
    slack = rtc_slack(torch, name, plain_ins)
    grid, block = rtc_launch_dims(name, shape)
    kern = rtc.Rtc(name, spec['ins'], spec['outs'], spec['body'])
    outs = [arrays[0]] if spec.get('in_place') else None
    compiles = rtc.RTC_COMPILES
    t0 = time.perf_counter()
    res = kern.push(arrays, outs=outs, grid_dims=grid, block_dims=block)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    compiled = rtc.RTC_COMPILES - compiles
    got = res[0].handle if outs else res.handle
    check = ulp_mismatch(torch, got, plain, spec['ulp'], slack)
    in_place = not outs or got.data_ptr() == arrays[0].handle.data_ptr()
    kern.push(arrays, outs=outs, grid_dims=grid, block_dims=block)
    torch.cuda.synchronize()
    recompiled = rtc.RTC_COMPILES - compiles - compiled
    row = dict(case=name, shape=list(shape), dtype=spec['dtype'],
               grid_dims=list(grid), block_dims=list(block),
               ulp_tol=spec['ulp'], first_push_ms=first_ms,
               compiles_first_push=compiled,
               compiles_second_push=recompiled, in_place=in_place, **check)
    print('rtc case ' + json.dumps(row))
    if not check['ok'] or not in_place:
        fail('rtc %s disagrees with its plain version: %s' % (name, row))
    if compiled != 1 or recompiled != 0:
        fail('rtc %s: %d compiles on the first push, %d on the second at '
             'the same key (expected 1 and 0)' % (name, compiled,
                                                  recompiled))
    return row


def rtc_saxpy_times(torch, mx):
    """saxpy1 at 2^26 float32 elements: the kernel's device time by
    torch.profiler, a push's time by CUDA events and by the host clock,
    its plain version and torch.addcmul by CUDA events, beside the bound:
    x and y read once and out written once."""
    from mxnet_tpu_torch import rtc
    spec = RTC_CASES['saxpy1']
    shape = spec['shape']
    x, y = [mx.nd.array(a, ctx=mx.gpu(0))
            for a in rtc_inputs('saxpy1', shape, SEED + 9)]
    out = mx.nd.empty(shape, ctx=mx.gpu(0))
    grid, block = rtc_launch_dims('saxpy1', shape)
    kern = rtc.Rtc('saxpy1', spec['ins'], spec['outs'], spec['body'])
    def push():
        kern.push([x, y], outs=[out], grid_dims=grid, block_dims=block)

    ms = profiled_ms(torch, push, 20)
    push_ms = cuda_ms(torch, push, 50)
    push_host_us = host_us(torch, push, 200)
    tx, ty = x.handle, y.handle
    plain_ms = cuda_ms(torch, lambda: rtc_plain('saxpy1', tx, ty), 20)
    one = torch.ones((), device=tx.device)
    library_ms = cuda_ms(torch, lambda: torch.addcmul(one, tx, ty), 50)
    n = shape[0]
    nbytes = 3 * n * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * n / PEAK_FLOPS['float32'] * 1e3
    return dict(ms=ms, push_event_ms=push_ms, push_host_us=push_host_us,
                plain_ms=plain_ms, library_ms=library_ms,
                library_call='torch.addcmul(one, x, y) with a 0-d one',
                bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bytes=nbytes, flops=2 * n, elements=n)


def rtc_sgd_loop(torch, mx):
    """Phase 8's path: logistic regression on two seeded Gaussian blobs
    (SGD_ROWS x SGD_FEATURES float32 on gpu(0), means +-mu with |mu| about
    2), the loss under autograd.record(), backward(), and each SGD step
    through sgd_update's Rtc in place; RTC_LAUNCHES is read from 0. Each
    step is timed by the host clock to a synchronise; the first pays for
    torch's one-time imports of its first autograd.grad."""
    from mxnet_tpu_torch import autograd, rtc
    nd, gpu = mx.nd, mx.gpu(0)
    rng = np.random.default_rng(SEED + 10)
    labels = rng.integers(0, 2, SGD_ROWS)
    mu = rng.standard_normal(SGD_FEATURES) * (2.0 / math.sqrt(SGD_FEATURES))
    xs = rng.standard_normal((SGD_ROWS, SGD_FEATURES)) + \
        np.where(labels[:, None] == 1, mu, -mu)
    X = nd.array(xs.astype(np.float32), ctx=gpu)
    Y = nd.array(labels.astype(np.float32), ctx=gpu)
    w = nd.zeros((SGD_FEATURES,), ctx=gpu)
    w.attach_grad()
    spec = RTC_CASES['sgd_update']
    sgd = rtc.Rtc('sgd_update', spec['ins'], spec['outs'], spec['body'])
    grid, block = rtc_launch_dims('sgd_update', (SGD_FEATURES,))

    def accuracy():
        return float(((nd.dot(X, w) > 0) == Y).mean().asscalar())

    acc0 = accuracy()
    rtc.RTC_LAUNCHES = 0
    losses, times = [], []
    for step in range(SGD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            p = nd.sigmoid(nd.dot(X, w))
            loss = -(Y * nd.log(p + 1e-7) +
                     (1 - Y) * nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        sgd.push([w, w.grad], outs=[w], grid_dims=grid, block_dims=block)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if step in (0, SGD_STEPS - 1):
            losses.append(float(loss.asscalar()))
    launches = rtc.RTC_LAUNCHES
    acc = accuracy()

    def one_step():
        with autograd.record():
            p = nd.sigmoid(nd.dot(X, w))
            loss = -(Y * nd.log(p + 1e-7) +
                     (1 - Y) * nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        sgd.push([w, w.grad], outs=[w], grid_dims=grid, block_dims=block)

    dev_ms, top, _ = profile_device(torch, one_step,
                                    'rtc imperative sgd profile, one step',
                                    8)
    step_ms = sorted(times[1:])[len(times) // 2] * 1e3
    row = dict(rows=SGD_ROWS, features=SGD_FEATURES, steps=SGD_STEPS,
               lr=RTC_LR, accuracy_before=acc0, accuracy=acc,
               loss_first=losses[0], loss_last=losses[-1],
               rtc_launches=launches, first_step_ms=times[0] * 1e3,
               step_ms_median=step_ms, profiled_device_ms=dev_ms,
               device_busy_share=dev_ms / step_ms, profile_top=top,
               w_device=str(w.handle.device))
    print('rtc imperative sgd ' + json.dumps(row))
    if not acc > 0.9 or launches != SGD_STEPS or \
            w.handle.device != gpu.torch_device:
        fail('imperative SGD through mx.rtc: accuracy %.4f (must pass 0.9), '
             '%d rtc launches (expected %d), w on %s' % (
                 acc, launches, SGD_STEPS, w.handle.device))
    return row


def rtc_phase(torch, mx):
    """Phase 8: RTC_CASES, saxpy1's times, then the imperative loop."""
    from mxnet_tpu_torch import _nvrtc, rtc
    print('rtc: NVRTC %d.%d from %s, target %s' % (
        _nvrtc.version() + (_nvrtc.nvrtc_path(), _nvrtc.ARCH)))
    before = rtc.RTC_LAUNCHES
    cases = [rtc_case(torch, mx, name) for name in RTC_CASES]
    case_launches = rtc.RTC_LAUNCHES - before
    saxpy = rtc_saxpy_times(torch, mx)
    print('rtc saxpy1 ' + json.dumps(saxpy))
    sgd = rtc_sgd_loop(torch, mx)
    return dict(cases=cases, case_launches=case_launches, saxpy=saxpy,
                sgd=sgd)


def rtc_kernel_entry(rtc_run):
    """The rtc entry of the kernels line: saxpy1's times, the launches of
    the imperative loop (the path) and of the case checks."""
    saxpy = rtc_run['saxpy']
    first = {c['case']: c for c in rtc_run['cases']}
    return dict(
        name='rtc', route='nvrtc', source='chip_smoke.py',
        wrapper='mxnet_tpu_torch/rtc.py', replaces='mxnet_tpu/rtc.py:60',
        launches=rtc_run['sgd']['rtc_launches'],
        launches_by_path=dict(rtc_cases=rtc_run['case_launches'],
                              imperative_sgd=rtc_run['sgd']['rtc_launches']),
        max_abs_err=first['saxpy1']['max_abs_err'],
        max_ulps=first['saxpy1']['max_ulps'],
        ms=saxpy['ms'], plain_ms=saxpy['plain_ms'],
        bound_ms=saxpy['bound_ms'], bound_by=saxpy['bound_by'],
        library_ms=saxpy['library_ms'], library_call=saxpy['library_call'],
        main_shape=dict(case='saxpy1', elements=saxpy['elements'],
                        dtype='float32'),
        compile_ms=first['saxpy1']['first_push_ms'],
        cases=rtc_run['cases'])


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('--forward-case', choices=sorted(FWD_CASES),
                        help='build, then run only this case of phase 2')
    parser.add_argument('--backward-case', choices=sorted(BWD_CASES),
                        help='build, then run only this case of phase 4')
    parser.add_argument('--conv-case', choices=sorted(CONV_CASES),
                        help='build, then run only this case of phase 6')
    parser.add_argument('--phases', type=lambda v: {int(p) for p in
                                                    v.split(',')},
                        default=ALL_PHASES,
                        help='build, then run only these phases (a comma '
                             'list of 2-8); the kernels line needs all')
    parser.add_argument('--mutants', action='store_true',
                        help='check that phase 2\'s LM case fails each of '
                             'FWD_MUTANTS, phase 4\'s each of BWD_MUTANTS '
                             'and phase 6\'s main case each of '
                             'CONV_MUTANTS, broken copies of the kernels')
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a '
             'CUDA device')
    root = Path(__file__).resolve().parent
    if not (root / 'mxnet_tpu_torch' / 'csrc').is_dir():
        fail('mxnet_tpu_torch/csrc not found beside %s: run it from a '
             'checkout of the repository' % Path(__file__).name)
    if args.mutants:
        mutant_check(root)
        return
    phases = args.phases
    if not phases <= ALL_PHASES:
        fail('--phases takes phases 2 to 8; got %s' % sorted(phases))
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _build, cuda_conv, cuda_ops
    from mxnet_tpu_torch.parallel import transformer as tfm
    from mxnet_tpu_torch.tools import bench_conv_bn

    # full float32 products in the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print('build: %.1f s' % build_s)
    build_log = _build.build_log().strip()
    print(build_log)
    sass = sass_check(_build.build(), build_log)
    if args.forward_case or args.backward_case or args.conv_case:
        if args.forward_case:
            shape_q, tk, dtype_name, iters = FWD_CASES[args.forward_case]
            kernel_case(torch, cuda_ops, args.forward_case, shape_q, tk,
                        getattr(torch, dtype_name), True, iters)
        if args.backward_case:
            backward_phase(torch, cuda_ops, [args.backward_case])
        if args.conv_case:
            conv_case(torch, cuda_conv, args.conv_case)
        return

    # 2. each kernel against its plain version, at the LM's shape first
    if 2 in phases:
        cases = [kernel_case(torch, cuda_ops, name, shape_q, tk,
                             getattr(torch, dtype_name), True, iters=iters)
                 for name, (shape_q, tk, dtype_name, iters)
                 in FWD_CASES.items()]

    # 3. the LM forward, the port's serving path
    if phases & {3, 5}:
        cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
        t0 = time.perf_counter()
        params = tfm.params_from_jax(seeded_tree(cfg, SEED),
                                     dtype=torch.bfloat16, device='cuda')
        print('lm: parameters made in %.1f s' % (time.perf_counter() - t0))
        rng = np.random.default_rng(SEED + 1)
        requests = []
        for _ in range(REQUESTS):
            tok = rng.integers(0, cfg['vocab'], (BATCH, SEQ + 1))
            tok = torch.from_numpy(tok).cuda()
            requests.append((tok[:, :-1], tok[:, 1:]))
    if 3 in phases:
        lm = lm_phase(torch, cuda_ops, tfm, cfg, params, requests)
        lm['wide_heads'] = lm_variant_check(
            torch, cuda_ops, tfm, requests[0], LM_WIDE_HEADS, torch.bfloat16,
            SEED + 7, 'wide heads')
        lm['float16'] = lm_variant_check(
            torch, cuda_ops, tfm, requests[0],
            dict(GPT2_MEDIUM, layers=F16_LAYERS), torch.float16, SEED + 8,
            'float16')

    # 4. the backward kernels against their plain versions
    if 4 in phases:
        bwd_cases = backward_phase(torch, cuda_ops, BWD_CASES)

    # 5. the train step, the port's training path
    if 5 in phases:
        train = train_phase(torch, cuda_ops, tfm, params, requests[0])
    if phases & {3, 5}:
        del params

    # 6. the conv + BN statistics kernel and its bench path
    if 6 in phases:
        conv = conv_phase(torch, cuda_ops, cuda_conv, bench_conv_bn)

    # 7. the NDArray core, gpu(0) against cpu(0)
    if 7 in phases:
        nd_phase(torch, mx)

    # 8. mx.rtc: the RTC_CASES kernels and the imperative loop
    if 8 in phases:
        rtc_run = rtc_phase(torch, mx)

    if phases != ALL_PHASES:
        print('phases %s passed' % sorted(phases))
        return
    main_case = cases[0]
    kernels = [dict(
        name='flash_attention_fwd', route='cuda',
        source='mxnet_tpu_torch/csrc/flash_attention_sm90.cu',
        float32_source='mxnet_tpu_torch/csrc/flash_attention.cu',
        sass=sass['flash_fwd_sm90'],
        replaces='mxnet_tpu/pallas_ops.py:95',
        launches=lm['flash_launches'],
        launches_by_path=dict(lm_serve=lm['flash_launches'],
                              lm_train=train['launches'][0]),
        max_abs_err=main_case['max_abs_err'],
        share_differ=main_case['share_differ'],
        ms=main_case['ms'], tflops=main_case['tflops'],
        plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=main_case['library_ms'],
        library_call='scaled_dot_product_attention forward (is_causal)',
        build_s=build_s, cases=cases)]
    for i, (name, key, grads, line) in enumerate((
            ('flash_attention_bwd_dkdv', 'dkdv', ('dk', 'dv'), 313),
            ('flash_attention_bwd_dq', 'dq', ('dq',), 362))):
        per_case = [dict(
            case=c['case'], dtype=c['dtype'],
            max_abs_err=max(c['errors'][g]['max_abs_err'] for g in grads),
            share_differ=max(c['errors'][g]['share_differ'] for g in grads),
            tol=c['tol'], same_bits_twice=c['same_bits_twice'],
            ms=c[key + '_ms'], plain_ms=c[key + '_plain_ms'],
            library_ms=c['sdpa_backward_ms'], **c['bounds'][key],
            **c['rates'][key])
            for c in bwd_cases]
        main_case = per_case[0]
        kernels.append(dict(
            name=name, route='cuda',
            source='mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu',
            float32_source='mxnet_tpu_torch/csrc/flash_attention_bwd.cu',
            sass=sass[SM90_KERNELS[1 + i]],
            tflops=main_case['tflops'], tflops_done=main_case['tflops_done'],
            replaces='mxnet_tpu/pallas_ops.py:%d' % line,
            launches=train['launches'][1 + i],
            launches_by_path=dict(lm_serve=lm['launches'][1 + i],
                                  lm_train=train['launches'][1 + i]),
            max_abs_err=main_case['max_abs_err'], ms=main_case['ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'],
            library_ms=main_case['library_ms'],
            library_call='scaled_dot_product_attention backward (dq, dk '
                         'and dv together), device time by torch.profiler',
            whole_backward_bound_ms=bwd_cases[0]['bounds']['whole'][
                'bound_ms'],
            cases=per_case))
    kernels.append(conv_kernel_entry(conv))
    kernels.append(rtc_kernel_entry(rtc_run))
    for kern in kernels:
        if kern['launches'] == 0:
            fail('its path launched no %s kernel' % kern['name'])
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def lm_phase(torch, cuda_ops, tfm, cfg, params, requests):
    """Phase 3: the LM forward answers REQUESTS requests on the flash
    kernel, and one request is held against plain attention."""
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    print('lm: %d parameters (bf16)' % sum(
        p.numel() for p in model.parameters()))
    with torch.inference_mode():
        model(requests[0][0])          # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts(cuda_ops)
        times, nlls, per_request = [], [], []
        for tokens, targets in requests:
            before = cuda_ops.FLASH_FWD_LAUNCHES
            t0 = time.perf_counter()
            logits = model(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_request.append(cuda_ops.FLASH_FWD_LAUNCHES - before)
            if tuple(logits.shape) != (BATCH, SEQ, cfg['vocab']):
                fail('logits shape %s' % (tuple(logits.shape),))
            if not bool(torch.isfinite(logits).all()):
                fail('non-finite logits')
            nlls.append(float(tfm.nll(logits, targets)))
        launches = read_counts(cuda_ops)

        # one request on plain attention, same weights
        tokens, targets = requests[0]
        flash_logits = model(tokens).float()
        dense_logits = dense(tokens).float()
        logit_err = float((flash_logits - dense_logits).abs().max())
        nll_dense = float(tfm.nll(dense_logits, targets))
        del flash_logits, dense_logits, logits

        # where the time of one request goes, by kernel
        dev_ms, top, copies = profile_device(
            torch, lambda: model(tokens), 'lm profile, one request', 10)

    fwd_ms = sorted(times)[len(times) // 2] * 1e3
    lm = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
              batch=BATCH, seq=SEQ, requests=REQUESTS,
              forward_ms=[t * 1e3 for t in times], forward_ms_median=fwd_ms,
              tokens_per_s=BATCH * SEQ / (fwd_ms / 1e3), mean_nll=nlls,
              ln_vocab=math.log(cfg['vocab']), flash_launches=launches[0],
              launches=launches, launches_per_request=per_request,
              flash_vs_plain_max_abs_logit_err=logit_err,
              logit_atol=LM_LOGIT_ATOL, nll_flash=nlls[0],
              nll_plain=nll_dense, nll_atol=LM_NLL_ATOL,
              profiled_device_ms=dev_ms, device_busy_share=dev_ms / fwd_ms,
              profile_top=top, copies=copies)
    print('lm ' + json.dumps(lm))
    if per_request != [cfg['layers']] * REQUESTS:
        fail('flash launches per request %s, expected %d each'
             % (per_request, cfg['layers']))
    if launches[1:] != (0, 0):
        fail('the forward launched backward kernels: %s' % (launches,))
    if not all(abs(n - math.log(cfg['vocab'])) < 1.0 for n in nlls):
        fail('mean NLL %s far from ln(vocab) = %.3f'
             % (nlls, math.log(cfg['vocab'])))
    if logit_err > LM_LOGIT_ATOL or abs(nlls[0] - nll_dense) > LM_NLL_ATOL:
        fail('flash and plain attention disagree: logits %.4g (tol %g), '
             'nll %.5f vs %.5f (tol %g)' % (logit_err, LM_LOGIT_ATOL,
                                            nlls[0], nll_dense,
                                            LM_NLL_ATOL))
    return lm


if __name__ == '__main__':
    main()
