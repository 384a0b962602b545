// Convolution with the BatchNorm statistics of its output, for Hopper
// (sm_90a): y = conv(x, w) for NHWC x and HWIO w (groups 1, no bias), and
// in the same pass the per-channel sums s1 = sum(y) and s2 = sum(y * y) in
// fp32, taken from the fp32 accumulators before y is rounded.
//
// mxt_conv_bn_stats dispatches by dtype to a tensor-core kernel fed by TMA:
// bfloat16 to conv_bn_stats_sm90.cu (bf16 wgmma), float32 to
// conv_bn_stats_tf32.cu (each product as three TF32 wgmmas, which keep the
// float32 gate, K * 2^-24 of |x| conv |w|, where one TF32 product fails
// it). Both write one partial of s1 and s2 per (M tile, channel), and this
// file's finalize kernel sums them.
//
// Replaces mxnet_tpu/pallas_conv.py:_conv_bn_kernel (launched by
// _conv_bn_stats_impl). The TPU kernel computes the conv as kh * kw shifted
// matmuls over a block of whole images held in VMEM, and carries s1 and s2
// from one image block to the next by read-modify-write, which is safe only
// because its grid runs in order on one core. Here the conv is one implicit
// GEMM: M = N * Ho * Wo rows (output pixels), Cout columns, a depth of
// kh * kw * Cin, and the input pixel of row (n, ho, wo) at tap (dy, dx) is
// (ho * sh - ph + dy, wo * sw - pw + dx), read as zero outside the image.
// So any stride, padding and kernel size is taken, ragged M, Cin and Cout
// are masked, and the TPU's gates (Cin < 8, Cout % 64, a power-of-two
// batch, the VMEM budget) have no counterpart. CUDA blocks run in no
// order, so a sum carried across blocks would need atomics, whose order,
// and so whose bits, change from run to run. The partials and a second
// pass (conv_bn_stats_finalize: the partials of every M tile summed in a
// fixed order) give the same bits every run, as the flash backward
// kernels' one-writer design does.
//
// Layout: x (n, h, w, cin), w (kh, kw, cin, cout), y (n, ho, wo, cout),
// row-major and contiguous, all float or all bfloat16; s1, s2 (cout) float;
// part (2, m_tiles, cout) float scratch from the caller, m_tiles =
// ceil(M / BM), BM the tile height of the dtype's kernel
// (mxt_conv_bn_stats_block_rows); ws scratch of
// mxt_conv_bn_stats_weight_floats floats (none in bf16). Offsets into x, y and part are 64-bit;
// M, the tile count and each size fit an int. The kernels allocate nothing
// and launch on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FIN_CH = 32;   // channels per finalize block
constexpr int FIN_GROUPS = THREADS / FIN_CH;

// s1[c] and s2[c]: the partials of every M tile summed in a fixed order.
// A block owns FIN_CH channels; group g of its threads sums M tiles g,
// g + FIN_GROUPS, ... in turn, and the groups' sums are added in order.
__global__ void __launch_bounds__(THREADS)
conv_bn_stats_finalize(const float* __restrict__ part, float* __restrict__ s1,
                       float* __restrict__ s2, int m_tiles, int cout) {
  __shared__ float red[2][FIN_GROUPS][FIN_CH];
  const int lane = threadIdx.x % FIN_CH, g = threadIdx.x / FIN_CH;
  const int c = blockIdx.x * FIN_CH + lane;
  float t1 = 0.f, t2 = 0.f;
  if (c < cout) {
    const float* p1 = part + c;
    const float* p2 = part + (long long)m_tiles * cout + c;
#pragma unroll 4
    for (int b = g; b < m_tiles; b += FIN_GROUPS) {
      t1 += p1[(long long)b * cout];
      t2 += p2[(long long)b * cout];
    }
  }
  red[0][g][lane] = t1;
  red[1][g][lane] = t2;
  __syncthreads();
  if (threadIdx.x < 2 * FIN_CH) {
    const int which = threadIdx.x / FIN_CH;
    const int ch = blockIdx.x * FIN_CH + lane;
    if (ch < cout) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < FIN_GROUPS; ++r) total += red[which][r][lane];
      (which ? s2 : s1)[ch] = total;
    }
  }
}

cudaError_t finalize(void* part, void* s1, void* s2, int m_tiles, int cout,
                     cudaStream_t stream) {
  conv_bn_stats_finalize<<<(cout + FIN_CH - 1) / FIN_CH, THREADS, 0,
                           stream>>>(static_cast<const float*>(part),
                                     static_cast<float*>(s1),
                                     static_cast<float*>(s2), m_tiles, cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// conv_bn_stats_sm90.cu (bf16) and conv_bn_stats_tf32.cu (float32): the
// tensor-core kernels, their partials in part
int mxt_conv_bn_stats_sm90(const void* x, const void* w, void* y, void* part,
                           int n, int h, int wd, int cin, int cout, int kh,
                           int kw, int sh, int sw, int ph, int pw, int ho,
                           int wo, void* stream);
int mxt_conv_bn_stats_sm90_block_rows(void);
int mxt_conv_bn_stats_tf32(const void* x, const void* w, void* y, void* part,
                           void* ws, int n, int h, int wd, int cin, int cout,
                           int kh, int kw, int sh, int sw, int ph, int pw,
                           int ho, int wo, void* stream);
int mxt_conv_bn_stats_tf32_block_rows(void);
long long mxt_conv_bn_stats_tf32_weight_floats(int kh, int kw, int cin,
                                               int cout);

// Rows of the output (output pixels) per M tile of dtype's kernel (0
// float32, 1 bfloat16; 0 for any other): the caller's scratch `part` holds
// 2 * ceil(M / this) * cout floats.
int mxt_conv_bn_stats_block_rows(int dtype) {
  switch (dtype) {
    case 0: return mxt_conv_bn_stats_tf32_block_rows();
    case 1: return mxt_conv_bn_stats_sm90_block_rows();
    default: return 0;
  }
}

// Floats of the scratch `ws` that dtype's kernel takes for the weights (0
// float32: w's split TF32 parts; 0 for any other dtype).
long long mxt_conv_bn_stats_weight_floats(int dtype, int kh, int kw, int cin,
                                          int cout) {
  return dtype == 0 ? mxt_conv_bn_stats_tf32_weight_floats(kh, kw, cin, cout)
                    : 0;
}

// dtype: 0 float32 (the 3xTF32 kernel of conv_bn_stats_tf32.cu), 1
// bfloat16 (the bf16 kernel of conv_bn_stats_sm90.cu). Returns a
// cudaError_t (0 on success).
int mxt_conv_bn_stats(const void* x, const void* w, void* y, void* s1,
                      void* s2, void* part, void* ws, int n, int h, int wd,
                      int cin, int cout, int kh, int kw, int sh, int sw,
                      int ph, int pw, int dtype, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  if (h + 2LL * ph < kh || wd + 2LL * pw < kw)
    return (int)cudaErrorInvalidValue;
  const long long ho = (h + 2LL * ph - kh) / sh + 1;
  const long long wo = (wd + 2LL * pw - kw) / sw + 1;
  const long long m = (long long)n * ho * wo;
  if (m > 0x7fffffffLL - 1024 || (long long)kh * kw * cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = mxt_conv_bn_stats_block_rows(dtype);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const int err =
      dtype == 0
          ? mxt_conv_bn_stats_tf32(x, w, y, part, ws, n, h, wd, cin, cout, kh,
                                   kw, sh, sw, ph, pw, (int)ho, (int)wo,
                                   stream)
          : mxt_conv_bn_stats_sm90(x, w, y, part, n, h, wd, cin, cout, kh,
                                   kw, sh, sw, ph, pw, (int)ho, (int)wo,
                                   stream);
  if (err != 0) return err;
  return (int)finalize(part, s1, s2, (int)((m + rows - 1) / rows), cout,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
