// Convolution with the BatchNorm statistics of its output, for Hopper
// (sm_90a): y = conv(x, w) for NHWC x and HWIO w (groups 1, no bias), and
// in the same pass the per-channel sums s1 = sum(y) and s2 = sum(y * y) in
// fp32, taken from the fp32 accumulators before y is rounded.
//
// mxt_conv_bn_stats dispatches by dtype: bfloat16 to the tensor-core
// kernel of conv_bn_stats_sm90.cu (wgmma fed by TMA), float32 to the FMA
// kernel here, since the tensor cores take fp32 only as TF32, whose 10-bit
// mantissa fails the float32 gate (K * 2^-24 of |x| conv |w|). Both write
// one partial of s1 and s2 per (M tile, channel), and this file's finalize
// kernel sums them.
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
// batch, the VMEM budget) have no counterpart.
//
// - conv_bn_stats_kernel (float32): one block per (BM-row M tile,
//   BN-column Cout tile). It loops over (dy, dx, BK-channel Cin chunk), staging the x and
//   w tiles in shared memory as fp32 (two buffers, the next tile's loads in
//   flight while the current one is multiplied), and accumulates an 8 x 4
//   micro-tile a thread in fp32 registers. It writes y rounded to x's type,
//   then sums its tile's fp32 accumulators over its rows into one partial
//   s1 and s2 per (M tile, channel), in a fixed order.
// - conv_bn_stats_finalize: sums the partials over the M tiles, in a fixed
//   order, into s1 and s2.
// CUDA blocks run in no order, so a sum carried across blocks would need
// atomics, whose order, and so whose bits, change from run to run. The
// partials and a second pass give the same bits every run, as the flash
// backward kernels' one-writer design does.
//
// Bound on an H100 SXM, at the ResNet-50 body's shapes at batch 256 in
// bf16: each conv reads x's pixels and w once and writes y once; the 1x1
// convs and the 3x3 conv at 56^2 are bound by those bytes at 3.35 TB/s,
// the 3x3 convs at 28^2 and below and the wide 1x1 convs at 14^2 and 7^2 by
// their 2 * M * Cout * kh * kw * Cin operations at 989 TFLOP/s of bf16
// tensor-core rate. The main case, 3x3 64 -> 64 at 56^2, is 59.2 GFLOP and
// 206 MB: 61 us by bytes. The statistics cost no bytes beyond s1 and s2
// themselves: they are summed while the tile is in registers, which is the
// point of the fusion. The float32 kernel multiplies with fp32 FMAs from
// shared memory, so FMA throughput (67 TFLOP/s at most) sets its time, far
// above the bound; conv_bn_stats_sm90.cu says what the bf16 kernel does
// about each bound.
//
// Layout: x (n, h, w, cin), w (kh, kw, cin, cout), y (n, ho, wo, cout),
// row-major and contiguous, all float or all bfloat16; s1, s2 (cout) float;
// part (2, m_tiles, cout) float scratch from the caller, m_tiles =
// ceil(M / BM), BM the tile height of the dtype's kernel
// (mxt_conv_bn_stats_block_rows). Offsets into x, y
// and part are 64-bit; M, the tile count and each size fit an int. The
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels (GEMM rows) per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // input channels per staged chunk
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // As row length: float4-aligned rows
constexpr int FIN_CH = 32;   // channels per finalize block
constexpr int FIN_GROUPS = THREADS / FIN_CH;
// thread (ty, tx), ty and tx in [0, 16), owns rows ty*8..+7 and columns
// tx*4..+3 of the tile; the x tile is loaded as 8 channels of one row a
// thread, the w tile as 4 channels of one input channel a thread
static_assert(THREADS == 16 * 16 && 16 * 8 == BM && 16 * 4 == BN,
              "tile and thread map disagree");
static_assert(THREADS * 8 == BM * BK && THREADS * 4 == BK * BN,
              "tile loads and thread map disagree");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Eight consecutive elements from a 16-byte-aligned address, as float.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Four consecutive elements from a 16-byte-aligned address.
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

struct ConvShape {
  int n, h, w, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo;
  int m;        // n * ho * wo
  int vec_x;    // cin % 8 == 0 and x 16-byte aligned: 8-wide x loads
  int vec_w;    // cout % 4 == 0 and w, y aligned: 4-wide w loads, y stores
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv_bn_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ part,
                     const ConvShape s) {
  __shared__ __align__(16) float As[2][BK][LDA];   // x tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];    // w tile
  __shared__ float red[2][16][BN];                 // statistics, by ty

  const int n_tiles = (s.cout + BN - 1) / BN;
  const int m_tile = blockIdx.x / n_tiles;
  const int co0 = (blockIdx.x - m_tile * n_tiles) * BN;
  const int m0 = m_tile * BM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // this thread's x row (output pixel) and 8-channel half of a chunk
  const int a_row = tid >> 1, a_half = tid & 1;
  const int m = m0 + a_row;
  const bool row_ok = m < s.m;
  const int hw_out = s.ho * s.wo;
  const int img = row_ok ? m / hw_out : 0;
  const int rem = row_ok ? m - img * hw_out : 0;
  const int ho = rem / s.wo, wo = rem - (rem / s.wo) * s.wo;
  const int hbase = ho * s.sh - s.ph;
  const int wbase = wo * s.sw - s.pw;
  const T* x_img = x + (long long)img * s.h * s.w * s.cin;
  // this thread's w row (input channel) and 4 output channels of a chunk
  const int b_k = tid >> 4, b_col = (tid & 15) * 4;
  const int co_b = co0 + b_col;

  const int chunks = (s.cin + BK - 1) / BK;
  const int taps = s.kh * s.kw;
  const int nt = taps * chunks;

  float ra[8], rb[4];
  auto load_tile = [&](int t) {
    const int tap = t / chunks;
    const int ci0 = (t - tap * chunks) * BK;
    const int dy = tap / s.kw, dx = tap - (tap / s.kw) * s.kw;
    const int hi = hbase + dy, wi = wbase + dx;
    const bool inside = row_ok && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
    const int c = ci0 + a_half * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) ra[j] = 0.f;
    if (inside) {
      const T* p = x_img + ((long long)hi * s.w + wi) * s.cin + c;
      if (s.vec_x && c < s.cin) {
        load8(p, ra);
      } else if (!s.vec_x) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < s.cin) ra[j] = to_f32(p[j]);
      }
    }
    const int ci = ci0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) rb[j] = 0.f;
    if (ci < s.cin) {
      const T* q = w + ((long long)tap * s.cin + ci) * s.cout + co_b;
      if (s.vec_w && co_b < s.cout) {
        load4(q, rb);
      } else if (!s.vec_w) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co_b + j < s.cout) rb[j] = to_f32(q[j]);
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_tile(0);
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    // the buffer written here was last read two tiles ago, before the
    // barrier of the previous iteration
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][a_half * 8 + j][a_row] = ra[j];
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (t + 1 < nt) load_tile(t + 1);   // in flight during the products
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // y, rounded to T; the statistics from the fp32 accumulators, rows past
  // M left out
  float sum1[4] = {0.f, 0.f, 0.f, 0.f}, sum2[4] = {0.f, 0.f, 0.f, 0.f};
  const int co = co0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r >= s.m) continue;
    T* yr = y + (long long)r * s.cout + co;
    if (s.vec_w && co < s.cout) {
      store4(yr, acc[i]);
    } else if (!s.vec_w) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (co + j < s.cout) yr[j] = from_f32<T>(acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sum1[j] += acc[i][j];
      sum2[j] = fmaf(acc[i][j], acc[i][j], sum2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = sum1[j];
    red[1][ty][tx * 4 + j] = sum2[j];
  }
  __syncthreads();
  // threads 0..BN-1 sum s1's column over ty, BN..2BN-1 s2's, in order
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid - which * BN;
    if (co0 + col < s.cout) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) total += red[which][r][col];
      const int m_tiles = (s.m + BM - 1) / BM;
      part[((long long)which * m_tiles + m_tile) * s.cout + co0 + col] = total;
    }
  }
}

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

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, void* s1, void* s2,
                   void* part, ConvShape s, cudaStream_t stream) {
  const long long m_tiles = (s.m + BM - 1) / BM;
  const long long blocks = m_tiles * ((s.cout + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  conv_bn_stats_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(part), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(part, s1, s2, (int)m_tiles, s.cout, stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// conv_bn_stats_sm90.cu: the bf16 kernel, its partials in part
int mxt_conv_bn_stats_sm90(const void* x, const void* w, void* y, void* part,
                           int n, int h, int wd, int cin, int cout, int kh,
                           int kw, int sh, int sw, int ph, int pw, int ho,
                           int wo, void* stream);
int mxt_conv_bn_stats_sm90_block_rows(void);

// Rows of the output (output pixels) per M tile of dtype's kernel (0
// float32, 1 bfloat16; 0 for any other): the caller's scratch `part` holds
// 2 * ceil(M / this) * cout floats.
int mxt_conv_bn_stats_block_rows(int dtype) {
  switch (dtype) {
    case 0: return BM;
    case 1: return mxt_conv_bn_stats_sm90_block_rows();
    default: return 0;
  }
}

// dtype: 0 float32 (the FMA kernel), 1 bfloat16 (the tensor-core kernel of
// conv_bn_stats_sm90.cu). Returns a cudaError_t (0 on success).
int mxt_conv_bn_stats(const void* x, const void* w, void* y, void* s1,
                      void* s2, void* part, int n, int h, int wd, int cin,
                      int cout, int kh, int kw, int sh, int sw, int ph,
                      int pw, int dtype, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  ConvShape s;
  s.n = n; s.h = h; s.w = wd; s.cin = cin; s.cout = cout;
  s.kh = kh; s.kw = kw; s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  if (h + 2LL * ph < kh || wd + 2LL * pw < kw)
    return (int)cudaErrorInvalidValue;
  const long long ho = (h + 2LL * ph - kh) / sh + 1;
  const long long wo = (wd + 2LL * pw - kw) / sw + 1;
  const long long m = (long long)n * ho * wo;
  if (m > 0x7fffffffLL - BM || (long long)kh * kw * cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s.ho = (int)ho; s.wo = (int)wo; s.m = (int)m;
  s.vec_x = cin % 8 == 0 && aligned(x, 16);
  s.vec_w = cout % 4 == 0 && aligned(w, 16) && aligned(y, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, w, y, s1, s2, part, s, st);
    case 1: {
      const int err = mxt_conv_bn_stats_sm90(x, w, y, part, n, h, wd, cin,
                                             cout, kh, kw, sh, sw, ph, pw,
                                             s.ho, s.wo, stream);
      if (err != 0) return err;
      const int rows = mxt_conv_bn_stats_sm90_block_rows();
      return (int)finalize(part, s1, s2, (s.m + rows - 1) / rows, cout, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
