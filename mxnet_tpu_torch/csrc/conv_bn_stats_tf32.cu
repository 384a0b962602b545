// Convolution with the BatchNorm statistics of its output, for float32 on
// Hopper's tensor cores (sm_90a): y = conv(x, w) for NHWC x and HWIO w
// (groups 1, no bias), stored as float32, and in the same pass one partial
// of s1 = sum(y) and s2 = sum(y * y) per (M tile, channel), taken from the
// fp32 accumulators. Every product is a wgmma in TF32 split three ways
// (tf32_common.cuh), so that y keeps float32's accuracy. conv_bn_stats.cu's
// mxt_conv_bn_stats sends float32 here and its finalize kernel sums the
// partials over the tiles.
//
// Replaces mxnet_tpu/pallas_conv.py:_conv_bn_kernel (:101, launched by
// _conv_bn_stats_impl) for float32. The conv is an implicit GEMM, as in the
// bf16 kernel (conv_bn_stats_sm90.cu), whose structure this file follows:
// M = N * Ho * Wo output pixels as rows, Cout columns, a depth K = kh * kw *
// Cin walked as (tap, chunk of 32 input channels); a chunk is 128 bytes of
// fp32, one swizzle row, so a K step is 32 channels, not 64.
//
// Bound on an H100 SXM at the main ResNet-50 shape (x (256, 56, 56, 64),
// 3x3 64 -> 64), taking a float32-accurate product at the TF32 rate over
// three (165 TFLOP/s): 59.2 GFLOP, 359 us, against 123 us for the bytes (x
// read and y written once in fp32): bound by operations. What the design
// does about it:
// - every product is a wgmma (m64n64k8, tf32 in, fp32 accumulators), three
//   for each product of the function, on 128 x 64 tiles: two consumer
//   warpgroups of 64 rows each, so that each w tile feeds 128 rows;
// - shared memory's bandwidth, which the operands of three products share,
//   is spent once on x: x arrives raw (im2col TMA) and each consumer loads
//   its A fragment from it and splits it into big and small parts in
//   registers, the A operand of register-A wgmmas; w, the B operand, is
//   split once per call by a pre-pass (conv_w_split) into its big and
//   small parts, K-major, and both arrive by tiled TMA. So nothing is split
//   or transposed in shared memory;
// - a block takes 102 KB of shared memory (three stages of x and w's two
//   parts), so two blocks share an SM and one's epilogue and pipeline fill
//   overlap the other's products; a producer warp keeps the ring full.
// Each K step's products are summed in an accumulator of their own and
// added to the running sum rounding to nearest: the tensor cores' fp32
// accumulation truncates, and one accumulator over the whole depth drifted
// y toward zero enough to mislead a BatchNorm's one-pass variance over few
// rows (chip_smoke.py's phase 30, its float32 cut net).
//
// Layout of the products. wgmma reads tf32 operands from shared memory
// K-major only: there is no transpose bit for 32-bit types. The x tile,
// the A operand, is read by the threads: its rows are output pixels and its
// channels lie along them, as TMA lands them. w arrives as HWIO, Cout along
// the row (MN-major); the pre-pass writes it as (2 parts, Cout, kh * kw *
// Cin32), Cin padded with zeros to a multiple of 32, so that a (64 Cout,
// 32 Cin) tile of either part is one TMA box, K-major.
//
// Rows past M (the last tile) are masked out of y and out of s1 and s2
// explicitly, whatever the copies filled them with. The statistics are
// summed in a fixed order: each thread's two rows of a column, then
// __shfl_xor_sync over the 8 lanes holding the same columns (4, 8, 16),
// then the 8 warps of the two warpgroups through shared memory, in order;
// there are no atomics, and every run gives the same bits.
//
// As in the other sm90 kernels: every mbarrier wait spins inside one PTX
// block and the role branch tests a __shfl_sync'd value, or ptxas
// serialises every wgmma (C7520); a wait traps after a bounded spin
// (sm90_common.cuh). TMA cannot address Cin % 4 != 0 (a pixel pitch off 16
// bytes), a pointer off 16 bytes, a stride above 8 or a window outside a
// 4-D map's corner range (im2col_fits): such an x is gathered by the
// producer warp's plain loads into the same layout, zero past the edges. So every float32
// conv that cuda_conv.supported takes runs here.
//
// Layout: x (n, h, w, cin), w (kh, kw, cin, cout), y (n, ho, wo, cout),
// float32, row-major and contiguous; part (2, m_tiles, cout) float, m_tiles
// = ceil(M / BM); ws (2, cout, kh * kw * cin32) float, w's split parts
// (mxt_conv_bn_stats_tf32_weight_floats), scratch from the caller.

#include "tf32_common.cuh"

namespace {

constexpr int BM = 128;             // output pixels of a block: 2 x 64 rows
constexpr int BN = 64;              // output channels of a block
constexpr int BK = 32;              // input channels of a K step: 128 bytes
constexpr int KSTEPS = BK / 8;      // wgmma k-steps of a K step
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int WARPS = CONSUMERS / 32;
// the parts each product is taken in: 3 (big big, big small, small big);
// 1 would be one TF32 product
constexpr int TERMS = 3;

// bytes of the x tile (BM pixels x BK channels, raw) and of one part of the
// w tile (BN x BK)
constexpr int X_TILE = BM * BK * 4;
constexpr int W_PART = BN * BK * 4;
constexpr int STAGE = X_TILE + 2 * W_PART;
// 1 KB of alignment slack; the ring; the warps' statistics; the mbarriers
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE +
                        2 * WARPS * BN * 4 + 8 * 2 * STAGES;
static_assert(2 * SMEM <= 228 * 1024 - 2 * 1024, "two blocks share an SM");

struct Params {
  CUtensorMap tx;  // x, im2col, when tma_x
  CUtensorMap tw;  // ws as (kh * kw * cin32, cout, 2)
  const float* x;
  float* y;
  float* part;
  int n, h, wd, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo, m;
  int m_tiles, n_tiles, chunks;
  int tma_x, vec_y;
};

// The pre-pass: ws[part][co][tap * cin32 + c] = the big (part 0) or small
// (part 1) TF32 part of w[tap][c][co], zero for c >= cin.
__global__ void conv_w_split(const float* __restrict__ w,
                             float* __restrict__ ws, int taps, int cin,
                             int cin32, int cout) {
  const long long depth = (long long)taps * cin32;
  const long long total = depth * cout;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(e / depth);
    const long long k = e - co * depth;
    const int tap = (int)(k / cin32), c = (int)(k - (long long)tap * cin32);
    const float v = c < cin ? w[((long long)tap * cin + c) * cout + co] : 0.f;
    const float b = to_tf32(v);
    ws[e] = b;
    ws[total + e] = to_tf32(v - b);
  }
}

// The x tile of one tap and chunk by the producer warp's plain loads, in
// the layout the im2col copy writes: row r is output pixel m0 + r, its
// channels c0 .. c0 + 31 at input pixel (ho sh - ph + dy, wo sw - pw + dx),
// zeros outside the image, past Cin and past M.
__device__ __forceinline__ void gather_x(const Params& p, uint8_t* dst,
                                         int m0, int c0, int dy, int dx,
                                         int lane) {
  const int hw = p.ho * p.wo;
  for (int e = lane; e < BM * (BK / 4); e += 32) {
    const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
    const int m = m0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < p.m && c0 + c < p.cin) {
      const int img = m / hw, rem = m - img * hw;
      const int ho = rem / p.wo, wo = rem - ho * p.wo;
      const int hi = ho * p.sh - p.ph + dy, wi = wo * p.sw - p.pw + dx;
      if (hi >= 0 && hi < p.h && wi >= 0 && wi < p.wd) {
        const float* src =
            p.x + (((long long)img * p.h + hi) * p.wd + wi) * p.cin + c0 + c;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c0 + c + u < p.cin) v[u] = src[u];
      }
    }
    *reinterpret_cast<float4*>(dst + swz(BM, r, c)) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    conv_bn_stats_tf32(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // each stage: [x, w big, w small]
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * WARPS * BN);
  uint64_t* empty = full + STAGES;

  const int m_tile = (int)blockIdx.x / p.n_tiles;
  const int n0 = ((int)blockIdx.x - m_tile * p.n_tiles) * BN;
  const int m0 = m_tile * BM;
  const int nt = p.kh * p.kw * p.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform in the compiler's eyes: warps 0-7 consume, warp
  // 8 produces
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / CONSUMERS, 0);
  if (role == 1) {
    // ---- producer warp ----
    // Each phase of a full barrier: lane 0 announces the TMA bytes and
    // issues the copies (or the warp gathers x and fences), then all 32
    // lanes arrive.
    const int lane = threadIdx.x - CONSUMERS;
    // the tile's first output pixel and the top-left of its window
    const int hw = p.ho * p.wo;
    const int img = m0 / hw, rem = m0 - img * hw;
    const int ho = rem / p.wo, wo = rem - ho * p.wo;
    const int w_start = wo * p.sw - p.pw, h_start = ho * p.sh - p.ph;
    for (int it = 0; it < nt; ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      const int tap = it / p.chunks;
      const int c0 = (it - tap * p.chunks) * BK;
      const int dy = tap / p.kw, dx = tap - dy * p.kw;
      uint8_t* st = ring + s * STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], (p.tma_x ? X_TILE : 0) + 2 * W_PART);
        if (p.tma_x)
          tma_im2col(&p.tx, st, c0, w_start, h_start, img, (uint16_t)dx,
                     (uint16_t)dy, &full[s]);
        const int k0 = tap * p.chunks * BK + c0;
        tma_box(&p.tw, st + X_TILE, k0, n0, 0, &full[s]);
        tma_box(&p.tw, st + X_TILE + W_PART, k0, n0, 1, &full[s]);
      }
      if (!p.tma_x) {
        gather_x(p, st, m0, c0, dy, dx, lane);
        fence_async_smem();
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  // rows of this thread in the tile: r0 + 8 h, h = 0, 1; in an A fragment,
  // rows r0, r0 + 8 and columns t4, t4 + 4 of each k-step; in the
  // accumulator, element 4 j + 2 h + e at column 8 j + 2 t4 + e
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int it = 0; it < nt; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* xt = ring + s * STAGE;
    const uint8_t* wt = xt + X_TILE;
    // this K step's products in an accumulator of their own, added to acc
    // after: the tensor cores' fp32 accumulation truncates, so one
    // accumulator over the whole depth drifts toward zero (y by a few
    // 1e-6 of itself at K = 576, s2 twice that, which the one-pass
    // variance of a BatchNorm over few rows turns into a wrong variance);
    // the steps' sums are added rounding to nearest
    float kacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) kacc[i] = 0.f;
    // one k-step at a time, so that its A fragment (big [0] and small [1]
    // parts) and both accumulators fit two blocks' registers an SM
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t xa[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = *reinterpret_cast<const float*>(
            xt + swz(BM, r0 + 8 * (i & 1), 8 * ks + t4 + 4 * (i >> 1)));
        const float b = to_tf32(v);
        xa[0][i] = __float_as_uint(b);
        xa[1][i] = __float_as_uint(to_tf32(v - b));
      }
      const uint64_t b = desc_tf32(wt, BN, ks);
      wgmma_fence();
      wgmma_tf32_rs64(kacc, xa[0], b);
      if constexpr (TERMS == 3) {
        wgmma_tf32_rs64(kacc, xa[0], desc_tf32(wt + W_PART, BN, ks));
        wgmma_tf32_rs64(kacc, xa[1], b);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(kacc);
      fence_regs<2 * 4>(&xa[0][0]);
    }
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += kacc[i];
  }

  // ---- epilogue ----
  const bool live[2] = {m0 + r0 < p.m, m0 + r0 + 8 < p.m};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    float* yr = p.y + (long long)(m0 + r0 + 8 * h) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * t4;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (p.vec_y) {  // c is even: both or neither lie inside
        if (c < p.cout) *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
      } else {
        if (c < p.cout) yr[c] = v0;
        if (c + 1 < p.cout) yr[c + 1] = v1;
      }
    }
  }
  // the statistics' values, rows past M left out: value 2 j + e of t1 (y)
  // and t2 (y^2) is the sum of this thread's two rows at its column
  float t1[BN / 4], t2[BN / 4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = live[0] ? acc[4 * j + e] : 0.f;
      const float a1 = live[1] ? acc[4 * j + 2 + e] : 0.f;
      t1[2 * j + e] = a0 + a1;
      t2[2 * j + e] = fmaf(a1, a1, a0 * a0);
    }
  // the 8 lanes holding a column (lane bits 2, 3, 4), in a fixed order
#pragma unroll
  for (int o = 4; o < 32; o *= 2)
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      t1[i] += __shfl_xor_sync(0xffffffffu, t1[i], o);
      t2[i] += __shfl_xor_sync(0xffffffffu, t2[i], o);
    }
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * lane + e;
        red[warp * BN + col] = t1[2 * j + e];
        red[(WARPS + warp) * BN + col] = t2[2 * j + e];
      }
  named_sync<1, CONSUMERS>();

  // the tile's partials: the warps' sums added in order
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, col = threadIdx.x % BN;
    float total = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp)
      total += red[(which * WARPS + wp) * BN + col];
    if (n0 + col < p.cout)
      p.part[((long long)which * p.m_tiles + m_tile) * p.cout + n0 + col] =
          total;
  }
}

// ---- host ----
int cin32_of(int cin) { return (cin + BK - 1) / BK * BK; }

}  // namespace

extern "C" {

// Rows of the output (output pixels) per M tile of this kernel.
int mxt_conv_bn_stats_tf32_block_rows(void) { return BM; }

// Floats of the scratch ws that holds w's split parts.
long long mxt_conv_bn_stats_tf32_weight_floats(int kh, int kw, int cin,
                                               int cout) {
  return 2LL * kh * kw * cin32_of(cin) * cout;
}

// The float32 conv and its per-tile partials in part (2, ceil(M / BM),
// cout), w split into ws first, for conv_bn_stats.cu's mxt_conv_bn_stats,
// which has checked the shape and gives the output size (ho, wo). Returns
// a cudaError_t.
int mxt_conv_bn_stats_tf32(const void* x, const void* w, void* y, void* part,
                           void* ws, int n, int h, int wd, int cin, int cout,
                           int kh, int kw, int sh, int sw, int ph, int pw,
                           int ho, int wo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.part = static_cast<float*>(part);
  p.n = n; p.h = h; p.wd = wd; p.cin = cin; p.cout = cout;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw;
  p.ho = ho; p.wo = wo;
  const long long m = (long long)n * ho * wo;
  const int cin32 = cin32_of(cin);
  const long long depth = (long long)kh * kw * cin32;
  if (m > 0x7fffffffLL - BM || depth > 0x7fffffffLL || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  p.m_tiles = (p.m + BM - 1) / BM;
  p.chunks = cin32 / BK;
  p.tma_x = im2col_fits<float>(x, cin, kh, kw, sh, sw, ph, pw);
  p.vec_y = cout % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  if (p.tma_x) {
    cudaError_t err = im2col_map<float>(&p.tx, x, n, h, wd, cin, kh, kw, sh,
                                        sw, ph, pw, BM);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = tensor_map_f32(&p.tw, ws, 2, cout, (int)depth, BN);
  if (err != cudaSuccess) return (int)err;
  p.n_tiles = (cout + BN - 1) / BN;
  const long long blocks = (long long)p.m_tiles * p.n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;

  const long long wsize = depth * cout;
  const long long wblocks = (wsize + 255) / 256;
  conv_w_split<<<(unsigned)(wblocks < 4096 ? wblocks : 4096), 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float*>(ws), kh * kw, cin,
      cin32, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static int configured = 0;
  if (configured == 0) {
    // as much of the SM's memory as shared memory as it takes: two blocks
    err = cudaFuncSetAttribute(conv_bn_stats_tf32,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_kernel(conv_bn_stats_tf32, &configured, p,
                            dim3((unsigned)blocks), THREADS, SMEM, st);
}

}  // extern "C"
