// Convolution with the BatchNorm statistics of its output, for bf16 on
// Hopper's tensor cores (sm_90a): y = conv(x, w) for NHWC x and HWIO w
// (groups 1, no bias), and in the same pass one partial of s1 = sum(y) and
// s2 = sum(y * y) per (M tile, channel), in fp32, taken from the fp32
// accumulators before y is rounded. conv_bn_stats.cu's finalize kernel sums
// the partials over the tiles; its mxt_conv_bn_stats sends bf16 here and
// keeps float32 on its FMA kernel.
//
// Replaces mxnet_tpu/pallas_conv.py:_conv_bn_kernel (:101, launched by
// _conv_bn_stats_impl) for bf16. The conv is an implicit GEMM: M = N * Ho *
// Wo output pixels as rows, Cout columns, a depth K = kh * kw * Cin walked
// as (tap, chunk of 64 input channels); a chunk is 128 bytes, one swizzle
// row.
//
// Bound on an H100 SXM at the ResNet-50 body's 19 shapes, batch 256
// (tools/bench_conv_bn.py:conv_bound): 11 are bound by bytes (x's pixels,
// w and y each moved once at 3.35 TB/s): every conv at 56^2, the 1x1 convs
// at 28^2 but the wide strided one, and the two stride-1 1x1 convs at
// 14^2. The other 8 (the 3x3 convs at 28^2 and below, the wide strided
// 1x1 convs, the 1x1 convs at 7^2) are bound by their 2 M Cout K
// operations at 989 TFLOP/s. The main shape, 3x3 64 -> 64 at 56^2, is 59.2
// GFLOP and 206 MB: 61 us by bytes. What the design does:
// - for the operations: every product is a bf16 wgmma with fp32
//   accumulators, on 128 x BN tiles (BN 64 at Cout <= 64, else 128), two
//   consumer warpgroups of 64 rows each issuing one m64nBNk16 a k step,
//   so that each x tile read from shared memory feeds BN columns;
//   the tiles stay bf16 in the 128-byte swizzled layout that TMA writes and
//   wgmma reads;
// - for the bytes: x and w arrive by TMA, one producer warp keeping a ring
//   of STAGES (x, w) tiles in flight behind mbarriers, and each consumer
//   keeps one group of products in flight while it waits for the next
//   tile; a block's shared memory stays under 100 KB so that two blocks
//   share an SM and one's epilogue overlaps the other's main loop; the
//   statistics cost no bytes beyond the partials, since they are summed
//   while the tile is in registers; y leaves through shared memory in
//   16-byte stores, whole rows at a time. What still costs bytes: a 3x3
//   conv reads each x pixel nine times, once a tap, from L2 (no reuse of
//   the halo in shared memory yet), and w once per M tile.
//
// A (x) by im2col-mode TMA over the flattened M: one copy names the first
// output pixel of the tile and the tap's (dx, dy); the hardware walks 128
// output pixels through the bounding box (-pad .. size - 1 + pad - (k - 1)
// on each axis) at the conv's strides, across rows and images, and zero
// fills the padding and channels past Cin. B (w) by a tiled 3-D map over
// w viewed as (Cout, Cin, kh * kw): one tap and chunk is a (64 Cin, BN
// Cout) slab with Cout contiguous, read MN-major through the transpose
// bit; channels past Cin and columns past Cout are zeros. TMA cannot
// address Cin % 8 != 0 or Cout % 8 != 0 (a row pitch off 16 bytes), a
// pointer off 16 bytes, a stride above 8 or a window outside a 4-D map's
// corner range: such an operand is staged by the producer warp's plain
// loads into the same swizzled layout, zero past the edges, followed by a
// proxy fence. So every bf16 conv that cuda_conv.supported takes runs
// here.
//
// Rows past M (the last tile) are masked out of y and out of s1 and s2
// explicitly, whatever the copies filled them with. The statistics are
// summed in a fixed order: each thread's two rows of a column, then
// __shfl_xor_sync over the 8 lanes holding the same columns (16, 8, 4: a
// butterfly that halves the values each step, so a warp shuffles 7 / 8 of
// a value per column instead of 3), then the 8 warps of the two
// warpgroups through shared memory, in order; there are no atomics, and
// every run gives the same bits.
//
// As in the flash kernels: every mbarrier wait spins inside one PTX block
// and the role branch tests a __shfl_sync'd value, never threadIdx.x, or
// ptxas serialises every wgmma (C7520); a wait traps after a bounded spin
// (sm90_common.cuh).
//
// Layout: x (n, h, w, cin), w (kh, kw, cin, cout), y (n, ho, wo, cout),
// bf16, row-major and contiguous; part (2, m_tiles, cout) float, m_tiles =
// ceil(M / BM).

#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;             // output pixels of a block: 2 x 64 rows
constexpr int BK = 64;              // input channels of a K step
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int WARPS = CONSUMERS / 32;
constexpr int A_BYTES = BM * BK * 2;  // the x tile: two atoms

template <int BN> struct Tile {
  static constexpr int STAGES = BN == 64 ? 4 : 3;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int PITCH = BN + 8;  // a staged y row, in bf16 values
  // 1 KB of alignment slack, the ring, the mbarriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
  // the epilogue reuses the ring: y staged, then the warps' sums
  static_assert(BM * PITCH * 2 + 2 * WARPS * BN * 4 <= STAGES * STAGE,
                "the epilogue fits in the ring");
  static_assert(2 * SMEM <= 228 * 1024 - 2 * 1024,
                "two blocks share an SM");
};

struct Params {
  CUtensorMap tx;  // x, im2col, when tma_x
  CUtensorMap tw;  // w as (cout, cin, kh * kw), when tma_w
  const uint16_t* x;
  const uint16_t* wt;
  uint16_t* y;
  float* part;
  int n, h, wd, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo, m;
  int m_tiles, n_tiles, chunks;
  int tma_x, tma_w, vec_y;
};

// The x tile of one tap and chunk by plain loads from one warp, in the
// layout the im2col copy writes: row r is output pixel m0 + r, its
// channels c0 .. c0 + 63 at input pixel (ho sh - ph + dy, wo sw - pw + dx),
// zeros outside the image, past Cin and past M.
__device__ __forceinline__ void gather_x(const Params& p, uint8_t* dst,
                                         int m0, int c0, int dy, int dx,
                                         int lane) {
  const int hw = p.ho * p.wo;
  for (int e = lane; e < BM * 8; e += 32) {
    const int r = e / 8, cc = e % 8;
    const int m = m0 + r, c = c0 + cc * 8;
    unsigned short v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (m < p.m && c < p.cin) {
      const int img = m / hw, rem = m - img * hw;
      const int ho = rem / p.wo, wo = rem - ho * p.wo;
      const int hi = ho * p.sh - p.ph + dy, wi = wo * p.sw - p.pw + dx;
      if (hi >= 0 && hi < p.h && wi >= 0 && wi < p.wd) {
        const uint16_t* src =
            p.x + (((long long)img * p.h + hi) * p.wd + wi) * p.cin + c;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c + u < p.cin) v[u] = src[u];
      }
    }
    uint4 q;
    q.x = v[0] | (uint32_t)v[1] << 16;
    q.y = v[2] | (uint32_t)v[3] << 16;
    q.z = v[4] | (uint32_t)v[5] << 16;
    q.w = v[6] | (uint32_t)v[7] << 16;
    *reinterpret_cast<uint4*>(dst + (r / 64) * ATOM + (r % 64) * 128 +
                              ((cc ^ (r & 7)) << 4)) = q;
  }
}

// One step of the statistics' butterfly over the lanes that differ in bit
// O: of t1[0 .. 2 HALF) and t2 the same, a lane keeps the upper half when
// its bit O is set, else the lower, adds its partner's values of that half
// into t1[0 .. HALF), and sends the other half. The sizes are template
// arguments so that every index is a constant and the values stay in
// registers.
template <int HALF, int O>
__device__ __forceinline__ void halve(float* t1, float* t2, int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send1 = upper ? t1[i] : t1[i + HALF];
    const float send2 = upper ? t2[i] : t2[i + HALF];
    const float keep1 = upper ? t1[i + HALF] : t1[i];
    const float keep2 = upper ? t2[i + HALF] : t2[i];
    t1[i] = keep1 + __shfl_xor_sync(0xffffffffu, send1, O);
    t2[i] = keep2 + __shfl_xor_sync(0xffffffffu, send2, O);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    conv_bn_stats_sm90(const __grid_constant__ Params p) {
  using TL = Tile<BN>;
  constexpr int NB = BN / 64;  // 64-column pieces
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TL::STAGES * TL::STAGE);
  uint64_t* empty = full + TL::STAGES;

  const int m_tile = (int)blockIdx.x / p.n_tiles;
  const int n0 = ((int)blockIdx.x - m_tile * p.n_tiles) * BN;
  const int m0 = m_tile * BM;
  const int taps = p.kh * p.kw;
  const int nt = taps * p.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TL::STAGES; ++s) {
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
    // issues the copies (or the warp copies and fences), then all 32 lanes
    // arrive.
    const int lane = threadIdx.x - CONSUMERS;
    // the tile's first output pixel and the top-left of its window
    const int hw = p.ho * p.wo;
    const int img = m0 / hw, rem = m0 - img * hw;
    const int ho = rem / p.wo, wo = rem - ho * p.wo;
    const int w_start = wo * p.sw - p.pw, h_start = ho * p.sh - p.ph;
    for (int it = 0; it < nt; ++it) {
      const int s = it % TL::STAGES;
      mbar_wait(&empty[s], ((it / TL::STAGES) & 1) ^ 1);
      const int tap = it / p.chunks;
      const int c0 = (it - tap * p.chunks) * BK;
      const int dy = tap / p.kw, dx = tap - dy * p.kw;
      uint8_t* a = ring + s * TL::STAGE;
      uint8_t* b = a + A_BYTES;
      if (lane == 0) {
        const uint32_t bytes =
            (p.tma_x ? A_BYTES : 0) + (p.tma_w ? TL::B_BYTES : 0);
        if (bytes) mbar_expect_tx(&full[s], bytes);
        if (p.tma_x)
          tma_im2col(&p.tx, a, c0, w_start, h_start, img, (uint16_t)dx,
                     (uint16_t)dy, &full[s]);
        if (p.tma_w) tma_tile(&p.tw, b, BN, n0, c0, tap, &full[s]);
      }
      if (!p.tma_x) gather_x(p, a, m0, c0, dy, dx, lane);
      if (!p.tma_w)
        copy_tile(p.wt + (long long)tap * p.cin * p.cout, p.cin, p.cout, b,
                  BN, n0, c0, lane);
      if (!p.tma_x || !p.tma_w) fence_async_smem();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
  for (int it = 0; it < nt; ++it) {
    const int s = it % TL::STAGES;
    mbar_wait(&full[s], (it / TL::STAGES) & 1);
    const int c0 = (it % p.chunks) * BK;
    const int ksteps = (min(p.cin - c0, BK) + 15) / 16;
    const uint8_t* a = ring + s * TL::STAGE + wg * ATOM;
    const uint8_t* b = ring + s * TL::STAGE + A_BYTES;
    wgmma_fence();
    for (int ks = 0; ks < ksteps; ++ks) {
      if constexpr (BN == 128)
        wgmma_ss128_bt<__nv_bfloat16>(acc, desc_k(a, ks), desc_mn(b, ks), 1);
      else
        wgmma_ss64_bt<__nv_bfloat16>(acc, desc_k(a, ks), desc_mn(b, ks), 1);
    }
    wgmma_commit();
    wgmma_wait1();  // the previous tile's products are done: free its stage
    if (it > 0) mbar_arrive(&empty[(it - 1) % TL::STAGES]);
  }
  wgmma_wait();
  fence_regs<NB * 32>(acc);

  // ---- epilogue ----
  // rows of this thread: r0 + 8 h, h = 0, 1; element 32 nb + 4 j + 2 h + e
  // sits at column 64 nb + 8 j + 2 t4 + e
  const int t4 = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const bool live0 = m0 + r0 < p.m, live1 = m0 + r0 + 8 < p.m;
  // both warpgroups' products are done: the ring is free
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  uint16_t* staged = reinterpret_cast<uint16_t*>(ring);  // BM x PITCH
  float* red = reinterpret_cast<float*>(ring + BM * TL::PITCH * 2);
  // y rounded to nearest, staged; the statistics' values, rows past M
  // left out: value i = 16 nb + 2 j + e of t1 (y) and t2 (y^2) is the sum
  // of this thread's two rows at its column
  constexpr int NC = NB * 16;
  float t1[NC], t2[NC];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * nb + 8 * j + 2 * t4;
      const float* v = acc + 32 * nb + 4 * j;
      *reinterpret_cast<uint32_t*>(staged + r0 * TL::PITCH + col) =
          pack2_rn<__nv_bfloat16>(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(staged + (r0 + 8) * TL::PITCH + col) =
          pack2_rn<__nv_bfloat16>(v[2], v[3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a0 = live0 ? v[e] : 0.f, a1 = live1 ? v[2 + e] : 0.f;
        t1[16 * nb + 2 * j + e] = a0 + a1;
        t2[16 * nb + 2 * j + e] = fmaf(a1, a1, a0 * a0);
      }
    }
  // The 8 lanes holding a column (lane bits 4, 3, 2) add their values by
  // a butterfly that halves them each step: at xor o, a lane keeps half of
  // its values (the upper half when its bit o is set), adds the partner's
  // values of that half, and sends the other half. Each lane ends with
  // the warp's totals of NC / 8 columns, values base .. base + NC / 8 - 1,
  // summed in the same order on every run.
  halve<NC / 2, 16>(t1, t2, lane);
  halve<NC / 4, 8>(t1, t2, lane);
  halve<NC / 8, 4>(t1, t2, lane);
  const int base = (lane & 16 ? NC / 2 : 0) + (lane & 8 ? NC / 4 : 0) +
                   (lane & 4 ? NC / 8 : 0);
#pragma unroll
  for (int k = 0; k < NC / 8; ++k) {
    const int i = base + k;
    const int col = 64 * (i / 16) + 8 * ((i % 16) / 2) + 2 * t4 + i % 2;
    red[warp * BN + col] = t1[k];
    red[(WARPS + warp) * BN + col] = t2[k];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

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

  // y, whole rows in 16-byte pieces, masked to M and Cout
  constexpr int CH = BN / 8;
  for (int e = threadIdx.x; e < BM * CH; e += CONSUMERS) {
    const int r = e / CH, cc = e - (e / CH) * CH;
    const int m = m0 + r, c = n0 + cc * 8;
    if (m >= p.m || c >= p.cout) continue;
    const uint16_t* src = staged + r * TL::PITCH + cc * 8;
    uint16_t* dst = p.y + (long long)m * p.cout + c;
    if (p.vec_y) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c + u < p.cout) dst[u] = src[u];
    }
  }
}

// ---- host ----
bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

bool corner_ok(int v) { return v >= -128 && v <= 127; }

template <int BN>
cudaError_t launch_bn(const Params& p, unsigned blocks, cudaStream_t stream) {
  static int configured = 0;
  if (configured == 0) {
    // as much of the SM's memory as shared memory as it takes: two blocks
    cudaError_t err = cudaFuncSetAttribute(
        conv_bn_stats_sm90<BN>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return launch_kernel(conv_bn_stats_sm90<BN>, &configured, p, dim3(blocks),
                       THREADS, Tile<BN>::SMEM, stream);
}

}  // namespace

extern "C" {

// Rows of the output (output pixels) per M tile of this kernel.
int mxt_conv_bn_stats_sm90_block_rows(void) { return BM; }

// The bf16 conv and its per-tile partials in part (2, ceil(M / BM), cout),
// for conv_bn_stats.cu's mxt_conv_bn_stats, which has checked the shape
// and gives the output size (ho, wo). Returns a cudaError_t.
int mxt_conv_bn_stats_sm90(const void* x, const void* w, void* y, void* part,
                           int n, int h, int wd, int cin, int cout, int kh,
                           int kw, int sh, int sw, int ph, int pw, int ho,
                           int wo, void* stream) {
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.wt = static_cast<const uint16_t*>(w);
  p.y = static_cast<uint16_t*>(y);
  p.part = static_cast<float*>(part);
  p.n = n; p.h = h; p.wd = wd; p.cin = cin; p.cout = cout;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw;
  p.ho = ho; p.wo = wo;
  const long long m = (long long)n * ho * wo;
  if (m > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  p.m_tiles = (p.m + BM - 1) / BM;
  p.chunks = (cin + BK - 1) / BK;
  p.tma_x = cin % 8 == 0 && aligned16(x) && sh <= 8 && sw <= 8 &&
            kh <= 256 && kw <= 256 && corner_ok(-ph) && corner_ok(-pw) &&
            corner_ok(ph - (kh - 1)) && corner_ok(pw - (kw - 1));
  p.tma_w = cout % 8 == 0 && aligned16(w);
  p.vec_y = cout % 8 == 0 && aligned16(y);
  if (p.tma_x) {
    cudaError_t err = im2col_map<__nv_bfloat16>(&p.tx, x, n, h, wd, cin, kh,
                                                kw, sh, sw, ph, pw, BM);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.tma_w) {
    cudaError_t err = tensor_map<__nv_bfloat16>(&p.tw, w, kh * kw, cin, cout);
    if (err != cudaSuccess) return (int)err;
  }
  // tiles 64 wide at Cout <= 64, else 128 wide: one x tile feeds twice the
  // products, which beat 64-wide tiles even where those would leave a
  // smaller last wave on the card (the 7^2 shapes with Cout 512: 392
  // blocks on 264 slots; PERF.md)
  const int bn = cout <= 64 ? 64 : 128;
  p.n_tiles = (cout + bn - 1) / bn;
  const long long blocks = (long long)p.m_tiles * p.n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bn == 64 ? launch_bn<64>(p, (unsigned)blocks, s)
                        : launch_bn<128>(p, (unsigned)blocks, s));
}

}  // extern "C"
