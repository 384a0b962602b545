// Flash-attention forward for bf16 and float16 on Hopper's tensor cores
// (sm_90a): O = softmax(Q K^T * scale) V and the per-row logsumexp, with
// both products on wgmma, never materialising the tq x tk scores in device
// memory.
//
// Replaces mxnet_tpu/pallas_ops.py:_attn_kernel_resident (:95) and
// _attn_kernel (:55), both launched by _flash_fwd_impl, for 16-bit inputs.
// float32 inputs go to flash_attention_tf32.cu, which takes each product as
// three TF32 ones (one would fail the float32 tolerance, rtol 2e-4). That
// is a dispatch by dtype, made in flash_attention.cu's
// mxt_flash_attention_fwd; a bf16 or float16 CUDA input always comes here.
//
// The function is _online_softmax_step (pallas_ops.py:34-52) and its
// finalisation (:122-124): s = q.k in fp32 times scale; a suffix-aligned
// causal mask (row i sees keys <= i + tk - tq); a running max m and sum l
// over 64-key tiles; p = exp(s - m_new) rounded to v's type before
// acc += p v in fp32, while l sums p unrounded; out = acc / l in q's type
// and lse = m + log l in fp32. Causal k tiles past the diagonal are neither
// loaded nor computed.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, causal)
// on an H100 SXM: q, k, v and O are 16.8 MB each and lse 0.5 MB, 67.6 MB at
// 3.35 TB/s = 20.2 us; the two products over the causal half are 17.2
// GFLOP, 17.4 us at 989 TFLOP/s. So the kernel is bound by bytes, close to
// its operations. What the design does about it:
// - both products are wgmmas (16-bit in, fp32 accumulators) on 64-row
//   warpgroup tiles: S = Q K^T with both operands K-major in shared
//   memory, then O += P V with P from registers and V read MN-major (the
//   transpose bit);
// - p never goes through shared memory: the S accumulator's fragment,
//   rounded to 16 bits in registers, is already the A operand of P V;
// - a producer warp streams K and V tiles by TMA into a two-stage ring
//   guarded by mbarriers, so the next tile's copy overlaps this one's
//   products and softmax; Q is loaded once;
// - tiles stay 16-bit in the 128-byte swizzled layout that TMA writes and
//   wgmma reads.
//
// One block: one consumer warpgroup that owns 64 q rows of one (batch,
// head), and one producer warp. The online softmax runs in registers: a
// thread holds two rows of S, each row spread over a quad of lanes
// (__shfl_xor_sync 1, 2). Only tiles that the diagonal or a ragged edge
// crosses are masked element by element. A row with no live key yet keeps
// m = -inf with no NaN. The heaviest causal q tiles (the last) are
// launched first, over all heads, so the light ones fill the tail.
//
// Any head_dim d >= 1, as in flash_attention_bwd_sm90.cu: output columns go
// in groups of at most GROUP = 128 on the grid's y axis (the 64 x 128 fp32
// accumulator is 64 registers a thread), a group of width GN (a multiple
// of 16) being a template instance; S is summed over the whole head in
// chunks of CW columns (the padded head when d <= 256, with Q loaded once,
// else chunks of 128 with Q's chunk streamed beside K's), the group's own
// chunk last, whose V tile feeds the group's product. A head_dim with
// d % 8 != 0, or a pointer off 16-byte alignment, takes plain loads by the
// producer warp into the same swizzled layout, zero past the edges,
// followed by a proxy fence. Every mbarrier wait traps after a bounded
// spin (sm90_common.cuh), so a pipeline fault ends the launch with an
// error instead of hanging the card.
//
// Trouble met and what the code does about it: ptxas serialises every
// wgmma of a kernel (C7520) when one sits after a divergent path, so the
// waits spin inside one PTX block and the role branch tests a
// __shfl_sync'd value, as in the backward. Decode (tq 16 against tk 1024)
// pads the 64-row tile with zero rows that TMA fills and the epilogue
// never stores.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 64;          // q rows of a block: a warpgroup's wgmma M
constexpr int BN = 64;          // keys per streamed tile
constexpr int STAGES = 2;
constexpr int GROUP = 128;      // output columns of a block, at most
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
static_assert(BM == 64 && BN == 64, "one box shape serves every tile");

__host__ __device__ constexpr size_t smem_bytes(int cw, int nres) {
  // 1 KB of alignment slack; the resident q tiles; K and V of each stage;
  // the mbarriers
  return 1024 + (size_t)(nres + 2 * STAGES) * BN * cw * 2 +
         8 * (2 * STAGES + 1);
}
static_assert(smem_bytes(256, 1) <= 232448 &&
                  smem_bytes(GROUP, STAGES) <= 232448,
              "a block takes at most 227 KB of shared memory");

struct Params {
  CUtensorMap tm[3];     // q, k, v as 3-D (d, t, bh) 16-bit, when use_tma
  const uint16_t* x[3];  // q, k, v: bf16 or float16 bits
  void* o;
  float* lse;
  int bh, tq, tk, d, causal, use_tma;
  int cw, nchunks, nres;  // contraction chunk width, chunks, q slots
  int group0;             // the first column group of this launch
  float scale;
};

// The column chunk of the ci-th step over the contraction: the group's own
// chunk (chunk = group when chunks are GROUP wide) comes last.
__device__ __forceinline__ int chunk_at(int ci, int g, const Params& p) {
  return p.nchunks == 1 ? 0 : (g + 1 + ci) % p.nchunks;
}

// The last k tile that a q tile starting at row r0 meets: under causal
// masking the one its last real row sees, diagonal inclusive
// (pallas_ops.py:_attn_kernel).
__device__ __forceinline__ int last_k_tile(int r0, const Params& p) {
  const int nk = (p.tk + BN - 1) / BN;
  return p.causal ? min((min(r0 + BM, p.tq) - 1 + p.tk - p.tq) / BN, nk - 1)
                  : nk - 1;
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf
// is 0). The softmax runs in base 2: s and m are kept times log2(e), so
// exp(s - m) is one subtraction and one ex2, where expf's range reduction
// took about ten instructions an element and set the softmax's time.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T16, int GN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tb = BN * p.cw * 2;  // bytes of one tile
  uint8_t* ring = base + p.nres * tb;  // K, V of stage s at 2 s tb, + tb
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * STAGES * tb);
  uint64_t* empty = full + STAGES;
  uint64_t* res_bar = empty + STAGES;

  const int ntiles = (p.tq + BM - 1) / BM;
  const int tile = ntiles - 1 - (int)(blockIdx.x / p.bh);
  const int bh = (int)(blockIdx.x % p.bh);
  const int r0 = tile * BM;
  const int g = p.group0 + (int)blockIdx.y;
  const int last = last_k_tile(r0, p);
  const long long hq = (long long)bh * p.tq * p.d;
  const long long hk = (long long)bh * p.tk * p.d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(res_bar, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform in the compiler's eyes: warps 0-3 consume,
  // warp 4 produces
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / CONSUMERS, 0);
  if (role == 1) {
    // ---- producer warp ----
    // Each phase of a barrier: lane 0 announces the TMA bytes and issues
    // the copies (or the warp copies and fences), then all 32 lanes arrive.
    const int lane = threadIdx.x - CONSUMERS;
    if (p.nres == 1) {  // q, once
      if (p.use_tma) {
        if (lane == 0) {
          mbar_expect_tx(res_bar, tb);
          tma_tile(&p.tm[0], base, p.cw, 0, r0, bh, res_bar);
        }
      } else {
        copy_tile(p.x[0] + hq, p.tq, p.d, base, p.cw, 0, r0, lane);
        fence_async_smem();
      }
    }
    mbar_arrive(res_bar);

    int it = 0;
    for (int t = 0; t <= last; ++t) {
      for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int col0 = chunk_at(ci, g, p) * p.cw;
        const bool with_v = ci == p.nchunks - 1;  // the group's own chunk
        uint8_t* kt = ring + 2 * s * tb;
        uint8_t* qt = base + s * tb;  // q's chunk, when streamed
        if (p.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[s], (1 + with_v + (p.nres > 1)) * tb);
            tma_tile(&p.tm[1], kt, p.cw, col0, t * BN, bh, &full[s]);
            if (with_v)
              tma_tile(&p.tm[2], kt + tb, p.cw, col0, t * BN, bh, &full[s]);
            if (p.nres > 1)
              tma_tile(&p.tm[0], qt, p.cw, col0, r0, bh, &full[s]);
          }
        } else {
          copy_tile(p.x[1] + hk, p.tk, p.d, kt, p.cw, col0, t * BN, lane);
          if (with_v)
            copy_tile(p.x[2] + hk, p.tk, p.d, kt + tb, p.cw, col0, t * BN,
                      lane);
          if (p.nres > 1)
            copy_tile(p.x[0] + hq, p.tq, p.d, qt, p.cw, col0, r0, lane);
          fence_async_smem();
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int offset = p.tk - p.tq;
  // rows of this thread in a 64-row accumulator: row_base + 8 h, h = 0, 1;
  // element i = 4 j + 2 h + e sits at column 8 j + 2 t4 + e
  const int row_base = 16 * warp + lane / 4;
  float acc[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(res_bar, 0);

  int it = 0;
  for (int t = 0; t <= last; ++t) {
    // S = Q K^T over the whole head, chunk by chunk
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    int s = 0;
    for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
      s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int col0 = chunk_at(ci, g, p) * p.cw;
      const uint8_t* kt = ring + 2 * s * tb;
      const uint8_t* qt = base + (p.nres == 1 ? 0 : s * tb);
      const int ksteps = (min(p.d - col0, p.cw) + 15) / 16;
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks)
        wgmma_ss64<T16>(x, desc_k(qt, ks), desc_k(kt, ks), ci > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(x);
      if (ci + 1 < p.nchunks) mbar_arrive(&empty[s]);
    }

    // the online softmax step, p in place of s
    const int k0 = t * BN;
    const bool mask =
        k0 + BN > p.tk || (p.causal && k0 + BN - 1 > r0 + offset);
    const float scale2 = p.scale * 1.4426950408889634f;  // times log2(e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = r0 + row_base + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, k = k0 + 8 * j + 2 * t4 + e;
          const bool live =
              !mask || (k < p.tk && (!p.causal || k <= q + offset));
          x[i] = live ? x[i] * scale2 : -INFINITY;
          mx = fmaxf(mx, x[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      // a row with no live key yet keeps m = -inf: exp(-inf - 0) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m_run[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          x[i] = ex2(x[i] - m_use);
          sum += x[i];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * corr + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int j = 0; j < GN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] *= corr;
    }

    // O += P V: the accumulator's 8-column groups 2 ks and 2 ks + 1 are
    // k-step ks's A fragment, p rounded to v's type
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[ks][i] = pack2_rn<T16>(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]);
    const uint8_t* vt = ring + 2 * s * tb + tb;
    const int gatom = (g * GROUP - chunk_at(p.nchunks - 1, g, p) * p.cw) / 64;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_group<T16, GN>(acc, pa[ks], vt + gatom * ATOM, ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs<16>(&pa[0][0]);
    fence_regs<GN / 2>(acc);
    mbar_arrive(&empty[s]);
  }

  // epilogue: out = acc / l in q's type, rows r0 + row_base + 8 h, columns
  // g * GROUP + 8 j + 2 t4 + e; the lse, m back in base e, from column
  // group 0
  T16* out = static_cast<T16*>(p.o) + hq;
  const int c_base = g * GROUP + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + row_base + 8 * h;
    if (row >= p.tq) continue;
    T16* orow = out + (long long)row * p.d;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int c = c_base + 8 * j;
      const float lo = acc[4 * j + 2 * h] / l_run[h];
      const float hi = acc[4 * j + 2 * h + 1] / l_run[h];
      if (p.d % 2 == 0) {  // c is even: both or neither lie inside
        if (c < p.d)
          *reinterpret_cast<uint32_t*>(orow + c) = pack2_rn<T16>(lo, hi);
      } else {
        if (c < p.d) orow[c] = round_to<T16>(lo);
        if (c + 1 < p.d) orow[c + 1] = round_to<T16>(hi);
      }
    }
    if (g == 0 && t4 == 0)
      p.lse[(long long)bh * p.tq + row] =
          m_run[h] * 0.6931471805599453f + logf(l_run[h]);
  }
}

// ---- host ----
template <typename T16, int GN>
cudaError_t launch_gn(const Params& p, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  static int configured = 0;
  return launch_kernel(flash_fwd_sm90<T16, GN>, &configured, p, grid,
                       THREADS, smem, stream);
}

template <typename T16>
cudaError_t launch_group(int gn, const Params& p, dim3 grid, size_t smem,
                         cudaStream_t s) {
  switch (gn) {
    case 16: return launch_gn<T16, 16>(p, grid, smem, s);
    case 32: return launch_gn<T16, 32>(p, grid, smem, s);
    case 48: return launch_gn<T16, 48>(p, grid, smem, s);
    case 64: return launch_gn<T16, 64>(p, grid, smem, s);
    case 80: return launch_gn<T16, 80>(p, grid, smem, s);
    case 96: return launch_gn<T16, 96>(p, grid, smem, s);
    case 112: return launch_gn<T16, 112>(p, grid, smem, s);
    case 128: return launch_gn<T16, 128>(p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T16>
int launch_all(Params& p, cudaStream_t s) {
  if (p.use_tma)
    for (int i = 0; i < 3; ++i) {
      cudaError_t err = tensor_map<T16>(&p.tm[i], p.x[i], p.bh,
                                        i == 0 ? p.tq : p.tk, p.d);
      if (err != cudaSuccess) return (int)err;
    }
  const int d64 = (p.d + 63) / 64 * 64;
  p.cw = d64 <= 256 ? d64 : GROUP;
  p.nchunks = (p.d + p.cw - 1) / p.cw;
  p.nres = p.nchunks == 1 ? 1 : STAGES;
  const size_t smem = smem_bytes(p.cw, p.nres);
  const long long blocks = (long long)((p.tq + BM - 1) / BM) * p.bh;
  const int full_groups = p.d / GROUP, rest = p.d - full_groups * GROUP;
  if (blocks > 0x7fffffffLL || full_groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (full_groups > 0) {
    p.group0 = 0;
    cudaError_t err = launch_group<T16>(
        GROUP, p, dim3((unsigned)blocks, full_groups), smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (rest > 0) {
    p.group0 = full_groups;
    cudaError_t err = launch_group<T16>((rest + 15) / 16 * 16, p,
                                        dim3((unsigned)blocks, 1), smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The 16-bit forward on the tensor cores, for flash_attention.cu's
// mxt_flash_attention_fwd; dtype 1 bfloat16, 2 float16. Returns a
// cudaError_t.
int mxt_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int tq, int tk,
                                 int d, float scale, int causal, int dtype,
                                 void* stream) {
  Params p;
  const void* x[3] = {q, k, v};
  bool aligned = true;
  for (int i = 0; i < 3; ++i) {
    p.x[i] = static_cast<const uint16_t*>(x[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
  }
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.use_tma = d % 8 == 0 && aligned;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_all<__nv_bfloat16>(p, s);
    case 2: return launch_all<__half>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
