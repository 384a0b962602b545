// Flash-attention forward for float32 on Hopper's tensor cores (sm_90a):
// O = softmax(Q K^T * scale) V and the per-row logsumexp, with both
// products on wgmma in TF32 split three ways (tf32_common.cuh), so that it
// keeps float32's accuracy, never materialising the tq x tk scores in
// device memory.
//
// Replaces mxnet_tpu/pallas_ops.py:_attn_kernel_resident (:95) and
// _attn_kernel (:55), both launched by _flash_fwd_impl, for float32 inputs:
// flash_attention.cu's mxt_flash_attention_fwd sends every float32 input
// here; bf16 and float16 go to flash_attention_sm90.cu.
//
// The function is _online_softmax_step (pallas_ops.py:34-52) and its
// finalisation (:122-124) in float32: s = q.k times scale; a suffix-aligned
// causal mask (row i sees keys <= i + tk - tq); a running max m and sum l
// over 64-key tiles; acc += p v; out = acc / l and lse = m + log l. Causal
// k tiles past the diagonal are neither loaded nor computed. Any tq and
// tk >= 1 (tq <= tk when causal) and any head_dim d >= 1 are taken.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, causal)
// on an H100 SXM, taking a float32-accurate product at the TF32 rate over
// three (165 TFLOP/s): the two products over the causal half are 17.2
// GFLOP, 104 us, against 40 us for the bytes (q, k, v read and O written
// once in fp32): bound by operations. What the design does about it:
// - every product is a wgmma (m64n64k8, tf32 in, fp32 accumulators), three
//   for each product of the function;
// - the split of each tile into its big and small parts is kept off the
//   consumers' path: a producer warpgroup issues the TMA copies (fp32,
//   128-byte swizzle) into a two-stage ring and splits each stage once it
//   has landed, while the consumers run the products of the stage before;
// - two consumer warpgroups of 64 q rows each (a 128-row block, at
//   head_dim <= 64) share every split stage, so a split feeds twice the
//   products, and one warpgroup's softmax runs beside the other's wgmmas.
//
// Layout of the products. wgmma reads tf32 operands from shared memory
// K-major only: there is no transpose bit for 32-bit types. S = Q K^T
// contracts over the head dim, along the rows of both Q and K: K-major as
// they lie. O += P V contracts over the keys, so it takes FA3's form: P
// stays in registers as the tf32 A fragment, split there, and V is written
// transposed (V^T: rows its columns, the keys along them) by the producers
// as they split it, which costs the split nothing more. The S accumulator
// holds a thread's columns {2 t, 2 t + 1} of each 8-key step where the A
// fragment wants {t, t + 4}, so the 8 keys of each k-step are permuted the
// same way in V^T's layout (key 2 t at place t, key 2 t + 1 at place t + 4).
// So P never goes through shared memory, and the rescale of O by the
// softmax's correction runs along the accumulator's rows, as in the 16-bit
// kernel. The transposed form (O^T += V^T P^T, the backward's in
// flash_attention_bwd_tf32.cu) would put P through shared memory and the
// correction along the columns.
//
// Shared memory: every operand carries two fp32 parts. At head_dim <= 64:
// the block's 128 q rows resident (64 KB), and two stages of a 64-key K
// and V (64 KB each): 193 KB. Past it, the contraction runs in chunks of
// CW = 64 columns, one consumer warpgroup a block, with q's 64-row chunk
// streamed beside K's (96 KB a stage), a group's own chunk last, whose V
// feeds the group's product; output columns go in groups of GROUP = 64 on
// the grid's y axis (a 64 x 64 fp32 accumulator, 32 registers a thread).
//
// As in the other sm90 kernels: every mbarrier wait spins inside one PTX
// block and the role branch tests a __shfl_sync'd value, or ptxas
// serialises every wgmma (C7520); a wait traps after a bounded spin
// (sm90_common.cuh). A head_dim with d % 4 != 0, or a pointer off 16-byte
// alignment, takes plain loads by the producers into the same swizzled
// layout, zero past the edges. Only tiles that the diagonal or a ragged
// edge crosses are masked element by element; a row with no live key yet
// keeps m = -inf with no NaN. The heaviest causal q tiles (the last) are
// launched first, over all heads, so the light ones fill the tail. There
// are no atomics: the same inputs give the same bits.

#include <math.h>

#include "tf32_common.cuh"

namespace {

constexpr int BN = 64;          // keys per streamed tile
constexpr int STAGES = 2;
constexpr int GROUP = CW;       // output columns of a block: the PV's N
constexpr int PRODUCERS = 128;  // one warpgroup: the copies and the split
// the parts each product is taken in: 3 (big big, big small, small big);
// 1 would be one TF32 product
constexpr int TERMS = 3;
static_assert(BN % 32 == 0 && BN * CW / 4 % PRODUCERS == 0,
              "split_v's thread map");

// bytes of one part (big or small) of a K or V tile and of 64 q rows
constexpr int KV_TILE = BN * CW * 4;
constexpr int Q_TILE = 64 * CW * 4;

__host__ __device__ constexpr size_t stage_bytes(int wgs, int nchunks) {
  // K and V, two parts each; q's chunk when streamed
  return 4 * (size_t)KV_TILE + (nchunks == 1 ? 0 : (size_t)wgs * 2 * Q_TILE);
}

__host__ __device__ constexpr size_t smem_bytes(int wgs, int nchunks) {
  // 1 KB of alignment slack; q resident (one chunk); the ring; the
  // mbarriers (landed, full, empty of each stage, and q's)
  return 1024 + (nchunks == 1 ? (size_t)wgs * 2 * Q_TILE : 0) +
         STAGES * stage_bytes(wgs, nchunks) + 8 * (3 * STAGES + 1);
}
static_assert(smem_bytes(2, 1) <= 232448 && smem_bytes(1, 2) <= 232448,
              "a block takes at most 227 KB of shared memory");

struct Params {
  CUtensorMap tm[3];  // q, k, v as 3-D (d, t, bh) fp32, when use_tma
  const float* x[3];  // q, k, v
  float* o;
  float* lse;
  int bh, tq, tk, d, causal, use_tma;
  int nchunks;  // contraction chunks of CW columns
  float scale;
};

// The column chunk of the ci-th step over the contraction: the group's own
// chunk (chunk = group) comes last.
__device__ __forceinline__ int chunk_at(int ci, int g, const Params& p) {
  return p.nchunks == 1 ? 0 : (g + 1 + ci) % p.nchunks;
}

// The last k tile that a block of bm q rows from row r0 meets: under
// causal masking the one its last real row sees, diagonal inclusive
// (pallas_ops.py:_attn_kernel).
__device__ __forceinline__ int last_k_tile(int r0, int bm, const Params& p) {
  const int nk = (p.tk + BN - 1) / BN;
  return p.causal ? min((min(r0 + bm, p.tq) - 1 + p.tk - p.tq) / BN, nk - 1)
                  : nk - 1;
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf
// is 0): the softmax runs in base 2, as in flash_attention_sm90.cu
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The producers' split of a V tile, landed raw (BN keys x CW columns, rows
// the keys) in the small part's slot at vt + KV_TILE, into V^T's parts at
// vt and vt + KV_TILE: rows V's columns, the keys along them, key j of
// each 8-key step at place (j % 2) * 4 + j / 2 (the order of P's A
// fragment). A warp reads 32 keys of one 4-column piece (16-byte reads,
// conflict-free) and writes one 128-byte row of V^T per column; every raw
// value is read before the small parts overwrite them.
__device__ __forceinline__ void split_v(uint8_t* vt, int ptid) {
  constexpr int PIECES = BN * CW / 4 / PRODUCERS;  // 16-byte pieces each
  uint8_t* raw = vt + KV_TILE;
  float small[PIECES][4];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int u = i * PRODUCERS + ptid;
    const int key = u % BN, c = u / BN * 4;
    const int place = (key & ~7) | ((key & 1) << 2) | ((key >> 1) & 3);
    const float4 v = *reinterpret_cast<const float4*>(raw + swz(BN, key, c));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = to_tf32(x[e]);
      *reinterpret_cast<float*>(vt + swz(CW, c + e, place)) = b;
      small[i][e] = to_tf32(x[e] - b);
    }
  }
  named_sync<2, PRODUCERS>();
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int u = i * PRODUCERS + ptid;
    const int key = u % BN, c = u / BN * 4;
    const int place = (key & ~7) | ((key & 1) << 2) | ((key >> 1) & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float*>(raw + swz(CW, c + e, place)) = small[i][e];
  }
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128 + PRODUCERS, 1)
    flash_fwd_tf32(const __grid_constant__ Params p) {
  constexpr int BM = 64 * WGS;  // q rows of a block
  constexpr int CONSUMERS = 128 * WGS;
  constexpr int QPART = WGS * Q_TILE;  // one part of the block's q rows
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // q resident [big, small] (one chunk); then each stage [K big, K small,
  // V^T big, V^T small (V lands raw here), q big, q small (streamed)]
  const bool q_res = p.nchunks == 1;
  const int sb = (int)stage_bytes(WGS, p.nchunks);
  uint8_t* qres = base;
  uint8_t* ring = base + (q_res ? 2 * QPART : 0);
  uint64_t* landed = reinterpret_cast<uint64_t*>(ring + STAGES * sb);
  uint64_t* full = landed + STAGES;
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int ntiles = (p.tq + BM - 1) / BM;
  const int tile = ntiles - 1 - (int)(blockIdx.x / p.bh);
  const int bh = (int)(blockIdx.x % p.bh);
  const int r0 = tile * BM;
  const int g = (int)blockIdx.y;
  const int last = last_k_tile(r0, BM, p);
  const int n_it = (last + 1) * p.nchunks;
  const long long hq = (long long)bh * p.tq * p.d;
  const long long hk = (long long)bh * p.tk * p.d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform in the compiler's eyes: the consumer warpgroups
  // first, the producer warpgroup last
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / CONSUMERS, 0);
  if (role == 1) {
    // ---- producer warpgroup ----
    // With TMA, thread 0 issues the copies of step it + 1 (once the
    // consumers have freed its stage) before the warpgroup splits step it;
    // with plain loads, the warpgroup copies each step itself. Then the
    // split, a proxy fence and an arrival of every producer.
    const int ptid = threadIdx.x - CONSUMERS;
    // thread 0, TMA: the copies of step n (k tile n / nchunks, chunk
    // n % nchunks) into stage n % STAGES, once the consumers have freed it
    auto issue = [&](int n) {
      const int sn = n % STAGES, cn = n % p.nchunks;
      const bool v_too = cn == p.nchunks - 1;
      const int col0 = chunk_at(cn, g, p) * CW, k0 = n / p.nchunks * BN;
      uint8_t* dst = ring + sn * sb;
      mbar_wait(&empty[sn], ((n / STAGES) & 1) ^ 1);
      mbar_expect_tx(&landed[sn],
                     KV_TILE * (1 + v_too) + (q_res ? 0 : QPART));
      tma_chunk(&p.tm[1], dst, BN, col0, k0, bh, &landed[sn]);
      if (v_too)
        tma_chunk(&p.tm[2], dst + 3 * KV_TILE, BN, col0, k0, bh,
                  &landed[sn]);
      if (!q_res)
        tma_chunk(&p.tm[0], dst + 4 * KV_TILE, BM, col0, r0, bh,
                  &landed[sn]);
      mbar_arrive(&landed[sn]);
    };
    if (p.use_tma && ptid == 0 && q_res) {
      mbar_expect_tx(q_bar, QPART);
      tma_chunk(&p.tm[0], qres, BM, 0, r0, bh, q_bar);
      mbar_arrive(q_bar);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int ci = it % p.nchunks;
      const bool with_v = ci == p.nchunks - 1;  // the group's own chunk
      uint8_t* st = ring + s * sb;
      if (p.use_tma) {
        if (ptid == 0) {
          if (it == 0) issue(0);
          if (it + 1 < n_it) issue(it + 1);
        }
        mbar_wait(&landed[s], (it / STAGES) & 1);
        if (it == 0 && q_res) mbar_wait(q_bar, 0);
      } else {
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int col0 = chunk_at(ci, g, p) * CW, k0 = it / p.nchunks * BN;
        if (it == 0 && q_res)
          copy_chunk<PRODUCERS>(p.x[0] + hq, p.tq, p.d, qres, BM, 0, r0,
                                ptid);
        copy_chunk<PRODUCERS>(p.x[1] + hk, p.tk, p.d, st, BN, col0, k0, ptid);
        if (with_v)
          copy_chunk<PRODUCERS>(p.x[2] + hk, p.tk, p.d, st + 3 * KV_TILE, BN,
                                col0, k0, ptid);
        if (!q_res)
          copy_chunk<PRODUCERS>(p.x[0] + hq, p.tq, p.d, st + 4 * KV_TILE, BM,
                                col0, r0, ptid);
        named_sync<2, PRODUCERS>();
      }
      if (it == 0 && q_res) split_tile<PRODUCERS>(qres, QPART, ptid);
      split_tile<PRODUCERS>(st, KV_TILE, ptid);
      if (!q_res) split_tile<PRODUCERS>(st + 4 * KV_TILE, QPART, ptid);
      if (with_v) split_v(st + 2 * KV_TILE, ptid);
      fence_async_smem();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int offset = p.tk - p.tq;
  // rows of this thread in its warpgroup's 64-row accumulator: row_base +
  // 8 h, h = 0, 1; element i = 4 j + 2 h + e sits at column 8 j + 2 t4 + e
  const int row_base = 16 * warp + lane / 4;
  const int q_first = r0 + 64 * wg + row_base;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float scale2 = p.scale * 1.4426950408889634f;  // times log2(e)

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
      const uint8_t* st = ring + s * sb;
      // this warpgroup's 64 rows of q (8 KB into each atom)
      const uint8_t* qt = (q_res ? qres : st + 4 * KV_TILE) + wg * 64 * 128;
      const int col0 = chunk_at(ci, g, p) * CW;
      const int ksteps = (min(p.d - col0, CW) + 7) / 8;
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint64_t a = desc_tf32(qt, BM, ks);
        const uint64_t as = desc_tf32(qt + QPART, BM, ks);
        const uint64_t b = desc_tf32(st, BN, ks);
        const uint64_t bs = desc_tf32(st + KV_TILE, BN, ks);
        wgmma_tf32_ss64(x, a, b, ci > 0 || ks > 0);
        if constexpr (TERMS == 3) {
          wgmma_tf32_ss64(x, a, bs, 1);
          wgmma_tf32_ss64(x, as, b, 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(x);
      if (ci + 1 < p.nchunks) mbar_arrive(&empty[s]);
    }

    // the online softmax step, p in place of s
    const int k0 = t * BN;
    const bool mask =
        k0 + BN > p.tk || (p.causal && k0 + BN - 1 > r0 + offset);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q_first + 8 * h;
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
      for (int j = 0; j < GROUP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[4 * j + 2 * h + e] *= corr;
    }

    // O += P V: k-step ks's A fragment (rows g and g + 8, places t and
    // t + 4) is the accumulator's keys 8 ks + 2 t and 8 ks + 2 t + 1, split
    // into big and small parts in registers
    uint32_t pa[BN / 8][2][4];
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = x[4 * ks + ((i & 1) << 1) + (i >> 1)];
        const float b = to_tf32(v);
        pa[ks][0][i] = __float_as_uint(b);
        pa[ks][1][i] = __float_as_uint(to_tf32(v - b));
      }
    const uint8_t* vt = ring + s * sb + 2 * KV_TILE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) {
      const uint64_t b = desc_tf32(vt, CW, ks);
      wgmma_tf32_rs64(acc, pa[ks][0], b);
      if constexpr (TERMS == 3) {
        wgmma_tf32_rs64(acc, pa[ks][0], desc_tf32(vt + KV_TILE, CW, ks));
        wgmma_tf32_rs64(acc, pa[ks][1], b);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs<32>(acc);
    fence_regs<BN / 8 * 2 * 4>(&pa[0][0][0]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: out = acc / l, rows q_first + 8 h, columns g * GROUP + 8 j +
  // 2 t4 + e; the lse, m back in base e, from column group 0
  float* out = p.o + hq;
  const int c_base = g * GROUP + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_first + 8 * h;
    if (row >= p.tq) continue;
    float* orow = out + (long long)row * p.d;
#pragma unroll
    for (int j = 0; j < GROUP / 8; ++j) {
      const int c = c_base + 8 * j;
      const float lo = acc[4 * j + 2 * h] / l_run[h];
      const float hi = acc[4 * j + 2 * h + 1] / l_run[h];
      if (p.d % 2 == 0) {  // c is even: both or neither lie inside
        if (c < p.d) *reinterpret_cast<float2*>(orow + c) = make_float2(lo, hi);
      } else {
        if (c < p.d) orow[c] = lo;
        if (c + 1 < p.d) orow[c + 1] = hi;
      }
    }
    if (g == 0 && t4 == 0)
      p.lse[(long long)bh * p.tq + row] =
          m_run[h] * 0.6931471805599453f + logf(l_run[h]);
  }
}

// ---- host ----
template <int WGS>
cudaError_t launch_wgs(Params& p, cudaStream_t s) {
  if (p.use_tma)
    for (int i = 0; i < 3; ++i) {
      cudaError_t err =
          tensor_map_f32(&p.tm[i], p.x[i], p.bh, i == 0 ? p.tq : p.tk, p.d,
                         i == 0 ? 64 * WGS : BN);
      if (err != cudaSuccess) return err;
    }
  const long long blocks = (long long)((p.tq + 64 * WGS - 1) / (64 * WGS)) *
                           p.bh;
  const int groups = (p.d + GROUP - 1) / GROUP;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return cudaErrorInvalidConfiguration;
  static int configured = 0;
  return launch_kernel(flash_fwd_tf32<WGS>, &configured, p,
                       dim3((unsigned)blocks, groups), WGS * 128 + PRODUCERS,
                       smem_bytes(WGS, p.nchunks), s);
}

}  // namespace

extern "C" {

// The float32 forward on the tensor cores, for flash_attention.cu's
// mxt_flash_attention_fwd. Returns a cudaError_t.
int mxt_flash_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int tq, int tk,
                                 int d, float scale, int causal,
                                 void* stream) {
  Params p;
  const void* x[3] = {q, k, v};
  bool aligned = true;
  for (int i = 0; i < 3; ++i) {
    p.x[i] = static_cast<const float*>(x[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
  }
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.use_tma = d % 4 == 0 && aligned;
  p.nchunks = (d + CW - 1) / CW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two consumer warpgroups share each stage while q fits resident beside
  // the ring; past one chunk, one
  return (int)(p.nchunks == 1 ? launch_wgs<2>(p, s) : launch_wgs<1>(p, s));
}

}  // extern "C"
