// Flash-attention backward for float32 on Hopper's tensor cores (sm_90a):
// dK, dV and dQ of O = softmax(Q K^T * scale) V, recomputed tile by tile
// from the forward's logsumexp, with every product on wgmma in TF32 split
// three ways, so that it keeps float32's accuracy. The TF32 building
// blocks (the split, the swizzled fp32 layout, its copies, tf32 wgmma) are
// in tf32_common.cuh, shared with the float32 forward and conv; the PTX
// ones (mbarriers, wgmma fences, tensor maps) in sm90_common.cuh, shared
// with the 16-bit kernels (flash_attention_bwd_sm90.cu), whose structure
// this file follows.
//
// Replaces mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel (:313) and its
// streaming twin _bwd_dkdv_stream_kernel (:403), and _bwd_dq_kernel (:362)
// and _bwd_dq_stream_kernel (:458), for float32 inputs. flash_attention_
// bwd.cu's launch() sends every float32 input here; bf16 and float16 go to
// flash_attention_bwd_sm90.cu.
//
// The function is the Pallas kernels' in float32: s = q.k times scale,
// p = exp(s - lse), dp = dO.v, ds = p * (dp - D); dV += p^T dO,
// dK += ds^T q * scale, dQ += ds k * scale. D = rowsum(dO * O) - glse
// comes from the caller. Causal rows suffix-align to the keys (row i sees
// keys <= i + tk - tq). There are no atomics: each gradient element has one
// writer, so the gradients are the same bits from run to run.
//
// Precision. The tensor cores take float32 only as TF32 (10 mantissa
// bits). One TF32 product misses the float32 gradient tolerance (rtol 2e-4,
// atol 2e-5, the JAX package's); three pass it: each operand x is split
// into big = tf32(x) and small = tf32(x - big) (cvt.rna: to nearest, ties
// away), and a b is taken as big_a big_b + big_a small_b + small_a big_b,
// summed in the fp32 accumulators (small_a small_b, about 2^-22 of a b, is
// left out; tf32_common.cuh). tests/test_torch_flash_backward.py emulates
// both on the CPU.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, causal)
// on an H100 SXM, taking a float32-accurate product at the TF32 rate over
// three (165 TFLOP/s): the dK/dV kernel's four products over the 524,800
// live (row, key) pairs a head are 34.4 GFLOP, 209 us; the dQ kernel's
// three 25.8 GFLOP, 156 us; the bytes (q, k, v, dO read, the gradients
// written, in fp32) take 40-50 us: bound by operations. What the design
// does about it:
// - every product is a wgmma (m64nNk8, tf32 in, fp32 accumulators), three
//   for each product of the function;
// - a producer warp streams tiles by TMA (fp32, 128-byte swizzle) into a
//   two-stage ring guarded by mbarriers, so the next tile's copy overlaps
//   this one's products; the consumers split each tile into its big and
//   small parts in shared memory once, and every wgmma of the tile reads
//   them there.
//
// Layout of the products. wgmma reads tf32 operands from shared memory
// K-major only: the transpose bits are for 16-bit types. Each block holds
// one 64-row resident tile and streams BN-row tiles past it (dK/dV:
// resident k and v, streamed q, dO, lse and D; dQ: resident q, dO, lse and
// D, streamed k and v). The first products, X = R0 S0^T and Y = R1 S1^T
// (S^T = K Q^T and dP^T = V dO^T for dK/dV, S = Q K^T and dP = dO V^T for
// dQ), contract over the head dim, along the rows of both tiles: K-major
// as they lie. The second products contract over the streamed rows, so
// they are taken transposed: dV^T += dO^T P, dK^T += Q^T dS and
// dQ^T += K^T dS^T. Their A operand, the streamed tile transposed, goes
// in registers, loaded by the threads from the tile's split parts in
// shared memory; their B operand, P or dS, is the first products'
// accumulator, which the threads write to shared memory row by row (its
// rows the resident rows, the contraction along them): K-major. So no
// tile is transposed in memory, and the register layout of an accumulator
// (which is not the tf32 A fragment's) never has to be converted.
//
// Output columns (the second products' M) go in groups of GROUP = 64 on
// the grid's y axis, one 64-row wgmma tile each. The contraction of the
// first products streams through shared memory in chunks of CW = 64
// columns: at head_dim <= 64 one chunk, with the resident tiles loaded and
// split once; past it, chunks with the resident chunk streamed beside the
// others, a group's own chunk last, so that its tiles feed the group's
// second products. Any head_dim d >= 1 and any tq, tk >= 1 are taken
// (tq <= tk when causal). Causal tiles that are fully masked are never
// loaded; only tiles that the diagonal or a ragged edge crosses are masked
// element by element.
//
// Trouble met and what the code does about it:
// - Shared memory: every operand in shared memory has a big and a small
//   part, in fp32: a 64-row resident tile (two tensors, two parts) takes
//   64 KB, a stage of two 32-row streamed tiles 32 KB, P and dS 32 KB.
//   Streamed tiles of BN = 32 rows (not 64) buy the ring its second stage:
//   160 KB at d <= 64, 224 KB with the resident chunks streamed
//   (static_assert below).
// - TMA needs a global row stride that is a multiple of 16 bytes, so a
//   head_dim with d % 4 != 0 (or a pointer off 16-byte alignment) takes
//   plain loads by the producer warp into the same swizzled layout,
//   zero-filled past the edges.
// - The split parts are written by the threads (the generic proxy) and
//   read by wgmma (the async proxy): each writer fences the proxies, and
//   the consumer warpgroup meets at a named barrier before the products.

#include <math.h>

#include "tf32_common.cuh"

namespace {

constexpr int kDkDv = 0, kDq = 1;
constexpr int BM = 64;          // resident rows: the first products' M
constexpr int BN = 32;          // streamed rows per tile: their N
constexpr int GROUP = CW;       // output columns of a block: a wgmma M
constexpr int STAGES = 2;
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
// the parts each product is taken in: 3 (big big, big small, small big);
// 1 would be one TF32 product
constexpr int TERMS_DKDV = 3;
constexpr int TERMS_DQ = 3;

// bytes of one part (big or small) of a resident tile, a streamed tile and
// P or dS; in each, a 128-byte row holds 32 fp32 columns
constexpr int RES_TILE = BM * CW * 4;
constexpr int STR_TILE = BN * CW * 4;
constexpr int Z_TILE = BM * BN * 4;

__host__ __device__ constexpr size_t smem_bytes(int nres) {
  // 1 KB of alignment slack; resident slots and streamed stages (two
  // tensors, two parts each); P and dS (two parts each); lse and D rows of
  // each stage and of the resident tile; the mbarriers
  return 1024 + (size_t)nres * 4 * RES_TILE + (size_t)STAGES * 4 * STR_TILE +
         4 * Z_TILE + (size_t)(STAGES * 2 * BN + 2 * BM) * 4 +
         8 * (2 * STAGES + 1);
}
static_assert(smem_bytes(STAGES) <= 232448,
              "a block takes at most 227 KB of shared memory");

struct Params {
  CUtensorMap tm[4];  // q, k, v, dO as 3-D (d, t, bh) fp32, when use_tma
  const float* x[4];  // q, k, v, dO
  const float *lse, *dd;
  float *dq, *dk, *dv;
  int tq, tk, d, causal, use_tma;
  int nchunks, nres;  // contraction chunks, resident slots
  float scale;
};

// The streamed tiles [lo, hi) that a block whose resident tile starts at
// row r0 meets: for dK/dV the q tiles from the first whose rows reach key
// r0 (row i sees keys <= i + tk - tq); for dQ the k tiles up to the last
// that the tile's last real row sees, diagonal inclusive.
__device__ __forceinline__ int2 stream_range(int kind, int r0,
                                             const Params& p) {
  const int offset = p.tk - p.tq;
  if (kind == kDkDv) {
    const int nq = (p.tq + BN - 1) / BN;
    const int lo = p.causal ? max(r0 - offset, 0) / BN : 0;
    return make_int2(lo, nq);
  }
  const int nk = (p.tk + BN - 1) / BN;
  const int last =
      p.causal ? min((min(r0 + BM, p.tq) - 1 + offset) / BN, nk - 1) : nk - 1;
  return make_int2(0, last + 1);
}

// The column chunk of the ci-th step over the contraction: a group's own
// chunk (chunk = group) comes last.
__device__ __forceinline__ int chunk_at(int ci, int g, const Params& p) {
  return p.nchunks == 1 ? 0 : (g + 1 + ci) % p.nchunks;
}

template <int KIND>
__device__ __forceinline__ void bwd_block(const Params& p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // resident slots [R0 big, R0 small, R1 big, R1 small], streamed stages
  // [S0 big, S0 small, S1 big, S1 small], then [P big, P small, dS big,
  // dS small]
  uint8_t* res = base;
  uint8_t* str = res + p.nres * 4 * RES_TILE;
  uint8_t* zt = str + STAGES * 4 * STR_TILE;
  float* rows = reinterpret_cast<float*>(zt + 4 * Z_TILE);
  float* rows_res = rows + STAGES * 2 * BN;  // lse, D of the resident rows
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_res + 2 * BM);
  uint64_t* empty = full + STAGES;
  uint64_t* res_bar = empty + STAGES;

  // which tensors are resident (R) and which streamed (S): 0 q, 1 k, 2 v,
  // 3 dO; first products X = R0 S0^T and Y = R1 S1^T
  constexpr int R0 = KIND == kDkDv ? 1 : 0, R1 = KIND == kDkDv ? 2 : 3;
  constexpr int S0 = KIND == kDkDv ? 0 : 1, S1 = KIND == kDkDv ? 3 : 2;
  constexpr int TERMS = KIND == kDkDv ? TERMS_DKDV : TERMS_DQ;
  const int t_res = KIND == kDkDv ? p.tk : p.tq;
  const int t_str = KIND == kDkDv ? p.tq : p.tk;
  const int ntiles = (t_res + BM - 1) / BM;
  const int tile = KIND == kDkDv ? (int)(blockIdx.x % ntiles)
                                 : ntiles - 1 - (int)(blockIdx.x % ntiles);
  const int r0 = tile * BM;
  const int bh = (int)(blockIdx.x / ntiles);
  const int g = (int)blockIdx.y;
  const int2 range = stream_range(KIND, r0, p);
  const long long hq = (long long)bh * p.tq * p.d;
  const long long hk = (long long)bh * p.tk * p.d;
  const float* head[4] = {p.x[0] + hq, p.x[1] + hk, p.x[2] + hk,
                          p.x[3] + hq};

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
    // the copies first, then the warp writes the lse and D rows, then all
    // 32 lanes arrive. The copies land in the tiles' big parts.
    const int lane = threadIdx.x - CONSUMERS;
    if (p.nres == 1) {  // the resident tiles, once
      if (p.use_tma) {
        if (lane == 0) {
          mbar_expect_tx(res_bar, 2 * RES_TILE);
          tma_chunk(&p.tm[R0], res, BM, 0, r0, bh, res_bar);
          tma_chunk(&p.tm[R1], res + 2 * RES_TILE, BM, 0, r0, bh, res_bar);
        }
      } else {
        copy_chunk(head[R0], t_res, p.d, res, BM, 0, r0, lane);
        copy_chunk(head[R1], t_res, p.d, res + 2 * RES_TILE, BM, 0, r0,
                   lane);
      }
    }
    if (KIND == kDq)
      for (int r = lane; r < BM; r += 32) {
        const bool in = r0 + r < p.tq;
        rows_res[r] = in ? p.lse[(long long)bh * p.tq + r0 + r] : 0.f;
        rows_res[BM + r] = in ? p.dd[(long long)bh * p.tq + r0 + r] : 0.f;
      }
    mbar_arrive(res_bar);

    int it = 0;
    for (int t = range.x; t < range.y; ++t) {
      for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int col0 = chunk_at(ci, g, p) * CW;
        uint8_t* st = str + s * 4 * STR_TILE;
        uint8_t* rt = res + s * 4 * RES_TILE;  // resident chunk, streamed
        if (p.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[s], 2 * STR_TILE +
                                         (p.nres == 1 ? 0 : 2 * RES_TILE));
            tma_chunk(&p.tm[S0], st, BN, col0, t * BN, bh, &full[s]);
            tma_chunk(&p.tm[S1], st + 2 * STR_TILE, BN, col0, t * BN, bh,
                      &full[s]);
            if (p.nres > 1) {
              tma_chunk(&p.tm[R0], rt, BM, col0, r0, bh, &full[s]);
              tma_chunk(&p.tm[R1], rt + 2 * RES_TILE, BM, col0, r0, bh,
                        &full[s]);
            }
          }
        } else {
          copy_chunk(head[S0], t_str, p.d, st, BN, col0, t * BN, lane);
          copy_chunk(head[S1], t_str, p.d, st + 2 * STR_TILE, BN, col0,
                     t * BN, lane);
          if (p.nres > 1) {
            copy_chunk(head[R0], t_res, p.d, rt, BM, col0, r0, lane);
            copy_chunk(head[R1], t_res, p.d, rt + 2 * RES_TILE, BM, col0, r0,
                       lane);
          }
        }
        if (KIND == kDkDv)
          for (int r = lane; r < BN; r += 32) {
            const bool in = t * BN + r < p.tq;
            const long long at = (long long)bh * p.tq + t * BN + r;
            rows[s * 2 * BN + r] = in ? p.lse[at] : 0.f;
            rows[s * 2 * BN + BN + r] = in ? p.dd[at] : 0.f;
          }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int offset = p.tk - p.tq;
  // rows of this thread in a 64-row accumulator: row_base + 8h, h = 0, 1
  const int row_base = 16 * warp + lane / 4;
  constexpr int NOUT = KIND == kDkDv ? 2 : 1;  // dV and dK, or dQ
  float acc[NOUT][32];  // out^T: rows the group's columns, cols resident
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[o][i] = 0.f;
  mbar_wait(res_bar, 0);
  if (p.nres == 1) {  // fenced with the first streamed tile's split
    split_tile<CONSUMERS>(res, RES_TILE, tid);
    split_tile<CONSUMERS>(res + 2 * RES_TILE, RES_TILE, tid);
  }

  int it = 0;
  for (int t = range.x; t < range.y; ++t) {
    float x[16], y[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = y[i] = 0.f;
    int s = 0;
    for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
      s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      uint8_t* st = str + s * 4 * STR_TILE;
      uint8_t* rt = res + (p.nres == 1 ? 0 : s * 4 * RES_TILE);
      split_tile<CONSUMERS>(st, STR_TILE, tid);
      split_tile<CONSUMERS>(st + 2 * STR_TILE, STR_TILE, tid);
      if (p.nres > 1) {
        split_tile<CONSUMERS>(rt, RES_TILE, tid);
        split_tile<CONSUMERS>(rt + 2 * RES_TILE, RES_TILE, tid);
      }
      fence_async_smem();
      consumers_sync();
      const int col0 = chunk_at(ci, g, p) * CW;
      const int ksteps = (min(p.d - col0, CW) + 7) / 8;
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const int acc_on = ci > 0 || ks > 0;
        const uint64_t a0 = desc_tf32(rt, BM, ks);
        const uint64_t a0s = desc_tf32(rt + RES_TILE, BM, ks);
        const uint64_t b0 = desc_tf32(st, BN, ks);
        const uint64_t b0s = desc_tf32(st + STR_TILE, BN, ks);
        const uint64_t a1 = desc_tf32(rt + 2 * RES_TILE, BM, ks);
        const uint64_t a1s = desc_tf32(rt + 3 * RES_TILE, BM, ks);
        const uint64_t b1 = desc_tf32(st + 2 * STR_TILE, BN, ks);
        const uint64_t b1s = desc_tf32(st + 3 * STR_TILE, BN, ks);
        wgmma_tf32_ss32(x, a0, b0, acc_on);
        wgmma_tf32_ss32(y, a1, b1, acc_on);
        if constexpr (TERMS == 3) {
          wgmma_tf32_ss32(x, a0, b0s, 1);
          wgmma_tf32_ss32(x, a0s, b0, 1);
          wgmma_tf32_ss32(y, a1, b1s, 1);
          wgmma_tf32_ss32(y, a1s, b1, 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<16>(x);
      fence_regs<16>(y);
      if (ci + 1 < p.nchunks) mbar_arrive(&empty[s]);
    }

    // p and ds in place of x and y
    const int s0 = t * BN;
    const int q0 = KIND == kDkDv ? s0 : r0, k0 = KIND == kDkDv ? r0 : s0;
    const int qn = KIND == kDkDv ? BN : BM, kn = KIND == kDkDv ? BM : BN;
    const bool mask = q0 + qn > p.tq || k0 + kn > p.tk ||
                      (p.causal && k0 + kn - 1 > q0 + offset);
    const float* rows_s = rows + s * 2 * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int rr = row_base + 8 * h, cc = 8 * j + 2 * t4 + e;
          int q, k;
          float l, dd;
          if constexpr (KIND == kDkDv) {
            k = r0 + rr;
            q = s0 + cc;
            l = rows_s[cc];
            dd = rows_s[BN + cc];
          } else {
            q = r0 + rr;
            k = s0 + cc;
            l = rows_res[rr];
            dd = rows_res[BM + rr];
          }
          const bool live = !mask || (q < p.tq && k < p.tk &&
                                      (!p.causal || k <= q + offset));
          const float pv = live ? expf(x[i] * p.scale - l) : 0.f;
          x[i] = pv;
          y[i] = pv * (y[i] - dd);
        }

    // P (dK/dV only) and dS, split, to shared memory: rows the resident
    // rows, the streamed rows along them, the B operand of the second
    // products
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const int off = swz(BM, row_base + 8 * h, 8 * j + 2 * t4);
        if constexpr (KIND == kDkDv) {
          const float2 pb = make_float2(to_tf32(x[i]), to_tf32(x[i + 1]));
          *reinterpret_cast<float2*>(zt + off) = pb;
          *reinterpret_cast<float2*>(zt + Z_TILE + off) = make_float2(
              to_tf32(x[i] - pb.x), to_tf32(x[i + 1] - pb.y));
        }
        const float2 db = make_float2(to_tf32(y[i]), to_tf32(y[i + 1]));
        *reinterpret_cast<float2*>(zt + 2 * Z_TILE + off) = db;
        *reinterpret_cast<float2*>(zt + 3 * Z_TILE + off) = make_float2(
            to_tf32(y[i] - db.x), to_tf32(y[i + 1] - db.y));
      }

    // the A fragments of the second products, from the group's own chunk
    // (the last, in stage s): out o's streamed tile transposed, rows its
    // columns; element (m, k) of k-step kk is tile row k, column m
    const uint8_t* st = str + s * 4 * STR_TILE;
    uint32_t a[NOUT][BN / 8][2][4];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      // dV^T from dO, dK^T from q; dQ^T from k
      const uint8_t* src = st + (KIND == kDkDv && o == 0 ? 2 : 0) * STR_TILE;
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = swz(BN, 8 * kk + t4 + 4 * (i >> 1),
                              row_base + 8 * (i & 1));
          a[o][kk][0][i] = *reinterpret_cast<const uint32_t*>(src + off);
          a[o][kk][1][i] =
              *reinterpret_cast<const uint32_t*>(src + STR_TILE + off);
        }
    }
    fence_async_smem();
    consumers_sync();

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        // dV^T += dO^T P, dK^T += q^T dS; dQ^T += k^T dS^T
        const uint8_t* zb = zt + (KIND == kDkDv && o == 0 ? 0 : 2) * Z_TILE;
        const uint64_t b = desc_tf32(zb, BM, kk);
        wgmma_tf32_rs64(acc[o], a[o][kk][0], b);
        if constexpr (TERMS == 3) {
          wgmma_tf32_rs64(acc[o], a[o][kk][0], desc_tf32(zb + Z_TILE, BM,
                                                         kk));
          wgmma_tf32_rs64(acc[o], a[o][kk][1], b);
        }
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      fence_regs<32>(acc[o]);
      fence_regs<(BN / 8) * 2 * 4>(&a[o][0][0][0]);
    }
    mbar_arrive(&empty[s]);
  }

  // epilogue: out^T row m = row_base + 8h is column g * GROUP + m of the
  // gradient, out^T column n = 8j + 2 t4 + e its row r0 + n
  const long long hout = (long long)bh * t_res * p.d;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    float* out = KIND == kDq ? p.dq : (o == 0 ? p.dv : p.dk);
    const float mult = (KIND == kDkDv && o == 0) ? 1.f : p.scale;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * j + 2 * t4 + e;
        if (row >= t_res) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = g * GROUP + row_base + 8 * h;
          if (c < p.d)
            out[hout + (long long)row * p.d + c] =
                acc[o][4 * j + 2 * h + e] * mult;
        }
      }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_tf32(const __grid_constant__ Params p) {
  bwd_block<kDkDv>(p);
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tf32(const __grid_constant__ Params p) {
  bwd_block<kDq>(p);
}

// ---- host ----
int launch(int which, Params& p, int bh, cudaStream_t s) {
  if (p.use_tma)
    for (int i = 0; i < 4; ++i) {
      const bool resident = which == 0 ? (i == 1 || i == 2)
                                       : (i == 0 || i == 3);
      const int t = (i == 1 || i == 2) ? p.tk : p.tq;
      cudaError_t err = tensor_map_f32(&p.tm[i], p.x[i], bh, t, p.d,
                                       resident ? BM : BN);
      if (err != cudaSuccess) return (int)err;
    }
  p.nchunks = (p.d + CW - 1) / CW;
  p.nres = p.nchunks == 1 ? 1 : STAGES;
  const size_t smem = smem_bytes(p.nres);
  const int t_res = which == 0 ? p.tk : p.tq;
  const long long blocks = (long long)((t_res + BM - 1) / BM) * bh;
  const int groups = (p.d + GROUP - 1) / GROUP;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  static int configured[2] = {0, 0};
  const dim3 grid((unsigned)blocks, groups);
  return (int)(which == 0
                   ? launch_kernel(flash_bwd_dkdv_tf32, &configured[0], p,
                                   grid, THREADS, smem, s)
                   : launch_kernel(flash_bwd_dq_tf32, &configured[1], p,
                                   grid, THREADS, smem, s));
}

}  // namespace

extern "C" {

// float32 dK/dV (which 0) or dQ (which 1) on the tensor cores, for
// flash_attention_bwd.cu's launch(). Returns a cudaError_t.
int mxt_flash_attention_bwd_tf32(int which, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* dd, void* dq,
                                 void* dk, void* dv, int bh, int tq, int tk,
                                 int d, float scale, int causal,
                                 void* stream) {
  Params p;
  const void* x[4] = {q, k, v, dout};
  bool aligned = true;
  for (int i = 0; i < 4; ++i) {
    p.x[i] = static_cast<const float*>(x[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
  }
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.use_tma = d % 4 == 0 && aligned;
  return launch(which, p, bh, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
