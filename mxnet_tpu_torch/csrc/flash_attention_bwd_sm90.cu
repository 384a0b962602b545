// Flash-attention backward for bf16 and float16 on Hopper's tensor cores
// (sm_90a): dK, dV and dQ of O = softmax(Q K^T * scale) V, recomputed tile
// by tile from the forward's logsumexp, with every product on wgmma. The
// two 16-bit types share one template (T16); the PTX building blocks are
// in sm90_common.cuh, shared with the forward (flash_attention_sm90.cu).
//
// Replaces mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel (:313) and its
// streaming twin _bwd_dkdv_stream_kernel (:403), and _bwd_dq_kernel (:362)
// and _bwd_dq_stream_kernel (:458), for 16-bit inputs. float32 inputs go
// to flash_attention_bwd_tf32.cu, which takes each product as three TF32
// ones (one would fail the JAX package's float32 gradient tolerance, rtol
// 2e-4 / atol 2e-5). That is a dispatch by dtype, made in
// flash_attention_bwd.cu's launch(); a bf16 or float16 CUDA input always
// comes here.
//
// The function is the Pallas kernels', with their roundings
// (pallas_ops.py:329-351, :375-391): s = q.k in fp32 times scale,
// p = exp(s - lse), dp = dO.v in fp32, ds = p * (dp - D); p rounded to the
// inputs' 16-bit type before dV += p^T dO, ds rounded to it before
// dK += ds^T q and dQ += ds k; fp32 sums; dK and dQ times scale.
// D = rowsum(dO * O) - glse comes from the caller. Causal rows suffix-align
// to the keys (row i sees keys <= i + tk - tq). There are no atomics: each
// gradient element has one writer, so the gradients are the same bits from
// run to run.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, causal)
// on an H100 SXM: five products over the 524,800 live (row, key) pairs a
// head, 43.0 GFLOP, 43.5 us at 989 TFLOP/s, against 35.4 us for the bytes:
// bound by operations. The split into a dK/dV and a dQ kernel computes S
// and dP twice, seven products: 34.8 us for the dK/dV kernel's four and
// 26.1 us for the dQ kernel's three. What the design does about it:
// - every product is a wgmma (16-bit in, fp32 accumulators) on 64-row
//   warpgroup tiles;
// - tiles stay 16-bit in shared memory, in the 128-byte swizzled layout wgmma
//   reads; nothing is widened to fp32 there;
// - a producer warp streams tiles by TMA (cp.async.bulk.tensor) into a
//   two-stage ring guarded by mbarriers, so the next tile's copy overlaps
//   this one's products;
// - the head dim is padded to a multiple of 16 (the wgmma depth), not to a
//   power of two: 64 and 192 carry no zero columns, 100 runs as 112.
//
// Each block holds one 64-row "resident" tile and streams 64-row tiles past
// it. dK/dV: resident k and v rows, streamed q, dO, lse and D; it computes
// S^T = K Q^T and dP^T = V dO^T, so that k rows are the accumulator's rows,
// and P^T and dS^T, rounded to 16 bits, already sit in registers in the layout
// wgmma takes as its A operand for dV += P^T dO and dK += dS^T Q, with dO
// and Q read from shared memory MN-major (the transpose bit). dQ: resident
// q, dO, lse and D, streamed k and v; S = Q K^T, dP = dO V^T, and dS from
// registers into dQ += dS K. Causal tiles that are fully masked are never
// loaded; only tiles that the diagonal or a ragged edge crosses are masked
// element by element.
//
// Output columns go in groups of at most GROUP = 128 on the grid's y axis:
// the accumulators of a 64 x 128 group (dK and dV: 128 fp32 registers a
// thread) are what one warpgroup can hold. A group of width GN (a multiple
// of 16) is a template instance; a head of d columns runs d / 128 groups of
// 128 and one of the rest, in at most two launches. Each group recomputes S
// and dP over the whole head dim, so for 128 < d S and dP are computed once
// per group. The contraction streams through shared memory in chunks of CW
// columns: the whole padded head (CW = d rounded up to 64) when d <= 256,
// with the resident tiles loaded once, else chunks of 128 with resident
// chunks streamed beside the others; a group's own chunk comes last, and
// its tiles feed the group's products. Any head_dim d >= 1 and any
// tq, tk >= 1 are taken (tq <= tk when causal).
//
// Trouble met and what the code does about it:
// - TMA descriptors need cuTensorMapEncodeTiled from the driver API; the
//   library links no libcuda, so it is reached through
//   cudaGetDriverEntryPoint. Descriptors are built on the host per call
//   (the pointers change) and passed in a __grid_constant__ parameter.
// - TMA needs a global row stride that is a multiple of 16 bytes, so a
//   head_dim with d % 8 != 0 (or a pointer off 16-byte alignment) takes
//   plain loads by the producer warp into the same swizzled layout,
//   zero-filled past the edges, followed by a proxy fence.
// - Registers: at GN 128 the dK/dV consumer holds 128 fp32 accumulators
//   plus S^T and dP^T (64); one consumer warpgroup and one producer warp
//   make a block of 160 threads with up to 255 registers each.
// - Shared memory at head_dim 256: K and V, and two stages of Q and dO,
//   64 rows each in 16 bits, come to 192 KB (static_assert below).
// - Accumulation order: the tensor cores add in another order from the
//   plain version's fp32 einsum, so a few 16-bit results round the other
//   way.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int kDkDv = 0, kDq = 1;
constexpr int BM = 64;          // resident rows: a warpgroup's wgmma M
constexpr int BN = 64;          // streamed rows per tile
constexpr int STAGES = 2;
constexpr int GROUP = 128;      // output columns of a block, at most
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
static_assert(BM == 64 && BN == 64, "one box shape serves every tile");

__host__ __device__ constexpr size_t smem_bytes(int cw, int nres) {
  // 1 KB of alignment slack; resident and streamed tiles; lse and D rows
  // of each stage and of the resident tile; the mbarriers
  return 1024 + (size_t)(2 * nres + 2 * STAGES) * BN * cw * 2 +
         (size_t)(STAGES + 1) * 2 * 64 * 4 + 8 * (2 * STAGES + 1);
}
static_assert(smem_bytes(256, 1) <= 232448 && smem_bytes(128, STAGES) <=
              232448, "a block takes at most 227 KB of shared memory");

struct Params {
  CUtensorMap tm[4];  // q, k, v, dO as 3-D (d, t, bh) 16-bit, when use_tma
  const uint16_t* x[4];  // q, k, v, dO: bf16 or float16 bits
  const float *lse, *dd;
  void *dq, *dk, *dv;
  int tq, tk, d, causal, use_tma;
  int cw, nchunks, nres;  // contraction chunk width, chunks, resident slots
  int group0;             // the first column group of this launch
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
// chunk (chunk = group when chunks are GROUP wide) comes last.
__device__ __forceinline__ int chunk_at(int ci, int g, const Params& p) {
  return p.nchunks == 1 ? 0 : (g + 1 + ci) % p.nchunks;
}

template <typename T16, int KIND, int GN>
__device__ __forceinline__ void bwd_block(const Params& p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tb = BN * p.cw * 2;  // bytes of one tile
  float* rows = reinterpret_cast<float*>(base + (2 * p.nres + 2 * STAGES) *
                                                    tb);
  float* rows_res = rows + STAGES * 128;  // lse, D of the resident q rows
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_res + 128);
  uint64_t* empty = full + STAGES;
  uint64_t* res_bar = empty + STAGES;

  // which tensors are resident (R) and which streamed (S): 0 q, 1 k, 2 v,
  // 3 dO; products X = R0 S0^T and Y = R1 S1^T
  constexpr int R0 = KIND == kDkDv ? 1 : 0, R1 = KIND == kDkDv ? 2 : 3;
  constexpr int S0 = KIND == kDkDv ? 0 : 1, S1 = KIND == kDkDv ? 3 : 2;
  const int t_res = KIND == kDkDv ? p.tk : p.tq;
  const int t_str = KIND == kDkDv ? p.tq : p.tk;
  const int ntiles = (t_res + BM - 1) / BM;
  const int tile = KIND == kDkDv ? (int)(blockIdx.x % ntiles)
                                 : ntiles - 1 - (int)(blockIdx.x % ntiles);
  const int r0 = tile * BM;
  const int bh = (int)(blockIdx.x / ntiles);
  const int g = p.group0 + (int)blockIdx.y;
  const int2 range = stream_range(KIND, r0, p);
  const long long hq = (long long)bh * p.tq * p.d;
  const long long hk = (long long)bh * p.tk * p.d;
  const uint16_t* head[4] = {p.x[0] + hq, p.x[1] + hk, p.x[2] + hk,
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
    // 32 lanes arrive.
    const int lane = threadIdx.x - CONSUMERS;
    if (p.nres == 1) {  // the resident tiles, once
      if (p.use_tma) {
        if (lane == 0) {
          mbar_expect_tx(res_bar, 2 * tb);
          tma_tile(&p.tm[R0], base, p.cw, 0, r0, bh, res_bar);
          tma_tile(&p.tm[R1], base + tb, p.cw, 0, r0, bh, res_bar);
        }
      } else {
        copy_tile(head[R0], t_res, p.d, base, p.cw, 0, r0, lane);
        copy_tile(head[R1], t_res, p.d, base + tb, p.cw, 0, r0, lane);
        fence_async_smem();
      }
    }
    if (KIND == kDq)
      for (int r = lane; r < BM; r += 32) {
        const bool in = r0 + r < p.tq;
        rows_res[r] = in ? p.lse[(long long)bh * p.tq + r0 + r] : 0.f;
        rows_res[64 + r] = in ? p.dd[(long long)bh * p.tq + r0 + r] : 0.f;
      }
    mbar_arrive(res_bar);

    int it = 0;
    for (int t = range.x; t < range.y; ++t) {
      for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int col0 = chunk_at(ci, g, p) * p.cw;
        uint8_t* st = base + (2 * p.nres + 2 * s) * tb;
        uint8_t* rt = base + 2 * s * tb;  // resident chunk, when streamed
        if (p.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[s], (p.nres == 1 ? 2 : 4) * tb);
            tma_tile(&p.tm[S0], st, p.cw, col0, t * BN, bh, &full[s]);
            tma_tile(&p.tm[S1], st + tb, p.cw, col0, t * BN, bh, &full[s]);
            if (p.nres > 1) {
              tma_tile(&p.tm[R0], rt, p.cw, col0, r0, bh, &full[s]);
              tma_tile(&p.tm[R1], rt + tb, p.cw, col0, r0, bh, &full[s]);
            }
          }
        } else {
          copy_tile(head[S0], t_str, p.d, st, p.cw, col0, t * BN, lane);
          copy_tile(head[S1], t_str, p.d, st + tb, p.cw, col0, t * BN, lane);
          if (p.nres > 1) {
            copy_tile(head[R0], t_res, p.d, rt, p.cw, col0, r0, lane);
            copy_tile(head[R1], t_res, p.d, rt + tb, p.cw, col0, r0, lane);
          }
          fence_async_smem();
        }
        if (KIND == kDkDv)
          for (int r = lane; r < BN; r += 32) {
            const bool in = t * BN + r < p.tq;
            const long long at = (long long)bh * p.tq + t * BN + r;
            rows[s * 128 + r] = in ? p.lse[at] : 0.f;
            rows[s * 128 + 64 + r] = in ? p.dd[at] : 0.f;
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
  // rows of this thread in a 64-row accumulator: h = 0, 1
  const int row_base = 16 * warp + lane / 4;
  constexpr int NOUT = KIND == kDkDv ? 2 : 1;  // dV, dK or dQ
  float acc[NOUT][GN / 2];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < GN / 2; ++i) acc[o][i] = 0.f;
  mbar_wait(res_bar, 0);

  int it = 0;
  for (int t = range.x; t < range.y; ++t) {
    float x[32], y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
    int s = 0;
    for (int ci = 0; ci < p.nchunks; ++ci, ++it) {
      s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int col0 = chunk_at(ci, g, p) * p.cw;
      const uint8_t* st = base + (2 * p.nres + 2 * s) * tb;
      const uint8_t* rt = base + (p.nres == 1 ? 0 : 2 * s * tb);
      const int ksteps = (min(p.d - col0, p.cw) + 15) / 16;
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const int acc_on = ci > 0 || ks > 0;
        wgmma_ss64<T16>(x, desc_k(rt, ks), desc_k(st, ks), acc_on);
        wgmma_ss64<T16>(y, desc_k(rt + tb, ks), desc_k(st + tb, ks), acc_on);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(x);
      fence_regs<32>(y);
      if (ci + 1 < p.nchunks) mbar_arrive(&empty[s]);
    }

    // p and ds in place of x and y
    const int s0 = t * BN;
    const int q0 = KIND == kDkDv ? s0 : r0, k0 = KIND == kDkDv ? r0 : s0;
    const bool mask = q0 + 64 > p.tq || k0 + 64 > p.tk ||
                      (p.causal && k0 + 63 > q0 + offset);
    const float* lse_s = rows + s * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
            l = lse_s[cc];
            dd = lse_s[64 + cc];
          } else {
            q = r0 + rr;
            k = s0 + cc;
            l = rows_res[rr];
            dd = rows_res[64 + rr];
          }
          const bool live = !mask || (q < p.tq && k < p.tk &&
                                      (!p.causal || k <= q + offset));
          const float pv = live ? expf(x[i] * p.scale - l) : 0.f;
          x[i] = pv;
          y[i] = pv * (y[i] - dd);
        }

    // the A fragments of the second products: the accumulator's 8-column
    // groups 2ks and 2ks + 1 are k-step ks's columns
    const uint8_t* st = base + (2 * p.nres + 2 * s) * tb;
    const int gatom = (g * GROUP - chunk_at(p.nchunks - 1, g, p) * p.cw) / 64;
    if constexpr (KIND == kDkDv) {
      uint32_t pt[4][4], dst[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[ks][i] = pack2_rn<T16>(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]);
          dst[ks][i] = pack2_rn<T16>(y[8 * ks + 2 * i], y[8 * ks + 2 * i + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // dV += P^T dO, dK += dS^T Q
        wgmma_group<T16, GN>(acc[0], pt[ks], st + tb + gatom * ATOM, ks);
        wgmma_group<T16, GN>(acc[1], dst[ks], st + gatom * ATOM, ks);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<16>(&pt[0][0]);
      fence_regs<16>(&dst[0][0]);
    } else {
      uint32_t ds[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[ks][i] = pack2_rn<T16>(y[8 * ks + 2 * i], y[8 * ks + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // dQ += dS K
        wgmma_group<T16, GN>(acc[0], ds[ks], st + gatom * ATOM, ks);
      wgmma_commit();
      wgmma_wait();
      fence_regs<16>(&ds[0][0]);
    }
#pragma unroll
    for (int o = 0; o < NOUT; ++o) fence_regs<GN / 2>(acc[o]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: rows r0 + row_base + 8h, columns g * GROUP + 8j + 2 t4 + e
  const int c_base = g * GROUP + 2 * t4;
  const long long hout = (long long)bh * t_res * p.d;
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    T16* out = static_cast<T16*>(KIND == kDq ? p.dq
                                             : (o == 0 ? p.dv : p.dk));
    const float mult = (KIND == kDkDv && o == 0) ? 1.f : p.scale;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + row_base + 8 * h;
      if (row >= t_res) continue;
#pragma unroll
      for (int j = 0; j < GN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c_base + 8 * j + e;
          if (c < p.d)
            out[hout + (long long)row * p.d + c] =
                round_to<T16>(acc[o][4 * j + 2 * h + e] * mult);
        }
    }
  }
}

template <typename T16, int GN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_sm90(const __grid_constant__ Params p) {
  bwd_block<T16, kDkDv, GN>(p);
}

template <typename T16, int GN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90(const __grid_constant__ Params p) {
  bwd_block<T16, kDq, GN>(p);
}

// ---- host ----
template <typename T16, int GN>
cudaError_t launch_gn(int which, const Params& p, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  static int configured[2] = {0, 0};
  return which == 0
             ? launch_kernel(flash_bwd_dkdv_sm90<T16, GN>, &configured[0], p,
                             grid, THREADS, smem, stream)
             : launch_kernel(flash_bwd_dq_sm90<T16, GN>, &configured[1], p,
                             grid, THREADS, smem, stream);
}

template <typename T16>
cudaError_t launch_group(int which, int gn, const Params& p, dim3 grid,
                         size_t smem, cudaStream_t s) {
  switch (gn) {
    case 16: return launch_gn<T16, 16>(which, p, grid, smem, s);
    case 32: return launch_gn<T16, 32>(which, p, grid, smem, s);
    case 48: return launch_gn<T16, 48>(which, p, grid, smem, s);
    case 64: return launch_gn<T16, 64>(which, p, grid, smem, s);
    case 80: return launch_gn<T16, 80>(which, p, grid, smem, s);
    case 96: return launch_gn<T16, 96>(which, p, grid, smem, s);
    case 112: return launch_gn<T16, 112>(which, p, grid, smem, s);
    case 128: return launch_gn<T16, 128>(which, p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T16>
int launch_all(int which, Params& p, int bh, int tq, int tk, int d,
               cudaStream_t s) {
  if (p.use_tma)
    for (int i = 0; i < 4; ++i) {
      const int t = (i == 1 || i == 2) ? tk : tq;
      cudaError_t err = tensor_map<T16>(&p.tm[i], p.x[i], bh, t, d);
      if (err != cudaSuccess) return (int)err;
    }
  const int d64 = (d + 63) / 64 * 64;
  p.cw = d64 <= 256 ? d64 : GROUP;
  p.nchunks = (d + p.cw - 1) / p.cw;
  p.nres = p.nchunks == 1 ? 1 : STAGES;
  const size_t smem = smem_bytes(p.cw, p.nres);
  const int t_res = which == 0 ? tk : tq;
  const long long blocks = (long long)((t_res + BM - 1) / BM) * bh;
  const int full_groups = d / GROUP, rest = d - full_groups * GROUP;
  if (blocks > 0x7fffffffLL || full_groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (full_groups > 0) {
    p.group0 = 0;
    cudaError_t err = launch_group<T16>(
        which, GROUP, p, dim3((unsigned)blocks, full_groups), smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (rest > 0) {
    p.group0 = full_groups;
    cudaError_t err = launch_group<T16>(which, (rest + 15) / 16 * 16, p,
                                        dim3((unsigned)blocks, 1), smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// 16-bit dK/dV (which 0) or dQ (which 1) on the tensor cores, for
// flash_attention_bwd.cu's launch(); dtype 1 bfloat16, 2 float16. Returns
// a cudaError_t.
int mxt_flash_attention_bwd_sm90(int which, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* dd, void* dq,
                                 void* dk, void* dv, int bh, int tq, int tk,
                                 int d, float scale, int causal, int dtype,
                                 void* stream) {
  Params p;
  const void* x[4] = {q, k, v, dout};
  bool aligned = true;
  for (int i = 0; i < 4; ++i) {
    p.x[i] = static_cast<const uint16_t*>(x[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
  }
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.use_tma = d % 8 == 0 && aligned;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_all<__nv_bfloat16>(which, p, bh, tq, tk, d, s);
    case 2: return launch_all<__half>(which, p, bh, tq, tk, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
