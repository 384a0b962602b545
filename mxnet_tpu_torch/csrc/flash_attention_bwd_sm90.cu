// Flash-attention backward for bf16 on Hopper's tensor cores (sm_90a): dK,
// dV and dQ of O = softmax(Q K^T * scale) V, recomputed tile by tile from
// the forward's logsumexp, with every product on wgmma.
//
// Replaces mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel (:313) and its
// streaming twin _bwd_dkdv_stream_kernel (:403), and _bwd_dq_kernel (:362)
// and _bwd_dq_stream_kernel (:458), for bf16 inputs. float32 inputs stay on
// the FMA kernels of flash_attention_bwd.cu: the tensor cores take fp32
// only as TF32, whose 10-bit mantissa fails the JAX package's float32
// gradient tolerance (rtol 2e-4 / atol 2e-5). That is a dispatch by dtype,
// made in flash_attention_bwd.cu's launch(); a bf16 CUDA input always
// comes here.
//
// The function is the Pallas kernels', with their roundings
// (pallas_ops.py:329-351, :375-391): s = q.k in fp32 times scale,
// p = exp(s - lse), dp = dO.v in fp32, ds = p * (dp - D); p rounded to bf16
// before dV += p^T dO, ds rounded to bf16 before dK += ds^T q and
// dQ += ds k; fp32 sums; dK and dQ times scale. D = rowsum(dO * O) - glse
// comes from the caller. Causal rows suffix-align to the keys (row i sees
// keys <= i + tk - tq). There are no atomics: each gradient element has one
// writer, so the gradients are the same bits from run to run.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, causal)
// on an H100 SXM: five products over the 524,800 live (row, key) pairs a
// head, 43.0 GFLOP, 43.5 us at 989 TFLOP/s, against 35.4 us for the bytes:
// bound by operations. The split into a dK/dV and a dQ kernel computes S
// and dP twice, seven products: 34.8 us for the dK/dV kernel's four and
// 26.1 us for the dQ kernel's three. What the design does about it:
// - every product is a wgmma (bf16 in, fp32 accumulators) on 64-row
//   warpgroup tiles;
// - tiles stay bf16 in shared memory, in the 128-byte swizzled layout wgmma
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
// and P^T and dS^T, rounded to bf16, already sit in registers in the layout
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
//   64 rows each in bf16, come to 192 KB (static_assert below).
// - Accumulation order: the tensor cores add in another order from the
//   plain version's fp32 einsum, so a few bf16 results round the other way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDkDv = 0, kDq = 1;
constexpr int BM = 64;          // resident rows: a warpgroup's wgmma M
constexpr int BN = 64;          // streamed rows per tile
constexpr int STAGES = 2;
constexpr int GROUP = 128;      // output columns of a block, at most
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int ATOM = 64 * 128;  // 64 rows x 64 bf16 columns: one TMA box
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
  CUtensorMap tm[4];  // q, k, v, dO as 3-D (d, t, bh) bf16, when use_tma
  const __nv_bfloat16* x[4];  // q, k, v, dO
  const float *lse, *dd;
  __nv_bfloat16 *dq, *dk, *dv;
  int tq, tk, d, causal, use_tma;
  int cw, nchunks, nres;  // contraction chunk width, chunks, resident slots
  int group0;             // the first column group of this launch
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// the phase also waits for `bytes` of TMA copies (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed. The spin stays
// inside one PTX block (its labels are local to the block), so that the
// compiler sees no divergent exit before the wgmmas that follow; a wait of
// 2^35 clocks (over 15 s) traps, so that a pipeline fault ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p_done, p_late;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p_done, [%0], %1;\n"
      "@p_done bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p_late, t1, 34359738368;\n"
      "@p_late trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- copies into the swizzled layout ----
// A tile is 64 rows x cw columns, stored as cw / 64 atoms of 64 x 64 bf16;
// in an atom, row r takes 128 bytes at r * 128, its 16-byte chunk c at
// chunk c ^ (r % 8): TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's B128.
__device__ __forceinline__ void tma_tile(const CUtensorMap* tm, uint8_t* dst,
                                         int cw, int col0, int row0, int bh,
                                         uint64_t* bar) {
  for (int b = 0; b < cw / 64; ++b)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
            smem_u32(dst + b * ATOM)),
        "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)),
        "r"(col0 + 64 * b), "r"(row0), "r"(bh)
        : "memory");
}

// the same layout by plain loads from one warp, zero past row t and
// column d; the caller fences for the async proxy
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* head, int t,
                                          int d, uint8_t* dst, int cw,
                                          int col0, int row0, int lane) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(head);
  const int chunks = cw / 8;
  for (int e = lane; e < BN * chunks; e += 32) {
    const int r = e / chunks, cc = e - r * chunks;
    const int row = row0 + r, c = col0 + cc * 8;
    unsigned short v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = (row < t && c + u < d) ? src[(long long)row * d + c + u] : 0;
    uint4 w;
    w.x = v[0] | (uint32_t)v[1] << 16;
    w.y = v[2] | (uint32_t)v[3] << 16;
    w.z = v[4] | (uint32_t)v[5] << 16;
    w.w = v[6] | (uint32_t)v[7] << 16;
    *reinterpret_cast<uint4*>(dst + (cc / 8) * ATOM + r * 128 +
                              (((cc & 7) ^ (r & 7)) << 4)) = w;
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ----
// K-major operand (rows of 64 bf16, the contraction along the row): the
// start address steps 32 bytes per 16 columns inside an atom; 8-row groups
// 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int ks) {
  const uint32_t a = smem_u32(tile + (ks / 4) * ATOM + (ks % 4) * 32);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)64 << 32 | (uint64_t)1 << 62;
}
// MN-major operand (the contraction down the rows, N along a row): one
// atom of 64 columns per instruction (LBO, the next atom, is unused), 8-row
// groups 1024 bytes apart (SBO); the start steps 16 rows per k-step.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* atom, int ks) {
  const uint32_t a = smem_u32(atom + ks * 16 * 128);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(ATOM >> 4) << 16 |
         (uint64_t)64 << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from touching registers across an async product
template <int N> __device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A B^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B, A in registers, B MN-major in shared memory; the
// scale-d predicate is always set (accumulate)
template <int N> struct WgmmaRS;
template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, "
        "1, 1, 1;\n}"
        : ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
        : ACC8(0), ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct WgmmaRS<48> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, "
        "%26, %27}, %28, p, 1, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
        "1, 1, 1;\n}"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
#undef ACC8

// acc (64 x GN) += A (64 x 16, registers) B (16 rows of the tile from
// column atom `atom`, GN columns): pieces of 64 columns, then the rest,
// each starting on an atom
template <int GN>
__device__ __forceinline__ void wgmma_group(float* acc, const uint32_t* a,
                                            const uint8_t* atom, int ks) {
#pragma unroll
  for (int i = 0; i < GN / 64; ++i)
    WgmmaRS<64>::run(acc + 32 * i, a, desc_mn(atom + i * ATOM, ks));
  if constexpr (GN % 64 != 0)
    WgmmaRS<GN % 64>::run(acc + 32 * (GN / 64), a,
                          desc_mn(atom + (GN / 64) * ATOM, ks));
}

// two floats rounded to nearest bf16, packed low then high
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

template <int KIND, int GN>
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
  const __nv_bfloat16* head[4] = {p.x[0] + hq, p.x[1] + hk, p.x[2] + hk,
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
        wgmma_ss64(x, desc_k(rt, ks), desc_k(st, ks), acc_on);
        wgmma_ss64(y, desc_k(rt + tb, ks), desc_k(st + tb, ks), acc_on);
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
          pt[ks][i] = bf16x2_rn(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]);
          dst[ks][i] = bf16x2_rn(y[8 * ks + 2 * i], y[8 * ks + 2 * i + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // dV += P^T dO, dK += dS^T Q
        wgmma_group<GN>(acc[0], pt[ks], st + tb + gatom * ATOM, ks);
        wgmma_group<GN>(acc[1], dst[ks], st + gatom * ATOM, ks);
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
          ds[ks][i] = bf16x2_rn(y[8 * ks + 2 * i], y[8 * ks + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // dQ += dS K
        wgmma_group<GN>(acc[0], ds[ks], st + gatom * ATOM, ks);
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
    __nv_bfloat16* out = KIND == kDq ? p.dq : (o == 0 ? p.dv : p.dk);
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
                __float2bfloat16(acc[o][4 * j + 2 * h + e] * mult);
        }
    }
  }
}

template <int GN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_sm90(const __grid_constant__ Params p) {
  bwd_block<kDkDv, GN>(p);
}

template <int GN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90(const __grid_constant__ Params p) {
  bwd_block<kDq, GN>(p);
}

// ---- host ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (d, t, bh) bf16, 64 x 64 boxes, 128-byte swizzle, zeros out of range
cudaError_t tensor_map(CUtensorMap* tm, const void* ptr, int bh, int t,
                       int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int* configured, const Params& p,
                          dim3 grid, size_t smem, cudaStream_t stream) {
  if ((int)smem > *configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *configured = (int)smem;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int GN>
cudaError_t launch_gn(int which, const Params& p, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  static int configured[2] = {0, 0};
  return which == 0 ? launch_kernel(flash_bwd_dkdv_sm90<GN>, &configured[0],
                                    p, grid, smem, stream)
                    : launch_kernel(flash_bwd_dq_sm90<GN>, &configured[1], p,
                                    grid, smem, stream);
}

cudaError_t launch_group(int which, int gn, const Params& p, dim3 grid,
                         size_t smem, cudaStream_t s) {
  switch (gn) {
    case 16: return launch_gn<16>(which, p, grid, smem, s);
    case 32: return launch_gn<32>(which, p, grid, smem, s);
    case 48: return launch_gn<48>(which, p, grid, smem, s);
    case 64: return launch_gn<64>(which, p, grid, smem, s);
    case 80: return launch_gn<80>(which, p, grid, smem, s);
    case 96: return launch_gn<96>(which, p, grid, smem, s);
    case 112: return launch_gn<112>(which, p, grid, smem, s);
    case 128: return launch_gn<128>(which, p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bf16 dK/dV (which 0) or dQ (which 1) on the tensor cores, for
// flash_attention_bwd.cu's launch(). Returns a cudaError_t.
int mxt_flash_attention_bwd_sm90(int which, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* dd, void* dq,
                                 void* dk, void* dv, int bh, int tq, int tk,
                                 int d, float scale, int causal,
                                 void* stream) {
  Params p;
  const void* x[4] = {q, k, v, dout};
  bool aligned = true;
  for (int i = 0; i < 4; ++i) {
    p.x[i] = static_cast<const __nv_bfloat16*>(x[i]);
    aligned = aligned && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0;
  }
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.use_tma = d % 8 == 0 && aligned;
  if (p.use_tma)
    for (int i = 0; i < 4; ++i) {
      const int t = (i == 1 || i == 2) ? tk : tq;
      cudaError_t err = tensor_map(&p.tm[i], x[i], bh, t, d);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (full_groups > 0) {
    p.group0 = 0;
    cudaError_t err = launch_group(which, GROUP, p,
                                   dim3((unsigned)blocks, full_groups), smem,
                                   s);
    if (err != cudaSuccess) return (int)err;
  }
  if (rest > 0) {
    p.group0 = full_groups;
    cudaError_t err = launch_group(which, (rest + 15) / 16 * 16, p,
                                   dim3((unsigned)blocks, 1), smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
