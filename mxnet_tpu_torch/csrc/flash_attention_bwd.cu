// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V, recomputed tile by tile from the forward's
// logsumexp, never materialising the tq x tk score matrix in device memory.
//
// Replaces mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel and _bwd_dq_kernel
// (launched by _flash_bwd_impl) and their streaming twins
// _bwd_dkdv_stream_kernel and _bwd_dq_stream_kernel (launched by
// _flash_bwd_stream_impl). The TPU chooses between the two pairs by whether
// one head's sequence fits VMEM; here one block holds only its own tiles,
// so one pair of kernels serves every length. As on the TPU there are two
// kernels, so that each gradient is written once, by one block, with no
// atomics: the gradients are bit-for-bit the same from run to run.
//
// - dkdv: one block per (bh, BK-row k tile). It loops over q tiles from the
//   causal lower bound max(k0 - offset, 0) / BQ (pallas_ops.py:355) and
//   keeps dK and dV in registers in fp32.
// - dq: one block per (bh, BQ-row q tile). It loops over k tiles up to the
//   causal upper bound, the last tile its last real row sees
//   (pallas_ops.py:393).
// Both recompute s = (q . k) * scale and p = exp(s - lse) in fp32, take
// dp = dO . v in fp32 and ds = p * (dp - D), with D = rowsum(dO * O) - glse
// from the caller (an elementwise pass, outside Pallas on the TPU too). The
// roundings are the Pallas kernels': p to dO's type before dV += p^T dO,
// ds to q's (k's) type before dK += ds^T q and dQ += ds k; all sums in
// fp32; dK and dQ times scale.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, bf16,
// causal: 524,800 live (row, key) pairs a head) on an H100 SXM: the function
// needs five products over the live pairs (S, dP, dV, dK, dQ),
// 10 * pairs * d = 43.0 GFLOP, 43.5 us at 989 TFLOP/s; it reads q, k, v, dO
// (16.8 MB each), lse and D (0.5 MB each) and writes dq, dk, dv: 118.5 MB,
// 35.4 us at 3.35 TB/s. So it is bound by operations at 43.5 us. Alone, the
// dK/dV kernel's four products give 34.8 us and the dQ kernel's three
// 26.1 us: the split computes S and dP twice, seven products in all. This
// first version runs them on fp32 FMAs from shared memory, as the forward
// does, so FMA throughput and shared-memory reads, not the bound, set its
// time; the tensor-core (mma/wgmma) version is later work.
//
// Layout: q, dO (bh, tq, d), k, v (bh, tk, d), dq, dk, dv likewise,
// row-major and contiguous, all in float or all in bfloat16; lse and D
// (bh, tq) float. d is a multiple of 8 up to 128; tiles are zero-padded to
// DP (32, 64 or 128) columns, and rows past tq or tk are masked, so any
// tq, tk >= 1 is taken (tq <= tk when causal). The kernels allocate nothing
// and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // k rows per tile
constexpr int THREADS = 256;
// thread (ty, tx), ty and tx in [0, 16), owns rows ty*4..+3 and columns
// tx + 16j of every tile it computes
static_assert(THREADS == 16 * 16 && 16 * 4 == BQ && 16 * 4 == BK,
              "tile and thread map disagree");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the Pallas kernels' .astype before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int DP>
constexpr size_t smem_floats_dkdv() {
  // Qs, dOs, Ks, Vs [64][DP+1]; Ps, dSs [BQ][BK+1]; lse, D [BQ]
  return 4 * (size_t)64 * (DP + 1) + 2 * (size_t)BQ * (BK + 1) + 2 * BQ;
}

template <int DP>
constexpr size_t smem_floats_dq() {
  // Qs, dOs, Ks, Vs [64][DP+1]; dSs [BQ][BK+1]; lse, D [BQ]
  return 4 * (size_t)64 * (DP + 1) + (size_t)BQ * (BK + 1) + 2 * BQ;
}

// Copy rows [r0, r0 + 64) of a (t, d) matrix into a zero-padded [64][DP+1]
// fp32 tile in shared memory.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int t, int d) {
  for (int e = threadIdx.x; e < 64 * DP; e += THREADS) {
    int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (r0 + r < t && c < d) x = to_f32(src[(long long)(r0 + r) * d + c]);
    dst[r * (DP + 1) + c] = x;
  }
}

// lse and D of q rows [q0, q0 + BQ), zero past tq
__device__ __forceinline__ void load_rows(float* lse_s, float* dd_s,
                                          const float* lse, const float* dd,
                                          int q0, int tq) {
  const int r = threadIdx.x;
  if (r < BQ) {
    const bool in = q0 + r < tq;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    dd_s[r] = in ? dd[q0 + r] : 0.f;
  }
}

// The s = Q K^T and dp = dO V^T micro-tiles of thread (ty, tx): q rows
// ty*4+i, k columns tx+16j, fp32 sums over the (zero-padded) head dim.
template <int DP>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * (DP + 1) + c];
      g[i] = dOs[(ty * 4 + i) * (DP + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = Ks[(tx + 16 * j) * (DP + 1) + c];
      w[j] = Vs[(tx + 16 * j) * (DP + 1) + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// p = exp(s * scale - lse) on the live pairs of the tile at (q0, k0), 0
// elsewhere, in place of s; ds = p * (dp - D) in place of dp.
__device__ __forceinline__ void softmax_grad(float s[4][4], float dp[4][4],
                                             const float* lse_s,
                                             const float* dd_s, int ty,
                                             int tx, int q0, int k0, int tq,
                                             int tk, float scale,
                                             int causal) {
  const int offset = tk - tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    const float l = lse_s[ty * 4 + i], dd = dd_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool live = r < tq && col < tk && (!causal || col <= r + offset);
      const float p = live ? expf(s[i][j] * scale - l) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dd);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd, T* __restrict__ dk,
                      T* __restrict__ dv, int tq, int tk, int d, float scale,
                      int causal) {
  constexpr int NJ = DP / 16;   // dK/dV columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (DP + 1);
  float* Ks = dOs + BQ * (DP + 1);
  float* Vs = Ks + BK * (DP + 1);
  float* Ps = Vs + BK * (DP + 1);
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* dd_s = lse_s + BQ;

  const int nk = (tk + BK - 1) / BK;
  // under causal masking the first k tiles meet the most q tiles: they
  // start first, so the short ones fill the tail of the grid
  const int k0 = (int)(blockIdx.x % nk) * BK;
  const long long bh = blockIdx.x / nk;
  const T* qb = q + bh * tq * d;
  const T* dob = dout + bh * tq * d;
  const float* lseb = lse + bh * tq;
  const float* ddb = dd + bh * tq;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile<T, DP>(Ks, k + bh * tk * d, k0, tk, d);
  load_tile<T, DP>(Vs, v + bh * tk * d, k0, tk, d);

  float acc_dk[4][NJ], acc_dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int nq = (tq + BQ - 1) / BQ;
  // the first q tile whose rows reach column k0 (row r sees r + tk - tq)
  const int first = causal ? max(k0 - (tk - tq), 0) / BQ : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DP>(Qs, qb, q0, tq, d);
    load_tile<T, DP>(dOs, dob, q0, tq, d);
    load_rows(lse_s, dd_s, lseb, ddb, q0, tq);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DP>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    softmax_grad(s, dp, lse_s, dd_s, ty, tx, q0, k0, tq, tk, scale, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (ty * 4 + i) * (BK + 1) + tx + 16 * j;
        Ps[e] = round_to<T>(s[i][j]);    // p in dO's type for dV
        dSs[e] = round_to<T>(dp[i][j]);  // ds in q's type for dK
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: k rows ty*4+i, columns tx+16j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float p[4], ds[4], g[NJ], x[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * (BK + 1) + ty * 4 + i];
        ds[i] = dSs[r * (BK + 1) + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = dOs[r * (DP + 1) + tx + 16 * j];
        x[j] = Qs[r * (DP + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_dv[i][j] = fmaf(p[i], g[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(ds[i], x[j], acc_dk[i][j]);
        }
    }
  }

  T* dkb = dk + bh * tk * d;
  T* dvb = dv + bh * tk * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dkb[(long long)row * d + c] = from_f32<T>(acc_dk[i][j] * scale);
        dvb[(long long)row * d + c] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, T* __restrict__ dq, int tq,
                    int tk, int d, float scale, int causal) {
  constexpr int NJ = DP / 16;   // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (DP + 1);
  float* Ks = dOs + BQ * (DP + 1);
  float* Vs = Ks + BK * (DP + 1);
  float* dSs = Vs + BK * (DP + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* dd_s = lse_s + BQ;

  const int nq = (tq + BQ - 1) / BQ;
  // the last q tiles meet the most k tiles under causal masking: they
  // start first
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const long long bh = blockIdx.x / nq;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile<T, DP>(Qs, q + bh * tq * d, q0, tq, d);
  load_tile<T, DP>(dOs, dout + bh * tq * d, q0, tq, d);
  load_rows(lse_s, dd_s, lse + bh * tq, dd + bh * tq, q0, tq);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nkb = (tk + BK - 1) / BK;
  int last = nkb - 1;
  if (causal) {
    // the last k tile the tile's last real row sees, diagonal inclusive
    const int q_last = min(q0 + BQ, tq) - 1;
    last = min((q_last + tk - tq) / BK, nkb - 1);
  }
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DP>(Ks, kb, k0, tk, d);
    load_tile<T, DP>(Vs, vb, k0, tk, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DP>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    softmax_grad(s, dp, lse_s, dd_s, ty, tx, q0, k0, tq, tk, scale, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // ds in k's type for dQ
        dSs[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();

    // dQ += dS K: q rows ty*4+i, columns tx+16j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], x[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j] = Ks[kk * (DP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], x[j], acc[i][j]);
    }
  }

  T* dqb = dq + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dqb[(long long)row * d + c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd;
  void *dq, *dk, *dv;
  int bh, tq, tk, d;
  float scale;
  int causal;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <typename T, int DP>
cudaError_t launch_dkdv(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats_dkdv<DP>() * sizeof(float);
  static bool configured = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<T, DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.tk + BK - 1) / BK) * a.bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_dkdv_kernel<T, DP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq, a.tk, a.d, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats_dq<DP>() * sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.tq + BQ - 1) / BQ) * a.bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_dq_kernel<T, DP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<T*>(a.dq), a.tq, a.tk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// kernel 0: dK/dV, 1: dQ; dtype 0: float32, 1: bfloat16
template <typename T, int DP>
cudaError_t launch_one(int which, const Args& a, cudaStream_t s) {
  return which == 0 ? launch_dkdv<T, DP>(a, s) : launch_dq<T, DP>(a, s);
}

template <typename T>
cudaError_t launch_d(int which, const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch_one<T, 32>(which, a, s);
  if (a.d <= 64) return launch_one<T, 64>(which, a, s);
  return launch_one<T, 128>(which, a, s);
}

int launch(int which, const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 8 || a.d > 128 ||
      a.d % 8 != 0 || (a.causal && a.tq > a.tk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(which, a, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(which, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
int mxt_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dd, void* dk, void* dv, int bh,
                                 int tq, int tk, int d, float scale,
                                 int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, dd, nullptr, dk, dv, bh, tq, tk, d, scale,
         causal};
  return launch(0, a, dtype, stream);
}

int mxt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dd, void* dq, int bh, int tq,
                               int tk, int d, float scale, int causal,
                               int dtype, void* stream) {
  Args a{q, k, v, dout, lse, dd, dq, nullptr, nullptr, bh, tq, tk, d, scale,
         causal};
  return launch(1, a, dtype, stream);
}

}  // extern "C"
