// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// and the per-row logsumexp, never materialising the tq x tk score matrix
// in device memory.
//
// Replaces mxnet_tpu/pallas_ops.py:_attn_kernel_resident and
// pallas_ops.py:_attn_kernel (both launched by _flash_fwd_impl). Same
// function: online softmax with running max m, normaliser l and
// accumulator acc in fp32; scores scaled after the product; p rounded to
// v's type before the P.V product; causal rows suffix-aligned to the keys
// (row i sees keys <= i + tk - tq); k tiles past the diagonal skipped.
// The TPU kernels' resident/streaming split and their block-size fitting
// are VMEM and tiling limits and have no counterpart here: one CUDA block
// owns a BQ-row q tile of one (batch, head) and loops over BK-row k tiles,
// masking the ragged edge, so any tq, tk >= 1 is taken.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, bf16,
// causal) on an H100 SXM: q, k, v and O are 16.8 MB each and lse 0.5 MB,
// 67.6 MB at 3.35 TB/s = 20.2 us; the two products over the causal half
// are 17.2 GFLOP, 17.4 us at 989 TFLOP/s of bf16 tensor-core rate. So the
// kernel is bound by bytes at about 20 us a launch. This first version
// does both products with fp32 FMAs from shared memory (no tensor cores),
// so its FMA and shared-memory traffic, not the bytes, set its time, far
// above that bound; the tensor-core (mma/wgmma) version is later work.
//
// Layout: q (bh, tq, d), k and v (bh, tk, d), o (bh, tq, d) row-major and
// contiguous, in float or bfloat16; lse (bh, tq) float. d is any head_dim
// from 1 to 256; tiles are zero-padded to DP (32, 64, 128 or 256) columns,
// and every load and store is masked to c < d. At DP 256 the shared memory
// below is 53,632 floats (214.5 KB, under the 227 KB a block may take) and
// each thread holds acc[4][16] in registers. The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // k rows per tile
constexpr int THREADS = 256;
// the thread maps below cover the tiles exactly
static_assert(THREADS == 4 * BQ && THREADS / 16 * 4 == BQ && BK == 64,
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

template <int DP>
constexpr size_t smem_floats() {
  // Qs, Ks [BQ|BK][DP+1]; Vs [BK][DP]; Ss [BQ][BK+1]; m, l, corr [BQ]
  return (size_t)BQ * (DP + 1) + (size_t)BK * (DP + 1) + (size_t)BK * DP +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}
static_assert(smem_floats<256>() * 4 <= 232448,
              "a block takes at most 227 KB of shared memory");

// Copy rows [r0, r0 + rows_tile) of a (t, d) matrix into a zero-padded
// [rows_tile][ld] fp32 tile in shared memory.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int r0, int rows_tile, int t,
                                          int d) {
  for (int e = threadIdx.x; e < rows_tile * DP; e += THREADS) {
    int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (r0 + r < t && c < d) x = to_f32(src[(long long)(r0 + r) * d + c]);
    dst[r * ld + c] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int d, float scale,
                 int causal) {
  constexpr int NJ = DP / 16;   // output columns per thread in P.V
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (DP + 1);
  float* Vs = Ks + BK * (DP + 1);
  float* Ss = Vs + BK * DP;
  float* m_s = Ss + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int nq = (tq + BQ - 1) / BQ;
  // the last q tiles do the most work under causal masking: start them
  // first so the short ones fill the tail of the grid
  const int qi = nq - 1 - (int)(blockIdx.x % nq);
  const long long bh = blockIdx.x / nq;
  const int q0 = qi * BQ;
  const int offset = tk - tq;
  const T* qb = q + bh * tq * d;
  const T* kp = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4..+3, cols tx+16j

  load_tile<T, DP>(Qs, DP + 1, qb, q0, BQ, tq, d);
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nkb = (tk + BK - 1) / BK;
  int last = nkb - 1;
  if (causal) {
    // the last live k tile of this q tile, diagonal inclusive
    // (pallas_ops.py:_attn_kernel), from its last real row
    const int q_last = min(q0 + BQ, tq) - 1;
    last = min((q_last + offset) / BK, nkb - 1);
  }

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DP>(Ks, DP + 1, kp, k0, BK, tk, d);
    load_tile<T, DP>(Vs, DP, vb, k0, BK, tk, d);
    __syncthreads();

    // S = Q K^T on a 4 x 4 micro-tile per thread, fp32
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (DP + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * (DP + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < tk && (!causal || col <= r + offset);
        Ss[(ty * 4 + i) * (BK + 1) + tx + 16 * j] =
            live ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row
    {
      const int r = tid >> 2, sub = tid & 3;
      float* srow = Ss + r * (BK + 1);
      const float m_old = m_s[r];
      float mx = -INFINITY;
      for (int j = sub; j < BK; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      // a row with no live key yet keeps m = -inf: exp(-inf - 0) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = sub; j < BK; j += 4) {
        const float p = __expf(srow[j] - m_use);
        sum += p;
        srow[j] = to_f32(from_f32<T>(p));   // p in v's type for P.V
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = m_old == -INFINITY ? 0.f : __expf(m_old - m_use);
      if (sub == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= tq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(long long)(q0 + r) * d + c] = from_f32<T>(acc[i][j] / l);
    }
  }
  if (tid < BQ && q0 + tid < tq)
    lse[bh * tq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long nq = (tq + BQ - 1) / BQ;
  const long long blocks = nq * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, DP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk, int d,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                  causal, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d,
                                          scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
