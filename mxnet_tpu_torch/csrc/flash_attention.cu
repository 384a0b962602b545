// Flash-attention forward for float32 on Hopper (sm_90a):
// O = softmax(Q K^T * scale) V and the per-row logsumexp, never
// materialising the tq x tk score matrix in device memory. bfloat16 and
// float16 inputs take the tensor-core kernel of flash_attention_sm90.cu
// instead (mxt_flash_attention_fwd below dispatches by dtype): the tensor
// cores take fp32 only as TF32, whose 10-bit mantissa fails the float32
// tolerance, so float32 stays on FMAs.
//
// Replaces mxnet_tpu/pallas_ops.py:_attn_kernel_resident and
// pallas_ops.py:_attn_kernel (both launched by _flash_fwd_impl), for
// float32. Same
// function: online softmax with running max m, normaliser l and
// accumulator acc in fp32; scores scaled after the product; p rounded to
// v's type before the P.V product; causal rows suffix-aligned to the keys
// (row i sees keys <= i + tk - tq); k tiles past the diagonal skipped.
// The TPU kernels' resident/streaming split and their block-size fitting
// are VMEM and tiling limits and have no counterpart here: one CUDA block
// owns a BQ-row q tile of one (batch, head) and loops over BK-row k tiles,
// masking the ragged edge, so any tq, tk >= 1 is taken.
//
// Bound at the LM's shape (batch 8, heads 16, T 1024, head_dim 64, float32,
// causal) on an H100 SXM: the two products over the causal half are 17.2
// GFLOP, 257 us at 67 TFLOP/s of fp32 FMA, against 40.3 us for the bytes.
// Both products run on fp32 FMAs from shared memory, so FMA throughput
// and shared-memory reads set its time.
//
// Layout: q (bh, tq, d), k and v (bh, tk, d), o (bh, tq, d) row-major and
// contiguous, in float; lse (bh, tq) float. d is any head_dim
// >= 1; tiles are zero-padded to DP (32, 64, 128 or 256) columns, and
// every load and store is masked to c < d. A head wider than 256 runs in
// column groups of 256 on the grid's y axis: each block writes its group's
// output columns and sums S over the whole head in chunks of 256 columns,
// reloading q with each chunk; group 0 writes lse. At DP 256 the shared memory
// below is 53,632 floats (214.5 KB, under the 227 KB a block may take) and
// each thread holds acc[4][16] in registers. The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>

// flash_attention_sm90.cu: the 16-bit kernel on the tensor cores
extern "C" int mxt_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int bh, int tq, int tk, int d,
                                            float scale, int causal,
                                            int dtype, void* stream);

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // k rows per tile
constexpr int THREADS = 256;
// the thread maps below cover the tiles exactly
static_assert(THREADS == 4 * BQ && THREADS / 16 * 4 == BQ && BK == 64,
              "tile and thread map disagree");

template <int DP>
constexpr size_t smem_floats() {
  // Qs, Ks [BQ|BK][DP+1]; Vs [BK][DP]; Ss [BQ][BK+1]; m, l, corr [BQ]
  return (size_t)BQ * (DP + 1) + (size_t)BK * (DP + 1) + (size_t)BK * DP +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}
static_assert(smem_floats<256>() * 4 <= 232448,
              "a block takes at most 227 KB of shared memory");

// Copy rows [r0, r0 + rows_tile), columns [c0, c0 + DP) of a (t, d) matrix
// into a zero-padded [rows_tile][ld] fp32 tile in shared memory.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int r0, int rows_tile, int t, int d,
                                          int c0) {
  for (int e = threadIdx.x; e < rows_tile * DP; e += THREADS) {
    int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (r0 + r < t && c0 + c < d)
      x = src[(long long)(r0 + r) * d + c0 + c];
    dst[r * ld + c] = x;
  }
}

// CHUNKED: the head is wider than DP (only at DP 256), so S sums over
// chunks of DP columns; a separate instance, so that the one-chunk kernel
// keeps its registers
template <int DP, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + bh * tq * d;
  const float* kp = k + bh * tk * d;
  const float* vb = v + bh * tk * d;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4..+3, cols tx+16j
  // output columns [g * DP, g * DP + DP); S sums over nch chunks of DP
  // columns (q reloaded with each chunk when there is more than one)
  const int g = blockIdx.y, nch = CHUNKED ? (d + DP - 1) / DP : 1;

  if (!CHUNKED) load_tile<DP>(Qs, DP + 1, qb, q0, BQ, tq, d, 0);
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
    // S = Q K^T on a 4 x 4 micro-tile per thread, fp32
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      __syncthreads();   // the previous tile's or chunk's readers are done
      if (CHUNKED) load_tile<DP>(Qs, DP + 1, qb, q0, BQ, tq, d, ci * DP);
      load_tile<DP>(Ks, DP + 1, kp, k0, BK, tk, d, ci * DP);
      if (ci == 0) load_tile<DP>(Vs, DP, vb, k0, BK, tk, d, g * DP);
      __syncthreads();
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
        srow[j] = p;   // p in v's type (float32) for P.V
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

  float* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= tq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = g * DP + tx + 16 * j;
      if (c < d) ob[(long long)(q0 + r) * d + c] = acc[i][j] / l;
    }
  }
  if (g == 0 && tid < BQ && q0 + tid < tq)   // one group writes lse
    lse[bh * tq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int DP, bool CHUNKED = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, CHUNKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long nq = (tq + BQ - 1) / BQ;
  const long long blocks = nq * bh;
  const int groups = (d + DP - 1) / DP;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, groups);
  flash_fwd_kernel<DP, CHUNKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, d, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int tq, int tk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<32>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  if (d <= 256)
    return launch<256>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream);
  return launch<256, true>(q, k, v, o, lse, bh, tq, tk, d, scale, causal,
                           stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t (0 on
// success).
int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk, int d,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
    case 1:
    case 2:
      return mxt_flash_attention_fwd_sm90(q, k, v, o, lse, bh, tq, tk, d,
                                          scale, causal, dtype, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
