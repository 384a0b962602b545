// Flash-attention backward for float32 on Hopper (sm_90a): dQ, dK and dV
// of O = softmax(Q K^T * scale) V, recomputed tile by tile from the
// forward's logsumexp, never materialising the tq x tk score matrix in
// device memory. bfloat16 and float16 inputs take the tensor-core kernels
// of flash_attention_bwd_sm90.cu instead (launch() below dispatches by
// dtype):
// the tensor cores take fp32 only as TF32, whose 10-bit mantissa fails the
// JAX package's float32 gradient tolerance, so float32 stays on FMAs.
//
// Replaces mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel and _bwd_dq_kernel
// (launched by _flash_bwd_impl) and their streaming twins
// _bwd_dkdv_stream_kernel and _bwd_dq_stream_kernel (launched by
// _flash_bwd_stream_impl), for float32. The TPU chooses between the two
// pairs by whether one head's sequence fits VMEM; here one block holds only
// its own tiles, so one pair of kernels serves every length. As on the TPU
// there are two kernels, so that each gradient is written once, by one
// block, with no atomics: the gradients are bit-for-bit the same from run
// to run.
//
// - dkdv: one block per (bh, BK-row k tile, column group). It loops over q
//   tiles from the causal lower bound max(k0 - offset, 0) / BQ
//   (pallas_ops.py:355) and keeps dK and dV in registers.
// - dq: one block per (bh, BQ-row q tile, column group). It loops over k
//   tiles up to the causal upper bound, the last tile its last real row
//   sees (pallas_ops.py:393).
// Both recompute s = (q . k) * scale and p = exp(s - lse), take
// dp = dO . v and ds = p * (dp - D), with D = rowsum(dO * O) - glse from
// the caller (an elementwise pass, outside Pallas on the TPU too); all
// sums in fp32; dK and dQ times scale.
//
// Bound at float32 and the LM's shape (batch 8, heads 16, T 1024, head_dim
// 64, causal) on an H100 SXM: the dK/dV kernel's four products over the
// live pairs take 513 us at 67 TFLOP/s of fp32 FMA, the dQ kernel's three
// 385 us; both read q, k, v, dO (33.6 MB each in fp32). They run the
// products on fp32 FMAs from shared memory, so FMA throughput and
// shared-memory reads set their time.
//
// Layout: q, dO (bh, tq, d), k, v (bh, tk, d), dq, dk, dv likewise,
// row-major and contiguous; lse and D (bh, tq) float. d is any head_dim
// >= 1; tiles are zero-padded to DP (32, 64, 128 or 256) columns, every
// load and store is masked to c < d, and rows past tq or tk are masked,
// so any tq, tk >= 1 is taken (tq <= tk when causal). A head wider than
// 256 runs in column groups of DP = 256 on the grid's y axis: each block
// writes its group's columns and sums S and dP over the whole head in
// chunks of 256 columns through the same tiles, the group's own chunk
// last, so that its q, dO (dK/dV) or k (dQ) columns are the ones left in
// shared memory for the group's products. At d <= 256 there is one group
// and the resident tiles load once. The kernels allocate nothing and
// launch on the caller's stream.
//
// Tiles are B x B (B = BQ = BK): 64 rows up to DP 128, 32 rows at DP 256.
// The dK/dV kernel keeps four [B][DP+1] fp32 tiles (q, dO, k, v) and two
// [B][B+1] (p, ds) in shared memory: at B 64 and DP 256 that is 74,240
// floats, 297 KB, over the 227 KB a block may take; at B 32 it is 35,072
// floats, 140 KB (the dQ kernel 34,016). So the DP 256 instance halves the
// tile rows, and the thread map follows B: thread (ty, tx) owns rows
// ty*RI..+RI-1 and columns tx + 16j (RI = RJ = B / 16) of each B x B score
// tile, and rows ty*RI..+RI-1, columns tx + 16j (DP / 16 of them) of its
// gradient tile.

#include <cuda_runtime.h>
#include <math.h>

// flash_attention_bwd_sm90.cu: the 16-bit kernels on the tensor cores
extern "C" int mxt_flash_attention_bwd_sm90(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, void* dk, void* dv, int bh,
    int tq, int tk, int d, float scale, int causal, int dtype, void* stream);

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread map

// Tile rows of the instance for padded head dim DP: the largest that keeps
// the dK/dV kernel's shared memory under 227 KB.
template <int DP> __host__ __device__ constexpr int tile_rows() {
  return DP <= 128 ? 64 : 32;
}

// thread (ty, tx), ty and tx in [0, 16), owns rows ty*RI..+RI-1 and
// columns tx + 16j (j < RI) of every B x B tile it computes, RI = B / 16
template <int B> struct ThreadMap {
  static_assert(THREADS == 16 * 16 && B % 16 == 0 && B <= 64,
                "tile and thread map disagree");
  static constexpr int RI = B / 16;
};

template <int DP, int B>
constexpr size_t smem_floats_dkdv() {
  // Qs, dOs, Ks, Vs [B][DP+1]; Ps, dSs [B][B+1]; lse, D [B]
  return 4 * (size_t)B * (DP + 1) + 2 * (size_t)B * (B + 1) + 2 * B;
}

template <int DP, int B>
constexpr size_t smem_floats_dq() {
  // Qs, dOs, Ks, Vs [B][DP+1]; dSs [B][B+1]; lse, D [B]
  return 4 * (size_t)B * (DP + 1) + (size_t)B * (B + 1) + 2 * B;
}

static_assert(smem_floats_dkdv<128, tile_rows<128>()>() * 4 <= 232448 &&
              smem_floats_dkdv<256, tile_rows<256>()>() * 4 <= 232448,
              "a block takes at most 227 KB of shared memory");

// Copy rows [r0, r0 + B), columns [c0, c0 + DP) of a (t, d) matrix into a
// zero-padded [B][DP+1] fp32 tile in shared memory.
template <int DP, int B>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int t, int d, int c0) {
  for (int e = threadIdx.x; e < B * DP; e += THREADS) {
    int r = e / DP, c = e - r * DP;
    float x = 0.f;
    if (r0 + r < t && c0 + c < d)
      x = src[(long long)(r0 + r) * d + c0 + c];
    dst[r * (DP + 1) + c] = x;
  }
}

// lse and D of q rows [q0, q0 + B), zero past tq
template <int B>
__device__ __forceinline__ void load_rows(float* lse_s, float* dd_s,
                                          const float* lse, const float* dd,
                                          int q0, int tq) {
  const int r = threadIdx.x;
  if (r < B) {
    const bool in = q0 + r < tq;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    dd_s[r] = in ? dd[q0 + r] : 0.f;
  }
}

// Add to the s = Q K^T and dp = dO V^T micro-tiles of thread (ty, tx),
// q rows ty*RI+i, k columns tx+16j, the fp32 sums over one (zero-padded)
// chunk of the head dim.
template <int DP, int RI>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[RI][RI],
                                            float dp[RI][RI]) {
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float a[RI], g[RI], b[RI], w[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = Qs[(ty * RI + i) * (DP + 1) + c];
      g[i] = dOs[(ty * RI + i) * (DP + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      b[j] = Ks[(tx + 16 * j) * (DP + 1) + c];
      w[j] = Vs[(tx + 16 * j) * (DP + 1) + c];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// p = exp(s * scale - lse) on the live pairs of the tile at (q0, k0), 0
// elsewhere, in place of s; ds = p * (dp - D) in place of dp.
template <int RI>
__device__ __forceinline__ void softmax_grad(float s[RI][RI],
                                             float dp[RI][RI],
                                             const float* lse_s,
                                             const float* dd_s, int ty,
                                             int tx, int q0, int k0, int tq,
                                             int tk, float scale,
                                             int causal) {
  const int offset = tk - tq;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty * RI + i;
    const float l = lse_s[ty * RI + i], dd = dd_s[ty * RI + i];
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool live = r < tq && col < tk && (!causal || col <= r + offset);
      const float p = live ? expf(s[i][j] * scale - l) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dd);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd, float* __restrict__ dk,
                      float* __restrict__ dv, int tq, int tk, int d,
                      float scale, int causal) {
  constexpr int BQ = tile_rows<DP>(), BK = BQ;
  constexpr int RI = ThreadMap<BQ>::RI;
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
  const float* qb = q + bh * tq * d;
  const float* dob = dout + bh * tq * d;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const float* lseb = lse + bh * tq;
  const float* ddb = dd + bh * tq;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // output columns [g * DP, g * DP + DP); the contraction runs over nch
  // chunks of DP columns, the group's own last, so that its Q and dO
  // columns are in shared memory for dK and dV
  const int g = blockIdx.y, nch = (d + DP - 1) / DP;

  if (nch == 1) {
    load_tile<DP, BK>(Ks, kb, k0, tk, d, 0);
    load_tile<DP, BK>(Vs, vb, k0, tk, d, 0);
  }

  float acc_dk[RI][NJ], acc_dv[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int nq = (tq + BQ - 1) / BQ;
  // the first q tile whose rows reach column k0 (row r sees r + tk - tq)
  const int first = causal ? max(k0 - (tk - tq), 0) / BQ : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      const int c0 = (nch == 1 ? 0 : (g + 1 + ci) % nch) * DP;
      __syncthreads();   // the previous tile's readers are done
      if (nch > 1) {
        load_tile<DP, BK>(Ks, kb, k0, tk, d, c0);
        load_tile<DP, BK>(Vs, vb, k0, tk, d, c0);
      }
      load_tile<DP, BQ>(Qs, qb, q0, tq, d, c0);
      load_tile<DP, BQ>(dOs, dob, q0, tq, d, c0);
      if (ci == 0) load_rows<BQ>(lse_s, dd_s, lseb, ddb, q0, tq);
      __syncthreads();
      score_tiles<DP, RI>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    }
    softmax_grad<RI>(s, dp, lse_s, dd_s, ty, tx, q0, k0, tq, tk, scale,
                     causal);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int e = (ty * RI + i) * (BK + 1) + tx + 16 * j;
        Ps[e] = s[i][j];
        dSs[e] = dp[i][j];
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: k rows ty*RI+i, columns tx+16j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float p[RI], ds[RI], g[NJ], x[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p[i] = Ps[r * (BK + 1) + ty * RI + i];
        ds[i] = dSs[r * (BK + 1) + ty * RI + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = dOs[r * (DP + 1) + tx + 16 * j];
        x[j] = Qs[r * (DP + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_dv[i][j] = fmaf(p[i], g[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(ds[i], x[j], acc_dk[i][j]);
        }
    }
  }

  float* dkb = dk + bh * tk * d;
  float* dvb = dv + bh * tk * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty * RI + i;
    if (row >= tk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = g * DP + tx + 16 * j;
      if (c < d) {
        dkb[(long long)row * d + c] = acc_dk[i][j] * scale;
        dvb[(long long)row * d + c] = acc_dv[i][j];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dq,
                    int tq, int tk, int d, float scale, int causal) {
  constexpr int BQ = tile_rows<DP>(), BK = BQ;
  constexpr int RI = ThreadMap<BQ>::RI;
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
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const float* qb = q + bh * tq * d;
  const float* dob = dout + bh * tq * d;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // output columns [g * DP, g * DP + DP), the contraction in nch chunks,
  // the group's own last (its K columns feed dQ)
  const int g = blockIdx.y, nch = (d + DP - 1) / DP;

  if (nch == 1) {
    load_tile<DP, BQ>(Qs, qb, q0, tq, d, 0);
    load_tile<DP, BQ>(dOs, dob, q0, tq, d, 0);
  }
  load_rows<BQ>(lse_s, dd_s, lse + bh * tq, dd + bh * tq, q0, tq);

  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
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
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      const int c0 = (nch == 1 ? 0 : (g + 1 + ci) % nch) * DP;
      __syncthreads();   // the previous tile's readers are done
      if (nch > 1) {
        load_tile<DP, BQ>(Qs, qb, q0, tq, d, c0);
        load_tile<DP, BQ>(dOs, dob, q0, tq, d, c0);
      }
      load_tile<DP, BK>(Ks, kb, k0, tk, d, c0);
      load_tile<DP, BK>(Vs, vb, k0, tk, d, c0);
      __syncthreads();
      score_tiles<DP, RI>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    }
    softmax_grad<RI>(s, dp, lse_s, dd_s, ty, tx, q0, k0, tq, tk, scale,
                     causal);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j)
        dSs[(ty * RI + i) * (BK + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ += dS K: q rows ty*RI+i, columns tx+16j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[RI], x[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty * RI + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j] = Ks[kk * (DP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], x[j], acc[i][j]);
    }
  }

  float* dqb = dq + bh * tq * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = g * DP + tx + 16 * j;
      if (c < d) dqb[(long long)row * d + c] = acc[i][j] * scale;
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

template <int DP>
cudaError_t launch_dkdv(const Args& a, cudaStream_t stream) {
  constexpr int B = tile_rows<DP>();
  const size_t smem = smem_floats_dkdv<DP, B>() * sizeof(float);
  static bool configured = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.tk + B - 1) / B) * a.bh;
  const int groups = (a.d + DP - 1) / DP;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, groups);
  flash_bwd_dkdv_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.tq, a.tk, a.d,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int B = tile_rows<DP>();
  const size_t smem = smem_floats_dq<DP, B>() * sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.tq + B - 1) / B) * a.bh;
  const int groups = (a.d + DP - 1) / DP;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, groups);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<float*>(a.dq), a.tq, a.tk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// kernel 0: dK/dV, 1: dQ
template <int DP>
cudaError_t launch_one(int which, const Args& a, cudaStream_t s) {
  return which == 0 ? launch_dkdv<DP>(a, s) : launch_dq<DP>(a, s);
}

cudaError_t launch_d(int which, const Args& a, cudaStream_t s) {
  if (a.d <= 32) return launch_one<32>(which, a, s);
  if (a.d <= 64) return launch_one<64>(which, a, s);
  if (a.d <= 128) return launch_one<128>(which, a, s);
  return launch_one<256>(which, a, s);
}

// The dispatch by dtype: float32 takes the FMA kernels above, bfloat16 and
// float16 the tensor-core kernels of flash_attention_bwd_sm90.cu.
int launch(int which, const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 1 ||
      (a.causal && a.tq > a.tk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d(which, a, s);
    case 1:
    case 2:
      return mxt_flash_attention_bwd_sm90(which, a.q, a.k, a.v, a.dout, a.lse,
                                          a.dd, a.dq, a.dk, a.dv, a.bh, a.tq,
                                          a.tk, a.d, a.scale, a.causal, dtype,
                                          stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t (0 on
// success).
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
