// Hopper (sm_90a) building blocks of the float32 kernels that run on the
// tensor cores as three TF32 products (flash_attention_tf32.cu,
// flash_attention_bwd_tf32.cu, conv_bn_stats_tf32.cu): the TF32 split, the
// 128-byte swizzled layout of fp32 tiles, their TMA and plain copies, tf32
// wgmma descriptors and instructions, and the host's fp32 tensor maps. The
// PTX building blocks they share with the 16-bit kernels (mbarriers,
// wgmma fences, the tensor-map encoders) are in sm90_common.cuh.
//
// Precision. The tensor cores take float32 only as TF32 (10 mantissa
// bits), and one TF32 product misses the float32 tolerances. Three pass
// them: each operand x is split into big = tf32(x) and small =
// tf32(x - big) (cvt.rna: to nearest, ties away), and a b is taken as
// big_a big_b + big_a small_b + small_a big_b, summed in the fp32
// accumulators (small_a small_b, about 2^-22 of a b, is left out).
//
// Layout. A tile of `rows` rows and 64 fp32 columns is two 32-column atoms
// of rows x 128 bytes; row r of an atom holds its 16-byte chunk c at chunk
// c ^ (r % 8): TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's B128. A K-major
// operand (the contraction along the row) steps 32 bytes per k-step of 8
// tf32 columns; wgmma has no transpose bit for 32-bit types, so every
// operand in shared memory is K-major.
//
// Every definition sits in an anonymous namespace: each source that
// includes this file gets its own copy.

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int CW = 64;  // columns of a tile (a contraction chunk): 2 atoms

// x rounded to TF32 (to nearest, ties away), as fp32 bits
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// the byte offset of element (row r, column c) in a tile of `rows` rows:
// 32-column atoms of rows x 128 bytes, the 16-byte chunk c / 4 of row r at
// chunk (c / 4) ^ (r % 8) (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's B128)
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// K-major wgmma descriptor of k-step ks (8 tf32 columns, 32 bytes) of a
// tile of `rows` rows; 8-row groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_tf32(const uint8_t* tile, int rows,
                                              int ks) {
  const uint32_t a = smem_u32(tile + (ks >> 2) * rows * 128 + (ks & 3) * 32);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)64 << 32 | (uint64_t)1 << 62;
}

// one box of a 3-D (d, t, bh) map (tensor_map_f32), 32 columns from col0
// of its rows from row0, by TMA: one 128-byte swizzle atom
__device__ __forceinline__ void tma_box(const CUtensorMap* tm, uint8_t* dst,
                                        int col0, int row0, int bh,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)), "r"(col0),
      "r"(row0), "r"(bh)
      : "memory");
}

// the CW-column chunk at col0 of rows row0.. of a (t, d) head, by TMA
__device__ __forceinline__ void tma_chunk(const CUtensorMap* tm,
                                          uint8_t* dst, int rows, int col0,
                                          int row0, int bh, uint64_t* bar) {
  for (int b = 0; b < CW / 32; ++b)
    tma_box(tm, dst + b * rows * 128, col0 + 32 * b, row0, bh, bar);
}

// the same by plain loads from NT threads (tid in [0, NT)), zero past row
// t and column d
template <int NT = 32>
__device__ __forceinline__ void copy_chunk(const float* head, int t, int d,
                                           uint8_t* dst, int rows, int col0,
                                           int row0, int tid) {
  constexpr int chunks = CW / 4;  // 16-byte chunks of a row
  for (int e = tid; e < rows * chunks; e += NT) {
    const int r = e / chunks, c = (e % chunks) * 4;
    const int row = row0 + r;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = (row < t && col0 + c + u < d)
                 ? head[(long long)row * d + col0 + c + u]
                 : 0.f;
    *reinterpret_cast<float4*>(dst + swz(rows, r, c)) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// the split of a tile by NT threads (tid in [0, NT)): x -> big = tf32(x) in
// place and small = tf32(x - big) `bytes` further on
template <int NT>
__device__ __forceinline__ void split_tile(uint8_t* tile, int bytes, int tid) {
  for (int o = tid * 16; o < bytes; o += NT * 16) {
    const float4 v = *reinterpret_cast<const float4*>(tile + o);
    const float4 b = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                                 to_tf32(v.w));
    *reinterpret_cast<float4*>(tile + o) = b;
    *reinterpret_cast<float4*>(tile + bytes + o) =
        make_float4(to_tf32(v.x - b.x), to_tf32(v.y - b.y),
                    to_tf32(v.z - b.z), to_tf32(v.w - b.w));
  }
}

// NT threads meet at named barrier ID (barrier 0 is __syncthreads')
template <int ID, int NT> __device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(NT) : "memory");
}

// one consumer warpgroup meets (named barrier 1; a producer does not take
// part)
__device__ __forceinline__ void consumers_sync() { named_sync<1, 128>(); }

#define MXT_F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32) (+)= A B^T, A and B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_ss32(float* d, uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}"
      : MXT_F8(0), MXT_F8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) (+)= A B^T, A and B K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_tf32_ss64(float* d, uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}"
      : MXT_F8(0), MXT_F8(8), MXT_F8(16), MXT_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A B^T, A (64 x 8 tf32) in registers, B K-major tf32 in
// shared memory
__device__ __forceinline__ void wgmma_tf32_rs64(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : MXT_F8(0), MXT_F8(8), MXT_F8(16), MXT_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef MXT_F8

// ---- host ----
// (d, t, bh) of fp32, boxes of 32 columns (128 bytes) x `rows` rows,
// 128-byte swizzle, zeros out of range
cudaError_t tensor_map_f32(CUtensorMap* tm, const void* ptr, int bh, int t,
                           int d, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)t * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
