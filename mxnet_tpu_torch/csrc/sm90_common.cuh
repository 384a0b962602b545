// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu,
// conv_bn_stats_sm90.cu; the float32 ones through tf32_common.cuh):
// mbarriers, TMA (tiled and im2col) and plain copies into the 128-byte
// swizzled tile layout, wgmma descriptors and instructions, and the host's
// tensor maps. Whatever names the 16-bit type (the wgmma instruction, the
// tensor map's data type, the packing of two values) is templated on T16,
// __nv_bfloat16 or __half; wgmma takes both with the same layouts. The
// im2col map takes float as well.
//
// Every definition sits in an anonymous namespace: each source that
// includes this file gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ATOM = 64 * 128;  // 64 rows x 64 16-bit columns: one TMA box

template <typename T16>
constexpr bool is_bf16 = std::is_same<T16, __nv_bfloat16>::value;

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
// A tile is 64 rows x cw columns, stored as cw / 64 atoms of 64 x 64
// 16-bit values; in an atom, row r takes 128 bytes at r * 128, its 16-byte
// chunk c at chunk c ^ (r % 8): TMA's CU_TENSOR_MAP_SWIZZLE_128B and
// wgmma's B128.
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
// column d, for a (t, d) row-major head of 16-bit values; the caller
// fences for the async proxy
__device__ __forceinline__ void copy_tile(const void* head, int t, int d,
                                          uint8_t* dst, int cw, int col0,
                                          int row0, int lane) {
  const unsigned short* src = static_cast<const unsigned short*>(head);
  const int chunks = cw / 8;
  for (int e = lane; e < 64 * chunks; e += 32) {
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

// One im2col column of an NHWC tensor map (`im2col_map`): 128 bytes of
// channels from c of each of the map's `pixels` pixels, walked from the pixel
// (w, h, n) through the map's bounding box at its traversal strides, row
// by row and image by image, each read at (w + dx, h + dy); one 128-byte
// swizzled row a pixel, zeros outside the tensor.
__device__ __forceinline__ void tma_im2col(const CUtensorMap* tm, uint8_t* dst,
                                           int c, int w, int h, int n,
                                           uint16_t dx, uint16_t dy,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ----
// K-major operand (rows of 64 16-bit values, the contraction along the
// row): the start address steps 32 bytes per 16 columns inside an atom;
// 8-row groups 1024 bytes apart (SBO).
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
// every committed group but the newest is done
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
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

#define MXT_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A B^T, A and B K-major in shared memory
#define MXT_WGMMA_SS64(TY)                                              \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "    \
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"      \
      : MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16), MXT_ACC8(24)            \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T16>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (is_bf16<T16>)
    MXT_WGMMA_SS64("bf16");
  else
    MXT_WGMMA_SS64("f16");
}
#undef MXT_WGMMA_SS64

// d (64 x 64) (+)= A B, A K-major and B MN-major (the transpose bit) in
// shared memory
#define MXT_WGMMA_SS64_BT(TY)                                           \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "    \
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}"      \
      : MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16), MXT_ACC8(24)            \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T16>
__device__ __forceinline__ void wgmma_ss64_bt(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (is_bf16<T16>)
    MXT_WGMMA_SS64_BT("bf16");
  else
    MXT_WGMMA_SS64_BT("f16");
}
#undef MXT_WGMMA_SS64_BT

// d (64 x 128) (+)= A B, A K-major and B MN-major in shared memory, B's
// two 64-column atoms ATOM bytes apart (the descriptor's LBO, desc_mn)
template <typename T16>
__device__ __forceinline__ void wgmma_ss128_bt(float* d, uint64_t da,
                                               uint64_t db, int accumulate) {
#define MXT_WGMMA_SS128_BT(TY)                                          \
  asm volatile(                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                        \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                        \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "%64, %65, p, 1, 1, 0, 1;\n}"                                     \
      : MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16), MXT_ACC8(24),           \
        MXT_ACC8(32), MXT_ACC8(40), MXT_ACC8(48), MXT_ACC8(56)          \
      : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (is_bf16<T16>)
    MXT_WGMMA_SS128_BT("bf16");
  else
    MXT_WGMMA_SS128_BT("f16");
#undef MXT_WGMMA_SS128_BT
}

// d (64 x N) += A B, A in registers, B MN-major in shared memory; the
// scale-d predicate is always set (accumulate). REGS names the N / 2
// accumulators, A the four A registers, B the descriptor, P the predicate.
#define MXT_WGMMA_RS(N, TY, REGS, A, B, P, ...)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "."  \
               TY " {" REGS "}, {" A "}, " B ", p, 1, 1, 1;\n}"         \
               : __VA_ARGS__                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                 "r"(1))

#define MXT_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define MXT_REGS32 MXT_REGS16 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define MXT_REGS48 MXT_REGS32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define MXT_REGS64 MXT_REGS48 ", %24, %25, %26, %27, %28, %29, %30, %31"

#define MXT_RS16(TY)                                                    \
  MXT_WGMMA_RS("16", TY, MXT_REGS16, "%8, %9, %10, %11", "%12", "%13",  \
               MXT_ACC8(0))
#define MXT_RS32(TY)                                                    \
  MXT_WGMMA_RS("32", TY, MXT_REGS32, "%16, %17, %18, %19", "%20",       \
               "%21", MXT_ACC8(0), MXT_ACC8(8))
#define MXT_RS48(TY)                                                    \
  MXT_WGMMA_RS("48", TY, MXT_REGS48, "%24, %25, %26, %27", "%28",       \
               "%29", MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16))
#define MXT_RS64(TY)                                                    \
  MXT_WGMMA_RS("64", TY, MXT_REGS64, "%32, %33, %34, %35", "%36",       \
               "%37", MXT_ACC8(0), MXT_ACC8(8), MXT_ACC8(16),           \
               MXT_ACC8(24))

template <typename T16, int N> struct WgmmaRS;
#define MXT_RS_SPEC(N)                                                  \
  template <typename T16> struct WgmmaRS<T16, N> {                      \
    static __device__ __forceinline__ void run(float* d,                \
                                               const uint32_t* a,       \
                                               uint64_t db) {           \
      if constexpr (is_bf16<T16>)                                       \
        MXT_RS##N("bf16");                                              \
      else                                                              \
        MXT_RS##N("f16");                                               \
    }                                                                   \
  };
MXT_RS_SPEC(16)
MXT_RS_SPEC(32)
MXT_RS_SPEC(48)
MXT_RS_SPEC(64)
#undef MXT_RS_SPEC
#undef MXT_RS16
#undef MXT_RS32
#undef MXT_RS48
#undef MXT_RS64
#undef MXT_WGMMA_RS
#undef MXT_REGS16
#undef MXT_REGS32
#undef MXT_REGS48
#undef MXT_REGS64
#undef MXT_ACC8

// acc (64 x GN) += A (64 x 16, registers) B (16 rows of the tile from
// column atom `atom`, GN columns): pieces of 64 columns, then the rest,
// each starting on an atom
template <typename T16, int GN>
__device__ __forceinline__ void wgmma_group(float* acc, const uint32_t* a,
                                            const uint8_t* atom, int ks) {
#pragma unroll
  for (int i = 0; i < GN / 64; ++i)
    WgmmaRS<T16, 64>::run(acc + 32 * i, a, desc_mn(atom + i * ATOM, ks));
  if constexpr (GN % 64 != 0)
    WgmmaRS<T16, GN % 64>::run(acc + 32 * (GN / 64), a,
                               desc_mn(atom + (GN / 64) * ATOM, ks));
}

// two floats rounded to nearest T16, packed low then high
template <typename T16>
__device__ __forceinline__ uint32_t pack2_rn(float lo, float hi) {
  if constexpr (is_bf16<T16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// one float rounded to nearest T16
template <typename T16> __device__ __forceinline__ T16 round_to(float x) {
  if constexpr (is_bf16<T16>)
    return __float2bfloat16(x);
  else
    return __float2half(x);
}

// ---- host: tensor maps ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is in the driver API; the library links no
// libcuda, so it is reached through cudaGetDriverEntryPoint
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

// (d, t, bh) of T16, 64 x 64 boxes, 128-byte swizzle, zeros out of range
template <typename T16>
cudaError_t tensor_map(CUtensorMap* tm, const void* ptr, int bh, int t,
                       int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(tm,
                      is_bf16<T16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                      3, const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col, reached as encode_tiled is
EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeIm2col>(ptr);
  }
  return fn;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Whether im2col_map can address the NHWC x of T (c channels) of a conv
// of kernel (kh, kw), stride (sh, sw) and padding (ph, pw): a pixel pitch
// of whole 16-byte units, a 16-byte aligned pointer, strides <= 8, each
// corner of the bounding box in [-128, 127] and each kernel size <= 256
// (a 4-D map's limits)
template <typename T>
bool im2col_fits(const void* x, int c, int kh, int kw, int sh, int sw,
                 int ph, int pw) {
  auto corner_ok = [](int v) { return v >= -128 && v <= 127; };
  return c * sizeof(T) % 16 == 0 && aligned16(x) && sh <= 8 && sw <= 8 &&
         kh <= 256 && kw <= 256 && corner_ok(-ph) && corner_ok(-pw) &&
         corner_ok(ph - (kh - 1)) && corner_ok(pw - (kw - 1));
}

// The im2col map of an NHWC (n, h, w, c) tensor of T (bf16, float16 or
// float) for a conv of kernel (kh, kw), stride (sh, sw) and padding
// (ph, pw): each copy (tma_im2col) brings 128 bytes of channels (64 16-bit
// or 32 fp32 ones) of `pixels` consecutive output pixels, the pixel of
// output (ho, wo) starting at input (ho sh - ph, wo sw - pw). The bounding
// box runs from -pad to (size - 1) + pad - (k - 1) on each axis, so one
// traversal step is one output pixel and a row of the box is a row of the
// output; 128-byte swizzle, zeros out of range. The caller keeps
// im2col_fits.
template <typename T>
cudaError_t im2col_map(CUtensorMap* tm, const void* ptr, int n, int h, int w,
                       int c, int kh, int kw, int sh, int sw, int ph, int pw,
                       int pixels) {
  EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  constexpr cuuint64_t b = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * b, (cuuint64_t)w * c * b,
                                 (cuuint64_t)h * w * c * b};
  const int lower[2] = {-pw, -ph};
  const int upper[2] = {pw - (kw - 1), ph - (kh - 1)};
  const cuuint32_t elem[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  CUresult r = encode(tm,
                      std::is_same<T, float>::value
                          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : is_bf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                      4, const_cast<void*>(ptr), dims, strides, lower, upper,
                      (cuuint32_t)(128 / b), (cuuint32_t)pixels, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// raise a kernel's dynamic shared memory limit to `smem` (once per size
// it grows to), then launch it on `stream`
template <typename Kernel, typename P>
cudaError_t launch_kernel(Kernel kernel, int* configured, const P& p,
                          dim3 grid, int threads, size_t smem,
                          cudaStream_t stream) {
  if ((int)smem > *configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *configured = (int)smem;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
