// Flash-attention forward: the C entry that dispatches by dtype. float32
// goes to the 3xTF32 tensor-core kernel of flash_attention_tf32.cu,
// bfloat16 and float16 to the 16-bit one of flash_attention_sm90.cu; both
// compute O = softmax(Q K^T * scale) V and the per-row logsumexp, never
// materialising the tq x tk score matrix in device memory, and together
// replace mxnet_tpu/pallas_ops.py:_attn_kernel_resident and
// pallas_ops.py:_attn_kernel (both launched by _flash_fwd_impl). Causal
// rows suffix-align to the keys (row i sees keys <= i + tk - tq).
//
// Layout: q (bh, tq, d), k and v (bh, tk, d), o (bh, tq, d) row-major and
// contiguous, in the dtype; lse (bh, tq) float. d is any head_dim >= 1 and
// tq, tk any lengths >= 1. The kernels allocate nothing and launch on the
// caller's stream.

#include <cuda_runtime.h>

// flash_attention_sm90.cu: the 16-bit kernel on the tensor cores
extern "C" int mxt_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int bh, int tq, int tk, int d,
                                            float scale, int causal,
                                            int dtype, void* stream);
// flash_attention_tf32.cu: the float32 kernel on the tensor cores
extern "C" int mxt_flash_attention_fwd_tf32(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int bh, int tq, int tk, int d,
                                            float scale, int causal,
                                            void* stream);

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t (0 on
// success).
int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk, int d,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return mxt_flash_attention_fwd_tf32(q, k, v, o, lse, bh, tq, tk, d,
                                          scale, causal, stream);
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
