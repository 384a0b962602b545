// Flash-attention backward on Hopper (sm_90a): the C entry points of the
// dK/dV and dQ kernels and their dispatch by dtype. Every route runs on the
// tensor cores:
// - float32 on the 3xTF32 kernels of flash_attention_bwd_tf32.cu (each
//   product split into TF32 parts that keep float32's accuracy);
// - bfloat16 and float16 on the 16-bit kernels of
//   flash_attention_bwd_sm90.cu.
//
// Together they replace mxnet_tpu/pallas_ops.py:_bwd_dkdv_kernel and
// _bwd_dq_kernel (launched by _flash_bwd_impl) and their streaming twins
// _bwd_dkdv_stream_kernel and _bwd_dq_stream_kernel (launched by
// _flash_bwd_stream_impl). The TPU chooses between the two pairs by
// whether one head's sequence fits VMEM; here one block holds only its own
// tiles, so one pair of kernels serves every length. As on the TPU there
// are two kernels, so that each gradient is written once, by one block,
// with no atomics: the gradients are bit-for-bit the same from run to run.
//
// Layout: q, dO (bh, tq, d), k, v (bh, tk, d), dq, dk, dv likewise,
// row-major and contiguous; lse and D = rowsum(dO * O) - glse (bh, tq)
// float32. Any head_dim d >= 1 and any tq, tk >= 1 (tq <= tk when causal).
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

// flash_attention_bwd_tf32.cu: float32 on the tensor cores
extern "C" int mxt_flash_attention_bwd_tf32(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, void* dk, void* dv, int bh,
    int tq, int tk, int d, float scale, int causal, void* stream);

// flash_attention_bwd_sm90.cu: the 16-bit kernels on the tensor cores
extern "C" int mxt_flash_attention_bwd_sm90(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, void* dk, void* dv, int bh,
    int tq, int tk, int d, float scale, int causal, int dtype, void* stream);

namespace {

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd;
  void *dq, *dk, *dv;
  int bh, tq, tk, d;
  float scale;
  int causal;
};

// kernel 0: dK/dV, 1: dQ. The dispatch by dtype: float32 takes the 3xTF32
// kernels, bfloat16 and float16 the 16-bit ones.
int launch(int which, const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1 || a.d < 1 ||
      (a.causal && a.tq > a.tk))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return mxt_flash_attention_bwd_tf32(which, a.q, a.k, a.v, a.dout, a.lse,
                                          a.dd, a.dq, a.dk, a.dv, a.bh, a.tq,
                                          a.tk, a.d, a.scale, a.causal,
                                          stream);
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
