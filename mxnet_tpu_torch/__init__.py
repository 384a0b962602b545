"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for NVIDIA
Hopper (H100).

The JAX package `mxnet_tpu` is the reference each part of the port is
tested against; this package imports neither it nor JAX. What runs so
far is the transformer LM (`parallel.transformer`): its forward and
its SGD train step, on hand-written flash-attention forward and
backward kernels (`cuda_ops`, `csrc/`); and the conv with fused
BatchNorm statistics (`cuda_conv.conv2d_bn_stats`) on a hand-written
implicit-GEMM kernel, with its bench (`tools.bench_conv_bn`, run on
the card as `python -m mxnet_tpu_torch.tools.bench_conv_bn`).

Importing the package builds nothing: the kernels are compiled by
`nvcc` at their first launch (`_build`).
"""
from .context import resolve_device

__all__ = ['resolve_device']
