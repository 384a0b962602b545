"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu, for NVIDIA
Hopper (H100).

The JAX package `mxnet_tpu` is the reference each part of the port is
tested against; this package imports neither it nor JAX. What runs so
far is the transformer LM's forward (`parallel.transformer`) on a
hand-written flash-attention kernel (`cuda_ops`, `csrc/`).

Importing the package builds nothing: the kernels are compiled by
`nvcc` at their first launch (`_build`).
"""
from .context import resolve_device

__all__ = ['resolve_device']
