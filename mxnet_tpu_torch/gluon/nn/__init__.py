"""Gluon neural-network layers, the counterpart of mxnet_tpu/gluon/nn/
(reference python/mxnet/gluon/nn/basic_layers.py and conv_layers.py).
Each layer's compute is a registry op; `MoE` (moe.py) routes tokens to
experts with parallel/moe's routing."""
from .basic_layers import (Sequential, HybridSequential, Dense, Activation,
                           Dropout, BatchNorm, LeakyReLU, Embedding, Flatten,
                           Lambda, HybridLambda)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose,
                          MaxPool1D, MaxPool2D, MaxPool3D,
                          AvgPool1D, AvgPool2D, AvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D)

from .moe import MoE
