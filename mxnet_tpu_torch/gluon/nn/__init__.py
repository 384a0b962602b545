"""Gluon neural-network layers, the counterpart of mxnet_tpu/gluon/nn/
(reference python/mxnet/gluon/nn/basic_layers.py and conv_layers.py).
Each layer's compute is a registry op. `MoE` waits for the port's
parallel/moe (Queue A 6) and raises."""
from ...base import unported
from .basic_layers import (Sequential, HybridSequential, Dense, Activation,
                           Dropout, BatchNorm, LeakyReLU, Embedding, Flatten,
                           Lambda, HybridLambda)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose,
                          MaxPool1D, MaxPool2D, MaxPool3D,
                          AvgPool1D, AvgPool2D, AvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D)


class MoE:
    """The mixture-of-experts layer: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise unported('gluon.nn.MoE (parallel/moe.py)', '6')
