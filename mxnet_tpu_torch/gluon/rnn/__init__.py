"""Gluon recurrent cells and fused layers: the counterpart of
mxnet_tpu/gluon/rnn/ (reference python/mxnet/gluon/rnn/)."""
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ZoneoutCell,
                       ResidualCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
