"""The symbolic recurrent-network toolkit (`mx.rnn`): the counterpart of
mxnet_tpu/rnn/ (reference python/mxnet/rnn/), on the port's symbols and
its fused `RNN` op."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       ModifierCell, DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
