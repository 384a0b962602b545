"""RNN checkpoints (`mx.rnn.save_rnn_checkpoint` and the rest): the
counterpart of mxnet_tpu/rnn/rnn.py (reference python/mxnet/rnn/rnn.py).

Checkpoints hold the cell weights unpacked (per layer and per gate), so
that they move between fused (`FusedRNNCell`) and unfused cell stacks;
the files are model.save_checkpoint's, the JAX package's format.
"""
from ..model import save_checkpoint, load_checkpoint
from .rnn_cell import BaseRNNCell


def _as_cells(cells):
    if isinstance(cells, BaseRNNCell):
        return [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """Save symbol + params, unpacking cell weights first."""
    for cell in _as_cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint saved by save_rnn_checkpoint, re-packing the
    weights for the given cells."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing with unpacked RNN weights
    (reference rnn/rnn.py do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
