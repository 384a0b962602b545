"""Legacy contrib autograd interface (reference
python/mxnet/contrib/autograd.py): thin aliases over mx.autograd."""
from ..autograd import (record, pause, is_recording, is_training,
                        mark_variables, backward)


def set_is_training(is_train):
    """Legacy toggle (reference contrib/autograd.py set_is_training);
    returns the previous state like the reference's C call did."""
    from .. import autograd as ag
    prev = ag.is_training()
    ag.set_training(is_train)
    return prev


def train_section():
    """Legacy alias of record() (reference contrib.autograd.train_section)."""
    return record()


def test_section():
    """Legacy alias of pause() under inference mode."""
    return pause()


def compute_gradient(outputs):
    """Compute gradients of outputs w.r.t. marked variables
    (reference contrib/autograd.py compute_gradient)."""
    backward(outputs)
