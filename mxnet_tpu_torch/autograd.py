"""Imperative autograd: the counterpart of mxnet_tpu/autograd.py, on
torch autograd.

The JAX package records every op invoked under `record()` on a tape and
replays it with jax.vjp. Here torch records: while `record()` is on,
`ndarray.invoke` runs each op under `torch.enable_grad()` on inputs that
require grad, and `backward()` is one `torch.autograd.grad` from the
heads to the arrays that were inputs of recorded ops. As on the tape,
every float input of a recorded op is differentiable (its tensor is
made to require grad when it first enters the recording), the
gradients land in the marked arrays (`attach_grad`, `mark_variables`)
by their `grad_req` ('write', 'add' or 'null'), and a backward without
`retain_graph` ends the recording: arrays made in it are constants to
the next one. Outside `record()` ops run under `torch.no_grad()`.

The thread-local state holds, until backward, every tensor of the
recording (so that an array made in an earlier one is detached when it
enters a new one) and, by array, the tensor each input entered with.
"""
import threading
from contextlib import contextmanager

import torch

_state = threading.local()


def _st():
    if not hasattr(_state, 'recording'):
        _state.recording = False
        _state.training = False
        _state.tensors = {}   # id(tensor) -> tensor of this recording
        _state.inputs = {}    # id(array) -> (array, tensor it entered with)
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    old = _st().recording
    _st().recording = flag
    return old


def set_training(flag):
    old = _st().training
    _st().training = flag
    return old


@contextmanager
def record(train_mode=True):
    """Record imperative ops for differentiation (reference
    python/mxnet/autograd.py record)."""
    st = _st()
    old_rec, old_train = st.recording, st.training
    st.recording, st.training = True, train_mode
    try:
        yield
    finally:
        st.recording, st.training = old_rec, old_train


@contextmanager
def pause(train_mode=False):
    st = _st()
    old_rec, old_train = st.recording, st.training
    st.recording, st.training = False, train_mode
    try:
        yield
    finally:
        st.recording, st.training = old_rec, old_train


@contextmanager
def train_mode():
    old = set_training(True)
    try:
        yield
    finally:
        set_training(old)


@contextmanager
def predict_mode():
    old = set_training(False)
    try:
        yield
    finally:
        set_training(old)


def mark_variable(arr, grad_req='write'):
    # a per-array flag; no registry, so marked arrays are freed normally
    if arr.grad_req is None:
        arr.grad_req = grad_req


def mark_variables(variables, gradients=None, grad_reqs='write'):
    if gradients is None:
        gradients = [None] * len(variables)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.grad_req = req
        v._grad = g


def _enter(arr):
    """The tensor of `arr` to compute on while recording: a float tensor
    from outside this recording is detached and made to require grad
    (the array then holds that tensor), so gradients reach it and stop
    there."""
    st = _st()
    t = arr._data
    if id(t) not in st.tensors:
        if t.is_floating_point():
            t = t.detach().requires_grad_(True)
            arr._data = t
        st.tensors[id(t)] = t
    st.inputs.setdefault(id(arr), (arr, t))
    return t


def _recorded(tensors):
    """Note the outputs of a recorded op as tensors of this recording."""
    st = _st()
    for t in tensors:
        st.tensors[id(t)] = t


@contextmanager
def _nested_recording(tensors):
    """Record into a state of its own, the enclosing one set aside: the
    ops see `tensors` as tensors of this recording (not detached when
    they enter), and their graph is the caller's to differentiate (a
    hybridized Gluon call, gluon/block.py _CachedCall)."""
    st = _st()
    saved = (st.recording, st.tensors, st.inputs)
    st.recording = True
    st.tensors = {id(t): t for t in tensors}
    st.inputs = {}
    try:
        yield
    finally:
        st.recording, st.tensors, st.inputs = saved


def _end_recording():
    st = _st()
    st.tensors = {}
    st.inputs = {}


def _head_grad(head, g):
    from .ndarray import NDArray
    if g is None:
        return torch.ones_like(head._data)
    if isinstance(g, NDArray):
        return g._data
    return torch.as_tensor(g, dtype=head._data.dtype,
                           device=head._data.device)


def _gradients(heads, head_grads, targets, retain_graph):
    """torch.autograd.grad of the recorded heads with respect to the
    tensors `targets`; None for a target no head depends on."""
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if h._data.requires_grad:   # a head made outside record() has none
            outs.append(h._data)
            grads.append(_head_grad(h, hg))
    live = [i for i, t in enumerate(targets)
            if t is not None and t.requires_grad]
    result = [None] * len(targets)
    if outs and live:
        gs = torch.autograd.grad(outs, [targets[i] for i in live], grads,
                                 retain_graph=retain_graph, allow_unused=True)
        for i, g in zip(live, gs):
            result[i] = g
    return result


def _write_grad(arr, g):
    from .ndarray import NDArray
    if arr._grad is None:
        arr._grad = NDArray(g, arr._ctx)
    elif arr.grad_req == 'add':
        arr._grad._data = arr._grad._data + g
    else:
        arr._grad._data = g


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run backward from `heads` through the recording (reference
    MXAutogradBackwardEx) into the marked arrays that were its inputs."""
    st = _st()
    marked = [(arr, t) for arr, t in st.inputs.values()
              if arr.grad_req not in (None, 'null')]
    grads = _gradients(heads, head_grads, [t for _, t in marked],
                       retain_graph)
    for (arr, _), g in zip(marked, grads):
        if g is not None:
            _write_grad(arr, g)
    if not retain_graph:
        _end_recording()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Compute and return the gradients of heads with respect to
    variables (None for a variable the heads do not depend on)."""
    st = _st()
    targets = [st.inputs.get(id(v), (None, None))[1] for v in variables]
    grads = _gradients(heads, head_grads, targets, bool(retain_graph))
    out = []
    for v, g in zip(variables, grads):
        if v.grad_req is None:
            v.grad_req = 'write'
        v._grad = None
        if g is not None:
            _write_grad(v, g)
        out.append(v._grad)
    if not retain_graph:
        _end_recording()
    return out


class _FunctionBridge(torch.autograd.Function):
    """Runs a `Function`'s forward and backward, written over NDArrays,
    as one node of torch autograd."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray import NDArray
        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t, c)
                                for t, c in zip(tensors, fn._in_ctxs)])
        fn._single = not isinstance(outs, (list, tuple))
        outs = [outs] if fn._single else list(outs)
        fn._out_ctxs = [o._ctx for o in outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        fn = ctx.fn
        gs = fn.backward(*[NDArray(g, c)
                           for g, c in zip(grads, fn._out_ctxs)])
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in gs)


class Function:
    """Custom differentiable function (reference python/mxnet/autograd.py
    Function): subclasses define forward and backward over NDArrays."""

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        self._in_ctxs = [x._ctx for x in inputs]
        tensors = [_enter(x) for x in inputs]
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *tensors)
        _recorded(outs)
        results = [NDArray(o, c) for o, c in zip(outs, self._out_ctxs)]
        return results[0] if self._single else results

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
