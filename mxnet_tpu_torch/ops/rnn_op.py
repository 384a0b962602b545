"""The fused multi-layer RNN operator (`RNN`): the counterpart of
mxnet_tpu/ops/rnn_op.py (reference src/operator/rnn-inl.h, the cuDNN
fused RNN).

One op runs a whole stacked, optionally bidirectional RNN, LSTM or GRU
over a sequence. The JAX package computes each direction of each layer
as a `lax.scan` whose body is two matmuls, with XLA and no Pallas
kernel; here it is a Python loop over the time steps of torch ops, the
same code on the CPU and on the card (no cuDNN RNN, no `torch.nn.LSTM`).
The input projection of all T steps is one product outside the loop, and
each step does only the (N, H) x (H, gates * H) recurrent product and
the gate math.

The weight layout is cuDNN-flat (every layer's i2h and h2h weight
matrices first, then every bias vector), the one `FusedRNNCell`
packs and unpacks, so checkpoints move between the fused op and the
unfused cells. Gate orders are cuDNN's: LSTM (i, f, g, o); GRU (r, z, n)
with the reset gate applied to (h2h . h + h2h_bias).
"""
import numpy as np
import torch

from .nn import dropout
from .registry import register, asbool, asint, asfloat
from ..base import parse_attr_value

_NUM_GATES = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4, 'gru': 3}


def _rnn_mode(attrs):
    return str(parse_attr_value(attrs['mode']))


def _rnn_dims(attrs):
    h = asint(attrs['state_size'])
    nl = asint(attrs['num_layers'])
    ndir = 2 if asbool(attrs.get('bidirectional', False)) else 1
    gates = _NUM_GATES[_rnn_mode(attrs)]
    return h, nl, ndir, gates


def enumerate_param_blocks(h, nl, ndir, gates, input_size):
    """Walk the cuDNN-flat parameter layout: every weight matrix first
    (per layer, per direction: i2h then h2h), then every bias vector in
    the same order. Yields (layer, direction, group, kind, start,
    shape). The one encoding of the layout: the fused op, FusedRNNCell's
    pack and unpack and the FusedRNN initializer all walk it."""
    pos = 0
    for layer in range(nl):
        isz = input_size if layer == 0 else h * ndir
        for d in range(ndir):
            for group, ni in (('i2h', isz), ('h2h', h)):
                shape = (gates * h, ni)
                yield layer, d, group, 'weight', pos, shape
                pos += shape[0] * shape[1]
    for layer in range(nl):
        for d in range(ndir):
            for group in ('i2h', 'h2h'):
                yield layer, d, group, 'bias', pos, (gates * h,)
                pos += gates * h


def rnn_param_size(attrs, input_size):
    """The number of scalars in the flat `parameters` vector."""
    h, nl, ndir, gates = _rnn_dims(attrs)
    size = 0
    for *_unused, start, shape in enumerate_param_blocks(
            h, nl, ndir, gates, input_size):
        size = start + int(np.prod(shape))
    return size


def _split_params(params, attrs, input_size):
    """The flat cuDNN layout as one dict of w_i2h, w_h2h, b_i2h, b_h2h
    per (layer, direction), each a view of `params`."""
    h, nl, ndir, gates = _rnn_dims(attrs)
    out = [{} for _ in range(nl * ndir)]
    key = {('i2h', 'weight'): 'w_i2h', ('h2h', 'weight'): 'w_h2h',
           ('i2h', 'bias'): 'b_i2h', ('h2h', 'bias'): 'b_h2h'}
    for layer, d, group, kind, start, shape in enumerate_param_blocks(
            h, nl, ndir, gates, input_size):
        n = int(np.prod(shape))
        out[layer * ndir + d][key[(group, kind)]] = \
            params[start:start + n].reshape(shape)
    return out


def cell_step(mode):
    """step(carry, gx, w_h2h, b_h2h) -> (carry, output) of one time step:
    gx is the step's input projection (bias included), carry (h,) or
    (h, c) for the LSTM."""
    if mode in ('rnn_relu', 'rnn_tanh'):
        act = torch.relu if mode == 'rnn_relu' else torch.tanh

        def step(carry, gx, w_h2h, b_h2h):
            (h,) = carry
            nh = act(gx + torch.addmm(b_h2h, h, w_h2h.t()))
            return (nh,), nh
        return step
    if mode == 'lstm':
        def step(carry, gx, w_h2h, b_h2h):
            h, c = carry
            g = gx + torch.addmm(b_h2h, h, w_h2h.t())
            i, f, gg, o = g.chunk(4, dim=-1)
            nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            return (nh, nc), nh
        return step
    if mode == 'gru':
        def step(carry, gx, w_h2h, b_h2h):
            (h,) = carry
            gh = torch.addmm(b_h2h, h, w_h2h.t())
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            nh = (1.0 - z) * n + z * h
            return (nh,), nh
        return step
    raise ValueError('unknown RNN mode %r' % (mode,))


def run_layer(mode, x, cell, h0, c0, reverse=False):
    """One direction of one layer: x (T, N, I) -> (out (T, N, H), h_T,
    c_T), c_T None but for the LSTM. The i2h projection of every step is
    one (T N, I) x (I, gates H) product before the loop; `reverse` walks
    the steps from the last to the first (lax.scan's reverse) and keeps
    the outputs in time order."""
    gates_x = torch.matmul(x, cell['w_i2h'].t()) + cell['b_i2h']
    step = cell_step(mode)
    carry = (h0, c0) if mode == 'lstm' else (h0,)
    w_h2h, b_h2h = cell['w_h2h'], cell['b_h2h']
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    outs = [None] * x.shape[0]
    for t in steps:
        carry, outs[t] = step(carry, gates_x[t], w_h2h, b_h2h)
    out = torch.stack(outs, dim=0)
    return out, carry[0], (carry[1] if mode == 'lstm' else None)


def _rnn_compute(attrs, inputs, auxs, op_ctx):
    mode = _rnn_mode(attrs)
    h_size, nl, ndir, gates = _rnn_dims(attrs)
    p = asfloat(attrs.get('p', 0.0))
    state_outputs = asbool(attrs.get('state_outputs', False))

    data = inputs[0]                       # (T, N, I): TNC
    params = inputs[1]
    state = inputs[2]                      # (nl * ndir, N, H)
    state_cell = inputs[3] if mode == 'lstm' else None

    cells = _split_params(params, attrs, data.shape[2])
    x = data
    h_finals, c_finals = [], []
    for layer in range(nl):
        if layer > 0 and p > 0 and op_ctx.is_train:
            x = dropout(x, p, op_ctx.rng)
        outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            c0 = state_cell[idx] if state_cell is not None else None
            out, h_t, c_t = run_layer(mode, x, cells[idx], state[idx], c0,
                                      reverse=(d == 1))
            outs.append(out)
            h_finals.append(h_t)
            if c_t is not None:
                c_finals.append(c_t)
        x = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)

    outputs = [x]
    if state_outputs:
        outputs.append(torch.stack(h_finals, dim=0))
        if mode == 'lstm':
            outputs.append(torch.stack(c_finals, dim=0))
    return outputs, []


def _rnn_input_names(attrs):
    names = ['data', 'parameters', 'state']
    if _rnn_mode(attrs) == 'lstm':
        names.append('state_cell')
    return names


def _rnn_num_outputs(attrs):
    if not asbool(attrs.get('state_outputs', False)):
        return 1
    return 3 if _rnn_mode(attrs) == 'lstm' else 2


def _rnn_infer_shape(attrs, in_shapes):
    h, nl, ndir, gates = _rnn_dims(attrs)
    d = in_shapes[0]
    if d is None:
        return in_shapes
    t, n, isz = d
    if in_shapes[1] is None:
        in_shapes[1] = (rnn_param_size(attrs, isz),)
    sshape = (nl * ndir, n, h)
    for i in range(2, len(in_shapes)):
        s = in_shapes[i]
        if s is None or (len(s) == 3 and 0 in s):
            # an unknown or partly known (0-dim) state takes its shape
            # from the data: FusedRNNCell.begin_state's zeros(shape=(l,
            # 0, h))
            in_shapes[i] = sshape
    return in_shapes


register('RNN', input_names=_rnn_input_names, num_outputs=_rnn_num_outputs,
         infer_shape=_rnn_infer_shape, needs_rng=True, mode_dependent=True,
         hint='rnn', simple=False)(_rnn_compute)
