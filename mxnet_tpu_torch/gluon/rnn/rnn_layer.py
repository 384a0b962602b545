"""Fused recurrent layers (RNN, LSTM, GRU): the counterpart of
mxnet_tpu/gluon/rnn/rnn_layer.py (reference
python/mxnet/gluon/rnn/rnn_layer.py over src/operator/rnn-inl.h).

The whole multi-layer, optionally bidirectional recurrence is one op
run through `nd.invoke_fn`, recorded by autograd like a registered op:
each direction of each layer is the fused RNN op's loop
(ops/rnn_op.py), the input projection one product over all T, then one
recurrent product per step. The reverse direction runs forward over the flipped sequence
and flips its outputs back; dropout between layers draws its mask from
the device's generator in train mode.
"""
import torch

from ... import ndarray as nd
from ...ops import nn as nn_ops
from ...ops import rnn_op
from ..block import Block


class _RNNLayer(Block):
    """Shared implementation. Layout 'TNC' (seq, batch, feature) like
    the reference default."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super(_RNNLayer, self).__init__(**kwargs)
        assert layout in ('TNC', 'NTC'), \
            'Invalid layout %s; must be one of TNC or NTC' % layout
        self._hidden_size, self._num_layers = hidden_size, num_layers
        self._mode, self._layout = mode, layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4,
                       'gru': 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (['l', 'r'] if bidirectional else ['l']):
                self._register_param(
                    '%s%d_i2h_weight' % (j, i), (ng * nh, ni),
                    i2h_weight_initializer)
                self._register_param(
                    '%s%d_h2h_weight' % (j, i), (ng * nh, nh),
                    h2h_weight_initializer)
                self._register_param(
                    '%s%d_i2h_bias' % (j, i), (ng * nh,),
                    i2h_bias_initializer)
                self._register_param(
                    '%s%d_h2h_bias' % (j, i), (ng * nh,),
                    h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        states = []
        for info in self.state_info(batch_size):
            info.update(kwargs)
            shape = info.pop('shape')
            states.append(func(shape, **info))
        return states

    def _finish_deferred(self, in_units):
        ng, nh = self._gates, self._hidden_size
        ni = in_units
        for i in range(self._num_layers):
            for j in (['l', 'r'] if self._dir == 2 else ['l']):
                for suffix, shape in (
                        ('i2h_weight', (ng * nh, ni)),
                        ('h2h_weight', (ng * nh, nh)),
                        ('i2h_bias', (ng * nh,)),
                        ('h2h_bias', (ng * nh,))):
                    p = getattr(self, '%s%d_%s' % (j, i, suffix))
                    if p._deferred_init:
                        p.shape = shape
                        p._finish_deferred_init()
            ni = nh * self._dir

    def forward(self, inputs, states=None):
        if self._layout == 'NTC':
            inputs = nd.swapaxes(inputs, dim1=0, dim2=1)
        T, N, C = inputs.shape
        self._finish_deferred(C)
        ctx = inputs.context
        skip_states = states is None
        if skip_states:
            states = self.begin_state(N, ctx=ctx)
        if isinstance(states, nd.NDArray):
            states = [states]
        # flatten params in deterministic order
        pnames = []
        for i in range(self._num_layers):
            for j in (['l', 'r'] if self._dir == 2 else ['l']):
                for suffix in ('i2h_weight', 'h2h_weight', 'i2h_bias',
                               'h2h_bias'):
                    pnames.append('%s%d_%s' % (j, i, suffix))
        params = [getattr(self, n).data(ctx) for n in pnames]
        inputs_all = [inputs] + params + list(states)
        out_arrays = nd.invoke_fn(
            _rnn_forward, inputs_all,
            dict(mode=self._mode, num_layers=self._num_layers,
                 dirs=self._dir, dropout=self._dropout),
            name='_fused_rnn')
        outputs = out_arrays[0]
        out_states = out_arrays[1:]
        if self._layout == 'NTC':
            outputs = nd.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, list(out_states)

    def __call__(self, inputs, *args):
        return self.forward(inputs, *args)


def _rnn_forward(attrs, inputs, auxs, op_ctx):
    """The fused multi-layer (bi)RNN: rnn_op's loop per layer and
    direction."""
    mode = attrs['mode']
    L, dirs = attrs['num_layers'], attrs['dirs']
    dropout = attrs['dropout']
    per_dir = 4
    n_params = L * dirs * per_dir
    x = inputs[0]
    params = inputs[1:1 + n_params]
    states = inputs[1 + n_params:]
    # states: [h (L*dirs, N, H)], or [h, c] for the LSTM
    h0 = states[0]
    c0 = states[1] if mode == 'lstm' else None

    out = x
    final_h = []
    final_c = []
    pidx = 0
    for layer in range(L):
        dir_outs = []
        for d in range(dirs):
            i2h_w, h2h_w, i2h_b, h2h_b = params[pidx:pidx + 4]
            pidx += 4
            sidx = layer * dirs + d
            seq = out if d == 0 else torch.flip(out, dims=(0,))
            cell = dict(w_i2h=i2h_w, w_h2h=h2h_w, b_i2h=i2h_b, b_h2h=h2h_b)
            ys, h_t, c_t = rnn_op.run_layer(
                mode, seq, cell, h0[sidx],
                c0[sidx] if c0 is not None else None)
            if d == 1:
                ys = torch.flip(ys, dims=(0,))
            dir_outs.append(ys)
            final_h.append(h_t)
            if c_t is not None:
                final_c.append(c_t)
        out = dir_outs[0] if dirs == 1 else torch.cat(dir_outs, dim=-1)
        if dropout > 0 and layer != L - 1 and op_ctx.is_train \
                and op_ctx.rng is not None:
            out = nn_ops.dropout(out, dropout, op_ctx.rng)
    outs = [out, torch.stack(final_h)]
    if c0 is not None:
        outs.append(torch.stack(final_c))
    return outs, []


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or relu
    (reference rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super(RNN, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, 'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super(LSTM, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, 'lstm', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size)},
                {'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super(GRU, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, 'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]
