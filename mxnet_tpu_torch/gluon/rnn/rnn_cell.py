"""Gluon recurrent cells: the counterpart of
mxnet_tpu/gluon/rnn/rnn_cell.py (reference
python/mxnet/gluon/rnn/rnn_cell.py).

Each cell computes one time step over NDArrays; `unroll` runs T steps
imperatively, each op recorded by autograd. The fused layers of
rnn_layer.py run a whole sequence in one op instead.
"""
from ... import ndarray as nd
from ..block import HybridBlock
from ..parameter import ParameterDict


class RecurrentCell(HybridBlock):
    """Base class for recurrent cells."""

    def __init__(self, prefix=None, params=None):
        super(RecurrentCell, self).__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial states for this cell."""
        assert not self._modified, \
            'After applying modifier cells (e.g. ZoneoutCell) the base ' \
            'cell cannot be called directly. Call the modifier cell instead.'
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info.update(kwargs)
            shape = info.pop('shape')
            info.pop('__layout__', None)
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """Run the cell over `length` steps.

        inputs: NDArray (batch, T, C) for 'NTC' or list of (batch, C).
        Returns (outputs, states)."""
        self.reset()
        axis = layout.find('T')
        if isinstance(inputs, nd.NDArray):
            if length == 1:
                inputs = [nd.reshape(
                    inputs, tuple(d for i, d in enumerate(inputs.shape)
                                  if i != axis))]
            else:
                inputs = nd.split(inputs, num_outputs=length, axis=axis,
                                  squeeze_axis=True)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=inputs[0].shape[0],
                                           ctx=inputs[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super(RecurrentCell, self).forward(inputs, states)

    def _infer_param_shapes_rnn(self, inputs, params_hidden):
        in_units = inputs.shape[-1]
        for name, p in self._reg_params.items():
            if p._deferred_init:
                if name == 'i2h_weight':
                    p.shape = (p.shape[0], in_units)
                p._finish_deferred_init()

    def _infer_param_shapes(self, x, *args):
        self._infer_param_shapes_rnn(x, None)

    def _register_fc_params(self, gate_mult, hidden_size, input_size,
                            i2h_weight_init, h2h_weight_init,
                            i2h_bias_init, h2h_bias_init):
        """Register the cell's stacked i2h/h2h projection parameters
        (gate_mult = gates per step: 1 rnn, 4 lstm, 3 gru)."""
        wide = gate_mult * hidden_size
        specs = (('i2h_weight', (wide, input_size), i2h_weight_init),
                 ('h2h_weight', (wide, hidden_size), h2h_weight_init),
                 ('i2h_bias', (wide,), i2h_bias_init),
                 ('h2h_bias', (wide,), h2h_bias_init))
        for pname, shape, init in specs:
            setattr(self, pname, self.params.get(
                pname, shape=shape, init=init, allow_deferred_init=True))


class RNNCell(RecurrentCell):
    """Simple Elman RNN cell: h' = act(W_ih x + b_ih + W_hh h + b_hh)."""

    def __init__(self, hidden_size, activation='tanh',
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size, self._input_size = hidden_size, input_size
        self._activation = activation
        self._register_fc_params(1, hidden_size, input_size,
                                 i2h_weight_initializer,
                                 h2h_weight_initializer,
                                 i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return 'rnn'

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """LSTM cell with i,f,c,o gates (reference rnn_cell.py LSTMCell;
    gate order matches cuDNN/MXNet: in, forget, cell, out)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size, self._input_size = hidden_size, input_size
        self._register_fc_params(4, hidden_size, input_size,
                                 i2h_weight_initializer,
                                 h2h_weight_initializer,
                                 i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return 'lstm'

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size)},
                {'shape': (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slices[0], act_type='sigmoid')
        forget_gate = F.Activation(slices[1], act_type='sigmoid')
        in_transform = F.Activation(slices[2], act_type='tanh')
        out_gate = F.Activation(slices[3], act_type='sigmoid')
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type='tanh')
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    """GRU cell (reset/update gates; reference rnn_cell.py GRUCell)."""

    def __init__(self, hidden_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._hidden_size, self._input_size = hidden_size, input_size
        self._register_fc_params(3, hidden_size, input_size,
                                 i2h_weight_initializer,
                                 h2h_weight_initializer,
                                 i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return 'gru'

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type='sigmoid')
        update_gate = F.Activation(i2h_z + h2h_z, act_type='sigmoid')
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type='tanh')
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step."""

    def __init__(self, prefix=None, params=None):
        super(SequentialRNNCell, self).__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum([c.state_info(batch_size) for c in self._children], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._children], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children:
            n = len(cell.state_info())
            state = states[pos:pos + n]
            pos += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class ModifierCell(RecurrentCell):
    """Base for cells that wrap another cell."""

    def __init__(self, base_cell):
        super(ModifierCell, self).__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(RecurrentCell):
    """Stateless cell applying dropout to its inputs
    (reference rnn_cell.py DropoutCell)."""

    def __init__(self, rate, prefix=None, params=None):
        super(DropoutCell, self).__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def __call__(self, inputs, states):
        self._counter += 1
        if self.rate > 0:
            inputs = nd.Dropout(inputs, p=self.rate)
        return inputs, states

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly keep previous states
    (reference rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            'BidirectionalCell does not support zoneout. Apply ' \
            'ZoneoutCell to the cells underneath instead.'
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super(ZoneoutCell, self).reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        self._counter += 1
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: nd.Dropout(nd.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = nd.zeros_like(next_output)
        output = nd.where(mask(p_outputs, next_output), next_output,
                          prev_output) if p_outputs != 0. else next_output
        new_states = [nd.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self._prev_output = output
        return output, new_states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ResidualCell(ModifierCell):
    """Adds the input to the output of the base cell."""

    def __call__(self, inputs, states):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class BidirectionalCell(RecurrentCell):
    """Runs l_cell forward and r_cell backward over the sequence; outputs
    concatenated (unroll-only, like the reference)."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super(BidirectionalCell, self).__init__(prefix='', params=None)
        self._output_prefix = output_prefix
        for child in (l_cell, r_cell):
            self.register_child(child)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            'Bidirectional cells cannot be stepped. Please use unroll')

    def state_info(self, batch_size=0):
        out = []
        for c in self._children:
            out.extend(c.state_info(batch_size))
        return out

    def begin_state(self, **kwargs):
        assert not self._modified
        out = []
        for c in self._children:
            out.extend(c.begin_state(**kwargs))
        return out

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        axis = layout.find('T')
        if isinstance(inputs, nd.NDArray):
            batch_size = inputs.shape[1 - axis if axis <= 1 else 0]
            seq = nd.split(inputs, num_outputs=length, axis=axis,
                           squeeze_axis=True) if length > 1 else [inputs]
        else:
            seq = list(inputs)
            batch_size = seq[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           ctx=seq[0].context)
        l_cell, r_cell = self._children
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout='NTC',
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, list(reversed(seq)), begin_state[n_l:], layout='NTC',
            merge_outputs=False)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError
