"""Symbolic RNN cells (`mx.rnn.*`): the counterpart of
mxnet_tpu/rnn/rnn_cell.py (reference python/mxnet/rnn/rnn_cell.py).

Cells compose `Symbol` graphs step by step (`unroll`), share parameters
through `RNNParams`, and convert weights to and from the fused `RNN` op
(`FusedRNNCell.unpack_weights` / `pack_weights`). An unrolled graph is
ordinary symbol composition, which the executor walks op by op;
`FusedRNNCell` instead emits the one `RNN` op (ops/rnn_op.py), whose
input projection is one product over all the steps.

Initial states follow the reference: `begin_state` emits
`sym.zeros(shape=(0, H))` with the batch dimension 0, which the
symbol's bidirectional shape inference fills from the rest of the graph.

Arrays that unpack_weights and pack_weights make lie on the context of
the arrays they were given (the current context for numpy ones).
"""
from functools import reduce
from itertools import chain

import numpy as np

from .. import symbol
from .. import ndarray
from ..ops.rnn_op import rnn_param_size


class RNNParams(object):
    """Container for holding variables shared between cells
    (reference rnn_cell.py RNNParams)."""

    def __init__(self, prefix=''):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Bring sequence data into the form a caller asked for.

    `inputs` is either one time-stacked symbol or a python list with one
    symbol per step.  Returns (inputs, time_axis) where inputs is a list
    of per-step symbols when merge is False, one stacked symbol when
    merge is True, and is passed through unchanged when merge is None.
    `in_layout` names the layout of an already-stacked input when it
    differs from the requested `layout`.
    """
    if inputs is None:
        raise ValueError('unroll requires inputs')
    t_out = layout.find('T')
    t_in = in_layout.find('T') if in_layout is not None else t_out

    if not isinstance(inputs, symbol.Symbol):
        # per-step list
        if length is not None and len(inputs) != length:
            raise ValueError('expected %s step inputs, got %d'
                             % (length, len(inputs)))
        if merge is True:
            steps = [symbol.expand_dims(s, axis=t_out) for s in inputs]
            return symbol.Concat(*steps, dim=t_out), t_out
        return list(inputs), t_out

    # stacked symbol
    if merge is False:
        if len(inputs.list_outputs()) != 1:
            raise ValueError(
                'unroll cannot split a grouped symbol; pass a list of '
                'per-step symbols or use merge_outputs=True')
        steps = symbol.split(inputs, axis=t_in, num_outputs=length,
                             squeeze_axis=1)
        return list(steps), t_out
    if t_in != t_out:
        inputs = symbol.swapaxes(inputs, dim1=t_out, dim2=t_in)
    return inputs, t_out


class BaseRNNCell(object):
    """Abstract base class for symbolic RNN cells
    (reference rnn_cell.py BaseRNNCell)."""

    def __init__(self, prefix='', params=None):
        self._prefix = prefix
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-using the cell for another graph."""
        self._init_counter = self._counter = -1

    def __call__(self, inputs, states):
        """Construct the symbol for one step of RNN.
        Returns (output, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """shape/layout information of states, batch dim encoded as 0."""
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele['shape'] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial state symbols (reference rnn_cell.py begin_state).
        Default func=sym.zeros with the batch dim encoded as 0:
        bidirectional shape inference (symbol._run_shape_inference)
        fills it from the rest of the graph, as the reference's nnvm
        InferShape does. Pass func=sym.Variable for states
        fed explicitly at bind time."""
        assert not self._modified, (
            'After applying modifier cells (e.g. DropoutCell) the base '
            'cell cannot be called directly. Call the modifier cell instead.')
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = '%sbegin_state_%d' % (self._prefix, self._init_counter)
            if func is symbol.Variable:
                state = func(name, **kwargs)
            else:
                info = dict(info or {})
                info.update(kwargs)
                state = func(name=name, **info)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split stacked gate weights into per-gate arrays
        (reference BaseRNNCell.unpack_weights)."""
        gates = self._gate_names
        if not gates:
            return args
        h = self._num_hidden
        out = args.copy()
        for group in ('i2h', 'h2h'):
            for kind in ('weight', 'bias'):
                stacked = out.pop('%s%s_%s' % (self._prefix, group, kind))
                for j, gate in enumerate(gates):
                    out['%s%s%s_%s' % (self._prefix, group, gate, kind)] = \
                        stacked[j * h:(j + 1) * h].copy()
        return out

    def pack_weights(self, args):
        """Concatenate per-gate arrays back into stacked weights."""
        gates = self._gate_names
        if not gates:
            return args
        out = args.copy()
        for group in ('i2h', 'h2h'):
            for kind in ('weight', 'bias'):
                parts = [out.pop('%s%s%s_%s'
                                 % (self._prefix, group, gate, kind))
                         for gate in gates]
                out['%s%s_%s' % (self._prefix, group, kind)] = \
                    ndarray.concatenate(parts)
        return out

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """Unroll the cell for `length` steps.  Returns (outputs, states)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        states = self.begin_state() if begin_state is None else begin_state
        per_step = []
        for step_input in inputs:
            out, states = self(step_input, states)
            per_step.append(out)
        outputs, _ = _normalize_sequence(length, per_step, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def _fc_params(self, bias_init=None):
        """The four stacked projection params (iW, iB, hW, hB)."""
        get = self.params.get
        i2h_bias = (get('i2h_bias') if bias_init is None
                    else get('i2h_bias', init=bias_init))
        return (get('i2h_weight'), i2h_bias,
                get('h2h_weight'), get('h2h_bias'))

    def _fc_pair(self, inputs, hidden, width, name):
        """The step's two projections: W x and R h."""
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB, num_hidden=width,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=hidden, weight=self._hW,
                                    bias=self._hB, num_hidden=width,
                                    name='%sh2h' % name)
        return i2h, h2h


class RNNCell(BaseRNNCell):
    """Simple recurrent cell: h' = act(W x + R h + b)."""

    def __init__(self, num_hidden, activation='tanh', prefix='rnn_',
                 params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW, self._iB, self._hW, self._hB = self._fc_params()

    @property
    def state_info(self):
        """One hidden state, batch dim deferred (0)."""
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        """Single un-gated projection."""
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h, h2h = self._fc_pair(inputs, states[0], self._num_hidden, name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name='%sout' % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, cuDNN gate order (i, f, g, o)
    (reference rnn_cell.py LSTMCell)."""

    def __init__(self, num_hidden, prefix='lstm_', params=None,
                 forget_bias=1.0):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        from .. import initializer as init
        self._num_hidden = num_hidden
        self._iW, self._iB, self._hW, self._hB = self._fc_params(
            bias_init=init.LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'},
                {'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ('_i', '_f', '_c', '_o')

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h, h2h = self._fc_pair(inputs, states[0],
                                 self._num_hidden * 4, name)
        sliced = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                     name='%sslice' % name)
        # cuDNN gate order: input, forget, candidate, output.
        gate_acts = (('i', 'sigmoid'), ('f', 'sigmoid'),
                     ('c', 'tanh'), ('o', 'sigmoid'))
        in_gate, forget_gate, in_transform, out_gate = (
            symbol.Activation(sliced[k], act_type=act,
                              name='%s%s' % (name, tag))
            for k, (tag, act) in enumerate(gate_acts))
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type='tanh')
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, cuDNN formulation: reset applied to (R h + b_R)
    (reference rnn_cell.py GRUCell)."""

    def __init__(self, num_hidden, prefix='gru_', params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW, self._iB, self._hW, self._hB = self._fc_params()

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ('_r', '_z', '_o')

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        prev_h = states[0]
        i2h, h2h = self._fc_pair(inputs, prev_h, self._num_hidden * 3, name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name='%si2h_slice' % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name='%sh2h_slice' % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type='sigmoid',
                                  name='%sr_act' % name)
        update = symbol.Activation(i2h_z + h2h_z, act_type='sigmoid',
                                   name='%sz_act' % name)
        candidate = symbol.Activation(i2h + reset * h2h, act_type='tanh',
                                      name='%sh_act' % name)
        next_h = (1. - update) * candidate + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN cell emitting the single `RNN` op
    (reference rnn_cell.py FusedRNNCell, the cuDNN path; here
    ops/rnn_op.py)."""

    def __init__(self, num_hidden, num_layers=1, mode='lstm',
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super(FusedRNNCell, self).__init__(
            prefix='%s_' % mode if prefix is None else prefix, params=params)
        self._num_hidden, self._num_layers = num_hidden, num_layers
        self._mode, self._bidirectional = mode, bidirectional
        self._dropout, self._get_next_state = dropout, get_next_state
        self._forget_bias = forget_bias
        self._directions = ['l', 'r'] if bidirectional else ['l']
        from .. import initializer as init
        self._parameter = self.params.get(
            'parameters', init=init.FusedRNN(
                None, num_hidden, num_layers, mode,
                bidirectional=bidirectional, forget_bias=forget_bias))

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == 'lstm') + 1
        return [{'shape': (b * self._num_layers, 0, self._num_hidden),
                 '__layout__': 'LNC'} for _ in range(n)]

    @property
    def _gate_names(self):
        return {'rnn_relu': [''], 'rnn_tanh': [''],
                'lstm': ['_i', '_f', '_c', '_o'],
                'gru': ['_r', '_z', '_o']}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise NotImplementedError('FusedRNNCell cannot be stepped. '
                                  'Please use unroll')

    def _attrs(self):
        return {'mode': self._mode, 'state_size': self._num_hidden,
                'num_layers': self._num_layers,
                'bidirectional': self._bidirectional}

    def _slice_weights(self, arr, li, lh):
        """Slice the flat parameter ndarray into per-layer blocks with
        unfused-cell names ('l0_i2h_weight', ...).  Layout comes from
        ops.rnn_op.enumerate_param_blocks, the walk the fused op uses,
        so pack and unpack cannot drift from the op."""
        from ..ops.rnn_op import enumerate_param_blocks
        args = {}
        end = 0
        for layer, d, group, kind, start, shape in enumerate_param_blocks(
                lh, self._num_layers, len(self._directions),
                self._num_gates, li):
            name = '%s%s%d_%s_%s' % (self._prefix, self._directions[d],
                                     layer, group, kind)
            n = int(np.prod(shape))
            args[name] = arr[start:start + n].reshape(shape)
            end = start + n
        assert end == arr.size, 'parameter size mismatch'
        return args

    def unpack_weights(self, args):
        args = args.copy()
        arr = args.pop('%sparameters' % self._prefix)
        ctx = _ctx_of(arr)
        nd_arr = arr.asnumpy() if hasattr(arr, 'asnumpy') else np.asarray(arr)
        li = self._infer_input_size(nd_arr)
        blocks = self._slice_weights(nd_arr, li, self._num_hidden)
        for name, block in blocks.items():
            args[name] = ndarray.array(np.ascontiguousarray(block), ctx=ctx)
        return args

    def _infer_input_size(self, arr):
        """Recover input size from total parameter count (invert
        rnn_param_size)."""
        h = self._num_hidden
        nl = self._num_layers
        ndir = len(self._directions)
        g = self._num_gates
        total = arr.size
        # total = ndir*g*h*(isz + h) + (nl-1)*ndir*g*h*(h*ndir + h)
        #         + nl*ndir*2*g*h
        rest = (nl - 1) * ndir * g * h * (h * ndir + h) + nl * ndir * 2 * g * h
        isz = (total - rest) // (ndir * g * h) - h
        return int(isz)

    def pack_weights(self, args):
        args = args.copy()
        w0 = args['%sl0_i2h_weight' % self._prefix]
        num_input = w0.shape[1]
        total = rnn_param_size(self._attrs(), num_input)
        flat = np.zeros((total,), dtype='float32')
        ctx = _ctx_of(w0)
        blocks = self._slice_weights(flat, num_input, self._num_hidden)
        for name, view in blocks.items():
            src = args.pop(name)
            src = src.asnumpy() if hasattr(src, 'asnumpy') else \
                np.asarray(src)
            view[...] = src.reshape(view.shape)
        args['%sparameters' % self._prefix] = ndarray.array(flat, ctx=ctx)
        return args

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state

        kwargs = {'data': inputs, 'parameters': self._parameter,
                  'state': states[0]}
        if self._mode == 'lstm':
            kwargs['state_cell'] = states[1]
        rnn = symbol.RNN(mode=self._mode, state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         name='%srnn' % self._prefix, **kwargs)

        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == 'lstm':
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs, in_layout=layout)
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of per-step cells (reference
        FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            'rnn_relu': lambda cell_prefix: RNNCell(
                self._num_hidden, activation='relu', prefix=cell_prefix),
            'rnn_tanh': lambda cell_prefix: RNNCell(
                self._num_hidden, activation='tanh', prefix=cell_prefix),
            'lstm': lambda cell_prefix: LSTMCell(
                self._num_hidden, prefix=cell_prefix,
                forget_bias=self._forget_bias),
            'gru': lambda cell_prefix: GRUCell(
                self._num_hidden, prefix=cell_prefix)}[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell('%sl%d_' % (self._prefix, i)),
                    get_cell('%sr%d_' % (self._prefix, i)),
                    output_prefix='%sbi_l%d_' % (self._prefix, i)))
            else:
                stack.add(get_cell('%sl%d_' % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix='%s_dropout%d_' %
                                      (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step
    (reference rnn_cell.py SequentialRNNCell)."""

    def __init__(self, params=None):
        super(SequentialRNNCell, self).__init__(prefix='', params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, (
                'Either specify params for SequentialRNNCell or child '
                'cells, not both.')
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        """Concatenated state roster of the stacked cells."""
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        """Initial states for every stacked cell, flattened."""
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        """Unpack through each stacked cell in turn."""
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        """Pack through each stacked cell in turn."""
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        carried = []
        for cell, chunk in zip(self._cells,
                               _split_states(states, self._cells)):
            assert not isinstance(cell, BidirectionalCell)
            inputs, chunk = cell(inputs, chunk)
            carried.extend(chunk)
        return inputs, carried

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        carried = []
        last = len(self._cells) - 1
        for i, (cell, chunk) in enumerate(
                zip(self._cells, _split_states(begin_state, self._cells))):
            inputs, chunk = cell.unroll(
                length, inputs=inputs, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            carried.extend(chunk)
        return inputs, carried

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]


class BidirectionalCell(BaseRNNCell):
    """Runs a forward and a backward cell over the sequence and
    concatenates outputs (reference rnn_cell.py BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix='bi_'):
        super(BidirectionalCell, self).__init__('', params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        self._cells = [l_cell, r_cell]
        for cell in self._cells:
            if self._override_cell_params:
                assert cell._own_params, (
                    'Either specify params for BidirectionalCell or child '
                    'cells, not both.')
                cell.params._params.update(self.params._params)
            self.params._params.update(cell.params._params)

    def unpack_weights(self, args):
        """Unpack through both directions in turn."""
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        """Pack through both directions in turn."""
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError('Bidirectional cells cannot be stepped. '
                                  'Please use unroll')

    @property
    def state_info(self):
        """Both directions' state rosters, flattened."""
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        """Initial states for both directions, flattened."""
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        states = self.begin_state() if begin_state is None else begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout,
            merge_outputs=merge_outputs)

        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, symbol.Symbol) and \
                isinstance(r_outputs, symbol.Symbol)
            l_outputs, _ = _normalize_sequence(length, l_outputs, layout,
                                               merge_outputs)
            r_outputs, _ = _normalize_sequence(length, r_outputs, layout,
                                               merge_outputs)

        if merge_outputs:
            reversed_r = symbol.reverse(r_outputs, axis=axis)
            outputs = symbol.Concat(l_outputs, reversed_r, dim=2,
                                    name='%sout' % self._output_prefix)
        else:
            outputs = [symbol.Concat(l_o, r_o, dim=1,
                                     name='%st%d' % (self._output_prefix, i))
                       for i, (l_o, r_o) in enumerate(
                           zip(l_outputs, reversed(r_outputs)))]
        states = l_states + r_states
        return outputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells that wrap another cell (reference ModifierCell).

    Params, states, and pack/unpack all delegate to the wrapped cell;
    subclasses only reinterpret the step function.
    """

    def __init__(self, base_cell):
        super(ModifierCell, self).__init__()
        self.base_cell = base_cell
        base_cell._modified = True

    @property
    def params(self):
        """The wrapped cell's params (a modifier owns none)."""
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        """The wrapped cell's state roster."""
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        # Unlock the wrapped cell just long enough to mint state symbols.
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        """Delegates to the wrapped cell."""
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        """Delegates to the wrapped cell."""
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class DropoutCell(BaseRNNCell):
    """Applies dropout on the input (reference DropoutCell)."""

    def __init__(self, dropout, prefix='dropout_', params=None):
        super(DropoutCell, self).__init__(prefix, params)
        assert isinstance(dropout, (int, float))
        self.dropout = dropout

    @property
    def state_info(self):
        """Stateless."""
        return []

    def __call__(self, inputs, states):
        dropped = (symbol.Dropout(data=inputs, p=self.dropout)
                   if self.dropout > 0 else inputs)
        return dropped, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super(DropoutCell, self).unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, (FusedRNNCell, BidirectionalCell)), (
            '%s does not support zoneout; unfuse()/unwrap to the cells '
            'underneath first.' % type(base_cell).__name__)
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs, self.zoneout_states = (zoneout_outputs,
                                                     zoneout_states)
        self.prev_output = None

    def reset(self):
        super(ZoneoutCell, self).reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0. \
            else next_output
        new_states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds residual connection: output = base(input) + input
    (reference ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name='%s_plus_residual' % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) if \
            merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


def _ctx_of(arr):
    """The context of an NDArray, None (the current one) for others."""
    return arr.context if isinstance(arr, ndarray.NDArray) else None


def _split_states(states, cells):
    """Carve a flat state list into per-cell chunks (by state_info width)."""
    chunks = []
    pos = 0
    for cell in cells:
        width = len(cell.state_info)
        chunks.append(states[pos:pos + width])
        pos += width
    return chunks


def _cells_state_info(cells):
    return list(chain.from_iterable(c.state_info for c in cells))


def _cells_begin_state(cells, **kwargs):
    return list(chain.from_iterable(c.begin_state(**kwargs) for c in cells))


def _cells_unpack_weights(cells, args):
    return reduce(lambda acc, cell: cell.unpack_weights(acc), cells, args)


def _cells_pack_weights(cells, args):
    return reduce(lambda acc, cell: cell.pack_weights(acc), cells, args)
