"""The port's `gluon.rnn` against the JAX package's, on the CPU, with
seeded numpy inputs and weights and the float32 tolerance of
tests/test_gluon_rnn.py (1e-5).

- Cells (RNN relu and tanh, LSTM, GRU, Sequential, Bidirectional,
  Residual, Dropout at 0, Zoneout at 0) unrolled under
  autograd.record(): outputs, final states and the gradients of the
  input and of every parameter, from the JAX cell's weights.
- The fused layers (RNN, LSTM, GRU; one and two layers, one and two
  directions, TNC and NTC, with and without given states): outputs,
  states and gradients the same way; deferred input sizes; dropout in
  eval mode; the layer against LSTMCell.unroll over its own weights.
- Dropout between the layers in train mode: the packages draw from
  different generators, so the mask is held by its kept share and its
  scale 1 / (1 - p), within 5 standard errors.
- The hybridized cell against the imperative one, and save_params /
  load_params across the packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-5)
T, N, C, H = 5, 3, 4, 6


def _cell(pkg, kind):
    r = pkg.gluon.rnn
    if kind == 'rnn_relu':
        return r.RNNCell(H, activation='relu', input_size=C, prefix='c_')
    if kind == 'rnn_tanh':
        return r.RNNCell(H, input_size=C, prefix='c_')
    if kind == 'lstm':
        return r.LSTMCell(H, input_size=C, prefix='c_')
    if kind == 'gru':
        return r.GRUCell(H, input_size=C, prefix='c_')
    if kind == 'sequential':
        stack = r.SequentialRNNCell(prefix='s_')
        with stack.name_scope():
            stack.add(r.LSTMCell(H, input_size=C, prefix='l0_'))
            stack.add(r.DropoutCell(0.0, prefix='d_'))
            stack.add(r.ResidualCell(r.GRUCell(H, input_size=H,
                                               prefix='g1_')))
        return stack
    if kind == 'bidirectional':
        return r.BidirectionalCell(r.LSTMCell(H, input_size=C, prefix='l_'),
                                   r.GRUCell(H, input_size=C, prefix='r_'))
    if kind == 'zoneout':
        return r.ZoneoutCell(r.RNNCell(H, input_size=C, prefix='z_'),
                             zoneout_outputs=0.0, zoneout_states=0.0)
    raise ValueError(kind)


def _values(block, seed):
    """Seeded uniform values for every parameter, by name."""
    rs = np.random.RandomState(seed)
    return {name: (rs.rand(*p.shape).astype(np.float32) - 0.5) * 0.8
            for name, p in sorted(block.collect_params().items())}


def _set(pkg, block, values):
    for name, p in block.collect_params().items():
        p.set_data(pkg.nd.array(values[name], ctx=pkg.cpu()))


def _params_grads(block):
    return {name: p.grad().asnumpy()
            for name, p in block.collect_params().items()
            if p.grad_req != 'null'}


def _run(pkg, block, call, x_np, heads_seed):
    """call(block, x) under autograd.record(), the loss a seeded linear
    function of every output: (outputs, input grad, param grads)."""
    x = pkg.nd.array(x_np, ctx=pkg.cpu())
    x.attach_grad()
    with pkg.autograd.record():
        outs = call(block, x)
        rs = np.random.RandomState(heads_seed)
        loss = None
        for o in outs:
            w = pkg.nd.array(rs.randn(*o.shape).astype(np.float32),
                             ctx=pkg.cpu())
            term = pkg.nd.sum(o * w)
            loss = term if loss is None else loss + term
    loss.backward()
    return [o.asnumpy() for o in outs], x.grad.asnumpy(), \
        _params_grads(block)


def _both(make, call, x_np, seed=0):
    """The same block in both packages from the JAX block's seeded
    values: the port's and the JAX package's (outputs, dx, grads)."""
    jb = make(jmx)
    jb.initialize(ctx=jmx.cpu())
    values = _values(jb, seed)
    _set(jmx, jb, values)
    tb = make(mx)
    tb.initialize(ctx=mx.cpu())
    assert sorted(tb.collect_params().keys()) == sorted(values)
    _set(mx, tb, values)
    return _run(mx, tb, call, x_np, seed + 1), \
        _run(jmx, jb, call, x_np, seed + 1)


def _compare(got, ref):
    (t_outs, t_dx, t_grads), (j_outs, j_dx, j_grads) = got, ref
    assert len(t_outs) == len(j_outs)
    for a, b in zip(t_outs, j_outs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(t_dx, j_dx, **TOL)
    assert sorted(t_grads) == sorted(j_grads)
    for name, g in j_grads.items():
        np.testing.assert_allclose(t_grads[name], g, err_msg=name, **TOL)


def _unroll(block, x):
    outputs, states = block.unroll(T, x, layout='NTC', merge_outputs=True)
    return [outputs] + list(states)


@pytest.mark.parametrize('kind', ['rnn_relu', 'rnn_tanh', 'lstm', 'gru',
                                  'sequential', 'bidirectional', 'zoneout'])
def test_cell_unroll_matches_jax(kind):
    x = np.random.RandomState(3).randn(N, T, C).astype(np.float32)
    got, ref = _both(lambda pkg: _cell(pkg, kind), _unroll, x)
    _compare(got, ref)


def test_cell_step_and_begin_state_match_jax():
    x = np.random.RandomState(4).randn(N, C).astype(np.float32)

    def step(block, x):
        states = block.begin_state(N, ctx=x.context)
        out, new = block(x, states)
        return [out] + list(new)
    got, ref = _both(lambda pkg: _cell(pkg, 'lstm'), step, x)
    _compare(got, ref)


LAYER_CASES = {
    'rnn_relu': ('RNN', dict(activation='relu'), 1, False, 'TNC', False),
    'rnn_tanh_bi_ntc': ('RNN', dict(activation='tanh'), 2, True, 'NTC',
                        True),
    'lstm': ('LSTM', {}, 1, False, 'TNC', True),
    'lstm_2_bi': ('LSTM', {}, 2, True, 'TNC', True),
    'lstm_2_ntc_no_states': ('LSTM', {}, 2, False, 'NTC', False),
    'gru_bi': ('GRU', {}, 1, True, 'TNC', True),
    'gru_2': ('GRU', {}, 2, False, 'NTC', True),
}


def _layer(pkg, case, input_size=C, dropout=0.0):
    kind, kw, layers, bi, layout, _ = LAYER_CASES[case]
    return getattr(pkg.gluon.rnn, kind)(
        H, num_layers=layers, layout=layout, bidirectional=bi,
        dropout=dropout, input_size=input_size, prefix='y_', **kw)


def _layer_states(pkg, block, batch, seed):
    rs = np.random.RandomState(seed)
    return [pkg.nd.array(rs.randn(*s.shape).astype(np.float32) * 0.5,
                         ctx=pkg.cpu())
            for s in block.begin_state(batch, ctx=pkg.cpu())]


@pytest.mark.parametrize('case', sorted(LAYER_CASES))
def test_fused_layer_matches_jax(case):
    layout, with_states = LAYER_CASES[case][4], LAYER_CASES[case][5]
    shape = (T, N, C) if layout == 'TNC' else (N, T, C)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    pkgs = {}

    def call(block, xa):
        pkg = mx if isinstance(xa, mx.nd.NDArray) else jmx
        if not with_states:
            return [block(xa)]
        states = _layer_states(pkg, block, N, 9)
        for s in states:
            s.attach_grad()
        pkgs[pkg] = states
        out, new = block(xa, states)
        return [out] + list(new)
    got, ref = _both(lambda pkg: _layer(pkg, case), call, x)
    _compare(got, ref)
    if with_states:
        for a, b in zip(pkgs[mx], pkgs[jmx]):
            np.testing.assert_allclose(a.grad.asnumpy(), b.grad.asnumpy(),
                                       **TOL)


def test_layer_deferred_input_size_and_eval_dropout():
    """input_size 0: the first forward completes the shapes (as the JAX
    layer does); dropout 0.5 outside training changes nothing."""
    x = np.random.RandomState(6).randn(T, N, C).astype(np.float32)
    outs = {}
    for pkg in (jmx, mx):
        ref = _layer(pkg, 'lstm_2_bi', input_size=C)
        ref.initialize(ctx=pkg.cpu())
        values = _values(ref, 0)
        _set(pkg, ref, values)
        lazy = _layer(pkg, 'lstm_2_bi', input_size=0, dropout=0.5)
        lazy.initialize(ctx=pkg.cpu())
        xa = pkg.nd.array(x, ctx=pkg.cpu())
        lazy(xa)
        assert lazy.l0_i2h_weight.shape == (4 * H, C)
        assert lazy.l1_i2h_weight.shape == (4 * H, 2 * H)
        _set(pkg, lazy, values)
        a = lazy(xa).asnumpy()
        np.testing.assert_array_equal(a, ref(xa).asnumpy())
        outs[pkg] = a
    np.testing.assert_allclose(outs[mx], outs[jmx], **TOL)


def test_layer_equals_cell_unroll_in_eval_mode():
    """LSTMCell.unroll over the layer's own weights (each layer a cell,
    one direction) equals the two-layer LSTM, dropout 0.5 in eval."""
    layer = mx.gluon.rnn.LSTM(H, num_layers=2, dropout=0.5, input_size=C,
                              prefix='e_')
    layer.initialize(ctx=mx.cpu())
    _set(mx, layer, _values(layer, 2))
    x = np.random.RandomState(7).randn(T, N, C).astype(np.float32)
    out = layer(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    seq = mx.nd.array(x.transpose(1, 0, 2), ctx=mx.cpu())
    for i, width in enumerate((C, H)):
        cell = mx.gluon.rnn.LSTMCell(H, input_size=width, prefix='k%d_' % i)
        cell.initialize(ctx=mx.cpu())
        for part in ('i2h_weight', 'h2h_weight', 'i2h_bias', 'h2h_bias'):
            getattr(cell, part).set_data(
                getattr(layer, 'l%d_%s' % (i, part)).data())
        seq, _ = cell.unroll(T, seq, layout='NTC', merge_outputs=True)
    np.testing.assert_allclose(seq.asnumpy().transpose(1, 0, 2), out, **TOL)


def test_layer_dropout_mask_statistics():
    """Train mode: between the two layers each unit is kept with
    probability 1 - p and scaled by 1 / (1 - p). With the second layer's
    input weights the identity on a one-hot gate and its recurrence
    zero, its candidate gate reads the dropped first-layer outputs
    directly; the kept share and the scale hold within 5 standard
    errors, and two forwards draw different masks."""
    p, hidden, n, steps = 0.3, 8, 512, 4
    layer = mx.gluon.rnn.RNN(hidden, num_layers=2, activation='relu',
                             dropout=p, input_size=hidden, prefix='m_')
    layer.initialize(ctx=mx.cpu())
    eye = np.eye(hidden, dtype=np.float32)
    zeros = np.zeros((hidden, hidden), np.float32)
    for name, value in (('l0_i2h_weight', eye), ('l0_h2h_weight', zeros),
                        ('l1_i2h_weight', eye), ('l1_h2h_weight', zeros)):
        getattr(layer, name).set_data(mx.nd.array(value, ctx=mx.cpu()))
    for name in ('l0_i2h_bias', 'l0_h2h_bias', 'l1_i2h_bias',
                 'l1_h2h_bias'):
        getattr(layer, name).set_data(mx.nd.zeros((hidden,), ctx=mx.cpu()))
    x = mx.nd.array(np.ones((steps, n, hidden), np.float32), ctx=mx.cpu())
    with mx.autograd.train_mode():
        a = layer(x).asnumpy()
        b = layer(x).asnumpy()
    kept = a != 0
    share = kept.mean()
    se = np.sqrt(p * (1 - p) / kept.size)
    assert abs(share - (1 - p)) <= 5 * se, share
    np.testing.assert_allclose(a[kept], 1.0 / (1 - p), rtol=1e-6)
    assert (a != b).any()
    np.testing.assert_array_equal(layer(x).asnumpy(), np.ones_like(a))


def test_hybridized_cell_and_params_across_packages(tmp_path):
    x = np.random.RandomState(8).randn(N, C).astype(np.float32)
    cell = _cell(mx, 'gru')
    cell.initialize(ctx=mx.cpu())
    _set(mx, cell, _values(cell, 4))
    xa = mx.nd.array(x, ctx=mx.cpu())
    states = cell.begin_state(N, ctx=mx.cpu())
    plain, _ = cell(xa, states)
    cell.hybridize()
    hyb, _ = cell(xa, states)
    np.testing.assert_array_equal(hyb.asnumpy(), plain.asnumpy())
    fname = str(tmp_path / 'gru.params')
    cell.save_params(fname)
    jcell = _cell(jmx, 'gru')
    jcell.load_params(fname, ctx=jmx.cpu())
    jout, _ = jcell(jmx.nd.array(x), jcell.begin_state(N))
    np.testing.assert_allclose(jout.asnumpy(), plain.asnumpy(), **TOL)


# -- chip_smoke.py's gate of phase 15 ------------------------------------------

def test_phase15_gate_passes_a_good_run_and_refuses_bad_ones():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    zero = dict(conv_bn_stats=0, flash_fwd=0, flash_bwd_dkdv=0,
                flash_bwd_dq=0, rtc=0)
    run = dict(kernel_launches=zero, losses=[9.2, 8.0, 7.1, 6.5, 6.0, 5.8],
               param_devices=['cuda:0'], unroll=dict(ok=True),
               dropout=dict(ok=True))
    assert cs.gluon_lm_gate(run) == []
    assert cs.gluon_lm_gate(dict(run, kernel_launches=dict(zero,
                                                           flash_fwd=1)))
    assert any('loss' in m for m in cs.gluon_lm_gate(dict(
        run, losses=[9.2, 9.3, 9.4, 9.5, 9.3, 9.4])))
    assert cs.gluon_lm_gate(dict(run, losses=[9.2, float('nan')] * 3))
    assert cs.gluon_lm_gate(dict(run, param_devices=['cpu']))
    assert cs.gluon_lm_gate(dict(run, unroll=dict(ok=False)))
    assert cs.gluon_lm_gate(dict(run, dropout=dict(ok=False)))
