"""The port's fused RNN op, `mx.rnn` and `init.FusedRNN` against the JAX
package's, on the CPU, with seeded numpy inputs and the float32
tolerance of tests/test_rnn.py (1e-5).

- The `RNN` op imperatively: outputs and the gradients of data,
  parameters and states for every mode, one and two directions, with
  and without state_outputs; its registration and shape inference
  (states given with a 0 batch dimension); `rnn_param_size` and the flat
  layout; dropout between layers only in training.
- Cells: FusedRNNCell and the unfused cells (RNN, LSTM, GRU, sequential,
  bidirectional, residual, dropout, zoneout) unrolled into symbols,
  bound and run forward and backward in both packages; the fused cell
  against its `unfuse()`d stack with the weights of `unpack_weights`;
  pack and unpack.
- `FusedRNN` against the JAX initializer: bit-equal where both draw the
  same numbers (LSTMBias, Constant, Orthogonal, which draws from numpy's
  global generator); under a global Xavier, where the packages' random
  streams differ (mx.random against JAX's keys), the same blocks drawn
  within the same bounds.
- `encode_sentences` and `BucketSentenceIter` (bucket_major too): the
  same batches in the same order from one seed of Python's `random` and
  numpy's global generator.
- rnn checkpoints written by the port and read by the JAX package, and
  the other way.
- The LSTM language model of tests/test_rnn.py through BucketingModule
  in both packages from the same weights: parameters within rtol 1e-4 /
  atol 1e-5 after a mixed-length epoch (test_module.py's bound).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops import rnn_op as jrnn_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_op as trnn_op

TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-5)
MODES = ('rnn_relu', 'rnn_tanh', 'lstm', 'gru')
T, N, I, H, L = 4, 3, 5, 6, 2


def _attrs(mode, bidirectional=False, layers=L, h=H):
    return dict(mode=mode, state_size=h, num_layers=layers,
                bidirectional=bidirectional)


def _op_inputs(mode, bidirectional, seed):
    rs = np.random.RandomState(seed)
    psize = jrnn_op.rnn_param_size(_attrs(mode, bidirectional), I)
    ndir = 2 if bidirectional else 1
    vals = dict(data=rs.randn(T, N, I).astype(np.float32),
                parameters=(rs.rand(psize).astype(np.float32) - 0.5) * 0.6,
                state=rs.randn(L * ndir, N, H).astype(np.float32) * 0.5)
    if mode == 'lstm':
        vals['state_cell'] = rs.randn(L * ndir, N, H).astype(
            np.float32) * 0.5
    return vals


def _run_op(pkg, vals, mode, bidirectional, state_outputs, seed):
    """nd.RNN under autograd.record(): the outputs and the gradients of
    every input for a seeded linear loss over every output."""
    ctx = pkg.cpu()
    arrays = {k: pkg.nd.array(v, ctx=ctx) for k, v in vals.items()}
    for a in arrays.values():
        a.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.RNN(state_outputs=state_outputs,
                          **_attrs(mode, bidirectional), **arrays)
        outs = outs if isinstance(outs, list) else [outs]
        rs = np.random.RandomState(seed)
        loss = None
        for o in outs:
            w = pkg.nd.array(rs.randn(*o.shape).astype(np.float32),
                             ctx=ctx)
            term = pkg.nd.sum(o * w)
            loss = term if loss is None else loss + term
    loss.backward()
    return ([o.asnumpy() for o in outs],
            {k: a.grad.asnumpy() for k, a in arrays.items()})


# every mode in one and two directions with the final states; without
# them, the one-output form in two cases
OP_CASES = [(m, b, True) for m in MODES for b in (False, True)] + \
    [('lstm', False, False), ('gru', True, False)]


@pytest.mark.parametrize('mode,bidirectional,state_outputs', OP_CASES)
def test_rnn_op_matches_jax(mode, bidirectional, state_outputs):
    vals = _op_inputs(mode, bidirectional, seed=1)
    j_outs, j_grads = _run_op(jmx, vals, mode, bidirectional,
                              state_outputs, seed=2)
    t_outs, t_grads = _run_op(mx, vals, mode, bidirectional,
                              state_outputs, seed=2)
    ndir = 2 if bidirectional else 1
    want = 1 + (state_outputs * (2 if mode == 'lstm' else 1))
    assert len(t_outs) == len(j_outs) == want
    assert t_outs[0].shape == (T, N, H * ndir)
    for got, ref in zip(t_outs, j_outs):
        np.testing.assert_allclose(got, ref, **TOL)
    assert set(t_grads) == set(j_grads)
    for name, g in j_grads.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(t_grads[name], g, err_msg=name, **TOL)


def test_rnn_op_registers_as_its_jax_namesake():
    mine, theirs = treg.get('RNN'), jreg.get('RNN')
    for attr in ('num_aux', 'hint', 'mutable_aux', 'needs_rng',
                 'mode_dependent'):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    for mode in MODES:
        for so in (False, True):
            attrs = dict(_attrs(mode), state_outputs=so)
            for method in ('input_names', 'arg_names', 'num_outputs',
                           'output_names'):
                assert getattr(mine, method)(attrs) == \
                    getattr(theirs, method)(attrs), (mode, so, method)


@pytest.mark.parametrize('bidirectional', [False, True])
@pytest.mark.parametrize('mode', MODES)
def test_param_size_and_flat_layout(mode, bidirectional):
    for layers, h, isz in ((1, 4, 3), (3, 5, 7)):
        attrs = _attrs(mode, bidirectional, layers, h)
        assert trnn_op.rnn_param_size(attrs, isz) == \
            jrnn_op.rnn_param_size(attrs, isz)
        dims = (h, layers, 2 if bidirectional else 1,
                trnn_op._NUM_GATES[mode], isz)
        assert list(trnn_op.enumerate_param_blocks(*dims)) == \
            list(jrnn_op.enumerate_param_blocks(*dims))
        size = trnn_op.rnn_param_size(attrs, isz)
        flat = np.arange(size, dtype=np.float32)
        mine = trnn_op._split_params(torch.from_numpy(flat), attrs, isz)
        theirs = jrnn_op._split_params(flat, attrs, isz)
        assert len(mine) == len(theirs)
        for m, t in zip(mine, theirs):
            assert sorted(m) == sorted(t)
            for k in t:
                np.testing.assert_array_equal(m[k].numpy(), np.asarray(t[k]))


def test_rnn_shape_inference_resolves_zero_batch_states():
    """FusedRNNCell's states are zeros(shape=(l, 0, h)): the data shape
    resolves them, and the parameters' size, in both packages."""
    shapes = {}
    for pkg in (jmx, mx):
        cell = pkg.rnn.FusedRNNCell(H, num_layers=L, mode='lstm',
                                    bidirectional=True, prefix='f_',
                                    get_next_state=True)
        out, states = cell.unroll(T, pkg.sym.Variable('data'), layout='TNC',
                                  merge_outputs=True)
        grp = pkg.sym.Group([out] + states)
        shapes[pkg] = grp.infer_shape(data=(T, N, I))
    assert shapes[mx] == shapes[jmx]
    arg_shapes, out_shapes, _ = shapes[mx]
    assert out_shapes == [(T, N, 2 * H), (2 * L, N, H), (2 * L, N, H)]
    assert (trnn_op.rnn_param_size(_attrs('lstm', True), I),) in arg_shapes


def test_rnn_op_dropout_only_in_training():
    """p > 0: eval equals p = 0; a train forward drops units of the layers
    after the first (its output differs) and draws from the device's
    generator (two train forwards differ); one layer has nothing to
    drop."""
    vals = _op_inputs('lstm', False, seed=3)
    arrays = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in vals.items()}
    base = mx.nd.RNN(p=0.0, **_attrs('lstm'), **arrays).asnumpy()
    ev = mx.nd.RNN(p=0.5, **_attrs('lstm'), **arrays).asnumpy()
    np.testing.assert_array_equal(ev, base)
    with mx.autograd.train_mode():
        a = mx.nd.RNN(p=0.5, **_attrs('lstm'), **arrays).asnumpy()
        b = mx.nd.RNN(p=0.5, **_attrs('lstm'), **arrays).asnumpy()
    assert not np.allclose(a, base) and not np.allclose(a, b)
    one = dict(arrays, state=arrays['state'][0:1],
               state_cell=arrays['state_cell'][0:1],
               parameters=mx.nd.array(vals['parameters'][
                   :trnn_op.rnn_param_size(_attrs('lstm', layers=1), I)],
                   ctx=mx.cpu()))
    ev = mx.nd.RNN(p=0.5, **_attrs('lstm', layers=1), **one).asnumpy()
    with mx.autograd.train_mode():
        train = mx.nd.RNN(p=0.5, **_attrs('lstm', layers=1), **one)
    np.testing.assert_array_equal(train.asnumpy(), ev)


# -- cells, unrolled into symbols -------------------------------------------

def _bind_step(pkg, symbol, data_shape, values, head_seed):
    """simple_bind on cpu(), the arguments from `values` (numpy by name,
    seeded uniform for the rest), one forward(is_train=True) and a
    backward with seeded head gradients: (outputs, grads, values)."""
    ex = symbol.simple_bind(pkg.cpu(), data=data_shape)
    rs = np.random.RandomState(head_seed)
    for name, arr in ex.arg_dict.items():
        if name not in values:
            values[name] = (rs.rand(*arr.shape).astype(np.float32) - 0.5) \
                * 0.6
    ex.copy_params_from({k: v for k, v in values.items()
                         if k in ex.arg_dict})
    ex.forward(is_train=True)
    rs = np.random.RandomState(head_seed + 1)
    heads = [rs.randn(*o.shape).astype(np.float32) for o in ex.outputs]
    ex.backward([pkg.nd.array(h, ctx=pkg.cpu()) for h in heads])
    return ([o.asnumpy() for o in ex.outputs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()}, values)


def _cell_graph(pkg, kind):
    """A cell stack of `kind` unrolled over T steps of 'data' (NTC),
    merged, grouped with its final states."""
    r = pkg.rnn
    if kind == 'fused_lstm':
        cell = r.FusedRNNCell(H, num_layers=L, mode='lstm', prefix='f_',
                              get_next_state=True)
    elif kind == 'fused_gru_bi':
        cell = r.FusedRNNCell(H, num_layers=L, mode='gru', prefix='f_',
                              bidirectional=True, get_next_state=True)
    elif kind == 'fused_relu':
        cell = r.FusedRNNCell(H, num_layers=1, mode='rnn_relu',
                              prefix='f_', get_next_state=True)
    elif kind == 'rnn_tanh':
        cell = r.RNNCell(H, prefix='r_')
    elif kind == 'lstm':
        cell = r.LSTMCell(H, prefix='l_', forget_bias=1.0)
    elif kind == 'gru':
        cell = r.GRUCell(H, prefix='g_')
    elif kind == 'stack_bi_residual':
        cell = r.SequentialRNNCell()
        cell.add(r.BidirectionalCell(r.LSTMCell(H, prefix='l0_'),
                                     r.LSTMCell(H, prefix='r0_'),
                                     output_prefix='bi_'))
        cell.add(r.DropoutCell(0.0, prefix='drop_'))
        cell.add(r.ResidualCell(r.GRUCell(2 * H, prefix='g1_')))
    elif kind == 'zoneout_eval':
        # eval-free here: zoneout 0 keeps the graph's where() path off
        cell = r.ZoneoutCell(r.RNNCell(H, prefix='z_'), zoneout_outputs=0.,
                             zoneout_states=0.)
    outputs, states = cell.unroll(T, pkg.sym.Variable('data'),
                                  layout='NTC', merge_outputs=True)
    return pkg.sym.Group([outputs] + list(states))


CELL_KINDS = ('fused_lstm', 'fused_gru_bi', 'fused_relu', 'rnn_tanh', 'lstm',
              'gru', 'stack_bi_residual', 'zoneout_eval')


@pytest.mark.parametrize('kind', CELL_KINDS)
def test_cells_unrolled_match_jax(kind):
    data = np.random.RandomState(5).randn(N, T, I).astype(np.float32)
    j_outs, j_grads, values = _bind_step(
        jmx, _cell_graph(jmx, kind), (N, T, I), {'data': data}, 6)
    t_outs, t_grads, _ = _bind_step(
        mx, _cell_graph(mx, kind), (N, T, I), dict(values), 6)
    assert len(t_outs) == len(j_outs)
    for got, ref in zip(t_outs, j_outs):
        np.testing.assert_allclose(got, ref, **TOL)
    assert set(t_grads) == set(j_grads)
    for name, g in j_grads.items():
        np.testing.assert_allclose(t_grads[name], g, err_msg=name, **TOL)


@pytest.mark.parametrize('mode', MODES)
def test_fused_equals_its_unfused_stack(mode):
    """FusedRNNCell.unroll equals its unfuse()'d stack with the weights
    moved through unpack_weights (tests/test_rnn.py's check, every mode,
    two directions)."""
    fused = mx.rnn.FusedRNNCell(H, num_layers=L, mode=mode, prefix='m_',
                                bidirectional=True, get_next_state=True)
    out, states = fused.unroll(T, mx.sym.Variable('data'), layout='NTC',
                               merge_outputs=True)
    rs = np.random.RandomState(7)
    x = rs.randn(N, T, I).astype(np.float32)
    psize = trnn_op.rnn_param_size(_attrs(mode, True), I)
    pvals = (rs.rand(psize).astype(np.float32) - 0.5) * 0.6
    with mx.cpu():
        ex = out.simple_bind(mx.cpu(), data=(N, T, I), grad_req='null')
        ex.copy_params_from({'data': x, 'm_parameters': pvals})
        f_out = ex.forward()[0].asnumpy()
        unfused = fused.unfuse()
        u_out, _ = unfused.unroll(T, mx.sym.Variable('data'), layout='NTC',
                                  merge_outputs=True)
        args = fused.unpack_weights(
            {'m_parameters': mx.nd.array(pvals, ctx=mx.cpu())})
        ex2 = u_out.simple_bind(mx.cpu(), data=(N, T, I), grad_req='null')
        ex2.copy_params_from(dict(args, data=mx.nd.array(x)))
        u_val = ex2.forward()[0].asnumpy()
    np.testing.assert_allclose(f_out, u_val, **TOL)
    assert len(states) == (2 if mode == 'lstm' else 1)


@pytest.mark.parametrize('mode', MODES)
def test_pack_unpack_match_jax(mode):
    rs = np.random.RandomState(8)
    psize = trnn_op.rnn_param_size(_attrs(mode, True), I)
    pvals = rs.rand(psize).astype(np.float32)
    unpacked = {}
    for pkg in (jmx, mx):
        cell = pkg.rnn.FusedRNNCell(H, num_layers=L, mode=mode,
                                    bidirectional=True, prefix='p_')
        unpacked[pkg] = cell.unpack_weights(
            {'p_parameters': pkg.nd.array(pvals, ctx=pkg.cpu())})
        packed = cell.pack_weights(unpacked[pkg])
        np.testing.assert_array_equal(packed['p_parameters'].asnumpy(),
                                      pvals)
    assert sorted(unpacked[mx]) == sorted(unpacked[jmx])
    for k, v in unpacked[jmx].items():
        assert unpacked[mx][k].context == mx.cpu()
        np.testing.assert_array_equal(unpacked[mx][k].asnumpy(),
                                      v.asnumpy())
    # the unfused cells' per-gate split, both packages
    for pkg in (jmx, mx):
        cell = pkg.rnn.LSTMCell(H, prefix='c_')
        w = pkg.nd.array(np.arange(4 * H * 3, dtype=np.float32).reshape(
            4 * H, 3), ctx=pkg.cpu())
        args = {'c_i2h_weight': w, 'c_h2h_weight': w,
                'c_i2h_bias': w[:, 0], 'c_h2h_bias': w[:, 0]}
        split = cell.unpack_weights(args)
        unpacked[pkg] = {k: v.asnumpy() for k, v in split.items()}
        back = cell.pack_weights(split)
        np.testing.assert_array_equal(back['c_i2h_weight'].asnumpy(),
                                      w.asnumpy())
    assert sorted(unpacked[mx]) == sorted(unpacked[jmx])
    for k, v in unpacked[jmx].items():
        np.testing.assert_array_equal(unpacked[mx][k], v)


# -- the FusedRNN initializer -------------------------------------------------

def _fused_init(pkg, init, mode, bidirectional, global_init=None):
    """A flat parameter vector initialised as a FusedRNNCell's is: the
    global initializer (Uniform unless given) meets the variable's
    __init__ attribute, FusedRNN's dumps()."""
    size = jrnn_op.rnn_param_size(_attrs(mode, bidirectional), I)
    arr = pkg.nd.zeros((size,), ctx=pkg.cpu())
    fused = pkg.init.FusedRNN(init, H, L, mode, bidirectional=bidirectional,
                              forget_bias=2.0)
    desc = pkg.init.InitDesc('f_parameters',
                             attrs={'__init__': fused.dumps()})
    (global_init or pkg.init.Uniform())(desc, arr)
    return arr.asnumpy()


@pytest.mark.parametrize('mode', ('lstm', 'gru'))
def test_fused_rnn_initializer_bit_equal_to_jax(mode):
    """Orthogonal (numpy's global draws), Constant and LSTMBias take the
    same numbers in both packages: the flat vectors are bit-equal."""
    for make in (lambda p: p.init.Orthogonal(scale=1.2),
                 lambda p: p.init.Constant(0.25)):
        got = {}
        for pkg in (jmx, mx):
            np.random.seed(11)
            got[pkg] = _fused_init(pkg, make(pkg), mode, True)
        np.testing.assert_array_equal(got[mx], got[jmx])
    if mode == 'lstm':
        # the i2h biases take LSTMBias: the forget quarter at forget_bias
        blocks = mx.rnn.FusedRNNCell(H, num_layers=L, mode='lstm',
                                     bidirectional=True, prefix='')
        with mx.cpu():
            parts = blocks.unpack_weights(
                {'parameters': mx.nd.array(got[mx])})
        bias = parts['l0_i2h_bias'].asnumpy()
        np.testing.assert_array_equal(bias[H:2 * H], 2.0)
        assert not bias[:H].any() and not bias[2 * H:].any()
    assert mx.init.FusedRNN(mx.init.Xavier(), H, L, mode).dumps() == \
        jmx.init.FusedRNN(jmx.init.Xavier(), H, L, mode).dumps()


def test_fused_rnn_initializer_under_a_global_xavier():
    """With no inner init the blocks take the global initializer: the
    random streams differ between the packages, so each weight block is
    held to Xavier's bound, the biases to zero (the LSTM i2h's to
    LSTMBias), as in the JAX package's vector."""
    got = {}
    for pkg in (jmx, mx):
        pkg.random.seed(0)
        got[pkg] = _fused_init(pkg, None, 'lstm', False,
                               global_init=pkg.init.Xavier())
    for pkg in (jmx, mx):
        blocks = trnn_op._split_params(torch.from_numpy(got[pkg].copy()),
                                       _attrs('lstm'), I)
        for b in blocks:
            for key in ('w_i2h', 'w_h2h'):
                w = b[key].numpy()
                bound = np.sqrt(3.0 / ((w.shape[0] + w.shape[1]) / 2.0))
                assert np.abs(w).max() <= bound and w.std() > bound / 4
            np.testing.assert_array_equal(b['b_h2h'].numpy(), 0.0)
            bias = b['b_i2h'].numpy()
            np.testing.assert_array_equal(bias[H:2 * H], 2.0)
    arr = mx.nd.zeros((jrnn_op.rnn_param_size(_attrs('gru'), I),),
                      ctx=mx.cpu())
    with pytest.raises(AssertionError, match='global initializer'):
        mx.init.FusedRNN(None, H, L, 'gru')._init_weight(
            mx.init.InitDesc('f_parameters'), arr)


# -- data: encode_sentences and BucketSentenceIter ---------------------------

def _sentences(n, vocab, seed):
    rs = np.random.RandomState(seed)
    return [[int(w) + 1 for w in rs.randint(0, vocab, size=rs.randint(2, 14))]
            for _ in range(n)]


def test_encode_sentences_matches_jax():
    words = [['w%d' % w for w in s] for s in _sentences(40, 9, 12)]
    for kwargs in (dict(invalid_label=0, start_label=1),
                   dict(invalid_label=-1, start_label=0),
                   dict(invalid_label=2, start_label=1)):
        mine = mx.rnn.encode_sentences(words, **kwargs)
        theirs = jmx.rnn.encode_sentences(words, **kwargs)
        assert mine == theirs
    _, vocab = jmx.rnn.encode_sentences(words, invalid_label=0,
                                        start_label=1)
    assert mx.rnn.encode_sentences(words, vocab=dict(vocab)) == \
        jmx.rnn.encode_sentences(words, vocab=dict(vocab))


def _batches(pkg, sentences, bucket_major, epochs=2):
    random.seed(21)
    np.random.seed(22)
    it = pkg.rnn.BucketSentenceIter(sentences, batch_size=8,
                                    buckets=[4, 8, 12], invalid_label=0,
                                    bucket_major=bucket_major)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy(),
                        b.label[0].asnumpy(), b.provide_data[0].shape))
        it.reset()
    return it, out


@pytest.mark.parametrize('bucket_major', [False, True])
def test_bucket_sentence_iter_matches_jax(bucket_major):
    sentences = _sentences(300, 20, 13)
    t_it, mine = _batches(mx, sentences, bucket_major)
    j_it, theirs = _batches(jmx, sentences, bucket_major)
    assert len(mine) == len(theirs) > 10
    for (kt, dt, lt, st), (kj, dj, lj, sj) in zip(mine, theirs):
        assert kt == kj and st == sj == (8, kt)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(lt[:, :-1], dt[:, 1:])
    assert t_it.provide_data == j_it.provide_data
    assert t_it.default_bucket_key == j_it.default_bucket_key == 12
    batch = next(iter(t_it))
    assert batch.data[0].context == mx.cpu()
    if bucket_major:
        keys = [k for k, *_ in mine[:len(mine) // 2]]
        runs = [k for i, k in enumerate(keys) if i == 0 or keys[i - 1] != k]
        assert len(runs) == len(set(keys))


# -- rnn checkpoints across the packages --------------------------------------

def _ckpt_cell(pkg):
    return pkg.rnn.FusedRNNCell(H, num_layers=L, mode='lstm', prefix='ck_')


def test_rnn_checkpoint_port_to_jax_and_back(tmp_path):
    rs = np.random.RandomState(14)
    psize = trnn_op.rnn_param_size(_attrs('lstm'), I)
    pvals = rs.rand(psize).astype(np.float32)
    fc = rs.rand(3, H).astype(np.float32)
    for writer, reader, name in ((mx, jmx, 'port'), (jmx, mx, 'jax')):
        prefix = str(tmp_path / name)
        cell = _ckpt_cell(writer)
        out, _ = cell.unroll(T, writer.sym.Variable('data'), layout='TNC',
                             merge_outputs=True)
        symbol = writer.sym.FullyConnected(out, num_hidden=3, name='fc')
        ctx = writer.cpu()
        args = {'ck_parameters': writer.nd.array(pvals, ctx=ctx),
                'fc_weight': writer.nd.array(fc, ctx=ctx)}
        writer.rnn.save_rnn_checkpoint(cell, prefix, 3, symbol, args, {})
        with writer.cpu():
            on_disk = writer.nd.load('%s-0003.params' % prefix)
        assert 'arg:ck_l0_i2h_weight' in on_disk
        assert 'arg:ck_parameters' not in on_disk
        with reader.cpu():
            sym, arg, aux = reader.rnn.load_rnn_checkpoint(
                _ckpt_cell(reader), prefix, 3)
        assert sym.tojson() == symbol.tojson()
        assert sorted(arg) == ['ck_parameters', 'fc_weight'] and aux == {}
        np.testing.assert_array_equal(arg['ck_parameters'].asnumpy(), pvals)
        np.testing.assert_array_equal(arg['fc_weight'].asnumpy(), fc)


def test_do_rnn_checkpoint_period(tmp_path):
    cell = _ckpt_cell(mx)
    out, _ = cell.unroll(T, mx.sym.Variable('data'), layout='TNC',
                         merge_outputs=True)
    pvals = np.ones(trnn_op.rnn_param_size(_attrs('lstm'), I), np.float32)
    cb = mx.rnn.do_rnn_checkpoint(cell, str(tmp_path / 'cb'), period=2)
    for epoch in range(4):
        cb(epoch, out, {'ck_parameters': mx.nd.array(pvals, ctx=mx.cpu())},
           {})
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.suffix == '.params') == ['cb-0002.params',
                                                'cb-0004.params']


# -- the LSTM language model through BucketingModule --------------------------

VOCAB, EMBED, HIDDEN = 16, 8, 12


def _lm_sym_gen(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.Variable('data')
        label = pkg.sym.Variable('softmax_label')
        emb = pkg.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                name='embed')
        cell = pkg.rnn.FusedRNNCell(HIDDEN, num_layers=2, mode='lstm',
                                    prefix='lstm_')
        outputs, _ = cell.unroll(seq_len, emb, layout='NTC',
                                 merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = pkg.sym.FullyConnected(pred, num_hidden=VOCAB, name='pred')
        lab = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label=lab, name='softmax')
        return pred, ('data',), ('softmax_label',)
    return sym_gen


def _toy_sentences():
    rs = np.random.RandomState(0)
    out = []
    for _ in range(64):
        ln = rs.choice([4, 8])
        s0 = rs.randint(1, VOCAB)
        out.append([(s0 + i) % VOCAB for i in range(ln)])
    return out


def _lm_train(pkg, start=None):
    random.seed(3)
    np.random.seed(4)
    it = pkg.rnn.BucketSentenceIter(_toy_sentences(), batch_size=8,
                                    buckets=[4, 8], invalid_label=0)
    mod = pkg.mod.BucketingModule(_lm_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if start is None:
        pkg.random.seed(0)
        mod.init_params(initializer=pkg.init.Xavier())
    else:
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in start.items()})
    args, _ = mod.get_params()
    start = {k: v.asnumpy() for k, v in args.items()}
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params={'learning_rate': 0.5})
    metric = pkg.metric.Perplexity(ignore_label=None)
    keys = []
    for batch in it:
        keys.append(batch.bucket_key)
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
    args, _ = mod.get_params()
    return start, {k: v.asnumpy() for k, v in args.items()}, \
        metric.get()[1], keys


def test_lstm_lm_bucketing_matches_jax():
    start, j_end, j_ppl, j_keys = _lm_train(jmx)
    _, t_end, t_ppl, t_keys = _lm_train(mx, start)
    assert t_keys == j_keys and set(t_keys) == {4, 8}
    # the FusedRNN initializer gave the forget quarter of the i2h biases 1
    assert sorted(start) == sorted(t_end) == sorted(j_end)
    for name, v in j_end.items():
        np.testing.assert_allclose(t_end[name], v, err_msg=name, **PARAMS)
        assert not np.array_equal(v, start[name]), name
    np.testing.assert_allclose(t_ppl, j_ppl, rtol=1e-4)


# -- chip_smoke.py's gate of phase 14 ------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_phase14_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    zero = dict(conv_bn_stats=0, flash_fwd=0, flash_bwd_dkdv=0,
                flash_bwd_dq=0, rtc=0)
    run = dict(kernel_launches=zero, epoch_perplexity=[900.0, 300.0],
               batches_per_epoch=[48, 48],
               buckets_bound=list(cs.PTB['buckets']), shared_params=True,
               unfused=dict(ok=True), cpu=dict(ok=True),
               bulk=dict(differ=[], compared=8, moms=4, dispatches=11,
                         dispatches_want=11),
               checkpoint=dict(differ=[], extra=[], compared=4,
                               same_symbol=True, unpacked=True))
    assert cs.ptb_gate(run) == []
    assert any('hand-written' in m for m in cs.ptb_gate(dict(
        run, kernel_launches=dict(zero, rtc=1))))
    assert any('perplexity' in m for m in cs.ptb_gate(dict(
        run, epoch_perplexity=[300.0, 301.0])))
    assert cs.ptb_gate(dict(run, batches_per_epoch=[19, 19]))
    assert cs.ptb_gate(dict(run, buckets_bound=[10, 20]))
    assert cs.ptb_gate(dict(run, shared_params=False))
    assert cs.ptb_gate(dict(run, unfused=dict(ok=False)))
    assert cs.ptb_gate(dict(run, cpu=dict(ok=False)))
    assert cs.ptb_gate(dict(run, bulk=dict(run['bulk'], differ=['arg w'])))
    assert cs.ptb_gate(dict(run, bulk=dict(run['bulk'], dispatches=10)))
    assert cs.ptb_gate(dict(run, checkpoint=dict(run['checkpoint'],
                                                 unpacked=False)))
    # the bucketing module's fit(bulk=4) dispatches only full groups
    assert cs.bulk_dispatches([10] * 14 + [20] * 20 + [10] * 3, 4) == 8
    # the corpus: words of PTB's vocabulary, lengths 1 to the longest bucket
    words = cs.ptb_sentences(64, cs.PTB['vocab'], 60, 0)
    assert min(map(len, words)) >= 1 and max(map(len, words)) <= 60
    ids, vocab = mx.rnn.encode_sentences(words, invalid_label=0,
                                         start_label=1)
    assert max(max(s) for s in ids) < cs.PTB['vocab'] and \
        min(min(s) for s in ids) >= 1
