"""The port's NN ops (mxnet_tpu_torch/ops/nn.py), executor and profiler
against the JAX package's, on the CPU.

Each op runs in both packages on the same seeded float32 inputs, forward
and backward (the gradient of the outputs against seeded cotangents),
at rtol 1e-5 / atol 1e-6, as tests/test_executor.py and
tests/test_train.py hold their own: the JAX side through its registry's
compute under jax.vjp, the port's through its registry's compute under
torch autograd. Then `nd.BatchNorm` under `autograd.record`, the
executor's grad_req, copy_params_from, aux updates and default head
gradients against the JAX executor, and the profiler's trace layout.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as reg

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _run_jax(name, attrs, inputs, auxs, is_train, cots):
    op = jreg.get(name)
    ctx = jreg.OpContext(is_train=is_train)
    aux_vals = [jnp.asarray(a) for a in auxs]

    def f(*xs):
        outs, new_aux = op.apply(attrs, list(xs), aux_vals, ctx)
        return tuple(outs), tuple(new_aux)

    outs, vjp, new_aux = jax.vjp(f, *[jnp.asarray(x) for x in inputs],
                                 has_aux=True)
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return ([np.asarray(o) for o in outs], [np.asarray(a) for a in new_aux],
            [np.asarray(g) for g in grads])


def _run_port(name, attrs, inputs, auxs, is_train, cots):
    op = reg.get(name)
    ctx = reg.OpContext(is_train=is_train, device=torch.device('cpu'))
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs, new_aux = op.apply(attrs, xs, [torch.tensor(a) for a in auxs],
                             ctx)
    live = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
            if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in live], xs,
                                [c for _, c in live], allow_unused=True)
    grads = [np.zeros_like(x) if g is None else g.numpy()
             for x, g in zip(inputs, grads)]
    return ([o.detach().numpy() for o in outs],
            [a.detach().numpy() for a in new_aux], grads)


def _check_op(name, attrs, inputs, auxs=(), is_train=False, seed=1):
    """The op in both packages: outputs, new aux states and gradients."""
    cots = _cots_for(name, attrs, inputs, auxs, is_train, seed)
    ref = _run_jax(name, attrs, inputs, auxs, is_train, cots)
    got = _run_port(name, attrs, inputs, auxs, is_train, cots)
    for kind, mine, theirs in zip(('output', 'aux', 'gradient'), got, ref):
        assert len(mine) == len(theirs), kind
        for i, (m, t) in enumerate(zip(mine, theirs)):
            assert m.shape == t.shape, (kind, i, m.shape, t.shape)
            np.testing.assert_allclose(m, t, err_msg='%s %d' % (kind, i),
                                       **TOL)


def _cots_for(name, attrs, inputs, auxs, is_train, seed):
    """Seeded cotangents of the op's outputs (shapes from the JAX run)."""
    op = jreg.get(name)
    ctx = jreg.OpContext(is_train=is_train)
    outs, _ = jax.eval_shape(
        lambda xs, a: op.apply(attrs, list(xs), list(a), ctx),
        [jnp.asarray(x) for x in inputs], [jnp.asarray(a) for a in auxs])
    rng = np.random.RandomState(seed)
    return [_rand(rng, o.shape) for o in outs]


NN_OPS = ['FullyConnected', 'Activation', 'Convolution', 'Pooling',
          'BatchNorm', 'SoftmaxOutput']


@pytest.mark.parametrize('name', NN_OPS)
def test_nn_op_registers_as_its_jax_namesake(name):
    mine, theirs = reg.get(name), jreg.get(name)
    attrs = {'no_bias': False, 'output_mean_var': True}
    for attr in ('num_aux', 'hint', 'mutable_aux', 'shape_rule',
                 'needs_rng', 'mode_dependent'):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    for method in ('input_names', 'arg_names', 'aux_names', 'num_outputs',
                   'output_names'):
        assert getattr(mine, method)(attrs) == \
            getattr(theirs, method)(attrs), method
    aliases = sorted(a for a, n in reg._OP_ALIASES.items() if n == name)
    assert aliases == sorted(a for a, n in jreg._OP_ALIASES.items()
                             if n == name)


CONV_CASES = {
    'stride_pad_bias': (dict(kernel=(3, 3), num_filter=6, stride=(2, 2),
                             pad=(1, 1)), (2, 4, 9, 9), (6, 4, 3, 3), True),
    'dilate': (dict(kernel=(3, 3), num_filter=5, dilate=(2, 2), pad=(2, 1),
                    no_bias=True), (2, 3, 10, 9), (5, 3, 3, 3), False),
    'groups': (dict(kernel=(3, 3), num_filter=6, num_group=2, pad=(1, 1)),
               (2, 4, 8, 8), (6, 2, 3, 3), True),
    'nhwc_io': (dict(kernel=(3, 3), num_filter=6, stride=(2, 2), pad=(1, 1),
                     no_bias=True, __layout__='NHWC'),
                (2, 9, 9, 4), (6, 4, 3, 3), False),
    'conv1d': (dict(kernel=(3,), num_filter=4, stride=(2,), pad=(1,)),
               (2, 3, 11), (4, 3, 3), True),
}


@pytest.mark.parametrize('case', sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    attrs, xs, ws, bias = CONV_CASES[case]
    rng = np.random.RandomState(0)
    inputs = [_rand(rng, xs), _rand(rng, ws, 0.3)]
    if bias:
        inputs.append(_rand(rng, (ws[0],)))
    _check_op('Convolution', attrs, inputs)


POOL_CASES = {
    'max_valid': (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
                  (2, 3, 9, 9)),
    'max_full_asym': (dict(kernel=(3, 3), stride=(2, 2),
                           pooling_convention='full'), (2, 3, 10, 10)),
    'avg_full_pad': (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type='avg', pooling_convention='full'),
                     (2, 3, 8, 8)),
    'sum_valid': (dict(kernel=(2, 3), stride=(2, 1), pool_type='sum'),
                  (2, 3, 7, 8)),
    'avg_1d': (dict(kernel=(3,), stride=(2,), pad=(1,), pool_type='avg'),
               (2, 3, 10)),
    'global_max': (dict(kernel=(7, 7), global_pool=True), (2, 3, 5, 6)),
    'global_avg': (dict(kernel=(7, 7), global_pool=True, pool_type='avg'),
                   (2, 3, 5, 6)),
    'global_sum': (dict(kernel=(7, 7), global_pool=True, pool_type='sum'),
                   (2, 3, 5, 6)),
    'nhwc_max': (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      __layout__='NHWC'), (2, 9, 8, 3)),
    'nhwc_global_avg': (dict(kernel=(7, 7), global_pool=True,
                             pool_type='avg', __layout__='NHWC'),
                        (2, 5, 5, 4)),
}


@pytest.mark.parametrize('case', sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    attrs, xs = POOL_CASES[case]
    _check_op('Pooling', attrs, [_rand(np.random.RandomState(2), xs)])


BN_CASES = {
    'train': (dict(fix_gamma=False, eps=2e-5, momentum=0.9), (4, 3, 5, 5),
              True),
    'train_fix_gamma': (dict(), (4, 3, 5, 5), True),
    'eval': (dict(fix_gamma=False), (4, 3, 5, 5), False),
    'global_stats': (dict(fix_gamma=False, use_global_stats=True),
                     (4, 3, 5, 5), True),
    'mean_var': (dict(fix_gamma=False, output_mean_var=True), (4, 3, 5, 5),
                 True),
    'mean_var_eval': (dict(output_mean_var=True), (4, 3, 5, 5), False),
    'axis_last': (dict(fix_gamma=False, axis=-1), (4, 6, 3), True),
    'flat': (dict(fix_gamma=False, momentum=0.5), (8, 3), True),
    'nhwc': (dict(fix_gamma=False, __layout__='NHWC'), (4, 5, 5, 3), True),
}


@pytest.mark.parametrize('case', sorted(BN_CASES))
def test_batchnorm_matches_jax(case):
    attrs, xs, is_train = BN_CASES[case]
    rng = np.random.RandomState(3)
    axis = attrs.get('axis', 1) % len(xs)
    if attrs.get('__layout__') == 'NHWC':
        axis = 3
    c = xs[axis]
    inputs = [_rand(rng, xs, 2.0, 0.5), _rand(rng, (c,), 0.2, 1.0),
              _rand(rng, (c,), 0.2)]
    auxs = [_rand(rng, (c,), 0.1), np.abs(_rand(rng, (c,), 0.2, 1.0))]
    _check_op('BatchNorm', attrs, inputs, auxs, is_train=is_train)


@pytest.mark.parametrize('flatten', [True, False])
def test_fully_connected_matches_jax(flatten):
    rng = np.random.RandomState(4)
    if flatten:
        attrs = dict(num_hidden=5)
        inputs = [_rand(rng, (3, 2, 2, 2)), _rand(rng, (5, 8)),
                  _rand(rng, (5,))]
    else:
        attrs = dict(num_hidden=5, flatten=False, no_bias=True)
        inputs = [_rand(rng, (3, 4, 6)), _rand(rng, (5, 6))]
    _check_op('FullyConnected', attrs, inputs)


@pytest.mark.parametrize('act_type', ['relu', 'sigmoid', 'tanh', 'softrelu',
                                      'softsign'])
def test_activation_matches_jax(act_type):
    x = _rand(np.random.RandomState(5), (4, 7), 3.0)
    _check_op('Activation', dict(act_type=act_type), [x])


SOFTMAX_CASES = {
    'null': (dict(), (6, 5), (6,)),
    'batch': (dict(normalization='batch', grad_scale=2.0), (6, 5), (6,)),
    'valid_ignore': (dict(normalization='valid', use_ignore=True,
                          ignore_label=1), (6, 5), (6,)),
    'null_ignore': (dict(use_ignore=True, ignore_label=0), (6, 5), (6,)),
    'multi_output': (dict(multi_output=True, normalization='valid'),
                     (3, 4, 5), (3, 5)),
    'preserve_shape': (dict(preserve_shape=True, normalization='batch'),
                       (3, 4, 5), (3, 4)),
}


@pytest.mark.parametrize('case', sorted(SOFTMAX_CASES))
def test_softmax_output_matches_jax(case):
    attrs, xs, ls = SOFTMAX_CASES[case]
    rng = np.random.RandomState(6)
    k = xs[-1] if attrs.get('preserve_shape') or len(xs) == 2 else xs[1]
    label = rng.randint(0, k, ls).astype(np.float32)
    _check_op('SoftmaxOutput', attrs, [_rand(rng, xs, 2.0), label])


def test_nd_batchnorm_under_record_updates_its_aux_holders():
    rng = np.random.RandomState(7)
    x = _rand(rng, (4, 3, 5, 5), 2.0, 1.0)
    g, b = _rand(rng, (3,), 0.2, 1.0), _rand(rng, (3,), 0.2)
    mm, mv = _rand(rng, (3,), 0.1), np.abs(_rand(rng, (3,), 0.2, 1.0))
    results = []
    for pkg, ndm in ((jmx, jnd), (mx, nd)):
        with pkg.cpu():
            arrays = [ndm.array(v) for v in (x, g, b, mm, mv)]
            arrays[0].attach_grad()
            with pkg.autograd.record(train_mode=True):
                out = ndm.BatchNorm(*arrays, fix_gamma=False, momentum=0.8)
            out.backward(ndm.array(np.cos(x)))
            results.append([out.asnumpy(), arrays[3].asnumpy(),
                            arrays[4].asnumpy(), arrays[0].grad.asnumpy()])
    assert not np.allclose(results[1][1], mm)
    for mine, theirs in zip(results[1], results[0]):
        np.testing.assert_allclose(mine, theirs, **TOL)
    # outside train mode the holders keep their values
    with mx.cpu():
        arrays = [nd.array(v) for v in (x, g, b, mm, mv)]
        nd.BatchNorm(*arrays, fix_gamma=False)
        np.testing.assert_array_equal(arrays[3].asnumpy(), mm)


# ---------------------------------------------------------------------------
# Executor semantics against the JAX executor
# ---------------------------------------------------------------------------

def _convnet(pkg):
    s = pkg.symbol
    data = s.Variable('data')
    conv = s.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                         name='conv')
    bn = s.BatchNorm(conv, fix_gamma=False, name='bn')
    act = s.Activation(bn, act_type='relu', name='relu')
    pool = s.Pooling(act, kernel=(2, 2), stride=(2, 2), pool_type='max',
                     name='pool')
    fc = s.FullyConnected(s.Flatten(pool, name='flat'), num_hidden=3,
                          name='fc')
    return s.SoftmaxOutput(fc, name='softmax')


SHAPES = dict(data=(4, 2, 6, 6))


def _params(symbol, seed):
    arg_shapes, _, aux_shapes = symbol.infer_shape(**SHAPES)
    rng = np.random.RandomState(seed)
    args = {n: _rand(rng, s, 0.5) for n, s in
            zip(symbol.list_arguments(), arg_shapes)}
    args['softmax_label'] = rng.randint(0, 3, (4,)).astype(np.float32)
    auxs = {n: np.abs(_rand(rng, s, 0.3, 0.5)) for n, s in
            zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _bind_both(grad_req='write', seed=8):
    jsym, tsym = _convnet(jmx), _convnet(mx)
    args, auxs = _params(tsym, seed)
    jex = jsym.simple_bind(jmx.cpu(), grad_req=grad_req, **SHAPES)
    tex = tsym.simple_bind(mx.cpu(), grad_req=grad_req, **SHAPES)
    for ex in (jex, tex):
        ex.copy_params_from(args, auxs)
    return jex, tex


def _assert_state_equal(jex, tex, tol=TOL):
    assert set(tex.grad_dict) == set(jex.grad_dict)
    for name, g in jex.grad_dict.items():
        np.testing.assert_allclose(tex.grad_dict[name].asnumpy(),
                                   g.asnumpy(), err_msg=name, **tol)
    for name, a in jex.aux_dict.items():
        np.testing.assert_allclose(tex.aux_dict[name].asnumpy(),
                                   a.asnumpy(), err_msg=name, **tol)
    for mine, theirs in zip(tex.outputs, jex.outputs):
        np.testing.assert_allclose(mine.asnumpy(), theirs.asnumpy(), **tol)


def test_backward_without_head_grads_on_a_loss_graph():
    jex, tex = _bind_both()
    for ex in (jex, tex):
        ex.forward(is_train=True)
        ex.backward()
    _assert_state_equal(jex, tex)
    assert np.abs(tex.grad_dict['conv_weight'].asnumpy()).sum() > 0


def test_aux_states_update_once_per_forward_and_backward():
    jex, tex = _bind_both(seed=9)
    before = tex.aux_dict['bn_moving_mean'].asnumpy()
    for ex in (jex, tex):
        ex.forward(is_train=True)
        ex.backward()
        ex.forward_backward()
        ex.forward(is_train=False)
    _assert_state_equal(jex, tex)
    assert not np.allclose(tex.aux_dict['bn_moving_mean'].asnumpy(), before)
    with pytest.raises(MXNetError):
        tex.backward()     # the graph of the last train forward is spent


@pytest.mark.parametrize('req', ['write', 'add', 'mixed'])
def test_grad_req_matches_jax(req):
    grad_req = req if req != 'mixed' else {
        'conv_weight': 'add', 'conv_bias': 'null', 'fc_weight': 'write',
        'bn_gamma': 'add', 'bn_beta': 'write'}
    jex, tex = _bind_both(grad_req=grad_req, seed=10)
    rng = np.random.RandomState(11)
    heads = _rand(rng, (4, 3))
    for ex, ndm in ((jex, jnd), (tex, nd)):
        with (jmx if ex is jex else mx).cpu():
            ex.forward_backward()
            ex.forward(is_train=True)
            ex.backward(ndm.array(heads))
    _assert_state_equal(jex, tex)
    if req == 'mixed':
        assert 'conv_bias' not in tex.grad_dict and 'data' not in \
            tex.grad_dict


def test_copy_params_from_and_its_refusals():
    _, tex = _bind_both()
    w = np.full(tex.arg_dict['fc_weight'].shape, 0.25, np.float32)
    with mx.cpu():
        tex.copy_params_from({'fc_weight': nd.array(w)},
                             {'bn_moving_var': np.full((4,), 2.0)})
    np.testing.assert_array_equal(tex.arg_dict['fc_weight'].asnumpy(), w)
    np.testing.assert_array_equal(tex.aux_dict['bn_moving_var'].asnumpy(),
                                  np.full((4,), 2.0, np.float32))
    assert tex.aux_dict['bn_moving_var'].dtype == np.float32
    with pytest.raises(MXNetError):
        tex.copy_params_from({'nope': w})
    tex.copy_params_from({'nope': w}, allow_extra_params=True)
    tex.forward()
    assert list(tex.output_dict) == ['softmax_output']
    assert [a.shape for a in tex.arg_arrays][:2] == [(4, 2, 6, 6),
                                                     (4, 2, 3, 3)]
    assert len(tex.grad_arrays) == len(tex.arg_arrays)
    assert len(tex.aux_arrays) == 2


def test_layout_pass_gives_the_same_step():
    jex, tex = _bind_both(seed=12)
    import os
    old = os.environ.get('MXNET_TPU_LAYOUT_OPT')
    os.environ['MXNET_TPU_LAYOUT_OPT'] = '1'
    try:
        nhwc = _convnet(mx).simple_bind(mx.cpu(), **SHAPES)
    finally:
        if old is None:
            del os.environ['MXNET_TPU_LAYOUT_OPT']
        else:
            os.environ['MXNET_TPU_LAYOUT_OPT'] = old
    assert nhwc._layout_opt and not tex._layout_opt
    nhwc.copy_params_from({n: a for n, a in tex.arg_dict.items()},
                          {n: a for n, a in tex.aux_dict.items()})
    for ex in (jex, nhwc):
        ex.forward_backward()
    _assert_state_equal(jex, nhwc)


def test_binding_to_the_gpu_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(MXNetError, match='cuda'):
        _convnet(mx).simple_bind(mx.gpu(0), **SHAPES)
    with pytest.raises(RuntimeError, match='cuda'):
        mx.current_context()


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

def _profile(pkg, ndm, path, mode='symbolic'):
    prof = pkg.profiler
    prof.profiler_set_config(mode=mode, filename=str(path))
    prof.clear()
    ex = _convnet(pkg).simple_bind(pkg.cpu(), **SHAPES)
    ex.copy_params_from(*_params(_convnet(pkg), seed=8))
    prof.profiler_set_state('run')
    try:
        with pkg.cpu():
            ex.forward()
            ex.forward(is_train=True)
            ex.backward()
            ex.forward_backward()
            a = ndm.ones((2, 2))
            (a + a).wait_to_read()
    finally:
        prof.profiler_set_state('stop')
    prof.dump_profile()
    prof.profiler_set_config(filename='profile.json')
    with open(path) as f:
        return json.load(f)


def _layout(trace):
    return (sorted(trace), sorted({tuple(sorted(e)) for e in
                                   trace['traceEvents'] if e['ph'] == 'X'}),
            sorted({tuple(sorted(e)) for e in trace['traceEvents']
                    if e['ph'] == 'M'}))


@pytest.mark.parametrize('mode', ['symbolic', 'all'])
def test_profile_has_the_jax_layout_and_spans(tmp_path, mode):
    ref = _profile(jmx, jnd, tmp_path / 'jax.json', mode)
    got = _profile(mx, nd, tmp_path / 'port.json', mode)
    assert _layout(got) == _layout(ref)
    names = [e['name'] for e in got['traceEvents'] if e['ph'] == 'X']
    ref_names = [e['name'] for e in ref['traceEvents'] if e['ph'] == 'X']
    for span in ('softmax_forward', 'softmax_forward_train',
                 'softmax_backward', 'softmax_forward_backward'):
        assert span in names
    assert sorted(names) == sorted(ref_names)
    assert not profiler.is_running()


def test_profile_device_lanes(tmp_path):
    path = tmp_path / 'lanes.json'
    profiler.profiler_set_config(filename=str(path), profile_xla=True)
    profiler.clear()
    try:
        profiler.profiler_set_state('run')
        with mx.cpu():
            a = nd.ones((8, 8))
            nd.dot(a, a).wait_to_read()
        profiler.profiler_set_state('stop')
        profiler.dump_profile()
    finally:
        profiler.profiler_set_config(filename='profile.json')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    lanes = [e for e in events if e['pid'] >= 100]
    assert any(e['ph'] == 'M' and e['name'] == 'process_name'
               for e in lanes)
    assert any(e['ph'] == 'X' for e in lanes)
    assert (tmp_path / 'lanes_xla' / 'torch_trace.json').exists()
