"""The port's pure-Python remainder against the JAX package: `contrib`
(mx.contrib.nd / .sym / .autograd), `visualization` (print_summary's
text string-equal, plot_network's graph), `test_utils` (the oracles and
check_consistency), `executor_manager`, `log` and `registry`. The cases
follow the JAX package's tests/test_contrib.py, test_observability.py,
test_operator_extra.py, test_executor.py and test_op_conformance.py, at
their tolerances.
"""
import contextlib
import io
import logging
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import test_utils as tu


def _both(fn):
    # each package names unnamed ops from a fresh counter, so that the
    # symbols other tests of the process made leave the names alike
    with mx.cpu(), mx.NameManager():
        port = fn(mx)
    with jmx.NameManager():
        return port, fn(jmx)


# -- contrib -----------------------------------------------------------------

def test_contrib_namespaces_list_the_jax_packages_ops():
    for sub in ('ndarray', 'symbol'):
        mine = sorted(n for n in vars(getattr(mx.contrib, sub))
                      if not n.startswith('_'))
        theirs = sorted(n for n in vars(getattr(jmx.contrib, sub))
                        if not n.startswith('_'))
        assert mine == theirs
    assert mx.contrib.nd is mx.contrib.ndarray
    assert mx.contrib.sym is mx.contrib.symbol
    assert mx.contrib.nd.fft is mx.nd.fft
    assert mx.contrib.sym.MultiBoxPrior is mx.sym.MultiBoxPrior


@pytest.mark.parametrize('case', ['fft_ifft', 'count_sketch', 'quantize',
                                  'multibox_prior'])
def test_contrib_nd_ops_match_the_jax_package(case):
    rs = np.random.RandomState(0)

    def run(pkg):
        c = pkg.contrib.nd
        if case == 'fft_ifft':
            x = pkg.nd.array(rs.rand(2, 8).astype(np.float32))
            y = c.fft(x)
            return [y.asnumpy(), c.ifft(y).asnumpy()]
        if case == 'count_sketch':
            x = pkg.nd.array(np.arange(12, dtype=np.float32).reshape(2, 6))
            h = pkg.nd.array(np.array([0, 2, 1, 3, 0, 2], np.float32))
            s = pkg.nd.array(np.array([1, -1, 1, 1, -1, 1], np.float32))
            return [c.count_sketch(x, h, s, out_dim=4).asnumpy()]
        if case == 'quantize':
            x = pkg.nd.array(np.linspace(-1, 1, 10).astype(np.float32))
            q, mn, mx_ = c.quantize(x, pkg.nd.array([-1.0]),
                                    pkg.nd.array([1.0]))
            return [q.asnumpy(), c.dequantize(q, mn, mx_).asnumpy()]
        data = pkg.nd.zeros((1, 3, 4, 4))
        return [c.MultiBoxPrior(data, sizes=(0.5, 0.25),
                                ratios=(1, 2)).asnumpy()]
    rs_state = rs.get_state()
    with mx.cpu():
        port = run(mx)
    rs.set_state(rs_state)
    ref = run(jmx)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_contrib_symbol_compose():
    """The JAX test's SSD head fragment composes and binds on the port."""
    def run(pkg):
        S = pkg.contrib.sym
        anchors = S.MultiBoxPrior(pkg.sym.Variable('data'), sizes=(0.4,),
                                  ratios=(1, 2))
        det = S.MultiBoxDetection(pkg.sym.Variable('cls_prob'),
                                  pkg.sym.Variable('loc_pred'), anchors)
        A = 3 * 3 * 2
        ex = det.simple_bind(pkg.cpu(), data=(1, 8, 3, 3),
                             cls_prob=(1, 2, A), loc_pred=(1, A * 4),
                             grad_req='null')
        return ex.forward(is_train=False)[0].asnumpy()
    port, ref = _both(run)
    assert port.shape == ref.shape == (1, 18, 6)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_contrib_autograd_legacy_interface():
    x0 = np.array([1.0, -2.0, 3.0], np.float32)

    def run(pkg):
        ag = pkg.contrib.autograd
        x = pkg.nd.array(x0)
        ag.mark_variables([x], [pkg.nd.zeros((3,))])
        with ag.train_section():
            y = x * x
            assert ag.is_recording()
        ag.compute_gradient([y])
        prev = ag.set_is_training(True)
        back = ag.set_is_training(prev)
        with ag.test_section():
            rec = ag.is_recording()
        return x.grad.asnumpy(), back, rec
    port, ref = _both(run)
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(port[0], 2 * x0)
    assert port[1:] == ref[1:]


# -- visualization -----------------------------------------------------------

def _mlp(pkg):
    S = pkg.sym
    x = S.FullyConnected(S.Variable('data'), num_hidden=8, name='fc1')
    x = S.Activation(x, act_type='relu', name='relu1')
    x = S.FullyConnected(x, num_hidden=2, name='fc2')
    return S.SoftmaxOutput(x, name='softmax')


def _convnet(pkg):
    S = pkg.sym
    x = S.Convolution(S.Variable('data'), num_filter=8, kernel=(3, 3),
                      pad=(1, 1), name='c1')
    x = S.BatchNorm(x, name='bn1')
    # named: the automatic names count the process's earlier symbols
    x = S.Activation(x, act_type='relu', name='relu1')
    x = S.Pooling(x, global_pool=True, pool_type='avg', kernel=(1, 1),
                  name='pool1')
    x = S.FullyConnected(S.Flatten(x, name='flat'), num_hidden=3, name='fc')
    return S.SoftmaxOutput(x, name='softmax')


NETS = {'mlp': (_mlp, {'data': (4, 10)}),
        'convnet': (_convnet, {'data': (2, 3, 8, 8)}),
        'mlp_no_shape': (_mlp, None)}


@pytest.mark.parametrize('name', sorted(NETS))
def test_print_summary_prints_the_jax_packages_text(name):
    build, shape = NETS[name]

    def run(pkg):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = pkg.viz.print_summary(build(pkg), shape=shape)
        return total, buf.getvalue()
    port, ref = _both(run)
    assert port == ref
    if name == 'mlp':
        assert port[0] == 10 * 8 + 8 + 8 * 2 + 2
        assert 'fc1' in port[1] and 'softmax' in port[1]


def test_print_summary_of_the_resnet_factory_matches():
    def run(pkg):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = pkg.viz.print_summary(
                pkg.models.resnet.get_symbol(10, 18, '3,32,32')
                if pkg is mx else
                __import__('mxnet_tpu.models.resnet', fromlist=['x'])
                .get_symbol(10, 18, '3,32,32'),
                shape={'data': (2, 3, 32, 32)}, line_length=100)
        return total, buf.getvalue()
    port, ref = _both(run)
    assert port == ref


def test_plot_network_builds_the_jax_packages_graph():
    def run(pkg):
        return pkg.viz.plot_network(_convnet(pkg), title='net',
                                    shape={'data': (2, 3, 8, 8)}).source
    port, ref = _both(run)
    assert port == ref
    assert 'c1' in port and 'fc' in port


def test_plot_network_without_graphviz_raises_as_the_jax_package(
        monkeypatch):
    monkeypatch.setitem(sys.modules, 'graphviz', None)
    errors = []
    for pkg in (mx, jmx):
        with pytest.raises(ImportError) as e:
            pkg.viz.plot_network(_mlp(pkg))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert 'print_summary' in errors[0]


# -- test_utils --------------------------------------------------------------

def test_default_context_reads_mxnet_test_device(monkeypatch):
    monkeypatch.delenv('MXNET_TEST_DEVICE', raising=False)
    with mx.cpu(1):
        assert tu.default_context() == mx.cpu(1)
    monkeypatch.setenv('MXNET_TEST_DEVICE', 'gpu:1')
    ctx = tu.default_context()
    assert (ctx.device_type, ctx.device_id) == ('gpu', 1)
    monkeypatch.setenv('MXNET_TEST_DEVICE', 'cpu')
    assert tu.default_context() == mx.cpu(0)


def test_random_helpers_follow_numpys_stream():
    outs = []
    for mod in (tu, jmx.test_utils):
        np.random.seed(4)
        outs.append((mod.rand_shape_nd(3, 5), mod.rand_shape_2d(),
                     mod.random_arrays((2, 3), (4,))))
    assert outs[0][:2] == outs[1][:2]
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_array_equal(a, b)
    with mx.cpu():
        a = tu.rand_ndarray((3, 4))
    assert a.shape == (3, 4) and np.abs(a.asnumpy()).max() <= 1.0


def test_assert_almost_equal_reports_violation():
    with pytest.raises(AssertionError, match='position'):
        tu.assert_almost_equal(np.array([1.0, 2.0]), np.array([1.0, 3.0]),
                               rtol=1e-3)
    tu.assert_almost_equal(mx.nd.array([1.0], ctx=mx.cpu()),
                           np.array([1.0 + 1e-7]), rtol=1e-5)
    assert tu.same([1, 2], np.array([1, 2]))
    assert tu.almost_equal([1.0], [1.0 + 1e-7])


def _fc_location(seed=0):
    rs = np.random.RandomState(seed)
    return {'data': rs.rand(4, 5).astype(np.float32),
            'fc_weight': rs.rand(3, 5).astype(np.float32),
            'fc_bias': rs.rand(3).astype(np.float32)}


def test_numeric_grad_matches_the_jax_package():
    loc = _fc_location()

    def run(pkg):
        fc = pkg.sym.FullyConnected(pkg.sym.Variable('data'), name='fc',
                                    num_hidden=3)
        ex = fc.bind(pkg.cpu(), {k: pkg.nd.array(v) for k, v in
                                 loc.items()}, grad_req='null')
        return pkg.test_utils.numeric_grad(
            ex, {'fc_bias': pkg.nd.array(loc['fc_bias'])}, eps=1e-3)
    port, ref = _both(run)
    np.testing.assert_allclose(port['fc_bias'], ref['fc_bias'], rtol=1e-3)
    np.testing.assert_allclose(port['fc_bias'], np.full(3, 4.0), rtol=1e-3)


def test_check_numeric_gradient_fc():
    fc = mx.sym.FullyConnected(mx.sym.Variable('data'), name='fc',
                               num_hidden=3)
    tu.check_numeric_gradient(fc, _fc_location(), rtol=1e-2, atol=1e-2,
                              ctx=mx.cpu())


def test_check_numeric_gradient_catches_a_wrong_gradient():
    """A symbol whose backward is off (BlockGrad cuts it) fails the
    finite-difference oracle."""
    x = mx.sym.Variable('data')
    net = mx.sym.BlockGrad(x) * x
    with pytest.raises(AssertionError, match='NUMERICAL_data'):
        tu.check_numeric_gradient(
            net, {'data': np.array([1.0, 2.0], np.float32)}, rtol=1e-2,
            ctx=mx.cpu())


def test_check_symbolic_forward_and_backward_match_the_jax_package():
    loc = _fc_location(1)
    og = np.ones((4, 3), np.float32)
    want_out = loc['data'] @ loc['fc_weight'].T + loc['fc_bias']
    want = {'data': og @ loc['fc_weight'], 'fc_weight': og.T @ loc['data'],
            'fc_bias': og.sum(0)}

    def run(pkg):
        fc = pkg.sym.FullyConnected(pkg.sym.Variable('data'), name='fc',
                                    num_hidden=3)
        out = pkg.test_utils.check_symbolic_forward(
            fc, loc, [want_out], rtol=1e-5, atol=1e-5, ctx=pkg.cpu())
        grads = pkg.test_utils.check_symbolic_backward(
            fc, loc, [og], want, rtol=1e-5, atol=1e-5, ctx=pkg.cpu())
        return out, grads
    port, ref = _both(run)
    np.testing.assert_allclose(port[0][0], ref[0][0], rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(port[1][k], ref[1][k], rtol=1e-6)
    with pytest.raises(AssertionError, match='FORWARD'):
        fc = mx.sym.FullyConnected(mx.sym.Variable('data'), name='fc',
                                   num_hidden=3)
        tu.check_symbolic_forward(fc, loc, [want_out + 1.0], ctx=mx.cpu())


def test_simple_forward():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = tu.simple_forward(mx.sym.relu(mx.sym.Variable('x') - 2.0),
                            ctx=mx.cpu(), x=x)
    np.testing.assert_array_equal(out, np.maximum(x - 2.0, 0.0))


def test_check_consistency_dtype():
    """The JAX test's case on the port: the same symbol twice over the
    CPU, float32 both times."""
    fc = mx.sym.FullyConnected(mx.sym.Variable('data'), name='fc',
                               num_hidden=4)
    ctx = mx.cpu()
    tu.check_consistency(fc, [{'ctx': ctx, 'data': (3, 6)},
                              {'ctx': ctx, 'data': (3, 6),
                               'type_dict': {'data': np.float32}}],
                         rtol=1e-3, atol=1e-3)


def _conv_bn(pkg):
    """A Conv -> BatchNorm pair whose output is weighted by an argument:
    under check_consistency's head of ones BatchNorm's output alone has
    gradients of exactly 0 (it is invariant to its input's shift and
    scale), whose rounding no dtype could match."""
    S = pkg.sym
    x = S.Convolution(S.Variable('data'), num_filter=8, kernel=(3, 3),
                      pad=(1, 1), no_bias=True, name='conv')
    x = S.BatchNorm(x, name='bn', fix_gamma=False)
    return x * S.Variable('head')


def test_check_consistency_bfloat16_against_float32():
    """The Conv -> BatchNorm pair over float32 and bfloat16 (the dtype
    matrix the card's check runs over cpu and gpu): the float32 run is
    the truth and bfloat16 passes at 5e-2 (the JAX package's own
    bfloat16 BatchNorm misses that on its beta gradient, so the JAX side
    runs the float32 pair of its test); the float32 outputs agree with
    the JAX package's, and a tolerance bfloat16 cannot meet fails."""
    def specs(pkg, low):
        return [{'ctx': pkg.cpu(), 'data': (4, 8, 6, 6)},
                {'ctx': pkg.cpu(), 'data': (4, 8, 6, 6),
                 'type_dict': {'data': low, 'conv_weight': low}}]
    with mx.cpu():
        np.random.seed(11)
        port = tu.check_consistency(_conv_bn(mx), specs(mx, 'bfloat16'),
                                    scale=0.5, rtol=5e-2, atol=5e-2)
    np.random.seed(11)
    ref = jmx.test_utils.check_consistency(
        _conv_bn(jmx), specs(jmx, np.float32), scale=0.5, rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-4, atol=1e-4)
    with pytest.raises(AssertionError, match='exceeds tolerance'):
        with mx.cpu():
            np.random.seed(11)
            tu.check_consistency(_conv_bn(mx), specs(mx, 'bfloat16'),
                                 scale=0.5, rtol=1e-3, atol=1e-3)


# -- executor_manager --------------------------------------------------------

def _manager(pkg, ctx):
    net = _mlp(pkg)
    rs = np.random.RandomState(2)
    it = pkg.io.NDArrayIter(rs.rand(8, 10).astype(np.float32),
                            (rs.rand(8) * 2).astype(np.int64)
                            .astype(np.float32), batch_size=8)
    mgr = pkg.executor_manager.DataParallelExecutorManager(
        net, ctx, it, param_names=None)
    return mgr, it


def test_executor_manager_runs_the_jax_managers_step():
    def run(pkg):
        mgr, it = _manager(pkg, [pkg.cpu()])
        rs = np.random.RandomState(6)
        shapes = dict(zip(mgr.param_names, [a.shape for a in
                                            mgr.param_arrays]))
        mgr.set_params({k: pkg.nd.array(rs.rand(*s).astype(np.float32)
                                        - 0.5) for k, s in shapes.items()},
                       {})
        batch = next(iter(it))
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        metric = pkg.metric.Accuracy()
        mgr.update_metric(metric, batch.label)
        args, auxs = {}, {}
        mgr.copy_to(args, auxs)
        return (sorted(mgr.param_names), mgr.aux_names,
                {k: g.asnumpy() for k, g in zip(mgr.param_names,
                                                mgr.grad_arrays)},
                metric.get()[1], sorted(args))
    port, ref = _both(run)
    assert port[0] == ref[0] == ['fc1_bias', 'fc1_weight', 'fc2_bias',
                                 'fc2_weight']
    assert port[1] == ref[1] == []
    for k in ref[2]:
        np.testing.assert_allclose(port[2][k], ref[2][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert port[3] == ref[3]
    assert port[4] == ref[4]


def test_executor_manager_over_several_contexts_names_the_launchers():
    with mx.cpu():
        with pytest.raises(mx.MXNetError, match='torchrun.*launch -n 2'):
            _manager(mx, [mx.cpu(0), mx.cpu(1)])


def test_executor_manager_refuses_duplicated_arguments():
    x = mx.sym.Variable('data')
    net = mx.sym.elemwise_add(mx.sym.FullyConnected(x, num_hidden=2,
                                                    name='fc'),
                              mx.sym.FullyConnected(x, num_hidden=2,
                                                    name='fc'))
    with pytest.raises(ValueError, match='duplicated'):
        mx.executor_manager._check_arguments(net)
    slices = mx.executor_manager._split_input_slice(10, [1, 1, 2])
    assert slices == jmx.executor_manager._split_input_slice(10, [1, 1, 2])


# -- log and registry --------------------------------------------------------

def test_get_logger_formats_as_the_jax_package(tmp_path):
    lines = []
    for pkg, name in ((mx, 'port_log'), (jmx, 'jax_log')):
        path = tmp_path / (name + '.txt')
        logger = pkg.log.get_logger(name, filename=str(path),
                                    level=pkg.log.INFO)
        assert logger is pkg.log.getLogger(name)
        logger.info('hello %d', 3)
        for h in logger.handlers:
            h.flush()
        lines.append(path.read_text().strip())
    heads = [l.split(' ', 1)[0][0] for l in lines]
    assert heads == ['I', 'I']
    assert all(l.endswith('hello 3') for l in lines)
    assert (mx.log.DEBUG, mx.log.WARNING) == (logging.DEBUG,
                                              logging.WARNING)


def test_registry_factories_register_alias_and_create():
    class Base(object):
        pass

    register = mx.registry.register(Base, 'widget')
    alias = mx.registry.alias(Base, 'widget')
    create = mx.registry.create(Base, 'widget')

    @alias('gizmo')
    @register
    class Thing(Base):
        def __init__(self, size=1):
            self.size = size

    assert isinstance(create('thing'), Thing)
    assert create('gizmo', size=3).size == 3
    made = create('thing', size=2)
    assert create(made) is made
    assert sorted(mx.registry.__all__) == sorted(jmx.registry.__all__)
