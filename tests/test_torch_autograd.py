"""Parity of the port's imperative autograd (mxnet_tpu_torch.autograd, on
torch autograd) with the JAX package's tape, on the CPU: the same seeded
numpy inputs through both, gradients at rtol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import nd

PKGS = {'port': (nd, ag), 'jax': (jnd, jag)}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _mlp_inputs(seed=0):
    rs = np.random.RandomState(seed)
    return dict(x=rs.randn(6, 5).astype(np.float32),
                w1=(rs.randn(5, 7) * 0.5).astype(np.float32),
                b1=(rs.randn(7) * 0.1).astype(np.float32),
                w2=(rs.randn(7, 3) * 0.5).astype(np.float32),
                y=rs.randn(6, 3).astype(np.float32))


def _mlp_grads(pkg, inp):
    nd_, ag_ = PKGS[pkg]
    a = {k: nd_.array(v) for k, v in inp.items()}
    for k in ('w1', 'b1', 'w2'):
        a[k].attach_grad()
    with ag_.record():
        h = nd_.relu(nd_.dot(a['x'], a['w1']) + a['b1'])
        out = nd_.tanh(nd_.dot(h, a['w2']))
        loss = nd_.mean(nd_.square(out - a['y']))
    loss.backward()
    return {k: a[k].grad.asnumpy() for k in ('w1', 'b1', 'w2')}, \
        float(loss.asscalar())


def test_mlp_gradients_match_jax():
    inp = _mlp_inputs()
    got, loss = _mlp_grads('port', inp)
    ref, ref_loss = _mlp_grads('jax', inp)
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
        assert np.abs(ref[k]).max() > 0


def _logreg_grads(pkg, xs, labels, w0):
    nd_, ag_ = PKGS[pkg]
    x, y, w = nd_.array(xs), nd_.array(labels), nd_.array(w0)
    w.attach_grad()
    with ag_.record():
        p = nd_.sigmoid(nd_.dot(x, w))
        loss = -(y * nd_.log(p + 1e-7) + (1 - y) * nd_.log(1 - p + 1e-7))
        loss = loss.mean()
    loss.backward()
    return w.grad.asnumpy()


def test_logistic_regression_gradient_matches_jax():
    rs = np.random.RandomState(1)
    xs = rs.randn(64, 10).astype(np.float32)
    labels = (rs.rand(64) < 0.5).astype(np.float32)
    w0 = (rs.randn(10) * 0.3).astype(np.float32)
    np.testing.assert_allclose(_logreg_grads('port', xs, labels, w0),
                               _logreg_grads('jax', xs, labels, w0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('req', ['write', 'add', 'null'])
def test_grad_req_matches_jax(req):
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        x = nd_.array([1.0, 2.0, 3.0])
        x.attach_grad(grad_req=req)
        for scale in (2.0, 5.0):
            with ag_.record():
                y = (x * x * scale).sum()
            y.backward()
        out.append(x.grad.asnumpy())
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL)
    expect = {'write': [10, 20, 30], 'add': [14, 28, 42], 'null': [0, 0, 0]}
    np.testing.assert_allclose(out[0], expect[req])


def test_block_grad_matches_jax():
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        x = nd_.array([1.0, -2.0])
        x.attach_grad()
        with ag_.record():
            y = x * 2 + nd_.BlockGrad(x * 3) * x
        y.backward()
        out.append(x.grad.asnumpy())
    np.testing.assert_allclose(out[0], out[1])
    np.testing.assert_allclose(out[0], [5.0, -4.0])


@pytest.mark.parametrize('scale', [1.0, 0.5])
def test_make_loss_ignores_the_head_gradient(scale):
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        x = nd_.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag_.record():
            y = nd_.make_loss(x * 4, grad_scale=scale)
        y.backward(nd_.array([10.0, 100.0, 1000.0]))
        out.append(x.grad.asnumpy())
    np.testing.assert_allclose(out[0], out[1])
    np.testing.assert_allclose(out[0], [4 * scale] * 3)


def test_head_gradient_reaches_the_variables():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with ag.record():
        y = x * 2
    y.backward(nd.array([10.0, 100.0]))
    np.testing.assert_allclose(x.grad.asnumpy(), [20, 200])


def test_pause_and_predict_mode():
    assert not ag.is_recording() and not ag.is_training()
    x = nd.array([3.0])
    x.attach_grad()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            z = x * 10                       # not recorded: a constant
        with ag.pause(train_mode=True):
            assert ag.is_training()
        y = x * x + z
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert not ag.is_recording() and not ag.is_training()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0])


def test_mark_variables_and_backward_match_jax():
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        x, w = nd_.array([3.0]), nd_.array([4.0])
        ag_.mark_variables([x, w], [nd_.zeros((1,)), nd_.zeros((1,))])
        with ag_.record():
            y = x * w + nd_.exp(w)
        ag_.backward([y])
        out.append((x.grad.asnumpy(), w.grad.asnumpy()))
    for got, ref in zip(*out):
        np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_grad_of_an_unmarked_recorded_input():
    x = nd.array([1.0, 2.0])
    assert ag.grad([(nd.exp(x)).sum()], [x]) == [None]   # not recorded
    x2 = nd.array([1.0, 2.0])
    with ag.record():
        y = nd.tanh(x2)
    g, = ag.grad([y], [x2])
    np.testing.assert_allclose(g.asnumpy(), 1 - np.tanh([1.0, 2.0]) ** 2,
                               rtol=RTOL)


def test_retain_graph_allows_a_second_backward():
    x = nd.array([3.0])
    x.attach_grad()
    with ag.record():
        y = x * x
    y.backward(retain_graph=True)
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0])
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0])


def test_an_earlier_recording_is_a_constant_to_the_next():
    """After a backward the recording ends, as the JAX tape clears: an
    array made in it enters the next recording as a constant."""
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        x = nd_.array([2.0])
        x.attach_grad()
        with ag_.record():
            y = x * x
        y.backward()
        with ag_.record():
            z = y * x
        z.backward()
        out.append(x.grad.asnumpy())
    np.testing.assert_allclose(out[0], out[1])
    np.testing.assert_allclose(out[0], [4.0])


def test_custom_function_matches_jax():
    out = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]

        class Sigmoid(ag_.Function):
            def forward(self, x):
                y = 1 / (1 + nd_.exp(-x))
                self._saved = y
                return y

            def backward(self, dy):
                y = self._saved
                return dy * y * (1 - y) * 3   # a scaled gradient shows

        x = nd_.array([0.0, 1.0, -2.0])
        x.attach_grad()
        with ag_.record():
            y = Sigmoid()(x) * 2
        y.backward()
        out.append((y.asnumpy(), x.grad.asnumpy()))
    for got, ref in zip(*out):
        np.testing.assert_allclose(got, ref, rtol=RTOL)
    s = 1 / (1 + np.exp(-np.array([0.0, 1.0, -2.0])))
    np.testing.assert_allclose(out[0][1], 6 * s * (1 - s), rtol=RTOL)


def test_outside_record_no_graph_is_built():
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 3
    assert not y.handle.requires_grad
    with ag.record():
        z = x * 3
    assert z.handle.requires_grad
    z.backward()
    w = x * 3                       # x is a leaf now; still no graph
    assert not w.handle.requires_grad


# op-table input kinds that are indices, masks or ids: never
# differentiated; ops whose outputs are indices or integers
INDEX_KINDS = {'idx', 'idx_out', 'nd_idx', 'nd_perm', 'mask'}
NOT_DIFFERENTIABLE = {'argmax', 'argmin', 'argmax_channel', 'argsort',
                      'Cast', 'one_hot'}


def _grad_cases():
    from mxnet_tpu_torch.tools import op_consistency as oc
    return sorted(name for name, (kinds, _, _) in oc.CASES.items()
                  if name not in NOT_DIFFERENTIABLE and
                  any(k not in INDEX_KINDS for k in kinds))


@pytest.mark.parametrize('name', _grad_cases())
def test_op_gradient_matches_jax(name):
    """The gradient of every differentiable tensor op, through each
    package's autograd, with seeded head gradients, on the same inputs."""
    from mxnet_tpu_torch.tools import op_consistency as oc
    kinds = oc.CASES[name][0]
    arrays, attrs, _ = oc.case(name, 6)
    grads = []
    for pkg in ('port', 'jax'):
        nd_, ag_ = PKGS[pkg]
        xs = [nd_.array(a) for a in arrays]
        marked = [x for x, k in zip(xs, kinds) if k not in INDEX_KINDS]
        for x in marked:
            x.attach_grad()
        with ag_.record():
            outs = oc.call(nd_, name, xs, attrs)
        rs = np.random.RandomState(5)
        heads = [nd_.array(rs.uniform(0.5, 1.5, o.shape).astype(np.float32)
                           .astype(o.asnumpy().dtype)) for o in outs]
        ag_.backward(outs, heads)
        grads.append([x.grad.asnumpy() for x in marked])
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
