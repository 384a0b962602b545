"""Python custom operators on the port (mxnet_tpu_torch.operator) against
the JAX package's (mxnet_tpu.operator): `Custom` (CustomOp and
CustomOpProp), the legacy `_Native` (NumpyOp) and `_NDArray`
(NDArrayOp), imperative, under autograd, in a bound symbol and in a
Module step, from the same numpy inputs. The cases are those of the
JAX package's tests/test_observability.py (the CustomOp section) and
tests/test_missing_ops.py (the legacy bridges), at their tolerances
(rtol 1e-6 forward, 1e-5 gradients); a Module step against another
program at the JAX tests' step tolerance (rtol 1e-4 / atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

PKGS = {'port': mx, 'jax': jmx}
STEP = dict(rtol=1e-4, atol=1e-5)


def _define(pkg):
    """The tests' custom ops, registered in `pkg`'s prop registry under
    the same names."""
    op_mod = pkg.operator

    class SigmoidOp(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = np.asarray(in_data[0])
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = np.asarray(out_data[0])
            self.assign(in_grad[0], req[0],
                        np.asarray(out_grad[0]) * y * (1.0 - y))

    @op_mod.register('t_sigmoid')
    class SigmoidProp(op_mod.CustomOpProp):
        def __init__(self):
            super(SigmoidProp, self).__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SigmoidOp()

    @op_mod.register('t_concat')
    class ConcatProp(op_mod.CustomOpProp):
        def __init__(self, **kwargs):
            # a symbol of several inputs passes its wiring (num_args)
            super(ConcatProp, self).__init__()

        def list_arguments(self):
            return ['a', 'b']

        def infer_shape(self, in_shape):
            out = list(in_shape[0])
            out[-1] = in_shape[0][-1] + in_shape[1][-1]
            return in_shape, [out], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], np.concatenate(
                        [np.asarray(in_data[0]), np.asarray(in_data[1])],
                        -1))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    g = np.asarray(out_grad[0])
                    k = in_data[0].shape[-1]
                    self.assign(in_grad[0], req[0], g[..., :k])
                    self.assign(in_grad[1], req[1], g[..., k:])
            return Op()

    class SoftmaxLoss(op_mod.CustomOp):
        """examples/numpy_ops/custom_softmax.py's loss head."""

        def forward(self, is_train, req, in_data, out_data, aux):
            z = np.asarray(in_data[0])
            z = z - z.max(axis=1, keepdims=True)
            e = np.exp(z)
            self.assign(out_data[0], req[0], e / e.sum(axis=1,
                                                       keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = np.asarray(out_data[0])
            labels = np.asarray(in_data[1]).astype(int)
            grad = p.copy()
            grad[np.arange(len(labels)), labels] -= 1.0
            self.assign(in_grad[0], req[0], grad / len(labels))

    @op_mod.register('t_softmax_loss')
    class SoftmaxLossProp(op_mod.CustomOpProp):
        def __init__(self, **kwargs):
            super(SoftmaxLossProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SoftmaxLoss()

    @op_mod.register('t_with_aux')
    class AuxProp(SigmoidProp):
        def list_auxiliary_states(self):
            return ['state']

    class HalfOp(op_mod.CustomOp):
        """Outputs in float16 whatever the input (infer_type)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], np.asarray(in_data[0]) * 0.5)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], np.asarray(out_grad[0]) * 0.5)

    @op_mod.register('t_half')
    class HalfProp(op_mod.CustomOpProp):
        def infer_type(self, in_type):
            return in_type, [np.float16], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return HalfOp()

    class Square(op_mod.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = np.asarray(in_data[0]) ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * np.asarray(in_data[0]) * \
                np.asarray(out_grad[0])

    class Neg(op_mod.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = -np.asarray(in_data[0])

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = -np.asarray(out_grad[0])

    class Double(op_mod.CustomOp):
        """Works on whatever host array it gets (a torch tensor for
        bfloat16 on the port, an ml_dtypes array in the JAX package)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            SEEN.append((type(in_data[0]), in_data[0].dtype,
                         type(out_data[0])))
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @op_mod.register('t_double')
    class DoubleProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Double()

    return {'Square': Square, 'Neg': Neg}


SEEN = []
LEGACY = {name: _define(pkg) for name, pkg in PKGS.items()}


def _ctx(pkg):
    return pkg.cpu()


def _both(fn, seen=None):
    """fn(pkg) run by each package (the port inside `with mx.cpu()`);
    `seen` collects what the double op's forward got, per package."""
    SEEN[:] = []
    with mx.cpu():
        port = fn(mx)
    if seen is not None:
        seen.extend(SEEN)
    return port, fn(jmx)


def test_custom_op_imperative():
    x = np.array([[-1.0, 0.0, 2.0]], np.float32)

    def run(pkg):
        return pkg.nd.Custom(pkg.nd.array(x), op_type='t_sigmoid').asnumpy()
    port, ref = _both(run)
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    np.testing.assert_allclose(port, 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_custom_op_autograd():
    x0 = np.array([0.5, -0.5, 1.5], np.float32)

    def run(pkg):
        x = pkg.nd.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            s = pkg.nd.sum(pkg.nd.Custom(x, op_type='t_sigmoid'))
        s.backward()
        return x.grad.asnumpy()
    port, ref = _both(run)
    np.testing.assert_allclose(port, ref, rtol=1e-5)


def test_custom_op_symbolic_training_matches_builtin_sigmoid():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)

    def run(pkg, custom):
        S = pkg.sym
        data = S.Variable('data')
        net = S.Custom(data, op_type='t_sigmoid', name='csig') if custom \
            else S.Activation(data, act_type='sigmoid')
        ex = S.make_loss(S.sum(net)).simple_bind(_ctx(pkg), data=(3, 4))
        ex.arg_dict['data'][:] = x
        ex.forward(is_train=True)
        ex.backward()
        return ex.grad_dict['data'].asnumpy()
    with mx.cpu():
        port, builtin = run(mx, True), run(mx, False)
    ref = run(jmx, True)
    np.testing.assert_allclose(port, builtin, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_custom_op_multi_input_forward_and_backward():
    a0 = np.ones((2, 3), np.float32)
    b0 = np.full((2, 5), 2.0, np.float32)
    w = np.arange(16, dtype=np.float32).reshape(2, 8)

    def run(pkg):
        a, b = pkg.nd.array(a0), pkg.nd.array(b0)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Custom(a, b, op_type='t_concat')
            s = pkg.nd.sum(out * pkg.nd.array(w))
        s.backward()
        return out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()
    port, ref = _both(run)
    assert port[0].shape == (2, 8)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=1e-6)


def test_shape_and_type_inference_go_through_the_prop():
    def run(pkg):
        S = pkg.sym
        cat = S.Custom(S.Variable('a'), S.Variable('b'), op_type='t_concat')
        half = S.Custom(S.Variable('x'), op_type='t_half')
        loss = S.Custom(S.Variable('data'), S.Variable('label'),
                        op_type='t_softmax_loss')
        # (the label's shape is not back-filled from the data's in either
        # package: the prop's infer_shape runs once every input is known)
        aux = S.Custom(S.Variable('x'), op_type='t_with_aux')
        return (cat.infer_shape(a=(2, 3), b=(2, 5)),
                [np.dtype(t).name for t in
                 half.infer_type(x=np.float32)[1]],
                loss.infer_shape(data=(4, 3), label=(4,)),
                loss.list_arguments(),
                aux.list_auxiliary_states())
    port, ref = _both(run)
    assert port[0] == ref[0] and port[0][1] == [(2, 8)]
    # the op's output dtype comes from the prop's infer_type in both
    # packages (test_infer_type_sets_the_output_dtype); the port's symbol
    # inference asks the prop too, where the JAX package's symbol
    # inference gives the input's dtype
    assert port[1] == ['float16'] and ref[1] == ['float32']
    assert port[2] == ref[2] and port[2][0] == [(4, 3), (4,)]
    assert port[3] == ref[3] == ['data', 'label']
    # no auxiliary states: the op takes its prop's arguments only
    assert port[4] == ref[4] == []


def test_infer_type_sets_the_output_dtype():
    x0 = np.array([1.0, -3.0], np.float32)

    def run(pkg):
        out = pkg.nd.Custom(pkg.nd.array(x0), op_type='t_half')
        return np.dtype(out.dtype).name, out.asnumpy()
    port, ref = _both(run)
    assert port[0] == ref[0] == 'float16'
    np.testing.assert_array_equal(port[1], ref[1])


def test_bfloat16_inputs_reach_the_user_as_torch_host_tensors():
    """A bfloat16 input is the torch CPU tensor _hostarray gives (the
    JAX package hands an ml_dtypes array); forward and gradient equal
    the JAX op's in bfloat16."""
    x0 = np.array([1.5, -2.25, 3.0], np.float32)
    seen = []

    def run(pkg):
        x = pkg.nd.array(x0).astype('bfloat16')
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(x, op_type='t_double')
        y.backward(pkg.nd.array(np.full(3, 0.5, np.float32))
                   .astype('bfloat16'))
        return (str(y.dtype), y.asnumpy().astype(np.float32),
                x.grad.asnumpy().astype(np.float32))
    port, ref = _both(run, seen)
    assert seen[0] == (torch.Tensor, torch.bfloat16, torch.Tensor)
    assert 'bfloat16' in port[0] and 'bfloat16' in ref[0]
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[2], ref[2])
    np.testing.assert_array_equal(port[1], x0 * 2)
    np.testing.assert_array_equal(port[2], np.full(3, 1.0))


@pytest.mark.parametrize('kind', ['Square', 'Neg'])
def test_legacy_op_bridge(kind):
    xv = np.array([1.0, -2.0, 3.0], np.float32)

    def run(pkg):
        op = LEGACY['port' if pkg is mx else 'jax'][kind](
            need_top_grad=True)
        net = op.get_symbol(pkg.sym.Variable('x'), name='legacy')
        ex = net.simple_bind(_ctx(pkg), grad_req='write', x=(3,))
        ex.forward(is_train=True, x=xv)
        out = ex.outputs[0].asnumpy()
        ex.backward(out_grads=pkg.nd.array(np.full(3, 0.5, np.float32)))
        return out, ex.grad_dict['x'].asnumpy(), net.list_arguments()
    port, ref = _both(run)
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-6)
    assert port[2] == ref[2] == ['x']
    want = {'Square': (xv ** 2, xv), 'Neg': (-xv, np.full(3, -0.5))}[kind]
    np.testing.assert_allclose(port[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(port[1], want[1], rtol=1e-6)


@pytest.mark.parametrize('name', ['Custom', '_Native', '_NDArray'])
def test_op_is_registered_as_in_the_jax_package(name):
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as reg
    mine, theirs = reg.get(name), jreg.get(name)
    assert mine.name == theirs.name and mine.hint == theirs.hint
    assert mine.mode_dependent and theirs.mode_dependent


def _softmax_module(pkg, custom):
    S = pkg.sym
    net = S.FullyConnected(S.Variable('data'), num_hidden=8, name='fc1')
    net = S.Activation(net, act_type='relu')
    net = S.FullyConnected(net, num_hidden=4, name='fc2')
    if custom:
        net = S.Custom(net, S.Variable('softmax_label'),
                       op_type='t_softmax_loss', name='softmax')
    else:
        # the Custom head's gradient is divided by the batch: 'batch'
        # normalization's
        net = S.SoftmaxOutput(net, name='softmax', normalization='batch')
    mod = pkg.mod.Module(net, context=[_ctx(pkg)])
    mod.bind(data_shapes=[pkg.io.DataDesc('data', (16, 6))],
             label_shapes=[pkg.io.DataDesc('softmax_label', (16,))])
    rs = np.random.RandomState(3)
    shapes = net.infer_shape(data=(16, 6), softmax_label=(16,))[0]
    args = {n: pkg.nd.array((rs.rand(*s).astype(np.float32) - 0.5) * 0.6)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ('data', 'softmax_label')}
    mod.init_params(initializer=None, arg_params=args)
    mod.init_optimizer(optimizer='sgd', optimizer_params={
        'learning_rate': 0.5, 'momentum': 0.9})
    return mod


@pytest.mark.parametrize('head', ['custom', 'softmax_output'])
def test_custom_loss_head_trains_a_module_as_the_jax_package(head):
    """examples/numpy_ops/custom_softmax.py's head in a Module: three
    steps equal the JAX Module's, and the Custom head's equal the
    SoftmaxOutput head's (its backward is the softmax loss gradient over
    the batch)."""
    rs = np.random.RandomState(8)
    X = rs.randn(3, 16, 6).astype(np.float32)
    y = (rs.rand(3, 16) * 4).astype(np.int64).astype(np.float32)

    def run(pkg, custom):
        mod = _softmax_module(pkg, custom)
        outs = []
        for xb, yb in zip(X, y):
            mod.forward_backward(pkg.io.DataBatch(
                data=[pkg.nd.array(xb)], label=[pkg.nd.array(yb)]))
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        return outs, {k: v.asnumpy() for k, v in
                      mod.get_params()[0].items()}
    custom = head == 'custom'
    with mx.cpu():
        port = run(mx, custom)
        builtin = run(mx, False)
    ref = run(jmx, custom)
    for got, want in ((port, ref), (port, builtin)):
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, **STEP)
        for k in want[1]:
            np.testing.assert_allclose(got[1][k], want[1][k], err_msg=k,
                                       **STEP)
