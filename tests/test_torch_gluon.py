"""The port's Gluon core against the JAX package's, on the CPU.

Each case builds the same block in both packages under the same prefix,
initializes it in the JAX package, carries its parameters across with
`gluon.params_from_jax`, and runs the same seeded numpy inputs:

- every layer of gluon.nn (Dense, the activations, BatchNorm in train
  mode with its moving statistics, LeakyReLU, Embedding, Flatten,
  Dropout at p = 0 and in eval mode, Lambda, HybridLambda, Sequential,
  HybridSequential, and every conv, transposed conv and pooling layer in
  1-D, 2-D and 3-D): the output and the gradient of its sum with
  respect to the input and every parameter within rtol 1e-5 / atol 1e-5
  (test_gluon.py's hybridize bound is 1e-5 / 1e-6; convolutions sum in
  another order, hence the atol); train-mode Dropout by its keep rate;
- the eight losses, with and without sample weights, within 1e-5;
- the Trainer (SGD with momentum and weight decay, Adam) over three
  steps within rtol 1e-4 / atol 1e-5 (test_module.py's bound), its
  learning rate and its states saved by one package and loaded by the
  other;
- hybridize: the hybridized forward and gradients equal to the
  imperative ones bit for bit, its cache keyed by the argument structure
  and train mode, BatchNorm's statistics committed, nested outputs;
- Parameter, Constant, ParameterDict, deferred initialization, cast,
  SymbolBlock, save_params / load_params across the packages, utils;
- what stays deferred raising with its ROADMAP item.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-5)


def _pair(make, prefix, init=None):
    """(jax block, port block) from make(pkg, prefix), the JAX one
    initialized (Xavier unless `init`) and its parameters carried into
    the port's."""
    jblock = make(jmx, prefix)
    tblock = make(mx, prefix)
    jblock.initialize(init or jmx.init.Xavier(), ctx=jmx.cpu())
    tblock.initialize(ctx=mx.cpu())
    return jblock, tblock


def _carry(jblock, tblock):
    arrays = {n: p.data().asnumpy()
              for n, p in jblock.collect_params().items()}
    tgluon.params_from_jax(tblock.collect_params(), arrays, ctx=mx.cpu())


def _run(pkg, block, xs, train=True):
    """The output and the gradients of its sum: {'out', 'in<i>', name}."""
    ag = jag if pkg is jmx else tag
    ctx = pkg.cpu()
    arrays = [pkg.nd.array(x, ctx=ctx) for x in xs]
    for a in arrays:
        a.attach_grad()
    with ag.record(train_mode=train):
        out = block(*arrays)
        loss = pkg.nd.sum(out)
    loss.backward()
    got = {'out': out.asnumpy()}
    for i, a in enumerate(arrays):
        got['in%d' % i] = a.grad.asnumpy()
    for name, p in block.collect_params().items():
        if p.grad_req != 'null':
            got[name] = p.grad().asnumpy()
        else:
            got[name] = p.data().asnumpy()
    return got


def _same(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _layer_cases():
    return {
        'dense': (lambda p, pre: p.gluon.nn.Dense(8, activation='relu',
                                                 prefix=pre), [(2, 5)]),
        'dense_no_flatten': (lambda p, pre: p.gluon.nn.Dense(
            3, flatten=False, use_bias=False, prefix=pre), [(2, 4, 5)]),
        'dense_3d_in': (lambda p, pre: p.gluon.nn.Dense(4, prefix=pre),
                        [(2, 3, 5)]),
        'activation_tanh': (lambda p, pre: p.gluon.nn.Activation(
            'tanh', prefix=pre), [(3, 4)]),
        'activation_softrelu': (lambda p, pre: p.gluon.nn.Activation(
            'softrelu', prefix=pre), [(3, 4)]),
        'leaky_relu': (lambda p, pre: p.gluon.nn.LeakyReLU(
            0.1, prefix=pre), [(3, 4)]),
        'batchnorm': (lambda p, pre: p.gluon.nn.BatchNorm(prefix=pre),
                      [(4, 3, 5, 5)]),
        'batchnorm_axis_last': (lambda p, pre: p.gluon.nn.BatchNorm(
            axis=-1, center=False, prefix=pre), [(4, 5, 3)]),
        'flatten': (lambda p, pre: p.gluon.nn.Flatten(prefix=pre),
                    [(2, 3, 4)]),
        'dropout_p0': (lambda p, pre: p.gluon.nn.Dropout(0.0, prefix=pre),
                       [(3, 4)]),
        'conv1d': (lambda p, pre: p.gluon.nn.Conv1D(
            4, 3, strides=2, padding=1, prefix=pre), [(2, 3, 9)]),
        'conv2d': (lambda p, pre: p.gluon.nn.Conv2D(
            4, 3, padding=1, groups=1, activation='relu', prefix=pre),
                   [(2, 3, 6, 6)]),
        'conv2d_grouped_dilated': (lambda p, pre: p.gluon.nn.Conv2D(
            4, (3, 2), dilation=(2, 1), groups=2, use_bias=False,
            prefix=pre), [(2, 4, 7, 6)]),
        'conv3d': (lambda p, pre: p.gluon.nn.Conv3D(
            2, 2, strides=(1, 2, 1), prefix=pre), [(1, 2, 4, 5, 4)]),
        'conv1d_transpose': (lambda p, pre: p.gluon.nn.Conv1DTranspose(
            3, 3, strides=2, padding=1, output_padding=1, prefix=pre),
                             [(2, 2, 5)]),
        'conv2d_transpose': (lambda p, pre: p.gluon.nn.Conv2DTranspose(
            3, (3, 3), strides=2, prefix=pre), [(2, 2, 4, 4)]),
        'conv3d_transpose': (lambda p, pre: p.gluon.nn.Conv3DTranspose(
            2, 2, strides=2, prefix=pre), [(1, 2, 3, 2, 3)]),
        'maxpool1d': (lambda p, pre: p.gluon.nn.MaxPool1D(3, 2, 1,
                                                          prefix=pre),
                      [(2, 3, 8)]),
        'maxpool2d': (lambda p, pre: p.gluon.nn.MaxPool2D(prefix=pre),
                      [(2, 3, 6, 6)]),
        'maxpool3d': (lambda p, pre: p.gluon.nn.MaxPool3D(prefix=pre),
                      [(1, 2, 4, 4, 4)]),
        'avgpool1d': (lambda p, pre: p.gluon.nn.AvgPool1D(prefix=pre),
                      [(2, 3, 8)]),
        'avgpool2d': (lambda p, pre: p.gluon.nn.AvgPool2D(
            3, 1, 1, prefix=pre), [(2, 3, 5, 5)]),
        'avgpool3d': (lambda p, pre: p.gluon.nn.AvgPool3D(prefix=pre),
                      [(1, 2, 4, 4, 4)]),
        'global_max1d': (lambda p, pre: p.gluon.nn.GlobalMaxPool1D(
            prefix=pre), [(2, 3, 5)]),
        'global_max2d': (lambda p, pre: p.gluon.nn.GlobalMaxPool2D(
            prefix=pre), [(2, 3, 5, 5)]),
        'global_max3d': (lambda p, pre: p.gluon.nn.GlobalMaxPool3D(
            prefix=pre), [(1, 2, 3, 3, 3)]),
        'global_avg1d': (lambda p, pre: p.gluon.nn.GlobalAvgPool1D(
            prefix=pre), [(2, 3, 5)]),
        'global_avg2d': (lambda p, pre: p.gluon.nn.GlobalAvgPool2D(
            prefix=pre), [(2, 3, 5, 5)]),
        'global_avg3d': (lambda p, pre: p.gluon.nn.GlobalAvgPool3D(
            prefix=pre), [(1, 2, 3, 3, 3)]),
        'hybrid_lambda': (lambda p, pre: p.gluon.nn.HybridLambda(
            lambda F, x: F.relu(x) * 2, prefix=pre), [(3, 4)]),
        'hybrid_lambda_name': (lambda p, pre: p.gluon.nn.HybridLambda(
            'tanh', prefix=pre), [(3, 4)]),
        'lambda': (lambda p, pre: p.gluon.nn.Lambda(
            lambda x: p.nd.exp(x), prefix=pre), [(3, 4)]),
        'hybrid_sequential': (_hybrid_seq, [(4, 3, 6, 6)]),
        'sequential': (_seq, [(2, 6)]),
    }


def _hybrid_seq(p, pre):
    net = p.gluon.nn.HybridSequential(prefix=pre)
    with net.name_scope():
        net.add(p.gluon.nn.Conv2D(4, 3, padding=1),
                p.gluon.nn.BatchNorm(), p.gluon.nn.Activation('relu'),
                p.gluon.nn.MaxPool2D(), p.gluon.nn.Flatten(),
                p.gluon.nn.Dense(5))
    return net


def _seq(p, pre):
    net = p.gluon.nn.Sequential(prefix=pre)
    with net.name_scope():
        net.add(p.gluon.nn.Dense(4, activation='sigmoid'),
                p.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize('case', sorted(_layer_cases()))
def test_layer_matches_jax(case):
    make, shapes = _layer_cases()[case]
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    jblock = make(jmx, case + '_')
    tblock = make(mx, case + '_')
    jblock.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tblock.initialize(ctx=mx.cpu())
    # an eval forward completes the deferred shapes and changes no state
    jblock(*[jmx.nd.array(x) for x in xs])
    tblock(*[mx.nd.array(x, ctx=mx.cpu()) for x in xs])
    _carry(jblock, tblock)
    _same(_run(mx, tblock, xs), _run(jmx, jblock, xs))


def test_embedding_matches_jax():
    jblock, tblock = _pair(lambda p, pre: p.gluon.nn.Embedding(
        10, 4, prefix=pre), 'emb_')
    _carry(jblock, tblock)
    idx = np.array([[1, 2], [3, 9]], dtype=np.float32)
    want, got = {}, {}
    for pkg, block, out in ((jmx, jblock, want), (mx, tblock, got)):
        ag = jag if pkg is jmx else tag
        x = pkg.nd.array(idx, ctx=pkg.cpu())
        with ag.record():
            y = block(x)
            loss = pkg.nd.sum(y * y)
        loss.backward()
        out['out'] = y.asnumpy()
        out['grad'] = block.weight.grad().asnumpy()
    _same(got, want)


def test_dropout_eval_is_identity_and_train_keeps_its_rate():
    x = np.ones((200, 100), np.float32)
    drop = tgluon.nn.Dropout(0.3)
    with mx.cpu():
        np.testing.assert_array_equal(drop(mx.nd.array(x)).asnumpy(), x)
        mx.random.seed(0)
        with tag.record():
            y = drop(mx.nd.array(x)).asnumpy()
    kept = (y != 0).mean()
    assert abs(kept - 0.7) < 0.01, kept
    np.testing.assert_allclose(y[y != 0], 1 / 0.7, rtol=1e-6)


def _loss_cases():
    rs = np.random.RandomState(3)
    pred = rs.randn(4, 5).astype(np.float32)
    prob = 1 / (1 + np.exp(-pred))
    idx = rs.randint(0, 5, 4).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[idx.astype(int)]
    binary = rs.randint(0, 2, (4, 5)).astype(np.float32)
    pm1 = binary * 2 - 1
    dist = rs.dirichlet(np.ones(5), 4).astype(np.float32)
    logp = np.log(dist[::-1].copy())
    target = rs.randn(4, 5).astype(np.float32)
    weight = rs.rand(4, 1).astype(np.float32)
    L = lambda p: p.gluon.loss
    return {
        'l2': (lambda p: L(p).L2Loss(), pred, target),
        'l1': (lambda p: L(p).L1Loss(weight=2.0), pred, target),
        'sigmoid_bce': (lambda p: L(p).SigmoidBinaryCrossEntropyLoss(),
                        pred, binary),
        'sigmoid_bce_from_sigmoid': (
            lambda p: L(p).SigmoidBCELoss(from_sigmoid=True), prob, binary),
        'softmax_ce': (lambda p: L(p).SoftmaxCrossEntropyLoss(), pred, idx),
        'softmax_ce_dense': (lambda p: L(p).SoftmaxCELoss(
            sparse_label=False), pred, onehot),
        'softmax_ce_logits': (lambda p: L(p).SoftmaxCrossEntropyLoss(
            from_logits=True), logp, idx),
        'kl_div': (lambda p: L(p).KLDivLoss(), logp, dist),
        'kl_div_softmax': (lambda p: L(p).KLDivLoss(from_logits=False),
                           pred, dist),
        'huber': (lambda p: L(p).HuberLoss(rho=0.5), pred, target),
        'hinge': (lambda p: L(p).HingeLoss(margin=0.5), pred, pm1),
        'weighted_l2': (lambda p: L(p).L2Loss(), pred, target, weight),
    }


@pytest.mark.parametrize('case', sorted(_loss_cases()))
def test_loss_matches_jax(case):
    make, *arrays = _loss_cases()[case]
    want = _run(jmx, make(jmx), arrays)
    got = _run(mx, make(mx), arrays)
    _same(got, want)


# -- Trainer -----------------------------------------------------------------

def _mlp(pkg, prefix='mlp_'):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation='relu'),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Dense(4))
    return net


def _train(pkg, net, steps, optimizer, opt_params, trainer=None):
    ag = jag if pkg is jmx else tag
    ctx = pkg.cpu()
    rs = np.random.RandomState(5)
    if trainer is None:
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(opt_params))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        x = pkg.nd.array(rs.randn(8, 10).astype(np.float32), ctx=ctx)
        y = pkg.nd.array(rs.randint(0, 4, 8).astype(np.float32), ctx=ctx)
        with ag.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(8)
    return trainer


def _values(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize('optimizer,params', [
    ('sgd', dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ('adam', dict(learning_rate=0.01))])
def test_trainer_matches_jax(optimizer, params):
    jnet, tnet = _mlp(jmx), _mlp(mx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet.initialize(ctx=mx.cpu())
    x0 = np.zeros((8, 10), np.float32)
    jnet(jmx.nd.array(x0))
    tnet(mx.nd.array(x0, ctx=mx.cpu()))
    _carry(jnet, tnet)
    jt = _train(jmx, jnet, 3, optimizer, params)
    tt = _train(mx, tnet, 3, optimizer, params)
    _same(_values(tnet), _values(jnet), PARAMS)
    assert tt.learning_rate == jt.learning_rate == params['learning_rate']
    tt.set_learning_rate(0.05)
    assert tt.learning_rate == 0.05
    assert tt._kvstore is None          # one context: no store


def test_trainer_states_load_across_packages(tmp_path):
    """save_states of one package loads in the other: the next steps
    agree as if uninterrupted."""
    opt = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
    jnet, tnet = _mlp(jmx, 'a_'), _mlp(mx, 'a_')
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet.initialize(ctx=mx.cpu())
    x0 = np.zeros((8, 10), np.float32)
    jnet(jmx.nd.array(x0))
    tnet(mx.nd.array(x0, ctx=mx.cpu()))
    _carry(jnet, tnet)
    jt = _train(jmx, jnet, 2, 'sgd', opt)
    tt = _train(mx, tnet, 2, 'sgd', opt)
    jfile, tfile = str(tmp_path / 'j.states'), str(tmp_path / 't.states')
    jpar, tpar = str(tmp_path / 'j.params'), str(tmp_path / 't.params')
    jt.save_states(jfile)
    tt.save_states(tfile)
    jnet.save_params(jpar)
    tnet.save_params(tpar)
    # the port continues from the JAX package's files and vice versa
    tnet2, jnet2 = _mlp(mx, 'a_'), _mlp(jmx, 'a_')
    tnet2.load_params(jpar, ctx=mx.cpu())
    jnet2.load_params(tpar, ctx=jmx.cpu())
    tt2 = tgluon.Trainer(tnet2.collect_params(), 'sgd', dict(opt))
    jt2 = jgluon.Trainer(jnet2.collect_params(), 'sgd', dict(opt))
    tt2.load_states(jfile)
    jt2.load_states(tfile)
    _train(mx, tnet2, 2, None, None, trainer=tt2)
    _train(jmx, jnet2, 2, None, None, trainer=jt2)
    _train(jmx, jnet, 2, None, None, trainer=jt)
    _same(_values(tnet2), _values(jnet), PARAMS)
    _same(_values(jnet2), _values(jnet), PARAMS)


def test_trainer_over_several_contexts_matches_jax():
    """The Trainer's store over cpu(0) and cpu(1) (Queue A item 5): the
    gradients summed over the contexts, the replicas kept equal, against
    the JAX Trainer over the same contexts."""
    rng = np.random.RandomState(12)
    w = rng.randn(3, 2).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    xs = [rng.randn(4, 2).astype(np.float32) for _ in range(2)]
    out = []
    for pkg, gl in ((mx, tgluon), (jmx, jgluon)):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        net = gl.nn.Dense(3, in_units=2)
        net.initialize(ctx=ctxs)
        net.weight.set_data(pkg.nd.array(w, ctx=ctxs[0]))
        net.bias.set_data(pkg.nd.array(b, ctx=ctxs[0]))
        tr = gl.Trainer(net.collect_params(), 'sgd',
                        {'learning_rate': 0.1, 'momentum': 0.9})
        for _ in range(2):
            with pkg.autograd.record():
                losses = [(net(pkg.nd.array(x, ctx=c)) ** 2).sum()
                          for x, c in zip(xs, ctxs)]
            for loss in losses:
                loss.backward()
            tr.step(8)
        assert tr._kvstore is not None
        out.append([[d.asnumpy() for d in p.list_data()]
                    for p in (net.weight, net.bias)])
    for tp, jp in zip(*out):
        np.testing.assert_array_equal(tp[0], tp[1])
        for td, jd in zip(tp, jp):
            np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_trainer_step_fused_raises():
    """step_fused raises until gluon.fuse_step attaches a step; then it
    runs that step, equal to the JAX package's."""
    x = _x(4, 2)
    y = np.array([0, 1, 2, 1], np.float32)
    out = []
    for pkg, g in ((jmx, jgluon), (mx, tgluon)):
        with pkg.cpu():
            net = g.nn.Dense(3, in_units=2)
            net.initialize()
            net.weight.set_data(pkg.nd.array(_x(3, 2, seed=5)))
            tr = g.Trainer(net.collect_params(), 'sgd',
                           {'learning_rate': 0.5})
            with pytest.raises(ValueError, match='no fused step'):
                tr.step_fused(4, pkg.nd.array(x), pkg.nd.array(y))
            g.fuse_step(net, g.loss.SoftmaxCrossEntropyLoss(), tr)
            loss = tr.step_fused(4, pkg.nd.array(x), pkg.nd.array(y))
            out.append((loss.asnumpy(), net.weight.data().asnumpy()))
    for t, j in zip(out[1], out[0]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


# -- hybridize ---------------------------------------------------------------

def _conv_net(pkg, prefix='cnet_'):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1),
                pkg.gluon.nn.BatchNorm(), pkg.gluon.nn.Activation('relu'),
                pkg.gluon.nn.Dropout(0.0), pkg.gluon.nn.Flatten(),
                pkg.gluon.nn.Dense(3))
    return net


def test_hybridized_forward_and_gradients_equal_the_imperative_ones():
    net = _conv_net(mx)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = _x(4, 2, 5, 5)
    net(mx.nd.array(x, ctx=mx.cpu()))
    start = {n: p.data().handle.detach().clone()
             for n, p in net.collect_params().items()}
    runs = {}
    for hybrid in (False, True):
        net.hybridize(hybrid)
        for n, p in net.collect_params().items():
            p.data()._data = start[n].clone()
        eval_out = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
        runs[hybrid] = dict(_run(mx, net, [x]), eval=eval_out)
    for k, v in runs[False].items():
        np.testing.assert_array_equal(runs[True][k], v, err_msg=k)
    # one cache entry per argument structure and train mode
    keys = list(net._cached_fn)
    assert sorted(k[-1] for k in keys) == [False, True]
    net(mx.nd.array(_x(2, 2, 5, 5), ctx=mx.cpu()))
    assert len(net._cached_fn) == 2     # the shape is not in the key
    net.hybridize(False)
    assert net._cached_fn is None


def test_hybridized_matches_jax_and_commits_statistics():
    jnet, tnet = _conv_net(jmx, 'h_'), _conv_net(mx, 'h_')
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet.initialize(ctx=mx.cpu())
    x = _x(4, 2, 5, 5)
    jnet(jmx.nd.array(x))
    tnet(mx.nd.array(x, ctx=mx.cpu()))
    _carry(jnet, tnet)
    jnet.hybridize()
    tnet.hybridize()
    before = tnet[1].running_mean.data().asnumpy().copy()
    _same(_run(mx, tnet, [x]), _run(jmx, jnet, [x]))
    assert not np.allclose(before, tnet[1].running_mean.data().asnumpy())
    # eval mode: the moving statistics, and no update of them
    after = tnet[1].running_mean.data().asnumpy().copy()
    np.testing.assert_allclose(
        tnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
        jnet(jmx.nd.array(x)).asnumpy(), **TOL)
    np.testing.assert_array_equal(tnet[1].running_mean.data().asnumpy(),
                                  after)


def _two_out(pkg):
    class TwoOut(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = pkg.gluon.nn.Dense(3)

        def hybrid_forward(self, F, x, states):
            h = self.fc(x)
            return h, [states[0] + F.sum(h), F.tanh(states[1])]
    return TwoOut(prefix='two_')


def test_hybridized_nested_outputs():
    net = _two_out(mx)
    net.initialize(ctx=mx.cpu())
    x = mx.nd.array(_x(2, 4), ctx=mx.cpu())
    states = [mx.nd.array(_x(1, seed=1), ctx=mx.cpu()),
              mx.nd.array(_x(2, 3, seed=2), ctx=mx.cpu())]
    out_imp, st_imp = net(x, states)
    net.hybridize()
    out_hyb, st_hyb = net(x, states)
    assert isinstance(st_hyb, list) and len(st_hyb) == 2
    np.testing.assert_array_equal(out_imp.asnumpy(), out_hyb.asnumpy())
    for a, b in zip(st_imp, st_hyb):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


# -- parameters, blocks, files, utils ----------------------------------------

def test_parameter_and_dict_basics(tmp_path):
    p = tgluon.Parameter('weight', shape=(4, 3))
    p.initialize(init='xavier', ctx=[mx.cpu(0), mx.cpu(1)])
    assert len(p.list_data()) == 2 and len(p.list_grad()) == 2
    assert p.data(mx.cpu(1)).context == mx.cpu(1)
    assert p.var().name == 'weight'
    p.grad_req = 'null'
    with pytest.raises(RuntimeError):
        p.grad()
    p.grad_req = 'write'
    assert p.grad(mx.cpu(0)).shape == (4, 3)
    deferred = tgluon.Parameter('w', shape=(0, 3), allow_deferred_init=True)
    deferred.initialize(ctx=mx.cpu())
    assert deferred.list_ctx() == [mx.cpu()]
    with pytest.raises(tgluon.DeferredInitializationError):
        deferred.data()
    with pytest.raises(ValueError):
        tgluon.Parameter('v', shape=(0, 3)).initialize(ctx=mx.cpu())
    params = tgluon.ParameterDict('net_')
    params.get('weight', shape=(10, 10))
    assert list(params.keys()) == ['net_weight']
    shared = tgluon.ParameterDict('net_', shared=params)
    assert shared.get('weight') is params['net_weight']
    params.initialize(ctx=mx.cpu())
    fname = str(tmp_path / 'd.params')
    params.save(fname)
    params.load(fname, mx.cpu())
    with mx.cpu():
        c = tgluon.Constant('const', np.array([1., 2., 3.]))
    c.initialize(ctx=mx.cpu())
    np.testing.assert_allclose(c.data().asnumpy(), [1., 2., 3.])
    assert c.grad_req == 'null'


def test_initialize_without_a_ctx_takes_gpu0(monkeypatch):
    p = tgluon.Parameter('w_weight', shape=(2, 2))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        p.initialize()
    with mx.cpu():
        p.initialize()
    assert p.list_ctx() == [mx.cpu()]


def test_save_and_load_params_across_packages(tmp_path):
    jnet, tnet = _conv_net(jmx, 's_'), _conv_net(mx, 's_')
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    x = _x(2, 2, 5, 5)
    jnet(jmx.nd.array(x))
    jfile, tfile = str(tmp_path / 'j.params'), str(tmp_path / 't.params')
    jnet.save_params(jfile)
    tnet.load_params(jfile, ctx=mx.cpu())
    _same(_values(tnet), _values(jnet), dict(rtol=0, atol=0))
    tnet.save_params(tfile)
    with open(jfile, 'rb') as a, open(tfile, 'rb') as b:
        assert a.read() == b.read()
    jnet2 = _conv_net(jmx, 's_')
    jnet2.load_params(tfile, ctx=jmx.cpu())
    _same(_values(jnet2), _values(jnet), dict(rtol=0, atol=0))
    np.testing.assert_allclose(tnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **TOL)
    with pytest.raises(IOError):
        _mlp(mx, 's_').load_params(tfile, ctx=mx.cpu())


def test_cast_and_collect_params():
    net = _conv_net(mx, 'c_')
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(_x(2, 2, 5, 5), ctx=mx.cpu()))
    assert sorted(net.collect_params().keys()) == sorted(
        _conv_net(jmx, 'c_').collect_params().keys())
    net.cast('float64')
    assert all(p.data().dtype == np.float64
               for p in net.collect_params().values())
    out = net(mx.nd.array(_x(2, 2, 5, 5), ctx=mx.cpu(), dtype='float64'))
    assert out.dtype == np.float64


def test_block_attr_replacement_and_naming():
    net = tgluon.nn.HybridSequential()
    net.fc = tgluon.nn.Dense(3)
    net.fc = tgluon.nn.Dense(5)
    assert len(net._children) == 1 and net._children[0]._units == 5
    with pytest.raises(ValueError):
        net.register_child(tgluon.nn.Sequential())
    named = tgluon.nn.Dense(2, prefix='my_')
    assert named.name == 'my' and named.weight.name == 'my_weight'


def test_symbol_block_matches_the_symbol():
    data = mx.sym.Variable('data')
    out = mx.sym.FullyConnected(data, num_hidden=3, name='fc')
    block = tgluon.SymbolBlock(out, data)
    block.collect_params().initialize(ctx=mx.cpu())
    assert sorted(block.collect_params().keys()) == ['fc_bias', 'fc_weight']
    # its shapes come with the values (the JAX package's SymbolBlock
    # infers none either)
    tgluon.params_from_jax(block.collect_params(),
                           {'fc_weight': _x(3, 4), 'fc_bias': _x(3, seed=2)})
    x = _x(2, 4, seed=1)
    got = block(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    want = x @ _x(3, 4).T + _x(3, seed=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_utils_match_jax():
    data = _x(8, 3)
    parts = tgluon.utils.split_and_load(data, [mx.cpu(0), mx.cpu(1)])
    assert [p.shape for p in parts] == [(4, 3), (4, 3)]
    assert parts[1].context == mx.cpu(1)
    uneven = tgluon.utils.split_data(mx.nd.array(_x(7, 2), ctx=mx.cpu()), 3,
                                     even_split=False)
    assert [u.shape[0] for u in uneven] == [2, 2, 3]
    with pytest.raises(ValueError):
        tgluon.utils.split_data(mx.nd.array(_x(7, 2), ctx=mx.cpu()), 3)
    arrays = [_x(3, 4, seed=3) * 5, _x(5, seed=4) * 5]
    t = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
    j = [jmx.nd.array(a) for a in arrays]
    tn = tgluon.utils.clip_global_norm(t, 1.0)
    jn = jgluon.utils.clip_global_norm(j, 1.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)


def test_deferred_parts_raise_naming_their_item():
    # the fused step, its pipelined mode and MoE are ported (item 6d):
    # a pipeline over one context refuses as the JAX package's does, and
    # MoE builds
    assert tgluon.FusedStep.__module__ == 'mxnet_tpu_torch.gluon.fused'
    with mx.cpu():
        net = tgluon.nn.Dense(3, in_units=2)
        net.initialize()
        tr = tgluon.Trainer(net.collect_params(), 'sgd')
    with pytest.raises(ValueError, match='do not divide'):
        tgluon.fuse_step(net, tgluon.loss.L2Loss(), tr, pipeline=(2, 2))
    assert repr(tgluon.nn.MoE(4, 8, 2)) == \
        'MoE(units=4, hidden=8, experts=2, capacity_factor=1)'
    # gluon.rnn: the JAX package's public cells and layers, each a Block
    # of the port's
    names = sorted(n for n in dir(jgluon.rnn) if n[0].isupper())
    assert names == sorted(n for n in dir(tgluon.rnn) if n[0].isupper())
    for name in names:
        assert issubclass(getattr(tgluon.rnn, name), tgluon.Block), name


# -- chip_smoke.py's gate of phase 13 ------------------------------------------

def test_phase13_gate_passes_a_good_run_and_refuses_bad_ones():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    zero = dict(conv_bn_stats=0, flash_fwd=0, flash_bwd_dkdv=0,
                flash_bwd_dq=0)
    run = dict(param_devices=['cuda:0'], param_ctxs=['gpu(0)'],
               kernel_launches=zero, losses=[7.0, 6.4, 5.6, 5.0, 4.5],
               timed_losses=[7.4, 7.4], hybrid_equal=dict(eval=True,
                                                          train=True),
               resume=dict(differ=[], compared=299),
               zoo=[dict(model='vgg11', ok=True)],
               batch_shape=[cs.GLUON_BATCH, 3, cs.GLUON_SIDE, cs.GLUON_SIDE])
    assert cs.gluon_gate(run) == []
    assert cs.gluon_gate(dict(run, param_devices=['cpu']))
    assert any('hand-written' in m for m in cs.gluon_gate(dict(
        run, kernel_launches=dict(zero, conv_bn_stats=1))))
    assert any('loss' in m for m in cs.gluon_gate(dict(
        run, losses=[7.0, 7.1, 7.2, 7.0, 7.3])))
    assert cs.gluon_gate(dict(run, hybrid_equal=dict(eval=True,
                                                     train=False)))
    assert cs.gluon_gate(dict(run, resume=dict(differ=['w'], compared=299)))
    assert cs.gluon_gate(dict(run, zoo=[dict(model='vgg11', ok=False)]))
