"""The port's Gluon model zoo against the JAX package's, on the CPU, at
the sizes of tests/test_gluon_model_zoo.py: each family built in both
packages under the same prefix, initialized in the JAX package (Xavier),
its parameters carried into the port (`gluon.params_from_jax`), and one
eval forward of the same seeded input in each: the parameter names
equal, the outputs within rtol 1e-4 / atol 1e-5 (deep stacks of
convolutions summed in another order). Then one training step of the
ResNet-18 v1 (test_gluon_model_zoo.py's) against the JAX package's,
get_model's names and errors, and pretrained=True raising.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon

TOL = dict(rtol=1e-4, atol=1e-5)


def _zoo(pkg):
    return pkg.gluon.model_zoo.vision


FAMILIES = {
    'resnet18_v1': (lambda p: _zoo(p).get_resnet(1, 18, classes=10,
                                                 thumbnail=True,
                                                 prefix='r1_'),
                    (1, 3, 32, 32)),
    'resnet18_v2': (lambda p: _zoo(p).get_resnet(2, 18, classes=10,
                                                 thumbnail=True,
                                                 prefix='r2_'),
                    (1, 3, 32, 32)),
    'resnet50_v1': (lambda p: _zoo(p).resnet50_v1(classes=10,
                                                  thumbnail=True,
                                                  prefix='r50_'),
                    (1, 3, 32, 32)),
    'densenet_small': (lambda p: _zoo(p).DenseNet(8, 4, [2, 2], classes=10,
                                                  prefix='d_'),
                       (1, 3, 32, 32)),
    'vgg11': (lambda p: _zoo(p).vgg11(classes=10, prefix='v_'),
              (1, 3, 32, 32)),
    'vgg11_bn': (lambda p: _zoo(p).vgg11_bn(classes=10, prefix='vb_'),
                 (1, 3, 32, 32)),
    'alexnet': (lambda p: _zoo(p).alexnet(classes=10, prefix='a_'),
                (1, 3, 224, 224)),
    'squeezenet1.1': (lambda p: _zoo(p).squeezenet1_1(classes=10,
                                                      prefix='s_'),
                      (1, 3, 64, 64)),
}


def _carry(jnet, tnet):
    tgluon.params_from_jax(
        tnet.collect_params(),
        {n: p.data().asnumpy() for n, p in jnet.collect_params().items()},
        ctx=mx.cpu())


def _built(name):
    make, shape = FAMILIES[name]
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    jnet, tnet = make(jmx), make(mx)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet.initialize(ctx=mx.cpu())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet(mx.nd.array(x, ctx=mx.cpu()))      # the deferred shapes
    _carry(jnet, tnet)
    return jnet, tnet, x, want


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_matches_jax(name):
    jnet, tnet, x, want = _built(name)
    assert sorted(tnet.collect_params().keys()) == \
        sorted(jnet.collect_params().keys())
    got = tnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert got.shape == (x.shape[0], 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_inception_v3_forward_shape():
    """Inception v3 at its 299 input, in the port alone (the JAX forward
    at this size is the slow part); its parameter names are the JAX
    package's."""
    tnet = _zoo(mx).inception_v3(classes=10, prefix='i_')
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    x = np.random.RandomState(0).rand(1, 3, 299, 299).astype(np.float32)
    out = tnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert out.shape == (1, 10) and np.isfinite(out).all()
    jnet = _zoo(jmx).inception_v3(classes=10, prefix='i_')
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())


def test_train_step_matches_jax():
    jnet, tnet, _, _ = _built('resnet18_v1')
    x = np.random.RandomState(1).rand(2, 3, 16, 16).astype(np.float32)
    y = np.array([0, 1], dtype=np.float32)
    out = {}
    for pkg, net, ag in ((jmx, jnet, jag), (mx, tnet, tag)):
        trainer = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                    {'learning_rate': 0.1})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        xs = pkg.nd.array(x, ctx=pkg.cpu())
        ys = pkg.nd.array(y, ctx=pkg.cpu())
        with ag.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(2)
        out[pkg] = (loss.asnumpy(), {n: p.data().asnumpy() for n, p in
                                     net.collect_params().items()})
    np.testing.assert_allclose(out[mx][0], out[jmx][0], **TOL)
    for k, v in out[jmx][1].items():
        np.testing.assert_allclose(out[mx][1][k], v, err_msg=k, **TOL)


def test_get_model_names_and_pretrained():
    with pytest.raises(ValueError):
        _zoo(mx).get_model('no_such_model')
    assert sorted(_zoo(mx)._models) == sorted(_zoo(jmx)._models)
    net = _zoo(mx).get_model('resnet18_v1', classes=4, thumbnail=True)
    net.initialize(ctx=mx.cpu())
    assert net(mx.nd.array(np.random.rand(1, 3, 32, 32).astype(np.float32),
                           ctx=mx.cpu())).shape == (1, 4)
    with pytest.raises(RuntimeError):
        _zoo(mx).resnet18_v1(pretrained=True)
    with pytest.raises(ValueError):
        _zoo(mx).get_resnet(3, 18)
