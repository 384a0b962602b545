"""The NN ops of the port's second ops slice (mxnet_tpu_torch/ops/nn.py:
LeakyReLU, the softmax family, the regression outputs and
softmax_cross_entropy, Deconvolution, InstanceNorm, L2Normalization, LRN,
Dropout, the sequence ops, UpSampling and Crop) against the JAX
package's registry, on the CPU.

Each op runs in both packages on the same seeded float32 inputs in every
mode the JAX op has, forward and backward (the gradient of the outputs
against seeded cotangents, for every input), at rtol 1e-5 / atol 1e-6
as tests/test_torch_executor.py holds the first slice's ops; then the
registration (names, aliases, aux, outputs), symbolic shape inference
against the JAX symbol's, and Dropout, whose mask the two packages draw
from different generators: the identity when not training, and in
training a mask from the op context's generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as reg

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _run_jax(name, attrs, inputs, is_train, cots):
    op = jreg.get(name)
    ctx = jreg.OpContext(is_train=is_train)

    def f(*xs):
        outs, _ = op.apply(attrs, list(xs), [], ctx)
        return tuple(outs)

    outs, vjp = jax.vjp(f, *[jnp.asarray(x) for x in inputs])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run_port(name, attrs, inputs, is_train, cots):
    op = reg.get(name)
    ctx = reg.OpContext(is_train=is_train, device=torch.device('cpu'))
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs, _ = op.apply(attrs, xs, [], ctx)
    live = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
            if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in live], xs,
                                [c for _, c in live], allow_unused=True)
    grads = [np.zeros_like(x) if g is None else g.numpy()
             for x, g in zip(inputs, grads)]
    return [o.detach().numpy() for o in outs], grads


def _check_op(name, attrs, inputs, is_train=False, seed=1):
    op = jreg.get(name)
    ctx = jreg.OpContext(is_train=is_train)
    outs, _ = jax.eval_shape(
        lambda xs: op.apply(attrs, list(xs), [], ctx),
        [jnp.asarray(x) for x in inputs])
    rng = np.random.RandomState(seed)
    cots = [_rand(rng, o.shape) for o in outs]
    ref = _run_jax(name, attrs, inputs, is_train, cots)
    got = _run_port(name, attrs, inputs, is_train, cots)
    for kind, mine, theirs in zip(('output', 'gradient'), got, ref):
        assert len(mine) == len(theirs), kind
        for i, (m, t) in enumerate(zip(mine, theirs)):
            assert m.shape == t.shape, (kind, i, m.shape, t.shape)
            np.testing.assert_allclose(m, t, err_msg='%s %d' % (kind, i),
                                       **TOL)


def _away_from_zero(a, gap=0.05):
    """No element within `gap` of 0 (a kink of relu-like ops)."""
    return np.where(np.abs(a) < gap, np.sign(a) * gap + a, a) \
        .astype(np.float32)


def _lengths(rng, t, b):
    return rng.randint(1, t + 1, size=(b,)).astype(np.float32)


def _case(name):
    rng = np.random.RandomState(0)
    x4 = _rand(rng, (2, 3, 5, 4))
    seq = _rand(rng, (6, 3, 4))
    table = {
        'leaky': ('LeakyReLU', dict(act_type='leaky', slope=0.1),
                  [_away_from_zero(x4)]),
        'leaky_default': ('LeakyReLU', {}, [_away_from_zero(x4)]),
        'elu': ('LeakyReLU', dict(act_type='elu', slope=0.3),
                [_away_from_zero(x4)]),
        'prelu': ('LeakyReLU', dict(act_type='prelu'),
                  [_away_from_zero(x4), _rand(rng, (3,), 0.2)]),
        'rrelu': ('LeakyReLU', dict(act_type='rrelu', lower_bound=0.1,
                                    upper_bound=0.3),
                  [_away_from_zero(x4)]),
        'softmax': ('softmax', {}, [x4]),
        'softmax_axis1_temp': ('softmax', dict(axis=1, temperature=2.0),
                               [x4]),
        'log_softmax': ('log_softmax', {}, [x4]),
        'log_softmax_axis0': ('log_softmax', dict(axis=0), [x4]),
        'softmax_act_instance': ('SoftmaxActivation', {}, [x4]),
        'softmax_act_channel': ('SoftmaxActivation', dict(mode='channel'),
                                [x4]),
        'linear_regression': ('LinearRegressionOutput',
                              dict(grad_scale=0.5),
                              [_rand(rng, (4, 3)), _rand(rng, (4, 3))]),
        'logistic_regression': ('LogisticRegressionOutput', {},
                                [_rand(rng, (4, 3)), _rand(rng, (4, 3))]),
        'mae_regression': ('MAERegressionOutput', dict(grad_scale=2.0),
                           [_rand(rng, (4, 3)), _rand(rng, (4, 3))]),
        'regression_label_1d': ('LinearRegressionOutput', {},
                                [_rand(rng, (5, 1)), _rand(rng, (5,))]),
        'softmax_cross_entropy': (
            'softmax_cross_entropy', {},
            [_rand(rng, (4, 5)),
             rng.randint(0, 5, (4,)).astype(np.float32)]),
        'deconv_2d': ('Deconvolution',
                      dict(kernel=(3, 3), num_filter=4, stride=(2, 2),
                           pad=(1, 1), adj=(1, 1)),
                      [_rand(rng, (2, 3, 5, 4)), _rand(rng, (3, 4, 3, 3), .3),
                       _rand(rng, (4,), .1)]),
        'deconv_groups': ('Deconvolution',
                          dict(kernel=(2, 2), num_filter=4, num_group=2,
                               stride=(2, 2), no_bias=True),
                          [_rand(rng, (2, 4, 3, 3)),
                           _rand(rng, (4, 2, 2, 2), .3)]),
        'deconv_1d': ('Deconvolution',
                      dict(kernel=(3,), num_filter=2, stride=(2,), pad=(1,)),
                      [_rand(rng, (2, 3, 7)), _rand(rng, (3, 2, 3), .3),
                       _rand(rng, (2,), .1)]),
        'instance_norm': ('InstanceNorm', dict(eps=1e-5),
                          [x4, _rand(rng, (3,), .1, 1.0),
                           _rand(rng, (3,), .1)]),
        'instance_norm_3d': ('InstanceNorm', {},
                             [_rand(rng, (2, 3, 7)),
                              _rand(rng, (3,), .1, 1.0),
                              _rand(rng, (3,), .1)]),
        'l2norm_instance': ('L2Normalization', {}, [x4]),
        'l2norm_channel': ('L2Normalization', dict(mode='channel'), [x4]),
        'l2norm_spatial': ('L2Normalization', dict(mode='spatial'), [x4]),
        'lrn_odd': ('LRN', dict(nsize=3, alpha=0.01, beta=0.75, knorm=2.0),
                    [_rand(rng, (2, 5, 4, 3))]),
        'lrn_even': ('LRN', dict(nsize=4), [_rand(rng, (2, 6, 3, 3))]),
        'dropout_eval': ('Dropout', dict(p=0.5), [x4]),
        'dropout_p0_train': ('Dropout', dict(p=0.0), [x4]),
        'sequence_last': ('SequenceLast', {}, [seq]),
        'sequence_last_len': ('SequenceLast',
                              dict(use_sequence_length=True),
                              [seq, _lengths(rng, 6, 3)]),
        'sequence_mask': ('SequenceMask', {}, [seq]),
        'sequence_mask_len': ('SequenceMask',
                              dict(use_sequence_length=True, value=-1.5),
                              [seq, _lengths(rng, 6, 3)]),
        'sequence_reverse': ('SequenceReverse', {}, [seq]),
        'sequence_reverse_len': ('SequenceReverse',
                                 dict(use_sequence_length=True),
                                 [seq, _lengths(rng, 6, 3)]),
        'upsampling_nearest': ('UpSampling', dict(scale=2), [x4]),
        'upsampling_nearest_2args': (
            'UpSampling', dict(scale=3, num_args=2),
            [x4, _rand(rng, (2, 2, 5, 4))]),
        'upsampling_bilinear': ('UpSampling',
                                dict(scale=2, sample_type='bilinear',
                                     num_filter=3),
                                [x4, _rand(rng, (3, 1, 4, 4))]),
        'crop_hw': ('Crop', dict(h_w=(3, 2), offset=(1, 1)), [x4]),
        'crop_center': ('Crop', dict(h_w=(3, 2), center_crop=True), [x4]),
        'crop_like': ('Crop', dict(num_args=2),
                      [x4, _rand(rng, (2, 1, 2, 3))]),
    }
    return table[name]


CASES = ['leaky', 'leaky_default', 'elu', 'prelu', 'rrelu', 'softmax',
         'softmax_axis1_temp', 'log_softmax', 'log_softmax_axis0',
         'softmax_act_instance', 'softmax_act_channel', 'linear_regression',
         'logistic_regression', 'mae_regression', 'regression_label_1d',
         'softmax_cross_entropy', 'deconv_2d', 'deconv_groups', 'deconv_1d',
         'instance_norm', 'instance_norm_3d', 'l2norm_instance',
         'l2norm_channel', 'l2norm_spatial', 'lrn_odd', 'lrn_even',
         'dropout_eval', 'dropout_p0_train', 'sequence_last',
         'sequence_last_len', 'sequence_mask', 'sequence_mask_len',
         'sequence_reverse', 'sequence_reverse_len', 'upsampling_nearest',
         'upsampling_nearest_2args', 'upsampling_bilinear', 'crop_hw',
         'crop_center', 'crop_like']


@pytest.mark.parametrize('case', CASES)
def test_op_matches_jax(case):
    name, attrs, inputs = _case(case)
    _check_op(name, attrs, inputs, is_train=case.endswith('_train'))


NEW_OPS = ['LeakyReLU', 'softmax', 'log_softmax', 'SoftmaxActivation',
           'LinearRegressionOutput', 'LogisticRegressionOutput',
           'MAERegressionOutput', 'softmax_cross_entropy', 'Deconvolution',
           'InstanceNorm', 'L2Normalization', 'LRN', 'Dropout',
           'SequenceLast', 'SequenceMask', 'SequenceReverse', 'UpSampling',
           'Crop']

ATTR_VARIANTS = [{}, {'act_type': 'prelu', 'use_sequence_length': True,
                      'num_args': 2, 'no_bias': True},
                 {'sample_type': 'bilinear', 'num_args': 1}]


@pytest.mark.parametrize('name', NEW_OPS)
def test_op_registers_as_its_jax_namesake(name):
    mine, theirs = reg.get(name), jreg.get(name)
    for attr in ('num_aux', 'hint', 'mutable_aux', 'shape_rule',
                 'needs_rng'):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    for attrs in ATTR_VARIANTS:
        for method in ('input_names', 'arg_names', 'aux_names',
                       'num_outputs', 'output_names'):
            assert getattr(mine, method)(attrs) == \
                getattr(theirs, method)(attrs), (method, attrs)
    aliases = sorted(a for a, n in reg._OP_ALIASES.items() if n == name)
    assert aliases == sorted(a for a, n in jreg._OP_ALIASES.items()
                             if n == name)


def _shape_net(pkg, case):
    s = pkg.sym
    data = s.Variable('data')
    if case == 'prelu':
        return s.LeakyReLU(data, act_type='prelu', name='p'), (2, 3, 4, 4)
    if case == 'deconv':
        return s.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                               pad=(1, 1), num_filter=5, name='d'), \
            (2, 3, 6, 6)
    if case == 'instance_norm':
        return s.InstanceNorm(data, name='i'), (2, 3, 4, 4)
    if case == 'bilinear':
        return s.UpSampling(data, scale=2, sample_type='bilinear',
                            num_filter=3, name='u'), (2, 3, 4, 4)
    if case == 'regression':
        return s.LinearRegressionOutput(data, name='lro'), (4, 3)
    if case == 'sequence':
        return s.SequenceLast(s.SequenceMask(
            data, use_sequence_length=True, name='m'),
            use_sequence_length=True, name='l'), (5, 2, 3)
    if case == 'crop':
        return s.Crop(data, h_w=(2, 3), name='c'), (2, 3, 5, 6)
    raise KeyError(case)


# shapes neither package infers from the data's (the sequence lengths),
# or the JAX package does not (the bilinear form's weight, which its
# compute never reads): the case gives them
EXTRA_SHAPES = {'bilinear': dict(u_weight=(3, 1, 4, 4)),
                'sequence': dict(m_sequence_length=(2,),
                                 l_sequence_length=(2,))}


@pytest.mark.parametrize('case', ['prelu', 'deconv', 'instance_norm',
                                  'bilinear', 'regression', 'sequence',
                                  'crop'])
def test_symbolic_shape_inference_matches_jax(case):
    mine, shape = _shape_net(mx, case)
    theirs, _ = _shape_net(jmx, case)
    extra = EXTRA_SHAPES.get(case, {})
    assert mine.list_arguments() == theirs.list_arguments()
    assert mine.infer_shape(data=shape, **extra) == \
        theirs.infer_shape(data=shape, **extra)


def test_bilinear_upsampling_weight_takes_the_reference_shape():
    net, shape = _shape_net(mx, 'bilinear')
    arg_shapes, out_shapes, _ = net.infer_shape(data=shape)
    assert arg_shapes[1] == EXTRA_SHAPES['bilinear']['u_weight']
    assert out_shapes == [(2, 3, 8, 8)]


def test_dropout_draws_from_the_op_context_generator():
    x = torch.ones(64, 128)
    op = reg.get('Dropout')

    def run(seed, is_train=True, mode='training'):
        g = torch.Generator().manual_seed(seed)
        ctx = reg.OpContext(is_train=is_train, rng=g,
                            device=torch.device('cpu'))
        return op.apply(dict(p=0.25, mode=mode), [x], [], ctx)[0][0]

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(run(3, is_train=False), x)
    assert not torch.equal(run(3, is_train=False, mode='always'), x)


def test_dropout_in_an_executor_is_the_identity_in_eval():
    data = mx.sym.Variable('data')
    net = mx.sym.Dropout(mx.sym.FullyConnected(data, num_hidden=4,
                                               name='fc'), p=0.5)
    ex = net.simple_bind(mx.cpu(), grad_req='null', data=(3, 5))
    rng = np.random.RandomState(2)
    ex.copy_params_from({'fc_weight': rng.randn(4, 5).astype(np.float32),
                         'fc_bias': np.zeros(4, np.float32)})
    x = rng.randn(3, 5).astype(np.float32)
    out = ex.forward(data=x)[0].asnumpy()
    ref = x @ ex.arg_dict['fc_weight'].asnumpy().T
    np.testing.assert_allclose(out, ref, **TOL)
    train = ex.forward(is_train=True, data=x)[0].asnumpy()
    assert ((train == 0) | np.isclose(train, 2 * ref, **TOL)).all()
