"""The port's SSD (models/ssd.py over the contrib MultiBox ops) against
the JAX package's, on the CPU.

- SSD300's training and detection symbols: the JAX package's JSON and
  shapes. Its VGG16-reduced pools with floor, so the six maps are 37,
  18, 9, 5, 3 and 1 and SSD300 has 8,096 anchors, in both packages (Liu
  et al.'s 8,732 come from ceil pooling at pool3).
- One train step of a cut SSD (64 x 64 input, widths 8-16, two maps,
  batch 3, seeded weights and boxes) through simple_bind in both
  packages: cls_prob and loc_loss within 1e-5, cls_label (MultiBoxTarget's
  targets) equal, and the gradients held to the JAX package's own spread:
  the median over parameters of the port's relative-norm error within
  twice the JAX package's own under a 2^-22 nudge of the input, plus
  0.005 (tests/test_torch_models.py's rule: the ReLU net's masks flip
  under rounding).
- The cut SSD's detection symbol on the same weights: ids and their order
  equal, scores and boxes within 1e-5.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor

from test_torch_models import _chip_smoke

CHAOS_PERTURBATION = 2.0 ** -22
CHAOS_FACTOR, CHAOS_SLACK = 2.0, 0.005
CUT_SHAPE = (3, 3, 64, 64)
CUT_LABEL = (3, 4, 5)
CUT_CLASSES = 3


def _models(pkg):
    return jmodels if pkg is jmx else mx.models


def _named(pkg, build, *args, **kwargs):
    """build(...) with its automatic names counted from 0 in a name
    manager of its own (as a fresh process counts them)."""
    with pkg.NameManager():
        return build(*args, **kwargs)


def test_ssd300_symbols_match_jax():
    for pkg_kw in (dict(num_classes=20), dict(num_classes=3)):
        t = _named(mx, mx.models.ssd.get_symbol_train, **pkg_kw)
        j = _named(jmx, jmodels.ssd.get_symbol_train, **pkg_kw)
        assert t.tojson() == j.tojson()
        shapes = dict(data=(2, 3, 300, 300), label=(2, 6, 5))
        assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    _, outs, _ = mx.models.ssd.get_symbol_train(num_classes=20).infer_shape(
        data=(1, 3, 300, 300), label=(1, 6, 5))
    maps = (37, 18, 9, 5, 3, 1)
    per_pixel = (4, 6, 6, 6, 4, 4)
    anchors = sum(m * m * a for m, a in zip(maps, per_pixel))
    assert anchors == 8096
    assert outs == [(1, 21, anchors), (1, 4 * anchors), (1, anchors)]
    det = dict(num_classes=20, nms_thresh=0.45, nms_topk=400)
    td = _named(mx, mx.models.ssd.get_symbol, **det)
    assert td.tojson() == _named(jmx, jmodels.ssd.get_symbol, **det).tojson()
    assert td.infer_shape(data=(2, 3, 300, 300))[1] == [(2, anchors, 6)]


def _cut_head(pkg):
    """Two feature maps (16 x 16 and 8 x 8) of a cut VGG-like body."""
    S = pkg.sym

    def conv(x, name, f, stride=1):
        c = S.Convolution(x, kernel=(3, 3), pad=(1, 1), stride=(stride,) * 2,
                          num_filter=f, name=name)
        return S.Activation(c, act_type='relu', name=name + '_relu')
    body = conv(S.Variable('data'), 'conv1', 8)
    body = S.Pooling(body, pool_type='max', kernel=(2, 2), stride=(2, 2),
                     name='pool1')
    body = conv(body, 'conv2', 16)
    f16 = S.Pooling(body, pool_type='max', kernel=(2, 2), stride=(2, 2),
                    name='pool2')
    f8 = conv(f16, 'conv3', 16, stride=2)
    return _models(pkg).ssd.multibox_layer(
        [f16, f8], CUT_CLASSES, sizes=[[.2, .272], [.37, .447]],
        ratios=[[1, 2, .5], [1, 2, .5, 3, 1. / 3]])


def _cut_train(pkg):
    """get_symbol_train's tail over the cut head."""
    S = pkg.sym
    loc_preds, cls_preds, anchors = _cut_head(pkg)
    loc_target, loc_mask, cls_target = S.MultiBoxTarget(
        anchors, S.Variable('label'), cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name='multibox_target')
    cls_prob = S.SoftmaxOutput(cls_preds, cls_target, ignore_label=-1,
                               use_ignore=True, multi_output=True,
                               normalization='valid', name='cls_prob')
    loc_loss_ = S.smooth_l1(loc_mask * (loc_preds - loc_target), scalar=1.0,
                            name='loc_loss_')
    loc_loss = S.MakeLoss(loc_loss_, normalization='valid', name='loc_loss')
    cls_label = S.MakeLoss(cls_target, grad_scale=0, name='cls_label')
    return S.Group([cls_prob, loc_loss, cls_label])


def _cut_detect(pkg):
    S = pkg.sym
    loc_preds, cls_preds, anchors = _cut_head(pkg)
    cls_prob = S.softmax(cls_preds, axis=1, name='cls_prob')
    return S.MultiBoxDetection(cls_prob, loc_preds, anchors,
                               name='detection', nms_threshold=0.45,
                               nms_topk=50, variances=(0.1, 0.1, 0.2, 0.2))


def _seeded(symbol, seed=0):
    """He-normal weights, small biases, images and 1-4 boxes an image."""
    shapes = dict(data=CUT_SHAPE)
    if 'label' in symbol.list_arguments():
        shapes['label'] = CUT_LABEL
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == 'label':
            lab = np.full(shape, -1.0)
            for i in range(shape[0]):
                for j in range(rng.randint(1, shape[1] + 1)):
                    x, y = rng.uniform(0, 0.6, 2)
                    w, h = rng.uniform(0.15, 0.4, 2)
                    lab[i, j] = [rng.randint(0, CUT_CLASSES), x, y, x + w,
                                 y + h]
            args[name] = lab
        elif name.endswith('_weight'):
            fan_in = int(np.prod(shape[1:]))
            args[name] = rng.randn(*shape) * math.sqrt(2.0 / fan_in)
        else:
            args[name] = rng.randn(*shape) * (1.0 if name == 'data' else 0.1)
    return {k: np.asarray(v, np.float32) for k, v in args.items()}


def _grad_req(symbol):
    return {n: 'null' if n in ('data', 'label') else 'write'
            for n in symbol.list_arguments()}


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) /
                 max(np.linalg.norm(ref), 1e-30))


def test_cut_ssd_train_step_matches_jax():
    js, ts = _named(jmx, _cut_train, jmx), _named(mx, _cut_train, mx)
    assert js.tojson() == ts.tojson()
    args = _seeded(js)
    shapes = dict(data=CUT_SHAPE, label=CUT_LABEL)
    jex = js.simple_bind(jmx.cpu(), grad_req=_grad_req(js), **shapes)
    jex.copy_params_from(args, {})
    jex.forward_backward()
    j_outs = [o.asnumpy() for o in jex.outputs]
    j_grads = {n: g.asnumpy() for n, g in jex.grad_dict.items()}
    tex = ts.simple_bind(mx.cpu(), grad_req=_grad_req(ts), **shapes)
    tex.copy_params_from(*executor.params_from_jax(args, {}, mx.cpu()))
    tex.forward_backward()
    t_outs = [o.asnumpy() for o in tex.outputs]
    np.testing.assert_allclose(t_outs[0], j_outs[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_outs[1], j_outs[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_outs[2], j_outs[2])
    assert (j_outs[2] > 0).any(), 'no anchor matched a box'
    t_grads = {n: g.asnumpy() for n, g in tex.grad_dict.items()}
    assert set(t_grads) == set(j_grads)
    nudged = dict(args, data=args['data'] *
                  np.float32(1.0 + CHAOS_PERTURBATION))
    jex.copy_params_from(nudged, {})
    jex.forward_backward()
    own = np.median([_rel(jex.grad_dict[n].asnumpy(), g)
                     for n, g in j_grads.items()])
    port = np.median([_rel(t_grads[n], g) for n, g in j_grads.items()])
    for name, g in t_grads.items():
        assert np.isfinite(g).all(), name
        assert np.abs(g).max() > 0, name
    assert port <= CHAOS_FACTOR * own + CHAOS_SLACK, (port, own)


def test_cut_ssd_detection_matches_jax():
    js, ts = _named(jmx, _cut_detect, jmx), _named(mx, _cut_detect, mx)
    assert js.tojson() == ts.tojson()
    args = _seeded(js, seed=1)
    jex = js.simple_bind(jmx.cpu(), grad_req='null', data=CUT_SHAPE)
    jex.copy_params_from(args, {})
    ref = jex.forward(is_train=False)[0].asnumpy()
    tex = ts.simple_bind(mx.cpu(), grad_req='null', data=CUT_SHAPE)
    tex.copy_params_from(*executor.params_from_jax(args, {}, mx.cpu()))
    got = tex.forward(is_train=False)[0].asnumpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    assert (ref[..., 0] >= 0).sum() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_phase19_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = dict(kernel_launches=dict(conv_bn_stats=0, rtc=0),
               loc_loss_by_epoch=[4.6, 3.2], cls_ce_by_epoch=[4.1, 3.2],
               ops=dict(ok=True), cpu=dict(ok=True),
               detect=dict(finite=True), anchors=8096,
               expected_anchors=8096)
    assert cs.ssd_gate(run) == []

    def bad(**kw):
        return cs.ssd_gate(dict(run, **kw))
    assert bad(kernel_launches=dict(conv_bn_stats=1, rtc=0))
    assert bad(loc_loss_by_epoch=[4.6, float('nan')])
    assert bad(cls_ce_by_epoch=[float('inf'), 3.2])
    assert bad(ops=dict(ok=False))
    assert bad(cpu=dict(ok=False))
    assert bad(detect=dict(finite=False))
    assert bad(anchors=8732)


def test_phase19_op_checks_on_the_cpu_agree_with_themselves():
    """ssd_op_checks' comparison (the card against cpu(0)) passes when
    both sides are the CPU, on a cut head's real outputs."""
    cs = _chip_smoke()
    rng = np.random.RandomState(0)
    from mxnet_tpu_torch.ops import contrib_ops as co
    anchors = torch.tensor(co.multibox_prior(4, 4, (0.3, 0.5), (1, 2),
                                             False, (-1, -1), (0.5, 0.5)))
    a = anchors.shape[1]
    cls_preds = torch.tensor(rng.randn(2, 4, a).astype(np.float32))
    loc_preds = torch.tensor(rng.randn(2, 4 * a).astype(np.float32) * 0.1)
    label = torch.tensor(np.array(
        [[[1, 0.1, 0.1, 0.5, 0.6], [-1] * 5],
         [[0, 0.4, 0.3, 0.9, 0.8], [2, 0.0, 0.5, 0.3, 0.9]]], np.float32))
    out = cs.ssd_op_checks(torch, mx, cls_preds, loc_preds, anchors, label)
    assert out['ok'] and out['positives'] > 0
