"""The ops of the port's last registry slice (mxnet_tpu_torch/ops/
extra.py, spatial.py and contrib_ops.py: 50 names with their aliases)
against the JAX package's registry, on the CPU.

Each name of `op_consistency.CONTRIB_NAMES` runs in both packages on the
same seeded inputs at the case table's small size, forward and, for the
inputs the case names, the gradient against the same seeded cotangents
(`tools/op_consistency.py`). Integer and selection results are equal:
MultiBoxTarget's cls_target and loc_mask, MultiBoxDetection's ids in
their order, the batch index of Proposal's rois, ROIPooling's maxima,
the anchors, quantize's codes. Floats hold at rtol 1e-5 / atol 1e-6
(FLOAT), or rtol 1e-4 where the op sums or multiplies matrices (REDUCE:
the linalg family, LSoftmax, fft, the correlations, the deformable
conv): the JAX package's own tests of these ops hold them at 1e-5 and
1e-4. `CONTRIB_VARIANTS` adds MultiBoxTarget with duplicated boxes
(IoU ties) and without hard-negative mining, MultiBoxDetection with
nms_topk=-1, with tied scores and with force_suppress, and
MultiProposal with its scores. Then the registry against the JAX
package's, NMS's early end against the full greedy loop, and symbolic
shape inference of the ops that produce shapes by rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import contrib_ops
from mxnet_tpu_torch.ops import registry as reg
from mxnet_tpu_torch.tools import op_consistency as oc

CASES = oc.CONTRIB_NAMES + tuple(sorted(oc.CONTRIB_VARIANTS))


def _run_jax(op_name, args, auxs, attrs, train, grad):
    op = jreg.get(op_name)
    ctx = jreg.OpContext(is_train=train)
    full = [jnp.asarray(a) for a in args]
    jauxs = [jnp.asarray(a) for a in auxs]

    def f(*xs):
        vals = list(full)
        for i, x in zip(grad, xs):
            vals[i] = x
        outs, new_auxs = op.apply(attrs, vals, jauxs, ctx)
        return tuple(outs), tuple(new_auxs)

    if not grad:
        outs, new_auxs = f()
        return ([np.asarray(o) for o in outs],
                [np.asarray(a) for a in new_auxs], [])
    outs, vjp, new_auxs = jax.vjp(f, *[full[i] for i in grad], has_aux=True)
    cots = oc.contrib_cotangents([o.shape for o in outs])
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cots, outs)))
    return ([np.asarray(o) for o in outs], [np.asarray(a) for a in new_auxs],
            [np.asarray(g) for g in grads])


@pytest.mark.parametrize('name', CASES)
def test_op_matches_jax(name):
    case = oc.contrib_case(name)
    op_name = oc.contrib_op(name)
    op = reg.get(name if name in oc.CONTRIB_NAMES else op_name)
    for k, (args, auxs, attrs) in enumerate(case['calls']):
        ref = _run_jax(op_name, args, auxs, attrs, case['train'],
                       case['grad'])
        got = oc.run_contrib_call(torch, op, args, auxs, attrs,
                                  case['train'], case['grad'], 'cpu')
        why = oc.contrib_mismatch(case, got, ref)
        assert why is None, 'call %d: %s' % (k, why)


def test_registry_is_the_jax_registry_but_queue_a_7():
    """Every JAX op name, the CustomOp ones (operator.py) included: the
    two registries hold the same names; the 50 names of slice 13 each
    under the JAX package's op."""
    import mxnet_tpu_torch.operator  # noqa: F401  (registers Custom)
    theirs = set(jreg.list_ops())
    mine = set(reg.list_ops())
    assert mine == theirs
    assert {'Custom', '_Native', '_NDArray'} <= mine
    for name in oc.CONTRIB_NAMES:
        assert reg.get(name).name == jreg.get(name).name
        assert reg.get(name).num_aux == jreg.get(name).num_aux


def _greedy_nms_reference(boxes, scores, cls_id, valid, thr, force, topk):
    """The JAX package's loop over every box (numpy), for one image."""
    num = len(scores)
    order = np.argsort(-np.where(valid, scores, -np.inf), kind='stable')
    b, c, v = boxes[order], cls_id[order], valid[order].copy()
    if topk > 0:
        v &= np.arange(num) < topk
    iou = contrib_ops.iou_matrix(torch.tensor(b), torch.tensor(b)).numpy()
    keep = v.copy()
    for i in range(num):
        same = (c == c[i]) | force
        sup = keep & v & (np.arange(num) < i) & same & (iou[i] > thr)
        keep[i] = keep[i] and not sup.any()
    out = np.zeros(num, bool)
    out[order] = keep
    return out


@pytest.mark.parametrize('topk', [-1, 7, 400])
@pytest.mark.parametrize('force', [False, True])
def test_nms_early_end_equals_the_full_loop(topk, force):
    """nms_keep's loop over the first min(topk, count(valid)) boxes keeps
    what the JAX package's loop over all boxes keeps, with tied scores,
    invalid boxes among them, and a batch of images whose counts
    differ."""
    rng = np.random.default_rng([topk + 1, int(force)])
    bsz, num = 3, 60
    xy = rng.uniform(0, 0.7, (bsz, num, 2))
    wh = rng.uniform(0.05, 0.4, (bsz, num, 2))
    boxes = np.concatenate([xy, xy + wh], 2).astype(np.float32)
    scores = rng.integers(0, 12, (bsz, num)).astype(np.float32) / 12
    cls_id = rng.integers(0, 3, (bsz, num)).astype(np.float32)
    valid = scores > 0.2
    valid[2] = False
    valid[2, :3] = True
    got = contrib_ops.nms_keep(torch.tensor(boxes), torch.tensor(scores),
                               torch.tensor(cls_id), torch.tensor(valid),
                               0.45, force, topk).numpy()
    for i in range(bsz):
        ref = _greedy_nms_reference(boxes[i], scores[i], cls_id[i],
                                    valid[i], 0.45, force, topk)
        np.testing.assert_array_equal(got[i], ref)


def test_symbolic_shapes_match_jax():
    """Symbols of the shape-producing ops infer the JAX package's shapes."""
    import mxnet_tpu as jmx

    def shapes(pkg, build, **kw):
        s = build(pkg.sym)
        return s.infer_shape(**kw)

    builds = [
        (lambda S: S.MultiBoxTarget(
            S.MultiBoxPrior(S.Variable('data'), sizes=(0.2, 0.3),
                            ratios=(1, 2)),
            S.Variable('label'), S.Variable('cls_pred')),
         dict(data=(2, 8, 5, 6), label=(2, 3, 5), cls_pred=(2, 4, 90))),
        (lambda S: S.MultiBoxDetection(
            S.Variable('cls_prob'), S.Variable('loc_pred'),
            S.Variable('anchor')),
         dict(cls_prob=(2, 4, 30), loc_pred=(2, 120), anchor=(1, 30, 4))),
        (lambda S: S.Proposal(S.Variable('cls_prob'), S.Variable('bbox'),
                              S.Variable('im_info'), rpn_post_nms_top_n=20,
                              scales=(8, 16, 32), output_score=True),
         dict(cls_prob=(2, 18, 5, 6), bbox=(2, 36, 5, 6), im_info=(2, 3))),
        (lambda S: S.ROIPooling(S.Variable('data'), S.Variable('rois'),
                                pooled_size=(3, 2), spatial_scale=0.5),
         dict(data=(1, 4, 9, 9), rois=(5, 5))),
        (lambda S: S.DeformableConvolution(
            S.Variable('data'), S.Variable('offset'), kernel=(3, 3),
            pad=(1, 1), num_filter=6),
         dict(data=(1, 4, 7, 8), offset=(1, 18, 7, 8))),
        (lambda S: S.LSoftmax(S.Variable('data'), num_hidden=7, margin=2),
         dict(data=(5, 3))),
    ]
    for build, kw in builds:
        assert shapes(mx, build, **kw) == shapes(jmx, build, **kw)


def test_quantize_dtype_inference_matches_jax():
    """quantize's ranges stay float32 and its output takes out_type;
    dequantize's output takes its out_type, as in the JAX package."""
    import mxnet_tpu as jmx

    def types(pkg, op, data, **kw):
        S = pkg.sym
        s = getattr(S, op)(S.Variable('data'), S.Variable('lo'),
                           S.Variable('hi'), **kw)
        return s.infer_type(data=data)
    for op, data, kw in (('quantize', np.float32, dict(out_type='int8')),
                         ('quantize', np.float32, dict(out_type='uint8')),
                         ('dequantize', np.uint8, {}),
                         ('dequantize', np.int8, dict(out_type='float32'))):
        assert types(mx, op, data, **kw) == types(jmx, op, data, **kw)
