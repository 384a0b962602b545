"""Contrib ops: the counterpart of mxnet_tpu/ops/contrib_ops.py over torch
tensors. The SSD MultiBox family (MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection), the RPN's Proposal / MultiProposal, PSROIPooling,
DeformableConvolution and DeformablePSROIPooling, ctc_loss, fft / ifft
(the real and imaginary parts interleaved on the last axis),
count_sketch, and quantize / dequantize, each under its `_contrib_`
alias too.

The values and orders are the JAX package's: stable sorts (ties keep
their index order, as jnp.argsort does), the first maximum where it
takes an argmax, the same -1 and padding sentinels. Where the JAX
package loops over fixed trip counts with masked vector bodies, the port
loops over what the data needs:

- MultiBoxTarget's bipartite matching runs over the padded label count
  for the whole batch at once.
- Greedy NMS (`nms_keep`) keeps the JAX package's rule: a box is kept
  unless a kept box of higher rank (of its class, unless
  force_suppress) overlaps it past the threshold. Only the first
  min(topk, count(valid)) boxes of the score order can be kept or
  suppress, so the overlap matrix is built among those alone, on the
  tensors' device, and the greedy scan runs on the host over its rows.
- PSROIPooling sums each bin from a float64 summed-area table, not a
  masked (rois, bins, channels, H, W) sum.

The outputs stay differentiable where the JAX package's are: the
indices come from the host scan and the device sorts, the values by
gathers. What a discrete choice reads through exp or log (the mining's
background probability, the decoded boxes that NMS compares) is computed
in float64 and rounded to the inputs' dtype: CUDA's exp and the CPU's
differ by an ulp, enough to reorder near-equal keys or flip an overlap
at the threshold, and the rounded values are the same on every device.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register, astuple, asbool, asint, asfloat
from .spatial import exact_div
from ..base import parse_attr_value


def _asfloats(v, default):
    v = parse_attr_value(v) if v is not None else default
    if isinstance(v, (int, float)):
        v = (float(v),)
    return tuple(float(x) for x in v)


def _argsort_desc(score, dim=-1):
    """jnp.argsort(-score): stable, ties in index order."""
    return torch.sort(-score, dim=dim, stable=True).indices


# ---------------------------------------------------------------------------
# MultiBoxPrior (reference contrib/multibox_prior.cc; per pixel, the sizes
# first at ratio 1, then the ratios at sizes[0])
# ---------------------------------------------------------------------------

def multibox_prior(in_h, in_w, sizes, ratios, clip, steps, offsets):
    """The (1, in_h * in_w * A, 4) float32 corner anchors, on the host."""
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    cy = (np.arange(in_h) + offsets[0]) * step_y
    cx = (np.arange(in_w) + offsets[1]) * step_x
    ws, hs = [], []
    for s in sizes:
        ws.append(s / 2.0)
        hs.append(s / 2.0)
    for r in ratios[1:]:
        sr = math.sqrt(r)
        ws.append(sizes[0] * sr / 2.0)
        hs.append(sizes[0] / sr / 2.0)
    ws = np.asarray(ws, np.float32)
    hs = np.asarray(hs, np.float32)
    gy, gx = np.meshgrid(cy, cx, indexing='ij')
    cxg = gx[:, :, None]
    cyg = gy[:, :, None]
    boxes = np.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs],
                     axis=-1).astype(np.float32)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    return boxes


@register('MultiBoxPrior', input_names=('data',),
          aliases=('_contrib_MultiBoxPrior',), hint='multiboxprior')
def _multibox_prior(attrs, data):
    boxes = multibox_prior(
        data.shape[2], data.shape[3], _asfloats(attrs.get('sizes'), (1.0,)),
        _asfloats(attrs.get('ratios'), (1.0,)),
        asbool(attrs.get('clip', False)),
        _asfloats(attrs.get('steps'), (-1.0, -1.0)),
        _asfloats(attrs.get('offsets'), (0.5, 0.5)))
    if data.device.type == 'meta':
        return torch.empty(boxes.shape, dtype=data.dtype, device=data.device)
    return torch.as_tensor(boxes).to(device=data.device, dtype=data.dtype)


# ---------------------------------------------------------------------------
# Box helpers
# ---------------------------------------------------------------------------

def iou_matrix(a, b):
    """a (..., A, 4), b (..., G, 4) corner boxes -> IoU (..., A, G)."""
    ax1, ay1 = a[..., :, 0:1], a[..., :, 1:2]
    ax2, ay2 = a[..., :, 2:3], a[..., :, 3:4]
    bx1, by1 = b[..., None, :, 0], b[..., None, :, 1]
    bx2, by2 = b[..., None, :, 2], b[..., None, :, 3]
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1,
                                                           min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1,
                                                           min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _encode_boxes(anchors, gt, variances):
    """SSD box encoding (reference multibox_target.cc AssignLocTargets);
    anchors (A, 4), gt (..., A, 4)."""
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5

    def safe(x):
        return torch.clamp(x, min=1e-12)
    tx = exact_div((gx - ax) / safe(aw), vx)
    ty = exact_div((gy - ay) / safe(ah), vy)
    tw = exact_div(torch.log(safe(gw / safe(aw))), vw)
    th = exact_div(torch.log(safe(gh / safe(ah))), vh)
    return torch.stack([tx, ty, tw, th], dim=-1)


def _decode_boxes(anchors, deltas, variances, clip):
    """The inverse of _encode_boxes (reference multibox_detection.cc
    TransformLocations); anchors (A, 4), deltas (..., A, 4). Computed in
    float64 and rounded to the deltas' dtype (the module's comment)."""
    dtype = deltas.dtype
    anchors, deltas = anchors.double(), deltas.double()
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    cx = deltas[..., 0] * vx * aw + ax
    cy = deltas[..., 1] * vy * ah + ay
    w = torch.exp(deltas[..., 2] * vw) * aw * 0.5
    h = torch.exp(deltas[..., 3] * vh) * ah * 0.5
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1).to(dtype)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def _take_rows(x, idx):
    """x (B, N, ...) gathered along dim 1 by idx (B, M) -> (B, M, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


# ---------------------------------------------------------------------------
# MultiBoxTarget (reference contrib/multibox_target.cc)
# ---------------------------------------------------------------------------

def multibox_target(anchors, labels, cls_pred, overlap_threshold,
                    ignore_label, neg_ratio, neg_thresh, min_neg, variances):
    """anchors (A, 4), labels (B, G, 5+), cls_pred (B, C, A) -> loc_target
    (B, 4A), loc_mask (B, 4A), cls_target (B, A)."""
    bsz, num_labels = labels.shape[0], labels.shape[1]
    num_anchors = anchors.shape[0]
    dev = anchors.device
    gt_valid = labels[:, :, 0] > -0.5                     # (B, G)
    num_valid = gt_valid.sum(dim=1)
    ious = iou_matrix(anchors, labels[:, :, 1:5])         # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    ious_d = ious.detach()

    # stage 1: bipartite greedy matching, one anchor per gt, the batch at
    # once; the flat argmax takes the first maximum, as jnp.argmax does
    a_matched = torch.zeros((bsz, num_anchors), dtype=torch.bool,
                            device=dev)
    g_matched = torch.zeros((bsz, num_labels), dtype=torch.bool, device=dev)
    match_gt = torch.full((bsz, num_anchors), -1, dtype=torch.long,
                          device=dev)
    rows = torch.arange(bsz, device=dev)
    neg1 = torch.full_like(ious_d, -1.0)
    for _ in range(num_labels):
        m = torch.where(a_matched[:, :, None] | g_matched[:, None, :], neg1,
                        ious_d)
        flat = m.reshape(bsz, -1).argmax(dim=1)
        aj, gk = flat // num_labels, flat % num_labels
        ok = m[rows, aj, gk] > 1e-6
        a_matched[rows, aj] = a_matched[rows, aj] | ok
        g_matched[rows, gk] = g_matched[rows, gk] | ok
        match_gt[rows, aj] = torch.where(ok, gk, match_gt[rows, aj])

    # stage 2: threshold matching for the rest
    best_iou = ious_d.amax(dim=2)
    best_gt = ious_d.argmax(dim=2)
    thresh_pos = (~a_matched) & (best_iou > overlap_threshold) & \
        (overlap_threshold > 0)
    positive = a_matched | thresh_pos
    match_gt = torch.where(a_matched, match_gt, best_gt)
    num_pos = positive.to(torch.int32).sum(dim=1)

    # stage 3: negatives, hard-mined by the background probability
    if neg_ratio > 0:
        prob_bg = torch.softmax(cls_pred.detach().double(), dim=1)[:, 0] \
            .to(cls_pred.dtype)                           # (B, A)
        cand = (~positive) & (best_iou < neg_thresh)
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * neg_ratio).to(torch.int32),
            num_anchors - num_pos)
        num_neg = torch.clamp(num_neg, min=min_neg)
        score = torch.where(cand, -prob_bg,
                            torch.full_like(prob_bg, -math.inf))
        order = _argsort_desc(score, dim=1)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(num_anchors, device=dev)
                      .expand(bsz, -1).contiguous())
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    matched = _take_rows(labels, match_gt)                # (B, A, 5+)
    cls_gt = matched[:, :, 0]
    cls_target = torch.where(
        positive, cls_gt + 1.0,
        torch.where(negative, torch.zeros_like(cls_gt),
                    torch.full_like(cls_gt, ignore_label)))
    loc = _encode_boxes(anchors, matched[:, :, 1:5], variances)
    mask = positive.to(anchors.dtype)[:, :, None]
    loc_target = (loc * mask).reshape(bsz, -1)
    loc_mask = mask.expand(bsz, num_anchors, 4).reshape(bsz, -1)
    # no valid gt in an image: everything background and zero
    has_gt = (num_valid > 0)[:, None]
    zero = torch.zeros((), dtype=anchors.dtype, device=dev)
    return (torch.where(has_gt, loc_target, zero),
            torch.where(has_gt, loc_mask, zero),
            torch.where(has_gt, cls_target, zero))


@register('MultiBoxTarget', input_names=('anchor', 'label', 'cls_pred'),
          num_outputs=3, aliases=('_contrib_MultiBoxTarget',),
          output_names=('loc_target', 'loc_mask', 'cls_target'),
          hint='multiboxtarget')
def _multibox_target(attrs, anchor, label, cls_pred):
    return multibox_target(
        anchor.reshape(-1, 4), label, cls_pred,
        asfloat(attrs.get('overlap_threshold', 0.5)),
        asfloat(attrs.get('ignore_label', -1.0)),
        asfloat(attrs.get('negative_mining_ratio', -1.0)),
        asfloat(attrs.get('negative_mining_thresh', 0.5)),
        asint(attrs.get('minimum_negative_samples', 0)),
        _asfloats(attrs.get('variances'), (0.1, 0.1, 0.2, 0.2)))


# ---------------------------------------------------------------------------
# Greedy NMS and MultiBoxDetection (reference contrib/multibox_detection.cc)
# ---------------------------------------------------------------------------

def nms_keep(boxes, scores, cls_id, valid, nms_threshold, force_suppress,
             topk):
    """The JAX package's _nms_keep over a batch: boxes (B, N, 4), scores,
    cls_id and valid (B, N) -> keep (B, N) bool in the original order.

    In score order (stable, invalid last) box i is kept when it is among
    the first topk, valid, and no kept box of higher rank (of its class,
    unless force_suppress) overlaps it past nms_threshold. Only the first
    K = min(topk, count(valid)) sorted boxes can be kept or suppress, so
    the overlap test runs among those K; the greedy scan over their rows
    runs on the host."""
    bsz, num = scores.shape
    dev = scores.device
    order = _argsort_desc(torch.where(valid, scores,
                                      torch.full_like(scores, -math.inf)))
    v = torch.gather(valid, 1, order)
    if topk > 0:
        v = v & (torch.arange(num, device=dev) < topk)
    k = int(v.sum(dim=1).max()) if num else 0
    keep = torch.zeros((bsz, num), dtype=torch.bool, device=dev)
    if k == 0:
        return keep
    top = order[:, :k]
    b = _take_rows(boxes.detach(), top)                    # (B, K, 4)
    sup = iou_matrix(b, b) > nms_threshold                 # (B, K, K)
    if not force_suppress:
        c = torch.gather(cls_id, 1, top)
        sup &= c[:, :, None] == c[:, None, :]
    sup = sup.cpu().numpy()
    cand = v[:, :k].cpu().numpy()
    kept = np.zeros((bsz, k), bool)
    suppressed = np.zeros((bsz, k), bool)
    for i in range(k):
        ki = cand[:, i] & ~suppressed[:, i]
        kept[:, i] = ki
        if ki.any():
            suppressed |= sup[:, i, :] & ki[:, None]
    keep.scatter_(1, top, torch.from_numpy(kept).to(dev))
    return keep


def multibox_detection(cls_prob, loc_pred, anchors, threshold, clip,
                       variances, nms_threshold, force_suppress, nms_topk):
    """cls_prob (B, C, A), loc_pred (B, 4A), anchors (A, 4) -> (B, A, 6)
    rows [id, score, x1, y1, x2, y2], the kept ones first by score, the
    others with id -1."""
    bsz, _, num_anchors = cls_prob.shape
    scores, _ = cls_prob[:, 1:].max(dim=1)                # skip class 0
    cls_id = cls_prob[:, 1:].detach().argmax(dim=1).to(torch.float32)
    boxes = _decode_boxes(anchors, loc_pred.reshape(bsz, -1, 4),
                          variances, clip)
    valid = scores.detach() > threshold
    keep = nms_keep(boxes, scores.detach(), cls_id, valid, nms_threshold,
                    force_suppress, nms_topk)
    out_id = torch.where(keep, cls_id, torch.full_like(cls_id, -1.0))
    rows = torch.cat([out_id[:, :, None], scores[:, :, None], boxes],
                     dim=2)
    # the kept rows first, by score (the reference's output order)
    order = _argsort_desc(torch.where(
        keep, scores.detach(), torch.full_like(scores, -math.inf)))
    return _take_rows(rows, order)


@register('MultiBoxDetection',
          input_names=('cls_prob', 'loc_pred', 'anchor'),
          aliases=('_contrib_MultiBoxDetection',), hint='multiboxdetection')
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    if cls_prob.device.type == 'meta':
        return torch.empty((cls_prob.shape[0], cls_prob.shape[2], 6),
                           dtype=cls_prob.dtype, device=cls_prob.device)
    return multibox_detection(
        cls_prob, loc_pred, anchor.reshape(-1, 4),
        asfloat(attrs.get('threshold', 0.01)),
        asbool(attrs.get('clip', True)),
        _asfloats(attrs.get('variances'), (0.1, 0.1, 0.2, 0.2)),
        asfloat(attrs.get('nms_threshold', 0.5)),
        asbool(attrs.get('force_suppress', False)),
        asint(attrs.get('nms_topk', -1)))


# ---------------------------------------------------------------------------
# Proposal (RPN; reference contrib/proposal.cc) and MultiProposal
# ---------------------------------------------------------------------------

def _rpn_anchors(scales, ratios, stride):
    """The base anchors at (0, 0): a stride x stride box scaled and
    reshaped, corner coordinates (reference GenerateAnchors)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    size = w * h
    for r in ratios:
        size_r = size / r
        ws = round(math.sqrt(size_r))
        hs = round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                        cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.asarray(out, np.float32)


def proposal(cls_prob, bbox_pred, im_info, anchors_np, stride, pre_nms,
             post_nms, nms_thresh, min_size):
    """-> rois (B, post_nms, 5) [batch index, x1, y1, x2, y2] and scores
    (B, post_nms, 1), the rows past the kept boxes 0."""
    bsz = cls_prob.shape[0]
    num_a = anchors_np.shape[0]
    h, w = cls_prob.shape[2], cls_prob.shape[3]
    dev, dt = cls_prob.device, cls_prob.dtype
    sx, sy = np.meshgrid(np.arange(w) * stride, np.arange(h) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                      axis=1).astype(np.float32)
    all_anchors = torch.as_tensor(
        (anchors_np[None, :, :] + shifts[:, None, :]).reshape(-1, 4)) \
        .to(dev)
    # scores (2A, H, W) -> the foreground's (A, H, W) -> (H W A,)
    fg = cls_prob[:, num_a:].permute(0, 2, 3, 1).reshape(bsz, -1)
    deltas = bbox_pred.reshape(bsz, num_a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(bsz, -1, 4)
    # the Faster R-CNN parameterisation: unit variances, pixel coordinates,
    # in float64 and rounded (the module's comment)
    all_anchors, deltas = all_anchors.double(), deltas.double()
    aw = all_anchors[:, 2] - all_anchors[:, 0] + 1.0
    ah = all_anchors[:, 3] - all_anchors[:, 1] + 1.0
    ax = all_anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = all_anchors[:, 1] + 0.5 * (ah - 1.0)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    pw = torch.exp(deltas[..., 2]) * aw
    ph = torch.exp(deltas[..., 3]) * ah
    boxes = torch.stack([cx - 0.5 * (pw - 1), cy - 0.5 * (ph - 1),
                         cx + 0.5 * (pw - 1), cy + 0.5 * (ph - 1)],
                        dim=2).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    xmax = (im_info[:, 1] - 1.0)[:, None]
    ymax = (im_info[:, 0] - 1.0)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), xmax),
        torch.minimum(torch.maximum(boxes[..., 1], zero), ymax),
        torch.minimum(torch.maximum(boxes[..., 2], zero), xmax),
        torch.minimum(torch.maximum(boxes[..., 3], zero), ymax)], dim=2)
    ms = (min_size * im_info[:, 2])[:, None]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= ms) & \
        ((boxes[..., 3] - boxes[..., 1] + 1.0) >= ms)
    neg_inf = torch.full_like(fg, -math.inf)
    fg = torch.where(keep_size, fg, neg_inf)
    n = fg.shape[1]
    pre = min(pre_nms, n) if pre_nms > 0 else n
    order = _argsort_desc(fg.detach())
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=dev).expand(bsz, -1)
                  .contiguous())
    valid = (rank < pre) & torch.isfinite(fg.detach())
    keep = nms_keep(boxes, fg.detach(), torch.zeros_like(fg), valid,
                    nms_thresh, True, -1)
    # the top post_nms kept boxes by score; the rows past them box 0
    sel = torch.where(keep, fg, neg_inf)
    order = _argsort_desc(sel.detach())[:, :post_nms]
    picked = torch.gather(sel.detach(), 1, order)
    if order.shape[1] < post_nms:
        # the JAX package's concatenation of its rois fails here too
        raise ValueError('Proposal: %d anchors < rpn_post_nms_top_n %d'
                         % (n, post_nms))
    ok = torch.isfinite(picked)
    rois = torch.where(ok[..., None], _take_rows(boxes, order), zero)
    bcol = torch.arange(bsz, device=dev, dtype=dt)[:, None, None] \
        .expand(bsz, post_nms, 1)
    rois = torch.cat([bcol, rois], dim=2)
    scores = torch.where(ok, torch.gather(fg, 1, order), zero)[..., None]
    return rois, scores


def _proposal_num_outputs(attrs):
    return 2 if asbool(attrs.get('output_score', False)) else 1


@register('Proposal', input_names=('cls_prob', 'bbox_pred', 'im_info'),
          num_outputs=_proposal_num_outputs,
          aliases=('_contrib_Proposal', 'MultiProposal',
                   '_contrib_MultiProposal'),
          hint='proposal', simple=False)
def _proposal(attrs, inputs, auxs, op_ctx):
    cls_prob, bbox_pred, im_info = inputs
    post_nms = asint(attrs.get('rpn_post_nms_top_n', 300))
    output_score = asbool(attrs.get('output_score', False))
    bsz = cls_prob.shape[0]
    if cls_prob.device.type == 'meta':
        outs = [torch.empty((bsz * post_nms, 5), dtype=cls_prob.dtype,
                            device=cls_prob.device)]
        if output_score:
            outs.append(torch.empty((bsz * post_nms, 1),
                                    dtype=cls_prob.dtype,
                                    device=cls_prob.device))
        return outs, []
    anchors_np = _rpn_anchors(
        _asfloats(attrs.get('scales'), (4.0, 8.0, 16.0, 32.0)),
        _asfloats(attrs.get('ratios'), (0.5, 1.0, 2.0)),
        asint(attrs.get('feature_stride', 16)))
    rois, scores = proposal(
        cls_prob, bbox_pred, im_info, anchors_np,
        asint(attrs.get('feature_stride', 16)),
        asint(attrs.get('rpn_pre_nms_top_n', 6000)), post_nms,
        asfloat(attrs.get('threshold', 0.7)),
        asfloat(attrs.get('rpn_min_size', 16)))
    # the batch folds into the rois (reference: (post_nms * batch, 5))
    outs = [rois.reshape(-1, 5)]
    if output_score:
        outs.append(scores.reshape(-1, 1))
    return outs, []


# ---------------------------------------------------------------------------
# PSROIPooling (R-FCN; reference contrib/psroi_pooling.cc)
# ---------------------------------------------------------------------------

def _summed_area(data):
    """The float64 summed-area table of (N, C, H, W): (N, C, H+1, W+1)."""
    s = torch.cumsum(torch.cumsum(data.double(), dim=2), dim=3)
    return F.pad(s, (1, 0, 1, 0))


@register('PSROIPooling', input_names=('data', 'rois'),
          aliases=('_contrib_PSROIPooling',), hint='psroipooling')
def _psroi_pooling(attrs, data, rois):
    spatial_scale = asfloat(attrs['spatial_scale'])
    output_dim = asint(attrs['output_dim'])
    p = asint(attrs['pooled_size'])
    g = asint(attrs.get('group_size', p))
    _, _, h, w = data.shape
    dt, dev = data.dtype, data.device
    bi = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    # (round(roi) + 1) * scale, not round(roi + 1) * scale (half to even)
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale
    bw = exact_div(torch.clamp(x2 - x1, min=0.1), p)
    bh = exact_div(torch.clamp(y2 - y1, min=0.1), p)
    pb = torch.arange(p, dtype=dt, device=dev)
    # (R, P) bounds of each bin row and column
    hstart = torch.clamp(torch.floor(y1[:, None] + pb[None] * bh[:, None]),
                         0, h)
    hend = torch.clamp(torch.ceil(y1[:, None] + (pb[None] + 1) *
                                  bh[:, None]), 0, h)
    wstart = torch.clamp(torch.floor(x1[:, None] + pb[None] * bw[:, None]),
                         0, w)
    wend = torch.clamp(torch.ceil(x1[:, None] + (pb[None] + 1) *
                                  bw[:, None]), 0, w)
    hs, he = hstart.long()[:, :, None, None], hend.long()[:, :, None, None]
    ws, we = wstart.long()[:, None, :, None], wend.long()[:, None, :, None]
    # the channel block of each spatial bin: (P, P, dim)
    pi = torch.arange(p, device=dev)
    gh = torch.clamp(torch.floor(exact_div(pi.to(dt) * g, p)).long(), 0,
                     g - 1)
    cidx = (torch.arange(output_dim, device=dev)[None, None] * g +
            gh[:, None, None]) * g + gh[None, :, None]
    sat = _summed_area(data)
    b = bi[:, None, None, None]
    c = cidx[None]
    s = sat[b, c, he, we] - sat[b, c, hs, we] - sat[b, c, he, ws] + \
        sat[b, c, hs, ws]                              # (R, P, P, dim)
    cnt = torch.clamp(((he - hs).clamp(min=0) * (we - ws).clamp(min=0))
                      .to(dt), min=1.0)
    out = (s / cnt).to(dt)
    empty = (he <= hs) | (we <= ws)
    out = torch.where(empty, torch.zeros((), dtype=dt, device=dev), out)
    return out.permute(0, 3, 1, 2).contiguous()         # (R, dim, P, P)


# ---------------------------------------------------------------------------
# DeformableConvolution (reference contrib/deformable_convolution.cc)
# ---------------------------------------------------------------------------

def bilinear_at(img, y, x):
    """img (..., C, H, W) indexed by `lead` + (y, x): zero-padded
    bilinear samples. img (C, H, W) and y, x of one shape S -> (C,) + S."""
    _, h, w = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        return img[:, yc, xc] * inb.to(img.dtype)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _dconv_names(attrs):
    if asbool(attrs.get('no_bias', False)):
        return ['data', 'offset', 'weight']
    return ['data', 'offset', 'weight', 'bias']


def _dconv_infer_shape(attrs, in_shapes):
    if in_shapes[0] is None:
        return in_shapes
    kh, kw = astuple(attrs['kernel'], 2)
    num_filter = asint(attrs['num_filter'])
    c = in_shapes[0][1]
    if in_shapes[2] is None:
        in_shapes[2] = (num_filter, c, kh, kw)
    if len(in_shapes) > 3 and in_shapes[3] is None:
        in_shapes[3] = (num_filter,)
    return in_shapes


@register('DeformableConvolution', input_names=_dconv_names,
          infer_shape=_dconv_infer_shape,
          aliases=('_contrib_DeformableConvolution',),
          hint='deformableconvolution')
def _deformable_convolution(attrs, data, offset, weight, bias=None):
    kh, kw = astuple(attrs['kernel'], 2)
    sh, sw = astuple(attrs.get('stride', (1, 1)), 2)
    ph, pw = astuple(attrs.get('pad', (0, 0)), 2)
    dh, dw = astuple(attrs.get('dilate', (1, 1)), 2)
    ndg = asint(attrs.get('num_deformable_group', 1))
    n, c, h, w = data.shape
    out_h = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    out_w = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev, dt = data.device, data.dtype
    oy = torch.arange(out_h, device=dev) * sh - ph
    ox = torch.arange(out_w, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]) \
        .expand(out_h, out_w, kh, kw).to(dt)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]) \
        .expand(out_h, out_w, kh, kw).to(dt)
    cg = c // ndg
    outs = []
    for i in range(n):
        # offset layout [group][tap][(y, x)], as the reference's
        off = offset[i].reshape(ndg, kh * kw, 2, out_h, out_w)
        vals = []
        for gi in range(ndg):
            o = off[gi]
            oy_ = o[:, 0].permute(1, 2, 0).reshape(out_h, out_w, kh, kw)
            ox_ = o[:, 1].permute(1, 2, 0).reshape(out_h, out_w, kh, kw)
            vals.append(bilinear_at(data[i, gi * cg:(gi + 1) * cg],
                                    base_y + oy_, base_x + ox_))
        vals = torch.cat(vals, dim=0)            # (C, OH, OW, KH, KW)
        outs.append(torch.einsum('cyxhw,fchw->fyx', vals, weight))
    out = torch.stack(outs)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


# ---------------------------------------------------------------------------
# DeformablePSROIPooling (reference contrib/deformable_psroi_pooling.cc)
# ---------------------------------------------------------------------------

def _dpsroi_names(attrs):
    if asbool(attrs.get('no_trans', False)):
        return ['data', 'rois']
    return ['data', 'rois', 'trans']


@register('DeformablePSROIPooling', input_names=_dpsroi_names,
          aliases=('_contrib_DeformablePSROIPooling',),
          hint='deformablepsroipooling')
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    spatial_scale = asfloat(attrs['spatial_scale'])
    output_dim = asint(attrs['output_dim'])
    p = asint(attrs.get('pooled_size', 7))
    g = asint(attrs.get('group_size', p))
    part_size = asint(attrs.get('part_size', p)) or p
    spp = asint(attrs.get('sample_per_part', 4))
    trans_std = asfloat(attrs.get('trans_std', 0.0))
    no_trans = asbool(attrs.get('no_trans', False)) or trans is None
    _, _, h, w = data.shape
    dt, dev = data.dtype, data.device
    r = rois.shape[0]
    bi = rois[:, 0].to(torch.int32).long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = exact_div(rw, p), exact_div(rh, p)
    sub_w, sub_h = exact_div(bw, spp), exact_div(bh, spp)
    pidx = torch.arange(p, device=dev)
    pf = pidx.to(dt)
    if no_trans:
        dy = torch.zeros((r, p, p), dtype=dt, device=dev)
        dx = torch.zeros((r, p, p), dtype=dt, device=dev)
    else:
        part = torch.clamp((pidx * part_size) // p, 0, part_size - 1)
        t = trans[torch.arange(r, device=dev)]           # (R, 2, ps, ps)
        dy = t[:, 0][:, part][:, :, part] * trans_std * rh[:, None, None]
        dx = t[:, 1][:, part][:, :, part] * trans_std * rw[:, None, None]
    # (R, P, P) bin origins, then (R, P, P, S, S) sample points
    wstart = pf[None, None, :] * bw[:, None, None] + x1[:, None, None] + dx
    hstart = pf[None, :, None] * bh[:, None, None] + y1[:, None, None] + dy
    iv = torch.arange(spp, device=dev, dtype=dt) + 0.5
    sy = hstart[..., None] + iv * sub_h[:, None, None, None]   # (R,P,P,S)
    sx = wstart[..., None] + iv * sub_w[:, None, None, None]
    gy = sy[..., :, None].expand(r, p, p, spp, spp)
    gx = sx[..., None, :].expand(r, p, p, spp, spp)
    gb = torch.clamp((pidx * g) // p, 0, g - 1)
    cidx = (torch.arange(output_dim, device=dev)[None, None] * g +
            gb[:, None, None]) * g + gb[None, :, None]     # (P, P, dim)
    y0 = torch.floor(gy)
    x0 = torch.floor(gx)
    wy = (gy - y0)[:, :, :, None]
    wx = (gx - x0)[:, :, :, None]
    b = bi[:, None, None, None, None, None]
    c = cidx[None, :, :, :, None, None]

    def tap(yi, xi):
        inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[:, :, :, None]
        yc = torch.clamp(yi, 0, h - 1).long()[:, :, :, None]
        xc = torch.clamp(xi, 0, w - 1).long()[:, :, :, None]
        return data[b, c, yc, xc] * inb.to(dt)        # (R, P, P, dim, S, S)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    vals = top * (1 - wy) + bot * wy
    out = vals.mean(dim=(4, 5))                       # (R, P, P, dim)
    return out.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# CTC loss (reference contrib/ctc_loss.cc, warp-ctc semantics: blank 0,
# labels padded with 0, a cost per sequence)
# ---------------------------------------------------------------------------

def ctc_loss(data, label):
    """data (T, N, C) raw activations, label (N, L) 0-padded classes
    1..C-1 -> the negative log likelihood (N,)."""
    t_len, n, _ = data.shape
    num_l = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data, dim=2)                  # (T, N, C)
    lab = label.to(torch.int32).long()
    lab_len = (lab > 0).sum(dim=1)                         # (N,)
    s_len = 2 * num_l + 1
    ext = torch.zeros((n, s_len), dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    neg_inf = -1e30
    skip_ok = torch.zeros((n, s_len), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])
    full = torch.full((n, s_len), neg_inf, dtype=data.dtype, device=dev)
    lp0 = torch.gather(logp[0], 1, ext)                    # (N, S)
    alpha = full.clone()
    alpha[:, 0] = lp0[:, 0]
    alpha[:, 1] = torch.where(lab_len > 0, lp0[:, 1],
                              torch.full_like(lp0[:, 1], neg_inf))
    pad1 = torch.full((n, 1), neg_inf, dtype=data.dtype, device=dev)
    pad2 = torch.full((n, 2), neg_inf, dtype=data.dtype, device=dev)
    for t in range(1, t_len):
        a_prev = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_prev2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]],
                                                 dim=1), full)
        m = torch.maximum(alpha, torch.maximum(a_prev, a_prev2))
        m_safe = torch.clamp(m, min=neg_inf)
        s = torch.exp(alpha - m_safe) + torch.exp(a_prev - m_safe) + \
            torch.exp(a_prev2 - m_safe)
        alpha = m_safe + torch.log(s) + torch.gather(logp[t], 1, ext)
    end = 2 * lab_len
    rows = torch.arange(n, device=dev)
    a_end = alpha[rows, end]
    # end - 1 is -1 for an empty label: jnp wraps it to the last entry
    a_end1 = alpha[rows, (end - 1) % s_len]
    m = torch.maximum(a_end, a_end1)
    ll = m + torch.log(torch.exp(a_end - m) + torch.where(
        lab_len > 0, torch.exp(a_end1 - m), torch.zeros_like(m)))
    return -ll


@register('ctc_loss', input_names=('data', 'label'),
          aliases=('_contrib_ctc_loss', 'CTCLoss', '_contrib_CTCLoss'),
          hint='ctc_loss')
def _ctc_loss(attrs, data, label):
    return ctc_loss(data, label)


# ---------------------------------------------------------------------------
# fft / ifft (reference contrib/fft.cc: cuFFT C2C on the last axis, the
# complex result interleaved [re, im] along it)
# ---------------------------------------------------------------------------

@register('fft', input_names=('data',), aliases=('_contrib_fft',),
          hint='fft')
def _fft(attrs, data):
    shape = tuple(data.shape)
    d = shape[-1]
    out = torch.fft.fft(data.reshape(-1, d), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1).reshape(-1, 2 * d)
    return packed.reshape(shape[:-1] + (2 * d,)).to(data.dtype)


@register('ifft', input_names=('data',), aliases=('_contrib_ifft',),
          hint='ifft')
def _ifft(attrs, data):
    shape = tuple(data.shape)
    d = shape[-1] // 2
    flat = data.reshape(-1, d, 2)
    cplx = torch.complex(flat[..., 0], flat[..., 1])
    # cuFFT's inverse is unnormalised: match it
    out = torch.fft.ifft(cplx, dim=-1) * d
    return out.real.reshape(shape[:-1] + (d,)).to(data.dtype)


# ---------------------------------------------------------------------------
# count_sketch (reference contrib/count_sketch.cc)
# ---------------------------------------------------------------------------

@register('count_sketch', input_names=('data', 'h', 's'),
          aliases=('_contrib_count_sketch',), hint='count_sketch')
def _count_sketch(attrs, data, h, s):
    out_dim = asint(attrs['out_dim'])
    hh = h.reshape(-1).to(torch.int32).long()
    vals = data * s.reshape(-1)[None, :]
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, vals)


# ---------------------------------------------------------------------------
# quantize / dequantize (reference contrib/quantize.cc): uint8 the affine
# map of [min_range, max_range] onto [0, 255]; int8 symmetric, the range
# max(|min|, |max|) onto +-127, min/max_output -+range; the math of
# quantization.py, shared with serving
# ---------------------------------------------------------------------------

def _quantize_infer_dtype(attrs, in_dtypes):
    # the ranges stay float32 whatever the data; the output is out_type
    out_type = str(parse_attr_value(attrs.get('out_type', 'uint8')))
    f32 = torch.float32
    return ([in_dtypes[0] or f32, f32, f32],
            [getattr(torch, out_type), f32, f32])


def _dequantize_infer_dtype(attrs, in_dtypes):
    out_type = str(parse_attr_value(attrs.get('out_type', 'float32')))
    f32 = torch.float32
    return ([in_dtypes[0] or torch.uint8, f32, f32],
            [getattr(torch, out_type)])


@register('quantize', input_names=('data', 'min_range', 'max_range'),
          num_outputs=3, aliases=('_contrib_quantize',),
          output_names=('output', 'min_output', 'max_output'),
          infer_dtype=_quantize_infer_dtype, hint='quantize')
def _quantize(attrs, data, min_range, max_range):
    from .. import quantization as Q
    out_type = str(parse_attr_value(attrs.get('out_type', 'uint8')))
    if out_type == 'int8':
        real_range = torch.maximum(torch.abs(min_range),
                                   torch.abs(max_range))
        q = Q.quantize_int8_math(data, real_range / Q.INT8_RANGE)
        return q, -real_range, real_range
    return (Q.quantize_uint8_math(data, min_range, max_range),
            min_range, max_range)


@register('dequantize', input_names=('data', 'min_range', 'max_range'),
          aliases=('_contrib_dequantize',),
          infer_dtype=_dequantize_infer_dtype, hint='dequantize')
def _dequantize(attrs, data, min_range, max_range):
    from .. import quantization as Q
    out_type = str(parse_attr_value(attrs.get('out_type', 'float32')))
    if data.dtype == torch.int8:
        real_range = torch.maximum(torch.abs(min_range),
                                   torch.abs(max_range))
        out = Q.dequantize_int8_math(data, real_range / Q.INT8_RANGE)
    else:
        out = Q.dequantize_uint8_math(data, min_range, max_range)
    return out.to(getattr(torch, out_type))
