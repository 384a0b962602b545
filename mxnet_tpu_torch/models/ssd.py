"""SSD detector symbols (VGG16-reduced backbone): the counterpart of
mxnet_tpu/models/ssd.py, the same graph (the same JSON) built with the
port's symbol API.

Reference: example/ssd/symbol/{vgg16_reduced,common,symbol_builder}.py
(Liu et al. 2016). Multi-scale feature maps each give per-anchor class
scores and box offsets; the priors come from MultiBoxPrior, the training
targets from MultiBoxTarget and the detections from MultiBoxDetection
(ops/contrib_ops.py), whose matching and NMS run on the tensors' device
with their greedy scans on the host.
"""
from .. import symbol as sym


def _conv_act(data, name, num_filter, kernel, pad=(0, 0), stride=(1, 1),
              dilate=(1, 1)):
    c = sym.Convolution(data, kernel=kernel, pad=pad, stride=stride,
                        dilate=dilate, num_filter=num_filter, name=name)
    return sym.Activation(c, act_type='relu', name=name + '_relu')


def vgg16_reduced(data):
    """VGG16 with pool5 3x3/s1 and dilated conv6/conv7 replacing the FC
    head (reference vgg16_reduced.py).  Returns (relu4_3, relu7)."""
    specs = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    body = data
    feat43 = None
    for i, (n, f) in enumerate(specs):
        for j in range(n):
            body = _conv_act(body, 'conv%d_%d' % (i + 1, j + 1), f,
                             (3, 3), pad=(1, 1))
        if i + 1 == 4:
            feat43 = body
        if i + 1 < 5:
            body = sym.Pooling(body, pool_type='max', kernel=(2, 2),
                               stride=(2, 2), name='pool%d' % (i + 1))
        else:
            body = sym.Pooling(body, pool_type='max', kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), name='pool5')
    conv6 = _conv_act(body, 'fc6', 1024, (3, 3), pad=(6, 6),
                      dilate=(6, 6))
    conv7 = _conv_act(conv6, 'fc7', 1024, (1, 1))
    return feat43, conv7


def _extra_layers(body, num_filters, strides):
    """1x1 bottleneck + 3x3/s2 conv pyramid (reference common.py
    multi_layer_feature extra layers)."""
    feats = []
    for i, (f, s) in enumerate(zip(num_filters, strides)):
        body = _conv_act(body, 'multi_feat_%d_conv_1x1' % i, f // 2,
                         (1, 1))
        pad = (1, 1) if s == 2 else (0, 0)
        body = _conv_act(body, 'multi_feat_%d_conv_3x3' % i, f, (3, 3),
                         pad=pad, stride=(s, s))
        feats.append(body)
    return feats


def multibox_layer(from_layers, num_classes, sizes, ratios,
                   normalization=(), steps=()):
    """Attach per-layer cls/loc conv heads + priors and concat across
    layers (reference common.py multibox_layer).  num_classes EXCLUDES
    background; the cls head predicts num_classes+1."""
    cls_preds, loc_preds, anchors = [], [], []
    num_cls = num_classes + 1
    for k, from_layer in enumerate(from_layers):
        feat = from_layer
        if normalization and normalization[k] > 0:
            from .. import initializer as init
            feat = sym.L2Normalization(feat, mode='channel',
                                       name='%d_l2norm' % k)
            scale = sym.Variable(
                '%d_scale' % k, shape=(1, 512, 1, 1),
                init=init.Constant(float(normalization[k])))
            feat = sym.broadcast_mul(scale, feat)
        size = sizes[k]
        ratio = ratios[k]
        num_anchors = len(size) - 1 + len(ratio)

        loc = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name='loc_pred_conv_%d' % k)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(loc))

        cls = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_cls,
                              name='cls_pred_conv_%d' % k)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Flatten(cls))

        step = (steps[k], steps[k]) if steps else (-1.0, -1.0)
        anchors.append(sym.Reshape(
            sym.MultiBoxPrior(feat, sizes=tuple(size), ratios=tuple(ratio),
                              clip=False, steps=step,
                              name='%d_anchors' % k),
            shape=(-1, 4)))
    loc_preds = sym.Concat(*loc_preds, dim=1, name='multibox_loc_pred')
    cls_preds = sym.Concat(*cls_preds, dim=1)
    cls_preds = sym.Reshape(cls_preds, shape=(0, -1, num_cls))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name='multibox_cls_pred')
    anchors = sym.Reshape(sym.Concat(*anchors, dim=0), shape=(1, -1, 4),
                          name='multibox_anchors')
    return loc_preds, cls_preds, anchors


_DEFAULT_SIZES = [[.1, .141], [.2, .272], [.37, .447], [.54, .619],
                  [.71, .79], [.88, .961]]
_DEFAULT_RATIOS = [[1, 2, .5], [1, 2, .5, 3, 1. / 3],
                   [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                   [1, 2, .5], [1, 2, .5]]


def _build_head(num_classes, sizes, ratios):
    data = sym.Variable('data')
    relu4_3, relu7 = vgg16_reduced(data)
    extras = _extra_layers(relu7, [512, 256, 256, 256], [2, 2, 1, 1])
    from_layers = [relu4_3, relu7] + extras
    return multibox_layer(from_layers, num_classes,
                          sizes or _DEFAULT_SIZES,
                          ratios or _DEFAULT_RATIOS,
                          normalization=(20, -1, -1, -1, -1, -1))


def get_symbol_train(num_classes=20, sizes=None, ratios=None,
                     overlap_threshold=0.5, negative_mining_ratio=3,
                     **kwargs):
    """Training symbol: outputs [cls_prob, loc_loss, cls_label]
    (reference symbol_builder.get_symbol_train)."""
    loc_preds, cls_preds, anchors = _build_head(num_classes, sizes, ratios)
    label = sym.Variable('label')
    loc_target, loc_target_mask, cls_target = sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=overlap_threshold,
        ignore_label=-1, negative_mining_ratio=negative_mining_ratio,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name='multibox_target')
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True,
                                 normalization='valid', name='cls_prob')
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss_ = sym.smooth_l1(loc_diff, scalar=1.0, name='loc_loss_')
    loc_loss = sym.MakeLoss(loc_loss_, normalization='valid',
                            name='loc_loss')
    cls_label = sym.MakeLoss(cls_target, grad_scale=0, name='cls_label')
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=20, sizes=None, ratios=None, nms_thresh=0.5,
               force_suppress=False, nms_topk=400, **kwargs):
    """Detection symbol: outputs (B, A, 6) rows
    [cls_id, score, xmin, ymin, xmax, ymax]
    (reference symbol_builder.get_symbol)."""
    loc_preds, cls_preds, anchors = _build_head(num_classes, sizes, ratios)
    cls_prob = sym.softmax(cls_preds, axis=1, name='cls_prob')
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                 name='detection',
                                 nms_threshold=nms_thresh,
                                 force_suppress=force_suppress,
                                 variances=(0.1, 0.1, 0.2, 0.2),
                                 nms_topk=nms_topk)
