"""Gluon vision model zoo, the counterpart of
mxnet_tpu/gluon/model_zoo/vision.py (reference
python/mxnet/gluon/model_zoo/vision/: ResNet v1 and v2, VGG, AlexNet,
SqueezeNet, DenseNet, Inception v3), layer for layer and name for name
the JAX package's networks. Pretrained weights are not downloaded:
`pretrained=True` raises, as in the JAX package.
"""
from ..block import HybridBlock
from .. import nn


def _seq(*layers, **kwargs):
    """Build a HybridSequential from a flat layer list (skipping None)."""
    out = nn.HybridSequential(prefix=kwargs.get('prefix', ''))
    for layer in layers:
        if layer is not None:
            out.add(layer)
    return out


def _relu():
    return nn.Activation('relu')


# ---------------------------------------------------------------------------
# AlexNet (reference model_zoo/vision/alexnet.py)
# ---------------------------------------------------------------------------

class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super(AlexNet, self).__init__(**kwargs)
        with self.name_scope():
            self.features = _seq(
                nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                          activation='relu'),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Conv2D(192, kernel_size=5, padding=2, activation='relu'),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Conv2D(384, kernel_size=3, padding=1, activation='relu'),
                nn.Conv2D(256, kernel_size=3, padding=1, activation='relu'),
                nn.Conv2D(256, kernel_size=3, padding=1, activation='relu'),
                nn.MaxPool2D(pool_size=3, strides=2),
                nn.Flatten())
            self.classifier = _seq(
                nn.Dense(4096, activation='relu'), nn.Dropout(0.5),
                nn.Dense(4096, activation='relu'), nn.Dropout(0.5),
                nn.Dense(classes))

    def hybrid_forward(self, F, x):
        return self.classifier(self.features(x))


# ---------------------------------------------------------------------------
# VGG (reference model_zoo/vision/vgg.py)
# ---------------------------------------------------------------------------

_VGG_STAGE_FILTERS = [64, 128, 256, 512, 512]
_VGG_DEPTHS = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
               16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}
vgg_spec = {n: (d, _VGG_STAGE_FILTERS) for n, d in _VGG_DEPTHS.items()}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super(VGG, self).__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation='relu',
                                           weight_initializer='normal'))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer='normal')

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        stages = []
        for depth, width in zip(layers, filters):
            for _ in range(depth):
                stages.append(nn.Conv2D(width, kernel_size=3, padding=1))
                if batch_norm:
                    stages.append(nn.BatchNorm())
                stages.append(_relu())
            stages.append(nn.MaxPool2D(strides=2))
        return _seq(*stages)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# ---------------------------------------------------------------------------
# ResNet v1/v2 (reference model_zoo/vision/resnet.py)
# ---------------------------------------------------------------------------

def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _proj1x1(channels, stride, in_channels):
    """1x1 strided projection used on shortcut paths."""
    return nn.Conv2D(channels, kernel_size=1, strides=stride,
                     use_bias=False, in_channels=in_channels)


def _stack_stage(block, depth, channels, stride, stage_index, in_channels):
    """One ResNet stage: a strided (possibly projecting) block followed by
    depth-1 identity blocks."""
    stage = nn.HybridSequential(prefix='stage%d_' % stage_index)
    with stage.name_scope():
        stage.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=''))
        for _ in range(depth - 1):
            stage.add(block(channels, 1, False, in_channels=channels,
                            prefix=''))
    return stage


def _stem_layers(channels0, thumbnail):
    """ImageNet 7x7 stem, or a thin 3x3 stem for small (CIFAR) inputs."""
    if thumbnail:
        return [_conv3x3(channels0, 1, 0)]
    return [nn.Conv2D(channels0, 7, 2, 3, use_bias=False),
            nn.BatchNorm(), _relu(), nn.MaxPool2D(3, 2, 1)]


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super(BasicBlockV1, self).__init__(**kwargs)
        self.body = _seq(_conv3x3(channels, stride, in_channels),
                         nn.BatchNorm(), _relu(),
                         _conv3x3(channels, 1, channels), nn.BatchNorm())
        self.downsample = _seq(_proj1x1(channels, stride, in_channels),
                               nn.BatchNorm()) if downsample else None

    def hybrid_forward(self, F, x):
        shortcut = self.downsample(x) if self.downsample else x
        return F.Activation(self.body(x) + shortcut, act_type='relu')


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super(BottleneckV1, self).__init__(**kwargs)
        mid = channels // 4
        self.body = _seq(
            nn.Conv2D(mid, kernel_size=1, strides=stride),
            nn.BatchNorm(), _relu(),
            _conv3x3(mid, 1, mid),
            nn.BatchNorm(), _relu(),
            nn.Conv2D(channels, kernel_size=1, strides=1),
            nn.BatchNorm())
        self.downsample = _seq(_proj1x1(channels, stride, in_channels),
                               nn.BatchNorm()) if downsample else None

    def hybrid_forward(self, F, x):
        shortcut = self.downsample(x) if self.downsample else x
        return F.Activation(self.body(x) + shortcut, act_type='relu')


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super(BasicBlockV2, self).__init__(**kwargs)
        self.bn1, self.bn2 = nn.BatchNorm(), nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = (_proj1x1(channels, stride, in_channels)
                           if downsample else None)

    def hybrid_forward(self, F, x):
        pre = F.Activation(self.bn1(x), act_type='relu')
        shortcut = self.downsample(pre) if self.downsample else x
        out = self.conv1(pre)
        out = self.conv2(F.Activation(self.bn2(out), act_type='relu'))
        return out + shortcut


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super(BottleneckV2, self).__init__(**kwargs)
        mid = channels // 4
        self.bn1, self.bn2, self.bn3 = (nn.BatchNorm(), nn.BatchNorm(),
                                        nn.BatchNorm())
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = (_proj1x1(channels, stride, in_channels)
                           if downsample else None)

    def hybrid_forward(self, F, x):
        pre = F.Activation(self.bn1(x), act_type='relu')
        shortcut = self.downsample(pre) if self.downsample else x
        out = self.conv1(pre)
        out = self.conv2(F.Activation(self.bn2(out), act_type='relu'))
        out = self.conv3(F.Activation(self.bn3(out), act_type='relu'))
        return out + shortcut


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super(ResNetV1, self).__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = _seq(*_stem_layers(channels[0], thumbnail))
            for i, depth in enumerate(layers):
                self.features.add(_stack_stage(
                    block, depth, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super(ResNetV2, self).__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = _seq(nn.BatchNorm(scale=False, center=False),
                                 *_stem_layers(channels[0], thumbnail))
            width = channels[0]
            for i, depth in enumerate(layers):
                self.features.add(_stack_stage(
                    block, depth, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels=width))
                width = channels[i + 1]
            for tail in (nn.BatchNorm(), _relu(), nn.GlobalAvgPool2D(),
                         nn.Flatten()):
                self.features.add(tail)
            self.output = nn.Dense(classes, in_units=width)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ('basic_block', [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ('basic_block', [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ('bottle_neck', [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ('bottle_neck', [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ('bottle_neck', [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {'basic_block': BasicBlockV1, 'bottle_neck': BottleneckV1},
    {'basic_block': BasicBlockV2, 'bottle_neck': BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    if num_layers not in resnet_spec:
        raise ValueError('Invalid number of layers: %d. Options are %s'
                         % (num_layers, str(sorted(resnet_spec))))
    if version not in (1, 2):
        raise ValueError('Invalid resnet version: %d. Options are 1 and 2.'
                         % version)
    _check_pretrained(pretrained)
    block_type, layers, channels = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    blk_cls = resnet_block_versions[version - 1][block_type]
    return net_cls(blk_cls, layers, channels, **kwargs)


# ---------------------------------------------------------------------------
# SqueezeNet (reference model_zoo/vision/squeezenet.py)
# ---------------------------------------------------------------------------

def _make_fire_conv(channels, kernel_size, padding=0):
    return _seq(nn.Conv2D(channels, kernel_size, padding=padding), _relu())


class _FireExpand(HybridBlock):
    def __init__(self, e1, e3, **kwargs):
        super(_FireExpand, self).__init__(**kwargs)
        self.p1 = _make_fire_conv(e1, 1)
        self.p3 = _make_fire_conv(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    return _seq(_make_fire_conv(squeeze_channels, 1),
                _FireExpand(expand1x1_channels, expand3x3_channels))


# Trunk plans: ('conv', channels, ksize), 'pool', or a fire (s, e1, e3) tuple.
_SQUEEZENET_PLAN = {
    '1.0': [('conv', 96, 7), 'pool', (16, 64, 64), (16, 64, 64),
            (32, 128, 128), 'pool', (32, 128, 128), (48, 192, 192),
            (48, 192, 192), (64, 256, 256), 'pool', (64, 256, 256)],
    '1.1': [('conv', 64, 3), 'pool', (16, 64, 64), (16, 64, 64), 'pool',
            (32, 128, 128), (32, 128, 128), 'pool', (48, 192, 192),
            (48, 192, 192), (64, 256, 256), (64, 256, 256)],
}


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super(SqueezeNet, self).__init__(**kwargs)
        if version not in _SQUEEZENET_PLAN:
            raise ValueError('Unsupported SqueezeNet version %s: '
                             '1.0 or 1.1 expected' % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            for step in _SQUEEZENET_PLAN[version]:
                if step == 'pool':
                    self.features.add(nn.MaxPool2D(3, 2))
                elif step[0] == 'conv':
                    self.features.add(nn.Conv2D(step[1], kernel_size=step[2],
                                                strides=2))
                    self.features.add(_relu())
                else:
                    self.features.add(_make_fire(*step))
            self.features.add(nn.Dropout(0.5))
            self.output = _seq(nn.Conv2D(classes, kernel_size=1), _relu(),
                               nn.GlobalAvgPool2D(), nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# ---------------------------------------------------------------------------
# DenseNet (reference model_zoo/vision/densenet.py)
# ---------------------------------------------------------------------------

class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super(_DenseLayer, self).__init__(**kwargs)
        self.body = _seq(
            nn.BatchNorm(), _relu(),
            nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False),
            nn.BatchNorm(), _relu(),
            nn.Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False),
            nn.Dropout(dropout) if dropout else None)

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = nn.HybridSequential(prefix='stage%d_' % stage_index)
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    return _seq(nn.BatchNorm(), _relu(),
                nn.Conv2D(num_output_features, kernel_size=1,
                          use_bias=False),
                nn.AvgPool2D(pool_size=2, strides=2))


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super(DenseNet, self).__init__(**kwargs)
        with self.name_scope():
            self.features = _seq(
                nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                          padding=3, use_bias=False),
                nn.BatchNorm(), _relu(),
                nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            width = num_init_features
            last = len(block_config) - 1
            for i, depth in enumerate(block_config):
                self.features.add(_make_dense_block(
                    depth, bn_size, growth_rate, dropout, i + 1))
                width += depth * growth_rate
                if i < last:
                    # Transition halves both channels and spatial dims.
                    width //= 2
                    self.features.add(_make_transition(width))
            for tail in (nn.BatchNorm(), _relu(), nn.GlobalAvgPool2D(),
                         nn.Flatten()):
                self.features.add(tail)
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


# ---------------------------------------------------------------------------
# Inception v3 (reference model_zoo/vision/inception.py)
# ---------------------------------------------------------------------------

def _make_basic_conv(**conv_args):
    return _seq(nn.Conv2D(use_bias=False, **conv_args),
                nn.BatchNorm(epsilon=0.001), _relu())


class _Branching(HybridBlock):
    """Run branches on the same input, concat on channel axis."""

    def __init__(self, branches, **kwargs):
        super(_Branching, self).__init__(**kwargs)
        self._branches = []
        for i, b in enumerate(branches):
            setattr(self, 'branch%d' % i, b)
            self._branches.append(b)

    def hybrid_forward(self, F, x):
        return F.Concat(*[b(x) for b in self._branches], dim=1)


_CONV_FIELDS = ('channels', 'kernel_size', 'strides', 'padding')


def _make_branch(use_pool, *conv_settings):
    pool = {'avg': lambda: nn.AvgPool2D(pool_size=3, strides=1, padding=1),
            'max': lambda: nn.MaxPool2D(pool_size=3, strides=2)}.get(use_pool)
    stages = [pool()] if pool else []
    for spec in conv_settings:
        named = {field: v for field, v in zip(_CONV_FIELDS, spec)
                 if v is not None}
        stages.append(_make_basic_conv(**named))
    return _seq(*stages)


def _make_A(pool_features, prefix):
    return _Branching([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch('avg', (pool_features, 1, None, None))],
        prefix=prefix)


def _make_B(prefix):
    return _Branching([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch('max')], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Branching([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch('avg', (192, 1, None, None))], prefix=prefix)


def _make_D(prefix):
    return _Branching([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch('max')], prefix=prefix)


class _BranchingE(HybridBlock):
    def __init__(self, prefix=None, **kwargs):
        super(_BranchingE, self).__init__(prefix=prefix, **kwargs)
        self.b0 = _make_branch(None, (320, 1, None, None))
        self.b1_stem = _make_basic_conv(channels=384, kernel_size=1)
        self.b1a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                    padding=(0, 1))
        self.b1b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                    padding=(1, 0))
        self.b2_stem = _seq(
            _make_basic_conv(channels=448, kernel_size=1),
            _make_basic_conv(channels=384, kernel_size=3, padding=1))
        self.b2a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                    padding=(0, 1))
        self.b2b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                    padding=(1, 0))
        self.b3 = _make_branch('avg', (192, 1, None, None))

    def hybrid_forward(self, F, x):
        o0 = self.b0(x)
        s1 = self.b1_stem(x)
        o1 = F.Concat(self.b1a(s1), self.b1b(s1), dim=1)
        s2 = self.b2_stem(x)
        o2 = F.Concat(self.b2a(s2), self.b2b(s2), dim=1)
        o3 = self.b3(x)
        return F.Concat(o0, o1, o2, o3, dim=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super(Inception3, self).__init__(**kwargs)
        with self.name_scope():
            self.features = _seq(
                _make_basic_conv(channels=32, kernel_size=3, strides=2),
                _make_basic_conv(channels=32, kernel_size=3),
                _make_basic_conv(channels=64, kernel_size=3, padding=1),
                nn.MaxPool2D(pool_size=3, strides=2),
                _make_basic_conv(channels=80, kernel_size=1),
                _make_basic_conv(channels=192, kernel_size=3),
                nn.MaxPool2D(pool_size=3, strides=2),
                _make_A(32, 'A1_'), _make_A(64, 'A2_'), _make_A(64, 'A3_'),
                _make_B('B_'),
                _make_C(128, 'C1_'), _make_C(160, 'C2_'),
                _make_C(160, 'C3_'), _make_C(192, 'C4_'),
                _make_D('D_'),
                _BranchingE(prefix='E1_'), _BranchingE(prefix='E2_'),
                nn.AvgPool2D(pool_size=8), nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# ---------------------------------------------------------------------------
# Factory (reference model_zoo/vision/__init__.py get_model)
# ---------------------------------------------------------------------------

def _check_pretrained(pretrained):
    if pretrained:
        raise RuntimeError(
            'Pretrained weights are not downloaded. Train locally or '
            'load params with net.load_params(file).')


def alexnet(pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    return AlexNet(**kwargs)


def _vgg(num_layers, pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw):
    """VGG-11 (configuration A)."""
    return _vgg(11, **kw)


def vgg13(**kw):
    """VGG-13 (configuration B)."""
    return _vgg(13, **kw)


def vgg16(**kw):
    """VGG-16 (configuration D)."""
    return _vgg(16, **kw)


def vgg19(**kw):
    """VGG-19 (configuration E)."""
    return _vgg(19, **kw)


def vgg11_bn(**kw):
    """VGG-11 with BatchNorm after every conv."""
    return _vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    """VGG-13 with BatchNorm after every conv."""
    return _vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    """VGG-16 with BatchNorm after every conv."""
    return _vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    """VGG-19 with BatchNorm after every conv."""
    return _vgg(19, batch_norm=True, **kw)


def resnet18_v1(**kw):
    """ResNet-18, post-activation (v1)."""
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    """ResNet-34, post-activation (v1)."""
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    """ResNet-50, post-activation (v1)."""
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    """ResNet-101, post-activation (v1)."""
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    """ResNet-152, post-activation (v1)."""
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    """ResNet-18, pre-activation (v2)."""
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    """ResNet-34, pre-activation (v2)."""
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    """ResNet-50, pre-activation (v2)."""
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    """ResNet-101, pre-activation (v2)."""
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    """ResNet-152, pre-activation (v2)."""
    return get_resnet(2, 152, **kw)


def squeezenet1_0(pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    return SqueezeNet('1.0', **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    return SqueezeNet('1.1', **kwargs)


def _densenet(num_layers, pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    return DenseNet(*densenet_spec[num_layers], **kwargs)


def densenet121(**kw):
    """DenseNet-121 (growth 32)."""
    return _densenet(121, **kw)


def densenet161(**kw):
    """DenseNet-161 (growth 48)."""
    return _densenet(161, **kw)


def densenet169(**kw):
    """DenseNet-169 (growth 32)."""
    return _densenet(169, **kw)


def densenet201(**kw):
    """DenseNet-201 (growth 32)."""
    return _densenet(201, **kw)


def inception_v3(pretrained=False, **kwargs):
    _check_pretrained(pretrained)
    return Inception3(**kwargs)


_models = {'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
           'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
           'resnet152_v1': resnet152_v1,
           'resnet18_v2': resnet18_v2, 'resnet34_v2': resnet34_v2,
           'resnet50_v2': resnet50_v2, 'resnet101_v2': resnet101_v2,
           'resnet152_v2': resnet152_v2,
           'vgg11': vgg11, 'vgg13': vgg13, 'vgg16': vgg16, 'vgg19': vgg19,
           'vgg11_bn': vgg11_bn, 'vgg13_bn': vgg13_bn,
           'vgg16_bn': vgg16_bn, 'vgg19_bn': vgg19_bn,
           'alexnet': alexnet,
           'densenet121': densenet121, 'densenet161': densenet161,
           'densenet169': densenet169, 'densenet201': densenet201,
           'squeezenet1.0': squeezenet1_0, 'squeezenet1.1': squeezenet1_1,
           'inceptionv3': inception_v3}


def get_model(name, **kwargs):
    """Create a model by name (reference model_zoo/__init__.py)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            'Model %s is not supported. Available options are\n\t%s'
            % (name, '\n\t'.join(sorted(_models.keys()))))
    return _models[name](**kwargs)
