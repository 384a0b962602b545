"""Gluon convolution and pooling layers, the counterpart of
mxnet_tpu/gluon/nn/conv_layers.py (reference
python/mxnet/gluon/nn/conv_layers.py: Conv1D-3D, Conv*Transpose,
Max/Avg/Global pooling), on the Convolution, Deconvolution and Pooling
registry ops."""
from ..block import HybridBlock
from .basic_layers import Activation


def _pair(x, n):
    if isinstance(x, (list, tuple)):
        assert len(x) == n
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """Shared implementation for all Conv layers."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', op_name='Convolution',
                 adj=None, prefix=None, params=None):
        super(_Conv, self).__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                'kernel': kernel_size, 'stride': strides,
                'dilate': dilation, 'pad': padding,
                'num_filter': channels, 'num_group': groups,
                'no_bias': not use_bias}
            if adj is not None:
                self._kwargs['adj'] = adj
            self._transposed = op_name == 'Deconvolution'
            if self._transposed:
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size) if in_channels else None
            else:
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size) if in_channels else None
            if wshape is None:
                wshape = ((0,) * (2 + ndim))
            self.weight = self.params.get(
                'weight', shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + '_')
            else:
                self.act = None

    def _alias(self):
        return 'conv'

    def _infer_param_shapes(self, x, *args):
        in_channels = x.shape[1]
        kernel = self._kwargs['kernel']
        groups = self._kwargs['num_group']
        if self._transposed:
            wshape = (in_channels, self._channels // groups) + tuple(kernel)
        else:
            wshape = (self._channels, in_channels // groups) + tuple(kernel)
        self.weight.shape = wshape
        self.weight._finish_deferred_init()
        if self.bias is not None:
            self.bias._finish_deferred_init()

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout='NCW', in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', **kwargs):
        super(Conv1D, self).__init__(
            channels, _pair(kernel_size, 1), _pair(strides, 1),
            _pair(padding, 1), _pair(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout='NCHW',
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros', **kwargs):
        super(Conv2D, self).__init__(
            channels, _pair(kernel_size, 2), _pair(strides, 2),
            _pair(padding, 2), _pair(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout='NCDHW', in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', **kwargs):
        super(Conv3D, self).__init__(
            channels, _pair(kernel_size, 3), _pair(strides, 3),
            _pair(padding, 3), _pair(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout='NCW',
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros', **kwargs):
        super(Conv1DTranspose, self).__init__(
            channels, _pair(kernel_size, 1), _pair(strides, 1),
            _pair(padding, 1), _pair(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name='Deconvolution',
            adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout='NCHW', in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', **kwargs):
        super(Conv2DTranspose, self).__init__(
            channels, _pair(kernel_size, 2), _pair(strides, 2),
            _pair(padding, 2), _pair(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name='Deconvolution',
            adj=_pair(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout='NCDHW',
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros', **kwargs):
        super(Conv3DTranspose, self).__init__(
            channels, _pair(kernel_size, 3), _pair(strides, 3),
            _pair(padding, 3), _pair(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name='Deconvolution',
            adj=_pair(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 **kwargs):
        super(_Pooling, self).__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            'kernel': pool_size, 'stride': strides, 'pad': padding,
            'global_pool': global_pool, 'pool_type': pool_type}

    def _alias(self):
        return 'pool'

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 **kwargs):
        super(MaxPool1D, self).__init__(
            _pair(pool_size, 1),
            _pair(strides, 1) if strides is not None else None,
            _pair(padding, 1), False, 'max', **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', **kwargs):
        super(MaxPool2D, self).__init__(
            _pair(pool_size, 2),
            _pair(strides, 2) if strides is not None else None,
            _pair(padding, 2), False, 'max', **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', **kwargs):
        super(MaxPool3D, self).__init__(
            _pair(pool_size, 3),
            _pair(strides, 3) if strides is not None else None,
            _pair(padding, 3), False, 'max', **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 **kwargs):
        super(AvgPool1D, self).__init__(
            _pair(pool_size, 1),
            _pair(strides, 1) if strides is not None else None,
            _pair(padding, 1), False, 'avg', **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', **kwargs):
        super(AvgPool2D, self).__init__(
            _pair(pool_size, 2),
            _pair(strides, 2) if strides is not None else None,
            _pair(padding, 2), False, 'avg', **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', **kwargs):
        super(AvgPool3D, self).__init__(
            _pair(pool_size, 3),
            _pair(strides, 3) if strides is not None else None,
            _pair(padding, 3), False, 'avg', **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout='NCW', **kwargs):
        super(GlobalMaxPool1D, self).__init__(
            (1,), None, (0,), True, 'max', **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout='NCHW', **kwargs):
        super(GlobalMaxPool2D, self).__init__(
            (1, 1), None, (0, 0), True, 'max', **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout='NCDHW', **kwargs):
        super(GlobalMaxPool3D, self).__init__(
            (1, 1, 1), None, (0, 0, 0), True, 'max', **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout='NCW', **kwargs):
        super(GlobalAvgPool1D, self).__init__(
            (1,), None, (0,), True, 'avg', **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout='NCHW', **kwargs):
        super(GlobalAvgPool2D, self).__init__(
            (1, 1), None, (0, 0), True, 'avg', **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout='NCDHW', **kwargs):
        super(GlobalAvgPool3D, self).__init__(
            (1, 1, 1), None, (0, 0, 0), True, 'avg', **kwargs)
