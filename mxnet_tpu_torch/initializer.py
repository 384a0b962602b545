"""Weight initializers: the counterpart of mxnet_tpu/initializer.py
(reference python/mxnet/initializer.py).

The name-pattern dispatch (weight, bias, gamma, beta, moving_mean,
moving_var, ...) and the zoo (Xavier, MSRAPrelu, Orthogonal, ...) are
the JAX package's. Random draws come from `mx.random`, on the device of
the array being filled, so a run is reproducible from its seed; their
numbers differ from JAX's by nature. `Orthogonal` draws from numpy's
global generator, as the JAX package does.
"""
import json
import re

import numpy as np

from . import base
from . import ndarray as nd


class InitDesc(str):
    """A parameter name with its attributes and the global initializer."""
    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer, dispatching on the parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError('desc must be a string or InitDesc')
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get('__init__', '') if isinstance(desc, InitDesc) \
            else ''
        if init:
            klass, kwargs = json.loads(init)
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith('weight'):
            self._init_weight(desc, arr)
        elif name.endswith('bias'):
            self._init_bias(desc, arr)
        elif name.endswith('gamma'):
            self._init_gamma(desc, arr)
        elif name.endswith('beta'):
            self._init_beta(desc, arr)
        elif name.endswith('moving_mean') or name.endswith('running_mean'):
            self._init_zero(desc, arr)
        elif name.endswith('moving_var') or name.endswith('running_var'):
            self._init_one(desc, arr)
        elif name.endswith('moving_inv_var') or name.endswith('moving_avg'):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _fill(arr, value):
        arr[:] = float(value)

    def _init_zero(self, _, arr):
        self._fill(arr, 0)

    def _init_one(self, _, arr):
        self._fill(arr, 1)

    def _init_bias(self, _, arr):
        self._fill(arr, 0)

    def _init_gamma(self, _, arr):
        self._fill(arr, 1)

    def _init_beta(self, _, arr):
        self._fill(arr, 0)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise ValueError(
            'Unknown initialization pattern for %s. Default initialization '
            'is now limited to "weight", "bias", "gamma", "beta".' % name)


register = base.get_register_func(Initializer, 'initializer')
alias = base.get_alias_func(Initializer, 'initializer')
create = base.get_create_func(Initializer, 'initializer')


def _uniform(low, high, arr):
    return nd.random_uniform(low, high, arr.shape, ctx=arr.context)


def _normal(loc, scale, arr):
    return nd.random_normal(loc, scale, arr.shape, ctx=arr.context)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


alias('zeros')(Zero)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


alias('ones')(One)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class LSTMBias(Initializer):
    """LSTM stacked biases: zero but the forget gate's quarter (gate order
    i, f, c, o), set to `forget_bias`."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        num_hidden = int(arr.shape[0] / 4)
        a = np.zeros(arr.shape, dtype=np.float32)
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a


@register
class FusedRNN(Initializer):
    """The flat parameter vector of a fused RNN op: unpacked into its
    per-layer weight and bias blocks, each initialised by `init` (or the
    global initializer in scope) and the LSTM's i2h biases by
    LSTMBias(forget_bias), then packed again."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if init is not None and not isinstance(init, str):
            init = init.dumps()
        super().__init__(init=init, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden, self._num_layers = num_hidden, num_layers
        self._mode, self._bidirectional = mode, bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(
            self._num_hidden, num_layers=self._num_layers, mode=self._mode,
            bidirectional=self._bidirectional,
            forget_bias=self._forget_bias, prefix='')
        args = cell.unpack_weights({'parameters': arr})
        inner = None
        if self._init is not None:
            klass, kwargs = json.loads(self._init)
            inner = create(klass, **kwargs)
        global_init = desc.global_init if isinstance(desc, InitDesc) \
            else None
        lstm_bias = LSTMBias(self._forget_bias) if self._mode == 'lstm' \
            else None
        for name, block in args.items():
            sub_desc = InitDesc(name, global_init=global_init)
            if lstm_bias is not None and name.endswith('i2h_bias'):
                lstm_bias._init_weight(sub_desc, block)
            elif inner is not None:
                inner(sub_desc, block)
            else:
                assert global_init is not None, (
                    'FusedRNN needs either an explicit init or a '
                    'global initializer in scope')
                global_init(sub_desc, block)
        arr[:] = cell.pack_weights(args)['parameters']


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _uniform(-self.scale, self.scale, arr)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _normal(0.0, self.sigma, arr)


@register
class Xavier(Initializer):
    """Xavier / Glorot: rnd_type uniform or gaussian, factor_type avg, in
    or out, magnitude 3 by default."""

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type, self.factor_type = rnd_type, factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError('Xavier initializer needs at least 2D: %s %s'
                             % (name, shape))
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        by_type = {'avg': (fan_in + fan_out) / 2.0,
                   'in': fan_in, 'out': fan_out}
        if self.factor_type not in by_type:
            raise ValueError('Incorrect factor type')
        scale = float(np.sqrt(self.magnitude / by_type[self.factor_type]))
        if self.rnd_type == 'uniform':
            arr[:] = _uniform(-scale, scale, arr)
        elif self.rnd_type == 'gaussian':
            arr[:] = _normal(0, scale, arr)
        else:
            raise ValueError('Unknown random type')


@register
class MSRAPrelu(Xavier):
    """Kaiming He's initializer."""

    def __init__(self, factor_type='avg', slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__('gaussian', factor_type, magnitude)
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type='uniform'):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == 'uniform':
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == (nout, nin) else v
        arr[:] = (self.scale * res).reshape(arr.shape).astype(np.float32)


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels."""

    def _init_weight(self, _, arr):
        weight = np.zeros(arr.shape, dtype=np.float32)
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.reshape(-1)[i] = \
                (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight


class Load:
    """Values from a parameter dict ('arg:' and 'aux:' prefixes taken
    off), `default_init` for the names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {}
        for name, a in param.items():
            if name.startswith('arg:') or name.startswith('aux:'):
                name = name[4:]
            self.param[name] = a
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != arr.shape:
                raise ValueError('Parameter %s shape mismatch' % name)
            arr[:] = src.asnumpy() if isinstance(src, nd.NDArray) and \
                src.context != arr.context else src
        else:
            if self.default_init is None:
                raise ValueError('%s is not in the loaded param file' % name)
            self.default_init(name, arr)


class Mixed:
    """The initializer of the first pattern a name matches."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        matched = next((init for prog, init in self.map
                        if prog.match(name)), None)
        if matched is None:
            raise ValueError('Parameter name %s did not match any pattern'
                             % name)
        matched(name, arr)
