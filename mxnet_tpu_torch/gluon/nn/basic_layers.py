"""Basic Gluon layers, the counterpart of
mxnet_tpu/gluon/nn/basic_layers.py (reference
python/mxnet/gluon/nn/basic_layers.py: Sequential, Dense, Activation,
Dropout, BatchNorm, LeakyReLU, Embedding, Flatten, Lambda)."""
import numpy as np

from ... import ndarray as nd
from .. import block as _block_mod
from ..block import Block, HybridBlock


class Sequential(Block):
    """Stack of Blocks executed sequentially."""

    def __init__(self, prefix=None, params=None):
        super(Sequential, self).__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks; hybridizes into one cached function. Inside
    the fused step a Conv2D followed by a BatchNorm may run as one pair
    on the conv + statistics kernel (gluon/fused.py)."""

    def __init__(self, prefix=None, params=None):
        super(HybridSequential, self).__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        route = _block_mod._PAIR_ROUTE[0]
        children = self._children
        i = 0
        while i < len(children):
            if route is not None and i + 1 < len(children):
                y = route(children[i], children[i + 1], x)
                if y is not None:
                    x = y
                    i += 2
                    continue
            x = children[i](x)
            i += 1
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class Dense(HybridBlock):
    """Fully-connected layer: out = act(dot(x, W.T) + b)
    (reference basic_layers.py Dense; op FullyConnected)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer='zeros',
                 in_units=0, prefix=None, params=None):
        super(Dense, self).__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._flatten = flatten
            self._in_units = in_units
            self.weight = self.params.get(
                'weight', shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(units,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + '_')
            else:
                self.act = None

    def _alias(self):
        return 'dense'

    def _infer_param_shapes(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)
        self.weight._finish_deferred_init()
        if self.bias is not None:
            self.bias._finish_deferred_init()

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Activation(HybridBlock):
    """Elementwise activation ('relu', 'sigmoid', 'tanh', 'softrelu')."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super(Activation, self).__init__(**kwargs)

    def _alias(self):
        """The activation name doubles as the block's name hint."""
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Dropout with rate `rate` (active in train mode only)."""

    def __init__(self, rate, **kwargs):
        super(Dropout, self).__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate)


class BatchNorm(HybridBlock):
    """Batch normalization over `axis` with moving statistics
    (reference basic_layers.py BatchNorm; op BatchNorm)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 running_mean_initializer='zeros',
                 running_variance_initializer='ones',
                 in_channels=0, **kwargs):
        super(BatchNorm, self).__init__(**kwargs)
        self._kwargs = {'axis': axis, 'eps': epsilon, 'momentum': momentum,
                        'fix_gamma': not scale,
                        'use_global_stats': use_global_stats}
        self._axis = axis
        self.gamma = self.params.get(
            'gamma', grad_req='write' if scale else 'null',
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            'beta', grad_req='write' if center else 'null',
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)
        self.running_mean = self.params.get(
            'running_mean', grad_req='null', shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            'running_var', grad_req='null', shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def _infer_param_shapes(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (channels,)
            p._finish_deferred_init()

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)


class LeakyReLU(HybridBlock):
    """Leaky ReLU with fixed slope alpha."""

    def __init__(self, alpha, **kwargs):
        super(LeakyReLU, self).__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type='leaky', slope=self._alpha)


class Embedding(HybridBlock):
    """Index -> dense vector lookup (op Embedding).

    sparse_grad=True puts the table in the sparse tier
    (parallel/embedding.py): the fused step's backward gives (unique ids,
    rows) pairs instead of a dense (input_dim, output_dim) gradient, the
    optimizer updates only those rows (lazy momentum and wd,
    docs/SPARSE.md), and under a data mesh the table and its momentum
    are striped over the ranks by rows. Outside the fused step
    (autograd.record + Trainer.step) its gradient is dense."""

    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super(Embedding, self).__init__(**kwargs)
        self._kwargs = {'input_dim': input_dim, 'output_dim': output_dim,
                        'sparse_grad': bool(sparse_grad)}
        self.weight = self.params.get(
            'weight', shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, sparse_grad=bool(sparse_grad))

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """Collapse all dims except batch."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """Wrap an arbitrary function of NDArrays as a Block."""

    def __init__(self, function, prefix=None):
        super(Lambda, self).__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd, function), \
                'Function name %s is not found in ndarray.' % function
            self._func_impl = getattr(nd, function)
        else:
            self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """Wrap an arbitrary F-function as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super(HybridLambda, self).__init__(prefix=prefix)
        if isinstance(function, str):
            assert hasattr(nd, function), \
                'Function name %s is not found in ndarray.' % function
            self._func_name = function
            self._func_impl = None
        else:
            self._func_impl = function
            self._func_name = None

    def hybrid_forward(self, F, x, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(x, *args)
        return self._func_impl(F, x, *args)
