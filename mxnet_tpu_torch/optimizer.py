"""Optimizers: the counterpart of mxnet_tpu/optimizer.py (reference
python/mxnet/optimizer.py).

Kept from the JAX package: per-index update counts, lr and wd
multipliers (the symbol's __lr_mult__ / __wd_mult__ attrs among them;
only *_weight and *_gamma decay by default), rescale_grad,
clip_gradient, the per-key `Updater` and its state pickles, and each
optimizer's formulas, written with the port's `nd` ops in the same
order.

`FusedSGD` is the whole-model SGD / NAG update `Module` takes for those
two optimizers. The JAX package compiles it into one XLA dispatch; here
it is a few `torch._foreach_*` calls over the whole parameter list,
applied in place to the executor's own weight tensors and to the
momenta and float32 masters it keeps, so the weights `Module.get_params`
reads are the ones that train. ZeRO, meshes and sparse embedding tables
are not ported.

State pickles have the JAX package's layout. numpy has no bfloat16
without ml_dtypes, so a bfloat16 state is written as float32 (exact),
as `nd.save` writes bfloat16 arrays, and is cast back to its slot's
dtype when it is read.
"""
import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from . import ndarray as nd
from .ndarray import NDArray, zeros

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class Optimizer:
    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0):
        self.lr, self.wd = learning_rate, wd
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict)
        self.idx2name = dict(param_idx2name)
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry ----------------------------------------------------------
    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError('Cannot find optimizer %s' % name)

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    # -- multipliers -------------------------------------------------------
    def _mults_from_sym(self, attr_key):
        """Per-argument multipliers declared as symbol attributes
        (__lr_mult__ / __wd_mult__)."""
        if self.sym is None:
            return {}
        attrs = self.sym.attr_dict()
        return {name: float(attrs[name][attr_key])
                for name in self.sym.list_arguments()
                if attr_key in attrs.get(name, {})}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._mults_from_sym('__lr_mult__')
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # only *_weight and *_gamma decay by default: biases, betas and
        # running statistics do not (the reference's rule)
        self.wd_mult = {name: 0.0 for name in self.idx2name.values()
                        if not name.endswith(('_weight', '_gamma'))}
        self.wd_mult.update(self._mults_from_sym('__wd_mult__'))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _preprocess_grad(self, grad):
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient,
                           a_max=self.clip_gradient)
        return grad


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros_like(weight, dtype=None):
    return zeros(weight.shape, weight.context,
                 dtype=dtype if dtype is not None else weight._data.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum and float32 master weights for float16 and
    bfloat16 parameters (multi_precision)."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        if self.multi_precision and weight._data.dtype in _LOW_PRECISION:
            momentum = None
            if self.momentum != 0.0:
                momentum = _zeros_like(weight, torch.float32)
            return (momentum, weight.astype(np.float32))
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        use_mp = isinstance(state, (list, tuple))
        if use_mp:
            mom, w = state
            g = grad.astype(np.float32)
        else:
            mom, w = state, weight
            g = grad
        g = self._preprocess_grad(g)
        g = g + wd * w
        if self.momentum == 0.0:
            w -= lr * g
        else:
            mom *= self.momentum
            mom -= lr * g
            w += mom
        if use_mp:
            weight._data = w._data.to(weight._data.dtype)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad) + wd * weight
        if self.momentum == 0.0:
            weight -= lr * grad
        else:
            mom = state
            mom *= self.momentum
            mom += grad
            grad += self.momentum * mom
            weight -= lr * grad


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics; the noise is drawn from the
    weight's device generator (`mx.random`)."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        noise = nd.random_normal(0, math.sqrt(lr), weight.shape,
                                 ctx=weight.context)
        weight -= lr / 2 * (grad + wd * weight)
        weight += noise


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        mom, previous_weight = state
        delta = grad + wd * weight + \
            self.lamda * grad * grad * (weight - previous_weight)
        if mom is not None:
            mom *= self.momentum
            mom += -lr * delta
            d = mom
        else:
            d = -lr * delta
        previous_weight._data = weight._data
        weight += d


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        grad = self._preprocess_grad(grad) + wd * weight
        mean, var = state
        mean *= self.beta1
        mean += (1. - self.beta1) * grad
        var *= self.beta2
        var += (1. - self.beta2) * grad * grad
        weight -= lr * mean / (nd.sqrt(var) + self.epsilon)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight, torch.float32)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        history = state
        history += grad * grad
        weight -= lr * (grad / nd.sqrt(history + self.float_stable_eps) +
                        wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp, with the centered variant."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight, torch.float32) for _ in range(n))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad) + wd * weight
        if self.centered:
            n, g, delta = state
            n *= self.gamma1
            n += (1 - self.gamma1) * grad * grad
            g *= self.gamma1
            g += (1 - self.gamma1) * grad
            delta *= self.gamma2
            delta -= lr * grad / nd.sqrt(n - g * g + self.epsilon)
            weight += delta
        else:
            n, = state
            n *= self.gamma1
            n += (1 - self.gamma1) * grad * grad
            weight -= lr * grad / nd.sqrt(n + self.epsilon)
        if self.clip_weights:
            weight._data = nd.clip(weight, a_min=-self.clip_weights,
                                   a_max=self.clip_weights)._data


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        acc_g, acc_delta = state
        acc_g *= self.rho
        acc_g += (1. - self.rho) * grad * grad
        current_delta = nd.sqrt(acc_delta + self.epsilon) / \
            nd.sqrt(acc_g + self.epsilon) * grad
        acc_delta *= self.rho
        acc_delta += (1. - self.rho) * current_delta * current_delta
        weight -= current_delta + wd * weight


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        z, n = state
        sigma = -nd.sqrt(n)
        n += grad * grad
        denom = nd.sqrt(n)
        sigma += denom
        sigma /= lr
        z += grad - sigma * weight
        d = (nd.sign(z) * self.lamda1 - z) / \
            ((self.beta + denom) / lr + wd)
        weight._data = (d * (nd.abs(z) > self.lamda1))._data


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        grad = self._preprocess_grad(grad) + wd * weight
        m_t, u_t = state
        m_t *= self.beta1
        m_t += (1. - self.beta1) * grad
        u_t._data = nd.maximum(self.beta2 * u_t, nd.abs(grad))._data
        weight -= lr * m_t / u_t


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.schedule_decay = epsilon, schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        grad = self._preprocess_grad(grad) + wd * weight
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t *= self.beta1
        m_t += (1. - self.beta1) * grad
        v_t *= self.beta2
        v_t += (1. - self.beta2) * grad * grad
        grad_prime = grad / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight -= lr * m_t_bar / (nd.sqrt(v_t_prime) + self.epsilon)


@register
class Signum(Optimizer):
    """Sign-momentum SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._preprocess_grad(grad)
        if state is not None:
            mom = state
            mom *= self.momentum
            mom -= (1 - self.momentum) * (grad + wd * weight)
            weight += lr * (nd.sign(mom) - self.wd_lh * weight)
        else:
            weight -= lr * (nd.sign(grad) + wd * weight)


@register
class Test(Optimizer):
    """Adds the rescaled gradient."""

    def create_state(self, index, weight):
        return _zeros_like(weight, torch.float32)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state._data = weight._data


ccSGD = SGD  # the reference's deprecated alias


# -- state pickles ---------------------------------------------------------

def _host(v):
    """A state value as numpy for a pickle (bfloat16 as float32)."""
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        t = v.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return v


def _tensor(a, like=None, dtype=None, device=None):
    """numpy or tensor `a` as a tensor in `like`'s dtype and on its device
    (or the given ones)."""
    if isinstance(a, torch.Tensor):
        t = a
    elif np.asarray(a).dtype.name == 'bfloat16':
        # numpy's bfloat16 (ml_dtypes, in the JAX package's pickles) has
        # no torch counterpart to convert through: its bits are bfloat16's
        t = torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if like is not None:
        dtype, device = like.dtype, like.device
    return t.to(device=device, dtype=dtype or t.dtype)


def _load_pickle(states):
    """(states, counts, masters) of a pickle of either layout."""
    payload = pickle.loads(states)
    if isinstance(payload, tuple) and len(payload) == 3:
        return payload
    if isinstance(payload, tuple):
        return payload[0], payload[1], None
    return payload, None, None


def _fill_state(template, loaded, weight):
    """The state slot(s) `template` (a fresh create_state) with the
    loaded numpy values written in, each in its slot's dtype and on the
    weight's device; a slot the file does not fill keeps its fresh
    value."""
    if isinstance(template, (list, tuple)) and \
            isinstance(loaded, (list, tuple)):
        return [_fill_state(t, v, weight) for t, v in zip(template, loaded)]
    if loaded is None:
        return template
    if template is None:
        return NDArray(_tensor(loaded, device=weight._data.device),
                       weight.context)
    return NDArray(_tensor(loaded, template._data), template.context)


class Updater:
    """The per-key update closure (reference optimizer.py get_updater):
    states by index, created at each index's first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        # indices whose state came from set_states as numpy, placed on
        # the weight's device at their next update
        self._loaded = set()

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif index in self._loaded:
            self._loaded.discard(index)
            self.states[index] = _fill_state(
                self.optimizer.create_state(index, weight),
                self.states[index], weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        states, counts, masters = _load_pickle(states)
        self.states = {k: list(v) if isinstance(v, tuple) else v
                       for k, v in states.items()}
        for k, m in (masters or {}).items():
            # a FusedSGD file carries the float32 masters apart: rebuild
            # the (momentum, master) pair, since an mp update cannot
            # derive a lost master again
            if m is not None and not isinstance(self.states.get(k), list):
                self.states[k] = [self.states.get(k), m]
        self._loaded = set(self.states)
        if counts is not None:
            self.optimizer._index_update_count = dict(counts)

    def get_states(self):
        def conv(v):
            if isinstance(v, (list, tuple)):
                return [_host(x) for x in v]
            return _host(v)
        return pickle.dumps(({k: conv(v) for k, v in self.states.items()},
                             dict(self.optimizer._index_update_count)))


def get_updater(optimizer):
    return Updater(optimizer)


def sgd_update_math(acc, g, m, lr, wd, momentum=0.0, rescale=1.0,
                    clip=None, nesterov=False):
    """The SGD / NAG elementwise update of one parameter, as the JAX
    package's sgd_update_math: `g` already in `acc`'s dtype; returns
    (new_acc, new_momentum) as new tensors. FusedSGD applies the same
    operations in the same order, in place, over all parameters."""
    g = g * rescale
    if clip is not None:
        g = g.clamp(-clip, clip)
    g = g + wd * acc
    if momentum == 0.0:
        return acc - lr * g, m
    if nesterov:
        nm = momentum * m + g
        return acc - lr * (g + momentum * nm), nm
    nm = momentum * m - lr * g
    return acc + nm, nm


class FusedSGD:
    """The whole-model SGD / NAG update (the JAX package's FusedSGD):
    `sgd_update_math` on every parameter, on float32 masters for float16
    and bfloat16 weights when multi_precision is set, the weight then the
    master rounded to nearest. `host_prep` bumps the per-name update
    counts and evaluates lr and wd; `step_math` applies the update in
    place with torch._foreach_* calls over the whole list.

    ZeRO stage 1 (`zero=1`, parallel/zero.py): the same update on the
    parameters flattened into buckets, with the momenta and masters
    sharded over the data axis of `mesh`: this rank holds and updates
    its 1/N block of each bucket, the gradients (this rank's own, not
    yet summed) are reduce-scattered and the updated buckets
    all-gathered into the weights. `interleave` is the reduction
    schedule (collectives.interleave_reduce_enabled), carried in the
    cache key. Checkpoints keep per-parameter arrays whatever the mode,
    so they restore across data widths and stages.

    `sparse_idx`: the positions of sparse embedding tables
    (parallel/embedding.py), whose gradient arrives as a (unique ids,
    row gradients) pair, or (ids, rows, lo) for a table striped over the
    data axis that holds rows [lo, ...), and which update rows-only
    (lazy momentum and wd). They stay out of the ZeRO buckets; their
    momenta have the weight's rows (a stripe under a mesh, where
    `sparse_vocab` {position: rows} gives each table's full size, which
    checkpoints gather to). Sparse tables do not take multi_precision.
    """

    def __init__(self, optimizer, param_names, zero=0, mesh=None,
                 interleave=None, sparse_idx=(), sparse_vocab=None):
        assert type(optimizer) in (SGD, NAG)
        self.sparse_idx = tuple(sorted(set(int(i) for i in sparse_idx)))
        if self.sparse_idx and bool(getattr(optimizer, 'multi_precision',
                                            False)):
            raise MXNetError(
                'sparse_grad embedding tables do not compose with '
                'multi_precision: a row-sliced float32 master would need '
                'its own lazy materialization; keep sparse tables '
                'float32 (their update touches only rows already)')
        self.sparse_vocab = dict(sparse_vocab or {})
        self.optimizer = optimizer
        self.param_names = list(param_names)
        self.states = {}      # name -> momentum tensor
        self.masters = {}     # name -> float32 master tensor, or None
        self.momentum = float(optimizer.momentum)
        self.rescale = float(optimizer.rescale_grad)
        self.clip = None if optimizer.clip_gradient is None \
            else float(optimizer.clip_gradient)
        self.nesterov = isinstance(optimizer, NAG)
        self.multi_precision = bool(getattr(optimizer, 'multi_precision',
                                            False))
        self.zero = int(zero or 0)
        self.mesh = mesh
        if mesh is not None and 'data' not in mesh.shape:
            raise ValueError("FusedSGD runs over the 'data' axis of a mesh; "
                             'its axes are %s' % (mesh.axis_names,))
        from .parallel import collectives
        from .parallel.mesh import mesh_fingerprint
        self._mesh_fp = mesh_fingerprint(mesh)
        self._interleave = collectives.interleave_reduce_enabled(interleave)
        self._layout = self._layout_inputs = self._layout_names = None
        self._zero_moms = self._zero_masters = None
        # per-name (momenta, masters) waiting to be bucketed (set_states,
        # or the state of a layout that changed)
        self._staged = None
        if self.zero:
            self.step_math = None     # bound with each layout

    def _hyper(self):
        return {'momentum': self.momentum, 'rescale': self.rescale,
                'clip': self.clip, 'nesterov': self.nesterov,
                'interleave': self._interleave}

    def _dp(self):
        return 1 if self.mesh is None else int(self.mesh.shape['data'])

    def _is_mp(self, w):
        return self.multi_precision and w._data.dtype in _LOW_PRECISION

    def cache_key(self):
        """The identity of step_math: what it reads of the optimizer (lr
        and wd are its arguments), and under ZeRO the stage, the bucket
        layout, the mesh and the schedule."""
        key = ('FusedSGD', type(self.optimizer).__name__, self.momentum,
               self.rescale, self.clip, self.multi_precision)
        if self.sparse_idx:
            key += (('sparse', self.sparse_idx),)
        if self.zero:
            key += (('zero', self.zero, self._layout.key
                     if self._layout is not None else None, self._mesh_fp,
                     self._interleave),)
        return key

    def _snapshot_schedule_state(self):
        """All that _get_lr changes: the update counts and the stateful
        lr scheduler's own attributes."""
        opt = self.optimizer
        sched = getattr(opt, 'lr_scheduler', None)
        return (dict(opt._index_update_count), opt.num_update,
                dict(sched.__dict__) if sched is not None else None)

    def _restore_schedule_state(self, saved):
        opt = self.optimizer
        counts, num_update, sched_state = saved
        opt._index_update_count = counts
        opt.num_update = num_update
        if sched_state is not None:
            opt.lr_scheduler.__dict__.clear()
            opt.lr_scheduler.__dict__.update(sched_state)

    def host_prep_steps(self, weights, k, advance=True):
        """host_prep for a K-step bulk dispatch: the states once, the
        update counts bumped K times and lr and wd evaluated at every
        step index, as the per-step loop evaluates them, so that a
        scheduler boundary crossed inside the dispatch takes effect at
        its step. Returns (moms, masters, lrs, wds) with lrs and wds one
        list of floats per step. advance=False leaves the counts and
        the schedule as they were (a warm-up)."""
        opt = self.optimizer
        saved = None if advance else self._snapshot_schedule_state()
        moms, masters, lrs0, wds0 = self.host_prep(weights)
        lrs, wds = [lrs0], [wds0]
        for _ in range(1, k):
            lr_s, wd_s = [], []
            for name in self.param_names:
                opt._update_count(name)
                lr_s.append(opt._get_lr(name))
                wd_s.append(opt._get_wd(name))
            lrs.append(lr_s)
            wds.append(wd_s)
        if saved is not None:
            self._restore_schedule_state(saved)
        return moms, masters, lrs, wds

    def host_prep(self, weights):
        """Create the momenta and masters a parameter lacks (zeros; the
        master from the weight), put loaded ones on the weight's device
        in their dtype, bump the update counts and evaluate lr and wd.
        Returns (moms, masters, lrs, wds) aligned with param_names, or
        under ZeRO with the layout's buckets (this rank's blocks)."""
        opt = self.optimizer
        if self.zero:
            moms, masters = self._host_prep_zero(weights)
        else:
            moms, masters = self._host_prep_replicated(weights)
        lrs, wds = [], []
        for name in self.param_names:
            opt._update_count(name)
            lrs.append(opt._get_lr(name))
            wds.append(opt._get_wd(name))
        return moms, masters, lrs, wds

    def _sparse_momentum(self, name, j, t):
        """The momentum of sparse table `name` (position j) beside its
        weight `t`: None without momentum; a loaded full table cut to
        this rank's stripe."""
        if self.momentum == 0.0:
            self.states.pop(name, None)
            return None
        m = self.states.get(name)
        if m is None:
            m = torch.zeros_like(t)
        else:
            if m.shape[0] != t.shape[0]:
                from .parallel.embedding import stripe_of
                m = stripe_of(_tensor(m), self.mesh)
            if m.device != t.device or m.dtype != t.dtype:
                m = _tensor(m, dtype=t.dtype, device=t.device)
        self.states[name] = m
        return m

    def _host_prep_replicated(self, weights):
        sparse = set(self.sparse_idx)
        for j, (name, w) in enumerate(zip(self.param_names, weights)):
            t = w._data
            if j in sparse:
                self._sparse_momentum(name, j, t)
                self.masters[name] = None
                continue
            mp = self._is_mp(w)
            mdtype = torch.float32 if mp else t.dtype
            m = self.states.get(name)
            if m is None:
                self.states[name] = torch.zeros_like(t, dtype=mdtype)
            elif m.device != t.device or m.dtype != mdtype:
                self.states[name] = _tensor(m, dtype=mdtype, device=t.device)
            master = self.masters.get(name)
            if not mp:
                self.masters[name] = None
            elif master is None:
                self.masters[name] = t.detach().float()
            elif master.device != t.device:
                self.masters[name] = _tensor(master, dtype=torch.float32,
                                             device=t.device)
        return ([self.states.get(n) for n in self.param_names],
                [self.masters[n] for n in self.param_names])

    def _host_prep_zero(self, weights):
        """(Re)build the bucket layout when the parameter list, its
        dtypes, the data size or the bucket target changed, and make
        this rank's blocks of the momenta and masters: from the staged
        per-name values where there are any, else zeros and the
        weights."""
        from .parallel import zero as zero_mod
        all_names = list(self.param_names)
        sparse = set(self.sparse_idx)
        # sparse tables stay out of the buckets: their update is rows-only
        dense_idx = [j for j in range(len(all_names)) if j not in sparse]
        names = [all_names[j] for j in dense_idx]
        sparse_w = [weights[j] for j in self.sparse_idx]
        weights = [weights[j] for j in dense_idx]
        dp = self._dp()
        inputs = (tuple(tuple(w.shape) for w in weights),
                  tuple(w._data.dtype for w in weights),
                  tuple(self._is_mp(w) for w in weights), dp,
                  zero_mod.bucket_bytes(), tuple(names), self.sparse_idx)
        if self._layout_inputs != inputs:
            if self._zero_moms is not None:
                self._staged = self._gather_zero()
            self._layout = zero_mod.ZeroBucketLayout(
                [tuple(w.shape) for w in weights],
                [w._data.dtype for w in weights],
                [self._is_mp(w) for w in weights], dp)
            self._layout_inputs = inputs
            self._layout_names = names
            self._zero_moms = self._zero_masters = None
            step = zero_mod.make_sharded_sgd_step(
                self._layout, self.mesh, self._hyper())
            self.step_math = step if not sparse else \
                self._make_zero_sparse_step(step, len(self._layout.buckets),
                                            dense_idx)
        if self._zero_moms is None:
            staged_moms, staged_masters = self._staged or ({}, {})
            self._staged = None
            index = 0 if self.mesh is None else \
                self.mesh.axis_index('data')
            lay = self._layout

            def block(b, per_name, fallback):
                vals = []
                for i in b.param_idx:
                    w = weights[i]._data
                    v = per_name.get(names[i])
                    vals.append(fallback(w) if v is None else
                                _tensor(v, device=w.device).reshape(w.shape))
                lo, hi = lay.shard_range(b, index)
                return lay.pack(b, vals)[lo:hi].clone()

            self._zero_moms = [block(b, staged_moms, torch.zeros_like)
                               for b in lay.buckets]
            self._zero_masters = [
                block(b, staged_masters, lambda w: w.detach().float())
                if b.mp else None for b in lay.buckets]
            for j in self.sparse_idx:
                v = staged_moms.get(all_names[j])
                if v is not None:
                    self.states[all_names[j]] = v
        sparse_moms = [self._sparse_momentum(all_names[j], j, w._data)
                       for j, w in zip(self.sparse_idx, sparse_w)]
        return list(self._zero_moms) + sparse_moms, list(self._zero_masters)

    def _make_zero_sparse_step(self, step, nb, dense_idx):
        """The ZeRO-1 step with sparse tables beside the buckets: moms
        arrive as [bucket blocks...] + [sparse momenta...]."""
        sparse_idx = self.sparse_idx

        def step_math(ws, gs, moms, masters, lrs, wds):
            dws, new_bm, new_masters = step(
                [ws[j] for j in dense_idx], [gs[j] for j in dense_idx],
                list(moms[:nb]), masters, [lrs[j] for j in dense_idx],
                [wds[j] for j in dense_idx])
            new_sm = [self._sparse_step(ws[j], gs[j], m, lrs[j], wds[j])
                      for j, m in zip(sparse_idx, moms[nb:])]
            return ws, list(new_bm) + new_sm, new_masters
        return step_math

    def _gather_zero(self):
        """The ZeRO blocks gathered over the data axis and unpacked:
        ({name: momentum}, {name: master}) of full per-parameter tensors
        (a collective: every rank of the mesh calls it)."""
        from .parallel import collectives
        moms, masters = {}, {}
        lay = self._layout
        for b, mom, mas in zip(lay.buckets, self._zero_moms,
                               self._zero_masters):
            full = collectives.all_gather_flat(mom, self.mesh)
            for i, v in zip(b.param_idx, lay.unpack(b, full)):
                moms[self._layout_names[i]] = v.clone()
            if b.mp and mas is not None:
                full = collectives.all_gather_flat(mas, self.mesh)
                for i, v in zip(b.param_idx, lay.unpack(b, full)):
                    masters[self._layout_names[i]] = v.clone()
        return moms, masters

    def _sparse_step(self, w, g, m, lr, wd):
        """The rows-only update of one sparse table from its (ids, rows[,
        lo]) gradient, in place; returns its momentum."""
        from .parallel.embedding import sparse_row_update
        uids, d_rows = g[0], g[1]
        lo = g[2] if len(g) > 2 else 0
        sparse_row_update(w, m, uids, d_rows, lr, wd,
                          momentum=self.momentum, rescale=self.rescale,
                          clip=self.clip, nesterov=self.nesterov, lo=lo)
        return m

    def step_math(self, ws, gs, moms, masters, lrs, wds):
        """The update of tensors ws (weights) from gs (gradients, left as
        they are), moms and masters (updated in place); returns (ws,
        moms, masters), the same tensors."""
        if self.sparse_idx:
            moms = list(moms)
            for j in self.sparse_idx:
                moms[j] = self._sparse_step(ws[j], gs[j], moms[j], lrs[j],
                                            wds[j])
            dense = [j for j in range(len(ws)) if j not in
                     set(self.sparse_idx)]
            self._dense_step([ws[j] for j in dense], [gs[j] for j in dense],
                             [moms[j] for j in dense],
                             [masters[j] for j in dense],
                             [lrs[j] for j in dense], [wds[j] for j in dense])
            return ws, moms, masters
        return self._dense_step(ws, gs, moms, masters, lrs, wds)

    def _dense_step(self, ws, gs, moms, masters, lrs, wds):
        if not ws:
            return ws, moms, masters
        accs = [m if m is not None else w for w, m in zip(ws, masters)]
        # the gradient in the accumulator's dtype, times rescale: new
        # tensors (the executor's gradients stay unscaled)
        g = [x if x.dtype == a.dtype else x.to(a.dtype)
             for x, a in zip(gs, accs)]
        g = torch._foreach_mul(g, self.rescale)
        if self.clip is not None:
            torch._foreach_clamp_min_(g, -self.clip)
            torch._foreach_clamp_max_(g, self.clip)
        torch._foreach_add_(g, torch._foreach_mul(accs, wds))
        if self.momentum == 0.0:
            torch._foreach_sub_(accs, torch._foreach_mul(g, lrs))
        elif self.nesterov:
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_add_(moms, g)
            step = torch._foreach_mul(moms, self.momentum)
            torch._foreach_add_(step, g)
            torch._foreach_mul_(step, lrs)
            torch._foreach_sub_(accs, step)
        else:
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_mul_(g, lrs)
            torch._foreach_sub_(moms, g)
            torch._foreach_add_(accs, moms)
        low = [(w, a) for w, a, m in zip(ws, accs, masters) if m is not None]
        if low:
            torch._foreach_copy_([w for w, _ in low], [a for _, a in low])
        return ws, moms, masters

    def commit(self, new_moms, new_masters):
        """Keep the momenta and masters a step returned (the same tensors
        when step_math ran in place; per bucket under ZeRO)."""
        if self.zero:
            nb = len(new_moms) - len(self.sparse_idx)
            self._zero_moms = list(new_moms[:nb])
            self._zero_masters = list(new_masters)
            for j, m in zip(self.sparse_idx, new_moms[nb:]):
                if m is not None:
                    self.states[self.param_names[j]] = m
            return
        for n, m, w in zip(self.param_names, new_moms, new_masters):
            if m is None:
                self.states.pop(n, None)
            else:
                self.states[n] = m
            self.masters[n] = w

    def __call__(self, weights, grads):
        """weights and grads: NDArrays aligned with param_names (a sparse
        table's gradient its (ids, rows[, lo]) tuple); the weights' own
        tensors are updated in place."""
        moms, masters, lrs, wds = self.host_prep(weights)
        _, new_moms, new_masters = self.step_math(
            [w._data for w in weights],
            [g if isinstance(g, tuple) else g._data for g in grads], moms,
            masters, lrs, wds)
        self.commit(new_moms, new_masters)

    def state_bytes_per_device(self):
        """Bytes of momenta and float32 masters on this rank's device:
        its blocks under ZeRO."""
        if self.zero:
            total = self._layout.state_bytes_per_device() \
                if self._layout is not None else 0
            for j in self.sparse_idx:
                v = self.states.get(self.param_names[j])
                if v is not None:
                    total += v.numel() * v.element_size()
            return total
        return sum(t.numel() * t.element_size()
                   for t in list(self.states.values()) +
                   list(self.masters.values()) if t is not None)

    def comm_bytes_per_step(self):
        """(bytes_reduce_scattered, bytes_all_gathered) of one ZeRO step;
        (0, 0) replicated."""
        if self.zero and self._layout is not None:
            return self._layout.comm_bytes_per_step()
        return 0, 0

    def transfer_states_from(self, other):
        """Take another FusedSGD's state (the same parameters): the fused
        Gluon step rebuilds its updater when rescale_grad changes.
        Replicated to replicated shares the tensors; otherwise through
        the checkpoint format."""
        if not self.zero and not other.zero:
            self.states = dict(other.states)
            self.masters = dict(other.masters)
            if other.optimizer is not self.optimizer:
                self.optimizer._index_update_count = \
                    dict(other.optimizer._index_update_count)
            return
        self.set_states(other.get_states())

    @staticmethod
    def _split_updater_states(states, masters):
        """(momenta, masters) by name from either checkpoint layout: the
        per-key Updater's None or [momentum, master] values, or
        FusedSGD's momenta with the masters apart."""
        moms = {}
        out_masters = {n: v for n, v in (masters or {}).items()
                       if v is not None}
        for n, v in states.items():
            if isinstance(v, (list, tuple)):
                if len(v) > 0 and v[0] is not None:
                    moms[n] = v[0]
                if len(v) > 1 and v[1] is not None:
                    out_masters.setdefault(n, v[1])
            elif v is not None:
                moms[n] = v
        return moms, out_masters

    def _per_name(self):
        """({name: momentum}, {name: master}) of full tensors, whatever
        the mode (under ZeRO a gather over the data axis)."""
        if self._staged is not None:
            return self._staged
        if self.zero:
            if self._zero_moms is None:
                moms, masters = {}, {}
            else:
                moms, masters = self._gather_zero()
            for j in self.sparse_idx:
                n = self.param_names[j]
                if n in self.states:
                    moms[n] = self.states[n]
        else:
            moms, masters = dict(self.states), dict(self.masters)
        return self._full_sparse(moms), masters

    def _full_sparse(self, moms):
        """moms with each striped sparse momentum gathered to its full
        table (a collective over the data axis)."""
        if self.mesh is None or self._dp() <= 1:
            return moms
        from .parallel.embedding import unstripe
        for j in self.sparse_idx:
            n = self.param_names[j]
            v = moms.get(n)
            vocab = self.sparse_vocab.get(j)
            if v is not None and vocab is not None and \
                    v.shape[0] != vocab:
                moms[n] = unstripe(_tensor(v), vocab, self.mesh)
        return moms

    def get_states(self):
        """The states as per-parameter arrays in either mode, so that a
        ZeRO run's file restores into a replicated one and back (under
        ZeRO every rank of the mesh calls it: it gathers)."""
        moms, masters = self._per_name()
        return pickle.dumps(
            ({n: _host(v) for n, v in moms.items()},
             dict(self.optimizer._index_update_count),
             {n: _host(v) for n, v in masters.items()}))

    def set_states(self, states):
        """Restore from either layout; the values stay on the host until
        host_prep puts each beside its weight (under ZeRO, its block of
        each bucket)."""
        states, counts, masters = _load_pickle(states)
        moms, masters = self._split_updater_states(states, masters)
        moms = {n: _tensor(v) for n, v in moms.items()}
        masters = {n: _tensor(v, dtype=torch.float32)
                   for n, v in masters.items()}
        if self.zero:
            self._staged = (moms, masters)
            self._zero_moms = self._zero_masters = None
        else:
            self.states, self.masters = moms, masters
        if counts is not None:
            self.optimizer._index_update_count = dict(counts)


def create_fused_updater(optimizer, param_names, zero=0, mesh=None,
                         interleave=None, sparse_idx=(), sparse_vocab=None):
    """A FusedSGD for SGD and NAG, else None (the caller takes the
    per-key Updater; with sparse tables the caller must refuse None)."""
    if type(optimizer) in (SGD, NAG):
        return FusedSGD(optimizer, param_names, zero=zero, mesh=mesh,
                        interleave=interleave, sparse_idx=sparse_idx,
                        sparse_vocab=sparse_vocab)
    return None
