"""Random sampling operators: the counterpart of
mxnet_tpu/ops/random_ops.py, under the same names and aliases.

Each sampler draws from `op_ctx.rng`, the torch.Generator of the device
its output is made on (`random.generator`), with the JAX package's
parameters and dtypes: float32 samples by default, int32 multinomial
draws. The numbers differ from JAX's; their distributions do not.
"""
import torch

from .registry import register, astuple, asfloat
from ..base import parse_attr_value, torch_dtype


def _shape_dtype(attrs):
    shape = attrs.get('shape', ())
    shape = astuple(shape) if shape not in (None, '') else ()
    return shape, torch_dtype(attrs.get('dtype', None) or 'float32')


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws, one for each element of the tensor alpha."""
    return torch._standard_gamma(alpha, generator=gen)


def _reg_sampler(name, draw, aliases=()):
    def compute(attrs, inputs, auxs, op_ctx, _draw=draw):
        shape, dtype = _shape_dtype(attrs)
        return [_draw(attrs, op_ctx.rng, shape, op_ctx.device).to(dtype)], []
    register(name, input_names=(), needs_rng=True, aliases=aliases,
             simple=False)(compute)


def _uniform(attrs, gen, shape, device):
    low = asfloat(attrs.get('low', 0.0))
    high = asfloat(attrs.get('high', 1.0))
    return torch.rand(shape, generator=gen, device=device) * (high - low) \
        + low


def _normal(attrs, gen, shape, device):
    return torch.randn(shape, generator=gen, device=device) \
        * asfloat(attrs.get('scale', 1.0)) + asfloat(attrs.get('loc', 0.0))


def _gamma_draw(attrs, gen, shape, device):
    alpha = torch.full(shape, asfloat(attrs.get('alpha', 1.0)), device=device)
    return _gamma(gen, alpha) * asfloat(attrs.get('beta', 1.0))


def _exponential(attrs, gen, shape, device):
    return torch.empty(shape, device=device).exponential_(
        generator=gen) / asfloat(attrs.get('lam', 1.0))


def _poisson(attrs, gen, shape, device):
    lam = torch.full(shape, asfloat(attrs.get('lam', 1.0)), device=device)
    return torch.poisson(lam, generator=gen)


def _neg_binomial(attrs, gen, shape, device):
    k = asfloat(attrs.get('k', 1.0))
    p = asfloat(attrs.get('p', 1.0))
    lam = _gamma(gen, torch.full(shape, k, device=device)) * (1.0 - p) / p
    return torch.poisson(lam, generator=gen)


def _gen_neg_binomial(attrs, gen, shape, device):
    mu = asfloat(attrs.get('mu', 1.0))
    alpha = asfloat(attrs.get('alpha', 1.0))
    lam = _gamma(gen, torch.full(shape, 1.0 / alpha, device=device)) \
        * (mu * alpha)
    return torch.poisson(lam, generator=gen)


_reg_sampler('_random_uniform', _uniform,
             aliases=('uniform', 'random_uniform'))
_reg_sampler('_random_normal', _normal, aliases=('normal', 'random_normal'))
_reg_sampler('_random_gamma', _gamma_draw, aliases=('random_gamma',))
_reg_sampler('_random_exponential', _exponential,
             aliases=('random_exponential', 'exponential'))
_reg_sampler('_random_poisson', _poisson,
             aliases=('random_poisson', 'poisson'))
_reg_sampler('_random_negative_binomial', _neg_binomial,
             aliases=('random_negative_binomial', 'negative_binomial'))
_reg_sampler('_random_generalized_negative_binomial', _gen_neg_binomial,
             aliases=('random_generalized_negative_binomial',
                      'generalized_negative_binomial'))


def _multinomial_compute(attrs, inputs, auxs, op_ctx):
    data, = inputs
    shape = attrs.get('shape', 1)
    n = 1
    if shape not in (None, ''):
        for d in astuple(shape):
            n *= d
    get_prob = parse_attr_value(attrs.get('get_prob', False))
    probs = torch.clamp(data.float(), min=1e-37)
    rows = probs.reshape(-1, data.shape[-1])
    out = torch.multinomial(rows, n, replacement=True, generator=op_ctx.rng)
    out = out.reshape(tuple(data.shape[:-1]) + (n,))
    if data.ndim == 1:
        out = out.reshape((n,)) if n > 1 else out.reshape(())
    out = out.to(torch_dtype(attrs.get('dtype', None) or 'int32'))
    if get_prob:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        lp = torch.gather(logp, -1, out.reshape(
            tuple(data.shape[:-1]) + (-1,)).long())
        return [out, lp.reshape(out.shape)], []
    return [out], []


register('_sample_multinomial', input_names=('data',), needs_rng=True,
         num_outputs=lambda attrs: 2 if parse_attr_value(
             attrs.get('get_prob', False)) else 1,
         aliases=('sample_multinomial', 'multinomial'),
         simple=False)(_multinomial_compute)


# ---------------------------------------------------------------------------
# Multi-distribution samplers (reference multisample_op.cc): one
# distribution per element of the parameter tensors, `shape` samples of
# each, appended to the parameters' shape
# ---------------------------------------------------------------------------

def _reg_msampler(name, input_names, draw):
    def compute(attrs, inputs, auxs, op_ctx, _draw=draw):
        shape = attrs.get('shape', ())
        extra = astuple(shape) if shape not in (None, '', ()) else ()
        full = tuple(inputs[0].shape) + tuple(extra)
        dtype = torch_dtype(attrs.get('dtype', None) or 'float32')
        params = [torch.broadcast_to(
            p.reshape(tuple(p.shape) + (1,) * len(extra)), full)
            for p in inputs]
        return [_draw(op_ctx.rng, params, full).to(dtype)], []
    register(name, input_names=input_names, needs_rng=True,
             simple=False)(compute)


def _rand_like(gen, shape, like):
    return torch.rand(shape, generator=gen, device=like.device,
                      dtype=like.dtype)


_reg_msampler('sample_uniform', ('low', 'high'),
              lambda gen, p, shape: _rand_like(gen, shape, p[0])
              * (p[1] - p[0]) + p[0])

_reg_msampler('sample_normal', ('mu', 'sigma'),
              lambda gen, p, shape: torch.randn(
                  shape, generator=gen, device=p[0].device,
                  dtype=p[0].dtype) * p[1] + p[0])

_reg_msampler('sample_gamma', ('alpha', 'beta'),
              lambda gen, p, shape: _gamma(gen, p[0].contiguous()) * p[1])

_reg_msampler('sample_exponential', ('lam',),
              lambda gen, p, shape: torch.empty(
                  shape, device=p[0].device, dtype=p[0].dtype).exponential_(
                      generator=gen) / p[0])

_reg_msampler('sample_poisson', ('lam',),
              lambda gen, p, shape: torch.poisson(p[0].contiguous(),
                                                  generator=gen))


def _msample_neg_binomial(gen, p, shape):
    k, prob = p
    lam = _gamma(gen, k.contiguous()) * (1.0 - prob) / prob
    return torch.poisson(lam, generator=gen)


_reg_msampler('sample_negative_binomial', ('k', 'p'), _msample_neg_binomial)


def _msample_gen_neg_binomial(gen, p, shape):
    mu, alpha = p
    lam = _gamma(gen, (1.0 / alpha).contiguous()) * (mu * alpha)
    return torch.poisson(lam, generator=gen)


_reg_msampler('sample_generalized_negative_binomial', ('mu', 'alpha'),
              _msample_gen_neg_binomial)
