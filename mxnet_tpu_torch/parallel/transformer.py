"""Transformer LM on one device: the counterpart of
mxnet_tpu/parallel/transformer.py at tp = sp = dp = 1.

The block is the JAX package's own: pre-norm RMSNorm (eps inside the
rsqrt, no mean subtraction), fused QKV projection, causal attention with
no position embedding, tanh-approximated GELU MLP, no biases, and the
output projection tied to the input embedding. Parameters keep the JAX
tree's names and shapes, so `params_from_jax` loads a JAX tree as it is.

`TransformerLM.forward` scores a batch of token sequences (logits) and
`TransformerLM.loss` gives the mean next-token NLL: the serving path.
Training (`make_train_step`) comes with the attention backward kernels.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from .ring_attention import full_attention

_LAYER_KEYS = ('ln1', 'wqkv', 'wo', 'ln2', 'w1', 'w2')


def attention(q, k, v, causal=False, scale=None, impl='auto',
              use_flash=False):
    """Attention dispatch of the JAX package's `attention`, on one
    device: 'auto' and 'full' take `full_attention`; 'ring' needs a
    sequence-parallel group, which one device does not have, and raises
    as the JAX package does without an 'sp' mesh."""
    if impl not in ('auto', 'ring', 'full'):
        raise ValueError("attention impl must be 'auto', 'ring' or "
                         "'full', got %r" % (impl,))
    if impl == 'ring':
        raise ValueError(
            "attention(impl='ring'): needs a sequence-parallel group of "
            "more than one device dividing T, and identical 4-D q/k/v; "
            "this port runs on one device; got q=%s k=%s v=%s"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    return full_attention(q, k, v, causal=causal, scale=scale,
                          use_flash=use_flash)


def lm_config(vocab=64, dim=32, heads=4, layers=2, mlp_mult=4,
              use_flash=False):
    """The JAX package's config dict. use_flash routes attention through
    the flash kernel (cuda_ops)."""
    return dict(vocab=vocab, dim=dim, heads=heads, layers=layers,
                mlp_mult=mlp_mult, head_dim=dim // heads,
                use_flash=use_flash)


def init_params(cfg, generator=None, dtype=torch.float32, device=None):
    """Parameter tree with the JAX `init_params` names and shapes:
    weights normal * 0.02, norm scales one. Numbers are drawn on the CPU
    from `generator` (a CPU torch.Generator), then moved; they differ
    from JAX's for the same seed."""
    device = resolve_device(device)
    D, V, H = cfg['dim'], cfg['vocab'], cfg['mlp_mult'] * cfg['dim']

    def normal(*shape):
        w = torch.randn(shape, generator=generator) * 0.02
        return w.to(device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    params = {'embed': normal(V, D), 'ln_f': ones(D), 'layers': []}
    for _ in range(cfg['layers']):
        params['layers'].append({
            'ln1': ones(D), 'wqkv': normal(D, 3 * D), 'wo': normal(D, D),
            'ln2': ones(D), 'w1': normal(D, H), 'w2': normal(H, D)})
    return params


def params_from_jax(tree, dtype=None, device=None):
    """The JAX parameter tree `{'embed', 'ln_f', 'layers': [{'ln1',
    'wqkv', 'wo', 'ln2', 'w1', 'w2'}]}`, as numpy arrays, to the port's
    tree on `device`. No weight is transposed or permuted: the columns
    of wqkv are q | k | v, each head-major, as the JAX forward splits
    them. dtype None keeps each array's own."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a))   # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return {'embed': conv(tree['embed']), 'ln_f': conv(tree['ln_f']),
            'layers': [{key: conv(lp[key]) for key in _LAYER_KEYS}
                       for lp in tree['layers']]}


def _rmsnorm(x, scale):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


class _Block(nn.Module):
    def __init__(self, lp):
        super().__init__()
        for key in _LAYER_KEYS:
            self.register_parameter(key, nn.Parameter(lp[key]))

    def forward(self, x, heads, head_dim, use_flash):
        b, t, _ = x.shape
        h = _rmsnorm(x, self.ln1)
        q, k, v = (h @ self.wqkv).chunk(3, dim=-1)

        def split_heads(z):
            return z.reshape(b, t, heads, head_dim).transpose(1, 2)

        att = full_attention(split_heads(q), split_heads(k), split_heads(v),
                             causal=True, use_flash=use_flash)
        att = att.transpose(1, 2).reshape(b, t, heads * head_dim)
        x = x + att @ self.wo
        h = _rmsnorm(x, self.ln2)
        y = F.gelu(h @ self.w1, approximate='tanh')   # jax.nn.gelu's default
        return x + y @ self.w2


class TransformerLM(nn.Module):
    """The LM of `cfg` (lm_config) over a parameter tree from
    `init_params` or `params_from_jax`; it runs where the tree lies."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = dict(cfg)
        self.embed = nn.Parameter(params['embed'])
        self.ln_f = nn.Parameter(params['ln_f'])
        self.layers = nn.ModuleList(_Block(lp) for lp in params['layers'])

    def forward(self, tokens):
        """tokens (batch, seq) int64 -> logits (batch, seq, vocab) in the
        parameters' dtype."""
        cfg = self.cfg
        x = self.embed[tokens]
        for block in self.layers:
            x = block(x, cfg['heads'], cfg['head_dim'], cfg['use_flash'])
        x = _rmsnorm(x, self.ln_f)
        return x @ self.embed.t()

    def loss(self, tokens, targets):
        """Mean next-token NLL of `targets` (counterpart of the JAX
        `_local_loss`)."""
        return nll(self.forward(tokens), targets)


def nll(logits, targets):
    """Mean negative log-likelihood of `targets` (batch, seq) under
    `logits` (batch, seq, vocab), taken in float32."""
    return F.cross_entropy(logits.float().flatten(0, 1), targets.flatten())
