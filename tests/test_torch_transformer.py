"""Parity of the port's transformer LM (mxnet_tpu_torch.parallel.
transformer) with the JAX package's `_local_forward` / `_local_loss`, on
the CPU, from the same JAX-initialised parameters.

The JAX functions call collectives over 'model', 'data' and 'sp', so
they run inside a shard_map over a 1 x 1 x 1 mesh; on one device the
ring is one hop and its merge is the identity.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel import transformer as jax_tfm
from mxnet_tpu.parallel._compat import shard_map
from mxnet_tpu_torch import context
from mxnet_tpu_torch.parallel import transformer as tfm

# float32 on both sides; the sums run in another order
RTOL, ATOL = 1e-4, 1e-5
B, T = 2, 16


def _jax_lm(cfg):
    mesh = make_mesh({'data': 1, 'sp': 1, 'model': 1},
                     devices=jax.devices()[:1])
    specs = jax_tfm.param_specs(cfg)
    tok = P('data', 'sp')
    fwd = shard_map(lambda p, t: jax_tfm._local_forward(cfg, p, t),
                    mesh=mesh, in_specs=(specs, tok), out_specs=tok,
                    check_vma=False)
    loss = shard_map(lambda p, t, y: jax_tfm._local_loss(cfg, p, t, y),
                     mesh=mesh, in_specs=(specs, tok, tok), out_specs=P(),
                     check_vma=False)
    return fwd, loss


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('use_flash', [False, True])
def test_lm_forward_and_loss_match_jax(use_flash):
    cfg = jax_tfm.lm_config(vocab=64, dim=32, heads=4, layers=2,
                            use_flash=use_flash)
    jparams = jax_tfm.init_params(cfg, jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg['vocab'], (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    fwd, loss = _jax_lm(cfg)
    ref_logits = np.asarray(fwd(jparams, jnp.asarray(tokens)))
    ref_loss = float(loss(jparams, jnp.asarray(tokens),
                          jnp.asarray(targets)))

    model = tfm.TransformerLM(
        tfm.lm_config(vocab=64, dim=32, heads=4, layers=2,
                      use_flash=use_flash),
        tfm.params_from_jax(_numpy_tree(jparams), device='cpu'))
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        logits = model(tt)
        nll = model.loss(tt, torch.from_numpy(targets).long())
    assert logits.shape == (B, T, cfg['vocab'])
    np.testing.assert_allclose(logits.numpy(), ref_logits,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(nll), ref_loss, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('use_flash', [False, True])
def test_train_step_matches_jax(use_flash):
    """Three SGD steps of the port's make_train_step against the JAX
    package's on a 1 x 1 x 1 mesh, from the same parameters: the loss of
    every step and every parameter after the last."""
    lr, steps = 0.1, 3
    cfg = jax_tfm.lm_config(vocab=64, dim=32, heads=4, layers=2,
                            use_flash=use_flash)
    mesh = make_mesh({'data': 1, 'sp': 1, 'model': 1},
                     devices=jax.devices()[:1])
    jparams = jax_tfm.place_params(
        jax_tfm.init_params(cfg, jax.random.PRNGKey(2)), cfg, mesh)
    # the JAX step donates its parameters: copy them out first
    model = tfm.TransformerLM(
        tfm.lm_config(vocab=64, dim=32, heads=4, layers=2,
                      use_flash=use_flash),
        tfm.params_from_jax(_numpy_tree(jparams), device='cpu'))
    rs = np.random.RandomState(5)
    tokens = rs.randint(0, cfg['vocab'], (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)

    jax_step = jax_tfm.make_train_step(cfg, mesh, lr=lr)
    step = tfm.make_train_step(model.cfg, lr=lr)
    tt = torch.from_numpy(tokens).long()
    ty = torch.from_numpy(targets).long()
    for i in range(steps):
        ref_loss, jparams = jax_step(jparams, jnp.asarray(tokens),
                                     jnp.asarray(targets))
        loss = step(model, tt, ty)
        np.testing.assert_allclose(float(loss), float(ref_loss),
                                   rtol=RTOL, atol=ATOL, err_msg=str(i))
    ref = _numpy_tree(jparams)
    for name in ('embed', 'ln_f'):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   ref[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for layer, lp in zip(model.layers, ref['layers']):
        for key, want in lp.items():
            np.testing.assert_allclose(getattr(layer, key).detach().numpy(),
                                       want, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


def test_train_step_updates_in_place_and_checks_its_config():
    cfg = tfm.lm_config(vocab=64, dim=32, heads=4, layers=1, use_flash=True)
    model = tfm.TransformerLM(cfg, tfm.init_params(
        cfg, torch.Generator().manual_seed(3), device='cpu'))
    rs = np.random.RandomState(6)
    tok = torch.from_numpy(rs.randint(0, 64, (B, T + 1))).long()
    before = model.layers[0].wqkv.detach().clone()
    storage = model.layers[0].wqkv.data_ptr()
    loss = tfm.make_train_step(cfg, lr=0.5)(model, tok[:, :-1], tok[:, 1:])
    assert not loss.requires_grad and np.isfinite(float(loss))
    wqkv = model.layers[0].wqkv
    assert wqkv.data_ptr() == storage
    assert torch.equal(wqkv.detach(), before - 0.5 * wqkv.grad)
    assert bool(wqkv.grad.abs().max() > 0)
    with pytest.raises(ValueError, match='built for'):
        tfm.make_train_step(dict(cfg, use_flash=False))(
            model, tok[:, :-1], tok[:, 1:])


def test_params_from_jax_keeps_names_shapes_and_values():
    cfg = jax_tfm.lm_config(vocab=64, dim=32, heads=4, layers=2)
    tree = _numpy_tree(jax_tfm.init_params(cfg, jax.random.PRNGKey(1)))
    port = tfm.params_from_jax(tree, device='cpu')
    flat_jax = jax.tree_util.tree_leaves_with_path(tree)
    assert len(port['layers']) == cfg['layers']
    for path, leaf in flat_jax:
        node = port
        for key in path:
            node = node[getattr(key, 'key', getattr(key, 'idx', None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    bf16 = tfm.params_from_jax(tree, dtype=torch.bfloat16, device='cpu')
    assert bf16['layers'][0]['wqkv'].dtype == torch.bfloat16


def test_init_params_matches_jax_layout():
    cfg = tfm.lm_config(vocab=64, dim=32, heads=4, layers=2)
    port = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                           device='cpu')
    ref = jax_tfm.init_params(cfg, jax.random.PRNGKey(0))
    assert sorted(port) == sorted(ref)
    for mine, theirs in zip(port['layers'], ref['layers']):
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: v.shape for k, v in theirs.items()}
    assert tuple(port['embed'].shape) == ref['embed'].shape
    assert torch.equal(port['ln_f'], torch.ones(cfg['dim']))
    std = float(port['layers'][0]['w1'].std())
    assert 0.015 < std < 0.025
    again = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    assert torch.equal(again['embed'], port['embed'])


def test_attention_dispatch():
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 8).astype(np.float32))
               for _ in range(3))
    full = tfm.attention(q, k, v, causal=True, impl='full')
    auto = tfm.attention(q, k, v, causal=True)
    assert torch.equal(full, auto)
    with pytest.raises(ValueError, match="impl='ring'"):
        tfm.attention(q, k, v, impl='ring')
    with pytest.raises(ValueError, match='must be'):
        tfm.attention(q, k, v, impl='nope')


def test_entry_points_without_device_need_cuda(monkeypatch):
    """No device and no CUDA: the entry points raise; they never fall
    back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = tfm.lm_config()
    tree = _numpy_tree(jax_tfm.init_params(cfg, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        context.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.params_from_jax(tree)
    assert context.resolve_device('cpu') == torch.device('cpu')
