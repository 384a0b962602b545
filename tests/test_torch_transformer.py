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


@pytest.mark.parametrize('dim,heads', [(384, 2), (300, 3)])
def test_lm_wide_and_ragged_heads_match_jax(dim, heads):
    """head_dim 192 (over 128) and 100 (not a multiple of 8) on the flash
    path, against the JAX LM with its Pallas kernel in interpret mode."""
    cfg = jax_tfm.lm_config(vocab=64, dim=dim, heads=heads, layers=1,
                            use_flash=True)
    jparams = jax_tfm.init_params(cfg, jax.random.PRNGKey(1))
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, cfg['vocab'], (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    fwd, loss = _jax_lm(cfg)
    ref_logits = np.asarray(fwd(jparams, jnp.asarray(tokens)))
    ref_loss = float(loss(jparams, jnp.asarray(tokens),
                          jnp.asarray(targets)))
    model = tfm.TransformerLM(
        tfm.lm_config(vocab=64, dim=dim, heads=heads, layers=1,
                      use_flash=True),
        tfm.params_from_jax(_numpy_tree(jparams), device='cpu'))
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        logits = model(tt)
        nll = model.loss(tt, torch.from_numpy(targets).long())
    assert dim // heads in (192, 100)
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


# -- the sharded step: eight ranks of a gloo group on the CPU -----------------

STEP_CFG = dict(vocab=64, dim=32, heads=4, layers=2, mlp_mult=4)
STEP_LR, STEP_STEPS = 0.1, 2
# the port's sharded step against the JAX sharded program with the
# corrected layout: float32 on both sides, other summing orders
STEP_RTOL, STEP_ATOL = 1e-5, 1e-7


def _step_inputs():
    cfg = jax_tfm.lm_config(**STEP_CFG)
    tree = _numpy_tree(jax_tfm.init_params(cfg, jax.random.PRNGKey(7)))
    leaves = tfm.tree_leaves(tree)
    rs = np.random.RandomState(8)
    tok = rs.randint(0, STEP_CFG['vocab'], (4, 17)).astype(np.int32)
    inputs = {'p_%d' % i: w for i, w in enumerate(leaves)}
    inputs.update({'cfg_' + k: v for k, v in STEP_CFG.items()})
    inputs.update(tokens=tok[:, :-1], targets=tok[:, 1:], steps=STEP_STEPS,
                  lr=STEP_LR)
    return tree, inputs


@pytest.fixture(scope='module')
def sharded_run(tmp_path_factory):
    import _torch_parallel_ranks as ranks
    tree, inputs = _step_inputs()
    res = ranks.run(ranks.step_suite, 8, tmp_path_factory.mktemp('step'),
                    **inputs)
    return tree, inputs, res


def _qkv_order(dim, model):
    """Column order of wqkv that gives JAX's contiguous model shard s
    [q_s | k_s | v_s], the heads of shard s."""
    blk = dim // model
    return np.concatenate([np.arange(s * blk, (s + 1) * blk) + part * dim
                           for s in range(model) for part in range(3)])


def _jax_sharded(tree, shape, use_flash, tokens, targets, lr, steps,
                 correct=True):
    """The JAX package's sharded program from the global `tree`; with
    `correct`, its wqkv columns ordered so that each model shard holds its
    own heads' q, k and v, at lr / mesh size (ROADMAP Queue C, findings in
    the JAX package). Returns the losses and the global tree after."""
    n = int(np.prod(list(shape.values())))
    mesh = make_mesh(shape, devices=jax.devices()[:n])
    cfg = jax_tfm.lm_config(use_flash=use_flash, **STEP_CFG)
    order = _qkv_order(cfg['dim'], shape['model'])
    tree = jax.tree_util.tree_map(np.array, tree)
    if correct:
        for lp in tree['layers']:
            lp['wqkv'] = lp['wqkv'][:, order]
    params = jax_tfm.place_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                  cfg, mesh)
    step = jax_tfm.make_train_step(cfg, mesh, lr=lr / n if correct else lr)
    losses = []
    for _ in range(steps):
        loss, params = step(params, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    out = _numpy_tree(params)
    if correct:
        for lp in out['layers']:
            back = np.empty_like(lp['wqkv'])
            back[:, order] = lp['wqkv']
            lp['wqkv'] = back
    return np.array(losses), out


STEP_CASES = [(tag, flash) for tag in ('222', '141') for flash in (False,
                                                                    True)]


def _shape(tag):
    return dict(zip(('data', 'sp', 'model'), (int(c) for c in tag)))


@pytest.mark.parametrize('tag,use_flash', STEP_CASES)
def test_sharded_step_matches_the_corrected_jax_program(sharded_run, tag,
                                                        use_flash):
    """The port's step at dp x sp x tp = (2, 2, 2) and (1, 4, 1), plain and
    on the flash ring, two steps against the JAX sharded program with each
    model shard's own heads and lr / mesh size: every loss and every
    gathered parameter."""
    tree, inputs, res = sharded_run
    key = '%s_%s' % (tag, 'flash' if use_flash else 'plain')
    losses, want = _jax_sharded(tree, _shape(tag), use_flash,
                                inputs['tokens'], inputs['targets'],
                                STEP_LR, STEP_STEPS)
    np.testing.assert_allclose(res[0]['loss_' + key], losses,
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    for i, ref in enumerate(tfm.tree_leaves(want)):
        np.testing.assert_allclose(res[0]['w_%s_%d' % (key, i)], ref,
                                   rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg='leaf %d' % i)


@pytest.mark.parametrize('tag,use_flash', STEP_CASES)
def test_sharded_step_equals_the_one_device_step(sharded_run, tag,
                                                 use_flash):
    """Every rank of the mesh reports the same loss, and the gathered
    parameters equal the port's one-device step's from the same tree."""
    _, _, res = sharded_run
    key = '%s_%s' % (tag, 'flash' if use_flash else 'plain')
    on_mesh = 8 if tag == '222' else 4
    for r in range(on_mesh):
        np.testing.assert_array_equal(res[r]['loss_' + key],
                                      res[0]['loss_' + key])
        for i in range(2 + 6 * STEP_CFG['layers']):
            np.testing.assert_array_equal(res[r]['w_%s_%d' % (key, i)],
                                          res[0]['w_%s_%d' % (key, i)])
    np.testing.assert_allclose(res[0]['loss_' + key], res[0]['loss_one'],
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    for i in range(2 + 6 * STEP_CFG['layers']):
        np.testing.assert_allclose(res[0]['w_%s_%d' % (key, i)],
                                   res[0]['w_one_%d' % i], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg='leaf %d' % i)


def test_place_params_gives_each_model_shard_its_heads(sharded_run):
    tree, _, res = sharded_run
    w = tree['layers'][0]['wqkv']
    d = STEP_CFG['dim']
    for r in range(8):
        s = int(res[r]['coord_222'][2])         # the model index
        cols = slice(s * d // 2, (s + 1) * d // 2)
        want = np.concatenate([w[:, :d][:, cols], w[:, d:2 * d][:, cols],
                               w[:, 2 * d:][:, cols]], axis=1)
        np.testing.assert_array_equal(res[r]['wqkv_local_222'], want)
    specs = tfm.param_specs(tfm.lm_config(**STEP_CFG))
    ref = jax_tfm.param_specs(jax_tfm.lm_config(**STEP_CFG))
    assert tuple(specs['layers'][0]['wqkv']) == \
        tuple(ref['layers'][0]['wqkv'])
    assert {k: tuple(v) for k, v in specs['layers'][1].items()} == \
        {k: tuple(v) for k, v in ref['layers'][1].items()}


def test_jax_sharded_step_departures(sharded_run):
    """The two faults of the JAX package's sharded step that the port does
    not copy, beside the port's agreement with the one-device step: at
    {'data': 2} the JAX update is twice the one-device update, and at
    {'model': 2} the JAX loss is another function's (shard 0's wqkv
    columns are q's first heads and part of k)."""
    tree, inputs, res = sharded_run
    tok, tgt = inputs['tokens'], inputs['targets']
    one_loss, one = _jax_sharded(tree, _shape('111'), False, tok, tgt,
                                 STEP_LR, 1, correct=False)
    _, dp = _jax_sharded(tree, _shape('211'), False, tok, tgt, STEP_LR, 1,
                         correct=False)
    tp_loss, _ = _jax_sharded(tree, _shape('112'), False, tok, tgt, STEP_LR,
                              1, correct=False)
    for w0, w1, w2 in zip(tfm.tree_leaves(tree), tfm.tree_leaves(one),
                          tfm.tree_leaves(dp)):
        ratio = np.linalg.norm(w2 - w0) / np.linalg.norm(w1 - w0)
        np.testing.assert_allclose(ratio, 2.0, rtol=1e-3)
    assert abs(tp_loss[0] - one_loss[0]) > 1e-4
    # the port: its sharded step's first loss and update are the
    # one-device step's
    np.testing.assert_allclose(res[0]['loss_222_plain'][0], one_loss[0],
                               rtol=STEP_RTOL, atol=STEP_ATOL)
