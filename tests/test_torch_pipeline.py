"""The port's pipeline parallelism (mxnet_tpu_torch.parallel.pipeline, the
Gluon PipelinedStep and Module.fit(pipeline=)) against the JAX package,
on the CPU: the counterparts of tests/test_pipeline_train.py's pipelined
tests and of tests/test_parallel.py's pipeline tests, and the engine
(make_pipe_step_fn) training the transformer LM cut into stages against
the JAX engine given the same stage function.

The ranks are one spawn of four gloo processes
(tests/_torch_parallel_ranks.py, `pipeline_suite`); the JAX package runs
on the suite's virtual CPU devices in this process. Tolerances: the
trainers' parity is the JAX tests' (atol 3e-6, rtol 1e-4 against the
one-device fused step; the int8 and bf16 wires atol 1e-3, rtol 1e-2), a
re-created trainer or a second run of the same wire gives the same bits,
and the LM is held to the LM tests' float32 bound (rtol 1e-4, atol 1e-5,
tests/test_torch_transformer.py) against the JAX engine, and to the
trainers' against the port's one-device step.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import mxnet_tpu as jmx
from mxnet_tpu.parallel import pipeline as jpipe
from mxnet_tpu.parallel import transformer as jax_tfm
from mxnet_tpu.parallel.ring_attention import full_attention as jfull

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import pipeline as pp
from mxnet_tpu_torch.parallel import transformer as tfm

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import (PP_BATCH as BATCH, PP_FEAT as FEAT,
                                   PP_LM, PP_LM_HYPER, PP_LM_LR, PP_LM_MICRO,
                                   PP_LM_STEPS, PP_LM_WD, PP_OPT as OPT,
                                   pp_batches, pp_fit, pp_net, pp_pvals,
                                   pp_train)

TRAINER = dict(atol=3e-6, rtol=1e-4)
WIRE = dict(atol=1e-3, rtol=1e-2)
LM_TOL = dict(rtol=1e-4, atol=1e-5)
LM_B, LM_T = 4, 16


def _got(res, prefix, n):
    return [res['%s__%d' % (prefix, i)] for i in range(n)]


def _close(a_vals, b_vals, tol):
    assert len(a_vals) == len(b_vals)
    for i, (a, b) in enumerate(zip(a_vals, b_vals)):
        np.testing.assert_allclose(a, b, err_msg=str(i), **tol)


def _lm_tree():
    """The LM's parameters from numpy seeds (no jax.random bits):
    normal * 0.02, norm scales 1, the JAX tree's names."""
    rs = np.random.RandomState(31)
    D, V = PP_LM['dim'], PP_LM['vocab']
    H = PP_LM['mlp_mult'] * D

    def normal(*shape):
        return (rs.randn(*shape) * 0.02).astype(np.float32)

    tree = {'embed': normal(V, D), 'ln_f': np.ones(D, np.float32),
            'layers': []}
    for _ in range(PP_LM['layers']):
        tree['layers'].append({
            'ln1': np.ones(D, np.float32), 'wqkv': normal(D, 3 * D),
            'wo': normal(D, D), 'ln2': np.ones(D, np.float32),
            'w1': normal(D, H), 'w2': normal(H, D)})
    return tree


def _lm_tokens():
    rs = np.random.RandomState(7)
    tok = rs.randint(0, PP_LM['vocab'], (LM_B, LM_T + 1))
    return tok[:, :-1].astype(np.int64), tok[:, 1:].astype(np.int64)


def _seq_inputs():
    rs = np.random.RandomState(0)
    out = {'seq_x': rs.randn(8, 2, 6).astype(np.float32),
           'seq_g': rs.randn(8, 2, 6).astype(np.float32)}
    for s in range(4):
        out['seq_w%d' % s] = (rs.randn(6, 6) * 0.3).astype(np.float32)
        out['seq_b%d' % s] = (rs.randn(6) * 0.1).astype(np.float32)
    rs = np.random.RandomState(1)
    for s in range(4):
        out['learn_w%d' % s] = (np.eye(8) + rs.randn(8, 8) * 0.05) \
            .astype(np.float32)
    out['learn_x'] = rs.randn(16, 8).astype(np.float32)
    out['learn_t'] = (out['learn_x'] * 2.0).astype(np.float32)
    rs = np.random.RandomState(0)
    for s in range(4):
        out['grad_w%d' % s] = (np.eye(4) + rs.randn(4, 4) * 0.05) \
            .astype(np.float32)
    out['grad_x'] = rs.randn(16, 4).astype(np.float32)
    out['grad_t'] = out['grad_x'] * 2.0
    return out


@pytest.fixture(scope='module')
def pipe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipeline')
    tree = _lm_tree()
    tok, tgt = _lm_tokens()
    leaves = tfm.tree_leaves(tfm.tree_from_leaves(
        [tree['embed'], tree['ln_f']] +
        [lp[k] for lp in tree['layers'] for k in tfm._LAYER_KEYS]))
    inputs = {'lmp_%d' % i: a for i, a in enumerate(leaves)}
    inputs.update(lm_tok=tok, lm_tgt=tgt, **_seq_inputs())
    res = ranks.run(ranks.pipeline_suite, 4, tmp, **inputs)
    return res, inputs


@pytest.fixture(scope='module')
def jax_baseline():
    """The JAX package's one-device fused step: the parity reference."""
    with jmx.cpu():
        net, _, _ = pp_train(jmx, jmx.cpu(0))
    return pp_pvals(net)


# -- gluon fuse_step(pipeline=) ------------------------------------------------

def test_gluon_pipe_parity_2x2(pipe_run, jax_baseline):
    """dp x pipe = 2 x 2 against the JAX package's one-device step and its
    own pipelined program, on every rank; a rank holds half the stage
    body, and its replicated momenta mirror its weights."""
    res, _ = pipe_run
    n = len(jax_baseline)
    with jmx.cpu():
        jnet, _, _ = pp_train(jmx, [jmx.cpu(i) for i in range(4)],
                              pipeline=(2, 2))
    for r in res:
        _close(_got(r, 'g22', n), jax_baseline, TRAINER)
        _close(_got(r, 'g22', n), pp_pvals(jnet), TRAINER)
        param_b, state_b = r['g22_acct']
        assert param_b < r['repl_bytes']
        assert state_b == param_b


def test_gluon_pipe_4stage_parity(pipe_run, jax_baseline):
    """All four ranks as a 1 x 4 pipe, one body layer a stage."""
    res, _ = pipe_run
    for r in res:
        _close(_got(r, 'g14', len(jax_baseline)), jax_baseline, TRAINER)


def test_gluon_pipe_bulk_parity(pipe_run, jax_baseline):
    res, _ = pipe_run
    for r in res:
        _close(_got(r, 'g22b', len(jax_baseline)), jax_baseline, TRAINER)
        assert r['g22b_loss'].shape == (3, BATCH)


def test_gluon_pipe_zero_parity_and_residency(pipe_run, jax_baseline):
    res, _ = pipe_run
    for r in res:
        _close(_got(r, 'g22z', len(jax_baseline)), jax_baseline, TRAINER)
        param_b, state_b = r['g22z_acct']
        rep_param_b, rep_state_b = r['g22_acct']
        assert param_b == rep_param_b
        # the momentum buckets shard over dp = 2 (padding adds slack)
        assert state_b < rep_state_b
        assert state_b <= rep_state_b // 2 + 4096


def test_gluon_pipe_recreation_bitwise_same_key(pipe_run):
    """A re-created net and ZeRO trainer of the same architecture give
    the same bits, with the same computation fingerprint and step
    signatures (the JAX package's program key); torch compiles nothing,
    and the pipelined step puts nothing in exec_cache."""
    res, _ = pipe_run
    n = len([k for k in res[0] if k.startswith('g22z__')])
    for r in res:
        assert r['recreate_same_key']
        assert r['recreate_cache_entries'] == 0
        for a, b in zip(_got(r, 'g22z', n), _got(r, 'g22z2', n)):
            np.testing.assert_array_equal(a, b)


def test_gluon_pipe_sync_params_enables_eager_eval(pipe_run):
    """After sync_params every rank holds every stage's trained weights
    (the JAX package's two steps), the net runs eagerly, and the next
    step runs on the step function already built."""
    res, _ = pipe_run
    with jmx.cpu():
        jnet, _, _ = pp_train(jmx, [jmx.cpu(i) for i in range(4)],
                              pipeline=(2, 2), k=2)
    ref = pp_pvals(jnet)
    for r in res:
        _close(_got(r, 'sync', len(ref)), ref, TRAINER)
        assert tuple(r['eager_shape']) == (BATCH, ranks.PP_NCLS)
        assert r['resync_new_fns'] == 0


def test_gluon_pipe_int8_wire_parity_and_determinism(pipe_run,
                                                     jax_baseline):
    """MXNET_TPU_DIST_WIRE_DTYPE=int8|bf16 narrows the data-axis sum:
    each mode gives the same bits twice, differs from float32, and stays
    within the wire's noise of the one-device step."""
    res, _ = pipe_run
    n = len(jax_baseline)
    for r in res:
        fp = _got(r, 'g22', n)
        for wire in ('int8', 'bf16'):
            a, b = _got(r, 'w%s0' % wire, n), _got(r, 'w%s1' % wire, n)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            _close(a, jax_baseline, WIRE)
        assert not all(np.array_equal(x, y) for x, y in
                       zip(fp, _got(r, 'wint80', n)))


def test_gluon_pipe_env_knob(pipe_run):
    res, _ = pipe_run
    assert all(str(r['env_kind']) == 'PipelinedStep' for r in res)


def test_pipe_spec_validation(monkeypatch):
    assert pp.pipe_spec((2, 4)) == (2, 4)
    monkeypatch.delenv('MXNET_TPU_PIPE', raising=False)
    assert pp.pipe_spec(None) is None
    with pytest.raises(ValueError):
        pp.pipe_spec((1, 4))
    with pytest.raises(ValueError):
        pp.pipe_spec((2, 0))
    monkeypatch.setenv('MXNET_TPU_PIPE', '3')
    with pytest.raises(ValueError):
        pp.pipe_spec(None)
    assert jpipe.pipe_spec((3, 5)) == pp.pipe_spec((3, 5))


def test_bubble_fraction_math():
    assert pp.bubble_fraction(4, 1) == pytest.approx(3 / 4)
    assert pp.bubble_fraction(2, 6) == pytest.approx(1 / 7)
    for s, m in ((2, 2), (2, 4), (4, 8)):
        assert pp.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)


def test_gluon_pipe_rejections(pipe_run):
    """The JAX refusals, with its exception types: metric, ema_decay,
    checkpoint, mesh and interleave do not compose; loss=None; contexts
    that do not divide into stages; several contexts and no process
    group; and (on the ranks) a batch that does not divide by dp * M."""
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        net = pp_net(mx, [mx.cpu(i) for i in range(4)])
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd', dict(OPT))
        with pytest.raises(ValueError, match='does not compose'):
            mx.gluon.fuse_step(net, loss, tr, pipeline=(2, 2),
                               metric=mx.metric.Accuracy())
        with pytest.raises(ValueError, match='does not compose'):
            mx.gluon.fuse_step(net, loss, tr, pipeline=(2, 2),
                               ema_decay=0.9)
        for kw in (dict(checkpoint=object()), dict(interleave=True)):
            with pytest.raises(ValueError, match='does not compose'):
                mx.gluon.fuse_step(net, loss, tr, pipeline=(2, 2), **kw)
        with pytest.raises(ValueError, match='loss'):
            mx.gluon.fuse_step(net, None, tr, pipeline=(2, 2))
        with pytest.raises(MXNetError, match='processes'):
            mx.gluon.fuse_step(net, loss, tr, pipeline=(2, 2))
        net3 = pp_net(mx, [mx.cpu(i) for i in range(3)])
        tr3 = mx.gluon.Trainer(net3.collect_params(), 'sgd', dict(OPT))
        with pytest.raises(ValueError, match='divide'):
            mx.gluon.fuse_step(net3, loss, tr3, pipeline=(2, 2))
    res, _ = pipe_run
    for r in res:
        assert str(r['err_batch']).startswith('ValueError') and \
            'must divide' in str(r['err_batch'])


def test_gluon_pipe_heterogeneous_stages_rejected(pipe_run):
    """Structurally identical body layers with relu against tanh: the
    op-trace homogeneity check refuses them before a step runs stage 0's
    code on stage 1's weights."""
    res, _ = pipe_run
    for r in res:
        e = str(r['err_hetero'])
        assert e.startswith('ValueError') and 'different computation' in e


def test_gluon_pipe_aux_params_rejected(pipe_run):
    res, _ = pipe_run
    for r in res:
        e = str(r['err_aux'])
        assert e.startswith('ValueError') and 'grad_req=null' in e


@pytest.mark.parametrize('case,kind,text', [
    ('odd_run', 'ValueError', 'not divisible into 2 stages'),
    ('few_children', 'ValueError', 'at least one block per stage'),
    ('mp', 'ValueError', 'multi_precision'),
    ('loss_params', 'ValueError', 'own parameters'),
    ('trainer_params', 'ValueError', "exactly the net's parameters"),
    ('lr_mult', 'ValueError', 'diverging lr/wd')])
def test_gluon_pipe_partition_and_trainer_refusals(pipe_run, case, kind,
                                                   text):
    """The JAX PipelinedStep's other refusals, with its exception types:
    a run of identical children that does not split into the stages,
    fewer children than stages, multi_precision, a loss with parameters
    of its own, a trainer that does not own exactly the net's
    parameters, and one stacked group's lr diverging over the stages."""
    res, _ = pipe_run
    for r in res:
        e = str(r['err_' + case])
        assert e.startswith(kind) and text in e, e


@pytest.mark.parametrize('case,kind,text', [
    ('aux', 'MXNetError', 'auxiliary states'),
    ('fixed', 'MXNetError', 'fixed_param_names'),
    ('mp', 'MXNetError', 'multi_precision'),
    ('ckpt', 'ValueError', 'does not compose')])
def test_module_fit_pipeline_restrictions(pipe_run, case, kind, text):
    """fit(pipeline=)'s restrictions, the JAX package's: no auxiliary
    state, no fixed parameters, no multi_precision, no checkpoint=."""
    res, _ = pipe_run
    for r in res:
        e = str(r['err_mod_' + case])
        assert e.startswith(kind) and text in e, e


def test_moe_rejected_in_pipeline_mode(pipe_run):
    """MoE's counters are aux parameters: the pipelined schedule refuses
    them rather than drop their counts."""
    res, _ = pipe_run
    for r in res:
        e = str(r['err_moe'])
        assert e.startswith('ValueError') and 'grad_req=null' in e


def test_pipe_profiler_counters(pipe_run):
    res, _ = pipe_run
    for r in res:
        assert r['pipe_stat_pipe_dispatches'] == 2
        assert r['pipe_stat_pipe_steps'] == 2
        assert r['pipe_stat_pipe_stages'] == 2
        assert r['pipe_stat_pipe_num_micro'] == 2
        assert r['pipe_stat_pipe_microbatches'] == 4
        assert r['pipe_stat_pipe_bubble_frac'] == pytest.approx(
            jpipe.bubble_fraction(2, 2))
        assert r['pipe_stat_pipe_param_bytes_per_device'] > 0
        assert r['pipe_stat_pipe_state_bytes_per_device'] > 0
        assert 'pipe_dispatches=2' in str(r['summary'])
        assert r['lane_pipe_steps'] == 2
        assert 'moe_routed_tokens' in list(r['lane_moe_keys'])


# -- Module.fit(pipeline=) -----------------------------------------------------

@pytest.fixture(scope='module')
def module_baseline():
    with jmx.cpu():
        return pp_fit(jmx, jmx.cpu(0))


def _module_got(r, prefix, names):
    return {k: r['%s__%s' % (prefix, k)] for k in names}


def test_module_fit_pipeline_parity(pipe_run, module_baseline):
    res, _ = pipe_run
    for r in res:
        got = _module_got(r, 'm22', module_baseline)
        for k in module_baseline:
            np.testing.assert_allclose(module_baseline[k], got[k],
                                       err_msg=k, **TRAINER)


def test_module_fit_pipeline_bulk(pipe_run, module_baseline):
    res, _ = pipe_run
    for r in res:
        got = _module_got(r, 'm22b', module_baseline)
        for k in module_baseline:
            np.testing.assert_allclose(module_baseline[k], got[k],
                                       err_msg=k, **TRAINER)


def test_module_fit_pipeline_rejections(pipe_run):
    """monitor= does not compose (ValueError); a branching symbol does
    not partition (MXNetError)."""
    res, _ = pipe_run
    for r in res:
        assert str(r['err_monitor']).startswith('ValueError') and \
            'does not compose' in str(r['err_monitor'])
        e = str(r['err_branch'])
        assert e.startswith('MXNetError') and 'graph inputs' in e


def _bound_chain_module():
    sym = ranks.pp_chain_symbol(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[mx.io.DataDesc('data', (BATCH, FEAT))],
             label_shapes=[mx.io.DataDesc('softmax_label', (BATCH,))])
    mod.init_params()
    mod.init_optimizer(optimizer='sgd', optimizer_params=dict(OPT))
    return mod


def test_module_pipeline_rejects_dist_kvstore():
    """The pipelined step reduces over its own mesh only: a dist kvstore
    is refused, not silently left out of the step."""
    import types
    from mxnet_tpu_torch.module.pipeline_fit import ModulePipeTrainer
    with mx.cpu():
        mod = _bound_chain_module()
        mod._kvstore = types.SimpleNamespace(type='dist_sync')
        with pytest.raises(MXNetError, match='kvstore'):
            ModulePipeTrainer(mod, (2, 2))
        mod._kvstore = None
        with pytest.raises(MXNetError, match='divide'):
            ModulePipeTrainer(mod, (2, 2))
        mod._optimizer = mx.optimizer.Adam()
        with pytest.raises(MXNetError, match='SGD/NAG'):
            ModulePipeTrainer(mod, (2, 2))


def test_bucketing_module_fit_pipeline_unsupported():
    def gen(key):
        return ranks.pp_chain_symbol(mx), ('data',), ('softmax_label',)
    with mx.cpu():
        bmod = mx.mod.BucketingModule(gen, default_bucket_key=BATCH,
                                      context=mx.cpu())
        it = mx.io.NDArrayIter(np.zeros((BATCH, FEAT), np.float32),
                               np.zeros((BATCH,), np.float32),
                               batch_size=BATCH)
        with pytest.raises(NotImplementedError, match='only supported'):
            bmod.fit(it, num_epoch=1, pipeline=(2, 2))


# -- pipeline_run and the plain step (tests/test_parallel.py) ----------------

def test_pipeline_matches_sequential(pipe_run):
    """A four-stage pipeline_run equals the stages in sequence, and its
    gradients (the explicit drain) equal sequential autograd's."""
    res, inp = pipe_run
    x = torch.from_numpy(inp['seq_x']).requires_grad_()
    ws = [torch.from_numpy(inp['seq_w%d' % s]).requires_grad_()
          for s in range(4)]
    bs = [torch.from_numpy(inp['seq_b%d' % s]).requires_grad_()
          for s in range(4)]
    y = x
    for w, b in zip(ws, bs):
        y = torch.tanh(y @ w + b)
    grads = torch.autograd.grad((y * torch.from_numpy(inp['seq_g'])).sum(),
                                ws + bs + [x])
    for s, r in enumerate(res):
        np.testing.assert_allclose(r['run_out'], y.detach().numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r['run_gw'], grads[s].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r['run_gb'], grads[4 + s].numpy(),
                                   rtol=1e-5, atol=1e-6)
        gx = grads[8].numpy() if s == 0 else np.zeros_like(inp['seq_x'])
        np.testing.assert_allclose(r['run_gx'], gx, rtol=1e-5, atol=1e-6)


def test_pipeline_train_step_learns(pipe_run):
    res, _ = pipe_run
    for r in res:
        losses = r['learn_losses']
        assert losses[-1] < losses[0] * 0.2, losses[::10]
        np.testing.assert_array_equal(losses, res[0]['learn_losses'])


def test_pipeline_gradients_match_sequential(pipe_run):
    """Each stage's gradient (lr = 1: w - w_new) equals sequential
    autograd's: no psum scales it by the stage count."""
    res, inp = pipe_run
    ws = [jnp.asarray(inp['grad_w%d' % s]) for s in range(4)]
    x, t = jnp.asarray(inp['grad_x']), jnp.asarray(inp['grad_t'])

    def seq_loss(ws):
        y = x
        for w in ws:
            y = y @ w
        return jnp.mean((y - t) ** 2)

    g_ref = jax.grad(seq_loss)(ws)
    for s, r in enumerate(res):
        np.testing.assert_allclose(r['grad_pipe'], np.asarray(g_ref[s]),
                                   rtol=1e-4, atol=1e-5)


# -- the pipelined LM through make_pipe_step_fn ---------------------------------

def _jax_block(lp, x, use_flash):
    b, t, _ = x.shape
    heads = PP_LM['heads']
    dh = PP_LM['dim'] // heads
    h = jax_tfm._rmsnorm(x, lp[0])
    q, k, v = jnp.split(h @ lp[1], 3, axis=-1)

    def split(z):
        return z.reshape(b, t, heads, dh).transpose(0, 2, 1, 3)

    att = jfull(split(q), split(k), split(v), causal=True,
                use_flash=use_flash)
    x = x + att.transpose(0, 2, 1, 3).reshape(b, t, heads * dh) @ lp[2]
    h = jax_tfm._rmsnorm(x, lp[3])
    return x + jax.nn.gelu(h @ lp[4]) @ lp[5]


def _jax_lm_engine(inp, dp, S, use_flash):
    """The JAX engine (parallel/pipeline.make_pipe_step_fn) on dp x S
    virtual devices with the same stem, stage and head functions:
    (losses, stage leaves stacked (S, ...), stem and head leaves)."""
    per = PP_LM['layers'] // S
    n = len(tfm._LAYER_KEYS)
    leaves = [inp['lmp_%d' % i] for i in range(2 + n * PP_LM['layers'])]
    embed, ln_f, layer_leaves = leaves[0], leaves[1], leaves[2:]
    stage_rows = [layer_leaves[s * per * n:(s + 1) * per * n]
                  for s in range(S)]

    def stem_fn(ws, tokens, rng):
        return ws[0][tokens]

    def stage_fn(ws, x, rng):
        for i in range(per):
            x = _jax_block(ws[i * n:(i + 1) * n], x, use_flash)
        return x

    def head_fn(ws, x, targets, rng):
        logits = jax_tfm._rmsnorm(x, ws[0]) @ ws[1].T
        logp = jax.nn.log_softmax(logits, axis=-1)
        loss = -jnp.mean(jnp.take_along_axis(
            logp, targets[..., None].astype(jnp.int32), axis=-1))
        return (loss[None],), loss

    mesh = jpipe.make_pipe_mesh(jax.devices()[:dp * S], S)
    hyper = dict(PP_LM_HYPER, rescale=1.0 / dp)
    step = jax.jit(jpipe.make_pipe_step_fn(
        mesh, S, PP_LM_MICRO, stem_fn, stage_fn, head_fn, hyper))
    pipe_sh = NamedSharding(mesh, P('pipe'))
    repl = NamedSharding(mesh, P())
    stage_ws = [jax.device_put(jnp.stack([jnp.asarray(stage_rows[s][j])
                                          for s in range(S)]), pipe_sh)
                for j in range(per * n)]
    stem_ws = [jax.device_put(jnp.asarray(embed), repl)]
    head_ws = [jax.device_put(jnp.asarray(ln_f), repl),
               jax.device_put(jnp.asarray(embed), repl)]
    opt = jpipe.init_pipe_opt_state(mesh, None, S, stage_ws, stem_ws,
                                    head_ws)
    rng = jax.device_put(jax.random.PRNGKey(0), repl)
    n_leaf = len(stage_ws) + 3
    lrs, wds = [PP_LM_LR] * n_leaf, [PP_LM_WD] * n_leaf
    tok, tgt = jnp.asarray(inp['lm_tok']), jnp.asarray(inp['lm_tgt'])
    losses = []
    for _ in range(PP_LM_STEPS):
        leaves_out, stage_ws, stem_ws, head_ws, opt, rng = step(
            stage_ws, stem_ws, head_ws, opt, rng, tok, tgt, lrs, wds)
        losses.append(float(np.asarray(leaves_out[0])[0]))
    return (np.array(losses), [np.asarray(w) for w in stage_ws],
            [np.asarray(w) for w in stem_ws + head_ws])


def _port_one_device_lm(inp, S):
    """The port's one-device step of the same untied function (plain
    autograd on the whole batch, sgd_update_math): the stage leaves
    stacked as the pipelined run gathers them, stem and head, losses."""
    from mxnet_tpu_torch.optimizer import sgd_update_math
    cfg = tfm.lm_config(use_flash=True, **PP_LM)
    stem_fn, stage_fn, head_fn = tfm.pipe_lm_fns(cfg, S)
    stages, stem, head = tfm.pipe_lm_leaves(
        ranks._tree(inp, 'lmp_'), S)
    ws = [w.clone() for st in stages for w in st] + stem + head
    moms = [torch.zeros_like(w) for w in ws]
    per = len(stages[0])
    tok, tgt = (torch.from_numpy(inp[k]) for k in ('lm_tok', 'lm_tgt'))
    losses = []
    for _ in range(PP_LM_STEPS):
        leaves = [w.detach().requires_grad_() for w in ws]
        x = stem_fn(leaves[S * per:S * per + 1], tok, 0)
        for s in range(S):
            x = stage_fn(leaves[s * per:(s + 1) * per], x, 0)
        (loss,), total = head_fn(leaves[S * per + 1:], x, tgt, 0)
        grads = torch.autograd.grad(total, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            new = [sgd_update_math(w, g, m, PP_LM_LR, PP_LM_WD,
                                   momentum=PP_LM_HYPER['momentum'])
                   for w, g, m in zip(leaves, grads, moms)]
        ws = [w.detach() for w, _ in new]
        moms = [m for _, m in new]
    stacked = [np.stack([ws[s * per + j].numpy() for s in range(S)])
               for j in range(per)]
    return np.array(losses), stacked, [w.numpy() for w in ws[S * per:]]


def _lm_got(r, prefix, n_stage):
    return ([r['%s_stage%d' % (prefix, j)] for j in range(n_stage)],
            [r['%s_edge%d' % (prefix, j)] for j in range(3)])


@pytest.mark.parametrize('use_flash', [False, True])
def test_pipe_lm_2x2_matches_the_jax_engine(pipe_run, use_flash):
    """make_pipe_step_fn trains the LM (dim 32, 4 heads, 2 layers a
    stage) at dp x pipe = 2 x 2 as the JAX engine does given the same
    stem, stage and head functions; with use_flash the JAX stage runs
    its Pallas kernel in interpret mode and the port's the flash
    Function's plain version."""
    res, inp = pipe_run
    losses, stage_ref, edge_ref = _jax_lm_engine(inp, 2, 2, use_flash)
    prefix = 'lm22f%d' % int(use_flash)
    for r in res:
        np.testing.assert_allclose(r[prefix + '_losses'], losses, **LM_TOL)
        stage, edge = _lm_got(r, prefix, len(stage_ref))
        _close(stage, stage_ref, LM_TOL)
        _close(edge, edge_ref, LM_TOL)


def test_pipe_lm_matches_the_one_device_step(pipe_run):
    """The pipelined LM at 2 x 2, with ZeRO-1, in bulk and at 1 x 4
    against the port's one-device step of the same function."""
    res, inp = pipe_run
    for prefix, S in (('lm22f1', 2), ('lm22z', 2), ('lm22b', 2),
                      ('lm14', 4)):
        losses, stage_ref, edge_ref = _port_one_device_lm(inp, S)
        for r in res:
            np.testing.assert_allclose(r[prefix + '_losses_mean'], losses,
                                       err_msg=prefix, **TRAINER)
            stage, edge = _lm_got(r, prefix, len(stage_ref))
            _close(stage, stage_ref, TRAINER)
            _close(edge, edge_ref, TRAINER)


def test_pipe_lm_stage_params_from_jax_trees():
    """stack_stage_params and place_pipeline_params take the JAX
    package's numpy trees: the stacked rows are the stages' leaves."""
    tree = _lm_tree()
    rows = [{'w1': lp['w1'], 'ln1': lp['ln1']} for lp in tree['layers']]
    stacked = pp.stack_stage_params(rows)
    jstacked = jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in r.items()} for r in rows])
    for k in ('w1', 'ln1'):
        np.testing.assert_array_equal(stacked[k].numpy(),
                                      np.asarray(jstacked[k]))


# -- chip_smoke's planted faults of phase 32, in the engine ----------------------

@pytest.mark.parametrize('plant', ['clean', 'drop', 'double', 'unsummed'])
def test_planted_pipe_faults_fail_the_float32_update_gate(pipe_run, plant):
    """chip_smoke's phase-32 faults (microbatch 1's gradient dropped or
    counted twice, the stem and head gradients not summed over 'pipe')
    planted into the float32 pipelined LM at dp x pipe 2 x 2: its
    updates_within gate at MESH_UPDATE_RTOL fails each against the clean
    run on some rank, and passes the clean run."""
    res, _ = pipe_run
    oks = [bool(r['planted_%s' % plant]) for r in res]
    if plant == 'clean':
        assert all(oks)
    else:
        assert not all(oks), oks
