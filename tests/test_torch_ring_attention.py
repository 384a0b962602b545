"""The port's ring attention (mxnet_tpu_torch.parallel.ring_attention)
against the JAX package's, on the CPU: four ranks of a gloo group (one
spawn shared by the file's checks) run ring_self_attention over an sp
axis of 4, plain and on the flash kernels' plain versions, causal and
not, and the parent holds every rank's output and its gradients in q, k
and v against JAX's ring_self_attention (its Pallas ring in interpret
mode for use_flash) under jax.grad on four virtual CPU devices, at the
JAX package's own tolerance (tests/test_parallel.py)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel.ring_attention import (ring_self_attention,
                                               full_attention)
from mxnet_tpu_torch.parallel.ring_attention import (
    ring_attention as port_ring_attention)
from mxnet_tpu_torch.parallel import transformer as tfm

import _torch_parallel_ranks as ranks

SP = 4
TOL = dict(rtol=2e-4, atol=2e-5)
B, H, T, D = 1, 2, 64, 8
RS = np.random.RandomState(2)
INPUTS = {n: (RS.randn(B, H, T, D) * (0.3 if n == 'g' else 0.4)
              ).astype(np.float32) for n in 'qkvg'}
# __graft_entry__.dryrun_multichip phase (j): B, H, T, D = 2, 2, 16 * sp, 8
INPUTS['qkv_j'] = np.random.RandomState(13).randn(
    3, 2, 2, 16 * SP, 8).astype(np.float32)


@pytest.fixture(scope='module')
def ring_run(tmp_path_factory):
    return ranks.run(ranks.ring_suite, SP, tmp_path_factory.mktemp('ring'),
                     **INPUTS)


def _jax_ring(use_flash, causal):
    mesh = make_mesh({'sp': SP}, devices=jax.devices()[:SP])
    g = jnp.asarray(INPUTS['g'])

    def loss(q, k, v):
        out = ring_self_attention(q, k, v, mesh, seq_axis='sp',
                                  causal=causal, use_flash=use_flash)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(INPUTS[n]) for n in 'qkv'))
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('causal', [False, True])
def test_ring_matches_jax_outputs_and_gradients(ring_run, use_flash,
                                                causal):
    tag = '%s_%s' % ('flash' if use_flash else 'plain',
                     'causal' if causal else 'full')
    want = _jax_ring(use_flash, causal)
    for rank, res in enumerate(ring_run):
        for name, ref in zip(('out', 'dq', 'dk', 'dv'), want):
            np.testing.assert_allclose(res['%s_%s' % (name, tag)], ref,
                                       err_msg='rank %d %s' % (rank, name),
                                       **TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_ring_hops_per_rank(ring_run, causal):
    """Under causal masking sp-rank i works i + 1 hops (a block after
    its queries runs nothing); without it every rank works all n."""
    for rank, res in enumerate(ring_run):
        for kind in ('plain', 'flash'):
            hops = int(res['hops_%s_%s' % (kind, 'causal' if causal
                                           else 'full')])
            assert hops == (rank + 1 if causal else SP)


def test_a_ring_of_one_hop_is_full_attention(ring_run):
    g = jnp.asarray(INPUTS['g'])

    def loss(q, k, v):
        out = full_attention(q, k, v, causal=True)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(INPUTS[n]) for n in 'qkv'))
    for res in ring_run:
        for name, ref in zip(('one_out', 'one_dq', 'one_dk', 'one_dv'),
                             [out] + list(grads)):
            np.testing.assert_allclose(res[name], np.asarray(ref),
                                       err_msg=name, **TOL)


def test_ring_on_two_dimensional_shards(ring_run):
    q, k, v = (jnp.asarray(INPUTS[n][0, 0]) for n in 'qkv')
    want = np.asarray(full_attention(q, k, v, causal=True))
    t = T // SP
    for rank, res in enumerate(ring_run):
        np.testing.assert_allclose(res['ring_2d'],
                                   want[rank * t:(rank + 1) * t], **TOL)


def test_attention_dispatch_runs_the_ring_on_the_mesh(ring_run):
    """attention(impl='ring') on the current mesh against impl='full', at
    dryrun_multichip phase (j)'s shape and bound, and against the JAX
    package's full_attention."""
    qkv = [jnp.asarray(a) for a in INPUTS['qkv_j']]
    ref = np.asarray(full_attention(*qkv, causal=True))
    for res in ring_run:
        np.testing.assert_allclose(res['attn_ring'], res['attn_full'],
                                   atol=2e-6, rtol=1e-6)
        np.testing.assert_array_equal(res['attn_auto'], res['attn_ring'])
        np.testing.assert_allclose(res['attn_full'], ref, **TOL)


def test_ring_needs_a_mesh_and_one_shape():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match='use_mesh'):
        port_ring_attention(q, q, q, 'sp')
    with pytest.raises(ValueError, match="impl='ring'"):
        tfm.attention(q, q, q, impl='ring')


# -- chip_smoke.py's gate of phase 27 -------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


def _ring_rows():
    """Four ranks' rows as phase 27 writes them, all within the gate."""
    layers, steps = CS.GPT2_MEDIUM['layers'], CS.MESH_RING_STEPS
    ok = dict(ok=True, max_abs_err=0.0)
    rows = []
    for rank in range(4):
        sp = rank // 2
        n = layers * (sp + 1)
        rows.append(dict(
            rank=rank, coordinate=dict(data=0, sp=sp, model=rank % 2),
            backend='gloo', staged=True, loss=11.0382,
            launches_per_step=[[n] * 3] * steps, launches=[n * steps] * 3,
            staged_bytes_per_step=4.8e9,
            fp32_launches=[CS.FP32_LAYERS * (sp + 1)] * 3,
            hop=dict(out=ok, dq=ok, dk=ok, dv=ok, lse_ok=True,
                     lse_max_abs_err=0.0),
            ring_vs_full=dict(plain=ok, flash=ok)))
        if sp:
            rows[-1]['past_hop'] = dict(out=ok, dq=ok, dk=ok, dv=ok,
                                        lse_ok=True, lse_max_abs_err=0.0)
    rows[0].update(one_device_loss=11.0380, fp32_params=dict(ok=True),
                   fp32_updates=dict(ok=True))
    return rows


def _break_launches(rows):
    rows[2]['launches_per_step'][0] = [24, 24, 24]


def _break_kernel(rows):
    rows[3]['hop']['dk'] = dict(ok=False, max_abs_err=1.0)


RING_FAULTS = {
    'launches': _break_launches,
    'loss_differs_across_ranks': lambda rows: rows[1].update(loss=11.04),
    'loss_off_one_device': lambda rows: rows[0].update(
        one_device_loss=11.05),
    'fp32_params': lambda rows: rows[0].update(fp32_params=dict(ok=False)),
    'fp32_launches': lambda rows: rows[2].update(fp32_launches=[4, 4, 4]),
    'not_staged': lambda rows: rows[1].update(staged=False),
    'nccl': lambda rows: rows[0].update(backend='nccl'),
    'hop_kernel': _break_kernel,
    'hop_lse': lambda rows: rows[0]['hop'].update(lse_ok=False),
    'past_hop_kernel': lambda rows: rows[2]['past_hop'].update(
        dv=dict(ok=False, max_abs_err=1.0)),
    'past_hop_lse': lambda rows: rows[3]['past_hop'].update(lse_ok=False),
    'past_hop_unchecked': lambda rows: rows[3].pop('past_hop'),
    'fp32_updates': lambda rows: rows[0].update(
        fp32_updates=dict(ok=False)),
    'ring_vs_full': lambda rows: rows[1]['ring_vs_full'].update(
        plain=dict(ok=False, max_abs_err=1e-3)),
}


def test_phase_27_gate_passes_a_good_run():
    assert CS.ring_gate(_ring_rows()) == []


@pytest.mark.parametrize('fault', sorted(RING_FAULTS))
def test_phase_27_gate_fails_each_fault(fault):
    rows = _ring_rows()
    RING_FAULTS[fault](rows)
    assert CS.ring_gate(rows)


def test_phase_26_parameter_check_bounds_each_element():
    ref = [torch.tensor([1.0, -2.0, 0.5]), torch.tensor([4.0])]
    same = CS.leaves_within(torch, [t.clone() for t in ref], ref,
                            CS.MESH_W_RTOL, 0.0)
    assert same['ok'] and same['bit_equal'] and same['share_differ'] == 0
    step = [ref[0] * (1 + CS.MESH_W_RTOL), ref[1].clone()]
    one = CS.leaves_within(torch, step, ref, CS.MESH_W_RTOL, 0.0)
    assert one['ok'] and not one['bit_equal']
    assert one['share_differ'] == 0.75
    two = CS.leaves_within(torch, [ref[0], ref[1] * (1 + 3 * CS.MESH_W_RTOL)],
                           ref, CS.MESH_W_RTOL, 0.0)
    assert not two['ok']


def test_update_check_bounds_each_leaf_by_its_largest_update():
    """updates_within: the update new - old against ref - old, within
    rtol of the leaf's largest reference update plus one float32 rounding
    of the weight."""
    old = [torch.tensor([0.02, -0.01, 0.03]), torch.tensor([1.0, 1.0])]
    upd = [torch.tensor([1e-3, -2e-3, 5e-4]), torch.tensor([4e-2, 0.0])]
    ref = [o - u for o, u in zip(old, upd)]
    rtol = CS.MESH_UPDATE_RTOL
    same = CS.updates_within(torch, [r.clone() for r in ref], old, ref, rtol)
    assert same['ok'] and same['max_err_of_leaf_update'] == 0
    # within rtol of the leaf's largest update (2e-3), not of the element's
    near = [ref[0] + torch.tensor([0.0, 0.0, 0.9 * rtol * 2e-3]), ref[1]]
    assert CS.updates_within(torch, near, old, ref, rtol)['ok']
    far = [ref[0] + torch.tensor([0.0, 0.0, 1.5 * rtol * 2e-3]), ref[1]]
    assert not CS.updates_within(torch, far, old, ref, rtol)['ok']
    # one float32 rounding of a weight of 1.0 passes; the update skipped
    # does not
    ulp = [ref[0], ref[1] + torch.tensor([0.0, 2.0 ** -23])]
    assert CS.updates_within(torch, ulp, old, ref, rtol)['ok']
    skipped = CS.updates_within(torch, [o.clone() for o in old], old, ref,
                                rtol)
    assert not skipped['ok'] and skipped['max_err_of_leaf_update'] == 1


# -- the float32 update gate on a CPU rehearsal of phase 27's step -------------

GATE_CFG = dict(vocab=64, dim=32, heads=4, layers=2, mlp_mult=4)


@pytest.fixture(scope='module')
def gate_run(tmp_path_factory):
    cfg = tfm.lm_config(use_flash=True, **GATE_CFG)
    tree = CS.seeded_tree(cfg, CS.SEED + 3)
    tok = np.random.default_rng(CS.SEED + 1).integers(0, cfg['vocab'],
                                                      (2, 17))
    inputs = {'p_%d' % i: np.asarray(a) for i, a in
              enumerate(tfm.tree_leaves(tree))}
    inputs.update({'cfg_' + k: v for k, v in GATE_CFG.items()},
                  tokens=tok[:, :-1], targets=tok[:, 1:], lr=CS.LR)
    return ranks.run(ranks.gate_suite, 4, tmp_path_factory.mktemp('gate'),
                     **inputs), [np.asarray(a) for a in
                                 tfm.tree_leaves(tree)]


@pytest.mark.parametrize('fault', ranks.GATE_FAULTS)
def test_update_gate_fails_planted_faults(gate_run, fault):
    """chip_smoke.py's float32 update gate (updates_within at
    MESH_UPDATE_RTOL) on phase 27's mesh, dp x sp x tp = 1 x 2 x 2, with
    the chip's seeded init at small widths: the step as it is passes,
    and a past hop's dK / dV dropped, the gradients left unreduced over
    sp, or the update skipped fails. The readings print with -s."""
    res, old = gate_run
    n = len(old)
    ref = [torch.from_numpy(res[0]['w_one_%d' % i]) for i in range(n)]
    old = [torch.from_numpy(a) for a in old]
    for rank, r in enumerate(res):
        new = [torch.from_numpy(r['w_%s_%d' % (fault, i)])
               for i in range(n)]
        upd = CS.updates_within(torch, new, old, ref, CS.MESH_UPDATE_RTOL)
        par = CS.leaves_within(torch, new, ref, CS.F32_TOL['rtol'],
                               CS.F32_TOL['atol'])
        print('%s rank %d: update error %.3g of the leaf\'s largest '
              'update (gate %g); weights within F32_TOL: %s (%.3g of the '
              'bound)' % (fault, rank, upd['max_err_of_leaf_update'],
                          CS.MESH_UPDATE_RTOL, par['ok'],
                          par['max_err_over_bound']))
        assert upd['ok'] == (fault == 'clean'), (fault, rank, upd)
