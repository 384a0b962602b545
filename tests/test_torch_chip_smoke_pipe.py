"""chip_smoke.py's gates of phases 32-34 (pipeline and experts) pass a good
run's rows and fail each fault planted in them; the phase-32 plants leave
the forward unchanged bit for bit and change the gradient as they say."""
import copy
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


# -- phase 32 --------------------------------------------------------------------

def _pipe_rows():
    cs = CS
    want = [cs.PIPE_STAGE_LAUNCHES] * 3
    f32 = [cs.FP32_LAYERS // cs.PIPE_RANKS * cs.PIPE_MICRO] * 3
    rows = []
    for r in range(cs.PIPE_RANKS):
        rows.append(dict(
            rank=r, backend='gloo', staged=True,
            launches_per_step=[want] * cs.PIPE_STEPS,
            staged_bytes_per_step=cs.pipe_staged_bytes(cs.GPT2_MEDIUM),
            pipe=dict(pipe_bubble_frac=0.2, pipe_steps=cs.PIPE_STEPS),
            param_bytes=400_000_000, loss=[11.0377, 10.9807],
            edge_digest='e',
            bf16_planted_drop=dict(ok=False, max_err_over_bound=30.0),
            fp32=dict(launches_per_step=[f32] * cs.PIPE_STEPS,
                      planted={p: dict(ok=False, max_err_over_bound=50.0)
                               for p in cs.PIPE_PLANTS}),
            kernel_checks=[dict(way=w, dtype=d,
                                q=list(cs.PIPE_KERNEL_SHAPE), ok=True)
                           for w, d in cs.PIPE_KERNEL_CHECKS]))
    ref = dict(tied_loss=11.0377, losses=[11.0377, 10.9807],
               params=dict(ok=True), fp32_updates=dict(ok=True),
               world1_param_bytes=710_000_000)
    return rows, ref


def _planted_passed(plant):
    def edit(rows, ref):
        for row in rows:
            row['fp32']['planted'][plant]['ok'] = True
    return edit


PIPE_FAULTS = {
    'nccl': lambda rows, ref: rows[0].update(backend='nccl'),
    'launches': lambda rows, ref: rows[1].update(
        launches_per_step=[[48, 48, 48], [60, 48, 48]]),
    'staged_bytes': lambda rows, ref: rows[0].update(
        staged_bytes_per_step=1),
    'bubble': lambda rows, ref: rows[1]['pipe'].update(pipe_bubble_frac=0.0),
    'pipe_steps': lambda rows, ref: rows[0]['pipe'].update(pipe_steps=1),
    'param_bytes': lambda rows, ref: rows[0].update(
        param_bytes=710_000_000),
    'ranks_losses': lambda rows, ref: rows[1].update(loss=[11.0, 10.9]),
    'edges_differ': lambda rows, ref: rows[1].update(edge_digest='f'),
    'fp32_launches': lambda rows, ref: rows[0]['fp32'].update(
        launches_per_step=[[8, 8, 8], [8, 0, 8]]),
    'kernel_shape': lambda rows, ref: rows[0]['kernel_checks'][0].update(
        q=[8, 16, 1024, 64]),
    'kernel_missing': lambda rows, ref: rows[1]['kernel_checks'].pop(),
    'first_loss': lambda rows, ref: ref.update(tied_loss=11.2),
    'step_loss': lambda rows, ref: ref.update(losses=[11.0377, 10.99]),
    'bf16_updates': lambda rows, ref: ref['params'].update(ok=False),
    'fp32_updates': lambda rows, ref: ref['fp32_updates'].update(ok=False),
    'plant_missing': lambda rows, ref: rows[0]['fp32']['planted'].pop(
        'double'),
    'bf16_planted_passed': lambda rows, ref: [
        row['bf16_planted_drop'].update(ok=True) for row in rows],
    'bf16_plant_missing': lambda rows, ref: [
        row.pop('bf16_planted_drop') for row in rows],
}
PIPE_FAULTS.update({'planted_%s_passed' % p: _planted_passed(p)
                    for p in CS.PIPE_PLANTS})


@pytest.mark.parametrize('fault', ['clean'] + sorted(PIPE_FAULTS))
def test_phase_32_gate(fault):
    """pipe_gate passes a good pair of rank rows and fails each fault:
    the counts, the engine's counters, the kernel checks at the
    microbatches' shape, the losses, the updates, and a planted fault
    the float32 gate let through."""
    rows, ref = _pipe_rows()
    if fault != 'clean':
        PIPE_FAULTS[fault](rows, ref)
    bad = CS.pipe_gate(rows, CS.GPT2_MEDIUM, ref)
    assert (bad == []) == (fault == 'clean'), bad


def test_phase_32_one_rank_catching_a_plant_is_enough():
    rows, ref = _pipe_rows()
    rows[1]['fp32']['planted']['drop']['ok'] = True
    assert CS.pipe_gate(rows, CS.GPT2_MEDIUM, ref) == []


def _head_grads(plant):
    """The forward of pipe_planted_fns' head and the gradient it sends
    into the acts, on a (8, 3) input in microbatches of 2 rows."""
    def head_fn(ws, acts, label, rng):
        loss = ((acts * ws[0]) ** 2).sum()
        return [loss], loss

    fns = (None, None, head_fn)
    if plant is not None:
        fns = CS.pipe_planted_fns(torch, fns, plant, rows=2)
    gen = torch.Generator().manual_seed(0)
    acts = torch.randn(8, 3, generator=gen, requires_grad=True)
    w = torch.randn(3, generator=gen)
    (loss,), total = fns[2]([w], acts, None, 0)
    g, = torch.autograd.grad(total, acts)
    return loss.detach(), g


@pytest.mark.parametrize('plant', ['drop', 'double'])
def test_pipe_plants_keep_the_forward_and_change_microbatch_1(plant):
    loss0, g0 = _head_grads(None)
    loss, g = _head_grads(plant)
    assert torch.equal(loss, loss0)
    torch.testing.assert_close(g[:2], g0[:2], rtol=0, atol=0)
    torch.testing.assert_close(g[4:], g0[4:], rtol=0, atol=0)
    scale = 0.0 if plant == 'drop' else 2.0
    torch.testing.assert_close(g[2:4], g0[2:4] * scale, rtol=0, atol=0)


def test_pipe_unsummed_plant_is_scoped_to_the_pipe_axis():
    from mxnet_tpu_torch.parallel import collectives
    real = collectives._all_reduce
    seen = []
    collectives._all_reduce = lambda x, mesh, axis: seen.append(axis) or x
    try:
        with CS.pipe_unsummed(collectives):
            x = torch.ones(2)
            assert collectives._all_reduce(x, None, 'pipe') is x
            collectives._all_reduce(x, None, 'data')
        assert seen == ['data']
    finally:
        collectives._all_reduce = real


def test_measured_bubble_reads_the_stage_calls():
    from mxnet_tpu_torch.parallel import pipeline as pp
    S, M = CS.PIPE_RANKS, CS.PIPE_MICRO
    # every microbatch once forward and once backward
    assert pp.measured_bubble(2 * M, S, M) == pytest.approx(
        pp.bubble_fraction(S, M))
    assert pp.measured_bubble(2 * M * 3, S, M, k=3) == pytest.approx(0.2)
    # a stage run on every tick leaves no bubble; a skipped microbatch
    # leaves more
    assert pp.measured_bubble(2 * (M + S - 1), S, M) == 0.0
    assert pp.measured_bubble(2 * M - 2, S, M) > 0.2


# -- phase 33 --------------------------------------------------------------------

def _pipe4_rows():
    rows = []
    for r in range(CS.PG_RANKS):
        row = dict(rank=r, recreate=dict(same_key=True, cache_entries=0,
                                         same_bits=True))
        for arm, state in (('z0', 8_400_000), ('z1', 4_200_128)):
            row[arm] = dict(mesh={'data': 2, 'pipe': 2},
                            device='cuda:0', accounting=[8_400_000, state])
        rows.append(row)
    rows[0]['z0']['parity'] = dict(ok=True)
    rows[0]['z1']['parity'] = dict(ok=True)
    rows[0]['fit_parity'] = dict(ok=True)
    return rows


PIPE4_FAULTS = {
    'mesh': lambda rows: rows[1]['z0'].update(mesh={'data': 4}),
    'cpu': lambda rows: rows[2]['z1'].update(device='cpu'),
    'zero_state': lambda rows: rows[3]['z1'].update(
        accounting=[8_400_000, 8_400_000]),
    'zero_params': lambda rows: rows[0]['z1'].update(
        accounting=[4_200_000, 4_200_000]),
    'recreate_key': lambda rows: rows[1]['recreate'].update(same_key=False),
    'recreate_cache': lambda rows: rows[0]['recreate'].update(
        cache_entries=1),
    'recreate_bits': lambda rows: rows[2]['recreate'].update(
        same_bits=False),
    'gluon_parity': lambda rows: rows[0]['z0']['parity'].update(ok=False),
    'zero_parity': lambda rows: rows[0]['z1']['parity'].update(ok=False),
    'fit_parity': lambda rows: rows[0]['fit_parity'].update(ok=False),
}


@pytest.mark.parametrize('fault', ['clean'] + sorted(PIPE4_FAULTS))
def test_phase_33_gate(fault):
    rows = _pipe4_rows()
    if fault != 'clean':
        PIPE4_FAULTS[fault](rows)
    bad = CS.pipe4_gate(rows)
    assert (bad == []) == (fault == 'clean'), bad


# -- phase 34 --------------------------------------------------------------------

def _moe_counts(routed, dropped):
    E = CS.SWITCH['experts']
    per = {'e%d' % e: dict(routed=routed // E + (e < routed % E),
                           dropped=dropped // E + (e < dropped % E))
           for e in range(E)}
    return dict(moe_routed_tokens=routed, moe_dropped_tokens=dropped,
                moe_dispatches=CS.MOE_STEPS, per_expert=per,
                block_routed=float(routed), block_dropped=float(dropped))


def _moe_rows():
    fed = CS.MOE_TOKENS * CS.MOE_STEPS
    world1 = _moe_counts(fed - 91, 91)
    half = CS.SWITCH['experts'] // CS.PIPE_RANKS
    rows = []
    for r in range(CS.PIPE_RANKS):
        moe = copy.deepcopy(world1)
        moe.update(experts=[r * half, (r + 1) * half],
                   expert_step=dict(finite=True, loss=0.4,
                                    local_experts=half))
        rows.append(dict(rank=r, moe=moe))
    return world1, rows, dict(ok=True), True


MOE_FAULTS = {
    'tokens_lost': lambda w, rows, p, s: w.update(moe_dropped_tokens=90),
    'dispatches': lambda w, rows, p, s: rows[0]['moe'].update(
        moe_dispatches=1),
    'per_expert': lambda w, rows, p, s: rows[1]['moe']['per_expert'][
        'e0'].update(routed=0),
    'block_counts': lambda w, rows, p, s: w.update(block_routed=1.0),
    'experts_split': lambda w, rows, p, s: rows[0]['moe'].update(
        experts=[0, 8]),
    'expert_step': lambda w, rows, p, s: rows[1]['moe'][
        'expert_step'].update(finite=False),
    'expert_step_local': lambda w, rows, p, s: rows[0]['moe'][
        'expert_step'].update(local_experts=8),
    'routing_differs': lambda w, rows, p, s: rows[1]['moe'].update(
        _moe_counts(CS.MOE_TOKENS * CS.MOE_STEPS - 90, 90)),
    'parity': lambda w, rows, p, s: p.update(ok=False),
}


@pytest.mark.parametrize('fault', ['clean', 'same_bits'] +
                         sorted(MOE_FAULTS))
def test_phase_34_gate(fault):
    world1, rows, parity, same = _moe_rows()
    if fault == 'same_bits':
        same = False
    elif fault != 'clean':
        MOE_FAULTS[fault](world1, rows, parity, same)
    bad = CS.moe_gate(world1, rows, parity, same)
    assert (bad == []) == (fault == 'clean'), bad
