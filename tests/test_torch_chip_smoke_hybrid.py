"""chip_smoke.py's gates of phases 35 (hybrid workers and the reductions
over the batch) and 36 (the Custom loss head) pass a good run's rows and
fail each fault planted in them."""
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
KEYS = 161


# -- phase 35 --------------------------------------------------------------------

def _hybrid_rows():
    cs = CS
    want = cs.route_pairs(cs.RESNET_PAIRS, cs.stem_split_on())
    total = sum(range(1, cs.HYBRID_WORKERS + 1))
    probe = [[[float((r + 1) * total)] * 2] * 2
             for r in range(cs.HYBRID_PROBE_ROUNDS)]
    rows = []
    for w in range(cs.HYBRID_WORKERS):
        for r in range(cs.HYBRID_RANKS):
            row = dict(
                worker=w, rank=r, workers=cs.HYBRID_WORKERS,
                group_size=cs.HYBRID_RANKS, world=cs.HYBRID_RANKS,
                dp=cs.HYBRID_RANKS, local_batch=cs.HYBRID_BATCH,
                probe=copy.deepcopy(probe),
                launches_per_step=[want] * cs.HYBRID_STEPS,
                rounds=cs.HYBRID_STEPS + 1, keys=KEYS,
                pushes=(cs.HYBRID_STEPS + 1) * KEYS if r == 0 else 0,
                rescale_grad=1.0 / (cs.HYBRID_BATCH * cs.HYBRID_RANKS *
                                    cs.HYBRID_WORKERS),
                param_digest='p', aux_digest='a%d' % w,
                loss=[6.9 + w, 6.8 + w, 6.7 + w],
                reducers={case: dict(ok=True, max_err_over_bound=0.01,
                                     differ=[], keys=5)
                          for case in cs.HYBRID_BR_CASES},
                sce=dict(loss=6.91, out_shape=[], launches=want,
                         grads_finite=True, replicated=[True]))
            if r == 0:
                row['sce_one_device'] = dict(loss=6.905)
            if w == 0 and r == 0:
                row['kernel_checks'] = [dict(x=[64, 56, 56, 64],
                                             w=[3, 3, 64, 64], ok=True)]
            rows.append(row)
    run = dict(
        group_sums={'worker %d %s' % (w, k): True
                    for w in range(cs.HYBRID_WORKERS)
                    for k in cs.DIST_PROBES},
        server_check={k: True for k in cs.DIST_PROBES},
        server_cuda_initialized=False,
        ranks_exited_ok=cs.HYBRID_WORKERS * cs.HYBRID_RANKS)
    return rows, run


def _pushed_twice(rows, run):
    rows[0]['pushes'] *= 2


def _follower_pushed(rows, run):
    rows[1]['pushes'] = rows[1]['rounds'] * rows[1]['keys']


def _rank_left_out(rows, run):
    run['group_sums']['worker 1 fc1_weight'] = False


def _replicated_concatenated(rows, run):
    # topk's replicated (3, 6) output gathered as if it carried the batch
    rows[2]['reducers']['topk'].update(
        ok=False, differ=['out'], max_err_over_bound=0.0)


def _post_reduction_grad_dp_times(rows, run):
    # w2's whole gradient on both ranks, summed by the all-reduce
    rows[0]['reducers']['sum'].update(ok=False, max_err_over_bound=1e4)


def _conv_launch_short(rows, run):
    rows[3]['launches_per_step'] = [32, 31, 32]


HYBRID_FAULTS = {
    'pushed_twice': _pushed_twice,
    'follower_pushed': _follower_pushed,
    'rank_left_out_of_the_sum': _rank_left_out,
    'replicated_output_concatenated': _replicated_concatenated,
    'post_reduction_gradient_dp_times': _post_reduction_grad_dp_times,
    'conv_launch_short': _conv_launch_short,
    'probe_off': lambda rows, run: rows[1]['probe'][2][0].__setitem__(
        0, 8.0),
    'weights_differ': lambda rows, run: rows[3].update(param_digest='q'),
    'aux_differ_in_a_worker': lambda rows, run: rows[1].update(
        aux_digest='x'),
    'server_arithmetic': lambda rows, run: run['server_check'].update(
        fc1_weight=False),
    'server_initialized_cuda': lambda rows, run: run.update(
        server_cuda_initialized=True),
    'a_rank_did_not_finish': lambda rows, run: run.update(
        ranks_exited_ok=3),
    'mesh_spans_the_job': lambda rows, run: rows[0].update(world=4),
    'rescale_grad': lambda rows, run: rows[2].update(
        rescale_grad=1.0 / 128),
    'reduction_case_missing': lambda rows, run: rows[0]['reducers'].pop(
        'argsort'),
    'sce_loss_off': lambda rows, run: rows[2].update(
        sce=dict(rows[2]['sce'], loss=7.2)),
    'sce_output_gathered': lambda rows, run: rows[1].update(
        sce=dict(rows[1]['sce'], replicated=[False], out_shape=[2])),
    'kernel_check_failed': lambda rows, run: rows[0]['kernel_checks'][0]
    .update(ok=False),
    'kernel_unchecked': lambda rows, run: rows[0].pop('kernel_checks'),
}


def test_phase_35_gate_passes_good_rows():
    rows, run = _hybrid_rows()
    assert CS.hybrid_gate(rows, run) == []


@pytest.mark.parametrize('fault', sorted(HYBRID_FAULTS))
def test_phase_35_gate(fault):
    rows, run = _hybrid_rows()
    HYBRID_FAULTS[fault](rows, run)
    assert CS.hybrid_gate(rows, run), fault


# -- phase 36 --------------------------------------------------------------------

def _custom_run():
    cs = CS
    want = cs.route_pairs(cs.RESNET_PAIRS, cs.stem_split_on())
    head = dict(launches=[want] * cs.CUSTOM_STEPS, ms=[180.0, 175.0],
                losses=[6.9077, 6.9001])
    return dict(
        custom=dict(head), softmax=dict(head),
        compare=dict(weight_steps_max=1.0, weight_steps_worst='fc1_weight',
                     state_rel_max=3e-8, state_rel_worst='master fc1_weight',
                     mom_rel_max=1e-5),
        planted=dict(scale=1.5, state_rel_max=1.2e-3,
                     state_rel_worst='master fc1_weight'),
        legacy=dict(ok=True),
        consistency=dict(ok=True, error=None, launches=1, specs=['a']),
        consistency_f32=dict(ok=True, error=None, launches=0, specs=['b']))


CUSTOM_FAULTS = {
    # the Custom head's backward scaled by 1.5: the masters move by half
    # an update
    'backward_off_by_a_factor': lambda run: run['compare'].update(
        state_rel_max=1.2e-3),
    'float32_weight_apart': lambda run: run['compare'].update(
        state_rel_max=5e-6, state_rel_worst='arg bn0_gamma'),
    'first_loss': lambda run: run['custom'].update(losses=[6.95, 6.9001]),
    'second_loss': lambda run: run['custom'].update(losses=[6.9077, 6.95]),
    # the state gate cannot tell the planted backward x1.5 from the head
    'plant_unseen': lambda run: run['planted'].update(state_rel_max=5e-7),
    'conv_launch_short': lambda run: run['custom'].update(
        launches=[32, 0]),
    'reference_launch_short': lambda run: run['softmax'].update(
        launches=[31, 32]),
    'legacy_step': lambda run: run['legacy'].update(ok=False),
    'consistency': lambda run: run['consistency'].update(
        ok=False, error='Error 0.9 exceeds tolerance'),
    'consistency_off_the_kernel': lambda run: run['consistency'].update(
        launches=0),
    'consistency_float32': lambda run: run['consistency_f32'].update(
        ok=False, error='Error 0.01 exceeds tolerance'),
}


def test_phase_36_gate_passes_a_good_run():
    assert CS.custom_gate(_custom_run()) == []


@pytest.mark.parametrize('fault', sorted(CUSTOM_FAULTS))
def test_phase_36_gate(fault):
    run = _custom_run()
    CUSTOM_FAULTS[fault](run)
    assert CS.custom_gate(run), fault


def test_phase_36_compare_reads_a_scaled_backward():
    """custom_compare on two states an update apart reads the masters'
    difference, and custom_gate fails it: a backward scaled by 1.5 moves
    every master by half an update."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 64, generator=g) * 0.05
    upd = torch.randn(64, 64, generator=g) * 1e-3
    ref = {'arg fc1_weight': (w - upd).to(torch.bfloat16),
           'master fc1_weight': w - upd, 'mom fc1_weight': upd,
           'arg fc1_bias': torch.zeros(64)}
    got = {'arg fc1_weight': (w - 1.5 * upd).to(torch.bfloat16),
           'master fc1_weight': w - 1.5 * upd, 'mom fc1_weight': 1.5 * upd,
           'arg fc1_bias': torch.zeros(64)}
    cmp_ = CS.custom_compare(torch, got, ref)
    assert cmp_['state_rel_max'] > 100 * CS.MODULE_STATE_REL
    run = _custom_run()
    run['compare'] = cmp_
    assert CS.custom_gate(run)
    same = CS.custom_compare(torch, ref, ref)
    assert same['weight_steps_max'] == 0 and same['state_rel_max'] == 0
