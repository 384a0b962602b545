"""ZeRO-1 on the port (mxnet_tpu_torch.parallel.zero, FusedSGD(zero=1))
against the JAX package's: the counterparts of tests/test_zero.py, of
tests/test_overlap_fusion.py's schedule tests and of the dryrun's phases
(b), (e), (e2) and (e3) (__graft_entry__.py).

One spawn of four gloo ranks (tests/_torch_parallel_ranks.py,
`zero_suite`) runs every Module case; the parent runs the JAX package's
Module over four virtual CPU devices from the same numpy inputs, and the
layout, accounting and key checks directly. Tolerances are the JAX
tests': rtol 1e-4 / atol 1e-5 between ZeRO and the replicated update and
between the packages, 1e-2 with bfloat16 weights, and the schedules bit
for bit (the JAX test allows 1e-6).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.parallel import collectives as jax_coll
from mxnet_tpu.parallel import zero as jax_zero

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch.parallel import collectives
from mxnet_tpu_torch.parallel import zero as zero_mod

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import (DP_BATCH, DP_FEAT, DP_OPT, dp_batches,
                                   dp_mlp, dp_module, dp_params, dp_result,
                                   dp_train)

N = 4
SHAPE = (DP_BATCH, DP_FEAT)
STEP = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
RS = np.random.RandomState(31)
INPUTS = dict(
    X=RS.rand(4, DP_BATCH, DP_FEAT).astype(np.float32),
    y=(RS.rand(4, DP_BATCH) * 5).astype(np.int64).astype(np.float32))


@pytest.fixture(scope='module')
def zero_run(tmp_path_factory):
    return ranks.run(ranks.zero_suite, N, tmp_path_factory.mktemp('zero'),
                     **INPUTS)


def _pick(res, prefix):
    pre = prefix + '__'
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _ranks_equal(out, prefix):
    first = _pick(out[0], prefix)
    assert first
    for r in range(1, N):
        other = _pick(out[r], prefix)
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    return first


def _jax(zero, dtype='float32', opt=None, bulk=False):
    """The JAX package's Module over four devices, four steps."""
    net = dp_mlp(jmx, dtype)
    kw = dict(DP_OPT, multi_precision=dtype != 'float32')
    kw.update(opt or {})
    mod = dp_module(jmx, net, [jmx.cpu(i) for i in range(N)], SHAPE,
                    *dp_params(net, SHAPE), zero=zero, opt=kw)
    res = {}
    batches = dp_batches(jmx, INPUTS['X'], INPUTS['y'])
    if bulk:
        mod.bulk_step(batches=batches)
        dp_result(mod, 'r', res)
    else:
        dp_train(jmx, mod, batches, res, 'r')
    return _pick(res, 'r')


def _close(got, want, tol, kinds=('p__', 'm__')):
    keys = [k for k in want if k[:3] in kinds]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# -- numeric parity: the sharded step is the replicated step ----------------

CASES = {'base': ({}, 'float32', STEP), 'clip': ({'clip_gradient': 0.05},
                                                  'float32', STEP),
         'bf16': ({}, 'bfloat16', BF16)}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('zero', [0, 1])
def test_parity_with_the_jax_module(zero_run, case, zero):
    """test_zero_parity_sgd_momentum_wd, _clip_gradient and
    _bf16_fp32_masters: the port over four ranks against the JAX
    package over four devices, ZeRO on and off."""
    opt, dtype, tol = CASES[case]
    got = _ranks_equal(zero_run, '%s_z%d' % (case, zero))
    _close(got, _jax(zero, dtype, opt), tol)


@pytest.mark.parametrize('case', sorted(CASES))
def test_zero_is_the_replicated_update(zero_run, case):
    tol = CASES[case][2]
    a = _pick(zero_run[0], '%s_z0' % case)
    b = _pick(zero_run[0], '%s_z1' % case)
    _close(b, a, tol, ('p__', 'm__', 'w__', 'out'))


@pytest.mark.parametrize('zero', [0, 1])
def test_parity_bulk_multistep(zero_run, zero):
    got = _ranks_equal(zero_run, 'bulk_z%d' % zero)
    _close(got, _jax(zero, bulk=True), STEP)
    _close(got, _pick(zero_run[0], 'bulk_z0'), STEP)


def test_parity_tiny_buckets(zero_run):
    """A bucket target below any parameter's size: one bucket a
    parameter, the same update."""
    _close(_ranks_equal(zero_run, 'tiny_z1'), _pick(zero_run[0], 'base_z0'),
           STEP)


def test_single_device_runs():
    """Data 1 (no mesh): the bucketed update, no collective, the
    replicated one's bits."""
    out = {}
    with mx.cpu():
        for zero in (0, 1):
            net = dp_mlp(mx)
            mod = dp_module(mx, net, [mx.cpu()], SHAPE,
                            *dp_params(net, SHAPE), zero=zero)
            res = {}
            dp_train(mx, mod, dp_batches(mx, INPUTS['X'], INPUTS['y']), res,
                     'r')
            out[zero] = _pick(res, 'r')
            assert mod._fused_updater.comm_bytes_per_step() == (0, 0)
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)


def test_env_knob(zero_run):
    assert all(int(r['env_knob__zero']) == 1 for r in zero_run)


# -- the bucket layout ------------------------------------------------------

def _layouts(shapes, dtypes, mp, dp, max_bytes=1 << 30):
    return (zero_mod.ZeroBucketLayout(
        shapes, [torch.bfloat16 if d == 'bfloat16' else torch.float32
                 for d in dtypes], mp, dp, max_bytes=max_bytes),
        jax_zero.ZeroBucketLayout(
            shapes, [jnp.bfloat16 if d == 'bfloat16' else np.float32
                     for d in dtypes], mp, dp, max_bytes=max_bytes))


def _same_buckets(port, jax):
    assert len(port.buckets) == len(jax.buckets)
    for a, b in zip(port.buckets, jax.buckets):
        assert (a.param_idx, a.sizes, a.offsets, a.shapes, a.size, a.padded,
                a.mp) == (b.param_idx, b.sizes, b.offsets, b.shapes, b.size,
                          b.padded, b.mp)


def test_bucket_layout_padding_and_grouping():
    port, jax = _layouts([(3, 5), (7,), (2, 2)], ['float32'] * 3,
                         [False] * 3, 8)
    _same_buckets(port, jax)
    b = port.buckets[0]
    assert len(port.buckets) == 1 and b.size == 26 and b.padded == 32
    port, jax = _layouts([(4,), (4,)], ['bfloat16', 'float32'],
                         [True, False], 2)
    _same_buckets(port, jax)
    assert port.buckets[0].mp and not port.buckets[1].mp
    assert port.buckets[0].acc_dtype == torch.float32


def test_bucket_pack_unpack_roundtrip():
    port, _ = _layouts([(2, 3), (5,)], ['float32'] * 2, [False] * 2, 4)
    b = port.buckets[0]
    vals = [torch.arange(6.0).reshape(2, 3), torch.arange(5.0) + 10]
    flat = port.pack(b, vals)
    assert tuple(flat.shape) == (b.padded,)
    for v, r in zip(vals, port.unpack(b, flat)):
        assert torch.equal(v, r)


def test_bucket_split_over_target():
    port, jax = _layouts([(100,)] * 5, ['float32'] * 5, [False] * 5, 2,
                         max_bytes=400)
    _same_buckets(port, jax)
    assert len(port.buckets) == 5


def test_state_and_comm_accounting():
    port, jax = _layouts([(64,)], ['bfloat16'], [True], 8)
    assert port.state_bytes_per_device() == jax.state_bytes_per_device() \
        == 8 * 4 + 8 * 4
    assert port.comm_bytes_per_step() == jax.comm_bytes_per_step() \
        == (64 * 4, 64 * 2)
    one, _ = _layouts([(64,)], ['float32'], [False], 1)
    assert one.comm_bytes_per_step() == (0, 0)


def test_state_bytes_drop_by_the_data_size(zero_run):
    """test_zero_state_bytes_drop_8x at four ranks: a rank's state bytes
    drop 4x (within the padding), and the profiler's gauge is the
    updater's."""
    for r in zero_run:
        rep, shard = int(r['acct_z0__state_bytes']), \
            int(r['acct_z1__state_bytes'])
        assert rep / shard >= 3.0, (rep, shard)
        assert int(r['acct_z1__stats'][2]) == shard
        assert int(r['acct_z0__stats'][2]) == rep


def test_states_actually_sharded(zero_run):
    for r in zero_run:
        np.testing.assert_array_equal(r['acct_z1__shard_sizes'],
                                      r['acct_z1__padded'] // N)
        assert bool(r['acct_z1__weights_full'])


def test_comm_counters_accumulate(zero_run):
    """Three steps: the layout's bytes three times, each bucket's
    reduce-scatter carried as an all-reduce on gloo, and no bucket of
    the replicated all-reduce; the replicated run the reverse."""
    for r in zero_run:
        rs, ag = r['acct_z1__rs_ag']
        assert rs > 0 and ag > 0
        stats = r['acct_z1__stats']
        nb = int(r['acct_z1__n_buckets'])
        assert list(stats[[0, 1, 3, 4, 5]]) == [3 * rs, 3 * ag, 3 * nb, 0,
                                                 0]
        stats0 = r['acct_z0__stats']
        assert list(stats0[[0, 1, 3]]) == [0, 0, 0]
        assert int(stats0[5]) == 3 * int(r['acct_z0__n_buckets'])
    with mx.cpu():
        assert 'bytes_reduce_scattered' in mx.profiler.summary(
            print_out=False)


# -- cache keys -------------------------------------------------------------

def test_zero_and_replicated_programs_never_alias(zero_run):
    assert all(int(r['bulk_z%d__multistep_keys' % z]) == 1
               for r in zero_run for z in (0, 1))


def test_fused_sgd_cache_key_carries_zero_and_layout():
    fr = opt_mod.FusedSGD(opt_mod.SGD(learning_rate=0.1, momentum=0.9),
                          ['w'])
    fz = opt_mod.FusedSGD(opt_mod.SGD(learning_rate=0.1, momentum=0.9),
                          ['w'], zero=1)
    assert fr.cache_key() != fz.cache_key()
    fz.host_prep([mx.nd.zeros((4, 4), ctx=mx.cpu())])
    k1 = fz.cache_key()
    assert any('zero' in str(part) for part in k1)
    fz2 = opt_mod.FusedSGD(opt_mod.SGD(learning_rate=0.1, momentum=0.9),
                           ['w'], zero=1)
    fz2.host_prep([mx.nd.zeros((8, 4), ctx=mx.cpu())])
    assert fz2.cache_key() != k1


# -- checkpoints across modes -----------------------------------------------

def test_checkpoint_roundtrip_cross_mode(zero_run):
    for r in zero_run:
        assert bool(r['cross__equal']) and bool(r['cross__moved'])
        assert bool(r['staged__keys'])


def test_get_states_before_first_step_preserves_staged(zero_run):
    assert all(bool(r['staged__equal']) for r in zero_run)


def test_jax_states_restore_into_the_port_sharded_updater():
    """A JAX ZeRO updater's states file restores into the port's (and
    back): per-parameter arrays in both modes and both packages."""
    net = dp_mlp(jmx)
    jmod = dp_module(jmx, net, [jmx.cpu(i) for i in range(N)], SHAPE,
                     *dp_params(net, SHAPE), zero=1)
    for b in dp_batches(jmx, INPUTS['X'], INPUTS['y'])[:2]:
        jmod.forward_backward(b)
        jmod.update()
    blob = jmod._fused_updater.get_states()
    states, _, _ = pickle.loads(blob)
    fz = opt_mod.FusedSGD(opt_mod.SGD(momentum=0.9), list(states), zero=1)
    fz.set_states(blob)
    back, _, _ = pickle.loads(fz.get_states())
    for k in states:
        np.testing.assert_array_equal(back[k], np.asarray(states[k]))


def test_bucket_relayout_mid_run(zero_run):
    _close(_ranks_equal(zero_run, 'relayout'), _pick(zero_run[0], 'base_z0'),
           STEP)


def test_zero_stage_validation():
    assert zero_mod.zero_stage(None) == 0
    assert zero_mod.zero_stage(1) == 1
    with pytest.raises(ValueError):
        zero_mod.zero_stage(2)


def test_kvstore_push_multi_value_merge():
    with mx.cpu():
        kv = mx.kvstore.create('local')
        kv.init('g', mx.nd.zeros((3, 2)))
        kv.push('g', [mx.nd.array(np.full((3, 2), float(i + 1), np.float32))
                      for i in range(5)])
        out = mx.nd.zeros((3, 2))
        kv.pull('g', out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full((3, 2), 15.0))


# -- the reduction schedule (tests/test_overlap_fusion.py) -------------------

def test_reduce_plan_mechanics(monkeypatch):
    shapes = [(4, 3), (4,), (8, 4), (8,), (2, 8)]
    dtypes = ['float32'] * 5
    for kw in ({}, {'n_buckets': 3}):
        port = collectives.GradReducePlan(shapes, dtypes, **kw)
        jax = jax_coll.GradReducePlan(shapes, dtypes, **kw)
        assert port.buckets == jax.buckets
    plan = collectives.GradReducePlan(shapes, dtypes)
    assert plan.n_buckets == 1 and plan.buckets[0][0] == 4
    p3 = collectives.GradReducePlan(shapes, dtypes, n_buckets=3)
    assert [i for b in p3.buckets for i in b] == [4, 3, 2, 1, 0]
    assert p3.key != plan.key
    assert collectives.GradReducePlan(
        [(4,), (4,), (4,)], ['float32', 'bfloat16', 'float32']).n_buckets \
        == 3
    monkeypatch.setenv('MXNET_TPU_INTERLEAVE_REDUCE', '0')
    pe = collectives.GradReducePlan(shapes, dtypes)
    assert pe.interleave is False and pe.key != plan.key
    assert collectives.interleave_reduce_enabled(True) is True


def test_grad_barrier_identity():
    gs = [torch.arange(4.0), torch.ones(2, 2)]
    out = collectives.grad_barrier(gs)
    assert all(a is b for a, b in zip(gs, out))
    assert collectives.grad_barrier([]) == []


@pytest.mark.parametrize('zero', [0, 1])
def test_interleaved_and_end_of_backward_give_the_same_bits(zero_run, zero):
    """The dryrun's (e3) and test_interleave_zero_composition: the two
    schedules, ZeRO on and off, bit for bit; the replicated step issues
    its buckets under either."""
    for r in zero_run:
        a = _pick(r, 'sched_z%d_i1' % zero)
        b = _pick(r, 'sched_z%d_i0' % zero)
        for k in a:
            if k != 'buckets':
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if zero == 0:
            assert int(a['buckets']) == int(b['buckets']) == 4


def test_epoch_fused_metric_bulk_is_the_host_loop(zero_run):
    """The dryrun's (e3): bulk_step with a device metric fold over four
    ranks in one dispatch, against the per-step host loop."""
    for r in zero_run:
        host = _pick(r, 'host')
        fold = _pick(r, 'fold')
        assert float(fold['metric']) == float(host['metric'])
        assert int(fold['dispatches']) == 1
        assert int(fold['metric_steps']) == 4
        _close(fold, host, dict(rtol=1e-5, atol=1e-6))


def test_dryrun_module_dp_outputs_are_finite(zero_run):
    """The dryrun's (b): the gathered outputs of a Module over four
    ranks are the global batch's, finite."""
    out = _ranks_equal(zero_run, 'base_z0')['out']
    assert out.shape == (4, DP_BATCH, 5) and np.isfinite(out).all()
