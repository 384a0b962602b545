"""A Module over several contexts on the port (mxnet_tpu_torch), held
against the JAX package's Module over as many virtual CPU devices and the
port's own one-device step on the global batch.

One spawn of two gloo ranks (tests/_torch_parallel_ranks.py,
`module_dp_suite`) runs every case; the parent runs the JAX package over
two devices and the port over one from the same numpy inputs. Tolerances:
the JAX tests' own (rtol 1e-4 / atol 1e-5 for a step against another
program, tests/test_zero.py and the dryrun's phase (e2); the two reduce
schedules bit for bit, where the JAX test allows 1e-6); bfloat16 ones are
stated beside their constants.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import (BR_CASES, DP_BATCH, DP_FEAT, DP_IMAGE,
                                   DP_OPT, br_step, dp_batches, dp_bn_net,
                                   dp_mlp, dp_module, dp_params, dp_result,
                                   dp_seq_net, dp_train)

REPO = Path(__file__).resolve().parents[1]
N = 2
STEP = dict(rtol=1e-4, atol=1e-5)
ONE_DEVICE = dict(rtol=1e-5, atol=1e-6)
# bfloat16: the ranks' and the one device's float32 statistics differ in
# their summing order, which can move a bfloat16 activation by one step
# (2^-8 of it) and the update with it
BF16 = dict(rtol=2e-2, atol=2e-3)
RS = np.random.RandomState(21)
Y = (RS.rand(4, DP_BATCH) * 5).astype(np.int64).astype(np.float32)
Y_IGN = Y.copy()
Y_IGN[:, ::5] = -1
INPUTS = dict(
    X=RS.rand(4, DP_BATCH, DP_FEAT).astype(np.float32),
    y=Y, y_ign=Y_IGN,
    Xi=RS.randn(4, DP_BATCH, *DP_IMAGE).astype(np.float32),
    Xs=RS.rand(4, DP_BATCH, 8).astype(np.float32))
MLP = (DP_BATCH, DP_FEAT)
IMG = (DP_BATCH,) + DP_IMAGE
JAX_CKPT_DEVICES = 8


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _opt_states(mod):
    moms, _, masters = pickle.loads(mod._fused_updater.get_states())
    return ({k: np.asarray(v, np.float32) for k, v in moms.items()},
            {k: np.asarray(v, np.float32) for k, v in (masters or {}).items()
             if v is not None})


def _jax_ckpt(directory):
    """The JAX package's ZeRO checkpoint: the MLP over eight devices,
    two steps; returns its optimizer states."""
    net = dp_mlp(jmx)
    mod = dp_module(jmx, net, _ctxs(jmx, JAX_CKPT_DEVICES), MLP,
                    *dp_params(net, MLP), zero=1)
    for b in dp_batches(jmx, INPUTS['X'], INPUTS['y'])[:2]:
        mod.forward_backward(b)
        mod.update()
    mgr = jelastic.CheckpointManager(str(directory), async_=False)
    mgr.attach(mod)
    mgr._step = 2
    mgr.save(sync=True)
    return _opt_states(mod)


@pytest.fixture(scope='module')
def dp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('module_dp')
    jax_states = _jax_ckpt(tmp / 'ckpt_jax')
    out = ranks.run(ranks.module_dp_suite, N, tmp, **INPUTS)
    return out, tmp, jax_states


def _pick(res, prefix):
    pre = prefix + '__'
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@functools.lru_cache(maxsize=None)
def _ref(pkg_name, case, ndev):
    """The case of module_dp_suite run by one package over ndev devices
    (the JAX package's Module over virtual CPU devices, or the port's
    over one): its result dict."""
    pkg = jmx if pkg_name == 'jax' else mx
    res = {}
    ctxs = _ctxs(pkg, ndev)
    kind, _, rest = case.partition('_')
    with (mx.cpu() if pkg is mx else _Null()):
        batches = dp_batches(pkg, INPUTS['X'], INPUTS['y'])
        if kind == 'mlp':
            zero, il = int(rest[1]), int(rest[4])
            prior = os.environ.get('MXNET_TPU_INTERLEAVE_REDUCE')
            os.environ['MXNET_TPU_INTERLEAVE_REDUCE'] = str(il)
            try:
                net = dp_mlp(pkg)
                mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP),
                                zero=zero)
                dp_train(pkg, mod, batches, res, 'r',
                         metric=pkg.metric.Accuracy())
            finally:
                if prior is None:
                    os.environ.pop('MXNET_TPU_INTERLEAVE_REDUCE', None)
                else:
                    os.environ['MXNET_TPU_INTERLEAVE_REDUCE'] = prior
        elif kind in ('bf16', 'clip'):
            net = dp_mlp(pkg, dtype='bfloat16' if kind == 'bf16'
                         else 'float32')
            opt = dict(DP_OPT, multi_precision=True) if kind == 'bf16' \
                else dict(DP_OPT, clip_gradient=0.05)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP),
                            zero=int(rest[1]), opt=opt)
            dp_train(pkg, mod, batches, res, 'r')
        elif kind == 'norm':
            net = dp_mlp(pkg, normalization=rest, use_ignore=True)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP))
            dp_train(pkg, mod, dp_batches(pkg, INPUTS['X'], INPUTS['y_ign']),
                     res, 'r')
        elif kind == 'bn':
            net = dp_bn_net(pkg, rest)
            mod = dp_module(pkg, net, ctxs, IMG, *dp_params(net, IMG),
                            opt=dict(DP_OPT, multi_precision=True))
            dp_train(pkg, mod, dp_batches(pkg, INPUTS['Xi'],
                                          INPUTS['y'])[:3], res, 'r')
        elif kind == 'bulk':
            net = dp_mlp(pkg)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP),
                            zero=int(rest[1]))
            metric = pkg.metric.Accuracy()
            mod.bulk_step(batches=batches, eval_metric=metric)
            res['r__metric'] = np.float64(metric.get()[1])
            dp_result(mod, 'r', res)
        elif kind == 'fit':
            net = dp_mlp(pkg)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP),
                            bind_only=True)
            it = pkg.io.NDArrayIter(INPUTS['X'].reshape(-1, DP_FEAT),
                                    INPUTS['y'].reshape(-1),
                                    batch_size=DP_BATCH)
            mod.fit(it, num_epoch=1, optimizer_params=dict(DP_OPT),
                    eval_metric='acc', bulk=2)
            dp_result(mod, 'r', res)
        elif kind == 'dropout':
            pkg.random.seed(7)
            net = dp_mlp(pkg, dropout=0.3)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP))
            dp_train(pkg, mod, batches[:2], res, 'r')
        elif kind == 'igrad':
            net = dp_mlp(pkg)
            mod = dp_module(pkg, net, ctxs, MLP, *dp_params(net, MLP),
                            inputs_need_grad=True)
            mod.forward_backward(batches[0])
            res['r__igrad'] = mod.get_input_grads()[0].asnumpy()
        elif kind == 'bucketing':
            bmod = pkg.mod.BucketingModule(
                lambda key: (dp_seq_net(pkg, key), ('data',),
                             ('softmax_label',)),
                default_bucket_key=8, context=ctxs)
            bmod.bind(data_shapes=[pkg.io.DataDesc('data', (DP_BATCH, 8))],
                      label_shapes=[pkg.io.DataDesc('softmax_label',
                                                    (DP_BATCH,))])
            bargs, _ = dp_params(dp_seq_net(pkg, 8), (DP_BATCH, 8))
            bmod.init_params(initializer=None, arg_params={
                k: pkg.nd.array(v) for k, v in bargs.items()})
            bmod.init_optimizer(optimizer='sgd',
                                optimizer_params=dict(DP_OPT))
            for i, key in enumerate((8, 4, 8, 4)):
                x = INPUTS['Xs'][i][:, :key]
                bmod.forward_backward(pkg.io.DataBatch(
                    data=[pkg.nd.array(x)],
                    label=[pkg.nd.array(INPUTS['y'][i])], bucket_key=key,
                    provide_data=[pkg.io.DataDesc('data', x.shape)],
                    provide_label=[pkg.io.DataDesc('softmax_label',
                                                   (DP_BATCH,))]))
                bmod.update()
            dp_result(bmod, 'r', res)
    return _pick(res, 'r')


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _close(got, want, tol, keys=None, what=''):
    keys = sorted(want) if keys is None else keys
    assert keys
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg='%s %s' % (what, k), **tol)


def _ranks_equal(out, prefix):
    a, b = _pick(out[0], prefix), _pick(out[1], prefix)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return a


def _state_keys(res):
    return [k for k in res if k[:3] in ('p__', 'a__', 'm__', 'w__')] + \
        [k for k in res if k == 'out']


MLP_CASES = ['z0_i1', 'z0_i0', 'z1_i1', 'z1_i0']


@pytest.mark.parametrize('case', MLP_CASES)
def test_mlp_matches_the_jax_module_and_the_one_device_step(dp_run, case):
    """Parameters, momenta, the gathered outputs and the metric after
    four steps: equal on both ranks, at the JAX tests' tolerance of the
    JAX package's Module over two devices, and of the port's one-device
    step on the global batch."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'mlp_' + case)
    jax = _ref('jax', 'mlp_' + case, N)
    one = _ref('port', 'mlp_%s' % case, 1)
    _close(got, jax, STEP, _state_keys(jax), 'vs JAX')
    _close(got, one, ONE_DEVICE, _state_keys(one), 'vs one device')
    assert float(got['metric']) == float(jax['metric'])


@pytest.mark.parametrize('zero', [0, 1])
def test_the_two_reduce_schedules_give_the_same_bits(dp_run, zero):
    out, _, _ = dp_run
    a = _pick(out[0], 'mlp_z%d_i1' % zero)
    b = _pick(out[0], 'mlp_z%d_i0' % zero)
    for k in _state_keys(a):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('case', ['mlp', 'bf16', 'clip'])
def test_zero_matches_the_replicated_update(dp_run, case):
    """ZeRO-1 against the replicated step (tests/test_zero.py's parity
    tests: rtol 1e-4 / atol 1e-5 here, the JAX test's 1e-2 for bfloat16
    weights, whose ZeRO gradients are summed in float32 rather than in
    bfloat16)."""
    out, _, _ = dp_run
    z0, z1 = (('mlp_z%d_i1' % z) if case == 'mlp' else '%s_z%d' % (case, z)
              for z in (0, 1))
    a, b = _pick(out[0], z0), _pick(out[0], z1)
    tol = dict(rtol=1e-2, atol=1e-2) if case == 'bf16' else STEP
    _close(b, a, tol, [k for k in a if k[:3] in ('p__', 'm__', 'w__')])


@pytest.mark.parametrize('case', ['bf16_z0', 'bf16_z1', 'clip_z0',
                                  'clip_z1'])
def test_bf16_masters_and_clipping_match_the_jax_module(dp_run, case):
    out, _, _ = dp_run
    got = _ranks_equal(out, case)
    jax = _ref('jax', case, N)
    tol = dict(rtol=1e-2, atol=1e-2) if case.startswith('bf16') else STEP
    _close(got, jax, tol, [k for k in jax if k[:3] in ('p__', 'm__')])


@pytest.mark.parametrize('norm', ['batch', 'valid'])
def test_loss_head_normalization_counts_the_global_batch(dp_run, norm):
    """SoftmaxOutput's 'batch' and 'valid' (ignored labels) scale by the
    global batch's count: the JAX package's step and the one-device
    step."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'norm_' + norm)
    _close(got, _ref('jax', 'norm_' + norm, N), STEP,
           ['p__fc1_weight', 'p__fc2_weight', 'p__fc2_bias'])
    one = _ref('port', 'norm_' + norm, 1)
    _close(got, one, ONE_DEVICE, _state_keys(one))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batchnorm_step_at_data_2_is_the_one_device_step(dp_run, dtype):
    """The conv -> BatchNorm net: its statistics summed over the data
    axis, the moving statistics equal on both ranks and to the one
    device's, and the step the JAX package's over two devices."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'bn_%s_clean' % dtype)
    one = _ref('port', 'bn_' + dtype, 1)
    jax = _ref('jax', 'bn_' + dtype, N)
    tol = ONE_DEVICE if dtype == 'float32' else BF16
    keys = [k for k in one if k[:3] in ('p__', 'a__')]
    _close(got, one, dict(rtol=1e-4, atol=1e-5) if dtype == 'float32'
           else tol, keys, 'vs one device')
    _close(got, jax, STEP if dtype == 'float32' else BF16, keys, 'vs JAX')


PLANTS = [(d, p) for d in ('float32', 'bfloat16')
          for p in ('local', 'identity_backward')]


def _gate_ratio(got, want, keys, tol):
    """The largest |got - want| / (atol + rtol |want|): at most 1 inside
    assert_allclose's gate."""
    worst = 0.0
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        worst = max(worst, float(np.max(np.abs(g - w) / (
            tol['atol'] + tol['rtol'] * np.abs(w)))))
    return worst


@pytest.mark.parametrize('dtype,plant', PLANTS)
def test_planted_statistics_faults_fail_the_gate(dp_run, dtype, plant):
    """Per-rank statistics, and a statistic sum whose backward does not
    sum the cotangent, each move the step past the one-device gate of
    the test above by more than twice its tolerance; the clean run stays
    inside it (in bfloat16 about a fifth of it)."""
    out, _, _ = dp_run
    one = _ref('port', 'bn_' + dtype, 1)
    keys = [k for k in one if k[:3] in ('p__', 'a__')]
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == 'float32' else BF16
    clean = _gate_ratio(_pick(out[0], 'bn_%s_clean' % dtype), one, keys, tol)
    bad = _gate_ratio(_pick(out[0], 'bn_%s_%s' % (dtype, plant)), one, keys,
                      tol)
    assert clean <= 1.0
    assert bad > 2.0, (clean, bad)


def test_outputs_metric_and_device_fold_cover_the_global_batch(dp_run):
    """get_outputs gathers the global batch (the JAX package's outputs),
    update_metric counts it, and bulk_step's device fold sums its carry
    over the data axis: the host loop's metric, in one dispatch."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'mlp_z0_i1')
    jax = _ref('jax', 'mlp_z0_i1', N)
    assert got['out'].shape == (4, DP_BATCH, 5)
    np.testing.assert_allclose(got['out'], jax['out'], **STEP)
    for z in (0, 1):
        bulk = _pick(out[0], 'bulk_z%d' % z)
        assert float(bulk['metric']) == float(got['metric'])
        assert int(bulk['dispatches']) == 1
        assert int(bulk['metric_steps']) == 4


@pytest.mark.parametrize('zero', [0, 1])
def test_bulk_step_matches_the_jax_module(dp_run, zero):
    out, _, _ = dp_run
    got = _ranks_equal(out, 'bulk_z%d' % zero)
    jax = _ref('jax', 'bulk_z%d' % zero, N)
    _close(got, jax, STEP, [k for k in jax if k[:3] in ('p__', 'm__')])
    assert float(got['metric']) == float(jax['metric'])


def test_fit_on_the_mesh_staging_is_the_one_device_fit(dp_run):
    """fit(bulk=2) stages each rank's rows (io.prefetch_to_device(mesh=))
    and trains the one-device epoch; on the CPU nothing is staged through
    host memory."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'fit')
    one = _ref('port', 'fit', 1)
    _close(got, one, ONE_DEVICE, [k for k in one if k[:3] in ('p__', 'm__')])
    assert int(got['staged_bytes']) == 0


def test_dropout_draws_the_one_device_mask(dp_run):
    out, _, _ = dp_run
    got = _ranks_equal(out, 'dropout')
    one = _ref('port', 'dropout', 1)
    _close(got, one, ONE_DEVICE, _state_keys(one))


def test_input_gradients_are_gathered(dp_run):
    out, _, _ = dp_run
    for r in range(N):
        np.testing.assert_allclose(out[r]['igrad'],
                                   _ref('port', 'igrad', 1)['igrad'],
                                   **ONE_DEVICE)
    np.testing.assert_allclose(out[0]['igrad'],
                               _ref('jax', 'igrad', N)['igrad'], **STEP)


@functools.lru_cache(maxsize=None)
def _br_ref(pkg_name, case, ndev):
    """The reducer case of br_step run by one package over ndev devices."""
    pkg = jmx if pkg_name == 'jax' else mx
    res = {}
    with (mx.cpu() if pkg is mx else _Null()):
        br_step(pkg, case, _ctxs(pkg, ndev), INPUTS['X'][0], INPUTS['y'][0],
                res, 'r')
    return _pick(res, 'r')


@pytest.mark.parametrize('case', BR_CASES)
def test_batch_reduction_is_global_under_the_data_mesh(dp_run, case):
    """Each registered op that reduces over the batch axis, at data 2,
    between a parameter before it (fc1, or w1) and one after it (w2):
    the gathered (or replicated) outputs, every parameter's gradient and
    one SGD update equal the JAX Module's over two devices and the
    port's one-device step on the global batch, on both ranks bit for
    bit. The cases add ties of max and min that straddle the ranks
    (the data's gradient splits over all of them), a chain of two
    reductions, and a replicated mean entering the batch's rows."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'br_' + case)
    one = _br_ref('port', case, 1)
    assert sorted(got) == sorted(one)
    _close(got, one, STEP, what='one device')
    _close(got, _br_ref('jax', case, N), STEP, what='jax')
    # every gradient is live but fc1's through argsort's indices
    for k in got:
        if k.startswith('g__') and not (case == 'argsort' and 'fc1' in k):
            assert np.abs(got[k]).sum() > 0, k


@pytest.mark.parametrize('zero', [0, 1])
def test_bucketing_module_over_two_ranks(dp_run, zero):
    """BucketingModule over two contexts: buckets 8 and 4 share the
    parameters, the optimizer (ZeRO's too: every bucket's gradients
    stay the rank's own for its reduce-scatter) and the data mesh; the
    one-device bucketing steps."""
    out, _, _ = dp_run
    got = _ranks_equal(out, 'bucketing_z%d' % zero)
    one = _ref('port', 'bucketing', 1)
    _close(got, one, ONE_DEVICE, [k for k in one if k.startswith('p__')])
    _close(got, _ref('jax', 'bucketing', N), STEP,
           [k for k in one if k.startswith('p__')])


def _restore_port(directory, ndev=1):
    with mx.cpu():
        net = dp_mlp(mx)
        mod = dp_module(mx, net, _ctxs(mx, ndev), MLP,
                        *dp_params(net, MLP, seed=9), zero=1)
        info = elastic.resume(elastic.CheckpointManager(str(directory)),
                              mod)
    assert info is not None and info.step == 2
    return _opt_states(mod)


def _assert_states_equal(got, want):
    for part_got, part_want in zip(got, want):
        assert sorted(part_got) == sorted(part_want)
        for k in part_want:
            np.testing.assert_array_equal(part_got[k], part_want[k],
                                          err_msg=k)


@pytest.mark.parametrize('width', [1, 2])
def test_jax_zero_checkpoint_restores_into_the_port(dp_run, width):
    """A ZeRO checkpoint the JAX package wrote over eight devices (mode
    'zero') restores into the port at data 1 and 2: the momenta, byte
    for byte."""
    out, tmp, jax_states = dp_run
    if width == 2:
        got = _ranks_equal(out, 'ckpt_jax')
        assert int(got['step']) == 2
        moms = {k[3:]: v for k, v in got.items() if k.startswith('m__')}
        _assert_states_equal((moms,), jax_states[:1])
    else:
        _assert_states_equal(_restore_port(tmp / 'ckpt_jax'), jax_states)


@pytest.mark.parametrize('into', ['jax_8', 'port_1'])
def test_port_zero_checkpoint_restores_elsewhere(dp_run, into):
    """The two ranks' ZeRO checkpoint (each rank its blocks) restores
    into the JAX package over eight devices and into one port device
    (2 -> 1), the momenta byte for byte with the gathered ones."""
    out, tmp, _ = dp_run
    saved = _ranks_equal(out, 'ckpt_saved')
    want = ({k[3:]: v for k, v in saved.items() if k.startswith('m__')},)
    import json
    man = json.loads(next((tmp / 'ckpt_port').glob('step-*')).joinpath(
        'manifest.json').read_text())
    assert man['opt']['mode'] == 'zero' and len(man['files']) == 2
    if into == 'port_1':
        got = _restore_port(tmp / 'ckpt_port')
    else:
        net = dp_mlp(jmx)
        mod = dp_module(jmx, net, _ctxs(jmx, JAX_CKPT_DEVICES), MLP,
                        *dp_params(net, MLP, seed=9), zero=1)
        assert jelastic.resume(jelastic.CheckpointManager(
            str(tmp / 'ckpt_port')), mod) is not None
        got = _opt_states(mod)
    _assert_states_equal(got[:1], want)


def test_state_bytes_and_comm_counters(dp_run):
    """ZeRO-1 at data 2 holds half the replicated state bytes (+ padding)
    a rank; comm_stats counts the reduce-scattered and all-gathered
    bytes of the layout each step, the gloo wire carrying each
    reduce-scatter as an all-reduce, and the replicated step's bucket
    all-reduces."""
    out, _, _ = dp_run
    for r in range(N):
        z0 = _pick(out[r], 'mlp_z0_i1')
        z1 = _pick(out[r], 'mlp_z1_i1')
        rep, shard = int(z0['state_bytes']), int(z1['state_bytes'])
        assert shard <= rep // N + 4 * N * 4, (rep, shard)
        assert int(z1['stat__optimizer_state_bytes_per_device']) == shard
        assert int(z1['stat__bytes_reduce_scattered']) > 0
        assert int(z1['stat__bytes_reduce_scattered']) % 4 == 0
        assert int(z1['stat__zero_wire_all_reduce']) > 0
        assert int(z0['stat__reduce_buckets_issued']) == 4
        assert int(z0['stat__bytes_reduce_scattered']) == 0


def test_dist_jax_mode_through_the_launcher(tmp_path):
    """Two workers of the port's tools/launch.py with
    MXNET_TPU_DIST_JAX=1: dist.initialize brings up one torch.distributed
    group, the host allreduce is off, and a Module over the workers' two
    contexts trains as one data mesh with ZeRO-1: both workers hold the
    same step, the one-device step's."""
    np.savez(tmp_path / 'inputs.npz', **INPUTS)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('DMLC_', 'MXNET_TPU_'))}
    env.update(PYTHONPATH=os.pathsep.join([str(REPO / 'tests'), str(REPO)]),
               MXNET_TPU_DIST_JAX='1', MXNET_TPU_DIST_DEVICE='cpu')
    res = subprocess.run(
        [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n', '2',
         '--launcher', 'local', sys.executable,
         str(REPO / 'tests' / '_torch_parallel_ranks.py'), str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=str(tmp_path))
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert 'WORKER_OK 0' in res.stdout and 'WORKER_OK 1' in res.stdout
    out = []
    for r in range(2):
        with np.load(tmp_path / ('r%d.npz' % r)) as z:
            out.append({k: z[k] for k in z.files})
    for r in range(2):
        assert not bool(out[r]['host_span']) and int(out[r]['world']) == 2
    got = _ranks_equal(out, 'w')
    with mx.cpu():
        net = dp_mlp(mx)
        mod = dp_module(mx, net, [mx.cpu()], MLP, *dp_params(net, MLP),
                        zero=1)
        one = {}
        dp_train(mx, mod, dp_batches(mx, INPUTS['X'], INPUTS['y'])[:3], one,
                 'r')
    one = _pick(one, 'r')
    _close(got, one, ONE_DEVICE, _state_keys(one))


# -- chip_smoke.py's gate of phase 29 ------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dp_rows(cs):
    want = cs.route_pairs(cs.RESNET_PAIRS, cs.stem_split_on())
    rows = []
    for r in range(cs.DP_RANKS):
        rows.append(dict(
            rank=r, data=cs.DP_RANKS, backend='gloo', staged=True,
            local_batch=cs.RESNET_BATCH // cs.DP_RANKS, host_span=False,
            launches_per_step=[want] * cs.DP_STEPS,
            kernel_checks=[dict(x=[128, 56, 56, 64], w=[3, 3, 64, 64],
                                ok=True)],
            state_bytes=102106796,
            comm=dict(zero_wire_all_reduce=12,
                      bytes_reduce_scattered=306593832),
            param_digest='p', aux_digest='a', loss=[7.1, 7.0, 6.9]))
    rows[0].update(output_max_abs_err=3e-4,
                   cut_updates=dict(ok=True),
                   cut_planted_updates=dict(ok=False),
                   restore=dict(ok=True))
    world1 = dict(state_bytes_z0=204213592,
                  reference=dict(loss=7.1003))
    return rows, world1


DP_FAULTS = {
    'launches': lambda rows, w: rows[1].update(
        launches_per_step=[33, 32, 32]),
    'kernel': lambda rows, w: rows[0]['kernel_checks'][0].update(ok=False),
    'state_bytes': lambda rows, w: rows[1].update(state_bytes=130000000),
    'no_zero_wire': lambda rows, w: rows[0]['comm'].update(
        zero_wire_all_reduce=0),
    'params_differ': lambda rows, w: rows[1].update(param_digest='q'),
    'aux_differ': lambda rows, w: rows[1].update(aux_digest='b'),
    'loss': lambda rows, w: w['reference'].update(loss=7.2),
    'outputs': lambda rows, w: rows[0].update(output_max_abs_err=0.5),
    'cut_updates': lambda rows, w: rows[0]['cut_updates'].update(ok=False),
    'planted_passed': lambda rows, w: rows[0]['cut_planted_updates'].update(
        ok=True),
    'restore': lambda rows, w: rows[0]['restore'].update(ok=False),
    'nccl': lambda rows, w: rows[0].update(backend='nccl'),
}


@pytest.mark.parametrize('fault', ['clean'] + sorted(DP_FAULTS))
def test_phase_29_gate(fault):
    """chip_smoke.dp_gate passes a good pair of rank rows and fails each
    fault planted in them."""
    cs = _chip_smoke()
    rows, world1 = _dp_rows(cs)
    if fault != 'clean':
        DP_FAULTS[fault](rows, world1)
    bad = cs.dp_gate(rows, world1)
    assert (bad == []) == (fault == 'clean'), bad
