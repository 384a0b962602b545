"""Hybrid workers on the port (mxnet_tpu_torch): a data mesh inside each
worker beside the parameter server or the dist runtime's host
all-reduce across workers, held against the JAX package's hybrid worker.

The JAX package's dryrun phase (f) starts `tools/launch.py -n 2 -s 1`
over `__graft_entry__._dist_hybrid_worker`: two worker processes, each
a two-device data mesh, synced through a CPU parameter server. Here the
test runs that worker as the dryrun does (nothing in it edited) and,
beside it, the port's two workers of two gloo ranks each
(`mxnet_tpu_torch.tools.launch --ranks-per-worker 2`, the ranks running
tests/_torch_hybrid_worker.py) through the server and, with -s 0,
through the dist runtime's host all-reduce. Every rank starts from the
weights the JAX workers start training from (saved by an observer of
their Module's init_optimizer) and takes the same batches. The probe's sync-SGD arithmetic is exact, the
port's four ranks end bit-equal, and their weights match the JAX
workers' at the JAX tests' step tolerance (rtol 1e-4 / atol 1e-5).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip('torch')

REPO = Path(__file__).resolve().parents[1]
STEP = dict(rtol=1e-4, atol=1e-5)
WORKERS, RANKS = 2, 2
ARMS = ('ps', 'host')


def _env(**extra):
    env = dict(os.environ)
    for stale in ('DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', 'DMLC_ROLE',
                  'DMLC_NUM_WORKER', 'DMLC_NUM_SERVER', 'DMLC_WORKER_ID',
                  'MXNET_TPU_DIST_JAX', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK',
                  'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(stale, None)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(REPO), env.get('PYTHONPATH', '')])
    env.update(extra)
    return env


# the JAX worker as the dryrun writes it, with an observer that saves the
# weights its Module starts training from (init_optimizer's entry)
JAX_WORKER = """import os
import numpy as np
import mxnet_tpu.module.module as jmodule
_init_optimizer = jmodule.Module.init_optimizer


def _observed(self, *args, **kwargs):
    params, _ = self.get_params()
    np.savez(os.path.join(os.environ['MXNET_TPU_HYBRID_OUT'],
                          'init_rank%%s.npz' %% os.environ['DMLC_WORKER_ID']),
             **{k: v.asnumpy() for k, v in params.items()})
    return _init_optimizer(self, *args, **kwargs)


jmodule.Module.init_optimizer = _observed
import __graft_entry__ as g
g._dist_hybrid_worker(%d)
"""


def _run(cmd, env, timeout=240):
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO),
                       env=env, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture(scope='module')
def hybrid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('hybrid')
    jax_out = tmp / 'jax'
    jax_out.mkdir()
    worker = jax_out / 'hybrid_worker.py'
    worker.write_text(JAX_WORKER % RANKS)
    flags = [f for f in os.environ.get('XLA_FLAGS', '').split()
             if 'xla_force_host_platform_device_count' not in f]
    logs = {'jax': _run(
        [sys.executable, str(REPO / 'tools' / 'launch.py'), '-n',
         str(WORKERS), '-s', '1', '--launcher', 'local', sys.executable,
         str(worker)],
        _env(JAX_PLATFORMS='cpu', MXNET_TPU_HYBRID_OUT=str(jax_out),
             XLA_FLAGS=' '.join(flags + [
                 '--xla_force_host_platform_device_count=%d' % RANKS])))}
    _ok(logs, 'jax')
    init = dict(np.load(jax_out / 'init_rank0.npz'))
    procs = {}
    for arm in ARMS:
        out = tmp / arm
        out.mkdir()
        np.savez(out / 'init.npz', **init)
        procs[arm] = subprocess.Popen(
            [sys.executable, '-m', 'mxnet_tpu_torch.tools.launch', '-n',
             str(WORKERS), '-s', '1' if arm == 'ps' else '0',
             '--ranks-per-worker', str(RANKS), sys.executable,
             str(REPO / 'tests' / '_torch_hybrid_worker.py'), str(out), arm],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(REPO), env=_env(MXNET_TPU_DIST_DEVICE='cpu'))
    for arm, p in procs.items():
        out, err = p.communicate(timeout=240)
        logs[arm] = (p.returncode, out, err)
    ranks = {}
    for arm in ARMS:
        if logs[arm][0] == 0:
            ranks[arm] = [[dict(np.load(tmp / arm / ('w%d_r%d.npz' % (w, r))))
                           for r in range(RANKS)] for w in range(WORKERS)]
    jax = [np.load(jax_out / ('params_rank%d.npy' % r))
           for r in range(WORKERS)]
    inits = [dict(np.load(jax_out / ('init_rank%d.npz' % r)))
             for r in range(WORKERS)]
    start = np.concatenate([init[k].ravel() for k in sorted(init)])
    return logs, ranks, jax, start, inits


def _ok(logs, name):
    rc, out, err = logs[name]
    assert rc == 0, (name, out[-3000:], err[-3000:])
    return out


def test_the_jax_hybrid_worker_runs_as_the_dryrun_runs_it(hybrid):
    logs, _, jax, _, inits = hybrid
    out = _ok(logs, 'jax')
    for r in range(WORKERS):
        assert 'HYBRID_OK rank=%d' % r in out
    np.testing.assert_array_equal(jax[0], jax[1])
    assert np.isfinite(jax[0]).all()
    # both JAX workers start from the same weights, which the port takes
    for k in inits[0]:
        np.testing.assert_array_equal(inits[0][k], inits[1][k])


@pytest.mark.parametrize('arm', ARMS)
def test_every_rank_exits_zero_through_the_launcher(hybrid, arm):
    logs = hybrid[0]
    out = _ok(logs, arm)
    for w in range(WORKERS):
        for r in range(RANKS):
            assert 'HYBRID_OK worker=%d rank=%d' % (w, r) in out


@pytest.mark.parametrize('arm', ARMS)
def test_probe_arithmetic_is_exact_on_every_rank(hybrid, arm):
    """W workers push rank + 1 to the accumulating 'test' optimizer: after
    round r every rank pulls (r + 1) * sum(1..W), as the JAX worker
    asserts."""
    logs, ranks = hybrid[:2]
    _ok(logs, arm)
    want = np.stack([np.full((2, 2), (r + 1) * sum(range(1, WORKERS + 1)),
                             np.float32) for r in range(3)])
    for w in range(WORKERS):
        for r in range(RANKS):
            res = ranks[arm][w][r]
            assert int(res['worker']) == w and int(res['group_rank']) == r
            assert int(res['num_workers']) == WORKERS
            # the data mesh is the worker's own ranks, not the job's
            assert int(res['world']) == RANKS
            np.testing.assert_array_equal(res['probe'], want)


@pytest.mark.parametrize('arm', ARMS)
def test_four_ranks_end_bit_equal_and_match_the_jax_workers(hybrid, arm):
    logs, ranks, jax, start = hybrid[:4]
    _ok(logs, arm)
    _ok(logs, 'jax')
    flats = [ranks[arm][w][r]['flat'] for w in range(WORKERS)
             for r in range(RANKS)]
    for f in flats[1:]:
        np.testing.assert_array_equal(f, flats[0])
    np.testing.assert_allclose(flats[0], jax[0], **STEP)
    # three steps moved every weight
    assert (flats[0] != start).all()


def test_one_push_a_key_and_step_from_each_worker(hybrid):
    """Through the server only the group's leader pushes: two keys
    (fc_weight, fc_bias) a step, three steps; rescale_grad counts the
    worker's batch times the workers."""
    logs, ranks = hybrid[:2]
    _ok(logs, 'ps')
    for w in range(WORKERS):
        leader, other = ranks['ps'][w]
        assert int(leader['step_pushes']) == 3 * 2
        assert int(other['step_pushes']) == 0
        for res in (leader, other):
            assert float(res['rescale_grad']) == 1.0 / (2 * RANKS * WORKERS)
