"""chip_smoke.py's phases 39 (train_imagenet.py through the runner, on a
.rec packed by the port's im2rec) and 40 (two more examples through the
runner) on the CPU: their gates pass a good run and fail each fault
planted in it, and phase 39's whole path runs here at a cut size with
`--device cpu` for `--tpus 0`, where exactly the gates that need the
card fail."""
import copy
import importlib.util
import json
import math
import os
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

import mxnet_tpu_torch as mx

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
STEPS = 10


def good_run():
    """A run of phase 39 as the card gives it (10 steps of 64)."""
    return dict(
        report={'mxnet_tpu': 'mxnet_tpu_torch', 'jax': False,
                'launches': {'CONV_BN_STATS_LAUNCHES': 320},
                'peak_bytes': 5289309184},
        launches=320,
        speedometer=[dict(batch=b, samples_per_s=700.0 + b,
                          accuracy='0.2', top_k_accuracy_5='0.6')
                     for b in range(1, STEPS)],
        train_accuracy=[math.nan], params=259, params_finite=True,
        peak_bytes=5289309184)


def plant(name):
    run, reports = good_run(), 1
    if name == 'jax':
        run['report']['jax'] = True
    elif name == 'jax_package':
        run['report']['mxnet_tpu'] = 'mxnet_tpu'
    elif name == 'launches_without_stem_split':
        run['launches'] = 33 * STEPS
    elif name == 'a_step_uncounted':
        run['launches'] = 32 * (STEPS - 1)
    elif name == 'a_batch_missing':
        del run['speedometer'][4]
    elif name == 'nan_metric':
        run['speedometer'][3]['accuracy'] = 'nan'
    elif name == 'no_epoch_end':
        run['train_accuracy'] = []
    elif name == 'checkpoint_not_finite':
        run['params_finite'] = False
    elif name == 'no_peak':
        run['peak_bytes'] = None
    elif name == 'two_exit_lines':
        reports = 2
    return run, reports


def test_example_gate_passes_a_good_run():
    assert CS.example_gate(good_run(), 1, STEPS) == []


@pytest.mark.parametrize('name', [
    'jax', 'jax_package', 'launches_without_stem_split', 'a_step_uncounted',
    'a_batch_missing', 'nan_metric', 'no_epoch_end',
    'checkpoint_not_finite', 'no_peak', 'two_exit_lines'])
def test_example_gate_fails_a_planted_fault(name):
    run, reports = plant(name)
    assert len(CS.example_gate(run, reports, STEPS)) == 1, name


def test_example_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """The whole phase at 16 images of 64-80 px, batch 4: the JPEGs,
    the port's im2rec, train_imagenet.py through the runner, the
    checkpoint. Only the gates that need the card fail: fit.py asks jax
    for a context without --tpus, nothing launches the kernel, and no
    CUDA peak is kept."""
    monkeypatch.setattr(CS, 'EXAMPLE_IMAGES', 16)
    monkeypatch.setattr(CS, 'EXAMPLE_BATCH', 4)
    monkeypatch.setattr(CS, 'EXAMPLE_SIDES', (64, 80))
    monkeypatch.setattr(CS, 'EXAMPLE_SHAPE', '3,64,64')
    monkeypatch.setattr(torch.cuda, 'empty_cache', lambda: None)
    real_run = subprocess.run

    def on_cpu(cmd, **kw):
        i = cmd.index('--tpus')
        cmd = cmd[:i] + cmd[i + 2:]
        j = cmd.index('mxnet_tpu_torch.tools.run_script') + 1
        env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='2')
        return real_run(cmd[:j] + ['--device', 'cpu'] + cmd[j:], env=env,
                        **kw)
    monkeypatch.setattr(CS.subprocess, 'run', on_cpu)

    def fail(msg):
        raise AssertionError(msg)
    monkeypatch.setattr(CS, 'fail', fail)
    root = tmp_path / 'root'
    root.mkdir()
    for name in ('mxnet_tpu_torch', 'examples'):
        (root / name).symlink_to(REPO / name)
    with mx.cpu():
        with pytest.raises(AssertionError) as err:
            CS.example_phase(torch, mx, root, 'card, 700 W')
    reasons = str(err.value)[len('phase 39: '):].split('; ')
    assert reasons == ['jax was imported',
                       '0 conv launches in 4 steps, want 32 a step',
                       'no peak memory reported'], reasons
    assert not (root / 'build' / 'phase39').exists()


class _Done:
    """A Background whose command has ended with the given output."""

    def __init__(self, rc, stdout, stderr):
        self.result = (subprocess.CompletedProcess([], rc, stdout, stderr),
                       1.0)

    def wait(self):
        return self.result


def _exit_line(jax=False):
    return 'run_script: ' + json.dumps(
        {'mxnet_tpu': 'mxnet_tpu_torch', 'jax': jax, 'launches': {},
         'peak_bytes': 1})


def _more(gluon_acc='0.8936', ppl='40.7', jax=False, rc=0):
    return [_Done(rc, 'epoch 0 acc %s\n' % gluon_acc, _exit_line(jax)),
            _Done(0, '', 'Epoch[0] Train-perplexity=%s\n%s'
                  % (ppl, _exit_line()))]


@pytest.mark.parametrize('case, reason', [
    ('good', None), ('jax', 'runner exit lines'),
    ('low_accuracy', 'mnist_gluon.py: metric 0.1'),
    ('nan_perplexity', 'lstm_bucketing.py: metric nan'),
    ('exit', 'exited 1')])
def test_more_examples_gate(monkeypatch, case, reason):
    def fail(msg):
        raise AssertionError(msg)
    monkeypatch.setattr(CS, 'fail', fail)
    started = {'good': _more(), 'jax': _more(jax=True),
               'low_accuracy': _more(gluon_acc='0.1'),
               'nan_perplexity': _more(ppl='nan'),
               'exit': _more(rc=1)}[case]
    if reason is None:
        runs = CS.more_examples_phase(REPO, copy.copy(started))
        assert [r['metric'] for r in runs] == [0.8936, 40.7]
        return
    with pytest.raises(AssertionError, match=reason):
        CS.more_examples_phase(REPO, started)
