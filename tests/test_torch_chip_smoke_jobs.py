"""chip_smoke.py's background jobs and phase clock, on the CPU.

Phases 21, 22, 29 and 31 of chip_smoke.py start their launcher runs as
`Launch` jobs (a `Background` job each) that run while the script goes
on; phase 25 runs its runner and C programs the same way. These tests
hold the jobs' contract with small shell commands: the output kept, the
wall clock stopped at the command's exit and not when it is waited on,
work hooked to a command's exit run once it has exited (phase 29's
launch waits so for phase 21's), a job past its time limit stopped, and
every job left running stopped by `stop_all`.
"""
import importlib.util
import os
import subprocess
import time
from pathlib import Path

import pytest


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _no_job_left():
    yield
    CS.Background.stop_all()
    assert CS.Background.running == []


def test_background_keeps_output_and_exit_code():
    job = CS.Background(['sh', '-c', 'echo out; echo err >&2; exit 3'], 30)
    res, wall = job.wait()
    assert (res.returncode, res.stdout, res.stderr) == (3, 'out\n', 'err\n')
    assert wall >= 0 and job.wait() == (res, wall)
    assert job not in CS.Background.running


def test_background_wall_stops_at_exit_not_at_wait():
    job = CS.Background(['sh', '-c', 'sleep 0.2'], 30)
    time.sleep(3.0)
    _, wall = job.wait()
    assert 0.2 <= wall < 2.8


def test_background_jobs_run_at_once():
    t0 = time.perf_counter()
    jobs = [CS.Background(['sh', '-c', 'sleep 2'], 30) for _ in range(3)]
    for job in jobs:
        assert job.wait()[0].returncode == 0
    assert time.perf_counter() - t0 < 5.0    # one after another: 6 s


def test_after_runs_once_the_command_has_exited():
    job = CS.Background(['sh', '-c', 'sleep 0.5'], 30)
    seen = []
    job.after(lambda: seen.append(('early', job.proc.returncode)))
    assert seen == []
    job.wait()
    assert seen == [('early', 0)]
    job.after(lambda: seen.append(('late', job.proc.returncode)))
    assert seen == [('early', 0), ('late', 0)]


def test_background_past_its_limit_is_stopped():
    job = CS.Background(['sleep', '60'], 0.5)
    with pytest.raises(subprocess.TimeoutExpired):
        job.wait()
    assert job.proc.returncode is not None
    assert job not in CS.Background.running


def test_stop_all_stops_every_running_job():
    jobs = [CS.Background(['sleep', '60'], 120) for _ in range(2)]
    CS.Background.stop_all()
    assert all(job.proc.returncode is not None for job in jobs)
    assert CS.Background.running == []


def test_launch_writes_its_log(tmp_path, capsys):
    (tmp_path / 'chiprun_out').mkdir()
    launch = CS.Launch(tmp_path, 'probe', ['sh', '-c', 'echo up; exit 0'],
                       dict(os.environ))
    res, wall = launch.wait()
    assert res.returncode == 0 and res.stdout == 'up\n'
    log = (tmp_path / 'chiprun_out' / 'dist_probe.log').read_text()
    assert log.startswith('$ sh -c echo up; exit 0\nrc 0, ')
    assert '--- stdout\nup\n' in log
    assert 'dist probe: launcher rc 0' in capsys.readouterr().out
    launch.wait()
    assert capsys.readouterr().out == ''


def test_start_launch_runs_the_port_launcher_on_this_script(tmp_path,
                                                            monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, root, tag, cmd, env):
            seen.update(root=root, tag=tag, cmd=cmd, env=env)

    monkeypatch.setattr(CS, 'Launch', Recorder)
    monkeypatch.setenv('MXNET_TPU_DIST_PORT', '1234')
    CS.start_launch(tmp_path, tmp_path / 'out', 'arm', 'coord', 2, 0,
                    env={'X_PROBE': '1'}, elastic=True)
    cmd = seen['cmd']
    assert cmd[1:4] == ['-m', 'mxnet_tpu_torch.tools.launch', '-n']
    assert '--elastic' in cmd and cmd[-6:] == [
        '--dist-worker', 'coord', '--dist-out', str(tmp_path / 'out'),
        '--dist-tag', 'arm']
    assert seen['env']['X_PROBE'] == '1'
    assert 'MXNET_TPU_DIST_PORT' not in seen['env']
    assert seen['env']['MXNET_TPU_DIST_DEAD_AFTER_S'] == \
        CS.DIST_ENV['MXNET_TPU_DIST_DEAD_AFTER_S']


def test_phase_clock_adds_a_phase_started_again(capsys):
    clock = CS.PhaseClock()
    clock.start(1)
    time.sleep(0.05)
    clock.start(2)
    clock.start(1)
    time.sleep(0.05)
    clock.stop()
    clock.stop()
    assert set(clock.seconds) == {1, 2}
    assert clock.seconds[1] >= 0.1          # both of its stretches
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(':')[0] for line in printed] == [
        'phase 1', 'phase 2', 'phase 1']
