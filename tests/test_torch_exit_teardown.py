"""Ranks of a gloo group exit through the interpreter cleanly (the exit
abort of ROADMAP Queue C2).

A gloo group's worker threads used to outlive the interpreter's
teardown: a Mesh's DeviceMesh kept the group alive after
`destroy_process_group`, and a worker thread that dropped the last
reference to a tensor Python made took the GIL during finalization and
aborted the process ("terminate called without an active exception",
4 to 13 runs in 60 before the repair). `mesh.destroy_process_group`
now releases every mesh's groups and joins their threads, and
init_process_group registers it to run at exit. Each run here is two
ranks of tests/_torch_exit_rank.py training gluon.nn.MoE through the
fused step over a data mesh, half of them leaving the teardown to the
exit handler; every rank must exit 0.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip('torch')

HERE = Path(__file__).resolve().parent
RUNS = 8
AT_ONCE = 2


def _start(tmp_path, run, mode):
    init = tmp_path / ('rdv%d' % run)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent), os.environ.get('PYTHONPATH', '')]))
    return [subprocess.Popen(
        [sys.executable, str(HERE / '_torch_exit_rank.py'), str(r), '2',
         str(init), mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(2)]


def test_moe_ranks_exit_cleanly_through_the_interpreter(tmp_path):
    t0 = time.monotonic()
    failures = []
    for first in range(0, RUNS, AT_ONCE):
        batch = [(run, _start(tmp_path, run,
                              'destroy' if run % 2 else 'atexit'))
                 for run in range(first, first + AT_ONCE)]
        for run, procs in batch:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=60)
                if p.returncode != 0 or 'EXIT_RANK_OK %d' % r not in out:
                    failures.append((run, r, p.returncode, err[-2000:]))
    assert not failures, failures
    assert time.monotonic() - t0 < 60
