"""Helpers of tests/test_torch_examples_cli*.py: run an example's
command line on the JAX package and, through
mxnet_tpu_torch.tools.run_script with `--device cpu`, on the port, at
the same time, each with logging at INFO (where Module.fit reports its
epoch metrics), and read a metric from their output. This module imports
neither package."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_RUN = ('import logging, os, runpy, sys; '
           'logging.basicConfig(level=logging.INFO); '
           'sys.argv = sys.argv[1:]; '
           'sys.path[0] = os.path.dirname(os.path.abspath(sys.argv[0])); '
           "runpy.run_path(sys.argv[0], run_name='__main__')")
PORT_RUN = ('import logging, sys; '
            'logging.basicConfig(level=logging.INFO); '
            'from mxnet_tpu_torch.tools import run_script; '
            'run_script.main(sys.argv[1:])')


def env():
    path = [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(
        os.pathsep) if p]
    return dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='2',
                PYTHONPATH=os.pathsep.join(path))


def both(jax_cmd, port_cmd, timeout=600):
    """Run the two commands at once; (jax output, port output), each
    stdout + stderr, after asserting that both exited with 0."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env(), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd in (jax_cmd, port_cmd)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
    for name, proc, out in zip(('jax', 'port'), procs, outs):
        assert proc.returncode == 0, (name, out[-4000:])
    assert '"mxnet_tpu": "mxnet_tpu_torch"' in outs[1], outs[1][-2000:]
    return outs


def run_both(rel, args, timeout=600):
    script = os.path.join(REPO, rel)
    return both([sys.executable, '-c', JAX_RUN, script] + args,
                [sys.executable, '-c', PORT_RUN, '--device', 'cpu',
                 script] + args, timeout)


def last(pattern, out):
    """The float of the last match of `pattern` in `out`."""
    found = re.findall(pattern, out)
    assert found, (pattern, out[-3000:])
    return float(found[-1])


def run_without_jax(rel, args=()):
    """The port's run of `rel` in a child where `import jax` fails, as
    on the card's host, where JAX is not installed."""
    return subprocess.run(
        [sys.executable, '-c', "import sys; sys.modules['jax'] = None; "
         + PORT_RUN, '--device', 'cpu', os.path.join(REPO, rel)]
        + list(args), cwd=REPO, env=env(), capture_output=True, text=True,
        timeout=300)
