"""The port's user-program runner (mxnet_tpu_torch/tools/run_script.py)
and its copies of the JAX package's tools/im2rec.py and
tools/bandwidth.py, on the CPU.

The runner resolves `mxnet_tpu` to the port's very modules, fails
loudly (a name the port lacks, no `--device` without CUDA, a module
loaded from the JAX package), and a user BaseModule subclass inside a
SequentialModule gives the JAX package's outputs through it. im2rec
writes the JAX tool's .lst, .rec and .idx files byte for byte; the
bandwidth tool's parameter-server arm prints the JAX tool's fields.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, 'tests', '_torch_examples_child.py')
RUNNER = [sys.executable, '-m', 'mxnet_tpu_torch.tools.run_script']


def env():
    path = [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(
        os.pathsep) if p]
    return dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
                PYTHONPATH=os.pathsep.join(path))


def run(cmd, timeout=300, **kw):
    return subprocess.run(cmd, cwd=REPO, env=env(), capture_output=True,
                          text=True, timeout=timeout, **kw)


def script(tmp_path, body):
    path = os.path.join(str(tmp_path), 'user_script.py')
    with open(path, 'w') as f:
        f.write(body)
    return path


# -- the runner --------------------------------------------------------

def test_runner_resolves_mxnet_tpu_to_the_port_modules(tmp_path):
    path = script(tmp_path, '''
import sys
import mxnet_tpu as mx
import mxnet_tpu.module.base_module as bm
from mxnet_tpu import nd, sym
import mxnet_tpu_torch
from mxnet_tpu_torch.module import base_module
assert mx is mxnet_tpu_torch
assert bm is base_module and bm.BaseModule is base_module.BaseModule
assert nd.NDArray is mxnet_tpu_torch.ndarray.NDArray
assert sym is mxnet_tpu_torch.symbol
assert sys.argv[1:] == ['--flag', 'x'], sys.argv
assert __name__ == '__main__'
print('ctx', mx.current_context(), (nd.ones((2,)) * 3).asnumpy().sum())
''')
    proc = run(RUNNER + ['--device', 'cpu', path, '--flag', 'x'])
    assert proc.returncode == 0, proc.stderr
    assert 'ctx cpu(0) 6.0' in proc.stdout, proc.stdout
    report = [ln for ln in proc.stderr.splitlines()
              if ln.startswith('run_script: ')]
    assert len(report) == 1, proc.stderr
    assert '"mxnet_tpu": "mxnet_tpu_torch"' in report[0], report


def test_runner_fails_on_a_module_the_port_lacks(tmp_path):
    path = script(tmp_path, 'import mxnet_tpu.pallas_ops\n')
    proc = run(RUNNER + ['--device', 'cpu', path])
    assert proc.returncode != 0
    assert "No module named 'mxnet_tpu_torch.pallas_ops'" in proc.stderr, \
        proc.stderr
    assert 'run_script: ' not in proc.stderr


def test_runner_without_device_needs_cuda(tmp_path):
    marker = os.path.join(str(tmp_path), 'ran')
    path = script(tmp_path, 'open(%r, "w").close()\n' % marker)
    proc = run(RUNNER + [path])
    assert proc.returncode != 0
    assert 'runs on cuda:0' in proc.stderr, proc.stderr
    assert not os.path.exists(marker)


def test_runner_exit_check_catches_the_jax_package(tmp_path):
    """A module executed from a mxnet_tpu/ directory fails the exit
    check (here the script loads one by path, past the finder)."""
    path = script(tmp_path, '''
import importlib.util, os
p = os.path.join(%r, 'mxnet_tpu', 'log.py')
spec = importlib.util.spec_from_file_location('jax_log', p)
m = importlib.util.module_from_spec(spec)
import sys; sys.modules['jax_log'] = m
spec.loader.exec_module(m)
''' % REPO)
    proc = run(RUNNER + ['--device', 'cpu', path])
    assert proc.returncode != 0
    assert 'the JAX package was reached' in proc.stderr, proc.stderr


def test_user_base_module_in_sequential_module(tmp_path):
    """examples/stochastic_depth's composition: a user BaseModule
    subclass, written for the JAX package, inside a SequentialModule,
    bound at 4 rows: the port through the runner's finder gives the JAX
    package's eval and train outputs and input gradient. (Run through a
    finder that loads a second copy of the port's modules under the
    `mxnet_tpu.` names, the probe forward of SequentialModule.bind met
    NDArrays of the other copy's class and made an object array of
    them.)"""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    try:
        import _torch_user_module as user
        want = user.run(0)
    finally:
        sys.path.remove(os.path.join(REPO, 'tests'))
    out = os.path.join(str(tmp_path), 'port.npz')
    proc = run([sys.executable, CHILD, 'module', out,
                os.path.join(REPO, 'tests', '_torch_user_module.py'), '0'])
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# -- im2rec ------------------------------------------------------------

def write_images(root, n=12, seed=0):
    """n seeded JPEGs of mixed sizes in two class folders."""
    import cv2
    rs = np.random.RandomState(seed)
    for i in range(n):
        folder = os.path.join(root, 'class%d' % (i % 2))
        os.makedirs(folder, exist_ok=True)
        h, w = rs.randint(40, 90, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(os.path.join(folder, 'img%02d.jpg' % i), img)


@pytest.mark.parametrize('mode', ['raw', 'resize_crop'])
def test_im2rec_matches_the_jax_tool(tmp_path, mode):
    root = os.path.join(str(tmp_path), 'images')
    write_images(root)
    flags = ['--resize', '64', '--center-crop'] if mode == 'resize_crop' \
        else []
    tools = {'jax': [sys.executable, os.path.join(REPO, 'tools',
                                                  'im2rec.py')],
             'port': [sys.executable, '-m', 'mxnet_tpu_torch.tools.im2rec']}
    files = {}
    for name, tool in tools.items():
        prefix = os.path.join(str(tmp_path), name)
        proc = run(tool + ['--list', '--recursive', prefix, root])
        assert proc.returncode == 0, proc.stderr
        proc = run(tool + [prefix, root] + flags)
        assert proc.returncode == 0, proc.stderr
        assert 'packed 12 records' in proc.stdout, proc.stdout
        files[name] = {ext: open(prefix + ext, 'rb').read()
                       for ext in ('.lst', '.rec', '.idx')}
    for ext in ('.lst', '.rec', '.idx'):
        assert files['port'][ext] == files['jax'][ext], ext
    lines = files['port']['.lst'].decode().splitlines()
    assert len(lines) == 12 and {ln.split('\t')[1] for ln in lines} == \
        {'0.000000', '1.000000'}
    order = [int(ln.split('\t')[0]) for ln in lines]
    assert order != sorted(order)           # the seeded shuffle


# -- bandwidth ---------------------------------------------------------

def test_bandwidth_ps_arm_reports_the_jax_fields():
    args = ['--test', 'ps', '--size-mb', '1', '--iters', '3', '-n', '2']
    pattern = re.compile(r'^workers=(\d+) payload=([\d.]+)MB '
                         r'time=([\d.]+)ms bw=([\d.]+) GB/s/worker$')
    fields = {}
    for name, tool in (
            ('jax', [sys.executable, os.path.join(REPO, 'tools',
                                                  'bandwidth.py')]),
            ('port', [sys.executable, '-m',
                      'mxnet_tpu_torch.tools.bandwidth'])):
        proc = run(tool + args)
        assert proc.returncode == 0, proc.stderr
        lines = [m for m in map(pattern.match, proc.stdout.splitlines())
                 if m]
        assert len(lines) == 1, proc.stdout
        fields[name] = lines[0].groups()
    assert fields['port'][:2] == fields['jax'][:2] == ('2', '1.0')
    assert float(fields['port'][2]) > 0 and float(fields['port'][3]) > 0
