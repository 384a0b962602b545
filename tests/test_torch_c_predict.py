"""The port's C predict API (mxnet_tpu_torch/csrc/capi/, built by
_build.c_predict_library with g++) on the CPU, held against the JAX
package's.

- the library builds with the host C++ compiler into build/, and a
  second call finds it built;
- driven by ctypes in this process with dev_type 1: create from the
  symbol JSON and the param blob, the output shape before the first
  forward, set input, forward, get output; the answers equal the port's
  Predictor bit for bit and the JAX package's Predictor (and, where it
  is built, the JAX package's libmxtpu.so) within rtol 1e-5 / atol
  1e-6; a wrong-size output buffer and a weight name as input are
  refused; MXTNDListCreate reads the blob;
- examples/c_predict/predict.c, unchanged, linked against the library
  and run with no PYTHONPATH, prints the class the Predictor gives;
- dev_type 3 fails MXTPredCreate, and so does dev_type 2 (the card) on a
  host without CUDA: nothing runs on the CPU in its place.
"""
import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import _core as jcore
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _build, model as model_mod
from mxnet_tpu_torch.predictor import Predictor

REPO = Path(__file__).resolve().parents[1]
CPU = mx.cpu()
DIM, HID, OUT = 12, 24, 4
JAX_TOL = dict(rtol=1e-5, atol=1e-6)


def _checkpoint(tmp_path):
    """A seeded classifier checkpoint (MXTPU001 files) and a sample."""
    rs = np.random.RandomState(0)
    data = mx.sym.Variable('data')
    fc1 = mx.sym.FullyConnected(data, num_hidden=HID, name='fc1')
    act = mx.sym.Activation(fc1, act_type='relu')
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(act, num_hidden=OUT, name='fc2'),
        name='softmax')
    args = {'fc1_weight': rs.randn(HID, DIM) * 0.5,
            'fc1_bias': rs.randn(HID) * 0.1,
            'fc2_weight': rs.randn(OUT, HID) * 0.5,
            'fc2_bias': rs.randn(OUT) * 0.1}
    prefix = str(tmp_path / 'deploy')
    model_mod.save_checkpoint(
        prefix, 1, net, {k: mx.nd.array(v.astype(np.float32), ctx=CPU)
                         for k, v in args.items()}, {})
    sample = rs.randn(DIM).astype(np.float32)
    return prefix, sample


@pytest.fixture(scope='module')
def lib_path():
    return _build.c_predict_library()


def _lib(path):
    lib = ctypes.CDLL(str(path))
    lib.MXTPredGetLastError.restype = ctypes.c_char_p
    return lib


def _create(lib, prefix, dev_type, dev_id=0):
    with open(prefix + '-symbol.json') as f:
        json_str = f.read().encode()
    with open(prefix + '-0001.params', 'rb') as f:
        params = f.read()
    shape = (ctypes.c_uint32 * 2)(1, DIM)
    indptr = (ctypes.c_uint32 * 2)(0, 2)
    keys = (ctypes.c_char_p * 1)(b'data')
    handle = ctypes.c_void_p()
    rc = lib.MXTPredCreate(json_str, params, len(params), dev_type,
                           dev_id, 1, keys, indptr, shape,
                           ctypes.byref(handle))
    return rc, handle, params


def _predict(lib, handle, sample):
    buf = np.ascontiguousarray(sample, dtype='<f4')
    rc = lib.MXTPredSetInput(
        handle, b'data', buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size)
    assert rc == 0, lib.MXTPredGetLastError()
    assert lib.MXTPredForward(handle) == 0, lib.MXTPredGetLastError()
    out = np.zeros(OUT, np.float32)
    rc = lib.MXTPredGetOutput(
        handle, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        OUT)
    assert rc == 0, lib.MXTPredGetLastError()
    return out


def test_library_builds_with_the_host_compiler(lib_path):
    assert lib_path.exists() and lib_path.name == 'libmxt_predict.so'
    assert lib_path.parent.parent.name == 'capi'
    log = (lib_path.parent / 'build.log').read_text()
    assert 'c_predict_api.cc' in log and '-lpython' in log
    assert _build.c_predict_library() == lib_path
    # the kernel library's sources stay the .cu / .cuh files
    assert all(p.suffix in ('.cu', '.cuh') for p in _build.sources())


def test_ctypes_matches_both_predictors(lib_path, tmp_path):
    prefix, sample = _checkpoint(tmp_path)
    lib = _lib(lib_path)
    rc, handle, params = _create(lib, prefix, 1)
    assert rc == 0, lib.MXTPredGetLastError()
    pre_shape = ctypes.POINTER(ctypes.c_uint32)()
    pre_ndim = ctypes.c_uint32()
    rc = lib.MXTPredGetOutputShape(handle, 0, ctypes.byref(pre_shape),
                                   ctypes.byref(pre_ndim))
    assert rc == 0, lib.MXTPredGetLastError()
    assert [pre_shape[i] for i in range(pre_ndim.value)] == [1, OUT]
    out = _predict(lib, handle, sample)
    want = Predictor.from_checkpoint(prefix, 1, {'data': (1, DIM)},
                                     ctx=CPU).predict(sample[None])[0]
    np.testing.assert_array_equal(out, want)
    jwant = JPredictor.from_checkpoint(prefix, 1, {'data': (1, DIM)}) \
        .predict(jmx.nd.array(sample[None]))[0]
    np.testing.assert_allclose(out, jwant, **JAX_TOL)
    # a wrong-size buffer is refused, not overrun; weights are no input
    small = np.zeros(OUT + 3, np.float32)
    assert lib.MXTPredGetOutput(
        handle, 0, small.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        OUT + 3) != 0
    w = np.zeros(HID * DIM, np.float32)
    assert lib.MXTPredSetInput(
        handle, b'fc1_weight',
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w.size) != 0
    assert b'not an input' in lib.MXTPredGetLastError()
    lib.MXTPredFree(handle)
    nd_handle = ctypes.c_void_p()
    nd_len = ctypes.c_uint32()
    rc = lib.MXTNDListCreate(params, len(params), ctypes.byref(nd_handle),
                             ctypes.byref(nd_len))
    assert rc == 0, lib.MXTPredGetLastError()
    assert nd_len.value == 4        # 2 weights + 2 biases
    key = ctypes.c_char_p()
    dptr = ctypes.POINTER(ctypes.c_float)()
    sptr = ctypes.POINTER(ctypes.c_uint32)()
    ndim = ctypes.c_uint32()
    assert lib.MXTNDListGet(nd_handle, 0, ctypes.byref(key),
                            ctypes.byref(dptr), ctypes.byref(sptr),
                            ctypes.byref(ndim)) == 0
    assert key.value.decode().startswith('arg:')
    lib.MXTNDListFree(nd_handle)


def test_ctypes_matches_the_jax_library(lib_path, tmp_path):
    if not jcore.available():
        pytest.skip("the JAX package's libmxtpu.so is not built")
    prefix, sample = _checkpoint(tmp_path)
    ours, theirs = _lib(lib_path), _lib(jcore._LIB_PATH)
    rc, h1, _ = _create(ours, prefix, 1)
    assert rc == 0, ours.MXTPredGetLastError()
    rc, h2, _ = _create(theirs, prefix, 1)
    assert rc == 0, theirs.MXTPredGetLastError()
    np.testing.assert_allclose(_predict(ours, h1, sample),
                               _predict(theirs, h2, sample), **JAX_TOL)
    ours.MXTPredFree(h1)
    theirs.MXTPredFree(h2)


def test_predict_c_example_prints_the_class(lib_path, tmp_path):
    prefix, sample = _checkpoint(tmp_path)
    inp = str(tmp_path / 'input.f32')
    np.ascontiguousarray(sample, dtype='<f4').tofile(inp)
    exe = str(tmp_path / 'predict')
    libdir = str(lib_path.parent)
    subprocess.run(['gcc', '-O2', str(REPO / 'examples' / 'c_predict' /
                                      'predict.c'),
                    '-o', exe, '-L' + libdir, '-lmxt_predict',
                    '-Wl,-rpath,' + libdir], check=True, timeout=120)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([exe, prefix + '-symbol.json',
                           prefix + '-0001.params', inp, '1', str(DIM)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = Predictor.from_checkpoint(prefix, 1, {'data': (1, DIM)},
                                     ctx=CPU).predict(sample[None])[0]
    assert 'predicted=%d ' % int(np.argmax(want)) in proc.stdout, \
        (proc.stdout, proc.stderr[-2000:])


@pytest.mark.parametrize('dev_type', [3, 0, 2])
def test_dev_type_other_than_cpu_and_card_or_no_card_fails(
        lib_path, tmp_path, dev_type, monkeypatch):
    if dev_type == 2:
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    prefix, _ = _checkpoint(tmp_path)
    lib = _lib(lib_path)
    rc, handle, _ = _create(lib, prefix, dev_type)
    assert rc != 0 and not handle.value
    err = lib.MXTPredGetLastError().decode()
    if dev_type == 2:
        assert 'is_available' in err, err
    else:
        assert 'dev_type' in err, err
