"""The port's native runtime (mxnet_tpu_torch/csrc/native/, built by
_build.native_library with g++ and OpenCV) on the CPU, held against the
JAX package's own library (libmxtpu.so) and its Python engine.

- mx.engine: write serialization, read/write ordering, independent
  parallelism, wait_for_var, an op's error raised at the next wait,
  duplicate vars refused, on the native engine and on NaiveEngine
  (MXNET_ENGINE_TYPE); a seeded program of 2,000 pushes over 32
  variables ends in the same state on the JAX native engine, the JAX
  Python engine, the port's native engine and its NaiveEngine; the
  workers are drained and joined at interpreter exit; no library, no
  engine.
- RecordIO: records written by the port's C writer read back by its C
  reader, the JAX library's reader and both packages' MXRecordIO, and
  the other way round.
- ImageRecordIter(use_native=True) bit-equal to the JAX package's
  _NativeImageRecordIter over two epochs (the same OpenCV calls and
  mt19937_64 seeds): plain, shuffle + random crop + mirror, resize with
  mean / std, num_parts / part_index, one channel, two labels, each with
  the padded last batch; resets mid-epoch each give the first epoch
  again; a record that fails to decode raises at the next batch (the
  JAX pipeline leaves the slot zero); use_native=None keeps the port's
  Python / nvJPEG pipeline (the JAX package's None takes its native one).
"""
import ctypes
import importlib.util
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

import mxnet_tpu as jmx
from mxnet_tpu import _core as jcore
from mxnet_tpu import engine as jengine
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _build, _core
from mxnet_tpu_torch import engine as engine_mod
from mxnet_tpu_torch import recordio as rec

REPO = Path(__file__).resolve().parents[1]
CPU = mx.cpu()

jax_native = pytest.mark.skipif(not jcore.available(),
                                reason="the JAX package's libmxtpu.so "
                                       "is not built")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(params=['native', 'naive'])
def engine(request, monkeypatch):
    if request.param == 'naive':
        monkeypatch.setenv('MXNET_ENGINE_TYPE', 'NaiveEngine')
        eng = engine_mod.Engine(num_workers=4)
        assert isinstance(eng._impl, engine_mod._PyEngine)
    else:
        monkeypatch.delenv('MXNET_ENGINE_TYPE', raising=False)
        eng = engine_mod.Engine(num_workers=4)
        assert isinstance(eng._impl, engine_mod._NativeEngine)
    yield eng
    eng.close()


# -- the engine --------------------------------------------------------------

def test_engine_write_serialization(engine):
    var = engine.new_variable()
    out = []
    for i in range(50):
        engine.push(lambda i=i: out.append(i), mutable_vars=(var,))
    engine.wait_all()
    assert out == list(range(50))


def test_engine_read_write_ordering(engine):
    var = engine.new_variable()
    state = {'x': 0}
    seen = []

    def write(v):
        def f():
            time.sleep(0.001)
            state['x'] = v
        return f

    def read():
        seen.append(state['x'])

    engine.push(write(1), mutable_vars=(var,))
    for _ in range(4):
        engine.push(read, const_vars=(var,))
    engine.push(write(2), mutable_vars=(var,))
    for _ in range(4):
        engine.push(read, const_vars=(var,))
    engine.wait_all()
    assert seen == [1] * 4 + [2] * 4


def test_engine_independent_parallelism():
    """Two chains on two variables overlap on the native workers."""
    eng = engine_mod.Engine(num_workers=4)
    v1, v2 = eng.new_variable(), eng.new_variable()
    intervals = []
    lock = threading.Lock()

    def op(tag):
        t0 = time.time()
        time.sleep(0.02)
        with lock:
            intervals.append((tag, t0, time.time()))
    for tag, v in (('a', v1), ('b', v2)):
        for _ in range(2):
            eng.push(lambda tag=tag: op(tag), mutable_vars=(v,))
    eng.wait_all()
    eng.close()
    a = [(s, e) for t, s, e in intervals if t == 'a']
    b = [(s, e) for t, s, e in intervals if t == 'b']
    assert any(s1 < e2 and s2 < e1 for s1, e1 in a for s2, e2 in b), (a, b)


def test_engine_wait_for_var(engine):
    var = engine.new_variable()
    done = []
    engine.push(lambda: (time.sleep(0.02), done.append(1)),
                mutable_vars=(var,))
    engine.wait_for_var(var)
    assert done == [1]


def test_engine_error_propagates_at_wait(engine):
    var = engine.new_variable()
    engine.push(lambda: (_ for _ in ()).throw(ValueError('boom')),
                mutable_vars=(var,))
    with pytest.raises(RuntimeError, match='engine op failed'):
        engine.wait_all()
    # reported once; the engine stays usable
    engine.push(lambda: None, mutable_vars=(var,))
    engine.wait_all()


def test_engine_rejects_duplicate_vars(engine):
    v = engine.new_variable()
    with pytest.raises(Exception):
        engine.push(lambda: None, mutable_vars=(v, v))
    with pytest.raises(Exception):
        engine.push(lambda: None, const_vars=(v,), mutable_vars=(v,))
    with pytest.raises(Exception):
        engine.push(lambda: None, const_vars=(v, v))
    engine.push(lambda: None, mutable_vars=(v,))
    engine.wait_all()


def test_engine_delete_variable_and_module_functions():
    eng = engine_mod.get()
    assert engine_mod.get() is eng
    var = engine_mod.new_variable()
    out = []
    engine_mod.push(lambda: out.append(1), mutable_vars=(var,))
    engine_mod.wait_for_var(var)
    engine_mod.delete_variable(var)
    engine_mod.wait_all()
    assert out == [1]
    with pytest.raises(_core.NativeError, match='unknown'):
        eng.push(lambda: None, mutable_vars=(var,))


@pytest.mark.parametrize('seed', [0, 1])
def test_engine_random_program_same_state_on_four_engines(seed,
                                                         monkeypatch):
    cs = _chip_smoke()
    engines = {'port native': engine_mod.Engine(num_workers=8)}
    monkeypatch.setenv('MXNET_ENGINE_TYPE', 'NaiveEngine')
    engines['port naive'] = engine_mod.Engine()
    monkeypatch.delenv('MXNET_ENGINE_TYPE')
    engines['jax python'] = jengine._PyEngine(8)
    if jcore.available():
        engines['jax native'] = jengine.Engine(num_workers=8)
        assert isinstance(engines['jax native']._impl,
                          jengine._NativeEngine)
    states = {name: cs.engine_program(eng, seed)
              for name, eng in engines.items()}
    engines['port native'].close()
    ref = states['port naive']
    assert len(ref) == cs.ENGINE_VARS and len(set(ref)) > 1
    for name, state in states.items():
        assert state == ref, name


def test_engine_threads_joined_at_exit(tmp_path):
    """Ops pushed and never waited for all run before the interpreter
    finalizes, and the process exits 0."""
    code = (
        'import atexit, sys, time\n'
        'out = []\n'
        'atexit.register(lambda: print("ran", len(out)))\n'
        'sys.path.insert(0, %r)\n'
        'from mxnet_tpu_torch import engine\n'
        'eng = engine.Engine(4)\n'
        'var = eng.new_variable()\n'
        'for i in range(40):\n'
        '    eng.push(lambda: (time.sleep(0.002), out.append(1)),\n'
        '             mutable_vars=(var,))\n' % str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ran 40' in proc.stdout, (proc.stdout, proc.stderr[-2000:])


def test_engine_raises_without_the_library(monkeypatch):
    def broken():
        raise RuntimeError('OpenCV 4 not found')
    monkeypatch.delenv('MXNET_ENGINE_TYPE', raising=False)
    monkeypatch.setattr(_build, 'native_library', broken)
    monkeypatch.setattr(_core, '_LIBS', {})
    with pytest.raises(_core.NativeError, match='OpenCV 4 not found'):
        engine_mod.Engine()


def test_without_opencv_the_engine_builds_and_the_iterator_raises(
        tmp_path, monkeypatch):
    """On a host without OpenCV 4's C++ package, the engine and RecordIO
    library still builds, and use_native=True raises naming OpenCV."""
    monkeypatch.setenv('PKG_CONFIG_PATH', str(tmp_path))
    monkeypatch.setenv('PKG_CONFIG_LIBDIR', str(tmp_path))
    monkeypatch.setattr(_core, '_LIBS', {})
    with pytest.raises(RuntimeError, match='OpenCV 4 not found'):
        _build.opencv_flags()
    assert _core.lib().MXTEngineCreate
    path = _write_images(tmp_path, n=2)
    with pytest.raises(_core.NativeError, match='OpenCV 4 not found'):
        mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                              batch_size=1, use_native=True, ctx=CPU)


def test_native_libraries_build_into_build():
    path = _build.native_library()
    assert path.name == 'libmxt_native.so'
    assert path.parent.parent.name == 'native'
    log = (path.parent / 'build.log').read_text()
    assert 'engine.cc' in log and 'opencv' not in log
    assert _build.native_library() == path
    image = _build.native_image_library()
    assert image.name == 'libmxt_native_image.so'
    log = (image.parent / 'build.log').read_text()
    assert 'image_record_iter.cc' in log and '-lopencv_imgcodecs' in log
    assert 'engine.cc' not in log
    # the port builds from its own sources, never from src/
    assert all(p.parent == REPO / 'mxnet_tpu_torch' / 'csrc' / 'native'
               for p in _build.native_sources())


# -- RecordIO ----------------------------------------------------------------

PAYLOADS = [b'hello', b'x' * 1000, b'abc' * 77, b'z', b'', b'q' * 4099]


def _c_write(lib, path):
    w = lib.MXTRecordWriterCreate(str(path).encode())
    assert w
    offsets = [lib.MXTRecordWriterWrite(w, p, len(p)) for p in PAYLOADS]
    lib.MXTRecordWriterFree(w)
    return offsets


def _c_read(lib, path):
    r = lib.MXTRecordReaderCreate(str(path).encode())
    assert r
    data_p, size = ctypes.c_char_p(), ctypes.c_uint64()
    out = []
    while True:
        ret = lib.MXTRecordReaderNext(r, ctypes.byref(data_p),
                                      ctypes.byref(size))
        assert ret >= 0, lib.MXTGetLastError()
        if ret == 0:
            break
        out.append(ctypes.string_at(data_p, size.value))
    lib.MXTRecordReaderFree(r)
    return out


def _py_read(pkg, path):
    r = pkg.MXRecordIO(str(path), 'r')
    out = []
    while True:
        item = r.read()
        if item is None:
            break
        out.append(item)
    r.close()
    return out


@jax_native
def test_recordio_cross_reads(tmp_path):
    ours, theirs = _core.lib(), jcore.lib()
    path = tmp_path / 'port_c.rec'
    offsets = _c_write(ours, path)
    assert offsets[0] == 0 and offsets == sorted(offsets)
    for reader in (lambda p: _c_read(ours, p), lambda p: _c_read(theirs, p),
                   lambda p: _py_read(rec, p), lambda p: _py_read(jrec, p)):
        assert reader(path) == PAYLOADS
    # the other way round: each writer read by the port's C reader
    jc = tmp_path / 'jax_c.rec'
    _c_write(theirs, jc)
    assert jc.read_bytes() == path.read_bytes()
    for pkg, name in ((rec, 'port_py.rec'), (jrec, 'jax_py.rec')):
        w = pkg.MXRecordIO(str(tmp_path / name), 'w')
        for p in PAYLOADS:
            w.write(p)
        w.close()
        assert _c_read(ours, tmp_path / name) == PAYLOADS
        assert (tmp_path / name).read_bytes() == path.read_bytes()


def test_recordio_reader_refuses_a_bad_file(tmp_path):
    lib = _core.lib()
    assert not lib.MXTRecordReaderCreate(str(tmp_path / 'none.rec').encode())
    assert b'cannot open' in lib.MXTGetLastError()
    bad = tmp_path / 'bad.rec'
    bad.write_bytes(b'\x00' * 16)
    r = lib.MXTRecordReaderCreate(str(bad).encode())
    data_p, size = ctypes.c_char_p(), ctypes.c_uint64()
    assert lib.MXTRecordReaderNext(r, ctypes.byref(data_p),
                                   ctypes.byref(size)) == -1
    assert b'magic' in lib.MXTGetLastError()
    lib.MXTRecordReaderFree(r)


# -- the image iterator --------------------------------------------------------

def _write_images(tmp_path, n=10, sides=(20, 48), labels=1, bad=None,
                  name='imgs'):
    """n seeded images (PNG and JPEG in turn, random sides) in
    name.rec / name.idx; record `bad` holds bytes no decoder reads."""
    prefix = str(tmp_path / name)
    w = rec.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    rng = np.random.RandomState(0)
    for i in range(n):
        h, wd = rng.randint(sides[0], sides[1] + 1, 2)
        img = rng.randint(0, 255, (h, wd, 3)).astype(np.uint8)
        ok, buf = cv2.imencode('.png' if i % 2 else '.jpg', img)
        assert ok
        payload = b'\x00garbage' * 8 if i == bad else buf.tobytes()
        label = float(i % 4) if labels == 1 else \
            [float(i % 4), float(i % 3) + 0.5]
        w.write_idx(i, rec.pack(rec.IRHeader(0, label, i, 0), payload))
    w.close()
    return prefix + '.rec'


ITER_CASES = {
    'plain': dict(data_shape=(3, 24, 24), batch_size=4),
    'shuffle_crop_mirror': dict(data_shape=(3, 18, 18), batch_size=4,
                                shuffle=True, rand_crop=True,
                                rand_mirror=True, seed=7),
    'resize_mean_std': dict(data_shape=(3, 20, 20), batch_size=3,
                            resize=26, mean_r=10., mean_g=20., mean_b=30.,
                            std_r=50., std_g=60., std_b=70.),
    'parts': dict(data_shape=(3, 16, 16), batch_size=2, num_parts=3,
                  part_index=1, shuffle=True, seed=3),
    'gray': dict(data_shape=(1, 22, 22), batch_size=4, rand_crop=True,
                 seed=5),
    'two_labels': dict(data_shape=(3, 16, 16), batch_size=4, label_width=2),
}


def _epochs(it, n=2):
    out = []
    for e in range(n):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


@jax_native
@pytest.mark.parametrize('case', sorted(ITER_CASES))
def test_native_iter_bit_equal_to_the_jax_pipeline(tmp_path, case):
    kw = dict(ITER_CASES[case])
    path = _write_images(tmp_path, n=11,
                         labels=kw.get('label_width', 1))
    ours = mx.io.ImageRecordIter(path_imgrec=path, use_native=True,
                                 preprocess_threads=3, ctx=CPU, **kw)
    assert isinstance(ours._inner, mx.io._NativeImageRecordIter)
    theirs = jmx.io.ImageRecordIter(path_imgrec=path, use_native=True,
                                    preprocess_threads=3, **kw)
    assert isinstance(theirs._inner, jmx.io._NativeImageRecordIter)
    got, want = _epochs(ours), _epochs(theirs)
    ours.close()
    assert ours.provide_data == [mx.io.DataDesc(
        'data', (kw['batch_size'],) + kw['data_shape'])]
    assert len(got[0]) == len(want[0]) >= 2
    assert got[0][-1][2] == want[0][-1][2]
    if case == 'plain':
        assert got[0][-1][2] == 1          # 11 records, batch 4: pad 1
    for e in range(2):
        for (d, l, p), (jd, jl, jp) in zip(got[e], want[e]):
            assert d.dtype == np.float32 and d.shape == jd.shape
            np.testing.assert_array_equal(d, jd)
            np.testing.assert_array_equal(l, jl)
            assert p == jp
    if kw.get('shuffle'):
        assert not all(np.array_equal(a[0], b[0])
                       for a, b in zip(got[0], got[1]))


def test_native_iter_resets_mid_epoch_give_the_first_epoch(tmp_path):
    path = _write_images(tmp_path, n=13)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                               batch_size=3, use_native=True,
                               preprocess_threads=8, prefetch_buffer=2,
                               ctx=CPU)
    first = [b.data[0].asnumpy() for b in it]
    rng = np.random.RandomState(1)
    for _ in range(40):
        it.reset()
        for _ in range(rng.randint(0, len(first))):
            it.next()
        it.reset()
        again = [b.data[0].asnumpy() for b in it]
        assert len(again) == len(first)
        for a, b in zip(again, first):
            np.testing.assert_array_equal(a, b)
    it.close()
    with pytest.raises(RuntimeError, match='closed'):
        it.next()


@jax_native
def test_a_decode_failure_raises_at_the_next_batch(tmp_path):
    path = _write_images(tmp_path, n=8, bad=5)
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4,
              use_native=True, preprocess_threads=2)
    it = mx.io.ImageRecordIter(ctx=CPU, **kw)
    with pytest.raises(_core.NativeError, match='decode failed'):
        for _ in it:
            pass
    # a reset starts a fresh epoch, which fails again at the same record
    it.reset()
    with pytest.raises(_core.NativeError, match='decode failed'):
        for _ in it:
            pass
    it.close()
    # the JAX pipeline prints the failure and leaves the slot zero
    jit = jmx.io.ImageRecordIter(**kw)
    batches = [b.data[0].asnumpy() for b in jit]
    assert len(batches) == 2 and not batches[1][1].any()


def test_use_native_none_keeps_the_python_pipeline(tmp_path):
    path = _write_images(tmp_path, n=4)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                               batch_size=2, ctx=CPU)
    assert isinstance(it._inner, mx.io.PrefetchingIter)
    assert it.next().data[0].shape == (2, 3, 16, 16)
    it.close()
    if jcore.available():
        jit = jmx.io.ImageRecordIter(path_imgrec=path,
                                     data_shape=(3, 16, 16), batch_size=2)
        assert isinstance(jit._inner, jmx.io._NativeImageRecordIter)


def test_native_iter_batches_land_on_the_ctx(tmp_path, monkeypatch):
    """A GPU ctx stages each batch through pinned memory (io.stage); the
    CPU one copies it out of the pipeline's buffer."""
    path = _write_images(tmp_path, n=4)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                               batch_size=2, use_native=True, ctx=CPU)
    a = it.next().data[0]
    b = it.next().data[0]
    assert a.context == CPU and not np.array_equal(a.asnumpy(),
                                                   b.asnumpy())
    it.close()
    staged = []

    def fake_stage(arrays, device=None, stream=None, mesh=None):
        staged.append((device, [tuple(t.shape) for t in arrays]))
        return mx.io._Staged([t.clone() for t in arrays], None)
    monkeypatch.setattr(mx.io, 'stage', fake_stage)
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                               batch_size=2, use_native=True,
                               ctx=mx.gpu(0))
    batch = it.next()
    it.close()
    assert staged == [(torch.device('cuda', 0), [(2, 3, 16, 16), (2,)])]
    assert batch.data[0].context == mx.gpu(0)
