"""The port's training C API (mxnet_tpu_torch/csrc/capi/c_api_train.cc in
the one C API library that _build.c_predict_library builds with g++) on
the CPU, held against the JAX package's libmxtpu.so.

- cpp-package/example/mlp_train.cpp, imperative_train.c and
  rec_train.cpp, unchanged, linked against the port's library and run
  with no PYTHONPATH, each reach the line the JAX package's test checks;
- op introspection from C: MXTListOpNames equals the JAX library's list,
  canonical names, input names, aliases, an unknown op refused, an op
  registered at run time seen; MXTRandomSeed makes the draws of an
  imperative sampler repeat, MXTNDArrayWaitAll returns 0;
- a float32 MLP trained for a few steps through the same MXT* calls on
  both libraries: losses and weights within rtol 1e-5 / atol 1e-6;
- dev_type 3 and, on a host without CUDA, dev_type 2 fail with
  MXTTrainGetLastError set; ImageRecordIter created from C takes
  use_native and, with no ctx, hands out host batches from the native
  pipeline and batches on gpu(0) from the port's where CUDA is;
- the Perl binding (perl-package/, unchanged) built against the port's
  library through a temporary tree whose mxnet_tpu/libmxtpu.so links
  to it, its example printing PERL TRAINS OK.
"""
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from mxnet_tpu import _core as jcore

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _build
from mxnet_tpu_torch import recordio as rec
from mxnet_tpu_torch.ops import registry as reg

REPO = Path(__file__).resolve().parents[1]
CPU = mx.cpu()
JAX_TOL = dict(rtol=1e-5, atol=1e-6)

jax_native = pytest.mark.skipif(not jcore.available(),
                                reason="the JAX package's libmxtpu.so "
                                       "is not built")


@pytest.fixture(scope='module')
def lib_path():
    return _build.c_predict_library()


def _lib(path):
    lib = ctypes.CDLL(str(path))
    lib.MXTTrainGetLastError.restype = ctypes.c_char_p
    return lib


def _env():
    return {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}


def _build_and_run(lib_path, tmp_path, src, args, compiler='g++'):
    exe = str(tmp_path / 'prog')
    libdir = str(lib_path.parent)
    cmd = [compiler, '-O2']
    if compiler == 'g++':
        cmd += ['-std=c++14', '-I' + str(REPO / 'cpp-package' / 'include')]
    cmd += [str(src), '-o', exe, '-L' + libdir, '-lmxt_predict',
            '-Wl,-rpath,' + libdir]
    subprocess.run(cmd, check=True, timeout=300)
    return subprocess.run([exe] + [str(a) for a in args],
                          capture_output=True, text=True, env=_env(),
                          timeout=600, cwd=str(tmp_path))


def test_library_holds_both_surfaces(lib_path):
    log = (lib_path.parent / 'build.log').read_text()
    assert 'c_api_train.cc' in log and 'c_predict_api.cc' in log
    lib = _lib(lib_path)
    for name in ('MXTPredCreate', 'MXTExecutorSimpleBind', 'MXTUpdaterStep',
                 'MXTDataIterCreate', 'MXTCachedOpInvoke'):
        assert hasattr(lib, name), name


def test_mlp_train_cpp_trains(lib_path, tmp_path):
    proc = _build_and_run(lib_path, tmp_path,
                          REPO / 'cpp-package' / 'example' / 'mlp_train.cpp',
                          [])
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    assert 'final train-accuracy' in proc.stdout, proc.stdout
    acc = float(proc.stdout.split('final train-accuracy')[1].split()[0])
    assert acc > 0.9, proc.stdout


def test_imperative_train_c_trains(lib_path, tmp_path):
    proc = _build_and_run(
        lib_path, tmp_path,
        REPO / 'cpp-package' / 'example' / 'imperative_train.c', [],
        compiler='gcc')
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    assert 'C IMPERATIVE/AUTOGRAD/CACHEDOP OK' in proc.stdout, proc.stdout


def _class_colour_rec(tmp_path, n=160, edge=12, classes=10):
    """The JAX test's .rec of colour-coded class images, written by the
    port's recordio (PNG through cv2)."""
    cv2 = pytest.importorskip('cv2')
    prefix = str(tmp_path / 'colors')
    w = rec.MXIndexedRecordIO(prefix + '.idx', prefix + '.rec', 'w')
    rng = np.random.RandomState(3)
    centers = rng.randint(40, 215, (classes, 3))
    for i in range(n):
        c = i % classes
        img = (centers[c][None, None, :] +
               rng.randint(-25, 25, (edge, edge, 3))).clip(0, 255) \
            .astype(np.uint8)
        ok, buf = cv2.imencode('.png', img)
        assert ok
        w.write_idx(i, rec.pack(rec.IRHeader(0, float(c), i, 0),
                                buf.tobytes()))
    w.close()
    return prefix + '.rec', edge, classes


def test_rec_train_cpp_trains_from_the_data_iter(lib_path, tmp_path):
    path, edge, classes = _class_colour_rec(tmp_path)
    proc = _build_and_run(lib_path, tmp_path,
                          REPO / 'cpp-package' / 'example' / 'rec_train.cpp',
                          [path, edge, classes])
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    assert 'final train-accuracy' in proc.stdout, proc.stdout


# -- introspection and runtime controls --------------------------------------

def _op_names(lib):
    n = ctypes.c_uint32()
    names = ctypes.POINTER(ctypes.c_char_p)()
    rc = lib.MXTListOpNames(ctypes.byref(n), ctypes.byref(names))
    assert rc == 0, lib.MXTTrainGetLastError()
    return [names[i].decode() for i in range(n.value)]


def _op_info(lib, name):
    canon, desc = ctypes.c_char_p(), ctypes.c_char_p()
    ni = ctypes.c_uint32()
    ins = ctypes.POINTER(ctypes.c_char_p)()
    rc = lib.MXTOpGetInfo(name.encode(), ctypes.byref(canon),
                          ctypes.byref(desc), ctypes.byref(ni),
                          ctypes.byref(ins))
    if rc != 0:
        return None
    return canon.value.decode(), [ins[i].decode() for i in range(ni.value)]


@jax_native
def test_c_op_introspection(lib_path):
    lib = _lib(lib_path)
    names = _op_names(lib)
    theirs = _lib(jcore._LIB_PATH)
    assert names == _op_names(theirs)
    assert len(set(names)) > 300
    assert {'Convolution', 'FullyConnected', 'stop_gradient'} <= set(names)
    canon, inputs = _op_info(lib, 'FullyConnected')
    assert canon == 'FullyConnected'
    assert inputs[0] == 'data' and 'weight' in inputs, inputs
    assert _op_info(lib, 'stop_gradient')[0] == 'BlockGrad'
    assert _op_info(lib, 'NoSuchOpEver') is None
    assert '_test_runtime_op' not in names

    @reg.register('_test_runtime_op', input_names=('data',))
    def _rt_op(attrs, data):            # pragma: no cover - never run
        return data
    try:
        assert '_test_runtime_op' in _op_names(lib)
        assert _op_info(lib, '_test_runtime_op') == ('_test_runtime_op',
                                                     ['data'])

        # re-registering the same name leaves the sizes as they were,
        # and the C caches still rebuild (the generation stamp)
        @reg.register('_test_runtime_op', input_names=('lhs', 'rhs'))
        def _rt_op2(attrs, lhs, rhs):   # pragma: no cover - never run
            return lhs
        assert _op_info(lib, '_test_runtime_op')[1] == ['lhs', 'rhs']
    finally:
        reg._OP_REGISTRY.pop('_test_runtime_op', None)


def test_c_runtime_controls(lib_path):
    lib = _lib(lib_path)

    def draw():
        assert lib.MXTRandomSeed(1234) == 0, lib.MXTTrainGetLastError()
        out = (ctypes.c_void_p * 1)()
        n = ctypes.c_uint32()
        rc = lib.MXTImperativeInvoke(
            b'_random_uniform', 0, None, 3,
            (ctypes.c_char_p * 3)(b'shape', b'low', b'ctx'),
            (ctypes.c_char_p * 3)(b'(4,)', b'0.0', b'cpu(0)'),
            ctypes.byref(n), out, 1)
        assert rc == 0, lib.MXTTrainGetLastError()
        buf = (ctypes.c_float * 4)()
        assert lib.MXTNDArraySyncCopyToCPU(ctypes.c_void_p(out[0]), buf,
                                           ctypes.c_size_t(4)) == 0, \
            lib.MXTTrainGetLastError()
        lib.MXTNDArrayFree(ctypes.c_void_p(out[0]))
        return list(buf)

    a, b = draw(), draw()
    assert a == b and len(set(a)) == 4
    assert all(0.0 <= v < 1.0 for v in a)
    assert lib.MXTNDArrayWaitAll() == 0, lib.MXTTrainGetLastError()


# -- one MLP through the same calls on both libraries -------------------------

class _C:
    """The MXT* training calls through ctypes on one library."""

    def __init__(self, lib):
        self.lib = lib

    def ok(self, rc):
        assert rc == 0, self.lib.MXTTrainGetLastError()

    def strs(self, items):
        return (ctypes.c_char_p * max(1, len(items)))(
            *[s.encode() for s in items])

    def var(self, name):
        out = ctypes.c_void_p()
        self.ok(self.lib.MXTSymbolCreateVariable(name.encode(),
                                                 ctypes.byref(out)))
        return out

    def op(self, op, name, attrs, args):
        out = ctypes.c_void_p()
        keys, syms = list(args), list(args.values())
        self.ok(self.lib.MXTSymbolCreate(
            op.encode(), name.encode(), len(attrs), self.strs(list(attrs)),
            self.strs(list(attrs.values())), len(keys), self.strs(keys),
            (ctypes.c_void_p * len(syms))(*[s.value for s in syms]),
            ctypes.byref(out)))
        return out

    def bind(self, sym, dev_type, shapes):
        keys = list(shapes)
        indptr, data = [0], []
        for k in keys:
            data += list(shapes[k])
            indptr.append(len(data))
        out = ctypes.c_void_p()
        rc = self.lib.MXTExecutorSimpleBind(
            sym, dev_type, 0, b'write', len(keys), self.strs(keys),
            (ctypes.c_uint32 * len(indptr))(*indptr),
            (ctypes.c_uint32 * len(data))(*data), ctypes.byref(out))
        return rc, out

    def array(self, ex, name, grad=False):
        out = ctypes.c_void_p()
        fn = self.lib.MXTExecutorGradArray if grad else \
            self.lib.MXTExecutorArgArray
        self.ok(fn(ex, name.encode(), ctypes.byref(out)))
        return out

    def set(self, handle, values):
        buf = np.ascontiguousarray(values, '<f4').ravel()
        self.ok(self.lib.MXTNDArraySyncCopyFromCPU(
            handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_size_t(buf.size)))

    def get(self, handle, shape):
        buf = np.zeros(int(np.prod(shape)), np.float32)
        self.ok(self.lib.MXTNDArraySyncCopyToCPU(
            handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_size_t(buf.size)))
        return buf.reshape(shape)


def _mlp_steps(lib, steps=4, batch=8, dim=6, hidden=10, classes=3):
    c = _C(lib)
    c.lib.MXTNDArrayFree.argtypes = [ctypes.c_void_p]
    data, label = c.var('data'), c.var('softmax_label')
    fc1 = c.op('FullyConnected', 'fc1', {'num_hidden': str(hidden)},
               {'data': data})
    act = c.op('Activation', 'relu1', {'act_type': 'relu'}, {'data': fc1})
    fc2 = c.op('FullyConnected', 'fc2', {'num_hidden': str(classes)},
               {'data': act})
    net = c.op('SoftmaxOutput', 'softmax', {},
               {'data': fc2, 'softmax_label': label})
    rc, ex = c.bind(net, 1, {'data': (batch, dim),
                             'softmax_label': (batch,)})
    c.ok(rc)
    rs = np.random.RandomState(0)
    shapes = {'fc1_weight': (hidden, dim), 'fc1_bias': (hidden,),
              'fc2_weight': (classes, hidden), 'fc2_bias': (classes,)}
    params = list(shapes)
    for name in params:
        c.set(c.array(ex, name), rs.randn(*shapes[name]) * 0.5)
    upd = ctypes.c_void_p()
    keys = ['learning_rate', 'momentum', 'wd', 'rescale_grad']
    vals = ['0.1', '0.9', '0.0001', str(1.0 / batch)]
    c.ok(c.lib.MXTUpdaterCreate(b'sgd', len(keys), c.strs(keys),
                                c.strs(vals), ctypes.byref(upd)))
    x = rs.randn(steps, batch, dim).astype(np.float32)
    y = rs.randint(0, classes, (steps, batch)).astype(np.float32)
    outs = []
    for s in range(steps):
        c.set(c.array(ex, 'data'), x[s])
        c.set(c.array(ex, 'softmax_label'), y[s])
        c.ok(c.lib.MXTExecutorForward(ex, 1))
        c.ok(c.lib.MXTExecutorBackward(ex))
        for i, name in enumerate(params):
            c.ok(c.lib.MXTUpdaterStep(upd, i, c.array(ex, name, grad=True),
                                      c.array(ex, name)))
        out = ctypes.c_void_p()
        c.ok(c.lib.MXTExecutorOutput(ex, 0, ctypes.byref(out)))
        outs.append(c.get(out, (batch, classes)))
    weights = {n: c.get(c.array(ex, n), shapes[n]) for n in params}
    losses = [float(-np.log(o[np.arange(batch), y[s].astype(int)]).mean())
              for s, o in enumerate(outs)]
    return losses, weights


@jax_native
def test_mlp_through_the_same_calls_on_both_libraries(lib_path):
    losses, weights = _mlp_steps(_lib(lib_path))
    jlosses, jweights = _mlp_steps(_lib(jcore._LIB_PATH))
    np.testing.assert_allclose(losses, jlosses, **JAX_TOL)
    assert losses[-1] < losses[0]
    for name in weights:
        np.testing.assert_allclose(weights[name], jweights[name],
                                   err_msg=name, **JAX_TOL)


@pytest.mark.parametrize('dev_type', [3, 2])
def test_dev_type_other_than_cpu_or_no_card_fails(lib_path, dev_type,
                                                  monkeypatch):
    if dev_type == 2:
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    c = _C(_lib(lib_path))
    data = c.var('data')
    net = c.op('FullyConnected', 'fc', {'num_hidden': '2'}, {'data': data})
    rc, ex = c.bind(net, dev_type, {'data': (2, 3)})
    assert rc != 0 and not ex.value
    err = c.lib.MXTTrainGetLastError().decode()
    assert ('dev_type' if dev_type == 3 else 'is_available') in err, err


def test_data_iter_from_c_hands_out_host_batches(lib_path, tmp_path):
    path, edge, _ = _class_colour_rec(tmp_path, n=12)
    lib = _lib(lib_path)
    c = _C(lib)
    for native in ('0', '1'):
        keys = ['path_imgrec', 'data_shape', 'batch_size', 'use_native']
        vals = [path, '(3,%d,%d)' % (edge, edge), '4', native]
        it = ctypes.c_void_p()
        c.ok(lib.MXTDataIterCreate(b'ImageRecordIter', len(keys),
                                   c.strs(keys), c.strs(vals),
                                   ctypes.byref(it)))
        has = ctypes.c_int()
        c.ok(lib.MXTDataIterNext(it, ctypes.byref(has)))
        assert has.value == 1
        d = ctypes.c_void_p()
        c.ok(lib.MXTDataIterGetData(it, ctypes.byref(d)))
        got = c.get(d, (4, 3, edge, edge))
        py = ctypes.py_object
        bridge_obj = ctypes.cast(it, ctypes.POINTER(py)).contents.value
        inner = bridge_obj.it._inner
        assert isinstance(inner, mx.io._NativeImageRecordIter) == \
            (native == '1')
        assert bridge_obj.cur.data[0].context == CPU
        want = mx.io.ImageRecordIter(path_imgrec=path,
                                     data_shape=(3, edge, edge),
                                     batch_size=4, use_native=True,
                                     ctx=CPU)
        if native == '1':
            np.testing.assert_array_equal(got,
                                          want.next().data[0].asnumpy())
        want.close()
        lib.MXTNDArrayFree.argtypes = [ctypes.c_void_p]
        lib.MXTNDArrayFree(d)
        lib.MXTDataIterFree.argtypes = [ctypes.c_void_p]
        lib.MXTDataIterFree(it)


@pytest.mark.parametrize('cuda', [True, False])
def test_image_iter_from_c_default_ctx(monkeypatch, cuda):
    """No ctx named: the native pipeline's batches stay on the host, the
    port's pipeline decodes on gpu(0) where the process has CUDA; a ctx
    named is kept."""
    from mxnet_tpu_torch import _c_api_bridge as bridge
    made = []
    monkeypatch.setattr(mx.io, 'ImageRecordIter',
                        lambda **kw: made.append(kw) or object())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: cuda)
    port = mx.gpu(0) if cuda else CPU
    for keys, vals, want in (
            ([], [], port),
            (['use_native'], ['0'], port),
            (['use_native'], ['1'], CPU),
            (['use_native', 'ctx'], ['0', 'cpu(0)'], CPU),
            (['ctx'], ['gpu(0)'], mx.gpu(0))):
        bridge.data_iter_create('ImageRecordIter', ['path_imgrec'] + keys,
                                ['x.rec'] + vals)
        assert made[-1]['ctx'] == want, (keys, vals, made[-1])


def test_perl_binding_trains_through_the_port(lib_path, tmp_path):
    for tool in ('perl', 'make', 'gcc'):
        if not shutil.which(tool):
            pytest.skip('no %s' % tool)
    # perl-package/Makefile.PL wants $MXTPU_REPO/mxnet_tpu/libmxtpu.so:
    # a tree whose libmxtpu.so is the port's library
    tree = tmp_path / 'tree'
    (tree / 'mxnet_tpu').mkdir(parents=True)
    (tree / 'mxnet_tpu' / 'libmxtpu.so').symlink_to(lib_path)
    pkg = tmp_path / 'perl-package'
    shutil.copytree(REPO / 'perl-package', pkg,
                    ignore=shutil.ignore_patterns('blib', '*.o', 'pm_to_blib',
                                                  'Makefile', 'MYMETA*',
                                                  'MxTpu.c'))
    env = dict(_env(), MXTPU_REPO=str(tree))
    for cmd in (['perl', 'Makefile.PL'], ['make']):
        proc = subprocess.run(cmd, cwd=str(pkg), capture_output=True,
                              text=True, env=env, timeout=600)
        assert proc.returncode == 0, (cmd, proc.stdout[-2000:],
                                      proc.stderr[-2000:])
    proc = subprocess.run(['perl', '-Mblib', 'example/mlp_train.pl'],
                          cwd=str(pkg), capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    assert 'PERL TRAINS OK' in proc.stdout, proc.stdout
