"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all in
parallel, and the objects are linked into one shared library with a
plain C interface, which is loaded with ctypes. The
library lands in `build/mxnet_tpu_torch/<hash of the sources>/` beside
the package, at first use, so a changed source builds anew and an
unchanged one is loaded from disk. A missing `nvcc` or a failed compile
raises with the compiler's output; nothing falls back.

The C API (`csrc/capi/`: the predict and the training surfaces, which
embed CPython) is not a kernel and stays out of that library:
`c_predict_library` builds it with the host C++ compiler against the
running interpreter's headers and libpython (sysconfig's paths) into
`build/mxnet_tpu_torch/capi/<hash>/`, at first use. The native runtime
(`csrc/native/`: the engine and RecordIO, `native_library`; the image
iterator on OpenCV 4, `native_image_library`) is host C++ too, built the
same way into `build/mxnet_tpu_torch/native/<hash>/`.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / 'csrc'
_BUILD_ROOT = _PKG.parent / 'build' / 'mxnet_tpu_torch'
_LIB_NAME = 'libmxt_kernels.so'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMPILE_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                              '-Xptxas', '-v')

_lock = threading.Lock()
_lib = None


def sources():
    """The kernel sources, in a fixed order."""
    return sorted(_CSRC.glob('*.cu')) + sorted(_CSRC.glob('*.cuh'))


def _digest():
    h = hashlib.sha256(' '.join(COMPILE_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                   'bin', 'nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('mxnet_tpu_torch: nvcc not found on PATH or in '
                       '$CUDA_HOME/bin; the CUDA kernels cannot be built')


def build():
    """Compile the sources if this hash has no library yet; returns the
    library's path. Each `.cu` file gets its own `nvcc`, all started
    together, and one more links them. What the compiler printed
    (registers, shared memory and spills per kernel, from ptxas) is kept
    beside the library as `build.log`."""
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in sources() if p.suffix == '.cu'):
        obj = out_dir / ('%s.%d.o' % (src.stem, tag))
        log = out_dir / ('%s.%d.log' % (src.stem, tag))
        cmd = [nvcc, *COMPILE_FLAGS, '-c', '-o', str(obj), str(src)]
        with open(log, 'w') as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, log, proc))
    failed, text = [], []
    for cmd, obj, log, proc in jobs:
        rc = proc.wait()
        text.append('$ %s\n%s' % (' '.join(cmd), log.read_text()))
        if rc != 0:
            failed.append(text[-1])
    tmp = out_dir / ('%s.%d.tmp' % (_LIB_NAME, tag))
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp),
               *[str(obj) for _, obj, _, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text.append('$ %s\n%s%s' % (' '.join(cmd), proc.stdout, proc.stderr))
        if proc.returncode != 0:
            failed.append(text[-1])
    (out_dir / 'build.log').write_text('\n'.join(text))
    if failed:
        raise RuntimeError('mxnet_tpu_torch: nvcc failed:\n' +
                           '\n'.join(failed))
    os.replace(tmp, lib_path)
    return lib_path


def build_log():
    """What the compiler printed for the current sources ('' if unbuilt)."""
    log = _BUILD_ROOT / _digest() / 'build.log'
    return log.read_text() if log.exists() else ''


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.mxt_flash_attention_fwd
    # q, k, v, o, lse, bh, tq, tk, d, scale, causal, dtype, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                   ctypes.c_float, i32, i32, ptr]
    fn.restype = i32
    fn = lib.mxt_flash_attention_bwd_dkdv
    # q, k, v, dout, lse, dd, dk, dv, bh, tq, tk, d, scale, causal, dtype,
    # stream
    fn.argtypes = [ptr] * 8 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr]
    fn.restype = i32
    fn = lib.mxt_flash_attention_bwd_dq
    # q, k, v, dout, lse, dd, dq, bh, tq, tk, d, scale, causal, dtype, stream
    fn.argtypes = [ptr] * 7 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr]
    fn.restype = i32
    fn = lib.mxt_conv_bn_stats
    # x, w, y, s1, s2, part, n, h, w, cin, cout, kh, kw, sh, sw, ph, pw,
    # dtype, stream
    fn.argtypes = [ptr] * 6 + [i32] * 12 + [ptr]
    fn.restype = i32
    # dtype -> the M-tile height of that dtype's kernel
    lib.mxt_conv_bn_stats_block_rows.argtypes = [i32]
    lib.mxt_conv_bn_stats_block_rows.restype = i32
    lib.mxt_error_string.argtypes = [i32]
    lib.mxt_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def check(lib, err, what):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError('%s: CUDA error %d (%s)' % (
            what, err, lib.mxt_error_string(err).decode()))


# -- the C predict API -----------------------------------------------------

_CAPI = _CSRC / 'capi'
# the host libraries keep the symbols of any static archive they link to
# themselves: a compiler that links libstdc++ statically (some do by
# default) would otherwise export a second C++ runtime into a process that
# holds torch's, and a C++ exception thrown and caught inside the library
# would mix the two and crash
HIDE_STATIC = ('-Wl,--exclude-libs,ALL',)
_CAPI_LIB = 'libmxt_predict.so'


def _capi_flags():
    """(compile flags, link flags) for the running interpreter's headers
    and libpython; the compile flags bake in (MXT_PY_PATHS) the paths its
    embedded copy needs to import mxnet_tpu_torch and torch."""
    inc = sysconfig.get_paths()['include']
    libdir = sysconfig.get_config_var('LIBDIR')
    ver = sysconfig.get_config_var('LDVERSION') or \
        sysconfig.get_config_var('VERSION')
    paths = []
    for p in (str(_PKG.parent), sysconfig.get_paths()['purelib'],
              sysconfig.get_paths()['platlib']):
        if p not in paths:
            paths.append(p)
    flags = ['-O2', '-std=c++17', '-fPIC', '-shared', '-Wall', '-pthread',
             *HIDE_STATIC, '-I' + inc,
             '-DMXT_PY_PATHS="%s"' % ':'.join(paths)]
    libs = ['-L' + libdir, '-Wl,-rpath,' + libdir, '-lpython' + ver,
            '-ldl']
    return flags, libs


def c_predict_library():
    """Build the C API library (the predict and the training surfaces) if
    this hash has none yet, with
    the host C++ compiler ($CXX, else g++); returns its path. A failed
    build raises with the compiler's output."""
    flags, libs = _capi_flags()
    h = hashlib.sha256(' '.join(flags + libs + [sys.version]).encode())
    srcs = sorted(_CAPI.glob('*.cc')) + sorted(_CAPI.glob('*.h'))
    for path in srcs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out_dir = _BUILD_ROOT / 'capi' / h.hexdigest()[:16]
    lib_path = out_dir / _CAPI_LIB
    if lib_path.exists():
        return lib_path
    cxx = _cxx('the C API')
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / ('%s.%d.tmp' % (_CAPI_LIB, os.getpid()))
    cmd = [cxx, *flags, '-o', str(tmp),
           *[str(p) for p in srcs if p.suffix == '.cc'], *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / 'build.log').write_text('$ %s\n%s%s' % (
        ' '.join(cmd), proc.stdout, proc.stderr))
    if proc.returncode != 0:
        raise RuntimeError('mxnet_tpu_torch: the C API failed to '
                           'build:\n$ %s\n%s%s' % (' '.join(cmd),
                                                   proc.stdout, proc.stderr))
    os.replace(tmp, lib_path)
    return lib_path


# -- the native runtime ----------------------------------------------------

_NATIVE = _CSRC / 'native'
_NATIVE_LIB = 'libmxt_native.so'
_IMAGE_LIB = 'libmxt_native_image.so'
# the image iterator's sources, which alone need OpenCV; its library also
# holds its own copy of RecordIO
IMAGE_SOURCES = ('image_record_iter.cc', 'c_api_image.cc')
# OpenCV's libraries the image iterator links (decode, resize, core)
OPENCV_LIBS = ('-lopencv_imgcodecs', '-lopencv_imgproc', '-lopencv_core')
NATIVE_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-pthread')


def native_sources():
    """The native runtime's sources, in a fixed order."""
    return sorted(_NATIVE.glob('*.cc')) + sorted(_NATIVE.glob('*.h'))


def _cxx(what):
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('mxnet_tpu_torch: no C++ compiler ($CXX or g++) '
                           'to build %s' % what)
    return cxx


def opencv_flags():
    """(compile flags, link flags) of OpenCV 4 from `pkg-config opencv4`;
    raises, naming what is missing, when pkg-config or OpenCV's package
    is not there."""
    if not shutil.which('pkg-config'):
        raise RuntimeError('mxnet_tpu_torch: pkg-config not found; the '
                           'native image iterator needs it to find OpenCV 4')
    got = []
    for query in ('--cflags', '--libs-only-L'):
        proc = subprocess.run(['pkg-config', query, 'opencv4'],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                'mxnet_tpu_torch: OpenCV 4 not found (pkg-config %s '
                'opencv4: %s); the native image iterator needs its C++ '
                'headers and libopencv_imgcodecs, _imgproc and _core'
                % (query, ' '.join((proc.stderr or proc.stdout).split())))
        got.append(proc.stdout.split())
    libdirs = [f[2:] for f in got[1] if f.startswith('-L')]
    return got[0], got[1] + ['-Wl,-rpath,' + d for d in libdirs] + \
        list(OPENCV_LIBS)


def _host_library(name, what, srcs, cflags, libs):
    """Build `srcs` into build/mxnet_tpu_torch/native/<hash>/<name> if that
    hash has no library yet, with the host C++ compiler ($CXX, else g++),
    one process a source, all started together; returns the library's
    path. A failed build raises with the compiler's output."""
    cxx = _cxx(what)
    flags = [*NATIVE_FLAGS, *cflags]
    h = hashlib.sha256(' '.join([cxx, name, *HIDE_STATIC] + flags +
                                libs).encode())
    for path in native_sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out_dir = _BUILD_ROOT / 'native' / h.hexdigest()[:16]
    lib_path = out_dir / name
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in srcs:
        obj = out_dir / ('%s.%d.o' % (src.stem, tag))
        cmd = [cxx, *flags, '-c', '-o', str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, text = [], []
    for cmd, obj, proc in jobs:
        out = proc.communicate()[0]
        text.append('$ %s\n%s' % (' '.join(cmd), out))
        if proc.returncode != 0:
            failed.append(text[-1])
    tmp = out_dir / ('%s.%d.tmp' % (name, tag))
    if not failed:
        cmd = [cxx, '-shared', '-pthread', *HIDE_STATIC, '-o', str(tmp),
               *[str(obj) for _, obj, _ in jobs], *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text.append('$ %s\n%s%s' % (' '.join(cmd), proc.stdout, proc.stderr))
        if proc.returncode != 0:
            failed.append(text[-1])
    (out_dir / 'build.log').write_text('\n'.join(text))
    if failed:
        raise RuntimeError('mxnet_tpu_torch: %s failed to build:\n%s'
                           % (what, '\n'.join(failed)))
    os.replace(tmp, lib_path)
    return lib_path


def native_library():
    """The native runtime's engine and RecordIO (no OpenCV), built on
    first use; returns the library's path."""
    srcs = [p for p in native_sources()
            if p.suffix == '.cc' and p.name not in IMAGE_SOURCES]
    return _host_library(_NATIVE_LIB, 'the native runtime', srcs, [], [])


def native_image_library():
    """The native image iterator (OpenCV 4 decode and augmentation) with
    its own RecordIO reader, built on first use; returns the library's
    path. Raises, naming what is missing, without OpenCV 4."""
    cflags, libs = opencv_flags()
    srcs = [_NATIVE / n for n in ('recordio.cc',) + IMAGE_SOURCES]
    return _host_library(_IMAGE_LIB, 'the native image iterator', srcs,
                         cflags, libs)
