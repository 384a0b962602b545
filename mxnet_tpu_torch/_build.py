"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all in
parallel, and the objects are linked into one shared library with a
plain C interface, which is loaded with ctypes. The
library lands in `build/mxnet_tpu_torch/<hash of the sources>/` beside
the package, at first use, so a changed source builds anew and an
unchanged one is loaded from disk. A missing `nvcc` or a failed compile
raises with the compiler's output; nothing falls back.

The C predict API (`csrc/capi/`, which embeds CPython) is not a kernel
and stays out of that library: `c_predict_library` builds it with the
host C++ compiler against the running interpreter's headers and
libpython (sysconfig's paths) into `build/mxnet_tpu_torch/capi/<hash>/`,
at first use.
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
             '-I' + inc, '-DMXT_PY_PATHS="%s"' % ':'.join(paths)]
    libs = ['-L' + libdir, '-Wl,-rpath,' + libdir, '-lpython' + ver,
            '-ldl']
    return flags, libs


def c_predict_library():
    """Build the C predict API library if this hash has none yet, with
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
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('mxnet_tpu_torch: no C++ compiler ($CXX or '
                           'g++) to build the C predict API')
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / ('%s.%d.tmp' % (_CAPI_LIB, os.getpid()))
    cmd = [cxx, *flags, '-o', str(tmp),
           *[str(p) for p in srcs if p.suffix == '.cc'], *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / 'build.log').write_text('$ %s\n%s%s' % (
        ' '.join(cmd), proc.stdout, proc.stderr))
    if proc.returncode != 0:
        raise RuntimeError('mxnet_tpu_torch: the C predict API failed to '
                           'build:\n$ %s\n%s%s' % (' '.join(cmd),
                                                   proc.stdout, proc.stderr))
    os.replace(tmp, lib_path)
    return lib_path
