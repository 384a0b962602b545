"""Compile CUDA C source at run time with NVRTC and launch it with the
CUDA driver API, through ctypes: the counterpart of `pallas_call`'s
compile step in mxnet_tpu/rtc.py and of the reference's
src/common/mxrtc.cc.

NVRTC is the CUDA toolkit's, `$CUDA_HOME/lib64/libnvrtc.so*` (CUDA_HOME
defaults to /usr/local/cuda), whose headers `-I$CUDA_HOME/include` names,
and not a copy a wheel may bundle; the driver is `libcuda.so.1`. Source
compiles to a CUBIN for `sm_90a`, once per source, and loads as a module
once per (device, source). A missing library, a failed compile or a
failed driver call raises MXNetError with NVRTC's log or the driver's
message; nothing falls back.

The driver API acts on the calling thread's current context, which torch
may not have made current in that thread: before loading a module the
device's primary context, the one torch's runtime uses, is retained and
made current (cuDevicePrimaryCtxRetain, cuCtxSetCurrent).
"""
import ctypes
import os
import threading
from pathlib import Path

from .base import MXNetError

ARCH = 'sm_90a'

_lock = threading.Lock()
_libs = {}
_cubins = {}        # source -> CUBIN bytes
_functions = {}     # (device index, source, name) -> CUfunction
_contexts = {}      # device index -> primary CUcontext

_p = ctypes.c_void_p
_size = ctypes.c_size_t


def cuda_home():
    return Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))


def nvrtc_path():
    """The toolkit's libnvrtc: `$CUDA_HOME/lib64/libnvrtc.so*`, the
    unversioned name first."""
    lib64 = cuda_home() / 'lib64'
    found = sorted(lib64.glob('libnvrtc.so*'))
    if not found:
        raise MXNetError(
            'mx.rtc: no libnvrtc.so* under %s, so CUDA source cannot be '
            'compiled; set CUDA_HOME to a CUDA toolkit' % lib64)
    return found[0]


def _nvrtc():
    if 'nvrtc' not in _libs:
        path = nvrtc_path()
        # NVRTC opens its builtins library by name: load the one beside it
        # first, so that name resolves to the same toolkit
        for builtins in sorted(path.parent.glob('libnvrtc-builtins.so*')):
            ctypes.CDLL(str(builtins), mode=ctypes.RTLD_GLOBAL)
            break
        lib = ctypes.CDLL(str(path))
        i32 = ctypes.c_int
        lib.nvrtcCreateProgram.argtypes = [ctypes.POINTER(_p), ctypes.c_char_p,
                                           ctypes.c_char_p, i32, _p, _p]
        lib.nvrtcCompileProgram.argtypes = [
            _p, i32, ctypes.POINTER(ctypes.c_char_p)]
        lib.nvrtcGetProgramLogSize.argtypes = [_p, ctypes.POINTER(_size)]
        lib.nvrtcGetProgramLog.argtypes = [_p, ctypes.c_char_p]
        lib.nvrtcGetCUBINSize.argtypes = [_p, ctypes.POINTER(_size)]
        lib.nvrtcGetCUBIN.argtypes = [_p, ctypes.c_char_p]
        lib.nvrtcDestroyProgram.argtypes = [ctypes.POINTER(_p)]
        lib.nvrtcGetErrorString.argtypes = [i32]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcVersion.argtypes = [ctypes.POINTER(i32)] * 2
        for fn in ('nvrtcCreateProgram', 'nvrtcCompileProgram',
                   'nvrtcGetProgramLogSize', 'nvrtcGetProgramLog',
                   'nvrtcGetCUBINSize', 'nvrtcGetCUBIN',
                   'nvrtcDestroyProgram', 'nvrtcVersion'):
            getattr(lib, fn).restype = i32
        _libs['nvrtc'] = lib
    return _libs['nvrtc']


def _driver():
    if 'cuda' not in _libs:
        try:
            lib = ctypes.CDLL('libcuda.so.1')
        except OSError as e:
            raise MXNetError('mx.rtc: the CUDA driver (libcuda.so.1) cannot '
                             'be loaded: %s' % e)
        i32, u32 = ctypes.c_int, ctypes.c_uint
        lib.cuInit.argtypes = [u32]
        lib.cuDeviceGet.argtypes = [ctypes.POINTER(i32), i32]
        lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(_p)]
        lib.cuCtxSetCurrent.argtypes = [_p]
        lib.cuDevicePrimaryCtxRetain.argtypes = [ctypes.POINTER(_p), i32]
        lib.cuModuleLoadData.argtypes = [ctypes.POINTER(_p), ctypes.c_char_p]
        lib.cuModuleGetFunction.argtypes = [ctypes.POINTER(_p), _p,
                                            ctypes.c_char_p]
        lib.cuLaunchKernel.argtypes = [_p] + [u32] * 7 + [_p, _p, _p]
        lib.cuGetErrorString.argtypes = [i32, ctypes.POINTER(ctypes.c_char_p)]
        for fn in ('cuInit', 'cuDeviceGet', 'cuCtxGetCurrent',
                   'cuCtxSetCurrent', 'cuDevicePrimaryCtxRetain',
                   'cuModuleLoadData', 'cuModuleGetFunction',
                   'cuLaunchKernel', 'cuGetErrorString'):
            getattr(lib, fn).restype = i32
        _libs['cuda'] = lib
    return _libs['cuda']


def _check_nvrtc(lib, err, what, log=''):
    if err != 0:
        raise MXNetError('mx.rtc: %s failed: %s%s' % (
            what, lib.nvrtcGetErrorString(err).decode(),
            '\n' + log if log else ''))


def _check_cu(err, what):
    if err != 0:
        msg = ctypes.c_char_p()
        _driver().cuGetErrorString(err, ctypes.byref(msg))
        raise MXNetError('mx.rtc: %s failed: CUDA driver error %d (%s)' % (
            what, err, msg.value.decode() if msg.value else 'unknown'))


def version():
    """(major, minor) of the loaded NVRTC."""
    major, minor = ctypes.c_int(), ctypes.c_int()
    lib = _nvrtc()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), 'nvrtcVersion')
    return major.value, minor.value


def _log(lib, prog):
    n = _size()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(n)) != 0 or n.value < 2:
        return ''
    buf = ctypes.create_string_buffer(n.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors='replace')


def compile_cubin(source, name):
    """NVRTC `source` (program `name`) to a CUBIN for ARCH; raises with
    NVRTC's log when the compile fails."""
    lib = _nvrtc()
    prog = _p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), (name + '.cu').encode(), 0,
        None, None), 'nvrtcCreateProgram')
    try:
        opts = [b'--gpu-architecture=' + ARCH.encode(),
                b'-I' + str(cuda_home() / 'include').encode(),
                b'--std=c++17']
        arr = (ctypes.c_char_p * len(opts))(*opts)
        err = lib.nvrtcCompileProgram(prog, len(opts), arr)
        _check_nvrtc(lib, err, 'compiling %s for %s' % (name, ARCH),
                     _log(lib, prog))
        n = _size()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(n)),
                     'nvrtcGetCUBINSize')
        buf = ctypes.create_string_buffer(n.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, buf), 'nvrtcGetCUBIN')
        return buf.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(device_index):
    """Make the device's primary context current in this thread."""
    drv = _driver()
    ctx = _contexts.get(device_index)
    if ctx is None:
        _check_cu(drv.cuInit(0), 'cuInit')
        dev = ctypes.c_int()
        _check_cu(drv.cuDeviceGet(ctypes.byref(dev), device_index),
                  'cuDeviceGet')
        ctx = _p()
        _check_cu(drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  'cuDevicePrimaryCtxRetain')
        _contexts[device_index] = ctx
    current = _p()
    _check_cu(drv.cuCtxGetCurrent(ctypes.byref(current)), 'cuCtxGetCurrent')
    if current.value != ctx.value:
        _check_cu(drv.cuCtxSetCurrent(ctx), 'cuCtxSetCurrent')


def function(device_index, source, name):
    """The CUfunction `name` of `source` on CUDA device `device_index`,
    and whether this call compiled the source: NVRTC runs once per
    source, the module loads once per (device, source)."""
    with _lock:
        key = (device_index, source, name)
        if key in _functions:
            _make_current(device_index)
            return _functions[key], False
        compiled = source not in _cubins
        if compiled:
            _cubins[source] = compile_cubin(source, name)
        _make_current(device_index)
        drv = _driver()
        module, fn = _p(), _p()
        _check_cu(drv.cuModuleLoadData(ctypes.byref(module),
                                       _cubins[source]), 'cuModuleLoadData')
        _check_cu(drv.cuModuleGetFunction(ctypes.byref(fn), module,
                                          name.encode()),
                  'cuModuleGetFunction(%s)' % name)
        _functions[key] = fn
        return fn, compiled


def launch(fn, grid, block, pointers, stream):
    """cuLaunchKernel of `fn` with 3-D `grid` and `block`, one device
    pointer argument for each of `pointers` (ints), on CUDA stream
    handle `stream` (an int), with no dynamic shared memory."""
    args = [ctypes.c_void_p(p) for p in pointers]
    params = (ctypes.c_void_p * len(args))(
        *[ctypes.cast(ctypes.byref(a), ctypes.c_void_p) for a in args])
    _check_cu(_driver().cuLaunchKernel(fn, *grid, *block, 0,
                                       ctypes.c_void_p(stream),
                                       ctypes.cast(params, ctypes.c_void_p),
                                       None),
              'cuLaunchKernel')
