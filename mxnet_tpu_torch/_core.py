"""ctypes bindings to the port's native runtime (`csrc/native/`).

The counterpart of the JAX package's `_core.py` (the reference's `_LIB`
and `check_call`). The native runtime is host C++ in two libraries:
`lib()` holds the dependency-scheduling engine (`mx.engine`) and RecordIO
framing, `image_lib()` the threaded image decode pipeline
(`io.ImageRecordIter(use_native=True)`), which alone needs OpenCV 4. Each
is built from the port's own sources through `_build` at first use and
loaded. There is nothing to fall back on: a library that cannot be built
or loaded raises `NativeError` with the compiler's or the loader's
message (an absent OpenCV named).
"""
import ctypes
import threading

from . import _build

_LIBS = {}
_LOCK = threading.Lock()


class NativeError(RuntimeError):
    pass


def _declare(lib):
    lib.MXTGetLastError.restype = ctypes.c_char_p
    lib.MXTEngineCreate.restype = ctypes.c_void_p
    lib.MXTEngineCreate.argtypes = [ctypes.c_int]
    lib.MXTEngineFree.argtypes = [ctypes.c_void_p]
    lib.MXTEngineNewVar.restype = ctypes.c_int64
    lib.MXTEngineNewVar.argtypes = [ctypes.c_void_p]
    lib.MXTEnginePush.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.MXTEngineWaitForVar.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.MXTEngineWaitAll.argtypes = [ctypes.c_void_p]
    lib.MXTEngineDeleteVar.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.MXTRecordReaderCreate.restype = ctypes.c_void_p
    lib.MXTRecordReaderCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordReaderFree.argtypes = [ctypes.c_void_p]
    lib.MXTRecordReaderNext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.MXTRecordReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.MXTRecordWriterCreate.restype = ctypes.c_void_p
    lib.MXTRecordWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordWriterFree.argtypes = [ctypes.c_void_p]
    lib.MXTRecordWriterWrite.restype = ctypes.c_int64
    lib.MXTRecordWriterWrite.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    return lib


def _declare_image(lib):
    lib.MXTGetLastError.restype = ctypes.c_char_p
    lib.MXTImageRecordIterCreate.restype = ctypes.c_void_p
    lib.MXTImageRecordIterCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64]
    lib.MXTImageRecordIterFree.argtypes = [ctypes.c_void_p]
    lib.MXTImageRecordIterNext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int)]
    lib.MXTImageRecordIterReset.argtypes = [ctypes.c_void_p]
    return lib


def _load(key, build, declare, what):
    with _LOCK:
        if key not in _LIBS:
            try:
                _LIBS[key] = declare(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError) as e:
                raise NativeError('%s cannot be built or loaded: %s'
                                  % (what, e)) from e
        return _LIBS[key]


def lib():
    """The engine and RecordIO library, built on first use. Raises
    NativeError when it cannot be built or loaded."""
    return _load('core', lambda: _build.native_library(), _declare,
                 'the native runtime')


def image_lib():
    """The image iterator's library, built on first use. Raises
    NativeError when it cannot be built (OpenCV 4 absent) or loaded."""
    return _load('image', lambda: _build.native_image_library(),
                 _declare_image, 'the native image iterator')


def check_call(ret, library=None):
    """Raise with the native error message of `library` (the engine's by
    default) on a nonzero return (reference base.py check_call)."""
    if ret != 0:
        raise NativeError((library or lib()).MXTGetLastError().decode())
