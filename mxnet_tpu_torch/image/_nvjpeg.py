"""JPEG decode and encode on the card with the CUDA toolkit's nvJPEG,
through ctypes, as `_nvrtc` reaches NVRTC.

The library is the toolkit's `$CUDA_HOME/lib64/libnvjpeg.so*` (CUDA_HOME
defaults to /usr/local/cuda). One handle (`nvjpegCreateSimple`) serves
the process; each thread keeps its own decode state and its own encoder
state and parameters, so that decode workers run side by side. Both
directions run on torch's current CUDA stream of the calling thread:

- `decode(buf, device, flag, to_rgb)`: `nvjpegGetImageInfo`, then
  `nvjpegDecode` to interleaved RGB (BGR with to_rgb=False, luma alone
  with flag=0) into a new uint8 (H, W, C) CUDA tensor;
- `encode(img, quality)`: `nvjpegEncodeImage` of a uint8 (H, W, 3) CUDA
  tensor in OpenCV's BGR order (a one-channel image by
  `nvjpegEncodeYUV` as grey), 4:2:0 chroma as OpenCV's default, then
  `nvjpegEncodeRetrieveBitstream`; returns the JPEG bytes.

A missing library or a failed call raises MXNetError naming the call and
nvJPEG's status; nothing falls back.
"""
import ctypes
import os
import threading
from pathlib import Path

from ..base import MXNetError

# nvjpeg.h enums
OUTPUT_Y, OUTPUT_RGBI, OUTPUT_BGRI = 2, 5, 6
INPUT_BGRI = 6
CSS_420, CSS_GRAY = 2, 6
MAX_COMPONENT = 4
_STATUS = {0: 'SUCCESS', 1: 'NOT_INITIALIZED', 2: 'INVALID_PARAMETER',
           3: 'BAD_JPEG', 4: 'JPEG_NOT_SUPPORTED', 5: 'ALLOCATOR_FAILURE',
           6: 'EXECUTION_FAILED', 7: 'ARCH_MISMATCH', 8: 'INTERNAL_ERROR',
           9: 'IMPLEMENTATION_NOT_SUPPORTED', 10: 'INCOMPLETE_BITSTREAM'}

_p = ctypes.c_void_p
_lock = threading.Lock()
_lib = {}
_handles = {}
_local = threading.local()


class Image(ctypes.Structure):
    """nvjpegImage_t: a pointer and a pitch per component."""
    _fields_ = [('channel', _p * MAX_COMPONENT),
                ('pitch', ctypes.c_size_t * MAX_COMPONENT)]


def library_path():
    """The toolkit's libnvjpeg: `$CUDA_HOME/lib64/libnvjpeg.so*`, the
    unversioned name first."""
    lib64 = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'lib64'
    found = sorted(lib64.glob('libnvjpeg.so*'))
    if not found:
        raise MXNetError(
            'nvJPEG: no libnvjpeg.so* under %s, so JPEG cannot be decoded '
            'or encoded on the card; set CUDA_HOME to a CUDA toolkit'
            % lib64)
    return found[0]


def _nvjpeg():
    with _lock:
        if 'lib' not in _lib:
            lib = ctypes.CDLL(str(library_path()))
            i32, size = ctypes.c_int, ctypes.c_size_t
            pp = ctypes.POINTER(_p)
            sigs = {
                'nvjpegCreateSimple': [pp],
                'nvjpegJpegStateCreate': [_p, pp],
                'nvjpegGetImageInfo': [_p, ctypes.c_char_p, size,
                                       ctypes.POINTER(i32),
                                       ctypes.POINTER(i32),
                                       ctypes.POINTER(i32),
                                       ctypes.POINTER(i32)],
                'nvjpegDecode': [_p, _p, ctypes.c_char_p, size, i32,
                                 ctypes.POINTER(Image), _p],
                'nvjpegEncoderStateCreate': [_p, pp, _p],
                'nvjpegEncoderParamsCreate': [_p, pp, _p],
                'nvjpegEncoderParamsSetQuality': [_p, i32, _p],
                'nvjpegEncoderParamsSetSamplingFactors': [_p, i32, _p],
                'nvjpegEncodeImage': [_p, _p, _p, ctypes.POINTER(Image),
                                      i32, i32, i32, _p],
                'nvjpegEncodeYUV': [_p, _p, _p, ctypes.POINTER(Image),
                                    i32, i32, i32, _p],
                'nvjpegEncodeRetrieveBitstream': [
                    _p, _p, ctypes.c_char_p, ctypes.POINTER(size), _p],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i32
            _lib['lib'] = lib
        return _lib['lib']


def _check(status, what):
    if status != 0:
        raise MXNetError('nvJPEG: %s failed: NVJPEG_STATUS_%s (%d)'
                         % (what, _STATUS.get(status, '?'), status))


def _handle(device):
    lib = _nvjpeg()
    with _lock:
        h = _handles.get(device.index)
        if h is None:
            h = _p()
            _check(lib.nvjpegCreateSimple(ctypes.byref(h)),
                   'nvjpegCreateSimple')
            _handles[device.index] = h
        return h


def _thread_obj(kind, device, make):
    """This thread's decode state or encoder state / params for device."""
    objs = getattr(_local, 'objs', None)
    if objs is None:
        objs = _local.objs = {}
    key = (kind, device.index)
    if key not in objs:
        objs[key] = make()
    return objs[key]


def _stream(torch, device):
    return _p(torch.cuda.current_stream(device).cuda_stream)


def _device(torch, device):
    device = torch.device(device)
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def image_info(buf):
    """(components, width, height) of a JPEG, from its headers."""
    import torch
    lib = _nvjpeg()
    handle = _handle(_device(torch, 'cuda'))
    n, subs = ctypes.c_int(), ctypes.c_int()
    widths = (ctypes.c_int * MAX_COMPONENT)()
    heights = (ctypes.c_int * MAX_COMPONENT)()
    _check(lib.nvjpegGetImageInfo(handle, buf, len(buf), ctypes.byref(n),
                                  ctypes.byref(subs), widths, heights),
           'nvjpegGetImageInfo')
    return n.value, widths[0], heights[0]


def decode(buf, device, flag=1, to_rgb=True):
    """Decode JPEG bytes on `device` (a CUDA torch.device) on the current
    stream: a uint8 (H, W, 3) tensor, RGB (BGR with to_rgb=False), or
    (H, W, 1) luma with flag=0."""
    import torch
    device = _device(torch, device)
    lib = _nvjpeg()
    buf = bytes(buf)
    handle = _handle(device)

    def make_state():
        s = _p()
        _check(lib.nvjpegJpegStateCreate(handle, ctypes.byref(s)),
               'nvjpegJpegStateCreate')
        return s
    state = _thread_obj('decode', device, make_state)
    _, w, h = image_info(buf)
    c = 1 if flag == 0 else 3
    out = torch.empty((h, w, c), dtype=torch.uint8, device=device)
    img = Image()
    img.channel[0] = out.data_ptr()
    img.pitch[0] = w * c
    fmt = OUTPUT_Y if flag == 0 else (OUTPUT_RGBI if to_rgb else OUTPUT_BGRI)
    _check(lib.nvjpegDecode(handle, state, buf, len(buf), fmt,
                            ctypes.byref(img), _stream(torch, device)),
           'nvjpegDecode')
    return out


def encode(img, quality=95):
    """JPEG bytes of a uint8 CUDA tensor (H, W, 3) in BGR order, or (H, W)
    / (H, W, 1) grey, at `quality`, 4:2:0 chroma."""
    import torch
    if img.dtype != torch.uint8 or img.device.type != 'cuda':
        raise MXNetError('nvJPEG: encode takes a uint8 CUDA tensor, not '
                         '%s on %s' % (img.dtype, img.device))
    grey = img.dim() == 2 or img.shape[2] == 1
    if not grey and img.shape[2] != 3:
        raise MXNetError('nvJPEG: encode takes 1 or 3 channels, not %d'
                         % img.shape[2])
    device = _device(torch, img.device)
    lib = _nvjpeg()
    handle = _handle(device)
    stream = _stream(torch, device)

    def make_encoder():
        state, params = _p(), _p()
        _check(lib.nvjpegEncoderStateCreate(handle, ctypes.byref(state),
                                            stream),
               'nvjpegEncoderStateCreate')
        _check(lib.nvjpegEncoderParamsCreate(handle, ctypes.byref(params),
                                             stream),
               'nvjpegEncoderParamsCreate')
        return state, params
    state, params = _thread_obj('encode', device, make_encoder)
    src = img.contiguous()
    h, w = src.shape[0], src.shape[1]
    _check(lib.nvjpegEncoderParamsSetQuality(params, int(quality), stream),
           'nvjpegEncoderParamsSetQuality')
    _check(lib.nvjpegEncoderParamsSetSamplingFactors(
        params, CSS_GRAY if grey else CSS_420, stream),
        'nvjpegEncoderParamsSetSamplingFactors')
    image = Image()
    image.channel[0] = src.data_ptr()
    if grey:
        image.pitch[0] = w
        _check(lib.nvjpegEncodeYUV(handle, state, params,
                                   ctypes.byref(image), CSS_GRAY, w, h,
                                   stream), 'nvjpegEncodeYUV')
    else:
        image.pitch[0] = 3 * w
        _check(lib.nvjpegEncodeImage(handle, state, params,
                                     ctypes.byref(image), INPUT_BGRI, w, h,
                                     stream), 'nvjpegEncodeImage')
    length = ctypes.c_size_t(0)
    _check(lib.nvjpegEncodeRetrieveBitstream(handle, state, None,
                                             ctypes.byref(length), stream),
           'nvjpegEncodeRetrieveBitstream (length)')
    torch.cuda.current_stream(device).synchronize()
    out = ctypes.create_string_buffer(length.value)
    _check(lib.nvjpegEncodeRetrieveBitstream(handle, state, out,
                                             ctypes.byref(length), stream),
           'nvjpegEncodeRetrieveBitstream')
    torch.cuda.current_stream(device).synchronize()
    return out.raw[:length.value]
