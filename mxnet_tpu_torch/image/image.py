"""Image decoding, augmentation and ImageIter: the counterpart of
mxnet_tpu/image/image.py (reference python/mxnet/image/image.py,
src/io/image_io.cc).

An image is a uint8 (H, W, C) tensor on the device of its context, and
every pixel operation is a torch op on that device: on a GPU context the
decode workers decode JPEG with nvJPEG (`_nvjpeg`) and augment on the
card, and the batch is made there, so that `io.prefetch_to_device` has
nothing to copy. On cpu(0) the decoder is cv2's (the JAX package's, so
that the CPU pipelines decode to the same pixels), else PIL's; without
either a CPU decode raises. A PNG (or any other format) bound for the
card is decoded on the host by the same decoder and moved to the card;
a JPEG bound for the card never leaves nvJPEG.

Augmenters take and return what they are given: an NDArray stays an
NDArray on its context, a torch tensor a tensor, a numpy array a numpy
array. `imresize` has OpenCV's semantics for INTER_NEAREST (0:
floor(dst * scale)), INTER_LINEAR (1), INTER_CUBIC (2, a = -0.75) and
INTER_AREA (3: coverage weights when shrinking), each as per-axis taps
and weights built on the host (`resize_taps`), then two gathers and
weighted sums; uint8 results round half up, with OpenCV's 11-bit
fixed-point weights for linear and cubic, so they stay within one level
of cv2.resize's.

The random draws stay on the host, in the JAX package's order, through
`_rng()` / `_np_rng()`: the process-global `random` and `np.random` on
the sequential path, per-sample streams seeded by
`random.stream_seed('image-aug', epoch, position)` in the decode
workers. Each worker thread decodes and augments on its own CUDA stream;
the consumer's stream waits on the event recorded after its chunk, and
each staged tensor is marked as used there (`record_stream`), as in
`io.prefetch_to_device`.
"""
import contextlib
import functools
import logging
import math
import os
import queue
import random as pyrandom
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import io as mxio
from .. import profiler
from .. import recordio
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray
from . import _nvjpeg

# ---------------------------------------------------------------------------
# Augmenter randomness routing (the JAX package's): the process-global
# `random` / `np.random` by default, per-sample seeded streams inside a
# decode worker
# ---------------------------------------------------------------------------

_AUG_RNG = threading.local()


def _rng():
    """The python-random stream augmenters draw from (the thread's
    override inside decode workers, else the global `random` module)."""
    return getattr(_AUG_RNG, 'py', pyrandom)


def _np_rng():
    """The same for numpy draws (LightingAug)."""
    return getattr(_AUG_RNG, 'np', np.random)


class _seeded_aug_rng(object):
    """Route _rng() / _np_rng() through streams seeded by `seed` for the
    current thread (a decode worker wraps each sample's augmentation)."""

    def __init__(self, seed):
        self._seed = int(seed)

    def __enter__(self):
        self._prev = (getattr(_AUG_RNG, 'py', None),
                      getattr(_AUG_RNG, 'np', None))
        _AUG_RNG.py = pyrandom.Random(self._seed)
        _AUG_RNG.np = np.random.RandomState(self._seed & 0xffffffff)
        return self

    def __exit__(self, *exc):
        if self._prev[0] is None:
            del _AUG_RNG.py
            del _AUG_RNG.np
        else:
            _AUG_RNG.py, _AUG_RNG.np = self._prev
        return False


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _is_jpeg(buf):
    return bytes(buf[:2]) == b'\xff\xd8'


def _format_name(buf):
    head = bytes(buf[:8])
    for magic, name in ((b'\x89PNG', 'PNG'), (b'BM', 'BMP'),
                        (b'GIF8', 'GIF'), (b'RIFF', 'WEBP'),
                        (b'II*\x00', 'TIFF'), (b'MM\x00*', 'TIFF')):
        if head.startswith(magic):
            return name
    return 'JPEG' if _is_jpeg(buf) else 'unknown'


def decode_host(buf, flag=1, to_rgb=True):
    """Decode bytes on the host: uint8 (H, W, C) numpy, RGB unless
    to_rgb=False. cv2 if it imports (the JAX package's decoder), else
    PIL; without either it raises."""
    arr = buf if isinstance(buf, np.ndarray) else \
        np.frombuffer(bytes(buf), dtype=np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(arr, flag)
        if img is None:
            raise MXNetError('Failed to decode image')
        if to_rgb and img.ndim == 3 and img.shape[2] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        try:
            import io as _io
            from PIL import Image
        except ImportError:
            raise MXNetError('decoding a %s image on the host needs cv2 or '
                             'PIL, and neither imports'
                             % _format_name(arr))
        pil = Image.open(_io.BytesIO(arr.tobytes()))
        img = np.asarray(pil.convert('L' if flag == 0 else 'RGB'))
        if not to_rgb and img.ndim == 3:
            img = np.ascontiguousarray(img[:, :, ::-1])
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def decode_tensor(buf, device, flag=1, to_rgb=True):
    """Decode bytes to a uint8 (H, W, C) tensor on `device`: a JPEG bound
    for a CUDA device by nvJPEG on the current stream; any other format
    for the card by the host decoder, then moved there; anything for the
    CPU by the host decoder."""
    device = torch.device(device)
    if device.type == 'cuda':
        if _is_jpeg(buf):
            return _nvjpeg.decode(buf, device, flag, to_rgb)
        try:
            img = decode_host(buf, flag, to_rgb)
        except MXNetError as e:
            raise MXNetError('nvJPEG decodes JPEG only, and this image is '
                             '%s: %s' % (_format_name(buf), e))
        return torch.from_numpy(img).to(device)
    return torch.from_numpy(decode_host(buf, flag, to_rgb))


def _ctx_of(ctx):
    return ctx if isinstance(ctx, Context) else (
        Context.from_device(torch.device(ctx)) if ctx is not None
        else current_context())


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode an image byte buffer into a uint8 (H, W, C) NDArray on ctx
    (the current context when None: gpu(0) unless the caller is in
    `with mx.cpu():`), by nvJPEG on the card, cv2 / PIL on the host."""
    ctx = _ctx_of(ctx)
    img = decode_tensor(buf, ctx.torch_device, flag, to_rgb)
    if out is not None:
        out._data.copy_(img)
        return out
    return NDArray(img, ctx)


def imread(filename, flag=1, to_rgb=True, ctx=None):
    with open(filename, 'rb') as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


def _t(src):
    """The torch tensor of an image argument (no copy where one exists)."""
    if isinstance(src, NDArray):
        return src._data
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(np.ascontiguousarray(src))


def _like(out, src):
    """Return `out` (a tensor) as `src` came: an NDArray on its context,
    a tensor, or a numpy array."""
    if isinstance(src, NDArray):
        return NDArray(out, src.context)
    if isinstance(src, torch.Tensor):
        return out
    return out.numpy()


# ---------------------------------------------------------------------------
# Resizing with OpenCV's semantics
# ---------------------------------------------------------------------------

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA = 0, 1, 2, 3
_COEF_SCALE = 2048.0        # OpenCV's INTER_RESIZE_COEF_SCALE (8-bit data)


def _cubic_coeffs(x):
    """OpenCV's interpolateCubic (A = -0.75), in float32."""
    a = np.float32(-0.75)
    x = np.float32(x)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return [c0, c1, c2, c3]


def _area_table(ssize, dsize, scale):
    """OpenCV's computeResizeAreaTab: per destination pixel, the source
    pixels it covers and their shares."""
    taps = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            row.append((sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    return taps


@functools.lru_cache(maxsize=512)
def resize_taps(ssize, dsize, interp, horizontal, fixed_point,
                area_cover=False):
    """(index (dsize, K) int64, weight (dsize, K) float32) numpy arrays:
    destination pixel d of one axis is sum_k weight[d, k] *
    src[index[d, k]], as cv::resize computes it for `interp` (0-3).
    `horizontal` picks OpenCV's x-axis border rule (the y axis clamps its
    rows); `fixed_point` rounds linear and cubic weights to 1/2048, as
    OpenCV does for 8-bit data. INTER_AREA takes the coverage table when
    both axes shrink (`area_cover`), else OpenCV's area-linear rule."""
    inv = dsize / ssize
    scale = 1.0 / inv
    rows = []
    if interp == INTER_NEAREST:
        rows = [[(min(int(math.floor(d * scale)), ssize - 1), 1.0)]
                for d in range(dsize)]
    elif interp == INTER_AREA and area_cover:
        rows = _area_table(ssize, dsize, scale)
    elif interp in (INTER_LINEAR, INTER_AREA, INTER_CUBIC):
        for d in range(dsize):
            if interp == INTER_AREA:
                s = math.floor(d * scale)
                f = float(np.float32((d + 1) - (s + 1) * inv))
                f = 0.0 if f <= 0 else f - math.floor(f)
            else:
                f = float(np.float32((d + 0.5) * scale - 0.5))
                s = math.floor(f)
                f = float(np.float32(f) - np.float32(s))
            if interp == INTER_CUBIC:
                coeffs = _cubic_coeffs(f)
                idx = [s - 1, s, s + 1, s + 2]
            else:
                if horizontal and s < 0:
                    f, s = 0.0, 0
                if horizontal and s >= ssize - 1:
                    f, s = 0.0, ssize - 1
                coeffs = [np.float32(1.0) - np.float32(f), np.float32(f)]
                idx = [s, s + 1]
            if fixed_point:
                coeffs = [np.rint(c * _COEF_SCALE) / _COEF_SCALE
                          for c in coeffs]
            rows.append([(min(max(i, 0), ssize - 1), float(c))
                         for i, c in zip(idx, coeffs)])
    else:
        raise MXNetError('imresize: interpolation %r is not one of '
                         'INTER_NEAREST (0), INTER_LINEAR (1), INTER_CUBIC '
                         '(2), INTER_AREA (3)' % (interp,))
    k = max(len(r) for r in rows)
    index = np.zeros((dsize, k), np.int64)
    weight = np.zeros((dsize, k), np.float32)
    for d, row in enumerate(rows):
        for j, (i, w) in enumerate(row):
            index[d, j] = i
            weight[d, j] = w
    return index, weight


_ON_DEVICE = {}     # (device, key) -> tensors made there once


def _on_device(device, key, make):
    """make()'s numpy arrays as tensors on `device`, copied there once."""
    out = _ON_DEVICE.get((device, key))
    if out is None:
        out = tuple(torch.from_numpy(a).to(device) for a in make())
        _ON_DEVICE[(device, key)] = out
    return out


def _taps_on(device, *key):
    return _on_device(device, ('taps',) + key, lambda: resize_taps(*key))


def resize_tensor(img, w, h, interp=INTER_LINEAR):
    """Resize a (H, W, C) tensor to (h, w, C) on its device with
    cv2.resize's semantics: the x axis, then the y axis; uint8 rounds
    half up and saturates, other dtypes stay float32."""
    ih, iw = img.shape[0], img.shape[1]
    if (ih, iw) == (h, w):
        return img.clone()
    dev = img.device
    if interp == INTER_NEAREST:
        ix, _ = _taps_on(dev, iw, w, interp, True, False)
        iy, _ = _taps_on(dev, ih, h, interp, False, False)
        return img.index_select(1, ix[:, 0]).index_select(0, iy[:, 0])
    cover = interp == INTER_AREA and iw >= w and ih >= h
    fixed = img.dtype == torch.uint8 and not cover
    x = img.to(torch.float32)
    ix, wx = _taps_on(dev, iw, w, interp, True, fixed, cover)
    iy, wy = _taps_on(dev, ih, h, interp, False, fixed, cover)
    # x axis: (H, w, K, C) weighted over K
    x = (x[:, ix] * wx[None, :, :, None]).sum(dim=2)
    # y axis: (h, K, w, C) weighted over K
    x = (x[iy] * wy[:, :, None, None]).sum(dim=1)
    if img.dtype == torch.uint8:
        return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)
    return x


def imresize(src, w, h, interp=1):
    """Resize to (w, h) (reference image_io.cc imresize), with OpenCV's
    semantics, on the image's device."""
    img = _t(src)
    if img.dim() == 2:
        img = img[:, :, None]
    return _like(resize_tensor(img, w, h, interp), src)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0):
    """Pad an image with a constant border (reference image_io.cc
    _cvcopyMakeBorder, border_type 0): a scalar value fills every
    channel."""
    if border_type != 0:
        raise MXNetError('copyMakeBorder: only the constant border '
                         '(border_type 0) is supported, not %r'
                         % (border_type,))
    img = _t(src)
    if img.dim() == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = torch.empty((h + top + bot, w + left + right, c), dtype=img.dtype,
                      device=img.device)
    fill = torch.as_tensor(np.broadcast_to(np.asarray(value, np.float64),
                                           (c,)).copy())
    out[:] = fill.to(device=img.device, dtype=img.dtype)
    out[top:top + h, left:left + w] = img
    return _like(out, src)


def scale_down(src_size, size):
    """Scale the target size down so it fits in src_size, keeping its
    ratio."""
    sw, sh = src_size
    w, h = size
    if sh < h:
        w, h = w * sh / float(h), sh
    if sw < w:
        w, h = sw, h * sw / float(w)
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so that the shorter edge is `size`."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a region, then resize it to `size` (w, h) when given."""
    out = _t(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        out = resize_tensor(out, size[0], size[1], interp)
    return _like(out, src)


def random_crop(src, size, interp=2):
    """A random crop of `size` (w, h): (cropped, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _rng().randint(0, w - new_w)
    y0 = _rng().randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A random crop of area in [min_area A, A] and aspect in `ratio`."""
    h, w = src.shape[:2]
    area = w * h
    for _ in range(10):
        new_area = _rng().uniform(min_area, 1.0) * area
        new_ratio = _rng().uniform(*ratio)
        new_w = int(round(np.sqrt(new_area * new_ratio)))
        new_h = int(round(np.sqrt(new_area / new_ratio)))
        if _rng().random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = _rng().randint(0, w - new_w)
            y0 = _rng().randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _vec(values, like):
    """A float32 vector (or array) of fixed values on `like`'s device,
    copied there once."""
    arr = np.ascontiguousarray(values, np.float32)
    return _on_device(like.device, ('vec', arr.shape, arr.tobytes()),
                      lambda: (arr,))[0]


def color_normalize(src, mean, std=None):
    """(src - mean) / std over the channels, in float32."""
    img = _t(src).to(torch.float32)
    out = img - _vec(mean, img)
    if std is not None:
        out = out / _vec(std, img)
    return _like(out, src)


# ---------------------------------------------------------------------------
# Augmenters (reference image.py)
# ---------------------------------------------------------------------------

class Augmenter(object):
    """Image augmenter base."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super(ResizeAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [resize_short(src, self.size, self.interp)]


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super(ForceResizeAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [imresize(src, self.size[0], self.size[1], self.interp)]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super(RandomCropAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [random_crop(src, self.size, self.interp)[0]]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super(RandomSizedCropAug, self).__init__(
            size=size, min_area=min_area, ratio=ratio, interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return [random_size_crop(src, self.size, self.min_area,
                                 self.ratio, self.interp)[0]]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super(CenterCropAug, self).__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [center_crop(src, self.size, self.interp)[0]]


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super(RandomOrderAug, self).__init__()
        self.ts = ts

    def __call__(self, src):
        srcs = [src]
        ts = list(self.ts)
        _rng().shuffle(ts)
        for t in ts:
            srcs = [out for s in srcs for out in t(s)]
        return srcs


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super(BrightnessJitterAug, self).__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.brightness, self.brightness)
        return [_like(_t(src).to(torch.float32) * alpha, src)]


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super(ContrastJitterAug, self).__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.contrast, self.contrast)
        img = _t(src).to(torch.float32)
        gray = (img * _vec(self.coef, img)).sum()
        gray = (3.0 * (1.0 - alpha) / img.numel()) * gray
        return [_like(img * alpha + gray, src)]


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super(SaturationJitterAug, self).__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        alpha = 1.0 + _rng().uniform(-self.saturation, self.saturation)
        img = _t(src).to(torch.float32)
        weighted = img * _vec(self.coef, img)
        # numpy's sum of three is ((a + b) + c): the same order here
        gray = (weighted[:, :, 0:1] + weighted[:, :, 1:2]) + \
            weighted[:, :, 2:3]
        return [_like(img * alpha + gray * (1.0 - alpha), src)]


def ColorJitterAug(brightness, contrast, saturation):
    """The three jitters in random order (reference ColorJitterAug)."""
    parts = [(brightness, BrightnessJitterAug),
             (contrast, ContrastJitterAug),
             (saturation, SaturationJitterAug)]
    return RandomOrderAug([cls(amount) for amount, cls in parts
                           if amount > 0])


class LightingAug(Augmenter):
    """PCA-based lighting noise (AlexNet's)."""

    def __init__(self, alphastd, eigval, eigvec):
        super(LightingAug, self).__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _np_rng().normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        img = _t(src).to(torch.float32)
        return [_like(img + torch.from_numpy(rgb).to(img.device), src)]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super(ColorNormalizeAug, self).__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return [color_normalize(src, self.mean, self.std)]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super(HorizontalFlipAug, self).__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _rng().random() < self.p:
            return [_like(torch.flip(_t(src), [1]), src)]
        return [src]


class CastAug(Augmenter):
    def __call__(self, src):
        return [_like(_t(src).to(torch.float32), src)]


IMAGENET_PCA = (np.array([55.46, 4.794, 1.148]),
                np.array([[-0.5675, 0.7192, 0.4009],
                          [-0.5808, -0.0045, -0.8140],
                          [-0.5836, -0.6948, 0.4203]]))
IMAGENET_MEAN = np.array([123.68, 116.28, 103.53])
IMAGENET_STD = np.array([58.395, 57.12, 57.375])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard augmenter list (reference image.py CreateAugmenter,
    in its order)."""
    crop_size = (data_shape[2], data_shape[1])
    auglist = [ResizeAug(resize, inter_method)] if resize > 0 else []
    if rand_resize:
        assert rand_crop
        cropper = RandomSizedCropAug(crop_size, 0.3, (3.0 / 4.0, 4.0 / 3.0),
                                     inter_method)
    elif rand_crop:
        cropper = RandomCropAug(crop_size, inter_method)
    else:
        cropper = CenterCropAug(crop_size, inter_method)
    auglist.append(cropper)
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, *IMAGENET_PCA))
    if mean is True:
        mean = IMAGENET_MEAN
    if std is True:
        std = IMAGENET_STD
    if mean is not None and len(np.atleast_1d(mean)) > 0:
        assert std is None or len(np.atleast_1d(std)) > 0
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# The parallel decode pool (the JAX package's: worker threads pull record
# ranges and decode + augment them; the consumer reassembles batches in
# epoch order through a bounded chunk window)
# ---------------------------------------------------------------------------

def decode_workers_from_env(default=0):
    """The MXNET_TPU_DECODE_WORKERS knob, parsed in one place (ImageIter's
    default and Module.fit's wiring agree)."""
    try:
        return max(0, int(os.environ.get('MXNET_TPU_DECODE_WORKERS',
                                         str(default))))
    except ValueError:
        return default


def _host_shard(num_parts, part_index):
    """Compose num_parts / part_index with MXNET_TPU_HOST_SHARD
    ('index/count'), the JAX package's per-host override. The port runs
    on one host, so nothing else composes."""
    spec = os.environ.get('MXNET_TPU_HOST_SHARD', '')
    if not spec:
        return num_parts, part_index
    host_index, host_count = (int(x) for x in spec.split('/'))
    if host_count <= 1:
        return num_parts, part_index
    return num_parts * host_count, part_index * host_count + host_index


class _SampleSource(object):
    """The workers' view of the dataset: read, decode and augment one
    sample on `device`. It holds the readers and the processing closure,
    never the iterator, so that live workers do not keep it alive."""

    def __init__(self, imgrec, imglist, path_root, process, device):
        self.imgrec = imgrec
        self.imglist = imglist
        self.path_root = path_root
        self.process = process  # (raw_label, img) -> (data, label)
        self.device = device

    def __call__(self, key, aug_seed):
        if self.imgrec is not None:
            header, buf = recordio.unpack(self.imgrec.read_idx(key))
            raw_label = header.label
        else:
            raw_label, fname = self.imglist[key]
            with open(os.path.join(self.path_root, fname), 'rb') as f:
                buf = f.read()
        img = decode_tensor(buf, self.device)
        with _seeded_aug_rng(aug_seed):
            return self.process(raw_label, img)


def _decode_pool_worker(source, task_q, results, cond, alive, cur_gen):
    """The decode pool's worker loop. Tasks are (generation, chunk id,
    [(key, aug seed, position), ...]); a result (ok, (samples, event)) is
    filed under (generation, chunk id), a failure as (False, exception)
    naming the record's key and epoch position. On a CUDA device the
    chunk runs on this thread's own stream, and `event` is recorded there
    after it."""
    device = source.device
    stream = torch.cuda.Stream(device) if device.type == 'cuda' else None
    while True:
        task = task_q.get()
        if task is None or not alive[0]:
            return
        gen, chunk_id, items = task
        if gen != cur_gen[0]:
            continue  # stale epoch: reset() already dropped this chunk
        t0 = time.perf_counter()
        try:
            samples = []
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                for key, aug_seed, pos in items:
                    try:
                        samples.append(source(key, aug_seed))
                    except BaseException as e:  # noqa: B036
                        wrapped = MXNetError(
                            'decode worker failed on record key=%r '
                            '(epoch position %d): %s: %s'
                            % (key, pos, type(e).__name__, e))
                        wrapped.record_key = key
                        wrapped.position = pos
                        wrapped.__cause__ = e
                        raise wrapped
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
            payload = (True, (samples, event))
        except BaseException as e:  # noqa: B036 - raised again at next()
            payload = (False, e)
        profiler.add_input_stats(
            decode_ms=(time.perf_counter() - t0) * 1e3,
            decoded_samples=len(items) if payload[0] else 0)
        with cond:
            if alive[0] and gen == cur_gen[0]:
                results[(gen, chunk_id)] = payload
                cond.notify_all()


class _DecodePool(object):
    """A bounded multi-worker decode pool with in-order reassembly:
    submit() queues chunk k of the current epoch, pop(k) blocks until it
    is staged; advance_epoch() drops all outstanding work; close() joins
    the workers."""

    def __init__(self, source, num_workers, name='imageiter'):
        self._task_q = queue.SimpleQueue()
        self._cond = threading.Condition()
        self._results = {}
        self._alive = [True]
        self._gen = [0]
        self.num_workers = num_workers
        self._threads = []
        for i in range(num_workers):
            worker = threading.Thread(
                target=_decode_pool_worker,
                args=(source, self._task_q, self._results, self._cond,
                      self._alive, self._gen),
                name='%s-decode-%d' % (name, i), daemon=True)
            worker.start()
            self._threads.append(worker)

    def advance_epoch(self):
        with self._cond:
            self._gen[0] += 1
            self._results.clear()
        while True:
            try:
                self._task_q.get_nowait()
            except queue.Empty:
                break

    def submit(self, chunk_id, items):
        self._task_q.put((self._gen[0], chunk_id, items))

    def ready_depth(self):
        """Chunks decoded and waiting for the consumer."""
        with self._cond:
            return len(self._results)

    def pop(self, chunk_id):
        """Block until chunk `chunk_id` of the current epoch is staged, and
        return its (samples, event); raise the worker's exception if
        decoding it failed."""
        key = (self._gen[0], chunk_id)
        with self._cond:
            while key not in self._results:
                if not self._alive[0]:
                    raise RuntimeError('decode pool is closed')
                if not any(t.is_alive() for t in self._threads):
                    raise MXNetError('all decode workers exited '
                                     'unexpectedly')
                self._cond.wait(0.2)
            ok, payload = self._results.pop(key)
        if not ok:
            raise payload
        return payload

    def close(self):
        """Stop and join the workers (idempotent)."""
        self._alive[0] = False
        for _ in self._threads:
            self._task_q.put(None)
        with self._cond:
            self._cond.notify_all()
        for worker in self._threads:
            worker.join(timeout=5)
        self._threads = [t for t in self._threads if t.is_alive()]

    def alive_workers(self):
        return sum(t.is_alive() for t in self._threads)


def _take_staged(samples, event, device):
    """Samples made on a worker's stream, safe to read on the current
    stream: it waits for `event`, and each tensor is marked as used by
    it."""
    if event is None:
        return samples
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for data, _ in samples:
        data.record_stream(stream)
    return samples


def _label_on(label, ctx):
    """A host float32 label array on ctx's device (pinned, copied without
    blocking on a CUDA device)."""
    t = torch.from_numpy(label)
    if ctx.torch_device.type == 'cuda':
        return t.pin_memory().to(ctx.torch_device, non_blocking=True)
    return t


def _stack_batch(rows, batch_size, data_shape, device):
    """The (batch_size,) + data_shape float32 batch of the rows, the rows
    past them 0 (a padded last batch)."""
    data = torch.stack(rows).to(torch.float32)
    if data.shape[1:] != tuple(data_shape):
        raise MXNetError('an augmented sample is %s, not data_shape %s'
                         % (tuple(data.shape[1:]), tuple(data_shape)))
    if len(rows) < batch_size:
        data = torch.cat([data, data.new_zeros(
            (batch_size - len(rows),) + tuple(data_shape))])
    return data


# ---------------------------------------------------------------------------
# ImageIter (reference image.py ImageIter)
# ---------------------------------------------------------------------------

class ImageIter(mxio.DataIter):
    """Image iterator over a .rec file or an image list and a root
    directory, with augmentation, num_parts / part_index sharding,
    shuffling and a parallel decode pool: the JAX package's ImageIter,
    its batches made on `ctx` (the current context when None: gpu(0)
    unless the caller is in `with mx.cpu():`).

    preprocess_threads (MXNET_TPU_DECODE_WORKERS when None): 2 or more
    start that many decode workers; 0 or 1 keeps the sequential path,
    whose augmentation draws from the global `random`. Parallel epochs
    are the same for any worker count of 2 or more under
    `mx.random.seed()`: each sample's draws are seeded from (seed, epoch,
    position)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root='.',
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name='data', label_name='softmax_label',
                 preprocess_threads=None, ctx=None, **kwargs):
        super(ImageIter, self).__init__(batch_size)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.ctx = _ctx_of(ctx)
        self.device = self.ctx.torch_device
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self._data_name = data_name
        self._label_name = label_name
        self.imgrec = None
        self.imglist = {}
        self.seq = None
        self._workers_explicit = preprocess_threads is not None
        if preprocess_threads is None:
            preprocess_threads = decode_workers_from_env()
        self.preprocess_threads = max(0, int(preprocess_threads))
        num_parts, part_index = _host_shard(num_parts, part_index)
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + '.idx'
            if os.path.isfile(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, 'r')
                self.seq = list(self.imgrec.keys)
            else:
                if shuffle or num_parts > 1:
                    raise ValueError(
                        'shuffle/num_parts on a .rec file require the '
                        '.idx sidecar (%s not found); regenerate with '
                        'tools/im2rec.py' % idx_path)
                self.imgrec = recordio.MXRecordIO(path_imgrec, 'r')
                self.seq = None
        if path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                for line in fin:
                    line = line.strip().split('\t')
                    label = np.array([float(i) for i in line[1:-1]],
                                     np.float32)
                    imglist[int(line[0])] = (label, line[-1])
                self.imglist = imglist
                self.seq = list(imglist.keys())
        elif isinstance(imglist, list):
            result = {}
            for index, img in enumerate(imglist):
                label = np.array(img[0], np.float32).reshape(-1)
                result[index] = (label, img[1])
            self.imglist = result
            self.seq = list(result.keys())
        self.path_root = path_root
        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            span = len(self.seq) // num_parts
            lo = part_index * span
            self.seq = self.seq[lo:lo + span]
        self.auglist = (CreateAugmenter(data_shape, **kwargs)
                        if aug_list is None else aug_list)
        self.cur = 0
        # the parallel pipeline, built at the first next() so that a
        # subclass finishes its own set-up first; _epoch seeds the
        # per-sample augmentation streams
        self._pool = None
        self._source = None
        self._process = None
        self._staged = deque()
        self._epoch = -1
        self._submit_pos = self._submit_chunk = self._consume_chunk = 0
        if self.preprocess_threads >= 2 and self.seq is None:
            logging.warning(
                'ImageIter: preprocess_threads=%d requested but the '
                'input is a pure-stream .rec without an .idx sidecar; '
                'decoding sequentially', self.preprocess_threads)
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self._data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [mxio.DataDesc(self._label_name, shape)]

    def _parallel(self):
        """True when the decode pool serves this iterator."""
        return self.preprocess_threads >= 2 and self.seq is not None

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and not self._parallel():
            # the sequential path's cursor; the pool reads positionally
            self.imgrec.reset()
        self.cur = 0
        self._epoch += 1
        self._staged.clear()
        self._submit_pos = self._submit_chunk = self._consume_chunk = 0
        self._next_pos = 0
        self._chunk_ranges = {}
        # the processing closure again: a subclass may have changed what
        # it captures (ImageDetIter's max_objects)
        self._process = None
        if self._pool is not None:
            self._pool.advance_epoch()
            if self._source is not None:
                self._source.process = self._processor()

    # -- the parallel pipeline ---------------------------------------------
    def _make_process(self):
        """The per-sample closure: augment one decoded image and lay it out
        CHW. It captures the augmenters, not `self`."""
        auglist = list(self.auglist)

        def process(raw_label, img):
            data = img
            for aug in auglist:
                data = aug(data)[0]
            arr = _t(data)
            if arr.dim() == 3:
                arr = arr.permute(2, 0, 1)
            return arr, np.atleast_1d(np.asarray(raw_label, np.float32))
        return process

    def _processor(self):
        """The cached per-sample closure: one definition for the
        sequential path and the decode workers."""
        if self._process is None:
            self._process = self._make_process()
        return self._process

    def _ensure_pool(self):
        if self._pool is None and self._parallel():
            self._source = _SampleSource(self.imgrec, self.imglist,
                                         self.path_root, self._processor(),
                                         self.device)
            self._pool = _DecodePool(self._source, self.preprocess_threads,
                                     name=type(self).__name__.lower())
            self._chunk_records = max(
                1, min(64, self.batch_size // self.preprocess_threads))
            self._max_outstanding = 2 * self.preprocess_threads + 2
        return self._pool

    def _fill_tasks(self):
        """Keep the bounded task window full."""
        from .. import random as mxrandom
        while (self._submit_chunk - self._consume_chunk) < \
                self._max_outstanding and self._submit_pos < len(self.seq):
            hi = min(self._submit_pos + self._chunk_records, len(self.seq))
            items = [(self.seq[p],
                      mxrandom.stream_seed('image-aug', self._epoch, p), p)
                     for p in range(self._submit_pos, hi)]
            self._pool.submit(self._submit_chunk, items)
            self._chunk_ranges[self._submit_chunk] = hi
            self._submit_chunk += 1
            self._submit_pos = hi

    def _pop_staged(self):
        self._next_pos += 1   # the consumed-sample watermark (close())
        return self._staged.popleft()

    def _pull_parallel(self):
        """The next (data, label) in epoch order from the pool; blocks
        only when the pool has fallen behind."""
        if self._staged:
            return self._pop_staged()
        self._fill_tasks()
        if self._consume_chunk >= self._submit_chunk:
            raise StopIteration
        t0 = time.perf_counter()
        chunk = self._consume_chunk
        self._consume_chunk += 1   # past a failed chunk too
        try:
            samples, event = self._pool.pop(chunk)
        except BaseException:
            self._next_pos = self._chunk_ranges.pop(chunk, self._next_pos)
            raise
        self._chunk_ranges.pop(chunk, None)
        self._fill_tasks()
        profiler.add_input_stats(
            decode_wait_ms=(time.perf_counter() - t0) * 1e3,
            queue_depth=self._pool.ready_depth())
        self._staged.extend(_take_staged(samples, event, self.device))
        return self._pop_staged()

    def _pull_sample(self):
        """The sequential pull: read one sample and run the workers'
        closure on the caller's thread with the global random."""
        raw_label, data = self.next_sample()
        return self._processor()(raw_label, data)

    def set_preprocess_threads(self, n):
        """Change the decode worker count (0 or 1: sequential); resets the
        iterator so that the new pipeline starts an epoch."""
        n = max(0, int(n))
        self._workers_explicit = True
        if n == self.preprocess_threads:
            return self
        self.close()
        self.preprocess_threads = n
        self.reset()
        return self

    def _discard_inflight(self):
        """Drop staged and in-flight work and rewind submission to the
        consumed-sample watermark (resubmitted positions decode to the
        same samples)."""
        self._staged.clear()
        self._chunk_ranges = {}
        self._submit_chunk = self._consume_chunk = 0
        self._submit_pos = self._next_pos
        if self._pool is not None:
            self._pool.advance_epoch()

    def close(self):
        """Join the decode workers (idempotent; __del__ calls it). The
        iterator stays usable: the pool restarts at the next next()."""
        if getattr(self, '_pool', None) is not None:
            self._pool.close()
            self._pool = None
            self._source = None
            self._discard_inflight()

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: attributes may be gone
            pass

    def _decode(self, buf):
        return decode_tensor(buf, self.device)

    def next_sample(self):
        """(label, the decoded (H, W, C) uint8 tensor on the device)."""
        if self.seq is None:
            packed = self.imgrec.read()
            if packed is None:
                raise StopIteration
            header, img = recordio.unpack(packed)
            return header.label, self._decode(img)
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            return header.label, self._decode(img)
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), 'rb') as f:
            return label, self._decode(f.read())

    def _pull_rows(self):
        """Up to batch_size (data, label) rows of the next batch."""
        pull = self._pull_parallel if self._ensure_pool() is not None \
            else self._pull_sample
        rows = []
        try:
            while len(rows) < self.batch_size:
                rows.append(pull())
        except StopIteration:
            if not rows:
                raise
        return rows

    def next(self):
        rows = self._pull_rows()
        shape = (self.batch_size, self.label_width) \
            if self.label_width > 1 else (self.batch_size,)
        batch_label = np.zeros(shape, np.float32)
        for i, (_, label) in enumerate(rows):
            batch_label[i] = label[0] if self.label_width == 1 \
                else label[:self.label_width]
        data = _stack_batch([d for d, _ in rows], self.batch_size,
                            self.data_shape, self.device)
        return mxio.DataBatch(
            data=[NDArray(data, self.ctx)],
            label=[NDArray(_label_on(batch_label, self.ctx), self.ctx)],
            pad=self.batch_size - len(rows), index=None,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
