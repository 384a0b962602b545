"""The detection image pipeline (`mx.image.ImageDetIter`): the
counterpart of mxnet_tpu/image/detection.py (reference
python/mxnet/image/detection.py).

Detection augmenters transform (image, boxes) together: crops eject or
clip boxes, pads and flips move them. The image is a tensor on its
device, as in image.py, and the (max_objects, width) label a host numpy
array, drawn and moved in the JAX package's order. ImageDetIter batches
the labels into a (batch, max_objects, width) tensor padded with -1,
the input MultiBoxTarget takes.
"""
import inspect

import numpy as np
import torch

from .. import io as mxio
from .. import recordio
from ..base import MXNetError
from ..ndarray import NDArray
from .image import (ImageIter, ResizeAug, ForceResizeAug, CastAug,
                    ColorJitterAug, LightingAug, ColorNormalizeAug, _t,
                    _like, _rng, _label_on, _stack_batch, IMAGENET_PCA,
                    IMAGENET_MEAN, IMAGENET_STD)


class DetAugmenter(object):
    """Detection augmenter base: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only Augmenter for detection (the label untouched)."""

    def __init__(self, augmenter):
        super(DetBorrowAug, self).__init__(augmenter=augmenter.__class__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        out = self.augmenter(src)
        src = out[0] if isinstance(out, (list, tuple)) else out
        return src, label


class DetRandomSelectAug(DetAugmenter):
    """One of the augmenters at random, or none with skip_prob."""

    def __init__(self, aug_list, skip_prob=0):
        super(DetRandomSelectAug, self).__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _rng().random() < self.skip_prob or not self.aug_list:
            return src, label
        return _rng().choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image and the boxes' x coordinates with probability p."""

    def __init__(self, p):
        super(DetHorizontalFlipAug, self).__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rng().random() < self.p:
            src = _like(torch.flip(_t(src), [1]), src)
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


def _box_iou_1(crop, boxes):
    """crop (4,), boxes (N, 4) normalised corners -> IoU (N,)."""
    ix = np.maximum(0, np.minimum(crop[2], boxes[:, 2]) -
                    np.maximum(crop[0], boxes[:, 0]))
    iy = np.maximum(0, np.minimum(crop[3], boxes[:, 3]) -
                    np.maximum(crop[1], boxes[:, 1]))
    inter = ix * iy
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_c = (crop[2] - crop[0]) * (crop[3] - crop[1])
    union = area_b + area_c - inter
    return np.where(union > 0, inter / union, 0)


def _update_labels_crop(label, crop, min_eject_coverage):
    """The labels in the crop's coordinates; boxes whose remaining share
    is under min_eject_coverage are ejected."""
    out = np.full_like(label, -1.0)
    cw = crop[2] - crop[0]
    ch = crop[3] - crop[1]
    j = 0
    for row in label:
        if row[0] < 0:
            continue
        x1, y1, x2, y2 = row[1:5]
        nx1, ny1 = max(x1, crop[0]), max(y1, crop[1])
        nx2, ny2 = min(x2, crop[2]), min(y2, crop[3])
        area = max(0, x2 - x1) * max(0, y2 - y1)
        new_area = max(0, nx2 - nx1) * max(0, ny2 - ny1)
        if area <= 0 or new_area / area < min_eject_coverage:
            continue
        out[j, 0] = row[0]
        out[j, 1] = (nx1 - crop[0]) / cw
        out[j, 2] = (ny1 - crop[1]) / ch
        out[j, 3] = (nx2 - crop[0]) / cw
        out[j, 4] = (ny2 - crop[1]) / ch
        out[j, 5:] = row[5:]
        j += 1
    return out, j > 0


class DetRandomCropAug(DetAugmenter):
    """A random crop under object-coverage constraints."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super(DetRandomCropAug, self).__init__()
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        boxes = label[label[:, 0] >= 0][:, 1:5]
        for _ in range(self.max_attempts):
            area = _rng().uniform(*self.area_range)
            ratio = _rng().uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(area * ratio))
            ch = min(1.0, np.sqrt(area / ratio))
            cx = _rng().uniform(0, 1.0 - cw)
            cy = _rng().uniform(0, 1.0 - ch)
            crop = np.array([cx, cy, cx + cw, cy + ch])
            if len(boxes):
                if _box_iou_1(crop, boxes).max() < self.min_object_covered:
                    continue
            new_label, any_left = _update_labels_crop(
                label, crop, self.min_eject_coverage)
            if not any_left and len(boxes):
                continue
            x0, y0 = int(cx * w), int(cy * h)
            x1, y1 = max(x0 + 1, int((cx + cw) * w)), \
                max(y0 + 1, int((cy + ch) * h))
            return _like(_t(src)[y0:y1, x0:x1], src), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """A random pad (zooming out), the boxes rescaled."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(128, 128, 128)):
        super(DetRandomPadAug, self).__init__()
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = _t(src)
        h, w, c = img.shape
        scale = _rng().uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        ratio = _rng().uniform(*self.aspect_ratio_range)
        nw = min(int(w * np.sqrt(scale * ratio)), w * 4)
        nh = min(int(h * np.sqrt(scale / ratio)), h * 4)
        nw, nh = max(nw, w), max(nh, h)
        ox = _rng().randint(0, nw - w)
        oy = _rng().randint(0, nh - h)
        fill = np.asarray(self.pad_val, dtype=np.float64)[:c]
        out = torch.empty((nh, nw, c), dtype=img.dtype, device=img.device)
        out[:] = torch.as_tensor(fill).to(device=img.device, dtype=img.dtype)
        out[oy:oy + h, ox:ox + w] = img
        new_label = label.copy()
        valid = new_label[:, 0] >= 0
        new_label[valid, 1] = (label[valid, 1] * w + ox) / nw
        new_label[valid, 2] = (label[valid, 2] * h + oy) / nh
        new_label[valid, 3] = (label[valid, 3] * w + ox) / nw
        new_label[valid, 4] = (label[valid, 4] * h + oy) / nh
        return _like(out, src), new_label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0., rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The standard detection augmentation chain (reference
    CreateDetAugmenter): every sample force-resized to data_shape with
    inter_method (INTER_CUBIC by default)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(LightingAug(pca_noise, *IMAGENET_PCA)))
    if mean is True:
        mean = IMAGENET_MEAN
    if std is True:
        std = IMAGENET_STD
    if mean is not None and not isinstance(mean, bool):
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            np.asarray(mean), np.asarray(std) if std is not None else None)))
    return auglist


def _parse_det_label(raw, object_width):
    """A flat label vector -> (num_objects, object_width): [header width,
    object width, header..., object 0..., object 1...], as
    tools/im2rec.py packs it, or a plain [cls, x1, y1, x2, y2] * N."""
    raw = np.asarray(raw, np.float32).ravel()
    if raw.size < 2:
        raise MXNetError('label must have at least 2 elements')
    header_width = int(raw[0])
    obj_width = int(raw[1])
    if obj_width <= 0 or (raw.size - header_width) % obj_width != 0:
        if raw.size % object_width == 0:
            return raw.reshape(-1, object_width)
        raise MXNetError('invalid detection label of size %d' % raw.size)
    out = raw[header_width:].reshape(-1, obj_width)
    if obj_width < object_width:
        raise MXNetError(
            'detection label object width %d < iterator '
            'object_width %d' % (obj_width, object_width))
    return out[:, :object_width]


class ImageDetIter(ImageIter):
    """The detection iterator: (batch, max_objects, object_width) labels
    padded with -1, the images augmented with the boxes. It has
    ImageIter's decode pool and context."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root='.', shuffle=False,
                 part_index=0, num_parts=1, aug_list=None, imglist=None,
                 object_width=5, max_objects=None,
                 data_name='data', label_name='label',
                 preprocess_threads=None, ctx=None, **kwargs):
        if aug_list is None:
            params = set(inspect.signature(
                CreateDetAugmenter).parameters) - {'data_shape'}
            unknown = set(kwargs) - params
            if unknown:
                raise TypeError('ImageDetIter: unknown arguments %s'
                                % sorted(unknown))
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super(ImageDetIter, self).__init__(
            batch_size=batch_size, data_shape=data_shape,
            path_imgrec=path_imgrec, path_imglist=path_imglist,
            path_root=path_root, shuffle=shuffle, part_index=part_index,
            num_parts=num_parts, aug_list=[], imglist=imglist,
            data_name=data_name, label_name=label_name,
            preprocess_threads=preprocess_threads, ctx=ctx)
        self.det_auglist = aug_list
        self.object_width = object_width
        if max_objects is None:
            max_objects = self._scan_max_objects()
        self.max_objects = max_objects

    def _parse_label(self, raw):
        return _parse_det_label(raw, self.object_width)

    def _scan_max_objects(self):
        """One pass over the labels of the whole dataset (every shard
        derives the same max_objects)."""
        max_obj = 1
        if self.imglist:
            for label, _ in self.imglist.values():
                max_obj = max(max_obj, self._parse_label(label).shape[0])
        elif getattr(self.imgrec, 'keys', None):
            for key in self.imgrec.keys:
                header, _ = recordio.unpack(self.imgrec.read_idx(key))
                max_obj = max(max_obj,
                              self._parse_label(header.label).shape[0])
        else:
            self.reset()
            while True:
                try:
                    label, _ = self.next_sample()
                except StopIteration:
                    break
                max_obj = max(max_obj, self._parse_label(label).shape[0])
            self.reset()
        return max_obj

    @property
    def provide_label(self):
        return [mxio.DataDesc(
            self._label_name,
            (self.batch_size, self.max_objects, self.object_width))]

    def _make_process(self):
        """The per-sample closure: parse and pad the label, run the
        (image, boxes) chain. Rebuilt at every reset, so that
        sync_label_shape's max_objects reaches the workers."""
        det_auglist = list(self.det_auglist)
        max_objects, object_width = self.max_objects, self.object_width

        def process(raw_label, img):
            label = _parse_det_label(raw_label, object_width)
            padded = np.full((max_objects, object_width), -1.0,
                             np.float32)
            n = min(len(label), max_objects)
            padded[:n] = label[:n]
            data = img
            for aug in det_auglist:
                data, padded = aug(data, padded)
            arr = _t(data)
            if arr.dim() == 3:
                arr = arr.permute(2, 0, 1)
            return arr, padded
        return process

    def next(self):
        rows = self._pull_rows()
        bl = np.full((self.batch_size, self.max_objects,
                      self.object_width), -1.0, np.float32)
        for i, (_, padded) in enumerate(rows):
            bl[i] = padded
        data = _stack_batch([d for d, _ in rows], self.batch_size,
                            self.data_shape, self.device)
        return mxio.DataBatch(
            data=[NDArray(data, self.ctx)],
            label=[NDArray(_label_on(bl, self.ctx), self.ctx)],
            pad=self.batch_size - len(rows), index=None,
            provide_data=self.provide_data,
            provide_label=self.provide_label)

    def sync_label_shape(self, it, verbose=False):
        """Make two iterators (train and val) agree on the label padding."""
        assert isinstance(it, ImageDetIter)
        m = max(self.max_objects, it.max_objects)
        self.max_objects = m
        it.max_objects = m
        # the cached closures and every staged or in-flight sample baked
        # the old max_objects: drop them (they decode again the same)
        for obj in (self, it):
            obj._process = None
            obj._discard_inflight()
            if obj._source is not None:
                obj._source.process = obj._processor()
        return it
