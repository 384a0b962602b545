"""RecordIO, the magic-delimited binary record format: the counterpart of
mxnet_tpu/recordio.py (reference python/mxnet/recordio.py), the JAX
package's pure-Python code, so files are byte-compatible both ways.

Each record is uint32 magic | uint32 (cflag << 29 | length) | payload,
padded to 4 bytes; multi-part records are chained by cflag (dmlc-core's
spec). unpack_img decodes, and pack_img encodes, with cv2, else PIL,
imported when called; without either they raise ImportError. pack_img
of an image on the card encodes JPEG there with nvJPEG.
"""
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

_MAGIC = 0xced7230a
_KMAGIC_PACK = struct.pack('<I', _MAGIC)

# continuation flags (dmlc-core recordio spec)
_CFLAG_WHOLE = 0
_CFLAG_BEGIN = 1
_CFLAG_MIDDLE = 2
_CFLAG_END = 3


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


class MXRecordIO(object):
    """Sequential reader/writer for .rec files
    (reference recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == 'w':
            self.fp = open(self.uri, 'wb')
            self.writable = True
        elif self.flag == 'r':
            self.fp = open(self.uri, 'rb')
            self.writable = False
        else:
            raise ValueError('Invalid flag %s' % self.flag)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.fp.close()
        self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d['is_open'] = False
        d['fp'] = None
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        if not self.is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fp.tell()

    def write(self, buf):
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode('utf-8')
        length = len(buf)
        self.fp.write(_KMAGIC_PACK)
        self.fp.write(struct.pack('<I', _encode_lrec(_CFLAG_WHOLE, length)))
        self.fp.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.write(b'\x00' * pad)

    def read(self):
        assert not self.writable
        parts = []
        while True:
            head = self.fp.read(8)
            if len(head) < 8:
                return None if not parts else b''.join(parts)
            magic, lrec = struct.unpack('<II', head)
            if magic != _MAGIC:
                raise IOError('Invalid RecordIO magic in %s' % self.uri)
            cflag, length = _decode_lrec(lrec)
            data = self.fp.read(length)
            if len(data) < length:
                raise IOError('Truncated record in %s' % self.uri)
            pad = (4 - length % 4) % 4
            if pad:
                self.fp.read(pad)
            parts.append(data)
            if cflag in (_CFLAG_WHOLE, _CFLAG_END):
                return b''.join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with an .idx sidecar
    (reference recordio.py:170)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        import threading
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        # read_idx goes through positional os.pread and needs no lock;
        # this guards the seek+read fallback on platforms without pread
        self._lock = threading.Lock()
        super(MXIndexedRecordIO, self).__init__(uri, flag)

    def open(self):
        super(MXIndexedRecordIO, self).open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split('\t')
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, 'w') as fout:
                for k in self.keys:
                    fout.write('%s\t%d\n' % (str(k), self.idx[k]))
        super(MXIndexedRecordIO, self).close()

    def __getstate__(self):
        d = super(MXIndexedRecordIO, self).__getstate__()
        d.pop('_lock', None)
        return d

    def __setstate__(self, d):
        import threading
        super(MXIndexedRecordIO, self).__setstate__(d)
        self._lock = threading.Lock()

    def seek(self, idx):
        assert not self.writable
        self.fp.seek(self.idx[idx])

    def read_at(self, pos):
        """Read the (possibly multi-part) record starting at byte `pos`
        WITHOUT moving the shared file cursor.  os.pread is positional
        and atomic per call, so any number of decode-pool workers can
        read concurrently through this one open fd — no lock, no
        per-worker reader handles (the thread-safety story behind
        image.ImageIter's parallel pipeline)."""
        assert not self.writable
        if not hasattr(os, 'pread'):  # pragma: no cover - non-POSIX
            with self._lock:
                self.fp.seek(pos)
                return self.read()
        fd = self.fp.fileno()
        parts = []
        while True:
            head = os.pread(fd, 8, pos)
            if len(head) < 8:
                return None if not parts else b''.join(parts)
            magic, lrec = struct.unpack('<II', head)
            if magic != _MAGIC:
                raise IOError('Invalid RecordIO magic in %s' % self.uri)
            cflag, length = _decode_lrec(lrec)
            pos += 8
            data = os.pread(fd, length, pos)
            while len(data) < length:
                more = os.pread(fd, length - len(data), pos + len(data))
                if not more:
                    raise IOError('Truncated record in %s' % self.uri)
                data += more
            pos += length + ((4 - length % 4) % 4)
            parts.append(data)
            if cflag in (_CFLAG_WHOLE, _CFLAG_END):
                return b''.join(parts)

    def read_idx(self, idx):
        return self.read_at(self.idx[idx])

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple('HEADER', ['flag', 'label', 'id', 'id2'])
_IR_FORMAT = 'IfQQ'
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into an image record payload
    (reference recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(s, str):
        s = s.encode('utf-8')
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    """Unpack an image record payload into (IRHeader, bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s[:header.flag * 4], dtype=np.float32))
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, decoded image array)."""
    header, s = unpack(s)
    img = _imdecode(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt='.jpg'):
    """Encode an image (H, W, C) uint8 in OpenCV's BGR order and pack it
    into a record payload: a CUDA tensor (or an NDArray on the card) by
    nvJPEG there, JPEG only; an array on the host by cv2, else PIL."""
    from .ndarray import NDArray
    data = img._data if isinstance(img, NDArray) else img
    if getattr(data, 'is_cuda', False):
        if img_fmt.lower() not in ('.jpg', '.jpeg'):
            raise ValueError('pack_img of an image on the card encodes '
                             'JPEG with nvJPEG, not %s' % img_fmt)
        from .image import _nvjpeg
        return pack(header, _nvjpeg.encode(data, quality))
    if hasattr(data, 'numpy'):
        img = data.numpy()
    buf = _imencode(img, quality, img_fmt)
    return pack(header, buf)


def _imdecode(buf, iscolor=-1):
    """Decode an encoded image (PNG/JPEG/BMP) to a HWC uint8 array.
    Uses cv2 if present, else PIL, else raises."""
    arr = np.frombuffer(buf, dtype=np.uint8) \
        if not isinstance(buf, np.ndarray) else buf
    try:
        import cv2
        return cv2.imdecode(arr, iscolor)
    except ImportError:
        pass
    try:
        import io as _io
        from PIL import Image
        img = Image.open(_io.BytesIO(bytes(buf)))
        return np.asarray(img)
    except ImportError:
        raise ImportError(
            'Neither cv2 nor PIL available for image decoding')


def _imencode(img, quality=95, img_fmt='.jpg'):
    img = np.asarray(img)
    try:
        import cv2
        encode_params = None
        if img_fmt.lower() in ('.jpg', '.jpeg'):
            encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        ret, buf = cv2.imencode(img_fmt, img, encode_params or [])
        assert ret, 'failed to encode image'
        return buf.tobytes()
    except ImportError:
        pass
    try:
        import io as _io
        from PIL import Image
        bio = _io.BytesIO()
        fmt = {'jpg': 'JPEG', 'jpeg': 'JPEG', 'png': 'PNG',
               'bmp': 'BMP'}[img_fmt.lstrip('.').lower()]
        Image.fromarray(img).save(bio, format=fmt, quality=quality)
        return bio.getvalue()
    except ImportError:
        raise ImportError(
            'Neither cv2 nor PIL available for image encoding')
