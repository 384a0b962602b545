"""im2rec: pack an image folder or a list file into RecordIO, on the
port's `recordio` (the flags and the files of the JAX package's
tools/im2rec.py, byte for byte).

  python -m mxnet_tpu_torch.tools.im2rec --list prefix root  # prefix.lst
  python -m mxnet_tpu_torch.tools.im2rec prefix root         # .rec, .idx

--list writes the images under root (with --recursive, one label per
folder) in a shuffle seeded with 100, unless --no-shuffle. Packing
stores each file's bytes as they are, and decodes and re-encodes with
cv2 only when --resize, --center-crop or a --quality other than 95 asks
for it.
"""
import argparse
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from mxnet_tpu_torch import recordio  # noqa: E402


def list_image(root, recursive, exts):
    """(index, path relative to root, label) of each image, in sorted
    order; with `recursive`, each folder is a label."""
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and suffix in exts:
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and suffix in exts:
                yield (i, os.path.relpath(fpath, root), 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, 'w') as fout:
        for item in image_list:
            line = '%d\t' % item[0]
            for j in item[2:]:
                line += '%f\t' % j
            line += '%s\n' % item[1]
            fout.write(line)


def read_list(path_in):
    """[index, path, label...] of each line of a .lst file."""
    with open(path_in) as fin:
        for line in fin:
            line = [i.strip() for i in line.strip().split('\t')]
            if len(line) < 3:
                continue
            yield [int(line[0])] + [line[-1]] + \
                [float(i) for i in line[1:-1]]


def make_list(args):
    image_list = list(list_image(args.root, args.recursive, args.exts))
    if args.shuffle:
        random.seed(100)
        random.shuffle(image_list)
    write_list(args.prefix + '.lst', image_list)


def reencode(img, args):
    """The image bytes decoded, center-cropped to a square, resized so
    that the shorter side is args.resize, and encoded again, as
    args.encoding at args.quality."""
    import cv2
    import numpy as np
    arr = cv2.imdecode(np.frombuffer(img, np.uint8), args.color)
    if args.center_crop and arr.shape[0] != arr.shape[1]:
        margin = abs(arr.shape[0] - arr.shape[1]) // 2
        if arr.shape[0] > arr.shape[1]:
            arr = arr[margin:margin + arr.shape[1]]
        else:
            arr = arr[:, margin:margin + arr.shape[0]]
    if args.resize:
        h, w = arr.shape[:2]
        if h > w:
            arr = cv2.resize(arr, (args.resize, args.resize * h // w))
        else:
            arr = cv2.resize(arr, (args.resize * w // h, args.resize))
    ret, buf = cv2.imencode(args.encoding, arr,
                            [cv2.IMWRITE_JPEG_QUALITY, args.quality])
    assert ret
    return buf.tobytes()


def im2rec(args):
    lst = args.prefix + '.lst'
    assert os.path.isfile(lst), 'list file %s not found' % lst
    record = recordio.MXIndexedRecordIO(
        args.prefix + '.idx', args.prefix + '.rec', 'w')
    count = 0
    for item in read_list(lst):
        with open(os.path.join(args.root, item[1]), 'rb') as fin:
            img = fin.read()
        if args.resize or args.center_crop or args.quality != 95:
            img = reencode(img, args)
        header = recordio.IRHeader(0, item[2] if len(item) == 3
                                   else item[2:], item[0], 0)
        record.write_idx(item[0], recordio.pack(header, img))
        count += 1
    record.close()
    print('packed %d records into %s.rec' % (count, args.prefix))


def main(argv=None):
    parser = argparse.ArgumentParser(description='im2rec')
    parser.add_argument('prefix')
    parser.add_argument('root')
    parser.add_argument('--list', action='store_true')
    parser.add_argument('--exts', nargs='+',
                        default=['.jpeg', '.jpg', '.png'])
    parser.add_argument('--recursive', action='store_true')
    parser.add_argument('--shuffle', dest='shuffle', action='store_true',
                        default=True)
    parser.add_argument('--no-shuffle', dest='shuffle',
                        action='store_false')
    parser.add_argument('--resize', type=int, default=0)
    parser.add_argument('--center-crop', action='store_true')
    parser.add_argument('--quality', type=int, default=95)
    parser.add_argument('--color', type=int, default=1)
    parser.add_argument('--encoding', default='.jpg')
    args = parser.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        im2rec(args)


if __name__ == '__main__':
    main()
