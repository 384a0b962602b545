"""Vision datasets, the counterpart of mxnet_tpu/gluon/data/vision.py
(reference python/mxnet/gluon/data/vision.py: MNIST, CIFAR10).

The datasets load from local files under `root` in their standard
formats (MNIST idx, CIFAR-10 binary) and raise when the files are
absent, as in the JAX package: nothing is downloaded.
`SyntheticImageDataset` gives seeded images with the same sample
interface for tests and benchmarks.
"""
import gzip
import os
import struct

import numpy as np

from ... import ndarray as nd
from .dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train, self._transform = train, transform
        self._data = self._label = None
        self._get_data()

    def __getitem__(self, idx):
        sample = nd.array(self._data[idx], dtype=self._data.dtype)
        if self._transform is None:
            return sample, self._label[idx]
        return self._transform(sample, self._label[idx])

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (train-images-idx3-ubyte(.gz) etc.)."""

    def __init__(self, root='~/.mxnet/datasets/mnist', train=True,
                 transform=None):
        super(MNIST, self).__init__(root, train, transform)

    def _get_data(self):
        if self._train:
            data_file = 'train-images-idx3-ubyte'
            label_file = 'train-labels-idx1-ubyte'
        else:
            data_file = 't10k-images-idx3-ubyte'
            label_file = 't10k-labels-idx1-ubyte'
        data_path = self._find(data_file)
        label_path = self._find(label_file)
        with self._open(label_path) as fin:
            struct.unpack('>II', fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.int32)
        with self._open(data_path) as fin:
            struct.unpack('>IIII', fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._data = data  # numpy; converted per sample in __getitem__
        self._label = label

    def _find(self, name):
        for cand in (name, name + '.gz'):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise IOError(
            'MNIST file %s not found under %s (nothing is downloaded; '
            'place the standard idx files there).' % (name, self._root))

    @staticmethod
    def _open(path):
        return gzip.open(path, 'rb') if path.endswith('.gz') \
            else open(path, 'rb')


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the local binary batches."""

    def __init__(self, root='~/.mxnet/datasets/cifar10', train=True,
                 transform=None):
        super(CIFAR10, self).__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, 'rb') as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        raw = raw.reshape(-1, 3073)
        return raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            raw[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = ['data_batch_%d.bin' % i for i in range(1, 6)]
        else:
            files = ['test_batch.bin']
        data, label = zip(*[self._read_batch(self._path(f))
                            for f in files])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)

    def _path(self, name):
        for cand in (os.path.join(self._root, name),
                     os.path.join(self._root, 'cifar-10-batches-bin', name)):
            if os.path.exists(cand):
                return cand
        raise IOError(
            'CIFAR-10 file %s not found under %s (nothing is downloaded; '
            'place the binary batches there).' % (name, self._root))


class SyntheticImageDataset(Dataset):
    """Deterministic fake image classification data for tests/benchmarks."""

    def __init__(self, num_samples=1000, shape=(28, 28, 1), num_classes=10,
                 transform=None, seed=0):
        self._n = num_samples
        self._shape = shape
        self._classes = num_classes
        self._transform = transform
        rng = np.random.RandomState(seed)
        self._raw = rng.randint(0, 256, (num_samples,) + tuple(shape)) \
            .astype(np.uint8)
        self._labels = rng.randint(0, num_classes, num_samples) \
            .astype(np.int32)

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        data = nd.array(self._raw[idx], dtype=np.uint8)
        if self._transform is not None:
            return self._transform(data, self._labels[idx])
        return data, self._labels[idx]
