"""Datasets, the counterpart of mxnet_tpu/gluon/data/dataset.py
(reference python/mxnet/gluon/data/dataset.py)."""
from ... import ndarray as nd
from ... import recordio


class Dataset(object):
    """Abstract dataset: indexable collection of samples."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """Wrap any indexable (list, array) as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of N indexables: returns tuples (reference ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, 'Needs at least 1 arrays'
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                'All arrays must have the same length; array[0] has ' \
                'length %d while array[%d] has %d.' \
                % (self._length, i, len(data))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file via the indexed reader
    (reference gluon/data/dataset.py RecordFileDataset)."""

    def __init__(self, filename):
        idx_file = filename[:filename.rindex('.')] + '.idx'
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, 'r')

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
