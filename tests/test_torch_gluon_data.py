"""The port's Gluon data pipeline against the JAX package's, on the CPU:
datasets, samplers and the DataLoader (its thread pool included) give the
same batches, MNIST and CIFAR10 read the same local files the same way
and raise when they are absent, and SyntheticImageDataset gives the same
seeded images; following tests/test_gluon_data.py.
"""
import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import recordio


def _batches(pkg, loader):
    out = []
    for batch in loader:
        items = batch if isinstance(batch, (list, tuple)) else [batch]
        out.append([b.asnumpy() for b in items])
    return out


@pytest.mark.parametrize('workers', [0, 2])
def test_array_dataset_dataloader_matches_jax(workers):
    X = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    got = {}
    for pkg in (jmx, mx):
        with pkg.cpu():
            ds = pkg.gluon.data.ArrayDataset(X, y)
            loader = pkg.gluon.data.DataLoader(ds, batch_size=4,
                                               num_workers=workers)
            assert len(ds) == 10 and len(loader) == 3
            got[pkg] = _batches(pkg, loader)
    assert len(got[mx]) == 3
    for tb, jb in zip(got[mx], got[jmx]):
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t, j)
            assert t.dtype == j.dtype


def test_workers_make_arrays_on_the_callers_context():
    ds = tgluon.data.SimpleDataset([np.float32(i) for i in range(8)])
    with mx.cpu(1):
        for batch in tgluon.data.DataLoader(ds, batch_size=4,
                                            num_workers=2):
            assert batch.context == mx.cpu(1)


def test_dataloader_shuffle_discard_and_rollover():
    ds = tgluon.data.ArrayDataset(np.arange(10).astype(np.float32))
    with mx.cpu():
        batches = list(tgluon.data.DataLoader(ds, batch_size=3, shuffle=True,
                                              last_batch='discard'))
    assert len(batches) == 3
    seen = np.concatenate([b.asnumpy() for b in batches])
    assert len(set(seen.tolist())) == 9
    sampler = tgluon.data.BatchSampler(tgluon.data.SequentialSampler(5), 2,
                                       'rollover')
    assert [list(b) for b in sampler] == [[0, 1], [2, 3]]
    assert [list(b) for b in sampler] == [[4, 0], [1, 2], [3, 4]]
    with pytest.raises(ValueError):
        tgluon.data.BatchSampler(sampler, 2, 'nope')
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(ds)
    with pytest.raises(ValueError):
        tgluon.data.DataLoader(ds, batch_size=2, shuffle=True,
                               sampler=tgluon.data.SequentialSampler(10))


def test_dataset_transform_and_samplers():
    ds = tgluon.data.SimpleDataset(list(range(5))).transform(lambda x: x * 2)
    assert ds[2] == 4
    pairs = tgluon.data.ArrayDataset(np.arange(4), np.arange(4) * 10)
    first = pairs.transform_first(lambda x: x + 1)
    assert first[1] == (2, 10)
    eager = pairs.transform(lambda a, b: a + b, lazy=False)
    assert [eager[i] for i in range(4)] == [0, 11, 22, 33]
    assert list(tgluon.data.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    assert sorted(tgluon.data.RandomSampler(5)) == [0, 1, 2, 3, 4]


def test_record_file_dataset(tmp_path):
    path = str(tmp_path / 'ds.rec')
    idxp = str(tmp_path / 'ds.idx')
    rec = recordio.MXIndexedRecordIO(idxp, path, 'w')
    for i in range(4):
        rec.write_idx(i, ('item%d' % i).encode())
    rec.close()
    ds = tgluon.data.RecordFileDataset(path)
    jds = jmx.gluon.data.RecordFileDataset(path)
    assert len(ds) == len(jds) == 4
    assert [ds[i] for i in range(4)] == [jds[i] for i in range(4)]


def _write_mnist(root, n=6, gz=False):
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = '.gz' if gz else ''
    with opener(str(root / ('train-images-idx3-ubyte' + suffix)),
                'wb') as f:
        f.write(struct.pack('>IIII', 2051, n, 28, 28) + images.tobytes())
    with opener(str(root / ('train-labels-idx1-ubyte' + suffix)),
                'wb') as f:
        f.write(struct.pack('>II', 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize('gz', [False, True])
def test_mnist_reads_local_files_as_jax(tmp_path, gz):
    images, labels = _write_mnist(tmp_path, gz=gz)
    with mx.cpu():
        ds = tgluon.data.vision.MNIST(root=str(tmp_path))
        jds = jmx.gluon.data.vision.MNIST(root=str(tmp_path))
        assert len(ds) == len(jds) == len(labels)
        for i in range(len(ds)):
            img, lab = ds[i]
            jimg, jlab = jds[i]
            np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())
            np.testing.assert_array_equal(img.asnumpy()[..., 0], images[i])
            assert lab == jlab == labels[i]
    with pytest.raises(IOError, match='not found'):
        tgluon.data.vision.MNIST(root=str(tmp_path), train=False)


def test_cifar10_reads_local_files_as_jax(tmp_path):
    rs = np.random.RandomState(2)
    for i in range(1, 6):
        raw = rs.randint(0, 256, (3, 3073)).astype(np.uint8)
        raw[:, 0] = rs.randint(0, 10, 3)
        (tmp_path / ('data_batch_%d.bin' % i)).write_bytes(raw.tobytes())
    with mx.cpu():
        ds = tgluon.data.vision.CIFAR10(root=str(tmp_path),
                                        transform=lambda d, l: (d, l + 1))
        jds = jmx.gluon.data.vision.CIFAR10(
            root=str(tmp_path), transform=lambda d, l: (d, l + 1))
        assert len(ds) == len(jds) == 15
        for i in (0, 7, 14):
            np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                          jds[i][0].asnumpy())
            assert ds[i][1] == jds[i][1]
        assert ds[0][0].shape == (32, 32, 3)
    with pytest.raises(IOError, match='not found'):
        tgluon.data.vision.CIFAR10(root=str(tmp_path), train=False)


def test_synthetic_vision_dataset_matches_jax():
    with mx.cpu():
        ds = tgluon.data.vision.SyntheticImageDataset(
            num_samples=20, shape=(8, 8, 3), seed=3)
        jds = jmx.gluon.data.vision.SyntheticImageDataset(
            num_samples=20, shape=(8, 8, 3), seed=3)
        img, label = ds[5]
        jimg, jlabel = jds[5]
        assert img.shape == (8, 8, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img.asnumpy(), jimg.asnumpy())
        assert label == jlabel
        data, labels = next(iter(tgluon.data.DataLoader(ds, batch_size=5)))
        assert data.shape == (5, 8, 8, 3) and labels.shape == (5,)
