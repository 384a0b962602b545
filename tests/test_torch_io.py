"""The port's data iterators, RecordIO and checkpoint files against the
JAX package's, on the CPU.

- NDArrayIter's batches, pads and seeded shuffle (numpy's global
  generator, seeded before each package's iterator) are equal, for pad,
  discard and roll_over, over two epochs; so are ResizeIter's,
  PrefetchingIter's, CSVIter's and MNISTIter's;
- prefetch_to_device (its staging thread; on the CPU the copies are
  synchronous) serves the source's batches and stops its thread;
- RecordIO files (plain and indexed, packed image records) and
  save_checkpoint files are byte-equal, and each package reads the
  other's.
"""
import gzip
import struct
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import model as jmodel
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import recordio as trec


def _data(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3, 2).astype(np.float32), \
        rng.randint(0, 4, n).astype(np.float32)


def _epochs(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([([d.asnumpy() for d in b.data],
                     [l.asnumpy() for l in b.label], b.pad) for b in it])
        it.reset()
    return out


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for ge, re_ in zip(got, ref):
        assert len(ge) == len(re_)
        for (gd, gl, gp), (rd, rl, rp) in zip(ge, re_):
            assert gp == rp
            for a, b in zip(gd + gl, rd + rl):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('handle', ['pad', 'discard', 'roll_over'])
def test_ndarray_iter_matches_jax(handle, shuffle):
    x, y = _data()
    out = []
    for io_mod in (jio, tio):
        np.random.seed(5)
        it = io_mod.NDArrayIter({'a': x, 'b': x[:, 0]}, y, batch_size=5,
                                shuffle=shuffle, last_batch_handle=handle)
        out.append((_epochs(it), it.provide_data, it.provide_label))
    _assert_same(out[1][0], out[0][0])
    assert [tuple(d) for d in out[1][1]] == [tuple(d) for d in out[0][1]]
    assert [tuple(d) for d in out[1][2]] == [tuple(d) for d in out[0][2]]


def test_ndarray_iter_batches_are_host_arrays_in_the_jax_dtypes():
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    batch = tio.NDArrayIter(x, y, batch_size=4).next()
    assert batch.data[0].context == mx.cpu()
    assert batch.data[0].dtype == np.float32
    assert batch.label[0].dtype == np.int32


def test_resize_and_prefetching_iter_match_jax():
    x, y = _data(17)
    out = []
    for io_mod in (jio, tio):
        resized = io_mod.ResizeIter(io_mod.NDArrayIter(x, y, batch_size=4),
                                    size=7)
        pre = io_mod.PrefetchingIter(
            [io_mod.NDArrayIter(x, y, batch_size=4),
             io_mod.NDArrayIter(x * 2, y, batch_size=4)],
            rename_data=[{'data': 'a'}, {'data': 'b'}])
        out.append((_epochs(resized), _epochs(pre),
                    [tuple(d) for d in pre.provide_data]))
        pre.close()
    _assert_same(out[1][0], out[0][0])
    _assert_same(out[1][1], out[0][1])
    assert out[1][2] == out[0][2]


def test_csv_and_mnist_iters_match_jax(tmp_path):
    x, y = _data(10)
    np.savetxt(tmp_path / 'd.csv', x.reshape(10, -1), delimiter=',')
    np.savetxt(tmp_path / 'l.csv', y, delimiter=',')
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (12, 4, 4)).astype(np.uint8)
    labels = rng.randint(0, 10, 12).astype(np.uint8)
    with gzip.open(tmp_path / 'img.gz', 'wb') as f:
        f.write(struct.pack('>IIII', 2051, 12, 4, 4) + images.tobytes())
    with open(tmp_path / 'lab', 'wb') as f:
        f.write(struct.pack('>II', 2049, 12) + labels.tobytes())
    out = []
    for io_mod in (jio, tio):
        csv = io_mod.CSVIter(str(tmp_path / 'd.csv'), (3, 2),
                             label_csv=str(tmp_path / 'l.csv'),
                             batch_size=3)
        mnist = io_mod.MNISTIter(str(tmp_path / 'img.gz'),
                                 str(tmp_path / 'lab'), batch_size=5,
                                 shuffle=True, seed=3, flat=True)
        out.append((_epochs(csv), _epochs(mnist)))
    _assert_same(out[1][0], out[0][0])
    _assert_same(out[1][1], out[0][1])


def test_prefetch_to_device_serves_the_source_and_stops():
    x, y = _data(14)
    src = tio.NDArrayIter(x, y, batch_size=4)
    ref = _epochs(tio.NDArrayIter(x, y, batch_size=4))
    # threads of earlier tests may still be ending: only the iterator's
    # own must be gone after close()
    before = set(threading.enumerate())
    it = tio.prefetch_to_device(src, size=2, device=mx.cpu())
    got = _epochs(it)
    _assert_same(got, ref)
    assert it.batches_served == 8 and it.stall_ms_per_batch() >= 0.0
    # a reset in the middle of an epoch starts it again
    first = it.next()
    it.reset()
    np.testing.assert_array_equal(it.next().data[0].asnumpy(),
                                  first.data[0].asnumpy())
    it.close()
    assert not set(threading.enumerate()) - before
    staged = tio.stage_to_device([x[:2], mx.nd.array(x[:2], ctx=mx.cpu())],
                                 device=mx.cpu())
    for t in staged:
        np.testing.assert_array_equal(t.numpy(), x[:2])


def test_prefetch_to_device_raises_the_source_error():
    class Broken(tio.DataIter):
        provide_data = provide_label = []

        def next(self):
            raise ValueError('broken source')
    it = tio.prefetch_to_device(Broken(4), device=mx.cpu())
    with pytest.raises(ValueError, match='broken source'):
        it.next()
    with pytest.raises(StopIteration):
        it.next()


def test_image_record_iter_raises():
    """ImageRecordIter is ported (tests/test_torch_image.py), and so is
    its native pipeline (tests/test_torch_native.py): use_native=True
    over a record file with no index raises the pipeline's error, where
    no Python pipeline is made in its place."""
    from mxnet_tpu_torch import _core
    with pytest.raises(_core.NativeError, match='cannot open idx'):
        tio.ImageRecordIter(path_imgrec='x.rec', data_shape=(3, 8, 8),
                            batch_size=2, use_native=True, ctx=mx.cpu())


# -- RecordIO --------------------------------------------------------------

def _records():
    rng = np.random.RandomState(4)
    recs = [bytes(rng.randint(0, 256, n).astype(np.uint8))
            for n in (0, 1, 5, 8, 13)]
    packed = [jrec.pack(jrec.IRHeader(0, 3.0, 7, 0), b'img'),
              jrec.pack(jrec.IRHeader(0, [1.0, 2.5], 8, 1), b'xyz')]
    return recs + packed


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_recordio_files_are_byte_equal_and_read_across(writer, tmp_path):
    recs = _records()
    paths = {}
    for name, rec in (('jax', jrec), ('port', trec)):
        rec_path = tmp_path / ('%s.rec' % name)
        idx_path = tmp_path / ('%s.idx' % name)
        w = rec.MXIndexedRecordIO(str(idx_path), str(rec_path), 'w')
        for i, r in enumerate(recs):
            w.write_idx(i, r)
        w.close()
        plain = tmp_path / ('%s_plain.rec' % name)
        pw = rec.MXRecordIO(str(plain), 'w')
        for r in recs:
            pw.write(r)
        pw.close()
        paths[name] = (rec_path, idx_path, plain)
    for a, b in zip(paths['jax'], paths['port']):
        assert a.read_bytes() == b.read_bytes()
    reader = trec if writer == 'jax' else jrec
    rec_path, idx_path, plain = paths[writer]
    r = reader.MXIndexedRecordIO(str(idx_path), str(rec_path), 'r')
    for i in reversed(range(len(recs))):
        assert r.read_idx(i) == recs[i]
    r.close()
    pr = reader.MXRecordIO(str(plain), 'r')
    assert [pr.read() for _ in recs] == recs
    assert pr.read() is None
    pr.close()


def test_pack_unpack_match_jax():
    for header, payload in ((trec.IRHeader(0, 3.0, 7, 0), b'abc'),
                            (trec.IRHeader(0, [1.0, 2.5, -1.0], 9, 2),
                             b'\x00\x01')):
        packed = trec.pack(header, payload)
        assert packed == jrec.pack(jrec.IRHeader(*header), payload)
        (th, tp), (jh, jp) = trec.unpack(packed), jrec.unpack(packed)
        assert tp == jp == payload
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))
        assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)


# -- checkpoints ------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable('data')
    fc = pkg.sym.FullyConnected(data, name='fc1', num_hidden=4)
    return pkg.sym.SoftmaxOutput(fc, name='softmax')


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_checkpoint_files_are_byte_equal_and_read_across(writer, tmp_path):
    rng = np.random.RandomState(9)
    args = {'fc1_weight': rng.randn(4, 3).astype(np.float32),
            'fc1_bias': rng.randn(4).astype(np.float32)}
    auxs = {'bn_moving_var': rng.rand(4).astype(np.float32)}
    for name, pkg, model in (('jax', jmx, jmodel), ('port', mx, tmodel)):
        ctx = pkg.cpu()
        model.save_checkpoint(
            str(tmp_path / name), 3, _mlp(pkg),
            {k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()},
            {k: pkg.nd.array(v, ctx=ctx) for k, v in auxs.items()})
    for suffix in ('-symbol.json', '-0003.params'):
        assert (tmp_path / ('jax' + suffix)).read_bytes() == \
            (tmp_path / ('port' + suffix)).read_bytes()
    if writer == 'jax':
        sym, a, x = tmodel.load_checkpoint(str(tmp_path / 'jax'), 3,
                                           ctx=mx.cpu())
    else:
        sym, a, x = jmodel.load_checkpoint(str(tmp_path / 'port'), 3)
    assert sym.list_arguments() == ['data', 'fc1_weight', 'fc1_bias',
                                    'softmax_label']
    for k, v in args.items():
        np.testing.assert_array_equal(a[k].asnumpy(), v)
    np.testing.assert_array_equal(x['bn_moving_var'].asnumpy(),
                                  auxs['bn_moving_var'])
