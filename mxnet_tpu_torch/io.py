"""Data iterators: the counterpart of mxnet_tpu/io.py (reference
python/mxnet/io.py).

The layering is the JAX package's: NDArrayIter serves in-memory data,
PrefetchingIter adds a host thread per source, and prefetch_to_device
stages upcoming batches on the card from a host thread, so that the
host copies and the host-to-device copy of batch N+1 overlap the compute
of batch N.

Host-side iterators (NDArrayIter, CSVIter, MNISTIter) make their
batches on cpu(0), as the JAX package's do; the executor group commits
each batch to its device. `stage_to_device` copies a CPU batch into
pinned host memory, then to the card with a non-blocking copy on a side
CUDA stream, and records an event there; the iterator makes the
consumer's stream wait on that event when it hands the batch out, and
`record_stream` tells the caching allocator that the consumer's stream
reads the staged tensor, so its memory is not reused for a later batch
before the step that reads it has run.

ImageRecordIter layers the port's image.ImageIter under a
PrefetchingIter, as the JAX package's Python pipeline does: decode
workers under a batch-prefetch thread, its batches made on the
iterator's context (nvJPEG and the card on a GPU context). With
`use_native=True` it runs the port's native C++ pipeline instead
(`csrc/native/image_record_iter.cc`: a reader thread and a pool of
OpenCV decode workers filling host float32 batches), whose batches go
through pinned memory to the iterator's context.
"""
import atexit
import ctypes
import os
import weakref
import queue
import threading
import time
from collections import namedtuple, OrderedDict
from itertools import chain

import numpy as np
import torch

from . import ndarray as nd
from . import profiler
from .context import Context, cpu
from .ndarray import NDArray

DataDesc = namedtuple('DataDesc', ['name', 'shape', 'dtype', 'layout'])
DataDesc.__new__.__defaults__ = (np.float32, 'NCHW')


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data, self.label = data, label
        self.pad, self.index = pad, index
        self.bucket_key = bucket_key
        self.provide_data, self.provide_label = provide_data, provide_label


def _batch_field(field):
    """Getter for one field of the staged batch (get<field>())."""
    def getter(self):
        return getattr(self.current_batch, field)
    getter.__name__ = 'get' + field
    return getter


class _StagedBatchMixin:
    """Iterators that stage whole DataBatches expose the batch's fields."""
    getdata = _batch_field('data')
    getlabel = _batch_field('label')
    getindex = _batch_field('index')
    getpad = _batch_field('pad')


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input data as a list of (name, numpy array)."""
    assert (data is not None) or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict(
                [('_%d_%s' % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError('Input must be NDArray, numpy.ndarray, a list of '
                        'them or dict with them as values')
    out = OrderedDict()
    for k, v in data.items():
        out[k] = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
    return list(out.items())


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays with shuffle, pad, discard and
    roll_over; shuffles with numpy's global generator, as the JAX package
    does, so a seeded order is the same in both."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = np.arange(self.num_data)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == 'discard':
            self.num_data = self.num_data - self.num_data % batch_size
        assert self.num_data >= batch_size, \
            'batch_size needs to be smaller than data size.'
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        offset = 0
        if self.last_batch_handle == 'roll_over' and \
                self.cursor > self.num_data:
            # the partial batch's offset carries into the new epoch
            offset = (self.cursor % self.num_data) % self.batch_size
        self.cursor = offset - self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _overrun(self):
        """How far the current batch runs past the end of the data."""
        return max(0, self.cursor + self.batch_size - self.num_data)

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, 'DataIter needs reset.'
        overrun = self._overrun()
        sel = self.idx[self.cursor:self.cursor + self.batch_size]
        if overrun:
            # wrap around: pad with rows from the start of the epoch
            sel = np.concatenate([sel, self.idx[:overrun]])
        # one host copy: the gathered rows become the tensor's storage
        # (float64 and int64 narrowed, as nd.array narrows them)
        return [NDArray(torch.from_numpy(
            arr[sel].astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)),
            cpu()) for _, arr in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == 'pad':
            return self._overrun()
        return 0


class ResizeIter(_StagedBatchMixin, DataIter):
    """Exactly `size` batches an epoch: a short source cycles (rewound
    when it runs dry), a long one is cut."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = int(size)
        self.reset_internal = reset_internal
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.current_batch = None
        self._remaining = self.size

    def reset(self):
        self._remaining = self.size
        if self.reset_internal:
            self.data_iter.reset()

    def _pull_cycling(self):
        """One batch from the source, rewinding it once if exhausted."""
        for attempt in range(2):
            try:
                return self.data_iter.next()
            except StopIteration:
                if attempt:
                    raise
                self.data_iter.reset()
        raise StopIteration

    def iter_next(self):
        if self._remaining <= 0:
            return False
        self.current_batch = self._pull_cycling()
        self._remaining -= 1
        return True


def _prefetch_worker(src, slot, next_batch, taken, ready, alive,
                     ctx=None):
    """PrefetchingIter's worker: refill `slot` whenever the consumer
    takes it, with the next batch, None at the end or the exception
    that `src` raised. It holds only the shared cells, never the
    iterator, so the iterator can be collected while workers run. `ctx`
    is the default context of the thread that made it, as in
    `_stage_worker`."""
    if ctx is not None:
        with Context(ctx):
            return _prefetch_worker(src, slot, next_batch, taken, ready,
                                    alive)
    while True:
        taken.wait()
        if not alive[0]:
            return
        try:
            fetched = src.next()
        except StopIteration:
            fetched = None
        except Exception as e:      # handed to the consumer, raised there
            fetched = e
        next_batch[slot] = fetched
        taken.clear()
        ready.set()


class PrefetchingIter(_StagedBatchMixin, DataIter):
    """A host thread per source iterator, each behind a pair of event
    gates (ready, taken); iter_next zips the sources' batches."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        self.n_iter = len(self.iters)
        assert self.n_iter > 0
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.started = True
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for gate in self.data_taken:
            gate.set()
        # a shared cell, so that the workers never reference `self`
        self._alive = [True]
        self.prefetch_threads = []
        for i in range(self.n_iter):
            worker = threading.Thread(
                target=_prefetch_worker,
                args=(self.iters[i], i, self.next_batch,
                      self.data_taken[i], self.data_ready[i],
                      self._alive,
                      getattr(Context._default_ctx, 'value', None)),
                daemon=True)
            self.prefetch_threads.append(worker)
            worker.start()

    def close(self):
        """Stop and join the workers (idempotent). The gate is set again
        while joining: a worker in the middle of a fetch clears it."""
        self._alive[0] = False
        self.started = False
        deadline = time.time() + 5
        remaining = []
        for worker in self.prefetch_threads:
            while worker.is_alive() and time.time() < deadline:
                for gate in self.data_taken:
                    gate.set()
                worker.join(timeout=0.05)
            if worker.is_alive():
                remaining.append(worker)
        self.prefetch_threads = remaining

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: attributes may be gone
            pass

    def _merged_desc(self, attr, renames):
        per_iter = [getattr(it, attr) for it in self.iters]
        if renames is None:
            return list(chain.from_iterable(per_iter))
        out = []
        for mapping, descs in zip(renames, per_iter):
            for d in descs:
                d = d if isinstance(d, DataDesc) else DataDesc(*d)
                out.append(DataDesc(mapping[d.name], d.shape, d.dtype))
        return out

    @property
    def provide_data(self):
        return self._merged_desc('provide_data', self.rename_data)

    @property
    def provide_label(self):
        return self._merged_desc('provide_label', self.rename_label)

    def reset(self):
        for gate in self.data_ready:
            gate.wait()
        for it in self.iters:
            it.reset()
        for gate in self.data_ready:
            gate.clear()
        for gate in self.data_taken:
            gate.set()

    def iter_next(self):
        for gate in self.data_ready:
            gate.wait()
        staged = self.next_batch
        for b in staged:
            if isinstance(b, Exception):
                raise b
        if staged[0] is None:
            assert all(b is None for b in staged), \
                'Number of entry mismatches between iterators'
            return False
        pad = staged[0].pad
        assert all(b.pad == pad for b in staged), \
            'Different pad between iterators'
        self.current_batch = DataBatch(
            list(chain.from_iterable(b.data for b in staged)),
            list(chain.from_iterable(b.label for b in staged)),
            pad, staged[0].index)
        for gate in self.data_ready:
            gate.clear()
        for gate in self.data_taken:
            gate.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


def _device_of(device):
    if isinstance(device, Context):
        return device.torch_device
    return torch.device(device) if device is not None else None


class _Staged:
    """The tensors of one staged batch part and the event after their
    copies (None when no copy was asynchronous)."""
    __slots__ = ('tensors', 'event')

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event

    def take(self):
        """The tensors, safe to read on the current stream: it waits for
        the copies, and each tensor is marked as used by it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.event.device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
            self.event = None
        return self.tensors


def _mesh_rows(mesh, a):
    """This data rank's rows of a batch array (its first dimension split
    over the mesh's data axis), cut where it lies."""
    n = mesh.shape.get('data', 1)
    if n <= 1:
        return a
    b = a.shape[0]
    if b % n:
        raise ValueError('a batch of %d rows does not split over %d data '
                         'ranks' % (b, n))
    lo = mesh.axis_index('data') * (b // n)
    if isinstance(a, NDArray):
        a = a._data
    return a[lo:lo + b // n]


def stage(arrays, device=None, stream=None, mesh=None):
    """Start the copies of `arrays` (NDArrays, tensors or numpy arrays) to
    `device`: a _Staged whose take() gives the tensors there. A CPU
    source headed for a CUDA device goes through pinned memory and a
    non-blocking copy on `stream` (a side stream), and an event is
    recorded after the copies; other sources are placed synchronously.
    With `mesh`, only this data rank's rows of each array are copied."""
    device = _device_of(device)
    if mesh is not None:
        arrays = [_mesh_rows(mesh, a) for a in arrays]
    srcs = []
    for a in arrays:
        if isinstance(a, NDArray):
            srcs.append(a._data.detach())
        elif isinstance(a, torch.Tensor):
            srcs.append(a.detach())
        else:
            srcs.append(torch.from_numpy(np.array(a, copy=True)))
    if device is None or device.type != 'cuda':
        return _Staged([s if device is None else s.to(device)
                        for s in srcs], None)
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        out = [s.pin_memory().to(device, non_blocking=True)
               if s.device.type == 'cpu' else s.to(device) for s in srcs]
        event = torch.cuda.Event()
        event.record(stream)
    return _Staged(out, event)


def stage_to_device(arrays, device=None, mesh=None, stream=None):
    """The tensors of `arrays` on `device`, ready to read on the current
    stream (the copy itself went through pinned memory on `stream`).
    With `mesh` (a data mesh), this rank's rows of each array on the
    mesh's device (`device` defaults to it): each rank moves 1/N of the
    batch's bytes."""
    if mesh is not None and device is None:
        device = mesh.device
    return stage(arrays, device, stream, mesh).take()


def _stage_worker(src, out, stop, device, stream, mesh=None, ctx=None):
    """PrefetchToDeviceIter's worker: pull batches from `src` and start
    their copies until `stop` is set, handing (batch, staged data,
    staged label) to `out`, then None at the end of the epoch (or the
    exception that ended it). It holds only the shared cells, never the
    iterator. `ctx`, the default context of the thread that started it,
    is this thread's too, so `src` makes its arrays where its caller's
    thread would."""
    if ctx is not None:
        with Context(ctx):
            return _stage_worker(src, out, stop, device, stream, mesh)

    def put(item):
        while not stop.is_set():
            try:
                out.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    while not stop.is_set():
        try:
            batch = src.next()
        except StopIteration:
            put(None)
            return
        except Exception as e:      # handed to the consumer, raised there
            put(e)
            return
        item = (batch, stage(batch.data, device, stream, mesh),
                stage(batch.label or [], device, stream, mesh))
        if not put(item):
            return


class PrefetchToDeviceIter(_StagedBatchMixin, DataIter):
    """Keeps up to `size` upcoming batches staged on `device` (see
    `stage`): a host thread pulls each batch from `data_iter`, copies it
    into pinned memory and starts its copy to the card on a side stream,
    so the host copies and the transfer of batch N+1 overlap step N. A
    served batch carries NDArrays on the device, safe to read on the
    consumer's stream, which the executor group takes without another
    copy.

    With `mesh` (a data mesh) only this rank's rows of each batch are
    staged, on the mesh's device unless `device` is given: each rank
    moves 1/N of the bytes, and the executor group binds the rows as
    they are (module/executor_group.py).

    input_stall_ms adds up the host time spent in next(): the time the
    loop waited for input."""

    def __init__(self, data_iter, size=2, device=None, mesh=None):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = max(1, int(size))
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = _device_of(device)
        self.ctx = Context.from_device(self.device) \
            if self.device is not None else None
        self._stream = torch.cuda.Stream(self.device) \
            if self.device is not None and self.device.type == 'cuda' \
            else None
        self._worker = None
        self._queue = None
        self._stop = None
        self._exhausted = False
        self.current_batch = None
        self.input_stall_ms = 0.0
        self.batches_served = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def _start(self):
        self._queue = queue.Queue(maxsize=self.size)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=_stage_worker,
            args=(self.data_iter, self._queue, self._stop, self.device,
                  self._stream, self.mesh,
                  getattr(Context._default_ctx, 'value', None)),
            daemon=True)
        self._worker.start()

    def close(self):
        """Stop and join the worker (idempotent); staged batches are
        dropped."""
        worker, self._worker = self._worker, None
        if worker is None:
            return
        self._stop.set()
        worker.join(timeout=60)
        if worker.is_alive():
            raise RuntimeError('the staging thread did not stop')

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: attributes may be gone
            pass

    def reset(self):
        self.close()
        self.data_iter.reset()
        self._exhausted = False

    def _served(self, staged, like):
        if not like:
            return like
        return [NDArray(t, self.ctx) for t in staged.take()]

    def iter_next(self):
        if self._exhausted:
            self.current_batch = None
            return False
        t0 = time.perf_counter()
        if self._worker is None:
            self._start()
        item = self._queue.get()
        if item is None or isinstance(item, Exception):
            self._exhausted = True
            self.close()
            self.current_batch = None
            if item is not None:
                raise item
            return False
        batch, data, label = item
        self.current_batch = DataBatch(
            self._served(data, batch.data), self._served(label, batch.label),
            pad=batch.pad, index=batch.index, bucket_key=batch.bucket_key,
            provide_data=batch.provide_data,
            provide_label=batch.provide_label)
        stall_ms = (time.perf_counter() - t0) * 1e3
        self.input_stall_ms += stall_ms
        self.batches_served += 1
        profiler.add_input_stats(stall_ms=stall_ms, batches=1)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def stall_ms_per_batch(self):
        """Mean host time blocked in next() per served batch."""
        if not self.batches_served:
            return 0.0
        return self.input_stall_ms / self.batches_served


def prefetch_to_device(data_iter, size=2, device=None, mesh=None):
    """`data_iter` with its upcoming batches staged on `device` (see
    PrefetchToDeviceIter); size 2 keeps one batch in use and one in
    flight."""
    return PrefetchToDeviceIter(data_iter, size=size, device=device,
                                mesh=mesh)


class CSVIter(DataIter):
    """CSV file iterator (reference src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=',', dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=',', dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle='pad' if round_batch else 'discard',
            label_name='label')

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


_NATIVE_ITERS = weakref.WeakSet()   # native iterators to close at exit


class _NativeImageRecordIter(DataIter):
    """The native threaded decode pipeline (csrc/native/
    image_record_iter.cc): a reader thread, a pool of OpenCV decode
    workers and a bounded queue of host float32 batches, after the
    reference's iter_image_recordio_2.cc. Each batch is copied out of the
    pipeline's buffer: through pinned memory to the card on a GPU `ctx`,
    into a fresh host tensor on the CPU. The pipeline's threads are
    joined at close() and at interpreter exit."""

    def __init__(self, path_imgrec, idx_path, data_shape, batch_size,
                 label_width, shuffle, rand_crop, rand_mirror, resize,
                 mean, std, num_parts, part_index, preprocess_threads,
                 prefetch_buffer, seed, data_name, label_name, ctx=None):
        from . import _core
        super().__init__(batch_size)
        self._core = _core
        lib = _core.image_lib()
        self._lib = lib
        from .image.image import _ctx_of
        self._ctx = _ctx_of(ctx)
        self._shape = tuple(data_shape)
        self._label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        c3 = (ctypes.c_float * 3)
        mean_arr = c3(*([float(m) for m in mean] if mean is not None
                        else [0., 0., 0.]))
        std_arr = c3(*([float(v) for v in std] if std is not None
                       else [1., 1., 1.]))
        self._handle = lib.MXTImageRecordIterCreate(
            path_imgrec.encode(), idx_path.encode(), batch_size,
            self._shape[0], self._shape[1], self._shape[2], label_width,
            int(shuffle), int(rand_crop), int(rand_mirror), int(resize),
            mean_arr, std_arr, num_parts, part_index,
            preprocess_threads, prefetch_buffer, seed)
        if not self._handle:
            raise _core.NativeError(lib.MXTGetLastError().decode())
        _NATIVE_ITERS.add(self)

    def close(self):
        """Join the pipeline's threads and free it (idempotent)."""
        handle, self._handle = getattr(self, '_handle', None), None
        if handle:
            self._lib.MXTImageRecordIterFree(handle)

    def __del__(self):
        self.close()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shape)]

    def _live(self):
        if not self._handle:
            raise RuntimeError('the iterator is closed')
        return self._handle

    def reset(self):
        self._core.check_call(
            self._lib.MXTImageRecordIterReset(self._live()), self._lib)

    def next(self):
        data_p = ctypes.POINTER(ctypes.c_float)()
        label_p = ctypes.POINTER(ctypes.c_float)()
        pad = ctypes.c_int()
        ret = self._lib.MXTImageRecordIterNext(
            self._live(), ctypes.byref(data_p), ctypes.byref(label_p),
            ctypes.byref(pad))
        if ret < 0:
            raise self._core.NativeError(
                self._lib.MXTGetLastError().decode())
        if ret == 0:
            raise StopIteration
        n = self.batch_size
        lshape = (n, self._label_width) if self._label_width > 1 \
            else (n,)
        # views of the pipeline's buffer, valid until the next call
        data = torch.from_numpy(np.ctypeslib.as_array(
            data_p, shape=(n,) + self._shape))
        label = torch.from_numpy(np.ctypeslib.as_array(
            label_p, shape=(n * self._label_width,))).reshape(lshape)
        device = self._ctx.torch_device
        if device.type == 'cuda':
            data, label = stage([data, label], device).take()
        else:
            data, label = data.clone(), label.clone()
        return DataBatch(data=[NDArray(data, self._ctx)],
                         label=[NDArray(label, self._ctx)],
                         pad=pad.value, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


@atexit.register
def _close_native_iters():
    for it in list(_NATIVE_ITERS):
        it.close()


class ImageRecordIter(DataIter):
    """RecordIO image iterator with augmentation and prefetch (reference
    src/io/iter_image_recordio_2.cc): image.ImageIter, its decode pool
    of preprocess_threads workers, under a PrefetchingIter; mean_r/g/b
    and std_r/g/b normalise, mean_img (a saved NDArray, CHW or HWC)
    subtracts a mean image, resize resizes the shorter side first,
    num_parts / part_index shard. The batches are made on `ctx` (the
    current context when None: gpu(0) unless the caller is in
    `with mx.cpu():`).

    use_native=True runs the port's native C++ pipeline over the
    record file and its `.idx` (`_NativeImageRecordIter`, seeded by
    `seed`, no mean_img), and raises if its library cannot be built (it
    needs OpenCV 4's C++ headers and libraries). None and False keep the pipeline above: nvJPEG on the
    workers' streams on a GPU context. (In the JAX package None means
    the native pipeline whenever it is built and an `.idx` exists.)"""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_width=1, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_img=None,
                 mean_r=0, mean_g=0, mean_b=0,
                 std_r=0, std_g=0, std_b=0,
                 resize=0, num_parts=1, part_index=0,
                 preprocess_threads=4, prefetch_buffer=4,
                 seed=0, use_native=None,
                 data_name='data', label_name='softmax_label', ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        if use_native:
            if mean_img is not None:
                raise ValueError('mean_img needs the Python pipeline '
                                 '(use_native=False)')
            mean = [mean_r, mean_g, mean_b] \
                if (mean_r or mean_g or mean_b) else None
            std = [std_r, std_g, std_b] if (std_r or std_g or std_b) \
                else None
            self._inner = _NativeImageRecordIter(
                path_imgrec, os.path.splitext(path_imgrec)[0] + '.idx',
                tuple(data_shape), batch_size, label_width, shuffle,
                rand_crop, rand_mirror, resize, mean, std, num_parts,
                part_index, preprocess_threads, prefetch_buffer, seed,
                data_name, label_name, ctx)
            return
        from .image import image as img_mod
        mean = std = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b], np.float32)
        if std_r or std_g or std_b:
            std = np.array([std_r, std_g, std_b], np.float32)
        aug_list = img_mod.CreateAugmenter(
            tuple(data_shape), resize=resize, rand_crop=rand_crop,
            rand_mirror=rand_mirror, mean=mean, std=std)
        if mean_img is not None:
            if not isinstance(mean_img, str):
                raise ValueError('mean_img must be a path to a saved '
                                 'NDArray mean image')
            loaded = nd.load(mean_img, ctx=cpu())
            marr = (list(loaded.values())[0] if isinstance(loaded, dict)
                    else loaded[0]).asnumpy().astype(np.float32)
            if marr.ndim == 3 and marr.shape[0] in (1, 3):
                marr = marr.transpose(1, 2, 0)  # CHW -> HWC
            aug_list.append(_MeanImageAug(marr))
        self._inner = PrefetchingIter(img_mod.ImageIter(
            batch_size=batch_size, data_shape=tuple(data_shape),
            label_width=label_width, path_imgrec=path_imgrec,
            shuffle=shuffle, part_index=part_index, num_parts=num_parts,
            aug_list=aug_list, preprocess_threads=preprocess_threads,
            data_name=data_name, label_name=label_name, ctx=ctx))

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def close(self):
        """Join the prefetch thread and the decode workers (idempotent)."""
        self._inner.close()
        if isinstance(self._inner, PrefetchingIter):
            self._inner.iters[0].close()


class _MeanImageAug:
    """Subtract a mean image (reference iter_normalize.h), in float32 on
    the image's device."""

    def __init__(self, mean):
        self.mean = mean

    def __call__(self, src):
        from .image.image import _t, _like, _vec
        img = _t(src).to(torch.float32)
        return [_like(img - _vec(self.mean, img), src)]


class MNISTIter(DataIter):
    """MNIST idx-file iterator (reference src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=False, num_parts=1,
                 part_index=0, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct

        def _open(path):
            return gzip.open(path, 'rb') if path.endswith('.gz') \
                else open(path, 'rb')
        with _open(label) as fin:
            struct.unpack('>II', fin.read(8))
            lab = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.float32)
        with _open(image) as fin:
            _, n, r, c = struct.unpack('>IIII', fin.read(16))
            img = np.frombuffer(fin.read(), dtype=np.uint8) \
                .reshape(n, r, c).astype(np.float32) / 255.0
        if num_parts > 1:
            part = n // num_parts
            img = img[part_index * part:(part_index + 1) * part]
            lab = lab[part_index * part:(part_index + 1) * part]
        if shuffle:
            perm = np.random.RandomState(seed).permutation(len(img))
            img, lab = img[perm], lab[perm]
        data = img.reshape(len(img), -1) if flat \
            else img[:, None, :, :]
        self._inner = NDArrayIter(data, lab, batch_size,
                                  last_batch_handle='discard')

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()
