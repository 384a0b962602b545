"""DataLoader, the counterpart of mxnet_tpu/gluon/data/dataloader.py
(reference python/mxnet/gluon/data/dataloader.py).

The reference feeds pickled batches from worker processes; here, as in
the JAX package, num_workers > 0 makes batches on a thread pool, which
overlaps the host's work with the device's (CUDA launches are
asynchronous) and forks nothing. The workers make their arrays on the
context the iterating thread has made current (`with mx.cpu():`), else
on the default, gpu(0).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import ndarray as nd
from ...context import Context
from .sampler import SequentialSampler, RandomSampler, BatchSampler


def default_batchify_fn(data):
    """Stack samples into a batch."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class DataLoader(object):
    """Loads a Dataset and returns mini-batches."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    'batch_size must be specified unless batch_sampler '
                    'is specified')
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    'shuffle must not be specified if sampler is '
                    'specified')
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                'batch_size, shuffle, sampler and last_batch must not '
                'be specified if batch_sampler is specified.')
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers

    def __iter__(self):
        if self._num_workers <= 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn(
                    [self._dataset[i] for i in batch])
            return
        # bounded in-flight window for backpressure (the reference's
        # prefetch queue depth); workers stay busy but finished batches
        # don't pile up when the consumer is slower
        current = getattr(Context._default_ctx, 'value', None)

        def make(b):
            if current is None:
                return self._batchify_fn([self._dataset[i] for i in b])
            with Context(current):
                return self._batchify_fn([self._dataset[i] for i in b])

        window = 2 * self._num_workers
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            pending = []
            for batch in self._batch_sampler:
                pending.append(pool.submit(make, batch))
                if len(pending) >= window:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)
