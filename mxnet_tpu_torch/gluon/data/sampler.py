"""Index samplers for Gluon data loading, the counterpart of
mxnet_tpu/gluon/data/sampler.py (reference
python/mxnet/gluon/data/sampler.py)."""
import random


class Sampler(object):
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """Yields 0..length-1 in order."""

    def __init__(self, length):
        self._span = range(length)

    def __iter__(self):
        return iter(self._span)

    def __len__(self):
        return len(self._span)


class RandomSampler(Sampler):
    """Yields a fresh random permutation of 0..length-1 each epoch."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        order = list(range(self._length))
        random.shuffle(order)
        return iter(order)

    def __len__(self):
        return self._length


_LAST_BATCH_MODES = ('keep', 'discard', 'rollover')


class BatchSampler(Sampler):
    """Chunk a sampler's index stream into batch-sized lists.

    ``last_batch`` controls the trailing partial batch: 'keep' emits it,
    'discard' drops it, 'rollover' carries it into the next epoch's first
    batch.  (Role of reference gluon BatchSampler.)
    """

    def __init__(self, sampler, batch_size, last_batch='keep'):
        if last_batch not in _LAST_BATCH_MODES:
            raise ValueError(
                'last_batch must be one of %s, but got %s'
                % (_LAST_BATCH_MODES, last_batch))
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._carry = []

    def __iter__(self):
        pending = self._carry
        self._carry = []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) >= self._batch_size:
                yield pending
                pending = []
        if not pending:
            return
        if self._last_batch == 'keep':
            yield pending
        elif self._last_batch == 'rollover':
            self._carry = pending
        # 'discard': trailing indices are simply dropped

    def __len__(self):
        full, extra = divmod(len(self._sampler), self._batch_size)
        if self._last_batch == 'keep':
            return full + (1 if extra else 0)
        if self._last_batch == 'discard':
            return full
        # rollover: carried indices from last epoch join this epoch's stream
        return (len(self._carry) + len(self._sampler)) // self._batch_size
