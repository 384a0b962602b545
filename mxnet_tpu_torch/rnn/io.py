"""Bucketed sequence iterators (`mx.rnn.BucketSentenceIter`): the
counterpart of mxnet_tpu/rnn/io.py (reference python/mxnet/rnn/io.py).

Sentences are binned into fixed-length buckets, so that each bucket is
one graph shape of BucketingModule. The shuffles are the JAX package's
draws: the batch order from Python's `random`, the rows of each bucket
from numpy's global generator, so one seed of each gives the JAX
package's batches in its order. Batches are made on cpu(0), as the
port's other host-side iterators make theirs; the executor group
commits each to its device.
"""
import random

import numpy as np

from ..io import DataIter, DataBatch, DataDesc


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key='\n', start_label=0):
    """Encode sentences (lists of tokens) into lists of int ids, building
    `vocab` on the fly (reference rnn/io.py encode_sentences)."""
    growing = vocab is None
    if growing:
        vocab = {invalid_key: invalid_label}
    next_id = [start_label]

    def intern(word):
        if word not in vocab:
            assert growing, 'Unknown token %s' % word
            if next_id[0] == invalid_label:
                next_id[0] += 1
            vocab[word] = next_id[0]
            next_id[0] += 1
        return vocab[word]

    return [[intern(w) for w in sent] for sent in sentences], vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over encoded sentences for language modeling.

    Each batch has `bucket_key` = sequence length; the label is the data
    shifted left by one (next-token prediction), padded with
    `invalid_label` (reference rnn/io.py BucketSentenceIter).
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name='data',
                 label_name='softmax_label', dtype='float32', layout='NT',
                 bucket_major=False):
        """bucket_major=True orders each epoch bucket-by-bucket
        (random bucket order, shuffled batches within each bucket)
        instead of fully interleaved: consecutive batches then share a
        bucket key, so BucketingModule's fit(bulk=K) can group them
        into one K-step dispatch. The epoch still covers exactly the
        same batches."""
        super(BucketSentenceIter, self).__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets must keep 2-D shape (0, bucket_len) for reset()
        self.data = [np.asarray(i, dtype=dtype).reshape(-1, blen)
                     for i, blen in zip(self.data, buckets)]
        if ndiscard:
            print('WARNING: discarded %d sentences longer than the '
                  'largest bucket.' % ndiscard)

        self.batch_size, self.buckets = batch_size, buckets
        self.data_name, self.label_name = data_name, label_name
        self.dtype, self.invalid_label = dtype, invalid_label
        self.nddata, self.ndlabel = [], []
        self.layout = layout
        self.major_axis = layout.find('N')
        self.default_bucket_key = max(buckets)

        if self.major_axis not in (0, 1):
            raise ValueError('Invalid layout %s: Must by NT (batch major) '
                             'or TN (time major)' % layout)
        widest = ((batch_size, self.default_bucket_key)
                  if self.major_axis == 0
                  else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, widest, layout=layout)]
        self.provide_label = [DataDesc(label_name, widest, layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.bucket_major = bucket_major
        self.curr_idx = 0
        self.reset()

    def reset(self):
        from .. import ndarray
        from ..context import cpu
        self.curr_idx = 0
        if self.bucket_major:
            # same batches, bucket-contiguous order: shuffle the bucket
            # order and the batches within each bucket, then emit
            # bucket-by-bucket (consecutive same-key batches fuse into
            # one bulk dispatch downstream)
            groups = {}
            for pair in self.idx:
                groups.setdefault(pair[0], []).append(pair)
            order = list(groups)
            random.shuffle(order)
            self.idx = []
            for i in order:
                random.shuffle(groups[i])
                self.idx.extend(groups[i])
        else:
            random.shuffle(self.idx)
        self.nddata, self.ndlabel = [], []
        for buck in self.data:
            np.random.shuffle(buck)
            # Next-token target: shift one step left, pad the final column.
            shifted = np.roll(buck, -1, axis=1)
            shifted[:, -1] = self.invalid_label
            self.nddata.append(ndarray.array(buck, ctx=cpu(),
                                             dtype=self.dtype))
            self.ndlabel.append(ndarray.array(shifted, ctx=cpu(),
                                              dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1

        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]

        return DataBatch(
            [data], [label], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
