"""Gluon data API, the counterpart of mxnet_tpu/gluon/data/ (reference
python/mxnet/gluon/data/)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, \
    RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, \
    BatchSampler
from .dataloader import DataLoader
from . import vision
