"""Module API: the counterpart of mxnet_tpu/module/ (reference
python/mxnet/module/)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .executor_group import DataParallelExecutorGroup
