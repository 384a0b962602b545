"""Module API: the counterpart of mxnet_tpu/module/ (reference
python/mxnet/module/). BucketingModule is not ported yet."""
from ..base import unported
from .base_module import BaseModule
from .module import Module
from .sequential_module import SequentialModule
from .executor_group import DataParallelExecutorGroup


class BucketingModule(BaseModule):
    """Not ported yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise unported('BucketingModule', '1b')
