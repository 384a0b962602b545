"""Parallelism over torch.distributed: the counterpart of
mxnet_tpu/parallel.

One process per rank in the default process group; a `Mesh` names axes
over the ranks (`mesh.py`), the collectives run over an axis's group
(`collectives.py`), ring attention shards the sequence (`ring_attention.py`),
the transformer LM trains at dp x tp x sp (`transformer.py`), ZeRO-1
shards the optimizer state over the data axis (`zero.py`), and sparse
embedding tables stripe their rows over it (`embedding.py`). `pipeline`
and `moe` are not ported yet (ROADMAP Queue A 6d): reaching them raises.
"""
from .mesh import (make_mesh, data_sharding, replicated, flat_sharding,
                   shard_batch, replicate_params, current_mesh,
                   set_current_mesh)
from .ring_attention import ring_attention, full_attention
from . import collectives
from . import zero
from . import embedding

_UNPORTED = {'pipeline': '6d', 'moe': '6d'}


def __getattr__(name):
    if name in _UNPORTED:
        from ..base import unported
        raise unported('mxnet_tpu_torch.parallel.%s (item %s)'
                       % (name, _UNPORTED[name]), '6')
    raise AttributeError('module %r has no attribute %r' % (__name__, name))


__all__ = ['make_mesh', 'data_sharding', 'replicated', 'flat_sharding',
           'shard_batch', 'replicate_params', 'current_mesh',
           'set_current_mesh', 'ring_attention', 'full_attention',
           'collectives', 'zero', 'embedding']
