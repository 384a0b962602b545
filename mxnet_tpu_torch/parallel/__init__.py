"""Parallelism over torch.distributed: the counterpart of
mxnet_tpu/parallel.

One process per rank in the default process group; a `Mesh` names axes
over the ranks (`mesh.py`), the collectives run over an axis's group
(`collectives.py`), ring attention shards the sequence (`ring_attention.py`),
the transformer LM trains at dp x tp x sp (`transformer.py`), ZeRO-1
shards the optimizer state over the data axis (`zero.py`), sparse
embedding tables stripe their rows over it (`embedding.py`), the GPipe
engine trains stages over a 'pipe' axis (`pipeline.py`), and switch-routed
experts run over an 'expert' axis (`moe.py`).
"""
from .mesh import (make_mesh, data_sharding, replicated, flat_sharding,
                   shard_batch, replicate_params, current_mesh,
                   set_current_mesh)
from .ring_attention import ring_attention, full_attention
from . import collectives
from . import zero
from . import embedding
from . import pipeline
from . import moe

__all__ = ['make_mesh', 'data_sharding', 'replicated', 'flat_sharding',
           'shard_batch', 'replicate_params', 'current_mesh',
           'set_current_mesh', 'ring_attention', 'full_attention',
           'collectives', 'zero', 'embedding', 'pipeline', 'moe']
