"""Fault-injection knobs, the counterpart of the part of
mxnet_tpu/elastic.py that the serving tier reads.

Only `fault_knob` is ported: `serving_fleet.ContinuousEngine.
export_state` reads MXNET_TPU_FAULT_SWAP_DROP_STATE through it. The rest
of the JAX module (async sharded checkpoints, `CheckpointManager`,
`resume`, preemption, the other fault knobs) is ROADMAP Queue A 5: each
of its public names raises `MXNetError` naming that item when it is
reached.
"""
import os

from .base import unported

# the JAX module's public names that wait for Queue A 5
_DEFERRED = frozenset((
    'Preempted', 'dead_hosts', 'heartbeat_drop_ranks', 'barrier_stall_s',
    'ring_stall_s', 'num_dead_node', 'check_barrier', 'write_shard_file',
    'read_shard_file', 'ResumeInfo', 'list_checkpoints', 'list_deltas',
    'load_state', 'load_newest_intact', 'CheckpointManager', 'LrBackoff',
    'fast_forward', 'resume'))


def fault_knob(name, default=None):
    """Raw value of MXNET_TPU_FAULT_<name>, or `default` when unset or
    empty. Read at each use, so that a knob can be flipped mid-process."""
    v = os.environ.get('MXNET_TPU_FAULT_' + name, '')
    return v if v.strip() else default


def __getattr__(name):
    if name in _DEFERRED:
        raise unported('elastic.%s (elastic checkpoints and the '
                       'distributed runtime)' % name, '5')
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
