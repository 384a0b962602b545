"""Profiler: spans of the framework's dispatch units written as a Chrome
trace, the counterpart of the core of mxnet_tpu/profiler.py (reference
src/engine/profiler.{h,cc}, python/mxnet/profiler.py).

The recorded spans are the executor's forward, backward and
forward_backward (the device synchronised inside the span, so that a
duration is the work's and not its enqueue's), the imperative ops under
mode='all', and any user `profiler.scope`. `profiler_set_config(
profile_xla=True)` also runs `torch.profiler` while the profiler runs,
and `dump_profile` merges its lanes (CUDA kernels, or the host's torch
ops on a CPU-only run) at pids 100 and up, where the JAX package merges
its XLA trace's device lanes.

MXNET_PROFILER_AUTOSTART=1 starts it at import, as in the reference.
The per-subsystem counters come with the subsystems they count: the
program cache's (exec_cache), the serving engine's, the quantization,
the serving fleet's (registry, HTTP front, continuous batcher), the
self-healing fleet's (supervisor, router, canary), the train -> serve
loop's, the hot-swap and host-hiding counters, the bucketed-training
and the input pipeline's counters, the elastic checkpoints', the dist
runtime's, the weight deltas', the mesh collectives', the fused Gluon
step's, the pipeline's, the mixture of experts' and the sparse
embedding tier's; `summary()` prints them, and `dump_profile` writes
each as a metadata event ('exec_cache', 'serving', 'fleet', 'quant',
'fleet_supervisor', 'loop', 'overlap', 'bucketing', 'input_pipeline',
'checkpoint', 'dist', 'delta', 'mesh', 'comm', 'gluon_fused',
'pipeline', 'moe', 'embed'). The fused Gluon step's spans have the
category 'gluon_fused'.
"""
import json
import os
import threading
import time

import numpy as np

_STATE = {
    'mode': 'symbolic',        # 'symbolic' | 'all'
    'filename': 'profile.json',
    'running': False,
    'records': [],             # (name, category, ts_us, dur_us, tid)
    'lock': threading.Lock(),
    'device_trace': False,
    'device_trace_dir': None,
    'torch_profile': None,     # the running torch.profiler.profile
    'device_events': [],       # its lanes, once stopped
}


# serving-engine counters (serving.InferenceEngine's dynamic batcher):
# coalesced dispatches, batch fill and pad waste, batcher queue depth
# observations, and a bounded ring of request latencies for p50/p99
_SERVING = {
    'serve_requests': 0,
    'serve_batches': 0,
    'serve_rows': 0,
    'serve_padded_rows': 0,
    'serve_fill_sum': 0.0,
    'serve_pad_elem_frac_sum': 0.0,
    'serve_queue_depth_sum': 0,
    'serve_queue_depth_obs': 0,
}
_SERVE_LAT_CAP = 8192
_SERVE_LAT = []                 # ring buffer of request latencies (ms)
_SERVE_LAT_POS = [0]


def add_serving_stats(requests=0, batches=0, rows=0, padded_rows=0,
                      fill=None, pad_elem_frac=None, queue_depth=None,
                      latencies_ms=()):
    """Accumulate serving counters (the engine's completion thread
    feeds one call per coalesced dispatch)."""
    with _STATE['lock']:
        _SERVING['serve_requests'] += requests
        _SERVING['serve_batches'] += batches
        _SERVING['serve_rows'] += rows
        _SERVING['serve_padded_rows'] += padded_rows
        if fill is not None:
            _SERVING['serve_fill_sum'] += float(fill)
        if pad_elem_frac is not None:
            _SERVING['serve_pad_elem_frac_sum'] += float(pad_elem_frac)
        if queue_depth is not None:
            _SERVING['serve_queue_depth_sum'] += int(queue_depth)
            _SERVING['serve_queue_depth_obs'] += 1
        for lat in latencies_ms:
            if len(_SERVE_LAT) < _SERVE_LAT_CAP:
                _SERVE_LAT.append(float(lat))
            else:   # overwrite the oldest: percentiles track recent traffic
                _SERVE_LAT[_SERVE_LAT_POS[0]] = float(lat)
                _SERVE_LAT_POS[0] = (_SERVE_LAT_POS[0] + 1) \
                    % _SERVE_LAT_CAP


def serving_stats():
    """Snapshot of the serving counters with derived means and the
    request latency percentiles (serve_latency_p50_ms / p99; 0.0 when no
    request was served)."""
    with _STATE['lock']:
        out = dict(_SERVING)
        lats = list(_SERVE_LAT)
    fill, pad = out.pop('serve_fill_sum'), out.pop('serve_pad_elem_frac_sum')
    nb = out['serve_batches']
    out['serve_batch_fill_avg'] = fill / nb if nb else 0.0
    out['serve_pad_elem_frac_avg'] = pad / nb if nb else 0.0
    qs = out.pop('serve_queue_depth_sum')
    qo = out.pop('serve_queue_depth_obs')
    out['serve_queue_depth_avg'] = qs / qo if qo else 0.0
    total = out['serve_rows'] + out['serve_padded_rows']
    out['serve_pad_waste_frac'] = \
        out['serve_padded_rows'] / total if total else 0.0
    out['serve_latency_p50_ms'] = \
        float(np.percentile(lats, 50)) if lats else 0.0
    out['serve_latency_p99_ms'] = \
        float(np.percentile(lats, 99)) if lats else 0.0
    return out


# low-precision counters. Gauges (set, not added): quant_models_resident,
# quant_paged_bytes, quant_error_feedback_norm. The rest accumulate:
# quant_int8_rungs_warmed (ladder rungs warmed in quantized mode),
# quant_wire_bytes_saved, quant_page_ins.
_QUANT = {
    'quant_models_resident': 0,         # gauge
    'quant_int8_rungs_warmed': 0,
    'quant_wire_bytes_saved': 0,
    'quant_error_feedback_norm': 0.0,   # gauge
    'quant_page_ins': 0,
    'quant_paged_bytes': 0,             # gauge
}


def add_quant_stats(models_resident=None, error_feedback_norm=None,
                    paged_bytes=None, **deltas):
    """Accumulate low-precision counters: the three gauge keywords set,
    everything else adds (keys without the quant_ prefix:
    int8_rungs_warmed=1, wire_bytes_saved=n, page_ins=1)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            _QUANT['quant_' + k] += int(v)
        if models_resident is not None:
            _QUANT['quant_models_resident'] = int(models_resident)
        if error_feedback_norm is not None:
            _QUANT['quant_error_feedback_norm'] = \
                float(error_feedback_norm)
        if paged_bytes is not None:
            _QUANT['quant_paged_bytes'] = int(paged_bytes)


def quant_stats():
    """Snapshot of the low-precision counters."""
    with _STATE['lock']:
        return dict(_QUANT)


# fleet serving-tier counters (serving_fleet.ModelRegistry, the HTTP
# front and the continuous batcher): registry paging, SLO sheds, HTTP
# admission, and the continuous batcher's ticks, chunks and slot use.
# fleet_resident_bytes is a gauge; the rest accumulate, the float-seeded
# ones in fractions.
_FLEET = {
    'fleet_models_registered': 0,
    'fleet_loads': 0,            # model made resident (engine warmed)
    'fleet_evictions': 0,        # byte-budget LRU paged a model out
    'fleet_shed_requests': 0,    # Overloaded raised at admission
    'fleet_http_requests': 0,
    'fleet_http_429': 0,         # backpressure surfaced to a client
    'fleet_resident_bytes': 0,   # gauge: registry-resident weight bytes
    'cont_ticks': 0,             # continuous-batcher timesteps run
    'cont_active_row_ticks': 0,  # slot-ticks doing real sequence work
    'cont_slot_ticks': 0,        # slot-ticks available (ticks x slots)
    'cont_admitted': 0,
    'cont_retired': 0,
    'cont_chunks_dispatched': 0,    # K-tick chunk dispatches
    'cont_chunk_ticks': 0,          # timesteps run inside those chunks
    'cont_boundary_wait_ms': 0.0,   # est. queue wait behind slots freed
                                    # mid-chunk (masked to the boundary)
    'cont_lone_fast_path': 0,       # lone-request rung dispatches
    'cont_exact_fill_admits': 0,    # chunk stagings that skipped the pad
                                    # fill (every slot active all K ticks)
    'cont_staged_chunks': 0,        # chunks staged while the previous
                                    # dispatch ran
    'cont_stage_overlap_ms': 0.0,   # host staging time spent behind an
                                    # in-flight chunk
}


def add_fleet_stats(resident_bytes=None, **deltas):
    """Accumulate fleet counters (resident_bytes is a gauge and set;
    everything else adds, keys with or without the fleet_ prefix)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            key = 'fleet_' + k if 'fleet_' + k in _FLEET else k
            _FLEET[key] += float(v) if isinstance(_FLEET[key], float) \
                else int(v)
        if resident_bytes is not None:
            _FLEET['fleet_resident_bytes'] = int(resident_bytes)


def fleet_stats():
    """Snapshot of the fleet counters and cont_utilization (active
    slot-ticks over available slot-ticks)."""
    with _STATE['lock']:
        out = dict(_FLEET)
    st = out['cont_slot_ticks']
    out['cont_utilization'] = \
        out['cont_active_row_ticks'] / st if st else 0.0
    return out


# train -> serve loop counters: pushes and verdicts (fleet_supervisor.
# CheckpointPusher) and the continuous batcher's hot-swap
# migration: slots re-admitted into a replacement engine, slots whose
# exported state was dropped (MXNET_TPU_FAULT_SWAP_DROP_STATE, replayed
# from t=0), slots migrated across a model change.
# loop_consecutive_rollbacks is a gauge.
_LOOP = {
    'loop_pushes': 0,
    'loop_push_failures': 0,
    'loop_push_queue_skipped': 0,
    'loop_verdicts_promoted': 0,
    'loop_verdicts_rolled_back': 0,
    'loop_consecutive_rollbacks': 0,    # gauge
    'loop_swap_migrated_slots': 0,
    'loop_swap_dropped_slots': 0,
    'loop_swap_divergent_slots': 0,
    'loop_lr_backoffs': 0,
}


def add_loop_stats(consecutive_rollbacks=None, **deltas):
    """Accumulate loop counters (consecutive_rollbacks is a gauge; keys
    without the loop_ prefix: swap_migrated_slots=n, ...)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            _LOOP['loop_' + k] += int(v)
        if consecutive_rollbacks is not None:
            _LOOP['loop_consecutive_rollbacks'] = \
                int(consecutive_rollbacks)


def loop_stats():
    """Snapshot of the loop counters."""
    with _STATE['lock']:
        return dict(_LOOP)


# the self-healing fleet's counters (fleet_supervisor.FleetRouter and
# FleetSupervisor): replica lifecycle (spawns, restarts, retires and the
# live gauge), the router's retries and fast 503s under replica death,
# and continuous deployment (canary pushes, promotions, rollbacks,
# shadow traffic and divergences). fleet_supervisor_replicas_live is a
# gauge.
_FLEET_SUP = {
    'fleet_supervisor_replica_spawns': 0,
    'fleet_supervisor_replica_restarts': 0,
    'fleet_supervisor_replica_retires': 0,
    'fleet_supervisor_replicas_live': 0,    # gauge
    'fleet_supervisor_router_requests': 0,
    'fleet_supervisor_router_retries': 0,
    'fleet_supervisor_router_503': 0,
    'fleet_supervisor_canary_pushes': 0,
    'fleet_supervisor_canary_promotions': 0,
    'fleet_supervisor_canary_rollbacks': 0,
    'fleet_supervisor_shadow_requests': 0,
    'fleet_supervisor_shadow_divergences': 0,
}


def add_fleet_supervisor_stats(replicas_live=None, **deltas):
    """Accumulate fleet-supervisor counters (replicas_live is a gauge;
    keys without the fleet_supervisor_ prefix: router_retries=1, ...)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            _FLEET_SUP['fleet_supervisor_' + k] += int(v)
        if replicas_live is not None:
            _FLEET_SUP['fleet_supervisor_replicas_live'] = \
                int(replicas_live)


def fleet_supervisor_stats():
    """Snapshot of the fleet-supervisor counters (also in summary(),
    dump_profile's 'fleet_supervisor' lane and the router's /statsz)."""
    with _STATE['lock']:
        return dict(_FLEET_SUP)


# host-hiding counters: train-step pipelining (not ported yet), the
# continuous batcher's chunk staging and its adaptive tick chunk.
# overlap_steps_ahead and overlap_auto_k are gauges.
_OVERLAP = {
    'overlap_train_steps': 0,
    'overlap_steps_ahead': 0,           # gauge
    'overlap_dispatch_wait_ms': 0.0,
    'overlap_deferred_metric_folds': 0,
    'overlap_stage_chunks': 0,          # serving chunks staged ahead
    'overlap_stage_overlap_ms': 0.0,    # their staging time
    'overlap_auto_k_decisions': 0,      # the adaptive chooser changed K
    'overlap_auto_k': 0,                # gauge: the K it chose last
}


def add_overlap_stats(steps_ahead=None, auto_k=None, **deltas):
    """Accumulate host-hiding counters (steps_ahead and auto_k are
    gauges; keys without the overlap_ prefix)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            key = 'overlap_' + k
            _OVERLAP[key] += float(v) \
                if isinstance(_OVERLAP[key], float) else int(v)
        if steps_ahead is not None:
            _OVERLAP['overlap_steps_ahead'] = int(steps_ahead)
        if auto_k is not None:
            _OVERLAP['overlap_auto_k'] = int(auto_k)


def overlap_stats():
    """Snapshot of the host-hiding counters."""
    with _STATE['lock']:
        return dict(_OVERLAP)


# bucketed-training counters (BucketingModule's bucket ladder): bucket
# switches, the label rows padded up to a rung, and per rung its steps,
# dispatches, the dispatches during which a program was built
# ('compiles': none after warm-up is the ladder's contract), its
# warm-up visits and those that built a program
_BUCKET = {
    'train_bucket_switches': 0,
    'train_pad_waste_rows': 0,
    'train_rows': 0,
}
_BUCKET_RUNGS = {}


def _rung_entry(rung):
    e = _BUCKET_RUNGS.get(str(rung))
    if e is None:
        e = {'steps': 0, 'dispatches': 0, 'compiles': 0,
             'warmups': 0, 'warm_compiles': 0}
        _BUCKET_RUNGS[str(rung)] = e
    return e


def add_bucket_stats(switches=0, pad_rows=0, rows=0):
    """Accumulate the bucket switches and the padded and total label
    rows."""
    with _STATE['lock']:
        _BUCKET['train_bucket_switches'] += int(switches)
        _BUCKET['train_pad_waste_rows'] += int(pad_rows)
        _BUCKET['train_rows'] += int(rows)


def note_bucket_dispatch(rung, steps=1, compiled=False):
    """One train dispatch of `steps` steps on `rung`; compiled: a
    program was built during it."""
    with _STATE['lock']:
        e = _rung_entry(rung)
        e['steps'] += int(steps)
        e['dispatches'] += 1
        if compiled:
            e['compiles'] += 1


def note_bucket_warmup(rung, compiled=False):
    """One warm-up of `rung`; compiled=False: its programs were all in
    exec_cache already."""
    with _STATE['lock']:
        e = _rung_entry(rung)
        e['warmups'] += 1
        if compiled:
            e['warm_compiles'] += 1


# host input-pipeline counters (the image decode pool and the device
# prefetch): the decode work done by the workers, the time the consumer
# waited on the pool, ready-chunk queue depth observations, and the input
# stall the training loop sees (PrefetchToDeviceIter.next's blocking time)
_INPUT = {
    'decode_ms': 0.0,
    'decoded_samples': 0,
    'decode_wait_ms': 0.0,
    'queue_depth_sum': 0,
    'queue_depth_obs': 0,
    'input_stall_ms': 0.0,
    'input_batches': 0,
}


def add_input_stats(decode_ms=0.0, decoded_samples=0, decode_wait_ms=0.0,
                    queue_depth=None, stall_ms=0.0, batches=0):
    """Accumulate the input-pipeline counters (decode workers feed
    decode_ms / decoded_samples; the batch consumer decode_wait_ms and
    queue_depth; PrefetchToDeviceIter stall_ms / batches)."""
    with _STATE['lock']:
        _INPUT['decode_ms'] += decode_ms
        _INPUT['decoded_samples'] += decoded_samples
        _INPUT['decode_wait_ms'] += decode_wait_ms
        if queue_depth is not None:
            _INPUT['queue_depth_sum'] += int(queue_depth)
            _INPUT['queue_depth_obs'] += 1
        _INPUT['input_stall_ms'] += stall_ms
        _INPUT['input_batches'] += batches


def input_stats():
    """A snapshot of the input-pipeline counters and their means
    (queue_depth_avg, input_stall_ms_per_batch)."""
    with _STATE['lock']:
        out = dict(_INPUT)
    out['queue_depth_avg'] = (out['queue_depth_sum'] /
                              out['queue_depth_obs']
                              if out['queue_depth_obs'] else 0.0)
    out['input_stall_ms_per_batch'] = (out['input_stall_ms'] /
                                       out['input_batches']
                                       if out['input_batches'] else 0.0)
    return out


def bucketing_stats():
    """The bucket-ladder counters, train_pad_waste_frac (padded over all
    label rows) and the per-rung table ('train_rungs')."""
    with _STATE['lock']:
        out = dict(_BUCKET)
        out['train_rungs'] = {k: dict(v) for k, v in _BUCKET_RUNGS.items()}
    total = out['train_rows'] + out['train_pad_waste_rows']
    out['train_pad_waste_frac'] = \
        out['train_pad_waste_rows'] / total if total else 0.0
    return out


def exec_cache_stats():
    """The program cache's counters: exec_cache_hits / exec_cache_misses
    (lookups of a rung's serve program; a miss builds one) and
    total_compile_s (host seconds building programs and running their
    first calls)."""
    from . import exec_cache
    st = exec_cache.stats()
    return {'exec_cache_hits': st['hits'],
            'exec_cache_misses': st['misses'],
            'total_compile_s': st['total_compile_s']}

# elastic-checkpoint counters (elastic.CheckpointManager): snapshots
# committed, payload bytes written, the writer thread's host time while
# training went on (ckpt_async_overlap_ms; 0 for synchronous and final
# commits), end-to-end commit time, torn checkpoints skipped at resume,
# restores, cadence snapshots skipped behind a write in flight, and
# write failures survived
_CKPT = {
    'ckpt_snapshots': 0,
    'ckpt_bytes': 0,
    'ckpt_async_overlap_ms': 0.0,
    'ckpt_commit_ms': 0.0,
    'ckpt_torn_fallbacks': 0,
    'ckpt_restores': 0,
    'ckpt_skipped': 0,
    'ckpt_failed_writes': 0,
}


def add_ckpt_stats(snapshots=0, bytes=0, async_overlap_ms=0.0,
                   commit_ms=0.0, torn_fallbacks=0, restores=0,
                   skipped=0, failed_writes=0):
    """Accumulate elastic-checkpoint counters (one call per event)."""
    with _STATE['lock']:
        _CKPT['ckpt_snapshots'] += int(snapshots)
        _CKPT['ckpt_bytes'] += int(bytes)
        _CKPT['ckpt_async_overlap_ms'] += float(async_overlap_ms)
        _CKPT['ckpt_commit_ms'] += float(commit_ms)
        _CKPT['ckpt_torn_fallbacks'] += int(torn_fallbacks)
        _CKPT['ckpt_restores'] += int(restores)
        _CKPT['ckpt_skipped'] += int(skipped)
        _CKPT['ckpt_failed_writes'] += int(failed_writes)


def ckpt_stats():
    """Snapshot of the elastic-checkpoint counters."""
    with _STATE['lock']:
        return dict(_CKPT)


# dist-runtime counters (dist.py): heartbeats sent and missed, barrier
# rounds and the ms waited in them, deaths learned of, allreduce rounds,
# wire bytes per direction and per topology ('star', 'ring', 'sparse'),
# the ms async rounds overlapped their caller, and the elastic
# relaunches this process is downstream of
_DIST = {
    'dist_heartbeats_sent': 0,
    'dist_heartbeats_missed': 0,
    'dist_barriers': 0,
    'dist_barrier_wait_ms': 0.0,
    'dist_dead_hosts_detected': 0,
    'dist_allreduce_rounds': 0,
    'dist_allreduce_bytes': 0,
    'dist_tx_bytes': 0,
    'dist_rx_bytes': 0,
    'dist_star_bytes': 0,
    'dist_ring_bytes': 0,
    'dist_sparse_bytes': 0,
    'dist_overlap_ms': 0.0,
    'dist_restarts': 0,
}


def add_dist_stats(heartbeats_sent=0, heartbeats_missed=0, barriers=0,
                   barrier_wait_ms=0.0, dead_hosts_detected=0,
                   allreduce_rounds=0, allreduce_bytes=0, restarts=0,
                   tx_bytes=0, rx_bytes=0, topology=None,
                   overlap_ms=0.0):
    """Accumulate dist-runtime counters; `topology` attributes the
    directional bytes to the transport that moved them, and
    allreduce_bytes defaults to tx + rx."""
    if (tx_bytes or rx_bytes) and not allreduce_bytes:
        allreduce_bytes = int(tx_bytes) + int(rx_bytes)
    with _STATE['lock']:
        _DIST['dist_heartbeats_sent'] += int(heartbeats_sent)
        _DIST['dist_heartbeats_missed'] += int(heartbeats_missed)
        _DIST['dist_barriers'] += int(barriers)
        _DIST['dist_barrier_wait_ms'] += float(barrier_wait_ms)
        _DIST['dist_dead_hosts_detected'] += int(dead_hosts_detected)
        _DIST['dist_allreduce_rounds'] += int(allreduce_rounds)
        _DIST['dist_allreduce_bytes'] += int(allreduce_bytes)
        _DIST['dist_tx_bytes'] += int(tx_bytes)
        _DIST['dist_rx_bytes'] += int(rx_bytes)
        if topology is not None:
            _DIST['dist_%s_bytes' % topology] += \
                int(tx_bytes) + int(rx_bytes)
        _DIST['dist_overlap_ms'] += float(overlap_ms)
        _DIST['dist_restarts'] += int(restarts)


def dist_stats():
    """Snapshot of the dist-runtime counters."""
    with _STATE['lock']:
        return dict(_DIST)


# weight-delta counters (delta.py and its users): delta commits and
# applies, payload bytes beside the full state's, the chain length
# (a gauge), rebases and fallbacks, and lossy-parity refusals
_DELTA = {
    'delta_committed': 0,
    'delta_applied': 0,
    'delta_bytes': 0,
    'delta_full_bytes': 0,
    'delta_chain_len': 0,       # gauge
    'delta_rebases': 0,
    'delta_fallbacks': 0,
    'delta_pushes': 0,
    'delta_push_fallbacks': 0,
    'delta_page_applies': 0,
    'delta_parity_refusals': 0,
}


def add_delta_stats(chain_len=None, **deltas):
    """Accumulate weight-delta counters (chain_len is set, the rest
    add; keys without the delta_ prefix)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            _DELTA['delta_' + k] += int(v)
        if chain_len is not None:
            _DELTA['delta_chain_len'] = int(chain_len)


def delta_stats():
    """Snapshot of the weight-delta counters."""
    with _STATE['lock']:
        return dict(_DELTA)


# mesh collective counters (parallel/collectives.py): collectives issued
# over an axis of more than one rank, their payload bytes (what each
# rank handed to the collective), the bytes copied between the card and
# pinned host memory to carry CUDA tensors over a gloo group (an NCCL
# group never stages), and the ring attention hops that ran a block
_MESH = {
    'mesh_collectives': 0,
    'mesh_payload_bytes': 0,
    'mesh_staged_bytes': 0,
    'mesh_ring_hops': 0,
}


def add_mesh_stats(**deltas):
    """Accumulate mesh collective counters (keys without the mesh_
    prefix)."""
    with _STATE['lock']:
        for k, v in deltas.items():
            _MESH['mesh_' + k] += int(v)


def mesh_stats():
    """Snapshot of the mesh collective counters."""
    with _STATE['lock']:
        return dict(_MESH)


# sparse embedding counters (Embedding(sparse_grad=True) through the
# fused steps, and the serving engine's hot-row cache): the bytes the
# rows-only update touched against what the dense update would have
_EMBED = {
    'embed_steps': 0,
    'embed_dispatches': 0,
    'embed_lookups': 0,
    'embed_unique_rows': 0,          # ladder-padded rows updated
    'embed_touched_bytes': 0,        # optimizer-touched (rows-only)
    'embed_dense_equiv_bytes': 0,    # dense-path equivalent
    'embed_max_rung': 0,             # largest ladder rung seen
    'hotrow_hits': 0,
    'hotrow_misses': 0,
    'hotrow_evictions': 0,
    'hotrow_resident_bytes': 0,      # gauge, not cumulative
    'hotrow_prefetched': 0,          # rows paged ahead of demand
    'hotrow_prefetch_hits': 0,       # prefetched rows later demanded
}


def add_embed_stats(steps=0, dispatches=0, lookups=0, unique_rows=0,
                    touched_bytes=0, dense_equiv_bytes=0, max_rung=0,
                    hits=0, misses=0, evictions=0, prefetched=0,
                    prefetch_hits=0, resident_bytes=None):
    """Accumulate sparse-embedding counters (one call per sparse fused
    dispatch; the hot-row cache's per batch and per prefetch)."""
    with _STATE['lock']:
        _EMBED['embed_steps'] += int(steps)
        _EMBED['embed_dispatches'] += int(dispatches)
        _EMBED['embed_lookups'] += int(lookups)
        _EMBED['embed_unique_rows'] += int(unique_rows)
        _EMBED['embed_touched_bytes'] += int(touched_bytes)
        _EMBED['embed_dense_equiv_bytes'] += int(dense_equiv_bytes)
        _EMBED['embed_max_rung'] = max(_EMBED['embed_max_rung'],
                                       int(max_rung))
        _EMBED['hotrow_hits'] += int(hits)
        _EMBED['hotrow_misses'] += int(misses)
        _EMBED['hotrow_evictions'] += int(evictions)
        _EMBED['hotrow_prefetched'] += int(prefetched)
        _EMBED['hotrow_prefetch_hits'] += int(prefetch_hits)
        if resident_bytes is not None:
            _EMBED['hotrow_resident_bytes'] = int(resident_bytes)


def embed_stats():
    """Snapshot of the sparse-embedding counters, with the touched
    fraction and the hot-row hit rate."""
    with _STATE['lock']:
        out = dict(_EMBED)
    out['embed_touched_frac'] = (
        out['embed_touched_bytes'] / out['embed_dense_equiv_bytes']
        if out['embed_dense_equiv_bytes'] else 0.0)
    lookups = out['hotrow_hits'] + out['hotrow_misses']
    out['hotrow_hit_rate'] = \
        out['hotrow_hits'] / lookups if lookups else 0.0
    return out


# fused Gluon step counters (gluon/fused.py): optimizer steps and the
# calls that ran them (a bulk call runs K)
_GLUON_FUSED = {
    'gluon_fused_steps': 0,
    'gluon_fused_dispatches': 0,
}


def add_gluon_fused_stats(steps=0, dispatches=0):
    with _STATE['lock']:
        _GLUON_FUSED['gluon_fused_steps'] += int(steps)
        _GLUON_FUSED['gluon_fused_dispatches'] += int(dispatches)


def gluon_fused_stats():
    """Snapshot of the fused Gluon step counters, with steps a call."""
    with _STATE['lock']:
        out = dict(_GLUON_FUSED)
    out['gluon_fused_steps_per_dispatch'] = (
        out['gluon_fused_steps'] / out['gluon_fused_dispatches']
        if out['gluon_fused_dispatches'] else 0.0)
    return out


# data-parallel step counters (the JAX package's comm_stats): the logical
# bytes the ZeRO-1 steps reduce-scattered and all-gathered, the
# optimizer-state bytes this rank holds (a gauge, set after each step),
# the gradient buckets the in-step all-reduce issued, the train steps
# whose metric folded on the device inside a bulk dispatch; and which
# collective carried each ZeRO bucket's reduce-scatter on the wire (a
# reduce-scatter on NCCL; on gloo, which has none, an all-reduce)
_COMM = {
    'bytes_reduce_scattered': 0,
    'bytes_all_gathered': 0,
    'optimizer_state_bytes_per_device': 0,
    'reduce_buckets_issued': 0,
    'scan_fused_metric_steps': 0,
    'zero_wire_reduce_scatter': 0,
    'zero_wire_all_reduce': 0,
}


def add_reduce_stats(buckets_issued=0, metric_steps=0):
    """Gradient buckets issued by the in-step all-reduce, and steps
    whose metric folded on the device."""
    with _STATE['lock']:
        _COMM['reduce_buckets_issued'] += int(buckets_issued)
        _COMM['scan_fused_metric_steps'] += int(metric_steps)


def add_comm_bytes(reduce_scattered=0, all_gathered=0):
    """Logical payload bytes of the ZeRO-1 steps: gradients
    reduce-scattered, updated parameters all-gathered."""
    with _STATE['lock']:
        _COMM['bytes_reduce_scattered'] += int(reduce_scattered)
        _COMM['bytes_all_gathered'] += int(all_gathered)


def add_comm_wire(reduce_scatter=0, reduce_scatter_as_all_reduce=0):
    """One ZeRO bucket's reduce-scatter, as the wire carried it."""
    with _STATE['lock']:
        _COMM['zero_wire_reduce_scatter'] += int(reduce_scatter)
        _COMM['zero_wire_all_reduce'] += int(reduce_scatter_as_all_reduce)


def set_optimizer_state_bytes(n):
    """The optimizer-state bytes resident on this rank (momenta and
    float32 masters; 1/dp of them under ZeRO-1)."""
    with _STATE['lock']:
        _COMM['optimizer_state_bytes_per_device'] = int(n)


def comm_stats():
    """Snapshot of the data-parallel step counters."""
    with _STATE['lock']:
        return dict(_COMM)


# pipeline-parallel counters (parallel/pipeline.py, both pipelined
# trainers; one call a pipelined dispatch). stages, num_micro,
# bubble_frac and the per-rank parameter and optimizer-state bytes are
# gauges (the last dispatch's); the rest accumulate. bubble_frac is the
# fill-drain schedule's (S-1)/(M+S-1): the share of its ticks on which a
# stage has no microbatch (the port runs nothing on them)
_PIPE = {
    'pipe_dispatches': 0,
    'pipe_steps': 0,
    'pipe_microbatches': 0,
    'pipe_stages': 0,
    'pipe_num_micro': 0,
    'pipe_bubble_frac': 0.0,
    'pipe_param_bytes_per_device': 0,
    'pipe_state_bytes_per_device': 0,
}


def note_pipe_dispatch(stages, micro, k, bubble_frac, param_bytes=0,
                       state_bytes=0):
    """One pipelined dispatch of k steps (the Gluon and Module paths
    share it)."""
    with _STATE['lock']:
        _PIPE['pipe_dispatches'] += 1
        _PIPE['pipe_steps'] += int(k)
        _PIPE['pipe_microbatches'] += int(micro) * int(k)
        _PIPE['pipe_stages'] = int(stages)
        _PIPE['pipe_num_micro'] = int(micro)
        _PIPE['pipe_bubble_frac'] = float(bubble_frac)
        if param_bytes:
            _PIPE['pipe_param_bytes_per_device'] = int(param_bytes)
        if state_bytes:
            _PIPE['pipe_state_bytes_per_device'] = int(state_bytes)


def pipe_stats():
    """Snapshot of the pipeline counters (also in summary() and
    dump_profile's 'pipeline' lane)."""
    with _STATE['lock']:
        return dict(_PIPE)


# mixture-of-experts counters (gluon.nn.MoE through the fused step):
# tokens routed to an expert and tokens dropped at its capacity (they
# ride the residual, silently otherwise), and the per-expert table
_MOE = {
    'moe_routed_tokens': 0,
    'moe_dropped_tokens': 0,
    'moe_dispatches': 0,
}
_MOE_EXPERTS = {}       # 'e<i>' -> {'routed': n, 'dropped': n}


def add_moe_stats(routed=0, dropped=0, per_expert_routed=None,
                  per_expert_dropped=None, dispatches=0):
    """Accumulate the routing counters (the fused step feeds one call a
    dispatch from the blocks' count deltas)."""
    with _STATE['lock']:
        _MOE['moe_routed_tokens'] += int(routed)
        _MOE['moe_dropped_tokens'] += int(dropped)
        _MOE['moe_dispatches'] += int(dispatches)
        for key, vals in (('routed', per_expert_routed),
                          ('dropped', per_expert_dropped)):
            if vals is None:
                continue
            for i, v in enumerate(vals):
                e = _MOE_EXPERTS.setdefault('e%d' % i,
                                            {'routed': 0, 'dropped': 0})
                e[key] += int(v)


def moe_stats():
    """Snapshot of the routing counters, the drop fraction and the
    per-expert table."""
    with _STATE['lock']:
        out = dict(_MOE)
        out['moe_experts'] = {k: dict(v) for k, v in _MOE_EXPERTS.items()}
    total = out['moe_routed_tokens'] + out['moe_dropped_tokens']
    out['moe_drop_frac'] = \
        out['moe_dropped_tokens'] / total if total else 0.0
    return out



def summary(print_out=True):
    """Human-readable profile summary: span time by category, then the
    input pipeline, program cache, serving, fleet, quantization, loop,
    overlap and bucketing counters."""
    with _STATE['lock']:
        records = list(_STATE['records'])
    by_cat = {}
    for _name, cat, _ts, dur, _tid in records:
        by_cat[cat] = by_cat.get(cat, 0) + dur
    lines = ['profile summary: %d spans' % len(records)]
    for cat in sorted(by_cat):
        lines.append('  %-16s %10.3f ms' % (cat, by_cat[cat] / 1e3))
    ip = input_stats()
    lines.append('  decode_ms=%.3f decoded_samples=%d '
                 'decode_wait_ms=%.3f queue_depth_avg=%.2f '
                 'input_stall_ms_per_batch=%.3f'
                 % (ip['decode_ms'], ip['decoded_samples'],
                    ip['decode_wait_ms'], ip['queue_depth_avg'],
                    ip['input_stall_ms_per_batch']))
    st = exec_cache_stats()
    lines.append('  exec_cache_hits=%d exec_cache_misses=%d '
                 'total_compile_s=%.3f'
                 % (st['exec_cache_hits'], st['exec_cache_misses'],
                    st['total_compile_s']))
    sv = serving_stats()
    lines.append('  serve_requests=%d serve_batches=%d '
                 'serve_queue_depth_avg=%.2f serve_batch_fill_avg=%.2f '
                 'serve_pad_waste_frac=%.3f serve_latency_p50_ms=%.3f '
                 'serve_latency_p99_ms=%.3f'
                 % (sv['serve_requests'], sv['serve_batches'],
                    sv['serve_queue_depth_avg'],
                    sv['serve_batch_fill_avg'],
                    sv['serve_pad_waste_frac'],
                    sv['serve_latency_p50_ms'],
                    sv['serve_latency_p99_ms']))
    qt = quant_stats()
    lines.append('  quant_models_resident=%d quant_int8_rungs_warmed=%d '
                 'quant_wire_bytes_saved=%d '
                 'quant_error_feedback_norm=%.6f quant_page_ins=%d '
                 'quant_paged_bytes=%d'
                 % (qt['quant_models_resident'],
                    qt['quant_int8_rungs_warmed'],
                    qt['quant_wire_bytes_saved'],
                    qt['quant_error_feedback_norm'],
                    qt['quant_page_ins'], qt['quant_paged_bytes']))
    fl = fleet_stats()
    lines.append('  fleet_loads=%d fleet_evictions=%d '
                 'fleet_shed_requests=%d fleet_http_requests=%d '
                 'fleet_http_429=%d fleet_resident_bytes=%d '
                 'cont_ticks=%d cont_utilization=%.3f'
                 % (fl['fleet_loads'], fl['fleet_evictions'],
                    fl['fleet_shed_requests'],
                    fl['fleet_http_requests'], fl['fleet_http_429'],
                    fl['fleet_resident_bytes'], fl['cont_ticks'],
                    fl['cont_utilization']))
    lines.append('  cont_chunks_dispatched=%d cont_chunk_ticks=%d '
                 'cont_boundary_wait_ms=%.3f cont_lone_fast_path=%d '
                 'cont_exact_fill_admits=%d'
                 % (fl['cont_chunks_dispatched'],
                    fl['cont_chunk_ticks'],
                    fl['cont_boundary_wait_ms'],
                    fl['cont_lone_fast_path'],
                    fl['cont_exact_fill_admits']))
    fs = fleet_supervisor_stats()
    lines.append('  ' + ' '.join('%s=%d' % kv for kv in fs.items()))
    lp = loop_stats()
    lines.append('  loop_pushes=%d loop_push_failures=%d '
                 'loop_push_queue_skipped=%d loop_verdicts_promoted=%d '
                 'loop_verdicts_rolled_back=%d '
                 'loop_consecutive_rollbacks=%d loop_lr_backoffs=%d'
                 % (lp['loop_pushes'], lp['loop_push_failures'],
                    lp['loop_push_queue_skipped'],
                    lp['loop_verdicts_promoted'],
                    lp['loop_verdicts_rolled_back'],
                    lp['loop_consecutive_rollbacks'],
                    lp['loop_lr_backoffs']))
    lines.append('  loop_swap_migrated_slots=%d '
                 'loop_swap_dropped_slots=%d '
                 'loop_swap_divergent_slots=%d'
                 % (lp['loop_swap_migrated_slots'],
                    lp['loop_swap_dropped_slots'],
                    lp['loop_swap_divergent_slots']))
    ov = overlap_stats()
    lines.append('  overlap_stage_chunks=%d overlap_stage_overlap_ms'
                 '=%.3f overlap_auto_k_decisions=%d overlap_auto_k=%d'
                 % (ov['overlap_stage_chunks'],
                    ov['overlap_stage_overlap_ms'],
                    ov['overlap_auto_k_decisions'],
                    ov['overlap_auto_k']))
    bk = bucketing_stats()
    lines.append('  train_bucket_switches=%d train_pad_waste_rows=%d '
                 'train_pad_waste_frac=%.3f'
                 % (bk['train_bucket_switches'],
                    bk['train_pad_waste_rows'],
                    bk['train_pad_waste_frac']))
    for rung in sorted(bk['train_rungs']):
        e = bk['train_rungs'][rung]
        lines.append('    rung %-8s steps=%d dispatches=%d compiles=%d '
                     'warmups=%d warm_compiles=%d'
                     % (rung, e['steps'], e['dispatches'], e['compiles'],
                        e['warmups'], e['warm_compiles']))
    cm = comm_stats()
    lines.append('  bytes_reduce_scattered=%d bytes_all_gathered=%d '
                 'optimizer_state_bytes_per_device=%d'
                 % (cm['bytes_reduce_scattered'], cm['bytes_all_gathered'],
                    cm['optimizer_state_bytes_per_device']))
    lines.append('  reduce_buckets_issued=%d scan_fused_metric_steps=%d '
                 'zero_wire_reduce_scatter=%d zero_wire_all_reduce=%d'
                 % (cm['reduce_buckets_issued'],
                    cm['scan_fused_metric_steps'],
                    cm['zero_wire_reduce_scatter'],
                    cm['zero_wire_all_reduce']))
    gf = gluon_fused_stats()
    lines.append('  gluon_fused_steps=%d gluon_fused_dispatches=%d '
                 'gluon_fused_steps_per_dispatch=%.2f'
                 % (gf['gluon_fused_steps'], gf['gluon_fused_dispatches'],
                    gf['gluon_fused_steps_per_dispatch']))
    pi = pipe_stats()
    lines.append('  pipe_dispatches=%d pipe_steps=%d '
                 'pipe_microbatches=%d pipe_stages=%d '
                 'pipe_num_micro=%d pipe_bubble_frac=%.3f '
                 'pipe_param_bytes_per_device=%d '
                 'pipe_state_bytes_per_device=%d'
                 % (pi['pipe_dispatches'], pi['pipe_steps'],
                    pi['pipe_microbatches'], pi['pipe_stages'],
                    pi['pipe_num_micro'], pi['pipe_bubble_frac'],
                    pi['pipe_param_bytes_per_device'],
                    pi['pipe_state_bytes_per_device']))
    mo = moe_stats()
    lines.append('  moe_routed_tokens=%d moe_dropped_tokens=%d '
                 'moe_drop_frac=%.3f moe_dispatches=%d'
                 % (mo['moe_routed_tokens'], mo['moe_dropped_tokens'],
                    mo['moe_drop_frac'], mo['moe_dispatches']))
    for ek in sorted(mo['moe_experts'], key=lambda s: int(s[1:])):
        e = mo['moe_experts'][ek]
        lines.append('    expert %-4s routed=%d dropped=%d'
                     % (ek, e['routed'], e['dropped']))
    em = embed_stats()
    lines.append('  embed_steps=%d embed_lookups=%d embed_unique_rows=%d '
                 'embed_touched_bytes=%d embed_dense_equiv_bytes=%d '
                 'embed_touched_frac=%.4f embed_max_rung=%d'
                 % (em['embed_steps'], em['embed_lookups'],
                    em['embed_unique_rows'], em['embed_touched_bytes'],
                    em['embed_dense_equiv_bytes'],
                    em['embed_touched_frac'], em['embed_max_rung']))
    lines.append('  hotrow_hits=%d hotrow_misses=%d hotrow_hit_rate=%.3f '
                 'hotrow_evictions=%d hotrow_resident_bytes=%d '
                 'hotrow_prefetched=%d hotrow_prefetch_hits=%d'
                 % (em['hotrow_hits'], em['hotrow_misses'],
                    em['hotrow_hit_rate'], em['hotrow_evictions'],
                    em['hotrow_resident_bytes'], em['hotrow_prefetched'],
                    em['hotrow_prefetch_hits']))
    for stats in (ckpt_stats(), dist_stats(), delta_stats(), mesh_stats()):
        lines.append('  ' + ' '.join('%s=%s' % kv
                                     for kv in sorted(stats.items())))
    text = '\n'.join(lines)
    if print_out:
        print(text)
    return text


def profiler_set_config(mode='symbolic', filename='profile.json',
                        profile_xla=False, xla_trace_dir=None):
    """Configure the profiler (reference profiler_set_config). mode:
    'symbolic' records executor-level spans; 'all' also records
    imperative ops. profile_xla adds torch.profiler's device lanes; its
    trace goes to xla_trace_dir (default: beside filename)."""
    if mode not in ('symbolic', 'all', 'all_ops'):
        raise ValueError("profiler mode must be 'symbolic', 'all' or "
                         "'all_ops', got %r" % (mode,))
    _STATE['mode'] = 'all' if mode in ('all', 'all_ops') else 'symbolic'
    _STATE['filename'] = filename
    _STATE['device_trace'] = bool(profile_xla)
    _STATE['device_trace_dir'] = xla_trace_dir or \
        os.path.splitext(filename)[0] + '_xla'


def profiler_set_state(state='stop'):
    """'run' starts recording, 'stop' halts it (reference
    MXSetProfilerState)."""
    if state not in ('run', 'stop'):
        raise ValueError("profiler state must be 'run' or 'stop', got %r"
                         % (state,))
    running = state == 'run'
    if running and not _STATE['running'] and _STATE['device_trace']:
        _start_device_trace()
    if not running and _STATE['running'] and \
            _STATE['torch_profile'] is not None:
        _stop_device_trace()
    _STATE['running'] = running


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _STATE['torch_profile'] = prof


def _stop_device_trace():
    """Stop torch.profiler, write its Chrome trace under the trace
    directory and keep its lanes for dump_profile."""
    prof = _STATE['torch_profile']
    _STATE['torch_profile'] = None
    prof.__exit__(None, None, None)
    os.makedirs(_STATE['device_trace_dir'], exist_ok=True)
    path = os.path.join(_STATE['device_trace_dir'], 'torch_trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        _STATE['device_events'] = _device_lanes(json.load(f))


def _device_lanes(trace):
    """torch.profiler's trace remapped to pids 100 and up: the CUDA
    kernels' lanes where the run had any, else the host's torch ops (a
    CPU-only run), as the JAX package keeps the device lanes of its XLA
    trace, or its '/host:CPU' lane on the CPU backend."""
    raw = trace.get('traceEvents', [])
    spans = [e for e in raw if e.get('ph') == 'X']
    kernels = [e for e in spans if e.get('cat') == 'kernel']
    keep = kernels or [e for e in spans if e.get('cat') == 'cpu_op']
    names = {}
    for e in raw:
        if e.get('ph') == 'M' and e.get('name') == 'process_name':
            names[e['pid']] = e.get('args', {}).get('name', str(e['pid']))
    pids = sorted({e['pid'] for e in keep}, key=str)
    pid_map = {pid: 100 + i for i, pid in enumerate(pids)}
    out = [{'ph': 'M', 'name': 'process_name', 'pid': new,
            'args': {'name': 'torch %s' % names.get(old, old)}}
           for old, new in pid_map.items()]
    for e in keep:
        out.append({'name': e.get('name', ''), 'cat': 'xla', 'ph': 'X',
                    'ts': e.get('ts', 0), 'dur': e.get('dur', 0),
                    'pid': pid_map[e['pid']], 'tid': e.get('tid', 0)})
    return out


def dump_profile():
    """Write the recorded spans as a Chrome trace-event file (reference
    Profiler::DumpProfile), with torch.profiler's lanes at pids 100 and
    up when profile_xla was set. Returns the file name."""
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 0,
               'args': {'name': 'mxnet_tpu_torch host spans'}},
              {'ph': 'M', 'name': 'exec_cache', 'pid': 0,
               'args': exec_cache_stats()},
              {'ph': 'M', 'name': 'serving', 'pid': 0,
               'args': serving_stats()},
              {'ph': 'M', 'name': 'fleet', 'pid': 0,
               'args': fleet_stats()},
              {'ph': 'M', 'name': 'quant', 'pid': 0,
               'args': quant_stats()},
              {'ph': 'M', 'name': 'fleet_supervisor', 'pid': 0,
               'args': fleet_supervisor_stats()},
              {'ph': 'M', 'name': 'loop', 'pid': 0,
               'args': loop_stats()},
              {'ph': 'M', 'name': 'overlap', 'pid': 0,
               'args': overlap_stats()},
              {'ph': 'M', 'name': 'bucketing', 'pid': 0,
               'args': bucketing_stats()},
              {'ph': 'M', 'name': 'input_pipeline', 'pid': 0,
               'args': input_stats()},
              {'ph': 'M', 'name': 'checkpoint', 'pid': 0,
               'args': ckpt_stats()},
              {'ph': 'M', 'name': 'dist', 'pid': 0,
               'args': dist_stats()},
              {'ph': 'M', 'name': 'delta', 'pid': 0,
               'args': delta_stats()},
              {'ph': 'M', 'name': 'mesh', 'pid': 0,
               'args': mesh_stats()},
              {'ph': 'M', 'name': 'comm', 'pid': 0,
               'args': comm_stats()},
              {'ph': 'M', 'name': 'gluon_fused', 'pid': 0,
               'args': gluon_fused_stats()},
              {'ph': 'M', 'name': 'pipeline', 'pid': 0,
               'args': pipe_stats()},
              {'ph': 'M', 'name': 'moe', 'pid': 0,
               'args': moe_stats()},
              {'ph': 'M', 'name': 'embed', 'pid': 0,
               'args': embed_stats()}]
    with _STATE['lock']:
        records = list(_STATE['records'])
    for name, cat, ts, dur, tid in records:
        events.append({'name': name, 'cat': cat, 'ph': 'X',
                       'ts': ts, 'dur': dur, 'pid': 0, 'tid': tid})
    if _STATE['device_trace']:
        events.extend(_STATE['device_events'])
    with open(_STATE['filename'], 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
    return _STATE['filename']


def is_running():
    return _STATE['running']


def mode():
    return _STATE['mode']


def record(name, category, ts_us, dur_us):
    """Append one span (the hook of the executor and imperative ops)."""
    if not _STATE['running']:
        return
    with _STATE['lock']:
        _STATE['records'].append(
            (name, category, ts_us, dur_us, threading.get_ident() % 1000))


def clear():
    with _STATE['lock']:
        _STATE['records'].clear()
        _STATE['device_events'] = []
        for k in _SERVING:
            _SERVING[k] = type(_SERVING[k])()
        for k in _QUANT:
            _QUANT[k] = type(_QUANT[k])()
        for k in _FLEET:
            _FLEET[k] = type(_FLEET[k])()
        for d in (_LOOP, _FLEET_SUP):
            for k in d:
                d[k] = 0
        for k in _OVERLAP:
            _OVERLAP[k] = type(_OVERLAP[k])()
        for k in _BUCKET:
            _BUCKET[k] = 0
        _BUCKET_RUNGS.clear()
        for k in _INPUT:
            _INPUT[k] = type(_INPUT[k])()
        for d in (_CKPT, _DIST, _DELTA, _MESH, _COMM, _EMBED,
                  _GLUON_FUSED):
            for k in d:
                d[k] = type(d[k])()
        for k in _PIPE:
            _PIPE[k] = type(_PIPE[k])()
        for k in _MOE:
            _MOE[k] = 0
        _MOE_EXPERTS.clear()
        del _SERVE_LAT[:]
        _SERVE_LAT_POS[0] = 0


class scope(object):
    """Context manager recording one span:
    `with profiler.scope('forward'): ...`"""

    def __init__(self, name, category='operator'):
        self.name = name
        self.category = category

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _STATE['running']:
            t1 = time.perf_counter()
            record(self.name, self.category,
                   int(self._t0 * 1e6), int((t1 - self._t0) * 1e6))
        return False


def synchronize(tensors):
    """While the profiler runs, wait for the devices of `tensors` inside
    the span: CUDA work is asynchronous, and a span would otherwise
    time the enqueue."""
    if not _STATE['running']:
        return
    import torch
    for dev in {t.device for t in tensors if t is not None and t.is_cuda}:
        torch.cuda.synchronize(dev)


if os.environ.get('MXNET_PROFILER_AUTOSTART', '0') == '1':
    profiler_set_state('run')
