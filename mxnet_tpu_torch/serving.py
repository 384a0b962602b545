"""Dynamic-batching inference engine: shape-bucketed serving on top of a
Predictor or a Module, the counterpart of the core of
mxnet_tpu/serving.py.

The reference's predict API serves one request per MXPredForward.
`InferenceEngine` serves many callers at once with three mechanisms:

  * **shape-bucket ladder**: requests are padded up to the nearest
    configured bucket on the batch dim (and optionally on free dims), so
    traffic only runs shapes that `warmup()` ran once: no rung is built
    after warmup (`stats()['compiles_after_warmup']` counts the rungs
    this engine bound after it; the port compiles nothing).
  * **dynamic batcher**: a thread-safe queue coalesces concurrent
    `infer()` calls into one padded dispatch under a `max_batch` /
    `max_wait_us` policy, then slices each request's rows back out.
    Within one bucket shape a request's rows do not depend on what it
    was batched with (the forward ops are row independent).
  * **double-buffered staging and completion**: the dispatcher thread
    assembles batch N+1, copies it to the card on a side stream
    (io.stage_to_device) and enqueues its graph walk on the engine's
    compute stream, then records a CUDA event; the completion thread
    waits on batch N's event only (torch.cuda.synchronize would wait for
    N+1 too) and copies its outputs to the host on a third stream. The
    bounded in-flight queue (depth 2) gives backpressure. A staged
    buffer is marked as used by the compute stream (record_stream), so
    its memory is reused only after the walk that reads it; the JAX
    package donates it to XLA instead.

Weights are shared by reference across every bucket executor (one copy
in device memory, `simple_bind(shared_exec=...)`).

Weight-storage quantization (`quantize='int8'` or 'bf16'): the matmul
and conv weights are replaced in place by int8 codes with per-channel
scales (or a bfloat16 cast); each dispatch dequantizes them to their
original dtype before the walk. The codes are what stays resident
(`resident_bytes` counts them at 1 byte). A parity gate refuses an
engine whose quantized outputs differ from the fp ones beyond
`QuantConfig.parity_tol`, and then nothing is mutated.

Serving counters (queue depth, batch fill, pad waste, request latency
p50/p99) feed `profiler.serving_stats()` / `profiler.summary()` /
`dump_profile`'s metadata. `stats()['host_ms']` splits the host time of
a dispatch into the batch's assembly, its staging, the graph walk's
launches and the completion's copy to the host.

`apply_delta` applies a weight delta (`delta.py`) to the resident
weights in place; `export_serving_checkpoint` and `serving_state` read
an elastic checkpoint (full or delta) for serving. Where the port
departs from the JAX package: the resident state that a delta's base
fingerprint is held against leaves out the arguments that feed a loss
head's label (SoftmaxOutput's softmax_label), which no checkpoint
holds; the JAX package counts them, so a model served with its loss
head never matches a commit's fingerprint and refuses every delta.

The hot-row embedding cache (`hot_rows=`, MXNET_TPU_SERVE_HOT_ROWS,
docs/SPARSE.md): an Embedding table whose ids arrive as an engine input
keeps only a (C, dim) buffer on the card, the full table in pinned host
memory; the dispatcher maps each batch's ids onto cache slots (LRU) and
pages the missing rows in before the walk, and after launching a batch
pages in the rows of requests still queued
(MXNET_TPU_SERVE_HOTROW_PREFETCH, default 8 of them; 'off'). Every
page-in is an in-place write on the engine's compute stream, queued
behind the walks already launched there: a walk still reading a slot
runs before the write that replaces it (the JAX package writes a new
buffer instead).

Typical use::

    pred = Predictor.from_checkpoint('model', 42, {'data': (1, 128)})
    eng = pred.serve(max_batch=8, max_wait_us=2000)   # warms the ladder
    out = eng.predict(x)                              # thread-safe
    eng.close()

Env knobs:
  MXNET_TPU_SERVE_MAX_BATCH     default max_batch (8)
  MXNET_TPU_SERVE_WAIT_US       default max_wait_us (2000)
  MXNET_TPU_SERVE_QUANTIZE      default quantize (off)
  MXNET_TPU_SERVE_HOT_ROWS      default hot_rows capacity (0 = off)
  MXNET_TPU_SERVE_HOTROW_PREFETCH  queued requests paged ahead (8)
"""
import contextlib
import os
import threading
import time
import warnings
from collections import OrderedDict, deque

import numpy as np
import torch

from . import exec_cache
from . import io as mxio
from . import ndarray as nd
from . import profiler
from . import quantization
from .base import MXNetError, numpy_dtype
from .quantization import QuantConfig, QuantParityError


def _env_int(name, default):
    try:
        return int(os.environ.get(name, '') or default)
    except ValueError:
        return default


TICK_CHUNK_KNOB = 'MXNET_TPU_SERVE_TICK_CHUNK'


def chunk_for_deadline(deadline_ms, tick_ms_hint, slots=None):
    """SLO-derived default tick chunk of continuous batching: K ticks a
    chunk, with (K-1) * tick_ms_hint <= MXNET_TPU_SERVE_WAIT_FRACTION
    (default 0.25) * deadline_ms, clamped to [1, slots]."""
    try:
        frac = float(os.environ.get('MXNET_TPU_SERVE_WAIT_FRACTION',
                                    '') or 0.25)
    except ValueError:
        frac = 0.25
    tick_ms = max(float(tick_ms_hint), 1e-9)
    k = 1 + int(float(deadline_ms) * frac / tick_ms)
    if slots is not None:
        k = min(k, int(slots))
    return max(1, k)


def resolve_tick_chunk(tick_chunk, slots=None, slo=None,
                       tick_ms_hint=None):
    """The parser of the chunked-tick knob: the chunk length K (1 = the
    unchunked tick loop), or 'auto'. Order: explicit `tick_chunk`
    (0/'off'/1 = unchunked), else MXNET_TPU_SERVE_TICK_CHUNK, else an
    SLO deadline with a per-tick hint (chunk_for_deadline), else 1.
    K > slots is refused; 'auto' needs an SLO deadline."""
    v = tick_chunk
    if v is None:
        v = os.environ.get(TICK_CHUNK_KNOB, '').strip() or None
    if v is None:
        if slo is not None and getattr(slo, 'deadline_ms', None) \
                and tick_ms_hint:
            return chunk_for_deadline(slo.deadline_ms, tick_ms_hint,
                                      slots)
        return 1
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ('', '0', 'off', 'none', 'false'):
            return 1
        if s == 'auto':
            if slo is None or not getattr(slo, 'deadline_ms', None):
                raise MXNetError(
                    "%s: tick_chunk='auto' needs an SLO deadline: the "
                    'adaptive chunker derives K from the live tick-time '
                    'EMA against slo.deadline_ms (chunk_for_deadline); '
                    'pass an SLO with deadline_ms or use a fixed '
                    'integer K' % TICK_CHUNK_KNOB)
            return 'auto'
        try:
            v = int(s)
        except ValueError:
            raise MXNetError(
                '%s: tick_chunk=%r is not a tick count (use an '
                'integer K, or 0/off/1 for the unchunked loop)'
                % (TICK_CHUNK_KNOB, tick_chunk))
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise MXNetError(
            '%s: tick_chunk=%r is not a tick count (use an integer '
            'K, or 0/off/1 for the unchunked loop)'
            % (TICK_CHUNK_KNOB, tick_chunk))
    if v < 0:
        raise MXNetError('%s: tick_chunk=%d must be >= 0'
                         % (TICK_CHUNK_KNOB, v))
    if v in (0, 1):
        return 1
    if slots is not None and v > int(slots):
        raise MXNetError(
            '%s: tick_chunk=%d > slots=%d: admission quantizes to '
            'chunk boundaries, so a chunk longer than the slot count '
            'can strand more than one full batch-width of freed '
            'slot-ticks behind a single boundary; keep K <= slots'
            % (TICK_CHUNK_KNOB, v, int(slots)))
    return v


# per-engine latency window: enough samples for a stable p99, bounded
_LOCAL_LAT_CAP = 4096
# EMA weight of the per-batch service-time and rows-per-batch estimates
_SVC_EMA_ALPHA = 0.25
# the host timings of a dispatch that stats()['host_ms'] reports
_HOST_SPLITS = ('assemble', 'stage', 'launch', 'complete_copy')


class _Request(object):
    """One infer() call in flight: host inputs, result slot, and the
    event the caller waits on."""
    __slots__ = ('inputs', 'rows', 'free_shapes', 't_enq', 'event',
                 'outputs', 'error')

    def __init__(self, inputs, rows, free_shapes):
        self.inputs = inputs            # list of np arrays, one per input
        self.rows = rows
        self.free_shapes = free_shapes  # tuple of shape[1:] per input
        self.t_enq = time.perf_counter()
        self.event = threading.Event()
        self.outputs = None
        self.error = None


def _host_table(t, device):
    """A host copy of a full embedding table, pinned when it feeds a
    card (its rows page in by asynchronous copies)."""
    t = t.detach().to('cpu').contiguous()
    return t.pin_memory() if device.type == 'cuda' else t.clone()


class _HotRowTable(object):
    """The host side of one hot-row-cached table: the full (vocab, dim)
    table on the host, the LRU map id -> slot of the (capacity, dim)
    buffer on the card, and the counters. Only the dispatcher thread
    changes it (stats() reads it)."""
    __slots__ = ('name', 'ids_idx', 'vocab', 'dim', 'capacity', 'host',
                 'arg', 'resident', 'free', 'hits', 'misses', 'evictions',
                 'prefetched', 'prefetch_hits', 'prefetch_rows')

    def __init__(self, name, ids_idx, vocab, dim, capacity, host, arg):
        self.name = name
        self.ids_idx = ids_idx          # engine-input positions
        self.vocab = vocab
        self.dim = dim
        self.capacity = capacity
        self.host = host                # full table, a CPU tensor
        self.arg = arg                  # the NDArray holding the buffer
        self.resident = OrderedDict()   # id -> slot, LRU order
        self.free = list(range(capacity))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetched = set()         # paged-ahead ids not yet hit
        self.prefetch_hits = 0
        self.prefetch_rows = 0


class _Program(object):
    """One (batch bucket x free bucket) rung: a forward-only executor
    sharing the base weights, and its serve function."""
    __slots__ = ('executor', 'serve_fn', 'weight_names', 'batch',
                 'free_shapes', 'warmed')

    def __init__(self, executor, serve_fn, weight_names, batch,
                 free_shapes):
        self.executor = executor
        self.serve_fn = serve_fn
        self.weight_names = weight_names
        self.batch = batch
        self.free_shapes = free_shapes
        # set after the rung's first call, under the engine's _prog_lock
        self.warmed = False


class InferenceEngine(object):
    """Dynamic-batching, shape-bucketed server over a bound Predictor or
    Module (forward only).

    Parameters
    ----------
    source : Predictor or Module
        Bound, parameter-initialized model. The engine shares its weight
        arrays by reference. Anything that rebinds the source to new
        arrays (Predictor.reshape(), Module.bind(force_rebind=True)) is
        invisible to the engine's rung executors: close() and re-create
        the engine after it.
    max_batch : int
        Largest coalesced dispatch (default MXNET_TPU_SERVE_MAX_BATCH or
        8), and the top rung of the default ladder.
    batch_buckets : sequence of int, optional
        The batch-dim ladder. Default: powers of two up to max_batch
        (exec_cache.batch_ladder).
    max_wait_us : int
        How long the batcher holds an underfull batch open for more
        requests (default MXNET_TPU_SERVE_WAIT_US or 2000); 0 flushes at
        once.
    free_dim_buckets : sequence of tuple-of-tuples, optional
        A ladder for the non-batch dims, each entry one free shape per
        input. Requests are padded to the smallest covering entry.
        Default: requests must come at exactly the source's bound free
        shapes. A ladder of several entries also slices the output axes
        that vary with the rung (settled by shape inference) back to the
        request's extent.
    pad_value : float
        Fill of the padding rows and elements (default 0).
    warmup : bool
        Run every rung once at construction (default True).
    depth : int
        In-flight dispatch bound (default 2: double-buffered).
    quantize : QuantConfig, 'int8', 'bf16', False or None
        Weight-storage quantization (None reads MXNET_TPU_SERVE_QUANTIZE;
        False is off whatever the env says). The swap is in place on the
        source's weight arrays: the engine owns them afterwards.
    calibrate : sequence of batches, optional
        Inputs of the quantization parity gate (each batch one array for
        a single-input model, or a list aligned with the input names);
        default one seeded unit-gaussian batch at the top rung.
    hot_rows : int or dict, optional
        The hot-row embedding cache (module docstring; unset:
        MXNET_TPU_SERVE_HOT_ROWS, 0 off). An int caches every eligible
        table at that capacity, a dict {weight name: C} the tables
        named (each must be eligible: its ids an engine input). C is
        clamped to vocab and must cover the worst case of one dispatch
        (max_batch x the ids input's largest free extent), refused
        otherwise; a quantized table is refused. stats()['hot_rows']
        reports each table's hits, misses and bytes.
    """

    def __init__(self, source, max_batch=None, batch_buckets=None,
                 max_wait_us=None, free_dim_buckets=None, pad_value=0.0,
                 warmup=True, depth=2, quantize=None, calibrate=None,
                 hot_rows=None):
        ex, symbol, ctx, input_names = _source_parts(source)
        if not input_names:
            raise MXNetError('InferenceEngine: source has no data inputs')
        if getattr(ex, '_grouped', False):
            raise MXNetError('InferenceEngine does not support ctx_group '
                             '(model-parallel) sources: rung executors '
                             'would collapse the placement onto one '
                             'device')
        if hot_rows is None:
            hot_rows = _env_int('MXNET_TPU_SERVE_HOT_ROWS', 0) or None
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device
        self._base_ex = ex
        self._input_names = list(input_names)
        self._label_names = _label_args(ex)
        self.max_batch = int(max_batch if max_batch is not None else
                             _env_int('MXNET_TPU_SERVE_MAX_BATCH', 8))
        self.max_wait_us = int(max_wait_us if max_wait_us is not None else
                               _env_int('MXNET_TPU_SERVE_WAIT_US', 2000))
        self.pad_value = pad_value
        self.batch_buckets = tuple(sorted(set(
            int(b) for b in (batch_buckets or
                             exec_cache.batch_ladder(self.max_batch)))))
        if self.batch_buckets[-1] != self.max_batch:
            raise MXNetError('largest batch bucket (%d) must equal '
                             'max_batch (%d)'
                             % (self.batch_buckets[-1], self.max_batch))
        base_free = tuple(tuple(ex.arg_dict[n].shape[1:])
                          for n in self._input_names)
        # the bound dtype of each input, and the host dtype a request is
        # taken in (float32 for a bfloat16 input: numpy has none)
        self._input_tdtypes = [ex.arg_dict[n]._data.dtype
                               for n in self._input_names]
        self._input_dtypes = [
            np.dtype(np.float32) if t == torch.bfloat16
            else np.dtype(numpy_dtype(t)) for t in self._input_tdtypes]
        # output free-dim slicing comes with an explicit free ladder only
        self._slice_free = free_dim_buckets is not None
        free = [tuple(tuple(int(d) for d in shp) for shp in entry)
                for entry in (free_dim_buckets or [base_free])]
        for entry in free:
            if len(entry) != len(self._input_names):
                raise MXNetError('free_dim_buckets entries need one free '
                                 'shape per input (%d)'
                                 % len(self._input_names))
        self._free_buckets = sorted(set(free), key=lambda e: (
            tuple(int(np.prod(s)) if s else 1 for s in e), e))
        # per output axis: does it mirror a padded input axis (slice it
        # back) or is it a fixed model dim that equals the bucket extent
        # (never slice)? An axis that varies across rungs mirrors
        self._mirror_masks = {}
        if self._slice_free and len(self._free_buckets) > 1:
            b = self.max_batch
            outs = {}
            for e in self._free_buckets:
                shapes = {n: (b,) + f
                          for n, f in zip(self._input_names, e)}
                outs[e] = self._symbol.infer_shape(**shapes)[1]
            ref = self._free_buckets[-1]
            alt = self._free_buckets[0]
            for e in self._free_buckets:
                other = outs[alt if e == ref else ref]
                self._mirror_masks[e] = [
                    tuple(d1 != d2 for d1, d2 in zip(s1[1:], s2[1:]))
                    for s1, s2 in zip(outs[e], other)]
        # the card's streams: the walk's, the staging copies' and the
        # completion copies'
        if self._device.type == 'cuda':
            self._stream = torch.cuda.Stream(self._device)
            self._stage_stream = torch.cuda.Stream(self._device)
            self._copy_stream = torch.cuda.Stream(self._device)
        else:
            self._stream = self._stage_stream = self._copy_stream = None
        self._programs = {}             # (batch, free_entry) -> _Program
        # serializes rung creation and each rung's first call: warmup()
        # on a live warmup=False engine runs beside the dispatcher
        self._prog_lock = threading.Lock()
        self._queues = OrderedDict()    # free_entry -> deque of _Request
        self._qrows = {}                # free_entry -> queued row count
        self._n_queued = 0              # queued requests
        self._n_queued_rows = 0         # queued rows (backlog_rows)
        self._cond = threading.Condition()
        self._inflight = deque()        # dispatched batches, or None
        self._inflight_cond = threading.Condition()
        self._depth = max(1, int(depth))
        self._closed = False
        self._started = False
        self._close_lock = threading.Lock()
        # lifetime counters of this engine
        self._lock = threading.Lock()
        self._inflight_rows = 0         # coalesced rows not yet answered
        self._n_requests = 0
        self._n_batches = 0
        self._n_rows = 0
        self._n_padded_rows = 0
        self._fill_sum = 0.0
        self._local_lats = []           # bounded latency ring (ms)
        self._local_lat_pos = 0
        self._qd_sum = 0
        self._qd_obs = 0
        self._svc_ms_ema = None
        self._rows_per_batch_ema = None
        self._host_ms = {k: 0.0 for k in _HOST_SPLITS}
        self._host_obs = 0
        self._rung_builds = 0           # rungs bound by this engine
        self._rung_build_s = 0.0        # their bind and first-call time
        self._warm_snapshot = None
        if quantize is None:
            quantize = QuantConfig.from_env()
        elif quantize is False:
            quantize = None
        self._quant = QuantConfig.resolve(quantize)
        self._quant_names = ()          # quantized weight names
        self._quant_scales = {}         # name -> device scale (int8)
        self._quant_scale_vals = ()     # scales in weight order
        self._quant_orig_dtype = {}     # name -> torch dtype
        self._quant_live = False        # serve functions dequantize
        self._quant_parity = None       # the gate's measured difference
        self._hotrows = OrderedDict()   # weight name -> _HotRowTable
        self._hotrow_shapes = {}        # weight name -> (C, dim)
        if self._quant is not None:
            self._setup_quantization(calibrate)
        # after quantization: eligibility sees the swapped dtypes
        if hot_rows:
            self._setup_hotrows(hot_rows)
        pf = os.environ.get('MXNET_TPU_SERVE_HOTROW_PREFETCH',
                            '').strip().lower()
        if pf in ('0', 'off', 'none', 'false'):
            self._hotrow_peek = 0
        else:
            try:
                self._hotrow_peek = int(pf) if pf else 8
            except ValueError:
                self._hotrow_peek = 8
        if warmup:
            self.warmup()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name='mxt-serve-dispatch',
            daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name='mxt-serve-complete',
            daemon=True)
        self._dispatcher.start()
        self._completer.start()
        self._started = True

    # ------------------------------------------------------------------
    # the card's streams
    # ------------------------------------------------------------------
    def _on_stream(self):
        """The engine's compute stream as the calling thread's current
        stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _join_caller_stream(self):
        """Order the compute stream after the calling thread's stream, on
        which the weights (and quantized codes) were written."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(
                self._device))

    def _to_device(self, host):
        """Host input arrays as tensors on the engine's device, in the
        bound dtypes, ready to read on the current stream."""
        dvals = mxio.stage_to_device(host, device=self._device,
                                     stream=self._stage_stream)
        return [v if v.dtype == dt else v.to(dt)
                for v, dt in zip(dvals, self._input_tdtypes)]

    # ------------------------------------------------------------------
    # bucket ladder
    # ------------------------------------------------------------------
    def _pick_free_bucket(self, free_shapes):
        """Smallest configured free-dim entry covering the request's free
        shapes elementwise. Without an explicit free ladder only the
        bound shapes are taken: padding free dims is model-dependent."""
        if not self._slice_free:
            if free_shapes == self._free_buckets[0]:
                return free_shapes
            raise MXNetError('request free dims %r != bound %r: '
                             'free-dim padding is model-dependent and '
                             'needs an explicit free_dim_buckets '
                             'opt-in (a single entry at the bound '
                             'shape suffices)'
                             % (free_shapes, self._free_buckets[0]))
        for entry in self._free_buckets:
            ok = True
            for want, have in zip(free_shapes, entry):
                if len(want) != len(have) or \
                        any(w > h for w, h in zip(want, have)):
                    ok = False
                    break
            if ok:
                return entry
        raise MXNetError('no free-dim bucket covers request shapes %r '
                         '(ladder: %r)'
                         % (free_shapes, self._free_buckets))

    def _pick_batch_bucket(self, rows):
        for b in self.batch_buckets:
            if rows <= b:
                return b
        return self.batch_buckets[-1]

    def _program(self, batch, free_entry):
        """The (batch x free) rung's executor and serve function, built on
        first use and counted as one of this engine's rung builds. The
        serve function is looked up in exec_cache under the rung
        executor's signature, so an equivalent engine shares it; the
        executor is bound here all the same."""
        key = (batch, free_entry)
        with self._prog_lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            t0 = time.perf_counter()
            shapes = {n: (batch,) + f
                      for n, f in zip(self._input_names, free_entry)}
            # a hot-row table binds at its (C, dim) cache shape, sharing
            # the base executor's buffer the dispatcher pages into
            shapes.update(self._hotrow_shapes)
            ex = self._symbol.simple_bind(self._ctx, grad_req='null',
                                          shared_exec=self._base_ex,
                                          **shapes)
            embed_tok = tuple((n, st.capacity)
                              for n, st in self._hotrows.items()) or None
            prog = _Program(ex, _make_serve_fn(ex, self._input_names,
                                               quant=self._quant_info(),
                                               embed=embed_tok),
                            [n for n in ex.arg_dict
                             if n not in self._input_names],
                            batch, free_entry)
            self._programs[key] = prog
            with self._lock:
                self._rung_builds += 1
                self._rung_build_s += time.perf_counter() - t0
            return prog

    # ------------------------------------------------------------------
    # weight-storage quantization
    # ------------------------------------------------------------------
    def _quant_info(self):
        """(config, quantized names, original dtypes) once the swap is
        live, else None."""
        if not self._quant_live:
            return None
        return (self._quant, frozenset(self._quant_names),
                dict(self._quant_orig_dtype))

    def _calibration_inputs(self, calibrate, batch, entry):
        """Host input batches of the parity gate: the caller's
        `calibrate` samples padded or truncated to the gate's shape, else
        one seeded unit-gaussian batch."""
        shapes = [(batch,) + f for f in entry]
        if not calibrate:
            rng = np.random.RandomState(0)
            return [[rng.randn(*s).astype(dt)
                     for s, dt in zip(shapes, self._input_dtypes)]]
        out = []
        for b in list(calibrate)[:4]:
            arrays = [b] if not isinstance(b, (tuple, list)) else list(b)
            if len(arrays) != len(self._input_names):
                raise MXNetError('calibrate batch has %d arrays, model '
                                 'has %d inputs' % (len(arrays),
                                                    len(self._input_names)))
            host = []
            for a, s, dt in zip(arrays, shapes, self._input_dtypes):
                a = np.asarray(a.asnumpy() if hasattr(a, 'asnumpy')
                               else a, dtype=dt)
                buf = np.zeros(s, dt)
                sl = tuple(slice(0, min(w, h))
                           for w, h in zip(a.shape, s))
                buf[sl] = a[sl]
                host.append(buf)
            out.append(host)
        return out

    def _setup_quantization(self, calibrate):
        """Quantize the matmul and conv weights in place, gated by fp
        parity: run the calibration batches through the top rung in fp,
        quantize, swap the weight arrays to the codes, run the same
        batches through the quantized program and compare. Over
        QuantConfig.parity_tol the swap is undone and QuantParityError
        raised: a refused engine mutates nothing."""
        cfg = self._quant
        ex = self._base_ex
        names = [n for n in ex.arg_dict
                 if n not in self._input_names and
                 cfg.wants(ex.arg_dict[n].shape, ex.arg_dict[n]._data.dtype)]
        if not names:
            raise MXNetError(
                'quantize=%r: no quantizable weights (need float32 (or, '
                'for int8, 16-bit float) arrays with >= %d elements and '
                '>= %d dims; biases and small vectors stay fp)'
                % (cfg.dtype, cfg.min_size, cfg.min_ndim))
        batch, entry = self.max_batch, self._free_buckets[-1]
        batches = self._calibration_inputs(calibrate, batch, entry)

        def run_gate(prog):
            outs = []
            self._join_caller_stream()
            with self._on_stream():
                for host in batches:
                    o = self._run(prog, self._to_device(host))
                    outs.append([v.float().cpu() for v in o])
            return outs

        fp_out = run_gate(self._program(batch, entry))
        quantized, _ = quantization.quantize_weights(
            {n: ex.arg_dict[n]._data.detach() for n in names}, cfg)
        scales = {}
        for n, (q, s, orig) in quantized.items():
            self._quant_orig_dtype[n] = ex.arg_dict[n]._data.dtype
            if s is not None and cfg.per_channel:
                s = s.reshape((-1,) + (1,) * (q.ndim - 1))
            scales[n] = s
        # the swap is in place: every rung executor shares these NDArrays;
        # the fp rungs are dropped, the quantized ones bind the codes, so
        # their signatures (and program keys) are the quantized ones
        orig = {n: ex.arg_dict[n]._data for n in names}
        for n in names:
            ex.arg_dict[n]._data = quantized[n][0]
        self._quant_names = tuple(names)
        self._quant_scales = scales
        self._quant_scale_vals = tuple(scales[n] for n in names
                                       if scales[n] is not None)
        self._quant_live = True
        self._programs.clear()
        try:
            q_out = run_gate(self._program(batch, entry))
        except Exception:
            self._undo_quant_swap(orig)
            raise
        worst = 0.0
        for fo, qo in zip(fp_out, q_out):
            for f, q in zip(fo, qo):
                spread = float(f.abs().max()) or 1.0
                worst = max(worst, float((f - q).abs().max()) / spread)
        if not worst <= cfg.parity_tol:
            self._undo_quant_swap(orig)
            raise QuantParityError(
                'engine over %d-input source' % len(self._input_names),
                worst, cfg.parity_tol)
        self._quant_parity = worst

    def _undo_quant_swap(self, orig):
        for n, v in orig.items():
            self._base_ex.arg_dict[n]._data = v
        self._quant_live = False
        self._quant_names = ()
        self._quant_scales = {}
        self._quant_scale_vals = ()
        self._quant_orig_dtype = {}
        self._programs.clear()

    # ------------------------------------------------------------------
    # the hot-row embedding cache
    # ------------------------------------------------------------------
    def _setup_hotrows(self, spec):
        """Swap each selected Embedding table for a (C, dim) buffer on the
        card, the full table moving to (pinned) host memory; every rung
        executor binds the buffer through shared_exec. Runs before any
        rung exists."""
        from .parallel import embedding as embed_mod
        if isinstance(spec, dict):
            req = {str(k): int(v) for k, v in spec.items()}
            blanket = None
        else:
            req, blanket = {}, int(spec)
        groups = OrderedDict()          # weight -> its lookups
        for t in embed_mod.find_symbol_tables(self._symbol,
                                              sparse_only=False):
            g = groups.setdefault(t['weight'], {
                'ids': [], 'vocab': t['vocab'], 'dim': t['dim'],
                'why': None})
            if t['ids_input'] is None:
                g['why'] = 'its ids are graph-derived'
            elif t['ids_input'] not in self._input_names:
                g['why'] = ('its ids input %r is not an engine input'
                            % t['ids_input'])
            else:
                idx = self._input_names.index(t['ids_input'])
                if idx not in g['ids']:
                    g['ids'].append(idx)
        unknown = set(req) - set(groups)
        if unknown:
            raise MXNetError('hot_rows: %s are not Embedding weights of '
                             'this model (tables: %s)'
                             % (sorted(unknown), sorted(groups)))
        for name, g in groups.items():
            cap = req.get(name, blanket)
            if cap is None:
                continue
            if g['why'] is not None:
                if name in req:
                    raise MXNetError(
                        'hot_rows[%r]: table is not cacheable: %s (the '
                        'dispatcher can only remap ids it receives)'
                        % (name, g['why']))
                continue
            if name in self._quant_names:
                raise MXNetError(
                    'hot_rows[%r]: table is weight-quantized; the hot '
                    'buffer pages fp rows: exclude the table via the '
                    'hot_rows dict form or pass quantize=False' % name)
            vocab, dim = g['vocab'], g['dim']
            cap = min(int(cap), vocab)
            # one coalesced dispatch must fit: max_batch rows times the
            # ids input's largest free extent, over the table's lookups
            worst = min(vocab, max(
                sum(self.max_batch * (int(np.prod(entry[k])) if entry[k]
                                      else 1) for k in g['ids'])
                for entry in self._free_buckets))
            if cap < worst:
                raise MXNetError(
                    'hot_rows[%r]: capacity %d < worst-case %d distinct '
                    'ids per dispatch (max_batch %d x the ids free '
                    'extent): a single batch could not be served from '
                    'the cache' % (name, cap, worst, self.max_batch))
            arg = self._base_ex.arg_dict[name]
            host = _host_table(arg._data.detach().to('cpu'), self._device)
            # rungs share this NDArray, and so the buffer
            arg._data = torch.zeros((cap, dim), dtype=host.dtype,
                                    device=self._device)
            self._hotrows[name] = _HotRowTable(name, tuple(g['ids']), vocab,
                                               dim, cap, host, arg)
            self._hotrow_shapes[name] = (cap, dim)
        if not self._hotrows:
            raise MXNetError('hot_rows: no cacheable Embedding tables (need '
                             'a table whose ids arrive as an engine input)')
        claimed = {}
        for st in self._hotrows.values():
            for k in st.ids_idx:
                if k in claimed:
                    raise MXNetError(
                        'hot_rows: input %r feeds both table %r and %r: '
                        'one ids array cannot be remapped onto two caches; '
                        'exclude one via the dict form'
                        % (self._input_names[k], claimed[k], st.name))
                claimed[k] = st.name
        self._programs.clear()

    def _page_in(self, st, missing, slots):
        """Write the host rows `missing` into `slots` of the table's
        buffer, in place on the current (compute) stream."""
        idx = torch.as_tensor(np.asarray(missing, np.int64))
        rows = st.host.index_select(0, idx)
        dev = self._device
        if dev.type == 'cuda':
            rows = rows.pin_memory().to(dev, non_blocking=True)
        slots = torch.as_tensor(np.asarray(slots, np.int64)).to(
            dev, non_blocking=dev.type == 'cuda')
        st.arg._data.index_copy_(0, slots, rows)

    @staticmethod
    def _claim_slots(st, missing, victims):
        """A slot for each of `missing`: a free one, else the next of
        `victims` (resident ids) evicted."""
        slots = []
        for _u in missing:
            if st.free:
                slots.append(st.free.pop())
            else:
                v = next(victims)
                slots.append(st.resident.pop(v))
                st.prefetched.discard(v)
                st.evictions += 1
        return slots

    @staticmethod
    def _table_ids(st, arrays):
        """Each of the table's id inputs in `arrays` as clipped int64."""
        out = []
        for k in st.ids_idx:
            a = np.asarray(arrays[k])
            ids = a.astype(np.int64) if a.dtype.kind in 'iu' \
                else np.rint(a).astype(np.int64)
            np.clip(ids, 0, st.vocab - 1, out=ids)
            out.append(ids)
        return out

    def _hotrow_remap(self, host):
        """The dispatcher's step (its thread alone touches the LRU): map
        each table's batch ids onto cache slots, paging missing rows in
        first. Returns a new host list (the caller's arrays are not
        written)."""
        out = list(host)
        ev_batch = miss_batch = hit_batch = pf_batch = 0
        for st in self._hotrows.values():
            per_k = self._table_ids(st, host)
            flat = np.concatenate([i.ravel() for i in per_k])
            uniq, inv = np.unique(flat, return_inverse=True)
            uniq_l = uniq.tolist()
            curset = set(uniq_l)
            missing = [u for u in uniq_l if u not in st.resident]
            hits = len(uniq_l) - len(missing)
            slots_new = []
            if missing:
                evictions = st.evictions
                # the capacity covers one batch: a victim always exists
                slots_new = self._claim_slots(
                    st, missing,
                    (u for u in list(st.resident) if u not in curset))
                ev_batch += st.evictions - evictions
                self._page_in(st, missing, slots_new)
            for u in uniq_l:
                if u in st.resident:
                    st.resident.move_to_end(u)
                    if u in st.prefetched:
                        st.prefetched.discard(u)
                        st.prefetch_hits += 1
                        pf_batch += 1
            for u, slot in zip(missing, slots_new):
                st.resident[u] = slot
            st.hits += hits
            st.misses += len(missing)
            hit_batch += hits
            miss_batch += len(missing)
            slot_per_uniq = np.asarray([st.resident[u] for u in uniq_l],
                                       np.int64)
            remapped = slot_per_uniq[inv.reshape(-1)]
            off = 0
            for k, ids in zip(st.ids_idx, per_k):
                n = ids.size
                out[k] = remapped[off:off + n].reshape(ids.shape).astype(
                    np.asarray(host[k]).dtype)
                off += n
        profiler.add_embed_stats(
            hits=hit_batch, misses=miss_batch, evictions=ev_batch,
            prefetch_hits=pf_batch,
            resident_bytes=sum(st.capacity * st.dim *
                               st.host.element_size()
                               for st in self._hotrows.values()))
        return out

    def _hotrow_prefetch(self, peek):
        """Page the rows of still-queued requests (their input tuples,
        `peek`) in behind the batch just launched: at most the free
        slots, and by eviction at most the LRU half of the cache, never
        a row a queued request wants."""
        for st in self._hotrows.values():
            ids = [i.ravel() for inputs in peek
                   for i in self._table_ids(st, inputs)]
            if not ids:
                continue
            uniq = np.unique(np.concatenate(ids)).tolist()
            missing = [u for u in uniq if u not in st.resident]
            curset = set(uniq)
            evictable = [u for u in st.resident if u not in curset]
            budget = min(max(len(st.free), st.capacity // 2),
                         len(st.free) + len(evictable))
            missing = missing[:budget]
            if not missing:
                continue
            slots_new = self._claim_slots(st, missing, iter(evictable))
            self._page_in(st, missing, slots_new)
            # an untouched guess is the first row demand reclaims
            for u, slot in zip(missing, slots_new):
                st.resident[u] = slot
                st.resident.move_to_end(u, last=False)
                st.prefetched.add(u)
                st.prefetch_rows += 1
            profiler.add_embed_stats(prefetched=len(missing))

    def resident_bytes(self):
        """Bytes the engine's weights and aux states hold on the device
        (int8 codes count 1 byte each), plus the dequantization
        scales."""
        ex = self._base_ex
        total = 0
        for d in (ex.arg_dict, ex.aux_dict):
            for n, a in d.items():
                if n in self._input_names:
                    continue
                total += a._data.numel() * a._data.element_size()
        for s in self._quant_scales.values():
            if s is not None:
                total += s.numel() * s.element_size()
        return total

    # -- in-place weight deltas (the delta push channel) ----------------
    def _resident_host_state(self):
        """The resident weights as a flat {'arg:NAME'/'aux:NAME': host
        array} state (the serving_state key space: a loss head's label
        argument is left out). Quantized weights dequantize back to their
        original dtype (lossy: apply_delta exempts them from the crc
        gate)."""
        from . import _hostarray as ha
        ex = self._base_ex
        state = {}
        for prefix, d in (('arg:', ex.arg_dict), ('aux:', ex.aux_dict)):
            for n, a in d.items():
                if n in self._input_names or \
                        (prefix == 'arg:' and n in self._label_names):
                    continue
                if prefix == 'arg:' and n in self._hotrows:
                    state[prefix + n] = self._hotrows[n].host.numpy()
                elif prefix == 'arg:' and n in self._quant_names:
                    codes = a._data
                    s = self._quant_scales[n]
                    dt = self._quant_orig_dtype.get(n, torch.float32)
                    if s is None:       # bf16 swap: a plain cast back
                        v = codes.to(dt)
                    else:
                        v = (codes.float() * s).to(dt)
                    state[prefix + n] = ha.host(v)
                else:
                    state[prefix + n] = ha.host(a._data)
        return state

    def apply_delta(self, entries, meta, expect_fp=None, parity_tol=None):
        """Apply one weight delta (delta.make_delta's output, or a
        shipped delta payload) to the resident weights, with no re-warm:
        each rung reads its weight tensors at every dispatch, so
        swapping them updates every rung.

        Every gate runs before anything changes: a base-fingerprint
        mismatch or a crc divergence raises DeltaChainError, a lossy
        delta whose rel_err exceeds `parity_tol` DeltaParityError, and
        the engine then serves its previous weights bit for bit.
        Quantized weights are requantized through the engine's own
        QuantConfig (codes and scales swap together). parity_tol
        defaults to the QuantConfig's (the DeltaConfig default for an
        fp engine). Returns the delta's new_fp."""
        from . import _hostarray as ha
        from . import delta as delta_mod
        if self._closed:
            raise MXNetError('InferenceEngine is closed')
        if parity_tol is None:
            parity_tol = (self._quant.parity_tol
                          if self._quant is not None
                          else delta_mod.DeltaConfig().parity_tol)
        state = self._resident_host_state()
        lossy = {'arg:' + n for n in self._quant_names}
        new_state = delta_mod.apply_delta(
            state, meta, entries, expect_fp=expect_fp,
            parity_tol=parity_tol, skip_crc=lossy)
        ex = self._base_ex
        resolved = []
        for key in meta.get('entries', {}):
            if key.startswith('arg:'):
                n, d = key[4:], ex.arg_dict
            elif key.startswith('aux:'):
                n, d = key[4:], ex.aux_dict
            else:
                raise delta_mod.DeltaChainError(
                    'delta entry %r is not in the serving key space '
                    "('arg:'/'aux:')" % key)
            if n not in d:
                raise delta_mod.DeltaChainError(
                    'delta touches %r which this engine does not hold'
                    % key)
            resolved.append((key, n, d))
        for key, n, d in resolved:
            new = ha.to_tensor(new_state[key])
            if d is ex.arg_dict and n in self._hotrows:
                st = self._hotrows[n]
                st.host = _host_table(new.to(st.host.dtype), self._device)
                # the rows the delta touched leave the cache: the next
                # dispatch that wants them pages the new values in
                ids = entries.get(delta_mod._KIND_IDS + key)
                if ids is None:
                    st.resident.clear()
                    st.prefetched.clear()
                    st.free = list(range(st.capacity))
                else:
                    for u in np.asarray(ids).ravel().tolist():
                        slot = st.resident.pop(int(u), None)
                        if slot is not None:
                            st.free.append(slot)
                        st.prefetched.discard(int(u))
            elif d is ex.arg_dict and n in self._quant_names:
                quantized, _ = quantization.quantize_weights(
                    {n: new.to(self._device)}, self._quant)
                q, sc, _orig = quantized[n]
                d[n]._data = q
                if sc is None:
                    self._quant_scales[n] = None
                else:
                    if self._quant.per_channel:
                        sc = sc.reshape((-1,) + (1,) * (q.ndim - 1))
                    self._quant_scales[n] = sc
            else:
                a = d[n]
                d[n]._data = new.to(a._data.device, a._data.dtype)
        if self._quant_names:
            self._quant_scale_vals = tuple(
                self._quant_scales[n] for n in self._quant_names
                if self._quant_scales[n] is not None)
        if self._device.type == 'cuda':
            # the copies ran on this thread's stream: done before any
            # dispatch reads them
            torch.cuda.current_stream(self._device).synchronize()
        profiler.add_delta_stats(applied=1)
        return meta.get('new_fp')

    def warmup(self):
        """Run every ladder rung (batch buckets x free-dim buckets) once,
        then snapshot this engine's rung-build counters: traffic after
        this builds no rung (stats()['compiles_after_warmup'] stays 0)."""
        if self._closed:
            raise MXNetError('InferenceEngine is closed')
        self._join_caller_stream()
        with self._on_stream():
            for free_entry in self._free_buckets:
                for b in self.batch_buckets:
                    prog = self._program(b, free_entry)
                    dvals = [torch.full((b,) + f, self.pad_value, dtype=dt,
                                        device=self._device)
                             for f, dt in zip(free_entry,
                                              self._input_tdtypes)]
                    self._run(prog, dvals)
        if self._stream is not None:
            self._stream.synchronize()
        if self._quant_live:
            profiler.add_quant_stats(
                int8_rungs_warmed=len(self._free_buckets) *
                len(self.batch_buckets))
        with self._lock:
            self._warm_snapshot = (self._rung_builds, self._rung_build_s)
        return self

    def _run(self, prog, dvals):
        """Launch the rung's walk on the current stream; returns its
        output tensors (not yet computed on the card)."""
        ex = prog.executor
        weights = [ex.arg_dict[n]._data for n in prog.weight_names]
        aux = [a._data for a in ex.aux_dict.values()]
        if self._quant_live:
            args = (ex, dvals, weights, self._quant_scale_vals, aux)
        else:
            args = (ex, dvals, weights, aux)
        if prog.warmed:
            return prog.serve_fn(*args)
        with self._prog_lock:
            if prog.warmed:
                return prog.serve_fn(*args)
            t0 = time.perf_counter()
            out = prog.serve_fn(*args)
            with self._lock:
                self._rung_build_s += time.perf_counter() - t0
            # slicing takes axis 0 of every output as the request batch: a
            # batch-reducing model (a sum over rows) would hand each
            # caller the co-batched aggregate, so the rung's first call
            # refuses it
            for i, o in enumerate(out):
                if o.ndim == 0 or o.shape[0] != prog.batch:
                    raise MXNetError(
                        'InferenceEngine requires row-independent '
                        'outputs with a leading batch dim: output %d '
                        'has shape %r at bucket batch %d; a '
                        'batch-reducing model would mix co-batched '
                        'requests' % (i, tuple(o.shape), prog.batch))
            prog.warmed = True
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def infer(self, *pos_inputs, **named_inputs):
        """Submit one request (thread-safe) and wait for its outputs.
        Inputs: positional in input-name order, or named; each an
        np.ndarray or NDArray with a leading batch dim (rows may exceed
        max_batch: the request is split and its answers joined). Returns
        a list of np.ndarrays, one per model output, with the request's
        own rows."""
        return self.submit(*pos_inputs, **named_inputs)()

    def submit(self, *pos_inputs, **named_inputs):
        """Enqueue one request as infer() does and return at once a
        function that waits for its outputs. A request enqueued before a
        close() is answered: close drains the queue."""
        if self._closed:
            raise MXNetError('InferenceEngine is closed')
        arrays = self._canonical_inputs(pos_inputs, named_inputs)
        rows = arrays[0].shape[0]
        if any(a.shape[0] != rows for a in arrays):
            raise MXNetError('inputs disagree on batch size')
        if rows == 0:
            raise MXNetError('empty request')
        # an oversized request's chunks are all enqueued before the first
        # wait, so they pipeline through the in-flight queue
        reqs = self._submit_all(
            [[a[i:i + self.max_batch] for a in arrays]
             for i in range(0, rows, self.max_batch)])

        def wait():
            for r in reqs:
                r.event.wait()
            for r in reqs:
                if r.error is not None:
                    raise r.error
            if len(reqs) == 1:
                return reqs[0].outputs
            return [np.concatenate([r.outputs[k] for r in reqs], axis=0)
                    for k in range(len(reqs[0].outputs))]
        return wait

    def _submit_all(self, chunks):
        """Enqueue a request's chunks in one lock hold, every bucket pick
        (which can raise) done before the first enqueue: a concurrent
        close() sees the whole request or none of it."""
        staged = []
        for arrays in chunks:
            free_shapes = tuple(tuple(a.shape[1:]) for a in arrays)
            entry = self._pick_free_bucket(free_shapes)
            staged.append(
                (entry, _Request(arrays, arrays[0].shape[0],
                                 free_shapes)))
        with self._cond:
            if self._closed:
                raise MXNetError('InferenceEngine is closed')
            wake = False
            self._n_queued += len(staged)
            self._n_queued_rows += sum(req.rows for _, req in staged)
            for entry, req in staged:
                q = self._queues.setdefault(entry, deque())
                q.append(req)
                rows = self._qrows.get(entry, 0) + req.rows
                self._qrows[entry] = rows
                # wake the dispatcher only when its decision can change:
                # a group became non-empty or can flush full
                if len(q) == 1 or rows >= self.max_batch:
                    wake = True
            if wake:
                self._cond.notify_all()
        return [req for _, req in staged]

    def predict(self, *pos_inputs, **named_inputs):
        """The first model output of infer() as an np.ndarray."""
        return self.infer(*pos_inputs, **named_inputs)[0]

    def _canonical_inputs(self, pos_inputs, named_inputs):
        if pos_inputs and named_inputs:
            raise MXNetError('pass inputs positionally or by name, '
                             'not both')
        if pos_inputs:
            if len(pos_inputs) != len(self._input_names):
                raise MXNetError('expected %d inputs, got %d'
                                 % (len(self._input_names),
                                    len(pos_inputs)))
            vals = list(pos_inputs)
        else:
            extra = set(named_inputs) - set(self._input_names)
            if extra:
                raise MXNetError('unknown input(s) %s (model inputs: %s)'
                                 % (sorted(extra), self._input_names))
            try:
                vals = [named_inputs[n] for n in self._input_names]
            except KeyError as e:
                raise MXNetError('missing input %s' % e)
        out = []
        for v, dt in zip(vals, self._input_dtypes):
            a = v.asnumpy() if hasattr(v, 'asnumpy') else np.asarray(v)
            out.append(np.ascontiguousarray(a, dtype=dt))
        return out

    def stats(self):
        """This engine's serving counters and the zero-build check.
        compiles_after_warmup / compile_s_after_warmup are the rungs this
        engine bound since its warmup() and the host seconds of their
        binds and first calls: 0 proves this engine built no rung after
        it, whatever other engines in the process build. service_ms_ema
        is a batch's walk as the card's compute stream sees it, between
        two CUDA events (the gaps while the host launches included), and
        the walk's host time on the CPU. The
        serve_* keys are the process-global profiler's; the rest (latency
        p50/p99, fill, queue depth, service-ms EMA, host_ms) are this
        engine's."""
        with self._lock:
            lats = list(self._local_lats)
            out = {
                'requests': self._n_requests,
                'batches': self._n_batches,
                'rows': self._n_rows,
                'padded_rows': self._n_padded_rows,
                'batch_fill_avg': (self._fill_sum / self._n_batches
                                   if self._n_batches else 0.0),
                'pad_waste_frac': (self._n_padded_rows /
                                   (self._n_rows + self._n_padded_rows)
                                   if self._n_rows else 0.0),
                'queue_depth_avg': (self._qd_sum / self._qd_obs
                                    if self._qd_obs else 0.0),
                'service_ms_ema': self._svc_ms_ema or 0.0,
                'rows_per_batch_ema': self._rows_per_batch_ema or 0.0,
                'host_ms': {k: (v / self._host_obs if self._host_obs
                                else 0.0)
                            for k, v in self._host_ms.items()},
            }
        out['latency_p50_ms'] = \
            float(np.percentile(lats, 50)) if lats else 0.0
        out['latency_p99_ms'] = \
            float(np.percentile(lats, 99)) if lats else 0.0
        out['backlog_rows'] = self.backlog_rows()
        if self._quant_live:
            out['quantized'] = self._quant.describe()
            out['quantized']['weights'] = len(self._quant_names)
            out['quantized']['parity_measured'] = self._quant_parity
            out['resident_bytes'] = self.resident_bytes()
        if self._hotrows:
            hr = {}
            for name, st in self._hotrows.items():
                tot = st.hits + st.misses
                item = st.host.element_size()
                hr[name] = {
                    'capacity': st.capacity,
                    'resident': len(st.resident),
                    'hits': st.hits,
                    'misses': st.misses,
                    'evictions': st.evictions,
                    'hit_rate': st.hits / tot if tot else 0.0,
                    'resident_bytes': st.capacity * st.dim * item,
                    'table_bytes': st.vocab * st.dim * item,
                    'prefetch_rows': st.prefetch_rows,
                    'prefetch_hits': st.prefetch_hits,
                }
            out['hot_rows'] = hr
        with self._lock:
            snap = self._warm_snapshot
            if snap is not None:
                out['compiles_after_warmup'] = self._rung_builds - snap[0]
                out['compile_s_after_warmup'] = round(
                    self._rung_build_s - snap[1], 6)
        out.update(profiler.serving_stats())
        return out

    def backlog_rows(self):
        """Rows queued or coalesced but not answered yet."""
        with self._cond:
            queued = self._n_queued_rows
        with self._lock:
            return queued + self._inflight_rows

    def service_estimate(self):
        """(service_ms_per_batch, rows_per_batch) EMAs of this engine, or
        None before any batch completed; rows_per_batch >= 1."""
        with self._lock:
            if self._svc_ms_ema is None:
                return None
            return (self._svc_ms_ema,
                    max(1.0, self._rows_per_batch_ema))

    # ------------------------------------------------------------------
    # batcher (dispatcher thread)
    # ------------------------------------------------------------------
    def _oldest_group(self):
        """The free-dim group whose head request has waited longest."""
        best, best_t = None, None
        for entry, q in self._queues.items():
            if q and (best_t is None or q[0].t_enq < best_t):
                best, best_t = entry, q[0].t_enq
        return best

    def _coalesce_locked(self, entry):
        """Pop requests of one group up to max_batch rows."""
        q = self._queues[entry]
        reqs, rows = [], 0
        while q and rows + q[0].rows <= self.max_batch:
            r = q.popleft()
            reqs.append(r)
            rows += r.rows
        self._qrows[entry] = self._qrows.get(entry, 0) - rows
        self._n_queued -= len(reqs)
        self._n_queued_rows -= rows
        # the rows stay in backlog_rows until their answers are back
        with self._lock:
            self._inflight_rows += rows
        return reqs, rows

    def _dispatch_loop(self):
        with self._on_stream():
            while True:
                with self._cond:
                    while not self._closed and not any(
                            self._queues.values()):
                        self._cond.wait()
                    if self._closed and not any(self._queues.values()):
                        break
                    entry = self._oldest_group()
                    # hold the batch open up to max_wait_us while it is
                    # underfull and more traffic may coalesce
                    deadline = self._queues[entry][0].t_enq + \
                        self.max_wait_us / 1e6
                    while not self._closed:
                        rows = self._qrows.get(entry, 0)
                        left = deadline - time.perf_counter()
                        if rows >= self.max_batch or left <= 0:
                            break
                        # another group full now goes first
                        full = next(
                            (e for e, q in self._queues.items()
                             if e != entry and
                             self._qrows.get(e, 0) >= self.max_batch),
                            None)
                        if full is not None:
                            entry = full
                            break
                        self._cond.wait(timeout=left)
                    depth = self._n_queued
                    reqs, rows = self._coalesce_locked(entry)
                    # the still-queued heads' inputs (frozen at submit),
                    # whose hot rows page in behind this batch
                    peek = None
                    if self._hotrows and self._hotrow_peek:
                        peek = [r.inputs for q in self._queues.values()
                                for r in q][:self._hotrow_peek]
                if not reqs:
                    continue
                try:
                    self._launch(entry, reqs, rows, depth, peek)
                except Exception as e:       # raised to each caller
                    with self._lock:
                        self._inflight_rows -= rows
                    for r in reqs:
                        r.error = e
                        r.event.set()
        # drain: wake the completer with a sentinel
        with self._inflight_cond:
            self._inflight.append(None)
            self._inflight_cond.notify_all()

    def _launch(self, entry, reqs, rows, depth, peek=None):
        """Assemble the padded host batch, stage it, launch the walk and
        record its completion event. The bounded in-flight queue lets
        batch N+1 stage and launch while the completion thread drains
        batch N."""
        t0 = time.perf_counter()
        bucket = self._pick_batch_bucket(rows)
        prog = self._program(bucket, entry)
        # exact fill: every element is a request's, so no pad fill; one
        # such request's arrays are the batch itself
        exact = rows == bucket and all(r.free_shapes == entry
                                       for r in reqs)
        if exact and len(reqs) == 1:
            host = reqs[0].inputs
        else:
            host = []
            for k, (f, dt) in enumerate(zip(entry, self._input_dtypes)):
                if exact:
                    buf = np.empty((bucket,) + f, dtype=dt)
                else:
                    buf = np.full((bucket,) + f, self.pad_value,
                                  dtype=dt)
                off = 0
                for r in reqs:
                    a = r.inputs[k]
                    sl = (slice(off, off + r.rows),) + tuple(
                        slice(0, d) for d in a.shape[1:])
                    buf[sl] = a
                    off += r.rows
                host.append(buf)
        if self._hotrows:
            host = self._hotrow_remap(host)
        t1 = time.perf_counter()
        with profiler.scope('serve_stage', 'serving'):
            dvals = self._to_device(host)
            t2 = time.perf_counter()
            start = done = None
            if self._stream is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
            outs = self._run(prog, dvals)
            if self._stream is not None:
                done = torch.cuda.Event(enable_timing=True)
                done.record(self._stream)
        if peek:
            # the queued requests' rows, paged in behind this walk
            self._hotrow_prefetch(peek)
        t3 = time.perf_counter()
        # the staged buffers: their memory waits for this walk
        # (record_stream in io.stage_to_device's take)
        del dvals
        offs = []
        off = 0
        for r in reqs:
            offs.append(off)
            off += r.rows
        pad_elems_frac = _pad_elem_frac(reqs, entry)
        with self._lock:
            for k, v in zip(_HOST_SPLITS[:3], (t1 - t0, t2 - t1, t3 - t2)):
                self._host_ms[k] += v * 1e3
        with self._inflight_cond:
            while len(self._inflight) >= self._depth and \
                    not self._closed:
                self._inflight_cond.wait()
            self._inflight.append(
                (prog, outs, start, done, (t3 - t2) * 1e3, reqs, offs,
                 rows, depth, pad_elems_frac))
            self._inflight_cond.notify_all()

    # ------------------------------------------------------------------
    # completion thread
    # ------------------------------------------------------------------
    def _host_outputs(self, outs, done):
        """The outputs as numpy arrays: on the card, copied on the copy
        stream after this batch's event (not after later batches)."""
        if self._copy_stream is None:
            return [o.float().numpy() if o.dtype == torch.bfloat16
                    else o.numpy() for o in outs]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            host = []
            for o in outs:
                o.record_stream(self._copy_stream)
                host.append(o.to('cpu', non_blocking=True))
        self._copy_stream.synchronize()
        return [h.float().numpy() if h.dtype == torch.bfloat16
                else h.numpy() for h in host]

    def _complete_loop(self):
        while True:
            with self._inflight_cond:
                while not self._inflight:
                    self._inflight_cond.wait()
                item = self._inflight.popleft()
                self._inflight_cond.notify_all()
            if item is None:
                break
            (prog, outs, start, done, svc_ms, reqs, offs, rows, depth,
             pad_frac) = item
            try:
                with profiler.scope('serve_complete', 'serving'):
                    if done is not None:
                        done.synchronize()
                        # the walk's span on the compute stream: from the
                        # staged inputs (and the batch before) being
                        # ready to its last kernel
                        svc_ms = start.elapsed_time(done)
                t1 = time.perf_counter()
                np_outs = self._host_outputs(outs, done)
                del outs
                now = time.perf_counter()
                masks = self._mirror_masks.get(prog.free_shapes)
                lats = []
                for r, off in zip(reqs, offs):
                    r.outputs = [_slice_out(o, off, r, prog,
                                            masks[k] if masks else None)
                                 for k, o in enumerate(np_outs)]
                    lats.append((now - r.t_enq) * 1e3)
                fill = rows / float(prog.batch)
                # the counters are committed before the callers wake: a
                # stats() right after infer() returns counts its batch
                with self._lock:
                    self._n_requests += len(reqs)
                    self._n_batches += 1
                    self._n_rows += rows
                    self._n_padded_rows += prog.batch - rows
                    self._fill_sum += fill
                    for lat in lats:
                        if len(self._local_lats) < _LOCAL_LAT_CAP:
                            self._local_lats.append(lat)
                        else:
                            self._local_lats[self._local_lat_pos] = lat
                            self._local_lat_pos = \
                                (self._local_lat_pos + 1) % _LOCAL_LAT_CAP
                    self._qd_sum += depth
                    self._qd_obs += 1
                    self._host_ms['complete_copy'] += (now - t1) * 1e3
                    self._host_obs += 1
                    a = _SVC_EMA_ALPHA
                    if self._svc_ms_ema is None:
                        self._svc_ms_ema = svc_ms
                        self._rows_per_batch_ema = float(rows)
                    else:
                        self._svc_ms_ema += a * (svc_ms -
                                                 self._svc_ms_ema)
                        self._rows_per_batch_ema += a * (
                            rows - self._rows_per_batch_ema)
                profiler.add_serving_stats(
                    requests=len(reqs), batches=1, rows=rows,
                    padded_rows=prog.batch - rows, fill=fill,
                    pad_elem_frac=pad_frac, queue_depth=depth,
                    latencies_ms=lats)
                for r in reqs:
                    r.event.set()
            except Exception as e:
                for r in reqs:
                    if not r.event.is_set():
                        r.error = e
                        r.event.set()
            finally:
                with self._lock:
                    self._inflight_rows -= rows

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def close(self, timeout=30):
        """Refuse new work, drain, join (idempotent, thread-safe):
        requests already queued are answered first; infer() after close
        raises."""
        with self._close_lock:
            if self._closed and not self._started:
                return self             # drained already
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            with self._inflight_cond:
                self._inflight_cond.notify_all()
            if self._started:
                self._dispatcher.join(timeout=timeout)
                self._completer.join(timeout=timeout)
                if self._dispatcher.is_alive() or \
                        self._completer.is_alive():
                    # keep _started, so that a later close() joins again
                    warnings.warn('InferenceEngine.close(): worker '
                                  'threads still running after %ss '
                                  '(dispatch wedged?); call close() '
                                  'again to re-join' % timeout)
                else:
                    self._started = False
        return self

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close(timeout=5)
        except Exception:       # interpreter teardown
            pass


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _label_args(ex):
    """The arguments that feed an op's 'label' input (a loss head's
    label): no weight, and in no checkpoint."""
    out = set()
    for node in ex._topo:
        if node.op is None:
            continue
        for name, (src, _i) in zip(node.op.input_names(node.attrs),
                                   node.inputs):
            if name == 'label' and src.op is None:
                out.add(src.name)
    return frozenset(out)


def _source_parts(source):
    """(executor, symbol, ctx, input_names) of a Predictor or a bound
    Module."""
    if hasattr(source, '_executor') and hasattr(source, '_input_names'):
        ex = source._executor
        return ex, source._symbol, source._ctx, list(source._input_names)
    if hasattr(source, '_exec_group') and source._exec_group is not None:
        ex = source._exec_group.executor
        return ex, source._symbol, ex._ctx, list(source.data_names)
    raise MXNetError('InferenceEngine needs a Predictor or a bound '
                     'Module, got %r' % (source,))


def _make_serve_fn(ex, input_names, quant=None, embed=None):
    """The rung's serve function, serve(ex, data_vals, weight_vals,
    aux_vals) -> outputs: the data values (in input_names order) and the
    weights (the other arguments, in argument order) merged into the
    argument list and walked by `ex.serve`. It holds no array, so it is
    shared process-wide through exec_cache under the rung's graph
    signature.

    `quant` ((config, quantized names, original dtypes) of a quantized
    engine) gives the form serve(ex, data_vals, weight_vals, scale_vals,
    aux_vals): the quantized weights arrive as codes and are
    dequantized to their original dtype before the walk (in float32, then
    cast), the int8 ones by their scales. The quant token joins the cache
    key."""
    input_set = set(input_names)
    names = list(ex.arg_dict)
    # data values come in input_names order, which need not be the
    # argument order (a Module's data_names is the caller's)
    data_pos = [names.index(n) for n in input_names]
    other_pos = [i for i, n in enumerate(names) if n not in input_set]
    other_names = [n for n in names if n not in input_set]
    token = None
    if quant is not None:
        cfg, qnames, orig_dtype = quant
        qflags = tuple(n in qnames for n in other_names)
        token = cfg.key(tuple(i for i, f in enumerate(qflags) if f))
    key = exec_cache.serve_step_key(ex._sig, input_names, quant=token,
                                    embed=embed)
    fn = exec_cache.get(key, count=True)
    if fn is not None:
        return fn
    t0 = time.perf_counter()
    n_args = len(names)

    if quant is None:
        def serve(ex, data_vals, weight_vals, aux_vals):
            merged = [None] * n_args
            for i, v in zip(data_pos, data_vals):
                merged[i] = v
            for i, v in zip(other_pos, weight_vals):
                merged[i] = v
            return ex.serve(merged, aux_vals)
    else:
        dtypes = [orig_dtype[n] if n in qnames else None
                  for n in other_names]
        is_int8 = cfg.dtype == 'int8'

        def serve(ex, data_vals, weight_vals, scale_vals, aux_vals):
            merged = [None] * n_args
            for i, v in zip(data_pos, data_vals):
                merged[i] = v
            si = 0
            for i, v, dt, qf in zip(other_pos, weight_vals, dtypes,
                                    qflags):
                if qf:
                    if is_int8:
                        v = v.to(torch.float32) * scale_vals[si]
                        si += 1
                    v = v.to(dt)
                merged[i] = v
            return ex.serve(merged, aux_vals)

    fn = exec_cache.TimedJit(serve)
    exec_cache.note_compile(time.perf_counter() - t0)
    return exec_cache.put(key, fn)


def _pad_elem_frac(reqs, entry):
    """Share of the free-dim elements that are padding across the
    coalesced requests (0.0 when every request had the bucket's free
    shapes)."""
    total = real = 0
    for r in reqs:
        for f, want in zip(entry, r.free_shapes):
            n = int(np.prod(f)) if f else 1
            total += n * r.rows
            real += (int(np.prod(want)) if want else 1) * r.rows
    return (total - real) / total if total else 0.0


def _slice_out(out, off, req, prog, mirror):
    """One request's rows of the padded batch's output. `mirror` (only
    with an explicit free ladder of several rungs) marks the trailing
    output axes that vary with the rung: those are cut back to the
    request's extent on the matching axis of input 0; a fixed model
    dimension that equals the bucket extent is never cut."""
    sl = [slice(off, off + req.rows)]
    if mirror:
        want = req.free_shapes[0]
        have = prog.free_shapes[0]
        for i, (d, (w, h)) in enumerate(zip(out.shape[1:],
                                            zip(want, have))):
            sl.append(slice(0, w)
                      if (i < len(mirror) and mirror[i] and
                          d == h and w < h)
                      else slice(None))
    return out[tuple(sl)].copy()


def export_serving_checkpoint(step_dir, symbol, prefix, epoch=0):
    """Convert one committed elastic checkpoint dir (a full `step-*` or
    a `delta-*`, whose chain is replayed) into the `save_checkpoint`
    serving format ('<prefix>-symbol.json' + '<prefix>-%04d.params').
    Module commits ('param:NAME', 'aux:NAME') map onto the symbol's
    names; gluon commits ('gparam:i:NAME', ...) by the parameter name.
    Optimizer state and RNG are dropped. The checkpoint validates end to
    end before anything is written. Returns `prefix`."""
    from . import _hostarray as ha
    from .context import cpu
    from .elastic import load_state
    from .model import save_checkpoint
    _manifest, arrays = load_state(step_dir)
    args, auxs = serving_arrays(arrays)
    if not args:
        raise MXNetError(
            'export_serving_checkpoint: %s holds no parameter entries '
            '(is it an elastic checkpoint dir?)' % step_dir)

    def nds(d):
        return {n: nd.NDArray(ha.to_tensor(ha.copy(a)), cpu())
                for n, a in d.items()}
    save_checkpoint(prefix, int(epoch), symbol, nds(args), nds(auxs))
    return prefix


def serving_arrays(arrays):
    """(args, auxs) host-array dicts of the weight entries of one elastic
    checkpoint's flat array dict (export_serving_checkpoint's mapping)."""
    args, auxs = {}, {}
    for key, v in arrays.items():
        if key.startswith('param:'):
            args[key[len('param:'):]] = v
        elif key.startswith('aux:'):
            auxs[key[len('aux:'):]] = v
        elif key.startswith(('gparam:', 'gaux:')):
            kind, _i, name = key.split(':', 2)
            dest = auxs if kind == 'gaux' else args
            dest[name] = v
        elif key.startswith('gfrozen:'):
            _k, _i, name = key.split(':', 2)
            args[name] = v
    return args, auxs


def serving_state(step_dir):
    """Flat {'arg:NAME'/'aux:NAME': host array} serving state of one
    committed checkpoint dir (full or delta): the key space the delta
    push channel speaks, resolved by InferenceEngine.apply_delta."""
    from .elastic import load_state
    _manifest, arrays = load_state(step_dir)
    args, auxs = serving_arrays(arrays)
    state = {'arg:' + n: a for n, a in args.items()}
    state.update({'aux:' + n: a for n, a in auxs.items()})
    return state
