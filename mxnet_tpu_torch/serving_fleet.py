"""Fleet serving tier: the model registry, SLO-aware batching, the HTTP
front with backpressure, and continuous batching for sequence models.
The counterpart of mxnet_tpu/serving_fleet.py.

`serving.InferenceEngine` serves one model. This module hosts many:

  * **ModelRegistry** keeps many named models under one byte budget of
    resident weights, with LRU paging: a cold model's engine is closed
    and drained and its Predictor dropped, so its weights leave the
    card. The rung programs of its engines stay in the process-wide
    `exec_cache` (they hold graph code, not weights), so a re-warm
    reloads the parameters and binds its rungs without building a new
    program. `page_dtype=` keeps an int8 (or bf16) image of an evicted
    model's weights in pinned host memory, and a page-in dequantizes
    it on the card instead of reading the checkpoint.
  * **SLO-aware batching**: each model carries a deadline
    (`SLO(deadline_ms=..., priority=...)`). The batcher hold is a share
    (MXNET_TPU_SERVE_WAIT_FRACTION) of the deadline, and admission sheds
    with a typed `Overloaded` once backlog rows times the engine's
    measured service time exceed it.
  * **HttpFront**: stdlib `http.server` threads, POST
    `/v1/models/<name>:predict`, GET `/healthz` and `/statsz`, with a
    bounded number of predicts in flight, so that overload reaches a
    client as 429 + Retry-After and not as an unbounded queue.
  * **ContinuousEngine**: continuous batching of a per-timestep sequence
    cell at a fixed slot count. Requests are admitted into free slots
    and retired at their own length at each tick boundary, so a long
    sequence does not convoy short ones (`convoy=True` is the baseline
    that fills the batch and runs it to its longest length). K ticks
    run as one chunk (`tick_chunk=K`): K walks of the cell executor
    queued back to back on the engine's CUDA stream with no host
    synchronisation inside the chunk, the state buffers written in
    place. Every tick of an engine runs at the same width on the same
    stream, so a request's answers are the same bits whatever it is
    batched with and whatever K is.

Where the port departs from the JAX package:

  * the default device is the card: `ContinuousEngine(ctx=None)` and a
    registry's checkpoint loaders bind to `gpu(0)` unless a `with
    mx.cpu():` block says otherwise, and raise MXNetError when CUDA is
    absent; the JAX package defaults to `cpu()`;
  * `ModelRegistry` serializes its loads, so that the check before a
    load with a known size holds against every resident byte and the
    peak stays within the budget under concurrent loads of different
    models; the JAX package runs them concurrently, and two loads that
    both passed the check overshoot together;
  * a request that makes its model resident is enqueued in the new
    engine before the load lock is released, so that the next load
    cannot evict the engine before it serves the request that loaded it
    (under thrash the JAX package's can: each load then serves nothing);
  * `ModelRegistry.infer` retries an eviction race within the tenant's
    deadline, as the JAX package does; when that window runs out it
    sheds with `Overloaded` (HTTP 429), where the JAX package re-raises
    the closed engine's error (HTTP 503 'closing', which tells a client
    the server is shutting down);
  * `HttpFront` listens with a backlog of 128 connections; the JAX
    package's server keeps socketserver's 5, which resets the
    connections of a burst of clients that connect at once;
  * `export_artifacts` returns `Predictor.export_compiled`'s
    `torch.export` programs where the JAX package's returns StableHLO.

Env knobs (the JAX package's docs/SERVING.md has the table):
  MXNET_TPU_SERVE_REGISTRY_BYTES   registry byte budget (0 = unbounded)
  MXNET_TPU_SERVE_STRICT_BUDGET    1 = refuse (typed BudgetExceeded)
                                   instead of transiently overshooting
  MXNET_TPU_SERVE_DEADLINE_MS      default SLO deadline (unset = none)
  MXNET_TPU_SERVE_WAIT_FRACTION    batcher hold as deadline fraction
  MXNET_TPU_SERVE_SHED_FACTOR      shed when est > factor x deadline
  MXNET_TPU_SERVE_MAX_QUEUE_ROWS   hard backlog cap per model (4096)
  MXNET_TPU_SERVE_HTTP_INFLIGHT    bounded HTTP admission (64)
  MXNET_TPU_SERVE_HTTP_PORT        default front port (8000)
  MXNET_TPU_SERVE_QUANTIZE         default engine weight quantization
  MXNET_TPU_SERVE_PAGED_BYTES      host budget for page_dtype images
                                   (0 = unbounded)
  MXNET_TPU_SERVE_TICK_CHUNK       continuous batching ticks a chunk
  MXNET_TPU_SERVE_STAGE_AHEAD      chunks staged ahead (default 1)
"""
import contextlib
import json
import os
import threading
import time
import warnings
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import exec_cache
from . import io as mxio
from . import profiler
from . import quantization
from .base import MXNetError
from .quantization import QuantConfig
from .serving import (InferenceEngine, _env_int, chunk_for_deadline,
                      resolve_tick_chunk)

__all__ = ['Overloaded', 'BudgetExceeded', 'SLO', 'ModelRegistry',
           'ContinuousEngine', 'HttpFront']

# tick_chunk='auto' EMA weight of one chunk's measured per-tick time
_TICK_EMA_ALPHA = 0.25


def _default_ctx():
    """The calling thread's `with ctx:` context, else gpu(0): a gpu
    context's bind raises MXNetError when CUDA is absent (no fallback to
    the CPU)."""
    from .context import Context, gpu
    ctx = getattr(Context._default_ctx, 'value', None)
    return ctx if ctx is not None else gpu(0)


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


class Overloaded(MXNetError):
    """Typed shed error: the model's backlog times its service time
    exceeds its deadline (or the hard queue cap), so admitting the
    request would only spend queue memory on a late answer. The HTTP
    front maps it to 429 + Retry-After; a direct caller can back off on
    `retry_after_ms`."""

    def __init__(self, model, backlog_rows, est_ms, deadline_ms):
        self.model = model
        self.backlog_rows = int(backlog_rows)
        self.est_ms = float(est_ms)
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        # retry once the excess backlog should have drained, clamped
        # finite (the queue-cap shed has est=inf)
        self.retry_after_ms = min(
            60000.0, max(1.0, (self.est_ms - (self.deadline_ms or 0.0))
                         if np.isfinite(self.est_ms) else 1000.0))
        super(Overloaded, self).__init__(
            'model %r overloaded: estimated %.1fms for %d backlog rows'
            '%s' % (model, self.est_ms, self.backlog_rows,
                    '' if deadline_ms is None
                    else ' > deadline %.1fms' % self.deadline_ms))


class BudgetExceeded(MXNetError):
    """Typed strict-budget refusal (MXNET_TPU_SERVE_STRICT_BUDGET=1):
    making the model resident would push the registry past its byte
    budget with nothing evictable left, so the load is refused (or
    undone). The HTTP front maps it to 507."""

    def __init__(self, model, need_bytes, budget_bytes, resident_bytes):
        self.model = model
        self.need_bytes = int(need_bytes)
        self.budget_bytes = int(budget_bytes)
        self.resident_bytes = int(resident_bytes)
        super(BudgetExceeded, self).__init__(
            'model %r refused under the strict registry budget: needs '
            '%d bytes but only %d of the %d-byte budget is free and '
            'nothing evictable remains (set '
            'MXNET_TPU_SERVE_STRICT_BUDGET=0 to allow transient '
            'overshoot)' % (model, self.need_bytes,
                            max(0, self.budget_bytes -
                                self.resident_bytes),
                            self.budget_bytes))


def _strict_budget():
    return os.environ.get('MXNET_TPU_SERVE_STRICT_BUDGET',
                          '').strip() in ('1', 'true')


class SLO(object):
    """Per-model serving objective.

    deadline_ms : float or None
        End-to-end latency target. It sets the batcher hold (the
        engine's `max_wait_us` becomes WAIT_FRACTION of it) and admission
        (shed with `Overloaded` once the backlog estimate exceeds
        shed_factor x deadline). None (and no MXNET_TPU_SERVE_DEADLINE_MS)
        means no deadline: the engine's own hold, shed only at the queue
        cap.
    priority : int
        Higher is more important: the registry evicts the lowest
        priority first (LRU within a priority), and the HTTP front's last
        admission slots are reserved for priority >= 1.
    service_ms_hint : float or None
        Per-row service time for shed decisions before the engine has
        measured any batch.
    shed_factor : float
        Tolerance of the backlog estimate (default
        MXNET_TPU_SERVE_SHED_FACTOR or 1.0).
    """

    def __init__(self, deadline_ms=None, priority=0,
                 service_ms_hint=None, shed_factor=None):
        if deadline_ms is None:
            d = _env_float('MXNET_TPU_SERVE_DEADLINE_MS', 0.0)
            deadline_ms = d if d > 0 else None
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        self.priority = int(priority)
        self.service_ms_hint = None if service_ms_hint is None \
            else float(service_ms_hint)
        self.shed_factor = float(
            shed_factor if shed_factor is not None else
            _env_float('MXNET_TPU_SERVE_SHED_FACTOR', 1.0))

    def wait_us(self):
        """The batcher hold the deadline gives: WAIT_FRACTION of it, in
        microseconds; None without a deadline."""
        if self.deadline_ms is None:
            return None
        frac = _env_float('MXNET_TPU_SERVE_WAIT_FRACTION', 0.25)
        return max(0, int(self.deadline_ms * 1000.0 * frac))

    def describe(self):
        return {'deadline_ms': self.deadline_ms,
                'priority': self.priority,
                'shed_factor': self.shed_factor}


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------

class _ModelEntry(object):
    __slots__ = ('name', 'loader', 'slo', 'engine_kwargs', 'pinned',
                 'lock', 'engine', 'holder', 'bytes', 'last_used',
                 'est_bytes', 'dead', 'quantize', 'page_dtype',
                 'paged', 'paged_bytes', 'tick_chunk')

    def __init__(self, name, loader, slo, engine_kwargs, pinned,
                 est_bytes=None, quantize=None, page_dtype=None,
                 tick_chunk=None):
        self.name = name
        self.loader = loader
        self.slo = slo
        self.engine_kwargs = engine_kwargs
        self.pinned = pinned
        self.quantize = quantize        # QuantConfig (live int8 engine)
        self.page_dtype = page_dtype    # QuantConfig (evicted image)
        self.tick_chunk = tick_chunk    # forwarded to a loader= model
        self.paged = None               # quantized host weight image
        self.paged_bytes = 0
        self.lock = threading.Lock()    # serializes load and evict
        self.engine = None              # engine-like, while resident
        self.holder = None              # the Predictor (weight owner)
        self.bytes = 0
        self.last_used = 0.0
        # the size before the first load (the checkpoint's param file, or
        # est_bytes= at register), replaced by the measured bytes after it
        self.est_bytes = est_bytes
        # set under self.lock by unregister(): a _load that raced it must
        # refuse rather than make an engine no entry can reach
        self.dead = False


def _weight_bytes(executor):
    """Bytes of one bound executor's argument and aux arrays: the unit of
    the registry's byte budget for an engine-like model."""
    total = 0
    for d in (executor.arg_dict, executor.aux_dict):
        for a in d.values():
            total += a._data.numel() * a._data.element_size()
    return total


def _to_host(t):
    """A copy of tensor `t` in host memory, pinned when it comes from the
    card (so that a page-in copies it back without staging)."""
    t = t.detach()
    if t.device.type == 'cpu':
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


class ModelRegistry(object):
    """Many named models behind one serving surface, their weights paged
    through a byte budget with LRU eviction, while the process-wide
    exec_cache keeps every model's rung programs (an evict/re-warm cycle
    builds no program: the programs hold graph code, not weights).

    A model is registered cheaply (nothing resident) and made resident at
    its first use. Its loader is one of:

      * ``prefix=/path/prefix, epoch=N, input_shapes={...}``: the
        Module.save_checkpoint artifacts; a re-warm reloads the
        parameters from disk;
      * ``loader=callable`` returning a fresh Predictor, or an
        engine-like object with .infer/.close (a ContinuousEngine for a
        sequence model);
      * ``source=<live Predictor or engine-like object>``: registered
        pinned; its weights exist only in memory, so the registry counts
        but never evicts it.

    Parameters
    ----------
    budget_bytes : int, optional
        Resident-weight budget (default MXNET_TPU_SERVE_REGISTRY_BYTES;
        0 or unset is unbounded). With a known size the colder models are
        paged out before a load; without one a load may overshoot by its
        own size until the enforcement after it.
    ctx : Context, optional
        Device of the checkpoint loaders and page-ins (default the
        constructing thread's `with ctx:` context, else `gpu(0)`, whose
        loads raise when CUDA is absent).
    """

    def __init__(self, budget_bytes=None, ctx=None):
        self.budget_bytes = int(
            budget_bytes if budget_bytes is not None else
            _env_int('MXNET_TPU_SERVE_REGISTRY_BYTES', 0))
        self.max_queue_rows = _env_int('MXNET_TPU_SERVE_MAX_QUEUE_ROWS',
                                       4096)
        # resolved here: loads run on whatever thread asks first, where
        # the constructing thread's `with ctx:` block does not hold
        self._ctx = ctx if ctx is not None else _default_ctx()
        self._lock = threading.Lock()   # registry map + byte ledger
        # one load at a time: the pre-load check then sees every byte
        # that will be resident, and two loads cannot both pass it
        self._load_lock = threading.Lock()
        self._entries = {}
        self._resident_bytes = 0
        self._peak_resident_bytes = 0   # high-water mark: with known
                                        # estimates at most the budget
        self._paged_bytes = 0           # host bytes of page-out images
        self._n_loads = 0
        self._n_evictions = 0
        self._n_shed = 0
        self._n_page_ins = 0
        self._n_page_drops = 0
        self._closed = False

    # -- registration ---------------------------------------------------
    def register(self, name, loader=None, prefix=None, epoch=0,
                 input_shapes=None, source=None, slo=None,
                 est_bytes=None, quantize=None, page_dtype=None,
                 tick_chunk=None, **engine_kwargs):
        """Register a model (nothing loads until its first use): exactly
        one of `loader` / `prefix` / `source`. `engine_kwargs` go to
        InferenceEngine (max_batch, batch_buckets, ...); `max_wait_us`
        defaults to the SLO's hold.

        `tick_chunk` (loader= sequence models only) goes to the loader as
        a keyword, parsed here by serving.resolve_tick_chunk (0/'off'/1
        leave the loader's default; 'auto' passes through, since only the
        engine has the deadline it derives K from). `est_bytes` sizes the
        model before its first load (prefix= models default to the param
        file's size); it is the float32-equivalent size, scaled by
        quantization.EST_BYTES_RATIO under quantize=. `quantize`
        ('int8'/'bf16' or a QuantConfig) serves the model through a
        weight-quantized engine, whose resident bytes the budget counts.
        `page_dtype` (prefix= models only, exclusive with quantize) keeps
        a quantized host image of an evicted model's weights, from which
        the next page-in dequantizes instead of reading the checkpoint;
        the images are bounded by MXNET_TPU_SERVE_PAGED_BYTES (0 =
        unbounded), the oldest dropped first."""
        given = [x is not None for x in (loader, prefix, source)]
        if sum(given) != 1:
            raise MXNetError('register(%r): exactly one of loader= / '
                             'prefix= / source= required' % name)
        if tick_chunk is not None:
            if loader is None:
                raise MXNetError(
                    'register(%r): tick_chunk= applies to loader= '
                    'sequence models (a loader accepting tick_chunk= '
                    'and returning a ContinuousEngine); prefix=/'
                    'source= models serve through the request '
                    'coalescer, which has no tick loop' % name)
            if isinstance(tick_chunk, str) and \
                    tick_chunk.strip().lower() == 'auto':
                tick_chunk = 'auto'
            elif resolve_tick_chunk(tick_chunk) == 1:
                tick_chunk = None
        quantize = QuantConfig.resolve(quantize)
        page_dtype = QuantConfig.resolve(page_dtype)
        if quantize is None and page_dtype is None:
            # the env default resolved here, where the exclusivity check,
            # the est_bytes scaling and stats() see it
            quantize = QuantConfig.from_env()
        if page_dtype is not None:
            if prefix is None:
                raise MXNetError(
                    'register(%r): page_dtype= needs a prefix= model '
                    '(page-in rebuilds from the checkpoint symbol + '
                    'input shapes)' % name)
            if quantize is not None:
                raise MXNetError(
                    'register(%r): page_dtype= and quantize= are '
                    'exclusive — a quantize= engine is already its '
                    'own compressed representation' % name)
        pinned = False
        if prefix is not None:
            if input_shapes is None:
                raise MXNetError('register(%r): prefix= needs '
                                 'input_shapes=' % name)
            from .predictor import Predictor
            ctx = self._ctx
            shapes = dict(input_shapes)

            def loader(_p=prefix, _e=int(epoch), _s=shapes, _c=ctx):
                return Predictor.from_checkpoint(_p, _e, _s, ctx=_c)
            if est_bytes is None:
                # the param file is a close upper bound of the resident
                # bytes (names and shape headers ride along)
                try:
                    est_bytes = os.path.getsize(
                        '%s-%04d.params' % (prefix, int(epoch)))
                except OSError:
                    est_bytes = None
        elif source is not None:
            pinned = True

            def loader(_src=source):
                return _src
        if est_bytes is not None and quantize is not None:
            est_bytes = max(1, int(est_bytes * quantize.est_ratio()))
        # quantize=False is the engine's explicit off: a page_dtype model
        # is not env-quantized behind the registry's back
        engine_kwargs = dict(engine_kwargs,
                             quantize=quantize if quantize is not None
                             else False)
        entry = _ModelEntry(name, loader, slo or SLO(),
                            dict(engine_kwargs), pinned,
                            est_bytes=est_bytes, quantize=quantize,
                            page_dtype=page_dtype,
                            tick_chunk=tick_chunk)
        with self._lock:
            if self._closed:
                raise MXNetError('ModelRegistry is closed')
            if name in self._entries:
                raise MXNetError('model %r already registered' % name)
            self._entries[name] = entry
        profiler.add_fleet_stats(models_registered=1)
        return self

    def models(self):
        with self._lock:
            return sorted(self._entries)

    def _entry(self, name):
        with self._lock:
            ent = self._entries.get(name)
        if ent is None:
            raise MXNetError('unknown model %r (registered: %s)'
                             % (name, self.models()))
        return ent

    # -- residency / paging ---------------------------------------------
    def engine(self, name):
        """The model's resident engine, loaded (and the budget paged) on
        demand. Concurrent callers of one cold model serialize on its
        entry lock, so the load and the ladder's warmup happen once."""
        ent = self._entry(name)
        ent.last_used = time.monotonic()
        eng = ent.engine
        if eng is not None and not eng.closed:
            return eng
        return self._load(ent)

    def _load(self, ent):
        # loads are serialized registry-wide: with a known size the check
        # before the load then holds against every resident byte, so the
        # peak stays within the budget even under concurrent loads of
        # different models. No ent.lock is held while waiting here: only
        # a load takes the load lock, and it takes entry locks only inside.
        with self._load_lock:
            return self._load_locked(ent)

    def _load_locked(self, ent):
        # with a known size, colder models are paged out BEFORE the load;
        # outside ent.lock, because evicting a victim takes the victim's
        # lock
        if self.budget_bytes > 0 and ent.est_bytes:
            self._make_room(ent, int(ent.est_bytes))
        with ent.lock:
            if self._closed:
                raise MXNetError('ModelRegistry is closed')
            if ent.dead:
                raise MXNetError('unknown model %r (unregistered)'
                                 % ent.name)
            if ent.engine is not None and not ent.engine.closed:
                return ent.engine
            obj = self._page_in(ent)    # quantized host image, if any
            if obj is None:
                obj = ent.loader() if ent.tick_chunk is None \
                    else ent.loader(tick_chunk=ent.tick_chunk)
            if hasattr(obj, 'infer'):   # engine-like
                eng, holder = obj, obj
                nbytes = int(obj.resident_bytes()) \
                    if hasattr(obj, 'resident_bytes') else 0
            else:                       # a Predictor: wrap and warm
                kwargs = dict(ent.engine_kwargs)
                if 'max_wait_us' not in kwargs:
                    w = ent.slo.wait_us()
                    if w is not None:
                        kwargs['max_wait_us'] = w
                eng = InferenceEngine(obj, **kwargs)
                holder = obj
                # the engine's own count: input staging left out, a
                # quantized engine's codes and scales in
                nbytes = eng.resident_bytes()
            ent.engine, ent.holder, ent.bytes = eng, holder, nbytes
            ent.est_bytes = nbytes or ent.est_bytes
            with self._lock:
                self._resident_bytes += nbytes
                self._peak_resident_bytes = max(
                    self._peak_resident_bytes, self._resident_bytes)
                self._n_loads += 1
            profiler.add_fleet_stats(
                loads=1, resident_bytes=self._resident_bytes)
            self._note_quant_gauges()
        # the enforcement after the load backstops the estimate; under the
        # strict knob a load that still overshoots is undone and refused
        self._enforce_budget(keep=ent)
        if self.budget_bytes > 0 and _strict_budget() and \
                not ent.pinned:
            with self._lock:
                over = self._resident_bytes - self.budget_bytes
                resident = self._resident_bytes
            if over > 0:
                self._evict_one(ent)
                raise BudgetExceeded(ent.name, ent.est_bytes or 0,
                                     self.budget_bytes,
                                     resident - (ent.est_bytes or 0))
        # the engine this call loaded, not ent.engine: a concurrent load's
        # enforcement may have evicted it already, and its closed error is
        # what infer()'s retry absorbs
        return eng

    def _make_room(self, ent, need):
        """Evict colder models until `need` bytes fit under the budget;
        under the strict knob raise BudgetExceeded when they cannot,
        before the load spends time and memory."""
        with self._lock:
            if ent.engine is not None and not ent.engine.closed:
                return                  # a concurrent load already won
            resident = self._resident_bytes
            evictable = sum(
                e.bytes for e in self._entries.values()
                if e is not ent and not e.pinned and
                e.engine is not None and not e.engine.closed)
        if resident - evictable + need > self.budget_bytes:
            # it would not fit even with every unpinned model evicted:
            # evict nothing for it
            if _strict_budget():
                raise BudgetExceeded(ent.name, need,
                                     self.budget_bytes, resident)
            return
        while True:
            with self._lock:
                if ent.engine is not None and not ent.engine.closed:
                    return
                if self._resident_bytes + need <= self.budget_bytes:
                    return
                victims = [e for e in self._entries.values()
                           if e is not ent and not e.pinned and
                           e.engine is not None and
                           not e.engine.closed]
                if not victims:
                    resident = self._resident_bytes
                    break
                victim = min(victims, key=lambda e:
                             (e.slo.priority, e.last_used))
            self._evict_one(victim)
        if _strict_budget() and \
                (ent.engine is None or ent.engine.closed):
            raise BudgetExceeded(ent.name, need, self.budget_bytes,
                                 resident)

    def _enforce_budget(self, keep=None):
        if self.budget_bytes <= 0:
            return
        while True:
            with self._lock:
                if self._resident_bytes <= self.budget_bytes:
                    return
                victims = [e for e in self._entries.values()
                           if e is not keep and not e.pinned and
                           e.engine is not None and
                           not e.engine.closed]
                if not victims:
                    return      # nothing evictable: the overshoot stands
                # lowest priority first, LRU within a priority
                victim = min(victims, key=lambda e:
                             (e.slo.priority, e.last_used))
            self._evict_one(victim)

    def _evict_one(self, ent):
        """Page one model out: close its engine (reject new work, drain),
        drop the weight holder, free its bytes in the ledger. With
        page_dtype a quantized host image of the weights is kept first."""
        with ent.lock:
            eng = ent.engine
            if eng is None:
                return
            image = None
            if ent.page_dtype is not None and not ent.pinned and \
                    not ent.dead and not self._closed and \
                    hasattr(ent.holder, '_symbol'):
                image = self._page_out(ent)
            eng.close()
            ent.engine = None
            ent.holder = None
            freed, ent.bytes = ent.bytes, 0
            with self._lock:
                self._resident_bytes -= freed
                self._n_evictions += 1
            if image is not None:
                self._store_page(ent, image)
            profiler.add_fleet_stats(
                evictions=1, resident_bytes=self._resident_bytes)
            self._note_quant_gauges()

    # -- quantized page-out images (page_dtype=) ------------------------
    def _page_out(self, ent):
        """The holder Predictor's weights as a quantized image in pinned
        host memory (under ent.lock, before the engine closes). Never
        raises: a model that cannot be imaged pages in from disk."""
        try:
            holder = ent.holder
            ex = holder._executor
            input_names = set(holder._input_names)
            shapes = {n: tuple(ex.arg_dict[n].shape)
                      for n in holder._input_names}
            args = {n: a._data for n, a in ex.arg_dict.items()
                    if n not in input_names}
            quantized, passthrough = quantization.quantize_weights(
                args, ent.page_dtype)
            quantized = {n: (_to_host(q),
                             None if s is None else _to_host(s), dt)
                         for n, (q, s, dt) in quantized.items()}
            keep = {n: _to_host(args[n]) for n in passthrough}
            aux = {n: _to_host(a._data) for n, a in ex.aux_dict.items()}
            nbytes = quantization.quantized_nbytes(
                quantized, list(keep.values()) + list(aux.values()))
            return {'symbol': holder._symbol, 'shapes': shapes,
                    'quantized': quantized, 'passthrough': keep,
                    'aux': aux, 'nbytes': nbytes}
        except Exception as e:          # pragma: no cover - safety net
            warnings.warn('page_dtype image of %r failed (%s); will '
                          'page in from the checkpoint instead'
                          % (ent.name, e))
            return None

    def _store_page(self, ent, image):
        """Commit an image to the host page store, dropping the oldest
        other images past MXNET_TPU_SERVE_PAGED_BYTES."""
        with self._lock:
            ent.paged = image
            ent.paged_bytes = int(image['nbytes'])
            self._paged_bytes += ent.paged_bytes
            budget = _env_int('MXNET_TPU_SERVE_PAGED_BYTES', 0)
            if budget > 0:
                victims = sorted(
                    (e for e in self._entries.values()
                     if e.paged is not None and e is not ent),
                    key=lambda e: e.last_used)
                while self._paged_bytes > budget and victims:
                    v = victims.pop(0)
                    self._paged_bytes -= v.paged_bytes
                    v.paged, v.paged_bytes = None, 0
                    self._n_page_drops += 1
                if self._paged_bytes > budget:
                    self._paged_bytes -= ent.paged_bytes
                    ent.paged, ent.paged_bytes = None, 0
                    self._n_page_drops += 1

    def _page_in(self, ent):
        """A Predictor on the registry's device rebuilt from the entry's
        quantized image (the codes copied to the device and dequantized
        there; no checkpoint read, and its engine's rungs find their
        programs in exec_cache). Consumes the image. None when there is
        none, or when the rebuild fails (the loader runs instead)."""
        with self._lock:
            image, ent.paged = ent.paged, None
            self._paged_bytes -= ent.paged_bytes
            ent.paged_bytes = 0
        if image is None:
            return None
        try:
            from .predictor import Predictor
            device = self._ctx.torch_device
            cfg = ent.page_dtype
            args = {}
            for n, (q, s, dt) in image['quantized'].items():
                q = q.to(device, non_blocking=True)
                if s is not None:
                    s = s.to(device, non_blocking=True)
                args[n] = quantization.dequantize_weight(q, s, cfg,
                                                         dtype=dt)
            for n, a in image['passthrough'].items():
                args[n] = a
            pred = Predictor(symbol=image['symbol'], arg_params=args,
                             aux_params=dict(image['aux']),
                             input_shapes=image['shapes'],
                             ctx=self._ctx)
            with self._lock:
                self._n_page_ins += 1
            profiler.add_quant_stats(page_ins=1)
            self._note_quant_gauges()
            return pred
        except Exception as e:          # pragma: no cover - safety net
            warnings.warn('page-in of %r from its quantized image '
                          'failed (%s); falling back to the loader'
                          % (ent.name, e))
            return None

    def apply_delta(self, name, entries, meta, expect_fp=None,
                    parity_tol=None):
        """Apply one weight delta to a registered model with no full
        reload: a resident model updates its engine's weights in place
        (InferenceEngine.apply_delta); a paged-out model with a
        quantized host image updates the image (dequantize, apply,
        requantize each touched weight), so that its next page-in holds
        the new weights. The delta's gates apply (DeltaChainError,
        DeltaParityError; nothing changes on a refusal); a model neither
        resident nor imaged raises MXNetError (the caller loads it in
        full). Returns the delta's new_fp."""
        from . import _hostarray as ha
        from . import delta as delta_mod
        ent = self._entry(name)
        with ent.lock:
            if ent.dead:
                raise MXNetError('model %r is shutting down' % name)
            if ent.engine is not None and not ent.engine.closed:
                if not hasattr(ent.engine, 'apply_delta'):
                    raise MXNetError(
                        'model %r is served by %s, which does not '
                        'take in-place deltas: full reload required'
                        % (name, type(ent.engine).__name__))
                fp = ent.engine.apply_delta(entries, meta,
                                            expect_fp=expect_fp,
                                            parity_tol=parity_tol)
                ent.last_used = time.time()
                return fp
            if ent.paged is None:
                raise MXNetError(
                    'model %r is neither resident nor paged: apply '
                    'the delta after a load, or full-load instead'
                    % name)
            image = ent.paged
            cfg = ent.page_dtype
            if parity_tol is None:
                parity_tol = getattr(cfg, 'parity_tol', None) or \
                    delta_mod.DeltaConfig().parity_tol
            state = {}
            for n, (q, s, dt) in image['quantized'].items():
                state['arg:' + n] = ha.host(quantization.dequantize_weight(
                    q, s, cfg, dtype=dt))
            for n, a in image['passthrough'].items():
                state['arg:' + n] = ha.host(a)
            for n, a in image['aux'].items():
                state['aux:' + n] = ha.host(a)
            lossy = {'arg:' + n for n in image['quantized']}
            new_state = delta_mod.apply_delta(
                state, meta, entries, expect_fp=expect_fp,
                parity_tol=parity_tol, skip_crc=lossy)
            plan = []
            for key in meta.get('entries', {}):
                n = key[4:]
                if key.startswith('arg:') and n in image['quantized']:
                    plan.append((key, n, 'quantized'))
                elif key.startswith('arg:') and \
                        n in image['passthrough']:
                    plan.append((key, n, 'passthrough'))
                elif key.startswith('aux:') and n in image['aux']:
                    plan.append((key, n, 'aux'))
                else:
                    raise delta_mod.DeltaChainError(
                        'delta touches %r which the page image of %r '
                        'does not hold' % (key, name))
            for key, n, dest in plan:
                new = ha.to_tensor(new_state[key])
                if dest == 'quantized':
                    requant, _pass = quantization.quantize_weights(
                        {n: new}, cfg)
                    q, s, dt = requant[n]
                    image['quantized'][n] = (
                        _to_host(q), None if s is None else _to_host(s),
                        dt)
                elif dest == 'passthrough':
                    image['passthrough'][n] = _to_host(new)
                else:
                    image['aux'][n] = _to_host(new)
            nbytes = quantization.quantized_nbytes(
                image['quantized'],
                list(image['passthrough'].values()) +
                list(image['aux'].values()))
            with self._lock:
                self._paged_bytes += int(nbytes) - ent.paged_bytes
                ent.paged_bytes = int(nbytes)
            image['nbytes'] = int(nbytes)
            profiler.add_delta_stats(applied=1, page_applies=1)
            self._note_quant_gauges()
            return meta.get('new_fp')

    def _note_quant_gauges(self):
        with self._lock:
            n = sum(1 for e in self._entries.values()
                    if e.engine is not None and not e.engine.closed and
                    getattr(e.engine, '_quant_live', False))
            pb = self._paged_bytes
        profiler.add_quant_stats(models_resident=n, paged_bytes=pb)

    def evict(self, name):
        """Page a model out by hand (nothing when it is not resident).
        Refuses a pinned (source=) model, whose only weight copy is the
        live object: close() the registry instead."""
        ent = self._entry(name)
        if ent.pinned:
            raise MXNetError('model %r is pinned (registered from a '
                             'live source=): evicting would lose its '
                             'only weight copy; use close() to shut '
                             'the registry down' % name)
        self._evict_one(ent)
        return self

    def unregister(self, name):
        """Remove a model: its name is unknown once this returns, its
        engine is drained and closed, its bytes and page image freed.
        Applies to pinned models too (retiring a superseded version)."""
        with self._lock:
            ent = self._entries.pop(name, None)
        if ent is None:
            raise MXNetError('unknown model %r (registered: %s)'
                             % (name, self.models()))
        with ent.lock:                  # an in-flight _load must not
            ent.dead = True             # resurrect it
        self._evict_one(ent)
        with self._lock:
            if ent.paged is not None:
                self._paged_bytes -= ent.paged_bytes
                ent.paged, ent.paged_bytes = None, 0
        self._note_quant_gauges()
        return self

    # -- serving --------------------------------------------------------
    def infer(self, name, *pos_inputs, **named_inputs):
        """Admission-controlled inference: sheds with `Overloaded` when
        the model's backlog times its service time exceeds its deadline
        (or the queue-row cap), else forwards to the resident engine. An
        eviction racing the call is absorbed by reloading and retrying
        within the deadline (30 s without one); past a deadline the race
        sheds with `Overloaded`."""
        ent = self._entry(name)
        budget = 30.0
        if ent.slo.deadline_ms:
            budget = min(budget, ent.slo.deadline_ms / 1e3)
        t0 = time.monotonic()
        deadline = t0 + budget
        while True:
            eng, wait = self._engine_submit(ent, pos_inputs, named_inputs)
            try:
                if wait is not None:
                    return wait()
                return eng.infer(*pos_inputs, **named_inputs)
            except MXNetError as e:
                # eviction race: the engine closed between engine() and
                # the enqueue; each loss needs the close to land in that
                # short window, so the retries converge
                if getattr(eng, 'closed', False) and 'closed' in str(e) \
                        and not self._closed:
                    if time.monotonic() < deadline:
                        continue
                    if ent.slo.deadline_ms:
                        self._shed(ent, self._backlog(eng),
                                   (time.monotonic() - t0) * 1e3)
                raise

    def _engine_submit(self, ent, pos_inputs, named_inputs):
        """(engine, wait): a resident engine after admission, with wait
        None (the caller's infer() enqueues); or, for a model that needs
        a load, the engine loaded and the request admitted and enqueued
        under the load lock (wait() gives its answer), so that no other
        load evicts it before the request that caused the load is in its
        queue (an eviction drains the queue)."""
        ent.last_used = time.monotonic()
        eng = ent.engine
        if eng is not None and not eng.closed:
            self._admit(ent, eng)
            return eng, None
        with self._load_lock:
            eng = self._load_locked(ent)
            self._admit(ent, eng)
            if not hasattr(eng, 'submit'):
                return eng, None
            return eng, eng.submit(*pos_inputs, **named_inputs)

    def predict(self, name, *pos_inputs, **named_inputs):
        """First output of infer()."""
        return self.infer(name, *pos_inputs, **named_inputs)[0]

    @staticmethod
    def _backlog(eng):
        return eng.backlog_rows() if hasattr(eng, 'backlog_rows') else 0

    def _admit(self, ent, eng):
        """Shed on backlog: the estimated time to answer the current
        backlog (rows x the engine's per-row service time, or the SLO's
        hint before any traffic) against the deadline."""
        slo = ent.slo
        backlog = self._backlog(eng)
        if backlog > self.max_queue_rows:
            self._shed(ent, backlog, float('inf'))
        if slo.deadline_ms is None:
            return
        est = eng.service_estimate() \
            if hasattr(eng, 'service_estimate') else None
        if est is not None:
            svc_ms, rows_per_batch = est
            per_row_ms = svc_ms / rows_per_batch
        elif slo.service_ms_hint is not None:
            per_row_ms = slo.service_ms_hint
        else:
            return                      # nothing to judge with yet
        est_ms = (backlog + 1) * per_row_ms
        if est_ms > slo.deadline_ms * slo.shed_factor:
            self._shed(ent, backlog, est_ms)

    def _shed(self, ent, backlog, est_ms):
        with self._lock:
            self._n_shed += 1
        profiler.add_fleet_stats(shed_requests=1)
        raise Overloaded(ent.name, backlog, est_ms,
                         ent.slo.deadline_ms)

    # -- observability / lifecycle --------------------------------------
    def stats(self):
        """The registry's paging counters and, per model, its residency,
        bytes, SLO and (resident) its engine's own stats()."""
        with self._lock:
            entries = list(self._entries.values())
            out = {
                'budget_bytes': self.budget_bytes,
                'resident_bytes': self._resident_bytes,
                'peak_resident_bytes': self._peak_resident_bytes,
                'paged_bytes': self._paged_bytes,
                'strict_budget': _strict_budget(),
                'loads': self._n_loads,
                'evictions': self._n_evictions,
                'shed_requests': self._n_shed,
                'page_ins': self._n_page_ins,
                'page_drops': self._n_page_drops,
            }
        models = {}
        for ent in entries:
            eng = ent.engine
            m = {'resident': eng is not None and not eng.closed,
                 'pinned': ent.pinned,
                 'bytes': ent.bytes}
            if ent.quantize is not None:
                m['quantize'] = ent.quantize.describe()
            if ent.page_dtype is not None:
                m['page_dtype'] = ent.page_dtype.dtype
                m['paged'] = ent.paged is not None
                m['paged_bytes'] = ent.paged_bytes
            m.update(ent.slo.describe())
            if m['resident'] and hasattr(eng, 'stats'):
                m['engine'] = eng.stats()
            models[ent.name] = m
        out['models'] = models
        return out

    def export_artifacts(self, name, batch_buckets=None):
        """The model's `Predictor.export_compiled` artifacts (one
        `torch.export` program, or one for each of `batch_buckets`)."""
        ent = self._entry(name)
        self.engine(name)               # ensure resident
        holder = ent.holder
        if not hasattr(holder, 'export_compiled'):
            raise MXNetError('model %r source has no export_compiled '
                             '(sequence/engine-like models export via '
                             'their own artifacts)' % name)
        return holder.export_compiled(batch_buckets=batch_buckets)

    def close(self):
        """Evict everything and refuse further use (idempotent)."""
        with self._lock:
            if self._closed:
                return self
            self._closed = True
            entries = list(self._entries.values())
        for ent in entries:
            self._evict_one(ent)
        return self

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# continuous batching for sequence models
# ---------------------------------------------------------------------------

class _ContRequest(object):
    __slots__ = ('seq', 'length', 't', 'ys', 'event', 'outputs',
                 'error', 't_enq', 'mig_state', 'staged_t')

    def __init__(self, seq):
        self.seq = seq
        self.length = seq.shape[0]
        self.t = 0
        self.ys = None                  # per output, a list of step rows
        self.event = threading.Event()
        self.outputs = None
        self.error = None
        self.t_enq = time.perf_counter()
        self.mig_state = None           # migrated cell state (hot swap)
        self.staged_t = 0               # position with staged chunks
                                        # (t advances when a chunk is
                                        # processed, staged_t when staged)


class _StagedChunk(object):
    """One chunk's host staging, prepared while earlier chunks run on the
    device. Retires are decided by staged positions, never by device
    outputs, so the admits, the reset mask and each row's bookkeeping are
    known before the previous chunk finishes. Carries its own K: the
    adaptive chooser may move tick_chunk between stagings."""
    __slots__ = ('K', 'xs', 'reset', 'rows', 'admits', 'mig', 'lone',
                 'lane', 'start', 'exact', 'outs', 'error', 't_disp',
                 'waiting', 'done')

    def __init__(self, K):
        self.K = K
        self.waiting = 0                # queue depth at staging time
        self.xs = None                  # host (K, width, ...) inputs
        self.reset = None               # host admission-reset mask
        self.rows = ()                  # (slot, request, n) per row
        self.admits = ()                # (slot, request) fresh admits
        self.mig = ()                   # (slot, state dict) hot swap
        self.lone = False
        self.lane = 0
        self.start = 0
        self.exact = False
        self.outs = None                # the chunk's output tensors
        self.done = None                # CUDA event after the chunk
        self.error = None               # dispatch-time exception
        self.t_disp = 0.0


class ContinuousEngine(object):
    """Continuous batching over a per-timestep sequence cell.

    The model is a single-timestep symbol: input `data_name` (one step,
    shape (slots,) + data_shape) and the named recurrent state variables;
    its outputs are the per-step outputs and the next states
    (`state_outputs` maps each state to the output index that feeds it
    back). The engine binds it once at a fixed `slots` batch and runs a
    tick loop:

      tick:  admit waiting requests into free slots (their state reset by
             `torch.where(reset, init, state)` before the walk), walk one
             step for every slot, append each active slot's output row,
             retire the slots whose sequence just finished.

    A request holds a slot for exactly its own length. Every tick runs at
    the same width, on the engine's CUDA stream, so co-resident answers
    are bit-equal to the same request run alone.

    `convoy=True` is the baseline: admission only into an empty batch,
    everyone run to the longest admitted length.

    **Chunked ticks** (`tick_chunk=K` / MXNET_TPU_SERVE_TICK_CHUNK): one
    dispatch runs K ticks, K walks queued back to back on the engine's
    stream with no host synchronisation between them and the state
    buffers written in place; the reset applies before the chunk's first
    tick (`where(False, init, state)` is the identity), so a chunked
    answer is bit-equal to the unchunked loop's. Admission and retirement
    happen at chunk boundaries only: a slot whose sequence ends
    mid-chunk stays masked for up to K-1 ticks while a request waits,
    which `boundary_wait_ms` prices. K <= slots. `tick_chunk='auto'`
    warms the power-of-2 rungs up to `slots` and moves K between them
    with an EMA of the measured per-tick time against the SLO deadline
    (serving.chunk_for_deadline).

    Two fast paths ride on chunked mode: a lone active request runs a
    narrow rung (the state lane read with `narrow`, written back with
    `index_copy_`), at width 1 or, where cuBLAS rounds a 1-row GEMM
    otherwise, 2; it is enabled only when its warm-up probe is bit-equal
    to the full-width program (stats()['lone_fast_path'],
    ['lone_fast_path_width']). An exact-fill chunk (every slot active
    all K ticks) skips the staging fill.

    **Hot-swap migration**: `export_state()` halts the loop at a chunk
    boundary and hands every accepted request (slot state, position,
    partial outputs, and the queue) to a replacement engine's
    `admit_state()`; with unchanged weights the migrated run is bit-equal
    to an unswapped one. MXNET_TPU_FAULT_SWAP_DROP_STATE drops the
    exported slot state: those requests replay from t=0.

    Parameters
    ----------
    symbol : Symbol
        The per-timestep cell graph.
    arg_params / aux_params : dict
        Parameters (the states must not be among them).
    data_shape : tuple
        Per-timestep input shape without the slot dim (() for a token).
    state_shapes : dict name -> tuple
        Recurrent state shapes without the slot dim.
    state_outputs : dict name -> int
        The output index of each state's next value.
    slots : int
        Co-resident request capacity (default MXNET_TPU_SERVE_MAX_BATCH
        or 4).
    ctx : Context, optional
        Default the calling thread's `with ctx:` context, else `gpu(0)`,
        which raises when CUDA is absent.
    init_states : dict name -> array, optional
        The state a request starts from (default zeros). Non-zero inits
        are held by the step programs, which are then not shared through
        exec_cache.
    max_queue : int
        Backlog cap in requests, past which infer() sheds with
        `Overloaded` (default MXNET_TPU_SERVE_MAX_QUEUE_ROWS).
    tick_chunk : int or str, optional
        Ticks a dispatch (serving.resolve_tick_chunk).
    slo : SLO, optional / tick_ms_hint : float, optional
        Together the default K when neither tick_chunk= nor the env knob
        is set, and the deadline of tick_chunk='auto'.
    stage_ahead : int, optional
        Chunks staged and dispatched while an earlier one runs (default
        MXNET_TPU_SERVE_STAGE_AHEAD or 1; 0 is the serialized loop).
    """

    def __init__(self, symbol, arg_params=None, aux_params=None,
                 data_name='data', data_shape=None, state_shapes=None,
                 state_outputs=None, slots=None, ctx=None,
                 init_states=None, convoy=False, max_queue=None,
                 tick_chunk=None, slo=None, tick_ms_hint=None,
                 stage_ahead=None):
        # every attribute close() and __del__ read, before anything raises
        self._started = False
        self._closed = True
        self._close_lock = threading.Lock()
        self._cond = threading.Condition()
        self._lock = threading.Lock()   # the engine-local counters
        if data_shape is None or not state_shapes or not state_outputs:
            raise MXNetError('ContinuousEngine needs data_shape, '
                             'state_shapes and state_outputs')
        if set(state_shapes) != set(state_outputs):
            raise MXNetError('state_shapes and state_outputs must name '
                             'the same states')
        self._ctx = ctx if ctx is not None else _default_ctx()
        self.slots = int(slots if slots is not None else
                         _env_int('MXNET_TPU_SERVE_MAX_BATCH', 4))
        self.convoy = bool(convoy)
        self.max_queue = int(max_queue if max_queue is not None else
                             _env_int('MXNET_TPU_SERVE_MAX_QUEUE_ROWS',
                                      4096))
        tk = resolve_tick_chunk(
            tick_chunk, self.slots, slo=slo, tick_ms_hint=tick_ms_hint)
        self._auto = tk == 'auto'
        self._rungs = ()
        self._deadline_ms = None
        self._tick_ms_ema = None        # measured per-tick EMA (auto)
        self._auto_decisions = 0
        if self._auto:
            # K moves between warmed power-of-2 rungs, so that a change of
            # K builds nothing
            self._deadline_ms = float(slo.deadline_ms)
            rungs, r = [], 1
            while r < self.slots:
                rungs.append(r)
                r *= 2
            rungs.append(self.slots)
            self._rungs = tuple(sorted(set(rungs)))
            if tick_ms_hint:
                self._tick_ms_ema = float(tick_ms_hint)
                self.tick_chunk = self._quantize_k(chunk_for_deadline(
                    self._deadline_ms, tick_ms_hint, self.slots))
            else:
                self.tick_chunk = 1     # no hint: the EMA raises K
        else:
            self.tick_chunk = tk
        if stage_ahead is None:
            s = os.environ.get('MXNET_TPU_SERVE_STAGE_AHEAD',
                               '').strip().lower()
            if s in ('0', 'off', 'none', 'false'):
                stage_ahead = 0
            else:
                try:
                    stage_ahead = int(s) if s else 1
                except ValueError:
                    stage_ahead = 1
        self._stage_ahead = max(0, int(stage_ahead))
        self._data_name = data_name
        self._data_shape = tuple(int(d) for d in data_shape)
        self._state_names = sorted(state_shapes)
        self._state_out_idx = [int(state_outputs[s])
                               for s in self._state_names]
        self._state_shapes = {s: tuple(int(d) for d in state_shapes[s])
                              for s in self._state_names}
        shapes = {data_name: (self.slots,) + self._data_shape}
        for s in self._state_names:
            shapes[s] = (self.slots,) + self._state_shapes[s]
        for s in self._state_names:
            if s in (arg_params or {}):
                raise MXNetError('state %r must not be a parameter' % s)
        # binding to a gpu context raises here when CUDA is absent
        ex = symbol.simple_bind(self._ctx, grad_req='null', **shapes)
        ex.copy_params_from(arg_params or {}, aux_params or {})
        self._ex = ex
        self._symbol = symbol
        self._device = self._ctx.torch_device
        n_outs = len(ex._out_entries)
        bad = [i for i in self._state_out_idx
               if i < 0 or i >= n_outs]
        if bad:
            raise MXNetError('state_outputs index %r out of range '
                             '(%d outputs)' % (bad, n_outs))
        self._y_idx = [i for i in range(n_outs)
                       if i not in set(self._state_out_idx)]
        self._dtype = np.dtype(ex.arg_dict[data_name].dtype)
        self._init_states = init_states
        # the walks' stream, the input staging's and the output copies'
        if self._device.type == 'cuda':
            self._stream = torch.cuda.Stream(self._device)
            self._stage_stream = torch.cuda.Stream(self._device)
            self._copy_stream = torch.cuda.Stream(self._device)
        else:
            self._stream = self._stage_stream = self._copy_stream = None
        # the explicit generator of the ops that draw (the JAX PRNGKey)
        self._rng = torch.Generator(device=self._device)
        self._rng.manual_seed(0)
        self._rung_builds = 0           # step programs this engine took
        self._rung_build_s = 0.0
        self._lone_exs = {}             # rung width -> executor
        self._step = self._build(_make_cont_step)
        # the device-resident recurrent state: one buffer set, written in
        # place by every program
        with torch.inference_mode():
            self._states = tuple(
                torch.zeros(ex.arg_dict[s]._data.shape,
                            dtype=ex.arg_dict[s]._data.dtype,
                            device=self._device)
                for s in self._state_names)
        # warm the single-tick program and check the slot-dim contract
        self._join_caller_stream()
        with self._on_stream():
            x0, r0 = self._to_device(
                [np.zeros((self.slots,) + self._data_shape, self._dtype),
                 np.zeros((self.slots,), np.bool_)])
            outs = self._step(ex, x0, r0, self._states, self._weights(),
                              self._aux(), self._rng)
        for i, o in zip(self._y_idx, outs):
            if o.ndim == 0 or o.shape[0] != self.slots:
                raise MXNetError(
                    'ContinuousEngine requires row-independent outputs '
                    'with a leading slot dim: output %d has shape %r '
                    '(slots=%d) — a slot-reducing cell would mix '
                    'co-resident sequences' % (i, tuple(o.shape),
                                               self.slots))
        self._chunk_steps = {}          # K -> chunk program
        self._lone_steps = {}           # K -> (lone rung program, width)
        if self._auto:
            # every rung warmed now: the chooser moves K at run time
            for k in self._rungs:
                self._warm_chunk_programs(k)
        elif self.tick_chunk > 1:
            self._warm_chunk_programs(self.tick_chunk)
        with torch.inference_mode():
            for s in self._states:
                s.zero_()
        self._sync()
        self._warm_snapshot = (self._rung_builds, self._rung_build_s)
        # request plumbing
        self._queue = deque()
        self._active = [None] * self.slots
        self._halt = False              # export_state's loop stop
        # engine-local counters
        self._ticks = 0
        self._chunks = 0                # dispatches (== ticks at K=1)
        self._active_row_ticks = 0
        self._admitted = 0
        self._retired = 0
        self._boundary_wait_ms = 0.0
        self._lone_hits = 0
        self._exact_fill = 0
        self._staged_chunks = 0
        self._stage_overlap_ms = 0.0
        self._sview = None              # staged slot view (staged loop)
        self._last_done = None          # last chunk completion (auto K)
        self._closed = False
        self._loop = threading.Thread(target=self._tick_loop,
                                      name='mxt-cont-batch', daemon=True)
        self._loop.start()
        self._started = True

    # -- device plumbing --------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _join_caller_stream(self):
        """Order the engine's stream after the caller's, on which the
        weights were written."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(
                self._device))

    def _sync(self):
        if self._stream is not None:
            self._stream.synchronize()

    def _to_device(self, host):
        """Host arrays as tensors on the engine's device, ready to read on
        the current stream (copied on the staging stream)."""
        return mxio.stage_to_device(host, device=self._device,
                                    stream=self._stage_stream)

    def _record_done(self):
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _host_outputs(self, outs, done):
        """The outputs as numpy arrays; on the card copied on the copy
        stream after `done` (not after later chunks)."""
        if self._copy_stream is None:
            return [o.numpy() for o in outs]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            host = []
            for o in outs:
                o.record_stream(self._copy_stream)
                buf = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                buf.copy_(o, non_blocking=True)
                host.append(buf)
        self._copy_stream.synchronize()
        return [h.numpy() for h in host]

    def _weights(self):
        ex = self._ex
        skip = set(self._state_names) | {self._data_name}
        return tuple(ex.arg_dict[n]._data for n in ex.arg_dict
                     if n not in skip)

    def _aux(self):
        ex = self._ex
        return tuple(ex.aux_dict[n]._data for n in ex.aux_dict)

    def _build(self, maker, *args):
        """One step program from `maker`, counted as a rung build of this
        engine (compiles_after_warmup counts those after the warm-up)."""
        t0 = time.perf_counter()
        fn = maker(self._ex, self._data_name, self._state_names,
                   self._state_out_idx, self._init_states, self._device,
                   *args)
        with self._lock:
            self._rung_builds += 1
            self._rung_build_s += time.perf_counter() - t0
        return fn

    def _lone_executor(self, width):
        """The cell bound at `width` rows, sharing the weights."""
        ex = self._lone_exs.get(width)
        if ex is None:
            shapes = {self._data_name: (width,) + self._data_shape}
            for s in self._state_names:
                shapes[s] = (width,) + self._state_shapes[s]
            ex = self._symbol.simple_bind(self._ctx, grad_req='null',
                                          shared_exec=self._ex, **shapes)
            self._lone_exs[width] = ex
        return ex

    def _warm_chunk_programs(self, K):
        """Build and warm the K-tick chunk program and the lone-request
        rung, and enable the rung only where a probe through it is
        bit-equal to the full-width program: cuBLAS may pick another GEMM
        for 1 or 2 rows than for `slots` and round otherwise, and the rung
        never trades bit parity for speed. The probe tries width 1, then
        2, and enables the first that matches; if none does (or the rung
        would not be narrower than `slots`), lone requests run the full
        program."""
        ex = self._ex
        self._chunk_steps[K] = self._build(_make_cont_chunk_step, K)
        n = int(np.prod((K, self.slots) + self._data_shape))
        probe = ((np.arange(n, dtype=np.float64) % 13) / 8.0 - 0.75)
        probe = probe.reshape(
            (K, self.slots) + self._data_shape).astype(self._dtype)

        def zstates(width):
            with torch.inference_mode():
                return tuple(
                    torch.zeros((width,) + self._state_shapes[s],
                                dtype=ex.arg_dict[s]._data.dtype,
                                device=self._device)
                    for s in self._state_names)

        with self._on_stream():
            fsts = zstates(self.slots)
            xs, reset = self._to_device(
                [probe, np.ones((self.slots,), np.bool_)])
            fouts = self._chunk_steps[K](ex, xs, reset, fsts,
                                         self._weights(), self._aux(),
                                         self._rng)
            fouts = [o.cpu() for o in fouts]
            fsts = [s.cpu() for s in fsts]
            for w in (1, 2):
                if w >= self.slots:
                    break
                cand = self._build(_make_cont_lone_step, K, w)
                lxs = np.zeros((K, w) + self._data_shape, self._dtype)
                lxs[:, 0] = probe[:, 0]     # lane 0 = the full slot 0
                lreset = np.zeros((w,), np.bool_)
                lreset[0] = True
                lsts = zstates(self.slots)
                lx, lr = self._to_device([lxs, lreset])
                louts = cand(self._lone_executor(w), lx, lr, 0, 0, lsts,
                             self._weights(), self._aux(), self._rng)
                lone_ok = all(torch.equal(f[:, :1], lo[:, :1].cpu())
                              for f, lo in zip(fouts, louts))
                lone_ok = lone_ok and all(
                    torch.equal(a[0], b[0].cpu())
                    for a, b in zip(fsts, lsts))
                if lone_ok:
                    self._lone_steps[K] = (cand, w)
                    break

    def _quantize_k(self, k):
        """Largest warmed rung <= k (rung 1 always exists)."""
        best = self._rungs[0]
        for r in self._rungs:
            if r <= k:
                best = r
        return best

    # -- public API -----------------------------------------------------
    def infer(self, seq):
        """Submit one sequence (array (T,) + data_shape, T >= 1) and wait
        for its per-step outputs: a list of numpy arrays, one per
        non-state output, each (T,) + that output's per-step shape.
        Thread-safe; requests are admitted at tick boundaries."""
        return self.infer_many([seq])[0]

    def infer_many(self, seqs):
        """Submit several sequences in one queue hold (the tick loop sees
        them all at its next boundary, so a quiet engine packs them
        deterministically) and wait for all of them; the answers in
        submission order."""
        return self._submit(seqs)()

    def submit(self, seq):
        """Enqueue one sequence as infer() does and return at once a
        function that waits for its outputs (close() drains the queue,
        so an enqueued sequence is answered)."""
        wait = self._submit([seq])
        return lambda: wait()[0]

    def _submit(self, seqs):
        reqs = [self._validate(s) for s in seqs]
        with self._cond:
            if self._closed:
                raise MXNetError('ContinuousEngine is closed')
            if len(self._queue) + len(reqs) > self.max_queue:
                profiler.add_fleet_stats(shed_requests=1)
                raise Overloaded('<continuous>', len(self._queue),
                                 float('inf'), None)
            self._queue.extend(reqs)
            self._cond.notify_all()

        def wait():
            for r in reqs:
                r.event.wait()
            for r in reqs:
                if r.error is not None:
                    raise r.error
            return [r.outputs for r in reqs]
        return wait

    def _validate(self, seq):
        a = seq.asnumpy() if hasattr(seq, 'asnumpy') else \
            np.asarray(seq)
        a = np.ascontiguousarray(a, dtype=self._dtype)
        if a.ndim != 1 + len(self._data_shape) or \
                tuple(a.shape[1:]) != self._data_shape or \
                a.shape[0] < 1:
            raise MXNetError('sequence shape %r != (T,)+%r with T>=1'
                             % (tuple(a.shape), self._data_shape))
        return _ContRequest(a)

    def stats(self):
        """This engine's counters: ticks (timesteps), chunks (dispatches),
        slot utilization (active row-ticks over slot-ticks), admits and
        retires, the boundary-wait estimate, the fast-path counters, the
        staging and auto-K counters, and the step programs taken after
        the warm-up (compiles_after_warmup: 0 is the contract)."""
        with self._lock:
            ticks = self._ticks
            lone = self._lone_steps.get(self.tick_chunk)
            out = {
                'ticks': ticks,
                'chunks': self._chunks,
                'tick_chunk': self.tick_chunk,
                'active_row_ticks': self._active_row_ticks,
                'slot_ticks': ticks * self.slots,
                'utilization': (self._active_row_ticks /
                                (ticks * self.slots) if ticks else 0.0),
                'admitted': self._admitted,
                'retired': self._retired,
                'slots': self.slots,
                'convoy': self.convoy,
                'boundary_wait_ms': round(self._boundary_wait_ms, 3),
                'lone_fast_path_hits': self._lone_hits,
                'exact_fill_admits': self._exact_fill,
                'lone_fast_path': lone is not None,
                'lone_fast_path_width': lone[1] if lone else 0,
                'stage_ahead': self._stage_ahead,
                'staged_chunks': self._staged_chunks,
                'stage_overlap_ms': round(self._stage_overlap_ms, 3),
                'auto_tick_chunk': self._auto,
                'tick_ms_ema': round(self._tick_ms_ema, 4)
                if self._tick_ms_ema is not None else 0.0,
                'auto_k_decisions': self._auto_decisions,
            }
            out['compiles_after_warmup'] = \
                self._rung_builds - self._warm_snapshot[0]
            out['compile_s_after_warmup'] = round(
                self._rung_build_s - self._warm_snapshot[1], 6)
        return out

    def backlog_rows(self):
        with self._cond:
            # the staged view holds requests admitted into an in-flight
            # chunk, which are neither queued nor (yet) in _active
            slots_src = self._sview if self._sview is not None \
                else self._active
            return len(self._queue) + \
                sum(1 for s in slots_src
                    if s is not None and not s.event.is_set())

    def service_estimate(self):
        return None                     # per-tick model: no batch EMA

    def resident_bytes(self):
        return _weight_bytes(self._ex)

    # -- hot-swap sequence migration --------------------------------------
    def export_state(self, timeout=30):
        """Halt the tick loop at a chunk boundary and export every
        accepted request (in-flight slot state rows, positions, partial
        outputs, and the queue) for `admit_state` on a replacement
        engine. This engine is closed afterwards; the blocked infer()
        callers are completed by the engine the requests move into.
        MXNET_TPU_FAULT_SWAP_DROP_STATE drops the slot state: those
        requests replay from t=0 (loop_swap_dropped_slots)."""
        from .elastic import fault_knob
        with self._cond:
            if self._closed:
                raise MXNetError('ContinuousEngine is closed')
            self._closed = True         # refuse new submits
            self._halt = True
            self._cond.notify_all()
        if self._started:
            self._loop.join(timeout=timeout)
            if self._loop.is_alive():
                # the halt did not land: undo it, so that the engine keeps
                # serving its accepted requests
                with self._cond:
                    self._halt = False
                    self._closed = False
                    self._cond.notify_all()
                self._loop.join(timeout=1.0)
                if not self._loop.is_alive():
                    self._loop = threading.Thread(
                        target=self._tick_loop,
                        name='mxt-cont-batch', daemon=True)
                    self._loop.start()
                raise MXNetError('export_state: tick loop did not '
                                 'halt within %ss (engine kept '
                                 'serving; retry the swap)' % timeout)
            self._started = False
        drop = fault_knob('SWAP_DROP_STATE') is not None
        self._sync()
        states_np = [s.cpu().numpy() for s in self._states]
        requests = []
        n_dropped = 0
        with self._cond:
            for i, r in enumerate(self._active):
                if r is None:
                    continue
                if drop:
                    r.mig_state = None
                    r.t = 0
                    r.ys = [[] for _ in self._y_idx]
                    n_dropped += 1
                else:
                    r.mig_state = {
                        n: states_np[k][i].copy()
                        for k, n in enumerate(self._state_names)}
                requests.append(r)
                self._active[i] = None
            requests.extend(self._queue)
            self._queue.clear()
        if n_dropped:
            profiler.add_loop_stats(swap_dropped_slots=n_dropped)
        return {'requests': requests,
                'data_shape': self._data_shape,
                'state_names': tuple(self._state_names),
                'n_outputs': len(self._y_idx),
                'dropped': n_dropped}

    def admit_state(self, exported, model_changed=False):
        """Re-admit another engine's `export_state()` into this one:
        in-flight requests resume from their state and position (their
        original callers wake when they finish here), queued ones join
        the queue, past max_queue (they were accepted already).
        `model_changed=True` declares other weights: the migrated and the
        dropped slots are counted as divergent. Returns the number of
        migrated in-flight slots."""
        if tuple(exported['data_shape']) != self._data_shape or \
                tuple(exported['state_names']) != \
                tuple(self._state_names) or \
                int(exported.get('n_outputs', len(self._y_idx))) != \
                len(self._y_idx):
            raise MXNetError(
                'admit_state: incompatible engines (data_shape %r vs '
                '%r, states %r vs %r, outputs %s vs %d)'
                % (tuple(exported['data_shape']), self._data_shape,
                   tuple(exported['state_names']),
                   tuple(self._state_names),
                   exported.get('n_outputs'), len(self._y_idx)))
        reqs = list(exported['requests'])
        migrated = sum(1 for r in reqs if r.mig_state is not None)
        with self._cond:
            if self._closed:
                raise MXNetError('ContinuousEngine is closed')
            self._queue.extend(reqs)
            self._cond.notify_all()
        profiler.add_loop_stats(
            swap_migrated_slots=migrated,
            swap_divergent_slots=(migrated +
                                  int(exported.get('dropped', 0)))
            if model_changed else 0)
        return migrated

    # -- tick loop --------------------------------------------------------
    def _tick_loop(self):
        with self._on_stream():
            if self._stage_ahead and (self._auto or self.tick_chunk > 1):
                self._staged_loop()
            else:
                self._serial_loop()

    def _write_mig(self, mig):
        """Migrated slots' exported state rows into the state buffers
        (in place, on the engine's stream)."""
        with torch.inference_mode():
            for i, st in mig:
                for k, n in enumerate(self._state_names):
                    self._states[k][i].copy_(torch.from_numpy(
                        np.asarray(st[n])).to(self._device))

    def _fail_rows(self, rows, e):
        """Surface a dispatch error to every request of a chunk."""
        with self._cond:
            for i, r in rows:
                r.error = e
                r.event.set()
                self._active[i] = None
                if self._sview is not None and self._sview[i] is r:
                    self._sview[i] = None

    def _serial_loop(self):
        """The stage -> dispatch -> drain loop: the parity baseline of the
        staged loop (stage_ahead=0), and the only loop at tick_chunk=1."""
        while True:
            admitted = []
            with self._cond:
                while not self._closed and not self._halt and \
                        not self._queue and \
                        all(s is None for s in self._active):
                    self._cond.wait()
                if self._halt:
                    # export_state(): stop at the boundary with the queue
                    # and the slots intact (close() drains them instead)
                    break
                if self._closed and not self._queue and \
                        all(s is None for s in self._active):
                    break
                # continuous mode fills any free slot; convoy mode only an
                # all-empty batch
                can_admit = any(s is None for s in self._active) if \
                    not self.convoy else \
                    all(s is None for s in self._active)
                if can_admit:
                    for i in range(self.slots):
                        if self._active[i] is None and self._queue:
                            req = self._queue.popleft()
                            if req.ys is None:
                                req.ys = [[] for _ in self._y_idx]
                            self._active[i] = req
                            admitted.append(i)
            active = [(i, r) for i, r in enumerate(self._active)
                      if r is not None]
            if not active:
                continue
            reset = np.zeros((self.slots,), np.bool_)
            mig = []
            for i in admitted:
                r = self._active[i]
                if r is not None and r.mig_state is not None:
                    mig.append((i, r.mig_state))
                    r.mig_state = None
                else:
                    reset[i] = True
            if mig:
                self._write_mig(mig)
            if self.tick_chunk == 1 and not self._auto:
                self._tick_once(active, admitted, reset)
            else:
                # auto mode always runs the chunk programs (rung 1 is a
                # 1-tick chunk), so a K move never switches paths
                self._chunk_once(active, admitted, reset)

    def _tick_once(self, active, admitted, reset):
        """One timestep for every slot: the unchunked dispatch path
        (tick_chunk=1, the parity baseline of chunked mode)."""
        x = np.zeros((self.slots,) + self._data_shape, self._dtype)
        for i, r in active:
            x[i] = r.seq[r.t]
        try:
            dx, dreset = self._to_device([x, reset])
            outs = self._step(self._ex, dx, dreset, self._states,
                              self._weights(), self._aux(), self._rng)
            np_outs = self._host_outputs(outs, self._record_done())
        except Exception as e:          # surfaced to every co-resident
            self._fail_rows(active, e)
            return
        retired = 0
        for i, r in active:
            for k, o in enumerate(np_outs):
                r.ys[k].append(o[i].copy())
            r.t += 1
            if r.t >= r.length:
                r.outputs = [np.stack(rows) for rows in r.ys]
                r.event.set()
                retired += 1
                with self._cond:
                    self._active[i] = None
        with self._lock:
            self._ticks += 1
            self._chunks += 1
            self._active_row_ticks += len(active)
            self._admitted += len(admitted)
            self._retired += retired
        profiler.add_fleet_stats(
            cont_ticks=1, cont_active_row_ticks=len(active),
            cont_slot_ticks=self.slots,
            cont_admitted=len(admitted), cont_retired=retired)

    def _stage_lone(self, ch, i, r, n, pos, reset, lone_ent):
        """The lone rung's inputs: the request's rows in lane `lane` of a
        width-W window of the state buffers starting at `start`."""
        K = ch.K
        W = lone_ent[1]
        start = min(i, self.slots - W)
        lane = i - start
        if n == K and W == 1:
            # the request's own contiguous rows are the chunk
            xs = r.seq[pos:pos + K].reshape((K, 1) + self._data_shape)
        else:
            xs = np.zeros((K, W) + self._data_shape, self._dtype)
            xs[:n, lane] = r.seq[pos:pos + n]
        lreset = np.zeros((W,), np.bool_)
        lreset[lane] = reset[i]
        ch.lone, ch.lane, ch.start = True, lane, start
        ch.xs, ch.reset = xs, lreset

    def _stage_full(self, ch, active, ns, pos, reset):
        K = ch.K
        exact = len(active) == self.slots and all(n == K for n in ns)
        xs = (np.empty if exact else np.zeros)(
            (K, self.slots) + self._data_shape, self._dtype)
        for (i, r), n, p in zip(active, ns, pos):
            xs[:n, i] = r.seq[p:p + n]
        ch.exact = exact
        ch.xs, ch.reset = xs, reset

    def _dispatch(self, ch):
        """Queue the chunk's K walks on the engine's stream and record the
        event after them; no host synchronisation."""
        ch.t_disp = time.perf_counter()
        dx, dreset = self._to_device([ch.xs, ch.reset])
        if ch.lone:
            fn, w = self._lone_steps[ch.K]
            ch.outs = fn(self._lone_executor(w), dx, dreset, ch.start,
                         ch.lane, self._states, self._weights(),
                         self._aux(), self._rng)
        else:
            ch.outs = self._chunk_steps[ch.K](
                self._ex, dx, dreset, self._states, self._weights(),
                self._aux(), self._rng)
        ch.done = self._record_done()

    def _chunk_once(self, active, admitted, reset):
        """K timesteps for every slot in one dispatch (tick_chunk=K): each
        request's min(K, remaining) rows are staged, and its output rows
        sliced out after. A slot whose sequence ends mid-chunk stays
        masked to the boundary; those slot-ticks are priced into
        boundary_wait_ms when requests were waiting. A lone active
        request runs the narrow rung; an exact-fill chunk skips the
        staging fill."""
        K = self.tick_chunk
        ns = [min(K, r.length - r.t) for _, r in active]
        ch = _StagedChunk(K)
        lone_ent = self._lone_steps.get(K) if len(active) == 1 \
            else None
        if lone_ent is not None:
            i, r = active[0]
            self._stage_lone(ch, i, r, ns[0], r.t, reset, lone_ent)
        else:
            self._stage_full(ch, active, ns, [r.t for _, r in active],
                             reset)
        try:
            self._dispatch(ch)
            np_outs = self._host_outputs(ch.outs, ch.done)
        except Exception as e:          # surfaced to every co-resident
            self._fail_rows(active, e)
            return
        wall_ms = (time.perf_counter() - ch.t_disp) * 1e3
        retired = 0
        wasted = 0                      # masked slot-ticks to the boundary
        for (i, r), n in zip(active, ns):
            col = ch.lane if ch.lone else i
            for k, o in enumerate(np_outs):
                for t in range(n):
                    r.ys[k].append(np.array(o[t, col]))
            r.t += n
            if r.t >= r.length:
                r.outputs = [np.stack(rows) for rows in r.ys]
                r.event.set()
                retired += 1
                wasted += K - n
                with self._cond:
                    self._active[i] = None
        with self._cond:
            waiting = len(self._queue)
        wait_ms = 0.0
        if wasted and waiting:
            # slot-ticks spent masked while requests queued, priced at
            # this chunk's measured per-tick time
            wait_ms = wasted * wall_ms / K
        self._count_chunk(K, sum(ns), len(admitted), retired, wait_ms,
                          ch.lone, ch.exact)
        if self._auto:
            self._auto_update(wall_ms, K)

    def _count_chunk(self, K, rows, admitted, retired, wait_ms, lone,
                     exact):
        with self._lock:
            self._ticks += K
            self._chunks += 1
            self._active_row_ticks += rows
            self._admitted += admitted
            self._retired += retired
            self._boundary_wait_ms += wait_ms
            self._lone_hits += int(lone)
            self._exact_fill += int(exact)
        profiler.add_fleet_stats(
            cont_ticks=K, cont_active_row_ticks=rows,
            cont_slot_ticks=K * self.slots,
            cont_admitted=admitted, cont_retired=retired,
            cont_chunks_dispatched=1, cont_chunk_ticks=K,
            cont_lone_fast_path=int(lone),
            cont_exact_fill_admits=int(exact),
            cont_boundary_wait_ms=wait_ms)

    # -- staged chunks ----------------------------------------------------
    def _staged_loop(self):
        """The pipelined loop: stage chunk t+1 and queue its walks while
        chunk t is still running, then drain t's outputs; up to
        1 + stage_ahead chunks in flight. Staging reads only what the
        host knows (positions, the queue, the requests' own inputs) and
        the walks are the same programs on the same stream, so the
        answers are the serialized loop's bits."""
        with self._cond:
            # rebuilt from the slots (not empty after an export_state
            # undo restarted the loop)
            self._sview = list(self._active)
        inflight = deque()
        depth = 1 + self._stage_ahead
        while True:
            with self._cond:
                while not self._closed and not self._halt and \
                        not self._queue and \
                        all(s is None for s in self._sview) and \
                        not inflight:
                    self._cond.wait()
                if self._halt:
                    break
                if self._closed and not self._queue and \
                        all(s is None for s in self._sview) and \
                        not inflight:
                    break
            while len(inflight) < depth:
                t0 = time.perf_counter()
                busy = bool(inflight)   # a chunk is on the device
                chunk = self._stage_next()
                if chunk is None:
                    break
                self._dispatch_staged(chunk)
                inflight.append(chunk)
                if busy:
                    dt = (time.perf_counter() - t0) * 1e3
                    with self._lock:
                        self._staged_chunks += 1
                        self._stage_overlap_ms += dt
                    profiler.add_fleet_stats(cont_staged_chunks=1,
                                             cont_stage_overlap_ms=dt)
                    profiler.add_overlap_stats(stage_chunks=1,
                                               stage_overlap_ms=dt)
            if inflight:
                self._process_staged(inflight.popleft())
        # halt (export_state): every dispatched chunk is drained, so the
        # export sees one chunk boundary
        while inflight:
            self._process_staged(inflight.popleft())

    def _stage_next(self):
        """Admission and host staging of the next chunk against the
        staged slot view (a slot frees when its request's staged position
        reaches its length). None when no slot would be active."""
        with self._cond:
            if self._halt:
                return None
            view = self._sview
            for i in range(self.slots):
                r = view[i]
                if r is not None and r.staged_t >= r.length:
                    view[i] = None
            can_admit = any(s is None for s in view) \
                if not self.convoy else all(s is None for s in view)
            admits = []
            if can_admit:
                for i in range(self.slots):
                    if view[i] is None and self._queue:
                        req = self._queue.popleft()
                        req.staged_t = req.t
                        if req.ys is None:
                            req.ys = [[] for _ in self._y_idx]
                        view[i] = req
                        admits.append((i, req))
            active = [(i, r) for i, r in enumerate(view)
                      if r is not None]
            waiting = len(self._queue)
        if not active:
            return None
        K = self.tick_chunk
        reset = np.zeros((self.slots,), np.bool_)
        mig = []
        for i, req in admits:
            if req.mig_state is not None:
                mig.append((i, req.mig_state))
                req.mig_state = None
            else:
                reset[i] = True
        ns = [min(K, r.length - r.staged_t) for _, r in active]
        ch = _StagedChunk(K)
        ch.mig = mig
        ch.admits = admits
        ch.waiting = waiting
        lone_ent = self._lone_steps.get(K) if len(active) == 1 \
            else None
        if lone_ent is not None:
            i, r = active[0]
            self._stage_lone(ch, i, r, ns[0], r.staged_t, reset, lone_ent)
        else:
            self._stage_full(ch, active, ns,
                             [r.staged_t for _, r in active], reset)
        ch.rows = [(i, r, n) for (i, r), n in zip(active, ns)]
        for _i, r, n in ch.rows:
            r.staged_t += n
        return ch

    def _dispatch_staged(self, ch):
        """Queue the staged chunk behind the chunks in flight (the state
        buffers carry the order on the stream). An exception is kept on
        the chunk and raised when it is processed."""
        try:
            if ch.mig:
                self._write_mig(ch.mig)
            self._dispatch(ch)
        except Exception as e:
            ch.error = e

    def _process_staged(self, ch):
        """Drain one dispatched chunk: wait for its outputs, slice each
        request's rows, advance the positions, retire, count; the
        serialized loop's bookkeeping one stage later."""
        try:
            if ch.error is not None:
                raise ch.error
            np_outs = self._host_outputs(ch.outs, ch.done)
        except Exception as e:          # surfaced to every co-resident
            self._fail_rows([(i, r) for i, r, _n in ch.rows], e)
            # the chunk's in-place state writes are suspect: start the
            # next admissions from zero state
            with torch.inference_mode():
                for s in self._states:
                    s.zero_()
            return
        K = ch.K
        now = time.perf_counter()
        wall_ms = (now - ch.t_disp) * 1e3
        retired = 0
        wasted = 0
        for i, r, n in ch.rows:
            col = ch.lane if ch.lone else i
            for k, o in enumerate(np_outs):
                for t in range(n):
                    r.ys[k].append(np.array(o[t, col]))
            r.t += n
            if r.t >= r.length:
                r.outputs = [np.stack(rows) for rows in r.ys]
                r.event.set()
                retired += 1
                wasted += K - n
                with self._cond:
                    self._active[i] = None
                    if self._sview[i] is r:
                        self._sview[i] = None
            else:
                with self._cond:
                    self._active[i] = r
        wait_ms = 0.0
        if wasted and ch.waiting:
            # priced against the queue depth at staging time
            wait_ms = wasted * wall_ms / K
        self._count_chunk(K, sum(n for _i, _r, n in ch.rows),
                          len(ch.admits), retired, wait_ms, ch.lone,
                          ch.exact)
        if self._auto:
            # a pipelined chunk's dispatch-to-done time includes the chunk
            # before it; completion to completion is the honest estimate
            # while the pipeline is busy: take the smaller
            last = self._last_done
            est = wall_ms if last is None else \
                min(wall_ms, (now - last) * 1e3)
            self._auto_update(est, K)
        self._last_done = now

    def _auto_update(self, wall_ms, K):
        """Fold one chunk's time into the per-tick EMA and re-derive K
        against the deadline, down to a warmed rung (tick_chunk='auto');
        on the tick-loop thread only."""
        tick_ms = wall_ms / K
        ema = self._tick_ms_ema
        self._tick_ms_ema = tick_ms if ema is None else \
            _TICK_EMA_ALPHA * tick_ms + (1 - _TICK_EMA_ALPHA) * ema
        new_k = self._quantize_k(chunk_for_deadline(
            self._deadline_ms, self._tick_ms_ema, self.slots))
        if new_k != self.tick_chunk:
            self.tick_chunk = new_k
            with self._lock:
                self._auto_decisions += 1
            profiler.add_overlap_stats(auto_k=new_k,
                                       auto_k_decisions=1)

    # -- lifecycle --------------------------------------------------------
    def close(self, timeout=30):
        """Refuse new work, drain (queued and in-flight sequences finish),
        join the tick loop. Idempotent and safe from a registry eviction
        while another thread is in infer()."""
        with self._close_lock:
            if self._closed and not self._started:
                return self
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            if self._started:
                self._loop.join(timeout=timeout)
                if self._loop.is_alive():
                    warnings.warn('ContinuousEngine.close(): tick loop '
                                  'still running after %ss; call '
                                  'close() again to re-join' % timeout)
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
        except Exception:               # interpreter teardown
            pass


# ---------------------------------------------------------------------------
# the step programs of continuous batching
# ---------------------------------------------------------------------------

def _cont_cell_plumbing(ex, data_name, state_names, state_out_idx,
                        init_states, device):
    """The cell executor's argument layout, the non-state output indices
    and the admission init values (None for zeros; tensors on `device`
    otherwise, which the program then holds)."""
    names = list(ex.arg_dict)
    data_pos = names.index(data_name)
    state_pos = [names.index(s) for s in state_names]
    skip = set(state_names) | {data_name}
    other_pos = [i for i, n in enumerate(names) if n not in skip]
    y_idx = [i for i in range(len(ex._out_entries))
             if i not in set(state_out_idx)]
    inits = None
    if init_states:
        inits = [torch.as_tensor(np.asarray(init_states[s]),
                                 dtype=ex.arg_dict[s]._data.dtype,
                                 device=device)
                 for s in state_names]
    return (len(names), data_pos, state_pos, other_pos, y_idx, inits)


def _cached(ex, kind, data_name, state_names, state_out_idx,
            init_states, make, chunk=None, width=None):
    """The program of `kind` from exec_cache (zeros init only: a program
    holding init values is not shared), else made by `make` and put
    there; a build is a miss of the cache's counters."""
    key = None
    if ex._sig is not None and not init_states:
        key = exec_cache.cont_step_key(ex._sig, kind, data_name,
                                       state_names, state_out_idx,
                                       chunk=chunk, width=width)
        fn = exec_cache.get(key, count=True)
        if fn is not None:
            return fn
    t0 = time.perf_counter()
    fn = exec_cache.TimedJit(make())
    exec_cache.note_compile(time.perf_counter() - t0)
    if key is not None:
        exec_cache.put(key, fn)
    return fn


def _tick_fn(n_args, data_pos, state_pos, other_pos, state_out_idx, y_idx):
    """One timestep: the cell walk on (x, states, weights); returns (next
    states, per-step outputs)."""
    def tick(ex, x, states, weight_vals, aux_vals, rng):
        merged = [None] * n_args
        merged[data_pos] = x
        for i, v in zip(state_pos, states):
            merged[i] = v
        for i, v in zip(other_pos, weight_vals):
            merged[i] = v
        outs = ex.serve(merged, aux_vals, rng)
        return ([outs[i] for i in state_out_idx],
                [outs[i] for i in y_idx])
    return tick


def _reset(states, reset, inits):
    """`torch.where(reset[:, None], init, state)` for each state."""
    out = []
    for k, v in enumerate(states):
        mask = reset.reshape((-1,) + (1,) * (v.ndim - 1))
        init = inits[k] if inits is not None else v.new_zeros(())
        out.append(torch.where(mask, init, v))
    return out


def _make_cont_step(ex, data_name, state_names, state_out_idx,
                    init_states, device):
    """The single-tick program, step(ex, x, reset, states, weights, aux,
    rng) -> per-step outputs: the reset, one walk for every slot, the
    next states written into `states` in place. Cached process-wide
    under exec_cache.cont_step_key."""
    (n_args, data_pos, state_pos, other_pos, y_idx,
     inits) = _cont_cell_plumbing(ex, data_name, state_names,
                                  state_out_idx, init_states, device)

    def make():
        tick = _tick_fn(n_args, data_pos, state_pos, other_pos,
                        state_out_idx, y_idx)

        def step(ex, x, reset, states, weight_vals, aux_vals, rng):
            with torch.inference_mode():
                new, ys = tick(ex, x, _reset(states, reset, inits),
                               weight_vals, aux_vals, rng)
                for buf, v in zip(states, new):
                    buf.copy_(v)
            return tuple(ys)
        return step
    return _cached(ex, 'cont_step', data_name, state_names, state_out_idx,
                   init_states, make)


def _make_cont_chunk_step(ex, data_name, state_names, state_out_idx,
                          init_states, device, chunk):
    """The K-tick program, chunk_step(ex, xs, reset, states, weights, aux,
    rng) -> outputs stacked (K, slots, ...): the reset before the first
    tick, then K walks queued back to back with no host synchronisation
    (the port's counterpart of the JAX package's lax.scan), the final
    states written into `states` in place (the donation). Each walk is
    the single-tick program's math, so a chunked answer is bit-equal to
    the unchunked loop's. Cached under exec_cache.cont_step_key, which
    carries K."""
    (n_args, data_pos, state_pos, other_pos, y_idx,
     inits) = _cont_cell_plumbing(ex, data_name, state_names,
                                  state_out_idx, init_states, device)

    def make():
        tick = _tick_fn(n_args, data_pos, state_pos, other_pos,
                        state_out_idx, y_idx)

        def chunk_step(ex, xs, reset, states, weight_vals, aux_vals, rng):
            with torch.inference_mode():
                cur = _reset(states, reset, inits)
                ys = [[] for _ in y_idx]
                for t in range(chunk):
                    cur, y = tick(ex, xs[t], cur, weight_vals, aux_vals,
                                  rng)
                    for acc, v in zip(ys, y):
                        acc.append(v)
                for buf, v in zip(states, cur):
                    buf.copy_(v)
                return tuple(torch.stack(acc) for acc in ys)
        return chunk_step
    return _cached(ex, 'cont_chunk_step', data_name, state_names,
                   state_out_idx, init_states, make, chunk=chunk)


def _make_cont_lone_step(ex, data_name, state_names, state_out_idx,
                         init_states, device, chunk, width):
    """The lone-request rung, lone_step(ex_w, xs, reset, start, lane,
    states, weights, aux, rng) -> outputs (K, width, ...): when one slot
    is active its K ticks run at batch `width` on the cell bound at that
    width (`ex_w`, sharing the weights). The width-row window of the
    state buffers starting at `start` is read with `narrow`; the request
    lives in lane `lane` of it, and only its final row is written back
    with `index_copy_` (the padding lanes' state is dropped), so the
    buffers' other rows are untouched. Cached under its own
    cont_step_key kind, carrying K and the width."""
    (n_args, data_pos, state_pos, other_pos, y_idx,
     inits) = _cont_cell_plumbing(ex, data_name, state_names,
                                  state_out_idx, init_states, device)

    def make():
        tick = _tick_fn(n_args, data_pos, state_pos, other_pos,
                        state_out_idx, y_idx)

        def lone_step(ex_w, xs, reset, start, lane, states, weight_vals,
                      aux_vals, rng):
            with torch.inference_mode():
                rows = _reset([v.narrow(0, start, width) for v in states],
                              reset, inits)
                ys = [[] for _ in y_idx]
                for t in range(chunk):
                    rows, y = tick(ex_w, xs[t], rows, weight_vals,
                                   aux_vals, rng)
                    for acc, v in zip(ys, y):
                        acc.append(v)
                idx = torch.full((1,), start + lane, dtype=torch.long,
                                 device=xs.device)
                for v, r in zip(states, rows):
                    v.index_copy_(0, idx, r.narrow(0, lane, 1))
                return tuple(torch.stack(acc) for acc in ys)
        return lone_step
    return _cached(ex, 'cont_lone_step', data_name, state_names,
                   state_out_idx, init_states, make, chunk=chunk,
                   width=width)


# ---------------------------------------------------------------------------
# HTTP front (stdlib http.server)
# ---------------------------------------------------------------------------

class _FleetHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: socketserver's default of 5 resets the
    # connections of a burst of clients that connect at once
    request_queue_size = 128


class _FleetHandler(BaseHTTPRequestHandler):
    """POST /v1/models/<name>:predict   {"inputs": {name: nested-list}}
                                     or {"instances": nested-list}
       GET  /healthz                    liveness
       GET  /statsz                     registry + fleet counters

    Errors: unknown model 404, malformed request 400, `Overloaded` or a
    full admission gate 429 (+ Retry-After), strict budget 507, registry
    closed 503, anything else 500. Every predict passes the front's
    bounded in-flight gate first, so a flood turns into fast 429s."""

    protocol_version = 'HTTP/1.1'
    server_version = 'mxt-serve/1.0'

    def log_message(self, fmt, *args):  # quiet: the profiler counts
        pass

    def _read_body(self):
        """Drain the request body; runs before any reply, since unread
        bytes on a keep-alive connection would be parsed as the next
        request line."""
        try:
            n = int(self.headers.get('Content-Length', 0) or 0)
        except ValueError:
            n = 0
        return self.rfile.read(n) if n > 0 else b''

    def _reply(self, code, payload, retry_after_ms=None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        if retry_after_ms is not None:
            self.send_header('Retry-After',
                             '%d' % max(1, int(retry_after_ms / 1000.0)
                                        + 1))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        front = self.server.front
        if self.path == '/healthz':
            if front.closed or front.registry.closed:
                self._reply(503, {'status': 'closing'})
            else:
                self._reply(200, {'status': 'ok',
                                  'models': front.registry.models()})
        elif self.path == '/statsz':
            stats = front.registry.stats()
            stats['fleet'] = profiler.fleet_stats()
            stats['http'] = front.stats()
            self._reply(200, stats)
        else:
            self._reply(404, {'error': 'not found', 'path': self.path})

    def do_POST(self):
        front = self.server.front
        profiler.add_fleet_stats(http_requests=1)
        front.note_request()
        raw = self._read_body()         # drain before any reply
        name = _predict_model(self.path)
        if name is None:
            self._reply(404, {'error': 'not found', 'path': self.path})
            return
        if not front.admit(name):
            profiler.add_fleet_stats(http_429=1)
            front.note_429()
            self._reply(429, {'error': 'overloaded',
                              'reason': 'in-flight limit',
                              'model': name},
                        retry_after_ms=1000)
            return
        try:
            try:
                body = json.loads(raw or b'{}')
                pos, named = _decode_inputs(body)
            except (ValueError, TypeError) as e:
                self._reply(400, {'error': 'bad request',
                                  'detail': str(e)})
                return
            try:
                outs = front.registry.infer(name, *pos, **named)
            except BudgetExceeded as e:
                self._reply(507, {'error': 'insufficient storage',
                                  'model': name,
                                  'need_bytes': e.need_bytes,
                                  'budget_bytes': e.budget_bytes})
                return
            except Overloaded as e:
                profiler.add_fleet_stats(http_429=1)
                front.note_429()
                self._reply(429, {'error': 'overloaded',
                                  'model': name,
                                  'backlog_rows': e.backlog_rows,
                                  'est_ms': _json_num(e.est_ms),
                                  'deadline_ms': e.deadline_ms},
                            retry_after_ms=e.retry_after_ms)
                return
            except MXNetError as e:
                msg = str(e)
                if 'unknown model' in msg:
                    self._reply(404, {'error': 'unknown model',
                                      'model': name})
                elif 'closed' in msg:
                    self._reply(503, {'error': 'closing'})
                else:
                    self._reply(400, {'error': 'bad request',
                                      'detail': msg})
                return
            except Exception as e:      # pragma: no cover - safety net
                self._reply(500, {'error': 'internal',
                                  'detail': str(e)})
                return
            self._reply(200,
                        {'outputs': [np.asarray(o).tolist()
                                     for o in outs]})
        finally:
            front.release(name)


def _predict_model(path):
    """Model name from /v1/models/<name>:predict, else None."""
    prefix, suffix = '/v1/models/', ':predict'
    if path.startswith(prefix) and path.endswith(suffix):
        name = path[len(prefix):-len(suffix)]
        if name and '/' not in name:
            return name
    return None


def _decode_inputs(body):
    """JSON body -> (positional, named) numpy inputs: {"inputs": {...}}
    feeds named inputs, {"instances": [...]} one positional array."""
    if not isinstance(body, dict):
        raise ValueError('JSON object body required')
    if 'inputs' in body:
        named = body['inputs']
        if not isinstance(named, dict):
            raise ValueError('"inputs" must be an object of arrays')
        return (), {k: np.asarray(v) for k, v in named.items()}
    if 'instances' in body:
        return (np.asarray(body['instances']),), {}
    raise ValueError('body needs "inputs" or "instances"')


def _json_num(x):
    return None if x is None or not np.isfinite(x) else float(x)


class HttpFront(object):
    """The fleet's HTTP surface: a threaded stdlib server over a
    ModelRegistry with bounded in-flight admission. At most
    `max_inflight` predicts run at once, and the last `priority_reserve`
    slots admit only models whose SLO priority is >= 1, so under pressure
    the batch tenants 429 first.

    Usage::

        front = HttpFront(registry, port=8000).start()
        ...
        front.close()
    """

    def __init__(self, registry, host='127.0.0.1', port=None,
                 max_inflight=None, priority_reserve=None,
                 handler_cls=None):
        self.registry = registry
        self.max_inflight = int(
            max_inflight if max_inflight is not None else
            _env_int('MXNET_TPU_SERVE_HTTP_INFLIGHT', 64))
        if priority_reserve is None:
            priority_reserve = max(1, self.max_inflight // 8) \
                if self.max_inflight > 1 else 0
        self.priority_reserve = int(priority_reserve)
        self._lock = threading.Lock()
        self._inflight = 0
        self._n_requests = 0
        self._n_429 = 0
        self._closed = False
        port = int(port if port is not None else
                   _env_int('MXNET_TPU_SERVE_HTTP_PORT', 8000))
        self._server = _FleetHTTPServer((host, port),
                                        handler_cls or _FleetHandler)
        self._server.front = self
        self._thread = None

    @property
    def address(self):
        """(host, port) bound (port 0 resolves here)."""
        return self._server.server_address[:2]

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name='mxt-serve-http', daemon=True)
            self._thread.start()
        return self

    def admit(self, name):
        """Bounded admission; the reserve admits only priority >= 1
        models; an unknown model passes (the handler 404s it)."""
        if self._closed:
            return False
        prio = 0
        try:
            prio = self.registry._entry(name).slo.priority
        except MXNetError:
            pass
        with self._lock:
            limit = self.max_inflight if prio >= 1 else \
                self.max_inflight - self.priority_reserve
            if self._inflight >= limit:
                return False
            self._inflight += 1
            return True

    def release(self, name):
        with self._lock:
            self._inflight -= 1

    def note_request(self):
        with self._lock:
            self._n_requests += 1

    def note_429(self):
        with self._lock:
            self._n_429 += 1

    def stats(self):
        with self._lock:
            return {'inflight': self._inflight,
                    'max_inflight': self.max_inflight,
                    'priority_reserve': self.priority_reserve,
                    'requests': self._n_requests,
                    'rejected_429': self._n_429}

    @property
    def closed(self):
        return self._closed

    def close(self):
        """Stop accepting, shut the server down and join its thread
        (idempotent). The registry stays open: it may outlive the front
        or serve several."""
        if self._closed:
            return self
        self._closed = True
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
