"""Process-wide cache of serve programs, the counterpart of
mxnet_tpu/exec_cache.py.

There is nothing to compile in the port: PyTorch runs a graph op by op.
What the JAX package caches as a jitted XLA program, the port caches as
a *program*: one shape rung's serve function, built for a bound
executor of that rung (`serving._make_serve_fn`), keyed on the rung
executor's canonical graph signature (`graph_signature`, taken at bind
as `Executor._sig`) and the serve key's other tokens (`serve_step_key`).
The counters keep the JAX package's names and count program builds
in the process: `misses` is the number of programs built, `hits` the
lookups that found one, and `total_compile_s` the host time spent
building them and running each one's first call (`TimedJit`: cuDNN's
and cuBLAS's per-shape setup, the allocator's first blocks). A second
engine over the same graph finds its rungs' programs here, yet it binds
each rung's executor itself: an engine counts its own rung builds
(`InferenceEngine.stats()['compiles_after_warmup']`), not these.

The cache is always on and holds MAX_ENTRIES programs, least recently
used first out. XLA's on-disk compilation cache
(`setup_persistent_cache` in the JAX package) has no counterpart.
"""
import os
import threading
import time
from collections import OrderedDict

_LOCK = threading.RLock()
_CACHE = OrderedDict()          # signature-scoped key -> cached object
_STATS = {'hits': 0, 'misses': 0, 'total_compile_s': 0.0}
MAX_ENTRIES = 64                # LRU bound

# Every env knob whose value changes what an executor's graph walk
# computes joins the signature, read at bind: MXNET_TPU_LAYOUT_OPT, the
# NHWC layout pass, and MXNET_TPU_STEM_SPLIT, the stem split. (The JAX
# package's conv layout knob has no counterpart in the port.)
TRACE_ENV_KNOBS = (
    ('MXNET_TPU_LAYOUT_OPT', 'auto'),
    ('MXNET_TPU_STEM_SPLIT', '1'),
)


def _dtype_str(dtype):
    """numpy's dtype string ('<f4') where numpy has the dtype, else the
    dtype's name ('bfloat16')."""
    import numpy as np
    from .base import dtype_name
    name = dtype_name(dtype)
    return name if name == 'bfloat16' else np.dtype(name).str


# ---------------------------------------------------------------------------
# canonical graph signature
# ---------------------------------------------------------------------------

def graph_signature(symbol, ctx, arg_dict, aux_dict, grad_req,
                    group2ctx=None, remat_mode='none'):
    """Hashable canonical form of everything that determines an
    executor's graph walk. Node *names* are left out (auto-naming
    counters differ between two builds of the same net): variables appear
    as their position in the arg/aux lists with shape, dtype and
    grad_req, ops as (op, sorted attrs, input wiring by topo index,
    ctx_group)."""
    topo = symbol._topo()
    index = {id(n): i for i, n in enumerate(topo)}
    arg_pos = {n: i for i, n in enumerate(arg_dict)}
    aux_pos = {n: i for i, n in enumerate(aux_dict)}
    nodes = []
    for n in topo:
        if n.op is None:
            if n.name in arg_pos:
                a = arg_dict[n.name]
                nodes.append(('arg', arg_pos[n.name], tuple(a.shape),
                              _dtype_str(a._data.dtype),
                              grad_req.get(n.name, 'null')))
            elif n.name in aux_pos:
                a = aux_dict[n.name]
                nodes.append(('aux', aux_pos[n.name], tuple(a.shape),
                              _dtype_str(a._data.dtype)))
            else:       # unbound variable: name is the only identity
                nodes.append(('unbound', n.name))
        else:
            attrs = tuple(sorted((str(k), repr(v))
                          for k, v in n.attrs.items()))
            ins = tuple((index[id(s)], oi) for s, oi in n.inputs)
            nodes.append(('op', n.op.name, attrs, ins,
                          n.user_attrs.get('ctx_group')))
    outs = tuple((index[id(n)], oi) for n, oi in symbol._outputs)
    groups = tuple(sorted((k, str(v))
                   for k, v in (group2ctx or {}).items()))
    env = (remat_mode,) + tuple(os.environ.get(k, d)
                                for k, d in TRACE_ENV_KNOBS)
    return (str(ctx), tuple(nodes), outs, groups, env)


# ---------------------------------------------------------------------------
# cache proper
# ---------------------------------------------------------------------------

def get(key, count=False):
    """Lookup. count=True records a hit or miss in the stats."""
    with _LOCK:
        found = key in _CACHE
        if found:
            _CACHE.move_to_end(key)
        if count:
            _STATS['hits' if found else 'misses'] += 1
        return _CACHE[key] if found else None


def put(key, value):
    with _LOCK:
        _CACHE[key] = value
        _CACHE.move_to_end(key)
        while len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
    return value


def note_compile(seconds):
    """Account the host time of one program build (or first call)."""
    with _LOCK:
        _STATS['total_compile_s'] += float(seconds)


def stats():
    with _LOCK:
        return dict(_STATS)


# ---------------------------------------------------------------------------
# serving bucket ladder
# ---------------------------------------------------------------------------
# The serving engine (serving.py) pads requests up to a ladder of bucket
# shapes; each rung binds its own executor, whose graph signature (shape
# included) is its program's cache identity: warming the ladder fills
# this cache, and steady-state traffic reuses the rungs with no new
# build.

def batch_ladder(max_batch, min_batch=1):
    """Default batch-dim bucket ladder: powers of two from min_batch up
    to and including max_batch (always included even when not a power of
    two)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError('max_batch must be >= 1')
    out = []
    b = max(1, int(min_batch))
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def train_ladder(bucket_keys):
    """Normalized training bucket ladder: sorted unique rung keys (ints,
    or equal-length tuples ordered lexicographically), the training
    analog of batch_ladder (BucketingModule pads each batch up to its
    covering rung, `ladder_rung`)."""
    keys = sorted(set(bucket_keys))
    if not keys:
        raise ValueError('train_ladder: empty bucket ladder')
    return tuple(keys)


def _rung_covers(rung, key):
    r_seq = isinstance(rung, (tuple, list))
    k_seq = isinstance(key, (tuple, list))
    if r_seq != k_seq:
        return False        # int ladder vs tuple key (or vice versa)
    if r_seq:
        return len(rung) == len(key) and \
            all(int(r) >= int(k) for r, k in zip(rung, key))
    return rung >= key


def ladder_rung(ladder, key):
    """Smallest rung of `ladder` (a train_ladder tuple) covering `key`,
    every extent >= the key's (elementwise for tuple keys), or None when
    no rung covers it."""
    for rung in ladder:
        if _rung_covers(rung, key):
            return rung
    return None


def embed_plan_key(positions, vocabs, dims, rungs=None):
    """Hashable identity of a sparse-embedding plan as it joins a
    program's cache key: which parameter slots are sparse tables, their
    (vocab, dim) geometry, and the unique-count rungs when
    rung-resolved."""
    key = ('embed', tuple(int(p) for p in positions),
           tuple(int(v) for v in vocabs), tuple(int(d) for d in dims))
    if rungs is not None:
        key += (tuple(int(r) for r in rungs),)
    return key


def serve_step_key(sig, input_names=(), quant=None, embed=None):
    """Cache key of one bucket rung's serve program. `sig` is the rung
    executor's graph signature (shape-distinct per rung). `input_names`
    is the engine's input order: the signature renames variables away,
    but the serve function maps data values to arguments by it, so
    engines with differently-ordered inputs must not share a program.
    `quant` is a quantized engine's token (QuantConfig.key of the
    quantized weight positions): its program takes int8 codes and scales
    and dequantizes them, so it never aliases the fp program. `embed` is
    a hot-row engine's token."""
    return (sig, 'serve_step', tuple(input_names)) + \
        (() if quant is None else (quant,)) + \
        (() if embed is None else (('hotrow',) + tuple(embed),))


def cont_step_key(sig, kind, data_name, state_names, state_out_idx,
                  chunk=None, width=None):
    """Cache key of one continuous-batching tick program: the cell
    executor's signature, the program family `kind` ('cont_step',
    'cont_chunk_step', 'cont_lone_step'), the chunk length of the
    chunked kinds and the lone rung's batch width."""
    key = (sig, kind, data_name, tuple(state_names),
           tuple(int(i) for i in state_out_idx))
    if chunk is not None:
        key += (('chunk', int(chunk)),)
    if width is not None:
        key += (('lone_width', int(width)),)
    return key


def gluon_step_key(fingerprint, step_key, mode, k, placement):
    """Cache key of one fused Gluon train-step program: the step's
    fingerprint, the optimizer's step key, single or K-step `mode`, `k`
    and the device placement."""
    return ('gluon_fused', fingerprint, step_key, mode, int(k),
            placement)


def clear(reset_stats=True):
    """Drop every cached program (tests, memory pressure)."""
    with _LOCK:
        _CACHE.clear()
        if reset_stats:
            for k in _STATS:
                _STATS[k] = 0.0 if k == 'total_compile_s' else 0


def size():
    with _LOCK:
        return len(_CACHE)


class TimedJit:
    """A program's callable that bills the host time of its first call
    to the process counters, as the JAX package's wrapper bills the
    calls that compile: in the port the first call of a rung is where
    cuDNN and cuBLAS set up for its shapes. Later calls pass through."""

    __slots__ = ('fn', 'called')

    def __init__(self, fn):
        self.fn = fn
        self.called = False

    def __call__(self, *args):
        if self.called:
            return self.fn(*args)
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.called = True
        note_compile(time.perf_counter() - t0)
        return out
