"""Incremental weight deltas, the counterpart of mxnet_tpu/delta.py: move
only what changed.

The train->serve loop moves *full model images* at every boundary:
each checkpoint commit writes every shard, each fleet push ships a
complete serving export, each registry page-in rehydrates the whole
host image.  But a training step rarely changes everything: sparse
embedding updates touch a handful of rows (the PR 16 touched-rows
path measures 195-390x less gradient traffic than dense), and dense
diffs between adjacent checkpoints compress to int8 with error
feedback the same way the distributed wire codec's gradient streams
do (quantization.WireCodec, PR 13).

This module is the ONE shared delta representation all three layers
speak:

  * elastic.CheckpointManager(incremental=K) — delta files between
    full bases, crash-safe manifest chaining, chain replay at resume;
  * fleet_supervisor.CheckpointPusher — per-commit weight deltas over
    the push channel when the fleet's resident base fingerprint
    matches (full-push fallback on mismatch/divergence);
  * serving.InferenceEngine.apply_delta / the registry's quantized
    page images — in-place resident updates at zero re-warm compiles.

Format
------
A delta is a pair (shard entries, JSON meta) built against a *base
state* — a flat ``{name: np.ndarray}`` dict.  Chain identity is a
``fingerprint`` of the base (content digest) plus a monotonically
increasing ``seq``; applying a delta whose ``base_fp`` does not match
the resident state's fingerprint raises the typed DeltaChainError
(the full-push fallback signal).  Three entry kinds, chosen per
array:

  rows   touched-rows COO for >=2-D arrays where few rows changed
         (sparse embedding tables, single-row edits of dense
         matrices): ``dids:NAME`` int32 row ids + ``drows:NAME`` raw
         row payloads.  BITWISE-exact on apply.
  int8   dense diff quantized to int8 with a per-tensor symmetric
         scale (``dq:NAME`` codes + ``dscale:NAME``); the encoder's
         chain state carries the bidirectional error-feedback
         residual: each new diff is computed against the APPLIED
         value (base + dequantized history), so quantization error
         never accumulates beyond one step — exactly WireCodec's
         error-feedback discipline at checkpoint granularity.  Lossy;
         gated by the recorded relative error at apply time.
  raw    verbatim new value (``draw:NAME``) for small arrays, ints,
         RNG keys — exact.

Every entry's meta carries a crc32 of the EXPECTED post-apply bytes:
both sides compute ``new = f(base, delta)`` with the same numpy ops,
so matching crcs prove the applier's base was bit-identical to the
encoder's chain state (divergence -> DeltaChainError, nothing
mutated).  ``meta['rel_err']`` records the encoder-measured distance
of the applied chain state from the TRUE weights — the parity gate
vs a full reload on the lossy path.

The port's states are host arrays (`_hostarray`): numpy, and torch CPU
tensors for bfloat16. Codes, payload bytes, crcs and fingerprints equal
the JAX package's for the same state, so a delta written by either
package applies in the other.

Where the port departs from the JAX package: an int8 entry whose
measured relative error is not finite (a NaN or inf in the current
value or the diff) records ``rel_err`` inf, in the entry and in the
meta, so that ``apply_delta(parity_tol=...)`` refuses it with
DeltaParityError. The JAX package's ``max(worst, rel)`` drops a NaN,
records 0.0, and its parity gate passes a delta whose applied
elements are all NaN.
"""
import hashlib
import os
import zlib

import numpy as np

from . import _hostarray as ha
from .base import MXNetError
from . import quantization

DELTA_FORMAT_VERSION = 1

# shard-entry name prefixes (elastic.write_shard_file containers)
_KIND_IDS = 'dids:'
_KIND_ROWS = 'drows:'
_KIND_CODES = 'dq:'
_KIND_SCALE = 'dscale:'
_KIND_RAW = 'draw:'


class DeltaChainError(MXNetError):
    """Typed chain break: the delta's base fingerprint / sequence does
    not match the resident state (or a per-entry crc proves the bytes
    diverged).  The receiver mutates NOTHING; the sender's correct
    response is a full push / full checkpoint (rebase)."""


class DeltaParityError(MXNetError):
    """Typed lossy-parity refusal: the encoder-measured relative error
    of the delta-applied state vs the true weights exceeds the
    receiver's tolerance.  Nothing is mutated."""

    def __init__(self, what, measured, tol):
        self.what = what
        self.measured = float(measured)
        self.tol = float(tol)
        super().__init__(
            'delta parity gate failed for %s: applied-state relative '
            'error %.6f exceeds tolerance %.6f (nothing mutated; '
            'full reload required)' % (what, self.measured, self.tol))


class DeltaConfig(object):
    """Knobs of the delta encoder.

    dense: 'int8' (quantized diffs with error feedback — the push
      channel default) or 'raw' (verbatim diff rows/values — exact;
      the incremental-CHECKPOINT default, so chain replay at resume
      stays bit-identical to the uninterrupted run).
    sparse_frac: a >=2-D array whose changed-row fraction is <= this
      is encoded as touched-rows COO (exact) instead of a dense diff.
    min_dense: arrays smaller than this (elements) are stored raw —
      int8 scales + ids overhead beats nothing on tiny tensors.
    parity_tol: default apply-side tolerance for the lossy gate
      (receivers may override per call).
    """

    __slots__ = ('dense', 'sparse_frac', 'min_dense', 'parity_tol')

    def __init__(self, dense='int8', sparse_frac=0.5, min_dense=1024,
                 parity_tol=0.05):
        if dense not in ('int8', 'raw'):
            raise MXNetError("DeltaConfig dense=%r (want 'int8' or "
                             "'raw')" % (dense,))
        self.dense = dense
        self.sparse_frac = float(sparse_frac)
        self.min_dense = int(min_dense)
        self.parity_tol = float(parity_tol)

    @classmethod
    def resolve(cls, value, **defaults):
        if value is None:
            return cls(**defaults)
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(dense=value, **{k: v for k, v in
                                       defaults.items()
                                       if k != 'dense'})
        raise MXNetError('cannot resolve %r into a DeltaConfig'
                         % (value,))


def fingerprint(state):
    """Content digest of a flat ``{name: array}`` state — the chain
    identity deltas are built and verified against.  Stable across
    processes and packages (name-sorted; covers dtype, shape and raw
    bytes)."""
    h = hashlib.sha1()
    for name in sorted(state):
        a = ha.contiguous(ha.host(state[name]))
        h.update(name.encode('utf-8'))
        h.update(ha.dtype_name(a).encode('utf-8'))
        h.update(str(tuple(a.shape)).encode('utf-8'))
        h.update(_bytes_of(a))
    return h.hexdigest()[:16]


def _bytes_of(a):
    """Raw bytes of a host array."""
    return ha.raw_bytes(ha.host(a)).tobytes()


def _crc(a):
    return zlib.crc32(ha.raw_bytes(ha.host(a))) & 0xffffffff


def state_nbytes(state):
    return int(sum(ha.nbytes(ha.host(a)) for a in state.values()))


def _size(a):
    return int(np.prod(a.shape)) if len(a.shape) else 1


def _values(a):
    """numpy values to compare (bfloat16 exactly as float32)."""
    return ha.to_float32(a) if ha.is_torch(a) else a


def _changed_rows(b, c):
    flat_b = _values(b).reshape(b.shape[0], -1)
    flat_c = _values(c).reshape(c.shape[0], -1)
    return np.any(flat_b != flat_c, axis=1)


def _take_rows(a, ids):
    """Rows `ids` of `a` (flattened past the first axis), a's kind."""
    flat = ha.bits(a).reshape(a.shape[0], -1)
    rows = np.ascontiguousarray(flat[ids])
    return ha.from_bits(rows, ha.dtype_name(a)) if ha.is_torch(a) \
        else rows


def _as_dtype_of(x, like):
    """Host array `x` in `like`'s dtype (as it is when they agree)."""
    x = ha.host(x)
    if ha.dtype_name(x) == ha.dtype_name(like):
        return x
    return ha.from_float32(ha.to_float32(x), like) if ha.is_torch(like) \
        else np.asarray(_values(x)).astype(like.dtype)


def make_delta(base, current, seq, base_fp, config=None):
    """Encode ``current - base`` as one delta.

    base/current: flat ``{name: np.ndarray}`` with IDENTICAL key sets,
    shapes and dtypes (the caller falls back to a full commit / full
    push otherwise).  ``base`` must be the APPLIED chain state (what
    receivers actually hold), not the true weights of the previous
    step — that difference is exactly the error-feedback residual the
    int8 path carries forward.

    Returns ``(entries, meta, new_state)``:
      entries    list of (name, np.ndarray) for elastic.write_shard_file
      meta       JSON-safe dict: format/base_fp/seq/new_fp/bytes/
                 full_bytes/rel_err + per-entry kind/crc/scale info
      new_state  the applied state receivers will hold after this
                 delta (the encoder's next chain base)
    """
    cfg = DeltaConfig.resolve(config)
    if set(base) != set(current):
        raise MXNetError(
            'make_delta: base/current name sets differ (%d vs %d '
            'entries) — rebase required'
            % (len(base), len(current)))
    entries = []
    emeta = {}
    new_state = {}
    payload = 0
    full = 0
    worst_rel = 0.0
    for name in sorted(current):
        b = ha.host(base[name])
        c = ha.host(current[name])
        if tuple(b.shape) != tuple(c.shape) or \
                ha.dtype_name(b) != ha.dtype_name(c):
            raise MXNetError(
                'make_delta: %r changed shape/dtype (%s%s -> %s%s) — '
                'rebase required' % (name, ha.dtype_name(b),
                                     tuple(b.shape), ha.dtype_name(c),
                                     tuple(c.shape)))
        full += ha.nbytes(c)
        if _bytes_of(b) == _bytes_of(c):
            new_state[name] = b         # untouched: not in the delta
            continue
        kind = _pick_kind(b, c, cfg)
        if kind == 'rows':
            changed = np.flatnonzero(_changed_rows(b, c)).astype(np.int32)
            rows = _take_rows(c, changed)
            entries.append((_KIND_IDS + name, changed))
            entries.append((_KIND_ROWS + name, rows))
            payload += changed.nbytes + ha.nbytes(rows)
            new = c                     # row writes are exact
            emeta[name] = {'kind': 'rows', 'crc': _crc(new)}
        elif kind == 'int8':
            b32, c32 = ha.to_float32(b), ha.to_float32(c)
            diff = c32 - b32
            scale = quantization.symmetric_scale(diff)
            codes = quantization.quantize_int8_math(diff, scale)
            deq = quantization.dequantize_int8_math(codes, scale)
            new = ha.from_float32(b32 + deq, b)
            entries.append((_KIND_CODES + name,
                            np.ascontiguousarray(codes)))
            entries.append((_KIND_SCALE + name,
                            np.asarray(scale,
                                       np.float32).reshape(1)))
            payload += codes.nbytes + 4
            spread = float(np.max(np.abs(c32))) or 1.0
            rel = float(np.max(np.abs(c32 - ha.to_float32(new)))) / spread
            if not np.isfinite(rel):
                # a NaN or inf in the diff: the gate must refuse it
                # (max() would drop a NaN and record 0.0)
                rel = float('inf')
            worst_rel = max(worst_rel, rel)
            emeta[name] = {'kind': 'int8', 'crc': _crc(new),
                           'rel_err': rel}
        else:                           # raw: verbatim new value
            entries.append((_KIND_RAW + name, ha.contiguous(c)))
            payload += ha.nbytes(c)
            new = c
            emeta[name] = {'kind': 'raw', 'crc': _crc(new)}
        new_state[name] = new
    meta = {
        'format': DELTA_FORMAT_VERSION,
        'base_fp': str(base_fp),
        'seq': int(seq),
        'new_fp': fingerprint(new_state),
        'entries': emeta,
        'bytes': int(payload),
        'full_bytes': int(full),
        'rel_err': float(worst_rel),
    }
    return entries, meta, new_state


def _pick_kind(b, c, cfg):
    if _size(b) < cfg.min_dense or len(b.shape) < 1:
        return 'raw'
    if len(b.shape) >= 2 and b.shape[0] > 1:
        touched = int(np.count_nonzero(_changed_rows(b, c)))
        if touched <= cfg.sparse_frac * b.shape[0]:
            return 'rows'
    # bfloat16 takes the exact kinds, as in the JAX package (whose
    # ml_dtypes bfloat16 has numpy kind 'V')
    name = ha.dtype_name(b)
    if cfg.dense == 'int8' and name not in ha.TORCH_ONLY and \
            np.dtype(name).kind == 'f':
        return 'int8'
    if len(b.shape) >= 2 and b.shape[0] > 1:
        return 'rows'                   # dense='raw': rows IS the raw
                                        # diff container (exact, still
                                        # skips untouched rows)
    return 'raw'


def apply_delta(state, meta, arrays, expect_fp=None, expect_seq=None,
                parity_tol=None, strict_crc=True, skip_crc=()):
    """Apply one delta to a resident flat state.  Returns the NEW
    state dict (input ``state`` is never mutated — all gates run
    before anything is built, and a failure raises with the resident
    state untouched).

    state:      flat {name: np.ndarray} the receiver holds
    meta:       the delta meta (make_delta / the delta manifest)
    arrays:     the delta's shard entries ({entry_name: np.ndarray},
                e.g. elastic.read_shard_file output)
    expect_fp:  the receiver's resident fingerprint; mismatch vs
                meta['base_fp'] -> DeltaChainError (full-push signal)
    expect_seq: when given, meta['seq'] must equal it exactly (chain
                continuity — a skipped delta is a break, not a gap to
                paper over)
    parity_tol: lossy gate — meta['rel_err'] above it ->
                DeltaParityError.  None disables (exact-only deltas
                carry rel_err 0.0)
    strict_crc: verify each touched entry's post-apply crc (proof the
                resident base was bit-identical to the encoder's
                chain state).  Receivers whose resident copy is
                itself lossy (int8-requantized engines, quantized
                page images) pass False and rely on the fp + parity
                gates instead.
    skip_crc:   names exempted from the crc check while the rest stays
                strict — the per-entry form of strict_crc=False for
                receivers where only SOME params round-trip lossily
                (a quantized engine's int8-swapped weights next to
                bit-held passthrough/aux arrays).
    """
    if int(meta.get('format', -1)) != DELTA_FORMAT_VERSION:
        raise DeltaChainError(
            'delta format %r unsupported (want %d)'
            % (meta.get('format'), DELTA_FORMAT_VERSION))
    if expect_fp is not None and str(meta.get('base_fp')) != \
            str(expect_fp):
        raise DeltaChainError(
            'delta base fingerprint %s does not match resident state '
            '%s — the chain is broken (full push/reload required)'
            % (meta.get('base_fp'), expect_fp))
    if expect_seq is not None and int(meta.get('seq', -1)) != \
            int(expect_seq):
        raise DeltaChainError(
            'delta seq %r does not continue the resident chain '
            '(expected %d)' % (meta.get('seq'), int(expect_seq)))
    if parity_tol is not None and \
            float(meta.get('rel_err', 0.0)) > float(parity_tol):
        from . import profiler
        profiler.add_delta_stats(parity_refusals=1)
        raise DeltaParityError('delta seq %d' % int(meta.get('seq', 0)),
                               meta.get('rel_err', 0.0), parity_tol)
    emeta = meta.get('entries', {})
    skip_crc = frozenset(skip_crc)
    staged = {}
    for name, em in emeta.items():
        if name not in state:
            raise DeltaChainError(
                'delta touches %r which the resident state does not '
                'hold — the chain is broken' % name)
        cur = ha.host(state[name])
        kind = em.get('kind')
        if kind == 'rows':
            ids = arrays.get(_KIND_IDS + name)
            rows = arrays.get(_KIND_ROWS + name)
            if ids is None or rows is None:
                raise DeltaChainError(
                    'delta payload is missing rows for %r' % name)
            flat = np.array(ha.bits(cur), copy=True).reshape(
                cur.shape[0], -1)
            flat[np.asarray(ids, np.int64)] = ha.bits(
                _as_dtype_of(rows, cur)).reshape(len(ids), -1)
            new = flat.reshape(tuple(cur.shape))
            if ha.is_torch(cur):
                new = ha.from_bits(new, ha.dtype_name(cur))
        elif kind == 'int8':
            codes = arrays.get(_KIND_CODES + name)
            scale = arrays.get(_KIND_SCALE + name)
            if codes is None or scale is None:
                raise DeltaChainError(
                    'delta payload is missing codes for %r' % name)
            # keep the scale an np.float32 scalar: the multiply must
            # reproduce the encoder's bits for the crc gate to hold
            s32 = np.asarray(scale, np.float32).ravel()[0]
            deq = quantization.dequantize_int8_math(
                np.asarray(codes), s32)
            new = ha.from_float32(ha.to_float32(cur) + deq, cur)
        elif kind == 'raw':
            raw = arrays.get(_KIND_RAW + name)
            if raw is None:
                raise DeltaChainError(
                    'delta payload is missing raw value for %r' % name)
            new = ha.copy(_as_dtype_of(raw, cur)).reshape(
                tuple(cur.shape))
        else:
            raise DeltaChainError('delta entry %r has unknown kind %r'
                                  % (name, kind))
        if strict_crc and name not in skip_crc and 'crc' in em and \
                _crc(new) != int(em['crc']):
            raise DeltaChainError(
                'delta crc mismatch for %r: the resident state '
                'diverged from the chain base (full push/reload '
                'required)' % name)
        staged[name] = new
    out = dict(state)
    out.update(staged)
    return out


def read_delta_file(path):
    """(arrays) of one delta payload file — an elastic shard-file
    container; raises MXNetError on torn/corrupt payloads."""
    from .elastic import read_shard_file
    if not os.path.isfile(path):
        raise DeltaChainError('delta payload %s is missing' % path)
    return read_shard_file(path)


class DeltaEncoder(object):
    """Stateful chain encoder: holds the applied state + fingerprint
    and hands out consecutive deltas.  One per push/checkpoint chain;
    ``rebase()`` starts a new chain from a fresh full state (the
    periodic full base that bounds both replay length and lossy
    drift)."""

    __slots__ = ('config', 'state', 'fp', 'seq', 'base_fp')

    def __init__(self, state, config=None):
        self.config = DeltaConfig.resolve(config)
        self.rebase(state)

    def rebase(self, state):
        """Start a new chain from ``state`` (a full commit/push just
        landed).  Returns the new base fingerprint."""
        self.state = {n: ha.host(a) for n, a in state.items()}
        self.fp = fingerprint(self.state)
        self.base_fp = self.fp
        self.seq = 0
        return self.fp

    def encode(self, current):
        """Delta from the chain's applied state to ``current``;
        advances the chain.  Returns (entries, meta)."""
        entries, meta, new_state = make_delta(
            self.state, current, seq=self.seq + 1, base_fp=self.fp,
            config=self.config)
        self.state = new_state
        self.fp = meta['new_fp']
        self.seq = int(meta['seq'])
        return entries, meta
