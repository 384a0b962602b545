"""Row-striped embedding tables with touched-rows-only updates: the
counterpart of mxnet_tpu/parallel/embedding.py (docs/SPARSE.md).

`Embedding(sparse_grad=True)` tables (Gluon) and Embedding nodes with
`sparse_grad=True` (Symbol) train rows-only in both fused paths. Before
the forward, each table's ids of the step are deduplicated to a static
rung: `dedup_ids` sorts them, flags where a sorted id differs from the
one before, and a cumulative sum of the flags gives each id its slot,
so the (rung,) ids come sorted and padded with `vocab` at the end, as
the JAX package's `jnp.unique(size=rung, fill_value=vocab)` gives them,
with no host synchronisation (torch.unique's variable size would block
the host every step). The touched rows `rows = table[uids]` are
gathered, detached, as a leaf that requires grad, and every lookup of
the table is served as `rows[inverse]`: the backward's gradient of that
gather, autograd's accumulating index_put (on the card a sort by slot,
then each slot's rows summed in their batch order: the same bits on
every run), is the per-unique-id row gradient, (rung, dim). No dense
(vocab, dim) gradient exists anywhere.

`sparse_row_update` applies `optimizer.sgd_update_math`, the dense
step's rounding, to the gathered rows, with lazy momentum and weight
decay: a row no id touched keeps its weight and its momentum. Padded
slots (id == vocab) write nothing: torch has no scatter mode that drops
an index, so each padded slot is pointed at the first real slot and
carries that slot's new value (a duplicate write of the same bits, in
any order), and row vocab - 1 is never touched by the padding. With
momentum 0 and wd 0 the touched rows equal the dense update's bit for
bit.

Unique-count ladder: `unique_ladder` and `pick_rung` are the JAX
package's (powers of two from MIN_RUNG up to the id slots). The Gluon
path counts each batch's unique ids on the host and pads to the rung
that covers them; the Module path's rung is the static
min(vocab, bound id slots).

Under a data mesh of N ranks (the port is multi-controller, so the JAX
package's one row-sharded GSPMD array becomes explicit traffic), rank r
holds rows [r*s, min(vocab, (r+1)*s)) with s = ceil(vocab / N)
(`stripe_range`), and so do its momenta. The step's unique ids are
those of the global batch (each rank all-gathers the ids of the others'
rows); `striped_gather` reads the rows each rank owns and one all-reduce
completes them everywhere; the row gradients are all-reduced over the
data axis, and each rank updates the rows it owns.
"""
import threading

import numpy as np
import torch

from ..base import MXNetError


# ---------------------------------------------------------------------------
# unique-count bucket ladder (copied from the JAX package: pure numpy)
# ---------------------------------------------------------------------------

MIN_RUNG = 8


def unique_ladder(capacity, min_rung=MIN_RUNG):
    """Rungs a batch's unique-id count may be padded to: powers of two
    from min_rung up to `capacity` (the id-slot count of the batch,
    always included)."""
    from .. import exec_cache
    capacity = int(capacity)
    if capacity < 1:
        raise MXNetError('unique_ladder: capacity must be >= 1')
    if capacity <= min_rung:
        return (capacity,)
    return tuple(r for r in exec_cache.batch_ladder(capacity, min_rung))


def pick_rung(ladder, u):
    """Smallest rung covering `u` unique ids (ladder is ascending)."""
    for r in ladder:
        if r >= u:
            return r
    return ladder[-1]


# ---------------------------------------------------------------------------
# lookup math
# ---------------------------------------------------------------------------

def _flat_ids(a, vocab):
    """Ids as the Embedding op reads them (truncated to int32, clipped to
    the table), flat and long."""
    return a.detach().to(torch.int32).long().reshape(-1).clamp(0, vocab - 1)


def dedup_ids(ids_list, rung, vocab):
    """One table's ids of a step deduplicated at the static `rung`.

    ids_list: the id tensors of every lookup of the table. Returns
    (uids, invs): uids (rung,) long, sorted, padded with `vocab`; invs
    one flat inverse map per lookup, each value < rung. `rung` must
    cover the unique count (the callers' rungs do)."""
    flats = [_flat_ids(a, vocab) for a in ids_list]
    allids = flats[0] if len(flats) == 1 else torch.cat(flats)
    srt, order = torch.sort(allids, stable=True)
    flags = torch.ones_like(srt)
    if srt.numel() > 1:
        flags[1:] = (srt[1:] != srt[:-1]).long()
    slot = (torch.cumsum(flags, 0) - 1).clamp(max=rung - 1)
    uids = torch.full((rung,), vocab, dtype=torch.long, device=srt.device)
    # duplicates of an id write the same value into its slot
    uids.scatter_(0, slot, srt)
    inv = torch.empty_like(slot)
    inv[order] = slot
    invs, off = [], 0
    for f in flats:
        invs.append(inv[off:off + f.numel()])
        off += f.numel()
    return uids, invs


def stripe_range(vocab, n, index):
    """Rows [lo, hi) of a table of `vocab` rows that rank `index` of `n`
    holds."""
    s = -(-int(vocab) // max(1, int(n)))
    lo = min(int(vocab), index * s)
    return lo, min(int(vocab), lo + s)


def _data_split(mesh):
    """(n, index) over the data axis of `mesh`, (1, 0) without one."""
    if mesh is None or mesh.shape.get('data', 1) <= 1:
        return 1, 0
    return mesh.axis_size('data'), mesh.axis_index('data')


def gather_rows(table, uids):
    """The touched rows (rung, dim) of the (vocab, dim) table; padded ids
    (== vocab) read the last row, which no lookup references."""
    return table[uids.clamp(0, table.shape[0] - 1)]


def striped_gather(table, uids, vocab, mesh):
    """The rows of `uids` from a table striped over the data axis of
    `mesh` (this rank's stripe `table`): each rank reads the rows it
    holds, zeros elsewhere, and one all-reduce sums them (a row and
    zeros: exact). Without a mesh, the plain gather."""
    n, index = _data_split(mesh)
    if n == 1:
        return gather_rows(table, uids)
    from .collectives import _all_reduce
    lo, hi = stripe_range(vocab, n, index)
    local = uids - lo
    held = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, max(hi - lo - 1, 0))]
    rows = torch.where(held[:, None], rows, torch.zeros_like(rows))
    return _all_reduce(rows, mesh, 'data')


def gather_global_ids(ids, mesh):
    """The ids of the global batch: this rank's id tensor all-gathered
    over the data axis in rank order (every rank's ids have one
    shape)."""
    n, _ = _data_split(mesh)
    if n == 1:
        return ids
    from .collectives import _all_gather
    flat = ids.detach().to(torch.int32).reshape(-1)
    return _all_gather(flat, mesh, 'data', 0)


def sparse_row_update(w, m, uids, d_rows, lr, wd, momentum=0.0,
                      rescale=1.0, clip=None, nesterov=False, lo=0):
    """Rows-only SGD / NAG of `w` (holding rows [lo, lo + len(w))) and
    its momentum `m`, in place: sgd_update_math on the touched row
    slices, lazy momentum and wd (module docstring). Slots whose id is
    padding or another rank's row write nothing. Returns (w, m)."""
    from ..optimizer import sgd_update_math
    n = w.shape[0]
    local = uids - lo
    valid = (local >= 0) & (local < n)
    idx = local.clamp(0, max(n - 1, 0))
    w_rows = w[idx]
    m_rows = m[idx] if momentum != 0.0 else None
    g = d_rows if d_rows.dtype == w.dtype else d_rows.to(w.dtype)
    acc_rows, nm_rows = sgd_update_math(
        w_rows, g, m_rows, lr, wd, momentum=momentum, rescale=rescale,
        clip=clip, nesterov=nesterov)
    # the slots that write nothing point at the first valid slot and
    # carry its value; with no valid slot, at row 0 with its own value
    if not n:
        return w, m
    anyv = valid.any()
    first = torch.argmax(valid.to(torch.int8))
    anchor = torch.where(anyv, idx[first], torch.zeros_like(idx[first]))
    tgt = torch.where(valid, idx, anchor)

    def write(dst, new_rows):
        a_val = torch.where(anyv, new_rows[first], dst[0])
        vals = torch.where(valid[:, None], new_rows, a_val[None])
        dst.index_put_((tgt,), vals.to(dst.dtype))

    write(w, acc_rows)
    if momentum != 0.0:
        write(m, nm_rows)
    return w, m


# ---------------------------------------------------------------------------
# capture / override scopes (the ops/tensor.py Embedding hook)
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


class _CaptureScope:
    """Records, while active, every Embedding lookup whose weight is a
    watched table: its id tensor, and which step input it is (when it is
    one). The lookup itself runs densely."""

    def __init__(self, watch, ins_map=None):
        self.watch = watch              # id(table tensor) -> table pos
        self.ins_map = ins_map or {}    # id(input tensor) -> input index
        self.records = {}               # pos -> [ids, ...]
        self.sources = {}               # pos -> [input index or None]

    def on_embedding(self, attrs, data, weight):
        pos = self.watch.get(id(weight))
        if pos is not None:
            self.records.setdefault(pos, []).append(data)
            self.sources.setdefault(pos, []).append(
                self.ins_map.get(id(data)))
        return None


class _Override:
    __slots__ = ('rows', 'invs', 'dim')

    def __init__(self, rows, invs, dim):
        self.rows = rows
        self.invs = list(invs)          # consumed in lookup order
        self.dim = dim


class _OverrideScope:
    """Serves each watched table's lookup as rows[inverse], the lookups
    matched to the ids' order positionally."""

    def __init__(self, overrides):
        self.overrides = overrides      # id(table tensor) -> _Override

    def on_embedding(self, attrs, data, weight):
        ov = self.overrides.get(id(weight))
        if ov is None:
            return None
        if not ov.invs:
            raise MXNetError(
                'sparse embedding: more lookups of a sparse_grad table '
                'in the gradient pass than the ids were taken for; the '
                'forward must look its tables up the same way each pass')
        inv = ov.invs.pop(0)
        return ov.rows[inv].reshape(tuple(data.shape) + (ov.dim,))


def _hook(attrs, data, weight):
    stack = getattr(_SCOPE, 'stack', None)
    if not stack:
        return None
    return stack[-1].on_embedding(attrs, data, weight)


class _scope:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        if not hasattr(_SCOPE, 'stack'):
            _SCOPE.stack = []
        _SCOPE.stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _SCOPE.stack.pop()
        return False


def capture_scope(watch, ins_map=None):
    return _scope(_CaptureScope(watch, ins_map))


def override_scope(overrides):
    return _scope(_OverrideScope(overrides))


from ..ops import tensor as _tensor_ops    # noqa: E402
_tensor_ops._embed_hook = _hook


# ---------------------------------------------------------------------------
# host-side plan
# ---------------------------------------------------------------------------

class SparseEmbedPlan:
    """The sparse tables of one fused step: entries of dicts with pos
    (the parameter's position), name, vocab, dim and dtype. `src[pos]`
    is the step input the table's first lookup reads, `srcs[pos]` those
    of all its lookups (None for derived ids), both learned by the first
    capture; `slots[(pos, sig)]` the id slots a step has at one input
    signature. Once every lookup of every table reads an input, the step
    takes the ids from the inputs and runs no capture."""

    def __init__(self, entries):
        self.entries = list(entries)
        self.src = {}
        self.srcs = {}
        self.slots = {}
        self._sig = None

    def __bool__(self):
        return bool(self.entries)

    @property
    def positions(self):
        return [e['pos'] for e in self.entries]

    def set_sig(self, sig):
        self._sig = sig

    def note_sources(self, pos, sources):
        self.srcs[pos] = list(sources)
        if sources and sources[0] is not None:
            self.src.setdefault(pos, sources[0])

    def note_slots(self, pos, n):
        self.slots[(pos, self._sig)] = int(n)

    def direct(self):
        """True when every table's lookups all read step inputs at this
        signature (the ids are known before the forward)."""
        return all(self.srcs.get(e['pos']) and
                   None not in self.srcs[e['pos']] and
                   (e['pos'], self._sig) in self.slots
                   for e in self.entries)

    def capacity(self, entry):
        """Worst-case unique count of one step at the bound signature:
        the id slots when known, capped at vocab."""
        n = self.slots.get((entry['pos'], self._sig))
        if n is None:
            return int(entry['vocab'])
        return min(int(entry['vocab']), int(n))

    def pick_rungs(self, host_ids, bulk=False):
        """Per-table rung of one dispatch: the ladder rung covering the
        unique count where the table's source input is in host_ids (a
        bulk (K, ...) stack: its worst step), else the capacity."""
        rungs = []
        for e in self.entries:
            cap = self.capacity(e)
            srcs = self.srcs.get(e['pos']) or [self.src.get(e['pos'])]
            if srcs and all(k is not None and k in host_ids for k in srcs):
                if bulk:
                    rows = [np.concatenate([np.asarray(host_ids[k][i])
                                            .reshape(-1) for k in srcs])
                            for i in range(len(host_ids[srcs[0]]))]
                else:
                    rows = [np.concatenate([np.asarray(host_ids[k])
                                            .reshape(-1) for k in srcs])]
                u = max(int(np.unique(
                    np.clip(r.astype(np.float64).astype(np.int32), 0,
                            int(e['vocab']) - 1)).size) for r in rows)
                u = max(1, u)
                rungs.append(min(cap, pick_rung(unique_ladder(cap), u)))
            else:
                rungs.append(cap)
        return tuple(rungs)

    def facts_key(self):
        return self.key() + ('facts',)

    def key(self, rungs=None):
        from .. import exec_cache
        return exec_cache.embed_plan_key(
            tuple(e['pos'] for e in self.entries),
            tuple(int(e['vocab']) for e in self.entries),
            tuple(int(e['dim']) for e in self.entries),
            rungs)

    # -- accounting --------------------------------------------------------
    def table_bytes(self):
        return sum(int(e['vocab']) * int(e['dim']) *
                   np.dtype(e['dtype']).itemsize for e in self.entries)

    def per_device_table_bytes(self, dp):
        """Table bytes a rank holds under row striping: ceil(vocab/dp)
        rows a table."""
        dp = max(1, int(dp))
        return sum(-(-int(e['vocab']) // dp) * int(e['dim']) *
                   np.dtype(e['dtype']).itemsize for e in self.entries)

    def touched_bytes(self, rungs, momentum=False):
        """Bytes the rows-only update reads and writes in one step."""
        total = 0
        for e, r in zip(self.entries, rungs):
            row = int(e['dim']) * np.dtype(e['dtype']).itemsize
            total += 2 * int(r) * row * (2 if momentum else 1)
        return total

    def dense_equiv_bytes(self, momentum=False):
        """What the dense update would read and write."""
        total = 0
        for e in self.entries:
            row = int(e['dim']) * np.dtype(e['dtype']).itemsize
            total += 2 * int(e['vocab']) * row * (2 if momentum else 1)
        return total

    def delta_bytes(self, rungs, steps=1):
        """The weight-delta payload of the tables after `steps` steps'
        touched rows (delta.py encodes a sparse table as COO rows)."""
        total = 0
        for e, r in zip(self.entries, rungs):
            touched = min(int(e['vocab']), int(r) * max(1, int(steps)))
            row = int(e['dim']) * np.dtype(e['dtype']).itemsize
            total += touched * (row + np.dtype(np.int32).itemsize)
        return total


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        from ..base import numpy_dtype
        return numpy_dtype(dtype)
    return np.dtype(dtype)


def gluon_sparse_plan(params):
    """SparseEmbedPlan over a fused step's ordered Parameter list: every
    2-D parameter flagged sparse_grad. None when there is none."""
    entries = []
    for i, p in enumerate(params):
        if not getattr(p, 'sparse_grad', False):
            continue
        if len(p.shape) != 2:
            raise MXNetError(
                'sparse_grad parameter %s must be a 2-D embedding '
                'table, got shape %r' % (p.name, (p.shape,)))
        entries.append({'pos': i, 'name': p.name,
                        'vocab': int(p.shape[0]), 'dim': int(p.shape[1]),
                        'dtype': _np_dtype(p.list_data()[0]._data.dtype)})
    return SparseEmbedPlan(entries) if entries else None


def find_symbol_tables(symbol, sparse_only=True):
    """The Embedding applications of a Symbol graph: one dict a node
    with weight (argument name), ids_input (the ids variable's name, or
    None for derived ids), vocab, dim and sparse (its sparse_grad
    attribute). Serving's hot-row cache and Module's sparse plan read
    it."""
    from ..base import parse_attr_value
    out = []
    for node in symbol._topo():
        if node.op is None or getattr(node.op, 'name', '') != 'Embedding':
            continue
        sparse = bool(parse_attr_value(
            node.attrs.get('sparse_grad', False)))
        if sparse_only and not sparse:
            continue
        data_node = node.inputs[0][0]
        w_node = node.inputs[1][0]
        if w_node.op is not None:
            continue
        out.append({
            'weight': w_node.name,
            'ids_input': data_node.name if data_node.op is None else None,
            'vocab': int(parse_attr_value(node.attrs['input_dim'])),
            'dim': int(parse_attr_value(node.attrs['output_dim'])),
            'sparse': sparse,
        })
    return out


def row_sharding(mesh):
    """The placement of a row-striped table: rows over the data axis."""
    from .mesh import P
    return P('data', None)


def stripe_of(full, mesh):
    """This rank's stripe (a copy) of a full table under the data axis
    of `mesh` (collectives.row_shard_constraint); the table itself
    without one."""
    from .collectives import row_shard_constraint
    t = row_shard_constraint(full, mesh)
    return t if t is full else t.clone()


def unstripe(local, vocab, mesh):
    """The full (vocab, ...) table assembled from every rank's stripe (a
    collective over the data axis); `local` itself without a mesh."""
    n, index = _data_split(mesh)
    if n == 1:
        return local
    from .collectives import _all_gather
    s = -(-int(vocab) // n)
    pad = s - local.shape[0]
    if pad:
        local = torch.cat([local, local.new_zeros((pad,) +
                                                  tuple(local.shape[1:]))])
    full = _all_gather(local.contiguous(), mesh, 'data', 0)
    return full[:int(vocab)]
