"""Executor: execution of a bound Symbol, the counterpart of the core of
mxnet_tpu/executor.py (reference GraphExecutor,
src/executor/graph_executor.cc).

`forward` walks the symbol's DAG op by op on torch tensors (PyTorch
launches each op's kernels asynchronously on the device's stream), and
the train-mode walk is differentiated by torch autograd where the JAX
package takes jax.vjp of one jitted function; there is no jit and no
compiled-program cache.

Semantics kept from the JAX package and the reference:
  * arg/grad/aux NDArray dictionaries owned by the executor;
  * grad_req write/add/null per argument;
  * aux states (BatchNorm's moving statistics) updated once by each
    train-mode forward, and not by backward: `backward()` differentiates
    the autograd graph of the last `forward(is_train=True)`, where the
    JAX package reruns the forward from the aux states it started from,
    so both leave them updated once;
  * backward() with no head gradients seeds ones, which loss ops
    (SoftmaxOutput) ignore but as a scale.

The NHWC layout pass (MXNET_TPU_LAYOUT_OPT: 'auto', the default, is on
for a gpu context and off for cpu; '1' on; '0' off) carries 4-D
activations channels-last through Convolution, Pooling, BatchNorm and
the elementwise ops, and turns them back to NCHW where an op needs the
semantic layout (Flatten, FullyConnected, ...).

The conv -> BatchNorm pair route. A 2-D Convolution with no bias, one
group and no dilation, whose output's only use is input 0 of a
BatchNorm on axis 1 without use_global_stats, is a pair (`pairs`, found
at bind). In a train-mode forward on bfloat16 data and weight, the pair
runs as `cuda_conv.conv2d_bn_stats` on the NHWC activation and the HWIO
weight, the conv kernel returning y with the float32 sums of y and y^2,
and the BatchNorm takes mean = s1 / m and var = max(s2 / m - mean^2, 0)
from them, not from its own sums: the one-pass statistics the JAX
BatchNorm takes in bfloat16, differentiable through s1 and s2. Float32
BatchNorm takes the two-pass variance, so float32 pairs stay unfused; in
eval mode and on unpaired convs the conv is F.conv2d. Where Cin is not
a multiple of KERNEL_CIN_MULTIPLE (the stem's 3 channels), x and w are
zero-padded to the next multiple, which the kernel takes by TMA instead
of by plain loads; the zeros change neither y nor the sums. There is no
fallback: the route raises where the kernel does not build or launch.

The stem split (MXNET_TPU_STEM_SPLIT, on unless '0' or ''). A
Convolution with no bias fed by a BatchNorm(fix_gamma=True) whose input
carries no gradient (ResNet's bn_data -> conv0) runs as conv(x^ g) +
conv(beta 1): the BatchNorm with beta zeroed, whose output then carries
no autograd graph, and the conv's output plus the conv of the constant
image beta at batch 1. Its backward reaches beta through a batch-1
dgrad instead of the whole batch's. Such a conv leaves the pair route:
the kernel's sums would be those of conv(x^ g) alone, and the sums of
y need sum_n y per output position, which the kernel does not give. The
split applies in every walk but the monitor's, which shows each node's
own output. `_split_conv` maps each split conv to its BatchNorm.

ctx_group placement (`group2ctx`). A node whose ctx_group attribute
maps to a context runs there: its inputs go there by `.to(device)`, and
autograd carries the gradients back across devices. A group2ctx that
matches no node changes nothing; a grouped executor takes neither the
layout pass nor the pair route, and has no multistep program (Module
runs its steps one by one).

At bind the executor takes its graph signature (`exec_cache.
graph_signature`, `_sig`), which the serving engine keys its rung
programs on. `serve` is the counterpart of the JAX package's
`raw_forward`: the eval walk on the values it is given, under
`torch.inference_mode()`, with no device synchronisation (the serving
engine overlaps one dispatch with the completion of the one before).
`set_monitor_callback` gives the callback every node's output of each
forward while it is active (`monitor.Monitor`); `partial_forward` runs
the graph op by op in steps; `memory_cost` measures the card's
allocator over one run; `reshape` rebinds new shapes, sharing the
arrays whose shapes did not change.

Data parallelism (a Module over several contexts, module/
executor_group.py). The group sets `_mesh`, the 'data' mesh whose rank
this executor is, bound at this rank's rows of the batch: each walk runs
in `mesh.data_mesh_scope`, so the ops that reduce over the batch reduce
over the mesh (ops/nn.py). The walk also tells each value's kind
(`_node_kind`): this rank's rows of a batch-carrying value, or a
replicated one. A registered op that reduces a batch-carrying value over
axis 0 (sum, mean, prod, max, norm, softmax_cross_entropy, sort, topk,
...) runs in its global form (parallel/batch_reduce.py), and what
follows it is replicated: it runs as the one-device op on every rank, a
replicated value entering a batch-carrying op sums its cotangent over
the mesh, and a parameter entering replicated math keeps its gradient
on data index 0, so that the all-reduce below counts it once. The
group gathers a replicated output once (`replicated_outputs`). The
group also sets `grad_reduce` (`collectives.GradReduce`), the in-step
all-reduce of the parameters' gradients over the data axis, started from
the backward's hooks when interleaved; `make_fused_train_step` and
`make_fused_multistep` take another for their steps (`grad_reduce=`).
Under ZeRO the group's is None: the sharded update reduce-scatters this
rank's own gradients itself (parallel/zero.py).

Sparse embedding tables (Embedding nodes with sparse_grad=True whose
weight is a differentiable argument, `_sparse_embed_entries`) train
rows-only once the Module's updater takes them (`set_sparse_tables`):
each train-mode forward deduplicates the table's ids, the bound id
inputs of the global batch, at the static rung min(vocab, id slots),
gathers the touched rows as a leaf and serves the table's lookups as
rows[inverse] (parallel/embedding.py); the backward leaves the table
without a dense gradient and puts (ids, row gradients, lo) in
`sparse_grads`, summed over the data mesh, where the table is striped
(rank r holding rows [lo, ...)). Ids computed in the graph, and ids that
are a differentiable argument, are refused.
"""
import contextlib
import os
import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from . import cuda_conv
from . import exec_cache
from . import ndarray as nd
from . import profiler
from . import random as _random
from .base import MXNetError, parse_attr_value, torch_dtype
from .context import Context
from .parallel import batch_reduce as _breduce
from .parallel import mesh as _pmesh
from .ops import nn as _nn
from .ops.registry import OpContext, asbool, astuple, normalize_axis

# elementwise ops whose outputs follow the input permutation unchanged
_LAYOUT_FLEX = frozenset((
    'Activation', 'Dropout', 'elemwise_add', 'elemwise_sub',
    'elemwise_mul', 'elemwise_div', '_grad_add', '_copy', 'BlockGrad',
    'Cast', 'relu', 'sigmoid', 'tanh', 'softsign', 'clip',
    '_plus_scalar', '_minus_scalar', '_mul_scalar', '_div_scalar',
    '_maximum_scalar', '_minimum_scalar', '_CrossDeviceCopy',
))


def _to_nchw(v, cur):
    return v.permute(0, 3, 1, 2) if cur == 'NHWC' else v


def _to_nhwc(v, cur):
    """v channels-last and contiguous, as the NHWC consumers take it."""
    if cur == 'NHWC':
        return v
    return v.permute(0, 2, 3, 1).contiguous()


def _layout_mode(op, attrs, vals):
    """'io' = the op consumes and produces its data input in NHWC when
    asked (the private __layout__ attr); 'elemwise' = the op is
    permutation-transparent; None = the op needs semantic NCHW inputs."""
    name = op.name
    if name == 'Convolution':
        return 'io' if len(astuple(attrs['kernel'])) == 2 else None
    if name == 'Pooling':
        return 'io' if vals[0].ndim == 4 else None
    if name == 'BatchNorm':
        if vals[0].ndim != 4:
            return None
        return 'io' if normalize_axis(attrs.get('axis', 1), 4) == 1 \
            else None
    if name in _LAYOUT_FLEX:
        return 'elemwise'
    return None


# the input channel count the kernel's TMA path needs a multiple of
KERNEL_CIN_MULTIPLE = 8


def padded_cin(cin):
    """The input channels the pair route gives the kernel for `cin`."""
    return -(-cin // KERNEL_CIN_MULTIPLE) * KERNEL_CIN_MULTIPLE


def pair_conv(x, w, stride, pad):
    """The conv of a conv -> BatchNorm pair on the conv + statistics
    kernel: x NHWC, w OIHW (given to the kernel as HWIO); returns (y
    NHWC, (s1, s2)). Input channels short of KERNEL_CIN_MULTIPLE are
    zero-padded (the same y and sums; autograd slices the gradients of
    x and w back). The executor's pair route and the fused Gluon step's
    (gluon/fused.py) both run their pairs through it."""
    w = w.permute(2, 3, 1, 0)       # OIHW -> HWIO
    extra = padded_cin(x.shape[3]) - x.shape[3]
    if extra:
        x = torch.nn.functional.pad(x, (0, extra))
        w = torch.nn.functional.pad(w, (0, 0, 0, extra))
    y, s1, s2 = cuda_conv.conv2d_bn_stats(x, w, stride, pad)
    return y, (s1, s2)


def pair_batch_norm(attrs, inputs, auxs, op_ctx, sums):
    """The BatchNorm of a pair on its NHWC data (inputs: data, gamma,
    beta; auxs: the moving statistics), its statistics the conv
    kernel's s1 and s2 (ops/nn.batch_norm, summed over the data mesh
    there): (outputs, updated moving statistics)."""
    return _nn.batch_norm(dict(attrs, __layout__='NHWC'), inputs, auxs,
                          op_ctx, sums=sums)


def conv_bn_pairs(topo, heads):
    """{conv node index: BatchNorm node index} of the topo order `topo`
    (heads: the symbol's output entries): each 2-D Convolution with
    no_bias, num_group 1 and dilate 1 whose output's only use is input 0
    of a BatchNorm on axis 1 without use_global_stats."""
    index = {id(n): i for i, n in enumerate(topo)}
    uses = {}
    for n in topo:
        for src, oi in n.inputs:
            uses.setdefault((id(src), oi), []).append(n)
    for n, oi in heads:
        uses.setdefault((id(n), oi), []).append(None)
    pairs = {}
    for conv in topo:
        if conv.op is None or conv.op.name != 'Convolution':
            continue
        kernel, _, dilate, _, group = _nn.conv_params(conv.attrs)
        if len(kernel) != 2 or group != 1 or any(d != 1 for d in dilate) \
                or not asbool(conv.attrs.get('no_bias', False)):
            continue
        users = uses.get((id(conv), 0), [])
        if len(users) != 1 or users[0] is None:
            continue
        bn = users[0]
        if bn.op.name != 'BatchNorm' or bn.inputs[0][0] is not conv or \
                normalize_axis(bn.attrs.get('axis', 1), 4) != 1 or \
                asbool(bn.attrs.get('use_global_stats', False)):
            continue
        pairs[index[id(conv)]] = index[id(bn)]
    return pairs


def stem_splits(topo, heads, grad_req, aux_names):
    """{conv node index: BatchNorm node index} of the stem split: each
    Convolution with no_bias and a 2-D kernel whose input 0 is output 0
    of a BatchNorm with fix_gamma (and no output_mean_var) used once,
    whose own data input, through any Casts, is an aux state or an
    argument of grad_req 'null'."""
    index = {id(n): i for i, n in enumerate(topo)}
    uses = {}
    for n in topo:
        for src, oi in n.inputs:
            uses[(id(src), oi)] = uses.get((id(src), oi), 0) + 1
    for n, oi in heads:
        uses[(id(n), oi)] = uses.get((id(n), oi), 0) + 1

    def grad_free(n):
        while n.op is not None and n.op.name == 'Cast':
            n = n.inputs[0][0]
        if n.op is not None:
            return False
        return n.name in aux_names or grad_req.get(n.name, 'null') == 'null'

    out = {}
    for ci, conv in enumerate(topo):
        if conv.op is None or conv.op.name != 'Convolution' or \
                not asbool(conv.attrs.get('no_bias', False)) or \
                len(astuple(conv.attrs.get('kernel', ()))) != 2:
            continue
        bn, boi = conv.inputs[0]
        if bn.op is None or bn.op.name != 'BatchNorm' or boi != 0 or \
                not asbool(bn.attrs.get('fix_gamma', False)) or \
                asbool(bn.attrs.get('output_mean_var', False)) or \
                uses.get((id(bn), 0), 0) != 1 or \
                not grad_free(bn.inputs[0][0]):
            continue
        out[ci] = index[id(bn)]
    return out


# the ops whose output is a storage of its own (no view of an input),
# which an activation of the eval walk may write in place
_FRESH_OUTPUT_OPS = ('Convolution', 'FullyConnected', 'BatchNorm')


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops run under this mode
    allocate and that are alive at once, and their peak (`peak`): the
    CPU allocator keeps no peak of its own. A storage counts from the op
    that returns it until it is freed (a weak reference to the storage,
    which lives as long as any tensor or saved value holds it); an
    output that shares an input's storage (a view, an in-place op)
    allocates nothing."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.current = self.peak = 0

    def _free(self, key):
        self.current -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage()._cdata
                  for t in _pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in _pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self.live or key in inputs:
                continue
            self.live[key] = storage.nbytes()
            self.current += self.live[key]
            self.peak = max(self.peak, self.current)
            weakref.finalize(storage, self._free, key)
        return out


def _tensor_of(value, dtype, device, copy=False):
    """A tensor of `value` (an NDArray, a torch tensor or anything
    numpy takes, a bfloat16 numpy array included) in `dtype` on
    `device`; with `copy`, never the source's own storage."""
    if isinstance(value, nd.NDArray):
        t = value._data.detach()
    elif isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        a = np.asarray(value)
        if a.dtype.name == 'bfloat16':
            # numpy's bfloat16 (ml_dtypes) has no torch counterpart to
            # convert through: its bits are bfloat16's
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=torch_dtype(dtype), copy=copy)


def params_from_jax(arg_np, aux_np, ctx):
    """The JAX executor's parameters, its arg_dict / aux_dict as numpy
    arrays by name (OIHW conv weights, bfloat16 arrays included), as the
    port's NDArrays on `ctx`, each in its array's dtype, which is the one
    both packages' infer_type gives it. Returns (arg_params,
    aux_params) for `Executor.copy_params_from`."""
    def convert(arrays):
        out = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            dtype = 'bfloat16' if a.dtype.name == 'bfloat16' else a.dtype
            out[name] = nd.NDArray(_tensor_of(a, dtype, ctx.torch_device),
                                   ctx)
        return out
    return convert(arg_np), convert(aux_np or {})


def _check_ctx(ctx):
    if not isinstance(ctx, Context):
        raise TypeError('an executor binds to a Context (mx.gpu(0), '
                        'mx.cpu()); got %r' % (ctx,))
    if ctx.device_type == 'gpu' and not torch.cuda.is_available():
        raise MXNetError('bind to %s: torch.cuda.is_available() is False; '
                         'bind to mx.cpu() to run on the CPU' % ctx)


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict, aux_dict,
                 grad_req_dict, group2ctx=None):
        _check_ctx(ctx)
        for g in (group2ctx or {}).values():
            _check_ctx(g)
        self._symbol = symbol
        self._ctx = ctx
        self._group2ctx = dict(group2ctx or {})
        self.arg_dict = arg_dict        # OrderedDict name -> NDArray
        self.grad_dict = grad_dict      # name -> NDArray (or absent)
        self.aux_dict = aux_dict        # OrderedDict name -> NDArray
        self._grad_req = grad_req_dict  # name -> 'write'|'add'|'null'
        self._arg_names = list(arg_dict.keys())
        self._aux_names = list(aux_dict.keys())
        self._diff_names = [n for n in self._arg_names
                            if grad_req_dict.get(n, 'null') != 'null']
        self.outputs = []
        # the autograd graph of the last train-mode forward, for backward
        self._stash = None
        # the conv -> BatchNorm pair route, read by each forward; off,
        # the pairs run unfused, which the tests and chip_smoke.py's
        # phase 9 compare it with
        self._pair_route = True
        self._monitor_callback = None
        self._partial_state = None
        # fused train dispatches run (run_fused_multistep)
        self.fused_dispatches = 0
        # data parallelism (module docstring): the data mesh, the batch
        # inputs (data and labels) and the in-step gradient all-reduce
        self._mesh = None
        self._batch_inputs = ()
        self._kinds = None
        self.grad_reduce = None
        # the sparse embedding tier (parallel/embedding.py): the tables
        # that train rows-only once the Module's updater takes them
        # (set_sparse_tables), each train forward's touched rows, and
        # the (ids, row gradients, lo) its backward gave each table
        self._sparse_entries = None
        self._sparse_on = False
        self._sparse_active = None
        self.sparse_grads = {}
        self._build()

    def _build(self):
        sym = self._symbol
        self._topo = topo = sym._topo()
        self._node_index = {id(n): i for i, n in enumerate(topo)}
        self._arg_pos = {n: i for i, n in enumerate(self._arg_names)}
        self._aux_pos = {n: i for i, n in enumerate(self._aux_names)}
        self._out_entries = [(self._node_index[id(n)], i)
                             for n, i in sym._outputs]
        # per node: the op nodes whose values the walk drops before it,
        # those whose last reader is the node before it (the graph's
        # outputs are kept)
        last_read = {}
        for ni, n in enumerate(topo):
            for src, _ in n.inputs:
                last_read[self._node_index[id(src)]] = ni
        for ni, _ in self._out_entries:
            last_read.pop(ni, None)
        self._release = {}
        for si, ni in last_read.items():
            if topo[si].op is not None:
                self._release.setdefault(ni + 1, []).append(si)
        # Activations the eval walk runs in place (the reference's
        # inplace plan): those whose input is the fresh output of an op
        # that no other node reads and that is no graph output
        readers = {}
        for n in topo:
            for src, _ in n.inputs:
                readers[id(src)] = readers.get(id(src), 0) + 1
        self._inplace = set()
        for ni, n in enumerate(topo):
            if n.op is None or n.op.name != 'Activation':
                continue
            src = n.inputs[0][0]
            if str(parse_attr_value(n.attrs['act_type'])) in \
                    _nn.ACTS_INPLACE and src.op is not None and \
                    src.op.name in _FRESH_OUTPUT_OPS and \
                    readers[id(src)] == 1 and \
                    self._node_index[id(src)] in last_read:
                self._inplace.add(ni)
        # shape-carrying init ops (zeros(shape=(0, H))) take their
        # bidirectionally inferred shapes, when their attr has 0 dims
        node_shapes = {}
        if any(n.op is not None and n.op.needs_out_shapes and
               any(d == 0 for d in astuple(n.attrs.get('shape', ())))
               for n in topo):
            known = {name: tuple(a.shape)
                     for name, a in list(self.arg_dict.items()) +
                     list(self.aux_dict.items())}
            by_id = sym._infer_node_shapes(known)
            node_shapes = {self._node_index[nid]: v
                           for nid, v in by_id.items()}
        self._node_shapes = node_shapes
        self._has_aux_always = any(
            n.op is not None and n.op.mutable_aux and n.op.aux_always
            for n in topo)
        # the context each op node runs on: its group's where its
        # ctx_group attribute maps to one
        self._node_ctx = {
            ni: self._group2ctx[n.user_attrs['ctx_group']]
            for ni, n in enumerate(topo)
            if n.op is not None and
            n.user_attrs.get('ctx_group') in self._group2ctx}
        self._grouped = bool(self._node_ctx)
        pref = os.environ.get('MXNET_TPU_LAYOUT_OPT', 'auto')
        if pref == '1':
            self._layout_opt = True
        elif pref == 'auto':
            self._layout_opt = self._ctx.device_type == 'gpu' and \
                not self._grouped
        elif pref in ('0', ''):
            self._layout_opt = False
        else:
            raise ValueError("MXNET_TPU_LAYOUT_OPT must be 'auto', '1' or "
                             "'0', got %r" % pref)
        split = os.environ.get('MXNET_TPU_STEM_SPLIT', '1') not in ('0', '')
        self._split_conv = stem_splits(
            topo, sym._outputs, self._grad_req, self._aux_pos) \
            if split else {}
        self._split_bn = set(self._split_conv.values())
        # a split conv leaves the route (module docstring); a grouped
        # executor takes none
        self.pairs = {} if self._grouped else {
            c: b for c, b in conv_bn_pairs(topo, sym._outputs).items()
            if c not in self._split_conv}
        self._sig = exec_cache.graph_signature(
            sym, self._ctx, self.arg_dict, self.aux_dict, self._grad_req,
            self._group2ctx)
        # the monitor's names of every op node's outputs, in topo order
        self._monitor_names = []
        for node in topo:
            if node.op is None:
                continue
            n_out = node.op.num_outputs(node.attrs)
            if n_out == 1:
                self._monitor_names.append(node.name + '_output')
            else:
                self._monitor_names.extend('%s_output%d' % (node.name, i)
                                           for i in range(n_out))

    # ------------------------------------------------------------------
    def _pair_conv(self, node, vals, in_l):
        """The conv of a pair on the conv + statistics kernel: (y NHWC,
        (s1, s2))."""
        _, stride, _, pad, _ = _nn.conv_params(node.attrs)
        return pair_conv(_to_nhwc(vals[0], in_l[0]), vals[1], stride, pad)

    # -- the sparse embedding tier --------------------------------------
    def sparse_diff_positions(self):
        """Positions, in _diff_names order, of the sparse tables."""
        return tuple(e['dpos'] for e in self._sparse_embed_entries())

    def _sparse_embed_entries(self):
        """One entry per sparse_grad table that is a differentiable
        argument (its lookups grouped): weight, dpos, ids (the id
        inputs), vocab, dim and the static rung min(vocab, the global
        batch's id slots). Raises on ids computed in the graph or ids
        that are a differentiable argument."""
        if self._sparse_entries is not None:
            return self._sparse_entries
        entries = []
        if not self._grouped:
            from .parallel import embedding as embed_mod
            diff_set = set(self._diff_names)
            dpos = {n: j for j, n in enumerate(self._diff_names)}
            dp = 1 if self._mesh is None else \
                self._mesh.shape.get('data', 1)
            by_w = OrderedDict()
            for t in embed_mod.find_symbol_tables(self._symbol):
                if t['weight'] not in diff_set:
                    continue
                if t['ids_input'] is None:
                    raise MXNetError(
                        'sparse embedding (Module path): table %r is looked '
                        'up with graph-derived ids; the sparse rewrite needs '
                        'the ids as a bound input variable. Feed the ids '
                        'directly or set sparse_grad=False on this table.'
                        % t['weight'])
                if t['ids_input'] in diff_set:
                    raise MXNetError(
                        'sparse embedding (Module path): ids input %r of '
                        'table %r is a differentiable arg; integer ids carry '
                        "no gradient, rebind it with grad_req='null'."
                        % (t['ids_input'], t['weight']))
                by_w.setdefault(t['weight'], []).append(t)
            for w, ts in by_w.items():
                slots = sum(max(1, int(np.prod(
                    self.arg_dict[t['ids_input']].shape))) * dp for t in ts)
                entries.append({
                    'weight': w, 'dpos': dpos[w],
                    'ids': [t['ids_input'] for t in ts],
                    'vocab': int(ts[0]['vocab']), 'dim': int(ts[0]['dim']),
                    'rung': min(int(ts[0]['vocab']), slots)})
        self._sparse_entries = entries
        return entries

    def set_sparse_tables(self, on):
        """Train the sparse tables rows-only (on) or densely."""
        self._sparse_on = bool(on) and bool(self._sparse_embed_entries())

    def _sparse_prep(self):
        """The touched rows of each sparse table for one train forward:
        {weight: (override, uids, rows, lo)}."""
        from .parallel import embedding as embed_mod
        mesh = self._mesh
        n, index = embed_mod._data_split(mesh)
        active = {}
        for e in self._sparse_embed_entries():
            glob = [embed_mod.gather_global_ids(self.arg_dict[i]._data, mesh)
                    for i in e['ids']]
            uids, invs = embed_mod.dedup_ids(glob, e['rung'], e['vocab'])
            local = [inv[index * (inv.numel() // n):
                         (index + 1) * (inv.numel() // n)] for inv in invs]
            rows = embed_mod.striped_gather(
                self.arg_dict[e['weight']]._data, uids, e['vocab'], mesh)
            rows = rows.detach().requires_grad_(True)
            lo = embed_mod.stripe_range(e['vocab'], n, index)[0]
            active[e['weight']] = (embed_mod._Override(rows, local, e['dim']),
                                   uids, rows, lo)
        return active

    def _sparse_lookup(self, node, vals):
        """The lookup of a sparse table served from its touched rows, or
        None."""
        ent = self._sparse_active.get(node.inputs[1][0].name)
        if ent is None:
            return None
        ov = ent[0]
        inv = ov.invs.pop(0)
        return ov.rows[inv].reshape(tuple(vals[0].shape) + (ov.dim,))

    def set_data_mesh(self, mesh, batch_inputs):
        """Make this executor a rank of the data mesh `mesh` (None: one
        device), `batch_inputs` the names of its batch-carrying
        arguments."""
        self._mesh = mesh
        self._batch_inputs = tuple(batch_inputs)
        self._kinds = None
        self._sparse_entries = None

    # under a data mesh each node's value is one of: 'B' this rank's rows
    # of a batch-carrying value; 'R' replicated, a reduction over the
    # batch or downstream of one; 'P' replicated, of the parameters and
    # constants alone. 'G' marks an op that reduces a batch-carrying
    # value over axis 0, which runs in its global form
    # (parallel/batch_reduce.py); its value is 'R', or 'B' for this
    # rank's block of a global sort
    def _node_kind(self, node, vals):
        if node.op is None:
            return 'B' if node.name in self._batch_inputs else 'P'
        kinds = [self._kinds[self._node_index[id(src)]]
                 for src, _ in node.inputs]
        if kinds and kinds[0] == 'B' and _breduce.reduces_batch(
                node.op.name, node.attrs, vals[0].ndim):
            return 'G'
        if 'B' in kinds:
            return 'B'
        return 'R' if 'R' in kinds else 'P'

    def replicated_outputs(self):
        """Per output, whether every rank of the data mesh holds the same
        whole value (a reduction over the batch, or of the parameters
        alone), not its rows; known after a forward under the mesh."""
        kinds = self._kinds
        return [kinds is not None and kinds[ni] != 'B'
                for ni, _ in self._out_entries]

    def _mesh_vals(self, ni, node, vals):
        """The kind of node `ni` under the data mesh, recorded, and its
        inputs: a replicated value entering a batch-carrying op sums its
        cotangent over the mesh; a parameter's value entering replicated
        math keeps its gradient on one rank (batch_reduce)."""
        kind = self._node_kind(node, vals)
        srcs = [self._kinds[self._node_index[id(src)]]
                for src, _ in node.inputs]
        if kind == 'G':
            self._kinds[ni] = 'R' if _breduce.output_replicated(
                node.op.name, node.attrs, vals[0].ndim) else 'B'
            return kind, vals
        self._kinds[ni] = kind
        if kind == 'B':
            vals = [_breduce.enter_batch(v, self._mesh) if k == 'R' else v
                    for v, k in zip(vals, srcs)]
        elif kind == 'R':
            vals = [_breduce.root_grad(v, self._mesh) if k == 'P' else v
                    for v, k in zip(vals, srcs)]
        return kind, vals

    def _run_graph(self, arg_vals, aux_vals, is_train, collect=None,
                   rng=None):
        """Walk the DAG; returns (outputs, new aux values). A list
        `collect` receives every op node's outputs in topo order, in the
        semantic (NCHW) layout, for the monitor. `rng`, a torch.Generator,
        feeds the ops that draw in place of the device's generator."""
        with _pmesh.data_mesh_scope(self._mesh) as dp:
            return self._walk(arg_vals, aux_vals, is_train, collect, rng,
                              dp is not None)

    def _walk(self, arg_vals, aux_vals, is_train, collect, rng, dp):
        topo = self._topo
        if dp:
            self._kinds = [None] * len(topo)
        results = [None] * len(topo)   # per node: list of outputs
        layouts = [None] * len(topo)   # per node: layout per output
        new_aux = list(aux_vals)
        pairs = self.pairs if self._pair_route and is_train else {}
        sums = {}                      # BatchNorm node index -> (s1, s2)
        # the monitor sees every node's own output: no split there
        split_conv = self._split_conv if collect is None else {}
        split_beta = {}                # split BatchNorm index -> beta
        node_ctx = self._node_ctx
        for ni, node in enumerate(topo):
            # a value no later node reads goes now (autograd keeps what
            # the backward needs)
            for si in self._release.get(ni, ()):
                results[si] = None
            if node.op is None:
                if node.name in self._arg_pos:
                    results[ni] = [arg_vals[self._arg_pos[node.name]]]
                else:
                    results[ni] = [new_aux[self._aux_pos[node.name]]]
                layouts[ni] = ['NCHW']
                if dp:
                    self._kinds[ni] = self._node_kind(node, None)
                continue
            op = node.op
            vals = [results[self._node_index[id(src)]][idx]
                    for src, idx in node.inputs]
            kind = 'B'
            if dp:
                kind, vals = self._mesh_vals(ni, node, vals)
                if kind == 'G':
                    in_l = [layouts[self._node_index[id(src)]][idx]
                            for src, idx in node.inputs]
                    outs = _breduce.global_reduce(
                        op, node.attrs,
                        [_to_nchw(v, l) for v, l in zip(vals, in_l)],
                        self._mesh)
                    results[ni], layouts[ni] = outs, ['NCHW'] * len(outs)
                    if collect is not None:
                        collect.extend(outs)
                    continue
            if self._sparse_active and op.name == 'Embedding':
                out = self._sparse_lookup(node, vals)
                if out is not None:
                    results[ni], layouts[ni] = [out], ['NCHW']
                    if collect is not None:
                        collect.append(out)
                    continue
            in_l = [layouts[self._node_index[id(src)]][idx]
                    for src, idx in node.inputs]
            if ni in pairs and vals[0].dtype == torch.bfloat16 and \
                    vals[1].dtype == torch.bfloat16:
                y, sums[pairs[ni]] = self._pair_conv(node, vals, in_l)
                results[ni], layouts[ni] = [y], ['NHWC']
                if collect is not None:
                    collect.append(_to_nchw(y, 'NHWC'))
                continue
            eff_attrs = node.attrs
            out_layout = 'NCHW'
            if ni in sums:
                mode = 'io'
            elif self._layout_opt:
                mode = _layout_mode(op, node.attrs, vals)
            else:
                mode = None
            if mode == 'io':
                # the data input rides NHWC; params and aux stay as-is
                vals = [_to_nhwc(v, l) if j == 0 else _to_nchw(v, l)
                        for j, (v, l) in enumerate(zip(vals, in_l))]
                eff_attrs = dict(node.attrs, __layout__='NHWC')
                out_layout = 'NHWC'
            elif mode == 'elemwise' and 'NHWC' in in_l:
                vals = [_to_nhwc(v, l) if v.ndim == 4 else v
                        for v, l in zip(vals, in_l)]
                out_layout = 'NHWC'
            else:
                vals = [_to_nchw(v, l) for v, l in zip(vals, in_l)]
            n_aux = op.num_aux
            args = vals[:len(vals) - n_aux] if n_aux else vals
            auxs = vals[len(vals) - n_aux:] if n_aux else []
            device = node_ctx.get(ni, self._ctx).torch_device
            if ni in node_ctx:
                # the group's device: the inputs go there, and autograd
                # carries their gradients back
                args = [v.to(device) for v in args]
                auxs = [v.to(device) for v in auxs]
            op_ctx = OpContext(
                is_train=is_train,
                rng=(rng if rng is not None else
                     _random.generator(device)) if op.needs_rng else None,
                device=device,
                out_shapes=self._node_shapes.get(ni)
                if op.needs_out_shapes else None)
            if ni in self._split_bn and split_conv:
                # the stem split: the BatchNorm with beta zeroed (its
                # statistics and aux updates do not read beta), and no
                # graph on its output; the conv adds conv(beta 1) back
                args = list(args)
                split_beta[ni] = args[2]
                args[2] = torch.zeros_like(args[2].detach())
            if ni in self._inplace and collect is None and \
                    not torch.is_grad_enabled() and \
                    args[0].is_floating_point():
                eff_attrs = dict(eff_attrs, __inplace__=True)
            if ni in sums:
                outs, updated = pair_batch_norm(eff_attrs, args, auxs,
                                                op_ctx, sums.pop(ni))
            elif kind != 'B':
                # replicated math: the same one-device op on every rank
                with _pmesh.data_mesh_scope(None):
                    outs, updated = op.apply(eff_attrs, args, auxs, op_ctx)
            else:
                outs, updated = op.apply(eff_attrs, args, auxs, op_ctx)
            if ni in split_conv:
                outs = [outs[0] + self._beta_conv(
                    op, eff_attrs, args, split_beta.pop(split_conv[ni]),
                    op_ctx)]
            results[ni] = outs
            layouts[ni] = [out_layout if o.ndim == 4 else 'NCHW'
                           for o in outs]
            if collect is not None:
                collect.extend(_to_nchw(o, l)
                               for o, l in zip(outs, layouts[ni]))
            if op.mutable_aux and (is_train or op.aux_always) and updated:
                for (src, _), newv in zip(node.inputs[len(vals) - n_aux:],
                                          updated):
                    if src.op is None and src.name in self._aux_pos:
                        new_aux[self._aux_pos[src.name]] = newv.detach()
        outputs = [_to_nchw(results[ni][oi], layouts[ni][oi])
                   for ni, oi in self._out_entries]
        return outputs, new_aux

    @staticmethod
    def _beta_conv(op, attrs, args, beta, op_ctx):
        """conv(beta 1) of the stem split: the conv of the image whose
        every pixel is beta, at batch 1, in the activation dtype (the
        JAX package adds the two convs in that dtype too)."""
        x = args[0]
        beta = beta.to(x.dtype)
        if attrs.get('__layout__') == 'NHWC':
            b_in = beta.expand((1,) + tuple(x.shape[1:]))
        else:
            b_in = beta[:, None, None].expand((1,) + tuple(x.shape[1:]))
        outs, _ = op.apply(attrs, [b_in, args[1]], [], op_ctx)
        return outs[0]

    def _wrap_outputs(self, outs):
        """The walk's outputs as NDArrays, each on the context of the
        node that made it."""
        return [nd.NDArray(o, self._node_ctx.get(ni, self._ctx))
                for o, (ni, _) in zip(outs, self._out_entries)]

    def _commit_aux(self, new_aux):
        """New aux values into aux_dict, each on its array's device (a
        grouped BatchNorm updates them on its group's)."""
        for n, v in zip(self._aux_names, new_aux):
            holder = self.aux_dict[n]
            holder._data = v.to(holder._data.device)

    # ------------------------------------------------------------------
    def _name(self, suffix):
        return '%s_%s' % (self._symbol.name or 'executor', suffix)

    def _set_args(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError('forward: unknown argument %s' % k)
            dst = self.arg_dict[k]
            if isinstance(v, nd.NDArray) and v.shape != dst.shape:
                raise MXNetError('forward: shape mismatch for %s: %s vs '
                                 'bound %s' % (k, v.shape, dst.shape))
            # moved to the executor's device: inputs often arrive on
            # cpu(0) from host-side iterators
            dst._data = _tensor_of(v, dst._data.dtype,
                                   self._ctx.torch_device)

    def _train_forward(self, collect=None):
        """The train-mode walk under autograd: the diff args enter as
        leaves that require grad. Returns (outputs, leaves)."""
        arg_vals = []
        leaves = []
        diff = set(self._diff_names)
        self._sparse_active = self._sparse_prep() if self._sparse_on \
            else None
        sparse = self._sparse_active or {}
        for n in self._arg_names:
            t = self.arg_dict[n]._data.detach()
            if n in diff:
                # a sparse table takes no dense gradient
                if n not in sparse:
                    t = t.requires_grad_(True)
                leaves.append(t)
            arg_vals.append(t)
        aux_vals = [self.aux_dict[n]._data.detach() for n in self._aux_names]
        with torch.enable_grad():
            outs, new_aux = self._run_graph(arg_vals, aux_vals, True,
                                            collect)
        self._commit_aux(new_aux)
        self.outputs = self._wrap_outputs([o.detach() for o in outs])
        return outs, leaves

    def forward(self, is_train=False, **kwargs):
        if kwargs:
            self._set_args(kwargs)
        self._stash = None
        monitor = self._monitor_callback
        # every node's outputs only while the monitor collects
        collect = [] if monitor is not None and \
            getattr(monitor, 'active', True) else None
        if is_train:
            with profiler.scope(self._name('forward_train')):
                self._stash = self._train_forward(collect)
                profiler.synchronize(self._stash[0])
        else:
            arg_vals = [self.arg_dict[n]._data for n in self._arg_names]
            aux_vals = [self.aux_dict[n]._data for n in self._aux_names]
            with profiler.scope(self._name('forward')), torch.no_grad():
                outs, new_aux = self._run_graph(arg_vals, aux_vals, False,
                                                collect)
                profiler.synchronize(outs)
            if self._has_aux_always:
                # update ops advance their states on every call
                self._commit_aux(new_aux)
            self.outputs = self._wrap_outputs(outs)
        if collect is not None:
            for name, v in zip(self._monitor_names, collect):
                monitor(name, nd.NDArray(v.detach(), self._ctx))
        return self.outputs

    def serve(self, arg_vals, aux_vals, rng=None):
        """The eval walk on the given tensors, one per argument and aux
        state in list order: the outputs, fresh tensors each call. No
        state of the executor is read or written but its graph, and the
        device is not synchronised (the counterpart of the JAX
        package's raw_forward, which the serving engine jits). `rng`, a
        torch.Generator on the executor's device, feeds the ops that
        draw (the JAX package's PRNG key argument); default the
        device's generator."""
        with torch.inference_mode():
            outs, _ = self._run_graph(list(arg_vals), list(aux_vals),
                                      False, rng=rng)
        return outs

    def partial_forward(self, step=None, is_train=False, **kwargs):
        """Run the forward graph only up to op node `step` (reference
        Executor::PartialForward): the topo prefix op by op, the partial
        state kept so that the next call goes on where this one stopped;
        step=None finishes the graph. Ops run on their semantic layouts
        and the pair route is not taken. Returns the number of op nodes
        still to run."""
        topo = self._topo
        op_nodes = [n for n in topo if n.op is not None]
        total = len(op_nodes)
        if kwargs:
            self._set_args(kwargs)
            self._partial_state = None
        state = self._partial_state
        device = self._ctx.torch_device
        if state is None:
            state = {'done': 0, 'results': {},
                     'args': [self.arg_dict[n]._data
                              for n in self._arg_names],
                     'auxs': [self.aux_dict[n]._data
                              for n in self._aux_names]}
        target = total if step is None else min(int(step), total)
        done_ops = 0
        with torch.no_grad():
            for ni, node in enumerate(topo):
                if node.op is None:
                    if ni not in state['results']:
                        state['results'][ni] = [
                            state['args'][self._arg_pos[node.name]]
                            if node.name in self._arg_pos else
                            state['auxs'][self._aux_pos[node.name]]]
                    continue
                done_ops += 1
                if done_ops <= state['done']:
                    continue
                if done_ops > target:
                    break
                op = node.op
                vals = [state['results'][self._node_index[id(src)]][idx]
                        for src, idx in node.inputs]
                n_aux = op.num_aux
                args = vals[:len(vals) - n_aux] if n_aux else vals
                auxs = vals[len(vals) - n_aux:] if n_aux else []
                op_ctx = OpContext(
                    is_train=is_train,
                    rng=_random.generator(device) if op.needs_rng else None,
                    device=device,
                    out_shapes=self._node_shapes.get(ni)
                    if op.needs_out_shapes else None)
                outs, updated = op.apply(node.attrs, args, auxs, op_ctx)
                state['results'][ni] = outs
                if op.mutable_aux and (is_train or op.aux_always) and \
                        updated:
                    # consumers keep the value before the update, as in
                    # the whole walk
                    for (src, _), newv in zip(
                            node.inputs[len(vals) - n_aux:], updated):
                        if src.op is None and src.name in self._aux_pos:
                            state['auxs'][self._aux_pos[src.name]] = newv
        state['done'] = min(target, total)
        self._partial_state = state
        if state['done'] < total:
            return total - state['done']
        self.outputs = [nd.NDArray(state['results'][ni][oi], self._ctx)
                        for ni, oi in self._out_entries]
        for n, v in zip(self._aux_names, state['auxs']):
            self.aux_dict[n]._data = v
        self._partial_state = None
        return 0

    def set_monitor_callback(self, callback):
        """callback(name, NDArray) receives every op node's outputs of
        each forward while `callback.active` (default True) holds."""
        self._monitor_callback = callback

    def _bound_bytes(self):
        return sum(a._data.numel() * a._data.element_size()
                   for a in list(self.arg_dict.values()) +
                   list(self.aux_dict.values()))

    def memory_cost(self, mode='forward'):
        """Memory of one run of this executor on the card, the role of
        the reference's memcost example (there the NNVM allocation plan,
        in the JAX package XLA's buffer assignment): `mode` 'forward'
        (the eval walk), 'train' (the train-mode walk) or
        'train_backward' (forward and backward). Returns
        argument_bytes (the bound arrays the walk reads), output_bytes
        (its outputs; with 'train' the new aux states too, with
        'train_backward' the gradients too), peak_memory_bytes (the
        allocator's peak over the run, torch.cuda.max_memory_allocated,
        above what was allocated before it, plus argument_bytes),
        temp_bytes (peak less arguments and outputs) and
        generated_code_bytes (0: nothing is compiled). The run changes
        no state of the executor, but it resets the device's peak
        memory statistics. The CPU allocator keeps no peak, so on a CPU
        executor the peak is that of the bytes of the storages the run's
        ops allocate and that are alive at once (`_LiveBytes`). Both are
        what one eager run really holds, op by op; XLA's buffer
        assignment in the JAX package is a static plan of the whole
        compiled program, which reuses and fuses buffers, so its temp
        bytes are not these."""
        if mode not in ('forward', 'train', 'train_backward'):
            raise ValueError("memory_cost mode must be 'forward', "
                             "'train' or 'train_backward', got %r" % mode)
        device = self._ctx.torch_device
        on_card = device.type == 'cuda'
        arg_bytes = self._bound_bytes()
        if on_card:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        arg_vals = [self.arg_dict[n]._data.detach()
                    for n in self._arg_names]
        aux_vals = [self.aux_dict[n]._data.detach()
                    for n in self._aux_names]
        tracker = contextlib.nullcontext() if on_card else _LiveBytes()
        with tracker:
            results = self._memory_cost_run(mode, arg_vals, aux_vals)
        out_bytes = sum(t.numel() * t.element_size() for t in results)
        if on_card:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - before
        else:
            peak = tracker.peak
        peak += arg_bytes
        return dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                    temp_bytes=int(max(peak - arg_bytes - out_bytes, 0)),
                    peak_memory_bytes=int(peak), generated_code_bytes=0)

    def _memory_cost_run(self, mode, arg_vals, aux_vals):
        """memory_cost's run: the walk of `mode`; returns what it
        leaves alive (outputs, new aux states, gradients)."""
        if mode == 'forward':
            with torch.no_grad():
                outs, _ = self._run_graph(arg_vals, aux_vals, False)
            results = list(outs)
        else:
            leaves = []
            for i, n in enumerate(self._arg_names):
                if n in self._diff_names:
                    arg_vals[i] = arg_vals[i].requires_grad_(True)
                    leaves.append(arg_vals[i])
            with torch.enable_grad():
                outs, new_aux = self._run_graph(arg_vals, aux_vals, True)
            results = [o.detach() for o in outs] + list(new_aux)
            if mode == 'train_backward':
                live = [o for o in outs if o.requires_grad]
                grads = torch.autograd.grad(
                    live, leaves, [torch.ones_like(o) for o in live],
                    allow_unused=True) if live and leaves else []
                results += [g for g in grads if g is not None]
        return results

    def debug_str(self):
        """Plan dump: the topo-ordered ops and the bytes of the bound
        arrays (reference Executor::Print)."""
        lines = ['Symbol outputs: %s' % ', '.join(
            self._symbol.list_outputs())]
        for node in self._topo:
            if node.op is None:
                continue
            group = node.user_attrs.get('ctx_group')
            lines.append('  op %s (%s)%s' % (
                node.name, node.op.name, ' @%s' % group if group else ''))
        total = self._bound_bytes()
        lines.append('Total bytes in args/aux: %d (%.1f MB)'
                     % (total, total / 1e6))
        lines.append('Executed: op by op on %s (no compiled module)'
                     % self._ctx)
        return '\n'.join(lines)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound to new input shapes (reference
        executor.py reshape; Module.reshape, Predictor.reshape): the
        arg, grad and aux arrays whose shapes did not change are shared,
        the others are new zeros."""
        sym = self._symbol
        arg_shapes, _, aux_shapes = sym.infer_shape(**kwargs)
        arg_names = sym.list_arguments()

        def keep(cur, shape):
            return cur if cur.shape == tuple(shape) else \
                nd.zeros(shape, self._ctx, dtype=cur._data.dtype)

        arg_dict = OrderedDict(
            (name, keep(self.arg_dict[name], shape))
            for name, shape in zip(arg_names, arg_shapes))
        grad_dict = {name: keep(g, arg_shapes[arg_names.index(name)])
                     for name, g in self.grad_dict.items()}
        aux_dict = OrderedDict(
            (name, keep(self.aux_dict[name], shape))
            for name, shape in zip(sym.list_auxiliary_states(), aux_shapes))
        return Executor(sym, self._ctx, arg_dict, grad_dict, aux_dict,
                        dict(self._grad_req), group2ctx=self._group2ctx)

    def _backward(self, out_grads):
        outs, leaves = self._stash
        self._stash = None
        heads = self._default_head_grads(out_grads)
        live = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        sparse = self._sparse_active or {}
        self._sparse_active = None
        rows = [v[2] for v in sparse.values()]
        want = [i for i, t in enumerate(leaves) if t.requires_grad]
        grads = [None] * len(leaves)
        # the in-step reduce: a GradReduce's pass hooks the leaves; a
        # plain function of the gradients applies after the backward
        red = self.grad_reduce
        rpass = red.begin(leaves) if hasattr(red, 'begin') and live and \
            leaves else None
        row_grads = [None] * len(rows)
        if live and (want or rows):
            gs = torch.autograd.grad([o for o, _ in live],
                                     [leaves[i] for i in want] + rows,
                                     [h for _, h in live],
                                     allow_unused=True)
            for i, g in zip(want, gs):
                grads[i] = g
            row_grads = list(gs[len(want):])
        # an argument no output depends on, or one cut off by a
        # stop-gradient (fix_gamma's gamma), gets a zero gradient; a
        # sparse table none (its gradient is its rows')
        grads = [torch.zeros_like(t) if g is None and t.requires_grad
                 else g for t, g in zip(leaves, grads)]
        if rpass is not None:
            grads = rpass.finish(grads)
        elif red is not None and not hasattr(red, 'begin'):
            grads = red(grads)
        self.sparse_grads = {}
        for (name, (_, uids, r, lo)), g in zip(sparse.items(), row_grads):
            g = torch.zeros_like(r) if g is None else g
            if self._mesh is not None and self._mesh.shape.get('data', 1) > 1:
                from .parallel.collectives import _all_reduce
                g = _all_reduce(g, self._mesh, 'data')
            self.sparse_grads[name] = (uids, g, lo)
        self._write_grads(grads)
        return grads

    def backward(self, out_grads=None):
        """Gradients of the last forward(is_train=True) into grad_dict.
        Its autograd graph is freed: a second backward needs another
        train-mode forward."""
        if self._stash is None:
            raise MXNetError('backward called before forward(is_train=True)')
        with profiler.scope(self._name('backward')):
            profiler.synchronize(self._backward(out_grads))

    def forward_backward(self, out_grads=None, **kwargs):
        """Train-mode forward and backward in one call (the path Module
        takes). Returns the outputs."""
        if kwargs:
            self._set_args(kwargs)
        with profiler.scope(self._name('forward_backward')):
            self._stash = self._train_forward()
            profiler.synchronize(self._backward(out_grads))
        return self.outputs

    def _default_head_grads(self, out_grads):
        """No head grads: ones. Loss outputs (SoftmaxOutput) scale their
        own gradient by the head cotangent, so ones give the reference's
        backward(). On a graph of several outputs that are not losses,
        ones give the gradient of their sum, which the reference refuses;
        a warning says so once."""
        if out_grads is None:
            if len(self.outputs) > 1 and not getattr(
                    self, '_warned_multi_head', False):
                self._warned_multi_head = True
                warnings.warn(
                    'backward() without head gradients on a %d-output '
                    'graph: gradients are of the SUM of outputs (loss ops '
                    'are unaffected; pass out_grads for per-output '
                    'control)' % len(self.outputs))
            return [torch.ones_like(o._data) for o in self.outputs]
        if isinstance(out_grads, nd.NDArray):
            out_grads = [out_grads]
        return [_tensor_of(g, o._data.dtype, o._data.device)
                for g, o in zip(out_grads, self.outputs)]

    def _write_grads(self, grads):
        for n, g in zip(self._diff_names, grads):
            holder = self.grad_dict.get(n)
            if holder is None or g is None:
                continue
            if self._grad_req.get(n) == 'add':
                holder._data = holder._data + g
            else:
                holder._data = g

    # ------------------------------------------------------------------
    def make_fused_train_step(self, step_math, step_key=None,
                              grad_reduce=None):
        """The whole train step with the optimizer's update, the
        counterpart of the JAX package's fused step (one XLA dispatch
        there): `forward_backward`, then `step_math(ws, gs, moms,
        masters, lrs, wds) -> (ws, moms, masters)` (FusedSGD.step_math)
        on the bound weights of the differentiable arguments, in
        _diff_names order, which it updates in place. Torch has no
        single dispatch to fuse them into, and there is no program to
        cache, so `step_key` is not used.

        `grad_reduce`, for the step's backward in place of the
        executor's own: a `collectives.GradReduce` (the in-step
        all-reduce over the data axis, interleaved with the backward by
        its hooks or after it) or a function of the list of gradients,
        applied after the backward."""
        def step(diff_names, moms, masters, lrs, wds):
            with self._reducing(grad_reduce):
                self.forward_backward()
            ws = [self.arg_dict[n]._data for n in diff_names]
            return step_math(ws, self.step_grads(diff_names), moms,
                             masters, lrs, wds)
        return step

    def step_grads(self, names):
        """The gradients of `names` for the optimizer: a sparse table's
        (ids, row gradients, lo), every other one's tensor."""
        return [self.sparse_grads[n] if n in self.sparse_grads
                else self.grad_dict[n]._data for n in names]

    @contextlib.contextmanager
    def _reducing(self, grad_reduce):
        """A scope in which the backward reduces by `grad_reduce` (None:
        the executor's own)."""
        prev = self.grad_reduce
        if grad_reduce is not None:
            self.grad_reduce = grad_reduce
        try:
            yield
        finally:
            self.grad_reduce = prev

    def run_fused_train_step(self, step, diff_names, moms, masters,
                             lrs, wds, zero=False):
        """Run a step of make_fused_train_step on the bound arrays and
        return (new_moms, new_masters) for the optimizer; the weights it
        returns are bound (they are the same tensors when step_math
        updates in place). `zero`: step_math is the ZeRO-1 sharded
        update, whose moms and masters are this rank's bucket blocks
        (the executor's gradients are then this rank's own)."""
        new_ws, new_moms, new_masters = step(diff_names, moms, masters,
                                             lrs, wds)
        for n, w in zip(diff_names, new_ws):
            self.arg_dict[n]._data = w
        return new_moms, new_masters

    def make_fused_multistep(self, step_math, scan_names, repeat=None,
                             step_key=None, grad_reduce=None, metric=None,
                             lr_stacked=False):
        """K whole train steps (forward, backward, step_math's update) in
        one dispatch, the counterpart of the JAX package's lax.scan
        program: the steps run back to back on the device's stream with
        no host synchronisation among them. `scan_names` are the
        arguments fed per step (data, labels): stacked on a leading K
        axis, or with `repeat=K` the bound batch K times. The stacks may
        be narrower than the bound dtype (bulk_step's scan_dtype): each
        step casts its slice back. `metric` is an (init, update) pair,
        init(device) the zero carry and update(carry, outs, step_vals)
        torch ops on device tensors; the final carry comes back. With
        `lr_stacked`, lrs and wds are one list per step, else one for
        all. Only the last step's outputs are kept, and the monitor does
        not fire.

        The program takes the executor as its first argument and keeps
        nothing of it, so equivalent executors share it through
        exec_cache under (graph signature, ..., step_key), as in the JAX
        package; its first call is billed to the cache's build time.
        Returns None for a grouped executor, whose steps run one by
        one. `grad_reduce` as in make_fused_train_step, for every step's
        backward."""
        if self._grouped:
            return None
        diff_set = set(self._diff_names)
        scan_order = [n for n in self._arg_names
                      if n in set(scan_names) and n not in diff_set]
        scan_dt = tuple(str(self.arg_dict[n]._data.dtype)
                        for n in scan_order)
        cache_key = None
        if step_key is not None:
            cache_key = (self._sig, 'multistep', tuple(scan_order), repeat,
                         scan_dt, bool(lr_stacked), step_key)
            fn = exec_cache.get(cache_key, count=True)
            if fn is not None:
                return fn

        def multistep(ex, diff_names, scan_stacks, moms, masters, lrs, wds):
            k = repeat if repeat is not None else \
                len(next(iter(scan_stacks.values())))
            mc = metric[0](ex._ctx.torch_device) if metric is not None \
                else ()
            for i in range(k):
                sv = []
                for n in scan_order:
                    bound = ex.arg_dict[n]._data
                    if scan_stacks is not None:
                        v = scan_stacks[n][i]
                        if v.dtype != bound.dtype:
                            v = v.to(bound.dtype)
                        ex.arg_dict[n]._data = v
                    sv.append(ex.arg_dict[n]._data)
                with ex._reducing(grad_reduce):
                    ex.forward_backward()
                ws = [ex.arg_dict[n]._data for n in diff_names]
                gs = ex.step_grads(diff_names)
                lr_t = lrs[i] if lr_stacked else lrs
                wd_t = wds[i] if lr_stacked else wds
                _, moms, masters = step_math(ws, gs, moms, masters,
                                             lr_t, wd_t)
                if metric is not None:
                    mc = metric[1](mc, [o._data for o in ex.outputs], sv)
            return moms, masters, mc

        fn = exec_cache.TimedJit(multistep)
        if cache_key is not None:
            exec_cache.put(cache_key, fn)
        return fn

    def run_fused_multistep(self, step, diff_names, scan_names,
                            scan_stacks, moms, masters, lrs, wds,
                            zero=False):
        """Run a make_fused_multistep program on the bound arrays:
        `scan_stacks` {name: (K, ...) tensor}, or None in repeat mode.
        The weights update in place; returns (new_moms, new_masters,
        metric_carry), the carry () without a metric. `zero` as in
        run_fused_train_step."""
        self.fused_dispatches += 1
        with profiler.scope(self._name('fused_multistep')):
            new_moms, new_masters, mcarry = step(
                self, list(diff_names), scan_stacks, moms, masters, lrs,
                wds)
            profiler.synchronize([o._data for o in self.outputs])
        self._stash = None
        return new_moms, new_masters, mcarry

    def warm_fused_multistep(self, step, diff_names, scan_names,
                             scan_stacks, moms, masters, lrs, wds):
        """Run a make_fused_multistep program once on copies of the bound
        weights, aux states, momenta and masters, with the device's
        random stream saved and restored, so that cuDNN and cuBLAS set
        up for its shapes (its first call: exec_cache's build time) and
        no state of the executor or the optimizer changes."""
        device = self._ctx.torch_device
        saved = [(a, a._data) for a in list(self.arg_dict.values()) +
                 list(self.aux_dict.values()) +
                 list(self.grad_dict.values())]
        outputs = self.outputs
        rng = _random.generator(device).get_state()
        try:
            for arr, t in saved:
                arr._data = t.clone()
            step(self, list(diff_names), scan_stacks,
                 [m.clone() for m in moms],
                 [None if m is None else m.clone() for m in masters],
                 lrs, wds)
        finally:
            for arr, t in saved:
                arr._data = t
            self.outputs = outputs
            self._stash = None
            _random.generator(device).set_state(rng)

    # ------------------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return OrderedDict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for params, holders, what in ((arg_params, self.arg_dict,
                                       'arguments'),
                                      (aux_params or {}, self.aux_dict,
                                       'aux states')):
            for k, v in params.items():
                if k in holders:
                    dst = holders[k]
                    # a copy: the optimizer updates the bound
                    # tensors in place, which must not reach the
                    # caller's arrays
                    dst._data = _tensor_of(v, dst._data.dtype,
                                           self._ctx.torch_device,
                                           copy=True)
                elif not allow_extra_params:
                    raise MXNetError('Found name "%s" not in %s' % (k, what))

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_grad_req(grad_req, arg_names):
        if isinstance(grad_req, str):
            return {n: grad_req for n in arg_names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(arg_names, grad_req))
        out = {n: 'null' for n in arg_names}
        out.update(grad_req or {})
        return out

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req='write', type_dict=None,
                     shared_exec=None, shape_kwargs=None, group2ctx=None):
        """The reference simple_bind flow: infer shapes and dtypes,
        allocate the arg, grad and aux arrays, bind."""
        _check_ctx(ctx)
        shape_kwargs = shape_kwargs or {}
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = type_dict or {}
        # parameters downstream of a Cast allocate in the compute dtype
        arg_types, _, aux_types = symbol.infer_type(**type_dict)
        inferred = dict(zip(arg_names, arg_types))
        inferred.update(zip(aux_names, aux_types))
        req = Executor._normalize_grad_req(grad_req, arg_names)

        def alloc(holders, name, shape, dtype):
            a = getattr(shared_exec, holders).get(name) \
                if shared_exec is not None else None
            if a is not None and a.shape == tuple(shape):
                return a
            return nd.zeros(shape, ctx, dtype=dtype)

        arg_dict = OrderedDict()
        grad_dict = {}
        for name, shape in zip(arg_names, arg_shapes):
            dtype = type_dict.get(name, inferred[name])
            arg_dict[name] = alloc('arg_dict', name, shape, dtype)
            if req.get(name, 'null') != 'null':
                grad_dict[name] = alloc('grad_dict', name, shape, dtype)
        aux_dict = OrderedDict()
        for name, shape in zip(aux_names, aux_shapes):
            aux_dict[name] = alloc('aux_dict', name, shape, inferred[name])
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict, req,
                        group2ctx=group2ctx)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad=None, grad_req='write',
              aux_states=None, shared_exec=None, group2ctx=None):
        _check_ctx(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            arg_dict = OrderedDict(zip(arg_names, args))
        else:
            arg_dict = OrderedDict((n, args[n]) for n in arg_names)
        req = Executor._normalize_grad_req(grad_req, arg_names)
        if args_grad is None:
            grad_dict = {n: nd.zeros(arg_dict[n].shape, ctx,
                                     dtype=arg_dict[n].dtype)
                         for n in arg_names if req.get(n, 'null') != 'null'}
        elif isinstance(args_grad, (list, tuple)):
            grad_dict = dict(zip(arg_names, args_grad))
        else:
            grad_dict = dict(args_grad)
        if aux_states is None:
            _, _, aux_shapes = symbol.infer_shape(
                **{n: a.shape for n, a in arg_dict.items()})
            aux_dict = OrderedDict(
                (n, nd.zeros(s, ctx)) for n, s in zip(aux_names, aux_shapes))
        elif isinstance(aux_states, (list, tuple)):
            aux_dict = OrderedDict(zip(aux_names, aux_states))
        else:
            aux_dict = OrderedDict((n, aux_states[n]) for n in aux_names)
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict, req,
                        group2ctx=group2ctx)
