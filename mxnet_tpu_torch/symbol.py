"""Symbol: the symbolic graph API, the counterpart of mxnet_tpu/symbol.py
(reference python/mxnet/symbol.py and nnvm::Symbol).

A Symbol is a set of output entries of a DAG of nodes; operator nodes
reference the op registry the imperative API uses, so symbolic and
imperative execution share one compute definition. `bind` and
`simple_bind` give an `executor.Executor`, which walks the DAG on torch
tensors and differentiates it with torch autograd. Shape inference is
bidirectional over partial shapes (nnvm InferShape); dtype inference
(InferType) is what allocates a mixed-precision graph's parameters in
its compute dtype. The JSON of `tojson`/`load_json` is the JAX
package's, string for string: a graph built in either package loads in
the other.

Dtypes are torch dtypes inside; `infer_type` answers as the JAX
package's does, with `np.dtype` objects, and torch.bfloat16 for
bfloat16 (numpy has no bfloat16 of its own).
"""
import hashlib
import json
import sys
import threading
from collections import OrderedDict

from . import attribute
import numpy as np

from .base import (MXNetError, current_name_manager, attr_value, dtype_name,
                   parse_attr_value, torch_dtype)
from .ops import registry as _reg

_py_slice = slice


# bumped by _set_attr on ANY symbol: shape-inference caches include it
# so attr edits through one handle invalidate caches on every handle
# sharing the nodes
_ATTR_EPOCH = 0

# complete shape inferences by the graph JSON's hash and the known shapes,
# process-wide: a symbol loaded again from a checkpoint (another object,
# the same graph) binds without inferring its shapes again (a serving
# registry's re-warm binds one executor per ladder rung)
_JSON_SHAPES = OrderedDict()
_JSON_SHAPES_MAX = 256
_JSON_SHAPES_LOCK = threading.Lock()


def _np_dtype(t):
    """np.dtype of the torch dtype `t`, or torch.bfloat16 itself."""
    name = dtype_name(t)
    return t if name == 'bfloat16' else np.dtype(name)


class _Node:
    """One graph node: an operator application or a variable (op=None)."""
    __slots__ = ('op', 'name', 'attrs', 'inputs', 'user_attrs')

    def __init__(self, op, name, attrs, inputs, user_attrs=None):
        self.op = op              # OpDef or None for variables
        self.name = name
        self.attrs = attrs        # dict of python values (op hyperparams)
        self.inputs = inputs      # list of (node, out_index)
        self.user_attrs = user_attrs or {}

    def num_outputs(self):
        return 1 if self.op is None else self.op.num_outputs(self.attrs)


class Symbol:
    """A set of (node, output_index) entries."""
    __slots__ = ('_outputs', '_shape_infer_cache')

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (node, int)
        self._shape_infer_cache = None

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _topo(self):
        """Topological order of all reachable nodes (inputs first)."""
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for src, _ in reversed(node.inputs):
                if id(src) not in seen:
                    stack.append((src, False))
        return order

    def list_arguments(self):
        out = []
        for node in self._topo():
            if node.op is None and not node.user_attrs.get('__is_aux__'):
                out.append(node.name)
        return out

    def list_auxiliary_states(self):
        out = []
        for node in self._topo():
            if node.op is None and node.user_attrs.get('__is_aux__'):
                out.append(node.name)
        return out

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.op is None:
                names.append(node.name)
            else:
                onames = node.op.output_names(node.attrs)
                names.append('%s_%s' % (node.name, onames[idx]))
        return names

    def get_internals(self):
        """Symbol grouping every internal output (reference
        symbol.py get_internals)."""
        entries = []
        for node in self._topo():
            for i in range(node.num_outputs()):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self):
        nodes = []
        for node, _ in self._outputs:
            nodes.extend(node.inputs)
        if not nodes:
            return None
        return Symbol(nodes)

    def __getitem__(self, index):
        if isinstance(index, _py_slice):
            return Symbol(self._outputs[index])
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError('cannot find output %s' % index)
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    def __repr__(self):
        name = self.name
        return '<Symbol %s>' % (name if name else 'Grouped')

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        if len(self._outputs) == 1:
            return self._outputs[0][0].user_attrs.get(key)
        return None

    def attr_dict(self):
        out = {}
        for node in self._topo():
            # include __lr_mult__/__wd_mult__/__init__ etc. — the optimizer
            # and Module.init_params read them from here (reference
            # symbol.py attr_dict exposes all attrs)
            attrs = dict(node.user_attrs)
            attrs.pop('__is_aux__', None)
            if node.op is not None:
                attrs.update({k: attr_value(v) for k, v in node.attrs.items()})
            if attrs:
                out[node.name] = attrs
        return out

    def _set_attr(self, **kwargs):
        global _ATTR_EPOCH
        for node, _ in self._outputs:
            node.user_attrs.update({k: str(v) for k, v in kwargs.items()})
        # attr changes can carry shape hints and nodes are shared across
        # Symbol handles (get_internals), so bump the global epoch that
        # every handle's inference cache is validated against
        _ATTR_EPOCH += 1

    # -- shape / type inference (nnvm InferShape/InferType passes) --------
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self._infer_shape_impl(
            False, *args, **kwargs)
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, s in zip(arg_names, args):
                if s is not None:
                    known[name] = tuple(s)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        from .ops.registry import shape_is_complete
        shapes, out_shapes = self._run_shape_inference(known, partial)
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        if not partial and any(not shape_is_complete(s)
                               for s in arg_shapes):
            missing = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if not shape_is_complete(s)]
            raise MXNetError('infer_shape: cannot fully infer shapes of '
                             'arguments %s' % missing)
        return arg_shapes, out_shapes, aux_shapes

    def _run_shape_inference(self, var_shapes, partial=False,
                             want_entries=False):
        """Fixed-point bidirectional shape inference over the DAG
        (nnvm InferShape semantics): shapes are partial, a 0 dimension
        meaning unknown, and each round sweeps the topo order forward
        then backward, merging what every op can deduce about its inputs
        and outputs, until nothing changes."""
        from .ops.registry import merge_shape, shape_is_complete
        cache_key = (tuple(sorted((k, tuple(v))
                                  for k, v in var_shapes.items())),
                     _ATTR_EPOCH)
        cached = getattr(self, '_shape_infer_cache', None)
        if cached is not None and cached[0] == cache_key:
            var_out, outs, entry_shape = cached[2]
            if not partial and any(not shape_is_complete(o)
                                   for o in outs):
                raise MXNetError('infer_shape: output shapes could not '
                                 'be inferred (missing input shapes?)')
            if want_entries:
                return dict(var_out), list(outs), dict(entry_shape)
            return dict(var_out), list(outs)
        json_key = None
        if not want_entries:
            json_key = (hashlib.blake2b(self.tojson().encode(),
                                        digest_size=20).digest(),
                        cache_key[0])
            with _JSON_SHAPES_LOCK:
                hit = _JSON_SHAPES.get(json_key)
                if hit is not None:
                    _JSON_SHAPES.move_to_end(json_key)
            if hit is not None:
                return dict(hit[0]), list(hit[1])
        topo = self._topo()
        entry_shape = {}   # (id(node), idx) -> partial shape
        var_shapes = dict(var_shapes)
        last_sig = {}      # id(node) -> in/out shapes at last infer call

        def update(key, s):
            """Merge new info into an entry; conflicts keep the old
            value (additive propagation).  Returns True if changed."""
            if s is None:
                return False
            old = entry_shape.get(key)
            merged = merge_shape(old, s)
            if merged is None or merged == old:
                return False
            entry_shape[key] = merged
            return True

        def visit(node):
            changed = False
            if node.op is None:
                s = var_shapes.get(node.name)
                if s is None and '__shape__' in node.user_attrs:
                    # honor Variable(shape=...) hints (reference
                    # symbol.py var(shape=...))
                    s = tuple(parse_attr_value(
                        node.user_attrs['__shape__']))
                    var_shapes[node.name] = s
                if update((id(node), 0), s):
                    changed = True
                    var_shapes[node.name] = entry_shape[(id(node), 0)]
                return changed
            in_shapes = [entry_shape.get((id(src), i))
                         for src, i in node.inputs]
            n_out = node.op.num_outputs(node.attrs)
            cur_outs = [entry_shape.get((id(node), i))
                        for i in range(n_out)]
            sig = (tuple(in_shapes), tuple(cur_outs))
            if last_sig.get(id(node)) == sig:
                # nothing new since the last infer call for this node:
                # skip the (meta-tensor) per-op inference
                return False
            last_sig[id(node)] = sig
            try:
                in_shapes, out_shapes = node.op.infer_shape(
                    node.attrs, in_shapes, out_shapes=cur_outs)
            except Exception as e:
                raise MXNetError(
                    'Error in operator %s: shape inference failed: %s'
                    % (node.name, e)) from e
            # back-fill inferred input (incl. parameter) shapes
            for (src, i), s in zip(node.inputs, in_shapes):
                if update((id(src), i), s):
                    changed = True
                    if src.op is None:
                        var_shapes[src.name] = entry_shape[(id(src), i)]
            for i, s in enumerate(out_shapes or []):
                if update((id(node), i), s):
                    changed = True
            return changed

        for _ in range(8):  # fixed-point: forward sweep + backward sweep
            changed = False
            for node in topo:
                changed |= visit(node)
            for node in reversed(topo):
                changed |= visit(node)
            if not changed:
                break
        outs = [entry_shape.get((id(n), i)) for n, i in self._outputs]
        if not partial and any(not shape_is_complete(o) for o in outs):
            raise MXNetError('infer_shape: output shapes could not be '
                             'inferred (missing input shapes?)')
        # memoize: bind re-runs inference with the same known shapes
        # (simple_bind then Executor._infer_node_shapes)
        self._shape_infer_cache = (cache_key, partial,
                                   (dict(var_shapes), list(outs),
                                    dict(entry_shape)))
        if json_key is not None and not partial:
            with _JSON_SHAPES_LOCK:
                _JSON_SHAPES[json_key] = (dict(var_shapes), list(outs))
                while len(_JSON_SHAPES) > _JSON_SHAPES_MAX:
                    _JSON_SHAPES.popitem(last=False)
        if want_entries:
            return var_shapes, outs, entry_shape
        return var_shapes, outs

    def _infer_node_shapes(self, var_shapes):
        """Per-node resolved output shapes, {id(node): [shape, ...]}: the
        executor passes them to shape-carrying init ops (zeros(shape=(0,
        H)))."""
        _, _, entries = self._run_shape_inference(
            var_shapes, partial=True, want_entries=True)
        out = {}
        for node in self._topo():
            if node.op is None:
                continue
            n = node.op.num_outputs(node.attrs)
            out[id(node)] = [entries.get((id(node), i)) for i in range(n)]
        return out

    def infer_type(self, *args, **kwargs):
        """Forward dtype inference over the DAG by each op's
        infer_dtype (the nnvm InferType pass): a graph with a Cast to
        bfloat16 allocates the parameters after it in bfloat16. Returns
        (arg_types, out_types, aux_types) as NDArray.dtype gives dtypes;
        float32 where nothing is known."""
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, t in zip(arg_names, args):
                if t is not None:
                    known[name] = torch_dtype(t)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = torch_dtype(v)
        default = torch_dtype('float32')
        topo = self._topo()
        entry_type = {}
        for _ in range(3):
            changed = False
            for node in topo:
                if node.op is None:
                    t = known.get(node.name)
                    if t is not None and \
                            entry_type.get((id(node), 0)) != t:
                        entry_type[(id(node), 0)] = t
                        changed = True
                    continue
                in_types = [entry_type.get((id(src), i))
                            for src, i in node.inputs]
                try:
                    in_types, out_types = node.op.infer_dtype(
                        node.attrs, in_types)
                except Exception:
                    continue
                for (src, i), t in zip(node.inputs, in_types):
                    if t is not None and \
                            entry_type.get((id(src), i)) is None:
                        entry_type[(id(src), i)] = torch_dtype(t)
                        if src.op is None:
                            known.setdefault(src.name, torch_dtype(t))
                        changed = True
                if out_types is not None:
                    for i, t in enumerate(out_types):
                        if t is not None and \
                                entry_type.get((id(node), i)) != \
                                torch_dtype(t):
                            entry_type[(id(node), i)] = torch_dtype(t)
                            changed = True
            if not changed:
                break
        arg_types = [known.get(n, default) for n in arg_names]
        aux_types = [known.get(n, default)
                     for n in self.list_auxiliary_states()]
        out_types = [entry_type.get((id(n), i), default)
                     for n, i in self._outputs]
        return ([_np_dtype(t) for t in arg_types],
                [_np_dtype(t) for t in out_types],
                [_np_dtype(t) for t in aux_types])

    # -- serialization (nnvm JSON layout) ---------------------------------
    def tojson(self):
        topo = self._topo()
        node_ids = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        arg_nodes = []
        for i, node in enumerate(topo):
            if node.op is None:
                arg_nodes.append(i)
            entry = {
                'op': 'null' if node.op is None else node.op.name,
                'name': node.name,
                'inputs': [[node_ids[id(src)], idx, 0]
                           for src, idx in node.inputs],
            }
            attrs = {k: attr_value(v) for k, v in node.attrs.items()} \
                if node.op is not None else {}
            uattrs = {k: v for k, v in node.user_attrs.items()}
            if attrs:
                entry['attrs'] = attrs
            if uattrs:
                entry['user_attrs'] = uattrs
            nodes.append(entry)
        heads = [[node_ids[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({'nodes': nodes, 'arg_nodes': arg_nodes,
                           'heads': heads,
                           'attrs': {'mxnet_tpu_version': '0.1.0'}},
                          indent=2)

    def save(self, fname):
        from .base import atomic_file
        with atomic_file(fname, mode='w') as f:
            f.write(self.tojson())

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx, grad_req='write', type_dict=None,
                    shared_exec=None, shared_data_arrays=None,
                    group2ctx=None, **kwargs):
        from .executor import Executor
        return Executor._simple_bind(self, ctx, grad_req=grad_req,
                                     type_dict=type_dict,
                                     shared_exec=shared_exec,
                                     group2ctx=group2ctx,
                                     shape_kwargs=kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req='write',
             aux_states=None, shared_exec=None, group2ctx=None):
        from .executor import Executor
        return Executor._bind(self, ctx, args, args_grad=args_grad,
                              grad_req=grad_req, aux_states=aux_states,
                              group2ctx=group2ctx,
                              shared_exec=shared_exec)

    def eval(self, ctx=None, **kwargs):
        from .context import current_context
        ctx = ctx or current_context()
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    def grad(self, wrt):  # pragma: no cover - legacy API
        raise NotImplementedError('use bind().backward instead')

    # -- arithmetic (reference symbol.py operator overloads) --------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _invoke_op(op, {'lhs': lhs, 'rhs': rhs}, {}, None)
        if isinstance(other, (int, float)):
            return _invoke_op(scalar_op, {'data': self},
                              {'scalar': float(other)}, None)
        raise TypeError('unsupported operand type %s' % type(other))

    def __add__(self, other):
        return self._binop(other, 'elemwise_add', '_plus_scalar')

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, 'elemwise_sub', '_minus_scalar')

    def __rsub__(self, other):
        if isinstance(other, (int, float)):
            return _invoke_op('_rminus_scalar', {'data': self},
                              {'scalar': float(other)}, None)
        return self._binop(other, 'elemwise_sub', '_minus_scalar', True)

    def __mul__(self, other):
        return self._binop(other, 'elemwise_mul', '_mul_scalar')

    __rmul__ = __mul__

    def __div__(self, other):
        return self._binop(other, 'elemwise_div', '_div_scalar')

    __truediv__ = __div__

    def __rdiv__(self, other):
        if isinstance(other, (int, float)):
            return _invoke_op('_rdiv_scalar', {'data': self},
                              {'scalar': float(other)}, None)
        return self._binop(other, 'elemwise_div', '_div_scalar', True)

    __rtruediv__ = __rdiv__

    def __pow__(self, other):
        return self._binop(other, '_power', '_power_scalar')

    def __neg__(self):
        return _invoke_op('negative', {'data': self}, {}, None)

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a variable symbol (reference symbol.py:var)."""
    user_attrs = attribute.current().get(attr or {})
    if shape is not None:
        user_attrs['__shape__'] = str(tuple(shape))
    if lr_mult is not None:
        user_attrs['__lr_mult__'] = str(lr_mult)
    if wd_mult is not None:
        user_attrs['__wd_mult__'] = str(wd_mult)
    if dtype is not None:
        user_attrs['__dtype__'] = dtype_name(dtype)
    if init is not None:
        user_attrs['__init__'] = init if isinstance(init, str) else \
            init.dumps()
    for k, v in kwargs.items():
        user_attrs[k] = str(v)
    node = _Node(None, name, {}, [], user_attrs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def _invoke_op(op_name, sym_kwargs, attrs, name, aux_syms=None):
    """Create an operator node (the compose step of reference
    symbol.py:_make_atomic_symbol_function)."""
    op = _reg.get(op_name)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    name = current_name_manager().get(name, op.hint)
    input_names = op.input_names(attrs)
    arg_names = op.arg_names(attrs)
    aux_names = op.aux_names(attrs)
    inputs = []
    user_attrs = attribute.current().get({})
    for in_name in input_names:
        is_aux = in_name in aux_names
        if in_name in sym_kwargs:
            s = sym_kwargs[in_name]
            if len(s._outputs) != 1:
                raise MXNetError('input %s must have a single output'
                                 % in_name)
            entry = s._outputs[0]
            if is_aux and entry[0].op is None:
                entry[0].user_attrs['__is_aux__'] = True
            inputs.append(entry)
        else:
            # auto-create missing parameter/aux variables: name_weight etc.
            vattrs = dict(user_attrs)
            if is_aux:
                vattrs['__is_aux__'] = True
            node = _Node(None, '%s_%s' % (name, in_name), {}, [], vattrs)
            inputs.append((node, 0))
    node = _Node(op, name, attrs, inputs, dict(user_attrs))
    n_out = node.num_outputs()
    sym = Symbol([(node, i) for i in range(n_out)])
    return sym


def load_json(json_str):
    """Rebuild a Symbol from tojson output."""
    data = json.loads(json_str)
    nodes_meta = data['nodes']
    built = []
    for meta in nodes_meta:
        if meta['op'] == 'null':
            node = _Node(None, meta['name'], {}, [],
                         dict(meta.get('user_attrs', {})))
        else:
            op = _reg.get(meta['op'])
            attrs = {k: parse_attr_value(v)
                     for k, v in meta.get('attrs', {}).items()}
            inputs = [(built[i], idx) for i, idx, _ in meta['inputs']]
            node = _Node(op, meta['name'], attrs, inputs,
                         dict(meta.get('user_attrs', {})))
        built.append(node)
    heads = [(built[i], idx) for i, idx, _ in data['heads']]
    return Symbol(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def zeros(shape, dtype=None, **kwargs):
    return _invoke_op('_zeros', {}, {'shape': tuple(shape) if not
                      isinstance(shape, int) else (shape,),
                      'dtype': dtype}, kwargs.get('name'))


def ones(shape, dtype=None, **kwargs):
    return _invoke_op('_ones', {}, {'shape': tuple(shape) if not
                      isinstance(shape, int) else (shape,),
                      'dtype': dtype}, kwargs.get('name'))


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return _invoke_op('_arange', {}, {'start': start, 'stop': stop,
                      'step': step, 'repeat': repeat, 'dtype': dtype},
                      kwargs.get('name'))


# ---------------------------------------------------------------------------
# Operator codegen: mirror of _init_symbol_module (reference symbol.py:2352)
# ---------------------------------------------------------------------------

def _make_sym_func(op_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        name = kwargs.pop('name', None)
        attr = kwargs.pop('attr', None)
        sym_kwargs = {}
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                attrs[k] = v
        pos = [a for a in args if isinstance(a, Symbol)]
        extra = [a for a in args if not isinstance(a, Symbol)]
        if extra:
            raise TypeError(
                'Operator %s: positional arguments must be Symbols; pass '
                'attributes as keywords (got %r)' % (op_name, extra))
        # variadic ops (Concat, add_n, ...): infer num_args from call site
        if len(pos) > 1 and callable(op._input_names):
            attrs.setdefault('num_args', len(pos) + len(sym_kwargs))
        input_names = op.input_names(attrs)
        free = [n for n in input_names if n not in sym_kwargs]
        if len(pos) > len(free):
            raise TypeError('Operator %s: too many positional inputs '
                            '(%d given, %d expected)' %
                            (op_name, len(pos), len(free)))
        for s, n in zip(pos, free):
            sym_kwargs[n] = s
        if attr:
            with attribute.AttrScope(**attr):
                return _invoke_op(op_name, sym_kwargs, attrs, name)
        return _invoke_op(op_name, sym_kwargs, attrs, name)

    fn.__name__ = op_name
    fn.__doc__ = 'Auto-generated symbol constructor for operator %s.' % op_name
    return fn


def _init_module():
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        if hasattr(mod, name):
            continue
        setattr(mod, name, _make_sym_func(name))


_init_module()


def __getattr__(name):
    """Late-registered ops (e.g. `Custom`) resolve on first access."""
    if _reg.exists(name):
        fn = _make_sym_func(name)
        setattr(sys.modules[__name__], name, fn)
        return fn
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
