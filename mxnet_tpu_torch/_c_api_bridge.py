"""Python side of the training C API (csrc/capi/c_api_train.cc), the
counterpart of mxnet_tpu/_c_api_bridge.py.

The reference exposes its training surface through C functions (NDArray
create / copy, Symbol compose / infer, Executor bind / forward / backward,
KVStore push / pull) so that a language binding trains with no Python in
the caller. The port's C library embeds CPython and drives the functions
here through a scalar / bytes call surface; each object it hands out
(NDArray, Symbol, Executor, KVStore, updater, data iterator) is an opaque
PyObject* handle on the C side. Every function is a thin adapter over
the port's public API.

Where the port departs from the JAX package: `dev_type` 1 is
cpu(dev_id) and 2 is gpu(dev_id), and any other value raises (the JAX
package maps every value but 1 to its accelerator), as the C predict API
does. An ImageRecordIter created from C with no `ctx` hands out its
batches where its pipeline decodes them: on the host from the native
pipeline, on gpu(0) from the port's (`_image_iter_ctx`);
MXTNDArrayCopyFromNDArray moves a batch onto the executor's device. A
CachedOp runs the symbol's graph walk as one recorded op.
"""
import numpy as np
import torch

from . import autograd as ag
from . import context as ctx_mod
from . import kvstore as kv_mod
from . import ndarray as nd
from . import optimizer as opt_mod
from . import symbol as sym_mod
from .ops import registry as _reg


def _ctx(dev_type, dev_id):
    """The C API's dev_type: 1 is cpu, 2 is gpu (the card)."""
    kinds = {1: ctx_mod.cpu, 2: ctx_mod.gpu}
    if int(dev_type) not in kinds:
        raise ValueError('dev_type %r: 1 (cpu) or 2 (gpu)' % (dev_type,))
    return kinds[int(dev_type)](int(dev_id))


# -- NDArray ----------------------------------------------------------------

def nd_create(shape, dev_type, dev_id):
    return nd.zeros(tuple(int(d) for d in shape), ctx=_ctx(dev_type, dev_id))


def nd_from_bytes(shape, buf, dev_type, dev_id):
    arr = np.frombuffer(buf, dtype='<f4').reshape(
        tuple(int(d) for d in shape))
    return nd.array(arr, ctx=_ctx(dev_type, dev_id), dtype=np.float32)


def nd_to_bytes(arr):
    """The array's values as flat little-endian float32 bytes (a bfloat16
    or float16 array widened)."""
    t = arr._data.detach().to(torch.float32).cpu().contiguous()
    return t.numpy().astype('<f4', copy=False).tobytes()


def nd_copy_from(arr, buf):
    """In-place refill from flat float32 bytes (shape preserved)."""
    arr[:] = np.frombuffer(buf, dtype='<f4').reshape(arr.shape).copy()


def nd_shape(arr):
    return tuple(int(d) for d in arr.shape)


def nd_save(fname, keys, arrays):
    nd.save(fname, dict(zip(keys, arrays)) if keys else list(arrays))


def nd_load(fname):
    """-> (keys, arrays) on the host; keys are '' for list-style files."""
    loaded = nd.load(fname, ctx=ctx_mod.cpu())
    if isinstance(loaded, dict):
        names = list(loaded.keys())
        return names, [loaded[k] for k in names]
    return [''] * len(loaded), list(loaded)


def nd_slice(arr, begin, end):
    begin, end = int(begin), int(end)
    if not 0 <= begin < end <= arr.shape[0]:
        raise ValueError('invalid slice [%d, %d) for axis of length %d'
                         % (begin, end, arr.shape[0]))
    return arr[begin:end]


def nd_reshape(arr, shape):
    return arr.reshape(tuple(int(d) for d in shape))


# -- Symbol -----------------------------------------------------------------

def sym_variable(name):
    return sym_mod.Variable(name)


def sym_create(op_name, name, attr_keys, attr_vals, arg_names, arg_syms):
    """Atomic symbol creation + composition in one call (the reference
    splits this into MXSymbolCreateAtomicSymbol + MXSymbolCompose)."""
    op = getattr(sym_mod, op_name, None)
    if op is None:
        raise ValueError('unknown operator %r' % op_name)
    kwargs = dict(zip(attr_keys, attr_vals))
    for aname, asym in zip(arg_names, arg_syms):
        kwargs[aname] = asym
    if name:
        kwargs['name'] = name
    return op(**kwargs)


def sym_from_json(text):
    return sym_mod.load_json(text)


def sym_to_json(sym):
    return sym.tojson()


def sym_list_arguments(sym):
    return list(sym.list_arguments())


def sym_list_outputs(sym):
    return list(sym.list_outputs())


def sym_list_aux(sym):
    return list(sym.list_auxiliary_states())


def sym_get_internals(sym):
    return sym.get_internals()


def sym_get_output(sym, index):
    return sym[int(index)]


def sym_get_internal_by_name(sym, name):
    return sym.get_internals()[name]


def sym_attr_get(sym, key):
    """-> (present, value); '' value with present=0 means unset."""
    value = sym.attr(key)
    if value is None:
        return 0, ''
    return 1, str(value)


def sym_attr_set(sym, key, value):
    sym._set_attr(**{key: value})


def sym_infer_shape(sym, names, shapes):
    known = {n: tuple(int(d) for d in s) for n, s in zip(names, shapes)}
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**known)
    return (list(arg_shapes or []), list(out_shapes or []),
            list(aux_shapes or []))


# -- Executor ---------------------------------------------------------------

def simple_bind(sym, dev_type, dev_id, grad_req, names, shapes):
    known = {n: tuple(int(d) for d in s) for n, s in zip(names, shapes)}
    return sym.simple_bind(_ctx(dev_type, dev_id), grad_req=grad_req,
                           **known)


def ex_forward(ex, is_train):
    ex.forward(is_train=bool(is_train))


def ex_backward(ex):
    ex.backward()


def ex_num_outputs(ex):
    return len(ex.outputs)


def ex_output(ex, index):
    return ex.outputs[int(index)]


def ex_arg(ex, name):
    return ex.arg_dict[name]


def ex_grad(ex, name):
    grad = ex.grad_dict.get(name)
    if grad is None:
        raise KeyError('no gradient bound for %r' % name)
    return grad


# -- Imperative invoke + autograd -------------------------------------------

def imperative_invoke(op_name, inputs, attr_keys, attr_vals):
    """Run any registered op by name on NDArray inputs (reference
    MXImperativeInvoke, c_api_ndarray.cc:423). Attr values arrive as
    strings, as in symbol composition; ops parse their own attrs. An op
    with no inputs runs on its `ctx` attr, else on the current context.
    -> list of output NDArrays."""
    if not _reg.exists(op_name):
        raise ValueError('unknown operator %r' % op_name)
    out = nd.invoke(op_name, list(inputs), dict(zip(attr_keys, attr_vals)))
    return list(out) if isinstance(out, (list, tuple)) else [out]


def random_seed(seed):
    """Reference MXRandomSeed: seed the global op RNG streams."""
    from . import random as _random
    _random.seed(int(seed))


def wait_all():
    """Reference MXNDArrayWaitAll: block until the card's queued work is
    done. An asynchronous CUDA error surfaces here (C callers get -1)."""
    nd.waitall()


def list_op_names():
    """Every invokable registry name, aliases included (reference
    MXSymbolListAtomicSymbolCreators: the list a binding's codegen walks
    to build its op namespace)."""
    return [str(n) for n in _reg.list_ops()]


def op_registry_generation():
    """The registry's mutation stamp. The C introspection caches
    (MXTListOpNames / MXTOpGetInfo) rebuild when it changes, so an op
    registered at run time appears."""
    return _reg.generation()


def op_info(name):
    """-> flat string list [canonical_name, description, in0, in1, ...]
    (reference MXSymbolGetAtomicSymbolInfo). Input names of ops whose
    arity depends on attrs are resolved with empty attrs, the default
    composition sees."""
    op = _reg.get(name)
    try:
        inputs = [str(i) for i in op.input_names({})]
    except Exception:
        inputs = []
    doc = (getattr(op.fcompute, '__doc__', None) or '').strip()
    return [str(op.name), doc] + inputs


def autograd_set_recording(flag):
    """-> previous state (reference MXAutogradSetIsRecording)."""
    prev = ag.is_recording()
    ag.set_recording(bool(flag))
    return int(prev)


def autograd_set_training(flag):
    prev = ag.is_training()
    ag.set_training(bool(flag))
    return int(prev)


def autograd_mark_variables(variables, grad_reqs):
    ag.mark_variables(list(variables), grad_reqs=list(grad_reqs))


def autograd_backward(heads, retain_graph):
    ag.backward(list(heads), retain_graph=bool(retain_graph))


def nd_get_grad(arr):
    """Gradient buffer attached by mark_variables + backward (reference
    MXNDArrayGetGrad)."""
    if arr._grad is None:
        raise ValueError('array has no gradient: mark it with '
                         'MXTAutogradMarkVariables and run backward first')
    return arr._grad


# -- CachedOp ---------------------------------------------------------------

class _CachedOp(object):
    """Graph replay (reference CachedOp, c_api_ndarray.cc:464): the
    symbol is bound once per input signature (shapes, dtypes, context)
    and each invocation runs the executor's graph walk as ONE op through
    the imperative machinery, so an enclosing recording differentiates
    straight through the cached graph, as the reference's CachedOp under
    MXAutogradBackward. Inputs arrive in list_arguments() +
    list_auxiliary_states() order."""

    def __init__(self, sym):
        self._sym = sym
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()
        self.n_outputs = len(sym.list_outputs())
        self._cache = {}

    def _bound(self, args, ctx):
        key = (str(ctx),) + tuple((tuple(a.shape), str(a.dtype))
                                  for a in args)
        ex = self._cache.get(key)
        if ex is None:
            shapes = {n: tuple(a.shape)
                      for n, a in zip(self.arg_names, args)}
            types = {n: a.dtype for n, a in zip(self.arg_names, args)}
            ex = self._sym.simple_bind(ctx, grad_req='null',
                                       type_dict=types, **shapes)
            self._cache[key] = ex
        return ex

    def invoke(self, inputs):
        n_args = len(self.arg_names)
        n_aux = len(self.aux_names)
        if len(inputs) != n_args + n_aux:
            raise ValueError(
                'CachedOp expects %d inputs (%d args + %d aux), got %d'
                % (n_args + n_aux, n_args, n_aux, len(inputs)))
        args, auxs = list(inputs[:n_args]), list(inputs[n_args:])
        ctx = args[0].context if args else ctx_mod.current_context()
        ex = self._bound(args, ctx)

        def fcompute(attrs, in_data, aux_data, op_ctx):
            outs, new_aux = ex._run_graph(
                list(in_data[:n_args]), list(in_data[n_args:]),
                op_ctx.is_train, rng=op_ctx.rng)
            return list(outs) + list(new_aux), []

        results = nd.invoke_fn(fcompute, args + auxs, name='_cached_op')
        outs = results[:self.n_outputs]
        # write the updated auxiliary state (BatchNorm's moving stats)
        # back into the caller's arrays, as the executor does
        for holder, new in zip(auxs, results[self.n_outputs:]):
            holder._data = new._data.detach()
        return outs


def cached_op_create(sym):
    return _CachedOp(sym)


def cached_op_invoke(op, inputs):
    return op.invoke(list(inputs))


# -- Optimizer --------------------------------------------------------------

def updater_create(opt_name, attr_keys, attr_vals):
    """An updater closure over a fresh optimizer (reference
    MXOptimizerCreateOptimizer + KVStore updater role)."""
    kwargs = {}
    for k, v in zip(attr_keys, attr_vals):
        try:
            kwargs[k] = float(v) if '.' in v or 'e' in v.lower() \
                else int(v)
        except ValueError:
            kwargs[k] = v
    optimizer = opt_mod.create(opt_name, **kwargs)
    return opt_mod.get_updater(optimizer)


def updater_step(updater, index, grad, weight):
    updater(int(index), grad, weight)


# -- DataIter ---------------------------------------------------------------
#
# The reference exposes its data pipeline to every binding through
# MXListDataIters / MXDataIterCreateIter / Next / GetData / GetLabel
# (src/c_api/c_api.cc, the iter block): create by registered name with
# string params.

def _parse_iter_param(value):
    s = str(value).strip()
    low = s.lower()
    if low in ('true', 'false'):
        return low == 'true'
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith('(') and s.endswith(')'):
        items = [x for x in s[1:-1].split(',') if x.strip()]
        return tuple(int(float(x)) for x in items)
    return value


def _parse_ctx(value):
    """A context named as 'cpu(0)' / 'gpu(0)' (or 'cpu' / 'gpu')."""
    s = str(value).strip()
    kind, _, rest = s.partition('(')
    kinds = {'cpu': ctx_mod.cpu, 'gpu': ctx_mod.gpu}
    if kind not in kinds:
        raise ValueError('ctx %r: cpu(n) or gpu(n)' % (value,))
    return kinds[kind](int(rest.rstrip(')') or 0))


def _iter_registry():
    from . import io as io_mod
    # the string-creatable iterators (NDArrayIter needs in-memory
    # arrays, so like the reference it is not in the C create registry)
    return {
        'CSVIter': io_mod.CSVIter,
        'ImageRecordIter': io_mod.ImageRecordIter,
        'MNISTIter': io_mod.MNISTIter,
    }


def list_data_iters():
    return sorted(_iter_registry().keys())


class _CDataIter(object):
    """C-handle wrapper: the iterator plus its current batch, so
    GetData/GetLabel have a stable batch to hand out between Next
    calls (the reference's DataIter::Value() contract)."""

    def __init__(self, it):
        self.it = it
        self.cur = None


def data_iter_create(name, keys, vals):
    registry = _iter_registry()
    if name not in registry:
        raise ValueError('unknown data iter %r (have: %s)'
                         % (name, ', '.join(sorted(registry))))
    kwargs = {k: (_parse_ctx(v) if k == 'ctx' else _parse_iter_param(v))
              for k, v in zip(keys, vals)}
    if name == 'ImageRecordIter' and 'ctx' not in kwargs:
        kwargs['ctx'] = _image_iter_ctx(kwargs.get('use_native'))
    return _CDataIter(registry[name](**kwargs))


def _image_iter_ctx(use_native):
    """Where an ImageRecordIter created from C with no `ctx` puts its
    batches. The native pipeline decodes on the host, so its batches stay
    there, as the reference's DataIter hands them out. The port's pipeline
    decodes on the card: gpu(0), and cpu(0) only in a process with no
    CUDA, where the caller's executor can only be on the host.
    MXTNDArrayCopyFromNDArray moves a batch onto the executor's device."""
    if use_native or not torch.cuda.is_available():
        return ctx_mod.cpu()
    return ctx_mod.gpu()


def data_iter_before_first(handle):
    handle.it.reset()
    handle.cur = None


def data_iter_next(handle):
    try:
        handle.cur = handle.it.next()
    except StopIteration:
        handle.cur = None
        return 0
    return 1


def _current_batch(handle):
    if handle.cur is None:
        raise ValueError('no current batch: call Next first')
    return handle.cur


def data_iter_get_data(handle):
    return _current_batch(handle).data[0]


def data_iter_get_label(handle):
    return _current_batch(handle).label[0]


def data_iter_get_pad(handle):
    return int(_current_batch(handle).pad or 0)


def nd_copy_from_nd(dst, src):
    """dst[:] = src, onto dst's device and dtype (the reference's
    _copyto path): C callers feed executor-bound arrays from iterator
    batches with it."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError('shape mismatch: dst %s vs src %s'
                         % (dst.shape, src.shape))
    src.copyto(dst)


# -- KVStore ----------------------------------------------------------------

def kv_create(kind):
    return kv_mod.create(kind)


def kv_init(kv, key, value):
    kv.init(key, value)


def kv_push(kv, key, value):
    kv.push(key, value)


def kv_pull(kv, key, out):
    kv.pull(key, out=out)
