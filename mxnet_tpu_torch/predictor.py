"""Deployment predictor: load a checkpoint, forward only. The counterpart
of mxnet_tpu/predictor.py (reference src/c_predict_api.cc:
MXPredCreate, MXPredSetInput, MXPredForward, MXPredGetOutput,
MXPredReshape).

`Predictor` takes the checkpoint artifacts Module writes
(prefix-symbol.json and prefix-NNNN.params, or the symbol's JSON and a
param blob), binds a forward-only executor and answers `forward` calls;
`serve` wraps it in the dynamic-batching `serving.InferenceEngine`.

The default device is the card: with no ctx a predictor binds to
`current_context()`, `gpu(0)` unless a `with mx.cpu():` block says
otherwise, and raises when CUDA is absent (the JAX package's default is
`cpu()`).

The deployment artifact. The JAX package lowers the serve forward to
StableHLO; the port's counterpart is a `torch.export` program of the
executor's eval walk (`Executor.serve`'s walk), traced non-strict on
fake tensors. `export_compiled` exports the walk with the weights as
program inputs (weight-independent, so cached per graph signature);
`export_artifact` bakes the weights in as buffers and writes
`<prefix>.pt2` (torch.export.save) and `<prefix>.manifest`, which
`torch.export.load` runs in a process that imports torch alone. A walk
that reads the host inside (`.item()`, `.cpu()`, a shape taken from
data) cannot be traced: the export raises MXNetError naming the op, and
never falls back to a pickled module.
"""
import torch

from . import context as ctx_mod
from . import exec_cache
from . import model as model_mod
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError


def _split_params(loaded):
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, name = k.split(':', 1)
        if tp == 'arg':
            arg_params[name] = v
        elif tp == 'aux':
            aux_params[name] = v
    return arg_params, aux_params


class Predictor(object):
    """Forward-only model server (the reference's MXPredCreate flow)."""

    def __init__(self, symbol_json_or_file=None, param_bytes_or_file=None,
                 input_shapes=None, ctx=None, symbol=None, arg_params=None,
                 aux_params=None, dev_type=None, dev_id=0):
        """From serialized artifacts (the C predict API's contract: the
        symbol's JSON string or file, and a param blob or file) or from
        objects in memory."""
        if symbol is None:
            s = symbol_json_or_file
            if s is None:
                raise MXNetError('need symbol json or symbol')
            if isinstance(s, str) and s.lstrip().startswith('{'):
                symbol = sym_mod.load_json(s)
            else:
                symbol = sym_mod.load(s)
        if arg_params is None and param_bytes_or_file is not None:
            blob = param_bytes_or_file
            # the parameters are read to the host and copied to the bound
            # device by copy_params_from
            if isinstance(blob, (bytes, bytearray)):
                loaded = nd.load_buffer(blob, ctx=ctx_mod.cpu())
            else:
                loaded = nd.load(blob, ctx=ctx_mod.cpu())
            arg_params, aux_params = _split_params(loaded)
        if ctx is None:
            ctx = ctx_mod.current_context() if dev_type is None else \
                ctx_mod.Context(dev_type, dev_id)
        input_shapes = dict(input_shapes or {})
        self._symbol = symbol
        self._ctx = ctx
        self._executor = symbol.simple_bind(ctx, grad_req='null',
                                            **input_shapes)
        self._executor.copy_params_from(arg_params or {}, aux_params or {})
        self._input_names = [n for n in symbol.list_arguments()
                             if n in input_shapes]

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, ctx=None):
        """Load Module.save_checkpoint's artifacts (the reference's
        MXPredCreate on prefix-symbol.json and prefix-NNNN.params)."""
        symbol, arg_params, aux_params = model_mod.load_checkpoint(
            prefix, epoch, ctx=ctx_mod.cpu())
        return cls(symbol=symbol, arg_params=arg_params,
                   aux_params=aux_params, input_shapes=input_shapes,
                   ctx=ctx)

    def set_input(self, name, value):
        """MXPredSetInput."""
        self._executor.arg_dict[name][:] = value

    def forward(self, **inputs):
        """MXPredForward: set the named inputs, run, return the
        outputs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        return self._executor.forward(is_train=False)

    def get_output(self, index=0):
        """MXPredGetOutput."""
        return self._executor.outputs[index]

    def predict(self, data, input_name='data'):
        out = self.forward(**{input_name: data})
        return out[0].asnumpy()

    def reshape(self, input_shapes):
        """MXPredReshape: rebind for new input shapes, sharing the
        weights. A live InferenceEngine over this predictor keeps the
        arrays it was built on: close() and re-create it afterwards."""
        self._executor = self._executor.reshape(**dict(input_shapes))
        self._input_names = [n for n in self._symbol.list_arguments()
                             if n in dict(input_shapes)]
        return self

    def serve(self, **engine_kwargs):
        """This predictor behind a `serving.InferenceEngine`: a dynamic
        batcher over a shape-bucket ladder that coalesces concurrent
        `infer()` calls into padded dispatches. Keyword arguments go to
        InferenceEngine (max_batch, max_wait_us, batch_buckets,
        free_dim_buckets, quantize, ...); the ladder is warmed before this
        returns unless warmup=False."""
        from .serving import InferenceEngine
        return InferenceEngine(self, **engine_kwargs)

    def export_compiled(self, batch_buckets=None):
        """The forward as a `torch.export` program: a dict with
        'program' (the ExportedProgram, whose inputs are every argument
        then every aux state of the executor, in list order) and 'graph'
        (its graph's text). The export takes the weights as inputs, so
        it depends on the graph signature alone and is cached in
        exec_cache under it with an export tag: a repeated export (or
        one of an equally bound predictor) is a cache hit.

        With `batch_buckets` (batch sizes, e.g. a serving engine's
        ladder) it returns {batch: dict}, one export for each rung, each
        cached under its rung's signature; the rung executors share this
        predictor's weight arrays."""
        if batch_buckets is not None:
            out = {}
            for b in sorted(set(int(x) for x in batch_buckets)):
                shapes = {
                    n: (b,) + tuple(self._executor.arg_dict[n].shape[1:])
                    for n in self._input_names}
                ex = self._symbol.simple_bind(
                    self._ctx, grad_req='null',
                    shared_exec=self._executor, **shapes)
                out[b] = self._export_one(ex)
            return out
        return self._export_one(self._executor)

    @staticmethod
    def _export_one(ex):
        key = (ex._sig, 'export_compiled')
        cached = exec_cache.get(key, count=True)
        if cached is not None:
            return dict(cached)
        vals = [ex.arg_dict[n]._data for n in ex._arg_names] + \
            [ex.aux_dict[n]._data for n in ex._aux_names]
        ep = _export(ex, _ServeWalk(ex), tuple(vals))
        out = {'program': ep,
               'graph': ep.graph_module.print_readable(print_output=False)}
        exec_cache.put(key, dict(out))
        return out

    def export_artifact(self, prefix):
        """Write a self-contained deployment artifact: the forward with
        every weight baked in, as `<prefix>.pt2` (torch.export.save; its
        inputs are the data inputs alone, in this predictor's order),
        and `<prefix>.manifest`, one line per data input (`input NAME
        DTYPE DIMS`) and per output (`output I DTYPE DIMS`), the JAX
        package's format. `torch.export.load(prefix + '.pt2').module()`
        runs it in a process that imports torch alone. Returns the
        manifest lines."""
        ex = self._executor
        walk = _ServeWalk(ex, data_names=self._input_names)
        data = tuple(ex.arg_dict[n]._data for n in self._input_names)
        ep = _export(ex, walk, data)
        out_vals = [n.meta['val'] for n in
                    ep.graph.find_nodes(op='output')[0].args[0]]
        manifest = []
        for n, v in zip(self._input_names, data):
            manifest.append('input %s %s %s' % (
                n, _dtype_name(v.dtype), ','.join(str(d) for d in v.shape)))
        for i, o in enumerate(out_vals):
            manifest.append('output %d %s %s' % (
                i, _dtype_name(o.dtype), ','.join(str(d) for d in o.shape)))
        torch.export.save(ep, prefix + '.pt2')
        with open(prefix + '.manifest', 'w') as f:
            f.write('\n'.join(manifest) + '\n')
        return manifest


class _ServeWalk(torch.nn.Module):
    """The executor's eval walk as a module for torch.export. With no
    `data_names` its inputs are every argument then every aux state;
    with them, only those arguments, and the other weights are buffers
    (baked into the export)."""

    def __init__(self, ex, data_names=None):
        super().__init__()
        self._ex = ex
        self._data_pos = None
        if data_names is not None:
            self._data_pos = [ex._arg_names.index(n) for n in data_names]
            for i, n in enumerate(ex._arg_names):
                if i not in self._data_pos:
                    self.register_buffer('arg%d' % i, ex.arg_dict[n]._data)
            for i, n in enumerate(ex._aux_names):
                self.register_buffer('aux%d' % i, ex.aux_dict[n]._data)

    def forward(self, *inputs):
        ex = self._ex
        n_arg = len(ex._arg_names)
        if self._data_pos is None:
            args, auxs = list(inputs[:n_arg]), list(inputs[n_arg:])
        else:
            given = dict(zip(self._data_pos, inputs))
            args = [given[i] if i in given else getattr(self, 'arg%d' % i)
                    for i in range(n_arg)]
            auxs = [getattr(self, 'aux%d' % i)
                    for i in range(len(ex._aux_names))]
        with torch.no_grad():
            outs, _ = ex._run_graph(args, auxs, False)
        return tuple(outs)


def _export(ex, module, inputs):
    """torch.export (non-strict) of the walk; an op that cannot be traced
    raises MXNetError naming it."""
    try:
        return torch.export.export(module, inputs, strict=False)
    except Exception as e:
        node = _walk_node(e, ex)
        where = ' at op %s (%s)' % (node.name, node.op.name) \
            if node is not None else ''
        raise MXNetError('export: the serve walk cannot be traced%s: '
                         '%s: %s' % (where, type(e).__name__, e)) from e


def _walk_node(exc, ex):
    """The graph node the walk was at when `exc` (or an exception it was
    raised from) left Executor._walk, the loop of Executor._run_graph."""
    code = type(ex)._walk.__code__
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        node = None
        tb = exc.__traceback__
        while tb is not None:
            if tb.tb_frame.f_code is code:
                node = tb.tb_frame.f_locals.get('node')
            tb = tb.tb_next
        if node is not None:
            return node
        exc = exc.__cause__ or exc.__context__
    return None


def _dtype_name(dtype):
    """numpy's name of a torch dtype ('float32', 'bfloat16', ...)."""
    return str(dtype).replace('torch.', '')


def _load_param_bytes(blob):
    """Param blob bytes -> {name: NDArray} on the host (the C predict
    API's MXTNDListCreate takes the .params bytes)."""
    return nd.load_buffer(bytes(blob), ctx=ctx_mod.cpu())
