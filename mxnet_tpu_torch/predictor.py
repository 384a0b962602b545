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
`cpu()`). `export_compiled` and `export_artifact`, which lower the
forward to StableHLO in the JAX package, have no counterpart yet.
"""
from . import context as ctx_mod
from . import model as model_mod
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError, unported


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
        raise unported('Predictor.export_compiled (the JAX package lowers '
                       'the forward to StableHLO; the port\'s deployment '
                       'artifact)', '3')

    def export_artifact(self, prefix):
        raise unported('Predictor.export_artifact (a self-contained '
                       'StableHLO artifact in the JAX package; the '
                       'port\'s deployment artifact)', '3')
