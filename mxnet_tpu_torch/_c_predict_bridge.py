"""Python side of the C predict API (csrc/capi/c_predict_api.cc), the
counterpart of mxnet_tpu/_c_predict_bridge.py.

The C library hosts an embedded CPython interpreter and drives the
port's `predictor.Predictor` through this module's small call surface.
Every function takes and returns C-marshalable values only (str, bytes,
int, tuples); the C side holds nothing of the framework but an opaque
PyObject* handle.

Where the port departs from the JAX package: `dev_type` 1 is cpu(dev_id)
and 2 is gpu(dev_id), and any other value raises (the JAX package maps
an unknown value to its CPU). A gpu predictor on a host without CUDA
raises at create; it never runs on the CPU in its place.
"""
import numpy as np


def create(symbol_json, param_blob, dev_type, dev_id, input_keys,
           input_shapes, output_keys=None):
    """MXTPredCreate(PartialOut): build a forward-only predictor.

    input_keys: list of input names; input_shapes: matching list of
    int tuples.  output_keys: optional subset of internal node names to
    expose instead of the symbol heads (reference
    MXPredCreatePartialOut).
    """
    from . import predictor as pred_mod
    from . import symbol as sym_mod

    shapes = {k: tuple(int(d) for d in s)
              for k, s in zip(input_keys, input_shapes)}
    dev = _dev_name(dev_type)
    if output_keys:
        symbol = sym_mod.load_json(symbol_json)
        internals = symbol.get_internals()
        heads = [internals[k if k.endswith('_output') else k + '_output']
                 for k in output_keys]
        symbol = sym_mod.Group(heads)
        p = pred_mod.Predictor(symbol=symbol,
                               param_bytes_or_file=bytes(param_blob),
                               input_shapes=shapes,
                               dev_type=dev, dev_id=dev_id)
    else:
        p = pred_mod.Predictor(symbol_json_or_file=symbol_json,
                               param_bytes_or_file=bytes(param_blob),
                               input_shapes=shapes,
                               dev_type=dev, dev_id=dev_id)
    return p


def _dev_name(dev_type):
    """The C predict API's dev_type: 1 is cpu, 2 is gpu (the card)."""
    names = {1: 'cpu', 2: 'gpu'}
    if int(dev_type) not in names:
        raise ValueError('dev_type %r: 1 (cpu) or 2 (gpu)' % (dev_type,))
    return names[int(dev_type)]


def set_input(pred, key, buf):
    """MXTPredSetInput: flat float32 little-endian bytes, reshaped to
    the input's bound shape.  Only declared input nodes are writable —
    the reference MXPredSetInput likewise refuses weight names."""
    if key not in pred._input_names:
        raise ValueError(
            '%r is not an input of this predictor (inputs: %s)'
            % (key, sorted(pred._input_names)))
    arr = pred._executor.arg_dict[key]
    data = np.frombuffer(buf, dtype='<f4').copy()
    if data.size != int(np.prod(arr.shape)):
        raise ValueError(
            'input %s expects %d floats, got %d'
            % (key, int(np.prod(arr.shape)), data.size))
    pred.set_input(key, data.reshape(arr.shape))


def forward(pred):
    pred._executor.forward(is_train=False)


def partial_forward(pred, step):
    """MXTPredPartialForward: returns op nodes still to run."""
    return int(pred._executor.partial_forward(step=step, is_train=False))


def num_outputs(pred):
    return len(pred._executor.outputs) if pred._executor.outputs \
        else len(pred._symbol.list_outputs())


def get_output_shape(pred, index):
    ex = pred._executor
    if ex.outputs:
        return tuple(int(d) for d in ex.outputs[int(index)].shape)
    # before the first forward: inferred from the bound input shapes
    shapes = {n: tuple(a.shape) for n, a in ex.arg_dict.items()}
    _, out_shapes, _ = pred._symbol.infer_shape(**{
        n: shapes[n] for n in pred._input_names})
    return tuple(int(d) for d in out_shapes[int(index)])


def get_output(pred, index):
    """Flat float32 little-endian bytes of output `index`."""
    out = pred.get_output(int(index)).asnumpy()
    return np.ascontiguousarray(out, dtype='<f4').tobytes()


def reshape(pred, input_keys, input_shapes):
    shapes = {k: tuple(int(d) for d in s)
              for k, s in zip(input_keys, input_shapes)}
    pred.reshape(shapes)


def ndlist_create(blob):
    """MXTNDListCreate: parse an NDArray-dict blob (the .params
    format) into [(name, shape_tuple, float32_bytes), ...]."""
    from . import predictor as pred_mod
    loaded = pred_mod._load_param_bytes(bytes(blob))
    out = []
    for name, arr in loaded.items():
        a = np.ascontiguousarray(arr.asnumpy(), dtype='<f4')
        out.append((name, tuple(int(d) for d in a.shape), a.tobytes()))
    return out


def last_version():
    """Smoke hook for the embed path."""
    from . import __version__
    return str(__version__)
