"""Testing oracles, numeric-gradient and cross-context conformance checks:
the counterpart of mxnet_tpu/test_utils.py (reference
python/mxnet/test_utils.py). numpy is the forward oracle, central finite
differences the backward oracle, and `check_consistency` cross-checks
the same symbol across contexts and dtypes (the reference's cpu / gpu /
fp16 matrix; here cpu / gpu / bfloat16, the bfloat16 inputs cast on the
device, since the host may have no ml_dtypes).
"""
import os

import numpy as np

from .base import torch_dtype
from .context import Context, cpu, current_context
from . import ndarray as nd
from . import symbol as sym  # noqa: F401  (re-exported for test modules)


def default_context():
    """Context under test; switch with env MXNET_TEST_DEVICE=gpu
    (reference: test_utils.py:47 default_context / MXNET_TEST_DEVICE)."""
    dev = os.environ.get('MXNET_TEST_DEVICE')
    if dev:
        name, _, idx = dev.partition(':')
        return Context(name, int(idx or 0))
    return current_context()


def default_dtype():
    return np.float32


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim).tolist())


def rand_shape_2d(dim0=10, dim1=10):
    return rand_shape_nd(2, max(dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return rand_shape_nd(3, max(dim0, dim1, dim2))


def random_arrays(*shapes):
    """Random float32 numpy arrays for the given shapes."""
    arrays = [np.random.randn(*s).astype(default_dtype())
              if isinstance(s, (list, tuple)) and len(s)
              else np.array(np.random.randn(), dtype=default_dtype())
              for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def rand_ndarray(shape, ctx=None, dtype=None):
    return nd.array(np.random.uniform(-1.0, 1.0, size=shape).astype(
        dtype or default_dtype()), ctx=ctx or default_context())


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def find_max_violation(a, b, rtol, atol):
    diff = np.abs(a - b) - atol - rtol * np.abs(b)
    idx = np.unravel_index(np.argmax(diff), diff.shape)
    rel = np.abs(a[idx] - b[idx]) / (np.abs(b[idx]) + atol)
    return idx, rel


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=('a', 'b')):
    """Relative+absolute closeness with a max-violation error message
    (reference test_utils.py:148)."""
    a = np.asarray(a.asnumpy() if isinstance(a, nd.NDArray) else a)
    b = np.asarray(b.asnumpy() if isinstance(b, nd.NDArray) else b)
    if almost_equal(a, b, rtol, atol):
        return
    idx, rel = find_max_violation(a, b, rtol, atol)
    raise AssertionError(
        'Error %f exceeds tolerance rtol=%e, atol=%e at position %s: '
        '%s=%s, %s=%s' % (rel, rtol, atol, str(idx),
                          names[0], str(a[idx]), names[1], str(b[idx])))


def simple_forward(symbol, ctx=None, is_train=False, **inputs):
    """Bind + forward in one call; returns numpy output(s)
    (reference test_utils.py simple_forward)."""
    ctx = ctx or default_context()
    inputs = {k: nd.array(v, ctx=ctx) for k, v in inputs.items()}
    ex = symbol.bind(ctx, inputs, grad_req='null')
    outputs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    if len(outputs) == 1:
        return outputs[0]
    return outputs


def _parse_location(symbol, location, ctx):
    """location: dict name->array or list in list_arguments() order."""
    if isinstance(location, dict):
        bad = set(location) - set(symbol.list_arguments())
        if bad:
            raise ValueError('Symbol arguments %s not found in %s'
                             % (sorted(bad), symbol.list_arguments()))
        loc = location
    else:
        loc = dict(zip(symbol.list_arguments(), location))
    return {k: v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx)
            for k, v in loc.items()}


def _parse_aux_states(symbol, aux_states, ctx):
    if aux_states is None:
        return {}
    if not isinstance(aux_states, dict):
        aux_states = dict(zip(symbol.list_auxiliary_states(), aux_states))
    return {k: v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx)
            for k, v in aux_states.items()}


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central finite differences of sum(outputs) w.r.t. each location
    entry (reference test_utils.py numeric_grad)."""
    grads = {}
    for name, arr in location.items():
        base = arr.asnumpy().astype(np.float64)
        grad = np.zeros_like(base)
        flat = base.ravel()
        gflat = grad.ravel()
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            executor.forward(is_train=use_forward_train,
                             **{name: nd.array(base.astype(np.float32),
                                               ctx=arr.context)})
            f_pos = sum(float(o.asnumpy().astype(np.float64).sum())
                        for o in executor.outputs)
            flat[i] = orig - eps
            executor.forward(is_train=use_forward_train,
                             **{name: nd.array(base.astype(np.float32),
                                               ctx=arr.context)})
            f_neg = sum(float(o.asnumpy().astype(np.float64).sum())
                        for o in executor.outputs)
            flat[i] = orig
            gflat[i] = (f_pos - f_neg) / (2 * eps)
        # restore
        executor.forward(is_train=use_forward_train,
                         **{name: nd.array(base.astype(np.float32),
                                           ctx=arr.context)})
        grads[name] = grad
    return grads


def check_numeric_gradient(symbol, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, use_forward_train=True,
                           ctx=None):
    """Verify symbolic backward against central finite differences
    (reference test_utils.py:439 check_numeric_gradient).

    The comparison target is d(sum(outputs))/d(input), i.e. backward with
    all-ones head gradients.
    """
    ctx = ctx or default_context()
    location = _parse_location(symbol, location, ctx)
    aux = _parse_aux_states(symbol, aux_states, ctx)
    args = symbol.list_arguments()
    if grad_nodes is None:
        grad_nodes = [k for k in args if k in location]
    grad_req = {k: ('write' if k in grad_nodes else 'null') for k in args}

    ex = symbol.bind(ctx, dict(location), args_grad={
        k: nd.zeros_like(location[k]) for k in grad_nodes},
        grad_req=grad_req, aux_states=dict(aux) if aux else None)
    ex.forward(is_train=use_forward_train)
    out_grads = [nd.ones(o.shape, ctx=ctx) for o in ex.outputs]
    ex.backward(out_grads)
    sym_grads = {k: ex.grad_dict[k].asnumpy() for k in grad_nodes}

    # fresh executor for the finite-difference probe (no grads needed)
    fd_ex = symbol.bind(ctx, dict(location), grad_req='null',
                        aux_states=dict(aux) if aux else None)
    num_grads = numeric_grad(fd_ex, {k: location[k] for k in grad_nodes},
                             aux, eps=numeric_eps,
                             use_forward_train=use_forward_train)
    for name in grad_nodes:
        assert_almost_equal(num_grads[name], sym_grads[name], rtol=rtol,
                            atol=atol if atol is not None else rtol * 0.1,
                            names=('NUMERICAL_%s' % name,
                                   'BACKWARD_%s' % name))


def check_symbolic_forward(symbol, location, expected, rtol=1e-5,
                           atol=None, aux_states=None, ctx=None,
                           is_train=False):
    """Compare executor forward against numpy reference outputs
    (reference test_utils.py:552)."""
    ctx = ctx or default_context()
    location = _parse_location(symbol, location, ctx)
    aux = _parse_aux_states(symbol, aux_states, ctx)
    ex = symbol.bind(ctx, dict(location), grad_req='null',
                     aux_states=dict(aux) if aux else None)
    outputs = ex.forward(is_train=is_train)
    if isinstance(expected, dict):
        expected = [expected[k] for k in symbol.list_outputs()]
    for out, exp, name in zip(outputs, expected, symbol.list_outputs()):
        assert_almost_equal(out.asnumpy(), np.asarray(exp), rtol=rtol,
                            atol=atol if atol is not None else rtol * 0.1,
                            names=('EXPECTED_%s' % name, 'FORWARD_%s' % name))
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(symbol, location, out_grads, expected,
                            rtol=1e-5, atol=None, aux_states=None,
                            grad_req='write', ctx=None):
    """Compare executor backward against numpy reference gradients
    (reference test_utils.py:617)."""
    ctx = ctx or default_context()
    location = _parse_location(symbol, location, ctx)
    aux = _parse_aux_states(symbol, aux_states, ctx)
    args = symbol.list_arguments()
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(args, expected))
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in args}
    args_grad = {k: nd.zeros_like(location[k])
                 for k in expected if grad_req.get(k, 'write') != 'null'}
    ex = symbol.bind(ctx, dict(location), args_grad=args_grad,
                     grad_req=grad_req,
                     aux_states=dict(aux) if aux else None)
    ex.forward(is_train=True)
    if out_grads is not None:
        out_grads = [g if isinstance(g, nd.NDArray) else nd.array(g, ctx=ctx)
                     for g in (out_grads if isinstance(out_grads, (list, tuple))
                               else [out_grads])]
    ex.backward(out_grads)
    for name, exp in expected.items():
        if grad_req.get(name, 'write') == 'null':
            continue
        assert_almost_equal(ex.grad_dict[name].asnumpy(), np.asarray(exp),
                            rtol=rtol,
                            atol=atol if atol is not None else rtol * 0.1,
                            names=('BACKWARD_%s' % name,
                                   'EXPECTED_%s' % name))
    return {k: v.asnumpy() for k, v in ex.grad_dict.items()
            if v is not None}


def check_consistency(sym_or_list, ctx_list, scale=1.0, grad_req='write',
                      rtol=1e-4, atol=1e-5, arg_params=None,
                      aux_params=None):
    """Run the same symbol under every (ctx, type_dict, shapes) spec and
    cross-check all outputs and gradients against the highest-precision
    run (reference test_utils.py:784 — its cpu/gpu/fp16 matrix; here the
    specs differ by context and/or dtype, e.g. float32 vs bfloat16).

    ctx_list entries: dict(ctx=Context, <input name>=shape, ...,
    optionally type_dict={name: dtype}).
    """
    if isinstance(sym_or_list, (list, tuple)):
        sym_list = list(sym_or_list)
    else:
        sym_list = [sym_or_list] * len(ctx_list)
    assert len(sym_list) == len(ctx_list)

    executors = []
    base_args = {}
    for s, spec in zip(sym_list, ctx_list):
        spec = dict(spec)
        ctx = spec.pop('ctx')
        type_dict = spec.pop('type_dict', {})
        shapes = spec
        args = {}
        for name in s.list_arguments():
            if name not in base_args:
                if arg_params and name in arg_params:
                    src = np.asarray(arg_params[name])
                else:
                    shape = shapes.get(name)
                    if shape is None:
                        arg_shapes, _, _ = s.infer_shape(**shapes)
                        shape = dict(zip(s.list_arguments(),
                                         arg_shapes))[name]
                    src = np.random.normal(size=shape, scale=scale)
                base_args[name] = src
            dtype = type_dict.get(name, np.float32)
            args[name] = nd.array(np.asarray(base_args[name],
                                             dtype=np.float32),
                                  ctx=ctx).astype(dtype)
        args_grad = {k: nd.zeros_like(v) for k, v in args.items()} \
            if grad_req != 'null' else None
        ex = s.bind(ctx, args, args_grad=args_grad, grad_req=grad_req)
        ex.forward(is_train=grad_req != 'null')
        if grad_req != 'null':
            ex.backward([nd.ones(o.shape, ctx=ctx).astype(o.dtype)
                         for o in ex.outputs])
        executors.append(ex)

    # ground truth = the highest-precision run (reference: sorts ctx_list
    # by dtype precision and compares everything against the widest)
    def _prec(spec):
        td = spec.get('type_dict', {})
        dts = [torch_dtype(d) for d in td.values()] or [torch_dtype('float32')]
        return min(dt.itemsize for dt in dts)

    ref_i = int(np.argmax([_prec(dict(s)) for s in ctx_list]))
    ref = executors[ref_i]
    for i, ex in enumerate(executors):
        if i == ref_i:
            continue
        for j, (a, b) in enumerate(zip(ref.outputs, ex.outputs)):
            assert_almost_equal(
                np.asarray(a.asnumpy(), np.float64),
                np.asarray(b.asnumpy(), np.float64), rtol=rtol, atol=atol,
                names=('ctx%d_out%d' % (ref_i, j),
                       'ctx%d_out%d' % (i, j)))
        if grad_req != 'null':
            for name in ref.grad_dict:
                if ref.grad_dict[name] is None:
                    continue
                assert_almost_equal(
                    np.asarray(ref.grad_dict[name].asnumpy(), np.float64),
                    np.asarray(ex.grad_dict[name].asnumpy(), np.float64),
                    rtol=rtol, atol=atol,
                    names=('ctx%d_grad_%s' % (ref_i, name),
                           'ctx%d_grad_%s' % (i, name)))
    return [ex.outputs[0].asnumpy() for ex in executors]
