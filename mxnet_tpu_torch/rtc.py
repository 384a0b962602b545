"""Runtime-compiled device kernels (`mx.rtc`): the counterpart of
mxnet_tpu/rtc.py, with the reference's contract back.

The reference's mx.rtc (python/mxnet/rtc.py, src/common/mxrtc.cc)
compiled the body of a CUDA kernel, supplied as a string, with NVRTC and
launched it on NDArrays with the caller's grid and block; the JAX
package had to take a Pallas body instead. Here the body is CUDA C
again: `Rtc` wraps it in

    extern "C" __global__ void <name>(const T0* x, ..., To* out) {
    const int x_ndim = 2;
    const int x_dims[] = {3000, 1000};
    ...
    <body>
    }

with one `<array>_ndim` and `<array>_dims[]` constant for each input and
output, as the reference's Rtc decorated its body, and compiles it with
NVRTC to a CUBIN for sm_90a (`_nvrtc`) once per (shapes, dtypes) key,
the key on which the JAX package compiled its Pallas call. Each array
type T comes from its dtype (`C_TYPES`). The pointers carry no
`__restrict__`: an output may be an input too, for an update in place.

`push` launches it with `grid_dims` and `block_dims` on the current
stream of the arrays' GPU. CUDA source has no CPU route, so a `cpu`
context raises, as the reference's GPU-only mx.rtc did. `RTC_LAUNCHES`
counts launches and `RTC_COMPILES` NVRTC compiles.
"""
import torch

from . import _nvrtc
from . import ndarray as nd
from .base import MXNetError, torch_dtype

# Launches and NVRTC compiles, counted where they happen; a run resets
# them to see what its path did.
RTC_LAUNCHES = 0
RTC_COMPILES = 0

C_TYPES = {torch.float32: 'float', torch.float64: 'double',
           torch.float16: '__half', torch.bfloat16: '__nv_bfloat16',
           torch.int32: 'int', torch.int64: 'long long',
           torch.int8: 'signed char', torch.uint8: 'unsigned char'}

_HEADER = '#include <cuda_fp16.h>\n#include <cuda_bf16.h>\n'


def _names(arrays):
    """Names from a list of names, a dict, or (name, NDArray) pairs."""
    if isinstance(arrays, dict):
        return list(arrays)
    return [a[0] if isinstance(a, (tuple, list)) else a for a in arrays]


def _c_type(dtype, what):
    if dtype not in C_TYPES:
        raise MXNetError('mx.rtc: %s has dtype %s, which has no C type here '
                         '(%s)' % (what, dtype, ', '.join(
                             str(d).split('.')[-1] for d in C_TYPES)))
    return C_TYPES[dtype]


def _dims3(name, dims):
    if dims is None:
        raise MXNetError('mx.rtc: push on a GPU takes %s, 1 to 3 positive '
                         'ints' % name)
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError('mx.rtc: %s must be 1 to 3 positive ints; got %r'
                         % (name, dims))
    return dims + (1,) * (3 - len(dims))


class Rtc(object):
    """A kernel compiled at run time from CUDA C.

    Parameters
    ----------
    name : str
        the kernel's name in the generated source.
    inputs, outputs : list of str, dict, or list of (name, NDArray)
        the names of the input and output arrays, in call order.
    kernel : str
        the body of the CUDA kernel; it reads the inputs as `const T*`,
        writes the outputs as `T*`, and may read `<array>_ndim` and
        `<array>_dims[]`.

    Example
    -------
    >>> k = mx.rtc.Rtc('saxpy1', ['x', 'y'], ['out'], '''
    ...     long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    ...     if (i < x_dims[0]) out[i] = x[i] * y[i] + 1.0f;''')
    >>> out = k.push([x, y], grid_dims=(4096,), block_dims=(256,))
    """

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self.input_names = _names(inputs)
        self.output_names = _names(outputs)
        self.kernel = kernel
        self._sources = {}

    def source(self, in_shapes, in_dtypes, out_shapes, out_dtypes):
        """The generated source for arrays of these shapes and torch
        dtypes, made once per key."""
        key = (tuple(map(tuple, in_shapes)), tuple(in_dtypes),
               tuple(map(tuple, out_shapes)), tuple(out_dtypes))
        if key not in self._sources:
            params, consts = [], []
            arrays = list(zip(self.input_names, in_shapes, in_dtypes)) + \
                list(zip(self.output_names, out_shapes, out_dtypes))
            for i, (name, shape, dtype) in enumerate(arrays):
                ctype = _c_type(dtype, 'array %s' % name)
                const = 'const ' if i < len(self.input_names) else ''
                params.append('%s%s* %s' % (const, ctype, name))
                dims = ', '.join(str(int(d)) for d in shape) or '1'
                consts.append('const int %s_ndim = %d;\n'
                              'const int %s_dims[] = {%s};\n'
                              % (name, len(shape), name, dims))
            self._sources[key] = '%s\nextern "C" __global__ void %s(%s) {\n' \
                '%s%s\n}\n' % (_HEADER, self.name, ', '.join(params),
                               ''.join(consts), self.kernel)
        return self._sources[key]

    def push(self, ins, outs=None, out_shapes=None, out_dtypes=None,
             grid_dims=None, block_dims=None):
        """Launch the kernel (reference Rtc.push(ins, outs, grid_dims,
        block_dims)) on `ins`, writing into `outs` and returning them, or
        into new arrays of `out_shapes` and `out_dtypes` (default: the
        first input's) and returning those."""
        global RTC_LAUNCHES, RTC_COMPILES
        ins = [x if isinstance(x, nd.NDArray) else nd.array(x) for x in ins]
        if len(ins) != len(self.input_names):
            raise MXNetError('Rtc %s expects %d inputs; got %d' % (
                self.name, len(self.input_names), len(ins)))
        n_out = len(self.output_names)
        if outs is not None:
            if len(outs) != n_out:
                raise MXNetError('Rtc %s expects %d outputs; got %d' % (
                    self.name, n_out, len(outs)))
            out_shapes = [o.shape for o in outs]
            out_dtypes = [o.handle.dtype for o in outs]
        if out_shapes is None:
            out_shapes = [ins[0].shape] * n_out
        if out_dtypes is None:
            out_dtypes = [ins[0].handle.dtype] * len(out_shapes)
        out_dtypes = [torch_dtype(d) for d in out_dtypes]
        if len(out_shapes) != n_out or len(out_dtypes) != n_out:
            raise MXNetError('Rtc %s expects %d output shapes and dtypes'
                             % (self.name, n_out))
        ctx = ins[0].context
        for x in ins + list(outs or []):
            if x.context != ctx:
                raise MXNetError('Rtc %s: arrays on %s and %s; they must be '
                                 'on one device' % (self.name, ctx,
                                                    x.context))
        source = self.source([x.shape for x in ins],
                             [x.handle.dtype for x in ins],
                             out_shapes, out_dtypes)
        grid = _dims3('grid_dims', grid_dims)
        block = _dims3('block_dims', block_dims)
        if ctx.device_type != 'gpu':
            raise MXNetError('Rtc %s: mx.rtc compiles CUDA source and runs on '
                             'a gpu context; %s has no route for it'
                             % (self.name, ctx))
        device = ctx.torch_device
        fn, compiled = _nvrtc.function(device.index, source, self.name)
        RTC_COMPILES += compiled
        in_t = [x.handle.detach().contiguous() for x in ins]
        if outs is not None:
            out_t = [o.handle.detach() for o in outs]
            if not all(t.is_contiguous() for t in out_t):
                raise MXNetError('Rtc %s writes into contiguous outputs only'
                                 % self.name)
        else:
            out_t = [torch.empty(tuple(s), dtype=d, device=device)
                     for s, d in zip(out_shapes, out_dtypes)]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            _nvrtc.launch(fn, grid, block,
                          [t.data_ptr() for t in in_t + out_t], stream)
        RTC_LAUNCHES += 1
        if outs is not None:
            return outs
        results = [nd.NDArray(t, ctx) for t in out_t]
        return results if len(results) > 1 else results[0]
