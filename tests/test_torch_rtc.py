"""The port's mx.rtc (mxnet_tpu_torch.rtc, _nvrtc) on the CPU.

CUDA source compiles and runs only on the card (chip_smoke.py phase 8).
Here: the generated source, the compile key and the launch arguments
(with NVRTC and the driver replaced by recorders), the errors, and each
RTC_CASES plain version against the JAX package's mx.rtc running the
same function as a Pallas body in interpret mode, on the same inputs at
small sizes, so that the card's comparison is anchored to the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

import chip_smoke
import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _nvrtc, nd, rtc

SAXPY_SOURCE = '''#include <cuda_fp16.h>
#include <cuda_bf16.h>

extern "C" __global__ void saxpy1(const float* x, const float* y, float* out) {
const int x_ndim = 1;
const int x_dims[] = {4096};
const int y_ndim = 1;
const int y_dims[] = {4096};
const int out_ndim = 1;
const int out_dims[] = {4096};
''' + chip_smoke.RTC_CASES['saxpy1']['body'] + '\n}\n'

DBL2D_SOURCE = '''#include <cuda_fp16.h>
#include <cuda_bf16.h>

extern "C" __global__ void dbl2d(const __nv_bfloat16* x, __nv_bfloat16* out) {
const int x_ndim = 2;
const int x_dims[] = {30, 100};
const int out_ndim = 2;
const int out_dims[] = {30, 100};
''' + chip_smoke.RTC_CASES['dbl2d']['body'] + '\n}\n'


def _kernel(name):
    spec = chip_smoke.RTC_CASES[name]
    return rtc.Rtc(name, list(spec['ins']), list(spec['outs']), spec['body'])


def test_generated_source_of_saxpy1():
    f32 = torch.float32
    src = _kernel('saxpy1').source([(4096,), (4096,)], [f32, f32],
                                   [(4096,)], [f32])
    assert src == SAXPY_SOURCE
    assert '__restrict__' not in src


def test_generated_source_of_dbl2d():
    bf16 = torch.bfloat16
    src = _kernel('dbl2d').source([(30, 100)], [bf16], [(30, 100)], [bf16])
    assert src == DBL2D_SOURCE


@pytest.mark.parametrize('dtype,ctype', sorted(
    (str(d).split('.')[-1], c) for d, c in rtc.C_TYPES.items()))
def test_array_types(dtype, ctype):
    t = getattr(torch, dtype)
    src = rtc.Rtc('k', ['a'], ['b'], '').source([(2,)], [t], [(2,)], [t])
    assert 'const %s* a, %s* b' % (ctype, ctype) in src


def test_inputs_and_outputs_as_reference_pairs_or_dicts():
    x = nd.zeros((3,), ctx=mx.cpu())
    k = rtc.Rtc('k', [('x', x)], [('y', x)], 'y[0] = x[0];')
    assert (k.input_names, k.output_names) == (['x'], ['y'])
    k = rtc.Rtc('k', {'a': 1, 'b': 2}, {'c': 3}, '')
    assert (k.input_names, k.output_names) == (['a', 'b'], ['c'])


class _FakeCard:
    """Stands in for NVRTC and the driver: records compiles and launches
    and runs each launch's plain version on the CPU memory behind its
    pointers, so that push's bookkeeping is seen end to end."""

    def __init__(self, monkeypatch):
        self.compiled, self.launches, self.sources = [], [], {}
        monkeypatch.setattr(_nvrtc, 'function', self.function)
        monkeypatch.setattr(_nvrtc, 'launch', self.launch)
        monkeypatch.setattr(torch.cuda, 'device', lambda d: _NoScope())
        monkeypatch.setattr(torch.cuda, 'current_stream',
                            lambda d: type('S', (), {'cuda_stream': 7})())
        monkeypatch.setattr(mx.Context, 'torch_device',
                            property(lambda self: torch.device('cpu')))

    def function(self, device_index, source, name):
        new = source not in self.compiled
        if new:
            self.compiled.append(source)
        self.sources[name] = source
        return name, new

    def launch(self, fn, grid, block, pointers, stream):
        self.launches.append((fn, grid, block, list(pointers), stream))


class _NoScope:
    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def _gpu_array(a):
    """An array labelled gpu(0) whose tensor lies on the CPU (never
    launched on: the fake card only records)."""
    return nd.NDArray(torch.from_numpy(np.asarray(a)), mx.gpu(0))


def test_compile_key_and_launch_arguments(monkeypatch):
    card = _FakeCard(monkeypatch)
    k = _kernel('saxpy1')
    x, y = _gpu_array(np.ones(256, np.float32)), \
        _gpu_array(np.ones(256, np.float32))
    c0, l0 = rtc.RTC_COMPILES, rtc.RTC_LAUNCHES
    out = k.push([x, y], grid_dims=(2,), block_dims=(128,))
    assert out.shape == (256,) and out.context == mx.gpu(0)
    k.push([x, y], grid_dims=(2,), block_dims=(128,))
    assert rtc.RTC_COMPILES - c0 == 1          # same key: compiled once
    x2 = _gpu_array(np.ones(512, np.float32))
    k.push([x2, x2], grid_dims=(4, 1), block_dims=(128, 1, 1))
    assert rtc.RTC_COMPILES - c0 == 2          # a new shape compiles anew
    assert rtc.RTC_LAUNCHES - l0 == 3
    assert len(card.compiled) == 2
    fn, grid, block, ptrs, stream = card.launches[0]
    assert (fn, grid, block, stream) == ('saxpy1', (2, 1, 1), (128, 1, 1), 7)
    assert ptrs[:2] == [x.handle.data_ptr(), y.handle.data_ptr()]
    assert 'x_dims[] = {512}' in card.sources['saxpy1']


def test_push_in_place_passes_the_output_as_the_input(monkeypatch):
    card = _FakeCard(monkeypatch)
    w = _gpu_array(np.ones(64, np.float32))
    g = _gpu_array(np.ones(64, np.float32))
    res = _kernel('sgd_update').push([w, g], outs=[w], grid_dims=(1,),
                                     block_dims=(64,))
    assert res == [w]
    ptrs = card.launches[-1][3]
    assert ptrs == [w.handle.data_ptr(), g.handle.data_ptr(),
                    w.handle.data_ptr()]


def test_push_raises_on_a_cpu_context():
    x = nd.ones((4,), ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match='gpu context'):
        _kernel('saxpy1').push([x, x], grid_dims=(1,), block_dims=(4,))


@pytest.mark.parametrize('kwargs', [dict(), dict(grid_dims=(1,)),
                                    dict(block_dims=(4,)),
                                    dict(grid_dims=(1, 1, 1, 1),
                                         block_dims=(4,)),
                                    dict(grid_dims=(0,), block_dims=(4,))])
def test_push_needs_grid_and_block_dims(kwargs):
    x = _gpu_array(np.ones(4, np.float32))
    with pytest.raises(mx.MXNetError, match='grid_dims|block_dims'):
        _kernel('saxpy1').push([x, x], **kwargs)


def test_push_raises_on_a_wrong_count():
    x = _gpu_array(np.ones(4, np.float32))
    k = _kernel('saxpy1')
    with pytest.raises(mx.MXNetError, match='expects 2 inputs'):
        k.push([x], grid_dims=(1,), block_dims=(4,))
    with pytest.raises(mx.MXNetError, match='expects 1 outputs'):
        k.push([x, x], outs=[x, x], grid_dims=(1,), block_dims=(4,))


def test_push_raises_on_a_dtype_with_no_c_type():
    x = _gpu_array(np.ones(4, np.bool_))
    with pytest.raises(mx.MXNetError, match='no C type'):
        rtc.Rtc('k', ['x'], ['y'], '').push([x], grid_dims=(1,),
                                             block_dims=(4,))


def test_push_raises_on_two_devices():
    x = _gpu_array(np.ones(4, np.float32))
    y = nd.NDArray(torch.ones(4), mx.gpu(1))
    with pytest.raises(mx.MXNetError, match='one device'):
        _kernel('saxpy1').push([x, y], grid_dims=(1,), block_dims=(4,))


def test_nvrtc_missing_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setattr(_nvrtc, '_libs', {})
    with pytest.raises(mx.MXNetError, match='no libnvrtc.so'):
        _nvrtc.nvrtc_path()
    with pytest.raises(mx.MXNetError, match='set CUDA_HOME'):
        _nvrtc.compile_cubin(SAXPY_SOURCE, 'saxpy1')


# the RTC_CASES functions as Pallas bodies, run by the JAX package's mx.rtc
PALLAS_BODIES = {
    'ref_exp': lambda x_ref, y_ref: y_ref.__setitem__(
        Ellipsis, jnp.exp(x_ref[...] * 5.0)),
    'saxpy1': lambda x_ref, y_ref, out_ref: out_ref.__setitem__(
        Ellipsis, x_ref[...] * y_ref[...] + 1.0),
    'dbl2d': lambda x_ref, out_ref: out_ref.__setitem__(
        Ellipsis, x_ref[...] * 2),
    'sgd_update': lambda w_ref, g_ref, out_ref: out_ref.__setitem__(
        Ellipsis, w_ref[...] - chip_smoke.RTC_LR * g_ref[...]),
}
SMALL = {'ref_exp': (10,), 'saxpy1': (4096,), 'dbl2d': (30, 100),
         'sgd_update': (1024,)}


@pytest.mark.parametrize('name', sorted(chip_smoke.RTC_CASES))
def test_plain_version_matches_the_jax_rtc(name):
    spec = chip_smoke.RTC_CASES[name]
    shape = SMALL[name]
    arrays = chip_smoke.rtc_inputs(name, shape, 0)
    dtype = getattr(torch, spec['dtype'])
    ins = [torch.from_numpy(a).to(dtype) for a in arrays]
    plain = chip_smoke.rtc_plain(name, *[t.clone() for t in ins])

    jdtype = jnp.bfloat16 if spec['dtype'] == 'bfloat16' else jnp.float32
    jins = [jnd.array(a, dtype=jdtype) for a in arrays]
    kern = jmx.rtc.Rtc(name, list(spec['ins']), list(spec['outs']),
                       PALLAS_BODIES[name])
    if spec.get('in_place'):
        kern.push(jins, outs=[jins[0]])
        ref = jins[0]
    else:
        ref = kern.push(jins, out_shapes=[shape])
    ref = torch.from_numpy(ref.asnumpy().astype(np.float32))
    slack = chip_smoke.rtc_slack(torch, name, ins)
    if name == 'sgd_update':
        # XLA on the CPU contracts w - lr * g to one FMA, where the plain
        # version (and the card's kernel) rounds lr * g first
        slack = 0.5 * chip_smoke.ulp_of(torch, chip_smoke.RTC_LR * ins[1])
    check = chip_smoke.ulp_mismatch(torch, plain, ref, max(spec['ulp'], 1),
                                    slack)
    assert check['ok'], check


@pytest.mark.parametrize('name,broken', [
    ('saxpy1', lambda x, y: x * y),
    ('sgd_update', lambda w, g: w - 0.1001 * g),
    ('ref_exp', lambda x: (x * 5.0).exp() * (1 + 2 ** -21)),
])
def test_chip_smoke_rtc_gate_catches_a_wrong_kernel(name, broken):
    spec = chip_smoke.RTC_CASES[name]
    ins = [torch.from_numpy(a) for a in
           chip_smoke.rtc_inputs(name, SMALL[name], 0)]
    plain = chip_smoke.rtc_plain(name, *ins)
    got = broken(*ins)
    slack = chip_smoke.rtc_slack(torch, name, ins)
    assert chip_smoke.ulp_mismatch(torch, plain, plain, spec['ulp'],
                                   slack)['ok']
    assert not chip_smoke.ulp_mismatch(torch, got, plain, spec['ulp'],
                                       slack)['ok']
