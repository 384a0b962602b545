"""The port's quantization core and the quantized serving engine
(mxnet_tpu_torch/quantization.py, serving.InferenceEngine(quantize=))
against the JAX package's, on the CPU.

Codes and scales equal the JAX package's bit for bit, on numpy arrays
and on torch tensors, exact .5 ties included (half away from zero,
where torch.round would round half to even); the uint8 math, the
calibration, the weight-dict helpers and the wire codec likewise (a bf16
payload the same bytes as the JAX package's ml_dtypes one). Then the
config's resolution and env default, and the engine's int8 and bf16
modes on the MLP of tests/test_quantization.py: its answers against the
JAX engine's, its residency, a parity-gate refusal that mutates nothing,
and the counters.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import ml_dtypes

import mxnet_tpu as jmx
from mxnet_tpu import quantization as JQ
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler, sym
from mxnet_tpu_torch import quantization as Q
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.quantization import (QuantConfig, QuantParityError,
                                          WireCodec)

# values whose codes are exact ties at scale 1 (max |a| = 127): half away
# from zero gives 3, -4, 1, -1, 2, 127; half to even would give 2, -4,
# 0, 0, 2, 126
TIES = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5], np.float32)
TIE_CODES = np.array([127, 3, -4, 1, -1, 2, 127], np.int8)


def _arrays():
    rng = np.random.RandomState(0)
    skew = rng.randn(4, 256).astype(np.float32)
    skew[0] *= 100.0
    return {'matrix': rng.randn(16, 32).astype(np.float32),
            'conv': (rng.randn(8, 3, 3, 3) * 0.1).astype(np.float32),
            'skewed': skew, 'ties': TIES.reshape(1, -1),
            'zeros': np.zeros((3, 4), np.float32),
            'tiny': (rng.randn(5, 7) * 1e-30).astype(np.float32)}


@pytest.mark.parametrize('name', sorted(_arrays()))
@pytest.mark.parametrize('axis', [None, 0])
def test_int8_codes_and_scales_equal_jax(name, axis):
    a = _arrays()[name]
    jq, js = JQ.quantize_int8(a, axis=axis)
    for src in (a, torch.from_numpy(a)):
        q, s = Q.quantize_int8(src, axis=axis)
        q, s = np.asarray(q), np.asarray(s)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s.view(np.uint32),
                                      np.asarray(js).view(np.uint32))
        back = Q.dequantize_int8(Q.quantize_int8(src, axis=axis)[0],
                                 Q.quantize_int8(src, axis=axis)[1],
                                 axis=axis)
        np.testing.assert_array_equal(
            np.asarray(back), JQ.dequantize_int8(jq, js, axis=axis))


def test_ties_round_half_away_from_zero():
    for src in (TIES, torch.from_numpy(TIES)):
        q, s = Q.quantize_int8(src)
        assert float(s) == 1.0
        np.testing.assert_array_equal(np.asarray(q), TIE_CODES)
    np.testing.assert_array_equal(JQ.quantize_int8(TIES)[0], TIE_CODES)
    # torch.round, which the port does not use, rounds half to even
    assert torch.round(torch.tensor(2.5)).item() == 2.0


def test_percentile_and_empty_scales_equal_jax():
    a = _arrays()['skewed']
    for axis in (None, 0):
        np.testing.assert_array_equal(
            Q.symmetric_scale(a, axis=axis, percentile=99.0),
            JQ.symmetric_scale(a, axis=axis, percentile=99.0))
    empty = np.zeros((0,), np.float32)
    assert Q.symmetric_scale(empty) == JQ.symmetric_scale(empty) == 0.0
    assert float(Q.symmetric_scale(torch.zeros(0))) == 0.0


def test_uint8_math_equals_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(64).astype(np.float32) * 3
    for lo, hi in ((-2.0, 2.5), (0.0, 0.0), (-9.0, 9.0)):
        ref = JQ.quantize_uint8_math(a, np.float32(lo), np.float32(hi))
        np.testing.assert_array_equal(
            Q.quantize_uint8_math(a, np.float32(lo), np.float32(hi)), ref)
        got = Q.quantize_uint8_math(torch.from_numpy(a), lo, hi)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            Q.dequantize_uint8_math(ref, np.float32(lo), np.float32(hi)),
            JQ.dequantize_uint8_math(ref, np.float32(lo), np.float32(hi)))


def test_calibrate_matches_jax():
    batches = [np.linspace(-1, 1, 100, dtype=np.float32),
               np.asarray([50.0], np.float32)]
    for mode in ('minmax', 'percentile'):
        assert Q.calibrate(batches, mode, percentile=99.0) == \
            JQ.calibrate(batches, mode, percentile=99.0)
    with pytest.raises(MXNetError):
        Q.calibrate(batches, 'bogus')
    with pytest.raises(MXNetError):
        Q.calibrate([])


@pytest.mark.parametrize('cfg', [dict(dtype='int8'),
                                 dict(dtype='int8', per_channel=False),
                                 dict(dtype='int8', calibration='percentile',
                                      percentile=99.0),
                                 dict(dtype='bf16'),
                                 dict(dtype='int8', min_size=16)])
def test_quantize_weights_equals_jax(cfg):
    arrays = dict(_arrays(), bias=np.ones(64, np.float32),
                  small=np.ones((2, 3), np.float32))
    mine, mine_pass = Q.quantize_weights(arrays, QuantConfig(**cfg))
    theirs, their_pass = JQ.quantize_weights(arrays, JQ.QuantConfig(**cfg))
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine_pass) == sorted(their_pass)
    for name, (q, s, orig) in mine.items():
        jq, js, jorig = theirs[name]
        assert orig == np.dtype(jorig).name == 'float32'
        if cfg['dtype'] == 'bf16':
            assert s is None and js is None
            np.testing.assert_array_equal(
                q.view(torch.int16).numpy().view(np.uint16),
                np.asarray(jq).view(np.uint16))
            back = Q.dequantize_weight(q, s, QuantConfig(**cfg))
        else:
            np.testing.assert_array_equal(q.numpy(), jq)
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            back = Q.dequantize_weight(q, s, QuantConfig(**cfg))
        np.testing.assert_array_equal(
            back.numpy(), JQ.dequantize_weight(jq, js,
                                               JQ.QuantConfig(**cfg)))
    assert Q.quantized_nbytes(mine) == JQ.quantized_nbytes(theirs)


def test_int8_takes_16_bit_weights_on_their_float32_values():
    """A bf16 weight (the port's bf16 ResNet-50) quantizes to the codes of
    its float32 values; the JAX package's config would keep it fp."""
    a = _arrays()['conv']
    w16 = torch.from_numpy(a).to(torch.bfloat16)
    cfg = QuantConfig('int8', min_size=16)
    assert cfg.wants(tuple(w16.shape), w16.dtype)
    assert not QuantConfig('bf16', min_size=16).wants(tuple(w16.shape),
                                                      w16.dtype)
    assert not JQ.QuantConfig('int8', min_size=16).wants(
        a.shape, ml_dtypes.bfloat16)
    (q, s, orig), = Q.quantize_weights({'w': w16}, cfg)[0].values()
    jq, js = JQ.quantize_int8(w16.float().numpy(), axis=0)
    assert orig == 'bfloat16'
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert q.numel() * q.element_size() * 2 == \
        w16.numel() * w16.element_size()


def test_wire_codec_equals_jax():
    rng = np.random.RandomState(2)
    steps = [[rng.randn(500).astype(np.float32),
              rng.randn(8, 8).astype(np.float32)] for _ in range(3)]
    for wire in ('int8', 'bf16', 'fp32'):
        mine, theirs = WireCodec(wire), JQ.WireCodec(wire)
        for arrays in steps:
            p, s = mine.encode(arrays)
            jp, js = theirs.encode(arrays)
            for a, b in zip(p, jp):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
            np.testing.assert_array_equal(s, js)
            assert WireCodec.wire_nbytes(p, s) == \
                JQ.WireCodec.wire_nbytes(jp, js)
            for d, jd in zip(mine.decode(p, s, [np.float32] * 2),
                             theirs.decode(jp, js, [np.float32] * 2)):
                np.testing.assert_array_equal(d, jd)
            # a JAX peer's payload decodes the same
            for d, jd in zip(mine.decode(jp, js, [np.float32] * 2),
                             theirs.decode(jp, js, [np.float32] * 2)):
                np.testing.assert_array_equal(d, jd)
            assert mine.residual_norm() == theirs.residual_norm()
    with pytest.raises(MXNetError):
        WireCodec('int4')


@pytest.mark.parametrize('wire', ['int8', 'bf16', 'fp32'])
def test_ring_chunk_equals_jax(wire):
    x = np.random.RandomState(3).randn(77).astype(np.float32)
    p, s = Q.encode_ring_chunk(x, wire)
    jp, js = JQ.encode_ring_chunk(x, wire)
    assert np.asarray(p).tobytes() == np.asarray(jp).tobytes() and s == js
    np.testing.assert_array_equal(Q.decode_ring_chunk(p, s, wire),
                                  JQ.decode_ring_chunk(jp, js, wire))


def test_wire_dtype_from_env(monkeypatch):
    for v, want in (('', 'fp32'), ('bf16', 'bf16'), ('i8', 'int8')):
        monkeypatch.setenv('MXNET_TPU_DIST_WIRE_DTYPE', v)
        assert Q.wire_dtype_from_env() == JQ.wire_dtype_from_env() == want
    monkeypatch.setenv('MXNET_TPU_DIST_WIRE_DTYPE', 'int4')
    with pytest.raises(MXNetError):
        Q.wire_dtype_from_env()


# ---------------------------------------------------------------------------
# the quantized engine
# ---------------------------------------------------------------------------

def _mlp(pkg, hidden=128, classes=8):
    s = pkg.sym
    data = s.Variable('data')
    x = s.Activation(s.FullyConnected(data, num_hidden=hidden, name='fc1'),
                     act_type='relu')
    x = s.FullyConnected(x, num_hidden=classes, name='fc2')
    return s.SoftmaxOutput(x, name='softmax')


def _params(seed=0, dim=64, scale=0.2):
    probe = _mlp(mx).simple_bind(mx.cpu(), grad_req='null', data=(1, dim))
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            for k, v in probe.arg_dict.items() if k != 'data'}


def _predictor(seed=0):
    return Predictor(symbol=_mlp(mx), arg_params=_params(seed),
                     input_shapes={'data': (1, 64)}, ctx=mx.cpu())


def _jax_predictor(seed=0):
    return JPredictor(symbol=_mlp(jmx), input_shapes={'data': (1, 64)},
                      arg_params={k: jmx.nd.array(v)
                                  for k, v in _params(seed).items()})


def test_int8_engine_parity_residency_and_recreation():
    x = np.random.RandomState(3).randn(2, 64).astype(np.float32)
    with _predictor(seed=4).serve(max_batch=4, max_wait_us=0) as eng_fp:
        fp_out = eng_fp.predict(x)
        fp_bytes = eng_fp.resident_bytes()
    eng = _predictor(seed=4).serve(max_batch=4, max_wait_us=0,
                                   quantize='int8')
    q_out = eng.predict(x)
    st = eng.stats()
    assert np.abs(fp_out - q_out).max() < 0.05
    assert st['quantized']['dtype'] == 'int8'
    assert st['quantized']['parity_measured'] <= 0.05
    assert st['quantized']['weights'] == 2
    assert eng.resident_bytes() * 3 < fp_bytes
    assert st['compiles_after_warmup'] == 0
    ex = eng._base_ex
    assert ex.arg_dict['fc1_weight']._data.dtype == torch.int8
    assert ex.arg_dict['fc1_bias']._data.dtype == torch.float32
    eng.close()
    # re-created: no rung built, the same bits
    misses = exec_cache.stats()['misses']
    with _predictor(seed=4).serve(max_batch=4, max_wait_us=0,
                                  quantize='int8') as eng2:
        q2 = eng2.predict(x)
    assert exec_cache.stats()['misses'] == misses
    np.testing.assert_array_equal(q_out, q2)


@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
def test_quantized_engine_answers_as_the_jax_engine(dtype):
    x = np.random.RandomState(5).randn(3, 64).astype(np.float32)
    with _jax_predictor(seed=6).serve(max_batch=4, max_wait_us=0,
                                      quantize=dtype) as jeng:
        ref = jeng.predict(x)
        jbytes = jeng.resident_bytes()
        jparity = jeng.stats()['quantized']['parity_measured']
    with _predictor(seed=6).serve(max_batch=4, max_wait_us=0,
                                  quantize=dtype) as eng:
        got = eng.predict(x)
        assert eng.resident_bytes() == jbytes
        assert abs(eng.stats()['quantized']['parity_measured'] -
                   jparity) < 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_int8_engine_rows_do_not_depend_on_their_batch():
    with _predictor(seed=5).serve(max_batch=4, max_wait_us=0,
                                  quantize='int8') as eng:
        xs = np.random.RandomState(6).randn(4, 64).astype(np.float32)
        full = eng.predict(xs)
        padded = eng.predict(xs[:3])
    np.testing.assert_array_equal(full[:3], padded)


def test_parity_gate_refuses_and_mutates_nothing():
    pred = _predictor(seed=7)
    before = pred._executor.arg_dict['fc1_weight'].asnumpy().copy()
    with pytest.raises(QuantParityError) as err:
        pred.serve(max_batch=4, quantize=QuantConfig(parity_tol=0.0))
    assert err.value.measured > 0 and err.value.tol == 0.0
    after = pred._executor.arg_dict['fc1_weight']
    assert after._data.dtype == torch.float32
    np.testing.assert_array_equal(before, after.asnumpy())
    with pred.serve(max_batch=4, max_wait_us=0) as eng:
        eng.predict(np.zeros((1, 64), np.float32))


def test_quantize_refuses_a_model_without_quantizable_weights():
    data = sym.Variable('data')
    net = sym.SoftmaxOutput(sym.FullyConnected(data, num_hidden=2,
                                               name='t'), name='softmax')
    pred = Predictor(symbol=net, input_shapes={'data': (1, 4)},
                     arg_params={'t_weight': np.ones((2, 4), np.float32),
                                 't_bias': np.zeros(2, np.float32)},
                     ctx=mx.cpu())
    with pytest.raises(MXNetError, match='no quantizable'):
        pred.serve(max_batch=2, quantize='int8')


def test_bf16_engine_mode():
    x = np.random.RandomState(8).randn(1, 64).astype(np.float32)
    with _predictor(seed=9).serve(max_batch=2, max_wait_us=0) as eng_fp:
        fp_out = eng_fp.predict(x)
        fp_bytes = eng_fp.resident_bytes()
    with _predictor(seed=9).serve(max_batch=2, max_wait_us=0,
                                  quantize='bf16') as eng:
        out = eng.predict(x)
        assert eng._base_ex.arg_dict['fc1_weight']._data.dtype == \
            torch.bfloat16
        assert eng.resident_bytes() * 1.5 < fp_bytes
    assert np.abs(fp_out - out).max() < 0.05


def test_calibration_batches_feed_the_gate():
    rng = np.random.RandomState(11)
    batches = [rng.randn(3, 64).astype(np.float32), [rng.randn(6, 64)]]
    with _predictor(seed=12).serve(max_batch=4, max_wait_us=0,
                                   quantize='int8',
                                   calibrate=batches) as eng:
        assert 0 < eng.stats()['quantized']['parity_measured'] <= 0.05
    with pytest.raises(MXNetError, match='calibrate batch'):
        _predictor(seed=12).serve(max_batch=4, quantize='int8',
                                  calibrate=[[batches[0], batches[0]]])


def test_quant_config_resolve_and_env_default(monkeypatch):
    assert QuantConfig.resolve(None) is None
    cfg = QuantConfig.resolve('int8')
    assert isinstance(cfg, QuantConfig) and cfg.dtype == 'int8'
    assert QuantConfig.resolve(cfg) is cfg
    assert cfg.describe() == JQ.QuantConfig('int8').describe()
    assert cfg.key((1, 3)) == JQ.QuantConfig('int8').key((1, 3))
    assert cfg.est_ratio() == JQ.QuantConfig('int8').est_ratio()
    for shape in ((64, 64), (64,), (4, 4), (1024, 1)):
        assert cfg.wants(shape, np.float32) == \
            JQ.QuantConfig('int8').wants(shape, np.float32)
        assert not cfg.wants(shape, np.int32)
    for bad in ('fp8', 3):
        with pytest.raises(MXNetError):
            QuantConfig.resolve(bad)
    monkeypatch.setenv('MXNET_TPU_SERVE_QUANTIZE', 'int8')
    with _predictor(seed=10).serve(max_batch=2, max_wait_us=0) as eng:
        assert eng._quant_live
    with _predictor(seed=10).serve(max_batch=2, max_wait_us=0,
                                   quantize=False) as eng:
        assert not eng._quant_live
    for off in ('0', 'off', 'none', 'fp32'):
        monkeypatch.setenv('MXNET_TPU_SERVE_QUANTIZE', off)
        assert QuantConfig.from_env() is None
        with _predictor(seed=10).serve(max_batch=2, max_wait_us=0) as eng:
            assert not eng._quant_live


def test_quant_counters_in_summary_and_dump(tmp_path):
    profiler.clear()
    with _predictor(seed=13).serve(max_batch=4, max_wait_us=0,
                                   quantize='int8'):
        pass
    # the ladder 1, 2, 4 warmed in quantized mode
    assert profiler.quant_stats()['quant_int8_rungs_warmed'] == 3
    profiler.add_quant_stats(wire_bytes_saved=100, models_resident=1,
                             error_feedback_norm=0.5, page_ins=1,
                             paged_bytes=64)
    st = profiler.quant_stats()
    assert st['quant_models_resident'] == 1
    assert st['quant_error_feedback_norm'] == 0.5
    text = profiler.summary(print_out=False)
    for key in ('quant_models_resident', 'quant_int8_rungs_warmed',
                'quant_wire_bytes_saved', 'quant_error_feedback_norm',
                'quant_page_ins', 'quant_paged_bytes'):
        assert key in text
    profiler.profiler_set_config(filename=str(tmp_path / 'p.json'))
    profiler.profiler_set_state('run')
    profiler.profiler_set_state('stop')
    path = profiler.dump_profile()
    profiler.profiler_set_config(filename='profile.json')
    lanes = {e.get('name'): e for e in
             json.load(open(path))['traceEvents'] if e.get('ph') == 'M'}
    assert lanes['quant']['args']['quant_wire_bytes_saved'] == 100
    profiler.clear()
    assert profiler.quant_stats()['quant_models_resident'] == 0
