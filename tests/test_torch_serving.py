"""The port's Predictor and dynamic-batching InferenceEngine
(mxnet_tpu_torch/predictor.py, serving.py) on the CPU: the 20 engine
contracts of tests/test_serving.py on the port, then the port against
the JAX package.

- the contracts: coalescing under concurrency, bucket padding and
  slicing bit-equal to serial Predictor.forward, rows independent of
  what they are batched with, free-dim buckets, no rung built after
  warmup (the engine's own rung-build count), the timeout flush, shutdown, the
  Module source, the two refusals, the profiler's serving counters;
- the port's Predictor against the JAX package's on the MLP of
  tests/test_serving.py (float32, atol 1e-5) and on the cut ResNet of
  tests/test_torch_resnet.py (float32 atol 1e-5; bf16 within 0.02 in
  relative norm, as that file holds its outputs);
- the port's engine answers against the JAX engine's for the same
  requests; a checkpoint of either package served by the other's
  Predictor; the default device; each deferred argument raising;
- chip_smoke.py's gate of phase 11 on a good run and on bad ones.
"""
import importlib.util
import json
import math
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler, sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import InferenceEngine

REPO = Path(__file__).resolve().parents[1]
DIM = 6
HID = 8
OUT = 3
F32 = dict(rtol=2e-6, atol=1e-6)


def _mlp(pkg=mx):
    data = pkg.sym.Variable('data')
    fc1 = pkg.sym.FullyConnected(data, num_hidden=HID, name='fc1')
    act = pkg.sym.Activation(fc1, act_type='relu')
    return pkg.sym.FullyConnected(act, num_hidden=OUT, name='fc2')


def _params(seed=7):
    rs = np.random.RandomState(seed)
    return {
        'fc1_weight': (rs.randn(HID, DIM) * .5).astype(np.float32),
        'fc1_bias': (rs.randn(HID) * .1).astype(np.float32),
        'fc2_weight': (rs.randn(OUT, HID) * .5).astype(np.float32),
        'fc2_bias': (rs.randn(OUT) * .1).astype(np.float32),
    }


def _predictor(batch=1):
    return Predictor(symbol=_mlp(), arg_params=_params(),
                     input_shapes={'data': (batch, DIM)}, ctx=mx.cpu())


def _jax_predictor(batch=1):
    return JPredictor(symbol=_mlp(jmx), input_shapes={'data': (batch, DIM)},
                      arg_params={k: jmx.nd.array(v)
                                  for k, v in _params().items()})


def _x(rows, seed=0, dim=DIM):
    return np.random.RandomState(seed).randn(rows, dim).astype(np.float32)


def _pred_of(net, shape, params=None):
    return Predictor(symbol=net, arg_params=params or {},
                     input_shapes={'data': shape}, ctx=mx.cpu())


# ---------------------------------------------------------------------------
# the 20 contracts of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_coalesces_concurrent_requests():
    with _predictor().serve(max_batch=8, max_wait_us=300000) as eng:
        barrier = threading.Barrier(8)
        outs = [None] * 8
        xs = [_x(1, seed=i) for i in range(8)]

        def client(i):
            barrier.wait()
            outs[i] = eng.infer(xs[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        st = eng.stats()
    assert st['requests'] == 8
    assert st['batches'] <= 3
    assert st['batch_fill_avg'] > 0.5
    for i in range(8):
        solo = _predictor(batch=1).forward(data=xs[i])[0].asnumpy()
        np.testing.assert_allclose(outs[i][0], solo, **F32)


def test_oversized_request_splits():
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        x = _x(11)
        out = eng.infer(x)[0]
    assert out.shape == (11, OUT)
    ref = _predictor(batch=11).forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(out, ref, **F32)


def test_full_bucket_bit_parity_vs_serial_forward():
    x = _x(8, seed=3)
    with _predictor().serve(max_batch=8, batch_buckets=(8,),
                            max_wait_us=0) as eng:
        got = eng.infer(x)[0]
    ref = _predictor(batch=8).forward(data=x)[0].asnumpy()
    assert np.array_equal(got, ref)


def test_padded_request_bit_parity_vs_padded_serial():
    x = _x(3, seed=5)
    with _predictor().serve(max_batch=4, batch_buckets=(4,),
                            max_wait_us=0, pad_value=0.0) as eng:
        got = eng.infer(x)[0]
    assert got.shape == (3, OUT)
    xp = np.zeros((4, DIM), np.float32)
    xp[:3] = x
    ref = _predictor(batch=4).forward(data=xp)[0].asnumpy()[:3]
    assert np.array_equal(got, ref)


def test_cobatch_slicing_is_row_independent():
    x_a = _x(2, seed=11)
    x_b = _x(2, seed=12)
    with _predictor().serve(max_batch=4, batch_buckets=(4,),
                            max_wait_us=300000) as eng:
        res = {}
        barrier = threading.Barrier(2)

        def client(name, arr):
            barrier.wait()
            res[name] = eng.infer(arr)[0]

        ts = [threading.Thread(target=client, args=('a', x_a)),
              threading.Thread(target=client, args=('b', x_b))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert eng.stats()['batches'] == 1
    with _predictor().serve(max_batch=4, batch_buckets=(4,),
                            max_wait_us=0) as eng:
        solo = eng.infer(x_a)[0]
    assert np.array_equal(res['a'], solo)


def test_default_engine_requires_exact_free_dims():
    net = sym.FullyConnected(sym.Variable('data'), num_hidden=8, name='fc')
    rs = np.random.RandomState(2)
    params = {'fc_weight': rs.randn(8, 8).astype(np.float32),
              'fc_bias': np.zeros(8, np.float32)}
    pred = _pred_of(net, (1, 8), params)
    x = rs.randn(2, 8).astype(np.float32)
    with InferenceEngine(pred, max_batch=4, max_wait_us=0) as eng:
        with pytest.raises(MXNetError, match='free-dim padding'):
            eng.infer(rs.randn(2, 5).astype(np.float32))
        out = eng.infer(x)[0]
    assert out.shape == (2, 8)
    ref = _pred_of(net, (2, 8), params).forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(out, ref, **F32)


def test_free_dim_bucket_padding_and_slicing():
    net = sym.Activation(sym.Variable('data'), act_type='relu')
    pred = _pred_of(net, (1, 8))
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    with InferenceEngine(pred, max_batch=4,
                         free_dim_buckets=[((8,),), ((16,),)],
                         max_wait_us=0) as eng:
        out = eng.infer(x)[0]
    assert out.shape == (2, 5)
    assert np.array_equal(out, np.maximum(x, 0))
    with pytest.raises(MXNetError):
        with InferenceEngine(pred, max_batch=4,
                             free_dim_buckets=[((8,),), ((16,),)],
                             max_wait_us=0) as eng:
            eng.infer(np.zeros((1, 32), np.float32))


def test_free_dim_slicing_spares_fixed_output_dims():
    data = sym.Variable('data')
    net = sym.Group([sym.Activation(data, act_type='relu'),
                     sym.slice_axis(data, axis=1, begin=0, end=8)])
    pred = _pred_of(net, (1, 8))
    x = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    with InferenceEngine(pred, max_batch=4,
                         free_dim_buckets=[((8,),), ((16,),)],
                         max_wait_us=0) as eng:
        relu_out, head_out = eng.infer(x)
    assert relu_out.shape == (2, 5)
    assert np.array_equal(relu_out, np.maximum(x, 0))
    assert head_out.shape == (2, 8)
    xp = np.zeros((2, 8), np.float32)
    xp[:, :5] = x
    assert np.array_equal(head_out, xp)


def test_full_batch_in_other_group_preempts_held_deadline():
    net = sym.Activation(sym.Variable('data'), act_type='relu')
    pred = _pred_of(net, (1, 8))
    with InferenceEngine(pred, max_batch=4,
                         free_dim_buckets=[((8,),), ((16,),)],
                         max_wait_us=30000000) as eng:
        t_a = threading.Thread(
            target=lambda: eng.infer(np.zeros((1, 8), np.float32)))
        t_a.start()
        deadline = time.time() + 10
        while time.time() < deadline and \
                not any(eng._queues.values()):
            time.sleep(0.005)
        tic = time.perf_counter()
        done = []

        def b_client():
            done.append(eng.infer(np.zeros((1, 16), np.float32)))

        t_bs = [threading.Thread(target=b_client) for _ in range(4)]
        for t in t_bs:
            t.start()
        for t in t_bs:
            t.join(timeout=30)
        elapsed = time.perf_counter() - tic
        assert len(done) == 4
        assert elapsed < 10, elapsed
    t_a.join(timeout=30)
    assert not t_a.is_alive()


def test_zero_compiles_after_warmup():
    with _predictor().serve(max_batch=8, max_wait_us=0) as eng:
        for rows in (1, 2, 3, 5, 7, 8, 4, 6, 1, 8):
            eng.infer(_x(rows, seed=rows))
        st = eng.stats()
    assert st['compiles_after_warmup'] == 0
    assert st['compile_s_after_warmup'] == 0
    assert st['requests'] == 10


def test_recreated_engine_reuses_cached_programs():
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        eng.infer(_x(2))
    before = exec_cache.stats()['misses']
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        eng.infer(_x(2))
    assert exec_cache.stats()['misses'] == before


def test_an_engine_counts_its_own_rung_builds():
    # a second engine over the same graph finds every rung's program in
    # exec_cache (no miss), yet a rung it binds after warmup counts
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        eng.infer(_x(2))
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        before = exec_cache.stats()['misses']
        del eng._programs[(2, ((DIM,),))]
        out = eng.infer(_x(2, seed=3))[0]
        st = eng.stats()
        assert exec_cache.stats()['misses'] == before
    assert st['compiles_after_warmup'] == 1
    assert st['compile_s_after_warmup'] > 0
    np.testing.assert_array_equal(
        out, _predictor(batch=2).predict(_x(2, seed=3)))


def test_service_time_is_the_walk_time():
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        assert eng.service_estimate() is None
        for i in range(3):
            eng.infer(_x(4, seed=i))
        st = eng.stats()
        svc, rows = eng.service_estimate()
    assert st['service_ms_ema'] == svc > 0
    assert rows == 4.0
    # on the CPU the walk is the launch: its host time is the service
    assert svc <= st['host_ms']['launch'] * 3


def test_late_warmup_on_live_engine():
    eng = _predictor().serve(max_batch=4, max_wait_us=0, warmup=False)
    try:
        errs = []

        def traffic():
            try:
                for i in range(10):
                    eng.infer(_x(1 + i % 4, seed=i))
            except Exception as e:      # raised in the main thread
                errs.append(e)

        t = threading.Thread(target=traffic)
        t.start()
        eng.warmup()
        t.join(timeout=60)
        assert not t.is_alive() and not errs, errs
        out = eng.infer(_x(2, seed=42))[0]
        assert eng.stats()['compiles_after_warmup'] == 0
    finally:
        eng.close()
    ref = _predictor(batch=2).forward(data=_x(2, seed=42))[0].asnumpy()
    np.testing.assert_allclose(out, ref, **F32)


def test_timeout_flushes_underfull_batch():
    with _predictor().serve(max_batch=8, max_wait_us=2000) as eng:
        out = eng.infer(_x(1))
        st = eng.stats()
    assert out[0].shape == (1, OUT)
    assert st['batches'] == 1
    assert st['padded_rows'] == 0
    with _predictor().serve(max_batch=8, batch_buckets=(8,),
                            max_wait_us=2000) as eng:
        eng.infer(_x(3))
        st = eng.stats()
    assert st['padded_rows'] == 5
    assert st['pad_waste_frac'] == pytest.approx(5 / 8)


def test_close_joins_workers_and_rejects_new_work():
    eng = _predictor().serve(max_batch=4, max_wait_us=0)
    eng.infer(_x(2))
    workers = [eng._dispatcher, eng._completer]
    eng.close()
    for t in workers:
        assert not t.is_alive()
    with pytest.raises(MXNetError):
        eng.infer(_x(1))
    eng.close()


def test_close_drains_queued_requests():
    with _predictor().serve(max_batch=8, max_wait_us=100000) as eng:
        res = {}

        def client():
            res['out'] = eng.infer(_x(2))[0]

        t = threading.Thread(target=client)
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline and 'out' not in res and \
                not any(eng._queues.values()):
            time.sleep(0.005)
    t.join(timeout=30)
    assert not t.is_alive()
    assert res['out'].shape == (2, OUT)


def test_multi_input_names_out_of_graph_order():
    av = np.full((1, 4), 5.0, np.float32)
    bv = np.full((1, 4), 2.0, np.float32)

    def engine(order):
        a = sym.Variable('a')
        b = sym.Variable('b')
        mod = mx.mod.Module(a - b, data_names=order, label_names=[],
                            context=mx.cpu())
        mod.bind(data_shapes=[(n, (1, 4)) for n in order],
                 for_training=False)
        mod.init_params()
        return InferenceEngine(mod, max_batch=2, max_wait_us=0)

    with engine(('b', 'a')) as eng:
        named = eng.infer(a=av, b=bv)[0]
        pos = eng.infer(bv, av)[0]
    np.testing.assert_array_equal(named, av - bv)
    np.testing.assert_array_equal(pos, av - bv)
    with engine(('a', 'b')) as eng:
        np.testing.assert_array_equal(eng.infer(a=av, b=bv)[0], av - bv)
        np.testing.assert_array_equal(eng.infer(av, bv)[0], av - bv)


def test_batch_reducing_model_rejected():
    pred = _pred_of(sym.sum(sym.Variable('data')), (1, 4))
    with pytest.raises(MXNetError, match='row-independent'):
        InferenceEngine(pred, max_batch=4, max_wait_us=0)


def test_model_parallel_source_rejected():
    """A source whose executor is placed by ctx_group groups is refused by
    the engine, whose rung executors would collapse the placement."""
    with mx.AttrScope(ctx_group='dev1'):
        net = sym.FullyConnected(sym.Variable('data'), num_hidden=2,
                                 name='fc')
    ex = net.simple_bind(mx.cpu(), grad_req='null', data=(2, 3),
                         group2ctx={'dev1': mx.cpu(0)})
    assert ex._grouped is True
    src = types.SimpleNamespace(_executor=ex, _symbol=net, _ctx=mx.cpu(0),
                                _input_names=['data'])
    with pytest.raises(MXNetError, match='ctx_group'):
        InferenceEngine(src, max_batch=2, max_wait_us=0)


def test_engine_over_module_source():
    mod = mx.mod.Module(_mlp(), label_names=[], context=mx.cpu())
    mod.bind(data_shapes=[('data', (1, DIM))], for_training=False)
    mod.init_params()
    mod.set_params(_params(), {})
    x = _x(2, seed=9)
    with InferenceEngine(mod, max_batch=4, max_wait_us=0) as eng:
        out = eng.infer(x)[0]
    ref = _predictor(batch=2).forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(out, ref, **F32)


def test_serving_counters_in_summary_and_dump(tmp_path):
    profiler.clear()
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        eng.infer(_x(3))
        eng.infer(_x(1))
        st = eng.stats()
    sv = profiler.serving_stats()
    assert sv['serve_requests'] >= 2
    assert sv['serve_batches'] >= 2
    assert sv['serve_latency_p50_ms'] > 0
    assert sv['serve_latency_p99_ms'] >= sv['serve_latency_p50_ms']
    assert 0 <= sv['serve_pad_waste_frac'] < 1
    assert set(st['host_ms']) == {'assemble', 'stage', 'launch',
                                  'complete_copy'}
    assert st['host_ms']['launch'] > 0
    text = profiler.summary(print_out=False)
    for key in ('serve_requests', 'serve_queue_depth_avg',
                'serve_batch_fill_avg', 'serve_pad_waste_frac',
                'serve_latency_p50_ms', 'serve_latency_p99_ms'):
        assert key in text
    out = tmp_path / 'serve_profile.json'
    profiler.profiler_set_config(filename=str(out))
    profiler.dump_profile()
    profiler.profiler_set_config(filename='profile.json')
    events = json.loads(out.read_text())['traceEvents']
    meta = [e for e in events if e.get('name') == 'serving']
    assert meta and meta[0]['args']['serve_requests'] >= 2


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_predictor_matches_jax_on_the_mlp():
    x = _x(4, seed=21)
    mine = _predictor(batch=4)
    theirs = _jax_predictor(batch=4)
    np.testing.assert_allclose(mine.predict(x), theirs.predict(x),
                               rtol=0, atol=1e-5)
    mine.reshape({'data': (2, DIM)})
    theirs.reshape({'data': (2, DIM)})
    np.testing.assert_allclose(mine.predict(x[:2]), theirs.predict(x[:2]),
                               rtol=0, atol=1e-5)
    out = mine.forward(data=x[2:])
    assert mine.get_output(0) is out[0]
    np.testing.assert_allclose(out[0].asnumpy(), theirs.predict(x[2:]),
                               rtol=0, atol=1e-5)


def test_engine_answers_as_the_jax_engine():
    reqs = [_x(r, seed=30 + r) for r in (1, 3, 4, 6, 11)]
    with _jax_predictor().serve(max_batch=4, max_wait_us=0) as jeng:
        ref = [jeng.infer(x)[0] for x in reqs]
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        got = [eng.infer(x)[0] for x in reqs]
        # a request over max_batch counts once a chunk
        assert eng.stats()['requests'] == sum(-(-len(x) // 4) for x in reqs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **F32)


CUT = dict(units=[1, 1, 1, 1], num_stages=4, filter_list=[8, 32, 64, 128, 256],
           num_classes=10, image_shape=(3, 64, 64), bottle_neck=True)
CUT_BATCH = 4


def _resnet_params(symbol, seed):
    shapes = dict(data=(CUT_BATCH,) + CUT['image_shape'])
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args, auxs = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in ('data', 'softmax_label'):
            continue
        if name.endswith('_weight'):
            args[name] = rng.randn(*shape) * math.sqrt(
                2.0 / int(np.prod(shape[1:])))
        elif name.endswith('_gamma'):
            args[name] = 1.0 + 0.1 * rng.randn(*shape)
        else:
            args[name] = 0.1 * rng.randn(*shape)
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        auxs[name] = 0.1 * rng.randn(*shape) if name.endswith('_mean') \
            else 1.0 + 0.1 * rng.rand(*shape)
    return ({k: np.asarray(v, np.float32) for k, v in args.items()},
            {k: np.asarray(v, np.float32) for k, v in auxs.items()})


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_predictor_matches_jax_on_the_cut_resnet(dtype, monkeypatch):
    jsym = jresnet.resnet(dtype=dtype, **CUT)
    args, auxs = _resnet_params(jsym, seed=3)
    x = np.random.RandomState(4).randn(
        CUT_BATCH, *CUT['image_shape']).astype(np.float32)
    shapes = {'data': (CUT_BATCH,) + CUT['image_shape']}
    theirs = JPredictor(symbol=jsym, input_shapes=shapes,
                        arg_params={k: jmx.nd.array(v)
                                    for k, v in args.items()},
                        aux_params={k: jmx.nd.array(v)
                                    for k, v in auxs.items()})
    mine = Predictor(symbol=tresnet.resnet(dtype=dtype, **CUT),
                     input_shapes=shapes, arg_params=args, aux_params=auxs,
                     ctx=mx.cpu())
    ref, got = theirs.predict(x), mine.predict(x)
    assert got.shape == ref.shape == (CUT_BATCH, CUT['num_classes'])
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert _rel(got, ref) <= 0.02
    with mine.serve(max_batch=CUT_BATCH, max_wait_us=0) as eng:
        served = eng.infer(x)[0]
    np.testing.assert_array_equal(served, got)


def test_checkpoints_cross_between_the_packages(tmp_path):
    x = _x(3, seed=40)
    params = _params(seed=41)
    # the JAX package writes, the port serves
    jprefix = str(tmp_path / 'jax_mlp')
    jmx.model.save_checkpoint(jprefix, 3, _mlp(jmx),
                              {k: jmx.nd.array(v) for k, v in
                               params.items()}, {})
    ref = JPredictor.from_checkpoint(jprefix, 3, {'data': (3, DIM)}) \
        .predict(x)
    mine = Predictor.from_checkpoint(jprefix, 3, {'data': (3, DIM)},
                                     ctx=mx.cpu())
    np.testing.assert_allclose(mine.predict(x), ref, rtol=0, atol=1e-5)
    # the port writes, the JAX package serves
    tprefix = str(tmp_path / 'port_mlp')
    mx.model.save_checkpoint(tprefix, 5, _mlp(mx),
                             {k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in params.items()}, {})
    theirs = JPredictor.from_checkpoint(tprefix, 5, {'data': (3, DIM)})
    np.testing.assert_allclose(theirs.predict(x), ref, rtol=0, atol=1e-5)
    # the symbol JSON and the param blob, as the C predict API takes them
    with open(tprefix + '-symbol.json') as f:
        js = f.read()
    with open(tprefix + '-0005.params', 'rb') as f:
        blob = f.read()
    for src in ((js, blob), (tprefix + '-symbol.json',
                             tprefix + '-0005.params')):
        p = Predictor(*src, input_shapes={'data': (3, DIM)}, ctx=mx.cpu())
        np.testing.assert_allclose(p.predict(x), ref, rtol=0, atol=1e-5)


def test_predictor_binds_to_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        Predictor(symbol=_mlp(), arg_params=_params(),
                  input_shapes={'data': (1, DIM)})
    with pytest.raises(MXNetError, match='cuda'):
        Predictor(symbol=_mlp(), arg_params=_params(),
                  input_shapes={'data': (1, DIM)}, dev_type='gpu')
    with mx.cpu():
        p = Predictor(symbol=_mlp(), arg_params=_params(),
                      input_shapes={'data': (1, DIM)})
    assert p._ctx == mx.cpu()
    assert p._executor.arg_dict['fc1_weight']._data.device.type == 'cpu'


def _deferred(case, tmp_path, monkeypatch):
    pred = _predictor()
    if case == 'hot_rows':
        pred.serve(max_batch=2, hot_rows=8)
    elif case == 'hot_rows_env':
        monkeypatch.setenv('MXNET_TPU_SERVE_HOT_ROWS', '8')
        pred.serve(max_batch=2)


DEFERRED = {'hot_rows': 'no cacheable Embedding',
            'hot_rows_env': 'no cacheable Embedding'}


@pytest.mark.parametrize('case', sorted(DEFERRED))
def test_deferred_argument_raises_naming_its_roadmap_item(case, tmp_path,
                                                          monkeypatch):
    """hot_rows (argument or MXNET_TPU_SERVE_HOT_ROWS) is ported: on a
    model with no Embedding table it refuses as the JAX package's engine
    does, with the same words."""
    with pytest.raises(MXNetError, match=DEFERRED[case]):
        _deferred(case, tmp_path, monkeypatch)
    if case == 'hot_rows':
        from mxnet_tpu.serving import InferenceEngine as JEngine
        with pytest.raises(Exception, match=DEFERRED[case]):
            JEngine(_jax_predictor(), max_batch=2, hot_rows=8)


def _checkpoint(tmp_path, params):
    """An elastic checkpoint dir of a Module holding `params`."""
    mod = mx.mod.Module(mx.sym.LinearRegressionOutput(_mlp(), name='lro'),
                        context=mx.cpu(), label_names=('lro_label',))
    mod.bind(data_shapes=[('data', (2, DIM))],
             label_shapes=[('lro_label', (2, OUT))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in params.items()})
    mod.init_optimizer()
    mgr = mx.elastic.CheckpointManager(str(tmp_path), async_=False)
    d = mgr.attach(mod).save(sync=True)
    mgr.close()
    return d


@pytest.mark.parametrize('case', ['apply_delta', 'export_serving_checkpoint',
                                  'serving_state'])
def test_checkpoint_serving_feature(case, tmp_path):
    """The serving parts of Queue A item 5 that this slice's cut refused:
    a delta applied in place answers as the new weights loaded in full;
    an elastic checkpoint exports to the serving format and reads as a
    serving state."""
    x = np.random.RandomState(3).randn(2, DIM).astype(np.float32)
    new = _params(seed=8)
    if case == 'apply_delta':
        base = {'arg:' + k: v for k, v in _params().items()}
        want = {'arg:' + k: v for k, v in new.items()}
        fp = mx.delta.fingerprint(base)
        ent, meta, _ = mx.delta.make_delta(base, want, seq=1, base_fp=fp,
                                           config='raw')
        full = Predictor(symbol=_mlp(), arg_params=new, ctx=mx.cpu(),
                         input_shapes={'data': (1, DIM)})
        with _predictor().serve(max_batch=2, max_wait_us=0) as eng, \
                full.serve(max_batch=2, max_wait_us=0) as ref:
            assert eng.apply_delta(dict(ent), meta, expect_fp=fp) == \
                meta['new_fp']
            np.testing.assert_array_equal(eng.infer(x)[0], ref.infer(x)[0])
    elif case == 'export_serving_checkpoint':
        d = _checkpoint(tmp_path / 'ck', new)
        prefix = mx.serving.export_serving_checkpoint(d, _mlp(),
                                                      str(tmp_path / 'p'))
        got = Predictor.from_checkpoint(prefix, 0, {'data': (2, DIM)},
                                        ctx=mx.cpu()).predict(x)
        np.testing.assert_allclose(got, _mlp_numpy_of(new, x), rtol=1e-5,
                                   atol=1e-5)
    else:
        state = mx.serving.serving_state(_checkpoint(tmp_path / 'ck', new))
        assert sorted(state) == sorted('arg:' + k for k in new)
        for k, v in new.items():
            np.testing.assert_array_equal(state['arg:' + k], v)


def _mlp_numpy_of(p, x):
    h = np.maximum(x @ p['fc1_weight'].T + p['fc1_bias'], 0)
    return h @ p['fc2_weight'].T + p['fc2_bias']


def _mlp_numpy(x):
    p = _params()
    h = np.maximum(x @ p['fc1_weight'].T + p['fc1_bias'], 0)
    return h @ p['fc2_weight'].T + p['fc2_bias']


def test_stats_count_every_request_and_row_under_load():
    """16 threads of mixed-size requests, some over max_batch: every
    request and row is counted once, and each caller gets its own rows."""
    with _predictor().serve(max_batch=8, max_wait_us=500) as eng:
        rng = np.random.RandomState(50)
        sizes = [[int(rng.randint(1, 12)) for _ in range(4)]
                 for _ in range(16)]
        errs = []

        def client(i):
            try:
                for j, rows in enumerate(sizes[i]):
                    x = _x(rows, seed=1000 * i + j)
                    np.testing.assert_allclose(eng.infer(x)[0],
                                               _mlp_numpy(x), rtol=0,
                                               atol=1e-5)
            except Exception as e:      # raised in the main thread
                errs.append(e)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs, errs
        st = eng.stats()
    chunks = sum(-(-r // 8) for s in sizes for r in s)
    assert st['requests'] == chunks
    assert st['rows'] == sum(map(sum, sizes))
    assert st['backlog_rows'] == 0
    assert 0 < st['batch_fill_avg'] <= 1


def test_backlog_and_service_estimate():
    with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
        assert eng.service_estimate() is None
        assert eng.backlog_rows() == 0
        eng.infer(_x(3))
        svc, rows = eng.service_estimate()
        assert svc >= 0 and rows == 3.0
        eng.infer(_x(1))
        assert eng.service_estimate()[1] == pytest.approx(3 + 0.25 * (1 - 3))
        assert eng.backlog_rows() == 0
        assert eng.stats()['rows_per_batch_ema'] == eng.service_estimate()[1]


def test_stage_and_complete_spans_are_recorded(tmp_path):
    profiler.clear()
    profiler.profiler_set_config(filename=str(tmp_path / 'serve.json'))
    profiler.profiler_set_state('run')
    try:
        with _predictor().serve(max_batch=4, max_wait_us=0) as eng:
            eng.infer(_x(2))
            eng.infer(_x(4))
    finally:
        profiler.profiler_set_state('stop')
    events = json.loads(open(profiler.dump_profile()).read())['traceEvents']
    profiler.profiler_set_config(filename='profile.json')
    spans = [e['name'] for e in events
             if e.get('ph') == 'X' and e.get('cat') == 'serving']
    assert spans.count('serve_stage') == 2
    assert spans.count('serve_complete') == 2


@pytest.mark.parametrize('args', [
    (100.0, 2.0), (100.0, 2.0, 8), (10.0, 50.0), (0.0, 1.0, 4),
    (1000.0, 0.001, 16)])
def test_chunk_for_deadline_matches_jax(args, monkeypatch):
    from mxnet_tpu import serving as jserving
    for frac in ('', '0.5', 'bogus'):
        monkeypatch.setenv('MXNET_TPU_SERVE_WAIT_FRACTION', frac)
        assert mx.serving.chunk_for_deadline(*args) == \
            jserving.chunk_for_deadline(*args)


@pytest.mark.parametrize('value,slots', [
    (None, None), (0, 8), (1, 8), (4, 8), ('off', None), ('3', 4),
    ('auto', 8), (9, 8), (-1, None), ('x', None), (2.5, None)])
def test_resolve_tick_chunk_matches_jax(value, slots, monkeypatch):
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.base import MXNetError as JError
    monkeypatch.delenv('MXNET_TPU_SERVE_TICK_CHUNK', raising=False)
    slo = types.SimpleNamespace(deadline_ms=40.0)
    for kw in ({}, dict(slo=slo, tick_ms_hint=5.0)):
        try:
            want = jserving.resolve_tick_chunk(value, slots, **kw)
        except JError:
            with pytest.raises(MXNetError, match='MXNET_TPU_SERVE_TICK'):
                mx.serving.resolve_tick_chunk(value, slots, **kw)
            continue
        assert mx.serving.resolve_tick_chunk(value, slots, **kw) == want


def test_pad_and_slice_helpers_match_jax():
    from mxnet_tpu import serving as jserving
    rng = np.random.RandomState(60)
    reqs = []
    for rows, free in ((2, ((5,),)), (3, ((8,),)), (1, ((7,),))):
        reqs.append(jserving._Request([rng.randn(rows, *free[0])], rows,
                                      free))
    entry = ((8,),)
    assert mx.serving._pad_elem_frac(reqs, entry) == \
        jserving._pad_elem_frac(reqs, entry)
    out = rng.randn(4, 8, 3).astype(np.float32)
    prog = types.SimpleNamespace(free_shapes=entry, batch=4)
    for mirror in (None, [(True, False)], [(False, False)]):
        for r, off in zip(reqs, (0, 1, 2)):
            np.testing.assert_array_equal(
                mx.serving._slice_out(out, off, r, prog, mirror),
                jserving._slice_out(out, off, r, prog, mirror))


def test_source_parts_take_a_predictor_or_a_bound_module():
    pred = _predictor()
    ex, symbol, ctx, names = mx.serving._source_parts(pred)
    assert ex is pred._executor and ctx == mx.cpu() and names == ['data']
    mod = mx.mod.Module(_mlp(), label_names=[], context=mx.cpu())
    with pytest.raises(MXNetError, match='Predictor or a bound Module'):
        mx.serving._source_parts(mod)
    mod.bind(data_shapes=[('data', (2, DIM))], for_training=False)
    ex, symbol, ctx, names = mx.serving._source_parts(mod)
    assert ex is mod._exec_group.executor and names == ['data']


# ---------------------------------------------------------------------------
# chip_smoke.py's gate of phase 11
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _passing_serve_run(cs):
    engine = dict(requests=cs.SERVE_CLIENTS * cs.SERVE_REQUESTS,
                  rows=1280, batch_fill_avg=0.83, pad_waste_frac=0.1,
                  compiles_after_warmup=0, compile_s_after_warmup=0.0,
                  answered_requests=cs.SERVE_CLIENTS * cs.SERVE_REQUESTS,
                  answered_rows=1280, wrong_rows=[], latency_p50_ms=9.0,
                  latency_p99_ms=30.0, max_rel_err_vs_serial=0.0136)
    return dict(
        default_device='cuda:0', sent_rows=1280,
        bf16=dict(engine), module=dict(engine),
        float32=dict(requests=128, rows=320, wrong_rows=[],
                     max_rel_err_vs_serial=1e-6),
        int8=dict(engine, parity_measured=0.01, parity_tol=0.05,
                  quant_bytes=25_000_000, bf16_bytes=50_000_000,
                  scale_bytes=100_000, quant_names=54),
        full_bucket_equal=True, padded_equal=True, row_independent=True,
        split_equal=True, module_max_abs_diff=0.0, closed_joined=True,
        closed_refuses=True, nn_ops=[dict(op='LRN', ok=True)],
        launches=dict(conv=0, flash_fwd=0, flash_bwd_dkdv=0,
                      flash_bwd_dq=0))


def test_phase11_checkpoint_is_well_conditioned():
    """At 64x64 on the CPU: the plain seeded ResNet-50 (residual scale 1)
    is moved far by bf16 rounding; phase 11's (SERVE_RESIDUAL_SCALE) is
    moved within the int8 gate's tolerance, its softmax unsaturated."""
    cs = _chip_smoke()
    plain, served = (cs.serve_conditioning(mx, (3, 64, 64), mx.cpu(), s)
                     for s in (1.0, cs.SERVE_RESIDUAL_SCALE))
    assert plain['bf16_rel_diff'] > 0.1, plain
    assert served['bf16_rel_diff'] < 0.05, served
    assert served['max_prob'] < 0.5 and served['top_classes'] > 1, served


def test_phase11_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = _passing_serve_run(cs)
    assert cs.serving_gate(run) == []
    # rows swapped between requests: answers that are another's
    swapped = dict(run, bf16=dict(run['bf16'], wrong_rows=[(3, 17)]))
    assert any('rows' in m for m in cs.serving_gate(swapped))
    assert cs.serving_gate(dict(run, row_independent=False))
    # a rung built after warmup
    built = dict(run, module=dict(run['module'], compiles_after_warmup=1))
    assert any('after warmup' in m for m in cs.serving_gate(built))
    # a fill over 1
    overfull = dict(run, bf16=dict(run['bf16'], batch_fill_avg=1.2))
    assert any('fill' in m for m in cs.serving_gate(overfull))
    # an int8 engine that misses its bytes
    fat = dict(run, int8=dict(run['int8'], quant_bytes=30_000_000))
    assert any('bytes' in m for m in cs.serving_gate(fat))
    loose = dict(run, int8=dict(run['int8'], parity_measured=0.2))
    assert any('parity' in m for m in cs.serving_gate(loose))
    # a rung's answers that drift from the serial forward, yet stay
    # nearest their own rows
    for name in ('bf16', 'module', 'int8', 'float32'):
        drift = dict(run, **{name: dict(run[name],
                                        max_rel_err_vs_serial=0.2)})
        assert any('serial forward' in m for m in cs.serving_gate(drift))
    lost = dict(run, bf16=dict(run['bf16'], requests=511))
    assert any('counted' in m for m in cs.serving_gate(lost))
    for key in ('full_bucket_equal', 'padded_equal', 'split_equal',
                'closed_joined', 'closed_refuses'):
        assert cs.serving_gate(dict(run, **{key: False})), key
    assert cs.serving_gate(dict(run, default_device='cpu'))
    assert cs.serving_gate(dict(run, module_max_abs_diff=0.5))
    assert cs.serving_gate(dict(run, nn_ops=[dict(op='LRN', ok=False)]))
    assert cs.serving_gate(dict(run, nn_ops=[]))
    launched = dict(run, launches=dict(run['launches'], conv=33))
    assert any('conv' in m for m in cs.serving_gate(launched))
