"""The port's weight deltas against the JAX package's, on the CPU.

- fingerprints are equal for the same state, bfloat16 included;
- make_delta gives the same entries (names, dtypes, bytes) and the same
  meta (kinds, crcs, fingerprints, sizes, the int8 codes and scales) for
  rows, int8 and raw deltas, and either package applies the other's
  deltas to the same bits;
- a delta payload written by either package's shard-file writer reads
  back through the other's read_delta_file;
- the gates: a fingerprint or sequence mismatch raises DeltaChainError,
  a lossy delta over its tolerance DeltaParityError, nothing changed;
- the serving side: InferenceEngine.apply_delta, the registry's
  apply_delta on a resident model and on a paged int8 image, and
  serving_state / export_serving_checkpoint, each against a full load.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import ml_dtypes

from mxnet_tpu import delta as jdelta
from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _hostarray as ha
from mxnet_tpu_torch import delta, elastic


def _bf16(x):
    j = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return j, ha.host(j)


def _states(seed=0):
    """(JAX base, JAX current, port base, port current): a table with a
    few touched rows, a dense matrix changed everywhere, a small vector,
    an int array, a bf16 table and a bf16 dense matrix."""
    rng = np.random.RandomState(seed)
    table = rng.randn(256, 8).astype(np.float32)
    table2 = table.copy()
    table2[[3, 17, 40]] += 1.5
    dense = rng.randn(40, 40).astype(np.float32)
    dense2 = dense + rng.randn(40, 40).astype(np.float32) * 1e-2
    small = rng.randn(5).astype(np.float32)
    small2 = small * 2
    ints = np.arange(10, dtype=np.int32)
    bt, bt2 = rng.randn(32, 40).astype(np.float32), None
    bt2 = bt.copy()
    bt2[[1, 2]] -= 0.5
    bd = rng.randn(48, 32).astype(np.float32)
    bd2 = bd + rng.randn(48, 32).astype(np.float32) * 0.05
    jb = {'table': table, 'dense': dense, 'small': small, 'ints': ints,
          'bf_table': _bf16(bt)[0], 'bf_dense': _bf16(bd)[0],
          'same': dense}
    jc = {'table': table2, 'dense': dense2, 'small': small2, 'ints': ints,
          'bf_table': _bf16(bt2)[0], 'bf_dense': _bf16(bd2)[0],
          'same': dense}
    tb = dict(jb, bf_table=_bf16(bt)[1], bf_dense=_bf16(bd)[1])
    tc = dict(jc, bf_table=_bf16(bt2)[1], bf_dense=_bf16(bd2)[1])
    return jb, jc, tb, tc


def _key(a):
    a = ha.host(a)
    return ha.dtype_name(a), tuple(a.shape), ha.raw_bytes(a).tobytes()


def test_fingerprints_are_equal():
    jb, jc, tb, tc = _states()
    assert delta.fingerprint(tb) == jdelta.fingerprint(jb)
    assert delta.fingerprint(tc) == jdelta.fingerprint(jc)
    assert delta.fingerprint(tb) != delta.fingerprint(tc)
    assert delta.state_nbytes(tb) == jdelta.state_nbytes(jb)


@pytest.mark.parametrize('dense', ['int8', 'raw'])
def test_make_delta_equals_the_jax_package(dense):
    jb, jc, tb, tc = _states()
    fp = jdelta.fingerprint(jb)
    jent, jmeta, jnew = jdelta.make_delta(jb, jc, seq=1, base_fp=fp,
                                          config=jdelta.DeltaConfig(
                                              dense=dense))
    tent, tmeta, tnew = delta.make_delta(tb, tc, seq=1, base_fp=fp,
                                         config=delta.DeltaConfig(
                                             dense=dense))
    assert tmeta == jmeta
    assert [n for n, _ in tent] == [n for n, _ in jent]
    for (n, a), (_, b) in zip(tent, jent):
        assert _key(a) == _key(b), n
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        assert _key(tnew[k]) == _key(jnew[k]), k
    kinds = {n: e['kind'] for n, e in tmeta['entries'].items()}
    assert kinds['table'] == 'rows' and kinds['bf_table'] == 'rows'
    assert kinds['small'] == 'raw' and 'same' not in kinds
    assert kinds['dense'] == ('int8' if dense == 'int8' else 'rows')
    # bfloat16 rides the exact kinds, as in the JAX package
    assert kinds['bf_dense'] == 'rows'


@pytest.mark.parametrize('dense', ['int8', 'raw'])
def test_each_package_applies_the_others_delta(dense, tmp_path):
    jb, jc, tb, tc = _states(seed=1)
    fp = jdelta.fingerprint(jb)
    jent, jmeta, jnew = jdelta.make_delta(
        jb, jc, seq=1, base_fp=fp, config=jdelta.DeltaConfig(dense=dense))
    tent, tmeta, tnew = delta.make_delta(
        tb, tc, seq=1, base_fp=fp, config=delta.DeltaConfig(dense=dense))
    # the payloads through each other's files
    jelastic.write_shard_file(str(tmp_path / 'j.bin'), jent)
    elastic.write_shard_file(str(tmp_path / 't.bin'), tent)
    assert (tmp_path / 'j.bin').read_bytes() == \
        (tmp_path / 't.bin').read_bytes()
    got = delta.apply_delta(tb, jmeta,
                            delta.read_delta_file(str(tmp_path / 'j.bin')),
                            expect_fp=fp, expect_seq=1)
    back = jdelta.apply_delta(jb, tmeta,
                              jdelta.read_delta_file(str(tmp_path /
                                                         't.bin')),
                              expect_fp=fp, expect_seq=1)
    for k in jnew:
        assert _key(got[k]) == _key(jnew[k]), k
        assert _key(back[k]) == _key(tnew[k]), k
    assert delta.fingerprint(got) == jmeta['new_fp']


def test_encoder_chain_and_gates():
    jb, jc, tb, tc = _states(seed=2)
    enc = delta.DeltaEncoder(tb, config='raw')
    jenc = jdelta.DeltaEncoder(jb, config='raw')
    assert enc.fp == jenc.fp
    ent, meta = enc.encode(tc)
    jent, jmeta = jenc.encode(jc)
    assert meta == jmeta and enc.seq == 1
    arrays = dict(ent)
    with pytest.raises(delta.DeltaChainError, match='fingerprint'):
        delta.apply_delta(tb, meta, arrays, expect_fp='0' * 16)
    with pytest.raises(delta.DeltaChainError, match='seq'):
        delta.apply_delta(tb, meta, arrays, expect_seq=2)
    wrong = dict(tb, table=tb['table'] + 1)
    with pytest.raises(delta.DeltaChainError, match='crc'):
        delta.apply_delta(wrong, meta, arrays)
    lossy = dict(meta, rel_err=0.5)
    with pytest.raises(delta.DeltaParityError):
        delta.apply_delta(tb, lossy, arrays, parity_tol=0.1)
    with pytest.raises(mx.MXNetError, match='rebase'):
        delta.make_delta(tb, dict(tc, extra=np.ones(2)), 1, 'x')
    assert enc.rebase(tc) == delta.fingerprint(tc) and enc.seq == 0


def test_nan_int8_delta_is_refused_by_the_parity_gate():
    """One NaN element in an int8 delta's current value. The JAX
    package's encoder drops the NaN relative error (max(0.0, nan) is
    0.0), so its 0.05 parity gate passes the delta and every applied
    element is NaN; the port records rel_err inf and the gate raises
    DeltaParityError."""
    rng = np.random.RandomState(0)
    base = {'w': rng.randn(4096).astype(np.float32)}
    cur = {'w': base['w'] + 0.01 * rng.randn(4096).astype(np.float32)}
    cur['w'][1234] = np.nan
    jent, jmeta, _ = jdelta.make_delta(base, cur, seq=1, base_fp='b')
    assert jmeta['entries']['w']['kind'] == 'int8'
    assert jmeta['rel_err'] == 0.0
    applied = jdelta.apply_delta(base, jmeta, dict(jent), parity_tol=0.05)
    assert np.isnan(applied['w']).all()
    ent, meta, _ = delta.make_delta(base, cur, seq=1, base_fp='b')
    assert meta['entries']['w']['kind'] == 'int8'
    assert meta['rel_err'] == float('inf')
    assert meta['entries']['w']['rel_err'] == float('inf')
    with pytest.raises(delta.DeltaParityError):
        delta.apply_delta(base, meta, dict(ent), parity_tol=0.05)


# -- serving ---------------------------------------------------------------

def _mlp():
    data = mx.sym.Variable('data')
    fc1 = mx.sym.FullyConnected(data, name='fc1', num_hidden=32)
    act = mx.sym.Activation(fc1, act_type='relu')
    return mx.sym.FullyConnected(act, name='fc2', num_hidden=40)


def _weights(seed):
    rng = np.random.RandomState(seed)
    return {'fc1_weight': rng.randn(32, 16).astype(np.float32) * 0.3,
            'fc1_bias': rng.randn(32).astype(np.float32) * 0.1,
            'fc2_weight': rng.randn(40, 32).astype(np.float32) * 0.3,
            'fc2_bias': rng.randn(40).astype(np.float32) * 0.1}


def _serving_delta(a, b):
    base = {'arg:' + k: v for k, v in a.items()}
    new = {'arg:' + k: v for k, v in b.items()}
    fp = delta.fingerprint(base)
    ent, meta, _ = delta.make_delta(base, new, seq=1, base_fp=fp,
                                    config=delta.DeltaConfig(dense='raw'))
    return dict(ent), meta, fp


def _predictor(w):
    return mx.predictor.Predictor(
        symbol=_mlp(), input_shapes={'data': (2, 16)}, ctx=mx.cpu(),
        arg_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in w.items()})


def test_engine_apply_delta_answers_as_a_full_load():
    a, b = _weights(3), _weights(4)
    b['fc1_bias'] = a['fc1_bias']          # untouched: not in the delta
    ent, meta, fp = _serving_delta(a, b)
    x = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    with _predictor(a).serve(max_batch=2, max_wait_us=0) as eng, \
            _predictor(b).serve(max_batch=2, max_wait_us=0) as full:
        before = eng.infer(x)[0]
        with pytest.raises(delta.DeltaChainError):
            eng.apply_delta(ent, meta, expect_fp='f' * 16)
        np.testing.assert_array_equal(eng.infer(x)[0], before)
        assert eng.apply_delta(ent, meta, expect_fp=fp) == meta['new_fp']
        np.testing.assert_array_equal(eng.infer(x)[0], full.infer(x)[0])
        assert eng.stats()['compiles_after_warmup'] == 0


def _checkpoint_dir(tmp_path, w):
    """An elastic checkpoint of an MLP Module holding weights `w`."""
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(_mlp(), name='softmax'),
                        context=mx.cpu())
    mod.bind(data_shapes=[('data', (2, 16))],
             label_shapes=[('softmax_label', (2,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in w.items()})
    mod.init_optimizer()
    mgr = elastic.CheckpointManager(str(tmp_path), async_=False).attach(mod)
    d = mgr.save(sync=True)
    mgr.close()
    return d


def test_serving_state_and_export(tmp_path):
    w = _weights(6)
    d = _checkpoint_dir(tmp_path / 'ck', w)
    state = mx.serving.serving_state(d)
    assert sorted(state) == sorted('arg:' + k for k in w)
    for k, v in w.items():
        np.testing.assert_array_equal(state['arg:' + k], v)
    prefix = str(tmp_path / 'exported')
    assert mx.serving.export_serving_checkpoint(
        d, mx.sym.SoftmaxOutput(_mlp(), name='softmax'), prefix, 3) == prefix
    _, args, auxs = mx.model.load_checkpoint(prefix, 3, ctx=mx.cpu())
    for k, v in w.items():
        np.testing.assert_array_equal(args[k].asnumpy(), v)
    with pytest.raises(mx.MXNetError):
        mx.serving.serving_state(str(tmp_path / 'nothing'))


@pytest.mark.parametrize('where', ['resident', 'paged'])
def test_registry_apply_delta(where, tmp_path):
    a, b = _weights(7), _weights(8)
    ent, meta, fp = _serving_delta(a, b)
    x = np.random.RandomState(9).randn(1, 16).astype(np.float32)
    for name, w in (('a', a), ('b', b)):
        mx.model.save_checkpoint(str(tmp_path / name), 0, _mlp(),
                                 {k: mx.nd.array(v, ctx=mx.cpu())
                                  for k, v in w.items()}, {})
    from mxnet_tpu_torch.serving_fleet import ModelRegistry
    with ModelRegistry(ctx=mx.cpu()) as reg:
        for name in ('m', 'ref'):
            reg.register(name, prefix=str(tmp_path / ('a' if name == 'm'
                                                      else 'b')),
                         input_shapes={'data': (1, 16)}, max_batch=1,
                         max_wait_us=0, page_dtype='int8')
        reg.infer('m', x)
        if where == 'paged':
            reg.evict('m')
            assert reg._entry('m').paged is not None
        assert reg.apply_delta('m', ent, meta, expect_fp=fp) == \
            meta['new_fp']
        got = reg.infer('m', x)[0]
        if where == 'paged':
            # the image requantized the new weights: as the reference
            # model paged in from its own int8 image
            reg.infer('ref', x)
            reg.evict('ref')
        np.testing.assert_array_equal(got, reg.infer('ref', x)[0])
