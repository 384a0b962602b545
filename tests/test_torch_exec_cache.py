"""The port's program cache (mxnet_tpu_torch/exec_cache.py) against the
JAX package's mxnet_tpu/exec_cache.py, on the CPU: the ladders and the
cache keys equal for the same inputs, the graph signature equal but for
the knobs each package's executor reads, and the cache's counting of
rung builds (a hit on an equivalent executor, a miss on a new shape)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx
from mxnet_tpu import exec_cache as jcache

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache as tcache


@pytest.mark.parametrize('max_batch,min_batch', [(1, 1), (8, 1), (32, 1),
                                                 (12, 1), (33, 4), (5, 8)])
def test_batch_ladder_matches_jax(max_batch, min_batch):
    assert tcache.batch_ladder(max_batch, min_batch) == \
        jcache.batch_ladder(max_batch, min_batch)


def test_batch_ladder_refuses_what_jax_refuses():
    for mod in (tcache, jcache):
        with pytest.raises(ValueError):
            mod.batch_ladder(0)


@pytest.mark.parametrize('keys', [[8, 2, 4, 2], [(4, 8), (2, 16), (4, 8)],
                                  [5]])
def test_train_ladder_and_rungs_match_jax(keys):
    mine, theirs = tcache.train_ladder(keys), jcache.train_ladder(keys)
    assert mine == theirs
    probes = [1, 3, 8, 9, (2, 8), (3, 16), (4, 9), (1, 1, 1)]
    for key in probes:
        assert tcache.ladder_rung(mine, key) == \
            jcache.ladder_rung(theirs, key), key
    for mod in (tcache, jcache):
        with pytest.raises(ValueError):
            mod.train_ladder([])


def test_keys_match_jax():
    sig = ('cpu(0)', ('node',), ((1, 0),), (), ('none',))
    for args in ((sig,), (sig, ('b', 'a')), (sig, ('data',), ('quant', 1)),
                 (sig, ('data',), None, (('w', 8),))):
        assert tcache.serve_step_key(*args) == jcache.serve_step_key(*args)
    assert tcache.embed_plan_key([0, 3], [100, 50], [8, 4]) == \
        jcache.embed_plan_key([0, 3], [100, 50], [8, 4])
    assert tcache.embed_plan_key([1], [9], [2], rungs=[4, 8]) == \
        jcache.embed_plan_key([1], [9], [2], rungs=[4, 8])
    for kw in ({}, dict(chunk=4), dict(width=2), dict(chunk=16, width=1)):
        assert tcache.cont_step_key(sig, 'cont_step', 'data', ['h', 'c'],
                                    [1, 2], **kw) == \
            jcache.cont_step_key(sig, 'cont_step', 'data', ['h', 'c'],
                                 [1, 2], **kw)
    assert tcache.gluon_step_key('fp', ('k',), 'bulk', 4, 'dev') == \
        jcache.gluon_step_key('fp', ('k',), 'bulk', 4, 'dev')


def _net(pkg):
    data = pkg.sym.Variable('data')
    x = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                            name='conv')
    x = pkg.sym.BatchNorm(x, name='bn')
    x = pkg.sym.FullyConnected(x, num_hidden=3, name='fc')
    return pkg.sym.SoftmaxOutput(x, name='softmax')


def test_graph_signature_matches_jax_but_for_the_env_knobs():
    mine = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    theirs = _net(jmx).simple_bind(jmx.cpu(), data=(2, 3, 5, 5))._sig
    assert mine[:4] == theirs[:4]
    # remat, MXNET_TPU_LAYOUT_OPT and MXNET_TPU_STEM_SPLIT, as the JAX
    # package's; its conv layout knob has no counterpart
    assert mine[4] == ('none', 'auto', '1') == theirs[4][:3]


def test_signature_ignores_names_and_keys_shapes_and_dtypes():
    a = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    b = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    c = _net(mx).simple_bind(mx.cpu(), data=(4, 3, 5, 5))._sig
    d = _net(mx).simple_bind(mx.cpu(), type_dict={'data': 'float16'},
                             data=(2, 3, 5, 5))._sig
    assert a == b and a != c and a != d


def test_signature_keys_the_layout_knob(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    on = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '0')
    off = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    assert on != off


def test_serve_key_of_a_bind_finds_its_program():
    sig = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    tcache.clear()
    tcache.put(tcache.serve_step_key(sig, ('data',)), 'prog')
    again = _net(mx).simple_bind(mx.cpu(), data=(2, 3, 5, 5))._sig
    assert tcache.get(tcache.serve_step_key(again, ('data',)),
                      count=True) == 'prog'
    assert tcache.get(tcache.serve_step_key(again, ('label',))) is None
    assert tcache.stats()['hits'] == 1
    tcache.clear()


def test_cache_counts_lookups_and_bounds_its_size(monkeypatch):
    tcache.clear()
    assert tcache.get('k', count=True) is None
    tcache.put('k', 1)
    assert tcache.get('k', count=True) == 1
    assert tcache.get('k') == 1              # not counted
    st = tcache.stats()
    assert (st['hits'], st['misses']) == (1, 1)
    monkeypatch.setattr(tcache, 'MAX_ENTRIES', 2)
    for i in range(4):
        tcache.put(('k', i), i)
    assert tcache.size() == 2
    assert tcache.get(('k', 0)) is None and tcache.get(('k', 3)) == 3
    tcache.clear()
    assert tcache.size() == 0 and tcache.stats()['misses'] == 0


def test_timed_jit_bills_only_the_first_call():
    tcache.clear()
    calls = []
    fn = tcache.TimedJit(lambda x: calls.append(x) or x + 1)
    assert fn(1) == 2
    first = tcache.stats()['total_compile_s']
    assert first > 0
    assert fn(2) == 3 and calls == [1, 2]
    assert tcache.stats()['total_compile_s'] == first
    tcache.clear()


def test_profiler_exposes_the_counters():
    tcache.clear()
    tcache.get('missing', count=True)
    st = mx.profiler.exec_cache_stats()
    assert st == {'exec_cache_hits': 0, 'exec_cache_misses': 1,
                  'total_compile_s': 0.0}
    assert 'exec_cache_misses=1' in mx.profiler.summary(print_out=False)
    tcache.clear()
    np.testing.assert_equal(tcache.size(), 0)
