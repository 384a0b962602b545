"""The port's BucketingModule against the JAX package's, on the CPU,
following tests/test_bucketing_fused.py case by case at its sizes: the
per-position LM (Embedding -> FullyConnected -> SoftmaxOutput with
use_ignore) over sequence-length buckets.

- The ladder: a batch padded up to its rung (data pad_value, labels
  mask_label) gives the unpadded run's gradients (atol 2e-6), masked
  metric (1e-4) and update trajectory (2e-6); the rung mapping and its
  errors; one FusedSGD state shared by every rung.
- The warm-up: every rung's programs built at init_optimizer, none by
  the steps after it (exec_cache's counters and the profiler's per-rung
  'compiles'), a re-created module finding them all, and no state
  changed by it.
- bulk_step: one dispatch for K steps of a rung, within 1e-5 of the
  per-step loop (Perplexity within 1e-3); fit(bulk=K) over rung-grouped
  batches against the per-batch fit.
- Checkpoints across rungs, the monitor on later buckets, allow_extra,
  the masked device folds and the bucketing counters.
- The port against the JAX package over a mixed-length run: parameters
  within rtol 1e-4 / atol 1e-5 (test_module.py's bound).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import exec_cache, profiler
from mxnet_tpu_torch.base import MXNetError

VOCAB = 12
EMBED = 6
BATCH = 4
MASK = 0
PARAMS = dict(rtol=1e-4, atol=1e-5)


def sym_gen_of(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.Variable('data')
        label = pkg.sym.Variable('softmax_label')
        emb = pkg.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                name='embed')
        h = pkg.sym.Reshape(emb, shape=(-1, EMBED))
        fc = pkg.sym.FullyConnected(h, num_hidden=VOCAB, name='pred')
        lab = pkg.sym.Reshape(label, shape=(-1,))
        out = pkg.sym.SoftmaxOutput(fc, label=lab, use_ignore=True,
                                    ignore_label=MASK, name='softmax')
        return out, ('data',), ('softmax_label',)
    return sym_gen


def _desc(pkg, name, seq_len):
    return pkg.io.DataDesc(name, (BATCH, seq_len), layout='NT')


@pytest.fixture(scope='module')
def start():
    """The JAX module's Xavier-initialised weights, as numpy."""
    mod = jmx.mod.Module(sym_gen_of(jmx)(8)[0], context=jmx.cpu())
    mod.bind([('data', (BATCH, 8))], [('softmax_label', (BATCH, 8))])
    mod.init_params(jmx.init.Xavier())
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def make_module(start, ladder=None, warmup=None, default_key=8, pkg=mx,
                sched=None):
    ctx = pkg.cpu()
    mod = pkg.mod.BucketingModule(sym_gen_of(pkg),
                                  default_bucket_key=default_key,
                                  bucket_ladder=ladder, mask_label=MASK,
                                  warmup_buckets=warmup, context=ctx)
    mod.bind(data_shapes=[_desc(pkg, 'data', default_key)],
             label_shapes=[_desc(pkg, 'softmax_label', default_key)])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in start.items()})
    opt = {'learning_rate': 0.1, 'momentum': 0.9}
    if sched is not None:
        opt['lr_scheduler'] = sched
    mod.init_optimizer(optimizer_params=opt)
    return mod


def make_batch(seq_len, seed=0, pkg=mx):
    rs = np.random.RandomState(100 * seed + seq_len)
    X = rs.randint(1, VOCAB, (BATCH, seq_len)).astype(np.float32)
    y = np.roll(X, -1, axis=1)
    y[:, -1] = MASK
    ctx = pkg.cpu()
    return pkg.io.DataBatch(
        [pkg.nd.array(X, ctx=ctx)], [pkg.nd.array(y, ctx=ctx)],
        bucket_key=seq_len,
        provide_data=[_desc(pkg, 'data', seq_len)],
        provide_label=[_desc(pkg, 'softmax_label', seq_len)])


def params_np(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def max_param_diff(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


# -- pad-to-rung masked parity -----------------------------------------------

def test_padded_grad_and_update_parity(start):
    padded = make_module(start, ladder=[8])     # L=5 runs at rung 8
    exact = make_module(start)                  # L=5 binds its own bucket
    b = make_batch(5, seed=3)
    padded.forward(b, is_train=True)
    padded.backward()
    exact.forward(b, is_train=True)
    exact.backward()
    gp = padded._buckets[8]._exec_group.executor
    ge = exact._buckets[5]._exec_group.executor
    for name in gp.grad_dict:
        np.testing.assert_allclose(
            gp.grad_dict[name].asnumpy(), ge.grad_dict[name].asnumpy(),
            atol=2e-6, err_msg='grad mismatch for %s' % name)
    mp = mx.metric.Perplexity(ignore_label=MASK)
    me = mx.metric.Perplexity(ignore_label=MASK)
    padded.update_metric(mp, b.label)
    exact.update_metric(me, b.label)
    assert abs(mp.get()[1] - me.get()[1]) < 1e-4
    for i, seq_len in enumerate((5, 3, 8, 6, 5)):
        bb = make_batch(seq_len, seed=i)
        padded.forward_backward(bb)
        padded.update()
        exact.forward_backward(bb)
        exact.update()
    assert max_param_diff(params_np(padded), params_np(exact)) < 2e-6


def test_shared_optimizer_state_across_rungs(start):
    padded = make_module(start, ladder=[4, 8])
    exact = make_module(start)
    for i, seq_len in enumerate((3, 8, 4, 7, 2, 8)):
        bb = make_batch(seq_len, seed=i)
        padded.forward_backward(bb)
        padded.update()
        exact.forward_backward(bb)
        exact.update()
    fus = set(id(m._fused_updater) for m in padded._buckets.values())
    assert len(fus) == 1, 'rungs must share one fused updater'
    # and one copy of the weights
    e4 = padded._buckets[4]._exec_group.executor
    e8 = padded._buckets[8]._exec_group.executor
    assert all(e4.arg_dict[n] is e8.arg_dict[n]
               for n in ('embed_weight', 'pred_weight', 'pred_bias'))
    sp = padded._buckets[8]._fused_updater
    se = exact._buckets[8]._fused_updater
    for name in sp.states:
        np.testing.assert_allclose(
            np.asarray(sp.states[name]), np.asarray(se.states[name]),
            atol=2e-6, err_msg='momentum mismatch for %s' % name)


def test_rung_mapping_and_errors(start):
    mod = make_module(start, ladder=[4, 8])
    assert mod._rung_for(4) == 4 and mod._rung_for(8) == 8
    assert mod._rung_for(3) == 4 and mod._rung_for(5) == 8
    with pytest.raises(MXNetError):
        mod._rung_for(9)
    lad = exec_cache.train_ladder([(4, 6), (8, 12)])
    assert exec_cache.ladder_rung(lad, (3, 5)) == (4, 6)
    assert exec_cache.ladder_rung(lad, (9, 2)) is None
    with pytest.raises(MXNetError):
        mod._rung_for((2, 3))
    nomask = mx.mod.BucketingModule(sym_gen_of(mx), default_bucket_key=8,
                                    bucket_ladder=[8], context=mx.cpu())
    nomask.bind(data_shapes=[_desc(mx, 'data', 8)],
                label_shapes=[_desc(mx, 'softmax_label', 8)])
    with pytest.raises(MXNetError):
        nomask._rung_for(5)
    # a padded batch's shapes, and its pad accounting
    b = mod._map_batch(make_batch(3))
    assert b.bucket_key == 4 and b.data[0].shape == (BATCH, 4)
    assert (b.label[0].asnumpy()[:, 3] == MASK).all()


# -- warm-up -----------------------------------------------------------------

def test_ladder_warmup_builds_nothing_after_it(start):
    mod = make_module(start, ladder=[4, 8], warmup=True)
    assert sorted(mod._buckets) == [4, 8]
    s0 = exec_cache.stats()
    b0 = profiler.bucketing_stats()
    for i, seq_len in enumerate((3, 4, 8, 5, 7, 4, 8, 2)):
        mod.forward_backward(make_batch(seq_len, seed=i))
        mod.update()
    s1 = exec_cache.stats()
    assert s1['total_compile_s'] == s0['total_compile_s']
    assert s1['misses'] == s0['misses']
    b1 = profiler.bucketing_stats()
    for rung in ('4', '8'):
        assert b1['train_rungs'][rung]['compiles'] == \
            b0['train_rungs'].get(rung, {}).get('compiles', 0)
        assert b1['train_rungs'][rung]['warmups'] >= 1
    assert b1['train_pad_waste_rows'] > b0['train_pad_waste_rows']
    assert b1['train_bucket_switches'] > b0['train_bucket_switches']


def test_recreated_module_rewarms_from_cache(start):
    make_module(start, ladder=[4, 8], warmup=True)
    s0 = exec_cache.stats()
    mod2 = make_module(start, ladder=[4, 8])
    warmed = mod2.warmup_buckets()
    s1 = exec_cache.stats()
    assert warmed == [4, 8]
    assert s1['total_compile_s'] == s0['total_compile_s']
    assert s1['misses'] == s0['misses']
    assert s1['hits'] > s0['hits']


def test_warmup_mutates_no_state(start):
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    mod = mx.mod.BucketingModule(sym_gen_of(mx), default_bucket_key=8,
                                 bucket_ladder=[4, 8], mask_label=MASK,
                                 context=mx.cpu())
    mod.bind(data_shapes=[_desc(mx, 'data', 8)],
             label_shapes=[_desc(mx, 'softmax_label', 8)])
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer_params={'learning_rate': 0.1,
                                         'momentum': 0.9,
                                         'lr_scheduler': sched})
    before = params_np(mod)
    opt = mod._curr_module._optimizer
    counts0 = dict(opt._index_update_count)
    nu0 = opt.num_update
    sched0 = dict(sched.__dict__)
    fu = mod._curr_module._fused_updater
    rng0 = mx.random.generator(torch.device('cpu')).get_state()
    mod.warmup_buckets(bulk=5,
                       eval_metric=mx.metric.Perplexity(ignore_label=MASK))
    assert max_param_diff(params_np(mod), before) == 0.0
    assert opt._index_update_count == counts0
    assert opt.num_update == nu0
    assert sched.__dict__ == sched0
    for name, v in fu.states.items():
        assert float(np.abs(np.asarray(v)).max()) == 0.0, name
    assert opt._get_lr(fu.param_names[0]) == 0.1
    assert torch.equal(mx.random.generator(torch.device('cpu')).get_state(),
                       rng0)


# -- per-bucket bulk dispatch --------------------------------------------------

def test_bulk_step_one_dispatch_and_parity(start):
    bulk = make_module(start, ladder=[4, 8], warmup=True)
    ref = make_module(start, ladder=[4, 8])
    metric_b = mx.metric.Perplexity(ignore_label=MASK)
    metric_r = mx.metric.Perplexity(ignore_label=MASK)
    batches = [make_batch(7, seed=i) for i in range(4)]
    ex8 = bulk._buckets[8]._exec_group.executor
    d0 = ex8.fused_dispatches
    bulk.bulk_step(batches=batches, eval_metric=metric_b)
    assert ex8.fused_dispatches - d0 == 1
    for b in batches:
        ref.forward_backward(b)
        ref.update()
        ref.update_metric(metric_r, b.label)
    assert max_param_diff(params_np(bulk), params_np(ref)) < 1e-5
    assert abs(metric_b.get()[1] - metric_r.get()[1]) < 1e-3
    with pytest.raises(MXNetError):
        bulk.bulk_step(batches=[make_batch(3), make_batch(8)])


class _RungMajorIter:
    """Batches of sequence lengths in rung-major order (the role of the
    JAX test's BucketSentenceIter(bucket_major=True))."""

    def __init__(self, lengths):
        self.batches = [make_batch(n, seed=i) for i, n in enumerate(lengths)]
        self.provide_data = [_desc(mx, 'data', 8)]
        self.provide_label = [_desc(mx, 'softmax_label', 8)]
        self.batch_size = BATCH

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def test_fit_bulk_rung_major_parity(start, monkeypatch):
    monkeypatch.setenv('MXNET_TPU_PREFETCH', '0')
    lengths = [3, 4, 3, 4, 2, 7, 8, 6, 8, 5, 8]

    def run(bulk):
        mod = mx.mod.BucketingModule(sym_gen_of(mx), default_bucket_key=8,
                                     bucket_ladder=[4, 8], mask_label=MASK,
                                     warmup_buckets=True, context=mx.cpu())
        metric = mx.metric.Perplexity(ignore_label=MASK)
        mod.fit(_RungMajorIter(lengths), eval_metric=metric, num_epoch=1,
                bulk=bulk, arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                       for k, v in start.items()},
                optimizer_params={'learning_rate': 0.1, 'momentum': 0.9})
        return params_np(mod), metric.get()[1]

    b0 = profiler.bucketing_stats()
    p_bulk, m_bulk = run(bulk=4)
    b1 = profiler.bucketing_stats()
    p_step, m_step = run(bulk=None)
    assert max_param_diff(p_bulk, p_step) < 1e-5
    assert abs(m_bulk - m_step) / m_step < 1e-3

    def total(stats, key):
        return sum(v[key] for v in stats['train_rungs'].values())
    assert total(b1, 'compiles') == total(b0, 'compiles')
    assert total(b1, 'steps') - total(b0, 'steps') > \
        total(b1, 'dispatches') - total(b0, 'dispatches')


# -- checkpoints, satellites ---------------------------------------------------

def test_checkpoint_roundtrip_across_rungs(start, tmp_path):
    mod = make_module(start, ladder=[4, 8], warmup=True)
    for i, seq_len in enumerate((3, 8, 4, 6)):
        mod.forward_backward(make_batch(seq_len, seed=i))
        mod.update()
    states = str(tmp_path / 'opt.states')
    mod._curr_module.save_optimizer_states(states)
    args, auxs = mod.get_params()
    mod2 = make_module(start, ladder=[4, 8], warmup=True)
    mod2.set_params(args, auxs)
    mod2._curr_module.load_optimizer_states(states)
    for i, seq_len in enumerate((7, 2, 8, 5)):
        b = make_batch(seq_len, seed=10 + i)
        mod.forward_backward(b)
        mod.update()
        mod2.forward_backward(b)
        mod2.update()
    assert max_param_diff(params_np(mod), params_np(mod2)) < 2e-6
    # the JAX package resumes from the port's files
    jmod = make_module(start, ladder=[4, 8], pkg=jmx)
    jmod.set_params({k: jmx.nd.array(v.asnumpy()) for k, v in args.items()},
                    {})
    jmod._curr_module.load_optimizer_states(states)
    ref = make_module(start, ladder=[4, 8])
    ref.set_params(args, auxs)
    ref._curr_module.load_optimizer_states(states)
    for i, seq_len in enumerate((7, 2)):
        jmod.forward_backward(make_batch(seq_len, seed=20 + i, pkg=jmx))
        jmod.update()
        ref.forward_backward(make_batch(seq_len, seed=20 + i))
        ref.update()
    got, want = params_np(ref), params_np(jmod)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAMS)


def test_monitor_installed_on_later_buckets(start):
    mod = make_module(start)
    mon = mx.mon.Monitor(1, pattern='.*')
    mod.install_monitor(mon)
    assert mod._buckets[8]._exec_group.executor._monitor_callback \
        is not None
    mod.forward(make_batch(5), is_train=False)
    assert mod._buckets[5]._exec_group.executor._monitor_callback \
        is not None


def test_init_params_allow_extra_forwarded(start):
    mod = make_module(start)
    args, auxs = mod.get_params()
    extra = dict(args)
    extra['not_a_param'] = mx.nd.zeros((2, 2), ctx=mx.cpu())
    with pytest.raises(MXNetError):
        mod.set_params(extra, auxs)
    mod.set_params(extra, auxs, allow_extra=True)


def test_masked_metric_device_folds():
    rs = np.random.RandomState(0)
    probs = rs.dirichlet(np.ones(VOCAB), size=10).astype(np.float32)
    labels = rs.randint(0, VOCAB, size=10).astype(np.float32)
    labels[7:] = MASK
    for metric in (mx.metric.Accuracy(ignore_label=MASK),
                   mx.metric.Perplexity(ignore_label=MASK)):
        fold = mx.metric.device_fold(metric)
        carry = fold.update(fold.init(torch.device('cpu')),
                            {'softmax_label': torch.from_numpy(labels)},
                            {'softmax_output': torch.from_numpy(probs)})
        fold.commit(carry)
        dev = metric.get()[1]
        metric.reset()
        with mx.cpu():
            metric.update([mx.nd.array(labels)], [mx.nd.array(probs)])
        assert abs(dev - metric.get()[1]) < 1e-4, metric.name
    acc = mx.metric.Accuracy()
    with mx.cpu():
        acc.update([mx.nd.array(labels)], [mx.nd.array(probs)])
    assert acc.num_inst == 10


def test_bucketing_counters_in_summary_and_dump(start, tmp_path):
    mod = make_module(start, ladder=[4, 8], warmup=True)
    for i, seq_len in enumerate((3, 8, 5)):
        mod.forward_backward(make_batch(seq_len, seed=i))
        mod.update()
    stats = profiler.bucketing_stats()
    assert stats['train_bucket_switches'] > 0
    assert stats['train_pad_waste_rows'] > 0
    assert 0.0 < stats['train_pad_waste_frac'] < 1.0
    assert stats['train_rungs']['8']['steps'] > 0
    text = profiler.summary(print_out=False)
    assert 'train_bucket_switches' in text and 'rung' in text
    profiler.profiler_set_config(filename=str(tmp_path / 'profile.json'))
    with open(profiler.dump_profile()) as f:
        events = json.load(f)['traceEvents']
    meta = [e for e in events if e.get('name') == 'bucketing']
    assert meta and 'train_pad_waste_rows' in meta[0]['args']
    assert set(stats) == set(jmx.profiler.bucketing_stats())


def test_bucketing_matches_jax(start):
    """The same mixed-length run through both packages' ladders."""
    out = {}
    for pkg in (jmx, mx):
        mod = make_module(start, ladder=[4, 8], pkg=pkg)
        metric = pkg.metric.Perplexity(ignore_label=MASK)
        for i, seq_len in enumerate((3, 8, 4, 7, 2, 8)):
            b = make_batch(seq_len, seed=i, pkg=pkg)
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        out[pkg] = (params_np(mod), metric.get()[1])
    for k in out[jmx][0]:
        np.testing.assert_allclose(out[mx][0][k], out[jmx][0][k],
                                   err_msg=k, **PARAMS)
    np.testing.assert_allclose(out[mx][1], out[jmx][1], rtol=1e-5)


def test_several_contexts_in_one_process_name_the_launchers():
    """A BucketingModule over several contexts is a data mesh of as many
    ranks, one process each (tests/test_torch_module_dp.py trains one);
    in one process with no process group it raises naming the
    launchers."""
    mod = mx.mod.BucketingModule(sym_gen_of(mx), default_bucket_key=8,
                                 context=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(MXNetError, match='torchrun'):
        mod.bind(data_shapes=[_desc(mx, 'data', 8)],
                 label_shapes=[_desc(mx, 'softmax_label', 8)])


# -- chip_smoke.py's gate of phase 12 ------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _passing_phase12(cs):
    pairs = cs.route_pairs(cs.RESNET_PAIRS, True)
    side = cs.BUCKET_KEYS[1]
    fit = dict(launches=pairs * cs.BULK_BATCHES, steps=cs.BULK_BATCHES,
               dispatches=cs.BULK_BATCHES // cs.BULK_K, queued=4, reads=4,
               leaves=2, compiles_during_steps={'160': 0, '224': 0},
               metric=[('accuracy', 0.0)], finite=True)
    return dict(
        stem_split=True,
        step_launches=[(k, pairs) for k in cs.BUCKET_KEYS * 3],
        path_launches=pairs * 6, shared_params=True, one_updater=True,
        update_seen=True, rungs_built_after_warmup=0,
        compiles_after_warmup={}, buckets=sorted(cs.BUCKET_KEYS),
        kernel_checks=[dict(x=[256, side // d, side // d, 64], ok=True)
                       for d in (4, 8, 16, 32)],
        bulk=dict(dispatches=1, launches=pairs * cs.BULK_K, differ=[],
                  compared=471, metric_bulk=[(2.0, 1024), (6.0, 1024)],
                  metric_steps=[(2.0, 1024), (6.0, 1024)],
                  metric_steps_host=[(2.0, 1024), (7.0, 1024)],
                  lrs_bulk=[0.1, 0.05, 0.05, 0.025],
                  lrs_step=[0.1, 0.05, 0.05, 0.025],
                  lrs_want=[0.1, 0.05, 0.05, 0.025]),
        fit_bulk=fit, bucket_fit_bulk=dict(fit),
        split=dict(on=dict(launches=cs.RESNET_PAIRS - 1),
                   off=dict(launches=cs.RESNET_PAIRS), loss_err=1.5e-4,
                   out_rel=0.0055, aux_rel={'bn0_moving_mean': 0.005}),
        group2ctx=dict(ok=True, grouped=True,
                       placed=['cpu(0)', 'gpu(0)']))


def test_phase12_gate_passes_a_good_run_and_refuses_bad_ones():
    cs = _chip_smoke()
    run = _passing_phase12(cs)
    assert cs.bucketing_gate(run) == []
    wrong = dict(run, step_launches=[(224, cs.RESNET_PAIRS)] +
                 run['step_launches'][1:])
    assert any('launched' in m for m in cs.bucketing_gate(wrong))
    assert cs.bucketing_gate(dict(run, shared_params=False))
    assert cs.bucketing_gate(dict(run, update_seen=False))
    assert cs.bucketing_gate(dict(run, rungs_built_after_warmup=1))
    assert cs.bucketing_gate(dict(run, kernel_checks=run['kernel_checks'][
        :3]))
    differs = dict(run, bulk=dict(run['bulk'], differ=['arg conv0_weight']))
    assert any('differs' in m for m in cs.bucketing_gate(differs))
    sums = dict(run, bulk=dict(run['bulk'], metric_steps=[(3.0, 1024),
                                                          (6.0, 1024)]))
    assert cs.bucketing_gate(sums)
    flat = dict(run, bulk=dict(run['bulk'], lrs_bulk=[0.1] * 4,
                               lrs_step=[0.1] * 4))
    assert any('lr' in m for m in cs.bucketing_gate(flat))
    reads = dict(run, fit_bulk=dict(run['fit_bulk'], reads=8))
    assert any('read' in m for m in cs.bucketing_gate(reads))
    split = dict(run, split=dict(run['split'], out_rel=0.07))
    assert any('output' in m for m in cs.bucketing_gate(split))
    assert cs.bucketing_gate(dict(run, group2ctx=dict(run['group2ctx'],
                                                      ok=False)))
