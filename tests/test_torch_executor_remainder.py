"""The executor's remainder (mxnet_tpu_torch/executor.py: `reshape`,
`partial_forward`, the monitor with mxnet_tpu_torch/monitor.py,
`memory_cost`, `debug_str`, the serve walk) and `Module.reshape`,
`install_monitor` and `fit(monitor=)`, against the JAX package's, on the
CPU, at rtol 1e-5 / atol 1e-6 (tests/test_torch_executor.py's bound)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = dict(data=(4, 2, 6, 6))


def _convnet(pkg):
    s = pkg.symbol
    data = s.Variable('data')
    conv = s.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                         name='conv')
    bn = s.BatchNorm(conv, fix_gamma=False, name='bn')
    act = s.Activation(bn, act_type='relu', name='relu')
    pool = s.Pooling(act, kernel=(2, 2), stride=(2, 2), pool_type='max',
                     name='pool')
    fc = s.FullyConnected(s.Flatten(pool, name='flat'), num_hidden=3,
                          name='fc')
    return s.SoftmaxOutput(fc, name='softmax')


def _params(seed, batch=4):
    symbol = _convnet(mx)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=(batch, 2, 6, 6))
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * 0.5).astype(np.float32) for n, s in
            zip(symbol.list_arguments(), arg_shapes)}
    args['softmax_label'] = rng.randint(0, 3, (batch,)).astype(np.float32)
    auxs = {n: np.abs(rng.randn(*s) * 0.3 + 0.5).astype(np.float32)
            for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _bind_both(grad_req='write', seed=8):
    args, auxs = _params(seed)
    jex = _convnet(jmx).simple_bind(jmx.cpu(), grad_req=grad_req, **SHAPES)
    tex = _convnet(mx).simple_bind(mx.cpu(), grad_req=grad_req, **SHAPES)
    for ex in (jex, tex):
        ex.copy_params_from(args, auxs)
    return jex, tex


def _close(mine, theirs):
    np.testing.assert_allclose(mine.asnumpy(), theirs.asnumpy(), **TOL)


def test_reshape_shares_unchanged_arrays_and_matches_jax():
    jex, tex = _bind_both()
    args, _ = _params(9, batch=7)
    pairs = []
    for ex in (jex, tex):
        new = ex.reshape(data=(7, 2, 6, 6), softmax_label=(7,))
        assert new.arg_dict['data'].shape == (7, 2, 6, 6)
        assert new.arg_dict['conv_weight'] is ex.arg_dict['conv_weight']
        assert new.aux_dict['bn_moving_mean'] is \
            ex.aux_dict['bn_moving_mean']
        assert new.grad_dict['conv_weight'] is ex.grad_dict['conv_weight']
        assert new.grad_dict['data'].shape == (7, 2, 6, 6)
        new.forward(is_train=False, data=args['data'])
        pairs.append(new)
    _close(pairs[1].outputs[0], pairs[0].outputs[0])
    back = tex.reshape(**SHAPES)
    assert back.arg_dict['data'] is tex.arg_dict['data']
    assert back._sig == tex._sig


@pytest.mark.parametrize('is_train', [False, True])
def test_partial_forward_steps_as_jax(is_train):
    jex, tex = _bind_both(seed=10)
    for step in (1, 3, 5):
        assert tex.partial_forward(step=step, is_train=is_train) == \
            jex.partial_forward(step=step, is_train=is_train)
    assert tex.partial_forward(is_train=is_train) == \
        jex.partial_forward(is_train=is_train) == 0
    _close(tex.outputs[0], jex.outputs[0])
    for name in jex.aux_dict:
        _close(tex.aux_dict[name], jex.aux_dict[name])
    # new inputs restart the walk
    x = _params(11)[0]['data']
    assert tex.partial_forward(step=2, data=x) == \
        jex.partial_forward(step=2, data=x)
    assert tex.partial_forward() == jex.partial_forward() == 0
    _close(tex.outputs[0], jex.outputs[0])


@pytest.mark.parametrize('is_train', [False, True])
def test_monitor_collects_every_node_output_as_jax(is_train):
    jex, tex = _bind_both(seed=12)
    got = {}
    for pkg, ex in ((jmx, jex), (mx, tex)):
        mon = pkg.mon.Monitor(1, pattern='.*')
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=is_train)
        got[pkg.__name__] = mon.toc()
    mine, theirs = got['mxnet_tpu_torch'], got['mxnet_tpu']
    assert [(n, k) for n, k, _ in mine] == [(n, k) for n, k, _ in theirs]
    names = [k for _, k, _ in mine]
    assert 'conv_output' in names and 'softmax_output' in names
    for (_, k, a), (_, _, b) in zip(mine, theirs):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, err_msg=k)
    # not due: nothing collected; the callback stays inactive
    mon = mx.mon.Monitor(2)
    mon.install(tex)
    mon.tic()
    mon.toc()
    mon.tic()
    tex.forward()
    assert mon.toc() == []


def test_monitor_sees_the_layout_pass_in_semantic_layout(monkeypatch):
    monkeypatch.setenv('MXNET_TPU_LAYOUT_OPT', '1')
    _, tex = _bind_both(seed=13)
    seen = {}

    def callback(name, arr):
        seen[name] = arr.shape
    callback.active = True
    tex.set_monitor_callback(callback)
    tex.forward()
    assert seen['conv_output'] == (4, 4, 6, 6)
    assert seen['pool_output'] == (4, 4, 3, 3)


def test_debug_str_lists_what_jax_lists():
    jex, tex = _bind_both()
    mine, theirs = tex.debug_str().split('\n'), jex.debug_str().split('\n')
    assert mine[:-1] == theirs[:-1]
    assert mine[-1] == 'Executed: op by op on cpu(0) (no compiled module)'


@pytest.mark.parametrize('mode', ['forward', 'train', 'train_backward'])
def test_memory_cost_counts_the_bound_and_produced_bytes(mode):
    jex, tex = _bind_both()
    before = {n: a.asnumpy() for n, a in tex.aux_dict.items()}
    cost = tex.memory_cost(mode)
    bound = sum(a.size * 4 for a in list(tex.arg_dict.values()) +
                list(tex.aux_dict.values()))
    assert cost['argument_bytes'] == bound
    outs = 4 * 3 * 4
    aux = sum(a.size * 4 for a in tex.aux_dict.values())
    grads = sum(g.size * 4 for g in tex.grad_dict.values())
    want = {'forward': outs, 'train': outs + aux,
            'train_backward': outs + aux + grads}[mode]
    assert cost['output_bytes'] == want
    # on the CPU, the peak of the bytes of the storages alive at once
    # (the CPU allocator keeps no peak of its own): integers, the same
    # for the same run, the temp bytes the peak less what is bound and
    # what stays
    peak, temp = cost['peak_memory_bytes'], cost['temp_bytes']
    assert isinstance(peak, int) and isinstance(temp, int)
    assert temp == peak - cost['argument_bytes'] - cost['output_bytes']
    assert temp > 0
    assert tex.memory_cost(mode) == cost
    assert set(cost) == set(jex.memory_cost(mode))
    # the run changes no state of the executor
    assert not tex.outputs
    for n, a in tex.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), before[n])
    for bad in ('backward', None):
        with pytest.raises(ValueError):
            tex.memory_cost(bad)


def test_serve_walk_is_the_eval_forward_on_given_tensors():
    _, tex = _bind_both(seed=14)
    args = [tex.arg_dict[n]._data for n in tex._arg_names]
    auxs = [tex.aux_dict[n]._data for n in tex._aux_names]
    before = [a.clone() for a in auxs]
    outs = tex.serve(args, auxs)
    ref = tex.forward()[0]
    assert torch.equal(outs[0], ref._data)
    assert outs[0].is_inference()
    again = tex.serve(args, auxs)
    assert again[0] is not outs[0]          # fresh outputs each call
    for a, b in zip(auxs, before):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable('data')
    x = pkg.sym.FullyConnected(data, num_hidden=8, name='fc1')
    x = pkg.sym.Activation(x, act_type='relu', name='relu1')
    x = pkg.sym.FullyConnected(x, num_hidden=3, name='fc2')
    return pkg.sym.SoftmaxOutput(x, name='softmax')


def _mlp_params():
    rng = np.random.RandomState(20)
    return {'fc1_weight': rng.randn(8, 5).astype(np.float32),
            'fc1_bias': rng.randn(8).astype(np.float32),
            'fc2_weight': rng.randn(3, 8).astype(np.float32),
            'fc2_bias': rng.randn(3).astype(np.float32)}


def test_module_reshape_matches_jax():
    x = np.random.RandomState(21).randn(6, 5).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[('data', (4, 5))],
                 label_shapes=[('softmax_label', (4,))], for_training=False)
        mod.set_params({k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in _mlp_params().items()}, {})
        w = mod._exec_group.executor.arg_dict['fc1_weight']
        mod.reshape(data_shapes=[('data', (6, 5))],
                    label_shapes=[('softmax_label', (6,))])
        assert mod.data_shapes == [('data', (6, 5))]
        assert mod._exec_group.executor.arg_dict['fc1_weight'] is w
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                     [pkg.nd.zeros((6,), ctx=pkg.cpu())]),
                    is_train=False)
        outs.append(mod.get_outputs()[0])
    _close(outs[1], outs[0])


def test_module_fit_ticks_an_installed_monitor():
    rng = np.random.RandomState(22)
    X = rng.randn(40, 5).astype(np.float32)
    y = rng.randint(0, 3, (40,)).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=10)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    seen = []
    mon = mx.mon.Monitor(2, pattern='fc.*')
    toc = mon.toc

    def record():
        res = toc()
        seen.append(res)
        return res
    mon.toc = record
    mod.fit(it, num_epoch=1, monitor=mon,
            optimizer_params=(('learning_rate', 0.1),))
    assert len(seen) == 4                  # one toc a batch
    due = [res for res in seen if res]
    assert len(due) == 2                   # every second batch
    # fit's step is forward_backward, which collects no node outputs (the
    # JAX package's fused step neither): toc records the parameters
    names = {k for _, k, _ in due[0]}
    assert names == {'fc1_weight', 'fc1_bias', 'fc2_weight', 'fc2_bias'}
    mod.install_monitor(mx.mon.Monitor(1))
    assert mod._exec_group.executor._monitor_callback is not None


def test_bucketing_module_and_group2ctx_raise_naming_their_item():
    """Both are ported (tests/test_torch_bucketing.py,
    tests/test_torch_stem_split.py), and so is data parallelism
    (tests/test_torch_module_dp.py). A BucketingModule over several
    contexts in one process raises naming the launchers (each context is
    a rank of its own process), and a multistep program takes an in-step
    reduce (a group2ctx that matches no node leaves the executor
    ungrouped)."""
    mod = mx.mod.BucketingModule(lambda key: (_mlp(mx), ('data',), None),
                                 default_bucket_key=5,
                                 context=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(MXNetError, match='torchrun'):
        mod.bind([('data', (2, 5))])
    ex = _mlp(mx).simple_bind(mx.cpu(), data=(2, 5),
                              group2ctx={'a': mx.cpu()})
    assert not ex._grouped
    assert ex.make_fused_multistep(lambda *a: a, ['data'],
                                   grad_reduce=lambda g: g) is not None
