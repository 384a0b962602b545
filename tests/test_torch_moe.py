"""The port's mixture of experts (mxnet_tpu_torch.parallel.moe and
gluon.nn.MoE) against the JAX package, on the CPU: the counterparts of
tests/test_pipeline_train.py's MoE tests and tests/test_parallel.py's
routing and expert-parallel step tests.

The ranks are two spawns of gloo processes, two and four
(tests/_torch_parallel_ranks.py, `moe_suite`): gluon.nn.MoE through the
fused step over a data mesh of all of them (each rank computing its
slice of the experts) against the JAX package on as many virtual
devices and against one device, and make_moe_train_step over an
'expert' axis. Tolerances: the JAX test's atol 3e-6, rtol 1e-4 for the
trained parameters; routing and its counts exactly; the same bits on a
second run.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

import mxnet_tpu as jmx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import moe as jmoe

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import moe as pmoe

import _torch_parallel_ranks as ranks
from _torch_parallel_ranks import (PP_BATCH as BATCH, PP_FEAT as FEAT,
                                   moe_train, pp_pvals)

TRAINER = dict(atol=3e-6, rtol=1e-4)
ROUTE = dict(rtol=1e-5, atol=1e-6)


def _route_inputs(T, D, E, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(T, D).astype(np.float32),
            rs.randn(D, E).astype(np.float32))


def test_switch_route_counts():
    x, w = _route_inputs(16, FEAT, 4)
    cap = pmoe.capacity_for(16, 4, 1.0)
    assert cap == jmoe.capacity_for(16, 4, 1.0) == 4
    disp, comb, aux, (routed, dropped) = pmoe.switch_route(
        torch.from_numpy(x), torch.from_numpy(w), 4, cap, with_counts=True)
    jd, jc, ja, (jr, jdr) = jmoe.switch_route(
        jnp.asarray(x), jnp.asarray(w), 4, cap, with_counts=True)
    assert routed.shape == (4,) and dropped.shape == (4,)
    np.testing.assert_array_equal(routed.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdr))
    assert int(routed.sum() + dropped.sum()) == 16
    assert bool((routed <= cap).all())
    np.testing.assert_allclose(disp.numpy(), np.asarray(jd), **ROUTE)
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), **ROUTE)
    np.testing.assert_allclose(float(aux), float(ja), **ROUTE)
    # ample capacity: nothing drops
    _, _, _, (r2, d2) = pmoe.switch_route(
        torch.from_numpy(x), torch.from_numpy(w), 4, 16, with_counts=True)
    assert int(d2.sum()) == 0 and int(r2.sum()) == 16


def test_moe_routing_dispatch_combine():
    """Identity experts: combine @ dispatch is each token times its
    gate, as in the JAX package."""
    x, w = _route_inputs(8, 4, 2)
    disp, comb, aux = pmoe.switch_route(torch.from_numpy(x),
                                        torch.from_numpy(w), 2, 8)
    assert tuple(disp.shape) == (2, 8, 4) and tuple(comb.shape) == (8, 2, 8)
    assert float(aux) > 0
    recon = torch.einsum('tec,ecd->td', comb, disp).numpy()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ w), -1))
    np.testing.assert_allclose(recon, x * probs.max(-1)[:, None], rtol=1e-5)
    jd, jc, ja = jmoe.switch_route(jnp.asarray(x), jnp.asarray(w), 2, 8)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jd), **ROUTE)
    np.testing.assert_allclose(float(aux), float(ja), **ROUTE)


def test_switch_route_scatter_gives_the_same_bits_twice():
    """Every kept token has its own slot and every dropped one a spare
    row, so the dispatch does not depend on the order of the writes."""
    x, w = _route_inputs(64, 8, 4, seed=3)
    outs = [pmoe.switch_route(torch.from_numpy(x), torch.from_numpy(w), 4,
                              6, with_counts=True) for _ in range(2)]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(a, b)
    assert int(outs[0][3][1].sum()) > 0        # some tokens dropped


def test_moe_params_from_jax_and_init():
    tree = jmoe.init_moe_params(jax.random.PRNGKey(0), 4, 8, 8)
    got = pmoe.params_from_jax({k: np.asarray(v) for k, v in tree.items()},
                               device='cpu')
    for k in ('router', 'w1', 'w2'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(tree[k]))
    mine = pmoe.init_moe_params(4, 8, 8, torch.Generator().manual_seed(0),
                                device='cpu')
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tree.items()}
    assert pmoe.moe_param_specs() == {'router': (), 'w1': ('expert',),
                                      'w2': ('expert',)}


def test_moe_imperative_training_raises():
    """The JAX layer's routing is outside its tape (its weights get no
    gradient under autograd.record); the port refuses, naming
    fuse_step. Inference runs."""
    with mx.cpu():
        net = ranks.moe_net(mx, mx.cpu())
        x = mx.nd.array(np.random.RandomState(1).rand(BATCH, FEAT)
                        .astype(np.float32))
        assert net(x).shape == (BATCH, ranks.PP_NCLS)
        with pytest.raises(MXNetError, match='fuse_step'):
            with mx.autograd.record():
                net(x)


def _moe_inputs():
    rs = np.random.RandomState(0)
    E, D, H = 8, 4, 8
    x = rs.randn(64, D).astype(np.float32)
    return {'moe_router': (rs.randn(D, E) * 0.02).astype(np.float32),
            'moe_w1': (rs.randn(E, D, H) * 0.5).astype(np.float32),
            'moe_w2': (rs.randn(E, H, D) * 0.5).astype(np.float32),
            'moe_x': x, 'moe_y': (np.tanh(x) * 0.5).astype(np.float32)}


@pytest.fixture(scope='module')
def moe_runs(tmp_path_factory):
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp('moe%d' % n)
        out[n] = ranks.run(ranks.moe_suite, n, tmp, **_moe_inputs())
    return out


@pytest.fixture(scope='module')
def one_device():
    with mx.cpu():
        net, _ = moe_train(mx, mx.cpu(0), k=2)
    return pp_pvals(net)


@pytest.mark.parametrize('n', [2, 4])
def test_moe_trains_with_counters(moe_runs, n):
    """Three steps over n ranks: every token routed or dropped, the
    per-expert tables summing to the totals, the blocks' cumulative
    counts equal to the profiler's, and the JAX package's counts on n
    devices."""
    profile = jmx.profiler
    profile.clear()
    profile.profiler_set_state('run')
    try:
        with jmx.cpu():
            moe_train(jmx, [jmx.cpu(i) for i in range(n)], k=3)
    finally:
        profile.profiler_set_state('stop')
    jst = profile.moe_stats()
    for r in moe_runs[n]:
        assert bool(r['losses_finite'])
        assert r['moe_dispatches'] == 3
        assert r['moe_routed_tokens'] + r['moe_dropped_tokens'] == 3 * BATCH
        assert r['per_expert_routed'] == r['moe_routed_tokens']
        assert r['per_expert_dropped'] == r['moe_dropped_tokens']
        assert 0.0 <= r['moe_drop_frac'] <= 1.0
        assert 'moe_routed_tokens=%d' % r['moe_routed_tokens'] in \
            str(r['summary'])
        assert r['block_routed'] == r['moe_routed_tokens']
        assert r['block_dropped'] == r['moe_dropped_tokens']
        assert r['moe_routed_tokens'] == jst['moe_routed_tokens']
        assert r['moe_dropped_tokens'] == jst['moe_dropped_tokens']


@pytest.mark.parametrize('n', [2, 4])
def test_moe_mesh_vs_single_device_parity(moe_runs, one_device, n):
    """Two steps over n ranks, each computing its slice of the experts,
    against the port's one device and the JAX package on n devices and
    on one; a second run gives the same bits."""
    with jmx.cpu():
        jnet, _ = moe_train(jmx, [jmx.cpu(i) for i in range(n)], k=2)
        jone, _ = moe_train(jmx, jmx.cpu(0), k=2)
    refs = (one_device, pp_pvals(jnet), pp_pvals(jone))
    k = len(one_device)
    for r in moe_runs[n]:
        got = [r['par0__%d' % i] for i in range(k)]
        for ref in refs:
            for i, (a, b) in enumerate(zip(got, ref)):
                np.testing.assert_allclose(a, b, err_msg=str(i), **TRAINER)
        for i in range(k):
            np.testing.assert_array_equal(r['par0__%d' % i],
                                          r['par1__%d' % i])


@pytest.mark.parametrize('n', [2, 4])
def test_moe_train_step_learns(moe_runs, n):
    """make_moe_train_step over an 'expert' axis of n ranks learns the
    toy regression and follows the JAX step on n devices from the same
    parameters (the gradient scaling: the router averaged, the experts
    divided by n)."""
    inp = _moe_inputs()
    mesh = jmake_mesh({'expert': n}, devices=jax.devices()[:n])
    specs = jmoe.moe_param_specs()
    params = {k: jax.device_put(jnp.asarray(inp['moe_' + k]),
                                NamedSharding(mesh, specs[k]))
              for k in ('router', 'w1', 'w2')}
    step = jmoe.make_moe_train_step(mesh, 4, 8, 8, 16, lr=2.0)
    jl = []
    for _ in range(5):
        loss, params = step(params, jnp.asarray(inp['moe_x']),
                            jnp.asarray(inp['moe_y']))
        jl.append(float(loss))
    for r in moe_runs[n]:
        losses = r['moe_losses']
        assert losses[-1] < losses[0] * 0.7, losses[::10]
        np.testing.assert_allclose(losses[:5], jl, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(losses, moe_runs[n][0]['moe_losses'])
