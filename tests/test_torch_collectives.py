"""The port's collectives (mxnet_tpu_torch.parallel.collectives) against
the JAX package's, on the CPU: four ranks of a gloo group (one spawn
shared by the file's checks) run each form over the 'data' axis, and the
parent holds every rank's result against the JAX form inside shard_map
over four virtual CPU devices, and each gradient against the one the
port's convention gives (a replicated value carries the whole
cotangent on every rank)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import collectives as jax_coll
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel._compat import shard_map
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives

import _torch_parallel_ranks as ranks

N = 4
RTOL, ATOL = 1e-6, 1e-6
RS = np.random.RandomState(11)
INPUTS = dict(
    X=RS.randn(8, 3).astype(np.float32),
    C=RS.randn(N, 2, 3).astype(np.float32),
    CF=RS.randn(N, 8, 3).astype(np.float32),
    XR=RS.randn(N, 8, 3).astype(np.float32),
    XA=RS.randn(N, 4, 2, 3).astype(np.float32),
    CA=RS.randn(N, 1, 8, 3).astype(np.float32),
    XQ=(RS.randn(N, 5, 7) * np.array([1, 3, 0.2, 50])[:, None, None]
        ).astype(np.float32),
    G=RS.randn(N, 3, 4, 5).astype(np.float32))


@pytest.fixture(scope='module')
def coll_run(tmp_path_factory):
    return ranks.run(ranks.collectives_suite, N,
                     tmp_path_factory.mktemp('collectives'), **INPUTS)


def _per_device(fn, x):
    """fn inside shard_map over 'data' (4 devices), each device's result
    as a list by axis index."""
    mesh = make_mesh({'data': N}, devices=jax.devices()[:N])
    out = shard_map(lambda a: fn(a)[None], mesh=mesh, in_specs=P('data'),
                    out_specs=P('data'), check_vma=False)(jnp.asarray(x))
    return [np.asarray(o) for o in out]


def test_collectives_api(coll_run):
    """The port's counterpart of tests/test_parallel.py::
    test_collectives_api: the allreduce of each rank's block sum."""
    for res in coll_run:
        np.testing.assert_allclose(res['api'], np.full((2, 2), 16.0))


X2 = INPUTS['X']
FORMS = {
    'sum': (lambda a: jax_coll.allreduce_sum(a, 'data'), X2),
    'mean': (lambda a: jax_coll.allreduce_mean(a, 'data'), X2),
    'gather': (lambda a: jax_coll.allgather(a, 'data', axis=0), X2),
    'gather_stacked': (lambda a: jax_coll.allgather(a, 'data', axis=0,
                                                    tiled=False), X2),
    'rs': (lambda a: jax_coll.reduce_scatter(a, 'data', 0),
           INPUTS['XR'].reshape(N * 8, 3)),
    'pp': (lambda a: jax_coll.ppermute(a, 'data', [(j, (j + 1) % N)
                                                   for j in range(N)]), X2),
    'pp_partial': (lambda a: jax_coll.ppermute(a, 'data', [(0, 1)]), X2),
    'a2a': (lambda a: jax_coll.all_to_all(a, 'data', 0, 1),
            INPUTS['XA'].reshape(N * 4, 2, 3)),
}


@pytest.mark.parametrize('name', sorted(FORMS))
def test_forms_match_jax(coll_run, name):
    fn, x = FORMS[name]
    want = _per_device(fn, x)
    for rank, res in enumerate(coll_run):
        np.testing.assert_allclose(res[name], want[rank], rtol=RTOL,
                                   atol=ATOL, err_msg='rank %d' % rank)


def test_axis_index_and_size_match_jax(coll_run):
    idx = _per_device(lambda a: jnp.full((1,), jax_coll.axis_index('data')),
                      np.zeros(N, np.float32))
    size = _per_device(lambda a: jnp.full((1,), jax_coll.axis_size('data')),
                       np.zeros(N, np.float32))
    for rank, res in enumerate(coll_run):
        assert int(res['axis_index']) == int(idx[rank][0]) == rank
        assert int(res['axis_size']) == int(size[rank][0]) == N


def _a2a_back(ca, rank):
    return np.stack([ca[s][0, 2 * rank:2 * rank + 2]
                     for s in range(N)])


GRADS = {
    'sum_grad': lambda r: INPUTS['C'][r],
    'mean_grad': lambda r: INPUTS['C'][r] / N,
    'copy_grad': lambda r: INPUTS['C'].sum(0),
    'gather_grad': lambda r: INPUTS['CF'][r][2 * r:2 * r + 2],
    'shard_grad': lambda r: INPUTS['C'].reshape(8, 3),
    'rs_grad': lambda r: INPUTS['C'].reshape(8, 3),
    'pp_grad': lambda r: INPUTS['C'][(r + 1) % N],
    'a2a_grad': lambda r: _a2a_back(INPUTS['CA'], r),
}


@pytest.mark.parametrize('name', sorted(GRADS))
def test_gradients_follow_the_replicated_convention(coll_run, name):
    for rank, res in enumerate(coll_run):
        np.testing.assert_allclose(res[name], GRADS[name](rank), rtol=RTOL,
                                   atol=ATOL, err_msg='rank %d' % rank)


def test_copy_to_axis_is_the_identity_forward(coll_run):
    for rank, res in enumerate(coll_run):
        np.testing.assert_array_equal(res['copy'],
                                      X2[2 * rank:2 * rank + 2])


def test_quantized_allreduce_bit_equal_to_jax(coll_run):
    from mxnet_tpu_torch import quantization as port_q
    from mxnet_tpu import quantization as jax_q
    xq = INPUTS['XQ']
    want = _per_device(lambda a: jax_coll.quantized_allreduce(a, 'data'),
                       xq.reshape(N * 5, 7))
    for rank, res in enumerate(coll_run):
        np.testing.assert_array_equal(res['quant'], want[rank])
        np.testing.assert_array_equal(res['quant'], coll_run[0]['quant'])
    for r in range(N):
        s_jax = np.asarray(jax_q.symmetric_scale(jnp.asarray(xq[r])))
        s_port = port_q.symmetric_scale(torch.from_numpy(xq[r]))
        assert s_jax.tobytes() == s_port.numpy().tobytes()
        np.testing.assert_array_equal(
            np.asarray(jax_q.quantize_int8_math(jnp.asarray(xq[r]), s_jax)),
            port_q.quantize_int8_math(torch.from_numpy(xq[r]),
                                      s_port).numpy())


@pytest.mark.parametrize('env', [
    {}, {'MXNET_TPU_REDUCE_BUCKETS': '3'},
    {'MXNET_TPU_ZERO_BUCKET_MB': '0.0005'},
    {'MXNET_TPU_REDUCE_BUCKETS': '1'}])
def test_grad_reduce_plan_buckets_equal_jax(monkeypatch, env):
    for k in ('MXNET_TPU_REDUCE_BUCKETS', 'MXNET_TPU_ZERO_BUCKET_MB'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shapes = [(64, 32), (32,), (32, 128), (128,), (), (50, 16), (16,)]
    np_dtypes = [np.float32, np.float32, np.float16, np.float16,
                 np.float32, np.float32, np.float64]
    torch_dtypes = [torch.float32, torch.float32, torch.float16,
                    torch.float16, torch.float32, torch.float32,
                    torch.float64]
    ref = jax_coll.GradReducePlan(shapes, np_dtypes)
    mine = collectives.GradReducePlan(shapes, torch_dtypes)
    assert mine.buckets == ref.buckets
    assert mine.n_buckets == ref.n_buckets
    assert collectives.GradReducePlan(shapes, np_dtypes).buckets == \
        ref.buckets


def test_grad_reduce_plan_apply_sums_over_the_axis(coll_run):
    g = INPUTS['G']
    for res in coll_run:
        assert list(res['plan_buckets']) == [2, 1]
        for i in range(3):
            np.testing.assert_allclose(res['plan_%d' % i], g[:, i].sum(0),
                                       rtol=RTOL, atol=ATOL)
    plan = collectives.GradReducePlan([(2,)], [np.float32])
    grads = [torch.ones(2)]
    assert plan.apply(grads, None)[0] is grads[0]


def test_several_axes(coll_run):
    for rank, res in enumerate(coll_run):
        np.testing.assert_allclose(res['two_axes'], X2.reshape(4, 2, 3).sum(0),
                                   rtol=RTOL, atol=ATOL)
        # model pairs ranks (0, 1) and (2, 3) on the data x model mesh
        pair = (rank // 2) * 2
        np.testing.assert_allclose(
            res['model_only'],
            X2[2 * pair:2 * pair + 2] + X2[2 * pair + 2:2 * pair + 4],
            rtol=RTOL, atol=ATOL)


def test_staged_wire_is_counted_and_only_when_staged(coll_run):
    for rank, res in enumerate(coll_run):
        np.testing.assert_allclose(res['staged_sum'], res['sum'],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(res['staged_gather'], X2)
        payload = 2 * 3 * 4          # each collective's (2, 3) float32
        assert int(res['staged_collectives']) == 2
        assert int(res['staged_payload_bytes']) == 2 * payload
        # out and back: the sum's block, then the gather's block and
        # its four blocks back
        assert int(res['staged_staged_bytes']) == 2 * payload + 5 * payload
        assert int(res['unstaged_staged_bytes']) == 0


def test_constraint_forms_without_a_mesh_are_the_identity(coll_run):
    x = torch.ones(4, 2)
    for fn in (lambda: collectives.allreduce_bucket(x, None),
               lambda: collectives.reduce_scatter_bucket(x, None),
               lambda: collectives.allgather_bucket(x, None),
               lambda: collectives.row_shard_constraint(x, None),
               lambda: collectives.expert_shard(x),
               lambda: collectives.replicate_constraint(x)):
        assert fn() is x
    # over a mesh (item 6d): each rank its experts of the summed buffer,
    # the blocks joined back, and the cotangent of every rank's tokens
    # summed into each block; replicate_constraint is the identity
    n = len(coll_run)
    total = np.arange(8.0).reshape(4, 2) * sum(range(1, n + 1))
    for r, res in enumerate(coll_run):
        lo, hi = res['expert_range']
        assert (lo, hi) == (r * 4 // n, (r + 1) * 4 // n)
        np.testing.assert_array_equal(res['expert_block'], total[lo:hi])
        np.testing.assert_array_equal(res['expert_back'], total)
        np.testing.assert_array_equal(res['expert_grad'],
                                      np.full((4, 2), sum(range(1, n + 1))))
        assert bool(res['replicate_is_x'])
    # over a mesh the row form is a sparse table's stripe: 10 rows over
    # the data axis, ceil(10 / n) a rank, the last rank's short
    table = np.arange(20.0).reshape(10, 2)
    n = len(coll_run)
    s = -(-10 // n)
    for r, res in enumerate(coll_run):
        np.testing.assert_array_equal(res['row_stripe'],
                                      table[r * s:(r + 1) * s])
    with pytest.raises(ValueError, match='use_mesh'):
        collectives.allreduce_sum(x, 'data')
    # pipeline and moe are ported (item 6d): their modules import
    from mxnet_tpu_torch.parallel import moe, pipeline
    assert callable(pipeline.make_pipe_step_fn)
    assert callable(moe.make_moe_train_step)
    assert collectives.expert_shard(x) is x     # no mesh: the identity
    assert collectives.replicate_constraint(x) is x
