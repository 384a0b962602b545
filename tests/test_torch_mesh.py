"""The port's mesh (mxnet_tpu_torch.parallel.mesh) against the JAX
package's, on the CPU: four ranks of a gloo group (one spawn shared by
the file's checks) build meshes over the default group; the layout, the
batch blocks and the specs are held against mxnet_tpu.parallel.mesh on
the virtual CPU devices."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import mesh as jax_mesh
from mxnet_tpu_torch.parallel import mesh

import _torch_parallel_ranks as ranks

WORLD = 4


@pytest.fixture(scope='module')
def mesh_run(tmp_path_factory):
    return ranks.run(ranks.mesh_suite, WORLD, tmp_path_factory.mktemp('mesh'))


def test_mesh_layout_is_row_major_over_the_ranks(mesh_run):
    ref = jax_mesh.make_mesh({'data': 1, 'sp': 2, 'model': 2},
                             devices=jax.devices()[:WORLD])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for rank, res in enumerate(mesh_run):
        assert tuple(res['axis_names']) == ref.axis_names
        assert tuple(res['sizes']) == tuple(ref.shape.values())
        assert int(res['size']) == WORLD
        coord = tuple(int(c) for c in res['coordinate'])
        assert ids[coord] == rank
        for i, axis in enumerate(ref.axis_names):
            line = [slice(None) if j == i else coord[j] for j in range(3)]
            assert list(res['ranks_' + axis]) == list(ids[tuple(line)])
        assert str(res['backend']) == 'gloo' and not bool(res['staged'])


def test_mesh_devices_and_fingerprint_agree_on_every_rank(mesh_run):
    devices = [tuple(r['devices']) for r in mesh_run]
    assert len(set(devices)) == 1 and len(devices[0]) == WORLD
    assert all(d.endswith('/cpu') for d in devices[0])
    assert len({str(r['fingerprint']) for r in mesh_run}) == 1
    assert mesh.mesh_fingerprint(None) is None


def test_one_dimensional_mesh_and_sizes(mesh_run):
    for res in mesh_run:
        assert tuple(res['flat_names']) == ('data',)
        assert int(res['flat_size']) == WORLD
        assert str(res['too_big']) == 'mesh needs 8 devices, have 4'
    assert [bool(r['half_on_mesh']) for r in mesh_run] == \
        [True, True, False, False]
    with pytest.raises(ValueError, match='mesh needs 8 devices, have 4'):
        jax_mesh.make_mesh({'data': 8}, devices=jax.devices()[:WORLD])


def test_shard_batch_matches_jax(mesh_run):
    ref = jax_mesh.make_mesh({'data': WORLD}, devices=jax.devices()[:WORLD])
    x = jnp.arange(24, dtype=jnp.float32).reshape(8, 3)
    y = jnp.arange(16.0, dtype=jnp.float32).reshape(2, 8)
    for dim, arr, key in ((0, x, 'batch_block'), (1, y, 'batch_block_dim1')):
        placed = jax_mesh.shard_batch(ref, arr, dim=dim)
        by_device = {s.device.id: np.asarray(s.data)
                     for s in placed.addressable_shards}
        for rank, res in enumerate(mesh_run):
            np.testing.assert_array_equal(res[key], by_device[rank])


def test_replicate_params_broadcasts_the_root(mesh_run):
    for res in mesh_run:
        np.testing.assert_array_equal(res['replicated'], np.zeros(3))


def test_use_mesh_is_scoped_and_per_thread(mesh_run):
    for res in mesh_run:
        assert bool(res['current_is_m']) and bool(res['current_after'])
    seen = []
    marker = object()
    with mesh.use_mesh(marker):
        t = threading.Thread(target=lambda: seen.append(mesh.current_mesh()))
        t.start()
        t.join()
        assert mesh.current_mesh() is marker
    assert seen == [None] and mesh.current_mesh() is None


def test_specs_are_the_jax_specs():
    assert tuple(mesh.data_sharding(None)) == \
        tuple(jax_mesh.P('data'))
    assert tuple(mesh.replicated(None)) == tuple(jax_mesh.P())
    assert tuple(mesh.flat_sharding(None, 'sp')) == tuple(jax_mesh.P('sp'))
    assert repr(mesh.P(None, 'model')) == "P(None, 'model')"


def test_entry_points_without_cuda_raise(monkeypatch):
    """No device and no CUDA: the rank's device, the group and the mesh
    raise; they never fall back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_process_group(init_method='file:///nonexistent', rank=0,
                                world_size=1)
    assert mesh.default_device('cpu') == torch.device('cpu')


def test_make_mesh_needs_the_default_group():
    with pytest.raises(RuntimeError, match='init_process_group'):
        mesh.make_mesh({'data': 1}, device='cpu')


def test_backend_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert mesh.choose_backend('cpu', 1) == 'gloo'
    assert mesh.choose_backend('cuda:0', 1) == 'nccl'
    # ranks that share a card: NCCL takes one GPU per rank
    assert mesh.choose_backend('cuda:0', 4) == 'gloo'
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert mesh.choose_backend('cuda:3', 4) == 'nccl'


def test_init_process_group_reads_torchrun_variables(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match='RANK and WORLD_SIZE'):
        mesh.init_process_group(device='cpu')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(ValueError, match='MASTER_ADDR'):
        mesh.init_process_group(device='cpu')
