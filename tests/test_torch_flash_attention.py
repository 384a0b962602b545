"""Parity of the port's attention (mxnet_tpu_torch.cuda_ops and
parallel.ring_attention) with the JAX package's, on the CPU.

On the CPU the port's wrappers take their plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp

from mxnet_tpu import pallas_ops
from mxnet_tpu.parallel.ring_attention import full_attention as jax_full
from mxnet_tpu_torch import cuda_ops
from mxnet_tpu_torch.parallel.ring_attention import (
    full_attention as torch_full)

REPO = Path(__file__).resolve().parent.parent
# the JAX package's own flash tolerance (tests/test_parallel.py)
RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed, q_shape, k_shape, scale=1.0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(*q_shape) * scale).astype(np.float32)
    k = (rs.randn(*k_shape) * scale).astype(np.float32)
    v = (rs.randn(*k_shape) * scale).astype(np.float32)
    return q, k, v


CASES = [
    # (q shape, k shape, causal)
    ((2, 3, 64, 16), (2, 3, 64, 16), False),
    ((2, 3, 64, 16), (2, 3, 64, 16), True),
    ((2, 3, 16, 16), (2, 3, 64, 16), True),    # rectangular: offset 48
    ((1, 2, 48, 8), (1, 2, 48, 8), True),      # odd length
    ((1, 2, 30, 8), (1, 2, 30, 8), False),     # JAX's dense-fallback length
    ((1, 2, 30, 8), (1, 2, 30, 8), True),
]


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES)
def test_flash_attention_matches_jax(q_shape, k_shape, causal):
    q, k, v = _qkv(0, q_shape, k_shape)
    ref = pallas_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
    out = cuda_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES)
def test_flash_attention_with_lse_matches_jax(q_shape, k_shape, causal):
    q, k, v = _qkv(1, q_shape, k_shape, scale=0.4)
    ref_o, ref_lse = pallas_ops.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True)
    out, lse = cuda_ops.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    b, h, tq, _ = q_shape
    assert lse.shape == (b * h, tq, 1) == ref_lse.shape
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=RTOL, atol=ATOL)


def test_flash_attention_explicit_scale():
    q, k, v = _qkv(2, (1, 2, 32, 16), (1, 2, 32, 16))
    ref = pallas_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, scale=0.3,
                                     interpret=True)
    out = cuda_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


BAD_SHAPES = [
    # causal with q_len > kv_len
    ((1, 1, 64, 16), (1, 1, 32, 16), (1, 1, 32, 16), True),
    # k / v shape mismatch
    ((1, 1, 64, 16), (1, 1, 32, 16), (1, 1, 16, 16), False),
    # head_dim mismatch
    ((1, 1, 8, 16), (1, 1, 8, 8), (1, 1, 8, 8), False),
]


@pytest.mark.parametrize('fn', ['flash_attention', 'flash_attention_with_lse'])
@pytest.mark.parametrize('q_shape,k_shape,v_shape,causal', BAD_SHAPES)
def test_validation_errors_match_jax(fn, q_shape, k_shape, v_shape, causal):
    with pytest.raises(ValueError) as jax_err:
        getattr(pallas_ops, fn)(jnp.zeros(q_shape), jnp.zeros(k_shape),
                                jnp.zeros(v_shape), causal=causal)
    with pytest.raises(ValueError) as port_err:
        getattr(cuda_ops, fn)(torch.zeros(q_shape), torch.zeros(k_shape),
                              torch.zeros(v_shape), causal=causal)
    assert str(port_err.value) == str(jax_err.value)


def test_full_attention_rejects_causal_tq_gt_tk():
    q = torch.zeros(1, 1, 64, 16)
    k = torch.zeros(1, 1, 32, 16)
    with pytest.raises(ValueError, match='q_len <= kv_len'):
        torch_full(q, k, k, causal=True)


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('q_len,causal', [(32, False), (32, True),
                                          (8, True)])
def test_full_attention_matches_jax(use_flash, q_len, causal):
    q, k, v = _qkv(3, (2, 2, q_len, 16), (2, 2, 32, 16))
    ref = jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, use_flash=use_flash)
    launches = cuda_ops.FLASH_FWD_LAUNCHES
    out = torch_full(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=causal,
                     use_flash=use_flash)
    # on the CPU no kernel launches, whichever path is taken
    assert cuda_ops.FLASH_FWD_LAUNCHES == launches
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('d', [1, 7, 100, 192, 256, 320, 512])
def test_kernel_inputs_take_head_dim_up_to_256(d):
    """The kernels take any head_dim, ragged or not, and past 256 (in
    column groups), as the JAX package's flash_attention does."""
    q = torch.zeros(1, 2, 8, d)
    cuda_ops._check_kernel_inputs(q, q, q, 'flash attention')


@pytest.mark.parametrize('d', [257, 320])
def test_kernel_inputs_refuse_head_dim_over_256(d):
    """head_dim over 256 was refused; the kernels now split the output
    columns into groups of at most 256 and take it, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 8, d, dtype=dtype)
        cuda_ops._check_kernel_inputs(q, q, q, 'flash attention')
    z = torch.zeros(1, 2, 8, 0)
    with pytest.raises(ValueError, match='no empty inputs'):
        cuda_ops._check_kernel_inputs(z, z, z, 'flash attention')


def test_wrapper_rejects_unsupported_device():
    q = torch.zeros(1, 1, 8, 8, device='meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        cuda_ops.flash_attention(q, q, q)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port adds no jax and no mxnet_tpu
    module to a fresh interpreter (modules it had before are ignored)."""
    code = (
        'import sys\n'
        'before = set(sys.modules)\n'
        'import mxnet_tpu_torch, mxnet_tpu_torch._build, '
        'mxnet_tpu_torch.context, mxnet_tpu_torch.cuda_ops, '
        'mxnet_tpu_torch.cuda_conv, mxnet_tpu_torch.tools, '
        'mxnet_tpu_torch.tools.bench_conv_bn, '
        'mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.ring_attention, '
        'mxnet_tpu_torch.parallel.transformer, '
        'mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.parallel.collectives, '
        'mxnet_tpu_torch.parallel.zero, mxnet_tpu_torch.parallel.embedding, '
        'mxnet_tpu_torch.parallel.pipeline, mxnet_tpu_torch.parallel.moe, '
        'mxnet_tpu_torch.gluon.nn.moe, mxnet_tpu_torch.module.pipeline_fit, '
        'mxnet_tpu_torch.gluon.fused, mxnet_tpu_torch.operator, '
        'mxnet_tpu_torch.contrib, mxnet_tpu_torch.contrib.autograd, '
        'mxnet_tpu_torch.visualization, mxnet_tpu_torch.test_utils, '
        'mxnet_tpu_torch.executor_manager, mxnet_tpu_torch.log, '
        'mxnet_tpu_torch.registry, mxnet_tpu_torch.parallel.worker_group, '
        'mxnet_tpu_torch.parallel.batch_reduce\n'
        'added = set(sys.modules) - before\n'
        "bad = sorted(m for m in added if m == 'jax' or "
        "m.startswith('jax.') or m == 'mxnet_tpu' or "
        "m.startswith('mxnet_tpu.'))\n"
        'print(repr(bad))\n')
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Every module of the port (pkgutil's walk of the package), imported
    in a fresh interpreter, adds no jax and no mxnet_tpu module."""
    code = (
        'import importlib, pkgutil, sys\n'
        'before = set(sys.modules)\n'
        'import mxnet_tpu_torch\n'
        'names = sorted(m.name for m in pkgutil.walk_packages('
        "mxnet_tpu_torch.__path__, 'mxnet_tpu_torch.'))\n"
        'for n in names:\n'
        '    importlib.import_module(n)\n'
        'added = set(sys.modules) - before\n'
        "bad = sorted(m for m in added if m == 'jax' or "
        "m.startswith('jax.') or m == 'mxnet_tpu' or "
        "m.startswith('mxnet_tpu.'))\n"
        'print(len(names), repr(bad))\n')
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(' ', 1)
    assert int(count) > 90 and bad.strip() == '[]'


def test_port_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(r'^\s*(import jax\b|from jax\b|'
                         r'import mxnet_tpu(?!_torch)|from mxnet_tpu(?!_torch))',
                         re.M)
    files = sorted((REPO / 'mxnet_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) >= 10
    for path in files:
        assert not pattern.search(path.read_text()), path
