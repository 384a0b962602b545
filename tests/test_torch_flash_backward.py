"""Gradients of the port's flash attention (mxnet_tpu_torch.cuda_ops)
against the JAX package's, on the CPU.

On the CPU the port's autograd Function runs its plain backward,
`flash_attention_bwd_reference`; the JAX side differentiates its Pallas
kernels in interpret mode through their custom VJPs. The CUDA backward
kernels are held against the plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from mxnet_tpu import pallas_ops
from mxnet_tpu_torch import cuda_ops
from mxnet_tpu_torch.parallel import transformer as tfm

from test_torch_flash_attention import CASES, _qkv

# the JAX package's own flash-gradient tolerance (tests/test_parallel.py)
RTOL, ATOL = 2e-4, 2e-5


def _cotangents(seed, q_shape):
    rs = np.random.RandomState(seed)
    b, h, tq, _ = q_shape
    g = (rs.randn(*q_shape) * 0.3).astype(np.float32)
    gl = (rs.randn(b * h, tq, 1) * 0.3).astype(np.float32)
    return g, gl


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES)
def test_flash_attention_grad_matches_jax(q_shape, k_shape, causal):
    q, k, v = _qkv(5, q_shape, k_shape, scale=0.4)
    g, _ = _cotangents(6, q_shape)
    _, vjp = jax.vjp(lambda q, k, v: pallas_ops.flash_attention(
        q, k, v, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))

    tq, tk, tv = _leaves(q, k, v)
    out = cuda_ops.flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == '_FlashAttentionBackward'
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for mine, theirs in zip(grads, ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES)
def test_flash_attention_with_lse_grad_matches_jax(q_shape, k_shape, causal):
    """Both outputs carry a cotangent (the loss sum(out*g) +
    sum(lse*gl)), so the lse's folds into D."""
    q, k, v = _qkv(7, q_shape, k_shape, scale=0.4)
    g, gl = _cotangents(8, q_shape)
    _, vjp = jax.vjp(lambda q, k, v: pallas_ops.flash_attention_with_lse(
        q, k, v, causal=causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp((jnp.asarray(g), jnp.asarray(gl)))

    tq, tk, tv = _leaves(q, k, v)
    out, lse = cuda_ops.flash_attention_with_lse(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                (torch.from_numpy(g), torch.from_numpy(gl)))
    for mine, theirs in zip(grads, ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES[1:4])
def test_unused_lse_adds_nothing(q_shape, k_shape, causal):
    """With the lse unused, the with-lse gradients are flash_attention's,
    and a zero lse cotangent gives the same."""
    q, k, v = _qkv(9, q_shape, k_shape, scale=0.4)
    g, gl = _cotangents(10, q_shape)
    tq, tk, tv = _leaves(q, k, v)
    plain = torch.autograd.grad(
        cuda_ops.flash_attention(tq, tk, tv, causal=causal), (tq, tk, tv),
        torch.from_numpy(g))
    out, _ = cuda_ops.flash_attention_with_lse(tq, tk, tv, causal=causal)
    unused = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    out, lse = cuda_ops.flash_attention_with_lse(tq, tk, tv, causal=causal)
    zero = torch.autograd.grad((out, lse), (tq, tk, tv),
                               (torch.from_numpy(g), torch.zeros_like(lse)))
    for a, b, c in zip(plain, unused, zero):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize('q_shape,k_shape,causal', CASES)
def test_bwd_reference_is_the_gradient_in_float64(q_shape, k_shape, causal):
    """The plain backward's recompute formula equals autograd through the
    plain forward, to float64 rounding, with both cotangents nonzero."""
    q, k, v = _qkv(11, q_shape, k_shape)
    g, gl = _cotangents(12, q_shape)
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (q, k, v)]
    out, lse = cuda_ops.flash_attention_reference(*leaves, causal, 0.3)
    gt, glt = torch.from_numpy(g).double(), torch.from_numpy(gl).double()
    ref = torch.autograd.grad((out, lse), leaves, (gt, glt))
    mine = cuda_ops.flash_attention_bwd_reference(
        *(t.detach() for t in leaves), out.detach(), lse.detach(), gt, glt,
        causal=causal, scale=0.3)
    for a, b in zip(mine, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_bwd_reference_rounds_as_the_kernels_in_bfloat16():
    """In bf16 the plain backward rounds p to dO's dtype before dV and ds
    to q's before dK and dQ; the gradients come back in the inputs'
    dtype and near the float32 ones."""
    q, k, v = _qkv(13, (1, 2, 32, 16), (1, 2, 32, 16), scale=0.5)
    g, gl = _cotangents(14, (1, 2, 32, 16))
    f32 = [torch.from_numpy(a) for a in (q, k, v, g)]
    bf = [t.bfloat16() for t in f32]
    o32, l32 = cuda_ops.flash_attention_reference(*f32[:3], True)
    obf, lbf = cuda_ops.flash_attention_reference(*bf[:3], True)
    assert lbf.dtype == torch.float32
    exact = cuda_ops.flash_attention_bwd_reference(
        *f32[:3], o32, l32, f32[3], torch.from_numpy(gl), causal=True)
    rounded = cuda_ops.flash_attention_bwd_reference(
        *bf[:3], obf, lbf, bf[3], torch.from_numpy(gl), causal=True)
    for a, b in zip(rounded, exact):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) < 3e-2 * scale
        assert not torch.equal(a.float(), b)


def _bf16_variant_grads(variant):
    """(dq, dk, dv) of the plain backward in bf16 at (1, 4, 256, 64)
    causal, and the same recomputed with its sums in float64 and one
    change: 'sound' none, 'p_not_rounded' / 'ds_not_rounded' leave out a
    rounding before the products, 'q_tile_skipped' drops one 64-row q
    tile from dK and dV."""
    rs = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 4, 256, 64).astype(
        np.float32)).bfloat16() for _ in range(4))
    scale = 0.125
    out, lse = cuda_ops.flash_attention_reference(q, k, v, True, scale)
    dd = cuda_ops.attention_bwd_delta(out, do)
    ref = (cuda_ops.flash_attention_bwd_dq_reference(q, k, v, do, lse, dd,
                                                     True, scale),
           *cuda_ops.flash_attention_bwd_dkdv_reference(q, k, v, do, lse, dd,
                                                        True, scale))
    p, ds = cuda_ops._probs_and_dscores(q, k, v, do, lse, dd, True, scale)
    f64 = torch.float64
    p_used = p.to(f64) if variant == 'p_not_rounded' else \
        p.bfloat16().to(f64)
    ds_used = ds.to(f64) if variant == 'ds_not_rounded' else \
        ds.bfloat16().to(f64)
    dq = torch.einsum('bhqk,bhkd->bhqd', ds_used, k.to(f64)) * scale
    if variant == 'q_tile_skipped':
        p_used[:, :, 128:192] = 0
        ds_used[:, :, 128:192] = 0
    got = (dq, torch.einsum('bhqk,bhqd->bhkd', ds_used, q.to(f64)) * scale,
           torch.einsum('bhqk,bhqd->bhkd', p_used, do.to(f64)))
    return [g.bfloat16() for g in got], ref


@pytest.mark.parametrize('variant,broken', [
    ('sound', ()), ('p_not_rounded', (2,)), ('ds_not_rounded', (0, 1)),
    ('q_tile_skipped', (1, 2))])
def test_chip_smoke_bf16_backward_gate(variant, broken):
    """chip_smoke.py's bf16 check of a backward kernel against its plain
    version passes another summing order, which differs on under 0.1 %
    of the elements, and fails a rounding left out (over 30 % differ by
    a bf16 step) or a skipped q tile."""
    import chip_smoke
    tol = chip_smoke.BWD_TOL['bfloat16']
    got, ref = _bf16_variant_grads(variant)
    for i, (a, b) in enumerate(zip(got, ref)):
        check = chip_smoke.grad_mismatch(torch, a, b, tol)
        if i not in broken:
            assert check['ok'] and check['share_differ'] < 1e-3, check
        else:
            assert not check['ok'], check
            if variant != 'q_tile_skipped':
                assert check['share_differ'] > 0.3, check


def test_cpu_backward_launches_no_kernel():
    q, k, v = _qkv(15, (1, 2, 16, 8), (1, 2, 16, 8))
    tq, tk, tv = _leaves(q, k, v)
    before = (cuda_ops.FLASH_FWD_LAUNCHES, cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
              cuda_ops.FLASH_BWD_DQ_LAUNCHES)
    cuda_ops.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert tq.grad is not None and tk.grad is not None
    assert (cuda_ops.FLASH_FWD_LAUNCHES, cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
            cuda_ops.FLASH_BWD_DQ_LAUNCHES) == before


@pytest.mark.parametrize('fn', [cuda_ops.flash_attention_bwd_dkdv_cuda,
                                cuda_ops.flash_attention_bwd_dq_cuda])
def test_bwd_kernel_wrappers_check_their_inputs(fn):
    """The kernel wrappers refuse what the kernels do not take before
    anything is built or launched."""
    q = torch.zeros(1, 2, 8, 16)
    rows = torch.zeros(2, 8, 1)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fn(q.double(), q.double(), q.double(), q.double(), rows, rows,
           True, 0.25)
    with pytest.raises(TypeError, match="dO of q's shape"):
        fn(q, q, q, q.bfloat16(), rows, rows, True, 0.25)
    with pytest.raises(TypeError, match='lse float32'):
        fn(q, q, q, q, rows.double(), rows, True, 0.25)
    with pytest.raises(TypeError, match='D float32'):
        fn(q, q, q, q, rows, torch.zeros(2, 8), True, 0.25)
    with pytest.raises(ValueError, match='contiguous'):
        fn(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2), rows,
           rows, True, 0.25)
    with pytest.raises(ValueError, match='head_dim from 1 to 256; got 257'):
        z = torch.zeros(1, 2, 8, 257)
        fn(z, z, z, z, rows, rows, True, 0.25)
    with pytest.raises(ValueError, match='one CUDA device'):
        fn(q, q, q, q, rows, rows, True, 0.25)


def test_lm_flash_path_gives_every_parameter_a_gradient():
    """The LM's flash path is differentiable through the Function: every
    parameter, wqkv included, gets a nonzero gradient, equal to the plain
    attention path's."""
    cfg = tfm.lm_config(vocab=64, dim=32, heads=4, layers=2, use_flash=True)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device='cpu')
    rs = np.random.RandomState(16)
    tok = torch.from_numpy(rs.randint(0, 64, (2, 17))).long()
    grads = {}
    for use_flash in (True, False):
        model = tfm.TransformerLM(dict(cfg, use_flash=use_flash),
                                  {k: v if k != 'layers' else
                                   [dict(lp) for lp in v]
                                   for k, v in params.items()})
        model.loss(tok[:, :-1], tok[:, 1:]).backward()
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()}
    for name, g in grads[True].items():
        assert g is not None and bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), grads[False][name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
