"""The 16-bit flash forward's plain version and float16 through the port,
against the JAX package, on the CPU.

`cuda_ops.flash_attention_online_reference` is what the tensor-core
forward (csrc/flash_attention_sm90.cu) is held to on the card: the
online recurrence of pallas_ops._online_softmax_step over key tiles,
with p rounded to v's dtype. Here it runs against the JAX package's
Pallas forward in interpret mode at the same key tile, in bfloat16,
float16 and float32; then the port's flash attention, its gradient and
the LM in float16 against JAX's. The kernels themselves are held to the
plain versions on the card by chip_smoke.py, whose forward gate is
checked here against an emulation of the tensor cores' summing order.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

import chip_smoke
from mxnet_tpu import pallas_ops
from mxnet_tpu.parallel import transformer as jax_tfm
from mxnet_tpu_torch import cuda_ops
from mxnet_tpu_torch.parallel import transformer as tfm

from test_torch_transformer import _jax_lm, _numpy_tree

DTYPES = {'bfloat16': (jnp.bfloat16, torch.bfloat16),
          'float16': (jnp.float16, torch.float16),
          'float32': (jnp.float32, torch.float32)}
# (q length, kv length, causal, head_dim): lengths are multiples of 64,
# so that JAX's key tile is 64 for square attention (pallas_ops.py:187),
# the kernel's; rectangular attention takes JAX's own tile (256 here)
SHAPES = [(128, 128, True, 32), (64, 256, True, 32), (128, 128, False, 32),
          (256, 256, True, 64)]
# the JAX package's flash tolerance for float32 (tests/test_parallel.py)
F32_TOL = dict(rtol=2e-4, atol=2e-5)
LSE_ATOL = 1e-5


def _inputs(seed, tq, tk, d, batch=1, heads=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(batch, heads, t, d).astype(np.float32)
            for t in (tq, tk, tk)]


def _check_16bit(got, ref, dtype_name):
    """got against ref under chip_smoke's forward gate: one 16-bit step
    of the value plus 1e-3 of the largest, and the share that differs at
    all within the gate's."""
    check = chip_smoke.grad_mismatch(torch, got, ref,
                                     chip_smoke.FWD_TOL[dtype_name])
    assert check['ok'], check
    return check


@pytest.mark.parametrize('dtype_name', sorted(DTYPES))
@pytest.mark.parametrize('tq,tk,causal,d', SHAPES)
def test_online_reference_matches_jax_flash(dtype_name, tq, tk, causal, d):
    jdt, tdt = DTYPES[dtype_name]
    q, k, v = _inputs(tq + tk + d, tq, tk, d)
    ref_o, ref_lse = pallas_ops.flash_attention_with_lse(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
        block_q=64, interpret=True)
    block_k = pallas_ops._fit_block(tk, 64 if tq == tk else 256)
    out, lse = cuda_ops.flash_attention_online_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal,
        block_k=block_k)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == ref_lse.shape
    ref = torch.from_numpy(np.asarray(ref_o.astype(jnp.float32))).to(tdt)
    if dtype_name == 'float32':
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **F32_TOL)
    else:
        _check_16bit(out, ref, dtype_name)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0,
                               atol=LSE_ATOL)


def test_online_reference_is_attention_in_float64():
    """Over float64 inputs, where the rounding of p to v's dtype changes
    nothing, the recurrence is the dense softmax attention."""
    q, k, v = (torch.from_numpy(x).double() for x in _inputs(3, 96, 160, 24))
    for causal in (False, True):
        out, lse = cuda_ops.flash_attention_online_reference(
            q, k, v, causal, block_k=64)
        ref, ref_lse = cuda_ops.flash_attention_reference(q, k, v, causal)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize('tq,tk,causal', [(128, 128, True), (64, 128, True),
                                          (128, 128, False)])
def test_float16_flash_and_its_gradient_match_jax(tq, tk, causal):
    """The port's flash attention in float16 (on the CPU: the plain
    forward, p unrounded, and the plain backward) against the JAX
    package's Pallas kernels in float16, forward and jax.grad: within
    2^-8 of the largest value, a few float16 steps there, since JAX's
    forward rounds p to float16 (2^-11) where the plain one does not."""
    q, k, v = _inputs(7, tq, tk, 32, batch=2)
    g = np.random.RandomState(8).randn(2, 2, tq, 32).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.float16) for x in (q, k, v, g))

    def jax_fn(a, b, c):
        out = pallas_ops.flash_attention(a, b, c, causal=causal, block_q=64,
                                         interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    ref_o = pallas_ops.flash_attention(jq, jk, jv, causal=causal,
                                       block_q=64, interpret=True)
    ref_grads = jax.grad(jax_fn, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [torch.from_numpy(x).half().requires_grad_(True)
              for x in (q, k, v)]
    out = cuda_ops.flash_attention(*leaves, causal=causal)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(g).half())
    pairs = [(out.detach(), ref_o)] + [
        (t.grad, r) for t, r in zip(leaves, ref_grads)]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2.0 ** -8 * np.abs(ref).max())


@pytest.mark.parametrize('use_flash', [True, False])
def test_lm_forward_in_float16_matches_jax(use_flash):
    """The LM with float16 weights (params_from_jax of a float16 tree)
    against the JAX package's in float16: logits within 2^-8 of the
    largest, a float16 step or two there, and the loss within 1e-3."""
    widths = dict(vocab=64, dim=128, heads=2, layers=2, use_flash=use_flash)
    cfg = jax_tfm.lm_config(**widths)
    jparams = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float16),
        jax_tfm.init_params(cfg, jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg['vocab'], (2, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    fwd, loss = _jax_lm(cfg)
    ref = np.asarray(fwd(jparams, jnp.asarray(tokens)), np.float32)
    ref_loss = float(loss(jparams, jnp.asarray(tokens),
                          jnp.asarray(targets)))
    model = tfm.TransformerLM(tfm.lm_config(**widths), tfm.params_from_jax(
        _numpy_tree(jparams), device='cpu'))
    tt = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        logits = model(tt)
        nll = float(model.loss(tt, torch.from_numpy(targets).long()))
    assert logits.dtype == torch.float16
    np.testing.assert_allclose(logits.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * np.abs(ref).max())
    assert abs(nll - ref_loss) < 1e-3


@pytest.mark.parametrize('embed_std', [0.02, 0.05])
def test_float16_gradient_overflows_where_jax_does(embed_std):
    """The LM's float16 gradient (plain attention, as chip_smoke's float16
    train check compares the kernels with it): at the 0.02 init the
    activations' mean square, 4e-4, makes RMSNorm's backward overflow
    float16 (rsqrt(var)^3 = 1.25e5), and the JAX package's gradient is
    non-finite in the same parameters as the port's; at the embedding
    scale chip_smoke's float16 step takes (F16_EMBED_STD) both are finite
    and agree."""
    widths = dict(vocab=64, dim=64, heads=2, layers=2)
    cfg = jax_tfm.lm_config(**widths)
    tree = chip_smoke.seeded_tree(cfg, 8, embed_std=embed_std)
    jtree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float16),
                                   tree)
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 64, (2, 33)).astype(np.int32)
    _, loss = _jax_lm(cfg)
    jgrads = jax.jit(jax.grad(loss))(jtree, jnp.asarray(tok[:, :-1]),
                                     jnp.asarray(tok[:, 1:]))
    model = tfm.TransformerLM(tfm.lm_config(**widths), tfm.params_from_jax(
        tree, dtype=torch.float16, device='cpu'))
    tt = torch.from_numpy(tok).long()
    model.loss(tt[:, :-1], tt[:, 1:]).backward()
    grads = dict(model.named_parameters())
    pairs = [('embed', jgrads['embed']), ('ln_f', jgrads['ln_f'])] + [
        ('layers.%d.%s' % (i, key), lp[key])
        for i, lp in enumerate(jgrads['layers']) for key in lp]
    finite = {}
    for name, ref in pairs:
        got = grads[name].grad.float().numpy()
        ref = np.asarray(ref, np.float32)
        finite[name] = bool(np.isfinite(ref).all())
        assert bool(np.isfinite(got).all()) == finite[name], name
        if finite[name]:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6 *
                                       np.abs(ref).max(), err_msg=name)
    assert all(finite.values()) == (
        embed_std == chip_smoke.F16_EMBED_STD)


def _blocks16(a, b):
    """a @ b^T over the last axis as the tensor cores sum: each block of
    16 products exactly (float64), rounded to float32, the blocks added
    in float32."""
    out = None
    for c in range(0, a.shape[-1], 16):
        part = torch.einsum('bhqd,bhkd->bhqk', a[..., c:c + 16].double(),
                            b[..., c:c + 16].double()).float()
        out = part if out is None else out + part
    return out


def _online_with(q, k, v, scores, round_p):
    """The online recurrence at 64-key tiles, causal with rows
    suffix-aligned to the keys, with s from `scores` and p rounded to v's
    dtype or not."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    m = torch.full((b, h, tq, 1), float('-inf'))
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, d))
    rows = torch.arange(tq)[:, None] + (tk - tq)
    for k0 in range(0, tk, 64):
        s = scores(q, k[:, :, k0:k0 + 64]) * (d ** -0.5)
        s = s.masked_fill(rows < torch.arange(k0, k0 + 64)[None, :],
                          float('-inf'))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pr = p.to(v.dtype).float() if round_p else p
        acc = acc * corr + torch.einsum('bhqk,bhkd->bhqd', pr,
                                        v[:, :, k0:k0 + 64].float())
        m = m_new
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize('dtype_name', ['bfloat16', 'float16'])
@pytest.mark.parametrize('variant', ['tensor_core_order', 'p_unrounded'])
def test_tensor_core_order_passes_the_forward_gate(dtype_name, variant):
    """The kernel sums s on the tensor cores, 16 products a block, where
    the plain version sums in float32 on the CUDA cores. Emulated at
    (1, 8, 512, 64) causal, that order moves under 0.2 % of the bf16
    outputs and about 1 % of the float16 ones by a step, all within
    chip_smoke.py's FWD_TOL; p left unrounded moves over 30 % and fails
    it."""
    tdt = DTYPES[dtype_name][1]
    q, k, v = (torch.from_numpy(x).to(tdt)
               for x in _inputs(21, 512, 512, 64, heads=8))
    f32 = lambda a, b: torch.einsum('bhqd,bhkd->bhqk', a.float(), b.float())
    ref = _online_with(q, k, v, f32, True)
    assert torch.equal(ref, cuda_ops.flash_attention_online_reference(
        q, k, v, True, block_k=64)[0])
    tol = chip_smoke.FWD_TOL[dtype_name]
    if variant == 'tensor_core_order':
        check = _check_16bit(_online_with(q, k, v, _blocks16, True), ref,
                             dtype_name)
        assert check['share_differ'] < tol['differ'] / 5
    else:
        check = chip_smoke.grad_mismatch(
            torch, _online_with(q, k, v, f32, False), ref, tol)
        assert not check['ok'] and check['share_differ'] > 0.3, check


@pytest.mark.parametrize('truncate', [False, True])
def test_tensor_core_accumulation_passes_the_float16_backward_gate(truncate):
    """The backward's emulation (test_torch_flash_backward.py) in
    float16: the tensor cores' 16-product blocks, added into fp32 rounded
    to nearest or toward zero, move under 1 % of the float16 gradients
    by a step, within chip_smoke.py's BWD_TOL['float16'] (at most 5 %),
    while p left unrounded moves over 30 % of dv."""
    from test_torch_flash_backward import _tc_matmul
    rs = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 4, 256, 64).astype(
        np.float32)).half() for _ in range(4))
    scale = 0.125
    out, lse = cuda_ops.flash_attention_reference(q, k, v, True, scale)
    dd = cuda_ops.attention_bwd_delta(out, do)
    args = (q, k, v, do, lse, dd, True, scale)
    ref = (cuda_ops.flash_attention_bwd_dq_reference(*args),
           *cuda_ops.flash_attention_bwd_dkdv_reference(*args))
    Q, K, V, dO = (t.float().numpy() for t in (q, k, v, do))
    T = lambda x: np.swapaxes(x, -1, -2)
    h = lambda x: torch.from_numpy(x).half().float().numpy()
    s = _tc_matmul(Q, T(K), truncate) * np.float32(scale)
    p = np.where(np.tril(np.ones((256, 256), bool)),
                 np.exp(s - lse.reshape(1, 4, 256, 1).numpy()),
                 0).astype(np.float32)
    dp = _tc_matmul(dO, T(V), truncate)
    ds = (p * (dp - dd.reshape(1, 4, 256, 1).numpy())).astype(np.float32)
    got = (_tc_matmul(h(ds), K, truncate) * np.float32(scale),
           _tc_matmul(T(h(ds)), Q, truncate) * np.float32(scale),
           _tc_matmul(T(h(p)), dO, truncate))
    tol = chip_smoke.BWD_TOL['float16']
    for a, b in zip(got, ref):
        check = chip_smoke.grad_mismatch(torch, torch.from_numpy(a).half(),
                                         b, tol)
        assert check['ok'] and check['share_differ'] < 1e-2, check
    unrounded = chip_smoke.grad_mismatch(
        torch, torch.from_numpy(_tc_matmul(T(p), dO, truncate)).half(),
        ref[2], tol)
    assert unrounded['share_differ'] > 0.3, unrounded


@pytest.mark.parametrize('dtype,code', [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_forward_wrapper_passes_each_dtype_to_the_library(monkeypatch,
                                                          dtype, code):
    """The wrapper hands the library the dtype code of its dispatch
    (float32 to the 3xTF32 tensor-core kernel, bfloat16 and float16 to
    the 16-bit one), counts the launch, and returns q's dtype and a
    float32 lse."""
    calls = []
    monkeypatch.setattr(cuda_ops, '_launch',
                        lambda entry, what, *args, device: calls.append(
                            (entry, args)))
    q = torch.zeros(1, 2, 8, 16, dtype=dtype)
    before = cuda_ops.FLASH_FWD_LAUNCHES
    out, lse = cuda_ops._flash_fwd_cuda(q, q, q, True, 0.25)
    assert cuda_ops.FLASH_FWD_LAUNCHES == before + 1
    (entry, args), = calls
    assert entry == 'mxt_flash_attention_fwd' and args[-1] == code
    assert out.dtype == dtype and lse.dtype == torch.float32
    with pytest.raises(TypeError, match='float16'):
        cuda_ops._flash_fwd_cuda(q.double(), q.double(), q.double(), True,
                                 0.25)


@pytest.mark.parametrize('source,table', [
    ('flash_attention_sm90.cu', 'FWD_MUTANTS'),
    ('flash_attention_bwd_sm90.cu', 'BWD_MUTANTS'),
    ('flash_attention_bwd_tf32.cu', 'TF32_BWD_MUTANTS')])
def test_each_mutant_edits_its_source_once(source, table):
    """chip_smoke.py --mutants edits each text once in its kernel's
    source; a text that is gone or repeated would refuse the check."""
    text = (chip_smoke.Path(chip_smoke.__file__).parent / 'mxnet_tpu_torch' /
            'csrc' / source).read_text()
    for name, (old, new) in getattr(chip_smoke, table).items():
        assert text.count(old) == 1, name
        assert old != new, name


def _emulated_shares():
    """The shares of chip_smoke's FWD_TOL comment: the outputs that the
    tensor cores' summing order of s moves by a 16-bit step, at the
    square shape and at decode, and those that an unrounded p moves."""
    f32 = lambda a, b: torch.einsum('bhqd,bhkd->bhqk', a.float(), b.float())
    for dtype_name in ('bfloat16', 'float16'):
        tdt = DTYPES[dtype_name][1]
        tol = dict(chip_smoke.FWD_TOL[dtype_name], differ=1.0)
        for tq in (512, 16):
            q, k, v = (torch.from_numpy(x).to(tdt)
                       for x in _inputs(21, tq, 1024 if tq == 16 else tq,
                                        64, heads=8))
            ref = cuda_ops.flash_attention_online_reference(
                q, k, v, True, block_k=64)[0]
            for name, scores, round_p in (('tensor-core order', _blocks16,
                                           True),
                                          ('p unrounded', f32, False)):
                got = _online_with(q, k, v, scores, round_p)
                check = chip_smoke.grad_mismatch(torch, got, ref, tol)
                print('%s (1, 8, %d, 64) against %d keys, %s: %.3f %% of '
                      'outputs differ, %d over the gate' % (
                          dtype_name, tq, k.shape[2], name,
                          100 * check['share_differ'], check['over_tol']))


def _float16_underflow():
    """The float16 gradients of the LM at full width (dim 1024, 16 heads,
    2 layers, vocab 50257) over 512 tokens, the loss scaled by 1/16 (the
    per-token scale of a mean over 8192 tokens) and by 2^12 / 16: how far
    the two attention paths' plain versions disagree, and the share of
    layer 0's wqkv gradient below float16's smallest normal."""
    cfg = tfm.lm_config(vocab=50257, dim=1024, heads=16, layers=2,
                        use_flash=True)
    tree = chip_smoke.seeded_tree(cfg, 8,
                                  embed_std=chip_smoke.F16_EMBED_STD)
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50257, (1, 513))).long()
    for scale in (1 / 16, chip_smoke.F16_LOSS_SCALE / 16):
        grads = {}
        for use_flash in (True, False):
            model = tfm.TransformerLM(dict(cfg, use_flash=use_flash),
                                      tfm.params_from_jax(
                                          tree, dtype=torch.float16,
                                          device='cpu'))
            (model.loss(tok[:, :-1], tok[:, 1:]) * scale).backward()
            grads[use_flash] = {n: p.grad.float()
                                for n, p in model.named_parameters()}
        rel = max(float((grads[True][n] - grads[False][n]).norm() /
                        grads[False][n].norm()) for n in grads[True])
        low = float((grads[True]['layers.0.wqkv'].abs() < 2.0 ** -14)
                    .float().mean())
        print('float16 LM gradient, loss scale %g: flash against plain '
              'attention %.4f in relative norm at most; %.1f %% of '
              "layer 0's wqkv gradient below 2^-14" % (scale, rel,
                                                       100 * low))


if __name__ == '__main__':
    # the numbers quoted by chip_smoke.py's FWD_TOL and F16_LOSS_SCALE
    _emulated_shares()
    _float16_underflow()
