"""The port's conv + BatchNorm statistics (mxnet_tpu_torch.cuda_conv)
against the JAX package's (mxnet_tpu/pallas_conv.py), on the CPU.

On the CPU the port runs its plain version through the same autograd
Function as on the card; the JAX side runs its Pallas kernel in
interpret mode, or its XLA oracle for shapes the Pallas kernel declines.
The CUDA kernel is held against the plain version on the card by
chip_smoke.py (phase 6, and --mutants against broken copies of it).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax
import jax.numpy as jnp

from mxnet_tpu import pallas_conv as pc
from mxnet_tpu_torch import cuda_conv
from mxnet_tpu_torch.tools import bench_conv_bn

REPO = Path(__file__).resolve().parents[1]

# tests/test_pallas_conv.py's cases and float32 tolerances
CASES = [
    ((4, 14, 14, 32), (3, 3, 32, 128), (1, 1), (1, 1)),
    ((4, 14, 14, 32), (1, 1, 32, 128), (1, 1), (0, 0)),
    ((4, 14, 14, 32), (1, 1, 32, 128), (2, 2), (0, 0)),
    ((8, 8, 8, 16), (3, 3, 16, 64), (1, 1), (1, 1)),
]
Y_TOL = dict(rtol=1e-5, atol=1e-5)
S1_TOL = dict(rtol=1e-4, atol=1e-3)
S2_TOL = dict(rtol=1e-4, atol=1e-2)
# shapes the Pallas kernel declines, as in chip_smoke.py's cases: ragged
# (M = 507, Cout = 96, Cin = 24) and stem-like (7x7 stride 2 on a
# non-square image, Cin = 3, Cout = 30)
DECLINED = [((3, 13, 13, 24), (3, 3, 24, 96), (1, 1), (1, 1)),
            ((2, 15, 17, 3), (7, 7, 3, 30), (2, 2), (3, 3))]


def _inputs(seed, xs, ws, scale=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(*xs).astype(np.float32),
            (rng.randn(*ws) * scale).astype(np.float32))


def _check(got, ref):
    for mine, theirs, tol in zip(got, ref, (Y_TOL, S1_TOL, S2_TOL)):
        np.testing.assert_allclose(np.asarray(mine, np.float32),
                                   np.asarray(theirs, np.float32), **tol)


@pytest.mark.parametrize('xs,ws,stride,pad', CASES)
def test_conv_bn_stats_matches_jax_pallas(xs, ws, stride, pad):
    x, w = _inputs(0, xs, ws)
    ref = pc.conv2d_bn_stats(jnp.asarray(x), jnp.asarray(w), stride, pad,
                             True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, s1, s2 = cuda_conv.conv2d_bn_stats(tx, torch.from_numpy(w), stride,
                                          pad)
    assert type(y.grad_fn).__name__ == '_ConvBnStatsBackward'
    assert y.dtype == torch.float32 and s1.dtype == s2.dtype == torch.float32
    _check([t.detach().numpy() for t in (y, s1, s2)], ref)


def test_conv_bn_stats_bfloat16_matches_jax_pallas():
    """bf16: both sum the float32 accumulators, so y agrees to one bf16
    step and the statistics to rtol 1e-4."""
    xs, ws, stride, pad = CASES[0]
    x, w = _inputs(3, xs, ws)
    y, s1, s2 = pc.conv2d_bn_stats(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16), stride, pad,
                                   True)
    ty, t1, t2 = cuda_conv.conv2d_bn_stats(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        stride, pad)
    assert ty.dtype == torch.bfloat16
    yj = np.asarray(y.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), yj, rtol=2.0 ** -7,
                               atol=0)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=1e-4,
                               atol=S1_TOL['atol'])
    np.testing.assert_allclose(t2.numpy(), np.asarray(s2), rtol=1e-4,
                               atol=S2_TOL['atol'])


def test_conv_bn_stats_gradients_match_jax():
    """tests/test_pallas_conv.py's gradient test: the loss takes all three
    outputs, so both statistics' cotangents fold into dy."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 64) * 0.1).astype(np.float32)

    def loss_jax(x, w):
        y, s1, s2 = pc.conv2d_bn_stats(x, w, (1, 1), (1, 1), True)
        return (y * 0.3).sum() + (s1 * 0.7).sum() - (s2 * 0.2).sum()

    gx, gw = jax.grad(loss_jax, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y, s1, s2 = cuda_conv.conv2d_bn_stats(tx, tw, (1, 1), (1, 1))
    ((y * 0.3).sum() + (s1 * 0.7).sum() - (s2 * 0.2).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('used', ['y', 's1', 's2'])
def test_unused_outputs_add_nothing(used):
    """An output left out of the loss sends no cotangent (None): the
    gradient is that of the outputs used, as jax.grad gives it with the
    others' cotangents zero."""
    xs, ws, stride, pad = CASES[2]
    x, w = _inputs(2, xs, ws)
    pick = {'y': 0, 's1': 1, 's2': 2}[used]

    def loss_jax(x, w):
        return pc.conv2d_bn_stats(x, w, stride, pad, True)[pick].sum()

    gx, gw = jax.grad(loss_jax, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    cuda_conv.conv2d_bn_stats(tx, tw, stride, pad)[pick].sum().backward()
    for mine, theirs in ((tx.grad, gx), (tw.grad, gw)):
        scale = float(np.abs(np.asarray(theirs)).max())
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize('xs,ws,stride,pad', DECLINED)
def test_ragged_shape_jax_declines_matches_xla_oracle(xs, ws, stride, pad):
    """Shapes outside the Pallas kernel's gates (Cout 96, batch 3; Cin 3,
    a strided 7x7): the port takes them, and agrees with the JAX
    package's XLA oracle, which in float32 is the kernel's function."""
    assert not pc.supported(xs, ws, stride, pad, jnp.float32)
    assert cuda_conv.supported(xs, ws, stride, pad, torch.float32)
    x, w = _inputs(4, xs, ws)
    ref = pc.reference_conv_bn_stats(jnp.asarray(x), jnp.asarray(w), stride,
                                     pad)
    got = cuda_conv.conv2d_bn_stats(torch.from_numpy(x), torch.from_numpy(w),
                                    stride, pad)
    _check([t.numpy() for t in got], ref)


def test_bfloat16_oracles_sum_the_rounded_y():
    """The port's reference_conv_bn_stats is the JAX oracle (statistics of
    the rounded bf16 y). The kernel's function sums before rounding, so
    against the oracle its statistics are held only to the rounding's
    own bound: |y_bf16 - y| <= 2^-9 |y|, so s1 within 2^-9 sum |y| and
    s2 within 2^-8 sum y^2, far looser than the rtol 1e-4 of the Pallas
    comparison."""
    xs, ws, stride, pad = CASES[3]
    x, w = _inputs(5, xs, ws)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ry, r1, r2 = pc.reference_conv_bn_stats(jx, jw, stride, pad)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    qy, q1, q2 = cuda_conv.reference_conv_bn_stats(tx, tw, stride, pad)
    ryf = np.asarray(ry.astype(jnp.float32))
    np.testing.assert_allclose(qy.float().numpy(), ryf, rtol=2.0 ** -7,
                               atol=0)
    np.testing.assert_allclose(q1.numpy(), np.asarray(r1), rtol=1e-4,
                               atol=S1_TOL['atol'])
    np.testing.assert_allclose(q2.numpy(), np.asarray(r2), rtol=1e-4,
                               atol=S2_TOL['atol'])
    _, k1, k2 = cuda_conv.conv2d_bn_stats(tx, tw, stride, pad)
    abs_sum = np.abs(ryf).sum((0, 1, 2))
    sq_sum = (ryf * ryf).sum((0, 1, 2))
    assert np.all(np.abs(k1.numpy() - np.asarray(r1)) <= 2.0 ** -9 * abs_sum)
    assert np.all(np.abs(k2.numpy() - np.asarray(r2)) <= 2.0 ** -8 * sq_sum)
    assert not np.array_equal(k2.numpy(), np.asarray(r2))


def test_supported_takes_every_resnet50_conv():
    """All 19 conv shapes of the ResNet-50 body at batch 256 in bf16,
    including those the Pallas kernel declines; the list is the JAX
    tool's."""
    spec = importlib.util.spec_from_file_location(
        'jax_bench_conv_bn', REPO / 'tools' / 'bench_conv_bn.py')
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert cuda_conv.RESNET50_CONVS == jax_tool.RESNET50_CONVS
    assert sum(c[-1] for c in cuda_conv.RESNET50_CONVS) == 51
    declined = 0
    for h, cin, cout, k, s, _ in cuda_conv.RESNET50_CONVS:
        xs, ws, stride, pad = bench_conv_bn.conv_geometry(256, h, cin, cout,
                                                          k, s)
        for dtype in (torch.bfloat16, 'bfloat16', torch.float32):
            assert cuda_conv.supported(xs, ws, stride, pad, dtype)
        declined += not pc.supported(xs, ws, stride, pad, jnp.bfloat16)
    assert declined >= 2     # (7, 512, 512, 3x3) and (14, 1024, 2048, s2)


@pytest.mark.parametrize('xs,ws,stride,pad,dtype', [
    ((2, 8, 8, 16), (3, 3, 8, 32), (1, 1), (1, 1), 'float32'),   # grouped
    ((8, 8, 16), (3, 3, 16, 32), (1, 1), (1, 1), 'float32'),     # 3-D x
    ((2, 8, 8, 16), (3, 3, 16), (1, 1), (1, 1), 'float32'),      # 3-D w
    ((2, 8, 8, 16), (3, 3, 16, 32), (1, 1), (1, 1), 'float64'),
    ((2, 8, 8, 16), (3, 3, 16, 32), (0, 1), (1, 1), 'float32'),
    ((2, 8, 8, 16), (3, 3, 16, 32), (1, 1), (-1, 0), 'float32'),
    ((2, 2, 2, 16), (3, 3, 16, 32), (1, 1), (0, 0), 'float32'),  # no output
    ((2 ** 16, 256, 256, 1), (1, 1, 1, 1), (1, 1), (0, 0), 'float32'),
])
def test_supported_refuses(xs, ws, stride, pad, dtype):
    assert not cuda_conv.supported(xs, ws, stride, pad, dtype)


def test_wrappers_refuse_and_never_fall_back():
    """The public function raises ValueError on what `supported` refuses,
    on either device; the CUDA wrapper raises on CPU tensors and on what
    the kernel does not take, before anything is built or launched."""
    x = torch.zeros(2, 8, 8, 16)
    w = torch.zeros(3, 3, 16, 32)
    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    with pytest.raises(ValueError, match='does not take'):
        cuda_conv.conv2d_bn_stats(x, torch.zeros(3, 3, 8, 32), (1, 1), (1, 1))
    with pytest.raises(ValueError, match='does not take'):
        cuda_conv.conv2d_bn_stats(x[0], w, (1, 1), (1, 1))
    with pytest.raises(ValueError, match='does not take'):
        cuda_conv.conv2d_bn_stats(x.double(), w.double(), (1, 1), (1, 1))
    with pytest.raises(ValueError, match='does not take'):
        cuda_conv.conv2d_bn_stats(x, w.bfloat16(), (1, 1), (1, 1))
    with pytest.raises(ValueError, match='cuda or cpu'):
        cuda_conv.conv2d_bn_stats(x.to('meta'), w.to('meta'))
    with pytest.raises(ValueError, match='one CUDA device'):
        cuda_conv.conv_bn_stats_cuda(x, w, (1, 1), (1, 1))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        cuda_conv.conv_bn_stats_cuda(x.double(), w.double(), (1, 1), (1, 1))
    with pytest.raises(ValueError, match='does not take'):
        cuda_conv.conv_bn_stats_cuda(x, torch.zeros(3, 3, 8, 32), (1, 1),
                                     (1, 1))
    with pytest.raises(ValueError, match='contiguous'):
        cuda_conv.conv_bn_stats_cuda(x.transpose(1, 2), w, (1, 1), (1, 1))
    assert cuda_conv.CONV_BN_STATS_LAUNCHES == before


def test_cpu_path_launches_no_kernel():
    x, w = _inputs(6, *CASES[3][:2])
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    y, s1, s2 = cuda_conv.conv2d_bn_stats(tx, tw, (1, 1), (1, 1))
    (y.sum() + s2.sum()).backward()
    assert tx.grad is not None and tw.grad is not None
    assert cuda_conv.CONV_BN_STATS_LAUNCHES == before


def test_plain_version_sums_before_rounding():
    """In bf16 the plain version's statistics are those of the float32
    conv, and its y is that conv rounded; in float32 it is the oracle."""
    x, w = _inputs(7, *CASES[0][:2])
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y32, s1, s2 = cuda_conv.conv_bn_stats_plain(tx, tw, (1, 1), (1, 1))
    by, b1, b2 = cuda_conv.conv_bn_stats_plain(tx.bfloat16(), tw.bfloat16(),
                                               (1, 1), (1, 1))
    exact = cuda_conv.conv_bn_stats_plain(tx.bfloat16().float(),
                                          tw.bfloat16().float(), (1, 1),
                                          (1, 1))
    assert by.dtype == torch.bfloat16 and by.is_contiguous()
    assert torch.equal(by, exact[0].bfloat16())
    assert torch.equal(b1, exact[1]) and torch.equal(b2, exact[2])
    ref = cuda_conv.reference_conv_bn_stats(tx, tw, (1, 1), (1, 1))
    for a, b in zip((y32, s1, s2), ref):
        assert torch.equal(a, b)


def test_weight_from_jax_keeps_the_layout():
    w = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    t = cuda_conv.weight_from_jax(w, device='cpu')
    assert t.shape == (2, 3, 4, 5) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), w)
    w[0, 0, 0, 0] = -1.0          # a copy, not a view
    assert float(t[0, 0, 0, 0]) == 0.0
    assert cuda_conv.weight_from_jax(w, torch.bfloat16, 'cpu').dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match='4-D'):
        cuda_conv.weight_from_jax(w[0], device='cpu')


def test_bench_bounds_of_the_resnet50_body():
    """The bench's bound: x's pixels read (a quarter for the strided 1x1
    convs), w and y once; count-weighted over the 51 convs at batch 256 in
    bf16, 1.8875 TFLOP of conv and 0.0069 of statistics, 8.58 GB, about
    3.17 ms on an H100's peaks."""
    assert bench_conv_bn._touched(56, 1, 2, 0) == 28
    assert bench_conv_bn._touched(56, 3, 1, 1) == 56
    assert bench_conv_bn._touched(13, 3, 2, 0) == 13
    assert bench_conv_bn._touched(10, 1, 3, 0) == 4
    flops = nbytes = ms = 0.0
    by = {}
    for h, cin, cout, k, s, count in cuda_conv.RESNET50_CONVS:
        geo = bench_conv_bn.conv_geometry(256, h, cin, cout, k, s)
        b = bench_conv_bn.conv_bound(*geo, 'bfloat16')
        flops += count * b['flops']
        nbytes += count * b['bytes']
        ms += count * b['bound_ms']
        by[(h, cin, cout, k, s)] = b['bound_by']
    assert abs(flops / 1.8944e12 - 1) < 1e-4
    assert abs(nbytes / 8.5762e9 - 1) < 1e-4
    assert abs(ms - 3.166) < 0.001
    assert by[(56, 64, 64, 3, 1)] == 'bytes'
    assert by[(28, 128, 128, 3, 1)] == 'operations'
    assert by[(7, 512, 512, 3, 1)] == 'operations'


def test_bench_needs_a_card_and_its_yardstick_is_the_oracle():
    with pytest.raises(RuntimeError, match='CUDA device'):
        bench_conv_bn.run(batch=1, device='cpu')
    x, w = _inputs(8, *CASES[3][:2])
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = bench_conv_bn.yardstick(
        tx.permute(0, 3, 1, 2),
        tw.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
        (1, 1), (1, 1))
    ref = cuda_conv.reference_conv_bn_stats(tx, tw, (1, 1), (1, 1))
    _check([got[0].permute(0, 2, 3, 1).numpy(), got[1].numpy(),
            got[2].numpy()], [t.numpy() for t in ref])
    errs = bench_conv_bn.compare(*ref, ref)
    assert errs['y_max_abs_err'] == 0 and errs['s2_err'] == 0


# the kernels' sources: float32 on the 3xTF32 tensor-core kernel, bfloat16
# on the bf16 one; the C entry and the finalize both share
TF32_SOURCE, SM90_SOURCE = 'conv_bn_stats_tf32.cu', 'conv_bn_stats_sm90.cu'
ENTRY_SOURCE = 'conv_bn_stats.cu'


def _source(name):
    return (REPO / 'mxnet_tpu_torch' / 'csrc' / name).read_text()


def _kernel_block_rows(source):
    return int(re.search(r'constexpr int BM = (\d+);',
                         _source(source)).group(1))


def _variant(name):
    """(kernel-like result, plain version's result, x, w) at a small bf16
    3x3 conv, where the kernel-like result is the plain version's function
    summed in float64 (another order) with one change: 'sound' none,
    'tap_skipped' the centre tap left out, 'pad_off_by_one' every input
    row read one pixel lower (hbase + 1)."""
    rs = np.random.RandomState(21)
    x = torch.from_numpy(rs.randn(4, 28, 28, 32).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, 32, 32) * 0.05).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    ref = cuda_conv.conv_bn_stats_plain(x, w, (1, 1), (1, 1))
    xd, wd = x.double(), w.double()
    if name == 'tap_skipped':
        wd = wd.clone()
        wd[1, 1] = 0
    if name == 'pad_off_by_one':
        shifted = torch.zeros_like(xd)
        shifted[:, :-1] = xd[:, 1:]
        xd = shifted
    yd = cuda_conv._conv_acc(xd, wd, (1, 1), (1, 1))
    got = (yd.to(torch.bfloat16).contiguous(), yd.sum((0, 1, 2)).float(),
           (yd * yd).sum((0, 1, 2)).float())
    return got, ref, x, w


@pytest.mark.parametrize('variant,broken', [
    ('sound', False), ('tap_skipped', True), ('pad_off_by_one', True)])
def test_chip_smoke_conv_y_gate(variant, broken):
    """chip_smoke.py's check of the kernel's bf16 y against its plain
    version passes another summing order and fails a skipped tap or a
    padding one pixel off, as the --mutants run must."""
    import chip_smoke
    got, ref, x, w = _variant(variant)
    check = chip_smoke.conv_y_mismatch(torch, cuda_conv, got[0], ref[0], x,
                                       w, (1, 1), (1, 1))
    assert check['ok'] != broken, check
    if not broken:
        assert check['share_differ'] < 1e-3, check
        pf = ref[0].float()
        scales = (pf.abs().sum((0, 1, 2)), (pf * pf).sum((0, 1, 2)))
        for got_s, ref_s, scale in zip(got[1:], ref[1:], scales):
            assert chip_smoke.stats_mismatch(torch, got_s, ref_s,
                                             scale)['ok']
    else:
        assert check['share_differ'] > 0.05, check


@pytest.mark.parametrize('source', [TF32_SOURCE, SM90_SOURCE])
@pytest.mark.parametrize('left_out', [False, True])
def test_chip_smoke_conv_stats_gate(left_out, source):
    """The statistics check at the main case's M (batch 256 at 56^2,
    6,272 tiles of each kernel's height, read from its source): the
    float64 sums pass it, and leaving one tile's partials out of s2, as
    the partial mutants do, fails it. A 3x3 conv of few channels keeps it
    quick."""
    import chip_smoke
    rows = _kernel_block_rows(source)
    rs = np.random.RandomState(22)
    x = torch.from_numpy(rs.randn(256, 56, 56, 4).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, 4, 8) * 0.2).astype(np.float32))
    py, p1, p2 = cuda_conv.conv_bn_stats_plain(x, w, (1, 1), (1, 1))
    yd = cuda_conv._conv_acc(x.double(), w.double(), (1, 1),
                             (1, 1)).reshape(-1, 8)
    m_tiles = -(-yd.shape[0] // rows)
    assert m_tiles == 6272
    if left_out:
        keep = torch.ones(yd.shape[0], dtype=torch.bool)
        keep[m_tiles // 2 * rows:(m_tiles // 2 + 1) * rows] = False
        yd = yd[keep]
    s1, s2 = yd.sum(0).float(), (yd * yd).sum(0).float()
    pf = py.float()
    c1 = chip_smoke.stats_mismatch(torch, s1, p1, pf.abs().sum((0, 1, 2)))
    c2 = chip_smoke.stats_mismatch(torch, s2, p2, (pf * pf).sum((0, 1, 2)))
    assert c1['ok'], c1
    assert c2['ok'] != left_out, c2
    if left_out:
        assert c2['rel_err'] > 2 * chip_smoke.CONV_STATS_RTOL, c2


@pytest.mark.parametrize('name', ['conv_partial_left_out',
                                  'tf32_conv_small_parts_dropped',
                                  'tf32_conv_k_step_skipped',
                                  'tf32_conv_tap_coordinate_off'])
def test_chip_smoke_conv_mutants_edit_the_source_once(name):
    """Each finalize mutant edits one text of conv_bn_stats.cu once, and
    each float32 conv mutant one text of conv_bn_stats_tf32.cu; a text that
    is gone or repeated would refuse the --mutants check. They are held
    against a float32 case, which runs the 3xTF32 kernel and the
    finalize."""
    import chip_smoke
    assert sorted(chip_smoke.CONV_MUTANTS) == ['conv_partial_left_out']
    assert sorted(chip_smoke.CONV_TF32_MUTANTS) == sorted([
        'tf32_conv_small_parts_dropped', 'tf32_conv_k_step_skipped',
        'tf32_conv_tap_coordinate_off'])
    if name in chip_smoke.CONV_MUTANTS:
        old, new = chip_smoke.CONV_MUTANTS[name]
        text = _source(ENTRY_SOURCE)
    else:
        old, new = chip_smoke.CONV_TF32_MUTANTS[name]
        text = _source(TF32_SOURCE)
    assert text.count(old) == 1 and new != old
    case = chip_smoke.CONV_CASES[chip_smoke.CONV_F32_MUTANT_CASE]
    assert case[-1] == 'float32'


@pytest.mark.parametrize('name', ['sm90_k_step_skipped',
                                  'sm90_tap_coordinate_off',
                                  'sm90_partial_left_out',
                                  'sm90_y_truncated'])
def test_chip_smoke_sm90_conv_mutants_edit_the_source_once(name):
    """Each tensor-core conv mutant edits one text of
    conv_bn_stats_sm90.cu once; a text that is gone or repeated would
    refuse the --mutants check. They are held against the bf16 main
    case, which runs that kernel."""
    import chip_smoke
    assert sorted(chip_smoke.CONV_SM90_MUTANTS) == sorted([
        'sm90_k_step_skipped', 'sm90_tap_coordinate_off',
        'sm90_partial_left_out', 'sm90_y_truncated'])
    old, new = chip_smoke.CONV_SM90_MUTANTS[name]
    assert _source(SM90_SOURCE).count(old) == 1
    assert new != old
    assert chip_smoke.CONV_CASES['main'][-1] == 'bfloat16'


def _tensor_core_conv(x, w, toward_zero):
    """The bf16 kernel's order for a stride-1 conv padded by kh // 2: over
    the taps, then 16-channel steps, each step's 16 products summed
    exactly (float64) and rounded to float32, the steps added in float32,
    as the tensor cores add; y rounded to bf16 to nearest, or toward zero
    (the y_truncated mutant). Returns (y, s1, s2), the statistics summed
    from the float32 accumulators."""
    kh, kw, cin, _ = w.shape
    n, h, wd, _ = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0, kw // 2, kw // 2,
                                              kh // 2, kh // 2))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            xs = xp[:, dy:dy + h, dx:dx + wd]
            for c in range(0, cin, 16):
                part = torch.einsum('nhwc,co->nhwo', xs[..., c:c + 16],
                                    w[dy, dx, c:c + 16].double()).float()
                acc = part if acc is None else acc + part
    if toward_zero:
        y = (acc.view(torch.int32) & -65536).view(torch.float32).bfloat16()
    else:
        y = acc.bfloat16()
    return y, acc.sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))


@pytest.mark.parametrize('toward_zero', [False, True])
def test_tensor_core_order_passes_the_conv_gate(toward_zero):
    """At the main case's pattern (3x3, 64 -> 64, padding 1, bf16) on a
    small batch: the tensor cores' summing order moves under 1 % of y by a
    bf16 step against the plain version (chip_smoke.py's CONV_Y_TOL), and
    its statistics pass CONV_STATS_RTOL; y rounded toward zero instead of
    to nearest fails the gate."""
    import chip_smoke
    rs = np.random.RandomState(23)
    x = torch.from_numpy(rs.randn(2, 14, 14, 64).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, 64, 64) * 0.05).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    py, p1, p2 = cuda_conv.conv_bn_stats_plain(x, w, (1, 1), (1, 1))
    y, s1, s2 = _tensor_core_conv(x, w, toward_zero)
    check = chip_smoke.conv_y_mismatch(torch, cuda_conv, y, py, x, w,
                                       (1, 1), (1, 1))
    if toward_zero:
        assert not check['ok'] and check['share_differ'] > 0.3, check
        return
    assert check['ok'] and check['share_differ'] < 0.01, check
    pf = py.float()
    for got_s, ref_s, scale in ((s1, p1, pf.abs().sum((0, 1, 2))),
                                (s2, p2, (pf * pf).sum((0, 1, 2)))):
        assert chip_smoke.stats_mismatch(torch, got_s, ref_s, scale)['ok']


@pytest.mark.parametrize('dtype,code', [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_conv_wrapper_passes_each_dtype_to_the_library(monkeypatch, dtype,
                                                       code):
    """The wrapper hands the library the dtype code of its dispatch
    (float32 to the 3xTF32 kernel, bfloat16 to the bf16 one), sizes
    the partials from that dtype's tile height and the weights' scratch
    from its count, counts the launch, and returns x's dtype and float32
    statistics."""
    rows = {0: 128, 1: 64}     # distinct, so the scratch shows which
    weight_floats = {0: 7, 1: 0}
    asked, calls, made = [], [], []

    class Library:
        def mxt_conv_bn_stats_block_rows(self, c):
            asked.append(c)
            return rows.get(c, 0)

        def mxt_conv_bn_stats_weight_floats(self, c, kh, kw, cin, cout):
            assert (kh, kw, cin, cout) == (3, 3, 8, 16)
            return weight_floats[c]

    monkeypatch.setattr(cuda_conv._build, 'library', Library)
    monkeypatch.setattr(cuda_conv, '_check_kernel_inputs',
                        lambda *args: None)
    monkeypatch.setattr(cuda_conv, '_launch',
                        lambda entry, what, *args, device: calls.append(
                            (entry, args)))
    partials = cuda_conv._partials
    monkeypatch.setattr(cuda_conv, '_partials',
                        lambda *args: made.append(partials(*args)) or made[-1])
    x = torch.zeros(3, 10, 10, 8, dtype=dtype)
    w = torch.zeros(3, 3, 8, 16, dtype=dtype)
    before = cuda_conv.CONV_BN_STATS_LAUNCHES
    y, s1, s2 = cuda_conv.conv_bn_stats_cuda(x, w, (1, 1), (1, 1))
    assert cuda_conv.CONV_BN_STATS_LAUNCHES == before + 1
    (entry, args), = calls
    assert entry == 'mxt_conv_bn_stats' and args[-1] == code
    assert asked == [code]
    assert tuple(made[0].shape) == (2, -(-300 // rows[code]), 16)
    assert args[5] == made[0].data_ptr()
    assert args[7:11] == (3, 10, 10, 8)
    assert y.dtype == dtype and y.shape == (3, 10, 10, 16)
    assert s1.dtype == s2.dtype == torch.float32
    with pytest.raises(TypeError, match='no torch.float16 route'):
        partials(300, 16, torch.float16, 'cpu')


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, 10 mantissa bits (the low 13 of float32's cleared)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize('case', ['ragged_f32', 'main_f32'])
@pytest.mark.parametrize('terms', [1, 3])
def test_tf32_split_conv_against_the_float32_gate(case, terms):
    """csrc/conv_bn_stats_tf32.cu takes the conv's products on the tensor
    cores in TF32. Emulated at chip_smoke.py's float32 cases (main_f32 at
    batch 2) with their weights' scale: three split products (big x big,
    big x small, small x big) pass chip_smoke.py's float32 y gate
    (CONV_F32_ORDERS * K * 2^-24 of |x| conv |w|) and its statistics gate,
    as the FMA kernel did, while one TF32 product fails the y gate."""
    import chip_smoke
    xs, ws, stride, pad, dtype_name = chip_smoke.CONV_CASES[case]
    assert dtype_name == 'float32'
    xs = (min(xs[0], 2),) + tuple(xs[1:])
    rs = np.random.RandomState(31)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) * 0.05).astype(np.float32)
    conv = lambda a, b: cuda_conv._conv_acc(torch.from_numpy(a),
                                            torch.from_numpy(b), stride, pad)
    x_big, w_big = _tf32(x), _tf32(w)
    y = conv(x_big, w_big)
    if terms == 3:
        y = y + conv(x_big, _tf32(w - w_big)) + conv(_tf32(x - x_big), w_big)
    y = y.contiguous()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    py, p1, p2 = cuda_conv.conv_bn_stats_plain(xt, wt, stride, pad)
    check = chip_smoke.conv_y_mismatch(torch, cuda_conv, y, py, xt, wt,
                                       stride, pad)
    assert check['ok'] == (terms == 3), check
    if terms == 3:
        pf = py.float()
        for got_s, ref_s, scale in ((y.sum((0, 1, 2)), p1,
                                     pf.abs().sum((0, 1, 2))),
                                    ((y * y).sum((0, 1, 2)), p2,
                                     (pf * pf).sum((0, 1, 2)))):
            assert chip_smoke.stats_mismatch(torch, got_s, ref_s,
                                             scale)['ok']
