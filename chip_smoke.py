#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --backward-case lm   # build, one case of phase 4
    python3 chip_smoke.py --mutants            # phase 4 against broken kernels

Phases, each of which exits non-zero on failure:

1. build: compile every kernel from mxnet_tpu_torch/csrc with nvcc;
2. kernels: launch each kernel on the card at the LM's shapes (and a
   decode-shaped and a ragged float32 case), hold it against its plain
   PyTorch version within the stated tolerance, and time it beside its
   bound, the plain version and, where one exists, one PyTorch call
   that computes the same function;
3. lm: the transformer LM forward at GPT-2-medium width (vocab 50257,
   dim 1024, 16 heads, 24 layers, bf16, seeded random weights) answers
   four requests of 8 x 1024 tokens on the flash kernel; the launch
   count must rise by one per layer per request, the logits must be
   finite, the mean NLL near ln(vocab), and one request must agree with
   the same model on plain attention;
4. backward kernels: launch the dK/dV and dQ kernels on the card at the
   shapes of phase 2 (and a rectangular float32 case with a nonzero lse
   cotangent), hold each against its plain PyTorch version element by
   element, check that the autograd Function gives the kernels'
   gradients, and time each beside its bound, its plain version and the
   backward of scaled_dot_product_attention;
5. train: the train step at the widths of phase 3, bf16, on one batch
   of 8 x 1024 tokens. Every parameter's gradient must be finite and
   nonzero on the flash path and on plain attention and agree between
   the two; then a warm-up step, whose update must be w - lr * g, and
   four timed steps, each of which must launch the forward, dK/dV and
   dQ kernels once per layer; a torch.profiler breakdown of one step;
   last, five float32 steps at full width and 4 layers on one batch,
   whose loss must fall.

It prints one JSON line with every kernel's numbers, then the card's
name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. It imports neither JAX nor mxnet_tpu, and
needs a CUDA device and the repository beside it.

--mutants builds each of BWD_MUTANTS (a rounding left out, a tile
skipped, the causal mask widened) in a copy of the port under
build/mutants/ and fails unless phase 4's LM case fails every one.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

GPT2_MEDIUM = dict(vocab=50257, dim=1024, heads=16, layers=24, mlp_mult=4)
BATCH, SEQ, REQUESTS = 8, 1024, 4

# kernel against its plain version, max |difference| allowed:
# float32 as the JAX package's own flash test (tests/test_parallel.py);
# bfloat16 inputs leave the output rounded to bf16 (8 bits, 4e-3 of the
# value) and p rounded to bf16 before P.V, so 2e-2 absolute on outputs
# of size about 1; lse is float32 from the same upcast inputs in both.
TOL = {'float32': dict(rtol=2e-4, atol=2e-5),
       'bfloat16': dict(rtol=0.0, atol=2e-2)}
LSE_TOL = {'float32': dict(rtol=2e-4, atol=2e-5),
           'bfloat16': dict(rtol=0.0, atol=1e-3)}
# flash against plain attention through 24 bf16 layers: logits of size
# up to about 4, where a bf16 step is 1/32
LM_LOGIT_ATOL = 0.125
LM_NLL_ATOL = 5e-3
# a backward kernel against its plain version, element by element:
# |got - ref| <= rtol * |ref| + atol + atol_of_max * max|ref|, and at
# most a share `differ` of the elements may differ at all. float32 at
# the JAX package's flash-gradient tolerance (tests/test_parallel.py);
# every element may differ there, in the last bits of another summing
# order. bfloat16: the kernel and its plain version take the same
# roundings (p and ds to bf16 before their products, the gradient on
# output), so they differ only where another fp32 summing order moves a
# value across a bf16 rounding: one bf16 step of the value (2^-7 of it
# at most), plus 1e-3 of the largest gradient for elements near 0 and
# for a flipped rounding of one p or ds. Such flips are rare, under
# 0.1 % of the elements when the sums run in float64 instead, while a
# missing rounding of p or ds moves over 30 % of its gradient by a step
# (both emulated on the CPU in tests/test_torch_flash_backward.py), so
# at most 1 % may differ.
BWD_TOL = {'float32': dict(rtol=2e-4, atol=2e-5, atol_of_max=0.0,
                           differ=1.0),
           'bfloat16': dict(rtol=2.0 ** -7, atol=0.0, atol_of_max=1e-3,
                            differ=1e-2)}
# the LM's gradients on the flash kernels against plain attention, both
# bf16, as ||g_flash - g_plain|| / ||g_plain|| per parameter: plain
# attention rounds its scores and softmax to bf16 (2^-8) where the
# kernels keep fp32, and those differences add through 24 layers of
# backward (0.018 at most on an H100 at this seed, about five bf16
# steps); a gradient that is cut or wrong gives about 1
GRAD_REL_TOL = 0.05
TRAIN_STEPS = 4
LR = 0.1                 # the JAX package's make_train_step default
FP32_LAYERS, FP32_STEPS = 4, 5

# phase 4: name -> (q shape, kv length, dtype, lse cotangent, iterations),
# all causal; phase 2's shapes and a rectangular one with an lse cotangent
BWD_CASES = {
    'lm': ((BATCH, 16, SEQ, 64), SEQ, 'bfloat16', False, 10),
    'decode': ((BATCH, 16, 16, 64), SEQ, 'bfloat16', False, 20),
    'ragged_f32': ((2, 4, 1000, 128), 1000, 'float32', False, 10),
    'rect_glse_f32': ((2, 4, 300, 64), 700, 'float32', True, 10),
}
# --mutants: edits of csrc/flash_attention_bwd.cu (text, replacement),
# each of which phase 4's LM case must catch
BWD_MUTANTS = {
    'p_not_rounded': ('Ps[e] = round_to<T>(s[i][j]);', 'Ps[e] = s[i][j];'),
    'dkdv_ds_not_rounded': ('dSs[e] = round_to<T>(dp[i][j]);',
                            'dSs[e] = dp[i][j];'),
    'dq_ds_not_rounded': ('16 * j] = round_to<T>(dp[i][j]);',
                          '16 * j] = dp[i][j];'),
    'dkdv_q_tile_skipped': ('for (int qt = first; qt < nq; ++qt) {',
                            'for (int qt = first; qt < nq; ++qt) {'
                            ' if (qt == nq / 2) continue;'),
    'dq_k_tile_skipped': ('for (int kt = 0; kt <= last; ++kt) {',
                          'for (int kt = 0; kt <= last; ++kt) {'
                          ' if (kt == last / 2) continue;'),
    'mask_one_key_wide': ('col <= r + offset)', 'col <= r + offset + 1)'),
}


def fail(msg):
    print('chip_smoke: FAILED: ' + msg, file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, iters):
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event):
    """A profiler event's own device time in us (the attribute was
    self_cuda_time_total before torch 2.4)."""
    return getattr(event, 'self_device_time_total', None) or \
        getattr(event, 'self_cuda_time_total', 0)


def device_events(torch, fn, iters=1):
    """The kernels fn launches over iters calls, by name, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')]


def profiled_ms(torch, fn, iters):
    """Mean device time of fn over iters calls, summed over its kernels,
    after one warm-up: for a call whose host work may outlast its
    kernels, where CUDA events around the calls would time the host."""
    fn()
    torch.cuda.synchronize()
    return sum(device_us(e) for e in device_events(torch, fn, iters)) \
        / 1e3 / iters


def attention_bound(b, h, tq, tk, d, dtype_name, causal):
    """Least time for one attention forward: q, k, v read once, O and
    lse written once, against the two products over the live (row, key)
    pairs of this shape."""
    itemsize = 2 if dtype_name == 'bfloat16' else 4
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + b * h * tq * 4
    flops = 4.0 * b * h * live_pairs(tq, tk, causal) * d
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


def live_pairs(tq, tk, causal):
    """(row, key) pairs that causal masking leaves, per (batch, head)."""
    if not causal:
        return tq * tk
    offset = tk - tq
    return sum(min(tk, i + offset + 1) for i in range(tq))


def backward_bounds(b, h, tq, tk, d, dtype_name, causal):
    """Least time of each backward kernel and of the whole backward:
    q, k, v, dO, lse and D read once, the kernel's gradients written
    once, against its products over the live pairs (S, dP, dV, dK for
    dK/dV; S, dP, dQ for dQ; five for the function)."""
    itemsize = 2 if dtype_name == 'bfloat16' else 4
    reads = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + 2 * b * h * tq * 4
    per_product = 2.0 * b * h * live_pairs(tq, tk, causal) * d
    out = {}
    for name, writes, products in (
            ('dkdv', 2 * b * h * tk * d, 4), ('dq', b * h * tq * d, 3),
            ('whole', b * h * (tq + 2 * tk) * d, 5)):
        nbytes = reads + writes * itemsize
        flops = products * per_product
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by='bytes' if t_bytes >= t_ops
                         else 'operations', bytes=nbytes, flops=flops)
    return out


def kernel_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, iters):
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)

    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = cuda_ops.flash_attention_reference(q, k, v, causal)
    err = (out.float() - ref_out.float()).abs()
    lse_err = (lse - ref_lse).abs()
    tol, ltol = TOL[dtype_name], LSE_TOL[dtype_name]
    ok_out = bool((err <= tol['atol'] + tol['rtol'] *
                   ref_out.float().abs()).all())
    ok_lse = bool((lse_err <= ltol['atol'] + ltol['rtol'] *
                   ref_lse.abs()).all())
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())

    ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal), iters)
    plain_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_reference(
        q, k, v, causal), max(2, iters // 4))
    library_ms = None
    if tq == tk:   # SDPA's is_causal aligns top-left: same function only
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(
        b, h, tq, tk, d, dtype_name, causal)
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, max_abs_err=float(err.max()),
               tol=tol, lse_max_abs_err=float(lse_err.max()), lse_tol=ltol,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    print('kernel case ' + json.dumps(row))
    if not finite:
        fail('%s: non-finite kernel output' % name)
    if not (ok_out and ok_lse):
        fail('%s: kernel disagrees with its plain version: out %.3g '
             '(tol %s), lse %.3g (tol %s)' % (name, row['max_abs_err'], tol,
                                             row['lse_max_abs_err'], ltol))
    return row


def grad_mismatch(torch, got, ref, tol):
    """A gradient against its plain version under `tol` (a BWD_TOL
    entry): the largest error and reference, the elements over their
    tolerance and the share that differ at all; ok when finite, none is
    over and no more than tol['differ'] differ."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    size = float(ref.abs().max())
    limit = tol['rtol'] * ref.abs() + tol['atol'] + tol['atol_of_max'] * size
    over = int((err > limit).sum())
    differ = float((err > 0).float().mean())
    finite = bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(err.max()), max_abs_ref=size,
                over_tol=over, share_differ=differ, finite=finite,
                ok=finite and over == 0 and differ <= tol['differ'])


def bwd_case(torch, cuda_ops, name, shape_q, tk, dtype, causal, with_glse,
             iters):
    """Phase 4, one shape: each backward kernel against its plain
    version on the same inputs (the kernel forward's out and lse, a
    seeded dO and lse cotangent), the autograd Function against the
    kernels, and the times."""
    import torch.nn.functional as F
    b, h, tq, d = shape_q
    dtype_name = str(dtype).split('.')[-1]
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    q = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device='cuda', dtype=dtype)
    do = torch.randn(shape_q, generator=gen, device='cuda', dtype=dtype)
    glse = None
    if with_glse:
        glse = torch.randn((b * h, tq, 1), generator=gen, device='cuda')
    out, lse = cuda_ops.flash_attention_with_lse(q, k, v, causal=causal)
    dd = cuda_ops.attention_bwd_delta(out, do, glse).contiguous()
    args = (q, k, v, do, lse, dd, causal, scale)

    dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
    dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    ref_dk, ref_dv = cuda_ops.flash_attention_bwd_dkdv_reference(*args)
    ref_dq = cuda_ops.flash_attention_bwd_dq_reference(*args)
    errs = {gname: grad_mismatch(torch, got, ref, BWD_TOL[dtype_name])
            for gname, got, ref in (('dq', dq, ref_dq), ('dk', dk, ref_dk),
                                    ('dv', dv, ref_dv))}
    ok = all(e['ok'] for e in errs.values())

    # the Function's backward is these kernels on these inputs
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o2, l2 = cuda_ops.flash_attention_with_lse(*leaves, causal=causal)
    outs, cots = ((o2, l2), (do, glse)) if with_glse else ((o2,), (do,))
    fn_grads = torch.autograd.grad(outs, leaves, cots)
    same = all(torch.equal(a, b) for a, b in zip(fn_grads, (dq, dk, dv)))

    dkdv_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dkdv_cuda(
        *args), iters)
    dq_ms = cuda_ms(torch, lambda: cuda_ops.flash_attention_bwd_dq_cuda(
        *args), iters)
    plain_iters = max(2, iters // 4)
    dkdv_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dkdv_reference(*args),
        plain_iters)
    dq_plain_ms = cuda_ms(
        torch, lambda: cuda_ops.flash_attention_bwd_dq_reference(*args),
        plain_iters)
    library_ms = None
    if tq == tk and not with_glse:   # SDPA's is_causal aligns top-left
        sq, sk, sv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                  is_causal=causal)
        # device time: the autograd engine's host work per call can
        # outlast these kernels
        library_ms = profiled_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (sq, sk, sv), do, retain_graph=True), iters)
    bounds = backward_bounds(b, h, tq, tk, d, dtype_name, causal)
    row = dict(case=name, q=list(shape_q), tk=tk, dtype=dtype_name,
               causal=causal, glse=with_glse, tol=BWD_TOL[dtype_name],
               errors=errs,
               function_equals_kernels=same,
               dkdv_ms=dkdv_ms, dq_ms=dq_ms, dkdv_plain_ms=dkdv_plain_ms,
               dq_plain_ms=dq_plain_ms, sdpa_backward_ms=library_ms,
               bounds=bounds)
    print('backward case ' + json.dumps(row))
    if not ok:
        fail('%s: a backward kernel disagrees with its plain version: %s'
             % (name, errs))
    if not same:
        fail('%s: the autograd Function does not give the kernels\' '
             'gradients' % name)
    return row


def reset_counts(cuda_ops):
    cuda_ops.FLASH_FWD_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DKDV_LAUNCHES = 0
    cuda_ops.FLASH_BWD_DQ_LAUNCHES = 0


def read_counts(cuda_ops):
    return (cuda_ops.FLASH_FWD_LAUNCHES, cuda_ops.FLASH_BWD_DKDV_LAUNCHES,
            cuda_ops.FLASH_BWD_DQ_LAUNCHES)


def profile_device(torch, fn, label, top):
    """Run fn once under torch.profiler; print and return the device time
    by kernel (ms), heaviest first."""
    events = device_events(torch, fn)
    total_us = sum(device_us(e) for e in events)
    print('%s: device time %.3f ms in %d kernels' % (
        label, total_us / 1e3, len(events)))
    rows = []
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        print('  %9.3f ms  %5d x  %s' % (device_us(e) / 1e3, e.count,
                                          e.key[:110]))
        rows.append(dict(kernel=e.key[:200], ms=device_us(e) / 1e3,
                         count=e.count))
    return total_us / 1e3, rows


def train_phase(torch, cuda_ops, tfm, params, batch):
    """Phase 5: the bf16 train step at full width and depth on `params`
    (updated in place), then the float32 loss check at FP32_LAYERS."""
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    tokens, targets = batch

    # gradients on the flash kernels and on plain attention, same weights
    grads, losses, peaks = {}, {}, {}
    for use_flash in (True, False):
        model = tfm.TransformerLM(dict(cfg, use_flash=use_flash), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = model.loss(tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        peaks[use_flash] = torch.cuda.max_memory_allocated()
        losses[use_flash] = loss.item()
        grads[use_flash] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    bad, rel = [], {}
    for name, gf in grads[True].items():
        gp = grads[False][name]
        if gf is None or gp is None:
            bad.append('%s: no gradient (flash %s, plain %s)' % (
                name, gf is None, gp is None))
            continue
        gf, gp = gf.float(), gp.float()
        if not (bool(torch.isfinite(gf).all()) and
                bool(torch.isfinite(gp).all())):
            bad.append('%s: non-finite gradient' % name)
        if not (float(gf.abs().max()) > 0 and float(gp.abs().max()) > 0):
            bad.append('%s: zero gradient' % name)
        rel[name] = float((gf - gp).norm() / gp.norm())
        if not rel[name] <= GRAD_REL_TOL:
            bad.append('%s: flash vs plain gradient %.4g (tol %g)' % (
                name, rel[name], GRAD_REL_TOL))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    grad_check = dict(parameters=len(grads[True]), loss_flash=losses[True],
                      loss_plain=losses[False], rel_err_max=worst[0][1],
                      rel_err_worst=worst, rel_tol=GRAD_REL_TOL,
                      wqkv_grad_norm_flash=float(
                          grads[True]['layers.0.wqkv'].float().norm()),
                      peak_bytes_flash=peaks[True],
                      peak_bytes_plain=peaks[False])
    print('train grad check ' + json.dumps(grad_check))
    del grads
    if bad:
        fail('train gradients: ' + '; '.join(bad[:10]))
    if abs(losses[True] - losses[False]) > LM_NLL_ATOL:
        fail('train loss flash %.5f vs plain %.5f (tol %g)' % (
            losses[True], losses[False], LM_NLL_ATOL))

    # the warm-up step, whose update is checked on layer 0's wqkv
    model = tfm.TransformerLM(cfg, params)
    step = tfm.make_train_step(cfg, lr=LR)
    w = model.layers[0].wqkv
    before = w.detach().clone()
    step(model, tokens, targets)
    torch.cuda.synchronize()
    update_exact = torch.equal(w.detach(), before - LR * w.grad)
    moved = int((w.detach() != before).sum())
    del before

    # the main path: TRAIN_STEPS steps, counted and timed
    reset_counts(cuda_ops)
    times, step_losses, per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        counts = read_counts(cuda_ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(float(loss))
        per_step.append([a - b for a, b in zip(read_counts(cuda_ops),
                                                counts)])
    launches = read_counts(cuda_ops)
    peak_step = torch.cuda.max_memory_allocated()
    dev_ms, top = profile_device(
        torch, lambda: step(model, tokens, targets),
        'train profile, one step', 12)
    del model

    step_ms = sorted(times)[len(times) // 2] * 1e3
    train = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
                 batch=BATCH, seq=SEQ, lr=LR, steps=TRAIN_STEPS,
                 step_ms=[t * 1e3 for t in times], step_ms_median=step_ms,
                 tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
                 losses=step_losses, launches=launches,
                 launches_per_step=per_step, update_exact=update_exact,
                 wqkv_elements_moved=moved, peak_bytes_step=peak_step,
                 profiled_device_ms=dev_ms,
                 device_busy_share=dev_ms / step_ms, profile_top=top)
    print('train ' + json.dumps(train))
    want = [cfg['layers']] * 3
    if per_step != [want] * TRAIN_STEPS:
        fail('launches (fwd, dK/dV, dQ) per step %s, expected %s each'
             % (per_step, want))
    if not update_exact:
        fail('the update of layers.0.wqkv is not w - lr * g')
    if not all(math.isfinite(x) for x in step_losses):
        fail('non-finite train loss %s' % step_losses)

    # float32 at full width, cut depth: the loss falls on one batch
    cfg32 = tfm.lm_config(use_flash=True,
                          **dict(GPT2_MEDIUM, layers=FP32_LAYERS))
    model = tfm.TransformerLM(cfg32, tfm.params_from_jax(
        seeded_tree(cfg32, SEED + 3), dtype=torch.float32, device='cuda'))
    step = tfm.make_train_step(cfg32, lr=LR)
    counts = read_counts(cuda_ops)
    fp32_losses = [float(step(model, tokens, targets))
                   for _ in range(FP32_STEPS)]
    fp32_launches = [a - b for a, b in zip(read_counts(cuda_ops), counts)]
    del model
    fp32 = dict(config='gpt2-medium widths, %d layers, float32'
                % FP32_LAYERS, lr=LR, losses=fp32_losses,
                launches=fp32_launches)
    print('train fp32 ' + json.dumps(fp32))
    if not all(math.isfinite(x) for x in fp32_losses) or \
            not fp32_losses[-1] < fp32_losses[0]:
        fail('float32 loss did not fall over %d steps: %s'
             % (FP32_STEPS, fp32_losses))
    if fp32_launches != [FP32_LAYERS * FP32_STEPS] * 3:
        fail('float32 steps launched %s kernels, expected %d each'
             % (fp32_launches, FP32_LAYERS * FP32_STEPS))
    return dict(train, grad_check=grad_check, fp32=fp32)


def seeded_tree(cfg, seed):
    """A JAX-layout parameter tree of numpy float32 arrays: weights
    normal * 0.02, norm scales one (the JAX package's init_params)."""
    rng = np.random.default_rng(seed)
    D, V, H = cfg['dim'], cfg['vocab'], cfg['mlp_mult'] * cfg['dim']

    def normal(*shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(0.02)
        return w

    ones = lambda n: np.ones((n,), np.float32)
    return {'embed': normal(V, D), 'ln_f': ones(D),
            'layers': [{'ln1': ones(D), 'wqkv': normal(D, 3 * D),
                        'wo': normal(D, D), 'ln2': ones(D),
                        'w1': normal(D, H), 'w2': normal(H, D)}
                       for _ in range(cfg['layers'])]}


def backward_phase(torch, cuda_ops, names):
    """Phase 4: the named BWD_CASES, in order."""
    rows = []
    for name in names:
        shape_q, tk, dtype_name, with_glse, iters = BWD_CASES[name]
        rows.append(bwd_case(torch, cuda_ops, name, shape_q, tk,
                             getattr(torch, dtype_name), True, with_glse,
                             iters))
    return rows


def mutant_check(root):
    """--mutants: build each of BWD_MUTANTS in its own copy of the port
    under build/mutants/ and run phase 4's LM case there, all at once;
    each must fail it and the copy with no edit must pass. Times from
    these runs mean nothing: they share the card."""
    import shutil
    base = root / 'build' / 'mutants'
    shutil.rmtree(base, ignore_errors=True)
    runs = []
    for name, edit in [('unchanged', None)] + list(BWD_MUTANTS.items()):
        copy = base / name
        shutil.copytree(root / 'mxnet_tpu_torch', copy / 'mxnet_tpu_torch',
                        ignore=shutil.ignore_patterns('__pycache__'))
        shutil.copy2(root / 'chip_smoke.py', copy)
        if edit:
            src = copy / 'mxnet_tpu_torch' / 'csrc' / 'flash_attention_bwd.cu'
            text = src.read_text()
            if text.count(edit[0]) != 1:
                fail('mutant %s: %r is not in the source once' % (name,
                                                                    edit[0]))
            src.write_text(text.replace(edit[0], edit[1]))
        with open(copy / 'run.log', 'w') as log:
            runs.append((name, copy, subprocess.Popen(
                [sys.executable, 'chip_smoke.py', '--backward-case', 'lm'],
                cwd=copy, stdout=log, stderr=subprocess.STDOUT)))
    try:
        rcs = [proc.wait(timeout=600) for _, _, proc in runs]
    finally:
        for _, _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wrong = []
    for (name, copy, _), rc in zip(runs, rcs):
        text = (copy / 'run.log').read_text()
        rows = [json.loads(line[len('backward case '):])
                for line in text.splitlines()
                if line.startswith('backward case ')]
        errors = {g: {k: e[k] for k in ('max_abs_err', 'over_tol',
                                         'share_differ')}
                  for g, e in (rows[0]['errors'].items() if rows else ())}
        failed_check = rc == 1 and 'disagrees with its plain' in text
        print('mutant ' + json.dumps(dict(mutant=name, rc=rc,
                                          caught=failed_check,
                                          errors=errors)))
        if (name == 'unchanged') != (rc == 0) or \
                (name != 'unchanged' and not failed_check):
            wrong.append('%s (rc %d):\n%s' % (name, rc, text[-3000:]))
    if wrong:
        fail('mutant check: ' + '\n'.join(wrong))
    print('mutants: all %d caught by the LM case; the unchanged copy '
          'passes' % len(BWD_MUTANTS))


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('--backward-case', choices=sorted(BWD_CASES),
                        help='build, then run only this case of phase 4')
    parser.add_argument('--mutants', action='store_true',
                        help='check that phase 4\'s LM case fails each of '
                             'BWD_MUTANTS, a broken copy of the backward '
                             'kernels')
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a '
             'CUDA device')
    root = Path(__file__).resolve().parent
    if not (root / 'mxnet_tpu_torch' / 'csrc').is_dir():
        fail('mxnet_tpu_torch/csrc not found beside %s: run it from a '
             'checkout of the repository' % Path(__file__).name)
    if args.mutants:
        mutant_check(root)
        return
    sys.path.insert(0, str(root))
    from mxnet_tpu_torch import _build, cuda_ops
    from mxnet_tpu_torch.parallel import transformer as tfm

    # full float32 products in the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print('build: %.1f s' % build_s)
    print(_build.build_log().strip())
    if args.backward_case:
        backward_phase(torch, cuda_ops, [args.backward_case])
        return

    # 2. each kernel against its plain version, at the LM's shape first
    cases = [
        kernel_case(torch, cuda_ops, 'lm', (BATCH, 16, SEQ, 64), SEQ,
                    torch.bfloat16, True, iters=20),
        kernel_case(torch, cuda_ops, 'decode', (BATCH, 16, 16, 64), SEQ,
                    torch.bfloat16, True, iters=50),
        kernel_case(torch, cuda_ops, 'ragged_f32', (2, 4, 1000, 128), 1000,
                    torch.float32, True, iters=20),
    ]

    # 3. the LM forward, the port's serving path
    cfg = tfm.lm_config(use_flash=True, **GPT2_MEDIUM)
    t0 = time.perf_counter()
    params = tfm.params_from_jax(seeded_tree(cfg, SEED),
                                 dtype=torch.bfloat16, device='cuda')
    print('lm: parameters made in %.1f s' % (time.perf_counter() - t0))
    rng = np.random.default_rng(SEED + 1)
    requests = []
    for _ in range(REQUESTS):
        tok = rng.integers(0, cfg['vocab'], (BATCH, SEQ + 1))
        tok = torch.from_numpy(tok).cuda()
        requests.append((tok[:, :-1], tok[:, 1:]))
    lm = lm_phase(torch, cuda_ops, tfm, cfg, params, requests)

    # 4. the backward kernels against their plain versions
    bwd_cases = backward_phase(torch, cuda_ops, BWD_CASES)

    # 5. the train step, the port's training path
    train = train_phase(torch, cuda_ops, tfm, params, requests[0])

    main_case = cases[0]
    kernels = [dict(
        name='flash_attention_fwd', route='cuda',
        source='mxnet_tpu_torch/csrc/flash_attention.cu',
        replaces='mxnet_tpu/pallas_ops.py:95',
        launches=lm['flash_launches'],
        launches_by_path=dict(lm_serve=lm['flash_launches'],
                              lm_train=train['launches'][0]),
        max_abs_err=main_case['max_abs_err'],
        ms=main_case['ms'], plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=main_case['library_ms'], build_s=build_s,
        cases=cases)]
    for i, (name, key, grads, line) in enumerate((
            ('flash_attention_bwd_dkdv', 'dkdv', ('dk', 'dv'), 313),
            ('flash_attention_bwd_dq', 'dq', ('dq',), 362))):
        per_case = [dict(
            case=c['case'], max_abs_err=max(c['errors'][g]['max_abs_err']
                                            for g in grads),
            share_differ=max(c['errors'][g]['share_differ'] for g in grads),
            tol=c['tol'],
            ms=c[key + '_ms'], plain_ms=c[key + '_plain_ms'],
            library_ms=c['sdpa_backward_ms'], **c['bounds'][key])
            for c in bwd_cases]
        main_case = per_case[0]
        kernels.append(dict(
            name=name, route='cuda',
            source='mxnet_tpu_torch/csrc/flash_attention_bwd.cu',
            replaces='mxnet_tpu/pallas_ops.py:%d' % line,
            launches=train['launches'][1 + i],
            launches_by_path=dict(lm_serve=lm['launches'][1 + i],
                                  lm_train=train['launches'][1 + i]),
            max_abs_err=main_case['max_abs_err'], ms=main_case['ms'],
            plain_ms=main_case['plain_ms'], bound_ms=main_case['bound_ms'],
            bound_by=main_case['bound_by'],
            library_ms=main_case['library_ms'],
            library_call='scaled_dot_product_attention backward (dq, dk '
                         'and dv together), device time by torch.profiler',
            whole_backward_bound_ms=bwd_cases[0]['bounds']['whole'][
                'bound_ms'],
            cases=per_case))
    for kern in kernels:
        if kern['launches'] == 0:
            fail('the LM path launched no %s kernel' % kern['name'])
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def lm_phase(torch, cuda_ops, tfm, cfg, params, requests):
    """Phase 3: the LM forward answers REQUESTS requests on the flash
    kernel, and one request is held against plain attention."""
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    print('lm: %d parameters (bf16)' % sum(
        p.numel() for p in model.parameters()))
    with torch.inference_mode():
        model(requests[0][0])          # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts(cuda_ops)
        times, nlls, per_request = [], [], []
        for tokens, targets in requests:
            before = cuda_ops.FLASH_FWD_LAUNCHES
            t0 = time.perf_counter()
            logits = model(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_request.append(cuda_ops.FLASH_FWD_LAUNCHES - before)
            if tuple(logits.shape) != (BATCH, SEQ, cfg['vocab']):
                fail('logits shape %s' % (tuple(logits.shape),))
            if not bool(torch.isfinite(logits).all()):
                fail('non-finite logits')
            nlls.append(float(tfm.nll(logits, targets)))
        launches = read_counts(cuda_ops)

        # one request on plain attention, same weights
        tokens, targets = requests[0]
        flash_logits = model(tokens).float()
        dense_logits = dense(tokens).float()
        logit_err = float((flash_logits - dense_logits).abs().max())
        nll_dense = float(tfm.nll(dense_logits, targets))
        del flash_logits, dense_logits, logits

        # where the time of one request goes, by kernel
        dev_ms, _ = profile_device(torch, lambda: model(tokens),
                                   'lm profile, one request', 10)

    fwd_ms = sorted(times)[len(times) // 2] * 1e3
    lm = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
              batch=BATCH, seq=SEQ, requests=REQUESTS,
              forward_ms=[t * 1e3 for t in times], forward_ms_median=fwd_ms,
              tokens_per_s=BATCH * SEQ / (fwd_ms / 1e3), mean_nll=nlls,
              ln_vocab=math.log(cfg['vocab']), flash_launches=launches[0],
              launches=launches, launches_per_request=per_request,
              flash_vs_plain_max_abs_logit_err=logit_err,
              logit_atol=LM_LOGIT_ATOL, nll_flash=nlls[0],
              nll_plain=nll_dense, nll_atol=LM_NLL_ATOL,
              profiled_device_ms=dev_ms, device_busy_share=dev_ms / fwd_ms)
    print('lm ' + json.dumps(lm))
    if per_request != [cfg['layers']] * REQUESTS:
        fail('flash launches per request %s, expected %d each'
             % (per_request, cfg['layers']))
    if launches[1:] != (0, 0):
        fail('the forward launched backward kernels: %s' % (launches,))
    if not all(abs(n - math.log(cfg['vocab'])) < 1.0 for n in nlls):
        fail('mean NLL %s far from ln(vocab) = %.3f'
             % (nlls, math.log(cfg['vocab'])))
    if logit_err > LM_LOGIT_ATOL or abs(nlls[0] - nll_dense) > LM_NLL_ATOL:
        fail('flash and plain attention disagree: logits %.4g (tol %g), '
             'nll %.5f vs %.5f (tol %g)' % (logit_err, LM_LOGIT_ATOL,
                                            nlls[0], nll_dense,
                                            LM_NLL_ATOL))
    return lm


if __name__ == '__main__':
    main()
