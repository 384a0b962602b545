#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

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
   the same model on plain attention.

It prints one JSON line with every kernel's numbers, then the card's
name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. It imports neither JAX nor mxnet_tpu, and
needs a CUDA device and the repository beside it.
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


def attention_bound(b, h, tq, tk, d, dtype_name, causal):
    """Least time for one attention forward: q, k, v read once, O and
    lse written once, against the two products over the live (row, key)
    pairs of this shape."""
    itemsize = 2 if dtype_name == 'bfloat16' else 4
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * itemsize \
        + b * h * tq * 4
    if causal:
        offset = tk - tq
        pairs = sum(min(tk, i + offset + 1) for i in range(tq))
    else:
        pairs = tq * tk
    flops = 4.0 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


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


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a '
             'CUDA device')
    root = Path(__file__).resolve().parent
    if not (root / 'mxnet_tpu_torch' / 'csrc').is_dir():
        fail('mxnet_tpu_torch/csrc not found beside %s: run it from a '
             'checkout of the repository' % Path(__file__).name)
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
    model = tfm.TransformerLM(cfg, params).eval()
    dense = tfm.TransformerLM(dict(cfg, use_flash=False), params).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print('lm: %d parameters (bf16), made in %.1f s' % (
        n_params, time.perf_counter() - t0))
    rng = np.random.default_rng(SEED + 1)
    requests = []
    for _ in range(REQUESTS):
        tok = rng.integers(0, cfg['vocab'], (BATCH, SEQ + 1))
        tok = torch.from_numpy(tok).cuda()
        requests.append((tok[:, :-1], tok[:, 1:]))

    with torch.inference_mode():
        model(requests[0][0])          # warm-up, not counted
        torch.cuda.synchronize()
        cuda_ops.FLASH_FWD_LAUNCHES = 0
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
        launches = cuda_ops.FLASH_FWD_LAUNCHES

        # one request on plain attention, same weights
        tokens, targets = requests[0]
        flash_logits = model(tokens).float()
        dense_logits = dense(tokens).float()
        logit_err = float((flash_logits - dense_logits).abs().max())
        nll_dense = float(tfm.nll(dense_logits, targets))
        del flash_logits, dense_logits, logits

        # where the time of one request goes, by kernel
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(tokens)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, 'device_type', '')).endswith('CUDA')]
    dev_total_us = sum(device_us(e) for e in events)
    print('lm profile, one request: device time %.3f ms in %d kernels' % (
        dev_total_us / 1e3, len(events)))
    for e in sorted(events, key=lambda e: -device_us(e))[:10]:
        print('  %9.3f ms  %5d x  %s' % (device_us(e) / 1e3, e.count,
                                          e.key[:90]))

    fwd_ms = sorted(times)[len(times) // 2] * 1e3
    lm = dict(config='gpt2-medium widths, %d layers, bf16' % cfg['layers'],
              batch=BATCH, seq=SEQ, requests=REQUESTS,
              forward_ms=[t * 1e3 for t in times], forward_ms_median=fwd_ms,
              tokens_per_s=BATCH * SEQ / (fwd_ms / 1e3), mean_nll=nlls,
              ln_vocab=math.log(cfg['vocab']), flash_launches=launches,
              launches_per_request=per_request,
              flash_vs_plain_max_abs_logit_err=logit_err,
              logit_atol=LM_LOGIT_ATOL, nll_flash=nlls[0],
              nll_plain=nll_dense, nll_atol=LM_NLL_ATOL,
              profiled_device_ms=dev_total_us / 1e3,
              device_busy_share=dev_total_us / 1e3 / fwd_ms)
    print('lm ' + json.dumps(lm))
    if per_request != [cfg['layers']] * REQUESTS:
        fail('flash launches per request %s, expected %d each'
             % (per_request, cfg['layers']))
    if not all(abs(n - math.log(cfg['vocab'])) < 1.0 for n in nlls):
        fail('mean NLL %s far from ln(vocab) = %.3f'
             % (nlls, math.log(cfg['vocab'])))
    if logit_err > LM_LOGIT_ATOL or abs(nlls[0] - nll_dense) > LM_NLL_ATOL:
        fail('flash and plain attention disagree: logits %.4g (tol %g), '
             'nll %.5f vs %.5f (tol %g)' % (logit_err, LM_LOGIT_ATOL,
                                            nlls[0], nll_dense,
                                            LM_NLL_ATOL))

    main_case = cases[0]
    kernels = [dict(
        name='flash_attention_fwd', route='cuda',
        source='mxnet_tpu_torch/csrc/flash_attention.cu',
        replaces='mxnet_tpu/pallas_ops.py:95',
        launches=launches, max_abs_err=main_case['max_abs_err'],
        ms=main_case['ms'], plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=main_case['library_ms'], build_s=build_s,
        cases=cases)]
    if launches == 0:
        fail('the LM path launched no flash kernel')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
