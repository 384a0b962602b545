"""Digests of the float32 flash backward kernels' outputs, to hold two
builds of the kernels to the same bits on one card.

    python3 mxnet_tpu_torch/tools/kernel_digest.py [--root DIR]

imports `mxnet_tpu_torch` from DIR (a checkout; default: the one this
file is in), builds its kernels, makes seeded float32 inputs at the LM's
shape (8, 16, 1024, 64) causal on the card, takes out and lse from the
plain version (so no other kernel of the build feeds the backward), runs
the dK/dV and dQ kernels, and prints one JSON line: a SHA-256 of each
gradient's bytes. Two builds whose lines agree gave the same bits.
"""
import argparse
import hashlib
import json
import math
import sys
from pathlib import Path

SHAPE, SEED = (8, 16, 1024, 64), 5


def digests(torch, cuda_ops, shape=SHAPE, seed=SEED):
    """{'dq', 'dk', 'dv': hex digest} of the backward kernels at `shape`
    (q, k and v alike), causal, on seeded inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device='cuda')
                   for _ in range(4))
    scale = 1.0 / math.sqrt(shape[-1])
    out, lse = cuda_ops.flash_attention_reference(q, k, v, True, scale)
    dd = cuda_ops.attention_bwd_delta(out, do).contiguous()
    args = (q, k, v, do, lse.contiguous(), dd, True, scale)
    dk, dv = cuda_ops.flash_attention_bwd_dkdv_cuda(*args)
    dq = cuda_ops.flash_attention_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for name, t in (('dq', dq), ('dk', dk), ('dv', dv))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--root', default=str(Path(__file__).resolve()
                                              .parents[2]))
    args = parser.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit('kernel_digest: needs a CUDA device')
    from mxnet_tpu_torch import cuda_ops
    print(json.dumps(dict(root=root, shape=list(SHAPE),
                          **digests(torch, cuda_ops))))


if __name__ == '__main__':
    main()
