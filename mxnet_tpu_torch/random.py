"""Random state: the counterpart of mxnet_tpu/random.py.

The reference seeds per-device PRNG streams (src/resource.cc kRandom)
through `mx.random.seed`; the JAX package splits one root key. Here each
device has one explicit `torch.Generator`, made at its first draw from
the last seed, and `seed(s)` reseeds them all. A sampler draws from the
generator of its output's device (`ndarray.invoke` hands it over in the
op's context), so a run is reproducible from its seed and no global
torch RNG state is touched. The numbers differ from JAX's by nature.

The samplers (`uniform`, `normal`, `gamma`, `exponential`, `poisson`,
`negative_binomial`, `generalized_negative_binomial`, `multinomial`) are
set on this module by `ndarray._init_module`, as in the JAX package.
`stream_seed` derives the seeds of host-side streams (the image decode
workers' augmentation draws) from the last seed, as the JAX package's
does, so both packages draw the same numbers there.
"""
import hashlib
import threading

import torch

_lock = threading.Lock()
_generators = {}
_seed = [0]


def _key(device):
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def generator(device):
    """The torch.Generator of `device`, seeded from the last `seed()`
    (0 before any) at its first use."""
    device = _key(device)
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed[0])
            _generators[device] = gen
        return gen


def seed(seed_state):
    """Seed every device's generator (reference python/mxnet/random.py
    seed): the next draws on each device start the stream of
    `seed_state` again."""
    with _lock:
        _seed[0] = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed[0])


def stream_seed(*components):
    """A reproducible integer seed for an auxiliary host-side stream, from
    the last `seed()` and `components` (('image-aug', epoch, position)):
    the blake2b of repr((seed, components)), the JAX package's integers.
    The image decode workers seed one random.Random / RandomState per
    sample from it, so augmentation depends only on (seed, epoch, sample
    position), whatever worker runs the sample."""
    payload = repr((_seed[0] or 0, components)).encode()
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, 'little')
