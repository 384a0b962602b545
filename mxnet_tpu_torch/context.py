"""Device resolution: the counterpart of mxnet_tpu/context.py.

The port runs on the card. An entry point given no device takes
`cuda:0`; it runs on the CPU only when the caller passes `device='cpu'`,
as the tests do, and it never falls back to the CPU on its own.
"""
import torch


def resolve_device(device=None):
    """`None` means `cuda:0`, and raises RuntimeError when CUDA is not
    available; anything else is passed to `torch.device` as it is."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'mxnet_tpu_torch runs on cuda:0 unless a device is given, '
                'and torch.cuda.is_available() is False; pass '
                "device='cpu' to run on the CPU")
        return torch.device('cuda', 0)
    return torch.device(device)
