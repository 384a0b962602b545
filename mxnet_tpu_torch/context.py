"""Device contexts and device resolution: the counterpart of
mxnet_tpu/context.py.

The port runs on the card. An entry point given no device takes
`cuda:0`; it runs on the CPU only when the caller asks for it
(`device='cpu'`, `mx.cpu()`, `with mx.cpu():`), as the tests do, and it
never falls back to the CPU on its own. So the default context is
`gpu(0)`, where the JAX package's is `cpu(0)`, and an array made with no
context raises when CUDA is absent. `tpu(i)` is kept as an alias of
`gpu(i)`, so scripts written for the JAX package run, as that package
keeps `gpu` as an alias of its accelerator.
"""
import threading

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


class Context:
    """A device context: `Context('cpu'|'gpu', i)`, and `with ctx:` makes
    it the default of the calling thread. 'tpu' is taken as 'gpu' and
    'cpu_pinned' as 'cpu'."""
    _default_ctx = threading.local()
    devtype2str = {1: 'cpu', 2: 'gpu'}
    devstr2type = {'cpu': 1, 'gpu': 2, 'tpu': 2, 'cpu_pinned': 1}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The torch.device of this context: cpu, or cuda:<device_id>."""
        if self.device_typeid == 1:
            return torch.device('cpu')
        return torch.device('cuda', self.device_id)

    def _key(self):
        return (self.device_typeid, self.device_id)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Context) and self._key() == other._key()

    def __str__(self):
        return '%s(%d)' % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, 'value', None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *args):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def from_device(cls, device):
        """The context of a torch.device."""
        device = torch.device(device)
        if device.type == 'cpu':
            return cls('cpu', 0)
        if device.type == 'cuda':
            return cls('gpu', device.index or 0)
        raise ValueError('no context for device %s' % device)


def cpu(device_id=0):
    return Context('cpu', device_id)


def gpu(device_id=0):
    return Context('gpu', device_id)


def tpu(device_id=0):
    """Alias of `gpu(device_id)`, for scripts written for the JAX
    package."""
    return Context('gpu', device_id)


def num_gpus():
    """Number of CUDA devices visible."""
    return torch.cuda.device_count()


def current_context():
    """The calling thread's default context: the innermost `with ctx:`,
    else `gpu(0)`, which raises when CUDA is not available
    (`resolve_device`'s rule)."""
    ctx = getattr(Context._default_ctx, 'value', None)
    if ctx is not None:
        return ctx
    resolve_device(None)
    return Context('gpu', 0)
