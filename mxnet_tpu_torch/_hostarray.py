"""Host arrays of the parameter-server wire, the distributed runtime,
the elastic checkpoints and the weight deltas.

They are numpy arrays, except for the dtypes numpy lacks (bfloat16 and
the two float8 types), which are contiguous torch CPU tensors: the JAX
package holds those as ml_dtypes arrays, and the port needs no
ml_dtypes. Either kind goes on the wire and into files as its dtype's
name and its raw bytes, byte for byte what the JAX package writes, and
comes back as the same kind. An ml_dtypes array handed in (the JAX
package's pickles, a test) converts through its bits.
"""
import numpy as np
import torch

# dtypes numpy lacks, by the name both packages write
TORCH_ONLY = {'bfloat16': torch.bfloat16,
              'float8_e4m3fn': torch.float8_e4m3fn,
              'float8_e5m2': torch.float8_e5m2}
_BITS_NP = {1: np.uint8, 2: np.uint16}
_BITS_TORCH = {1: torch.uint8, 2: torch.int16}


def is_torch(a):
    return isinstance(a, torch.Tensor)


def dtype_name(a):
    """'float32', 'bfloat16', ... of a host array (or a dtype)."""
    dt = getattr(a, 'dtype', a)
    if isinstance(dt, torch.dtype):
        return str(dt).replace('torch.', '')
    return np.dtype(dt).name


def host(a):
    """A host array of an NDArray, a torch tensor on any device, a numpy
    array (ml_dtypes included) or a scalar: numpy where numpy has the
    dtype, else a contiguous torch CPU tensor. A numpy input, or a CPU
    tensor numpy can view, comes back without a copy."""
    data = getattr(a, '_data', None)
    if isinstance(data, torch.Tensor):
        a = data
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if dtype_name(t) in TORCH_ONLY:
            return t.cpu().contiguous()
        return t.cpu().numpy()
    a = np.asarray(a)
    if a.dtype.name in TORCH_ONLY:
        return from_bits(a.view(_BITS_NP[a.dtype.itemsize]), a.dtype.name)
    return a


def bits(a):
    """The raw elements of a torch-only host array as a numpy unsigned
    array of its width (a numpy array comes back as it is)."""
    if not is_torch(a):
        return a
    t = a.contiguous()
    return t.view(_BITS_TORCH[t.element_size()]).numpy().view(
        _BITS_NP[t.element_size()])


def from_bits(u, name):
    """The torch CPU tensor of dtype `name` whose raw elements are the
    unsigned numpy array `u` (copied when `u` is read-only)."""
    u = np.ascontiguousarray(u)
    if not u.flags.writeable:
        u = u.copy()
    width = TORCH_ONLY[name].itemsize
    signed = u.view(np.int16) if width == 2 else u.view(np.uint8)
    return torch.from_numpy(signed).view(TORCH_ONLY[name])


def raw_bytes(a):
    """A uint8 numpy view of a host array's bytes (no copy when it is
    contiguous)."""
    if is_torch(a):
        return bits(a).reshape(-1).view(np.uint8)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def from_buffer(buf, name, shape):
    """The host array of dtype `name` and `shape` over the bytes `buf` (a
    view for numpy dtypes; a torch-only dtype's tensor owns a copy when
    the buffer is read-only)."""
    if name in TORCH_ONLY:
        width = TORCH_ONLY[name].itemsize
        return from_bits(np.frombuffer(buf, dtype=_BITS_NP[width]),
                         name).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape))


def copy(a):
    return a.clone() if is_torch(a) else np.array(a, copy=True)


def contiguous(a):
    return a.contiguous() if is_torch(a) else np.ascontiguousarray(a)


def to_float32(a):
    """float32 numpy values of a host array (exact for bfloat16)."""
    if is_torch(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def from_float32(x, like):
    """float32 numpy values `x` cast to `like`'s dtype (nearest, ties to
    even, as ml_dtypes and numpy cast), in `like`'s kind."""
    if is_torch(like):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            like.dtype)
    return np.asarray(x).astype(like.dtype)


def nbytes(a):
    if is_torch(a):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def to_tensor(a, device=None, dtype=None):
    """A torch tensor of a host array (sharing a numpy array's memory
    where it can), on `device` in `dtype` when given."""
    if is_torch(a):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.name in TORCH_ONLY:
            t = host(a)
        else:
            if not a.flags.writeable:
                a = a.copy()
            t = torch.from_numpy(np.ascontiguousarray(a))
    if device is not None or dtype is not None:
        t = t.to(device=device or t.device, dtype=dtype or t.dtype)
    return t
