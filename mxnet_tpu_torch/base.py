"""Foundation utilities: the counterpart of mxnet_tpu/base.py, as far as
the port's modules use it (the error type, crash-safe file writes, the
name manager of symbol construction and attribute parsing)."""
import ast
import contextlib
import os
import tempfile
import threading


class MXNetError(Exception):
    """Error raised by the framework (the reference's
    python/mxnet/base.py name)."""


# process umask, read once at import: the umask(0)/umask(restore) probe is
# not thread-safe
try:
    _UMASK = os.umask(0)
    os.umask(_UMASK)
except OSError:  # pragma: no cover
    _UMASK = 0o022


@contextlib.contextmanager
def atomic_file(fname, mode='wb'):
    """Crash-safe file write: yields a handle on a same-directory temp
    file, fsyncs and os.replace()s it over `fname` on success, and
    unlinks it on any failure, so a crash mid-write never leaves a torn
    file under the final name. Symlink destinations are resolved first."""
    fname = os.path.realpath(fname)
    d = os.path.dirname(fname)
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(fname) + '.tmp')
    try:
        # mkstemp creates 0600; give the final file a plain open()'s mode
        os.fchmod(fd, 0o666 & ~_UMASK)
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _NameManager:
    """Automatic op naming, mirroring python/mxnet/name.py.

    Thread-local current manager; `with NameManager():` scopes a fresh
    counter space.
    """
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        seq = self._counter.get(hint, 0)
        self._counter[hint] = seq + 1
        return '%s%d' % (hint, seq)

    def __enter__(self):
        self._old = getattr(_NameManager._current, 'value', None)
        _NameManager._current.value = self
        return self

    def __exit__(self, *args):
        _NameManager._current.value = self._old


NameManager = _NameManager


def current_name_manager():
    mgr = getattr(_NameManager._current, 'value', None)
    if mgr is None:
        mgr = _NameManager()
        _NameManager._current.value = mgr
    return mgr


class Prefix(_NameManager):
    """Name manager that always attaches a prefix (python/mxnet/name.py:70)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def attr_value(v):
    """Serialize an attribute value to a string (all graph attrs are
    strings in the reference's JSON)."""
    if isinstance(v, str):
        return v
    return str(v)


def parse_attr_value(s):
    """Parse an attribute string back into a Python value."""
    if not isinstance(s, str):
        return s
    ls = s.strip()
    low = ls.lower()
    if low == 'true':
        return True
    if low == 'false':
        return False
    if low in ('none', 'null'):
        return None
    try:
        return ast.literal_eval(ls)
    except (ValueError, SyntaxError):
        return s


# dtypes by name: numpy's names, and bfloat16, which numpy lacks
_DTYPE_NAMES = frozenset(['float32', 'float64', 'float16', 'bfloat16',
                          'uint8', 'int8', 'int16', 'int32', 'int64',
                          'bool'])


def torch_dtype(dtype):
    """The torch dtype of `dtype`: a torch.dtype, a name ('float32',
    'bfloat16', ...) or anything numpy takes as a dtype (np.float32,
    np.dtype('int32'))."""
    import torch
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, '__name__',
                                                        None)
    if name not in _DTYPE_NAMES:
        import numpy as np
        name = np.dtype(dtype).name
    if name not in _DTYPE_NAMES:
        raise TypeError('no torch dtype for %r' % (dtype,))
    return getattr(torch, name)


def dtype_name(dtype):
    """The name of a dtype given as `torch_dtype` takes it: 'float32',
    'bfloat16', ..."""
    return str(torch_dtype(dtype)).replace('torch.', '')


def numpy_dtype(dtype):
    """The numpy scalar type of a torch dtype (np.float32, ...), or the
    torch dtype itself where numpy has none (bfloat16)."""
    import numpy as np
    name = str(dtype).split('.')[-1]
    if name == 'bfloat16':
        return dtype
    return np.dtype(name).type


# -- name registries (reference python/mxnet/registry.py): optimizers,
# initializers and metrics are registered and created by lowercase name
_REGISTRIES = {}


def get_register_func(base_class, nickname):
    """A decorator registering subclasses of `base_class` under their
    lowercase class name (or `name`)."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            'Can only register subclass of %s' % base_class.__name__
        name = (name or klass.__name__).lower()
        registry[name] = klass
        klass.__register_name__ = name
        return klass

    register.__name__ = 'register_%s' % nickname
    return register


def get_alias_func(base_class, nickname):
    """A decorator factory registering a class under extra names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for extra in aliases:
                register(klass, extra)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """A creator taking an instance (returned as it is), a registered
    name, or a 'name,k=v,...' spec string."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            return args[0]
        if args and isinstance(args[0], str):
            name, args = args[0], args[1:]
        elif nickname in kwargs and isinstance(kwargs[nickname], str):
            name = kwargs.pop(nickname)
        else:
            raise ValueError('%s is not valid' % nickname)
        if ',' in name:
            parts = name.split(',')
            name = parts[0]
            for kv in parts[1:]:
                if kv:
                    k, v = kv.split('=')
                    kwargs[k] = parse_attr_value(v)
        name = name.lower()
        if name not in registry:
            raise ValueError('%s is not registered for %s'
                             % (name, nickname))
        return registry[name](*args, **kwargs)

    create.__name__ = 'create_%s' % nickname
    return create
