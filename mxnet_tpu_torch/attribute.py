"""AttrScope: scoped attributes attached to symbols at construction, the
counterpart of mxnet_tpu/attribute.py (reference
python/mxnet/attribute.py)."""
import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = {k: str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attr):
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        self._old = getattr(AttrScope._current, 'value', None)
        merged = dict(self._old._attr) if self._old else {}
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old


def current():
    scope = getattr(AttrScope._current, 'value', None)
    if scope is None:
        scope = AttrScope()
        AttrScope._current.value = scope
    return scope
