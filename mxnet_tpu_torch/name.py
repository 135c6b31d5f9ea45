"""Automatic names of symbols (counterpart of ``mxnet_tpu/name.py``;
reference ``python/mxnet/name.py``): ``with mx.name.NameManager():``
starts the counters afresh, ``with mx.name.Prefix("p_"):`` prepends a
prefix to every automatic name."""
from __future__ import annotations

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Names an op node from its hint and a per-hint counter
    (``fullyconnected0``, ``fullyconnected1``); an explicit name wins.
    The manager in force is process-wide, as the reference's."""

    _current = None

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name is not None:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    @classmethod
    def current(cls):
        if NameManager._current is None:
            NameManager._current = NameManager()
        return NameManager._current

    def __enter__(self):
        self._old = NameManager._current
        NameManager._current = self
        return self

    def __exit__(self, *args):
        NameManager._current = self._old


class Prefix(NameManager):
    """Prepend ``prefix`` to every automatic name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
