"""Attribute scopes for symbols (counterpart of
``mxnet_tpu/attribute.py``; reference ``python/mxnet/attribute.py ::
AttrScope``): ``with mx.AttrScope(ctx_group="dev1"):`` attaches the
attributes to every symbol made in the scope, in this thread."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class AttrScope:
    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def __enter__(self):
        _stack().append(self._attrs)
        return self

    def __exit__(self, *args):
        _stack().pop()

    @staticmethod
    def current_attrs():
        """The attributes of every scope in force, inner ones winning."""
        merged = {}
        for frame in _stack():
            merged.update(frame)
        return merged
