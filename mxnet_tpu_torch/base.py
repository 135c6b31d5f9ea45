"""Base error type and helpers of the PyTorch/CUDA port (counterpart of
``mxnet_tpu/base.py``)."""
from __future__ import annotations

import re

__all__ = ["MXNetError", "build_param_doc", "camel_to_snake", "check_call"]


class MXNetError(RuntimeError):
    """Framework error type: bad arguments, shapes or devices, and
    failures of a kernel launch, raised as native Python exceptions."""


def check_call(ret):
    """Compatibility no-op: the port has no flat C ABI to check."""
    return ret


_CAMEL_RE1 = re.compile(r"(.)([A-Z][a-z]+)")
_CAMEL_RE2 = re.compile(r"([a-z0-9])([A-Z])")


def camel_to_snake(name: str) -> str:
    """``"BatchNorm"`` -> ``"batch_norm"``."""
    s = _CAMEL_RE1.sub(r"\1_\2", name)
    return _CAMEL_RE2.sub(r"\1_\2", s).lower()


def build_param_doc(params) -> str:
    """An op's typed parameters (:class:`~.ops.registry.OpParam`) as a
    numpydoc ``Parameters`` section."""
    lines = ["Parameters", "----------"]
    for p in params:
        lines.append("%s : %s, optional, default=%r"
                     % (p.name, p.type_str, p.default) if p.has_default
                     else "%s : %s, required" % (p.name, p.type_str))
        if p.doc:
            lines.append("    " + p.doc)
    return "\n".join(lines)
