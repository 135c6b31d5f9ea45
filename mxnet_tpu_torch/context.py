"""Device contexts and device resolution (counterpart of
``mxnet_tpu/context.py``).

A :class:`Context` names a device: ``cpu()``, ``cpu_pinned()`` (host
memory the card reads by DMA), ``Context("cpu_shared")`` (host memory,
as the CPU) or ``gpu(i)`` (CUDA device ``i``).  :attr:`DeviceType`
holds the reference's type ids.
``with ctx:`` pushes it on a thread-local stack that
:func:`current_context` reads.

Port rule, a deliberate deviation from the JAX package: with no
``with ctx:`` in force, :func:`current_context` is ``gpu(0)``, and it
raises :class:`MXNetError` when CUDA is absent, where the JAX package
falls back to ``cpu(0)`` (``mxnet_tpu/context.py :: current_context``).
Every entry point of the port runs on the GPU unless its caller asks for
the CPU, and never carries on quietly on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "DeviceType", "cpu", "cpu_pinned", "current_context",
           "gpu", "gpu_memory_info", "num_gpus", "resolve_device"]


class DeviceType:
    """The reference's device type ids (``Context.device_typeid``)."""
    kCPU = 1
    kGPU = 2
    kCPUPinned = 3
    kCPUShared = 5


_DEVTYPE_NAMES = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
_DEVTYPE_IDS = {v: k for k, v in _DEVTYPE_NAMES.items()}


class Context:
    """A device context (reference: ``context.py :: Context``)."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if device_type not in _DEVTYPE_IDS:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_typeid = _DEVTYPE_IDS[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self):
        return _DEVTYPE_NAMES[self.device_typeid]

    @property
    def pinned(self):
        return self.device_typeid == 3

    def torch_device(self):
        """The ``torch.device`` this context names; raises without CUDA
        for ``gpu(i)``."""
        if self.device_typeid == 2:
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    @classmethod
    def of_tensor(cls, tensor):
        """The context a tensor lies in."""
        dev = tensor.device
        if dev.type == "cuda":
            return cls("gpu", dev.index or 0)
        if torch.cuda.is_available() and tensor.is_pinned():
            return cls("cpu_pinned", 0)
        return cls("cpu", 0)

    def __eq__(self, other):
        return isinstance(other, Context) and \
            self.device_typeid == other.device_typeid and \
            self.device_id == other.device_id

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this card
        (``torch.cuda.empty_cache``); a no-op for a host context."""
        if self.device_typeid == 2:
            with torch.cuda.device(self.torch_device()):
                torch.cuda.empty_cache()

    def memory_info(self):
        """``(bytes_in_use, bytes_limit)`` of this device: on a card the
        caching allocator's bytes in use (``torch.cuda.memory_allocated``)
        and the card's total memory; ``(0, 0)`` for a host context,
        which keeps no such statistics (as the JAX package gives for a
        backend without them)."""
        if self.device_typeid != 2:
            return (0, 0)
        dev = self.torch_device()
        return (int(torch.cuda.memory_allocated(dev)),
                int(torch.cuda.get_device_properties(dev).total_memory))


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id=0):
    """``(free, total)`` bytes of card ``device_id``
    (``torch.cuda.mem_get_info``); raises :class:`MXNetError` without
    CUDA."""
    if not torch.cuda.is_available():
        raise MXNetError("gpu_memory_info: CUDA is not available")
    return tuple(torch.cuda.mem_get_info(device_id))


def scoped_context():
    """The innermost ``with ctx:`` context of this thread, or None: what
    a worker thread re-enters so that arrays it makes land where its
    creator's would."""
    stack = getattr(Context._default_ctx, "stack", None)
    return stack[-1] if stack else None


def current_context():
    """The innermost ``with ctx:`` context of this thread, else
    ``gpu(0)``; raises :class:`MXNetError` when that default is taken
    and CUDA is absent."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError("CUDA is not available and no context is in "
                         "force; pass ctx=mx.cpu() or use 'with mx.cpu():' "
                         "to run on the CPU")
    return Context("gpu", 0)


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; ``"cpu"`` (or a CPU ``torch.device``, or
    ``cpu()``/``cpu_pinned()``) -> the CPU; any CUDA spelling or
    ``gpu(i)`` -> that CUDA device.  Raises :class:`MXNetError` when
    CUDA is asked for, or defaulted to, and absent."""
    if isinstance(device, Context):
        if device.device_typeid != 2:
            return torch.device("cpu")
        device = torch.device("cuda", device.device_id)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("unsupported device %r: the port runs on CUDA, "
                         "or on the CPU when asked" % (device,))
    if not torch.cuda.is_available():
        raise MXNetError("CUDA is not available; pass device='cpu' to "
                         "run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
