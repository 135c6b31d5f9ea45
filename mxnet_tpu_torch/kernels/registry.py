"""Registry of the port's kernels (counterpart of
``mxnet_tpu/kernels/registry.py``).

Each entry names a kernel, its plain PyTorch version, its launcher and
a launch counter.  The rule that picks between them is fixed and has
no switch:

- a CUDA tensor goes to the launcher, which launches the hand-written
  kernel or raises;
- a CPU tensor goes to the plain version.

There is no fallback from one to the other.  The counter grows by one
each time a launcher has launched its kernel (the launcher calls
:func:`count_launch`), so a run can prove that its path went through
the kernel; a launcher that passes the dtype it ran on also counts the
launch under that dtype (:func:`launch_dtypes`), and under
``"<dtype> <variant>"`` where it names a variant of its kernel (the
flash kernels' ``"masked"``), so a path's masked launches count apart
from its unmasked ones.

Each entry also carries the kernel's cost function (:mod:`.costs`: the
operations and bytes of one launch, from its arguments) and its cost
category.  A launcher hands its arguments to :func:`count_launch`;
while a :mod:`~mxnet_tpu_torch.profiling` walk runs on the launching
thread, the launch is charged there at its cost, since a kernel
launched through ``ctypes`` is invisible to the walk.  On the CPU,
:func:`dispatch` runs the plain version inside the walk's suppression
and charges it once, as the kernel, so a step's report counts each hand
kernel once on either device.  A kernel registered without a cost
function is an error.

A launch made while a CUDA graph is being captured does not run: it is
recorded.  Inside :func:`counting_into` such launches go to the graph's
tally instead of the counters, and :func:`add_launches` adds the tally
at every replay of the graph, so the counters keep counting the
kernels that ran.
"""
from __future__ import annotations

import contextlib
import inspect
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["KernelSpec", "register_kernel", "get", "list_kernels",
           "describe", "remedy_for", "dispatch", "count_launch",
           "counting_into", "add_launches", "register_counter",
           "count_captured",
           "launch_dtypes", "launches", "reset_launches"]


# the cost categories of the profiling reports (the JAX package's HLO
# categories); a hand kernel takes the one its work belongs to
_CATEGORIES = ("conv_dot", "collective", "transpose_layout",
               "elementwise_fusion", "other")


@dataclass
class KernelSpec:
    """One port kernel: plain version, launcher, provenance, and the
    cost of one launch (``cost(*args, **kwargs) -> (flops, bytes)`` over
    the launcher's arguments) in its report category."""
    name: str
    plain: Callable
    launch: Callable
    source: str       # the kernel source, relative to the package
    replaces: str     # the TPU kernel it ports, "file:line function"
    cost: Callable
    category: str
    launches: int = 0
    dtypes: Counter = field(default_factory=Counter)
    # the JAX KernelSpec's descriptive fields: a description (by
    # default the first paragraph of the launcher's docstring), the
    # report categories whose traffic the kernel removes, the perf-audit
    # advisory kinds it remedies (:func:`remedy_for`) and extras
    doc: str = ""
    categories: Tuple[str, ...] = ()
    remedies: Tuple[str, ...] = ()
    extra: Dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.doc:
            self.doc = " ".join((inspect.getdoc(self.launch) or "")
                                .split("\n\n")[0].split())
        if not callable(self.cost):
            raise MXNetError("kernel %r registered without a cost "
                             "function" % self.name)
        if self.category not in _CATEGORIES:
            raise MXNetError("kernel %r: unknown cost category %r"
                             % (self.name, self.category))

    def __repr__(self):
        return "KernelSpec(%s, launches=%d)" % (self.name, self.launches)


KERNELS: Dict[str, KernelSpec] = {}
_count_lock = threading.Lock()
_tally = None      # the Counter of the graph being captured, if any
# profiling walks running (profiling.aten.Walk); 0 keeps launches and
# plain calls to one integer check
_walks = 0


def _walk_of_thread():
    """The profiling walk on this thread's dispatch-mode stack, or
    None."""
    if not _walks:
        return None
    from ..profiling import aten
    return aten.current_walk()


def register_kernel(spec: KernelSpec) -> KernelSpec:
    if spec.name in KERNELS and KERNELS[spec.name] is not spec:
        raise MXNetError("duplicate kernel registration %r" % spec.name)
    KERNELS[spec.name] = spec
    return spec


def _ensure_registered():
    from . import (flash_attention, fused_bn_relu, layernorm,  # noqa: F401
                   optimizer_update, paged_attention)


def get(name: str) -> KernelSpec:
    _ensure_registered()
    try:
        return KERNELS[name]
    except KeyError:
        raise MXNetError("unknown kernel %r; registered: %s"
                         % (name, ", ".join(sorted(KERNELS)))) from None


def list_kernels() -> List[str]:
    _ensure_registered()
    return sorted(KERNELS)


def _qualname(fn):
    return "%s.%s" % (fn.__module__, getattr(fn, "__qualname__", fn))


def describe() -> Dict[str, Dict]:
    """``{name: {doc, source, replaces, plain, cost, category,
    categories, remedies}}`` of every registered kernel: its kernel
    source, its plain version and cost function (by qualified name) and
    its report categories.  There is no mode and no choice to report:
    the tensor's device picks the kernel (:func:`dispatch`)."""
    _ensure_registered()
    return {name: {"doc": spec.doc, "source": spec.source,
                   "replaces": spec.replaces,
                   "plain": _qualname(spec.plain),
                   "cost": _qualname(spec.cost),
                   "category": spec.category,
                   "categories": list(spec.categories),
                   "remedies": list(spec.remedies)}
            for name, spec in sorted(KERNELS.items())}


def remedy_for(kind: str) -> Optional[str]:
    """The registered kernel remedying a perf-audit advisory ``kind``
    (``"unfused-elementwise"`` -> ``"kernels.bn_relu_apply"``), the
    first by name of those whose ``remedies`` name it; None when no
    kernel covers it."""
    _ensure_registered()
    for name in sorted(KERNELS):
        if kind in KERNELS[name].remedies:
            return "kernels." + name
    return None


def dispatch(name: str, x, *args, **kwargs):
    """Run kernel ``name`` on ``x`` (and the rest of its arguments):
    its launcher when ``x`` lies on a CUDA device, its plain version
    when ``x`` lies on the CPU.  On ``meta`` tensors, which hold no
    data (a symbol graph's shape inference), the plain version gives
    the output shapes."""
    spec = get(name)
    kind = x.device.type
    if kind == "cuda":
        return spec.launch(x, *args, **kwargs)
    if kind == "meta":
        return spec.plain(x, *args, **kwargs)
    if kind == "cpu":
        walk = _walk_of_thread()
        if walk is None:
            return spec.plain(x, *args, **kwargs)
        # the walk counts the plain version once, as its kernel
        with walk.suppressed():
            out = spec.plain(x, *args, **kwargs)
        walk.kernel(spec, spec.cost(x, *args, **kwargs), launched=False,
                    dtype=x.dtype)
        return out
    raise MXNetError("kernel %r: no implementation for device %s"
                     % (name, x.device))


def _dtype_name(dtype, variant=None):
    if dtype is None:
        return None
    name = str(dtype).replace("torch.", "")
    return name if variant is None else "%s %s" % (name, variant)


def count_launch(name: str, dtype=None, variant=None,
                 cost_args=None) -> None:
    """Called by a launcher right after its kernel launched, with the
    dtype it ran on where that varies (and the variant of the kernel it
    launched, where it has several) and ``cost_args``, the ``(args,
    kwargs)`` it was called with, which the kernel's cost function
    reads while a profiling walk runs.  A launch recorded into a CUDA
    graph under :func:`counting_into` goes to that graph's tally (the
    check of the capturing stream covers the autograd engine's thread,
    which runs a captured backward on the capture stream)."""
    spec = get(name)
    if cost_args is None:
        raise MXNetError("kernel %r counted a launch without its cost "
                         "arguments" % name)
    walk = _walk_of_thread()
    if walk is not None:
        args, kwargs = cost_args
        walk.kernel(spec, spec.cost(*args, **kwargs), launched=True,
                    dtype=getattr(args[0], "dtype", None) if args else None)
    with _count_lock:
        if _tally is not None:
            import torch
            if torch.cuda.is_current_stream_capturing():
                _tally[(name, _dtype_name(dtype, variant))] += 1
                return
        spec.launches += 1
        if dtype is not None:
            spec.dtypes[_dtype_name(dtype, variant)] += 1


@contextlib.contextmanager
def counting_into(tally: Counter):
    """Within the scope, launches recorded by a capturing stream count
    into ``tally`` (``{(name, dtype name or None): launches}``) and not
    into the counters.  One capture at a time."""
    global _tally
    with _count_lock:
        if _tally is not None:
            raise MXNetError("counting_into: a capture is already "
                             "counting")
        _tally = tally
    try:
        yield tally
    finally:
        with _count_lock:
            _tally = None


# counters of launches that are not hand kernels (the mesh's
# collectives): name -> add(detail, n), called at each replay
_counters = {}


def register_counter(name, add) -> None:
    """Route a captured graph's tally entries ``(name, detail)`` to
    ``add(detail, n)`` at each replay (``n`` the entry's count)."""
    _counters[name] = add  # mxlint: disable=unbounded-shape-cache


def count_captured(name, detail) -> bool:
    """Record one launch of ``name`` (a :func:`register_counter` name)
    into the tally of the graph being captured on this stream; whether
    it was (False outside a capture: the caller counts it itself)."""
    with _count_lock:
        if _tally is None:
            return False
        import torch
        if not torch.cuda.is_current_stream_capturing():
            return False
        _tally[(name, detail)] += 1
        return True


def add_launches(tally) -> None:
    """Add a captured graph's tally to the counters: called at each
    replay, which launches every kernel the graph recorded."""
    with _count_lock:
        for (name, dtype), n in tally.items():
            spec = KERNELS.get(name)
            if spec is None:
                add = _counters[name]
                add(dtype, n)
                continue
            spec.launches += n
            if dtype is not None:
                spec.dtypes[dtype] += n


def launches(name: str) -> int:
    return get(name).launches


def launch_dtypes(name: str) -> Dict[str, int]:
    """``{dtype name: launches}`` of the launches counted with a dtype
    (``"bfloat16 masked"`` for a masked flash launch on bf16)."""
    return dict(get(name).dtypes)


def reset_launches() -> None:
    _ensure_registered()
    with _count_lock:
        for spec in KERNELS.values():
            spec.launches = 0
            spec.dtypes.clear()
