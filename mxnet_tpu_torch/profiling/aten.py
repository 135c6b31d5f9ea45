"""Per-op cost attribution over aten ops: the port's counterpart of
``mxnet_tpu/profiling/hlo.py``, which it replaces.

The JAX package reads its costs from the compiled HLO text.  The port
has no HLO: a step is the sequence of aten ops its eager run dispatches
(a captured CUDA graph replays the same sequence).  :class:`Walk` is a
``TorchDispatchMode`` that sees each op of one eager run, executes it,
and charges it to one of the JAX package's five categories:

==================  ==================================================
category            ops
==================  ==================================================
conv_dot            ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
                    ``convolution*`` (forward, data and weight
                    gradients) -- and the flash and paged attention
                    kernels
collective          c10d ops
transpose_layout    ``permute``, ``copy_``, ``cat``, ``slice``,
                    ``_to_copy`` and the other copies, pads, gathers
                    and views -- pure data movement
elementwise_fusion  arithmetic, compare, select and reduce ops (aten's
                    ``pointwise`` and ``reduction`` tags, the norm and
                    softmax passes) -- and the BatchNorm+ReLU,
                    LayerNorm, LARS and LAMB kernels
other               everything else
==================  ==================================================

Flops are ``torch.utils.flop_counter``'s (the matrix and convolution
products; elementwise ops count none), bytes are each op's tensor
operands plus its outputs; a view moves no bytes and an ``empty``
writes none.  Hand kernels launch through ``ctypes`` and never reach
the dispatcher: their launchers report them through
:func:`~mxnet_tpu_torch.kernels.registry.count_launch`, charged here at
their cost functions (:mod:`mxnet_tpu_torch.kernels.costs`).  On the
CPU the kernels' plain versions run as aten ops; the registry runs each
inside :meth:`Walk.suppressed` and charges it once, as its kernel.

The dispatch mode is propagated to the autograd engine's threads, so a
``backward()`` inside the walk is walked too.  A walk cannot run inside
a CUDA-graph capture; the port walks a key's eager warm-up, which every
captured owner runs first.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["CATEGORIES", "Walk", "category_of", "current_walk"]

CATEGORIES = ("conv_dot", "collective", "transpose_layout",
              "elementwise_fusion", "other")

_CONV_DOT = {"mm", "addmm", "bmm", "baddbmm", "matmul", "mv", "addmv",
             "dot", "linear", "_scaled_mm"}
_LAYOUT = {"permute", "copy_", "copy", "cat", "slice", "_to_copy",
           "clone", "contiguous", "transpose", "t", "expand", "view",
           "reshape", "_unsafe_view", "as_strided", "unsqueeze",
           "squeeze", "select", "split", "split_with_sizes", "unbind",
           "flip", "roll", "constant_pad_nd", "pad", "stack", "narrow",
           "index_select", "gather", "repeat", "expand_copy",
           "slice_scatter", "select_scatter", "alias", "detach",
           "_reshape_alias", "unfold", "im2col", "col2im", "lift_fresh"}
_ELEMENTWISE = {"native_batch_norm", "native_batch_norm_backward",
                "_native_batch_norm_legit",
                "_native_batch_norm_legit_no_training",
                "_native_batch_norm_legit_functional",
                "native_layer_norm", "native_layer_norm_backward",
                "_softmax", "_log_softmax", "_softmax_backward_data",
                "_log_softmax_backward_data", "nll_loss_forward",
                "nll_loss_backward", "threshold_backward", "where",
                "fill_", "zero_", "zeros_like", "ones_like", "full_like",
                "max_pool2d_with_indices",
                "max_pool2d_with_indices_backward", "avg_pool2d",
                "avg_pool2d_backward", "_adaptive_avg_pool2d",
                "_adaptive_avg_pool2d_backward", "var_mean", "std_mean",
                "native_dropout", "native_dropout_backward", "rsqrt",
                "sqrt", "addcmul", "addcdiv", "lerp", "clamp_min",
                "clamp", "_foreach_add", "_foreach_mul", "all", "any",
                "isfinite", "logical_and", "bernoulli_", "uniform_",
                "normal_", "norm", "linalg_vector_norm", "cumsum"}
# no data moves: allocations without a write
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "set_",
         "resize_", "record_stream"}


def category_of(op):
    """The category of an aten ``OpOverload`` (or of a bare op name):
    the rules of the JAX package's ``hlo.category_of`` over aten ops."""
    name = op if isinstance(op, str) else op._schema.name
    ns, _, base = name.rpartition("::")
    if ns in ("c10d", "_c10d_functional", "c10d_functional"):
        return "collective"
    if base.startswith("convolution") or base.startswith("_convolution") \
            or base.startswith("cudnn_convolution") or base in _CONV_DOT:
        return "conv_dot"
    if base in _LAYOUT:
        return "transpose_layout"
    if base in _ELEMENTWISE:
        return "elementwise_fusion"
    if not isinstance(op, str):
        tags = op.tags
        if torch.Tag.pointwise in tags or torch.Tag.reduction in tags:
            return "elementwise_fusion"
        if getattr(op, "is_view", False):
            return "transpose_layout"
    return "other"


def _tensors(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


_flop_registry = None


def _flop_fn(packet):
    global _flop_registry
    if _flop_registry is None:
        from torch.utils.flop_counter import flop_registry
        _flop_registry = flop_registry
    return _flop_registry.get(packet)


def current_walk():
    """The innermost :class:`Walk` on this thread's dispatch-mode stack
    (the autograd engine's threads inherit it), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Walk):
            return mode
    return None


class Walk(TorchDispatchMode):
    """Charge every aten op of the run inside it, and every hand-kernel
    launch reported to it, to a category::

        with Walk() as walk:
            step()
        walk.categories, walk.provenance(), walk.fingerprint()

    ``categories`` is ``{category: {"flops", "bytes",
    "instructions"}}``; :meth:`provenance` the top flop-charged ops and
    every hand kernel with its launches."""

    def __init__(self):
        super().__init__()
        self.categories = {c: {"flops": 0, "bytes": 0, "instructions": 0}
                           for c in CATEGORIES}
        self._ops = {}            # op name -> provenance entry
        self._kernels = {}        # kernel name -> provenance entry
        self._sequence = hashlib.sha256()
        self._lock = threading.Lock()
        self._suppress = 0

    # -- the registry's interface --------------------------------------
    def __enter__(self):
        from ..kernels import registry
        with registry._count_lock:
            registry._walks += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import registry
        try:
            return super().__exit__(*exc)
        finally:
            with registry._count_lock:
                registry._walks -= 1

    @contextlib.contextmanager
    def suppressed(self):
        """Ops inside are executed but not charged: a kernel's plain
        version, charged once as its kernel."""
        with self._lock:
            self._suppress += 1
        try:
            yield
        finally:
            with self._lock:
                self._suppress -= 1

    def kernel(self, spec, cost, launched):
        """Charge one hand-kernel call at ``cost = (flops, bytes)`` to
        its category; ``launched`` says the kernel ran (on the CPU its
        plain version ran instead)."""
        flops, nbytes = int(cost[0]), int(cost[1])
        with self._lock:
            cat = self.categories[spec.category]
            cat["flops"] += flops
            cat["bytes"] += nbytes
            cat["instructions"] += 1
            ent = self._kernels.setdefault(spec.name, {
                "op_name": spec.name, "category": spec.category,
                "flops": 0, "bytes": 0, "calls": 0, "launches": 0,
                "kernel": True, "source": spec.source})
            ent["flops"] += flops
            ent["bytes"] += nbytes
            ent["calls"] += 1
            ent["launches"] += int(bool(launched))
            self._sequence.update(("k:%s;" % spec.name).encode())

    # -- the dispatch hook ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suppress:
            return out
        base = func._schema.name.rpartition("::")[2]
        cat = category_of(func)
        flops = 0
        fn = _flop_fn(func._overloadpacket)
        if fn is not None:
            flops = int(fn(*args, **kwargs, out_val=out))
        outs = _tensors(out, [])
        if base in _FREE or getattr(func, "is_view", False):
            nbytes = 0
        else:
            nbytes = _nbytes(_tensors(args, []) + _tensors(kwargs, [])
                             + outs)
        sig = "%s%s;" % (func.name(), ",".join(
            "%s%s" % (tuple(t.shape), str(t.dtype)[6:]) for t in outs))
        with self._lock:
            c = self.categories[cat]
            c["flops"] += flops
            c["bytes"] += nbytes
            c["instructions"] += 1
            if flops:
                ent = self._ops.setdefault(base, {
                    "op_name": "aten." + base, "category": cat,
                    "flops": 0})
                ent["flops"] += flops
            self._sequence.update(sig.encode())
        return out

    # -- results --------------------------------------------------------
    def provenance(self, top=12):
        """The ``top`` flop-charged aten ops, then every hand kernel
        charged (with its calls and launches)."""
        with self._lock:
            ops = sorted(self._ops.values(), key=lambda e: -e["flops"])
            kernels = sorted(self._kernels.values(),
                             key=lambda e: e["op_name"])
            return [dict(e) for e in ops[:top]] + [dict(e) for e in kernels]

    def kernels(self):
        """``{kernel name: provenance entry}`` of the hand kernels
        charged."""
        with self._lock:
            return {k: dict(v) for k, v in self._kernels.items()}

    def fingerprint(self):
        """Digest of the walked op sequence (names, output shapes and
        dtypes, hand kernels): one program, one fingerprint."""
        with self._lock:
            return self._sequence.copy().hexdigest()[:16]
