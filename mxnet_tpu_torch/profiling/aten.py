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

Flops are ``torch.utils.flop_counter``'s for the matrix products
(elementwise ops count none).  A convolution and its two gradients are
charged as XLA charges them: only the kernel taps whose input index
falls inside the unpadded input do work (:func:`conv_flops`; the flop
counter would charge every tap, those in the padding too).  Bytes
are each op's tensor operands plus its outputs; a view moves no bytes
and an ``empty`` writes none.  Hand kernels launch through ``ctypes`` and never reach
the dispatcher: their launchers report them through
:func:`~mxnet_tpu_torch.kernels.registry.count_launch`, charged here at
their cost functions (:mod:`mxnet_tpu_torch.kernels.costs`).  On the
CPU the kernels' plain versions run as aten ops; the registry runs each
inside :meth:`Walk.suppressed` and charges it once, as its kernel.

Beside the categories the walk keeps the counters the analysis audits
read (:meth:`Walk.audit_counters`): the bytes of each layout op, of
the aten elementwise ops (each its own launch, fused with nothing), the
matrix products' operand bytes as laid out and padded to the tensor
cores' 16-byte alignment, the dtype casts, the products and reductions
that accumulate in half precision, and the argument storages the run
writes in place.

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

__all__ = ["CATEGORIES", "Walk", "category_of", "conv_flops",
           "current_walk", "in_bounds_taps"]

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
# reductions, beside aten's reduction tag: the norm and softmax passes
# and the pooling windows (the JAX audit's reduce and reduce-window)
_REDUCE = {"sum", "mean", "var", "std", "var_mean", "std_mean", "norm",
           "linalg_vector_norm", "prod", "logsumexp", "cumsum", "_softmax",
           "_log_softmax", "native_batch_norm", "_native_batch_norm_legit",
           "_native_batch_norm_legit_functional", "native_layer_norm",
           "avg_pool2d", "max_pool2d_with_indices",
           "_adaptive_avg_pool2d"}
_HALF = (torch.float16, torch.bfloat16)
# the tensor cores' operand alignment: 16 bytes in the minor dimension
ALIGN_BYTES = 16
# no data moves: allocations without a write
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "set_",
         "resize_", "record_stream"}


# c10d op names (underscores stripped) -> the JAX package's HLO kinds
_COLLECTIVE_KINDS = (("allreduce", "all-reduce"),
                     ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"),
                     ("broadcast", "broadcast"))


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


def _aligned_bytes(t):
    """Bytes of ``t`` with its minor dimension padded to
    :data:`ALIGN_BYTES` (a rank < 2 tensor is not charged padding)."""
    if t.dim() < 2:
        return t.numel() * t.element_size()
    per = max(1, ALIGN_BYTES // t.element_size())
    minor = -(-max(int(t.shape[-1]), 1) // per) * per
    return (t.numel() // max(int(t.shape[-1]), 1)) * minor \
        * t.element_size()


def _nchw_activation(tensors):
    """Whether a convolution's activation (or its gradient) is laid out
    channels-first: a 4-D tensor of more than one channel and pixel that
    is not channels-last in memory.  cuDNN's tensor-core convolutions
    take channels-last operands, so such a convolution pays layout
    conversions around it."""
    for t in tensors:
        if t.dim() == 4 and t.shape[1] > 1 and t.shape[2] * t.shape[3] > 1 \
                and not t.is_contiguous(
                    memory_format=torch.channels_last):
            return True
    return False


def _half_accumulating_product(base, ins):
    """Whether an aten matrix product on half inputs may accumulate in
    half: cuBLAS accumulates bf16/fp16 GEMMs in fp32 unless PyTorch's
    reduced-precision reduction flag for that dtype is on (it lets a
    split-K GEMM sum its partial products in the input type); cuDNN's
    convolutions accumulate in fp32."""
    if base.startswith(("convolution", "_convolution", "cudnn_conv")):
        return False
    dts = {t.dtype for t in ins if t.is_floating_point()}
    m = torch.backends.cuda.matmul
    if torch.bfloat16 in dts:
        return bool(m.allow_bf16_reduced_precision_reduction)
    if torch.float16 in dts:
        return bool(m.allow_fp16_reduced_precision_reduction)
    return False


_flop_registry = None


def in_bounds_taps(size, kernel, stride, padding, dilation, out):
    """Pairs ``(output position, kernel tap)`` along one spatial axis
    whose input index ``o * stride - padding + k * dilation`` lies in
    ``[0, size)``: for each tap, the output positions between the first
    and the last that land inside, counted in closed form."""
    total = 0
    for k in range(kernel):
        off = k * dilation - padding
        lo = max(0, -(off // stride))
        hi = min(out - 1, (size - 1 - off) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation):
    """Flops of one (non-transposed) convolution charging only in-bounds
    taps: 2 x batch x output channels x input channels a group x the
    product over spatial axes of :func:`in_bounds_taps`.  Either
    gradient of the convolution does the same products."""
    spatial = len(w_shape) - 2
    stride, padding, dilation = (
        list(v) * spatial if len(v) == 1 else list(v)
        for v in (stride, padding, dilation))
    taps = 1
    for i in range(spatial):
        taps *= in_bounds_taps(x_shape[2 + i], w_shape[2 + i], stride[i],
                               padding[i], dilation[i], out_shape[2 + i])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_op_flops(base, args, out):
    """In-bounds flops of ``convolution``/``_convolution`` (forward) and
    ``convolution_backward`` (each gradient its ``output_mask`` asks
    for), or None for a transposed convolution (left to the flop
    counter)."""
    if base == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed = args[4:8]
        mask = args[10]
        if transposed:
            return None
        one = conv_flops(x.shape, w.shape, grad_out.shape, stride,
                         padding, dilation)
        return one * (int(bool(mask[0])) + int(bool(mask[1])))
    x, w = args[0], args[1]
    stride, padding, dilation, transposed = args[3:7]
    if transposed:
        return None
    return conv_flops(x.shape, w.shape, out.shape, stride, padding,
                      dilation)


_CONV_OPS = ("convolution", "_convolution", "convolution_backward")


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
        self._audit = {
            "transpose_ops": {}, "unfused_elementwise_bytes": 0,
            "unfused_elementwise_count": 0, "mxu_actual_bytes": 0,
            "mxu_padded_bytes": 0, "half_product_flops": 0,
            "product_flops": 0, "convert_bytes": 0, "convert_ops": {},
            "mxu_bytes": 0, "half_dot_bytes": 0, "half_dots": {},
            "reduce_bytes": 0, "half_reduce_bytes": 0,
            "half_reduces": {}, "kernel_bytes": {}, "conv_bytes": 0,
            "nchw_conv_bytes": 0}
        self._written = {}        # storage pointer -> bytes written in place
        self._collectives = {}    # kind -> {"count", "bytes"}

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

    def kernel(self, spec, cost, launched, dtype=None):
        """Charge one hand-kernel call at ``cost = (flops, bytes)`` to
        its category; ``launched`` says the kernel ran (on the CPU its
        plain version ran instead); ``dtype`` is the dtype it ran on,
        which with the accumulation type recorded beside its cost
        function (:data:`~..kernels.costs.KERNEL_NUMERICS`) places it
        in the precision counters."""
        from ..kernels.costs import KERNEL_NUMERICS
        flops, nbytes = int(cost[0]), int(cost[1])
        num = KERNEL_NUMERICS.get(spec.name, {})
        half_in = dtype in _HALF
        half_acc = half_in and num.get("accumulates") in ("float16",
                                                           "bfloat16")
        with self._lock:
            a = self._audit
            a["kernel_bytes"][spec.name] = \
                a["kernel_bytes"].get(spec.name, 0) + nbytes
            if spec.category == "conv_dot":
                a["mxu_bytes"] += nbytes
                a["product_flops"] += flops
                if half_in:
                    a["half_product_flops"] += flops
                if half_acc:
                    a["half_dot_bytes"] += nbytes
                    a["half_dots"][spec.name] = \
                        a["half_dots"].get(spec.name, 0) + nbytes
            if num.get("reduces"):
                a["reduce_bytes"] += nbytes
                if half_acc:
                    a["half_reduce_bytes"] += nbytes
                    a["half_reduces"][spec.name] = \
                        a["half_reduces"].get(spec.name, 0) + nbytes
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
        flops = _conv_op_flops(base, args, out) if base in _CONV_OPS \
            and not kwargs else None
        if flops is None:
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
        ins = _tensors(args, []) + _tensors(kwargs, [])
        with self._lock:
            c = self.categories[cat]
            c["flops"] += flops
            c["bytes"] += nbytes
            c["instructions"] += 1
            if nbytes:
                self._count_audit(func, base, cat, flops, nbytes, ins, outs)
            self._count_writes(func, args, kwargs)
            if cat == "collective":
                self._count_collective(base, args)
            if flops:
                ent = self._ops.setdefault(base, {
                    "op_name": "aten." + base, "category": cat,
                    "flops": 0})
                ent["flops"] += flops
            self._sequence.update(sig.encode())
        return out

    def _count_collective(self, base, args):
        """One c10d call, by the JAX package's HLO kind, with its
        payload (the tensors of its first argument)."""
        name = base.strip("_")
        kind = next((k for prefix, k in _COLLECTIVE_KINDS
                     if name.startswith(prefix)), name)
        payload = _nbytes(_tensors(args[:1], []))
        rec = self._collectives.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += payload

    def collectives(self):
        """``{kind: {"count", "bytes"}}`` of the c10d calls walked."""
        with self._lock:
            return {k: dict(v) for k, v in self._collectives.items()}

    def _count_audit(self, func, base, cat, flops, nbytes, ins, outs):
        a = self._audit
        name = "aten." + base
        if cat == "transpose_layout":
            a["transpose_ops"][name] = \
                a["transpose_ops"].get(name, 0) + nbytes
        elif cat == "elementwise_fusion":
            a["unfused_elementwise_bytes"] += nbytes
            a["unfused_elementwise_count"] += 1
        elif cat == "conv_dot":
            a["mxu_bytes"] += nbytes
            a["product_flops"] += flops
            for t in ins + outs:
                if t.dim() >= 2:
                    a["mxu_actual_bytes"] += t.numel() * t.element_size()
                    a["mxu_padded_bytes"] += _aligned_bytes(t)
            if base.startswith(("convolution", "_convolution")):
                a["conv_bytes"] += nbytes
                if _nchw_activation(ins[:2]):
                    a["nchw_conv_bytes"] += nbytes
            if any(t.dtype in _HALF for t in ins):
                a["half_product_flops"] += flops
                if _half_accumulating_product(base, ins):
                    a["half_dot_bytes"] += nbytes
                    a["half_dots"][name] = \
                        a["half_dots"].get(name, 0) + nbytes
        if base == "_to_copy" and ins and outs and \
                ins[0].is_floating_point() and \
                outs[0].is_floating_point() and \
                ins[0].dtype != outs[0].dtype:
            a["convert_bytes"] += nbytes
            a["convert_ops"][name] = a["convert_ops"].get(name, 0) + nbytes
        if base in _REDUCE or torch.Tag.reduction in func.tags:
            a["reduce_bytes"] += nbytes
            dts = [t.dtype for t in ins + outs if t.is_floating_point()]
            if dts and all(d in _HALF for d in dts):
                a["half_reduce_bytes"] += nbytes
                a["half_reduces"][name] = \
                    a["half_reduces"].get(name, 0) + nbytes

    def _count_writes(self, func, args, kwargs):
        """Record the storages an op writes in place (its schema's
        mutable arguments)."""
        schema = func._schema
        if not schema.is_mutable:
            return
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in _tensors(v, []):
                try:
                    ptr = t.untyped_storage().data_ptr()
                except RuntimeError:
                    continue
                self._written[ptr] = t.untyped_storage().nbytes()

    # -- results --------------------------------------------------------
    def audit_counters(self):
        """The counters of the analysis audits (a copy)."""
        import copy
        with self._lock:
            return copy.deepcopy(self._audit)

    def written_bytes(self, tensors):
        """Bytes of the distinct storages among ``tensors`` that the run
        wrote in place."""
        seen, total = set(), 0
        with self._lock:
            for t in tensors:
                try:
                    ptr = t.untyped_storage().data_ptr()
                except RuntimeError:
                    continue
                if ptr in self._written and ptr not in seen:
                    seen.add(ptr)
                    total += t.untyped_storage().nbytes()
        return total

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
