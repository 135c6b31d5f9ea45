"""Recording and train/predict scopes (counterpart of
``mxnet_tpu/autograd.py``).

PyTorch records every operation on a tensor that requires a gradient,
so the port's tape is PyTorch's own.  What stays from MXNet is the pair
of thread-local flags the layers read:

- *recording* -- whether operations are recorded for backward; a scope
  that sets it also enters ``torch.enable_grad()`` or
  ``torch.no_grad()``;
- *training* -- whether layers run in training mode (``BatchNorm`` uses
  batch statistics and updates its running statistics).

``record()`` sets both, ``pause()`` clears recording and (by default)
training, ``train_mode()`` and ``predict_mode()`` set training alone.
:func:`set_recording` and :func:`set_training` set one flag outside a
scope and return its previous value; ``set_recording`` sets PyTorch's
grad mode with it.

On NDArrays (:mod:`mxnet_tpu_torch.ndarray`), :func:`backward`,
:func:`grad`, :func:`mark_variables` and :class:`Function` keep MXNet's
gradient requests where PyTorch always accumulates:

- ``"write"``: each backward overwrites the gradient.  Before it runs,
  the ``.grad`` of every leaf of the heads' graph that asks for
  ``"write"`` -- an NDArray's after ``attach_grad``, a gluon
  ``Parameter``'s -- is cleared, so PyTorch's accumulation starts from
  nothing;
- ``"add"``: gradients accumulate across backwards;
- ``"null"``: no gradient.

An NDArray leaf's ``grad`` is rebound to the leaf tensor's ``.grad``
after each backward.  A backward of an array not computed inside
``record()``, and a second backward through a graph freed by the first
(no ``retain_graph``), raise :class:`MXNetError`.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Function", "backward", "grad", "is_recording", "is_training",
           "mark_variables", "pause", "predict_mode", "record",
           "set_recording", "set_training", "train_mode"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Turn recording on or off; returns the previous setting."""
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    torch.set_grad_enabled(st.recording)
    return prev


def set_training(train_mode):
    """Turn training mode on or off; returns the previous setting."""
    st = _st()
    prev, st.training = st.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._is_record = is_record
        self._train = train_mode
        self._prev = None
        self._grad_mode = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._is_record is not None:
            st.recording = self._is_record
            self._grad_mode = torch.set_grad_enabled(self._is_record)
            self._grad_mode.__enter__()
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad_mode is not None:
            self._grad_mode.__exit__(*exc)
            self._grad_mode = None
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """Scope in which operations are recorded for backward."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording is suspended."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# ----------------------------------------------------------------------
# NDArray entry points
# ----------------------------------------------------------------------

def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf of backward whose
    gradient is the NDArray of ``gradients`` beside it."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        v._grad = g
        if req != "null":
            v._data.grad = g._data


def _leaves(heads):
    """The leaf tensors of the graph behind ``heads`` (a head that is a
    leaf itself among them)."""
    out = [h for h in heads if h.grad_fn is None and h.requires_grad]
    seen = set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        variable = getattr(node, "variable", None)
        if variable is not None:
            out.append(variable)
        stack.extend(nxt for nxt, _ in node.next_functions)
    return out


def _run_backward(heads, head_grads, retain_graph, create_graph=False,
                  inputs=None):
    """``torch.autograd`` backward (or ``grad`` when ``inputs`` are
    given) from NDArray ``heads``, with MXNet's errors."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate: array is not part of a recorded "
                "computation (call inside autograd.record())")
        if t.grad_fn is not None and t.grad_fn.metadata.get("mx_freed"):
            raise MXNetError(
                "backward through a graph that was already freed; pass "
                "retain_graph=True to backward() to allow repeated calls")
        tensors.append(t)
        grads.append(torch.ones_like(t) if hg is None
                     else hg._data.to(t.device, t.dtype))
    try:
        if inputs is not None:
            return torch.autograd.grad(tensors, inputs, grads,
                                       retain_graph=retain_graph,
                                       create_graph=create_graph,
                                       allow_unused=True)
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph,
                                create_graph=create_graph)
    except RuntimeError as e:
        if "backward through the graph a second time" in str(e):
            raise MXNetError(
                "backward through a graph that was already freed; pass "
                "retain_graph=True to backward() to allow repeated "
                "calls") from e
        raise
    finally:
        if not retain_graph:
            for t in tensors:
                if t.grad_fn is not None:
                    t.grad_fn.metadata["mx_freed"] = True
    return None


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backward from NDArray ``heads`` (head gradients of ones unless
    ``head_grads`` are given), into the gradients of every leaf of their
    graph, by each leaf's gradient request."""
    from .ndarray import NDArray
    hs = [heads] if isinstance(heads, NDArray) else list(heads)
    leaves = _leaves([h._data for h in hs])
    for t in leaves:
        if getattr(t, "_mx_grad_req", "add") == "write":
            t.grad = None
    _run_backward(hs, head_grads, retain_graph)
    for t in leaves:
        owner = getattr(t, "_mx_owner", None)
        nd = owner() if owner is not None else None
        if nd is not None and nd._grad is not None and t.grad is not None:
            nd._grad._data = t.grad


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (NDArrays)
    as NDArrays, leaving every ``.grad`` as it was; zeros for a variable
    the heads do not depend on."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    vs = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    got = _run_backward(heads, head_grads, retain_graph, create_graph,
                        inputs=[v._data for v in vs])
    outs = [NDArray(g if g is not None else torch.zeros_like(v._data))
            for g, v in zip(got, vs)]
    return outs[0] if single else outs


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported: use "
                     "HybridBlock.export / Symbol tracing instead")


class _FunctionBridge(torch.autograd.Function):
    """Runs a user :class:`Function`'s forward and backward on NDArrays
    inside one ``torch.autograd.Function``."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray import NDArray
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        ctx.single = not isinstance(outs, (tuple, list))
        outs = [outs] if ctx.single else list(outs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in grads])
        if not isinstance(in_grads, (tuple, list)):
            in_grads = (in_grads,)
        return (None,) + tuple(g._data if isinstance(g, NDArray) else g
                               for g in in_grads)


class Function:
    """A differentiable function on NDArrays with a forward and backward
    of the user's own (reference: ``autograd.py :: Function``), run as a
    ``torch.autograd.Function``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not (is_recording() and any(i._data.requires_grad
                                       for i in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = _FunctionBridge.apply(self, *[i._data for i in inputs])
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs
