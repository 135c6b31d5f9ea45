"""Inference predictors and self-contained artifacts (counterpart of
``mxnet_tpu/predictor.py``; reference ``src/c_api/c_predict_api.cc ::
MXPredCreate/SetInput/Forward/GetOutput`` and the ``amalgamation/``
edge-deploy story).

- :class:`Predictor` loads ``-symbol.json`` + ``.params`` into a
  :class:`~.gluon.SymbolBlock` and serves its forwards through one
  captured CUDA graph an input-shape class (on the
  CPU, plain calls), in an LRU bounded by ``jit_cache_size`` (default
  ``MXNET_TPU_SERVING_PREDICTOR_CACHE``).  A class has a
  :class:`~._capture.GraphOwner` of its own, so evicting it frees its
  graph and its memory pool; evictions count in the
  ``serving.compile_evictions`` telemetry counter.
- :func:`export_compiled` writes a ``.mxa`` archive: ``meta.json`` (the
  JAX package's keys), ``weights.params`` and, where the JAX package
  writes ``forward.stablehlo``, the block's exported symbol graph
  (``forward-symbol.json``).  CUDA graphs have no portable serialized
  form, so :class:`CompiledPredictor` loads the graph with no model code
  (a ``SymbolBlock`` again) and captures one graph for the artifact's
  input shapes.  An archive
  holding StableHLO (the JAX package's) raises.
- :class:`NativePredictor` drives the C predict runtime
  (``_native/predict_native.cc``, built with ``g++``): an ONNX
  interpreter on the host with a flat C ABI, the edge runtime with no
  Python, whose host execution is its purpose.

Parameters are read on the host and copied once onto the predictor's
device (the card unless ``ctx=mx.cpu()`` or a ``with mx.cpu():``); a
forward copies only its inputs.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from collections import OrderedDict

import numpy as np
import torch

from . import _capture
from . import autograd
from . import telemetry as _telemetry
from .base import MXNetError
from .gluon.block import _params_on
from .ndarray import NDArray
from .ndarray import ndarray as _nd_mod

__all__ = ["CompiledPredictor", "NativePredictor", "Predictor",
           "export_compiled"]


def _device(ctx):
    from .context import current_context, resolve_device
    return resolve_device(ctx if ctx is not None else current_context())


def _strip(key):
    return key.split(":", 1)[1] if ":" in key else key


def _inference(block):
    """``(fn, watched)``: ``fn(*tensors) -> tuple(outputs)``, an
    inference call of ``block``, and the parameter tensors a captured
    graph of it reads."""
    def fn(*xs):
        with torch.no_grad(), autograd.pause(train_mode=False):
            out = block(*xs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)
    return fn, [p._data for p in block._reg_params.values()]


class Predictor:
    """The C predict API object (reference: ``MXPredCreate``) over a
    graph and its parameters."""

    def __init__(self, symbol_file, param_file=None, ctx=None,
                 input_shapes=None, jit_cache_size=None):
        from . import symbol as sym_mod
        self._sym = sym_mod.load(symbol_file) \
            if isinstance(symbol_file, str) \
            else sym_mod.load_json(symbol_file.decode()
                                   if isinstance(symbol_file, bytes)
                                   else symbol_file)
        self._device = _device(ctx)
        self._params = _params_on(param_file, self._device)
        given = {_strip(k) for k in self._params}
        arg_names = self._sym.list_arguments()
        aux_names = self._sym.list_auxiliary_states()
        self._input_names = [n for n in arg_names
                             if n not in given and n not in aux_names]
        if input_shapes:
            missing = [n for n in input_shapes if n not in arg_names]
            if missing:
                raise MXNetError("unknown inputs %r" % missing)
        self._input_shapes = dict(input_shapes or {})
        self._inputs = {}
        self._outputs = None
        if jit_cache_size is None:
            from . import env as _env
            jit_cache_size = _env.get("MXNET_TPU_SERVING_PREDICTOR_CACHE")
        self._jit_cache_size = max(1, int(jit_cache_size))
        self._jit_cache = OrderedDict()   # shape key -> GraphOwner
        self._block = None                # built at the first forward

    def _owner_for(self, key):
        """The graph owner of this input-shape class, LRU-bounded: the
        least-recently-used class beyond the bound is dropped, and its
        graph and memory pool with it."""
        cache = self._jit_cache
        owner = cache.get(key)
        if owner is None:
            owner = cache[key] = _capture.GraphOwner("Predictor",
                                                     self._device)
            if len(cache) > self._jit_cache_size:
                cache.popitem(last=False)
                if _telemetry._ENABLED:
                    _telemetry.hooks.serving_evict()
        else:
            cache.move_to_end(key)
        return owner

    def set_input(self, name, arr):
        """Reference: ``MXPredSetInput``; the value lands on the
        predictor's device."""
        if name not in self._input_names:
            raise MXNetError("unknown input %r (inputs: %s)"
                             % (name, self._input_names))
        t = arr._data if isinstance(arr, NDArray) else arr
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(t)))
        self._inputs[name] = t.to(self._device)

    def forward(self, **kwargs):
        """Reference: ``MXPredForward``; returns the outputs as
        NDArrays."""
        for k, v in kwargs.items():
            self.set_input(k, v)
        missing = [n for n in self._input_names if n not in self._inputs]
        if missing:
            raise MXNetError("inputs not set: %r" % missing)
        if self._block is None:
            self._block = self._symbol_block()
        fn, watched = _inference(self._block)
        xs = [self._inputs[n] for n in self._input_names]
        key = tuple((n, tuple(t.shape), str(t.dtype))
                    for n, t in zip(self._input_names, xs))
        owner = self._owner_for(key)
        outs = owner.run(key, fn, xs, watched, "Predictor %r" % (key,))
        self._outputs = [NDArray(o) for o in outs]
        return self._outputs

    def _symbol_block(self):
        """The graph as a :class:`~.gluon.SymbolBlock` over the
        parameters; aux states absent from them get defaults (zeros;
        ones for variances) from one shape inference at the inputs set
        now."""
        from .gluon.block import SymbolBlock
        params = dict(self._params)
        given = {_strip(k) for k in params}
        aux_names = self._sym.list_auxiliary_states()
        if any(n not in given for n in aux_names):
            shapes = {_strip(k): tuple(v.shape) for k, v in params.items()}
            shapes.update({n: tuple(v.shape)
                           for n, v in self._inputs.items()})
            shapes.update(self._input_shapes)
            _, _, aux_shapes = self._sym.infer_shape(**{
                k: shapes[k] for k in self._sym.list_arguments()
                if k in shapes})
            for n, s in zip(aux_names, aux_shapes):
                if n not in given:
                    params["aux:" + n] = torch.full(
                        s, 1.0 if n.endswith("var") else 0.0,
                        device=self._device)
        return SymbolBlock(self._sym, self._input_names, params)

    def get_output(self, index=0):
        """Reference: ``MXPredGetOutput``."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index]

    @property
    def output_count(self):
        return len(self._sym._outputs)


# ----------------------------------------------------------------------
# Self-contained artifacts ("Edge" deploy)
# ----------------------------------------------------------------------

_MXA_VERSION = 1
_GRAPH_ENTRY = "forward-symbol.json"


def _input_names(n):
    return ["data"] if n == 1 else ["data%d" % i for i in range(n)]


def export_compiled(block, path, input_shapes, dtype="float32"):
    """Write ``block`` as a self-contained ``.mxa`` archive: its symbol
    graph, its weights and its calling convention (the input shapes and
    dtype).  Loading it needs no model code (:class:`CompiledPredictor`).
    A block whose forward does not trace to a symbol graph raises."""
    from .gluon.block import HybridBlock
    from .symbol.export import symbolic_forward
    from .symbol.symbol import Group, var
    if not isinstance(block, HybridBlock):
        raise MXNetError("export_compiled expects a HybridBlock")
    shapes = [tuple(int(d) for d in s) for s in input_shapes]
    params = list(block._all_params())
    if any(p._data is None for p in params):
        # size deferred parameters with one probe forward, on the device
        # (and at the dtype) the sized parameters use
        device = next((p._data.device for p in params
                       if p._data is not None), None) \
            or next(p._deferred_init[1] for p in params
                    if p._deferred_init is not None)
        with autograd.pause():
            block(*[torch.zeros(s, dtype=getattr(torch, str(dtype)),
                                device=device) for s in shapes])
    names = _input_names(len(shapes))
    out = symbolic_forward(block, *[var(n) for n in names])
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    graph = Group(outs) if len(outs) > 1 else outs[0]
    weights = {p.name: p._data.detach() for p in block._all_params()
               if p._data is not None}
    with tempfile.TemporaryDirectory() as d:
        pfile = os.path.join(d, "weights.params")
        _nd_mod.save(pfile, weights)
        with open(pfile, "rb") as f:
            param_bytes = f.read()
    meta = {
        "version": _MXA_VERSION,
        "input_shapes": [list(s) for s in shapes],
        "input_dtype": str(dtype),
        "param_names": list(weights),
        "num_outputs": len(graph._outputs),
    }
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr(_GRAPH_ENTRY, graph.tojson())
        z.writestr("weights.params", param_bytes)
    return path


class CompiledPredictor:
    """Serve a ``.mxa`` archive of :func:`export_compiled` with no model
    code: the graph is walked over the archive's weights, copied once
    onto ``ctx`` (the card by default), and on the card captured into
    one CUDA graph for the archive's input shapes at load."""

    def __init__(self, path, ctx=None):
        from .symbol.symbol import load_json
        with zipfile.ZipFile(path) as z:
            entries = set(z.namelist())
            if "forward.stablehlo" in entries:
                raise MXNetError(
                    "%s holds a StableHLO program (the JAX package's "
                    ".mxa), which the port cannot run: CUDA graphs have "
                    "no portable serialized form, so the port's archive "
                    "carries the block's symbol graph (%s) in its place; "
                    "re-export the block with the port's export_compiled"
                    % (path, _GRAPH_ENTRY))
            if _GRAPH_ENTRY not in entries:
                raise MXNetError("%s is not a .mxa archive (no %s)"
                                 % (path, _GRAPH_ENTRY))
            self.meta = json.loads(z.read("meta.json"))
            sym = load_json(z.read(_GRAPH_ENTRY).decode())
            param_bytes = z.read("weights.params")
        from .gluon.block import SymbolBlock
        self._device = _device(ctx)
        with tempfile.TemporaryDirectory() as d:
            pfile = os.path.join(d, "weights.params")
            with open(pfile, "wb") as f:
                f.write(param_bytes)
            params = _params_on(pfile, self._device)
        self._shapes = [tuple(s) for s in self.meta["input_shapes"]]
        self._dtype = getattr(torch, self.meta["input_dtype"])
        given = {_strip(k) for k in params}
        names = [n for n in sym.list_arguments() if n not in given]
        if len(names) != len(self._shapes):
            raise MXNetError("%s: the graph has inputs %r, the archive "
                             "%d input shapes" % (path, names,
                                                  len(self._shapes)))
        self._fn, self._watched = _inference(
            SymbolBlock(sym, names, params))
        self._owner = _capture.GraphOwner("CompiledPredictor",
                                          self._device)
        self._key = ("forward",) + tuple(self._shapes)
        if self._owner.cuda:
            # warm, then capture: the first call replays
            zeros = [torch.zeros(s, dtype=self._dtype, device=self._device)
                     for s in self._shapes]
            for _ in range(2):
                self._run(zeros)

    def _run(self, xs):
        return self._owner.run(self._key, self._fn, xs, self._watched,
                               "CompiledPredictor")

    def forward(self, *inputs):
        """The outputs, as NDArrays, of NDArrays, tensors or numpy
        arrays at the archive's input shapes."""
        xs = []
        for x, shape in zip(inputs, self._shapes):
            t = x._data if isinstance(x, NDArray) else x
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(t)))
            if tuple(t.shape) != shape:
                raise MXNetError("CompiledPredictor: input of shape %s, "
                                 "the archive takes %s"
                                 % (tuple(t.shape), shape))
            xs.append(t.to(self._device, self._dtype))
        if len(xs) != len(self._shapes):
            raise MXNetError("CompiledPredictor: %d inputs, the archive "
                             "takes %d" % (len(xs), len(self._shapes)))
        return [NDArray(o) for o in self._run(xs)]

    __call__ = forward


class NativePredictor:
    """Python handle of the C predict runtime (reference:
    ``c_predict_api.h``): a dependency-free C++ interpreter of exported
    ONNX files on the host, with a flat C ABI usable from any language;
    this class is the binding for tests and Python callers."""

    def __init__(self, onnx_path):
        import ctypes
        from ._native import load_predict
        lib = load_predict()
        if lib is None:
            raise MXNetError("native predict runtime unavailable "
                             "(no C++ toolchain?)")
        self._lib = lib
        self._h = ctypes.c_void_p()
        rc = lib.MXPredCreateFromFile(str(onnx_path).encode(),
                                      ctypes.byref(self._h))
        if rc != 0:
            raise MXNetError("MXPredCreate failed: %s"
                             % lib.MXPredGetLastError().decode())

    def forward(self, data, input_name=None):
        """Logits of one input (an NDArray, a tensor or an array-like)
        as a float32 numpy array."""
        import ctypes
        lib = self._lib
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(data, np.float32))
        shape = (ctypes.c_int64 * a.ndim)(*a.shape)
        rc = lib.MXPredSetInput(
            self._h, input_name.encode() if input_name else None,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape,
            a.ndim)
        if rc == 0:
            rc = lib.MXPredForward(self._h)
        if rc != 0:
            raise MXNetError("MXPredForward failed: %s"
                             % lib.MXPredGetLastError().decode())
        # two-step query: the rank first (shape=NULL), then the dims
        ndim = ctypes.c_int()
        lib.MXPredGetOutputShape(self._h, 0, None, ctypes.byref(ndim))
        oshape = (ctypes.c_int64 * max(ndim.value, 1))()
        lib.MXPredGetOutputShape(self._h, 0, oshape, ctypes.byref(ndim))
        out = np.empty(tuple(oshape[i] for i in range(ndim.value)),
                       np.float32)
        rc = lib.MXPredGetOutput(
            self._h, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size)
        if rc != 0:
            raise MXNetError("MXPredGetOutput failed: %s"
                             % lib.MXPredGetLastError().decode())
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.MXPredFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
