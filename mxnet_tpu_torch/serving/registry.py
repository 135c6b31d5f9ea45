"""Multi-tenant model registry: sources -> servable handles (counterpart
of ``mxnet_tpu/serving/registry.py``).

A :class:`Servable` is one deployed fixed-shape model: a
:class:`~.executor.BucketExecutorPool` (warmed at registration) behind a
:class:`~.batcher.DynamicBatcher` with its own worker thread and bounded
queue.  A generative servable (:mod:`.decode`) serves an autoregressive
decoder.  The :class:`ModelRegistry` owns many of them by name.

Sources:

- **Gluon block** (``block=``): the block's forward, in inference mode,
  on the device its parameters lie on, over the servable's own copy of
  the parameters taken at registration (after a checkpoint restore,
  before warm-up): training the block afterwards, or restoring another
  step into it for the next servable, leaves this servable's answers as
  they were -- the JAX package's servable holds its immutable arrays;
- **checkpoint** (``checkpoint=`` with ``block=``): parameters restored
  from a manifest-verified
  :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` step (the
  newest intact one by default) into the block, then served as a block;
- **symbol and params** (``symbol=``/``params=``): a ``-symbol.json``
  graph (a path or a Symbol) and its parameters (a ``.params`` path or
  a dict; the reference's ``arg:``/``aux:`` prefixes accepted) as a
  :class:`~mxnet_tpu_torch.gluon.SymbolBlock`, served as a block whose
  snapshot lies on the current context's device (the card unless a
  ``with mx.cpu():`` is in force); ``input_name=`` picks the batched
  input when the graph has several;
- **ONNX** (``onnx=``): ``mx.onnx.import_model``, third-party files
  included, then served as a graph;
- ``register_generative(params=)`` or ``(checkpoint=)``: a decoder's
  weights from a dict or from a checkpoint's ``params`` item.

A graph source's fingerprint digests the graph's JSON and its
parameters' names, shapes and dtypes in place of a block's structure.

Registration warms every bucket, checks the predicted peak device memory
of each against the card's (:meth:`ModelRegistry._validate_hbm`, a
warning for a bucket that cannot fit), then installs: the chaos fail
point ``serving.swap`` sits between the two, where a swap dies late,
and the servable it would have replaced keeps serving untouched.  The
``serving.register.warm`` and ``.install`` spans and the
``serving.register`` telemetry event are the JAX package's.  CUDA graphs
have no portable serialized form, so ``ModelRegistry(cache_dir=,
compile_cache=)`` is accepted and keeps no cache: every registration
captures its buckets anew (counted as compile-cache misses).

::

    reg = ModelRegistry()
    reg.register("resnet", block=net, checkpoint=root,
                 input_shape=(224, 224, 3))
    y = reg.infer("resnet", img)           # batched with other callers
    reg.shutdown(drain=True)
"""
from __future__ import annotations

import hashlib

import torch

from .. import autograd
from .. import chaos as _chaos
from .. import obs as _obs
from .. import sync as _sync
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..ndarray import NDArray
from .batcher import DynamicBatcher, ServableClosed
from .executor import BucketExecutorPool, device_hbm_bytes

__all__ = ["ModelRegistry", "Servable"]


def _default_buckets():
    from .. import env as _env
    spec = _env.get("MXNET_TPU_SERVING_BUCKETS")
    try:
        return tuple(int(tok) for tok in str(spec).split(",") if tok)
    except ValueError as e:
        raise MXNetError("MXNET_TPU_SERVING_BUCKETS=%r is not a "
                         "comma-separated int list" % (spec,)) from e


_CONFIG_TYPES = (bool, int, float, str, type(None))


def _config(module):
    """A block's own settings: the scalar and tuple attributes it keeps
    (units, strides, epsilon, activation, layout), not its name."""
    out = []
    for k, v in sorted(vars(module).items()):
        if k in ("training", "_prefix", "_active"):
            continue
        if isinstance(v, _CONFIG_TYPES) or (
                isinstance(v, tuple)
                and all(isinstance(e, _CONFIG_TYPES) for e in v)):
            out.append([k, v])
    return out


def _structure(block):
    """What a serving fingerprint records of a block: each sub-block's
    structural path, class and settings, and each parameter's
    structural name, shape and dtype -- nothing that depends on the
    instance's name."""
    out = {"blocks": [[path, type(m).__name__, _config(m)]
                      for path, m in block.named_modules()],
           "params": [[k, list(p._data.shape), str(p._data.dtype)]
                      for k, p in sorted(
                          block._collect_params_with_prefix().items())
                      if p._data is not None]}
    graph = getattr(block, "_outputs", None)
    if graph is not None:               # a SymbolBlock: its graph's JSON
        out["graph"] = hashlib.sha256(graph.tojson().encode()).hexdigest()
    return out


def _manager(checkpoint):
    from ..checkpoint import CheckpointManager
    return checkpoint if isinstance(checkpoint, CheckpointManager) \
        else CheckpointManager(checkpoint)


class Servable:
    """One deployed fixed-shape model: executor pool + dynamic
    batcher."""

    def __init__(self, name, pool, batcher, source):
        self.name = name
        self.source = source
        self._pool = pool
        self._batcher = batcher

    # -- client surface -------------------------------------------------
    def submit(self, x, timeout=None):
        """Queue one sample; returns a ``concurrent.futures.Future``."""
        return self._batcher.submit(x, timeout=timeout)

    def infer(self, x, timeout=None):
        """Blocking single-sample inference: submit + wait.  The
        ``timeout`` bounds the whole round trip."""
        return self.submit(x, timeout=timeout).result(timeout=timeout)

    # -- introspection --------------------------------------------------
    @property
    def buckets(self):
        return self._pool.buckets

    @property
    def input_shape(self):
        return self._pool.input_shape

    @property
    def dtype(self):
        return self._pool.dtype

    def fingerprint(self, bucket):
        """The digest of what ``bucket``'s graph computes
        (:meth:`BucketExecutorPool.fingerprint`)."""
        return self._pool.fingerprint(bucket)

    def queue_depth(self):
        return self._batcher.queue_depth()

    @property
    def queue_capacity(self):
        """Bounded queue depth past which submits shed (the readiness
        check reads depth against this)."""
        return self._batcher.max_queue

    def stats(self):
        """The batcher's counts (:meth:`DynamicBatcher.stats`)."""
        return self._batcher.stats()

    @property
    def closed(self):
        return self._batcher.closed

    def close(self, drain=True):
        self._batcher.close(drain=drain)

    def __repr__(self):
        return "Servable(%r, source=%r, buckets=%r, input=%r)" % (
            self.name, self.source, self.buckets, self.input_shape)


class ModelRegistry:
    """Name -> servable store; the multi-tenant serving surface.

    ::

        reg = ModelRegistry()
        reg.register("lenet", block=net, input_shape=(1, 28, 28))
        y = reg.infer("lenet", x)          # dynamically batched
        reg.shutdown(drain=True)
    """

    def __init__(self, cache_dir=None, compile_cache=True):
        self._lock = _sync.Lock(name="serving.registry")
        self._servables = {}
        # no portable artifact to cache (``cache_dir`` has nothing to
        # hold): the flag only counts each warmed bucket as a miss
        self._compile_cache = bool(compile_cache)
        _obs.status.register_registry(self)   # weak: health, statusz

    # -- registration ---------------------------------------------------
    def register(self, name, block=None, symbol=None, params=None,
                 onnx=None, checkpoint=None, step=None, input_shape=None,
                 dtype="float32", input_name=None, buckets=None,
                 max_wait_ms=None, max_queue=None, warmup=True):
        """Load a model from one source into a warm servable handle.

        Exactly one of ``block``, ``symbol`` (with ``params``) and
        ``onnx`` is the source (``checkpoint`` composes with ``block``:
        the newest intact step, or ``step``, is restored into the block
        first).  ``input_shape`` is the per-sample shape (no batch dim)
        and is required.  A block's forward runs on the device its
        parameters lie on, a graph's on the current context's.
        Registration runs every bucket once, so no request pays a first
        run; re-registering a name drains and replaces the previous
        servable.
        """
        if input_shape is None:
            raise MXNetError("serving.register needs input_shape "
                             "(per-sample, no batch dim)")
        if checkpoint is not None and block is None:
            raise MXNetError("checkpoint= needs block= for the "
                             "architecture (a manifest stores params)")
        if sum(s is not None for s in (block, symbol, onnx)) != 1:
            raise MXNetError("serving.register needs exactly one of "
                             "block= / symbol= / onnx=")
        if checkpoint is not None:
            self._restore_checkpoint(block, checkpoint, step)
            source = "checkpoint"
        elif block is not None:
            source = "block"
        elif onnx is not None:
            source = "onnx"
        else:
            source = "symbol"
        device = None
        if block is None:
            # a graph source: its SymbolBlock, served on the current
            # context's device
            from ..context import current_context
            block = self._graph_block(symbol, params, onnx, input_name)
            device = resolve_device(current_context())
        fn, device, snapshot, structure = self._from_block(
            block, input_shape, dtype, device)
        buckets = tuple(buckets) if buckets else _default_buckets()
        pool = BucketExecutorPool(
            fn, input_shape, dtype, buckets, device,
            watch=lambda: snapshot, label=name, structure=structure,
            param_bytes=sum(t.numel() * t.element_size()
                            for t in snapshot),
            compile_cache=self._compile_cache)
        if warmup:
            sp = _obs.begin_span("serving.register.warm", model=name) \
                if _obs._TRACE_ENABLED else None
            try:
                pool.warmup()
            finally:
                if sp is not None:
                    _obs.end_span(sp)
            self._validate_hbm(name, pool)
        # chaos: an abort here (after the expensive warm-up, before the
        # install) models every way a swap dies late; the previous
        # servable MUST keep serving untouched
        _chaos.fail_point("serving.swap", model=name)
        sp = _obs.begin_span("serving.register.install", model=name) \
            if _obs._TRACE_ENABLED else None
        try:
            batcher = DynamicBatcher(pool, label=name,
                                     max_wait_ms=max_wait_ms,
                                     max_queue=max_queue)
            servable = Servable(name, pool, batcher, source)
            self._install(name, servable)
        finally:
            if sp is not None:
                _obs.end_span(sp)
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_model(name, source, len(buckets))
        return servable

    def _install(self, name, servable):
        """Install ``servable`` under ``name``; returns the number of
        sequences a replaced generative servable drained (0 for a
        fixed-shape one)."""
        with self._lock:
            old = self._servables.get(name)
            self._servables[name] = servable
        if old is None:
            return 0
        # drain=True keeps serving (or, for a decoder, STEPPING) the old
        # servable until everything it accepted has finished
        return old.close(drain=True) or 0

    @staticmethod
    def _validate_hbm(name, pool):
        """Predict every bucket's peak device memory
        (:meth:`BucketExecutorPool.hbm_plan`) and warn on buckets that
        cannot fit the card -- registration still succeeds (an
        oversized bucket may never be dispatched), but the operator
        hears it before an out-of-memory error does the telling.
        Returns the plan, or None on the CPU."""
        limit = device_hbm_bytes(pool.device)
        if not limit:
            return None
        plan = pool.hbm_plan(limit)
        bad = [str(b["batch"]) for b in plan["buckets"]
               if b["fits"] is False]
        if bad:
            import warnings
            warnings.warn(
                "servable %r: predicted peak device memory exceeds the "
                "card's for bucket(s) %s (largest fitting bucket: %s)"
                % (name, ", ".join(bad), plan["largest_fit_bucket"]),
                RuntimeWarning, stacklevel=3)
        return plan

    def register_generative(self, name, model, params=None,
                            checkpoint=None, step=None,
                            prefill_buckets=None, decode_buckets=None,
                            block_size=None, num_blocks=None,
                            max_queue=None, warmup=True,
                            kv_dtype="float32", device=None):
        """Deploy an autoregressive decoder as a generative servable.

        ``model`` is the pure-function spec
        (:class:`~mxnet_tpu_torch.serving.decode.TinyGPT`-shaped);
        weights come from ``params=``, a flat name->array dict (tensors
        or numpy arrays), or from ``checkpoint=``, a
        :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` (or its
        root) whose step (the newest intact one unless ``step``) carries
        a ``params`` item.  They are moved to ``device`` (CUDA unless
        ``"cpu"``).  Registration warms every prefill and decode bucket,
        then installs; re-registering a name swaps mid-decode safely --
        the old engine drains its half-generated sequences to completion
        while the replacement takes new requests.
        """
        from .decode.convert import params_from_numpy
        from .decode.engine import DecodeEngine, GenerativeServable
        if (params is None) == (checkpoint is None):
            raise MXNetError("register_generative needs exactly one "
                             "of params= / checkpoint=")
        if checkpoint is not None:
            params = {k: v._data if isinstance(v, NDArray) else v
                      for k, v in self._restore_params(checkpoint,
                                                       step).items()}
        dev = resolve_device(device)
        # a fresh dict of fresh tensors: the caller's tensors may be
        # updated in place after this returns
        engine = DecodeEngine(model, params_from_numpy(params, dev),
                              prefill_buckets=prefill_buckets,
                              decode_buckets=decode_buckets,
                              block_size=block_size,
                              num_blocks=num_blocks,
                              max_queue=max_queue, label=name,
                              kv_dtype=kv_dtype, device=dev,
                              compile_cache=self._compile_cache)
        if warmup:
            sp = _obs.begin_span("serving.register.warm", model=name) \
                if _obs._TRACE_ENABLED else None
            try:
                engine.warmup()
            finally:
                if sp is not None:
                    _obs.end_span(sp)
        # same late-abort contract as register(): a chaos fault here
        # (warmed, not yet installed) leaves the old servable -- and
        # every sequence it is generating -- untouched
        try:
            _chaos.fail_point("serving.swap", model=name)
        except BaseException:
            engine.close(drain=False)
            raise
        sp = _obs.begin_span("serving.register.install", model=name) \
            if _obs._TRACE_ENABLED else None
        try:
            engine.start()
            servable = GenerativeServable(name, engine)
            live = self._install(name, servable)
            if live:
                _chaos.survived("serving.decode_swap",
                                "drained %d live" % live)
        finally:
            if sp is not None:
                _obs.end_span(sp)
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_model(
                name, "generative",
                len(engine.prefill_buckets) + len(engine.decode_buckets))
        return servable

    @staticmethod
    def _restore_params(checkpoint, step):
        mgr = _manager(checkpoint)
        ckpt = mgr.restore(step=step)
        if ckpt is None:
            raise MXNetError("serving: no intact checkpoint under %r"
                             % mgr.root)
        if "params" not in ckpt.items:
            raise MXNetError(
                "serving: checkpoint step %d has no 'params' item "
                "(items: %s)" % (ckpt.step, sorted(ckpt.items)))
        return ckpt.items["params"]

    @staticmethod
    def _restore_checkpoint(block, checkpoint, step):
        mgr = _manager(checkpoint)
        ckpt = mgr.restore_training(block, step=step)
        if ckpt is None:
            raise MXNetError("serving: no intact checkpoint under %r"
                             % mgr.root)
        return ckpt

    @staticmethod
    def _from_block(block, input_shape, dtype, device=None):
        """``(fn, device, snapshot, structure)`` of a block:
        ``fn(x) -> tuple(outputs)`` runs the block's forward over
        ``snapshot``, copies of its parameters taken now, on ``device``
        (by default the one they lie on); ``structure`` describes the
        block for the pool's fingerprint.  Parameters whose shape is
        still deferred are sized by one probe forward first (outside
        inference mode, so the new parameters can take gradients
        later)."""
        from ..gluon.block import param_values_from
        from ..gluon.block import HybridBlock
        if not isinstance(block, HybridBlock):
            raise MXNetError("serving: block= expects a HybridBlock")
        params = list(block._all_params())
        if device is None:
            device = next((p._data.device for p in params
                           if p._data is not None), None)
        if device is None:
            device = next((p._deferred_init[1] for p in params
                           if p._deferred_init is not None), None)
        if device is None:
            raise MXNetError("serving: initialize the block first")
        if any(p._data is None for p in params):
            probe = torch.zeros((1,) + tuple(input_shape),
                                dtype=getattr(torch, str(dtype)),
                                device=device)
            with autograd.pause():
                block(probe)
        with torch.no_grad():
            values = {p: p._data.detach().to(device, copy=True)
                      for p in params if p._data is not None}

        def fn(x):
            with param_values_from(values):
                out = block(x)
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        return fn, device, list(values.values()), _structure(block)

    @staticmethod
    def _graph_block(symbol, params, onnx, input_name):
        """The :class:`~..gluon.SymbolBlock` of a graph source: a
        ``-symbol.json`` path or a Symbol with its parameters (a
        ``.params`` path or a dict, ``arg:``/``aux:`` prefixes
        accepted), or an ONNX file; its one batched input is
        ``input_name`` or the one argument the parameters leave."""
        from ..gluon.block import SymbolBlock
        from ..ndarray import ndarray as _nd
        from ..symbol import symbol as sym_mod
        if onnx is not None:
            from ..onnx import import_model
            sym, arg_params, aux_params = import_model(onnx)
            params = dict(arg_params)
            params.update({"aux:" + k: v for k, v in aux_params.items()})
        else:
            sym = sym_mod.load(symbol) if isinstance(symbol, str) \
                else symbol
            params = _nd.load_tensors(params) if isinstance(params, str) \
                else dict(params or {})
        given = {k.split(":", 1)[-1] for k in params}
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        inputs = [n for n in arg_names
                  if n not in given and n not in aux_names]
        if input_name is None:
            if len(inputs) != 1:
                raise MXNetError(
                    "serving: graph has inputs %r; pass input_name= to "
                    "pick the batched one (others must be in params)"
                    % (inputs,))
            input_name = inputs[0]
        elif input_name not in arg_names:
            raise MXNetError("serving: unknown input %r (arguments: %s)"
                             % (input_name, arg_names))
        missing = [n for n in aux_names if n not in given]
        if missing:
            raise MXNetError("serving: aux states %r missing from "
                             "params" % (missing,))
        return SymbolBlock(sym, [input_name], params)

    # -- lookup / client ------------------------------------------------
    def servable(self, name):
        with self._lock:
            s = self._servables.get(name)
        if s is None:
            raise MXNetError("serving: no servable %r (registered: %s)"
                             % (name, self.names()))
        return s

    def names(self):
        with self._lock:
            return sorted(self._servables)

    def submit(self, name, x, timeout=None):
        """Queue one sample on the named servable.  A concurrent
        re-register can close the handle between the lookup and the
        submit; the replacement is installed by then, so the lookup
        retries against it."""
        for _ in range(8):
            s = self.servable(name)
            try:
                return s.submit(x, timeout=timeout)
            except ServableClosed:
                with self._lock:
                    cur = self._servables.get(name)
                if cur is None or cur is s:
                    raise               # really closed, not swapped
        raise ServableClosed(
            "serving: servable %r kept closing mid-submit (flapping "
            "re-registration?)" % name)

    def infer(self, name, x, timeout=None):
        return self.submit(name, x, timeout=timeout).result(
            timeout=timeout)

    def generate(self, name, prompt, max_new_tokens, eos_id=None,
                 timeout=None):
        """Stream generated tokens from the named generative servable
        (a :class:`~mxnet_tpu_torch.serving.decode.GenerationStream`).
        A hot swap between lookup and admission closes the old handle;
        the replacement is installed by then, so the lookup retries
        against it."""
        for _ in range(8):
            s = self.servable(name)
            if not hasattr(s, "generate"):
                raise MXNetError("serving: servable %r (source=%r) is "
                                 "not generative" % (name, s.source))
            try:
                return s.generate(prompt, max_new_tokens,
                                  eos_id=eos_id, timeout=timeout)
            except ServableClosed:
                with self._lock:
                    cur = self._servables.get(name)
                if cur is None or cur is s:
                    raise               # really closed, not swapped
        raise ServableClosed(
            "serving: servable %r kept closing mid-generate (flapping "
            "re-registration?)" % name)

    # -- lifecycle ------------------------------------------------------
    def unregister(self, name, drain=True):
        with self._lock:
            s = self._servables.pop(name, None)
        if s is None:
            raise MXNetError("serving: no servable %r" % name)
        s.close(drain=drain)

    def shutdown(self, drain=True):
        """Close every servable (draining by default)."""
        with self._lock:
            servables = list(self._servables.values())
            self._servables.clear()
        for s in servables:
            s.close(drain=drain)

    def __contains__(self, name):
        with self._lock:
            return name in self._servables

    def __len__(self):
        with self._lock:
            return len(self._servables)
