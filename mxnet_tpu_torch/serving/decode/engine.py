"""The autoregressive decode engine: separately bucketed prefill and
decode, continuous batching, token streaming (counterpart of
``mxnet_tpu/serving/decode/engine.py``).

- **bucketed split**: prefill (whole prompt -> cache blocks + first
  token) runs at batch 1, padded to a PROMPT-LENGTH bucket; the decode
  step (one token per slot over the paged cache) runs padded to a
  SLOT-COUNT bucket.  The JAX engine compiles one program per bucket;
  on the card the port captures one CUDA graph per bucket, all in one
  memory pool (:mod:`..._capture`): :meth:`DecodeEngine.warmup` runs
  every bucket once eagerly on the capture stream (the kernels' build,
  the matmul libraries' set-up), then captures and replays it.  A
  decode graph reads tokens, positions and block tables from static
  buffers that each step refreshes with ``copy_``, and writes the new
  K/V into the cache slabs, allocated once; a prefill graph reads the
  prompt, its block table and its true length the same way and
  scatters the prompt's K/V into the cache blocks inside the graph
  (positions past the true length land in the scratch block), as the
  JAX prefill program does.  On the CPU every bucket runs eagerly.
- **continuous batching**: one worker thread runs an admit-then-step
  loop.  Pending requests join the RUNNING batch at a step boundary
  (one prefill each), finished sequences vacate their slot the step
  they finish, and live slots pad up to the smallest decode bucket;
  padded slots carry all-scratch block tables.
- **admission backpressure**: the whole ``prompt + max_new`` KV budget
  is allocated at submit; an exhausted cache or a full pending queue
  sheds with :class:`~mxnet_tpu_torch.serving.batcher.ServingQueueFull`.
- **token streaming**: :meth:`DecodeEngine.submit` returns a
  :class:`GenerationStream` that yields each token as it is decoded.

Hot swap: re-registering a :class:`GenerativeServable` installs the
replacement for new requests while the old engine's
``close(drain=True)`` steps its half-generated sequences to completion;
:class:`GenerativeWatcher` drives that swap from a checkpoint root.
Each engine's graphs live on its own capture stream, so the old and the
new engine keep separate paged-attention scratch.

The chaos fail points ``serving.decode.prefill`` and
``serving.decode.step`` sit before each program call; the ``decode.*``
telemetry and the ``serving.decode_step`` / ``serving.request`` spans
are the JAX package's.  :meth:`DecodeEngine.fingerprint` is a stable
digest of what a bucket's graph computes (the model's geometry, the
parameters' names, shapes and dtypes, the bucket's input shapes, the
cache's geometry and dtype, the backend settings and the kernel
libraries).
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import queue as _queue_mod
import threading
import time

import numpy as np
import torch

from ... import _build, _capture
from ... import chaos as _chaos
from ... import obs as _obs
from ... import sync as _sync
from ... import telemetry as _telemetry
from ...base import MXNetError
from ...context import resolve_device
from ...ops.paged_attention import reserve_scratch, scratch_sizes
from ..batcher import RequestTimeout, ServableClosed, ServingQueueFull
from ..loop import RegistryWatcher as _RegistryWatcher
from .kvcache import SCRATCH_BLOCK, KVCacheExhausted, PagedKVCache

__all__ = ["DecodeEngine", "GenerationStream", "GenerativeServable",
           "GenerativeWatcher"]

_IDLE_WAIT_S = 0.05
_DONE = object()


def _env_buckets(var):
    from ... import env as _env
    spec = _env.get(var)
    try:
        return tuple(sorted({int(tok) for tok in str(spec).split(",")
                             if tok}))
    except ValueError as e:
        raise MXNetError("%s=%r is not a comma-separated int list"
                         % (var, spec)) from e


class GenerationStream:
    """Iterator over one request's generated token ids.

    Tokens arrive as the engine decodes them; iteration blocks until
    the next token, ``StopIteration`` lands after EOS / ``max_new`` /
    cancel / drain, and an engine-side failure re-raises here.
    ``cancel()`` asks the engine to drop the sequence at the next step
    boundary (its cache blocks are freed there)."""

    def __init__(self, model, prompt_len, max_new):
        self.model = model
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self._q = _queue_mod.Queue()
        self._error = None
        self._finished = False
        self.finish_reason = None       # eos | length | cancel | closed
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_first_token = None

    # -- engine side ----------------------------------------------------
    def _push(self, token, now):
        if self.t_first_token is None:
            self.t_first_token = now
        self._q.put(int(token))

    def _finish(self, reason, error=None):
        self.finish_reason = reason
        self._error = error
        self._q.put(_DONE)

    # -- client side ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def cancel(self):
        """Drop the sequence at the next step boundary (idempotent)."""
        self.cancelled = True

    def tokens(self):
        """Drain the stream to completion and return every token."""
        return list(self)

    @property
    def ttft_s(self):
        """Submit -> first token, or None before the first token."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit


class _GenRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "table", "stream",
                 "deadline", "generated", "last_token", "t_submit",
                 "t_last_emit", "tctx")

    def __init__(self, prompt, max_new, eos_id, table, stream, timeout):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.table = table
        self.stream = stream
        self.t_submit = stream.t_submit
        self.deadline = (self.t_submit + timeout) if timeout else None
        self.generated = 0
        self.last_token = None
        self.t_last_emit = None
        self.tctx = None

    @property
    def position(self):
        """Cache position the NEXT decode step writes (the last
        generated token's index in the full sequence)."""
        return len(self.prompt) + self.generated - 1


class DecodeEngine:
    """Continuous-batching autoregressive decode over a paged KV cache.

    Parameters
    ----------
    model : :class:`~.model.TinyGPT`-shaped spec (``prefill_kv`` /
        ``decode_logits`` / geometry attributes)
    params : flat name -> tensor dict, on ``device``
    prefill_buckets : prompt-length buckets (prefill runs at batch 1)
    decode_buckets : slot-count buckets; the largest is the
        concurrent-sequence bound
    block_size / num_blocks : :class:`~.kvcache.PagedKVCache` geometry
    max_queue : pending-request bound past which submits shed
    kv_dtype : cache dtype, ``"float32"`` or ``"bfloat16"``
    device : where the cache lives and the model runs (CUDA unless
        ``"cpu"``)
    compile_cache : count each warmed prefill and decode bucket as a
        compile-cache miss (``ModelRegistry(compile_cache=)``)
    cache : the JAX package's compile cache; any value but None turns
        ``compile_cache`` on (a CUDA graph has no portable serialized
        form to keep)
    """

    def __init__(self, model, params, prefill_buckets=None,
                 decode_buckets=None, block_size=None, num_blocks=None,
                 max_queue=None, label="generative", kv_dtype="float32",
                 device=None, compile_cache=False, cache=None):
        from ... import env as _env
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self._label = label
        self._compile_cache = bool(compile_cache) or cache is not None
        if prefill_buckets is None:
            prefill_buckets = _env_buckets(
                "MXNET_TPU_SERVING_PREFILL_BUCKETS")
        if decode_buckets is None:
            decode_buckets = _env_buckets(
                "MXNET_TPU_SERVING_DECODE_BUCKETS")
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in prefill_buckets)))
        self.decode_buckets = tuple(sorted(set(
            int(b) for b in decode_buckets)))
        if not self.prefill_buckets or self.prefill_buckets[0] < 1 \
                or not self.decode_buckets \
                or self.decode_buckets[0] < 1:
            raise MXNetError("decode engine: buckets must be positive "
                             "ints, got prefill=%r decode=%r"
                             % (prefill_buckets, decode_buckets))
        # buckets past the model's context can never run: keep those
        # that fit, plus one capped at max_seq so the longest
        # admissible prompt stays servable
        if self.prefill_buckets[-1] > model.max_seq:
            kept = tuple(b for b in self.prefill_buckets
                         if b < model.max_seq)
            self.prefill_buckets = kept + (int(model.max_seq),)
        block_size = int(block_size if block_size is not None
                         else _env.get("MXNET_TPU_SERVING_KV_BLOCK"))
        num_blocks = int(num_blocks if num_blocks is not None
                         else _env.get("MXNET_TPU_SERVING_KV_BLOCKS"))
        self.cache = PagedKVCache(model.num_layers, model.num_heads,
                                  model.head_dim, block_size,
                                  num_blocks, dtype=kv_dtype,
                                  device=self.device)
        # fixed block-table width: enough for the longest sequence the
        # model can hold
        self.max_blocks_per_seq = self.cache.blocks_for(model.max_seq)
        self.max_queue = int(max_queue if max_queue is not None
                             else _env.get("MXNET_TPU_SERVING_QUEUE"))
        self.max_slots = self.decode_buckets[-1]
        self.decode_steps = 0           # decode-step runs, warm-up included
        self._fingerprints = {}         # (kind, bucket) -> digest
        self._cond = _sync.Condition(name="serving.decode")
        self._pending = collections.deque()
        self._active = []
        self._closed = False
        self._drain = True
        self._drained_live = 0      # sequences in flight at close()
        self._thread = None
        self._owner = _capture.GraphOwner("DecodeEngine(%s)" % label,
                                          self.device)

    # -- the two programs -----------------------------------------------
    def capture_stats(self):
        """Graphs captured, seconds capturing, pool bytes, replays."""
        return self._owner.stats()

    def _program(self, kind, bucket, arrays, fn):
        """``fn`` over ``arrays`` (host int32 arrays) on the device:
        eagerly on the CPU and at a bucket's first run (on the card, on
        the capture stream); after that a replay of the bucket's graph,
        its static inputs refreshed by ``copy_``."""
        return self._owner.run((kind, bucket), fn,
                               [torch.from_numpy(a) for a in arrays],
                               what="%s bucket %d" % (kind, bucket))

    def _prefill_body(self, tokens, table, true_len):
        """The prefill program: tokens (1, bucket), table (max_blocks,)
        and true_len (1,) int32 tensors -> the first generated token,
        (1,).  The prompt's K/V go into the cache blocks in place;
        padded positions write the scratch block."""
        bs = self.cache.block_size
        logits, ks, vs = self.model.prefill_kv(self.params, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        blk = torch.where(pos < true_len, table.long()[pos // bs],
                          SCRATCH_BLOCK)
        off = pos % bs
        self.cache.keys[:, blk, off] = ks.to(self.cache.dtype)
        self.cache.values[:, blk, off] = vs.to(self.cache.dtype)
        last = logits[0].index_select(0, true_len.long() - 1)
        return last.argmax(dim=-1)

    def _run_prefill(self, tokens, table, true_len):
        """tokens (1, bucket) int32, table (max_blocks,) int32 -> first
        generated token.  The prompt's K/V go into the cache in place,
        inside the program."""
        first = self._program(
            "prefill", tokens.shape[1],
            [tokens, table.astype(np.int32),
             np.array([true_len], np.int32)], self._prefill_body)
        return int(first[0])

    def _run_decode(self, tokens, positions, tables):
        """One decode step over (bucket,) tokens/positions and
        (bucket, max_blocks) tables -> next token per slot."""
        self.decode_steps += 1
        out = self._program(
            "decode", tokens.shape[0], [tokens, positions, tables],
            lambda t, p, b: self.model.decode_logits(
                self.params, self.cache.keys, self.cache.values, t, p, b,
                self.cache.block_size)[0])
        return out.tolist()

    def _device_scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def warmup(self):
        """Run every prefill and decode bucket once on scratch-only
        tables (kernel build, library set-up) and, on the card, capture
        and replay its graph; returns the seconds it took.  Warm-up
        writes land in the scratch block only."""
        t0 = time.perf_counter()
        mb = self.max_blocks_per_seq
        scratch = np.full((mb,), SCRATCH_BLOCK, np.int32)
        runs = 2 if self._owner.cuda else 1
        with self._device_scope():
            if self._owner.cuda:
                # the paged-attention scratch of the largest bucket, made
                # before any capture on the engine's stream
                reserve_scratch(self._owner.device,
                                self._owner.stream.cuda_stream,
                                *scratch_sizes(
                                    self.max_slots, self.model.num_heads,
                                    self.model.head_dim, mb,
                                    self.cache.block_size))
            for b in self.prefill_buckets:
                for _ in range(runs):
                    self._run_prefill(np.zeros((1, b), np.int32), scratch,
                                      b)
            for s in self.decode_buckets:
                for _ in range(runs):
                    self._run_decode(
                        np.zeros((s,), np.int32), np.zeros((s,), np.int32),
                        np.full((s, mb), SCRATCH_BLOCK, np.int32))
        for kind, buckets, shapes in (
                ("prefill", self.prefill_buckets,
                 lambda b: [[1, b], [mb], [1]]),
                ("decode", self.decode_buckets,
                 lambda b: [[b], [b], [b, mb]])):
            for b in buckets:
                self._fingerprints[(kind, b)] = self._digest(kind,
                                                             shapes(b))
                if self._compile_cache and _telemetry._ENABLED:
                    _telemetry.hooks.serving_compile_cache(False)
        dt = time.perf_counter() - t0
        if _telemetry._ENABLED:
            _telemetry.hooks.serving_warmup(
                self._label, dt,
                len(self.prefill_buckets) + len(self.decode_buckets))
        return dt

    def _digest(self, kind, input_shapes):
        m = self.model
        doc = {"model": [type(m).__name__, m.vocab_size, m.units,
                         m.num_layers, m.num_heads, m.max_seq],
               "params": [[k, list(v.shape), str(v.dtype)]
                          for k, v in sorted(self.params.items())],
               "program": kind, "inputs": input_shapes,
               "cache": [self.cache.block_size, self.cache.num_blocks,
                         str(self.cache.dtype)],
               "backend": list(_capture._backend_flags()),
               "kernels": _build.library_names()}
        return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()
                              ).hexdigest()

    def _bucket(self, buckets, n, what):
        for b in buckets:
            if b >= n:
                return b
        raise MXNetError("decode engine: %s of %d exceeds the largest "
                         "%s bucket %d" % (what, n, what, buckets[-1]))

    # -- intake ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens, eos_id=None, timeout=None):
        """Admit one generation request; returns a
        :class:`GenerationStream`.

        The FULL ``prompt + max_new_tokens`` cache budget is allocated
        here: :class:`ServingQueueFull` is raised when the pending queue
        is at capacity or the KV cache cannot cover the budget, so an
        accepted request never fails for cache space mid-generation."""
        prompt = [int(t) for t in prompt]
        max_new = int(max_new_tokens)
        if not prompt or max_new < 1:
            raise MXNetError("generate needs a non-empty prompt and "
                             "max_new_tokens >= 1")
        if len(prompt) > self.prefill_buckets[-1]:
            raise MXNetError(
                "prompt of %d tokens exceeds the largest prefill "
                "bucket %d" % (len(prompt), self.prefill_buckets[-1]))
        total = len(prompt) + max_new
        if total > self.model.max_seq:
            raise MXNetError(
                "prompt + max_new_tokens = %d exceeds model max_seq %d"
                % (total, self.model.max_seq))
        with self._cond:
            if self._closed:
                raise ServableClosed("generative servable %r is closed"
                                     % self._label)
            if len(self._pending) >= self.max_queue:
                if _telemetry._ENABLED:
                    _telemetry.hooks.decode_shed(self._label, "queue")
                raise ServingQueueFull(
                    "generative servable %r pending queue full (%d)"
                    % (self._label, self.max_queue))
            try:
                table = self.cache.allocate(total)
            except KVCacheExhausted as e:
                if _telemetry._ENABLED:
                    _telemetry.hooks.decode_shed(self._label, "kvcache")
                raise ServingQueueFull(
                    "generative servable %r shed at admission: %s"
                    % (self._label, e)) from e
            stream = GenerationStream(self._label, len(prompt), max_new)
            req = _GenRequest(prompt, max_new, eos_id, table, stream,
                              timeout)
            if _obs._TRACE_ENABLED:
                req.tctx = _obs.trace.fresh_context()
            self._pending.append(req)
            depth = len(self._pending)
            self._cond.notify()
        if _telemetry._ENABLED:
            _telemetry.hooks.decode_request(self._label, depth)
        return stream

    # -- the loop -------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise MXNetError("DecodeEngine already started")
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name="mxtt-decode-%s" % self._label)
        self._thread.start()

    def _worker(self):
        with self._device_scope():
            while True:
                with self._cond:
                    while not self._pending and not self._active \
                            and not self._closed:
                        self._cond.wait(_IDLE_WAIT_S)
                    if self._closed:
                        if not self._drain:
                            self._abort_locked()
                            return
                        if not self._pending and not self._active:
                            return
                self._admit()
                if self._active:
                    self._step()

    def _abort_locked(self):
        """close(drain=False): resolve everything as closed and free
        every table -- every stream still ends explicitly."""
        err = ServableClosed("generative servable %r closed without "
                             "drain" % self._label)
        for req in list(self._pending) + self._active:
            self.cache.free(req.table)
            req.stream._finish("closed", error=err)
        self._pending.clear()
        del self._active[:]

    def _admit(self):
        """Step-boundary admission: pending requests take free slots in
        the RUNNING batch (one prefill each).  Expired or cancelled
        requests resolve here and never occupy a slot."""
        while True:
            with self._cond:
                if not self._pending \
                        or len(self._active) >= self.max_slots:
                    return
                req = self._pending.popleft()
            now = time.perf_counter()
            if req.stream.cancelled:
                self._finish(req, "cancel")
                continue
            if req.deadline is not None and now > req.deadline:
                self.cache.free(req.table)
                req.stream._finish("timeout", error=RequestTimeout(
                    "generation waited %.1fms > timeout while queued"
                    % (1e3 * (now - req.t_submit))))
                if _telemetry._ENABLED:
                    _telemetry.hooks.serving_timeout(self._label)
                continue
            self._prefill(req)

    def _prefill(self, req):
        bucket = self._bucket(self.prefill_buckets, len(req.prompt),
                              "prefill")
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :len(req.prompt)] = req.prompt
        table = self.cache.padded_table(req.table,
                                        self.max_blocks_per_seq)
        t0 = time.perf_counter()
        try:
            _chaos.fail_point("serving.decode.prefill",
                              model=self._label, bucket=bucket)
            first = self._run_prefill(tokens, table, len(req.prompt))
        except Exception as e:  # the loop must keep serving the others
            if _telemetry._ENABLED:
                _telemetry.hooks.serving_error(self._label)
            self.cache.free(req.table)
            req.stream._finish("error", error=e)
            return
        self.cache.note_tokens(req.table, len(req.prompt) + 1)
        now = time.perf_counter()
        if _telemetry._ENABLED:
            _telemetry.hooks.decode_prefill(self._label, bucket,
                                            len(req.prompt), now - t0)
            _telemetry.hooks.decode_ttft(now - req.t_submit)
        self._emit(req, first, t0, now)
        if not self._maybe_finish(req):
            self._active.append(req)

    def _step(self):
        """ONE decode iteration for every live slot."""
        n = len(self._active)
        bucket = self._bucket(self.decode_buckets, n, "decode")
        tokens = np.zeros((bucket,), np.int32)
        positions = np.zeros((bucket,), np.int32)
        tables = np.full((bucket, self.max_blocks_per_seq),
                         SCRATCH_BLOCK, np.int32)
        for i, req in enumerate(self._active):
            tokens[i] = req.last_token
            positions[i] = req.position
            tables[i] = self.cache.padded_table(
                req.table, self.max_blocks_per_seq)
        t0 = time.perf_counter()
        try:
            _chaos.fail_point("serving.decode.step", model=self._label,
                              occupancy=n, bucket=bucket)
            out = self._run_decode(tokens, positions, tables)
        except Exception as e:  # fail the batch, keep the loop alive
            if _telemetry._ENABLED:
                _telemetry.hooks.serving_error(self._label)
            for req in self._active:
                self.cache.free(req.table)
                req.stream._finish("error", error=e)
            del self._active[:]
            return
        now = time.perf_counter()
        if _telemetry._ENABLED:
            _telemetry.hooks.decode_step(self._label, n, bucket, now - t0)
        finished = []
        for i, req in enumerate(self._active):
            self._emit(req, out[i], t0, now)
            self.cache.note_tokens(req.table,
                                   len(req.prompt) + req.generated)
            if self._maybe_finish(req):
                finished.append(req)
        if finished:
            # finished sequences vacate their slot IMMEDIATELY: the
            # next iteration packs the survivors into a smaller bucket
            self._active = [r for r in self._active
                            if r not in finished]

    def _emit(self, req, token, t_step0, now):
        req.generated += 1
        req.last_token = token
        if _telemetry._ENABLED and req.t_last_emit is not None:
            _telemetry.hooks.decode_inter_token(now - req.t_last_emit)
        if _obs._TRACE_ENABLED and req.tctx is not None:
            _obs.record_span(
                "serving.decode_step", req.tctx.child(),
                parent_id=req.tctx.span_id, t0=t_step0,
                dur=now - t_step0,
                attrs={"model": self._label,
                       "token_index": req.generated - 1})
        req.t_last_emit = now
        req.stream._push(token, now)

    def _maybe_finish(self, req):
        if req.stream.cancelled:
            self._finish(req, "cancel")
            return True
        if req.eos_id is not None and req.last_token == req.eos_id:
            self._finish(req, "eos")
            return True
        if req.generated >= req.max_new:
            self._finish(req, "length")
            return True
        return False

    def _finish(self, req, reason):
        self.cache.free(req.table)
        now = time.perf_counter()
        if _obs._TRACE_ENABLED and req.tctx is not None:
            _obs.record_span(
                "serving.request", req.tctx, t0=req.t_submit,
                dur=now - req.t_submit,
                attrs={"model": self._label, "generative": True,
                       "tokens": req.generated, "reason": reason})
        if _telemetry._ENABLED:
            _telemetry.hooks.decode_finish(self._label, reason,
                                           req.generated)
            _telemetry.hooks.serving_latency(now - req.t_submit)
        req.stream._finish(reason)

    # -- introspection --------------------------------------------------
    def queue_depth(self):
        with self._cond:
            return len(self._pending)

    def active_sequences(self):
        """Sequences in the running decode batch."""
        with self._cond:
            return len(self._active)

    def live_sequences(self):
        """Sequences admitted and not finished: pending plus running."""
        with self._cond:
            return len(self._pending) + len(self._active)

    def fingerprint(self, kind, bucket):
        """The digest of what the ``kind`` (``"prefill"`` or
        ``"decode"``) program of ``bucket`` computes, or None before
        warm-up."""
        return self._fingerprints.get((kind, bucket))

    # -- lifecycle ------------------------------------------------------
    def close(self, drain=True):
        """Stop intake and shut the loop down.  ``drain=True`` keeps
        STEPPING until every admitted sequence runs to completion (the
        hot-swap path rides this); ``drain=False`` resolves everything
        as closed.  Returns the number of sequences that were in flight
        when close was called."""
        with self._cond:
            if self._closed:
                return 0
            self._closed = True
            self._drain = drain
            live = len(self._pending) + len(self._active)
            self._drained_live = live
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        return live

    @property
    def closed(self):
        return self._closed


class GenerativeServable:
    """One deployed generative model: a :class:`DecodeEngine` behind
    the registry's servable surface."""

    source = "generative"

    def __init__(self, name, engine):
        self.name = name
        self._engine = engine

    # -- client surface -------------------------------------------------
    def generate(self, prompt, max_new_tokens, eos_id=None,
                 timeout=None):
        """Stream greedy-decoded tokens for ``prompt``; returns a
        :class:`GenerationStream`."""
        return self._engine.submit(prompt, max_new_tokens,
                                   eos_id=eos_id, timeout=timeout)

    # -- introspection --------------------------------------------------
    @property
    def engine(self):
        return self._engine

    @property
    def buckets(self):
        return self._engine.decode_buckets

    @property
    def prefill_buckets(self):
        return self._engine.prefill_buckets

    def queue_depth(self):
        return self._engine.queue_depth()

    @property
    def queue_capacity(self):
        return self._engine.max_queue

    def kvcache_stats(self):
        return self._engine.cache.stats()

    @property
    def closed(self):
        return self._engine.closed

    def close(self, drain=True):
        return self._engine.close(drain=drain)

    def __repr__(self):
        return ("GenerativeServable(%r, prefill=%r, decode=%r, kv=%s)"
                % (self.name, self._engine.prefill_buckets,
                   self._engine.decode_buckets,
                   self._engine.cache.stats()))


class GenerativeWatcher(_RegistryWatcher):
    """The :class:`~mxnet_tpu_torch.serving.loop.RegistryWatcher`
    contract for generative servables: the same verified-step
    discovery and retry/backoff/failure-budget state machine, but a
    swap re-registers through ``register_generative`` -- the weights
    restored from the checkpoint's ``params`` item -- and the old engine
    drains its half-generated sequences to completion (zero dropped,
    counted under ``chaos.survived.serving.decode_swap``).  Extra
    keyword arguments go to ``register_generative`` (buckets, cache
    geometry, ``device``)."""

    def __init__(self, registry, name, checkpoint, model, **kwargs):
        # block/input_shape/dtype are fixed-shape-servable concepts; the
        # base class only threads them into register(), which
        # _register_step replaces wholesale
        super().__init__(registry, name, checkpoint, block=None,
                         input_shape=(), **kwargs)
        self.model = model

    def _register_step(self, step):
        self.registry.register_generative(
            self.name, model=self.model, checkpoint=self.manager,
            step=step, **self._register_kwargs)
