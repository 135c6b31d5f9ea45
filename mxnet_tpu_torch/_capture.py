"""Shape-keyed CUDA-graph capture and replay: the port's counterpart of
the JAX package's compiled programs.

The JAX package compiles each of its hot paths: a hybridized block's
shape-keyed ``jax.jit`` cache, ``TrainStep``'s donated step program, one
executable per serving bucket, one program per decode bucket.  On a
CUDA card the counterpart of a compiled, shape-specialized program is a
captured CUDA graph that is replayed: one launch for the whole program
and no Python per op.  A :class:`GraphOwner` is what each such owner
keeps:

- one side stream and one memory pool, shared by the owner's graphs
  (``CUDAGraph.capture_begin(pool=)``).  Graphs of one pool may reuse
  each other's scratch memory, so an owner reads a graph's outputs
  before it replays another of its graphs; a graph whose results must
  outlive the owner's next replay (a forward whose activations wait
  for a backward) gets a pool of its own (:meth:`GraphOwner.new_pool`);
- :meth:`GraphOwner.run` is the keyed cache: a key's first call runs
  eagerly (:meth:`GraphOwner.warm`, on the side stream: cuDNN's
  algorithm choice, the kernels' build and the allocator's growth
  happen there, before any capture, on the stream that captures); its
  second captures the body over static copies of its inputs; every
  later call copies its inputs into them, replays the graph and
  returns copies of its outputs;
- :meth:`GraphOwner.capture` records a body into a :class:`Graph` with
  the port's generator of the device registered (each replay draws new
  dropout masks) and the kernels' launches tallied
  (:func:`~.kernels.registry.counting_into`).  A host read inside the
  region (``.item()``, a copy from pageable memory) fails the capture,
  and the capture raises;
- a :class:`Graph` keeps the ``data_ptr`` of every tensor it reads that
  a user may rebind (parameters, optimizer state): :meth:`Graph.stale`
  tells its owner to capture again after ``load_parameters``,
  ``restore_training`` or ``cast`` put a new tensor in its place, or
  after the backend settings that choose the kernels at capture
  (cuDNN's ``deterministic``, ``benchmark`` and TF32 flags, the matmul
  TF32 flag) changed.

There is no eager fallback on the card: a capture that fails raises
:class:`~.base.MXNetError` naming the owner, the key and what broke.
On the CPU there are no graphs: an owner's cache entry is its eager
call, under the same key.

:func:`checking_syncs` runs every capture and replay under
``torch.cuda.set_sync_debug_mode("error")``: the card's tests and
``chip_smoke.py`` use it to show that no host read is left in a
captured region.  The mode is PyTorch's and process-wide, so it is off
unless asked for: a server's other threads read results on the host
while a graph replays.

While a body is warmed or captured (:func:`in_body`), hybridized blocks
inside it run their plain forward, as the JAX package traces a
hybridized child into its parent's program.

A key's warm-up and capture are the port's counterpart of a compile:
every owner adds their walls to ``build_s``, and with telemetry on an
owner given a ``site`` (the owners whose JAX counterparts report their
compiles: the hybridize cache, ``TrainStep``) makes each a ``compile``
event and a ``compile.build_time`` sample (the goodput ledger's
recompile category).  With ``mx.profiling`` on, a warm-up
given a ``profile`` is walked into the key's CostReport
(:func:`~.profiling.capture_jit`): the eager run is the only one a
dispatch-mode walk can see.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from collections import Counter

import torch

from . import profiling as _profiling
from . import random as _random
from . import telemetry as _telemetry
from .base import MXNetError
from .kernels import registry

__all__ = ["Graph", "GraphOwner", "checking_syncs", "in_body",
           "release_collective_graphs"]

_local = threading.local()
# the live graphs that recorded a mesh's collectives (NCCL kernels of a
# process group): a world's teardown frees them first
_collective_graphs = weakref.WeakSet()
_capture_lock = threading.RLock()
_sync_lock = threading.Lock()
_checks = {"syncs": 0}


def in_body():
    """Whether this thread is running an owner's warmed or captured
    body."""
    return getattr(_local, "depth", 0) > 0


def release_collective_graphs():
    """Free every live graph that recorded a mesh's collectives
    (``CUDAGraph.reset``), after the card has finished their replays:
    :mod:`mxnet_tpu_torch.distributed` calls it as the world shuts down,
    before its process groups are destroyed.  A rank of a four-card
    world whose captured step was still referenced at interpreter exit
    never exited (NVIDIA H100, NCCL 2.28.9); with its graphs freed first,
    the world exits.  Returns how many graphs it freed."""
    graphs = list(_collective_graphs)
    if graphs:
        torch.cuda.synchronize()
        for g in graphs:
            g.reset()
    _collective_graphs.clear()
    return len(graphs)


def synchronize(device=None):
    """``torch.cuda.synchronize(device)`` once no other thread of this
    process is capturing a graph: a device-wide wait on a capturing
    stream fails the wait and the capture, so it takes the capture lock
    first (a capture holds it; the always-on loop's trainer publishes
    while its watcher captures a servable)."""
    with _capture_lock:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def body_scope():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


@contextlib.contextmanager
def checking_syncs():
    """Within the scope every capture and replay, in any thread, runs
    under ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing
    CUDA call there raises.  The mode is process-wide while a capture or
    replay runs, so a synchronizing call in another thread raises too:
    a check for runs that do one thing at a time."""
    with _sync_lock:
        _checks["syncs"] += 1
    try:
        yield
    finally:
        with _sync_lock:
            _checks["syncs"] -= 1


@contextlib.contextmanager
def _sync_checked():
    if not _checks["syncs"]:
        yield
        return
    with _sync_lock:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _backend_flags():
    """The settings a capture bakes into its choice of kernels."""
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _fingerprint(tensors):
    """The ``data_ptr`` and ``requires_grad`` of each tensor (None for a
    missing one)."""
    return tuple(None if t is None else (t.data_ptr(), t.requires_grad)
                 for t in tensors)


def _copies(out):
    """``out`` with each tensor in it (through tuples and lists)
    cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_copies(o) for o in out)
    return out


class Graph:
    """One captured CUDA graph and the kernel launches it recorded."""

    __slots__ = ("graph", "launches", "ptrs", "flags", "owner")

    def __init__(self, graph, launches, ptrs, owner):
        self.graph = graph
        self.launches = launches
        self.ptrs = ptrs
        self.flags = _backend_flags()
        self.owner = owner

    def stale(self, watched):
        """Whether a watched tensor is no longer the one captured, or
        the backend settings changed since capture."""
        return _fingerprint(watched) != self.ptrs \
            or _backend_flags() != self.flags

    def replay(self):
        """Launch the graph on the current stream and count the kernel
        launches it makes."""
        with _sync_checked():
            self.graph.replay()
        self.owner.replays += 1
        registry.add_launches(self.launches)


class _Entry:
    """A key's captured graph, its static inputs and its outputs."""

    __slots__ = ("graph", "inputs", "outputs")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs


class GraphOwner:
    """The graphs of one owner (a hybridized block, a ``TrainStep``, a
    bucket pool, a decode engine) on one device: a side stream, a
    memory pool, the keys it has run and counts (graphs captured,
    seconds capturing, bytes the card's reserved memory grew by while
    capturing, replays)."""

    def __init__(self, name, device, site=None):
        self.name = name
        self.site = site
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = None
        self._pool = None
        self._seen = {}          # key -> None, in the order first run
        self._entries = {}       # key -> _Entry
        self.graphs = 0
        self.capture_s = 0.0
        self.build_s = 0.0       # warm-ups and captures, in seconds
        self.pool_bytes = 0
        self.replays = 0
        # agree(err): called after each capture with its error (None
        # when it succeeded); a mesh's step raises there for a peer's
        self.agree = None

    @property
    def cuda(self):
        return self.device.type == "cuda"

    @property
    def stream(self):
        """The side stream the owner warms and captures on (made at
        first use, with the owner's pool)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    @staticmethod
    def new_pool():
        """A memory pool of its own, for a graph whose results must
        outlive the replays of the owner's other graphs."""
        return torch.cuda.graph_pool_handle()

    def keys(self):
        """The keys run so far, in the order of their first call."""
        return list(self._seen)

    def captured_keys(self):
        """The keys whose graph is captured."""
        return list(self._entries)

    def is_new(self, key):
        """Whether ``key`` has not been run yet."""
        return key not in self._seen

    def first_call(self, key):
        """Record a call of ``key``; whether it is to run eagerly: on
        the CPU always, on the card the key's first call."""
        seen = key in self._seen
        self._seen[key] = None
        return not (self.cuda and seen)

    @contextlib.contextmanager
    def _on_side_stream(self):
        side = self.stream
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                yield side
        finally:
            cur.wait_stream(side)

    def _compiled(self, stage, t0):
        """Account one warm-up or capture that began at ``t0``."""
        dt = time.perf_counter() - t0
        self.build_s += dt
        if self.site is not None and _telemetry._ENABLED:
            _telemetry.hooks.compile_event(
                self.site, seconds=dt, retrace=len(self._seen) > 1,
                owner=self.name, stage=stage)

    def warm(self, fn, profile=None, build=True):
        """``fn()``, the owner's eager call: on the card, on the side
        stream that captures.  ``profile`` is ``(label, kind, key,
        arguments)``: with ``mx.profiling`` on, the call is walked into
        that key's CostReport.  ``build`` says the call is a key's first
        (on the CPU every call is eager; only the first builds)."""
        if profile is not None and _profiling._ENABLED:
            label, kind, pkey, arguments = profile
            call = fn

            def fn():
                return _profiling.capture_jit(
                    label, call, key=pkey, kind=kind, arguments=arguments,
                    owner=self if self.cuda else None, device=self.device)
        t0 = time.perf_counter()
        with body_scope():
            if not self.cuda:
                out = fn()
            else:
                with self._on_side_stream():
                    out = fn()
        if build:
            self._compiled("warm", t0)
        return out

    def run(self, key, fn, inputs, watched=(), what=None, profile=None):
        """``fn(*inputs)`` through ``key``'s entry: eagerly on the CPU
        and at the key's first call (:meth:`warm`); on the card, at its
        second call captured over static copies of ``inputs`` (again
        whenever a ``watched`` tensor was rebound), and from then on
        replayed after ``inputs`` are copied into those copies.  The
        inputs may lie on the host.  Returns ``fn``'s result; from a
        replay, copies of the graph's outputs, which the owner's next
        replay does not overwrite.  ``profile`` is :meth:`warm`'s."""
        new = self.is_new(key)
        if self.first_call(key):
            return self.warm(lambda: fn(*[t.to(self.device)
                                          for t in inputs]), profile, new)
        entry = self._entries.get(key)
        if entry is None or entry.graph.stale(watched):
            with torch.no_grad():
                static = [torch.empty_like(t, device=self.device).copy_(t)
                          for t in inputs]
            graph, out = self.capture(lambda: fn(*static),
                                      what or repr(key), watched)
            self._entries[key] = entry = _Entry(graph, static, out)
        else:
            with torch.no_grad():
                for s, t in zip(entry.inputs, inputs):
                    s.copy_(t)
        entry.graph.replay()
        with torch.no_grad():
            return _copies(entry.outputs)

    def capture(self, fn, what, watched=(), pool=None):
        """Capture ``fn()`` into a :class:`Graph`, in ``pool`` (by
        default the owner's); returns ``(graph, fn's result)``, whose
        tensors the graph's replays write.  The body does not run: a
        replay runs it.  ``watched`` are the tensors whose rebinding
        makes the graph stale."""
        if not self.cuda:
            raise MXNetError("%s: no CUDA graphs on %s" % (self.name,
                                                           self.device))
        t0 = time.perf_counter()
        # as torch.cuda.graph does: what the eager warm-up left cached
        # goes back to the card, so the graph's pool can take it (under
        # the capture lock: neither waits on another thread's capture)
        with _capture_lock:
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
        with _capture_lock, self._on_side_stream():
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(_random.generator(self.device))
            tally = Counter()
            err = out = None
            with registry.counting_into(tally), _sync_checked(), \
                    body_scope():
                graph.capture_begin(pool=pool or self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                except Exception as e:      # reported below, once
                    err = e
                finally:
                    try:
                        graph.capture_end()
                    except Exception as e:  # the body's error comes first
                        err = err or e
            if any(name not in registry.KERNELS for name, _d in tally):
                # a collective (a registered counter, not a hand kernel)
                _collective_graphs.add(graph)
            if self.agree is not None:
                # the ranks of a mesh agree on the outcome before any
                # replays: a peer's failure raises here, named
                self.agree(err)
            if err is not None:
                raise MXNetError(
                    "%s: CUDA-graph capture of %s failed (no eager "
                    "fallback on the card): %s: %s"
                    % (self.name, what, type(err).__name__, err)) from err
            self.pool_bytes += torch.cuda.memory_reserved(self.device) \
                - reserved
        self.graphs += 1
        self.capture_s += time.perf_counter() - t0
        self._compiled("capture", t0)
        return Graph(graph, tally, _fingerprint(watched), self), out

    def stats(self):
        return {"graphs": self.graphs, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "keys": self.keys()}
