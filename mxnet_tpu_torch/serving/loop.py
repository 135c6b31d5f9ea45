"""The always-on loop: continuous training publishing checkpoints, and
a registry watcher hot-swapping the servable (counterpart of
``mxnet_tpu/serving/loop.py``).

- :class:`ContinuousTrainer` runs the training loop and **publishes**
  the (block, trainer) state every ``publish_every`` steps through
  ``CheckpointManager.save_training`` -- the atomic commit path, so a
  kill mid-publish can never tear what the watcher sees;
- :class:`RegistryWatcher` polls the checkpoint root, discovers a new
  **verified** step via ``CheckpointManager.latest_step()`` (the
  corruption-tolerant, quarantining discovery -- a torn newest step
  reads as "previous good step", which IS the rollback), and hot-swaps
  the servable by re-registering it: the new pool warms (its buckets
  captured as CUDA graphs on the card) while the old servable keeps
  serving, then the registry installs the new one and drains the old
  -- zero dropped (non-shed) requests across the swap.  Each servable
  reads its own copy of the weights, taken at its registration, so
  restoring the next step into the watcher's block never reaches the
  servable still draining.

A swap that aborts (chaos at ``serving.swap``, a raced retention delete,
a capture failure) retries with exponential backoff; a step that
exhausts its retries is marked bad and skipped -- the previous model
keeps serving -- and ``failure_budget`` consecutive failed steps suspend
the watcher with a warning.

The trainer ticks the ops plane as the JAX loop does: the process
goodput ledger once a step (``MXNET_TPU_OBS_GOODPUT=1``; each publish
marks its window publish-guarded, ``close()`` flushes the tail window),
the leak sentinel likewise (``MXNET_TPU_MEMORY_WATCH=1``), and the
``memory.leak`` chaos point before each step's forward.

One process: the JAX trainer beats a cross-process liveness lease each
step and can train past a publish aborted by a rank failure
(``on_publish_error="continue"``); both wait for the multi-device slice
(ROADMAP item 9), and a multi-process launch raises.
"""
from __future__ import annotations

import os
import threading
import time
import warnings

from .. import chaos as _chaos
from .. import obs as _obs
from ..analysis import memory as _memory
from .. import sync as _sync
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..checkpoint import CheckpointManager

__all__ = ["ContinuousTrainer", "RegistryWatcher"]


def _manager(checkpoint):
    return checkpoint if isinstance(checkpoint, CheckpointManager) \
        else CheckpointManager(checkpoint)


def _refuse_unported():
    """Raise for the part of the JAX loop the port does not have."""
    try:
        procs = int(os.environ.get("MXNET_TPU_NUM_PROCS", "1") or 1)
    except ValueError:
        procs = 1
    if procs > 1:
        raise MXNetError("ContinuousTrainer: a multi-process loop (its "
                         "liveness lease, rank-failure publishes) waits "
                         "for the multi-device slice, ROADMAP item 9")


class ContinuousTrainer:
    """Train continuously and publish checkpoints for a serving watcher.

    ::

        ct = ContinuousTrainer(net, trainer, loss_fn, batch_fn,
                               manager, publish_every=50)
        ct.resume()                # restore newest intact step, if any
        ct.start()                 # background loop (or run_steps(n))
        ...
        ct.close()

    ``data`` is either a fixed ``(x, y)`` pair or a callable
    ``step -> (x, y)``.  ``handler`` (a ``preemption.PreemptionHandler``)
    is polled at every loop boundary so SIGTERM lands a consistent save
    and stops the loop.  ``on_publish_error`` is the JAX package's
    policy for a publish aborted by a rank failure: ``"raise"`` or
    ``"continue"``; one process has no rank failures, so every publish
    error raises.
    """

    def __init__(self, block, trainer, loss_fn, data, manager,
                 publish_every=1, handler=None, on_publish_error="raise"):
        self.block = block
        self.trainer = trainer
        self.loss_fn = loss_fn
        self._data = data
        self.manager = _manager(manager)
        self.publish_every = int(publish_every)
        if self.publish_every < 1:
            raise MXNetError("ContinuousTrainer: publish_every must be "
                             ">= 1, got %r" % publish_every)
        if on_publish_error not in ("raise", "continue"):
            raise MXNetError("ContinuousTrainer: on_publish_error must "
                             "be 'raise' or 'continue', got %r"
                             % (on_publish_error,))
        _refuse_unported()
        self._on_publish_error = on_publish_error
        self.handler = handler
        self._lock = _sync.Lock(name="serving.train_loop")
        self._stop = _sync.Event(name="serving.train_loop.stop")
        self._thread = None
        self._step = 0
        self._published_step = None
        self._error = None
        _obs.status.register_trainer(self)   # weak: statusz heartbeat

    # -- state ----------------------------------------------------------
    @property
    def step(self):
        with self._lock:
            return self._step

    @property
    def published_step(self):
        with self._lock:
            return self._published_step

    def resume(self):
        """Restore the newest intact checkpoint (or start fresh);
        returns the Checkpoint or None.  The step counter continues
        from the restored step -- the crash-restart contract."""
        ckpt = self.manager.restore_training(self.block, self.trainer)
        with self._lock:
            self._step = ckpt.step if ckpt is not None else 0
            self._published_step = ckpt.step if ckpt is not None else None
        return ckpt

    # -- the loop -------------------------------------------------------
    def run_steps(self, n):
        """Run ``n`` training steps inline (the thread-free surface the
        scenarios and tests drive); publishes at every
        ``publish_every`` boundary.  Returns the last loss (or None if
        stopped before a step ran)."""
        from .. import autograd
        from ..analysis import numerics as _numerics
        last = None
        for _ in range(int(n)):
            if self._stop.is_set():
                break
            if self.handler is not None and self.handler.triggered:
                # the triggered read already wrote the preemption save
                break
            with self._lock:
                self._step += 1
                step = self._step
            sp = _obs.begin_span("train.step", step=step) \
                if _obs._TRACE_ENABLED else None
            try:
                x, y = self._data(step) if callable(self._data) \
                    else self._data
                # numerics.nonfinite chaos point: poison THIS batch so
                # the fault flows through forward/backward and the
                # sentinel (not the injector) must catch it
                box = {}
                _chaos.fail_point("numerics.nonfinite", box=box,
                                  step=step)
                # memory.leak chaos point: the armed action pins tensors
                # in a hidden list, so the LEAK SENTINEL (not the
                # injector) must catch the live-bytes growth
                _chaos.fail_point("memory.leak", step=step)
                if box.get("poison"):
                    x = _numerics.poison_nd(x)
                with autograd.record():
                    loss = self.loss_fn(self.block(x), y)
                loss.backward()
                if _numerics.check_enabled():
                    # ONE finite check over the named gradients; raises
                    # NonFiniteError naming the first offender BEFORE
                    # the optimizer applies the poisoned update
                    _numerics.finite_sentinel(
                        [(p.name, p._data.grad)
                         for p in self.trainer._params
                         if p._data is not None
                         and p._data.grad is not None],
                        step=step)
                self.trainer.step(x.shape[0])
                last = loss
                if step % self.publish_every == 0:
                    self.publish()
            finally:
                if sp is not None:
                    _obs.end_span(sp)
            if _obs._GOODPUT_ENABLED:
                # one ledger tick per training step: windows close at
                # the MXNET_TPU_OBS_GOODPUT_WINDOW boundary and the
                # attribution publishes through goodput.* instruments
                _obs.goodput.ledger().step()
            if _memory.watch_enabled():
                # one sentinel tick per step: censuses run only at
                # window boundaries, inside the sentinel
                _memory.sentinel().step()
            # liveness beat for statusz: a stale heartbeat means a
            # wedged loop even when every thread is alive
            _obs.status.heartbeat()
        return last

    def publish(self):
        """Checkpoint the current (block, trainer) state as the current
        step, through the atomic commit path."""
        with self._lock:
            step = self._step
        t0 = time.perf_counter()
        sp = _obs.begin_span("train.publish", step=step) \
            if _obs._TRACE_ENABLED else None
        try:
            self.manager.save_training(step, self.block, self.trainer,
                                       metadata={"step": step})
        finally:
            if sp is not None:
                _obs.end_span(sp)
        with self._lock:
            self._published_step = step
        if _obs._GOODPUT_ENABLED:
            # the ledger's publish guard: the checkpoint_stall spike
            # this window is expected work, not a regression
            _obs.goodput.ledger().note_publish()
        if _memory.watch_enabled():
            # same guard for the leak sentinel: the snapshot's
            # live-bytes spike is expected work, not a leak
            _memory.sentinel().note_publish()
        if _telemetry._ENABLED:
            _telemetry.hooks.train_publish(step, time.perf_counter() - t0)
        return step

    # -- lifecycle ------------------------------------------------------
    def start(self, max_steps=None):
        """Run the loop on a background thread until :meth:`stop` (or
        ``max_steps`` steps, or a preemption trigger)."""
        if self._thread is not None:
            raise MXNetError("ContinuousTrainer already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(max_steps,), daemon=True,
            name="mxtt-train-loop")
        self._thread.start()

    def _run(self, max_steps):
        try:
            if max_steps is not None:
                self.run_steps(max_steps)
            else:
                while not self._stop.is_set():
                    if self.run_steps(1) is None:
                        break           # preempted/stopped mid-boundary
        except Exception as e:          # surface at close(), not a dead
            with self._lock:            # daemon thread
                self._error = e

    def stop(self):
        self._stop.set()

    def close(self):
        """Stop the loop, join the thread, drain any in-flight async
        checkpoint write, and re-raise a loop error if one occurred."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self.manager.wait_until_finished()
        if _obs._GOODPUT_ENABLED:
            # close the partial tail window so a short run still
            # reports its attribution
            _obs.goodput.ledger().flush(reason="close")
        if _memory.watch_enabled():
            # close the sentinel's partial tail window too
            _memory.sentinel().flush()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err


class RegistryWatcher:
    """Watch a checkpoint root and hot-swap a servable to each new
    verified step.

    ::

        w = RegistryWatcher(reg, "model", ckpt_root, block,
                            input_shape=(8,), buckets=(1, 4))
        w.poll_once()          # or w.start() for the background loop
        ...
        w.close()

    Discovery reuses ``CheckpointManager.latest_step()``: manifest and
    CRC verification with quarantine, so a step torn by a killed
    trainer is renamed ``<step>.corrupt`` and the watcher keeps (or
    rolls back to) the previous verified step.  A swap re-registers the
    servable: the replacement warms while the old servable still
    serves, then the registry installs it and drains the old one -- no
    accepted request is dropped.  Swap failures retry with exponential
    backoff (``swap_retries``/``swap_backoff_s``); a step exhausting its
    retries is skipped (``bad_steps()``) and ``failure_budget``
    consecutive bad steps suspend the watcher.  Extra keyword arguments
    go to ``ModelRegistry.register`` (buckets, queue bounds).
    """

    def __init__(self, registry, name, checkpoint, block, input_shape,
                 dtype="float32", poll_s=None, swap_retries=None,
                 swap_backoff_s=None, failure_budget=None,
                 **register_kwargs):
        from .. import env as _env
        self.registry = registry
        self.name = name
        self.manager = _manager(checkpoint)
        self.block = block
        self.input_shape = tuple(input_shape)
        self.dtype = dtype
        self._register_kwargs = register_kwargs
        self.poll_s = float(poll_s if poll_s is not None
                            else _env.get("MXNET_TPU_SERVING_POLL_S"))
        self._swap_retries = int(
            swap_retries if swap_retries is not None
            else _env.get("MXNET_TPU_SERVING_SWAP_RETRIES"))
        self._swap_backoff_s = float(
            swap_backoff_s if swap_backoff_s is not None
            else _env.get("MXNET_TPU_SERVING_SWAP_BACKOFF_S"))
        self._failure_budget = int(
            failure_budget if failure_budget is not None
            else _env.get("MXNET_TPU_SERVING_SWAP_BUDGET"))
        self._lock = _sync.Lock(name="serving.watcher")
        self._stop = _sync.Event(name="serving.watcher.stop")
        self._thread = None
        self._served_step = None
        self._bad_steps = set()
        self._consecutive_failures = 0
        self._suspended = False
        _obs.status.register_watcher(self)   # weak: health readiness

    # -- state ----------------------------------------------------------
    @property
    def served_step(self):
        with self._lock:
            return self._served_step

    @property
    def suspended(self):
        """True once ``failure_budget`` consecutive steps failed to
        swap -- the watcher stops flapping and keeps serving the last
        good model until an operator intervenes."""
        with self._lock:
            return self._suspended

    def bad_steps(self):
        """Steps that exhausted their swap retries and are skipped."""
        with self._lock:
            return sorted(self._bad_steps)

    # -- one poll -------------------------------------------------------
    def poll_once(self):
        """Discover the newest verified step and swap to it if it is
        newer than what is serving.  Returns the newly served step, or
        None when nothing changed (no new step, step already bad, or
        the swap failed and the previous model keeps serving)."""
        sp = _obs.begin_span("serving.watcher.discover", model=self.name) \
            if _obs._TRACE_ENABLED else None
        step = None
        try:
            step = self.manager.latest_step()
        finally:
            if sp is not None:
                _obs.end_span(sp, step=step)
        if step is None:
            return None
        with self._lock:
            if self._suspended or step in self._bad_steps:
                return None
            served = self._served_step
        if served is not None and step <= served:
            return None
        return self._swap(step)

    def _swap(self, step):
        sp = _obs.begin_span("serving.swap", model=self.name, step=step) \
            if _obs._TRACE_ENABLED else None
        try:
            return self._swap_attempts(step)
        finally:
            if sp is not None:
                _obs.end_span(sp)

    def _register_step(self, step):
        """ONE registration attempt for ``step`` -- the overridable
        point subclasses (the generative watcher) replace to route a
        swap through a different registry surface while inheriting the
        whole retry/backoff/failure-budget state machine."""
        self.registry.register(
            self.name, block=self.block, checkpoint=self.manager,
            step=step, input_shape=self.input_shape,
            dtype=self.dtype, **self._register_kwargs)

    def _swap_attempts(self, step):
        t0 = time.perf_counter()
        attempts = self._swap_retries + 1
        last_err = None
        for attempt in range(1, attempts + 1):
            if attempt > 1:
                # exponential backoff, interruptible by close()
                if self._stop.wait(self._swap_backoff_s
                                   * (2 ** (attempt - 2))):
                    return None
            try:
                self._register_step(step)
            except Exception as e:  # noqa: BLE001 -- retried, then kept
                last_err = e
                if _telemetry._ENABLED:
                    _telemetry.hooks.serving_swap(
                        self.name, step, time.perf_counter() - t0,
                        ok=False, attempt=attempt, error=str(e))
                continue
            with self._lock:
                prev, self._served_step = self._served_step, step
                self._consecutive_failures = 0
            if _telemetry._ENABLED:
                _telemetry.hooks.serving_swap(
                    self.name, step, time.perf_counter() - t0, ok=True,
                    from_step=prev, attempt=attempt)
            if attempt > 1:
                _chaos.survived("serving.swap", "retry")
            return step
        # retries exhausted: skip this step, keep serving the previous
        # verified one (the failure-budget rollback contract)
        with self._lock:
            self._bad_steps.add(step)
            self._consecutive_failures += 1
            exhausted = self._consecutive_failures >= self._failure_budget
            if exhausted:
                self._suspended = True
            served = self._served_step
        _chaos.survived("serving.swap", "rollback")
        if exhausted and _telemetry._ENABLED:
            # terminal, alertable: nothing retries until an operator
            # acts, and health() reports NOT_READY off the same state
            _telemetry.hooks.serving_watcher_suspended(
                self.name, step, self._failure_budget)
        warnings.warn(
            "serving watcher %r: swap to step %d failed after %d "
            "attempt(s) (%s); still serving step %r%s"
            % (self.name, step, attempts, last_err, served,
               "; failure budget exhausted, watcher suspended"
               if exhausted else ""),
            RuntimeWarning, stacklevel=3)
        return None

    # -- lifecycle ------------------------------------------------------
    def start(self):
        """Poll on a background thread every ``poll_s`` seconds until
        :meth:`close` (or suspension by the failure budget)."""
        if self._thread is not None:
            raise MXNetError("RegistryWatcher already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name="mxtt-watcher-%s" % self.name)
        self._thread.start()

    def _watch(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 -- discovery outlives
                warnings.warn("serving watcher %r: poll failed: %s"
                              % (self.name, e), RuntimeWarning)
            if self.suspended:
                return
            self._stop.wait(self.poll_s)

    def close(self):
        """Stop polling and join the watcher thread (the servable stays
        registered; close it through the registry)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
