"""Preemption-aware checkpointing (counterpart of
``mxnet_tpu/preemption.py``).

Maintenance events and schedulers deliver SIGTERM with a grace window
before they take the card away.  ``install()`` arms a handler that,
on signal, marks ``handler.triggered``; the checkpoint (model parameters
plus optimizer state) is written at the training loop's next *read* of
``handler.triggered`` -- a loop boundary, so the save can never observe
a torn, mid-``trainer.step()`` state the way an arbitrary-bytecode
signal-path save could.  Loops that cannot poll can opt into the
immediate in-handler save with ``save_in_handler=True``.  ``resume()``
restores everything on restart.

Checkpoint layout: ``<prefix>-preempt.params`` (block parameters) and
``<prefix>-preempt.states`` (Trainer/updater state), plus
``<prefix>-preempt.meta`` (JSON with the step counter AND the byte
size + CRC32 of each committed file).  File commits go through the
shared atomic helper (``checkpoint.core.commit``); ``resume()``
verifies the data files against the meta's checksums, so a checkpoint
that bit-rotted (or was half-overwritten by an even older writer)
reads as "no checkpoint" instead of loading garbage.

A second SIGTERM delivered while the first one's save is on the stack
is suppressed (``preemption.reentrant_signals``,
``chaos.survived.preemption.signal``), so it cannot start a second
commit inside the first; the ``preemption.signal`` chaos fail point sits
in the handler, after the handler marks and msyncs the flight recorder
(``obs.flight.emergency_dump``), as the JAX package does.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import warnings

from . import chaos as _chaos
from . import sync as _sync
from . import telemetry as _telemetry
from .base import MXNetError
from .checkpoint import core as _ckpt

__all__ = ["PreemptionHandler", "install", "resume"]


class PreemptionHandler:
    """Arm signal-triggered checkpointing for a training loop.

    Usage::

        handler = preemption.install(prefix, net, trainer)
        for epoch in range(...):
            for batch in data:
                if handler.triggered:      # checkpoint already written
                    return
                step(...)
    """

    def __init__(self, prefix, block, trainer=None,
                 signals=(signal.SIGTERM,), extra_state=None,
                 save_in_handler=False, fallback_after=20.0):
        self.prefix = prefix
        self.block = block
        self.trainer = trainer
        self.extra_state = extra_state or {}
        self.saved = False
        self.save_in_handler = save_in_handler
        # Deferred saves rely on the loop polling ``triggered``; a loop
        # blocked in a long dispatch would otherwise reach SIGKILL with
        # nothing written.  The fallback timer fires a last-resort save
        # after ``fallback_after`` seconds (None disables) -- possibly
        # mid-step, so it is PROVISIONAL: it does not set ``saved``, and
        # a later consistent boundary save overwrites it.
        self.fallback_after = fallback_after
        self._fallback_timer = None
        self._fallback_saved = False
        self._signal_seen = False
        self._saving = False
        self._in_handler = False
        # RLock: the SIGTERM handler runs on the same thread and may
        # interrupt an explicit save_now() call mid-save
        self._lock = _sync.RLock(name="preemption.handler")
        # a previous incarnation killed between write_fn(tmp) and
        # os.replace strands its temp forever; clean house on arm
        _ckpt.sweep_stale_tmps(os.path.dirname(self.prefix) or ".",
                               prefix=os.path.basename(self.prefix))
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)

    @property
    def triggered(self):
        """True once a preemption signal arrived.  Reading this at the
        loop boundary is what performs the (deferred) checkpoint write:
        the state is guaranteed consistent there, unlike inside the
        signal handler which may fire mid ``trainer.step()``."""
        if self._signal_seen and not self.saved:
            self.save_now()
        return self._signal_seen

    # -- paths ---------------------------------------------------------
    @property
    def params_path(self):
        return self.prefix + "-preempt.params"

    @property
    def states_path(self):
        return self.prefix + "-preempt.states"

    @property
    def meta_path(self):
        return self.prefix + "-preempt.meta"

    # -- save ----------------------------------------------------------
    def save_now(self, step=None, provisional=False):
        """Drain pending device work and write the checkpoint.  Safe to
        call directly (e.g. at epoch boundaries) as well as from the
        signal path.

        ``provisional=True`` (the fallback timer's mode) marks a save
        that may have caught a mid-step state: it is written, but it
        does NOT set ``saved``, so the next boundary-triggered save
        re-saves a consistent snapshot over it.

        Files are written to temp paths and renamed into place, with
        the meta file LAST -- ``resume`` gates on the meta file, so a
        SIGKILL at grace-window expiry can never leave a checkpoint
        that loads truncated."""
        from .ndarray import waitall
        with self._lock:
            if self.saved or self._saving:
                return
            if provisional and self._fallback_saved:
                return
            self._saving = True    # re-entrancy: signal during save
            try:
                # the drain deliberately runs under the handler lock:
                # the lock is re-entered only by the SIGTERM handler on
                # THIS thread (RLock), never contended across threads,
                # and the saved state must not advance past the drain
                waitall()  # mxlint: disable=blocking-under-lock
                if self._fallback_saved and not provisional:
                    # re-arm the meta-last atomicity gate before
                    # overwriting a provisional checkpoint: otherwise a
                    # SIGKILL mid-re-save could leave NEW params beside
                    # the OLD provisional states/meta, and resume()
                    # (which trusts the meta file) would load a
                    # mismatched pair.  Runs AFTER waitall so a device
                    # error cannot destroy the provisional checkpoint
                    # before the re-save even starts -- and clearing
                    # _fallback_saved lets the fallback path rewrite a
                    # checkpoint if THIS save fails partway.
                    self._fallback_saved = False
                    try:
                        os.remove(self.meta_path)
                    except FileNotFoundError:
                        pass

                # shared atomic commit (tmp+fsync+rename) from the
                # checkpoint subsystem; each commit's digest feeds the
                # meta manifest that resume() verifies against
                files = {}

                def record(path, digest):
                    files[os.path.basename(path)] = {
                        "bytes": digest[0], "crc32": digest[1]}

                record(self.params_path,
                       _ckpt.commit(self.params_path,
                                    self.block.save_parameters))
                if self.trainer is not None:
                    record(self.states_path,
                           _ckpt.atomic_write_bytes(
                               self.states_path,
                               self.trainer.get_states()))
                meta = {"step": step, "extra": self.extra_state,
                        "format_version": _ckpt.FORMAT_VERSION,
                        "files": files}

                def write_meta(tmp):
                    with open(tmp, "w") as f:
                        json.dump(meta, f)
                _ckpt.commit(self.meta_path, write_meta)
                # only now: a failed write above leaves saved False so a
                # later signal/save_now retries instead of silently
                # skipping the one job this class has.  A provisional
                # (possibly torn) fallback save never sets saved -- only
                # a boundary save ends the retry loop.
                if provisional:
                    self._fallback_saved = True
                else:
                    self.saved = True
                if _telemetry._ENABLED:
                    _telemetry.hooks.checkpoint(
                        "save", prefix=self.prefix, step=step,
                        provisional=bool(provisional),
                        signal_triggered=self._signal_seen)
            finally:
                self._saving = False

    def _on_signal(self, signum, frame):
        # Re-entrancy guard: Python delivers a second SIGTERM by
        # running this handler NESTED on the same thread, at an
        # arbitrary bytecode boundary -- possibly while save_now() is
        # mid-commit (save_in_handler, or a signal landing during the
        # boundary save that a `triggered` read started).  Without the
        # guard the nested handler would re-enter save_now through the
        # RLock and interleave a second commit into the first one's
        # tmp-file dance, tearing the provisional save with its own
        # handler.  A re-entrant delivery only records the signal; the
        # outer save already in flight is the one that lands.
        if self._in_handler or self._saving:
            self._signal_seen = True
            if _telemetry._ENABLED:
                _telemetry.hooks.preemption_reentry()
            _chaos.survived("preemption.signal", "reentrant-suppressed")
            return
        self._in_handler = True
        try:
            self._signal_seen = True
            # black box: the preemption is exactly the death a flight
            # recorder exists for -- mark it (with the in-flight trace)
            # and msync so the final seconds survive the SIGKILL that
            # follows the grace window
            from . import obs as _obs
            _obs.flight.emergency_dump("preemption.signal",
                                       signum=signum, prefix=self.prefix)
            # chaos: a rule here can deliver a nested signal (callable
            # action invoking _on_signal again) or stall the handler --
            # how tests prove the guard above holds
            _chaos.fail_point("preemption.signal", signum=signum,
                              handler=self)
            if self.save_in_handler:
                self.save_now()
            elif self.fallback_after is not None \
                    and self._fallback_timer is None:
                t = threading.Timer(self.fallback_after, self.save_now,
                                    kwargs={"provisional": True})
                t.daemon = True
                t.start()
                self._fallback_timer = t
        finally:
            self._in_handler = False
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev if prev is not None
                          else signal.SIG_DFL)
        self._prev = {}
        if self._fallback_timer is not None:
            self._fallback_timer.cancel()
            self._fallback_timer = None


def install(prefix=None, block=None, trainer=None,
            signals=(signal.SIGTERM,), extra_state=None,
            save_in_handler=False):
    """Arm SIGTERM-triggered checkpointing; returns the handler.

    With ``prefix=None`` the prefix comes from the
    ``MXNET_CHECKPOINT_ON_SIGTERM`` env var (operator-armed jobs)."""
    if prefix is None:
        from . import env as _env
        prefix = _env.get("MXNET_CHECKPOINT_ON_SIGTERM")
        if not prefix:
            raise MXNetError("preemption.install: no prefix given and "
                             "MXNET_CHECKPOINT_ON_SIGTERM is unset")
    if block is None:
        raise MXNetError("preemption.install needs the block to save")
    return PreemptionHandler(prefix, block, trainer, signals=signals,
                             extra_state=extra_state,
                             save_in_handler=save_in_handler)


def resume(prefix, block, trainer=None, ctx=None):
    """Restore a preemption checkpoint if one exists.

    Returns the saved meta dict (``{"step": ..., "extra": ...}``) or
    None when no checkpoint is present (fresh start).
    """
    params = prefix + "-preempt.params"
    states = prefix + "-preempt.states"
    meta_path = prefix + "-preempt.meta"
    # the meta file commits LAST in save_now: its presence proves the
    # whole checkpoint landed...
    if not os.path.exists(meta_path) or not os.path.exists(params):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except ValueError:
        warnings.warn("preemption meta %s is not valid JSON; treating "
                      "as no checkpoint" % meta_path, RuntimeWarning)
        return None
    # ...and its checksums prove the files are the SAME bytes that were
    # committed -- presence alone can't catch bit-rot or a stale params
    # file beside a newer meta.  Metas from before the checkpoint
    # subsystem carry no digests; those keep the legacy presence check.
    files = meta.get("files")
    if files:
        problems = _ckpt.verify_files(os.path.dirname(prefix) or ".",
                                      files)
        if problems:
            warnings.warn(
                "preemption checkpoint %s failed verification (%s); "
                "treating as no checkpoint" % (prefix,
                                               "; ".join(problems)),
                RuntimeWarning)
            return None
    block.load_parameters(params, ctx=ctx)
    if trainer is not None and os.path.exists(states):
        trainer.load_states(states)
    if _telemetry._ENABLED:
        _telemetry.hooks.checkpoint("restore", prefix=prefix,
                                    step=meta.get("step"))
    return meta
