"""Crash-safe flight recorder: the black box an operator reads AFTER
the process died (counterpart of ``mxnet_tpu/obs/flight.py``; the ring
file is byte for byte the JAX package's, so a file written by either
package reads in the other).

A bounded circular byte ring of the most recent telemetry records
(event emits, timer samples, spans) lives in an **mmap'd file**:
every write lands in the page cache immediately, so the bytes survive
``os._exit`` (the chaos KILL), SIGKILL at grace-window expiry, and any
Python-level crash -- no atexit, no flush() discipline required.  Only
losing the whole machine loses the ring.

Layout: a fixed 32-byte header (magic, data capacity, write position,
total bytes ever written) followed by ``capacity`` data bytes holding
newline-delimited JSON records written circularly.  The file is
*created* through the checkpoint subsystem's atomic
:func:`~mxnet_tpu_torch.checkpoint.core.commit` helper, so a reader can never
observe a half-initialized ring; after creation all writes go through
the mmap.  A record torn by a crash between the payload write and the
header update parses as garbage on exactly one line and is skipped by
:func:`read` -- the same corruption-tolerance posture as checkpoint
discovery.

The recorder attaches to the telemetry registry as a sink (it receives
every streamed record) and is dumped -- final marker event + msync --
automatically from three death paths:

- the **preemption handler** (SIGTERM landed);
- the **chaos KILL** action (``os._exit(137)`` mid-fault-injection);
- a ``faulthandler``-style **SIGUSR2** hook that snapshots every
  thread's stack into the ring on demand (wedged-process postmortem
  without killing it).

Render with ``mxtelemetry blackbox <file>``.
"""
from __future__ import annotations

import json
import mmap
import os
import signal
import struct
import sys
import threading
import time
import traceback

from .. import sync as _sync
from ..base import MXNetError

__all__ = ["FlightRecorder", "install", "installed", "uninstall",
           "note", "emergency_dump", "read", "DEFAULT_CAPACITY"]

_MAGIC = b"MXBBOX1\n"
# header: magic(8s) capacity(Q) write_pos(Q) total_written(Q)
_HEADER = struct.Struct("<8sQQQ")
HEADER_SIZE = _HEADER.size          # 32
DEFAULT_CAPACITY = 256 * 1024


def _json_default(obj):
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


class FlightRecorder:
    """One process's bounded crash-surviving record ring.

    Implements the telemetry sink protocol (``write(record)``), so
    attaching it to the registry makes every streamed event/sample/span
    part of the post-mortem record.
    """

    def __init__(self, path, capacity=None):
        if capacity is None:
            from .. import env as _env
            capacity = int(_env.get("MXNET_TPU_OBS_BLACKBOX_KB")) * 1024
        if capacity < 4096:
            raise MXNetError("flight recorder capacity %d too small "
                             "(min 4096 bytes)" % capacity)
        self.path = os.fspath(path)
        self.capacity = int(capacity)
        self._lock = _sync.Lock(name="obs.flight")
        self._closed = False
        # atomic creation: a fresh zeroed ring + header lands via the
        # checkpoint commit helper, so no reader ever sees a torn file
        from ..checkpoint import core as _ckpt

        def _init(tmp):
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(_MAGIC, self.capacity, 0, 0))
                f.truncate(HEADER_SIZE + self.capacity)
        _ckpt.commit(self.path, _init)
        self._f = open(self.path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(),
                             HEADER_SIZE + self.capacity)
        self._pos = 0
        self._total = 0

    # -- sink protocol --------------------------------------------------
    def write(self, record):
        """Append one telemetry record (dict) to the ring."""
        try:
            line = json.dumps(record, default=_json_default)
        except Exception:
            return
        self._append((line + "\n").encode("utf-8", "replace"))

    def flush(self):
        self.sync()

    # -- direct notes ---------------------------------------------------
    def note(self, name, **payload):
        """Record an operator-facing marker event directly (bypasses
        telemetry entirely -- death paths must record even in a run
        that never enabled instrumentation)."""
        self.write({"kind": "event", "name": name, "t": time.time(),
                    "payload": payload})

    # -- ring mechanics -------------------------------------------------
    def _append(self, data):
        if len(data) > self.capacity:
            data = data[-self.capacity:]
        with self._lock:
            if self._closed:
                return
            pos = self._pos
            end = pos + len(data)
            if end <= self.capacity:
                self._mm[HEADER_SIZE + pos:HEADER_SIZE + end] = data
            else:
                head = self.capacity - pos
                self._mm[HEADER_SIZE + pos:HEADER_SIZE
                         + self.capacity] = data[:head]
                self._mm[HEADER_SIZE:HEADER_SIZE
                         + (end - self.capacity)] = data[head:]
            self._pos = end % self.capacity
            self._total += len(data)
            # header LAST: a crash mid-payload leaves the previous
            # header, and the overwritten bytes read as one torn line
            _HEADER.pack_into(self._mm, 0, _MAGIC, self.capacity,
                              self._pos, self._total)

    def sync(self):
        """msync the ring to storage (belt-and-braces: the page cache
        already survives process death; this survives power loss of
        everything but the disk)."""
        with self._lock:
            if not self._closed:
                self._mm.flush()

    def records(self):
        """Parse this recorder's own ring (tests/introspection)."""
        self.sync()
        return read(self.path)

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._mm.flush()
            self._mm.close()
            self._f.close()


def read(path):
    """Parse a flight-recorder file into its records, oldest first.
    Torn/partial lines (crash mid-write, ring wrap) are skipped, not
    fatal.  Raises OSError when the file is missing, MXNetError when it
    is not a flight-recorder ring."""
    with open(path, "rb") as f:
        header = f.read(HEADER_SIZE)
        if len(header) < HEADER_SIZE:
            raise MXNetError("%s: not a flight recorder (short header)"
                             % path)
        magic, capacity, pos, total = _HEADER.unpack(header)
        if magic != _MAGIC:
            raise MXNetError("%s: not a flight recorder (bad magic)"
                             % path)
        data = f.read(capacity)
    if total <= capacity:
        raw = data[:pos]
        wrapped = False
    else:
        raw = data[pos:] + data[:pos]
        wrapped = True
    out = []
    for i, line in enumerate(raw.split(b"\n")):
        if not line:
            continue
        if i == 0 and wrapped:
            # the oldest surviving line was half-overwritten by the
            # newest write; its head bytes are gone by construction
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


# ----------------------------------------------------------------------
# process-global install + death-path dumps
# ----------------------------------------------------------------------

_recorder = None
_prev_usr2 = None


def install(path=None, capacity=None, sigusr2=True):
    """Create the process flight recorder, attach it to the telemetry
    registry as a sink, and arm the SIGUSR2 stack-dump hook.  ``path``
    defaults to ``MXNET_TPU_OBS_BLACKBOX``.  Returns the recorder."""
    global _recorder, _prev_usr2
    if path is None:
        from .. import env as _env
        path = _env.get("MXNET_TPU_OBS_BLACKBOX")
        if not path:
            raise MXNetError("obs.flight.install: no path given and "
                             "MXNET_TPU_OBS_BLACKBOX is unset")
    uninstall()
    rec = FlightRecorder(path, capacity=capacity)
    from .. import telemetry as _telemetry
    _telemetry.registry().attach(rec)
    rec.note("obs.blackbox.open", pid=os.getpid(),
             argv=" ".join(sys.argv[:4]))
    if sigusr2:
        try:
            _prev_usr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
        except ValueError:
            _prev_usr2 = None   # not the main thread; hook unavailable
    _recorder = rec
    return rec


def installed():
    """The process flight recorder, or None."""
    return _recorder


def uninstall():
    """Detach and close the process recorder (tests)."""
    global _recorder, _prev_usr2
    rec, _recorder = _recorder, None
    if rec is None:
        return
    from .. import telemetry as _telemetry
    _telemetry.registry().detach(rec)
    rec.close()
    if _prev_usr2 is not None:
        try:
            signal.signal(signal.SIGUSR2, _prev_usr2)
        except ValueError:
            pass
        _prev_usr2 = None


def note(name, **payload):
    """Marker into the process recorder, if one is installed (the
    guarded one-liner the death paths call)."""
    rec = _recorder
    if rec is not None:
        rec.note(name, **payload)


def emergency_dump(reason, **payload):
    """The death-path dump: record the reason (with the in-flight trace
    context, so a postmortem names WHICH request/step died), msync, and
    never raise -- callable from a signal handler or the instruction
    before ``os._exit``."""
    rec = _recorder
    if rec is None:
        return False
    try:
        from . import trace as _trace
        ctx = _trace.current()
        if ctx is not None:
            payload.setdefault("trace", ctx.trace_id)
            payload.setdefault("span", ctx.span_id)
        rec.note(reason, **payload)
        rec.sync()
    except Exception:
        pass
    return True


def _thread_stacks():
    """One formatted stack per live thread (faulthandler-shaped, but
    JSON-serializable)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        label = "%s(%d)" % (names.get(ident, "?"), ident)
        stacks[label] = "".join(traceback.format_stack(frame))[-4000:]
    return stacks


def _on_sigusr2(signum, frame):
    """faulthandler-style on-demand postmortem of a LIVE process: every
    thread's stack lands in the ring, then msync.  Re-raises nothing;
    chains to any previous handler."""
    emergency_dump("obs.sigusr2", stacks=_thread_stacks())
    prev = _prev_usr2
    if callable(prev):
        prev(signum, frame)
