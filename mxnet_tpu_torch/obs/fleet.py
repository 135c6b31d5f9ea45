"""Endpoint discovery files and the ``/alertz`` shell (the part of
``mxnet_tpu/obs/fleet.py`` a single process uses).

Every obs server publishes its ``{pid, rank, generation, port,
started_at}`` to ``MXNET_TPU_OBS_ENDPOINTS_DIR`` (:func:`publish_endpoint`,
through the checkpoint core's atomic commit, so a reader never sees a
torn registration) and withdraws it on stop (:func:`remove_endpoint`);
dead writers' files are swept (:func:`sweep_endpoints`).  The files
are the JAX package's, name and content.  The fleet monitor that reads
them, its aggregation, the alert engine and ``mxtelemetry fleet`` are
the fleet plane, not ported yet: :func:`alertz` answers the JAX
package's "no monitor in this process" shell.
"""
from __future__ import annotations

import json
import os
import re
import time

__all__ = ["Endpoint", "publish_endpoint", "remove_endpoint",
           "sweep_endpoints", "alertz"]

_ENDPOINT_RE = re.compile(r"^r(\d+)\.(\d+)\.json$")

# published endpoint paths owned by THIS process (removed on
# server.stop())
_published = []


def _endpoints_dir(dirpath=None):
    if dirpath is None:
        dirpath = os.environ.get("MXNET_TPU_OBS_ENDPOINTS_DIR", "")
    return dirpath or None


def _rank():
    try:
        return int(os.environ.get("MXNET_TPU_PROC_ID", "0") or 0)
    except ValueError:
        return 0


def _generation():
    try:
        return int(os.environ.get("MXNET_TPU_GENERATION", "0") or 0)
    except ValueError:
        return 0


class Endpoint:
    """One discovered obs-server registration."""

    __slots__ = ("pid", "rank", "generation", "port", "started_at",
                 "path")

    def __init__(self, pid, rank, generation, port, started_at,
                 path=None):
        self.pid = int(pid)
        self.rank = int(rank)
        self.generation = int(generation)
        self.port = int(port)
        self.started_at = float(started_at)
        self.path = path

    @property
    def url(self):
        return "http://127.0.0.1:%d" % self.port

    def as_dict(self):
        return {"pid": self.pid, "rank": self.rank,
                "generation": self.generation, "port": self.port,
                "started_at": self.started_at}

    def __repr__(self):
        return ("Endpoint(rank=%d gen=%d pid=%d port=%d)"
                % (self.rank, self.generation, self.pid, self.port))


def sweep_endpoints(dirpath):
    """Remove endpoint files whose writer pid is dead -- the
    checkpoint core's stale-tmp sweep applied to registrations.  Live
    pids (including ours) are left alone.  Returns the removed
    paths."""
    from ..checkpoint.core import _pid_alive
    removed = []
    try:
        entries = os.listdir(dirpath)
    except OSError:
        return removed
    for name in entries:
        m = _ENDPOINT_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(2))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(dirpath, name)
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


def publish_endpoint(port, dirpath=None, rank=None, generation=None):
    """Atomically publish this process's obs endpoint to the discovery
    directory (``MXNET_TPU_OBS_ENDPOINTS_DIR`` when ``dirpath`` is
    None; unset = no-op returning None).  Uses the checkpoint-core
    atomic commit, so a reader can never observe a torn registration,
    and sweeps dead-pid siblings first so a crashed generation's
    residue never outlives its relaunch."""
    from ..checkpoint.core import atomic_write_bytes
    dirpath = _endpoints_dir(dirpath)
    if dirpath is None:
        return None
    rank = _rank() if rank is None else int(rank)
    generation = _generation() if generation is None else int(generation)
    os.makedirs(dirpath, exist_ok=True)
    sweep_endpoints(dirpath)
    ep = Endpoint(os.getpid(), rank, generation, port, time.time())
    path = os.path.join(dirpath, "r%d.%d.json" % (rank, os.getpid()))
    atomic_write_bytes(path, json.dumps(ep.as_dict(),
                                        sort_keys=True).encode())
    ep.path = path
    _published.append(path)
    return path


def remove_endpoint(path=None):
    """Withdraw this process's registration(s) -- the clean-departure
    path (obs.server.stop()); a dead-pid sweep covers the crash path."""
    paths = [path] if path is not None else list(_published)
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass
        if p in _published:
            _published.remove(p)


def alertz():
    """The ``/alertz`` payload: the JAX package's empty shell of a
    process that runs no fleet monitor."""
    return {"schema": "mxalertz.v1", "monitors": 0, "firing": [],
            "pending": [], "history": [], "rules": []}
