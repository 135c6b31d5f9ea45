"""Restart supervisor (counterpart of ``mxnet_tpu/supervisor.py``).

:class:`Supervisor` launches ``num_workers`` processes of one command as
one *generation* and keeps the work alive across a worker's death:

1. a worker exits nonzero (or is killed) -> the others get ``grace_s``
   to exit on their own, then the process tree is torn down;
2. the supervisor bumps the generation (``MXNET_TPU_GENERATION``, which
   the workers' statusz and endpoint files carry) and relaunches every
   worker with a fresh coordinator port; workers resume from the newest
   intact step (``ContinuousTrainer.resume()``, the crash-restart
   contract);
3. a bounded restart budget (``MXNET_TPU_SUPERVISOR_RESTARTS``) keeps a
   persistent failure from flapping forever: exhaustion is terminal
   (``supervisor.exhausted`` event) and ``/healthz`` reads NOT_READY
   while a generation is down or the budget is spent
   (``obs.status.register_supervisor``).

Each worker gets the JAX package's launch variables
(``MXNET_TPU_COORDINATOR``, ``MXNET_TPU_NUM_PROCS``,
``MXNET_TPU_PROC_ID``, ``MXNET_TPU_GENERATION``) and joins its
generation's world with
:func:`~mxnet_tpu_torch.distributed.distributed_init`: rank 0 hosts the
generation's store at the fresh coordinator port, so nothing of a dead
generation's rendezvous outlives it.  Set ``grace_s`` above
``MXNET_TPU_DIST_BARRIER_TIMEOUT_MS`` so the survivors' logs carry
their typed ``BarrierTimeout``.  ``python -m mxnet_tpu_torch.launch -n N
--supervise`` runs this supervisor from the command line.

Telemetry: ``supervisor.restarts`` / ``supervisor.generation`` /
``supervisor.restart`` / ``supervisor.exhausted``.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

from . import chaos as _chaos
from . import obs as _obs
from . import telemetry as _telemetry
from .base import MXNetError

__all__ = ["Supervisor"]

_print_lock = threading.Lock()


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _relay(pipe, prefix):
    """Line-buffered prefixed relay (the launcher behavior): each
    worker line is ONE atomic write, so generations and ranks never
    interleave mid-line."""
    out = sys.stdout.buffer
    with pipe:
        for line in iter(pipe.readline, b""):
            if not line.endswith(b"\n"):
                line += b"\n"
            with _print_lock:
                out.write(prefix + line)
                out.flush()


class Supervisor:
    """Launch ``num_workers`` ranks of ``command`` and keep the world
    alive across rank deaths under a bounded restart budget.

    ::

        sup = Supervisor([sys.executable, "-u", "train.py"], 1)
        rc = sup.run()          # 0 = every worker of some generation
                                # finished clean

    ``None`` options defer to the env registry
    (``MXNET_TPU_SUPERVISOR_RESTARTS`` / ``_GRACE_S``); the starting
    generation comes from ``MXNET_TPU_GENERATION`` so a supervisor
    itself restarted by a higher-level manager continues the
    numbering.
    """

    def __init__(self, command, num_workers, max_restarts=None,
                 grace_s=None, env=None, endpoints_dir=None):
        from . import env as _env
        if num_workers < 1:
            raise MXNetError("Supervisor: num_workers must be >= 1")
        self.command = list(command)
        self.num_workers = int(num_workers)
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else _env.get("MXNET_TPU_SUPERVISOR_RESTARTS"))
        self.grace_s = float(grace_s if grace_s is not None
                             else _env.get("MXNET_TPU_SUPERVISOR_GRACE_S"))
        self._base_env = dict(os.environ if env is None else env)
        # the endpoint discovery dir (obs.fleet): threaded into every
        # launched generation so a relaunched worker's obs server
        # re-registers under the same rank
        self.endpoints_dir = (
            endpoints_dir if endpoints_dir is not None
            else self._base_env.get("MXNET_TPU_OBS_ENDPOINTS_DIR", ""))
        self.generation = int(
            self._base_env.get("MXNET_TPU_GENERATION", "0") or 0)
        self.restarts = 0
        self.exhausted = False
        self._down = False
        self._procs = []
        _obs.status.register_supervisor(self)   # weak: /healthz

    # -- state ----------------------------------------------------------
    @property
    def generation_down(self):
        """True between a rank death and the next successful launch --
        and forever once the restart budget is exhausted.  /healthz
        reads NOT_READY off this."""
        return self._down or self.exhausted

    # -- lifecycle ------------------------------------------------------
    def run(self):
        """Supervise until a generation finishes clean (returns 0) or
        the restart budget is exhausted (returns the last failing
        rank's exit code)."""
        while True:
            rc, rank = self._run_generation(self.generation)
            if rc == 0:
                self._down = False
                return 0
            self._down = True
            if self.restarts >= self.max_restarts:
                self.exhausted = True
                if _telemetry._ENABLED:
                    _telemetry.hooks.supervisor_exhausted(
                        self.generation, self.max_restarts)
                self._log("restart budget (%d) exhausted; generation "
                          "%d stays down (rank %s exit %d)"
                          % (self.max_restarts, self.generation,
                             rank, rc))
                return rc
            self.restarts += 1
            self.generation += 1
            if _telemetry._ENABLED:
                _telemetry.hooks.supervisor_restart(
                    self.generation, rank, rc, self.restarts)
            # the relaunch IS the recovery path for a rank death
            _chaos.survived("supervisor.rank_exit", "relaunch")
            self._log("rank %s exited %d; relaunching generation %d "
                      "(restart %d/%d)"
                      % (rank, rc, self.generation, self.restarts,
                         self.max_restarts))

    def _log(self, msg):
        with _print_lock:
            print("supervisor: " + msg, flush=True)

    def _worker_env(self, gen, rank, coord):
        """The env one launched rank runs under (factored out of
        _spawn so the threading contract is testable without
        launching)."""
        env = dict(self._base_env)
        env.update({
            "MXNET_TPU_COORDINATOR": coord,
            "MXNET_TPU_NUM_PROCS": str(self.num_workers),
            "MXNET_TPU_PROC_ID": str(rank),
            "MXNET_TPU_GENERATION": str(gen),
        })
        if self.endpoints_dir:
            env["MXNET_TPU_OBS_ENDPOINTS_DIR"] = self.endpoints_dir
        return env

    def _spawn(self, gen, rank, coord):
        p = subprocess.Popen(self.command,
                             env=self._worker_env(gen, rank, coord),
                             start_new_session=True,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        t = threading.Thread(target=_relay,
                             args=(p.stdout, b"[g%d.%d] " % (gen, rank)),
                             daemon=True)
        t.start()
        p._relay_thread = t
        return p

    def _run_generation(self, gen):
        """One generation: fresh coordinator port, all ranks launched
        with the generation env.  Returns ``(0, None)`` when every
        rank exits clean, else ``(rc, rank)`` of the first failure
        (survivors get ``grace_s`` to exit on their own -- long enough
        for their typed BarrierTimeout -- then the tree is killed)."""
        coord = "127.0.0.1:%d" % _free_port()
        self._procs = [self._spawn(gen, rank, coord)
                       for rank in range(self.num_workers)]
        self._down = False
        procs = list(self._procs)
        first_rc, first_rank = None, None
        deadline = None
        while procs:
            for p in list(procs):
                rc = p.poll()
                if rc is None:
                    continue
                procs.remove(p)
                t = getattr(p, "_relay_thread", None)
                if t is not None:
                    t.join(timeout=10)
                if rc != 0 and first_rc is None:
                    first_rc = rc
                    first_rank = self._procs.index(p)
                    deadline = time.monotonic() + self.grace_s
            if not procs:
                break
            if deadline is not None and time.monotonic() > deadline:
                self._log("grace (%.0fs) over; killing %d straggler(s) "
                          "of generation %d"
                          % (self.grace_s, len(procs), gen))
                self._kill_tree(procs)
                break
            # fail-fast over N children needs a poll round-robin: a
            # blocking wait on one child hides a sibling's death
            time.sleep(0.1)  # mxlint: disable=sleep-poll
        if first_rc is None:
            return 0, None
        self._kill_tree([p for p in self._procs if p.poll() is None])
        return first_rc, first_rank

    def close(self):
        """Tear down any worker still running (a supervisor abandoned
        mid-generation, or a caller's timeout)."""
        live = [p for p in self._procs if p.poll() is None]
        if live:
            self._kill_tree(live)

    @staticmethod
    def _kill_tree(procs):
        """SIGTERM each straggler's process group, escalating to
        SIGKILL after a short grace (workers start in their own
        session, so wrapper grandchildren die too)."""
        import signal
        for q in procs:
            try:
                os.killpg(q.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                q.terminate()
        deadline = time.time() + 10
        for q in procs:
            try:
                q.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
            if q.poll() is None:
                try:
                    os.killpg(q.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    q.kill()
                q.wait()
