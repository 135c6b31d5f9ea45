"""``python -m mxnet_tpu_torch.launch``: start the workers of one world
(counterpart of ``tools/launch.py``, with the same flags, variables and
relay).

There are no parameter-server or scheduler roles: every worker is a
process of the world of :mod:`mxnet_tpu_torch.distributed`, and the
launcher only starts N identical processes with the coordinator's
address and each process's index::

  local mode:   python -m mxnet_tpu_torch.launch -n 2 python train.py
  ssh mode:     python -m mxnet_tpu_torch.launch -n 8 -H hostfile python train.py
  supervised:   python -m mxnet_tpu_torch.launch -n 2 --supervise python train.py

Each worker gets MXNET_TPU_COORDINATOR / MXNET_TPU_NUM_PROCS /
MXNET_TPU_PROC_ID; ``mx.distributed_init()`` maps them onto a
``TCPStore`` and a gloo process group.  Every worker line is relayed to
stdout with a ``[rank]`` prefix in one atomic write.  Without
``--supervise`` the first nonzero exit tears the survivors down.

``--supervise`` (local mode) runs the restart supervisor
(:class:`mxnet_tpu_torch.supervisor.Supervisor`): a rank death tears the
world down (survivors get their typed BarrierTimeout within
``--grace``), the generation id is bumped (MXNET_TPU_GENERATION --
workers resume via ``ContinuousTrainer.resume()``), and the world
relaunches under a bounded ``--max-restarts`` budget.
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import threading

_print_lock = threading.Lock()


def _relay(pipe, prefix):
    """Line-buffered prefixed relay (the dmlc tracker behavior): each
    worker line becomes ONE atomic write under a lock, so two workers'
    output can never interleave mid-line."""
    out = sys.stdout.buffer
    with pipe:
        for line in iter(pipe.readline, b""):
            if not line.endswith(b"\n"):
                line += b"\n"
            with _print_lock:
                out.write(prefix + line)
                out.flush()


def _spawn_relayed(cmd, env, rank):
    p = subprocess.Popen(cmd, env=env, start_new_session=True,
                         stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    t = threading.Thread(target=_relay,
                         args=(p.stdout, b"[%d] " % rank), daemon=True)
    t.start()
    p._relay_thread = t
    return p


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kill_tree(procs):
    """SIGTERM each worker's whole process group (workers start in
    their own session, so wrapper scripts' grandchildren die too),
    escalating to SIGKILL after a grace period."""
    import signal
    import time
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


def _wait_all(procs):
    """Wait for every worker, failing FAST: the first nonzero exit
    tears down the survivors (a dead peer would otherwise wedge the
    rest inside their collectives); Ctrl-C tears all down."""
    import time
    try:
        while procs:
            for p in list(procs):
                rc = p.poll()
                if rc is None:
                    continue
                procs.remove(p)
                t = getattr(p, "_relay_thread", None)
                if t is not None:
                    t.join(timeout=10)
                if rc != 0:
                    _kill_tree(procs)
                    return rc
            # fail-FAST over N children needs a poll round-robin: a
            # blocking wait on any single child would hide a sibling's
            # death behind it (os.wait reaps relay threads' pipes too)
            time.sleep(0.1)
        return 0
    except KeyboardInterrupt:
        _kill_tree(procs)
        raise


def launch_local(args, command):
    coord = "127.0.0.1:%d" % _free_port()
    procs = []
    for rank in range(args.num_workers):
        env = dict(os.environ)
        env.update({
            "MXNET_TPU_COORDINATOR": coord,
            "MXNET_TPU_NUM_PROCS": str(args.num_workers),
            "MXNET_TPU_PROC_ID": str(rank),
            # legacy names some scripts read
            "DMLC_ROLE": "worker",
            "DMLC_NUM_WORKER": str(args.num_workers),
        })
        procs.append(_spawn_relayed(command, env, rank))
    return _wait_all(procs)


def launch_ssh(args, command):
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip()
                 and not h.startswith("#")]
    if len(hosts) < args.num_workers:
        # round-robin workers over hosts
        hosts = [hosts[i % len(hosts)] for i in range(args.num_workers)]
    # per-job coordinator port: a fixed port would collide across jobs
    # (or a restart racing its predecessor's TIME_WAIT socket)
    port = args.port or (40000 + os.getpid() % 20000)
    coord = "%s:%d" % (hosts[0].split(":")[0], port)
    procs = []
    cwd = os.getcwd()
    for rank in range(args.num_workers):
        host = hosts[rank].split(":")[0]
        envs = " ".join("%s=%s" % kv for kv in [
            ("MXNET_TPU_COORDINATOR", coord),
            ("MXNET_TPU_NUM_PROCS", str(args.num_workers)),
            ("MXNET_TPU_PROC_ID", str(rank)),
        ])
        remote = "cd %s && env %s %s" % (
            shlex.quote(cwd), envs, " ".join(map(shlex.quote, command)))
        procs.append(_spawn_relayed(
            ["ssh", "-o", "StrictHostKeyChecking=no", "-tt", host,
             remote], None, rank))
    # -tt allocates a tty so terminating the ssh client also kills the
    # remote command instead of orphaning it
    return _wait_all(procs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("-H", "--hostfile", default=None,
                   help="one host per line; omit for single-host local")
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port for ssh mode (default: derived "
                        "per job)")
    p.add_argument("--supervise", action="store_true",
                   help="elastic restart supervision (local mode): on "
                        "any rank exit, tear down, bump the generation "
                        "id, and relaunch under --max-restarts")
    p.add_argument("--max-restarts", type=int, default=None,
                   help="restart budget for --supervise (default: "
                        "MXNET_TPU_SUPERVISOR_RESTARTS)")
    p.add_argument("--grace", type=float, default=None,
                   help="seconds survivors get to exit on their own "
                        "typed error before the tree is killed "
                        "(default: MXNET_TPU_SUPERVISOR_GRACE_S)")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command given")
    if args.supervise:
        if args.hostfile:
            p.error("--supervise is local-mode only (ssh worlds need "
                    "an external supervisor per host)")
        from .supervisor import Supervisor
        return Supervisor(args.command, args.num_workers,
                          max_restarts=args.max_restarts,
                          grace_s=args.grace).run()
    if args.hostfile:
        return launch_ssh(args, args.command)
    return launch_local(args, args.command)


if __name__ == "__main__":
    sys.exit(main())
