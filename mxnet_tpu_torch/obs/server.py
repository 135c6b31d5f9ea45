"""Live introspection over HTTP: a stdlib ``http.server`` thread every
serving/training process can run (``MXNET_TPU_OBS_PORT``; counterpart
of ``mxnet_tpu/obs/server.py``, with the same bodies for the same
status board).

Three endpoints, chosen because they are what fleet tooling already
speaks:

- ``GET /healthz``  -- ``200 READY`` / ``503 NOT_READY`` derived from
  the status board (watcher failure budget, async-writer failures,
  queue saturation); body carries the JSON reasons.
- ``GET /metrics``  -- the existing Prometheus text exposition of the
  live telemetry registry (scrape it; no push gateway).
- ``GET /statusz``  -- the operator JSON: served/published step, swap
  history, bucket occupancy, per-rank last-heartbeat.
- ``GET /alertz``   -- the fleet alert plane: firing/pending alerts,
  the resolved history and the rules of the newest
  :class:`~mxnet_tpu_torch.obs.fleet.FleetMonitor` registered in this
  process, or the JAX package's empty shell when none runs here.

When ``MXNET_TPU_OBS_ENDPOINTS_DIR`` is set, :func:`serve` also
publishes this process's ``{pid, rank, generation, port, started_at}``
endpoint file there (atomically, via checkpoint-core) so a fleet
monitor can discover it; :func:`stop` withdraws it.

Bound to localhost by default (a sidecar/scraper surface, not an
internet listener); ``port=0`` picks an ephemeral port, returned by
:func:`serve` and readable via :func:`port`.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import status as _status

__all__ = ["serve", "stop", "port", "running"]

_server = None
_thread = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxtpu-obs/1"

    def _send(self, code, body, ctype="application/json"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                ready, reasons = _status.health()
                self._send(200 if ready else 503,
                           json.dumps({"status": "READY" if ready
                                       else "NOT_READY",
                                       "reasons": reasons}))
            elif path == "/metrics":
                from .. import telemetry as _telemetry
                self._send(200, _telemetry.prom_dump(),
                           ctype="text/plain; version=0.0.4")
            elif path == "/statusz":
                self._send(200, json.dumps(_status.statusz(),
                                           default=str))
            elif path == "/alertz":
                from . import fleet as _fleet
                self._send(200, json.dumps(_fleet.alertz(),
                                           default=str))
            else:
                self._send(404, json.dumps(
                    {"error": "unknown path %r" % path,
                     "paths": ["/healthz", "/metrics", "/statusz",
                               "/alertz"]}))
        except Exception as e:      # an introspection bug must never
            try:                    # kill the serving process
                self._send(500, json.dumps({"error": str(e)}))
            except Exception:
                pass

    def log_message(self, fmt, *args):   # no stderr chatter per scrape
        pass


def serve(port=None, host="127.0.0.1"):
    """Start the introspection server thread; returns the bound port.
    ``port=None`` reads ``MXNET_TPU_OBS_PORT``; ``0`` binds ephemeral.
    Idempotent: an already-running server just reports its port."""
    global _server, _thread
    if _server is not None:
        return _server.server_address[1]
    if port is None:
        from .. import env as _env
        port = int(_env.get("MXNET_TPU_OBS_PORT"))
    srv = ThreadingHTTPServer((host, int(port)), _Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mxtpu-obs-http")
    t.start()
    _server, _thread = srv, t
    bound = srv.server_address[1]
    from . import fleet as _fleet
    _fleet.publish_endpoint(bound)   # no-op unless ENDPOINTS_DIR set
    return bound


def stop():
    """Shut the server down, withdraw the published endpoint, and join
    the thread."""
    global _server, _thread
    srv, _server = _server, None
    t, _thread = _thread, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=10)
    from . import fleet as _fleet
    _fleet.remove_endpoint()        # the clean-departure path


def port():
    """The bound port, or None when not running."""
    return _server.server_address[1] if _server is not None else None


def running():
    return _server is not None
