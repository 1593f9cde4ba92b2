"""Dependency-free live ops surface: /metrics, /health, /slo (counterpart of
the reference's ``telemetry/ops_server.py``).

A :class:`OpsServer` binds a stdlib ``ThreadingHTTPServer`` on an ephemeral
(or pinned) port and serves three read-only routes while a drain runs:

- ``/metrics`` — the session registry's Prometheus text exposition
  (``MetricsRegistry.prometheus_text`` already snapshots per family under
  its lock — copy, then render — so a scrape racing the
  router thread reads a consistent family).
- ``/health`` — per-replica health/occupancy/backlog JSON from the
  caller-provided ``health_fn`` (the router's gauge view).
- ``/slo`` — the live :class:`~.slo_monitor.SloMonitor` snapshot: windowed
  attainment + burn rate per tenant, the operable control signal the
  ROADMAP "elastic fleet" item closes on.

Threading model: the ONLY mutable state is held by the
server object and written once at init (init-confined); the handler reads
it and calls the three callables, each of which takes its OWN lock
(registry / monitor / router) — the HTTP threads never hold a runtime lock
across a blocking socket write because the payload is fully rendered
before ``wfile.write``. ``stop()`` joins the serve thread without holding
any session lock.

Host-side only: nothing here touches a device, and import stays
stdlib-only so the module loads anywhere.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from neuronx_distributed_inference_tpu_torch.telemetry import metrics as metrics_mod

__all__ = ["OpsServer"]


class _OpsHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + the three route backends (init-confined)."""

    daemon_threads = True

    def __init__(self, addr, registry, health_fn, slo_fn):
        super().__init__(addr, _OpsHandler)
        self.registry = registry
        self.health_fn = health_fn
        self.slo_fn = slo_fn


class _OpsHandler(BaseHTTPRequestHandler):
    """Read-only GET router. No attribute writes, no runtime locks held —
    each route renders its full payload (the callables lock internally)
    and then writes it out."""

    server: _OpsHTTPServer

    def do_GET(self):  # noqa: N802 (http.server naming contract)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            body = self.server.registry.prometheus_text().encode()
            ctype = metrics_mod.PROMETHEUS_CONTENT_TYPE
        elif path == "/health":
            fn = self.server.health_fn
            payload = fn() if fn is not None else {}
            body = json.dumps(payload, sort_keys=True).encode()
            ctype = "application/json"
        elif path == "/slo":
            fn = self.server.slo_fn
            payload = fn() if fn is not None else {}
            body = json.dumps(payload, sort_keys=True).encode()
            ctype = "application/json"
        else:
            body = b"not found: routes are /metrics /health /slo\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:
        # scrapes every few seconds must not spam stderr
        pass


class OpsServer:
    """Threaded HTTP endpoint over one telemetry registry.

    ``health_fn`` / ``slo_fn`` are zero-arg callables returning
    JSON-serializable dicts (``ServingRouter.diagnostic_snapshot`` and
    ``SloMonitor.snapshot`` are the intended bindings); either may be None
    and the route serves ``{}``. ``port=0`` binds an ephemeral port —
    read ``self.port`` after :meth:`start`.
    """

    def __init__(
        self,
        registry,
        health_fn: Optional[Callable[[], dict]] = None,
        slo_fn: Optional[Callable[[], dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.registry = registry
        self.health_fn = health_fn
        self.slo_fn = slo_fn
        self.host = host
        self.port = int(port)
        self._httpd: Optional[_OpsHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        self._httpd = _OpsHTTPServer(
            (self.host, self.port), self.registry, self.health_fn,
            self.slo_fn,
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="nxdi-ops-server",
            daemon=True,
        )
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        """Shut the server down and JOIN the serve thread (clean teardown
        is part of the tier-1 smoke — no daemon-thread leak past stop)."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self) -> "OpsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
