"""Live ops surface — stdlib HTTP endpoint for scrape + readiness.

Four read-only routes over the serving runtime's observability state:

* ``/metrics`` — Prometheus text exposition (``repro_torch.obs.export.
  prometheus_text`` over a fresh telemetry snapshot, HELP/TYPE lines
  included). Content type is the exposition-format one scrapers expect.
* ``/health`` — the :class:`~repro_torch.obs.health.HealthMonitor` status
  document as JSON. HTTP status mirrors readiness: 200 for ``ok`` and
  ``degraded`` (degraded is serving, just impaired), 503 for
  ``stalled`` — so a dumb LB health check needs no JSON parsing.
* ``/freshness`` — per-standing-query staleness/burn rows from the
  :class:`~repro_torch.obs.freshness.FreshnessLedger`, stalest first.
* ``/flight`` — on-demand flight-recorder dump; responds with the path
  written (the dump itself stays on local disk — flight JSONL can be
  large and contains the full event ring).

Stdlib ``http.server`` only (no new deps), ``ThreadingHTTPServer`` so a
slow scraper cannot block a health probe, bound to 127.0.0.1 — this is
an operator loopback surface, not a public API. ``port=0`` binds an
ephemeral port (tests); the chosen port is readable at ``.port`` after
``start()``. Suppliers are plain callables so the server has no
runtime-type dependency and tests can drive it with stubs.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from .export import prometheus_text

_CT_PROM = "text/plain; version=0.0.4; charset=utf-8"
_CT_JSON = "application/json; charset=utf-8"


class OpsServer:
    """Loopback HTTP server exposing ``/metrics`` ``/health``
    ``/freshness`` ``/flight`` (module docstring).

    Parameters are suppliers: ``snapshot`` → telemetry snapshot dict,
    ``health`` → health status dict (with a ``state`` key), ``freshness``
    → list of per-query row dicts, ``flight`` → dump path or None.
    Any supplier may be None (its route 404s).
    """

    def __init__(self,
                 snapshot: Optional[Callable[[], Dict[str, Any]]] = None,
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 freshness: Optional[Callable[[], Any]] = None,
                 flight: Optional[Callable[[], Optional[str]]] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 prefix: str = "igpm"):
        self._suppliers = {"snapshot": snapshot, "health": health,
                           "freshness": freshness, "flight": flight}
        self.prefix = prefix
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _handler(self):
        ops = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # scrapes must not spam stderr
                pass

            def _send(self, status: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    route = ops._route(path)
                except Exception as exc:   # supplier blew up: surface, don't die
                    self._send(500, json.dumps({"error": repr(exc)}) + "\n",
                               _CT_JSON)
                    return
                if route is None:
                    self._send(404, json.dumps(
                        {"error": "not found", "routes": [
                            "/metrics", "/health", "/freshness", "/flight"],
                         }) + "\n", _CT_JSON)
                else:
                    self._send(*route)

        return _Handler

    def _route(self, path: str):
        """(status, body, content-type) for a path, None = 404."""
        s = self._suppliers
        if path == "/metrics" and s["snapshot"] is not None:
            return 200, prometheus_text(s["snapshot"](),
                                        prefix=self.prefix), _CT_PROM
        if path == "/health" and s["health"] is not None:
            doc = s["health"]()
            status = 503 if doc.get("state") == "stalled" else 200
            return status, json.dumps(doc, default=str) + "\n", _CT_JSON
        if path == "/freshness" and s["freshness"] is not None:
            rows = s["freshness"]()
            rows = [r._asdict() if hasattr(r, "_asdict") else r for r in rows]
            return 200, json.dumps({"queries": rows}) + "\n", _CT_JSON
        if path == "/flight" and s["flight"] is not None:
            path_out = s["flight"]()
            return 200, json.dumps(
                {"dumped": path_out is not None,
                 "path": str(path_out) if path_out else None}) + "\n", _CT_JSON
        return None

    def start(self) -> "OpsServer":
        if self._thread is not None:
            raise RuntimeError("ops server already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1}, name="rt-ops", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()
