"""Optional stdlib HTTP ``/metrics`` + ``/healthz`` endpoint for a
real scrape loop (counterpart of ``paddle_tpu/observability/exporter.py``,
the same code; it binds the loopback address unless told otherwise).

``serve_metrics(port)`` starts a daemon-threaded ``http.server``
serving the registry's Prometheus text exposition at ``/metrics``
(and ``/``), so a standard Prometheus scrape config works against a
training or serving process without the JSONL sink. Stdlib only — no
new dependencies — and entirely off the hot path: a scrape calls
``registry.prometheus_text()`` exactly like ``metrics_snapshot()``
does. ``/metrics?names=<prefix>[,<prefix>...]`` narrows the
exposition to metric names under the given prefixes (what a fleet
collector scrapes when it only wants one subsystem's series); both
endpoints declare ``charset=utf-8`` explicitly.

``/healthz`` answers 200 with a tiny JSON liveness payload::

    {"status": "ok", "snapshot_age_seconds": 1.7, "pid": 1234}

``snapshot_age_seconds`` is the time since the registry's last
in-process snapshot — the engines snapshot once per step / serving
tick, so an external scraper can tell a HUNG process (age growing
without bound while the port still answers) from an idle-but-healthy
one. Scrapes of ``/metrics`` deliberately do not refresh the age
(metrics.py ``snapshot(touch=False)``); before any engine tick the
age is ``null``.

Components can degrade the health verdict without owning the endpoint:
``add_health_provider(fn)`` registers a callable returning
``{"component": ..., "status": "ok" | "degraded"}`` (or None to be
pruned — dead engines fall away via weakrefs). ``/healthz`` reports
``"status": "degraded"`` plus the per-component list whenever any
provider does — the ServingEngine registers one that flips to
degraded while it is load-shedding, so an external LB can drain the
replica before users see errors.

    >>> srv = serve_metrics(9100)        # port 0 picks a free port
    >>> srv.port
    9100
    >>> # ... prometheus scrapes http://host:9100/metrics,
    >>> # ... the orchestrator probes /healthz ...
    >>> srv.close()
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from .metrics import MetricsRegistry, get_registry

__all__ = ["MetricsServer", "serve_metrics", "add_health_provider",
           "remove_health_provider", "health_status"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_health_lock = threading.Lock()
_health_providers: list = []


def add_health_provider(fn) -> None:
    """Register a component health callable for /healthz: returns
    ``{"component": str, "status": "ok" | "degraded"}``, or None to be
    pruned (a provider closing over a dead weakref)."""
    with _health_lock:
        if fn not in _health_providers:
            _health_providers.append(fn)


def remove_health_provider(fn) -> None:
    with _health_lock:
        if fn in _health_providers:
            _health_providers.remove(fn)


def health_status() -> dict:
    """Aggregate component health: worst status wins; providers that
    return None (component gone) are pruned."""
    with _health_lock:
        providers = list(_health_providers)
    components, dead = [], []
    for fn in providers:
        try:
            c = fn()
        except Exception:
            continue        # a broken provider must not break liveness
        if c is None:
            dead.append(fn)
            continue
        components.append(c)
    for fn in dead:
        remove_health_provider(fn)
    status = "degraded" if any(
        c.get("status") != "ok" for c in components) else "ok"
    return {"status": status, "components": components}


class MetricsServer:
    """Handle on a running exporter: ``port`` is the bound port (useful
    with ``port=0``), ``close()`` shuts the listener down."""

    def __init__(self, httpd: ThreadingHTTPServer,
                 thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.port = int(httpd.server_address[1])

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # context-manager sugar so tests/tools can `with serve_metrics(0):`
    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_metrics(port: int = 0, registry: Optional[MetricsRegistry] = None,
                  host: str = "127.0.0.1") -> MetricsServer:
    """Start the ``/metrics`` endpoint on ``host:port`` (0 = ephemeral)
    serving ``registry`` (default: the process-wide one)."""
    reg = registry or get_registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                age = reg.snapshot_age_seconds()
                health = health_status()
                doc = {
                    "status": health["status"],
                    "snapshot_age_seconds":
                        round(age, 3) if age is not None else None,
                    "pid": os.getpid(),
                }
                if health["components"]:
                    doc["components"] = health["components"]
                body = json.dumps(doc).encode("utf-8")
                ctype = "application/json; charset=utf-8"
            elif path in ("/", "/metrics"):
                # ?names=<prefix>[,<prefix>...] filters the exposition
                # by metric-name prefix (a fleet collector scraping
                # only paddle_tpu_serving_* pays for just that); the
                # filtered read is still snapshot(touch=False) inside
                # prometheus_text, so scrapes never mask a hung engine
                prefixes = [p for n in parse_qs(query).get("names", [])
                            for p in n.split(",") if p] or None
                body = reg.prometheus_text(
                    prefixes=prefixes).encode("utf-8")
                ctype = CONTENT_TYPE
            else:
                self.send_error(404, "only /metrics and /healthz are "
                                     "served")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass                # scrapes must not spam the train log

    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="metrics-exporter", daemon=True)
    thread.start()
    return MetricsServer(httpd, thread)
