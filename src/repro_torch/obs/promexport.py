"""Prometheus text-exposition export + a stdlib pull endpoint.

``MetricsRegistry.snapshot()`` is a nested dict built for JSON
artifacts; a fleet monitor wants the flat
`name{label="..."} value` lines of the Prometheus text exposition
format (version 0.0.4) on a scrape port. This module provides both
halves with **zero new dependencies**:

  * ``to_prometheus_text(snapshot)`` — flatten a registry snapshot into
    exposition lines: counters → ``counter``, gauges → ``gauge``,
    histograms → mean/percentile gauges plus a cumulative
    ``_bucket{le=...}`` series, provider dicts → gauges with their
    nested path as the metric name and non-numeric leaves skipped;
  * ``MetricsServer(registry, port)`` — a ``ThreadingHTTPServer``
    serving ``/metrics`` (exposition text) and ``/metrics.json`` (the
    raw snapshot), started on a daemon thread.
    ``launch.serve --metrics-port`` wires it up.

Metric names are sanitized to ``[a-zA-Z0-9_:]`` with a ``repro_``
prefix; µs values keep their ``_us`` suffix rather than being rescaled
— honest units over convention.
"""
from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LEADING_RE = re.compile(r"^[^a-zA-Z_:]+")


def _metric_name(*parts: str) -> str:
    flat = "_".join(str(p) for p in parts if p != "")
    name = _NAME_RE.sub("_", flat)
    name = _LEADING_RE.sub("", name) or "metric"
    return f"repro_{name}"


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(float(v))


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _flatten(prefix: Tuple[str, ...], obj,
             out: List[Tuple[str, float]]) -> None:
    """Provider dicts -> (dotted-path, value) leaves; non-numeric leaves
    (engine names, booleans-as-flags keep 0/1) are dropped."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(prefix + (str(k),), v, out)
    elif isinstance(obj, bool):
        out.append((_metric_name(*prefix), 1.0 if obj else 0.0))
    elif _is_num(obj):
        out.append((_metric_name(*prefix), float(obj)))


def to_prometheus_text(snapshot: Dict) -> str:
    """Registry snapshot dict -> Prometheus text exposition format."""
    lines: List[str] = []

    def emit(name: str, value, mtype: Optional[str] = None,
             labels: str = "") -> None:
        if mtype is not None:
            lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {_fmt(value)}")

    for key, v in sorted((snapshot.get("counters") or {}).items()):
        emit(_metric_name(key, "total"), v, "counter")
    for key, v in sorted((snapshot.get("gauges") or {}).items()):
        if _is_num(v):
            emit(_metric_name(key), v, "gauge")
    for key, h in sorted((snapshot.get("histograms") or {}).items()):
        base = _metric_name(key)
        emit(f"{base}_count", h.get("n", 0), "gauge")
        for stat in ("mean_us", "p50_us", "p95_us", "p99_us"):
            if _is_num(h.get(stat)):
                emit(f"{base}_{stat}", h[stat], "gauge")
        buckets = h.get("buckets") or {}
        if buckets:
            # cumulative le-series from the registry's sparse log
            # buckets (edges are their lower bound, label keeps the
            # registry's own "<edge>us" spelling)
            lines.append(f"# TYPE {base}_bucket gauge")
            cum = 0
            for edge, n in buckets.items():
                cum += int(n)
                lines.append(f'{base}_bucket{{le="{edge}"}} {cum}')
    reserved = ("counters", "gauges", "histograms")
    flat: List[Tuple[str, float]] = []
    for key, sub in sorted(snapshot.items()):
        if key in reserved:
            continue
        _flatten((key,), sub, flat)
    for name, v in flat:
        emit(name, v, "gauge")
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsServer:
    """Pull endpoint for one ``MetricsRegistry`` (stdlib http.server).

    ``GET /metrics`` returns the exposition text, ``GET /metrics.json``
    the raw snapshot. The server thread is a daemon; ``close()`` shuts
    it down deterministically (tests), process exit reaps it otherwise.
    """

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                           # noqa: N802
                try:
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(
                            server.registry.snapshot()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = to_prometheus_text(
                            server.registry.snapshot()).encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        self.send_error(404, "try /metrics")
                        return
                except Exception as e:      # scrape must not kill serving
                    self.send_error(500, type(e).__name__)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log news
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics-server:{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
