"""Operator observability HTTP listener: /metrics, /healthz, and the
/debug/* family (stacks, trace, health, flightrec).

Reference: swarmd/cmd/swarmd/main.go:92-97 (--listen-metrics serving
Prometheus metrics, --listen-debug serving pprof).  The stacks endpoint
is the Python analogue of a goroutine dump (the reference's integration
tests rely on exactly that for diagnosis).

Endpoints register into a table (path -> handler + description) so ``/``
serves a discoverable index and embedders can add their own via
``register()``.  This module owns only the layer-free builtins
(/metrics, /healthz, /debug/stacks); the obs package contributes
/debug/trace, /debug/health (503 while any SLO check is failing) and
/debug/flightrec through ``register_default_endpoints`` — utils sits
below obs in the layering matrix and must not import it.
"""

from __future__ import annotations

import http.server
import sys
import threading
import traceback
import urllib.parse
from typing import Callable, Dict, Optional, Tuple

from .metrics import registry

# handler(query: {k: [v, ...]}) -> (body bytes, status code, content type)
Handler = Callable[[Dict[str, list]], Tuple[bytes, int, str]]

# registered by higher layers (obs) at import time: each callback gets
# every newly constructed DebugServer and installs its endpoints, so the
# dependency points downward (obs -> utils) instead of utils importing
# the planes it serves
_default_endpoint_hooks: list = []


def register_default_endpoints(hook: Callable[["DebugServer"], None]
                               ) -> None:
    """Install ``hook(server)`` to run for every DebugServer built from
    now on (idempotent per hook object)."""
    if hook not in _default_endpoint_hooks:
        _default_endpoint_hooks.append(hook)


def _all_stacks() -> str:
    frames = sys._current_frames()
    out = []
    by_id = {t.ident: t for t in threading.enumerate()}
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else f"thread-{tid}"
        out.append(f"--- {name} ({tid}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


class DebugServer:
    """Plain-HTTP observability endpoints (no TLS: bind to loopback or a
    protected interface, like the reference's --listen-metrics)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 health: Optional[Callable[[], str]] = None,
                 health_evaluator=None):
        self.health = health or (lambda: "SERVING")
        # the SLO evaluator behind /debug/health (served by the obs
        # endpoint hook); None means the obs singleton
        self._evaluator = health_evaluator
        #: path -> (description, handler); see register()
        self.endpoints: Dict[str, Tuple[str, Handler]] = {}
        self._register_builtins()
        for hook in list(_default_endpoint_hooks):
            hook(self)
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def do_GET(self):
                body, code, ctype = outer._dispatch(self.path)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self.addr = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- endpoints

    def register(self, path: str, handler: Handler,
                 description: str) -> None:
        """Add/replace an endpoint; it appears on the ``/`` index."""
        self.endpoints[path] = (description, handler)

    def _register_builtins(self) -> None:
        self.register("/metrics", self._h_metrics,
                      "Prometheus text exposition of the process registry")
        self.register("/healthz", self._h_healthz,
                      "liveness probe: SERVING (200) or NOT_SERVING (503)")
        self.register("/debug/stacks", self._h_stacks,
                      "stack dump of every live thread")

    def _dispatch(self, raw_path: str) -> Tuple[bytes, int, str]:
        parts = urllib.parse.urlsplit(raw_path)
        path = parts.path
        # keep blanks: "?enable=" must reach the handler (and 400)
        # rather than silently degrade to the no-query behavior
        query = urllib.parse.parse_qs(parts.query,
                                      keep_blank_values=True)
        if path in ("", "/"):
            return self._h_index(query)
        entry = self.endpoints.get(path)
        if entry is None:
            return b"not found\n", 404, "text/plain"
        try:
            return entry[1](query)
        except Exception as e:   # an endpoint must never kill the server
            return (f"endpoint error: {e!r}\n".encode(), 500,
                    "text/plain")

    # -------------------------------------------------------------- handlers

    def _h_index(self, query) -> Tuple[bytes, int, str]:
        width = max(len(p) for p in self.endpoints)
        lines = ["swarmkit-tpu debug endpoints:", ""]
        for path in sorted(self.endpoints):
            desc, _ = self.endpoints[path]
            lines.append(f"  {path:<{width}}  {desc}")
        return ("\n".join(lines) + "\n").encode(), 200, "text/plain"

    def _h_metrics(self, query) -> Tuple[bytes, int, str]:
        return (registry.expose().encode(), 200,
                "text/plain; version=0.0.4")

    def _h_healthz(self, query) -> Tuple[bytes, int, str]:
        status = self.health()
        return ((status + "\n").encode(),
                200 if status == "SERVING" else 503, "text/plain")

    def _h_stacks(self, query) -> Tuple[bytes, int, str]:
        return _all_stacks().encode(), 200, "text/plain"

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="debug-http",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
