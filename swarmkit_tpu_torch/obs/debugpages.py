"""The obs package's /debug/* endpoints for utils.httpdebug.DebugServer.

These handlers used to live inside httpdebug itself, lazily importing
obs — an inversion of the layering matrix (utils must import nothing
above itself; swarmlint's ``layering`` rule now enforces that).  They
register here instead, through the server's default-endpoint hook:
importing the obs package is what makes any subsequently constructed
DebugServer serve /debug/trace, /debug/health and /debug/flightrec.
"""

from __future__ import annotations

import json
from typing import Tuple

from ..utils import httpdebug


def _h_trace(server, query) -> Tuple[bytes, int, str]:
    from .trace import tracer
    enable = query.get("enable")
    if enable:
        value = enable[0].lower()
        if value in ("1", "true", "on", "yes"):
            tracer.reset()
            tracer.enable()
            return b"tracing enabled\n", 200, "text/plain"
        if value in ("0", "false", "off", "no"):
            tracer.disable()
            return b"tracing disabled\n", 200, "text/plain"
        return (f"bad enable value {value!r}; use 1/0\n".encode(),
                400, "text/plain")
    return tracer.to_json().encode(), 200, "application/json"


def _h_health(server, query) -> Tuple[bytes, int, str]:
    ev = server._evaluator
    if ev is None:
        from .health import evaluator
        ev = server._evaluator = evaluator
    report = ev.report()
    # probes consume the status code; humans the JSON body
    code = 503 if report["status"] == "fail" else 200
    body = json.dumps(report, sort_keys=True, indent=1).encode()
    return body, code, "application/json"


def _h_flightrec(server, query) -> Tuple[bytes, int, str]:
    from .flightrec import flightrec
    return flightrec.dump_json().encode(), 200, "application/json"


def _h_planes(server, query) -> Tuple[bytes, int, str]:
    """Per-plane saturation report + journey-ledger summary.  Must
    render on a fresh manager with zero observations and on a deposed
    ex-leader alike (ISSUE 17 bugfix sweep): both arms below only read
    module-level state that always exists."""
    from .journey import journeys
    from .planes import report_all
    doc = {"planes": report_all(), "journeys": journeys.summary()}
    body = json.dumps(doc, sort_keys=True, indent=1).encode()
    return body, 200, "application/json"


def _h_device(server, query) -> Tuple[bytes, int, str]:
    """Device-plane telemetry ledger: kernel rows, per-reason transfer
    bytes, the compile-cache ledger, memory watermarks, and the
    donation balance.  Renders on a fresh manager (all tables empty)
    and on a deposed ex-leader (module-level state always exists) — the
    _h_planes discipline."""
    from .devicetelemetry import snapshot
    from .planes import DEVICE, report_all
    doc = {"device_telemetry": snapshot(),
           "device_plane": report_all().get(DEVICE, {})}
    body = json.dumps(doc, sort_keys=True, indent=1).encode()
    return body, 200, "application/json"


def _install(server: "httpdebug.DebugServer") -> None:
    server.register("/debug/trace",
                    lambda query: _h_trace(server, query),
                    "Chrome trace-event JSON of the span tracer "
                    "(?enable=1/0 toggles recording)")
    server.register("/debug/health",
                    lambda query: _h_health(server, query),
                    "SLO check report (JSON); 503 while any check "
                    "is failing")
    server.register("/debug/flightrec",
                    lambda query: _h_flightrec(server, query),
                    "flight-recorder post-mortem dump (JSON): recent "
                    "spans, metric samples, store events, raft "
                    "transitions")
    server.register("/debug/planes",
                    lambda query: _h_planes(server, query),
                    "per-plane saturation report (occupancy, queue "
                    "depth, oldest-item age, drops/defers) + journey "
                    "ledger summary")
    server.register("/debug/device",
                    lambda query: _h_device(server, query),
                    "device-plane telemetry: kernel ledger, per-reason "
                    "transfer bytes, compile-cache ledger, memory "
                    "watermarks, donation balance")


httpdebug.register_default_endpoints(_install)
