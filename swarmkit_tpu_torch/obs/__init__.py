"""Observability layer: span tracing, task-lifecycle latency, reports,
flight recorder, time-series sampler, and the health/SLO plane.

``tracer`` is the process-wide span recorder (disabled by default; the
chip smoke run and ``/debug/trace`` enable/serve it).  ``flightrec`` is
the process-wide black box: bounded rings of recent spans (tapped from
the tracer), metric samples (``Sampler``), store events, and raft role
transitions, dumped as one post-mortem JSON (``/debug/flightrec``).
``HealthEvaluator`` judges declarative SLO checks over the registry and
serves ``/debug/health``.  Metrics counters and timers live in
``utils.metrics.registry`` -- this package adds the span/trace dimension
and the derived planes on top.
"""

from . import debugpages  # noqa: F401  (installs /debug/* endpoint hook)
from . import devicetelemetry  # noqa: F401  (device-plane ledger)
from . import planes  # noqa: F401  (per-plane saturation signals)
from .flightrec import FlightRecorder, flightrec
from .health import Check, HealthEvaluator
from .journey import JourneyLedger, journeys
from .lifecycle import LifecycleTracker
from .report import (
    device_table, diff_phase_tables, format_device_table, format_diff,
    format_table, phase_table, validate_chrome_trace,
)
from .sampler import Sampler
from .trace import Span, Tracer, tracer

__all__ = [
    "Check", "FlightRecorder", "HealthEvaluator", "JourneyLedger",
    "LifecycleTracker", "Sampler", "Span", "Tracer",
    "device_table", "devicetelemetry", "diff_phase_tables", "flightrec",
    "format_device_table", "format_diff", "format_table", "journeys",
    "phase_table", "planes", "tracer", "validate_chrome_trace",
]
