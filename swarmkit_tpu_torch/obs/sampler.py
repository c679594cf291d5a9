"""Time-series metrics sampler feeding the flight recorder.

Periodically snapshots the metrics registry and records a compact delta
row into ``flightrec.samples``.  Two properties matter:

* **Time through the seam.**  Sample timestamps come from
  ``models.types.now()`` — under the simulator's VirtualClock a sample
  series is a pure function of the seed (the engine drives ``sample()``
  as an event; production runs ``start()``'s thread).

* **Deltas, not absolutes.**  The registry is process-global and
  long-lived; absolute counter values embed everything that ran before
  this capture.  ``rebase()`` pins a baseline and every sample records
  counters (and timer observation counts) relative to it, so two
  captures of the same workload produce identical rows.

Deterministic mode (the sim) drops everything wall-clock-tainted: timer
totals/quantiles are measured with ``perf_counter`` and gauges may be
written by wall-clock threads, so only counter and timer-count deltas —
pure event counts — are recorded.  Production mode keeps gauges and
timer totals for the health plane's benefit.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..models import types as _types
from ..utils.metrics import Registry
from ..utils.metrics import registry as _default_registry
from .flightrec import FlightRecorder, flightrec


class Sampler:
    def __init__(self, registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 deterministic: bool = False, prefix: str = "swarm_"):
        self.registry = registry or _default_registry
        self.recorder = recorder or flightrec
        self.deterministic = deterministic
        self.prefix = prefix
        self._base_counters: Dict[str, float] = {}
        self._base_timer_counts: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rebase()

    # -------------------------------------------------------------- sampling

    def rebase(self) -> None:
        """Pin the delta baseline to the registry's current state (call
        at capture start; ``reset()`` on the registry also warrants
        one)."""
        reg = self.registry
        self._base_counters = reg.counters_snapshot(self.prefix)
        self._base_timer_counts = {
            name: t.count
            for name, t in reg.timers_snapshot(self.prefix).items()}

    def sample(self) -> Dict[str, object]:
        """Record one row: cumulative deltas since ``rebase()``.  Always
        returns the row; recording respects the recorder's enable
        flag."""
        # close the plane occupancy windows on the same cadence as the
        # rows that carry them: the rolled gauges land in this sample
        from . import planes as _planes
        _planes.roll_all()
        reg = self.registry
        t = _types.now()
        counters = {
            k: v - self._base_counters.get(k, 0.0)
            for k, v in reg.counters_snapshot(self.prefix).items()}
        counters = {k: v for k, v in sorted(counters.items()) if v}
        gauges = {} if self.deterministic else dict(
            sorted(reg.gauges_snapshot(self.prefix).items()))
        timer_counts = {}
        timer_totals = {}
        for name, timer in sorted(reg.timers_snapshot(self.prefix)
                                  .items()):
            d = timer.count - self._base_timer_counts.get(name, 0)
            if d:
                timer_counts[name] = d
                if not self.deterministic:
                    timer_totals[name] = round(timer.total, 6)
        row: Dict[str, object] = {"t": t, "counters": counters,
                                  "timer_counts": timer_counts}
        if gauges:
            row["gauges"] = gauges
        if timer_totals:
            row["timer_totals"] = timer_totals
        self.recorder.record_sample(row)
        return row

    # --------------------------------------------------------------- running

    def start(self, interval: float = 2.0,
              on_sample: Optional[Callable[[], None]] = None) -> None:
        """Production mode: a daemon thread samples every ``interval``
        seconds, drains the recorder's store subscription, then runs
        ``on_sample`` (the Manager passes the health evaluator)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.recorder.poll_store()
                    self.sample()
                    if on_sample is not None:
                        on_sample()
                except Exception:
                    pass   # observability must never take the plane down

        self._thread = threading.Thread(target=loop, name="obs-sampler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
