"""What the metric readers (``metrics/*.py``) share: sums and medians
over a run's :class:`harness.Record`."""

from __future__ import annotations

import statistics
from typing import Callable, Optional

from . import profile


def median_ms(rec, part: Callable[[dict], float]) -> Optional[float]:
    """Median over the measured steps of ``part(step)`` seconds, in ms."""
    values = [part(st) for st in rec.steps]
    return statistics.median(values) * 1e3 if values else None


def span_ms_per_tick(rec, name: str) -> Optional[float]:
    """The program's span ``name``: its seconds over the traced window
    (every thread), per tick, in ms."""
    if not rec.traced or not rec.ticks:
        return None
    spans = [end - start for n, start, end, _ in rec.spans if n == name]
    if not spans:
        return None
    return sum(spans) / rec.ticks * 1e3


def planner_ms_per_tick(rec, key: str) -> Optional[float]:
    """A seconds counter of ``TorchPlanner.stats`` over the traced
    window, per tick, in ms."""
    if not rec.traced or not rec.ticks or key not in rec.planner_stats:
        return None
    return rec.planner_stats[key] / rec.ticks * 1e3


def device_ms_per_tick(rec, keep: Callable[[str], bool]) -> Optional[float]:
    """Device seconds of the rows ``keep`` selects, per tick, in ms; None
    where the run traced no device."""
    dev = rec.device
    if dev is None or not rec.ticks:
        return None
    rows = [d for name, _, d in dev.rows if keep(name)]
    if not rows:
        return None
    return sum(rows) / rec.ticks * 1e3


def busy_share(rec) -> Optional[float]:
    """The union of the device's rows over the traced window, in %."""
    dev = rec.device
    if dev is None or dev.window_s() <= 0 or not dev.rows:
        return None
    return dev.busy_s() / dev.window_s() * 100.0


def kernel_roofline(rec) -> Optional[float]:
    """The least time the window's plans need on the card (its published
    peaks) over the device time of its kernel rows, in %."""
    from .metrics import roofline
    dev = rec.device
    if dev is None or not rec.work:
        return None
    kernel_s = dev.seconds_where(lambda name: not profile.is_copy(name))
    if kernel_s <= 0:
        return None
    least = sum(roofline.plan_seconds(w) for w in rec.work)
    return least / kernel_s * 100.0
