"""The device's side of a traced window, from ``torch.profiler``.

The profile records the device's activity (kernels, copies and the
runtime's launch calls; no CPU operators, which would slow the host it
measures).  It starts with ``PROFILE_WARM`` throwaway kernels whose rows
are kept out of every sum (``chip_smoke.py``'s procedure, copied: once a
process has run a traced tick, the profiler loses the first kernel rows
of every later profile).  The device rows come from the profile's raw events,
where each carries its launch call's correlation id.  One more launch
right after a reading of the host clock puts the device rows on the
tracer's clock (epoch seconds), so idle time can be named by the host
span around it.
"""

from __future__ import annotations

import heapq
import time
from collections import Counter
from typing import List, Tuple

PROFILE_WARM = 512


class DeviceTrace:
    """Device rows of one window: ``rows`` ((name, start, seconds) on the
    epoch clock), ``window`` (start, end) and ``missing`` (launches of the
    window that show no device row)."""

    def __init__(self, torch):
        self.torch = torch
        self.rows: List[Tuple[str, float, float]] = []
        self.window = (0.0, 0.0)
        self.missing = 0
        self._prof = None

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        warm = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(PROFILE_WARM):
            warm.add_(1)
        torch.cuda.synchronize()
        self._mark = time.time()
        warm.add_(1)                  # the clock mark's launch
        torch.cuda.synchronize()

    def stop(self, start: float, end: float) -> None:
        from torch.autograd import DeviceType
        self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        launches = sorted((e for e in events
                           if e.device_type() != DeviceType.CUDA
                           and "Launch" in e.name()),
                          key=lambda e: e.start_ns())
        if len(launches) <= PROFILE_WARM:
            raise RuntimeError(
                f"the profiler recorded {len(launches)} launch calls, no "
                f"more than the {PROFILE_WARM} of its warm-up")
        offset = self._mark - launches[PROFILE_WARM].start_ns() / 1e9
        warm_ids = {e.correlation_id()
                    for e in launches[:PROFILE_WARM + 1]}
        device = [e for e in events if e.device_type() == DeviceType.CUDA]
        seen = {e.correlation_id() for e in device}
        self.missing = sum(e.correlation_id() not in seen
                           for e in launches[PROFILE_WARM + 1:])
        self.rows = sorted(
            (e.name(), e.start_ns() / 1e9 + offset, e.duration_ns() / 1e9)
            for e in device if e.correlation_id() not in warm_ids)
        self.rows.sort(key=lambda r: r[1])
        self.window = (start, end)

    # ------------------------------------------------------------ reading

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the rows' intervals inside the window: a copy that
        overlaps a kernel counts once."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, s, d in self.rows:
            a, b = max(s, lo), min(s + d, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def seconds_where(self, keep) -> float:
        return sum(d for name, _, d in self.rows if keep(name))

    def top_ops(self, n: int = 10) -> List[list]:
        by = Counter()
        for name, _, d in self.rows:
            by[name[:120]] += d
        return [[name, s] for name, s in by.most_common(n)]

    def idle_gaps(self, spans, n: int = 10) -> List[list]:
        """The device's idle time inside the window, split by the
        innermost host span (the latest started of those open) at each
        instant; ``(none)`` outside every span."""
        lo, hi = self.window
        idle, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        if hi > t:
            idle.append((t, hi))
        ordered = sorted((sp for sp in spans if sp[2] > lo and sp[1] < hi),
                         key=lambda sp: sp[1])
        cuts = sorted({lo, hi} | {x for sp in ordered for x in sp[1:3]
                                  if lo < x < hi})
        by = Counter()
        open_: List[tuple] = []       # heap of (-start, end, index): the
        #                               latest start, then the first end
        nxt = j = 0
        for a, b in zip(cuts, cuts[1:]):
            while nxt < len(ordered) and ordered[nxt][1] <= a:
                heapq.heappush(open_, (-ordered[nxt][1], ordered[nxt][2],
                                       nxt))
                nxt += 1
            while open_ and open_[0][1] <= a:
                heapq.heappop(open_)  # closed; the next latest may be open
            name = ordered[open_[0][2]][0] if open_ else "(none)"
            while j < len(idle) and idle[j][1] <= a:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < b:
                by[name] += min(b, idle[k][1]) - max(a, idle[k][0])
                k += 1
        return [[name, s] for name, s in by.most_common(n)]


def is_copy(name: str) -> bool:
    """A copy or memset row rather than a kernel."""
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")
