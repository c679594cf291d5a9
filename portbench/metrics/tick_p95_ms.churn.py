"""tick_p95_ms.churn: the 95th percentile (nearest rank) of the wall time
of every tick in the window, in ms; the harness's clock."""

import math


def read(rec):
    ticks = sorted(st["tick_s"] for st in rec.steps)
    if not ticks:
        return None
    return ticks[math.ceil(0.95 * len(ticks)) - 1] * 1e3
