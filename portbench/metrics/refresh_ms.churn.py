"""refresh_ms.churn: the program's span plan.refresh (the streaming
resident state brought up to date), per tick, in ms."""

from portbench.readers import span_ms_per_tick


def read(rec):
    return span_ms_per_tick(rec, "plan.refresh")
