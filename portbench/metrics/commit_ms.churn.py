"""commit_ms.churn: the program's span sched.commit, per tick, in ms."""

from portbench.readers import span_ms_per_tick


def read(rec):
    return span_ms_per_tick(rec, "sched.commit")
