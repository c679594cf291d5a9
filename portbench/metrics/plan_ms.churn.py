"""plan_ms.churn: TorchPlanner.stats["plan_seconds"] over the window, per
tick, in ms."""

from portbench.readers import planner_ms_per_tick


def read(rec):
    return planner_ms_per_tick(rec, "plan_seconds")
