"""feed_ms.churn: a window's store writes (arrivals, exits) and the
watch feed that brings them to the scheduler, median per window, in ms;
the harness's clock."""

from portbench.readers import median_ms


def read(rec):
    return median_ms(rec, lambda st: st["write_s"] + st["feed_s"])
