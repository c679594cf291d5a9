"""device_busy.churn: the union of the device rows' intervals over the
traced window, in %."""

from portbench.readers import busy_share


def read(rec):
    return busy_share(rec)
