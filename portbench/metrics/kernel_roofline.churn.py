"""kernel_roofline.churn: the least time the windows' plans need at the
card's published peaks (metrics/roofline.py) over the device time of the
kernel rows, in %."""

from portbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec)
