"""h2d_ms.churn: device time of the host-to-device copies (torch.profiler
Memcpy HtoD rows), per tick, in ms."""

from portbench.readers import device_ms_per_tick


def read(rec):
    return device_ms_per_tick(rec, lambda name: "HtoD" in name)
