"""Virtual time for deterministic simulation.

The control plane reads wall-clock time through one seam —
``models.types.now()`` — so installing a VirtualClock there puts every
timestamp, heartbeat TTL, debounce window, and orphan deadline under the
simulator's control.  Time only moves when the engine pops the next
event; nothing ever sleeps.
"""

from __future__ import annotations

from ..models import types as _types

# virtual epoch: an arbitrary but fixed "wall clock" origin so task
# timestamps look like real times in dumps and compare correctly
SIM_EPOCH = 1_700_000_000.0


class VirtualClock:
    def __init__(self, start: float = SIM_EPOCH):
        self._now = start
        self.start = start

    def time(self) -> float:
        return self._now

    def elapsed(self) -> float:
        return self._now - self.start

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"time went backwards: {t} < {self._now}")
        self._now = t

    def install(self) -> None:
        """Route models.types.now() through this clock."""
        _types.set_time_source(self.time)

    @staticmethod
    def uninstall() -> None:
        _types.set_time_source(None)

    def __enter__(self) -> "VirtualClock":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
