"""Seeded single-threaded event loop with trace recording.

Everything in a simulation — raft ticks, message deliveries, agent
heartbeats, control-plane steps, fault injections — is an event on one
heap ordered by (virtual time, sequence number).  Sequence numbers break
ties deterministically, and the only randomness anywhere is
``engine.rng`` (or generators seeded from it), so a run is a pure
function of its seed.  The trace records every event execution; its
SHA-256 is the run's identity — two runs with the same seed must produce
the same hash, byte for byte.
"""

from __future__ import annotations

import hashlib
import heapq
import random
from typing import Callable, List

from .clock import VirtualClock


class SimEngine:
    def __init__(self, seed: int):
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = VirtualClock()
        self._heap: list = []        # (time, seq, label, fn)
        self._seq = 0
        self._cancelled: set = set()
        self.trace: List[str] = []
        self.events_run = 0
        self.max_events = 2_000_000  # runaway backstop
        # member ids currently under a clock-skew fault (SimManager's
        # tick_scale setter maintains it).  Shared on the engine because
        # skew ANYWHERE voids every leader's lease math — the read plane
        # checks this set before honoring a lease read.
        self.clock_skew_members: set = set()

    # ------------------------------------------------------------ scheduling

    def at(self, t: float, label: str, fn: Callable[[], None]) -> int:
        """Schedule ``fn`` at absolute virtual time ``t``; returns an id
        usable with cancel()."""
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, label, fn))
        return self._seq

    def after(self, dt: float, label: str, fn: Callable[[], None]) -> int:
        return self.at(self.clock.time() + max(0.0, dt), label, fn)

    def every(self, interval: float, label: str,
              fn: Callable[[], object], phase: float = 0.0) -> None:
        """Repeating event.  ``fn`` returning False stops the series."""

        def run():
            if fn() is False:
                return
            self.after(interval, label, run)

        self.after(phase if phase > 0 else interval, label, run)

    def cancel(self, event_id: int) -> None:
        self._cancelled.add(event_id)

    # --------------------------------------------------------------- running

    def run_until(self, t_end: float) -> None:
        """Pop events in order until virtual time reaches ``t_end``.

        Re-entrant: an event handler may itself call ``run_until`` (the
        raft-attached control plane blocks on consensus by pumping
        virtual time from inside a control step — see
        ``SimRaftProposer.wait_proposal``).  The inner call consumes
        heap events up to ITS deadline; the outer loop simply finds them
        gone.  Still single-threaded and heap-ordered, so determinism is
        untouched — only the clock clamp below is needed, because an
        inner pump may have advanced time past the outer deadline."""
        end = self.clock.start + t_end
        while self._heap and self._heap[0][0] <= end:
            t, seq, label, fn = heapq.heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self.clock.advance_to(max(t, self.clock.time()))
            self.events_run += 1
            if self.events_run > self.max_events:
                raise RuntimeError("simulation exceeded max_events")
            fn()
        self.clock.advance_to(max(end, self.clock.time()))

    # ----------------------------------------------------------------- trace

    def log(self, msg: str) -> None:
        self.trace.append(f"{self.clock.elapsed():.6f} {msg}")

    def trace_hash(self) -> str:
        h = hashlib.sha256()
        for line in self.trace:
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def fork_rng(self) -> random.Random:
        """A child RNG seeded from the engine stream: components that
        consume randomness at their own cadence (raft election jitter,
        per-agent failure draws) get independent deterministic streams."""
        return random.Random(self.rng.getrandbits(64))
