"""Retry queue with exponential backoff.

Reference: volumequeue/volumequeue.go — a queue of IDs that pops items
only when their retry deadline passes, doubling the wait on each re-enqueue
up to a cap.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Optional, Tuple

BASE_RETRY_INTERVAL = 0.1    # reference: volumequeue.go baseRetryInterval
MAX_RETRY_INTERVAL = 600.0   # reference: maxRetryInterval


class VolumeQueue:
    def __init__(self, clock=None) -> None:
        # injectable monotonic time source (deterministic simulation seam);
        # wait() still blocks on the condition using real timeouts, but all
        # deadline arithmetic goes through the clock
        self._clock = clock or time.monotonic
        self._cond = threading.Condition()
        self._heap: list = []            # (ready_at, seq, id)
        self._attempts: Dict[str, int] = {}
        self._pending: Dict[str, float] = {}  # id -> ready_at (dedupe)
        self._seq = 0
        self._closed = False

    def enqueue(self, id: str, retry: bool = False) -> None:
        """Queue an id.  ``retry=False`` (new work) is immediate and does
        not grow the backoff; ``retry=True`` (the operation failed) delays
        by the id's exponential backoff and bumps it — mirroring the
        reference's explicit retry counts (volumequeue.go Enqueue)."""
        with self._cond:
            if retry:
                attempts = self._attempts.get(id, 0) + 1
                self._attempts[id] = attempts
                delay = min(BASE_RETRY_INTERVAL * (2 ** (attempts - 1)),
                            MAX_RETRY_INTERVAL)
            else:
                delay = 0.0
            ready = self._clock() + delay
            if id in self._pending and self._pending[id] <= ready:
                return  # already queued sooner
            self._pending[id] = ready
            self._seq += 1
            heapq.heappush(self._heap, (ready, self._seq, id))
            self._cond.notify()

    def forget(self, id: str) -> None:
        """The operation succeeded: reset backoff state."""
        with self._cond:
            self._attempts.pop(id, None)
            self._pending.pop(id, None)

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Pop the next due id, blocking until one is due (or timeout)."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._closed:
                    return None
                now = self._clock()
                while self._heap and self._heap[0][0] <= now:
                    ready, _, id = heapq.heappop(self._heap)
                    # deliver only the entry matching the CURRENT deadline:
                    # superseded entries (e.g. pre-backoff ones) are stale
                    # and must not fire a retry early
                    if self._pending.get(id) == ready:
                        self._pending.pop(id, None)
                        return id
                if self._heap:
                    wait_for = self._heap[0][0] - now
                else:
                    wait_for = None
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait_for = remaining if wait_for is None \
                        else min(wait_for, remaining)
                self._cond.wait(wait_for)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
