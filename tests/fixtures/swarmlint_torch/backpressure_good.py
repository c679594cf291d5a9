"""Fixture: the same hot paths with backpressure discipline (clean).

Each growth site from the bad twin, fixed the sanctioned way: an
admission check against a ``max_*`` knob with a counted shed, a
``maxlen`` deque (self-bounding), an evict pass in the same method, or
the growth moved off the hot path entirely.
"""

import heapq
from collections import deque


class Dispatcher:
    def __init__(self, config):
        self.config = config
        self._updates = []
        self._intake = deque(maxlen=1024)   # self-bounding: exempt
        self._wheel = []
        self._sheds = 0

    def update_task_status(self, node_id, session_id, updates):
        # admission check against the declared bound, counted shed
        if len(self._updates) + len(updates) > self.config.max_pending_updates:
            self._sheds += len(updates)
            raise OverflowError("overloaded: shed counted")
        for u in updates:
            self._updates.append(u)

    def heartbeat(self, node_id, session_id):
        # maxlen deque: the container bounds itself
        self._intake.appendleft((node_id, session_id))

    def register(self, node_id, description):
        # evict the expired tail before admitting a new deadline
        evicted = 0
        while self._wheel and self._wheel[0][0] < 0:
            heapq.heappop(self._wheel)
            evicted += 1
        heapq.heappush(self._wheel, (0.0, node_id))


class Scheduler:
    def __init__(self, config):
        self.config = config
        self._queue = deque()

    def _enqueue(self, tasks):
        # partial admission up to the tick budget; remainder deferred
        room = self.config.max_queue_depth - len(self._queue)
        self._queue.extend(tasks[:room])
        return tasks[room:]
