"""Fixture: unbounded intake on dispatcher/scheduler hot paths (fires).

Linted AS IF at swarmkit_tpu_torch/manager/fixture.py — every class below
grows an agent-sized container on a session-gated RPC edge or a named
intake edge with no admission knob and no counted fallback.
"""

import heapq
from collections import deque


class Dispatcher:
    def __init__(self):
        self._updates = []            # one entry per agent report
        self._intake = deque()        # no maxlen: agents size it
        self._wheel = []              # deadline heap
        self._backlog = []

    def update_task_status(self, node_id, session_id, updates):
        # RPC edge: whatever the fleet sends, we keep (fires)
        for u in updates:
            self._updates.append(u)

    def heartbeat(self, node_id, session_id):
        # every heartbeat leaves a permanent residue (fires)
        self._intake.appendleft((node_id, session_id))

    def register(self, node_id, description):
        # admission without admission control (fires, heappush form)
        heapq.heappush(self._wheel, (0.0, node_id))


class Scheduler:
    def __init__(self):
        self._queue = deque()

    def _enqueue(self, tasks):
        # scheduler intake edge, batch form (fires)
        self._queue.extend(tasks)
