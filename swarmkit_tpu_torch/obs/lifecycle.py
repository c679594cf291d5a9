"""Task-lifecycle latency tracker.

The reference instruments exactly one FSM edge — the dispatcher's
scheduling-delay timer (dispatcher.go:72-77, time from task creation to
the node receiving it).  This generalizes that to *every* forward edge of
the task FSM: created→pending, pending→assigned, assigned→accepted, …,
starting→running.  Each observed edge feeds a labeled registry timer

    swarm_task_lifecycle{from="pending",to="assigned"}

so ``/metrics`` exports per-edge p50/p90/p99, and ``summary()`` gives the
same numbers programmatically (bench/tests).

Latencies are computed from the *stamped* status timestamps (and
``meta.created_at`` for the creation edge), not from observation time —
so the numbers measure the control plane, not the watcher's queue, and
are deterministic under the simulator's virtual clock.

Use it two ways:

* passively — call ``handle_event(ev)`` from an existing event loop
  (the simulator, tests);
* actively — ``start()``/``stop()`` runs a store-subscribed thread like
  manager.metrics.Collector (the Manager wires this).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..models.objects import Task
from ..models.types import TERMINAL_STATES, TaskState
from ..state.events import Event, EventSnapshotRestore, EventTaskBlock
from ..state.watch import Closed
from ..utils.metrics import Registry
from ..utils.metrics import registry as _default_registry


def _edge_timer_name(frm: str, to: str) -> str:
    return f'swarm_task_lifecycle{{from="{frm}",to="{to}"}}'


def service_edge_timer_name(service_id: str) -> str:
    """Per-service pending->assigned timer (the autoscaler's
    ``target_p99`` signal — orchestrator/autoscaler.py reads it)."""
    return f'swarm_task_lifecycle_service{{service="{service_id}"}}'


#: bounded per-service timer cardinality: beyond this many distinct
#: services the per-service edge stops growing new timers (counted on
#: ``swarm_task_lifecycle_service_overflow``) — the global edge timer
#: keeps covering them, so no latency sample is ever lost
SERVICE_TIMER_CAP = 64


class LifecycleTracker:
    def __init__(self, store=None, registry: Optional[Registry] = None):
        self.store = store
        self.registry = registry or _default_registry
        self._mu = threading.Lock()
        # task id -> (state, stamped timestamp of that state)
        self._last: Dict[str, Tuple[int, float]] = {}
        # services with a per-service pending->assigned timer (bounded)
        self._svc_timers: Dict[str, None] = {}
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- observing

    def _observe_edge(self, from_state: int, to_state: int,
                      dt: float, service_id: str = "") -> None:
        frm = ("created" if from_state < 0
               else TaskState(from_state).name.lower())
        to = TaskState(to_state).name.lower()
        self.registry.timer(_edge_timer_name(frm, to)).observe(
            max(0.0, dt))
        # the scheduling-latency edge additionally feeds a per-service
        # timer (bounded cardinality) so per-service SLO policies — the
        # autoscaler's target_p99 — read their OWN signal instead of
        # the cluster-wide aggregate
        if (service_id
                and from_state == int(TaskState.PENDING)
                and to_state == int(TaskState.ASSIGNED)):
            if service_id not in self._svc_timers:
                if len(self._svc_timers) >= SERVICE_TIMER_CAP:
                    self.registry.counter(
                        "swarm_task_lifecycle_service_overflow")
                    return
                self._svc_timers[service_id] = None
            self.registry.timer(
                service_edge_timer_name(service_id)).observe(
                max(0.0, dt))

    def observe_task(self, t: Task, old: Optional[Task] = None) -> None:
        """Record the FSM edge a create/update event represents."""
        state = int(t.status.state)
        ts = t.status.timestamp or 0.0
        with self._mu:
            prev = self._last.get(t.id)
            if prev is None and old is not None:
                prev = (int(old.status.state), old.status.timestamp or 0.0)
            if prev is None:
                # first sighting: the creation edge, off meta.created_at
                created = t.meta.created_at if t.meta else 0.0
                if created and ts >= created:
                    self._observe_edge(-1, state, ts - created)
            elif state > prev[0]:
                if prev[1]:
                    self._observe_edge(prev[0], state, ts - prev[1],
                                       getattr(t, "service_id", ""))
            else:
                # same-state refresh or a backward write (never a forward
                # edge): keep the earlier stamp
                return
            if TaskState(state) in TERMINAL_STATES:
                self._last.pop(t.id, None)
            else:
                self._last[t.id] = (state, ts)

    def forget(self, task_id: str) -> None:
        with self._mu:
            self._last.pop(task_id, None)

    def handle_event(self, ev) -> None:
        if isinstance(ev, EventTaskBlock):
            # columnar assignment: N edges stamped with one shared ts
            for old in ev.olds:
                self.observe_task(_BlockView(old, ev.state, ev.ts), old)
            return
        if isinstance(ev, EventSnapshotRestore):
            with self._mu:
                self._last.clear()
            return
        if isinstance(ev, Event) and isinstance(ev.obj, Task):
            if ev.action == "delete":
                self.forget(ev.obj.id)
            else:
                self.observe_task(ev.obj, ev.old)

    # --------------------------------------------------------------- summary

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{"pending->assigned": {"count": n, "p50": s, ...}, ...}"""
        out: Dict[str, Dict[str, float]] = {}
        prefix = "swarm_task_lifecycle{"
        for name, timer in list(self.registry.timers.items()):
            if not name.startswith(prefix):
                continue
            labels = name[len(prefix):-1]
            parts = dict(p.split("=", 1) for p in labels.split(","))
            edge = (parts['from'].strip('"') + "->"
                    + parts['to'].strip('"'))
            q = timer.quantiles()
            out[edge] = {"count": timer.count,
                         "total": timer.total,
                         **{f"p{int(k * 100)}": v for k, v in q.items()}}
        return out

    # ------------------------------------------------------- store-attached

    def start(self) -> None:
        if self.store is None:
            raise RuntimeError("LifecycleTracker needs a store to start()")
        self._thread = threading.Thread(target=self.run, name="lifecycle",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._done.wait(timeout=5)

    def run(self) -> None:
        try:
            def init(tx):
                for t in tx.find(Task):
                    state = int(t.status.state)
                    if TaskState(state) not in TERMINAL_STATES:
                        self._last[t.id] = (state,
                                            t.status.timestamp or 0.0)

            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                while not self._stop.is_set():
                    try:
                        ev = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    self.handle_event(ev)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()


class _BlockView:
    """Minimal Task-shaped view of one block-committed assignment (id +
    new status), avoiding per-task materialization on the watch path."""

    __slots__ = ("id", "meta", "status", "service_id")

    def __init__(self, old: Task, state: int, ts: float):
        self.id = old.id
        self.meta = old.meta
        self.service_id = old.service_id
        self.status = _StatusView(state, ts)


class _StatusView:
    __slots__ = ("state", "timestamp")

    def __init__(self, state: int, ts: float):
        self.state = state
        self.timestamp = ts
