"""Rolling-update supervisor: one Updater per service, a
parallelism-bounded window of in-flight slot replacements, start-first/
stop-first ordering, failure monitoring with pause/rollback.

Reference: manager/orchestrator/update/updater.go.

Design difference from the reference (and from this module's first
shape): the updater is an explicit state machine pumped by ``drive()``
instead of one goroutine per slot.  Production runs it on a single
thread per updater (``Supervisor(start_worker=True)``: the thread loops
drive + event wait); the deterministic simulator constructs the
supervisor with ``start_worker=False`` and pumps ``drive()`` from its
control step under virtual time — same FSM, zero threads, mirroring
orchestrator/restart.py.  All deadlines (batch delay, monitor window)
read time through the ``models.types.now()`` seam, and every store
write rides ``store.update`` — which pins the proposal to the
leadership epoch read at commit start, so a deposed leader's rollout
writes are fenced, not silently committed.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional

from ..models.objects import Cluster, Service, Task
from ..models.types import (
    TaskState, UpdateFailureAction, UpdateOrder, UpdateState, UpdateStatus,
    now,
)
from ..state.events import Event
from ..state.store import MemoryStore, WriteTx
from ..utils.metrics import registry as _metrics
from . import common
from .restart import Supervisor as RestartSupervisor

log = logging.getLogger("update")


def _specs_equal(a, b) -> bool:
    return a is b or dataclasses.asdict(a) == dataclasses.asdict(b)


def _state_gauge(service_id: str, state: UpdateState) -> None:
    _metrics.gauge(f'swarm_update_state{{service="{service_id}"}}',
                   float(int(state)))


def _clear_state_gauge(service_id: str) -> None:
    """Service gone mid-rollout: park the state gauge at -1 (no update)
    so the ``stuck_rollout`` health check stops judging a frozen
    UPDATING stamp for a service that no longer exists."""
    _metrics.gauge(f'swarm_update_state{{service="{service_id}"}}', -1.0)


def _progress_gauge(service_id: str) -> None:
    """Stamp of the update's last forward progress; the ``stuck_rollout``
    health check fails when an UPDATING service stops moving for longer
    than its monitor window (obs/health.py)."""
    _metrics.gauge(
        f'swarm_update_last_progress{{service="{service_id}"}}', now())


def _edge_timer(edge: str, dt: float) -> None:
    _metrics.timer(f'swarm_update_rollout{{edge="{edge}"}}').observe(dt)


class Supervisor:
    """Tracks at most one in-flight Updater per service
    (reference: updater.go:26)."""

    def __init__(self, store: MemoryStore, restarts: RestartSupervisor,
                 start_worker: bool = True):
        """``start_worker=False`` spawns no threads: the caller (the
        deterministic simulator's control step) pumps ``drive()`` under
        its own clock — identical FSM semantics, zero threads."""
        self.store = store
        self.restarts = restarts
        self._start_worker = start_worker
        self._mu = threading.Lock()
        self._updates: Dict[str, "Updater"] = {}

    def update(self, cluster: Optional[Cluster], service: Service,
               slots: List[common.Slot]) -> None:
        with self._mu:
            existing = self._updates.get(service.id)
            if existing is not None and not existing.finished:
                if _specs_equal(service.spec, existing.new_service.spec):
                    return  # already working towards this goal
                # blocking cancel serializes updaters per service: the old
                # one must be fully out of its slots before the new one
                # touches them (reference: updater.go:56-61).  Threadless
                # mode aborts synchronously (same thread); threaded mode
                # waits for the drive loop to exit — safe under _mu, the
                # loop sets its done event before the cleanup closure
                # re-takes _mu.
                existing.cancel()
            updater = Updater(self.store, self.restarts, cluster, service,
                              threadless=not self._start_worker)
            self._updates[service.id] = updater

        if not self._start_worker:
            updater.begin(slots)
            return

        def run():
            updater.run(slots)
            with self._mu:
                if self._updates.get(service.id) is updater:
                    del self._updates[service.id]

        threading.Thread(target=run, name=f"updater-{service.id[:8]}",
                         daemon=True).start()

    def drive(self) -> None:
        """One synchronous pump of every in-flight updater
        (start_worker=False mode); finished updaters are reaped.  A
        store-write failure (leadership loss) propagates to the caller —
        the simulator's control step handles the deposal."""
        with self._mu:
            updaters = list(self._updates.items())
        for service_id, u in updaters:
            if not u.finished:
                u.drive()
            if u.finished:
                with self._mu:
                    if self._updates.get(service_id) is u:
                        del self._updates[service_id]

    def cancel_all(self) -> None:
        with self._mu:
            updates = list(self._updates.values())
        for u in updates:
            u.cancel()


class _SlotState:
    """One in-flight slot replacement.  Phases:

    * ``delay``    — waiting for the restart supervisor's delayed start
                     (old task stopping / restart delay) to complete
    * ``running``  — waiting for the replacement task to reach RUNNING
                     (or any terminal state; failures are accounted by
                     the monitor, not re-waited here)
    * ``cooldown`` — per-batch ``delay`` between slots, occupying a
                     parallelism window seat (reference worker sleep)
    """

    __slots__ = ("slot", "uid", "phase", "delay_done", "deadline",
                 "start_first")

    def __init__(self, slot: common.Slot):
        self.slot = slot
        self.uid = ""          # replacement task id ("" = none created)
        self.phase = "delay"
        self.delay_done = None  # threading.Event from delay_start
        self.deadline = 0.0     # cooldown deadline
        self.start_first = False


class Updater:
    """Updates one service's slots to the new spec
    (reference: updater.go:85)."""

    #: checker-sensitivity seam (tests/test_update_chaos.py): when False,
    #: a failure-threshold PAUSE still writes the paused status but does
    #: NOT halt the rollout — the sim's pause-on-failure-threshold
    #: invariant must catch the update claiming new slots while paused.
    _pause_halts = True

    def __init__(self, store: MemoryStore, restarts: RestartSupervisor,
                 cluster: Optional[Cluster], new_service: Service,
                 threadless: bool = False):
        self.store = store
        self.restarts = restarts
        self.cluster = cluster.copy() if cluster else None
        self.new_service = new_service.copy()
        self.threadless = threadless
        self.finished = False
        self._stop = threading.Event()
        self._done = threading.Event()
        self._mu = threading.Lock()
        self._updated_tasks: Dict[str, float] = {}  # id -> RUNNING stamp
        # ----- FSM state
        self._pending: List[common.Slot] = []
        self._in_flight: List[_SlotState] = []
        self._monitor_deadline: Optional[float] = None
        self._sub = None
        self._failed_tasks: set = set()
        self._total_failures = 0
        self._stopped = False
        self._rollback = False
        self._config = None
        self._monitoring_period = 30.0
        self._parallelism = 1
        self._n_dirty = 0
        self._watch_failures = False

    def cancel(self) -> None:
        """Stop the rollout without completing it.  Never writes the
        store (a deposed leader's teardown must not stage writes)."""
        self._stop.set()
        if self.threadless:
            self._abort()
            return
        if self._sub is not None:
            self._sub.wake()
        # must outlast the drive loop so per-service serialization holds:
        # a successor updater may not start while this one can still
        # touch slots
        self._done.wait(timeout=30)

    # ------------------------------------------------------------ threaded

    def run(self, slots: List[common.Slot]) -> None:
        """Threaded entry point: begin + drive loop on one thread."""
        from ..state.watch import Closed
        try:
            self.begin(slots)
            while not self.finished:
                if self._stop.is_set():
                    self._abort()
                    break
                self.drive()
                if self.finished or self._sub is None:
                    break
                try:
                    ev = self._sub.get(timeout=0.2)
                except TimeoutError:
                    continue
                except Closed:
                    self._abort()
                    break
                self._intake(ev)
        except Exception:
            log.exception("updater failed")
            self._abort()
        finally:
            self._abort()   # no-op when already finished cleanly
            self._done.set()

    # ----------------------------------------------------------------- begin

    def begin(self, slots: List[common.Slot]) -> None:
        """Classify slots and start the FSM.  May finish immediately
        (paused service, nothing dirty)."""
        service = self.new_service
        us = service.update_status
        if us is not None and us.state in (UpdateState.PAUSED,
                                           UpdateState.ROLLBACK_PAUSED):
            self._finish()
            return

        dirty_slots = [s for s in slots if self._is_slot_dirty(s)]
        if not dirty_slots:
            if us is not None and us.state in (UpdateState.UPDATING,
                                               UpdateState.ROLLBACK_STARTED):
                self._complete_update(service.id)
            self._finish()
            return

        if us is None:
            self._start_update(service.id)

        self._rollback = us is not None and \
            us.state == UpdateState.ROLLBACK_STARTED
        self._config = common.update_config_for(service, self._rollback)
        self._monitoring_period = self._config.monitor or 30.0
        if self._config.delay >= self._monitoring_period:
            self._monitoring_period = self._config.delay + 1.0
        self._parallelism = self._config.parallelism or len(dirty_slots)
        self._n_dirty = len(dirty_slots)
        self._watch_failures = (self._config.failure_action
                                != UpdateFailureAction.CONTINUE)
        _metrics.gauge(
            f'swarm_update_monitor{{service="{service.id}"}}',
            self._monitoring_period)
        self._pending = list(dirty_slots)

        sid = service.id

        def pred(ev):
            # every update event for this service's tasks: failures feed
            # the monitor, >=RUNNING flips complete in-flight slots.
            # accepts_blocks below, but blocks (EventTaskBlock) fail the
            # isinstance and are dropped: assignment blocks carry only
            # scheduler-band states, the RUNNING flip and every failure
            # arrive as per-object events (store contract)
            return (isinstance(ev, Event) and ev.action == "update"
                    and isinstance(ev.obj, Task)
                    and ev.obj.service_id == sid)

        self._sub = self.store.queue.subscribe(pred, accepts_blocks=True)
        self.drive()

    # ----------------------------------------------------------------- drive

    def drive(self) -> None:
        """One synchronous pump: intake task events, advance the
        in-flight window, refill it, run the monitor window, complete."""
        if self.finished:
            return
        if self._stop.is_set():
            self._abort()
            return
        # 1. event intake (failures + RUNNING flips)
        if self._sub is not None:
            from ..state.watch import Subscription
            while True:
                ev = self._sub.poll()
                if ev is None:
                    break
                if ev is not Subscription.WAKE:
                    self._intake(ev)
                if self.finished:
                    return
        # 2. advance in-flight slots
        ts = now()
        still = []
        for ss in self._in_flight:
            self._advance_slot(ss, ts)
            if ss.phase != "done":
                still.append(ss)
            else:
                _progress_gauge(self.new_service.id)
        self._in_flight = still
        if self.finished or self._stopped:
            if self._stopped:
                self._finish()
            return
        # 3. refill the window
        while self._pending and len(self._in_flight) < self._parallelism:
            slot = self._pending.pop(0)
            try:
                ss = self._begin_slot(slot)
            except Exception:
                if self.threadless:
                    raise   # sim: leadership loss handled by the caller
                log.exception("update failed")
                continue
            if self.finished or self._stopped:
                if self._stopped:
                    self._finish()
                return
            if ss is not None:
                self._advance_slot(ss, now())
                if ss.phase != "done":
                    self._in_flight.append(ss)
        # 4. monitor window, then completion
        if self._pending or self._in_flight:
            return
        if self._monitor_deadline is None:
            if not self._watch_failures:
                # CONTINUE never monitors (reference parity)
                self._complete_update(self.new_service.id)
                self._finish()
                return
            self._monitor_deadline = now() + self._monitoring_period
            return
        if now() >= self._monitor_deadline:
            self._complete_update(self.new_service.id)
            self._finish()

    def _finish(self) -> None:
        if self.finished:
            return
        self.finished = True
        if self._sub is not None:
            try:
                self.store.queue.unsubscribe(self._sub)
            except Exception:
                pass
            self._sub = None
        self._done.set()

    def _abort(self) -> None:
        """Teardown without completion and WITHOUT store writes."""
        self._stopped = True
        self._finish()

    # ---------------------------------------------------------- event intake

    def _intake(self, ev) -> None:
        if not isinstance(ev, Event) or not isinstance(ev.obj, Task):
            return
        t = ev.obj
        state = TaskState(t.status.state)
        if self._watch_failures and state > TaskState.RUNNING:
            self._on_failure(t)

    def _slot_running(self, ss: _SlotState, t: Task,
                      state: TaskState) -> None:
        """The replacement reached RUNNING (or died trying — the monitor
        accounts failures; this slot's wait is over either way).  In
        start-first order the old task comes down only on a LIVE
        replacement (state == RUNNING exactly): a replacement observed
        already-dead keeps the old task serving — even when RUNNING
        flashed by between two pumps — and the next reconcile re-dirties
        the slot once the restart supervisor produces a survivor."""
        with self._mu:
            self._updated_tasks[ss.uid] = now()
        if ss.start_first and state == TaskState.RUNNING:
            def rm(tx: WriteTx) -> None:
                self._remove_old_tasks(tx, ss.slot)
            try:
                self.store.update(rm)
            except Exception:
                if self.threadless:
                    raise
                log.exception("failed to remove old task after starting "
                              "replacement")
        self._enter_cooldown(ss)

    def _on_failure(self, failed_task: Task) -> bool:
        """reference: updater.go:222 — one failure may trip the
        configured failure action once the ratio threshold is crossed."""
        if failed_task.id in self._failed_tasks:
            return False
        with self._mu:
            started_at = self._updated_tasks.get(failed_task.id)
        if started_at is None:
            return False
        if started_at and now() - started_at > self._monitoring_period:
            return False
        self._failed_tasks.add(failed_task.id)
        self._total_failures += 1
        if (self._total_failures / self._n_dirty
                <= self._config.max_failure_ratio):
            return False
        action = self._config.failure_action
        if action == UpdateFailureAction.PAUSE or \
                (action == UpdateFailureAction.ROLLBACK and self._rollback):
            # never roll back a rollback: it pauses instead
            kind = "rollback" if self._rollback else "update"
            self._pause_update(
                self.new_service.id,
                f"{kind} paused due to failure or early termination "
                f"of task {failed_task.id}")
            if self._pause_halts:
                self._stopped = True
                self._finish()
            return True
        if action == UpdateFailureAction.ROLLBACK:
            self._rollback_update(
                self.new_service.id,
                "update rolled back due to failure or early "
                f"termination of task {failed_task.id}")
            self._stopped = True
            self._finish()
            return True
        return False

    # -------------------------------------------------------------- slot FSM

    def _advance_slot(self, ss: _SlotState, ts: float) -> None:
        if ss.phase == "delay":
            if ss.delay_done is None or ss.delay_done.is_set():
                if ss.uid:
                    ss.phase = "running"
                else:
                    self._enter_cooldown(ss)   # reused task: no wait
        if ss.phase == "running":
            # poll the row rather than the event stream: the RUNNING flip
            # may have committed while this slot was still in its delay
            # phase, and a consumed event cannot be re-observed (events
            # still wake the threaded loop and feed the failure monitor)
            t = self.store.raw_get(Task, ss.uid)
            if t is None:
                self._enter_cooldown(ss)   # replacement vanished
            else:
                state = TaskState(t.status.state)
                if state >= TaskState.RUNNING:
                    self._slot_running(ss, t, state)
        if ss.phase == "cooldown" and ts >= ss.deadline:
            ss.phase = "done"

    def _enter_cooldown(self, ss: _SlotState) -> None:
        if self._config is not None and self._config.delay:
            ss.phase = "cooldown"
            ss.deadline = now() + self._config.delay
        else:
            ss.phase = "done"

    def _begin_slot(self, slot: common.Slot) -> Optional[_SlotState]:
        """Start updating one slot; returns its in-flight state, or
        None when the slot needed no work and no cooldown applies."""
        running_task = None
        clean_task = None
        for t in slot:
            if not self._is_task_dirty(t):
                if t.desired_state == TaskState.RUNNING:
                    running_task = t
                    break
                if t.desired_state < TaskState.RUNNING:
                    clean_task = t
        if running_task is not None:
            return self._use_existing_task(slot, running_task)
        if clean_task is not None:
            return self._use_existing_task(slot, clean_task)

        ss = _SlotState(slot)
        node_id = ""
        if common.is_global_service(self.new_service):
            node_id = slot[0].node_id
        updated = common.new_task(
            self.cluster, self.new_service, slot[0].slot, node_id)
        updated.desired_state = TaskState.READY
        ss.uid = updated.id
        ss.start_first = (self._config.order == UpdateOrder.START_FIRST)
        with self._mu:
            self._updated_tasks[ss.uid] = 0.0

        def txn(tx: WriteTx) -> None:
            """Atomically create the updated task and bring down the old
            one (reference: updater.go:367)."""
            if tx.get(Service, updated.service_id) is None:
                raise RuntimeError("service was deleted")
            tx.create(updated)
            if ss.start_first:
                ss.delay_done = self.restarts.delay_start(
                    None, ss.uid, 0.0, False)
            else:
                old_task = self._remove_old_tasks(tx, slot)
                ss.delay_done = self.restarts.delay_start(
                    old_task, ss.uid, 0.0, True)

        self.store.update(txn)
        return ss

    def _use_existing_task(self, slot: common.Slot,
                           existing: Task) -> Optional[_SlotState]:
        remove = [t for t in slot if t is not existing]
        if not remove and existing.desired_state == TaskState.RUNNING:
            # nothing to change; the cooldown still paces the window
            if self._config is not None and self._config.delay:
                ss = _SlotState(slot)
                self._enter_cooldown(ss)
                return ss
            return None
        ss = _SlotState(slot)

        def txn(tx: WriteTx) -> None:
            old_task = self._remove_old_tasks(tx, remove) if remove else None
            if existing.desired_state != TaskState.RUNNING:
                ss.delay_done = self.restarts.delay_start(
                    old_task, existing.id, 0.0, True)

        self.store.update(txn)
        return ss

    def _remove_old_tasks(self, tx: WriteTx,
                          remove: common.Slot) -> Optional[Task]:
        """Shut down the given tasks; returns one that was shut down
        (reference: updater.go:493)."""
        removed = None
        for original in remove:
            if original.desired_state > TaskState.RUNNING:
                continue
            t = tx.get(Task, original.id)
            if t is None:
                continue
            if t.desired_state > TaskState.RUNNING:
                continue
            t = t.copy()
            t.desired_state = TaskState.SHUTDOWN
            tx.update(t)
            removed = t
        return removed

    # ------------------------------------------------------------ dirtiness

    def _is_task_dirty(self, t: Task) -> bool:
        from ..models.objects import Node
        n = self.store.raw_get(Node, t.node_id) if t.node_id else None
        return common.is_task_dirty(self.new_service, t, n)

    def _is_slot_dirty(self, slot: common.Slot) -> bool:
        return len(slot) > 1 or (len(slot) == 1
                                 and self._is_task_dirty(slot[0]))

    # -------------------------------------------------------- status writes

    def _start_update(self, service_id: str) -> None:
        state = {}

        def cb(tx: WriteTx) -> None:
            service = tx.get(Service, service_id)
            if service is None:
                state["deleted"] = True
                return
            if service.update_status is not None:
                return
            service = service.copy()
            service.update_status = UpdateStatus(
                state=UpdateState.UPDATING, started_at=now(),
                message="update in progress")
            state["new"] = UpdateState.UPDATING
            tx.update(service)

        self._status_update(cb, "mark update in progress", service_id,
                            state)

    def _pause_update(self, service_id: str, message: str) -> None:
        state = {}

        def cb(tx: WriteTx) -> None:
            service = tx.get(Service, service_id)
            if service is None:
                state["deleted"] = True
                return
            if service.update_status is None:
                return
            service = service.copy()
            state["started"] = service.update_status.started_at
            if service.update_status.state == UpdateState.ROLLBACK_STARTED:
                service.update_status.state = UpdateState.ROLLBACK_PAUSED
                state["edge"] = "rollback_to_paused"
            else:
                service.update_status.state = UpdateState.PAUSED
                state["edge"] = "updating_to_paused"
            service.update_status.message = message
            state["new"] = service.update_status.state
            tx.update(service)

        self._status_update(cb, "pause update", service_id, state)

    def _rollback_update(self, service_id: str, message: str) -> None:
        state = {}

        def cb(tx: WriteTx) -> None:
            service = tx.get(Service, service_id)
            if service is None:
                state["deleted"] = True
                return
            if service.update_status is None:
                return
            service = service.copy()
            state["started"] = service.update_status.started_at
            state["edge"] = "updating_to_rollback"
            state["new"] = UpdateState.ROLLBACK_STARTED
            service.update_status.state = UpdateState.ROLLBACK_STARTED
            service.update_status.message = message
            if service.previous_spec is None:
                raise RuntimeError("cannot roll back service because no "
                                   "previous spec is available")
            service.spec = service.previous_spec
            service.spec_version = (service.previous_spec_version.copy()
                                    if service.previous_spec_version else None)
            service.previous_spec = None
            service.previous_spec_version = None
            tx.update(service)

        self._status_update(cb, "start rollback", service_id, state)

    def _complete_update(self, service_id: str) -> None:
        state = {}

        def cb(tx: WriteTx) -> None:
            service = tx.get(Service, service_id)
            if service is None:
                state["deleted"] = True
                return
            if service.update_status is None:
                return
            service = service.copy()
            state["started"] = service.update_status.started_at
            if service.update_status.state == UpdateState.ROLLBACK_STARTED:
                service.update_status.state = UpdateState.ROLLBACK_COMPLETED
                service.update_status.message = "rollback completed"
                state["edge"] = "rollback_to_completed"
            else:
                service.update_status.state = UpdateState.COMPLETED
                service.update_status.message = "update completed"
                state["edge"] = "updating_to_completed"
            service.update_status.completed_at = now()
            state["new"] = service.update_status.state
            tx.update(service)

        self._status_update(cb, "mark update complete", service_id, state)

    def _status_update(self, cb, what: str, service_id: str,
                       state: Optional[dict] = None) -> None:
        """Run a status transaction; on success export the state gauge,
        the rollout edge timer, and the progress stamp (observability
        only fires for commits that actually happened)."""
        try:
            self.store.update(cb)
        except Exception:
            if self.threadless:
                raise   # sim: leadership loss must reach the control step
            log.exception("failed to %s", what)
            return
        if state is None:
            return
        if state.get("deleted"):
            # the service vanished mid-rollout: without this, the gauge
            # stays frozen at UPDATING and stuck_rollout fails forever
            # for a service that no longer exists
            _clear_state_gauge(service_id)
            return
        if state.get("new") is not None:
            _state_gauge(service_id, state["new"])
            if state.get("edge"):
                _edge_timer(state["edge"], now() - state.get("started", 0.0))
            # progress only for status writes that actually changed the
            # row: a no-oping callback (status already set) must not
            # keep a stuck rollout looking fresh to the stuck_rollout
            # health check
            _progress_gauge(service_id)
