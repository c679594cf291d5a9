"""Restart supervisor: replaces failed/stopped tasks under the service's
restart policy, with delayed starts and per-slot restart history.

Reference: manager/orchestrator/restart/restart.go.

Design difference from the reference: the reference spawns one goroutine per
delayed start (cheap in Go); here a restart storm would mean thousands of
Python threads, so all delayed starts are driven by a **single timer worker**
holding a deadline heap plus one store subscription that watches for the
old-task-stopped / node-down conditions.
"""

from __future__ import annotations

import heapq
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..models.objects import Cluster, Node, Service, Task
from ..models.types import (
    NodeAvailability, NodeState, RestartCondition, TaskState, now,
)
from ..state.events import Event
from ..state.store import MemoryStore, WriteTx
from . import common

log = logging.getLogger("restart")

DEFAULT_OLD_TASK_TIMEOUT = 60.0  # reference: restart.go:20


@dataclass
class _RestartInfo:
    total_restarts: int = 0
    restarted_instances: List[float] = field(default_factory=list)
    spec_version: int = 0


class _DelayedStart:
    """One pending READY->RUNNING transition, owned by the timer worker."""

    __slots__ = ("task_id", "cancelled", "done", "waiter", "delay_deadline",
                 "wait_task_id", "wait_node_id", "waiting", "wait_deadline",
                 "callbacks")

    def __init__(self, task_id: str, delay_deadline: float,
                 wait_task_id: str, wait_node_id: str):
        self.task_id = task_id
        self.cancelled = False
        self.done = threading.Event()
        self.waiter = False
        self.delay_deadline = delay_deadline
        self.wait_task_id = wait_task_id   # "" = no wait
        self.wait_node_id = wait_node_id
        self.waiting = False               # True once in the wait-stop phase
        self.wait_deadline = 0.0
        self.callbacks: List[Callable[[], None]] = []


class Supervisor:
    def __init__(self, store: MemoryStore, start_worker: bool = True):
        """``start_worker=False`` runs no timer thread: the caller (the
        deterministic simulator) pumps ``drive()`` under its own clock —
        identical deadline/wait-stop semantics, zero threads."""
        self.store = store
        self._mu = threading.Lock()
        self._delays: Dict[str, _DelayedStart] = {}
        self._history: Dict[str, Dict[common.SlotTuple, _RestartInfo]] = {}
        self.task_timeout = DEFAULT_OLD_TASK_TIMEOUT
        self._start_worker = start_worker
        self._worker: Optional[threading.Thread] = None
        self._stopped = False
        self._heap: List = []   # (deadline, seq, _DelayedStart)
        self._seq = 0
        self._sub = None
        self._orphans: List[_DelayedStart] = []  # replaced, to be completed

    # ------------------------------------------------------------ restarting

    def restart(self, tx: WriteTx, cluster: Optional[Cluster],
                service: Service, t: Task) -> None:
        """Shut down t and create a replacement if policy allows.

        Must be called inside a store.update transaction (reference:
        restart.go:117 Restart).
        """
        with self._mu:
            old_delay = self._delays.get(t.id)
            if old_delay is not None:
                # t is itself a delayed-start replacement that has not
                # started yet; restart it after the delay completes
                # (reference: restart.go:124-139)
                if not old_delay.waiter:
                    old_delay.waiter = True
                    old_delay.callbacks.append(
                        lambda: self._restart_after_delay(cluster, t.id))
                return

        if t.desired_state > TaskState.COMPLETE:
            raise RuntimeError(
                "restart called on task that was already shut down")

        t = t.copy()
        t.desired_state = TaskState.SHUTDOWN
        tx.update(t)

        if not self._should_restart(t, service):
            return

        if common.is_replicated_service(service) \
                or common.is_replicated_job(service):
            restart_task = common.new_task(cluster, service, t.slot, "")
        elif common.is_global_service(service) \
                or common.is_global_job(service):
            restart_task = common.new_task(cluster, service, 0, t.node_id)
        else:
            log.error("service not supported by restart supervisor")
            return

        if common.is_replicated_job(service) or common.is_global_job(service):
            from ..models.types import Version
            restart_task.job_iteration = Version(
                service.job_status.job_iteration.index
                if service.job_status else 0)

        n = tx.get(Node, t.node_id) if t.node_id else None

        restart_task.desired_state = TaskState.READY

        restart_delay = 0.0
        # restart delay is not applied on drained nodes
        if n is None or n.spec.availability != NodeAvailability.DRAIN:
            if t.spec.restart is not None:
                restart_delay = t.spec.restart.delay
            else:
                restart_delay = common.DEFAULT_RESTART_DELAY

        # normally wait for the old task to stop running; skip if it's
        # already dead or its node is down
        wait_stop = not ((n is not None
                          and n.status.state == NodeState.DOWN)
                         or t.status.state > TaskState.RUNNING)

        tx.create(restart_task)

        tuple_ = common.SlotTuple(
            service_id=restart_task.service_id, slot=restart_task.slot,
            node_id=restart_task.node_id if not restart_task.slot else "")
        self.record_restart_history(tuple_, restart_task)
        self.delay_start(t, restart_task.id, restart_delay, wait_stop)

    def _restart_after_delay(self, cluster: Optional[Cluster],
                             task_id: str) -> None:
        def cb(tx: WriteTx) -> None:
            t = tx.get(Task, task_id)
            if t is None or t.desired_state > TaskState.RUNNING:
                return
            service = tx.get(Service, t.service_id)
            if service is None:
                return
            self.restart(tx, cluster, service, t)

        try:
            self.store.update(cb)
        except Exception:
            log.exception("failed to restart task after waiting for "
                          "previous restart")

    # -------------------------------------------------------------- policy

    def _should_restart(self, t: Task, service: Service) -> bool:
        condition = common.restart_condition(t)
        if condition == RestartCondition.ANY:
            if (common.is_replicated_job(service)
                    or common.is_global_job(service)) \
                    and t.status.state == TaskState.COMPLETE:
                return False
        elif condition == RestartCondition.ON_FAILURE:
            if t.status.state == TaskState.COMPLETE:
                return False
        else:  # NONE
            return False

        if t.spec.restart is None or t.spec.restart.max_attempts == 0:
            return True

        tuple_ = common.SlotTuple(service_id=t.service_id, slot=t.slot)
        if common.is_global_service(service):
            tuple_ = common.SlotTuple(service_id=t.service_id,
                                      node_id=t.node_id)

        with self._mu:
            info = self._history.get(t.service_id, {}).get(tuple_)
            if info is None or (t.spec_version is not None
                                and t.spec_version.index != info.spec_version):
                return True

            max_attempts = t.spec.restart.max_attempts
            window = t.spec.restart.window
            if not window:
                return info.total_restarts < max_attempts

            if not info.restarted_instances:
                return True

            timestamp = t.status.applied_at or t.status.timestamp or now()
            lookback = timestamp - window

            # drop restarts before the lookback window
            instances = [s for s in info.restarted_instances if s > lookback]
            info.restarted_instances = instances
            # ignore restarts that happened after this task's timestamp
            num = sum(1 for s in instances if s < timestamp)
            return num < max_attempts

    def updatable_tasks_in_slot(self, slot: common.Slot,
                                service: Service) -> common.Slot:
        """reference: restart.go:333 UpdatableTasksInSlot."""
        if not slot:
            return []
        updatable = [t for t in slot if t.desired_state <= TaskState.RUNNING]
        if updatable:
            return updatable
        from ..models.types import UpdateState
        if service.update_status is not None and \
                service.update_status.state == UpdateState.ROLLBACK_STARTED:
            return []
        newest = max(slot, key=common.task_timestamp)
        if not self._should_restart(newest, service):
            return [newest]
        return []

    def record_restart_history(self, tuple_: common.SlotTuple,
                               replacement: Task) -> None:
        if replacement.spec.restart is None \
                or replacement.spec.restart.max_attempts == 0:
            return
        with self._mu:
            per_service = self._history.setdefault(
                replacement.service_id, {})
            info = per_service.setdefault(tuple_, _RestartInfo())
            if replacement.spec_version is not None and \
                    replacement.spec_version.index != info.spec_version:
                info.total_restarts = 0
                info.restarted_instances = []
                info.spec_version = replacement.spec_version.index
            info.total_restarts += 1
            if replacement.spec.restart.window:
                info.restarted_instances.append(
                    replacement.meta.created_at or now())

    # -------------------------------------------------------- delayed starts

    def delay_start(self, old_task: Optional[Task], new_task_id: str,
                    delay: float, wait_stop: bool) -> threading.Event:
        """Move new_task READY->RUNNING after the delay elapses and the old
        task stops (or times out).  Returns the completion event
        (reference: restart.go:427 DelayStart)."""
        # a task that was never assigned has no agent to report its stop
        # — waiting on it would just burn task_timeout (rolling updates
        # replacing a still-PENDING restart replacement hit this)
        wait_for_task = (wait_stop and old_task is not None
                         and old_task.status.state <= TaskState.RUNNING
                         and (bool(old_task.node_id)
                              or old_task.status.state
                              >= TaskState.ASSIGNED))
        ds = _DelayedStart(
            new_task_id, now() + delay,
            old_task.id if wait_for_task else "",
            old_task.node_id if wait_for_task else "")
        with self._mu:
            old = self._delays.pop(new_task_id, None)
            if old is not None:
                # keep it visible to the sweep so its done event fires and
                # any waiter callbacks run promptly
                old.cancelled = True
                self._orphans.append(old)
            self._delays[new_task_id] = ds
            self._seq += 1
            heapq.heappush(self._heap, (ds.delay_deadline, self._seq, ds))
            self._ensure_worker_locked()
        if self._sub is not None:
            self._sub.wake()   # react to the new deadline without poll lag
        return ds.done

    def _ensure_worker_locked(self) -> None:
        if self._sub is None:
            # accepts_blocks: pred drops them — assignment blocks are
            # state<=RUNNING by store contract, never failures
            self._sub = self.store.queue.subscribe(
                self._event_pred, accepts_blocks=True)
        if not self._start_worker:
            return   # simulator mode: drive() pumps instead of a thread
        if self._worker is None or not self._worker.is_alive():
            self._stopped = False
            self._worker = threading.Thread(
                target=self._worker_loop, name="restart-timer", daemon=True)
            self._worker.start()

    def drive(self) -> None:
        """One synchronous pump of the timer machinery (start_worker=False
        mode): handle buffered stop events, sweep cancellations, fire due
        deadlines.  Exactly one _worker_loop iteration, minus the thread
        and the blocking get — the simulator calls this every control
        step under virtual time."""
        from ..state.watch import Subscription
        if self._sub is None:
            if self._stopped:
                return   # deposed: never resubscribe a dead supervisor
            with self._mu:
                self._ensure_worker_locked()
        while True:
            # re-read per iteration: a stop event's completion write
            # pumps consensus (virtual time), and a deposal inside that
            # pump runs stop() re-entrantly, nulling the subscription
            sub = self._sub
            if sub is None:
                return
            ev = sub.poll()
            if ev is None:
                break
            if ev is not Subscription.WAKE:
                self._handle_stop_event(ev)
        self._sweep_cancelled()
        self._fire_due()

    @staticmethod
    def _event_pred(ev) -> bool:
        if not isinstance(ev, Event):
            return False
        obj = ev.obj
        if isinstance(obj, Task):
            # a deleted task (reaper cleanup) can never report a stop —
            # release its waiters instead of sitting out task_timeout
            return (ev.action == "delete"
                    or (ev.action == "update"
                        and obj.status.state > TaskState.RUNNING))
        if isinstance(obj, Node):
            return (ev.action == "delete"
                    or (ev.action == "update"
                        and obj.status.state == NodeState.DOWN))
        return False

    def _worker_loop(self) -> None:
        from ..state.watch import Closed, Subscription
        while not self._stopped:
            with self._mu:
                deadline = self._heap[0][0] if self._heap else None
            timeout = 0.2 if deadline is None else \
                min(0.2, max(0.0, deadline - now()))
            ev = None
            try:
                ev = self._sub.get(timeout=timeout) if timeout > 0 else None
            except TimeoutError:
                pass
            except Closed:
                break
            if ev is not None and ev is not Subscription.WAKE:
                self._handle_stop_event(ev)
            self._sweep_cancelled()
            self._fire_due()
        # final pass: complete whatever remains so done events always fire
        self._sweep_cancelled()

    def _handle_stop_event(self, ev: Event) -> None:
        """An old task stopped or its node died: release waiting entries."""
        obj = ev.obj
        ready: List[_DelayedStart] = []
        with self._mu:
            for ds in self._delays.values():
                if not ds.waiting or ds.cancelled:
                    continue
                if (isinstance(obj, Task) and obj.id == ds.wait_task_id) or \
                        (isinstance(obj, Node) and obj.id == ds.wait_node_id):
                    ready.append(ds)
        for ds in ready:
            self._complete(ds)

    def _sweep_cancelled(self) -> None:
        with self._mu:
            cancelled = [ds for ds in self._delays.values()
                         if ds.cancelled and not ds.done.is_set()]
            cancelled.extend(self._orphans)
            self._orphans = []
        for ds in cancelled:
            self._complete(ds)

    def _fire_due(self) -> None:
        ts = now()
        while True:
            with self._mu:
                if not self._heap or self._heap[0][0] > ts:
                    return
                _, _, ds = heapq.heappop(self._heap)
                if ds.done.is_set():
                    continue
                if not ds.cancelled and not ds.waiting and ds.wait_task_id:
                    # delay elapsed; wait only if the old task may still
                    # stop gracefully: it reads <= RUNNING *and* its node is
                    # alive (a node that died during the delay phase will
                    # never report the stop — don't sit out task_timeout)
                    cur = self.store.raw_get(Task, ds.wait_task_id)
                    node = self.store.raw_get(Node, ds.wait_node_id) \
                        if ds.wait_node_id else None
                    node_dead = (ds.wait_node_id
                                 and (node is None or node.status.state
                                      == NodeState.DOWN))
                    if cur is not None and not node_dead and \
                            cur.status.state <= TaskState.RUNNING:
                        ds.waiting = True
                        ds.wait_deadline = ts + self.task_timeout
                        self._seq += 1
                        heapq.heappush(self._heap,
                                       (ds.wait_deadline, self._seq, ds))
                        continue
            self._complete(ds)

    def _complete(self, ds: _DelayedStart) -> None:
        """Fire the READY->RUNNING transition and mark done.  Runs outside
        _mu: start_now and the callbacks take store locks, and restart()
        (which can run inside a store transaction) takes _mu — completing
        under _mu would invert that order."""
        with self._mu:
            if ds.done.is_set():
                return
            cancelled = ds.cancelled
        if not cancelled:
            try:
                self.start_now(ds.task_id)
            except Exception:
                log.exception("moving task to RUNNING failed")
        with self._mu:
            if ds.done.is_set():
                return
            if self._delays.get(ds.task_id) is ds:
                del self._delays[ds.task_id]
            callbacks, ds.callbacks = ds.callbacks, []
            ds.done.set()
        for cb in callbacks:
            try:
                cb()
            except Exception:
                log.exception("delayed-start callback failed")

    def start_now_tx(self, tx: WriteTx, task_id: str) -> None:
        """Move the task out of its delayed state inside an open
        transaction: job tasks (those carrying a job_iteration) run to
        desired COMPLETE, service tasks to desired RUNNING (reference:
        restart.go StartNow's JobIteration branch)."""
        t = tx.get(Task, task_id)
        if t is None or t.desired_state >= TaskState.RUNNING:
            return
        t = t.copy()
        t.desired_state = (TaskState.COMPLETE if t.job_iteration is not None
                           else TaskState.RUNNING)
        tx.update(t)

    def start_now(self, task_id: str) -> None:
        """Moves the task to the RUNNING state (reference: StartNow)."""
        self.store.update(lambda tx: self.start_now_tx(tx, task_id))

    def cancel(self, task_id: str) -> None:
        with self._mu:
            ds = self._delays.get(task_id)
            if ds is not None:
                ds.cancelled = True
        if ds is not None:
            if self._sub is not None:
                self._sub.wake()
            ds.done.wait(timeout=5)

    def cancel_all(self) -> None:
        with self._mu:
            for ds in self._delays.values():
                ds.cancelled = True
        if self._sub is not None:
            self._sub.wake()

    def stop(self) -> None:
        """Shut the timer worker down (manager demotion/shutdown)."""
        self.cancel_all()
        self._stopped = True
        if self._sub is not None:
            # closing the subscription pops the worker out of get(); its
            # exit path runs a final sweep so pending done events fire
            self.store.queue.unsubscribe(self._sub)
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        self._sub = None
        # belt-and-braces: if the worker was wedged, complete leftovers here
        with self._mu:
            leftovers = ([ds for ds in self._delays.values()
                          if not ds.done.is_set()] + self._orphans)
            self._orphans = []
        for ds in leftovers:
            self._complete(ds)

    def clear_service_history(self, service_id: str) -> None:
        with self._mu:
            self._history.pop(service_id, None)
