"""Task reaper: deletes historic tasks beyond TaskHistoryRetentionLimit and
tasks marked desired-REMOVE once shut down.

Reference: manager/orchestrator/taskreaper/task_reaper.go.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set

from ..models.objects import Cluster, Service, Task
from ..models.specs import ServiceMode
from ..models.types import TaskState
from ..state.events import Event
from ..state.store import (
    Batch, ByDesiredState, ByName, ByNode, BySlot, ByTaskState, MemoryStore,
)
from ..state.watch import Closed
from . import common
from .replicated import DEFAULT_CLUSTER_NAME

log = logging.getLogger("taskreaper")

MAX_DIRTY = 1000                  # reference: task_reaper.go:17
REAPER_BATCHING_INTERVAL = 0.250  # reference: task_reaper.go:19


def _task_in_terminal_state(t: Task) -> bool:
    return t.status.state > TaskState.RUNNING


def _task_will_never_run(t: Task) -> bool:
    return (t.status.state < TaskState.ASSIGNED
            and t.desired_state > TaskState.RUNNING)


class TaskReaper:
    def __init__(self, store: MemoryStore):
        self.store = store
        self.task_history = 5
        self.dirty: Set[common.SlotTuple] = set()
        self.cleanup: List[str] = []
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="taskreaper",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)

    def run(self) -> None:
        try:
            def init(tx):
                for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                    self.task_history = \
                        c.spec.orchestration.task_history_retention_limit
                orphaned = tx.find(Task, ByTaskState(TaskState.ORPHANED))
                removed = tx.find(Task, ByDesiredState(TaskState.REMOVE))
                for t in orphaned:
                    # serviceless orphans can be cleaned right away; service
                    # tasks go through regular history cleanup
                    if not t.service_id:
                        self.cleanup.append(t.id)
                for t in removed:
                    if (t.status.state < TaskState.ASSIGNED
                            or t.status.state >= TaskState.COMPLETE):
                        self.cleanup.append(t.id)

            # accepts_blocks: reaping triggers on creates, orphaned and
            # REMOVE-desired terminal states — assignment blocks
            # (state<=RUNNING by store contract) match none of those
            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                if self.cleanup:
                    self.tick()
                deadline: Optional[float] = None
                from ..models.types import now
                while not self._stop.is_set():
                    timeout = 0.2 if deadline is None else \
                        max(0.0, min(0.2, deadline - now()))
                    event = None
                    try:
                        event = sub.get(timeout=timeout) if timeout > 0 \
                            else None
                    except TimeoutError:
                        pass
                    except Closed:
                        return
                    if event is not None and isinstance(event, Event):
                        self._handle_event(event)
                        if len(self.dirty) + len(self.cleanup) > MAX_DIRTY:
                            deadline = None
                            self.tick()
                        elif deadline is None:
                            deadline = now() + REAPER_BATCHING_INTERVAL
                    elif deadline is not None and now() >= deadline:
                        deadline = None
                        self.tick()
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _handle_event(self, ev: Event) -> None:
        obj = ev.obj
        if isinstance(obj, Task):
            if ev.action == "create":
                self.dirty.add(common.SlotTuple(
                    service_id=obj.service_id, slot=obj.slot,
                    node_id=obj.node_id))
            elif ev.action == "update":
                t = obj
                if t.status.state >= TaskState.ORPHANED and not t.service_id:
                    self.cleanup.append(t.id)
                if t.desired_state == TaskState.REMOVE and (
                        t.status.state < TaskState.ASSIGNED
                        or t.status.state >= TaskState.COMPLETE):
                    self.cleanup.append(t.id)
        elif isinstance(obj, Cluster) and ev.action == "update":
            self.task_history = \
                obj.spec.orchestration.task_history_retention_limit

    def tick(self) -> None:
        """reference: task_reaper.go:231 tick."""
        if not self.dirty and not self.cleanup:
            return
        delete_tasks: Set[str] = set(self.cleanup)
        self.cleanup = []

        def read(tx):
            for dirty in list(self.dirty):
                service = tx.get(Service, dirty.service_id)
                if service is None:
                    self.dirty.discard(dirty)
                    continue
                task_history = self.task_history
                # MaxAttempts forces retention for restart-history rebuild
                restart = service.spec.task.restart
                if restart is not None and restart.max_attempts > 0:
                    task_history = restart.max_attempts + 1
                if task_history < 0:
                    self.dirty.discard(dirty)
                    continue

                if service.spec.mode == ServiceMode.REPLICATED:
                    historic = tx.find(
                        Task, BySlot(dirty.service_id, dirty.slot))
                elif service.spec.mode == ServiceMode.GLOBAL:
                    historic = [t for t in tx.find(Task, ByNode(dirty.node_id))
                                if t.service_id == dirty.service_id]
                else:
                    # jobs keep their history until service deletion
                    self.dirty.discard(dirty)
                    continue

                if len(historic) <= task_history:
                    self.dirty.discard(dirty)
                    continue

                historic.sort(key=common.task_timestamp)

                running = 0
                for t in historic:
                    if _task_in_terminal_state(t) or _task_will_never_run(t):
                        delete_tasks.add(t.id)
                        task_history += 1
                        if len(historic) <= task_history:
                            break
                    else:
                        running += 1
                # keep the slot dirty only while >1 running tasks remain
                if running <= 1:
                    self.dirty.discard(dirty)

        self.store.view(read)

        if delete_tasks:
            def cb(batch: Batch) -> None:
                for task_id in delete_tasks:
                    def one(tx, task_id=task_id):
                        try:
                            tx.delete(Task, task_id)
                        except Exception:
                            pass
                    batch.update(one)
            try:
                self.store.batch(cb)
            except Exception:
                log.exception("task reaper cleanup batch failed")
