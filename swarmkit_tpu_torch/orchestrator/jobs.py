"""Jobs orchestrator: run-to-completion replicated and global jobs.

Reference: manager/orchestrator/jobs/{orchestrator.go,replicated/
reconciler.go,global/reconciler.go}.

A shared event-loop orchestrator with one reconciler per job mode.
Replicated jobs fill ``total_completions`` unique slots, at most
``max_concurrent`` in flight; global jobs run one completion per
constraint-matching node per job iteration.  Tasks carry the service's
``job_iteration``; tasks from older iterations are marked REMOVE.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set

from ..models.objects import Cluster, Node, Service, Task
from ..models.types import NodeAvailability, TaskState, Version
from ..scheduler import constraint as constraint_mod
from ..state.events import Event, EventCommit, EventSnapshotRestore
from ..state.store import Batch, ByName, ByService, MemoryStore
from ..state.watch import Closed
from . import common, taskinit
from .replicated import DEFAULT_CLUSTER_NAME
from .restart import Supervisor as RestartSupervisor

log = logging.getLogger("jobs")


class ReplicatedJobReconciler:
    """reference: jobs/replicated/reconciler.go."""

    def __init__(self, store: MemoryStore,
                 restarts: RestartSupervisor):
        self.store = store
        self.restarts = restarts

    def reconcile_service(self, service_id: str,
                          cluster: Optional[Cluster]) -> None:
        def read(tx):
            return (tx.get(Service, service_id),
                    tx.find(Task, ByService(service_id)))

        service, tasks = self.store.view(read)
        if service is None or not common.is_replicated_job(service):
            return
        job_version = (service.job_status.job_iteration.index
                       if service.job_status else 0)
        rj = service.spec.replicated_job
        if rj is None:
            return
        total = rj.total_completions
        max_concurrent = rj.max_concurrent or total

        running = 0
        complete = 0
        restart_tasks: List[str] = []
        remove_tasks: List[str] = []
        slots: Set[int] = set()
        for t in tasks:
            it = t.job_iteration.index if t.job_iteration else 0
            if it == job_version:
                if t.status.state == TaskState.COMPLETE:
                    complete += 1
                    slots.add(t.slot)
                elif t.desired_state <= TaskState.COMPLETE:
                    running += 1
                    slots.add(t.slot)
                    if t.status.state > TaskState.COMPLETE:
                        restart_tasks.append(t.id)
            else:
                if t.status.state <= TaskState.RUNNING and \
                        t.desired_state != TaskState.REMOVE:
                    remove_tasks.append(t.id)

        new_tasks = min(max_concurrent - running,
                        total - complete - running)
        new_tasks = max(new_tasks, 0)

        def cb(batch: Batch) -> None:
            slot = 0
            for _ in range(new_tasks):
                while slot in slots:
                    slot += 1
                slots.add(slot)

                def create(tx, slot=slot):
                    if tx.get(Service, service_id) is None:
                        return
                    task = common.new_task(cluster, service, slot, "")
                    task.job_iteration = Version(index=job_version)
                    task.desired_state = TaskState.COMPLETE
                    tx.create(task)
                batch.update(create)
            for task_id in restart_tasks:
                def restart(tx, task_id=task_id):
                    t = tx.get(Task, task_id)
                    if t is None or t.desired_state > TaskState.COMPLETE:
                        return
                    self.restarts.restart(tx, cluster, service, t)
                batch.update(restart)
            for task_id in remove_tasks:
                def remove(tx, task_id=task_id):
                    t = tx.get(Task, task_id)
                    if t is None or t.desired_state == TaskState.REMOVE:
                        return
                    t = t.copy()
                    t.desired_state = TaskState.REMOVE
                    tx.update(t)
                batch.update(remove)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("replicated job reconcile failed")


class GlobalJobReconciler:
    """reference: jobs/global/reconciler.go."""

    def __init__(self, store: MemoryStore,
                 restarts: RestartSupervisor):
        self.store = store
        self.restarts = restarts

    def reconcile_service(self, service_id: str,
                          cluster: Optional[Cluster]) -> None:
        def read(tx):
            return (tx.get(Service, service_id),
                    tx.find(Task, ByService(service_id)),
                    tx.find(Node))

        service, tasks, nodes = self.store.view(read)
        if service is None or not common.is_global_job(service):
            return
        job_version = (service.job_status.job_iteration.index
                       if service.job_status else 0)
        constraints = []
        placement = service.spec.task.placement
        if placement and placement.constraints:
            try:
                constraints = constraint_mod.parse(placement.constraints)
            except constraint_mod.InvalidConstraint:
                constraints = []

        covered: Set[str] = set()
        restart_tasks: List[str] = []
        remove_tasks: List[str] = []
        for t in tasks:
            it = t.job_iteration.index if t.job_iteration else 0
            if it != job_version:
                if t.status.state <= TaskState.RUNNING and \
                        t.desired_state != TaskState.REMOVE:
                    remove_tasks.append(t.id)
                continue
            if t.status.state == TaskState.COMPLETE or \
                    t.desired_state <= TaskState.COMPLETE:
                covered.add(t.node_id)
                if TaskState.COMPLETE < t.status.state and \
                        t.desired_state <= TaskState.COMPLETE:
                    restart_tasks.append(t.id)

        def cb(batch: Batch) -> None:
            for node in nodes:
                if node.id in covered:
                    continue
                if common.invalid_node(node) or \
                        node.spec.availability == NodeAvailability.PAUSE:
                    continue
                if not constraint_mod.node_matches(constraints, node):
                    continue

                def create(tx, node_id=node.id):
                    if tx.get(Service, service_id) is None:
                        return
                    task = common.new_task(cluster, service, 0, node_id)
                    task.job_iteration = Version(index=job_version)
                    task.desired_state = TaskState.COMPLETE
                    tx.create(task)
                batch.update(create)
            for task_id in restart_tasks:
                def restart(tx, task_id=task_id):
                    t = tx.get(Task, task_id)
                    if t is None or t.desired_state > TaskState.COMPLETE:
                        return
                    self.restarts.restart(tx, cluster, service, t)
                batch.update(restart)
            for task_id in remove_tasks:
                def remove(tx, task_id=task_id):
                    t = tx.get(Task, task_id)
                    if t is None or t.desired_state == TaskState.REMOVE:
                        return
                    t = t.copy()
                    t.desired_state = TaskState.REMOVE
                    tx.update(t)
                batch.update(remove)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("global job reconcile failed")


class Orchestrator:
    """reference: jobs/orchestrator.go:34."""

    def __init__(self, store: MemoryStore,
                 restarts: Optional[RestartSupervisor] = None):
        self.store = store
        self.restarts = restarts or RestartSupervisor(store)
        self.replicated = ReplicatedJobReconciler(store, self.restarts)
        self.global_ = GlobalJobReconciler(store, self.restarts)
        self.cluster: Optional[Cluster] = None
        self._dirty: Set[str] = set()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="jobs",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)
        self.restarts.cancel_all()

    def run(self) -> None:
        try:
            def init(tx):
                for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                    self.cluster = c
                for s in tx.find(Service):
                    if common.is_replicated_job(s) or common.is_global_job(s):
                        self._dirty.add(s.id)

            # accepts_blocks: a job task's ASSIGNED flip changes neither
            # the desired-state running count nor completions, so
            # assignment blocks need no reconcile
            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                taskinit.check_tasks(self.store, self.store.view(), self,
                                     self.restarts)
                self._tick()
                while not self._stop.is_set():
                    try:
                        event = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if isinstance(event, EventCommit):
                        self._tick()
                    elif isinstance(event, EventSnapshotRestore):
                        self._resync()
                    elif isinstance(event, Event):
                        self._handle_event(event)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _resync(self) -> None:
        self._dirty.clear()

        def init(tx):
            for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                self.cluster = c
            for s in tx.find(Service):
                if common.is_replicated_job(s) or common.is_global_job(s):
                    self._dirty.add(s.id)

        self.store.view(init)
        self._tick()

    def _handle_event(self, ev: Event) -> None:
        obj = ev.obj
        if isinstance(obj, Cluster):
            if ev.action != "delete":
                self.cluster = obj
        elif isinstance(obj, Service):
            if not (common.is_replicated_job(obj)
                    or common.is_global_job(obj)):
                return
            if ev.action == "delete":
                common.set_service_tasks_remove(self.store, obj)
                self.restarts.clear_service_history(obj.id)
                self._dirty.discard(obj.id)
            else:
                self._dirty.add(obj.id)
        elif isinstance(obj, Task):
            if obj.service_id and ev.action in ("update", "delete"):
                service = self.store.raw_get(Service, obj.service_id)
                if common.is_replicated_job(service) or \
                        common.is_global_job(service):
                    self._dirty.add(obj.service_id)
        elif isinstance(obj, Node) and ev.action in ("create", "update"):
            # a new/recovered node may need global-job tasks
            for s in self.store.view(lambda tx: tx.find(Service)):
                if common.is_global_job(s):
                    self._dirty.add(s.id)

    def _tick(self) -> None:
        if not self._dirty:
            return
        dirty, self._dirty = self._dirty, set()
        for service_id in dirty:
            service = self.store.raw_get(Service, service_id)
            if service is None:
                continue
            if common.is_replicated_job(service):
                self.replicated.reconcile_service(service_id, self.cluster)
            elif common.is_global_job(service):
                self.global_.reconcile_service(service_id, self.cluster)

    # -------------------------------------------------------- taskinit hooks

    def is_related_service(self, service: Optional[Service]) -> bool:
        return common.is_replicated_job(service) or \
            common.is_global_job(service)

    def slot_tuple(self, t: Task) -> common.SlotTuple:
        if t.slot:
            return common.SlotTuple(service_id=t.service_id, slot=t.slot)
        return common.SlotTuple(service_id=t.service_id, node_id=t.node_id)

    def fix_task(self, batch: Batch, t: Task) -> None:
        if t.service_id:
            self._dirty.add(t.service_id)
