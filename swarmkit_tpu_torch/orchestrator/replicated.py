"""Replicated-service orchestrator: slot-count reconciliation.

Reference: manager/orchestrator/replicated/{replicated,services,tasks,slot}.go.

Event-loop object: collects dirty services and restart-candidate tasks from
store events, acts on commit boundaries.  Scale-up creates tasks in missing
slots; scale-down prefers slots on the most-crowded nodes (and non-running
tasks first) and marks the rest desired-REMOVE for the agent to stop and the
task reaper to delete.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from ..models.objects import Cluster, Node, Service, Task
from ..models.types import TaskState
from ..obs.trace import tracer
from ..state.events import Event, EventCommit, EventSnapshotRestore
from ..state.store import Batch, ByName, ByNode, ByService, MemoryStore
from ..state.watch import Closed
from ..utils.metrics import registry as _metrics
from . import common
from .restart import Supervisor as RestartSupervisor
from .update import Supervisor as UpdateSupervisor
from . import taskinit

log = logging.getLogger("replicated")

DEFAULT_CLUSTER_NAME = "default"  # reference: store.DefaultClusterName

# cached Timer reference (Registry.reset() resets in place)
_RECONCILE_TIMER = _metrics.timer(
    'swarm_orchestrator_reconcile{kind="replicated"}')


class Orchestrator:
    def __init__(self, store: MemoryStore,
                 restarts: Optional[RestartSupervisor] = None,
                 updater: Optional[UpdateSupervisor] = None):
        self.store = store
        self.restarts = restarts or RestartSupervisor(store)
        self.updater = updater or UpdateSupervisor(store, self.restarts)
        self.cluster: Optional[Cluster] = None
        self.reconcile_services: Dict[str, Service] = {}
        self.restart_tasks: Dict[str, None] = {}   # insertion-ordered set
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="replicated",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)
        self.updater.cancel_all()
        self.restarts.cancel_all()

    def run(self) -> None:
        try:
            def init(tx):
                for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                    self.cluster = c
                for s in tx.find(Service):
                    if common.is_replicated_service(s):
                        self.reconcile_services[s.id] = s

            # accepts_blocks: scheduler assignment blocks carry
            # state<=RUNNING transitions by store contract — never a
            # failure this loop reacts to (_handle_task_change fires on
            # state>RUNNING); node invalidation arrives as Node events
            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                # outside view_and_watch: check_tasks writes through
                # store.batch, which needs the update lock view_and_watch
                # holds; the events it causes replay through sub (idempotent)
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
        self.reconcile_services.clear()
        self.restart_tasks.clear()

        def init(tx):
            for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                self.cluster = c
            for s in tx.find(Service):
                if common.is_replicated_service(s):
                    self.reconcile_services[s.id] = s

        self.store.view(init)
        self._tick()

    # ----------------------------------------------------------- event intake

    def _handle_event(self, ev: Event) -> None:
        obj = ev.obj
        if isinstance(obj, Service):
            if not common.is_replicated_service(obj):
                return
            if ev.action == "delete":
                common.set_service_tasks_remove(self.store, obj)
                self.restarts.clear_service_history(obj.id)
                self.reconcile_services.pop(obj.id, None)
            else:
                self.reconcile_services[obj.id] = obj
        elif isinstance(obj, Task):
            if ev.action == "delete":
                if obj.desired_state <= TaskState.RUNNING and obj.service_id:
                    service = self.store.raw_get(Service, obj.service_id)
                    if common.is_replicated_service(service):
                        self.reconcile_services[service.id] = service
                self.restarts.cancel(obj.id)
            else:
                self._handle_task_change(obj)
        elif isinstance(obj, Node):
            if ev.action == "delete":
                self._restart_tasks_by_node(obj.id)
            else:
                if common.invalid_node(obj):
                    self._restart_tasks_by_node(obj.id)
        elif isinstance(obj, Cluster):
            if ev.action != "delete":
                self.cluster = obj

    def _handle_task_change(self, t: Task) -> None:
        """A task changed (usually agent status): queue restart if it died
        or its node became invalid (reference: tasks.go:120)."""
        if t.desired_state > TaskState.RUNNING:
            # a PREEMPTED task (scheduler marked it desired-SHUTDOWN to
            # make room for a higher-priority band) empties its slot
            # outside every other trigger — reconcile the service so the
            # slot requeues at its own priority
            if "swarm.preempted.at" in t.annotations.labels \
                    and t.service_id:
                service = self.store.raw_get(Service, t.service_id)
                if common.is_replicated_service(service):
                    self.reconcile_services[service.id] = service
            return
        n = self.store.raw_get(Node, t.node_id) if t.node_id else None
        service = self.store.raw_get(Service, t.service_id) \
            if t.service_id else None
        if not common.is_replicated_service(service):
            return
        if t.status.state > TaskState.RUNNING or \
                (t.node_id and common.invalid_node(n)):
            self.restart_tasks[t.id] = None

    def _restart_tasks_by_node(self, node_id: str) -> None:
        for t in self.store.view(
                lambda tx: tx.find(Task, ByNode(node_id))):
            if t.desired_state > TaskState.RUNNING:
                continue
            service = self.store.raw_get(Service, t.service_id)
            if common.is_replicated_service(service):
                self.restart_tasks[t.id] = None

    # ----------------------------------------------------------------- ticks

    def _tick(self) -> None:
        # task-level first, so restarts respond before reconciliation
        self._tick_tasks()
        self._tick_services()

    def _tick_tasks(self) -> None:
        if not self.restart_tasks:
            return
        restart_tasks, self.restart_tasks = self.restart_tasks, {}

        def cb(batch: Batch) -> None:
            for task_id in restart_tasks:
                def one(tx, task_id=task_id):
                    t = tx.get(Task, task_id)
                    if t is None or t.desired_state > TaskState.RUNNING:
                        return
                    service = tx.get(Service, t.service_id)
                    if not common.is_replicated_service(service):
                        return
                    self.restarts.restart(tx, self.cluster, service, t)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("task restart transaction failed")

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("task restart batch failed")

    def _tick_services(self) -> None:
        if not self.reconcile_services:
            return
        services, self.reconcile_services = self.reconcile_services, {}
        with tracer.span("orchestrator.reconcile", "orchestrator",
                         kind="replicated", services=len(services)):
            with _RECONCILE_TIMER.time():
                for s in services.values():
                    self._reconcile(s)

    # ------------------------------------------------------------- reconcile

    def _updatable_and_dead_slots(self, service: Service):
        """reference: slot.go:75 updatableAndDeadSlots."""
        tasks = self.store.view(
            lambda tx: tx.find(Task, ByService(service.id)))
        slots: Dict[int, List[Task]] = {}
        for t in tasks:
            slots.setdefault(t.slot, []).append(t)
        updatable: Dict[int, List[Task]] = {}
        dead: Dict[int, List[Task]] = {}
        for slot_id, slot in slots.items():
            u = self.restarts.updatable_tasks_in_slot(slot, service)
            if u:
                updatable[slot_id] = u
            else:
                dead[slot_id] = slot
        return updatable, dead

    def _reconcile(self, service: Service) -> None:
        """reference: services.go:95 reconcile."""
        cur = self.store.raw_get(Service, service.id)
        if cur is None:
            return
        service = cur
        running_slots, dead_slots = self._updatable_and_dead_slots(service)
        num_slots = len(running_slots)
        slots_slice = list(running_slots.values())
        specified = service.spec.replicated.replicas \
            if service.spec.replicated else 0

        if specified > num_slots:
            self.updater.update(self.cluster, service, slots_slice)

            def cb(batch: Batch) -> None:
                self._add_tasks(batch, service, running_slots, dead_slots,
                                specified - num_slots)
                self._delete_tasks(batch, dead_slots)

            self._safe_batch(cb)
        elif specified < num_slots:
            # running slots sort first (removal takes from the end, so
            # non-running tasks are preferentially removed); lower slot
            # numbers first on ties (reference: slot.go:20 Less)
            slots_slice.sort(key=lambda slot: (
                0 if any(t.status.state == TaskState.RUNNING for t in slot)
                else 1,
                slot[0].slot))
            # nth-copy-per-node index (1, 2, 3...) — remove highest first
            slots_by_node: Dict[str, int] = {}
            with_indices: List[Tuple[int, List[Task]]] = []
            for slot in slots_slice:
                if len(slot) == 1 and slot[0].node_id:
                    slots_by_node[slot[0].node_id] = \
                        slots_by_node.get(slot[0].node_id, 0) + 1
                    with_indices.append((slots_by_node[slot[0].node_id],
                                         slot))
                else:
                    with_indices.append((-1, slot))
            with_indices.sort(key=lambda p: (p[0] < 0, p[0]))
            sorted_slots = [slot for _, slot in with_indices]

            self.updater.update(self.cluster, service,
                                sorted_slots[:specified])

            def cb(batch: Batch) -> None:
                self._delete_tasks(batch, dead_slots)
                self._set_desired_state(batch, sorted_slots[specified:],
                                        TaskState.REMOVE)

            self._safe_batch(cb)
        else:
            def cb(batch: Batch) -> None:
                self._delete_tasks(batch, dead_slots)

            self._safe_batch(cb)
            self.updater.update(self.cluster, service, slots_slice)

    def _add_tasks(self, batch: Batch, service: Service,
                   running_slots: Dict[int, List[Task]],
                   dead_slots: Dict[int, List[Task]], count: int) -> None:
        slot = 0
        for _ in range(count):
            while True:
                slot += 1
                if slot not in running_slots:
                    break
            dead_slots.pop(slot, None)

            def one(tx, slot=slot):
                tx.create(common.new_task(self.cluster, service, slot, ""))
            try:
                batch.update(one)
            except Exception:
                log.exception("failed to create task")

    def _set_desired_state(self, batch: Batch, slots: List[List[Task]],
                           state: TaskState) -> None:
        for slot in slots:
            for t in slot:
                def one(tx, t=t):
                    cur = tx.get(Task, t.id)
                    if cur is None:
                        return
                    if cur.desired_state > state:
                        # time travel is not allowed
                        return
                    cur = cur.copy()
                    cur.desired_state = state
                    tx.update(cur)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("failed to update desired state")

    def _delete_tasks(self, batch: Batch,
                      slots: Dict[int, List[Task]]) -> None:
        for slot in slots.values():
            for t in slot:
                def one(tx, t=t):
                    try:
                        tx.delete(Task, t.id)
                    except Exception:
                        pass
                batch.update(one)

    def _safe_batch(self, cb) -> None:
        try:
            self.store.batch(cb)
        except Exception:
            log.exception("reconcile batch failed")

    # -------------------------------------------------------- taskinit hooks

    def is_related_service(self, service: Optional[Service]) -> bool:
        return common.is_replicated_service(service)

    def slot_tuple(self, t: Task) -> common.SlotTuple:
        return common.SlotTuple(service_id=t.service_id, slot=t.slot)

    def fix_task(self, batch: Batch, t: Task) -> None:
        """reference: tasks.go:157 FixTask."""
        if t.desired_state > TaskState.RUNNING:
            return
        n = self.store.raw_get(Node, t.node_id) if t.node_id else None
        service = self.store.raw_get(Service, t.service_id)
        if not common.is_replicated_service(service):
            return
        if t.status.state > TaskState.RUNNING or \
                (t.node_id and common.invalid_node(n)):
            self.restart_tasks[t.id] = None
