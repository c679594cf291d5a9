"""Global-service orchestrator: one task per constraint-matching node.

Reference: manager/orchestrator/global/global.go.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ..models.objects import Cluster, Node, Service, Task
from ..models.types import NodeAvailability, NodeState, TaskState
from ..obs.trace import tracer
from ..scheduler import constraint as constraint_mod
from ..state.events import Event, EventCommit, EventSnapshotRestore
from ..state.store import Batch, ByName, ByNode, ByService, MemoryStore
from ..state.watch import Closed
from ..utils.metrics import registry as _metrics
from . import common
from .replicated import DEFAULT_CLUSTER_NAME
from .restart import Supervisor as RestartSupervisor
from .update import Supervisor as UpdateSupervisor
from . import taskinit

log = logging.getLogger("global")

# cached Timer reference (Registry.reset() resets in place)
_RECONCILE_TIMER = _metrics.timer(
    'swarm_orchestrator_reconcile{kind="global"}')


class _GlobalService:
    __slots__ = ("service", "constraints")

    def __init__(self, service: Service):
        self.service = service
        self.constraints = []
        placement = service.spec.task.placement
        if placement and placement.constraints:
            try:
                self.constraints = constraint_mod.parse(placement.constraints)
            except constraint_mod.InvalidConstraint:
                self.constraints = []


class Orchestrator:
    def __init__(self, store: MemoryStore,
                 restarts: Optional[RestartSupervisor] = None,
                 updater: Optional[UpdateSupervisor] = None):
        self.store = store
        self.restarts = restarts or RestartSupervisor(store)
        self.updater = updater or UpdateSupervisor(store, self.restarts)
        self.cluster: Optional[Cluster] = None
        self.nodes: Dict[str, Node] = {}      # non-drained, non-down nodes
        self.global_services: Dict[str, _GlobalService] = {}
        self.restart_tasks: Dict[str, None] = {}   # insertion-ordered set
        # victims whose preemption marker already triggered a reconcile
        # (pruned on task delete; see _handle_task_change)
        self._preempt_seen: set = set()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="global",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)
        self.updater.cancel_all()
        self.restarts.cancel_all()

    def run(self) -> None:
        try:
            reconcile_ids: List[str] = []

            def init(tx):
                for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                    self.cluster = c
                for n in tx.find(Node):
                    self._update_node(n)
                for s in tx.find(Service):
                    if common.is_global_service(s):
                        self._update_service(s)
                        reconcile_ids.append(s.id)

            # accepts_blocks: assignment blocks (state<=RUNNING) are not
            # failures; _handle_task_change only reacts to state>RUNNING
            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            try:
                # outside view_and_watch: check_tasks writes through
                # store.batch, which needs the update lock view_and_watch
                # holds; the events it causes replay through sub (idempotent)
                taskinit.check_tasks(self.store, self.store.view(), self,
                                     self.restarts)
                self._tick_tasks()
                self._reconcile_services(reconcile_ids)

                while not self._stop.is_set():
                    try:
                        event = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if isinstance(event, EventSnapshotRestore):
                        self._resync()
                    elif isinstance(event, Event):
                        self._handle_event(event)
                    self._tick_tasks()
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _resync(self) -> None:
        self.nodes.clear()
        self.global_services.clear()
        self.restart_tasks.clear()
        ids: List[str] = []

        def init(tx):
            for c in tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)):
                self.cluster = c
            for n in tx.find(Node):
                self._update_node(n)
            for s in tx.find(Service):
                if common.is_global_service(s):
                    self._update_service(s)
                    ids.append(s.id)

        self.store.view(init)
        self._reconcile_services(ids)

    # ----------------------------------------------------------- event intake

    def _handle_event(self, ev: Event) -> None:
        obj = ev.obj
        if isinstance(obj, Cluster):
            if ev.action != "delete":
                self.cluster = obj
        elif isinstance(obj, Service):
            if not common.is_global_service(obj):
                return
            if ev.action == "delete":
                common.set_service_tasks_remove(self.store, obj)
                self.global_services.pop(obj.id, None)
                self.restarts.clear_service_history(obj.id)
            else:
                self._update_service(obj)
                self._reconcile_services([obj.id])
        elif isinstance(obj, Node):
            if ev.action == "delete":
                self._foreach_task_from_node(obj, self._delete_task)
                self.nodes.pop(obj.id, None)
            else:
                self._update_node(obj)
                self._reconcile_one_node(obj)
        elif isinstance(obj, Task) and ev.action == "update":
            self._handle_task_change(obj)
        elif isinstance(obj, Task) and ev.action == "delete":
            self._preempt_seen.discard(obj.id)
            # beyond the reference (global.go:164 only watches updates):
            # an out-of-band deletion (operator `task rm`) of a live
            # global task would otherwise leave its node without a
            # replica until an unrelated event arrives
            if (obj.service_id in self.global_services
                    and obj.desired_state <= TaskState.RUNNING):
                self._reconcile_services([obj.service_id])

    def _handle_task_change(self, t: Task) -> None:
        if t.service_id not in self.global_services:
            return
        if t.desired_state > TaskState.RUNNING:
            # preempted by the scheduler: the node lost its replica with
            # no node/service event to notice — reconcile to re-cover
            # it, ONCE per victim (the marker persists through the
            # victim's remaining lifecycle writes)
            if "swarm.preempted.at" in t.annotations.labels \
                    and t.id not in self._preempt_seen:
                self._preempt_seen.add(t.id)
                self._reconcile_services([t.service_id])
            return
        if t.status.state > TaskState.RUNNING:
            self.restart_tasks[t.id] = None

    # --------------------------------------------------------------- mirrors

    def _update_node(self, node: Node) -> None:
        if node.spec.availability == NodeAvailability.DRAIN or \
                node.status.state == NodeState.DOWN:
            self.nodes.pop(node.id, None)
        else:
            self.nodes[node.id] = node

    def _update_service(self, service: Service) -> None:
        self.global_services[service.id] = _GlobalService(service)

    # ------------------------------------------------------------- reconcile

    def _reconcile_services(self, service_ids: List[str]) -> None:
        """reference: global.go:254 reconcileServices."""
        with tracer.span("orchestrator.reconcile", "orchestrator",
                         kind="global", services=len(service_ids)), \
                _RECONCILE_TIMER.time():
            self._reconcile_services_inner(service_ids)

    def _reconcile_services_inner(self, service_ids: List[str]) -> None:
        node_tasks: Dict[str, Dict[str, List[Task]]] = {}

        def read(tx):
            for service_id in service_ids:
                entry = self.global_services.get(service_id)
                if entry is None:
                    continue
                by_node: Dict[str, List[Task]] = {}
                for t in tx.find(Task, ByService(service_id)):
                    by_node.setdefault(t.node_id, []).append(t)
                for node_id in list(by_node):
                    updatable = self.restarts.updatable_tasks_in_slot(
                        by_node[node_id], entry.service)
                    if updatable:
                        by_node[node_id] = updatable
                    else:
                        del by_node[node_id]
                node_tasks[service_id] = by_node

        self.store.view(read)

        updates: List[tuple] = []

        def cb(batch: Batch) -> None:
            for service_id in service_ids:
                if service_id not in node_tasks:
                    continue
                entry = self.global_services[service_id]
                update_slots: List[List[Task]] = []
                by_node = node_tasks[service_id]
                for node_id, node in self.nodes.items():
                    meets = constraint_mod.node_matches(
                        entry.constraints, node)
                    ntasks = by_node.pop(node_id, [])
                    if not meets:
                        self._shutdown_tasks(batch, ntasks)
                        continue
                    if node.spec.availability == NodeAvailability.PAUSE:
                        continue
                    if not ntasks:
                        self._add_task(batch, entry.service, node_id)
                    else:
                        update_slots.append(ntasks)
                if update_slots:
                    updates.append((entry.service, update_slots))
                # tasks on nodes that are drained or no longer exist
                for ntasks in by_node.values():
                    self._shutdown_tasks(batch, ntasks)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("global reconcile batch failed")

        for service, update_slots in updates:
            self.updater.update(self.cluster, service, update_slots)

    def _reconcile_one_node(self, node: Node) -> None:
        """reference: global.go:374 reconcileOneNode."""
        if node.spec.availability == NodeAvailability.DRAIN or \
                node.status.state == NodeState.DOWN:
            self._foreach_task_from_node(node, self._shutdown_task)
            return
        if node.spec.availability == NodeAvailability.PAUSE:
            return
        node = self.nodes.get(node.id)
        if node is None:
            return

        tasks_on_node = self.store.view(
            lambda tx: tx.find(Task, ByNode(node.id)))
        by_service: Dict[str, List[Task]] = {}
        for t in tasks_on_node:
            if t.service_id in self.global_services:
                by_service.setdefault(t.service_id, []).append(t)
        for service_id in list(by_service):
            entry = self.global_services[service_id]
            updatable = self.restarts.updatable_tasks_in_slot(
                by_service[service_id], entry.service)
            if updatable:
                by_service[service_id] = updatable
            else:
                del by_service[service_id]

        def cb(batch: Batch) -> None:
            for service_id, entry in self.global_services.items():
                if not constraint_mod.node_matches(entry.constraints, node):
                    continue
                tasks = by_service.get(service_id, [])
                if not tasks:
                    self._add_task(batch, entry.service, node.id)
                else:
                    # not a rolling update: this is node reconciliation
                    # (reference: global.go:440 comment)
                    dirty = []
                    clean = []
                    for t in tasks:
                        if common.is_task_dirty(entry.service, t, node):
                            dirty.append(t)
                        else:
                            clean.append(t)
                    if not clean:
                        self._add_task(batch, entry.service, node.id)
                    else:
                        dirty.extend(clean[1:])
                    self._shutdown_tasks(batch, dirty)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("global reconcileOneNode batch failed")

    # ----------------------------------------------------------------- ticks

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
                    if service is None:
                        return
                    node = self.nodes.get(t.node_id)
                    entry = self.global_services.get(t.service_id)
                    if node is None or entry is None:
                        return
                    if node.spec.availability == NodeAvailability.PAUSE or \
                            not constraint_mod.node_matches(
                                entry.constraints, node):
                        t = t.copy()
                        t.desired_state = TaskState.SHUTDOWN
                        tx.update(t)
                        return
                    self.restarts.restart(tx, self.cluster, service, t)
                try:
                    batch.update(one)
                except Exception:
                    log.exception("global restart transaction failed")

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("global restart batch failed")

    # --------------------------------------------------------------- helpers

    def _foreach_task_from_node(self, node: Node, fn) -> None:
        tasks = self.store.view(lambda tx: tx.find(Task, ByNode(node.id)))

        def cb(batch: Batch) -> None:
            for t in tasks:
                if t.service_id in self.global_services:
                    fn(batch, t)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("global foreachTaskFromNode batch failed")

    def _shutdown_task(self, batch: Batch, t: Task) -> None:
        def one(tx, t=t):
            cur = tx.get(Task, t.id)
            if cur is not None and cur.desired_state < TaskState.SHUTDOWN:
                cur = cur.copy()
                cur.desired_state = TaskState.SHUTDOWN
                tx.update(cur)
        try:
            batch.update(one)
        except Exception:
            log.exception("global shutdownTask failed")

    def _shutdown_tasks(self, batch: Batch, tasks: List[Task]) -> None:
        for t in tasks:
            self._shutdown_task(batch, t)

    def _add_task(self, batch: Batch, service: Service,
                  node_id: str) -> None:
        task = common.new_task(self.cluster, service, 0, node_id)

        def one(tx):
            if tx.get(Service, service.id) is None:
                return
            tx.create(task)
        try:
            batch.update(one)
        except Exception:
            log.exception("global addTask failed")

    def _delete_task(self, batch: Batch, t: Task) -> None:
        def one(tx, t=t):
            try:
                tx.delete(Task, t.id)
            except Exception:
                pass
        batch.update(one)

    # -------------------------------------------------------- taskinit hooks

    def is_related_service(self, service: Optional[Service]) -> bool:
        return common.is_global_service(service)

    def slot_tuple(self, t: Task) -> common.SlotTuple:
        return common.SlotTuple(service_id=t.service_id, node_id=t.node_id)

    def fix_task(self, batch: Batch, t: Task) -> None:
        """reference: global.go:174 FixTask."""
        if t.service_id not in self.global_services:
            return
        if t.desired_state > TaskState.RUNNING:
            return
        node = self.nodes.get(t.node_id) if t.node_id else None
        if not t.node_id or common.invalid_node(node):
            self._shutdown_task(batch, t)
            return
        if t.status.state > TaskState.RUNNING:
            self.restart_tasks[t.id] = None
