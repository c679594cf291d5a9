"""Constraint and volume enforcers.

Reference: manager/orchestrator/constraintenforcer/constraint_enforcer.go
and manager/orchestrator/volumeenforcer/volume_enforcer.go.

The constraint enforcer shuts down running tasks whose node no longer
satisfies their placement constraints or resource reservations after a node
update (labels removed, resources shrunk).  The volume enforcer removes
tasks using volumes whose availability was set to DRAIN.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ..models.objects import Node, Service, Task, Volume
from ..models.types import NodeAvailability, TaskState, VolumeAvailability
from ..scheduler import constraint as constraint_mod
from ..state.events import Event
from ..state.store import Batch, ByNode, MemoryStore
from ..state.watch import Closed

log = logging.getLogger("enforcer")


class _EnforcerLoop:
    name = "enforcer"

    def __init__(self, store: MemoryStore):
        self.store = store
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=10)

    def run(self) -> None:
        try:
            _, sub = self.store.view_and_watch(
                self._init, predicate=self._pred, accepts_blocks=True)
            try:
                self._initial_pass()
                while not self._stop.is_set():
                    try:
                        event = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if isinstance(event, Event):
                        self._handle(event)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _init(self, tx) -> None:
        pass

    def _initial_pass(self) -> None:
        pass

    def _pred(self, ev) -> bool:
        return isinstance(ev, Event)

    def _handle(self, ev: Event) -> None:
        raise NotImplementedError


class ConstraintEnforcer(_EnforcerLoop):
    """reference: constraint_enforcer.go:33."""

    name = "constraint-enforcer"

    def _init(self, tx) -> None:
        self._initial_nodes = tx.find(Node)

    def _initial_pass(self) -> None:
        # check all nodes once at startup (reference: Run's initial scan)
        for node in self._initial_nodes:
            self.reject_noncompliant_tasks(node)

    def _pred(self, ev) -> bool:
        return (isinstance(ev, Event) and isinstance(ev.obj, Node)
                and ev.action == "update")

    def _handle(self, ev: Event) -> None:
        self.reject_noncompliant_tasks(ev.obj)

    def reject_noncompliant_tasks(self, node: Node) -> None:
        # drain is the orchestrators' job; pause means hands off
        if node.spec.availability != NodeAvailability.ACTIVE:
            return

        def read(tx):
            tasks = tx.find(Task, ByNode(node.id))
            services = {t.service_id: tx.get(Service, t.service_id)
                        for t in tasks if t.service_id}
            return tasks, services

        tasks, services = self.store.view(read)

        available_cpu = available_mem = 0
        if node.description and node.description.resources:
            available_cpu = node.description.resources.nano_cpus
            available_mem = node.description.resources.memory_bytes

        remove: List[Task] = []
        for t in tasks:
            if t.desired_state < TaskState.ASSIGNED or \
                    t.desired_state > TaskState.COMPLETE:
                continue
            # use the service's CURRENT constraints: the task's copy can be
            # outdated after constraint-only service updates
            # (reference: constraint_enforcer.go:121 comment)
            service = services.get(t.service_id)
            placement = (service.spec.task.placement if service is not None
                         else t.spec.placement)
            if placement is not None and placement.constraints:
                try:
                    constraints = constraint_mod.parse(placement.constraints)
                except constraint_mod.InvalidConstraint:
                    constraints = []
                if not constraint_mod.node_matches(constraints, node):
                    remove.append(t)
                    continue
            res = t.spec.resources.reservations if t.spec.resources else None
            if res is not None:
                if res.memory_bytes > available_mem or \
                        res.nano_cpus > available_cpu:
                    remove.append(t)
                    continue
                available_mem -= res.memory_bytes
                available_cpu -= res.nano_cpus

        if not remove:
            return

        def cb(batch: Batch) -> None:
            for t in remove:
                def one(tx, t=t):
                    cur = tx.get(Task, t.id)
                    if cur is None or \
                            cur.desired_state > TaskState.RUNNING:
                        return
                    cur = cur.copy()
                    cur.desired_state = TaskState.SHUTDOWN
                    if cur.status.state < TaskState.ASSIGNED:
                        cur.status.state = TaskState.SHUTDOWN
                        cur.status.err = \
                            "assigned node no longer meets constraints"
                    tx.update(cur)
                batch.update(one)

        try:
            self.store.batch(cb)
            log.info("shut down %d noncompliant tasks on node %s",
                     len(remove), node.id)
        except Exception:
            log.exception("constraint enforcement batch failed")


class VolumeEnforcer(_EnforcerLoop):
    """reference: volume_enforcer.go."""

    name = "volume-enforcer"

    def _pred(self, ev) -> bool:
        return (isinstance(ev, Event) and isinstance(ev.obj, Volume)
                and ev.action == "update")

    def _handle(self, ev: Event) -> None:
        volume = ev.obj
        if volume.spec.availability != VolumeAvailability.DRAIN:
            return
        tasks = self.store.view(lambda tx: tx.find(Task))
        using = [t for t in tasks
                 if any(va.id == volume.id for va in t.volumes)
                 and t.desired_state <= TaskState.RUNNING]
        if not using:
            return

        def cb(batch: Batch) -> None:
            for t in using:
                def one(tx, t=t):
                    cur = tx.get(Task, t.id)
                    if cur is None or \
                            cur.desired_state > TaskState.RUNNING:
                        return
                    cur = cur.copy()
                    cur.desired_state = TaskState.REMOVE
                    tx.update(cur)
                batch.update(one)

        try:
            self.store.batch(cb)
        except Exception:
            log.exception("volume enforcement batch failed")
