"""Shared orchestration helpers: slots, task factory, dirtiness checks.

Reference: manager/orchestrator/{task.go,slot.go,service.go}.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..models.objects import Cluster, Node, Service, Task
from ..models.specs import ServiceMode
from ..models.types import (
    Endpoint, NodeAvailability, NodeState, RestartCondition, TaskState,
    TaskStatus, UpdateConfig, UpdateFailureAction, now,
)
from ..scheduler import constraint as constraint_mod
# the single priority accessor — defined next to the selection logic
# that consumes it, re-exported here for orchestrator-side callers
from ..scheduler.preempt import task_priority  # noqa: F401
from ..state.store import Batch, MemoryStore, ReadTx
from ..utils import new_id

# compile-time defaults (reference: api/defaults/service.go)
DEFAULT_RESTART_DELAY = 5.0
DEFAULT_UPDATE_CONFIG = UpdateConfig(
    parallelism=1, failure_action=UpdateFailureAction.PAUSE, monitor=30.0)
DEFAULT_ROLLBACK_CONFIG = UpdateConfig(
    parallelism=1, failure_action=UpdateFailureAction.PAUSE, monitor=30.0)

# Slot: the running tasks occupying one slot; usually a single task, but
# rolling updates can briefly hold two (reference: slot.go:11).
Slot = List[Task]


@dataclass(frozen=True)
class SlotTuple:
    """(service, slot) for replicated; (service, node) for global."""

    service_id: str
    slot: int = 0
    node_id: str = ""


def slot_tuple(t: Task) -> SlotTuple:
    if t.slot:
        return SlotTuple(service_id=t.service_id, slot=t.slot)
    return SlotTuple(service_id=t.service_id, node_id=t.node_id)


def is_replicated_service(service: Optional[Service]) -> bool:
    return service is not None and service.spec.mode == ServiceMode.REPLICATED


def is_global_service(service: Optional[Service]) -> bool:
    return service is not None and service.spec.mode == ServiceMode.GLOBAL


def is_replicated_job(service: Optional[Service]) -> bool:
    return service is not None and \
        service.spec.mode == ServiceMode.REPLICATED_JOB


def is_global_job(service: Optional[Service]) -> bool:
    return service is not None and service.spec.mode == ServiceMode.GLOBAL_JOB


def invalid_node(n: Optional[Node]) -> bool:
    """Node is nil, down, or drained (reference: service.go InvalidNode)."""
    return (n is None
            or n.status.state == NodeState.DOWN
            or n.spec.availability == NodeAvailability.DRAIN)


def effective_task_spec(service: Service):
    """The task spec a task of this service actually carries: the
    service-level priority class propagates into the spec at creation
    when the task spec has none (the scheduler only reads
    ``task.spec.priority``).  ``is_task_dirty`` compares against this
    same spec so the propagation never reads as spec drift."""
    spec = service.spec.task
    svc_prio = getattr(service.spec, "priority", 0)
    if svc_prio and not getattr(spec, "priority", 0):
        spec = spec.copy()
        spec.priority = svc_prio
    return spec


def new_task(cluster: Optional[Cluster], service: Service, slot: int,
             node_id: str = "") -> Task:
    """Task factory (reference: task.go:16 NewTask)."""
    log_driver = service.spec.task.log_driver
    if log_driver is None and cluster is not None:
        log_driver = cluster.spec.task_defaults.log_driver

    task = Task(
        id=new_id(),
        service_annotations=service.spec.annotations,
        spec=effective_task_spec(service),
        spec_version=service.spec_version.copy()
        if service.spec_version else None,
        service_id=service.id,
        slot=slot,
        status=TaskStatus(state=TaskState.NEW, timestamp=now(),
                          message="created"),
        endpoint=Endpoint(spec=service.spec.endpoint.copy())
        if service.spec.endpoint else None,
        desired_state=TaskState.RUNNING,
        log_driver=log_driver,
    )
    if node_id:
        task.node_id = node_id
    return task


def restart_condition(task: Task) -> RestartCondition:
    if task.spec.restart is not None:
        return task.spec.restart.condition
    return RestartCondition.ANY


def task_timestamp(t: Task) -> float:
    return t.status.applied_at or t.status.timestamp


def _node_matches(service: Service, n: Optional[Node]) -> bool:
    if n is None:
        return False
    try:
        constraints = constraint_mod.parse(
            service.spec.task.placement.constraints)
    except constraint_mod.InvalidConstraint:
        constraints = []
    return constraint_mod.node_matches(constraints, n)


def is_task_dirty(service: Service, t: Task, n: Optional[Node]) -> bool:
    """Does the task need replacing to match the service spec?
    (reference: task.go:75 IsTaskDirty)"""
    if (t.spec_version is not None and service.spec_version is not None
            and t.spec_version.index == service.spec_version.index):
        return False

    # compare against the spec tasks are actually minted with — a
    # service-level priority propagated at creation is not drift
    service_spec = effective_task_spec(service)

    # Not dirty if only placement constraints changed and the assigned node
    # still satisfies them.
    if _placement_constraints_only_changed(service_spec, t) \
            and _node_matches(service, n):
        return False

    spec_equal = service_spec == t.spec or \
        dataclasses.asdict(service_spec) == dataclasses.asdict(t.spec)
    endpoint_dirty = False
    if t.endpoint is not None:
        svc_ep = service.spec.endpoint
        task_ep_spec = t.endpoint.spec
        if svc_ep is None:
            endpoint_dirty = bool(task_ep_spec.ports)
        else:
            endpoint_dirty = dataclasses.asdict(svc_ep) != \
                dataclasses.asdict(task_ep_spec)
    return (not spec_equal) or endpoint_dirty


def _placement_constraints_only_changed(service_spec, t: Task) -> bool:
    if dataclasses.asdict(service_spec.placement) == \
            dataclasses.asdict(t.spec.placement):
        return False
    a = dataclasses.asdict(service_spec)
    b = dataclasses.asdict(t.spec)
    a["placement"] = b["placement"]
    return a == b


def set_service_tasks_remove(store: MemoryStore, service: Service) -> None:
    """Mark all of a deleted service's tasks desired-REMOVE so agents shut
    them down and the reaper deletes them (reference: service.go
    SetServiceTasksRemove)."""
    from ..state.store import ByService

    tasks = store.view(lambda tx: tx.find(Task, ByService(service.id)))

    def cb(batch: Batch) -> None:
        for t in tasks:
            if t.desired_state == TaskState.REMOVE:
                continue

            def one(tx, t=t):
                cur = tx.get(Task, t.id)
                if cur is None:
                    return
                cur = cur.copy()
                cur.desired_state = TaskState.REMOVE
                tx.update(cur)
            batch.update(one)

    store.batch(cb)


def update_config_for(service: Service, rollback: bool) -> UpdateConfig:
    if rollback:
        return service.spec.rollback or DEFAULT_ROLLBACK_CONFIG
    return service.spec.update or DEFAULT_UPDATE_CONFIG
