"""Synthetic clusters for driving the scheduler end to end.

``build_cluster`` creates a store holding ``n_nodes`` READY nodes
(64 CPUs / 256 GiB each, ``rack`` label r0..r19 unless ``node_labels`` says
otherwise) and ``n_tasks`` PENDING tasks of one replicated service; a
``global_share`` of the tasks comes preassigned to a node, the way a
global service's tasks do.  ``one_tick`` runs the scheduler's
production sequence on it once: mirror setup, preassigned validation, one
tick.  The headline workload (10,000 nodes x 100,000 tasks, 20%
preassigned, spread over ``node.labels.rack``) is ``headline_cluster``.

``many_service_cluster`` is the many-service tick of a manager that runs
ten services: bench.py's config 7 (10,000 nodes, 10 replicated services of
50,000 tasks, 0.1 CPU + 64 MiB each, all pending in one tick), with the
services split over the four placement strategies (``MANY_SERVICE_MIX``):
four spread over the rack label, two binpack, two weighted, two learned.
"""

from __future__ import annotations

import time

from .models import (
    Annotations, Node, NodeDescription, NodeSpec, NodeState, NodeStatus,
    Placement, PlacementPreference, Platform, ReplicatedService, Resources,
    ResourceRequirements, Service, ServiceMode, ServiceSpec, SpreadOver, Task,
    TaskSpec, TaskState, TaskStatus, Version,
)
from .state import MemoryStore
from .utils import new_id

HEADLINE_NODES = 10_000
HEADLINE_TASKS = 100_000
HEADLINE_GLOBAL_SHARE = 0.2

MANY_SERVICE_NODES = 10_000
MANY_SERVICE_TASKS = 500_000
#: (strategy, spread over the rack label, strategy weights) per service
MANY_SERVICE_MIX = (
    ("spread", True, None), ("spread", True, None),
    ("spread", True, None), ("spread", True, None),
    ("binpack", False, None), ("binpack", False, None),
    ("weighted", False, {"spread": 2, "cpu": 3}), ("weighted", False, None),
    ("learned", False, None), ("learned", False, None),
)


def rack_spread():
    """The headline's placement preference: spread over the rack label."""
    return [PlacementPreference(
        spread=SpreadOver(spread_descriptor="node.labels.rack"))]


def build_cluster(n_nodes, n_tasks, node_labels=None, constraints=None,
                  platforms=None, prefs=None, node_platform=None,
                  global_share=0.0):
    """(store, service, nodes, tasks) for a synthetic cluster of one
    replicated service whose tasks reserve 0.1 CPU and 64 MiB each."""
    store = MemoryStore()
    nodes = []
    for i in range(n_nodes):
        labels = dict(node_labels(i)) if node_labels else \
            {"rack": f"r{i % 20}"}
        platform = Platform(**node_platform(i)) if node_platform else \
            Platform(os="linux", architecture="amd64")
        nodes.append(Node(
            id=new_id(),
            spec=NodeSpec(annotations=Annotations(
                name=f"node-{i:05d}", labels=labels)),
            status=NodeStatus(state=NodeState.READY),
            description=NodeDescription(
                hostname=f"node-{i:05d}", platform=platform,
                resources=Resources(nano_cpus=64 * 10**9,
                                    memory_bytes=256 << 30))))
    shared_spec = TaskSpec(
        placement=Placement(constraints=constraints or [],
                            platforms=platforms or [],
                            preferences=prefs or []),
        resources=ResourceRequirements(
            reservations=Resources(nano_cpus=10**8, memory_bytes=64 << 20)))

    svc = Service(
        id=new_id(),
        spec=ServiceSpec(annotations=Annotations(name="bench-0"),
                         mode=ServiceMode.REPLICATED,
                         replicated=ReplicatedService(replicas=n_tasks)),
        spec_version=Version(index=1))
    n_global = int(n_tasks * global_share)
    tasks = []
    for s in range(1, n_tasks + 1):
        t = Task(id=new_id(), service_id=svc.id, slot=s,
                 desired_state=TaskState.RUNNING, spec=shared_spec,
                 spec_version=Version(index=1),
                 status=TaskStatus(state=TaskState.PENDING))
        if s <= n_global:
            # global-service style: preassigned to a node
            t.slot = 0
            t.node_id = nodes[s % n_nodes].id
        tasks.append(t)

    def create_nodes(tx):
        for n in nodes:
            tx.create(n)
        tx.create(svc)

    store.update(create_nodes)

    def create_tasks(tx):
        for t in tasks:
            tx.create(t)

    store.update(create_tasks)
    return store, svc, nodes, tasks


def headline_cluster(n_nodes=HEADLINE_NODES, n_tasks=HEADLINE_TASKS):
    return build_cluster(n_nodes, n_tasks, prefs=rack_spread(),
                         global_share=HEADLINE_GLOBAL_SHARE)


def one_tick(store, planner):
    """Build a scheduler over ``store`` with ``planner`` (None: the host
    path), validate the preassigned tasks and run one tick.  Returns
    (scheduler, decisions, seconds): decisions counts the tick's and the
    preassigned tasks that were confirmed."""
    from .scheduler import Scheduler

    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    n_pre = len(sched.pending_preassigned_tasks)
    t0 = time.perf_counter()
    sched._process_preassigned_tasks()
    n_dec = sched.tick()
    n_dec += n_pre - len(sched.pending_preassigned_tasks)
    return sched, n_dec, time.perf_counter() - t0


def many_service_cluster(n_nodes=MANY_SERVICE_NODES,
                         n_tasks=MANY_SERVICE_TASKS, mix=MANY_SERVICE_MIX):
    """(store, services, nodes, tasks): ``n_nodes`` nodes as
    ``build_cluster`` makes them and ``n_tasks`` PENDING tasks split
    evenly over one replicated service per entry of ``mix``, each task
    reserving 0.1 CPU and 64 MiB."""
    store = MemoryStore()
    nodes = [Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(
            name=f"node-{i:05d}", labels={"rack": f"r{i % 20}"})),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=f"node-{i:05d}",
            platform=Platform(os="linux", architecture="amd64"),
            resources=Resources(nano_cpus=64 * 10**9,
                                memory_bytes=256 << 30)))
        for i in range(n_nodes)]
    services, tasks = [], []
    per = n_tasks // len(mix)
    for si, (strategy, spread, weights) in enumerate(mix):
        count = per if si < len(mix) - 1 else n_tasks - per * si
        spec = TaskSpec(
            placement=Placement(
                preferences=rack_spread() if spread else [],
                strategy=strategy, strategy_weights=dict(weights or {})),
            resources=ResourceRequirements(reservations=Resources(
                nano_cpus=10**8, memory_bytes=64 << 20)))
        svc = Service(
            id=new_id(),
            spec=ServiceSpec(annotations=Annotations(name=f"bench-{si}"),
                             mode=ServiceMode.REPLICATED,
                             replicated=ReplicatedService(replicas=count),
                             task=spec),
            spec_version=Version(index=1))
        services.append(svc)
        for s in range(1, count + 1):
            tasks.append(Task(id=new_id(), service_id=svc.id, slot=s,
                              desired_state=TaskState.RUNNING, spec=spec,
                              spec_version=Version(index=1),
                              status=TaskStatus(state=TaskState.PENDING)))

    def create_nodes(tx):
        for n in nodes:
            tx.create(n)
        for svc in services:
            tx.create(svc)

    store.update(create_nodes)

    def create_tasks(tx):
        for t in tasks:
            tx.create(t)

    store.update(create_tasks)
    return store, services, nodes, tasks
