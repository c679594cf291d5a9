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

``steady_state_churn`` is bench.py's config 10, the streaming scheduler's
production shape: 8,192 nodes in steady state (12,000 base tasks RUNNING
over six services ``ca``..``cf``) while seeded windows bring Poisson(40)
arrivals to one service (rotating over ``cb``..``cf``) and Poisson(18)
exits; each window ends in one tick driven through the store watch feed.

``gang_fleet`` is bench.py's config 12 gang fleet: 400 nodes of 16 CPUs,
24 gangs of 8 members at 4 CPUs, 40 gangs of 4 at 2 CPUs, and 8
cross-service gangs of two services x 4 members at 2 CPUs, all pending.

``priority_jobs`` is bench.py's config 8, priority preemption's production
shape: 512 nodes of 8 CPUs / 32 GiB run 1,800 priority-0 tasks (2 CPUs /
1 GiB); a priority-2 band of 400 tasks, a priority-1 band of 120 and a
priority-1 replicated job of 64 completions arrive in one tick, and the
tick's preemption pass must evict low-band tasks to place them.
``priority_storm`` is a priority storm at the headline cluster's width:
10,000 nodes of 16 CPUs / 64 GiB, each running 15 single-CPU tasks of
2 GiB in a per-node mix of priority 0 and 1 drawn from a seed, and a
priority-2 service of 512 tasks of 4 CPUs / 8 GiB arriving at once.
``preempt_tick`` runs one tick of either with its victim budget.

``per_host_spread`` is a spread over a per-node label on a cluster past
8,192 nodes, the ordinary way to ask for one task a host: 8,200 nodes of
16 CPUs / 64 GiB, each with its own ``host`` label, and two replicated
services of 8,200 tasks (0.1 CPU + 64 MiB) spread over
``node.labels.host``, all pending in one tick.  Its value count rounds up
to 16,384 leaf segments.  Ids are fixed (``n00000``, ``svc0-t00000``), so
two builds place task by task alike.

The builders run with the cyclic garbage collector paused
(``utils.gctune.paused_gc``): a store of half a million tasks is a tree
of small objects, and the collections its growth triggers would take
near half of a build's time.

``ControlLoops`` steps the leader's control loops over a store without
threads: the scheduler, the task allocator, the orchestrators and their
supervisors; ``advance_tasks`` is a stub agent on every node and
``settle`` steps both until quiet.  ``orchestrated_cluster`` is bench.py's
config 5 as users reach it: the headline's 10,000 nodes and services with
no task in the store (``web``, 500,000 replicas spread over the racks;
``agent``, global; ``api``, 10,000 replicas rolled out 2,500 at a time),
driven through a create, a drain of 1,000 nodes (``drain_nodes``) and a
rollout (``roll_out``).  ``tenant_storm`` is bench.py's config 9: the
autoscaler and the tenant quotas under a burst, its window one autoscaler
drive and one tick (``tenant_storm_pass``).

``live_manager`` is bench.py's ``run_live_manager`` (configs 6 and 7):
one tick of a store the caller built (``live_cluster`` is config 6:
10,000 nodes, two services of 100,000 tasks) through a single-voter
``RaftNode`` with a sealed WAL, under the live manager's subscribers.
``raft_group`` makes in-process raft members over one ``LocalNetwork``,
each with its own store and WAL, and ``wait_leader`` waits, bounded, for
one of them to lead.

``million_swarm`` is bench.py's config 13: a thousand real dispatcher
sessions over one threadless ``Dispatcher`` with the batched fan-out
carry a million replicas from one tick through the fan-out and the
status write-back shed at the bounded admission edge until every replica
is RUNNING.  ``e2e`` is bench.py's ``run_e2e`` (swarm-bench): a
``Manager``, agents with a ``TestExecutor`` on its dispatcher and a
service created through its control API, timed to RUNNING, optionally
over a single-voter raft and through a heal after an agent stops.

``SIM_DEVICE_SCENARIOS`` names the simulator's scenarios that build a
device planner (``sim/scenario.py``), and ``sim_obs_events`` puts a sim
report's span trace in a form two planners can be compared in.
"""

from __future__ import annotations

import json
import os
import random
import time

from .models import (
    Annotations, GangConfig, Node, NodeDescription, NodeSpec, NodeState,
    NodeStatus, Placement, PlacementPreference, Platform, ReplicatedJob,
    ReplicatedService, Resources, ResourceRequirements, Service, ServiceMode,
    ServiceSpec, SpreadOver, Task, TaskSpec, TaskState, TaskStatus, Version,
)
from .models.types import NodeRole, now
from .state import MemoryStore
from .utils import new_id
from .utils.gctune import paused_gc
from .utils.sampling import poisson

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


def rack_nodes(n_nodes, node_labels=None, node_platform=None):
    """``n_nodes`` READY nodes of 64 CPUs / 256 GiB: labelled
    ``node_labels(i)`` (default: ``rack`` r0..r19) on the platform
    ``node_platform(i)`` (default: linux/amd64)."""
    return [Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(
            name=f"node-{i:05d}",
            labels=dict(node_labels(i)) if node_labels
            else {"rack": f"r{i % 20}"})),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=f"node-{i:05d}",
            platform=Platform(**node_platform(i)) if node_platform
            else Platform(os="linux", architecture="amd64"),
            resources=Resources(nano_cpus=64 * 10**9,
                                memory_bytes=256 << 30)))
        for i in range(n_nodes)]


@paused_gc()
def build_cluster(n_nodes, n_tasks, node_labels=None, constraints=None,
                  platforms=None, prefs=None, node_platform=None,
                  global_share=0.0, n_services=1, reservations=None):
    """(store, service, nodes, tasks) for a synthetic cluster whose tasks
    reserve ``reservations`` each (None: 0.1 CPU and 64 MiB).
    ``n_services`` replicated services
    (``bench-0``, ...) split ``n_tasks`` evenly, the last taking the
    remainder; ``service`` is the first of them."""
    store = MemoryStore()
    nodes = rack_nodes(n_nodes, node_labels, node_platform)
    shared_spec = TaskSpec(
        placement=Placement(constraints=constraints or [],
                            platforms=platforms or [],
                            preferences=prefs or []),
        resources=ResourceRequirements(
            reservations=reservations
            or Resources(nano_cpus=10**8, memory_bytes=64 << 20)))

    services = []
    tasks = []
    per = n_tasks // n_services
    for si in range(n_services):
        count = per if si < n_services - 1 else n_tasks - per * si
        svc = Service(
            id=new_id(),
            spec=ServiceSpec(annotations=Annotations(name=f"bench-{si}"),
                             mode=ServiceMode.REPLICATED,
                             replicated=ReplicatedService(replicas=count)),
            spec_version=Version(index=1))
        services.append(svc)
        n_global = int(count * global_share)
        for s in range(1, count + 1):
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
        for svc in services:
            tx.create(svc)

    store.update(create_nodes)

    def create_tasks(tx):
        for t in tasks:
            tx.create(t)

    store.update(create_tasks)
    return store, services[0], nodes, tasks


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


@paused_gc()
def many_service_cluster(n_nodes=MANY_SERVICE_NODES,
                         n_tasks=MANY_SERVICE_TASKS, mix=MANY_SERVICE_MIX):
    """(store, services, nodes, tasks): ``n_nodes`` nodes as
    ``build_cluster`` makes them and ``n_tasks`` PENDING tasks split
    evenly over one replicated service per entry of ``mix``, each task
    reserving 0.1 CPU and 64 MiB."""
    store = MemoryStore()
    nodes = rack_nodes(n_nodes)
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


# ------------------------------------------------------ per-host spread

PER_HOST_NODES = 8200
PER_HOST_SERVICES = (8200, 8200)


@paused_gc()
def per_host_spread(n_nodes=PER_HOST_NODES, services=PER_HOST_SERVICES):
    """(store, services, nodes): ``n_nodes`` READY nodes (16 CPUs, 64
    GiB), each with its own ``host`` label, and one replicated service per
    entry of ``services`` (its task count; 0.1 CPU and 64 MiB a task)
    spread over ``node.labels.host``, every task PENDING."""
    nodes = [Node(
        id=f"n{i:05d}",
        spec=NodeSpec(annotations=Annotations(
            name=f"node-{i:05d}", labels={"host": f"h{i}"})),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=f"node-{i:05d}",
            platform=Platform(os="linux", architecture="amd64"),
            resources=Resources(nano_cpus=16 * 10**9,
                                memory_bytes=64 << 30)))
        for i in range(n_nodes)]
    spec = TaskSpec(
        placement=Placement(preferences=[PlacementPreference(
            spread=SpreadOver(spread_descriptor="node.labels.host"))]),
        resources=ResourceRequirements(reservations=Resources(
            nano_cpus=10**8, memory_bytes=64 << 20)))
    svcs, tasks = [], []
    for si, count in enumerate(services):
        svc = Service(
            id=f"svc{si}",
            spec=ServiceSpec(annotations=Annotations(name=f"svc{si}"),
                             mode=ServiceMode.REPLICATED,
                             replicated=ReplicatedService(replicas=count),
                             task=spec),
            spec_version=Version(index=1))
        svcs.append(svc)
        tasks += [Task(id=f"{svc.id}-t{k:05d}", service_id=svc.id,
                       slot=k + 1, desired_state=TaskState.RUNNING,
                       spec=spec, spec_version=Version(index=1),
                       status=TaskStatus(state=TaskState.PENDING))
                  for k in range(count)]
    return _create_all(nodes, svcs, tasks), svcs, nodes


# ------------------------------------------------------ steady-state churn

CHURN_NODES = 8192
CHURN_BASE_TASKS = 12_000
CHURN_WINDOWS = 12
CHURN_SEED = 1
CHURN_SERVICES = ("ca", "cb", "cc", "cd", "ce", "cf")
#: arrivals rotate over the production-shaped services; "ca" is base load
CHURN_ARRIVE = ("cb", "cc", "cd", "ce", "cf")
CHURN_LAM_ARRIVE = 40.0
CHURN_LAM_EXIT = 18.0


def churn_specs():
    """The six services' task specs: constraints, platform requirements
    and a rack spread preference -- the per-group columns the resident
    state keeps."""
    res = ResourceRequirements(
        reservations=Resources(nano_cpus=10**8, memory_bytes=64 << 20))
    amd64 = [Platform(os="linux", architecture="amd64")]
    rack = [PlacementPreference(spread=SpreadOver(
        spread_descriptor="node.labels.rack"))]
    return {
        "ca": TaskSpec(resources=res),
        "cb": TaskSpec(resources=res, placement=Placement(
            constraints=["node.labels.tier==web"], platforms=amd64)),
        "cc": TaskSpec(resources=res, placement=Placement(preferences=rack)),
        "cd": TaskSpec(resources=res, placement=Placement(
            constraints=["node.labels.rack!=r03"], platforms=amd64)),
        "ce": TaskSpec(resources=res, placement=Placement(
            constraints=["node.hostname!=c99999"], platforms=amd64,
            preferences=rack)),
        "cf": TaskSpec(resources=res, placement=Placement(
            constraints=["node.labels.rack!=r07"], platforms=amd64)),
    }


def churn_script(windows, seed=CHURN_SEED):
    """[(arrivals {service: count}, exits)] per window: each window's
    arrivals hit ONE service, rotating; seeded, so every run replays the
    same churn."""
    rng = random.Random(seed)
    script = []
    for w in range(windows):
        sid = CHURN_ARRIVE[w % len(CHURN_ARRIVE)]
        arrivals = {sid: max(1, poisson(rng, CHURN_LAM_ARRIVE))}
        script.append((arrivals, poisson(rng, CHURN_LAM_EXIT)))
    return script


class SteadyStateChurn:
    """One run of the churn workload: the store (built here), a scheduler
    over it fed by the store's watch stream, and the window driver.  Ids
    are fixed, so two runs compare task by task."""

    def __init__(self, n_nodes=CHURN_NODES, n_base=CHURN_BASE_TASKS,
                 windows=CHURN_WINDOWS, seed=CHURN_SEED):
        self.n_base = n_base
        self.specs = churn_specs()
        self.script = churn_script(windows, seed)
        self.seqs = {sid: 0 for sid in CHURN_SERVICES}
        self.exited = 0
        self.sched = None
        self._sub = None
        self.store = store = MemoryStore()
        nodes = [Node(
            id=f"c{i:05d}",
            spec=NodeSpec(annotations=Annotations(
                name=f"c{i:05d}",
                labels={"tier": "web" if i % 2 else "db",
                        "rack": f"r{i % 16:02d}"})),
            status=NodeStatus(state=NodeState.READY),
            description=NodeDescription(
                hostname=f"c{i:05d}",
                platform=Platform(os="linux", architecture="amd64"),
                resources=Resources(nano_cpus=8 * 10**9,
                                    memory_bytes=32 << 30)))
            for i in range(n_nodes)]
        store.update(lambda tx: [tx.create(n) for n in nodes])

        def mk_services(tx):
            for sid in CHURN_SERVICES:
                tx.create(Service(
                    id=sid,
                    spec=ServiceSpec(
                        annotations=Annotations(name=sid),
                        mode=ServiceMode.REPLICATED,
                        replicated=ReplicatedService(replicas=0),
                        task=self.specs[sid]),
                    spec_version=Version(index=1)))
        store.update(mk_services)

        def mk_base(tx):
            for k in range(n_base):
                sid = CHURN_SERVICES[k % len(CHURN_SERVICES)]
                tx.create(Task(
                    id=f"{sid}-base{k:06d}", service_id=sid, slot=k + 1,
                    desired_state=TaskState.RUNNING, spec=self.specs[sid],
                    spec_version=Version(index=1),
                    node_id=nodes[k % n_nodes].id,
                    status=TaskStatus(state=TaskState.RUNNING)))
        store.update(mk_base)

    def attach(self, planner):
        """A scheduler over the store with ``planner``, its mirror set up
        from a watch subscription (the streaming delta source)."""
        from .scheduler import Scheduler
        self.sched = Scheduler(self.store, batch_planner=planner,
                               pipeline_depth=1)
        _, self._sub = self.store.view_and_watch(
            lambda tx: self.sched._setup_tasks_list(tx), accepts_blocks=True)
        return self.sched

    def pump(self) -> None:
        """Feed the scheduler every watch event since the last pump."""
        from .state.events import Event, EventSnapshotRestore
        while True:
            ev = self._sub.poll()
            if ev is None:
                return
            if isinstance(ev, EventSnapshotRestore):
                self.sched._resync()
            elif isinstance(ev, Event):
                self.sched._handle_event(ev)

    def add(self, sid: str, n: int) -> None:
        """``n`` PENDING arrivals of service ``sid``."""
        spec = self.specs[sid]
        base = self.seqs[sid]

        def cb(tx):
            ts = now()
            for k in range(n):
                tx.create(Task(
                    id=f"{sid}-a{base + k:06d}", service_id=sid,
                    slot=self.n_base + base + k + 1,
                    desired_state=TaskState.RUNNING, spec=spec,
                    spec_version=Version(index=1),
                    status=TaskStatus(state=TaskState.PENDING,
                                      timestamp=ts)))
        self.store.update(cb)
        self.seqs[sid] = base + n

    def exit_some(self, k: int) -> None:
        """The ``k`` oldest base tasks not yet exited complete."""
        start = self.exited
        victims = [f"{CHURN_SERVICES[j % len(CHURN_SERVICES)]}-base{j:06d}"
                   for j in range(start, min(start + k, self.n_base))]
        self.exited = start + len(victims)

        def cb(tx):
            ts = now()
            for tid in victims:
                cur = tx.get(Task, tid)
                if cur is None:
                    continue
                cur = cur.copy()
                cur.status = TaskStatus(state=TaskState.COMPLETE,
                                        timestamp=ts, message="churn exit")
                tx.update(cur)
        self.store.update(cb)

    def feed(self, arrivals, exits) -> None:
        """A window's arrivals and exits, written to the store and fed to
        the scheduler through the watch stream."""
        for sid, n in arrivals.items():
            if n:
                self.add(sid, n)
        if exits:
            self.exit_some(exits)
        self.pump()

    def window(self, arrivals, exits) -> int:
        """One window: :meth:`feed`, then one tick.  Returns the tick's
        decisions."""
        self.feed(arrivals, exits)
        return self.sched.tick()

    def placements(self):
        """Sorted (task id, node id) of every task in the store."""
        return sorted((t.id, t.node_id)
                      for t in self.store.view(lambda tx: tx.find(Task)))

    def close(self) -> None:
        self.pump()
        self.store.queue.unsubscribe(self._sub)


def steady_state_churn(n_nodes=CHURN_NODES, n_base=CHURN_BASE_TASKS,
                       windows=CHURN_WINDOWS, seed=CHURN_SEED):
    """A fresh :class:`SteadyStateChurn` (store built, script drawn)."""
    return SteadyStateChurn(n_nodes, n_base, windows, seed)


# -------------------------------------------------------------- gang fleet

GANG_NODES = 400
GANG_NODE_CPUS = 16
#: (name prefix, gangs, members, CPUs per member) of the one-service gangs
GANG_SHAPES = (("gang8", 24, 8, 4), ("gang4", 40, 4, 2))
GANG_CROSS = 8            # cross-service gangs: 2 services x 4 members


def gang_service(name, cpus, count, min_size, gang_id=""):
    """(service, tasks): ``count`` PENDING tasks of one replicated service
    reserving ``cpus`` CPUs (and cpus/4 GiB) each, in gang ``gang_id``
    (the service itself when empty) of ``min_size`` members.  The service
    id is ``name`` and task ids derive from it, so two builds compare task
    by task (the host path breaks ties by id)."""
    spec = TaskSpec(
        resources=ResourceRequirements(reservations=Resources(
            nano_cpus=cpus * 10**9, memory_bytes=(cpus << 30) // 4)),
        placement=Placement(gang=GangConfig(min_size=min_size)),
        gang_id=gang_id)
    svc = Service(
        id=name,
        spec=ServiceSpec(annotations=Annotations(name=name),
                         mode=ServiceMode.REPLICATED,
                         replicated=ReplicatedService(replicas=count),
                         task=spec),
        spec_version=Version(index=1))
    tasks = [Task(id=f"{name}-t{s:02d}", service_id=svc.id, slot=s + 1,
                  desired_state=TaskState.RUNNING, spec=spec,
                  spec_version=Version(index=1),
                  status=TaskStatus(state=TaskState.PENDING))
             for s in range(count)]
    return svc, tasks


@paused_gc()
def gang_fleet(n_nodes=GANG_NODES):
    """(store, services, nodes, tasks) of the gang fleet, ``tasks`` in
    creation order: 72 gangs, 416 members, all pending.  Ids are fixed."""
    store = MemoryStore()
    nodes = [Node(
        id=f"g{i:04d}",
        spec=NodeSpec(annotations=Annotations(name=f"g{i:04d}")),
        status=NodeStatus(state=NodeState.READY,
                          addr=f"10.{i // 250}.0.{i % 250 + 1}"),
        description=NodeDescription(
            hostname=f"g{i:04d}",
            resources=Resources(nano_cpus=GANG_NODE_CPUS * 10**9,
                                memory_bytes=64 << 30)))
        for i in range(n_nodes)]
    services, tasks = [], []
    for prefix, n_gangs, size, cpus in GANG_SHAPES:
        for g in range(n_gangs):
            svc, ts = gang_service(f"{prefix}-{g:02d}", cpus, size, size)
            services.append(svc)
            tasks += ts
    for g in range(GANG_CROSS):
        for half in "ab":
            svc, ts = gang_service(f"xgang-{g}{half}", 2, 4, 8,
                                   gang_id=f"xg{g}")
            services.append(svc)
            tasks += ts

    def mk(tx):
        for n in nodes:
            tx.create(n)
        for svc in services:
            tx.create(svc)
    store.update(mk)
    store.update(lambda tx: [tx.create(t) for t in tasks] and None)
    return store, services, nodes, tasks


PRIORITY_JOBS_NODES = 512
PRIORITY_JOBS_BUDGET = 512
#: (band, priority, tasks) of config 8: the resident band first
PRIORITY_BANDS = (("lo", 0, 1800), ("hi", 2, 400), ("mid", 1, 120))
PRIORITY_JOB = ("job", 1, 64)       # a replicated job of 64 completions
STORM_NODES = 10_000
STORM_RESIDENTS = 15                # single-CPU tasks of 2 GiB per node
STORM_ARRIVALS = 512                # priority 2, 4 CPUs / 8 GiB each
STORM_BUDGET = 2048


def _reservation(cpus, mem):
    return ResourceRequirements(reservations=Resources(
        nano_cpus=cpus * 10**9, memory_bytes=mem))


def _priority_nodes(prefix, n_nodes, cpus, mem):
    return [Node(
        id=f"{prefix}{i:05d}",
        spec=NodeSpec(annotations=Annotations(name=f"{prefix}{i:05d}")),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=f"{prefix}{i:05d}",
            resources=Resources(nano_cpus=cpus * 10**9, memory_bytes=mem)))
        for i in range(n_nodes)]


def _band_service(name, spec, replicas, job=False):
    if job:
        return Service(
            id=f"band-{name}",
            spec=ServiceSpec(annotations=Annotations(name=f"band-{name}"),
                             mode=ServiceMode.REPLICATED_JOB,
                             replicated_job=ReplicatedJob(
                                 total_completions=replicas),
                             task=spec),
            spec_version=Version(index=1))
    return Service(
        id=f"band-{name}",
        spec=ServiceSpec(annotations=Annotations(name=f"band-{name}"),
                         mode=ServiceMode.REPLICATED,
                         replicated=ReplicatedService(replicas=replicas),
                         task=spec),
        spec_version=Version(index=1))


def _create_all(nodes, services, tasks):
    store = MemoryStore()

    def mk(tx):
        for n in nodes:
            tx.create(n)
        for svc in services:
            tx.create(svc)
    store.update(mk)
    store.update(lambda tx: [tx.create(t) for t in tasks] and None)
    return store


@paused_gc()
def priority_jobs(n_nodes=PRIORITY_JOBS_NODES):
    """(store, services, nodes, tasks) of config 8: the bands' counts are
    fixed and ``n_nodes`` scales only the cluster, as bench.py's
    ``BENCH_CFG8_NODES`` does (below 450 nodes the resident band overfills
    the nodes and their free pools go negative).  Resident tasks are
    RUNNING round-robin over the nodes; ids are fixed, so two builds
    compare victim by victim."""
    nodes = _priority_nodes("p", n_nodes, 8, 32 << 30)
    res = _reservation(2, 1 << 30)
    services, tasks = [], []
    for name, prio, count in PRIORITY_BANDS:
        spec = TaskSpec(resources=res, priority=prio)
        services.append(_band_service(name, spec, count))
        for s in range(count):
            t = Task(id=f"{name}-{s:04d}", service_id=f"band-{name}",
                     slot=s + 1, desired_state=TaskState.RUNNING, spec=spec,
                     spec_version=Version(index=1),
                     status=TaskStatus(state=TaskState.PENDING))
            if prio == 0:       # the resident band: already RUNNING
                t.node_id = nodes[s % n_nodes].id
                t.status = TaskStatus(state=TaskState.RUNNING)
            tasks.append(t)
    name, prio, count = PRIORITY_JOB
    spec = TaskSpec(resources=res, priority=prio)
    services.append(_band_service(name, spec, count, job=True))
    for s in range(count):
        tasks.append(Task(
            id=f"{name}-{s:04d}", service_id=f"band-{name}", slot=s,
            desired_state=TaskState.COMPLETE, spec=spec,
            spec_version=Version(index=1), job_iteration=Version(index=0),
            status=TaskStatus(state=TaskState.PENDING)))
    return _create_all(nodes, services, tasks), services, nodes, tasks


@paused_gc()
def priority_storm(n_nodes=STORM_NODES, seed=1):
    """(store, services, nodes, tasks) of the priority storm.  Node i runs
    ``STORM_RESIDENTS`` tasks, of which a seeded uniform 0..15 are priority
    0 and the rest priority 1, so the cheapest victim prefix (three
    victims free the 3 CPUs an arrival lacks) costs 3 to 6 from node to
    node; then ``STORM_ARRIVALS`` priority-2 tasks arrive, none of which
    fits anywhere without preemption."""
    rng = random.Random(seed)
    nodes = _priority_nodes("s", n_nodes, 16, 64 << 30)
    specs = {prio: TaskSpec(resources=_reservation(1, 2 << 30),
                            priority=prio) for prio in (0, 1)}
    resident = {0: [], 1: []}
    for i, node in enumerate(nodes):
        n_lo = rng.randint(0, STORM_RESIDENTS)
        for r in range(STORM_RESIDENTS):
            prio = 0 if r < n_lo else 1
            resident[prio].append(Task(
                id=f"r{prio}-{i:05d}-{r:02d}",
                service_id=f"band-r{prio}", desired_state=TaskState.RUNNING,
                spec=specs[prio], spec_version=Version(index=1),
                node_id=node.id, status=TaskStatus(state=TaskState.RUNNING)))
    services, tasks = [], []
    for prio, ts in resident.items():
        services.append(_band_service(f"r{prio}", specs[prio], len(ts)))
        for s, t in enumerate(ts):
            t.slot = s + 1
        tasks += ts
    spec = TaskSpec(resources=_reservation(4, 8 << 30), priority=2)
    services.append(_band_service("storm", spec, STORM_ARRIVALS))
    tasks += [Task(id=f"storm-{s:04d}", service_id="band-storm", slot=s + 1,
                   desired_state=TaskState.RUNNING, spec=spec,
                   spec_version=Version(index=1),
                   status=TaskStatus(state=TaskState.PENDING))
              for s in range(STORM_ARRIVALS)]
    return _create_all(nodes, services, tasks), services, nodes, tasks


def preempt_tick(store, planner, budget):
    """Build a scheduler over ``store`` with ``planner`` (None: the host
    path) and a victim budget of ``budget``, and run one tick.  Returns
    (scheduler, decisions, seconds)."""
    from .scheduler import Scheduler

    sched = Scheduler(store, batch_planner=planner, preempt_budget=budget)
    store.view(sched._setup_tasks_list)
    t0 = time.perf_counter()
    n_dec = sched.tick()
    return sched, n_dec, time.perf_counter() - t0


# ------------------------------------------------------- the control loops

class ControlLoops:
    """The leader's control loops over ``store``, minus the dispatcher and
    minus threads, stepped by the caller in the order of the reference
    simulator's control step: a ``Scheduler`` over ``planner`` (None: the
    host path), then the task allocator, the replicated, global and jobs
    orchestrators (each on its own block-accepting subscription), their
    rolling-update supervisors, the autoscaler, the pipeline supervisor
    and the restart supervisor.  The scheduler's mirror is fed as its
    own event loop feeds it (``_handle_event`` a store event, ``_resync``
    on a snapshot restore) where the simulator rebuilds it every step:
    at half a million tasks a rebuild costs seconds a step.
    ``sampler`` is the autoscaler's load seam.  ``last`` holds each
    part's wall time in the latest step."""

    PARTS = ("intake", "preassigned", "tick", "allocator", "replicated",
             "global", "jobs", "updates", "autoscaler", "pipeline",
             "restarts")

    def __init__(self, store, planner=None, sampler=None):
        from .manager.allocator import Allocator
        from .orchestrator.autoscaler import (
            Supervisor as AutoscaleSupervisor,
        )
        from .orchestrator.global_ import Orchestrator as GlobalOrchestrator
        from .orchestrator.jobs import Orchestrator as JobsOrchestrator
        from .orchestrator.pipeline import PipelineSupervisor
        from .orchestrator.replicated import (
            Orchestrator as ReplicatedOrchestrator,
        )
        from .orchestrator.restart import Supervisor as RestartSupervisor
        from .orchestrator.update import Supervisor as UpdateSupervisor
        from .scheduler import Scheduler
        from .scheduler.filters import VolumesFilter

        self.store = store
        self.allocator = Allocator(store)
        self.restarts = RestartSupervisor(store, start_worker=False)
        self.scheduler = Scheduler(store, batch_planner=planner,
                                   pipeline_depth=1)
        self.scheduler.pipeline.add_filter(
            VolumesFilter(self.scheduler.volumes))
        self.autoscaler = AutoscaleSupervisor(store, sampler=sampler,
                                              start_worker=False)
        self.pipeline = PipelineSupervisor(store, start_worker=False)
        self.jobs = JobsOrchestrator(store, restarts=self.restarts)
        self.replicated = ReplicatedOrchestrator(
            store, restarts=self.restarts,
            updater=UpdateSupervisor(store, self.restarts,
                                     start_worker=False))
        self.global_ = GlobalOrchestrator(
            store, restarts=self.restarts,
            updater=UpdateSupervisor(store, self.restarts,
                                     start_worker=False))
        self._drivers = []
        self.last = dict.fromkeys(self.PARTS, 0.0)

    def _timed(self, part, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.last[part] += time.perf_counter() - t0
        return out

    def cold_start(self):
        """Mirror the store into the scheduler and subscribe it, subscribe
        the allocator (it moves NEW tasks to PENDING), then each orchestrator,
        each after the startup consistency pass and a resync."""
        from .orchestrator import taskinit

        store = self.store
        _, self._sched_sub = store.view_and_watch(
            self.scheduler._setup_tasks_list, accepts_blocks=True)
        sub = store.queue.subscribe(accepts_blocks=True)
        self._drivers.append(("allocator", self.allocator, sub,
                              self.allocator._tick))
        self.allocator._resync()
        for part, orch, tick in (
                ("replicated", self.replicated, self.replicated._tick),
                ("global", self.global_, self.global_._tick_tasks),
                ("jobs", self.jobs, self.jobs._tick)):
            sub = store.queue.subscribe(accepts_blocks=True)
            self._drivers.append((part, orch, sub, tick))
            taskinit.check_tasks(store, store.view(), orch, self.restarts)
            orch._resync()

    def _intake(self, orch, sub, tick):
        from .state.events import Event, EventSnapshotRestore

        while True:
            ev = sub.poll()
            if ev is None:
                break
            if isinstance(ev, EventSnapshotRestore):
                orch._resync()
            elif isinstance(ev, Event):
                orch._handle_event(ev)
        tick()

    def step(self):
        """One control step; returns the scheduler's decisions (tasks the
        tick assigned and preassigned tasks confirmed) and the store
        versions the whole step wrote (0: the loops are quiet)."""
        version = self.store.version
        self.last = dict.fromkeys(self.PARTS, 0.0)
        sched = self.scheduler
        self._timed("intake", self._intake, sched, self._sched_sub,
                    lambda: None)
        n_pre = len(sched.pending_preassigned_tasks)
        if n_pre:
            self._timed("preassigned", sched._process_preassigned_tasks)
        decided = n_pre - len(sched.pending_preassigned_tasks)
        decided += self._timed("tick", sched.tick)
        for part, orch, sub, tick in self._drivers:
            self._timed(part, self._intake, orch, sub, tick)
        for orch in (self.replicated, self.global_):
            self._timed("updates", orch.updater.drive)
        self._timed("autoscaler", self.autoscaler.drive)
        self._timed("pipeline", self.pipeline.drive)
        self._timed("restarts", self.restarts.drive)
        return decided, self.store.version - version

    def close(self):
        """Unsubscribe every loop from the store, as a leader's loops stop
        when it loses the lead: the store keeps no queue for them."""
        subs = [self._sched_sub] if hasattr(self, "_sched_sub") else []
        subs += [sub for _, _, sub, _ in self._drivers]
        for sub in subs:
            self.store.queue.unsubscribe(sub)
        self._drivers = []


def advance_tasks(store):
    """A stub agent on every node, in one store batch: an assigned task
    that is desired RUNNING starts (RUNNING), and a live task desired
    SHUTDOWN or beyond stops (SHUTDOWN), as the reference's test agent
    does.  Returns how many tasks moved."""
    def moves(tx):
        out = []
        for t in tx.find(Task):
            state = t.status.state
            if t.desired_state == TaskState.RUNNING and \
                    TaskState.ASSIGNED <= state < TaskState.RUNNING:
                out.append((t.id, TaskState.RUNNING, "started"))
            elif t.desired_state >= TaskState.SHUTDOWN and \
                    TaskState.ASSIGNED <= state <= TaskState.RUNNING:
                out.append((t.id, TaskState.SHUTDOWN, "shutdown"))
        return out

    todo = store.view(moves)

    def cb(batch):
        for tid, state, message in todo:
            def one(tx, tid=tid, state=state, message=message):
                t = tx.get(Task, tid).copy()
                t.status = TaskStatus(state=state, timestamp=now(),
                                      message=message)
                tx.update(t)
            batch.update(one)

    store.batch(cb)
    return len(todo)


# ------------------------------------------- a service's life, orchestrated

def orchestrated_cluster(n_nodes, web, api, parallelism):
    """(store, services, nodes) of bench.py's config 5 as users reach it
    (10,000 nodes, 500,000 ``web`` and 10,000 ``api`` replicas, ``api``
    rolled out 2,500 at a time):
    ``n_nodes`` nodes as ``build_cluster`` makes them, the ``default``
    Cluster, and services with no task in the store -- ``web``
    (replicated, ``web`` replicas spread over the rack label), ``agent``
    (global, one task a node) and ``api``
    (replicated, ``api`` replicas, rolled out ``parallelism`` at a time
    with no delay, no monitor window and a pause on failure).  Every task
    reserves 0.1 CPU and 64 MiB and restarts on any exit with no delay;
    ``services`` maps each name to its Service."""
    from .models import (
        Cluster, ClusterSpec, ContainerSpec, RestartCondition,
        RestartPolicy, UpdateConfig, UpdateFailureAction,
    )

    store = MemoryStore()
    nodes = rack_nodes(n_nodes)

    def spec(image, prefs=None):
        return TaskSpec(
            container=ContainerSpec(image=image),
            placement=Placement(preferences=prefs or []),
            restart=RestartPolicy(condition=RestartCondition.ANY, delay=0.0),
            resources=ResourceRequirements(reservations=Resources(
                nano_cpus=10**8, memory_bytes=64 << 20)))

    def service(name, mode, task, replicas=None, update=None):
        return Service(
            id=new_id(),
            spec=ServiceSpec(
                annotations=Annotations(name=name), task=task, mode=mode,
                replicated=ReplicatedService(replicas=replicas)
                if replicas is not None else None,
                update=update),
            spec_version=Version(index=1))

    services = {
        "web": service("web", ServiceMode.REPLICATED,
                       spec("web:1", rack_spread()), web),
        "agent": service("agent", ServiceMode.GLOBAL, spec("agent:1")),
        "api": service(
            "api", ServiceMode.REPLICATED, spec("api:1"), api,
            UpdateConfig(parallelism=parallelism, delay=0.0, monitor=0.0,
                         failure_action=UpdateFailureAction.PAUSE))}

    def create(tx):
        tx.create(Cluster(id=new_id(), spec=ClusterSpec(
            annotations=Annotations(name="default"))))
        for n in nodes:
            tx.create(n)
        for svc in services.values():
            tx.create(svc)

    store.update(create)
    return store, services, nodes


def drain_nodes(store, nodes):
    """Set each of ``nodes`` to DRAIN in one transaction."""
    from .models import NodeAvailability

    def cb(tx):
        for n in nodes:
            cur = tx.get(Node, n.id).copy()
            cur.spec.availability = NodeAvailability.DRAIN
            tx.update(cur)

    store.update(cb)


def roll_out(store, service_id, image):
    """A new image for ``service_id``'s tasks: the previous spec kept and
    the spec version bumped, as the control API's service update does."""
    def cb(tx):
        cur = tx.get(Service, service_id).copy()
        cur.previous_spec = cur.spec
        cur.previous_spec_version = cur.spec_version
        cur.spec = cur.spec.copy()
        cur.spec.task.container.image = image
        cur.spec_version = Version(index=cur.spec_version.index + 1)
        cur.update_status = None
        tx.update(cur)

    store.update(cb)


# --------------------------------------- the live manager and raft groups

#: config 6's services (bench.py ``BENCH_CFG6_SERVICES``)
LIVE_SERVICES = 2
#: the key the live manager's WAL is sealed with; production seals its WAL
#: with a key the certificate authority keeps
LIVE_WAL_KEY = b"swarmkit-live-manager-wal-key"
#: seconds to wait for a raft member to lead (bench.py's bound)
LEADER_TIMEOUT = 15.0
#: the live manager's dispatcher sessions (bench.py's eight)
LIVE_SESSIONS = 8


def live_cluster(n_nodes=HEADLINE_NODES,
                 n_tasks=HEADLINE_TASKS * LIVE_SERVICES,
                 n_services=LIVE_SERVICES):
    """(store, service, nodes, tasks) of bench.py's config 6: ``n_nodes``
    racked nodes and ``n_services`` replicated services with no placement
    preference splitting ``n_tasks`` PENDING tasks (0.1 CPU + 64 MiB each),
    all planned in one tick."""
    return build_cluster(n_nodes, n_tasks, n_services=n_services)


def raft_group(n, root, encoder=None, snapshot_interval=1000,
               tick_interval=None, start=True):
    """(network, {id: RaftNode}) of ``n`` members ``m0``.. over one
    ``LocalNetwork``, each with its own ``MemoryStore`` (its proposer the
    member) and its WAL and snapshots under ``root/<id>``, sealed by
    ``encoder()`` when one is given.  A member whose directory holds a WAL
    boots from it.  ``start=False`` leaves the raft threads to the
    caller."""
    from .state.raft import LocalNetwork, RaftLogger, RaftNode

    net = LocalNetwork()
    ids = [f"m{i}" for i in range(n)]
    members = {}
    for node_id in ids:
        store = MemoryStore()
        logger = RaftLogger(os.path.join(root, node_id),
                            encoder=encoder() if encoder else None)
        rn = RaftNode(node_id, ids, store, logger, net,
                      snapshot_interval=snapshot_interval,
                      tick_interval=tick_interval)
        store._proposer = rn
        members[node_id] = rn
    if start:
        for rn in members.values():
            rn.start()
    return net, members


def wait_leader(members, timeout=LEADER_TIMEOUT):
    """The one member of ``members`` (a dict or a list) that leads and has
    applied its election's no-op, so it takes proposals; RuntimeError
    after ``timeout`` seconds."""
    members = list(members.values()) if isinstance(members, dict) \
        else list(members)
    deadline = time.monotonic() + timeout
    while True:
        leaders = [rn for rn in members
                   if rn.is_leader and rn.core.leader_ready]
        if len(leaders) == 1:
            return leaders[0]
        if time.monotonic() > deadline:
            raise RuntimeError(f"no single raft leader in {timeout} s "
                               f"among {[rn.id for rn in members]}")
        time.sleep(0.01)


def wal_bytes(path):
    """Bytes of every file under ``path`` (a member's WAL and snapshots)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def live_manager(store, planner, proposer="raft", nodes=None, wal_dir=None,
                 around=None):
    """bench.py's ``run_live_manager`` on a store the caller built: one
    tick of a ``Scheduler`` over ``planner`` at the default pipeline depth
    with a single-voter ``RaftNode`` under the store (its WAL in
    ``wal_dir``, else a temporary directory removed afterwards, sealed
    by a ``KeyEncoder`` over ``LIVE_WAL_KEY``) and the live manager's
    subscribers on threads of their own: two control-loop subscriptions,
    a dispatcher session on each of the first eight of ``nodes`` (the
    store's nodes when None) and the metrics consumer.
    ``proposer=None`` runs the same tick with a nil proposer.  ``around``
    wraps the tick: ``around(tick)`` calls ``tick()`` and returns what it
    returns (a tracer, for one).  Kernels build at first use, before any
    tick, so no warm-up tick runs here.

    Fails, as bench.py does, unless every task of the store is ASSIGNED
    and the metrics histogram balances.  Returns the tick's decisions,
    seconds (``tick_s``, ``plan_s``, ``commit_s``, ``fanout_s``), raft's
    ``raft_entries_applied``, ``raft_stats`` and ``wal_bytes``, the
    seconds the propose and apply timers added (``propose_s``,
    ``apply_s``), ``native_commit``, the planner's ``groups_fused``, the
    events each subscriber took, and the scheduler (``sched``)."""
    import shutil
    import tempfile
    import threading

    from . import native
    from .state.events import EventTaskBlock
    from .state.raft import KeyEncoder, LocalNetwork, RaftLogger, RaftNode
    from .utils.metrics import registry

    assert proposer in ("raft", None), proposer
    if nodes is None:
        nodes = store.view(lambda tx: tx.find(Node))
    n_tasks = store.view(lambda tx: len(tx.find(Task)))
    own_dir = wal_dir is None
    tmp = tempfile.mkdtemp(prefix="live-raft-") if own_dir else wal_dir
    rn = None
    stop = threading.Event()
    try:
        if proposer == "raft":
            rn = RaftNode("b0", ["b0"], store,
                          RaftLogger(os.path.join(tmp, "b0"),
                                     encoder=KeyEncoder(LIVE_WAL_KEY)),
                          LocalNetwork())
            store._proposer = rn
            rn.start()
            wait_leader([rn])

        counts, hist = {}, {}
        subs = {"orchestrator": store.queue.subscribe(accepts_blocks=True),
                "reaper": store.queue.subscribe(accepts_blocks=True)}
        session_nodes = [n.id for n in nodes[:LIVE_SESSIONS]]
        for i, nid in enumerate(session_nodes):
            def pred(ev, nid=nid):
                if isinstance(ev, EventTaskBlock):
                    return True   # the per-node probe runs in the consumer
                return getattr(getattr(ev, "obj", None), "node_id",
                               None) == nid
            subs[f"session{i}"] = store.queue.subscribe(
                pred, accepts_blocks=True)
        metrics_sub = store.queue.subscribe(accepts_blocks=True)

        def items(sub):
            try:
                head = sub.get(timeout=0.1)
            except TimeoutError:
                return []
            return [head] + sub.drain()

        def consume(name, sub):
            got = 0
            while not stop.is_set():
                for it in items(sub):
                    if isinstance(it, EventTaskBlock):
                        if name.startswith("session"):
                            nid = session_nodes[int(name[7:])]
                            got += len(it.per_node().get(nid, ()))
                        else:
                            got += len(it)   # a control loop skips it
                    else:
                        got += 1
            for it in sub.drain():
                got += len(it) if isinstance(it, EventTaskBlock) else 1
            counts[name] = got

        def consume_metrics(sub):
            got = 0

            def absorb(batch):
                nonlocal got
                for it in batch:
                    if isinstance(it, EventTaskBlock):
                        for old in it.olds:
                            k = int(old.status.state)
                            hist[k] = hist.get(k, 0) - 1
                        hist[it.state] = hist.get(it.state, 0) + len(it)
                        got += len(it)
                    else:
                        got += 1

            while not stop.is_set():
                absorb(items(sub))
            absorb(sub.drain())
            counts["metrics"] = got

        threads = [threading.Thread(target=consume, args=(k, s),
                                    daemon=True) for k, s in subs.items()]
        threads.append(threading.Thread(target=consume_metrics,
                                        args=(metrics_sub,), daemon=True))
        for t in threads:
            t.start()

        timers = {name: registry.timer(name) for name in (
            "swarm_watch_fanout_latency", "swarm_raft_propose_latency",
            "swarm_raft_apply_latency")}
        totals0 = {name: t.total for name, t in timers.items()}
        fallbacks0 = registry.get_counter("swarm_native_commit_fallbacks")
        stats0 = dict(getattr(planner, "stats", {}))
        tick = (lambda: one_tick(store, planner))
        sched, n_dec, dt = around(tick) if around else tick()
        time.sleep(0.2)   # let the consumers drain the tail
        stop.set()
        for t in threads:
            t.join(timeout=5)
        for sub in list(subs.values()) + [metrics_sub]:
            store.queue.unsubscribe(sub)
        n_assigned = sum(
            1 for t in store.view(lambda tx: tx.find(Task))
            if t.status.state >= TaskState.ASSIGNED and t.node_id)
        if n_assigned < n_tasks:
            raise RuntimeError(f"live manager: only {n_assigned}/{n_tasks} "
                               "tasks ASSIGNED")
        if counts.get("metrics", 0) < n_dec or \
                hist.get(int(TaskState.ASSIGNED), 0) < n_dec:
            raise RuntimeError(f"live manager: the metrics histogram does "
                               f"not balance: {counts} {hist}")
        added = {name: t.total - totals0[name] for name, t in timers.items()}
        stats = getattr(planner, "stats", {})
        return {
            "tasks": n_tasks, "decisions": n_dec, "tick_s": dt,
            "pipeline_depth": sched.pipeline_depth,
            "plan_s": stats.get("plan_seconds", 0.0)
            - stats0.get("plan_seconds", 0.0),
            "commit_s": sched.stats["commit_seconds"],
            "fanout_s": added["swarm_watch_fanout_latency"],
            "propose_s": added["swarm_raft_propose_latency"],
            "apply_s": added["swarm_raft_apply_latency"],
            "native_commit": {
                "enabled": native.commit_enabled(),
                "active": native.get() is not None,
                "fallbacks": int(registry.get_counter(
                    "swarm_native_commit_fallbacks") - fallbacks0)},
            "groups_fused": stats.get("groups_fused", 0)
            - stats0.get("groups_fused", 0),
            "raft_entries_applied": rn.stats["applied"] if rn else 0,
            "raft_stats": dict(rn.stats) if rn else {},
            "wal_bytes": wal_bytes(tmp) if rn else 0,
            "events_delivered": dict(counts), "sched": sched}
    finally:
        stop.set()
        if rn is not None:
            rn.stop()
            store._proposer = None
        if own_dir:
            shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------ tenant burst (config 9)

TENANT_NODES = 256
TENANT_CPU = 2 * 10**9


def tenant_bands(n_nodes=TENANT_NODES):
    """(high band, burst quota, burst, blocked) task counts of config 9
    at ``n_nodes`` nodes of four 2-CPU slots: the high band and the burst
    tenant's quota together stay near 70% of the slots, so the blocked
    service fails on quota, not on capacity."""
    slots = n_nodes * 4
    quota = slots * 3 // 10
    return (slots * 2 // 5, quota, quota + max(slots // 5, 50),
            max(slots // 8, 16))


def tenant_storm(n_nodes=TENANT_NODES):
    """(store, services) of bench.py's config 9, the autoscaler and the
    tenant quotas under a burst: ``n_nodes`` nodes of 8 CPUs / 32 GiB, a
    ``default`` Cluster with quotas for the tenants ``burst`` and ``hi``,
    and three replicated services of 2-CPU tasks, all PENDING: ``hi``
    (priority 2, the high band), ``burst`` (an autoscaled service at 2
    replicas whose tasks outnumber the tenant's quota) and ``blocked``
    (the same tenant, arriving with the quota spent)."""
    from .models import (
        AutoscaleConfig, Cluster, ClusterSpec, TenantQuota,
    )
    from .scheduler.quota import TENANT_LABEL

    n_hi, quota, n_burst, n_blocked = tenant_bands(n_nodes)
    store = MemoryStore()
    store.update(lambda tx: tx.create(Cluster(
        id=new_id(),
        spec=ClusterSpec(
            annotations=Annotations(name="default"),
            tenants={"burst": TenantQuota(nano_cpus=quota * TENANT_CPU),
                     "hi": TenantQuota(nano_cpus=1000 * TENANT_CPU)}))))

    def mk_nodes(tx):
        for i in range(n_nodes):
            tx.create(Node(
                id=new_id(),
                spec=NodeSpec(annotations=Annotations(name=f"q{i:04d}")),
                status=NodeStatus(state=NodeState.READY),
                description=NodeDescription(
                    hostname=f"q{i:04d}",
                    resources=Resources(nano_cpus=8 * 10**9,
                                        memory_bytes=32 << 30))))

    store.update(mk_nodes)
    res = ResourceRequirements(
        reservations=Resources(nano_cpus=TENANT_CPU, memory_bytes=1 << 30))
    plan = (("hi", "hi", 2, n_hi, None),
            ("burst", "burst", 0, n_burst,
             AutoscaleConfig(min_replicas=2, max_replicas=n_burst,
                             target_utilization=1.0,
                             stabilization_window=0.0)),
            ("blocked", "burst", 0, n_blocked, None))
    services = {}

    def mk_services(tx):
        for name, tenant, prio, count, autoscale in plan:
            svc = Service(
                id=new_id(),
                spec=ServiceSpec(
                    annotations=Annotations(name=f"t-{name}",
                                            labels={TENANT_LABEL: tenant}),
                    mode=ServiceMode.REPLICATED,
                    # the burst service starts small, so the autoscaler's
                    # drive commits a real scale-up decision
                    replicated=ReplicatedService(
                        replicas=2 if autoscale else count),
                    task=TaskSpec(resources=res, priority=prio),
                    autoscale=autoscale),
                spec_version=Version(index=1))
            services[name] = svc
            tx.create(svc)

    store.update(mk_services)

    def mk_tasks(tx):
        for name, _tenant, _prio, count, _auto in plan:
            svc = services[name]
            for s in range(count):
                tx.create(Task(
                    id=new_id(), service_id=svc.id, slot=s + 1,
                    desired_state=TaskState.RUNNING, spec=svc.spec.task,
                    spec_version=Version(index=1),
                    service_annotations=svc.spec.annotations,
                    status=TaskStatus(state=TaskState.PENDING)))

    store.update(mk_tasks)
    return store, services


def tenant_storm_pass(store, services, planner):
    """Config 9's timed window on ``store``: one threadless autoscaler
    drive, its sampler reporting the burst service's load as its whole
    task count, then one tick of a ``Scheduler`` over ``planner`` (None:
    the host path).  Returns (scheduler, autoscaler, decisions,
    seconds)."""
    from .orchestrator.autoscaler import Supervisor as AutoscaleSupervisor
    from .scheduler import Scheduler

    burst = services["burst"]
    load = float(burst.spec.autoscale.max_replicas)
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    scaler = AutoscaleSupervisor(
        store, sampler=lambda sid: {"load": load} if sid == burst.id
        else None, start_worker=False)
    t0 = time.perf_counter()
    scaler.drive()
    n_dec = sched.tick()
    return sched, scaler, n_dec, time.perf_counter() - t0


#: the control steps :func:`settle` takes before it gives up
SETTLE_STEPS = 400


def settle(loops):
    """Step ``loops`` until a step writes nothing, let the stub agent
    (:func:`advance_tasks`) move tasks, and repeat until it has none to
    move.  Returns one record a step: (the scheduler's decisions, store
    versions written, {part: seconds}), the agent's seconds under
    ``"agent"`` in the record of the step before it."""
    records = []
    while len(records) < SETTLE_STEPS:
        assigned, wrote = loops.step()
        records.append((assigned, wrote, dict(loops.last)))
        if wrote:
            continue
        t0 = time.perf_counter()
        moved = advance_tasks(loops.store)
        records[-1][2]["agent"] = time.perf_counter() - t0
        if not moved:
            return records
    raise RuntimeError(f"the control loops did not settle in {SETTLE_STEPS} "
                       "steps")


# ------------------------------------------- the million swarm (config 13)

#: config 13's fleet (bench.py's ``run_million_swarm`` defaults): dispatcher
#: sessions, replicas, services, the bound on buffered status updates and
#: the updates an agent reports in one batch
SWARM_AGENTS = 1000
SWARM_REPLICAS = 1_000_000
SWARM_SERVICES = 10
SWARM_PENDING_CAP = 65_536
SWARM_REPORT_BATCH = 1024


def trim_heap():
    """Collect and hand freed arenas back to the system, as bench.py does
    between configs: a multi-GB object graph left behind slows the next
    build's allocations and collections."""
    import ctypes
    import gc
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def million_swarm(planner_factory, n_agents=SWARM_AGENTS,
                  n_replicas=SWARM_REPLICAS, n_services=SWARM_SERVICES,
                  pending_cap=SWARM_PENDING_CAP,
                  report_batch=SWARM_REPORT_BATCH):
    """bench.py's config 13 (``run_million_swarm``): ``n_agents`` real
    dispatcher sessions over one threadless ``Dispatcher`` with the
    batched assignment fan-out carry ``n_replicas`` replicas of
    ``n_services`` services end to end.  The fleet registers (the
    heartbeat stretches past its threshold), every assignment stream
    opens, one timed tick over ``planner_factory()`` (None: the host
    path) places every replica, the fan-out delivers them, and the status
    write-back storm runs against the bounded admission edge
    (``pending_cap`` buffered updates, ``report_batch`` a batch): a batch
    that would overflow it is shed whole with ``ErrOverloaded``, counted
    on both sides and sent again next round until every replica is
    RUNNING.

    Fails unless the shed ledger reconciles exactly, no session expired
    early and every replica is RUNNING.  Returns bench.py's fields, with
    ``compiles`` (kernel builds charged inside the timed tick, by bucket;
    all 0 on a warm process), ``build_s`` (build seconds left unclaimed
    across it), ``launches`` (the tick's kernel launches, by kernel),
    ``planner_stats`` and ``placements`` (creation index -> hostname)."""
    import gc

    from .manager.dispatcher import Config_, Dispatcher, ErrOverloaded
    from .obs import tracer
    from .obs.planes import plane
    from .ops import cuda
    from .ops import kernel as K
    from .ops import preempt as P
    from .utils.metrics import registry

    compile_key = 'swarm_planner_compiles{bucket="'
    kernels = K.KERNELS + P.KERNELS
    # light replicas, as bench.py's config: the default 0.1 CPU caps a
    # 64-CPU node at 640 tasks, short of a million over 1,000 nodes
    rsv = Resources(nano_cpus=2 * 10**7, memory_bytes=16 << 20)

    # a warm-up tick at this config's shapes (node bucket and service
    # count), so no kernel build lands in the timed tick (the small-group
    # router is off by default: one pass takes every route the tick does)
    was_tracing = tracer.enabled
    tracer.disable()
    try:
        warm_store, *_ = build_cluster(n_agents, 16 * n_services,
                                       reservations=rsv,
                                       n_services=n_services)
        one_tick(warm_store, planner_factory())
        del warm_store
        trim_heap()
    finally:
        tracer.enabled = was_tracing

    store, _, nodes, tasks = build_cluster(n_agents, n_replicas,
                                           reservations=rsv,
                                           n_services=n_services)
    host_of = {n.id: n.description.hostname for n in nodes}
    order = [t.id for t in tasks]
    del tasks
    # the session cap just above the fleet, the stretch threshold well
    # under it, the update buffer far under the storm; max_batch_items
    # above the admission bound, so the buffer drains on this driver's
    # flush turns
    d = Dispatcher(store, Config_(
        heartbeat_period=30.0,
        max_batch_items=pending_cap * 2,
        max_sessions=n_agents + 64,
        hb_stretch_start=max(8, n_agents // 16),
        hb_stretch_max=4.0,
        max_pending_updates=pending_cap,
        max_terminal_tasks=max(1024, n_replicas // 64)))
    d.run(start_worker=False)
    fan = d.enable_batched_fanout()
    try:
        t0 = time.perf_counter()
        sessions = {n.id: d.register(n.id)[0] for n in nodes}
        register_s = time.perf_counter() - t0
        stretch = d._stretch_factor()

        t0 = time.perf_counter()
        streams = {n.id: fan.open(n.id, sessions[n.id]) for n in nodes}
        open_s = time.perf_counter() - t0

        def drain_streams():
            msgs = changes = 0
            for s in streams.values():
                while True:
                    try:
                        m = s.get(timeout=0)
                    except Exception:   # TimeoutError / Closed: drained
                        break
                    msgs += 1
                    changes += len(m.changes)
            return msgs, changes

        # the timed tick: no kernel build may land in it
        planner = planner_factory()
        cuda.take_build_seconds()
        compiles0 = registry.counters_snapshot(compile_key)
        launches0 = cuda.launch_counts(kernels)
        plane("scheduler").roll()
        t_create = time.time()
        gc.collect()
        gc.freeze()
        try:
            sched, n_dec, dt = one_tick(store, planner)
        finally:
            gc.unfreeze()
        plane("scheduler").note_busy(dt)
        compiles = {k[len(compile_key):-2]: int(v - compiles0.get(k, 0.0))
                    for k, v in registry.counters_snapshot(
                        compile_key).items()}
        build_s = cuda.take_build_seconds()
        launches = {k: v - launches0[k]
                    for k, v in cuda.launch_counts(kernels).items()}
        planner_stats = dict(getattr(planner, "stats", {}))
        del sched, planner

        # the fan-out: one subscription drains into the per-node sets,
        # each flush sends the incremental batches
        t0 = time.perf_counter()
        fan_msgs = fan_changes = 0
        while True:
            fan.flush()
            m, c = drain_streams()
            fan_msgs += m
            fan_changes += c
            if not m:
                break
        fanout_s = time.perf_counter() - t0

        # the write-back storm against the bounded admission edge
        backlog = {}
        placements = {}
        for t in store.view(lambda tx: tx.find(Task)):
            if t.node_id:
                backlog.setdefault(t.node_id, []).append(t.id)
                placements[t.id] = host_of[t.node_id]
        node_ids = [n.id for n in nodes]
        client = {"shed_batches": 0, "shed_updates": 0, "rounds": 0,
                  "heartbeats": 0}
        sheds0 = d.stats["sheds"]
        plane("dispatcher").roll()
        peak_depth = 0
        t0 = time.perf_counter()
        rr = 0
        while backlog:
            client["rounds"] += 1
            for nid in node_ids:   # keep the sessions' TTL wheel hot
                d.heartbeat(nid, sessions[nid])
                client["heartbeats"] += 1
            shed_this_round = 0
            for _ in range(len(node_ids)):
                nid = node_ids[rr % len(node_ids)]
                rr += 1
                ids = backlog.get(nid)
                if not ids:
                    continue
                chunk = ids[:report_batch]
                ts = time.time()
                ups = [(tid, TaskStatus(state=TaskState.RUNNING,
                                        message="started", timestamp=ts))
                       for tid in chunk]
                try:
                    d.update_task_status(nid, sessions[nid], ups)
                except ErrOverloaded:
                    client["shed_batches"] += 1
                    client["shed_updates"] += len(ups)
                    shed_this_round += 1
                    if shed_this_round >= 4:
                        break   # the edge is saturated: drain first
                    continue
                del ids[:len(chunk)]
                if not ids:
                    del backlog[nid]
            peak_depth = max(peak_depth, len(d._task_updates))
            plane("dispatcher").set_depth(peak_depth)
            with plane("dispatcher").busy():
                d._flush_updates()      # the worker's process turn
                d.process_deadlines()   # the TTL wheel and fan-out flush
            m, c = drain_streams()
            fan_msgs += m
            fan_changes += c
        writeback_s = time.perf_counter() - t0
        shed_count = d.stats["sheds"] - sheds0

        # every shed the dispatcher counted is one a client saw and sent
        # again
        if shed_count != client["shed_updates"]:
            raise RuntimeError(f"config 13: the dispatcher shed {shed_count}"
                               f" updates, the clients saw {client}")
        if d.stats["premature_expirations"]:
            raise RuntimeError(f"config 13: sessions expired early: "
                               f"{d.stats}")
        lat = sorted(
            (t.status.applied_at or t.status.timestamp) - t_create
            for t in store.view(lambda tx: tx.find(Task))
            if t.status.state == TaskState.RUNNING)
        if len(lat) < n_replicas:
            raise RuntimeError(f"config 13: only {len(lat)}/{n_replicas} "
                               "RUNNING")

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        plane("dispatcher").roll()
        plane("scheduler").roll()
        return {
            "agents": n_agents, "replicas": n_replicas,
            "services": n_services, "sessions": len(sessions),
            "decisions": n_dec, "decisions_per_sec": n_dec / dt,
            "tick_s": dt, "register_s": register_s,
            "stream_open_s": open_s, "fanout_s": fanout_s,
            "fanout_messages": fan_msgs, "fanout_changes": fan_changes,
            "fanout_compactions": fan.stats["compactions"],
            "writeback_s": writeback_s,
            "writeback_rounds": client["rounds"],
            "peak_update_depth": peak_depth,
            "heartbeats": client["heartbeats"],
            "hb_stretch_factor": stretch,
            "hb_stretches": d.stats["hb_stretches"],
            "premature_expirations": d.stats["premature_expirations"],
            "expirations": d.stats["expirations"],
            "sheds": {
                "dispatcher": shed_count,
                "client_observed": client["shed_updates"],
                "shed_batches": client["shed_batches"],
                "uncounted": shed_count - client["shed_updates"],
                "unrecovered": n_replicas - len(lat)},
            "time_to_running": {
                "p50_s": pct(0.50), "p90_s": pct(0.90),
                "p99_s": pct(0.99), "max_s": lat[-1], "running": len(lat)},
            "planes": {"dispatcher": plane("dispatcher").report(),
                       "scheduler": plane("scheduler").report()},
            "path": "dispatcher+fanout+writeback",
            "compiles": dict(sorted(compiles.items())),
            "build_s": build_s,
            "launches": launches,
            "planner_stats": planner_stats,
            "placements": [placements.get(tid) for tid in order],
        }
    finally:
        d.stop()
        trim_heap()


# ----------------------------------------------- swarm-bench's end to end

#: bench.py's ``run_e2e``: agents, replicas, and the bound in seconds on
#: each wait
E2E_AGENTS = 5
E2E_REPLICAS = 500
E2E_TIMEOUT = 120.0
#: the manager's dispatcher for the end to end (bench.py's)
E2E_DISPATCHER = dict(heartbeat_period=2.0, process_updates_interval=0.05,
                      assignment_batching_wait=0.05)


def _wait(cond, what):
    """Poll ``cond()`` every 0.1 s until it returns something true and
    return that; RuntimeError after ``E2E_TIMEOUT`` seconds."""
    deadline = time.monotonic() + E2E_TIMEOUT
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what}: not within {E2E_TIMEOUT} s")
        time.sleep(0.1)


def e2e(n_agents=E2E_AGENTS, n_replicas=E2E_REPLICAS, device=None,
        raft_root=None, heal=False):
    """bench.py's ``run_e2e`` (swarm-bench): a ``Manager`` whose leader
    schedules on ``TorchPlanner(device=device)`` (None: the card),
    ``n_agents`` agents with a ``TestExecutor`` on its dispatcher, and one
    replicated service of ``n_replicas`` made through
    ``control_api.create_service``; the seconds from the create to each
    replica's RUNNING, as committed.

    With ``raft_root`` a single-voter ``RaftNode`` (its WAL under that
    directory, sealed) sits under the manager's store, and leadership
    reaches the manager through its leadership worker, as in production.
    With ``heal`` one agent then stops: its node must go DOWN when its
    heartbeat expires, and its tasks must come back RUNNING on the
    others.  Every wait is bounded by ``E2E_TIMEOUT`` seconds and
    raises.  The agents and the manager (and raft) stop before it
    returns.

    Returns the time-to-running percentiles, the journey attribution at
    p99, the replicas a hostname, the leader planner's class and device,
    and with raft the WAL's bytes and the entries applied; with ``heal``
    the seconds from the stop to DOWN and to the last replica RUNNING."""
    from .agent import Agent
    from .agent.testutils import TestExecutor
    from .manager import Manager
    from .manager.dispatcher import Config_
    from .models.specs import ContainerSpec
    from .obs import flightrec
    from .obs.journey import journeys

    # a fresh journey ledger for this window
    journeys.reset(sample_rate=1.0)
    rn = None
    if raft_root is not None:
        from .state.raft import KeyEncoder
        _, members = raft_group(1, raft_root,
                                encoder=lambda: KeyEncoder(LIVE_WAL_KEY))
        rn = members["m0"]
        wait_leader([rn], timeout=E2E_TIMEOUT)
    mgr = None
    agents = []
    try:
        mgr = Manager(raft_node=rn, device=device,
                      dispatcher_config=Config_(**E2E_DISPATCHER))
        mgr.run()

        def leading():
            with mgr._mu:   # held by _become_leader until every loop runs
                return mgr.dispatcher

        dispatcher = _wait(leading, "the manager's leader loops")
        planner = mgr.scheduler.batch_planner
        nodes = []
        for i in range(n_agents):
            node = Node(
                id=new_id(),
                spec=NodeSpec(annotations=Annotations(name=f"bench-w{i}")),
                status=NodeStatus(state=NodeState.READY),
                description=NodeDescription(
                    hostname=f"bench-w{i}",
                    resources=Resources(nano_cpus=64 * 10**9,
                                        memory_bytes=256 << 30)))
            mgr.store.update(lambda tx, node=node: tx.create(node))
            nodes.append(node)
            a = Agent(node.id, TestExecutor(hostname=f"bench-w{i}"),
                      dispatcher)
            a.start()
            agents.append(a)
        host_of = {n.id: n.description.hostname for n in nodes}

        spec = ServiceSpec(
            annotations=Annotations(name="e2e-bench"),
            task=TaskSpec(container=ContainerSpec(image="bench")),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=n_replicas))
        t_create = time.time()
        svc = mgr.control_api.create_service(spec)

        def running():
            done = [t for t in mgr.control_api.list_tasks(
                        service_id=svc.id)
                    if t.status.state == TaskState.RUNNING
                    and t.desired_state == TaskState.RUNNING]
            return done if len(done) >= n_replicas else None

        done = _wait(running, f"{n_replicas} replicas RUNNING")
        lat = sorted((t.status.applied_at or t.status.timestamp) - t_create
                     for t in done)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        flightrec.poll_store()
        per_host = {}
        for t in done:
            per_host[host_of[t.node_id]] = \
                per_host.get(host_of[t.node_id], 0) + 1
        out = {
            "agents": n_agents, "replicas": n_replicas,
            "p50_s": pct(0.50), "p90_s": pct(0.90), "p99_s": pct(0.99),
            "max_s": lat[-1],
            "journey_attribution": journeys.critical_path(0.99),
            "journey_summary": journeys.summary(),
            "per_host": dict(sorted(per_host.items())),
            "planner": type(planner).__name__,
            "planner_device": str(planner.device),
        }
        if heal:
            out["heal"] = _heal(mgr, svc, agents, nodes, n_replicas)
        if rn is not None:
            out["raft_entries_applied"] = rn.stats["applied"]
            out["wal_bytes"] = wal_bytes(raft_root)
        return out
    finally:
        for a in agents:
            a.stop()
        if mgr is not None:
            mgr.stop()
        if rn is not None:
            rn.stop()
            rn.store._proposer = None


def _heal(mgr, svc, agents, nodes, n_replicas):
    """Stop the first agent; its node must go DOWN and its replicas come
    back RUNNING on the others.  Returns the seconds to each."""
    dead = nodes[0].id
    t0 = time.monotonic()
    agents[0].stop()
    _wait(lambda: mgr.store.view(lambda tx: tx.get(Node, dead)).status.state
          == NodeState.DOWN, "the stopped agent's node DOWN")
    down_s = time.monotonic() - t0

    def healed():
        live = [t for t in mgr.control_api.list_tasks(service_id=svc.id)
                if t.desired_state == TaskState.RUNNING]
        return (len(live) == n_replicas
                and all(t.status.state == TaskState.RUNNING
                        and t.node_id != dead for t in live))

    _wait(healed, "the stopped node's replicas RUNNING elsewhere")
    live = [t for t in mgr.control_api.list_tasks(service_id=svc.id)
            if t.desired_state == TaskState.RUNNING]
    per_node = {}
    for t in live:
        per_node[t.node_id] = per_node.get(t.node_id, 0) + 1
    return {"down_s": down_s, "running_s": time.monotonic() - t0,
            "nodes": len(per_node)}


# ------------------------------------------------ the daemons (swarmd.py)

#: three managers, the HA size Docker's swarm documentation recommends,
#: and sixteen workers: twenty replicas a node, 24 after the scale.  The
#: three managers share one interpreter here, and each write passes
#: through three sealed raft members in it: at a hundred a node the
#: replicated orchestrator's create held the store's lock for 74 s and
#: the leader lost its term (NVIDIA H100 host, chip_smoke.py phase 28)
SWARMD_MANAGERS = 3
SWARMD_WORKERS = 16
SWARMD_REPLICAS = 380
SWARMD_SCALED = 432
#: the parity shape: one manager, three workers, three replicas a node;
#: no leader changes there, so a one-second heartbeat is safe
SWARMD_PARITY = dict(n_managers=1, n_workers=3, replicas=12, scale_to=None,
                     stop="worker", heartbeat=1.0)
SWARMD_TIMEOUT = 120.0
#: raft's tick for the managers here.  ``RaftNode`` ticks every 0.02 s
#: and calls an election after 10-20 ticks of silence; three members and
#: sixteen agents in one interpreter starve a member's thread for longer
#: than that, and the leader lost its term in the middle of a create (on
#: the CPU).  At 0.1 s an election needs 1-2 s of silence (phase 25's
#: members in one interpreter tick at 0.3 s); a manager in a process of
#: its own keeps the default
SWARMD_RAFT_TICK_S = 0.1
#: the heartbeat the script sets through ``cluster update`` so a stopped
#: daemon's node goes DOWN in seconds.  After a leader change the new
#: leader's dispatcher waits three periods for each agent to register
#: again, and an agent whose remotes still favour the dead leader's
#: address can take longer than that (``daemon_swarm``'s ``flapped``)
SWARMD_HEARTBEAT_S = 2.0
#: the service's restart delay (``--restart-delay``; Docker's default is
#: 5 s): each wave of replacements after a node goes DOWN waits it out
SWARMD_RESTART_DELAY_S = 1.0


def swarmd_tools(device=None):
    """The port's daemon, CLI and wire clients as ``daemon_swarm`` takes
    them; every daemon gets ``device`` (None: the card)."""
    from types import SimpleNamespace

    from .cli import run_command
    from .net import RemoteControlClient, issue_certificate
    from .swarmd import Swarmd
    return SimpleNamespace(Swarmd=Swarmd, run_command=run_command,
                           RemoteControlClient=RemoteControlClient,
                           issue_certificate=issue_certificate,
                           daemon_kw={"device": device})


def _swarm_wait(cond, what, timeout=SWARMD_TIMEOUT):
    """Poll ``cond()`` every 0.1 s until it returns something true and
    return that; RuntimeError naming ``what`` after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what}: not within {timeout} s")
        time.sleep(0.1)


def _swarm_settled(api, service_id, n, dead=None):
    """The service's tasks desired RUNNING once ``n`` of them run and
    none on ``dead``, else None."""
    live = [t for t in api.list_tasks(service_id=service_id)
            if t.desired_state == TaskState.RUNNING]
    if len(live) == n and all(t.status.state == TaskState.RUNNING
                              and t.node_id != dead for t in live):
        return live
    return None


def _swarm_hosts(api):
    return {n.id: (n.description.hostname if n.description else n.id)
            for n in api.list_nodes()}


def _swarm_per_host(api, tasks):
    host = _swarm_hosts(api)
    per = {}
    for t in tasks:
        per[host[t.node_id]] = per.get(host[t.node_id], 0) + 1
    return dict(sorted(per.items()))


def _swarm_ready(api, n):
    return sum(x.status.state == NodeState.READY
               for x in api.list_nodes()) == n


def swarm_spread_ok(before, after):
    """Whether ``after`` (replicas a hostname) is what a spread makes of
    ``before`` when it places the difference at once: every node that
    gained a replica ends within one of the least loaded node of
    ``after``.  Without a node that came back empty it means every node
    within one of even."""
    lo = min(after.values())
    return all(n <= lo + 1 for h, n in after.items()
               if n > before.get(h, 0))


def _swarm_leader(daemons):
    """The manager daemon whose manager leads with its loops up."""
    for d in daemons:
        m = d.manager
        if (d.raft_node is not None and d.raft_node.is_leader
                and m is not None and m.is_leader
                and m.dispatcher is not None and m.scheduler is not None):
            return d
    return None


def _swarm_cli(tools, managers, op, argv, timeout=SWARMD_TIMEOUT):
    """``cli.run_command(argv)`` through a ``RemoteControlClient`` (the
    operator certificate ``op``) to whichever of ``managers`` leads, again
    after a failure, as a client does around a leadership change.  A
    create that a dropped reply had already committed counts as done.
    RuntimeError with the last error after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        leader = _swarm_leader(managers)
        if leader is not None:
            client = tools.RemoteControlClient(leader.server.addr, op)
            try:
                return tools.run_command(argv, client)
            except Exception as e:
                if type(e).__name__ == "AlreadyExists":
                    return str(e)
                last = e
            finally:
                client.close()
        time.sleep(0.3)
    raise RuntimeError(f"{' '.join(argv)}: not within {timeout} s "
                       f"({last!r})")


def _swarm_planner(daemon):
    p = daemon.manager.scheduler.batch_planner
    if p is None:
        return None, None
    return type(p).__name__, str(p.device)


def daemon_swarm(root, n_managers=SWARMD_MANAGERS, n_workers=SWARMD_WORKERS,
                 replicas=SWARMD_REPLICAS, scale_to=SWARMD_SCALED,
                 stop="leader", heartbeat=SWARMD_HEARTBEAT_S,
                 use_device_scheduler=True, tools=None, snapshot=False,
                 on_running=None):
    """A swarm of ``swarmd`` daemons in this process, on loopback: the
    operator's path from bootstrap to failover.

    ``m0`` bootstraps (raft over TCP with mutual TLS, a sealed WAL under
    ``root/m0``) and, before anyone joins, drops the heartbeat to
    ``heartbeat`` seconds through ``cli.run_command(["cluster", "update",
    ...])`` on its control API; ``m1``.. join with the manager token over
    ``join_raft``; ``n_workers`` daemons join with the worker token; every
    daemon runs the test executor, and each manager's raft ticks every
    ``SWARMD_RAFT_TICK_S``.  The service restarts a replica after
    ``SWARMD_RESTART_DELAY_S``.  Once every node is READY and every
    daemon's remotes hold every manager (heartbeats carry the list), an
    operator certificate (manager token) drives ``cli.run_command(
    ["service", "create", ...])`` through a ``RemoteControlClient`` to the
    leading manager's remote API.  Then ``stop="leader"`` stops the leading
    manager's daemon (``m0`` unless a leadership change came first; its
    manager and its agent): a survivor must take over, building its own
    planner; ``stop="worker"`` stops the first worker.  Either way the
    stopped node must go DOWN and its replicas come back RUNNING on the
    others.  A node besides the stopped one that lost a replica on the way
    is ``flapped`` (it went DOWN: its agent did not register with the new
    leader in time); ``on_leader`` names the workers whose sessions are on
    the leader once every replica runs again.  Then ``scale_to`` scales the
    service through the CLI against the leader, without waiting for a
    flapped node to come back.  Every CLI call goes to whichever manager
    leads and is made again after a failure, as a client does around a
    leadership change. ``state_dir`` is a surviving follower's state dir;
    with ``snapshot`` that follower snapshots after one more write (the
    scale said again), so its sealed state dir holds the final store.

    ``tools`` is ``swarmd_tools(device)`` (the default: the card) or
    another package's daemon, CLI and clients with the same names.
    ``on_running(leader)`` is called once every replica first runs.  Every
    wait is bounded by ``SWARMD_TIMEOUT`` seconds and raises; every daemon
    is stopped before this returns.

    Returns the replicas a hostname after the create, the heal and the
    scale, the seconds from the create to each replica's RUNNING as the
    store committed it, the seconds from the stop to a new leader, to DOWN
    and to RUNNING, the leader's planner class and device before and after
    the stop, and that state dir."""
    tools = tools or swarmd_tools()
    run = tools.run_command
    daemons, managers, workers = [], [], []

    def make(name, **kw):
        d = tools.Swarmd(state_dir=os.path.join(root, name), hostname=name,
                         executor="test",
                         use_device_scheduler=use_device_scheduler,
                         **tools.daemon_kw, **kw)
        daemons.append(d)
        d.start()
        if d.raft_node is not None:
            d.raft_node.tick_interval = SWARMD_RAFT_TICK_S
        return d

    n_nodes = n_managers + n_workers
    out = {"managers": n_managers, "workers": n_workers,
           "replicas": replicas, "heartbeat_s": heartbeat}
    try:
        t0 = time.monotonic()
        m0 = make("m0", manager=True, listen_remote_api=("127.0.0.1", 0))
        managers.append(m0)
        api = m0.manager.control_api
        out["heartbeat"] = run(["cluster", "update", "--heartbeat-period",
                                f"{heartbeat:g}"], api)
        # the dispatcher takes the period from its store watch; an agent
        # that registers before that keeps the old one until it beats
        _swarm_wait(lambda: m0.manager.dispatcher.config.heartbeat_period
                    == heartbeat, "the dispatcher on the new heartbeat")
        mtoken = m0.manager.root_ca.join_token(NodeRole.MANAGER)
        wtoken = m0.manager.root_ca.join_token(NodeRole.WORKER)
        for i in range(1, n_managers):
            managers.append(make(
                f"m{i}", manager=True, join_addr=m0.server.addr,
                join_token=mtoken, listen_remote_api=("127.0.0.1", 0)))
        for i in range(n_workers):
            workers.append(make(f"w{i}", join_addr=m0.server.addr,
                                join_token=wtoken))
        _swarm_wait(lambda: _swarm_ready(api, n_nodes),
                    f"{n_nodes} nodes READY")
        _swarm_wait(lambda: all(len(d.remotes.weights()) >= n_managers
                                for d in daemons),
                    f"every daemon's remotes holding the {n_managers} "
                    "managers")
        out["bootstrap_s"] = time.monotonic() - t0

        op = tools.issue_certificate(m0.server.addr, new_id(), mtoken)
        t_create = time.time()
        out["create"] = _swarm_cli(tools, managers, op, [
            "service", "create", "--name", "web", "--image", "nginx:alpine",
            "--replicas", str(replicas), "--restart-delay",
            f"{SWARMD_RESTART_DELAY_S:g}"])
        svc = next(s for s in api.list_services()
                   if s.spec.annotations.name == "web")
        done = _swarm_wait(lambda: _swarm_settled(api, svc.id, replicas),
                           f"{replicas} replicas RUNNING")
        lat = sorted((t.status.applied_at or t.status.timestamp) - t_create
                     for t in done)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        out["time_to_running"] = {"p50_s": pct(0.50), "p90_s": pct(0.90),
                                  "p99_s": pct(0.99), "max_s": lat[-1]}
        out["per_host"] = {"create": _swarm_per_host(api, done)}
        leader = _swarm_wait(lambda: _swarm_leader(managers),
                             "a manager leading with its loops")
        out["planner"], out["planner_device"] = _swarm_planner(leader)
        if on_running is not None:
            on_running(leader)

        victim = leader if stop == "leader" else workers[0]
        out["stopped"] = victim.hostname
        dead = victim.node.node_id
        survivors = [d for d in managers if d is not victim]
        workers = [d for d in workers if d is not victim]
        t1 = time.monotonic()
        daemons.remove(victim)
        victim.stop()
        leader = _swarm_wait(lambda: _swarm_leader(survivors),
                             "a surviving manager leading with its loops")
        out["leader_s"] = time.monotonic() - t1
        out["leader"] = leader.hostname
        out["new_planner"], out["new_planner_device"] = \
            _swarm_planner(leader)
        # any survivor's store holds what the leader committed
        api = survivors[0].manager.control_api
        _swarm_wait(lambda: api.get_node(dead).status.state
                    == NodeState.DOWN, "the stopped daemon's node DOWN")
        out["down_s"] = time.monotonic() - t1
        live = _swarm_wait(
            lambda: _swarm_settled(api, svc.id, replicas, dead),
            "the stopped node's replicas RUNNING elsewhere")
        out["running_s"] = time.monotonic() - t1
        host = _swarm_hosts(api)
        out["per_host"]["heal"] = _swarm_per_host(api, live)
        # a node that lost a replica it ran before the stop went DOWN on
        # the way and came back, if at all, empty
        kept = {t.id for t in live}
        out["flapped"] = sorted({host[t.node_id] for t in done
                                 if t.id not in kept and t.node_id != dead})
        # the agents that registered with the new leader in its window
        cur = _swarm_wait(lambda: _swarm_leader(survivors),
                          "a surviving manager leading with its loops")
        out["on_leader"] = sorted(
            d.hostname for d in workers
            if getattr(d.node.agent.client, "_current", None)
            == cur.server.addr)

        if scale_to is not None:
            t3 = time.monotonic()
            out["scale"] = _swarm_cli(tools, survivors, op, [
                "service", "scale", f"web={scale_to}"])
            scaled = _swarm_wait(
                lambda: _swarm_settled(api, svc.id, scale_to, dead),
                f"{scale_to} replicas RUNNING")
            out["scale_s"] = time.monotonic() - t3
            out["per_host"]["scale"] = _swarm_per_host(api, scaled)
        leader = _swarm_wait(lambda: _swarm_leader(survivors),
                             "a surviving manager leading with its loops")
        out["final_leader"] = leader.hostname
        keep = next((d for d in survivors if d is not leader), leader)
        t3 = time.monotonic()
        if snapshot:
            # rafttool's dump-object reads the snapshot: a follower
            # snapshots after the next applied entry (a leader busy
            # sealing the whole store would miss its heartbeats)
            snaps = keep.raft_node.stats["snapshots"]
            interval = keep.raft_node.snapshot_interval
            keep.raft_node.snapshot_interval = 1
            _swarm_cli(tools, survivors, op, [
                "service", "scale", f"web={scale_to or replicas}"])
            _swarm_wait(lambda: keep.raft_node.stats["snapshots"] > snaps,
                        f"a snapshot on {keep.hostname}")
            keep.raft_node.snapshot_interval = interval
            out["snapshot_s"] = time.monotonic() - t3
        out["state_dir"] = keep.state_dir
    finally:
        t2 = time.monotonic()
        for d in reversed(daemons):
            d.stop()
        out["stop_s"] = time.monotonic() - t2
    return out


# ------------------------------------------------------------- simulator

#: the simulator's scenarios whose fault timelines run a device planner:
#: three build their own (``TorchPlanner(device=sim.device)``) and seven
#: set ``cp.planner_factory``, so every new leader builds one mid-run
SIM_DEVICE_SCENARIOS = (
    "pipelined-commit-churn", "fused-differential-churn",
    "steady-state-churn", "leader-crash-mid-tick", "leader-crash-mid-tick-d1",
    "partition-pipelined-commit", "partition-pipelined-commit-d1",
    "preemption-storm", "tenant-storm", "gang-deadlock")


def sim_obs_events(obs_trace: str, drop=("plan.compile",)) -> list:
    """A sim report's span trace (``SimReport.obs_trace``) as a list of
    events two runs can be compared by: the spans named in ``drop`` left
    out, and each span's ``span_id`` and ``parent_id`` replaced by its
    parent's name (a left-out span shifts every later id).  On the card
    the first kernel build in a process records one ``plan.compile``;
    against the reference's planner, drop ``plan.refresh`` as well (the
    port's resident-state span, which the reference does not record)."""
    events = json.loads(obs_trace)["traceEvents"]
    names = {e["args"]["span_id"]: e["name"] for e in events
             if "span_id" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("name") in drop:
            continue
        args = dict(e.get("args", {}))
        if "span_id" in args:
            del args["span_id"]
            args["parent"] = names.get(args.pop("parent_id", None))
        out.append({**e, "args": args})
    return out
