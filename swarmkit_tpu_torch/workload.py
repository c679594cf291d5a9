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
"""

from __future__ import annotations

import os
import random
import time

from .models import (
    Annotations, GangConfig, Node, NodeDescription, NodeSpec, NodeState,
    NodeStatus, Placement, PlacementPreference, Platform, ReplicatedJob,
    ReplicatedService, Resources, ResourceRequirements, Service, ServiceMode,
    ServiceSpec, SpreadOver, Task, TaskSpec, TaskState, TaskStatus, Version,
)
from .models.types import now
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
                  global_share=0.0, n_services=1):
    """(store, service, nodes, tasks) for a synthetic cluster whose tasks
    reserve 0.1 CPU and 64 MiB each.  ``n_services`` replicated services
    (``bench-0``, ...) split ``n_tasks`` evenly, the last taking the
    remainder; ``service`` is the first of them."""
    store = MemoryStore()
    nodes = rack_nodes(n_nodes, node_labels, node_platform)
    shared_spec = TaskSpec(
        placement=Placement(constraints=constraints or [],
                            platforms=platforms or [],
                            preferences=prefs or []),
        resources=ResourceRequirements(
            reservations=Resources(nano_cpus=10**8, memory_bytes=64 << 20)))

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
