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
"""

from __future__ import annotations

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


# ------------------------------------------------------ per-host spread

PER_HOST_NODES = 8200
PER_HOST_SERVICES = (8200, 8200)


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
