"""The port's orchestrators and task allocator against the reference's.

Each test drives one script through both packages, threadless, with one
fixed model clock (``models.types.set_time_source``, moved only by the
script) and one id counter a package (``utils.identity.set_id_source``):
the port through ``workload.ControlLoops`` and ``workload.advance_tasks``
(the stub agent), the reference through the same order written out here
(``RefLoops``, ``ref_advance``) over its own classes.  After every step
of the script every store row's ``serde.to_dict`` must be equal in the
two packages: every comparison is exact.

Scripts: a replicated service created and scaled; task exits under each
restart condition, the delay and the ``max_attempts`` window; node down,
drain and delete; a global service across node join, leave, drain and
constraint changes; rolling updates stop-first and start-first, a failure
that pauses and one that rolls back; the task allocator's ports and
addresses; the startup consistency pass on an inconsistent store; and the
slice as a whole (the orchestrated storm of ``chip_smoke.py``'s phase 22
at 64 nodes) through ``TorchPlanner(device="cpu")`` and ``TPUPlanner``.
Jobs, enforcers, the reaper, the autoscaler and the pipeline are in
``test_torch_orchestrator_jobs.py``.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import importlib  # noqa: E402
import itertools  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from swarmkit_tpu_torch import workload  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0
KINDS = ("Cluster", "Node", "Network", "Volume", "Service", "Task")


class Pkg:
    """One package's modules the scripts use."""

    def __init__(self, name):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        self.name = name
        self.m = mod("models")
        self.types = mod("models.types")
        self.serde = mod("state.serde")
        self.state = mod("state")
        self.events = mod("state.events")
        self.identity = mod("utils.identity")
        self.orch = mod("orchestrator")
        self.taskinit = mod("orchestrator.taskinit")
        self.allocator = mod("manager.allocator")


PKGS = {name: Pkg(name) for name in (REF, PORT)}


class RefLoops:
    """The reference simulator's control step (``sim/cluster.py``
    ``ClusterControl.cold_start`` and ``step``, minus the dispatcher) over
    the reference's classes: the scheduler's mirror rebuilt every step
    (``_resync``), the allocator, the replicated, global and jobs
    orchestrators, the rolling-update, autoscale, pipeline and restart
    supervisors.  ``workload.ControlLoops`` feeds its scheduler by store
    events instead, so the rows compared after every step hold that
    mirror to the simulator's.  ``feed="events"`` feeds the reference's
    scheduler as its own event loop (``Scheduler.run``) does, for the
    scripts whose placements read a node's recent failures: ``_resync``
    forgets them (``NodeInfo.task_failed``), the event loop keeps them."""

    def __init__(self, store, planner=None, sampler=None, feed="resync"):
        from swarmkit_tpu.manager.allocator import Allocator
        from swarmkit_tpu.orchestrator.autoscaler import (
            Supervisor as AutoscaleSupervisor,
        )
        from swarmkit_tpu.orchestrator.global_ import (
            Orchestrator as GlobalOrchestrator,
        )
        from swarmkit_tpu.orchestrator.jobs import (
            Orchestrator as JobsOrchestrator,
        )
        from swarmkit_tpu.orchestrator.pipeline import PipelineSupervisor
        from swarmkit_tpu.orchestrator.replicated import (
            Orchestrator as ReplicatedOrchestrator,
        )
        from swarmkit_tpu.orchestrator.restart import (
            Supervisor as RestartSupervisor,
        )
        from swarmkit_tpu.orchestrator.update import (
            Supervisor as UpdateSupervisor,
        )
        from swarmkit_tpu.scheduler import Scheduler
        from swarmkit_tpu.scheduler.filters import VolumesFilter

        assert feed in ("resync", "events"), feed
        self.feed = feed
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

    def cold_start(self):
        from swarmkit_tpu.orchestrator import taskinit

        store = self.store
        if self.feed == "resync":
            store.view(self.scheduler._setup_tasks_list)
        else:
            _, self._sched_sub = store.view_and_watch(
                self.scheduler._setup_tasks_list, accepts_blocks=True)
        sub = store.queue.subscribe(accepts_blocks=True)
        self._drivers.append((self.allocator, sub, self.allocator._tick))
        self.allocator._resync()
        for orch, tick in ((self.replicated, self.replicated._tick),
                           (self.global_, self.global_._tick_tasks),
                           (self.jobs, self.jobs._tick)):
            sub = store.queue.subscribe(accepts_blocks=True)
            self._drivers.append((orch, sub, tick))
            taskinit.check_tasks(store, store.view(), orch, self.restarts)
            orch._resync()

    @staticmethod
    def _intake(orch, sub, tick):
        from swarmkit_tpu.state.events import Event, EventSnapshotRestore

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
        version = self.store.version
        sched = self.scheduler
        if self.feed == "resync":
            sched._resync()
        else:
            self._intake(sched, self._sched_sub, lambda: None)
        n_pre = len(sched.pending_preassigned_tasks)
        if n_pre:
            sched._process_preassigned_tasks()
        decided = n_pre - len(sched.pending_preassigned_tasks)
        decided += sched.tick()
        for orch, sub, tick in self._drivers:
            self._intake(orch, sub, tick)
        for orch in (self.replicated, self.global_):
            orch.updater.drive()
        self.autoscaler.drive()
        self.pipeline.drive()
        self.restarts.drive()
        return decided, self.store.version - version


def ref_advance(store):
    """``workload.advance_tasks`` over the reference's classes."""
    from swarmkit_tpu.models import Task, TaskState, TaskStatus
    from swarmkit_tpu.models.types import now

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


class EnforcerDriver:
    """An enforcer's event loop (``_EnforcerLoop.run``) without its
    thread: subscribe with its predicate, the initial pass, then each
    drive hands it the events that arrived."""

    def __init__(self, pkg, enforcer, store):
        self.pkg, self.enforcer = pkg, enforcer
        _, self.sub = store.view_and_watch(
            enforcer._init, predicate=enforcer._pred, accepts_blocks=True)
        enforcer._initial_pass()

    def drive(self):
        while True:
            ev = self.sub.poll()
            if ev is None:
                return
            if isinstance(ev, self.pkg.events.Event):
                self.enforcer._handle(ev)


class ReaperDriver:
    """The task reaper's event loop (``TaskReaper.run``) without its
    thread or its batching timer: each drive takes the events that
    arrived, then ticks."""

    def __init__(self, pkg, store):
        m = pkg.m
        state = pkg.state
        self.pkg = pkg
        self.reaper = reaper = pkg.orch.TaskReaper(store)

        def init(tx):
            for c in tx.find(m.Cluster, state.ByName("default")):
                reaper.task_history = \
                    c.spec.orchestration.task_history_retention_limit

        _, self.sub = store.view_and_watch(init, accepts_blocks=True)

    def drive(self):
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            if isinstance(ev, self.pkg.events.Event):
                self.reaper._handle_event(ev)
        self.reaper.tick()


class World:
    """One package's store, its control loops and the extra loops a
    script asks for (``constraint``, ``volume``, ``reaper``)."""

    def __init__(self, pkg, planner=None, sampler=None, store=None,
                 feed="resync"):
        self.p = pkg
        self.store = store if store is not None else pkg.state.MemoryStore()
        if pkg.name == PORT:
            self.loops = workload.ControlLoops(self.store, planner, sampler)
        else:
            self.loops = RefLoops(self.store, planner, sampler, feed)
        self.extras = []

    def start(self, extras=()):
        self.loops.cold_start()
        for name in extras:
            if name == "reaper":
                self.extras.append(ReaperDriver(self.p, self.store))
            else:
                cls = {"constraint": self.p.orch.ConstraintEnforcer,
                       "volume": self.p.orch.VolumeEnforcer}[name]
                self.extras.append(EnforcerDriver(self.p, cls(self.store),
                                                  self.store))

    def step(self):
        version = self.store.version
        decided, _ = self.loops.step()
        for x in self.extras:
            x.drive()
        if self.p.name == PORT:
            self.check_mirror()
        return decided, self.store.version - version

    def check_mirror(self):
        """The port's event-fed scheduler mirror, once it has taken the
        events so far (what its next step's intake would take), must
        equal a mirror built afresh from the store, as the reference
        simulator's per-step ``_resync`` builds it."""
        from swarmkit_tpu_torch.scheduler import Scheduler

        loops = self.loops
        loops._intake(loops.scheduler, loops._sched_sub, lambda: None)
        fresh = Scheduler(self.store)
        self.store.view(fresh._setup_tasks_list)
        assert mirror(loops.scheduler, self.p.serde) == \
            mirror(fresh, self.p.serde)

    def agent(self):
        if self.p.name == PORT:
            return workload.advance_tasks(self.store)
        return ref_advance(self.store)

    def rows(self):
        serde, m = self.p.serde, self.p.m

        def read(tx):
            return [(kind, o.id, serde.to_dict(o)) for kind in KINDS
                    for o in sorted(tx.find(getattr(m, kind)),
                                    key=lambda o: o.id)]
        return self.store.view(read)

    def tasks(self, service_id=None):
        m = self.p.m
        return sorted((t for t in self.store.view(lambda tx: tx.find(m.Task))
                       if service_id is None or t.service_id == service_id),
                      key=lambda t: t.id)

    def service(self, sid):
        return self.store.view(lambda tx: tx.get(self.p.m.Service, sid))


def mirror(sched, serde):
    """What a scheduler's mirror holds, by id: the queued, preassigned and
    known tasks, and each node's row (its object, tasks, counts, free
    resources and host ports; a service counted 0 counts as absent).
    Each node's recent failures are left out: only the event intake
    records them."""
    nodes = {nid: (serde.to_dict(i.node), sorted(i.tasks),
                   i.active_tasks_count,
                   sorted((k, v) for k, v in
                          i.active_tasks_count_by_service.items() if v),
                   serde.to_dict(i.available_resources),
                   sorted(map(repr, i.used_host_ports)))
             for nid, i in sched.node_set.nodes.items()}
    return (sorted(sched.unassigned_tasks),
            sorted(sched.pending_preassigned_tasks),
            sorted(sched.all_tasks), nodes)


class Twin:
    """The reference's world and the port's, driven in lockstep; rows are
    compared after every operation."""

    def __init__(self, clock, planners=(None, None), sampler=None,
                 ref_feed="resync"):
        self.clock = clock
        self.ref = World(PKGS[REF], planners[0], sampler, feed=ref_feed)
        self.port = World(PKGS[PORT], planners[1], sampler)
        self.compares = 0

    @property
    def worlds(self):
        return (self.ref, self.port)

    def compare(self):
        a, b = self.ref.rows(), self.port.rows()
        assert len(a) == len(b), (len(a), len(b))
        for ra, rb in zip(a, b):
            assert ra == rb, f"rows differ: {ra[:2]}"
        self.compares += 1

    def apply(self, op):
        """``op(world)`` on both worlds; returns the port's result, which
        must equal the reference's."""
        got = [op(w) for w in self.worlds]
        assert got[0] == got[1], got
        self.compare()
        return got[1]

    def start(self, extras=()):
        self.apply(lambda w: w.start(extras))

    def step(self):
        return self.apply(lambda w: w.step())

    def settle(self, max_steps=200, after_step=None):
        """Steps until a step writes nothing, then the agent, until the
        agent has nothing to move; returns the decisions made.
        ``after_step`` (an operation) runs after every step."""
        decided = 0
        for _ in range(max_steps):
            d, wrote = self.step()
            decided += d
            if after_step is not None and self.apply(after_step):
                continue
            if wrote:
                continue
            if not self.apply(lambda w: w.agent()):
                return decided
        raise AssertionError("the loops did not settle")

    def tick_clock(self, dt):
        self.clock[0] += dt

    def until(self, done, dt=1.0, rounds=40):
        """Settle, and move the clock ``dt`` until ``done(port world)``."""
        for _ in range(rounds):
            self.settle()
            if done(self.port):
                return
            self.tick_clock(dt)
        raise AssertionError("the script's condition never held")


@pytest.fixture(autouse=True)
def registries_left_as_found():
    """The orchestrators export gauges and timers (rollout states,
    autoscale flaps, lifecycle latencies under the fixed clock) into each
    package's process-wide metrics registry, which later tests in the
    same process read (the reference's health plane): each test here
    leaves both registries' gauges and timers as it found them.  Counters
    only grow and are read as deltas; they stay (a compile counter must
    stay beside the jit cache it counts)."""
    regs = [importlib.import_module(f"{name}.utils.metrics").registry
            for name in (REF, PORT)]
    saved = [(dict(r.gauges), {k: (list(t._buf), t._i, t.count, t.total)
                               for k, t in r.timers.items()})
             for r in regs]
    yield
    for r, (gauges, timers) in zip(regs, saved):
        r.gauges.clear()
        r.gauges.update(gauges)
        for name, t in r.timers.items():
            t.reset()
            if name in timers:
                t._buf, t._i, t.count, t.total = timers[name]


@pytest.fixture
def clock():
    """One fixed model clock for both packages and an id counter each."""
    t = [T0]
    for pkg in PKGS.values():
        pkg.types.set_time_source(lambda: t[0])
        n = itertools.count()
        pkg.identity.set_id_source(lambda n=n: f"id{next(n):08d}")
    try:
        yield t
    finally:
        for pkg in PKGS.values():
            pkg.types.set_time_source(None)
            pkg.identity.set_id_source(None)


# ------------------------------------------------------------ the objects

def cluster(m, retention=5):
    return m.Cluster(id="cluster-default", spec=m.ClusterSpec(
        annotations=m.Annotations(name="default"),
        orchestration=m.OrchestrationConfig(
            task_history_retention_limit=retention)))


def node(m, i, labels=None, cpus=8):
    name = f"n{i:03d}"
    return m.Node(
        id=name,
        spec=m.NodeSpec(annotations=m.Annotations(
            name=name, labels=dict(labels if labels is not None
                                   else {"rack": f"r{i % 2}"}))),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(
            hostname=name,
            platform=m.Platform(os="linux", architecture="amd64"),
            resources=m.Resources(nano_cpus=cpus * 10**9,
                                  memory_bytes=32 << 30)))


def task_spec(m, image="img:1", restart=None, constraints=(), cpus=0.5,
              networks=()):
    return m.TaskSpec(
        container=m.ContainerSpec(image=image),
        restart=restart if restart is not None
        else m.RestartPolicy(delay=0.0),
        placement=m.Placement(constraints=list(constraints)),
        resources=m.ResourceRequirements(reservations=m.Resources(
            nano_cpus=int(cpus * 10**9), memory_bytes=64 << 20)),
        networks=[m.NetworkAttachmentConfig(target=n) for n in networks])


def replicated(m, name, replicas, update=None, rollback=None, endpoint=None,
               **task):
    return m.Service(
        id=f"svc-{name}",
        spec=m.ServiceSpec(
            annotations=m.Annotations(name=name), task=task_spec(m, **task),
            mode=m.ServiceMode.REPLICATED,
            replicated=m.ReplicatedService(replicas=replicas),
            update=update, rollback=rollback, endpoint=endpoint),
        spec_version=m.Version(index=1))


def global_service(m, name, **task):
    return m.Service(
        id=f"svc-{name}",
        spec=m.ServiceSpec(annotations=m.Annotations(name=name),
                           task=task_spec(m, **task),
                           mode=m.ServiceMode.GLOBAL),
        spec_version=m.Version(index=1))


# ------------------------------------------------------------ operations

def create(*factories):
    """An operation creating every object the factories make."""
    def op(w):
        def cb(tx):
            for f in factories:
                tx.create(f(w.p.m))
        w.store.update(cb)
    return op


def edit(kind, oid, fn):
    """An operation: ``fn(copy, models)`` on one object, written back."""
    def op(w):
        def cb(tx):
            cur = tx.get(getattr(w.p.m, kind), oid).copy()
            fn(cur, w.p.m)
            tx.update(cur)
        w.store.update(cb)
    return op


def delete(kind, oid):
    def op(w):
        w.store.update(lambda tx: tx.delete(getattr(w.p.m, kind), oid))
    return op


def scale(sid, n):
    def fn(s, m):
        s.spec = s.spec.copy()
        s.spec.replicated.replicas = n
    return edit("Service", sid, fn)


def roll_out(sid, image):
    """A new image with the previous spec kept and the version bumped, as
    the control API's service update does."""
    def fn(s, m):
        s.previous_spec = s.spec
        s.previous_spec_version = s.spec_version
        s.spec = s.spec.copy()
        s.spec.task.container.image = image
        s.spec_version = m.Version(index=s.spec_version.index + 1)
        s.update_status = None
    return edit("Service", sid, fn)


def exit_task(sid, state="FAILED", slot=None, node_id=None):
    """An operation: the lowest-id running task of ``sid`` (in ``slot`` or
    on ``node_id`` where given; desired RUNNING, or COMPLETE for a job)
    reports ``state``."""
    def op(w):
        m = w.p.m

        def cb(tx):
            live = sorted(
                (t for t in tx.find(m.Task) if t.service_id == sid
                 and (slot is None or t.slot == slot)
                 and (node_id is None or t.node_id == node_id)
                 and t.desired_state in (m.TaskState.RUNNING,
                                         m.TaskState.COMPLETE)
                 and t.status.state == m.TaskState.RUNNING),
                key=lambda t: t.id)
            t = live[0].copy()
            t.status = m.TaskStatus(state=getattr(m.TaskState, state),
                                    timestamp=w.p.types.now(),
                                    err="task exited")
            tx.update(t)
        w.store.update(cb)
    return op


def fail_image(image):
    """An operation: every running task of ``image`` fails (an image
    that crashes at start)."""
    def op(w):
        m = w.p.m

        def cb(tx):
            n = 0
            for t in sorted(tx.find(m.Task), key=lambda t: t.id):
                if t.spec.container.image == image and \
                        t.status.state == m.TaskState.RUNNING:
                    t = t.copy()
                    t.status = m.TaskStatus(state=m.TaskState.FAILED,
                                            timestamp=w.p.types.now(),
                                            err="crash")
                    tx.update(t)
                    n += 1
            return n
        return w.store.update(cb)
    return op


def live(world, sid):
    """The port's tasks of ``sid`` desired RUNNING and running."""
    m = world.p.m
    return [t for t in world.tasks(sid)
            if t.desired_state == m.TaskState.RUNNING
            and t.status.state == m.TaskState.RUNNING]


def run_twin(clock, n_nodes=4, extras=(), planners=(None, None),
             retention=5, labels=None, ref_feed="resync"):
    twin = Twin(clock, planners, ref_feed=ref_feed)
    twin.apply(create(lambda m: cluster(m, retention), *(
        (lambda m, i=i: node(m, i, labels(i) if labels else None))
        for i in range(n_nodes))))
    twin.start(extras)
    return twin


# ------------------------------------------------------------- replicated

def test_replicated_create_scale_up_and_down(clock):
    twin = run_twin(clock)
    twin.apply(create(lambda m: replicated(m, "web", 6)))
    assert twin.settle() == 6
    assert len(live(twin.port, "svc-web")) == 6
    twin.apply(scale("svc-web", 9))
    assert twin.settle() == 3
    twin.apply(scale("svc-web", 2))
    twin.settle()
    assert len(live(twin.port, "svc-web")) == 2
    m = twin.port.p.m
    assert sum(t.desired_state == m.TaskState.REMOVE
               for t in twin.port.tasks("svc-web")) == 7
    assert twin.compares > 20


@pytest.mark.parametrize("condition", ["ANY", "ON_FAILURE", "NONE"])
def test_task_exits_under_each_restart_condition(clock, condition):
    twin = run_twin(clock)

    def svc(m):
        return replicated(m, "web", 3, restart=m.RestartPolicy(
            condition=getattr(m.RestartCondition, condition), delay=5.0))
    twin.apply(create(svc))
    twin.settle()
    twin.apply(exit_task("svc-web", "FAILED", slot=1))
    twin.settle()
    twin.tick_clock(2.0)
    twin.settle()
    twin.tick_clock(4.0)          # past the 5 s restart delay
    twin.settle()
    twin.apply(exit_task("svc-web", "COMPLETE", slot=2))
    twin.settle()
    twin.tick_clock(6.0)
    twin.settle()
    running = {t.slot for t in live(twin.port, "svc-web")}
    want = {"ANY": {1, 2, 3}, "ON_FAILURE": {1, 3}, "NONE": {3}}[condition]
    assert running == want


@pytest.mark.parametrize("window", [0.0, 20.0], ids=["no_window",
                                                     "window"])
def test_restart_max_attempts(clock, window):
    twin = run_twin(clock)

    def svc(m):
        return replicated(m, "web", 1, restart=m.RestartPolicy(
            condition=m.RestartCondition.ANY, delay=1.0, max_attempts=2,
            window=window))
    twin.apply(create(svc))
    twin.settle()
    restarts = []
    for _ in range(4):
        if live(twin.port, "svc-web"):
            twin.apply(exit_task("svc-web", "FAILED"))
        twin.settle()
        twin.tick_clock(2.0)
        twin.settle()
        restarts.append(len(live(twin.port, "svc-web")))
        if window:
            twin.tick_clock(window / 2)
    if window:
        # each restart ages out of the window before the next failure
        assert restarts == [1, 1, 1, 1]
    else:
        assert restarts == [1, 1, 0, 0]


@pytest.mark.parametrize("event", ["down", "drain", "delete"])
def test_node_down_drain_delete(clock, event):
    twin = run_twin(clock)
    twin.apply(create(lambda m: replicated(m, "web", 8)))
    twin.settle()
    m = twin.port.p.m
    on = {t.id for t in twin.port.tasks("svc-web") if t.node_id == "n001"}
    assert on
    if event == "down":
        def fn(n, m):
            n.status = m.NodeStatus(state=m.NodeState.DOWN)
        twin.apply(edit("Node", "n001", fn))
    elif event == "drain":
        def fn(n, m):
            n.spec.availability = m.NodeAvailability.DRAIN
        twin.apply(edit("Node", "n001", fn))
    else:
        twin.apply(delete("Node", "n001"))
    twin.settle()
    alive = live(twin.port, "svc-web")
    assert len(alive) == 8
    assert all(t.node_id != "n001" for t in alive)
    assert all(t.desired_state > m.TaskState.RUNNING
               for t in twin.port.tasks("svc-web") if t.id in on)


# ----------------------------------------------------------------- global

def test_global_service_across_node_changes(clock):
    twin = run_twin(clock, n_nodes=3,
                    labels=lambda i: {"tier": "web" if i < 2 else "db"})
    twin.apply(create(lambda m: global_service(
        m, "agent", constraints=["node.labels.tier==web"])))
    twin.settle()
    on = lambda: sorted(t.node_id for t in live(twin.port, "svc-agent"))
    assert on() == ["n000", "n001"]
    twin.apply(create(lambda m: node(m, 3, {"tier": "web"})))   # join
    twin.settle()
    assert on() == ["n000", "n001", "n003"]
    twin.apply(delete("Node", "n000"))                          # leave
    twin.settle()
    assert on() == ["n001", "n003"]

    def drain(n, m):
        n.spec.availability = m.NodeAvailability.DRAIN
    twin.apply(edit("Node", "n001", drain))
    twin.settle()
    assert on() == ["n003"]

    def relabel(n, m):
        n.spec.annotations.labels = {"tier": "web"}
    twin.apply(edit("Node", "n002", relabel))                   # label
    twin.settle()
    assert on() == ["n002", "n003"]

    def widen(s, m):
        s.spec = s.spec.copy()
        s.spec.task.placement.constraints = []
        s.spec_version = m.Version(index=s.spec_version.index + 1)
    twin.apply(edit("Service", "svc-agent", widen))             # service
    twin.settle()
    assert on() == ["n002", "n003"]
    twin.apply(create(lambda m: node(m, 4, {"tier": "db"})))
    twin.settle()
    assert on() == ["n002", "n003", "n004"]


# --------------------------------------------------------- rolling updates

@pytest.mark.parametrize("order", ["STOP_FIRST", "START_FIRST"])
def test_rolling_update(clock, order):
    twin = run_twin(clock)

    def svc(m):
        return replicated(m, "web", 5, update=m.UpdateConfig(
            parallelism=2, delay=1.0, monitor=2.0,
            order=getattr(m.UpdateOrder, order)))
    twin.apply(create(svc))
    twin.settle()
    twin.apply(roll_out("svc-web", "img:2"))
    m = twin.port.p.m

    def done(w):
        st = w.service("svc-web").update_status
        return st is not None and st.state == m.UpdateState.COMPLETED
    twin.until(done)
    alive = live(twin.port, "svc-web")
    assert len(alive) == 5
    assert {t.spec.container.image for t in alive} == {"img:2"}


@pytest.mark.parametrize("action", ["PAUSE", "ROLLBACK"])
def test_rolling_update_failure(clock, action):
    twin = run_twin(clock)

    def svc(m):
        return replicated(
            m, "web", 4,
            restart=m.RestartPolicy(condition=m.RestartCondition.NONE),
            update=m.UpdateConfig(
                parallelism=1, monitor=5.0,
                failure_action=getattr(m.UpdateFailureAction, action)),
            rollback=m.UpdateConfig(parallelism=2, monitor=1.0))
    twin.apply(create(svc))
    twin.settle()
    twin.apply(roll_out("svc-web", "img:2"))
    m = twin.port.p.m
    want = {"PAUSE": m.UpdateState.PAUSED,
            "ROLLBACK": m.UpdateState.ROLLBACK_COMPLETED}[action]

    def done(w):
        st = w.service("svc-web").update_status
        return st is not None and st.state == want
    for _ in range(40):
        twin.settle(after_step=fail_image("img:2"))
        if done(twin.port):
            break
        twin.tick_clock(1.0)
    else:
        raise AssertionError("the update never reached " + want.name)
    images = [t.spec.container.image for t in live(twin.port, "svc-web")]
    if action == "ROLLBACK":
        assert images == ["img:1"] * 4
    else:
        assert set(images) == {"img:1"} and 0 < len(images) < 4, \
            "the paused update left the slots it had not reached"


# -------------------------------------------------------------- allocator

def test_allocator_ports_and_addresses(clock):
    twin = run_twin(clock)

    def network(m):
        return m.Network(id="net-backend", spec=m.NetworkSpec(
            annotations=m.Annotations(name="backend")))

    def svc(m):
        ports = [m.PortConfig(name="http", target_port=80,
                              published_port=8080),
                 m.PortConfig(name="admin", target_port=9090)]
        return replicated(m, "web", 3, networks=["backend"],
                          endpoint=m.EndpointSpec(ports=ports))
    twin.apply(create(network))
    twin.settle()
    twin.apply(create(svc))
    twin.settle()
    w = twin.port
    net = w.store.view(lambda tx: tx.get(w.p.m.Network, "net-backend"))
    assert net.ipam is not None and net.ipam.configs[0].subnet
    ep = w.service("svc-web").endpoint
    assert sorted(p.published_port for p in ep.ports) == [8080, 30000]
    assert [v.network_id for v in ep.virtual_ips] == ["net-backend"]
    addrs = [a for t in live(w, "svc-web") for att in t.networks
             for a in att.addresses]
    assert len(addrs) == 3 and len(set(addrs)) == 3
    assert all(t.endpoint is not None for t in live(w, "svc-web"))

    # a second service asking for the same published port is refused and
    # its tasks wait, unallocated, while the first holds it
    def clash(m):
        return replicated(m, "clash", 1, endpoint=m.EndpointSpec(
            ports=[m.PortConfig(target_port=81, published_port=8080)]))
    twin.apply(create(clash))
    twin.settle()
    m = w.p.m
    assert [t.status.state for t in w.tasks("svc-clash")] == \
        [m.TaskState.NEW]
    twin.apply(delete("Service", "svc-web"))
    twin.settle()
    assert [t.status.state for t in w.tasks("svc-clash")] == \
        [m.TaskState.NEW], "a refused service waits for its next update"

    def relabel(s, m):
        s.spec = s.spec.copy()
        s.spec.annotations.labels = {"retry": "1"}
    twin.apply(edit("Service", "svc-clash", relabel))
    twin.settle()
    assert [t.status.state for t in w.tasks("svc-clash")] == \
        [m.TaskState.RUNNING]


def test_port_allocator_matches_reference():
    ref = PKGS[REF].allocator.PortAllocator()
    port = PKGS[PORT].allocator.PortAllocator()
    for pa, pkg in ((ref, PKGS[REF]), (port, PKGS[PORT])):
        m = pkg.m
        pa.allocate([m.PortConfig(target_port=80, published_port=30000)])
    got = []
    for pa, pkg in ((ref, PKGS[REF]), (port, PKGS[PORT])):
        m = pkg.m
        out = pa.allocate([m.PortConfig(target_port=p) for p in range(3)])
        with pytest.raises(ValueError):
            pa.allocate([m.PortConfig(target_port=9, published_port=30001)])
        got.append([(p.target_port, p.published_port) for p in out])
    assert got[0] == got[1] == [(0, 30001), (1, 30002), (2, 30003)]


# --------------------------------------------------------------- taskinit

def test_taskinit_check_tasks_on_an_inconsistent_store(clock):
    """A store left by a previous leader: a task of a deleted service, a
    task on a drained node, a task desired READY whose restart delay
    already passed; the startup pass and the loops repair each, alike in
    both packages.  The restart the startup pass queues for the task on
    the drained node is dropped by the resync that follows it in the
    simulator's cold start (``sim/cluster.py:1344-1345``), so that task
    is restarted at its node's next event."""
    twin = Twin(clock)

    def drained(m):
        n = node(m, 1)
        n.spec.availability = m.NodeAvailability.DRAIN
        return n

    def stale(m):
        svc = replicated(m, "web", 3, restart=m.RestartPolicy(delay=5.0))
        ts = T0 - 60.0
        mk = lambda tid, slot, nid, desired, state: m.Task(
            id=tid, service_id=svc.id, slot=slot, node_id=nid,
            desired_state=desired, spec=svc.spec.task,
            spec_version=m.Version(index=1),
            status=m.TaskStatus(state=state, timestamp=ts))
        return [svc,
                mk("t-orphan", 1, "n000", m.TaskState.RUNNING,
                   m.TaskState.RUNNING),
                mk("t-drained", 2, "n001", m.TaskState.RUNNING,
                   m.TaskState.RUNNING),
                mk("t-ready", 3, "", m.TaskState.READY,
                   m.TaskState.PENDING)]

    def setup(w):
        m = w.p.m
        svc, orphan, *rest = stale(m)
        orphan.service_id = "svc-gone"

        def cb(tx):
            tx.create(cluster(m))
            tx.create(node(m, 0))
            tx.create(drained(m))
            tx.create(svc)
            tx.create(orphan)
            for t in rest:
                tx.create(t)
        w.store.update(cb)
    twin.apply(setup)
    twin.start()
    m = twin.port.p.m
    ids = {t.id for t in twin.port.tasks()}
    assert "t-orphan" not in ids, "a task of a deleted service is removed"
    twin.settle()
    twin.tick_clock(6.0)
    twin.settle()
    got = {t.id: t for t in twin.port.tasks()}
    assert got["t-ready"].desired_state == m.TaskState.RUNNING
    assert got["t-ready"].status.state == m.TaskState.RUNNING
    assert got["t-drained"].desired_state == m.TaskState.RUNNING

    def relabel(n, m):
        n.spec.annotations.labels = {"rack": "r9"}
    twin.apply(edit("Node", "n001", relabel))
    twin.settle()
    alive = live(twin.port, "svc-web")
    assert len(alive) == 3 and all(t.node_id == "n000" for t in alive)
    got = {t.id: t for t in twin.port.tasks()}
    assert got["t-drained"].desired_state > m.TaskState.RUNNING


# ------------------------------------------------- the slice as a whole

SLICE = dict(n_nodes=64, web=2000, api=128, parallelism=32, drained=8)


def slice_script(clock, w):
    """``chip_smoke.py``'s phase 22 at 64 nodes in one world: create the
    orchestrated cluster's services, drain 8 nodes, roll ``api`` out;
    returns (id, node, state, desired, image) of every task after each
    stage."""
    p = w.p

    def rows():
        return [(t.id, t.node_id, int(t.status.state), int(t.desired_state),
                 t.spec.container.image) for t in w.tasks()]

    def settle():
        for _ in range(200):
            _, wrote = w.step()
            if not wrote and not w.agent():
                return
        raise AssertionError("the loops did not settle")

    out = []
    settle()
    out.append(rows())
    nodes = sorted(w.store.view(lambda tx: tx.find(p.m.Node)),
                   key=lambda n: n.description.hostname)

    api = w.store.view(lambda tx: tx.find(p.m.Service, p.state.ByName(
        "api")))[0].id
    if p.name == PORT:
        workload.drain_nodes(w.store, nodes[:SLICE["drained"]])
    else:
        def drain(tx):
            for n in nodes[:SLICE["drained"]]:
                cur = tx.get(p.m.Node, n.id).copy()
                cur.spec.availability = p.m.NodeAvailability.DRAIN
                tx.update(cur)
        w.store.update(drain)
    settle()
    out.append(rows())
    if p.name == PORT:
        workload.roll_out(w.store, api, "api:2")
    else:
        roll_out(api, "api:2")(w)
    for _ in range(4):
        settle()
        if w.service(api).update_status.state == p.m.UpdateState.COMPLETED:
            break
        clock[0] += 31.0
    out.append(rows())
    return out


def test_slice_matches_reference_planner(clock):
    """Phase 22's script at 64 nodes x 2,000 web replicas (with ``agent``
    and ``api``) through ``TorchPlanner(device="cpu")`` and through the
    reference's ``TPUPlanner`` (router off): the same task on the same
    node in the same state after create, drain and rollout."""
    from swarmkit_tpu.ops import TPUPlanner
    from swarmkit_tpu_torch.ops import TorchPlanner

    ref_planner = TPUPlanner()
    ref_planner.enable_small_group_routing = False
    port_planner = TorchPlanner(device="cpu")
    results, stats = [], []
    for pkg, planner in ((REF, ref_planner), (PORT, port_planner)):
        clock[0] = T0
        if pkg == PORT:
            store = workload.orchestrated_cluster(
                SLICE["n_nodes"], SLICE["web"], SLICE["api"],
                SLICE["parallelism"])[0]
        else:
            store = ref_orchestrated_cluster()
        w = World(PKGS[pkg], planner, store=store)
        w.loops.cold_start()
        results.append(slice_script(clock, w))
        stats.append({k: v for k, v in planner.stats.items()
                      if k in ("tasks_planned", "groups_planned",
                               "groups_fused", "groups_fallback")})
    for stage, (a, b) in zip(("create", "drain", "rollout"), zip(*results)):
        assert a == b, f"{stage}: placements differ"
    assert stats[0] == stats[1]
    assert stats[1]["tasks_planned"] > SLICE["web"] + SLICE["api"]
    assert stats[1]["groups_fallback"] == 0
    placed = [r for r in results[1][0] if r[1]]
    assert len(placed) == SLICE["web"] + SLICE["api"] + SLICE["n_nodes"]


def ref_orchestrated_cluster():
    """``workload.orchestrated_cluster`` at ``SLICE`` over the reference's
    classes (the same objects, made in the same order)."""
    from swarmkit_tpu import models as m
    from swarmkit_tpu.state import MemoryStore
    from swarmkit_tpu.utils import new_id

    store = MemoryStore()
    nodes = [m.Node(
        id=new_id(),
        spec=m.NodeSpec(annotations=m.Annotations(
            name=f"node-{i:05d}", labels={"rack": f"r{i % 20}"})),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(
            hostname=f"node-{i:05d}",
            platform=m.Platform(os="linux", architecture="amd64"),
            resources=m.Resources(nano_cpus=64 * 10**9,
                                  memory_bytes=256 << 30)))
        for i in range(SLICE["n_nodes"])]

    def spec(image, prefs=None):
        return m.TaskSpec(
            container=m.ContainerSpec(image=image),
            placement=m.Placement(preferences=prefs or []),
            restart=m.RestartPolicy(condition=m.RestartCondition.ANY,
                                    delay=0.0),
            resources=m.ResourceRequirements(reservations=m.Resources(
                nano_cpus=10**8, memory_bytes=64 << 20)))

    def service(name, mode, task, replicas=None, update=None):
        return m.Service(
            id=new_id(),
            spec=m.ServiceSpec(
                annotations=m.Annotations(name=name), task=task, mode=mode,
                replicated=m.ReplicatedService(replicas=replicas)
                if replicas is not None else None,
                update=update),
            spec_version=m.Version(index=1))

    rack = [m.PlacementPreference(spread=m.SpreadOver(
        spread_descriptor="node.labels.rack"))]
    services = [
        service("web", m.ServiceMode.REPLICATED, spec("web:1", rack),
                SLICE["web"]),
        service("agent", m.ServiceMode.GLOBAL, spec("agent:1")),
        service("api", m.ServiceMode.REPLICATED, spec("api:1"), SLICE["api"],
                m.UpdateConfig(parallelism=SLICE["parallelism"], delay=0.0,
                               monitor=0.0,
                               failure_action=m.UpdateFailureAction.PAUSE)),
    ]

    def cb(tx):
        tx.create(m.Cluster(id=new_id(), spec=m.ClusterSpec(
            annotations=m.Annotations(name="default"))))
        for n in nodes:
            tx.create(n)
        for svc in services:
            tx.create(svc)

    store.update(cb)
    return store


# ------------------------------------------------- threaded smoke test

def poll(fn, timeout=5.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.01)
    raise AssertionError(f"poll timed out: {msg}")


def test_threaded_replicated_orchestrator_and_allocator_start_stop():
    """The port's replicated orchestrator and allocator on their own
    threads: a created service's tasks are made and allocated (NEW ->
    PENDING), and both stop."""
    from swarmkit_tpu_torch.manager import Allocator
    from swarmkit_tpu_torch.models import Task, TaskState
    from swarmkit_tpu_torch.orchestrator import ReplicatedOrchestrator
    from swarmkit_tpu_torch import models as m
    from swarmkit_tpu_torch.state import MemoryStore

    store = MemoryStore()
    store.update(lambda tx: tx.create(cluster(m)))
    orch = ReplicatedOrchestrator(store)
    alloc = Allocator(store)
    orch.start()
    alloc.start()
    try:
        store.update(lambda tx: tx.create(replicated(m, "web", 3)))
        poll(lambda: sum(t.status.state == TaskState.PENDING
                         for t in store.view(lambda tx: tx.find(Task)))
             == 3, msg="three tasks allocated")
    finally:
        orch.stop()
        alloc.stop()
    assert orch._done.is_set() and alloc._done.is_set()
