"""The port's dispatcher and agent, on the CPU.

- The port's copies of the reference's ``tests/test_dispatcher_agent.py``
  (sessions, heartbeats and expiry, orphaning, the assignment streams,
  status write-back, driver-backed secrets, and the end-to-end slice
  store -> orchestrator -> scheduler -> dispatcher -> agent -> RUNNING);
  the two end-to-end cases run once on the host path, as the reference
  runs them, and once with ``TorchPlanner(device="cpu")``.
- The port's copies of the dispatcher cases of ``tests/test_overload.py``:
  the session cap, whole-batch shedding, the heartbeat stretch, terminal
  compaction in the batched fan-out, and 1,000 sessions re-opened after a
  leader gap.
- A differential: one scripted sequence through both packages' threadless
  ``Dispatcher`` (registration, heartbeats, the batched fan-out's streams,
  a tick, status batches up to a shed, expiry), each over its own store
  with one fixed clock, one id counter a package and one seeded random
  source: the same messages (type and changes by task), the same
  ``stats`` and the same store rows (``serde.to_dict``), exactly.

Where a case waits on the dispatcher's or the agent's threads, it polls
with a bound, as the reference's do.
"""

import importlib
import itertools
import random
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.agent import Agent  # noqa: E402
from swarmkit_tpu_torch.agent.testutils import TestExecutor  # noqa: E402
from swarmkit_tpu_torch.manager import Allocator, Dispatcher  # noqa: E402
from swarmkit_tpu_torch.manager.dispatcher import (  # noqa: E402
    Config_, ErrNodeNotFound, ErrOverloaded, ErrSessionInvalid,
)
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, Cluster, EngineDescription, Node, NodeAvailability,
    NodeDescription, NodeSpec, NodeState, NodeStatus, Placement, Platform,
    ReplicatedService, ResourceRequirements, Resources, RestartPolicy,
    Service, ServiceMode, ServiceSpec, Task, TaskSpec, TaskState,
    TaskStatus, Version,
)
from swarmkit_tpu_torch.models.specs import ClusterSpec  # noqa: E402
from swarmkit_tpu_torch.models.types import now  # noqa: E402
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402
from swarmkit_tpu_torch.orchestrator import (  # noqa: E402
    ReplicatedOrchestrator,
)
from swarmkit_tpu_torch.scheduler import Scheduler  # noqa: E402
from swarmkit_tpu_torch.state import ByService, MemoryStore  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0

#: the scheduler's planner in the end-to-end cases: the host path (the
#: reference's cases) and the port's planner on the CPU
PLANNERS = pytest.mark.parametrize(
    "planner", [lambda: None, lambda: TorchPlanner(device="cpu")],
    ids=["host", "torch_cpu"])


@pytest.fixture(autouse=True)
def singletons_left_as_found():
    """A ``Manager``'s ``run()`` enables the port's flight recorder and
    journey ledger and installs its crash hook; the dispatcher and the
    scheduler export gauges and timers and open planes.  Later tests in
    the same process read all of these (the health plane, the obs
    differentials), so each test here leaves both packages' registries,
    planes, flight recorders, journey ledgers and the threads' exception
    hook as it found them.  The counters too: the health plane judges
    their totals (heartbeat expirations over heartbeats, for one), and a
    script that expires sessions on purpose would fail a later run's
    health check."""
    import threading
    mods = [{k: importlib.import_module(f"{name}.{k}") for k in (
        "utils.metrics", "obs.flightrec", "obs.journey", "obs.planes")}
        for name in (REF, PORT)]
    saved = []
    for m in mods:
        r = m["utils.metrics"].registry
        saved.append((
            dict(r.counters), dict(r.gauges),
            {k: (list(t._buf), t._i, t.count, t.total)
             for k, t in r.timers.items()},
            m["obs.flightrec"].flightrec.save_state(),
            m["obs.journey"].journeys.save_state(),
            m["obs.planes"].save_state()))
    hook = threading.excepthook
    yield
    threading.excepthook = hook
    for m, (counters, gauges, timers, fr, js, pl) in zip(mods, saved):
        r = m["utils.metrics"].registry
        r.counters.clear()
        r.counters.update(counters)
        r.gauges.clear()
        r.gauges.update(gauges)
        for name, t in r.timers.items():
            t.reset()
            if name in timers:
                t._buf, t._i, t.count, t.total = timers[name]
        m["obs.flightrec"].flightrec.restore_state(fr)
        m["obs.journey"].journeys.restore_state(js)
        m["obs.planes"].restore_state(pl)


# ------------------------------------------- the reference's test helpers

def poll(cond, timeout=8.0, interval=0.05, msg="condition not met"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(msg)


def make_node(name, availability=NodeAvailability.ACTIVE,
              state=NodeState.READY, labels=None):
    return Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(name=name, labels=labels or {}),
                      availability=availability),
        status=NodeStatus(state=state),
        description=NodeDescription(hostname=name),
    )


def make_replicated(name, replicas, restart=None, update=None, image="img:1"):
    from swarmkit_tpu_torch.models.specs import ContainerSpec
    return Service(
        id=new_id(),
        spec=ServiceSpec(
            annotations=Annotations(name=name),
            task=TaskSpec(container=ContainerSpec(image=image),
                          restart=restart or RestartPolicy(delay=0.05)),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=replicas),
            update=update,
        ),
        spec_version=Version(index=1),
    )


def make_ready_node(name, cpus=4, mem=32 << 30, labels=None,
                    engine_labels=None, os="linux", arch="amd64",
                    availability=NodeAvailability.ACTIVE):
    n = Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(name=name),
                      availability=availability),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=name,
            platform=Platform(architecture=arch, os=os),
            resources=Resources(nano_cpus=cpus * 10**9, memory_bytes=mem),
            engine=EngineDescription(labels=engine_labels or {}),
        ),
    )
    if labels:
        n.spec.annotations.labels.update(labels)
    return n


def make_service_with_tasks(n_tasks):
    svc = Service(
        id=new_id(),
        spec=ServiceSpec(
            annotations=Annotations(name="svc-" + new_id()[:6]),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=n_tasks),
        ),
        spec_version=Version(index=1),
    )
    tasks = []
    for slot in range(1, n_tasks + 1):
        tasks.append(Task(
            id=new_id(), service_id=svc.id, slot=slot,
            desired_state=TaskState.RUNNING,
            spec=TaskSpec(
                placement=Placement(),
                resources=ResourceRequirements(),
            ),
            spec_version=Version(index=1),
            status=TaskStatus(state=TaskState.PENDING),
        ))
    return svc, tasks


@pytest.fixture
def store():
    s = MemoryStore()
    cluster = Cluster(id=new_id(), spec=ClusterSpec(
        annotations=Annotations(name="default")))
    s.update(lambda tx: tx.create(cluster))
    yield s
    s.close()


def fast_config(**kw):
    defaults = dict(heartbeat_period=0.3, heartbeat_epsilon=0.02,
                    grace_multiplier=3, process_updates_interval=0.02,
                    assignment_batching_wait=0.02, orphan_timeout=2.0)
    defaults.update(kw)
    return Config_(**defaults)


# ------------------------------------ tests/test_dispatcher_agent.py's cases

def test_register_requires_known_node(store):
    d = Dispatcher(store, fast_config())
    d.run()
    try:
        with pytest.raises(ErrNodeNotFound):
            d.register("nope")
    finally:
        d.stop()


def test_register_rate_limit(store):
    """Re-registration is rate limited per node (reference: nodes.go:90
    CheckRateLimit — RATE_LIMIT_COUNT re-registrations per period, reset
    once the last registration ages past the period)."""
    from swarmkit_tpu_torch.manager.dispatcher import ErrRateLimited

    d = Dispatcher(store, fast_config(rate_limit_period=0.5))
    d.run()
    node = make_ready_node("n1")
    store.update(lambda tx: tx.create(node))
    try:
        d.register(node.id)
        for _ in range(3):        # three rapid re-registrations pass
            d.register(node.id)
        with pytest.raises(ErrRateLimited):
            d.register(node.id)   # the fourth within the period fails
        time.sleep(0.6)           # ...and ages out
        d.register(node.id)

        # disabled limit (period 0): unlimited re-registration
        d2 = Dispatcher(store, fast_config(rate_limit_period=0.0))
        d2.run()
        try:
            for _ in range(10):
                d2.register(node.id)
        finally:
            d2.stop()
    finally:
        d.stop()


def test_heartbeat_session_validation(store):
    d = Dispatcher(store, fast_config())
    d.run()
    node = make_ready_node("n1")
    store.update(lambda tx: tx.create(node))
    try:
        session, period = d.register(node.id)
        assert period > 0
        assert d.heartbeat(node.id, session) > 0
        with pytest.raises(ErrSessionInvalid):
            d.heartbeat(node.id, "bogus")
    finally:
        d.stop()


def test_heartbeat_expiry_marks_node_down(store):
    d = Dispatcher(store, fast_config())
    d.run()
    node = make_ready_node("n1")
    store.update(lambda tx: tx.create(node))
    try:
        d.register(node.id)
        poll(lambda: store.view(
            lambda tx: tx.get(Node, node.id)).status.state
            == NodeState.READY)
        # no heartbeats: after period * grace the node must go DOWN
        poll(lambda: store.view(
            lambda tx: tx.get(Node, node.id)).status.state
            == NodeState.DOWN,
            timeout=5, msg="node should go DOWN after heartbeat expiry")
    finally:
        d.stop()


def test_orphan_timeout_moves_tasks_to_orphaned(store):
    d = Dispatcher(store, fast_config(orphan_timeout=0.5))
    d.run()
    node = make_ready_node("n1")
    t = Task(id=new_id(), service_id=new_id(), slot=1, node_id=node.id,
             desired_state=TaskState.RUNNING,
             status=TaskStatus(state=TaskState.RUNNING))

    def setup(tx):
        tx.create(node)
        tx.create(t)
    store.update(setup)
    try:
        d.register(node.id)
        poll(lambda: store.view(
            lambda tx: tx.get(Node, node.id)).status.state
            == NodeState.DOWN, timeout=5)
        poll(lambda: store.view(
            lambda tx: tx.get(Task, t.id)).status.state
            == TaskState.ORPHANED,
            timeout=5, msg="tasks on long-dead node become ORPHANED")
    finally:
        d.stop()


def test_assignments_stream_complete_and_incremental(store):
    d = Dispatcher(store, fast_config())
    d.run()
    node = make_ready_node("n1")
    t1 = Task(id=new_id(), service_id="svc", slot=1, node_id=node.id,
              desired_state=TaskState.RUNNING,
              status=TaskStatus(state=TaskState.ASSIGNED))

    def setup(tx):
        tx.create(node)
        tx.create(t1)
    store.update(setup)
    try:
        session, _ = d.register(node.id)
        stream = d.open_assignments(node.id, session)
        msg = stream.get(timeout=2)
        assert msg.type == "complete"
        assert [obj.id for _, kind, obj in msg.changes
                if kind == "task"] == [t1.id]

        # a new assignment arrives incrementally
        t2 = Task(id=new_id(), service_id="svc", slot=2, node_id=node.id,
                  desired_state=TaskState.RUNNING,
                  status=TaskStatus(state=TaskState.ASSIGNED))
        store.update(lambda tx: tx.create(t2))
        # create events don't reach agents (tasks are never created
        # ASSIGNED by the real pipeline); an update does
        t2b = store.view(lambda tx: tx.get(Task, t2.id)).copy()
        t2b.status = TaskStatus(state=TaskState.ASSIGNED, timestamp=now())
        t2b.desired_state = TaskState.RUNNING
        store.update(lambda tx: tx.update(t2b))

        msg = stream.get(timeout=2)
        assert msg.type == "incremental"
        assert {obj.id for _, kind, obj in msg.changes} >= {t2.id}
        assert msg.applies_to == "1"
    finally:
        d.stop()


def test_assignments_stream_from_block_commit_with_raft(store, tmp_path):
    """Columnar block commits with a LIVE raft proposer still produce
    correct per-session assignment diffs: each session receives exactly
    its node's slice of the block (as materialized ASSIGNED tasks), and
    the block rides consensus as a compact TaskBlockAction (VERDICT r3
    item 1 'done' criterion)."""
    import os as _os

    from swarmkit_tpu_torch.state.raft import LocalNetwork, RaftLogger, RaftNode

    rn = RaftNode("m0", ["m0"], store,
                  RaftLogger(_os.path.join(str(tmp_path), "m0")),
                  LocalNetwork())
    store._proposer = rn
    rn.start()
    poll(lambda: rn.is_leader and rn.core.leader_ready, timeout=10)

    d = Dispatcher(store, fast_config())
    d.run()
    n1, n2 = make_ready_node("n1"), make_ready_node("n2")
    tasks = [Task(id=new_id(), service_id="svc", slot=i,
                  desired_state=TaskState.RUNNING,
                  status=TaskStatus(state=TaskState.PENDING))
             for i in range(6)]

    def setup(tx):
        tx.create(n1)
        tx.create(n2)
        for t in tasks:
            tx.create(t)
    store.update(setup)

    try:
        s1, _ = d.register(n1.id)
        s2, _ = d.register(n2.id)
        st1 = d.open_assignments(n1.id, s1)
        st2 = d.open_assignments(n2.id, s2)
        assert st1.get(timeout=2).type == "complete"
        assert st2.get(timeout=2).type == "complete"

        # columnar commit: evens to n1, odds to n2, one block
        stored = [store.raw_get(Task, t.id) for t in tasks]
        nids = [n1.id if i % 2 == 0 else n2.id for i in range(6)]
        committed, failed = store.commit_task_block(
            stored, nids, int(TaskState.ASSIGNED), "assigned",
            lambda t, n: None, lambda t, n: False)
        assert committed == list(range(6)) and failed == []

        msg1 = st1.get(timeout=2)
        assert msg1.type == "incremental"
        got1 = {obj.id for _, kind, obj in msg1.changes if kind == "task"}
        assert got1 == {tasks[i].id for i in (0, 2, 4)}
        for _, kind, obj in msg1.changes:
            if kind == "task":
                assert obj.node_id == n1.id
                assert obj.status.state == TaskState.ASSIGNED

        msg2 = st2.get(timeout=2)
        got2 = {obj.id for _, kind, obj in msg2.changes if kind == "task"}
        assert got2 == {tasks[i].id for i in (1, 3, 5)}
    finally:
        d.stop()
        rn.stop()


def test_update_task_status_rejects_foreign_node(store):
    d = Dispatcher(store, fast_config())
    d.run()
    n1, n2 = make_ready_node("n1"), make_ready_node("n2")
    t = Task(id=new_id(), service_id="svc", slot=1, node_id=n2.id,
             desired_state=TaskState.RUNNING,
             status=TaskStatus(state=TaskState.ASSIGNED))

    def setup(tx):
        tx.create(n1)
        tx.create(n2)
        tx.create(t)
    store.update(setup)
    try:
        session, _ = d.register(n1.id)
        with pytest.raises(Exception):
            d.update_task_status(
                n1.id, session,
                [(t.id, TaskStatus(state=TaskState.RUNNING))])
    finally:
        d.stop()


@PLANNERS
def test_e2e_service_to_running_via_dispatcher_and_agent(store, planner):
    """The minimum end-to-end slice (SURVEY §7.5): service create →
    orchestrator → scheduler → dispatcher → agent → fake executor →
    RUNNING status written back through the dispatcher."""
    d = Dispatcher(store, fast_config())
    d.run()
    alloc = Allocator(store)
    sched = Scheduler(store, batch_planner=planner())
    orch = ReplicatedOrchestrator(store)

    node = make_ready_node("n1", cpus=8)
    store.update(lambda tx: tx.create(node))

    agent = Agent(node.id, TestExecutor(hostname="n1"), d)
    alloc.start()
    sched.start()
    orch.start()
    agent.start()
    try:
        svc = make_replicated("web", 3)
        store.update(lambda tx: tx.create(svc))

        def all_running():
            got = [t for t in store.view(
                lambda tx: tx.find(Task, ByService(svc.id)))
                if t.desired_state == TaskState.RUNNING]
            return (len(got) == 3
                    and all(t.status.state == TaskState.RUNNING
                            for t in got)
                    and all(t.node_id == node.id for t in got))

        poll(all_running, timeout=20,
             msg="3 replicas should reach RUNNING through the full pipeline")

        # the worker runs exactly the assigned tasks
        poll(lambda: len(agent.worker.task_managers) == 3)

        # scale down: agent must stop the removed tasks
        cur = store.view(lambda tx: tx.get(Service, svc.id)).copy()
        from swarmkit_tpu_torch.models import ReplicatedService, Service as _S
        cur.spec.replicated = ReplicatedService(replicas=1)
        store.update(lambda tx: tx.update(cur))

        def scaled():
            got = store.view(lambda tx: tx.find(Task, ByService(svc.id)))
            live = [t for t in got
                    if t.desired_state == TaskState.RUNNING]
            shut = [t for t in got
                    if t.desired_state >= TaskState.SHUTDOWN]
            return (len(live) == 1
                    and all(t.status.state >= TaskState.SHUTDOWN
                            for t in shut))
        poll(scaled, timeout=20,
             msg="scaled-down tasks should be shut down by the agent")
    finally:
        agent.stop()
        orch.stop()
        sched.stop()
        alloc.stop()
        d.stop()



@PLANNERS
def test_e2e_agent_death_reschedules_tasks(store, planner):
    """Kill the agent (stop heartbeating) → node DOWN → orchestrator
    replaces tasks → scheduler assigns to the surviving node → its agent
    runs them."""
    d = Dispatcher(store, fast_config())
    d.run()
    alloc = Allocator(store)
    alloc.start()
    sched = Scheduler(store, batch_planner=planner())
    orch = ReplicatedOrchestrator(store)

    n1, n2 = make_ready_node("n1", cpus=8), make_ready_node("n2", cpus=8)
    store.update(lambda tx: (tx.create(n1), tx.create(n2)))

    agent1 = Agent(n1.id, TestExecutor(hostname="n1"), d)
    agent2 = Agent(n2.id, TestExecutor(hostname="n2"), d)
    sched.start()
    orch.start()
    agent1.start()
    agent2.start()
    try:
        svc = make_replicated("web", 2)
        store.update(lambda tx: tx.create(svc))

        def all_running():
            got = [t for t in store.view(
                lambda tx: tx.find(Task, ByService(svc.id)))
                if t.desired_state == TaskState.RUNNING]
            return (len(got) == 2
                    and all(t.status.state == TaskState.RUNNING
                            for t in got))
        poll(all_running, timeout=20)

        # kill agent1: heartbeats stop, node n1 goes DOWN, tasks restarted
        agent1.stop()

        def healed():
            got = [t for t in store.view(
                lambda tx: tx.find(Task, ByService(svc.id)))
                if t.desired_state == TaskState.RUNNING]
            return (len(got) == 2
                    and all(t.status.state == TaskState.RUNNING
                            for t in got)
                    and all(t.node_id == n2.id for t in got))
        poll(healed, timeout=20,
             msg="tasks should be rescheduled onto the surviving node")
    finally:
        agent2.stop()
        orch.stop()
        sched.stop()
        alloc.stop()
        d.stop()


def test_driver_backed_secrets_fetch_per_task_values(store):
    """Secrets with spec.driver fetch their value from a provider plugin
    at assignment time; DoNotReuse providers yield task-specific secret
    ids/values (reference: manager/drivers/secrets.go + assignments.go
    assignSecret)."""
    from swarmkit_tpu_torch.manager.drivers import DriverProvider
    from swarmkit_tpu_torch.models import Secret
    from swarmkit_tpu_torch.models.specs import ContainerSpec, SecretSpec, TaskSpec
    from swarmkit_tpu_torch.models.types import Driver, SecretReference

    calls = []

    def plugin(req):
        calls.append(req)
        import base64
        value = f"v-for-{req['TaskID']}".encode()
        return {"Value": base64.b64encode(value).decode(),
                "DoNotReuse": True}

    provider = DriverProvider({"vault": plugin})
    d = Dispatcher(store, fast_config(), driver_provider=provider)
    d.run()
    node = make_ready_node("n1")
    secret = Secret(id=new_id(), spec=SecretSpec(
        annotations=Annotations(name="db-pass"),
        driver=Driver(name="vault")))

    def mk_task(slot):
        return Task(id=new_id(), service_id="svc", slot=slot,
                    node_id=node.id, desired_state=TaskState.RUNNING,
                    status=TaskStatus(state=TaskState.ASSIGNED),
                    spec=TaskSpec(container=ContainerSpec(
                        image="img", secrets=[SecretReference(
                            secret_id=secret.id, secret_name="db-pass")])))

    t1, t2 = mk_task(1), mk_task(2)

    def setup(tx):
        tx.create(node)
        tx.create(secret)
        tx.create(t1)
        tx.create(t2)
    store.update(setup)
    try:
        session, _ = d.register(node.id)
        stream = d.open_assignments(node.id, session)
        msg = stream.get(timeout=2)
        assert msg.type == "complete"
        secrets = {obj.id: obj for _, kind, obj in msg.changes
                   if kind == "secret"}
        assert set(secrets) == {f"{secret.id}.{t1.id}",
                                f"{secret.id}.{t2.id}"}, \
            "DoNotReuse secrets must get task-specific ids"
        assert secrets[f"{secret.id}.{t1.id}"].spec.data == \
            f"v-for-{t1.id}".encode()
        assert secrets[f"{secret.id}.{t2.id}"].spec.data == \
            f"v-for-{t2.id}".encode()
        assert all(s.internal for s in secrets.values())
        assert len(calls) == 2
        assert calls[0]["SecretName"] == "db-pass"
        assert calls[0]["NodeID"] == node.id
    finally:
        d.stop()


def test_driver_secret_fetch_error_skips_assignment(store):
    """Provider failures leave the secret unassigned rather than shipping
    an empty value (reference: assignments.go fetch-error path)."""
    from swarmkit_tpu_torch.manager.drivers import DriverProvider
    from swarmkit_tpu_torch.models import Secret
    from swarmkit_tpu_torch.models.specs import ContainerSpec, SecretSpec, TaskSpec
    from swarmkit_tpu_torch.models.types import Driver, SecretReference

    def bad_plugin(req):
        return {"Err": "vault is sealed"}

    provider = DriverProvider({"vault": bad_plugin})
    d = Dispatcher(store, fast_config(), driver_provider=provider)
    d.run()
    node = make_ready_node("n1")
    secret = Secret(id=new_id(), spec=SecretSpec(
        annotations=Annotations(name="db-pass"),
        driver=Driver(name="vault")))
    t1 = Task(id=new_id(), service_id="svc", slot=1, node_id=node.id,
              desired_state=TaskState.RUNNING,
              status=TaskStatus(state=TaskState.ASSIGNED),
              spec=TaskSpec(container=ContainerSpec(
                  image="img", secrets=[SecretReference(
                      secret_id=secret.id, secret_name="db-pass")])))

    def setup(tx):
        tx.create(node)
        tx.create(secret)
        tx.create(t1)
    store.update(setup)
    try:
        session, _ = d.register(node.id)
        stream = d.open_assignments(node.id, session)
        msg = stream.get(timeout=2)
        assert msg.type == "complete"
        assert [obj.id for _, kind, obj in msg.changes
                if kind == "secret"] == [], \
            "failed driver fetch must not ship a secret"
        assert [obj.id for _, kind, obj in msg.changes
                if kind == "task"] == [t1.id], "the task still ships"
    finally:
        d.stop()


def test_driver_secret_retries_until_provider_recovers(store):
    """A transient provider outage heals: the assignments loop retries
    failed fetches on idle ticks and ships the secret once the provider
    answers."""
    from swarmkit_tpu_torch.manager.drivers import DriverProvider
    from swarmkit_tpu_torch.models import Secret
    from swarmkit_tpu_torch.models.specs import ContainerSpec, SecretSpec, TaskSpec
    from swarmkit_tpu_torch.models.types import Driver, SecretReference

    state = {"n": 0}

    def flaky_plugin(req):
        state["n"] += 1
        if state["n"] <= 2:
            return {"Err": "vault sealed"}
        import base64
        return {"Value": base64.b64encode(b"recovered").decode()}

    provider = DriverProvider({"vault": flaky_plugin})
    d = Dispatcher(store, fast_config(), driver_provider=provider)
    d.run()
    node = make_ready_node("n1")
    secret = Secret(id=new_id(), spec=SecretSpec(
        annotations=Annotations(name="db-pass"),
        driver=Driver(name="vault")))
    t1 = Task(id=new_id(), service_id="svc", slot=1, node_id=node.id,
              desired_state=TaskState.RUNNING,
              status=TaskStatus(state=TaskState.ASSIGNED),
              spec=TaskSpec(container=ContainerSpec(
                  image="img", secrets=[SecretReference(
                      secret_id=secret.id, secret_name="db-pass")])))

    def setup(tx):
        tx.create(node)
        tx.create(secret)
        tx.create(t1)
    store.update(setup)
    try:
        session, _ = d.register(node.id)
        stream = d.open_assignments(node.id, session)
        msg = stream.get(timeout=2)
        assert msg.type == "complete"
        assert not [o for _, k, o in msg.changes if k == "secret"]

        # the loop's idle-tick retry eventually ships it
        deadline = time.time() + 10
        got = None
        while time.time() < deadline:
            d.heartbeat(node.id, session)   # keep the session alive
            try:
                msg = stream.get(timeout=0.25)
            except TimeoutError:
                continue
            secrets = [o for _, k, o in msg.changes if k == "secret"]
            if secrets:
                got = secrets[0]
                break
        assert got is not None, "secret never shipped after recovery"
        assert got.spec.data == b"recovered"
        assert state["n"] >= 3
    finally:
        d.stop()


# ----------------------------------- tests/test_overload.py's dispatcher cases


def overload_config(**kw):
    defaults = dict(heartbeat_period=5.0, heartbeat_epsilon=0.0,
                    grace_multiplier=3.0, rate_limit_period=0.0)
    defaults.update(kw)
    return Config_(**defaults)


def _mk_nodes(store, n):
    nodes = [make_ready_node(f"n{i:04d}") for i in range(n)]
    def setup(tx):
        for nd in nodes:
            tx.create(nd)
    store.update(setup)
    return nodes


def _mk_assigned_tasks(store, node_id, n, state=TaskState.ASSIGNED):
    svc, tasks = make_service_with_tasks(n)
    def setup(tx):
        tx.create(svc)
        for t in tasks:
            t.node_id = node_id
            t.status = TaskStatus(state=state, timestamp=now())
            tx.create(t)
    store.update(setup)
    return tasks


# ------------------------------------------------- bounded admission

def test_register_shed_at_session_cap(store):
    """The session bound sheds NEW nodes (counted), while an already-
    registered node's re-registration stays admitted at the cap: the
    bound limits concurrent sessions, it never evicts a live one."""
    nodes = _mk_nodes(store, 5)
    d = Dispatcher(store, overload_config(max_sessions=4))
    d.run(start_worker=False)
    try:
        for nd in nodes[:4]:
            d.register(nd.id)
        with pytest.raises(ErrOverloaded):
            d.register(nodes[4].id)
        assert d.stats["sheds"] == 1
        # the cap bounds sessions, not re-registrations
        sid, _period = d.register(nodes[0].id)
        assert sid
        assert d.stats["sheds"] == 1
    finally:
        d.stop()


def test_update_batch_shed_whole_counted_and_recoverable(store):
    """A status batch that would overflow max_pending_updates is shed
    WHOLE with ErrOverloaded: the shed is counted, already-buffered
    updates survive untouched, the session stays valid, and the same
    batch lands after a flush drains the buffer — degraded, never
    silently lossy."""
    (node,) = _mk_nodes(store, 1)
    tasks = _mk_assigned_tasks(store, node.id, 12)
    d = Dispatcher(store, overload_config(
        max_pending_updates=8, max_batch_items=1000))
    d.run(start_worker=False)
    try:
        sid, _ = d.register(node.id)
        ups = lambda ts: [(t.id, TaskStatus(state=TaskState.RUNNING,
                                            message="started",
                                            timestamp=now()))
                          for t in ts]
        d.update_task_status(node.id, sid, ups(tasks[:6]))
        assert len(d._task_updates) == 6
        with pytest.raises(ErrOverloaded):
            d.update_task_status(node.id, sid, ups(tasks[6:12]))
        assert d.stats["sheds"] == 6
        assert len(d._task_updates) == 6      # admitted work untouched
        # rewrites of already-buffered tasks never grow the buffer and
        # always land, even at the bound
        d.update_task_status(node.id, sid, ups(tasks[:6]))
        # the session survived the shed: heartbeat + retry both work
        d.heartbeat(node.id, sid)
        d._flush_updates()
        d.update_task_status(node.id, sid, ups(tasks[6:12]))
        d._flush_updates()
        running = [t for t in store.view(lambda tx: tx.find(Task))
                   if t.status.state == TaskState.RUNNING]
        assert len(running) == 12             # recovery is total
        assert d.stats["sheds"] == 6          # and exactly counted
    finally:
        d.stop()


def test_heartbeat_stretch_engages_and_extends_promise(store):
    """Past hb_stretch_start sessions the advertised period stretches
    linearly (capped at hb_stretch_max) and every stretched advertisement
    is counted; the expiry deadline extends with the stretched promise
    so slowing down can never expire a compliant agent early."""
    nodes = _mk_nodes(store, 8)
    d = Dispatcher(store, overload_config(
        hb_stretch_start=4, hb_stretch_max=3.0))
    d.run(start_worker=False)
    try:
        sids = {}
        for nd in nodes[:4]:
            sids[nd.id] = d.register(nd.id)[0]
        assert d._stretch_factor() == 1.0
        p0 = d.heartbeat(nodes[0].id, sids[nodes[0].id])
        assert p0 == pytest.approx(5.0)
        for nd in nodes[4:]:
            sids[nd.id] = d.register(nd.id)[0]
        assert d._stretch_factor() == pytest.approx(2.0)
        before = d.stats["hb_stretches"]
        p1 = d.heartbeat(nodes[0].id, sids[nodes[0].id])
        assert p1 == pytest.approx(10.0)      # 5.0 x stretch 2.0
        assert d.stats["hb_stretches"] > before
        # the deadline honors the stretched promise: window = period,
        # not period/stretch
        rn = d._nodes[nodes[0].id]
        assert rn.deadline == pytest.approx(now() + p1 * 3.0, abs=0.2)
        assert rn.promised_until == pytest.approx(rn.deadline, abs=0.2)
        assert d.stats["premature_expirations"] == 0
    finally:
        d.stop()


# -------------------------------------- batched fan-out memory bounds

def test_fanout_terminal_compaction_bounds_memory(store):
    """Terminal tasks beyond max_terminal_tasks are compacted out of the
    per-node assignment set as explicit removes: set memory stays
    O(assigned + bound) under churn instead of O(task history), and
    every eviction lands in the shared compaction counter."""
    (node,) = _mk_nodes(store, 1)
    tasks = _mk_assigned_tasks(store, node.id, 40)
    d = Dispatcher(store, overload_config(max_terminal_tasks=8))
    d.run(start_worker=False)
    fan = d.enable_batched_fanout()
    try:
        sid, _ = d.register(node.id)
        stream = fan.open(node.id, sid)
        first = stream.get(timeout=0)
        assert first.type == first.COMPLETE
        assert len(first.changes) == 40
        # churn: 30 of the 40 finish (terminal > RUNNING)
        def finish(tx):
            for t in tasks[:30]:
                t2 = tx.get(Task, t.id).copy()
                t2.status = TaskStatus(state=TaskState.COMPLETE,
                                       timestamp=now())
                tx.update(t2)
        store.update(finish)
        fan.flush()
        aset = fan._sets[node.id]
        assert fan.stats["compactions"] >= 22     # 30 terminal - bound 8
        assert len(aset._terminal) <= 8
        # O(assigned + bound): 10 live + <= 8 retained terminal
        assert len(aset.tasks) <= 18
    finally:
        d.stop()


def test_fanout_open_after_leader_gap_at_1k_sessions():
    """A re-elected leader's fresh dispatcher rebuilds every assignment
    stream from the store view: after a full leader gap, 1000 re-opened
    sessions each receive a COMPLETE set carrying exactly their node's
    assignments — nothing lost, nothing duplicated, and the rebuilt
    fan-out state stays O(assigned) per node."""
    s = MemoryStore()
    try:
        s.update(lambda tx: tx.create(Cluster(
            id=new_id(),
            spec=ClusterSpec(annotations=Annotations(name="default")))))
        n_nodes = 1000
        nodes = _mk_nodes(s, n_nodes)
        svc, tasks = make_service_with_tasks(2 * n_nodes)
        def setup(tx):
            tx.create(svc)
            for i, t in enumerate(tasks):
                t.node_id = nodes[i % n_nodes].id
                t.status = TaskStatus(state=TaskState.ASSIGNED,
                                      timestamp=now())
                tx.create(t)
        s.update(setup)

        def fleet_register(d, fan):
            sids = {nd.id: d.register(nd.id)[0] for nd in nodes}
            streams = {nid: fan.open(nid, sid)
                       for nid, sid in sids.items()}
            return sids, streams

        d1 = Dispatcher(s, overload_config(max_sessions=n_nodes + 8))
        d1.run(start_worker=False)
        fan1 = d1.enable_batched_fanout()
        _, streams1 = fleet_register(d1, fan1)
        assert fan1.stats["complete_sends"] == n_nodes
        d1.stop()                      # the leader gap

        d2 = Dispatcher(s, overload_config(max_sessions=n_nodes + 8))
        d2.run(start_worker=False)
        fan2 = d2.enable_batched_fanout()
        try:
            _, streams2 = fleet_register(d2, fan2)
            for nid, stream in streams2.items():
                msg = stream.get(timeout=0)
                assert msg.type == msg.COMPLETE
                got = sorted(c[2].id for c in msg.changes)
                want = sorted(t.id for t in tasks if t.node_id == nid)
                assert got == want
                assert len(fan2._sets[nid].tasks) == 2  # O(assigned)
        finally:
            d2.stop()
    finally:
        s.close()


# --------------------------------------- scheduler tick deadline budget


# ------------------------------------------------------- the differential

class _Pkg:
    """One package's modules, by the reference's paths."""

    def __init__(self, name):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")
        self.name = name
        self.models = mod("models")
        self.types = mod("models.types")
        self.identity = mod("utils.identity")
        self.dispatcher = mod("manager.dispatcher")
        self.scheduler = mod("scheduler")
        self.state = mod("state")
        self.serde = mod("state.serde")


def _message_key(msg):
    """An assignment message as plain values: its type, and each change
    as (action, kind, id) plus a task's node and state."""
    changes = []
    for action, kind, obj in msg.changes:
        row = (action, kind, obj.id)
        if kind == "task":
            row += (obj.node_id, int(obj.status.state),
                    int(obj.desired_state))
        changes.append(row)
    return (msg.type, tuple(sorted(changes)))


def _dispatcher_script(pkg, clock):
    """Registration, heartbeats, the batched fan-out's streams, a tick,
    status batches up to a shed and the resend, two sessions' expiry.
    Returns (messages by node index, stats, store rows)."""
    m = pkg.models
    store = pkg.state.MemoryStore()
    store.update(lambda tx: tx.create(m.Cluster(
        id=pkg.identity.new_id(), spec=m.ClusterSpec(
            annotations=m.Annotations(name="default")))))
    nodes = [m.Node(
        id=pkg.identity.new_id(),
        spec=m.NodeSpec(annotations=m.Annotations(name=f"n{i}")),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(
            hostname=f"n{i}",
            resources=m.Resources(nano_cpus=4 * 10**9,
                                  memory_bytes=8 << 30)))
        for i in range(4)]
    svc = m.Service(
        id=pkg.identity.new_id(),
        spec=m.ServiceSpec(annotations=m.Annotations(name="web"),
                           mode=m.ServiceMode.REPLICATED,
                           replicated=m.ReplicatedService(replicas=24)),
        spec_version=m.Version(index=1))
    tasks = [m.Task(id=pkg.identity.new_id(), service_id=svc.id, slot=s,
                    desired_state=m.TaskState.RUNNING,
                    spec=m.TaskSpec(), spec_version=m.Version(index=1),
                    status=m.TaskStatus(state=m.TaskState.PENDING))
             for s in range(1, 25)]

    def setup(tx):
        for obj in nodes + [svc] + tasks:
            tx.create(obj)
    store.update(setup)

    d = pkg.dispatcher.Dispatcher(store, pkg.dispatcher.Config_(
        heartbeat_period=5.0, heartbeat_epsilon=0.0, grace_multiplier=3.0,
        rate_limit_period=0.0, max_pending_updates=8, max_batch_items=1000,
        hb_stretch_start=2, hb_stretch_max=3.0, max_terminal_tasks=4),
        rng=random.Random(7))
    d.run(start_worker=False)
    fan = d.enable_batched_fanout()
    msgs = {i: [] for i in range(len(nodes))}

    def drain():
        for i, stream in streams.items():
            while True:
                try:
                    msgs[i].append(_message_key(stream.get(timeout=0)))
                except Exception:   # TimeoutError / Closed: drained
                    break

    try:
        sessions = [d.register(n.id)[0] for n in nodes]
        periods = [d.heartbeat(n.id, s) for n, s in zip(nodes, sessions)]
        streams = {i: fan.open(n.id, sessions[i])
                   for i, n in enumerate(nodes)}
        drain()
        sched = pkg.scheduler.Scheduler(store)
        store.view(sched._setup_tasks_list)
        assert sched.tick() == 24
        fan.flush()
        drain()
        clock[0] += 1.0
        sheds = []
        by_node = {}
        for t in store.view(lambda tx: tx.find(m.Task)):
            by_node.setdefault(t.node_id, []).append(t.id)
        for i, n in enumerate(nodes):
            ids = sorted(by_node.get(n.id, []))
            for lo in range(0, len(ids), 5):
                ups = [(tid, m.TaskStatus(state=m.TaskState.RUNNING,
                                          message="started",
                                          timestamp=clock[0]))
                       for tid in ids[lo:lo + 5]]
                try:
                    d.update_task_status(n.id, sessions[i], ups)
                except pkg.dispatcher.ErrOverloaded:
                    sheds.append((i, lo))
                    d._flush_updates()
                    d.update_task_status(n.id, sessions[i], ups)
        d._flush_updates()
        fan.flush()
        drain()
        # the first two nodes keep heartbeating; the others expire
        clock[0] += 10.0
        for i in (0, 1):
            periods.append(d.heartbeat(nodes[i].id, sessions[i]))
        clock[0] += 24.0
        d.process_deadlines(clock[0])
        drain()
        stats = dict(d.stats)
    finally:
        d.stop()
    rows = sorted(
        (type(o).__name__, repr(pkg.serde.to_dict(o)))
        for kind in (m.Node, m.Task, m.Service)
        for o in store.view(lambda tx, kind=kind: tx.find(kind)))
    store.close()
    return msgs, stats, rows, periods, sheds


def test_dispatcher_script_matches_reference():
    """One scripted sequence through both packages' threadless
    ``Dispatcher``: the same messages, stats, store rows, advertised
    periods and sheds, exactly."""
    outs = []
    for name in (REF, PORT):
        pkg = _Pkg(name)
        clock = [T0]
        pkg.types.set_time_source(lambda clock=clock: clock[0])
        n = itertools.count()
        pkg.identity.set_id_source(lambda n=n: f"id{next(n):08d}")
        try:
            outs.append(_dispatcher_script(pkg, clock))
        finally:
            pkg.types.set_time_source(None)
            pkg.identity.set_id_source(None)
    ref, port = outs
    msgs, stats, rows, periods, sheds = port
    assert sheds, "the script never reached the admission edge"
    assert stats["sheds"] > 0 and stats["expirations"] == 2, stats
    assert sum(len(v) for v in msgs.values()) > 4
    assert port == ref
