"""The port's node agent, on the CPU.

- ``tests/test_fsm_properties.py``'s two cases on the port's stack: the
  task FSM's safety properties (observed state never backwards, desired
  state never backwards, no terminal task resurrected, a node only once
  ASSIGNED) checked on every committed transition while a cluster churns
  through the dispatcher, the agents and the scheduler over
  ``TorchPlanner(device="cpu")``; and the resource API's network attach.
- ``TaskDB``, the agent's on-disk task store: what the reference's
  ``TaskDB`` writes the port's reads back, and the reverse, field for
  field (``serde.to_dict``), exactly; and the port's copies of
  ``tests/test_template_storage.py``'s two storage cases (a task resumed
  from the file with its last status, a worker restarted on the same
  file supervising it again).
- The ``ProcessExecutor`` cases of ``tests/test_procexec.py`` that need no
  ``node.py``: real processes run, fail, fail a health check, stop with
  their process group, ship their logs and read their secrets through a
  ``Manager`` on the host path and an ``Agent`` on its dispatcher (the
  reference's fixture joins the node through ``node.py``, which the port
  does not carry yet; the agent here is the one that fixture starts).

Where a case waits on threads or processes, it polls with a bound.
"""

import importlib
import os
import tempfile
import threading
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.agent import Agent, ProcessExecutor  # noqa: E402
from swarmkit_tpu_torch.agent.testutils import TestExecutor  # noqa: E402
from swarmkit_tpu_torch.manager import (  # noqa: E402
    Allocator, Dispatcher, Manager,
)
from swarmkit_tpu_torch.manager.dispatcher import Config_  # noqa: E402
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, Cluster, ContainerSpec, Node, NodeAvailability,
    ReplicatedService, RestartCondition, RestartPolicy, Service,
    ServiceMode, ServiceSpec, Task, TaskSpec, TaskState, TaskStatus,
)
from swarmkit_tpu_torch.models.specs import ClusterSpec  # noqa: E402
from swarmkit_tpu_torch.models.types import (  # noqa: E402
    TERMINAL_STATES, now,
)
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402
from swarmkit_tpu_torch.orchestrator import (  # noqa: E402
    ReplicatedOrchestrator, TaskReaper,
)
from swarmkit_tpu_torch.scheduler import Scheduler  # noqa: E402
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402
from swarmkit_tpu_torch.state import ByService, MemoryStore  # noqa: E402
from swarmkit_tpu_torch.state.events import Event  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    make_node, make_ready_node, make_replicated, poll,
    singletons_left_as_found,
)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


# ------------------------------------- tests/test_fsm_properties.py's cases



class FSMInvariantChecker:
    def __init__(self, store):
        self.store = store
        self.violations = []
        self._last = {}
        self._sub = store.queue.subscribe(
            lambda ev: isinstance(ev, Event) and isinstance(ev.obj, Task))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from swarmkit_tpu_torch.state.watch import Closed
        while not self._stop.is_set():
            try:
                ev = self._sub.get(timeout=0.1)
            except TimeoutError:
                continue
            except Closed:
                return
            t = ev.obj
            if ev.action == "delete":
                self._last.pop(t.id, None)
                continue
            prev = self._last.get(t.id)
            if prev is not None:
                prev_state, prev_desired = prev
                if t.status.state < prev_state:
                    self.violations.append(
                        f"P1: task {t.id[:8]} state went backwards "
                        f"{prev_state.name} -> {t.status.state.name}")
                if t.desired_state < prev_desired:
                    self.violations.append(
                        f"P2: task {t.id[:8]} desired went backwards "
                        f"{prev_desired.name} -> {t.desired_state.name}")
                if prev_state in TERMINAL_STATES and \
                        t.status.state != prev_state and \
                        t.status.state not in TERMINAL_STATES:
                    self.violations.append(
                        f"P3: terminal task {t.id[:8]} resurrected to "
                        f"{t.status.state.name}")
            if t.status.state >= TaskState.ASSIGNED and not t.node_id \
                    and t.status.state <= TaskState.RUNNING:
                self.violations.append(
                    f"P4: task {t.id[:8]} in {t.status.state.name} "
                    "without a node")
            self._last[t.id] = (t.status.state, t.desired_state)

    def stop(self):
        self._stop.set()
        self.store.queue.unsubscribe(self._sub)
        self._thread.join(timeout=2)


def test_fsm_invariants_under_cluster_churn():
    store = MemoryStore()
    store.update(lambda tx: tx.create(Cluster(
        id=new_id(),
        spec=ClusterSpec(annotations=Annotations(name="default")))))
    checker = FSMInvariantChecker(store)

    d = Dispatcher(store, Config_(heartbeat_period=0.3,
                                  heartbeat_epsilon=0.02,
                                  process_updates_interval=0.02,
                                  assignment_batching_wait=0.02))
    d.run()
    alloc = Allocator(store)
    sched = Scheduler(store, batch_planner=TorchPlanner(device="cpu"))
    orch = ReplicatedOrchestrator(store)
    reaper = TaskReaper(store)
    nodes = [make_node(f"n{i}") for i in range(3)]
    for n in nodes:
        n.description.resources.nano_cpus = 8 * 10**9
        n.description.resources.memory_bytes = 32 << 30
        store.update(lambda tx, n=n: tx.create(n))
    agents = [Agent(n.id, TestExecutor(), d) for n in nodes]
    alloc.start()
    sched.start()
    orch.start()
    reaper.start()
    for a in agents:
        a.start()
    try:
        svc = make_replicated("churn", 6)
        store.update(lambda tx: tx.create(svc))

        def n_running(k):
            got = [t for t in store.view(
                lambda tx: tx.find(Task, ByService(svc.id)))
                if t.desired_state == TaskState.RUNNING
                and t.status.state == TaskState.RUNNING]
            return len(got) == k
        poll(lambda: n_running(6), timeout=30)

        # fail a task
        victim = store.view(
            lambda tx: tx.find(Task, ByService(svc.id)))[0]

        def fail(tx):
            t = tx.get(Task, victim.id)
            if t is not None and t.status.state <= TaskState.RUNNING:
                t = t.copy()
                t.status = TaskStatus(state=TaskState.FAILED,
                                      timestamp=now(), err="churn")
                tx.update(t)
        store.update(fail)
        poll(lambda: n_running(6), timeout=30)

        # drain a node
        def drain(tx):
            n = tx.get(Node, nodes[0].id).copy()
            n.spec.availability = NodeAvailability.DRAIN
            tx.update(n)
        store.update(drain)
        poll(lambda: n_running(6), timeout=30)

        # scale down, then delete
        cur = store.view(lambda tx: tx.get(Service, svc.id)).copy()
        cur.spec.replicated = ReplicatedService(replicas=2)
        store.update(lambda tx: tx.update(cur))
        poll(lambda: n_running(2), timeout=30)
        store.update(lambda tx: tx.delete(Service, svc.id))
        time.sleep(1.0)

        assert not checker.violations, "\n".join(checker.violations[:10])
    finally:
        for a in agents:
            a.stop()
        orch.stop()
        reaper.stop()
        sched.stop()
        alloc.stop()
        d.stop()
        checker.stop()


def test_resourceapi_attach_detach():
    from swarmkit_tpu_torch.manager import ResourceAPI
    from swarmkit_tpu_torch.manager.controlapi import InvalidArgument, NotFound
    from swarmkit_tpu_torch.models import Network
    from swarmkit_tpu_torch.models.specs import NetworkSpec
    import pytest

    store = MemoryStore()
    node = make_node("n1")
    net = Network(id=new_id(), spec=NetworkSpec(
        annotations=Annotations(name="overlay1"), attachable=True))
    sealed = Network(id=new_id(), spec=NetworkSpec(
        annotations=Annotations(name="internal1")))
    store.update(lambda tx: (tx.create(node), tx.create(net),
                             tx.create(sealed)))
    api = ResourceAPI(store)

    with pytest.raises(NotFound):
        api.attach_network("nope", net.id)
    with pytest.raises(InvalidArgument, match="not attachable"):
        api.attach_network(node.id, sealed.id)

    attachment_id = api.attach_network(node.id, net.id,
                                       container_id="c1")
    t = store.view(lambda tx: tx.get(Task, attachment_id))
    assert t.spec.attachment.container_id == "c1"
    assert t.node_id == node.id
    assert t.networks[0].network_id == net.id

    with pytest.raises(InvalidArgument):
        api.detach_network("other-node", attachment_id)
    api.detach_network(node.id, attachment_id)
    assert store.view(lambda tx: tx.get(Task, attachment_id)) is None


# ------------------------------------------------------------------ TaskDB

def _taskdb_rows(pkg, path, write):
    """With ``write``, store three tasks (two assigned, one not) and two
    statuses in a ``TaskDB`` at ``path``; then read it back with a fresh
    one.  Returns the rows as plain values."""
    m = importlib.import_module(f"{pkg}.models")
    serde = importlib.import_module(f"{pkg}.state.serde")
    storage = importlib.import_module(f"{pkg}.agent.storage")
    if write:
        db = storage.TaskDB(path)
        tasks = [m.Task(id=f"t{i}", service_id="svc", slot=i + 1,
                        node_id="n1", desired_state=m.TaskState.RUNNING,
                        spec=m.TaskSpec(container=m.ContainerSpec(
                            image="img", command=["sh", "-c", "true"])),
                        status=m.TaskStatus(state=m.TaskState.ASSIGNED,
                                            timestamp=T0 + i))
                 for i in range(3)]
        with db.batch():
            for i, t in enumerate(tasks):
                db.put_task(t, assigned=i < 2)
            db.put_status("t0", m.TaskStatus(state=m.TaskState.RUNNING,
                                             timestamp=T0 + 5,
                                             message="started"))
            db.put_status("t2", m.TaskStatus(state=m.TaskState.COMPLETE,
                                             timestamp=T0 + 6))
        db.remove("t1")
        db.put_task(tasks[1], assigned=True)
    db = storage.TaskDB(path)
    assigned = sorted((t.id, repr(serde.to_dict(t)))
                      for t in db.assigned_tasks())
    statuses = {tid: repr(serde.to_dict(db.get_status(tid)))
                for tid in ("t0", "t1", "t2", "missing")}
    return assigned, statuses


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference_writes", "port_writes"])
def test_taskdb_reads_across_packages(tmp_path, writer, reader):
    """One package's ``TaskDB`` writes; both packages read the file back
    alike, and alike to what the writer reads."""
    path = str(tmp_path / "tasks.db")
    written = _taskdb_rows(writer, path, write=True)
    read = _taskdb_rows(reader, path, write=False)
    assert read == written
    assigned, statuses = read
    assert [tid for tid, _ in assigned] == ["t0", "t1"]
    assert "'message': 'started'" in statuses["t0"]
    assert f"'state': {int(TaskState.RUNNING)}" in statuses["t0"]
    assert f"'state': {int(TaskState.COMPLETE)}" in statuses["t2"]
    assert statuses["t1"] == statuses["missing"] == "None"


def make_task():
    return Task(
        id="task1", service_id="svc1", slot=3, node_id="nodeA",
        service_annotations=Annotations(name="web",
                                        labels={"env": "prod"}),
        spec=TaskSpec(container=ContainerSpec(
            image="nginx",
            env=["SERVICE={{.Service.Name}}", "SLOT={{.Task.Slot}}",
                 "HOST={{.Node.Hostname}}", "PLAIN=1"],
            hostname="{{.Service.Name}}-{{.Task.Slot}}",
            labels={"which": "{{index .Service.Labels \"env\"}}"})),
        status=TaskStatus(state=TaskState.ASSIGNED))


def test_task_db_roundtrip_and_resume(tmp_path):
    """``tests/test_template_storage.py``'s case: a fresh ``TaskDB`` on
    the same path resumes the task with its last status folded in."""
    from swarmkit_tpu_torch.agent.storage import TaskDB

    path = os.path.join(tmp_path, "worker", "tasks.db")
    db = TaskDB(path)
    t = make_task()
    db.put_task(t)
    db.put_status(t.id, TaskStatus(state=TaskState.RUNNING,
                                   message="started"))

    # restart: a fresh TaskDB on the same path resumes the task with its
    # last reported status folded in
    db2 = TaskDB(path)
    got = db2.assigned_tasks()
    assert len(got) == 1
    assert got[0].id == t.id
    assert got[0].status.state == TaskState.RUNNING
    db2.remove(t.id)
    assert TaskDB(path).assigned_tasks() == []


def test_agent_restart_resumes_tasks(tmp_path):
    """``tests/test_template_storage.py``'s case: a worker restarted with
    the same task DB resumes supervising without any dispatcher contact
    (reference: worker.go Init)."""
    from swarmkit_tpu_torch.agent.storage import TaskDB
    from swarmkit_tpu_torch.agent.worker import Worker

    path = os.path.join(tmp_path, "tasks.db")
    t = make_task()
    t.desired_state = TaskState.RUNNING
    reported = {}

    db = TaskDB(path)
    w = Worker(TestExecutor(), lambda tid, st: reported.update({tid: st}),
               db=db)
    w.assign([("update", "task", t)])
    deadline = time.time() + 5
    while time.time() < deadline:
        if reported.get(t.id) and \
                reported[t.id].state == TaskState.RUNNING:
            break
        time.sleep(0.05)
    assert reported[t.id].state == TaskState.RUNNING
    for tid, st in reported.items():
        db.put_status(tid, st)
    w.close()

    # "restart": new worker from the same db, no assign() call
    reported2 = {}
    w2 = Worker(TestExecutor(),
                lambda tid, st: reported2.update({tid: st}), db=TaskDB(path))
    w2.init_from_db()
    assert t.id in w2.task_managers, "persisted task must be resumed"
    w2.close()


# --------------------------- tests/test_procexec.py's cases without node.py

def fast_cfg():
    return Config_(heartbeat_period=0.3, heartbeat_epsilon=0.02,
                   process_updates_interval=0.02,
                   assignment_batching_wait=0.02)


def proc_service(name, replicas, command, restart=None):
    return ServiceSpec(
        annotations=Annotations(name=name),
        task=TaskSpec(container=ContainerSpec(
            image="process", command=command),
            restart=restart or RestartPolicy(
                condition=RestartCondition.NONE)),
        mode=ServiceMode.REPLICATED,
        replicated=ReplicatedService(replicas=replicas))


@pytest.fixture
def cluster(tmp_path):
    """A manager on the host path and one agent with a
    ``ProcessExecutor`` on its dispatcher; yields (manager, agent,
    executor)."""
    if not HAVE_CRYPTOGRAPHY:
        pytest.skip("CA/TLS tests require the cryptography package")
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    executor = ProcessExecutor(hostname="proc1",
                               log_dir=str(tmp_path / "logs"),
                               stop_grace=2.0)
    n = make_ready_node("proc1")
    manager.store.update(lambda tx: tx.create(n))
    agent = Agent(n.id, executor, manager.dispatcher,
                  task_db_path=str(tmp_path / "node" / "tasks.db"))
    agent.start()
    yield manager, agent, executor
    agent.stop()
    manager.stop()


def test_process_tasks_run_and_complete(cluster):
    manager, node, executor = cluster
    api = manager.control_api
    marker = os.path.join(tempfile.mkdtemp(), "ran")
    svc = api.create_service(proc_service(
        "toucher", 2, ["sh", "-c", f"echo done >> {marker}"]))
    poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                      if t.status.state == TaskState.COMPLETE]) == 2,
         timeout=20, msg="both process replicas should COMPLETE")
    with open(marker) as f:
        assert f.read().count("done") == 2
    # stdout captured per task
    svc2 = api.create_service(proc_service(
        "talker", 1, ["sh", "-c", "echo captured-output"]))
    poll(lambda: [t for t in api.list_tasks(service_id=svc2.id)
                  if t.status.state == TaskState.COMPLETE] or None,
         timeout=20)
    t = [t for t in api.list_tasks(service_id=svc2.id)][0]
    ctlr = executor.controllers[t.id]
    assert b"captured-output" in ctlr.read_logs()


def test_process_failure_surfaces_exit_code(cluster):
    manager, node, executor = cluster
    api = manager.control_api
    svc = api.create_service(proc_service(
        "failer", 1, ["sh", "-c", "echo boom >&2; exit 3"]))

    def failed():
        ts = api.list_tasks(service_id=svc.id)
        return [t for t in ts if t.status.state == TaskState.FAILED]
    got = poll(lambda: failed() or None, timeout=20,
               msg="failing process should reach FAILED")
    assert "exited with 3" in got[0].status.err
    assert "boom" in got[0].status.err


def test_health_check_fails_unhealthy_task(cluster):
    """A failing healthcheck stops the task with a diagnostic err and the
    restart policy replaces it (reference: dockerapi controller health
    monitoring; api/types.proto HealthConfig)."""
    from swarmkit_tpu_torch.models.specs import HealthConfig

    manager, node, executor = cluster
    api = manager.control_api

    # healthy-then-unhealthy: the probe passes while the flag file
    # exists, then we delete it and the task must fail within ~2 probes
    flag = os.path.join(tempfile.mkdtemp(), "healthy")
    open(flag, "w").close()
    spec = proc_service("webish", 1, ["sh", "-c", "sleep 60"])
    spec.task.container.healthcheck = HealthConfig(
        test=["CMD", "test", "-e", flag],
        interval=0.2, timeout=1.0, retries=2, start_period=0.2)
    svc = api.create_service(spec)
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state == TaskState.RUNNING] or None,
         timeout=20, msg="task should start healthy")
    time.sleep(0.6)   # at least one passing probe
    running = [t for t in api.list_tasks(service_id=svc.id)
               if t.status.state == TaskState.RUNNING]
    assert running, "passing health checks must not kill the task"

    os.unlink(flag)
    got = poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                        if t.status.state == TaskState.FAILED] or None,
               timeout=20, msg="unhealthy task should FAIL")
    assert "health check" in got[0].status.err

    # CMD-SHELL form + restart policy: always-unhealthy task cycles
    # through replacements (the orchestrator heals unhealthy tasks)
    spec2 = proc_service(
        "sickly", 1, ["sh", "-c", "sleep 60"],
        restart=RestartPolicy(condition=RestartCondition.ON_FAILURE,
                              delay=0.05))
    spec2.task.container.healthcheck = HealthConfig(
        test=["CMD-SHELL", "exit 1"],
        interval=0.1, timeout=1.0, retries=2)
    svc2 = api.create_service(spec2)

    def replaced():
        ts = api.list_tasks(service_id=svc2.id)
        return len([t for t in ts
                    if t.status.state == TaskState.FAILED]) >= 2
    poll(replaced, timeout=25,
         msg="restart policy should replace unhealthy tasks")


def test_process_shutdown_terminates_group(cluster):
    manager, node, executor = cluster
    api = manager.control_api
    svc = api.create_service(proc_service(
        "sleeper", 1, ["sh", "-c", "sleep 300 & wait"]))
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state == TaskState.RUNNING] or None,
         timeout=20, msg="long-running process should reach RUNNING")
    tasks = api.list_tasks(service_id=svc.id)
    pid = executor.controllers[tasks[0].id].proc.pid
    api.remove_service(svc.id)
    poll(lambda: not any(t.status.state == TaskState.RUNNING
                         for t in api.list_tasks(service_id=svc.id)),
         timeout=20, msg="removal should stop the process task")

    def proc_gone():
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            return True
    poll(proc_gone, timeout=15, msg="the OS process group must die")


def test_task_logs_ship_to_broker(cluster):
    """Process stdout flows agent → dispatcher → log broker subscribers
    (reference: agent log publisher + logbroker.PublishLogs)."""
    from swarmkit_tpu_torch.manager.logbroker import LogSelector

    manager, node, executor = cluster
    node.log_ship_interval = 0.1
    api = manager.control_api
    svc = api.create_service(proc_service(
        "chatty", 1,
        ["sh", "-c", "echo hello-from-task; echo second-line"]))
    sub = manager.logbroker.subscribe_logs(
        LogSelector(service_ids=[svc.id]))
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state == TaskState.COMPLETE] or None,
         timeout=20)
    got = b""
    deadline = time.time() + 10
    while time.time() < deadline and b"second-line" not in got:
        try:
            got += sub.get(timeout=1.0).data
        except TimeoutError:
            pass
    assert b"hello-from-task" in got and b"second-line" in got
    sub.close()



def test_process_task_receives_secret_and_config_files(cluster):
    """Secrets/configs materialize as per-task files with their paths in
    SWARM_SECRET_* / SWARM_CONFIG_* env vars (the process equivalent of
    the reference's /run/secrets mounts)."""
    from swarmkit_tpu_torch.models.specs import ConfigSpec, SecretSpec
    from swarmkit_tpu_torch.models.types import ConfigReference, SecretReference

    manager, node, executor = cluster
    api = manager.control_api
    secret = api.create_secret(SecretSpec(
        annotations=Annotations(name="db-pass"), data=b"hunter2"))
    config = api.create_config(ConfigSpec(
        annotations=Annotations(name="app-conf"), data=b"mode=fast"))
    out = os.path.join(tempfile.mkdtemp(), "out")
    spec = proc_service(
        "secretuser", 1,
        ["sh", "-c",
         f'cat "$SWARM_SECRET_DB_PASS" "$SWARM_CONFIG_APP_CONF" > {out}'])
    spec.task.container.secrets = [SecretReference(
        secret_id=secret.id, secret_name="db-pass", target="db-pass")]
    spec.task.container.configs = [ConfigReference(
        config_id=config.id, config_name="app-conf",
        target="app-conf")]
    svc = api.create_service(spec)
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state == TaskState.COMPLETE] or None,
         timeout=20, msg="secret-using task completes")
    with open(out, "rb") as f:
        assert f.read() == b"hunter2mode=fast"
    # secret file mode is owner-only
    t = api.list_tasks(service_id=svc.id)[0]
    ctlr = executor.controllers[t.id]
    spath = os.path.join(ctlr.deps_dir, "secrets", "db-pass")
    # the file may already be cleaned with the task; check only if present
    if os.path.exists(spath):
        assert (os.stat(spath).st_mode & 0o777) == 0o600
    # controller close must shred the plaintext material
    ctlr.close()
    assert not os.path.exists(ctlr.deps_dir)
