"""The port's ``cli.py`` and ``node.py`` on the CPU.

- The CLI cases of ``tests/test_controlapi.py`` (volume, network,
  cluster, extension and resource nouns; service statuses with a node
  joined through ``node.Node``; every noun over a ``RemoteControlClient``;
  a CSI volume's life driven from the CLI; ``cluster update``), of
  ``tests/test_manager_components.py`` (a standalone manager driven from
  the CLI with a worker joined through ``node.Node``) and of
  ``tests/test_procexec.py`` (task logs over TCP, ``service logs``), each
  manager on the host path as the reference's cases run.
- ``cli.run_command`` prints the same for the same scripted commands
  against either package's ``ControlAPI``, ids minted from one counter
  and the clock fixed in both packages.
"""

import importlib
import itertools
import shlex
import tempfile
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.agent import ProcessExecutor  # noqa: E402
from swarmkit_tpu_torch.agent.testutils import TestExecutor  # noqa: E402
from swarmkit_tpu_torch.cli import run_command  # noqa: E402
from swarmkit_tpu_torch.manager import Manager  # noqa: E402
from swarmkit_tpu_torch.manager.controlapi import APIError  # noqa: E402
from swarmkit_tpu_torch.manager.dispatcher import Config_  # noqa: E402
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, Cluster, ContainerSpec, ReplicatedService,
    RestartCondition, RestartPolicy, ServiceMode, ServiceSpec, TaskSpec,
    TaskState,
)
from swarmkit_tpu_torch.models.types import NodeRole  # noqa: E402
from swarmkit_tpu_torch.node import Node as ClusterNode  # noqa: E402
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    poll, singletons_left_as_found,
)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


# ------------------------------------ tests/test_controlapi.py's CLI cases

@requires_crypto
def test_cli_volume_network_cluster_nouns():
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.manager import Manager

    m = Manager(use_device_scheduler=False)
    m.run()
    api2 = m.control_api
    try:
        vid = run_command(["volume", "create", "data1",
                           "--driver", "csi.example",
                           "--group", "fast"], api2)
        out = run_command(["volume", "ls"], api2)
        assert "data1" in out and "fast" in out
        out = run_command(["volume", "inspect", "data1"], api2)
        assert vid in out
        run_command(["volume", "drain", "data1"], api2)
        run_command(["volume", "rm", "data1", "--force"], api2)
        assert "data1" not in run_command(["volume", "ls"], api2)

        nid = run_command(["network", "create", "backend",
                           "--subnet", "10.99.0.0/24"], api2)
        assert "backend" in run_command(["network", "ls"], api2)
        assert "10.99.0.0/24" in run_command(
            ["network", "inspect", "backend"], api2)
        run_command(["network", "rm", "backend"], api2)

        out = run_command(["cluster", "inspect"], api2)
        assert "SWMTKN-1-" in out
        ls = run_command(["cluster", "ls"], api2)
        assert "default" in ls and "AUTOLOCK" in ls
        token = run_command(["cluster", "rotate-token", "worker"], api2)
        assert token.startswith("SWMTKN-1-")
        assert token in run_command(["cluster", "inspect"], api2)

        run_command(["extension", "create", "widgets"], api2)
        run_command(["resource", "create", "w1", "widgets"], api2)
        assert "w1" in run_command(["resource", "ls"], api2)
        run_command(["resource", "rm", "w1"], api2)
        run_command(["extension", "rm", "widgets"], api2)
    finally:
        m.stop()


@requires_crypto
def test_list_service_statuses():
    """Desired/running counts per service — the `service ls` helper
    (reference: manager/controlapi/service.go:1047 ListServiceStatuses:
    replicated desired = replicas; global desired counts live tasks;
    unknown ids return zeroed statuses)."""
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.manager import Manager
    from swarmkit_tpu_torch.models import (
        Annotations, ContainerSpec, ServiceMode, ServiceSpec, TaskSpec,
    )

    from test_torch_dispatcher import poll

    m = Manager(use_device_scheduler=False)
    m.run()
    api = m.control_api
    try:
        run_command(["service", "create", "--name", "web",
                     "--image", "nginx", "--replicas", "3"], api)
        svc = api.list_services("web")[0]
        gsvc = api.create_service(ServiceSpec(
            annotations=Annotations(name="agent-everywhere"),
            task=TaskSpec(container=ContainerSpec(image="agent")),
            mode=ServiceMode.GLOBAL))
        # no agents: replicated tasks never RUN, but desired is 3 now
        sts = {st["service_id"]: st for st in api.list_service_statuses(
            [svc.id, gsvc.id, "no-such-service"])}
        assert sts[svc.id]["desired_tasks"] == 3
        assert sts["no-such-service"] == {
            "service_id": "no-such-service", "desired_tasks": 0,
            "running_tasks": 0, "completed_tasks": 0}

        # a node joins: global desired becomes 1, and once tasks run the
        # running counts follow
        from swarmkit_tpu_torch.agent.testutils import TestExecutor
        from swarmkit_tpu_torch.node import Node as ClusterNode
        import tempfile
        node = ClusterNode(TestExecutor(hostname="w1"), tempfile.mkdtemp())
        cluster = api.get_default_cluster()
        node.load_or_join(m.ca_server, cluster.root_ca.join_tokens.worker)
        node.start(m.dispatcher, store=m.store, hostname="w1")
        try:
            def counts():
                sts = {st["service_id"]: st
                       for st in api.list_service_statuses(
                           [svc.id, gsvc.id])}
                return (sts[svc.id]["running_tasks"] == 3
                        and sts[gsvc.id]["desired_tasks"] == 1
                        and sts[gsvc.id]["running_tasks"] == 1)
            poll(counts, timeout=20,
                 msg="statuses should reach 3/3 and 1/1")
            ls = run_command(["service", "ls"], api)
            assert "3/3" in ls and "1/1" in ls
        finally:
            node.stop()
    finally:
        m.stop()


@requires_crypto
def test_cli_nouns_over_remote_control_client():
    """The same CLI nouns drive a remote manager through the mTLS control
    client (reference: swarmctl against a live manager)."""
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.manager import Manager
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.net import (
        ManagerServer, RemoteControlClient, issue_certificate,
    )
    from swarmkit_tpu_torch.state.store import ByName
    from swarmkit_tpu_torch.utils import new_id

    m = Manager(use_device_scheduler=False)
    m.run()
    srv = ManagerServer(m)
    srv.start()
    try:
        cluster = m.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        op = issue_certificate(srv.addr, new_id(),
                               cluster.root_ca.join_tokens.manager)
        ctl = RemoteControlClient(srv.addr, op)
        run_command(["volume", "create", "rv", "--driver", "csi.x"], ctl)
        assert "rv" in run_command(["volume", "ls"], ctl)
        run_command(["volume", "rm", "rv", "--force"], ctl)
        run_command(["network", "create", "rnet"], ctl)
        assert "rnet" in run_command(["network", "ls"], ctl)
        run_command(["network", "rm", "rnet"], ctl)
        tok = run_command(["cluster", "rotate-token", "worker"], ctl)
        assert tok.startswith("SWMTKN-1-")
        run_command(["extension", "create", "kinds"], ctl)
        run_command(["resource", "create", "k1", "kinds"], ctl)
        assert "k1" in run_command(["resource", "ls"], ctl)
        run_command(["resource", "rm", "k1"], ctl)
        run_command(["secret", "create", "rs", "payload"], ctl)
        insp = run_command(["secret", "inspect", "rs"], ctl)
        assert "Name: rs" in insp and "payload" not in insp
        run_command(["secret", "rm", "rs"], ctl)
        run_command(["config", "create", "rc", "k=v"], ctl)
        assert "Data: k=v" in run_command(["config", "inspect", "rc"], ctl)
        run_command(["config", "rm", "rc"], ctl)
        run_command(["extension", "rm", "kinds"], ctl)
        # service ls pulls running/desired through the wire statuses RPC
        run_command(["service", "create", "--name", "rweb",
                     "--image", "nginx", "--replicas", "2"], ctl)
        assert "0/2" in run_command(["service", "ls"], ctl)
        run_command(["service", "rm", "rweb"], ctl)
        ctl.close()
    finally:
        srv.stop()
        m.stop()


@requires_crypto
def test_csi_volume_lifecycle_e2e_from_cli():
    """VERDICT r2 item 3 done-criterion: volume create -> schedule a task
    using it -> publish -> drain -> unpublish, all driven from the CLI
    (reference: volume.go + csi manager + VolumesFilter together)."""
    import time

    from swarmkit_tpu_torch.agent import Agent
    from swarmkit_tpu_torch.agent.testutils import TestExecutor
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.manager import Manager
    from swarmkit_tpu_torch.manager.dispatcher import Config_
    from swarmkit_tpu_torch.models import Task, TaskState
    from swarmkit_tpu_torch.models.types import VolumePublishStatus

    from test_torch_dispatcher import poll
    from test_torch_dispatcher import make_ready_node

    m = Manager(dispatcher_config=Config_(
        heartbeat_period=0.3, heartbeat_epsilon=0.02,
        process_updates_interval=0.02, assignment_batching_wait=0.02),
        use_device_scheduler=False)
    m.run()
    api2 = m.control_api
    n = make_ready_node("csi-n1")
    m.store.update(lambda tx, n=n: tx.create(n))
    agent = Agent(n.id, TestExecutor(hostname="csi-n1"), m.dispatcher)
    agent.start()
    try:
        vid = run_command(["volume", "create", "data1",
                           "--driver", "inmem"], api2)
        # csi manager creates it plugin-side
        poll(lambda: api2.get_volume(vid).volume_info is not None
             and api2.get_volume(vid).volume_info.volume_id,
             timeout=10, msg="csi manager should create the volume")

        run_command(["service", "create", "--name", "dbsvc",
                     "--image", "db", "--replicas", "1",
                     "--csi-volume", "data1:/data"], api2)

        def task_running_with_volume():
            ts = [t for t in api2.list_tasks()
                  if t.service_annotations.name == "dbsvc"
                  and t.desired_state == TaskState.RUNNING]
            return (ts and ts[0].status.state == TaskState.RUNNING
                    and any(va.id == vid for va in ts[0].volumes))
        poll(task_running_with_volume, timeout=20,
             msg="task should run with the volume attached")

        def published():
            v = api2.get_volume(vid)
            return any(p.node_id == n.id and p.state ==
                       VolumePublishStatus.State.PUBLISHED
                       for p in v.publish_status)
        poll(published, timeout=10,
             msg="csi manager should controller-publish on the node")
        assert "published" in run_command(
            ["volume", "inspect", "data1"], api2)

        # drain: the volume enforcer evicts the task, the csi manager
        # unpublishes once unused
        run_command(["volume", "drain", "data1"], api2)

        def unpublished():
            v = api2.get_volume(vid)
            return not v.publish_status
        poll(unpublished, timeout=20,
             msg="drained volume should unpublish after eviction")

        # and now removable without force
        run_command(["service", "rm", "dbsvc"], api2)
        run_command(["volume", "rm", "data1"], api2)
        poll(lambda: not [v for v in api2.list_volumes()
                          if v.spec.annotations.name == "data1"],
             timeout=10, msg="pending-delete volume should be deleted")
    finally:
        agent.stop()
        m.stop()


def test_cli_cluster_update_live_settings():
    """swarmctl cluster update flags flow into the watched ClusterSpec
    (reference: swarmctl cluster update)."""
    from swarmkit_tpu_torch.cli import run_command
    from swarmkit_tpu_torch.manager.controlapi import ControlAPI
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.models.specs import ClusterSpec
    from swarmkit_tpu_torch.models.types import Annotations
    from swarmkit_tpu_torch.state import MemoryStore

    store = MemoryStore()
    store.update(lambda tx: tx.create(Cluster(
        id="c1", spec=ClusterSpec(annotations=Annotations(name="default")))))
    api = ControlAPI(store)
    out = run_command(["cluster", "update", "--heartbeat-period", "2.5",
                       "--cert-expiry", "3600",
                       "--task-history-limit", "9"], api)
    assert "heartbeat-period=2.5s" in out
    c = api.get_default_cluster()
    assert c.spec.dispatcher.heartbeat_period == 2.5
    assert c.spec.ca_config.node_cert_expiry == 3600
    assert c.spec.orchestration.task_history_retention_limit == 9
    assert run_command(["cluster", "update"], api) == "nothing to update"



# ---------------------------- tests/test_manager_components.py's CLI case

def fast_cfg():
    return Config_(heartbeat_period=0.3, heartbeat_epsilon=0.02,
                   process_updates_interval=0.02,
                   assignment_batching_wait=0.02)


@requires_crypto
def test_manager_standalone_cluster_and_cli():
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    node = None
    try:
        assert manager.is_leader
        # the default cluster exists with join tokens
        from swarmkit_tpu_torch.state.store import ByName
        cluster = manager.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        assert cluster.root_ca.join_tokens.worker.startswith("SWMTKN-1-")

        # join a worker node through the CA with the worker token
        import tempfile
        node = ClusterNode(TestExecutor(hostname="w1"),
                           tempfile.mkdtemp())
        node.load_or_join(manager.ca_server,
                          cluster.root_ca.join_tokens.worker)
        assert node.role == NodeRole.WORKER
        node.start(manager.dispatcher, store=manager.store, hostname="w1")

        api = manager.control_api
        out = run_command(["service", "create", "--name", "web",
                           "--image", "nginx", "--replicas", "2"], api)
        service_id = out.strip()

        def running():
            tasks = api.list_tasks(service_id=service_id)
            return (len([t for t in tasks
                         if t.desired_state == TaskState.RUNNING]) == 2
                    and all(t.status.state == TaskState.RUNNING
                            for t in tasks
                            if t.desired_state == TaskState.RUNNING))
        poll(running, timeout=20,
             msg="service created via CLI should reach RUNNING")

        ls = run_command(["service", "ls"], api)
        assert "web" in ls and "nginx" in ls
        tasks_out = run_command(["task", "ls"], api)
        assert "RUNNING" in tasks_out and "web.1" in tasks_out
        t0 = api.list_tasks(service_id=service_id)[0]
        insp = run_command(["task", "inspect", t0.id[:8]], api)
        assert f"ID: {t0.id}" in insp and "Status: " in insp
        assert "Image: nginx" in insp
        nodes_out = run_command(["node", "ls"], api)
        assert "w1" in nodes_out and "READY" in nodes_out

        # availability verbs (reference: swarmctl node pause/activate)
        run_command(["node", "pause", "w1"], api)
        assert "pause" in run_command(["node", "ls"], api)
        run_command(["node", "activate", "w1"], api)
        assert "active" in run_command(["node", "ls"], api)
        insp = run_command(["node", "inspect", "w1"], api)
        assert "Hostname: w1" in insp and "Availability: active" in insp

        # service create flag surface (reference: swarmctl
        # service/flagparser): env, labels, publish, restart policy,
        # secret/config refs, network attachment, global mode
        run_command(["secret", "create", "db-pass", "hunter2"], api)
        run_command(["config", "create", "app-conf", "x=1"], api)
        nid = run_command(["network", "create", "backend0"], api)
        sid2 = run_command(
            ["service", "create", "--name", "rich", "--image", "api:1",
             "--replicas", "1", "--env", "MODE=prod", "--label", "tier=web",
             "--publish", "8080:80", "--publish", "53:53/udp",
             "--network", "backend0", "--secret", "db-pass",
             "--config", "app-conf:conf/app.ini",
             "--restart-condition", "on-failure",
             "--restart-delay", "0.5"], api)
        rich = api.get_service(sid2)
        assert rich.spec.task.container.env == ["MODE=prod"]
        assert rich.spec.annotations.labels == {"tier": "web"}
        ports = rich.spec.endpoint.ports
        assert [(p.published_port, p.target_port, int(p.protocol))
                for p in ports] == [(8080, 80, 0), (53, 53, 1)]
        assert rich.spec.task.networks[0].target == nid
        assert rich.spec.task.container.secrets[0].secret_name == "db-pass"
        cref = rich.spec.task.container.configs[0]
        assert cref.target == "conf/app.ini"
        assert rich.spec.task.restart.condition.name == "ON_FAILURE"
        assert rich.spec.task.restart.delay == 0.5
        run_command(["service", "rm", "rich"], api)

        gid = run_command(
            ["service", "create", "--name", "everywhere",
             "--image", "agent:1", "--mode", "global"], api)
        assert api.get_service(gid).spec.mode.name == "GLOBAL"
        poll(lambda: [t for t in api.list_tasks(service_id=gid)
                      if t.status.state == TaskState.RUNNING] or None,
             timeout=20, msg="global service should land on the worker")
        with pytest.raises(APIError):
            run_command(["service", "scale", "everywhere=3"], api)
        run_command(["service", "rm", "everywhere"], api)
        with pytest.raises(APIError):
            run_command(["service", "create", "--name", "x", "--image",
                         "i", "--mode", "global", "--replicas", "5"], api)
        with pytest.raises(APIError):
            run_command(["service", "create", "--name", "x", "--image",
                         "i", "--publish", "99999:80"], api)

        # rolling update from the CLI: new image reaches every replica
        # through the update supervisor (reference: swarmctl service
        # update driving updater.go)
        run_command(["service", "update", "web", "--image", "nginx:2",
                     "--update-parallelism", "2"], api)
        def updated():
            tasks = [t for t in api.list_tasks(service_id=service_id)
                     if t.desired_state == TaskState.RUNNING]
            return (len(tasks) == 2 and all(
                t.spec.container.image == "nginx:2"
                and t.status.state == TaskState.RUNNING for t in tasks))
        poll(updated, timeout=30,
             msg="all replicas should roll to the new image")
        assert "nginx:2" in run_command(["service", "ls"], api)

        # in-proc agents follow key-manager rotations through the local
        # heartbeat piggyback (LocalDispatcherClient), like remote workers
        ex = node.executor
        poll(lambda: getattr(ex, "network_keys", None), timeout=10,
             msg="network keys should reach the in-proc agent")
        clock0 = max(k.lamport_time for k in ex.network_keys)
        manager.keymanager.rotate_now()
        poll(lambda: max(k.lamport_time for k in ex.network_keys) > clock0,
             timeout=10, msg="rotated keys should reach the in-proc agent")

        run_command(["service", "scale", "web=4"], api)
        poll(lambda: len([t for t in api.list_tasks(service_id=service_id)
                          if t.desired_state == TaskState.RUNNING]) == 4,
             timeout=20)

        out = run_command(["service", "rm", "web"], api)
        assert out == service_id
        with pytest.raises(APIError):
            run_command(["service", "inspect", "web"], api)

        # metrics exposed
        from swarmkit_tpu_torch.utils.metrics import registry
        text = registry.expose()
        assert "swarm_manager_nodes" in text
        assert "swarm_store_write_tx_latency_seconds_count" in text
    finally:
        if node is not None:
            node.stop()
        manager.stop()



# ------------------------------------ tests/test_procexec.py's CLI cases

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
def cluster():
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    log_dir = tempfile.mkdtemp()
    executor = ProcessExecutor(hostname="proc1", log_dir=log_dir,
                               stop_grace=2.0)
    node = ClusterNode(executor, tempfile.mkdtemp())
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.state.store import ByName
    cl = manager.store.view(
        lambda tx: tx.find(Cluster, ByName("default")))[0]
    node.load_or_join(manager.ca_server, cl.root_ca.join_tokens.worker)
    node.start(manager.dispatcher, store=manager.store, hostname="proc1")
    yield manager, node, executor
    node.stop()
    manager.stop()


def test_task_logs_ship_over_tcp():
    """Same flow over the wire: remote agent publishes log bytes through
    the TCP dispatcher surface."""
    from swarmkit_tpu_torch.agent import Agent
    from swarmkit_tpu_torch.manager.logbroker import LogSelector
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.net import ManagerServer, RemoteDispatcherClient, \
        issue_certificate
    from swarmkit_tpu_torch.state.store import ByName

    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    server = ManagerServer(manager)
    server.start()
    agent = None
    try:
        cl = manager.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        node_id = new_id()
        cert = issue_certificate(server.addr, node_id,
                                 cl.root_ca.join_tokens.worker)
        client = RemoteDispatcherClient(server.addr, cert)
        executor = ProcessExecutor(hostname="tcp-proc",
                                   log_dir=tempfile.mkdtemp())
        agent = Agent(node_id, executor, client)
        agent.log_ship_interval = 0.1
        agent.start()

        api = manager.control_api
        svc = api.create_service(proc_service(
            "tcp-chatty", 1, ["sh", "-c", "echo over-the-wire"]))
        sub = manager.logbroker.subscribe_logs(
            LogSelector(service_ids=[svc.id]))
        got = b""
        deadline = time.time() + 15
        while time.time() < deadline and b"over-the-wire" not in got:
            try:
                got += sub.get(timeout=1.0).data
            except TimeoutError:
                pass
        assert b"over-the-wire" in got
        sub.close()
    finally:
        if agent is not None:
            agent.stop()
        server.stop()
        manager.stop()


def test_cli_service_logs(cluster):
    """`swarmctl service logs` collects live output via the broker."""
    from swarmkit_tpu_torch.cli import run_command

    manager, node, executor = cluster
    node.agent.log_ship_interval = 0.1
    api = manager.control_api
    svc = api.create_service(proc_service(
        "logger", 1,
        ["sh", "-c", "for i in 1 2 3; do echo line-$i; sleep 0.4; done"]))
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state >= TaskState.RUNNING] or None,
         timeout=20, msg="logger task should start")
    out = run_command(["service", "logs", "logger", "--duration", "4"],
                      api)
    # live-only stream: line-1 may print before collection subscribes,
    # but the tail of the output must land inside the window
    assert "line-" in out and "line-3" in out

    # history replay: --no-follow returns instantly from the broker's
    # ring — including output that predates this subscription — and
    # --tail bounds it (reference: LogSubscriptionOptions)
    out = run_command(["service", "logs", "logger", "--no-follow"], api)
    assert "line-1" in out and "line-3" in out
    # tail bounds the replay to the last message(s) per task
    msgs = api.collect_logs(svc.id, tail=1, follow=False)
    assert len(msgs) == 1 and b"line-3" in msgs[0]["data"]
    assert "logger." in out and "@" in out



# ------------------------------------------ the same command lines, twice

#: command lines an operator types, in order; ``{web}`` is the id the
#: first ``service create`` printed
CLI_SCRIPT = (
    "service create --name web --image nginx:1 --replicas 3 "
    "--env MODE=prod --label tier=web --publish 8080:80",
    "service create --name web --image nginx:1",
    "service create --name bad! --image nginx:1",
    "service create --name x --image i --mode global --replicas 5",
    "service create --name x --image i --publish 99999:80",
    "service create --name agent --image agent:1 --mode global",
    "service ls",
    "service inspect web",
    "service inspect {web}",
    "service scale web=5",
    "service scale agent=3",
    "service scale web=many",
    "service update web --image nginx:2 --update-parallelism 2",
    "service inspect nope",
    "task ls",
    "task inspect t0",
    "node ls",
    "node inspect n0",
    "node pause n1",
    "node drain n2",
    "node activate n1",
    "node ls",
    "node rm n0",
    "secret create db-pass hunter2",
    "secret create db-pass again",
    "secret ls",
    "secret inspect db-pass",
    "config create app-conf x=1",
    "config ls",
    "config inspect app-conf",
    "network create backend --subnet 10.99.0.0/24",
    "network ls",
    "network inspect backend",
    "network rm backend",
    "volume create data1 --driver csi.example --group fast",
    "volume ls",
    "volume inspect data1",
    "volume drain data1",
    "volume rm data1 --force",
    "extension create widgets",
    "resource create w1 widgets",
    "resource ls",
    "resource rm w1",
    "extension rm widgets",
    "cluster ls",
    "cluster inspect",
    "cluster update --heartbeat-period 2.5 --task-history-limit 9",
    "cluster update",
    "cluster rotate-token worker",
    "secret rm db-pass",
    "config rm app-conf",
    "service rm web",
    "service ls",
    "bogus verb",
)


def cli_script(name):
    """``CLI_SCRIPT`` through ``name``'s ``cli.run_command`` against its
    ``ControlAPI`` over a store holding the default cluster, three READY
    nodes and two tasks of the first service: each line's output, or its
    error's class and message, or argparse's exit code."""
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    cli, m, sp = mod("cli"), mod("models"), mod("models.specs")
    store = mod("state").MemoryStore()

    def setup(tx):
        tx.create(m.Cluster(id="cluster-0", spec=sp.ClusterSpec(
            annotations=m.Annotations(name="default"))))
        for i in range(3):
            tx.create(m.Node(
                id=f"node-{i}",
                spec=sp.NodeSpec(annotations=m.Annotations(name=f"n{i}")),
                status=m.NodeStatus(state=m.NodeState.READY),
                description=m.NodeDescription(hostname=f"n{i}")))

    store.update(setup)
    api = mod("manager.controlapi").ControlAPI(store)
    out, ids = [], {}
    for line in CLI_SCRIPT:
        argv = shlex.split(line.format(**ids))
        try:
            got = ("ok", cli.run_command(argv, api))
        except SystemExit as exc:
            got = ("exit", exc.code)
        except Exception as exc:
            got = ("error", type(exc).__name__, str(exc))
        out.append(got)
        if not ids and got[0] == "ok":
            ids["web"] = got[1]
            svc = api.get_service(got[1])

            def tasks(tx, svc=svc):
                for slot in (1, 2):
                    tx.create(m.Task(
                        id=f"t{slot - 1}", service_id=svc.id, slot=slot,
                        node_id=f"node-{slot}", spec=svc.spec.task,
                        service_annotations=svc.spec.annotations,
                        desired_state=m.TaskState.RUNNING,
                        status=m.TaskStatus(state=m.TaskState.RUNNING)))

            store.update(tasks)
    return out


def test_cli_output_matches_reference(capsys):
    outputs = {}
    for name in (REF, PORT):
        p_types = importlib.import_module(f"{name}.models.types")
        p_ident = importlib.import_module(f"{name}.utils.identity")
        n = itertools.count()
        p_types.set_time_source(lambda: T0)
        p_ident.set_id_source(lambda n=n: f"id{next(n):08d}")
        try:
            outputs[name] = cli_script(name)
        finally:
            p_types.set_time_source(None)
            p_ident.set_id_source(None)
        outputs[name + " stderr"] = capsys.readouterr()
    ref, port = outputs[REF], outputs[PORT]
    assert len(port) == len(ref) == len(CLI_SCRIPT)
    for line, a, b in zip(CLI_SCRIPT, port, ref):
        assert a == b, f"{line!r}: port {a!r} != reference {b!r}"
    assert outputs[PORT + " stderr"] == outputs[REF + " stderr"]
    kinds = [r[0] for r in port]
    assert kinds.count("ok") >= 35 and "error" in kinds and "exit" in kinds
