"""The wire between the two packages, and the daemons side by side.

- The wire is JSON (``net/wire.py``), so the packages interoperate: the
  port's ``RemoteDispatcherClient`` (under the port's agents) and
  ``RemoteControlClient`` against the reference's ``ManagerServer`` on
  its host path, and the reference's clients and agents against the
  port's ``ManagerServer`` over ``TorchPlanner(device="cpu")``: each
  creates a service whose replicas all reach RUNNING, with equal
  replicas per node both ways.
- ``workload.daemon_swarm`` at one manager, three workers and 12
  replicas (a worker stopped and healed) on the port's daemons
  (``device="cpu"``) and on the reference's (host path): equal sorted
  replicas per node after the create and after the heal.

Each case gets one retry after a failure, as ``tests/conftest.py`` gives
the reference's daemon files (threads, TCP links, heartbeats and
elections on a loaded runner).
"""

import importlib
import tempfile
from types import SimpleNamespace

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch import workload  # noqa: E402
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402

from test_torch_raft import retried  # noqa: E402
from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    poll, singletons_left_as_found,
)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
AGENTS, REPLICAS = 3, 12

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def pkg(name):
    def mod(path):
        return importlib.import_module(f"{name}.{path}")
    return SimpleNamespace(
        name=name, manager=mod("manager"),
        dispatcher=mod("manager.dispatcher"),
        net=mod("net"), agent=mod("agent"), testutils=mod("agent.testutils"),
        models=mod("models"), store=mod("state.store"), utils=mod("utils"))


def fast_cfg(p):
    return p.dispatcher.Config_(
        heartbeat_period=0.3, heartbeat_epsilon=0.02,
        process_updates_interval=0.02, assignment_batching_wait=0.02)


def remote_service(server_pkg, client_pkg):
    """``server_pkg``'s ``Manager`` and ``ManagerServer`` (the port's on
    ``TorchPlanner(device="cpu")``, the reference's on its host path);
    ``AGENTS`` agents of ``client_pkg`` joined over its
    ``issue_certificate`` and ``RemoteDispatcherClient``; a replicated
    service of ``REPLICAS`` made through its ``RemoteControlClient``.
    Returns the sorted replicas a node once every replica runs."""
    s, c = pkg(server_pkg), pkg(client_pkg)
    kw = {"device": "cpu"} if server_pkg == PORT \
        else {"use_device_scheduler": False}
    manager = s.manager.Manager(dispatcher_config=fast_cfg(s), **kw)
    manager.run()
    server = s.net.ManagerServer(manager)
    server.start()
    agents, control = [], None
    try:
        cluster = manager.store.view(lambda tx: tx.find(
            s.models.Cluster, s.store.ByName("default")))[0]
        tokens = cluster.root_ca.join_tokens
        for i in range(AGENTS):
            node_id = c.utils.new_id()
            cert = c.net.issue_certificate(server.addr, node_id,
                                           tokens.worker)
            agent = c.agent.Agent(
                node_id, c.testutils.TestExecutor(hostname=f"x{i}"),
                c.net.RemoteDispatcherClient(server.addr, cert))
            agent.start()
            agents.append(agent)
        poll(lambda: sum(n.status.state == s.models.NodeState.READY
                         for n in manager.control_api.list_nodes())
             == AGENTS, timeout=30, msg="every agent READY")
        op = c.net.issue_certificate(server.addr, c.utils.new_id(),
                                     tokens.manager)
        control = c.net.RemoteControlClient(server.addr, op)
        m = c.models
        svc = control.create_service(m.ServiceSpec(
            annotations=m.Annotations(name="web"),
            task=m.TaskSpec(container=m.ContainerSpec(image="nginx")),
            mode=m.ServiceMode.REPLICATED,
            replicated=m.ReplicatedService(replicas=REPLICAS)))

        def running():
            live = [t for t in control.list_tasks(service_id=svc.id)
                    if t.desired_state == m.TaskState.RUNNING]
            if len(live) == REPLICAS and all(
                    t.status.state == m.TaskState.RUNNING for t in live):
                return live
            return None

        live = poll(running, timeout=30, msg="every replica RUNNING")
        assert {t.node_id for t in live} == {a.node_id for a in agents}
        per = {}
        for t in live:
            per[t.node_id] = per.get(t.node_id, 0) + 1
        return sorted(per.values())
    finally:
        if control is not None:
            control.close()
        for a in agents:
            a.stop()
        server.stop()
        manager.stop()


@requires_crypto
@retried
def test_port_clients_against_reference_server():
    port_on_ref = remote_service(REF, PORT)
    assert port_on_ref == remote_service(REF, REF) == [4, 4, 4]


@requires_crypto
@retried
def test_reference_clients_against_port_server():
    ref_on_port = remote_service(PORT, REF)
    assert ref_on_port == remote_service(PORT, PORT) == [4, 4, 4]


def reference_tools():
    """The reference's daemon, CLI and wire clients as
    ``workload.daemon_swarm`` takes them (no device argument)."""
    return SimpleNamespace(
        Swarmd=importlib.import_module(f"{REF}.swarmd").Swarmd,
        run_command=importlib.import_module(f"{REF}.cli").run_command,
        RemoteControlClient=importlib.import_module(
            f"{REF}.net").RemoteControlClient,
        issue_certificate=importlib.import_module(
            f"{REF}.net").issue_certificate,
        daemon_kw={})


@requires_crypto
@retried
def test_daemon_swarm_matches_reference(tmp_path):
    """One manager and three workers, 12 replicas, a worker stopped: the
    port's daemons planning on the CPU place as the reference's do on
    their host path, replicas per node sorted (hostnames and ids are
    drawn afresh in each run)."""
    runs = {}
    for name, tools, on_planner in (
            (PORT, workload.swarmd_tools("cpu"), True),
            (REF, reference_tools(), False)):
        runs[name] = workload.daemon_swarm(
            tempfile.mkdtemp(dir=tmp_path), tools=tools,
            use_device_scheduler=on_planner, **workload.SWARMD_PARITY)
    port, ref = runs[PORT], runs[REF]
    assert port["planner"] == "TorchPlanner" \
        and port["planner_device"] == "cpu"
    assert ref["planner"] is None
    for stage in ("create", "heal"):
        assert sorted(port["per_host"][stage].values()) \
            == sorted(ref["per_host"][stage].values()), stage
    assert sorted(port["per_host"]["create"].values()) == [3, 3, 3, 3]
    assert sorted(port["per_host"]["heal"].values()) == [4, 4, 4]
    assert "w0" not in port["per_host"]["heal"]
    assert port["flapped"] == ref["flapped"] == []
