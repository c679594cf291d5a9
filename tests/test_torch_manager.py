"""The port's ``Manager``, on the CPU.

- The port's copies of ``tests/test_manager_components.py``'s
  leadership lifecycle (the leader's loops start and stop with
  leadership) and its two deallocator cases, and of
  ``tests/test_controlapi.py``'s join-token rotation through a running
  manager.
- ``Manager()`` resolves its planner's device in the caller's thread:
  where there is no card it raises there, before any loop starts; with
  ``device="cpu"`` the leader schedules on ``TorchPlanner`` over the
  plain versions.
- ``workload.e2e`` (bench.py's ``run_e2e``: a service created through
  the manager's control API reaching RUNNING on agents with a
  ``TestExecutor``) with ``device="cpu"`` at 4 agents x 40 replicas,
  standalone and over a single-voter raft with a sealed WAL: every
  replica RUNNING and ten a node, as the reference's ``Manager`` places
  them on the same shape; then the heal: one agent stopped, its node
  DOWN, its replicas RUNNING on the three others.

Thread schedules decide when things happen here, never where: the
per-node counts are exact.  Every wait polls with a bound.
"""

import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402
import torch  # noqa: E402

from swarmkit_tpu_torch import workload  # noqa: E402
from swarmkit_tpu_torch.manager import Manager  # noqa: E402
from swarmkit_tpu_torch.manager.dispatcher import Config_  # noqa: E402
from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, Network, Service, Task, TaskState, TaskStatus,
)
from swarmkit_tpu_torch.models.types import NodeRole  # noqa: E402
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402
from swarmkit_tpu_torch.state import MemoryStore  # noqa: E402
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")

#: the end to end's shape here: ten replicas a node
E2E_AGENTS, E2E_REPLICAS = 4, 40


def fast_cfg():
    return Config_(heartbeat_period=0.3, heartbeat_epsilon=0.02,
                   process_updates_interval=0.02,
                   assignment_batching_wait=0.02)


# ---------------------------------- tests/test_manager_components.py's cases

@requires_crypto
def test_manager_leadership_lifecycle():
    """become_leader starts the loops; become_follower stops them."""
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    try:
        assert manager.scheduler is not None
        assert manager.dispatcher is not None
        manager._become_follower()
        assert manager.scheduler is None
        assert manager.dispatcher is None
        assert not manager.is_leader
        manager._become_leader()
        assert manager.scheduler is not None
    finally:
        manager.stop()


def test_deallocator_waits_for_tasks_then_frees_networks():
    """Services marked pending_delete are removed only once their tasks
    drain, and their pending-delete networks are freed unless another
    service still uses them (reference: manager/deallocator/
    deallocator.go + its test scenarios)."""
    from swarmkit_tpu_torch.manager.deallocator import Deallocator
    from swarmkit_tpu_torch.models.specs import NetworkSpec
    from swarmkit_tpu_torch.models.types import NetworkAttachmentConfig

    store = MemoryStore()
    net_shared = Network(id=new_id(), spec=NetworkSpec(
        annotations=Annotations(name="shared")), pending_delete=True)
    net_own = Network(id=new_id(), spec=NetworkSpec(
        annotations=Annotations(name="own")), pending_delete=True)
    doomed = make_replicated("doomed", 2)
    doomed.spec.networks = [
        NetworkAttachmentConfig(target=net_shared.id),
        NetworkAttachmentConfig(target=net_own.id)]
    doomed.pending_delete = True
    survivor = make_replicated("survivor", 1)
    survivor.spec.networks = [NetworkAttachmentConfig(
        target=net_shared.id)]
    tasks = [Task(id=new_id(), service_id=doomed.id, slot=i,
                  status=TaskStatus(state=TaskState.RUNNING),
                  desired_state=TaskState.RUNNING) for i in (1, 2)]

    def setup(tx):
        tx.create(net_shared)
        tx.create(net_own)
        tx.create(doomed)
        tx.create(survivor)
        for t in tasks:
            tx.create(t)

    store.update(setup)
    d = Deallocator(store)
    d.start()
    try:
        time.sleep(0.3)
        assert store.view(lambda tx: tx.get(Service, doomed.id)) \
            is not None, "service with live tasks must not be deleted"

        store.update(lambda tx: tx.delete(Task, tasks[0].id))
        time.sleep(0.2)
        assert store.view(lambda tx: tx.get(Service, doomed.id)) \
            is not None, "one task still remains"

        store.update(lambda tx: tx.delete(Task, tasks[1].id))
        poll(lambda: store.view(
            lambda tx: tx.get(Service, doomed.id)) is None,
            msg="drained pending-delete service removed")
        poll(lambda: store.view(
            lambda tx: tx.get(Network, net_own.id)) is None,
            msg="its exclusive pending-delete network freed")
        assert store.view(lambda tx: tx.get(Network, net_shared.id)) \
            is not None, "network still used by survivor must stay"

        # the survivor releases the shared network: now it frees too
        cur = store.view(lambda tx: tx.get(Service, survivor.id)).copy()
        cur.spec.networks = []
        store.update(lambda tx: tx.update(cur))
        # re-nudge via a network update event (reference: the event path)
        netcur = store.view(
            lambda tx: tx.get(Network, net_shared.id)).copy()
        store.update(lambda tx: tx.update(netcur))
        poll(lambda: store.view(
            lambda tx: tx.get(Network, net_shared.id)) is None,
            msg="unreferenced pending-delete network freed on event")
    finally:
        d.stop()


def test_deallocator_removes_already_drained_service_at_startup():
    from swarmkit_tpu_torch.manager.deallocator import Deallocator

    store = MemoryStore()
    gone = make_replicated("gone", 1)
    gone.pending_delete = True
    store.update(lambda tx: tx.create(gone))
    d = Deallocator(store)
    d.start()
    try:
        poll(lambda: store.view(
            lambda tx: tx.get(Service, gone.id)) is None,
            msg="drained service reaped by the initial scan")
    finally:
        d.stop()


# ----------------------------------------- tests/test_controlapi.py's case

@requires_crypto
def test_rotate_join_token_via_api():
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.state.store import ByName

    m = Manager(use_device_scheduler=False)
    m.run()
    try:
        cluster = m.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        old = cluster.root_ca.join_tokens.worker
        new = m.control_api.rotate_join_token(NodeRole.WORKER)
        assert new != old
        assert m.root_ca.join_token(NodeRole.WORKER) == new
        cluster = m.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        assert cluster.root_ca.join_tokens.worker == new
        with pytest.raises(Exception):
            m.root_ca.role_for_token(old)
    finally:
        m.stop()


# ------------------------------------------------- the device, and the e2e

@requires_crypto
def test_manager_without_a_card_raises_in_the_callers_thread():
    """``Manager()`` means the card; with none it raises here, and no
    thread of a manager is left behind.  ``device="cpu"`` runs the
    leader's scheduler on ``TorchPlanner`` over the plain versions."""
    import threading
    before = set(threading.enumerate())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Manager()
        assert set(threading.enumerate()) == before
    m = Manager(device="cpu", dispatcher_config=fast_cfg())
    m.run()
    try:
        planner = m.scheduler.batch_planner
        assert type(planner).__name__ == "TorchPlanner"
        assert planner.device.type == "cpu"
        assert m.dispatcher is not None and m.allocator is not None
    finally:
        m.stop()
    assert m.scheduler is None and m.dispatcher is None


def reference_e2e_counts():
    """The reference's ``Manager`` (host path) at the same shape: replicas
    per agent hostname once every replica is RUNNING."""
    from swarmkit_tpu.agent import Agent
    from swarmkit_tpu.agent.testutils import TestExecutor
    from swarmkit_tpu.manager import Manager as RefManager
    from swarmkit_tpu.manager.dispatcher import Config_ as RefConfig
    from swarmkit_tpu.models import (
        Annotations as A, Node, NodeDescription, NodeSpec, NodeState,
        NodeStatus, ReplicatedService, Resources, ServiceMode, ServiceSpec,
        TaskSpec,
    )
    from swarmkit_tpu.models import TaskState as S
    from swarmkit_tpu.models.specs import ContainerSpec
    from swarmkit_tpu.utils import new_id as ref_id

    mgr = RefManager(dispatcher_config=RefConfig(**workload.E2E_DISPATCHER),
                     use_device_scheduler=False)
    mgr.run()
    agents = []
    try:
        host = {}
        for i in range(E2E_AGENTS):
            node = Node(id=ref_id(), spec=NodeSpec(annotations=A(
                name=f"bench-w{i}")),
                status=NodeStatus(state=NodeState.READY),
                description=NodeDescription(
                    hostname=f"bench-w{i}",
                    resources=Resources(nano_cpus=64 * 10**9,
                                        memory_bytes=256 << 30)))
            mgr.store.update(lambda tx, node=node: tx.create(node))
            host[node.id] = f"bench-w{i}"
            agents.append(Agent(node.id, TestExecutor(
                hostname=f"bench-w{i}"), mgr.dispatcher))
            agents[-1].start()
        svc = mgr.control_api.create_service(ServiceSpec(
            annotations=A(name="e2e-bench"),
            task=TaskSpec(container=ContainerSpec(image="bench")),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=E2E_REPLICAS)))

        def running():
            done = [t for t in mgr.control_api.list_tasks(
                        service_id=svc.id)
                    if t.status.state == S.RUNNING
                    and t.desired_state == S.RUNNING]
            return done if len(done) >= E2E_REPLICAS else None

        done = poll(running, timeout=60, msg="reference e2e converges")
        counts = {}
        for t in done:
            counts[host[t.node_id]] = counts.get(host[t.node_id], 0) + 1
        return dict(sorted(counts.items()))
    finally:
        for a in agents:
            a.stop()
        mgr.stop()


@requires_crypto
@pytest.mark.parametrize("raft", [False, True], ids=["standalone", "raft"])
def test_e2e_matches_reference_manager(tmp_path, raft):
    run = workload.e2e(n_agents=E2E_AGENTS, n_replicas=E2E_REPLICAS,
                       device="cpu",
                       raft_root=str(tmp_path / "raft") if raft else None)
    assert run["planner"] == "TorchPlanner"
    assert run["planner_device"] == "cpu"
    assert sum(run["per_host"].values()) == E2E_REPLICAS
    assert run["per_host"] == reference_e2e_counts()
    assert set(run["per_host"].values()) == {E2E_REPLICAS // E2E_AGENTS}
    assert 0 <= run["p50_s"] <= run["p90_s"] <= run["p99_s"] \
        <= run["max_s"] < workload.E2E_TIMEOUT
    assert run["journey_summary"]["complete"] == E2E_REPLICAS
    if raft:
        assert run["raft_entries_applied"] > 0 and run["wal_bytes"] > 0


@requires_crypto
def test_e2e_heal_after_an_agent_stops():
    """Flow 4's heal on the port: one agent stopped, its node DOWN after
    its heartbeat expires, every replica RUNNING on the others."""
    run = workload.e2e(n_agents=E2E_AGENTS, n_replicas=E2E_REPLICAS,
                       device="cpu", heal=True)
    heal = run["heal"]
    assert heal["nodes"] == E2E_AGENTS - 1
    assert 0 < heal["down_s"] <= heal["running_s"] < workload.E2E_TIMEOUT
