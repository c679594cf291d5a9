"""The daemon scenarios of ``tests/test_integration.py`` on the port:
promotion and demotion under the daemon (a downed manager included), a
promoted manager's restart, and the device scheduler inside a live
manager daemon, there on ``TorchPlanner(device="cpu")`` (a worker's
rejoin and the rolling manager restarts are in
``test_torch_daemon_restarts.py``).  Every daemon gets
``device="cpu"``: any worker may be promoted, and a promotion builds a
``Manager`` on the role watcher.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile
import time

import pytest

from swarmkit_tpu_torch.models import TaskState
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


# --------------------------------------------------------------------------
# Daemon-level black-box scenarios (reference: integration/
# integration_test.go:196 TestDemotePromote and friends)

def _manager_daemon(name, **kw):
    from swarmkit_tpu_torch.swarmd import Swarmd
    kw.setdefault("listen_remote_api", ("127.0.0.1", 0))
    kw.setdefault("use_device_scheduler", False)
    kw.setdefault("device", "cpu")
    return Swarmd(state_dir=kw.pop("state_dir", tempfile.mkdtemp()),
                  hostname=name, manager=True, **kw)


def _worker_daemon(name, join_addr, token, **kw):
    from swarmkit_tpu_torch.swarmd import Swarmd
    kw.setdefault("device", "cpu")
    return Swarmd(state_dir=kw.pop("state_dir", tempfile.mkdtemp()),
                  hostname=name, join_addr=join_addr, join_token=token,
                  **kw)


def _speed_up_heartbeats(api, period=0.5):
    """Shrink the dispatcher heartbeat period so role changes (which ride
    heartbeat responses) propagate quickly in tests."""
    from swarmkit_tpu_torch.models import Cluster
    from swarmkit_tpu_torch.state.store import ByName
    c = api.store.view(
        lambda tx: tx.find(Cluster, ByName("default")))[0].copy()
    c.spec.dispatcher.heartbeat_period = period
    api.store.update(lambda tx: tx.update(c))


def _set_role(api, node_id, role):
    """Role flip with read-modify-write retry: the agent's status and
    description writes race the version we read, and the control API
    rightly rejects stale versions (SequenceConflict semantics) — real
    clients re-read and retry, so these helpers do too."""
    from swarmkit_tpu_torch.manager.controlapi import FailedPrecondition
    last = None
    for _ in range(10):
        n = api.get_node(node_id)
        spec = n.spec.copy()
        spec.desired_role = role
        try:
            return api.update_node(n.id, n.meta.version.index, spec)
        except FailedPrecondition as e:
            if "stale version" not in str(e):
                raise
            last = e
            time.sleep(0.1)
    raise last


def _promote(api, node_id):
    from swarmkit_tpu_torch.models.types import NodeRole
    _set_role(api, node_id, NodeRole.MANAGER)


def _demote(api, node_id):
    from swarmkit_tpu_torch.models.types import NodeRole
    _set_role(api, node_id, NodeRole.WORKER)


@requires_crypto
@retried
def test_promote_worker_to_manager_under_daemon():
    """A running worker daemon promoted via the control API renews into a
    manager cert, joins raft, and serves as a manager — without restart
    (reference: integration_test.go:196 promote path)."""
    from swarmkit_tpu_torch.models.types import NodeRole, NodeState

    m0 = _manager_daemon("m0")
    m0.start()
    w = None
    try:
        api = m0.manager.control_api
        _speed_up_heartbeats(api)
        w = _worker_daemon("w0", m0.server.addr,
                           m0.manager.root_ca.join_token(0))
        w.start()
        wid = w.node.node_id
        poll(lambda: (api.get_node(wid).status.state == NodeState.READY
                      if _has_node(api, wid) else False),
             msg="worker registers READY")

        _promote(api, wid)
        poll(lambda: w.manager is not None and w.raft_node is not None,
             timeout=45, msg="promoted worker starts its manager")
        poll(lambda: wid in m0.raft_node.core.peers, timeout=20,
             msg="promoted node joins the raft group")
        assert NodeRole(w.node.certificate.role) == NodeRole.MANAGER
        assert api.get_node(wid).role == int(NodeRole.MANAGER)
        # the new manager replicates cluster state
        svc = api.create_service(make_replicated("promoted", 2).spec)
        from swarmkit_tpu_torch.models import Service
        poll(lambda: w.manager.store.view(
            lambda tx: tx.get(Service, svc.id)) is not None,
             timeout=20, msg="state replicates to the promoted manager")
    finally:
        if w is not None:
            w.stop()
        m0.stop()


def _has_node(api, node_id):
    try:
        api.get_node(node_id)
        return True
    except Exception:
        return False


@requires_crypto
@retried
def test_demote_manager_to_worker_under_daemon():
    """A joined manager demoted via the control API leaves raft, tears
    down its manager stack, and keeps serving as a worker (reference:
    integration_test.go demote path)."""
    from swarmkit_tpu_torch.models.types import NodeRole, NodeState

    m0 = _manager_daemon("m0")
    m0.start()
    m1 = None
    try:
        api = m0.manager.control_api
        _speed_up_heartbeats(api)
        token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
        m1 = _manager_daemon("m1", join_addr=m0.server.addr,
                             join_token=token)
        m1.start()
        assert "m-m1" in m0.raft_node.core.peers
        poll(lambda: _has_node(api, "m-m1")
             and api.get_node("m-m1").status.state == NodeState.READY,
             msg="joined manager's agent registers")

        _demote(api, "m-m1")
        poll(lambda: m1.manager is None and m1.raft_node is None,
             timeout=45, msg="demoted manager tears down its stack")
        assert m0.raft_node.core.peers == {"m-m0"}
        assert NodeRole(m1.node.certificate.role) == NodeRole.WORKER
        poll(lambda: api.get_node("m-m1").role == int(NodeRole.WORKER),
             msg="store role reconciled to worker")
        # still a live worker: schedulable
        svc = api.create_service(make_replicated("afterdemote", 4).spec)
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING]) == 4,
             timeout=30, msg="tasks run, incl. on the demoted node")
        assert {t.node_id for t in api.list_tasks(service_id=svc.id)} \
            == {"m-m0", "m-m1"}
    finally:
        if m1 is not None:
            m1.stop()
        m0.stop()


@requires_crypto
@retried
def test_demote_downed_manager_recovers_quorum():
    """Demoting a DEAD manager removes it from raft so the survivors'
    quorum shrinks (reference: integration_test.go:393 demote a downed
    node)."""
    from swarmkit_tpu_torch.models.types import NodeRole

    m0 = _manager_daemon("m0")
    m0.start()
    token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    joiners = []
    try:
        for h in ("m1", "m2"):
            d = _manager_daemon(h, join_addr=m0.server.addr,
                                join_token=token)
            d.start()
            joiners.append(d)
        api = m0.manager.control_api
        assert m0.raft_node.core.peers == {"m-m0", "m-m1", "m-m2"}
        poll(lambda: _has_node(api, "m-m2"),
             msg="m2's node record registers before we kill it")

        joiners[1].stop()    # kill m2; 2-of-3 quorum survives
        _demote(api, "m-m2")
        poll(lambda: m0.raft_node.core.peers == {"m-m0", "m-m1"},
             timeout=30, msg="dead manager removed from raft")
        poll(lambda: api.get_node("m-m2").role == int(NodeRole.WORKER),
             msg="dead manager's role reconciled")
        # the 2-member group still commits
        svc = api.create_service(make_replicated("post-demote", 1).spec)
        assert svc.id
    finally:
        for d in joiners:
            d.stop()
        m0.stop()


@requires_crypto
@retried
def test_promoted_manager_restart_comes_back_as_manager():
    """A runtime-promoted node restarted on its state dir boots straight
    into manager mode (persisted raft id + WAL), like the reference's
    restarted promoted node."""
    from swarmkit_tpu_torch.models.types import NodeRole, NodeState

    m0 = _manager_daemon("m0")
    m0.start()
    w = w2 = None
    try:
        api = m0.manager.control_api
        _speed_up_heartbeats(api)
        state_dir = tempfile.mkdtemp()
        w = _worker_daemon("w0", m0.server.addr,
                           m0.manager.root_ca.join_token(0),
                           state_dir=state_dir)
        w.start()
        wid = w.node.node_id
        poll(lambda: _has_node(api, wid), msg="worker registers")
        _promote(api, wid)
        poll(lambda: w.manager is not None, timeout=45,
             msg="worker promotes")
        w.stop()
        poll(lambda: any(d.raft_node.is_leader for d in (m0,)),
             timeout=30, msg="m0 leads after the promoted node stops")

        from swarmkit_tpu_torch.swarmd import Swarmd
        w2 = Swarmd(state_dir=state_dir, hostname="w0",
                    join_addr=m0.server.addr, join_token="",
                    use_device_scheduler=False, device="cpu")
        w2.start()
        poll(lambda: w2.manager is not None and w2.raft_node is not None,
             timeout=45, msg="restarted promoted node is a manager again")
        assert w2.raft_id == wid
        poll(lambda: wid in m0.raft_node.core.peers, timeout=20,
             msg="rejoined the raft group under its node id")
    finally:
        if w is not None:
            w.stop()
        if w2 is not None:
            w2.stop()
        m0.stop()


@requires_crypto
@retried
def test_device_scheduler_inside_live_manager():
    """The port's planner runs inside a live manager daemon end-to-end:
    service -> orchestrator -> device-planned placement -> dispatcher ->
    agent -> RUNNING (the other daemon tests pin the host path; this one
    proves the device path through the full stack)."""
    from swarmkit_tpu_torch.models.types import NodeState

    m0 = _manager_daemon("m0", use_device_scheduler=True)
    m0.start()
    workers = []
    try:
        api = m0.manager.control_api
        token = m0.manager.root_ca.join_token(0)
        for i in range(3):
            w = _worker_daemon(f"w{i}", m0.server.addr, token)
            w.start()
            workers.append(w)
        poll(lambda: len([n for n in api.list_nodes()
                          if n.status.state == NodeState.READY]) == 4,
             timeout=30, msg="all nodes READY")

        # large enough that the adaptive router sends it to the device
        planner = m0.manager.scheduler.batch_planner
        assert planner is not None, "device planner must be wired"
        planner.enable_small_group_routing = False

        svc = api.create_service(make_replicated("devplanned", 12).spec)
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING
                          and t.desired_state == TaskState.RUNNING]) == 12,
             timeout=45, msg="12 replicas RUNNING via the device path")
        assert planner.stats["tasks_planned"] >= 12, planner.stats
        # spread across all four agents (manager node + 3 workers)
        per_node = {}
        for t in api.list_tasks(service_id=svc.id):
            per_node[t.node_id] = per_node.get(t.node_id, 0) + 1
        assert sorted(per_node.values()) == [3, 3, 3, 3], per_node
    finally:
        for w in workers:
            w.stop()
        m0.stop()
