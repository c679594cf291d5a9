"""The two slow failover cases of ``tests/test_remotes_swarmd.py`` on the
port: agents follow the new leader after the one they joined through
dies, and a worker restarted with no join flags finds the surviving
managers through its persisted remotes.  Every daemon gets
``device="cpu"``.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile
import time

import pytest

from swarmkit_tpu_torch.models import TaskState
from swarmkit_tpu_torch.swarmd import Swarmd
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def create_service_after_failover(daemons, spec, timeout=30):
    """Create a service on whichever daemon currently leads, retrying
    through post-failover churn.  Transient NotLeader / ProposalDropped
    here is expected behavior — the reference's clients retry RPCs around
    leadership changes — and AlreadyExists means an earlier "dropped"
    proposal actually committed."""
    from swarmkit_tpu_torch.manager.controlapi import AlreadyExists

    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        leader = next(
            (d for d in daemons
             if d.raft_node is not None and d.raft_node.is_leader
             and d.manager is not None
             and d.manager.dispatcher is not None), None)
        if leader is not None:
            api = leader.manager.control_api
            try:
                return api.create_service(spec)
            except AlreadyExists:
                name = spec.annotations.name
                for s in api.list_services():
                    if s.spec.annotations.name == name:
                        return s
            except Exception as e:
                last = e
        time.sleep(0.3)
    raise AssertionError(f"create_service never succeeded: {last!r}")


@requires_crypto
@retried
def test_worker_restart_survives_join_manager_death(tmp_path):
    """Learned managers persist across worker restarts (reference:
    node/node.go:1202 persistentRemotes + state.json): a worker that
    joined via m0 restarts with NO --join-addr after m0 died and finds
    the surviving managers from its persisted remotes."""
    import os

    from swarmkit_tpu_torch.models.types import NodeRole, NodeState

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    wtoken = m0.manager.root_ca.join_token(NodeRole.WORKER)
    joiners, worker = [], None
    wdir = str(tmp_path / "worker")
    try:
        for h in ("m1", "m2"):
            d = Swarmd(state_dir=tempfile.mkdtemp(), hostname=h,
                       manager=True, join_addr=m0.server.addr,
                       join_token=token,
                       listen_remote_api=("127.0.0.1", 0),
                       use_device_scheduler=False, device="cpu")
            d.start()
            joiners.append(d)

        worker = Swarmd(state_dir=wdir, hostname="w0",
                        join_addr=m0.server.addr, join_token=wtoken,
                        device="cpu")
        worker.start()
        # heartbeats piggyback the manager list; the persistent remotes
        # must learn all three managers before m0 goes away
        poll(lambda: len(worker.remotes.weights()) >= 3, timeout=20,
             msg="worker should learn every manager from heartbeats")
        assert os.path.exists(os.path.join(wdir, "state.json"))
        worker.stop()

        m0.stop()
        new_leader = poll(
            lambda: next((d for d in joiners
                          if d.raft_node.is_leader
                          and d.manager is not None
                          and d.manager.dispatcher is not None), None),
            timeout=30, msg="survivors elect a leader")

        # restart WITHOUT join flags: persisted identity + remotes only
        worker = Swarmd(state_dir=wdir, hostname="w0", device="cpu")
        worker.start()

        def ready():
            api = new_leader.manager.control_api
            return any(
                n.status.state == NodeState.READY
                and (n.spec.annotations.name == "w0"
                     or (n.description
                         and n.description.hostname == "w0"))
                for n in api.list_nodes())
        poll(ready, timeout=30,
             msg="restarted worker should re-register via survivors")
    finally:
        if worker is not None:
            worker.stop()
        for d in joiners:
            d.stop()
        m0.stop()


@requires_crypto
@retried
def test_swarmd_agents_follow_leader_after_death():
    """Agents learn the full manager list from heartbeat responses, so
    when the manager they joined through dies they fail over to the new
    leader and their tasks keep running."""
    from swarmkit_tpu_torch.models.types import NodeRole

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    joiners = []
    for h in ("m1", "m2"):
        d = Swarmd(state_dir=tempfile.mkdtemp(), hostname=h,
                   manager=True, join_addr=m0.server.addr,
                   join_token=token, listen_remote_api=("127.0.0.1", 0),
                   use_device_scheduler=False, device="cpu")
        d.start()
        joiners.append(d)
    m1, m2 = joiners
    worker = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
                    join_addr=m0.server.addr,
                    join_token=m0.manager.root_ca.join_token(0), device="cpu")
    worker.start()
    try:
        # the worker's tracker must learn the other managers' API
        # addresses via heartbeats
        poll(lambda: len(worker.remotes.weights()) >= 3, timeout=20,
             msg="worker should learn all managers from heartbeats")

        m0.stop()   # 2-of-3 quorum survives
        new = poll(lambda: next(
            (d for d in joiners
             if d.raft_node.is_leader and d.manager.is_leader), None),
            timeout=30, msg="a surviving manager takes leadership")
        # the worker re-sessions against the new leader and turns READY
        from swarmkit_tpu_torch.models.types import NodeState
        api = new.manager.control_api

        def worker_ready():
            nodes = [n for n in api.list_nodes()
                     if n.description
                     and n.description.hostname == "w0"]
            return nodes and nodes[0].status.state == NodeState.READY
        poll(worker_ready, timeout=30,
             msg="worker should fail over to the new leader")

        svc = create_service_after_failover(
            joiners, make_replicated("after-failover", 2).spec)
        # a replica may first land on the dead m0's agent node; it heals
        # once the heartbeat TTL marks that node DOWN (default 5s period
        # x grace), hence the generous timeout
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING
                          and t.desired_state == TaskState.RUNNING]) == 2,
             timeout=90, msg="new leader schedules onto failed-over agents")
    finally:
        worker.stop()
        m1.stop()
        m2.stop()
        m0.stop()
