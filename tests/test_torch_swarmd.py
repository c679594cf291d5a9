"""The port's ``swarmd.py`` and ``remotes.py`` on the CPU:
``tests/test_remotes_swarmd.py``'s cases on the port (the remotes tracker,
the connection broker, the failover client, a manager daemon with a
remote worker, network keys reaching it, a live heartbeat reload, joined
managers forming a raft group and surviving the leader's death, a
bootstrap manager's restart, the clock and rng seams); the two slow
failover cases are in ``test_torch_swarmd_failover.py``.  Every daemon
gets ``device="cpu"``.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile
import time

import pytest

from swarmkit_tpu_torch.manager import Manager
from swarmkit_tpu_torch.manager.dispatcher import Config_
from swarmkit_tpu_torch.models import Cluster, TaskState
from swarmkit_tpu_torch.remotes import (
    ConnectionBroker, FailoverDispatcherClient, NoSuchRemote, Remotes,
)
from swarmkit_tpu_torch.state.store import ByName
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


@retried
def test_remotes_weighted_selection():
    r = Remotes(("a", 1), ("b", 2))
    # both selectable initially
    seen = {r.select() for _ in range(100)}
    assert seen == {("a", 1), ("b", 2)}

    # hammer failures on a: selection should strongly prefer b
    for _ in range(50):
        r.observe(("a", 1), -10)
    picks = [r.select() for _ in range(300)]
    b_share = picks.count(("b", 2)) / len(picks)
    assert b_share > 0.9, b_share

    # exclusion and exhaustion
    assert r.select(("a", 1)) == ("b", 2)
    r.remove(("b", 2))
    r.remove(("a", 1))
    with pytest.raises(NoSuchRemote):
        r.select()


@retried
def test_connection_broker_prefers_local():
    r = Remotes(("remote", 1))
    broker = ConnectionBroker(r, local_addr=("local", 9))
    assert broker.select() == ("local", 9)
    assert broker.select(prefer_local=False) == ("remote", 1)


@retried
def test_failover_client_switches_managers():
    calls = []

    class FakeClient:
        def __init__(self, addr, fail=False):
            self.addr = addr
            self.fail = fail

        def heartbeat(self, node_id, session_id):
            calls.append(self.addr)
            if self.fail:
                raise ConnectionError("down")
            return 1.0

        def close(self):
            pass

    r = Remotes(("m1", 1), ("m2", 2))
    # make m1 the overwhelming favorite so the first pick is deterministic
    for _ in range(30):
        r.observe(("m1", 1), 10)
        r.observe(("m2", 2), -10)
    broker = ConnectionBroker(r)
    clients = {("m1", 1): FakeClient(("m1", 1), fail=True),
               ("m2", 2): FakeClient(("m2", 2))}
    fc = FailoverDispatcherClient(broker, None,
                                  client_factory=lambda a: clients[a])

    # first call hits m1 (favorite), fails, down-weights it
    with pytest.raises(ConnectionError):
        fc.heartbeat("n", "s")
    # retries eventually land on m2 and succeed
    for _ in range(20):
        try:
            assert fc.heartbeat("n", "s") == 1.0
            break
        except ConnectionError:
            continue
    else:
        raise AssertionError("failover never reached m2")
    assert ("m2", 2) in calls


@requires_crypto
@retried
def test_swarmd_manager_and_remote_worker():
    """Full daemon wiring: a manager swarmd serving the remote API, a
    worker swarmd joining over TCP with the printed token."""
    mgr_daemon = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                        manager=True, listen_remote_api=("127.0.0.1", 0),
                        use_device_scheduler=False, device="cpu")
    mgr_daemon.start()
    worker = None
    try:
        token = mgr_daemon.manager.root_ca.join_token(0)
        worker = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
                        join_addr=mgr_daemon.server.addr,
                        join_token=token, device="cpu")
        worker.start()

        api = mgr_daemon.manager.control_api
        from swarmkit_tpu_torch.models.types import NodeState
        poll(lambda: [n.status.state for n in api.list_nodes()]
             == [NodeState.READY] * 2,
             msg="both swarmd nodes should register and turn READY")

        svc = api.create_service(make_replicated("web", 4).spec)
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING
                          and t.desired_state == TaskState.RUNNING]) == 4,
             timeout=30, msg="replicas should run across both daemons")
        nodes_used = {t.node_id for t in api.list_tasks(service_id=svc.id)}
        assert len(nodes_used) == 2, "both nodes should receive tasks"
    finally:
        if worker is not None:
            worker.stop()
        mgr_daemon.stop()


@requires_crypto
@retried
def test_network_bootstrap_keys_reach_remote_worker():
    """Key-manager rotations are delivered to agents over the wire and
    handed to the executor (reference: SessionMessage.NetworkBootstrapKeys;
    agent.go handleSessionMessage -> executor.SetNetworkBootstrapKeys)."""
    mgr_daemon = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                        manager=True, listen_remote_api=("127.0.0.1", 0),
                        use_device_scheduler=False, device="cpu")
    mgr_daemon.start()
    worker = None
    try:
        api = mgr_daemon.manager.control_api

        # fast heartbeats BEFORE the worker registers, so delivery is
        # prompt (the dispatcher reloads the period from the cluster spec)
        def fast(tx):
            c = tx.find(Cluster, ByName("default"))[0].copy()
            c.spec.dispatcher.heartbeat_period = 0.3
            tx.update(c)
        mgr_daemon.manager.store.update(fast)
        poll(lambda: mgr_daemon.manager.dispatcher.config.heartbeat_period
             == 0.3, msg="heartbeat period reload")

        token = mgr_daemon.manager.root_ca.join_token(0)
        worker = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
                        join_addr=mgr_daemon.server.addr,
                        join_token=token, device="cpu")
        worker.start()

        # the key manager populates keys at leader startup; the first
        # heartbeats deliver them
        poll(lambda: getattr(worker.executor, "network_keys", None),
             timeout=15, msg="initial network keys should reach the agent")
        keys = worker.executor.network_keys
        subsystems = {k.subsystem for k in keys}
        assert "networking:gossip" in subsystems
        assert all(k.key for k in keys)
        clock0 = max(k.lamport_time for k in keys)

        # a rotation bumps the lamport clock and re-delivers
        mgr_daemon.manager.keymanager.rotate_now()
        poll(lambda: max(k.lamport_time
                         for k in worker.executor.network_keys) > clock0,
             timeout=15, msg="rotated keys should reach the agent")
    finally:
        if worker is not None:
            worker.stop()
        mgr_daemon.stop()


@requires_crypto
@retried
def test_dispatcher_live_heartbeat_reload():
    mgr = Manager(dispatcher_config=Config_(heartbeat_period=5.0,
                                            process_updates_interval=0.02),
                  use_device_scheduler=False)
    mgr.run()
    try:
        assert mgr.dispatcher.config.heartbeat_period == 5.0

        def bump(tx):
            c = tx.find(Cluster, ByName("default"))[0].copy()
            c.spec.dispatcher.heartbeat_period = 1.5
            tx.update(c)
        mgr.store.update(bump)
        poll(lambda: mgr.dispatcher.config.heartbeat_period == 1.5,
             msg="heartbeat period should reload from cluster spec")
    finally:
        mgr.stop()


@requires_crypto
@retried
def test_swarmd_manager_join_forms_raft_group():
    """A second swarmd --manager with --join-addr + manager token joins the
    bootstrap manager's raft group and replicates its state."""
    from swarmkit_tpu_torch.models.types import NodeRole

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    m1 = None
    try:
        assert m0.raft_node is not None, "bootstrap manager is raft-backed"
        token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
        m1 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m1",
                    manager=True, join_addr=m0.server.addr,
                    join_token=token, use_device_scheduler=False, device="cpu")
        m1.start()

        assert "m-m1" in m0.raft_node.core.peers
        assert not m1.manager.is_leader    # follower of m0

        api = m0.manager.control_api
        poll(lambda: len(api.list_nodes()) == 2,
             msg="both manager-node agents should register")
        svc = api.create_service(make_replicated("ha", 2).spec)
        # replicated through raft into the joined manager's store
        from swarmkit_tpu_torch.models import Service
        poll(lambda: m1.manager.store.view(
            lambda tx: tx.get(Service, svc.id)) is not None,
             msg="service should replicate to the joined manager")
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING
                          and t.desired_state == TaskState.RUNNING]) == 2,
             timeout=30, msg="replicas run across both manager nodes")
    finally:
        if m1 is not None:
            m1.stop()
        m0.stop()


@requires_crypto
@retried
def test_swarmd_three_managers_survive_leader_death():
    """m1 and m2 both join via m0; their transport addresses replicate
    through conf entries, so when m0 dies the survivors can still dial
    each other and elect a new leader (2-of-3 quorum)."""
    from swarmkit_tpu_torch.models.types import NodeRole

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    joiners = []
    try:
        for h in ("m1", "m2"):
            d = Swarmd(state_dir=tempfile.mkdtemp(), hostname=h,
                       manager=True, join_addr=m0.server.addr,
                       join_token=token, use_device_scheduler=False,
                       device="cpu")
            d.start()
            joiners.append(d)
        m1, m2 = joiners
        # the address of m2 (joined later) must have replicated to m1
        poll(lambda: "m-m2" in m1.raft_node.core.peer_addrs,
             msg="later joiner's address replicates to earlier joiner")

        m0.stop()
        new_leader = poll(
            lambda: next((d for d in joiners if d.raft_node.is_leader),
                         None),
            timeout=30, msg="survivors should elect a leader without m0")
        poll(lambda: new_leader.manager.is_leader, timeout=20,
             msg="manager leadership follows raft")
        # the new leader can still commit (quorum = itself + the other
        # survivor)
        svc = create_service_after_failover(
            joiners, make_replicated("post-failover", 1).spec)
        assert svc.id
    finally:
        for d in joiners:
            d.stop()


@requires_crypto
@retried
def test_swarmd_bootstrap_manager_restart(tmp_path):
    """A raft-backed bootstrap manager restarted on the same state dir
    reuses its CA key and raft port and recovers its cluster state."""
    state_dir = str(tmp_path)
    m = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
               listen_remote_api=("127.0.0.1", 0),
               use_device_scheduler=False, device="cpu")
    m.start()
    api = m.manager.control_api
    svc = api.create_service(make_replicated("durable", 1).spec)
    key1 = m.manager.root_ca.key
    port1 = m.raft_transport.addr[1]
    m.stop()

    m2 = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m2.start()
    try:
        assert m2.manager.root_ca.key == key1, "CA key persists"
        assert m2.raft_transport.addr[1] == port1, "raft port persists"
        from swarmkit_tpu_torch.models import Service
        poll(lambda: m2.manager.store.view(
            lambda tx: tx.get(Service, svc.id)) is not None,
             msg="service survives the restart via the WAL")
    finally:
        m2.stop()


@retried
def test_swarmd_injected_clock_rng_seams(tmp_path):
    """Swarmd(clock=, rng=) (matching Agent(rng=)): deadlines read the
    injected clock, and a FROZEN clock still raises via the loop-count
    backstop instead of hanging the harness."""
    import random

    vt = [1000.0]
    sd = Swarmd(str(tmp_path), clock=lambda: vt[0],
                rng=random.Random(7), device="cpu")
    assert sd._clock() == 1000.0
    assert sd._rng.random() == random.Random(7).random()

    # advancing clock: deadline observed without real-time waiting
    def cond():
        vt[0] += 6.0
        return False
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        sd._wait(cond, "deadline", timeout=5.0)
    assert time.monotonic() - t0 < 2.0

    # frozen clock: the backstop bounds the loop
    frozen = Swarmd(str(tmp_path), clock=lambda: 100.0, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        frozen._wait(lambda: False, "frozen", timeout=0.05)
    assert time.monotonic() - t0 < 5.0

