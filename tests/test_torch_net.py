"""The port's ``net/`` on the CPU: ``tests/test_net.py``'s cases on the
port (remote agents and the remote control surface over TCP, raft over
the TCP transport, the raft-join RPC, logs over the wire), each daemon's
manager on the host path (``use_device_scheduler=False``), as the
reference's own cases run; and the wire frames of both packages' ``net.wire``
byte for byte on seeded objects.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import importlib
import os
import socket

import numpy as np
import pytest

from swarmkit_tpu_torch.agent import Agent
from swarmkit_tpu_torch.agent.testutils import TestExecutor
from swarmkit_tpu_torch.manager import Manager
from swarmkit_tpu_torch.manager.dispatcher import Config_
from swarmkit_tpu_torch.models import (
    Annotations, Cluster, ReplicatedService, TaskState,
)
from swarmkit_tpu_torch.models.types import NodeRole
from swarmkit_tpu_torch.net import (
    ManagerServer, RemoteControlClient, RemoteDispatcherClient,
    TCPRaftTransport, issue_certificate,
)
from swarmkit_tpu_torch.net import wire
from swarmkit_tpu_torch.state import MemoryStore, serde
from swarmkit_tpu_torch.state.store import ByName
from swarmkit_tpu_torch.utils import new_id
from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY

from swarmkit_tpu.net import wire as ref_wire
from swarmkit_tpu.state import serde as ref_serde

from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)

requires_crypto = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY,
    reason="requires the 'cryptography' package")


def fast_cfg():
    return Config_(heartbeat_period=0.3, heartbeat_epsilon=0.02,
                   process_updates_interval=0.02,
                   assignment_batching_wait=0.02)


@requires_crypto
def test_remote_agent_and_control_over_tcp():
    """Full E2E over real sockets: join via token -> cert; agent sessions,
    heartbeats, assignment stream, status writeback; control client drives
    service lifecycle."""
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    server = ManagerServer(manager)
    server.start()
    agent = None
    try:
        cluster = manager.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        token = cluster.root_ca.join_tokens.worker

        # join over the network: token -> certificate
        node_id = new_id()
        cert = issue_certificate(server.addr, node_id, token)
        assert cert.node_id == node_id
        assert NodeRole(cert.role) == NodeRole.WORKER

        # bad token rejected
        with pytest.raises(Exception):
            issue_certificate(server.addr, new_id(), "SWMTKN-1-bad-bad")

        client = RemoteDispatcherClient(server.addr, cert)
        agent = Agent(node_id, TestExecutor(hostname="remote1"), client)
        agent.start()

        poll(lambda: manager.store.view(
            lambda tx: tx.get(
                __import__("swarmkit_tpu_torch.models",
                           fromlist=["Node"]).Node, node_id)) is not None,
            msg="remote node should self-register")

        # the control surface is manager-role gated: a worker cert is
        # rejected, an operator needs a manager-token-issued cert
        with pytest.raises(PermissionError):
            RemoteControlClient(server.addr, cert).list_nodes()
        op_cert = issue_certificate(server.addr, new_id(),
                                    cluster.root_ca.join_tokens.manager)
        control = RemoteControlClient(server.addr, op_cert)
        svc = control.create_service(make_replicated("web", 3).spec)

        def running():
            tasks = control.list_tasks(service_id=svc.id)
            live = [t for t in tasks
                    if t.desired_state == TaskState.RUNNING]
            return (len(live) == 3
                    and all(t.status.state == TaskState.RUNNING
                            and t.node_id == node_id for t in live))
        poll(running, timeout=30,
             msg="remote agent should run all replicas via TCP")

        # scale down over the network
        cur = control.get_service(svc.id)
        spec = cur.spec.copy()
        spec.replicated = ReplicatedService(replicas=1)
        control.update_service(svc.id, cur.meta.version.index, spec)
        poll(lambda: len([t for t in control.list_tasks(service_id=svc.id)
                          if t.desired_state == TaskState.RUNNING]) == 1,
             timeout=30)
        control.close()
    finally:
        if agent is not None:
            agent.stop()
        server.stop()
        manager.stop()


@requires_crypto
def test_unauthenticated_connection_rejected():
    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    server = ManagerServer(manager)
    server.start()
    try:
        from swarmkit_tpu_torch.security import RootCA
        foreign = RootCA().issue("evil", NodeRole.WORKER)
        with pytest.raises(PermissionError):
            RemoteControlClient(server.addr, foreign).list_nodes()
    finally:
        server.stop()
        manager.stop()


def test_raft_over_tcp(tmp_path):
    """3-member consensus over real TCP links."""
    from swarmkit_tpu_torch.models import Node, NodeSpec
    from swarmkit_tpu_torch.state.raft import RaftLogger, RaftNode

    ids = ["m0", "m1", "m2"]
    transports = {i: TCPRaftTransport(i) for i in ids}
    for i in ids:
        for j in ids:
            if i != j:
                transports[i].set_peer(j, transports[j].addr)
    members = {}
    for i in ids:
        store = MemoryStore()
        rn = RaftNode(i, ids, store,
                      RaftLogger(os.path.join(tmp_path, i)),
                      transports[i])
        store._proposer = rn
        members[i] = rn
        rn.start()
    try:
        # leader_ready: proposals before the election no-op applies are
        # dropped by design; wait for a proposal-ready leader
        leader = poll(
            lambda: next((m for m in members.values()
                          if m.is_leader and m.core.leader_ready), None)
            if sum(1 for m in members.values() if m.is_leader) == 1
            else None,
            timeout=20, msg="leader over TCP")
        for name in ("a", "b"):
            leader.store.update(lambda tx, name=name: tx.create(Node(
                id=new_id(),
                spec=NodeSpec(annotations=Annotations(name=name)))))

        def converged():
            for m in members.values():
                names = {n.spec.annotations.name
                         for n in m.store.view(lambda tx: tx.find(Node))}
                if names != {"a", "b"}:
                    return False
            return True
        poll(converged, timeout=20,
             msg="stores should converge over TCP links")
    finally:
        for m in members.values():
            m.stop()


@requires_crypto
def test_manager_raft_join_rpc(tmp_path):
    """A promoted node's manager joins the raft group over the network:
    manager-cert gated, returns peer addresses, membership grows."""
    import os

    from swarmkit_tpu_torch.models.types import NodeRole
    from swarmkit_tpu_torch.net import join_raft
    from swarmkit_tpu_torch.state.raft import (
        LocalNetwork, RaftLogger, RaftNode,
    )

    net = LocalNetwork()
    store = MemoryStore()
    rn = RaftNode("m0", ["m0"], store,
                  RaftLogger(os.path.join(tmp_path, "m0")), net)
    store._proposer = rn
    rn.start()
    poll(lambda: rn.is_leader, timeout=10)

    manager = Manager(store=store, raft_node=rn,
                      dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.raft_peer_addrs["m0"] = ("127.0.0.1", 12345)
    manager.run()
    server = ManagerServer(manager)
    server.start()
    try:
        poll(lambda: manager.is_leader, timeout=10)
        worker_cert = manager.root_ca.issue("joiner", NodeRole.WORKER)
        with pytest.raises(Exception):
            join_raft(server.addr, worker_cert, "joiner")

        mgr_cert = manager.root_ca.issue("m1", NodeRole.MANAGER)
        # the join wedges quorum until the member starts, so start it
        # right after the RPC
        import threading

        def start_member():
            store2 = MemoryStore()
            rn2 = RaftNode("m1", ["m0", "m1"], store2,
                           RaftLogger(os.path.join(tmp_path, "m1")), net)
            store2._proposer = rn2
            rn2.start()
            return rn2

        result = join_raft(server.addr, mgr_cert, "m1",
                           raft_addr=("127.0.0.1", 23456))
        assert "m0" in result["members"]
        assert "m1" in rn.core.peers
        rn2 = start_member()
        try:
            poll(lambda: rn2.core.commit_index > 0, timeout=15,
                 msg="joined manager should replicate")
        finally:
            rn2.stop()
    finally:
        server.stop()
        manager.stop()
        rn.stop()


@requires_crypto
def test_collect_logs_over_tcp():
    """service logs work through the remote control client too."""
    import tempfile as _tf

    from swarmkit_tpu_torch.agent import Agent, ProcessExecutor

    manager = Manager(dispatcher_config=fast_cfg(),
                      use_device_scheduler=False)
    manager.run()
    server = ManagerServer(manager)
    server.start()
    agent = None
    try:
        cluster = manager.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0]
        node_id = new_id()
        cert = issue_certificate(server.addr, node_id,
                                 cluster.root_ca.join_tokens.worker)
        client = RemoteDispatcherClient(server.addr, cert)
        agent = Agent(node_id, ProcessExecutor(
            hostname="tcp-logger", log_dir=_tf.mkdtemp()), client)
        agent.log_ship_interval = 0.1
        agent.start()

        op_cert = issue_certificate(server.addr, new_id(),
                                    cluster.root_ca.join_tokens.manager)
        control = RemoteControlClient(server.addr, op_cert)
        from swarmkit_tpu_torch.models import (
            Annotations, ContainerSpec, ReplicatedService,
            RestartCondition, RestartPolicy, ServiceMode, ServiceSpec,
            TaskSpec,
        )
        svc = control.create_service(ServiceSpec(
            annotations=Annotations(name="wire-logger"),
            task=TaskSpec(container=ContainerSpec(
                image="process",
                command=["sh", "-c",
                         "for i in 1 2 3; do echo wire-$i; "
                         "sleep 0.4; done"]),
                restart=RestartPolicy(
                    condition=RestartCondition.NONE)),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=1)))
        poll(lambda: [t for t in control.list_tasks(service_id=svc.id)
                      if t.status.state >= TaskState.RUNNING] or None,
             timeout=20)
        msgs = control.collect_logs(svc.id, duration=4.0)
        data = b"".join(m["data"] for m in msgs)
        # live-only stream: lines published before the subscription are
        # not replayed, so any tick from the overlap window suffices
        assert b"wire-" in data, data
        control.close()
    finally:
        if agent is not None:
            agent.stop()
        server.stop()
        manager.stop()


# -------------------------------------------------- the wire, both ways

def seeded_object(rng, depth=0):
    """A JSON value drawn from ``rng``: nested dicts and lists of ints,
    floats, strings (non-ASCII among them), booleans and nulls."""
    kind = int(rng.integers(0, 8 if depth < 3 else 5))
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 2:
        alphabet = "abcxyz019 _-/:é✓\"\n"
        return "".join(rng.choice(list(alphabet),
                                  size=int(rng.integers(0, 24))))
    if kind == 3:
        return bool(rng.integers(0, 2))
    if kind == 4:
        return None
    if kind in (5, 6):
        return {f"k{int(rng.integers(0, 1000))}": seeded_object(rng, depth + 1)
                for _ in range(int(rng.integers(0, 6)))}
    return [seeded_object(rng, depth + 1)
            for _ in range(int(rng.integers(0, 6)))]


def frame_bytes(mod, obj):
    """The bytes ``mod.send_frame`` puts on a socket for ``obj``."""
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def store_frames(seed):
    """Request, response and push frames carrying the same seeded tasks
    and services, serialized by each package's own ``serde``."""
    out = {}
    for name, mod, ser in (
            ("port", importlib.import_module("swarmkit_tpu_torch.models"),
             serde),
            ("ref", importlib.import_module("swarmkit_tpu.models"),
             ref_serde)):
        rng = np.random.default_rng(seed)
        objs = []
        for i in range(8):
            spec = mod.ServiceSpec(
                annotations=mod.Annotations(
                    name=f"svc{i}", labels={"k": str(rng.integers(9))}),
                task=mod.TaskSpec(container=mod.ContainerSpec(
                    image=f"img:{int(rng.integers(100))}",
                    env=[f"E={rng.integers(1000)}"])),
                mode=mod.ServiceMode.REPLICATED,
                replicated=mod.ReplicatedService(
                    replicas=int(rng.integers(1, 50))))
            objs.append(mod.Service(id=f"s{i}", spec=spec))
            objs.append(mod.Task(
                id=f"t{i}", service_id=f"s{i}", slot=i + 1,
                node_id=f"n{int(rng.integers(4))}", spec=spec.task,
                desired_state=mod.TaskState.RUNNING,
                status=mod.TaskStatus(
                    state=mod.TaskState.RUNNING,
                    timestamp=float(rng.integers(1, 2**31)))))
        data = [ser.to_dict(o) for o in objs]
        out[name] = [
            {"id": 1, "method": "list_tasks", "params": {"service_id": "s1"}},
            {"id": 1, "result": data},
            {"push": "assignments", "changes": data[:4]},
            {"id": 2, "error": "not the raft leader", "code": "not_leader"}]
    return out["port"], out["ref"]


@pytest.mark.parametrize("seed", range(6))
def test_wire_frames_match_reference(seed):
    """Both packages' ``send_frame`` put the same bytes on the socket for
    the same seeded objects, and each ``recv_frame`` reads the other's
    frames back to the object that was sent."""
    rng = np.random.default_rng(seed)
    objs = [seeded_object(rng) for _ in range(20)]
    port_frames, ref_frames = store_frames(seed)
    assert port_frames == ref_frames
    for obj in objs + port_frames:
        data = frame_bytes(wire, obj)
        assert data == frame_bytes(ref_wire, obj)
        for sender, receiver in ((wire, ref_wire), (ref_wire, wire)):
            a, b = socket.socketpair()
            try:
                sender.send_frame(a, obj)
                assert receiver.recv_frame(b) == obj
            finally:
                a.close()
                b.close()


def test_wire_refuses_oversized_frames_like_reference():
    """A header past ``MAX_FRAME`` is refused by both receivers, and a
    peer that closes mid-frame surfaces as ``ConnectionError`` in both."""
    assert wire.MAX_FRAME == ref_wire.MAX_FRAME
    for mod in (wire, ref_wire):
        a, b = socket.socketpair()
        try:
            a.sendall((mod.MAX_FRAME + 1).to_bytes(4, "big"))
            with pytest.raises(mod.WireError):
                mod.recv_frame(b)
        finally:
            a.close()
            b.close()
        a, b = socket.socketpair()
        try:
            a.sendall((10).to_bytes(4, "big") + b"{}")
            a.close()
            with pytest.raises(ConnectionError):
                mod.recv_frame(b)
        finally:
            b.close()

