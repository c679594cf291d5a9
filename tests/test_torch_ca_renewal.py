"""``tests/test_ca_rotation.py``'s quorum-loss recovery and certificate
expiry cases on the port's daemons.  Every daemon gets
``device="cpu"``.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile
import time

import pytest

pytest.importorskip(
    "cryptography", reason="CA/TLS tests require the cryptography package")

from swarmkit_tpu_torch.models import Cluster, TaskState
from swarmkit_tpu_torch.models.types import NodeRole
from swarmkit_tpu_torch.state.store import ByName
from swarmkit_tpu_torch.swarmd import Swarmd

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)


@retried
def test_force_new_cluster_recovers_from_quorum_loss():
    """Kill 2 of 3 managers; the survivor cannot lead.  Restart it with
    force_new_cluster: single-member raft from its WAL, cluster state
    intact, and new managers can join again (reference:
    manager.go:99-101 --force-new-cluster)."""
    from swarmkit_tpu_torch.models import ReplicatedService

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    mtoken = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    joiners = []
    for h in ("m1", "m2"):
        d = Swarmd(state_dir=tempfile.mkdtemp(), hostname=h,
                   manager=True, join_addr=m0.server.addr,
                   join_token=mtoken, listen_remote_api=("127.0.0.1", 0),
                   use_device_scheduler=False, device="cpu")
        d.start()
        joiners.append(d)
    m1, m2 = joiners
    svc = m0.manager.control_api.create_service(
        make_replicated("critical", 2).spec)
    poll(lambda: len(m0.manager.control_api.list_tasks(
        service_id=svc.id)) >= 2, timeout=30)
    # replicate to m2 before the others die
    poll(lambda: m2.manager.store.view(
        lambda tx: tx.get(type(svc), svc.id)) is not None, timeout=20,
        msg="service should replicate to m2")

    survivor_dir = m2.state_dir
    m0.stop()
    m1.stop()
    time.sleep(1.0)
    m2.stop()

    # recovery: single-member rebuild from the survivor's state dir
    rec = Swarmd(state_dir=survivor_dir, hostname="m2", manager=True,
                 listen_remote_api=("127.0.0.1", 0),
                 use_device_scheduler=False, force_new_cluster=True,
                 device="cpu")
    rec.start()
    assert rec.raft_node.core.peers == {"m-m2"}
    poll(lambda: rec.manager.is_leader
         and rec.manager.dispatcher is not None, timeout=30,
         msg="recovered manager should lead alone")
    got = rec.manager.control_api.get_service(svc.id)
    assert got.spec.annotations.name == "critical"

    # the rebuilt cluster accepts new managers and workers again
    token2 = rec.manager.root_ca.join_token(NodeRole.MANAGER)
    m3 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m3",
                manager=True, join_addr=rec.server.addr,
                join_token=token2, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m3.start()
    poll(lambda: "m-m3" in rec.raft_node.core.peers, timeout=30,
         msg="a fresh manager should join the rebuilt group")
    w = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
               join_addr=rec.server.addr,
               join_token=rec.manager.root_ca.join_token(NodeRole.WORKER),
               device="cpu")
    w.start()
    from swarmkit_tpu_torch.models.types import NodeState
    def worker_ready():
        nodes = [n for n in rec.manager.control_api.list_nodes()
                 if n.description and n.description.hostname == "w0"]
        return nodes and nodes[0].status.state == NodeState.READY
    poll(worker_ready, timeout=30, msg="worker joins the rebuilt cluster")
    w.stop()
    m3.stop()
    rec.stop()


@retried
def test_node_cert_expiry_renewal_under_daemon():
    """Short-lived node certs renew automatically at half-life and the
    node stays READY past its original expiry (reference: ca/renewer.go
    renewal loop + CAConfig.NodeCertExpiry driving validity)."""
    from swarmkit_tpu_torch.models.types import NodeState

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    w = None
    try:
        api = m0.manager.control_api
        # operator shrinks cert validity via the cluster spec; the
        # leader's CA applies it live
        c = api.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0].copy()
        c.spec.ca_config.node_cert_expiry = 10.0
        api.store.update(lambda tx: tx.update(c))
        poll(lambda: m0.manager.root_ca.node_cert_expiry == 10.0,
             msg="CA picks up node_cert_expiry from the cluster spec")

        w = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
                   join_addr=m0.server.addr,
                   join_token=m0.manager.root_ca.join_token(0),
                   cert_renew_interval=0.5, device="cpu")
        w.start()
        first = w.node.certificate
        # issuance backdates not_valid_before 60s for clock skew, so
        # check the remaining validity rather than the full lifetime
        assert first.expires_at - time.time() < 15.0, \
            "short validity should apply to issuance"

        # the renewer must swap in a fresh cert at ~half-life
        poll(lambda: w.node.certificate.expires_at > first.expires_at,
             timeout=20, msg="cert renews before expiry")
        wid = w.node.node_id

        # past the ORIGINAL expiry the node is still a functioning member
        time.sleep(max(0.0, first.expires_at - time.time()) + 0.5)
        def ready():
            nodes = [n for n in api.list_nodes() if n.id == wid]
            return nodes and nodes[0].status.state == NodeState.READY
        poll(ready, timeout=15,
             msg="node stays READY past its first cert's expiry")
        svc = api.create_service(make_replicated("fresh-cert", 2).spec)
        poll(lambda: len([t for t in api.list_tasks(service_id=svc.id)
                          if t.status.state == TaskState.RUNNING]) == 2,
             timeout=30, msg="tasks still schedule after renewal")
    finally:
        if w is not None:
            w.stop()
        m0.stop()
