"""``tests/test_ca_rotation.py``'s root rotation, autolock and health
cases on the port's daemons (its quorum-loss recovery and certificate
expiry cases are in ``test_torch_ca_renewal.py``).  Every daemon gets
``device="cpu"``.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile

import pytest

pytest.importorskip(
    "cryptography", reason="CA/TLS tests require the cryptography package")

from swarmkit_tpu_torch.models import Cluster, TaskState
from swarmkit_tpu_torch.models.types import NodeRole
from swarmkit_tpu_torch.net import RemoteControlClient, issue_certificate
from swarmkit_tpu_torch.security.ca import signing_root_digest
from swarmkit_tpu_torch.state.store import ByName
from swarmkit_tpu_torch.swarmd import ManagerLockedError, Swarmd

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    make_replicated, poll, singletons_left_as_found,
)


@retried
def test_rootca_rotation_unit():
    """Cross-sign + dual-trust issuance semantics on the RootCA itself."""
    from swarmkit_tpu_torch.security import RootCA

    ca = RootCA()
    old_digest = ca.digest
    pre_cert = ca.issue("old-node", NodeRole.WORKER)

    ca.begin_rotation()
    assert ca.active_digest != old_digest
    assert ca.digest == old_digest          # tokens stay on the old root

    # new issuance signs with the new key + ships the cross-signed chain
    mid_cert = ca.issue("mid-node", NodeRole.WORKER)
    assert signing_root_digest(mid_cert) == ca.active_digest
    assert len(ca.trust_bundle().split(b"-----BEGIN")) - 1 == 2
    # both old- and new-root certs verify during rotation
    ca.verify(pre_cert)
    ca.verify(mid_cert)
    assert ca.issuer_digest(pre_cert) == old_digest
    assert ca.issuer_digest(mid_cert) == ca.active_digest

    ca.finalize_rotation()
    assert ca.digest != old_digest
    ca.verify(mid_cert)
    with pytest.raises(Exception):
        ca.verify(pre_cert)   # old-root certs die with the old root


@retried
def test_ca_rotation_live_cluster_no_task_disruption():
    """Rotate the root on a live 2-manager + 1-worker cluster: nodes
    re-certify via their renewers, the reconciler finalizes, tokens
    re-derive from the new root, and running tasks never restart."""
    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, cert_renew_interval=0.3,
                device="cpu")
    m0.start()
    m0.manager.ca_rotation_check_interval = 0.3
    mtoken = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    m1 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m1",
                manager=True, join_addr=m0.server.addr, join_token=mtoken,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, cert_renew_interval=0.3,
                device="cpu")
    m1.start()
    w = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
               join_addr=m0.server.addr,
               join_token=m0.manager.root_ca.join_token(NodeRole.WORKER),
               cert_renew_interval=0.3, device="cpu")
    w.start()
    try:
        op = issue_certificate(m0.server.addr, "op", mtoken)
        ctl = RemoteControlClient(m0.server.addr, op)
        svc = ctl.create_service(make_replicated("web", 3).spec)

        def running_ids():
            ts = [t for t in ctl.list_tasks(service_id=svc.id)
                  if t.desired_state == TaskState.RUNNING
                  and t.status.state == TaskState.RUNNING]
            return sorted(t.id for t in ts) if len(ts) == 3 else None
        poll(running_ids, timeout=40, msg="3 replicas running")
        before = running_ids()

        old_digest = m0.manager.root_ca.digest
        new_digest = ctl.rotate_ca()
        assert new_digest != old_digest

        def finalized():
            cluster = m0.manager.store.view(
                lambda tx: tx.find(Cluster, ByName("default")))[0]
            return (not cluster.root_ca.root_rotation_in_progress
                    and m0.manager.root_ca.digest == new_digest)
        poll(finalized, timeout=60,
             msg="rotation should finalize once all nodes re-certify")

        # zero task disruption: identical task ids still RUNNING
        assert running_ids() == before

        # the worker's live identity now chains to the new root
        poll(lambda: signing_root_digest(w.node.certificate)
             == new_digest, timeout=20,
             msg="worker cert should chain to the new root")

        # tokens re-derive: a brand-new worker joins with the NEW token
        new_token = m0.manager.root_ca.join_token(NodeRole.WORKER)
        fresh = issue_certificate(m0.server.addr, "late-joiner",
                                  new_token)
        assert signing_root_digest(fresh) == new_digest
        # the API keeps serving under the rotated root
        assert len(ctl.list_nodes()) >= 3
        ctl.close()
    finally:
        w.stop()
        m1.stop()
        m0.stop()


@retried
def test_autolock_manager_refuses_until_unlocked():
    """Autolocked manager state: a restart cannot serve (or even read
    its CA material) until the operator supplies the unlock key."""
    state_dir = tempfile.mkdtemp()
    m0 = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    api = m0.manager.control_api
    from swarmkit_tpu_torch.cli import run_command
    out = run_command(["cluster", "autolock", "on"], api)
    key = out.rsplit(" ", 1)[-1]
    assert len(key) == 64
    assert run_command(["cluster", "unlock-key"], api) == key
    svc = api.create_service(make_replicated("locked-web", 1).spec)
    poll(lambda: [t for t in api.list_tasks(service_id=svc.id)
                  if t.status.state == TaskState.RUNNING], timeout=30)
    # the re-seal hook fires on the cluster update; give it a beat
    poll(lambda: open(m0._manager_state_path(), "rb").read()
         .startswith(b"LOCK1"), timeout=10,
         msg="state file should be sealed after autolock on")
    m0.stop()

    # restart without the key: locked, serving nothing
    m1 = Swarmd(state_dir=state_dir, hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m1.start()
    assert m1.locked
    assert m1.manager is None and m1.server is None

    # wrong key rejected
    with pytest.raises(ManagerLockedError):
        m1.unlock("00" * 32)
    assert m1.locked

    # right key: unseals, serves, state intact
    m1.unlock(key)
    assert not m1.locked
    poll(lambda: m1.manager is not None and m1.manager.is_leader,
         timeout=30, msg="unlocked manager should lead again")
    names = [s.spec.annotations.name
             for s in m1.manager.control_api.list_services()]
    assert "locked-web" in names
    m1.stop()


@retried
def test_health_api_and_metrics_endpoint():
    """Health RPC on the control surface + curl-able /metrics /healthz
    /debug/stacks (reference: manager/health/health.go, swarmd
    --listen-metrics main.go:92-97)."""
    import urllib.error
    import urllib.request

    from swarmkit_tpu_torch.cli import run_command

    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0",
                manager=True, listen_remote_api=("127.0.0.1", 0),
                listen_metrics=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    try:
        # in-process probe via CLI
        assert run_command(["cluster", "health"],
                           m0.manager.control_api) == "SERVING"
        assert run_command(["cluster", "health", "--service", "raft"],
                           m0.manager.control_api) == "SERVING"

        # remote probe over mTLS
        op = issue_certificate(
            m0.server.addr, "op",
            m0.manager.root_ca.join_token(NodeRole.MANAGER))
        ctl = RemoteControlClient(m0.server.addr, op)
        assert ctl.health() == "SERVING"
        assert ctl.health("raft") == "SERVING"
        assert ctl.health("bogus") == "UNKNOWN"
        ctl.close()

        # create some state so the collector gauges are non-trivial
        svc = m0.manager.control_api.create_service(
            make_replicated("obs", 2).spec)
        poll(lambda: len(m0.manager.control_api.list_tasks(
            service_id=svc.id)) == 2, timeout=20)

        base = "http://%s:%d" % m0.metrics_server.addr
        poll(lambda: b"swarm_manager_services 1" in urllib.request.urlopen(
            base + "/metrics", timeout=5).read(), timeout=15,
            msg="collector gauges should surface on /metrics")
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        assert "swarm_store_write_tx_latency_seconds_count" in body
        # per-RPC interceptor metrics: the remote health probes above
        # must have counted (reference: grpc-prometheus interceptors);
        # labeled counters must render valid exposition format
        # (name_total{labels} value)
        assert 'swarm_rpc_total{method="health"}' in body
        assert "swarm_rpc_latency_seconds_count" in body

        assert urllib.request.urlopen(
            base + "/healthz", timeout=5).read().strip() == b"SERVING"
        stacks = urllib.request.urlopen(
            base + "/debug/stacks", timeout=5).read().decode()
        assert "raft-m-m0" in stacks   # thread dump names live threads

        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
    finally:
        m0.stop()
