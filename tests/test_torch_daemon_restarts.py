"""Two daemon scenarios of ``tests/test_integration.py`` on the port: a
worker rejoining on its state dir with its persisted identity, and
rolling restarts of three managers.  Every daemon gets
``device="cpu"``: any worker may be promoted, and a promotion builds a
``Manager`` on the role watcher.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import tempfile
import time

import pytest

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


def _has_node(api, node_id):
    try:
        api.get_node(node_id)
        return True
    except Exception:
        return False


@requires_crypto
@retried
def test_worker_rejoin_same_state_dir():
    """A worker stopped and restarted on the same state dir rejoins with
    its persisted identity and turns READY again (reference:
    integration_test.go node rejoin)."""
    from swarmkit_tpu_torch.models.types import NodeState

    m0 = _manager_daemon("m0")
    m0.start()
    w2 = None
    try:
        api = m0.manager.control_api
        state_dir = tempfile.mkdtemp()
        token = m0.manager.root_ca.join_token(0)
        w = _worker_daemon("w0", m0.server.addr, token,
                           state_dir=state_dir)
        w.start()
        wid = w.node.node_id
        poll(lambda: _has_node(api, wid)
             and api.get_node(wid).status.state == NodeState.READY,
             msg="worker READY before restart")
        w.stop()
        poll(lambda: api.get_node(wid).status.state == NodeState.DOWN,
             timeout=45, msg="stopped worker marked DOWN")

        # rejoin with a bogus token: the persisted identity must carry it
        w2 = _worker_daemon("w0", m0.server.addr, "not-a-real-token",
                            state_dir=state_dir)
        w2.start()
        assert w2.node.node_id == wid, "identity persists across rejoin"
        poll(lambda: api.get_node(wid).status.state == NodeState.READY,
             timeout=30, msg="rejoined worker turns READY")
    finally:
        if w2 is not None:
            w2.stop()
        m0.stop()


@requires_crypto
@retried
def test_rolling_manager_restart_preserves_cluster():
    """Restart all three managers one at a time; state and membership
    survive throughout (reference: integration_test.go rolling manager
    restarts)."""
    from swarmkit_tpu_torch.models.types import NodeRole

    dirs = {"m0": tempfile.mkdtemp()}
    m0 = _manager_daemon("m0", state_dir=dirs["m0"])
    m0.start()
    token = m0.manager.root_ca.join_token(NodeRole.MANAGER)
    daemons = {"m0": m0}
    try:
        for h in ("m1", "m2"):
            d = _manager_daemon(h, join_addr=m0.server.addr,
                                join_token=token)
            dirs[h] = d.state_dir
            d.start()
            daemons[h] = d
        svc = daemons["m0"].manager.control_api.create_service(
            make_replicated("persistent", 1).spec)

        for h in ("m0", "m1", "m2"):
            old = daemons[h]
            old.stop()
            # survivors (2-of-3) elect a leader if the dead one led
            poll(lambda: any(d.raft_node.is_leader and d.manager.is_leader
                             and d.manager.dispatcher is not None
                             for n, d in daemons.items() if n != h),
                 timeout=45, msg=f"leadership settles without {h}")
            # restarts replay from the WAL; a joiner's bogus join_addr
            # only routes the code path (no RPC is made when persisted
            # state exists)
            fresh = _manager_daemon(h, state_dir=dirs[h],
                                    join_addr=None if h == "m0"
                                    else ("127.0.0.1", 1))
            fresh.start()
            daemons[h] = fresh
            poll(lambda: fresh.manager is not None
                 and svc.id in [s.id for s in _services_of(fresh)],
                 timeout=45,
                 msg=f"restarted {h} recovers replicated state")
        # after the full roll: all three are raft members somewhere
        leader = next(d for d in daemons.values()
                      if d.raft_node is not None and d.raft_node.is_leader)
        assert leader.raft_node.core.peers == {"m-m0", "m-m1", "m-m2"}
    finally:
        for d in daemons.values():
            d.stop()


def _services_of(daemon):
    from swarmkit_tpu_torch.models import Service
    try:
        return daemon.manager.store.view(lambda tx: tx.find(Service))
    except Exception:
        return []


