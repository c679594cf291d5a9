"""The port's consensus layer on the CPU: ``state/raft/``, ``security/``
and the manager's API surfaces against the reference's.

- The fifteen modules of this slice are the reference's text (their
  imports are relative, so the package name appears nowhere to change).
- The reference's ``tests/test_raft.py`` cases run against the port:
  in-process clusters of real ``RaftNode`` threads over ``LocalNetwork``,
  with on-disk WALs and snapshots, partitions, failover, restarts and
  membership changes; the failover case schedules through
  ``TorchPlanner(device="cpu")``.  Each gets one retry after a failure,
  the policy ``tests/conftest.py`` applies to the reference's own raft
  file: threaded elections on a loaded runner may blip.
- A WAL and snapshot sealed by one package's ``RaftLogger`` and
  ``KeyEncoder`` read back in the other's with equal records.
- ``RaftCore`` driven by hand, with no threads, in both packages, each
  member seeded alike, gives the same ``Ready`` sequence through an
  election, proposals, a partition, a snapshot and its install.
"""

import dataclasses
import functools
import importlib
import os
import pathlib
import random
import time

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, EngineDescription, Node, NodeAvailability,
    NodeDescription, NodeSpec, NodeState, NodeStatus, Placement, Platform,
    ReplicatedService, Resources, ResourceRequirements, Service,
    ServiceMode, ServiceSpec, Task, TaskSpec, TaskState, TaskStatus,
    Version,
)
from swarmkit_tpu_torch.state import MemoryStore  # noqa: E402
from swarmkit_tpu_torch.state.raft import (  # noqa: E402
    LocalNetwork, NotLeader, ProposalDropped, RaftLogger, RaftNode,
)
from swarmkit_tpu_torch.utils import new_id  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
#: the modules this slice ports, each the reference's text
SLICE_MODULES = (
    "state/raft/__init__.py", "state/raft/core.py", "state/raft/node.py",
    "state/raft/storage.py", "state/raft/transport.py",
    "security/__init__.py", "security/ca.py", "security/tls.py",
    "security/external.py", "manager/watchapi.py", "manager/controlapi.py",
    "manager/resourceapi.py", "manager/logbroker.py",
    "manager/keymanager.py", "manager/rolemanager.py",
    "manager/metrics.py")


def poll(cond, timeout=8.0, interval=0.05, msg="condition not met"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(msg)


def retried(fn):
    """Run ``fn`` again, once, after a failure, in a fresh ``tmp_path``
    directory: the retry ``tests/conftest.py`` gives the reference's raft
    tests, whose threaded elections can blip on a loaded runner."""
    @functools.wraps(fn)
    def run(*args, **kw):
        try:
            return fn(*args, **kw)
        except Exception:
            if "tmp_path" in kw:
                kw["tmp_path"] = kw["tmp_path"] / "retry"
                kw["tmp_path"].mkdir()
            return fn(*args, **kw)
    return run


def make_ready_node(name, cpus=4, mem=32 << 30, labels=None,
                    engine_labels=None, os="linux", arch="amd64",
                    availability=NodeAvailability.ACTIVE):
    n = Node(
        id=new_id(),
        spec=NodeSpec(annotations=Annotations(name=name),
                      availability=availability),
        status=NodeStatus(state=NodeState.READY),
        description=NodeDescription(
            hostname=name,
            platform=Platform(architecture=arch, os=os),
            resources=Resources(nano_cpus=cpus * 10**9, memory_bytes=mem),
            engine=EngineDescription(labels=engine_labels or {}),
        ),
    )
    if labels:
        n.spec.annotations.labels.update(labels)
    return n


def make_service_with_tasks(n_tasks, reservations=None):
    svc = Service(
        id=new_id(),
        spec=ServiceSpec(
            annotations=Annotations(name="svc-" + new_id()[:6]),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=n_tasks),
        ),
        spec_version=Version(index=1),
    )
    tasks = []
    for slot in range(1, n_tasks + 1):
        tasks.append(Task(
            id=new_id(), service_id=svc.id, slot=slot,
            desired_state=TaskState.RUNNING,
            spec=TaskSpec(
                placement=Placement(),
                resources=ResourceRequirements(reservations=reservations),
            ),
            spec_version=Version(index=1),
            status=TaskStatus(state=TaskState.PENDING),
        ))
    return svc, tasks


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_module_is_the_reference_text(rel):
    port = (ROOT / PORT / rel).read_text()
    ref = (ROOT / REF / rel).read_text()
    assert port == ref.replace("swarmkit_tpu.", "swarmkit_tpu_torch.")


# ------------------------------------------- the reference's raft cases

def make_cluster(tmp_path, n=3, snapshot_interval=1000):
    net = LocalNetwork()
    ids = [f"m{i}" for i in range(n)]
    nodes = {}
    for node_id in ids:
        store = MemoryStore()
        logger = RaftLogger(os.path.join(tmp_path, node_id))
        rn = RaftNode(node_id, ids, store, logger, net,
                      snapshot_interval=snapshot_interval)
        store._proposer = rn
        nodes[node_id] = rn
    for rn in nodes.values():
        rn.start()
    return net, nodes


def wait_leader(nodes, timeout=10):
    def find():
        # leader_ready: the election no-op must be applied before the
        # leader accepts proposals — a bare is_leader check races
        # ProposalDropped on an immediate store.update
        leaders = [rn for rn in nodes.values()
                   if rn.is_leader and rn.core.leader_ready]
        return leaders[0] if len(leaders) == 1 else None
    return poll(find, timeout=timeout, msg="no single leader elected")


def mk_node_obj(name):
    return Node(id=new_id(),
                spec=NodeSpec(annotations=Annotations(name=name)))


def stores_converged(nodes, expect_names, timeout=10):
    def check():
        for rn in nodes.values():
            got = {n.spec.annotations.name
                   for n in rn.store.view(lambda tx: tx.find(Node))}
            if got != set(expect_names):
                return False
        return True
    poll(check, timeout=timeout,
         msg=f"stores should converge to {expect_names}")


@retried
def test_single_node_cluster_commits(tmp_path):
    net, nodes = make_cluster(tmp_path, n=1)
    try:
        leader = wait_leader(nodes)
        leader.store.update(lambda tx: tx.create(mk_node_obj("a")))
        stores_converged(nodes, {"a"})
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_three_node_replication(tmp_path):
    net, nodes = make_cluster(tmp_path)
    try:
        leader = wait_leader(nodes)
        leader.store.update(lambda tx: tx.create(mk_node_obj("a")))
        leader.store.update(lambda tx: tx.create(mk_node_obj("b")))
        stores_converged(nodes, {"a", "b"})
        # follower stores carry identical version stamps
        versions = set()
        for rn in nodes.values():
            for n in rn.store.view(lambda tx: tx.find(Node)):
                versions.add((n.spec.annotations.name,
                              n.meta.version.index))
        assert len(versions) == 2, versions
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_proposal_on_follower_rejected(tmp_path):
    net, nodes = make_cluster(tmp_path)
    try:
        leader = wait_leader(nodes)
        follower = next(rn for rn in nodes.values() if not rn.is_leader)
        with pytest.raises(NotLeader):
            follower.store.update(lambda tx: tx.create(mk_node_obj("x")))
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_leader_failure_elects_new_and_resumes(tmp_path):
    net, nodes = make_cluster(tmp_path)
    try:
        leader = wait_leader(nodes)
        leader.store.update(lambda tx: tx.create(mk_node_obj("a")))
        stores_converged(nodes, {"a"})

        # kill the leader
        net.pause(leader.id)
        survivors = {k: v for k, v in nodes.items() if v is not leader}
        new_leader = wait_leader(survivors, timeout=15)
        assert new_leader.id != leader.id

        new_leader.store.update(lambda tx: tx.create(mk_node_obj("b")))
        stores_converged(survivors, {"a", "b"})

        # old leader comes back: catches up, steps down
        net.resume(leader.id)
        stores_converged(nodes, {"a", "b"})
        poll(lambda: not leader.is_leader or new_leader.is_leader,
             timeout=10)
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_partitioned_leader_cannot_commit(tmp_path):
    net, nodes = make_cluster(tmp_path)
    try:
        leader = wait_leader(nodes)
        others = [rn for rn in nodes.values() if rn is not leader]
        net.cut(leader.id, others[0].id)
        net.cut(leader.id, others[1].id)
        # a proposal on the partitioned leader must not commit
        with pytest.raises(ProposalDropped):
            leader.store.update(lambda tx: tx.create(mk_node_obj("lost")))
        # majority side elects and commits
        survivors = {rn.id: rn for rn in others}
        new_leader = wait_leader(survivors, timeout=15)
        new_leader.store.update(lambda tx: tx.create(mk_node_obj("ok")))
        net.heal(leader.id, others[0].id)
        net.heal(leader.id, others[1].id)
        stores_converged(nodes, {"ok"}, timeout=15)
        # the lost write must not reappear anywhere
        for rn in nodes.values():
            names = {n.spec.annotations.name
                     for n in rn.store.view(lambda tx: tx.find(Node))}
            assert "lost" not in names
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_restart_replays_wal(tmp_path):
    net, nodes = make_cluster(tmp_path, n=1)
    leader = wait_leader(nodes)
    leader.store.update(lambda tx: tx.create(mk_node_obj("a")))
    leader.store.update(lambda tx: tx.create(mk_node_obj("b")))
    leader.stop()

    # new process: same state dir
    store2 = MemoryStore()
    logger2 = RaftLogger(os.path.join(tmp_path, "m0"))
    net2 = LocalNetwork()
    rn2 = RaftNode("m0", ["m0"], store2, logger2, net2)
    store2._proposer = rn2
    names = {n.spec.annotations.name
             for n in store2.view(lambda tx: tx.find(Node))}
    assert names == {"a", "b"}, "WAL replay must rebuild the store"
    rn2.start()
    try:
        wait_leader({"m0": rn2})
        rn2.store.update(lambda tx: tx.create(mk_node_obj("c")))
        assert {n.spec.annotations.name
                for n in store2.view(lambda tx: tx.find(Node))} == \
            {"a", "b", "c"}
    finally:
        rn2.stop()


@retried
def test_snapshot_and_catchup(tmp_path):
    net, nodes = make_cluster(tmp_path, snapshot_interval=10)
    try:
        leader = wait_leader(nodes)
        names = set()
        for i in range(25):
            name = f"n{i:02d}"
            names.add(name)
            leader.store.update(lambda tx, name=name: tx.create(
                mk_node_obj(name)))
        stores_converged(nodes, names)
        assert leader.stats["snapshots"] >= 1, "leader should snapshot"
        assert leader.core.snap_index > 0

        # a follower that missed everything catches up via snapshot
        lagger = next(rn for rn in nodes.values() if rn is not leader)
        net.pause(lagger.id)
        more = set()
        for i in range(25, 45):
            name = f"n{i:02d}"
            names.add(name)
            more.add(name)
            leader.store.update(lambda tx, name=name: tx.create(
                mk_node_obj(name)))
        live = {k: v for k, v in nodes.items() if v is not lagger}
        stores_converged(live, names)
        net.resume(lagger.id)
        stores_converged(nodes, names, timeout=20)
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_leader_failover_preserves_scheduler_input(tmp_path):
    """The headline HA property: leader dies, the new leader's store has
    everything needed to keep scheduling (SURVEY §5.3); both leaders'
    schedulers plan through ``TorchPlanner(device="cpu")``."""
    from swarmkit_tpu_torch.models import Task, TaskState
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.scheduler import Scheduler
    from swarmkit_tpu_torch.state import ByService

    net, nodes = make_cluster(tmp_path)
    scheds = []
    try:
        leader = wait_leader(nodes)
        worker = make_ready_node("w1", cpus=8)
        svc, tasks = make_service_with_tasks(4)

        def setup(tx):
            tx.create(worker)
            tx.create(svc)
            for t in tasks:
                tx.create(t)
        leader.store.update(setup)

        # leader-only control loop: scheduler on the leader
        sched = Scheduler(leader.store,
                          batch_planner=TorchPlanner(device="cpu"))
        scheds.append(sched)
        sched.start()
        poll(lambda: all(
            t.status.state == TaskState.ASSIGNED
            for t in leader.store.view(
                lambda tx: tx.find(Task, ByService(svc.id)))), timeout=15)
        sched.stop()

        # leader dies; new leader resumes scheduling from replicated state
        net.pause(leader.id)
        survivors = {k: v for k, v in nodes.items() if v is not leader}
        new_leader = wait_leader(survivors, timeout=15)

        # a new task arrives (e.g. scale-up committed via new leader)
        t_new = tasks[0].copy()
        t_new.id = new_id()
        t_new.slot = 99
        t_new.node_id = ""
        new_leader.store.update(lambda tx: tx.create(t_new))

        sched2 = Scheduler(new_leader.store,
                           batch_planner=TorchPlanner(device="cpu"))
        scheds.append(sched2)
        sched2.start()
        poll(lambda: (new_leader.store.view(
            lambda tx: tx.get(Task, t_new.id)).status.state
            == TaskState.ASSIGNED), timeout=15,
            msg="new leader must schedule from replayed state")
        sched2.stop()
    finally:
        for s in scheds:
            s.stop()
        for rn in nodes.values():
            rn.stop()


@retried
def test_membership_add_and_remove(tmp_path):
    """Dynamic membership: a new member joins via a conf change and
    catches up; a removed member stops participating (reference:
    raft.go:926 Join / :1138 Leave)."""
    net, nodes = make_cluster(tmp_path, n=3)
    m3 = None
    try:
        leader = wait_leader(nodes)
        leader.store.update(lambda tx: tx.create(mk_node_obj("a")))
        stores_converged(nodes, {"a"})

        # join a 4th member: leader proposes the conf change, then the new
        # member starts with the expanded peer set and catches up
        leader.add_member("m3")
        poll(lambda: all("m3" in rn.core.peers for rn in nodes.values()),
             timeout=10, msg="all members should learn the new peer")

        store3 = MemoryStore()
        logger3 = RaftLogger(os.path.join(tmp_path, "m3"))
        m3 = RaftNode("m3", ["m0", "m1", "m2", "m3"], store3, logger3, net)
        store3._proposer = m3
        m3.start()
        all_nodes = dict(nodes)
        all_nodes["m3"] = m3
        stores_converged(all_nodes, {"a"}, timeout=15)

        leader2 = wait_leader(all_nodes)
        leader2.store.update(lambda tx: tx.create(mk_node_obj("b")))
        stores_converged(all_nodes, {"a", "b"}, timeout=15)

        # remove m3 again: cluster keeps committing with 3 members
        leader2.remove_member("m3")
        poll(lambda: all("m3" not in rn.core.peers
                         for rn in nodes.values()),
             timeout=10, msg="members should drop the removed peer")
        leader3 = wait_leader(nodes, timeout=15)
        leader3.store.update(lambda tx: tx.create(mk_node_obj("c")))
        stores_converged(nodes, {"a", "b", "c"}, timeout=15)
    finally:
        if m3 is not None:
            m3.stop()
        for rn in nodes.values():
            rn.stop()


@retried
def test_removed_member_cannot_disrupt(tmp_path):
    """A removed member stops participating, and live members ignore its
    messages — it can never depose the leader (check against the
    removed-node disruption raft failure mode)."""
    net, nodes = make_cluster(tmp_path, n=3)
    try:
        leader = wait_leader(nodes)
        removed = next(rn for rn in nodes.values() if rn is not leader)
        leader.remove_member(removed.id)
        poll(lambda: all(removed.id not in rn.core.peers
                         for rn in nodes.values() if rn is not removed),
             timeout=10, msg="members should drop the removed peer")

        # the removed node may never learn of its own removal (the leader
        # stops talking to it), so it will campaign at rising terms — live
        # members must IGNORE it: stable leader, same term, still committing
        term_before = leader.core.term
        time.sleep(1.5)
        survivors = {k: v for k, v in nodes.items() if v is not removed}
        cur_leader = wait_leader(survivors, timeout=10)
        assert cur_leader.core.term == term_before, \
            "removed member must not force elections"
        cur_leader.store.update(lambda tx: tx.create(mk_node_obj("post")))
        stores_converged(survivors, {"post"})
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_membership_survives_snapshot_and_restart(tmp_path):
    """Conf changes compacted into a snapshot must still be in effect
    after a restart (snapshot carries the peer set)."""
    net, nodes = make_cluster(tmp_path, n=3, snapshot_interval=5)
    try:
        leader = wait_leader(nodes)
        leader.add_member("m9")
        poll(lambda: "m9" in leader.core.peers, timeout=10)
        # churn past the snapshot interval so the conf entry is compacted
        for i in range(10):
            leader.store.update(lambda tx, i=i: tx.create(
                mk_node_obj(f"x{i}")))
        assert leader.core.snap_index > 0, "should have snapshotted"
        follower = next(rn for rn in nodes.values() if rn is not leader)
        fid = follower.id
        follower.stop()

        # restart with the ORIGINAL 3-member constructor list: membership
        # must come back from the snapshot (4 members incl. m9)
        store2 = MemoryStore()
        rn2 = RaftNode(fid, ["m0", "m1", "m2"], store2,
                       RaftLogger(os.path.join(tmp_path, fid)), net)
        store2._proposer = rn2
        assert "m9" in rn2.core.peers, rn2.core.peers
        rn2.stop()
    finally:
        for rn in nodes.values():
            rn.stop()


@retried
def test_wal_at_rest_encryption(tmp_path):
    """WAL + snapshot bytes on disk are sealed under the DEK; replay with
    the right key restores state, the wrong key fails authentication, and
    pre-encryption plaintext records still replay (upgrade path)."""
    import os

    from swarmkit_tpu_torch.state.raft.storage import KeyEncoder

    from swarmkit_tpu_torch.models import Service
    from swarmkit_tpu_torch.models.specs import (
        ContainerSpec, ReplicatedService, ServiceMode, ServiceSpec,
        TaskSpec,
    )

    def make_service(name):
        return Service(id=new_id(), spec=ServiceSpec(
            annotations=Annotations(name=name),
            task=TaskSpec(container=ContainerSpec(image="img:1")),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=1)))

    dek = b"cluster-dek"
    d = os.path.join(tmp_path, "raft")
    logger = RaftLogger(d, encoder=KeyEncoder(dek))
    net = LocalNetwork()
    store = MemoryStore()
    rn = RaftNode("n1", ["n1"], store, logger, net)
    store._proposer = rn
    rn.start()
    poll(lambda: rn.is_leader and rn.core.leader_ready, timeout=10)
    svc = make_service("sealed")
    store.update(lambda tx: tx.create(svc))
    rn.stop()

    # on-disk bytes must not contain the service name in the clear
    wal_path = os.path.join(d, "wal.jsonl")
    raw = open(wal_path, "rb").read()
    assert b"sealed" not in raw
    import base64 as b64
    for line in raw.splitlines():
        assert b"sealed" not in b64.b64decode(line)

    # right key replays
    store2 = MemoryStore()
    rn2 = RaftNode("n1", ["n1"], store2,
                   RaftLogger(d, encoder=KeyEncoder(dek)), LocalNetwork())
    assert store2.view(lambda tx: tx.get(Service, svc.id)) is not None
    rn2.logger.close()

    # wrong key fails closed
    with pytest.raises(Exception):
        RaftNode("n1", ["n1"], MemoryStore(),
                 RaftLogger(d, encoder=KeyEncoder(b"wrong")),
                 LocalNetwork())

    # plaintext (pre-encryption) records: steady-state decode fails closed
    # (unauthenticated records must not replay as raft state); the
    # explicit one-time migration flag allows the replay
    d2 = os.path.join(tmp_path, "plain")
    store3 = MemoryStore()
    rn3 = RaftNode("n1", ["n1"], store3, RaftLogger(d2), LocalNetwork())
    store3._proposer = rn3
    rn3.start()
    poll(lambda: rn3.is_leader and rn3.core.leader_ready, timeout=10)
    svc2 = make_service("plain")
    store3.update(lambda tx: tx.create(svc2))
    rn3.stop()
    from swarmkit_tpu_torch.state.raft.storage import DecryptionError
    with pytest.raises(DecryptionError):
        RaftNode("n1", ["n1"], MemoryStore(),
                 RaftLogger(d2, encoder=KeyEncoder(dek)), LocalNetwork())
    store4 = MemoryStore()
    rn4 = RaftNode(
        "n1", ["n1"], store4,
        RaftLogger(d2, encoder=KeyEncoder(dek, allow_plaintext=True)),
        LocalNetwork())
    assert store4.view(lambda tx: tx.get(Service, svc2.id)) is not None
    rn4.logger.close()


# --------------------------------------------- WAL and snapshot, crosswise

def _raft(pkg, name):
    return importlib.import_module(f"{pkg}.state.raft.{name}")


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_sealed_wal_and_snapshot_read_across_packages(tmp_path, writer,
                                                      reader):
    """Records sealed by one package's ``RaftLogger`` under a
    ``KeyEncoder`` read back in the other's: equal hard state, entries
    (binary block data included) and snapshot; a wrong key fails."""
    dek = b"cross-package-dek"
    w_core, w_sto = _raft(writer, "core"), _raft(writer, "storage")
    r_sto = _raft(reader, "storage")
    d = str(tmp_path / "m0")
    logger = w_sto.RaftLogger(d, encoder=w_sto.KeyEncoder(dek))
    rng = random.Random(7)
    entries = [w_core.Entry(term=1 + i // 4, index=i + 1,
                            data=bytes(rng.randrange(256)
                                       for _ in range(rng.randrange(300))))
               for i in range(12)]
    logger.save(w_core.HardState(term=2, voted_for="m0", commit=6),
                entries[:6])
    snap = w_core.Snapshot(index=4, term=1, data=b"store-bytes" * 50,
                           peers=["m0", "m1", "m2"],
                           peer_addrs={"m1": ("10.0.0.2", 4242)})
    logger.save_snapshot(snap, 4)
    logger.save(w_core.HardState(term=3, voted_for="m1", commit=10),
                entries[6:])
    want = logger.bootstrap()
    logger.close()

    other = r_sto.RaftLogger(d, encoder=r_sto.KeyEncoder(dek))
    got = other.bootstrap()
    other.close()
    hs, ents, sn = got
    assert dataclasses.asdict(hs) == dataclasses.asdict(want[0])
    assert [dataclasses.asdict(e) for e in ents] == \
        [dataclasses.asdict(e) for e in want[1]]
    assert [e.index for e in ents] == list(range(5, 13))
    assert dataclasses.asdict(sn) == dataclasses.asdict(want[2])
    with pytest.raises(r_sto.DecryptionError):
        r_sto.RaftLogger(d, encoder=r_sto.KeyEncoder(b"wrong")).bootstrap()


# ------------------------------------------------ RaftCore, by hand, twice

class Cores:
    """Three ``RaftCore`` members of one package, driven by hand: every
    message a Ready carries is delivered unless its link is cut, entries
    are persisted and applied at once, and a snapshot message gets the
    leader's data.  ``trace`` records every Ready as plain data."""

    def __init__(self, pkg, seed):
        self.core = _raft(pkg, "core")
        ids = ["n0", "n1", "n2"]
        self.cores = {i: self.core.RaftCore(
            i, ids, rng=random.Random(seed * 31 + k))
            for k, i in enumerate(ids)}
        for c in self.cores.values():
            c.lease_clock = lambda: 1000.0
        self.cut = set()
        self.trace = []
        self.snap_data = b""

    def drain(self, rounds=200):
        for _ in range(rounds):
            moved = False
            for i, c in sorted(self.cores.items()):
                if not c.has_ready():
                    continue
                rd = c.ready()
                self.trace.append((i, dataclasses.asdict(rd)))
                c.advance(rd)
                for m in rd.messages:
                    if (m.src, m.dst) in self.cut or \
                            (m.dst, m.src) in self.cut:
                        continue
                    if m.type == "snap" and m.snapshot is not None:
                        m.snapshot.data = self.snap_data
                    self.cores[m.dst].step(m)
                    moved = True
                moved = moved or bool(rd.entries or rd.committed)
            if not moved:
                return

    def tick(self, n=1, only=None):
        for _ in range(n):
            for i, c in sorted(self.cores.items()):
                if only is None or i in only:
                    c.tick()
            self.drain()

    def leader(self):
        leads = [c for c in self.cores.values() if c.role == "leader"]
        return leads[0] if len(leads) == 1 else None

    def script(self):
        for _ in range(60):
            if self.leader() is not None and self.leader().leader_ready:
                break
            self.tick()
        lead = self.leader()
        assert lead is not None
        for k in range(5):
            lead.propose(b"entry-%d" % k)
            self.drain()
        # partition one follower off; the majority keeps committing
        lag = sorted(i for i in self.cores if i != lead.id)[0]
        self.cut |= {(lag, i) for i in self.cores if i != lag}
        for k in range(5, 12):
            lead.propose(b"entry-%d" % k)
            self.drain()
        self.tick(3)
        # the leader compacts past what the lagging member has
        self.snap_data = b"snapshot@%d" % lead.commit_index
        for c in self.cores.values():
            if c.id != lag:
                c.compact(c.applied_index)
        self.cut.clear()
        self.tick(4)
        lead = self.leader()
        lead.propose(b"after-heal")
        self.drain()
        self.tick(2)
        return self.trace


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_raft_core_ready_sequence_matches_reference(seed):
    """Both packages' cores, seeded alike and driven by the same script,
    give the same Ready sequence: hard states, entries to persist,
    messages (snapshots included) and committed entries."""
    ref = Cores(REF, seed).script()
    port = Cores(PORT, seed).script()
    assert len(port) == len(ref) and port == ref
    kinds = {m["type"] for _, rd in port for m in rd["messages"]}
    assert {"vote", "app", "snap"} <= kinds, kinds
    lagging = [rd for i, rd in port if rd["snapshot"] is not None]
    assert lagging, "no member installed a snapshot"
