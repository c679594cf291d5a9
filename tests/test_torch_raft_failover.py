"""Leadership fencing in the port, on the CPU.

- The port's copies of the reference's ``tests/test_failover.py`` cases
  that need neither the simulator nor a planner: both epoch fence points
  of ``RaftNode`` driven by hand, the epoch pin refused before
  serialization, epochs monotonic across a restart, and the WAL's and
  snapshot's integrity checks (CRC, legacy records, a quarantined
  snapshot).
- A differential fence test: a stub proposer with ``propose_async`` /
  ``wait_proposal`` moves its ``leadership_epoch`` at the k-th block
  proposal of a pipelined many-service tick (chunks cut to 64 tasks, so
  each group's commit is a window of proposals).  The port's scheduler
  over ``TorchPlanner(device="cpu")`` and the reference's over
  ``TPUPlanner`` (router off), on the same cluster with the same ids and
  clock, must fail the same drafts and leave the same store rows; the
  port's planner holds nothing in flight afterwards and its breaker is
  closed.
"""

import base64
import importlib
import itertools
import json
import os

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.models import (  # noqa: E402
    Annotations, Node, NodeSpec,
)
from swarmkit_tpu_torch.state import MemoryStore  # noqa: E402
from swarmkit_tpu_torch.state.raft import (  # noqa: E402
    LocalNetwork, ProposalDropped, RaftLogger, RaftNode,
)
from swarmkit_tpu_torch.state.raft.core import LEADER  # noqa: E402
from swarmkit_tpu_torch.state.raft.node import StaleEpoch  # noqa: E402
from swarmkit_tpu_torch.state.store import StoreAction  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
T0 = 1_700_000_000.0


# ---------------------------------------------------------------------------
# Epoch fencing: both fence points, unit-level (no raft thread — the
# test drives the consensus loop by hand so the role change lands
# exactly between proposal creation and each fence point).
# ---------------------------------------------------------------------------

def _single_node(tmp_path):
    net = LocalNetwork()
    store = MemoryStore()
    logger = RaftLogger(os.path.join(str(tmp_path), "m0"))
    rn = RaftNode("m0", ["m0"], store, logger, net)
    store._proposer = rn
    _elect(rn)
    return rn


def _elect(rn, max_ticks=500):
    for _ in range(max_ticks):
        if rn.core.leader_ready:
            return
        rn.core.tick()
        rn._process_ready()
    raise AssertionError("single-member node failed to elect itself")


def _mk_node_action(name):
    return StoreAction("create", Node(
        id=name, spec=NodeSpec(annotations=Annotations(name=name))))


def test_pre_wal_fence_rejects_stale_epoch(tmp_path):
    """A proposal created under epoch E is rejected on the raft thread —
    before it can reach the log or WAL — once E is fenced by a
    depose-and-re-elect cycle that a naive role check would miss."""
    rn = _single_node(tmp_path)
    epoch0 = rn.leadership_epoch
    waiter = rn.propose_async([_mk_node_action("stale")])
    assert waiter.epoch == epoch0

    # forced role change while the proposal sits in the inbox: depose,
    # then re-elect (the member is leader AGAIN, but under a new epoch)
    rn.core.step_down()
    _elect(rn)
    assert rn.core.role == LEADER
    assert rn.leadership_epoch > epoch0

    last = rn.core.last_index()
    item = rn._inbox.get_nowait()
    rn._handle_proposal(*item)
    # fence point 1: nothing appended, waiter failed, reject counted
    assert rn.core.last_index() == last
    assert waiter.event.is_set() and not waiter.ok
    assert rn.stats["stale_epoch_rejects"] >= 1
    with pytest.raises(ProposalDropped):
        rn.wait_proposal(waiter)
    assert rn.store.raw_get(Node, "stale") is None
    rn.logger.close()


def test_commit_callback_fence_rejects_stale_epoch(tmp_path):
    """An entry that reaches the log under epoch E but commits after E
    was fenced must fail its proposer WITHOUT running the commit
    callback — while the store still converges via the follower-style
    remote apply (the entry is committed cluster state)."""
    rn = _single_node(tmp_path)
    ran = []
    waiter = rn.propose_async([_mk_node_action("fenced")],
                              commit_cb=lambda: ran.append(1))
    # append the entry under the current epoch (passes fence point 1)
    rn._handle_proposal(*rn._inbox.get_nowait())
    assert rn.core.last_index() > 0

    # the race under test: leadership epoch is fenced AFTER the entry is
    # in the log but BEFORE its commit callback is delivered
    rn.core.fence_epoch()
    rn._process_ready()   # commits + applies the entry

    assert waiter.event.is_set() and not waiter.ok
    assert ran == [], "commit callback must not run under a fenced epoch"
    with pytest.raises(ProposalDropped):
        rn.wait_proposal(waiter)
    # convergence: the committed entry still applied (remote-apply path)
    assert rn.store.raw_get(Node, "fenced") is not None
    assert rn.stats["stale_epoch_rejects"] >= 1
    rn.logger.close()


def test_epoch_pin_rejected_before_serialization(tmp_path):
    """propose_async(epoch=E) with a fenced E raises StaleEpoch
    immediately — multi-chunk commits pinned to a dead reign never even
    serialize their later chunks."""
    rn = _single_node(tmp_path)
    epoch0 = rn.leadership_epoch
    rn.core.step_down()
    _elect(rn)
    with pytest.raises(StaleEpoch):
        rn.propose_async([_mk_node_action("x")], epoch=epoch0)
    # unpinned proposals under the new reign still work (the node has
    # no raft thread, so drain the inbox by hand before waiting)
    ran = []
    w = rn.propose_async([_mk_node_action("fresh")],
                         commit_cb=lambda: ran.append(1))
    _drain_and_commit(rn)
    rn.wait_proposal(w)
    assert ran == [1]
    rn.logger.close()


def _drain_and_commit(rn, max_ticks=50):
    # the node has no thread: drain the inbox + Ready loop by hand
    import queue as _q
    for _ in range(max_ticks):
        try:
            item = rn._inbox.get_nowait()
        except _q.Empty:
            break
        rn._handle_proposal(*item)
    rn._process_ready()


def test_epoch_survives_restart_monotonic(tmp_path):
    """Epochs after a crash-restart are strictly above every pre-crash
    epoch — INCLUDING epochs inflated well past the term by
    deposal/re-election flaps and explicit handler fences (the
    term-stride epoch space) — so a restarted proposer can never
    accidentally match a pre-crash pin."""
    rn = _single_node(tmp_path)
    w = rn.propose_async([_mk_node_action("a")])
    _drain_and_commit(rn)
    rn.wait_proposal(w)
    # inflate the epoch far past the bare term: flaps + explicit fences
    for _ in range(3):
        rn.core.step_down()
        _elect(rn)
        rn.core.fence_epoch()
        rn.core.fence_epoch()
    epoch0 = rn.leadership_epoch
    assert epoch0 > rn.core.term, "flaps must outpace the term"
    rn.logger.close()

    net2 = LocalNetwork()
    store2 = MemoryStore()
    logger2 = RaftLogger(os.path.join(str(tmp_path), "m0"))
    rn2 = RaftNode("m0", ["m0"], store2, logger2, net2)
    store2._proposer = rn2
    _elect(rn2)
    assert rn2.leadership_epoch > epoch0
    rn2.logger.close()


def _wal_lines(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().splitlines() if ln.strip()]


def _rewrite_wal(path, lines):
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")


def test_wal_crc_catches_bit_flip(tmp_path):
    from swarmkit_tpu_torch.state.raft.core import Entry, HardState
    logger = RaftLogger(str(tmp_path))
    logger.save(HardState(term=1, voted_for="m0", commit=0),
                [Entry(term=1, index=i, data=f"e{i}".encode())
                 for i in (1, 2, 3)])
    logger.close()

    wal = os.path.join(str(tmp_path), "wal.jsonl")
    lines = _wal_lines(wal)
    # flip a bit INSIDE entry 2's payload such that base64/JSON still
    # parse — only the CRC can catch this class of corruption
    rec = json.loads(base64.b64decode(lines[2]))
    assert rec["index"] == 2
    data = bytearray(base64.b64decode(rec["data"]))
    data[0] ^= 0x40
    rec["data"] = base64.b64encode(bytes(data)).decode("ascii")
    lines[2] = base64.b64encode(json.dumps(
        rec, sort_keys=True, separators=(",", ":")).encode())
    _rewrite_wal(wal, lines)

    logger2 = RaftLogger(str(tmp_path))
    hs, entries, _ = logger2.bootstrap()
    # replay truncates AT the corrupt record: entry 1 survives, the
    # flipped entry 2 and everything after it do not
    assert [e.index for e in entries] == [1]
    logger2.close()


def test_wal_legacy_record_without_crc_replays(tmp_path):
    from swarmkit_tpu_torch.state.raft.core import Entry, HardState
    logger = RaftLogger(str(tmp_path))
    logger.save(HardState(term=1, voted_for="", commit=0),
                [Entry(term=1, index=1, data=b"one")])
    logger.close()
    wal = os.path.join(str(tmp_path), "wal.jsonl")
    lines = _wal_lines(wal)
    # append a pre-CRC-era record by hand
    legacy = {"t": "ent", "term": 1, "index": 2, "type": 0,
              "data": base64.b64encode(b"two").decode("ascii")}
    lines.append(base64.b64encode(json.dumps(
        legacy, sort_keys=True, separators=(",", ":")).encode()))
    _rewrite_wal(wal, lines)
    logger2 = RaftLogger(str(tmp_path))
    _, entries, _ = logger2.bootstrap()
    assert [e.index for e in entries] == [1, 2]
    assert entries[1].data == b"two"
    logger2.close()


def test_snapshot_bit_flip_quarantined_wal_fallback(tmp_path):
    from swarmkit_tpu_torch.state.raft.core import Entry, HardState, Snapshot
    logger = RaftLogger(str(tmp_path))
    logger.save(HardState(term=1, voted_for="", commit=3),
                [Entry(term=1, index=i, data=f"e{i}".encode())
                 for i in (1, 2, 3)])
    logger.save_snapshot(Snapshot(index=2, term=1, data=b"snapbody"),
                         keep_entries_from=2)
    logger.close()

    snap_path = os.path.join(str(tmp_path), "snapshot")
    rec = json.loads(open(snap_path, "rb").read())
    body = bytearray(base64.b64decode(rec["data"]))
    body[3] ^= 0x01
    rec["data"] = base64.b64encode(bytes(body)).decode("ascii")
    with open(snap_path, "w") as f:
        f.write(json.dumps(rec))

    logger2 = RaftLogger(str(tmp_path))
    hs, entries, snapshot = logger2.bootstrap()
    # corrupt snapshot: quarantined, not restored — bootstrap falls
    # back to WAL-only replay of the post-snapshot tail
    assert snapshot is None
    assert os.path.exists(snap_path + ".corrupt")
    assert not os.path.exists(snap_path)
    assert [e.index for e in entries] == [3]
    logger2.close()


def test_snapshot_intact_roundtrip_still_loads(tmp_path):
    from swarmkit_tpu_torch.state.raft.core import Snapshot
    logger = RaftLogger(str(tmp_path))
    logger.save_snapshot(Snapshot(index=5, term=2, data=b"payload"),
                         keep_entries_from=5)
    snap = logger.load_snapshot()
    assert snap is not None and snap.data == b"payload"
    logger.close()




# ---------------------------------------------------------------------------
# A deposed pipelined tick, both packages
# ---------------------------------------------------------------------------

#: (strategy, spread over the rack label) per service of the fence cluster
FENCE_MIX = (("spread", True), ("binpack", False), ("spread", True),
             ("weighted", False), ("spread", False), ("learned", False))
FENCE_NODES = 96
FENCE_TASKS = 150          # a service
FENCE_CHUNK = 64           # tasks a block proposal


class Pkg:
    def __init__(self, name):
        def mod(path):
            return importlib.import_module(f"{name}.{path}")

        self.name = name
        self.m = mod("models")
        self.types = mod("models.types")
        self.identity = mod("utils.identity")
        self.serde = mod("state.serde")
        self.state = mod("state")
        self.node = mod("state.raft.node")
        self.sched = mod("scheduler")
        self.metrics = mod("utils.metrics")


PKGS = {name: Pkg(name) for name in (REF, PORT)}


@pytest.fixture(autouse=True)
def registries_left_as_found():
    """Each test leaves both packages' metrics gauges and timers as it
    found them: later tests in the same process read them (the
    reference's health plane).  Counters only grow and are read as
    deltas."""
    regs = [p.metrics.registry for p in PKGS.values()]
    saved = [(dict(r.gauges), {k: (list(t._buf), t._i, t.count, t.total)
                               for k, t in r.timers.items()})
             for r in regs]
    yield
    for r, (gauges, timers) in zip(regs, saved):
        r.gauges.clear()
        r.gauges.update(gauges)
        for name, t in r.timers.items():
            t.reset()
            if name in timers:
                t._buf, t._i, t.count, t.total = timers[name]


class DeposingProposer:
    """A leader that loses its reign at its ``depose_at``-th block
    proposal: that proposal, those still in flight and every later one
    fail, pinned proposals before serialization with the package's
    ``StaleEpoch``, the rest at the wait with ``ProposalDropped`` (the
    commit-delivery fence); proposals waited on before it commit, in
    order, as a raft leader's do."""

    def __init__(self, pkg, depose_at):
        self.pkg = pkg
        self.depose_at = depose_at
        self.epoch = 7
        self.calls = 0
        self.committed = []

    @property
    def is_leader(self):
        return True

    @property
    def leadership_epoch(self):
        return self.epoch

    def propose_async(self, actions, commit_cb=None, epoch=None):
        if epoch is not None and epoch != self.epoch:
            raise self.pkg.node.StaleEpoch(f"epoch {epoch} fenced")
        self.calls += 1
        if self.calls == self.depose_at:
            self.epoch += 1
        return [actions, commit_cb, self.epoch if epoch is None else epoch]

    def wait_proposal(self, waiter):
        actions, commit_cb, epoch = waiter
        if epoch != self.epoch:
            raise self.pkg.node.ProposalDropped("leadership change")
        if commit_cb is not None:
            commit_cb()
        self.committed.append(sum(len(a.ids) for a in actions))

    def propose(self, actions, commit_cb=None, epoch=None):
        self.wait_proposal(self.propose_async(actions, commit_cb, epoch))


def fence_cluster(p):
    """Racked nodes and one replicated service a ``FENCE_MIX`` entry, all
    tasks PENDING, with the package's fixed ids."""
    m = p.m
    store = p.state.MemoryStore()
    store.BLOCK_PROPOSAL_MAX_ITEMS = FENCE_CHUNK
    nodes = [m.Node(
        id=p.identity.new_id() if hasattr(p.identity, "new_id")
        else importlib.import_module(f"{p.name}.utils").new_id(),
        spec=m.NodeSpec(annotations=m.Annotations(
            name=f"node-{i:03d}", labels={"rack": f"r{i % 6}"})),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(
            hostname=f"node-{i:03d}",
            resources=m.Resources(nano_cpus=64 * 10**9,
                                  memory_bytes=256 << 30)))
        for i in range(FENCE_NODES)]
    new_id = importlib.import_module(f"{p.name}.utils").new_id
    services, tasks = [], []
    for si, (strategy, spread) in enumerate(FENCE_MIX):
        spec = m.TaskSpec(
            placement=m.Placement(
                preferences=[m.PlacementPreference(spread=m.SpreadOver(
                    spread_descriptor="node.labels.rack"))] if spread
                else [], strategy=strategy),
            resources=m.ResourceRequirements(reservations=m.Resources(
                nano_cpus=10**8, memory_bytes=64 << 20)))
        svc = m.Service(id=new_id(), spec=m.ServiceSpec(
            annotations=m.Annotations(name=f"fence-{si}"),
            mode=m.ServiceMode.REPLICATED, task=spec,
            replicated=m.ReplicatedService(replicas=FENCE_TASKS)),
            spec_version=m.Version(index=1))
        services.append(svc)
        for s in range(1, FENCE_TASKS + 1):
            tasks.append(m.Task(
                id=new_id(), service_id=svc.id, slot=s,
                desired_state=m.TaskState.RUNNING, spec=spec,
                spec_version=m.Version(index=1),
                status=m.TaskStatus(state=m.TaskState.PENDING)))

    def create(tx):
        for obj in nodes + services + tasks:
            tx.create(obj)

    store.update(create)
    return store


def deposed_tick(p, planner, depose_at):
    """One pipelined tick of the fence cluster under a proposer deposed at
    its ``depose_at``-th block proposal: (decisions, store rows by task,
    tasks the scheduler requeued, proposals made, committed sizes)."""
    t = [T0]
    p.types.set_time_source(lambda: t[0])
    n = itertools.count()
    p.identity.set_id_source(lambda: f"id{next(n):08d}")
    try:
        store = fence_cluster(p)
        proposer = DeposingProposer(p, depose_at)
        store._proposer = proposer
        sched = p.sched.Scheduler(store, batch_planner=planner)
        assert sched.pipeline_depth >= 2
        store.view(sched._setup_tasks_list)
        decided = sched.tick()
        rows = store.view(lambda tx: sorted(
            (x.id, x.node_id, int(x.status.state), x.meta.version.index,
             x.status.message) for x in tx.find(p.m.Task)))
        return (decided, rows, sorted(sched.unassigned_tasks),
                proposer.calls, proposer.committed)
    finally:
        p.types.set_time_source(None)
        p.identity.set_id_source(None)


@pytest.mark.parametrize("depose_at", [1, 2, 5, 11])
def test_deposed_pipelined_tick_matches_reference(depose_at):
    from swarmkit_tpu.ops import TPUPlanner

    from swarmkit_tpu_torch.ops import TorchPlanner

    ref_planner = TPUPlanner()
    ref_planner.enable_small_group_routing = False
    port_planner = TorchPlanner(device="cpu")
    ref = deposed_tick(PKGS[REF], ref_planner, depose_at)
    port = deposed_tick(PKGS[PORT], port_planner, depose_at)
    decided, rows, requeued, calls, committed = port
    assert port == ref
    total = len(FENCE_MIX) * FENCE_TASKS
    assigned = [r for r in rows if r[1]]
    # only proposals waited on before the deposing one committed: those
    # still in the store's window when it came fail with it
    assert len(committed) < depose_at
    assert (len(committed) > 0) == (depose_at > 2)
    assert len(assigned) == sum(committed) < total
    assert len(requeued) == total - len(assigned)
    assert not port_planner._inflight
    assert port_planner._fused_active is None
    assert port_planner.breaker.state == 0
    assert port_planner.stats.get("groups_device_error", 0) == 0


def test_lost_leadership_is_not_a_device_error():
    """The proposer's refusals are not device errors: the breaker's host
    route (``ops.cuda.DEVICE_ERRORS``) never takes them."""
    from swarmkit_tpu_torch.ops.cuda import DEVICE_ERRORS
    from swarmkit_tpu_torch.state.raft import NotLeader

    for exc in (NotLeader, StaleEpoch, ProposalDropped):
        assert not issubclass(exc, DEVICE_ERRORS), exc
