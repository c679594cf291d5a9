"""Follower-served reads in the port, on the CPU.

The port's copies of the reference's ``tests/test_follower_reads.py``
cases whose modules the port has: raft's read-index and lease protocol
driven by hand, the store's linearizable ``read_view``, the watch API's
resume tokens (gap-free and dup-free on any member) and filters, and the
stale-read health value.  The reference's other cases there need the
dispatcher, the agents' remotes or the simulator, which the port does not
have yet.  One more case drives three real ``RaftNode`` threads: a
linearizable read and a watch resumed on a follower, and a stranded
ex-leader that refuses a linearizable read until it has caught up.
"""

import functools
import logging
import time

import pytest

from swarmkit_tpu_torch.models import (
    Annotations, Service, ServiceSpec, Task, TaskSpec, TaskState,
    TaskStatus, Version,
)
from swarmkit_tpu_torch.state.raft.core import LEADER, Message, RaftCore
from swarmkit_tpu_torch.state.raft.node import ReadUnavailable
from swarmkit_tpu_torch.state.store import MemoryStore

logging.disable(logging.CRITICAL)


# --------------------------------------------------------------- helpers

def mk_cluster(n=3):
    """N connected RaftCores with a synchronous message pump."""
    ids = [f"n{i}" for i in range(n)]
    import random
    cores = {i: RaftCore(i, ids, rng=random.Random(hash(i) & 0xFFFF))
             for i in ids}

    def pump():
        for _ in range(200):
            moved = False
            for c in cores.values():
                msgs, c._msgs = c._msgs, []
                for m in msgs:
                    moved = True
                    if m.dst in cores:
                        cores[m.dst].step(m)
            if not moved:
                return

    def elect(i):
        c = cores[i]
        while c.role != LEADER:
            c.tick()
            pump()
        # drain ready so the no-op applies (leader_ready)
        rd = c.ready()
        c.advance(rd)
        c.applied_index = c.commit_index
        return c

    return cores, pump, elect


def mk_task(i, sid="svc"):
    return Task(id=f"t{i:03d}", service_id=sid, slot=i,
                desired_state=TaskState.RUNNING, spec=TaskSpec(),
                spec_version=Version(index=1),
                status=TaskStatus(state=TaskState.PENDING, timestamp=1.0))


def test_read_index_quorum_round_on_leader():
    cores, pump, elect = mk_cluster()
    leader = elect("n0")
    leader.lease_duration = None    # force the quorum round
    seq = leader.request_read()
    assert seq is not None and seq not in leader.read_results
    pump()   # heartbeat round + echoes
    index, ok, lease = leader.read_results.pop(seq)
    assert ok and not lease
    assert index == leader.commit_index


def test_follower_read_index_round_trip():
    cores, pump, elect = mk_cluster()
    leader = elect("n0")
    leader.lease_duration = None
    follower = cores["n1"]
    # the follower learns the leader via a heartbeat
    leader._broadcast_append(heartbeat=True)
    pump()
    assert follower.leader_id == "n0"
    seq = follower.request_read()
    assert seq is not None
    pump()
    index, ok, lease = follower.read_results.pop(seq)
    assert ok and not lease
    assert index == leader.commit_index


def test_lease_fast_path_and_expiry(monkeypatch):
    from swarmkit_tpu_torch.models import types as mtypes
    t = [100.0]
    mtypes.set_time_source(lambda: t[0])
    try:
        cores, pump, elect = mk_cluster()
        leader = elect("n0")
        leader.lease_duration = 1.0
        # earn the lease: one quorum-acked heartbeat round
        leader._broadcast_append(heartbeat=True)
        pump()
        assert leader.lease_valid()
        seq = leader.request_read()
        index, ok, lease = leader.read_results.pop(seq)
        assert ok and lease and index == leader.commit_index
        assert leader.read_stats["lease_served"] == 1
        # past the (margin-shaved) expiry the lease must NOT serve
        t[0] += 1.0
        assert not leader.lease_valid()
        seq = leader.request_read()
        assert seq not in leader.read_results   # quorum round in flight
        pump()
        index, ok, lease = leader.read_results.pop(seq)
        assert ok and not lease
    finally:
        mtypes.set_time_source(None)


def test_lease_gate_vetoes_fast_path(monkeypatch):
    from swarmkit_tpu_torch.models import types as mtypes
    t = [50.0]
    mtypes.set_time_source(lambda: t[0])
    try:
        cores, pump, elect = mk_cluster()
        leader = elect("n0")
        leader.lease_duration = 5.0
        leader._broadcast_append(heartbeat=True)
        pump()
        assert leader.lease_valid()
        leader.lease_gate = lambda: False   # clock-skew fault active
        seq = leader.request_read()
        assert seq not in leader.read_results   # forced quorum round
        pump()
        index, ok, lease = leader.read_results.pop(seq)
        assert ok and not lease
        assert leader.read_stats["lease_refused_gate"] == 1
    finally:
        mtypes.set_time_source(None)


def test_deposed_leader_fails_pending_reads():
    cores, pump, elect = mk_cluster()
    leader = elect("n0")
    leader.lease_duration = None
    seq = leader.request_read()
    assert seq not in leader.read_results
    # a higher-term message deposes the leader before the round confirms
    leader.step(Message(type="vote", term=leader.term + 5, src="n1",
                        dst="n0", last_log_index=99, last_log_term=99))
    index, ok, lease = leader.read_results.pop(seq)
    assert not ok


def test_single_member_reads_immediately():
    import random
    c = RaftCore("solo", ["solo"], rng=random.Random(1))
    while c.role != LEADER:
        c.tick()
    c.applied_index = c.commit_index
    seq = c.request_read()
    index, ok, lease = c.read_results.pop(seq)
    assert ok and index == c.commit_index


class _BarrierProposer:
    """Fake proposer exposing the read_barrier capability."""

    leadership_epoch = None

    def __init__(self):
        self.barriers = 0

    def propose(self, actions, commit_cb=None, epoch=None):
        commit_cb()

    def read_barrier(self, timeout=None):
        self.barriers += 1


def test_read_view_runs_barrier_only_when_linearizable():
    p = _BarrierProposer()
    store = MemoryStore(proposer=p)
    store.update(lambda tx: tx.create(mk_task(1)))
    n = store.read_view(lambda tx: len(tx.find(Task)))
    assert n == 1 and p.barriers == 0
    n = store.read_view(lambda tx: len(tx.find(Task)),
                        linearizable=True)
    assert n == 1 and p.barriers == 1
    # plain proposers without the capability serve directly
    store2 = MemoryStore()
    store2.update(lambda tx: tx.create(mk_task(2)))
    assert store2.read_view(lambda tx: len(tx.find(Task)),
                            linearizable=True) == 1


def test_watch_events_carry_resume_tokens_including_deletes():
    from swarmkit_tpu_torch.manager.watchapi import WatchRequest, WatchServer
    store = MemoryStore()
    server = WatchServer(store)
    stream = server.watch(WatchRequest(kinds=[Task]))
    store.update(lambda tx: tx.create(mk_task(1)))
    store.update(lambda tx: tx.delete(Task, "t001"))
    ev1 = stream.get(timeout=1)
    ev2 = stream.get(timeout=1)
    assert ev1.action == "create" and ev1.version > 0
    assert ev2.action == "delete" and ev2.version == ev1.version + 1
    assert stream.poll() is None
    stream.close()


def test_resume_token_continues_without_gap_or_dup():
    from swarmkit_tpu_torch.manager.watchapi import WatchRequest, WatchServer
    store = MemoryStore()
    server = WatchServer(store)
    stream = server.watch(WatchRequest(kinds=[Task]))
    for i in range(1, 4):
        store.update(lambda tx, i=i: tx.create(mk_task(i)))
    seen = [stream.get(timeout=1) for _ in range(2)]
    token = seen[-1].version
    stream.close()
    # more commits while detached
    for i in range(4, 6):
        store.update(lambda tx, i=i: tx.create(mk_task(i)))
    resumed = server.watch(WatchRequest(kinds=[Task],
                                        resume_from_version=token))
    got = []
    while True:
        ev = resumed.poll()
        if ev is None:
            break
        got.append(ev)
    ids = [e.obj.id for e in got]
    assert ids == ["t003", "t004", "t005"]
    versions = [e.version for e in got]
    assert versions == sorted(versions) and versions[0] == token + 1
    resumed.close()


def test_resume_token_is_member_portable():
    """A token minted on the leader store resumes on a follower replica
    (identical version stamping through apply_store_actions)."""
    from swarmkit_tpu_torch.manager.watchapi import WatchRequest, WatchServer
    from swarmkit_tpu_torch.state.store import StoreAction
    leader = MemoryStore()
    follower = MemoryStore()

    class Replicator:
        leadership_epoch = None

        def propose(self, actions, commit_cb=None, epoch=None):
            commit_cb()
            follower.apply_store_actions(
                [StoreAction(a.action, a.obj.copy()) for a in actions])

    leader._proposer = Replicator()
    stream = WatchServer(leader).watch(WatchRequest(kinds=[Task]))
    for i in range(1, 5):
        leader.update(lambda tx, i=i: tx.create(mk_task(i)))
    token = None
    for _ in range(2):
        token = stream.get(timeout=1).version
    stream.close()
    assert follower.version == leader.version
    resumed = WatchServer(follower).watch(
        WatchRequest(kinds=[Task], resume_from_version=token))
    ids = []
    while True:
        ev = resumed.poll()
        if ev is None:
            break
        ids.append(ev.obj.id)
    assert ids == ["t003", "t004"]
    resumed.close()


def test_resume_compacted_raises():
    from swarmkit_tpu_torch.manager.watchapi import (
        ResumeCompacted, WatchRequest, WatchServer,
    )
    store = MemoryStore()
    store.changelog_limit = 4
    for i in range(1, 10):
        store.update(lambda tx, i=i: tx.create(mk_task(i)))
    with pytest.raises(ResumeCompacted):
        WatchServer(store).watch(
            WatchRequest(kinds=[Task], resume_from_version=1))


def _filter_events(request, events):
    from swarmkit_tpu_torch.manager.watchapi import compile_filter
    pred = compile_filter(request)
    return [ev for ev in events if pred(ev)]


def test_watch_field_filters_and_custom_indices():
    from swarmkit_tpu_torch.manager.watchapi import WatchRequest
    from swarmkit_tpu_torch.state.events import Event
    t1 = mk_task(1, sid="a")
    t2 = mk_task(2, sid="b")
    t2.desired_state = TaskState.SHUTDOWN
    svc = Service(id="s1", spec=ServiceSpec(
        annotations=Annotations(name="Web",
                                indices={"tier": "frontend"})),
        spec_version=Version(index=1))
    events = [Event("create", t1), Event("create", t2),
              Event("create", svc)]
    # slot selector
    got = _filter_events(WatchRequest(slots=[("a", 1)]), events)
    assert [e.obj.id for e in got] == ["t001"]
    # desired-state selector
    got = _filter_events(
        WatchRequest(desired_states=[int(TaskState.SHUTDOWN)]), events)
    assert [e.obj.id for e in got] == ["t002"]
    # exact-name selector (case-insensitive, like the store index)
    got = _filter_events(WatchRequest(names=["web"]), events)
    assert [e.obj.id for e in got] == ["s1"]
    # custom index exact + prefix
    got = _filter_events(
        WatchRequest(custom_indices=[("tier", "frontend")]), events)
    assert [e.obj.id for e in got] == ["s1"]
    got = _filter_events(
        WatchRequest(custom_index_prefixes=[("tier", "front")]), events)
    assert [e.obj.id for e in got] == ["s1"]
    got = _filter_events(
        WatchRequest(custom_indices=[("tier", "backend")]), events)
    assert got == []


def test_watch_filters_member_agnostic():
    """The same compiled filter applied to the leader's and a follower's
    event payloads selects the same stream (shared by both serve paths
    and by the sim's continuity ledger)."""
    from swarmkit_tpu_torch.manager.watchapi import (
        WatchRequest, compile_filter,
    )
    from swarmkit_tpu_torch.state.store import StoreAction
    leader, follower = MemoryStore(), MemoryStore()
    req = WatchRequest(kinds=[Task], service_ids=["a"])
    pred = compile_filter(req)
    lsub = leader.queue.subscribe(pred)
    fsub = follower.queue.subscribe(pred)

    class Replicator:
        leadership_epoch = None

        def propose(self, actions, commit_cb=None, epoch=None):
            commit_cb()
            follower.apply_store_actions(
                [StoreAction(a.action, a.obj.copy()) for a in actions])

    leader._proposer = Replicator()
    for i, sid in ((1, "a"), (2, "b"), (3, "a")):
        leader.update(lambda tx, i=i, sid=sid: tx.create(mk_task(i, sid)))
    from swarmkit_tpu_torch.state.events import event_version
    lgot = []
    while True:
        ev = lsub.poll()
        if ev is None:
            break
        lgot.append((event_version(ev), ev.obj.id))
    fgot = []
    while True:
        ev = fsub.poll()
        if ev is None:
            break
        fgot.append((event_version(ev), ev.obj.id))
    assert lgot == fgot == [(1, "t001"), (3, "t003")]


def test_stale_read_risk_transitions():
    from swarmkit_tpu_torch.obs.health import stale_read_risk_value
    from swarmkit_tpu_torch.utils.metrics import Registry
    reg = Registry()
    val = stale_read_risk_value(read_index_p99_bound=0.5)
    assert val(reg) is None                      # no read plane yet
    reg.gauge("swarm_lease_enabled", 1.0)
    assert val(reg) == 0.0                       # lease on, no staleness
    reg.gauge("swarm_lease_enabled", 0.0)
    t = reg.timer("swarm_read_index_latency")
    for _ in range(20):
        t.observe(2.0)                           # slow quorum rounds
    assert val(reg) == 1.0                       # warn: degraded
    reg.counter("swarm_stale_reads")
    assert val(reg) == 2.0                       # fail: stale serve


# ------------------------------------------- three real members, threaded

def retried(fn):
    """Run ``fn`` again, once, after a failure, in a fresh ``tmp_path``
    directory: the retry ``tests/conftest.py`` gives the reference's raft
    tests, whose threaded elections can blip on a loaded runner."""
    @functools.wraps(fn)
    def run(*args, **kw):
        try:
            return fn(*args, **kw)
        except Exception:
            kw["tmp_path"] = kw["tmp_path"] / "retry"
            kw["tmp_path"].mkdir()
            return fn(*args, **kw)
    return run


def _poll(cond, timeout=15.0, msg="condition not met"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(msg)


@retried
def test_follower_reads_and_watch_resume_on_real_members(tmp_path):
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.manager.watchapi import WatchRequest, WatchServer

    net, members = workload.raft_group(3, str(tmp_path), tick_interval=0.02)
    try:
        leader = workload.wait_leader(members)
        stream = WatchServer(leader.store).watch(WatchRequest(kinds=[Task]))
        for i in range(1, 9):
            leader.store.update(lambda tx, i=i: tx.create(mk_task(i)))
        follower = next(rn for rn in members.values() if rn is not leader)
        ids = follower.store.read_view(
            lambda tx: sorted(t.id for t in tx.find(Task)),
            linearizable=True, timeout=10.0)
        assert ids == [f"t{i:03d}" for i in range(1, 9)]
        seen = [stream.get(timeout=5) for _ in range(3)]
        token = seen[-1].version
        stream.close()
        resumed = WatchServer(follower.store).watch(
            WatchRequest(kinds=[Task], resume_from_version=token))
        got = []
        while True:
            ev = resumed.poll()
            if ev is None:
                break
            got.append((ev.version, ev.obj.id))
        resumed.close()
        assert got == [(token + k, f"t{k + 3:03d}") for k in range(1, 6)]

        # the leader is cut off: its successor commits, and the stranded
        # ex-leader refuses a linearizable read rather than serve stale
        net.pause(leader.id)
        survivors = [rn for rn in members.values() if rn is not leader]
        successor = workload.wait_leader(survivors)
        successor.store.update(lambda tx: tx.create(mk_task(9)))
        with pytest.raises(ReadUnavailable):
            leader.store.read_view(lambda tx: len(tx.find(Task)),
                                   linearizable=True, timeout=1.0)
        net.resume(leader.id)
        _poll(lambda: leader.store.read_view(
            lambda tx: len(tx.find(Task)), linearizable=True,
            timeout=2.0) == 9, msg="the ex-leader did not catch up")
    finally:
        for rn in members.values():
            rn.stop()
