"""Raft consensus core: a sans-IO state machine.

Reference behavior: manager/state/raft/raft.go wraps etcd-raft; this module
implements the same consensus protocol (leader election with randomized
timeouts, log replication, commit by majority match, snapshot install,
leader no-op entry on election) as a pure state machine — no threads, no
clocks, no sockets.  The driver (node.py) feeds it ``tick()`` and
``step(msg)`` and drains ``ready()``:

    rd = core.ready()
    1. persist rd.hard_state and rd.entries (WAL) BEFORE sending
    2. send rd.messages
    3. apply rd.committed to the application state machine
    4. core.advance(rd)

This ordering gives raft's durability guarantee: nothing is sent or applied
before it is on stable storage (raft.go:540's Ready loop does the same).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ...models.types import now as _now

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

ENTRY_NORMAL = 0
ENTRY_NOOP = 1
ENTRY_CONF = 2   # data = JSON {"op": "add"|"remove", "id": member id,
                 #                "addr": optional [host, port]}

# leadership epochs are minted at term * stride: the headroom between
# consecutive terms absorbs every fence bump a reign can accumulate
# (deposal + explicit handler fences), so an epoch minted under any
# later term — in particular, after a crash-restart — is strictly
# greater than every epoch the earlier term could have reached
EPOCH_TERM_STRIDE = 1 << 20


@dataclass
class Entry:
    term: int
    index: int
    data: bytes = b""
    type: int = ENTRY_NORMAL


@dataclass
class HardState:
    """Must be persisted before acting on a Ready (raft thesis §3.8)."""

    term: int = 0
    voted_for: str = ""
    commit: int = 0


@dataclass
class Snapshot:
    index: int = 0
    term: int = 0
    data: bytes = b""
    # the peer set as of `index`: conf entries before the snapshot are
    # compacted away, so membership must travel with it (etcd ConfState)
    peers: List[str] = field(default_factory=list)
    # transport addresses learned through conf entries: every member must
    # be able to dial every other even if it never served their join RPC
    # (the reference stores member addrs in the raft member list itself,
    # membership/cluster.go)
    peer_addrs: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    # managers' remote-API addresses: distributed to agents via heartbeat
    # responses so they can fail over (reference: session Message.Managers)
    api_addrs: Dict[str, Tuple[str, int]] = field(default_factory=dict)


@dataclass
class Message:
    type: str            # vote / vote_resp / app / app_resp / snap
                         # / read_index / read_index_resp
    term: int
    src: str
    dst: str
    # vote
    last_log_index: int = 0
    last_log_term: int = 0
    granted: bool = False
    # append
    prev_index: int = 0
    prev_term: int = 0
    entries: List[Entry] = field(default_factory=list)
    commit: int = 0
    success: bool = False
    match_index: int = 0
    # snapshot
    snapshot: Optional[Snapshot] = None
    # read-index protocol (etcd-raft MsgReadIndex/MsgReadIndexResp):
    # heartbeat rounds carry a context id that successful followers echo
    # so the leader can count a quorum for the reads pinned to the round
    read_ctx: int = 0
    # requester-minted id for one read-barrier request, echoed in the resp
    read_seq: int = 0
    # the leader's confirmed commit index for that request
    read_index: int = 0
    # the resp was served off the leader lease (no quorum round)
    lease_read: bool = False


@dataclass
class Ready:
    hard_state: Optional[HardState]
    entries: List[Entry]             # new entries to persist
    messages: List[Message]          # send after persisting
    committed: List[Entry]           # apply to the state machine
    snapshot: Optional[Snapshot]     # received snapshot to persist+restore


class RaftCore:
    """One member's consensus state (pure; deterministic given inputs)."""

    def __init__(self, node_id: str, peers: Sequence[str],
                 election_tick: int = 10, heartbeat_tick: int = 1,
                 rng: Optional[random.Random] = None,
                 prevote: bool = True):
        self.id = node_id
        self.peers = set(peers) | {node_id}
        # pre-vote (raft thesis §9.6, etcd-raft PreVote): before a real
        # campaign, probe a majority with a WOULD-you-vote round that
        # mutates no state — a partitioned rejoiner keeps timing out its
        # pre-vote instead of bumping its term, so it cannot depose a
        # healthy leader when the partition heals
        self.prevote = prevote
        self._in_prevote = False
        self._prevotes: Dict[str, bool] = {}
        self.peer_addrs: Dict[str, Tuple[str, int]] = {}
        self.api_addrs: Dict[str, Tuple[str, int]] = {}
        self.election_tick = election_tick
        self.heartbeat_tick = heartbeat_tick
        self._rng = rng or random.Random()

        self.term = 0
        self.voted_for = ""
        self.role = FOLLOWER
        self.leader_id = ""
        # leadership-epoch fencing token (Chubby sequencer / ZooKeeper
        # zxid-epoch style): minted strictly monotonically on every
        # transition INTO leadership and bumped again the moment
        # leadership is lost (or explicitly fenced), so a proposal
        # stamped with the epoch it was created under can be rejected at
        # the proposer's fence points even if its in-flight role checks
        # race a re-election.  Epochs live at term * EPOCH_TERM_STRIDE
        # plus a per-term fence count: a new election's term strictly
        # exceeds every persisted term, so post-restart epochs are
        # strictly above every pre-crash epoch (however many fences
        # inflated it, up to the stride) WITHOUT persisting the counter
        # itself — a stale pin can never collide across a restart.
        self.leadership_epoch = 0
        # observability tap: called as (member_id, role, term) on every
        # role transition.  The core stays sans-IO — embedders (RaftNode,
        # the sim's SimManager) point this at the flight recorder; the
        # callback must be non-throwing and side-effect-free w.r.t.
        # consensus state.
        self.on_transition: Optional[Callable[[str, str, int], None]] = None

        # log[0] corresponds to index snap_index+1
        self.log: List[Entry] = []
        self.snap_index = 0
        self.snap_term = 0
        self.commit_index = 0
        self.applied_index = 0

        self._elapsed = 0
        self._stepdown_ticks = 0
        self._timeout = self._rand_timeout()
        self._votes: Dict[str, bool] = {}
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        # index of the no-op appended at election: the leader is not ready
        # for proposals until it is applied (all prior-term entries are then
        # in the state machine — swarmkit's signalledLeadership gate)
        self.noop_index = 0

        self._msgs: List[Message] = []
        self._persisted_index = 0    # highest entry index known persisted
        self._hs_dirty = False
        self._pending_snapshot: Optional[Snapshot] = None
        # ---- read-index / lease state (etcd-raft readOnly + lease read).
        # The core stays sans-IO for consensus; the lease alone reads
        # wall/virtual time through the models.types.now() seam, because
        # a lease IS a clock claim ("no one can have been elected yet").
        #: seconds a quorum-acked heartbeat round extends the lease; the
        #: embedder sets this to (election_tick * tick_seconds) — it MUST
        #: stay below the minimum election timeout or the lease argument
        #: is void.  None disables the lease fast path (read-index only).
        self.lease_duration: Optional[float] = None
        #: fraction shaved off the lease for clock drift between members
        #: (the reference design's clock-drift safety margin)
        self.lease_drift_margin = 0.2
        #: embedder veto: when set and returning False, lease reads are
        #: refused (the sim wires this to "a clock-skew fault is active",
        #: which voids the lease math — election timers no longer run at
        #: spec rate).  None = no veto (production default).
        self.lease_gate: Optional[Callable[[], bool]] = None
        #: the clock the lease window is measured on.  Defaults to the
        #: models.types.now() seam (virtual under the sim — lease math
        #: must be a pure function of the seed there); production
        #: embedders (RaftNode) override it with a MONOTONIC clock: a
        #: backward wall-clock step (NTP) must shrink the lease to
        #: nothing, never extend it past the election timeout.
        self.lease_clock: Callable[[], float] = _now
        self._lease_expiry = 0.0
        #: local read-barrier results: read_seq -> (index, ok, lease)
        self.read_results: Dict[int, Tuple[int, bool, bool]] = {}
        #: called (read_seq, index, ok, lease) whenever a local read
        #: resolves — the driver completes its blocked readers here
        self.on_read_ready: Optional[
            Callable[[int, int, bool, bool], None]] = None
        #: plain tallies; embedders export them as metrics
        self.read_stats = {"lease_served": 0, "read_index_served": 0,
                           "lease_refused_gate": 0, "read_failed": 0}
        self._read_seq = 0           # local request ids (this member)
        self._read_ctx = 0           # heartbeat-round context (leader)
        self._read_acks: Dict[int, set] = {}
        self._hb_sent_at: Dict[int, float] = {}
        # (ctx, requester, read_seq, index): reads pinned to a round
        self._pending_reads: List[Tuple[int, str, int, int]] = []
        # check-quorum: a leader that cannot reach a majority steps down so
        # its blocked proposals fail fast (etcd-raft CheckQuorum behavior)
        self._quorum_elapsed = 0
        self._recent_active: set = set()
        # set once a committed conf change removes this member: the node
        # stops ticking/voting so it cannot disrupt the remaining cluster
        self.removed = False
        # single-conf-change-at-a-time guard (etcd pendingConfIndex)
        self.pending_conf_index = 0

    # ------------------------------------------------------------- log utils

    def last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self.last_index():
            return None
        return self.log[index - self.snap_index - 1].term

    def _entry_at(self, index: int) -> Entry:
        return self.log[index - self.snap_index - 1]

    def entries_from(self, index: int) -> List[Entry]:
        if index <= self.snap_index:
            return []
        return self.log[index - self.snap_index - 1:]

    def _rand_timeout(self) -> int:
        return self.election_tick + self._rng.randrange(self.election_tick)

    def step_down(self) -> None:
        """Leader voluntarily abdicates (demotion path).  Its own
        campaigns are suppressed for a bounded window so another peer wins
        the next election instead of this node flapping straight back into
        leadership (it usually has the most up-to-date log); the bound
        keeps a lone up-to-date survivor able to recover leadership if no
        other peer can win (reference: raft.go:1134 TransferLeadership
        targets a peer for the same reason)."""
        if self.role == LEADER:
            self._become_follower(self.term)
        self._stepdown_ticks = 10 * self.election_tick

    # --------------------------------------------------------------- loading

    def load(self, hard_state: HardState, entries: List[Entry],
             snapshot: Optional[Snapshot]) -> None:
        """Restore persisted state on restart (before any tick/step)."""
        if snapshot is not None:
            self.snap_index = snapshot.index
            self.snap_term = snapshot.term
            self.commit_index = snapshot.index
            self.applied_index = snapshot.index
            if snapshot.peers:
                self.peers = set(snapshot.peers)
            if snapshot.peer_addrs:
                self.peer_addrs = {k: tuple(v)
                                   for k, v in snapshot.peer_addrs.items()}
            if snapshot.api_addrs:
                self.api_addrs = {k: tuple(v)
                                  for k, v in snapshot.api_addrs.items()}
        self.term = hard_state.term
        self.voted_for = hard_state.voted_for
        # epoch floor: any election after this restart runs at a term —
        # and hence an epoch stride — above everything minted before
        # the crash
        self.leadership_epoch = max(self.leadership_epoch,
                                    hard_state.term * EPOCH_TERM_STRIDE)
        self.commit_index = max(self.commit_index, hard_state.commit)
        self.log = [e for e in entries if e.index > self.snap_index]
        self._persisted_index = self.last_index()

    # ----------------------------------------------------------------- ticks

    def tick(self) -> None:
        if self.removed:
            return
        if self.role == LEADER:
            self._elapsed += 1
            if self._elapsed >= self.heartbeat_tick:
                self._elapsed = 0
                self._broadcast_append(heartbeat=True)
            self._quorum_elapsed += 1
            if self._quorum_elapsed >= 2 * self.election_tick:
                self._quorum_elapsed = 0
                active = len(self._recent_active | {self.id})
                self._recent_active = set()
                if active <= len(self.peers) // 2:
                    self._become_follower(self.term)
        else:
            if self._stepdown_ticks > 0:
                self._stepdown_ticks -= 1
                self._elapsed = 0
                return
            self._elapsed += 1
            if self._elapsed >= self._timeout:
                if self.prevote and len(self.peers) > 1:
                    self._prevote_campaign()
                else:
                    self._campaign()

    def _prevote_campaign(self) -> None:
        """Probe for electability without mutating term/vote state."""
        self._in_prevote = True
        self._prevotes = {self.id: True}
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        for peer in sorted(self.peers):
            if peer == self.id:
                continue
            self._msgs.append(Message(
                type="prevote", term=self.term + 1, src=self.id, dst=peer,
                last_log_index=self.last_index(),
                last_log_term=self._term_at(self.last_index()) or 0))

    def _campaign(self) -> None:
        self._become_candidate()
        if len(self.peers) == 1:
            self._become_leader()
            return
        for peer in sorted(self.peers):
            if peer == self.id:
                continue
            self._msgs.append(Message(
                type="vote", term=self.term, src=self.id, dst=peer,
                last_log_index=self.last_index(),
                last_log_term=self._term_at(self.last_index()) or 0))

    # ------------------------------------------------------------ transitions

    def fence_epoch(self) -> None:
        """Invalidate every proposal created under the current epoch.
        Called automatically on deposal; role-transition handlers (the
        Manager, the sim's control plane) call it explicitly so their
        stop-the-loops path and the fence can never disagree."""
        self.leadership_epoch += 1

    def _become_follower(self, term: int, leader: str = "") -> None:
        role_changed = self.role != FOLLOWER
        if self.role == LEADER:
            # deposed: fence the reign's epoch so in-flight proposals
            # created under it fail even if this member is re-elected
            # before they reach a fence point
            self.fence_epoch()
            self._fail_pending_reads()
        if term > self.term:
            self.term = term
            self.voted_for = ""
            self._hs_dirty = True
        self.role = FOLLOWER
        self.leader_id = leader
        self._in_prevote = False
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        # only genuine role changes reach the tap: this path also runs
        # for term bumps while already a follower (every higher-term
        # message), which would flood the bounded raft ring
        if role_changed and self.on_transition is not None:
            self.on_transition(self.id, self.role, self.term)

    def _become_candidate(self) -> None:
        self.term += 1
        self.voted_for = self.id
        self._hs_dirty = True
        self._in_prevote = False
        self.role = CANDIDATE
        self.leader_id = ""
        self._votes = {self.id: True}
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        if self.on_transition is not None:
            self.on_transition(self.id, self.role, self.term)

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.id
        # a lease is earned per reign: the first quorum-acked heartbeat
        # round under THIS term starts it (a carried-over expiry could
        # overlap the previous leader's)
        self._lease_expiry = 0.0
        self._read_acks.clear()
        self._hb_sent_at.clear()
        self._pending_reads.clear()
        # mint a fresh leadership epoch.  max(): strictly greater than
        # every epoch this process ever minted or fenced, and — because
        # an election's term strictly exceeds every persisted term, and
        # a reign's fence bumps never reach the next term's stride —
        # strictly greater than any epoch minted before a crash-restart.
        self.leadership_epoch = max(self.leadership_epoch + 1,
                                    self.term * EPOCH_TERM_STRIDE)
        self._elapsed = 0
        last = self.last_index()
        for peer in self.peers:
            self.next_index[peer] = last + 1
            self.match_index[peer] = 0
        self.match_index[self.id] = last
        # no-op entry commits prior-term entries (raft thesis §3.6.2; etcd
        # does the same on election)
        self._append(Entry(term=self.term, index=last + 1,
                           type=ENTRY_NOOP))
        self.noop_index = last + 1
        if self.on_transition is not None:
            self.on_transition(self.id, self.role, self.term)
        self._broadcast_append()

    @property
    def leader_ready(self) -> bool:
        """True once this leader may accept proposals: its election no-op
        (and hence everything before it) has been applied locally."""
        return self.role == LEADER and self.applied_index >= self.noop_index

    # -------------------------------------------------------------- proposal

    def propose(self, data: bytes) -> int:
        """Leader-only: append a new entry; returns its index."""
        assert self.role == LEADER, "propose on non-leader"
        index = self.last_index() + 1
        self._append(Entry(term=self.term, index=index, data=data))
        self._broadcast_append()
        return index

    def propose_conf_change(self, op: str, member_id: str,
                            addr: Optional[Tuple[str, int]] = None,
                            api_addr: Optional[Tuple[str, int]] = None
                            ) -> int:
        """Leader-only membership change (reference: raft.go Join :926 /
        Leave :1138 propose ConfChange entries).  Single-change-at-a-time
        semantics: a second change is refused until the first has been
        APPLIED (etcd pendingConfIndex)."""
        import json as _json
        assert self.role == LEADER, "conf change on non-leader"
        if self.pending_conf_index > self.applied_index:
            raise RuntimeError(
                "a membership change is already in flight")
        index = self.last_index() + 1
        self.pending_conf_index = index
        change = {"op": op, "id": member_id}
        if addr is not None:
            change["addr"] = list(addr)
        if api_addr is not None:
            change["api_addr"] = list(api_addr)
        self._append(Entry(term=self.term, index=index,
                           data=_json.dumps(change).encode(),
                           type=ENTRY_CONF))
        self._broadcast_append()
        return index

    def apply_conf_change(self, op: str, member_id: str,
                          addr: Optional[Tuple[str, int]] = None,
                          api_addr: Optional[Tuple[str, int]] = None
                          ) -> None:
        """Called by the driver when an ENTRY_CONF commits."""
        if op == "add":
            self.peers.add(member_id)
            if addr is not None:
                self.peer_addrs[member_id] = tuple(addr)
            if api_addr is not None:
                self.api_addrs[member_id] = tuple(api_addr)
            if self.role == LEADER and member_id not in self.next_index:
                self.next_index[member_id] = self.last_index() + 1
                self.match_index[member_id] = 0
        elif op == "remove":
            self.peers.discard(member_id)
            self.peer_addrs.pop(member_id, None)
            self.api_addrs.pop(member_id, None)
            self.next_index.pop(member_id, None)
            self.match_index.pop(member_id, None)
            if member_id == self.id:
                # we were removed: stop participating entirely
                self.removed = True
                self._become_follower(self.term)
            elif self.role == LEADER:
                self._maybe_commit()  # quorum shrank

    def _append(self, entry: Entry) -> None:
        self.log.append(entry)
        self.match_index[self.id] = self.last_index()
        if len(self.peers) == 1:
            self._maybe_commit()

    # ----------------------------------------------------- linearizable reads
    #
    # Read-index protocol (raft thesis §6.4, etcd-raft ReadIndex): a
    # linearizable read needs the CURRENT leader's commit index, proven
    # current by one heartbeat quorum round; the reader then waits until
    # its local applied index passes that commit index.  The leader-lease
    # fast path skips the round while the lease from the last
    # quorum-acked heartbeat is still valid (minus a clock-drift margin):
    # no other member can have won an election inside that window.

    def lease_valid(self) -> bool:
        """True while the leader lease covers a quorum-free read."""
        if (self.role != LEADER or self.lease_duration is None
                or not self.leader_ready):
            return False
        if len(self.peers) == 1:
            return True
        return self.lease_clock() < self._lease_expiry

    def request_read(self) -> Optional[int]:
        """Begin a read-barrier request on ANY member; returns a
        ``read_seq`` whose result lands in ``read_results`` (and fires
        ``on_read_ready``), or None when no leader is known to ask."""
        self._read_seq += 1
        seq = self._read_seq
        if self.role == LEADER:
            self._serve_read_index(self.id, seq)
            return seq
        if not self.leader_id:
            self._read_seq -= 1
            return None
        self._msgs.append(Message(
            type="read_index", term=self.term, src=self.id,
            dst=self.leader_id, read_seq=seq))
        return seq

    def _serve_read_index(self, requester: str, read_seq: int) -> None:
        """Leader side of one read request (local or remote)."""
        if self.role != LEADER or not self.leader_ready:
            self._read_reply(requester, read_seq, 0, ok=False)
            return
        index = self.commit_index
        if len(self.peers) == 1:
            self.read_stats["read_index_served"] += 1
            self._read_reply(requester, read_seq, index, ok=True)
            return
        if self.lease_duration is not None \
                and self.lease_gate is not None and not self.lease_gate():
            # the embedder vetoed the lease (clock-skew fault active):
            # fall through to the full quorum round
            self.read_stats["lease_refused_gate"] += 1
        elif self.lease_valid():
            self.read_stats["lease_served"] += 1
            self._read_reply(requester, read_seq, index, ok=True,
                             lease=True)
            return
        ctx = self._read_ctx + 1
        self._pending_reads.append((ctx, requester, read_seq, index))
        self._broadcast_append(heartbeat=True)

    def _read_reply(self, requester: str, read_seq: int, index: int,
                    ok: bool, lease: bool = False) -> None:
        if requester == self.id or not requester:
            self.read_results[read_seq] = (index, ok, lease)
            if self.on_read_ready is not None:
                self.on_read_ready(read_seq, index, ok, lease)
            return
        self._msgs.append(Message(
            type="read_index_resp", term=self.term, src=self.id,
            dst=requester, read_seq=read_seq, read_index=index,
            success=ok, lease_read=lease))

    def _confirm_read_ctx(self, ctx: int) -> None:
        """A heartbeat round got its quorum: renew the lease from the
        round's SEND time (conservative — followers reset their election
        timers no earlier than that) and resolve every read pinned to
        this or an earlier round."""
        sent = self._hb_sent_at.get(ctx)
        if sent is not None and self.lease_duration is not None:
            self._lease_expiry = max(
                self._lease_expiry,
                sent + self.lease_duration * (1.0 - self.lease_drift_margin))
        # prune BOTH maps through ctx — a round whose every echo was
        # lost never shows up in _read_acks, and its _hb_sent_at entry
        # would otherwise outlive the reign (leak on a lossy link)
        for c in [c for c in self._read_acks if c <= ctx]:
            del self._read_acks[c]
        for c in [c for c in self._hb_sent_at if c <= ctx]:
            del self._hb_sent_at[c]
        still = []
        for (c, requester, seq, index) in self._pending_reads:
            if c <= ctx:
                self.read_stats["read_index_served"] += 1
                self._read_reply(requester, seq, index, ok=True)
            else:
                still.append((c, requester, seq, index))
        self._pending_reads = still

    def _fail_pending_reads(self) -> None:
        pending, self._pending_reads = self._pending_reads, []
        for (_c, requester, seq, _index) in pending:
            self.read_stats["read_failed"] += 1
            self._read_reply(requester, seq, 0, ok=False)
        self._read_acks.clear()
        self._hb_sent_at.clear()

    # -------------------------------------------------------------- messages

    def step(self, m: Message) -> None:
        if self.removed:
            return
        if m.src != self.id and m.src not in self.peers:
            # not (or no longer) a member: ignore — a removed node's
            # campaigns must not depose live leaders
            return
        if self.role == LEADER and m.src in self.peers:
            self._recent_active.add(m.src)
        if m.type in ("prevote", "prevote_resp"):
            # pre-vote rounds carry a FUTURE term the sender has not
            # adopted; they must never make the receiver step down or
            # adjust its own term (etcd-raft: pre-vote messages are
            # exempt from the term-advance rule)
            if m.type == "prevote":
                self._on_prevote(m)
            else:
                self._on_prevote_resp(m)
            return
        if m.term > self.term:
            leader = m.src if m.type in ("app", "snap") else ""
            self._become_follower(m.term, leader)
        if m.type == "vote":
            self._on_vote(m)
        elif m.type == "vote_resp":
            self._on_vote_resp(m)
        elif m.type == "app":
            self._on_append(m)
        elif m.type == "app_resp":
            self._on_append_resp(m)
        elif m.type == "snap":
            self._on_snapshot(m)
        elif m.type == "read_index":
            if self.role == LEADER:
                self._serve_read_index(m.src, m.read_seq)
            else:
                # not the leader anymore: refuse so the requester retries
                # against whoever leads now
                self._msgs.append(Message(
                    type="read_index_resp", term=self.term, src=self.id,
                    dst=m.src, read_seq=m.read_seq, success=False))
        elif m.type == "read_index_resp":
            self._on_read_index_resp(m)

    def _on_read_index_resp(self, m: Message) -> None:
        if m.success and m.term < self.term:
            # a stale leader's grant must not complete a barrier minted
            # under a newer view of the cluster; failures always deliver
            # (they only trigger a retry)
            return
        if not m.success:
            self.read_stats["read_failed"] += 1
        self.read_results[m.read_seq] = (m.read_index, m.success,
                                         m.lease_read)
        if self.on_read_ready is not None:
            self.on_read_ready(m.read_seq, m.read_index, m.success,
                               m.lease_read)

    def _on_prevote(self, m: Message) -> None:
        """Answer a pre-vote probe; grants mutate NO local state.  Grant
        only when (a) the proposed term is ahead of ours, (b) the
        candidate's log is at least as up-to-date, and (c) our leader
        lease has lapsed — i.e. we have not heard from a live leader
        within an election timeout (leader stickiness, the property that
        stops a healed rejoiner from deposing a healthy leader)."""
        my_last = self.last_index()
        my_last_term = self._term_at(my_last) or 0
        up_to_date = (m.last_log_term, m.last_log_index) >= \
            (my_last_term, my_last)
        if self.role == LEADER:
            # a live leader never grants: check-quorum demotes it first
            # if it actually lost its majority
            lease_lapsed = False
        else:
            lease_lapsed = (self.leader_id == ""
                            or self._elapsed >= self.election_tick)
        grant = m.term > self.term and up_to_date and lease_lapsed
        self._msgs.append(Message(type="prevote_resp", term=m.term,
                                  src=self.id, dst=m.src, granted=grant))

    def _on_prevote_resp(self, m: Message) -> None:
        if not self._in_prevote or m.term != self.term + 1:
            return
        self._prevotes[m.src] = m.granted
        granted = sum(1 for g in self._prevotes.values() if g)
        if granted > len(self.peers) // 2:
            # a majority would vote for us: run the real election
            self._in_prevote = False
            self._campaign()
        elif len(self._prevotes) - granted > len(self.peers) // 2:
            # majority rejected: stand down without having disturbed
            # anyone's term; retry on the next timeout
            self._in_prevote = False

    def _on_vote(self, m: Message) -> None:
        if m.term < self.term:
            self._msgs.append(Message(type="vote_resp", term=self.term,
                                      src=self.id, dst=m.src, granted=False))
            return
        my_last = self.last_index()
        my_last_term = self._term_at(my_last) or 0
        up_to_date = (m.last_log_term, m.last_log_index) >= \
            (my_last_term, my_last)
        grant = (self.voted_for in ("", m.src)) and up_to_date
        if grant:
            self.voted_for = m.src
            self._hs_dirty = True
            self._elapsed = 0
        self._msgs.append(Message(type="vote_resp", term=self.term,
                                  src=self.id, dst=m.src, granted=grant))

    def _on_vote_resp(self, m: Message) -> None:
        if self.role != CANDIDATE or m.term < self.term:
            return
        self._votes[m.src] = m.granted
        granted = sum(1 for g in self._votes.values() if g)
        if granted > len(self.peers) // 2:
            self._become_leader()
        elif len(self._votes) - granted > len(self.peers) // 2:
            self._become_follower(self.term)

    def _on_append(self, m: Message) -> None:
        if m.term < self.term:
            self._msgs.append(Message(type="app_resp", term=self.term,
                                      src=self.id, dst=m.src, success=False))
            return
        if self.role != FOLLOWER and self.on_transition is not None:
            # only genuine role changes reach the tap — this runs on
            # every heartbeat, and a steady-state follower is not news
            self.on_transition(self.id, FOLLOWER, self.term)
        self.role = FOLLOWER
        self.leader_id = m.src
        self._elapsed = 0
        # a live leader cancels any pre-vote round in flight: a stale
        # grant arriving after this heartbeat must not start a real
        # campaign (etcd-raft clears pre-vote state on leader contact)
        self._in_prevote = False

        prev_term = self._term_at(m.prev_index)
        if prev_term is None or (m.prev_index > 0
                                 and prev_term != m.prev_term):
            # log mismatch: ask the leader to back up.  The read context
            # is still echoed — a mismatching follower has accepted this
            # leader for the term, which is all a read quorum needs.
            self._msgs.append(Message(
                type="app_resp", term=self.term, src=self.id, dst=m.src,
                success=False,
                match_index=min(m.prev_index - 1, self.last_index()),
                read_ctx=m.read_ctx))
            return
        # append, truncating conflicts
        for e in m.entries:
            existing = self._term_at(e.index)
            if existing is None or existing != e.term:
                if e.index <= self.last_index():
                    # conflict: truncate from here
                    del self.log[e.index - self.snap_index - 1:]
                    self._persisted_index = min(self._persisted_index,
                                                self.last_index())
                self.log.append(e)
        # commit may only advance over entries this append VERIFIED to
        # match the leader (up to prev_index + new entries) — never over
        # untruncated local tail entries (raft paper fig. 2: AppendEntries
        # step 5, "index of last new entry")
        last_new = m.prev_index + len(m.entries)
        if m.commit > self.commit_index:
            self.commit_index = min(m.commit, last_new)
            self._hs_dirty = True
        self._msgs.append(Message(
            type="app_resp", term=self.term, src=self.id, dst=m.src,
            success=True, match_index=max(last_new, self.commit_index),
            read_ctx=m.read_ctx))

    def _on_append_resp(self, m: Message) -> None:
        if self.role != LEADER or m.term < self.term:
            return
        if m.read_ctx:
            # read-quorum accounting: success is irrelevant — any echo at
            # our term is an acceptance of this leadership
            acks = self._read_acks.setdefault(m.read_ctx, set())
            acks.add(m.src)
            if len(acks | {self.id}) > len(self.peers) // 2:
                self._confirm_read_ctx(m.read_ctx)
        if m.success:
            self.match_index[m.src] = max(self.match_index.get(m.src, 0),
                                          m.match_index)
            self.next_index[m.src] = self.match_index[m.src] + 1
            self._maybe_commit()
            if self.next_index[m.src] <= self.last_index():
                # follower acked a heartbeat but is missing entries
                # (e.g. rejoined after a partition): repair now
                self._send_append(m.src)
        else:
            hint = m.match_index
            self.next_index[m.src] = max(1, min(
                hint + 1, self.next_index.get(m.src, 1) - 1))
            self._send_append(m.src)

    def _on_snapshot(self, m: Message) -> None:
        if m.term < self.term or m.snapshot is None:
            return
        if self.role != FOLLOWER and self.on_transition is not None:
            self.on_transition(self.id, FOLLOWER, self.term)
        self.role = FOLLOWER
        self.leader_id = m.src
        self._elapsed = 0
        self._in_prevote = False
        snap = m.snapshot
        if snap.index <= self.commit_index:
            # stale snapshot; report progress instead
            self._msgs.append(Message(
                type="app_resp", term=self.term, src=self.id, dst=m.src,
                success=True, match_index=self.commit_index))
            return
        self._pending_snapshot = snap
        self.snap_index = snap.index
        self.snap_term = snap.term
        if snap.peers:
            self.peers = set(snap.peers)
        self.log = []
        self.commit_index = snap.index
        self.applied_index = snap.index
        self._persisted_index = snap.index
        self._hs_dirty = True
        self._msgs.append(Message(
            type="app_resp", term=self.term, src=self.id, dst=m.src,
            success=True, match_index=snap.index))

    # ------------------------------------------------------------ replication

    def _maybe_commit(self) -> None:
        for n in range(self.last_index(), self.commit_index, -1):
            if (self._term_at(n) == self.term
                    and sum(1 for p in self.peers
                            if self.match_index.get(p, 0) >= n)
                    > len(self.peers) // 2):
                self.commit_index = n
                self._hs_dirty = True
                break

    def _broadcast_append(self, heartbeat: bool = False) -> None:
        # every broadcast round doubles as a leadership proof: it carries
        # a read-index context the followers echo on success, so the
        # quorum count confirms pending reads and renews the lease
        self._read_ctx += 1
        ctx = self._read_ctx
        self._hb_sent_at[ctx] = self.lease_clock()
        # sorted: message emission order must be a pure function of state,
        # not of str-hash-seeded set order, so the deterministic simulator
        # gets identical traces across processes
        for peer in sorted(self.peers):
            if peer != self.id:
                self._send_append(peer, heartbeat=heartbeat, ctx=ctx)

    def _send_append(self, peer: str, heartbeat: bool = False,
                     ctx: int = 0) -> None:
        next_i = self.next_index.get(peer, self.last_index() + 1)
        if next_i <= self.snap_index:
            # follower is behind our log start: needs a snapshot; the
            # driver fills in the snapshot data (we only know the index)
            self._msgs.append(Message(
                type="snap", term=self.term, src=self.id, dst=peer,
                snapshot=Snapshot(index=self.snap_index,
                                  term=self.snap_term)))
            return
        prev = next_i - 1
        entries = [] if heartbeat else self.entries_from(next_i)
        self._msgs.append(Message(
            type="app", term=self.term, src=self.id, dst=peer,
            prev_index=prev, prev_term=self._term_at(prev) or 0,
            entries=list(entries), commit=self.commit_index,
            read_ctx=ctx))

    # ----------------------------------------------------------------- ready

    def has_ready(self) -> bool:
        return bool(self._msgs or self._hs_dirty
                    or self._pending_snapshot is not None
                    or self.last_index() > self._persisted_index
                    or self.commit_index > self.applied_index)

    def ready(self) -> Ready:
        hs = None
        if self._hs_dirty:
            hs = HardState(term=self.term, voted_for=self.voted_for,
                           commit=self.commit_index)
        new_entries = self.entries_from(self._persisted_index + 1)
        # only committed entries that are also persisted locally are applied
        apply_upto = min(self.commit_index,
                         max(self._persisted_index, self.last_index()))
        committed = [self._entry_at(i)
                     for i in range(self.applied_index + 1, apply_upto + 1)
                     if self._term_at(i) is not None]
        msgs, self._msgs = self._msgs, []
        snap, self._pending_snapshot = self._pending_snapshot, None
        return Ready(hard_state=hs, entries=list(new_entries),
                     messages=msgs, committed=committed, snapshot=snap)

    def advance(self, rd: Ready) -> None:
        if rd.hard_state is not None:
            self._hs_dirty = False
        if rd.entries:
            self._persisted_index = max(self._persisted_index,
                                        rd.entries[-1].index)
        if rd.committed:
            self.applied_index = max(self.applied_index,
                                     rd.committed[-1].index)
        if rd.snapshot is not None:
            self.applied_index = max(self.applied_index, rd.snapshot.index)

    # ------------------------------------------------------------ compaction

    def compact(self, index: int, snapshot_term: Optional[int] = None) -> None:
        """Drop log entries up to ``index`` (inclusive); the driver has a
        durable snapshot at that index."""
        if index <= self.snap_index:
            return
        term = snapshot_term if snapshot_term is not None \
            else self._term_at(index)
        self.log = self.entries_from(index + 1)
        self.snap_index = index
        self.snap_term = term or 0
