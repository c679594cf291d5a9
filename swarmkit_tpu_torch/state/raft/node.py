"""RaftNode: drives the consensus core, persists through the logger, and
implements the store's Proposer seam.

Reference: manager/state/raft/raft.go (Node.Run Ready loop :540,
ProposeValue :1592 / processInternalRaftRequest :1785, processCommitted
:1890) and manager/state/proposer.go.

Wiring: every member owns a MemoryStore.  The leader's store proposes
change-lists here; ``propose`` blocks until the entry commits, then the
leader's store applies locally (MemoryStore.update's normal flow).
Followers apply committed entries via ``apply_store_actions`` — identical
bytes, identical version stamps, so all stores converge bit-for-bit.
Snapshots carry the full store (store.save_bytes) and are installed on
slow/new followers.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ...utils.metrics import registry as _metrics
from .. import serde
from ..store import MemoryStore, Proposer, StoreAction
from .core import (
    ENTRY_CONF, ENTRY_NOOP, Entry, HardState, LEADER, Message, RaftCore,
    Snapshot,
)
from .storage import RaftLogger

log = logging.getLogger("raft")

# cached Timer references (Registry.reset() resets these in place, so
# holding them is safe); apply runs once per committed entry
_APPLY_TIMER = _metrics.timer("swarm_raft_apply_latency")
_PROPOSE_TIMER = _metrics.timer("swarm_raft_propose_latency")
_READ_INDEX_TIMER = _metrics.timer("swarm_read_index_latency")


class NotLeader(Exception):
    """Proposal sent to a non-leader member."""


class ReadUnavailable(Exception):
    """A linearizable read barrier could not be confirmed in time (no
    reachable leader, or this member could not catch up to the barrier
    index).  Retry against another member — the data was never served
    stale."""


class StaleEpoch(NotLeader):
    """Proposal carries a leadership epoch that has been fenced."""


class ProposalDropped(Exception):
    """Leadership was lost before the proposal committed."""


@dataclass
class _Waiter:
    event: threading.Event
    term: int
    index: int
    ok: bool = False
    commit_cb: Optional[Callable[[], None]] = None
    t0: float = 0.0   # propose_async submit time (propose-latency timer)
    # leadership epoch the proposal was created under; checked against
    # the core's current epoch pre-WAL and at commit-callback delivery
    epoch: int = -1


class RaftNode(Proposer):
    """One consensus member (reference: raft.Node)."""

    TICK_INTERVAL = 0.02

    def __init__(self, node_id: str, peers: Sequence[str],
                 store: MemoryStore, logger: RaftLogger, transport,
                 snapshot_interval: int = 1000,
                 on_leadership: Optional[Callable[[bool], None]] = None,
                 force_new_cluster: bool = False,
                 tick_interval: Optional[float] = None):
        self.id = node_id
        self.store = store
        self.logger = logger
        self.transport = transport
        self.snapshot_interval = snapshot_interval
        self.on_leadership = on_leadership
        # injectable tick pacing (tests/simulation shrink it; the
        # deterministic simulator bypasses this thread entirely and
        # drives RaftCore ticks itself)
        self.tick_interval = (tick_interval if tick_interval is not None
                              else self.TICK_INTERVAL)
        self.core = RaftCore(node_id, peers)
        # black-box the role history: every transition (with term) lands
        # in the flight recorder's bounded ring for post-mortems
        from ...obs.flightrec import flightrec
        self.core.on_transition = flightrec.record_raft
        # leader-lease sizing: one election timeout of real time, margin
        # already shaved inside the core (lease_drift_margin).  The
        # lease window is measured on the MONOTONIC clock: a backward
        # wall-clock step (NTP) must never extend a lease past the
        # election timeout, it can only shorten it.
        self.core.lease_duration = \
            self.core.election_tick * (tick_interval if tick_interval
                                       is not None else self.TICK_INTERVAL)
        # monotonic by design, see above
        # swarmlint: disable=determinism-seam
        self.core.lease_clock = time.monotonic
        self.core.on_read_ready = self._on_read_ready

        self._inbox: "queue.Queue" = queue.Queue()
        # plane saturation probes (obs/planes.py): inbox depth is the
        # commit plane's queue, commit-applied lag is the apply plane's.
        # Pulled at roll time — the hot paths stay untouched; weakref so
        # a probe never pins a stopped node.  With co-resident nodes
        # (HA tests) the last-constructed node owns the probe;
        # production runs one node per process.
        import weakref
        from ...obs import planes as _planes
        _ref = weakref.ref(self)
        _planes.plane(_planes.RAFT).set_probe(
            lambda: ({"depth": float(_ref()._inbox.qsize())}
                     if _ref() is not None else {}))
        _planes.plane(_planes.RAFT_APPLY).set_probe(
            lambda: ({"depth": float(max(
                0, _ref().core.commit_index - _ref().core.applied_index))}
                if _ref() is not None else {}))
        self._waiters: Dict[int, _Waiter] = {}
        self._waiters_lock = threading.Lock()
        self._read_waiters: Dict[int, dict] = {}
        self._read_submitting = False   # raft-thread-only flag
        self._local_indices: set = set()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._was_leader = False
        self._last_snap_applied = 0
        self.stats = {"applied": 0, "snapshots": 0,
                      "stale_epoch_rejects": 0}

        # boot from disk (reference: JoinAndStart -> BootstrapFromDisk)
        hs, entries, snapshot = logger.bootstrap()
        if snapshot is not None and snapshot.data:
            self.store.restore_bytes(snapshot.data)
            self._last_snap_applied = snapshot.index
        self.core.load(hs, entries, snapshot)
        # replay committed-but-unapplied log entries into the store
        for e in self.core.entries_from(self.core.applied_index + 1):
            if e.index > self.core.commit_index:
                break
            self._apply_entry(e, replay=True)
            self.core.applied_index = e.index

        if force_new_cluster:
            # quorum-loss recovery (reference: manager.go:99-101
            # --force-new-cluster): keep the replayed store state but
            # collapse membership to this node alone, then snapshot so a
            # later restart cannot resurrect the dead peers from old
            # conf entries
            log.warning("force-new-cluster: collapsing membership "
                        "%s -> {%s}", sorted(self.core.peers), node_id)
            self.core.peers = {node_id}
            self.core.peer_addrs = {
                k: v for k, v in self.core.peer_addrs.items()
                if k == node_id}
            self.core.api_addrs = {
                k: v for k, v in self.core.api_addrs.items()
                if k == node_id}
            self.core.removed = False
            # drop uncommitted tail entries: as a sole leader this node
            # would otherwise commit them next term, potentially
            # re-adding the dead peers via stale conf changes
            self.core.log = [e for e in self.core.log
                             if e.index <= self.core.commit_index]
            index = self.core.applied_index
            snap = Snapshot(
                index=index, term=self.core._term_at(index) or 0,
                data=self.store.save_bytes(),
                peers=sorted(self.core.peers),
                peer_addrs=dict(self.core.peer_addrs),
                api_addrs=dict(self.core.api_addrs))
            self.logger.save_snapshot(snap, index)
            # save_snapshot rewrites the WAL from DISK, which still
            # carries the dropped tail; force the on-disk log to match
            # the truncated in-memory one or a crash-before-next-append
            # restart would resurrect the stale conf entries
            from .core import HardState as _HS
            self.logger.rewrite(
                _HS(term=self.core.term, voted_for=self.core.voted_for,
                    commit=self.core.commit_index),
                self.core.log, keep_entries_from=index)
            self.core.compact(index, snap.term)

        self._sync_transport_from_core()
        transport.register(node_id, self._inbox.put)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name=f"raft-{self.id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:   # never started: nothing to wait on
            self._done.wait(timeout=10)
        self.transport.unregister(self.id)
        self.logger.close()
        self._fail_waiters()

    @property
    def is_leader(self) -> bool:
        return self.core.role == LEADER

    @property
    def leadership_epoch(self) -> int:
        """Current fencing token (see RaftCore.leadership_epoch).  The
        store pins multi-proposal commits (chunked block commits, the
        scheduler's pipelined drafts) to the epoch read here so none of
        their chunks can land across a role change."""
        return self.core.leadership_epoch

    @property
    def leader_id(self) -> str:
        return self.core.leader_id

    def run(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = self._inbox.get(timeout=self.tick_interval)
                except queue.Empty:
                    item = None
                if item is None:
                    self.core.tick()
                elif isinstance(item, Message):
                    self.core.step(item)
                elif isinstance(item, tuple):   # local proposal/command
                    self._handle_proposal(*item)
                # drain any further queued items before processing ready
                while True:
                    try:
                        item = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(item, Message):
                        self.core.step(item)
                    elif isinstance(item, tuple):
                        self._handle_proposal(*item)

                if self._was_leader and self.core.role != LEADER:
                    # fail blocked proposers NOW, before applying anything:
                    # apply_store_actions/restore need the store update
                    # lock a blocked proposer may hold
                    self._fail_waiters()
                self._process_ready()
                self._leadership_change()
        finally:
            self._done.set()

    def _handle_proposal(self, *item) -> None:
        if item[0] == "stepdown":
            if self.core.role == LEADER:
                self.core.step_down()
            return
        if item[0] == "read":
            _, slot, ev = item
            # the flag marks the synchronous-resolution window: a
            # callback firing inside request_read must leave the result
            # in core.read_results for the pop below (raft thread only)
            self._read_submitting = True
            try:
                seq = self.core.request_read()
            finally:
                self._read_submitting = False
            if seq is None:
                # no known leader to ask; the caller backs off and retries
                slot["ok"] = False
                ev.set()
                return
            res = self.core.read_results.pop(seq, None)
            if res is not None:
                # resolved synchronously (lease / single-member fast path)
                slot["index"], slot["ok"], slot["lease"] = res
                ev.set()
            else:
                with self._waiters_lock:
                    self._read_waiters[seq] = (slot, ev)
            return
        if item[0] == "conf":
            _, op, member_id, addr, api_addr, waiter = item
            if not self.core.leader_ready:
                waiter.ok = False
                waiter.event.set()
                return
            try:
                index = self.core.propose_conf_change(op, member_id, addr,
                                                      api_addr)
            except RuntimeError:
                # a membership change is already in flight: fail this
                # waiter (callers retry); never let the error kill the
                # raft event loop
                waiter.ok = False
                waiter.event.set()
                return
            waiter.term = self.core.term
            waiter.index = index
            self._local_indices.add(index)
            with self._waiters_lock:
                self._waiters[index] = waiter
            return
        data, waiter = item
        # pre-WAL fence: this runs on the raft thread — the same thread
        # that applies role transitions — so the check cannot race a
        # deposal/re-election: a proposal created under a fenced epoch is
        # rejected HERE, before it is appended (and therefore before it
        # can ever be serialized into the WAL or replicated)
        if not self.core.leader_ready \
                or waiter.epoch != self.core.leadership_epoch:
            if self.core.role == LEADER \
                    and waiter.epoch != self.core.leadership_epoch:
                self.stats["stale_epoch_rejects"] += 1
                _metrics.counter("swarm_raft_stale_epoch_rejects")
                log.warning(
                    "pre-WAL fence: proposal epoch %d != current %d",
                    waiter.epoch, self.core.leadership_epoch)
            waiter.ok = False
            waiter.event.set()
            return
        index = self.core.propose(data)
        waiter.term = self.core.term
        waiter.index = index
        self._local_indices.add(index)
        with self._waiters_lock:
            self._waiters[index] = waiter

    def _process_ready(self) -> None:
        while self.core.has_ready():
            rd = self.core.ready()
            # 1. persist before anything else (the fsync batch: its
            # share of wall time is the raft plane's occupancy)
            _save_t0 = time.perf_counter()
            self.logger.save(rd.hard_state, rd.entries)
            from ...obs import planes as _planes
            _planes.plane(_planes.RAFT).note_busy(
                time.perf_counter() - _save_t0)
            if rd.snapshot is not None and rd.snapshot.data:
                self.logger.save_snapshot(rd.snapshot, rd.snapshot.index)
                self.store.restore_bytes(rd.snapshot.data)
                self._last_snap_applied = rd.snapshot.index
                self.stats["snapshots"] += 1
                self._sync_transport_from_core()
            # 2. send messages (attach snapshot payloads)
            for m in rd.messages:
                if m.type == "snap" and m.snapshot is not None \
                        and not m.snapshot.data:
                    try:
                        snap = self.logger.load_snapshot()
                    except OSError:
                        # transient read error (load_snapshot propagates
                        # I/O errors rather than quarantining): skip this
                        # send — the follower's next rejection retries it
                        log.exception("snapshot read failed; send skipped")
                        continue
                    if snap is None:
                        continue
                    m.snapshot = snap
                self.transport.send(m)
            # 3. apply committed entries
            for e in rd.committed:
                self._apply_entry(e)
            self.core.advance(rd)
            if rd.committed:
                self._maybe_snapshot()

    # -------------------------------------------------------------- applying

    def _sync_transport_peer(self, op: str, member_id: str, addr) -> None:
        """Keep the transport's dialing table in lockstep with replicated
        membership, so every member can reach every other after leader
        failures and restarts (addresses arrive via conf entries and
        snapshots, not just via whoever served the join RPC)."""
        if member_id == self.id:
            return
        if op == "add" and addr and hasattr(self.transport, "set_peer"):
            self.transport.set_peer(member_id, tuple(addr))
        elif op == "remove" and hasattr(self.transport, "remove_peer"):
            self.transport.remove_peer(member_id)

    def _sync_transport_from_core(self) -> None:
        if hasattr(self.transport, "set_peer"):
            for nid, addr in self.core.peer_addrs.items():
                if nid != self.id:
                    self.transport.set_peer(nid, tuple(addr))

    def _apply_entry(self, e: Entry, replay: bool = False) -> None:
        if e.type == ENTRY_CONF:
            import json as _json
            try:
                change = _json.loads(e.data)
                addr = change.get("addr")
                api_addr = change.get("api_addr")
                self.core.apply_conf_change(
                    change["op"], change["id"],
                    tuple(addr) if addr else None,
                    tuple(api_addr) if api_addr else None)
                self._sync_transport_peer(change["op"], change["id"], addr)
                log.info("membership change applied: %s %s",
                         change["op"], change["id"])
            except Exception:
                log.exception("applying conf change failed")
            with self._waiters_lock:
                waiter = self._waiters.pop(e.index, None)
            self._local_indices.discard(e.index)
            if waiter is not None and not replay:
                waiter.ok = True
                waiter.event.set()
            return
        if e.type == ENTRY_NOOP or not e.data:
            return
        self.stats["applied"] += 1
        _metrics.counter("swarm_raft_entries_applied")
        _apply_t0 = time.perf_counter()
        local = e.index in self._local_indices
        if local:
            self._local_indices.discard(e.index)
        if local and not replay:
            # run the proposing store's commit callback *here*, in the
            # apply path, before appliedIndex advances — snapshots taken at
            # this index must include this entry's changes (reference:
            # wait.trigger runs the commit cb inside processEntry,
            # raft.go:1917)
            with self._waiters_lock:
                waiter = self._waiters.pop(e.index, None)
            if waiter is not None \
                    and waiter.epoch != self.core.leadership_epoch:
                # commit-callback fence: the entry committed, but the
                # reign that created it is over (fenced epoch).  The
                # proposer must observe failure — its commit callback
                # (store-side success path) must NOT run — while the
                # store still converges by applying the entry below
                # exactly like a follower would.
                self.stats["stale_epoch_rejects"] += 1
                _metrics.counter("swarm_raft_stale_epoch_rejects")
                log.warning(
                    "commit fence: entry %d epoch %d != current %d",
                    e.index, waiter.epoch, self.core.leadership_epoch)
                waiter.ok = False
                waiter.event.set()
                waiter = None
            if waiter is not None:
                ok = True
                if waiter.commit_cb is not None:
                    try:
                        waiter.commit_cb()
                    except Exception:
                        # contract: on failure propose must raise — never
                        # report success for an uncommitted local tx
                        log.exception("local commit callback failed")
                        ok = False
                waiter.ok = ok
                waiter.event.set()
                _dt = time.perf_counter() - _apply_t0
                _APPLY_TIMER.observe(_dt)
                from ...obs import planes as _planes
                _planes.plane(_planes.RAFT_APPLY).note_busy(_dt)
                return
            # the waiter was cancelled (leadership churn) but the entry
            # committed anyway: apply it like a remote entry so this store
            # does not diverge from the cluster (reference: processEntry's
            # no-wait branch, raft.go:1907)
        try:
            actions = serde.entry_to_actions(e.data)
            self.store.apply_store_actions(actions)
        except Exception:
            log.exception("applying raft entry %d failed", e.index)
        _dt = time.perf_counter() - _apply_t0
        _APPLY_TIMER.observe(_dt)
        from ...obs import planes as _planes
        _planes.plane(_planes.RAFT_APPLY).note_busy(_dt)

    def _maybe_snapshot(self) -> None:
        """reference: raft.go:781 needsSnapshot + doSnapshot."""
        if self.core.applied_index - self.core.snap_index \
                < self.snapshot_interval:
            return
        index = self.core.applied_index
        snap = Snapshot(index=index, term=self.core._term_at(index) or 0,
                        data=self.store.save_bytes(),
                        peers=sorted(self.core.peers),
                        peer_addrs=dict(self.core.peer_addrs),
                        api_addrs=dict(self.core.api_addrs))
        self.logger.save_snapshot(snap, index)
        self.core.compact(index, snap.term)
        self.stats["snapshots"] += 1

    def _leadership_change(self) -> None:
        leader = self.core.role == LEADER
        if leader != self._was_leader:
            self._was_leader = leader
            if not leader:
                self._fail_waiters()
            if self.on_leadership is not None:
                try:
                    self.on_leadership(leader)
                except Exception:
                    log.exception("leadership callback failed")

    def _fail_waiters(self) -> None:
        with self._waiters_lock:
            waiters, self._waiters = self._waiters, {}
            read_waiters, self._read_waiters = self._read_waiters, {}
        for w in waiters.values():
            w.ok = False
            w.event.set()
        for slot, ev in read_waiters.values():
            slot["ok"] = False
            ev.set()

    # ---------------------------------------------------- linearizable reads

    def _on_read_ready(self, seq: int, index: int, ok: bool,
                       lease: bool) -> None:
        """Core callback (raft thread): a read-barrier request resolved."""
        with self._waiters_lock:
            w = self._read_waiters.pop(seq, None)
        if w is None:
            if not self._read_submitting:
                # nobody is waiting (the reader timed out or a
                # leadership change failed its waiter) and this is not
                # the synchronous-resolution window: drop the orphaned
                # result or it leaks for the process lifetime
                self.core.read_results.pop(seq, None)
            # else: resolved synchronously inside request_read — the
            # inbox handler reads it straight out of core.read_results
            return
        self.core.read_results.pop(seq, None)
        slot, ev = w
        slot["index"], slot["ok"], slot["lease"] = index, ok, lease
        ev.set()

    def read_barrier(self, timeout: float = 10.0) -> int:
        """Linearizable read barrier (raft thesis §6.4): returns once this
        member's applied state includes everything committed cluster-wide
        at the moment of the call — served off the leader lease when
        valid, a read-index heartbeat quorum round otherwise.  Callable
        on ANY member; followers ask the leader for the confirmed commit
        index and wait until their applied index passes it.  Raises
        ReadUnavailable when no leader confirms within ``timeout`` —
        degraded, never stale.  MUST NOT be called while holding the
        store's locks (swarmlint lock-discipline enforces this)."""
        t0 = time.perf_counter()
        deadline = t0 + timeout
        slot: dict = {}
        while True:
            slot = {}
            ev = threading.Event()
            self._inbox.put(("read", slot, ev))
            ev.wait(timeout=max(0.001, deadline - time.perf_counter()))
            if ev.is_set() and slot.get("ok"):
                break
            if time.perf_counter() >= deadline:
                _metrics.counter('swarm_lease_reads{result="unavailable"}')
                raise ReadUnavailable(
                    f"{self.id}: no leader confirmed a read barrier "
                    f"within {timeout:.1f}s")
            # refused (leaderless gap / churn): brief backoff, retry
            self._stop.wait(timeout=0.01)
        index = slot["index"]
        while self.core.applied_index < index:
            if time.perf_counter() >= deadline:
                _metrics.counter('swarm_lease_reads{result="lagging"}')
                raise ReadUnavailable(
                    f"{self.id}: applied index {self.core.applied_index} "
                    f"never reached the barrier {index}")
            self._stop.wait(timeout=0.002)
        _READ_INDEX_TIMER.observe(time.perf_counter() - t0)
        _metrics.counter('swarm_lease_reads{result="lease"}'
                         if slot.get("lease")
                         else 'swarm_lease_reads{result="read_index"}')
        # one consistent meaning everywhere: "was the last read served
        # off a lease" — on a follower the LEADER's lease answers its
        # read_index request, and the resp's lease flag carries that
        _metrics.gauge("swarm_lease_enabled",
                       1.0 if slot.get("lease") else 0.0)
        return index

    # ------------------------------------------------------------ membership

    def _propose_conf(self, op: str, member_id: str, addr=None,
                      api_addr=None) -> None:
        if not self.core.leader_ready:
            raise NotLeader(f"{self.id} is not a ready leader")
        waiter = _Waiter(event=threading.Event(), term=self.core.term,
                        index=0)
        self._inbox.put(("conf", op, member_id, addr, api_addr, waiter))
        waiter.event.wait(timeout=10)
        if not waiter.ok:
            raise ProposalDropped("membership change dropped")

    def step_down(self) -> None:
        """Voluntarily relinquish leadership (used before self-demotion;
        reference: raft.go:1225 TransferLeadership)."""
        self._inbox.put(("stepdown",))

    def add_member(self, member_id: str, addr=None,
                   api_addr=None) -> None:
        """Leader-side join (reference: raft.go:926 Join).  ``addr`` is
        the member's raft transport address and ``api_addr`` its remote
        API address; both replicate with the conf entry so every member
        can dial the newcomer and agents can fail over to it."""
        self._propose_conf("add", member_id, addr, api_addr)

    def remove_member(self, member_id: str) -> None:
        """Leader-side leave/demote (reference: raft.go:1138 Leave)."""
        self._propose_conf("remove", member_id)

    # -------------------------------------------------------------- proposer

    def propose_async(self, actions: Sequence[StoreAction],
                      commit_cb=None, epoch: Optional[int] = None
                      ) -> _Waiter:
        """Submit a proposal without waiting for consensus: serialize on
        the caller's thread, enqueue to the raft loop, return the waiter.
        Proposals submitted from one thread are appended to the log (and
        therefore committed and applied) in submission order — the
        ordering guarantee the store's chunk-pipelined block commits rely
        on.  Pair every returned waiter with ``wait_proposal``: the
        commit callback runs in the apply path regardless, but success or
        failure is only observable through the wait.

        ``epoch`` pins the proposal to a leadership epoch captured
        earlier (``leadership_epoch``): a multi-proposal commit passes
        the epoch it started under so no chunk can be created — let
        alone land — after a role change.  A stale pin is rejected here,
        before serialization; None stamps the current epoch."""
        if self.core.role != LEADER:
            raise NotLeader(f"{self.id} is not the leader")
        cur = self.core.leadership_epoch
        if epoch is None:
            epoch = cur
        elif epoch != cur:
            # pre-serialization fence: the reign this commit belongs to
            # is already over
            self.stats["stale_epoch_rejects"] += 1
            _metrics.counter("swarm_raft_stale_epoch_rejects")
            raise StaleEpoch(
                f"{self.id}: proposal epoch {epoch} fenced "
                f"(current {cur})")
        t0 = time.perf_counter()
        # columnar block commits serialize to the compact binary form
        # (decoded natively on every member); other change lists keep
        # the JSON form — one shared grammar (serde.entry_to_actions)
        data = serde.actions_to_entry_data(actions)
        waiter = _Waiter(event=threading.Event(), term=self.core.term,
                         index=0, commit_cb=commit_cb, t0=t0,
                         epoch=epoch)
        self._inbox.put((data, waiter))
        return waiter

    def wait_proposal(self, waiter: _Waiter) -> None:
        """Block until a ``propose_async`` proposal commits (commit_cb
        already ran in the apply path) or fails; raises ProposalDropped
        on leadership loss (no internal timeout by design,
        design/raft.md:215)."""
        waiter.event.wait()
        # serialize -> consensus round -> apply-path commit, end to end
        _PROPOSE_TIMER.observe(time.perf_counter() - waiter.t0)
        if not waiter.ok:
            raise ProposalDropped(
                "raft proposal dropped (leadership change)")

    def propose(self, actions: Sequence[StoreAction],
                commit_cb=None, epoch: Optional[int] = None) -> None:
        """Block until the change list is committed by consensus and
        ``commit_cb`` ran in the apply path (reference: raft.go:1592
        ProposeValue)."""
        self.wait_proposal(self.propose_async(actions, commit_cb,
                                              epoch=epoch))
