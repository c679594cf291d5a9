"""Safety invariants checked continuously during simulation.

Raft layer (checked on every state change, cluster-wide):

* single-leader-per-term — two members must never both be LEADER in the
  same term
* committed-entry agreement / no loss — once ANY member applies entry
  (index, term, digest), every member that ever applies that index must
  apply the identical entry, including after crash/restore from WAL

Control-plane layer (checked against the leader store's event stream):

* task FSM never moves backwards — observed status.state is monotone
  per task; desired_state is monotone per task
* terminal states are sticky — a COMPLETE/FAILED/... task never leaves
  the terminal set
* assignment liveness — when a task reaches ASSIGNED, its node exists
  and is not DOWN in the same store view
* no double assignment — a task's node_id never changes once set
* blocks are never failures — EventTaskBlock only ever carries
  assignment-band states (<= RUNNING), by contract

Rolling-update layer (``UpdateInvariants``, stream-ordered like
``TaskInvariants``; quality-not-just-safety framing per PAPERS.md
2302.05446 — the control plane must bound convergence and placement
quality under perturbation, not merely avoid unsafe states):

* no-mixed-version-after-completion — once an update reports COMPLETED
  (and a short settle absorbs racing restarts), every task slated to
  keep running carries the completed spec version
* rollback-restores-old-spec-everywhere — the same check at
  ROLLBACK_COMPLETED against the restored version
* pause-on-failure-threshold — a paused update must stop claiming new
  slots for the paused version
* update-convergence-within-bound — scenario-registered expectations
  (``RaftControlPlane.expect_update``) judged against the observed
  update-state history at finish
* placement-quality (``check_placement_quality``) — post-convergence,
  running tasks may not pile onto one node beyond a bound of the ideal
  even spread

Gang/pipeline layer (ISSUE 16; ``GangInvariants`` /
``PipelineInvariants``, payload discipline like ``TaskInvariants``
plus commit boundaries from ``EventCommit``):

* gang-atomicity — no committed transaction may assign a strict subset
  of a gang unit's pending members; judged at each ``EventCommit``
  with a short grace window so concurrent orchestrator churn (a
  replacement materializing between the scheduler's snapshot and its
  commit) resolves instead of flagging
* pipeline-order — a task of a ``depends_on`` stage must never reach
  RUNNING before every upstream stage has had at least one task
  RUNNING (the supervisor's release bar is stricter — full replicas —
  so this is the safe observable core of DAG ordering)
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..models.objects import Cluster, Node, Service, Task
from ..models.types import NodeState, TaskState, TERMINAL_STATES, UpdateState
from ..state.events import Event, EventCommit, EventTaskBlock, commit_or


class InvariantViolation(AssertionError):
    pass


class Violations:
    """Shared sink: checkers record, the runner decides pass/fail."""

    def __init__(self, engine):
        self.engine = engine
        self.items: List[str] = []

    def record(self, name: str, msg: str) -> None:
        line = f"INVARIANT {name}: {msg}"
        self.engine.log(line)
        self.items.append(f"t={self.engine.clock.elapsed():.3f} {line}")
        # mark the black box too: the post-mortem dump shows the
        # violation in context (surrounding spans/events), not alone
        from ..obs.flightrec import flightrec
        flightrec.note(line)


def entry_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


class RaftInvariants:
    def __init__(self, violations: Violations):
        self.v = violations
        self.leaders: Dict[int, str] = {}         # term -> leader id
        self.ledger: Dict[int, Tuple[int, str]] = {}  # index -> (term, digest)

    def observe_leader(self, term: int, member_id: str) -> None:
        seen = self.leaders.get(term)
        if seen is None:
            self.leaders[term] = member_id
        elif seen != member_id:
            # an election needs a majority of votes in that term; two
            # distinct winners for one term is a safety violation no
            # matter when each was observed
            self.v.record("single-leader-per-term",
                          f"term {term}: {seen} and {member_id} "
                          "are both leader")

    def observe_apply(self, member_id: str, index: int, term: int,
                      digest: str) -> None:
        seen = self.ledger.get(index)
        if seen is None:
            self.ledger[index] = (term, digest)
        elif seen != (term, digest):
            self.v.record(
                "no-committed-entry-loss",
                f"{member_id} applied ({term},{digest}) at index {index} "
                f"but the cluster committed {seen} there")

    def max_committed(self) -> int:
        return max(self.ledger) if self.ledger else 0


class TaskInvariants:
    """Subscribes to a store's event queue; ``drain()`` must be called
    after every synchronous control-plane step (single-threaded sim, so
    no events are ever in flight between checks)."""

    def __init__(self, violations: Violations, store):
        self.v = violations
        self.store = store
        self.states: Dict[str, int] = {}
        self.desired: Dict[str, int] = {}
        self.node_of: Dict[str, str] = {}
        # node states tracked from the SAME ordered event stream the
        # task observations come from: the assigned-node-live check must
        # compare an assignment against the node state committed BEFORE
        # it, not against the store's current row — drain can run behind
        # the commits (follower catch-up, deferred applies), where a
        # later DOWN would falsely indict an earlier valid assignment
        self.node_states: Dict[str, int] = {}
        self.sub = store.queue.subscribe(
            lambda ev: isinstance(ev, (Event, EventTaskBlock)),
            accepts_blocks=True)
        # adopt the store's committed rows as the baseline: a checker
        # attached to a crash-rebuilt store replays no history, and
        # judging a pre-existing assignment as a fresh transition against
        # a later-arriving node-DOWN event manufactures false positives
        # (single-threaded: nothing commits between subscribe and seed)
        def seed(tx):
            for n in tx.find(Node):
                self.node_states[n.id] = int(n.status.state)
            for t in tx.find(Task):
                self.states[t.id] = int(t.status.state)
                self.desired[t.id] = int(t.desired_state)
                if t.node_id:
                    self.node_of[t.id] = t.node_id
        store.view(seed)

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                return
            if isinstance(ev, EventTaskBlock):
                self._check_block(ev)
                # observe the block's OWN payload (state/node arrays),
                # never the store's current row: drain may run behind a
                # catch-up burst (a rejoined member replaying a long
                # committed suffix), where the store is already ahead of
                # the event being drained — reading "current" there
                # manufactures false FSM regressions
                state = int(ev.state)
                for nid, items in ev.per_node().items():
                    for old, _ver in items:
                        self._observe(old.id, state,
                                      int(old.desired_state), nid)
                continue
            if isinstance(ev.obj, Node):
                if ev.action == "delete":
                    self.node_states.pop(ev.obj.id, None)
                else:
                    self.node_states[ev.obj.id] = \
                        int(ev.obj.status.state)
                continue
            if isinstance(ev.obj, Task) and ev.action != "delete":
                t = ev.obj
                self._observe(t.id, int(t.status.state),
                              int(t.desired_state), t.node_id)

    def _check_block(self, ev: EventTaskBlock) -> None:
        if ev.state > int(TaskState.RUNNING):
            self.v.record(
                "blocks-never-failures",
                f"task block committed state {ev.state} "
                f"(> RUNNING): blocks must only carry assignment states")

    def _observe(self, task_id: str, state: int, des: int,
                 node_id: str) -> None:
        """One observed (state, desired, node) triple for a task, from
        the event payload itself (per-task Event or block column)."""
        prev = self.states.get(task_id)
        if prev is not None:
            if state < prev:
                self.v.record(
                    "fsm-monotonic",
                    f"task {task_id[:8]} moved {TaskState(prev).name} -> "
                    f"{TaskState(state).name}")
            if TaskState(prev) in TERMINAL_STATES and state != prev \
                    and TaskState(state) not in TERMINAL_STATES:
                self.v.record(
                    "terminal-sticky",
                    f"task {task_id[:8]} left terminal "
                    f"{TaskState(prev).name} for {TaskState(state).name}")
        self.states[task_id] = state

        prev_des = self.desired.get(task_id)
        if prev_des is not None and des < prev_des:
            self.v.record(
                "desired-monotonic",
                f"task {task_id[:8]} desired moved "
                f"{TaskState(prev_des).name} -> {TaskState(des).name}")
        self.desired[task_id] = des

        if node_id:
            prev_node = self.node_of.get(task_id)
            if prev_node is not None and prev_node != node_id:
                self.v.record(
                    "no-double-assign",
                    f"task {task_id[:8]} reassigned {prev_node[:8]} -> "
                    f"{node_id[:8]} while live")
            self.node_of[task_id] = node_id

        if state == int(TaskState.ASSIGNED) and prev != state:
            ns = self.node_states.get(node_id) if node_id else None
            if ns is not None:
                # ordered knowledge: the node's last state committed
                # BEFORE this assignment — a DOWN here means the
                # scheduler placed onto a node it knew was dead
                if ns == int(NodeState.DOWN):
                    self.v.record(
                        "assigned-node-live",
                        f"task {task_id[:8]} ASSIGNED to DOWN node "
                        f"{node_id[:8]}")
            else:
                # no ordered knowledge (subscribed mid-stream): at least
                # the node must exist
                node = self.store.raw_get(Node, node_id) \
                    if node_id else None
                if node is None:
                    self.v.record(
                        "assigned-node-live",
                        f"task {task_id[:8]} ASSIGNED to missing node "
                        f"{node_id[:8] if node_id else '<none>'}")


class UpdateInvariants:
    """Rolling-update invariants, tracked from one store's ordered event
    stream (payloads only — the same discipline as TaskInvariants: a
    member draining behind a catch-up burst must never be judged against
    rows newer than the event in hand).

    Completion checks are deferred by ``SETTLE`` virtual seconds: a
    restart racing the updater can legitimately leave one old-version
    task for a beat after COMPLETED lands (the next reconcile's updater
    converges it — reference behavior).  A deferred check is dropped
    when the service's spec version moved on (a newer rollout owns the
    slots now); ``finalize()`` evaluates whatever is still pending at
    scenario end regardless of settle.
    """

    #: virtual seconds a completion check waits before judging
    SETTLE = 15.0

    def __init__(self, violations: Violations, store, tag: str = ""):
        self.v = violations
        self.store = store
        self.tag = tag
        # task id -> immutable spec version index (0 = unversioned)
        self.task_version: Dict[str, int] = {}
        self.task_desired: Dict[str, int] = {}
        self.task_service: Dict[str, str] = {}
        self.task_slot: Dict[str, tuple] = {}
        self.svc_version: Dict[str, int] = {}
        self.svc_state: Dict[str, int] = {}      # UpdateState int; -1 = none
        # sid -> the version a ROLLBACK_STARTED transition rolled back
        # FROM (the restored spec hides it, but expectations are
        # registered against the minted rollout version)
        self._rollback_of: Dict[str, int] = {}
        # sid -> {"version": paused rollout version, "slots": claimed set}
        self.paused: Dict[str, dict] = {}
        #: (t, sid, version, UpdateState int) — every observed transition
        self.history: List[tuple] = []
        #: deferred completion checks: (due_t, sid, version, name)
        self._pending_checks: List[tuple] = []
        self.sub = store.queue.subscribe(
            lambda ev: isinstance(ev, Event)
            and isinstance(ev.obj, (Task, Service)),
            accepts_blocks=True)
        # baseline adoption (see TaskInvariants): a crash-rebuilt store
        # replays no history, so seed tasks and service update states
        # from the committed rows — including a paused rollout's claimed
        # slots, so pause-on-failure-threshold keeps enforcing
        def seed(tx):
            for t in tx.find(Task):
                self.task_version[t.id] = \
                    t.spec_version.index if t.spec_version else 0
                self.task_desired[t.id] = int(t.desired_state)
                self.task_service[t.id] = t.service_id
                self.task_slot[t.id] = (t.slot, t.node_id)
            for s in tx.find(Service):
                version = s.spec_version.index if s.spec_version else 0
                state = int(s.update_status.state) if s.update_status \
                    else -1
                self.svc_version[s.id] = version
                self.svc_state[s.id] = state
                if state in (int(UpdateState.PAUSED),
                             int(UpdateState.ROLLBACK_PAUSED)):
                    # claimed keys carry CREATE-time node ids on the
                    # event path (replicated replacements are minted
                    # with node_id "" before assignment), but committed
                    # rows are already assigned — seed both shapes so a
                    # legitimate restart replacement in an
                    # already-claimed slot never reads as a fresh claim
                    claimed = set()
                    for tid, v in self.task_version.items():
                        if v == version \
                                and self.task_service.get(tid) == s.id:
                            slot_key = self.task_slot[tid]
                            claimed.add(slot_key)
                            claimed.add((slot_key[0], ""))
                    self.paused[s.id] = {"version": version,
                                         "slots": claimed}
        store.view(seed)

    # ---------------------------------------------------------------- drain

    def _now(self) -> float:
        return self.v.engine.clock.elapsed()

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            obj = ev.obj
            if isinstance(obj, Task):
                self._observe_task(ev.action, obj)
            elif isinstance(obj, Service):
                self._observe_service(ev.action, obj)
        self._run_due_checks(self._now())

    def _observe_task(self, action: str, t: Task) -> None:
        if action == "delete":
            self.task_version.pop(t.id, None)
            self.task_desired.pop(t.id, None)
            self.task_service.pop(t.id, None)
            self.task_slot.pop(t.id, None)
            return
        if action == "create":
            version = t.spec_version.index if t.spec_version else 0
            self.task_version[t.id] = version
            self.task_service[t.id] = t.service_id
            self.task_slot[t.id] = (t.slot, t.node_id)
            self._check_pause_progress(t, version)
        self.task_desired[t.id] = int(t.desired_state)

    def _observe_service(self, action: str, s: Service) -> None:
        if action == "delete":
            self.svc_version.pop(s.id, None)
            self.svc_state.pop(s.id, None)
            self.paused.pop(s.id, None)
            return
        version = s.spec_version.index if s.spec_version else 0
        state = int(s.update_status.state) if s.update_status else -1
        prev_state = self.svc_state.get(s.id, -1)
        prev_version = self.svc_version.get(s.id)
        self.svc_version[s.id] = version
        self.svc_state[s.id] = state
        if state == prev_state and version == prev_version:
            return
        self.history.append((self._now(), s.id, version, state))
        if state == int(UpdateState.ROLLBACK_STARTED) \
                and prev_version is not None and prev_version != version:
            self._rollback_of[s.id] = prev_version
        rb = self._rollback_of.get(s.id)
        if rb is not None and state in (int(UpdateState.ROLLBACK_STARTED),
                                        int(UpdateState.ROLLBACK_PAUSED),
                                        int(UpdateState.ROLLBACK_COMPLETED)):
            # mirror rollback states onto the rolled-back version so
            # expect_update(minted_version, ROLLBACK_COMPLETED) matches
            self.history.append((self._now(), s.id, rb, state))
        elif rb is not None and (state == -1 or version > rb):
            self._rollback_of.pop(s.id, None)
        if state != prev_state:
            if state in (int(UpdateState.COMPLETED),
                         int(UpdateState.ROLLBACK_COMPLETED)):
                name = ("rollback-restores-old-spec-everywhere"
                        if state == int(UpdateState.ROLLBACK_COMPLETED)
                        else "no-mixed-version-after-completion")
                self._pending_checks.append(
                    (self._now() + self.SETTLE, s.id, version, name))
            if state in (int(UpdateState.PAUSED),
                         int(UpdateState.ROLLBACK_PAUSED)):
                self.paused[s.id] = {
                    "version": version,
                    "slots": {self.task_slot[tid]
                              for tid, v in self.task_version.items()
                              if v == version
                              and self.task_service.get(tid) == s.id
                              and tid in self.task_slot}}
            else:
                self.paused.pop(s.id, None)

    # -------------------------------------------------------------- checks

    def _check_pause_progress(self, t: Task, version: int) -> None:
        """A paused update must not claim NEW slots for the paused
        version.  Restart replacements in already-claimed slots are
        legitimate (pausing stops the rollout, not restart management)."""
        p = self.paused.get(t.service_id)
        if p is None or version != p["version"]:
            return
        key = (t.slot, t.node_id)
        if key in p["slots"]:
            return
        p["slots"].add(key)   # record once per slot
        self.v.record(
            "pause-on-failure-threshold",
            f"{self.tag}: service {t.service_id} claimed new slot "
            f"{key} for version {version} while the update is paused")

    def _run_due_checks(self, ts: float) -> None:
        still = []
        for due, sid, version, name in self._pending_checks:
            if ts < due:
                still.append((due, sid, version, name))
                continue
            self._judge_completion(sid, version, name)
        self._pending_checks = still

    def _judge_completion(self, sid: str, version: int, name: str) -> None:
        if self.svc_version.get(sid) != version:
            return   # a newer rollout owns the slots now
        mixed = [
            tid for tid, v in self.task_version.items()
            if self.task_service.get(tid) == sid and v != version
            and self.task_desired.get(tid, 0) <= int(TaskState.RUNNING)]
        if mixed:
            self.v.record(
                name,
                f"{self.tag}: service {sid} completed at version "
                f"{version} but {len(mixed)} live task(s) carry other "
                f"versions (e.g. {sorted(mixed)[:3]})")

    def finalize(self) -> None:
        """Scenario end: judge every still-pending completion check —
        the end state must be clean regardless of settle windows."""
        self.drain()
        for _due, sid, version, name in self._pending_checks:
            self._judge_completion(sid, version, name)
        self._pending_checks = []


class PreemptionInvariants:
    """Priority & preemption invariants, tracked from one store's
    ordered event stream (payload discipline like TaskInvariants):

    * no-preempt-equal-or-higher — every preemption marker
      (``swarm.preempted.*`` annotations stamped by the scheduler's
      atomic preemption tx) must name a victim priority STRICTLY below
      the preemptor's; equal-or-higher anywhere is a safety violation.
    * no-priority-inversion — a positive-priority task that stays
      PENDING past ``inversion_bound`` virtual seconds while some node
      it fits (resource-wise, counting the reservations of its
      strictly-lower-priority running tasks as reclaimable) holds
      lower-priority work is an inversion the preemption pass should
      have resolved.
    * preemption-thrash-bound — one slot preempted more than
      ``thrash_bound`` times inside ``thrash_window`` virtual seconds
      is thrash the anti-thrash cooldown exists to prevent.
    * preempted-tasks-requeue (``finalize``) — every preempted victim's
      slot must hold a NEWER runnable (or completed) task by scenario
      end, unless the service shrank below the slot or was deleted:
      preemption evicts work, it never loses it.
    """

    def __init__(self, violations: Violations, store, tag: str = "",
                 inversion_bound: float = 25.0, thrash_bound: int = 3,
                 thrash_window: float = 60.0):
        self.v = violations
        self.store = store
        self.tag = tag
        self.inversion_bound = inversion_bound
        self.thrash_bound = thrash_bound
        self.thrash_window = thrash_window
        #: pending positive-priority unassigned tasks -> first-seen t
        self.pending_since: Dict[str, float] = {}
        self._judged: set = set()
        self._seen_markers: set = set()
        self._thrash_flagged: set = set()
        self._slot_stamps: Dict[tuple, List[float]] = {}
        #: (t, service_id, slot, node_id, victim_id) per observed marker
        self.preempted: List[tuple] = []
        self.seen_preemptions = 0
        from ..scheduler.preempt import task_priority
        self._priority = task_priority
        self.sub = store.queue.subscribe(
            lambda ev: isinstance(ev, Event)
            and isinstance(ev.obj, Task), accepts_blocks=True)

        # baseline adoption (TaskInvariants discipline): a crash-rebuilt
        # store replays no history — seed pending-age tracking from the
        # committed rows so a long-pending inversion survives the crash
        def seed(tx):
            ts = self._now()
            for t in tx.find(Task):
                if (not t.node_id
                        and t.status.state == int(TaskState.PENDING)
                        and t.desired_state <= int(TaskState.COMPLETE)
                        and self._priority(t) > 0):
                    self.pending_since[t.id] = ts
                if "swarm.preempted.at" in t.annotations.labels:
                    self._seen_markers.add(t.id)
        store.view(seed)

    def _now(self) -> float:
        return self.v.engine.clock.elapsed()

    # ---------------------------------------------------------------- drain

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            t = ev.obj
            if ev.action == "delete":
                self.pending_since.pop(t.id, None)
                continue
            if (not t.node_id
                    and t.status.state == int(TaskState.PENDING)
                    and t.desired_state <= int(TaskState.COMPLETE)
                    and self._priority(t) > 0):
                self.pending_since.setdefault(t.id, self._now())
            else:
                self.pending_since.pop(t.id, None)
            labels = t.annotations.labels
            if "swarm.preempted.at" in labels \
                    and t.id not in self._seen_markers:
                self._seen_markers.add(t.id)
                self._observe_preemption(t, labels)
        ts = self._now()
        for tid, since in list(self.pending_since.items()):
            if ts - since > self.inversion_bound:
                self._judge_inversion(tid, ts)

    def _observe_preemption(self, t: Task, labels: Dict[str, str]) -> None:
        self.seen_preemptions += 1
        try:
            victim_prio = int(labels.get("swarm.preempted.prio", "0"))
            by_prio = int(labels.get("swarm.preempted.by.prio", "0"))
        except ValueError:
            victim_prio, by_prio = 0, 0
        if victim_prio >= by_prio:
            self.v.record(
                "no-preempt-equal-or-higher",
                f"{self.tag}: task {t.id[:8]} (priority {victim_prio}) "
                f"preempted by priority {by_prio} work — victims must "
                "be strictly lower")
        ts = self._now()
        key = (t.service_id, t.slot, t.node_id if not t.slot else "")
        stamps = [s for s in self._slot_stamps.get(key, [])
                  if ts - s < self.thrash_window] + [ts]
        self._slot_stamps[key] = stamps
        if len(stamps) > self.thrash_bound \
                and key not in self._thrash_flagged:
            self._thrash_flagged.add(key)
            self.v.record(
                "preemption-thrash-bound",
                f"{self.tag}: slot {key} preempted {len(stamps)} times "
                f"inside {self.thrash_window:.0f}s (bound "
                f"{self.thrash_bound}) — anti-thrash cooldown broken")
        self.preempted.append((ts, t.service_id, t.slot, t.node_id,
                               t.id))

    # --------------------------------------------------------------- checks

    def _judge_inversion(self, tid: str, ts: float) -> None:
        """Judge one overdue pending task.  A clean verdict RE-ARMS the
        stamp (the task is judged again after another bound) — an
        inversion that only develops later must still be caught; a
        recorded violation stops tracking (one report per task)."""
        if tid in self._judged:
            self.pending_since.pop(tid, None)
            return
        task = self.store.raw_get(Task, tid)
        if task is None or task.node_id \
                or task.status.state != int(TaskState.PENDING):
            self.pending_since.pop(tid, None)
            return
        p = self._priority(task)
        res = task.spec.resources.reservations if task.spec.resources \
            else None
        if res is None or (not res.nano_cpus and not res.memory_bytes) \
                or res.generic:
            # non-resource infeasibility: not preemption's job, and it
            # cannot become one — stop tracking this task
            self.pending_since.pop(tid, None)
            return
        cpu_d, mem_d = int(res.nano_cpus), int(res.memory_bytes)

        def scan(tx):
            from ..scheduler.nodeinfo import task_reservations
            by_node: Dict[str, list] = {}
            for t in tx.find(Task):
                if t.node_id and t.desired_state <= int(TaskState.COMPLETE) \
                        and t.status.state <= int(TaskState.RUNNING):
                    by_node.setdefault(t.node_id, []).append(t)
            for n in tx.find(Node):
                if n.status.state != int(NodeState.READY) \
                        or n.spec.availability != 0 \
                        or not n.description or not n.description.resources:
                    continue
                free_cpu = int(n.description.resources.nano_cpus)
                free_mem = int(n.description.resources.memory_bytes)
                reclaim_cpu = reclaim_mem = 0
                lower = False
                for t in by_node.get(n.id, []):
                    r = task_reservations(t)
                    free_cpu -= int(r.nano_cpus)
                    free_mem -= int(r.memory_bytes)
                    if self._priority(t) < p \
                            and t.status.state == int(TaskState.RUNNING):
                        lower = True
                        reclaim_cpu += int(r.nano_cpus)
                        reclaim_mem += int(r.memory_bytes)
                if lower and free_cpu + reclaim_cpu >= cpu_d \
                        and free_mem + reclaim_mem >= mem_d:
                    return n.id
            return None

        node = self.store.view(scan)
        if node is not None:
            self._judged.add(tid)
            self.pending_since.pop(tid, None)
            self.v.record(
                "no-priority-inversion",
                f"{self.tag}: task {tid[:8]} (priority {p}) pending > "
                f"{self.inversion_bound:.0f}s while lower-priority work "
                f"on node {node} covers its demand — preemption should "
                "have resolved this")
        else:
            # clean right now: re-arm — an inversion may develop later
            self.pending_since[tid] = ts

    def finalize(self) -> None:
        """Scenario end: every preempted slot must have been requeued —
        a newer task occupies the (service, slot), or the service
        legitimately shrank/vanished."""
        self.drain()

        def judge(tx):
            missing = []
            for ts, sid, slot, node_id, victim_id in self.preempted:
                svc = tx.get(Service, sid)
                if svc is None:
                    continue
                if svc.spec.replicated is not None \
                        and svc.spec.replicated.replicas < slot:
                    continue    # scaled below the slot: no requeue owed
                again = [t for t in tx.find(Task)
                         if t.service_id == sid and t.slot == slot
                         and t.id != victim_id
                         and (t.desired_state <= int(TaskState.COMPLETE)
                              or t.status.state
                              == int(TaskState.COMPLETE))]
                if not again:
                    missing.append((sid, slot, victim_id))
            return missing

        for sid, slot, victim_id in self.store.view(judge):
            self.v.record(
                "preempted-tasks-requeue",
                f"{self.tag}: victim {victim_id[:8]} of service {sid} "
                f"slot {slot} was never requeued — preemption lost "
                "work")


class QosInvariants:
    """Autoscaler + multi-tenant QoS invariants (ISSUE 12), tracked from
    one store's ordered event stream (payload discipline like
    TaskInvariants):

    * quota-never-exceeded — committed per-tenant usage (cpu/memory
      reservations + task count of assigned, live tasks) must stay <=
      the ClusterSpec quota at every drain.  Usage is re-derived from
      event payloads, independently of the scheduler's ledger.
    * autoscale-within-bounds-and-rate — every committed replica change
      on an autoscaled service must land inside [min, max], move at
      most one configured step, and carry decision stamps
      (``Service.autoscale_status.last_decision_at`` — the REPLICATED
      stamp, so the check holds across leader failover) no closer than
      the stabilization window.
    * no-cross-band-p99-violation (``check_band_p99``) — a registered
      burst window must not degrade higher bands' pending->assigned
      p99 beyond a bound derived from the scheduler's own cadence
      (control-step interval + commit-debounce latency) and the band's
      own out-of-window behavior — never a per-scenario constant.
      Tasks still pending at finalize count at their open-ended age, so
      outright starvation cannot hide from a percentile.
    * autoscale-converges — judged by the control plane's registered
      expectations against ``replica_history`` (merged across members
      and crash-rebuilt checkers, like the update-state history).
    """

    #: slack on the rate check: equal stamps one float ulp apart must
    #: not fire
    RATE_EPS = 1e-6

    def __init__(self, violations: Violations, store, tag: str = "",
                 cadence: float = 1.5):
        self.v = violations
        self.store = store
        self.tag = tag
        #: scheduler cadence (control interval + debounce max latency):
        #: the latency floor the p99 bound derives from
        self.cadence = cadence
        self.quotas: Dict[str, object] = {}
        #: task id -> (tenant, cpu, mem) currently counted toward usage
        self._counted: Dict[str, tuple] = {}
        self.usage: Dict[str, List[int]] = {}
        self._quota_flagged: set = set()
        #: service id -> (replicas, autoscale cfg, decision stamp)
        self._svc_replicas: Dict[str, int] = {}
        self._svc_stamp: Dict[str, float] = {}
        self._bounds_flagged: set = set()
        #: (t, service id, replicas) — every committed replica change
        #: on an autoscaled service
        self.replica_history: List[tuple] = []
        #: task id -> (priority, first-PENDING stamp) still waiting
        self.pending_open: Dict[str, tuple] = {}
        #: (task id, priority, assign t, pending->assigned latency) —
        #: the id lets the control plane dedupe samples across member
        #: checkers (every member observes the same committed stream)
        self.band_samples: List[tuple] = []
        self.sub = store.queue.subscribe(
            lambda ev: isinstance(ev, EventTaskBlock)
            or (isinstance(ev, Event)
                and isinstance(ev.obj, (Task, Service, Cluster))),
            accepts_blocks=True)

        from ..scheduler.nodeinfo import task_reservations
        from ..scheduler.preempt import task_priority
        from ..scheduler.quota import task_tenant
        self._reservations = task_reservations
        self._priority = task_priority
        self._tenant = task_tenant

        # baseline adoption (TaskInvariants discipline): a crash-rebuilt
        # store replays no history — seed quotas, usage, service state
        # and open pending stamps from the committed rows
        def seed(tx):
            ts = self._now()
            for c in tx.find(Cluster):
                if c.spec.annotations.name == "default":
                    self.quotas = dict(c.spec.tenants)
            for s in tx.find(Service):
                if s.spec.autoscale is not None \
                        and s.spec.replicated is not None:
                    self._svc_replicas[s.id] = s.spec.replicated.replicas
                    if s.autoscale_status is not None:
                        self._svc_stamp[s.id] = \
                            s.autoscale_status.last_decision_at
            for t in tx.find(Task):
                self._observe_task_row(t, ts)
        store.view(seed)

    def _now(self) -> float:
        return self.v.engine.clock.elapsed()

    # ---------------------------------------------------------------- drain

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            ts = self._now()
            if isinstance(ev, EventTaskBlock):
                # block payloads: per-task (old row, node) pairs plus
                # the committed state column — the scheduler's columnar
                # assignment commits arrive exactly this way
                state = int(ev.state)
                for nid, items in ev.per_node().items():
                    for old, _ver in items:
                        self._observe_task_payload(
                            old, state, nid, int(old.desired_state), ts)
                continue
            obj = ev.obj
            if isinstance(obj, Cluster):
                # the "default" cluster owns the quota table (the same
                # row the scheduler reads) — other Cluster objects must
                # not wipe it
                if ev.action != "delete" \
                        and obj.spec.annotations.name == "default":
                    self.quotas = dict(obj.spec.tenants)
                continue
            if isinstance(obj, Service):
                self._observe_service(ev.action, obj, ts)
                continue
            if ev.action == "delete":
                self._uncount(obj.id)
                self.pending_open.pop(obj.id, None)
                continue
            self._observe_task_row(obj, ts)
        self._check_quota()

    # -------------------------------------------------------------- tenants

    def _observe_task_row(self, t: Task, ts: float) -> None:
        self._observe_task_payload(t, int(t.status.state), t.node_id,
                                   int(t.desired_state), ts)

    def _observe_task_payload(self, t: Task, state: int, node_id: str,
                              desired: int, ts: float) -> None:
        # usage: counted while assigned and live
        live = (bool(node_id)
                and int(TaskState.ASSIGNED) <= state
                <= int(TaskState.RUNNING)
                and desired <= int(TaskState.COMPLETE))
        if live and t.id not in self._counted:
            tenant = self._tenant(t)
            if tenant in self.quotas:
                res = self._reservations(t)
                entry = (tenant, int(res.nano_cpus),
                         int(res.memory_bytes))
                self._counted[t.id] = entry
                row = self.usage.setdefault(tenant, [0, 0, 0])
                row[0] += entry[1]
                row[1] += entry[2]
                row[2] += 1
        elif not live and t.id in self._counted:
            self._uncount(t.id)
        # pending->assigned band latency.  Terminal-past-RUNNING is
        # checked FIRST: a task shut down while still PENDING (scale
        # down, reaper) was never assigned and must not mint a sample.
        if state > int(TaskState.RUNNING):
            self.pending_open.pop(t.id, None)
        elif (state == int(TaskState.PENDING) and not node_id
                and desired <= int(TaskState.COMPLETE)):
            self.pending_open.setdefault(t.id, (self._priority(t), ts))
        elif state >= int(TaskState.ASSIGNED):
            open_ = self.pending_open.pop(t.id, None)
            if open_ is not None:
                prio, since = open_
                self.band_samples.append((t.id, prio, ts, ts - since))

    def _uncount(self, task_id: str) -> None:
        entry = self._counted.pop(task_id, None)
        if entry is None:
            return
        tenant, cpu, mem = entry
        row = self.usage.get(tenant)
        if row is not None:
            row[0] -= cpu
            row[1] -= mem
            row[2] -= 1

    def _check_quota(self) -> None:
        for tenant, q in self.quotas.items():
            if tenant in self._quota_flagged:
                continue
            row = self.usage.get(tenant)
            if row is None:
                continue
            over = []
            for have, limit, unit in ((row[0], q.nano_cpus, "nano_cpus"),
                                      (row[1], q.memory_bytes,
                                       "memory_bytes"),
                                      (row[2], q.max_tasks, "tasks")):
                if limit > 0 and have > limit:
                    over.append(f"{unit} {have} > {limit}")
            if over:
                self._quota_flagged.add(tenant)
                self.v.record(
                    "quota-never-exceeded",
                    f"{self.tag}: tenant {tenant} committed usage "
                    f"exceeds its quota ({'; '.join(over)}) — admission "
                    "clamping is broken")

    # ------------------------------------------------------------ autoscale

    def _observe_service(self, action: str, s: Service,
                         ts: float) -> None:
        if action == "delete":
            self._svc_replicas.pop(s.id, None)
            self._svc_stamp.pop(s.id, None)
            return
        cfg = s.spec.autoscale
        if cfg is None or s.spec.replicated is None:
            self._svc_replicas.pop(s.id, None)
            return
        new = s.spec.replicated.replicas
        prev = self._svc_replicas.get(s.id)
        stamp = (s.autoscale_status.last_decision_at
                 if s.autoscale_status is not None else 0.0)
        prev_stamp = self._svc_stamp.get(s.id)
        self._svc_replicas[s.id] = new
        if stamp:
            self._svc_stamp[s.id] = stamp
        if prev is None or new == prev:
            return
        self.replica_history.append((ts, s.id, new))
        problems = []
        if not (cfg.min_replicas <= new <= cfg.max_replicas):
            problems.append(
                f"replicas {new} outside "
                f"[{cfg.min_replicas}, {cfg.max_replicas}]")
        step = cfg.scale_up_step if new > prev else cfg.scale_down_step
        if abs(new - prev) > max(step, 1):
            problems.append(
                f"step {prev} -> {new} exceeds the configured "
                f"{'up' if new > prev else 'down'} step {step}")
        if (prev_stamp and stamp
                and stamp - prev_stamp
                < cfg.stabilization_window - self.RATE_EPS):
            problems.append(
                f"decision stamps {prev_stamp:.3f} -> {stamp:.3f} are "
                f"closer than the {cfg.stabilization_window:.1f}s "
                "stabilization window")
        if problems and s.id not in self._bounds_flagged:
            self._bounds_flagged.add(s.id)
            self.v.record(
                "autoscale-within-bounds-and-rate",
                f"{self.tag}: service {s.id}: {'; '.join(problems)}")

    # -------------------------------------------------------------- finalize

    @staticmethod
    def _p99(samples: List[float]) -> float:
        if not samples:
            return 0.0
        ordered = sorted(samples)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]

    def band_p99_bound(self, baseline: List[float]) -> float:
        """The derived bound: the scheduler's own cadence (a handful of
        control steps + commit debounce) as the floor, or 3x the band's
        out-of-window p99 when that behavior is worse — never a
        per-scenario constant."""
        return max(4.0 * self.cadence, 3.0 * self._p99(baseline))

    def check_band_p99(self, min_priority: int, t0: float, t1: float,
                       violations: Violations,
                       samples: Optional[List[tuple]] = None,
                       open_pending: Optional[List[tuple]] = None
                       ) -> None:
        """Judge one registered burst window: higher bands' (priority >=
        ``min_priority``) pending->assigned p99 inside [t0, t1] must stay
        under the derived bound.  ``samples``/``open_pending`` default to
        this checker's own view (the control plane passes merged,
        deduped collections)."""
        samples = samples if samples is not None else self.band_samples
        if open_pending is None:
            open_pending = list(self.pending_open.values())
        ts = self._now()
        band = [(at, lat) for _tid, prio, at, lat in samples
                if prio >= min_priority]
        in_window = [lat for at, lat in band if t0 <= at <= t1]
        # a task of the band still unassigned counts at its open-ended
        # age — starvation must not escape the percentile
        for prio, since in open_pending:
            if prio >= min_priority and since <= t1:
                in_window.append(ts - since)
        if not in_window:
            violations.record(
                "no-cross-band-p99-violation",
                f"band >= {min_priority} produced no pending->assigned "
                f"samples in [{t0:.0f}, {t1:.0f}] — the burst window "
                "never exercised the protected band")
            return
        baseline = [lat for at, lat in band if at < t0 or at > t1]
        bound = self.band_p99_bound(baseline)
        p99 = self._p99(in_window)
        if p99 > bound:
            violations.record(
                "no-cross-band-p99-violation",
                f"band >= {min_priority} pending->assigned p99 "
                f"{p99:.2f}s inside the burst window exceeds the "
                f"derived bound {bound:.2f}s (cadence {self.cadence}s, "
                f"baseline p99 {self._p99(baseline):.2f}s over "
                f"{len(baseline)} samples) — the burst leaked into the "
                "protected band")


class GangInvariants:
    """Gang-scheduling atomicity (ISSUE 16), tracked from one store's
    ordered event stream with commit boundaries:

    * gang-atomicity — no committed transaction may assign a strict
      subset of a gang unit: at every ``EventCommit``, a unit that had
      members assigned in the batch while OTHER members of the unit
      remain pending is *suspected*.  A suspicion resolves silently if
      those members stop being pending (placed by the immediately
      following tick, or shut down) within ``GRACE`` seconds — that is
      the legal race where the orchestrator materializes a replacement
      between the scheduler's snapshot and its commit.  A suspicion
      that outlives the grace window is a real partial placement and
      fails the run.

    Pending membership is derived from event payloads only (never
    current store rows), TaskInvariants discipline; a crash-rebuilt
    checker seeds from the committed rows.
    """

    #: seconds a strict-subset suspicion may stay open before it is a
    #: violation — a few scheduler cadences, so the one-tick
    #: snapshot/commit race always resolves and a deferred
    #: "partially placed" remainder never does
    GRACE = 10.0

    def __init__(self, violations: Violations, store, tag: str = ""):
        self.v = violations
        self.store = store
        self.tag = tag
        from ..scheduler.gang import gang_unit, is_gang
        self._gang_unit = gang_unit
        self._is_gang = is_gang
        #: pending gang members: task id -> unit key
        self._pending: Dict[str, str] = {}
        #: unit -> task ids assigned in the current commit batch
        self._batch: Dict[str, set] = {}
        #: unit -> (suspected-at, frozenset of left-behind task ids)
        self._suspect: Dict[str, tuple] = {}
        self._flagged: set = set()
        self.stats = {"commits_judged": 0, "suspicions": 0,
                      "resolved": 0}
        self.sub = store.queue.subscribe(
            commit_or(lambda ev: isinstance(ev, EventTaskBlock)
                      or (isinstance(ev, Event)
                          and isinstance(ev.obj, Task))),
            accepts_blocks=True)
        # baseline adoption: seed the pending set from committed rows
        # (assignments already committed are history, not a batch)
        def seed(tx):
            for t in tx.find(Task):
                self._observe(t, int(t.status.state), t.node_id,
                              int(t.desired_state))
        store.view(seed)
        self._batch.clear()

    def _now(self) -> float:
        return self.v.engine.clock.elapsed()

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            if isinstance(ev, EventCommit):
                self._judge_batch()
                continue
            if isinstance(ev, EventTaskBlock):
                state = int(ev.state)
                for nid, items in ev.per_node().items():
                    for old, _ver in items:
                        self._observe(old, state, nid,
                                      int(old.desired_state))
                continue
            obj = ev.obj
            if ev.action == "delete":
                self._pending.pop(obj.id, None)
                continue
            self._observe(obj, int(obj.status.state), obj.node_id,
                          int(obj.desired_state))
        self._age_suspicions()

    def _observe(self, t: Task, state: int, node_id: str,
                 desired: int) -> None:
        if not self._is_gang(t):
            return
        unit = self._gang_unit(t)
        if (not node_id and state == int(TaskState.PENDING)
                and desired <= int(TaskState.COMPLETE)):
            self._pending[t.id] = unit
            return
        was_pending = self._pending.pop(t.id, None) is not None
        if (was_pending and node_id
                and state >= int(TaskState.ASSIGNED)
                and desired <= int(TaskState.COMPLETE)):
            self._batch.setdefault(unit, set()).add(t.id)
        # anything else — shut down, failed, orphaned — just stops
        # being pending; only pending->assigned joins the batch

    def _judge_batch(self) -> None:
        batch, self._batch = self._batch, {}
        if not batch:
            return
        self.stats["commits_judged"] += 1
        for unit, assigned in batch.items():
            if unit in self._flagged or unit in self._suspect:
                continue
            left = frozenset(tid for tid, u in self._pending.items()
                             if u == unit)
            if left:
                self.stats["suspicions"] += 1
                self._suspect[unit] = (self._now(), left, len(assigned))

    def _age_suspicions(self) -> None:
        if not self._suspect:
            return
        ts = self._now()
        for unit in list(self._suspect):
            since, left, n_assigned = self._suspect[unit]
            still = [tid for tid in left if self._pending.get(tid) == unit]
            if not still:
                self.stats["resolved"] += 1
                del self._suspect[unit]
                continue
            if ts - since > self.GRACE and unit not in self._flagged:
                self._flagged.add(unit)
                del self._suspect[unit]
                self.v.record(
                    "gang-atomicity",
                    f'{self.tag}: a commit at t={since:.1f} assigned '
                    f'{n_assigned} member(s) of gang "{unit}" while '
                    f'{len(still)} member(s) stayed pending '
                    f'{ts - since:.1f}s past the commit — a strict '
                    "subset of a gang was committed")


class PipelineInvariants:
    """Pipeline DAG ordering (ISSUE 16), tracked from one store's
    ordered event stream:

    * pipeline-order — a task of a service that names upstream
      dependencies (``ServiceSpec.depends_on``) must never be observed
      RUNNING before every upstream service has had at least one task
      reach RUNNING (COMPLETE counts: a finished job ran).  The
      supervisor's release bar is stricter (full replicas / total
      completions), so this is the safe observable core — it cannot
      false-positive on upstream churn after release, yet fires the
      moment the gate is bypassed.

    Ever-RUNNING is sticky per service; a crash-rebuilt checker seeds
    it leniently (status >= RUNNING) from committed rows so failover
    cannot mint false positives.
    """

    def __init__(self, violations: Violations, store, tag: str = ""):
        self.v = violations
        self.store = store
        self.tag = tag
        #: service id -> upstream names; service name -> id
        self._depends: Dict[str, List[str]] = {}
        self._by_name: Dict[str, str] = {}
        #: service ids with >= 1 task ever observed RUNNING
        self._ever_ran: set = set()
        self._flagged: set = set()
        self.sub = store.queue.subscribe(
            lambda ev: isinstance(ev, EventTaskBlock)
            or (isinstance(ev, Event)
                and isinstance(ev.obj, (Task, Service))),
            accepts_blocks=True)

        def seed(tx):
            for s in tx.find(Service):
                self._observe_service("update", s)
            for t in tx.find(Task):
                if t.status.state >= int(TaskState.RUNNING):
                    self._ever_ran.add(t.service_id)
        store.view(seed)

    def drain(self) -> None:
        while True:
            ev = self.sub.poll()
            if ev is None:
                break
            if isinstance(ev, EventTaskBlock):
                # assignment-band block commits never carry RUNNING by
                # contract; guarded anyway so a future block shape
                # cannot silently skip the ordering check
                if int(ev.state) == int(TaskState.RUNNING):
                    for _nid, items in ev.per_node().items():
                        for old, _ver in items:
                            self._observe_running(old)
                continue
            obj = ev.obj
            if isinstance(obj, Service):
                self._observe_service(ev.action, obj)
                continue
            if ev.action == "delete":
                continue
            state = int(obj.status.state)
            if state == int(TaskState.RUNNING) \
                    or state == int(TaskState.COMPLETE):
                self._observe_running(obj)

    def _observe_service(self, action: str, s: Service) -> None:
        name = s.spec.annotations.name
        if action == "delete":
            self._depends.pop(s.id, None)
            if self._by_name.get(name) == s.id:
                del self._by_name[name]
            return
        self._by_name[name] = s.id
        deps = list(s.spec.depends_on or ())
        if deps:
            self._depends[s.id] = deps
        else:
            self._depends.pop(s.id, None)

    def _observe_running(self, t: Task) -> None:
        sid = t.service_id
        deps = self._depends.get(sid)
        if deps and sid not in self._flagged:
            not_ready = []
            for dep in deps:
                up = self._by_name.get(dep)
                if up is None or up not in self._ever_ran:
                    not_ready.append(dep)
            if not_ready:
                self._flagged.add(sid)
                self.v.record(
                    "pipeline-order",
                    f"{self.tag}: task {t.id} of pipeline stage "
                    f"{sid} reached RUNNING before upstream stage(s) "
                    f"{', '.join(repr(d) for d in not_ready)} ever ran "
                    "— the DAG gate was bypassed")
        # sticky AFTER the check (self-edges are rejected by the
        # control API, so ordering here cannot self-satisfy)
        self._ever_ran.add(sid)


class ReadInvariants:
    """Follower-served read-plane invariants, judged at read-serve time
    (the proposers' ``read_barrier`` calls in — no event stream needed,
    a read is a synchronous act):

    * follower-reads-never-uncommitted — a linearizable view served by
      ANY member must include every entry committed cluster-wide at the
      moment the read was requested (and can never run ahead of the
      sealed ledger: members only apply committed entries).  Serving a
      view without waiting out the read barrier is exactly the bug this
      catches.
    * lease-read-safe-under-skew — a leader-lease read (quorum-free fast
      path) is only safe while the lease's election-timing argument
      holds: never under an active clock-skew fault (skewed tick rates
      void the "no one can have been elected yet" claim), and never from
      a member whose state trails the cluster's committed frontier (an
      expired-lease ex-leader serving is a stale read).
    """

    def __init__(self, violations: Violations, managers):
        self.v = violations
        self.managers = managers
        self.stats = {"reads": 0, "lease_reads": 0, "stale_serves": 0}

    def committed_version(self) -> int:
        """The cluster's sealed store-version frontier: member stores
        only apply committed entries, so the max version any member
        reached IS the committed watermark a linearizable read must
        cover."""
        best = 0
        for m in self.managers:
            if m.store is not None:
                v = m.store.version
                if v > best:
                    best = v
        return best

    def begin_read(self, member) -> dict:
        return {"required": self.committed_version()}

    def _stale(self) -> None:
        from ..utils.metrics import registry as _metrics
        self.stats["stale_serves"] += 1
        # the counter obs/health.py's stale_read_risk check fails on
        _metrics.counter("swarm_stale_reads")

    def served(self, member, token: dict, lease: bool,
               skew_active: bool) -> None:
        self.stats["reads"] += 1
        v = member.store.version if member.store is not None else 0
        if v < token["required"]:
            self._stale()
            self.v.record(
                "follower-reads-never-uncommitted",
                f"{member.id} served a linearizable view at store "
                f"version {v}, missing committed entries up to "
                f"{token['required']} — the read barrier was skipped "
                "or broken")
        if lease:
            self.stats["lease_reads"] += 1
            if skew_active:
                self.v.record(
                    "lease-read-safe-under-skew",
                    f"{member.id} served a lease read while a "
                    "clock-skew fault is active — skew voids the "
                    "lease's election-timing argument; it must fall "
                    "back to a read-index quorum round")
            if v < token["required"]:
                # judged against the REQUEST-time frontier (entries
                # committing while the response is in flight are not a
                # linearizability violation): an expired-lease ex-leader
                # honoring its lease lands here
                self.v.record(
                    "lease-read-safe-under-skew",
                    f"{member.id} served a lease read at version {v} "
                    "behind the committed frontier "
                    f"{token['required']} at request time — an expired "
                    "or stale lease was honored")


class OverloadInvariants:
    """Overload-protection-plane invariants (ISSUE 20), judged at
    scenario end against two ledgers:

    * overload-sheds-are-counted-and-recovered — degraded is never
      silently lossy.  Two halves: (1) every shed a CLIENT observed
      (an ``ErrOverloaded`` on a registration or a status batch) must
      be covered by the dispatcher-side shed ledger
      (``stats["sheds"]`` accumulated across attach epochs and read
      planes) — a shed the server didn't count is invisible to
      operators; (2) every task whose status update was shed must
      reach AT LEAST the shed state — or some terminal state, or be
      deleted — in the authoritative store once load subsides: the
      client's level-triggered re-derive plus the jittered backoff
      must have recovered it.
    * heartbeat-liveness-under-stretch — adaptive heartbeat-period
      stretching may slow the cadence, but a node must NEVER be
      expired inside the window the dispatcher PROMISED it (the
      dispatcher counts such expiries as ``premature_expirations``;
      only reachable with the ``stretch_extends_deadline`` seam off).
    """

    def __init__(self, violations: Violations, cp):
        self.v = violations
        self.cp = cp
        #: sheds as the CLIENTS saw them: one per shed registration,
        #: len(batch) per shed status batch
        self.client_sheds = 0
        #: task id -> highest shed state the client tried to report
        self.shed_tasks: Dict[str, int] = {}

    def note_client_shed(self, node_id: str, updates) -> None:
        """Called by the agent the instant it catches ErrOverloaded.
        ``updates`` is the shed (task_id, TaskStatus) batch, or None
        for a shed registration."""
        if updates is None:
            self.client_sheds += 1
            return
        self.client_sheds += len(updates)
        for tid, status in updates:
            st = int(status.state)
            if st > self.shed_tasks.get(tid, 0):
                self.shed_tasks[tid] = st

    def finalize(self) -> None:
        counted = self.cp.dispatcher_stats.get("sheds", 0)
        if self.client_sheds > counted:
            self.v.record(
                "overload-sheds-are-counted-and-recovered",
                f"clients observed {self.client_sheds} admission sheds "
                f"but the dispatcher ledger counted only {counted} — "
                "degradation went silently unaccounted")
        store = self.cp.store
        if store is not None and self.shed_tasks:
            rows = {t.id: t for t in store.view(
                lambda tx: tx.find(Task))}
            lost = []
            for tid, shed_state in sorted(self.shed_tasks.items()):
                t = rows.get(tid)
                if t is None:
                    continue   # reaped/removed: nothing to recover
                got = int(t.status.state)
                # recovered: the store caught up to (or past) what the
                # client tried to report, or the task reached SOME
                # terminal outcome that supersedes the shed report
                if got >= shed_state or got > int(TaskState.RUNNING):
                    continue
                lost.append((tid, shed_state, got))
            if lost:
                tid, shed_state, got = lost[0]
                self.v.record(
                    "overload-sheds-are-counted-and-recovered",
                    f"{len(lost)} shed status update(s) never recovered "
                    f"after heal+grace — e.g. task {tid[:12]} was shed "
                    f"reporting {TaskState(shed_state).name} but the "
                    f"store still shows {TaskState(got).name}")
        premature = self.cp.dispatcher_stats.get(
            "premature_expirations", 0)
        if premature:
            self.v.record(
                "heartbeat-liveness-under-stretch",
                f"{premature} session(s) were expired INSIDE their "
                "promised heartbeat window — the stretched period was "
                "promised to the agent but not honored by the expiry "
                "deadline")


class WatchContinuity:
    """Reference ledger + judgment for ``watch-resume-no-gap-no-dup``.

    The ledger taps EVERY member's replicated store with the watcher's
    own compiled filter (member-agnostic by construction) and records,
    first-writer-wins, the (action, object id) each store version
    resolves to — convergent stores must agree, so a disagreement is
    itself a violation.  At scenario end each watcher's consumed payload
    stream is judged against the ledger: within each resync segment the
    consumed versions must be exactly the matching committed versions in
    order — no duplicate, no gap, no uncommitted interloper — however
    many member hops the stream survived.
    """

    def __init__(self, violations: Violations, pred, managers, tag: str):
        self.v = violations
        self.pred = pred
        self.managers = managers
        self.tag = tag
        self.ref: Dict[int, Tuple[str, str]] = {}
        self._subs: Dict[str, tuple] = {}   # member id -> (store, sub)

    def ensure(self) -> None:
        """(Re)subscribe to every member store; a crash-rebuilt store
        gets a fresh tap (its replayed prefix was already recorded live
        from the surviving members)."""
        for m in self.managers:
            if m.store is None:
                continue
            entry = self._subs.get(m.id)
            if entry is not None and entry[0] is m.store:
                continue
            sub = m.store.queue.subscribe(accepts_blocks=True)
            self._subs[m.id] = (m.store, sub)

    def drain(self) -> None:
        from ..state.events import Event, EventTaskBlock
        for mid, (_store, sub) in self._subs.items():
            while True:
                ev = sub.poll()
                if ev is None:
                    break
                if isinstance(ev, EventTaskBlock):
                    for e in ev.expand_events():
                        self._observe(mid, e)
                elif isinstance(ev, Event):
                    self._observe(mid, ev)

    def _observe(self, mid: str, ev) -> None:
        from ..state.events import event_version
        if not self.pred(ev):
            return
        ver = event_version(ev)
        key = (ev.action, ev.obj.id)
        seen = self.ref.get(ver)
        if seen is None:
            self.ref[ver] = key
        elif seen != key:
            self.v.record(
                "watch-resume-no-gap-no-dup",
                f"{self.tag}: members disagree on version {ver}: "
                f"{seen} vs {key} (from {mid}) — resume tokens are "
                "not member-portable")

    def judge(self, watcher) -> None:
        """Scenario end (all faults healed, watcher fully drained):
        validate every consumed segment against the ledger."""
        self.drain()
        ref_versions = sorted(self.ref)
        for seg in watcher.segments:
            start = seg["start"]
            consumed = seg["events"]
            last = consumed[-1][0] if consumed else start
            expected = [v for v in ref_versions if start < v <= last]
            got = [c[0] for c in consumed]
            if got != expected:
                gaps = sorted(set(expected) - set(got))[:5]
                dups = sorted({v for v in got
                               if got.count(v) > 1} | (set(got)
                              - set(expected)))[:5]
                self.v.record(
                    "watch-resume-no-gap-no-dup",
                    f"{watcher.name}: segment from v{start} diverged "
                    f"from the committed stream (missing {gaps}, "
                    f"extra/dup {dups}) across {watcher.hops} member "
                    "hop(s)")
                continue
            for ver, action, oid in consumed:
                if self.ref.get(ver) != (action, oid):
                    self.v.record(
                        "watch-resume-no-gap-no-dup",
                        f"{watcher.name}: payload at v{ver} is "
                        f"({action}, {oid}) but the cluster committed "
                        f"{self.ref.get(ver)}")
        # liveness: after heal+grace the stream must have caught up
        if ref_versions and watcher.segments:
            tail = watcher.segments[-1]
            last = tail["events"][-1][0] if tail["events"] \
                else tail["start"]
            behind = [v for v in ref_versions if v > last]
            if behind:
                self.v.record(
                    "watch-resume-no-gap-no-dup",
                    f"{watcher.name}: stream ended {len(behind)} "
                    f"committed event(s) behind the cluster "
                    f"(first missing v{behind[0]})")


def check_placement_quality(violations: Violations, store,
                            bound: float = 3.0,
                            record: str = "placement-quality") -> None:
    """Post-convergence placement-quality bound: with every fault healed,
    no live node may hold more than ``bound`` times the ideal even share
    of the RUNNING tasks (quality, not just safety — a converged-but-
    pathological packing is a scheduler regression chaos must catch)."""
    tasks = [t for t in store.view(lambda tx: tx.find(Task))
             if t.node_id
             and t.desired_state == TaskState.RUNNING
             and TaskState(t.status.state) == TaskState.RUNNING]
    nodes = [n for n in store.view(lambda tx: tx.find(Node))
             if n.status.state != NodeState.DOWN]
    if not tasks or not nodes or len(tasks) < len(nodes):
        return   # too sparse for a spread claim
    per_node: Dict[str, int] = {}
    for t in tasks:
        per_node[t.node_id] = per_node.get(t.node_id, 0) + 1
    ideal = len(tasks) / len(nodes)
    worst = max(per_node.items(), key=lambda kv: (kv[1], kv[0]))
    if worst[1] > bound * ideal:
        violations.record(
            record,
            f"node {worst[0]} runs {worst[1]} of {len(tasks)} tasks "
            f"(ideal {ideal:.1f}/node across {len(nodes)} live nodes, "
            f"bound {bound:.1f}x)")
