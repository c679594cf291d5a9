"""Causal per-task journeys: a bounded, sampled milestone ledger.

A *journey* is the ordered milestone record of one task's path to
RUNNING::

    created -> admitted -> planned -> committed -> assigned_sent
            -> agent_ack -> running

Every milestone except ``assigned_sent`` is minted from REPLICATED
store state — the stamped ``status.timestamp`` of the watch event's
task (``meta.created_at`` for creation) plus the store's version token
(``state.events.event_version``) — never from observation time.  Both
are identical on every member: the leader and a follower watching the
same committed changes mint byte-identical milestones, which is what
makes a journey survive leader failover *stitched* (the successor's
events dedup against the milestones the deposed leader already
produced) rather than truncated.  ``assigned_sent`` is the one
leader-local milestone: the dispatcher's fan-out stamps it at send
time through ``models.types.now()`` — deterministic under the sim's
virtual clock, absent on members that never served the session (edges
simply skip missing milestones).

Sampling is deterministic and PYTHONHASHSEED-independent:
``zlib.crc32(task_id)`` against ``sample_rate`` decides admission (the
same task is sampled on every member), and a hard cap
(``JOURNEY_CAP``, SERVICE_TIMER_CAP-style) bounds memory at O(sample)
whatever the cluster size; refusals are counted, never silent.

``critical_path()`` is the attribution join: over the slowest
time-to-running cohort it splits each journey into per-edge durations,
charges each edge to the later milestone's owning plane, and
normalizes — "62% scheduler, 21% dispatcher, …".  The
``planned -> committed`` edge is zero-width today (both ride the same
replicated stamp; the version token still records the commit) so the
commit plane's share surfaces through the plane-occupancy windows
(obs/planes.py) that ``scripts/trace_report.py --critical-path``
prints alongside.
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..models import types as _types
from ..models.objects import Task
from ..models.types import TaskState
from ..state.events import (
    Event, EventSnapshotRestore, EventTaskBlock, event_version,
)

#: hard cap on distinct sampled tasks (SERVICE_TIMER_CAP discipline):
#: beyond it new tasks are refused and counted on ``overflow`` — a
#: million-task tick costs O(cap), not O(tasks)
JOURNEY_CAP = 4096

#: milestone grammar: name -> (order, owning plane).  An edge between
#: consecutive present milestones is charged to the LATER one's plane.
MILESTONES: Dict[str, Tuple[int, str]] = {
    "created": (0, "api"),
    "admitted": (1, "orchestrator"),
    "planned": (2, "scheduler"),
    "committed": (3, "commit"),
    "assigned_sent": (4, "dispatcher"),
    "agent_ack": (5, "agent"),
    "running": (6, "agent"),
}

_STATE_MILESTONE = {
    int(TaskState.PENDING): "admitted",
    int(TaskState.ACCEPTED): "agent_ack",
    int(TaskState.RUNNING): "running",
}


def _sampled(task_id: str, rate: float) -> bool:
    """Deterministic, hash-order-independent admission: the crc32 of
    the task id against ``rate`` — NOT ``hash()``, which varies with
    PYTHONHASHSEED and would sample different tasks per process."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(task_id.encode()) & 0xFFFFFFFF) < rate * 2**32


class JourneyLedger:
    """Bounded milestone ledger.  Enable/disable is one attribute check
    per event; disabled it costs nothing measurable (the Tracer
    contract)."""

    def __init__(self, sample_rate: float = 1.0, cap: int = JOURNEY_CAP):
        self.enabled = False
        self.sample_rate = sample_rate
        self.cap = cap
        self._mu = threading.Lock()
        # task_id -> {milestone: (ts, version)}
        self._tasks: Dict[str, Dict[str, Tuple[float, int]]] = {}
        self.overflow = 0
        self.refused = 0   # rate-rejected sightings (distinct events)

    # ------------------------------------------------------------- recording

    def _admit(self, task_id: str) -> Optional[Dict]:
        """The task's milestone map, or None when sampled out / over
        cap.  Caller holds no lock."""
        with self._mu:
            m = self._tasks.get(task_id)
            if m is not None:
                return m
            if not _sampled(task_id, self.sample_rate):
                self.refused += 1
                return None
            if len(self._tasks) >= self.cap:
                self.overflow += 1
                return None
            m = self._tasks[task_id] = {}
            return m

    def _mark(self, task_id: str, milestone: str, ts: float,
              version: int = 0) -> None:
        m = self._admit(task_id)
        if m is None or milestone in m:
            return   # dedup: replicated stamps make re-sightings
        #          (other members, post-failover replays) idempotent
        m[milestone] = (float(ts), int(version))

    def note_sent(self, task_id: str, ts: Optional[float] = None) -> None:
        """Dispatcher fan-out milestone (the one leader-local stamp):
        the assignment left the manager for the agent's session."""
        if not self.enabled:
            return
        self._mark(task_id, "assigned_sent",
                   _types.now() if ts is None else ts)

    def observe_task(self, t, version: int = 0,
                     created: bool = False) -> None:
        """Mint the milestones one task sighting carries."""
        status = getattr(t, "status", None)
        if status is None:
            return
        state = int(status.state)
        ts = status.timestamp or 0.0
        if created:
            meta = getattr(t, "meta", None)
            created_at = meta.created_at if meta is not None else 0.0
            if created_at:
                self._mark(t.id, "created", created_at, version)
        if state == int(TaskState.ASSIGNED):
            # one replicated stamp carries both the plan decision and
            # the committed write; the version token is the commit's
            self._mark(t.id, "planned", ts, version)
            self._mark(t.id, "committed", ts, version)
            return
        name = _STATE_MILESTONE.get(state)
        if name is not None and ts:
            self._mark(t.id, name, ts, version)

    def handle_event(self, ev) -> None:
        """Watch-queue tap (flightrec.poll_store drives this in both
        production and the sim)."""
        if not self.enabled:
            return
        if isinstance(ev, EventTaskBlock):
            base, ts = ev.base_version, ev.ts
            for i, old in enumerate(ev.olds):
                self._mark(old.id, "planned", ts, base + 1 + i)
                self._mark(old.id, "committed", ts, base + 1 + i)
            return
        if isinstance(ev, EventSnapshotRestore):
            return   # journeys ride replicated stamps: nothing to drop
        if isinstance(ev, Event) and isinstance(ev.obj, Task):
            if ev.action == "delete":
                return
            self.observe_task(ev.obj, event_version(ev),
                              created=ev.action == "create")

    # --------------------------------------------------------------- reading

    def journeys(self) -> Dict[str, List[Tuple[str, float, int]]]:
        """task_id -> ordered [(milestone, ts, version), ...] —
        sorted by milestone order then task id, for stable output."""
        with self._mu:
            snap = {tid: dict(m) for tid, m in self._tasks.items()}
        out = {}
        for tid in sorted(snap):
            ms = snap[tid]
            out[tid] = [(name, ms[name][0], ms[name][1])
                        for name in sorted(ms,
                                           key=lambda n: MILESTONES[n][0])]
        return out

    def edges(self, milestones: List[Tuple[str, float, int]]
              ) -> List[Tuple[str, float, str]]:
        """Per-edge durations of one journey: [(edge, dt, plane)]
        between consecutive present milestones, charged to the later
        milestone's plane.  Clamped at 0 — a replicated stamp never
        runs backwards, but a leader-local ``assigned_sent`` under
        clock skew may."""
        out = []
        for (a, ta, _va), (b, tb, _vb) in zip(milestones, milestones[1:]):
            out.append((f"{a}->{b}", max(0.0, tb - ta), MILESTONES[b][1]))
        return out

    def critical_path(self, quantile: float = 0.99
                      ) -> Dict[str, object]:
        """Per-plane attribution of time-to-running at ``quantile``:
        take the slowest cohort of complete (created..running)
        journeys, sum each journey's per-edge durations by plane, and
        normalize.  The fractions sum to ~1.0 because the edges of one
        journey partition exactly its created->running interval."""
        complete = []
        for tid, ms in self.journeys().items():
            names = {name for name, _ts, _v in ms}
            if "created" in names and "running" in names:
                total = ms[-1][1] - ms[0][1]
                complete.append((tid, ms, max(0.0, total)))
        if not complete:
            return {"tasks": 0, "cohort": 0, "p": quantile,
                    "total_s": 0.0, "planes": {}}
        totals = sorted(t for _tid, _ms, t in complete)
        # nearest-rank quantile (utils.metrics.Timer discipline)
        idx = max(0, min(len(totals) - 1,
                         int(round(quantile * len(totals))) - 1))
        bar = totals[idx]
        cohort = [(tid, ms, t) for tid, ms, t in complete if t >= bar]
        by_plane: Dict[str, float] = {}
        grand = 0.0
        for _tid, ms, _t in cohort:
            for _edge, dt, plane in self.edges(ms):
                by_plane[plane] = by_plane.get(plane, 0.0) + dt
                grand += dt
        planes = {
            p: {"seconds": round(s, 9),
                "frac": round(s / grand, 6) if grand > 0 else 0.0}
            for p, s in sorted(by_plane.items())}
        # device sub-attribution for the ``planned`` milestone: the
        # scheduler plane's edge gains a NESTED breakdown (dispatch vs
        # d2h vs compile from the device-telemetry ledger) — nested,
        # not a sibling plane row, so per-plane fracs still sum to ~1.0
        # (the trace_report --critical-path invariant).
        sched_row = planes.get("scheduler")
        if sched_row is not None:
            from . import devicetelemetry as _devtel
            sub = _devtel.journey_sub_attribution(sched_row["seconds"])
            if sub:
                sched_row["device_sub"] = sub
        return {"tasks": len(complete), "cohort": len(cohort),
                "p": quantile, "total_s": round(grand, 9),
                "planes": planes}

    def summary(self) -> Dict[str, object]:
        with self._mu:
            n = len(self._tasks)
            complete = sum(1 for m in self._tasks.values()
                           if "created" in m and "running" in m)
            return {"sampled_tasks": n, "complete": complete,
                    "overflow": self.overflow, "refused": self.refused,
                    "cap": self.cap, "sample_rate": self.sample_rate}

    def journey_of(self, task_id: str
                   ) -> List[Tuple[str, float, int]]:
        """One task's milestones (empty when unsampled) — the flight
        recorder dumps these for invariant-implicated tasks."""
        with self._mu:
            ms = dict(self._tasks.get(task_id) or {})
        return [(name, ms[name][0], ms[name][1])
                for name in sorted(ms, key=lambda n: MILESTONES[n][0])]

    # ------------------------------------------------------------------ dump

    def dump(self) -> Dict[str, object]:
        return {"summary": self.summary(), "journeys": self.journeys()}

    def dump_bytes(self) -> bytes:
        """Canonical bytes: the byte-identity surface the sim's
        determinism assertions compare across seeds and re-runs."""
        return json.dumps(self.dump(), sort_keys=True,
                          separators=(",", ":")).encode()

    # ------------------------------------------------------------- lifecycle

    def reset(self, sample_rate: Optional[float] = None,
              cap: Optional[int] = None) -> None:
        with self._mu:
            self._tasks = {}
            self.overflow = 0
            self.refused = 0
            if sample_rate is not None:
                self.sample_rate = sample_rate
            if cap is not None:
                self.cap = cap

    def save_state(self):
        with self._mu:
            return (self._tasks, self.overflow, self.refused,
                    self.enabled, self.sample_rate, self.cap)

    def restore_state(self, state) -> None:
        with self._mu:
            (self._tasks, self.overflow, self.refused, self.enabled,
             self.sample_rate, self.cap) = state


# the process-wide ledger: the Manager, the sim runner, and bench all
# tap the same instance (flightrec.journey_sink feeds it store events)
journeys = JourneyLedger()
