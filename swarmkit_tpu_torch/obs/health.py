"""Declarative SLO/health evaluator over the metrics registry.

Each check reads a live signal (timer quantile, counter ratio) and
compares it against warn/fail thresholds; the evaluator tracks per-check
state transitions (pass -> warn -> fail -> recover), exports every state
as a ``swarm_health{check="..."}`` gauge (0=pass, 1=warn, 2=fail), and
notes every transition into the flight recorder so a post-mortem shows
*when* a signal degraded, not just that it did.

``/debug/health`` (utils/httpdebug) serves ``report()`` — pass/warn/fail
per check plus the offending sample window from the flight recorder's
time series — and returns HTTP 503 while any check is failing, so
load-balancer/probe consumers need no JSON parsing.

Checks with no data (a timer never observed, a counter never
incremented) report ``pass`` with ``value: null`` — a fresh manager is
healthy, not unknown-unhealthy.  Thresholds are constructor arguments;
the defaults are sized for the production-shape bench (100k-task ticks
well under a second of p99 budget).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..models import types as _types
from ..utils.metrics import Registry
from ..utils.metrics import registry as _default_registry
from .flightrec import FlightRecorder, flightrec

PASS, WARN, FAIL = "pass", "warn", "fail"
_STATE_VALUE = {PASS: 0, WARN: 1, FAIL: 2}


@dataclass
class Check:
    name: str
    value: Callable[[Registry], Optional[float]]
    warn: float
    fail: float
    unit: str = ""
    #: sampler-row key prefixes relevant to this check — report() uses
    #: them to attach the offending sample window from the recorder
    window_prefixes: Tuple[str, ...] = field(default_factory=tuple)

    def judge(self, v: Optional[float]) -> str:
        if v is None:
            return PASS
        if v >= self.fail:
            return FAIL
        if v >= self.warn:
            return WARN
        return PASS


# --------------------------------------------------------- value accessors

def timer_p99(name: str) -> Callable[[Registry], Optional[float]]:
    def get(reg: Registry) -> Optional[float]:
        t = reg.get_timer(name)
        if t is None or t.count == 0:
            return None
        return t.quantiles()[0.99]
    return get


def counter_ratio(numerator: str, denominators: Tuple[str, ...]
                  ) -> Callable[[Registry], Optional[float]]:
    """numerator / sum(denominators), None while the denominator is 0."""
    def get(reg: Registry) -> Optional[float]:
        total = sum(reg.get_counter(d) for d in denominators)
        if total <= 0:
            return None
        return reg.get_counter(numerator) / total
    return get


def gauge_value(name: str) -> Callable[[Registry], Optional[float]]:
    """Latest value of a gauge; None (pass) until first export."""
    def get(reg: Registry) -> Optional[float]:
        return reg.get_gauge(name)
    return get


_ROUTES = tuple(f'swarm_planner_groups{{route="{r}"}}'
                for r in ("device", "fallback", "host_small", "spill",
                          "breaker"))

_STATE_PREFIX = 'swarm_update_state{service="'


def stuck_rollout_value() -> Callable[[Registry], Optional[float]]:
    """Worst rollout condition across services: 0 = every rollout is
    progressing (pass), 1 = a rollout sits PAUSED / ROLLBACK_PAUSED
    after tripping its failure threshold (warn — operator attention,
    not an outage), 2 = an ACTIVE rollout has stamped no forward
    progress for longer than its own monitor window (fail — stuck, the
    supervisor should have either advanced a slot or declared a
    verdict by now).  None (pass) until a first update exports state.

    Reads the gauges orchestrator/update.py exports on every committed
    status write and slot completion: ``swarm_update_state{service=}``,
    ``swarm_update_last_progress{service=}`` (progress stamp) and
    ``swarm_update_monitor{service=}`` (per-rollout window)."""
    from ..models.types import UpdateState
    active = (float(UpdateState.UPDATING),
              float(UpdateState.ROLLBACK_STARTED))
    paused = (float(UpdateState.PAUSED),
              float(UpdateState.ROLLBACK_PAUSED))

    def get(reg: Registry) -> Optional[float]:
        states = reg.gauges_snapshot(_STATE_PREFIX)
        if not states:
            return None
        worst = 0.0
        t = _types.now()
        for name, state in states.items():
            svc = name[len(_STATE_PREFIX):-len('"}')]
            if state in paused:
                worst = max(worst, 1.0)
            elif state in active:
                last = reg.get_gauge(
                    f'swarm_update_last_progress{{service="{svc}"}}')
                monitor = reg.get_gauge(
                    f'swarm_update_monitor{{service="{svc}"}}')
                if last is not None and monitor is not None \
                        and t - last > monitor:
                    worst = max(worst, 2.0)
        return worst
    return get


def stale_read_risk_value(read_index_p99_bound: float = 2.0
                          ) -> Callable[[Registry], Optional[float]]:
    """Follower-served read plane risk: 2 (fail) the moment ANY stale
    serve was counted (``swarm_stale_reads`` — the invariant-adjacent
    counter the read barrier/lease checks increment when a view would
    have been served behind the committed frontier; correct operation
    keeps it at zero forever), 1 (warn) while lease reads are not being
    served (``swarm_lease_enabled`` = 0: the latest barrier fell back to
    a quorum round — clock-skew veto, lease churn, or no leader lease)
    AND the read-index fallback's p99 is above bound — reads are safe
    but every one pays a quorum round.  None (pass) until the read
    plane exports its first signal."""
    def get(reg: Registry) -> Optional[float]:
        if reg.get_counter("swarm_stale_reads") > 0:
            return 2.0
        lease = reg.get_gauge("swarm_lease_enabled")
        t = reg.get_timer("swarm_read_index_latency")
        if lease is None and (t is None or t.count == 0):
            return None
        if lease == 0.0 and t is not None and t.count \
                and t.quantiles()[0.99] > read_index_p99_bound:
            return 1.0
        return 0.0
    return get


_FLAP_PREFIX = 'swarm_autoscale_flapping{service="'
_OOB_PREFIX = 'swarm_autoscale_out_of_bounds{service="'


def autoscale_flapping_value() -> Callable[[Registry], Optional[float]]:
    """Autoscaler condition across services: 2 (fail) when any
    autoscaled service's replicas sit outside its [min, max] bounds —
    the loop wrote (or inherited) an out-of-policy state; 1 (warn)
    while any service's flap breaker is engaged — the policy froze
    itself after too many direction reversals and needs operator
    attention (or a better target); 0 otherwise.  None (pass) until a
    supervisor exports its first gauge.  Reads the gauges
    orchestrator/autoscaler.py exports on every drive."""
    def get(reg: Registry) -> Optional[float]:
        flaps = reg.gauges_snapshot(_FLAP_PREFIX)
        oob = reg.gauges_snapshot(_OOB_PREFIX)
        if not flaps and not oob:
            return None
        if any(v for v in oob.values()):
            return 2.0
        if any(v for v in flaps.values()):
            return 1.0
        return 0.0
    return get


def plane_saturation_value(plane_name: str, occ_warn: float = 0.85,
                           age_n: int = 4, age_floor: float = 0.5
                           ) -> Callable[[Registry], Optional[float]]:
    """Saturation condition for one serving plane (obs/planes.py): 1
    (warn) while the rolled occupancy sits at/above ``occ_warn`` — the
    plane is near its capacity ceiling; 2 (fail) when the plane's
    oldest-item age grew STRICTLY monotonically across the last
    ``age_n`` evaluations and is above ``age_floor`` — the backlog is
    unbounded, work is aging out faster than the plane drains it.
    None (pass) until the plane exports its first gauges (a fresh
    manager with zero observations is healthy, not unknown)."""
    occ_name = f'swarm_plane_occupancy{{plane="{plane_name}"}}'
    age_name = f'swarm_plane_oldest_age_s{{plane="{plane_name}"}}'
    history: deque = deque(maxlen=age_n)

    def get(reg: Registry) -> Optional[float]:
        occ = reg.get_gauge(occ_name)
        age = reg.get_gauge(age_name)
        if occ is None and age is None:
            return None
        if age is not None:
            history.append(age)
        if len(history) == age_n and history[-1] >= age_floor \
                and all(b > a for a, b in
                        zip(history, list(history)[1:])):
            return 2.0
        if occ is not None and occ >= occ_warn:
            return 1.0
        return 0.0
    return get


def apply_lag_value(warn_entries: float = 256.0, n: int = 4
                    ) -> Callable[[Registry], Optional[float]]:
    """Raft apply-plane lag (commit_index - applied_index, exported as
    the ``raft_apply`` plane's queue depth): 1 (warn) at/above
    ``warn_entries`` — the committer is behind but may be catching up;
    2 (fail) when the lag is over the bar AND grew strictly across the
    last ``n`` evaluations — a stalled committer, the backlog can only
    grow.  None (pass) before the raft plane exports."""
    name = 'swarm_plane_queue_depth{plane="raft_apply"}'
    history: deque = deque(maxlen=n)

    def get(reg: Registry) -> Optional[float]:
        lag = reg.get_gauge(name)
        if lag is None:
            return None
        history.append(lag)
        if len(history) == n and lag >= warn_entries \
                and all(b > a for a, b in
                        zip(history, list(history)[1:])):
            return 2.0
        if lag >= warn_entries:
            return 1.0
        return 0.0
    return get


def dispatcher_overload_value(n: int = 4
                              ) -> Callable[[Registry], Optional[float]]:
    """Dispatcher backpressure condition: 1 (warn) while admission
    sheds are actively being counted (``swarm_dispatcher_sheds`` grew
    since the last evaluation — the edge is rejecting work, clients are
    re-queuing under backoff); 2 (fail) when sheds grew STRICTLY across
    the last ``n`` evaluations — sustained overload, load is not
    subsiding and degraded service is the steady state.  None (pass)
    until the dispatcher exports its first overload signal."""
    history: deque = deque(maxlen=n)

    def get(reg: Registry) -> Optional[float]:
        sheds = reg.get_counter("swarm_dispatcher_sheds")
        if sheds <= 0 \
                and reg.get_gauge("swarm_dispatcher_pending_updates") \
                is None:
            return None
        history.append(sheds)
        if len(history) == n and all(b > a for a, b in
                                     zip(history, list(history)[1:])):
            return 2.0
        if len(history) >= 2 and history[-1] > history[-2]:
            return 1.0
        return 0.0
    return get


def heartbeat_stretch_value(stretch_warn: float = 2.0
                            ) -> Callable[[Registry], Optional[float]]:
    """Heartbeat-stretch condition: 2 (fail) the moment ANY premature
    expiration is counted (``swarm_dispatcher_premature_expirations`` —
    a node marked DOWN inside the window the dispatcher PROMISED it;
    correct stretching keeps it at zero forever, the
    heartbeat-liveness-under-stretch invariant in live form); 1 (warn)
    while the advertised stretch factor is at/over ``stretch_warn`` —
    agents have been told to slow down materially, the session plane is
    loaded.  None (pass) until the stretch plane exports."""
    def get(reg: Registry) -> Optional[float]:
        if reg.get_counter("swarm_dispatcher_premature_expirations") > 0:
            return 2.0
        s = reg.get_gauge("swarm_dispatcher_hb_stretch")
        if s is None \
                and reg.get_counter("swarm_dispatcher_hb_stretches") <= 0:
            return None
        if s is not None and s >= stretch_warn:
            return 1.0
        return 0.0
    return get


def default_checks(tick_warn: float = 5.0, tick_fail: float = 30.0,
                   edge_warn: float = 10.0, edge_fail: float = 60.0,
                   fallback_warn: float = 0.1, fallback_fail: float = 0.5,
                   propose_warn: float = 2.0, propose_fail: float = 10.0,
                   hb_warn: float = 0.05, hb_fail: float = 0.25
                   ) -> List[Check]:
    return [
        Check("tick_p99", timer_p99("swarm_scheduler_tick_latency"),
              tick_warn, tick_fail, "s",
              ("swarm_scheduler_",)),
        Check("lifecycle_assign_p99",
              timer_p99('swarm_task_lifecycle'
                        '{from="pending",to="assigned"}'),
              edge_warn, edge_fail, "s",
              ("swarm_task_lifecycle",)),
        Check("planner_fallback_rate",
              counter_ratio('swarm_planner_groups{route="fallback"}',
                            _ROUTES),
              fallback_warn, fallback_fail, "ratio",
              ("swarm_planner_",)),
        Check("raft_propose_p99", timer_p99("swarm_raft_propose_latency"),
              propose_warn, propose_fail, "s",
              ("swarm_raft_",)),
        Check("heartbeat_miss_rate",
              counter_ratio("swarm_dispatcher_heartbeat_expirations",
                            ("swarm_dispatcher_heartbeats",)),
              hb_warn, hb_fail, "ratio",
              ("swarm_dispatcher_heartbeat",)),
        # device-path circuit breaker (ops/planner.py PlannerBreaker):
        # 0=closed (pass), 1=half-open probing (warn), 2=open — every
        # group on host fallback (fail).  Degraded throughput, not an
        # outage: placements stay valid, so this is the check that says
        # "the device is sick", not "the manager is down".
        Check("planner_breaker",
              gauge_value("swarm_planner_breaker_state"),
              1.0, 2.0, "state",
              ("swarm_planner_",)),
        # rolling updates (orchestrator/update.py): 1 = paused at the
        # failure threshold (warn), 2 = an active rollout stopped
        # making progress past its monitor window (fail)
        Check("stuck_rollout", stuck_rollout_value(),
              1.0, 2.0, "state",
              ("swarm_update_",)),
        # priority inversions (scheduler/preempt.py): pending positive-
        # priority tasks still unplaced after the preemption pass while
        # lower-priority work holds capacity — warn on the first one
        # (budget/cooldown may legitimately defer a tick or two), fail
        # when the important band is piling up behind the cheap one
        Check("priority_inversion",
              gauge_value("swarm_priority_inversion"),
              1.0, 8.0, "tasks",
              ("swarm_priority_", "swarm_preempt")),
        # follower-served reads (state/raft read-index + leader lease):
        # fail = a stale serve was ever counted (safety breach — the
        # read plane served behind the committed frontier), warn = lease
        # disabled AND the read-index fallback is slow (every read pays
        # a quorum round)
        Check("stale_read_risk", stale_read_risk_value(),
              1.0, 2.0, "state",
              ("swarm_read_", "swarm_lease_", "swarm_stale_",
               "swarm_leader_read_")),
        # autoscaler (orchestrator/autoscaler.py): 1 = a flap breaker is
        # engaged (policy frozen after direction reversals), 2 = an
        # autoscaled service's replicas are outside [min, max]
        Check("autoscale_flapping", autoscale_flapping_value(),
              1.0, 2.0, "state",
              ("swarm_autoscale_", "swarm_tenant_quota_")),
        # per-plane saturation (obs/planes.py, ISSUE 17): 1 = the
        # scheduler plane's tick occupancy is sustained at/over 85%,
        # 2 = its pending-backlog age grows without bound
        Check("scheduler_occupancy", plane_saturation_value("scheduler"),
              1.0, 2.0, "state",
              ("swarm_plane_", "swarm_scheduler_")),
        # raft apply plane: 1 = apply lag over the entry bar, 2 = a
        # stalled committer (lag over the bar and strictly growing)
        Check("apply_lag", apply_lag_value(),
              1.0, 2.0, "state",
              ("swarm_plane_", "swarm_raft_")),
        # dispatcher backpressure (manager/dispatcher.py overload
        # plane): 1 = admission sheds actively counted, 2 = sheds
        # growing strictly across evaluations (sustained overload)
        Check("dispatcher_overload", dispatcher_overload_value(),
              1.0, 2.0, "state",
              ("swarm_dispatcher_", "swarm_plane_")),
        # heartbeat stretching: 1 = agents told to slow down >= 2x,
        # 2 = a node was DOWNed inside its promised window (liveness
        # breach — the stretch the expiry deadline forgot)
        Check("heartbeat_stretch", heartbeat_stretch_value(),
              1.0, 2.0, "state",
              ("swarm_dispatcher_h",)),
    ]


class HealthEvaluator:
    def __init__(self, registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 checks: Optional[List[Check]] = None):
        self.registry = registry or _default_registry
        self.recorder = recorder or flightrec
        self.checks = checks if checks is not None else default_checks()
        self._state: Dict[str, str] = {}
        self._value: Dict[str, Optional[float]] = {}
        #: (t, check, old_state, new_state) history — a deque keeps the
        #: NEWEST entries when it fills (the recent degradation is the
        #: evidence /debug/health exists for, not the oldest one)
        self.transitions: deque = deque(maxlen=256)

    # ------------------------------------------------------------ evaluating

    def evaluate(self) -> Dict[str, str]:
        """Run every check once; returns {check: state}.  Exports
        ``swarm_health{check=...}`` gauges and notes state changes to
        the flight recorder."""
        t = _types.now()
        out: Dict[str, str] = {}
        for c in self.checks:
            try:
                v = c.value(self.registry)
            except Exception:
                v = None
            state = c.judge(v)
            prev = self._state.get(c.name, PASS)
            if state != prev:
                self.transitions.append((t, c.name, prev, state))
                self.recorder.note(
                    f"health {c.name}: {prev} -> {state}"
                    f" (value={v!r} warn={c.warn} fail={c.fail})")
            self._state[c.name] = state
            self._value[c.name] = v
            self.registry.gauge(f'swarm_health{{check="{c.name}"}}',
                                _STATE_VALUE[state])
            out[c.name] = state
        return out

    def failing(self) -> bool:
        return FAIL in self._state.values()

    def status(self) -> str:
        states = self._state.values()
        if FAIL in states:
            return FAIL
        if WARN in states:
            return WARN
        return PASS

    # --------------------------------------------------------------- report

    def _window(self, prefixes: Tuple[str, ...], n: int = 10) -> list:
        """The offending sample window: the recorder's most recent rows
        trimmed to this check's metric families."""
        rows = []
        for row in self.recorder.samples.items()[-n:]:
            keep = {}
            for section in ("counters", "timer_counts", "timer_totals",
                            "gauges"):
                vals = row.get(section) or {}
                hit = {k: v for k, v in vals.items()
                       if any(k.startswith(p) for p in prefixes)}
                if hit:
                    keep[section] = hit
            if keep:
                keep["t"] = row.get("t")
                rows.append(keep)
        return rows

    def report(self) -> Dict[str, object]:
        self.evaluate()
        checks = {}
        for c in self.checks:
            state = self._state[c.name]
            entry: Dict[str, object] = {
                "state": state,
                "value": self._value[c.name],
                "warn": c.warn, "fail": c.fail, "unit": c.unit,
            }
            if state != PASS:
                entry["window"] = self._window(c.window_prefixes)
            checks[c.name] = entry
        return {
            "status": self.status(),
            "checks": checks,
            "transitions": [
                {"t": t, "check": name, "from": a, "to": b}
                for t, name, a, b in list(self.transitions)[-32:]],
        }


# the default evaluator /debug/health and the Manager share
evaluator = HealthEvaluator()
