"""Pipeline workflows: DAG-gated rollout across services.

A service naming upstream services in ``ServiceSpec.depends_on``
(validated acyclic by the control API) is a *pipeline stage*: the
scheduler's gate (scheduler/gang.py ``pipeline_gate``) holds its tasks
back until this supervisor **releases** the stage — every upstream is
ready (replicated services: RUNNING count >= desired replicas; jobs:
completions reached; global: at least one task RUNNING).  Release is
*sticky*: later upstream churn (restarts, node loss) never re-gates a
stage that already started, so steady-state convergence is monotone.

Failure cascades: an upstream observed *poisoned* (``POISON_FAILURES``
cumulative task failures) — or itself halted — **halts** every
downstream stage.  A halted stage's pending tasks defer at the gate
with the halt reason; ``ServiceSpec.on_upstream_failure ==
"rollback"`` additionally scales the stage to zero replicas so its
running tasks drain.  Halt verdicts are sticky: the operator re-arms
a halted stage with controlapi ``resume_pipeline`` after fixing the
poison — the resume stamps a ``resumed_at`` watermark that forgives
every failure observed at/before it (replicated ledger cleared in the
resume transaction, leader-local ledgers dropped on seeing the fresh
stamp, pre-watermark failed task rows skipped on re-scan).

The loop is the established threadless-drivable FSM shape
(orchestrator/autoscaler.py, update.py): production wraps one thread
(``start_worker=True``); the simulator constructs
``start_worker=False`` and pumps ``drive()`` from the leader's control
step under virtual time.  Verdicts write ``Service.pipeline_status``
(models/objects.py) through ``store.update`` — epoch-pinned at commit,
replicated with the row — so a successor leader's supervisor resumes
released/halted stages exactly where the deposed one left them.
Failure OBSERVATIONS replicate too: every drive folds newly seen
distinct failed-task ids into ``PipelineStatus.failed_ids`` on the
committed row, so a poison count at 2/3 on a crashed leader trips on
the successor's first new observation instead of restarting at zero.

``_cascade_enabled`` is the checker-sensitivity seam: with it off a
poisoned upstream no longer halts downstream stages and the sim's
``pipeline-chaos`` scenario expectations must catch the miss.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set, Tuple

from ..models.objects import PipelineStatus, Service, Task
from ..models.specs import ServiceMode
from ..models.types import TaskState, now
from ..state.store import MemoryStore, WriteTx
from ..utils.metrics import registry as _metrics

log = logging.getLogger("pipeline")

#: cumulative task failures observed on one service before the
#: supervisor declares it poisoned and halts its downstream stages
POISON_FAILURES = 3


class PipelineSupervisor:
    """One release/halt decision pass per ``drive()`` over every
    service that names upstream dependencies."""

    #: checker-sensitivity seam (tests/test_gang.py): False disables
    #: the failure cascade — a poisoned upstream then never halts its
    #: downstream stages and the chaos expectations must fire.
    _cascade_enabled = True

    def __init__(self, store: MemoryStore, start_worker: bool = True,
                 interval: float = 2.0):
        self.store = store
        self.interval = interval
        self.threadless = not start_worker
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: leader-local failure observation: service id -> task ids
        #: seen FAILED/REJECTED at least once (cumulative — a restarted
        #: slot failing again is a NEW task id, so flapping accrues)
        self._failed_seen: Dict[str, Set[str]] = {}
        #: last ``resumed_at`` watermark acted on per service — a fresh
        #: stamp (operator resume_pipeline) drops local observations
        self._resume_seen: Dict[str, float] = {}
        self.stats = {"released": 0, "halted": 0, "rollbacks": 0}

    # --------------------------------------------------------------- running

    def start(self) -> None:
        """Production mode: one daemon thread, drive every interval."""
        if self.threadless or (self._thread is not None
                               and self._thread.is_alive()):
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.drive()
                except Exception:
                    log.exception("pipeline pass failed")

        self._thread = threading.Thread(target=loop, name="pipeline",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Teardown without store writes (deposed-leader discipline)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---------------------------------------------------------------- drive

    def drive(self) -> None:
        """One synchronous decision pass.  Threadless mode re-raises
        store failures (leadership loss) to the caller — the sim's
        control step handles the deposal, exactly like the update,
        restart, and autoscale supervisors."""
        services, tasks = self.store.view(
            lambda tx: (tx.find(Service), tx.find(Task)))
        stages = [s for s in services if s.spec.depends_on]
        if not stages:
            return
        by_name: Dict[str, Service] = {
            s.spec.annotations.name: s for s in services}
        by_service: Dict[str, List[Task]] = {}
        for t in tasks:
            by_service.setdefault(t.service_id, []).append(t)
        # only pipeline participants (stages + their upstreams) carry
        # replicated observations — an unrelated service's failures are
        # the restart supervisor's business, not a pipeline verdict
        dep_names = {d for s in stages for d in s.spec.depends_on}
        relevant = {s.id for s in stages} | {
            s.id for s in services
            if s.spec.annotations.name in dep_names}
        poisoned = self._observe_failures(services, by_service,
                                          relevant)

        for svc in sorted(stages, key=lambda s: s.id):
            try:
                self._drive_stage(svc, by_name, by_service, poisoned)
            except Exception:
                if self.threadless:
                    raise
                log.exception("pipeline decision for %s failed", svc.id)

    def _observe_failures(self, services, by_service,
                          relevant: Set[str]) -> Set[str]:
        """Accumulate per-service failure observations; returns the ids
        of services currently over the poison threshold.  Observations
        for pipeline participants (``relevant``) merge with — and fold
        back into — the replicated ``PipelineStatus.failed_ids`` so
        the count survives leader failover."""
        poisoned: Set[str] = set()
        for svc in services:
            seen = self._failed_seen.setdefault(svc.id, set())
            st = svc.pipeline_status
            watermark = st.resumed_at if st is not None else 0.0
            if watermark and self._resume_seen.get(svc.id) != watermark:
                # operator resume: observations predating the stamp are
                # forgiven — drop the local ledger (the replicated one
                # was cleared in the resume transaction)
                self._resume_seen[svc.id] = watermark
                seen.clear()
            if st is not None and st.failed_ids:
                # a prior leader's (or our own committed) observations
                seen.update(st.failed_ids)
            for t in by_service.get(svc.id, []):
                if t.status.state in (TaskState.FAILED,
                                      TaskState.REJECTED) \
                        and t.status.timestamp > watermark:
                    seen.add(t.id)
            if svc.id in relevant:
                have = set(st.failed_ids) if st is not None else set()
                if seen - have:
                    self._persist_failures(svc.id, set(seen))
            if len(seen) >= POISON_FAILURES:
                poisoned.add(svc.id)
        return poisoned

    @staticmethod
    def _upstream_ready(svc: Service, tasks: List[Task]) -> bool:
        """Readiness bar for releasing a downstream stage."""
        running = sum(1 for t in tasks
                      if t.status.state == TaskState.RUNNING
                      and t.desired_state <= TaskState.RUNNING)
        mode = svc.spec.mode
        if mode == ServiceMode.REPLICATED:
            want = svc.spec.replicated.replicas \
                if svc.spec.replicated else 1
            return running >= want
        if mode == ServiceMode.REPLICATED_JOB:
            done = sum(1 for t in tasks
                       if t.status.state == TaskState.COMPLETE)
            want = svc.spec.replicated_job.total_completions \
                if svc.spec.replicated_job else 1
            return done >= want
        if mode == ServiceMode.GLOBAL_JOB:
            return any(t.status.state == TaskState.COMPLETE
                       for t in tasks)
        return running >= 1    # GLOBAL: at least one member up

    def _drive_stage(self, svc: Service, by_name, by_service,
                     poisoned: Set[str]) -> None:
        st = svc.pipeline_status or PipelineStatus()
        if st.state == "halted":
            return    # sticky: operator action restarts the pipeline

        # upstream survey: any poisoned/halted upstream cascades; all
        # ready (and none missing) releases
        halt_reason: Optional[str] = None
        all_ready = True
        for dep in svc.spec.depends_on:
            up = by_name.get(dep)
            if up is None:
                all_ready = False    # forward reference: stay gated
                continue
            up_st = up.pipeline_status
            if self._cascade_enabled and up_st is not None \
                    and up_st.state == "halted":
                halt_reason = f'upstream "{dep}" halted'
                break
            if self._cascade_enabled and up.id in poisoned:
                halt_reason = (f'upstream "{dep}" poisoned '
                               f'({POISON_FAILURES} task failures)')
                break
            if not self._upstream_ready(up, by_service.get(up.id, [])):
                all_ready = False

        if halt_reason is not None:
            self._halt(svc, halt_reason)
            return
        if st.state == "released":
            return    # sticky: upstream churn never re-gates a stage
        if all_ready:
            self._release(svc)

    # ---------------------------------------------------------------- writes

    def _persist_failures(self, sid: str, seen: Set[str]) -> None:
        """Fold newly observed distinct failed-task ids into the
        replicated row (ISSUE 16 residual: the poison threshold must
        trip across a leader crash at 2/3 observations)."""

        def cb(tx: WriteTx) -> None:
            cur = tx.get(Service, sid)
            if cur is None:
                return
            st = cur.pipeline_status
            have = set(st.failed_ids) if st is not None else set()
            merged = sorted(have | seen)
            if st is not None and merged == sorted(st.failed_ids):
                return    # raced with our own earlier commit: no-op
            cur = cur.copy()
            cur.pipeline_status = (cur.pipeline_status.copy()
                                   if cur.pipeline_status is not None
                                   else PipelineStatus())
            cur.pipeline_status.failed_ids = merged
            tx.update(cur)

        self._update(cb, "persist pipeline failure observations")

    def _release(self, svc: Service) -> None:
        sid = svc.id
        state: Dict[str, bool] = {}

        def cb(tx: WriteTx) -> None:
            cur = tx.get(Service, sid)
            if cur is None or not cur.spec.depends_on:
                return
            cur_st = cur.pipeline_status
            if cur_st is not None and cur_st.state != "waiting":
                return    # released already, or halted meanwhile
            cur = cur.copy()
            cur.pipeline_status = PipelineStatus(
                state="released", reason="", updated_at=now(),
                failed_ids=list(cur_st.failed_ids) if cur_st else [],
                resumed_at=cur_st.resumed_at if cur_st else 0.0)
            tx.update(cur)
            state["written"] = True

        self._update(cb, "release pipeline stage")
        if not state.get("written"):
            return
        self.stats["released"] += 1
        _metrics.counter(f'swarm_pipeline_released{{service="{sid}"}}')
        log.info("pipeline stage %s released", sid)

    def _halt(self, svc: Service, reason: str) -> None:
        sid = svc.id
        rollback = svc.spec.on_upstream_failure == "rollback"
        state: Dict[str, bool] = {}

        def cb(tx: WriteTx) -> None:
            cur = tx.get(Service, sid)
            if cur is None or not cur.spec.depends_on:
                return
            cur_st = cur.pipeline_status
            if cur_st is not None and cur_st.state == "halted":
                return
            cur = cur.copy()
            cur.pipeline_status = PipelineStatus(
                state="halted", reason=reason, updated_at=now(),
                failed_ids=list(cur_st.failed_ids) if cur_st else [],
                resumed_at=cur_st.resumed_at if cur_st else 0.0)
            if rollback and cur.spec.replicated is not None:
                # rollback policy: drain the stage — the orchestrator
                # shuts the running tasks down as replicas go to zero
                cur.spec.replicated.replicas = 0
            tx.update(cur)
            state["written"] = True

        self._update(cb, "halt pipeline stage")
        if not state.get("written"):
            return
        self.stats["halted"] += 1
        if rollback:
            self.stats["rollbacks"] += 1
        _metrics.counter(f'swarm_pipeline_halted{{service="{sid}"}}')
        log.warning("pipeline stage %s halted: %s%s", sid, reason,
                    " (rolled back to 0 replicas)" if rollback else "")

    def _update(self, cb, what: str) -> None:
        try:
            self.store.update(cb)
        except Exception:
            if self.threadless:
                raise   # sim: leadership loss must reach the control step
            log.exception("failed to %s", what)
