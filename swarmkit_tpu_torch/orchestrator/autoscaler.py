"""Horizontal autoscaler: the load-reactive control loop (ISSUE 12).

One ``AutoscaleSupervisor`` per manager scales every replicated service
carrying an ``AutoscaleConfig`` (models/specs.py) from observed load —
per-service utilization through the **sampler seam**, or the
pending->assigned p99 from the obs lifecycle timers.  The loop is the
established threadless-drivable FSM shape (orchestrator/update.py,
restart.py): production wraps one thread (``start_worker=True``); the
deterministic simulator constructs ``start_worker=False`` and pumps
``drive()`` from the leader's control step under virtual time.

Stability machinery, in decision order per service:

* **flap breaker** — a policy that reversed direction
  ``flap_reversals`` times inside the flap window freezes itself for a
  window (no writes) and raises the ``autoscale_flapping`` health warn;
  chaos-induced metric noise can never oscillate replicas.
* **hysteresis** — a deadband of ±``hysteresis`` around the target;
  utilization inside it produces no decision at all.
* **rate limit** — at most one step per ``stabilization_window``, per
  service.
* **bounds** — the step is clamped into [min, max] replicas
  (``_enforce_bounds`` is the checker-sensitivity seam: with it off,
  the sim's ``autoscale-within-bounds-and-rate`` invariant must fire).

Every decision writes the service spec through ``store.update`` — the
proposal is pinned to the leadership epoch read at commit start, so a
deposed leader's scale writes are fenced — and the SAME transaction
stamps ``Service.autoscale_status`` (objects.py): the successor's
supervisor resumes the window/direction/freeze state from the
replicated row, which is what lets an in-flight scale-up survive
failover without violating the rate invariant.

All deadlines read ``models.types.now()``.  Gauges:
``swarm_autoscale_replicas{service=}``,
``swarm_autoscale_flapping{service=}``,
``swarm_autoscale_out_of_bounds{service=}``; decisions count on
``swarm_autoscale_decisions{direction=,service=}``.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Dict, Optional

from ..models.objects import AutoscaleStatus, Service
from ..models.specs import ServiceMode
from ..models.types import now
from ..state.store import MemoryStore, WriteTx
from ..utils.metrics import registry as _metrics

log = logging.getLogger("autoscaler")

#: flap window = this many stabilization windows: reversals older than
#: it age out; a freeze lasts one flap window
FLAP_WINDOW_FACTOR = 4.0


def registry_sampler(registry=None) -> Callable[[str], Optional[dict]]:
    """Production sampler: per-service load from the
    ``swarm_service_load{service=}`` gauge (exported by whatever
    measures demand — an ingress proxy, a queue depth exporter) and the
    pending->assigned p99 from the obs lifecycle timers — the SERVICE'S
    OWN ``swarm_task_lifecycle_service{service=}`` timer when it has
    samples (a quiet service must not scale on a noisy neighbor's
    latency), the cluster-wide edge timer as the fallback for services
    past the bounded per-service cardinality cap.  The sim replaces
    this wholesale with a deterministic scenario-driven sampler — that
    indirection is the whole point of the seam."""
    from ..obs.lifecycle import service_edge_timer_name
    reg = registry if registry is not None else _metrics

    def sample(service_id: str) -> Optional[dict]:
        out = {}
        load = reg.get_gauge(
            f'swarm_service_load{{service="{service_id}"}}')
        if load is not None:
            out["load"] = load
        t = reg.get_timer(service_edge_timer_name(service_id))
        if t is None or not t.count:
            t = reg.get_timer(
                'swarm_task_lifecycle{from="pending",to="assigned"}')
        if t is not None and t.count:
            out["p99"] = t.quantiles()[0.99]
        return out or None

    return sample


class Supervisor:
    """One decision pass per ``drive()`` over every autoscaled service."""

    #: checker-sensitivity seam (tests/test_autoscale.py): False skips
    #: BOTH the [min, max] clamp and the stabilization-window rate
    #: limit — the sim's ``autoscale-within-bounds-and-rate`` invariant
    #: must then catch the runaway policy.
    _enforce_bounds = True
    #: checker-sensitivity seam: False ignores scale-down decisions —
    #: load removal then never converges replicas back to min and the
    #: ``autoscale-converges`` expectation must fire.
    _scale_down_enabled = True

    def __init__(self, store: MemoryStore,
                 sampler: Optional[Callable[[str], Optional[dict]]] = None,
                 start_worker: bool = True, interval: float = 2.0):
        self.store = store
        self.sampler = sampler if sampler is not None \
            else registry_sampler()
        self.interval = interval
        self.threadless = not start_worker
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"decisions": 0, "frozen_skips": 0,
                      "rate_limited": 0}

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
                    log.exception("autoscale pass failed")

        self._thread = threading.Thread(target=loop, name="autoscaler",
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
        control step handles the deposal, exactly like the update and
        restart supervisors."""
        services = self.store.view(lambda tx: tx.find(Service))
        for svc in sorted(services, key=lambda s: s.id):
            cfg = svc.spec.autoscale
            if cfg is None or svc.spec.mode != ServiceMode.REPLICATED \
                    or svc.spec.replicated is None:
                continue
            try:
                self._drive_service(svc, cfg)
            except Exception:
                if self.threadless:
                    raise
                log.exception("autoscale decision for %s failed", svc.id)

    def _drive_service(self, svc: Service, cfg) -> None:
        sid = svc.id
        cur = svc.spec.replicated.replicas
        ts = now()
        st = svc.autoscale_status or AutoscaleStatus()
        _metrics.gauge(f'swarm_autoscale_replicas{{service="{sid}"}}',
                       float(cur))
        oob = not (cfg.min_replicas <= cur <= cfg.max_replicas)
        _metrics.gauge(
            f'swarm_autoscale_out_of_bounds{{service="{sid}"}}',
            1.0 if oob else 0.0)

        window = max(cfg.stabilization_window, 0.0)
        flap_window = window * FLAP_WINDOW_FACTOR
        frozen = ts < st.frozen_until
        _metrics.gauge(f'swarm_autoscale_flapping{{service="{sid}"}}',
                       1.0 if frozen else 0.0)
        if frozen:
            # flap breaker engaged: policy writes suspended for a flap
            # window (the health plane warns meanwhile)
            self.stats["frozen_skips"] += 1
            return

        want, direction = self._desired(sid, cfg, cur)
        if direction == 0:
            return
        if direction < 0 and not self._scale_down_enabled:
            return   # sensitivity seam: converge enforcement off
        if self._enforce_bounds:
            want = max(cfg.min_replicas,
                       min(cfg.max_replicas, want))
            if want == cur:
                return
            # rate limit: one step per stabilization window, judged
            # against the REPLICATED stamp so it holds across failover
            if st.last_decision_at and ts - st.last_decision_at < window:
                self.stats["rate_limited"] += 1
                return
        elif want == cur:
            return

        # flap detection BEFORE the write: a direction reversal joins
        # the window; too many reversals freeze the policy instead of
        # committing yet another oscillation
        reversals = [r for r in st.reversal_stamps
                     if flap_window <= 0 or ts - r < flap_window]
        if st.last_direction and direction != st.last_direction:
            reversals.append(ts)
            if cfg.flap_reversals > 0 \
                    and len(reversals) >= cfg.flap_reversals:
                self._freeze(sid, st, reversals, ts,
                             flap_window if flap_window > 0
                             else window)
                return

        self._commit(svc, cfg, want, direction, reversals, ts)

    # ---------------------------------------------------------------- policy

    def _desired(self, sid: str, cfg, cur: int):
        """(want, direction) from the sampled signal; direction 0 =
        inside the hysteresis deadband or no sample."""
        sample = self.sampler(sid)
        if not sample:
            return cur, 0
        signal = target = None
        if cfg.target_utilization > 0 and sample.get("load") is not None:
            signal = sample["load"] / max(cur, 1)
            target = cfg.target_utilization
        elif cfg.target_p99 > 0 and sample.get("p99") is not None:
            signal = sample["p99"]
            target = cfg.target_p99
        if signal is None:
            return cur, 0
        if signal > target * (1.0 + cfg.hysteresis):
            if cfg.target_utilization > 0:
                # jump toward the load-proportional size, bounded by the
                # step: big bursts converge in few windows, small ones
                # take one step
                ideal = math.ceil(sample["load"] / target)
                want = min(cur + max(cfg.scale_up_step, 1),
                           max(ideal, cur + 1))
            else:
                want = cur + max(cfg.scale_up_step, 1)
            return want, 1
        if signal < target * (1.0 - cfg.hysteresis):
            return cur - max(cfg.scale_down_step, 1), -1
        return cur, 0

    # ---------------------------------------------------------------- writes

    def _freeze(self, sid: str, st: AutoscaleStatus, reversals,
                ts: float, hold: float) -> None:
        """Engage the flap breaker: one status-only write (no replica
        change) so the freeze itself rides the replicated row and
        survives failover."""
        until = ts + max(hold, 1.0)

        def cb(tx: WriteTx) -> None:
            cur = tx.get(Service, sid)
            if cur is None or cur.spec.autoscale is None:
                return
            cur = cur.copy()
            status = cur.autoscale_status or AutoscaleStatus()
            status = status.copy()
            status.reversal_stamps = list(reversals)
            status.frozen_until = until
            cur.autoscale_status = status
            tx.update(cur)

        self._update(cb, "freeze flapping policy")
        _metrics.counter(f'swarm_autoscale_flaps{{service="{sid}"}}')
        _metrics.gauge(f'swarm_autoscale_flapping{{service="{sid}"}}',
                       1.0)
        log.warning("autoscale policy for %s frozen until %.1f "
                    "(%d direction reversals)", sid, until,
                    len(reversals))

    def _commit(self, svc: Service, cfg, want: int, direction: int,
                reversals, ts: float) -> None:
        sid = svc.id
        state: Dict[str, bool] = {}

        def cb(tx: WriteTx) -> None:
            cur = tx.get(Service, sid)
            if cur is None or cur.spec.autoscale is None \
                    or cur.spec.replicated is None:
                return
            if cur.spec.replicated.replicas != \
                    svc.spec.replicated.replicas:
                return   # a concurrent writer moved it; re-decide later
            cur = cur.copy()
            cur.spec.replicated.replicas = want
            status = (cur.autoscale_status or AutoscaleStatus()).copy()
            status.last_decision_at = ts
            status.last_direction = direction
            status.reversal_stamps = list(reversals)
            cur.autoscale_status = status
            tx.update(cur)
            state["written"] = True

        self._update(cb, "scale service")
        if not state.get("written"):
            return
        self.stats["decisions"] += 1
        label = "up" if direction > 0 else "down"
        _metrics.counter(
            f'swarm_autoscale_decisions{{direction="{label}",'
            f'service="{sid}"}}')
        _metrics.gauge(f'swarm_autoscale_replicas{{service="{sid}"}}',
                       float(want))
        log.info("autoscaled %s: %d -> %d (%s)", sid,
                 svc.spec.replicated.replicas, want, label)

    def _update(self, cb, what: str) -> None:
        try:
            self.store.update(cb)
        except Exception:
            if self.threadless:
                raise   # sim: leadership loss must reach the control step
            log.exception("failed to %s", what)
