"""The port's copy of ``tests/test_update_chaos.py``: rolling updates
under chaos -- the real UpdateSupervisor in threadless drive mode inside
the raft-attached sim control plane, the three long-horizon scenarios, the
five invariants (each proven LIVE by a checker-sensitivity test -- an
invariant you've never seen fire is a no-op), the chaos sweeper's
coverage gate (``swarmkit_tpu_torch.scripts.chaos_sweep``), the
fuzz-pool/registry parity, and the stuck_rollout health check.  Every
scenario runs with ``device="cpu"`` (the plain versions).
"""

import functools
import json
import os
import subprocess
import sys

import pytest

from swarmkit_tpu_torch.models import types as mtypes
from swarmkit_tpu_torch.models.types import (
    UpdateFailureAction, UpdateState,
)
from swarmkit_tpu_torch.scripts import chaos_sweep
from swarmkit_tpu_torch.sim.cluster import Sim
from swarmkit_tpu_torch.sim.faults import NetConfig
from swarmkit_tpu_torch.sim.scenario import (
    FUZZ_EXCLUDED, FUZZ_POOL, LEGACY_RCP_SCENARIOS, SCENARIOS,
    UPDATE_SCENARIOS, _update_cfg, run_scenario,
)

from test_torch_dispatcher import singletons_left_as_found  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
run_scenario = functools.partial(run_scenario, device="cpu")
sweep = functools.partial(chaos_sweep.sweep, device="cpu")


# ---------------------------------------------------------------------------
# the tentpole: real rollouts inside Sim(raft_cp=True)
# ---------------------------------------------------------------------------

def test_inert_updater_is_gone():
    """The stub is deleted: the sim control plane runs the REAL
    update supervisor in threadless mode."""
    from swarmkit_tpu_torch.orchestrator.update import Supervisor
    from swarmkit_tpu_torch.sim import cluster
    assert not hasattr(cluster, "_InertUpdater")
    sim = Sim(seed=0, raft_cp=True)
    with sim:
        sim.engine.run_until(5.0)
        lead = sim.leader()
        assert lead is not None
        mc = sim.cp.active
        for orch in (mc.replicated, mc.global_):
            assert isinstance(orch.updater, Supervisor)
            assert orch.updater._start_worker is False


def test_threadless_rollout_updating_to_completed():
    """A plain spec rollout through consensus: UPDATING then COMPLETED,
    every replacement task carrying the minted spec version."""
    sim = Sim(seed=2, raft_cp=True)
    with sim:
        eng = sim.engine
        sim.start_raft_workload(interval=0.8)
        sim.cp.scale(5)
        holder = {}

        def roll():
            holder["v"] = sim.cp.rollout(
                "img:2", update=_update_cfg(UpdateFailureAction.CONTINUE))
            sim.cp.expect_update(holder["v"], (UpdateState.COMPLETED,),
                                 60.0)
        eng.at(eng.clock.start + 8.0, "rollout", roll)
        sim.run(70.0)
        sim.finish(grace=20.0)
    assert not sim.violations.items, sim.violations.items
    states = {h[3] for c in sim.cp._update_checkers() for h in c.history}
    assert int(UpdateState.UPDATING) in states
    assert int(UpdateState.COMPLETED) in states
    # converged: every live task carries the minted version
    from swarmkit_tpu_torch.models import Task
    tasks = [t for t in sim.cp.store.view(lambda tx: tx.find(Task))
             if t.desired_state <= mtypes.TaskState.RUNNING]
    assert tasks
    assert all(t.spec_version and t.spec_version.index == holder["v"]
               for t in tasks)


def test_rolling_upgrade_chaos_green_and_deterministic():
    """The headline scenario: good rollout across leader stepdown +
    partition, poisoned rollback, poisoned pause — green, the full
    update-state alphabet observed, and byte-identical on re-run."""
    r1 = run_scenario("rolling-upgrade-chaos", seed=0)
    assert r1.ok, r1.violations
    states = set(r1.stats["control"]["update_states"])
    assert {"UPDATING", "COMPLETED", "PAUSED", "ROLLBACK_STARTED",
            "ROLLBACK_COMPLETED"} <= states, states
    assert r1.stats["control"]["rollouts"] == 3
    r2 = run_scenario("rolling-upgrade-chaos", seed=0)
    assert r2.trace_hash == r1.trace_hash
    assert r2.obs_trace_sha256 == r1.obs_trace_sha256


def test_cascading_failure_rebalance_green():
    r = run_scenario("cascading-failure-rebalance", seed=0)
    assert r.ok, r.violations
    assert r.stats["control"]["attaches"] >= 2   # leader crash mid-cascade


def test_legacy_scenarios_through_raft_cp():
    """The legacy fault timelines re-driven through the real control
    plane (updater live) stay green."""
    for name in LEGACY_RCP_SCENARIOS:
        r = run_scenario(name, seed=0)
        assert r.ok, (name, r.violations)
        assert r.stats["control"]["attaches"] >= 1, name


# ---------------------------------------------------------------------------
# checker-sensitivity: every new invariant must FIRE when its
# enforcement is disabled (house rule from PR 1/5)
# ---------------------------------------------------------------------------

def _mini_rollout_sim(seed, rollout_at, cfg, poison=False, duration=70.0,
                      expect=None):
    sim = Sim(seed=seed, n_managers=3, n_agents=5,
              net_config=NetConfig(), raft_cp=True)
    with sim:
        eng = sim.engine
        sim.start_raft_workload(interval=0.8)
        sim.cp.scale(5)
        holder = {}

        def roll():
            holder["v"] = sim.cp.rollout("img:x", update=cfg,
                                         poison=poison)
            if expect is not None:
                sim.cp.expect_update(holder["v"], expect[0], expect[1])
        eng.at(eng.clock.start + rollout_at, "rollout", roll)
        sim.run(duration)
        sim.finish(grace=20.0)
    return sim, holder.get("v")


def test_sensitivity_update_convergence_within_bound():
    """An impossible convergence bound must be reported: the rollout
    cannot reach COMPLETED one virtual second after it starts."""
    sim, _v = _mini_rollout_sim(
        3, 8.0, _update_cfg(UpdateFailureAction.CONTINUE),
        expect=((UpdateState.COMPLETED,), 9.0))
    assert any("update-convergence-within-bound" in v
               for v in sim.violations.items), sim.violations.items


def test_sensitivity_no_mixed_version_after_completion(monkeypatch):
    """Disable the enforcement (hide one dirty slot from the updater so
    it completes with an old-version task still live) — the checker
    must catch the mixed versions."""
    from swarmkit_tpu_torch.orchestrator import update as upd
    orig = upd.Updater._is_slot_dirty

    def hide_slot_2(self, slot):
        if slot and slot[0].slot == 2:
            return False
        return orig(self, slot)
    monkeypatch.setattr(upd.Updater, "_is_slot_dirty", hide_slot_2)
    sim, _v = _mini_rollout_sim(
        4, 8.0, _update_cfg(UpdateFailureAction.CONTINUE))
    assert any("no-mixed-version-after-completion" in v
               for v in sim.violations.items), sim.violations.items


def test_sensitivity_rollback_restores_old_spec_everywhere(monkeypatch):
    """Disable the enforcement on the rollback path: a rollback that
    skips one already-updated slot leaves a new-version task running
    after ROLLBACK_COMPLETED — the checker must catch it."""
    from swarmkit_tpu_torch.orchestrator import update as upd
    orig = upd.Updater._is_slot_dirty
    # armed at forced-rollback time: from then on slot 1 is invisible
    # to EVERY updater (the rollback and any follow-up reconcile), so
    # its new-version task survives — a true enforcement hole, not the
    # one-reconcile race the checker's settle window legitimately
    # absorbs
    hide = {"on": False}

    def hide_slot_1(self, slot):
        if hide["on"] and slot and slot[0].slot == 1:
            return False
        return orig(self, slot)
    monkeypatch.setattr(upd.Updater, "_is_slot_dirty", hide_slot_1)

    sim = Sim(seed=5, n_managers=3, n_agents=5,
              net_config=NetConfig(), raft_cp=True)
    with sim:
        eng = sim.engine
        sim.start_raft_workload(interval=0.8)
        sim.cp.scale(5)
        cp = sim.cp
        holder = {}

        def roll():
            holder["v"] = cp.rollout(
                "img:good", update=_update_cfg(
                    UpdateFailureAction.CONTINUE, delay=0.5))
        eng.at(eng.clock.start + 8.0, "rollout", roll)

        def force_rollback():
            """Mid-rollout, do what _rollback_update does (restore the
            previous spec, mark ROLLBACK_STARTED) from the outside —
            the updater then rolls the updated slots back, minus the
            hidden one."""
            from swarmkit_tpu_torch.models import Service
            mc = cp.active
            if mc is None or mc.detached or cp.busy:
                eng.after(0.5, "force rollback retry", force_rollback)
                return
            cp.busy = True
            hide["on"] = True
            try:
                def cb(tx):
                    svc = tx.get(Service, "svc-sim")
                    if svc is None or svc.previous_spec is None:
                        return
                    svc = svc.copy()
                    svc.update_status.state = UpdateState.ROLLBACK_STARTED
                    svc.update_status.message = "forced by test"
                    svc.spec = svc.previous_spec
                    svc.spec_version = svc.previous_spec_version
                    svc.previous_spec = None
                    svc.previous_spec_version = None
                    tx.update(svc)
                mc.store.update(cb)
            except Exception:
                eng.after(0.5, "force rollback retry", force_rollback)
            finally:
                cp.busy = False
        # after the forward rollout has converged (slot 1 carries the
        # minted version), so the rollback has something to skip
        eng.at(eng.clock.start + 16.0, "force rollback", force_rollback)
        sim.run(60.0)
        sim.finish(grace=20.0)
    assert any("rollback-restores-old-spec-everywhere" in v
               for v in sim.violations.items), sim.violations.items


def test_sensitivity_pause_on_failure_threshold(monkeypatch):
    """Disable the halt (the seam built into the updater): a PAUSE that
    writes the paused status but keeps claiming slots must be caught."""
    from swarmkit_tpu_torch.orchestrator import update as upd
    monkeypatch.setattr(upd.Updater, "_pause_halts", False)
    sim, _v = _mini_rollout_sim(
        6, 8.0, _update_cfg(UpdateFailureAction.PAUSE, parallelism=1,
                            delay=0.5),
        poison=True, duration=90.0)
    assert any("pause-on-failure-threshold" in v
               for v in sim.violations.items), sim.violations.items


def test_sensitivity_placement_quality_bound():
    """Tighten the bound below the unavoidable remainder imbalance
    (8 tasks on 5 nodes): the post-convergence quality check must
    fire — proving the end-state plumbing is live, not decorative."""
    sim = Sim(seed=7, n_managers=3, n_agents=5,
              net_config=NetConfig(), raft_cp=True)
    with sim:
        sim.start_raft_workload(interval=0.8)
        sim.cp.scale(8)
        sim.cp.placement_quality_bound = 0.9
        sim.run(25.0)
        sim.finish(grace=20.0)
    assert any("placement-quality" in v
               for v in sim.violations.items), sim.violations.items


# ---------------------------------------------------------------------------
# chaos sweeper: coverage matrix + gate
# ---------------------------------------------------------------------------

def test_chaos_sweep_coverage_gate_unit():
    """The gate fails on an empty required cell and passes when every
    required cell is populated."""
    required = chaos_sweep.required_cells(("rolling-upgrade-chaos",))
    assert ("rollout-poison", "updater") in required
    assert chaos_sweep.uncovered({}, required) == sorted(required)
    full = {f: {c: 1} for f, c in required}
    assert chaos_sweep.uncovered(full, required) == []
    # classification: manager vs agent by target id, fixed components
    assert chaos_sweep.classify("crash", "m0") == "manager"
    assert chaos_sweep.classify("crash", "w3") == "agent"
    assert chaos_sweep.classify("rollout-poison", "w1") == "updater"
    assert chaos_sweep.classify("split", "") == "network"


def test_chaos_sweep_cli_single_scenario():
    """End-to-end sweeper run: JSON verdict, populated coverage matrix,
    exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "swarmkit_tpu_torch.scripts.chaos_sweep",
         "--scenario", "cascading-failure-rebalance", "--fuzz", "1",
         "--quiet", "--device", "cpu"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout)
    assert verdict["ok"] is True
    assert verdict["runs"] == 1
    assert verdict["coverage"]["uncovered"] == []
    assert verdict["coverage"]["matrix"]["agent-crash"]["agent"] > 0
    assert verdict["coverage"]["matrix"]["crash"]["manager"] > 0


def test_fuzz_pool_registry_parity():
    """Every registry scenario is either in the fuzz pool or explicitly
    excluded with a reason — fuzz coverage cannot silently lag the
    registry (the bugfix satellite's regression test)."""
    pool, excluded = set(FUZZ_POOL), set(FUZZ_EXCLUDED)
    assert pool | excluded == set(SCENARIOS), \
        set(SCENARIOS) ^ (pool | excluded)
    assert not pool & excluded
    assert all(FUZZ_EXCLUDED[n].strip() for n in excluded), \
        "every exclusion needs a reason"
    # the new suites are pooled (minus documented exclusions)
    assert set(LEGACY_RCP_SCENARIOS) <= pool
    assert set(UPDATE_SCENARIOS) - excluded <= pool
    # chaos_sweep's fuzz suite IS the pool, and the pool rotation is
    # stable position arithmetic (reproducible from the seed alone)
    assert chaos_sweep.SUITES["fuzz"] == FUZZ_POOL
    from swarmkit_tpu_torch.sim.fuzz import pool_scenario
    assert pool_scenario(0) == FUZZ_POOL[0]
    assert pool_scenario(len(FUZZ_POOL) + 1) == FUZZ_POOL[1]


# ---------------------------------------------------------------------------
# obs: stuck_rollout SLO check
# ---------------------------------------------------------------------------

def test_stuck_rollout_health_check():
    """pass with no data, pass while progressing, warn on PAUSED, fail
    when an active rollout stops progressing past its monitor window."""
    from swarmkit_tpu_torch.obs.health import HealthEvaluator
    from swarmkit_tpu_torch.utils.metrics import Registry
    reg = Registry()
    ev = HealthEvaluator(registry=reg)
    assert ev.evaluate()["stuck_rollout"] == "pass"
    svc = 'service="s1"'
    reg.gauge(f"swarm_update_state{{{svc}}}",
              float(UpdateState.UPDATING))
    reg.gauge(f"swarm_update_last_progress{{{svc}}}", mtypes.now())
    reg.gauge(f"swarm_update_monitor{{{svc}}}", 1.5)
    assert ev.evaluate()["stuck_rollout"] == "pass"
    reg.gauge(f"swarm_update_last_progress{{{svc}}}",
              mtypes.now() - 10.0)
    assert ev.evaluate()["stuck_rollout"] == "fail"
    reg.gauge(f"swarm_update_state{{{svc}}}",
              float(UpdateState.PAUSED))
    assert ev.evaluate()["stuck_rollout"] == "warn"
    reg.gauge(f"swarm_update_state{{{svc}}}",
              float(UpdateState.COMPLETED))
    assert ev.evaluate()["stuck_rollout"] == "pass"


def test_update_gauges_exported_by_scenario():
    """The rollout scenarios export the state gauge + edge timers the
    stuck_rollout check and dashboards read."""
    from swarmkit_tpu_torch.orchestrator.update import _clear_state_gauge
    from swarmkit_tpu_torch.utils.metrics import registry as reg
    run_scenario("rolling-upgrade-chaos", seed=1)
    states = reg.gauges_snapshot('swarm_update_state{')
    try:
        assert states, "swarm_update_state{service=...} never exported"
        timers = reg.timers_snapshot("swarm_update_rollout")
        assert any(t.count > 0 for t in timers.values()), \
            "no update-rollout edge timers observed"
    finally:
        # the scenario ends with svc-sim legitimately PAUSED (leg 3);
        # park the process-global gauges so later health evaluations in
        # this test process don't inherit a warn
        for name in states:
            _clear_state_gauge(
                name[len('swarm_update_state{service="'):-len('"}')])


# ---------------------------------------------------------------------------
# slow tier: the wide sweeps
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_update_chaos_wide_sweep():
    """Acceptance: >= 20 seeds of the rolling-update suite + the
    raft_cp legacy variants, all green, full coverage, and
    byte-identical reports on re-run for sampled seeds."""
    scenarios = UPDATE_SCENARIOS + LEGACY_RCP_SCENARIOS
    reports = sweep(scenarios, n_seeds=20)
    out = chaos_sweep.verdict(reports, scenarios, 20, 0)
    assert out["ok"], json.dumps(
        {"failures": out["failures"],
         "uncovered": out["coverage"]["uncovered"]}, indent=2)
    # seed-determinism: re-running a sampled (scenario, seed) pair
    # reproduces the identical report, byte for byte
    by_key = {(r.scenario, r.seed): r for r in reports}
    for name in scenarios:
        for seed in (0, 7):
            r1 = by_key[(name, seed)]
            r2 = run_scenario(name, seed, keep_trace=True)
            assert r2.trace_hash == r1.trace_hash, (name, seed)
            assert r2.obs_trace_sha256 == r1.obs_trace_sha256, \
                (name, seed)
            assert r2.violations == r1.violations, (name, seed)
