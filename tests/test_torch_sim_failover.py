"""The port's copies of the simulator cases of ``tests/test_failover.py``:
the raft-attached sim control plane and its failover scenarios (the
tier-1 sweep, determinism, the wide sweep in the slow tier, the
``failover_fuzz`` command line), the restarted member's proposer, the
two checker-sensitivity cases (fencing disabled, detach-on-depose
broken: each invariant must fire), the flight recorder's crash hook and
the restart timer re-armed across a failover.  Every scenario runs with
``device="cpu"`` (the plain versions).
"""

import functools
import json
import os
import subprocess
import sys
import threading

import pytest

from swarmkit_tpu_torch.models import (
    Annotations, Node, NodeSpec, ReplicatedService, Service, ServiceMode,
    ServiceSpec, Task, TaskSpec, TaskState, TaskStatus, Version,
)
from swarmkit_tpu_torch.models import types as mtypes
from swarmkit_tpu_torch.models.types import RestartPolicy
from swarmkit_tpu_torch.state import MemoryStore
from swarmkit_tpu_torch.state.store import StoreAction

from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    poll, singletons_left_as_found,
)


def _mk_node_action(name):
    return StoreAction("create", Node(
        id=name, spec=NodeSpec(annotations=Annotations(name=name))))


def _port_run_scenario():
    from swarmkit_tpu_torch.sim import run_scenario
    return functools.partial(run_scenario, device="cpu")


# ---------------------------------------------------------------------------
# Raft-attached sim control plane + failover scenarios
# ---------------------------------------------------------------------------

def test_failover_scenarios_fast():
    """Tier-1 sweep: every failover scenario (leader crash mid-tick and
    partition mid-pipelined-commit at store pipeline depths 1 and 2,
    plus rollout churn) across a small deterministic seed set — all
    invariants hold and every live task is re-placed on the successor."""
    run_scenario = _port_run_scenario()
    from swarmkit_tpu_torch.sim.scenario import FAILOVER_SCENARIOS
    for name in FAILOVER_SCENARIOS:
        for seed in (0, 7):
            r = run_scenario(name, seed=seed)
            assert r.ok, (name, seed, r.violations)
            ctl = r.stats["control"]
            assert ctl["attaches"] >= 2, \
                (name, seed, "failover never handed the loops over")
            assert r.stats["tasks"].get("RUNNING", 0) > 0, (name, seed)


def test_failover_scenario_deterministic():
    run_scenario = _port_run_scenario()
    r1 = run_scenario("leader-crash-mid-tick", seed=7, keep_trace=True)
    r2 = run_scenario("leader-crash-mid-tick", seed=7)
    assert r1.ok, r1.violations
    assert r1.trace_hash == r2.trace_hash
    assert any("mid-tick" in line for line in r1.trace), \
        "the mid-tick strike must fire"
    assert any("control detach" in line for line in r1.trace)
    assert any("control attach" in line for line in r1.trace)


@pytest.mark.slow
def test_failover_fuzz_wide_sweep():
    """Acceptance sweep: >= 20 seeds of leader-crash-mid-tick and
    partition-pipelined-commit at depths 1 and 2, zero violations
    (no-stale-epoch-commit and control-loops-only-on-leader hold
    everywhere)."""
    run_scenario = _port_run_scenario()
    bad = []
    for name in ("leader-crash-mid-tick", "leader-crash-mid-tick-d1",
                 "partition-pipelined-commit",
                 "partition-pipelined-commit-d1"):
        for seed in range(20):
            r = run_scenario(name, seed=seed)
            if not r.ok:
                bad.append((name, seed, r.violations[:3]))
    assert not bad, bad


def test_failover_fuzz_cli():
    """``python -m swarmkit_tpu_torch.scripts.failover_fuzz``: exit 0 on a
    clean deterministic run, machine-readable JSON verdict on stdout."""
    proc = subprocess.run(
        [sys.executable, "-m", "swarmkit_tpu_torch.scripts.failover_fuzz",
         "--fuzz", "1", "--scenario", "failover-churn-rollout", "--quiet",
         "--device", "cpu"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout)
    assert verdict["ok"] is True
    assert verdict["runs"] == 1


def test_restarted_member_store_keeps_proposer():
    """A crashed member rebuilds its replicated store from the WAL on
    restart; the rebuilt store must keep its member-bound proposer — a
    proposer-less rebuild would let a re-elected ex-leader commit
    locally with no consensus and no fencing."""
    from swarmkit_tpu_torch.sim.cluster import Sim
    sim = Sim(seed=3, raft_cp=True)
    with sim:
        eng = sim.engine
        sim.cp.create_tasks(4)
        sim.run(8.0)
        lead = sim.cp.active.member
        lead.crash()
        sim.run(eng.clock.elapsed() + 3.0)
        lead.restart()
        assert lead.store._proposer is sim.cp.proposers[lead.id]
        sim.run(eng.clock.elapsed() + 5.0)
        sim.cp.stopped = True
        sim.finishing = True
        for m in sim.managers:
            m.stopped = True
    assert not sim.violations.items, sim.violations.items


def test_stale_epoch_commit_checker_fires():
    """Checker sensitivity: with fencing force-disabled, a commit
    callback delivered under a fenced epoch RUNS — and the
    no-stale-epoch-commit invariant must flag it."""
    from swarmkit_tpu_torch.sim.cluster import Sim
    sim = Sim(seed=9, raft_cp=True)
    with sim:
        eng = sim.engine
        sim.cp.create_tasks(4)
        sim.run(8.0)
        mc = sim.cp.active
        assert mc is not None, "control plane never attached"
        member = mc.member
        proposer = sim.cp.proposers[member.id]
        proposer.enforce_fencing = False
        ran = []
        proposer.propose_async([_mk_node_action("wx")],
                               commit_cb=lambda: ran.append(1))
        # fence lands AFTER the entry entered the log, BEFORE commit
        # delivery — exactly the race fencing exists to close
        member.core.fence_epoch()
        sim.run(eng.clock.elapsed() + 3.0)
        sim.cp.stopped = True
        sim.finishing = True
        for m in sim.managers:
            m.stopped = True
    assert ran == [1], "with fencing disabled the stale commit must run"
    assert any("no-stale-epoch-commit" in v
               for v in sim.violations.items), sim.violations.items


def test_control_loops_only_on_leader_checker_fires():
    """Checker sensitivity: break the detach-on-deposal handler and
    force a stepdown — the control-loops-only-on-leader invariant must
    catch the deposed member still holding live loops."""
    from swarmkit_tpu_torch.sim.cluster import Sim
    sim = Sim(seed=9, raft_cp=True)
    with sim:
        eng = sim.engine
        sim.cp.create_tasks(4)
        sim.run(8.0)
        assert sim.cp.active is not None
        sim.cp.detach_on_depose = False     # the injected bug
        sim.stepdown_leader()
        sim.run(eng.clock.elapsed() + 3.0)
        sim.cp.stopped = True
        sim.finishing = True
        for m in sim.managers:
            m.stopped = True
    assert any("control-loops-only-on-leader" in v
               for v in sim.violations.items), sim.violations.items


# ---------------------------------------------------------------------------
# Flight-recorder crash hook
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_hook_dumps_postmortem(tmp_path, monkeypatch, caplog):
    import logging
    import sys as _sys
    import swarmkit_tpu_torch.obs.flightrec  # noqa: F401 — module, not the singleton
    fr = _sys.modules["swarmkit_tpu_torch.obs.flightrec"]
    monkeypatch.setenv("SWARM_FLIGHTREC_DIR", str(tmp_path))
    saved = fr.flightrec.save_state()
    fr.flightrec.reset()
    fr.flightrec.enabled = True
    fr.install_crash_hook()
    try:
        with caplog.at_level(logging.ERROR, logger="flightrec"):
            t = threading.Thread(
                target=lambda: (_ for _ in ()).throw(
                    RuntimeError("injected control-loop crash")),
                name="scheduler", daemon=True)
            t.start()
            t.join(timeout=10)
        dumps = list(tmp_path.glob("flightrec_crash_scheduler_*.json"))
        assert len(dumps) == 1, "exactly one post-mortem per crash"
        doc = json.loads(dumps[0].read_text())
        notes = [n[1] for n in doc["notes"]]
        assert any("injected control-loop crash" in n for n in notes)
        # path + sha are logged so the operator can find the evidence
        msg = "\n".join(r.getMessage() for r in caplog.records)
        assert str(dumps[0]) in msg and "sha256" in msg
    finally:
        fr.uninstall_crash_hook()
        fr.flightrec.enabled = False
        fr.flightrec.restore_state(saved)
    # hook chain restored
    assert threading.excepthook is not fr._crash_excepthook


# ---------------------------------------------------------------------------
# Restart supervisor: delayed-restart timers across leader failover
# ---------------------------------------------------------------------------

def _mk_restart_service(delay):
    return Service(
        id="svc-r",
        spec=ServiceSpec(
            annotations=Annotations(name="svc-r"),
            mode=ServiceMode.REPLICATED,
            replicated=ReplicatedService(replicas=1),
            task=TaskSpec(restart=RestartPolicy(delay=delay))),
        spec_version=Version(index=1))


def test_restart_timer_rearms_on_new_leader_after_failover():
    """A delayed restart armed by the old leader survives failover: the
    new leader's taskinit pass re-arms it from the replicated store —
    exactly one replacement, started exactly once (no lost and no
    duplicated restarts across the handoff)."""
    from swarmkit_tpu_torch.orchestrator import (
        ReplicatedOrchestrator, RestartSupervisor, taskinit,
    )
    store = MemoryStore()
    service = _mk_restart_service(delay=0.4)
    failed = Task(
        id="t-old", service_id=service.id, slot=1,
        desired_state=TaskState.RUNNING,
        spec=service.spec.task, spec_version=Version(index=1),
        status=TaskStatus(state=TaskState.FAILED,
                          timestamp=mtypes.now(), message="boom"))
    store.update(lambda tx: (tx.create(service), tx.create(failed)))

    # ---- old leader arms the delayed restart...
    sup_a = RestartSupervisor(store, start_worker=False)

    def cb(tx):
        t = tx.get(Task, "t-old")
        sup_a.restart(tx, None, service, t)
    store.update(cb)
    tasks = store.view(lambda tx: tx.find(Task))
    repl = [t for t in tasks if t.id != "t-old"]
    assert len(repl) == 1
    assert repl[0].desired_state == TaskState.READY, \
        "replacement must be delayed (READY), not started yet"

    # ---- ...and is deposed before the delay elapses
    sup_a.stop()
    after_stop = store.view(lambda tx: tx.get(Task, repl[0].id))
    assert after_stop.desired_state == TaskState.READY, \
        "a deposed leader must not fire the start on its way out"

    # ---- the new leader cold-starts from the replicated store
    sup_b = RestartSupervisor(store, start_worker=False)
    orch = ReplicatedOrchestrator(store, restarts=sup_b)
    taskinit.check_tasks(store, store.view(), orch, sup_b)
    # timer re-armed, not lost — and not fired early either
    cur = store.view(lambda tx: tx.get(Task, repl[0].id))
    if cur.desired_state == TaskState.READY:
        assert repl[0].id in sup_b._delays

    def started():
        sup_b.drive()
        t = store.view(lambda tx: tx.get(Task, repl[0].id))
        return t if t.desired_state == TaskState.RUNNING else None
    poll(started, timeout=10, msg="re-armed delayed restart never fired")

    # no duplicated restarts: a second taskinit pass (e.g. yet another
    # failover) must not mint a second replacement or re-delay the task
    sup_c = RestartSupervisor(store, start_worker=False)
    orch_c = ReplicatedOrchestrator(store, restarts=sup_c)
    taskinit.check_tasks(store, store.view(), orch_c, sup_c)
    tasks = store.view(lambda tx: tx.find(Task))
    assert len([t for t in tasks if t.id != "t-old"]) == 1
    assert store.view(lambda tx: tx.get(
        Task, repl[0].id)).desired_state == TaskState.RUNNING
    sup_b.stop()
    sup_c.stop()

