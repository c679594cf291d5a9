"""The port's copy of ``tests/test_sim.py``: deterministic simulation &
fault injection (``swarmkit_tpu_torch/sim``), every scenario run with
``device="cpu"`` (the plain versions).

Three claims are under test:

1. determinism — the same (scenario, seed) produces a byte-identical
   event trace and identical invariant verdicts on every run;
2. safety — scripted multi-fault scenarios and a randomized fuzz sweep
   surface no invariant violations on the real components;
3. sensitivity — the checkers actually fire when a genuine safety bug
   is injected (a crash that loses acked WAL records — the durability
   violation fsync exists to prevent), so a green fuzz run means
   something.
"""

import functools

from swarmkit_tpu_torch.models import TaskState
from swarmkit_tpu_torch.sim import fuzz, run_scenario
from swarmkit_tpu_torch.sim.cluster import Sim
from swarmkit_tpu_torch.sim.fuzz import failures, reproduce

fuzz = functools.partial(fuzz, device="cpu")
reproduce = functools.partial(reproduce, device="cpu")
run_scenario = functools.partial(run_scenario, device="cpu")


def test_crash_leader_mid_commit_smoke():
    """Tier-1 smoke: leader crashes with a proposal burst in flight,
    cluster re-elects, ex-leader rejoins from WAL, all invariants hold,
    and the run is reproducible."""
    r1 = run_scenario("crash-leader-mid-commit", seed=7)
    assert r1.ok, r1.violations
    assert r1.stats["raft"]["max_committed"] > 10
    assert r1.stats["raft"]["restarts"] >= 1
    # control plane made progress through the churn
    assert r1.stats["tasks"].get("RUNNING", 0) > 0
    r2 = run_scenario("crash-leader-mid-commit", seed=7)
    assert r2.trace_hash == r1.trace_hash
    assert r2.violations == r1.violations


def test_partition_churn_deterministic_and_multifault():
    """The acceptance scenario: 3 managers / 5 agents through at least
    three distinct fault classes, same seed => identical trace."""
    r1 = run_scenario("partition-churn", seed=42, keep_trace=True)
    assert r1.ok, r1.violations
    fault_kinds = set()
    for line in r1.trace:
        if " fault " in line:
            fault_kinds.add(line.split(" fault ", 1)[1].split()[0])
    # split partitions, leader stepdown, agent crash, agent partition,
    # drop bursts... well over the three required fault classes
    assert len(fault_kinds) >= 3, fault_kinds
    r2 = run_scenario("partition-churn", seed=42)
    assert r2.trace_hash == r1.trace_hash


def test_different_seeds_diverge():
    a = run_scenario("random-fuzz", seed=1)
    b = run_scenario("random-fuzz", seed=2)
    assert a.trace_hash != b.trace_hash


def test_pipelined_commit_churn_scenario():
    """Chunk-pipelined block proposals under a mid-pipeline leader
    crash: committed chunks survive, nothing commits after the
    leadership-loss instant, the remainder requeues and re-places under
    the successor, and the committed-entry ledger stays consistent —
    all checked inside the scenario (violations fail the run).  Same
    seed => identical engine trace."""
    r1 = run_scenario("pipelined-commit-churn", seed=7, keep_trace=True)
    assert r1.ok, r1.violations
    assert any(" fault crash " in line and "mid-pipeline" in line
               for line in r1.trace), "the mid-pipeline strike must fire"
    r2 = run_scenario("pipelined-commit-churn", seed=7)
    assert r2.trace_hash == r1.trace_hash
    assert r2.violations == r1.violations


def test_fuzz_50_seeds_no_violations():
    """Acceptance: >= 50 randomized fault schedules, zero invariant
    violations, and any report reproduces from its seed byte-for-byte."""
    reports = fuzz(50, start_seed=0)
    bad = failures(reports)
    assert not bad, [(r.seed, r.violations) for r in bad]
    # reproduction contract: replaying a seed gives the identical trace
    sample = reports[17]
    reproduce(sample.seed, expect_hash=sample.trace_hash)


def test_checker_detects_seeded_durability_bug():
    """Inject the bug the default fault model excludes: a member whose
    crash loses WAL records it already acked (no fsync).  The committed
    ledger checker must flag the committed-entry loss — proving a green
    fuzz run reflects checker sensitivity, not checker blindness."""
    sim = Sim(seed=5)
    with sim:
        eng = sim.engine
        eng.run_until(5.0)               # elect a leader
        lead = sim.leader()
        assert lead is not None
        others = [m for m in sim.managers if m is not lead]
        iso, keeper = others
        # 1. partition one follower away; commits now need lead+keeper
        sim.net.split([iso.id], [lead.id, keeper.id])
        eng.run_until(7.0)
        for i in range(12):
            sim.propose(f"critical-{i:02d}".encode())
        eng.run_until(12.0)
        committed_before = sim.raft_inv.max_committed()
        assert committed_before >= 12
        # 2. keeper dies losing its acked tail (the durability bug)
        keeper.crash(truncate_wal=10)
        keeper.restart()
        # 3. flip the partition: lead is cut off; iso+keeper (both
        #    missing the committed tail) form a quorum and elect
        sim.net.split([lead.id], [iso.id, keeper.id])
        eng.run_until(30.0)
        sim.net.heal_all()
        eng.run_until(40.0)
    assert any("no-committed-entry-loss" in v
               for v in sim.violations.items), (
        "checker failed to detect the injected durability violation:\n"
        + "\n".join(sim.violations.items[:5]))


def test_agent_faults_keep_fsm_invariants():
    """Agent crash/partition/failure-storm churn: the dispatcher marks
    nodes down, the scheduler reschedules, and every observed task
    transition stays monotone (VERDICT Weak #6's missing property)."""
    r = run_scenario("agent-storm", seed=11)
    assert r.ok, r.violations
    assert r.stats["expirations"] >= 1          # TTL expiry really fired
    # failure storm produced terminal tasks AND replacements came up
    assert r.stats["tasks"].get("FAILED", 0) \
        + r.stats["tasks"].get("SHUTDOWN", 0) > 0
    assert r.stats["tasks"].get("RUNNING", 0) > 0


def test_prevote_partitioned_rejoiner_does_not_depose():
    """VERDICT Missing #3 exercised end-to-end: a follower isolated for
    many election timeouts keeps pre-voting (term unchanged) instead of
    campaigning; when it rejoins, the healthy leader stays leader and
    no term bump is forced on the cluster."""
    sim = Sim(seed=9)
    with sim:
        eng = sim.engine
        eng.run_until(5.0)
        lead = sim.leader()
        assert lead is not None
        term_before = lead.core.term
        victim = next(m for m in sim.managers if m is not lead)
        sim.net.isolate(victim.id)
        # many election timeouts in isolation (tick=0.1s, timeout~1-2s)
        eng.run_until(35.0)
        assert victim.core.term == term_before, \
            "pre-vote must stop a partitioned node from bumping its term"
        sim.net.rejoin(victim.id)
        eng.run_until(45.0)
        lead_after = sim.leader()
        assert lead_after is lead, "healthy leader was deposed by rejoiner"
        assert lead.core.term == term_before
        sim.finishing = True
        sim.cp.stopped = True
        for m in sim.managers:
            m.stopped = True
    assert not sim.violations.items, sim.violations.items


def test_task_block_commits_flow_through_sim():
    """The scheduler's columnar block commits ride through the sim; the
    blocks-never-failures contract is continuously checked."""
    r = run_scenario("partition-churn", seed=3)
    assert r.ok, r.violations
    # every created task either reached a live state or was replaced
    states = r.stats["tasks"]
    assert sum(states.values()) >= 18    # 12 initial + 6 later
    assert states.get(TaskState.RUNNING.name, 0) > 0
