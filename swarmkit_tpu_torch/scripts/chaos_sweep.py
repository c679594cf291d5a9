#!/usr/bin/env python
"""General chaos sweeper: seed-sweep any scenario subset under the
raft-attached control plane and report fault-type x component coverage.

    python -m swarmkit_tpu_torch.scripts.chaos_sweep  # default suites
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --fast  # CI subset
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --fuzz 20  # seeds/scenario
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --suite update
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --scenario long-soak --fuzz 3
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --suite gang --device cpu
    python -m swarmkit_tpu_torch.scripts.chaos_sweep --list

Generalizes scripts/failover_fuzz.py (which remains as a thin wrapper):
every (scenario, seed) runs the full control plane — scheduler,
dispatcher, allocator, restart supervisor, replicated + global
orchestrators, and (new in ISSUE 8) the REAL rolling-update supervisor
in threadless drive mode — through its fault timeline under every
invariant checker.

The sweep's verdict is twofold:

* **safety/quality** — every run must hold every invariant (task FSM,
  ledger, fencing, update convergence, version purity, placement
  quality).  Failures print the violations, the exact replay command,
  and the flight-recorder post-mortem path + sha the runner dumped.
* **coverage** — the engine trace records every injected fault
  (``fault <type> <target>`` / ``net drop`` lines).  The sweep
  aggregates them into a fault-type x component matrix and fails when
  any cell REQUIRED for the swept scenario set stayed at zero: a chaos
  suite that silently stopped injecting a fault class is itself a bug.

Exit status is 0 only when every run held every invariant AND no
required coverage cell is empty.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, Iterable, List, Set, Tuple

from ..sim.scenario import (
    FAILOVER_SCENARIOS, FUZZ_POOL, GANG_SCENARIOS, LEGACY_RCP_SCENARIOS,
    OVERLOAD_SCENARIOS, PREEMPT_SCENARIOS, QOS_SCENARIOS, READ_SCENARIOS,
    SCENARIOS, STREAMING_SCENARIOS, UPDATE_SCENARIOS, run_scenario,
)

#: named scenario subsets.  "default" is what CI's slow sweep runs; the
#: "fuzz" suite is the same seed-rotating pool `python -m swarmkit_tpu_torch.sim
#: --fuzz` draws from (minus the exclusions documented in scenario.py).
SUITES: Dict[str, tuple] = {
    "failover": FAILOVER_SCENARIOS,
    "update": UPDATE_SCENARIOS,
    "preempt": PREEMPT_SCENARIOS,
    "qos": QOS_SCENARIOS,
    "read": READ_SCENARIOS,
    "streaming": STREAMING_SCENARIOS,
    "gang": GANG_SCENARIOS,
    "overload": OVERLOAD_SCENARIOS,
    "legacy-rcp": LEGACY_RCP_SCENARIOS,
    "default": FAILOVER_SCENARIOS + UPDATE_SCENARIOS
    + PREEMPT_SCENARIOS + QOS_SCENARIOS + READ_SCENARIOS
    + STREAMING_SCENARIOS + GANG_SCENARIOS + OVERLOAD_SCENARIOS
    + LEGACY_RCP_SCENARIOS,
    "fuzz": FUZZ_POOL,
}

# ------------------------------------------------------------- coverage

#: trace grammar: "<ts> fault <type> <target...>" and
#: "<ts> net drop <src>-><dst> <msgtype>"
_FAULT_RE = re.compile(r"^\d+\.\d+ fault ([a-z-]+)(?: (\S+))?")
_DROP_RE = re.compile(r"^\d+\.\d+ net drop ")

#: fault types that always hit one component regardless of target
_FIXED_COMPONENT = {
    "agent-crash": "agent", "agent-restart": "agent",
    "agent-partition": "agent", "task-failure-storm": "agent",
    "rollout-poison": "updater",
    "preempt-burst": "scheduler",
    "autoscale-burst": "scheduler", "quota-clamp": "scheduler",
    "gang-deadlock": "scheduler",
    "pipeline-stage": "orchestrator", "stage-poison": "agent",
    "stale-read-probe": "read-plane", "read-storm": "read-plane",
    # columnar commit plane: logged once per raft-attached run when a
    # binary block entry rides consensus with the native decode active
    "native-commit-plane": "store",
    # streaming scheduler: logged when a leader handoff ACTUALLY
    # rebuilt the resident device-input state (epoch resync observed)
    "streaming-resync": "scheduler",
    # overload plane: logged the first time the dispatcher ACTUALLY
    # shed an admission / the first time the heartbeat period ACTUALLY
    # stretched — an empty cell means the backpressure plane went dead
    "overload-shed": "dispatcher",
    "heartbeat-stretch": "agent",
    "fan-out-burst": "dispatcher",
    "cut": "network", "heal": "network", "split": "network",
    "heal-all": "network", "drop": "network", "drop-burst": "network",
    "clock-skew": "clock",
}


def classify(ftype: str, target: str) -> str:
    """Component a fault perturbs: manager (raft/control plane), agent,
    network, updater (rollout workload), scheduler (priority/preemption
    pressure), or clock."""
    fixed = _FIXED_COMPONENT.get(ftype)
    if fixed is not None:
        return fixed
    # crash / restart / stepdown / isolate / rejoin / partition:
    # manager vs agent by target id convention (m* managers, w* workers)
    if target.startswith("w"):
        return "agent"
    return "manager"


#: coverage cells each scenario is REQUIRED to exercise, judged against
#: the sweep-wide aggregate (a probabilistic fault like a drop burst
#: need not land in every seed, but must land somewhere in the sweep).
#: Keep in sync with the fault timelines in sim/scenario.py — the gate
#: exists so a scenario edit cannot silently drop a fault class.
REQUIRED_CELLS: Dict[str, Set[Tuple[str, str]]] = {
    "rolling-upgrade-chaos": {
        ("stepdown", "manager"), ("isolate", "manager"),
        ("rejoin", "manager"), ("agent-crash", "agent"),
        ("agent-restart", "agent"), ("agent-partition", "agent"),
        ("rollout-poison", "updater"), ("drop", "network")},
    "cascading-failure-rebalance": {
        ("agent-crash", "agent"), ("agent-restart", "agent"),
        ("crash", "manager"), ("restart", "manager")},
    "long-soak": {
        ("agent-crash", "agent"), ("agent-restart", "agent"),
        ("crash", "manager"), ("restart", "manager"),
        ("split", "network"), ("heal-all", "network"),
        ("stepdown", "manager"), ("rollout-poison", "updater"),
        ("drop", "network")},
    "partition-churn-rcp": {
        ("split", "network"), ("heal-all", "network"),
        ("drop-burst", "network"), ("drop", "network")},
    "crash-restart-churn-rcp": {
        ("crash", "manager"), ("restart", "manager"),
        ("agent-crash", "agent"), ("agent-restart", "agent")},
    "agent-storm-rcp": {
        ("task-failure-storm", "agent"), ("agent-crash", "agent")},
    "leader-crash-mid-tick": {
        ("crash", "manager"), ("restart", "manager"),
        ("agent-crash", "agent"), ("agent-restart", "agent")},
    "leader-crash-mid-tick-d1": {
        ("crash", "manager"), ("restart", "manager")},
    "partition-pipelined-commit": {
        ("partition", "manager"), ("isolate", "manager"),
        ("rejoin", "manager")},
    "partition-pipelined-commit-d1": {
        ("partition", "manager"), ("isolate", "manager"),
        ("rejoin", "manager")},
    "failover-churn-rollout": {
        ("crash", "manager"), ("restart", "manager"),
        ("stepdown", "manager"), ("task-failure-storm", "agent"),
        ("agent-crash", "agent"), ("agent-restart", "agent")},
    "preemption-storm": {
        ("preempt-burst", "scheduler"), ("agent-crash", "agent"),
        ("agent-restart", "agent"), ("stepdown", "manager"),
        ("drop", "network"),
        # the raft-attached scheduler's block commits must ride the
        # NATIVE columnar commit plane (ISSUE 13) — an empty cell means
        # it silently fell back to the Python oracle sweep-wide
        ("native-commit-plane", "store")},
    # fused-vs-per-service differential under churn, now also the
    # columnar-commit-plane coverage anchor for the fuzz suite
    "fused-differential-churn": {
        ("native-commit-plane", "store")},
    # streaming scheduler twin-store differential: the stepdown must
    # happen AND the successor reign's refresh must actually resync
    # resident state — an empty cell means the handoff path rotted
    "steady-state-churn": {
        ("stepdown", "manager"),
        ("streaming-resync", "scheduler")},
    # autoscaler + tenant QoS: the burst is injected, but the
    # quota-clamp cell is logged only when the scheduler ACTUALLY
    # clamped — a suite edit that stops clamping empties the cell
    "tenant-storm": {
        ("autoscale-burst", "scheduler"), ("quota-clamp", "scheduler"),
        ("crash", "manager"), ("restart", "manager"),
        ("agent-crash", "agent"), ("agent-restart", "agent"),
        ("drop", "network")},
    # follower-served read plane: partition × read-plane (the stranded
    # ex-leader must be PROBED, not just partitioned) and clock × lease
    # (a skew fault must run while lease reads are in play)
    "follower-read-failover": {
        ("crash", "manager"), ("restart", "manager"),
        ("isolate", "manager"), ("rejoin", "manager"),
        ("stale-read-probe", "read-plane"), ("clock-skew", "clock"),
        ("agent-crash", "agent"), ("agent-restart", "agent")},
    "read-storm-degraded": {
        ("read-storm", "read-plane"), ("stepdown", "manager"),
        ("crash", "manager"), ("restart", "manager"),
        ("drop", "network")},
    # gang scheduling: two half-placeable gangs must actually contend
    # (the injection cell), under agent churn and a stepdown
    "gang-deadlock": {
        ("gang-deadlock", "scheduler"), ("agent-crash", "agent"),
        ("agent-restart", "agent"), ("stepdown", "manager"),
        ("drop", "network")},
    # pipeline workflows: the poisoned mid stage must be injected AND
    # at least one of its tasks must actually die on startup
    "pipeline-chaos": {
        ("pipeline-stage", "orchestrator"),
        ("stage-poison", "agent"),
        ("crash", "manager"), ("restart", "manager"),
        ("stepdown", "manager"), ("drop", "network")},
    # million-swarm overload harness: the dispatcher must ACTUALLY shed
    # (not just be configured to) and the heartbeat period must ACTUALLY
    # stretch under the session load — empty cells mean the fan-out no
    # longer saturates the admission plane and the scenario is testing
    # nothing
    "million-swarm": {
        ("overload-shed", "dispatcher"),
        ("heartbeat-stretch", "agent"),
        ("fan-out-burst", "dispatcher"),
        ("crash", "manager"), ("restart", "manager"),
        ("agent-crash", "agent"), ("agent-restart", "agent"),
        ("drop", "network")},
}


def coverage_matrix(traces: Iterable[List[str]]) -> Dict[str, Dict[str, int]]:
    """Aggregate fault-type x component counts over engine traces."""
    matrix: Dict[str, Dict[str, int]] = {}
    for trace in traces:
        for line in trace:
            m = _FAULT_RE.match(line)
            if m:
                ftype, target = m.group(1), m.group(2) or ""
            elif _DROP_RE.match(line):
                ftype, target = "drop", ""
            else:
                continue
            comp = classify(ftype, target)
            row = matrix.setdefault(ftype, {})
            row[comp] = row.get(comp, 0) + 1
    return {f: dict(sorted(row.items()))
            for f, row in sorted(matrix.items())}


def required_cells(scenarios: Iterable[str]) -> Set[Tuple[str, str]]:
    cells: Set[Tuple[str, str]] = set()
    for name in scenarios:
        cells |= REQUIRED_CELLS.get(name, set())
    return cells


def uncovered(matrix: Dict[str, Dict[str, int]],
              required: Set[Tuple[str, str]]) -> List[Tuple[str, str]]:
    return sorted((f, c) for f, c in required
                  if not matrix.get(f, {}).get(c))


# ---------------------------------------------------------------- sweep

def sweep(scenarios, n_seeds: int, start_seed: int = 0,
          progress=None, keep_trace: bool = True, device=None) -> list:
    """Run every (scenario, seed) pair; returns all SimReports (shared
    with scripts/failover_fuzz.py).  ``keep_trace`` retains each run's
    engine trace on the report — required for the coverage matrix, but
    a caller that never reads traces (failover_fuzz) passes False so a
    wide sweep does not hold every run's full log in memory.  ``device``
    goes to every run (None -> the card)."""
    reports = []
    for name in scenarios:
        for seed in range(start_seed, start_seed + n_seeds):
            r = run_scenario(name, seed, keep_trace=keep_trace,
                             device=device)
            reports.append(r)
            if progress is not None:
                progress(r)
    return reports


def verdict(reports, scenarios, n_seeds: int, start_seed: int,
            check_coverage: bool = True) -> dict:
    bad = [r for r in reports if not r.ok]
    matrix = coverage_matrix(r.trace for r in reports)
    required = required_cells(scenarios) if check_coverage else set()
    missing = uncovered(matrix, required)
    return {
        "scenarios": list(scenarios),
        "seeds_per_scenario": n_seeds,
        "start_seed": start_seed,
        "runs": len(reports),
        "coverage": {
            "matrix": matrix,
            "required": sorted(list(c) for c in required),
            "uncovered": [list(c) for c in missing],
        },
        "failures": [
            {"scenario": r.scenario, "seed": r.seed,
             "violations": r.violations,
             "flightrec": r.flightrec_path,
             "flightrec_sha256": r.flightrec_sha256,
             "reproduce": f"python -m swarmkit_tpu_torch.sim --seed {r.seed} "
                          f"--scenario {r.scenario}"}
            for r in bad],
        "ok": not bad and not missing,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.scripts.chaos_sweep")
    p.add_argument("--fuzz", type=int, metavar="N", default=5,
                   help="seeds per scenario (default 5)")
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--suite", choices=sorted(SUITES), default=None,
                   help="named scenario subset (default: 'default' = "
                        "failover + update + legacy-rcp)")
    p.add_argument("--scenario", action="append", default=None,
                   choices=sorted(SCENARIOS),
                   help="sweep exactly these scenarios (repeatable; "
                        "overrides --suite)")
    p.add_argument("--fast", action="store_true",
                   help="CI subset: 3 seeds x rolling-upgrade-chaos + "
                        "preemption-storm + follower-read-failover, "
                        "plus 1 tenant-storm, 1 steady-state-churn, "
                        "1 gang-deadlock, 1 pipeline-chaos and "
                        "1 million-swarm seed "
                        "(overrides --fuzz/--suite/--scenario)")
    p.add_argument("--no-coverage-gate", action="store_true",
                   help="report the coverage matrix but never fail on "
                        "an empty cell (for ad-hoc subsets)")
    p.add_argument("--list", action="store_true",
                   help="list suites + scenarios and exit")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-run progress lines")
    p.add_argument("--device", default=None,
                   help="where the scenarios' planners run: the card "
                        "(default) or 'cpu' for the plain versions")
    args = p.parse_args(argv)

    if args.list:
        for suite in sorted(SUITES):
            print(f"[{suite}]")
            for name in SUITES[suite]:
                doc = (SCENARIOS[name].__doc__ or "").strip()
                print(f"  {name:34s} {doc.split(chr(10))[0]}")
        return 0

    extra_runs: tuple = ()    # (scenario, n_seeds) beyond the main sweep
    if args.fast:
        scenarios: tuple = ("rolling-upgrade-chaos", "preemption-storm",
                            "follower-read-failover")
        n_seeds = 3
        extra_runs = (("tenant-storm", 1), ("steady-state-churn", 1),
                      ("gang-deadlock", 1), ("pipeline-chaos", 1),
                      ("million-swarm", 1))
    else:
        if args.scenario:
            scenarios = tuple(args.scenario)
        else:
            scenarios = SUITES[args.suite or "default"]
        n_seeds = args.fuzz

    def progress(r):
        if args.quiet:
            return
        mark = "ok" if r.ok else "FAIL"
        ctl = r.stats.get("control", {})
        print(f"{r.scenario:34s} seed {r.seed:5d} {mark} "
              f"trace={r.trace_hash[:12]} "
              f"attaches={ctl.get('attaches', 0)} "
              f"rollouts={ctl.get('rollouts', 0)}", file=sys.stderr)

    reports = sweep(scenarios, n_seeds, start_seed=args.start_seed,
                    progress=progress, device=args.device)
    for name, n in extra_runs:
        reports.extend(sweep((name,), n, start_seed=args.start_seed,
                             progress=progress, device=args.device))
    out = verdict(reports, scenarios + tuple(n for n, _ in extra_runs),
                  n_seeds, args.start_seed,
                  check_coverage=not args.no_coverage_gate)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
