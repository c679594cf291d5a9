#!/usr/bin/env python
"""Seed-sweep the leader-failover scenarios (raft-attached control
plane) and fail loudly on any invariant violation.

Thin wrapper kept for CLI compatibility: the sweep implementation moved
to scripts/chaos_sweep.py, which generalizes it to any scenario subset
and adds the fault-type x component coverage report.

    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 20
    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 20 --scenario leader-crash-mid-tick
    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 2 --device cpu
    python -m swarmkit_tpu_torch.scripts.failover_fuzz --list

Each (scenario, seed) runs the full raft-attached control plane —
scheduler, dispatcher, allocator, restart supervisor, replicated +
global orchestrators on per-member replicated stores — through its
fault timeline under every invariant checker (single-leader-per-term,
committed-entry ledger, FSM monotonicity, no-double-assign,
control-loops-only-on-leader, no-stale-epoch-commit, failover
re-placement).  Exit status is 0 only when every run held every
invariant; failures print the violations, the exact replay command, and
the flight-recorder post-mortem path + sha the runner dumped.

The tier-1 test (tests/test_failover.py) runs a small deterministic
sweep through this same entry point; the wide sweep is the `slow` tier.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..sim.scenario import (
    FAILOVER_SCENARIOS, SCENARIOS,
)
from .chaos_sweep import sweep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.scripts.failover_fuzz")
    p.add_argument("--fuzz", type=int, metavar="N", default=5,
                   help="seeds per scenario (default 5)")
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--scenario", action="append", default=None,
                   choices=sorted(FAILOVER_SCENARIOS),
                   help="restrict to one scenario (repeatable); "
                        "default: the whole failover suite")
    p.add_argument("--list", action="store_true",
                   help="list the failover scenarios and exit")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-run progress lines")
    p.add_argument("--device", default=None,
                   help="where the scenarios' planners run: the card "
                        "(default) or 'cpu' for the plain versions")
    args = p.parse_args(argv)

    if args.list:
        for name in FAILOVER_SCENARIOS:
            doc = (SCENARIOS[name].__doc__ or "").strip().split("\n")[0]
            print(f"{name:32s} {doc}")
        return 0

    scenarios = tuple(args.scenario) if args.scenario \
        else FAILOVER_SCENARIOS

    def progress(r):
        if args.quiet:
            return
        mark = "ok" if r.ok else "FAIL"
        ctl = r.stats.get("control", {})
        print(f"{r.scenario:32s} seed {r.seed:5d} {mark} "
              f"trace={r.trace_hash[:12]} "
              f"attaches={ctl.get('attaches', 0)}", file=sys.stderr)

    reports = sweep(scenarios, args.fuzz, start_seed=args.start_seed,
                    progress=progress, keep_trace=False,
                    device=args.device)
    bad = [r for r in reports if not r.ok]
    print(json.dumps({
        "scenarios": list(scenarios),
        "seeds_per_scenario": args.fuzz,
        "start_seed": args.start_seed,
        "runs": len(reports),
        "failures": [
            {"scenario": r.scenario, "seed": r.seed,
             "violations": r.violations,
             "flightrec": r.flightrec_path,
             "flightrec_sha256": r.flightrec_sha256,
             "reproduce": f"python -m swarmkit_tpu_torch.sim --seed {r.seed} "
                          f"--scenario {r.scenario}"}
            for r in bad],
        "ok": not bad,
    }, indent=2))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
