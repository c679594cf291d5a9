"""CLI for the deterministic simulator.

    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn
    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn --trace
    python -m swarmkit_tpu_torch.sim --fuzz 50 [--start-seed 100]
    python -m swarmkit_tpu_torch.sim --seed 7 --scenario gang-deadlock --device cpu
    python -m swarmkit_tpu_torch.sim --list

Exit status: 0 when every invariant held, 1 otherwise (failing seeds are
printed so they can be replayed verbatim).
"""

from __future__ import annotations

import argparse
import json
import sys

from .fuzz import failures, fuzz
from .scenario import SCENARIOS, run_scenario


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.sim")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scenario", default=None,
                   choices=sorted(SCENARIOS),
                   help="scenario to run (single-run default: "
                        "partition-churn; fuzz-mode default: rotate "
                        "seeds through the whole registry pool)")
    p.add_argument("--fuzz", type=int, metavar="N", default=0,
                   help="run N seeds; without --scenario the seeds "
                        "rotate through every pooled scenario "
                        "(random-fuzz, failover, rolling-update chaos, "
                        "legacy raft_cp variants)")
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--managers", type=int, default=3)
    p.add_argument("--agents", type=int, default=5)
    p.add_argument("--trace", action="store_true",
                   help="dump the full event trace to stderr")
    p.add_argument("--trace-json", metavar="PATH", default=None,
                   help="write the run's Chrome trace-event JSON here "
                        "(fuzz mode: one file per seed, suffixed)")
    p.add_argument("--list", action="store_true",
                   help="list scenarios and exit")
    p.add_argument("--device", default=None,
                   help="where the scenarios' planners run: the card "
                        "(default) or 'cpu' for the plain versions")
    args = p.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().split("\n")[0]
            print(f"{name:26s} {doc}")
        return 0

    if args.fuzz:
        def progress(r):
            mark = "ok" if r.ok else "FAIL"
            print(f"seed {r.seed:6d} {r.scenario:26s} {mark} "
                  f"trace={r.trace_hash[:12]} "
                  f"obs={r.obs_trace_sha256[:12]} events={r.events}",
                  file=sys.stderr)

        reports = fuzz(args.fuzz, start_seed=args.start_seed,
                       scenario=args.scenario, progress=progress,
                       device=args.device)
        if args.trace_json:
            for r in reports:
                path = (args.trace_json if len(reports) == 1
                        else f"{args.trace_json}.seed{r.seed}")
                with open(path, "w") as f:
                    f.write(r.obs_trace)
        bad = failures(reports)
        print(json.dumps({
            "seeds": args.fuzz,
            "start_seed": args.start_seed,
            # per-seed identity: the engine trace hash AND the sha of the
            # Chrome span trace — both pure functions of the seed, so two
            # runs of the same command are byte-identical end to end
            "runs": [
                {"seed": r.seed, "scenario": r.scenario, "ok": r.ok,
                 "events": r.events, "trace_hash": r.trace_hash,
                 "obs_trace_sha256": r.obs_trace_sha256}
                for r in reports],
            "failures": [
                {"seed": r.seed, "scenario": r.scenario,
                 "violations": r.violations,
                 # the black box: spans/samples/store events/raft
                 # transitions around the violation, sha-stable per seed
                 "flightrec": r.flightrec_path,
                 "flightrec_sha256": r.flightrec_sha256,
                 "reproduce": f"python -m swarmkit_tpu_torch.sim --seed "
                              f"{r.seed} --scenario {r.scenario}"}
                for r in bad],
            "ok": not bad,
        }, indent=2))
        return 1 if bad else 0

    report = run_scenario(args.scenario or "partition-churn", args.seed,
                          n_managers=args.managers, n_agents=args.agents,
                          keep_trace=args.trace, device=args.device)
    if args.trace:
        print("\n".join(report.trace), file=sys.stderr)
    if args.trace_json:
        with open(args.trace_json, "w") as f:
            f.write(report.obs_trace)
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
