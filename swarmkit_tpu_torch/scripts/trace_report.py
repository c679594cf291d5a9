"""Summarize or diff Chrome trace-event JSON as per-phase tables.

Usage:
    python -m swarmkit_tpu_torch.scripts.trace_report trace.json
    python -m swarmkit_tpu_torch.scripts.trace_report trace.json --validate
    python -m swarmkit_tpu_torch.scripts.trace_report sim_trace.json --json
    python -m swarmkit_tpu_torch.scripts.trace_report --diff A.json B.json
    python -m swarmkit_tpu_torch.scripts.trace_report --critical-path ART
    python -m swarmkit_tpu_torch.scripts.trace_report --device ART

Works on any trace the port's obs tracer emits
(``obs.tracer.chrome_trace()``, ``python -m swarmkit_tpu_torch.sim
--trace-json``, or a ``/debug/trace`` download).  When the trace carries ``bench.config`` marker spans, a table
is printed per config; otherwise one table covers the whole trace.
``--validate`` schema-checks the document and exits non-zero on problems
(the tier-1 smoke test runs exactly this check in-process).
``--diff A B`` prints a side-by-side phase table with per-phase total_s
deltas (A = baseline, B = candidate), matched per config window where
both traces carry the same ``bench.config`` markers — the same
``obs/report.py`` aggregation the bench artifact embeds.
``--critical-path ART`` and ``--device ART`` read a bench ARTIFACT (not
a trace).  The port writes no bench artifact yet (ROADMAP A1), so every
artifact is one without the journey attribution or the device ledger:
both exit 1 with the message for such an artifact.
"""

import argparse
import json
import sys

from ..obs.report import (
    config_windows, diff_phase_tables, format_diff, format_table,
    phase_table, validate_chrome_trace, x_events,
)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _tables(doc):
    windows = config_windows(doc)
    if not windows:
        windows = [("all", None)]
    return {name: phase_table(doc, window=w) for name, w in windows}


def _run_diff(path_a: str, path_b: str, as_json: bool) -> int:
    doc_a, doc_b = _load(path_a), _load(path_b)
    ta, tb = _tables(doc_a), _tables(doc_b)
    only_a = sorted(set(ta) - set(tb))
    only_b = sorted(set(tb) - set(ta))
    names = [n for n in ta if n in tb]
    matched = {}
    if names:
        matched = {n: (ta[n], tb[n]) for n in names}
    else:
        # no shared config windows: diff whole-trace tables (and still
        # report the disjoint config sets below — that mismatch is the
        # headline when it happens)
        matched = {"all": (phase_table(doc_a), phase_table(doc_b))}
        names = ["all"]
    diffs = {name: diff_phase_tables(a, b)
             for name, (a, b) in matched.items()}
    if as_json:
        print(json.dumps(diffs, indent=2, sort_keys=True))
        return 0
    print(f"A = {path_a}\nB = {path_b}\n")
    for name in names:
        print(f"=== {name} ===")
        print(format_diff(diffs[name]))
        print()
    if only_a:
        print(f"configs only in A: {', '.join(only_a)}")
    if only_b:
        print(f"configs only in B: {', '.join(only_b)}")
    return 0


def _run_critical_path() -> int:
    """No port bench artifact carries the journey attribution yet
    (ROADMAP A1): exit 1 with the message for an artifact without it."""
    print("critical-path: artifact carries no journey_attribution (bench "
          "ran without the e2e config, or journeys were disabled)",
          file=sys.stderr)
    return 1


def _run_device(path: str) -> int:
    """No port bench artifact carries the device-telemetry ledger yet
    (ROADMAP A1): exit 1 with the message for an artifact without it."""
    print(f"{path}: artifact carries no device_telemetry (bench "
          "predates the device ledger, or telemetry was disabled)",
          file=sys.stderr)
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m swarmkit_tpu_torch.scripts.trace_report")
    p.add_argument("trace", nargs="+",
                   help="Chrome trace-event JSON file(s); two with "
                        "--diff; a bench artifact with --critical-path")
    p.add_argument("--validate", action="store_true",
                   help="schema-check only; exit 1 on problems")
    p.add_argument("--json", action="store_true",
                   help="emit the phase table(s) as JSON")
    p.add_argument("--diff", action="store_true",
                   help="side-by-side phase diff of two traces (A B)")
    p.add_argument("--critical-path", action="store_true",
                   help="per-plane attribution of time-to-running p99 "
                        "from a bench ARTIFACT; the port writes none yet "
                        "(ROADMAP A1), so this exits 1")
    p.add_argument("--device", action="store_true",
                   help="device-telemetry ledger from a bench ARTIFACT; "
                        "the port writes none yet (ROADMAP A1), so this "
                        "exits 1")
    args = p.parse_args(argv)

    if args.device:
        if len(args.trace) != 1:
            p.error("--device takes exactly one bench artifact")
        return _run_device(args.trace[0])
    if args.critical_path:
        if len(args.trace) != 1:
            p.error("--critical-path takes exactly one bench artifact")
        return _run_critical_path()
    if args.diff:
        if len(args.trace) != 2:
            p.error("--diff takes exactly two trace files")
        return _run_diff(args.trace[0], args.trace[1], args.json)
    if len(args.trace) != 1:
        p.error("pass one trace file (or two with --diff)")

    doc = _load(args.trace[0])

    problems = validate_chrome_trace(doc)
    if args.validate:
        for pr in problems:
            print(pr, file=sys.stderr)
        print(f"{args.trace[0]}: "
              f"{'INVALID' if problems else 'ok'} "
              f"({len(x_events(doc))} spans)")
        return 1 if problems else 0
    if problems:
        print(f"warning: {len(problems)} schema problems "
              f"(run --validate)", file=sys.stderr)

    tables = _tables(doc)
    if args.json:
        print(json.dumps(tables, indent=2, sort_keys=True))
        return 0
    for name, table in tables.items():
        print(f"=== {name} ===")
        print(format_table(table))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
