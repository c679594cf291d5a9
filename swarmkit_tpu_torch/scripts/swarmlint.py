"""swarmlint CLI — run the project's AST invariant linter.

Usage:
    python -m swarmkit_tpu_torch.scripts.swarmlint  # the port, all rules
    python -m swarmkit_tpu_torch.scripts.swarmlint swarmkit_tpu_torch/state
    python -m swarmkit_tpu_torch.scripts.swarmlint --rules layering
    python -m swarmkit_tpu_torch.scripts.swarmlint --format json
    python -m swarmkit_tpu_torch.scripts.swarmlint --list-rules
    python -m swarmkit_tpu_torch.scripts.swarmlint --write-baseline
        # regenerate the grandfather list (entries keep their
        # justifications)

Exit status: 0 clean (baselined findings are fine), 1 on new findings,
stale/unjustified baseline entries, or parse errors.
"""

import argparse
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from ..analysis import (
    DEFAULT_BASELINE, DEFAULT_ROOTS, checker_names, lint_tree,
    make_checkers, write_baseline)
from ..analysis.reporters import human_report, json_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="swarmlint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_ROOTS})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path, repo-relative "
                         f"(default: {DEFAULT_BASELINE}); 'none' disables")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings")
    ap.add_argument("--verbose", action="store_true",
                    help="also print grandfathered findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for c in make_checkers():
            print(f"{c.name:24s} {c.description}")
        return 0

    rules = [r.strip() for r in args.rules.split(",")] \
        if args.rules else None
    baseline = None if args.baseline == "none" else args.baseline
    roots = args.paths or DEFAULT_ROOTS
    result = lint_tree(REPO_ROOT, roots=roots, rules=rules,
                       baseline_path=baseline)

    if args.write_baseline:
        if baseline is None:
            ap.error("--write-baseline conflicts with --baseline none "
                     "(there is no file to write)")
        n = write_baseline(REPO_ROOT, result, baseline)
        print(f"wrote {n} entries to {baseline} "
              "(fill in 'justification' for each)")
        return 0

    if args.format == "json":
        print(json_report(result))
    else:
        print(human_report(result, verbose=args.verbose))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
