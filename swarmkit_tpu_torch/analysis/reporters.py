"""Human and JSON reporters for lint results."""

from __future__ import annotations

import json
from typing import List

from .runner import LintResult


def human_report(result: LintResult, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in result.new:
        lines.append(f.render())
    if result.stale:
        lines.append("")
        lines.append("stale baseline entries (fixed or moved code — "
                     "remove them from the baseline; it only shrinks):")
        for e in result.stale:
            lines.append(f"  {e.path}: [{e.rule}] {e.code!r}")
    if result.unjustified:
        lines.append("")
        lines.append("baseline entries missing a one-line justification:")
        for e in result.unjustified:
            lines.append(f"  {e.path}: [{e.rule}] {e.code!r}")
    if verbose and result.baselined:
        lines.append("")
        lines.append("grandfathered (baselined) findings:")
        for f in result.baselined:
            lines.append("  " + f.render())
    lines.append("")
    lines.append(
        f"swarmlint: {len(result.new)} finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{result.suppressed} suppressed, "
        f"{len(result.stale)} stale baseline entr(y/ies), "
        f"{len(result.modules)} module(s), "
        f"{len(result.rules)} rule(s): "
        f"{'FAIL' if not result.ok else 'ok'}")
    return "\n".join(lines)


def json_report(result: LintResult) -> str:
    return json.dumps({
        "ok": result.ok,
        "rules": result.rules,
        "modules": len(result.modules),
        "suppressed": result.suppressed,
        "findings": [vars(f) for f in result.new],
        "baselined": [vars(f) for f in result.baselined],
        "stale_baseline": [e.to_dict() for e in result.stale],
        "unjustified_baseline": [e.to_dict() for e in result.unjustified],
    }, indent=2, sort_keys=True)
