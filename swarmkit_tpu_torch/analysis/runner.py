"""Tree walker + orchestration: parse, check, suppress, baseline.

``lint_tree`` is the one entry point (the CLI and the tier-1 test both
call it): collect sources, run every requested checker over each
module, drop per-line-suppressed findings, validate that suppressions
name real rules, then split what remains against the committed
baseline.  The result is clean (``ok``) only when there are no new
findings, no stale baseline entries, no unjustified baseline entries,
and no parse failures.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

from .baseline import Baseline, BaselineEntry
from .core import ALL_RULES, Checker, Finding, ModuleInfo, checker_names, \
    make_checkers

#: what `python -m swarmkit_tpu_torch.scripts.swarmlint` (and the tier-1
#: test) lints by default
DEFAULT_ROOTS = ("swarmkit_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = "swarmlint_torch_baseline.json"

_SKIP_DIRS = {"__pycache__", ".git", "native", "build", "_build"}


@dataclass
class LintResult:
    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale: List[BaselineEntry] = field(default_factory=list)
    unjustified: List[BaselineEntry] = field(default_factory=list)
    suppressed: int = 0
    modules: List[str] = field(default_factory=list)
    rules: List[str] = field(default_factory=list)
    #: all unsuppressed findings before baseline split (for --write-baseline)
    raw: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale and not self.unjustified


def iter_source_files(repo_root: str,
                      roots: Iterable[str] = DEFAULT_ROOTS
                      ) -> List[str]:
    """Repo-relative paths of every .py file under the given roots."""
    out: List[str] = []
    for root in roots:
        abs_root = os.path.normpath(os.path.join(repo_root, root))
        if not os.path.exists(abs_root):
            # a typo'd root silently linting NOTHING would let the CI
            # gate pass vacuously — fail loudly instead
            raise FileNotFoundError(
                f"swarmlint root {root!r} does not exist under "
                f"{repo_root}")
        if os.path.isfile(abs_root):
            # normalize ('./chip_smoke.py', absolute paths) to the canonical
            # repo-relative form — rule whitelists and baseline entries
            # match on it
            out.append(os.path.relpath(abs_root, repo_root)
                       .replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          repo_root)
                    out.append(rel.replace(os.sep, "/"))
    return sorted(set(out))


def load_modules(repo_root: str, relpaths: Iterable[str]
                 ) -> (List[ModuleInfo], List[Finding]):
    mods: List[ModuleInfo] = []
    errors: List[Finding] = []
    for rel in relpaths:
        with open(os.path.join(repo_root, rel), encoding="utf-8") as f:
            source = f.read()
        try:
            mods.append(ModuleInfo.from_source(source, rel))
        except SyntaxError as e:
            errors.append(Finding(
                rule="parse-error", path=rel, line=e.lineno or 1, col=0,
                message=f"syntax error: {e.msg}", code=""))
    return mods, errors


def run_checkers(checkers: List[Checker], mods: List[ModuleInfo]
                 ) -> (List[Finding], int, List[Finding]):
    """-> (kept findings, suppressed count, bad-suppression findings)."""
    kept: List[Finding] = []
    suppressed = 0
    by_path = {m.relpath: m for m in mods}
    for mod in mods:
        for checker in checkers:
            for f in checker.check(mod):
                if mod.suppressed(f):
                    suppressed += 1
                else:
                    kept.append(f)
    for checker in checkers:
        for f in checker.finalize():
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f):
                suppressed += 1
            else:
                kept.append(f)

    # every suppression comment must name a real rule: a typo must be an
    # error, never a silent no-op
    known = set(checker_names()) | {ALL_RULES}
    bad: List[Finding] = []
    for mod in mods:
        for line, rules in sorted(mod.suppressions.items()):
            for r in sorted(rules - known):
                if line <= len(mod.lines) \
                        and "swarmlint" in mod.lines[line - 1]:
                    bad.append(Finding(
                        rule="bad-suppression", path=mod.relpath,
                        line=line, col=0,
                        message=f"suppression names unknown rule {r!r} "
                                f"(known: {', '.join(sorted(known))})",
                        code=mod.code_at(line)))
    return kept, suppressed, bad


def lint_tree(repo_root: str,
              roots: Iterable[str] = DEFAULT_ROOTS,
              rules: Optional[Iterable[str]] = None,
              baseline_path: Optional[str] = DEFAULT_BASELINE
              ) -> LintResult:
    from . import rules as _rules  # noqa: F401  (registration side effect)

    checkers = make_checkers(rules)
    relpaths = iter_source_files(repo_root, roots)
    mods, parse_errors = load_modules(repo_root, relpaths)
    findings, suppressed, bad = run_checkers(checkers, mods)
    findings = sorted(findings + parse_errors + bad,
                      key=lambda f: (f.path, f.line, f.rule))

    result = LintResult(suppressed=suppressed,
                        modules=[m.relpath for m in mods],
                        rules=[c.name for c in checkers],
                        raw=findings)
    if baseline_path is not None:
        full = Baseline.load(os.path.join(repo_root, baseline_path)
                             if not os.path.isabs(baseline_path)
                             else baseline_path)
        # a subtree / rule-subset run judges only the entries it could
        # have re-observed: out-of-scope entries are neither matched nor
        # stale (the full default run still ratchets everything)
        bl = Baseline(_in_scope(full.entries, result))
        result.new, result.baselined, result.stale = bl.split(findings)
        result.unjustified = bl.unjustified()
    else:
        result.new = findings
    return result


#: rules the runner itself emits, always active regardless of --rules
_META_RULES = {"parse-error", "bad-suppression"}


def _in_scope(entries: List[BaselineEntry], result: LintResult
              ) -> List[BaselineEntry]:
    scanned = set(result.modules)
    active = set(result.rules) | _META_RULES
    return [e for e in entries
            if e.path in scanned and e.rule in active]


def write_baseline(repo_root: str, result: LintResult,
                   baseline_path: str = DEFAULT_BASELINE,
                   justification: str = "TODO: justify or fix") -> int:
    """Regenerate the baseline from the current raw findings, keeping
    the justification of entries that still match.  One entry PER
    occurrence (matching is count-aware).  Entries OUTSIDE the run's
    scope (files not scanned / rules not active) are preserved verbatim
    — a subtree --write-baseline must never destroy the rest of the
    grandfather list.  New entries get the TODO placeholder, which
    ``Baseline.unjustified`` deliberately still FAILS: regenerating
    never yields a green run until a human justifies each new line.
    Returns the total entry count."""
    path = baseline_path if os.path.isabs(baseline_path) \
        else os.path.join(repo_root, baseline_path)
    old_entries = Baseline.load(path).entries
    in_scope = _in_scope(old_entries, result)
    kept_out = [e for e in old_entries if e not in in_scope]
    # key -> queue of old justifications, consumed one per occurrence
    old_just: dict = {}
    for e in in_scope:
        old_just.setdefault(e.key(), []).append(e.justification)
    entries = list(kept_out)
    for f in result.raw:
        queued = old_just.get(f.key())
        entries.append(BaselineEntry(
            rule=f.rule, path=f.path, code=f.code,
            justification=queued.pop(0) if queued else justification))
    bl = Baseline(entries)
    bl.save(path)
    return len(bl.entries)
