"""swarmlint: AST-based invariant linter for swarmkit-tpu.

Mechanically enforces the conventions the runtime invariants hang on —
determinism seams, leadership-epoch fencing, lock discipline, package
layering, device-path purity, metric hygiene.  Run it with
``python -m swarmkit_tpu_torch.scripts.swarmlint``; the framework lives in
:mod:`swarmkit_tpu_torch.analysis.core`, the project rules in
:mod:`swarmkit_tpu_torch.analysis.rules`.
"""

from .baseline import Baseline, BaselineEntry
from .core import ALL_RULES, Checker, Finding, ModuleInfo, checker_names, \
    make_checkers, register
from .runner import DEFAULT_BASELINE, DEFAULT_ROOTS, LintResult, \
    iter_source_files, lint_tree, write_baseline

# importing the rules package registers every project rule
from . import rules  # noqa: E402,F401

__all__ = [
    "ALL_RULES", "Baseline", "BaselineEntry", "Checker", "Finding",
    "LintResult", "ModuleInfo", "DEFAULT_BASELINE", "DEFAULT_ROOTS",
    "checker_names", "iter_source_files", "lint_tree", "make_checkers",
    "register", "write_baseline",
]
