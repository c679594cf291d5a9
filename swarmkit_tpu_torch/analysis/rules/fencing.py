"""epoch-fencing: every leader-path proposal carries a leadership epoch.

PR 5 made split-brain safety hang on a convention: a proposal minted
under reign N must be rejected if reign N+1 has started, which only
works when every proposal API *threads the epoch through*.  Three
mechanical checks keep the convention from rotting:

* call sites: every call to ``propose_async`` / ``bulk_update_tasks`` /
  ``commit_task_block`` must pass ``epoch=`` (or forward ``**kwargs``).
  A deliberate unfenced branch (the legacy-proposer compatibility path
  in the store) carries a per-line suppression with its justification;
* definitions: any function *named* ``propose`` / ``propose_async`` /
  ``bulk_update_tasks`` / ``commit_task_block`` must accept an
  ``epoch`` parameter (or ``**kwargs``) — a new proposer implementation
  cannot silently drop fencing support;
* the store's implicit pin: ``store.update(cb)`` deliberately has no
  epoch argument — it pins the epoch *internally* at commit start.
  This rule asserts that ``state/store.py``'s commit path
  (``_propose_and_commit``) still reads ``_proposer_epoch``, so the
  internal pin can't be refactored away unnoticed.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..core import Checker, Finding, ModuleInfo, attr_tail, \
    has_epoch_argument, register

FENCED_CALLS = {"propose_async", "bulk_update_tasks", "commit_task_block"}
# bare `propose` is excluded: the name is shared with the CORE-level
# consensus append (RaftCore.propose(data) -> index), which fences one
# layer up at RaftNode/SimRaftProposer — exactly the APIs named here
FENCED_DEFS = FENCED_CALLS

STORE_MODULE = "swarmkit_tpu_torch/state/store.py"
STORE_COMMIT_FN = "_propose_and_commit"
STORE_PIN = "_proposer_epoch"


def _accepts_epoch(fn: ast.FunctionDef) -> bool:
    args = fn.args
    names = [a.arg for a in args.args + args.kwonlyargs
             + getattr(args, "posonlyargs", [])]
    return "epoch" in names or args.kwarg is not None


@register
class EpochFencing(Checker):
    name = "epoch-fencing"
    description = ("proposals on leader paths must thread a leadership "
                   "epoch (propose_async/bulk_update_tasks/"
                   "commit_task_block; store.update pins internally)")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                tail = attr_tail(node.func)
                if tail in FENCED_CALLS and not has_epoch_argument(node):
                    out.append(mod.finding(
                        self.name, node,
                        f"{tail}() without epoch=: proposals must be "
                        "pinned to the leadership epoch they were "
                        "planned under (see docs/architecture.md, "
                        "leadership fencing)"))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in FENCED_DEFS \
                    and not _accepts_epoch(node):
                out.append(mod.finding(
                    self.name, node,
                    f"def {node.name}(...) does not accept an epoch "
                    "parameter: every proposal API must support fencing"))
        if mod.relpath == STORE_MODULE:
            out.extend(self._check_store_pin(mod))
        return out

    def _check_store_pin(self, mod: ModuleInfo) -> List[Finding]:
        """store.update has no epoch arg by design — the commit path must
        therefore pin the proposer epoch itself."""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == STORE_COMMIT_FN:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) \
                            and sub.attr == STORE_PIN:
                        return []
                    if isinstance(sub, ast.Name) and sub.id == STORE_PIN:
                        return []
                return [mod.finding(
                    self.name, node,
                    f"{STORE_COMMIT_FN} no longer reads {STORE_PIN}: "
                    "store.update() relies on it to pin proposals to "
                    "the epoch current at commit start")]
        return [Finding(
            rule=self.name, path=mod.relpath, line=1, col=0,
            message=f"{STORE_COMMIT_FN} not found: the store commit "
                    "path (which pins the leadership epoch) moved — "
                    "update this rule's anchor",
            code=mod.code_at(1))]
