"""lock-discipline: lock-order cycles and blocking work under hot locks.

Python has no ``-race`` detector, so the two deadlock shapes that bit
the reference (and that PRs 4-5 carefully designed around) are enforced
lexically from the AST:

* **lock-order cycles** — every ``with <obj>.<attr>:`` whose attribute
  looks like a lock contributes acquisition edges (outer -> inner,
  within one function scope) to a global graph; any cycle across the
  tree is flagged.  Today's sanctioned order is
  ``MemoryStore._update_lock -> MemoryStore._lock``.
* **blocking under the store locks** — the store *view* lock
  (``MemoryStore._lock``) is taken by every reader and by the raft
  apply path, so holding it across anything blocking (consensus waits,
  device dispatch, D2H fetches, sleeps) stalls the whole plane.  The
  *update* lock serializes writers THROUGH consensus by design — raft
  proposals under it are the commit path itself and are allowed — but
  device-side blocking (planner ``dispatch_group``/``fetch_group``,
  ``jax.device_get``, ``block_until_ready``, sleeps; in the port any
  ``.synchronize()`` and ``finish_fetch``) under it would couple device
  latency into every writer, and is flagged.

Lexical scope is the limit: a callback defined under a lock but invoked
elsewhere is not charged to that lock (nested ``def``/``lambda`` reset
the held-lock stack), and manual ``.acquire()``/``.release()`` regions
are not tracked.  That is the same tradeoff ``go vet`` makes — catch
the shapes that appear in real diffs, mechanically, with zero runtime.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Checker, Finding, ModuleInfo, attr_tail, register

_LOCK_ATTR_RE = re.compile(r"lock|mutex|_mu$", re.IGNORECASE)

#: lock name -> call tails that must not run while it is held.
#: Keys are ``Class.attr`` as produced by :func:`_lock_key`.
NO_BLOCK_UNDER: Dict[str, Set[str]] = {
    "MemoryStore._lock": {
        "propose", "propose_async", "wait_proposal", "fetch_group",
        "dispatch_group", "schedule_group", "device_get",
        "block_until_ready", "sleep", "read_barrier",
        "fanout_expand", "expand_events",
        # the port's device syncs: torch.cuda / an event / a stream
        # .synchronize() and the fetch stage's wait
        "synchronize", "finish_fetch",
    },
    # read_barrier under the UPDATE lock deadlocks a follower outright:
    # the barrier waits for remote applies, and apply_store_actions
    # needs the update lock the waiter is holding.  (propose/wait under
    # it remain the sanctioned leader commit path.)  The GIL-released
    # native watch fan-out (fanout_expand / its expand_events wrapper,
    # ISSUE 13) is consumer-thread work by contract: under the WRITER
    # lock it would tax every committer with O(block) synthesis the
    # coalesced-event design exists to avoid.
    "MemoryStore._update_lock": {
        "fetch_group", "dispatch_group", "schedule_group",
        "device_get", "block_until_ready", "sleep", "read_barrier",
        "fanout_expand", "expand_events",
        "synchronize", "finish_fetch",
    },
}


def _lock_key(expr: ast.AST, cls: Optional[str]) -> Optional[str]:
    """``self._lock`` inside class C -> ``C._lock``; deeper chains keep
    their dotted suffix (``self._store._update_lock`` ->
    ``MemoryStore._update_lock`` is NOT inferred — cross-object locks
    keep the attribute path, e.g. ``_store._update_lock``)."""
    if not isinstance(expr, ast.Attribute) \
            or not _LOCK_ATTR_RE.search(expr.attr):
        return None
    parts: List[str] = [expr.attr]
    cur = expr.value
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    if cur.id == "self" and len(parts) == 1:
        return f"{cls or '?'}.{parts[0]}"
    if cur.id != "self":
        parts.append(cur.id)
    return ".".join(reversed(parts))


@register
class LockDiscipline(Checker):
    name = "lock-discipline"
    description = ("no lock-order cycles; no blocking raft/device calls "
                   "while the store locks are held")

    def __init__(self):
        # edge (outer, inner) -> first location seen
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # ------------------------------------------------------------ check
    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        self._out: List[Finding] = []
        self._mod = mod
        for node in mod.tree.body:
            self._visit(node, cls=None, held=[])
        return self._out

    def _visit(self, node: ast.AST, cls: Optional[str],
               held: List[str]) -> None:
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                self._visit(child, cls=node.name, held=[])
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # new runtime scope: locks held at the definition site are
            # not held at call time
            body = node.body if not isinstance(node, ast.Lambda) \
                else [node.body]
            for child in body:
                self._visit(child, cls=cls, held=[])
            return
        if isinstance(node, ast.With):
            acquired: List[str] = []
            for item in node.items:
                # context expressions evaluate under the locks already
                # held (including earlier items of this statement):
                # blocking calls there are violations too
                self._visit(item.context_expr, cls, held + acquired)
                key = _lock_key(item.context_expr, cls)
                if key is None:
                    continue
                # `with a, b:` acquires in order — a is held when b is
                # taken, so earlier items edge into later ones exactly
                # like lexical nesting
                for outer in held + acquired:
                    if outer != key:
                        self.edges.setdefault(
                            (outer, key),
                            (self._mod.relpath, item.context_expr.lineno))
                acquired.append(key)
            for child in node.body:
                self._visit(child, cls, held + acquired)
            return
        if isinstance(node, ast.Call):
            tail = attr_tail(node.func)
            if tail is not None:
                for lock in held:
                    banned = NO_BLOCK_UNDER.get(lock)
                    if banned and tail in banned:
                        self._out.append(self._mod.finding(
                            self.name, node,
                            f"{tail}() while holding {lock}: blocking "
                            "raft/device work under the store lock "
                            "stalls every reader and the raft apply "
                            "path — release first (see store.py commit "
                            "path for the sanctioned shape)"))
        for child in ast.iter_child_nodes(node):
            self._visit(child, cls, held)

    # --------------------------------------------------------- finalize
    def finalize(self) -> Iterable[Finding]:
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        out: List[Finding] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str],
                visiting: Set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cycle = tuple(sorted(path))
                    if cycle in seen_cycles:
                        continue
                    seen_cycles.add(cycle)
                    loc_path, loc_line = self.edges[(node, start)]
                    chain = " -> ".join(path + [start])
                    out.append(Finding(
                        rule=self.name, path=loc_path, line=loc_line,
                        col=0,
                        message=f"lock-order cycle: {chain}: two "
                                "threads taking these locks in opposite "
                                "orders deadlock",
                        code=""))
                elif nxt not in visiting:
                    dfs(start, nxt, path + [nxt], visiting | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out
