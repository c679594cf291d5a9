"""backpressure-discipline: no unbounded intake on serving hot paths.

The overload plane (ISSUE 20) has one load-bearing rule: every
container a dispatcher or scheduler hot path GROWS in response to
agent traffic must either carry a declared bound (an admission check
against a ``max_*`` config knob, a ``deque(maxlen=...)``, an
evict/compact pass) or count what it sheds.  An append with neither is
the memory leak that kills a manager at 1000x agent scale — slowly,
under exactly the fan-out a chaos seed won't reproduce on a laptop.

Lexical contract, in the spirit of the lock rule:

* **scope** — modules under ``swarmkit_tpu_torch/manager/`` and
  ``swarmkit_tpu_torch/scheduler/`` (the serving planes; sim, obs and
  orchestrators buffer on their own clocks and are not agent-driven).
* **growable container** — a ``self.X`` initialized in ``__init__`` as
  a bare ``[]`` or a ``deque()`` WITHOUT ``maxlen`` (a ``maxlen``
  deque is self-bounding and exempt by construction).
* **hot path** — a method carrying a ``session_id`` parameter (the
  session-gated agent RPC surface: heartbeat, status writeback,
  assignment streams), plus the named intake edges ``register``,
  ``tick``, ``enqueue``/``_enqueue``.
* **violation** — ``self.X.append/appendleft/extend(...)`` or
  ``heappush(self.X, ...)`` inside a hot path whose body mentions NO
  bound/shed vocabulary (``max_*``, ``limit``, ``bound``, ``cap``,
  ``budget``, ``shed``, ``evict``, ``compact``, ``trim``, ``prune``,
  ``drop``).  Mentioning the vocabulary is the declaration: the bound
  check and the grown container sit in the same method, reviewable in
  one screenful.

Lexical scope is the limit, as ever: a bound enforced by a helper the
hot path calls under a non-matching name needs a rename or a per-line
suppression with its justification — which is the point: the bound
must be visible where the growth is.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set

from ..core import Checker, Finding, ModuleInfo, register

#: the serving planes whose intake is agent-driven
HOT_ROOTS = ("swarmkit_tpu_torch/manager/",
             "swarmkit_tpu_torch/scheduler/")

#: named intake edges that are hot without a session_id parameter
HOT_NAMES = {"register", "tick", "enqueue", "_enqueue"}

#: vocabulary that declares a bound or a counted shed in the method
_BOUND_RE = re.compile(
    r"max_|limit|bound|cap|budget|shed|evict|compact|trim|prune|drop",
    re.IGNORECASE)

_GROW_METHODS = {"append", "appendleft", "extend"}


def _growable_attrs(cls: ast.ClassDef) -> Set[str]:
    """``self.X`` attrs initialized in ``__init__`` as ``[]`` or an
    unbounded ``deque()`` — the containers the rule tracks."""
    out: Set[str] = set()
    for fn in cls.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name != "__init__":
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, val = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None:
                tgt, val = node.target, node.value
            else:
                continue
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            if isinstance(val, ast.List) and not val.elts:
                out.add(tgt.attr)
            elif isinstance(val, ast.Call):
                f = val.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else "")
                if name == "deque" and not any(
                        kw.arg == "maxlen" for kw in val.keywords):
                    out.add(tgt.attr)
    return out


def _self_attr(expr: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X``, else None."""
    if isinstance(expr, ast.Attribute) \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


def _is_hot(fn: ast.FunctionDef) -> bool:
    if fn.name in HOT_NAMES:
        return True
    return any(a.arg == "session_id" for a in fn.args.args)


@register
class BackpressureDiscipline(Checker):
    name = "backpressure-discipline"
    description = ("dispatcher/scheduler hot paths may only grow a "
                   "queue behind a declared bound or a counted shed")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not mod.relpath.startswith(HOT_ROOTS):
            return []
        out: List[Finding] = []
        for cls in [n for n in mod.tree.body
                    if isinstance(n, ast.ClassDef)]:
            attrs = _growable_attrs(cls)
            if not attrs:
                continue
            for fn in [n for n in cls.body
                       if isinstance(n, ast.FunctionDef)]:
                if not _is_hot(fn):
                    continue
                declared = bool(_BOUND_RE.search(ast.unparse(fn)))
                if declared:
                    continue
                for site, attr in self._grow_sites(fn, attrs):
                    out.append(mod.finding(
                        self.name, site,
                        f"{cls.name}.{fn.name} grows self.{attr} on a "
                        "serving hot path with no declared bound or "
                        "shed counter: agent traffic sizes this "
                        "container, so it needs an admission check "
                        "against a max_* knob, a maxlen deque, or a "
                        "counted shed/evict pass in the same method "
                        "(see dispatcher.py update_task_status for "
                        "the sanctioned shape)"))
        return out

    @staticmethod
    def _grow_sites(fn: ast.FunctionDef, attrs: Set[str]):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # self.X.append / appendleft / extend
            if isinstance(f, ast.Attribute) and f.attr in _GROW_METHODS:
                attr = _self_attr(f.value)
                if attr in attrs:
                    yield node, attr
            # heapq.heappush(self.X, ...) / heappush(self.X, ...)
            is_heappush = (
                isinstance(f, ast.Attribute) and f.attr == "heappush"
            ) or (isinstance(f, ast.Name) and f.id == "heappush")
            if is_heappush and node.args:
                attr = _self_attr(node.args[0])
                if attr in attrs:
                    yield node, attr
