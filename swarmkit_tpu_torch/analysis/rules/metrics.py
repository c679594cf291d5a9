"""metric-hygiene: exposition-grammar checks at the call site.

Migrated from ``tests/test_flightrec.py``'s live-registry walk so it
runs over *source* — a metric name only ever emitted on a rare error
path gets checked on every lint run, not only when a test happens to
drive that path.  For every string literal (or f-string) passed to a
registry API (``counter``/``gauge``/``timer``/``get_counter``/
``get_gauge``/``observe_*``) the rule enforces the same grammar the
exposition endpoint guarantees:

* base name matches ``^swarm_[a-z0-9_]+$``;
* labels, when written literally, are ``key="value"`` pairs with
  sorted, duplicate-free keys (sorted keys make exposition strings
  stable, which the flight recorder's sha-stable dumps rely on);
* the number of *distinct literal labelsets* per base name stays under
  the cardinality bound — the static shadow of the runtime check (label
  values interpolated at runtime are each one labelset here; the live
  cardinality guard on real label values stays in tests);
* no *per-entity* label keys (``task``/``node``/``session``/... — see
  ``UNBOUNDED_LABEL_KEYS``): a counter or gauge keyed by a task or
  node id mints one series per entity and grows with cluster size, not
  with code.  Bounded domains — ``service``, ``tenant``, ``plane``,
  ``check`` — stay legal; per-entity detail belongs in task journeys
  and the flight recorder, not the metrics registry.

F-string label *values* are treated as opaque placeholders; f-string
fragments inside the base name must still produce a grammar-valid name
for any lowercase interpolation.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Checker, Finding, ModuleInfo, register

_BASE_RE = re.compile(r"^swarm_[a-z0-9_\x00]+$")
_LABEL_RE = re.compile(r'^[a-z_][a-z0-9_]*="[^"{},]*"$')
_PLACEHOLDER = "\x00"        # stands in for {interpolated} fragments
MAX_LABEL_CARDINALITY = 64

_REGISTRY_METHODS = {"counter", "gauge", "timer", "get_counter",
                     "get_gauge", "get_timer", "observe"}

#: label keys that identify one ENTITY per value: a series per task,
#: node, slot, or session is unbounded cardinality — it scales with the
#: cluster, not the codebase.  (service/tenant/plane/check are bounded
#: operator-facing domains and stay legal.)
UNBOUNDED_LABEL_KEYS = {
    "task", "task_id", "taskid",
    "node", "node_id", "nodeid",
    "slot", "container", "container_id",
    "session", "session_id", "agent", "agent_id",
}

#: receiver names that identify the metrics registry: calls on these get
#: the FULL grammar check, including the swarm_ namespace prefix (a call
#: on any other receiver is only checked when the name already claims
#: the swarm_ namespace — .timer()/.counter() are common method names)
_REGISTRY_RECEIVERS = {"registry", "metrics", "_metrics"}


def _receiver_is_registry(func: ast.Attribute) -> bool:
    cur = func.value
    while isinstance(cur, ast.Attribute):
        if cur.attr in _REGISTRY_RECEIVERS:
            return True
        cur = cur.value
    return isinstance(cur, ast.Name) and cur.id in _REGISTRY_RECEIVERS


def _literal_text(node: ast.AST) -> Optional[str]:
    """The static text of a str constant or f-string, with interpolated
    values replaced by a placeholder byte; None for non-strings."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append(_PLACEHOLDER)
        return "".join(parts)
    return None


@register
class MetricHygiene(Checker):
    name = "metric-hygiene"
    description = ("metric names match ^swarm_[a-z0-9_]+$ with sorted, "
                   "bounded-cardinality labels, checked at the source "
                   "call site")

    def __init__(self):
        self.labelsets: Dict[str, Set[str]] = {}
        self.base_locs: Dict[str, Tuple[str, int]] = {}

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTRY_METHODS
                    and node.args):
                continue
            text = _literal_text(node.args[0])
            if text is None:
                continue
            if text.startswith(_PLACEHOLDER):
                # name begins with an interpolated fragment: the prefix
                # is unverifiable statically, like any other placeholder
                continue
            if not text.startswith("swarm_"):
                # a misprefixed name on the REAL registry is exactly the
                # namespace violation the old live-registry test caught
                if _receiver_is_registry(node.func):
                    shown = text.split("{")[0].replace(_PLACEHOLDER, "…")
                    out.append(mod.finding(
                        self.name, node,
                        f"metric name {shown!r} is outside the swarm_ "
                        "namespace: every exposed metric must match "
                        "^swarm_[a-z0-9_]+$"))
                continue
            out.extend(self._check_name(mod, node, text))
        return out

    def _check_name(self, mod: ModuleInfo, node: ast.AST,
                    text: str) -> List[Finding]:
        out: List[Finding] = []
        shown = text.replace(_PLACEHOLDER, "…")   # messages stay printable
        if "{" in text:
            base, rest = text.split("{", 1)
            if not rest.endswith("}"):
                out.append(mod.finding(
                    self.name, node,
                    f"metric {shown!r}: unterminated label block"))
                return out
            keys: List[str] = []
            for pair in rest[:-1].split(","):
                norm = pair.replace(_PLACEHOLDER, "x")
                if not _LABEL_RE.match(norm):
                    out.append(mod.finding(
                        self.name, node,
                        f"metric {shown!r}: label {norm!r} is not "
                        'key="value" with a lowercase key'))
                    continue
                key = pair.split("=", 1)[0]
                keys.append(key)
                if key in UNBOUNDED_LABEL_KEYS:
                    out.append(mod.finding(
                        self.name, node,
                        f"metric {shown!r}: label key {key!r} is "
                        "per-entity (one series per task/node/session "
                        "is unbounded cardinality) — aggregate, or "
                        "use a bounded key like service/tenant/plane"))
            if keys != sorted(keys):
                out.append(mod.finding(
                    self.name, node,
                    f"metric {shown!r}: label keys must be sorted for "
                    "stable exposition (flight-recorder dumps hash "
                    "these strings)"))
            if len(keys) != len(set(keys)):
                out.append(mod.finding(
                    self.name, node,
                    f"metric {shown!r}: duplicate label key"))
            self.labelsets.setdefault(base, set()).add(rest)
            self.base_locs.setdefault(base, (mod.relpath, node.lineno))
        else:
            base = text
        if not _BASE_RE.match(base.replace(_PLACEHOLDER, "x")):
            out.append(mod.finding(
                self.name, node,
                f"metric name {shown.split(chr(123))[0]!r} violates "
                "^swarm_[a-z0-9_]+$"))
        return out

    def finalize(self) -> Iterable[Finding]:
        out: List[Finding] = []
        for base, sets in sorted(self.labelsets.items()):
            if len(sets) > MAX_LABEL_CARDINALITY:
                path, line = self.base_locs[base]
                out.append(Finding(
                    rule=self.name, path=path, line=line, col=0,
                    message=f"metric {base!r} has {len(sets)} distinct "
                            f"literal labelsets (> {MAX_LABEL_CARDINALITY})"
                            ": unbounded label?",
                    code=""))
        return out
