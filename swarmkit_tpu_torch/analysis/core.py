"""swarmlint core: findings, checker registry, per-module AST context.

The reference SwarmKit leans on ``go vet``/staticcheck/``-race`` to keep
its concurrent control plane honest; this package is the Python
equivalent, specialized to THIS codebase's invariants (see
``swarmkit_tpu_torch/analysis/rules/``).  The framework is deliberately small:

* a :class:`Finding` is one diagnostic, fingerprinted by the *source
  text* of the offending line (not its number) so committed baselines
  survive unrelated edits;
* a :class:`Checker` visits one module at a time and may emit more
  findings from :meth:`Checker.finalize` once the whole tree has been
  seen (cross-module rules: layering, lock-order cycles, metric
  cardinality);
* suppressions are per-line comments — ``# swarmlint: disable=<rule>``
  on the offending line, or on a comment-only line directly above it —
  and the runner rejects suppressions naming unknown rules, so a typo
  can never silently disable enforcement.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Type

#: sentinel rule name: ``disable=all`` suppresses every rule on a line
ALL_RULES = "all"

_SUPPRESS_RE = re.compile(r"#\s*swarmlint:\s*disable=([A-Za-z0-9_\-]+"
                          r"(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


@dataclass(frozen=True)
class Finding:
    """One diagnostic.  ``code`` (the stripped source line) is the
    baseline fingerprint: rule+path+code identifies a grandfathered
    finding across line-number drift."""

    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int
    message: str
    code: str = ""

    def key(self):
        return (self.rule, self.path, self.code)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"


class ModuleInfo:
    """Parsed module + everything checkers need: dotted name, package
    segment, source lines, import alias map, suppression map."""

    def __init__(self, relpath: str, source: str, tree: ast.AST):
        self.relpath = relpath.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        raw = self.relpath[:-3].split("/") \
            if self.relpath.endswith(".py") else self.relpath.split("/")
        parts = raw[:-1] if raw and raw[-1] == "__init__" else raw
        self.module = ".".join(parts)
        # first package segment under swarmkit_tpu_torch/ ("" for top-level
        # modules like swarmd.py, and for chip_smoke.py); computed
        # from the PATH so a package's own __init__ belongs to it
        if raw[0] == "swarmkit_tpu_torch" and len(raw) > 2:
            self.package = raw[1]
        else:
            self.package = ""
        self.suppressions = self._parse_suppressions()
        annotate_parents(tree)

    @classmethod
    def from_source(cls, source: str, relpath: str) -> "ModuleInfo":
        return cls(relpath, source, ast.parse(source))

    # ---------------------------------------------------- suppressions
    def _parse_suppressions(self) -> Dict[int, Set[str]]:
        """Directive scan over REAL comment tokens (via tokenize), so a
        string literal that merely mentions the directive — help text,
        an error message — neither suppresses anything nor trips the
        bad-suppression audit."""
        import io
        import tokenize

        out: Dict[int, Set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            line, col = tok.start
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(line, set()).update(rules)
            # a comment-only line suppresses the next source line too,
            # so long call lines don't have to exceed the column limit
            if self.lines[line - 1][:col].strip() == "":
                out.setdefault(line + 1, set()).update(rules)
        return out

    def suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line)
        if not rules:
            return False
        return finding.rule in rules or ALL_RULES in rules

    def all_suppression_names(self) -> Set[str]:
        names: Set[str] = set()
        for rules in self.suppressions.values():
            names.update(rules)
        return names

    # --------------------------------------------------------- helpers
    def code_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.relpath, line=line, col=col,
                       message=message, code=self.code_at(line))


class Checker:
    """Base class.  Subclasses set ``name``/``description`` and
    implement :meth:`check`; cross-module rules accumulate state there
    and emit from :meth:`finalize`.  One instance per lint run."""

    name: str = ""
    description: str = ""

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    if not cls.name:
        raise ValueError(f"checker {cls!r} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate checker name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def checker_names() -> List[str]:
    return sorted(_REGISTRY)


def make_checkers(names: Optional[Iterable[str]] = None) -> List[Checker]:
    if names is None:
        names = checker_names()
    out = []
    for n in names:
        if n not in _REGISTRY:
            raise KeyError(f"unknown swarmlint rule {n!r} "
                           f"(known: {', '.join(checker_names())})")
        out.append(_REGISTRY[n]())
    return out


# ------------------------------------------------------------ AST utilities

def annotate_parents(tree: ast.AST) -> None:
    """Attach ``_swarmlint_parent`` backlinks (idempotent)."""
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._swarmlint_parent = parent  # type: ignore[attr-defined]


def parent_of(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_swarmlint_parent", None)


class ImportMap:
    """Alias resolution for dotted-call matching: after ``import time as
    _time`` the call ``_time.monotonic()`` resolves to
    ``time.monotonic``; after ``from uuid import uuid4`` the bare
    ``uuid4()`` resolves to ``uuid.uuid4``.  Function-level imports are
    folded in too (module-wide scope — fine for linting)."""

    def __init__(self, tree: ast.AST):
        self.aliases: Dict[str, str] = {}     # local name -> module path
        self.from_names: Dict[str, str] = {}  # local name -> full dotted
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.from_names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain with the leading alias
        resolved, or None for non-trivial expressions."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        head = cur.id
        if parts:
            head = self.aliases.get(head, head)
        else:
            head = self.from_names.get(head, head)
        parts.append(head)
        return ".".join(reversed(parts))


def attr_tail(node: ast.AST) -> Optional[str]:
    """The final attribute of a call target (``x.y.fetch_group`` ->
    ``fetch_group``; bare ``fetch_group`` -> itself)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def has_epoch_argument(call: ast.Call) -> bool:
    """True when the call threads an epoch: an ``epoch=`` keyword, a
    ``**kwargs`` splat (forwarders), or a positional name mentioning
    epoch (rare, but honest)."""
    for kw in call.keywords:
        if kw.arg is None:          # **kwargs forward
            return True
        if kw.arg == "epoch":
            return True
    for a in call.args:
        if isinstance(a, ast.Name) and "epoch" in a.id:
            return True
        if isinstance(a, ast.Attribute) and "epoch" in a.attr:
            return True
    return False
