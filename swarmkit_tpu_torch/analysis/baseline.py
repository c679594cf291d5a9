"""Committed-findings baseline: the grandfather list that may only shrink.

The baseline is a JSON file of findings that predate a rule (or are
justified permanent exceptions too broad for a per-line suppression).
Every entry MUST carry a one-line ``justification`` — an entry without
one is itself an error.  Matching is by (rule, path, stripped source
line), so entries survive line-number drift but die the moment the
offending code changes or disappears; a dead ("stale") entry is an
error too, which is what makes the baseline a ratchet: fixing a
violation forces the entry's removal, and new violations can never be
added without editing the committed file in review.  Matching is
count-aware: one entry absorbs exactly ONE occurrence, so pasting a
textually identical violation elsewhere in the same file surfaces as a
new finding instead of hiding behind the grandfathered line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .core import Finding


@dataclass
class BaselineEntry:
    rule: str
    path: str
    code: str
    justification: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.code)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "code": self.code,
                "justification": self.justification}


class Baseline:
    def __init__(self, entries: List[BaselineEntry]):
        self.entries = entries
        # key -> how many entries carry it (normally 1; a file with N
        # identical grandfathered lines commits N entries)
        self._budget: Dict[Tuple[str, str, str], int] = {}
        for e in entries:
            self._budget[e.key()] = self._budget.get(e.key(), 0) + 1

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return cls([])
        return cls([BaselineEntry(
            rule=e["rule"], path=e["path"], code=e["code"],
            justification=e.get("justification", ""))
            for e in raw.get("entries", [])])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"entries": [e.to_dict() for e in sorted(
                self.entries, key=lambda e: e.key())]}, f, indent=2,
                sort_keys=True)
            f.write("\n")

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
        """Partition findings into (new, grandfathered) and return the
        stale entries that matched nothing.  Count-aware: each entry
        absorbs at most one finding — an (N+1)-th occurrence of an
        N-entry key is a NEW finding, and an entry beyond the number of
        live occurrences is STALE."""
        used: Dict[Tuple[str, str, str], int] = {}
        new: List[Finding] = []
        old: List[Finding] = []
        for f in findings:
            key = f.key()
            if used.get(key, 0) < self._budget.get(key, 0):
                used[key] = used.get(key, 0) + 1
                old.append(f)
            else:
                new.append(f)
        stale: List[BaselineEntry] = []
        seen: Dict[Tuple[str, str, str], int] = {}
        for e in self.entries:
            seen[e.key()] = seen.get(e.key(), 0) + 1
            if seen[e.key()] > used.get(e.key(), 0):
                stale.append(e)
        return new, old, stale

    def unjustified(self) -> List[BaselineEntry]:
        """Entries with no real justification: empty, or the
        --write-baseline placeholder — a regenerated baseline must not
        pass the gate until a human writes each line."""
        return [e for e in self.entries
                if not e.justification.strip()
                or e.justification.strip().upper().startswith("TODO")]
