"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, the mix is ``traffic/<mix>.json`` and each metric is read
by ``metrics/<metric>.py``.  A later change adds a configuration, a mix,
a metric or a cell by adding such files and entries: nothing here lists
them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

#: the checkout's root: BENCHMARK.json and portbench/ sit in it
ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "portbench"


class Cell:
    """One entry of ``workloads`` with what it resolves to."""

    def __init__(self, root: Path, bench: dict, entry: dict):
        self.root = root
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.config_entry = next(c for c in bench["configs"]
                                 if c["name"] == entry["config"])
        self.config_path = root / self.config_entry["file"]
        self.traffic_path = root / PACKAGE / "traffic" / \
            f"{entry['traffic']}.json"
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (self.name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]

    def config(self) -> dict:
        return _load(self.config_path)

    def traffic(self) -> dict:
        return _load(self.traffic_path)

    def metrics(self, traced: bool) -> List[dict]:
        """The metrics a run reports: per-layer when traced, else
        end-to-end."""
        return self.per_layer if traced else self.end_to_end


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load(root)
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return Cell(Path(root), bench, entry)
    raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")


_READERS: Dict[str, Callable] = {}


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value from
    a run's record, or None where the run gives it nothing to read."""
    path = Path(root) / PACKAGE / "metrics" / f"{name}.py"
    key = str(path)
    fn = _READERS.get(key)
    if fn is None:
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_metric_{len(_READERS)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn = _READERS[key] = mod.read
    return fn


def read_metrics(cell: Cell, record, traced: bool
                 ) -> Dict[str, Dict[str, object]]:
    """Every metric of the run that its record gives a value for."""
    out = {}
    for m in cell.metrics(traced):
        value: Optional[float] = reader(m["name"], cell.root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
