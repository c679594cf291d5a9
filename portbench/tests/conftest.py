"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the checkout's root (the card's: ``-m gpu``).  Small clusters on the CPU,
through the same harness a run uses, with the planner's plain versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the cell that :func:`add_a_cell` adds, with its configuration, mix and
#: metric, as new files and entries only
ADDED = "tiny.waves"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


def add_a_cell(root: Path) -> None:
    """Copy the benchmark to ``root`` and add to it, as a later change
    would: a configuration, a traffic mix, a per-layer metric and the cell
    ``tiny.waves``, as new files and new entries of ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = json.loads((root / "portbench/configs/swarm10k.json").read_text())
    cfg.update(name="tiny", nodes=dict(cfg["nodes"], count=64),
               test_size={"nodes": 48, "tasks": 480})
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/tiny-waves.json").write_text(json.dumps(
        {"warmup_steps": 1, "step": {"report": True, "replace": [
            {"shape": "headline", "tasks": 640,
             "preassigned_share": 0.5}]}}))
    (root / "portbench/metrics/waves.tiny.py").write_text(
        "def read(rec):\n    return float(len(rec.steps))\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tiny",
                             file="portbench/configs/tiny.json"))
    b["workloads"].append(dict(name=ADDED, config="tiny",
                               traffic="tiny-waves", chips=1, why="t"))
    b["per_layer"].append(dict(
        name="waves.tiny", unit="waves", better="higher",
        source="host_clock", layer="t", moves="decisions_per_s",
        workloads=[ADDED]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture
def root_of(tmp_path):
    """``root_of(name)``: the checkout that holds cell ``name``: this one,
    or for :data:`ADDED` a copy with the cell added."""
    from portbench import bench

    def get(name: str) -> Path:
        if name != ADDED:
            return bench.ROOT
        if not (tmp_path / "BENCHMARK.json").exists():
            add_a_cell(tmp_path)
        return tmp_path
    return get


def small(name: str, root: Path):
    """(cell, configuration, mix) of ``name``, cut to the node and task
    counts of its configuration's ``test_size``."""
    from portbench import bench
    cell = bench.cell(name, root=root)
    cfg, mix = cell.config(), cell.traffic()
    size = cfg["test_size"]
    cfg["nodes"]["count"] = size["nodes"]
    for r in mix["step"].get("replace", []):
        r["tasks"] = size["tasks"]
    if mix.get("base"):
        mix["base"]["tasks"] = size["tasks"]
    return cell, cfg, mix


@pytest.fixture
def small_cell(root_of):
    """``small_cell(name)``: :func:`small` of the cell in its checkout."""
    return lambda name: small(name, root_of(name))
