"""BENCHMARK.json and the files it names: found by name, extensible by
new files alone, free of JAX, and refusing to run without a card."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench

ROOT = bench.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "swarmkit_tpu"}


def test_every_cell_and_metric_resolves_to_its_files():
    b = bench.load()
    names = [w["name"] for w in b["workloads"]]
    assert names and len(set(names)) == len(names)
    for name in names:
        cell = bench.cell(name)
        assert cell.config_path.is_file() and cell.traffic_path.is_file()
        cfg = cell.config()
        assert cfg["name"] == cell.config_entry["name"]
        assert cfg["control"] in ("preassigned", "constraints")
        assert cfg["test_size"]["nodes"] > 0 < cfg["test_size"]["tasks"]
        from portbench import harness
        assert callable(harness.reference_of(cfg))
        assert cell.chips == 1
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.reader(m["name"]))
        assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        reported = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in reported for m in cell.per_layer)
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= set(names)


def test_a_cell_and_a_metric_added_as_new_files_only(tmp_path):
    from conftest import ADDED, add_a_cell
    from portbench import harness
    before = {p.relative_to(ROOT): p.read_bytes()
              for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    add_a_cell(tmp_path)
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data

    cell = bench.cell(ADDED, root=tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["waves.tiny"]
    record, check, _ = harness.run_cell(cell, 7, 0.2, True, "cpu", 0.0)
    assert check["misplaced"] == 0 and check["placed"] > 0
    got = bench.read_metrics(cell, record, traced=True)
    assert got["waves.tiny"]["value"] == len(record.steps) >= 1
    got = bench.read_metrics(cell, record, traced=False)
    assert set(got) == {"decisions_per_s", "setup_s"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT) for p in (ROOT / "portbench").rglob("*.py")),
    ids=str)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & FORBIDDEN
    if path.parts[1] == "reference":
        assert "swarmkit_tpu_torch" not in tops


def test_the_top_level_names_are_compared_whole(monkeypatch):
    from portbench import harness
    for name in ("swarmkit_tpu_torch_probe", "jaxish", "swarmkit_tpu.probe"):
        monkeypatch.setitem(sys.modules, name, sys)
    bad = harness.forbidden_modules()
    assert "swarmkit_tpu.probe" in bad
    assert "swarmkit_tpu_torch_probe" not in bad and "jaxish" not in bad


def test_a_run_without_a_card_exits_non_zero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    name = bench.load()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
