"""The port's drivers that read the package, run as modules.

* ``python -m swarmkit_tpu_torch.scripts.swarmlint``: the reference's
  flags and exit codes over the port's roots (``--format json`` parses
  and is clean, ``--list-rules`` gives the reference's seven rule names,
  a rule subset with a path lints only that, ``--write-baseline`` keeps
  its justifications, a new finding exits 1);
* ``swarmkit_tpu_torch.scripts.train_scorer`` rebuilds the port's
  ``scheduler/learned_scorer.json`` byte for byte (the artifact both
  packages hold);
* ``swarmkit_tpu_torch.scripts.trace_report`` prints the reference
  script's phase tables, JSON, diff and ``--validate`` verdict for a
  Chrome trace that the port's tracer writes on the CPU; ``--device``
  and ``--critical-path`` exit 1 until the port writes bench artifacts.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from swarmkit_tpu_torch.analysis import checker_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "swarmkit_tpu_torch"


def _lint_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", f"{PORT}.scripts.swarmlint", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120)


def test_cli_json_is_clean():
    out = _lint_cli("--format", "json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["ok"] is True and payload["findings"] == []
    assert set(payload["rules"]) == set(checker_names())
    assert payload["modules"] > 100
    assert len(payload["baselined"]) >= 4


def test_cli_list_rules_gives_the_references_seven():
    out = _lint_cli("--list-rules")
    assert out.returncode == 0, out.stderr
    names = [line.split()[0] for line in out.stdout.splitlines() if line]
    from swarmkit_tpu.analysis import checker_names as ref_names
    assert names == ref_names() and len(names) == 7


def test_cli_rule_subset_and_paths():
    out = _lint_cli("--rules", "layering", "--baseline", "none", PORT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1 rule(s): ok" in out.stdout
    out = _lint_cli("--rules", "device-path-purity", "--format", "json",
                    f"{PORT}/ops/convert.py")
    payload = json.loads(out.stdout)
    assert out.returncode == 0 and payload["rules"] == ["device-path-purity"]
    assert payload["modules"] == 1
    assert {f["path"] for f in payload["baselined"]} == \
        {f"{PORT}/ops/convert.py"}


def test_cli_fails_on_a_new_finding():
    """A rule subset with no baseline over the fixtures exits 1, and an
    unknown rule is an error."""
    out = _lint_cli("--rules", "device-path-purity", "--baseline", "none",
                    "tests/fixtures/swarmlint_torch/device_bad.py")
    assert out.returncode == 0, "fixtures outside ops/ are out of scope"
    out = _lint_cli("--baseline", "none", PORT)
    assert out.returncode == 1
    assert "FAIL" in out.stdout and "determinism-seam" in out.stdout
    out = _lint_cli("--rules", "no-such-rule")
    assert out.returncode != 0 and "unknown swarmlint rule" in out.stderr


def test_cli_write_baseline_keeps_justifications(tmp_path):
    import shutil
    bl = tmp_path / "bl.json"
    shutil.copy(os.path.join(REPO, "swarmlint_torch_baseline.json"), bl)
    before = json.loads(bl.read_text())
    out = _lint_cli("--write-baseline", "--baseline", str(bl))
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(bl.read_text()) == before
    out = _lint_cli("--write-baseline", "--baseline", "none")
    assert out.returncode == 2


# ------------------------------------------------------------- the scorer

def test_trainer_rebuilds_the_ports_artifact(tmp_path):
    """The port's trainer writes the committed artifact byte for byte,
    the artifact the reference's trainer wrote for both packages."""
    from swarmkit_tpu_torch.scripts import train_scorer
    out = tmp_path / "artifact.json"
    assert train_scorer.main(["--out", str(out)]) == 0
    committed = os.path.join(REPO, PORT, "scheduler", "learned_scorer.json")
    with open(committed, "rb") as f:
        assert out.read_bytes() == f.read()
    with open(os.path.join(REPO, "swarmkit_tpu", "scheduler",
                           "learned_scorer.json"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_trainer_default_output_is_the_ports(monkeypatch, tmp_path):
    from swarmkit_tpu_torch.scripts import train_scorer
    written = []
    real_open = open

    def spy(path, mode="r", *a, **kw):
        if "w" in mode:
            written.append(path)
            return real_open(tmp_path / "x.json", mode, *a, **kw)
        return real_open(path, mode, *a, **kw)
    monkeypatch.setattr("builtins.open", spy)
    train_scorer.main(["--samples", "512"])
    assert written == [os.path.join(REPO, PORT, "scheduler",
                                    "learned_scorer.json")]


# ------------------------------------------------------- the trace report

def _reference_trace_report():
    spec = importlib.util.spec_from_file_location(
        "reference_trace_report",
        os.path.join(REPO, "scripts", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Two Chrome traces the port's tracer writes on the CPU: ticks of a
    small headline cluster and a small many-service cluster through
    ``TorchPlanner(device="cpu")``, each inside a ``bench.config`` marker
    span, and a second run of the first alone."""
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.obs import tracer
    from swarmkit_tpu_torch.ops import TorchPlanner
    root = tmp_path_factory.mktemp("traces")
    saved = tracer.save_state()
    paths = []
    try:
        for cells in ((("headline", workload.headline_cluster, 200, 2000),
                       ("cfg7", workload.many_service_cluster, 200, 2000)),
                      (("headline", workload.headline_cluster, 200, 1000),)):
            tracer.reset()
            tracer.enable()
            for cfg, build, n, t in cells:
                store = build(n, t)[0]
                with tracer.span("bench.config", "bench", cfg=cfg):
                    workload.one_tick(store, TorchPlanner(device="cpu"))
            path = root / f"trace{len(paths)}.json"
            tracer.dump(str(path))
            paths.append(str(path))
    finally:
        tracer.restore_state(saved)
    return paths


@pytest.mark.parametrize("args", [
    [], ["--json"], ["--validate"]], ids=["table", "json", "validate"])
def test_trace_report_equals_the_references(traces, args, capsys):
    from swarmkit_tpu_torch.scripts import trace_report
    ref = _reference_trace_report()
    assert ref.main([traces[0]] + args) == 0
    want = capsys.readouterr()
    assert trace_report.main([traces[0]] + args) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert got.out.strip()
    if not args:
        assert "=== headline ===" in got.out and "=== cfg7 ===" in got.out
        assert "plan.dispatch" in got.out and "sched.tick" in got.out
    if args == ["--validate"]:
        assert ": ok (" in got.out


def test_trace_report_diff_equals_the_references(traces, capsys):
    from swarmkit_tpu_torch.scripts import trace_report
    ref = _reference_trace_report()
    assert ref.main(["--diff"] + traces) == 0
    want = capsys.readouterr().out
    assert trace_report.main(["--diff"] + traces) == 0
    got = capsys.readouterr().out
    assert got == want and "configs only in A: cfg7" in got


def test_trace_report_validate_fails_like_the_reference(tmp_path, capsys):
    from swarmkit_tpu_torch.scripts import trace_report
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": 3}]}))
    ref = _reference_trace_report()
    assert ref.main([str(bad), "--validate"]) == 1
    want = capsys.readouterr()
    assert trace_report.main([str(bad), "--validate"]) == 1
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert "INVALID" in got.out


@pytest.mark.parametrize("flag,message", [
    ("--device", "artifact carries no device_telemetry"),
    ("--critical-path", "artifact carries no journey_attribution")])
def test_trace_report_bench_artifact_modes_wait_for_a_benchmark(
        tmp_path, capsys, flag, message):
    from swarmkit_tpu_torch.scripts import trace_report
    art = tmp_path / "art.json"
    art.write_text(json.dumps({"ok": True}))
    assert trace_report.main([flag, str(art)]) == 1
    assert message in capsys.readouterr().err


def test_trace_report_runs_as_a_module(traces):
    out = subprocess.run(
        [sys.executable, "-m", f"{PORT}.scripts.trace_report", traces[0],
         "--validate"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert out.returncode == 0 and ": ok (" in out.stdout, out.stderr
