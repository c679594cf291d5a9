"""The port's simulator and sweep drivers at their entry points.

- ``sim/clock.py``, ``engine.py``, ``faults.py``, ``invariants.py`` and
  ``cluster.py`` are the reference's text, byte for byte; ``scenario.py``,
  ``fuzz.py``, ``__init__.py``, ``__main__.py`` and the two sweep drivers
  (``scripts/chaos_sweep.py`` and ``scripts/failover_fuzz.py``, package
  modules here) differ from it only at the lines pinned below: the
  planner, the device, the module names in usage and replay lines, and
  the relative imports that take the place of the scripts' ``sys.path``
  insert.
- The device rule: ``run_scenario``, ``fuzz``, ``reproduce``, ``sweep``
  and the three command lines without a device mean the card, and raise
  (or exit non-zero) naming CUDA where there is none, before any ``Sim``
  is built, for host-only scenarios too; ``device="cpu"`` runs the plain
  versions.
- ``python -m swarmkit_tpu_torch.sim --seed 7 --scenario gang-deadlock
  --device cpu`` prints the reference's trace hash for that seed, and two
  ``--fuzz 2 --device cpu`` runs print the same bytes.
"""

import importlib
import json
import pathlib
import subprocess
import sys

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_dispatcher import singletons_left_as_found  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "swarmkit_tpu_torch"
#: the reference's text, byte for byte
COPIED = ("clock", "engine", "faults", "invariants", "cluster")
#: port file -> reference file
REFERENCE = {
    "sim/scenario": "swarmkit_tpu/sim/scenario.py",
    "sim/fuzz": "swarmkit_tpu/sim/fuzz.py",
    "sim/__init__": "swarmkit_tpu/sim/__init__.py",
    "sim/__main__": "swarmkit_tpu/sim/__main__.py",
    "scripts/chaos_sweep": "scripts/chaos_sweep.py",
    "scripts/failover_fuzz": "scripts/failover_fuzz.py",
}
#: the only lines each differs at: (removed, added)
PINNED = {
    'sim/scenario': (
        [
            '    from ..ops import TPUPlanner',
            '    planner = TPUPlanner()',
            '    from ..ops import TPUPlanner',
            '        planner = TPUPlanner()',
            '    from ..ops import TPUPlanner',
            '        planner = TPUPlanner()',
            'def _device_planner():',
            '    from ..ops import TPUPlanner',
            '    p = TPUPlanner()',
            '        cp.planner_factory = _device_planner',
            '        cp.planner_factory = _device_planner',
            '    cp.planner_factory = _device_planner    # device victim selection',
            '    cp.planner_factory = _device_planner    # quota mask on device',
            '    cp.planner_factory = _device_planner    # gang_fit on device',
            '#: scenarios the seed-rotating fuzzers (``python -m swarmkit_tpu.sim',
            '                 flightrec_dir: Optional[str] = None) -> SimReport:',
        ], [
            '    from ..ops import TorchPlanner',
            '    planner = TorchPlanner(device=sim.device)',
            '    from ..ops import TorchPlanner',
            '        planner = TorchPlanner(device=sim.device)',
            '    from ..ops import TorchPlanner',
            '        planner = TorchPlanner(device=sim.device)',
            'def _device_planner(device):',
            '    from ..ops import TorchPlanner',
            '    p = TorchPlanner(device=device)',
            '        cp.planner_factory = lambda: _device_planner(sim.device)',
            '        cp.planner_factory = lambda: _device_planner(sim.device)',
            '    cp.planner_factory = lambda: _device_planner(sim.device)    # device victim selection',
            '    cp.planner_factory = lambda: _device_planner(sim.device)    # quota mask on device',
            '    cp.planner_factory = lambda: _device_planner(sim.device)    # gang_fit on device',
            '#: scenarios the seed-rotating fuzzers (``python -m swarmkit_tpu_torch.sim',
            '                 flightrec_dir: Optional[str] = None,',
            '                 device=None) -> SimReport:',
            '    # where every planner of the run is built (None -> the card), resolved',
            "    # here, in the caller's thread and before the Sim exists, for every",
            "    # scenario: a planner built mid-run (a new leader's) would otherwise",
            '    # meet a missing card inside the chaos',
            '    from ..ops.convert import resolve_device',
            '    device = resolve_device(device)',
            '    sim.device = device',
        ]),
    'sim/fuzz': (
        [
            '(``python -m swarmkit_tpu.sim --seed N --scenario random-fuzz``).',
            '         progress=None) -> List[SimReport]:',
            '    (scenario, seed) pair reproducible from the report alone."""',
            '        report = run_scenario(name, seed)',
            '              expect_hash: Optional[str] = None) -> SimReport:',
            '    report = run_scenario(scenario, seed)',
        ], [
            '(``python -m swarmkit_tpu_torch.sim --seed N --scenario random-fuzz``).',
            '         progress=None, device=None) -> List[SimReport]:',
            '    (scenario, seed) pair reproducible from the report alone.',
            '    ``device`` goes to every run (None -> the card)."""',
            '        report = run_scenario(name, seed, device=device)',
            '              expect_hash: Optional[str] = None,',
            '              device=None) -> SimReport:',
            '    report = run_scenario(scenario, seed, device=device)',
        ]),
    'sim/__init__': (
        [
            '    python -m swarmkit_tpu.sim --seed 7 --scenario partition-churn',
            '    python -m swarmkit_tpu.sim --fuzz 50',
        ], [
            '    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn',
            '    python -m swarmkit_tpu_torch.sim --fuzz 50',
        ]),
    'sim/__main__': (
        [
            '    python -m swarmkit_tpu.sim --seed 7 --scenario partition-churn',
            '    python -m swarmkit_tpu.sim --seed 7 --scenario partition-churn --trace',
            '    python -m swarmkit_tpu.sim --fuzz 50 [--start-seed 100]',
            '    python -m swarmkit_tpu.sim --list',
            '    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu.sim")',
            '                       scenario=args.scenario, progress=progress)',
            '                 "reproduce": f"python -m swarmkit_tpu.sim --seed "',
            '                          keep_trace=args.trace)',
        ], [
            '    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn',
            '    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn --trace',
            '    python -m swarmkit_tpu_torch.sim --fuzz 50 [--start-seed 100]',
            '    python -m swarmkit_tpu_torch.sim --seed 7 --scenario gang-deadlock --device cpu',
            '    python -m swarmkit_tpu_torch.sim --list',
            '    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.sim")',
            '    p.add_argument("--device", default=None,',
            '                   help="where the scenarios\' planners run: the card "',
            '                        "(default) or \'cpu\' for the plain versions")',
            '                       scenario=args.scenario, progress=progress,',
            '                       device=args.device)',
            '                 "reproduce": f"python -m swarmkit_tpu_torch.sim --seed "',
            '                          keep_trace=args.trace, device=args.device)',
        ]),
    'scripts/chaos_sweep': (
        [
            '    python scripts/chaos_sweep.py                       # default suites',
            '    python scripts/chaos_sweep.py --fast                # CI subset',
            '    python scripts/chaos_sweep.py --fuzz 20             # seeds/scenario',
            '    python scripts/chaos_sweep.py --suite update',
            '    python scripts/chaos_sweep.py --scenario long-soak --fuzz 3',
            '    python scripts/chaos_sweep.py --list',
            'import os',
            'sys.path.insert(0, os.path.dirname(os.path.dirname(',
            '    os.path.abspath(__file__))))',
            '',
            'from swarmkit_tpu.sim.scenario import (          # noqa: E402',
            '#: "fuzz" suite is the same seed-rotating pool `python -m swarmkit_tpu.sim',
            '          progress=None, keep_trace: bool = True) -> list:',
            '    wide sweep does not hold every run\'s full log in memory."""',
            '            r = run_scenario(name, seed, keep_trace=keep_trace)',
            '             "reproduce": f"python -m swarmkit_tpu.sim --seed {r.seed} "',
            '    p = argparse.ArgumentParser(prog="scripts/chaos_sweep.py")',
            '                    progress=progress)',
            '                             progress=progress))',
        ], [
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep  # default suites',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --fast  # CI subset',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --fuzz 20  # seeds/scenario',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --suite update',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --scenario long-soak --fuzz 3',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --suite gang --device cpu',
            '    python -m swarmkit_tpu_torch.scripts.chaos_sweep --list',
            'from ..sim.scenario import (',
            '#: "fuzz" suite is the same seed-rotating pool `python -m swarmkit_tpu_torch.sim',
            '          progress=None, keep_trace: bool = True, device=None) -> list:',
            "    wide sweep does not hold every run's full log in memory.  ``device``",
            '    goes to every run (None -> the card)."""',
            '            r = run_scenario(name, seed, keep_trace=keep_trace,',
            '                             device=device)',
            '             "reproduce": f"python -m swarmkit_tpu_torch.sim --seed {r.seed} "',
            '    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.scripts.chaos_sweep")',
            '    p.add_argument("--device", default=None,',
            '                   help="where the scenarios\' planners run: the card "',
            '                        "(default) or \'cpu\' for the plain versions")',
            '                    progress=progress, device=args.device)',
            '                             progress=progress, device=args.device))',
        ]),
    'scripts/failover_fuzz': (
        [
            '    python scripts/failover_fuzz.py --fuzz 20',
            '    python scripts/failover_fuzz.py --fuzz 20 --scenario leader-crash-mid-tick',
            '    python scripts/failover_fuzz.py --list',
            'import os',
            'sys.path.insert(0, os.path.dirname(os.path.dirname(',
            '    os.path.abspath(__file__))))',
            '',
            'from swarmkit_tpu.sim.scenario import (          # noqa: E402',
            'from chaos_sweep import sweep                    # noqa: E402,F401',
            '    p = argparse.ArgumentParser(prog="scripts/failover_fuzz.py")',
            '                    progress=progress, keep_trace=False)',
            '             "reproduce": f"python -m swarmkit_tpu.sim --seed {r.seed} "',
        ], [
            '    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 20',
            '    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 20 --scenario leader-crash-mid-tick',
            '    python -m swarmkit_tpu_torch.scripts.failover_fuzz --fuzz 2 --device cpu',
            '    python -m swarmkit_tpu_torch.scripts.failover_fuzz --list',
            'from ..sim.scenario import (',
            'from .chaos_sweep import sweep',
            '    p = argparse.ArgumentParser(prog="python -m swarmkit_tpu_torch.scripts.failover_fuzz")',
            '    p.add_argument("--device", default=None,',
            '                   help="where the scenarios\' planners run: the card "',
            '                        "(default) or \'cpu\' for the plain versions")',
            '                    progress=progress, keep_trace=False,',
            '                    device=args.device)',
            '             "reproduce": f"python -m swarmkit_tpu_torch.sim --seed {r.seed} "',
        ]),
}
CLI_TIMEOUT = 300


def _diff(name):
    import difflib
    port = (PORT / f"{name}.py").read_text().splitlines()
    ref = (ROOT / REFERENCE[name]).read_text().splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(ref, port, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    return removed, added


@pytest.mark.parametrize("name", COPIED)
def test_sim_module_is_the_reference_text(name):
    assert (PORT / "sim" / f"{name}.py").read_bytes() == (
        ROOT / "swarmkit_tpu" / "sim" / f"{name}.py").read_bytes()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_module_differs_from_the_reference_only_at_its_pinned_lines(name):
    removed, added = PINNED[name]
    assert _diff(name) == (removed, added)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None means the card here")


@pytest.mark.parametrize("name", ["gang-deadlock", "partition-churn"])
def test_run_scenario_without_a_device_needs_the_card(name, monkeypatch):
    """Host-only scenarios too: the device is resolved before the ``Sim``
    (and its virtual clock) exists."""
    _no_card()
    from swarmkit_tpu_torch.sim import scenario
    built = []
    monkeypatch.setattr(scenario, "Sim",
                        lambda *a, **kw: built.append(a) or 1 / 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario.run_scenario(name, 7)
    with pytest.raises(ValueError):
        scenario.run_scenario(name, 7, device="meta")
    assert built == []


def test_fuzz_reproduce_and_sweep_without_a_device_need_the_card():
    _no_card()
    from swarmkit_tpu_torch.scripts.chaos_sweep import sweep
    fuzz_mod = importlib.import_module("swarmkit_tpu_torch.sim.fuzz")
    for call in (lambda: fuzz_mod.fuzz(1),
                 lambda: fuzz_mod.fuzz(1, scenario=None),
                 lambda: fuzz_mod.reproduce(3),
                 lambda: sweep(("gang-deadlock",), 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_device_reaches_every_run(monkeypatch):
    """``fuzz``, ``reproduce`` and ``sweep`` hand their device to every
    ``run_scenario`` call."""
    from swarmkit_tpu_torch.scripts import chaos_sweep
    fuzz_mod = importlib.import_module("swarmkit_tpu_torch.sim.fuzz")
    seen = []

    class Report:
        ok, trace_hash = True, "h"

    def probe(name, seed, **kw):
        seen.append((name, seed, kw.get("device")))
        return Report()

    monkeypatch.setattr(fuzz_mod, "run_scenario", probe)
    monkeypatch.setattr(chaos_sweep, "run_scenario", probe)
    fuzz_mod.fuzz(2, scenario=None, device="cpu")
    fuzz_mod.reproduce(4, expect_hash="h", device="cpu")
    chaos_sweep.sweep(("gang-deadlock",), 1, device="cpu")
    assert seen == [(fuzz_mod.pool_scenario(0), 0, "cpu"),
                    (fuzz_mod.pool_scenario(1), 1, "cpu"),
                    ("random-fuzz", 4, "cpu"), ("gang-deadlock", 0, "cpu")]


@pytest.mark.parametrize("module, argv", [
    ("sim.__main__", ["--scenario", "gang-deadlock"]),
    ("scripts.chaos_sweep", ["--scenario", "gang-deadlock", "--fuzz", "1"]),
    ("scripts.failover_fuzz", ["--scenario", "leader-crash-mid-tick",
                               "--fuzz", "1"])])
def test_command_line_without_a_device_needs_the_card(module, argv):
    """Each command line hands ``--device`` to ``run_scenario``: without
    one and without a card its first run raises naming CUDA;
    ``--device meta`` is refused everywhere."""
    main = importlib.import_module(f"swarmkit_tpu_torch.{module}").main
    with pytest.raises(ValueError):
        main(argv + ["--device", "meta"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def _run(args):
    return subprocess.run([sys.executable, "-m"] + args, cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)


def test_sim_command_line_prints_the_reference_trace_hash():
    from swarmkit_tpu.sim.scenario import run_scenario
    proc = _run(["swarmkit_tpu_torch.sim", "--seed", "7", "--scenario",
                 "gang-deadlock", "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] is True
    assert report["trace_hash"] == run_scenario("gang-deadlock",
                                                7).trace_hash
    if not torch.cuda.is_available():
        proc = _run(["swarmkit_tpu_torch.sim", "--seed", "7", "--scenario",
                     "gang-deadlock"])
        assert proc.returncode != 0
        assert "CUDA" in proc.stderr


def test_sim_fuzz_command_line_is_byte_identical():
    """Two ``--fuzz 2 --device cpu`` runs print the same bytes: the
    engine trace hashes and the span traces' shas, seed by seed."""
    args = ["swarmkit_tpu_torch.sim", "--fuzz", "2", "--device", "cpu"]
    first, second = _run(args), _run(args)
    assert first.returncode == 0, first.stdout + first.stderr
    assert second.returncode == 0, second.stdout + second.stderr
    assert first.stdout == second.stdout
    out = json.loads(first.stdout)
    assert out["ok"] is True and len(out["runs"]) == 2
    assert all(r["obs_trace_sha256"] for r in out["runs"])


def test_sim_list_needs_no_device():
    proc = _run(["swarmkit_tpu_torch.sim", "--list"])
    assert proc.returncode == 0, proc.stderr
    assert "gang-deadlock" in proc.stdout
