"""The port stands alone: no module of ``swarmkit_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``swarmkit_tpu`` (each
module of the consensus layer, the security package and the manager's API
surfaces is also imported alone in a fresh interpreter), the planner's
entry point defaults to the card, and the manager and agent modules are
the reference's text (``manager.py`` differs only where it builds a
``TorchPlanner``), as are ``net/``, ``template.py``, ``node.py`` and
``cli.py``; ``swarmd.py`` differs only at its device and ``rafttool.py``
only in its usage lines, and ``Swarmd()`` resolves its device in the
caller's thread.  The simulator (``sim/``) and its sweep drivers
(``scripts/``) are covered too, and so are the linter (``analysis/``) and
the three drivers that read the package (``scripts/swarmlint.py``,
``train_scorer.py``, ``trace_report.py``); each ``analysis/`` module but
``rules/device.py`` (written anew for PyTorch) differs from the
reference's, its package name aside, only at the lines pinned below."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "swarmkit_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "swarmkit_tpu")
ORCHESTRATOR_MODULES = ("__init__", "autoscaler", "common", "enforcers",
                        "global_", "jobs", "pipeline", "replicated",
                        "restart", "taskinit", "taskreaper", "update")
#: the consensus layer, the security package and the manager's API
#: surfaces (the reference's text; tests/test_torch_raft.py pins that)
CONSENSUS_MODULES = (
    "state.raft", "state.raft.core", "state.raft.node",
    "state.raft.storage", "state.raft.transport", "security",
    "security.ca", "security.tls", "security.external",
    "manager.watchapi", "manager.controlapi", "manager.resourceapi",
    "manager.logbroker", "manager.keymanager", "manager.rolemanager",
    "manager.metrics")
#: the manager's leader side, the node agent and the agent's remotes: the
#: reference's text, byte for byte
COPIED_MODULES = (
    "manager/__init__", "manager/drivers", "manager/deallocator",
    "manager/csi", "manager/dispatcher", "remotes", "agent/__init__",
    "agent/exec", "agent/storage", "agent/csivol", "agent/worker",
    "agent/agent", "agent/testutils", "agent/procexec")
#: the transport, the templates, the node and the operator CLI: the
#: reference's text, byte for byte
ENTRY_COPIED_MODULES = (
    "net/__init__", "net/wire", "net/raft_transport", "net/server",
    "net/client", "template", "node", "cli")
#: the simulator and its two sweep drivers (tests/test_torch_sim_entry.py
#: pins their text to the reference's)
SIM_MODULES = (
    "sim/__init__", "sim/__main__", "sim/clock", "sim/engine", "sim/faults",
    "sim/invariants", "sim/cluster", "sim/scenario", "sim/fuzz",
    "scripts/__init__", "scripts/chaos_sweep", "scripts/failover_fuzz")
#: the linter and the drivers that read the package
ANALYSIS_MODULES = (
    "analysis/__init__", "analysis/baseline", "analysis/core",
    "analysis/reporters", "analysis/runner", "analysis/rules/__init__",
    "analysis/rules/backpressure", "analysis/rules/determinism",
    "analysis/rules/device", "analysis/rules/fencing",
    "analysis/rules/layering", "analysis/rules/locking",
    "analysis/rules/metrics", "scripts/swarmlint", "scripts/train_scorer",
    "scripts/trace_report")


def _imported(path):
    """Absolute module names a file imports (relative imports stay inside
    its own package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("swarmkit_tpu_torch/ops/kernel.py",
                 "swarmkit_tpu_torch/ops/planner.py",
                 "swarmkit_tpu_torch/ops/convert.py",
                 "swarmkit_tpu_torch/ops/streaming.py",
                 "swarmkit_tpu_torch/ops/preempt.py",
                 "swarmkit_tpu_torch/parallel/__init__.py",
                 "swarmkit_tpu_torch/parallel/sharded.py",
                 "swarmkit_tpu_torch/utils/sampling.py",
                 "swarmkit_tpu_torch/scheduler/scheduler.py",
                 "swarmkit_tpu_torch/manager/__init__.py",
                 "swarmkit_tpu_torch/manager/allocator.py",
                 "swarmkit_tpu_torch/manager/netdriver.py",
                 "chip_smoke.py") + tuple(
                     f"swarmkit_tpu_torch/orchestrator/{name}.py"
                     for name in ORCHESTRATOR_MODULES) + tuple(
                     "swarmkit_tpu_torch/" + name.replace(".", "/")
                     + ("/__init__.py" if name in ("state.raft", "security")
                        else ".py")
                     for name in CONSENSUS_MODULES) + tuple(
                     f"swarmkit_tpu_torch/{name}.py"
                     for name in COPIED_MODULES + ENTRY_COPIED_MODULES
                     + SIM_MODULES + ANALYSIS_MODULES
                     + ("manager/manager", "swarmd", "rafttool")):
        assert must in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


@pytest.mark.parametrize("module", [
    "swarmkit_tpu_torch.ops.streaming", "swarmkit_tpu_torch.ops.planner",
    "swarmkit_tpu_torch.ops.preempt", "swarmkit_tpu_torch.parallel.sharded",
    "swarmkit_tpu_torch.workload", "swarmkit_tpu_torch.utils.sampling",
    "swarmkit_tpu_torch.orchestrator", "swarmkit_tpu_torch.manager",
    "swarmkit_tpu_torch.agent", "swarmkit_tpu_torch.remotes",
    "swarmkit_tpu_torch.net", "swarmkit_tpu_torch.template",
    "swarmkit_tpu_torch.node", "swarmkit_tpu_torch.cli",
    "swarmkit_tpu_torch.swarmd", "swarmkit_tpu_torch.rafttool",
    "swarmkit_tpu_torch.sim", "swarmkit_tpu_torch.sim.__main__",
    "swarmkit_tpu_torch.scripts.chaos_sweep",
    "swarmkit_tpu_torch.scripts.failover_fuzz",
    "swarmkit_tpu_torch.analysis", "swarmkit_tpu_torch.scripts.swarmlint",
    "swarmkit_tpu_torch.scripts.train_scorer",
    "swarmkit_tpu_torch.scripts.trace_report"] + [
        f"swarmkit_tpu_torch.{name}" for name in CONSENSUS_MODULES])
def test_import_loads_no_jax(module):
    """Importing a port module (and everything it imports) in a fresh
    interpreter loads neither jax nor the reference package."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_planner_defaults_to_cuda():
    from swarmkit_tpu_torch.ops import TorchPlanner
    if torch.cuda.is_available():
        assert TorchPlanner().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchPlanner()
    assert TorchPlanner(device="cpu").device.type == "cpu"


def test_mesh_planner_defaults_to_cuda():
    """``make_mesh()`` and ``TorchPlanner(mesh=...)`` run on the card
    unless the caller passes CPU devices."""
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.parallel import make_mesh
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert all(d.type == "cuda" for d in mesh.devices)
        assert TorchPlanner(mesh=mesh).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    cpu = make_mesh(["cpu"] * 2)
    planner = TorchPlanner(mesh=cpu)
    assert planner.device.type == "cpu" and planner.mesh is cpu


def test_wrappers_refuse_other_devices():
    from swarmkit_tpu_torch.ops import kernel
    with pytest.raises(ValueError):
        kernel._on_cuda(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("helper", ["to_device", "fused_to_device"])
def test_device_helpers_default_to_cuda(helper):
    """``to_device`` and ``fused_to_device`` called without a device put
    their tensors on the card, or raise where there is none: never CPU
    tensors unless the caller asks for the CPU."""
    import numpy as np
    from swarmkit_tpu_torch.ops import convert
    from swarmkit_tpu_torch.ops.kernel import (
        FusedCarry, FusedGroups, FusedShared, GroupInputs, NodeInputs)

    def arrays(cls):
        return cls(**{name: np.zeros(4, np.int32) for name in cls._fields})

    if helper == "to_device":
        args = (arrays(NodeInputs), arrays(GroupInputs))
    else:
        args = (arrays(FusedShared), arrays(FusedGroups), arrays(FusedCarry))
    fn = getattr(convert, helper)
    if torch.cuda.is_available():
        tensors = [t for part in fn(*args)[:2] for t in part]
        assert all(t.device.type == "cuda" for t in tensors)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
    tensors = [t for part in fn(*args, device="cpu")[:2] for t in part]
    assert all(t.device.type == "cpu" for t in tensors)


def _reference_all(path):
    """``__all__`` of a reference module, read from its text: the
    reference's manager package does not import on every jax."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_manager_exports_only_what_is_ported():
    """The port's ``manager`` package exports exactly the reference's
    names, ``Manager``, the dispatcher and the CSI manager included."""
    import swarmkit_tpu_torch.manager as manager
    assert manager.__all__ == _reference_all(
        ROOT / "swarmkit_tpu" / "manager" / "__init__.py")
    for name in manager.__all__:
        assert hasattr(manager, name)
    import swarmkit_tpu_torch.agent as agent
    assert agent.__all__ == _reference_all(
        ROOT / "swarmkit_tpu" / "agent" / "__init__.py")


@pytest.mark.parametrize("name", COPIED_MODULES)
def test_manager_and_agent_modules_are_the_reference_text(name):
    """The dispatcher, the CSI controller, the deallocator, the driver
    provider, the remotes and every agent module are the reference's
    text (their imports are relative)."""
    port = ROOT / "swarmkit_tpu_torch" / f"{name}.py"
    ref = ROOT / "swarmkit_tpu" / f"{name}.py"
    assert port.read_text() == ref.read_text()


#: the only lines of ``manager/manager.py`` that differ from the
#: reference's: the planner's import, the ``device`` argument (kept and
#: resolved in the caller's thread) and the planner the leader builds
MANAGER_DIFF_REMOVED = [
    "from ..ops import TPUPlanner",
    "                 scheduler_pipeline_depth: Optional[int] = None):",
    '        escape hatch)."""',
    "            planner = TPUPlanner() if self.use_device_scheduler else None",
]
MANAGER_DIFF_ADDED = [
    "from ..ops import TorchPlanner",
    "                 scheduler_pipeline_depth: Optional[int] = None,",
    "                 device=None):",
    "        escape hatch).",
    "        ``device``: where the leader's ``TorchPlanner`` runs (None -> the",
    "        card).  It is resolved here, in the caller's thread: leadership",
    "        builds the planner on the leadership worker, which logs a failure",
    "        and goes on, so a missing card would otherwise leave a manager",
    '        running with no scheduler and no loops."""',
    "        self.device = device",
    "        if use_device_scheduler:",
    "            from ..ops.convert import resolve_device",
    "            resolve_device(device)",
    "            planner = (TorchPlanner(device=self.device)",
    "                       if self.use_device_scheduler else None)",
]


def test_manager_differs_from_the_reference_only_at_the_planner():
    import difflib
    port = (ROOT / "swarmkit_tpu_torch" / "manager" / "manager.py"
            ).read_text().splitlines()
    ref = (ROOT / "swarmkit_tpu" / "manager" / "manager.py"
           ).read_text().splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(ref, port, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    assert removed == MANAGER_DIFF_REMOVED
    assert added == MANAGER_DIFF_ADDED


@pytest.mark.parametrize("name", ORCHESTRATOR_MODULES[1:] + (
    "../manager/allocator", "../manager/netdriver"))
def test_orchestrator_modules_are_the_reference_text(name):
    """Each orchestrator module, the allocator and the network driver
    registry are the reference's text (their imports are relative, so the
    package name appears nowhere to change)."""
    port = ROOT / "swarmkit_tpu_torch" / "orchestrator" / f"{name}.py"
    ref = ROOT / "swarmkit_tpu" / "orchestrator" / f"{name}.py"
    assert port.resolve().read_text() == ref.resolve().read_text()


@pytest.mark.parametrize("name", ENTRY_COPIED_MODULES)
def test_entry_modules_are_the_reference_text(name):
    """``net/``, ``template.py``, ``node.py`` and ``cli.py`` are the
    reference's text (their imports are relative; ``cli.main``'s
    ``Manager()`` is the port's, so it schedules on the card)."""
    port = ROOT / "swarmkit_tpu_torch" / f"{name}.py"
    ref = ROOT / "swarmkit_tpu" / f"{name}.py"
    assert port.read_text() == ref.read_text()


def _diff(name):
    import difflib
    port = (ROOT / "swarmkit_tpu_torch" / f"{name}.py"
            ).read_text().splitlines()
    ref = (ROOT / "swarmkit_tpu" / f"{name}.py").read_text().splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(ref, port, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    return removed, added


#: the only lines of ``swarmd.py`` that differ from the reference's: the
#: module docstring's three commands, the ``device`` keyword (kept,
#: resolved in the caller's thread, passed to every ``Manager`` the
#: daemon builds) and ``main()``'s ``--device`` option
SWARMD_DIFF_REMOVED = [
    "    python -m swarmkit_tpu.swarmd --manager --state-dir /tmp/m0 \\",
    "    python -m swarmkit_tpu.swarmd --state-dir /tmp/w0 \\",
    "    python -m swarmkit_tpu.swarmd --manager --state-dir /tmp/m1 \\",
    "                 clock=None, rng: Optional[random.Random] = None):",
    "            use_device_scheduler=self.use_device_scheduler)",
    "        if args.listen_metrics else None)",
]
SWARMD_DIFF_ADDED = [
    "    python -m swarmkit_tpu_torch.swarmd --manager --state-dir /tmp/m0 \\",
    "    python -m swarmkit_tpu_torch.swarmd --state-dir /tmp/w0 \\",
    "    python -m swarmkit_tpu_torch.swarmd --manager --state-dir /tmp/m1 \\",
    "                 clock=None, rng: Optional[random.Random] = None,",
    "                 device=None):",
    "        # where every Manager this daemon builds runs its leader's",
    "        # TorchPlanner (None -> the card).  Resolved here, in the caller's",
    "        # thread: a runtime promotion builds its Manager on the role",
    "        # watcher, which logs a failure and retries forever",
    "        self.device = device",
    "        if use_device_scheduler:",
    "            from .ops.convert import resolve_device",
    "            resolve_device(device)",
    "            use_device_scheduler=self.use_device_scheduler,",
    "            device=self.device)",
    '    parser.add_argument("--device", default=None,',
    """                        help="where the leader's scheduler runs: the card \"""",
    """                             "(default) or 'cpu' for the plain versions")""",
    "        if args.listen_metrics else None,",
    "        device=args.device)",
]
#: ``rafttool.py`` differs only in its docstring's six usage lines
RAFTTOOL_VERBS = ("dump-wal <state-dir> [unlock-key]",
                  "dump-snapshot <state-dir> [unlock-key]",
                  "dump-object <state-dir> <collection>",
                  "decrypt <state-dir> <out-dir> [key]",
                  "downgrade-key <state-dir> <unlock-key>",
                  "renew-certs <state-dir> [unlock-key]")


def test_swarmd_differs_from_the_reference_only_at_the_device():
    assert _diff("swarmd") == (SWARMD_DIFF_REMOVED, SWARMD_DIFF_ADDED)


def test_rafttool_differs_from_the_reference_only_in_its_usage():
    assert _diff("rafttool") == (
        [f"    python -m swarmkit_tpu.rafttool {v}" for v in RAFTTOOL_VERBS],
        [f"    python -m swarmkit_tpu_torch.rafttool {v}"
         for v in RAFTTOOL_VERBS])


def test_swarmd_resolves_its_device_in_the_callers_thread(tmp_path):
    """``Swarmd()`` with the device scheduler on and no device means the
    card: it raises at construction where there is none (a promotion on
    the role watcher would swallow the error and retry forever), and
    ``device="cpu"`` or the host path construct anywhere.  Every
    ``Manager`` the daemon builds gets the same device."""
    from swarmkit_tpu_torch.swarmd import Swarmd
    if torch.cuda.is_available():
        assert Swarmd(str(tmp_path)).device is None
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Swarmd(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            Swarmd(str(tmp_path), manager=True, executor="test")
    assert Swarmd(str(tmp_path), device="cpu").device == "cpu"
    assert Swarmd(str(tmp_path), use_device_scheduler=False).device is None
    with pytest.raises(ValueError):
        Swarmd(str(tmp_path), device="meta")


def test_swarmd_main_takes_a_device(monkeypatch, tmp_path):
    """``python -m swarmkit_tpu_torch.swarmd --device cpu`` builds its
    daemon with ``device="cpu"``; without ``--device`` the daemon gets
    None, the card."""
    from swarmkit_tpu_torch import swarmd
    seen = []

    class Stop(Exception):
        pass

    class Probe:
        def __init__(self, **kw):
            seen.append(kw)

        def start(self):
            raise Stop

        def stop(self):
            pass

    monkeypatch.setattr(swarmd, "Swarmd", Probe)
    monkeypatch.setattr(swarmd.logging, "basicConfig", lambda **kw: None)
    for argv, want in ((["--device", "cpu"], "cpu"), ([], None)):
        with pytest.raises(Stop):
            swarmd.main(["--state-dir", str(tmp_path), "--manager"] + argv)
        assert seen[-1]["device"] == want
        assert seen[-1]["use_device_scheduler"] is True



def test_analysis_imports_no_torch():
    """The linter is stdlib over the AST: importing it (and every rule)
    in a fresh interpreter loads neither torch nor numpy."""
    code = ("import sys, swarmkit_tpu_torch.analysis\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'swarmkit_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


#: the only lines of each ``analysis/`` module that differ from the
#: reference's once its package name is the port's: (removed, added).
#: ``rules/device.py`` is written anew for PyTorch; the modules absent here
#: are the reference's text but for the package name
ANALYSIS_PINNED = {
    '__init__': (
        [
            '``python scripts/swarmlint.py``; the framework lives in',
        ],
        [
            '``python -m swarmkit_tpu_torch.scripts.swarmlint``; the framework lives in',
        ],
    ),
    'core': (
        [
            '        # modules like swarmd.py, and for scripts/ / bench.py); computed',
        ],
        [
            '        # modules like swarmd.py, and for chip_smoke.py); computed',
        ],
    ),
    'rules/backpressure': (
        [
            'HOT_ROOTS = ("swarmkit_tpu_torch/manager/", "swarmkit_tpu_torch/scheduler/")',
        ],
        [
            'HOT_ROOTS = ("swarmkit_tpu_torch/manager/",',
            '             "swarmkit_tpu_torch/scheduler/")',
        ],
    ),
    'rules/determinism': (
        [
            'crypto (``security/``), and host-side tooling (``scripts/``,',
            '``bench.py``) that measures real time on purpose.',
            '    "scripts/",',
            '    "bench.py",',
        ],
        [
            "crypto (``security/``), and host-side tooling (the port's ``scripts/``",
            'and ``probes/``, ``workload.py`` and ``chip_smoke.py``) that measures',
            'real time on purpose.',
            '',
            "torch's global RNG is the port's third source of hidden state:",
            '',
            '* ``torch.rand*`` / ``randn*`` / ``randint*`` / ``randperm`` /',
            '  ``multinomial`` / ``normal`` / ``bernoulli`` / ``poisson`` with no',
            '  ``generator=`` draw from it — pass a seeded ``torch.Generator``;',
            '* ``torch.manual_seed`` / ``torch.seed`` (and the ``torch.cuda`` twins)',
            '  reseed it for every caller in the process;',
            '* a ``torch.Generator()`` that is never seeded (no ``.manual_seed`` on',
            '  it anywhere in the module) starts from a default seed no caller',
            '  chose.',
            '    "swarmkit_tpu_torch/scripts/",',
            '    "swarmkit_tpu_torch/probes/",',
            '    "swarmkit_tpu_torch/workload.py",',
            '    "chip_smoke.py",',
            "# torch's global-RNG draws: legal only with an explicit generator=",
            '_TORCH_RANDOM_FNS = {"rand", "rand_like", "randn", "randn_like", "randint",',
            '                     "randint_like", "randperm", "multinomial", "normal",',
            '                     "bernoulli", "poisson"}',
            '',
            "# calls that (re)seed torch's process-wide generators",
            '_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",',
            '                       "torch.random.manual_seed", "torch.random.seed",',
            '                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",',
            '                       "torch.cuda.seed", "torch.cuda.seed_all"}',
            '',
            '',
            'def _seeded_generators(tree: ast.AST) -> set:',
            '    """Source forms (``g``, ``self._gen``) that a ``.manual_seed(...)``',
            '    call is made on anywhere in the module."""',
            '    out = set()',
            '    for node in ast.walk(tree):',
            '        if isinstance(node, ast.Call) \\',
            '                and isinstance(node.func, ast.Attribute) \\',
            '                and node.func.attr == "manual_seed":',
            '            out.add(ast.unparse(node.func.value))',
            '    return out',
            '',
            '',
            'def _unseeded_generator(node: ast.Call, seeded: set) -> bool:',
            '    """True for a ``torch.Generator(...)`` that is neither seeded in',
            '    the same expression (``torch.Generator().manual_seed(s)``) nor bound',
            '    to a name the module seeds later."""',
            '    p = parent_of(node)',
            '    if isinstance(p, ast.Attribute) and p.attr == "manual_seed":',
            '        return False',
            '    if isinstance(p, (ast.Assign, ast.AnnAssign)):',
            '        targets = p.targets if isinstance(p, ast.Assign) else [p.target]',
            '        return not any(ast.unparse(t) in seeded for t in targets)',
            '    return True',
            '',
            '        seeded = _seeded_generators(mod.tree)',
            '            elif dotted.startswith("torch.") \\',
            '                    and dotted.rsplit(".", 1)[1] in _TORCH_RANDOM_FNS \\',
            '                    and dotted.count(".") == 1 \\',
            '                    and not any(kw.arg in ("generator", None)',
            '                                for kw in node.keywords):',
            '                out.append(mod.finding(',
            '                    self.name, node,',
            '                    f"{dotted}() with no generator= draws from torch\'s "',
            '                    "global RNG; pass a seeded torch.Generator"))',
            '            elif dotted in _TORCH_GLOBAL_SEEDS:',
            '                out.append(mod.finding(',
            '                    self.name, node,',
            '                    f"{dotted}() reseeds torch\'s process-wide RNG for "',
            '                    "every caller; seed a torch.Generator of your own"))',
            '            elif dotted == "torch.Generator" \\',
            '                    and _unseeded_generator(node, seeded):',
            '                out.append(mod.finding(',
            '                    self.name, node,',
            '                    "torch.Generator() that is never seeded: call "',
            '                    ".manual_seed(seed) on it (its default seed is no "',
            '                    "caller\'s choice)"))',
        ],
    ),
    'rules/layering': (
        [
            '  tree, never the reverse (``scripts/`` and ``bench.py`` are drivers',
            '  and exempt).',
            '            "security", "analysis"}',
            'SIM_IMPORTERS_EXEMPT = ("scripts/", "bench.py", "tests/")',
            '                   "manager internals, sim in-process only")',
        ],
        [
            "  tree, never the reverse (the port's ``scripts/`` and ``probes/``,",
            '  ``workload.py`` and ``chip_smoke.py`` are drivers and exempt);',
            '* the port stands alone: no module of ``swarmkit_tpu_torch`` and not',
            '  ``chip_smoke.py`` imports ``jax`` or the reference package',
            '  ``swarmkit_tpu`` (only tests import both).',
            '            "security", "analysis", "scripts", "probes"}',
            'SIM_IMPORTERS_EXEMPT = ("swarmkit_tpu_torch/scripts/",',
            '                        "swarmkit_tpu_torch/probes/",',
            '                        "swarmkit_tpu_torch/workload.py", "chip_smoke.py",',
            '                        "tests/")',
            '',
            '#: top-level modules no package of the port may import, and the paths',
            '#: that rule holds for',
            'FOREIGN = ("jax", "jaxlib", "swarmkit_tpu")',
            'PORT_PATHS = ("swarmkit_tpu_torch/", "chip_smoke.py")',
            '                   "manager internals, sim in-process only, no jax")',
            '        in_port = mod.relpath.startswith(PORT_PATHS)',
            '            foreign = [d for d in targets if d.split(".")[0] in FOREIGN]',
            '            if in_port and foreign:',
            '                out.append(mod.finding(',
            '                    self.name, node,',
            '                    f"{mod.package or \'top-level\'} must not import "',
            '                    f"{foreign[0]}: the port imports neither jax nor "',
            '                    "swarmkit_tpu"))',
        ],
    ),
    'rules/locking': (
        [
            '  ``jax.device_get``, ``block_until_ready``, sleeps) under it would',
            '  couple XLA latency into every writer, and is flagged.',
        ],
        [
            '  ``jax.device_get``, ``block_until_ready``, sleeps; in the port any',
            '  ``.synchronize()`` and ``finish_fetch``) under it would couple device',
            '  latency into every writer, and is flagged.',
            "        # the port's device syncs: torch.cuda / an event / a stream",
            "        # .synchronize() and the fetch stage's wait",
            '        "synchronize", "finish_fetch",',
            '        "synchronize", "finish_fetch",',
        ],
    ),
    'runner': (
        [
            '#: what `scripts/swarmlint.py` (and the tier-1 test) lints by default',
            'DEFAULT_ROOTS = ("swarmkit_tpu_torch", "scripts", "bench.py")',
            'DEFAULT_BASELINE = "swarmlint_baseline.json"',
            '',
            '_SKIP_DIRS = {"__pycache__", ".git", "native", "build"}',
            "            # normalize ('./bench.py', absolute paths) to the canonical",
        ],
        [
            '#: what `python -m swarmkit_tpu_torch.scripts.swarmlint` (and the tier-1',
            '#: test) lints by default',
            'DEFAULT_ROOTS = ("swarmkit_tpu_torch", "chip_smoke.py")',
            'DEFAULT_BASELINE = "swarmlint_torch_baseline.json"',
            '',
            '_SKIP_DIRS = {"__pycache__", ".git", "native", "build", "_build"}',
            "            # normalize ('./chip_smoke.py', absolute paths) to the canonical",
        ],
    ),
}


def _analysis_diff(name):
    import difflib
    import re
    port = (ROOT / "swarmkit_tpu_torch" / "analysis" / f"{name}.py"
            ).read_text().splitlines()
    ref = re.sub(r"\bswarmkit_tpu\b", "swarmkit_tpu_torch",
                 (ROOT / "swarmkit_tpu" / "analysis" / f"{name}.py"
                  ).read_text()).splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(ref, port, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    return removed, added


@pytest.mark.parametrize("name", [
    m[len("analysis/"):] for m in ANALYSIS_MODULES
    if m.startswith("analysis/") and m != "analysis/rules/device"])
def test_analysis_differs_from_the_reference_only_at_its_pinned_lines(name):
    assert _analysis_diff(name) == ANALYSIS_PINNED.get(name, ([], []))
