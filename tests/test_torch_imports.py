"""The port stands alone: no module of ``swarmkit_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``swarmkit_tpu`` (each
module of the consensus layer, the security package and the manager's API
surfaces is also imported alone in a fresh interpreter), and the
planner's entry point defaults to the card."""

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
                     for name in CONSENSUS_MODULES):
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
    "swarmkit_tpu_torch.orchestrator", "swarmkit_tpu_torch.manager"] + [
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


def test_manager_exports_only_what_is_ported():
    """The port's ``manager`` package carries the task allocator and the
    API surfaces every raft member serves: it exports exactly their
    reference names, and no ``Manager``, dispatcher or CSI manager, which
    are not ported yet."""
    import swarmkit_tpu_torch.manager as manager
    assert manager.__all__ == [
        "Allocator", "Collector", "ControlAPI", "KeyManager", "LogBroker",
        "LogMessage", "LogSelector", "PortAllocator", "ResourceAPI",
        "WatchRequest", "WatchServer"]
    for name in ("Manager", "Dispatcher", "CSIManager"):
        assert not hasattr(manager, name)


@pytest.mark.parametrize("name", ORCHESTRATOR_MODULES[1:] + (
    "../manager/allocator", "../manager/netdriver"))
def test_orchestrator_modules_are_the_reference_text(name):
    """Each orchestrator module, the allocator and the network driver
    registry are the reference's text (their imports are relative, so the
    package name appears nowhere to change)."""
    port = ROOT / "swarmkit_tpu_torch" / "orchestrator" / f"{name}.py"
    ref = ROOT / "swarmkit_tpu" / "orchestrator" / f"{name}.py"
    assert port.resolve().read_text() == ref.resolve().read_text()
