"""layering: the import-boundary matrix between packages.

The dependency discipline the tree grew into (and that keeps the device
path, the control plane, and the simulator separately testable):

* ``models`` and ``utils`` are the bottom: they import nothing above
  themselves (``utils`` may use ``models``);
* ``ops``/``parallel`` (the device path) never import the control plane
  (``manager``/``state``/``orchestrator``), the worker (``agent``), the
  I/O edge (``net``/``security``) or the simulator — device code sees
  only densified arrays and scheduler input structs;
* ``agent`` (worker side) never imports manager internals, control
  loops, or the device path — it talks to managers over the wire;
* ``sim`` drives the real control plane **in process** and touches
  production code only through the injected seams — it never imports
  the real I/O edge (``net``, ``security``);
* nothing in production imports ``sim`` — the simulator depends on the
  tree, never the reverse (the port's ``scripts/`` and ``probes/``,
  ``workload.py`` and ``chip_smoke.py`` are drivers and exempt);
* the port stands alone: no module of ``swarmkit_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax`` or the reference package
  ``swarmkit_tpu`` (only tests import both).

The matrix is enforced on every ``import``/``from-import`` (including
function-local ones), with relative imports resolved against the
importing module's package.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from ..core import Checker, Finding, ModuleInfo, register

PACKAGES = {"models", "utils", "ops", "parallel", "agent", "sim", "state",
            "scheduler", "orchestrator", "manager", "obs", "net",
            "security", "analysis", "scripts", "probes"}

#: importing package -> forbidden target packages
FORBIDDEN: Dict[str, Set[str]] = {
    "models": PACKAGES - {"models"},
    "utils": PACKAGES - {"utils", "models"},
    "ops": {"manager", "state", "orchestrator", "agent", "sim", "net",
            "security"},
    "parallel": {"manager", "state", "orchestrator", "agent", "sim",
                 "net", "security"},
    "agent": {"manager", "orchestrator", "scheduler", "ops", "parallel",
              "sim"},
    "sim": {"net", "security"},
    # the linter itself is pure stdlib-over-AST: it must never import the
    # tree it judges (no chicken-and-egg on a broken module)
    "analysis": PACKAGES - {"analysis"},
}

#: only the simulator (and external drivers) may import sim
SIM_IMPORTERS_EXEMPT = ("swarmkit_tpu_torch/scripts/",
                        "swarmkit_tpu_torch/probes/",
                        "swarmkit_tpu_torch/workload.py", "chip_smoke.py",
                        "tests/")

#: top-level modules no package of the port may import, and the paths
#: that rule holds for
FOREIGN = ("jax", "jaxlib", "swarmkit_tpu")
PORT_PATHS = ("swarmkit_tpu_torch/", "chip_smoke.py")


def _resolve_relative(mod: ModuleInfo, node: ast.ImportFrom) -> Optional[str]:
    parts = mod.module.split(".")
    if mod.relpath.endswith("/__init__.py"):
        parts = parts + ["__init__"]
    if node.level >= len(parts):
        return node.module
    base = parts[:-node.level]
    return ".".join(base + ([node.module] if node.module else []))


def _target_package(dotted: str) -> Optional[str]:
    """First swarmkit_tpu_torch-internal package segment of an import target,
    or None for stdlib/third-party/top-level modules."""
    parts = dotted.split(".")
    if parts[0] != "swarmkit_tpu_torch" or len(parts) < 2:
        return None
    return parts[1] if parts[1] in PACKAGES else None


@register
class Layering(Checker):
    name = "layering"
    description = ("import-boundary matrix: models/utils at the bottom, "
                   "device path free of control plane, agent free of "
                   "manager internals, sim in-process only, no jax")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        out: List[Finding] = []
        exempt_from_sim = any(mod.relpath.startswith(p)
                              for p in SIM_IMPORTERS_EXEMPT)
        forbidden = FORBIDDEN.get(mod.package, set())
        in_port = mod.relpath.startswith(PORT_PATHS)
        for node in ast.walk(mod.tree):
            targets: List[str] = []
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = _resolve_relative(mod, node)
                    if base is None:
                        continue
                    # `from .. import store` imports members too
                    targets = [base] + [f"{base}.{a.name}"
                                        for a in node.names]
                elif node.module:
                    # `from swarmkit_tpu_torch import sim` names the package in
                    # the imported MEMBERS, not in node.module — check
                    # both, or the from-form bypasses the whole matrix
                    targets = [node.module] + \
                        [f"{node.module}.{a.name}" for a in node.names
                         if a.name != "*"]
            else:
                continue
            foreign = [d for d in targets if d.split(".")[0] in FOREIGN]
            if in_port and foreign:
                out.append(mod.finding(
                    self.name, node,
                    f"{mod.package or 'top-level'} must not import "
                    f"{foreign[0]}: the port imports neither jax nor "
                    "swarmkit_tpu"))
            for dotted in targets:
                pkg = _target_package(dotted)
                if pkg is None:
                    continue
                if pkg == "sim" and mod.package != "sim" \
                        and not exempt_from_sim:
                    out.append(mod.finding(
                        self.name, node,
                        f"import of {dotted}: production code must "
                        "never depend on the simulator (sim sits on "
                        "top of the tree)"))
                elif pkg in forbidden and pkg != mod.package:
                    out.append(mod.finding(
                        self.name, node,
                        f"{mod.package or 'top-level'} must not import "
                        f"{pkg} ({dotted}): violates the layering "
                        "matrix (see docs/architecture.md, static "
                        "analysis section)"))
        return out
