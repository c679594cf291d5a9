"""determinism-seam: all time and randomness flows through the seams.

The deterministic simulator (``swarmkit_tpu_torch/sim``) replays the whole
control plane under a virtual clock and seeded id source; that only
works because production code reads wall-clock time through
``models.types.now()`` and mints randomness/ids through injected
``random.Random`` seams / ``utils.identity``.  This rule flags the
bypasses that silently break seed-reproducibility:

* ``time.time()`` / ``time.monotonic()`` calls — use
  ``models.types.now()`` (``time.perf_counter`` is allowed: it measures
  durations for metrics and never steers control flow);
* ``random.Random()`` with no seed, and module-level ``random.*``
  draws from the global unseeded RNG — inject a ``random.Random(seed)``
  (the ``rng or random.Random()`` constructor-default idiom for an
  injected seam parameter is allowed);
* ``uuid.uuid4()`` — use ``utils.identity.new_id()`` (routes through
  the sim's ``set_id_source`` seam);
* ``os.urandom()`` — use ``utils.identity.new_secret()`` unless the
  bytes are cryptographic key material (suppress with a justification
  in that case).

Whitelisted modules are the seams themselves, the virtual clock, the
real-subprocess executor (wall-clock health timers are its point),
crypto (``security/``), and host-side tooling (the port's ``scripts/``
and ``probes/``, ``workload.py`` and ``chip_smoke.py``) that measures
real time on purpose.

torch's global RNG is the port's third source of hidden state:

* ``torch.rand*`` / ``randn*`` / ``randint*`` / ``randperm`` /
  ``multinomial`` / ``normal`` / ``bernoulli`` / ``poisson`` with no
  ``generator=`` draw from it — pass a seeded ``torch.Generator``;
* ``torch.manual_seed`` / ``torch.seed`` (and the ``torch.cuda`` twins)
  reseed it for every caller in the process;
* a ``torch.Generator()`` that is never seeded (no ``.manual_seed`` on
  it anywhere in the module) starts from a default seed no caller
  chose.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..core import Checker, Finding, ImportMap, ModuleInfo, parent_of, \
    register

ALLOWED_PATHS = (
    "swarmkit_tpu_torch/models/types.py",    # defines the now() seam
    "swarmkit_tpu_torch/sim/clock.py",       # the virtual clock implementation
    "swarmkit_tpu_torch/utils/identity.py",  # the id seam (crypto source)
    "swarmkit_tpu_torch/agent/procexec.py",  # real subprocesses, real deadlines
    "swarmkit_tpu_torch/agent/testutils.py",
    "swarmkit_tpu_torch/security/",          # cert validity / key material are
                                       # real-world crypto by definition
    "swarmkit_tpu_torch/scripts/",
    "swarmkit_tpu_torch/probes/",
    "swarmkit_tpu_torch/workload.py",
    "chip_smoke.py",
)

_BANNED_CALLS = {
    "time.time":
        "bare wall-clock read; route through models.types.now() so the "
        "sim's virtual clock controls it",
    "time.monotonic":
        "bare monotonic read; route deadlines through models.types.now()"
        " (or take an injected clock seam)",
    "uuid.uuid4":
        "unseamed id; use utils.identity.new_id() (respects the sim's "
        "set_id_source seam)",
    "os.urandom":
        "unseamed entropy; use utils.identity.new_secret(), or suppress "
        "with a justification if this is cryptographic key material",
}

# module-level draws from the global, unseeded RNG
_RANDOM_GLOBAL_FNS = {"random", "randint", "uniform", "choice", "shuffle",
                      "randrange", "sample", "betavariate", "gauss"}

# numpy's global-RNG twins (ISSUE 15: the learned-scorer strategy made
# numpy arrays a production data path — weight loading must read the
# checked-in artifact, NEVER fall back to a random init; device kernels
# must not mint noise outside an injected seeded Generator)
_NUMPY_GLOBAL_FNS = {"rand", "randn", "randint", "random", "choice",
                     "shuffle", "permutation", "normal", "uniform",
                     "seed"}

# torch's global-RNG draws: legal only with an explicit generator=
_TORCH_RANDOM_FNS = {"rand", "rand_like", "randn", "randn_like", "randint",
                     "randint_like", "randperm", "multinomial", "normal",
                     "bernoulli", "poisson"}

# calls that (re)seed torch's process-wide generators
_TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                       "torch.random.manual_seed", "torch.random.seed",
                       "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                       "torch.cuda.seed", "torch.cuda.seed_all"}


def _seeded_generators(tree: ast.AST) -> set:
    """Source forms (``g``, ``self._gen``) that a ``.manual_seed(...)``
    call is made on anywhere in the module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "manual_seed":
            out.add(ast.unparse(node.func.value))
    return out


def _unseeded_generator(node: ast.Call, seeded: set) -> bool:
    """True for a ``torch.Generator(...)`` that is neither seeded in
    the same expression (``torch.Generator().manual_seed(s)``) nor bound
    to a name the module seeds later."""
    p = parent_of(node)
    if isinstance(p, ast.Attribute) and p.attr == "manual_seed":
        return False
    if isinstance(p, (ast.Assign, ast.AnnAssign)):
        targets = p.targets if isinstance(p, ast.Assign) else [p.target]
        return not any(ast.unparse(t) in seeded for t in targets)
    return True


def _is_or_default(node: ast.Call) -> bool:
    """True for the injected-seam constructor-default idiom
    ``self._rng = rng or random.Random()`` — the fallback only fires in
    production, where nondeterminism is the correct behavior."""
    p = parent_of(node)
    return isinstance(p, ast.BoolOp) and isinstance(p.op, ast.Or) \
        and p.values and p.values[-1] is node


@register
class DeterminismSeam(Checker):
    name = "determinism-seam"
    description = ("time/randomness/ids must flow through the injected "
                   "seams (models.types.now, utils.identity, rng params)")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if any(mod.relpath.startswith(p) for p in ALLOWED_PATHS):
            return ()
        imports = ImportMap(mod.tree)
        seeded = _seeded_generators(mod.tree)
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = imports.resolve(node.func)
            if dotted is None:
                continue
            if dotted in _BANNED_CALLS:
                out.append(mod.finding(
                    self.name, node, f"{dotted}(): {_BANNED_CALLS[dotted]}"))
            elif dotted == "random.Random" and not node.args \
                    and not node.keywords and not _is_or_default(node):
                out.append(mod.finding(
                    self.name, node,
                    "random.Random() with no seed: inject a seeded rng "
                    "(Agent(rng=...) style) or seed explicitly"))
            elif dotted.startswith("random.") \
                    and dotted.split(".", 1)[1] in _RANDOM_GLOBAL_FNS:
                out.append(mod.finding(
                    self.name, node,
                    f"{dotted}() draws from the global unseeded RNG; use "
                    "an injected random.Random(seed)"))
            elif dotted == "numpy.random.default_rng" and not node.args \
                    and not node.keywords:
                out.append(mod.finding(
                    self.name, node,
                    "numpy.random.default_rng() with no seed: pass an "
                    "explicit seed (learned-scorer weights load from the "
                    "checked-in artifact, never a random init)"))
            elif dotted.startswith("numpy.random.") \
                    and dotted.rsplit(".", 1)[1] in _NUMPY_GLOBAL_FNS:
                out.append(mod.finding(
                    self.name, node,
                    f"{dotted}() draws from numpy's global RNG; use a "
                    "seeded numpy.random.default_rng(seed) (and never "
                    "random-init scorer weights)"))
            elif dotted.startswith("torch.") \
                    and dotted.rsplit(".", 1)[1] in _TORCH_RANDOM_FNS \
                    and dotted.count(".") == 1 \
                    and not any(kw.arg in ("generator", None)
                                for kw in node.keywords):
                out.append(mod.finding(
                    self.name, node,
                    f"{dotted}() with no generator= draws from torch's "
                    "global RNG; pass a seeded torch.Generator"))
            elif dotted in _TORCH_GLOBAL_SEEDS:
                out.append(mod.finding(
                    self.name, node,
                    f"{dotted}() reseeds torch's process-wide RNG for "
                    "every caller; seed a torch.Generator of your own"))
            elif dotted == "torch.Generator" \
                    and _unseeded_generator(node, seeded):
                out.append(mod.finding(
                    self.name, node,
                    "torch.Generator() that is never seeded: call "
                    ".manual_seed(seed) on it (its default seed is no "
                    "caller's choice)"))
        return out
