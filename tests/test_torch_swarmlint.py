"""The port's linter (``swarmkit_tpu_torch/analysis``) lints the port.

* **fixtures** — every rule fires on its bad fixture
  (``tests/fixtures/swarmlint_torch/``), meets its floor and is silent on
  its good twin; the device rule, written anew for PyTorch, shows every
  shape it flags;
* **parity with the reference** — the six rules the port shares with the
  reference give the reference's findings on the reference's own
  fixtures (the package name rewritten in the text and the path), the
  layering rule adding only the port's house rule (no ``jax``, no
  ``swarmkit_tpu``); and on every port module that is the reference's
  text byte for byte, the port's linter gives the reference's findings
  line for line, before the baseline;
* **the tree** — the port's tree is clean against its own shrink-only
  baseline (``swarmlint_torch_baseline.json``), which carries the
  reference's four ``state/store.py`` entries with their justifications;
  the rest mirrors ``tests/test_swarmlint.py``'s tree, ratchet and
  suppression tests.
"""

import json
import os
import re

import pytest

from swarmkit_tpu_torch.analysis import (
    Baseline, BaselineEntry, DEFAULT_BASELINE, DEFAULT_ROOTS, ModuleInfo,
    checker_names, lint_tree, make_checkers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "swarmlint_torch")
REF_FIXDIR = os.path.join(REPO, "tests", "fixtures", "swarmlint")
PORT = "swarmkit_tpu_torch"

# The baseline RATCHET: this number may only go DOWN (to the new entry
# count) when a grandfathered finding is fixed.
MAX_BASELINE_ENTRIES = 16

#: rule -> (fixture stem, relpath the harness lints it as)
FIXTURES = {
    "determinism-seam": ("determinism", f"{PORT}/state/fixture.py"),
    "epoch-fencing": ("fencing", f"{PORT}/manager/fixture.py"),
    "lock-discipline": ("locking", f"{PORT}/state/fixture.py"),
    "layering": ("layering", f"{PORT}/ops/fixture.py"),
    "device-path-purity": ("device", f"{PORT}/ops/fixture.py"),
    "metric-hygiene": ("metrics", f"{PORT}/obs/fixture.py"),
    "backpressure-discipline": ("backpressure",
                                f"{PORT}/manager/fixture.py"),
}
#: the rules whose text the port shares with the reference
SHARED = sorted(set(FIXTURES) - {"device-path-purity"})

#: what each shape of the device rule says, one key a shape
DEVICE_SHAPES = (
    ".item()", ".tolist()", ".cpu()", ".numpy()", "int() of",
    "float() of", "bool() of", ".synchronize()", "blocking copy .to(",
    "blocking copy .cuda(", "blocking .copy_()", "nonzero()",
    "boolean-mask indexing", "unique()", "masked_select()",
    "Python control flow on a tensor", "print of a non-literal",
    "CUDA_LAUNCH_BLOCKING", "set_sync_debug_mode", "inside plain version",
    "unaccounted transfer: .to()", "unaccounted transfer: .cuda()",
    "unaccounted transfer: .copy_()", "staging buffer",
    "pinned result", "mid-chunk D2H", "re-upload of already-resident")

_PKG_RE = re.compile(r"\bswarmkit_tpu\b")


def to_port(text):
    """The reference's package name rewritten to the port's."""
    return _PKG_RE.sub(PORT, text)


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _findings(make, rule, source, relpath, module_info=ModuleInfo):
    checker = make([rule])[0]
    mod = module_info.from_source(source, relpath)
    found = list(checker.check(mod)) + list(checker.finalize())
    return [f for f in found if not mod.suppressed(f)]


def _run_rule(rule, kind):
    stem, relpath = FIXTURES[rule]
    source = _read(os.path.join(FIXDIR, f"{stem}_{kind}.py"))
    return _findings(make_checkers, rule, source, relpath)


def test_every_rule_has_a_fixture_pair():
    assert set(FIXTURES) == set(checker_names())
    for stem, _ in FIXTURES.values():
        for kind in ("bad", "good"):
            assert os.path.exists(os.path.join(FIXDIR, f"{stem}_{kind}.py"))


def test_the_port_has_the_references_seven_rules():
    from swarmkit_tpu.analysis import checker_names as ref_names
    assert checker_names() == ref_names()


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_bad_fixture(rule):
    findings = _run_rule(rule, "bad")
    assert findings, f"{rule} did not fire on its bad fixture"
    assert all(f.rule == rule for f in findings)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_passes_clean_twin(rule):
    findings = _run_rule(rule, "good")
    assert not findings, "\n".join(f.render() for f in findings)


# the reference's floors plus the port's own shapes in each bad fixture
@pytest.mark.parametrize("rule,min_findings", [
    ("determinism-seam", 14),  # the reference's 10 + torch.manual_seed, an
    #                            unseeded torch.Generator(), torch.rand and
    #                            torch.randperm without generator=
    ("epoch-fencing", 4),
    ("lock-discipline", 7),    # the reference's 5 + torch.cuda.synchronize
    #                            under the view lock, finish_fetch under
    #                            the writer lock
    ("layering", 6),           # the reference's 4 + an import of jax and
    #                            one of the reference package
    ("device-path-purity", 20),
    ("metric-hygiene", 7),
    ("backpressure-discipline", 4),
])
def test_rule_sensitivity_floor(rule, min_findings):
    findings = _run_rule(rule, "bad")
    assert len(findings) >= min_findings, \
        "\n".join(f.render() for f in findings)


@pytest.mark.parametrize("shape", DEVICE_SHAPES)
def test_device_rule_flags_every_torch_shape(shape):
    """Each shape of the PyTorch device rule fires on the bad fixture."""
    messages = [f.message for f in _run_rule("device-path-purity", "bad")]
    assert any(shape in m for m in messages), messages


def test_device_rule_scope_and_stages():
    """The launch stage is the kernel launchers, the planner's dispatch
    entries, the ``*_packed`` compositions and their same-module callees;
    the fetch stage and CPU-twin branches stay out; modules outside
    ``ops/`` and ``parallel/`` are not judged."""
    src = ("import torch\n"
           "K = CudaKernel('k', 's', 'src', 'r')\n"
           "def launcher(t):\n"
           "    helper(t)\n"
           "    K(t.data_ptr())\n"
           "def helper(t):\n"
           "    return t.item()\n"
           "def fetch_plan(t):\n"
           "    return t.item()\n"
           "def wrapper(t, out):\n"
           "    if not _on_cuda(t):\n"
           "        out.copy_(t)\n"
           "        return\n"
           "    K(t.data_ptr())\n")
    findings = _findings(make_checkers, "device-path-purity", src,
                         f"{PORT}/ops/fixture.py")
    assert [(f.line, "helper" in f.message) for f in findings] == \
        [(7, True)], [f.render() for f in findings]
    assert not _findings(make_checkers, "device-path-purity", src,
                         f"{PORT}/scheduler/fixture.py")


def test_layering_forbids_jax_and_the_reference_in_every_port_package():
    checker = make_checkers(["layering"])[0]
    for rel in (f"{PORT}/models/x.py", f"{PORT}/obs/x.py",
                f"{PORT}/workload.py", "chip_smoke.py"):
        mod = ModuleInfo.from_source(
            "import jax\nfrom swarmkit_tpu.ops import kernel\n"
            "import swarmkit_tpu\nfrom jax import numpy\n", rel)
        found = [f for f in checker.check(mod)
                 if "neither jax nor swarmkit_tpu" in f.message]
        assert [f.line for f in found] == [1, 2, 3, 4], rel
    # tests import both packages
    mod = ModuleInfo.from_source("import jax\n", "tests/test_x.py")
    assert not list(checker.check(mod))


# ------------------------------------------------- parity with the reference

def _ref_findings(rule, source, relpath):
    from swarmkit_tpu.analysis import ModuleInfo as RefModuleInfo
    from swarmkit_tpu.analysis import make_checkers as ref_make
    return _findings(ref_make, rule, source, relpath, RefModuleInfo)


def _key(f):
    return (f.rule, f.line, f.col, to_port(f.message))


def _foreign_import_lines(source):
    """Lines of ``import``/``from`` statements that name jax or the
    reference package: where the port's house rule fires."""
    import ast
    lines = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        if any(n.split(".")[0] in ("jax", "jaxlib", "swarmkit_tpu")
               for n in names):
            lines.append(node.lineno)
    return sorted(lines)


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", SHARED)
def test_shared_rule_equals_the_reference_on_its_fixtures(rule, kind):
    stem, port_rel = FIXTURES[rule]
    source = _read(os.path.join(REF_FIXDIR, f"{stem}_{kind}.py"))
    ref_rel = port_rel.replace(PORT + "/", "swarmkit_tpu/")
    ref = sorted(_key(f) for f in _ref_findings(rule, source, ref_rel))
    port_source = to_port(source)
    port = _findings(make_checkers, rule, port_source, port_rel)
    house = sorted(f.line for f in port
                   if "neither jax nor swarmkit_tpu" in f.message)
    rest = sorted((f.rule, f.line, f.col, f.message) for f in port
                  if "neither jax nor swarmkit_tpu" not in f.message)
    assert rest == ref
    want_house = _foreign_import_lines(port_source) \
        if rule == "layering" else []
    assert house == want_house


def _identical_modules():
    """Port modules that are the reference's text byte for byte (the
    linter's roots skip ``native/``)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, PORT)):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build", "native"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            port = os.path.join(dirpath, fn)
            rel = os.path.relpath(port, os.path.join(REPO, PORT))
            ref = os.path.join(REPO, "swarmkit_tpu", rel)
            if os.path.exists(ref) and _read(ref) == _read(port):
                out.append(rel.replace(os.sep, "/"))
    return out


IDENTICAL = _identical_modules()


@pytest.fixture(scope="module")
def pinned_findings():
    """Both linters, every rule, no baseline, over the byte-identical
    modules: the reference's over its own files, the port's over the
    port's."""
    from swarmkit_tpu.analysis import lint_tree as ref_lint
    ref = ref_lint(REPO, roots=[f"swarmkit_tpu/{r}" for r in IDENTICAL],
                   baseline_path=None)
    port = lint_tree(REPO, roots=[f"{PORT}/{r}" for r in IDENTICAL],
                     baseline_path=None)
    by_path = {}
    for side, res, prefix in (("ref", ref, "swarmkit_tpu/"),
                              ("port", port, PORT + "/")):
        assert len(res.modules) == len(IDENTICAL)
        for f in res.new:
            rel = f.path[len(prefix):]
            by_path.setdefault(rel, {"ref": [], "port": []})[side].append(
                (f.rule, f.line, f.col,
                 to_port(f.message) if side == "ref" else f.message,
                 f.code))
    return by_path


def test_the_pinned_copies_are_many():
    assert len(IDENTICAL) >= 90, IDENTICAL
    for must in ("state/store.py", "scheduler/scheduler.py",
                 "manager/dispatcher.py", "models/types.py", "cli.py"):
        assert must in IDENTICAL


@pytest.mark.parametrize("rel", IDENTICAL)
def test_pinned_copy_has_the_references_findings(rel, pinned_findings):
    got = pinned_findings.get(rel, {"ref": [], "port": []})
    assert sorted(got["port"]) == sorted(got["ref"])


def test_store_findings_are_the_references_four(pinned_findings):
    got = pinned_findings["state/store.py"]
    assert len(got["port"]) == 4
    assert {r[0] for r in got["port"]} == {"determinism-seam"}


# ------------------------------------------------------------- tree run

def test_tree_is_clean():
    """The full rule suite over the port's roots: no new findings, no
    stale or unjustified baseline entries, no parse errors."""
    result = lint_tree(REPO)
    assert DEFAULT_ROOTS == (PORT, "chip_smoke.py")
    assert set(result.rules) == set(checker_names())
    assert len(result.modules) > 100, "tree walk lost most of the port?"
    assert "chip_smoke.py" in result.modules
    assert not any(m.startswith(f"{PORT}/_build/") for m in result.modules)
    assert result.ok, "swarmlint found new violations:\n" \
        + "\n".join(f.render() for f in result.new) \
        + "".join(f"\nstale baseline: {e.to_dict()}" for e in result.stale) \
        + "".join(f"\nunjustified: {e.to_dict()}"
                  for e in result.unjustified)


# ------------------------------------------------------- baseline ratchet

def test_baseline_only_shrinks():
    assert DEFAULT_BASELINE == "swarmlint_torch_baseline.json"
    bl = Baseline.load(os.path.join(REPO, DEFAULT_BASELINE))
    assert len(bl.entries) <= MAX_BASELINE_ENTRIES, \
        f"baseline grew to {len(bl.entries)} entries " \
        f"(cap {MAX_BASELINE_ENTRIES}): the grandfather list only shrinks"
    for e in bl.entries:
        assert e.justification.strip(), e.key()
        assert e.rule in checker_names(), e.rule


def test_baseline_carries_the_references_store_entries():
    """The reference's four ``state/store.py`` entries, with their
    justifications, and every port-only entry names a ROADMAP item."""
    ref = Baseline.load(os.path.join(REPO, "swarmlint_baseline.json"))
    port = Baseline.load(os.path.join(REPO, DEFAULT_BASELINE))
    want = sorted((e.rule, to_port(e.path), e.code, e.justification)
                  for e in ref.entries
                  if e.path == "swarmkit_tpu/state/store.py")
    got = sorted((e.rule, e.path, e.code, e.justification)
                 for e in port.entries
                 if e.path == f"{PORT}/state/store.py")
    assert len(want) == 4 and got == want
    for e in port.entries:
        if e.path != f"{PORT}/state/store.py":
            assert "ROADMAP" in e.justification, e.key()


def test_stale_baseline_entry_is_an_error():
    bl = Baseline([BaselineEntry(
        rule="determinism-seam", path=f"{PORT}/nonexistent.py",
        code="t = time.time()", justification="synthetic")])
    new, old, stale = bl.split([])
    assert stale and stale[0].path == f"{PORT}/nonexistent.py"


def test_baseline_matching_is_count_aware():
    from swarmkit_tpu_torch.analysis.core import Finding

    entry = BaselineEntry(rule="determinism-seam",
                          path=f"{PORT}/state/store.py",
                          code="t0 = time.monotonic()",
                          justification="grandfathered")
    bl = Baseline([entry])

    def f(line):
        return Finding(rule="determinism-seam",
                       path=f"{PORT}/state/store.py", line=line, col=0,
                       message="m", code="t0 = time.monotonic()")
    new, old, stale = bl.split([f(85), f(900)])
    assert len(old) == 1 and len(new) == 1 and not stale


def test_layering_catches_from_package_import_form():
    checker = make_checkers(["layering"])[0]
    mod = ModuleInfo.from_source(
        f"from {PORT} import sim\n"
        f"from {PORT} import manager\n",
        f"{PORT}/ops/fixture.py")
    findings = list(checker.check(mod))
    assert len(findings) == 2, [f.render() for f in findings]


def test_sim_importers_exempt_are_the_ports_drivers():
    checker = make_checkers(["layering"])[0]
    for rel, flagged in ((f"{PORT}/scripts/x.py", False),
                         (f"{PORT}/probes/x.py", False),
                         (f"{PORT}/workload.py", False),
                         ("chip_smoke.py", False), ("tests/test_x.py", False),
                         (f"{PORT}/scheduler/x.py", True)):
        mod = ModuleInfo.from_source(f"from {PORT}.sim import scenario\n",
                                     rel)
        assert bool(list(checker.check(mod))) == flagged, rel


def test_locking_multi_item_with_and_context_expr():
    checker = make_checkers(["lock-discipline"])[0]
    mod = ModuleInfo.from_source(
        "class MemoryStore:\n"
        "    def one(self):\n"
        "        with self._update_lock, self._lock:\n"
        "            self.apply()\n"
        "    def two(self):\n"
        "        with self._lock:\n"
        "            with self._update_lock:\n"
        "                self.apply()\n"
        "    def three(self, planner, h):\n"
        "        with self._lock, planner.fetch_group(h):\n"
        "            pass\n",
        f"{PORT}/state/fixture.py")
    findings = list(checker.check(mod)) + list(checker.finalize())
    assert any("cycle" in f.message for f in findings)
    assert any("fetch_group" in f.message for f in findings)


def test_write_baseline_placeholder_still_fails_the_gate(tmp_path):
    from swarmkit_tpu_torch.analysis import write_baseline

    scratch = str(tmp_path / "bl.json")
    r = lint_tree(REPO, roots=("tests/fixtures/swarmlint_torch",),
                  rules=["determinism-seam"], baseline_path=None)
    assert r.new
    write_baseline(REPO, r, scratch)
    bl = Baseline.load(scratch)
    assert bl.entries and bl.unjustified() == bl.entries


def test_missing_lint_root_is_an_error():
    from swarmkit_tpu_torch.analysis import iter_source_files

    with pytest.raises(FileNotFoundError):
        iter_source_files(REPO, (f"{PORT}/sate",))


def test_directive_in_string_literal_is_inert():
    from swarmkit_tpu_torch.analysis.runner import run_checkers

    mod = ModuleInfo.from_source(
        "import time\n"
        "MSG = \"add '# swarmlint: disable=bogus-rule' above the line\"\n"
        "t = time.time()  "
        "# a real string: '# swarmlint: disable=determinism-seam'\n",
        f"{PORT}/state/fixture.py")
    assert not mod.suppressions.get(2)
    findings, suppressed, bad = run_checkers(make_checkers(), [mod])
    assert not bad
    assert suppressed == 1 and \
        not any(f.rule == "determinism-seam" for f in findings)


def test_metric_hygiene_catches_misprefixed_name_on_registry():
    checker = make_checkers(["metric-hygiene"])[0]
    mod = ModuleInfo.from_source(
        "def f(registry, stopwatch, prefix):\n"
        "    registry.counter('tasks_total')\n"
        "    registry.counter('Swarm_Bad')\n"
        "    stopwatch.timer('laps')\n"
        "    registry.counter(f'{prefix}_total')\n",
        f"{PORT}/obs/fixture.py")
    assert len(list(checker.check(mod))) == 2


# ----------------------------------------------------- suppression audit

def test_suppressions_name_existing_rules():
    from swarmkit_tpu_torch.analysis import iter_source_files

    known = set(checker_names()) | {"all"}
    seen = 0
    for rel in iter_source_files(REPO, DEFAULT_ROOTS):
        mod = ModuleInfo.from_source(_read(os.path.join(REPO, rel)), rel)
        for lineno, rules in sorted(mod.suppressions.items()):
            for rule in rules:
                seen += 1
                assert rule in known, f"{rel}:{lineno}: {rule!r}"
    assert seen >= 1, "expected at least the store/crypto suppressions"


def test_unknown_suppression_is_a_finding():
    from swarmkit_tpu_torch.analysis.runner import run_checkers

    mod = ModuleInfo.from_source(
        "import time\n"
        "t = time.time()  # swarmlint: disable=determinsm-seam\n",
        f"{PORT}/state/fixture.py")
    findings, suppressed, bad = run_checkers(make_checkers(), [mod])
    assert any(f.rule == "bad-suppression" for f in bad)
    assert any(f.rule == "determinism-seam" for f in findings)


def test_subset_runs_ignore_out_of_scope_baseline():
    r = lint_tree(REPO, roots=(f"{PORT}/obs",))
    assert r.ok, [f.render() for f in r.new] + \
        [e.to_dict() for e in r.stale]
    r = lint_tree(REPO, rules=["layering"])
    assert r.ok and not r.stale, [e.to_dict() for e in r.stale]


def test_write_baseline_preserves_out_of_scope_entries(tmp_path):
    import shutil

    from swarmkit_tpu_torch.analysis import write_baseline

    scratch = tmp_path / "bl.json"
    shutil.copy(os.path.join(REPO, DEFAULT_BASELINE), scratch)
    before = Baseline.load(str(scratch))
    r = lint_tree(REPO, roots=(f"{PORT}/obs",), baseline_path=str(scratch))
    n = write_baseline(REPO, r, str(scratch))
    after = Baseline.load(str(scratch))
    assert n == len(before.entries)
    assert sorted((e.key(), e.justification) for e in after.entries) \
        == sorted((e.key(), e.justification) for e in before.entries)


def test_file_roots_are_normalized():
    from swarmkit_tpu_torch.analysis import iter_source_files

    assert iter_source_files(REPO, ("./chip_smoke.py",)) == ["chip_smoke.py"]
    r = lint_tree(REPO, roots=("./chip_smoke.py",), baseline_path=None)
    assert r.ok, [f.render() for f in r.new]


def test_json_report_round_trips():
    from swarmkit_tpu_torch.analysis.reporters import json_report
    payload = json.loads(json_report(lint_tree(REPO, roots=(f"{PORT}/ops",))))
    assert payload["ok"] is True and payload["findings"] == []
    assert len(payload["baselined"]) >= 1
