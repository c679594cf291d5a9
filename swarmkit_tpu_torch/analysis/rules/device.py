"""device-path-purity: no host sync between dispatch and fetch.

The planner's throughput story (async dispatch overlapping host commit)
dies the moment its launch stage waits on the card.  In PyTorch a sync
hides behind ordinary calls, so inside the **launch stage** of
``ops``/``parallel`` this rule flags:

* ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` and
  ``float``/``int``/``bool`` of a non-literal (literals, UPPER_CASE
  constants, ``len(...)`` and numpy calls are host values) — implicit
  D2H syncs;
* ``torch.cuda.synchronize()`` and any ``.synchronize()`` (an event, a
  stream) — explicit syncs that belong in the *fetch* stage;
* a blocking copy: ``.to(<device>)``, ``.cuda()`` or ``.copy_(src)``
  without ``non_blocking=True`` — a copy from pageable memory waits for
  the card;
* syncs that depend on data: ``nonzero()``, boolean-mask indexing,
  ``torch.unique``, ``masked_select``, and Python control flow on a
  tensor (``if t.any():``) — the host needs the result's size or value;
* ``print`` of a non-literal, and setting ``CUDA_LAUNCH_BLOCKING`` or
  ``torch.cuda.set_sync_debug_mode`` in code — debug hooks that
  serialize the hot path.

The launch stage is every function of a module that launches a
hand-written kernel (``.launch(`` on a ``CudaKernel``, or a call of a
kernel object the module makes with ``CudaKernel(...)``), the planner's
dispatch entries (``LAUNCH_ROOTS``), the ``*_packed`` compositions, and
any function of the same module one of them calls (by bare name or as
``self.<method>``).  The fetch stage (``FETCH_STAGE``), where syncs
belong, and the plain versions stay out of it, and so does a CPU-twin
branch (``if not _on_cuda(x):`` and the other ``ON_CUDA_TESTS``,
``if x.device.type != "cuda":``, and the ``else`` of their positive
forms): it runs only on CPU tensors.

A kernel's **plain version** (``_*_plain``) is the CPU twin of the
kernel and must stay torch: ``np.*`` inside it is flagged.

In the **host drivers** of these modules (every other function, the
launch stage included) the rule also flags:

* an **unaccounted transfer** — an H2D (``.to(<device>)``, ``.cuda()``,
  ``.copy_``, an ``UploadStage`` fill through ``.upload()``) or a D2H
  fetch (``.cpu()``, ``.to("cpu")``, ``.copy_`` into a pinned buffer)
  in a function with no ``note_h2d`` / ``note_d2h`` /
  ``note_bytes_avoided`` call and no call through ``devicetelemetry``: a
  byte stream the device ledger never sees.  The fetch stage's seams
  are accounted where the stage is finished (``fetch_plan``,
  ``fetch_group``, ``fetch_fused_chunk``) and are exempt;
* a **staging buffer reused in flight** — after ``dst.copy_(src,
  non_blocking=True)``, a later write to ``src`` (the pinned staging
  buffer an H2D still reads) or read of ``dst``'s data (the pinned
  result of a D2H not yet landed) in the same function, with no event or
  stream wait (``.synchronize()``, ``wait_event``, ``wait_stream``,
  ``host_view``, ``finish_fetch``) in between;
* the **cross-shard shapes** — a value fetched D2H that feeds a later
  dispatch in the same function (the carry round-trips through the host
  mid-chunk), and a ``.to(<device>)`` of a name bound from an earlier
  ``.to(<device>)`` (the tensor is already resident).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set

from ..core import Checker, Finding, ImportMap, ModuleInfo, register

SCOPE_PREFIXES = ("swarmkit_tpu_torch/ops/", "swarmkit_tpu_torch/parallel/")

#: the planner's dispatch entries: launch stage wherever they are defined
LAUNCH_ROOTS = {"dispatch_group", "_enqueue_plan", "probe_fused_run",
                "dispatch_fused_run"}

#: the fetch stage: the D2H seams and the waits (syncs belong here)
FETCH_STAGE = {"start_fetch", "start_fetch_shards", "finish_fetch",
               "fetch_plan", "host_view", "fetch_group",
               "fetch_fused_chunk"}

#: attribute calls that read a tensor's value on the host
_D2H_ATTRS = {"item", "tolist", "cpu", "numpy"}

#: attribute calls that wait for queued device work
_WAIT_ATTRS = {"synchronize", "wait_event", "wait_stream", "host_view",
               "finish_fetch"}

#: attribute calls whose result size depends on the data
_DATA_SIZED_ATTRS = {"nonzero", "unique", "masked_select", "argwhere",
                     "unique_consecutive"}
_DATA_SIZED_FNS = {"torch.nonzero", "torch.unique", "torch.masked_select",
                   "torch.argwhere", "torch.unique_consecutive"}

#: reductions whose truth value a Python branch would read on the host
_TRUTH_ATTRS = {"any", "all", "equal", "allclose"}
_TRUTH_FNS = {"torch.any", "torch.all", "torch.equal", "torch.allclose",
              "torch.count_nonzero", "torch.is_nonzero"}

#: a host fn carrying any of these calls is "accounted": the transfer
#: seams it touches report into the device ledger
_ACCOUNT_ATTRS = {"note_h2d", "note_d2h", "note_bytes_avoided"}

#: in-place writes through a tensor method
_WRITE_ATTRS = {"copy_", "fill_", "zero_", "index_put_", "scatter_",
                "masked_fill_"}

#: data reads of a host tensor
_READ_ATTRS = {"numpy", "tolist", "item"}

#: predicates that are true when their tensors lie on the card: the arm
#: they rule out is a CPU twin
ON_CUDA_TESTS = {"_on_cuda", "_split_route", "_check_shards"}

#: debug switches that serialize the card
_DEBUG_FNS = {"torch.cuda.set_sync_debug_mode"}


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted source form of a Name/Attribute chain ("self.cpu_dev"),
    None for anything fancier."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _is_device_arg(node: ast.AST) -> bool:
    """True when ``node`` names a device, not a dtype: a "cuda"/"cpu"
    string, a ``torch.device(...)``, or a name/attribute mentioning a
    device (``dev``, ``self.device``, ``t.device``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(node, ast.Call):
        return _dotted(node.func) in ("torch.device",)
    d = _dotted(node)
    if d is None:
        return False
    tail = d.rsplit(".", 1)[-1].lower()
    return "dev" in tail or "cuda" in tail


def _is_device_move(call: ast.Call) -> bool:
    """``x.to(<device>)`` (positional or ``device=``) or ``x.cuda()``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "cuda":
        return True
    if f.attr != "to":
        return False
    if _kw(call, "device") is not None:
        return True
    return bool(call.args) and _is_device_arg(call.args[0])


def _is_cpu_target(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    arg = _kw(call, "device") or (call.args[0] if call.args else None)
    return isinstance(arg, ast.Constant) and arg.value == "cpu"


def _cpu_branch(test: ast.AST) -> Optional[str]:
    """Which arm of an ``if`` runs only on CPU tensors: "body" for
    ``not _on_cuda(x)`` (any of ``ON_CUDA_TESTS``) / ``x.type != "cuda"`` /
    ``x.type == "cpu"``, "orelse" for their positive forms, None for any
    other test."""
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    inner = test.operand if neg else test
    if isinstance(inner, ast.Call):
        name = _dotted(inner.func) or ""
        if name.rsplit(".", 1)[-1] in ON_CUDA_TESTS:
            return "body" if neg else "orelse"
        return None
    if isinstance(inner, ast.Compare) and len(inner.ops) == 1 \
            and isinstance(inner.comparators[0], ast.Constant) \
            and isinstance(inner.left, ast.Attribute) \
            and inner.left.attr == "type":
        value = inner.comparators[0].value
        eq = isinstance(inner.ops[0], (ast.Eq, ast.Is))
        ne = isinstance(inner.ops[0], (ast.NotEq, ast.IsNot))
        if not (eq or ne) or value not in ("cuda", "cpu"):
            return None
        cpu_when_true = (value == "cpu") == eq
        if neg:
            cpu_when_true = not cpu_when_true
        return "body" if cpu_when_true else "orelse"
    return None


def _walk(fn: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` over a function, minus its CPU-twin branches."""
    stack = [fn]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.If):
            arm = _cpu_branch(node.test)
            stack.append(node.test)
            if arm != "body":
                stack.extend(node.body)
            if arm != "orelse":
                stack.extend(node.orelse)
            continue
        stack.extend(ast.iter_child_nodes(node))


def _module_functions(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """Module-level and class-level defs by (unqualified) name."""
    out: Dict[str, ast.FunctionDef] = {}
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            stack.extend(ast.iter_child_nodes(node))
        elif isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, node)
    return out


def _kernel_objects(tree: ast.AST) -> Set[str]:
    """Module-level names bound to ``CudaKernel(...)``."""
    out: Set[str] = set()
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and (_dotted(node.value.func) or "").rsplit(".", 1)[-1] \
                == "CudaKernel":
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _launches(fn: ast.FunctionDef, kernels: Set[str]) -> bool:
    """True when ``fn`` launches a kernel: ``.launch(`` on anything, a
    call of a kernel object, or a call of a local name bound from an
    expression that names one (``k = A if c else B; k(...)``)."""
    local: Set[str] = set()
    for node in _walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(n, ast.Name) and n.id in kernels
                for n in ast.walk(node.value)):
            local.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    for node in _walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "launch":
            return True
        if isinstance(node.func, ast.Name) \
                and (node.func.id in kernels or node.func.id in local):
            return True
    return False


def _callees(fn: ast.FunctionDef, fns: Dict[str, ast.FunctionDef]
             ) -> Set[str]:
    """Same-module functions ``fn`` calls by bare name or as
    ``self.<name>``, outside its CPU-twin branches."""
    out: Set[str] = set()
    for node in _walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in fns:
            out.add(f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and f.attr in fns:
            out.add(f.attr)
    return out


def _is_plain(name: str) -> bool:
    return name.startswith("_") and name.endswith("_plain")


def _is_accounted(fn: ast.FunctionDef) -> bool:
    """True when the function body carries a device-ledger accounting
    call — an ``_ACCOUNT_ATTRS`` attr call (works for the conventional
    ``_devtel`` alias) or any dotted call through ``devicetelemetry``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _ACCOUNT_ATTRS:
            return True
        d = _dotted(node.func)
        if d and "devicetelemetry" in d:
            return True
    return False


def _is_mask(node: ast.AST, masks: Set[str]) -> bool:
    """A boolean-mask index: a comparison, a ``~``/``&``/``|`` of
    comparisons, or a name bound from one in the same function."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return True
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask(node.left, masks) or _is_mask(node.right, masks)
    return isinstance(node, ast.Name) and node.id in masks


def _mask_names(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for node in _walk(fn):
        if isinstance(node, ast.Assign) and _is_mask(node.value, out):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _host_number(node: ast.AST, imports: ImportMap) -> bool:
    """An argument of ``float``/``int``/``bool`` that is a host value by
    its shape: a literal, an UPPER_CASE constant, ``len(...)`` or a numpy
    call."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id.isupper()
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
        return (imports.resolve(node.func) or "").startswith("numpy.")
    return False


def _truth_read(test: ast.AST, imports: ImportMap) -> bool:
    """A branch test that needs a tensor's value on the host."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        if imports.resolve(node.func) in _TRUTH_FNS:
            return True
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TRUTH_ATTRS \
                and not (imports.resolve(node.func.value) or "") \
                .startswith("numpy"):
            return True
    return False


@register
class DevicePathPurity(Checker):
    name = "device-path-purity"
    description = ("no host sync between dispatch and fetch: .item()/"
                   ".tolist()/blocking copies/data-sized ops in the launch "
                   "stage, np. in plain versions, accounted transfers "
                   "(ops/, parallel/)")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not mod.relpath.startswith(SCOPE_PREFIXES):
            return ()
        imports = ImportMap(mod.tree)
        fns = _module_functions(mod.tree)
        kernels = _kernel_objects(mod.tree)

        # roots: kernel launchers, the planner's dispatch entries and the
        # packed compositions; then every same-module callee
        launch: Set[str] = {
            name for name, fn in fns.items()
            if name not in FETCH_STAGE and not _is_plain(name)
            and (name in LAUNCH_ROOTS or name.endswith("_packed")
                 or _launches(fn, kernels))}
        frontier = list(launch)
        while frontier:
            for callee in _callees(fns[frontier.pop()], fns):
                if callee in launch or callee in FETCH_STAGE \
                        or _is_plain(callee):
                    continue
                launch.add(callee)
                frontier.append(callee)

        out: List[Finding] = []
        for name in sorted(launch):
            out.extend(self._check_launch(mod, fns[name], imports))
        for name in sorted(fns):
            if _is_plain(name):
                out.extend(self._check_plain(mod, fns[name], imports))

        dispatchers = launch | kernels
        for name in sorted(fns):
            fn = fns[name]
            if _is_plain(name):
                continue
            if name not in FETCH_STAGE:
                out.extend(self._check_unaccounted_transfer(mod, fn))
            out.extend(self._check_in_flight(mod, fn))
            out.extend(self._check_cross_shard(mod, fn, imports,
                                               dispatchers))
        return out

    # ------------------------------------------------------ launch stage
    def _check_launch(self, mod: ModuleInfo, fn: ast.FunctionDef,
                      imports: ImportMap) -> List[Finding]:
        out: List[Finding] = []
        masks = _mask_names(fn)
        where = f"in launch-stage fn {fn.name}"
        for node in _walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)) \
                    and _truth_read(node.test, imports):
                out.append(mod.finding(
                    self.name, node.test,
                    f"Python control flow on a tensor {where}: the branch "
                    "reads the value on the host (a sync); decide on the "
                    "host's own data or on the card"))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and _is_mask(node.slice, masks):
                out.append(mod.finding(
                    self.name, node,
                    f"boolean-mask indexing {where}: the result's size "
                    "depends on the data, so the host waits for the "
                    "card; use torch.where or a kernel"))
            elif isinstance(node, ast.Constant) \
                    and node.value == "CUDA_LAUNCH_BLOCKING":
                out.append(mod.finding(
                    self.name, node,
                    f"CUDA_LAUNCH_BLOCKING {where}: makes every launch a "
                    "sync; set it in the environment of a debug run"))
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            dotted = imports.resolve(f)
            tail = f.attr if isinstance(f, ast.Attribute) else None
            if tail in _D2H_ATTRS and not (
                    imports.resolve(f.value) or "").startswith("numpy"):
                out.append(mod.finding(
                    self.name, node,
                    f".{tail}() {where}: implicit host sync; keep values "
                    "on the card (the fetch belongs in ops/kernel.py "
                    "start_fetch / finish_fetch)"))
            elif tail == "synchronize":
                out.append(mod.finding(
                    self.name, node,
                    f".synchronize() {where}: an explicit sync; waits "
                    "belong in the fetch stage (finish_fetch)"))
            elif _is_device_move(node) and not _non_blocking(node):
                out.append(mod.finding(
                    self.name, node,
                    f"blocking copy .{tail}(<device>) {where}: a copy "
                    "from pageable memory waits for the card; stage it "
                    "in pinned memory and pass non_blocking=True"))
            elif tail == "copy_" and not _non_blocking(node):
                out.append(mod.finding(
                    self.name, node,
                    f"blocking .copy_() {where}: a host<->device copy "
                    "without non_blocking=True syncs; stage it in pinned "
                    "memory and pass non_blocking=True"))
            elif tail in _DATA_SIZED_ATTRS or dotted in _DATA_SIZED_FNS:
                what = tail or dotted
                out.append(mod.finding(
                    self.name, node,
                    f"{what}() {where}: the result's size depends on the "
                    "data, so the host waits for the card"))
            elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                    and node.args and not _host_number(node.args[0],
                                                       imports):
                out.append(mod.finding(
                    self.name, node,
                    f"{f.id}() of a non-literal {where}: on a tensor it "
                    "is an implicit host sync; keep the value on the "
                    "card or take it from the host's own data"))
            elif isinstance(f, ast.Name) and f.id == "print" \
                    and any(not isinstance(a, ast.Constant)
                            for a in node.args):
                out.append(mod.finding(
                    self.name, node,
                    f"print of a non-literal {where}: printing a tensor "
                    "reads it on the host (a sync); gate or remove"))
            elif dotted in _DEBUG_FNS:
                out.append(mod.finding(
                    self.name, node,
                    f"{dotted} {where}: a debug hook on the hot path; "
                    "set it in a debug harness, not in the package"))
        return out

    def _check_plain(self, mod: ModuleInfo, fn: ast.FunctionDef,
                     imports: ImportMap) -> List[Finding]:
        numpy_aliases = {alias for alias, target in imports.aliases.items()
                         if target == "numpy"}
        out: List[Finding] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in numpy_aliases:
                out.append(mod.finding(
                    self.name, node,
                    f"np.{node.attr} inside plain version {fn.name}: the "
                    "plain version is the kernel's CPU twin and must stay "
                    "torch"))
        return out

    # ------------------------------------------------------ host drivers
    def _check_unaccounted_transfer(self, mod: ModuleInfo,
                                    fn: ast.FunctionDef) -> List[Finding]:
        """One host function: its H2D moves, ``.copy_`` calls and
        ``.upload()`` fills, and its D2H reads; all pass when the body
        carries an accounting call, all fire when it does not."""
        moves: List[ast.Call] = []
        for node in _walk(fn):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            tail = node.func.attr
            if _is_device_move(node) or tail in ("copy_", "upload"):
                moves.append(node)
        if not moves or _is_accounted(fn):
            return []
        return [mod.finding(
            self.name, node,
            f"unaccounted transfer: .{node.func.attr}() in host fn "
            f"{fn.name} with no device-ledger accounting — note the "
            "bytes (obs.devicetelemetry.note_h2d / note_d2h) or route "
            "through an accounted seam") for node in moves]

    def _check_in_flight(self, mod: ModuleInfo,
                         fn: ast.FunctionDef) -> List[Finding]:
        """A non-blocking copy's source written, or its destination's data
        read, later in the same function with no wait in between."""
        copies = []       # (line, src dotted, dst dotted)
        waits: List[int] = []
        writes: Dict[str, List[int]] = {}
        reads: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                tail = node.func.attr
                base = _dotted(node.func.value)
                if tail == "copy_" and _non_blocking(node) and node.args:
                    copies.append((node.lineno, _dotted(node.args[0]),
                                   base))
                elif tail == "upload" and base:
                    copies.append((node.lineno, base + ".host", None))
                if tail in _WAIT_ATTRS:
                    waits.append(node.lineno)
                elif tail in _WRITE_ATTRS and base:
                    writes.setdefault(base, []).append(node.lineno)
                elif tail in _READ_ATTRS and base:
                    reads.setdefault(base, []).append(node.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in _WAIT_ATTRS:
                waits.append(node.lineno)
            elif isinstance(node, ast.Subscript):
                base = _dotted(node.value)
                if base is None and isinstance(node.value, ast.Call) \
                        and isinstance(node.value.func, ast.Attribute) \
                        and node.value.func.attr == "numpy":
                    base = _dotted(node.value.func.value)
                if base is None:
                    continue
                if isinstance(node.ctx, ast.Store):
                    writes.setdefault(base, []).append(node.lineno)
                elif isinstance(node.ctx, ast.Load):
                    reads.setdefault(base, []).append(node.lineno)
        out: List[Finding] = []
        for line, src, dst in copies:
            def hazard(lines):
                return next((ln for ln in sorted(lines) if ln > line
                             and not any(line < w <= ln for w in waits)),
                            None)
            bad = None
            if src is not None:
                ln = hazard(writes.get(src, ()))
                if ln is not None:
                    bad = (f"staging buffer {src!r} written again at line "
                           f"{ln} while the non-blocking copy at line "
                           f"{line} may still read it")
            if bad is None and dst is not None:
                ln = hazard(reads.get(dst, ()))
                if ln is not None:
                    bad = (f"pinned result {dst!r} read at line {ln} "
                           f"before the non-blocking copy at line {line} "
                           "has landed")
            if bad is not None:
                out.append(Finding(
                    rule=self.name, path=mod.relpath, line=line, col=0,
                    message=f"{bad} in host fn {fn.name}: wait on the "
                            "copy's event (or the stream) first",
                    code=mod.code_at(line)))
        return out

    def _check_cross_shard(self, mod: ModuleInfo, fn: ast.FunctionDef,
                           imports: ImportMap,
                           dispatchers: Set[str]) -> List[Finding]:
        """A D2H fetch of a dotted ``x`` that is passed to a dispatcher
        (a launch-stage function or a kernel of this module) on a LATER
        line — the carry round-trips through the host mid-chunk — and a
        ``.to(<device>)`` of a name bound from an earlier one."""
        out: List[Finding] = []
        dispatch_arg_lines: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name) and f.value.id == "self"
                else None)
            if name in dispatchers:
                for a in node.args:
                    d = _dotted(a)
                    if d:
                        dispatch_arg_lines.setdefault(d, []).append(
                            node.lineno)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fetched = None
            if isinstance(f, ast.Attribute) and (
                    f.attr in _D2H_ATTRS
                    or (f.attr == "to" and _is_cpu_target(node))):
                fetched = _dotted(f.value)
            elif isinstance(f, ast.Name) and f.id == "finish_fetch" \
                    and node.args:
                fetched = _dotted(node.args[0])
            if fetched and any(ln > node.lineno for ln in
                               dispatch_arg_lines.get(fetched, ())):
                out.append(mod.finding(
                    self.name, node,
                    f"mid-chunk D2H of {fetched!r} in host fn {fn.name}: "
                    "the value feeds a device dispatch below — keep it "
                    "on the card between chunks and fetch once, after "
                    "the last dispatch"))
        resident: Dict[str, int] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and _is_device_move(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        resident[tgt.id] = node.lineno
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_device_move(node) \
                    and isinstance(node.func, ast.Attribute):
                d = _dotted(node.func.value)
                if d in resident and node.lineno > resident[d]:
                    out.append(mod.finding(
                        self.name, node,
                        f"re-upload of already-resident {d!r} in host fn "
                        f"{fn.name}: moved to the device at line "
                        f"{resident[d]} — reuse that tensor"))
        return out
