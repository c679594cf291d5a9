"""Trace analysis: phase tables and schema validation.

Consumed three ways: ``scripts/trace_report.py`` (CLI), ``bench.py``
(embeds a per-config phase table in the BENCH artifact, derived from the
same trace JSON it writes), and the tier-1 smoke test (schema-validates
an emitted trace).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# span names making up the device-plan phase vs the host-commit phase —
# the pair whose overlap answers ROADMAP item 1's question ("is plan
# hidden behind commit?")
PLAN_PHASES = ("plan.dispatch", "plan.d2h", "plan.feasibility",
               # whole dispatch→fetch window of one plan (retro span):
               # captures compute hidden behind commits that the d2h
               # wait alone cannot see (ops/planner.py _note_inflight)
               "plan.inflight")
COMMIT_PHASES = ("sched.commit",)


def x_events(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in doc.get("traceEvents", ())
            if e.get("ph") == "X"]


def config_windows(doc: Dict[str, Any]
                   ) -> List[Tuple[str, Tuple[int, int]]]:
    """(cfg label, (ts_lo, ts_hi)) per ``bench.config`` marker span —
    the single definition both bench.py and scripts/trace_report.py use
    to attribute phases, so artifact tables and CLI reports can never
    disagree on the same trace file."""
    return [(e["args"].get("cfg", "?"), (e["ts"], e["ts"] + e["dur"]))
            for e in x_events(doc) if e["name"] == "bench.config"]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, non-overlapping union of [start, end) us intervals.
    Overlap/union math runs on merged sets only — concurrent spans of
    the same phase (the pipelining PR will produce them) must not be
    double-counted."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _union_seconds(merged: List[Tuple[int, int]]) -> float:
    """Total covered length of a MERGED interval set, in seconds."""
    return sum(e - s for s, e in merged) / 1e6


def _overlap_seconds(a: List[Tuple[int, int]],
                     b: List[Tuple[int, int]]) -> float:
    """Intersection length of two MERGED interval sets, in seconds."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def phase_table(doc: Dict[str, Any],
                window: Optional[Tuple[int, int]] = None
                ) -> Dict[str, Any]:
    """Summarize a Chrome trace into a per-phase table.

    ``window``: optional (ts_lo, ts_hi) in trace microseconds — restricts
    the table to spans starting inside it (bench uses the enclosing
    ``bench.config`` span to attribute phases per config).
    """
    phases: Dict[str, Dict[str, float]] = {}
    plan_iv: List[Tuple[int, int]] = []
    commit_iv: List[Tuple[int, int]] = []
    for e in x_events(doc):
        ts, dur = e["ts"], e["dur"]
        if window is not None and not (window[0] <= ts <= window[1]):
            continue
        row = phases.setdefault(
            e["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur / 1e6
        row["max_s"] = max(row["max_s"], dur / 1e6)
        if e["name"] in PLAN_PHASES:
            plan_iv.append((ts, ts + dur))
        elif e["name"] in COMMIT_PHASES:
            commit_iv.append((ts, ts + dur))
    for row in phases.values():
        row["total_s"] = round(row["total_s"], 6)
        row["max_s"] = round(row["max_s"], 6)
    plan_iv = _merge(plan_iv)
    commit_iv = _merge(commit_iv)
    plan_s = _union_seconds(plan_iv)
    commit_s = _union_seconds(commit_iv)
    overlap = _overlap_seconds(plan_iv, commit_iv)
    return {
        "phases": dict(sorted(phases.items())),
        "plan_wall_s": round(plan_s, 6),
        "commit_wall_s": round(commit_s, 6),
        "plan_commit_overlap_s": round(overlap, 6),
        # fraction of device-plan wall time hidden behind host commit;
        # 0.0 today (sequential) — the pipelining PR moves this
        "plan_hidden_frac": round(overlap / plan_s, 4) if plan_s else 0.0,
        # the mirror fraction: host-commit wall time hidden behind the
        # device plan — the commit-plane headline ISSUE 13 tracks
        "commit_hidden_frac": round(overlap / commit_s, 4)
        if commit_s else 0.0,
    }


def format_table(table: Dict[str, Any]) -> str:
    lines = [f"{'phase':<28} {'count':>8} {'total_s':>12} {'max_s':>12}"]
    for name, row in table["phases"].items():
        lines.append(f"{name:<28} {row['count']:>8} "
                     f"{row['total_s']:>12.6f} {row['max_s']:>12.6f}")
    lines.append("")
    lines.append(f"plan wall   : {table['plan_wall_s']:.6f}s")
    lines.append(f"commit wall : {table['commit_wall_s']:.6f}s")
    lines.append(f"overlap     : {table['plan_commit_overlap_s']:.6f}s "
                 f"(plan hidden: {table['plan_hidden_frac'] * 100:.1f}%)")
    return "\n".join(lines)


def diff_phase_tables(a: Dict[str, Any], b: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Side-by-side diff of two ``phase_table`` results (A = baseline,
    B = candidate).  ``delta_pct`` is B vs A on total_s; None when A has
    no time in that phase.  Shared by ``scripts/trace_report.py --diff``
    and tests, so CLI output and assertions use one aggregation."""
    names = sorted(set(a.get("phases", {})) | set(b.get("phases", {})))
    rows = []
    for n in names:
        ra = a.get("phases", {}).get(n) or {"count": 0, "total_s": 0.0}
        rb = b.get("phases", {}).get(n) or {"count": 0, "total_s": 0.0}
        ta, tb = ra["total_s"], rb["total_s"]
        rows.append({
            "phase": n,
            "a_count": ra["count"], "b_count": rb["count"],
            "a_total_s": ta, "b_total_s": tb,
            "delta_pct": round((tb - ta) / ta * 100.0, 1) if ta else None,
        })
    summary = {}
    for key in ("plan_wall_s", "commit_wall_s", "plan_commit_overlap_s",
                "plan_hidden_frac"):
        summary[key] = (a.get(key, 0.0), b.get(key, 0.0))
    return {"rows": rows, "summary": summary}


def format_diff(diff: Dict[str, Any]) -> str:
    lines = [f"{'phase':<28} {'A cnt':>7} {'B cnt':>7} "
             f"{'A total_s':>12} {'B total_s':>12} {'delta':>8}"]
    for row in diff["rows"]:
        d = row["delta_pct"]
        if d is not None:
            delta = f"{d:+.1f}%"
        elif row["b_total_s"] and not row["a_total_s"]:
            delta = "new"
        else:
            delta = "="
        lines.append(
            f"{row['phase']:<28} {row['a_count']:>7} {row['b_count']:>7} "
            f"{row['a_total_s']:>12.6f} {row['b_total_s']:>12.6f} "
            f"{delta:>8}")
    lines.append("")
    for key, (va, vb) in diff["summary"].items():
        lines.append(f"{key:<22}: {va:.6f} -> {vb:.6f}")
    return "\n".join(lines)


def device_table(art: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Join a bench artifact's device-telemetry ledger with the device
    plane's occupancy window: kernel rows (bucket/route, dispatch vs
    D2H vs compile time) against what the plane as a whole reported.
    Returns None when the artifact carries no ``device_telemetry``
    (pre-PR-18 artifact, or telemetry off) — the CLI exits non-zero.
    Shared by ``scripts/trace_report.py --device`` and tests."""
    tel = art.get("device_telemetry")
    if not isinstance(tel, dict):
        return None
    plane = (art.get("planes") or {}).get("device") or {}
    rows = []
    for key, row in sorted((tel.get("kernel") or {}).items()):
        bucket, _, route = key.partition("|")
        rows.append({
            "bucket": bucket, "route": route,
            "dispatches": row.get("dispatches", 0),
            "groups": row.get("groups", 0),
            "task_rows": row.get("task_rows", 0),
            "node_rows": row.get("node_rows", 0),
            "dispatch_s": round(row.get("dispatch_ns", 0) / 1e9, 6),
            "d2h_s": round(row.get("d2h_ns", 0) / 1e9, 6),
            "compile_s": round(
                row.get("retro_compile_ns", 0) / 1e9, 6),
        })
    return {
        "device_plane": plane,
        "kernel": rows,
        "transfers": tel.get("transfers") or {},
        "bytes_avoided": tel.get("bytes_avoided", 0),
        "compile_cache": tel.get("compile_cache") or {},
        "memory": tel.get("memory") or {},
        "donation": tel.get("donation") or {},
    }


def format_device_table(table: Dict[str, Any]) -> str:
    plane = table["device_plane"]
    lines = [
        f"device plane: occupancy={plane.get('occupancy', 0.0)} "
        f"queue_depth={plane.get('queue_depth', 0.0)} "
        f"oldest_age_s={plane.get('oldest_age_s', 0.0)}",
        "",
        f"{'bucket':<40} {'route':<10} {'disp':>6} "
        f"{'dispatch_s':>11} {'d2h_s':>9} {'compile_s':>10}",
    ]
    for r in table["kernel"]:
        lines.append(
            f"{r['bucket']:<40} {r['route']:<10} {r['dispatches']:>6} "
            f"{r['dispatch_s']:>11.6f} {r['d2h_s']:>9.6f} "
            f"{r['compile_s']:>10.6f}")
    lines.append("")
    for direction in sorted(table["transfers"]):
        for reason, row in sorted(table["transfers"][direction].items()):
            lines.append(f"{direction} {reason:<16}: "
                         f"{row['bytes']:>14} B  x{row['count']}")
    lines.append(f"bytes avoided        : {table['bytes_avoided']:>14} B")
    cache = table["compile_cache"]
    misses = sum(r.get("misses", 0) for r in cache.values())
    hits = sum(r.get("hits", 0) for r in cache.values())
    lines.append(f"compile cache        : {len(cache)} signatures, "
                 f"{misses} misses, {hits} hits")
    don = table["donation"]
    if don:
        lines.append(
            f"donation balance     : donated={don.get('donated', 0)} "
            f"retired={don.get('retired', 0)} "
            f"outstanding={don.get('outstanding', 0)} "
            f"violations={don.get('violations', 0)}")
    return "\n".join(lines)


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-validate a Chrome trace-event document.  Returns a list of
    problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    span_ids = set()
    parents = []
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph == "M":
            if e.get("name") != "thread_name":
                problems.append(f"event {i}: unknown metadata {e.get('name')}")
            continue
        if ph != "X":
            problems.append(f"event {i}: unsupported phase {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"event {i}: missing name")
        for key in ("ts", "dur", "pid", "tid"):
            v = e.get(key)
            if not isinstance(v, int) or v < 0:
                problems.append(f"event {i}: bad {key}={v!r}")
        args = e.get("args")
        if not isinstance(args, dict) \
                or not isinstance(args.get("span_id"), int):
            problems.append(f"event {i}: args.span_id missing")
        else:
            span_ids.add(args["span_id"])
            if args.get("parent_id"):
                parents.append((i, args["parent_id"]))
    dropped = (doc.get("otherData") or {}).get("dropped_spans", 0)
    if not dropped:
        for i, pid in parents:
            if pid not in span_ids:
                problems.append(f"event {i}: parent {pid} not in trace")
    return problems
