"""Device-plane telemetry: kernel / transfer / compile / memory ledger.

PR 17 made the *control* planes legible; the device plane — the part
this reproduction exists to accelerate — was observed only as a coarse
queue gauge plus a retroactive ``plan.compile`` span.  This module is
the deterministic, bounded ledger every device interaction routes
through (the xprof/JAX-profiler model of attributing time to compiles
vs transfers vs compute, kept Dapper-cheap):

* **kernel ledger** — one aggregate row per ``(bucket, route)``:
  dispatch count, group/task/node rows, dispatch ns, D2H ns, and the
  retroactively measured compile ns.  Keys are the existing static
  compile-bucket names (``nb..``, ``_st<id>``, ``_gfF``, ``feas_``,
  ``stream_``, ``preempt_``) — bounded label cardinality by
  construction, never entity ids (the swarmlint metric-hygiene rule
  polices the exported ``swarm_device_kernel_*`` names the same way).
* **transfer accounting** — every H2D upload / D2H fetch seam reports
  bytes with a *reason* from a fixed taxonomy; streaming's resident
  tier also reports the bytes its donated scatter AVOIDED moving, so
  the streaming win is a number, not an inference.
* **compile-cache ledger** — a per-process registry of every jit
  signature ever compiled (bucket, shapes hash, retro compile time,
  hit/miss counts), serialized into bench artifacts and flight-recorder
  dumps so "compiles 0 in the timed window" is auditable per-signature.
* **memory watermarks** — live-buffer byte estimates per resident tier
  (host mirror vs device copies), plus a donation-balance registry that
  cross-checks the swarmlint donation rule at *runtime*: buffers
  donated to XLA are registered, retirements balance them, and a read
  of a still-donated buffer is a counted violation.

Determinism discipline: this module NEVER consumes the time source
(``models.types.now``) — callers hand it durations they already
measured — so enabling it cannot shift frozen-clock byte-identity runs.
All ledger keys are strings aggregated in program order and snapshots
sort them, so output is independent of PYTHONHASHSEED.  Every table is
bounded (row caps with counted overflow), so a pathological workload
costs O(cap), never O(signatures).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Iterable, List, Optional

from ..utils.metrics import registry as _metrics

#: fixed transfer-reason taxonomy (bounded label cardinality).  Unknown
#: reasons lump into "other" rather than minting labels.
H2D_REASONS = (
    "cold_build",      # resident full upload / fused run node state
    "dirty_scatter",   # streaming donated scatter staging buffers
    "shard_scatter",   # per-shard staged scatter buffers (mesh tier)
    "wide_reupload",   # delta wider than the scatter buckets
    "mesh_reshard",    # NamedSharding device_put over the mesh
    "group_inputs",    # per-group kernel input columns
    "fused_inputs",    # fused chunk staging arrays
    "gang_inputs",     # gang feasibility input stacks
    "preempt_inputs",  # victim-selection candidate matrices
)
D2H_REASONS = (
    "fetch",           # plan outputs (fetch_plan seam)
    "feasibility",     # preassigned-validation mask/capacity
    "preempt",         # victim picks
    "probe",           # launch-overhead measurement
)
D2D_REASONS = (
    "resident_carry",  # fused carry cloned from the resident columns
)
_OTHER = "other"

#: fixed memory tiers (watermark gauges)
TIERS = ("host_mirror", "device_resident")

#: row caps — counted overflow, never silent truncation
MAX_KERNEL_ROWS = 256
MAX_CACHE_ROWS = 512
MAX_DONATED_IDS = 4096
#: distinct (bucket, route) label combos exported to the live metrics
#: registry — tighter than MAX_KERNEL_ROWS because exposition-page
#: cardinality is the scarcer resource; past the cap, dispatches still
#: count but under bucket="__overflow__"
MAX_METRIC_SERIES = 48


def tree_nbytes(obj) -> int:
    """Total ``nbytes`` of a nested tuple/list/dict of array-likes —
    the one byte-count every transfer seam shares (host-side shapes
    only; never introspects device buffers)."""
    if obj is None:
        return 0
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(obj, dict):
        return sum(tree_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tree_nbytes(v) for v in obj)
    return 0


class DeviceTelemetry:
    """The bounded ledger.  Thread-safe; every note is a few dict ops
    under one lock (the PlaneStats cost model)."""

    def __init__(self):
        self.enabled = True
        self._mu = threading.Lock()
        # (bucket, route) -> row
        self._kernel: Dict[tuple, Dict[str, int]] = {}
        self.kernel_overflow = 0
        # (bucket, route) combos already exported as live metric series
        self._metric_series: set = set()
        # direction -> reason -> {"bytes", "count"}
        self._transfers: Dict[str, Dict[str, Dict[str, int]]] = {
            "h2d": {}, "d2h": {}, "d2d": {}}
        self.bytes_avoided = 0
        # bucket -> {"shape_hash","compiles","compile_ns","hits","misses"}
        self._cache: Dict[str, Dict[str, int]] = {}
        self.cache_overflow = 0
        # tier -> {"bytes","peak"}
        self._mem: Dict[str, Dict[str, int]] = {}
        # donation balance: live ids of buffers donated to XLA
        # (insertion-ordered for FIFO eviction; value is a presence
        # marker — it must be truthy so note_retired's pop can tell a
        # balanced retirement from an id never donated)
        self._donated: Dict[int, bool] = {}
        self.donations = 0
        self.retirements = 0
        self.donation_violations = 0

    # ------------------------------------------------------- kernel ledger

    def note_kernel(self, bucket: str, route: str, *,
                    dispatch_s: float = 0.0, d2h_s: float = 0.0,
                    compile_s: float = 0.0, groups: int = 1,
                    task_rows: int = 0, node_rows: int = 0,
                    strategy_id: int = -1) -> None:
        """One device dispatch (or one fetch completing it), keyed by
        the static jit-signature bucket and the routing label."""
        if not self.enabled:
            return
        key = (bucket, route)
        with self._mu:
            row = self._kernel.get(key)
            if row is None:
                if len(self._kernel) >= MAX_KERNEL_ROWS:
                    self.kernel_overflow += 1
                    key = ("__overflow__", route)
                    row = self._kernel.get(key)
                if row is None:
                    row = self._kernel[key] = {
                        "dispatches": 0, "groups": 0, "task_rows": 0,
                        "node_rows": 0, "dispatch_ns": 0, "d2h_ns": 0,
                        "retro_compile_ns": 0, "strategy_id": -1}
            row["dispatches"] += 1
            row["groups"] += int(groups)
            row["task_rows"] += int(task_rows)
            row["node_rows"] = max(row["node_rows"], int(node_rows))
            row["dispatch_ns"] += int(dispatch_s * 1e9)
            row["d2h_ns"] += int(d2h_s * 1e9)
            row["retro_compile_ns"] += int(compile_s * 1e9)
            if strategy_id >= 0:
                row["strategy_id"] = int(strategy_id)
            mkey = key
            if mkey not in self._metric_series:
                if len(self._metric_series) >= MAX_METRIC_SERIES:
                    mkey = ("__overflow__", route)
                else:
                    self._metric_series.add(mkey)
        _metrics.counter(
            f'swarm_device_kernel_dispatches{{bucket="{mkey[0]}"'
            f',route="{route}"}}')

    # ---------------------------------------------------------- transfers

    def _note_transfer(self, direction: str, reasons: tuple,
                       reason: str, nbytes: int) -> None:
        if not self.enabled or nbytes < 0:
            return
        if reason not in reasons:
            reason = _OTHER
        with self._mu:
            table = self._transfers[direction]
            row = table.get(reason)
            if row is None:
                row = table[reason] = {"bytes": 0, "count": 0}
            row["bytes"] += int(nbytes)
            row["count"] += 1
        _metrics.counter(
            f'swarm_device_transfer_bytes{{dir="{direction}"'
            f',reason="{reason}"}}', int(nbytes))

    def note_h2d(self, reason: str, nbytes: int) -> None:
        """Host-to-device upload of ``nbytes`` (host-side shape math)."""
        self._note_transfer("h2d", H2D_REASONS, reason, nbytes)

    def note_d2h(self, reason: str, nbytes: int) -> None:
        """Device-to-host fetch of ``nbytes``."""
        self._note_transfer("d2h", D2H_REASONS, reason, nbytes)

    def note_d2d(self, reason: str, nbytes: int) -> None:
        """Device-to-device copy of ``nbytes`` (no host link crossed)."""
        self._note_transfer("d2d", D2D_REASONS, reason, nbytes)

    def note_bytes_avoided(self, nbytes: int) -> None:
        """Bytes a resident/donated fast path did NOT move (the
        streaming win, measured rather than inferred)."""
        if not self.enabled or nbytes <= 0:
            return
        with self._mu:
            self.bytes_avoided += int(nbytes)
        _metrics.counter("swarm_device_bytes_avoided", int(nbytes))

    # ------------------------------------------------ compile-cache ledger

    def _cache_row(self, bucket: str) -> Optional[Dict[str, int]]:
        row = self._cache.get(bucket)
        if row is None:
            if len(self._cache) >= MAX_CACHE_ROWS:
                self.cache_overflow += 1
                return None
            row = self._cache[bucket] = {
                # PYTHONHASHSEED-independent shapes hash (crc32, the
                # journey-sampling discipline)
                "shape_hash": zlib.crc32(bucket.encode()) & 0xFFFFFFFF,
                "compiles": 0, "compile_ns": 0, "hits": 0, "misses": 0}
        return row

    def note_compile(self, bucket: str, dt: float,
                     count: int = 1) -> None:
        """An observed XLA cache miss: ``count`` new signatures under
        ``bucket``, retro-measured at ``dt`` seconds."""
        if not self.enabled:
            return
        with self._mu:
            row = self._cache_row(bucket)
            if row is None:
                return
            row["compiles"] += int(count)
            row["misses"] += int(count)
            row["compile_ns"] += int(dt * 1e9)

    def note_cache_hit(self, bucket: str) -> None:
        """A dispatch whose jit cache did not grow — the common,
        load-bearing case the ledger exists to make auditable."""
        if not self.enabled:
            return
        with self._mu:
            row = self._cache_row(bucket)
            if row is not None:
                row["hits"] += 1

    def compile_cache_snapshot(self) -> Dict[str, Dict[str, int]]:
        """Sorted copy of the per-signature ledger (bench diffs the
        before/after of the timed window against this)."""
        with self._mu:
            return {b: dict(r) for b, r in sorted(self._cache.items())}

    # ---------------------------------------------------------- watermarks

    def set_watermark(self, tier: str, nbytes: int) -> None:
        """Live-buffer byte estimate for one resident tier."""
        if not self.enabled or tier not in TIERS:
            return
        with self._mu:
            row = self._mem.get(tier)
            if row is None:
                row = self._mem[tier] = {"bytes": 0, "peak": 0}
            row["bytes"] = int(nbytes)
            row["peak"] = max(row["peak"], int(nbytes))
        _metrics.gauge(
            f'swarm_device_mem_bytes{{tier="{tier}"}}', int(nbytes))

    # ----------------------------------------------------- donation balance

    def note_donated(self, ids: Iterable[int]) -> None:
        """Register buffers about to be donated to XLA (their host
        references must never be read again — the runtime twin of the
        swarmlint donated-arg-reuse rule)."""
        if not self.enabled:
            return
        with self._mu:
            for i in ids:
                if len(self._donated) >= MAX_DONATED_IDS:
                    # FIFO eviction keeps the registry bounded; an
                    # evicted id simply stops being checkable
                    self._donated.pop(next(iter(self._donated)))
                self._donated[int(i)] = True
                self.donations += 1

    def note_retired(self, ids: Iterable[int]) -> None:
        """Balance donated buffers once their rebind landed (the old
        references are provably unreachable)."""
        if not self.enabled:
            return
        with self._mu:
            for i in ids:
                if self._donated.pop(int(i), None) is None:
                    continue
                self.retirements += 1

    def check_live(self, ids: Iterable[int]) -> List[int]:
        """Assert none of ``ids`` is a still-donated buffer; returns the
        violating ids (counted + flight-recorded, never raising — obs
        must not take the data path down)."""
        if not self.enabled:
            return []
        with self._mu:
            bad = [int(i) for i in ids if int(i) in self._donated]
            self.donation_violations += len(bad)
        if bad:
            _metrics.counter("swarm_device_donation_violations",
                             len(bad))
            from .flightrec import flightrec
            flightrec.note(
                f"device donation-balance violation: {len(bad)} "
                f"donated buffer(s) read after donation")
        return bad

    # ------------------------------------------------------------ reading

    def snapshot(self) -> Dict[str, object]:
        """One deterministic document: sorted keys, aggregate ints only
        — the bench-artifact / flightrec-dump / ``/debug/device``
        surface.  Renders on a fresh process (all tables empty)."""
        with self._mu:
            kernel = {f"{b}|{r}": dict(row) for (b, r), row
                      in sorted(self._kernel.items())}
            transfers = {
                d: {reason: dict(row) for reason, row
                    in sorted(table.items())}
                for d, table in sorted(self._transfers.items())}
            cache = {b: dict(r) for b, r in sorted(self._cache.items())}
            mem = {t: dict(r) for t, r in sorted(self._mem.items())}
            return {
                "enabled": self.enabled,
                "kernel": kernel,
                "kernel_overflow": self.kernel_overflow,
                "transfers": transfers,
                "bytes_avoided": self.bytes_avoided,
                "compile_cache": cache,
                "compile_cache_overflow": self.cache_overflow,
                "memory": mem,
                "donation": {
                    "donated": self.donations,
                    "retired": self.retirements,
                    "outstanding": len(self._donated),
                    "violations": self.donation_violations,
                },
            }

    def transfer_totals(self) -> Dict[str, int]:
        """{"h2d": bytes, "d2h": bytes} — the scalar the crossover
        sweep and cfg10 diff around their timed windows."""
        with self._mu:
            return {d: sum(r["bytes"] for r in table.values())
                    for d, table in sorted(self._transfers.items())}

    def sub_plane_rows(self) -> Dict[str, object]:
        """Device-plane sub-rows for ``PlaneStats.report()``: where the
        plane's busy time and queue pressure actually went.  Empty dict
        on a fresh process (render-on-empty discipline)."""
        with self._mu:
            if not self._kernel and not any(self._transfers.values()):
                return {}
            disp = sum(r["dispatches"] for r in self._kernel.values())
            dns = sum(r["dispatch_ns"] for r in self._kernel.values())
            fns = sum(r["d2h_ns"] for r in self._kernel.values())
            cns = sum(r["compile_ns"] for r in self._cache.values())
            hits = sum(r["hits"] for r in self._cache.values())
            comp = sum(r["compiles"] for r in self._cache.values())
            h2d = sum(r["bytes"]
                      for r in self._transfers["h2d"].values())
            d2h = sum(r["bytes"]
                      for r in self._transfers["d2h"].values())
            return {
                "kernel_dispatches": disp,
                "dispatch_s": round(dns / 1e9, 6),
                "d2h_s": round(fns / 1e9, 6),
                "compile_s": round(cns / 1e9, 6),
                "compiles": comp,
                "cache_hits": hits,
                "h2d_bytes": h2d,
                "d2h_bytes": d2h,
                "bytes_avoided": self.bytes_avoided,
            }

    def journey_sub_attribution(self, plane_s: float
                                ) -> Optional[Dict[str, float]]:
        """Device sub-attribution for the journeys' ``planned``
        milestone: split the device ledger's busy time into dispatch /
        D2H / compile shares, clamped against the owning plane's
        seconds.  None when the ledger saw no device work (the
        critical-path report then stays byte-identical to PR 17)."""
        with self._mu:
            dns = sum(r["dispatch_ns"] for r in self._kernel.values())
            fns = sum(r["d2h_ns"] for r in self._kernel.values())
            cns = sum(r["compile_ns"] for r in self._cache.values())
        total = dns + fns + cns
        if total <= 0:
            return None
        out = {
            "dispatch_s": round(dns / 1e9, 9),
            "d2h_s": round(fns / 1e9, 9),
            "compile_s": round(cns / 1e9, 9),
            "dispatch_frac": round(dns / total, 6),
            "d2h_frac": round(fns / total, 6),
            "compile_frac": round(cns / total, 6),
        }
        if plane_s > 0:
            out["of_plane_frac"] = round(
                min(1.0, (total / 1e9) / plane_s), 6)
        return out


# ------------------------------------------------------------- module state
#
# One process-wide ledger, rebound (not cleared) by reset() so a
# save_state capture survives — the planes.py/flightrec lifecycle
# contract shared by every obs singleton.

_state = DeviceTelemetry()


def set_enabled(on: bool) -> None:
    """Toggle the whole ledger (bench's obs-overhead off-half)."""
    _state.enabled = bool(on)


def is_enabled() -> bool:
    return _state.enabled


def note_kernel(bucket: str, route: str, **kw) -> None:
    _state.note_kernel(bucket, route, **kw)


def note_h2d(reason: str, nbytes: int) -> None:
    _state.note_h2d(reason, nbytes)


def note_d2h(reason: str, nbytes: int) -> None:
    _state.note_d2h(reason, nbytes)


def note_d2d(reason: str, nbytes: int) -> None:
    _state.note_d2d(reason, nbytes)


def note_bytes_avoided(nbytes: int) -> None:
    _state.note_bytes_avoided(nbytes)


def note_compile(bucket: str, dt: float, count: int = 1) -> None:
    _state.note_compile(bucket, dt, count)


def note_cache_hit(bucket: str) -> None:
    _state.note_cache_hit(bucket)


def set_watermark(tier: str, nbytes: int) -> None:
    _state.set_watermark(tier, nbytes)


def note_donated(ids: Iterable[int]) -> None:
    _state.note_donated(ids)


def note_retired(ids: Iterable[int]) -> None:
    _state.note_retired(ids)


def check_live(ids: Iterable[int]) -> List[int]:
    return _state.check_live(ids)


def snapshot() -> Dict[str, object]:
    return _state.snapshot()


def compile_cache_snapshot() -> Dict[str, Dict[str, int]]:
    return _state.compile_cache_snapshot()


def transfer_totals() -> Dict[str, int]:
    return _state.transfer_totals()


def sub_plane_rows() -> Dict[str, object]:
    return _state.sub_plane_rows()


def journey_sub_attribution(plane_s: float
                            ) -> Optional[Dict[str, float]]:
    return _state.journey_sub_attribution(plane_s)


def save_state():
    return _state


def restore_state(state) -> None:
    global _state
    _state = state


def reset() -> None:
    """Start fresh (tests, bench epoch, sim scenario entry).  The
    ledger is REBOUND, not cleared in place, so a ``save_state``
    capture survives."""
    global _state
    enabled = _state.enabled
    _state = DeviceTelemetry()
    _state.enabled = enabled
