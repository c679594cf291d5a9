"""Resident node state for the streaming scheduler.

``TorchPlanner._build_columns`` re-densifies the whole NodeSet mirror into
SoA columns: O(cluster) Python work per tick, even when the tick's churn
touched three nodes.  ``ResidentState`` keeps those columns (and the
per-group column precursors: per-service task counts, node platform
hashes, constraint hash columns, spread leaves, failure rows) alive across
ticks and refreshes only the rows the scheduler's ``DeltaTracker`` marked
dirty.  Counterpart of the reference's ``swarmkit_tpu/ops/streaming.py``.

Two tiers of residency:

* **host mirror** -- numpy columns updated row-wise from the NodeInfo
  ground truth.  They feed the per-group kernel inputs and the exact int64
  resource math, so an incremental refresh is byte-identical to a full
  rebuild by construction (same per-row formulas, same row order: appends
  match the NodeSet dict's insertion order; removals demand a full rebuild
  because row index is a placement tie-break key).
* **device columns** -- tensors on the planner's device holding the five
  node-state columns (valid, ready, cpu, mem, total), updated IN PLACE by
  the dirty-row scatter K7 (``kernel.scatter_rows``): the port's form of
  the reference's donated scatter.  A refresh packs its dirty rows into one
  pinned staging buffer and moves it with one non-blocking H2D copy on the
  current stream, then launches K7.  The fused planner seeds its run from
  these columns when they are fresh (``device_carry``); since they are
  updated in place, a consumer that writes (the fused carry) takes a
  device-to-device clone, never the resident tensors themselves.

On a planner mesh (``parallel/sharded.py``) the device tier is split on
the node axis: each shard holds its nb/D rows of the five columns on its
own device, an upload places each shard's slice directly
(``put_resident``), and a refresh packs its dirty rows with their global
indices into one pinned staging buffer, moves it with one H2D and
scatters it with ONE K7 launch over the table of shards, each row landing
in the shard that owns it (``row // local_n``): O(churn) bytes.  A fused
run on the same mesh seeds its split node state from those shards.  A
node bucket that the mesh does not divide keeps the single-device tier
(counted ``mesh_demotions``), as the reference does.

Fallback matrix (every full rebuild is counted; ``streaming_enabled =
False`` on the planner turns the whole plane off):

=====================  =======================================
cold start             first refresh ever (counted ``cold``)
leader handoff         tick epoch != resident epoch -> resync:
                       a successor must rebuild from its own
                       replicated store before trusting rows
node removal / store   row order shifts -> full rebuild
resync
node-bucket overflow   cluster outgrew ``nb`` -> rebuild into
                       the next pow2 bucket
tracker divergence     mirror count != resident count (a missed
                       hook) -> rebuild, never trust drifted rows
mesh shard-count       planner mesh resized -> the resident
change                 shards have the wrong layout; device tier
                       re-uploads (host mirror stays valid)
mesh teardown          planner mesh removed -> device tier
                       demotes to single-device residency
=====================  =======================================

Nothing here hides a device fault: an upload, copy or launch error
propagates and fails the tick.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.types import NodeAvailability, NodeState
from ..obs import devicetelemetry as _devtel
from ..obs.trace import tracer
from ..utils.metrics import registry as _metrics
from .densify import SENTINEL, con_column_key, n_bucket, split_hash
from .hashing import str_hash
from .kernel import (
    SCATTER_SLOT_BYTES, UploadStage, scatter_rows, scatter_views,
)

_REFRESH_TIMER = _metrics.timer("swarm_streaming_refresh_latency")

#: dirty-row scatter buckets (a bounded set of staging shapes); a refresh
#: dirtier than the top bucket re-uploads the columns wholesale
D_BUCKETS = (16, 256, 4096)

#: per-service column cache bound (FIFO eviction -- oldest-built goes
#: first; deterministic): steady-state workloads cycle a few dozen
#: services, and an evicted column simply rebuilds on next demand
SVC_CACHE_CAP = 64
CON_CACHE_CAP = 32
LEAF_CACHE_CAP = 16

_UNSET = object()


def _d_bucket(d: int) -> Optional[int]:
    for b in D_BUCKETS:
        if d <= b:
            return b
    return None


class _ConColumn:
    """One cached constraint-key hash column: per-node value hashes (hi/lo
    int32) plus how many nodes' values were unknown (the whole constraint
    then disables with the sentinel, matching ``densify.fill_constraints``)."""

    __slots__ = ("hash", "none_count")

    def __init__(self, nb: int):
        self.hash = np.zeros((2, nb), np.int32)
        self.none_count = 0


class _ScatterStage(UploadStage):
    """The packed staging buffer of one scatter bucket, which K7 reads on
    the device."""

    __slots__ = ("db",)

    def __init__(self, db: int, device: torch.device):
        super().__init__(SCATTER_SLOT_BYTES * db, device)
        self.db = db

    def fill(self, rows: List[int], nb: int, cols) -> None:
        """Pack ``rows`` of the host columns (valid, ready, cpu, mem,
        total); the slots past them are pads (index ``nb``)."""
        idx, u_valid, u_ready, u_cpu, u_mem, u_total = scatter_views(
            self.host_view(), self.db)
        d = len(rows)
        r = np.asarray(rows, np.int64)
        idx[:d] = r
        idx[d:] = nb
        for view, col in zip((u_valid, u_ready, u_cpu, u_mem, u_total),
                             cols):
            view[:d] = col[r]
            view[d:] = 0


class ResidentState:
    """Persistent densified node state, refreshed O(churn) per tick.

    ``device`` is the planner's torch device: the device tier lives
    there (on the CPU, the tensors are copies of the host mirror, and K7's
    plain version updates them).  ``mesh`` (a ``parallel.NodeMesh``)
    splits the device tier over its shards when it divides the node
    bucket."""

    def __init__(self, node_value: Callable, device, mesh=None):
        #: planner._node_value -- constraint-key lookup per NodeInfo
        self._node_value = node_value
        self.device = torch.device(device)
        #: planner mesh; the device tier is split over it while
        #: ``_mesh_active``
        self.mesh = mesh
        self._mesh_active = False
        self.infos: Optional[List] = None
        self.row_of: Dict[str, int] = {}
        self.n = 0
        self.nb = 0
        self.valid = self.ready = None
        self.cpu = self.mem = self.total = None
        self.os_hash = self.arch_hash = None
        # platform hashes are maintained LAZILY: workloads without
        # platform requirements never pay the 2x str_hash per row
        self._want_platforms = False
        #: per-row node ids and task dicts, in row order: the planner's
        #: apply reads them instead of building both lists per group
        self.node_ids: List[str] = []
        self.task_dicts: List[dict] = []
        #: rows whose NodeInfo has a (possibly expired) failure record --
        #: mirrors the ``if info.recent_failures`` guard of the per-group
        #: failure loop, so the fill visits the same rows it would
        self.fail_rows: Dict[int, None] = {}
        self.svc_cols: Dict[str, np.ndarray] = {}
        self.con_cols: Dict[str, _ConColumn] = {}
        self.leaf_cols: Dict[str, Tuple[np.ndarray, Dict[str, int],
                                        List[str]]] = {}
        self.epoch = _UNSET
        self._tracker = None
        # device tier: (valid, ready, cpu, mem, total) tensors -- on a
        # mesh each column a tuple of per-shard tensors -- or None
        self.dev: Optional[tuple] = None
        self._dev_version = -1
        # the scatter's staging buffers, one a (bucket, device)
        self._stages: Dict[tuple, _ScatterStage] = {}
        # rows recomputed by a HOST-ONLY absorb (mid-tick accessors): the
        # device tier has not seen them yet -- the next device sync must
        # scatter them too, or it would stamp itself fresh while silently
        # missing those rows' updates
        self._pending_dev_rows: Dict[int, None] = {}
        self.stats = {"colds": 0, "resyncs": 0, "fallbacks": 0,
                      "incremental": 0, "full": 0, "rows": 0,
                      "dirty_frac": 0.0, "device_syncs": 0,
                      "svc_evictions": 0, "bytes_avoided": 0,
                      "shard_syncs": 0, "mesh_demotions": 0,
                      "scatters": 0}

    # ------------------------------------------------------------ mesh tier

    def set_mesh(self, mesh) -> None:
        """(Re)wire the planner mesh.  A layout change while device
        tensors exist -- mesh resized ("shard-count") or removed
        ("mesh-teardown") -- drops the device tier for a counted re-upload
        on the next sync; the host mirror stays valid, so no host rebuild
        happens."""
        if mesh is self.mesh:
            return
        self.mesh = mesh
        if self.dev is None and not self._mesh_active:
            return
        reason = "mesh-teardown" if mesh is None else "shard-count"
        self.stats["resyncs"] += 1
        _metrics.counter(f'swarm_streaming_resyncs{{reason="{reason}"}}')
        self.dev = None
        self._mesh_active = False
        self._dev_version = -1

    def _mesh_for(self):
        """The usable mesh for the device tier: set, more than one shard,
        and dividing the node bucket (pow2 buckets and mesh sizes make that
        the norm); otherwise None (the single-device tier)."""
        mesh = self.mesh
        if mesh is None or not self.nb:
            return None
        d = mesh.size
        if d <= 1 or self.nb % d:
            return None
        return mesh

    def _mesh_devices(self) -> int:
        return self.mesh.size if self._mesh_active and self.mesh is not None \
            else 0

    # ------------------------------------------------------------- refresh

    def refresh(self, sched) -> list:
        """Bring the resident columns up to date with the scheduler's
        mirror and sync the device tier; returns the planner cols list
        ``[infos, n, nb, valid, ready, cpu, mem, total]``.  O(dirty)
        when incremental, O(cluster) on the counted fallbacks."""
        t0 = time.perf_counter()
        with tracer.span("plan.refresh", "plan"):
            rows = self._absorb(sched, device=True, tick=True)
        _REFRESH_TIMER.observe(time.perf_counter() - t0)
        if rows is not None and self.n:
            frac = len(rows) / float(self.n)
            self.stats["dirty_frac"] = frac
            _metrics.gauge("swarm_streaming_dirty_frac", frac)
        return self.cols()

    def absorb(self, sched) -> None:
        """Host-only incremental catch-up (mid-tick accessors call this
        before reading cached columns).  Cheap no-op when the tracker has
        nothing pending."""
        self._absorb(sched, device=False)

    def cols(self) -> list:
        return [self.infos, self.n, self.nb, self.valid, self.ready,
                self.cpu, self.mem, self.total]

    def _full(self, sched, reason: str, epoch, device: bool,
              count: Optional[str] = None) -> None:
        """A counted full rebuild, the epoch it serves, and (with
        ``device``) a fresh upload of the device tier."""
        self._rebuild(sched, reason, count=count)
        self.epoch = epoch
        if device:
            self._device_upload()

    def _absorb(self, sched, device: bool,
                tick: bool = False) -> Optional[list]:
        # the planner's _streaming_for serves only schedulers that carry
        # the delta feed
        tracker = sched.delta
        epoch = getattr(sched, "_tick_epoch", None)
        if self._tracker is not None and tracker is not self._tracker:
            # a different scheduler's mirror: its mutations were never
            # observed here -- never trust the resident rows
            self._tracker = tracker
            tracker.drain()
            self._full(sched, "tracker-swap", epoch, device,
                       count="fallbacks")
            return None
        self._tracker = tracker
        if not tracker.pending and self.infos is not None \
                and epoch == self.epoch:
            if tick:
                self.stats["incremental"] += 1
                self.stats["dirty_frac"] = 0.0
                _metrics.counter(
                    'swarm_streaming_ticks{mode="incremental"}')
            if device:
                self._device_sync([])   # flushes any host-only backlog
            return []
        dirty, added, full_reason = tracker.drain()
        if self.infos is None:
            full_reason = full_reason or "cold"
        if full_reason is not None:
            self._full(sched, full_reason, epoch, device)
            return None
        if self.epoch is not _UNSET and epoch != self.epoch:
            # leader handoff (or the first fenced tick after an unfenced
            # one): the resident state was built under another reign --
            # rebuild from the replicated store before trusting it
            self._full(sched, "epoch", epoch, device, count="resyncs")
            return None
        node_set = sched.node_set
        rows: List[int] = []
        for nid in added:
            if nid in self.row_of:
                self._full(sched, "divergence", epoch, device,
                           count="fallbacks")
                return None
            info = node_set.nodes.get(nid)
            if info is None or self.n >= self.nb:
                reason = "overflow" if info is not None else "divergence"
                self._full(sched, reason, epoch, device, count="fallbacks")
                return None
            i = self.n
            self.n += 1
            self.row_of[nid] = i
            self.infos.append(info)
            self.node_ids.append(nid)
            self.task_dicts.append(info.tasks)
            self.valid[i] = True
            self._recompute_row(i, info, append=True)
            rows.append(i)
        if self.n != len(node_set.nodes):
            self._full(sched, "divergence", epoch, device, count="fallbacks")
            return None
        for nid in dirty:
            i = self.row_of.get(nid)
            if i is None:
                continue   # marked after removal was already demanded
            info = node_set.nodes.get(nid)
            if info is not self.infos[i]:
                # the NodeInfo OBJECT was swapped (not mutated in place):
                # the resident row mirrors a dead object
                self._full(sched, "divergence", epoch, device,
                           count="fallbacks")
                return None
            self._recompute_row(i, info)
            rows.append(i)
        if tick:
            self.stats["incremental"] += 1
            _metrics.counter('swarm_streaming_ticks{mode="incremental"}')
        self.stats["rows"] += len(rows)
        if rows:
            _metrics.counter("swarm_streaming_rows", len(rows))
        if device:
            self._device_sync(rows)
        else:
            # host-only drain: the device tier is now behind for these
            # rows -- queue them for the next device sync
            for i in rows:
                self._pending_dev_rows[i] = None
        return rows

    # ------------------------------------------------------------ row math

    def _recompute_row(self, i: int, info, append: bool = False) -> None:
        """One row from the NodeInfo ground truth -- the exact per-row
        formulas ``_build_columns`` / ``node_platform_hashes`` apply, so an
        incremental row equals its full-rebuild value bit for bit."""
        node = info.node
        self.ready[i] = (
            node.status.state == NodeState.READY
            and node.spec.availability == NodeAvailability.ACTIVE)
        self.cpu[i] = info.available_resources.nano_cpus
        self.mem[i] = info.available_resources.memory_bytes
        self.total[i] = info.active_tasks_count
        if self._want_platforms:
            self._recompute_platform_row(i, info)
        if info.recent_failures:
            self.fail_rows[i] = None
        else:
            self.fail_rows.pop(i, None)
        by_svc = info.active_tasks_count_by_service
        for sid, col in self.svc_cols.items():
            col[i] = by_svc.get(sid, 0)
        for key in list(self.con_cols):
            self._recompute_con_row(key, i, info)
        for desc_key in list(self.leaf_cols):
            self._recompute_leaf_row(desc_key, i, info, append)

    def _recompute_platform_row(self, i: int, info) -> None:
        desc = info.node.description
        if desc and desc.platform:
            from ..scheduler.filters import normalize_arch
            self.os_hash[:, i] = split_hash(str_hash(desc.platform.os))
            self.arch_hash[:, i] = split_hash(
                str_hash(normalize_arch(desc.platform.architecture)))
        else:
            self.os_hash[:, i] = SENTINEL
            self.arch_hash[:, i] = SENTINEL

    def _recompute_con_row(self, key: str, i: int, info) -> None:
        entry = self.con_cols[key]
        v = self._node_value(info, key)
        # real value hashes are split into non-negative halves, so the
        # (-1, -1) sentinel doubles as the per-row "was unknown" flag
        was_none = bool(entry.hash[0, i] == SENTINEL[0]
                        and entry.hash[1, i] == SENTINEL[1])
        if v is None:
            entry.hash[:, i] = SENTINEL
            if not was_none:
                entry.none_count += 1
        else:
            entry.hash[:, i] = split_hash(str_hash(v))
            if was_none:
                entry.none_count -= 1

    def _recompute_leaf_row(self, desc_key: str, i: int, info,
                            append: bool) -> None:
        from ..scheduler.nodeset import _pref_value
        entry = self.leaf_cols.get(desc_key)
        if entry is None:
            return   # already invalidated earlier in this absorb pass
        leaf, ids, values = entry
        v = _pref_value(info, desc_key) or ""
        if append:
            values.append(v)
            leaf[i] = ids.setdefault(v, len(ids))
            return
        if values[i] == v:
            return
        # a value change can renumber OTHER rows (leaf ids are
        # first-appearance ordered in row order, and branch index is a
        # spread tie-break the kernels read): drop the cached column -- it
        # rebuilds lazily, exactly as a full rebuild would number it
        del self.leaf_cols[desc_key]

    # ------------------------------------------------------- full rebuild

    def _rebuild(self, sched, reason: str, count: Optional[str] = None
                 ) -> None:
        if count is None:
            count = ("colds" if reason == "cold"
                     else "resyncs" if reason == "epoch"
                     else "fallbacks")
        self.stats[count] += 1
        self.stats["full"] += 1
        self.stats["dirty_frac"] = 1.0
        _metrics.counter('swarm_streaming_ticks{mode="full"}')
        _metrics.counter(f'swarm_streaming_resyncs{{reason="{reason}"}}')
        node_set = sched.node_set
        infos = list(node_set.nodes.values())
        n = len(infos)
        nb = n_bucket(max(n, 1))
        self.infos = infos
        self.n = n
        self.nb = nb
        self.row_of = {info.node.id: i for i, info in enumerate(infos)}
        self.node_ids = [info.node.id for info in infos]
        self.task_dicts = [info.tasks for info in infos]
        self.valid = np.zeros(nb, bool)
        self.valid[:n] = True
        self.ready = np.zeros(nb, bool)
        self.cpu = np.zeros(nb, np.int64)
        self.mem = np.zeros(nb, np.int64)
        self.total = np.zeros(nb, np.int32)
        self.os_hash = np.zeros((2, nb), np.int32)
        self.arch_hash = np.zeros((2, nb), np.int32)
        self.fail_rows = {}
        # column caches rebuild lazily at their new width; a full device
        # upload covers every row, so the host-only backlog dies
        self.svc_cols = {}
        self.con_cols = {}
        self.leaf_cols = {}
        self._pending_dev_rows = {}
        for i, info in enumerate(infos):
            self._recompute_row(i, info)
        _devtel.set_watermark("host_mirror", _devtel.tree_nbytes(
            (self.valid, self.ready, self.cpu, self.mem, self.total,
             self.os_hash, self.arch_hash)))

    # -------------------------------------------------- cached precursors

    def svc_tasks_col(self, sched, service_id: str) -> np.ndarray:
        """Per-service active-task column (read-only to callers)."""
        self.absorb(sched)
        col = self.svc_cols.get(service_id)
        if col is None:
            if len(self.svc_cols) >= SVC_CACHE_CAP:
                self.svc_cols.pop(next(iter(self.svc_cols)))
                self.stats["svc_evictions"] += 1
            col = np.zeros(self.nb, np.int32)
            for i, info in enumerate(self.infos):
                c = info.active_tasks_count_by_service.get(service_id, 0)
                if c:
                    col[i] = c
            self.svc_cols[service_id] = col
        return col

    def fill_failures(self, failures: np.ndarray, ts: float, t) -> None:
        """Failure down-weights for one group (rows with failure records
        only -- the same rows the O(N) guard loop would visit)."""
        infos = self.infos
        for i in self.fail_rows:
            failures[i] = infos[i].count_recent_failures(ts, t)

    def platform_hashes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Resident node platform hash columns; built in full on first
        demand (a platform-requiring group appeared), row-maintained from
        then on."""
        if not self._want_platforms:
            self._want_platforms = True
            for i, info in enumerate(self.infos):
                self._recompute_platform_row(i, info)
        return self.os_hash, self.arch_hash

    def fill_constraints(self, sched, constraints, con_hash, con_op,
                         con_exp) -> None:
        """Streaming twin of ``densify.fill_constraints``: per-key
        node-value hash columns are resident and refreshed per dirty row,
        so a group build is a vectorized copy instead of an O(N) Python
        hashing loop."""
        self.absorb(sched)
        n = self.n
        for ci, con in enumerate(constraints):
            col_key, expected = con_column_key(con)
            if col_key is None:
                # malformed node.ip: never matches, regardless of op
                con_op[ci] = 0
                con_exp[ci] = SENTINEL
                continue
            entry = self.con_cols.get(col_key)
            if entry is None:
                if len(self.con_cols) >= CON_CACHE_CAP:
                    del self.con_cols[next(iter(self.con_cols))]
                entry = _ConColumn(self.nb)
                self.con_cols[col_key] = entry
                for i, info in enumerate(self.infos):
                    self._recompute_con_row(col_key, i, info)
            if entry.none_count > 0:
                # unknown key on some node: node never matches, regardless
                # of op (fill_constraints parity)
                con_op[ci] = 0
                con_exp[ci] = SENTINEL
                continue
            con_hash[ci, :, :n] = entry.hash[:, :n]
            con_op[ci] = con.operator
            con_exp[ci] = split_hash(str_hash(expected))

    def flat_leaf(self, sched, descriptor: str) -> Tuple[np.ndarray, int]:
        """Streaming twin of ``densify.flat_leaf`` -- leaf ids stay
        first-appearance ordered in ROW order (a tie-break the kernels
        read), so value changes that would renumber rebuild the column."""
        self.absorb(sched)
        entry = self.leaf_cols.get(descriptor)
        if entry is None:
            from ..scheduler.nodeset import _pref_value
            if len(self.leaf_cols) >= LEAF_CACHE_CAP:
                self.leaf_cols.pop(next(iter(self.leaf_cols)))
            leaf = np.zeros(self.nb, np.int32)
            ids: Dict[str, int] = {}
            values: List[str] = []
            for i, info in enumerate(self.infos):
                v = _pref_value(info, descriptor) or ""
                values.append(v)
                leaf[i] = ids.setdefault(v, len(ids))
            entry = (leaf, ids, values)
            self.leaf_cols[descriptor] = entry
        leaf, ids, _values = entry
        return leaf, max(len(ids), 1)

    # --------------------------------------------------------- device tier

    def _host_cols(self) -> tuple:
        return (self.valid, self.ready, self.cpu, self.mem, self.total)

    def _stamp(self) -> None:
        self._dev_version = self._tracker.version \
            if self._tracker is not None else -1

    def _device_upload(self, reason: str = "cold_build") -> None:
        """Fresh device copies of the five node-state columns (full
        rebuild, or a delta too wide for the scatter buckets).  Covers
        every row, so the host-only backlog is consumed by definition.  On
        a mesh each shard receives its own slice."""
        self._pending_dev_rows = {}
        mesh = self._mesh_for()
        if mesh is not None:
            from ..parallel.sharded import put_resident
            self.dev = put_resident(self._host_cols(), mesh)
            self._mesh_active = True
        else:
            if self.mesh is not None:
                self.stats["mesh_demotions"] += 1
            self.dev = tuple(torch.from_numpy(a).to(self.device, copy=True)
                             for a in self._host_cols())
            self._mesh_active = False
        nbytes = _devtel.tree_nbytes(self._host_cols())
        _devtel.note_h2d(reason, nbytes)
        _devtel.set_watermark("device_resident", nbytes)
        self.stats["device_syncs"] += 1
        self._stamp()

    def _device_sync(self, rows: List[int]) -> None:
        """Scatter dirty rows -- plus any host-only backlog -- into the
        resident device columns with K7; wide deltas re-upload
        wholesale."""
        if self.dev is None:
            self._device_upload()
            return
        mesh = self._mesh_for() if self._mesh_active else None
        if self._mesh_active and mesh is None:
            # the mesh became unusable under live shards (the bucket regrew
            # to a width it does not divide): re-place
            self.dev = None
            self._device_upload()
            return
        if self._pending_dev_rows:
            backlog = self._pending_dev_rows
            self._pending_dev_rows = {}
            for i in rows:
                backlog[i] = None
            rows = list(backlog)
        if not rows:
            self._stamp()
            return
        db = _d_bucket(len(rows))
        if db is None:
            self._device_upload(reason="wide_reupload")
            return
        # one stage a (bucket, card); on a mesh K7 writes each global row
        # into the shard that owns it
        key = (db, self.device if mesh is None else mesh.devices[0])
        stage = self._stages.get(key)
        if stage is None:
            stage = self._stages[key] = _ScatterStage(*key)
        t0 = time.perf_counter()
        stage.fill(rows, self.nb, self._host_cols())
        scatter_rows(self.dev, stage.upload())
        dt = time.perf_counter() - t0
        if mesh is None:
            reason, label = "dirty_scatter", f"stream_nb{self.nb}_d{db}"
        else:
            reason = "shard_scatter"
            label = f"stream_nb{self.nb}_d{db}_x{mesh.size}"
            self.stats["shard_syncs"] += 1
        staged = SCATTER_SLOT_BYTES * db
        _devtel.note_h2d(reason, staged)
        # what a non-streaming tick would have shipped instead: the full
        # five-column upload, minus what the scatter staged
        avoided = max(0, _devtel.tree_nbytes(self._host_cols()) - staged)
        _devtel.note_bytes_avoided(avoided)
        self.stats["bytes_avoided"] += avoided
        _devtel.note_kernel(label, "scatter", dispatch_s=dt,
                            node_rows=len(rows))
        self.stats["scatters"] += 1
        self.stats["device_syncs"] += 1
        self._stamp()

    def device_carry(self):
        """The resident device columns (valid, ready, cpu, mem, total) --
        only when they provably mirror the host columns (no marks since
        the last sync); None otherwise.  On a mesh each column is a tuple
        of per-shard tensors.  K7 updates them in place, so a consumer
        that writes must clone them first."""
        if self.dev is None or self._tracker is None:
            return None
        if self._tracker.version != self._dev_version \
                or self._tracker.pending:
            return None
        return self.dev

    # --------------------------------------------------------------- bench

    def snapshot(self) -> Dict[str, object]:
        """Artifact-shaped stats: the ``streaming_*`` fields."""
        return {
            "enabled": True,
            "dirty_frac": round(self.stats["dirty_frac"], 4),
            "resyncs": self.stats["resyncs"],
            "fallbacks": self.stats["fallbacks"],
            "incremental_ticks": self.stats["incremental"],
            "full_ticks": self.stats["full"],
            "rows": self.stats["rows"],
            "device_syncs": self.stats["device_syncs"],
            "bytes_avoided": self.stats["bytes_avoided"],
            "shard_syncs": self.stats["shard_syncs"],
            "mesh_devices": self._mesh_devices(),
        }
