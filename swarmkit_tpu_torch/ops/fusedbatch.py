"""Fused many-service batch builder: one plan per chunk of groups.

The per-group route pays one densify, one launch sequence and one D2H
round-trip per (service, spec-version) group, so a tick of G services
costs G round-trips and G Python column builds.  This module packs an
ordered run of *fusable* groups into padded, shape-bucketed chunks for
``ops.kernel.plan_fused_packed``: shared node columns are densified once,
per-group columns land in bucketed group slots, and the groups' sequential
semantics (group g sees groups 0..g-1 applied) ride the device carry
instead of host round-trips.  Placements are identical to the per-group
route by construction: the carry updates are exactly the per-group apply,
restricted to the signals the kernels read.

A run is split into CHUNKS (``CHUNK_GROUPS`` groups each, always >= 2
chunks per run) so the pipelined scheduler can overlap chunk i+1's device
work with chunk i's host apply and commit; the carry stays on the device
from chunk to chunk and is never fetched.

Fusability is stricter than device-ability: a group that densifies fine
per-group but carries signals the fused carry does not model (generic
resources, host-published ports, multi-level spread trees,
shutdown-marked stragglers) breaks the run and takes the per-group route
-- identical placements, one extra round-trip.  A bucket that cannot hold
the run, or a cluster with no node, degrades the same way.

Resource arithmetic is exact: the carry holds int64 nano-cpus and bytes,
and K1F's floor divisions match the host densifier's numpy ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..models.objects import Task
from ..models.types import PublishMode, TaskState
from ..scheduler import constraint as constraint_mod
from ..scheduler import strategy as strategy_mod
from .densify import (
    CC_BUCKETS, P_BUCKETS, bucket, fill_constraints, fill_platforms,
    flat_leaf, group_quota_blocked, l_bucket, needs_plugins,
    node_platform_hashes, plugin_mask, pow2_bucket,
)
from .kernel import (
    K_CLAMP, FusedCarry, FusedGroups, FusedShared, FusedStrategy,
)

#: groups per fused chunk
CHUNK_GROUPS = 4


def chunk_sizes(g: int, chunk: int = CHUNK_GROUPS) -> List[int]:
    """Split ``g`` groups into chunk sizes.  A run always yields >= 2
    chunks (when it has >= 2 groups) so the pipelined tick has a chunk
    of commits to overlap the next chunk's device work with."""
    chunk = max(1, chunk)
    if g <= 1:
        return [g] if g else []
    if g <= chunk:
        first = (g + 1) // 2
        return [first, g - first]
    out = []
    rest = g
    while rest > 0:
        take = min(chunk, rest)
        out.append(take)
        rest -= take
    return out


# ----------------------------------------------------------- fusability

class GroupSpec:
    """One fusable group's parsed routing facts, captured at probe time
    and reused by the builder and the apply phase."""

    __slots__ = ("group", "t", "k", "constraints", "platforms",
                 "pref_descriptor", "wants_plugins", "cpu_d", "mem_d",
                 "maxrep", "slot", "quota_blocked", "sid", "sname",
                 "weights")

    def __init__(self, group: Dict[str, Task], t: Task, k: int,
                 constraints, platforms, pref_descriptor, wants_plugins,
                 cpu_d: int, mem_d: int, maxrep: int,
                 quota_blocked: bool = False, sid: int = 0,
                 sname: str = "", weights=None):
        self.group = group
        self.t = t
        self.k = k
        self.constraints = constraints
        self.platforms = platforms
        self.pref_descriptor = pref_descriptor
        self.wants_plugins = wants_plugins
        self.cpu_d = cpu_d
        self.mem_d = mem_d
        self.maxrep = maxrep
        self.slot = 0    # service slot, assigned at build time
        # frozen tenant-quota admission verdict (group_quota_blocked):
        # True builds an all-False quota mask row for this group
        self.quota_blocked = quota_blocked
        # strategy routing facts: sid 0 = spread; non-spread groups
        # take their strategy's launch sequence inside the fused chunk
        self.sid = sid
        self.sname = sname
        self.weights = weights   # i32[4] (weighted strategy) or None


def probe_group(planner, sched,
                group: Dict[str, Task]) -> Optional[GroupSpec]:
    """Fusability check for one group: everything ``dispatch_group``
    would device-plan MINUS the signals the fused carry does not model
    (generic resources, host-published ports, multi-level spread,
    shutdown-marked stragglers).  None = the group breaks the run and
    takes the per-group path."""
    t = next(iter(group.values()))
    if not planner._supported(t):
        return None
    sinfo = strategy_mod.resolve(strategy_mod.strategy_of(t))
    if sinfo is None:
        # unknown strategy name: the host path serves it through the
        # spread tree and counts the strategy fallback
        return None
    flat = sinfo.sid != strategy_mod.STRAT_SPREAD
    k = len(group)
    if k == 0 or k > K_CLAMP:
        return None
    placement = t.spec.placement
    # non-spread strategies own the scoring stage and ignore spread
    # preferences entirely (the per-group route plans them flat too)
    prefs = [] if flat else \
        [p for p in (placement.preferences if placement else [])
         if p.spread]
    if len(prefs) > 1:
        return None    # multi-level spread: per-group hier path
    res = t.spec.resources.reservations if t.spec.resources else None
    if res and res.generic:
        return None    # per-task claim bookkeeping: per-group path
    if t.endpoint and any(p.publish_mode == PublishMode.HOST
                          and p.published_port
                          for p in t.endpoint.ports):
        return None    # cross-group port claims: per-group path
    if any(tk.desired_state > TaskState.COMPLETE
           for tk in group.values()):
        return None    # batched mirror counting needs active totals
    constraints = []
    if placement and placement.constraints:
        try:
            constraints = constraint_mod.parse(placement.constraints)
        except constraint_mod.InvalidConstraint:
            constraints = []
    if bucket(len(constraints), CC_BUCKETS) is None:
        return None    # constraint-slot overflow: per-group -> host
    platforms = placement.platforms if placement else []
    if bucket(max(len(platforms), 1), P_BUCKETS) is None:
        return None
    return GroupSpec(
        group, t, k, constraints, platforms,
        prefs[0].spread.spread_descriptor if prefs else None,
        needs_plugins(t),
        int(res.nano_cpus) if res else 0,
        int(res.memory_bytes) if res else 0,
        placement.max_replicas if placement else 0,
        quota_blocked=group_quota_blocked(sched, t),
        sid=sinfo.sid, sname=sinfo.name,
        weights=(strategy_mod.weights_of(t)
                 if sinfo.uses_weights else None))


# ------------------------------------------------------------ run builder

class FusedChunk:
    """One dispatch unit of a fused run."""

    __slots__ = ("start", "count", "gb", "groups", "strat", "sids",
                 "pending", "tasks", "t0")

    def __init__(self, start: int, count: int, gb: int,
                 groups: FusedGroups, tasks: int, strat=None):
        self.start = start
        self.count = count
        self.gb = gb
        self.groups = groups   # np-backed FusedGroups; dropped at dispatch
        self.strat = strat     # np-backed FusedStrategy or None (spread)
        # each slot's strategy id, on the host: picks its launch sequence
        self.sids = [int(v) for v in strat.sid] if strat is not None \
            else [strategy_mod.STRAT_SPREAD] * gb
        self.pending = None    # the result rows' D2H (kernel.PendingFetch)
        self.tasks = tasks
        self.t0 = 0.0


class FusedRun:
    """A dispatched fused batch: chunks, device carry, and everything
    the apply phase needs."""

    __slots__ = ("sched", "specs", "cols", "shared", "carry", "chunks",
                 "next_dispatch", "next_fetch", "last_fetch_end", "L",
                 "nb", "cc", "pb", "sb", "has_quota", "has_strat",
                 "aborted", "dispatch_dead")

    def __init__(self, sched, specs, cols, shared, carry, chunks,
                 L, nb, cc, pb, sb, has_quota=False, has_strat=False):
        self.sched = sched
        self.specs = specs
        self.cols = cols
        self.shared = shared
        self.carry = carry
        self.chunks = chunks
        self.next_dispatch = 0
        self.next_fetch = 0
        self.last_fetch_end = 0.0   # perf_counter of the last fetch
        self.L = L
        self.nb = nb
        self.cc = cc
        self.pb = pb
        self.sb = sb
        self.has_quota = has_quota
        self.has_strat = has_strat
        self.aborted = False
        self.dispatch_dead = False   # a chunk's dispatch failed

    @property
    def n_groups(self) -> int:
        return len(self.specs)

    def bucket_label(self, chunk: FusedChunk) -> str:
        """Stable name for one fused chunk shape (the device-telemetry
        ledger's bucket)."""
        q = "_q1" if self.has_quota else ""
        m = "_mx1" if self.has_strat else ""
        return (f"fused_g{chunk.gb}_nb{self.nb}_cc{self.cc}"
                f"_p{self.pb}_L{self.L}_s{self.sb}{q}{m}")


def build_run(planner, sched, specs: List[GroupSpec]
              ) -> Optional[FusedRun]:
    """Densify an ordered run of fusable groups into one fused batch.

    Returns None when the cluster has no valid nodes or a shared bucket
    cannot hold the run -- the caller falls back to the per-group path
    (same placements, amortization lost)."""
    t0 = specs[0].t
    cols = planner._densify(sched, t0)
    infos, n, nb, valid, ready, cpu, mem, total = cols
    if n == 0:
        return None
    # resident fast paths (ops/streaming.py): per-service base counts,
    # platform hashes, failure rows and flat leaves come from the planner's
    # row-maintained resident caches when these ARE the resident columns
    # (identity-guarded); the loops below remain the tracker-less path
    st = planner._resident_for(cols)

    # ---- shared buckets across the run
    cc = max(bucket(len(sp.constraints), CC_BUCKETS) for sp in specs)
    pb = max(bucket(max(len(sp.platforms), 1), P_BUCKETS)
             for sp in specs)

    # ---- service slots (groups of one service share a slot so the
    # carry's per-service accumulator levels them together)
    slot_map: Dict[str, int] = {}
    for sp in specs:
        sp.slot = slot_map.setdefault(sp.t.service_id, len(slot_map))
    sb = pow2_bucket(len(slot_map))

    svc0 = np.zeros((sb, nb), np.int32)
    if st is not None:
        for sid, s in slot_map.items():
            svc0[s] = st.svc_tasks_col(sched, sid)
    else:
        for i, info in enumerate(infos):
            by_svc = info.active_tasks_count_by_service
            if not by_svc:
                continue
            for sid, c in by_svc.items():
                s = slot_map.get(sid)
                if s is not None and c:
                    svc0[s, i] = c

    if any(sp.platforms for sp in specs):
        if st is not None:
            os_hash, arch_hash = st.platform_hashes()
        else:
            os_hash, arch_hash = node_platform_hashes(infos, nb)
    else:
        os_hash = np.zeros((2, nb), np.int32)
        arch_hash = np.zeros((2, nb), np.int32)

    # ---- spread leaves (flat; multi-level trees never fuse) + shared L
    ts = planner.fail_ts()   # tick-frozen: parity with the per-group path
    fail_idx = list(st.fail_rows) if st is not None else \
        [i for i, info in enumerate(infos) if info.recent_failures]
    leaves: List[Optional[np.ndarray]] = []
    L = 1
    for sp in specs:
        if sp.pref_descriptor is not None:
            if st is not None:
                leaf, n_values = st.flat_leaf(sched, sp.pref_descriptor)
            else:
                leaf, n_values = flat_leaf(infos, nb, sp.pref_descriptor)
            leaves.append(leaf)
            L = max(L, l_bucket(n_values))
        else:
            leaves.append(None)

    shared = FusedShared(valid=valid, ready=ready, os_hash=os_hash,
                         arch_hash=arch_hash, svc0=svc0)
    # carry snapshot: int64 resource columns (exact math on device),
    # int32 totals; svc placements accumulate from zero within the run
    carry = FusedCarry(
        total=total.copy(), cpu=cpu.copy(), mem=mem.copy(),
        svc_acc=np.zeros((sb, nb), np.int32))

    # ---- chunk assembly.  Quota mask rows are built for the WHOLE run
    # when ANY group in it is quota-blocked (one shape per run); a run
    # with no blocked group ships quota_ok=None (K1 reads no quota column).
    has_quota = any(sp.quota_blocked for sp in specs)
    # Strategy-mixed runs carry per-group strategy ids + weighted terms
    # and ONE run-wide learned-scorer parameter set (all groups share the
    # deployed scorer).  Spread-only runs ship strat=None.
    has_strat = any(sp.sid for sp in specs)
    if has_strat:
        if any(sp.sid == strategy_mod.STRAT_LEARNED for sp in specs):
            lw1, lb1, lw2, lb2 = strategy_mod.learned_params()
            lw1 = np.asarray(lw1, np.int32)
            lb1 = np.asarray(lb1, np.int32)
            lw2 = np.asarray(lw2, np.int32)
            lb2 = np.asarray(lb2, np.int32)
        else:
            f = len(strategy_mod.MLP_FEATURES)
            lw1 = np.zeros((f, 1), np.int32)
            lb1 = np.zeros(1, np.int32)
            lw2 = np.zeros(1, np.int32)
            lb2 = np.zeros((), np.int32)
    chunks: List[FusedChunk] = []
    start = 0
    for count in chunk_sizes(len(specs)):
        gb = pow2_bucket(count)
        k = np.zeros(gb, np.int32)
        slot = np.zeros(gb, np.int32)
        maxrep = np.zeros(gb, np.int32)
        cpu_d = np.zeros(gb, np.int64)
        mem_d = np.zeros(gb, np.int64)
        con_hash = np.zeros((gb, cc, 2, nb), np.int32)
        con_op = np.full((gb, cc), 2, np.int32)
        con_exp = np.zeros((gb, cc, 2), np.int32)
        plat = np.full((gb, pb, 4), -1, np.int32)
        failures = np.zeros((gb, nb), np.int32)
        leaf = np.zeros((gb, nb), np.int32)
        extra = np.ones((gb, nb), bool)
        quota = np.ones((gb, nb), bool) if has_quota else None
        sid = np.zeros(gb, np.int32) if has_strat else None
        weights = np.zeros((gb, 4), np.int32) if has_strat else None
        tasks = 0
        for j in range(count):
            sp = specs[start + j]
            if quota is not None and sp.quota_blocked:
                quota[j] = False
            if sid is not None:
                sid[j] = sp.sid
                if sp.weights is not None:
                    weights[j] = sp.weights
            k[j] = sp.k
            slot[j] = sp.slot
            maxrep[j] = sp.maxrep
            cpu_d[j] = sp.cpu_d
            mem_d[j] = sp.mem_d
            tasks += sp.k
            if sp.constraints:
                if st is not None:
                    st.fill_constraints(sched, sp.constraints, con_hash[j],
                                        con_op[j], con_exp[j])
                else:
                    fill_constraints(planner._node_value, infos, n,
                                     sp.constraints, con_hash[j], con_op[j],
                                     con_exp[j])
            if sp.platforms:
                fill_platforms(sp.platforms, plat[j])
            for i in fail_idx:
                failures[j, i] = infos[i].count_recent_failures(ts, sp.t)
            if leaves[start + j] is not None:
                leaf[j] = leaves[start + j]
            if sp.wants_plugins:
                extra[j] = plugin_mask(sp.t, infos, nb)
        chunks.append(FusedChunk(
            start, count, gb,
            FusedGroups(k=k, slot=slot, maxrep=maxrep, cpu_d=cpu_d,
                        mem_d=mem_d, con_hash=con_hash, con_op=con_op,
                        con_exp=con_exp, plat=plat, failures=failures,
                        leaf=leaf, extra_mask=extra, quota_ok=quota),
            tasks,
            strat=(FusedStrategy(sid=sid, weights=weights, w1=lw1,
                                 b1=lb1, w2=lw2, b2=lb2)
                   if has_strat else None)))
        start += count

    return FusedRun(sched, specs, cols, shared, carry, chunks,
                    L, nb, cc, pb, sb, has_quota=has_quota,
                    has_strat=has_strat)
