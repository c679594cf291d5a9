"""Batch planner on the card: plugs the CUDA kernels into the scheduler seam.

Implements the ``batch_planner`` protocol that ``scheduler.Scheduler``
consumes (``begin_tick``/``end_tick``, ``schedule_group``,
``dispatch_group``/``fetch_group``, ``discard_inflight``,
``validate_preassigned``): given a task group, place the whole group on the
device and return True, or return False/None so the scheduler runs its host
path.

Two routes reach the card.  The per-group route plans one group per
dispatch: a spread group through K1 -> K2 -> K3, a binpack, weighted or
learned group through ``plan_strategy`` (K1, then K5 or K6 -> K3).  The
fused route (``probe_fused_run`` .. ``abort_fused_run``) plans a run of
consecutive fusable groups in chunks (``ops/fusedbatch.py``): per chunk one
stream of launches over its group slots, the cluster state carried from
slot to slot on the device (K1F enters each slot, K4's carry update closes
the chunk), and one D2H of the chunk's result rows.  Gang
admission asks ``gang_feasible`` / ``gang_feasible_many`` for its
all-or-nothing precheck, which K8 decides on the card, and the preemption
pass asks ``select_victims`` for its victim picks, which K9 makes on the
card.  The breaker and small-group router are not part of this planner.

Groups go to the host path for the features the device path does not
model: CSI volume mounts, non-discrete generic resources, spread trees
deeper than 4 levels, and static buckets that overflow (``groups_fallback``).
Nothing on the device path is caught: a kernel build, launch or fetch error
propagates and fails the tick.  Only a fused run that cannot be built (no
node, a bucket overflow) is routing: its groups take the per-group route.

Densification builds SoA arrays from the scheduler's NodeSet mirror.  The
group-independent node columns are built once per tick (begin_tick), kept
in sync by the apply phase's batched per-node updates, and invalidated
whenever a host-path fallback (which mutates NodeInfos directly) occurs.
With the streaming plane on (``streaming_enabled``, the default) those
columns stay resident across ticks (``ops/streaming.py``): each refresh
recomputes only the rows the scheduler's delta tracker marked dirty and
scatters them into the resident device columns with K7, and a fused run
seeds its node state from those device columns when they are fresh.

With a mesh (``TorchPlanner(mesh=make_mesh(...))``, ``parallel/sharded.py``)
the per-group, strategy and fused routes run over the node-axis split
(K10 and K11 carry the node-level fills across the shards), and the
resident columns live split over the same shards.  The preassigned
validation, the gang precheck and the victim selection stay unsharded on
the mesh's first device, as in the reference.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.objects import Meta, Task
from ..models.types import (
    GenericResourceKind, MountType, NodeAvailability, NodeState, PublishMode,
    TaskState, TaskStatus, Version, now,
)
from ..obs import devicetelemetry as _devtel
from ..obs import planes as _planes
from ..obs.trace import tracer
from ..scheduler import constraint as constraint_mod
from ..scheduler import strategy as strategy_mod
from ..scheduler.nodeinfo import NodeInfo
from ..utils.metrics import registry as _metrics
from . import densify, fusedbatch
from .convert import (
    gang_stage, named_to_device, resolve_device, tensor, to_device,
)
from .densify import (
    CC_BUCKETS as _CC_BUCKETS, P_BUCKETS as _P_BUCKETS,
    bucket as _bucket, l_bucket as _l_bucket, n_bucket as _n_bucket,
)
from .kernel import (
    K_CLAMP, FusedCarry, FusedGroups, FusedShared,
    FusedStrategy, GroupInputs, NodeInputs, StrategyInputs,
    feasibility_packed, fetch_plan, finish_fetch, gang_fit_packed,
    plan_fused_packed, plan_group_packed, plan_strategy_packed, start_fetch,
    unpack_feasibility, unpack_fused, unpack_gang,
)
from .preempt import plan_victims

_PLAN_TIMER = _metrics.timer("swarm_planner_plan_latency")


def _bucket_label(nodes_in, group_in, L: int, hier) -> str:
    """Stable name for one input-shape bucket: node bucket, constraint
    slots, platform slots, spread leaf bucket, spread depth."""
    depth = len(hier[0]) + 1 if hier else 0
    q = "_q1" if nodes_in.quota_ok is not None else ""
    return (f"nb{nodes_in.valid.shape[0]}_cc{group_in.con_hash.shape[0]}"
            f"_p{group_in.plat.shape[0]}_L{L}_h{depth}{q}")


def _fast_assign(task: Task, node_id: str, status) -> Task:
    """Minimal assignment clone for the columnar commit hot path:
    ``task.copy()`` + set node_id/status, minus the copy of the status we
    replace.  ``status`` may be shared across the whole group (stored
    objects follow the replace-don't-mutate convention)."""
    new = object.__new__(Task)
    d = new.__dict__
    d.update(task.__dict__)
    m = task.meta
    new.meta = Meta(Version(m.version.index), m.created_at, m.updated_at)
    new.status = status
    new.node_id = node_id
    new.networks = list(task.networks)
    new.assigned_generic_resources = []
    new.volumes = list(task.volumes)
    return new


class _InFlightPlan:
    """One dispatched-but-unfetched device plan: everything fetch_group
    needs to finish the group once the result lands."""

    __slots__ = ("sched", "t", "task_group", "decisions", "built",
                 "plan_t0", "pending", "bucket", "route")

    def __init__(self, sched, t, task_group, decisions, built, plan_t0,
                 pending, bucket, route="group"):
        self.sched = sched
        self.t = t
        self.task_group = task_group
        self.decisions = decisions
        self.built = built
        self.plan_t0 = plan_t0
        self.pending = pending
        self.bucket = bucket
        self.route = route      # "group" (spread) or "strategy"


class TorchPlanner:
    """The scheduler's device planner on PyTorch + CUDA.

    ``device=None`` means ``"cuda"`` and raises where CUDA is absent;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.  ``mesh``
    (a ``parallel.NodeMesh``) splits the plans and the resident columns
    over its shards; ``device`` then defaults to the mesh's first
    device, where the unsharded work runs."""

    def __init__(self, device=None, mesh=None):
        self.device = resolve_device(
            mesh.devices[0] if device is None and mesh is not None
            else device)
        self.mesh = None
        self._sharded = None
        self.set_mesh(mesh)
        self._tick_ts = None         # failure-window ts frozen per tick
        self._in_tick = False
        self.last_explanation = ""
        self.stats = {"groups_planned": 0, "groups_fallback": 0,
                      "tasks_planned": 0, "plan_seconds": 0.0}
        # per-tick cache of group-independent node columns; built on
        # begin_tick, updated incrementally by the apply phase, invalidated
        # by host-path fallbacks (which mutate NodeInfos behind our back)
        self._cache = None
        # FIFO in-flight queue for the dispatch/fetch pipeline split.  At
        # most ONE plan may be in flight: group i+1's input columns depend
        # on group i's apply
        self._inflight: deque = deque()
        # fused many-service route; False sends every group down the
        # per-group route (the same placements, one round-trip per group)
        self.fused_enabled = True
        # streaming scheduler (ops/streaming.py): the node columns above
        # -- and their device copies -- stay RESIDENT across ticks and
        # refresh from the scheduler's dirty-set tracker in O(churn).
        # False reverts to a full rebuild per tick (the same placements)
        self.streaming_enabled = True
        self._streaming = None
        # packed staging buffers of the victim selection, per shape
        self._victim_stages: Dict = {}
        # packed staging buffers of the gang verdicts, per shape (G, n, cc,
        # np, quota)
        self._gang_stages: Dict = {}

        # device-plane saturation probe (obs/planes.py): dispatch-queue
        # depth read lazily at window-roll time; weakref so the probe never
        # pins a dead planner
        import weakref
        _ref = weakref.ref(self)
        _planes.plane(_planes.DEVICE).set_probe(
            lambda: ({"depth": float(len(_ref()._inflight))}
                     if _ref() is not None else {}))

    def set_mesh(self, mesh) -> None:
        """Route the plans over ``mesh`` from the next dispatch on (None:
        unsharded, on ``device``).  The resident columns follow at the next
        tick's refresh: a layout change there is a counted resync."""
        self.mesh = mesh
        if mesh is None:
            self._sharded = None
        else:
            from ..parallel.sharded import ShardedPlanFn
            self._sharded = ShardedPlanFn(mesh)

    # ------------------------------------------------------------- accounting

    # routing-counter keys -> the route label exported on
    # swarm_planner_groups{route=...}; every increment goes through _count
    # so the stats dict and the metrics registry never disagree
    _ROUTE = {"groups_planned": "device",
              "groups_fused": "fused",
              "groups_fallback": "fallback",
              "groups_spill_to_host": "spill"}

    def _count(self, key: str, delta: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + delta
        route = self._ROUTE.get(key)
        if route is not None:
            _metrics.counter(f'swarm_planner_groups{{route="{route}"}}',
                             delta)
        else:
            _metrics.counter(f"swarm_planner_{key}", delta)

    def _observe_plan(self, dt: float) -> None:
        self.stats["plan_seconds"] += dt
        _PLAN_TIMER.observe(dt)

    @staticmethod
    def _note_inflight(dt: float) -> None:
        """Retroactive ``plan.inflight`` span covering one plan's whole
        dispatch->fetch window (zero-duration under a virtual clock)."""
        from ..models.types import time_source_installed
        tracer.record_complete("plan.inflight", "plan",
                               0.0 if time_source_installed() else dt)

    def _to_device(self, nodes_np, group_np, hier_np):
        _devtel.note_h2d("group_inputs",
                         _devtel.tree_nbytes((nodes_np, group_np, hier_np)))
        return to_device(nodes_np, group_np, hier_np, self.device)

    # ------------------------------------------------------- per-tick caching

    def begin_tick(self, sched) -> None:
        self._in_tick = True
        # one failure-window timestamp for the whole tick
        self._tick_ts = now()
        st = self._streaming_for(sched)
        if st is not None:
            self._cache = st.refresh(sched)
        else:
            self._cache = self._build_columns(sched)

    def _streaming_for(self, sched):
        """The resident-state plane when it may serve this scheduler:
        streaming on AND the scheduler carries the dirty-set delta feed
        (scheduler/deltatrack.py).  Built at first use."""
        if not self.streaming_enabled \
                or getattr(sched, "delta", None) is None:
            return None
        if self._streaming is None:
            from .streaming import ResidentState
            self._streaming = ResidentState(self._node_value, self.device,
                                            mesh=self.mesh)
        else:
            # a mesh teardown or shard-count change between ticks resyncs
            # the device tier (set_mesh is a no-op on identity)
            self._streaming.set_mesh(self.mesh)
        return self._streaming

    def _resident_for(self, cols):
        """The resident state iff ``cols`` came from it (identity on the
        infos list) -- the guard every streaming fast path sits behind, so
        a planner fed foreign columns never reads stale resident
        caches."""
        st = self._streaming
        if st is not None and cols and cols[0] is st.infos:
            return st
        return None

    def streaming_snapshot(self):
        """The ``streaming_*`` fields: refresh modes, rows, syncs."""
        st = self._streaming
        if st is None or not self.streaming_enabled:
            return {"enabled": False, "dirty_frac": None, "resyncs": 0,
                    "fallbacks": 0, "incremental_ticks": 0,
                    "full_ticks": 0, "rows": 0, "device_syncs": 0}
        return st.snapshot()

    def end_tick(self) -> None:
        self._in_tick = False
        self._tick_ts = None
        self._cache = None

    def fail_ts(self):
        """Failure-window timestamp: frozen per tick; now() for
        out-of-tick densifies."""
        ts = self._tick_ts
        return ts if ts is not None else now()

    def _build_columns(self, sched):
        node_set = sched.node_set
        infos: List[NodeInfo] = list(node_set.nodes.values())
        n = len(infos)
        nb = _n_bucket(max(n, 1))
        valid = np.zeros(nb, bool)
        ready = np.zeros(nb, bool)
        cpu = np.zeros(nb, np.int64)
        mem = np.zeros(nb, np.int64)
        total = np.zeros(nb, np.int32)
        valid[:n] = True
        for i, info in enumerate(infos):
            node = info.node
            ready[i] = (node.status.state == NodeState.READY
                        and node.spec.availability == NodeAvailability.ACTIVE)
            cpu[i] = info.available_resources.nano_cpus
            mem[i] = info.available_resources.memory_bytes
            total[i] = info.active_tasks_count
        return [infos, n, nb, valid, ready, cpu, mem, total]

    # explanation builders, pipeline order (matches the fail_counts rows
    # and the host filters' Explain strings -- filter.go)
    _EXPLAINERS = (
        lambda n: (f"{n} nodes not available for new tasks" if n != 1
                   else "1 node not available for new tasks"),
        lambda n: (f"insufficient resources on {n} nodes" if n != 1
                   else "insufficient resources on 1 node"),
        lambda n: (f"missing plugin on {n} nodes" if n != 1
                   else "missing plugin on 1 node"),
        lambda n: (f"scheduling constraints not satisfied on {n} nodes"
                   if n != 1
                   else "scheduling constraints not satisfied on 1 node"),
        lambda n: (f"unsupported platform on {n} nodes" if n != 1
                   else "unsupported platform on 1 node"),
        lambda n: (f"host-mode port already in use on {n} nodes" if n != 1
                   else "host-mode port already in use on 1 node"),
        lambda n: "max replicas per node limit exceed",
        lambda n: (f"over tenant quota on {n} nodes" if n != 1
                   else "over tenant quota on 1 node"),
    )

    def _explain(self, fail_counts: np.ndarray) -> str:
        pairs = [(int(c), ex) for c, ex in zip(fail_counts, self._EXPLAINERS)]
        pairs.sort(key=lambda p: -p[0])
        return "; ".join(ex(c) for c, ex in pairs if c > 0)

    # ------------------------------------------------------------ suitability

    def _supported(self, t: Task) -> bool:
        c = t.spec.container
        if c is not None:
            for m in c.mounts:
                if m.type == MountType.CSI:
                    return False  # volume scheduling stays on host
        placement = t.spec.placement
        if placement:
            prefs = [p for p in placement.preferences if p.spread]
            if len(prefs) > 4:
                return False  # absurdly deep spread tree: host path
        res = t.spec.resources.reservations if t.spec.resources else None
        if res:
            for g in res.generic:
                if g.res_type != GenericResourceKind.DISCRETE:
                    return False
        return True

    # ---------------------------------------------------------- densification

    def _densify(self, sched, t: Task):
        """The per-tick node columns (built on begin_tick, rebuilt after an
        invalidation; with the streaming plane, refreshed row-wise from
        the marks the host-path mutations left)."""
        if self._cache is not None:
            return self._cache
        st = self._streaming_for(sched)
        cols = st.refresh(sched) if st is not None \
            else self._build_columns(sched)
        if self._in_tick:
            self._cache = cols
        return cols

    def _node_value(self, info: NodeInfo, key: str) -> str:
        node = info.node
        lk = key.lower()
        if lk == "node.id":
            return node.id
        if lk == "node.ip" or lk.startswith("node.ip/"):
            # hash/prefix column keys minted by constraint.ip_column_spec
            return constraint_mod.ip_node_value(
                node.status.addr if node.status else "", lk)
        if lk == "node.hostname":
            return node.description.hostname if node.description else ""
        if lk == "node.role":
            return "MANAGER" if node.spec.desired_role == 1 else "WORKER"
        if lk == "node.platform.os":
            return (node.description.platform.os
                    if node.description and node.description.platform else "")
        if lk == "node.platform.arch":
            return (node.description.platform.architecture
                    if node.description and node.description.platform else "")
        if lk.startswith(constraint_mod.NODE_LABEL_PREFIX):
            return node.spec.annotations.labels.get(
                key[len(constraint_mod.NODE_LABEL_PREFIX):], "")
        if lk.startswith(constraint_mod.ENGINE_LABEL_PREFIX):
            if node.description and node.description.engine:
                return node.description.engine.labels.get(
                    key[len(constraint_mod.ENGINE_LABEL_PREFIX):], "")
            return ""
        return None  # unknown key

    def _fallback(self) -> bool:
        # the host path will mutate NodeInfos the cached columns mirror
        self._count("groups_fallback")
        self._cache = None
        return False

    # ----------------------------------------------------------- entry point

    def schedule_group(self, sched, task_group: Dict[str, Task],
                       decisions) -> bool:
        """Serial entry point: dispatch + immediate fetch (the pipelined
        scheduler calls the two stages separately; both share this code)."""
        handle = self.dispatch_group(sched, task_group, decisions)
        if handle is None:
            return False
        return self.fetch_group(handle)

    def dispatch_group(self, sched, task_group: Dict[str, Task],
                       decisions) -> Optional[_InFlightPlan]:
        """Pipeline stage 1: route, densify, and enqueue one group's plan
        on the device -- K1 -> K2 -> K3 for a spread group, K1 -> K5
        (binpack) or K1 -> K6 -> K3 (weighted, learned) for a strategy
        group, on the current stream -- then one non-blocking copy of the
        result buffer to pinned host memory and an event.  Nothing waits
        on the device here.  Returns an in-flight handle to finish with
        ``fetch_group``, or None when the group is not device-planned (the
        caller runs the host path)."""
        t = next(iter(task_group.values()))
        if not self._supported(t):
            self._fallback()
            return None
        sinfo = strategy_mod.resolve(strategy_mod.strategy_of(t))
        if sinfo is None:
            # unknown strategy name: the host path serves it
            self._fallback()
            return None
        flat = sinfo.sid != strategy_mod.STRAT_SPREAD

        plan_t0 = time.perf_counter()
        k = len(task_group)
        if k > K_CLAMP:  # beyond the kernels' 32-bit budget
            self._fallback()
            return None
        if self._inflight:
            raise RuntimeError(
                "dispatch_group with a plan already in flight: fetch it "
                "first (its apply feeds this group's input columns)")
        with tracer.span("plan.build_inputs", "plan", tasks=k):
            built = self._build_device_inputs(sched, t, k, flat=flat)
            sin_np = self._build_strategy_inputs(built, t, sinfo) \
                if flat and built is not None and built[1] else None
        if built is None:
            self._fallback()
            return None
        if built[1] == 0:   # no valid nodes densified
            return None
        nodes_np, group_np, L, hier_np = built[7], built[8], built[9], \
            built[10]
        bucket = _bucket_label(nodes_np, group_np, L, hier_np)
        route = "strategy" if flat else "group"
        if flat:
            bucket += f"_st{sinfo.sid}"
        if self._sharded is not None:
            bucket += f"_x{self.mesh.size}"
        with tracer.span("plan.dispatch", "plan", tasks=k):
            t0 = time.perf_counter()
            if self._sharded is not None:
                # the node-axis split: each shard's slice goes to its
                # device, the result rows come back in one pinned buffer
                _devtel.note_h2d("group_inputs", _devtel.tree_nbytes(
                    (nodes_np, group_np, hier_np, sin_np)))
                pending = self._sharded.strategy(
                    nodes_np, group_np, sin_np, sinfo.sid) if flat \
                    else self._sharded(nodes_np, group_np, L, hier_np)
            else:
                nodes_in, group_in, hier = self._to_device(
                    nodes_np, group_np, hier_np)
                if flat:
                    _devtel.note_h2d("strategy_inputs",
                                     _devtel.tree_nbytes(sin_np))
                    sin = named_to_device(StrategyInputs, sin_np,
                                          self.device)
                    buf = plan_strategy_packed(nodes_in, group_in, sin,
                                               sinfo.sid)
                else:
                    buf = plan_group_packed(nodes_in, group_in, L, hier)
                pending = start_fetch(buf)
            _devtel.note_kernel(bucket, route,
                                dispatch_s=time.perf_counter() - t0,
                                task_rows=k,
                                node_rows=nodes_np.valid.shape[0],
                                strategy_id=sinfo.sid if flat else -1)
        if flat:
            strategy_mod.count_group(sinfo.name, "device")
        handle = _InFlightPlan(sched, t, task_group, decisions, built,
                               plan_t0, pending, bucket, route)
        self._inflight.append(handle)
        return handle

    def _build_strategy_inputs(self, built, t, sinfo):
        """The strategy columns of one group, as numpy ``StrategyInputs``
        (reference ``_build_strategy_inputs``): per-resource headroom in
        demand units (the exact int64 floor divisions that the host
        oracle's ``build_host_columns`` applies per row), the per-service
        weight vector, and the learned scorer's shipped weights.  Members
        the strategy does not read are zeros."""
        (infos, n, nb, valid, cpu, mem, total, _nodes_in, _group_in,
         _L, _hier, cpu_d, mem_d, gen_wanted, _port_limited) = built
        HR = strategy_mod.HR_CLAMP
        if cpu_d > 0:
            hr_cpu = np.clip(cpu // cpu_d, 0, HR).astype(np.int32)
        else:
            hr_cpu = np.full(nb, HR, np.int32)
        if mem_d > 0:
            hr_mem = np.clip(mem // mem_d, 0, HR).astype(np.int32)
        else:
            hr_mem = np.full(nb, HR, np.int32)
        hr_gen = np.full(nb, HR, np.int32)
        if gen_wanted:
            for i, info in enumerate(infos):
                gen_min = HR
                for g in gen_wanted:
                    avail = 0
                    for r in info.available_resources.generic:
                        if r.kind == g.kind:
                            avail += (1 if r.res_type
                                      == GenericResourceKind.NAMED
                                      else r.value)
                    gen_min = min(gen_min,
                                  int(min(max(avail // g.value, 0), HR)))
                hr_gen[i] = gen_min
        if sinfo.uses_weights:
            weights = strategy_mod.weights_of(t)
        else:
            weights = np.zeros(4, np.int32)
        if sinfo.uses_learned:
            w1, b1, w2, b2 = strategy_mod.learned_params()
        else:
            f = len(strategy_mod.MLP_FEATURES)
            w1 = np.zeros((f, 1), np.int32)
            b1 = np.zeros(1, np.int32)
            w2 = np.zeros(1, np.int32)
            b2 = np.zeros((), np.int32)
        return StrategyInputs(hr_cpu=hr_cpu, hr_mem=hr_mem, hr_gen=hr_gen,
                              weights=weights, w1=w1, b1=b1, w2=w2,
                              b2=np.asarray(b2, np.int32))

    def _build_device_inputs(self, sched, t, k, flat=False):
        """Densify the cluster + one task-group spec into numpy kernel
        inputs.  Shared by group planning and preassigned validation.
        Returns None when a static bucket overflows (caller falls back to
        the host path).  ``flat``: skip the spread-preference tree (a
        non-spread strategy owns the scoring stage: one flat segment)."""
        cols = self._densify(sched, t)
        infos, n, nb, valid, ready, cpu, mem, total = cols
        if n == 0:
            return (infos, 0, nb, valid, cpu, mem, total, None, None, 1,
                    (), 0, 0, [], False)
        # resident fast paths (ops/streaming.py): per-service counts,
        # failure rows, platform hashes, constraint hash columns and flat
        # spread leaves come from row-maintained caches, byte-identical to
        # the loops below (same per-row formulas); the loops remain the
        # tracker-less / streaming-off path
        st = self._resident_for(cols)

        # ---- per-service arrays
        ts = self.fail_ts()
        sid = t.service_id
        failures = np.zeros(nb, np.int32)
        if st is not None:
            svc_tasks = st.svc_tasks_col(sched, sid)
            if st.fail_rows:
                st.fill_failures(failures, ts, t)
        else:
            svc_tasks = np.zeros(nb, np.int32)
            for i, info in enumerate(infos):
                c = info.active_tasks_count_by_service.get(sid, 0)
                if c:
                    svc_tasks[i] = c
                if info.recent_failures:
                    failures[i] = info.count_recent_failures(ts, t)

        # ---- constraints
        placement = t.spec.placement
        constraints = []
        if placement and placement.constraints:
            try:
                constraints = constraint_mod.parse(placement.constraints)
            except constraint_mod.InvalidConstraint:
                constraints = []
        cc = _bucket(len(constraints), _CC_BUCKETS)
        if cc is None:
            return None
        con_hash = np.zeros((cc, 2, nb), np.int32)
        con_op = np.full(cc, 2, np.int32)     # 2 = disabled
        con_exp = np.zeros((cc, 2), np.int32)
        if constraints:
            if st is not None:
                st.fill_constraints(sched, constraints, con_hash, con_op,
                                    con_exp)
            else:
                densify.fill_constraints(self._node_value, infos, n,
                                         constraints, con_hash, con_op,
                                         con_exp)

        # ---- platforms
        platforms = placement.platforms if placement else []
        pb = _bucket(max(len(platforms), 1), _P_BUCKETS)
        if pb is None:
            return None
        plat = np.full((pb, 4), -1, np.int32)
        densify.fill_platforms(platforms, plat)
        if platforms:
            if st is not None:
                os_hash, arch_hash = st.platform_hashes()
            else:
                os_hash, arch_hash = densify.node_platform_hashes(infos, nb)
        else:
            os_hash = np.zeros((2, nb), np.int32)
            arch_hash = np.zeros((2, nb), np.int32)

        # ---- resources: exact int64 mask + capacity, computed host-side so
        # device decisions match the host oracle's integer comparisons
        res = t.spec.resources.reservations if t.spec.resources else None
        cpu_d = int(res.nano_cpus) if res else 0
        mem_d = int(res.memory_bytes) if res else 0
        gen_wanted = [g for g in (res.generic if res else [])]
        res_ok = valid.copy()
        res_cap = np.full(nb, K_CLAMP, np.int64)
        for avail, demand in ((cpu, cpu_d), (mem, mem_d)):
            if demand > 0:
                res_ok &= avail >= demand
                np.minimum(res_cap, avail // demand, out=res_cap)
        for g in gen_wanted:
            if g.value <= 0:
                continue
            gen_avail = np.zeros(nb, np.int64)
            for i, info in enumerate(infos):
                avail = 0
                for r in info.available_resources.generic:
                    if r.kind == g.kind:
                        avail += (1 if r.res_type == GenericResourceKind.NAMED
                                  else r.value)
                gen_avail[i] = avail
            res_ok &= gen_avail >= g.value
            np.minimum(res_cap, gen_avail // g.value, out=res_cap)
        res_cap = np.clip(res_cap, 0, K_CLAMP).astype(np.int32)

        # ---- host ports
        port_conflict = np.zeros(nb, bool)
        port_limited = False
        if t.endpoint:
            wanted = [(p.protocol, p.published_port)
                      for p in t.endpoint.ports
                      if p.publish_mode == PublishMode.HOST
                      and p.published_port]
            if wanted:
                port_limited = True
                for i, info in enumerate(infos):
                    if info.used_host_ports:
                        port_conflict[i] = any(
                            w in info.used_host_ports for w in wanted)

        # ---- plugins (volume/network/log drivers): host-side mask
        if densify.needs_plugins(t):
            extra_mask = densify.plugin_mask(t, infos, nb)
        else:
            extra_mask = np.ones(nb, bool)

        # ---- tenant quota mask column: all-False only for groups the
        # ledger blocked at admission (the frozen verdict)
        quota_ok = None
        if densify.group_quota_blocked(sched, t):
            quota_ok = np.zeros(nb, bool)

        # ---- spread preferences -> hierarchical branch ids
        leaf = np.zeros(nb, np.int32)
        L = 1
        hier = ()
        prefs = [] if flat else \
            [p for p in (placement.preferences if placement else [])
             if p.spread]
        if len(prefs) == 1:
            descriptor = prefs[0].spread.spread_descriptor
            if st is not None:
                leaf, n_values = st.flat_leaf(sched, descriptor)
            else:
                leaf, n_values = densify.flat_leaf(infos, nb, descriptor)
            L = _l_bucket(n_values)
        elif prefs:
            from ..scheduler.nodeset import _pref_value
            descriptors = [p.spread.spread_descriptor for p in prefs]
            depth = len(descriptors)
            paths = []
            for info in infos:
                paths.append(tuple(_pref_value(info, d) or ""
                                   for d in descriptors))
            level_ids: List[Dict[tuple, int]] = []
            seg_arrays: List[np.ndarray] = []
            for di in range(depth):
                ids: Dict[tuple, int] = {}
                seg = np.zeros(nb, np.int32)
                for i, path in enumerate(paths):
                    seg[i] = ids.setdefault(path[:di + 1], len(ids))
                level_ids.append(ids)
                seg_arrays.append(seg)
            leaf = seg_arrays[-1]
            L = _l_bucket(max(len(level_ids[-1]), 1))
            if depth > 1:
                upper = []
                for di in range(depth - 1):
                    L_d = _l_bucket(max(len(level_ids[di]), 1))
                    parent = np.zeros(L_d, np.int32)
                    if di > 0:
                        for path, cid in level_ids[di].items():
                            parent[cid] = level_ids[di - 1][path[:di]]
                    upper.append((seg_arrays[di], parent))
                leaf_parent = np.zeros(L, np.int32)
                for path, cid in level_ids[-1].items():
                    leaf_parent[cid] = level_ids[-2][path[:depth - 1]]
                hier = (tuple(upper), leaf_parent)

        nodes_in = NodeInputs(
            valid=valid, ready=ready, res_ok=res_ok, res_cap=res_cap,
            svc_tasks=svc_tasks, total_tasks=total, failures=failures,
            leaf=leaf, os_hash=os_hash, arch_hash=arch_hash,
            port_conflict=port_conflict, extra_mask=extra_mask,
            quota_ok=quota_ok)
        group_in = GroupInputs(
            k=np.int32(k), con_hash=con_hash, con_op=con_op, con_exp=con_exp,
            plat=plat, maxrep=np.int32(
                placement.max_replicas if placement else 0),
            port_limited=np.bool_(port_limited))
        return (infos, n, nb, valid, cpu, mem, total, nodes_in, group_in,
                L, hier, cpu_d, mem_d, gen_wanted, port_limited)

    def _apply_assignments(self, sched, t, items, slots, infos,
                           decisions, cpu_d, mem_d, counts,
                           cpu, mem, total,
                           message="scheduler assigned task to node"
                           ) -> None:
        """Shared apply: clone+register the assigned tasks and do the
        per-NODE mirror arithmetic in batch.  ``counts``: i32[nb] tasks
        placed per node column."""
        from ..scheduler.scheduler import SchedulingDecision

        all_tasks = sched.all_tasks
        if getattr(sched, "block_mode", False):
            # columnar end-to-end: each group stages one (olds, nids,
            # message) column triple and commits as one array-shaped store
            # call (store.commit_task_block)
            olds, nids = [], []
            for (task_id, task), i in zip(items, slots):
                olds.append(task)
                nids.append(infos[i].node.id)
                infos[i].tasks[task_id] = task
            if olds:
                sched.block_draft.append((olds, nids, message))
        else:
            shared_status = TaskStatus(
                state=TaskState.ASSIGNED, timestamp=now(), message=message)
            for (task_id, task), i in zip(items, slots):
                info = infos[i]
                new_t = _fast_assign(task, info.id, shared_status)
                all_tasks[task_id] = new_t
                info.tasks[task_id] = new_t
                decisions[task_id] = SchedulingDecision(task, new_t)
        service_id = t.service_id
        idx = np.nonzero(counts)[0]
        if self._cache is not None and len(idx):
            hit = counts[idx]
            total[idx] += hit
            cpu[idx] -= hit.astype(np.int64) * cpu_d
            mem[idx] -= hit.astype(np.int64) * mem_d
        # the batched mirror arithmetic bypasses the NodeInfo mutation
        # hooks: mark the touched rows dirty directly
        delta = getattr(sched, "delta", None)
        mark = delta.mark if delta is not None else None
        for i in idx.tolist():
            cnt = int(counts[i])
            info = infos[i]
            info.active_tasks_count += cnt
            svc_map = info.active_tasks_count_by_service
            svc_map[service_id] = svc_map.get(service_id, 0) + cnt
            ar = info.available_resources
            ar.nano_cpus -= cnt * cpu_d
            ar.memory_bytes -= cnt * mem_d
            if mark is not None:
                mark(info.node.id)

    def validate_preassigned(self, sched, tasks, decisions) -> list:
        """Validate preassigned tasks (same service) against their FIXED
        nodes with one feasibility kernel launch and one D2H (reference:
        scheduler.go:646 taskFitNode).  Admits each task iff its node
        passes the mask and has capacity left after earlier tasks of this
        batch claimed it; returns the rest for the host path."""
        t = tasks[0]
        if not self._supported(t):
            return tasks
        c = t.spec.container
        if c is not None and (c.mounts or getattr(c, "volumes", None)):
            return tasks   # volume selection is host-path logic
        if any(tk.desired_state > TaskState.COMPLETE for tk in tasks):
            # batched mirror counting assumes every admitted task counts
            # toward active totals -- shutdown-marked stragglers take the
            # host path
            return tasks
        plan_t0 = time.perf_counter()
        with tracer.span("plan.build_inputs", "plan", tasks=len(tasks)):
            built = self._build_device_inputs(sched, t, len(tasks))
        if built is None or built[1] == 0:
            return tasks
        (infos, n, nb, valid, cpu, mem, total, nodes_np, group_np, L,
         hier, cpu_d, mem_d, gen_wanted, port_limited) = built
        if gen_wanted or port_limited:
            return tasks   # per-task claim bookkeeping: host path

        with tracer.span("plan.feasibility", "plan", tasks=len(tasks)):
            bucket = "feas_" + _bucket_label(nodes_np, group_np, 1, ())
            t0 = time.perf_counter()
            nodes_in, group_in, _ = self._to_device(nodes_np, group_np, ())
            buf = finish_fetch(start_fetch(feasibility_packed(nodes_in,
                                                              group_in)))
            _devtel.note_d2h("feasibility", int(buf.nbytes))
            _devtel.note_kernel(bucket, "feasibility",
                                dispatch_s=time.perf_counter() - t0,
                                task_rows=len(tasks), node_rows=nb)
        mask, cap, _ = unpack_feasibility(buf, nb)
        col = {info.node.id: i for i, info in enumerate(infos)}

        items = []      # (task_id, task) admitted
        slots = []      # node column per admitted task
        remaining = []
        used = np.zeros(nb, np.int32)
        for task in tasks:
            i = col.get(task.node_id)
            if i is None or not mask[i] or used[i] >= cap[i]:
                remaining.append(task)
                continue
            used[i] += 1
            items.append((task.id, task))
            slots.append(i)
        self._observe_plan(time.perf_counter() - plan_t0)
        if not items:
            return remaining

        with tracer.span("plan.apply", "plan", tasks=len(items)):
            self._apply_assignments(
                sched, t, items, slots, infos, decisions, cpu_d, mem_d,
                used, cpu, mem, total,
                message="scheduler confirmed task can run on preassigned "
                        "node")
        self._count("tasks_planned", len(items))
        return remaining

    def discard_inflight(self) -> None:
        """Drop dispatched-but-unfetched plans (aborted tick): their
        results are never applied, and the column cache is invalidated."""
        if self._inflight:
            self._inflight.clear()
            self._cache = None

    def fetch_group(self, handle: _InFlightPlan) -> bool:
        """Pipeline stage 2: wait for the dispatched plan's D2H, then
        apply it to the scheduler mirrors / decision draft.  Returns True
        when the device handled the group (``task_group`` keeps any
        unplaceable leftovers), False when the plan spilled and the caller
        must run the group through the host oracle.  Handles are fetched
        oldest-first."""
        if not self._inflight or self._inflight[0] is not handle:
            raise RuntimeError("fetch_group out of dispatch order")
        self._inflight.popleft()
        sched, t = handle.sched, handle.t
        task_group, decisions = handle.task_group, handle.decisions
        plan_t0 = handle.plan_t0
        (infos, n, nb, valid, cpu, mem, total, nodes_in, group_in, L,
         hier, cpu_d, mem_d, gen_wanted, port_limited) = handle.built
        d2h_t0 = time.perf_counter()
        with tracer.span("plan.d2h", "plan"):
            x, fail_counts, spill = fetch_plan(handle.pending, nb)
        handle.pending = None
        # the d2h wait IS the device plane's busy window
        d2h_dt = time.perf_counter() - d2h_t0
        _planes.plane(_planes.DEVICE).note_busy(d2h_dt)
        _devtel.note_kernel(handle.bucket, handle.route, d2h_s=d2h_dt)
        self._note_inflight(time.perf_counter() - plan_t0)
        if spill:
            # a spread branch saturated: the host oracle's convergence
            # loop redistributes differently than the water-fill in that
            # regime -- keep exact reference parity on the host
            self._observe_plan(time.perf_counter() - plan_t0)
            self._count("groups_spill_to_host")
            self._cache = None
            return False
        self.last_explanation = self._explain(fail_counts)
        self._observe_plan(time.perf_counter() - plan_t0)

        # ---- apply: expand per-node counts into per-task decisions
        from ..scheduler.scheduler import SchedulingDecision
        slots = np.repeat(np.arange(x.shape[0]), x).tolist()
        items = list(task_group.items())
        shared_status = TaskStatus(
            state=TaskState.ASSIGNED, timestamp=now(),
            message="scheduler assigned task to node")
        all_tasks = sched.all_tasks
        placed = 0
        # batched per-node counting assumes every placed task counts toward
        # active-task totals (desired_state <= COMPLETE) -- tasks already
        # marked for shutdown take the per-task path
        simple = (not gen_wanted and not port_limited
                  and not any(tk.desired_state > TaskState.COMPLETE
                              for _, tk in items))
        if simple:
            placed = min(len(items), len(slots))
            counts = np.asarray(x)
            with tracer.span("plan.apply", "plan", tasks=placed):
                self._apply_assignments(sched, t, items[:placed],
                                        slots[:placed], infos, decisions,
                                        cpu_d, mem_d, counts, cpu, mem,
                                        total)
            if placed == len(task_group):
                task_group.clear()
            else:
                for task_id, _ in items[:placed]:
                    del task_group[task_id]
        else:
            # generic resources / host ports need per-task claim bookkeeping
            self._cache = None   # add_task mutates behind the columns
            with tracer.span("plan.apply", "plan", tasks=len(slots)):
                for (task_id, task), node_i in zip(items, slots):
                    info = infos[node_i]
                    new_t = _fast_assign(task, info.id, shared_status)
                    all_tasks[task_id] = new_t
                    info.add_task(new_t)
                    decisions[task_id] = SchedulingDecision(task, new_t)
                    del task_group[task_id]
                    placed += 1

        self._count("groups_planned")
        self._count("tasks_planned", placed)
        return True

    # ------------------------------------------------- victim selection

    def select_victims(self, cand, cpu_d: int, mem_d: int, gen_d: int,
                       n_picks: int, budget: int):
        """The preemption pass's victim picks for one pending group
        (reference ``select_victims``): [(node index, prefix length)],
        the integers ``select_victims_host`` gives, from K9 on the card.
        There is no breaker and no host fallback: a build, launch or fetch
        error propagates and fails the tick."""
        t0 = time.perf_counter()
        with tracer.span("plan.preempt", "plan", picks=n_picks):
            picks, bucket = plan_victims(cand, cpu_d, mem_d, gen_d, n_picks,
                                         budget, self.device,
                                         self._victim_stages)
        _devtel.note_kernel(bucket, "preempt",
                            dispatch_s=time.perf_counter() - t0,
                            task_rows=n_picks,
                            node_rows=int(cand.ok.shape[0]))
        return picks

    # ------------------------------------------------- gang feasibility

    def gang_feasible(self, sched, t: Task, k: int) -> Optional[bool]:
        """Group-level all-members-feasible verdict for a gang member
        group (reference ``gang_feasible``): True/False from K8, None when
        no verdict is available (a static bucket overflow), and the caller
        then decides by a placement attempt and rollback.  A build, launch
        or fetch error propagates: there is no host-oracle fallback."""
        built = self._build_device_inputs(sched, t, k)
        if built is None:
            return None
        nodes_np, group_np = built[7], built[8]
        if built[1] == 0:
            return False
        bucket = _bucket_label(nodes_np, group_np, built[9], built[10])
        return self._gang_fit_one(nodes_np, group_np, bucket + "_gf")

    def _gang_fit_one(self, nodes_np, group_np, bucket: str) -> bool:
        """One gang's verdict from K8 (counted ``gang_fit_device``)."""
        return self._gang_fit_rows([(nodes_np, group_np)], bucket)[0]

    def _gang_fit_rows(self, rows, bucket: str) -> List[bool]:
        """K8 over the (NodeInputs, GroupInputs) of ``rows``: the columns
        it reads packed into the stage of their shape, one H2D of it, one
        launch, one D2H of every gang's verdict into the stage's pinned
        buffer.  One row counts ``gang_fit_device``, a stack
        ``gang_fit_fused``."""
        g = len(rows)
        t0 = time.perf_counter()
        span, args = ("plan.gang_fit", {"k": int(rows[0][1].k)}) if g == 1 \
            else ("plan.gang_fit_fused", {"gangs": g})
        with tracer.span(span, "plan", **args):
            stage = gang_stage(rows, self.device, self._gang_stages)
            arr = stage.fetch(gang_fit_packed(*stage.dev_views))
            fits, _fail, _total = unpack_gang(arr, g)
        _devtel.note_h2d("gang_inputs", int(stage.host.nbytes))
        _devtel.note_d2h("fetch", int(arr.nbytes))
        if g == 1:
            _devtel.note_kernel(bucket, "gang",
                                dispatch_s=time.perf_counter() - t0,
                                task_rows=int(rows[0][1].k),
                                node_rows=rows[0][0].valid.shape[0])
            self._count("gang_fit_device")
        else:
            _devtel.note_kernel(bucket, "gang_fused",
                                dispatch_s=time.perf_counter() - t0,
                                groups=g)
            self._count("gang_fit_fused", g)
        return [bool(f) for f in fits]

    def gang_feasible_many(self, sched, wants) -> list:
        """Fused gang route: verdicts for ``wants`` = [(t, k), ...].
        Groups of one input-shape bucket (the same label, quota-mask
        presence included) stack on a leading gang axis and are judged in
        ONE K8 launch (bucket suffix ``_gfF``); a bucket with one group
        takes the per-group route (``_gf``).  Returns [Optional[bool]]
        aligned with ``wants``."""
        results: list = [None] * len(wants)
        by_bucket: Dict[str, list] = {}
        for i, (t, k) in enumerate(wants):
            built = self._build_device_inputs(sched, t, k)
            if built is None:
                continue
            if built[1] == 0:
                results[i] = False
                continue
            nodes_np, group_np = built[7], built[8]
            label = _bucket_label(nodes_np, group_np, built[9], built[10])
            by_bucket.setdefault(label, []).append((i, nodes_np, group_np))
        for label, rows in by_bucket.items():
            if len(rows) < 2:
                for i, nodes_np, group_np in rows:
                    results[i] = self._gang_fit_one(nodes_np, group_np,
                                                    label + "_gf")
                continue
            fits = self._gang_fit_rows([(n, g) for _, n, g in rows],
                                       label + "_gfF")
            for (i, _n, _g), fit in zip(rows, fits):
                results[i] = fit
        return results

    # ------------------------------------------------------------ fused route

    def probe_fused_run(self, sched, glist, start: int) -> list:
        """Maximal run of consecutive fusable groups from ``glist[start:]``,
        as parsed GroupSpecs.  Empty when fusion is off or the first group
        is not fusable: the scheduler then takes the per-group route for
        exactly the groups a per-group tick would route the same way."""
        if not self.fused_enabled:
            return []
        specs = []
        for group in glist[start:]:
            spec = fusedbatch.probe_group(self, sched, group)
            if spec is None:
                break
            specs.append(spec)
        return specs

    def dispatch_fused_run(self, sched, specs):
        """Densify one fused run (>= 2 groups), move its node state to the
        device and enqueue its first chunks.  Returns the FusedRun, or None
        when the run cannot be built (no node, a bucket overflow): the
        caller then takes its groups one by one, and no mirror state was
        touched.  A device error propagates and fails the tick."""
        run = fusedbatch.build_run(self, sched, specs)
        if run is None:
            self._count("fused_overflows")
            return None
        if self._sharded is not None and run.nb % self.mesh.size:
            # the fused split needs the node bucket to divide over the
            # mesh (reference sharded.py:388-390): the per-group route,
            # which pads, takes the groups
            self._count("fused_mesh_indivisible")
            return None
        self._prepare_fused(run)
        self._dispatch_fused_chunks(run)
        return run

    def _prepare_fused(self, run) -> None:
        """Move the run's node state (FusedShared, FusedCarry) to the
        device, where it stays for every chunk of the run.  The carry is
        updated in place by every chunk, so it must be the run's own: the
        builder's copy of the mirror columns, uploaded.

        With the streaming plane fresh (no mirror mutation since the
        resident device sync), valid, ready, total, cpu and mem are
        already on the device and equal the host mirror bit for bit (K7
        applies the same rows), so placements cannot change.  The run then
        uploads only its hashes and service columns: valid and ready are
        only read and alias the resident tensors, while the carry's total,
        cpu and mem are device-to-device clones -- seeded with the
        resident tensors themselves, the run would write its placements
        into the resident columns, which would then stop mirroring the
        host."""
        shared, carry = run.shared, run.carry
        # identity guard, like every other streaming fast path: the run's
        # shared.valid IS the resident host column iff build_run densified
        # from the resident state
        st = self._streaming
        if st is not None and (not self.streaming_enabled
                               or shared.valid is not st.valid):
            st = None
        dev = st.device_carry() if st is not None else None
        if self._sharded is not None:
            # the mesh path: seeded from the resident shards when they are
            # split over THIS mesh, else the run's columns are split and
            # uploaded (mesh_reshard)
            if dev is not None and st._mesh_active and st.mesh is self.mesh:
                self._count("streaming_device_carries")
                _devtel.note_bytes_avoided(_devtel.tree_nbytes(
                    (shared.valid, shared.ready, carry.total, carry.cpu,
                     carry.mem)))
                run.shared, run.carry = self._sharded.prepare_fused(
                    shared, carry, resident=dev)
            else:
                run.shared, run.carry = self._sharded.prepare_fused(shared,
                                                                    carry)
            return
        if dev is not None and st._mesh_active:
            # resident tier split but no mesh plan to consume it: the
            # unsharded run re-uploads from the host mirror
            dev = None
        if dev is None:
            _devtel.note_h2d("cold_build", _devtel.tree_nbytes(
                (tuple(shared), tuple(carry))))
            run.shared = named_to_device(FusedShared, shared, self.device)
            run.carry = named_to_device(FusedCarry, carry, self.device)
            return
        d_valid, d_ready, d_cpu, d_mem, d_total = dev
        self._count("streaming_device_carries")
        _devtel.note_bytes_avoided(_devtel.tree_nbytes(
            (shared.valid, shared.ready, carry.total, carry.cpu, carry.mem)))
        rest = (shared.os_hash, shared.arch_hash, shared.svc0, carry.svc_acc)
        _devtel.note_h2d("cold_build", _devtel.tree_nbytes(rest))
        os_hash, arch_hash, svc0, svc_acc = (tensor(a, self.device)
                                             for a in rest)
        total, cpu, mem = d_total.clone(), d_cpu.clone(), d_mem.clone()
        _devtel.note_d2d("resident_carry",
                         total.nbytes + cpu.nbytes + mem.nbytes)
        run.shared = FusedShared(valid=d_valid, ready=d_ready,
                                 os_hash=os_hash, arch_hash=arch_hash,
                                 svc0=svc0)
        run.carry = FusedCarry(total=total, cpu=cpu, mem=mem,
                               svc_acc=svc_acc)

    def _dispatch_fused_chunks(self, run) -> None:
        """Enqueue chunks until two are in flight (or the run is fully
        dispatched): the device plans chunk i+1 while the host applies and
        commits chunk i.  Each chunk writes its own result rows and copies
        them into its own pinned buffer, so a later chunk's launches never
        touch what an earlier chunk's copy reads; the carry they share is
        ordered by the stream."""
        while (not run.aborted and run.next_dispatch < len(run.chunks)
               and run.next_dispatch - run.next_fetch < 2):
            c = run.chunks[run.next_dispatch]
            _devtel.note_h2d("fused_inputs",
                             _devtel.tree_nbytes((c.groups, c.strat)))
            c.t0 = time.perf_counter()
            with tracer.span("plan.dispatch", "plan", tasks=c.tasks,
                             fused_groups=c.count):
                if self._sharded is not None:
                    c.pending = self._sharded.fused(
                        run.shared, c.groups, run.carry, run.L, c.strat,
                        sids=c.sids)
                else:
                    groups = named_to_device(FusedGroups, c.groups,
                                             self.device)
                    strat = None if c.strat is None else named_to_device(
                        FusedStrategy, c.strat, self.device)
                    c.pending = start_fetch(plan_fused_packed(
                        run.shared, groups, run.carry, run.L, strat,
                        sids=c.sids))
            _devtel.note_kernel(run.bucket_label(c), "fused",
                                dispatch_s=time.perf_counter() - c.t0,
                                groups=c.count, task_rows=c.tasks)
            c.groups = None   # release the numpy staging buffers
            c.strat = None
            run.next_dispatch += 1
            self._count("fused_chunks")

    def fetch_fused_chunk(self, run):
        """Wait for the next chunk's D2H and keep two chunks in flight.
        Returns (x [G, N], fail_counts [G, 8], spill [G], start, count) as
        numpy, or None when the run is exhausted or aborted."""
        if run.aborted or run.next_fetch >= run.next_dispatch:
            return None
        c = run.chunks[run.next_fetch]
        d2h_t0 = time.perf_counter()
        with tracer.span("plan.d2h", "plan"):
            rows = finish_fetch(c.pending)
            _devtel.note_d2h("fetch", int(rows.nbytes))
        c.pending = None
        run.next_fetch += 1
        end = time.perf_counter()
        _planes.plane(_planes.DEVICE).note_busy(end - d2h_t0)
        _devtel.note_kernel(run.bucket_label(c), "fused", d2h_s=end - d2h_t0)
        # chunk windows overlap (two in flight): charge plan_seconds only
        # the wall time this chunk added beyond the previous fetch
        self._observe_plan(end - max(c.t0, run.last_fetch_end))
        run.last_fetch_end = end
        self._note_inflight(end - c.t0)
        self._dispatch_fused_chunks(run)   # keep the pipeline primed
        xs, fcs, spills = unpack_fused(rows, run.nb)
        return xs, fcs, spills, c.start, c.count

    def apply_fused_group(self, run, gi: int, x_row, fail_row,
                          decisions) -> int:
        """Apply one fused group's placements to the scheduler mirrors and
        decision draft: the same simple-path apply as ``fetch_group``
        (fusable groups have no generic resources, host ports or
        shutdown-marked stragglers).  Returns the number of tasks placed;
        the group dict keeps any unplaceable leftovers and
        ``last_explanation`` is set for the caller's no-suitable-node
        pass."""
        spec = run.specs[gi]
        sched, t, task_group = run.sched, spec.t, spec.group
        infos, n, nb, valid, ready, cpu, mem, total = run.cols
        self.last_explanation = self._explain(fail_row)
        x = np.asarray(x_row)
        slots = np.repeat(np.arange(x.shape[0]), x).tolist()
        items = list(task_group.items())
        placed = min(len(items), len(slots))
        with tracer.span("plan.apply", "plan", tasks=placed):
            self._apply_assignments(sched, t, items[:placed],
                                    slots[:placed], infos, decisions,
                                    spec.cpu_d, spec.mem_d, x, cpu, mem,
                                    total)
        if placed == len(task_group):
            task_group.clear()
        else:
            for task_id, _ in items[:placed]:
                del task_group[task_id]
        self._count("groups_fused")
        if spec.sid:
            strategy_mod.count_group(spec.sname, "device")
        self._count("tasks_planned", placed)
        return placed

    def note_fused_spill(self, run) -> None:
        """A fused group's spread branches saturated: the group goes to
        the host oracle for exact reference parity (as on the per-group
        route), which invalidates the column cache and aborts the rest of
        the run -- later groups were planned against this group's device
        placement, which no longer happens."""
        self._count("groups_spill_to_host")
        self._cache = None
        self.abort_fused_run(run)

    def abort_fused_run(self, run) -> None:
        """Release a fused run (at its end or on an abort): staging
        buffers, pending copies and the device state."""
        run.aborted = True
        for c in run.chunks:
            c.pending = None
            c.groups = None
            c.strat = None
        run.carry = None
        run.shared = None
