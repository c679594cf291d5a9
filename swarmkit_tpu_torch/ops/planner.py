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
card.

Groups go to the host path for the features the device path does not
model: CSI volume mounts, non-discrete generic resources, spread trees
deeper than 4 levels, and static buckets that overflow (``groups_fallback``).
With the small-group router on (``enable_small_group_routing``, off by
default), small groups go to the host path too (``groups_small_to_host``):
a plan on the card costs a fixed round trip (``_measure_launch_overhead``
takes the median of several warm minimal plans through the per-group
route), while the host oracle costs ``host_cost_per_task`` a task, so below
the break-even the group stays on the host.

A launch or fetch error on the device (``ops.cuda.DEVICE_ERRORS``: a
refused launch, or the CUDA runtime's own error) never fails the tick: it
is logged, counted (``groups_device_error``, ``preempt_device_error``,
``gang_device_error``), fed to the :class:`PlannerBreaker`, and the group
goes to the host oracle, whose placements the kernels equal bit for bit.
Three failures in a row trip the breaker open: every route then takes the
host path (``groups_breaker_to_host``, ``preempt_breaker_to_host``) until a
cooldown has passed and one half-open probe group succeeds on the card.
Anything else a route raises -- a kernel that does not build
(``ops.cuda.KernelBuildError``), a fault of the program -- is never routed
around: it raises out of the route and leaves the breaker as it was.  The
plain versions on the CPU never raise a device error.

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

import logging
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
from . import cuda as _cuda
from .cuda import DEVICE_ERRORS
from .preempt import plan_victims

log = logging.getLogger("torch-planner")

#: the host oracle's cost a task, which the small-group router weighs
#: against the launch overhead: the median of three host-only ticks of
#: 10,000 tasks on 1,000 nodes (``chip_smoke.py``'s breaker phase) on the
#: host of an NVIDIA H100 80GB HBM3 machine.  The model has no term for
#: the host path's pass over every node a group, which the same phase's
#: trickle of small groups shows to dominate: hence the router is off by
#: default
HOST_COST_PER_TASK = 29.4e-6

#: the registry's counters of work that left the card for a device error
#: or an open breaker, on every route (groups, gang verdicts, victim
#: picks), and of the breaker's trips: a run on a healthy card moves none
DEVICE_FAULT_COUNTERS = (
    "swarm_planner_groups_device_error",
    'swarm_planner_groups{route="breaker"}',
    "swarm_planner_gang_device_error",
    "swarm_planner_preempt_device_error",
    "swarm_planner_preempt_breaker_to_host",
    "swarm_planner_breaker_trips")

_PLAN_TIMER = _metrics.timer("swarm_planner_plan_latency")
_COMPILE_TIMER = _metrics.timer("swarm_planner_compile_latency")


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


def _probe_inputs():
    """The launch-overhead probe's minimal plan: 1,024 ready nodes, 8
    tasks, no constraint, one flat segment."""
    nb = 1024
    valid = np.ones(nb, bool)
    nodes = NodeInputs(
        valid=valid, ready=valid.copy(),
        res_ok=valid.copy(), res_cap=np.full(nb, 8, np.int32),
        svc_tasks=np.zeros(nb, np.int32), total_tasks=np.zeros(nb, np.int32),
        failures=np.zeros(nb, np.int32), leaf=np.zeros(nb, np.int32),
        os_hash=np.zeros((2, nb), np.int32),
        arch_hash=np.zeros((2, nb), np.int32),
        port_conflict=np.zeros(nb, bool), extra_mask=np.ones(nb, bool))
    group = GroupInputs(
        k=np.int32(8), con_hash=np.zeros((1, 2, nb), np.int32),
        con_op=np.full(1, 2, np.int32), con_exp=np.zeros((1, 2), np.int32),
        plat=np.full((1, 4), -1, np.int32), maxrep=np.int32(0),
        port_limited=np.bool_(False))
    return nodes, group


BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0, 1, 2
_BREAKER_NAMES = {BREAKER_CLOSED: "closed", BREAKER_HALF_OPEN: "half-open",
                  BREAKER_OPEN: "open"}


class PlannerBreaker:
    """Degraded-mode circuit breaker for the device path.

    ``threshold`` consecutive device launch or fetch failures trip the
    breaker OPEN: every group routes to the host oracle (placements stay
    valid, the tick never fails) until the cooldown elapses.  The breaker
    then goes HALF-OPEN and admits a single probe group; a successful probe
    closes it, a failed probe re-opens it with a doubled (capped) cooldown.
    Successful closes decay the accumulated cooldown back toward the base,
    so a device that recovers cleanly is re-trusted quickly while a
    flapping one backs off geometrically.

    State is exported as the ``swarm_planner_breaker_state`` gauge
    (0=closed, 1=half-open, 2=open), every trip counts
    ``swarm_planner_breaker_trips`` and lands in the flight recorder, and
    every admitted probe counts ``swarm_planner_breaker_probes``.  Time is
    read through ``models.types.now()`` so a virtual clock drives the
    cooldown deterministically.
    """

    def __init__(self, threshold: int = 3, cooldown: float = 30.0,
                 max_cooldown: float = 480.0):
        self.threshold = max(1, threshold)
        self.base_cooldown = cooldown
        self.max_cooldown = max_cooldown
        self._state = BREAKER_CLOSED
        self._failures = 0          # consecutive, resets on success
        self._cooldown = cooldown
        self._open_until = 0.0
        self._probe_inflight = False
        self.stats = {"trips": 0, "probes": 0, "failures": 0}
        self._export()

    def _export(self) -> None:
        _metrics.gauge("swarm_planner_breaker_state", self._state)

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _BREAKER_NAMES[self._state]

    def allow_device(self) -> bool:
        """Gate one group's device dispatch.  OPEN past its cooldown flips
        to HALF-OPEN and admits exactly one probe; every other caller stays
        on the host until the probe resolves."""
        if self._state == BREAKER_CLOSED:
            return True
        if self._state == BREAKER_OPEN:
            if now() < self._open_until:
                return False
            self._state = BREAKER_HALF_OPEN
            self._probe_inflight = False
            self._export()
        # HALF_OPEN: single probe at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        self.stats["probes"] += 1
        _metrics.counter("swarm_planner_breaker_probes")
        return True

    def abort_probe(self) -> None:
        """The admitted group never reached the device (routed to host for
        an unrelated reason): release the probe slot unchanged."""
        self._probe_inflight = False

    def record_success(self) -> None:
        self._failures = 0
        if self._state == BREAKER_HALF_OPEN:
            self._probe_inflight = False
            self._state = BREAKER_CLOSED
            # decay the accumulated backoff toward the base: a clean
            # recovery is re-trusted, a flapper keeps most of its penalty
            self._cooldown = max(self.base_cooldown, self._cooldown / 2.0)
            self._export()
            log.info("planner breaker closed (device recovered)")

    def record_failure(self) -> None:
        self.stats["failures"] += 1
        if self._state == BREAKER_HALF_OPEN:
            # failed probe: back off harder
            self._cooldown = min(self._cooldown * 2.0, self.max_cooldown)
            self._trip()
            return
        self._failures += 1
        if self._state == BREAKER_CLOSED \
                and self._failures >= self.threshold:
            self._trip()

    def _trip(self) -> None:
        self._state = BREAKER_OPEN
        self._probe_inflight = False
        self._failures = 0
        self._open_until = now() + self._cooldown
        self.stats["trips"] += 1
        _metrics.counter("swarm_planner_breaker_trips")
        self._export()
        log.warning("planner breaker OPEN for %.1fs: device path "
                    "degraded to host fallback", self._cooldown)
        from ..obs.flightrec import flightrec
        flightrec.note(f"planner breaker tripped open "
                       f"(cooldown {self._cooldown:.1f}s)")


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
    device, where the unsharded work runs.  ``breaker`` replaces the
    default :class:`PlannerBreaker` (threshold 3, cooldown 30 s)."""

    def __init__(self, device=None, mesh=None, breaker=None):
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
                      "groups_small_to_host": 0,
                      "tasks_planned": 0, "plan_seconds": 0.0}
        # the small-group router: with it on, a group too small to
        # amortize the measured launch overhead (dispatch + D2H round trip
        # of a minimal plan) against the host oracle's per-task cost stays
        # on the host path.  Off by default: every supported group goes to
        # the device
        self.enable_small_group_routing = False
        self._launch_overhead = None
        self.host_cost_per_task = HOST_COST_PER_TASK
        # degraded-mode circuit breaker: consecutive device failures trip
        # the whole planner to the host path instead of failing ticks
        self.breaker = breaker if breaker is not None else PlannerBreaker()
        self._fused_dead = False     # set on fused errors: the rest of the
        #                              tick rides the per-group route
        self._fused_active = None    # in-flight FusedRun (tick aborts)
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
              "groups_small_to_host": "host_small",
              "groups_spill_to_host": "spill",
              "groups_breaker_to_host": "breaker"}

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

    def _to_device(self, nodes_np, group_np, hier_np, h2d="group_inputs"):
        _devtel.note_h2d(h2d,
                         _devtel.tree_nbytes((nodes_np, group_np, hier_np)))
        return to_device(nodes_np, group_np, hier_np, self.device)

    def _observe_compile(self, bucket: str) -> float:
        """The port's compile accounting: the kernels are built once, at
        the first launch in the process (``ops/cuda.py``), so the build's
        seconds are charged to the bucket whose launch paid them -- a
        ``swarm_planner_compiles{bucket=...}`` tick, a compile timer
        observation, a ``plan.compile`` span and the ledger's ``compile_s``
        -- and every other launch is a cache hit.  Returns the seconds."""
        dt = _cuda.take_build_seconds() if self.device.type == "cuda" \
            else 0.0
        if dt <= 0.0:
            _devtel.note_cache_hit(bucket)
            return 0.0
        _metrics.counter(f'swarm_planner_compiles{{bucket="{bucket}"}}')
        _COMPILE_TIMER.observe(dt)
        _devtel.note_compile(bucket, dt)
        from ..models.types import time_source_installed
        tracer.record_complete("plan.compile", "plan",
                               0.0 if time_source_installed() else dt,
                               bucket=bucket)
        return dt

    # ------------------------------------------------------- per-tick caching

    def begin_tick(self, sched) -> None:
        self._in_tick = True
        self._fused_dead = False
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
        if self._fused_active is not None:   # abandoned run (aborted tick)
            self.abort_fused_run(self._fused_active)
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

    # per-process launch overhead by device type (the link to the card,
    # whatever the planner's mesh): only a successful measurement is
    # shared, so every planner of a process routes the same groups
    _launch_overhead_shared: Dict[str, float] = {}
    # timed plans a measurement takes the median of
    LAUNCH_PROBE_SAMPLES = 7

    def _measure_launch_overhead(self) -> None:
        """Time warm minimal plans through the planner's own per-group
        route (``_probe_inputs``' shape, node bucket 1,024): the dispatch,
        the event and the pinned D2H, after one untimed call; the overhead
        is the median of ``LAUNCH_PROBE_SAMPLES`` of them.  On
        ``device="cpu"`` this times the plain path.  Measured once per
        process and device kind and shared across planners; a device error
        leaves 0.0 here and shares nothing, and anything else raises."""
        key = self.device.type
        shared = TorchPlanner._launch_overhead_shared.get(key)
        if shared is not None:
            self._launch_overhead = shared
            return
        nodes_np, group_np = _probe_inputs()
        nb = nodes_np.valid.shape[0]

        def plan():
            fetch_plan(self._enqueue_plan(nodes_np, group_np, 1, (), None,
                                          None, h2d="launch_probe"), nb)
        try:
            plan()
            samples = []
            for _ in range(self.LAUNCH_PROBE_SAMPLES):
                t0 = time.perf_counter()
                plan()
                samples.append(time.perf_counter() - t0)
        except DEVICE_ERRORS:
            log.exception("launch-overhead probe failed")
            self._launch_overhead = 0.0
            return
        self._launch_overhead = float(np.median(samples))
        TorchPlanner._launch_overhead_shared[key] = self._launch_overhead

    def _below_break_even(self, n_tasks: int) -> bool:
        """True when a group is too small to amortize the device launch
        overhead.  The single predicate every routing site shares
        (dispatch_group, the preassigned validation and the fused-run
        probe), so fused and per-group routing cannot drift apart."""
        if not self.enable_small_group_routing:
            return False
        if self._launch_overhead is None:
            self._measure_launch_overhead()
        return (n_tasks * self.host_cost_per_task
                < 0.8 * self._launch_overhead)

    def _device_failed(self, what: str, key: str) -> None:
        """A launch or fetch error: logged with its traceback, counted
        under ``key`` and fed to the breaker."""
        log.exception("device %s failed; host path", what)
        self._count(key)
        self.breaker.record_failure()

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
        caller runs the host path: an unsupported feature, an open
        breaker, a group below the break-even, or a launch error)."""
        t = next(iter(task_group.values()))
        if not self._supported(t):
            self._fallback()
            return None
        sinfo = strategy_mod.resolve(strategy_mod.strategy_of(t))
        if sinfo is None:
            # unknown strategy name: the host path serves it
            self._fallback()
            return None
        if not self.breaker.allow_device():
            # degraded mode: a sick device routes every group to the host
            # oracle until the breaker's cooldown and probe admit it
            self._count("groups_breaker_to_host")
            self._cache = None   # host path mutates NodeInfos
            return None
        if self._below_break_even(len(task_group)):
            self._count("groups_small_to_host")
            self.breaker.abort_probe()   # never reached the device
            self._cache = None   # host path mutates NodeInfos
            return None
        flat = sinfo.sid != strategy_mod.STRAT_SPREAD

        plan_t0 = time.perf_counter()
        k = len(task_group)
        if k > K_CLAMP:  # beyond the kernels' 32-bit budget
            self.breaker.abort_probe()
            self._fallback()
            return None
        if self._inflight:
            self.breaker.abort_probe()
            raise RuntimeError(
                "dispatch_group with a plan already in flight: fetch it "
                "first (its apply feeds this group's input columns)")
        with tracer.span("plan.build_inputs", "plan", tasks=k):
            built = self._build_device_inputs(sched, t, k, flat=flat)
            sin_np = self._build_strategy_inputs(built, t, sinfo) \
                if flat and built is not None and built[1] else None
        if built is None:
            self.breaker.abort_probe()
            self._fallback()
            return None
        if built[1] == 0:   # no valid nodes densified
            self.breaker.abort_probe()
            return None
        nodes_np, group_np, L, hier_np = built[7], built[8], built[9], \
            built[10]
        bucket = _bucket_label(nodes_np, group_np, L, hier_np)
        route = "strategy" if flat else "group"
        if flat:
            bucket += f"_st{sinfo.sid}"
        if self._sharded is not None:
            bucket += f"_x{self.mesh.size}"
        try:
            with tracer.span("plan.dispatch", "plan", tasks=k):
                t0 = time.perf_counter()
                pending = self._enqueue_plan(nodes_np, group_np, L, hier_np,
                                             sin_np, sinfo.sid if flat
                                             else None)
                dt = time.perf_counter() - t0
        except DEVICE_ERRORS:
            # a launch failure degrades THIS group to the host path and
            # feeds the breaker: a sick device trips to wholesale host
            # routing instead of failing the tick
            self._device_failed("dispatch", "groups_device_error")
            self._cache = None
            return None
        except BaseException:
            self.breaker.abort_probe()
            raise
        _devtel.note_kernel(bucket, route, dispatch_s=dt,
                            compile_s=self._observe_compile(bucket),
                            task_rows=k, node_rows=nodes_np.valid.shape[0],
                            strategy_id=sinfo.sid if flat else -1)
        if flat:
            strategy_mod.count_group(sinfo.name, "device")
        handle = _InFlightPlan(sched, t, task_group, decisions, built,
                               plan_t0, pending, bucket, route)
        self._inflight.append(handle)
        return handle

    def _enqueue_plan(self, nodes_np, group_np, L, hier_np, sin_np, sid,
                      h2d="group_inputs"):
        """Upload one group's numpy inputs and enqueue its plan -- the
        spread plan, or with ``sid`` set the strategy plan -- and the D2H
        of its result rows; returns the ``PendingFetch``.  On a mesh each
        shard's slice goes to its device and the rows come back in one
        pinned buffer.  The uploads are noted in the H2D ledger under
        ``h2d`` (the strategy columns under ``strategy_inputs``)."""
        if self._sharded is not None:
            _devtel.note_h2d(h2d, _devtel.tree_nbytes(
                (nodes_np, group_np, hier_np, sin_np)))
            if sid is not None:
                return self._sharded.strategy(nodes_np, group_np, sin_np,
                                              sid)
            return self._sharded(nodes_np, group_np, L, hier_np)
        nodes_in, group_in, hier = self._to_device(nodes_np, group_np,
                                                   hier_np, h2d)
        if sid is not None:
            _devtel.note_h2d("strategy_inputs", _devtel.tree_nbytes(sin_np))
            sin = named_to_device(StrategyInputs, sin_np, self.device)
            buf = plan_strategy_packed(nodes_in, group_in, sin, sid)
        else:
            buf = plan_group_packed(nodes_in, group_in, L, hier)
        return start_fetch(buf)

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
        """Shared apply: clone+register the assigned tasks (the native C
        loops when available, ``native/hotpath.c``) and do the per-NODE
        mirror arithmetic in batch.  ``counts``: i32[nb] tasks placed per
        node column."""
        from ..scheduler.scheduler import SchedulingDecision

        from .. import native
        hp = native.get()
        all_tasks = sched.all_tasks
        # resident row lists when the streaming plane owns these infos
        # (identity-guarded): no O(cluster) list builds per group
        st = self._streaming
        if st is not None and st.infos is not infos:
            st = None
        if getattr(sched, "block_mode", False):
            # columnar end-to-end: each group stages one (olds, nids,
            # message) column triple and commits as one array-shaped store
            # call (store.commit_task_block); mirrors keep the
            # pre-assignment object
            node_id_by_i = st.node_ids if st is not None \
                else [info.node.id for info in infos]
            if hp is not None:
                task_dict_by_i = st.task_dicts if st is not None \
                    else [info.tasks for info in infos]
                olds, nids = hp.block_stage(items, slots, node_id_by_i,
                                            task_dict_by_i)
            else:
                olds, nids = [], []
                for (task_id, task), i in zip(items, slots):
                    olds.append(task)
                    nids.append(node_id_by_i[i])
                    infos[i].tasks[task_id] = task
            if olds:
                sched.block_draft.append((olds, nids, message))
        elif hp is not None:
            shared_status = TaskStatus(
                state=TaskState.ASSIGNED, timestamp=now(), message=message)
            node_id_by_i = st.node_ids if st is not None \
                else [info.node.id for info in infos]
            task_dict_by_i = st.task_dicts if st is not None \
                else [info.tasks for info in infos]
            hp.plan_apply(items, slots, node_id_by_i, task_dict_by_i,
                          shared_status, all_tasks, decisions,
                          SchedulingDecision)
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
        if not self.breaker.allow_device():
            # breaker open: the host loop validates; counted like
            # dispatch_group so route breakdowns stay honest
            self._count("groups_breaker_to_host")
            return tasks
        if self._below_break_even(len(tasks)):
            self.breaker.abort_probe()
            return tasks   # below device break-even: host loop
        plan_t0 = time.perf_counter()
        with tracer.span("plan.build_inputs", "plan", tasks=len(tasks)):
            built = self._build_device_inputs(sched, t, len(tasks))
        if built is None or built[1] == 0:
            self.breaker.abort_probe()
            return tasks
        (infos, n, nb, valid, cpu, mem, total, nodes_np, group_np, L,
         hier, cpu_d, mem_d, gen_wanted, port_limited) = built
        if gen_wanted or port_limited:
            self.breaker.abort_probe()
            return tasks   # per-task claim bookkeeping: host path

        try:
            with tracer.span("plan.feasibility", "plan", tasks=len(tasks)):
                bucket = "feas_" + _bucket_label(nodes_np, group_np, 1, ())
                t0 = time.perf_counter()
                nodes_in, group_in, _ = self._to_device(nodes_np, group_np,
                                                        ())
                buf = finish_fetch(start_fetch(feasibility_packed(
                    nodes_in, group_in)))
                _devtel.note_d2h("feasibility", int(buf.nbytes))
                _devtel.note_kernel(bucket, "feasibility",
                                    dispatch_s=time.perf_counter() - t0,
                                    compile_s=self._observe_compile(bucket),
                                    task_rows=len(tasks), node_rows=nb)
        except DEVICE_ERRORS:
            self._device_failed("feasibility", "groups_device_error")
            self._cache = None
            return tasks
        except BaseException:
            self.breaker.abort_probe()
            raise
        self.breaker.record_success()
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
        results are never applied, and the column cache is invalidated.  A
        discarded plan may have been the breaker's half-open probe: its
        slot is released (no outcome observed), or the breaker would stay
        wedged in half-open with no path back to the device."""
        self.breaker.abort_probe()
        if self._inflight:
            self._inflight.clear()
            self._cache = None
        if self._fused_active is not None:
            self.abort_fused_run(self._fused_active)
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
        try:
            with tracer.span("plan.d2h", "plan"):
                x, fail_counts, spill = fetch_plan(handle.pending, nb)
        except DEVICE_ERRORS:
            # the plan is lost but the group is not: it re-runs through
            # the host oracle (return False), and the breaker counts the
            # device failure
            handle.pending = None
            self._observe_plan(time.perf_counter() - plan_t0)
            self._device_failed("fetch", "groups_device_error")
            self._cache = None
            return False
        except BaseException:
            self.breaker.abort_probe()
            raise
        handle.pending = None
        # the d2h wait IS the device plane's busy window
        d2h_dt = time.perf_counter() - d2h_t0
        _planes.plane(_planes.DEVICE).note_busy(d2h_dt)
        _devtel.note_kernel(handle.bucket, handle.route, d2h_s=d2h_dt)
        self.breaker.record_success()
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
        Routed through the same breaker as planning: an open breaker or a
        launch or fetch error returns None and the scheduler runs the host
        oracle instead; a kernel that does not build raises."""
        if not self.breaker.allow_device():
            self._count("preempt_breaker_to_host")
            return None
        try:
            t0 = time.perf_counter()
            with tracer.span("plan.preempt", "plan", picks=n_picks):
                picks, bucket = plan_victims(cand, cpu_d, mem_d, gen_d,
                                             n_picks, budget, self.device,
                                             self._victim_stages)
            dt = time.perf_counter() - t0
        except DEVICE_ERRORS:
            self._device_failed("victim selection", "preempt_device_error")
            return None
        except BaseException:
            self.breaker.abort_probe()
            raise
        _devtel.note_kernel(bucket, "preempt", dispatch_s=dt,
                            compile_s=self._observe_compile(bucket),
                            task_rows=n_picks,
                            node_rows=int(cand.ok.shape[0]))
        self.breaker.record_success()
        return picks

    # ------------------------------------------------- gang feasibility

    def gang_feasible(self, sched, t: Task, k: int) -> Optional[bool]:
        """Group-level all-members-feasible verdict for a gang member
        group (reference ``gang_feasible``): True/False from K8, None when
        no verdict is available (a static bucket overflow), and the caller
        then decides by a placement attempt and rollback.  Behind the
        breaker, with the bit-equal host oracle (``gang_fit_host``) serving
        an open breaker or a launch error: a breaker flip never changes a
        verdict."""
        built = self._build_device_inputs(sched, t, k)
        if built is None:
            return None
        nodes_np, group_np = built[7], built[8]
        if built[1] == 0:
            return False
        bucket = _bucket_label(nodes_np, group_np, built[9], built[10])
        return self._gang_fit_one(nodes_np, group_np, bucket + "_gf")

    def _gang_fit_one(self, nodes_np, group_np, bucket: str) -> bool:
        """One gang's verdict: K8 behind the breaker (counted
        ``gang_fit_device``), the host oracle on an open breaker or a
        launch error (``gang_fit_host``)."""
        if self.breaker.allow_device():
            try:
                fit = self._gang_fit_rows([(nodes_np, group_np)], bucket)[0]
            except DEVICE_ERRORS:
                self._device_failed("gang_fit", "gang_device_error")
            except BaseException:
                self.breaker.abort_probe()
                raise
            else:
                self.breaker.record_success()
                return fit
        return self._gang_fit_host(nodes_np, group_np)

    def _gang_fit_host(self, nodes_np, group_np):
        from ..scheduler import gang as gang_mod
        self._count("gang_fit_host")
        fit, _fc = gang_mod.gang_fit_host(nodes_np, group_np)
        return fit

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
                                compile_s=self._observe_compile(bucket),
                                task_rows=int(rows[0][1].k),
                                node_rows=rows[0][0].valid.shape[0])
            self._count("gang_fit_device")
        else:
            _devtel.note_kernel(bucket, "gang_fused",
                                dispatch_s=time.perf_counter() - t0,
                                compile_s=self._observe_compile(bucket),
                                groups=g)
            self._count("gang_fit_fused", g)
        return [bool(f) for f in fits]

    def gang_feasible_many(self, sched, wants) -> list:
        """Fused gang route: verdicts for ``wants`` = [(t, k), ...].
        Groups of one input-shape bucket (the same label, quota-mask
        presence included) stack on a leading gang axis and are judged in
        ONE K8 launch (bucket suffix ``_gfF``); a bucket with one group,
        or an open breaker, takes the per-group route (``_gf``), and a
        launch error the host oracle.  Returns [Optional[bool]] aligned
        with ``wants``."""
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
            if len(rows) < 2 or not self.breaker.allow_device():
                for i, nodes_np, group_np in rows:
                    results[i] = self._gang_fit_one(nodes_np, group_np,
                                                    label + "_gf")
                continue
            try:
                fits = self._gang_fit_rows([(n, g) for _, n, g in rows],
                                           label + "_gfF")
            except DEVICE_ERRORS:
                self._device_failed("fused gang_fit", "gang_device_error")
                for i, nodes_np, group_np in rows:
                    results[i] = self._gang_fit_host(nodes_np, group_np)
                continue
            except BaseException:
                self.breaker.abort_probe()
                raise
            self.breaker.record_success()
            for (i, _n, _g), fit in zip(rows, fits):
                results[i] = fit
        return results

    # ------------------------------------------------------------ fused route

    def probe_fused_run(self, sched, glist, start: int) -> list:
        """Maximal run of consecutive fusable groups from ``glist[start:]``,
        as parsed GroupSpecs.  Empty when fusion is off or dead for this
        tick, the breaker is not closed (per-group routing owns the probe
        accounting), or the first group is not fusable or below the
        break-even: the scheduler then takes the per-group route for
        exactly the groups a per-group tick would route the same way."""
        if not self.fused_enabled or self._fused_dead:
            return []
        if self.breaker.state != BREAKER_CLOSED:
            return []
        specs = []
        for group in glist[start:]:
            if self._below_break_even(len(group)):
                break   # below device break-even: host path
            spec = fusedbatch.probe_group(self, sched, group)
            if spec is None:
                break
            specs.append(spec)
        return specs

    def dispatch_fused_run(self, sched, specs):
        """Densify one fused run (>= 2 groups), move its node state to the
        device and enqueue its first chunks.  Returns the FusedRun, or None
        when the run cannot be built (no node, a bucket overflow) or its
        first dispatch fails: the caller then takes its groups one by one,
        and no mirror state was touched.  A launch error also feeds the
        breaker and ends fusion for the rest of the tick."""
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
        try:
            self._prepare_fused(run)
            self._dispatch_fused_chunks(run)
        except DEVICE_ERRORS:
            self._device_failed("fused dispatch", "groups_device_error")
            self._fused_dead = True
            return None
        if run.dispatch_dead and run.next_dispatch == 0:
            return None
        self._fused_active = run
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
        ordered by the stream.  A launch error marks the run dispatch-dead:
        the chunks already dispatched still apply, and the rest of the
        tick rides the per-group route."""
        while (not run.dispatch_dead and not run.aborted
               and run.next_dispatch < len(run.chunks)
               and run.next_dispatch - run.next_fetch < 2):
            c = run.chunks[run.next_dispatch]
            _devtel.note_h2d("fused_inputs",
                             _devtel.tree_nbytes((c.groups, c.strat)))
            c.t0 = time.perf_counter()
            try:
                with tracer.span("plan.dispatch", "plan", tasks=c.tasks,
                                 fused_groups=c.count):
                    if self._sharded is not None:
                        c.pending = self._sharded.fused(
                            run.shared, c.groups, run.carry, run.L, c.strat,
                            sids=c.sids)
                    else:
                        groups = named_to_device(FusedGroups, c.groups,
                                                 self.device)
                        strat = None if c.strat is None \
                            else named_to_device(FusedStrategy, c.strat,
                                                 self.device)
                        c.pending = start_fetch(plan_fused_packed(
                            run.shared, groups, run.carry, run.L, strat,
                            sids=c.sids))
            except DEVICE_ERRORS:
                self._device_failed("fused chunk dispatch",
                                    "groups_device_error")
                self._fused_dead = True
                run.dispatch_dead = True
                return
            bucket = run.bucket_label(c)
            _devtel.note_kernel(bucket, "fused",
                                dispatch_s=time.perf_counter() - c.t0,
                                compile_s=self._observe_compile(bucket),
                                groups=c.count, task_rows=c.tasks)
            c.groups = None   # release the numpy staging buffers
            c.strat = None
            run.next_dispatch += 1
            self._count("fused_chunks")

    def fetch_fused_chunk(self, run):
        """Wait for the next chunk's D2H and keep two chunks in flight.
        Returns (x [G, N], fail_counts [G, 8], spill [G], start, count) as
        numpy, or None when the run is exhausted, aborted or its fetch
        failed (the remaining groups take the per-group route)."""
        if run.aborted or run.next_fetch >= run.next_dispatch:
            return None
        c = run.chunks[run.next_fetch]
        d2h_t0 = time.perf_counter()
        try:
            with tracer.span("plan.d2h", "plan"):
                rows = finish_fetch(c.pending)
                _devtel.note_d2h("fetch", int(rows.nbytes))
        except DEVICE_ERRORS:
            self._device_failed("fused fetch", "groups_device_error")
            self._fused_dead = True
            self._cache = None
            self.abort_fused_run(run)
            return None
        c.pending = None
        run.next_fetch += 1
        self.breaker.record_success()
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
        if self._fused_active is run:
            self._fused_active = None
