"""One run of one cell: the program's cluster built from the traffic's
plain data, set-up, the measured window, and the check of what the
window committed against the plain reference.

The program's entry is the scheduler as a manager runs it: a
``Scheduler(store, batch_planner=TorchPlanner(device=...))`` fed by the
store's watch stream (``SteadyStateChurn.attach`` / ``pump`` of
``swarmkit_tpu_torch/workload.py``), its preassigned pass and its tick.
Every step of the closed loop writes the traffic to the store, pumps the
watch stream into the scheduler, runs the preassigned pass when tasks
wait on it, and one tick.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import bench as bench_mod
from . import generator
from .reference.placement import Reference   # the judge's interface

#: modules that may not be loaded in a run's process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "swarmkit_tpu")

#: the planner's counters of groups that a measured window planned off
#: the card (an unsupported feature, the small-group router, a saturated
#: spread branch, an open breaker, a device error) and the breaker's
#: trips: a run whose window moves any of them did not time the device
#: path, and prints no result
HOST_ROUTES = ("groups_fallback", "groups_small_to_host",
               "groups_spill_to_host", "groups_breaker_to_host",
               "groups_device_error", "preempt_device_error",
               "gang_device_error", "breaker_trips")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Record:
    """What a run measured, for the metric readers (``metrics/*.py``).

    ``steps``: per measured step, its seconds of store writes
    (``write_s``), watch feed (``feed_s``), preassigned pass (``pre_s``)
    and tick (``tick_s``).
    ``window_s``, ``setup_s``; ``placed`` and ``attempted``: the tasks of
    the measured steps that the store shows placed, and all of them;
    ``host_routes``: the window's moves of each of :data:`HOST_ROUTES`.
    Traced runs add ``spans`` ((name, start, end, thread) of the
    program's tracer, epoch seconds), ``planner_stats`` (the planner's
    ``stats`` over the window), ``device`` (a :class:`profile.DeviceTrace`
    or None off a card) and ``work`` (the plans the ticks asked for)."""

    def __init__(self):
        self.steps: List[dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.placed = 0
        self.attempted = 0
        self.host_routes: Dict[str, int] = {}
        self.traced = False
        self.spans: List[tuple] = []
        self.planner_stats: Dict[str, float] = {}
        self.device = None
        self.work: List[dict] = []
        #: seconds after the window: reading the device trace, the check
        self.after: Dict[str, float] = {}

    @property
    def ticks(self) -> int:
        return len(self.steps)


class Cluster:
    """The program's side: store, scheduler, planner and the watch feed,
    built from a :class:`generator.Traffic`."""

    def __init__(self, traffic: generator.Traffic, device: str,
                 pipeline_depth: Optional[int]):
        from swarmkit_tpu_torch import models as M
        from swarmkit_tpu_torch.ops import TorchPlanner
        from swarmkit_tpu_torch.scheduler import Scheduler
        from swarmkit_tpu_torch.state import ByService, MemoryStore
        from swarmkit_tpu_torch.obs.trace import tracer
        self.M = M
        self.ByService = ByService
        self.tracer = tracer
        self.store = store = MemoryStore()
        self.nodes = [self._node(x) for x in traffic.nodes]
        self.index = {x["id"]: i for i, x in enumerate(traffic.nodes)}
        self.specs: Dict[str, object] = {}
        self.shapes = traffic.shapes
        #: task id -> (node id, state) of tasks removed with their service
        self.removed_ids: List[str] = []
        self.removed_nodes: List[str] = []
        self.removed_states: List[int] = []
        store.update(lambda tx: [tx.create(n) for n in self.nodes])
        services = {sid: self._service(sid, shape)
                    for sid, shape in traffic.services.items()}
        if services:
            store.update(lambda tx: [tx.create(s)
                                     for s in services.values()])
        if traffic.base:
            def mk_base(tx):
                for k, (tid, sid, i) in enumerate(traffic.base):
                    tx.create(M.Task(
                        id=tid, service_id=sid, slot=k + 1,
                        desired_state=M.TaskState.RUNNING,
                        spec=self.specs[sid],
                        spec_version=M.Version(index=1),
                        node_id=self.nodes[i].id,
                        status=M.TaskStatus(state=M.TaskState.RUNNING)))
            store.update(mk_base)
        self.planner = TorchPlanner(device=device)
        self.sched = Scheduler(store, batch_planner=self.planner,
                               pipeline_depth=pipeline_depth)
        _, self.sub = store.view_and_watch(
            lambda tx: self.sched._setup_tasks_list(tx), accepts_blocks=True)

    # ------------------------------------------------------ program objects

    def _node(self, x: dict):
        M = self.M
        return M.Node(
            id=x["id"],
            spec=M.NodeSpec(annotations=M.Annotations(
                name=x["hostname"], labels=dict(x["labels"]))),
            status=M.NodeStatus(state=M.NodeState.READY),
            description=M.NodeDescription(
                hostname=x["hostname"],
                platform=M.Platform(os=x["os"], architecture=x["arch"]),
                resources=M.Resources(nano_cpus=x["cpu"],
                                      memory_bytes=x["mem"])))

    def _spec(self, shape: dict):
        M = self.M
        return M.TaskSpec(
            placement=M.Placement(
                constraints=list(shape["constraints"]),
                platforms=[M.Platform(os=p.get("os", ""),
                                      architecture=p.get("arch", ""))
                           for p in shape["platforms"]],
                preferences=[M.PlacementPreference(spread=M.SpreadOver(
                    spread_descriptor=d)) for d in shape["spread"]],
                strategy=shape.get("strategy", "spread")),
            resources=M.ResourceRequirements(reservations=M.Resources(
                nano_cpus=shape["cpu"], memory_bytes=shape["mem"])))

    def _service(self, sid: str, shape_name: str):
        M = self.M
        spec = self.specs[sid] = self._spec(self.shapes[shape_name])
        return M.Service(
            id=sid,
            spec=M.ServiceSpec(annotations=M.Annotations(name=sid),
                               mode=M.ServiceMode.REPLICATED,
                               replicated=M.ReplicatedService(replicas=0),
                               task=spec),
            spec_version=M.Version(index=1))

    # -------------------------------------------------------------- a step

    def write(self, step: dict) -> None:
        """The step's store writes: its tasks reported RUNNING, the
        removal of its old services with their tasks, the creation of its
        services and tasks, its exits; one transaction each.

        They run with the cyclic collector paused, as the program's
        cluster builders run theirs (``build_cluster`` and the other
        builders of ``swarmkit_tpu_torch/workload.py`` under
        ``utils.gctune.paused_gc``): the store's objects are trees that
        reference counting frees, and the collections that a write of
        100,000 tasks triggers otherwise take a share of the window that
        swings with the host.  The collector is on again from the feed
        on, the rest of the step's code being the program's."""
        enabled = gc.isenabled()
        gc.disable()
        try:
            self._write(step)
        finally:
            if enabled:
                gc.enable()

    def _write(self, step: dict) -> None:
        M, store = self.M, self.store
        if step["running"]:
            def report(tx):
                ts = M.now()
                for tid in step["running"]:
                    cur = tx.get(M.Task, tid)
                    if cur is None or cur.status.state != \
                            M.TaskState.ASSIGNED:
                        continue
                    cur = cur.copy()
                    cur.status = M.TaskStatus(state=M.TaskState.RUNNING,
                                              timestamp=ts)
                    tx.update(cur)
            store.update(report)
        if step["remove"]:
            def remove(tx):
                for sid in step["remove"]:
                    for t in tx.find(M.Task, self.ByService(sid)):
                        self.removed_ids.append(t.id)
                        self.removed_nodes.append(t.node_id)
                        self.removed_states.append(int(t.status.state))
                        tx.delete(M.Task, t.id)
                    tx.delete(M.Service, sid)
            store.update(remove)
            for sid in step["remove"]:
                self.specs.pop(sid, None)
        if step["services"] or step["create"]:
            services = [self._service(sid, shape)
                        for sid, shape in step["services"].items()]
            nodes, specs = self.nodes, self.specs

            def create(tx):
                for s in services:
                    tx.create(s)
                ts = M.now()
                for slot, (tid, sid, pre) in enumerate(step["create"], 1):
                    tx.create(M.Task(
                        id=tid, service_id=sid, slot=0 if pre >= 0 else slot,
                        desired_state=M.TaskState.RUNNING, spec=specs[sid],
                        spec_version=M.Version(index=1),
                        node_id=nodes[pre].id if pre >= 0 else "",
                        status=M.TaskStatus(state=M.TaskState.PENDING,
                                            timestamp=ts)))
            store.update(create)
        if step["exits"]:
            def exit_tasks(tx):
                ts = M.now()
                for tid in step["exits"]:
                    cur = tx.get(M.Task, tid)
                    if cur is None:
                        continue
                    cur = cur.copy()
                    cur.status = M.TaskStatus(
                        state=M.TaskState.COMPLETE, timestamp=ts,
                        message="exit")
                    tx.update(cur)
            store.update(exit_tasks)

    def pump(self) -> None:
        """Feed the scheduler every watch event since the last pump."""
        from swarmkit_tpu_torch.state.events import (
            Event, EventSnapshotRestore)
        sched = self.sched
        while True:
            ev = self.sub.poll()
            if ev is None:
                return
            if isinstance(ev, EventSnapshotRestore):
                sched._resync()
            elif isinstance(ev, Event):
                sched._handle_event(ev)

    def step(self, step: dict) -> dict:
        """One turn of the closed loop; returns its seconds by part."""
        tracer, sched = self.tracer, self.sched
        with tracer.span("portbench.step", "portbench"):
            t0 = time.perf_counter()
            with tracer.span("portbench.write", "portbench"):
                self.write(step)
            t1 = time.perf_counter()
            with tracer.span("portbench.feed", "portbench"):
                self.pump()
            t2 = time.perf_counter()
            if sched.pending_preassigned_tasks:
                sched._process_preassigned_tasks()
            t3 = time.perf_counter()
            sched.tick()
            t4 = time.perf_counter()
        return dict(write_s=t1 - t0, feed_s=t2 - t1, pre_s=t3 - t2,
                    tick_s=t4 - t3)

    def committed(self) -> Dict[str, tuple]:
        """(node id, state) of every task the store held or that left it
        with its service."""
        out = dict(zip(self.removed_ids,
                       zip(self.removed_nodes, self.removed_states)))
        for t in self.store.view(lambda tx: tx.find(self.M.Task)):
            out[t.id] = (t.node_id, int(t.status.state))
        return out

    def close(self) -> None:
        self.pump()
        self.store.queue.unsubscribe(self.sub)


def work_of(traffic: generator.Traffic, step: dict) -> List[dict]:
    """The plans a step's ticks ask for: a preassigned check per service
    with preassigned tasks, a placement per service with pending tasks."""
    n = len(traffic.nodes)
    out = []
    for kind, pre in (("validate", True), ("place", False)):
        per: Dict[str, int] = {}
        for _, sid, p in step["create"]:
            if (p >= 0) == pre:
                per[sid] = per.get(sid, 0) + 1
        for sid, k in per.items():
            shape = traffic.shapes[traffic.services[sid]]
            leaves = []
            for d in shape["spread"] if kind == "place" else ():
                key = d.split("node.labels.", 1)[-1]
                leaves.append(len({x["labels"].get(key, "")
                                   for x in traffic.nodes}))
            out.append(dict(kind=kind, nodes=n, tasks=k,
                            constraints=len(shape["constraints"]),
                            platforms=shape["platforms"],
                            levels=leaves))
    return out


def reference_of(cfg: dict):
    """The configuration's plain reference: ``Reference`` of
    ``reference/<cfg["reference"]>.py``."""
    return importlib.import_module(
        f"{__package__}.reference.{cfg['reference']}").Reference


def judge(traffic_steps: List[dict], reference: Reference,
          committed: Dict[str, tuple], index: Dict[str, int],
          measured_from: int) -> dict:
    """Every step's placements against the reference's.

    Tasks of one service and one kind (preassigned or not) are alike, so
    the comparison is by node: ``misplaced`` counts the tasks that would
    have to move (or be placed, or be taken off) for the program's counts
    per node to equal the reference's.  Returns it with the tasks
    checked, and the measured steps' tasks placed and created."""
    assigned = 192   # TaskState.ASSIGNED
    misplaced = checked = placed = attempted = 0
    for s, step in enumerate(traffic_steps):
        want = reference.step(step["remove"], step["create"], step["exits"],
                              step["services"])
        got = np.full(len(step["create"]), -1, np.int64)
        for j, (tid, _, _) in enumerate(step["create"]):
            nid, state = committed.get(tid, ("", 0))
            if nid and state >= assigned:
                got[j] = index.get(nid, -2)
        if s >= measured_from:
            placed += int((got >= 0).sum())
            attempted += len(got)
        keys: Dict[tuple, List[int]] = {}
        for j, (_, sid, pre) in enumerate(step["create"]):
            keys.setdefault((sid, pre >= 0), []).append(j)
        n = len(index)
        for rows in keys.values():
            rows = np.asarray(rows)
            a = np.bincount(got[rows] + 2, minlength=n + 2)
            b = np.bincount(want[rows] + 2, minlength=n + 2)
            misplaced += int(np.abs(a - b).sum()) // 2
        checked += len(got)
    return dict(misplaced=misplaced, checked=checked, placed=placed,
                attempted=attempted)


def run_cell(cell: bench_mod.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, cfg: Optional[dict] = None,
             mix: Optional[dict] = None) -> tuple:
    """Set up, measure, check.  Returns the :class:`Record`, the
    :func:`judge` result and the device's peak bytes (0 on the CPU).
    ``cfg`` and ``mix`` replace the cell's files (the tests' small
    clusters)."""
    import torch
    from . import profile
    cfg = cfg or cell.config()
    mix = mix or cell.traffic()
    traffic = generator.Traffic(cfg, mix, seed)
    cluster = Cluster(traffic, device, mix.get("pipeline_depth"))
    steps: List[dict] = []
    record = Record()

    for _ in range(traffic.warmup_steps()):
        steps.append(traffic.next_step())
        cluster.step(steps[-1])
    if device != "cpu":
        torch.cuda.synchronize()
    record.setup_s = time.perf_counter() - t_start
    measured_from = len(steps)

    tracer = cluster.tracer
    planner = cluster.planner
    dev_trace = profile.DeviceTrace(torch) if trace and device != "cpu" \
        else None
    stats0 = dict(planner.stats)
    trips0 = planner.breaker.stats["trips"]
    if trace:
        tracer.reset()
        tracer.enable()
    if dev_trace is not None:
        dev_trace.start()
    t0 = time.perf_counter()
    wall0 = time.time()
    while True:
        steps.append(traffic.next_step())
        record.steps.append(cluster.step(steps[-1]))
        if trace:
            record.work.extend(work_of(traffic, steps[-1]))
        if time.perf_counter() - t0 >= seconds:
            break
    if device != "cpu":
        torch.cuda.synchronize()
    record.window_s = time.perf_counter() - t0
    wall1 = time.time()
    t_after = time.perf_counter()
    if dev_trace is not None:
        dev_trace.stop(wall0, wall1)
    record.after["trace_s"] = time.perf_counter() - t_after
    record.host_routes = {
        k: int(planner.stats.get(k, 0) - stats0.get(k, 0))
        for k in HOST_ROUTES if k != "breaker_trips"}
    record.host_routes["breaker_trips"] = \
        planner.breaker.stats["trips"] - trips0
    if trace:
        tracer.disable()
        record.traced = True
        record.spans = [(sp.name, sp.start, sp.end, sp.thread)
                        for sp in tracer.spans()]
        record.planner_stats = {
            k: v - stats0.get(k, 0) for k, v in planner.stats.items()
            if isinstance(v, (int, float))}
        record.device = dev_trace
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    t_check = time.perf_counter()
    committed = cluster.committed()
    index = cluster.index
    cluster.close()
    del cluster
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    fresh = generator.Traffic(cfg, mix, seed)
    reference = reference_of(cfg)(fresh.nodes, fresh.shapes, fresh.services,
                                  fresh.base)
    check = judge(steps, reference, committed, index, measured_from)
    record.after["check_s"] = time.perf_counter() - t_check
    record.placed = check["placed"]
    record.attempted = check["attempted"]
    return record, check, peak
