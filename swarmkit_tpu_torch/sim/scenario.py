"""Named scenarios + the runner.

A scenario is a function ``(sim: Sim) -> duration`` that schedules a
workload and a fault timeline on the sim's engine, returning how long
(in virtual seconds) to run before the heal-and-converge epilogue.  The
runner wraps it with clock installation, the finish sequence (heal all
faults, restart everything, grace period, convergence checks), and
report assembly.

Every scenario exercises at least three distinct fault classes from the
taxonomy in ``faults``; the randomized ``random-fuzz`` scenario draws
its entire fault timeline from the seed.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..obs import planes as planes_mod
from ..obs.flightrec import flightrec
from ..obs.journey import journeys
from ..obs.sampler import Sampler
from ..obs.trace import tracer
from ..utils.sampling import poisson as _poisson
from .cluster import Sim
from .faults import NetConfig


@dataclass
class SimReport:
    scenario: str
    seed: int
    duration: float
    events: int
    trace_hash: str
    ok: bool
    violations: List[str] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    trace: List[str] = field(default_factory=list)   # when keep_trace
    # Chrome trace-event JSON of the control plane under virtual time
    # (obs.tracer spans); byte-identical for a given (scenario, seed)
    obs_trace: str = ""
    obs_trace_sha256: str = ""   # computed once in __post_init__
    # flight-recorder post-mortem, written automatically when the run
    # ends with invariant violations; sha is a pure function of the
    # seed (virtual timestamps, delta-based samples)
    flightrec_path: str = ""
    flightrec_sha256: str = ""
    # per-task journey ledger (obs/journey.py) captured at scenario
    # exit: milestones ride replicated stamps, so the dump — and its
    # sha — is a pure function of (scenario, seed), leader crashes
    # included (stitched across members, asserted in tests/test_obs.py)
    journeys_dump: dict = field(default_factory=dict)
    journeys_sha256: str = ""

    def __post_init__(self) -> None:
        if self.obs_trace and not self.obs_trace_sha256:
            self.obs_trace_sha256 = hashlib.sha256(
                self.obs_trace.encode()).hexdigest()

    def to_dict(self) -> dict:
        out = {
            "scenario": self.scenario, "seed": self.seed,
            "duration_virtual_s": self.duration, "events": self.events,
            "trace_hash": self.trace_hash,
            "obs_trace_sha256": self.obs_trace_sha256, "ok": self.ok,
            "violations": self.violations, "stats": self.stats,
        }
        if self.flightrec_path:
            out["flightrec_path"] = self.flightrec_path
            out["flightrec_sha256"] = self.flightrec_sha256
        if self.journeys_sha256:
            out["journeys_sha256"] = self.journeys_sha256
        return out


# --------------------------------------------------------------- scenarios

def _partition_churn(sim: Sim) -> float:
    """The acceptance scenario: a 3-manager/5-agent cluster through
    partitions, message loss, leader churn, and agent crash/partition
    faults — four distinct fault classes on one seeded timeline."""
    eng = sim.engine
    sim.start_raft_workload(interval=0.4)
    sim.cp.create_tasks(12)
    rng = eng.fork_rng()
    mids = [m.id for m in sim.managers]

    def churn():
        if sim.finishing:
            return False
        # random two-way split (sometimes isolating the leader)
        lone = rng.choice(mids)
        sim.net.split([lone], [m for m in mids if m != lone])
        eng.after(2.5, "heal split", sim.net.heal_all)
        return None

    eng.every(6.0, "partition churn", churn, phase=5.0)

    # message-loss burst mid-run
    def drops_on():
        sim.net.config.drop_p = 0.15
        eng.log("fault drop-burst on")

    def drops_off():
        sim.net.config.drop_p = 0.0
        eng.log("fault drop-burst off")

    eng.at(eng.clock.start + 20.0, "drop burst on", drops_on)
    eng.at(eng.clock.start + 30.0, "drop burst off", drops_off)

    # forced leader churn
    eng.at(eng.clock.start + 14.0, "stepdown", sim.stepdown_leader)
    eng.at(eng.clock.start + 40.0, "stepdown", sim.stepdown_leader)

    # agent faults: crash/restart one, partition another
    a0, a1 = sim.cp.agents[0], sim.cp.agents[1]
    eng.at(eng.clock.start + 12.0, "agent crash", a0.crash)
    eng.at(eng.clock.start + 32.0, "agent restart", a0.restart)
    eng.at(eng.clock.start + 25.0, "agent partition",
           lambda: a1.partition(True))
    eng.at(eng.clock.start + 45.0, "agent heal",
           lambda: a1.partition(False))
    eng.at(eng.clock.start + 35.0, "more tasks",
           lambda: sim.cp.create_tasks(6))
    return 55.0


def _crash_leader_mid_commit(sim: Sim) -> float:
    """Propose a burst at the leader and crash it in the same virtual
    instant — entries are on its WAL and (partially) on the wire but
    unacked.  The cluster must elect a successor without losing any
    entry it committed, and the rejoining ex-leader must converge."""
    eng = sim.engine
    sim.start_raft_workload(interval=0.5)
    sim.cp.create_tasks(8)

    def strike():
        m = sim.leader()
        if m is None:
            eng.after(1.0, "await leader", strike)
            return
        for i in range(20):
            sim.propose(f"burst-{i:03d}".encode())
        m.crash()                       # before any ack round-trips
        eng.after(6.0, "restart ex-leader", m.restart)

    eng.at(eng.clock.start + 5.0, "crash leader mid-commit", strike)

    # second strike against the successor (WAL intact — crash-with-
    # truncation is a durability bug the checkers are REQUIRED to flag,
    # exercised separately in tests)
    def strike2():
        m = sim.leader()
        if m is not None:
            for i in range(10):
                sim.propose(f"burst2-{i:03d}".encode())
            m.crash()
            eng.after(5.0, "restart ex-leader", m.restart)

    eng.at(eng.clock.start + 16.0, "crash successor mid-commit", strike2)
    eng.at(eng.clock.start + 10.0, "agent crash",
           sim.cp.agents[2].crash)
    eng.at(eng.clock.start + 20.0, "agent restart",
           sim.cp.agents[2].restart)
    return 28.0


def _crash_restart_churn(sim: Sim) -> float:
    """Rolling crash/restart of managers (never losing quorum for
    long); every restart rebuilds from the WAL and the ledger checker
    verifies the re-applied committed prefix byte-for-byte."""
    eng = sim.engine
    sim.start_raft_workload(interval=0.3)
    sim.cp.create_tasks(10)
    rng = eng.fork_rng()

    def churn():
        if sim.finishing:
            return False
        alive = [m for m in sim.managers if m.alive]
        if len(alive) <= 2:     # keep a quorum candidate pool
            return None
        victim = rng.choice(alive)
        victim.crash()
        eng.after(3.0, f"restart {victim.id}", victim.restart)
        return None

    eng.every(7.0, "crash churn", churn, phase=4.0)
    # agents churn too
    a = sim.cp.agents
    eng.at(eng.clock.start + 9.0, "agent crash", a[3].crash)
    eng.at(eng.clock.start + 18.0, "agent restart", a[3].restart)
    eng.at(eng.clock.start + 22.0, "more tasks",
           lambda: sim.cp.create_tasks(5))
    return 45.0


def _clock_skew(sim: Sim) -> float:
    """Timing faults: slow the leader's tick rate (its heartbeats
    arrive late -> followers may elect; pre-vote keeps this from
    cascading into term explosions), and slow one agent's heartbeat
    cadence past the TTL so the dispatcher marks it DOWN."""
    eng = sim.engine
    sim.start_raft_workload(interval=0.5)
    sim.cp.create_tasks(10)

    def skew_leader():
        m = sim.leader()
        if m is None:
            eng.after(1.0, "await leader", skew_leader)
            return
        m.tick_scale = 3.0
        eng.log(f"fault clock-skew {m.id} x3")
        eng.after(12.0, "unskew", lambda: setattr(m, "tick_scale", 1.0))

    eng.at(eng.clock.start + 8.0, "skew leader", skew_leader)
    agent = sim.cp.agents[4]

    def skew_agent():
        agent.rate_scale = 8.0      # heartbeats now slower than the TTL
        eng.log(f"fault clock-skew agent {agent.node_id} x8")

    eng.at(eng.clock.start + 15.0, "skew agent", skew_agent)
    eng.at(eng.clock.start + 32.0, "unskew agent",
           lambda: setattr(agent, "rate_scale", 1.0))
    eng.at(eng.clock.start + 20.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 28.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))
    return 40.0


def _agent_storm(sim: Sim) -> float:
    """Control-plane stress: task failure storms + agent churn while the
    consensus layer rides steady message jitter."""
    eng = sim.engine
    sim.start_raft_workload(interval=0.5)
    sim.cp.create_tasks(20)

    def storm_on():
        for a in sim.cp.agents:
            a.fail_p = 0.08
        eng.log("fault task-failure-storm on")

    def storm_off():
        for a in sim.cp.agents:
            a.fail_p = 0.0
        eng.log("fault task-failure-storm off")

    eng.at(eng.clock.start + 8.0, "storm on", storm_on)
    eng.at(eng.clock.start + 25.0, "storm off", storm_off)
    rng = eng.fork_rng()

    def agent_churn():
        if sim.finishing:
            return False
        up = [a for a in sim.cp.agents if a.alive]
        if len(up) > 2:
            victim = rng.choice(up)
            victim.crash()
            # outlive the heartbeat TTL (period 2s x grace 3) so the
            # dispatcher's expiry -> DOWN -> reschedule path runs
            eng.after(8.0, "agent restart", victim.restart)
        return None

    eng.every(6.0, "agent churn", agent_churn, phase=10.0)
    eng.at(eng.clock.start + 30.0, "more tasks",
           lambda: sim.cp.create_tasks(8))
    return 42.0


def _random_fuzz(sim: Sim) -> float:
    """The fuzzer's scenario: the entire fault timeline is drawn from
    the seed.  Constraints keep the run inside raft's fault model
    (crashes keep WALs intact and leave at least two members up so
    elections stay possible; durability bugs are injected only by the
    dedicated checker-detection test)."""
    eng = sim.engine
    rng = eng.fork_rng()
    sim.start_raft_workload(interval=0.3 + rng.random() * 0.4)
    sim.cp.create_tasks(rng.randrange(6, 16))
    duration = 30.0

    t = 3.0
    while t < duration - 4.0:
        op = rng.choice([
            "split", "isolate", "heal", "crash", "crash",
            "stepdown", "drop_burst", "agent_crash", "agent_partition",
            "skew", "tasks"])
        at = eng.clock.start + t

        if op == "split":
            def do_split():
                if sim.finishing:
                    return
                mids = [m.id for m in sim.managers]
                lone = rng.choice(mids)
                sim.net.split([lone], [m for m in mids if m != lone])
            eng.at(at, "fuzz split", do_split)
        elif op == "isolate":
            mid = rng.choice([m.id for m in sim.managers])
            eng.at(at, "fuzz isolate",
                   lambda mid=mid: sim.net.isolate(mid))
        elif op == "heal":
            eng.at(at, "fuzz heal", sim.net.heal_all)
        elif op == "crash":
            def do_crash():
                if sim.finishing:
                    return
                alive = [m for m in sim.managers if m.alive]
                if len(alive) <= 2:
                    return
                victim = rng.choice(alive)
                victim.crash()
                eng.after(2.0 + rng.random() * 4.0,
                          f"fuzz restart {victim.id}", victim.restart)
            eng.at(at, "fuzz crash", do_crash)
        elif op == "stepdown":
            eng.at(at, "fuzz stepdown", sim.stepdown_leader)
        elif op == "drop_burst":
            p = 0.05 + rng.random() * 0.2
            eng.at(at, "fuzz drops on",
                   lambda p=p: setattr(sim.net.config, "drop_p", p))
            eng.at(at + 2.0 + rng.random() * 4.0, "fuzz drops off",
                   lambda: setattr(sim.net.config, "drop_p", 0.0))
        elif op == "agent_crash":
            def do_acrash():
                up = [a for a in sim.cp.agents if a.alive]
                if len(up) > 1:
                    victim = rng.choice(up)
                    victim.crash()
                    eng.after(2.0 + rng.random() * 5.0,
                              "fuzz agent restart", victim.restart)
            eng.at(at, "fuzz agent crash", do_acrash)
        elif op == "agent_partition":
            agent = rng.choice(sim.cp.agents)
            eng.at(at, "fuzz agent partition",
                   lambda a=agent: a.partition(True))
            eng.at(at + 3.0 + rng.random() * 5.0, "fuzz agent heal",
                   lambda a=agent: a.partition(False))
        elif op == "skew":
            m = rng.choice(sim.managers)
            scale = 1.5 + rng.random() * 2.0
            eng.at(at, "fuzz skew",
                   lambda m=m, s=scale: setattr(m, "tick_scale", s))
            eng.at(at + 5.0, "fuzz unskew",
                   lambda m=m: setattr(m, "tick_scale", 1.0))
        elif op == "tasks":
            n = rng.randrange(2, 8)
            eng.at(at, "fuzz tasks", lambda n=n: sim.cp.create_tasks(n))
        t += 1.0 + rng.random() * 2.5
    return duration


def _pipelined_commit_churn(sim: Sim) -> float:
    """Chunk-pipelined scheduler commits through the sim consensus layer
    under leader crash: a raft-attached store (SimRaftProposer) commits
    a device-planned task group as many small pipelined block chunks,
    and the leader is crashed while later chunks are still in flight.

    Asserted (as violations when broken):
      * the clean pipelined tick commits every task;
      * NO chunk commits to the store after the leadership-loss instant
        — in-flight device plans must fail, roll back, and requeue;
      * committed + requeued always accounts for every task (none lost);
      * after a new leader emerges, a re-tick places the remainder;
      * the committed-entry ledger invariant (RaftInvariants) holds for
        the chunk-pipelined proposals interleaved with the background
        raft workload — checked continuously by the shared checkers.
    """
    eng = sim.engine
    sim.start_raft_workload(interval=0.6)
    sim.cp.create_tasks(6)   # keep the standard control plane busy too

    # top-level pumping: wait_proposal advances virtual time itself, so
    # this scenario DRIVES its workload inline instead of scheduling it
    # (the engine loop is not re-entrant from inside an event)
    while sim.leader() is None and eng.clock.elapsed() < 30.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("pipelined-commit",
                              "no ready leader within 30s")
        return eng.clock.elapsed() + 5.0

    from ..models import (
        Annotations, Node, NodeDescription, NodeSpec, NodeState,
        NodeStatus, ReplicatedService, Resources, Service, ServiceMode,
        ServiceSpec, Task, TaskSpec, TaskState, TaskStatus, Version,
    )
    from ..models.types import now
    from ..ops import TorchPlanner
    from ..scheduler import Scheduler
    from ..state.store import MemoryStore
    from .cluster import SimRaftProposer

    proposer = SimRaftProposer(sim)
    store = MemoryStore(proposer=proposer)
    store.pipeline_depth = 4            # chunk-pipelined proposals
    store.BLOCK_PROPOSAL_MAX_ITEMS = 8  # many small chunks per group

    def mk_nodes(tx):
        for i in range(16):
            tx.create(Node(
                id=f"pn{i:02d}",
                spec=NodeSpec(annotations=Annotations(name=f"pn{i:02d}")),
                status=NodeStatus(state=NodeState.READY),
                description=NodeDescription(
                    hostname=f"pn{i:02d}",
                    resources=Resources(nano_cpus=8 * 10 ** 9,
                                        memory_bytes=32 << 30))))

    store.update(mk_nodes)
    svc = Service(
        id="svc-pipe",
        spec=ServiceSpec(annotations=Annotations(name="pipe"),
                         mode=ServiceMode.REPLICATED,
                         replicated=ReplicatedService(replicas=96),
                         task=TaskSpec()),
        spec_version=Version(index=1))
    store.update(lambda tx: tx.create(svc))

    def mk_tasks(base):
        def cb(tx):
            for i in range(48):
                tx.create(Task(
                    id=f"pt{base + i:03d}", service_id=svc.id,
                    slot=base + i + 1,
                    desired_state=TaskState.RUNNING, spec=svc.spec.task,
                    spec_version=Version(index=1),
                    status=TaskStatus(state=TaskState.PENDING,
                                      timestamp=now())))
        store.update(cb)

    def count_assigned():
        return sum(1 for t in store.view(lambda tx: tx.find(Task))
                   if t.node_id
                   and t.status.state >= TaskState.ASSIGNED)

    planner = TorchPlanner(device=sim.device)
    planner.enable_small_group_routing = False
    # scheduler-level depth 1: its committer thread would break the
    # sim's single-threaded determinism; the store-level chunk pipeline
    # (window 4 above) is what this scenario exercises
    sched = Scheduler(store, batch_planner=planner, pipeline_depth=1)
    store.view(sched._setup_tasks_list)

    # ---- phase 1: clean pipelined tick, every chunk rides consensus
    mk_tasks(0)
    sched._resync()
    sched.tick()
    assigned1 = count_assigned()
    if assigned1 != 48:
        sim.violations.record(
            "pipelined-commit",
            f"clean pipelined tick committed {assigned1}/48")

    # ---- phase 2: crash the leader while chunks are in flight.  The
    # strike is keyed off the pipeline itself (after the 2nd chunk's
    # commit is acked, with up to window-1 later chunks still riding
    # consensus), not off wall/virtual timing — deterministic per seed
    # and guaranteed to land mid-pipeline.
    mk_tasks(48)
    sched._resync()
    at_crash: Dict[str, int] = {}
    acked = {"n": 0}

    def strike():
        m = sim.leader()
        if m is None:
            return
        at_crash["assigned"] = count_assigned()
        eng.log(f"fault crash {m.id} mid-pipeline")
        m.crash()
        eng.after(8.0, "restart ex-leader", m.restart)

    orig_wait = proposer.wait_proposal

    def wait_then_strike(waiter):
        orig_wait(waiter)
        acked["n"] += 1
        if acked["n"] == 2:
            strike()

    proposer.wait_proposal = wait_then_strike
    try:
        sched.tick()
    finally:
        proposer.wait_proposal = orig_wait
    assigned2 = count_assigned()
    requeued = len(sched.unassigned_tasks)
    flightrec.note(f"pipelined-commit phase2: assigned={assigned2} "
                   f"at_crash={at_crash.get('assigned')} "
                   f"requeued={requeued}")
    if "assigned" not in at_crash:
        sim.violations.record("pipelined-commit",
                              "leader crash fault never fired")
    elif assigned2 > at_crash["assigned"]:
        sim.violations.record(
            "pipeline-commit-after-leadership-loss",
            f"{assigned2 - at_crash['assigned']} tasks committed after "
            f"the leadership-loss instant (in-flight chunks must fail)")
    if assigned2 - 48 + requeued != 48:
        sim.violations.record(
            "pipelined-commit",
            f"task accounting broken after churn: committed "
            f"{assigned2 - 48} + requeued {requeued} != 48")

    # ---- phase 3: a successor leader acks the re-placed remainder
    while sim.leader() is None and eng.clock.elapsed() < 90.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("pipelined-commit",
                              "no successor leader within 90s")
    else:
        sched._resync()
        sched.tick()
        assigned3 = count_assigned()
        if assigned3 != 96:
            sim.violations.record(
                "pipelined-commit",
                f"re-tick after churn placed {assigned3}/96")
    return eng.clock.elapsed() + 3.0


def _fused_differential_churn(sim: Sim) -> float:
    """Differential: the FUSED many-service planner must place exactly
    what the per-service planner places, per seed, under churn.

    Two standalone stores ride the sim consensus (unbound
    SimRaftProposers) while the raft-attached control plane churns in
    the background: scheduler F plans with the fused path, scheduler P
    with ``fused_enabled=False``.  Identical workloads and faults are
    applied to both in lockstep and placements are compared after every
    phase — any divergence is a violation.  Phases cover the degraded
    routes too: host fallback (node.ip constraint group in every tick),
    task-failure down-weighting, node drains, a PlannerBreaker trip
    (both planners host-route, then half-open probe after the virtual
    cooldown), and a leadership stepdown (commit failure -> rollback ->
    requeue -> converge on the successor).
    """
    eng = sim.engine
    sim.start_raft_workload(interval=0.8)
    sim.cp.create_tasks(6)   # background control-plane traffic

    while sim.leader() is None and eng.clock.elapsed() < 30.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("fused-differential",
                              "no ready leader within 30s")
        return eng.clock.elapsed() + 5.0

    from ..models import (
        Annotations, Node, NodeAvailability, NodeDescription, NodeSpec,
        NodeState, NodeStatus, Placement, PlacementPreference,
        ReplicatedService, Resources, ResourceRequirements, Service,
        ServiceMode, ServiceSpec, SpreadOver, Task, TaskSpec, TaskState,
        TaskStatus, Version,
    )
    from ..models.types import now
    from ..ops import TorchPlanner
    from ..scheduler import Scheduler
    from ..state.store import MemoryStore
    from .cluster import SimRaftProposer

    res = ResourceRequirements(
        reservations=Resources(nano_cpus=10 ** 8, memory_bytes=64 << 20))
    svc_specs = {
        "fa": TaskSpec(resources=res),
        "fb": TaskSpec(resources=res),
        "fc": TaskSpec(placement=Placement(preferences=[
            PlacementPreference(spread=SpreadOver(
                spread_descriptor="node.labels.rack"))]),
            resources=res),
        # node.ip constraints stay on the host oracle: the fused run
        # breaks around this group every tick (host-fallback parity)
        "fd": TaskSpec(placement=Placement(
            constraints=["node.ip!=10.0.0.9"])),
    }

    def build_store():
        store = MemoryStore(proposer=SimRaftProposer(sim))
        def mk(tx):
            for i in range(12):
                tx.create(Node(
                    id=f"dn{i:02d}",
                    spec=NodeSpec(annotations=Annotations(
                        name=f"dn{i:02d}",
                        labels={"rack": f"r{i % 3}"})),
                    status=NodeStatus(state=NodeState.READY),
                    description=NodeDescription(
                        hostname=f"dn{i:02d}",
                        resources=Resources(nano_cpus=8 * 10 ** 9,
                                            memory_bytes=32 << 30))))
            for sid, spec in svc_specs.items():
                tx.create(Service(
                    id=sid,
                    spec=ServiceSpec(annotations=Annotations(name=sid),
                                     mode=ServiceMode.REPLICATED,
                                     replicated=ReplicatedService(
                                         replicas=0),
                                     task=spec),
                    spec_version=Version(index=1)))
        store.update(mk)
        return store

    seqs = {sid: 0 for sid in svc_specs}

    def add_tasks(store, sid, n, base):
        spec = svc_specs[sid]
        def cb(tx):
            for i in range(n):
                tx.create(Task(
                    id=f"{sid}-{base + i:04d}", service_id=sid,
                    slot=base + i + 1,
                    desired_state=TaskState.RUNNING, spec=spec,
                    spec_version=Version(index=1),
                    status=TaskStatus(state=TaskState.PENDING,
                                      timestamp=now())))
        store.update(cb)

    stores, scheds, planners = [], [], []
    for fused in (True, False):
        store = build_store()
        planner = TorchPlanner(device=sim.device)
        planner.enable_small_group_routing = False
        planner.fused_enabled = fused
        sched = Scheduler(store, batch_planner=planner,
                          pipeline_depth=1)
        store.view(sched._setup_tasks_list)
        stores.append(store)
        scheds.append(sched)
        planners.append(planner)

    def snap(store):
        # placement claim only: ids, nodes, states.  Timestamps differ
        # by construction (the two ticks run seconds apart in virtual
        # time) and are not part of the equivalence being asserted.
        return sorted((t.id, t.node_id, int(t.status.state))
                      for t in store.view(lambda tx: tx.find(Task)))

    def both(fn):
        for store in stores:
            fn(store)

    def tick_and_compare(phase):
        for sched in scheds:
            sched._resync()
            sched.tick()
        a, b = snap(stores[0]), snap(stores[1])
        if a != b:
            diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
            sim.violations.record(
                "fused-differential",
                f"{phase}: fused placements diverged from per-service "
                f"(first diffs: {diff})")

    # ---- phase 1: clean multi-service tick
    for sid, n in (("fa", 40), ("fb", 24), ("fc", 18), ("fd", 8)):
        both(lambda s, sid=sid, n=n: add_tasks(s, sid, n, seqs[sid]))
        seqs[sid] += {"fa": 40, "fb": 24, "fc": 18, "fd": 8}[sid]
    tick_and_compare("clean-tick")
    if planners[0].stats.get("groups_fused", 0) < 2:
        sim.violations.record(
            "fused-differential",
            "fused path never engaged on the fused-side scheduler "
            f"(stats {planners[0].stats})")
    if planners[1].stats.get("groups_fused", 0):
        sim.violations.record(
            "fused-differential",
            "per-service side took the fused path; differential is void")

    # ---- phase 2: task failures (down-weighted scoring) + scale-up
    def fail_tasks(store):
        victims = [t for t in store.view(lambda tx: tx.find(Task))
                   if t.service_id == "fa" and t.node_id][:6]
        def cb(tx):
            for v in victims:
                cur = tx.get(Task, v.id)
                if cur is None:
                    continue
                cur = cur.copy()
                cur.status = TaskStatus(state=TaskState.FAILED,
                                        timestamp=now(),
                                        message="sim fault")
                tx.update(cur)
        store.update(cb)
    both(fail_tasks)
    eng.run_until(eng.clock.elapsed() + 1.0)
    both(lambda s: add_tasks(s, "fa", 20, seqs["fa"]))
    seqs["fa"] += 20
    tick_and_compare("failure-churn")

    # ---- phase 3: drain nodes, then place more work around them
    def drain(store):
        def cb(tx):
            for nid in ("dn00", "dn05"):
                cur = tx.get(Node, nid).copy()
                cur.spec.availability = NodeAvailability.DRAIN
                tx.update(cur)
        store.update(cb)
    both(drain)
    both(lambda s: add_tasks(s, "fb", 16, seqs["fb"]))
    both(lambda s: add_tasks(s, "fc", 12, seqs["fc"]))
    seqs["fb"] += 16
    seqs["fc"] += 12
    tick_and_compare("drain-churn")

    # ---- phase 4: breaker trip — BOTH planners degrade to the host
    # oracle, then half-open probe after the virtual cooldown
    for planner in planners:
        for _ in range(planner.breaker.threshold):
            planner.breaker.record_failure()
    both(lambda s: add_tasks(s, "fa", 12, seqs["fa"]))
    seqs["fa"] += 12
    tick_and_compare("breaker-open")
    if not planners[0].stats.get("groups_breaker_to_host"):
        sim.violations.record(
            "fused-differential",
            "breaker-open tick did not host-route (degraded differential "
            "not exercised)")
    eng.run_until(eng.clock.elapsed()
                  + planners[0].breaker.base_cooldown + 1.0)
    both(lambda s: add_tasks(s, "fb", 12, seqs["fb"]))
    seqs["fb"] += 12
    tick_and_compare("breaker-probe")

    # ---- phase 5: leadership stepdown mid-workload — both sides fail
    # their commits, roll back, requeue, and converge on the successor
    both(lambda s: add_tasks(s, "fa", 10, seqs["fa"]))
    seqs["fa"] += 10
    sim.stepdown_leader()
    tick_and_compare("stepdown-requeue")
    while sim.leader() is None and eng.clock.elapsed() < 90.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("fused-differential",
                              "no successor leader within 90s")
    else:
        tick_and_compare("post-stepdown-converge")
        pending = len(scheds[0].unassigned_tasks)
        if pending:
            sim.violations.record(
                "fused-differential",
                f"{pending} tasks still unplaced after the successor "
                "re-tick")
    return eng.clock.elapsed() + 3.0


_fused_differential_churn.raft_cp = True


def _steady_state_churn(sim: Sim) -> float:
    """Differential: the STREAMING scheduler (device-resident node
    state, dirty-row incremental refreshes — ops/streaming.py) must
    place exactly what a forced full-replan scheduler places, per seed,
    under sustained Poisson churn.

    Twin stores ride the sim consensus through epoch-reporting
    ``SimRaftProposer``s while the raft-attached control plane churns
    in the background: scheduler S refreshes resident columns from the
    delta tracker (the real watch feed, pumped between ticks exactly
    like the production event loop), scheduler F runs with
    ``streaming_enabled=False`` — the ``SWARM_STREAMING_PLANNER=0``
    posture, O(cluster) rebuild every tick.  Identical workloads and
    faults apply to both in lockstep; any placement divergence is an
    ``incremental-equals-full-replan`` violation.  Phases cover every
    row of the streaming fallback matrix: steady arrivals/exits/
    failures (incremental ticks, the common case), node availability
    churn + a spread service (dirty node rows, resident leaf columns),
    a host-routed constraint group every tick (hook-marked host
    mutations), node add + node REMOVE (append vs forced-full), and a
    leader stepdown (epoch change -> the successor-reign resync that
    rebuilds resident state before trusting it — the
    ``streaming-resync x scheduler`` coverage cell)."""
    eng = sim.engine
    rng = eng.fork_rng()
    sim.start_raft_workload(interval=0.8)
    sim.cp.create_tasks(4)   # background control-plane traffic

    while sim.leader() is None and eng.clock.elapsed() < 30.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("incremental-equals-full-replan",
                              "no ready leader within 30s")
        return eng.clock.elapsed() + 5.0

    from ..models import (
        Annotations, Node, NodeAvailability, NodeDescription, NodeSpec,
        NodeState, NodeStatus, Placement, PlacementPreference,
        ReplicatedService, Resources, ResourceRequirements, Service,
        ServiceMode, ServiceSpec, SpreadOver, Task, TaskSpec, TaskState,
        TaskStatus, Version,
    )
    from ..models.types import now
    from ..ops import TorchPlanner
    from ..scheduler import Scheduler
    from ..state.events import Event, EventSnapshotRestore
    from ..state.store import MemoryStore
    from .cluster import SimRaftProposer

    class _EpochedProposer(SimRaftProposer):
        """Unbound proposer that still reports a fencing epoch (the
        current leader's) so the twin schedulers' tick pinning — and
        the streaming plane's resync-on-handoff — see reigns change."""

        @property
        def leadership_epoch(self):
            m = self.sim.leader()
            return m.core.leadership_epoch if m is not None else None

    res = ResourceRequirements(
        reservations=Resources(nano_cpus=10 ** 8, memory_bytes=64 << 20))
    svc_specs = {
        "ga": TaskSpec(resources=res),
        "gb": TaskSpec(resources=res),
        # spread service: exercises the resident leaf columns
        "gc": TaskSpec(placement=Placement(preferences=[
            PlacementPreference(spread=SpreadOver(
                spread_descriptor="node.labels.rack"))]),
            resources=res),
        # node.ip constraints stay on the host oracle: every tick ends
        # with hook-marked host-path mirror mutations the dirty set
        # must absorb (NOT a full rebuild)
        "gd": TaskSpec(placement=Placement(
            constraints=["node.ip!=10.0.0.9"])),
    }

    def mk_node(tx, i: int):
        tx.create(Node(
            id=f"sn{i:02d}",
            spec=NodeSpec(annotations=Annotations(
                name=f"sn{i:02d}", labels={"rack": f"r{i % 3}"})),
            status=NodeStatus(state=NodeState.READY),
            description=NodeDescription(
                hostname=f"sn{i:02d}",
                resources=Resources(nano_cpus=8 * 10 ** 9,
                                    memory_bytes=32 << 30))))

    def build_store():
        store = MemoryStore(proposer=_EpochedProposer(sim))

        def mk(tx):
            for i in range(14):
                mk_node(tx, i)
            for sid, spec in svc_specs.items():
                tx.create(Service(
                    id=sid,
                    spec=ServiceSpec(annotations=Annotations(name=sid),
                                     mode=ServiceMode.REPLICATED,
                                     replicated=ReplicatedService(
                                         replicas=0),
                                     task=spec),
                    spec_version=Version(index=1)))
        store.update(mk)
        return store

    seqs = {sid: 0 for sid in svc_specs}

    def add_tasks(store, sid, n):
        spec = svc_specs[sid]
        base = seqs[sid]

        def cb(tx):
            for i in range(n):
                tx.create(Task(
                    id=f"{sid}-{base + i:04d}", service_id=sid,
                    slot=base + i + 1,
                    desired_state=TaskState.RUNNING, spec=spec,
                    spec_version=Version(index=1),
                    status=TaskStatus(state=TaskState.PENDING,
                                      timestamp=now())))
        store.update(cb)

    stores, scheds, planners, subs = [], [], [], []
    for streaming in (True, False):
        store = build_store()
        planner = TorchPlanner(device=sim.device)
        planner.enable_small_group_routing = False
        planner.streaming_enabled = streaming
        sched = Scheduler(store, batch_planner=planner,
                          pipeline_depth=1)
        _, sub = store.view_and_watch(
            lambda tx, s=sched: s._setup_tasks_list(tx),
            accepts_blocks=True)
        stores.append(store)
        scheds.append(sched)
        planners.append(planner)
        subs.append(sub)

    def pump(i):
        """Drain the store watch into the scheduler exactly as its
        production event loop would — this IS the streaming delta feed
        (blocks are the scheduler's own commits and are skipped, like
        the run() loop skips them)."""
        sched, sub = scheds[i], subs[i]
        while True:
            ev = sub.poll()
            if ev is None:
                return
            if isinstance(ev, EventSnapshotRestore):
                sched._resync()
            elif isinstance(ev, Event):
                sched._handle_event(ev)

    def snap(store):
        return sorted((t.id, t.node_id, int(t.status.state))
                      for t in store.view(lambda tx: tx.find(Task)))

    def both(fn):
        for store in stores:
            fn(store)

    violated = {"n": 0}

    def tick_and_compare(phase):
        for i in range(2):
            pump(i)
            scheds[i].tick()
        a, b = snap(stores[0]), snap(stores[1])
        if a != b and violated["n"] < 3:   # first divergences only
            violated["n"] += 1
            diff = [(x, y) for x, y in zip(a, b) if x != y][:5]
            sim.violations.record(
                "incremental-equals-full-replan",
                f"{phase}: streaming placements diverged from "
                f"full-replan (first diffs: {diff})")

    def fail_some(store, sid, k):
        victims = sorted(
            (t for t in store.view(lambda tx: tx.find(Task))
             if t.service_id == sid and t.node_id
             and t.status.state == TaskState.ASSIGNED), key=lambda t: t.id
        )[:k]

        def cb(tx):
            for v in victims:
                cur = tx.get(Task, v.id)
                if cur is None:
                    continue
                cur = cur.copy()
                cur.status = TaskStatus(state=TaskState.FAILED,
                                        timestamp=now(),
                                        message="sim churn exit")
                tx.update(cur)
        store.update(cb)

    # ---- phase 1: seed the steady state
    for sid, n in (("ga", 16), ("gb", 12), ("gc", 10), ("gd", 4)):
        both(lambda s, sid=sid, n=n: add_tasks(s, sid, n))
        seqs[sid] += n
    tick_and_compare("seed")

    # ---- phase 2: sustained Poisson churn — arrivals, exits/failures,
    # node availability flips.  This is the tick shape the streaming
    # plane exists for: every refresh must be incremental.
    for w in range(12):
        for sid, lam in (("ga", 1.6), ("gb", 1.2), ("gc", 0.9),
                         ("gd", 0.5)):
            n = _poisson(rng, lam)
            if n:
                both(lambda s, sid=sid, n=n: add_tasks(s, sid, n))
                seqs[sid] += n
        exits = _poisson(rng, 1.1)
        if exits:
            sid = ("ga", "gb", "gc")[w % 3]
            both(lambda s, sid=sid, k=exits: fail_some(s, sid, k))
        if w % 4 == 2:
            flip = f"sn{rng.randrange(14):02d}"

            def avail(store, nid=flip, drain=(w % 8 == 2)):
                def cb(tx):
                    cur = tx.get(Node, nid)
                    if cur is None:
                        return
                    cur = cur.copy()
                    cur.spec.availability = (
                        NodeAvailability.DRAIN if drain
                        else NodeAvailability.ACTIVE)
                    tx.update(cur)
                store.update(cb)
            both(avail)
        eng.run_until(eng.clock.elapsed() + 0.7)
        tick_and_compare(f"churn-w{w}")

    st_stats = planners[0].streaming_snapshot()
    if st_stats["incremental_ticks"] < 8:
        sim.violations.record(
            "incremental-equals-full-replan",
            "streaming side barely ran incrementally "
            f"({st_stats}) — the differential is void")
    if planners[1].streaming_snapshot()["enabled"]:
        sim.violations.record(
            "incremental-equals-full-replan",
            "full-replan side had streaming enabled; differential void")

    # ---- phase 3: membership churn — a node joins (append row), a
    # node leaves (forced full rebuild; row order shifted)
    def add_node(store):
        store.update(lambda tx: mk_node(tx, 14))
    both(add_node)
    both(lambda s: add_tasks(s, "ga", 6))
    seqs["ga"] += 6
    tick_and_compare("node-join")

    def del_node(store):
        def cb(tx):
            cur = tx.get(Node, "sn03")
            if cur is not None:
                tx.delete(Node, "sn03")
        store.update(cb)
    both(del_node)
    both(lambda s: add_tasks(s, "gb", 6))
    seqs["gb"] += 6
    tick_and_compare("node-leave")

    # ---- phase 4: leader stepdown mid-churn — commits fail, roll
    # back, requeue; the successor reign's first refresh must RESYNC
    # the resident state (epoch change), not trust pre-handoff rows
    both(lambda s: add_tasks(s, "ga", 5))
    seqs["ga"] += 5
    pre_resyncs = planners[0].streaming_snapshot()["resyncs"]
    sim.stepdown_leader()
    tick_and_compare("stepdown-requeue")
    while sim.leader() is None and eng.clock.elapsed() < 90.0:
        eng.run_until(eng.clock.elapsed() + 0.5)
    if sim.leader() is None:
        sim.violations.record("incremental-equals-full-replan",
                              "no successor leader within 90s")
        return eng.clock.elapsed() + 3.0
    tick_and_compare("post-stepdown-converge")
    post_resyncs = planners[0].streaming_snapshot()["resyncs"]
    if post_resyncs > pre_resyncs:
        # coverage cell (scripts/chaos_sweep.py REQUIRED_CELLS): a
        # leader handoff ACTUALLY rebuilt resident state this run
        eng.log("fault streaming-resync scheduler")
    else:
        sim.violations.record(
            "incremental-equals-full-replan",
            "leader handoff did not resync the resident state "
            f"(resyncs {pre_resyncs} -> {post_resyncs})")

    # ---- phase 5: converged steady state again
    both(lambda s: add_tasks(s, "gb", 4))
    seqs["gb"] += 4
    eng.run_until(eng.clock.elapsed() + 0.7)
    tick_and_compare("post-handoff-churn")
    pending = len(scheds[0].unassigned_tasks)
    if pending:
        sim.violations.record(
            "incremental-equals-full-replan",
            f"{pending} schedulable tasks still unplaced after the "
            "post-handoff re-tick")
    return eng.clock.elapsed() + 3.0


_steady_state_churn.raft_cp = True


# ------------------------------------------------- failover scenarios
#
# These run the RAFT-ATTACHED control plane (Sim(raft_cp=True)): every
# member holds a replicated store, the real scheduler / dispatcher /
# allocator / restart supervisor / orchestrators run on the leader only,
# and leadership hand-off is exercised under faults.  The shared
# checkers run throughout, plus control-loops-only-on-leader,
# no-stale-epoch-commit (epoch fencing), and the failover-replacement
# end-state check in Sim.finish.


def _device_planner(device):
    """Planner factory for the failover scenarios: the device path with
    small-group routing off, so every group's assignments commit as
    chunk-pipelined columnar block proposals (the pipelined commit the
    partition scenario strikes mid-flight)."""
    from ..ops import TorchPlanner
    p = TorchPlanner(device=device)
    p.enable_small_group_routing = False
    return p


def _arm_leader_strike(sim: Sim, fire) -> None:
    """Wrap the ACTIVE leader's member-bound proposer so ``fire(member)``
    triggers deterministically from inside the control plane's own
    consensus traffic (not off wall/virtual timing).  ``fire`` returns
    True once the strike happened; arming then stops."""
    eng = sim.engine
    state = {"fired": False}

    def arm():
        if sim.finishing or state["fired"]:
            return False
        mc = sim.cp.active
        if mc is None:
            return None
        proposer = sim.cp.proposers[mc.member.id]
        if getattr(proposer, "_strike_armed", False):
            return None
        proposer._strike_armed = True
        orig_wait = proposer.wait_proposal

        def wait_then_strike(waiter):
            orig_wait(waiter)
            if not state["fired"] and not sim.finishing \
                    and fire(proposer, mc.member):
                state["fired"] = True
        proposer.wait_proposal = wait_then_strike
        return None

    eng.every(0.5, "arm leader strike", arm, phase=0.25)


def _mk_leader_crash_mid_tick(depth: int) -> Callable[[Sim], float]:
    def scenario(sim: Sim) -> float:
        eng = sim.engine
        cp = sim.cp
        cp.store_pipeline_depth = depth
        cp.block_proposal_max_items = 4
        cp.planner_factory = lambda: _device_planner(sim.device)
        sim.start_raft_workload(interval=0.6)
        cp.create_tasks(12)

        def fire(proposer, member) -> bool:
            # strike only once real control traffic is flowing: past the
            # bootstrap + scale + task-creation commits, i.e. inside a
            # scheduling/status tick of the attached leader
            if proposer.stats["committed"] < 6:
                return False
            eng.log(f"fault crash {member.id} mid-tick")
            member.crash()
            eng.after(6.0, "restart ex-leader", member.restart)
            return True

        _arm_leader_strike(sim, fire)
        # agent churn rides along so the successor re-learns sessions
        a = sim.cp.agents
        eng.at(eng.clock.start + 16.0, "agent crash", a[1].crash)
        eng.at(eng.clock.start + 24.0, "agent restart", a[1].restart)
        eng.at(eng.clock.start + 20.0, "more tasks",
               lambda: cp.create_tasks(6))
        return 40.0
    scenario.raft_cp = True
    return scenario


def _mk_partition_pipelined_commit(depth: int) -> Callable[[Sim], float]:
    def scenario(sim: Sim) -> float:
        eng = sim.engine
        cp = sim.cp
        cp.store_pipeline_depth = depth
        cp.block_proposal_max_items = 4
        cp.planner_factory = lambda: _device_planner(sim.device)
        sim.start_raft_workload(interval=0.7)
        cp.create_tasks(16)
        state = {"armed_async": False}

        def fire(proposer, member) -> bool:
            if state["armed_async"]:
                return False
            if proposer.stats["committed"] < 4:
                return False
            # from here on, the moment the chunk-pipelined window holds
            # 2+ in-flight proposals, cut the leader off mid-commit
            state["armed_async"] = True
            orig_async = proposer.propose_async

            # at depth 1 chunks ride strictly serially, so one in-flight
            # proposal IS the mid-commit window; deeper pipelines strike
            # with the window actually filled
            window_needed = 2 if depth > 1 else 1

            def async_then_partition(actions, commit_cb=None, epoch=None):
                w = orig_async(actions, commit_cb, epoch=epoch)
                if len(proposer._pending) >= window_needed \
                        and member.alive:
                    eng.log(f"fault partition {member.id} mid-pipelined-"
                            f"commit (window={len(proposer._pending)})")
                    sim.net.isolate(member.id)
                    eng.after(10.0, "heal partition",
                              lambda: sim.net.rejoin(member.id))
                    proposer.propose_async = orig_async
                return w
            proposer.propose_async = async_then_partition
            return True

        _arm_leader_strike(sim, fire)
        eng.at(eng.clock.start + 24.0, "more tasks",
               lambda: cp.create_tasks(6))
        return 45.0
    scenario.raft_cp = True
    return scenario


def _failover_churn_rollout(sim: Sim) -> float:
    """Scale rollout (up, down, up) under leader churn, agent churn and
    a task-failure storm: the restart supervisor and orchestrators must
    keep the replica count converging across two leadership hand-offs
    with no lost or duplicated restarts.  A replicated JOB rides along
    (jobs orchestrator live in the raft-attached control plane): its
    ``total_completions`` must all land despite the leader hand-offs —
    job iterations survive failover via the replicated store."""
    eng = sim.engine
    cp = sim.cp
    sim.start_raft_workload(interval=0.8)
    cp.create_tasks(10)
    # jobs under churn: 6 completions through a max_concurrent=2 window,
    # spanning both leadership hand-offs below
    eng.at(eng.clock.start + 6.0, "job under churn",
           lambda: cp.run_job("job-churn", total=6, max_concurrent=2))
    cp.expect_job_complete("job-churn", 6)
    eng.at(eng.clock.start + 10.0, "scale up", lambda: cp.scale(16))
    eng.at(eng.clock.start + 20.0, "scale down", lambda: cp.scale(6))
    eng.at(eng.clock.start + 28.0, "scale up again",
           lambda: cp.scale(12))

    eng.at(eng.clock.start + 14.0, "stepdown", sim.stepdown_leader)

    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 24.0, "crash leader", crash_leader)

    def storm_on():
        for a in cp.agents:
            a.fail_p = 0.05
        eng.log("fault task-failure-storm on")

    def storm_off():
        for a in cp.agents:
            a.fail_p = 0.0
        eng.log("fault task-failure-storm off")
    eng.at(eng.clock.start + 8.0, "storm on", storm_on)
    eng.at(eng.clock.start + 30.0, "storm off", storm_off)
    a = cp.agents
    eng.at(eng.clock.start + 12.0, "agent crash", a[2].crash)
    eng.at(eng.clock.start + 26.0, "agent restart", a[2].restart)
    return 45.0


_failover_churn_rollout.raft_cp = True


def _preemption_storm(sim: Sim) -> float:
    """Priority bands arriving under node churn and leader stepdown:
    three replicated bands (priority 0 / 5 / 10) with per-task cpu
    reservations contend for 5 workers x 4 slots.  Two node deaths
    shrink capacity to 12 slots just as the higher bands arrive, so the
    mid and high bands are infeasible without evicting the low band —
    the scheduler's preemption pass (device victim kernel behind the
    breaker seam, host oracle on fallback) must place them, the
    orchestrators must requeue the evicted slots, and after heal the
    whole workload (20 tasks) fits again.  Judged by the preemption
    invariants (no-priority-inversion, no-preempt-equal-or-higher,
    preemption-thrash-bound, preempted-tasks-requeue) plus the
    preemptions-observed coverage check."""
    eng = sim.engine
    cp = sim.cp
    cp.planner_factory = lambda: _device_planner(sim.device)    # device victim selection
    cp.expect_preemptions = True
    sim.start_raft_workload(interval=0.8)

    CPU = 2 * 10 ** 9    # 4 slots per 8-cpu worker
    eng.at(eng.clock.start + 6.0, "band lo",
           lambda: cp.add_service("svc-lo", 12, priority=0,
                                  nano_cpus=CPU))
    # node churn: two workers die while the higher bands arrive
    a = cp.agents
    eng.at(eng.clock.start + 20.0, "node death w0", a[0].crash)
    eng.at(eng.clock.start + 24.0, "node death w1", a[1].crash)
    eng.at(eng.clock.start + 22.0, "band mid",
           lambda: cp.add_service("svc-mid", 4, priority=5,
                                  nano_cpus=CPU))

    def high_band():
        # the burst the coverage matrix requires: the high band lands on
        # a shrunken cluster and must preempt its way in
        eng.log("fault preempt-burst scheduler")
        cp.add_service("svc-hi", 4, priority=10, nano_cpus=CPU)
    eng.at(eng.clock.start + 30.0, "band high (preempt burst)",
           high_band)

    eng.at(eng.clock.start + 34.0, "stepdown mid-storm",
           sim.stepdown_leader)
    eng.at(eng.clock.start + 40.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 46.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))
    eng.at(eng.clock.start + 50.0, "node return w0", a[0].restart)
    eng.at(eng.clock.start + 54.0, "node return w1", a[1].restart)
    return 80.0


_preemption_storm.raft_cp = True


def _tenant_storm(sim: Sim) -> float:
    """Autoscaler + multi-tenant QoS soak (ISSUE 12): a quota'd
    low-band tenant's autoscaled service bursts (the scenario drives
    its load signal up 16x) while a high-band tenant's service must
    keep its pending->assigned p99 — judged by the derived cross-band
    bound, not a constant.  The burst rides agent churn, a drop burst,
    and a leader crash landing MID-SCALE-UP (the successor's
    supervisor resumes the policy from the replicated
    ``autoscale_status``, still inside bounds and rate).  Quotas clamp
    the burst at admission — host filter AND device quota-mask column
    (the planner factory is the device path) — so the low tenant's
    committed usage can never exceed its quota and the high band never
    waits on capacity the burst stole.  Load removal at the end must
    converge replicas back to min.  Judged by quota-never-exceeded,
    autoscale-within-bounds-and-rate, no-cross-band-p99-violation and
    autoscale-converges on top of the shared checkers."""
    from ..models.specs import AutoscaleConfig
    from ..models.types import TenantQuota
    eng = sim.engine
    cp = sim.cp
    cp.planner_factory = lambda: _device_planner(sim.device)    # quota mask on device
    CPU = 2 * 10 ** 9    # 4 slots per 8-cpu worker (5 workers = 40 cpu)
    eng.at(eng.clock.start + 4.0, "tenants",
           lambda: cp.configure_tenants({
               # t-lo: 12 cpu = 6 tasks — far below the burst's ask
               "t-lo": TenantQuota(nano_cpus=12 * 10 ** 9),
               # t-hi: room for the whole high band
               "t-hi": TenantQuota(nano_cpus=24 * 10 ** 9)}))
    eng.at(eng.clock.start + 6.0, "burst service",
           lambda: cp.add_service(
               "svc-burst", 2, priority=0, nano_cpus=CPU,
               tenant="t-lo",
               autoscale=AutoscaleConfig(
                   min_replicas=2, max_replicas=16,
                   target_utilization=1.0, scale_up_step=4,
                   scale_down_step=6, stabilization_window=3.0)))
    eng.at(eng.clock.start + 8.0, "high band",
           lambda: cp.add_service("svc-hi", 4, priority=10,
                                  nano_cpus=CPU, tenant="t-hi"))
    # steady pre-burst load so the policy has a signal either way
    eng.at(eng.clock.start + 10.0, "baseline load",
           lambda: cp.set_load("svc-burst", 2.0))

    def burst():
        # the injected fault: a 16x tenant burst into the scheduler
        eng.log("fault autoscale-burst scheduler")
        cp.set_load("svc-burst", 32.0)
    eng.at(eng.clock.start + 14.0, "tenant burst", burst)
    # the burst's scale-up wants 16 replicas; quota admits 6 — clamps
    # MUST be observed (coverage cell quota-clamp x scheduler), and the
    # committed replica count must still reach the spec maximum across
    # the leader crash below
    cp.expect_autoscale("svc-burst", at_least=10, by=48.0)
    cp.expect_band_p99(5, 14.0, 58.0)

    # agent churn AWAY from the leader outage (its TTL-driven
    # re-placement must ride a live leader)
    a = cp.agents
    eng.at(eng.clock.start + 18.0, "agent crash", a[3].crash)
    eng.at(eng.clock.start + 36.0, "agent restart", a[3].restart)

    # leader crash mid-scale-up: the supervisor is between steps of the
    # burst ramp — the successor resumes from the replicated status
    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 26.0, "crash leader mid-scale-up",
           crash_leader)

    eng.at(eng.clock.start + 44.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 50.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))

    # load removed: the policy must walk replicas back to min and stay
    eng.at(eng.clock.start + 58.0, "load removed",
           lambda: cp.set_load("svc-burst", 0.0))
    cp.expect_autoscale_converge("svc-burst", to=2, by=95.0)
    return 85.0


_tenant_storm.raft_cp = True


def _gang_deadlock(sim: Sim) -> float:
    """Gang scheduling under contention (ISSUE 16): two all-or-nothing
    gangs of 8 tasks each land on a cluster shrunk to 12 slots — each
    gang fits alone, both together do not.  Partial placement would
    livelock them (each holding half the capacity, neither complete);
    atomic admission plus the deterministic (-priority, age, key)
    admission order must place one gang in a single commit and defer
    the other INTACT.  A leader stepdown mid-contention rebuilds the
    deferral bookkeeping on the successor, an agent crash evicts part
    of the placed gang (its replacements must re-place without
    demanding a whole new gang — placed-live members count toward
    min_size), and when the dead workers return the deferred gang must
    place in full.  Judged by the gang-atomicity invariant (no commit
    ever assigns a strict subset of a unit) plus end-state convergence
    of BOTH gangs."""
    eng = sim.engine
    cp = sim.cp
    cp.planner_factory = lambda: _device_planner(sim.device)    # gang_fit on device
    sim.start_raft_workload(interval=0.8)

    CPU = 2 * 10 ** 9    # 4 slots per 8-cpu worker
    a = cp.agents
    # shrink to 3 workers x 4 slots = 12 before the gangs arrive
    eng.at(eng.clock.start + 6.0, "node death w0", a[0].crash)
    eng.at(eng.clock.start + 7.0, "node death w1", a[1].crash)

    def gangs():
        # the injected fault: two half-placeable gangs race for 12
        # slots — the deadlock gang scheduling exists to break
        eng.log("fault gang-deadlock scheduler")
        cp.add_service("svc-gang-a", 8, gang_min=8, nano_cpus=CPU)
        cp.add_service("svc-gang-b", 8, gang_min=8, nano_cpus=CPU)
    eng.at(eng.clock.start + 10.0, "two contending gangs", gangs)

    # leader churn mid-contention: the deferred unit's age/blocked
    # bookkeeping is leader-local and must rebuild on the successor
    eng.at(eng.clock.start + 20.0, "stepdown mid-contention",
           sim.stepdown_leader)
    # agent churn under the placed gang: its replacements re-place
    # against placed-live min_size accounting, still atomically
    eng.at(eng.clock.start + 26.0, "agent crash w2", a[2].crash)
    eng.at(eng.clock.start + 34.0, "agent return w2", a[2].restart)
    eng.at(eng.clock.start + 38.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 44.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))
    # capacity returns: the deferred gang must now place in full
    eng.at(eng.clock.start + 48.0, "node return w0", a[0].restart)
    eng.at(eng.clock.start + 52.0, "node return w1", a[1].restart)
    cp.expect_service_running("svc-gang-a", 8)
    cp.expect_service_running("svc-gang-b", 8)
    return 80.0


_gang_deadlock.raft_cp = True


def _pipeline_chaos(sim: Sim) -> float:
    """Pipeline DAG rollout under churn (ISSUE 16): a 3-deep workflow
    (stage-a -> stage-b -> {stage-c, stage-d}) where the supervisor
    must release each stage only once its upstream is fully running —
    across a leader crash landing between releases (verdicts are
    replicated on the Service rows, so the successor resumes them).
    stage-b is poisoned from the start: its tasks die on startup, so it
    accumulates failure observations past the poison threshold and the
    supervisor must HALT both downstream stages — stage-c freezes
    (halt), stage-d scales to zero (rollback policy) — while stage-b
    itself stays released and churns restarts until the global heal.
    Judged by the pipeline-order invariant (no downstream task RUNNING
    before its upstream ever ran) plus the end-state verdicts."""
    eng = sim.engine
    cp = sim.cp
    sim.start_raft_workload(interval=0.8)

    def poison():
        # the injected fault: the mid stage is poisoned — every task
        # dies on startup until the end-of-scenario heal
        eng.log("fault pipeline-stage orchestrator")
        cp.poison_services.add("svc-stage-b")
    eng.at(eng.clock.start + 4.0, "poison mid stage", poison)

    eng.at(eng.clock.start + 6.0, "stage a",
           lambda: cp.add_service("svc-stage-a", 4))
    eng.at(eng.clock.start + 8.0, "stage b",
           lambda: cp.add_service("svc-stage-b", 4,
                                  depends_on=["svc-stage-a"]))
    eng.at(eng.clock.start + 10.0, "stages c+d", lambda: (
        cp.add_service("svc-stage-c", 3, depends_on=["svc-stage-b"],
                       on_upstream_failure="halt"),
        cp.add_service("svc-stage-d", 3, depends_on=["svc-stage-b"],
                       on_upstream_failure="rollback")))

    # leader crash between stage releases: the successor's supervisor
    # resumes from the replicated pipeline_status verdicts
    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 14.0, "crash leader mid-rollout",
           crash_leader)
    eng.at(eng.clock.start + 30.0, "stepdown", sim.stepdown_leader)
    eng.at(eng.clock.start + 36.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 42.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))

    cp.expect_service_running("svc-stage-a", 4,
                              label="pipeline-converges")
    # released before the poison verdicts land downstream; churns
    # restarts until the heal clears the poison, then converges
    cp.expect_pipeline_state("svc-stage-b", "released")
    cp.expect_pipeline_state("svc-stage-c", "halted")
    cp.expect_pipeline_state("svc-stage-d", "halted")
    return 75.0


_pipeline_chaos.raft_cp = True


# ----------------------------------------- follower-served read plane
#
# ISSUE 11: the consumer plane (watch streams, agent sessions,
# linearizable control-API reads) is served from FOLLOWER members'
# replicated stores — raft read-index/lease reads underneath — and must
# survive leader loss.  Judged by follower-reads-never-uncommitted,
# lease-read-safe-under-skew and watch-resume-no-gap-no-dup on top of
# the shared checkers.


def _follower_read_failover(sim: Sim) -> float:
    """Watchers + agent sessions pinned to followers while the leader
    crashes, a partition strands an ex-leader whose expired lease must
    refuse to serve, and a clock-skew fault forces lease reads to
    auto-degrade to read-index rounds.  Watch streams must lose nothing
    across member hops (resume-token continuity), agent sessions must
    fail over to different members, and no read may ever be stale."""
    from ..manager.watchapi import WatchRequest
    from ..models import Task
    from ..state.raft.node import ReadUnavailable
    eng = sim.engine
    cp = sim.cp
    cp.enable_follower_reads()
    sim.start_raft_workload(interval=0.8)
    cp.create_tasks(10)
    # one broad watcher, one using the per-kind field filters (the
    # member-agnostic filter path): both judged for continuity
    cp.add_watchers(1)
    cp.add_watchers(1, request=WatchRequest(kinds=[Task],
                                            service_ids=["svc-sim"]))
    cp.start_read_probes(interval=1.5)

    # leader crash mid-run: sessions + streams hop to survivors
    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 14.0, "crash leader", crash_leader)

    # agent churn rides along (session re-resolution under backoff)
    a = cp.agents
    eng.at(eng.clock.start + 18.0, "agent crash", a[1].crash)
    eng.at(eng.clock.start + 27.0, "agent restart", a[1].restart)

    # crash the member a watcher is pinned to: its stream MUST resume on
    # a different member from its token — the continuity checker judges
    # the hop gap-free and dup-free
    def crash_watch_member():
        w = cp.watchers[0]
        m = w.member
        if m is None or not m.alive:
            return
        m.crash()
        eng.after(6.0, "restart watch member", m.restart)
    eng.at(eng.clock.start + 21.0, "crash watcher member",
           crash_watch_member)

    # partition the (new) leader and, mid-partition, make the stranded
    # ex-leader TRY to serve a linearizable read: its lease is expired
    # and its read-index round cannot reach a quorum — the read must
    # come back unavailable (or fresh after heal), never stale
    state: Dict[str, object] = {}

    def cut_leader():
        m = sim.leader()
        if m is None:
            return
        state["ex"] = m
        sim.net.isolate(m.id)
        eng.after(8.0, "heal ex-leader partition",
                  lambda: sim.net.rejoin(m.id))
    eng.at(eng.clock.start + 26.0, "partition leader", cut_leader)

    def stale_probe():
        m = state.get("ex")
        if m is None or not m.alive or m.store is None:
            return
        eng.log("fault stale-read-probe read-plane")
        try:
            cp.linearizable_read(m, lambda tx: len(tx.find(Task)),
                                 timeout=4.0)
            # success means the barrier confirmed FRESH data (e.g. the
            # partition healed under it) — the invariants judge safety
        except ReadUnavailable:
            cp.read_stats["stale_probe_refused"] += 1
    eng.at(eng.clock.start + 28.5, "stale-read probe", stale_probe)

    # clock-skew fault: lease reads must auto-disable (degrade to
    # read-index) for its whole duration
    def skew_on():
        lead = sim.leader()
        victim = next((m for m in sim.managers
                       if m.alive and m is not lead), sim.managers[0])
        state["skewed"] = victim
        victim.tick_scale = 2.0
        eng.log(f"fault clock-skew {victim.id} x2")

    def skew_off():
        victim = state.get("skewed")
        if victim is not None:
            victim.tick_scale = 1.0
            eng.log(f"fault clock-skew {victim.id} off")
    eng.at(eng.clock.start + 38.0, "skew member", skew_on)
    eng.at(eng.clock.start + 46.0, "unskew member", skew_off)

    eng.at(eng.clock.start + 40.0, "more tasks",
           lambda: cp.create_tasks(6))
    return 55.0


_follower_read_failover.raft_cp = True


def _read_storm_degraded(sim: Sim) -> float:
    """Continuous linearizable read load against follower members while
    the leadership churns (stepdowns, a crash, a drop burst): every
    probe must eventually serve — degraded to read-index latency during
    gaps, NEVER an error, never stale — and the follower-pinned watch
    streams must stay continuous throughout."""
    eng = sim.engine
    cp = sim.cp
    cp.enable_follower_reads()
    cp.expect_reads_never_fail = True
    sim.start_raft_workload(interval=0.8)
    cp.create_tasks(12)
    cp.add_watchers(2)
    eng.log("fault read-storm read-plane")
    cp.start_read_probes(interval=1.0, timeout=25.0)

    # rolling leader churn under the storm
    for t in (10.0, 18.0, 34.0):
        eng.at(eng.clock.start + t, "stepdown", sim.stepdown_leader)

    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 24.0, "crash leader", crash_leader)

    eng.at(eng.clock.start + 30.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 36.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))
    eng.at(eng.clock.start + 20.0, "more tasks",
           lambda: cp.create_tasks(8))
    return 48.0


_read_storm_degraded.raft_cp = True


# ------------------------------------------- million-swarm harness
#
# ISSUE 20: overload-safe serving at fleet scale.  A MuxAgentFleet
# multiplexes an env-scalable session count over one driver timer and
# one RPC budget; the dispatcher runs with its overload-protection
# bounds ON (session cap, adaptive heartbeat stretch, bounded status
# buffer, counted assignment-set compaction) and the scenario drives a
# full task fan-out through a leader crash, a follower-plane member
# crash, and a drop burst.  Judged by the shared checkers plus
# overload-sheds-are-counted-and-recovered and
# heartbeat-liveness-under-stretch.


def _million_swarm(sim: Sim) -> float:
    """Full fan-out at fleet scale under overload bounds: the status
    storm right after the fan-out overruns the bounded per-plane update
    buffer (admission sheds — every one counted and recovered), the
    session count runs past the stretch threshold (adaptive heartbeat
    stretching — no premature expiry allowed), and the usual chaos
    (leader crash, follower-plane crash, drop burst, fleet-agent churn)
    rides on top.  Sessions/tasks scale via
    ``SWARM_MILLION_SWARM_SESSIONS`` / ``SWARM_MILLION_SWARM_TASKS``
    (defaults sized for the sweep; crank them for soak runs — the
    event budget scales along)."""
    from .cluster import MuxAgentFleet
    eng = sim.engine
    cp = sim.cp
    sessions = int(os.environ.get("SWARM_MILLION_SWARM_SESSIONS", "64"))
    fanout = int(os.environ.get("SWARM_MILLION_SWARM_TASKS", "150"))
    eng.max_events = max(eng.max_events, sessions * 50_000)
    cp.enable_follower_reads()
    # overload-protection bounds, applied to every dispatcher the plane
    # builds (leader + follower read planes).  The update-buffer bound
    # sits well under the fan-out's per-window status arrivals, so the
    # storm MUST shed; the session cap sits above the fleet, so steady
    # registration stays admitted (register-path sheds are pinned by
    # unit tests instead — a scenario-level cap would just park part of
    # the fleet forever).
    cp.dispatcher_overrides = {
        "max_sessions": sessions + cp.n_agents + 8,
        "hb_stretch_start": max(4, sessions // 8),
        "hb_stretch_max": 4.0,
        "max_pending_updates": max(12, fanout // 12),
        "max_terminal_tasks": max(64, fanout),
    }
    # generous tick budget: the deadline plumbing runs live (virtual
    # now() advances through each group's consensus commit) without
    # starving convergence in the common case
    cp.tick_budget_s = 1.5
    fleet = MuxAgentFleet(cp, sessions, interval=1.0,
                          driver_interval=0.25,
                          rpc_budget=max(64, sessions // 2))
    sim.start_raft_workload(interval=0.8)
    cp.create_tasks(12)

    # the fan-out: one burst to the full task count — the status storm
    # in the following windows is the overload the plane must absorb
    def fan_out():
        eng.log("fault fan-out-burst dispatcher")
        cp.scale(fanout)
    eng.at(eng.clock.start + 8.0, "full fan-out", fan_out)

    # leader crash AT full fan-out: the successor re-learns the fleet
    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 14.0, "crash leader at fan-out",
           crash_leader)

    # follower-plane failover: kill a member SERVING sessions — its
    # shard re-registers across the survivors (jitter-spread, not a
    # thundering herd)
    def crash_follower():
        lead = sim.leader()
        victim = next((m for m in sim.managers
                       if m.alive and m is not lead), None)
        if victim is None:
            return
        victim.crash()
        eng.after(8.0, "restart follower", victim.restart)
    eng.at(eng.clock.start + 26.0, "crash follower plane",
           crash_follower)

    eng.at(eng.clock.start + 34.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.12))
    eng.at(eng.clock.start + 40.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))

    # fleet-agent churn: a slice of sessions dies and returns
    for i, (t_down, t_up) in enumerate(((20.0, 36.0), (30.0, 44.0))):
        a = fleet.agents[i * 7]
        eng.at(eng.clock.start + t_down, "fleet agent crash", a.crash)
        eng.at(eng.clock.start + t_up, "fleet agent restart", a.restart)
    return 60.0


_million_swarm.raft_cp = True


# ----------------------------------------------- rolling-update scenarios
#
# The UpdateSupervisor is live inside the raft-attached control plane
# (threadless drive mode): these scenarios run REAL spec rollouts —
# parallelism, per-batch delay, monitor window, failure pause/rollback —
# under partitions, crashes and churn, with convergence and version
# invariants on top of the shared checkers (UpdateInvariants,
# expect_update, placement quality).


def _update_cfg(action, parallelism=3, delay=0.2, monitor=1.5,
                ratio=0.2):
    from ..models.types import UpdateConfig
    return UpdateConfig(parallelism=parallelism, delay=delay,
                        monitor=monitor, max_failure_ratio=ratio,
                        failure_action=action)


def _rolling_upgrade_chaos(sim: Sim) -> float:
    """Rolling spec updates under chaos: a good rollout rides a leader
    stepdown + leader partition (the in-flight rollout hands off to the
    successor), a poisoned rollout triggers automatic rollback, and a
    second poisoned rollout pauses at the failure threshold — each leg
    bounded by update-convergence invariants, with agent churn and a
    drop burst along the way."""
    from ..models.types import UpdateFailureAction, UpdateState
    eng = sim.engine
    cp = sim.cp
    sim.start_raft_workload(interval=0.8)
    cp.scale(6)
    cp.placement_quality_bound = 4.0

    # leg 1: good rollout, CONTINUE action, leader churn mid-rollout
    def leg1():
        v = cp.rollout("img:2", update=_update_cfg(
            UpdateFailureAction.CONTINUE))
        cp.expect_update(v, (UpdateState.COMPLETED,), 55.0)
    eng.at(eng.clock.start + 8.0, "rollout good", leg1)
    eng.at(eng.clock.start + 11.0, "stepdown mid-rollout",
           sim.stepdown_leader)

    def partition_leader():
        m = sim.leader()
        if m is None:
            return
        sim.net.isolate(m.id)
        eng.after(4.0, "heal leader partition",
                  lambda: sim.net.rejoin(m.id))
    eng.at(eng.clock.start + 16.0, "partition leader mid-rollout",
           partition_leader)

    # leg 2: poisoned rollout -> automatic rollback restores the old spec
    def leg2():
        v = cp.rollout("img:bad-rb", poison=True, update=_update_cfg(
            UpdateFailureAction.ROLLBACK))
        cp.expect_update(v, (UpdateState.ROLLBACK_COMPLETED,), 100.0)
    eng.at(eng.clock.start + 45.0, "rollout poisoned (rollback)", leg2)

    # leg 3: poisoned rollout with PAUSE -> halts at the threshold
    def leg3():
        v = cp.rollout("img:bad-pause", poison=True, update=_update_cfg(
            UpdateFailureAction.PAUSE))
        cp.expect_update(v, (UpdateState.PAUSED,), 110.0)
    eng.at(eng.clock.start + 80.0, "rollout poisoned (pause)", leg3)

    # background churn
    a = cp.agents
    eng.at(eng.clock.start + 20.0, "agent crash", a[2].crash)
    eng.at(eng.clock.start + 30.0, "agent restart", a[2].restart)
    eng.at(eng.clock.start + 50.0, "drop burst",
           lambda: setattr(sim.net.config, "drop_p", 0.1))
    eng.at(eng.clock.start + 58.0, "drop off",
           lambda: setattr(sim.net.config, "drop_p", 0.0))
    eng.at(eng.clock.start + 62.0, "agent partition",
           lambda: a[4].partition(True))
    eng.at(eng.clock.start + 72.0, "agent heal",
           lambda: a[4].partition(False))
    return 100.0


_rolling_upgrade_chaos.raft_cp = True


def _cascading_failure_rebalance(sim: Sim) -> float:
    """Sequential node deaths during a rebalance: a scale-up lands while
    nodes die one after another (heartbeat TTL -> DOWN -> restart
    supervisor re-places), a leader crash rides the cascade, and the
    post-convergence placement must still be balanced (quality bound),
    not just complete."""
    eng = sim.engine
    cp = sim.cp
    sim.start_raft_workload(interval=0.8)
    cp.scale(6)
    cp.placement_quality_bound = 3.5

    eng.at(eng.clock.start + 8.0, "scale up (rebalance)",
           lambda: cp.scale(14))
    a = cp.agents
    # the cascade: one death every ~6s while the scale-up places
    eng.at(eng.clock.start + 10.0, "node death w0", a[0].crash)
    eng.at(eng.clock.start + 16.0, "node death w1", a[1].crash)
    eng.at(eng.clock.start + 22.0, "node death w2", a[2].crash)
    eng.at(eng.clock.start + 21.0, "node return w0", a[0].restart)
    eng.at(eng.clock.start + 28.0, "node return w1", a[1].restart)
    eng.at(eng.clock.start + 34.0, "node return w2", a[2].restart)

    def crash_leader():
        m = sim.leader()
        if m is None:
            return
        m.crash()
        eng.after(6.0, "restart ex-leader", m.restart)
    eng.at(eng.clock.start + 18.0, "crash leader mid-cascade",
           crash_leader)

    eng.at(eng.clock.start + 26.0, "scale down", lambda: cp.scale(10))
    eng.at(eng.clock.start + 32.0, "scale up again",
           lambda: cp.scale(16))
    return 48.0


_cascading_failure_rebalance.raft_cp = True


def _long_soak(sim: Sim) -> float:
    """Long-horizon virtual-time soak: repeated rollouts (every third
    one poisoned and rolled back) over continuous mixed churn — agent
    crash/partition cycles, manager crash/restart, leader stepdowns,
    partitions, drop bursts, scale oscillation.  Default duration is
    ``SWARM_SOAK_VIRTUAL_SECONDS`` (1200 = 20 virtual minutes; crank it
    for multi-day soaks — the event budget scales with it).  Every good
    rollout must converge within its bound and the end placement must
    meet the quality bound."""
    from ..models.types import UpdateFailureAction, UpdateState
    eng = sim.engine
    cp = sim.cp
    duration = float(os.environ.get("SWARM_SOAK_VIRTUAL_SECONDS", "1200"))
    sim.engine.max_events = max(sim.engine.max_events,
                                int(duration) * 2000)
    sim.start_raft_workload(interval=0.9)
    cp.scale(8)
    cp.placement_quality_bound = 4.0
    rng = eng.fork_rng()
    counter = {"n": 0}

    def rollout_cycle():
        if sim.finishing:
            return False
        if eng.clock.elapsed() > duration - 120.0:
            return False   # last rollout must fit its convergence bound
        counter["n"] += 1
        n = counter["n"]
        if n % 3 == 0:
            v = cp.rollout(f"img:bad-{n}", poison=True,
                           update=_update_cfg(
                               UpdateFailureAction.ROLLBACK))
            cp.expect_update(v, (UpdateState.ROLLBACK_COMPLETED,),
                             eng.clock.elapsed() + 110.0)
        else:
            v = cp.rollout(f"img:{n}", update=_update_cfg(
                UpdateFailureAction.CONTINUE))
            cp.expect_update(v, (UpdateState.COMPLETED,),
                             eng.clock.elapsed() + 110.0)
        return None
    eng.every(120.0, "soak rollout", rollout_cycle, phase=15.0)

    def agent_churn():
        if sim.finishing:
            return False
        up = [a for a in cp.agents if a.alive]
        if len(up) > 3:
            victim = rng.choice(up)
            victim.crash()
            eng.after(10.0 + rng.random() * 10.0, "soak agent restart",
                      victim.restart)
        return None
    eng.every(45.0, "soak agent churn", agent_churn, phase=25.0)

    def manager_churn():
        if sim.finishing:
            return False
        alive = [m for m in sim.managers if m.alive]
        if len(alive) <= 2:
            return None
        victim = rng.choice(alive)
        victim.crash()
        eng.after(5.0 + rng.random() * 5.0,
                  f"soak restart {victim.id}", victim.restart)
        return None
    eng.every(140.0, "soak manager churn", manager_churn, phase=70.0)

    def partition_cycle():
        if sim.finishing:
            return False
        mids = [m.id for m in sim.managers]
        lone = rng.choice(mids)
        sim.net.split([lone], [m for m in mids if m != lone])
        eng.after(4.0 + rng.random() * 4.0, "soak heal", sim.net.heal_all)
        return None
    eng.every(90.0, "soak partition", partition_cycle, phase=40.0)

    def stepdown():
        if sim.finishing:
            return False
        sim.stepdown_leader()
        return None
    eng.every(200.0, "soak stepdown", stepdown, phase=100.0)

    def drop_burst():
        if sim.finishing:
            return False
        sim.net.config.drop_p = 0.05 + rng.random() * 0.1
        eng.after(3.0 + rng.random() * 4.0, "soak drops off",
                  lambda: setattr(sim.net.config, "drop_p", 0.0))
        return None
    eng.every(150.0, "soak drop burst", drop_burst, phase=60.0)

    def scale_wobble():
        if sim.finishing:
            return False
        cp.scale(6 + (counter["n"] % 3) * 2)
        return None
    eng.every(160.0, "soak scale wobble", scale_wobble, phase=130.0)
    return duration


_long_soak.raft_cp = True


def _raft_cp_variant(fn: Callable[[Sim], float],
                     base: str) -> Callable[[Sim], float]:
    """Route a legacy standalone-control-plane scenario through the
    raft-attached control plane: same fault timeline, but the real
    scheduler/dispatcher/orchestrators/updater run on the elected
    leader's replicated store, under the failover invariants too."""
    def scenario(sim: Sim) -> float:
        return fn(sim)
    scenario.raft_cp = True
    scenario.__doc__ = (f"'{base}' driven through the raft-attached "
                        "control plane (Sim(raft_cp=True)): "
                        + (fn.__doc__ or "").strip())
    return scenario


SCENARIOS: Dict[str, Callable[[Sim], float]] = {
    "partition-churn": _partition_churn,
    "crash-leader-mid-commit": _crash_leader_mid_commit,
    "crash-restart-churn": _crash_restart_churn,
    "clock-skew": _clock_skew,
    "agent-storm": _agent_storm,
    "pipelined-commit-churn": _pipelined_commit_churn,
    "fused-differential-churn": _fused_differential_churn,
    # streaming scheduler: incremental vs full-replan twin differential
    "steady-state-churn": _steady_state_churn,
    "random-fuzz": _random_fuzz,
    # failover suite (raft-attached control plane); depth = store-level
    # chunk-pipelined proposal window
    "leader-crash-mid-tick": _mk_leader_crash_mid_tick(2),
    "leader-crash-mid-tick-d1": _mk_leader_crash_mid_tick(1),
    "partition-pipelined-commit": _mk_partition_pipelined_commit(2),
    "partition-pipelined-commit-d1": _mk_partition_pipelined_commit(1),
    "failover-churn-rollout": _failover_churn_rollout,
    # priority & preemption (device victim kernel + host oracle)
    "preemption-storm": _preemption_storm,
    # autoscaler + multi-tenant QoS (quota mask column + control loop)
    "tenant-storm": _tenant_storm,
    # gang scheduling & pipeline workflows (atomic admission, DAG gate)
    "gang-deadlock": _gang_deadlock,
    "pipeline-chaos": _pipeline_chaos,
    # follower-served read plane (read-index/lease reads, resume tokens)
    "follower-read-failover": _follower_read_failover,
    "read-storm-degraded": _read_storm_degraded,
    # overload plane + mux-fleet harness (ISSUE 20)
    "million-swarm": _million_swarm,
    # rolling-update suite (real UpdateSupervisor, threadless drive)
    "rolling-upgrade-chaos": _rolling_upgrade_chaos,
    "cascading-failure-rebalance": _cascading_failure_rebalance,
    "long-soak": _long_soak,
    # legacy scenarios routed through the raft-attached control plane
    "partition-churn-rcp": _raft_cp_variant(_partition_churn,
                                            "partition-churn"),
    "crash-restart-churn-rcp": _raft_cp_variant(_crash_restart_churn,
                                                "crash-restart-churn"),
    "agent-storm-rcp": _raft_cp_variant(_agent_storm, "agent-storm"),
}

#: the failover sweep scripts/chaos_sweep.py seed-sweeps by default
FAILOVER_SCENARIOS = (
    "leader-crash-mid-tick", "leader-crash-mid-tick-d1",
    "partition-pipelined-commit", "partition-pipelined-commit-d1",
    "failover-churn-rollout",
)

#: rolling-update chaos suite (ISSUE 8)
UPDATE_SCENARIOS = (
    "rolling-upgrade-chaos", "cascading-failure-rebalance", "long-soak",
)

#: priority & preemption suite (ISSUE 10)
PREEMPT_SCENARIOS = ("preemption-storm",)

#: autoscaler + multi-tenant QoS suite (ISSUE 12)
QOS_SCENARIOS = ("tenant-storm",)

#: gang scheduling & pipeline workflows suite (ISSUE 16)
GANG_SCENARIOS = ("gang-deadlock", "pipeline-chaos")

#: follower-served read plane (ISSUE 11)
READ_SCENARIOS = ("follower-read-failover", "read-storm-degraded")

#: streaming scheduler differential (ISSUE 14)
STREAMING_SCENARIOS = ("steady-state-churn",)

#: overload plane + million-swarm harness (ISSUE 20)
OVERLOAD_SCENARIOS = ("million-swarm",)

#: legacy fault timelines re-driven through Sim(raft_cp=True)
LEGACY_RCP_SCENARIOS = (
    "partition-churn-rcp", "crash-restart-churn-rcp", "agent-storm-rcp",
)

#: scenarios the seed-rotating fuzzers (``python -m swarmkit_tpu_torch.sim
#: --fuzz`` without --scenario, and chaos_sweep --suite fuzz) draw from.
#: Every registry entry must be here or in FUZZ_EXCLUDED with a reason —
#: tests/test_update_chaos.py enforces the parity, so a new scenario
#: cannot silently lag fuzz coverage.
FUZZ_EXCLUDED: Dict[str, str] = {
    "long-soak": "minutes of virtual time per run; swept by the "
                 "dedicated slow soak test, not per-seed rotation",
    "million-swarm": "heavyweight mux-fleet fan-out (an order of "
                     "magnitude more events per run than the rotation "
                     "scenarios); swept by its own chaos_sweep suite "
                     "and the dedicated determinism test instead",
}
FUZZ_POOL: tuple = tuple(
    sorted(n for n in SCENARIOS if n not in FUZZ_EXCLUDED))


# ------------------------------------------------------------------ runner

def run_scenario(name: str, seed: int, n_managers: int = 3,
                 n_agents: int = 5, grace: float = 20.0,
                 keep_trace: bool = False,
                 flightrec_dir: Optional[str] = None,
                 device=None) -> SimReport:
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    # where every planner of the run is built (None -> the card), resolved
    # here, in the caller's thread and before the Sim exists, for every
    # scenario: a planner built mid-run (a new leader's) would otherwise
    # meet a missing card inside the chaos
    from ..ops.convert import resolve_device
    device = resolve_device(device)
    sim = Sim(seed, n_managers=n_managers, n_agents=n_agents,
              net_config=NetConfig(),
              raft_cp=getattr(fn, "raft_cp", False))
    sim.device = device
    with sim:
        # record control-plane spans under the virtual clock: epoch and
        # every timestamp are virtual, span ids are a counter, and the
        # sim is single-threaded — the exported JSON is a pure function
        # of (scenario, seed).  The shared tracer's prior recording
        # state (an embedding process may be tracing) is saved and
        # restored around the scenario.  Constraint: other threads must
        # not RECORD spans while the scenario runs (their wall-clock
        # spans would land in the sim buffer and break byte-identity) —
        # run sims from the CLI or tests, not inside a live traced
        # manager process.
        saved = tracer.save_state()
        fr_saved = flightrec.save_state()
        pl_saved = planes_mod.save_state()
        j_saved = journeys.save_state()
        tracer.reset()
        tracer.enable()
        # the black box records continuously under virtual time:
        # spans (tracer sink), store events, raft transitions, and
        # periodic metric samples (deltas, so concurrent-process
        # history cannot leak into the capture).  A violating or
        # crashing run dumps it as a post-mortem whose sha is a pure
        # function of the seed.
        flightrec.reset(deterministic=True)
        flightrec.enabled = True
        # journeys at full sample under the virtual clock: every member
        # mints milestones from replicated stamps via the recorder's
        # store taps, so the ledger stitches across leader crashes and
        # its bytes are seed-pure (JOURNEY_CAP bounds memory)
        planes_mod.reset()
        journeys.reset(sample_rate=1.0)
        journeys.enabled = True
        flightrec.journey_sink = journeys.handle_event
        # raft-attached mode taps every member's replicated store (the
        # leader's commits and the followers' replayed applies both land
        # in the black box); standalone taps the one control-plane store.
        # A store rebuilt by a crash-restart is not re-tapped — the
        # post-mortem keeps the pre-crash view, the WAL has the rest.
        fr_stores = [m.store for m in sim.managers
                     if m.store is not None] or [sim.cp.store]
        for s in fr_stores:
            flightrec.watch_store(s)
        sampler = Sampler(deterministic=True)

        def _sample():
            if sim.cp.stopped:
                return False
            flightrec.poll_store()
            sampler.sample()
            return None

        sim.engine.every(5.0, "flightrec sample", _sample)
        fr_path = fr_sha = ""
        crashed = False
        try:
            sim.engine.log(f"scenario {name} seed {seed}")
            duration = fn(sim)
            sim.run(duration)
            sim.finish(grace=grace)
            stats = sim.stats()
        except BaseException as e:
            crashed = True
            flightrec.note(f"scenario crashed: {type(e).__name__}: {e}")
            raise
        finally:
            tracer.disable()
            obs_trace = tracer.to_json()
            # fold any store events still buffered into the ledger
            # before capturing it (the dump below reads it too)
            flightrec.poll_store()
            j_dump = journeys.dump()
            j_sha = hashlib.sha256(journeys.dump_bytes()).hexdigest()
            if crashed or sim.violations.items:
                fr_path, fr_sha = _dump_flightrec(name, seed,
                                                  flightrec_dir)
            flightrec.enabled = False
            journeys.enabled = False
            for s in fr_stores:                     # only the sim's taps
                flightrec.unwatch_store(s)
            flightrec.restore_state(fr_saved)
            journeys.restore_state(j_saved)
            planes_mod.restore_state(pl_saved)
            tracer.restore_state(saved)
    return SimReport(
        scenario=name, seed=seed, duration=duration + grace,
        events=sim.engine.events_run, trace_hash=sim.engine.trace_hash(),
        ok=not sim.violations.items,
        violations=list(sim.violations.items), stats=stats,
        trace=list(sim.engine.trace) if keep_trace else [],
        obs_trace=obs_trace, flightrec_path=fr_path,
        flightrec_sha256=fr_sha, journeys_dump=j_dump,
        journeys_sha256=j_sha)


def _dump_flightrec(name: str, seed: int,
                    flightrec_dir: Optional[str]) -> tuple:
    """Write the post-mortem (``flightrec_<scenario>_seed<N>.json``) in
    ``flightrec_dir`` (default: $SWARM_SIM_FLIGHTREC_DIR, else cwd)."""
    d = flightrec_dir or os.environ.get("SWARM_SIM_FLIGHTREC_DIR") or "."
    path = os.path.join(d, f"flightrec_{name}_seed{seed}.json")
    try:
        sha = flightrec.dump(path)
    except OSError:
        return "", ""
    return path, sha
