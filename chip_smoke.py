#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's scheduler on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each of which exits non-zero on failure:

1. card: name and power limit (``nvidia-smi``) and the device torch sees,
   and whether the ``cryptography`` package imports (no phase needs it);
2. build: compile the CUDA kernels of ``swarmkit_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a (``-Xptxas -v``: registers and shared memory), all
   sources in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, on
   seeded inputs at the main paths' shapes (node bucket 16384; leaf bucket
   256, 4 constraint slots, 4 platform rows, branch totals around 2^24 for
   K1-K3; a cfg7 chunk of 4 group slots over 16 service slots for K1F
   (its binpack slot), the scored K1F (its weighted and learned slots:
   K6's score as the slot entry's epilogue), K4's carry update, K5, K6 and
   the scored K1 (spread, weighted, learned));
   K2 twice back to back without a sync, one launch a call; K3 (one
   cluster launch a call) also over one spread value per node (L =
   16,384); K5 (one launch a call) also on its edge cases
   (``pack_edge_inputs``); outputs must be bit-equal, and so must one
   fused chunk on the card and on the CPU.  Times come from CUDA events
   and torch.profiler (every kernel launch's row counted);
4. headline path: the headline cluster (10,000 nodes, 100,000 tasks of one
   replicated service, 20% preassigned, spread over 20 racks) through
   ``Scheduler`` + ``TorchPlanner()``: every task placed on the device,
   racks balanced within 1, K1-K3 launched;
5. traced tick: a second headline tick under the span tracer and
   torch.profiler -- where the wall time goes, the device's busy share;
6. host oracle: per-node task counts of ``TorchPlanner`` on the card equal
   the host path's on a 1,000-node cluster of the same shape and on a
   constrained one (tier==web, linux/amd64);
7. many-service path: bench.py's config 7 (10,000 nodes, 10 services of
   50,000 tasks, one tick) with the services split over spread, binpack,
   weighted and learned: all 500,000 tasks placed through the fused route
   (10 groups fused in 3 chunks, none on the host), every kernel of the
   route launched: K1F once a group slot (scored for the weighted and
   learned ones), K4's carry update once a chunk, no standalone K1 and no
   K6; every kernel's count exactly the route's (31 launches);
8. traced many-service tick: its traced twin;
9. many-service host oracle: at 1,000 nodes x 10,000 tasks, per-service
   per-node counts of the card's fused tick equal the host path's (the
   spread tree walk and ``scheduler/strategy.py``'s oracles);
10. kernels K7 and K8: the dirty-row scatter at node bucket 16384 at
    16, 256 and 4096 update slots (with pad slots), unsplit and over four
    shards of the card (one launch over the shard table), and the gang
    fit (one node a thread, the blocks of a gang meeting in self-counting
    atomic words) at node buckets 512, 1,024 (the gang fleet's) and 16,384
    with G = 1, 2 and 8 (a quota column at 16,384 and G = 1; totals at
    k - 1, k, k + 1 and above 2^24), each bit-equal to its plain version
    on the card; K7 also timed against ``index_copy_`` over the five
    columns;
11. steady-state churn: bench.py's config 10 (8,192 nodes, 12,000 base
    tasks, 12 seeded windows of Poisson arrivals and exits, plus a 13th in
    which three services arrive at once) through the store watch feed, in
    four postures: the streaming resident state, full rebuilds, the
    resident state and the plans split over four shards of the card, and
    layout changes (four shards, no mesh from window 4, two shards from
    window 8, each a counted resync): equal placement digests after every
    window, at least 13 incremental refreshes and no fallback after the
    cold tick, K7 launched once a scattering device sync (one launch over
    every shard on a mesh) with one staged H2D, on every window with
    dirty rows, K10 launched on the mesh, the fused run seeded from the
    resident columns, and the resident CUDA columns (or shards) equal to
    the host mirror after the last tick;
12. gang fleet: bench.py's config 12 gangs (400 nodes, 72 gangs, 416
    members): every gang admitted whole in one tick with 80 verdicts from
    K8 (64 per group, 16 fused rows; 72 launches), placements equal to
    the host path's by creation index, and an added infeasible gang
    deferred whole; one verdict through the planner's route (the packed
    stage) timed warm at the fleet's shapes and at node bucket 16384, and
    its device ops exactly one H2D, one K8 and one D2H;
13. config 8: bench.py's priority bands (512 nodes, 1,800 priority-0
    tasks running, 584 higher-priority arrivals in one tick) through
    ``TorchPlanner()``: every arrival assigned with preemptions, K9
    launched once per preempting group, each call's picks equal to
    ``select_victims_host``, and the live tasks per (service, node) and the
    victims equal to the host path's;
14. kernel K9 at node bucket 16384 for V = 4, 16 and 64 with 512 picks:
    the victim selection on a full run, a budget stop and an infeasible
    stop, each bit-equal to its plain version on the card (negative free
    pools, a generic column); wrapper, device (both launches) and H2D
    times; and on the inputs of config 8's calls (node bucket 1024,
    V = 4), bit-equal and timed;
15. priority storm at the headline width (10,000 nodes, 150,000 running
    tasks, 512 priority-2 arrivals): every arrival placed through K9, each
    call's picks equal to the plain version on the card and on the CPU,
    its traced twin, and at 1,000 nodes each call's picks equal to the
    host oracle's;
16. the node-axis split's kernels at node bucket 16384 on four shards of
    the card: K10 (one launch a fill) over 20 segments (equal loads across
    the shard borders, capacity sums past 2^24, a segment that cannot be
    filled), over one, over the headline's leaf fill (L = 256, timed) and
    over one segment a row (L = 16,384, timed), K11 (one launch a fill)
    at and below the whole capacity and on K5's edge cases, each
    bit-equal to its plain version on the same tensors, K10's and K11's
    profiles within 15% of the median of ``probes/kernel_ab.py --fills``
    run in three processes of its own; K2 over the shard table (one
    launch a level) at the headline's leaf level, against its plain
    version and K2 on the unsplit columns, twice without a sync;
17. the headline tick through ``TorchPlanner(mesh=make_mesh(["cuda:0"] *
    4))``: every task placed, every plan's x, fail counts and spill equal
    to the unsharded tick's (phase 4), K10 launched, stage A once a card
    (one K2 over the shard table and one K3 a level, no per-shard K2);
18. config 7 through the same mesh: every group fused in 3 chunks,
    binpack through K11 (two launches, one a fill), every kernel's count
    exactly the route's (70 launches: no K6, four K2 and four stage-A
    K3), each chunk's rows and the per-(service, node) counts equal to the
    unsharded tick's (phase 7), and its traced twin;
    with phase 16, two compositions of the split timed against the
    unsharded plans of the same inputs (B13, a weighted group's plan;
    B14, a cfg7 fused chunk);
19. a spread over a per-node label past 8,192 nodes
    (``workload.per_host_spread``: 8,200 nodes, two services of 8,200
    tasks, 16,384 leaf segments): the fused tick on the card places
    exactly as the CPU plain path, both groups fused, none on the host;
    the same tick over four shards of the card places as the unsharded
    one;
20. native plane: the headline tick and the config-7 tick (cut to
    ``NATIVE_CFG7_TASKS``, 100,000 tasks over the ten services) twice
    each, with the native C commit plane (``swarmkit_tpu_torch/native``)
    on and off (``SWARMKIT_TPU_NO_NATIVE``): equal store rows (id, node,
    state, version), equal events published and equal per-task events
    when the blocks are expanded; the tick wall, ``sched.commit`` and
    ``plan.apply`` both ways;
21. breaker: a planner whose plan path raises ``KernelLaunchError`` on
    its first three dispatches places a 1,000-node many-service tick
    through the host path exactly as the host path alone, its breaker
    open (gauge 2); after a 0.5 s cooldown the half-open probe runs the
    kernels and closes it.  Then the small-group router's inputs: the
    host path's cost a task (three host-only ticks of that cluster), the
    launch overhead (five measurements, each the median of the planner's
    own timed plans) and the break-even they give; and a trickle of small
    groups (the churn cluster, every window a few arrivals for each of
    five services) with the router off, on, on and off: equal store rows,
    groups below the break-even on the host path when it is on, and the
    churn's wall time both ways;
22. a service's life through the port's control loops
    (``workload.ControlLoops``: the scheduler, the task allocator, the
    orchestrators and their supervisors, threadless) at bench.py's config
    5 width: 10,000 nodes, and services with no task in the store --
    ``web`` (150,000 replicas spread over the racks, cut from bench.py's
    500,000 to keep the script in its time limit), ``agent`` (global)
    and ``api`` (10,000 replicas, rolled out 2,500 at a time).  Create:
    170,000 tasks made, allocated NEW -> PENDING and placed on the card
    (the preassigned pass through K1, every group on the device, racks
    within 1); drain 1,000 nodes: every replacement placed in one tick,
    off the drained nodes (the drained nodes' agents confirm their stops
    after the restart supervisor's old-task timeout), every ``web`` and
    ``api`` slot with one running task and ``agent`` on each active
    node; roll ``api`` out to a
    new image: four batches of 2,500, one device plan (one K1) each,
    every slot on the new spec.  Each stage's seconds split into the
    loops' parts and the spans (``orchestrator.reconcile``,
    ``sched.preassigned``, ``sched.tick``, ``sched.commit``), its
    decisions/s and the process's memory.  The same script at 1,000
    nodes (``LIFE_PARITY``) through the card and through the host path,
    with fixed ids: equal live tasks per (service, node) after each
    stage;
23. bench.py's config 9 (256 nodes, a high band, a tenant bursting past
    its quota, a service of the spent tenant) through the autoscaler's
    threadless supervisor and ``TorchPlanner()``: the high band placed,
    the burst at or under its quota with clamps, the blocked service
    refused "over tenant quota", an autoscale decision; the same build on
    the host path places the same counts with the same clamps;
24. the live manager (``workload.live_manager``, bench.py's
    ``run_live_manager``): config 6 (10,000 nodes, two services of
    100,000 tasks) and config 7 (``NATIVE_CFG7_TASKS``) each one pipelined
    tick through a single-voter ``RaftNode`` with a sealed WAL and the
    live manager's subscribers, against the same tick with a nil proposer
    (config 6 also a traced twin): every task assigned, equal placements
    by creation index, every group fused (2 and 10), the fused route's
    launches, no
    native fallback, the WAL made of block entries; raft's added seconds,
    ``swarm_raft_propose_latency`` and ``swarm_raft_apply_latency``, the
    device busy share and the spans ``sched.commit``, ``plan.dispatch``,
    ``plan.d2h`` and ``plan.apply``;
25. the replicated control plane (``control_script``): three raft members
    over one ``LocalNetwork``, each with its own store and sealed WAL, at
    ``CONTROL``'s width (200 racked nodes): services made through the
    leader's ``ControlAPI`` and driven by ``workload.ControlLoops`` over
    ``TorchPlanner()``; followers byte-equal to the leader, a
    linearizable follower read, a watch resumed on a follower with no
    gap and no duplicate; the leader cut off and the successor's new
    loops scaling ``web`` up; a leader deposed inside a pipelined tick
    (later drafts failed, no fenced row in any store, nothing in flight,
    the breaker closed); every member restarted from its WAL and
    snapshot, byte-equal, the new leader's loops placing a new service;
    card memory after each leadership change; the same script on the
    host path places the same live tasks per (service, node).
26. bench.py's config 13 (``workload.million_swarm``): 1,000 real
    dispatcher sessions over one threadless ``Dispatcher`` with the
    batched fan-out, 10 services, the pending cap 65,536 and report
    batches of 1,024, at ``CFG13_REPLICAS`` replicas (100,000; config 13
    has 1,000,000, which ``probes/million_swarm_probe.py`` runs): one
    tick places them through ``TorchPlanner()`` (K1F and K4's carry
    launched, no kernel build inside the timed tick), the fan-out
    delivers every replica, and the status write-back storm is shed at
    the admission edge (at least once; the dispatcher's count equal to
    the clients', none lost) until every replica is RUNNING, the
    heartbeat stretched and no session expired early; at 100 sessions
    (``CFG13_PARITY``) the card and the host path give equal replicas per
    (service, node), shed ledgers, rounds and fan-out counts;
27. bench.py's ``run_e2e`` (``workload.e2e``): a ``Manager()`` whose
    leader schedules on a ``TorchPlanner`` on the card (K1 launched),
    five agents with a ``TestExecutor`` on its dispatcher and a service
    of 500 replicas made through its control API, every replica RUNNING
    within 1 of even; one agent stopped, its node DOWN and its replicas
    RUNNING on the four others (the heal); the same over a single-voter
    raft with a sealed WAL; the card's allocated memory after each
    manager stops no higher than before it was built.
28. the daemons (``workload.daemon_swarm``): three ``Swarmd`` managers
    (raft over TCP with mutual TLS, sealed WALs) and 16 workers joined
    with their tokens over ``RemoteDispatcherClient``, on loopback in
    this process; a service of 380 replicas made through
    ``cli.run_command`` and a ``RemoteControlClient`` to the leader,
    twenty a node, the leader's scheduler a ``TorchPlanner`` on the card
    (K1-K3 launched, no group on the host path); ``m0``'s daemon stopped:
    a survivor leads with a new ``TorchPlanner`` on the card, the workers
    fail over through their remotes, ``m0``'s node goes DOWN and its
    replicas come back RUNNING on the others; ``service scale web=432``
    through the CLI: 24 on each of the 18 nodes; every daemon stopped,
    the card's memory no higher than before, ``rafttool`` reading ``m1``'s
    sealed state dir (``web`` at 432, every WAL entry decoded); the same
    script at one manager, three workers and 12 replicas on the card and
    on the host path gives equal replicas per node, before and after a
    worker's stop;
29. the simulator (``swarmkit_tpu_torch/sim``): its ten scenarios that
    run a device planner (``workload.SIM_DEVICE_SCENARIOS``: pipelined
    commit under a leader crash, the fused differential, the streaming
    churn, leader crashes and partitions mid-commit at depths 2 and 1, the
    preemption storm, the tenant storm and the gang deadlock; every new
    leader builds its planner mid-run) at seed ``SIM_SEED`` through
    ``run_scenario(..., device="cuda")`` and again with ``device="cpu"``:
    no violation, equal trace hashes, events, stats, violations and
    journey ledgers, equal span traces but for ``plan.compile``, kernels
    launched on the card (K9 by the storm, K8 by the gang deadlock, K7 by
    the churn), the off-card counters moved as on the CPU (the fused
    differential trips its breakers on purpose) and no device error, and
    the card's memory after the phase no higher than before it but for
    the kernels' workspaces of first use.

The native plane is on for the whole run (it is built first, and the
script fails without it); ``swarm_native_commit_fallbacks`` must stay 0.
The small-group router is off by default, so every phase but the
router's own trickle puts every supported group on the card, and fails
if a group went to the host path (``groups_small_to_host``,
``groups_breaker_to_host``, ``groups_device_error``, ``groups_fallback``).
Phases 22-29 run last.  Over the whole run, the breaker's own phase
and the simulator's (which holds them to its CPU twin's) aside, no
counter of
``ops.planner.DEVICE_FAULT_COUNTERS`` (a device error or an open breaker
on any route: groups, gang verdicts, victim picks) may move.

The counts of kernel launches are set to 0 just before each main path and
read just after it; the kernels' JSON line reports K1 from the headline
path, K1F, the scored K1F and K2-K6 from the many-service path (one K1F
launch a group slot, one K4 carry update a chunk, no standalone K1 and
no K6 there: K6, the port of the public ``strategy_score``, reports 0),
K7 from the churn path, K8 from the gang path, K9 from the storm, and
K10, K11 and K2 over the shard table from the mesh many-service path.
K8 has two rows: ``gang_fit`` at node bucket 16,384 (G = 1, the quota
column), the shape earlier slices reported, and ``gang_fit@nb1024`` at
the gang fleet's bucket.  The last lines are that JSON
line, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  The full record also goes to ``chiprun_out/chip_smoke.json``.
"""

import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM 32-bit rate outside tensor cores
REPS = 50
#: shards of the mesh phases, all on the one card
MESH_SHARDS = 4
#: the planner's routes to the host path: none may take a group on a phase
#: that runs with the small-group router off
HOST_ROUTES = ("groups_device_error", "groups_breaker_to_host",
               "groups_small_to_host", "groups_fallback")
#: phase 20's config-7 cell: its ten services at a fifth of config 7's
#: tasks, so the two builds and block fan-outs leave the run room for
#: phases 22-23
NATIVE_CFG7_TASKS = 100_000
#: the router's trickle: windows, seed and mean arrivals a service a window
TRICKLE_WINDOWS = 12
TRICKLE_SEED = 3
TRICKLE_LAM = 3.0
#: host-only ticks and launch-overhead measurements the router's inputs
#: take the median of
HOST_COST_RUNS = 3
OVERHEAD_RUNS = 5
#: integer operations a row of K5 and K11 needs: the binpack key (6), its
#: histogram bin and sum (3), the placement (3)
PACK_OPS = 12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(torch, fn, reps=REPS, warmup=5):
    """Mean milliseconds per call from CUDA events over ``reps`` warm
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(evt):
    """An event's own device time in microseconds, counted only on the
    device's rows (kernels, copies, fills): a CPU op such as aten::copy_
    carries its kernels' time again.  The attribute's name changed across
    torch versions."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


#: throwaway kernels launched at the start of each profiled session: once
#: a process has run a traced tick, torch.profiler loses the first rows of
#: later sessions, usually 8-16, whatever idle time precedes them, and
#: once at least 104 (PERF.md, open questions); these absorb the loss.
#: Their rows are kept out of every sum.
PROFILE_WARM = 512
#: sessions :func:`device_ms_each` makes before a measured launch without
#: its device row fails the phase
PROFILE_TRIES = 3
#: ... and, when the profiler returned no device row at all in a session
#: (not one of the warm-up's), the sessions it makes in all, waiting
#: PROFILE_DEAD_WAIT_S before each new one
PROFILE_TRIES_DEAD = 6
PROFILE_DEAD_WAIT_S = 2.0
#: what each profiled session saw: its kernel rows against the launches it
#: made, the warm-up rows that came back, the launches without a row, and
#: the device clock's offset
PROFILE_LOG = []
#: seconds a phase of this run took
PHASE_S = {}


def profiled(torch, body):
    """Run ``body`` in one torch.profiler session that starts with
    PROFILE_WARM throwaway kernels, and return the device rows of
    ``body`` alone as (name, microseconds) pairs, with the session's
    record: ``warm``, how many warm-up launches came back as kernel rows;
    ``missing``, how many kernel launch calls of ``body`` show no device
    row; ``skew``, the least (kernel start - its launch call's start) in
    ms, a few microseconds when the device and host clocks agree.

    The rows come from the profile's raw events, where each device row
    carries its launch call's correlation id, so the warm-up's rows are
    told apart from those of ``body``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARM):
            warm.add_(1)
        torch.cuda.synchronize()
        body()
        torch.cuda.synchronize()
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        fail("this torch's profiler exposes no raw events: the warm-up's "
             "rows cannot be kept out of the device sums")
    launches = sorted((e for e in events
                       if e.device_type() != DeviceType.CUDA
                       and "Launch" in e.name()),
                      key=lambda e: e.start_ns())
    check(len(launches) >= PROFILE_WARM,
          f"the profiler recorded {len(launches)} launch calls, fewer than "
          f"the {PROFILE_WARM} of its warm-up")
    warm_ids = {e.correlation_id() for e in launches[:PROFILE_WARM]}
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    kern = {e.correlation_id(): e for e in device}
    skews = [(kern[e.correlation_id()].start_ns() - e.start_ns()) / 1e6
             for e in launches if e.correlation_id() in kern]
    rows = [(e.name(), e.duration_ns() / 1e3) for e in device
            if e.correlation_id() not in warm_ids]
    session = dict(
        warm=sum(e.correlation_id() in kern
                 for e in launches[:PROFILE_WARM]),
        missing=sum(e.correlation_id() not in kern
                    for e in launches[PROFILE_WARM:]),
        skew=min(skews) if skews else None)
    return rows, session


def device_ms(torch, fn, symbols, reps=20, label=None, before_session=None):
    """Device time per call of the kernels whose names contain one of
    ``symbols``, from torch.profiler (see :func:`device_ms_each`)."""
    return device_ms_each(torch, fn, (symbols,), reps, label=label,
                          before_session=before_session)[0]


def device_ms_each(torch, fn, groups, reps=20, per_call=None, label=None,
                   before_session=None):
    """Device time per call for each group of kernel-name ``symbols`` in
    ``groups``, from one :func:`profiled` session of ``reps`` calls
    (``before_session()``, when given, runs before each session, outside
    it).

    Every launch of the ``reps`` calls must show its device row: a session
    that lost one is made again, up to PROFILE_TRIES in all
    (PROFILE_TRIES_DEAD after a session without a single device row), and
    then the phase fails.  A group of kernel names must show exactly
    ``per_call`` rows a call (default 1), so a lost row fails the phase
    instead of reading short.  A group of every device op (``("",)``) is
    not counted but must show some row."""
    fn()

    def body():
        for _ in range(reps):
            fn()

    attempt = 0
    while True:
        if before_session is not None:
            before_session()
        events, session = profiled(torch, body)
        attempt += 1
        session["attempt"] = attempt
        if session["missing"] == 0:
            break
        PROFILE_LOG.append(dict(label=label, session=session))
        dead = session["warm"] == 0
        if attempt >= (PROFILE_TRIES_DEAD if dead else PROFILE_TRIES):
            break
        if dead:
            time.sleep(PROFILE_DEAD_WAIT_S)
    check(session["missing"] == 0,
          f"device_ms ({label}): {session['missing']} kernel launches show "
          f"no device row in each of {attempt} sessions; {session}")
    seen = sorted({name[:80] for name, _ in events})
    out, rows = [], []
    for j, symbols in enumerate(groups):
        hit = [us for name, us in events
               if any(sym in name for sym in symbols)]
        want = None if symbols == ("",) else \
            (per_call[j] if per_call else 1) * reps
        rows.append(dict(symbols=list(symbols), rows=len(hit),
                         expected=want))
        check(sum(hit) > 0, f"device_ms ({label or symbols}): no device row "
              f"matches {symbols}; rows seen: {seen[:6]}; {session}")
        check(want is None or len(hit) == want,
              f"device_ms ({label or symbols}): {len(hit)} device rows match "
              f"{symbols}, {want} launched; rows seen: {seen[:6]}; "
              f"{session}")
        out.append(sum(hit) / reps / 1e3)
    PROFILE_LOG.append(dict(label=label, groups=rows, session=session))
    return out


def max_abs_err(torch, got, want):
    check(len(got) == len(want), "output count differs")
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} vs "
              f"{tuple(w.shape)}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_inputs(seed, nb=16384, n_valid=10000, n_leaves=20, n_top=0, cc=4,
                p=4, k=80000, near_2p24=True, quota=False, maxrep=0,
                port_limited=False, plat_wildcard=True):
    """Seeded inputs of one group's plan, as numpy (nodes, group, L, hier).

    The layout is the planner's densified one: ``n_valid`` real nodes
    padded to ``nb``, ``n_leaves`` spread branches (optionally under
    ``n_top`` upper branches), ``cc`` constraint slots and ``p`` platform
    rows.  With ``near_2p24`` a few branches carry service loads and
    capacities that straddle 2^24, where a float32 segment sum stops being
    exact (the capacity totals need a group size ``k`` near ``K_CLAMP``).
    ``maxrep``, ``port_limited`` and ``plat_wildcard=False`` (platform rows
    that name an os and an arch, behind an unused row) reach the filter
    columns that the headline group does not read.
    """
    import numpy as np
    from swarmkit_tpu_torch.ops.densify import l_bucket
    from swarmkit_tpu_torch.ops.kernel import (
        K_CLAMP, SVC_CLAMP, GroupInputs, NodeInputs)
    rng = np.random.RandomState(seed)
    valid = np.zeros(nb, bool)
    valid[:n_valid] = True
    idx = np.arange(nb)
    leaf = (idx % n_leaves).astype(np.int32)
    svc = rng.randint(0, 8, nb).astype(np.int32)
    res_cap = rng.randint(0, 640, nb).astype(np.int32)
    ready = rng.rand(nb) < 0.97
    res_ok = rng.rand(nb) < 0.97
    extra_mask = rng.rand(nb) < 0.99
    con_hash = np.zeros((cc, 2, nb), np.int32)
    con_hash[0] = rng.randint(0, 4, (2, nb))
    if cc > 2:
        con_hash[2] = (rng.rand(2, nb) < 0.1).astype(np.int32)
    if near_2p24:
        # branch loads: branch 0 holds ~2^24 - 2^20 tasks of the service,
        # branch 1 ~2^24 + 2^20 (clamped to LOAD_CLAMP).  Branch
        # capacities (with k near K_CLAMP): branch 2 holds four nodes of
        # K_CLAMP capacity (just above 2^24 in all), branch 3 three (below)
        branch = [np.nonzero(leaf[:n_valid] == b)[0] for b in range(4)]
        svc[branch[0][:15]] = SVC_CLAMP
        svc[branch[1][:17]] = SVC_CLAMP
        big = np.concatenate([branch[2][:4], branch[3][:3]])
        res_cap[big] = K_CLAMP
        ready[big] = res_ok[big] = extra_mask[big] = True
        con_hash[:, :, big] = 0
    nodes = NodeInputs(
        valid=valid,
        ready=ready,
        res_ok=res_ok,
        res_cap=res_cap,
        svc_tasks=svc,
        total_tasks=rng.randint(0, 2000, nb).astype(np.int32),
        failures=rng.choice([0, 0, 0, 0, 1, 5, 9, 80], nb).astype(np.int32),
        leaf=leaf,
        os_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        arch_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        port_conflict=rng.rand(nb) < 0.05,
        extra_mask=extra_mask,
        quota_ok=(rng.rand(nb) < 0.9) if quota else None)
    con_op = np.full(cc, 2, np.int32)
    con_op[0] = 1                       # one != constraint
    if cc > 2:
        con_op[2] = 0                   # one == constraint, after a gap
    con_exp = np.zeros((cc, 2), np.int32)
    con_exp[0] = (1, 1)
    plat = np.full((p, 4), -1, np.int32)
    if plat_wildcard:
        plat[0] = (0, 0, 0, 0)          # any platform
        if p > 1:
            plat[1] = (1, 1, 0, 0)
    else:
        plat[-1] = (1, 1, 0, 0)         # os 1, any arch
        if p > 2:
            plat[1] = (0, 1, 1, 0)      # os (0, 1) on arch (1, 0)
    group = GroupInputs(
        k=np.int32(min(k, K_CLAMP)), con_hash=con_hash, con_op=con_op,
        con_exp=con_exp, plat=plat, maxrep=np.int32(maxrep),
        port_limited=np.bool_(port_limited))
    L = l_bucket(n_leaves)
    hier = ()
    if n_top:
        top = (leaf % n_top).astype(np.int32)
        leaf_parent = np.zeros(L, np.int32)
        leaf_parent[:n_leaves] = np.arange(n_leaves) % n_top
        hier = (((top, np.zeros(l_bucket(n_top), np.int32)),), leaf_parent)
    return nodes, group, L, hier


WATERFILL_MODES = ("stage_a", "stage_a_open", "stage_b")


def waterfill_inputs(seed, n, L, mode="stage_b"):
    """Seeded numpy keyword inputs of one K3 call over ``n`` elements and
    ``L`` segments.  ``stage_b``: the level is the spread score of
    (svc_tasks, failures) and the key (clip(total) << 20) | index, no
    spill epilogue (a spread plan's node fill).  ``stage_a``: a given
    level ``e``, the index key, and the spill epilogue on ``raw_cap`` (a
    branch fill; ``stage_a_open``: the same with no element able to
    saturate, so the epilogue finds no spill).  Element i lies in segment
    i % L when L <= n, else in a seeded draw from [0, L) (most segments
    empty); segments ask for up to 1.1x what they hold, some for K_CLAMP;
    three elements of K_CLAMP capacity take their segments' totals past
    2^24; ``raw_cap`` equals the capacity on about half of the elements,
    so some saturate.  Returns (kwargs, k_seg)."""
    import numpy as np
    from swarmkit_tpu_torch.ops.kernel import K_CLAMP
    rng = np.random.RandomState(seed)
    seg = (np.arange(n) % L) if L <= n else rng.randint(0, L, n)
    cap = rng.randint(0, 7, n).astype(np.int32)
    cap[rng.choice(n, 3, replace=False)] = K_CLAMP
    held = np.bincount(seg, weights=cap.astype(np.float64), minlength=L)
    k_seg = np.minimum(held * rng.uniform(0, 1.1, L), K_CLAMP)
    k_seg[rng.rand(L) < 0.05] = K_CLAMP
    kw = dict(cap=cap, seg=seg.astype(np.int32))
    if mode == "stage_b":
        kw.update(svc_tasks=rng.randint(0, 8, n).astype(np.int32),
                  failures=rng.choice([0] * 6 + [1, 5, 80], n).astype(
                      np.int32),
                  total=rng.randint(0, 2000, n).astype(np.int32))
    else:
        above = rng.choice([0, 1, 5], n, p=[0.5, 0.3, 0.2])
        if mode == "stage_a_open":
            above[:] = K_CLAMP
        kw.update(e=rng.randint(0, 3000, n).astype(np.int32),
                  raw_cap=cap.astype(np.int64) + above,
                  spill=np.zeros(1, np.int32))
    return kw, k_seg.astype(np.int32)


def waterfill_call(torch, K, kw, k_seg, L, device, plain=False):
    """K3 (or, with ``plain``, its plain version on the same tensors) on
    :func:`waterfill_inputs`' arrays moved to ``device``; returns (x,
    spill or None)."""
    t = {name: torch.from_numpy(a).to(device) for name, a in kw.items()}
    k = torch.from_numpy(k_seg).to(device)
    n = t["cap"].shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=device)
    if not plain:
        K._waterfill(k_seg=k, L=L, out=out, **t)
        return out, t.get("spill")
    e = t["e"] if "e" in t else K._spread_score(t["svc_tasks"],
                                                t["failures"])
    tie = K._tie_keys(t.get("total"), n, out.device)
    x = K._waterfill_plain(e, t["cap"], tie, k, t["seg"], L)
    spill = None
    if "raw_cap" in t:
        spill = t["spill"] | K._level_spill(x, t["raw_cap"]).to(torch.int32)
    return x, spill


def fused_inputs(seed, nb=16384, n_valid=10000, strategies=(0, 1, 2, 3),
                 n_slots=16, n_leaves=20, quota=False):
    """Seeded inputs of one fused chunk, as numpy (shared, groups, carry,
    strat, L) in the planner's layout: a cfg7 chunk of group slots (one per
    entry of ``strategies``, padded to a power of two) over ``n_slots``
    service slots, spread groups over ``n_leaves`` racks, tasks of 0.1 CPU
    + 64 MiB on nodes of 64 CPUs / 256 GiB that already run some work.  A
    few nodes hold exactly one task's worth of a resource, one unit short
    of it, nothing, or less than nothing; two slots share a service."""
    import numpy as np
    from swarmkit_tpu_torch.ops.densify import l_bucket, pow2_bucket
    from swarmkit_tpu_torch.ops.kernel import (
        FusedCarry, FusedGroups, FusedShared, FusedStrategy)
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    rng = np.random.RandomState(seed)
    n_real = len(strategies)
    G = pow2_bucket(n_real)
    valid = np.zeros(nb, bool)
    valid[:n_valid] = True
    cpu_unit, mem_unit = 10**8, 64 << 20
    cpu = (64 * 10**9 - rng.randint(0, 600, nb) * cpu_unit).astype(np.int64)
    mem = ((256 << 30) - rng.randint(0, 600, nb) * mem_unit).astype(np.int64)
    cpu[:50] = cpu_unit
    cpu[50:60] = cpu_unit - 1
    cpu[60:70] = 0
    cpu[70:80] = -7
    mem[80:100] = 2 * mem_unit + 3
    shared = FusedShared(
        valid=valid, ready=rng.rand(nb) < 0.98,
        os_hash=np.zeros((2, nb), np.int32),
        arch_hash=np.zeros((2, nb), np.int32),
        svc0=rng.randint(0, 4, (n_slots, nb)).astype(np.int32))
    carry = FusedCarry(
        total=rng.randint(0, 600, nb).astype(np.int32), cpu=cpu, mem=mem,
        svc_acc=np.zeros((n_slots, nb), np.int32))
    k = np.zeros(G, np.int32)
    k[:n_real] = 50000
    slot = np.zeros(G, np.int32)
    slot[:n_real] = np.arange(n_real) % max(n_real - 1, 1)  # 0 twice
    cpu_d = np.zeros(G, np.int64)
    mem_d = np.zeros(G, np.int64)
    cpu_d[:n_real] = cpu_unit
    mem_d[:n_real] = mem_unit
    plat = np.full((G, 1, 4), -1, np.int32)
    leaf = np.zeros((G, nb), np.int32)
    for g, sid in enumerate(strategies):
        if sid == strategy_mod.STRAT_SPREAD:
            leaf[g] = np.arange(nb) % n_leaves
    failures = rng.choice([0] * 12 + [1, 5, 70], (G, nb)).astype(np.int32)
    quota_ok = None
    if quota:
        quota_ok = np.ones((G, nb), bool)
        quota_ok[n_real - 1] = False
    groups = FusedGroups(
        k=k, slot=slot, maxrep=np.zeros(G, np.int32), cpu_d=cpu_d,
        mem_d=mem_d, con_hash=np.zeros((G, 1, 2, nb), np.int32),
        con_op=np.full((G, 1), 2, np.int32),
        con_exp=np.zeros((G, 1, 2), np.int32), plat=plat,
        failures=failures, leaf=leaf, extra_mask=np.ones((G, nb), bool),
        quota_ok=quota_ok)
    sid = np.zeros(G, np.int32)
    sid[:n_real] = strategies
    weights = np.zeros((G, 4), np.int32)
    weights[:] = (2, 3, 1, 1)
    w1, b1, w2, b2 = strategy_mod.learned_params()
    strat = FusedStrategy(sid=sid, weights=weights, w1=w1, b1=b1, w2=w2,
                          b2=np.asarray(b2, np.int32))
    L = l_bucket(n_leaves) if strategy_mod.STRAT_SPREAD in strategies else 1
    return shared, groups, carry, strat, L


#: the slot-entry (K1F) cases: the first slot of a chunk, a carried
#: placement, a slot repeating the previous slot's service, a padding slot
#: (k = 0), slots above [0, S) and below it (the previous slot's scatter
#: dropped), nodes pushed short of the demand, a zero cpu or memory demand
#: or none, and a carry with negative availability
FUSED_ENTRY_CASES = ("first_slot", "carried_x", "repeat_service",
                     "padding_slot", "slot_above", "slot_negative",
                     "short_of_demand", "zero_cpu_demand", "zero_mem_demand",
                     "no_demand", "negative_carry")


def fused_entry_inputs(seed, case, nb=1024, n_valid=None):
    """Seeded inputs of one slot entry, as numpy (shared, groups, carry, g,
    x_prev) in the planner's layout: four group slots over six service
    slots with constraints (== and !=), platform rows (the wildcard, an os,
    an os on an arch), max-replicas and quota rows; available resources
    at, just under and far under one task's demand, zero and negative;
    ``g`` the slot to enter and ``x_prev`` slot g - 1's placements (None
    for the first slot).  ``case`` is one of FUSED_ENTRY_CASES."""
    import numpy as np
    from swarmkit_tpu_torch.ops.kernel import (
        FusedCarry, FusedGroups, FusedShared)
    rng = np.random.RandomState(seed)
    G, S, cc, P = 4, 6, 4, 4
    n_valid = nb - nb // 40 if n_valid is None else n_valid
    valid = np.zeros(nb, bool)
    valid[:n_valid] = True
    cpu_unit, mem_unit = 10**8, 64 << 20
    cpu = (rng.randint(-3, 40, nb) * cpu_unit
           + rng.choice([0, 0, 1, -1, 7], nb)).astype(np.int64)
    mem = (rng.randint(-2, 60, nb) * mem_unit
           + rng.choice([0, 3, -5], nb)).astype(np.int64)
    cpu[:16] = cpu_unit
    cpu[16:32] = cpu_unit - 1
    cpu[32:40] = 0
    cpu[40:48] = -7
    mem[48:64] = mem_unit
    mem[64:72] = mem_unit - 1
    shared = FusedShared(
        valid=valid, ready=rng.rand(nb) < 0.95,
        os_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        arch_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        svc0=rng.randint(0, 6, (S, nb)).astype(np.int32))
    carry = FusedCarry(
        total=rng.randint(0, 600, nb).astype(np.int32), cpu=cpu, mem=mem,
        svc_acc=rng.randint(0, 3, (S, nb)).astype(np.int32))
    k = rng.randint(100, 5000, G).astype(np.int32)
    slot = np.array([0, 1, 2, 3], np.int32)
    maxrep = np.array([0, 4, 0, 6], np.int32)
    cpu_d = np.full(G, cpu_unit, np.int64)
    mem_d = np.full(G, mem_unit, np.int64)
    con_op = np.array([[1, 2, 0, 2], [2, 2, 2, 2], [0, 1, 2, 2],
                       [2, 0, 2, 2]], np.int32)
    plat = np.full((G, P, 4), -1, np.int32)
    plat[0, 1] = (0, 0, 0, 0)            # any platform
    plat[1, 0] = (1, 1, 0, 0)            # os (1, 1), any arch
    plat[2, 2] = (0, 1, 1, 0)            # os (0, 1) on arch (1, 0)
    plat[2, 3] = (1, 1, 0, 0)
    quota_ok = rng.rand(G, nb) < 0.9
    quota_ok[3] = True
    g = 2
    x_prev = (rng.randint(0, 4, nb) * (rng.rand(nb) < 0.5)
              * valid).astype(np.int32)
    if case == "first_slot":
        g, x_prev = 0, None
    elif case == "repeat_service":
        slot[g] = slot[g - 1]
    elif case == "padding_slot":
        k[g] = 0
    elif case == "slot_above":
        slot[g], slot[g - 1] = S + 2, S + 1
    elif case == "slot_negative":
        slot[g], slot[g - 1] = -1, -S - 2
    elif case == "short_of_demand":
        # many nodes one or two tasks above the demand, then placed on
        cpu[: nb // 2] = rng.randint(0, 3, nb // 2) * cpu_unit \
            + rng.choice([0, -1, 1], nb // 2)
        x_prev[: nb // 2] = rng.randint(0, 3, nb // 2)
    elif case == "zero_cpu_demand":
        cpu_d[g] = cpu_d[g - 1] = 0
    elif case == "zero_mem_demand":
        mem_d[g] = 0
    elif case == "no_demand":
        cpu_d[g] = mem_d[g] = 0
    elif case == "negative_carry":
        cpu[::3] = -rng.randint(1, 10**10, len(cpu[::3]))
        mem[1::3] = -rng.randint(1, 1 << 34, len(mem[1::3]))
    elif case != "carried_x":
        raise ValueError(f"unknown slot-entry case {case!r}")
    groups = FusedGroups(
        k=k, slot=slot, maxrep=maxrep, cpu_d=cpu_d, mem_d=mem_d,
        con_hash=rng.randint(0, 3, (G, cc, 2, nb)).astype(np.int32),
        con_op=con_op,
        con_exp=rng.randint(0, 3, (G, cc, 2)).astype(np.int32), plat=plat,
        failures=rng.choice([0] * 12 + [1, 5, 70], (G, nb)).astype(np.int32),
        leaf=np.zeros((G, nb), np.int32),
        extra_mask=rng.rand(G, nb) < 0.97, quota_ok=quota_ok)
    return shared, groups, carry, g, x_prev


def scatter_inputs(seed, nb=16384, d=200, db=256):
    """Seeded numpy (five resident columns [nb], a packed scatter buffer
    of ``db`` slots: ``d`` unique rows, then pad slots at index nb)."""
    import numpy as np
    from swarmkit_tpu_torch.ops.kernel import pack_scatter
    rng = np.random.RandomState(seed)
    cols = (rng.rand(nb) < 0.95, rng.rand(nb) < 0.9,
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(0, 2000, nb).astype(np.int32))
    idx = np.full(db, nb, np.int32)
    idx[:d] = rng.choice(nb, d, replace=False)
    upd = (rng.rand(db) < 0.5, rng.rand(db) < 0.5,
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(0, 2**31 - 1, db).astype(np.int32))
    return cols, pack_scatter(idx, *upd)


def split_columns(cols, shards, device):
    """Numpy resident columns as five tuples of ``shards`` per-shard
    tensors on ``device`` (copies): the mesh tier's layout."""
    import torch
    ln = cols[0].shape[0] // shards
    return tuple(tuple(torch.from_numpy(c[s * ln:(s + 1) * ln].copy())
                       .to(device) for s in range(shards)) for c in cols)


SHARD_FILL_CASES = {
    # K10 over L = 20 segments (one infeasible, one whose capacity sums
    # pass 2^24) and over one segment; K11 over one segment, with k near
    # K_CLAMP (sums past 2^24) and above the whole capacity
    "waterfill_L20": dict(L=20),
    "waterfill_L20_scored": dict(L=20, scored=True),
    "waterfill_L1": dict(L=1),
    "packfill": dict(L=1, pack=True),
    "packfill_short": dict(L=1, pack=True, big=False),
}


def shard_fill_inputs(seed, nb=16384, n_valid=16000, L=20, scored=False,
                      pack=False, big=True):
    """Seeded numpy columns (length nb) and k (int32 [L]) of one
    node-level fill over a node-axis split.  Rows next to every quarter
    border (and every eighth) carry equal levels, totals and binpack
    scores, so the global tie key decides between rows of different
    shards; five rows of K_CLAMP capacity (``big``) push the capacity
    sums past 2^24; with L > 1, segment 2 asks for more than its rows
    hold (its level stays at 2^30), and without ``big`` so does the one
    segment (every row takes its capacity)."""
    import numpy as np
    from swarmkit_tpu_torch.ops.kernel import K_CLAMP
    rng = np.random.RandomState(seed)
    idx = np.arange(nb)
    valid = idx < n_valid
    svc = rng.randint(0, 6, nb).astype(np.int32)
    failures = rng.choice([0] * 10 + [1, 5, 70], nb).astype(np.int32)
    total = rng.randint(0, 1500, nb).astype(np.int32)
    res_cap = rng.randint(0, 959, nb).astype(np.int32)
    cap = rng.randint(0, 6, nb).astype(np.int32)
    e = rng.randint(0, 3000, nb).astype(np.int32)
    leaf = (idx % L).astype(np.int32)
    for frac in range(1, 8):
        b = nb * frac // 8
        near = slice(b - 96, b + 96)
        svc[near], failures[near], total[near] = 2, 0, 700
        res_cap[near], e[near], cap[near] = 480, 1000, 3
    rows = np.nonzero(leaf == (1 % L))[0][3:8]
    if big:
        cap[rows] = K_CLAMP
        svc[rows] = 0
    cap[~valid] = 0
    k_seg = rng.randint(100, 4000, L).astype(np.int32)
    if L > 1:
        k_seg[1] = K_CLAMP
        k_seg[2] = K_CLAMP          # infeasible: its rows hold far less
        cap[(leaf == 2) & (cap > 5)] = 5
    else:
        k_seg[0] = K_CLAMP - 1 if big else K_CLAMP
    return dict(svc=svc, failures=failures, total=total, res_cap=res_cap,
                cap=cap, e=e if scored else None, leaf=leaf, k=k_seg,
                pack=pack)


def edge_fill_inputs(seed, n, L, scored=False):
    """:func:`shard_fill_inputs`' columns for the water-fill cases a split
    turns on, ``n`` rows (a multiple of 16): with L >= 3, segment 0's rows
    lie in the first sixteenth of the axis (inside shard 0 at any D <= 16)
    and segment 1's are every fifth row across all of it; rows on every
    sixteenth's border carry equal levels and totals, so the global tie
    key decides between shards; with L > 3 one segment asks for more than
    its rows hold.  Capacity sums stay below 2^24."""
    import numpy as np
    from swarmkit_tpu_torch.ops.kernel import K_CLAMP
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    leaf = rng.randint(0, L, n).astype(np.int32)
    if L >= 3:
        leaf[leaf <= 1] = 2
        first = idx < n // 16
        leaf[first & (idx % 3 == 0)] = 0
        leaf[idx % 5 == 1] = 1
    svc = rng.randint(0, 6, n).astype(np.int32)
    failures = rng.choice([0] * 10 + [1, 5, 70], n).astype(np.int32)
    total = rng.randint(0, 1500, n).astype(np.int32)
    cap = rng.randint(0, 7, n).astype(np.int32)
    e = rng.randint(0, 3000, n).astype(np.int32)
    for frac in range(1, 16):
        near = slice(n * frac // 16 - 8, n * frac // 16 + 8)
        svc[near], failures[near], total[near] = 2, 0, 700
        e[near], cap[near] = 1000, 3
    held = np.bincount(leaf, weights=cap, minlength=L).astype(np.int64)
    k = np.minimum(rng.randint(0, 4000, L), K_CLAMP).astype(np.int32)
    k[:2] = np.minimum(held[:2] * 3 // 4, K_CLAMP)
    if L > 3:
        k[3] = held[3] + 5          # more than its rows hold
    return dict(svc=svc, failures=failures, total=total,
                res_cap=np.zeros(n, np.int32), cap=cap,
                e=e if scored else None, leaf=leaf, k=k, pack=False)


#: K5's and K11's edge cases (:func:`pack_edge_inputs`)
PACK_EDGE_CASES = ("k1", "k_total", "k_over", "k0", "failure_band",
                   "one_bin", "cap0_band", "border", "half")


def pack_edge_inputs(seed, n, case):
    """Seeded numpy columns (length ``n``, a multiple of 16) and k
    (int32 [1]) of one binpack fill, for the cases its threshold select
    turns on: k = 1, the whole capacity, 9 past it, 0; every row in the
    failure band; every row in one score bin; rows of capacity 0 inside
    the threshold's score bin, next to it; the threshold row the first
    row of the second half (a shard border at D = 2, 4, 8 and 16); and
    half the capacity over random scores (past 2^20 rows the index runs
    into the score bits and keys repeat)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    res_cap = rng.randint(0, 1200, n).astype(np.int32)
    failures = rng.choice([0] * 10 + [1, 5, 70], n).astype(np.int32)
    cap = rng.randint(0, 7, n).astype(np.int32)
    if case == "failure_band":
        failures = rng.randint(5, 80, n).astype(np.int32)
    elif case == "one_bin":
        res_cap[:], failures[:] = 480, 0
    elif case == "cap0_band":
        res_cap = rng.choice([100, 480, 700], n).astype(np.int32)
        failures[:] = 0
        band = np.nonzero(res_cap == 480)[0]
        cap[band[::2]] = 0
        cap[band[1::2]] = 3
    elif case == "border":
        res_cap[:], failures[:], cap[:] = 200, 0, 2
    total = int(cap.astype(np.int64).sum())
    if case == "cap0_band":
        # the threshold lands on the middle row of capacity 3 in the band
        below = int(cap[res_cap < 480].astype(np.int64).sum())
        k = below + 3 * (len(band[1::2]) // 2) + 2
    else:
        k = {"k1": 1, "k_total": total, "k_over": total + 9, "k0": 0,
             "border": 2 * (n // 2) + 1}.get(case, total // 2)
    return dict(cap=cap, failures=failures, res_cap=res_cap, e=None,
                k=np.array([k], np.int32), pack=True)


def fill_parts(arrs, d, device):
    """Split :func:`shard_fill_inputs`' columns into ``d`` FillShards on
    ``device`` (fresh zeroed outputs)."""
    import numpy as np
    import torch
    from swarmkit_tpu_torch.ops.kernel import FillShard
    nb = arrs["cap"].shape[0]
    ln = nb // d

    def t(a, s):
        return torch.from_numpy(np.ascontiguousarray(
            a[s * ln:(s + 1) * ln])).to(device)

    parts = []
    for s in range(d):
        k = torch.from_numpy(arrs["k"]).to(device)
        common = dict(cap=t(arrs["cap"], s), k=k, offset=s * ln,
                      out=torch.zeros(ln, dtype=torch.int32, device=device),
                      failures=t(arrs["failures"], s))
        if arrs["pack"]:
            parts.append(FillShard(res_cap=t(arrs["res_cap"], s), **common))
        elif arrs["e"] is not None:
            parts.append(FillShard(e=t(arrs["e"], s),
                                   total=t(arrs["total"], s),
                                   seg=t(arrs["leaf"], s), **common))
        else:
            parts.append(FillShard(svc_tasks=t(arrs["svc"], s),
                                   total=t(arrs["total"], s),
                                   seg=t(arrs["leaf"], s), **common))
    return parts


def headline_fill_parts(d, device, seed=2024, nb=16384, n_valid=10000,
                        n_leaves=20):
    """K10's inputs as the mesh headline path hands them over: the
    leaf-level fill of one headline group (:func:`plan_inputs`, 80,000
    tasks over ``n_leaves`` racks, L = l_bucket(20) = 256 segments) split
    into ``d`` shards on ``device``, with the capacities of K1's plain
    version and the branch allocation of stage A's plain versions, and
    fresh zeroed outputs.  Returns (parts, L)."""
    import torch
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.parallel import sharded as S
    nodes, group, L, hier = plan_inputs(seed, nb=nb, n_valid=n_valid,
                                        n_leaves=n_leaves, near_2p24=False)
    shards = S.shard_group(nodes, group, hier, S.make_mesh([device] * d))
    caps = [K._feasibility_plain(nd, gd)[1] for nd, gd, _ in shards]
    total = K.sum_shards([
        K._seg_partial_plain(nd.svc_tasks, nd.valid, cap, nd.leaf, L)
        for (nd, _g, _h), cap in zip(shards, caps)])
    load, bcap, _raw, kk = K._seg_clamp(total[0], total[1], shards[0][1].k)
    i32 = torch.int32
    k_branch = K._waterfill_plain(
        load, bcap, torch.arange(L, dtype=i32, device=load.device), kk,
        torch.zeros(L, dtype=i32, device=load.device), 1)
    ln = shards[0][0].valid.shape[0]
    return [K.FillShard(svc_tasks=nd.svc_tasks, failures=nd.failures,
                        total=nd.total_tasks, cap=cap, k=k_branch,
                        seg=nd.leaf, offset=s * ln,
                        out=torch.zeros(ln, dtype=i32, device=cap.device))
            for s, ((nd, _g, _h), cap) in enumerate(zip(shards, caps))], L


GANG_VARIANTS = (dict(), dict(maxrep=5), dict(port_limited=True),
                 dict(plat_wildcard=False))


def gang_rows(seed, g_count, nb=16384, n_valid=10000, quota=False):
    """Seeded numpy (NodeInputs, GroupInputs) of ``g_count`` gangs at the
    headline shapes (4 constraint slots, 4 platform rows), the filter
    variants in turn.  Gang g asks for its capacity total minus one, the
    total, or the total plus one (g % 3); of several gangs the last (no
    variant) holds nodes of K_CLAMP capacity, a total above 2^24, and asks
    K_CLAMP."""
    import numpy as np
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.ops.convert import gang_to_device
    rows = []
    for g in range(g_count):
        near = g_count > 1 and g == g_count - 1
        nodes, group, _, _ = plan_inputs(
            seed + g, nb=nb, n_valid=n_valid, n_leaves=20, k=K.K_CLAMP,
            near_2p24=near, quota=quota,
            **({} if near else GANG_VARIANTS[g % len(GANG_VARIANTS)]))
        if not near:
            # per-node capacities stay below k here, so k moves only the
            # verdict, not the capacities
            total = int(K.unpack_gang(K.gang_fit_packed(
                *gang_to_device([(nodes, group)], "cpu")), 1)[2][0])
            group = group._replace(k=np.int32(max(total + g % 3 - 1, 0)))
        rows.append((nodes, group))
    return rows


def gang_bytes(rows):
    """The bytes K8 must move: per gang, the node columns its filters
    read (K1's count without K1's capacity and mask writes and fail
    counts; never total_tasks, failures or leaf, which the packed stage
    leaves out), plus each gang's 44-byte result row."""
    n = rows[0][0].valid.shape[0]
    return sum(feasibility_bytes(nodes, group) - 5 * n - 32 + 44
               for nodes, group in rows)


def gang_ops(rows):
    """K8's integer operations: per node of each gang, the filters and
    capacity (9), three per active constraint slot, six per used platform
    row."""
    return sum(nodes.valid.shape[0] * (9 + 3 * int(
        ((grp.con_op == 0) | (grp.con_op == 1)).sum()) + 6 * int(
        (grp.plat[:, 0] != -1).sum())) for nodes, grp in rows)


VICTIM_CASES = ("full", "budget_stop", "infeasible_stop")


def victim_inputs(seed, v, case="full", n=10000, picks=512):
    """A seeded ``CandidateSet`` of ``n`` nodes and ``v`` victim slots and
    the call's (cpu_d, mem_d, gen_d, n_picks, budget), as numpy.  Free
    pools run from -4 to 3 CPUs (so nearly every pick evicts), victims
    carry cpu, memory and one generic kind, slots are sorted by priority
    with dead ones among them.  ``budget_stop`` gives a budget that runs
    out mid-run; ``infeasible_stop`` leaves 8 eligible nodes, whose victims
    run out before the picks do."""
    import numpy as np
    from swarmkit_tpu_torch.scheduler.preempt import CandidateSet
    rng = np.random.RandomState(seed)
    cpu, gib = 10**9, 1 << 30
    ok = rng.rand(n) < 0.95
    if case == "infeasible_stop":
        ok &= np.arange(n) % (n // 8) == 0
    vvalid = rng.rand(v, n) < 0.8
    cand = CandidateSet(
        infos=None, ok=ok,
        free_cpu=rng.randint(-4, 4, n).astype(np.int64) * cpu,
        free_mem=rng.randint(-2, 16, n).astype(np.int64) * gib,
        vvalid=vvalid,
        vprio=np.sort(rng.randint(0, 10, (v, n)), axis=0).astype(np.int32),
        vcpu=rng.randint(0, 5, (v, n)).astype(np.int64) * cpu,
        vmem=rng.randint(0, 9, (v, n)).astype(np.int64) * gib,
        victims=None, vb=v, n_candidates=int(vvalid.sum()),
        free_gen=rng.randint(0, 3, n).astype(np.int64),
        vgen=rng.randint(0, 2, (v, n)).astype(np.int64))
    budget = 400 if case == "budget_stop" else 1 << 20
    return cand, (4 * cpu, 8 * gib, 1, picks, budget)


VICTIM_EDGE_CASES = ("equal_keys", "repick", "budget_stop_v64",
                     "infeasible_stop_v64", "negative_free")


def victim_edge_inputs(case, n=600, picks=16):
    """A ``CandidateSet`` of ``n`` nodes for one of the cases a pick order
    turns on, and the call's (cpu_d, mem_d, gen_d, n_picks, budget):

    * ``equal_keys`` (V = 4): every node alike, two 1-CPU victims for a
      2-CPU pick, so the node index decides each pick, and each chosen
      node is infeasible after its pick;
    * ``repick`` (V = 16): node 3 frees 3 CPUs for a 1-CPU pick, then
      rides its surplus twice at no cost; node 5's cheap victims are then
      taken one pick at a time (its prefix length grows past used slots);
    * ``budget_stop_v64`` (V = 64): two victims a pick against a budget
      of five, the third pick stops the run;
    * ``infeasible_stop_v64`` (V = 64): three eligible nodes with four
      live victims each among dead slots, two picks each, then an
      infeasible stop;
    * ``negative_free`` (V = 16): cpu, memory and generic free pools
      below zero everywhere."""
    import numpy as np
    from swarmkit_tpu_torch.scheduler.preempt import CandidateSet
    rng = np.random.RandomState(sum(map(ord, case)))
    cpu, gib = 10**9, 1 << 30
    v = {"equal_keys": 4, "repick": 16, "negative_free": 16}.get(case, 64)
    ok = np.ones(n, bool)
    free_cpu = np.zeros(n, np.int64)
    free_mem = np.full(n, 64 * gib, np.int64)
    free_gen = np.zeros(n, np.int64)
    vvalid = np.ones((v, n), bool)
    vprio = np.zeros((v, n), np.int32)
    vcpu = np.full((v, n), cpu, np.int64)
    vmem = np.zeros((v, n), np.int64)
    vgen = np.zeros((v, n), np.int64)
    demand = (2 * cpu, 0, 0)
    budget = 1 << 20
    if case == "equal_keys":
        vvalid[2:] = False
    elif case == "repick":
        demand = (cpu, 0, 0)
        vprio[:] = 5
        vprio[:, 5] = 0
        vvalid[1:, 3] = False
        vcpu[0, 3] = 3 * cpu
        vprio[0, 3] = 0
    elif case == "budget_stop_v64":
        budget = 5
        vprio[:] = rng.randint(0, 3, (v, n))
    elif case == "infeasible_stop_v64":
        ok[:] = False
        ok[[17, 300 % n, n - 1]] = True
        vvalid[:] = False
        vvalid[[5, 20, 40, 63]] = True
        vcpu[:] = 2 * cpu
        demand = (4 * cpu, 0, 0)
    elif case == "negative_free":
        free_cpu = rng.randint(-3, 0, n).astype(np.int64) * cpu
        free_mem = rng.randint(-4, 0, n).astype(np.int64) * gib
        free_gen = rng.randint(-2, 0, n).astype(np.int64)
        vvalid = rng.rand(v, n) < 0.7
        vprio = np.sort(rng.randint(0, 8, (v, n)), axis=0).astype(np.int32)
        vcpu = rng.randint(0, 3, (v, n)).astype(np.int64) * cpu
        vmem = rng.randint(0, 3, (v, n)).astype(np.int64) * gib
        vgen = rng.randint(0, 2, (v, n)).astype(np.int64)
        demand = (cpu, gib, 1)
    else:
        raise ValueError(f"unknown case {case}")
    cand = CandidateSet(
        infos=None, ok=ok, free_cpu=free_cpu, free_mem=free_mem,
        vvalid=vvalid, vprio=vprio, vcpu=vcpu, vmem=vmem, victims=None,
        vb=v, n_candidates=int(vvalid.sum()), free_gen=free_gen, vgen=vgen)
    return cand, demand + (picks, budget)


def victim_need(cand, args, picked, nb, pb):
    """(bytes, operations) that K9's function must spend on these inputs,
    given the run's ``picked`` [(node, m)].  Bytes: ``ok`` of each of the
    ``nb`` padded nodes; the three free pools of each node whose ``ok``
    holds; of those nodes' victim slots, each one before the first prefix
    that fits (all V where none fits) or before the longest prefix a pick
    took there: its ``vvalid`` byte and, where valid, its 28 bytes of cpu,
    memory, generic units and priority; and the 8 PB bytes of picks
    written.  Operations: five sums and a compare per valid slot read, and
    one compare per eligible node per pick made."""
    import numpy as np
    ok, vvalid = np.asarray(cand.ok), np.asarray(cand.vvalid)
    v, n = vvalid.shape
    fits = np.ones((v + 1, n), bool)
    for free, col, d in ((cand.free_cpu, cand.vcpu, args[0]),
                         (cand.free_mem, cand.vmem, args[1]),
                         (cand.free_gen, cand.vgen, args[2])):
        cum = np.cumsum(np.where(vvalid, col, 0), axis=0)
        fits &= free + np.concatenate([np.zeros((1, n), np.int64), cum]) >= d
    reach = np.where(fits.any(axis=0), fits.argmax(axis=0), v)
    for j, m in picked:
        reach[j] = max(reach[j], m)
    read = (np.arange(v)[:, None] < reach) & ok
    n_live = int((read & vvalid).sum())
    n_ok = int(ok.sum())
    nbytes = nb + 24 * n_ok + int(read.sum()) + 28 * n_live + 8 * pb
    return nbytes, 6 * n_live + len(picked) * n_ok


def phase_build(cuda):
    t0 = time.perf_counter()
    res = cuda.build()
    cuda.library()
    print(f"build: {res.seconds:.2f} s nvcc ({time.perf_counter() - t0:.2f}"
          f" s with load) -> {os.path.relpath(res.path)}", flush=True)
    for line in res.ptxas.splitlines():
        if line.startswith("==") or "Used" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    return res


def feasibility_bytes(nodes, group):
    """The bytes K1's function must move on these inputs: each column it
    needs read once, capacity and mask written once, the eight counts.  A
    column that the group's filters do not consult is not needed: an
    unused constraint slot's hashes, the node platform hashes when a used
    platform row is the full wildcard (or no row names an os / an arch),
    the host-port column of a group that is not port-limited, the
    service's task counts of a group without max-replicas."""
    n = nodes.valid.shape[0]
    # valid, ready, res_ok, extra_mask; res_cap; cap; mask
    per_node = 4 + 4 + 4 + 1
    per_node += 8 * int(((group.con_op == 0) | (group.con_op == 1)).sum())
    rows = [tuple(int(v) for v in r) for r in group.plat.tolist()
            if r[0] != -1]
    if rows and (0, 0, 0, 0) not in rows:
        per_node += 8 * any(r[0] != 0 or r[1] != 0 for r in rows)
        per_node += 8 * any(r[2] != 0 or r[3] != 0 for r in rows)
    per_node += 1 if bool(group.port_limited) else 0
    per_node += 4 if int(group.maxrep) > 0 else 0
    per_node += 1 if nodes.quota_ok is not None else 0
    return n * per_node + 4 * 8


def stage_b_calls(torch, K, nodes, cap, k_branch, L):
    """Stage B of a spread plan over ``L`` leaves on the card: (the
    unchecked K3 entry the plan calls, its plain version, the checked
    entry), each writing or returning the node placement."""
    n = nodes.valid.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=cap.device)
    kw = dict(svc_tasks=nodes.svc_tasks, failures=nodes.failures,
              total=nodes.total_tasks, cap=cap, k_seg=k_branch,
              seg=nodes.leaf, L=L, out=out)
    tie = K._tie_keys(nodes.total_tasks, n, cap.device)

    def run():
        return K._waterfill_into(**kw)

    def plain():
        return K._waterfill_plain(K.spread_score(nodes), cap, tie, k_branch,
                                  nodes.leaf, L)

    def checked():
        return K._waterfill(**kw)

    return run, plain, checked


def phase_kernels(torch, K, to_device):
    """Each kernel against its plain version at the headline shapes."""
    dev = torch.device("cuda")
    nodes_np, group_np, L, hier_np = plan_inputs(
        seed=2024, nb=16384, n_valid=10000, n_leaves=20, cc=4, p=4,
        k=K.K_CLAMP - 1, near_2p24=True)
    nodes, group, hier = to_device(nodes_np, group_np, hier_np, dev)
    n = nodes.valid.shape[0]
    rows = []

    # ---- K1 feasibility
    got = K.feasibility_and_capacity(nodes, group)
    want = K._feasibility_plain(nodes, group)
    err1 = max_abs_err(torch, got, want)
    cap = want[1]
    active_cc = int(((group.con_op == 0) | (group.con_op == 1)).sum())
    plat_used = int((group.plat[:, 0] != -1).sum())
    b1 = feasibility_bytes(nodes, group)
    o1 = n * (8 + 3 * active_cc + 6 * plat_used)
    rows.append(dict(
        kernel=K.FEASIBILITY, err=err1, bytes=b1, ops=o1,
        device_ms=device_ms(torch, lambda: K.feasibility_packed(nodes, group),
                            ("feasibility_kernel",)),
        ms=time_ms(torch, lambda: K.feasibility_packed(nodes, group)),
        plain_ms=time_ms(torch, lambda: K._feasibility_plain(nodes, group)),
        library_ms=None))

    # ---- K2 branch sums (the leaf level of stage A), one launch a call:
    # the unchecked entry the plan calls (timed as the row; its outputs
    # are per-stream buffers that the next call overwrites), and the public
    # one that checks its inputs and returns fresh tensors
    def k2():
        return K._branch_sums(nodes.svc_tasks, nodes.valid, cap, nodes.leaf,
                              L, group.k)

    def k2_public():
        return K.branch_sums(nodes.svc_tasks, nodes.valid, cap, nodes.leaf,
                             L, group.k)

    got = k2_public()
    want = K._seg_sum_plain(nodes.svc_tasks, nodes.valid, cap, nodes.leaf,
                            L, group.k)
    err2 = max_abs_err(torch, got, want)
    check(int(want[2].max()) >= 1 << 24 and int(want[0].max())
          == K.LOAD_CLAMP, "the sample inputs must carry branch totals above "
          "2^24")
    # two calls queued back to back, no sync between them (the fused
    # route's chunks in flight): the accumulator each leaves zero
    cap2 = cap.flip(0).contiguous()
    before = K.SEG_SUM.launches
    pair = [k2_public(), K.branch_sums(nodes.svc_tasks, nodes.valid, cap2,
                                       nodes.leaf, L, group.k)]
    check(K.SEG_SUM.launches - before == 2, "K2 is not one launch a call")
    err2 = max(err2, max_abs_err(torch, pair[0], want), max_abs_err(
        torch, pair[1], K._seg_sum_plain(nodes.svc_tasks, nodes.valid, cap2,
                                         nodes.leaf, L, group.k)))
    load, bcap, raw_cap, kk = want
    vals = torch.stack([torch.where(nodes.valid, nodes.svc_tasks.clamp(
        0, K.SVC_CLAMP), 0), cap], 1).to(torch.int64)
    seg_l = nodes.leaf.to(torch.int64)
    acc = torch.zeros((L, 2), dtype=torch.int64, device=dev)
    k2_public_ms = time_ms(torch, k2_public)
    rows.append(dict(
        kernel=K.SEG_SUM, err=err2, bytes=n * 13 + L * 16 + 4, ops=2 * n,
        device_ms=device_ms(torch, k2, ("seg_sum_kernel",)),
        ms=time_ms(torch, k2),
        plain_ms=time_ms(torch, lambda: K._seg_sum_plain(
            nodes.svc_tasks, nodes.valid, cap, nodes.leaf, L, group.k)),
        library_ms=time_ms(torch, lambda: acc.index_add_(0, seg_l, vals))))
    print(f"kernels: seg_sum public entry (input checks) {k2_public_ms:.4f}"
          f" ms per call; index_add_ {rows[-1]['library_ms']:.4f} ms",
          flush=True)

    # ---- K3 water-fill, one cluster launch a call: stage A (branches)
    # and stage B (nodes), as the main path runs them, then stage B over
    # one spread value per node (L = 16,384)
    k_branch = K._waterfill_plain(
        load, bcap, torch.arange(L, dtype=torch.int32, device=dev), kk,
        torch.zeros(L, dtype=torch.int32, device=dev), 1)
    spill = torch.zeros(1, dtype=torch.int32, device=dev)
    alloc = torch.empty(L, dtype=torch.int32, device=dev)
    K._waterfill(e=load, cap=bcap, k_seg=kk,
                 seg=torch.zeros(L, dtype=torch.int32, device=dev), L=1,
                 out=alloc, raw_cap=raw_cap, spill=spill)
    spill_plain = K._level_spill(k_branch, raw_cap)
    err3a = max_abs_err(torch, (alloc, spill[0] != 0),
                        (k_branch, spill_plain))
    stage_b, stage_b_plain, stage_b_checked = stage_b_calls(
        torch, K, nodes, cap, k_branch, L)
    err3 = max(err3a, max_abs_err(torch, (stage_b(),), (stage_b_plain(),)))
    steps = K.LEVEL_ITERS + K.TIE_ITERS + 2
    stage_a_ms = time_ms(torch, lambda: K._waterfill(
        e=load, cap=bcap, k_seg=kk,
        seg=torch.zeros(L, dtype=torch.int32, device=dev), L=1,
        out=alloc, raw_cap=raw_cap, spill=spill))
    before = K.WATERFILL.launches
    stage_b()
    check(K.WATERFILL.launches - before == 1, "K3 is not one launch a call")
    rows.append(dict(
        kernel=K.WATERFILL, err=err3, bytes=n * 24 + L * 4, ops=steps * n * 4,
        device_ms=device_ms(torch, stage_b, ("waterfill_kernel",)),
        ms=time_ms(torch, stage_b), plain_ms=time_ms(torch, stage_b_plain),
        library_ms=None))
    stage_b_checked_ms = time_ms(torch, stage_b_checked)
    print(f"kernels: waterfill stage A (256 branches, 1 segment) "
          f"{stage_a_ms:.4f} ms per call; stage B through the checked "
          f"entry {stage_b_checked_ms:.4f} ms", flush=True)

    wn, wg, wide_L, _ = plan_inputs(
        seed=2025, nb=16384, n_valid=16384, n_leaves=16384, k=2 * 16384,
        near_2p24=False)
    wn, wg, _ = to_device(wn, wg, (), dev)
    check(wide_L == 16384, f"one value per node gives L = {wide_L}")
    _, wcap, _ = K._feasibility_plain(wn, wg)
    wload, wbcap, _, wkk = K._seg_sum_plain(wn.svc_tasks, wn.valid, wcap,
                                            wn.leaf, wide_L, wg.k)
    wk_branch = K._waterfill_plain(
        wload, wbcap, torch.arange(wide_L, dtype=torch.int32, device=dev),
        wkk, torch.zeros(wide_L, dtype=torch.int32, device=dev), 1)
    wide, wide_plain, _ = stage_b_calls(torch, K, wn, wcap, wk_branch,
                                        wide_L)
    wide_x = wide_plain()
    err_wide = max_abs_err(torch, (wide(),), (wide_x,))
    check(err_wide == 0, f"waterfill at L = {wide_L} differs from its plain "
          f"version (max abs err {err_wide})")
    check(int(wide_x.sum()) == int(wg.k), "the one-value-per-node fill "
          f"placed {int(wide_x.sum())} of {int(wg.k)}")
    wide_ms = time_ms(torch, wide)
    wide_dev = device_ms(torch, wide, ("waterfill_kernel",))
    print(f"kernels: waterfill stage B over one spread value per node "
          f"(L = {wide_L}, nb 16384) == plain; {wide_ms:.4f} ms per wrapper "
          f"call, device {wide_dev:.4f} ms", flush=True)
    extra = dict(seg_sum_public_ms=k2_public_ms,
                 waterfill_stage_a_ms=stage_a_ms,
                 waterfill_stage_b_checked_ms=stage_b_checked_ms,
                 waterfill_L16384_ms=wide_ms,
                 waterfill_L16384_device_ms=wide_dev)

    # ---- the composition: plan_group on the card vs the CPU plain path
    cn, cg, ch = to_device(nodes_np, group_np, hier_np, "cpu")
    on_card = K.plan_group_packed(nodes, group, L, hier)
    on_cpu = K.plan_group_packed(cn, cg, L, ch)
    check(torch.equal(on_card.cpu(), on_cpu),
          "plan_group on the card differs from the CPU plain path")
    x, _, spill_flag = K.unpack_plan(on_cpu.numpy(), n)
    print(f"kernels: plan_group card == cpu (placed {int(x.sum())} of "
          f"{int(group_np.k)}, spill {spill_flag})", flush=True)
    plan_ms = time_ms(torch, lambda: K.plan_group_packed(nodes, group, L,
                                                         hier))
    plan_dev = device_ms(torch, lambda: K.plan_group_packed(nodes, group, L,
                                                            hier), ("",))

    def plan_plain():
        """plan_group's plain composition on the card: K1, K2 and both K3
        stages as plain PyTorch, the placement x."""
        _, cap_p, _ = K._feasibility_plain(nodes, group)
        load_p, bcap_p, raw_p, kk_p = K._seg_sum_plain(
            nodes.svc_tasks, nodes.valid, cap_p, nodes.leaf, L, group.k)
        k_br = K._waterfill_plain(
            load_p, bcap_p, torch.arange(L, dtype=torch.int32, device=dev),
            kk_p, torch.zeros(L, dtype=torch.int32, device=dev), 1)
        K._level_spill(k_br, raw_p)
        return K._waterfill_plain(K.spread_score(nodes), cap_p, K._tie_keys(
            nodes.total_tasks, n, dev), k_br, nodes.leaf, L)

    check(torch.equal(plan_plain().cpu(), on_cpu[:n]),
          "plan_group's plain composition on the card differs")
    plan_plain_ms = time_ms(torch, plan_plain, reps=10, warmup=2)
    print(f"kernels: plan_group (K1 + K2 + 2 x K3) {plan_ms:.4f} ms per call "
          f"(CUDA events), device {plan_dev:.4f} ms per call "
          "(torch.profiler, every device op); plain composition "
          f"{plan_plain_ms:.4f} ms", flush=True)
    for r in rows:
        check(r["err"] == 0, f"{r['kernel'].name}: kernel differs from its "
              f"plain version (max abs err {r['err']})")
        print(f"kernels: {r['kernel'].name} {r['ms']:.4f} ms per wrapper "
              f"call (CUDA events), device {r['device_ms']:.4f} ms per "
              "call (torch.profiler)", flush=True)
    return rows, dict(ms=plan_ms, device_ms=plan_dev, plain_ms=plan_plain_ms,
                      **extra)


#: integer operations a node of K1F needs: the carried placement (4),
#: two int64 floor divisions and their clamps (8), the filters and the
#: capacity (12)
ENTRY_OPS = 24


def score_ops(sid, hidden):
    """Integer operations a node of the score (K6, or the scored K1F's
    epilogue) needs: the down-weight (4) and the weighted sum (12), or the
    learned MLP (a multiply-add each of 6 x hidden and hidden weights, the
    features, shifts and clamps)."""
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    if sid == strategy_mod.STRAT_LEARNED:
        return 2 * 6 * hidden + 2 * hidden + 24
    return 16


def fused_entry_bytes(groups, g, n, s, sid, has_prev, nnz_prev, hidden=0):
    """The bytes K1F's function must move for slot ``g`` of a fused chunk
    over ``n`` nodes and ``s`` service slots: valid, ready and the plugin
    mask, the carry's cpu and mem, svc0 and svc_acc at the slot, the
    previous slot's placement, the active constraints' hashes and the quota
    row read; capacity and svc written, and res_cap (binpack) or, for a
    weighted or learned slot (the scored launch), the group's failures
    read, the carry's total read (learned; already counted where the chunk
    has a previous slot) and the level e written, with the slot's weights
    or the ``hidden``-unit MLP; the fail counts and the slot's scalars.
    The headroom is derived in registers and never written.  For each
    of the ``nnz_prev`` nodes the previous slot placed on, the carry's
    update: total read and written (8), cpu and mem written (16; read
    above), svc_acc at the previous slot's service written (4) and read
    (4) unless that row is the one this slot reads (read above); no svc_acc
    where the previous slot's service lies outside [0, S)."""
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    op = groups.con_op[g]
    per_node = 3 + 16 + 8 + 8 * int(((op == 0) | (op == 1)).sum())
    per_node += 4 if has_prev else 0
    per_node += 1 if groups.quota_ok is not None else 0
    rows = [tuple(int(v) for v in r) for r in groups.plat[g].tolist()
            if r[0] != -1]
    if rows and (0, 0, 0, 0) not in rows:
        per_node += 8 * any(r[0] != 0 or r[1] != 0 for r in rows)
        per_node += 8 * any(r[2] != 0 or r[3] != 0 for r in rows)
    per_node += 8
    scalars = 4 * 8 + 64
    if sid == strategy_mod.STRAT_BINPACK:
        per_node += 4
    elif sid in (strategy_mod.STRAT_WEIGHTED, strategy_mod.STRAT_LEARNED):
        learned = sid == strategy_mod.STRAT_LEARNED
        per_node += 4 + 4 + (4 if learned and not has_prev else 0)
        scalars += 4 * (4 + ((6 + 2) * hidden + 1 if learned else 0))
    placed = 0
    if has_prev:
        prev = K._scatter_slot(groups, g - 1, s)
        placed = 24 + (0 if prev is None else
                       4 if prev == K._slot_of(groups, g, s) else 8)
    return n * per_node + placed * nnz_prev + scalars


#: calls a fresh cfg7 chunk's carry (``fused_inputs``, seeds 77 and 78)
#: sustains while every call places all its tasks: 16, on the CPU plain
#: path; then the carry runs dry and a chunk places nothing.  Each timed
#: measurement of a chunk below (each profiled session) makes at most this
#: many calls on a carry of its own.
CHUNK_CALLS_PER_CARRY = 16


def time_chunk(torch, plan, fresh_carry, placed_of, want, label, reps,
               warmup, dev_reps):
    """A fused chunk's wrapper and device times, each measured on a fresh
    carry (``fresh_carry()``; every profiled session on one of its own),
    every call planning on the carry the last one left as the route's
    chunks do.  Fails unless each measurement's last call still placed
    ``want`` (``placed_of`` of its rows): a drained carry would time a
    chunk that places nothing."""
    check(max(reps + warmup, 1 + dev_reps) <= CHUNK_CALLS_PER_CARRY,
          f"{label}: too many calls for a carry")
    times = []
    for profile in (False, True):
        carry = [fresh_carry()]
        last = []

        def run():
            last[:] = [plan(carry[0])]
            return last[0]

        def renew():
            carry[0] = fresh_carry()

        times.append(
            device_ms(torch, run, ("",), reps=dev_reps, label=label,
                      before_session=renew) if profile
            else time_ms(torch, run, reps=reps, warmup=warmup))
        got = placed_of(last[0])
        check(got == want, f"{label}: the last timed chunk placed {got}, "
              f"not {want}: its carry ran dry")
    return times


def binpack_slot(torch, K, shared, groups, carry):
    """(NodeInputs, GroupInputs, capacity) of a fused chunk's binpack slot
    (slot 1) as the fused route hands them to K5: the slot's columns from
    the carry and K1's capacity, from their plain versions."""
    gb = 1
    n = shared.valid.shape[0]
    dev = shared.valid.device
    res_ok, res_cap, svc = K._fused_prologue_plain(
        shared, carry, groups.cpu_d[gb], groups.mem_d[gb],
        K._slot_of(groups, gb, shared.svc0.shape[0]))
    nodes = K.NodeInputs(
        valid=shared.valid, ready=shared.ready, res_ok=res_ok,
        res_cap=res_cap, svc_tasks=svc, total_tasks=carry.total,
        failures=groups.failures[gb], leaf=groups.leaf[gb],
        os_hash=shared.os_hash, arch_hash=shared.arch_hash,
        port_conflict=torch.zeros(n, dtype=torch.bool, device=dev),
        extra_mask=groups.extra_mask[gb])
    grp = K.GroupInputs(
        k=groups.k[gb], con_hash=groups.con_hash[gb],
        con_op=groups.con_op[gb], con_exp=groups.con_exp[gb],
        plat=groups.plat[gb], maxrep=groups.maxrep[gb],
        port_limited=torch.zeros((), dtype=torch.bool, device=dev))
    return nodes, grp, K._feasibility_plain(nodes, grp)[1]


def phase_kernels_fused(torch, K, fused_to_device):
    """K1F, K4's carry update, K5 and K6 against their plain versions on a
    cfg7 chunk at node bucket 16384, and one fused chunk on the card
    against the CPU."""
    dev = torch.device("cuda")
    i32 = torch.int32
    inputs = fused_inputs(seed=77)
    shared, groups, carry, strat = fused_to_device(*inputs[:4], device=dev)
    L = inputs[4]
    n = shared.valid.shape[0]
    s = shared.svc0.shape[0]
    g = 2                                    # the weighted slot
    rows = []

    # ---- K1F, the slot entry of the binpack slot, with a carried x: the
    # previous slot's placements into the carry, the slot's columns and
    # K1's filters, with res_cap written (K5's key)
    x_prev = torch.zeros(n, dtype=i32, device=dev)
    x_prev[:10000] = torch.randint(0, 6, (10000,), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev, dtype=i32)
    nnz_prev = int((x_prev != 0).sum())
    hidden = int(strat.w1.shape[1])

    def entry_row(kern, gs, scored, label):
        """K1F at slot ``gs`` on clones of the carry against its plain
        version on others (bit-equal columns and carry), then timed."""
        outs = [torch.empty(n, dtype=i32, device=dev) for _ in range(3)]
        fail = torch.zeros(K.N_FILTERS, dtype=i32, device=dev)
        sid = int(strat.sid[gs])
        entry_carry = K.FusedCarry(*(t.clone() for t in carry))

        def entry(c=entry_carry):
            K._fused_feasibility(
                shared, groups, c, gs, s, x_prev, fail, outs[0], outs[1],
                None if scored else outs[2], strat if scored else None, sid,
                outs[2] if scored else None)

        def entry_plain(c=entry_carry):
            return K._fused_feasibility_plain(shared, groups, c, gs, s,
                                              x_prev, strat, sid)

        clones = [K.FusedCarry(*(t.clone() for t in carry))
                  for _ in range(2)]
        before = kern.launches
        entry(clones[0])
        check(kern.launches - before == 1, f"{label}: not one launch")
        _, cap_p, fail_p, ok_p, rc_p, svc_p, _, _, e_p = \
            entry_plain(clones[1])
        err = max(max_abs_err(torch, [outs[0], fail, outs[1], outs[2]],
                              [cap_p, fail_p, svc_p,
                               e_p if scored else rc_p]),
                  max_abs_err(torch, tuple(clones[0]), tuple(clones[1])))
        check(bool((~ok_p[:n // 2]).any()) and bool(ok_p[:n // 2].any()),
              "the fused inputs must leave some nodes short of the demand")
        return dict(
            kernel=kern, err=err, sid=sid,
            bytes=fused_entry_bytes(groups, gs, n, s, sid, True, nnz_prev,
                                    hidden),
            ops=(ENTRY_OPS + (score_ops(sid, hidden) if scored else 0)) * n,
            device_ms=device_ms(torch, entry, ("fused_feasibility_kernel",),
                                label=label),
            ms=time_ms(torch, entry), plain_ms=time_ms(torch, entry_plain),
            library_ms=None)

    rows.append(entry_row(K.FUSED_FEASIBILITY, 1, False, "K1F"))
    # the scored K1F on the weighted and the learned slot; the learned
    # one (the MLP) is its row, the weighted one goes to the record
    scored_weighted = entry_row(K.FUSED_SCORED, 2, True, "K1F weighted")
    rows.append(entry_row(K.FUSED_SCORED, 3, True, "K1F learned"))
    check(scored_weighted["err"] == 0, "the scored K1F (weighted) differs "
          f"from its plain version ({scored_weighted['err']})")

    # ---- K4 carry update, with a placement of the chunk's own sizes
    x = torch.zeros(n, dtype=i32, device=dev)
    x[:10000] = torch.randint(0, 6, (10000,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev, dtype=i32)
    nnz = int((x != 0).sum())
    clones = [K.FusedCarry(*(t.clone() for t in carry)) for _ in range(2)]
    K._fused_carry(groups, clones[0], g, s, x)
    K._fused_carry_plain(groups, clones[1], g, s, x)
    err = max_abs_err(torch, tuple(clones[0]), tuple(clones[1]))
    scratch = K.FusedCarry(*(t.clone() for t in carry))
    rows.append(dict(
        kernel=K.FUSED_CARRY, err=err,
        bytes=4 * n + 2 * 24 * nnz + 20, ops=6 * nnz,
        device_ms=device_ms(torch, lambda: K._fused_carry(
            groups, scratch, g, s, x), ("fused_carry_kernel",)),
        ms=time_ms(torch, lambda: K._fused_carry(groups, scratch, g, s, x)),
        plain_ms=time_ms(torch, lambda: K._fused_carry_plain(
            groups, scratch, g, s, x)),
        library_ms=None))

    # ---- K5 pack fill on the binpack slot's columns
    gb = 1
    nodes, grp, cap = binpack_slot(torch, K, shared, groups, carry)
    res_cap = nodes.res_cap
    seg = torch.zeros(n, dtype=i32, device=dev)
    out = torch.empty(n, dtype=i32, device=dev)
    err = 0
    total = int(cap.sum())
    for k in (int(groups.k[gb]), total, total + 9, 1, 0):
        kk = torch.tensor([k], dtype=i32, device=dev)
        before = K.PACKFILL.launches
        got = K._packfill(res_cap=res_cap, failures=nodes.failures, cap=cap,
                          k=kk, out=out)
        check(K.PACKFILL.launches - before == 1,
              "K5 is not one launch a call")
        want = K._packfill_plain(K._binpack_key(res_cap, nodes.failures),
                                 cap, kk, seg, 1)
        err = max(err, max_abs_err(torch, (got,), (want,)))
    for case in PACK_EDGE_CASES:
        cols = {c: torch.from_numpy(a).to(dev)
                for c, a in pack_edge_inputs(61, n, case).items()
                if c in ("res_cap", "failures", "cap", "k")}
        got = K._packfill(out=torch.empty(n, dtype=i32, device=dev), **cols)
        want = K._packfill_plain(
            K._binpack_key(cols["res_cap"], cols["failures"]), cols["cap"],
            cols["k"], seg, 1)
        err = max(err, max_abs_err(torch, (got,), (want,)))
    kk = groups.k[gb].reshape(1)

    def packfill():
        return K._packfill(res_cap=res_cap, failures=nodes.failures,
                           cap=cap, k=kk, out=out)

    def packfill_plain():
        return K._packfill_plain(K._binpack_key(res_cap, nodes.failures),
                                 cap, kk, seg, 1)

    # res_cap, failures and cap in, x out; k
    rows.append(dict(
        kernel=K.PACKFILL, err=err, bytes=16 * n + 4, ops=PACK_OPS * n,
        device_ms=device_ms(torch, packfill, ("packfill_kernel",),
                            label="K5"),
        ms=time_ms(torch, packfill), plain_ms=time_ms(torch, packfill_plain),
        library_ms=None, launches_per_call=1))

    # ---- K6 scores: weighted and learned on the same node columns (the
    # public strategy_score; the plans score in K1's and K1F's epilogue),
    # and the scored K1 on them, bit-equal to its plain version
    hr = [K._fused_headroom(carry.cpu, groups.cpu_d[g]),
          K._fused_headroom(carry.mem, groups.mem_d[g]),
          torch.full((n,), K.HR_CLAMP, dtype=i32, device=dev)]
    sin = K.StrategyInputs(*hr, weights=strat.weights[g], w1=strat.w1,
                           b1=strat.b1, w2=strat.w2, b2=strat.b2)
    err = 0
    scored_k1_err = 0
    for mode in (K.STRAT_SPREAD, K.STRAT_WEIGHTED, K.STRAT_LEARNED):
        err = max(err, max_abs_err(
            torch, (K.strategy_score(nodes, sin, mode),),
            (K._strategy_score_plain(nodes, sin, mode),)))
        cap_k, e_k = (torch.empty(n, dtype=i32, device=dev)
                      for _ in range(2))
        fail_k = torch.zeros(K.N_FILTERS, dtype=i32, device=dev)
        before = K.FEASIBILITY.launches
        K._feasibility_into(nodes, grp, None, cap_k, fail_k, (sin, mode),
                            e_k)
        check(K.FEASIBILITY.launches - before == 1,
              "the scored K1 is not one launch")
        scored_k1_err = max(scored_k1_err, max_abs_err(
            torch, (cap_k, fail_k, e_k),
            K._feasibility_plain(nodes, grp, (sin, mode))[1:]))
    check(scored_k1_err == 0, "the scored K1 differs from its plain "
          f"version ({scored_k1_err})")
    # timed in learned mode: svc, total, failures, hr_cpu, hr_mem (int32)
    # and ready (a byte) in, e out, and the scorer's weights
    rows.append(dict(
        kernel=K.SCORE, err=err,
        bytes=n * (4 * 5 + 1) + 4 * n + 4 * (6 * hidden + 2 * hidden + 1),
        ops=n * (2 * 6 * hidden + 2 * hidden + 24),
        device_ms=device_ms(torch, lambda: K.strategy_score(
            nodes, sin, K.STRAT_LEARNED), ("score_kernel",)),
        ms=time_ms(torch, lambda: K.strategy_score(nodes, sin,
                                                   K.STRAT_LEARNED)),
        plain_ms=time_ms(torch, lambda: K._strategy_score_plain(
            nodes, sin, K.STRAT_LEARNED)),
        library_ms=None))

    # ---- K3 over one segment, as a weighted or learned group runs it
    _, cap_w, _ = K._feasibility_plain(nodes, grp)
    e = K._strategy_score_plain(nodes, sin, K.STRAT_WEIGHTED)
    kk_w = groups.k[g].reshape(1)
    fill = torch.empty(n, dtype=i32, device=dev)

    def waterfill_flat():
        return K._waterfill(e=e, total=nodes.total_tasks, cap=cap_w,
                            k_seg=kk_w, seg=seg, L=1, out=fill)

    waterfill_flat()
    check(torch.equal(fill, K._waterfill_plain(
        e, cap_w, K._tie_keys(nodes.total_tasks, n, dev), kk_w, seg, 1)),
        "waterfill over one segment differs from its plain version")
    flat_ms = time_ms(torch, waterfill_flat)
    flat_dev = device_ms(torch, waterfill_flat, ("waterfill_kernel",))
    print(f"kernels: waterfill over one segment (weighted group, 16384 "
          f"nodes) {flat_ms:.4f} ms per wrapper call, device "
          f"{flat_dev:.4f} ms", flush=True)

    # ---- one fused chunk (spread, binpack, weighted, learned) on the card
    # against the CPU, then its time per chunk
    sids = inputs[3].sid.tolist()
    pristine = K.FusedCarry(*(t.clone() for t in carry))
    on_card = K.plan_fused_packed(shared, groups, carry, L, strat, sids)
    cpu_in = fused_to_device(*inputs[:4], device="cpu")
    on_cpu = K.plan_fused_packed(*cpu_in[:3], L, cpu_in[3], sids)
    check(torch.equal(on_card.cpu(), on_cpu),
          "a fused chunk on the card differs from the CPU plain path")
    check(torch.equal(carry.cpu.cpu(), cpu_in[2].cpu)
          and torch.equal(carry.svc_acc.cpu(), cpu_in[2].svc_acc),
          "the fused carry on the card differs from the CPU's")
    placed = on_cpu[:, :n].sum(dim=1).tolist()
    check(all(p > 0 for p in placed), f"a fused group placed nothing: "
          f"{placed}")

    chunk_ms, chunk_dev = time_chunk(
        torch, lambda c: K.plan_fused_packed(shared, groups, c, L, strat,
                                             sids),
        lambda: K.FusedCarry(*(t.clone() for t in pristine)),
        lambda buf: buf[:, :n].sum(dim=1).tolist(), placed, "fused chunk",
        reps=10, warmup=2, dev_reps=5)
    print(f"kernels: fused chunk (4 slots: spread, binpack, weighted, "
          f"learned) card == cpu, placed {placed}; {chunk_ms:.4f} ms per "
          f"chunk (CUDA events), device {chunk_dev:.4f} ms (torch.profiler, "
          "every device op)", flush=True)
    for r in rows:
        check(r["err"] == 0, f"{r['kernel'].name}: kernel differs from its "
              f"plain version (max abs err {r['err']})")
        print(f"kernels: {r['kernel'].name} {r['ms']:.4f} ms per wrapper "
              f"call (CUDA events), device {r['device_ms']:.4f} ms per "
              "call (torch.profiler)"
              + (f", {r['launches_per_call']} launch per call"
                 if "launches_per_call" in r else ""), flush=True)
    print(f"kernels: fused_feasibility_scored (weighted slot) "
          f"{scored_weighted['ms']:.4f} ms per wrapper call, device "
          f"{scored_weighted['device_ms']:.4f} ms; scored K1 == plain "
          "(spread, weighted, learned)", flush=True)
    return rows, dict(ms=chunk_ms, device_ms=chunk_dev, placed=placed,
                      waterfill_one_segment_ms=flat_ms,
                      waterfill_one_segment_device_ms=flat_dev,
                      scored_entry_weighted={
                          k: v for k, v in scored_weighted.items()
                          if k != "kernel"})


#: K8's shapes in phase 10: (node bucket, gangs, quota column); the gang
#: fleet's bucket is 1,024 (its main path: G = 1 and 2), the headline's
#: 16,384
GANG_KERNEL_SHAPES = ((512, 1, False), (512, 2, False), (512, 8, False),
                      (1024, 1, False), (1024, 2, False), (1024, 8, False),
                      (16384, 1, True), (16384, 2, False), (16384, 8, False))


def phase_kernels_resident(torch, K, gang_to_device):
    """K7 (one launch over a table of 1 and 4 shards) and K8 (M blocks a
    gang) against their plain versions."""
    dev = torch.device("cuda")
    rows = []

    # ---- K7: the dirty-row scatter at each staging bucket, unsplit and
    # over four shards of the card (global indices, one launch)
    per_bucket = {}
    for d, db in ((13, 16), (200, 256), (3000, 4096)):
        cols_np, packed_np = scatter_inputs(31 + db, d=d, db=db)
        packed = torch.from_numpy(packed_np).to(dev)
        idx, *upd = K.scatter_views(packed, db)
        keep = idx < cols_np[0].shape[0]
        rows_t = idx[keep].to(torch.int64)
        upd = [u[keep] for u in upd]
        for shards in (1, MESH_SHARDS):
            cols = split_columns(cols_np, shards, dev)
            got = tuple(tuple(p.clone() for p in c) for c in cols)
            launched = K.SCATTER.launches
            K.scatter_rows(got, packed)
            check(K.SCATTER.launches == launched + 1,
                  f"scatter over {shards} shards: not one launch")
            want = tuple(tuple(p.clone() for p in c) for c in cols)
            K._scatter_rows_plain(want, packed, db)
            err = max_abs_err(torch, [torch.cat(g) for g in got],
                              [torch.cat(w) for w in want])
            check(all(not torch.equal(torch.cat(g), torch.cat(c))
                      for g, c in zip(got, cols)),
                  f"scatter at d={d} over {shards} shards wrote no row")
            scratch = tuple(tuple(p.clone() for p in c) for c in cols)
            flat = [torch.cat(c) for c in cols]

            def library(flat=flat, rows_t=rows_t, upd=upd):
                for c, u in zip(flat, upd):
                    c.index_copy_(0, rows_t, u)

            def run(scratch=scratch, packed=packed):
                K.scatter_rows(scratch, packed)

            per_bucket[(db, shards)] = dict(
                kernel=K.SCATTER, err=err,
                # the in-range slots read whole (26 B) and written (22 B);
                # a pad slot's index read (4 B)
                bytes=26 * d + 4 * (db - d) + 22 * d, ops=6 * db,
                device_ms=device_ms(torch, run, ("scatter_rows_kernel",),
                                    label=f"K7 db={db} x{shards}"),
                ms=time_ms(torch, run),
                plain_ms=time_ms(torch, lambda s=scratch, p=packed, b=db:
                                 K._scatter_rows_plain(s, p, b)),
                library_ms=time_ms(torch, library), d=d, db=db,
                shards=shards)
    rows.append(per_bucket[(256, 1)])

    # ---- K8: the gang fit at the fleet's and the headline's buckets
    per_g = {}
    for nb, g_count, quota in GANG_KERNEL_SHAPES:
        gang_np = gang_rows(500 + g_count, g_count, nb=nb,
                            n_valid=10000 if nb == 16384 else nb * 3 // 4,
                            quota=quota)
        nodes, groups = gang_to_device(gang_np, dev)
        got = K.unpack_gang(K.gang_fit_packed(nodes, groups), g_count)
        want = K._gang_fit_plain(nodes, groups)
        err = max_abs_err(torch, got, want)
        fits = want[0].tolist()
        if g_count > 1 and nb == 16384:
            check(fits == [g % 3 != 2 for g in range(g_count - 1)] + [True]
                  and int(want[2][-1]) > 1 << 24,
                  f"the gang inputs must sit at the k boundary: {fits}")

        def run(nodes=nodes, groups=groups):
            K.gang_fit_packed(nodes, groups)

        per_g[(nb, g_count)] = dict(
            kernel=K.GANG_FIT, err=err, bytes=gang_bytes(gang_np),
            ops=gang_ops(gang_np),
            device_ms=device_ms(torch, run, ("gang_fit_kernel",),
                                label=f"K8 nb={nb} G={g_count}"),
            ms=time_ms(torch, run),
            plain_ms=time_ms(torch, lambda nodes=nodes, groups=groups:
                             K._gang_fit_plain(nodes, groups),
                             reps=10, warmup=2),
            library_ms=None, fits=fits, g=g_count, nb=nb,
            blocks=K.gang_fit_blocks(nb, g_count))
    # the earlier slices' row (nb 16,384, G = 1, the quota column) keeps
    # the kernel's name, so a line compares with its parent's at one
    # shape; the gang fleet's (its node bucket, one gang a verdict) goes
    # beside it under a name of its own
    rows.append(per_g[(16384, 1)])
    rows.append(dict(per_g[(1024, 1)], name=f"{K.GANG_FIT.name}@nb1024"))
    for r in list(per_bucket.values()) + list(per_g.values()):
        check(r["err"] == 0, f"{r['kernel'].name}: kernel differs from its "
              f"plain version (max abs err {r['err']})")
        shape = (f"d={r['d']} of {r['db']} slots, {r['shards']} shard(s)"
                 if "db" in r else f"nb={r['nb']}, G={r['g']}, "
                 f"{r['blocks']} block(s) a gang, fits {r['fits']}")
        print(f"kernels: {r['kernel'].name} ({shape}) == plain; "
              f"{r['ms']:.4f} ms per wrapper call (CUDA events), device "
              f"{r['device_ms']:.5f} ms (torch.profiler), plain "
              f"{r['plain_ms']:.4f} ms"
              + ("" if r["library_ms"] is None
                 else f", index_copy_ x5 {r['library_ms']:.4f} ms")
              + f", {r['bytes']} bytes, bound "
              f"{bound(r['bytes'], r['ops'])[0]:.7f} ms",
              flush=True)
    extra = {f"scatter_db{db}_x{shards}": {k: v for k, v in r.items()
                                          if k != "kernel"}
             for (db, shards), r in per_bucket.items()}
    extra.update({f"gang_fit_nb{nb}_g{g}": {k: v for k, v in r.items()
                                            if k != "kernel"}
                  for (nb, g), r in per_g.items()})
    return rows, extra


#: a 13th churn window in which three services arrive at once: their
#: groups fuse, and the run seeds from the resident device columns
CHURN_BURST = ({"cb": 40, "cd": 40, "cf": 40}, 18)


#: the churn's postures: (name, streaming, mesh shards at the cold tick,
#: {window index: shards from that window on, 0 = no mesh})
CHURN_POSTURES = (("streaming", True, 0, {}), ("full", False, 0, {}),
                  ("mesh", True, MESH_SHARDS, {}),
                  ("layout", True, MESH_SHARDS, {4: 0, 8: 2}))


def scatter_syncs(planner, K):
    """(K7 launches, the resident state's scattering device syncs, the
    scatter H2D copies noted by the device telemetry) so far."""
    from swarmkit_tpu_torch.obs import devicetelemetry
    st = planner._streaming
    h2d = devicetelemetry.snapshot()["transfers"].get("h2d", {})
    return (K.SCATTER.launches, st.stats["scatters"] if st else 0,
            sum(h2d.get(r, {}).get("count", 0)
                for r in ("dirty_scatter", "shard_scatter")))


def phase_churn(torch, K, cuda, workload, TorchPlanner, make_mesh, card):
    """bench.py's config 10 through the store watch feed, with the
    streaming resident state, with full rebuilds, with the resident state
    and the plans split over four shards of the card, and with layout
    changes (four shards, no mesh, two shards): the same placements after
    every window; the streaming sides refresh incrementally through K7
    (per shard on a mesh) and seed a fused run from the resident
    columns."""
    import numpy as np
    out = {}
    for posture, streaming, shards, layout in CHURN_POSTURES:
        t0 = time.perf_counter()
        wl = workload.steady_state_churn()
        wl.script.append(CHURN_BURST)
        build_s = time.perf_counter() - t0
        planner = TorchPlanner(mesh=make_mesh(["cuda:0"] * shards)
                               if shards else None)
        planner.streaming_enabled = streaming
        sched = wl.attach(planner)
        sched.tick()                   # cold tick, outside the windows
        torch.cuda.synchronize()
        cuda.reset_launch_counts(K.KERNELS)
        ticks, decisions, feed_s, digests = [], 0, 0.0, []
        quiet_shard_windows, scatter_rows = [], []
        for w, (arrivals, exits) in enumerate(wl.script):
            if w in layout:
                planner.set_mesh(make_mesh(["cuda:0"] * layout[w])
                                 if layout[w] else None)
            before = planner.streaming_snapshot()
            sync0 = scatter_syncs(planner, K)
            t = time.perf_counter()
            wl.feed(arrivals, exits)
            t1 = time.perf_counter()
            decisions += sched.tick()
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t1)
            feed_s += t1 - t
            after = planner.streaming_snapshot()
            # K7 once a scattering device sync, with one staged H2D
            delta = [b - a for a, b in zip(sync0,
                                           scatter_syncs(planner, K))]
            scatter_rows.append(delta)
            check(delta[0] == delta[1] == delta[2],
                  f"churn ({posture}), window {w}: scatter launches, "
                  f"scattering syncs and scatter H2D copies differ: "
                  f"{delta}")
            # a layout change re-uploads the split columns (a counted
            # resync); every other window with dirty rows scatters them
            if after.get("mesh_devices") and w not in layout \
                    and after["rows"] > before["rows"] \
                    and after["shard_syncs"] <= before["shard_syncs"]:
                quiet_shard_windows.append(w)
            digests.append(hashlib.sha256(
                repr(wl.placements()).encode()).hexdigest())
        launches = cuda.launch_counts(K.KERNELS)
        arrived = sum(sum(a.values()) for a, _ in wl.script)
        check(decisions == arrived, f"churn ({posture}): {decisions} "
              f"decisions for {arrived} arrivals")
        snap = planner.streaming_snapshot()
        stats = dict(planner.stats)
        if streaming:
            check(snap["incremental_ticks"] >= len(wl.script),
                  f"incremental ticks {snap['incremental_ticks']}")
            check(snap["fallbacks"] == 0 and snap["full_ticks"] == 1
                  and snap["resyncs"] == 2 * bool(layout),
                  f"churn ({posture}): unexpected rebuilds or resyncs "
                  f"after the cold tick: {snap}")
            check(launches["scatter_rows"] > 0,
                  "the dirty-row scatter never launched on the churn path")
            check(stats.get("streaming_device_carries", 0) >= 1,
                  "no fused run seeded from the resident columns")
            st = planner._streaming
            st.refresh(sched)
            torch.cuda.synchronize()
            for name, d, h in zip(("valid", "ready", "cpu", "mem", "total"),
                                  st.dev, st._host_cols()):
                parts = d if isinstance(d, tuple) else (d,)
                check(all(p.is_cuda for p in parts) and np.array_equal(
                    torch.cat([p.cpu() for p in parts]).numpy(), h),
                    f"churn ({posture}): resident CUDA column {name} "
                    "differs from the host mirror")
        else:
            check(not snap["enabled"] and launches["scatter_rows"] == 0,
                  "the full-rebuild side used the resident state")
            check(stats.get("streaming_device_carries", 0) == 0,
                  "the full-rebuild side seeded from resident columns")
        if shards:
            final = layout[max(layout)] if layout else shards
            check(snap["mesh_devices"] == final,
                  f"churn ({posture}): mesh_devices {snap['mesh_devices']}"
                  f" != {final}")
            check(not quiet_shard_windows, f"churn ({posture}): windows "
                  f"{quiet_shard_windows} had dirty rows and no shard sync")
            check(launches["shard_waterfill"] > 0,
                  f"churn ({posture}): K10 never launched")
        wl.close()
        seconds = sum(ticks)
        out[posture] = dict(
            scatter_launches_syncs_h2d=[sum(d[i] for d in scatter_rows)
                                        for i in range(3)],
            decisions=decisions, seconds=seconds,
            decisions_per_s=decisions / seconds,
            tick_ms_median=statistics.median(ticks) * 1e3,
            tick_ms_max=max(ticks) * 1e3, feed_s=feed_s,
            cluster_build_s=build_s,
            launches=launches, digest=digests[-1], window_digests=digests,
            snapshot=snap,
            streaming_device_carries=stats.get(
                "streaming_device_carries", 0),
            groups_fused=stats.get("groups_fused", 0))
        print(f"churn ({posture}): {decisions} decisions in {len(ticks)} "
              f"ticks, K7 launches / scattering syncs / scatter H2D "
              f"{out[posture]['scatter_launches_syncs_h2d']}, "
              f"{seconds:.3f} s ({decisions / seconds:.0f} "
              f"decisions/s), tick median {out[posture]['tick_ms_median']:.1f}"
              f" ms, max {out[posture]['tick_ms_max']:.1f} ms (store writes "
              f"and watch feed {feed_s:.3f} s outside them) on {card}; "
              f"launches {launches}; streaming {snap}; device carries "
              f"{out[posture]['streaming_device_carries']}", flush=True)
    for posture in out:
        check(out[posture]["window_digests"]
              == out["streaming"]["window_digests"],
              f"churn placements differ between the streaming and {posture} "
              "postures")
    print(f"churn: placement digests equal after each of the "
          f"{len(out['full']['window_digests'])} windows in all "
          f"{len(out)} postures ({out['full']['digest'][:16]})", flush=True)
    return out


def phase_traced_churn(torch, workload, TorchPlanner, tracer, card):
    """The churn's windows again with the streaming resident state, under
    the span tracer and torch.profiler: where a streaming tick's time
    goes, and the device's busy share of the windows."""
    wl = workload.steady_state_churn()
    wl.script.append(CHURN_BURST)
    sched = wl.attach(TorchPlanner())
    sched.tick()
    torch.cuda.synchronize()

    def windows():
        for arrivals, exits in wl.script:
            wl.window(arrivals, exits)

    out = traced(torch, tracer, windows, card, "traced churn windows")
    wl.close()
    return out


def gang_fit_on_fleet(torch, K, workload, Scheduler, TorchPlanner,
                      gang_to_device):
    """K8 against its plain version on the gang fleet's own inputs, as the
    planner builds them: one single-service gang (G=1), one cross-service
    pair (G=2) and the infeasible 17-CPU gang (G=1), on stacked tensors
    and on the planner's packed stage.  Fit, fail counts and totals must
    be equal, and the verdicts those the fleet expects."""
    from swarmkit_tpu_torch.ops.convert import gang_stage
    store, services, _, tasks = workload.gang_fleet()
    planner = TorchPlanner()
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    first = {}
    for t in tasks:
        first.setdefault(t.service_id, t)
    size = {s.id: s.spec.replicated.replicas for s in services}
    _, too_big = workload.gang_service("too-big", 17, 8, 8)
    cases = (("single-service gang", [first["gang8-00"]], [True]),
             ("cross-service pair", [first["xgang-0a"], first["xgang-0b"]],
              [True, True]),
             ("infeasible gang", [too_big[0]], [False]))
    err, nb = 0, None
    for label, members, expect in cases:
        rows = []
        for t in members:
            built = planner._build_device_inputs(
                sched, t, size.get(t.service_id, len(too_big)))
            check(built is not None and built[1] > 0,
                  f"K8 on the fleet ({label}): no inputs")
            rows.append((built[7], built[8]))
            nb = built[2]
        nodes, groups = gang_to_device(rows, torch.device("cuda"))
        got = K.unpack_gang(K.gang_fit_packed(nodes, groups), len(rows))
        want = K._gang_fit_plain(nodes, groups)
        # the planner's route: the packed stage, K8 on its views
        stage = gang_stage(rows, "cuda", {})
        staged = K.unpack_gang(torch.from_numpy(stage.fetch(
            K.gang_fit_packed(*stage.dev_views)).copy()), len(rows))
        e = max(max_abs_err(torch, got, want),
                max_abs_err(torch, staged, [w.cpu() for w in want]))
        check(e == 0 and all(torch.equal(a.cpu(), b.cpu())
                             for a, b in zip(got, want)),
              f"K8 on the fleet ({label}): kernel {got} != plain {want}")
        check(want[0].tolist() == expect,
              f"K8 on the fleet ({label}): verdicts {want[0].tolist()}, "
              f"expected {expect}")
        print(f"gang fleet: K8 == plain on the fleet's inputs ({label}, "
              f"G={len(rows)}, nb={nb}): fit {want[0].tolist()}, totals "
              f"{want[2].tolist()}, fail counts {want[1].tolist()}",
              flush=True)
        err = max(err, e)
    return dict(err=err, nb=nb)


#: verdicts timed through the planner's gang route: (label, node bucket,
#: gangs), the gang fleet's shapes and the headline's bucket
VERDICT_SHAPES = (("fleet_g1", 1024, 1), ("fleet_g2", 1024, 2),
                  ("nb16384_g1", 16384, 1))
VERDICT_REPS = 200


def verdict_ops(names):
    """The device ops of a verdict by kind: H2D and D2H copies, K8,
    fills (``torch.zeros``, memsets) and anything else."""
    kinds = Counter()
    for name in names:
        kinds["HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name
              else "gang_fit" if "gang_fit_kernel" in name
              else "fill" if "Memset" in name or "Fill" in name
              else "other"] += 1
    return dict(kinds)


def verdict_probe(torch, TorchPlanner, card):
    """One gang verdict through ``TorchPlanner._gang_fit_rows`` (the
    packed stage, its H2D, K8 and the D2H of the verdict), warm: its wall
    time (host clock, the fetch waited for) and its device ops from
    torch.profiler, which must be one H2D, one K8 and one D2H."""
    planner = TorchPlanner()
    out = {}
    for label, nb, g in VERDICT_SHAPES:
        rows = gang_rows(90 + g, g, nb=nb,
                         n_valid=10000 if nb == 16384 else nb * 3 // 4)

        def verdict(rows=rows, label=label):
            return planner._gang_fit_rows(rows, label)

        for _ in range(5):
            verdict()
        t0 = time.perf_counter()
        for _ in range(VERDICT_REPS):
            verdict()
        wall_ms = (time.perf_counter() - t0) / VERDICT_REPS * 1e3
        for _ in range(PROFILE_TRIES):
            events, session = profiled(torch, verdict)
            if session["missing"] == 0:
                break
        names = [name for name, _ in events]
        ops = verdict_ops(names)
        check(ops == {"HtoD": 1, "gang_fit": 1, "DtoH": 1}
              and not any("Pageable" in n for n in names),
              f"a verdict ({label}) ran {names} on the device; {session}")
        out[label] = dict(wall_ms=wall_ms, device_ops=ops,
                          device_ms=sum(us for _, us in events) / 1e3,
                          nb=nb, g=g)
        print(f"gang verdict ({label}, nb={nb}, G={g}): {wall_ms:.4f} ms "
              f"wall through the planner's route on {card}; device ops "
              f"{ops}, {out[label]['device_ms']:.5f} ms on the device",
              flush=True)
    return out


def phase_gang(torch, K, cuda, workload, Task, Scheduler, TorchPlanner,
               gang_to_device, card):
    """bench.py's config 12 gang fleet: every gang admitted whole on K8's
    verdicts, placements equal to the host path's by creation index, and
    an infeasible gang deferred whole by K8's verdict (no rollback) on the
    card.  K8 is held against its plain version on the fleet's inputs."""
    from swarmkit_tpu_torch.state.events import Event
    out = {"k8_on_fleet": gang_fit_on_fleet(
        torch, K, workload, Scheduler, TorchPlanner, gang_to_device),
        "verdict": verdict_probe(torch, TorchPlanner, card)}
    for label, planner in (("card", TorchPlanner()), ("host", None)):
        store, _, nodes, tasks = workload.gang_fleet()
        sched = Scheduler(store, batch_planner=planner)
        _, sub = store.view_and_watch(lambda tx: sched._setup_tasks_list(tx))
        cuda.reset_launch_counts(K.KERNELS)
        t0 = time.perf_counter()
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
        launches = cuda.launch_counts(K.KERNELS)
        gstats = dict(sched.gang.stats)
        host = {n.id: n.description.hostname for n in nodes}
        now_tasks = {t.id: t for t in store.view(lambda tx: tx.find(Task))}
        placements = [host.get(now_tasks[t.id].node_id) for t in tasks]
        check(gstats["gangs_admitted"] == 72 and gstats["gangs_deferred"] == 0
              and all(placements), f"gang fleet ({label}): {gstats}")
        pstats = dict(planner.stats) if planner is not None else {}
        if planner is not None:
            verdicts = pstats.get("gang_fit_device", 0) \
                + pstats.get("gang_fit_fused", 0)
            check(verdicts == 80 and pstats.get("gang_fit_fused") == 16,
                  f"gang verdicts from K8: {pstats}")
            check(pstats.get("gang_fit_host", 0) == 0, "a host verdict")
            check(launches["gang_fit"] == 64 + 8,
                  f"gang_fit launches {launches['gang_fit']}")
        # an infeasible gang: 8 members of 17 CPUs on 16-CPU nodes
        svc, extra = workload.gang_service("too-big", 17, 8, 8)
        store.update(lambda tx: [tx.create(svc)]
                     + [tx.create(t) for t in extra] and None)
        while (ev := sub.poll()) is not None:
            if isinstance(ev, Event):
                sched._handle_event(ev)
        sched.tick()
        store.queue.unsubscribe(sub)
        left = [store.view(lambda tx, i=t.id: tx.get(Task, i))
                for t in extra]
        check(sched.gang.stats["gangs_deferred"] == 1
              and all(not t.node_id and "all-or-nothing placement "
                      "infeasible" in t.status.err for t in left),
              f"the infeasible gang ({label}) was not deferred whole: "
              f"{[(t.node_id, t.status.err) for t in left]}")
        rollbacks = sched.gang.stats["rollbacks"]
        if planner is not None:
            check(planner.stats["gang_fit_device"]
                  == pstats["gang_fit_device"] + 1,
                  "the infeasible gang's verdict did not come from K8")
            # K8's False deferred it before any scratch placement
            check(rollbacks == 0, f"card path rolled back {rollbacks} "
                  "gangs: K8 did not defer the infeasible gang")
        else:
            check(rollbacks == 1, f"host path rolled back {rollbacks} "
                  "gangs, expected the infeasible one")
        out[label] = dict(decisions=n_dec, tick_s=tick_s,
                          decisions_per_s=n_dec / tick_s,
                          gang_stats=gstats, launches=launches,
                          planner_stats={k: v for k, v in pstats.items()
                                         if k != "plan_seconds"},
                          placements=placements)
        print(f"gang fleet ({label}): {n_dec} decisions in {tick_s:.3f} s "
              f"on {card}; {gstats}; planner {out[label]['planner_stats']}; "
              f"gang_fit launches {launches['gang_fit']}; infeasible gang "
              "deferred whole", flush=True)
    check(out["card"]["placements"] == out["host"]["placements"],
          "gang placements differ from the host path's")
    print("gang fleet: card placements == host path's (72 gangs, 416 "
          "members, by creation index)", flush=True)
    for label in ("card", "host"):
        del out[label]["placements"]
    return out


# ------------------------------------------------- the node-axis split


class PlanRecorder:
    """Records every plan the planner module fetches -- (x, fail_counts,
    spill) of a per-group plan, the (x, fail_counts, spill) rows of a fused
    chunk -- so two ticks can be held against each other plan by plan."""

    def __init__(self):
        self.plans = []
        self._saved = None

    def __enter__(self):
        import numpy as np
        from swarmkit_tpu_torch.ops import planner as planner_mod
        fetch, unpack = planner_mod.fetch_plan, planner_mod.unpack_fused

        def fetch_plan(pending, n):
            x, fail, spill = fetch(pending, n)
            self.plans.append(("group", np.array(x), np.array(fail),
                               np.array(bool(spill))))
            return x, fail, spill

        def unpack_fused(rows, n):
            xs, fails, spills = unpack(rows, n)
            self.plans.append(("fused", np.array(xs), np.array(fails),
                               np.array(spills)))
            return xs, fails, spills

        self._saved = (planner_mod, fetch, unpack)
        planner_mod.fetch_plan = fetch_plan
        planner_mod.unpack_fused = unpack_fused
        return self

    def __exit__(self, *exc):
        planner_mod, fetch, unpack = self._saved
        planner_mod.fetch_plan = fetch
        planner_mod.unpack_fused = unpack
        return False


def same_plans(a, b):
    """True when two recorded ticks fetched equal plans in equal order."""
    import numpy as np
    return len(a) == len(b) and all(
        pa[0] == pb[0] and all(np.array_equal(u, v)
                               for u, v in zip(pa[1:], pb[1:]))
        for pa, pb in zip(a, b))


#: processes of ``probes/kernel_ab.py --fills`` run one after the other;
#: each profiled fill of the mesh phase is held to their median, so that
#: one process's outlier decides nothing (on an H100 80GB HBM3, K11 once
#: read 0.0135 ms in the probe's process against 0.0170 ms in this
#: script's session of the same run, its usual reading)
FILLS_PROBE_RUNS = 3


def card_uuid(torch):
    """The card's UUID as torch reports it (None where this torch does
    not)."""
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
    return None if uuid is None else str(uuid)


def fills_probe():
    """K5's, K10's and K11's rows as ``probes/kernel_ab.py --fills``
    measures them in each of FILLS_PROBE_RUNS processes of its own (the
    same inputs and profiler as this script's): each process's record
    (``fills`` and the ``card`` it measured), or a failed phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for _ in range(FILLS_PROBE_RUNS):
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "swarmkit_tpu_torch",
                                          "probes", "kernel_ab.py"),
             "--fills", root],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"kernel_ab.py --fills failed: "
              f"{proc.stderr[-2000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def phase_kernels_mesh(torch, K):
    """K10, K11 and K2 over the shard table on four shards of the card
    against their plain versions on the same tensors, node bucket 16384.
    K10 is timed at the headline path's leaf fill (L = 256, its kernels
    row) and at one segment a row (L = 16,384), K11 at the binpack case,
    K2 at the headline's leaf level (L = 256).  K10's and K11's
    profiler rows must agree within 15% with the median of
    ``probes/kernel_ab.py``'s profiles of the same calls in
    FILLS_PROBE_RUNS processes of their own, each on this card."""
    dev = torch.device("cuda")
    d = MESH_SHARDS
    nb = 16384
    rows, per_case = [], {}
    errs = {K.SHARD_WATERFILL.name: 0, K.SHARD_PACKFILL.name: 0}
    timed = {}
    cases = [(case, kw, fill_parts(shard_fill_inputs(31, **kw), d, dev))
             for case, kw in SHARD_FILL_CASES.items()]
    cases += [(f"packfill_{case}", dict(L=1, pack=True),
               fill_parts(pack_edge_inputs(33, nb, case), d, dev))
              for case in PACK_EDGE_CASES]
    parts, L = headline_fill_parts(d, dev)
    cases.append(("waterfill_headline", dict(L=L), parts))
    # one segment a row: the shape of the per-host spread's leaf fill
    wide = dict(L=16384)
    cases.append(("waterfill_L16384", wide,
                  fill_parts(shard_fill_inputs(31, **wide), d, dev)))
    for case, kw, parts in cases:
        if kw.get("pack"):
            kern = K.SHARD_PACKFILL

            def run(parts=parts):
                K._shard_packfill(parts)

            def plain(parts=parts):
                return K._shard_packfill_plain(parts)
        else:
            kern = K.SHARD_WATERFILL
            L = kw["L"]

            def run(parts=parts, L=L):
                K._shard_waterfill(parts, L)

            def plain(parts=parts, L=L):
                return K._shard_waterfill_plain(parts, L)
        before = kern.launches
        run()
        torch.cuda.synchronize()
        launches = kern.launches - before
        check(launches == 1, f"{kern.name} ({case}): {launches} launches "
              "a fill, not one")
        got = torch.cat([p.out for p in parts])
        err = max_abs_err(torch, (got,), (torch.cat(plain()),))
        errs[kern.name] = max(errs[kern.name], err)
        check(err == 0, f"{kern.name} ({case}): differs from its plain "
              f"version on the card (max abs err {err})")
        per_case[case] = dict(launches_per_call=launches,
                              placed=int(got.to(torch.int64).sum()))
        if case in ("waterfill_headline", "packfill", "waterfill_L16384"):
            timed[case] = (kern, run, plain, kw)
        print(f"mesh kernels: {kern.name} ({case}, {d} shards x "
              f"{parts[0].cap.shape[0]} rows, L = {kw['L']}) == plain, "
              f"{launches} launch per call, placed "
              f"{per_case[case]['placed']}", flush=True)

    for case in ("waterfill_headline", "packfill", "waterfill_L16384"):
        kern, run, plain, kw = timed[case]
        L = kw["L"]
        if kern is K.SHARD_WATERFILL:
            # svc, failures, cap, total, seg in, x out; k per shard
            nbytes, ops = nb * 24 + d * L * 4, K.WATERFILL_STEPS * nb * 4
            symbol = "ShardElems"
        else:
            # res_cap, failures, cap in, x out; k per shard
            nbytes, ops = 16 * nb + 4 * d, PACK_OPS * nb
            symbol = "ShardRows"
        row = dict(
            kernel=kern, err=errs[kern.name], bytes=nbytes, ops=ops, L=L,
            device_ms=device_ms(torch, run, (symbol,), reps=10,
                                label=f"{kern.name} {case}"),
            ms=time_ms(torch, run, reps=20, warmup=3),
            plain_ms=time_ms(torch, plain, reps=3, warmup=1),
            library_ms=None, launches_per_call=1)
        if case == "waterfill_L16384":
            per_case[case].update(
                {k: v for k, v in row.items() if k != "kernel"})
            r = row
            print(f"mesh kernels: shard_waterfill at L = {L}: "
                  f"{r['ms']:.4f} ms per wrapper call (CUDA events), "
                  f"device {r['device_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound "
                  f"{bound(nbytes, ops)[0]:.7f} ms", flush=True)
        else:
            rows.append(row)
        per_case[case]["device_ms"] = row["device_ms"]

    # ---- the same calls profiled by the probe in processes of their own
    probes = fills_probe()
    here = card_uuid(torch)
    for run in probes:
        check(run["card"] == here, f"kernel_ab.py --fills measured the "
              f"card {run['card']}, not this run's {here}")
    for case, key in (("waterfill_headline", "k10_L256"),
                      ("waterfill_L16384", "k10_L16384"),
                      ("packfill", "k11")):
        mine = per_case[case]["device_ms"]
        seen = [run["fills"][key]["device_ms"] for run in probes]
        theirs = statistics.median(seen)
        per_case[case]["probe_device_ms"] = seen
        check(abs(mine - theirs) <= 0.15 * theirs,
              f"mesh kernels ({case}): this run's profile {mine:.4f} ms "
              f"and the median {theirs:.4f} ms of kernel_ab.py's "
              f"{[round(v, 5) for v in seen]} differ by more than 15%")
        print(f"mesh kernels: {case} device {mine:.4f} ms here, "
              f"{' / '.join(f'{v:.4f}' for v in seen)} ms in "
              f"{FILLS_PROBE_RUNS} runs of kernel_ab.py --fills", flush=True)

    # ---- K2 over the split: ONE launch over the shard table sums the
    # leaf level of a headline group (L = 256, capacity totals past 2^24)
    # over every shard's rows and clamps; held to its plain version (the
    # shards' partials summed in shard order, then the clamps) and to K2
    # on the unsplit columns, twice without a sync, and timed
    nodes_np, group_np, L, hier_np = plan_inputs(
        seed=2024, nb=nb, n_valid=10000, n_leaves=20, k=K.K_CLAMP - 1)
    from swarmkit_tpu_torch.parallel import sharded as S
    shards = S.shard_group(nodes_np, group_np, hier_np,
                           S.make_mesh(["cuda:0"] * d))
    caps = [K._feasibility_plain(nd, gd)[1] for nd, gd, _ in shards]
    parts = [(nd.svc_tasks, nd.valid, cap, nd.leaf, gd.k)
             for (nd, gd, _), cap in zip(shards, caps)]

    def table_sums():
        return K.branch_sums_sharded(parts, L)[0]

    def table_entry():
        """The composition's entry: no input checks, this stream's output
        buffers (as K2's row times the plan's entry)."""
        return K._shard_seg_sum(parts, L)

    def table_plain():
        return K._seg_fold_plain(
            [K._seg_partial_plain(*p[:4], L) for p in parts], parts[0][4])

    before = K.SHARD_SEG_SUM.launches
    got = [table_sums(), table_sums()]
    check(K.SHARD_SEG_SUM.launches - before == 2,
          "K2 over the shard table is not one launch a level")
    want = table_plain()
    unsplit = K.branch_sums(*(torch.cat([p[j] for p in parts])
                              for j in range(4)), L, parts[0][4])
    err = max(max_abs_err(torch, g, want) for g in got + [unsplit])
    check(err == 0, f"K2 over the shard table differs from its plain "
          f"version ({err})")
    check(int(want[2].max()) >= 1 << 24, "the table's inputs must carry "
          "capacity totals above 2^24")
    # the yardstick: one index_add_ of the unsplit (load, capacity) rows
    unsplit_seg = torch.cat([p[3] for p in parts]).to(torch.int64)
    unsplit_vals = torch.stack([
        torch.where(torch.cat([p[1] for p in parts]),
                    torch.clamp(torch.cat([p[0] for p in parts]), 0,
                                K.SVC_CLAMP), 0),
        torch.cat([p[2] for p in parts])]).to(torch.int64)
    unsplit_acc = torch.zeros((2, L), dtype=torch.int64, device=dev)
    # svc, cap, seg (4 B each) and valid (1 B) a node read, k read; load,
    # bcap (4 B each) and raw_cap (8 B) a segment written, kk written
    rows.append(dict(
        kernel=K.SHARD_SEG_SUM, err=err, bytes=13 * nb + 16 * L + 8,
        ops=4 * nb + 4 * L, L=L,
        device_ms=device_ms(torch, table_entry, ("seg_sum_kernel",),
                            reps=50, label="K2 shard table"),
        ms=time_ms(torch, table_entry, reps=20, warmup=3),
        public_ms=time_ms(torch, table_sums, reps=20, warmup=3),
        plain_ms=time_ms(torch, table_plain, reps=20, warmup=3),
        library_ms=time_ms(torch, lambda: unsplit_acc.index_add_(
            1, unsplit_seg, unsplit_vals), reps=20, warmup=3),
        launches_per_call=1))
    per_case["shard_seg_sum"] = dict(public_ms=rows[-1]["public_ms"],
                                     library_ms=rows[-1]["library_ms"])
    for r in rows:
        print(f"mesh kernels: {r['kernel'].name} {r['ms']:.4f} ms per "
              f"wrapper call (CUDA events), device {r['device_ms']:.4f} ms "
              f"(torch.profiler), plain {r['plain_ms']:.4f} ms, bound "
              f"{bound(r['bytes'], r['ops'])[0]:.7f} ms, "
              f"{r['launches_per_call']} launches per call"
              + (f"; the checked public entry {r['public_ms']:.4f} ms"
                 if "public_ms" in r else ""), flush=True)
    return rows, per_case


def phase_mesh_compositions(torch, K, to_device, fused_to_device):
    """Two compositions of the split on four shards of the card at node
    bucket 16384, each against the unsharded plan of the same inputs, with
    its wrapper time (CUDA events) and device time (torch.profiler, every
    device op): B13, a weighted group's plan (the scored K1 per shard,
    then K10 over one segment), and B14, a cfg7 fused chunk (spread,
    binpack, weighted, learned: K1F and each slot's sharded fill per slot,
    K4's carry update per chunk).  Each bound is the sum of its kernels'
    byte counts."""
    import numpy as np
    from swarmkit_tpu_torch.parallel import sharded as S
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    d, nb = MESH_SHARDS, 16384
    mesh = S.make_mesh(["cuda:0"] * d)
    devs = mesh.devices
    out = {}

    nodes_np, group_np, _, _ = plan_inputs(
        seed=2027, nb=nb, n_valid=10000, n_leaves=1, k=80000,
        near_2p24=False)
    rng = np.random.RandomState(2027)
    w1, b1, w2, b2 = strategy_mod.learned_params()
    sin_np = K.StrategyInputs(
        hr_cpu=rng.randint(0, 1024, nb).astype(np.int32),
        hr_mem=rng.randint(0, 1024, nb).astype(np.int32),
        hr_gen=np.full(nb, 1023, np.int32),
        weights=np.array([2, 3, 1, 1], np.int32), w1=w1, b1=b1, w2=w2,
        b2=np.asarray(b2, np.int32))
    shards = [(nd, gd) for nd, gd, _ in
              S.shard_group(nodes_np, group_np, (), mesh)]
    sins = S.shard_to_device(sin_np, K.StrategyInputs, devs)

    def b13():
        return K.plan_strategy_sharded_packed(shards, sins,
                                              K.STRAT_WEIGHTED)

    dev = torch.device("cuda")
    nodes, group, _ = to_device(nodes_np, group_np, (), dev)
    sin = K.StrategyInputs(*(torch.from_numpy(np.asarray(a)).to(dev)
                             for a in sin_np))
    want = K.plan_strategy_packed(nodes, group, sin, K.STRAT_WEIGHTED)
    got = K.merge_shard_rows(torch.stack(b13()).cpu().numpy(), nb)
    check(np.array_equal(got, want.cpu().numpy()), "B13 on four shards "
          "differs from the unsharded weighted plan")
    active_cc = int(((group.con_op == 0) | (group.con_op == 1)).sum())
    plat_used = int((group.plat[:, 0] != -1).sum())
    nbytes = (feasibility_bytes(nodes, group) + 24 * nb + 16
              + 16 * nb + 4 * d)
    ops = (nb * (8 + 3 * active_cc + 6 * plat_used) + 10 * nb
           + K.WATERFILL_STEPS * nb * 4)

    def b13_plain():
        """B13's plain composition on the card: per shard the scored K1's
        plain version (K1's and K6's), then K10's over every shard."""
        parts = []
        for s_, ((nd, gd), sd) in enumerate(zip(shards, sins)):
            cap = K._feasibility_plain(nd, gd)[1]
            parts.append(K.FillShard(
                e=K._strategy_score_plain(nd, sd, K.STRAT_WEIGHTED),
                total=nd.total_tasks, cap=cap,
                k=torch.clamp(gd.k, max=K.K_CLAMP).reshape(1),
                offset=s_ * cap.shape[0]))
        return K._shard_waterfill_plain(parts, 1)

    check(np.array_equal(torch.cat(b13_plain()).cpu().numpy(), got[:nb]),
          "B13's plain composition differs from the kernels'")
    out["B13_weighted"] = dict(
        ms=time_ms(torch, b13, reps=10, warmup=2),
        device_ms=device_ms(torch, b13, ("",), reps=5),
        plain_ms=time_ms(torch, b13_plain, reps=2, warmup=1),
        bound_ms=bound(nbytes, ops)[0], bytes=nbytes)

    inputs = fused_inputs(seed=78)
    L = inputs[4]
    sids = inputs[3].sid.tolist()
    fn = S.ShardedPlanFn(mesh)
    groupss = S.shard_to_device(inputs[1], K.FusedGroups, devs)
    strats = S.shard_to_device(inputs[3], K.FusedStrategy, devs)
    shareds, carries = fn.prepare_fused(inputs[0], inputs[2])
    got = K.merge_shard_rows(np.stack([r.cpu().numpy() for r in (
        K.plan_fused_sharded_packed(shareds, groupss, carries, L, strats,
                                    sids))]), nb)
    cpu_in = fused_to_device(*inputs[:4], device="cpu")
    want = K.plan_fused_packed(*cpu_in[:3], L, cpu_in[3], sids).numpy()
    check(np.array_equal(got, want), "B14: a fused chunk on four shards "
          "differs from the unsharded chunk")

    # B14's bytes: per slot K1F's (fused_entry_bytes, with the previous
    # slot's placements into the carry) and its fill's capacity and level
    # in and placement out (16 N); the chunk's last carry update reads the
    # last slot's placement (4 N) and reads and writes the carry of each
    # node it placed on (48 B)
    nnz = [int(np.count_nonzero(want[g, :nb])) for g in range(len(sids))]
    n_svc = inputs[0].svc0.shape[0]
    nbytes = sum(fused_entry_bytes(inputs[1], g, nb, n_svc, sid, g > 0,
                                   nnz[g - 1] if g > 0 else 0)
                 + 16 * nb for g, sid in enumerate(sids)) \
        + 4 * nb + 48 * nnz[-1]
    b14_ms, b14_dev = time_chunk(
        torch, lambda c: K.plan_fused_sharded_packed(shareds, groupss, c, L,
                                                     strats, sids),
        lambda: fn.prepare_fused(inputs[0], inputs[2])[1],
        lambda bufs: K.merge_shard_rows(np.stack(
            [b.cpu().numpy() for b in bufs]), nb)[:, :nb].sum(1).tolist(),
        want[:, :nb].sum(1).tolist(), "B14", reps=5, warmup=1, dev_reps=3)
    out["B14_chunk"] = dict(ms=b14_ms, device_ms=b14_dev,
                            bound_ms=bound(nbytes, 0)[0], bytes=nbytes)
    for name, r in out.items():
        print(f"mesh compositions: {name} ({d} shards) == unsharded; "
              f"{r['ms']:.4f} ms per call (CUDA events), device "
              f"{r['device_ms']:.4f} ms (torch.profiler, every device op)"
              + (f", bound {r['bound_ms']:.7f} ms" if "bound_ms" in r
                 else "")
              + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r
                 else ""), flush=True)
    return out


def mesh_planner(TorchPlanner, make_mesh, shards=MESH_SHARDS):
    return TorchPlanner(mesh=make_mesh(["cuda:0"] * shards))


def phase_mesh_headline(torch, K, cuda, workload, Task, Scheduler,
                        TorchPlanner, make_mesh, card, want_plans,
                        want_racks):
    """The headline tick through ``TorchPlanner(mesh=...)``, four shards on
    the card: every task placed, every plan equal to the unsharded
    planner's on the same tick."""
    t0 = time.perf_counter()
    store, _, nodes, _ = workload.headline_cluster()
    build_s = time.perf_counter() - t0
    planner = mesh_planner(TorchPlanner, make_mesh)
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    n_pre = len(sched.pending_preassigned_tasks)
    cuda.reset_launch_counts(K.KERNELS)
    with PlanRecorder() as rec:
        t0 = time.perf_counter()
        sched._process_preassigned_tasks()
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
    n_dec += n_pre - len(sched.pending_preassigned_tasks)
    launches = cuda.launch_counts(K.KERNELS)
    stats = dict(planner.stats)
    check(n_dec == workload.HEADLINE_TASKS,
          f"mesh headline: decisions {n_dec} != {workload.HEADLINE_TASKS}")
    for key in ("groups_spill_to_host",) + HOST_ROUTES:
        check(stats.get(key, 0) == 0, f"mesh headline: {key} = "
              f"{stats.get(key)}")
    for k in (K.FEASIBILITY, K.SHARD_SEG_SUM, K.WATERFILL,
              K.SHARD_WATERFILL):
        check(launches[k.name] > 0, f"{k.name} never launched on the mesh "
              "headline path")
    # stage A once a card: one K2 over the shard table and one K3 fill a
    # level (the headline's racks: every level has several values)
    check(launches[K.SEG_SUM.name] == 0
          and launches[K.WATERFILL.name] == launches[K.SHARD_SEG_SUM.name],
          f"mesh headline: stage A not once a level: {launches}")
    check(same_plans(rec.plans, want_plans),
          f"mesh headline: {len(rec.plans)} plans differ from the "
          f"unsharded tick's {len(want_plans)}")
    by_id = {n.id: n for n in nodes}
    racks = Counter(rack_of(by_id[t.node_id]) for t in store.view(
        lambda tx: tx.find(Task)) if t.node_id)
    check(sorted(racks.values()) == want_racks,
          "mesh headline: rack counts differ from the unsharded tick's")
    rate = n_dec / tick_s
    print(f"mesh headline ({MESH_SHARDS} shards on one card): {n_dec} "
          f"decisions in {tick_s:.3f} s ({rate:.0f} decisions/s; cluster "
          f"build {build_s:.1f} s) on {card}; {len(rec.plans)} plans == "
          f"unsharded; shard_waterfill launches "
          f"{launches['shard_waterfill']}; launches {launches}", flush=True)
    return dict(decisions=n_dec, tick_s=tick_s, decisions_per_s=rate,
                cluster_build_s=build_s, launches=launches,
                plans=len(rec.plans), plan_seconds=stats["plan_seconds"])


def phase_mesh_many_service(torch, K, cuda, workload, Task, Scheduler,
                            TorchPlanner, make_mesh, card, want_plans,
                            want_counts):
    """Config 7 through ``TorchPlanner(mesh=...)``: the fused route split
    over four shards (binpack through K11), every chunk's rows and the
    per-(service, node) counts equal to the unsharded tick's."""
    t0 = time.perf_counter()
    store, services, nodes, _ = workload.many_service_cluster()
    build_s = time.perf_counter() - t0
    planner = mesh_planner(TorchPlanner, make_mesh)
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    cuda.reset_launch_counts(K.KERNELS)
    with PlanRecorder() as rec:
        t0 = time.perf_counter()
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
    launches = cuda.launch_counts(K.KERNELS)
    stats = dict(planner.stats)
    n_tasks = workload.MANY_SERVICE_TASKS
    check(n_dec == n_tasks, f"mesh many-service: decisions {n_dec}")
    check(stats.get("groups_fused") == len(workload.MANY_SERVICE_MIX)
          and stats.get("fused_chunks") == 3,
          f"mesh many-service: not every group fused: {stats}")
    for key in ("groups_planned", "groups_spill_to_host", "fused_overflows",
                "fused_mesh_indivisible") + HOST_ROUTES:
        check(stats.get(key, 0) == 0, f"mesh many-service: {key} = "
              f"{stats.get(key)}")
    for k in (K.SHARD_SEG_SUM, K.WATERFILL, K.SHARD_WATERFILL,
              K.SHARD_PACKFILL, K.FUSED_FEASIBILITY, K.FUSED_SCORED,
              K.FUSED_CARRY):
        check(launches[k.name] > 0, f"{k.name} never launched on the mesh "
              "many-service path")
    total = check_fused_launches(
        K, launches, len(workload.MANY_SERVICE_MIX), stats["fused_chunks"],
        "mesh many-service", MESH_SHARDS, mix=workload.MANY_SERVICE_MIX)
    check(launches[K.PACKFILL.name] == 0,
          "the unsharded pack fill ran on the mesh path")
    check(launches[K.SHARD_PACKFILL.name] == 2,
          f"K11 launched {launches[K.SHARD_PACKFILL.name]} times for the "
          "two binpack groups, not once a fill")
    check(same_plans(rec.plans, want_plans),
          "mesh many-service: chunk rows differ from the unsharded tick's")
    counts = service_counts(store, Task, services, nodes)
    check(counts == want_counts, "mesh many-service: per-(service, node) "
          "counts differ from the unsharded tick's")
    rate = n_dec / tick_s
    print(f"mesh many-service ({MESH_SHARDS} shards on one card): {n_dec} "
          f"decisions in {tick_s:.3f} s ({rate:.0f} decisions/s; cluster "
          f"build {build_s:.1f} s) on {card}; {len(rec.plans)} chunks == "
          f"unsharded; {total} launches {launches}", flush=True)
    return dict(decisions=n_dec, tick_s=tick_s, decisions_per_s=rate,
                cluster_build_s=build_s, launches=launches,
                launches_total=total, plan_seconds=stats["plan_seconds"])


def victims_at_calls(torch, P, victims_to_device, calls):
    """K9 on the inputs of recorded ``select_victims`` calls (config 8's
    shape: node bucket 1024, V = 4): bit-equal to its plain version, and
    per call the wrapper ms (CUDA events) and the prefix and pick
    kernels' device ms (torch.profiler).  Returns (max abs err, rows)."""
    from swarmkit_tpu_torch.ops.densify import n_bucket
    dev = torch.device("cuda")
    err, out = 0, []
    for cand, args, _, _ in calls:
        nb = n_bucket(max(cand.ok.shape[0], 1))
        pb = P.pick_bucket(args[3])
        inp = victims_to_device(cand, nb, dev)
        args = tuple(int(a) for a in args)

        def run(inp=inp, args=args, pb=pb):
            return P.select_victims(inp, *args, pb)

        e = max_abs_err(torch, (run(),), (P._select_victims_plain(
            inp, *args, pb),))
        check(e == 0, f"K9 at config 8's call (nb {nb}, V {cand.vb}): "
              "kernel differs from its plain version")
        err = max(err, e)
        prefix_dev, pick_dev = device_ms_each(
            torch, run, (("victim_prefix_kernel",), ("victim_pick_kernel",)))
        out.append(dict(nb=nb, v=int(cand.vb), pb=pb, n_picks=args[3],
                        ms=time_ms(torch, run, reps=20, warmup=3),
                        prefix_device_ms=prefix_dev,
                        pick_device_ms=pick_dev))
        r = out[-1]
        print(f"kernels: select_victims at config 8's call (nb {nb}, V "
              f"{r['v']}, pb {pb}, {args[3]} picks asked) == plain: "
              f"{r['ms']:.4f} ms per wrapper call, device "
              f"{prefix_dev:.4f} ms prefix + {pick_dev:.4f} ms picks",
              flush=True)
    return err, out


def phase_kernels_victims(torch, P, victims_to_device, config8_calls):
    """K9 against its plain version on the card at node bucket 16384 for
    V = 4, 16 and 64, 512 picks: a full run, a budget stop and an
    infeasible stop each, bit-equal.  Times at each V on the full run, and
    at config 8's shape on the inputs of its recorded calls."""
    from swarmkit_tpu_torch.ops.densify import n_bucket
    dev = torch.device("cuda")
    per_v, err = {}, 0
    for v in (4, 16, 64):
        for case in VICTIM_CASES:
            cand, args = victim_inputs(900 + v, v, case)
            n_picks = args[3]
            pb = P.pick_bucket(n_picks)
            nb = n_bucket(cand.ok.shape[0])
            stages = {}
            inp = victims_to_device(cand, nb, dev, stages)
            got = P.select_victims(inp, *args, pb)
            want = P._select_victims_plain(inp, *args, pb)
            e = max_abs_err(torch, (got,), (want,))
            check(e == 0 and torch.equal(got, want),
                  f"K9 (V={v}, {case}): kernel differs from its plain version")
            err = max(err, e)
            picks = int((want[:pb] >= 0).sum())
            rich = P.select_victims(inp, *args[:4], 1 << 20, pb)
            more = int((rich[:pb] >= 0).sum())
            if case == "full":
                check(picks == n_picks, f"K9 (V={v}): {picks} of {n_picks} "
                      "picks on the full run")
            elif case == "budget_stop":
                check(picks < more, f"K9 (V={v}): the budget never stopped "
                      f"the run ({picks} picks, {more} without it)")
            else:
                check(picks == more < n_picks, f"K9 (V={v}): no infeasible "
                      f"stop ({picks} / {more} of {n_picks} picks)")
            print(f"kernels: select_victims (V={v}, {case}, nb={nb}) == plain "
                  f"on the card: {picks} picks of {n_picks}", flush=True)
            if case != "full":
                continue
            (stage,) = stages.values()
            prefix_dev, pick_dev = device_ms_each(
                torch, lambda: P.select_victims(inp, *args, pb),
                (("victim_prefix_kernel",), ("victim_pick_kernel",)))
            t0 = time.perf_counter()
            for _ in range(5):
                victims_to_device(cand, nb, dev, stages)
            torch.cuda.synchronize()
            prep_ms = (time.perf_counter() - t0) / 5 * 1e3
            need = victim_need(cand, args, picks_of(*want.view(2, -1)), nb,
                               pb)
            per_v[v] = dict(
                kernel=P.VICTIMS, err=0, picks=picks, nb=nb, pb=pb,
                bytes=need[0], ops=need[1],
                ms=time_ms(torch, lambda: P.select_victims(
                    inp, *args, pb), reps=20, warmup=3),
                prefix_device_ms=prefix_dev, pick_device_ms=pick_dev,
                plain_ms=time_ms(torch, lambda: P._select_victims_plain(
                    inp, *args, pb), reps=2, warmup=1),
                h2d_ms=time_ms(torch, lambda: stage.dev.copy_(
                    stage.host, non_blocking=True), reps=20, warmup=2),
                h2d_bytes=int(stage.host.numel()),
                pack_and_upload_ms=prep_ms, library_ms=None)
            r = per_v[v]
            r["device_ms"] = r["prefix_device_ms"] + r["pick_device_ms"]
            dev_txt = (f"{r['prefix_device_ms']:.4f} ms prefix + "
                       f"{r['pick_device_ms']:.4f} ms picks (torch.profiler)")
            print(f"kernels: select_victims (V={v}, {picks} picks) "
                  f"{r['ms']:.4f} ms per wrapper call (CUDA events), device "
                  f"{dev_txt}, plain {r['plain_ms']:.2f} ms, H2D "
                  f"{r['h2d_ms']:.4f} ms for {r['h2d_bytes']} bytes (pack + "
                  f"upload {prep_ms:.3f} ms), {r['bytes']} bytes, bound "
                  f"{bound(r['bytes'], r['ops'])[0]:.7f} ms", flush=True)
    err8, config8 = victims_at_calls(torch, P, victims_to_device,
                                     config8_calls)
    row = dict(per_v[16])
    row["err"] = max(err, err8)
    record = {f"select_victims_v{v}": {k: x for k, x in r.items()
                                       if k != "kernel"}
              for v, r in per_v.items()}
    record["select_victims_config8"] = config8
    return [row], record


def spy_on_victims(planner):
    """Wrap ``planner.select_victims`` so each call's (candidates,
    arguments, picks, seconds) is kept; returns that list."""
    calls = []
    orig = planner.select_victims

    def spy(cand, *args):
        t0 = time.perf_counter()
        picks = orig(cand, *args)
        calls.append((cand, args, picks, time.perf_counter() - t0))
        return picks
    planner.select_victims = spy
    return calls


class PreemptSteps:
    """Wall seconds of the preemption pass's host steps while in use:
    the candidate build (``build_candidates``) and the commits
    (``Scheduler._commit_preemption``), wrapped where the scheduler looks
    them up and restored on exit."""

    def __init__(self, Scheduler):
        from swarmkit_tpu_torch.scheduler import preempt as hp
        self.targets = ((hp, "build_candidates", "build_candidates_s"),
                        (Scheduler, "_commit_preemption", "commit_s"))
        self.seconds = {key: 0.0 for _, _, key in self.targets}

    def __enter__(self):
        self.saved = []
        for owner, name, key in self.targets:
            orig = getattr(owner, name)
            self.saved.append((owner, name, orig))

            def timed(*args, _orig=orig, _key=key, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*args, **kw)
                finally:
                    self.seconds[_key] += time.perf_counter() - t0
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self.saved:
            setattr(owner, name, orig)


def preempt_outcome(store, Task, nodes):
    """(live tasks per (service, node hostname), sorted victim ids)."""
    from swarmkit_tpu_torch.models import TaskState
    host = {n.id: n.description.hostname for n in nodes}
    tasks = store.view(lambda tx: tx.find(Task))
    live = Counter((t.service_id, host[t.node_id]) for t in tasks
                   if t.node_id and t.desired_state <= TaskState.COMPLETE)
    victims = sorted(t.id for t in tasks
                     if "swarm.preempted.at" in t.annotations.labels)
    return live, victims


def phase_priority_jobs(torch, K, P, cuda, workload, Task, Scheduler,
                        TorchPlanner, card):
    """bench.py's config 8 through ``TorchPlanner()``: every arrival
    placed with preemptions, K9 launched once per preempting group, each
    call's picks equal to the host oracle's, and the live tasks per
    (service, node) and the victims equal to the host path's."""
    from swarmkit_tpu_torch.models import TaskState
    from swarmkit_tpu_torch.scheduler import preempt as hp
    from swarmkit_tpu_torch.utils.metrics import registry
    out, outcome = {}, {}
    for label, planner in (("card", TorchPlanner()), ("host", None)):
        store, _, nodes, tasks = workload.priority_jobs()
        calls = spy_on_victims(planner) if planner is not None else []
        pre0 = registry.get_counter('swarm_preemptions{reason="priority"}')
        cuda.reset_launch_counts(K.KERNELS + P.KERNELS)
        with PreemptSteps(Scheduler) as steps:
            sched, n_dec, tick_s = workload.preempt_tick(
                store, planner, workload.PRIORITY_JOBS_BUDGET)
            torch.cuda.synchronize()
        launches = cuda.launch_counts(K.KERNELS + P.KERNELS)
        preemptions = int(registry.get_counter(
            'swarm_preemptions{reason="priority"}') - pre0)
        after = {t.id: t for t in store.view(lambda tx: tx.find(Task))}
        arrivals = [t for t in tasks if t.service_id != "band-lo"]
        check(all(after[t.id].node_id and after[t.id].status.state
                  == TaskState.ASSIGNED for t in arrivals),
              f"config 8 ({label}): not every arrival was assigned")
        check(preemptions > 0, f"config 8 ({label}): no preemption")
        if planner is not None:
            check(launches["select_victims"] == len(calls) > 0,
                  f"config 8: {launches['select_victims']} K9 launches for "
                  f"{len(calls)} select_victims calls")
            for cand, args, picks, _ in calls:
                check(picks == hp.select_victims_host(cand, *args),
                      f"config 8: K9's picks differ from the host oracle's "
                      f"(V={cand.vb}, args {args})")
        outcome[label] = preempt_outcome(store, Task, nodes)
        if planner is not None:
            card_calls = calls
        out[label] = dict(decisions=n_dec, tick_s=tick_s,
                          decisions_per_s=n_dec / tick_s,
                          preemptions=preemptions, launches=launches,
                          select_victims_calls=len(calls),
                          select_victims_s=sum(c[3] for c in calls),
                          picks=[len(c[2]) for c in calls],
                          v_buckets=[c[0].vb for c in calls], **steps.seconds)
        print(f"config 8 ({label}): {n_dec} decisions in {tick_s:.3f} s "
              f"({n_dec / tick_s:.0f} decisions/s) on {card}; preemption "
              f"pass: candidates {steps.seconds['build_candidates_s']:.3f} s,"
              f" selection {out[label]['select_victims_s']:.3f} s, commits "
              f"{steps.seconds['commit_s']:.3f} s; "
              f"{preemptions} preemptions, {len(arrivals)} arrivals assigned; "
              f"select_victims calls {len(calls)} (picks "
              f"{out[label]['picks']}, V {out[label]['v_buckets']}); "
              f"launches {launches}", flush=True)
    check(outcome["card"][0] == outcome["host"][0],
          "config 8: live tasks per (service, node) differ from the host "
          "path's")
    check(outcome["card"][1] == outcome["host"][1],
          "config 8: the victims differ from the host path's")
    print(f"config 8: card == host path (live tasks per service and node; "
          f"{len(outcome['card'][1])} victims); every call's picks == "
          "select_victims_host", flush=True)
    return out, card_calls


def picks_of(nodes, ms):
    return [(int(j), int(m)) for j, m in zip(nodes.tolist(), ms.tolist())
            if j >= 0]


def phase_storm(torch, K, P, cuda, workload, Task, Scheduler, TorchPlanner,
                victims_to_device, tracer, card):
    """The priority storm at the headline width through ``TorchPlanner()``:
    every arrival placed, each call's picks equal to the plain version on
    the card and on the CPU; its traced twin; and at 1,000 nodes, each
    call's picks equal to the host oracle's."""
    from swarmkit_tpu_torch.models import TaskState
    from swarmkit_tpu_torch.ops.densify import n_bucket
    from swarmkit_tpu_torch.scheduler import preempt as hp
    t0 = time.perf_counter()
    store, _, _, _ = workload.priority_storm()
    build_s = time.perf_counter() - t0
    planner = TorchPlanner()
    calls = spy_on_victims(planner)
    cuda.reset_launch_counts(K.KERNELS + P.KERNELS)
    with PreemptSteps(Scheduler) as steps:
        sched, n_dec, tick_s = workload.preempt_tick(store, planner,
                                                     workload.STORM_BUDGET)
        torch.cuda.synchronize()
    launches = cuda.launch_counts(K.KERNELS + P.KERNELS)

    def placed(store):
        return sum(1 for t in store.view(lambda tx: tx.find(Task))
                   if t.service_id == "band-storm" and t.node_id
                   and t.status.state == TaskState.ASSIGNED)

    n_placed = placed(store)
    check(n_placed == workload.STORM_ARRIVALS,
          f"storm: {n_placed} of {workload.STORM_ARRIVALS} arrivals placed")
    check(launches["select_victims"] == len(calls) >= 1,
          f"storm: {launches['select_victims']} K9 launches for "
          f"{len(calls)} calls")
    plain_s = {}
    for cand, args, picks, _ in calls:
        nb, pb = n_bucket(cand.ok.shape[0]), P.pick_bucket(args[3])
        for where in ("cuda", "cpu"):
            inp = victims_to_device(cand, nb, where)
            t = time.perf_counter()
            want = picks_of(*P._select_victims_plain(inp, *args,
                                                     pb).view(2, -1))
            plain_s[where] = time.perf_counter() - t
            check(picks == want, f"storm: K9's picks differ from the plain "
                  f"version on {where} (V={cand.vb}, nb={nb})")
    select_s = sum(c[3] for c in calls)
    print(f"storm: {n_dec} decisions in {tick_s:.3f} s ({n_dec / tick_s:.0f}"
          f" decisions/s; cluster build {build_s:.1f} s) on {card}; "
          f"preemption pass: candidates "
          f"{steps.seconds['build_candidates_s']:.3f} s, selection "
          f"{select_s:.4f} s, commits {steps.seconds['commit_s']:.3f} s; "
          f"{n_placed} arrivals placed; select_victims calls {len(calls)} "
          f"(picks {[len(c[2]) for c in calls]}, V "
          f"{[c[0].vb for c in calls]}) == plain on the card and on the CPU "
          f"(plain {plain_s.get('cuda', 0):.2f} s / "
          f"{plain_s.get('cpu', 0):.2f} s); launches {launches}", flush=True)
    out = dict(decisions=n_dec, tick_s=tick_s, decisions_per_s=n_dec / tick_s,
               cluster_build_s=build_s, placed=n_placed, launches=launches,
               select_victims_calls=len(calls), select_victims_s=select_s,
               picks=[len(c[2]) for c in calls],
               plain_s=plain_s, **steps.seconds)

    # the traced twin
    store, _, _, _ = workload.priority_storm()
    sched = Scheduler(store, batch_planner=TorchPlanner(),
                      preempt_budget=workload.STORM_BUDGET)
    store.view(sched._setup_tasks_list)
    out["traced"] = traced(torch, tracer, sched.tick, card,
                           "traced storm tick")
    check(placed(store) == workload.STORM_ARRIVALS,
          "traced storm: not every arrival placed")

    # the host oracle, at 1,000 nodes
    store, _, _, _ = workload.priority_storm(n_nodes=1000)
    planner = TorchPlanner()
    small = spy_on_victims(planner)
    workload.preempt_tick(store, planner, workload.STORM_BUDGET)
    check(placed(store) == workload.STORM_ARRIVALS and small,
          "storm at 1,000 nodes: not every arrival placed")
    for cand, args, picks, _ in small:
        check(picks == hp.select_victims_host(cand, *args),
              "storm at 1,000 nodes: K9's picks differ from the host oracle's")
    print(f"host oracle: storm_1k K9 picks == select_victims_host "
          f"({sum(len(c[2]) for c in small)} picks)", flush=True)
    out["oracle_1k_picks"] = sum(len(c[2]) for c in small)
    return out


def phase_wide_spread(torch, K, cuda, workload, Task, Scheduler,
                      TorchPlanner, make_mesh, card):
    """The fused tick of two per-host spreads (8,200 nodes, 16,384 leaf
    segments) on the card: the placements of the CPU plain path, both
    groups fused, none on the host; then the same tick over four shards of
    the card, equal to the unsharded one."""

    def tick(planner):
        t0 = time.perf_counter()
        store, _, _ = workload.per_host_spread()
        build_s = time.perf_counter() - t0
        sched = Scheduler(store, batch_planner=planner, pipeline_depth=2)
        store.view(sched._setup_tasks_list)
        t0 = time.perf_counter()
        n_dec = sched.tick()
        if planner.device.type == "cuda":
            torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
        placed = sorted((t.id, t.node_id)
                        for t in store.view(lambda tx: tx.find(Task)))
        return placed, dict(decisions=n_dec, tick_s=tick_s,
                            cluster_build_s=build_s,
                            stats=dict(planner.stats))

    n_tasks = sum(workload.PER_HOST_SERVICES)
    want, cpu_run = tick(TorchPlanner(device="cpu"))
    out = {"cpu": cpu_run}
    for posture, planner in (("card", TorchPlanner()),
                             ("mesh", mesh_planner(TorchPlanner, make_mesh))):
        cuda.reset_launch_counts(K.KERNELS)
        got, run = tick(planner)
        run["launches"] = cuda.launch_counts(K.KERNELS)
        stats, launches = run["stats"], run["launches"]
        check(run["decisions"] == n_tasks, f"per-host spread ({posture}): "
              f"decisions {run['decisions']} != {n_tasks}")
        check(got == want, f"per-host spread ({posture}): placements differ "
              "from the CPU plain path's")
        check(stats.get("groups_fused") == 2, f"per-host spread "
              f"({posture}): groups_fused {stats.get('groups_fused')}")
        for key in ("groups_planned", "groups_spill_to_host") \
                + HOST_ROUTES:
            check(stats.get(key, 0) == 0, f"per-host spread ({posture}): "
                  f"{key} = {stats.get(key)}")
        fills = (K.SHARD_SEG_SUM, K.SHARD_WATERFILL) if posture == "mesh" \
            else (K.SEG_SUM,)
        for k in (K.WATERFILL, K.FUSED_FEASIBILITY, K.FUSED_CARRY) + fills:
            check(launches[k.name] > 0, f"{k.name} never launched on the "
                  f"per-host spread path ({posture})")
        check_fused_launches(K, launches, 2, stats["fused_chunks"],
                             f"per-host spread ({posture})",
                             MESH_SHARDS if posture == "mesh" else 1)
        out[posture] = run
        print(f"per-host spread ({posture}): {run['decisions']} decisions "
              f"in {run['tick_s']:.3f} s on {card} (CPU plain path "
              f"{cpu_run['tick_s']:.3f} s), placements == CPU, "
              f"groups_fused 2, launches {launches}", flush=True)
    return out


def rack_of(node):
    return node.spec.annotations.labels.get("rack")


def phase_main_path(torch, K, cuda, workload, Task, Scheduler,
                    TorchPlanner, card):
    """The headline tick through the port's entry points (the per-group
    route: one service never fuses)."""
    t0 = time.perf_counter()
    store, _, nodes, _ = workload.headline_cluster()
    build_s = time.perf_counter() - t0
    planner = TorchPlanner()
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    n_pre = len(sched.pending_preassigned_tasks)
    cuda.reset_launch_counts(K.KERNELS)
    with PlanRecorder() as rec:
        t0 = time.perf_counter()
        sched._process_preassigned_tasks()
        k1_preassigned = K.FEASIBILITY.launches
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
    n_dec += n_pre - len(sched.pending_preassigned_tasks)
    launches = cuda.launch_counts(K.KERNELS)
    stats = dict(planner.stats)
    check(n_dec == workload.HEADLINE_TASKS,
          f"decisions {n_dec} != {workload.HEADLINE_TASKS}")
    check(stats["tasks_planned"] == workload.HEADLINE_TASKS,
          f"tasks_planned {stats['tasks_planned']}")
    for key in ("groups_spill_to_host", "groups_strategy_host") \
            + HOST_ROUTES:
        check(stats.get(key, 0) == 0, f"{key} = {stats.get(key)}")
    for k in (K.FEASIBILITY, K.SEG_SUM, K.WATERFILL):
        check(launches[k.name] > 0, f"{k.name} never launched on the "
              "headline path")
    check(k1_preassigned >= 1, "the preassigned batch did not go through "
          "the feasibility kernel")
    by_id = {n.id: n for n in nodes}
    tasks = store.view(lambda tx: tx.find(Task))
    racks = Counter(rack_of(by_id[t.node_id]) for t in tasks if t.node_id)
    check(sum(racks.values()) == workload.HEADLINE_TASKS,
          "not every task holds a node")
    check(max(racks.values()) - min(racks.values()) <= 1,
          f"racks unbalanced: {sorted(racks.values())}")
    rate = n_dec / tick_s
    print(f"main path: {n_dec} decisions in {tick_s:.3f} s "
          f"({rate:.0f} decisions/s; cluster build {build_s:.1f} s) on "
          f"{card}; launches {launches}; stats "
          f"{ {k: v for k, v in stats.items() if k != 'plan_seconds'} }",
          flush=True)
    return dict(decisions=n_dec, tick_s=tick_s, decisions_per_s=rate,
                preassigned_feasibility_launches=k1_preassigned,
                cluster_build_s=build_s, launches=launches,
                plan_seconds=stats["plan_seconds"],
                rack_counts=sorted(racks.values())), rec.plans


def phase_traced_tick(torch, build, Scheduler, TorchPlanner, tracer, card,
                      label="traced tick"):
    """A second tick of the cluster ``build()`` makes, with the span tracer
    and torch.profiler on: where the tick's wall time goes, and the
    device's busy share.  The untraced tick of its path gives the
    end-to-end numbers."""
    store = build()[0]
    sched = Scheduler(store, batch_planner=TorchPlanner())
    store.view(sched._setup_tasks_list)

    def tick():
        sched._process_preassigned_tasks()
        sched.tick()

    return traced(torch, tracer, tick, card, label)


class GcClock:
    """The cyclic garbage collector's collections while ``on`` is set:
    (generation, seconds) each.  Registered as a ``gc.callbacks`` entry
    while it is entered."""

    def __init__(self):
        self.on = False
        self.runs = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter() if self.on else None
        elif self._t0 is not None:
            self.runs.append((info["generation"],
                              time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def by_generation(self):
        """{generation: (collections, seconds)}."""
        out = {}
        for gen, sec in self.runs:
            n, s = out.get(gen, (0, 0.0))
            out[gen] = (n + 1, s + sec)
        return dict(sorted(out.items()))


def traced(torch, tracer, fn, card, label):
    """Run ``fn`` under the span tracer and torch.profiler (a
    :func:`profiled` session, whose warm-up is kept out of the wall time
    and the sums): span sums, device rows and the device's busy share of
    the wall time, with the count of ``fn``'s kernel launches that show
    no device row (a tick cannot be run again: where it is not 0, the busy
    time is short by their rows)."""
    wall = []
    clock = GcClock()

    def body():
        tracer.reset()
        tracer.enable()
        clock.on = True
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        clock.on = False
        tracer.disable()

    with clock:
        events, session = profiled(torch, body)
    collections = clock.by_generation()
    PROFILE_LOG.append(dict(label=label, session=session))
    wall = wall[0]
    spans = Counter()
    for sp in tracer.spans():
        spans[sp.name] += sp.duration
    by_op = Counter()
    for name, us in events:
        by_op[name[:60]] += us / 1e3
    device_s = sum(by_op.values()) / 1e3
    busy = device_s / wall if device_s > 0 else None
    top = ", ".join(f"{name} {sec * 1e3:.1f} ms"
                    for name, sec in spans.most_common(12))
    ops = ", ".join(f"{name} {ms:.3f} ms"
                    for name, ms in by_op.most_common(8))
    print(f"{label}: {wall:.3f} s wall; device busy "
          + (f"{device_s * 1e3:.3f} ms ({busy:.4%} of the wall time)"
             if busy is not None else "not measured")
          + f" ({session['missing']} launches without a device row) on "
          f"{card}; spans: {top}; device rows: {ops}; garbage collections "
          "in it: " + (", ".join(f"gen {g} x{n} {sec * 1e3:.1f} ms"
                                 for g, (n, sec) in collections.items())
                       or "none"), flush=True)
    return dict(wall_s=wall, device_busy_s=device_s or None,
                gc_by_generation={str(g): dict(collections=n, seconds=sec)
                                  for g, (n, sec) in collections.items()},
                device_busy_share=busy, launches_without_row=session[
                    "missing"],
                spans_s={k: v for k, v in spans.most_common()},
                device_ms_by_row=dict(by_op.most_common()))


def phase_host_oracle(workload, Task, Platform, TorchPlanner):
    """Per-node counts of the card's planner equal the host path's."""
    shapes = {
        "rack_spread_1k": dict(prefs=workload.rack_spread(),
                               global_share=0.2),
        "constrained_1k": dict(
            node_labels=lambda i: {"tier": "web" if i % 2 else "db",
                                   "rack": f"r{i % 40}"},
            node_platform=lambda i: {"os": "linux" if i % 10 else "windows",
                                     "architecture": "amd64"},
            constraints=["node.labels.tier==web"],
            platforms=[Platform(os="linux", architecture="amd64")]),
    }
    out = {}
    for name, kw in shapes.items():
        counts = []
        for planner in (TorchPlanner(), None):
            store, _, nodes, _ = workload.build_cluster(1000, 10000, **kw)
            workload.one_tick(store, planner)
            host = {n.id: n.description.hostname for n in nodes}
            counts.append(Counter(host[t.node_id] for t in store.view(
                lambda tx: tx.find(Task)) if t.node_id))
            if planner is not None:
                check(planner.stats.get("groups_planned", 0) >= 1,
                      f"{name}: the card planned no group")
        check(counts[0] == counts[1],
              f"{name}: card placements differ from the host path")
        out[name] = sum(counts[0].values())
        print(f"host oracle: {name} card == host ({out[name]} tasks placed)",
              flush=True)
    return out


def service_counts(store, Task, services, nodes):
    """Tasks per (service name, node hostname) in ``store``."""
    name = {s.id: s.spec.annotations.name for s in services}
    host = {n.id: n.description.hostname for n in nodes}
    return Counter((name[t.service_id], host[t.node_id]) for t in store.view(
        lambda tx: tx.find(Task)) if t.node_id)


def check_fused_launches(K, launches, n_groups, chunks, label, shards=1,
                         mix=None):
    """The fused route's slot entries for ``n_groups`` fused groups: one
    K1F launch a group slot (each chunk padded to a power of two; the
    scored instantiation for a weighted or learned slot) and one K4 carry
    update a chunk, each per shard on a mesh, no standalone K1 and no K6
    (the slot entry scores).  With ``mix`` (the groups' strategies, no
    padding slot) every kernel's count must be exactly the route's
    (:func:`fused_tick_launches`); returns the launches in all."""
    from swarmkit_tpu_torch.ops.densify import pow2_bucket
    from swarmkit_tpu_torch.ops.fusedbatch import chunk_sizes
    sizes = chunk_sizes(n_groups)
    check(len(sizes) == chunks, f"{label}: {chunks} chunks, "
          f"{len(sizes)} expected for {n_groups} groups")
    slots = sum(pow2_bucket(c) for c in sizes)
    entries = launches[K.FUSED_FEASIBILITY.name] \
        + launches[K.FUSED_SCORED.name]
    check(entries == slots * shards,
          f"{label}: {entries} K1F launches for {slots} slots x {shards} "
          "shards")
    check(launches[K.FUSED_CARRY.name] == chunks * shards,
          f"{label}: {launches[K.FUSED_CARRY.name]} carry updates for "
          f"{chunks} chunks x {shards} shards")
    check(launches[K.FEASIBILITY.name] == 0,
          f"{label}: K1 launched {launches[K.FEASIBILITY.name]} times on "
          "the fused route")
    check(launches[K.SCORE.name] == 0,
          f"{label}: K6 launched {launches[K.SCORE.name]} times on the "
          "fused route (the slot entry scores)")
    if mix is not None:
        check(slots == len(mix), f"{label}: padding slots")
        want = fused_tick_launches(K, mix, chunks, shards)
        got = {k.name: launches[k.name] for k in K.KERNELS}
        check(got == want, f"{label}: launches {got}, expected {want}")
    return sum(launches[k.name] for k in K.KERNELS)


def fused_tick_launches(K, mix, chunks, shards=1):
    """Every kernel's launches in a fused tick of the groups of ``mix``
    (``workload.MANY_SERVICE_MIX``'s layout; spread groups over one
    spread level of several values) in ``chunks`` chunks, unsharded or
    over ``shards`` shards of the card: per slot K1F (scored for weighted
    and learned), per chunk K4's carry update, each per shard; a spread
    group's stage A (one K2, one K3 fill; on a mesh K2 over the shard
    table) and its leaf fill (K3, on a mesh K10), a weighted or learned
    group's fill (K3 or K10), a binpack group's (K5 or K11)."""
    spread = sum(st == "spread" for st, *_ in mix)
    binpack = sum(st == "binpack" for st, *_ in mix)
    scored = len(mix) - spread - binpack
    want = {k.name: 0 for k in K.KERNELS}
    want[K.FUSED_FEASIBILITY.name] = (spread + binpack) * shards
    want[K.FUSED_SCORED.name] = scored * shards
    want[K.FUSED_CARRY.name] = chunks * shards
    if shards == 1:
        want[K.SEG_SUM.name] = spread
        want[K.WATERFILL.name] = 2 * spread + scored
        want[K.PACKFILL.name] = binpack
    else:
        want[K.SHARD_SEG_SUM.name] = spread
        want[K.WATERFILL.name] = spread
        want[K.SHARD_WATERFILL.name] = spread + scored
        want[K.SHARD_PACKFILL.name] = binpack
    return want


def phase_many_service(torch, K, cuda, workload, Task, Scheduler,
                       TorchPlanner, card):
    """bench.py's config 7 with mixed strategies, one tick through the
    port's entry points: every group fused, every kernel launched."""
    t0 = time.perf_counter()
    store, services, nodes, _ = workload.many_service_cluster()
    build_s = time.perf_counter() - t0
    n_tasks = workload.MANY_SERVICE_TASKS
    planner = TorchPlanner()
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    cuda.reset_launch_counts(K.KERNELS)
    with PlanRecorder() as rec:
        t0 = time.perf_counter()
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
    launches = cuda.launch_counts(K.KERNELS)
    stats = dict(planner.stats)
    n_groups = len(workload.MANY_SERVICE_MIX)
    check(n_dec == n_tasks, f"decisions {n_dec} != {n_tasks}")
    check(stats.get("tasks_planned") == n_tasks,
          f"tasks_planned {stats.get('tasks_planned')}")
    check(stats.get("groups_fused") == n_groups,
          f"groups_fused {stats.get('groups_fused')} != {n_groups}")
    check(stats.get("fused_chunks") == 3,
          f"fused_chunks {stats.get('fused_chunks')} != 3")
    for key in ("groups_strategy_host", "groups_planned",
                "groups_spill_to_host", "fused_overflows") + HOST_ROUTES:
        check(stats.get(key, 0) == 0, f"{key} = {stats.get(key)}")
    for k in K.KERNELS:
        if k in (K.FEASIBILITY, K.SCATTER, K.GANG_FIT, K.SHARD_SEG_SUM,
                 K.SHARD_WATERFILL, K.SHARD_PACKFILL, K.SCORE):
            continue   # the headline, churn, gang and mesh paths' kernels,
            # and K6, which the slot entry's epilogue replaces
        check(launches[k.name] > 0, f"{k.name} never launched on the "
              "many-service path")
    total = check_fused_launches(K, launches, n_groups,
                                 stats["fused_chunks"], "many-service",
                                 mix=workload.MANY_SERVICE_MIX)
    counts = service_counts(store, Task, services, nodes)
    check(sum(counts.values()) == n_tasks, "not every task holds a node")
    by_host = {n.description.hostname: n for n in nodes}
    for svc, (strategy, spread, _) in zip(services,
                                          workload.MANY_SERVICE_MIX):
        if not spread:
            continue
        name = svc.spec.annotations.name
        racks = Counter()
        for (sname, host), c in counts.items():
            if sname == name:
                racks[rack_of(by_host[host])] += c
        check(len(racks) == 20 and max(racks.values())
              - min(racks.values()) <= 1,
              f"{name}: racks unbalanced: {sorted(racks.values())}")
    rate = n_dec / tick_s
    print(f"many-service path: {n_dec} decisions in {tick_s:.3f} s "
          f"({rate:.0f} decisions/s; cluster build {build_s:.1f} s) on "
          f"{card}; {total} launches {launches}; stats "
          f"{ {k: v for k, v in stats.items() if k != 'plan_seconds'} }",
          flush=True)
    return dict(decisions=n_dec, tick_s=tick_s, decisions_per_s=rate,
                cluster_build_s=build_s, launches=launches,
                launches_total=total, plan_seconds=stats["plan_seconds"],
                groups_fused=stats["groups_fused"],
                fused_chunks=stats["fused_chunks"]), rec.plans, counts


def phase_many_service_oracle(workload, Task, Scheduler, TorchPlanner):
    """The card's fused many-service tick places as the host path does:
    tasks per (service, node) equal at 1,000 nodes x 10,000 tasks (spread
    groups place a multiple of the node count, so no tie among equally
    loaded nodes is left to a tie-break order)."""
    counts = []
    for planner in (TorchPlanner(), None):
        store, services, nodes, _ = workload.many_service_cluster(1000,
                                                                   10000)
        sched = Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        sched.tick()
        counts.append(service_counts(store, Task, services, nodes))
        if planner is not None:
            check(planner.stats.get("groups_fused") == 10,
                  f"1k many-service: groups_fused "
                  f"{planner.stats.get('groups_fused')}")
    check(counts[0] == counts[1],
          "many-service: card placements differ from the host path")
    placed = sum(counts[0].values())
    check(placed == 10000, f"many-service oracle placed {placed}")
    print(f"host oracle: many_service_1k card == host ({placed} tasks "
          "placed, 10 groups fused)", flush=True)
    return placed


def set_native(on):
    """The native plane on (both switches cleared), or off through
    ``SWARMKIT_TPU_NO_NATIVE`` with the commit plane's own switch pulled
    too (``SWARM_NATIVE_COMMIT=0``), so an off run is the Python oracle
    and not a counted fallback."""
    if on:
        os.environ.pop("SWARMKIT_TPU_NO_NATIVE", None)
        os.environ.pop("SWARM_NATIVE_COMMIT", None)
    else:
        os.environ["SWARMKIT_TPU_NO_NATIVE"] = "1"
        os.environ["SWARM_NATIVE_COMMIT"] = "0"


def fixed_ids(identity):
    """Mint ids from a counter (``None`` to stop), so two builds of one
    cluster carry the same ids."""
    import itertools
    n = itertools.count()
    identity.set_id_source(lambda: f"{next(n):025d}")


def store_rows(store, Task):
    """(id, node, state, version) of every task, sorted."""
    return sorted((t.id, t.node_id, int(t.status.state),
                   t.meta.version.index)
                  for t in store.view(lambda tx: tx.find(Task)))


def phase_native(torch, native, identity, EventTaskBlock, workload, Task,
                 Scheduler, TorchPlanner, tracer, card):
    """The headline tick and the config-7 tick (at ``NATIVE_CFG7_TASKS``
    tasks) twice each, with the native C commit plane on and off: the
    same store rows (id, node, state, version), the same events published
    (and the same per-task events when each block is expanded), and the
    tick's wall time with its ``sched.commit`` and ``plan.apply`` spans
    both ways."""
    out = {}
    for label, build in (("headline", workload.headline_cluster),
                         ("config 7", lambda: workload.many_service_cluster(
                             n_tasks=NATIVE_CFG7_TASKS))):
        runs = {}
        for on in (True, False):
            set_native(on)
            hp = native.get()
            check((hp is not None) == on, f"native {label}: native.get() "
                  f"is {hp} with the plane {'on' if on else 'off'}")
            fixed_ids(identity)
            try:
                store = build()[0]
            finally:
                identity.set_id_source(None)
            planner = TorchPlanner()
            sched = Scheduler(store, batch_planner=planner)
            store.view(sched._setup_tasks_list)
            sub = store.queue.subscribe(accepts_blocks=True)
            tracer.reset()
            tracer.enable()
            t0 = time.perf_counter()
            sched._process_preassigned_tasks()
            n_dec = sched.tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tracer.disable()
            spans = Counter()
            for sp in tracer.spans():
                spans[sp.name] += sp.duration
            events = sub.drain()
            store.queue.unsubscribe(sub)
            published = sum(len(e) if isinstance(e, EventTaskBlock) else 1
                            for e in events)
            blocks = [e for e in events if isinstance(e, EventTaskBlock)]
            t0 = time.perf_counter()
            expanded = [e.expand_events() for e in blocks]
            expand_s = time.perf_counter() - t0
            fan = hashlib.sha256()
            for evs in expanded:
                for ev in evs:
                    fan.update(f"{ev.obj.id}:{ev.obj.node_id}:"
                               f"{ev.obj.meta.version.index};".encode())
            del expanded
            rows = store_rows(store, Task)
            runs[on] = dict(
                decisions=n_dec, wall_s=wall,
                commit_s=spans.get("sched.commit", 0.0),
                apply_s=spans.get("plan.apply", 0.0),
                events=published, expand_s=expand_s,
                fanout_digest=fan.hexdigest(),
                rows_digest=hashlib.sha256(repr(rows).encode()).hexdigest(),
                placed=sum(1 for r in rows if r[1]),
                stats={k: v for k, v in planner.stats.items()
                       if k != "plan_seconds"})
            check(not any(planner.stats.get(k, 0) for k in HOST_ROUTES),
                  f"native {label}: a group left the card: "
                  f"{planner.stats}")
        set_native(True)
        a, b = runs[True], runs[False]
        for key in ("decisions", "rows_digest", "events", "fanout_digest",
                    "placed", "stats"):
            check(a[key] == b[key], f"native {label}: {key} differs with "
                  f"the plane on ({a[key]}) and off ({b[key]})")
        print(f"native plane, {label}: {a['decisions']} decisions, "
              f"{a['placed']} tasks placed, {a['events']} events, rows "
              f"equal on and off ({a['rows_digest'][:16]}); tick "
              f"{a['wall_s']:.3f} s native / {b['wall_s']:.3f} s Python, "
              f"sched.commit {a['commit_s']:.3f} / {b['commit_s']:.3f} s, "
              f"plan.apply {a['apply_s']:.3f} / {b['apply_s']:.3f} s, "
              f"fan-out {a['expand_s']:.3f} / {b['expand_s']:.3f} s, on "
              f"{card}", flush=True)
        out[label] = {"native": a, "python": b}
    return out


def trickle_script(workload, windows=TRICKLE_WINDOWS, seed=TRICKLE_SEED):
    """The churn's windows as a trickle of small groups: every window a few
    arrivals (Poisson(3), at least one) for each of the five arriving
    services, as restarts and one-replica updates send them, and the
    churn's exits.  Seeded."""
    import random
    rng = random.Random(seed)
    return [({sid: max(1, workload.poisson(rng, TRICKLE_LAM))
              for sid in workload.CHURN_ARRIVE},
             workload.poisson(rng, workload.CHURN_LAM_EXIT))
            for _ in range(windows)]


def run_trickle(torch, workload, Task, planner, script):
    """One churn run over ``script`` with ``planner`` (None: the host path
    alone): (decisions, wall seconds of the windows' ticks, store rows,
    planner stats)."""
    wl = workload.steady_state_churn()
    wl.script = list(script)
    sched = wl.attach(planner)
    sched.tick()
    decisions, t0 = 0, time.perf_counter()
    for arrivals, exits in wl.script:
        wl.feed(arrivals, exits)
        decisions += sched.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = store_rows(wl.store, Task)
    wl.close()
    stats = {} if planner is None else planner.stats
    return decisions, wall, rows, {k: v for k, v in stats.items()
                                   if k != "plan_seconds"}


def phase_breaker(torch, K, cuda, workload, Task, Scheduler, TorchPlanner,
                  planner_mod, registry, card):
    """The breaker on the card: a planner whose plan path raises
    ``KernelLaunchError`` on its first three dispatches (a stub in front
    of the real kernels) places a 1,000-node many-service tick through the
    host path exactly as a run without a planner, its breaker open (gauge
    2); after the cooldown the half-open probe runs the real kernels and
    closes it.  Then the small-group router: the host path's cost a task,
    the launch overhead, the break-even, and a trickle of small groups
    with the router off and on."""
    from swarmkit_tpu_torch.ops.cuda import KernelLaunchError
    cooldown = 0.5

    class Flaky(TorchPlanner):
        injected = 0

        def _enqueue_plan(self, *args, **kw):
            if self.injected < 3:
                self.injected += 1
                raise KernelLaunchError("injected launch failure")
            return super()._enqueue_plan(*args, **kw)

    planner = Flaky(breaker=planner_mod.PlannerBreaker(threshold=3,
                                                       cooldown=cooldown))
    planner.fused_enabled = False

    def run(p):
        store, services, nodes, _ = workload.many_service_cluster(1000,
                                                                   10000)
        sched = Scheduler(store, batch_planner=p)
        store.view(sched._setup_tasks_list)
        t0 = time.perf_counter()
        n_dec = sched.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t0
        return n_dec, service_counts(store, Task, services, nodes), tick_s

    n_dec, tripped, _ = run(planner)
    gauge = registry.get_gauge("swarm_planner_breaker_state")
    stats = dict(planner.stats)
    host_runs = [run(None) for _ in range(HOST_COST_RUNS)]
    n_host, host, _ = host_runs[0]
    check(all(r[0] == n_host and r[1] == host for r in host_runs),
          "breaker: the host-only ticks differ")
    check(n_dec == n_host == 10000 and tripped == host,
          "breaker: the tripped tick differs from the host path's")
    check(planner.injected == 3 and stats.get("groups_device_error") == 3,
          f"breaker: {planner.injected} injected, stats {stats}")
    check(stats.get("groups_breaker_to_host") == 7
          and stats.get("groups_planned", 0) == 0,
          f"breaker: groups not routed to the host: {stats}")
    check(planner.breaker.state == planner_mod.BREAKER_OPEN and gauge == 2,
          f"breaker: state {planner.breaker.state_name}, gauge {gauge}")
    time.sleep(cooldown * 1.5)
    cuda.reset_launch_counts(K.KERNELS)
    n_probe, probed, _ = run(planner)
    launches = cuda.launch_counts(K.KERNELS)
    gauge_after = registry.get_gauge("swarm_planner_breaker_state")
    check(planner.breaker.state == planner_mod.BREAKER_CLOSED
          and gauge_after == 0 and planner.breaker.stats["probes"] == 1,
          f"breaker: the half-open probe did not close it "
          f"({planner.breaker.state_name}, {planner.breaker.stats})")
    check(planner.stats["groups_planned"] == 10 and probed == host,
          f"breaker: after the probe {planner.stats}")
    for k in (K.FEASIBILITY, K.SEG_SUM, K.WATERFILL):
        check(launches[k.name] > 0, f"breaker: {k.name} not launched "
              "after the probe")
    print(f"breaker: 3 injected launch errors tripped it open (gauge "
          f"{gauge:.0f}), 10,000 tasks placed by the host path as without a "
          f"planner; after {cooldown} s the half-open probe ran the kernels "
          f"and closed it (gauge {gauge_after:.0f}) on {card}", flush=True)

    # the router's inputs: the host path's cost a task, and the launch
    # overhead, each over repeated samples
    host_task_s = sorted(r[2] / n_host for r in host_runs)
    host_cost = statistics.median(host_task_s)
    overheads = []
    for _ in range(OVERHEAD_RUNS):
        TorchPlanner._launch_overhead_shared.clear()
        probe = TorchPlanner()
        probe._measure_launch_overhead()
        check(probe._launch_overhead > 0.0,
              "breaker: the launch-overhead probe failed")
        overheads.append(probe._launch_overhead)
    overhead = statistics.median(overheads)
    break_even = int(0.8 * overhead / host_cost) + 1
    print(f"router: host path {host_cost * 1e6:.2f} us a task (median of "
          f"{HOST_COST_RUNS} host-only 10,000-task ticks: "
          f"{', '.join(f'{x * 1e6:.2f}' for x in host_task_s)}); launch "
          f"overhead {overhead * 1e3:.4f} ms (median of {OVERHEAD_RUNS} "
          f"measurements, each the median of "
          f"{TorchPlanner.LAUNCH_PROBE_SAMPLES} plans: "
          f"{', '.join(f'{x * 1e3:.4f}' for x in sorted(overheads))}); so "
          f"groups below {break_even} tasks go to the host with the router "
          f"on (the planner's constant: "
          f"{planner_mod.HOST_COST_PER_TASK * 1e6:.2f} us a task) on {card}",
          flush=True)

    # a trickle of small groups: the host path alone, then the router
    # off / on / on / off.  The kernels and the host path break ties
    # between equal nodes differently, so the runs compare within a
    # setting, and the router's against the host path's where it sent
    # every group there
    script = trickle_script(workload)
    arrived = sum(sum(a.values()) for a, _ in script)
    n_groups = sum(len(a) for a, _ in script)
    _, host_s, host_rows, _ = run_trickle(torch, workload, Task, None,
                                          script)
    trickle = []
    for on in (False, True, True, False):
        p = TorchPlanner()
        if on:
            p.enable_small_group_routing = True
            p._launch_overhead = overhead
            p.host_cost_per_task = host_cost
        decisions, wall, rows, rstats = run_trickle(torch, workload, Task,
                                                    p, script)
        label = "on" if on else "off"
        check(decisions == arrived, f"trickle (router {label}): "
              f"{decisions} decisions for {arrived} arrivals")
        for key in ("groups_device_error", "groups_breaker_to_host"):
            check(rstats.get(key, 0) == 0, f"trickle: {key} = "
                  f"{rstats.get(key)}")
        small = rstats.get("groups_small_to_host", 0)
        check((small > 0) == on, f"trickle (router {label}): "
              f"groups_small_to_host {small}")
        if small == n_groups:
            check(rows == host_rows, "trickle: the router sent every group "
                  "to the host path, which placed them otherwise")
        trickle.append(dict(router=on, decisions=decisions, seconds=wall,
                            rows=rows, stats=rstats))
    for on in (False, True):
        same = [r.pop("rows") for r in trickle if r["router"] == on]
        check(same[0] == same[1], f"trickle: two runs with the router "
              f"{'on' if on else 'off'} placed otherwise")
    walls = {on: [r["seconds"] for r in trickle if r["router"] == on]
             for on in (False, True)}
    on_stats = trickle[1]["stats"]
    print(f"router trickle: {arrived} arrivals in {n_groups} groups of "
          f"1-{max(max(a.values()) for a, _ in script)} tasks over "
          f"{len(script)} windows; router on: groups_small_to_host "
          f"{on_stats.get('groups_small_to_host', 0)}, groups_planned "
          f"{on_stats.get('groups_planned', 0)}, groups_fused "
          f"{on_stats.get('groups_fused', 0)}, "
          f"{', '.join(f'{x:.4f}' for x in walls[True])} s; router off: "
          f"{', '.join(f'{x:.4f}' for x in walls[False])} s (off, on, on, "
          f"off); host path alone {host_s:.4f} s, on {card}", flush=True)
    return dict(injected=planner.injected, tripped_stats=stats,
                gauge_open=gauge, gauge_after_probe=gauge_after,
                probe_launches=launches, host_cost_per_task_s=host_cost,
                host_task_samples_s=host_task_s, launch_overhead_s=overhead,
                launch_overhead_samples_s=overheads,
                break_even_tasks=break_even, trickle=trickle,
                trickle_host_s=host_s)


#: phase 22's script at config 5's width (10,000 nodes; ``web`` cut from
#: bench.py's 500,000 replicas to 150,000 to keep the script in its time
#: limit), and the shape it runs at against the host path: 1,000 nodes, a
#: drain of a tenth of them and a rollout whose every count divides the
#: nodes it spreads over (9 web tasks a node, 1 more after the drain; 9
#: api tasks a node, batches of 4,500 over 900 active nodes), so no tie
#: among equally loaded nodes is left to a tie-break order.
#: ``stop_timeout``: the drained nodes' agents confirm their stops only
#: after the restart supervisor's old-task timeout, so the replacements
#: start through it (the path of an agent that does not answer); at full
#: width its stop intake, a scan of every waiting restart for each stop
#: (``orchestrator/restart.py`` ``_handle_stop_event``), would take
#: minutes.  The parity run takes the users' path: the stops reported,
#: then the replacements started.
LIFE_FULL = dict(n_nodes=10_000, web=150_000, api=10_000, parallelism=2_500,
                 drained=1_000, stop_timeout=True)
LIFE_PARITY = dict(n_nodes=1_000, web=9_000, api=9_000, parallelism=4_500,
                   drained=100, stop_timeout=False)
LIFE_STAGES = ("create", "drain", "rollout")
#: the spans each stage's seconds are split into
LIFE_SPANS = ("orchestrator.reconcile", "sched.preassigned", "sched.tick",
              "sched.commit", "sched.host_fallback")
#: the clock jump past the rollout's monitor window (30 s: ``monitor`` 0
#: means the default window, ``update.py``)
MONITOR_JUMP_S = 31.0


def rss_gib():
    """This process's resident memory, GiB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


def service_life(workload, types, Task, TaskState, Service, planner, tracer,
                 shape, K=None, cuda=None, sync=None):
    """A service's life through the port's control loops
    (``workload.ControlLoops`` over ``planner``, None: the host path) on
    ``workload.orchestrated_cluster(...)`` at ``shape``: create the
    services and settle (``workload.settle``), drain the first
    ``shape["drained"]`` nodes, step until the replacements are placed,
    and settle (with ``shape["stop_timeout"]``, after moving the clock
    past the restart supervisor's old-task timeout), roll
    ``api`` out to ``api:2``
    and settle until its update completes (the clock jumps past the
    monitor window while it waits).  The model clock is the wall clock
    plus those jumps.  Returns (store, services, nodes, {stage: record}):
    each record holds the stage's wall seconds, its control steps, the
    scheduler's decisions each step (``assigned``), the loops' parts and
    the spans (``LIFE_SPANS``) in seconds, the planner's counters moved,
    the tasks it created, the kernels launched (with ``K`` and ``cuda``),
    the live tasks per (service, node) after it, the tasks desired
    RUNNING a slot, the nodes running ``agent``, the garbage collections
    and the process's memory."""
    skew = [0.0]
    types.set_time_source(lambda: time.time() + skew[0])
    try:
        t0 = time.perf_counter()
        store, services, nodes = workload.orchestrated_cluster(
            shape["n_nodes"], shape["web"], shape["api"],
            shape["parallelism"])
        build_s = time.perf_counter() - t0
        loops = workload.ControlLoops(store, planner)
        names = {s.id: name for name, s in services.items()}
        host = {n.id: n.description.hostname for n in nodes}
        api = services["api"].id

        def create():
            loops.cold_start()
            return workload.settle(loops)

        def drain():
            workload.drain_nodes(store, nodes[:shape["drained"]])
            records = []
            # the replacements made, allocated and placed
            for _ in range(workload.SETTLE_STEPS):
                decided, wrote = loops.step()
                records.append((decided, wrote, dict(loops.last)))
                if not wrote:
                    break
            else:
                fail(f"service life: the drain's loops still wrote after "
                     f"{len(records)} steps")
            if shape["stop_timeout"]:
                skew[0] += loops.restarts.task_timeout + 1.0
            return records + workload.settle(loops)

        def rollout():
            from swarmkit_tpu_torch.models import UpdateState
            workload.roll_out(store, api, "api:2")
            records = []
            for _ in range(4):
                records += workload.settle(loops)
                st = store.view(lambda tx: tx.get(Service, api)) \
                    .update_status
                if st is not None and st.state == UpdateState.COMPLETED:
                    return records
                skew[0] += MONITOR_JUMP_S
            fail(f"service life: the api rollout did not complete ({st})")

        out = {}
        for label, run in zip(LIFE_STAGES, (create, drain, rollout)):
            before = {t.id for t in store.view(lambda tx: tx.find(Task))}
            stats0 = dict(planner.stats) if planner is not None else {}
            if cuda is not None:
                cuda.reset_launch_counts(K.KERNELS)
            tracer.reset()
            tracer.enable()
            with GcClock() as collections:
                collections.on = True
                t0 = time.perf_counter()
                records = run()
                if sync is not None:
                    sync()
                wall = time.perf_counter() - t0
                collections.on = False
            tracer.disable()
            spans, n_spans = Counter(), Counter()
            for sp in tracer.spans():
                spans[sp.name] += sp.duration
                n_spans[sp.name] += 1
            parts = Counter()
            for _, _, p in records:
                parts.update(p)
            tasks = store.view(lambda tx: tx.find(Task))
            slots, agents, not_running = Counter(), set(), 0
            for t in tasks:
                if t.desired_state != TaskState.RUNNING:
                    continue
                not_running += t.status.state != TaskState.RUNNING
                if t.slot:
                    slots[(names[t.service_id], t.slot)] += 1
                else:
                    agents.add(t.node_id)
            out[label] = dict(
                seconds=wall, steps=len(records),
                assigned=[a for a, _, _ in records],
                parts_s=dict(parts),
                spans_s={k: spans.get(k, 0.0) for k in LIFE_SPANS},
                span_counts={k: n_spans.get(k, 0) for k in LIFE_SPANS},
                planner={k: v - stats0.get(k, 0)
                         for k, v in planner.stats.items()
                         if k != "plan_seconds" and v != stats0.get(k, 0)}
                if planner is not None else {},
                created=[t for t in tasks if t.id not in before],
                launches=cuda.launch_counts(K.KERNELS)
                if cuda is not None else {},
                counts=Counter(
                    (names[t.service_id], host[t.node_id]) for t in tasks
                    if t.node_id and t.desired_state <= TaskState.RUNNING),
                slots={name: Counter(c for (n, _), c in slots.items()
                                     if n == name)
                       for name in ("web", "api")},
                agents=agents, not_running=not_running, rss_gib=rss_gib(),
                gc_by_generation={
                    str(g): dict(collections=n, seconds=sec)
                    for g, (n, sec) in collections.by_generation().items()})
        out["create"]["build_s"] = build_s
        return store, services, nodes, out
    finally:
        tracer.disable()
        types.set_time_source(None)


def check_life(label, store, services, nodes, stages, shape, Task,
               TaskState, K=None):
    """The checks of phase 22 on one run of :func:`service_life`."""
    n_nodes, drained_n = shape["n_nodes"], shape["drained"]
    web, api, par = shape["web"], shape["api"], shape["parallelism"]
    names = {s.id: name for name, s in services.items()}
    by_id = {n.id: n for n in nodes}
    drained = {n.id for n in nodes[:drained_n]}
    tasks = store.view(lambda tx: tx.find(Task))
    for stage, rec in stages.items():
        for key in ("groups_spill_to_host", "groups_strategy_host",
                    "fused_overflows") + HOST_ROUTES:
            check(rec["planner"].get(key, 0) == 0,
                  f"{label} {stage}: {key} = {rec['planner'].get(key)}")
        if rec["planner"] or K is not None:
            check(rec["span_counts"]["sched.host_fallback"] == 0,
                  f"{label} {stage}: a group took the host path")
    create, drain, rollout = (stages[s] for s in LIFE_STAGES)

    # create: every task made, allocated and placed
    made = Counter(names[t.service_id] for t in create["created"])
    check(made == Counter(web=web, api=api, agent=n_nodes),
          f"{label} create: tasks made {dict(made)}")
    check(sum(create["assigned"]) == web + api + n_nodes,
          f"{label} create: decisions {sum(create['assigned'])}")
    racks = Counter(rack_of(by_id[t.node_id]) for t in create["created"]
                    if names[t.service_id] == "web")
    check(len(racks) == 20 and max(racks.values()) - min(racks.values())
          <= 1, f"{label} create: web racks unbalanced: "
          f"{sorted(racks.values())}")
    if create["planner"] or K is not None:
        check(create["planner"].get("tasks_planned") == web + api + n_nodes,
              f"{label} create: tasks_planned "
              f"{create['planner'].get('tasks_planned')}")
    if K is not None:
        got = create["launches"]
        check(got[K.FEASIBILITY.name] >= 1, f"{label} create: the "
              "preassigned batch did not go through K1")
        for k in (K.SEG_SUM, K.WATERFILL):
            check(got[k.name] > 0, f"{label} create: {k.name} never "
                  "launched")
        check(got[K.FUSED_FEASIBILITY.name] + got[K.FEASIBILITY.name] > 1,
              f"{label} create: no plan's feasibility kernel launched")

    # drain: replacements placed in one tick, off the drained nodes
    repl = [t for t in drain["created"] if names[t.service_id] != "agent"]
    want = Counter(web=web // n_nodes * drained_n,
                   api=api // n_nodes * drained_n)
    check(Counter(names[t.service_id] for t in repl) == want,
          f"{label} drain: replacements "
          f"{dict(Counter(names[t.service_id] for t in repl))}, want "
          f"{dict(want)}")
    placed = [a for a in drain["assigned"] if a]
    check(placed == [len(repl)], f"{label} drain: ticks assigned {placed}, "
          f"not all {len(repl)} replacements in one tick")
    cur = {t.id: t for t in tasks}
    check(all(cur[t.id].node_id and cur[t.id].node_id not in drained
              for t in repl), f"{label} drain: a replacement is unplaced or "
          "on a drained node")
    if K is not None:
        check(drain["launches"][K.WATERFILL.name] > 0,
              f"{label} drain: K3 never launched")
    active = {n.id for n in nodes} - drained
    for stage, rec in stages.items():
        check(rec["not_running"] == 0, f"{label} {stage}: "
              f"{rec['not_running']} tasks desired RUNNING are not running")
        for name, n in (("web", web), ("api", api)):
            check(rec["slots"][name] == Counter({1: n}),
                  f"{label} {stage}: {name}'s slots hold "
                  f"{dict(rec['slots'][name])} tasks desired RUNNING, not "
                  f"one in each of {n}")
        want_agents = active if stage != "create" else {n.id for n in nodes}
        check(rec["agents"] == want_agents, f"{label} {stage}: agent runs "
              f"on {len(rec['agents'])} nodes, {len(rec['agents'] & drained)}"
              " of them drained")

    # rollout: batches of ``parallelism`` placed by the device, all slots
    # on the new spec
    batches = [a for a in rollout["assigned"] if a]
    check(batches == [par] * (api // par),
          f"{label} rollout: batches placed {batches}")
    if rollout["planner"] or K is not None:
        check(rollout["planner"].get("groups_planned") == api // par,
              f"{label} rollout: groups_planned "
              f"{rollout['planner'].get('groups_planned')}")
    if K is not None:
        check(rollout["launches"][K.FEASIBILITY.name] == api // par,
              f"{label} rollout: K1 launched "
              f"{rollout['launches'][K.FEASIBILITY.name]} times for "
              f"{api // par} batches")
    svc = store.view(lambda tx: tx.get(type(services["api"]),
                                       services["api"].id))
    check(svc.spec_version.index == 2, f"{label}: api spec version")
    new = [t for t in tasks if names[t.service_id] == "api"
           and t.desired_state == TaskState.RUNNING]
    check(len(new) == api and all(
        t.spec_version.index == 2 and t.spec.container.image == "api:2"
        for t in new), f"{label} rollout: not every api slot runs the new "
          "spec")


def phase_service_life(torch, K, cuda, workload, types, identity, Task,
                       TaskState, Service, TorchPlanner, tracer, card):
    """A service's life at config 5's full width through the port's
    control loops, then the same script at 1,000 nodes through the card
    and through the host path (fixed ids): equal live tasks per (service,
    node) after every stage."""
    planner = TorchPlanner()
    store, services, nodes, stages = service_life(
        workload, types, Task, TaskState, Service, planner, tracer,
        LIFE_FULL, K=K, cuda=cuda, sync=torch.cuda.synchronize)
    check_life("service life", store, services, nodes, stages, LIFE_FULL,
               Task, TaskState, K=K)
    out = {}
    for label in LIFE_STAGES:
        rec = stages[label]
        parts = rec["parts_s"]
        tick_s = parts.get("preassigned", 0.0) + parts.get("tick", 0.0)
        decided = sum(rec["assigned"])
        rate = decided / tick_s if tick_s > 0 else None
        out[label] = dict(
            {k: v for k, v in rec.items()
             if k not in ("created", "counts", "agents")},
            created=len(rec["created"]), agents=len(rec["agents"]),
            decisions_per_s=rate)
        spans = rec["spans_s"]
        print(f"service life, {label}: {rec['seconds']:.1f} s in "
              f"{rec['steps']} steps (" + ", ".join(
                  f"{k} {spans[k]:.2f}" for k in LIFE_SPANS if spans[k])
              + "; loops: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in parts.items() if v >= 0.005)
              + f"); {len(rec['created'])} tasks made, decisions a step "
              f"{[a for a in rec['assigned'] if a]} "
              + (f"({rate:.0f} decisions/s of the preassigned passes and "
                 "ticks)" if rate else "")
              + "; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }"
              f"; planner {rec['planner']}; RSS {rec['rss_gib']:.1f} GiB; "
              "garbage collections: " + (", ".join(
                  f"gen {g} x{c['collections']} {c['seconds']:.1f} s"
                  for g, c in rec["gc_by_generation"].items()) or "none")
              + f"; on {card}", flush=True)
    out["create"]["cluster_build_s"] = stages["create"]["build_s"]
    del store, services, nodes, stages
    gc.collect()

    counts, walls = [], []
    for planner in (TorchPlanner(), None):
        fixed_ids(identity)
        try:
            t0 = time.perf_counter()
            store, services, nodes, stages = service_life(
                workload, types, Task, TaskState, Service, planner, tracer,
                LIFE_PARITY)
            walls.append(time.perf_counter() - t0)
        finally:
            identity.set_id_source(None)
        check_life("service life 1k" + (" host" if planner is None
                                         else ""), store, services, nodes,
                   stages, LIFE_PARITY, Task, TaskState)
        counts.append({s: stages[s]["counts"] for s in LIFE_STAGES})
    for label in LIFE_STAGES:
        check(counts[0][label] == counts[1][label],
              f"service life 1k {label}: card placements differ from the "
              "host path")
    print(f"service life 1k: card == host after create, drain and rollout "
          f"({sum(counts[0]['rollout'].values())} live tasks; "
          f"{walls[0]:.1f} s card, {walls[1]:.1f} s host path)", flush=True)
    out["parity_1k"] = dict(card_s=walls[0], host_s=walls[1],
                            live_tasks=sum(counts[0]["rollout"].values()))
    return out


def phase_tenant_storm(torch, K, cuda, workload, Task, TaskState,
                       TorchPlanner, card):
    """bench.py's config 9 through ``orchestrator.autoscaler.Supervisor``
    and ``TorchPlanner()``: the high band all placed, the burst tenant at
    or under its quota with clamps, the blocked service refused on quota,
    an autoscale decision; the same build on the host path places the
    same counts a service with the same clamps."""
    n_hi, quota, _, _ = workload.tenant_bands()
    out = {}
    for planner in (TorchPlanner(), None):
        store, services = workload.tenant_storm()
        cuda.reset_launch_counts(K.KERNELS)
        sched, scaler, n_dec, dt = workload.tenant_storm_pass(
            store, services, planner)
        if planner is not None:
            torch.cuda.synchronize()
        launches = cuda.launch_counts(K.KERNELS)
        tasks = store.view(lambda tx: tx.find(Task))
        placed = Counter()
        for t in tasks:
            if t.node_id and t.status.state >= TaskState.ASSIGNED:
                placed[t.service_id] += 1
        by = {name: placed[s.id] for name, s in services.items()}
        clamps = sched.stats.get("quota_clamps", 0)
        label = "card" if planner is not None else "host"
        check(by["hi"] == n_hi, f"config 9 {label}: high band placed "
              f"{by['hi']} of {n_hi}")
        check(by["burst"] <= quota, f"config 9 {label}: the burst tenant "
              f"placed {by['burst']} over its quota {quota}")
        check(clamps > 0, f"config 9 {label}: no quota clamp")
        check(by["blocked"] == 0, f"config 9 {label}: the blocked service "
              f"placed {by['blocked']}")
        err = next((t.status.err for t in tasks
                    if t.service_id == services["blocked"].id), "")
        check("over tenant quota" in (err or ""),
              f"config 9 {label}: blocked service's error {err!r}")
        check(scaler.stats["decisions"] > 0,
              f"config 9 {label}: no autoscale decision")
        stats = dict(planner.stats) if planner is not None else {}
        if planner is not None:
            for key in ("groups_spill_to_host", "groups_strategy_host",
                        "fused_overflows") + HOST_ROUTES:
                check(stats.get(key, 0) == 0, f"config 9: {key} = "
                      f"{stats.get(key)}")
            check(sum(launches.values()) > 0,
                  "config 9: no kernel launched")
        out[label] = dict(placed=by, quota_clamps=clamps, decisions=n_dec,
                          tick_s=dt, decisions_per_s=n_dec / dt,
                          autoscale_decisions=scaler.stats["decisions"],
                          launches=launches,
                          stats={k: v for k, v in stats.items()
                                 if k != "plan_seconds"})
    card_run, host_run = out["card"], out["host"]
    check(card_run["placed"] == host_run["placed"]
          and card_run["quota_clamps"] == host_run["quota_clamps"],
          f"config 9: card {card_run['placed']} / {card_run['quota_clamps']}"
          f" clamps, host path {host_run['placed']} / "
          f"{host_run['quota_clamps']}")
    print(f"config 9: placed {card_run['placed']} (quota "
          f"{quota}), {card_run['quota_clamps']} quota clamps, "
          f"{card_run['autoscale_decisions']} autoscale decisions, tick "
          f"{card_run['tick_s']:.4f} s ({card_run['decisions_per_s']:.0f} "
          f"decisions/s; host path {host_run['tick_s']:.4f} s), equal to "
          f"the host path; launches "
          f"{ {k: v for k, v in card_run['launches'].items() if v} }; "
          f"stats {card_run['stats']}; on {card}", flush=True)
    return out


# ----------------------------------------------- phase 24: the live manager

#: the spans phase 24 prints from each traced twin
LIVE_SPANS = ("sched.commit", "plan.dispatch", "plan.d2h", "plan.apply")
#: a WAL holding whole task objects takes ~2 KB a task (the host path);
#: block entries take ~52 bytes (bench.py's config 6 on the reference)
LIVE_WAL_BYTES_PER_TASK = 200


def placements(store, Task, tasks, nodes):
    """Each of ``tasks``' hostname in ``store``, in creation order: ids
    are minted afresh by each build, creation order is not."""
    host = {n.id: n.description.hostname for n in nodes}
    rows = {t.id: t.node_id for t in store.view(lambda tx: tx.find(Task))}
    return [host.get(rows.get(t.id)) for t in tasks]


def wal_entries(path, serde):
    """(entries, block entries) of a member's WAL under ``path``, unsealed
    with the live manager's key."""
    from swarmkit_tpu_torch.state.raft import KeyEncoder, RaftLogger
    from swarmkit_tpu_torch.workload import LIVE_WAL_KEY
    logger = RaftLogger(path, encoder=KeyEncoder(LIVE_WAL_KEY))
    try:
        _, entries, _ = logger.bootstrap()
    finally:
        logger.close()
    return len(entries), sum(e.data[:4] == serde.BLOCK_ENTRY_MAGIC
                             for e in entries)


def live_run(torch, K, cuda, workload, Task, TorchPlanner, build, proposer,
             around=None, wal_dir=None):
    """One live-manager tick (``workload.live_manager``) of the cluster
    ``build()`` makes, on the card: its record, launches by kernel,
    placements in creation order and the planner's stats."""
    t0 = time.perf_counter()
    store, _, nodes, tasks = build()
    build_s = time.perf_counter() - t0
    planner = TorchPlanner()
    cuda.reset_launch_counts(K.KERNELS)
    out = workload.live_manager(store, planner, proposer=proposer,
                                nodes=nodes, wal_dir=wal_dir, around=around)
    torch.cuda.synchronize()
    out["launches"] = cuda.launch_counts(K.KERNELS)
    out["placements"] = placements(store, Task, tasks, nodes)
    out["stats"] = {k: v for k, v in planner.stats.items()
                    if k != "plan_seconds"}
    out["build_s"] = build_s
    out.pop("sched")
    del store, nodes, tasks, planner
    gc.collect()
    return out


def phase_live_manager(torch, K, cuda, workload, Task, TorchPlanner, serde,
                       tracer, card):
    """Configs 6 and 7 as bench.py's ``run_live_manager`` runs them: one
    tick through a single-voter ``RaftNode`` with its sealed WAL and the
    live manager's subscribers, against the same tick with a nil proposer
    (and, for config 6, a traced twin); equal placements, every group
    fused, the WAL made of block entries."""
    import shutil
    import tempfile
    from swarmkit_tpu_torch.ops.fusedbatch import chunk_sizes
    cells = (
        ("config6", workload.live_cluster, workload.LIVE_SERVICES, None,
         True),
        ("config7", lambda: workload.many_service_cluster(
            workload.MANY_SERVICE_NODES, NATIVE_CFG7_TASKS),
         len(workload.MANY_SERVICE_MIX), workload.MANY_SERVICE_MIX, False))
    out = {}
    for label, build, n_groups, mix, with_twin in cells:
        chunks = len(chunk_sizes(n_groups))
        wal = tempfile.mkdtemp(prefix=f"live-{label}-")
        try:
            raft = live_run(torch, K, cuda, workload, Task, TorchPlanner,
                            build, "raft", wal_dir=wal)
            entries, blocks = wal_entries(os.path.join(wal, "b0"), serde)
        finally:
            shutil.rmtree(wal, ignore_errors=True)
        runs = {"raft": raft, "nil": live_run(
            torch, K, cuda, workload, Task, TorchPlanner, build, None)}
        traced_rec = {}
        if with_twin:
            def around(tick):
                got = []
                traced_rec.update(traced(
                    torch, tracer, lambda: got.append(tick()), card,
                    f"traced live manager, {label}"))
                return got[0]

            runs["traced"] = live_run(torch, K, cuda, workload, Task,
                                      TorchPlanner, build, "raft",
                                      around=around)
        nil = runs["nil"]
        n_tasks = raft["tasks"]
        for name, run in runs.items():
            lab = f"live manager {label} ({name})"
            check(run["decisions"] == n_tasks,
                  f"{lab}: {run['decisions']} decisions for {n_tasks} tasks")
            check(run["groups_fused"] == n_groups,
                  f"{lab}: groups_fused {run['groups_fused']} != {n_groups}")
            check(run["native_commit"]["active"]
                  and run["native_commit"]["fallbacks"] == 0,
                  f"{lab}: native commit {run['native_commit']}")
            for key in ("groups_spill_to_host",) + HOST_ROUTES:
                check(run["stats"].get(key, 0) == 0,
                      f"{lab}: {key} = {run['stats'].get(key)}")
            check_fused_launches(K, run["launches"], n_groups, chunks, lab,
                                 mix=mix)
            check(run["placements"] == nil["placements"],
                  f"{lab}: placements differ from the nil proposer's")
        check(raft["raft_entries_applied"] >= 2 and blocks >= 1,
              f"live manager {label}: {raft['raft_entries_applied']} entries "
              f"applied, {blocks} block entries in the WAL")
        check(raft["wal_bytes"] < LIVE_WAL_BYTES_PER_TASK * n_tasks,
              f"live manager {label}: {raft['wal_bytes']} WAL bytes for "
              f"{n_tasks} tasks: not block entries")
        rec = dict(
            tasks=n_tasks, groups_fused=raft["groups_fused"],
            raft_tick_s=raft["tick_s"], nil_tick_s=nil["tick_s"],
            raft_added_s=raft["tick_s"] - nil["tick_s"],
            commit_s=dict(raft=raft["commit_s"], nil=nil["commit_s"]),
            plan_s=dict(raft=raft["plan_s"], nil=nil["plan_s"]),
            fanout_s=dict(raft=raft["fanout_s"], nil=nil["fanout_s"]),
            propose_s=raft["propose_s"], apply_s=raft["apply_s"],
            raft_entries_applied=raft["raft_entries_applied"],
            raft_stats=raft["raft_stats"], wal_bytes=raft["wal_bytes"],
            wal_entries=entries, wal_block_entries=blocks,
            native_commit=raft["native_commit"],
            launches={k: v for k, v in raft["launches"].items() if v},
            events_delivered=raft["events_delivered"],
            cluster_build_s=raft["build_s"])
        twin_line = ""
        if with_twin:
            spans = traced_rec["spans_s"]
            rec.update(
                traced_tick_s=runs["traced"]["tick_s"],
                device_busy_share=traced_rec["device_busy_share"],
                device_busy_s=traced_rec["device_busy_s"],
                traced_wall_s=traced_rec["wall_s"],
                spans_s={k: spans.get(k, 0.0) for k in LIVE_SPANS},
                launches_without_row=traced_rec["launches_without_row"])
            twin_line = (
                f"; traced twin {rec['traced_tick_s']:.3f} s, device busy "
                + (f"{rec['device_busy_share']:.4%}"
                   if rec["device_busy_share"] is not None
                   else "not measured")
                + ", spans " + ", ".join(
                    f"{k} {v * 1e3:.1f} ms"
                    for k, v in rec["spans_s"].items()))
        print(f"live manager, {label}: {n_tasks} tasks, raft tick "
              f"{raft['tick_s']:.3f} s, nil proposer {nil['tick_s']:.3f} s "
              f"(raft added {rec['raft_added_s']:.3f} s; sched.commit "
              f"{raft['commit_s']:.3f} / {nil['commit_s']:.3f} s); "
              f"swarm_raft_propose_latency {raft['propose_s']:.3f} s, "
              f"swarm_raft_apply_latency {raft['apply_s']:.3f} s; "
              f"{raft['raft_entries_applied']} entries applied, WAL "
              f"{raft['wal_bytes']} bytes ({blocks} block entries of "
              f"{entries}); groups_fused {raft['groups_fused']}; native "
              f"fallbacks {raft['native_commit']['fallbacks']}; launches "
              f"{rec['launches']}; cluster build {raft['build_s']:.1f} s"
              + twin_line + f"; placements equal; on {card}", flush=True)
        out[label] = rec
    return out


# ------------------------------------- phase 25: the replicated control plane

#: phase 25's shape: racked nodes (10 a rack), ``web`` tasks a node at
#: the create and after the successor's scale-up, ``batch`` tasks a node
#: after the restart, raft entries between snapshots, the fence stage's
#: services and tasks each, and raft's tick in seconds.  Every object a
#: member writes through three sealed members costs ~4 ms of the one
#: interpreter they share, so the width is cut from 1,000 nodes and
#: 12,000 tasks to fit the script's time limit; elections take 10-20
#: ticks of silence, and a member whose thread a sealed snapshot holds
#: for seconds is not taken for dead
CONTROL = dict(n_nodes=200, web=2, scaled=3, batch=1, snapshot_interval=12,
               fence_services=3, fence_tasks=200, tick_interval=0.3)
#: the key each member's WAL is sealed with
CONTROL_KEY = b"swarmkit-replicated-control-key"
#: changes each store keeps for watch resumes: the whole script's
CONTROL_CHANGELOG = 1 << 20
#: seconds a member may take to catch up with the leader
CONTROL_CATCH_UP_S = 60.0
#: leadership changes nobody asked for that a run of the script survives
CONTROL_UNPLANNED = 3
CONTROL_STAGES = ("create", "scale", "restart")


def control_service(m, name, replicas=None, spread=False):
    """A ``ServiceSpec`` as a user sends it: replicated (``replicas``),
    else global; 0.1 CPU + 64 MiB a task; spread over the racks."""
    return m.ServiceSpec(
        annotations=m.Annotations(name=name),
        task=m.TaskSpec(
            container=m.ContainerSpec(image=f"{name}:1"),
            placement=m.Placement(preferences=[m.PlacementPreference(
                spread=m.SpreadOver(spread_descriptor="node.labels.rack"))]
                if spread else []),
            resources=m.ResourceRequirements(reservations=m.Resources(
                nano_cpus=10**8, memory_bytes=64 << 20))),
        mode=m.ServiceMode.REPLICATED if replicas is not None
        else m.ServiceMode.GLOBAL,
        replicated=m.ReplicatedService(replicas=replicas)
        if replicas is not None else None)


def control_rows(store, m):
    """Live tasks by (service name, slot) -- by hostname for a global
    service's -- to (hostname, state): a key two runs share where ids
    differ."""
    def cb(tx):
        host = {n.id: n.description.hostname for n in tx.find(m.Node)}
        name = {s.id: s.spec.annotations.name for s in tx.find(m.Service)}
        out = {}
        for t in tx.find(m.Task):
            if t.desired_state > m.TaskState.RUNNING:
                continue
            key = (name.get(t.service_id), t.slot or host.get(t.node_id))
            out[key] = (host.get(t.node_id), int(t.status.state))
        return out
    return store.view(cb)


def control_counts(rows):
    """Live tasks per (service name, hostname) of :func:`control_rows`:
    the host path's spread walk and the water-fill give equally loaded
    nodes their tasks in different orders, so the card and the host path
    agree on these counts where the loads are tie-free, not task for
    task."""
    return Counter((key[0], host) for key, (host, _) in rows.items())


def converge(members, leader, timeout=CONTROL_CATCH_UP_S):
    """Wait until every member has applied all that ``leader`` committed
    and holds a store byte-equal to ``leader``'s (a member installing a
    snapshot has applied it before its store is restored); returns those
    bytes."""
    members = list(members)
    deadline = time.monotonic() + timeout
    while True:
        if all(rn.core.applied_index >= leader.core.commit_index
               for rn in members):
            want = leader.store.save_bytes()
            if all(rn is leader or rn.store.save_bytes() == want
                   for rn in members):
                return want
        if time.monotonic() > deadline:
            fail(f"replicated control: the members' stores did not "
                 f"converge on {leader.id}'s in {timeout} s")
        time.sleep(0.2)


def drain_stream(stream):
    out = []
    while True:
        ev = stream.poll()
        if ev is None:
            return out
        out.append(ev)


def watch_resume(m, leader_stream, follower_store):
    """The leader's watch stream resumed on a follower at the middle
    event's version: the follower's tail must be the leader's, with no
    gap and no duplicate."""
    from swarmkit_tpu_torch.manager import WatchRequest, WatchServer
    events = drain_stream(leader_stream)
    leader_stream.close()
    check(len(events) >= 2, f"replicated control: the leader's watch "
          f"stream saw {len(events)} events")
    token = events[len(events) // 2].version
    resumed = WatchServer(follower_store).watch(
        WatchRequest(kinds=[m.Task], resume_from_version=token))
    tail = drain_stream(resumed)
    resumed.close()

    def key(ev):
        return (ev.version, ev.action, ev.obj.id)

    want = [key(e) for e in events if e.version > token]
    got = [key(e) for e in tail]
    versions = [e.version for e in tail]
    check(got == want and versions == sorted(set(versions))
          and versions and versions[0] == want[0][0],
          f"replicated control: the watch resumed on a follower at "
          f"{token} differs from the leader's stream ({len(got)} events, "
          f"{len(want)} expected)")
    return dict(events=len(events), token=token, resumed=len(tail))


def fence_tick(workload, m, rn, planner, shape):
    """Depose ``rn`` while a pipelined tick's chunk proposals are in
    flight: services of PENDING tasks (ids of their own, so the rest of
    the script mints the ids it would without them) ticked by a
    ``Scheduler`` at the default pipeline depth, whose first block
    proposal steps the leader down.  Returns the fence's ids and what the
    tick saw."""
    from swarmkit_tpu_torch.scheduler import Scheduler
    store = rn.store
    spec = m.TaskSpec(resources=m.ResourceRequirements(
        reservations=m.Resources(nano_cpus=10**8, memory_bytes=64 << 20)))
    services, tasks = [], []
    for i in range(shape["fence_services"]):
        svc = m.Service(
            id=f"fence-{i}", spec=m.ServiceSpec(
                annotations=m.Annotations(name=f"fence-{i}"), task=spec,
                mode=m.ServiceMode.REPLICATED,
                replicated=m.ReplicatedService(
                    replicas=shape["fence_tasks"])),
            spec_version=m.Version(index=1))
        services.append(svc)
        for s in range(1, shape["fence_tasks"] + 1):
            tasks.append(m.Task(
                id=f"fence-{i}-{s:05d}", service_id=svc.id, slot=s,
                desired_state=m.TaskState.RUNNING, spec=spec,
                spec_version=m.Version(index=1),
                status=m.TaskStatus(state=m.TaskState.PENDING)))

    def create(tx):
        for obj in services + tasks:
            tx.create(obj)

    store.update(create)
    sched = Scheduler(store, batch_planner=planner)
    check(sched.pipeline_depth >= 2, "the fence tick is not pipelined")
    store.view(sched._setup_tasks_list)
    calls = []
    propose_async = rn.propose_async

    def deposing(actions, commit_cb=None, epoch=None):
        waiter = propose_async(actions, commit_cb, epoch=epoch)
        calls.append([getattr(a, "ids", ()) for a in actions])
        if len(calls) == 1:
            epoch0 = rn.leadership_epoch
            rn.step_down()
            deadline = time.monotonic() + 10.0
            while rn.leadership_epoch == epoch0:
                check(time.monotonic() < deadline, "step_down() did not "
                      "move the leadership epoch in 10 s")
                time.sleep(0.001)
        return waiter

    rn.propose_async = deposing
    try:
        sched.tick()
    finally:
        del rn.propose_async
    check(len(calls) >= 1, "the fence tick proposed nothing")
    first = {tid for ids in calls[0] for tid in ids}
    return dict(services=[s.id for s in services],
                tasks=[t.id for t in tasks], first=first,
                proposals=len(calls), requeued=len(sched.unassigned_tasks))


def resident_bytes(planner):
    """Bytes of the planner's resident node columns on its device, each
    tensor rounded up to the caching allocator's 512-byte blocks."""
    st = getattr(planner, "_streaming", None)
    dev = getattr(st, "dev", None) or ()
    out = []
    stack = list(dev)
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif x is not None and hasattr(x, "element_size"):
            out.append(-(-x.numel() * x.element_size() // 512) * 512)
    return sum(out)


def control_script(workload, m, planner_factory, root, shape, fence=True,
                   memory=None):
    """Phase 25's script: three members over one ``LocalNetwork``, each
    with its own store and sealed WAL under ``root``; the users' services
    created through the leader's ``ControlAPI`` and driven by
    ``workload.ControlLoops`` over ``planner_factory()`` (None: the host
    path); the leader paused and the successor's new loops scaling
    ``web`` up; with ``fence``, a leader deposed inside a pipelined tick;
    every member stopped and restarted from its WAL and snapshots, the new
    leader's loops placing a new service.  ``memory()`` reads the card's
    allocated bytes after each leadership change.

    A leader can also lose the lead unasked: the three members share one
    interpreter, and a member whose thread is held up long enough (a
    snapshot of the whole store, sealed) is taken for dead.  The script
    then does what a manager does: the successor's new loops take over
    and finish the stage (counted in ``unplanned``).  Returns the rows
    after each stage (:func:`control_rows`) and what each check saw."""
    import gc as _gc

    from swarmkit_tpu_torch.manager import (
        ControlAPI, WatchRequest, WatchServer,
    )
    from swarmkit_tpu_torch.ops.planner import DEVICE_FAULT_COUNTERS
    from swarmkit_tpu_torch.state.raft import (
        KeyEncoder, NotLeader, ProposalDropped,
    )
    from swarmkit_tpu_torch.utils.metrics import registry

    lost = (NotLeader, ProposalDropped)

    def key():
        return KeyEncoder(CONTROL_KEY)

    n = shape["n_nodes"]
    rec = {"rows": {}, "seconds": {}, "memory": [], "settled_memory": {},
           "checks": {}, "changes": [], "unplanned": 0}
    net, members = workload.raft_group(
        3, root, key, snapshot_interval=shape["snapshot_interval"],
        tick_interval=shape["tick_interval"])
    for rn in members.values():
        rn.store.changelog_limit = CONTROL_CHANGELOG
    voters = dict(members)
    loops = planner = cur = None

    def lead(rn, why):
        """``rn``'s loops take over: the old loops and planner dropped and
        the card's memory read (with the dropped planner's resident
        bytes), then a new planner and cold-started loops."""
        nonlocal loops, planner, cur
        resident = resident_bytes(planner)
        if loops is not None:
            loops.close()
        loops = planner = None
        _gc.collect()
        if memory:
            rec["memory"].append(dict(change=why, member=rn.id,
                                      allocated=memory(),
                                      resident=resident))
        rec["changes"].append((why, rn.id))
        cur = rn
        planner = planner_factory()
        loops = workload.ControlLoops(rn.store, planner)
        loops.cold_start()

    def unplanned():
        rec["unplanned"] += 1
        check(rec["unplanned"] <= CONTROL_UNPLANNED,
              f"replicated control: {rec['unplanned']} leadership changes "
              "nobody asked for")
        lead(workload.wait_leader(voters), "unplanned")

    def on_leader(fn):
        """``fn(leader)``, called again on the successor if the lead moves
        under it; ``fn`` must be safe to repeat."""
        while True:
            rn = workload.wait_leader(voters)
            if rn is not cur:
                unplanned()
                rn = cur
            try:
                return fn(rn)
            except lost:
                pass

    def settled(label, t0):
        while True:
            rn, epoch = cur, cur.leadership_epoch
            try:
                workload.settle(loops)
            except lost:
                pass
            if rn.is_leader and rn.leadership_epoch == epoch:
                break
            unplanned()
        rec["seconds"][label] = time.perf_counter() - t0
        if memory:
            rec["settled_memory"][label] = memory()

    def service(spec):
        """The named service, created through the leader's API unless an
        earlier try already committed it."""
        def make(rn):
            api = ControlAPI(rn.store)
            have = [s for s in api.list_services(spec.annotations.name)
                    if s.spec.annotations.name == spec.annotations.name]
            return have[0] if have else api.create_service(spec)
        return on_leader(make)

    try:
        t0 = time.perf_counter()
        lead(workload.wait_leader(voters), "elected")
        nodes = workload.rack_nodes(n)

        def setup(rn):
            store = rn.store
            if not store.view(lambda tx: tx.find(m.Cluster)):
                store.update(lambda tx: tx.create(m.Cluster(
                    id="cluster-default", spec=m.ClusterSpec(
                        annotations=m.Annotations(name="default")))))
            have = {x.id for x in store.view(lambda tx: tx.find(m.Node))}

            def register(batch):
                # one write a node, as nodes join; the batch cuts proposals
                for node in nodes:
                    if node.id not in have:
                        batch.update(lambda tx, node=node: tx.create(node))

            store.batch(register)

        on_leader(setup)
        streamed = cur
        stream = WatchServer(cur.store).watch(WatchRequest(kinds=[m.Task]))
        web = service(control_service(m, "web", shape["web"] * n, True))
        service(control_service(m, "agent"))
        settled("create", t0)
        rec["rows"]["create"] = control_rows(cur.store, m)
        leader = cur
        followers = [rn for rn in members.values() if rn is not leader]
        converge(members.values(), leader)
        assigned = (lambda tx: sorted(
            (t.id, t.node_id) for t in tx.find(m.Task)
            if t.node_id and t.status.state >= m.TaskState.ASSIGNED))
        want = leader.store.view(assigned)
        got = followers[0].store.read_view(assigned, linearizable=True,
                                           timeout=10.0)
        check(got == want and len(want) >= (shape["web"] + 1) * n,
              f"replicated control: a linearizable read on "
              f"{followers[0].id} saw {len(got)} assigned rows, the leader "
              f"{len(want)}")
        rec["checks"]["linearizable_read_rows"] = len(got)
        watcher = next(rn for rn in members.values() if rn is not streamed)
        rec["checks"]["watch"] = watch_resume(m, stream, watcher.store)

        # failover: the leader is cut off; the successor's new loops
        t0 = time.perf_counter()
        net.pause(leader.id)
        voters = {rn.id: rn for rn in followers}
        lead(workload.wait_leader(voters), "failover")

        def scale(rn):
            api = ControlAPI(rn.store)
            cur_svc = api.get_service(web.id)
            if cur_svc.spec.replicated.replicas != shape["scaled"] * n:
                spec = cur_svc.spec.copy()
                spec.replicated.replicas = shape["scaled"] * n
                api.update_service(web.id, cur_svc.meta.version.index, spec)

        on_leader(scale)
        settled("scale", t0)
        rec["rows"]["scale"] = control_rows(cur.store, m)
        net.resume(leader.id)
        voters = dict(members)
        converge(members.values(), cur)
        rec["failover"] = dict(deposed=leader.id, successor=cur.id)

        if fence:
            faults0 = {k: registry.get_counter(k)
                       for k in DEVICE_FAULT_COUNTERS}
            fplanner = planner_factory()
            f = on_leader(lambda rn: fence_tick(workload, m, rn, fplanner,
                                                shape))
            fenced = set(f["tasks"]) - f["first"]
            check(f["first"] and fenced, f"the fence tick's first block "
                  f"proposal held {len(f['first'])} of {len(f['tasks'])} "
                  "tasks: no draft was behind it")
            check(not fplanner._inflight and fplanner._fused_active is None,
                  "the deposed tick left plans in flight")
            check(fplanner.breaker.state == 0, f"the breaker is "
                  f"{fplanner.breaker.state} after a lost leadership")
            moved = {k: registry.get_counter(k) - v
                     for k, v in faults0.items() if registry.get_counter(k)
                     != v}
            check(not moved, f"a lost leadership moved {moved}")
            check(f["requeued"] >= len(fenced), f"the deposed tick "
                  f"requeued {f['requeued']} tasks, {len(fenced)} fenced")
            del fplanner
            third = workload.wait_leader(voters)
            after = converge(members.values(), third)

            def landed(tx):
                return {t.id for t in tx.find(m.Task)
                        if t.id.startswith("fence-") and t.node_id}

            for rn in members.values():
                got = rn.store.view(landed)
                check(not got & fenced and got in (set(), f["first"]),
                      f"replicated control: {len(got & fenced)} rows "
                      f"proposed under the deposed epoch landed on {rn.id}")
            rec["fence"] = dict(
                proposals=f["proposals"], first_chunk=len(f["first"]),
                first_chunk_landed=bool(third.store.view(landed)),
                requeued=f["requeued"], leader=third.id,
                store_bytes=len(after))
            lead(third, "fence")

            def remove(rn):
                def cb(tx):
                    for tid in f["tasks"]:
                        if tx.get(m.Task, tid) is not None:
                            tx.delete(m.Task, tid)
                    for sid in f["services"]:
                        if tx.get(m.Service, sid) is not None:
                            tx.delete(m.Service, sid)
                rn.store.update(cb)

            t0 = time.perf_counter()
            on_leader(remove)
            settled("fence", t0)
        converge(members.values(), cur)
        before = {rn.id: rn.store.save_bytes() for rn in members.values()}
        snaps = {rn.id: rn.stats["snapshots"] for rn in members.values()}
        check(all(snaps.values()), f"replicated control: a member took no "
              f"snapshot ({snaps})")

        # restart: every member stops and boots from its WAL and snapshot
        t0 = time.perf_counter()
        loops.close()
        loops = None
        for rn in members.values():
            rn.stop()
        net, members = workload.raft_group(
            3, root, key, snapshot_interval=shape["snapshot_interval"],
            tick_interval=shape["tick_interval"], start=False)
        voters = dict(members)
        for rn in members.values():
            check(rn.store.save_bytes() == before[rn.id],
                  f"replicated control: {rn.id} restarted unlike it "
                  "stopped")
            rn.start()
        lead(workload.wait_leader(voters), "restart")
        service(control_service(m, "batch", shape["batch"] * n, True))
        settled("restart", t0)
        rec["rows"]["restart"] = control_rows(cur.store, m)
        converge(members.values(), cur)
        rec["snapshots"] = snaps
        rec["raft_applied"] = {rn.id: rn.stats["applied"]
                               for rn in members.values()}
        return rec
    finally:
        if loops is not None:
            loops.close()
        for rn in members.values():
            rn.stop()


def control_models():
    """The port's model classes and ``new_id``, as one namespace."""
    import types as _types

    from swarmkit_tpu_torch import models
    from swarmkit_tpu_torch.utils import new_id
    names = {k: getattr(models, k) for k in dir(models)
             if not k.startswith("_")}
    return _types.SimpleNamespace(new_id=new_id, **names)


def run_control(workload, identity, planner_factory, shape, fence=True,
                memory=None):
    """:func:`control_script` in a temporary directory, with fixed ids."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="replicated-control-")
    fixed_ids(identity)
    try:
        t0 = time.perf_counter()
        rec = control_script(workload, control_models(), planner_factory,
                             root, shape, fence=fence, memory=memory)
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        identity.set_id_source(None)
        shutil.rmtree(root, ignore_errors=True)
    return rec


def check_control_memory(rec, label):
    """Card memory after each leadership change, the old planner dropped
    and collected: from the first change on (before it no planner has
    run, so the kernels' per-device workspaces are not yet made) it may
    grow by at most one resident state a change."""
    mem = rec["memory"]
    for prev, cur in zip(mem[1:], mem[2:]):
        grew = cur["allocated"] - prev["allocated"]
        check(grew <= max(cur["resident"], prev["resident"]),
              f"{label}: card memory grew {grew} bytes from the "
              f"{prev['change']} change to the {cur['change']} change, "
              f"above one resident state ({cur['resident']} bytes)")


def phase_replicated_control(torch, K, cuda, workload, identity,
                             TorchPlanner, card):
    """Phase 25: :func:`control_script` at ``CONTROL``'s width on the card
    (its fence stage included) and through the host path; equal rows after
    the create, the successor's scale-up and the restart's new service."""
    cuda.reset_launch_counts(K.KERNELS)
    run = run_control(workload, identity, TorchPlanner, CONTROL,
                      memory=torch.cuda.memory_allocated)
    torch.cuda.synchronize()
    launches = cuda.launch_counts(K.KERNELS)
    print("replicated control: card memory after each leadership change "
          "(allocated bytes, the dropped planner's resident bytes): "
          + ", ".join(f"{m['change']} {m['allocated']} ({m['resident']})"
                      for m in run["memory"])
          + f"; after each stage {run['settled_memory']}", flush=True)
    check_control_memory(run, "replicated control")
    for k in (K.FEASIBILITY, K.SEG_SUM, K.WATERFILL, K.FUSED_FEASIBILITY,
              K.FUSED_CARRY):
        check(launches[k.name] > 0, f"replicated control: {k.name} never "
              "launched")
    host = run_control(workload, identity, lambda: None, CONTROL,
                       fence=False)
    for stage in CONTROL_STAGES:
        check(control_counts(run["rows"][stage])
              == control_counts(host["rows"][stage]),
              f"replicated control, {stage}: the card's live tasks per "
              "(service, node) differ from the host path's")
    out = dict(
        seconds=run["seconds"], host_seconds=host["seconds"],
        wall_s=run["wall_s"], host_wall_s=host["wall_s"],
        rows={s: len(run["rows"][s]) for s in CONTROL_STAGES},
        checks=run["checks"], failover=run["failover"],
        fence=run["fence"], snapshots=run["snapshots"],
        raft_applied=run["raft_applied"], memory=run["memory"],
        settled_memory=run["settled_memory"], changes=run["changes"],
        unplanned=run["unplanned"],
        launches={k: v for k, v in launches.items() if v})
    print(f"replicated control: {CONTROL['n_nodes']} nodes, 3 members; "
          "stages " + ", ".join(f"{k} {v:.1f} s"
                                for k, v in run["seconds"].items())
          + f" (host path: " + ", ".join(
              f"{k} {v:.1f} s" for k, v in host["seconds"].items())
          + f"); {out['rows']} live tasks, per (service, node) equal "
          "to the host path's; "
          f"follower read {run['checks']['linearizable_read_rows']} rows; "
          f"watch resumed {run['checks']['watch']}; fence {run['fence']}; "
          f"snapshots {run['snapshots']}; leadership changes "
          f"{run['changes']} ({run['unplanned']} unasked); launches "
          f"{out['launches']}; on {card}", flush=True)
    return out


# ------------------------------------------ phase 26: the million swarm

#: phase 26's replicas: bench.py's config 13 carries 1,000,000; the
#: script's time limit cuts them (the sessions, services, pending cap and
#: report batch stay config 13's): at 250,000 the whole script took
#: 911-948 s on an H100 80GB HBM3 at 700 W, too near the limit on a
#: slower host, so 100,000 (each 100,000 replicas cost ~17 s of fan-out
#: and write-back there);
#: ``probes/million_swarm_probe.py`` runs the full depth
CFG13_REPLICAS = 100_000
#: the parity run: 100 sessions and a replica count whose every service
#: is a multiple of the sessions (no tie for the spread to break), under
#: an admission bound the write-back overflows
CFG13_PARITY = dict(n_agents=100, n_replicas=10_000, pending_cap=1024,
                    report_batch=64)


def swarm_counts(run):
    """Live replicas per (service, hostname) of a ``million_swarm`` run:
    its tasks are made service by service, in equal runs."""
    per = run["replicas"] // run["services"]
    return Counter((min(i // per, run["services"] - 1), host)
                   for i, host in enumerate(run["placements"]))


def phase_million_swarm(torch, K, cuda, workload, TorchPlanner, card):
    """Phase 26: bench.py's config 13 through ``workload.million_swarm``
    on the card at 1,000 sessions and ``CFG13_REPLICAS``; then the parity
    run on the card and through the host path."""
    cuda.reset_launch_counts(K.KERNELS)
    run = workload.million_swarm(TorchPlanner,
                                 n_replicas=CFG13_REPLICAS)
    torch.cuda.synchronize()
    launches = cuda.launch_counts(K.KERNELS)
    lab = "million swarm"
    n = run["replicas"]
    sheds = run["sheds"]
    check(run["time_to_running"]["running"] == n,
          f"{lab}: {run['time_to_running']['running']} of {n} RUNNING")
    check(run["sessions"] == workload.SWARM_AGENTS,
          f"{lab}: {run['sessions']} sessions")
    check(sheds["dispatcher"] == sheds["client_observed"]
          and sheds["uncounted"] == 0 and sheds["unrecovered"] == 0,
          f"{lab}: the shed ledger does not reconcile: {sheds}")
    check(sheds["dispatcher"] >= 1, f"{lab}: nothing shed, the admission "
          "edge was never reached")
    check(run["premature_expirations"] == 0,
          f"{lab}: {run['premature_expirations']} premature expirations")
    check(run["hb_stretch_factor"] > 1.0,
          f"{lab}: the heartbeat did not stretch "
          f"({run['hb_stretch_factor']})")
    check(run["fanout_changes"] == n,
          f"{lab}: {run['fanout_changes']} fan-out changes for {n} replicas")
    check(not any(run["compiles"].values()) and run["build_s"] == 0.0,
          f"{lab}: a kernel build inside the timed tick: "
          f"{run['compiles']}, {run['build_s']} s")
    for k in (K.FUSED_FEASIBILITY, K.FUSED_CARRY):
        check(run["launches"][k.name] > 0 and launches[k.name] > 0,
              f"{lab}: {k.name} never launched in the tick")
    for key in ("groups_spill_to_host",) + HOST_ROUTES:
        check(run["planner_stats"].get(key, 0) == 0,
              f"{lab}: {key} = {run['planner_stats'].get(key)}")
    ttr = run["time_to_running"]
    print(f"million swarm: {run['sessions']} sessions, {n} replicas of "
          f"{run['services']} services (config 13 has "
          f"{workload.SWARM_REPLICAS}); tick {run['tick_s']:.3f} s "
          f"({run['decisions_per_sec']:.0f} decisions/s), register "
          f"{run['register_s']:.3f} s, stream open "
          f"{run['stream_open_s']:.3f} s, fan-out {run['fanout_s']:.3f} s "
          f"({run['fanout_messages']} messages, {run['fanout_changes']} "
          f"changes), write-back {run['writeback_s']:.3f} s in "
          f"{run['writeback_rounds']} rounds (peak depth "
          f"{run['peak_update_depth']}); sheds {sheds}; heartbeat stretch "
          f"x{run['hb_stretch_factor']:.3f} ({run['hb_stretches']} "
          f"stretched), premature expirations "
          f"{run['premature_expirations']}; time to running p50 "
          f"{ttr['p50_s']:.3f} s, p90 {ttr['p90_s']:.3f}, p99 "
          f"{ttr['p99_s']:.3f}, max {ttr['max_s']:.3f}; compiles in the "
          f"tick {run['compiles']}; launches "
          f"{ {k: v for k, v in run['launches'].items() if v} }; groups "
          f"fused {run['planner_stats'].get('groups_fused', 0)}; on {card}",
          flush=True)
    print("million swarm planes: " + json.dumps(run["planes"]), flush=True)

    dev = workload.million_swarm(TorchPlanner, **CFG13_PARITY)
    host = workload.million_swarm(lambda: None, **CFG13_PARITY)
    plab = f"million swarm parity ({CFG13_PARITY['n_agents']} sessions)"
    check(swarm_counts(dev) == swarm_counts(host),
          f"{plab}: replicas per (service, node) differ from the host "
          "path's")
    for key in ("sheds", "writeback_rounds", "fanout_messages",
                "fanout_changes"):
        check(dev[key] == host[key],
              f"{plab}: {key} {dev[key]} on the card, {host[key]} on the "
              "host path")
    print(f"{plab}: {CFG13_PARITY['n_replicas']} replicas, per (service, "
          f"node) equal to the host path's; sheds {dev['sheds']['dispatcher']}"
          f" in {dev['writeback_rounds']} rounds and "
          f"{dev['fanout_changes']} fan-out changes both ways", flush=True)
    keep = ("agents", "replicas", "services", "sessions", "decisions",
            "decisions_per_sec", "tick_s", "register_s", "stream_open_s",
            "fanout_s", "fanout_messages", "fanout_changes",
            "fanout_compactions", "writeback_s", "writeback_rounds",
            "peak_update_depth", "heartbeats", "hb_stretch_factor",
            "hb_stretches", "premature_expirations", "expirations", "sheds",
            "time_to_running", "planes", "compiles", "build_s")
    out = {k: run[k] for k in keep}
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["parity"] = {"sessions": CFG13_PARITY["n_agents"],
                     "replicas": CFG13_PARITY["n_replicas"],
                     "sheds": dev["sheds"],
                     "writeback_rounds": dev["writeback_rounds"],
                     "tick_s": dev["tick_s"], "host_tick_s": host["tick_s"]}
    return out


# ------------------------------------------------- phase 27: the end to end

def phase_e2e(torch, K, cuda, workload, card):
    """Phase 27: bench.py's ``run_e2e`` through ``workload.e2e`` with
    ``Manager()`` (the card): standalone, then the heal on the same
    manager, then over a single-voter raft with a sealed WAL; the card's
    memory after each manager stops."""
    import shutil
    import tempfile

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    out = {}
    for label in ("standalone", "raft"):
        root = tempfile.mkdtemp(prefix="e2e-raft-") if label == "raft" \
            else None
        before = allocated()
        cuda.reset_launch_counts(K.KERNELS)
        try:
            run = workload.e2e(raft_root=root, heal=label == "standalone")
        finally:
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)
        torch.cuda.synchronize()
        launches = cuda.launch_counts(K.KERNELS)
        after = allocated()
        lab = f"e2e ({label})"
        check(run["planner"] == "TorchPlanner"
              and run["planner_device"].startswith("cuda"),
              f"{lab}: the leader planned on {run['planner']} "
              f"({run['planner_device']})")
        check(launches[K.FEASIBILITY.name] > 0,
              f"{lab}: {K.FEASIBILITY.name} never launched")
        counts = list(run["per_host"].values())
        check(sum(counts) == run["replicas"]
              and len(counts) == run["agents"]
              and max(counts) - min(counts) <= 1,
              f"{lab}: replicas per node {run['per_host']}")
        check(after <= before, f"{lab}: card memory {after} bytes after "
              f"the manager stopped, {before} before it was built")
        crit = run["journey_attribution"]
        line = (f"e2e ({label}): {run['agents']} agents, {run['replicas']} "
                f"replicas RUNNING through Manager(); time to running p50 "
                f"{run['p50_s']:.3f} s, p90 {run['p90_s']:.3f}, p99 "
                f"{run['p99_s']:.3f}, max {run['max_s']:.3f}; critical path "
                f"at p99 " + json.dumps(crit.get("planes", crit))
                + f"; per node {run['per_host']}; launches "
                f"{ {k: v for k, v in launches.items() if v} } (K7 "
                f"{'launched' if launches[K.SCATTER.name] else 'not launched'}"
                f"); card memory {before} -> {after} bytes")
        if "heal" in run:
            heal = run["heal"]
            check(heal["nodes"] == run["agents"] - 1,
                  f"{lab}: healed onto {heal['nodes']} nodes")
            line += (f"; heal: node DOWN {heal['down_s']:.2f} s after its "
                     f"agent stopped, every replica RUNNING on the "
                     f"{heal['nodes']} others {heal['running_s']:.2f} s "
                     "after")
        if "wal_bytes" in run:
            line += (f"; raft: {run['raft_entries_applied']} entries "
                     f"applied, WAL {run['wal_bytes']} bytes")
        print(line + f"; on {card}", flush=True)
        run["launches"] = {k: v for k, v in launches.items() if v}
        run["memory"] = {"before": before, "after": after}
        out[label] = run
    return out


# ---------------------------------------------------- phase 28: the daemons

def phase_swarmd(torch, K, cuda, workload, card):
    """Phase 28: ``workload.daemon_swarm`` at three managers and 16
    workers on the card (create through the CLI, the leader's failover,
    the scale through the CLI), ``rafttool`` on a surviving follower's
    sealed state dir, the card's memory after every daemon stopped; then
    the parity script (``workload.SWARMD_PARITY``) on the card and on the
    host path."""
    import shutil
    import tempfile

    from swarmkit_tpu_torch import rafttool

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    lab = "swarmd"
    seen = {}

    def on_running(leader):
        torch.cuda.synchronize()
        seen["launches"] = cuda.launch_counts(K.KERNELS)
        seen["stats"] = dict(leader.manager.scheduler.batch_planner.stats)

    before = allocated()
    root = tempfile.mkdtemp(prefix="swarmd-")
    try:
        cuda.reset_launch_counts(K.KERNELS)
        run = workload.daemon_swarm(root, snapshot=True,
                                    on_running=on_running)
        torch.cuda.synchronize()
        launches = cuda.launch_counts(K.KERNELS)
        after = allocated()
        state = run["state_dir"]
        services = rafttool.dump_objects(state, "services")
        wal = rafttool.dump_wal(state)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_nodes = workload.SWARMD_MANAGERS + workload.SWARMD_WORKERS
    per, ttr = run["per_host"], run["time_to_running"]
    heal, scaled = per["heal"], per["scale"]
    undecoded = sum(r.get("actions") == "<undecodable>" for r in wal)
    print(f"swarmd: {workload.SWARMD_MANAGERS} managers + "
          f"{workload.SWARMD_WORKERS} workers up in {run['bootstrap_s']:.2f}"
          f" s; {workload.SWARMD_REPLICAS} replicas through the CLI, time "
          f"to running p50 {ttr['p50_s']:.3f} s, p90 {ttr['p90_s']:.3f}, "
          f"p99 {ttr['p99_s']:.3f}, max {ttr['max_s']:.3f}; "
          f"{run['stopped']} (the leader) stopped: "
          f"{run['leader']} leads after {run['leader_s']:.2f} s on "
          f"{run['new_planner']} ({run['new_planner_device']}), its node "
          f"DOWN after {run['down_s']:.2f} s, every replica RUNNING after "
          f"{run['running_s']:.2f} s (flapped {run['flapped']}; "
          f"{len(run['on_leader'])} of {workload.SWARMD_WORKERS} workers "
          f"on the leader then); heal {sorted(heal.values())}; scaled to "
          f"{workload.SWARMD_SCALED}: {sorted(scaled.values())} in "
          f"{run['scale_s']:.2f} s; snapshot {run['snapshot_s']:.2f} s; stop "
          f"{run['stop_s']:.2f} s; rafttool read {len(wal)} WAL records of "
          f"{os.path.basename(state)}; launches "
          f"{ {k: v for k, v in launches.items() if v} } (create "
          f"{ {k: v for k, v in seen['launches'].items() if v} }); card "
          f"memory {before} -> {after} bytes; on {card}", flush=True)
    for key in ("planner", "new_planner"):
        dev = run[key + "_device"] or ""
        check(run[key] == "TorchPlanner" and dev.startswith("cuda"),
              f"{lab}: the {key.replace('_', ' ')} is {run[key]} on {dev}")
    check(run["stopped"].startswith("m") and run["leader"].startswith("m")
          and run["leader"] != run["stopped"],
          f"{lab}: {run['leader']} leads after {run['stopped']} stopped")
    check(len(per["create"]) == n_nodes and set(per["create"].values())
          == {workload.SWARMD_REPLICAS // n_nodes},
          f"{lab}: replicas per node after the create {per['create']}")
    for k in (K.FEASIBILITY, K.SEG_SUM, K.WATERFILL):
        check(seen["launches"][k.name] > 0,
              f"{lab}: {k.name} never launched for the create")
    for key in HOST_ROUTES:
        check(seen["stats"].get(key, 0) == 0,
              f"{lab}: {key} = {seen['stats'].get(key)}")
    # a node that went DOWN on the way (its agent late to the new leader)
    # lost its replicas; the others stay within one of each other, and
    # every worker among them failed over to the leader through remotes
    steady = [n for h, n in heal.items() if h not in run["flapped"]]
    late = [f"w{i}" for i in range(workload.SWARMD_WORKERS)
            if f"w{i}" not in run["on_leader"]]
    check(set(late) <= set(run["flapped"]),
          f"{lab}: workers {late} not on the leader after the heal, "
          f"flapped {run['flapped']}")
    check(run["stopped"] not in heal
          and sum(heal.values()) == workload.SWARMD_REPLICAS
          and max(steady) - min(steady) <= 1,
          f"{lab}: replicas per node after the heal {heal} (flapped: "
          f"{run['flapped']})")
    check(run["stopped"] not in scaled
          and len(scaled) >= n_nodes - 1 - len(run["flapped"])
          and sum(scaled.values()) == workload.SWARMD_SCALED
          and workload.swarm_spread_ok(heal, scaled),
          f"{lab}: replicas per node after the scale {scaled} (after the "
          f"heal {heal})")
    check(run["flapped"] or (len(scaled) == n_nodes - 1 and set(
        scaled.values()) == {workload.SWARMD_SCALED // (n_nodes - 1)}),
          f"{lab}: no node flapped, yet the scale is uneven: {scaled}")
    check(after <= before, f"{lab}: card memory {after} bytes after every "
          f"daemon stopped, {before} before the first was built")
    check([(o["spec"]["annotations"]["name"],
            o["spec"]["replicated"]["replicas"]) for o in services]
          == [("web", workload.SWARMD_SCALED)],
          f"{lab}: rafttool dump-object services on "
          f"{os.path.basename(state)} gave "
          f"{[o['spec']['annotations']['name'] for o in services]}")
    check(wal and undecoded == 0,
          f"{lab}: rafttool dump-wal: {undecoded} of {len(wal)} records "
          "undecodable")

    def parity_run(on_card):
        root = tempfile.mkdtemp(prefix="swarmd-parity-")
        try:
            return workload.daemon_swarm(root, use_device_scheduler=on_card,
                                         **workload.SWARMD_PARITY)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # the two small swarms side by side: each waits on heartbeats most of
    # its time
    from concurrent.futures import ThreadPoolExecutor
    t_parity = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        runs = {name: pool.submit(parity_run, on_card)
                for name, on_card in (("card", True), ("host", False))}
        parity = {name: f.result() for name, f in runs.items()}
    plab = (f"swarmd parity ({workload.SWARMD_PARITY['n_managers']} manager"
            f", {workload.SWARMD_PARITY['n_workers']} workers)")
    check(parity["card"]["planner_device"].startswith("cuda")
          and parity["host"]["planner"] is None,
          f"{plab}: planners {parity['card']['planner_device']} / "
          f"{parity['host']['planner']}")
    for stage in ("create", "heal"):
        a = sorted(parity["card"]["per_host"][stage].values())
        b = sorted(parity["host"]["per_host"][stage].values())
        check(a == b, f"{plab}: replicas per node after the {stage}: {a} "
              f"on the card, {b} on the host path")
    card_run = parity["card"]["per_host"]
    print(f"{plab}: {workload.SWARMD_PARITY['replicas']} replicas per node "
          f"{sorted(card_run['create'].values())}, after a worker's stop "
          f"{sorted(card_run['heal'].values())} on the card and on the host "
          f"path ({time.perf_counter() - t_parity:.2f} s, side by side)",
          flush=True)
    keep = ("bootstrap_s", "time_to_running", "stopped", "leader",
            "final_leader", "leader_s",
            "down_s", "running_s", "scale_s", "snapshot_s", "stop_s",
            "flapped", "on_leader",
            "per_host", "planner", "planner_device", "new_planner",
            "new_planner_device", "heartbeat_s")
    out = {k: run[k] for k in keep}
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["create_launches"] = {k: v for k, v in seen["launches"].items()
                              if v}
    out["memory"] = {"before": before, "after": after}
    out["wal_records"] = len(wal)
    out["parity"] = {name: {k: r[k] for k in ("per_host", "down_s",
                                              "running_s")}
                     for name, r in parity.items()}
    return out


# -------------------------------------------------- phase 29: the simulator

#: the seed every device scenario of the simulator runs at, on the card and
#: on the CPU
SIM_SEED = 5
#: the registry counters of work that left the card: a device error, an
#: open breaker or the small-group router
OFF_CARD_ROUTE = 'swarm_planner_groups{route="host_small"}'
#: counters no scenario may move even where its script trips a breaker
#: (``fused-differential-churn`` does, on both devices): a device error
DEVICE_ERRORS = ("swarm_planner_groups_device_error",
                 "swarm_planner_gang_device_error",
                 "swarm_planner_preempt_device_error")


def workspace_bytes(K):
    """Bytes of the kernels' per-device workspaces on the card (K2's
    accumulator and its outputs per segment count, K8's workspace): made at
    the first use of a shape and kept, each tensor rounded up to the caching
    allocator's 512-byte blocks."""
    stack = [list(K._SEG_SUM_ACC.values()), list(K._SEG_SUM_OUT.values()),
             list(K._GANG_WORK.values())]
    total = 0
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif hasattr(x, "element_size") and x.is_cuda:
            total += -(-x.numel() * x.element_size() // 512) * 512
    return total


def phase_sim(torch, K, P, cuda, workload, registry, planner_mod, card):
    """Phase 29: the simulator's ten device scenarios
    (``workload.SIM_DEVICE_SCENARIOS``) at ``SIM_SEED`` through the port's
    ``run_scenario`` on the card and on the CPU: each run free of
    violations, the two runs' reports equal (engine trace hash, events,
    stats, violations, journey ledger) and their span traces equal but for
    ``plan.compile``; kernels launched on the card (K9 by the preemption
    storm, K8 by the gang deadlock, K7 by the steady-state churn); the
    counters of work that left the card moved on the card exactly as on
    the CPU and no device error; card memory after the phase back at its
    level before it but for the kernels' workspaces of first use."""
    import importlib
    scenario = importlib.import_module("swarmkit_tpu_torch.sim.scenario")
    kernels = K.KERNELS + P.KERNELS
    must = {"preemption-storm": P.VICTIMS, "gang-deadlock": K.GANG_FIT,
            "steady-state-churn": K.SCATTER}
    watched = planner_mod.DEVICE_FAULT_COUNTERS + (OFF_CARD_ROUTE,)
    dumps = os.path.join("chiprun_out", "sim_flightrec")
    os.makedirs(dumps, exist_ok=True)

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def counters():
        return {k: registry.get_counter(k) for k in watched}

    def run(name, device):
        c0, t0 = counters(), time.perf_counter()
        rep = scenario.run_scenario(name, SIM_SEED, device=device,
                                    flightrec_dir=dumps)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = {k: v - c0[k] for k, v in counters().items() if v != c0[k]}
        return rep, seconds, moved

    before, work0 = allocated(), workspace_bytes(K)
    out = {}
    for name in workload.SIM_DEVICE_SCENARIOS:
        lab = f"sim {name} (seed {SIM_SEED})"
        cuda.reset_launch_counts(kernels)
        on_card, card_s, card_moved = run(name, "cuda")
        launches = {k: v for k, v in cuda.launch_counts(kernels).items()
                    if v}
        on_cpu, cpu_s, cpu_moved = run(name, "cpu")
        for dev, rep in (("card", on_card), ("cpu", on_cpu)):
            check(rep.ok and not rep.violations,
                  f"{lab}: violations on the {dev}: {rep.violations[:3]} "
                  f"(post-mortem {rep.flightrec_path})")
        for key in ("trace_hash", "events", "stats", "violations",
                    "journeys_sha256"):
            check(getattr(on_card, key) == getattr(on_cpu, key),
                  f"{lab}: {key} differs between the card and the CPU")
        spans_card = workload.sim_obs_events(on_card.obs_trace)
        spans_cpu = workload.sim_obs_events(on_cpu.obs_trace)
        first = next((i for i, (a, b) in enumerate(zip(spans_card,
                                                       spans_cpu))
                      if a != b), min(len(spans_card), len(spans_cpu)))
        check(spans_card == spans_cpu,
              f"{lab}: span traces differ ({len(spans_card)} spans on the "
              f"card, {len(spans_cpu)} on the CPU; first difference at "
              f"{first}: "
              f"{spans_card[first] if first < len(spans_card) else None} / "
              f"{spans_cpu[first] if first < len(spans_cpu) else None})")
        check(launches, f"{lab}: no kernel launched on the card")
        if name in must:
            check(launches.get(must[name].name, 0) > 0,
                  f"{lab}: {must[name].name} never launched ({launches})")
        check(card_moved == cpu_moved,
              f"{lab}: off-card counters moved {card_moved} on the card, "
              f"{cpu_moved} on the CPU")
        check(not any(card_moved.get(k) for k in DEVICE_ERRORS)
              and not card_moved.get(OFF_CARD_ROUTE),
              f"{lab}: work left the card: {card_moved}")
        print(f"{lab}: {card_s:.2f} s on the card, {cpu_s:.2f} s on the "
              f"CPU; {on_card.events} events, trace {on_card.trace_hash[:12]}"
              f", {len(spans_card)} spans; launches {launches}"
              + (f"; scripted breaker counters {card_moved}"
                 if card_moved else ""), flush=True)
        out[name] = {"card_s": card_s, "cpu_s": cpu_s,
                     "events": on_card.events,
                     "trace_hash": on_card.trace_hash,
                     "spans": len(spans_card), "launches": launches,
                     "counters_moved": card_moved}
    after, work1 = allocated(), workspace_bytes(K)
    check(after - before <= work1 - work0,
          f"sim: card memory {before} -> {after} bytes over the phase, "
          f"above the kernels' new workspaces ({work1 - work0} bytes)")
    print(f"sim: {len(out)} device scenarios equal on the card and on the "
          f"CPU; card memory {before} -> {after} bytes (new workspaces "
          f"{work1 - work0} bytes); on {card}", flush=True)
    return {"seed": SIM_SEED, "scenarios": out,
            "memory": {"before": before, "after": after,
                       "new_workspaces": work1 - work0}}


def phase(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds kept in ``PHASE_S[name]``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
    return out


def device_faults(registry, planner_mod):
    return {name: registry.get_counter(name)
            for name in planner_mod.DEVICE_FAULT_COUNTERS}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    try:
        from swarmkit_tpu_torch import native, workload
        from swarmkit_tpu_torch.models import (
            Platform, Service, Task, TaskState,
        )
        from swarmkit_tpu_torch.models import types
        from swarmkit_tpu_torch.obs import tracer
        from swarmkit_tpu_torch.ops import TorchPlanner, cuda
        from swarmkit_tpu_torch.ops import kernel as K
        from swarmkit_tpu_torch.ops import planner as planner_mod
        from swarmkit_tpu_torch.ops import preempt as P
        from swarmkit_tpu_torch.ops.convert import (
            fused_to_device, gang_to_device, to_device, victims_to_device)
        from swarmkit_tpu_torch.parallel import make_mesh
        from swarmkit_tpu_torch.scheduler import Scheduler
        from swarmkit_tpu_torch.state import serde
        from swarmkit_tpu_torch.state.events import EventTaskBlock
        from swarmkit_tpu_torch.utils import identity
        from swarmkit_tpu_torch.utils.metrics import registry
    except ImportError as exc:
        fail(f"the swarmkit_tpu_torch package is not importable: {exc}")

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card} (torch sees {kind} x{count}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    # the manager's CA needs the cryptography package; no phase does
    try:
        import cryptography
        crypto = cryptography.__version__
        print(f"cryptography: {crypto} imports", flush=True)
    except ImportError as exc:
        crypto = None
        print(f"cryptography: does not import ({exc})", flush=True)

    # the native C commit plane runs under every phase; a run without it
    # (no C compiler) fails here
    set_native(True)
    t0 = time.perf_counter()
    check(native.get() is not None, "the native C commit plane did not "
          "build (native.get() is None)")
    print(f"native plane: {native.loaded_path()} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    fallbacks0 = registry.get_counter("swarm_native_commit_fallbacks")
    faults0 = device_faults(registry, planner_mod)

    build = phase("build", phase_build, cuda)
    rows, plan = phase("kernels", phase_kernels, torch, K, to_device)
    fused_rows, chunk = phase("kernels_fused", phase_kernels_fused, torch, K,
                              fused_to_device)
    rows += fused_rows
    main_path, headline_plans = phase(
        "main_path", phase_main_path, torch, K, cuda, workload, Task,
        Scheduler, TorchPlanner, card)
    traced = phase("traced_tick", phase_traced_tick, torch,
                   workload.headline_cluster, Scheduler, TorchPlanner,
                   tracer, card)
    oracle = phase("host_oracle", phase_host_oracle, workload, Task,
                   Platform, TorchPlanner)
    many, many_plans, many_counts = phase(
        "many_service", phase_many_service, torch, K, cuda, workload, Task,
        Scheduler, TorchPlanner, card)
    many_traced = phase(
        "traced_many_service", phase_traced_tick, torch,
        workload.many_service_cluster, Scheduler, TorchPlanner, tracer,
        card, label="traced many-service tick")
    oracle["many_service_1k"] = phase(
        "many_service_oracle", phase_many_service_oracle, workload, Task,
        Scheduler, TorchPlanner)
    native_run = phase("native", phase_native, torch, native, identity,
                       EventTaskBlock, workload, Task, Scheduler,
                       TorchPlanner, tracer, card)
    # the breaker's phase injects launch errors: its counts are its own
    faults1 = device_faults(registry, planner_mod)
    breaker = phase("breaker", phase_breaker, torch, K, cuda, workload,
                    Task, Scheduler, TorchPlanner, planner_mod, registry,
                    card)
    faults2 = device_faults(registry, planner_mod)
    resident_rows, resident_kernels = phase(
        "kernels_resident", phase_kernels_resident, torch, K,
        gang_to_device)
    rows += resident_rows
    churn = phase("churn", phase_churn, torch, K, cuda, workload,
                  TorchPlanner, make_mesh, card)
    churn["traced"] = phase("traced_churn", phase_traced_churn, torch,
                            workload, TorchPlanner, tracer, card)
    gang = phase("gang", phase_gang, torch, K, cuda, workload, Task,
                 Scheduler, TorchPlanner, gang_to_device, card)
    jobs, config8_calls = phase(
        "priority_jobs", phase_priority_jobs, torch, K, P, cuda, workload,
        Task, Scheduler, TorchPlanner, card)
    victim_rows, victim_kernels = phase(
        "kernels_victims", phase_kernels_victims, torch, P,
        victims_to_device, config8_calls)
    rows += victim_rows
    storm = phase("storm", phase_storm, torch, K, P, cuda, workload, Task,
                  Scheduler, TorchPlanner, victims_to_device, tracer, card)
    mesh_rows, mesh_cases = phase("kernels_mesh", phase_kernels_mesh, torch,
                                  K)
    rows += mesh_rows
    mesh = {"kernel_cases": mesh_cases}
    mesh["compositions"] = phase(
        "mesh_compositions", phase_mesh_compositions, torch, K, to_device,
        fused_to_device)
    mesh["headline"] = phase(
        "mesh_headline", phase_mesh_headline, torch, K, cuda, workload,
        Task, Scheduler, TorchPlanner, make_mesh, card, headline_plans,
        main_path["rack_counts"])
    mesh["many_service"] = phase(
        "mesh_many_service", phase_mesh_many_service, torch, K, cuda,
        workload, Task, Scheduler, TorchPlanner, make_mesh, card,
        many_plans, many_counts)
    mesh["traced_many_service"] = phase(
        "traced_mesh_many_service", phase_traced_tick, torch,
        workload.many_service_cluster, Scheduler,
        lambda: mesh_planner(TorchPlanner, make_mesh), tracer, card,
        label="traced mesh many-service tick")
    wide = phase("wide_spread", phase_wide_spread, torch, K, cuda, workload,
                 Task, Scheduler, TorchPlanner, make_mesh, card)
    life = phase("service_life", phase_service_life, torch, K, cuda,
                 workload, types, identity, Task, TaskState, Service,
                 TorchPlanner, tracer, card)
    tenant = phase("tenant_storm", phase_tenant_storm, torch, K, cuda,
                   workload, Task, TaskState, TorchPlanner, card)
    live = phase("live_manager", phase_live_manager, torch, K, cuda,
                 workload, Task, TorchPlanner, serde, tracer, card)
    control = phase("replicated_control", phase_replicated_control, torch,
                    K, cuda, workload, identity, TorchPlanner, card)
    swarm = phase("million_swarm", phase_million_swarm, torch, K, cuda,
                  workload, TorchPlanner, card)
    e2e = phase("e2e", phase_e2e, torch, K, cuda, workload, card)
    swarmd = phase("swarmd", phase_swarmd, torch, K, cuda, workload, card)
    faults3 = device_faults(registry, planner_mod)
    moved = {k: faults1[k] - faults0[k] + faults3[k] - faults2[k]
             for k in faults0}
    check(not any(moved.values()), f"work left the card for a device "
          f"fault or an open breaker: {moved}")
    # after the run-wide check: a sim scenario may trip a breaker on
    # purpose, and the phase holds those counters to its CPU twin's
    sim = phase("sim", phase_sim, torch, K, P, cuda, workload, registry,
                planner_mod, card)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in PHASE_S.items()),
          flush=True)

    # each kernel's launches from the main path that runs it
    path_launches = dict(many["launches"])
    path_launches["feasibility"] = main_path["launches"]["feasibility"]
    path_launches["scatter_rows"] = \
        churn["streaming"]["launches"]["scatter_rows"]
    path_launches["gang_fit"] = gang["card"]["launches"]["gang_fit"]
    path_launches["select_victims"] = storm["launches"]["select_victims"]
    for k in (K.SHARD_SEG_SUM, K.SHARD_WATERFILL, K.SHARD_PACKFILL):
        path_launches[k.name] = mesh["many_service"]["launches"][k.name]
    kernels = []
    for r in rows:
        k = r["kernel"]
        bound_ms, bound_by = bound(r["bytes"], r["ops"])
        if k is K.GANG_FIT:
            r["err"] = max(r["err"], gang["k8_on_fleet"]["err"])
        kernels.append({
            "name": r.get("name", k.name), "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": path_launches[k.name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"]})
    fallbacks = registry.get_counter("swarm_native_commit_fallbacks") \
        - fallbacks0
    check(fallbacks == 0 and native.get() is not None,
          f"the native plane fell back {fallbacks} times during the run")
    record = {"card": card, "kind": kind, "build_s": build.seconds,
              "kernels": kernels,
              "device_ms": {r.get("name", r["kernel"].name): r["device_ms"]
                            for r in rows},
              "plan_group": plan, "fused_chunk": chunk,
              "main_path": main_path, "traced_tick": traced,
              "many_service": many, "traced_many_service": many_traced,
              "host_oracle": oracle, "resident_kernels": resident_kernels,
              "churn": churn, "gang": gang,
              "victim_kernels": victim_kernels, "priority_jobs": jobs,
              "storm": storm, "mesh": mesh, "per_host_spread": wide,
              "native": native_run, "native_fallbacks": fallbacks,
              "breaker": breaker, "service_life": life,
              "tenant_storm": tenant, "live_manager": live,
              "replicated_control": control, "million_swarm": swarm,
              "e2e": e2e, "swarmd": swarmd, "sim": sim,
              "cryptography": crypto,
              "device_faults": moved,
              "phase_seconds": PHASE_S,
              "profiler_sessions": PROFILE_LOG,
              "seconds": time.perf_counter() - t_start}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
