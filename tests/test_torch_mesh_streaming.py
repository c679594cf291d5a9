"""The port's planner over a node-axis split on the CPU, against the
reference's.

Mirrors the reference's ``tests/test_mesh_streaming.py`` (the churn
differential at ``:302``, resident shards against the mirror at ``:317``,
the strategy cases at ``:395`` and ``:423``, the epoch resync at ``:443``,
teardown and shard count at ``:468``, the divergence resync at ``:516``)
and ``tests/test_fused.py:410`` (fused parity over a mesh) with
``TorchPlanner(device="cpu", mesh=make_mesh(["cpu"] * D))``.  The churn
runs through each package's store watch feed with the same ids, so the
port's mesh run is held task by task against the reference's
``TPUPlanner`` on a D-device mesh (D in {2, 4, 8}), against the port's
unsharded planner (decisions, store rows and the watch-event stream), and
the resident tier's counters against the reference's ``ResidentState``.

Not mirrored: the reference's sim differential (``:549``) and its
bench-gate case (``:561``), which drive the reference's ``sim`` package
and ``scripts/bench_compare.py``; the port has neither.

The reference is called as it stands, through the same test-side
``shard_map(check_rep=)`` -> ``check_vma`` wrapper and ``enable_x64``
alias as ``tests/test_torch_mesh.py`` (applied with ``monkeypatch``, only
where the running jax lacks the names).
"""

import copy
import importlib
import inspect
import types

import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import TorchPlanner
from swarmkit_tpu_torch.parallel import make_mesh
from swarmkit_tpu_torch.utils.metrics import registry as port_metrics

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"


@pytest.fixture
def ref(monkeypatch):
    """The reference's planner and mesh maker, callable on this jax
    (``enable_x64`` aliased, ``shard_map(check_rep=)`` passed on as
    ``check_vma``, each only where the running jax lacks it)."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
    sharded = importlib.import_module("swarmkit_tpu.parallel.sharded")
    params = inspect.signature(sharded.shard_map).parameters
    if "check_rep" not in params and "check_vma" in params:
        orig = sharded.shard_map

        def shard_map(*args, check_rep=None, **kw):
            if check_rep is not None:
                kw.setdefault("check_vma", check_rep)
            return orig(*args, **kw)

        monkeypatch.setattr(sharded, "shard_map", shard_map)
    ops = importlib.import_module("swarmkit_tpu.ops")
    return types.SimpleNamespace(
        planner=lambda d=None: ops.TPUPlanner(
            mesh=None if d is None
            else sharded.make_mesh(jax.devices()[:d])))


@pytest.fixture
def frozen_clock():
    mods = [importlib.import_module(f"{pkg}.models.types")
            for pkg in (REF, PORT)]
    for m in mods:
        m.set_time_source(lambda: 1_700_000_000.0)
    try:
        yield
    finally:
        for m in mods:
            m.set_time_source(None)


def _pkg(name):
    return types.SimpleNamespace(
        M=importlib.import_module(f"{name}.models"),
        T=importlib.import_module(f"{name}.models.types"),
        S=importlib.import_module(f"{name}.state"),
        Sch=importlib.import_module(f"{name}.scheduler"),
        E=importlib.import_module(f"{name}.state.events"))


def _port_planner(d=None, fused=True):
    p = TorchPlanner(device="cpu",
                     mesh=None if d is None else make_mesh(["cpu"] * d))
    p.fused_enabled = fused
    return p


# ------------------------------------------------------------- harness

def _mk_node(P, i, cpus=8 * 10 ** 9, mem=32 << 30):
    M = P.M
    return M.Node(
        id=f"n{i:04d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"node-{i:04d}",
            labels={"rack": f"r{i % 3}",
                    "tier": "web" if i % 2 else "db"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"node-{i:04d}",
            resources=M.Resources(nano_cpus=cpus, memory_bytes=mem)))


def _mk_service(P, sid, n_tasks, spec, first=0):
    M = P.M
    svc = M.Service(
        id=sid,
        spec=M.ServiceSpec(annotations=M.Annotations(name=f"svc-{sid}"),
                           mode=M.ServiceMode.REPLICATED,
                           replicated=M.ReplicatedService(replicas=n_tasks),
                           task=spec),
        spec_version=M.Version(index=1))
    tasks = [M.Task(id=f"{sid}-t{k:04d}", service_id=sid, slot=k + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING,
                                        timestamp=P.T.now()))
             for k in range(first, first + n_tasks)]
    return svc, tasks


def _specs(P):
    M = P.M
    res = M.ResourceRequirements(reservations=M.Resources(
        nano_cpus=10 ** 8, memory_bytes=64 << 20))
    return {
        "sva": M.TaskSpec(resources=res),
        "svb": M.TaskSpec(resources=res, placement=M.Placement(
            constraints=["node.labels.tier==web"])),
        "svc": M.TaskSpec(resources=res, placement=M.Placement(
            preferences=[M.PlacementPreference(spread=M.SpreadOver(
                spread_descriptor="node.labels.rack"))])),
    }


def _build_store(P, n_nodes=24):
    store = P.S.MemoryStore()
    store.update(lambda tx: [tx.create(_mk_node(P, i))
                             for i in range(n_nodes)])
    specs = _specs(P)
    seeded = {"sva": 20, "svb": 12, "svc": 9}

    def mk(tx):
        for sid, spec in specs.items():
            svc, tasks = _mk_service(P, sid, seeded[sid], spec)
            tx.create(svc)
            for t in tasks:
                tx.create(t)
    store.update(mk)
    return store, specs, dict(seeded)


def _event_key(P, ev):
    E = P.E
    if isinstance(ev, E.EventTaskBlock):
        return ("block", tuple(o.id for o in ev.olds),
                tuple(ev.node_ids), ev.base_version, ev.state, ev.message)
    if isinstance(ev, E.EventCommit):
        return ("commit", ev.version)
    if isinstance(ev, E.Event):
        obj = ev.obj
        return (ev.action, obj.id, getattr(obj, "node_id", None),
                int(obj.status.state) if hasattr(obj, "status") else None,
                obj.meta.version.index)
    return ("other", repr(ev))


def _pump(P, sched, sub):
    while True:
        ev = sub.poll()
        if ev is None:
            return
        if isinstance(ev, P.E.EventSnapshotRestore):
            sched._resync()
        elif isinstance(ev, P.E.Event):
            sched._handle_event(ev)


def _churn_run(pkg, planner):
    """The reference's churn (arrivals, failures, a drain flip, a node
    join, a node leave) through the store watch feed, with either
    package's models and planner."""
    P = _pkg(pkg)
    M = P.M
    store, specs, seqs = _build_store(P)
    planner.enable_small_group_routing = False
    sched = P.Sch.Scheduler(store, batch_planner=planner, pipeline_depth=1)
    _, sub = store.view_and_watch(
        lambda tx: sched._setup_tasks_list(tx), accepts_blocks=True)
    obs = store.queue.subscribe(accepts_blocks=True)

    def add(sid, n):
        _, tasks = _mk_service(P, sid, n, specs[sid], first=seqs[sid])
        for t in tasks:
            t.status = M.TaskStatus(state=M.TaskState.PENDING)
        store.update(lambda tx: [tx.create(t) for t in tasks])
        seqs[sid] += n

    def fail_some(sid, k):
        victims = sorted(
            (t for t in store.view(lambda tx: tx.find(M.Task))
             if t.service_id == sid and t.node_id), key=lambda t: t.id)[:k]

        def cb(tx):
            for v in victims:
                cur = tx.get(M.Task, v.id).copy()
                cur.status = M.TaskStatus(
                    state=M.TaskState.FAILED, timestamp=P.T.now(),
                    message="churn exit")
                tx.update(cur)
        store.update(cb)

    def flip(nid, avail):
        def cb(tx):
            cur = tx.get(M.Node, nid).copy()
            cur.spec.availability = avail
            tx.update(cur)
        store.update(cb)

    decisions = sched.tick()                       # tick 1: cold build
    add("sva", 5)
    add("svc", 3)
    fail_some("sva", 2)
    _pump(P, sched, sub)
    decisions += sched.tick()                      # tick 2: incremental
    add("svb", 4)
    flip("n0002", M.NodeAvailability.DRAIN)
    _pump(P, sched, sub)
    decisions += sched.tick()                      # tick 3: incremental
    store.update(lambda tx: tx.create(_mk_node(P, 24)))
    add("sva", 4)
    _pump(P, sched, sub)
    decisions += sched.tick()                      # tick 4: append row
    store.update(lambda tx: tx.delete(M.Node, "n0005"))
    add("svc", 4)
    _pump(P, sched, sub)
    decisions += sched.tick()                      # tick 5: node removal
    add("svb", 3)
    flip("n0002", M.NodeAvailability.ACTIVE)
    _pump(P, sched, sub)
    decisions += sched.tick()                      # tick 6: incremental

    events = [_event_key(P, e) for e in obs.drain()]
    store.queue.unsubscribe(obs)
    store.queue.unsubscribe(sub)
    state = sorted((t.id, t.node_id, int(t.status.state), t.status.message,
                    t.meta.version.index)
                   for t in store.view(lambda tx: tx.find(M.Task)))
    return decisions, state, events, sched, planner


def _host_cols(st):
    return (st.valid, st.ready, st.cpu, st.mem, st.total)


def _assert_shards_mirror(st):
    """The split device tier equals the host mirror, shard by shard, each
    shard on its own tensors."""
    d = st.mesh.size
    for col, host in zip(st.dev, _host_cols(st)):
        assert len(col) == d
        assert len({t.data_ptr() for t in col}) == d
        np.testing.assert_array_equal(
            torch.cat([t.cpu() for t in col]).numpy(), host)


# -------------------------------------------------- churn differentials

@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_churn_matches_reference_and_single_device(frozen_clock, ref,
                                                        d):
    """The churn at mesh D places as the port's unsharded planner (the
    same decisions, store rows and watch events) and as the reference's
    ``TPUPlanner`` on a D-device mesh, while the resident tier runs split
    (per-shard scatters counted, as the reference counts them)."""
    dm, sm, em, _s, pm = _churn_run(PORT, _port_planner(d))
    d1, s1, e1, _s1, _p1 = _churn_run(PORT, _port_planner())
    assert (dm, sm, em) == (d1, s1, e1)
    dr, sr, _er, _sr, pr = _churn_run(REF, ref.planner(d))
    assert (dm, sm) == (dr, sr)
    snap, rsnap = pm.streaming_snapshot(), pr.streaming_snapshot()
    assert snap["mesh_devices"] == d and snap["shard_syncs"] >= 1, snap
    # staged bytes differ by design (the port stages only shards with
    # rows); every counter of refreshes and syncs is the reference's
    for key in ("resyncs", "fallbacks", "incremental_ticks", "full_ticks",
                "rows", "device_syncs", "shard_syncs", "mesh_devices"):
        assert snap[key] == rsnap[key], (key, snap, rsnap)
    assert pm.stats.get("groups_fused", 0) >= 2, pm.stats


def test_mesh_resident_shards_match_mirror_and_seed_fused(frozen_clock):
    """After the churn the four split columns equal the host mirror row
    for row, and the fused runs seeded from them."""
    _dm, _sm, _em, sched, planner = _churn_run(PORT, _port_planner(4))
    st = planner._streaming
    assert st is not None and st._mesh_active
    st.refresh(sched)
    assert st.device_carry() is not None
    _assert_shards_mirror(st)
    assert st.stats["shard_syncs"] >= 2
    assert st.snapshot()["mesh_devices"] == 4
    assert planner.stats.get("streaming_device_carries", 0) >= 1, \
        planner.stats


def test_mesh_fused_run_leaves_resident_shards_untouched(frozen_clock):
    """A fused run seeded from the resident shards writes its placements
    into per-shard clones: at the end of the run the shards still hold
    what they held when the run was seeded."""
    planner = _port_planner(4)
    seen = {}
    prepare, release = planner._prepare_fused, planner.abort_fused_run

    def snapshot():
        return [[t.clone() for t in col] for col in planner._streaming.dev]

    def prepare_fused(run):
        seen["before"] = snapshot()
        prepare(run)

    def abort_fused_run(run):
        seen.setdefault("after", snapshot())
        release(run)

    planner._prepare_fused = prepare_fused
    planner.abort_fused_run = abort_fused_run
    decisions = _run_tick(planner)[0]
    assert decisions > 0
    assert planner.stats.get("streaming_device_carries", 0) >= 1
    for col, was in zip(seen["after"], seen["before"]):
        for t, w in zip(col, was):
            assert torch.equal(t, w)


# ------------------------------------------------------- strategies

def _strategy_spec(P, strategy, cpus=1, weights=None):
    M = P.M
    return M.TaskSpec(
        resources=M.ResourceRequirements(reservations=M.Resources(
            nano_cpus=cpus * 10 ** 9, memory_bytes=1 << 30)),
        placement=M.Placement(strategy=strategy,
                              strategy_weights=weights or {}))


def _strategy_tick(planner):
    """One tick over spread + binpack + weighted + learned services on
    heterogeneous nodes (the reference's ``_strategy_tick``); returns the
    placements by task id."""
    P = _pkg(PORT)
    store = P.S.MemoryStore()
    nodes = [_mk_node(P, i, cpus=(4 + (i % 5) * 4) * 10 ** 9)
             for i in range(10)]
    batches = [
        _mk_service(P, "pack", 8, _strategy_spec(P, "binpack")),
        _mk_service(P, "wt", 8, _strategy_spec(
            P, "weighted", weights={"cpu": 3, "spread": 1})),
        _mk_service(P, "ml", 8, _strategy_spec(P, "learned")),
        _mk_service(P, "spr", 8, _strategy_spec(P, "")),
    ]

    def mk(tx):
        for node in nodes:
            tx.create(node)
        for svc, tasks in batches:
            tx.create(svc)
            for t in tasks:
                tx.create(t)
    store.update(mk)
    sched = P.Sch.Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    sched.tick()
    return {t.id: t.node_id for t in store.view(
        lambda tx: tx.find(P.M.Task))}


def _strategy_subset(placements):
    """The binpack / weighted / learned tasks: the spread service's host
    walk places the same per-node counts in another task order."""
    return {tid: nid for tid, nid in placements.items()
            if not tid.startswith("spr-")}


def _strategy_groups(route):
    return sum(port_metrics.get_counter(
        f'swarm_strategy_groups{{route="{route}",strategy="{s}"}}')
        for s in ("binpack", "weighted", "learned"))


def test_mesh_fused_strategies_match_host_oracle(frozen_clock):
    """binpack / weighted / learned at mesh 2, fused: the mixed tick
    places as the unsharded planner, the strategy services as the host
    oracle, every strategy group on the device and in the fused run."""
    host = _strategy_tick(None)
    dev1 = _strategy_tick(_port_planner())
    h_before, d_before = _strategy_groups("host"), _strategy_groups("device")
    planner = _port_planner(2)
    devm = _strategy_tick(planner)
    assert devm == dev1
    assert _strategy_subset(devm) == _strategy_subset(host)
    assert all(devm.values())
    assert _strategy_groups("host") == h_before
    assert _strategy_groups("device") == d_before + 3
    assert planner.stats.get("groups_fused", 0) >= 4, planner.stats


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_per_group_strategy_routes_on_device(frozen_clock, d):
    """With fusion off, a non-spread group takes the sharded strategy
    plan (K11 or K10 over the shards), placing as the unsharded planner
    and the host oracle."""
    host = _strategy_tick(None)
    dev1 = _strategy_tick(_port_planner(fused=False))
    planner = _port_planner(d, fused=False)
    devm = _strategy_tick(planner)
    assert devm == dev1
    assert _strategy_subset(devm) == _strategy_subset(host)
    assert planner.stats.get("groups_planned", 0) >= 4, planner.stats


# ---------------------------------------------------- fallback matrix

def _begin(planner, sched):
    planner.begin_tick(sched)
    planner.end_tick()
    return planner._streaming


def _small(d, n_nodes=8):
    P = _pkg(PORT)
    store, _specs, _seqs = _build_store(P, n_nodes=n_nodes)
    planner = _port_planner(d)
    sched = P.Sch.Scheduler(store, batch_planner=planner, pipeline_depth=1)
    store.view(sched._setup_tasks_list)
    return planner, sched


def test_mesh_epoch_resync(frozen_clock):
    """An epoch bump forces the counted resync, after which the device
    tier is split again and mirrors the host columns."""
    planner, sched = _small(2)
    sched._tick_epoch = 3
    st = _begin(planner, sched)
    assert st._mesh_active and st.stats["resyncs"] == 0
    sched._tick_epoch = 4
    _begin(planner, sched)
    assert st.stats["resyncs"] == 1, st.stats
    st.refresh(sched)
    assert st._mesh_active
    _assert_shards_mirror(st)


def test_mesh_teardown_and_shard_count_resync(frozen_clock):
    """Tearing the mesh down demotes to single-device residency; a
    shard-count change re-uploads over the new layout.  Both are counted
    resyncs with their own reasons, and the host mirror survives."""
    planner, sched = _small(2)
    st = _begin(planner, sched)
    assert st._mesh_active and st.snapshot()["mesh_devices"] == 2
    host_cols = [np.array(c) for c in _host_cols(st)]

    label = 'swarm_streaming_resyncs{reason="%s"}'
    before_td = port_metrics.get_counter(label % "mesh-teardown")
    st.set_mesh(None)
    assert st.dev is None and not st._mesh_active
    assert port_metrics.get_counter(label % "mesh-teardown") == before_td + 1
    st.refresh(sched)
    assert st.device_carry() is not None
    assert st.snapshot()["mesh_devices"] == 0
    for was, now in zip(host_cols, _host_cols(st)):
        np.testing.assert_array_equal(was, now)
    for col, host in zip(st.dev, host_cols):
        np.testing.assert_array_equal(col.numpy(), host)

    before_sc = port_metrics.get_counter(label % "shard-count")
    st.set_mesh(make_mesh(["cpu"] * 4))
    assert st.dev is None
    assert port_metrics.get_counter(label % "shard-count") == before_sc + 1
    st.refresh(sched)
    assert st._mesh_active and st.snapshot()["mesh_devices"] == 4
    _assert_shards_mirror(st)
    assert st.stats["resyncs"] == 2


def test_mesh_planner_layout_change_keeps_placements(frozen_clock):
    """The planner's own layout changes (4 shards -> none -> 2 shards
    between churn ticks) are counted resyncs, and the churn places as the
    unsharded planner."""
    planner = _port_planner(4)
    calls = {"n": 0}
    tick = planner.begin_tick

    def begin_tick(sched):
        calls["n"] += 1
        if calls["n"] == 3:
            planner.set_mesh(None)
        elif calls["n"] == 5:
            planner.set_mesh(make_mesh(["cpu"] * 2))
        tick(sched)

    planner.begin_tick = begin_tick
    got = _churn_run(PORT, planner)
    want = _churn_run(PORT, _port_planner())
    assert got[:3] == want[:3]
    snap = planner.streaming_snapshot()
    assert snap["mesh_devices"] == 2 and snap["resyncs"] >= 2, snap


def test_mesh_divergence_resync_reshards(frozen_clock):
    """A NodeInfo object swapped behind a resident row: the next refresh
    counts the divergence fallback, rebuilds the mirror and re-uploads
    the split device tier."""
    planner, sched = _small(2)
    st = _begin(planner, sched)
    assert st._mesh_active
    ns = sched.node_set.nodes
    ns["n0000"] = copy.copy(ns["n0000"])
    sched.delta.mark("n0000")
    label = 'swarm_streaming_resyncs{reason="divergence"}'
    before = port_metrics.get_counter(label)
    fb_before = st.stats["fallbacks"]
    st.refresh(sched)
    assert port_metrics.get_counter(label) == before + 1
    assert st.stats["fallbacks"] == fb_before + 1
    assert st._mesh_active and st.dev is not None
    _assert_shards_mirror(st)


def test_mesh_bucket_indivisible_demotes_counted(frozen_clock):
    """A mesh of 3 does not divide the power-of-two node bucket: the
    resident tier stays single-device (counted ``mesh_demotions``), the
    fused route hands its groups to the per-group route (counted), and
    the churn still places as the unsharded planner."""
    got = _churn_run(PORT, _port_planner(3))
    want = _churn_run(PORT, _port_planner())
    assert got[:3] == want[:3]
    planner = got[4]
    st = planner._streaming
    assert not st._mesh_active and st.stats["mesh_demotions"] >= 1
    assert planner.streaming_snapshot()["mesh_devices"] == 0
    assert planner.stats.get("fused_mesh_indivisible", 0) >= 1
    assert planner.stats.get("groups_planned", 0) >= 1


# ------------------------------------------- fused parity (test_fused.py)

def _many_service_store(P, n_services=5, n_nodes=40, base=40):
    M = P.M
    store = P.S.MemoryStore()
    res = M.ResourceRequirements(reservations=M.Resources(
        nano_cpus=10 ** 8, memory_bytes=64 << 20))
    nodes = [_mk_node(P, i, cpus=16 * 10 ** 9, mem=64 << 30)
             for i in range(n_nodes)]
    store.update(lambda tx: [tx.create(n) for n in nodes])
    batches = [_mk_service(P, f"svc{si}", base + 7 * si,
                           M.TaskSpec(resources=res))
               for si in range(n_services)]

    def mk(tx):
        for svc, tasks in batches:
            tx.create(svc)
            for t in tasks:
                tx.create(t)
    store.update(mk)
    return store


def _run_tick(planner):
    P = _pkg(PORT)
    store = _many_service_store(P)
    sub = store.queue.subscribe(accepts_blocks=True)
    sched = P.Sch.Scheduler(store, batch_planner=planner, pipeline_depth=2)
    store.view(sched._setup_tasks_list)
    decisions = sched.tick()
    events = [_event_key(P, e) for e in sub.drain()]
    store.queue.unsubscribe(sub)
    state = sorted((t.id, t.node_id, int(t.status.state), t.status.message,
                    t.meta.version.index)
                   for t in store.view(lambda tx: tx.find(P.M.Task)))
    return decisions, state, events


def test_fused_mesh_parity(frozen_clock):
    """The fused route over a 4-shard mesh gives the same store rows and
    events as the unsharded planner, with every group fused."""
    planner = _port_planner(4)
    got = _run_tick(planner)
    assert planner.stats.get("groups_fused", 0) == 5, planner.stats
    assert got == _run_tick(_port_planner())
