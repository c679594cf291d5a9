"""The port's streaming scheduler on the CPU, against the reference.

Kernel level: ``scatter_rows`` (K7's plain version) against the
reference's donated ``_scatter_rows_jit`` on seeded numpy inputs with pad
slots, under x64: bit-equal.

Resident state: the port's ``ResidentState`` and the reference's, each
driven by its own package's ``Scheduler`` through the same store
mutations, hold equal host columns (and per-service, constraint, leaf and
platform caches, and counted refresh modes) after every step: incremental
rows, an epoch resync, a tracker swap, node adds, a node removal, a node
bucket overflow and the host-only backlog.  Every incremental state also
equals a full rebuild.

Planner level: a churn of arrivals, failures, availability flips, a node
join and a node removal, driven through each package's store watch feed:
``TorchPlanner(device="cpu")`` with streaming places exactly as
``TPUPlanner`` (streaming, its default) and as the port with
``streaming_enabled = False``, fused on and off.  The aliasing test holds
the resident tensors equal to the host mirror after a fused run seeded
from them (the run's carry must be a clone: K4 updates it in place).
Failure windows read a frozen clock.
"""

import importlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from swarmkit_tpu.ops import streaming as ref_streaming  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops import streaming as port_streaming  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
PKGS = (REF, PORT)


@pytest.fixture
def frozen_clock():
    mods = [importlib.import_module(f"{pkg}.models.types") for pkg in PKGS]
    for m in mods:
        m.set_time_source(lambda: 1_700_000_000.0)
    try:
        yield
    finally:
        for m in mods:
            m.set_time_source(None)


# ------------------------------------------------------------ kernel level

@pytest.mark.parametrize("nb,d,db", [(1024, 5, 16), (1024, 16, 16),
                                     (4096, 200, 256), (8192, 3000, 4096)])
def test_scatter_rows_matches_reference_jit(nb, d, db):
    rng = np.random.RandomState(nb + d)
    cols = (rng.rand(nb) < 0.9, rng.rand(nb) < 0.8,
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(0, 5000, nb).astype(np.int32))
    idx = np.full(db, nb, np.int32)            # pad slots: index nb
    idx[:d] = rng.choice(nb, d, replace=False)
    upd = (rng.rand(db) < 0.5, rng.rand(db) < 0.5,
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(0, 2**31 - 1, db).astype(np.int32))
    with jax.enable_x64(True):
        want = ref_streaming._scatter_rows_jit(
            *[jnp.asarray(c) for c in cols], jnp.asarray(idx),
            *[jnp.asarray(u) for u in upd])
        want = [np.asarray(w) for w in want]
    got = tuple(torch.from_numpy(c.copy()) for c in cols)
    packed = torch.from_numpy(port.pack_scatter(idx, *upd))
    port.scatter_rows(got, packed)
    for name, g, w, c in zip(("valid", "ready", "cpu", "mem", "total"),
                             got, want, cols):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert (g.numpy() != c).any(), name   # the scatter wrote rows


def test_scatter_views_round_trip():
    idx = np.arange(16, dtype=np.int32)
    upd = (np.ones(16, bool), np.zeros(16, bool),
           np.arange(16, dtype=np.int64) - 2**40,
           np.arange(16, dtype=np.int64) * 3,
           np.arange(16, dtype=np.int32) + 7)
    buf = port.pack_scatter(idx, *upd)
    assert buf.nbytes == port.SCATTER_SLOT_BYTES * 16
    for view, want in zip(port.scatter_views(torch.from_numpy(buf), 16),
                          (idx,) + upd):
        np.testing.assert_array_equal(view.numpy(), want)
    with pytest.raises(ValueError):
        port.scatter_views(buf[:-1], 16)


# ------------------------------------------------------- resident state

def _mods(pkg):
    return (importlib.import_module(f"{pkg}.models"),
            importlib.import_module(f"{pkg}.state"),
            importlib.import_module(f"{pkg}.scheduler"),
            importlib.import_module(f"{pkg}.state.events"))


def _node(M, i, rack=None):
    """Node i: rack r{i % 3}, tier web|db; every fifth has no platform and
    every seventh no zone label (unknown constraint values)."""
    labels = {"rack": rack or f"r{i % 3}", "tier": "web" if i % 2 else "db"}
    if i % 7:
        labels["zone"] = f"z{i % 2}"
    return M.Node(
        id=f"n{i:04d}",
        spec=M.NodeSpec(annotations=M.Annotations(name=f"node-{i:04d}",
                                                  labels=labels)),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"node-{i:04d}",
            platform=(M.Platform(os="linux", architecture="amd64")
                      if i % 5 else None),
            resources=M.Resources(nano_cpus=8 * 10**9,
                                  memory_bytes=32 << 30)))


class Mirror:
    """One package's store, scheduler (fed by the store's watch stream)
    and ResidentState, with no planner: the resident state is refreshed
    directly, so both packages see the same mutations at the same
    points."""

    def __init__(self, pkg, n_nodes):
        self.pkg = pkg
        self.M, S, self.Sch, self.E = _mods(pkg)
        self.store = S.MemoryStore()
        self.store.update(lambda tx: [tx.create(_node(self.M, i))
                                      for i in range(n_nodes)])
        self.attach()
        mod = ref_streaming if pkg == REF else port_streaming
        # the planner's constraint-key lookup
        if pkg == REF:
            from swarmkit_tpu.ops import TPUPlanner
            self.st = mod.ResidentState(TPUPlanner()._node_value)
        else:
            from swarmkit_tpu_torch.ops import TorchPlanner
            self.st = mod.ResidentState(
                TorchPlanner(device="cpu")._node_value, "cpu")

    def attach(self):
        self.sched = self.Sch.Scheduler(self.store, batch_planner=None)
        _, self.sub = self.store.view_and_watch(
            lambda tx: self.sched._setup_tasks_list(tx))

    def pump(self):
        while True:
            ev = self.sub.poll()
            if ev is None:
                return
            if isinstance(ev, self.E.Event):
                self.sched._handle_event(ev)

    def run_tasks(self, sid, ids_nodes, failed=False):
        """Create RUNNING tasks on the given nodes, or (``failed``) move
        existing ones to FAILED."""
        M = self.M

        def cb(tx):
            for tid, nid in ids_nodes:
                cur = tx.get(M.Task, tid)
                st = M.TaskState.FAILED if failed else M.TaskState.RUNNING
                if cur is None:
                    tx.create(M.Task(
                        id=tid, service_id=sid, slot=1, node_id=nid,
                        desired_state=M.TaskState.RUNNING,
                        spec=M.TaskSpec(resources=M.ResourceRequirements(
                            reservations=M.Resources(
                                nano_cpus=10**8, memory_bytes=64 << 20))),
                        spec_version=M.Version(index=1),
                        status=M.TaskStatus(state=st)))
                else:
                    cur = cur.copy()
                    cur.status = M.TaskStatus(state=st)
                    tx.update(cur)
        self.store.update(cb)

    def flip(self, nid, drain):
        M = self.M

        def cb(tx):
            cur = tx.get(M.Node, nid).copy()
            cur.spec.availability = (M.NodeAvailability.DRAIN if drain
                                     else M.NodeAvailability.ACTIVE)
            tx.update(cur)
        self.store.update(cb)

    def add_node(self, i, rack=None):
        self.store.update(lambda tx: tx.create(_node(self.M, i, rack)))

    def delete_node(self, nid):
        self.store.update(lambda tx: tx.delete(self.M.Node, nid))

    def read_caches(self):
        """Touch every cache kind so it is built and then row-maintained:
        per-service columns, constraint columns (one key unknown on some
        nodes), a flat leaf column and the platform hashes."""
        st, sched = self.st, self.sched
        svc = {sid: st.svc_tasks_col(sched, sid).copy()
               for sid in ("sa", "sb")}
        cons = []
        for exprs in (["node.labels.tier==web"], ["node.labels.zone!=z1"],
                      ["node.hostname!=node-0003", "node.labels.rack==r1"]):
            parse = importlib.import_module(
                f"{self.pkg}.scheduler.constraint").parse
            con = parse(exprs)
            h = np.zeros((4, 2, st.nb), np.int32)
            op = np.full(4, 2, np.int32)
            ex = np.zeros((4, 2), np.int32)
            st.fill_constraints(sched, con, h, op, ex)
            cons.append((h, op, ex))
        leaf, nv = st.flat_leaf(sched, "node.labels.rack")
        os_h, arch_h = st.platform_hashes()
        return svc, cons, (leaf.copy(), nv), (os_h.copy(), arch_h.copy())


STATS = ("colds", "resyncs", "fallbacks", "incremental", "full", "rows",
         "device_syncs")


def _same(p, r, step):
    """The port's resident state equals the reference's, field by field."""
    ps, rs = p.st, r.st
    assert ps.n == rs.n and ps.nb == rs.nb, step
    # row order (a placement tie key): the port keeps it in ``infos``
    assert [i.node.id for i in ps.infos] == rs.node_ids, step
    assert list(ps.row_of.items()) == list(rs.row_of.items()), step
    for name in ("valid", "ready", "cpu", "mem", "total"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(rs, name),
                                      err_msg=f"{step}: {name}")
    assert list(ps.fail_rows) == list(rs.fail_rows), step
    assert {k: ps.stats[k] for k in STATS} == \
        {k: rs.stats[k] for k in STATS}, step
    got, want = p.read_caches(), r.read_caches()
    for sid in ("sa", "sb"):
        np.testing.assert_array_equal(got[0][sid], want[0][sid],
                                      err_msg=f"{step}: svc {sid}")
    for (gh, go, ge), (wh, wo, we) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gh, wh, err_msg=step)
        np.testing.assert_array_equal(go, wo, err_msg=step)
        np.testing.assert_array_equal(ge, we, err_msg=step)
    np.testing.assert_array_equal(got[2][0], want[2][0], err_msg=step)
    assert got[2][1] == want[2][1], step
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w, err_msg=step)
    # incremental rows equal a full rebuild of the same mirror
    fresh = port_streaming.ResidentState(ps._node_value, "cpu")
    fresh._rebuild(p.sched, "check")
    for name in ("valid", "ready", "cpu", "mem", "total"):
        np.testing.assert_array_equal(getattr(ps, name),
                                      getattr(fresh, name),
                                      err_msg=f"{step}: rebuild {name}")
    np.testing.assert_array_equal(ps.svc_tasks_col(p.sched, "sa"),
                                  fresh.svc_tasks_col(p.sched, "sa"))
    np.testing.assert_array_equal(
        ps.flat_leaf(p.sched, "node.labels.rack")[0],
        fresh.flat_leaf(p.sched, "node.labels.rack")[0], err_msg=step)
    # the device tier mirrors the host at every refresh point
    if ps.device_carry() is not None:
        for d, h in zip(ps.dev, ps._host_cols()):
            np.testing.assert_array_equal(d.numpy(), h, err_msg=step)


def _both(twins, fn):
    for m in twins:
        fn(m)


def test_resident_state_matches_reference_through_fallbacks(frozen_clock):
    p, r = Mirror(PORT, 30), Mirror(REF, 30)

    def step(name, mutate=None):
        if mutate is not None:
            _both((p, r), mutate)
        _both((p, r), lambda m: (m.pump(), m.st.refresh(m.sched)))
        _same(p, r, name)

    step("cold")
    assert p.st.stats["colds"] == 1
    step("tasks", lambda m: m.run_tasks(
        "sa", [(f"sa-{k}", f"n{k % 30:04d}") for k in range(40)]))
    step("more tasks and failures", lambda m: (
        m.run_tasks("sb", [(f"sb-{k}", f"n{(3 * k) % 30:04d}")
                           for k in range(12)]),
        m.run_tasks("sa", [(f"sa-{k}", None) for k in range(5)],
                    failed=True)))
    step("drain flip", lambda m: m.flip("n0004", True))
    assert p.st.stats["incremental"] == 3 and p.st.stats["full"] == 1
    step("node add", lambda m: (m.add_node(30), m.add_node(31, rack="r9")))
    assert p.st.stats["full"] == 1 and p.st.n == 32

    # host-only backlog: a mid-tick-style mutation drained by a host-only
    # absorb must still reach the device tier at the next refresh
    def backlog(m):
        info = m.sched.node_set.nodes["n0001"]
        info.available_resources.nano_cpus -= 12345
        m.sched.delta.mark("n0001")
        m.st.absorb(m.sched)
    _both((p, r), backlog)
    assert p.st._pending_dev_rows and p.st.device_carry() is None
    step("backlog")
    assert not p.st._pending_dev_rows
    assert int(p.st.dev[2][1]) == int(p.st.cpu[1])

    step("epoch", lambda m: setattr(m.sched, "_tick_epoch", 7))
    assert p.st.stats["resyncs"] == 1
    step("node removal", lambda m: m.delete_node("n0002"))
    assert p.st.stats["fallbacks"] == 1
    step("tracker swap", lambda m: m.attach())
    assert p.st.stats["fallbacks"] == 2
    step("after swap", lambda m: m.run_tasks(
        "sb", [(f"sb-x{k}", f"n{k:04d}") for k in range(3, 9)]))
    assert p.st.stats["incremental"] >= 5


def test_resident_overflow_rebuilds_into_next_bucket(frozen_clock):
    twins = p, r = Mirror(PORT, 1022), Mirror(REF, 1022)
    _both(twins, lambda m: m.st.refresh(m.sched))
    _same(p, r, "cold")
    assert p.st.nb == 1024
    _both(twins, lambda m: (m.add_node(1022), m.add_node(1023), m.pump(),
                            m.st.refresh(m.sched)))
    _same(p, r, "fill the bucket")
    assert p.st.stats["full"] == 1 and p.st.nb == 1024
    _both(twins, lambda m: (m.add_node(1024), m.pump(),
                            m.st.refresh(m.sched)))
    _same(p, r, "overflow")
    assert p.st.nb == 2048 and p.st.stats["fallbacks"] == 1
    assert p.st.dev[0].shape[0] == 2048


# ----------------------------------------------------------- planner level

_RES_ARGS = dict(nano_cpus=10**8, memory_bytes=64 << 20)


def _churn_run(pkg, streaming=True, fused=True):
    """Multi-tick churn through the scheduler's event feed: arrivals,
    failures, an availability flip, a node join, a node removal.  Returns
    (decisions, sorted (task id, node id, state), planner, scheduler)."""
    M, S, Sch, E = _mods(pkg)
    if pkg == REF:
        from swarmkit_tpu.ops import TPUPlanner
        planner = TPUPlanner()
        planner.enable_small_group_routing = False
    else:
        from swarmkit_tpu_torch.ops import TorchPlanner
        planner = TorchPlanner(device="cpu")
    planner.fused_enabled = fused
    planner.streaming_enabled = streaming
    store = S.MemoryStore()
    store.update(lambda tx: [tx.create(_node(M, i)) for i in range(24)])
    res = M.ResourceRequirements(reservations=M.Resources(**_RES_ARGS))
    specs = {
        "sva": M.TaskSpec(resources=res),
        "svb": M.TaskSpec(resources=res, placement=M.Placement(
            constraints=["node.labels.tier==web"])),
        "svc": M.TaskSpec(resources=res, placement=M.Placement(
            preferences=[M.PlacementPreference(spread=M.SpreadOver(
                spread_descriptor="node.labels.rack"))])),
    }
    seqs = {sid: 0 for sid in specs}

    def mk_services(tx):
        for sid, spec in specs.items():
            tx.create(M.Service(
                id=sid, spec=M.ServiceSpec(
                    annotations=M.Annotations(name=sid),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=0), task=spec),
                spec_version=M.Version(index=1)))
    store.update(mk_services)
    sched = Sch.Scheduler(store, batch_planner=planner, pipeline_depth=1)
    _, sub = store.view_and_watch(lambda tx: sched._setup_tasks_list(tx),
                                  accepts_blocks=True)

    def pump():
        while True:
            ev = sub.poll()
            if ev is None:
                return
            if isinstance(ev, E.EventSnapshotRestore):
                sched._resync()
            elif isinstance(ev, E.Event):
                sched._handle_event(ev)

    def add(sid, n):
        base = seqs[sid]

        def cb(tx):
            for k in range(n):
                tx.create(M.Task(
                    id=f"{sid}-t{base + k:04d}", service_id=sid,
                    slot=base + k + 1, desired_state=M.TaskState.RUNNING,
                    spec=specs[sid], spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING)))
        store.update(cb)
        seqs[sid] = base + n

    def fail_some(sid, k):
        victims = sorted((t for t in store.view(lambda tx: tx.find(M.Task))
                          if t.service_id == sid and t.node_id),
                         key=lambda t: t.id)[:k]

        def cb(tx):
            for v in victims:
                cur = tx.get(M.Task, v.id).copy()
                cur.status = M.TaskStatus(state=M.TaskState.FAILED,
                                          message="churn exit")
                tx.update(cur)
        store.update(cb)

    def flip(nid, avail):
        def cb(tx):
            cur = tx.get(M.Node, nid).copy()
            cur.spec.availability = avail
            tx.update(cur)
        store.update(cb)

    add("sva", 20)
    add("svb", 12)
    add("svc", 9)
    pump()
    decisions = sched.tick()                       # cold build
    add("sva", 5)
    add("svc", 3)
    fail_some("sva", 2)
    pump()
    decisions += sched.tick()
    add("svb", 4)
    flip("n0002", M.NodeAvailability.DRAIN)
    pump()
    decisions += sched.tick()
    store.update(lambda tx: tx.create(_node(M, 24)))
    add("sva", 4)
    add("svb", 3)
    pump()
    decisions += sched.tick()                      # appended row, fused
    store.update(lambda tx: tx.delete(M.Node, "n0005"))
    add("svc", 4)
    pump()
    decisions += sched.tick()                      # node removal
    add("svb", 3)
    add("sva", 6)
    flip("n0002", M.NodeAvailability.ACTIVE)
    pump()
    decisions += sched.tick()
    pump()
    store.queue.unsubscribe(sub)
    state = sorted((t.id, t.node_id, int(t.status.state))
                   for t in store.view(lambda tx: tx.find(M.Task)))
    return decisions, state, planner, sched


@pytest.mark.parametrize("fused", [True, False])
def test_streaming_churn_matches_reference_and_full_replan(frozen_clock,
                                                           fused):
    want = _churn_run(REF, fused=fused)
    got = _churn_run(PORT, fused=fused)
    full = _churn_run(PORT, streaming=False, fused=fused)
    assert got[:2] == want[:2]
    assert full[:2] == got[:2]
    snap, ref_snap = got[2].streaming_snapshot(), \
        want[2].streaming_snapshot()
    assert snap["enabled"] and snap["incremental_ticks"] >= 3, snap
    assert snap["fallbacks"] >= 1, snap            # the node-removal tick
    for key in ("incremental_ticks", "full_ticks", "fallbacks", "resyncs",
                "rows"):
        assert snap[key] == ref_snap[key], key
    assert not full[2].streaming_snapshot()["enabled"]
    stats = got[2].stats
    if fused:
        assert stats.get("streaming_device_carries", 0) \
            == want[2].stats.get("streaming_device_carries", 0) >= 1
        assert stats.get("groups_fused", 0) >= 2
    assert full[2].stats.get("streaming_device_carries", 0) == 0


def test_resident_columns_match_reference_after_churn(frozen_clock):
    _, _, ref_planner, ref_sched = _churn_run(REF)
    _, _, planner, sched = _churn_run(PORT)
    st, ref_st = planner._streaming, ref_planner._streaming
    for name in ("valid", "ready", "cpu", "mem", "total"):
        np.testing.assert_array_equal(getattr(st, name),
                                      getattr(ref_st, name), err_msg=name)
    cols = planner._build_columns(sched)
    for name, want in zip(("valid", "ready", "cpu", "mem", "total"),
                          cols[3:]):
        np.testing.assert_array_equal(getattr(st, name), want,
                                      err_msg=name)
    # the last tick's applies marked rows after the last device sync: the
    # device tier refuses to serve until the next refresh, then mirrors
    # the host exactly
    assert st.device_carry() is None
    st.refresh(sched)
    assert st.device_carry() is not None
    for d, h in zip(st.dev, st._host_cols()):
        np.testing.assert_array_equal(d.numpy(), h)


def test_fused_run_leaves_resident_columns_untouched(frozen_clock):
    """The aliasing test: a fused run seeded from ``device_carry()``
    updates its carry in place, chunk after chunk; the resident tensors
    must still equal the host mirror afterwards (the carry is a clone)."""
    from swarmkit_tpu_torch.ops import TorchPlanner
    M, S, Sch, _ = _mods(PORT)
    store = S.MemoryStore()
    store.update(lambda tx: [tx.create(_node(M, i)) for i in range(20)])
    res = M.ResourceRequirements(reservations=M.Resources(**_RES_ARGS))

    def mk(tx):
        for si in range(5):
            spec = M.TaskSpec(resources=res)
            tx.create(M.Service(
                id=f"s{si}", spec=M.ServiceSpec(
                    annotations=M.Annotations(name=f"s{si}"),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=30), task=spec),
                spec_version=M.Version(index=1)))
            for k in range(30):
                tx.create(M.Task(
                    id=f"s{si}-t{k:03d}", service_id=f"s{si}", slot=k + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING)))
    store.update(mk)
    planner = TorchPlanner(device="cpu")
    sched = Sch.Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    planner.begin_tick(sched)
    st = planner._streaming
    before = [d.clone() for d in st.dev]
    glist = [g for g in sched.unassigned_groups.values() if g]
    specs = planner.probe_fused_run(sched, glist, 0)
    assert len(specs) == 5
    run = planner.dispatch_fused_run(sched, specs)
    assert planner.stats["streaming_device_carries"] == 1
    assert run.shared.valid is st.dev[0]           # read-only: aliases
    assert run.carry.total.data_ptr() != st.dev[4].data_ptr()
    placed = 0
    while (out := planner.fetch_fused_chunk(run)) is not None:
        placed += int(out[0].sum())
    assert placed == 150
    assert int(run.carry.total.sum()) == int(before[4].sum()) + placed
    for d, b, h in zip(st.dev, before, st._host_cols()):
        np.testing.assert_array_equal(d.numpy(), b.numpy())
        np.testing.assert_array_equal(d.numpy(), h)
    planner.abort_fused_run(run)
    planner.end_tick()


def test_streaming_off_builds_no_resident_state(frozen_clock):
    from swarmkit_tpu_torch.ops import TorchPlanner
    assert TorchPlanner(device="cpu").streaming_enabled   # the default
    _, _, planner, _ = _churn_run(PORT, streaming=False)
    assert planner._streaming is None
    assert planner.streaming_snapshot() == {
        "enabled": False, "dirty_frac": None, "resyncs": 0, "fallbacks": 0,
        "incremental_ticks": 0, "full_ticks": 0, "rows": 0,
        "device_syncs": 0}
