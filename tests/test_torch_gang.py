"""The port's gang all-or-nothing precheck on the CPU, against the reference.

Kernel level: ``gang_fit`` / ``gang_fit_fused`` (K8's plain version: K1's
plain version and an int64 capacity sum per gang) against the reference's
``gang_fit_jit`` / ``gang_fit_fused_jit`` and its numpy oracle
``gang_fit_host`` over a seeded fuzz, the exact-fit boundary (totals at
k - 1, k and k + 1) and totals around 2^24, where the reference's float32
sum stops being exact.  The planner's packed gang stage (only the columns
K8 reads, one buffer a verdict) through the same plain K8 against the
same reference kernels, its layout and the 44-byte result.

Planner level: ``TorchPlanner(device="cpu").gang_feasible`` and
``gang_feasible_many`` give the verdicts ``TPUPlanner``'s do, and a small
gang fleet admits and places exactly as under ``TPUPlanner``, task by
task; an infeasible gang defers whole.
"""

import importlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu.scheduler import gang as ref_gang  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import (  # noqa: E402
    gang_stage, gang_to_device)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
K_CLAMP = port.K_CLAMP


# ------------------------------------------------------------ kernel level

def gang_inputs(rng, nb, quota=None):
    """Seeded numpy (NodeInputs, GroupInputs) of one gang in the
    reference's layout: every filter column carries signal."""
    cc, p = 4, 4
    con_hash = rng.integers(0, 3, (cc, 2, nb)).astype(np.int32)
    con_op = rng.choice([0, 1, 2, 2], cc).astype(np.int32)
    con_exp = rng.integers(0, 3, (cc, 2)).astype(np.int32)
    plat = np.full((p, 4), -1, np.int32)
    plat[0] = rng.choice([(0, 0, 0, 0), (1, 1, 0, 0), (0, 1, 1, 0)])
    if rng.random() < 0.5:
        plat[2] = (1, 0, 0, 0)
    with_quota = rng.random() < 0.5 if quota is None else quota
    nodes = ref.NodeInputs(
        valid=np.arange(nb) < nb - rng.integers(0, nb // 4),
        ready=rng.random(nb) < 0.9,
        res_ok=rng.random(nb) < 0.85,
        res_cap=rng.integers(0, 8, nb).astype(np.int32),
        svc_tasks=rng.integers(0, 6, nb).astype(np.int32),
        total_tasks=rng.integers(0, 40, nb).astype(np.int32),
        failures=rng.integers(0, 4, nb).astype(np.int32),
        leaf=np.zeros(nb, np.int32),
        os_hash=rng.integers(0, 2, (2, nb)).astype(np.int32),
        arch_hash=rng.integers(0, 2, (2, nb)).astype(np.int32),
        port_conflict=rng.random(nb) < 0.2,
        extra_mask=rng.random(nb) < 0.95,
        quota_ok=(rng.random(nb) < 0.8) if with_quota else None)
    group = ref.GroupInputs(
        k=np.int32(rng.integers(1, 60)), con_hash=con_hash, con_op=con_op,
        con_exp=con_exp, plat=plat,
        maxrep=np.int32(rng.choice([0, 0, 2, 4])),
        port_limited=np.bool_(rng.random() < 0.3))
    return nodes, group


def _port_fit(rows):
    """(fit bool[G], fail i32[G, 8]) of the port on stacked rows."""
    fit, fail = port.gang_fit_fused(*gang_to_device(rows, "cpu"))
    return fit.numpy(), fail.numpy()


@pytest.mark.parametrize("seed", range(12))
def test_gang_fit_matches_reference_fuzz(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.choice([64, 1024]))
    nodes, group = gang_inputs(rng, nb)
    fit_r, fc_r = ref.gang_fit_jit(nodes, group)
    fit_h, fc_h = ref_gang.gang_fit_host(nodes, group)
    pn, pg = gang_to_device([(nodes, group)], "cpu")
    fit, fc = port.gang_fit(
        port.NodeInputs(*[None if v is None else v[0] for v in pn]),
        port.GroupInputs(*[v[0] for v in pg]))
    assert bool(fit) == bool(fit_r) == fit_h
    np.testing.assert_array_equal(fc.numpy(), np.asarray(fc_r))
    np.testing.assert_array_equal(fc.numpy(), fc_h)


@pytest.mark.parametrize("quota", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_gang_fit_fused_matches_reference_fuzz(seed, quota):
    rng = np.random.default_rng(100 + seed)
    rows = [gang_inputs(rng, 256, quota=quota) for _ in range(5)]
    stacked_nodes = ref.NodeInputs(*[
        None if f == "quota_ok" and not quota
        else np.stack([getattr(n, f) for n, _ in rows])
        for f in ref.NodeInputs._fields])
    stacked_groups = ref.GroupInputs(*[
        np.stack([getattr(g, f) for _, g in rows])
        for f in ref.GroupInputs._fields])
    fits_r, fcs_r = ref.gang_fit_fused_jit(stacked_nodes, stacked_groups)
    fits, fcs = _port_fit(rows)
    np.testing.assert_array_equal(fits, np.asarray(fits_r))
    np.testing.assert_array_equal(fcs, np.asarray(fcs_r))
    for i, (n, g) in enumerate(rows):
        fit_h, fc_h = ref_gang.gang_fit_host(n, g)
        assert bool(fits[i]) == fit_h, i
        np.testing.assert_array_equal(fcs[i], fc_h)
    assert fits.any() and not fits.all(), "the fuzz must decide both ways"


def _boundary_rows(caps, ks):
    """One gang per k over the same plain cluster whose per-node capacity
    is ``caps`` (every filter passes)."""
    nb = 1024
    cap = np.zeros(nb, np.int32)
    cap[:len(caps)] = caps
    nodes = ref.NodeInputs(
        valid=np.arange(nb) < 1000, ready=np.ones(nb, bool),
        res_ok=np.ones(nb, bool), res_cap=cap,
        svc_tasks=np.zeros(nb, np.int32), total_tasks=np.zeros(nb, np.int32),
        failures=np.zeros(nb, np.int32), leaf=np.zeros(nb, np.int32),
        os_hash=np.zeros((2, nb), np.int32),
        arch_hash=np.zeros((2, nb), np.int32),
        port_conflict=np.zeros(nb, bool), extra_mask=np.ones(nb, bool),
        quota_ok=None)
    rows = []
    for k in ks:
        rows.append((nodes, ref.GroupInputs(
            k=np.int32(k), con_hash=np.zeros((1, 2, nb), np.int32),
            con_op=np.full(1, 2, np.int32),
            con_exp=np.zeros((1, 2), np.int32),
            plat=np.full((1, 4), -1, np.int32), maxrep=np.int32(0),
            port_limited=np.bool_(False))))
    return rows


BOUNDARY = {
    # sum(cap) = 12: k = 11, 12 fit, 13 does not
    "small": ([3, 3, 3, 3], [11, 12, 13], [True, True, False]),
    # per-node caps are clamped to min(k, K_CLAMP): sum = k - 1, k, k + 1
    # at k = K_CLAMP
    "k_clamp": ([2**21, 2**21 - 1], [K_CLAMP], [False]),
    "k_clamp_exact": ([2**21, 2**21], [K_CLAMP, K_CLAMP + 5], [True, True]),
    "k_clamp_over": ([2**21, 2**21, 1], [K_CLAMP - 1, K_CLAMP],
                     [True, True]),
    # totals around 2^24 (float32 sums round there): far over any k
    "near_2p24": ([K_CLAMP] * 4 + [1], [K_CLAMP, 1, 9],
                  [True, True, True]),
    "below_2p24": ([K_CLAMP] * 3 + [K_CLAMP - 1], [K_CLAMP, 2**24 - 1],
                   [True, True]),
    "many_small": ([7] * 1000, [7000, 6999, 7001], [True, True, False]),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY))
def test_gang_fit_boundary_matches_reference(case):
    caps, ks, want = BOUNDARY[case]
    rows = _boundary_rows(caps, ks)
    fits, _ = _port_fit(rows)
    assert fits.tolist() == want
    for (n, g), w in zip(rows, want):
        assert bool(ref.gang_fit_jit(n, g)[0]) is w
        assert ref_gang.gang_fit_host(n, g)[0] is w
    total = port.unpack_gang(port.gang_fit_packed(
        *gang_to_device(rows, "cpu")), len(rows))[2]
    assert total.tolist() == [sum(min(c, min(k, K_CLAMP)) for c in caps)
                              for k in ks]


def test_gang_to_device_refuses_mixed_quota():
    rng = np.random.default_rng(5)
    rows = [gang_inputs(rng, 64, quota=True), gang_inputs(rng, 64,
                                                          quota=False)]
    with pytest.raises(ValueError, match="quota_ok"):
        gang_to_device(rows, "cpu")


# ------------------------------------------------ the packed gang stage
#
# The planner's route: only the columns K8 reads, every gang of a verdict
# packed into one staging buffer (``convert.gang_stage``); on the CPU K8's
# plain version reads the stage's views in place, and the verdict comes
# back through the stage's fetch as the 44-byte-a-gang result buffer.

def _staged(rows, stages=None):
    """(fit, fail, total) numpy arrays of the port's packed-stage route."""
    stage = gang_stage(rows, "cpu", {} if stages is None else stages)
    arr = stage.fetch(port.gang_fit_packed(*stage.dev_views))
    assert arr.dtype == np.uint8 and arr.shape == (44 * len(rows),)
    return port.unpack_gang(arr, len(rows))


@pytest.mark.parametrize("seed", range(12))
def test_gang_stage_matches_reference_fuzz(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.choice([64, 1024]))
    nodes, group = gang_inputs(rng, nb)
    fit_r, fc_r = ref.gang_fit_jit(nodes, group)
    fit, fail, total = _staged([(nodes, group)])
    assert bool(fit[0]) == bool(fit_r)
    np.testing.assert_array_equal(fail[0], np.asarray(fc_r))
    pn, pg = gang_to_device([(nodes, group)], "cpu")
    assert int(total[0]) == int(port._gang_fit_plain(pn, pg)[2][0])


@pytest.mark.parametrize("quota", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_gang_stage_fused_matches_reference_fuzz(seed, quota):
    rng = np.random.default_rng(100 + seed)
    rows = [gang_inputs(rng, 256, quota=quota) for _ in range(5)]
    stacked_nodes = ref.NodeInputs(*[
        None if f == "quota_ok" and not quota
        else np.stack([getattr(n, f) for n, _ in rows])
        for f in ref.NodeInputs._fields])
    stacked_groups = ref.GroupInputs(*[
        np.stack([getattr(g, f) for _, g in rows])
        for f in ref.GroupInputs._fields])
    fits_r, fcs_r = ref.gang_fit_fused_jit(stacked_nodes, stacked_groups)
    fits, fcs, _ = _staged(rows)
    np.testing.assert_array_equal(fits, np.asarray(fits_r))
    np.testing.assert_array_equal(fcs, np.asarray(fcs_r))
    assert fits.any() and not fits.all(), "the fuzz must decide both ways"


@pytest.mark.parametrize("case", sorted(BOUNDARY))
def test_gang_stage_boundary_matches_reference(case):
    caps, ks, want = BOUNDARY[case]
    rows = _boundary_rows(caps, ks)
    fits, _, total = _staged(rows)
    assert fits.tolist() == want
    assert [bool(ref.gang_fit_fused_jit(
        ref.NodeInputs(*[None if v is None else np.stack([v] * len(rows))
                         for v in rows[0][0]]),
        ref.GroupInputs(*[np.stack([getattr(g, f) for _, g in rows])
                          for f in ref.GroupInputs._fields]))[0][i])
        for i in range(len(rows))] == want
    assert total.tolist() == [sum(min(c, min(k, K_CLAMP)) for c in caps)
                              for k in ks]


@pytest.mark.parametrize("quota", [False, True])
def test_gang_stage_layout_and_result(quota):
    """The stage holds the columns K8 reads and no other, each at a
    16-byte aligned offset; the result buffer is 44 bytes a gang, total
    i64 | fail i32[8] | fit i32, and unpacks alike from numpy and torch."""
    g, n, cc, npl = 3, 100, 4, 4
    layout, nbytes = port.gang_stage_layout(g, n, cc, npl, quota)
    names = [row[0] for row in layout]
    assert not {"total_tasks", "failures", "leaf"} & set(names)
    assert ("quota_ok" in names) is quota
    assert all(off % 16 == 0 for *_, off in layout)
    ends = [off + int(np.prod(shape)) * (4 if dt == torch.int32 else 1)
            for _, _, dt, shape, off in layout]
    assert ends == sorted(ends) and nbytes == -(-ends[-1] // 16) * 16
    assert all(b <= a for b, (*_, a) in zip(ends, layout[1:]))
    rng = np.random.default_rng(9)
    rows = [gang_inputs(rng, n, quota=quota) for _ in range(g)]
    for r in rows:
        r[1].con_op[:] = rng.integers(0, 3, cc)
    fit, fail, total = _staged(rows)
    arr = np.zeros(44 * g, np.uint8)
    arr[:8 * g].view(np.int64)[:] = total
    arr[8 * g:40 * g].view(np.int32)[:] = fail.reshape(-1)
    arr[40 * g:].view(np.int32)[:] = fit
    for buf in (arr, torch.from_numpy(arr)):
        f2, fc2, t2 = port.unpack_gang(buf, g)
        np.testing.assert_array_equal(np.asarray(f2), fit)
        np.testing.assert_array_equal(np.asarray(fc2), fail)
        np.testing.assert_array_equal(np.asarray(t2), total)
    want = _port_fit(rows)
    np.testing.assert_array_equal(fit, want[0])
    np.testing.assert_array_equal(fail, want[1])


def test_gang_stage_reused_per_shape():
    """One stage a (G, n, cc, np, quota) key, refilled verdict after
    verdict with other gangs; every verdict equals the stacked route's."""
    rng = np.random.default_rng(21)
    stages = {}
    for step in range(6):
        g = 1 + step % 2
        rows = [gang_inputs(rng, 64, quota=bool(step % 3 == 0))
                for _ in range(g)]
        fit, fail, _ = _staged(rows, stages)
        want = _port_fit(rows)
        np.testing.assert_array_equal(fit, want[0], err_msg=str(step))
        np.testing.assert_array_equal(fail, want[1], err_msg=str(step))
    assert sorted(stages) == [(1, 64, 4, 4, False), (1, 64, 4, 4, True),
                              (2, 64, 4, 4, False), (2, 64, 4, 4, True)]


def test_gang_stages_kept_are_bounded():
    """Stacks of every size from 1 to GANG_STAGES_KEPT + 4 gangs: the
    planner keeps at most GANG_STAGES_KEPT stages, drops the one used
    longest ago, and every verdict equals the stacked route's."""
    from swarmkit_tpu_torch.ops.convert import GANG_STAGES_KEPT
    rng = np.random.default_rng(23)
    stages = {}
    one = [gang_inputs(rng, 32, quota=False)]
    last = GANG_STAGES_KEPT + 4
    for g in range(1, last + 1):
        rows = [gang_inputs(rng, 32, quota=False) for _ in range(g)]
        fit, fail, _ = _staged(rows, stages)
        want = _port_fit(rows)
        np.testing.assert_array_equal(fit, want[0], err_msg=str(g))
        np.testing.assert_array_equal(fail, want[1], err_msg=str(g))
        _staged(one, stages)   # the single gang's stage stays in use
        assert len(stages) <= GANG_STAGES_KEPT
    # the single gang's and the last GANG_STAGES_KEPT - 1 stacks'
    kept = sorted(key[0] for key in stages)
    assert kept == [1] + list(range(last - GANG_STAGES_KEPT + 2, last + 1))


def test_gang_stage_refuses_mixed_quota():
    rng = np.random.default_rng(5)
    rows = [gang_inputs(rng, 64, quota=True), gang_inputs(rng, 64,
                                                          quota=False)]
    with pytest.raises(ValueError, match="quota_ok"):
        gang_stage(rows, "cpu", {})


# ----------------------------------------------------------- planner level

def _mods(pkg):
    return (importlib.import_module(f"{pkg}.models"),
            importlib.import_module(f"{pkg}.state"),
            importlib.import_module(f"{pkg}.scheduler"))


def _planner(pkg):
    if pkg == REF:
        from swarmkit_tpu.ops import TPUPlanner
        p = TPUPlanner()
        p.enable_small_group_routing = False
        return p
    from swarmkit_tpu_torch.ops import TorchPlanner
    return TorchPlanner(device="cpu")


def fleet_store(pkg, gangs, n_nodes=24, node_cpus=8):
    """A store of ``n_nodes`` READY nodes (``node_cpus`` CPUs, racks r0-r2)
    and one service per gang entry (name, cpus, members, min_size,
    gang_id, constraints), all tasks PENDING, ids fixed."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    nodes = [M.Node(
        id=f"n{i:03d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"n{i:03d}", labels={"rack": f"r{i % 3}"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"n{i:03d}",
            resources=M.Resources(nano_cpus=node_cpus * 10**9,
                                  memory_bytes=64 << 30)))
        for i in range(n_nodes)]

    def mk(tx):
        for n in nodes:
            tx.create(n)
        for name, cpus, count, min_size, gang_id, cons in gangs:
            spec = M.TaskSpec(
                resources=M.ResourceRequirements(reservations=M.Resources(
                    nano_cpus=int(cpus * 10**9), memory_bytes=1 << 30)),
                placement=M.Placement(
                    gang=M.GangConfig(min_size=min_size),
                    constraints=list(cons)),
                gang_id=gang_id)
            tx.create(M.Service(
                id=name, spec=M.ServiceSpec(
                    annotations=M.Annotations(name=name),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=count),
                    task=spec),
                spec_version=M.Version(index=1)))
            for s in range(count):
                tx.create(M.Task(
                    id=f"{name}-t{s:02d}", service_id=name, slot=s + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING)))
    store.update(mk)
    return store


FLEET = (
    [(f"g8-{g}", 2, 8, 8, "", ()) for g in range(4)]
    + [(f"g4-{g}", 1, 4, 4, "", ()) for g in range(6)]
    + [(f"x{g}{h}", 1, 4, 8, f"xg{g}", ()) for g in range(3) for h in "ab"]
    # two constraints: another constraint-slot bucket than its partner's
    + [("xc-a", 1, 3, 6, "xc", ["node.labels.rack!=r0",
                                "node.labels.rack!=r2"]),
       ("xc-b", 0.5, 3, 6, "xc", ())]
)


def _fleet_tick(pkg, gangs, **kw):
    M, _, Sch = _mods(pkg)
    store = fleet_store(pkg, gangs, **kw)
    planner = _planner(pkg)
    sched = Sch.Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    sched.tick()
    tasks = sorted((t.id, t.node_id, int(t.status.state), t.status.err)
                   for t in store.view(lambda tx: tx.find(M.Task)))
    return tasks, planner, sched


def test_gang_fleet_matches_reference_planner():
    want, ref_planner, ref_sched = _fleet_tick(REF, FLEET)
    got, planner, sched = _fleet_tick(PORT, FLEET)
    assert got == want
    assert all(node for _, node, _, _ in got), "every gang placed whole"
    assert sched.gang.stats == ref_sched.gang.stats
    assert sched.gang.stats["gangs_admitted"] == 14
    stats, ref_stats = planner.stats, ref_planner.stats
    for key in ("gang_fit_device", "gang_fit_fused"):
        assert stats.get(key, 0) == ref_stats.get(key, 0), key
    # one-service gangs and the mixed-bucket cross gang judge per group,
    # the same-bucket cross gangs stack
    assert stats["gang_fit_device"] == 10 + 2
    assert stats["gang_fit_fused"] == 6
    assert stats.get("gang_fit_host", 0) == 0


def test_infeasible_gang_defers_whole():
    gangs = FLEET[:2] + [("huge", 9, 4, 4, "", ()),
                         ("short", 4, 40, 40, "", ())]
    want, _, ref_sched = _fleet_tick(REF, gangs)
    got, planner, sched = _fleet_tick(PORT, gangs)
    assert got == want
    for tid, node, _, err in got:
        if tid.startswith(("huge", "short")):
            assert node == "" or node is None, tid
            assert "all-or-nothing placement infeasible" in err, (tid, err)
        else:
            assert node, tid
    assert sched.gang.stats["gangs_deferred"] == 2
    assert sched.gang.stats["rollbacks"] == 0, "the precheck decided"
    assert planner.stats["gang_fit_device"] == 4


def test_gang_feasible_verdicts_match_reference_planner():
    """Direct verdicts on one cluster state: per group and fused, across
    feasible, capacity-short, constrained and mixed-bucket groups."""
    gangs = [("a", 2, 30, 30, "", ()), ("b", 2, 200, 200, "", ()),
             ("c", 1, 10, 10, "", ["node.labels.rack==r2"]),
             ("d", 1, 100, 100, "", ["node.labels.rack==r2"]),
             ("e", 9, 1, 1, "", ())]
    verdicts = []
    for pkg in (REF, PORT):
        M, _, Sch = _mods(pkg)
        store = fleet_store(pkg, gangs)
        planner = _planner(pkg)
        sched = Sch.Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        wants = [(next(iter(g.values())), len(g))
                 for g in sched.unassigned_groups.values() if g]
        single = [planner.gang_feasible(sched, t, k) for t, k in wants]
        many = planner.gang_feasible_many(sched, wants)
        verdicts.append((single, many, planner.stats.get("gang_fit_device"),
                         planner.stats.get("gang_fit_fused")))
    assert verdicts[0] == verdicts[1]
    single, many = verdicts[1][:2]
    assert single == many
    assert True in single and False in single
