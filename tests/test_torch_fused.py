"""The port's fused many-service route on the CPU, against the reference.

Kernel level: ``plan_fused`` (the plain PyTorch versions of K1-K6 under
the port's host loop) against the reference's ``plan_fused_jit`` under
x64, on seeded numpy inputs handed to both -- a run that mixes the four
strategies, two groups of one service slot, padding slots, a
quota-blocked group, and available resources below, equal to and above
the demand (negative too).  Every output is an integer, so ``x``,
``fail_counts``, ``spill`` and the carry must be bit-equal.

Planner level: many-service ticks built twice with fixed ids, once with
the reference's models and ``TPUPlanner`` (small-group routing off), once
with the port's and ``TorchPlanner(device="cpu")``; placements are
compared task id by task id, with the fused route on and off, and through
a spread group that saturates a branch (the run aborts and the group goes
to the host oracle).
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

from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import fused_to_device  # noqa: E402
from swarmkit_tpu_torch.ops.fusedbatch import chunk_sizes  # noqa: E402
from swarmkit_tpu_torch.scheduler import strategy as strategy_mod  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
SPREAD, BINPACK, WEIGHTED, LEARNED = 0, 1, 2, 3


# ------------------------------------------------------------ kernel level

def fused_inputs(seed, nb=1024, n_valid=1000, strategies=None, quota=True):
    """Seeded (FusedShared, FusedGroups, FusedCarry, FusedStrategy or None,
    L) in the reference's numpy layout: eight group slots, the last two
    padding (k = 0)."""
    rng = np.random.RandomState(seed)
    G, S, cc, p = 8, 4, 4, 4
    strategies = [SPREAD, BINPACK, WEIGHTED, LEARNED, SPREAD, WEIGHTED] \
        if strategies is None else strategies
    n_real = len(strategies)
    valid = np.zeros(nb, bool)
    valid[:n_valid] = True
    shared = ref.FusedShared(
        valid=valid, ready=rng.rand(nb) < 0.95,
        os_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        arch_hash=rng.randint(0, 2, (2, nb)).astype(np.int32),
        svc0=rng.randint(0, 6, (S, nb)).astype(np.int32))

    cpu_unit, mem_unit = 10**8, 64 << 20
    # available resources: mostly plenty, but some nodes exactly at one
    # demand, one short of it, at zero and below zero
    cpu = rng.randint(0, 64, nb).astype(np.int64) * 10**9
    mem = rng.randint(0, 256, nb).astype(np.int64) << 30
    cpu[:40] = cpu_unit                       # exactly one task
    cpu[40:60] = cpu_unit - 1                 # just short
    cpu[60:70] = 0
    cpu[70:80] = -3 * cpu_unit - 7            # over-committed
    mem[80:100] = 3 * mem_unit                # exactly three tasks
    mem[100:110] = -1
    mem[110:130] = 2 * mem_unit + 5
    carry = ref.FusedCarry(
        total=rng.randint(0, 2000, nb).astype(np.int32), cpu=cpu, mem=mem,
        svc_acc=rng.randint(0, 3, (S, nb)).astype(np.int32))

    k = np.zeros(G, np.int32)
    k[:n_real] = rng.randint(200, 3000, n_real)
    slot = np.array([0, 1, 2, 3, 0, 1, 0, 0], np.int32)   # 0 twice
    cpu_d = np.zeros(G, np.int64)
    mem_d = np.zeros(G, np.int64)
    cpu_d[:n_real] = cpu_unit
    mem_d[:n_real] = mem_unit
    cpu_d[2] = 0                              # memory-only demand
    mem_d[3] = 0                              # cpu-only demand
    mem_d[4] = 3 * mem_unit
    con_hash = np.zeros((G, cc, 2, nb), np.int32)
    con_op = np.full((G, cc), 2, np.int32)
    con_exp = np.zeros((G, cc, 2), np.int32)
    con_hash[1, 0] = rng.randint(0, 3, (2, nb))
    con_op[1, 0] = 1                          # one != constraint
    con_exp[1, 0] = (1, 1)
    con_hash[4, 2] = (rng.rand(2, nb) < 0.2).astype(np.int32)
    con_op[4, 2] = 0                          # one == constraint
    plat = np.full((G, p, 4), -1, np.int32)
    plat[:, 0] = 0                            # any platform
    plat[3, 1] = (1, 1, 0, 0)
    failures = rng.choice([0, 0, 0, 1, 5, 9, 80], (G, nb)).astype(np.int32)
    leaf = np.zeros((G, nb), np.int32)
    for g, sid in enumerate(strategies):
        if sid == SPREAD:
            leaf[g] = np.arange(nb) % 20      # 20 racks
    extra = rng.rand(G, nb) < 0.99
    quota_ok = None
    if quota:
        quota_ok = np.ones((G, nb), bool)
        quota_ok[n_real - 1] = False          # the last real group blocked
    groups = ref.FusedGroups(
        k=k, slot=slot, maxrep=np.array([0, 0, 0, 0, 3, 0, 0, 0], np.int32),
        cpu_d=cpu_d, mem_d=mem_d, con_hash=con_hash, con_op=con_op,
        con_exp=con_exp, plat=plat, failures=failures, leaf=leaf,
        extra_mask=extra, quota_ok=quota_ok)

    strat = None
    if any(strategies):
        sid = np.zeros(G, np.int32)
        sid[:n_real] = strategies
        weights = np.zeros((G, 4), np.int32)
        weights[2] = (2, 3, 1, 1)
        weights[5] = (0, strategy_mod.W_CLAMP, 4, 0)
        w1, b1, w2, b2 = strategy_mod.learned_params()
        strat = ref.FusedStrategy(sid=sid, weights=weights, w1=w1, b1=b1,
                                  w2=w2, b2=np.asarray(b2, np.int32))
    L = 256 if SPREAD in strategies else 1
    return shared, groups, carry, strat, L


def run_reference(shared, groups, carry, strat, L):
    with jax.enable_x64(True):
        conv = lambda t: None if t is None else type(t)(  # noqa: E731
            *[None if v is None else jnp.asarray(v) for v in t])
        xs, fcs, spills, out = ref.plan_fused_jit(
            conv(shared), conv(groups), conv(carry), L, conv(strat))
        return (np.asarray(xs), np.asarray(fcs), np.asarray(spills),
                tuple(np.asarray(v) for v in out))


FUSED_CASES = {
    "mixed": dict(),
    "mixed_no_quota": dict(quota=False),
    "spread_only": dict(strategies=[SPREAD] * 5),
    "strategies_only": dict(strategies=[BINPACK, WEIGHTED, LEARNED,
                                        BINPACK]),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_plan_fused_matches_reference_jit(case):
    shared, groups, carry, strat, L = fused_inputs(3, **FUSED_CASES[case])
    xs_r, fcs_r, spills_r, carry_r = run_reference(shared, groups, carry,
                                                   strat, L)
    ps, pg, pc, pst = fused_to_device(shared, groups, carry, strat, "cpu")
    sids = [SPREAD] * len(groups.k) if strat is None else strat.sid.tolist()
    xs, fcs, spills, out = port.plan_fused(ps, pg, pc, L, pst, sids)
    np.testing.assert_array_equal(xs.numpy(), xs_r)
    np.testing.assert_array_equal(fcs.numpy(), fcs_r)
    np.testing.assert_array_equal(spills.numpy(), spills_r)
    for name, got, want in zip(port.FusedCarry._fields, out, carry_r):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # the cases place real work: every real group places something, the
    # padding slots nothing, and the quota-blocked group nothing
    n_real = int((groups.k > 0).sum())
    assert (xs_r[n_real:] == 0).all()
    if groups.quota_ok is not None:
        assert xs_r[n_real - 1].sum() == 0
        assert fcs_r[n_real - 1][7] > 0
    assert xs_r[0].sum() > 0


@pytest.mark.parametrize("hidden", [1, 8, 64])
def test_plan_fused_scored_slots_match_reference_jit(hidden):
    """A chunk with every strategy id, whose weighted and learned slots
    score in their slot entries (the scored K1F's plain version), against
    ``plan_fused_jit`` for learned scorers of 1, 8 and 64 hidden units."""
    shared, groups, carry, strat, L = fused_inputs(
        40 + hidden, strategies=[SPREAD, BINPACK, WEIGHTED, LEARNED,
                                 LEARNED, WEIGHTED])
    rng = np.random.RandomState(hidden)
    w, f = strategy_mod.MLP_W_CLAMP, len(strategy_mod.MLP_FEATURES)
    strat = strat._replace(
        w1=rng.randint(-w, w + 1, (f, hidden)).astype(np.int32),
        b1=rng.randint(-w, w + 1, hidden).astype(np.int32),
        w2=rng.randint(-w, w + 1, hidden).astype(np.int32),
        b2=np.int32(rng.randint(-w, w + 1)))
    xs_r, fcs_r, spills_r, carry_r = run_reference(shared, groups, carry,
                                                   strat, L)
    ps, pg, pc, pst = fused_to_device(shared, groups, carry, strat, "cpu")
    xs, fcs, spills, out = port.plan_fused(ps, pg, pc, L, pst,
                                           strat.sid.tolist())
    np.testing.assert_array_equal(xs.numpy(), xs_r)
    np.testing.assert_array_equal(fcs.numpy(), fcs_r)
    np.testing.assert_array_equal(spills.numpy(), spills_r)
    for name, got, want in zip(port.FusedCarry._fields, out, carry_r):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # the scored slots place (the last real one is quota-blocked)
    for g in (2, 3, 4):
        assert xs_r[g].sum() > 0


@pytest.mark.parametrize("g,want", [(0, []), (1, [1]), (2, [1, 1]),
                                    (3, [2, 1]), (4, [2, 2]),
                                    (10, [4, 4, 2])])
def test_chunk_sizes(g, want):
    from swarmkit_tpu.ops.fusedbatch import chunk_sizes as ref_chunk_sizes
    assert chunk_sizes(g) == want == ref_chunk_sizes(g, 4)


# ----------------------------------------------------------- planner level

def _mods(pkg):
    return (importlib.import_module(f"{pkg}.models"),
            importlib.import_module(f"{pkg}.state"),
            importlib.import_module(f"{pkg}.scheduler"))


def many_service_store(pkg, services, n_nodes=40, tiny_rack=False,
                       log_plugins=False):
    """A store of ``n_nodes`` nodes (16 CPUs / 64 GiB, rack r{i % 5},
    tier web|db) and one replicated service per entry of ``services``:
    dicts with ``tasks`` and optionally ``strategy``, ``weights``,
    ``spread``, ``cpus`` (reservation per task), ``constraints`` and
    ``log_driver``.  With ``log_plugins`` every fourth node's engine offers
    only the "json-file" log plugin and the next one "fluentd" too, so a
    "fluentd" log driver rules a quarter of the nodes out.  Ids are fixed,
    so two builds compare task by task."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()

    def engine(i):
        if not log_plugins or i % 4 > 1:
            return M.EngineDescription()
        names = ["json-file"] + (["fluentd"] if i % 4 == 1 else [])
        return M.EngineDescription(plugins=[
            M.PluginDescription(type="Log", name=nm) for nm in names])

    nodes = [M.Node(
        id=f"n{i:04d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"node-{i:04d}",
            labels={"rack": f"r{i % 5}",
                    "tier": "web" if i % 2 else "db"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"node-{i:04d}",
            platform=M.Platform(os="linux", architecture="amd64"),
            resources=M.Resources(nano_cpus=16 * 10**9,
                                  memory_bytes=64 << 30),
            engine=engine(i)))
        for i in range(n_nodes)]
    if tiny_rack:
        nodes.append(M.Node(
            id="n9999",
            spec=M.NodeSpec(annotations=M.Annotations(
                name="tiny", labels={"rack": "r9", "tier": "web"})),
            status=M.NodeStatus(state=M.NodeState.READY),
            description=M.NodeDescription(
                hostname="tiny",
                platform=M.Platform(os="linux", architecture="amd64"),
                resources=M.Resources(nano_cpus=2 * 10**9,
                                      memory_bytes=2 << 30))))
    store.update(lambda tx: [tx.create(n) for n in nodes])
    for si, sv in enumerate(services):
        sid = f"svc{si}"
        placement = M.Placement(
            constraints=list(sv.get("constraints", [])),
            preferences=[M.PlacementPreference(spread=M.SpreadOver(
                spread_descriptor=d)) for d in sv.get("spread", [])],
            strategy=sv.get("strategy", "spread"),
            strategy_weights=dict(sv.get("weights", {})))
        spec = M.TaskSpec(
            placement=placement,
            resources=M.ResourceRequirements(reservations=M.Resources(
                nano_cpus=int(sv.get("cpus", 0.1) * 10**9),
                memory_bytes=sv.get("mem", 64 << 20))),
            log_driver=(M.Driver(name=sv["log_driver"])
                        if "log_driver" in sv else None))
        svc = M.Service(
            id=sid,
            spec=M.ServiceSpec(annotations=M.Annotations(name=sid),
                               mode=M.ServiceMode.REPLICATED,
                               replicated=M.ReplicatedService(
                                   replicas=sv["tasks"]),
                               task=spec),
            spec_version=M.Version(index=1))
        tasks = [M.Task(id=f"{sid}-t{k:04d}", service_id=sid, slot=k + 1,
                        desired_state=M.TaskState.RUNNING, spec=spec,
                        spec_version=M.Version(index=1),
                        status=M.TaskStatus(state=M.TaskState.PENDING))
                 for k in range(sv["tasks"])]

        def mk(tx, svc=svc, tasks=tasks):
            tx.create(svc)
            for t in tasks:
                tx.create(t)
        store.update(mk)
    return store


def tick(pkg, services, planner, depth=2, **kw):
    """One scheduler tick; returns (sorted (task id, node id, state)
    triples, scheduler)."""
    M, _, Sched = _mods(pkg)
    store = many_service_store(pkg, services, **kw)
    sched = Sched.Scheduler(store, batch_planner=planner,
                            pipeline_depth=depth)
    store.view(sched._setup_tasks_list)
    sched.tick()
    tasks = store.view(lambda tx: tx.find(M.Task))
    return sorted((t.id, t.node_id, int(t.status.state)) for t in tasks), \
        sched


def ref_planner(fused=True):
    from swarmkit_tpu.ops import TPUPlanner
    p = TPUPlanner()
    p.enable_small_group_routing = False   # every group on the kernels
    p.fused_enabled = fused
    return p


def port_planner(fused=True):
    from swarmkit_tpu_torch.ops import TorchPlanner
    p = TorchPlanner(device="cpu")
    p.fused_enabled = fused
    return p


# spread groups place a multiple of the node count (40 nodes, 5 racks of 8)
# so that no tie among equally loaded nodes is left to a tie-break order:
# the host tree walk and the water-fill break such ties differently
MIXED = [
    dict(tasks=80, spread=["node.labels.rack"]),
    dict(tasks=45, strategy="binpack", cpus=1),
    dict(tasks=50, strategy="weighted", weights={"spread": 2, "cpu": 3}),
    dict(tasks=37, strategy="learned"),
    dict(tasks=40, spread=["node.labels.rack"], cpus=0.5),
    dict(tasks=30, strategy="weighted", constraints=["node.labels.tier==web"]),
    dict(tasks=25, strategy="binpack", cpus=2),
    dict(tasks=40),
    dict(tasks=55, strategy="learned", cpus=0.25),
]


@pytest.mark.parametrize("depth", [1, 2])
def test_fused_tick_matches_reference(depth):
    want, ref_sched = tick(REF, MIXED, ref_planner(), depth)
    got, sched = tick(PORT, MIXED, port_planner(), depth)
    assert got == want
    stats, ref_stats = sched.batch_planner.stats, ref_sched.batch_planner.stats
    assert stats["groups_fused"] == ref_stats["groups_fused"] == len(MIXED)
    assert stats["fused_chunks"] == ref_stats["fused_chunks"] \
        == len(chunk_sizes(len(MIXED)))
    assert stats["groups_planned"] == 0
    assert stats.get("groups_strategy_host", 0) == 0
    assert stats["groups_fallback"] == 0
    assert all(node for _, node, _ in got), "every task placed"


def test_fused_off_places_the_same():
    """The fused route only changes the number of round-trips
    (reference ``plan_fused``'s contract, ``kernel.py:644-650``)."""
    fused, fused_sched = tick(PORT, MIXED, port_planner(fused=True))
    per_group, sched = tick(PORT, MIXED, port_planner(fused=False))
    assert fused == per_group
    assert fused_sched.batch_planner.stats["groups_fused"] == len(MIXED)
    stats = sched.batch_planner.stats
    assert stats.get("groups_fused", 0) == 0
    assert stats["groups_planned"] == len(MIXED)


def test_fused_tick_with_log_plugin_matches_reference():
    """Groups whose log driver needs a node plugin fuse with a per-group
    plugin mask: the same placements as the reference, and no such task
    on a node whose engine lacks the plugin."""
    services = MIXED[:4] + [
        dict(tasks=60, spread=["node.labels.rack"], log_driver="fluentd"),
        dict(tasks=33, strategy="binpack", cpus=1, log_driver="fluentd"),
        dict(tasks=29, strategy="learned", log_driver="fluentd"),
    ]
    want, ref_sched = tick(REF, services, ref_planner(), log_plugins=True)
    got, sched = tick(PORT, services, port_planner(), log_plugins=True)
    assert got == want
    stats, ref_stats = sched.batch_planner.stats, ref_sched.batch_planner.stats
    assert stats["groups_fused"] == ref_stats["groups_fused"] == len(services)
    assert stats["groups_fallback"] == 0
    assert all(node for _, node, _ in got), "every task placed"
    for tid, node, _ in got:
        if tid.split("-")[0] in ("svc4", "svc5", "svc6"):
            assert int(node[1:]) % 4 != 0, (tid, node)


def test_fused_tick_matches_host_oracle():
    """The fused route places as the scheduler's host path, which runs the
    spread tree walk and ``scheduler/strategy.py``'s oracles."""
    from collections import Counter

    def per_service_node(triples):
        return Counter((tid.split("-")[0], node) for tid, node, _ in triples)

    fused, _ = tick(PORT, MIXED, port_planner())
    host, _ = tick(PORT, MIXED, None)
    assert per_service_node(fused) == per_service_node(host)


def test_fused_spill_routes_group_to_host():
    """A spread branch that saturates mid-run (rack r9 is one tiny node)
    aborts the fused run: the group takes the host oracle and the rest of
    the run goes per group, exactly as in the reference."""
    services = [
        dict(tasks=30),
        dict(tasks=60, spread=["node.labels.rack"], cpus=1, mem=1 << 30),
        dict(tasks=30, strategy="binpack"),
        dict(tasks=20, strategy="weighted"),
    ]
    want, ref_sched = tick(REF, services, ref_planner(), n_nodes=16,
                           tiny_rack=True)
    got, sched = tick(PORT, services, port_planner(), n_nodes=16,
                      tiny_rack=True)
    assert got == want
    stats, ref_stats = sched.batch_planner.stats, ref_sched.batch_planner.stats
    assert ref_stats.get("groups_spill_to_host", 0) >= 1, \
        "workload no longer spills; rebuild it so the route is covered"
    for key in ("groups_spill_to_host", "groups_fused", "groups_planned"):
        assert stats.get(key, 0) == ref_stats.get(key, 0), key
    per_group, _ = tick(PORT, services, port_planner(fused=False),
                        n_nodes=16, tiny_rack=True)
    assert got == per_group
