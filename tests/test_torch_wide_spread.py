"""Spreads over more than 8,192 values: the port against the reference.

A spread over a per-node label (``node.labels.host``) on a cluster of more
than 8,192 nodes asks for one task per host; the leaf bucket ``l_bucket``
rounds its value count up to 16,384 segments.  The reference plans such a
group on its kernel, per group and fused.  These tests hold the port to
it task by task on the CPU: the fused tick of two such services (8,200
nodes, 8,200 tasks each), the same tick over a two-shard node-axis split,
a per-group spread over 9,000 values, and the water-fill's plain version
against the reference's ``seg_waterfill`` at 16,384 segments with branch
totals near 2^24.  Task counts are multiples of the node count, so no tie
among equally loaded nodes is left to a tie-break order.
"""

import importlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import tensor  # noqa: E402
from swarmkit_tpu_torch.ops.densify import l_bucket  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"


def _mods(pkg):
    return (importlib.import_module(pkg + ".models"),
            importlib.import_module(pkg + ".state"),
            importlib.import_module(pkg + ".scheduler"))


def per_host_store(pkg, n_nodes, services):
    """A store of ``n_nodes`` READY nodes (16 CPUs, 64 GiB), each with its
    own ``host`` label, and one replicated service per entry of
    ``services`` (its task count; 0.1 CPU and 64 MiB a task) spread over
    ``node.labels.host``.  Ids are fixed, so the two packages' stores
    match task by task."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    nodes = [M.Node(
        id=f"n{i:05d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"node-{i:05d}", labels={"host": f"h{i}"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"node-{i:05d}",
            platform=M.Platform(os="linux", architecture="amd64"),
            resources=M.Resources(nano_cpus=16 * 10**9,
                                  memory_bytes=64 << 30)))
        for i in range(n_nodes)]
    store.update(lambda tx: [tx.create(n) for n in nodes])
    for si, n_tasks in enumerate(services):
        sid = f"svc{si}"
        spec = M.TaskSpec(
            placement=M.Placement(preferences=[M.PlacementPreference(
                spread=M.SpreadOver(spread_descriptor="node.labels.host"))]),
            resources=M.ResourceRequirements(reservations=M.Resources(
                nano_cpus=10**8, memory_bytes=64 << 20)))
        svc = M.Service(
            id=sid,
            spec=M.ServiceSpec(annotations=M.Annotations(name=sid),
                               mode=M.ServiceMode.REPLICATED,
                               replicated=M.ReplicatedService(
                                   replicas=n_tasks),
                               task=spec),
            spec_version=M.Version(index=1))
        tasks = [M.Task(id=f"{sid}-t{k:05d}", service_id=sid, slot=k + 1,
                        desired_state=M.TaskState.RUNNING, spec=spec,
                        spec_version=M.Version(index=1),
                        status=M.TaskStatus(state=M.TaskState.PENDING))
                 for k in range(n_tasks)]

        def mk(tx, svc=svc, tasks=tasks):
            tx.create(svc)
            for t in tasks:
                tx.create(t)
        store.update(mk)
    return store


def tick(pkg, planner, n_nodes, services):
    """One scheduler tick at pipeline depth 2; (sorted (task id, node id,
    state) triples, the planner)."""
    M, _, Sched = _mods(pkg)
    store = per_host_store(pkg, n_nodes, services)
    sched = Sched.Scheduler(store, batch_planner=planner, pipeline_depth=2)
    store.view(sched._setup_tasks_list)
    sched.tick()
    tasks = store.view(lambda tx: tx.find(M.Task))
    return sorted((t.id, t.node_id, int(t.status.state))
                  for t in tasks), planner


def ref_planner(fused=True):
    from swarmkit_tpu.ops import TPUPlanner
    p = TPUPlanner()
    p.enable_small_group_routing = False   # every group on the kernels
    p.fused_enabled = fused
    return p


def port_planner(fused=True, mesh=None):
    from swarmkit_tpu_torch.ops import TorchPlanner
    p = TorchPlanner(device="cpu", mesh=mesh)
    p.fused_enabled = fused
    return p


FUSED_NODES, FUSED_SERVICES = 8200, [8200, 8200]


def test_leaf_bucket_of_a_per_node_spread_passes_8192():
    assert l_bucket(FUSED_NODES) == 16384 and l_bucket(9000) == 16384


def test_fused_per_node_spread_tick_matches_reference():
    """Two services spread one task a host over 8,200 hosts fuse into one
    run over 16,384 leaf segments and place as the reference does."""
    want, ref_p = tick(REF, ref_planner(), FUSED_NODES, FUSED_SERVICES)
    got, port_p = tick(PORT, port_planner(), FUSED_NODES, FUSED_SERVICES)
    assert got == want
    stats, ref_stats = port_p.stats, ref_p.stats
    assert stats["groups_fused"] == ref_stats["groups_fused"] == 2
    assert stats["fused_chunks"] == ref_stats["fused_chunks"]
    assert stats["groups_fallback"] == ref_stats["groups_fallback"] == 0
    assert all(node for _, node, _ in got), "every task placed"
    per_node = {}
    for _, node, _ in got:
        per_node[node] = per_node.get(node, 0) + 1
    assert set(per_node.values()) == {2}, "two tasks a host"


def test_fused_per_node_spread_tick_on_mesh_matches_unsharded():
    """The same tick over a two-shard node-axis split places as the
    unsharded port tick."""
    from swarmkit_tpu_torch.parallel import make_mesh
    want, base = tick(PORT, port_planner(), FUSED_NODES, FUSED_SERVICES)
    got, split = tick(PORT, port_planner(mesh=make_mesh(["cpu"] * 2)),
                      FUSED_NODES, FUSED_SERVICES)
    assert got == want
    assert split.stats["groups_fused"] == base.stats["groups_fused"] == 2
    assert split.stats["groups_fallback"] == 0
    assert split.streaming_snapshot()["mesh_devices"] == 2


def test_per_group_spread_over_9000_values_on_the_kernel_path():
    """A per-group spread over 9,000 per-node values is planned on the
    port's kernel path (no host route), as the reference plans it."""
    want, ref_p = tick(REF, ref_planner(fused=False), 9000, [9000])
    got, port_p = tick(PORT, port_planner(fused=False), 9000, [9000])
    assert got == want
    stats, ref_stats = port_p.stats, ref_p.stats
    assert stats["groups_planned"] == ref_stats["groups_planned"] == 1
    assert stats["groups_fallback"] == ref_stats["groups_fallback"] == 0
    assert len({node for _, node, _ in got}) == 9000, "one task a host"


def test_waterfill_plain_matches_reference_at_16384_segments():
    """The water-fill's plain version at L = 16,384 against the reference's
    ``seg_waterfill``: two elements a segment, and segments of eight
    elements of capacity near 2^21 whose totals straddle 2^24, with k
    below, at and above the segment's capacity."""
    rng = np.random.RandomState(16384)
    L = 16384
    n = 2 * L
    seg = np.repeat(np.arange(L), 2).astype(np.int32)
    e = rng.randint(0, 40, n).astype(np.int32)
    cap = rng.randint(0, 7, n).astype(np.int32)
    k_seg = rng.randint(0, 12, L).astype(np.int32)
    wide = rng.choice(L, 64, replace=False)
    big = np.concatenate([np.nonzero(seg == s)[0] for s in wide])
    cap[big] = (1 << 21) + rng.randint(-3, 4, big.shape[0])
    extra = np.repeat(wide, 6).astype(np.int32)   # six more elements each
    seg = np.concatenate([seg, extra])
    e = np.concatenate([e, rng.randint(0, 40, extra.shape[0])]).astype(
        np.int32)
    cap = np.concatenate([cap, (1 << 21) + rng.randint(
        -3, 4, extra.shape[0])]).astype(np.int32)
    totals = np.bincount(seg, weights=cap.astype(np.float64), minlength=L)
    assert totals[wide].min() < (1 << 24) < totals[wide].max()
    k_seg[wide[:16]] = ref.K_CLAMP
    k_seg[wide[16:32]] = ref.K_CLAMP - 1
    k_seg[wide[32:]] = rng.randint(1 << 20, 1 << 22, 32)
    tie = rng.permutation(seg.shape[0]).astype(np.int32)
    x_r = ref.seg_waterfill(*map(jnp.asarray, (e, cap, tie, k_seg, seg)), L)
    x_p = port._waterfill_plain(*(tensor(a, "cpu")
                                  for a in (e, cap, tie, k_seg, seg)), L)
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_r))
    placed = np.bincount(seg, weights=x_p.numpy(), minlength=L)
    assert (placed == np.minimum(k_seg, totals)).all()
