"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (inside its body) where no CUDA device is
present.  On a machine with a card, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``
(``--noconftest`` because the repository's conftest imports jax, which the
card's machine does not need).  Every output is an integer, so the kernels
must be bit-equal to the plain versions.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    FUSED_ENTRY_CASES, PACK_EDGE_CASES, SHARD_FILL_CASES, VICTIM_CASES,
    VICTIM_EDGE_CASES, WATERFILL_MODES, edge_fill_inputs, fill_parts,
    fused_entry_inputs, fused_inputs, gang_rows, headline_fill_parts,
    pack_edge_inputs, plan_inputs, scatter_inputs, shard_fill_inputs,
    split_columns, victim_edge_inputs, victim_inputs, waterfill_call,
    waterfill_inputs)
from swarmkit_tpu_torch.ops import kernel as K
from swarmkit_tpu_torch.ops import preempt as P
from swarmkit_tpu_torch.ops.convert import (
    fused_to_device, gang_to_device, to_device, victims_to_device)
from swarmkit_tpu_torch.ops.densify import n_bucket
from swarmkit_tpu_torch.ops.planner import DEVICE_FAULT_COUNTERS
from swarmkit_tpu_torch.utils.metrics import registry

pytestmark = pytest.mark.gpu

#: the registry counters no test here may move: work that left the card
#: for a device error, an open breaker or the small-group router
OFF_CARD = DEVICE_FAULT_COUNTERS + (
    'swarm_planner_groups{route="host_small"}',)


@pytest.fixture(autouse=True)
def _stays_on_the_card():
    """Every test here holds the card's results, so none may pass through
    the host path that the breaker or the router would take: that path
    places as the kernels do, and would hide a kernel that fails."""
    before = {k: registry.get_counter(k) for k in OFF_CARD}
    yield
    moved = {k: registry.get_counter(k) - v for k, v in before.items()
             if registry.get_counter(k) != v}
    assert not moved, f"work left the card: {moved}"

SHAPES = {
    "small_flat": dict(nb=1024, n_valid=1000, n_leaves=1, k=700),
    "small_rack": dict(nb=1024, n_valid=1000, n_leaves=12, k=3000),
    "headline": dict(nb=16384, n_valid=10000, n_leaves=20, k=80000),
    "headline_two_level": dict(nb=16384, n_valid=10000, n_leaves=20,
                               n_top=4, k=80000),
    "headline_quota": dict(nb=16384, n_valid=10000, n_leaves=20,
                           k=80000, quota=True),
    "k_clamp": dict(nb=4096, n_valid=4000, n_leaves=3, k=K.K_CLAMP),
    # the filter columns the headline group does not read: max-replicas,
    # host ports, platform rows that name an os and an arch
    "filters_all": dict(nb=4096, n_valid=4000, n_leaves=6, k=3000,
                        near_2p24=False, quota=True, maxrep=5,
                        port_limited=True, plat_wildcard=False),
    "platform_rows": dict(nb=4096, n_valid=3000, n_leaves=6, k=20000,
                          plat_wildcard=False),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(case, device):
    """(nodes, group, L, hier) for a case, as tensors on ``device``."""
    nodes, group, L, hier = plan_inputs(7, **SHAPES[case])
    nodes, group, hier = to_device(nodes, group, hier, device)
    return nodes, group, L, hier


def _eq(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_feasibility_kernel_matches_plain(case):
    dev = _card()
    nodes, group, _, _ = _inputs(case, dev)
    mask, cap, fail = K.feasibility_and_capacity(nodes, group)
    torch.cuda.synchronize()
    pm, pc, pf = K._feasibility_plain(nodes, group)
    _eq(mask, pm)
    _eq(cap, pc)
    _eq(fail, pf)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_seg_sum_kernel_matches_plain(case):
    dev = _card()
    nodes, group, L, _ = _inputs(case, dev)
    _, cap, _ = K.feasibility_and_capacity(nodes, group)
    got = K.branch_sums(nodes.svc_tasks, nodes.valid, cap, nodes.leaf, L,
                        group.k)
    torch.cuda.synchronize()
    want = K._seg_sum_plain(nodes.svc_tasks, nodes.valid, cap, nodes.leaf,
                            L, group.k)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_waterfill_kernel_matches_plain(case):
    dev = _card()
    nodes, group, L, _ = _inputs(case, dev)
    _, cap, _ = K.feasibility_and_capacity(nodes, group)
    k_seg = torch.full((L,), int(group.k) // max(L, 1) + 3,
                       dtype=torch.int32, device=dev)
    e = K.spread_score(nodes)
    tie = K._tie_keys(nodes.total_tasks, cap.shape[0], dev)
    got = K.seg_waterfill(e, cap, tie, k_seg, nodes.leaf, L)
    torch.cuda.synchronize()
    _eq(got, K._waterfill_plain(e, cap, tie, k_seg, nodes.leaf, L))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_group_on_card_matches_cpu(case):
    dev = _card()
    nodes, group, L, hier = _inputs(case, dev)
    got = K.plan_group_packed(nodes, group, L, hier)
    torch.cuda.synchronize()
    cn, cg, _, ch = _inputs(case, "cpu")
    _eq(got, K.plan_group_packed(cn, cg, L, ch))


def _at_offset(t, off):
    """``t`` copied into a contiguous view that starts ``off`` elements
    into a larger buffer, as a shard's slice of a column does."""
    if t is None or t.dim() == 0:
        return t
    buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("off", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("nb", [1021, 1022, 1023, 4097, (1 << 17) + 3])
def test_feasibility_kernel_odd_sizes_and_offset_views(nb, off):
    """K1's column reads at their edges: a node count that fills no whole
    block (padding threads in the last one) and every column a view at an
    offset (shard slices start at any row) give the plain version's
    outputs, with and without the mask column, from one block an SM up to
    far more (2^17 nodes: 1,025 blocks, each warp staging its own copy of
    the group)."""
    dev = _card()
    nodes_np, group_np, _, _ = plan_inputs(
        13, nb=nb, n_valid=nb - 5, n_leaves=3, k=5000, near_2p24=False,
        quota=True, maxrep=4, port_limited=True, plat_wildcard=False)
    nodes, group, _ = to_device(nodes_np, group_np, (), dev)
    nodes = K.NodeInputs(*(_at_offset(t, off) for t in nodes))
    group = group._replace(con_hash=_at_offset(group.con_hash, off))
    mask, cap, fail = K.feasibility_and_capacity(nodes, group)
    n = nodes.valid.shape[0]
    cap_only = _at_offset(torch.full((n,), -1, dtype=torch.int32,
                                     device=dev), off)
    fail_only = torch.zeros(K.N_FILTERS, dtype=torch.int32, device=dev)
    K._feasibility_into(nodes, group, None, cap_only, fail_only)
    torch.cuda.synchronize()
    pm, pc, pf = K._feasibility_plain(nodes, group)
    assert int(pf.sum()) > 0 and int(pc.sum()) > 0
    for got, want in ((mask, pm), (cap, pc), (fail, pf), (cap_only, pc),
                      (fail_only, pf)):
        _eq(got, want)


def _launched(fn):
    kernels = K.KERNELS + P.KERNELS
    before = {k.name: k.launches for k in kernels}
    fn()
    torch.cuda.synchronize()
    return {k.name: k.launches - before[k.name] for k in kernels
            if k.launches != before[k.name]}


def test_kernels_count_launches():
    dev = _card()
    nodes, group, L, hier = _inputs("small_rack", dev)
    # K1 once, K2 once (one spread level), K3 twice (stage A + stage B)
    assert _launched(lambda: K.plan_group_packed(nodes, group, L, hier)) \
        == {"feasibility": 1, "seg_sum": 1, "waterfill": 2}


# ---------------------------------------- K3 as one cluster launch, K2

@pytest.mark.parametrize("mode", WATERFILL_MODES)
@pytest.mark.parametrize("n", [1024, 16384, 131072])
@pytest.mark.parametrize("L", [1, 20, 256, 8192, 16384, 65536])
def test_waterfill_cluster_kernel_matches_plain(L, n, mode):
    """K3 against its plain version on the same tensors, over L segments
    and n elements: elements held in registers and re-read from L2; the
    exchange route (segments shared between blocks or local to one) and
    the owner route (more than 256 shared segments, or L past 16,384 with
    its state in global memory); the spill epilogue on (saturating or not)
    and off."""
    dev = _card()
    kw, k_seg = waterfill_inputs(n + L, n, L, mode)
    got, spill = waterfill_call(torch, K, kw, k_seg, L, dev)
    torch.cuda.synchronize()
    want, want_spill = waterfill_call(torch, K, kw, k_seg, L, dev,
                                      plain=True)
    _eq(got, want)
    if spill is not None:
        _eq(spill, want_spill)


@pytest.mark.parametrize("L", [256, 65536])
def test_waterfill_cluster_kernel_twice_without_a_sync(L):
    """Two K3 calls on other inputs queued back to back, one launch each,
    then one sync: both equal their plain versions."""
    dev = _card()
    cases = [waterfill_inputs(seed, 16384, L, mode)
             for seed, mode in ((1, "stage_a"), (2, "stage_b"))]
    got = []
    launched = _launched(lambda: got.extend(
        waterfill_call(torch, K, kw, k_seg, L, dev) for kw, k_seg in cases))
    assert launched == {"waterfill": 2}
    for (x, spill), (kw, k_seg) in zip(got, cases):
        want, want_spill = waterfill_call(torch, K, kw, k_seg, L, dev,
                                          plain=True)
        _eq(x, want)
        if spill is not None:
            _eq(spill, want_spill)


def _seg_sum_inputs(seed, n, L, dev):
    """Seeded K2 inputs: n nodes over L segments, a tenth invalid, and
    eight nodes of K_CLAMP capacity in segment 0 (a total past 2^24)."""
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, L, n).astype(np.int32)
    seg[:8] = 0
    cap = rng.randint(0, 9, n).astype(np.int32)
    cap[:8] = K.K_CLAMP
    svc = rng.randint(-2, 9, n).astype(np.int32)
    svc[8:12] = K.SVC_CLAMP + 5
    valid = rng.rand(n) < 0.9

    def t(a):
        return torch.from_numpy(a).to(dev)

    return (t(svc), t(valid), t(cap), t(seg),
            torch.tensor(K.K_CLAMP - 1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("L", [1, 256, 2048, 2049, 16384])
def test_seg_sum_kernel_at_segment_counts(L):
    """K2 in one launch a call, through shared-memory partials (L <= 2048)
    and global ones: equal to its plain version, also for two calls
    queued back to back without a sync."""
    dev = _card()
    ins = [_seg_sum_inputs(seed, 16384, L, dev) for seed in (3, 4)]
    got = []
    launched = _launched(lambda: got.extend(
        K.branch_sums(*a[:4], L, a[4]) for a in ins))
    assert launched == {"seg_sum": 2}
    for g, a in zip(got, ins):
        for u, v in zip(g, K._seg_sum_plain(*a[:4], L, a[4])):
            _eq(u, v)


def _shard_sum_parts(seed, d, n, L, dev):
    """``d`` shards of ``n`` rows of K2's inputs as (svc, valid, cap, seg,
    k) tuples: :func:`_seg_sum_inputs` (a capacity total past 2^24) with
    some segments past L - 1 and below 0, which K2 drops."""
    svc, valid, cap, seg, k = _seg_sum_inputs(seed, d * n, L, dev)
    seg[9::11] = L
    seg[10::13] = -1
    return [(svc[i * n:(i + 1) * n], valid[i * n:(i + 1) * n],
             cap[i * n:(i + 1) * n], seg[i * n:(i + 1) * n], k)
            for i in range(d)]


@pytest.mark.parametrize("L", [1, 256, 2048, 2049, 16384])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_shard_seg_sum_kernel_matches_plain(d, L):
    """K2 over the shard table (one launch a level, every shard's rows):
    equal to the plain sum of the shards' partials in shard order then the
    clamps, and to K2 on the unsplit columns; sums past 2^24, segments
    out of range dropped; two calls without a sync (the accumulator is
    left zero)."""
    dev = _card()
    n = 16384 // d
    calls = [_shard_sum_parts(seed, d, n, L, dev) for seed in (8, 9)]
    got = []
    assert _launched(lambda: got.extend(
        K.branch_sums_sharded(parts, L) for parts in calls)) \
        == {"shard_seg_sum": 2}
    for sums, parts in zip(got, calls):
        assert len(sums) == d
        want = K._seg_fold_plain(
            [K._seg_partial_plain(*p[:4], L) for p in parts], parts[0][4])
        unsplit = K._seg_sum_plain(*(torch.cat([p[j] for p in parts])
                                     for j in range(4)), L, parts[0][4])
        for u, v, w in zip(sums[0], want, unsplit):
            _eq(u, v)
            _eq(u, w)
        assert int(want[2].max()) > 1 << 24


def test_plan_group_twice_without_a_sync():
    """Two plans queued back to back on the card, no sync between them:
    the second's K2 call reuses the stream's output buffers after the
    first plan's stage A read them; both equal the CPU plain path."""
    dev = _card()
    cases = ("headline", "headline_two_level")
    inputs = [_inputs(case, dev) for case in cases]
    torch.cuda.synchronize()
    got = [K.plan_group_packed(*ins) for ins in inputs]
    torch.cuda.synchronize()
    for buf, case in zip(got, cases):
        cn, cg, L, ch = _inputs(case, "cpu")
        _eq(buf, K.plan_group_packed(cn, cg, L, ch))


@pytest.mark.parametrize("L", [16384, 32768])
@pytest.mark.parametrize("shards", [1, 4, 16])
def test_shard_waterfill_kernel_at_wide_segment_counts(shards, L):
    """K10 over 16,384 segments (K3's exchange route) and 32,768 (its
    owner route, with global scratch) against its plain version and the
    one-shard fill."""
    dev = _card()
    arrs = shard_fill_inputs(9, nb=16384, n_valid=16000, L=L)
    parts = fill_parts(arrs, shards, dev)
    got = _fill(parts, L, False)
    _eq(got, torch.cat(K._shard_waterfill_plain(parts, L)))
    _eq(got, _fill(fill_parts(arrs, 1, dev), L, False))


# ------------------------------------------------------------- K4, K5, K6

FUSED_SHAPES = {
    "nb1024": dict(nb=1024, n_valid=1000),
    "nb16384": dict(nb=16384, n_valid=10000),
    "nb16384_quota": dict(nb=16384, n_valid=10000, quota=True),
}


def _fused(case, device):
    shared, groups, carry, strat, L = fused_inputs(
        11, **{k: v for k, v in FUSED_SHAPES[case].items()})
    return (*fused_to_device(shared, groups, carry, strat, device=device), L)


def _strategy_nodes(shared, groups, carry, g):
    """The NodeInputs/GroupInputs a fused slot's plan reads, from the
    plain prologue."""
    s = shared.svc0.shape[0]
    n = shared.valid.shape[0]
    dev = shared.valid.device
    ok, cap, svc = K._fused_prologue_plain(
        shared, carry, groups.cpu_d[g], groups.mem_d[g],
        K._slot_of(groups, g, s))
    nodes = K.NodeInputs(
        valid=shared.valid, ready=shared.ready, res_ok=ok, res_cap=cap,
        svc_tasks=svc, total_tasks=carry.total, failures=groups.failures[g],
        leaf=groups.leaf[g], os_hash=shared.os_hash,
        arch_hash=shared.arch_hash,
        port_conflict=torch.zeros(n, dtype=torch.bool, device=dev),
        extra_mask=groups.extra_mask[g])
    grp = K.GroupInputs(
        k=groups.k[g], con_hash=groups.con_hash[g], con_op=groups.con_op[g],
        con_exp=groups.con_exp[g], plat=groups.plat[g],
        maxrep=groups.maxrep[g],
        port_limited=torch.zeros((), dtype=torch.bool, device=dev))
    sin = K.StrategyInputs(
        hr_cpu=K._fused_headroom(carry.cpu, groups.cpu_d[g]),
        hr_mem=K._fused_headroom(carry.mem, groups.mem_d[g]),
        hr_gen=torch.full((n,), K.HR_CLAMP, dtype=torch.int32, device=dev),
        weights=torch.tensor([2, 3, 1, 1], dtype=torch.int32, device=dev),
        w1=None, b1=None, w2=None, b2=None)
    return nodes, grp, sin


def _entry_matches_plain(shared, groups, carry, g, x_prev, cols=True,
                         strat=None, sid=0):
    """K1F for slot ``g`` on clones of ``carry`` against its plain version
    on other clones: capacity, fail counts, svc, res_cap (``cols``; else
    only capacity and svc, res_cap left unwritten) and the updated carry;
    with ``strat`` the scored launch under strategy ``sid``, its level e
    in place of res_cap."""
    dev = shared.valid.device
    n = shared.valid.shape[0]
    s = shared.svc0.shape[0]
    a = K.FusedCarry(*(t.clone() for t in carry))
    b = K.FusedCarry(*(t.clone() for t in carry))
    out = [torch.full((n,), -1, dtype=torch.int32, device=dev)
           for _ in range(3)]
    fail = torch.zeros(K.N_FILTERS, dtype=torch.int32, device=dev)
    scored = strat is not None
    K._fused_feasibility(shared, groups, a, g, s, x_prev, fail, out[0],
                         out[1], out[2] if cols and not scored else None,
                         strat, sid, out[2] if scored else None)
    torch.cuda.synchronize()
    _, cap, pf, _, res_cap, svc, _, _, e = K._fused_feasibility_plain(
        shared, groups, b, g, s, x_prev, strat, sid)
    _eq(out[0], cap)
    _eq(fail, pf)
    _eq(out[1], svc)
    if scored:
        _eq(out[2], e)
    elif cols:
        _eq(out[2], res_cap)
    else:
        assert bool((out[2] == -1).all())
    for u, v in zip(a, b):
        _eq(u, v)
    return cap, pf


@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_fused_feasibility_kernel_matches_plain(case):
    """K1F on every slot of a cfg7 chunk (spread, binpack, weighted,
    learned), the first slot without a previous placement and the others
    with a carried one, against ``_fused_feasibility_plain``."""
    dev = _card()
    shared, groups, carry, strat, L = _fused(case, dev)
    n = shared.valid.shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    for g in range(groups.k.shape[0]):
        x_prev = None if g == 0 else torch.randint(
            0, 6, (n,), generator=gen, device=dev, dtype=torch.int32)
        _entry_matches_plain(shared, groups, carry, g, x_prev)


@pytest.mark.parametrize("cols", [True, False])
@pytest.mark.parametrize("nb", [1024, 16384, 1 << 17])
@pytest.mark.parametrize("case", FUSED_ENTRY_CASES)
def test_fused_feasibility_kernel_at_entry_cases(case, nb, cols):
    """K1F on the slot-entry cases the CPU holds to the reference's scan
    step (``tests/test_torch_fused_entry.py``): bit-equal to the plain
    version, with and without the fill's optional column, one node a
    thread and the group staged a copy a warp, at 1,024 to 2^17 nodes."""
    dev = _card()
    shared, groups, carry, g, x_prev = fused_entry_inputs(7, case, nb=nb)
    shared, groups, carry, _ = fused_to_device(shared, groups, carry,
                                               device=dev)
    x = None if x_prev is None else torch.from_numpy(x_prev).to(dev)
    cap, fail = _entry_matches_plain(shared, groups, carry, g, x, cols)
    assert int(fail.sum()) > 0


def _mlp(seed, hidden, dev, negative=False):
    """A seeded learned scorer of ``hidden`` units inside the artifact's
    clamps (``negative``: pre-activations mostly below zero)."""
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    rng = np.random.RandomState(seed)
    w, f = strategy_mod.MLP_W_CLAMP, len(strategy_mod.MLP_FEATURES)
    hi = w // 3 if negative else w + 1

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return (t(rng.randint(-w, hi, (f, hidden))), t(rng.randint(-w, hi,
                                                               hidden)),
            t(rng.randint(-w, w + 1, hidden)), t(rng.randint(-w, w + 1)))


def _entry_strategy(seed, g_count, hidden, dev, negative=False):
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    rng = np.random.RandomState(seed + 1)
    w1, b1, w2, b2 = _mlp(seed, hidden, dev, negative)
    return K.FusedStrategy(
        sid=torch.full((g_count,), 2, dtype=torch.int32, device=dev),
        weights=torch.from_numpy(rng.randint(
            0, strategy_mod.W_CLAMP + 1, (g_count, 4)).astype(np.int32)
        ).to(dev), w1=w1, b1=b1, w2=w2, b2=b2)


#: the scored entry's modes: (strategy id, hidden units, negative MLP)
SCORED_MODES = {
    "spread": (0, 8, False), "weighted": (2, 8, False),
    "learned_h1": (3, 1, False), "learned_h8": (3, 8, False),
    "learned_h64": (3, 64, False), "learned_negative": (3, 8, True),
}


@pytest.mark.parametrize("nb", [1024, 16384, 1 << 20])
@pytest.mark.parametrize("mode", sorted(SCORED_MODES))
@pytest.mark.parametrize("case", FUSED_ENTRY_CASES)
def test_scored_fused_feasibility_kernel_matches_plain(case, mode, nb):
    """The scored K1F (K6's score as the slot entry's epilogue) on the
    slot-entry cases, in spread, weighted and learned mode (hidden 1, 8,
    64; negative pre-activations): capacity, fail counts, svc, the level
    e and the carry bit-equal to the plain version."""
    dev = _card()
    sid, hidden, negative = SCORED_MODES[mode]
    shared, groups, carry, g, x_prev = fused_entry_inputs(
        7, case, nb=nb, n_valid=None if nb < (1 << 20) else nb - 1000)
    shared, groups, carry, _ = fused_to_device(shared, groups, carry,
                                               device=dev)
    strat = _entry_strategy(5 + hidden, groups.k.shape[0], hidden, dev,
                            negative)
    x = None if x_prev is None else torch.from_numpy(x_prev).to(dev)
    launched = _launched(lambda: _entry_matches_plain(
        shared, groups, carry, g, x, strat=strat, sid=sid))
    assert launched == {"fused_feasibility_scored": 1}


@pytest.mark.parametrize("push", ["clamps", "failures"])
def test_scored_fused_feasibility_kernel_at_clamps(push):
    """The scored K1F with svc past SVC_CLAMP and FEAT_CLAMP, headroom at
    HR_CLAMP and 0, or failures at and above MAX_FAILURES and
    FAILURE_CLAMP, weighted with every weight at W_CLAMP and learned."""
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    from swarmkit_tpu_torch.scheduler.nodeinfo import MAX_FAILURES
    dev = _card()
    shared, groups, carry, g, x_prev = fused_entry_inputs(9, "carried_x",
                                                          nb=16384)
    rng = np.random.RandomState(3)
    if push == "clamps":
        svc0 = shared.svc0.copy()
        svc0[:, ::7] = K.SVC_CLAMP + 3
        svc0[:, 3::7] = strategy_mod.FEAT_CLAMP + 1
        shared = shared._replace(svc0=svc0)
        cpu, mem = carry.cpu.copy(), carry.mem.copy()
        cpu[::5] = 5000 * groups.cpu_d[g]
        mem[1::5] = 5000 * groups.mem_d[g]
        cpu[2::5] = 0
        carry = carry._replace(cpu=cpu, mem=mem)
    else:
        failures = groups.failures.copy()
        failures[g] = rng.choice(
            [0, MAX_FAILURES - 1, MAX_FAILURES, MAX_FAILURES + 1,
             K.FAILURE_CLAMP, K.FAILURE_CLAMP + 1, 500], failures.shape[1])
        groups = groups._replace(failures=failures)
    shared, groups, carry, _ = fused_to_device(shared, groups, carry,
                                               device=dev)
    strat = _entry_strategy(11, groups.k.shape[0], 8, dev)
    strat = strat._replace(weights=torch.full_like(strat.weights,
                                                   strategy_mod.W_CLAMP))
    x = torch.from_numpy(x_prev).to(dev)
    for sid in (2, 3):
        _entry_matches_plain(shared, groups, carry, g, x, strat=strat,
                             sid=sid)


def test_scored_fused_entries_twice_without_a_sync():
    """Two scored slots entered back to back on one carry, no sync
    between them (a chunk's weighted then learned slot): each equals the
    plain version's, carry included."""
    dev = _card()
    shared, groups, carry, strat, L = _fused("nb16384", dev)
    n = shared.valid.shape[0]
    s = shared.svc0.shape[0]
    x = torch.randint(0, 6, (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev, dtype=torch.int32)
    a = K.FusedCarry(*(t.clone() for t in carry))
    b = K.FusedCarry(*(t.clone() for t in carry))
    outs, want = [], []
    for g, sid, x_prev in ((2, 2, x), (3, 3, x.flip(0).contiguous())):
        cols = [torch.empty(n, dtype=torch.int32, device=dev)
                for _ in range(3)]
        fail = torch.zeros(K.N_FILTERS, dtype=torch.int32, device=dev)
        K._fused_feasibility(shared, groups, a, g, s, x_prev, fail, cols[0],
                             cols[1], None, strat, sid, cols[2])
        outs.append((cols[0], fail, cols[1], cols[2]))
        p = K._fused_feasibility_plain(shared, groups, b, g, s, x_prev,
                                       strat, sid)
        want.append((p[1], p[2], p[5], p[8]))
    torch.cuda.synchronize()
    for got, w in zip(outs, want):
        for u, v in zip(got, w):
            _eq(u, v)
    for u, v in zip(a, b):
        _eq(u, v)


@pytest.mark.parametrize("nb", [1024, 16384, 1 << 20])
@pytest.mark.parametrize("mode", sorted(SCORED_MODES))
def test_scored_feasibility_kernel_matches_plain(mode, nb):
    """The scored K1 (the per-group strategy route's entry: K6's score as
    its epilogue) against its plain version: mask, capacity, fail counts
    and the level e, one launch."""
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    dev = _card()
    sid, hidden, negative = SCORED_MODES[mode]
    nodes, group, _, _ = plan_inputs(7, nb=nb, n_valid=nb - nb // 10,
                                     n_leaves=1, k=9000, near_2p24=False)
    nodes, group, _ = to_device(nodes, group, (), dev)
    rng = np.random.RandomState(hidden)
    hr = [torch.from_numpy(rng.randint(0, strategy_mod.HR_CLAMP + 1, nb)
                           .astype(np.int32)).to(dev) for _ in range(3)]
    sin = K.StrategyInputs(
        *hr, weights=torch.tensor([3, 15, 0, 7], dtype=torch.int32,
                                  device=dev),
        w1=None, b1=None, w2=None, b2=None)._replace(
        **dict(zip(("w1", "b1", "w2", "b2"),
                   _mlp(hidden, hidden, dev, negative))))
    mask, cap, e = (torch.empty(nb, dtype=t, device=dev)
                    for t in (torch.bool, torch.int32, torch.int32))
    fail = torch.zeros(K.N_FILTERS, dtype=torch.int32, device=dev)
    assert _launched(lambda: K._feasibility_into(
        nodes, group, mask, cap, fail, (sin, sid), e)) == {"feasibility": 1}
    for got, want in zip((mask, cap, fail, e),
                         K._feasibility_plain(nodes, group, (sin, sid))):
        _eq(got, want)


@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_fused_carry_kernel_matches_plain(case):
    dev = _card()
    shared, groups, carry, strat, L = _fused(case, dev)
    n = shared.valid.shape[0]
    s = shared.svc0.shape[0]
    x = torch.randint(0, 7, (n,), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev, dtype=torch.int32)
    a = K.FusedCarry(*(t.clone() for t in carry))
    b = K.FusedCarry(*(t.clone() for t in carry))
    for g in range(groups.k.shape[0]):
        K._fused_carry(groups, a, g, s, x)
        K._fused_carry_plain(groups, b, g, s, x)
    torch.cuda.synchronize()
    for got, want in zip(a, b):
        _eq(got, want)


@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_packfill_kernel_matches_plain(case):
    dev = _card()
    shared, groups, carry, strat, L = _fused(case, dev)
    nodes, grp, _ = _strategy_nodes(shared, groups, carry, 1)
    _, cap, _ = K._feasibility_plain(nodes, grp)
    n = cap.shape[0]
    seg = torch.zeros(n, dtype=torch.int32, device=dev)
    key = K._binpack_key(nodes.res_cap, nodes.failures)
    total = int(cap.sum())
    for k in (0, 1, 777, int(groups.k[1]), total, total + 5):
        kk = torch.tensor([k], dtype=torch.int32, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        got = K._packfill(res_cap=nodes.res_cap, failures=nodes.failures,
                          cap=cap, k=kk, out=out)
        torch.cuda.synchronize()
        _eq(got, K._packfill_plain(key, cap, kk, seg, 1))
    # the general form (any key, any segments) is the plain version only
    with pytest.raises(ValueError):
        K.seg_packfill(key, cap, kk, seg, 1)


def _packfill_cols(case, n, dev, seed=51):
    cols = {c: torch.from_numpy(a).to(dev)
            for c, a in pack_edge_inputs(seed, n, case).items()
            if c in ("res_cap", "failures", "cap", "k")}
    want = K._packfill_plain(
        K._binpack_key(cols["res_cap"], cols["failures"]), cols["cap"],
        cols["k"], torch.zeros(n, dtype=torch.int32, device=dev), 1)
    return cols, want


@pytest.mark.parametrize("n", [1024, 16384, 1 << 17])
@pytest.mark.parametrize("case", PACK_EDGE_CASES)
def test_packfill_kernel_at_edge_cases(case, n):
    """K5's threshold select against the plain bisection on the cases it
    turns on (k = 1, the whole capacity, past it, 0; the failure band;
    one score bin; capacity-0 rows in the threshold's bin; the threshold
    row at n / 2), one launch a call."""
    dev = _card()
    cols, want = _packfill_cols(case, n, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    assert _launched(lambda: K._packfill(out=out, **cols)) \
        == {"packfill": 1}
    torch.cuda.synchronize()
    _eq(out, want)


def test_packfill_twice_without_a_sync():
    """Two K5 fills of different inputs enqueued back to back: each
    equals its plain version."""
    dev = _card()
    n = 16384
    a, want_a = _packfill_cols("half", n, dev, seed=1)
    b, want_b = _packfill_cols("one_bin", n, dev, seed=2)
    out_a = torch.empty(n, dtype=torch.int32, device=dev)
    out_b = torch.empty(n, dtype=torch.int32, device=dev)
    K._packfill(out=out_a, **a)
    K._packfill(out=out_b, **b)
    torch.cuda.synchronize()
    _eq(out_a, want_a)
    _eq(out_b, want_b)


def test_packfill_kernel_past_2p20_rows():
    """Past 2^20 rows the node index runs into the score bits and keys
    repeat: every row at the threshold key takes the remainder, as the
    plain bisection gives it."""
    dev = _card()
    n = (1 << 20) + 16384
    cols, want = _packfill_cols("half", n, dev)
    key = K._binpack_key(cols["res_cap"], cols["failures"])
    assert torch.unique(key).numel() < n
    out = torch.empty(n, dtype=torch.int32, device=dev)
    K._packfill(out=out, **cols)
    torch.cuda.synchronize()
    _eq(out, want)


@pytest.mark.parametrize("mode", ["spread", "weighted", "learned"])
@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_strategy_score_kernel_matches_plain(case, mode):
    dev = _card()
    shared, groups, carry, strat, L = _fused(case, dev)
    nodes, _, sin = _strategy_nodes(shared, groups, carry, 2)
    sin = sin._replace(w1=strat.w1, b1=strat.b1, w2=strat.w2, b2=strat.b2)
    sid = {"spread": 0, "weighted": 2, "learned": 3}[mode]
    got = K.strategy_score(nodes, sin, sid)
    torch.cuda.synchronize()
    _eq(got, K._strategy_score_plain(nodes, sin, sid))


@pytest.mark.parametrize("strategy", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_plan_strategy_on_card_matches_cpu(case, strategy):
    dev = _card()
    bufs = []
    for device in (dev, "cpu"):
        shared, groups, carry, strat, L = _fused(case, device)
        nodes, grp, sin = _strategy_nodes(shared, groups, carry, strategy)
        sin = sin._replace(w1=strat.w1, b1=strat.b1, w2=strat.w2,
                           b2=strat.b2)
        bufs.append(K.plan_strategy_packed(nodes, grp, sin, strategy))
    torch.cuda.synchronize()
    _eq(bufs[0], bufs[1])


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_plan_strategy_counts_launches(strategy):
    """The per-group strategy route: K1 (scored for weighted and learned:
    K6's score in the same launch), then K5 or K3; no K6."""
    dev = _card()
    shared, groups, carry, strat, L = _fused("nb1024", dev)
    nodes, grp, sin = _strategy_nodes(shared, groups, carry, strategy)
    sin = sin._replace(w1=strat.w1, b1=strat.b1, w2=strat.w2, b2=strat.b2)
    fill = "packfill" if strategy == 1 else "waterfill"
    assert _launched(lambda: K.plan_strategy_packed(
        nodes, grp, sin, strategy)) == {"feasibility": 1, fill: 1}


@pytest.mark.parametrize("case", sorted(FUSED_SHAPES))
def test_fused_chunk_on_card_matches_cpu(case):
    dev = _card()
    outs = []
    for device in (dev, "cpu"):
        shared, groups, carry, strat, L = _fused(case, device)
        buf = K.plan_fused_packed(shared, groups, carry, L, strat,
                                  strat.sid.cpu().tolist())
        outs.append((buf, carry))
    torch.cuda.synchronize()
    _eq(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        _eq(a, b)


def test_fused_chunk_counts_launches():
    dev = _card()
    shared, groups, carry, strat, L = _fused("nb1024", dev)
    # slots: spread, binpack, weighted, learned; one slot entry (K1F) a
    # slot and one carry update a chunk, no standalone K1
    # (scored for the weighted and learned slots, which launch no K6)
    assert _launched(lambda: K.plan_fused_packed(
        shared, groups, carry, L, strat, [0, 1, 2, 3])) == {
        "fused_feasibility": 2, "fused_feasibility_scored": 2,
        "fused_carry": 1, "seg_sum": 1, "waterfill": 4, "packfill": 1}


def test_fused_chunks_twice_without_a_sync():
    """Two fused chunks of different inputs, each with its own carry,
    enqueued back to back: each equals the CPU's, carry included."""
    dev = _card()
    runs = []
    for seed in (11, 12):
        shared, groups, carry, strat, L = fused_inputs(seed, nb=4096,
                                                       n_valid=4000)
        sids = strat.sid.tolist()
        card = fused_to_device(shared, groups, carry, strat, device=dev)
        cpu = fused_to_device(shared, groups, carry, strat, device="cpu")
        runs.append((card, cpu, L, sids))
    outs = [K.plan_fused_packed(*card[:3], L, card[3], sids)
            for card, _, L, sids in runs]
    torch.cuda.synchronize()
    for buf, (card, cpu, L, sids) in zip(outs, runs):
        _eq(buf, K.plan_fused_packed(*cpu[:3], L, cpu[3], sids))
        for a, b in zip(card[2], cpu[2]):
            _eq(a, b)


def test_many_service_tick_on_card_matches_host_path():
    _card()
    from collections import Counter

    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.scheduler import Scheduler
    from swarmkit_tpu_torch.workload import many_service_cluster

    def counts(planner):
        store, services, nodes, _ = many_service_cluster(300, 3000)
        sched = Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        sched.tick()
        name = {s.id: s.spec.annotations.name for s in services}
        host = {n.id: n.description.hostname for n in nodes}
        return Counter((name[t.service_id], host[t.node_id])
                       for t in store.view(lambda tx: tx.find(Task))
                       if t.node_id)

    planner = TorchPlanner()
    got = counts(planner)
    assert got == counts(None)
    assert sum(got.values()) == 3000
    assert planner.stats["groups_fused"] == 10
    assert planner.stats["tasks_planned"] == 3000


def test_planner_tick_on_card_matches_host_path():
    _card()
    from collections import Counter

    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.workload import build_cluster, one_tick, \
        rack_spread

    def counts(planner):
        store, _, nodes, _ = build_cluster(300, 3000, prefs=rack_spread(),
                                           global_share=0.2)
        one_tick(store, planner)
        host = {n.id: n.description.hostname for n in nodes}
        return Counter(host[t.node_id] for t in store.view(
            lambda tx: tx.find(Task)) if t.node_id)

    planner = TorchPlanner()
    assert counts(planner) == counts(None)
    assert planner.stats["tasks_planned"] == 3000


# ----------------------------------------------------------------- K7, K8

SCATTER_SHAPES = {"d13_of_16": (1024, 13, 16), "d16_of_16": (16384, 16, 16),
                  "d200_of_256": (16384, 200, 256),
                  "d3000_of_4096": (16384, 3000, 4096)}


@pytest.mark.parametrize("case", sorted(SCATTER_SHAPES))
def test_scatter_rows_kernel_matches_plain(case):
    dev = _card()
    nb, d, db = SCATTER_SHAPES[case]
    cols_np, packed_np = scatter_inputs(3, nb=nb, d=d, db=db)
    got = [torch.from_numpy(c).to(dev) for c in cols_np]
    K.scatter_rows(got, torch.from_numpy(packed_np).to(dev))
    torch.cuda.synchronize()
    want = [torch.from_numpy(c.copy()) for c in cols_np]
    K.scatter_rows(want, torch.from_numpy(packed_np))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(SCATTER_SHAPES))
def test_scatter_table_kernel_matches_plain(case, shards):
    """K7 over a table of ``shards`` shards on the card (global indices,
    pads at nb) equals its plain version on CPU shards, in ONE launch."""
    dev = _card()
    nb, d, db = SCATTER_SHAPES[case]
    cols_np, packed_np = scatter_inputs(9 + shards, nb=nb, d=d, db=db)
    got = split_columns(cols_np, shards, dev)
    packed = torch.from_numpy(packed_np).to(dev)
    assert _launched(lambda: K.scatter_rows(got, packed)) \
        == {"scatter_rows": 1}
    want = split_columns(cols_np, shards, "cpu")
    K.scatter_rows(want, torch.from_numpy(packed_np))
    for g, w in zip(got, want):
        _eq(torch.cat(g), torch.cat(w))


# K8 at the shapes the paths give it: 512, the gang fleet's node bucket
# (1,024) and the headline's 16,384; G = 1, 2 and 8, with and without the
# quota column
GANG_SHAPES = {f"n{nb}_g{g}{'_quota' if q else ''}":
               dict(g_count=g, nb=nb, n_valid=nb * 3 // 4, quota=q)
               for nb in (512, 1024, 16384) for g in (1, 2, 8)
               for q in (False, True)}
GANG_SHAPES.update({"g1_quota": dict(g_count=1, quota=True),
                    "g1": dict(g_count=1),
                    "g3_small": dict(g_count=3, nb=1024, n_valid=1000),
                    "g8": dict(g_count=8)})


def _gang_matches_plain(rows):
    dev = torch.device("cuda")
    g = len(rows)
    got = K.unpack_gang(K.gang_fit_packed(*gang_to_device(rows, dev)), g)
    torch.cuda.synchronize()
    want = K.unpack_gang(K.gang_fit_packed(*gang_to_device(rows, "cpu")), g)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("case", sorted(GANG_SHAPES))
def test_gang_fit_kernel_matches_plain(case):
    _card()
    _gang_matches_plain(gang_rows(41, **GANG_SHAPES[case]))


@pytest.mark.parametrize("end", ["least", "most"])
@pytest.mark.parametrize("g", [1, 3, 8, 300])
def test_gang_fit_kernel_at_every_block_count(g, end):
    """Every count of blocks a gang the launch picks for G gangs, at the
    least and the most node count (up to 2^17) that picks it, twice: the
    workspace words that join a gang's blocks are back at zero for the next
    launch.  G = 300 takes one block a gang and loops over its nodes."""
    _card()
    sizes = range(32, (1 << 17) + 1, 32)
    counts = {}
    for n in sizes:
        counts.setdefault(K.gang_fit_blocks(n, g), []).append(n)
    for blocks, picks in sorted(counts.items()):
        n = picks[0] if end == "least" else picks[-1]
        n = min(n, 1024) if g == 300 else n
        rows = gang_rows(60 + blocks, g, nb=n, n_valid=n - 5,
                         quota=blocks % 2 == 1)
        for _ in range(2):
            _gang_matches_plain(rows)


def test_gang_verdict_is_one_copy_each_way_and_one_kernel():
    """A planner verdict on the packed stage is one H2D, one K8 and one
    D2H on the device: no fill, no other copy, at the gang fleet's bucket
    and at the headline's (a gang's blocks meeting in the workspace, made
    zeroed once and left at zero)."""
    _card()
    from chip_smoke import profiled
    from swarmkit_tpu_torch.ops import TorchPlanner
    planner = TorchPlanner()
    for g, nb in ((1, 1024), (2, 1024), (1, 16384), (8, 16384)):
        rows = gang_rows(70 + g, g, nb=nb, n_valid=400)
        planner._gang_fit_rows(rows, "warm")
        rows_dev, _ = profiled(torch, lambda: planner._gang_fit_rows(
            rows, "probe"))
        names = sorted(name for name, _ in rows_dev)
        assert len(names) == 3, names
        assert sum("HtoD" in x for x in names) == 1, names
        assert sum("DtoH" in x for x in names) == 1, names
        assert sum("gang_fit_kernel" in x for x in names) == 1, names


def test_resident_kernels_count_launches():
    dev = _card()
    cols_np, packed_np = scatter_inputs(5, nb=1024, d=10, db=16)
    cols = [torch.from_numpy(c).to(dev) for c in cols_np]
    packed = torch.from_numpy(packed_np).to(dev)
    assert _launched(lambda: K.scatter_rows(cols, packed)) \
        == {"scatter_rows": 1}
    nodes, groups = gang_to_device(gang_rows(6, 3, nb=1024, n_valid=1000),
                                   dev)
    assert _launched(lambda: K.gang_fit_packed(nodes, groups)) \
        == {"gang_fit": 1}


def test_resident_state_refreshes_on_card():
    """Back-to-back refreshes reuse one pinned staging buffer per bucket;
    each must wait for the previous copy out of it, so the CUDA columns
    equal the host mirror after every refresh."""
    _card()
    from swarmkit_tpu_torch.ops.planner import TorchPlanner
    from swarmkit_tpu_torch.ops.streaming import ResidentState
    from swarmkit_tpu_torch.workload import steady_state_churn
    wl = steady_state_churn(1024, 600, 1)
    sched = wl.attach(None)
    st = ResidentState(TorchPlanner(device="cpu")._node_value, "cuda")
    st.refresh(sched)
    rng = np.random.RandomState(9)
    for step in range(30):
        for nid in rng.choice(sorted(sched.node_set.nodes), 40,
                              replace=False):
            info = sched.node_set.nodes[nid]
            info.available_resources.nano_cpus -= int(rng.randint(1, 99))
            info.active_tasks_count += 1
            sched.delta.mark(nid)
        st.refresh(sched)
        assert st.device_carry() is not None
        torch.cuda.synchronize()
        for d, h in zip(st.dev, st._host_cols()):
            np.testing.assert_array_equal(d.cpu().numpy(), h,
                                          err_msg=str(step))
    wl.close()


def test_churn_on_card_matches_cpu():
    _card()
    import hashlib

    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.workload import steady_state_churn

    def run(device, streaming):
        wl = steady_state_churn(1024, 1500, 6)
        wl.script.append(({"cb": 20, "cd": 20, "cf": 20}, 9))
        planner = TorchPlanner(device=device)
        planner.streaming_enabled = streaming
        wl.attach(planner).tick()
        for arrivals, exits in wl.script:
            wl.window(arrivals, exits)
        wl.close()
        digest = hashlib.sha256(repr(wl.placements()).encode()).digest()
        return digest, planner

    card, planner = run("cuda", True)
    assert card == run("cpu", True)[0] == run("cuda", False)[0]
    assert planner.stats["streaming_device_carries"] >= 1
    assert planner.streaming_snapshot()["incremental_ticks"] >= 7


def test_gang_fleet_on_card_matches_host_path():
    _card()
    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.scheduler import Scheduler
    from swarmkit_tpu_torch.workload import gang_fleet

    def run(planner):
        store, _, _, tasks = gang_fleet()
        sched = Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        sched.tick()
        placed = {t.id: t.node_id for t in store.view(
            lambda tx: tx.find(Task))}
        return [placed[t.id] for t in tasks], sched

    planner = TorchPlanner()
    card, sched = run(planner)
    assert card == run(None)[0]
    assert all(card)
    assert sched.gang.stats["gangs_admitted"] == 72
    assert planner.stats["gang_fit_device"] + \
        planner.stats["gang_fit_fused"] == 80


# ----------------------------------------------------------------- K9

VICTIM_SHAPES = {f"v{v}_{case}": (v, case, 3000)
                 for v in (4, 16, 64) for case in VICTIM_CASES}
VICTIM_SHAPES["v16_full_headline"] = (16, "full", 10000)


@pytest.mark.parametrize("case", sorted(VICTIM_SHAPES))
def test_select_victims_kernel_matches_plain(case):
    dev = _card()
    v, kind, n = VICTIM_SHAPES[case]
    cand, args = victim_inputs(70 + v, v, kind, n=n)
    pb = P.pick_bucket(args[3])
    nb = n_bucket(n)
    got = P.select_victims(victims_to_device(cand, nb, dev), *args, pb)
    torch.cuda.synchronize()
    want = P.select_victims(victims_to_device(cand, nb, "cpu"), *args, pb)
    _eq(got, want)
    picks = int((want[:pb] >= 0).sum())
    assert (picks == args[3]) == (kind == "full"), (picks, args[3])


@pytest.mark.parametrize("n", [1000, 10000, 1 << 17])
@pytest.mark.parametrize("case", VICTIM_CASES)
@pytest.mark.parametrize("v", [4, 16, 64])
def test_select_victims_kernel_at_node_buckets(v, case, n):
    """K9 at node buckets 1,024, 16,384 and 2^17 (its tree's leaves in
    shared memory up to 16,384 nodes, in global memory past that) with
    512 picks, against its plain version on the same CUDA tensors."""
    dev = _card()
    cand, args = victim_inputs(500 + v, v, case, n=n)
    pb = P.pick_bucket(args[3])
    inp = victims_to_device(cand, n_bucket(n), dev)
    got = P.select_victims(inp, *args, pb)
    torch.cuda.synchronize()
    _eq(got, P._select_victims_plain(inp, *args, pb))


def test_select_victims_kernel_at_max_nodes():
    """K9 at its largest node bucket, 2^20 (the tree's first two levels in
    global memory), against its plain version."""
    dev = _card()
    n = P.MAX_NODES
    cand, args = victim_inputs(77, 16, "full", n=n, picks=128)
    pb = P.pick_bucket(args[3])
    inp = victims_to_device(cand, n_bucket(n), dev)
    got = P.select_victims(inp, *args, pb)
    torch.cuda.synchronize()
    _eq(got, P._select_victims_plain(inp, *args, pb))
    assert int((got[:pb] >= 0).sum()) == 128


@pytest.mark.parametrize("n", [600, 1 << 17])
@pytest.mark.parametrize("case", VICTIM_EDGE_CASES)
def test_select_victims_kernel_at_edge_cases(case, n):
    """K9 on the cases its pick order turns on (equal keys, a node
    infeasible after its pick, a node picked again, budget and infeasible
    stops at V = 64, free pools below zero) against its plain version."""
    dev = _card()
    cand, args = victim_edge_inputs(case, n=n, picks=64)
    inp = victims_to_device(cand, n_bucket(n), dev)
    got = P.select_victims(inp, *args, 64)
    torch.cuda.synchronize()
    _eq(got, P._select_victims_plain(inp, *args, 64))


def test_select_victims_counts_launches():
    dev = _card()
    cand, args = victim_inputs(3, 4, "full", n=500, picks=8)
    inp = victims_to_device(cand, 1024, dev)
    assert _launched(lambda: P.select_victims(inp, *args, 8)) \
        == {"select_victims": 1}


def test_planner_preemption_tick_on_card_matches_host_path():
    """Config 8 at 64 nodes (negative free pools, V = 64, a budget stop)
    on the card: the same store rows as the plain versions on the CPU and
    as the host path, with K9's picks."""
    _card()
    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.workload import preempt_tick, priority_jobs

    def run(planner):
        store, _, _, _ = priority_jobs(64)
        preempt_tick(store, planner, 512)
        return sorted((t.id, t.node_id, int(t.status.state),
                       int(t.desired_state))
                      for t in store.view(lambda tx: tx.find(Task)))

    before = P.VICTIMS.launches
    card = run(TorchPlanner())
    assert P.VICTIMS.launches > before
    assert card == run(TorchPlanner(device="cpu")) == run(None)


# ------------------------------------------- the node-axis split: K10, K11

def _fill(parts, L, pack):
    if pack:
        K._shard_packfill(parts)
    else:
        K._shard_waterfill(parts, L)
    torch.cuda.synchronize()
    return torch.cat([p.out for p in parts])


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(SHARD_FILL_CASES))
def test_shard_fill_kernels_match_plain(case, shards):
    """K10 and K11 on ``shards`` shards of one card against their plain
    versions on the same CUDA tensors, and against the one-shard fill."""
    dev = _card()
    kw = SHARD_FILL_CASES[case]
    arrs = shard_fill_inputs(4, **kw)
    parts = fill_parts(arrs, shards, dev)
    got = _fill(parts, kw["L"], arrs["pack"])
    plain = K._shard_packfill_plain(parts) if arrs["pack"] \
        else K._shard_waterfill_plain(parts, kw["L"])
    _eq(got, torch.cat(plain))
    _eq(got, _fill(fill_parts(arrs, 1, dev), kw["L"], arrs["pack"]))


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
def test_shard_waterfill_kernel_at_headline_shape(shards):
    """K10 at the shape the mesh headline path gives it (the leaf fill of
    a headline group, nb 16384, L = 256, 20 live racks) against its plain
    version on the same CUDA tensors, and against the one-shard fill."""
    dev = _card()
    parts, L = headline_fill_parts(shards, dev)
    got = _fill(parts, L, False)
    _eq(got, torch.cat(K._shard_waterfill_plain(parts, L)))
    assert int(got.to(torch.int64).sum()) == 80000
    one, _ = headline_fill_parts(1, dev)
    _eq(got, _fill(one, L, False))


EDGE_FILLS = {
    "L1": dict(n=16384, L=1),
    "L20": dict(n=16384, L=20),
    "L20_level": dict(n=16384, L=20, scored=True),
    "L8200": dict(n=16400, L=8200),
}


@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(EDGE_FILLS))
def test_shard_waterfill_kernel_at_edge_cases(case, shards):
    """K10 where a segment lies inside one shard and another spreads over
    all, equal levels meet at every shard border, and L passes 8,192,
    against its plain version on the same CUDA tensors."""
    dev = _card()
    kw = EDGE_FILLS[case]
    parts = fill_parts(edge_fill_inputs(43, **kw), shards, dev)
    got = _fill(parts, kw["L"], False)
    _eq(got, torch.cat(K._shard_waterfill_plain(parts, kw["L"])))


@pytest.mark.parametrize("n", [1024, 12000, 16384, 1 << 17])
@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", PACK_EDGE_CASES)
def test_shard_packfill_kernel_at_edge_cases(case, shards, n):
    """K11 over ``shards`` shards of n rows in all on K5's edge cases
    (the threshold row on a shard border among them; 12,000 rows give
    shards of a size that is not a power of two) against its plain
    version on the same CUDA tensors and against K5 on the whole
    columns, one launch a fill."""
    dev = _card()
    arrs = pack_edge_inputs(53, n, case)
    parts = fill_parts(arrs, shards, dev)
    assert _launched(lambda: K._shard_packfill(parts)) \
        == {"shard_packfill": 1}
    got = _fill(parts, 1, True)
    _eq(got, torch.cat(K._shard_packfill_plain(parts)))
    cols, want = _packfill_cols(case, n, dev, seed=53)
    _eq(got, want)


def test_shard_packfill_twice_without_a_sync():
    """Two K11 fills of different inputs enqueued back to back: each
    equals its plain version."""
    dev = _card()
    first = fill_parts(pack_edge_inputs(23, 16384, "half"), 4, dev)
    second = fill_parts(shard_fill_inputs(24, nb=16384, n_valid=15000,
                                          L=1, pack=True), 4, dev)
    K._shard_packfill(first)
    K._shard_packfill(second)
    torch.cuda.synchronize()
    for parts in (first, second):
        _eq(torch.cat([p.out for p in parts]),
            torch.cat(K._shard_packfill_plain(parts)))


def test_shard_packfill_kernel_past_2p20_rows():
    """K11 over 16 shards of 66,560 rows (global indices past 2^20, keys
    repeat) against its plain version."""
    dev = _card()
    n = 16 * 66560
    arrs = pack_edge_inputs(29, n, "half")
    parts = fill_parts(arrs, 16, dev)
    got = _fill(parts, 1, True)
    _eq(got, torch.cat(K._shard_packfill_plain(parts)))


@pytest.mark.parametrize("L", [256, 32768])
def test_shard_waterfill_twice_without_a_sync(L):
    """Two K10 fills of different inputs enqueued back to back, as the
    fused route's in-flight chunks are: each equals its plain version
    (nothing of one fill's scratch leaks into the next)."""
    dev = _card()
    first = fill_parts(shard_fill_inputs(21, nb=16384, n_valid=16000, L=L),
                       4, dev)
    second = fill_parts(shard_fill_inputs(22, nb=16384, n_valid=15000,
                                          L=L), 4, dev)
    K._shard_waterfill(first, L)
    K._shard_waterfill(second, L)
    torch.cuda.synchronize()
    for parts in (first, second):
        _eq(torch.cat([p.out for p in parts]),
            torch.cat(K._shard_waterfill_plain(parts, L)))


def test_shard_fill_kernels_count_launches():
    dev = _card()
    arrs = shard_fill_inputs(5, nb=4096, n_valid=4000, L=3)
    parts = fill_parts(arrs, 4, dev)
    assert _launched(lambda: K._shard_waterfill(parts, 3)) \
        == {"shard_waterfill": 1}
    arrs = shard_fill_inputs(5, nb=4096, n_valid=4000, L=1, pack=True)
    parts = fill_parts(arrs, 4, dev)
    assert _launched(lambda: K._shard_packfill(parts)) \
        == {"shard_packfill": 1}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", ["headline", "headline_two_level",
                                  "small_flat", "filters_all"])
def test_plan_group_sharded_on_card_matches_cpu(case, shards):
    """The sharded spread plan (K1 per shard; per stage-A level one K2
    over the shard table and one K3 fill; K10) on a ``shards``-shard mesh
    of one card equals the CPU mesh's and the unsharded plan's
    placements, fail counts and spill (shard 0's)."""
    _card()
    from swarmkit_tpu_torch.parallel import sharded as S
    nodes, group, L, hier = plan_inputs(7, **SHAPES[case])
    n = nodes.valid.shape[0]
    card = S.make_mesh(["cuda:0"] * shards)
    got = K.finish_fetch(S.ShardedPlanFn(card)(nodes, group, L, hier))
    cpu = K.finish_fetch(S.ShardedPlanFn(S.make_mesh(["cpu"] * shards))(
        nodes, group, L, hier))
    np.testing.assert_array_equal(got, cpu)
    cn, cg, ch = to_device(nodes, group, hier, "cpu")
    np.testing.assert_array_equal(got, K.plan_group_packed(cn, cg, L, ch)
                                  .numpy()[:n + K.N_FILTERS + 1])
    launched = _launched(lambda: S.ShardedPlanFn(card)(nodes, group, L,
                                                       hier))
    levels = 2 if hier else 1
    assert launched["shard_waterfill"] == 1
    assert launched["shard_seg_sum"] == levels
    assert "seg_sum" not in launched
    # stage A's fills once a card: one K3 a level with several values
    assert launched.get("waterfill", 0) == (0 if L == 1 and not hier
                                            else levels)


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_plan_strategy_sharded_on_card_matches_cpu(strategy):
    """The sharded strategy plan (per shard K1, scored for weighted and
    learned; K11 or K10) on four shards of the card equals the CPU
    mesh's, with no K6 launch."""
    _card()
    from swarmkit_tpu_torch.parallel import sharded as S
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    nodes, group, _, _ = plan_inputs(3, nb=4096, n_valid=4000, n_leaves=1,
                                     k=9000, near_2p24=False)
    rng = np.random.RandomState(strategy)
    w1, b1, w2, b2 = strategy_mod.learned_params()
    sin = K.StrategyInputs(
        hr_cpu=rng.randint(0, 1024, 4096).astype(np.int32),
        hr_mem=rng.randint(0, 1024, 4096).astype(np.int32),
        hr_gen=np.full(4096, 1023, np.int32),
        weights=np.array([2, 3, 1, 1], np.int32), w1=w1, b1=b1, w2=w2,
        b2=np.asarray(b2, np.int32))
    launched = _launched(lambda: S.plan_strategy_sharded(
        nodes, group, sin, strategy, S.make_mesh(["cuda:0"] * 4)))
    assert launched == {"feasibility": 4, "shard_packfill" if strategy == 1
                        else "shard_waterfill": 1}
    on_card = S.plan_strategy_sharded(nodes, group, sin, strategy,
                                      S.make_mesh(["cuda:0"] * 4))
    on_cpu = S.plan_strategy_sharded(nodes, group, sin, strategy,
                                     S.make_mesh(["cpu"] * 4))
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plan_fused_sharded_on_card_matches_cpu():
    """A mixed-strategy fused chunk split over four shards of the card
    equals the CPU mesh's, carry included."""
    _card()
    from swarmkit_tpu_torch.parallel import sharded as S
    shared, groups, carry, strat, L = fused_inputs(11, nb=4096,
                                                   n_valid=4000)
    sids = [int(v) for v in strat.sid]
    got = S.plan_fused_sharded(shared, groups, carry, L,
                               S.make_mesh(["cuda:0"] * 4), strat, sids)
    want = S.plan_fused_sharded(shared, groups, carry, L,
                                S.make_mesh(["cpu"] * 4), strat, sids)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got[3], want[3]):
        for u, v in zip(a, b):
            _eq(u, v)


def test_mesh_churn_on_card_matches_unsharded():
    """The churn with the resident tier split over four shards of the card
    places exactly as the unsharded planner, scattering per shard."""
    _card()
    import hashlib

    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.parallel import make_mesh
    from swarmkit_tpu_torch.workload import steady_state_churn

    def run(mesh):
        wl = steady_state_churn(1024, 1500, 6)
        wl.script.append(({"cb": 20, "cd": 20, "cf": 20}, 9))
        planner = TorchPlanner(mesh=mesh)
        wl.attach(planner).tick()
        for arrivals, exits in wl.script:
            wl.window(arrivals, exits)
        wl.close()
        digest = hashlib.sha256(repr(wl.placements()).encode()).digest()
        return digest, planner

    sharded, planner = run(make_mesh(["cuda:0"] * 4))
    assert sharded == run(None)[0]
    snap = planner.streaming_snapshot()
    assert snap["mesh_devices"] == 4 and snap["shard_syncs"] >= 1, snap
    assert planner.stats["streaming_device_carries"] >= 1


def test_service_life_on_card_matches_cpu():
    """Phase 22's script at 1,000 nodes (``chip_smoke.LIFE_PARITY``:
    create, drain, rollout through ``workload.ControlLoops``) on the card
    and through the CPU plain path, with fixed ids: every task on the same
    node in the same state after each stage, and the card's planner took
    every group (the autouse fixture holds the device-fault counters)."""
    _card()
    import chip_smoke as cs
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.models import Service, Task, TaskState, types
    from swarmkit_tpu_torch.obs import tracer
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.utils import identity

    def run(device):
        planner = TorchPlanner(device=device)
        cs.fixed_ids(identity)
        try:
            store, services, nodes, stages = cs.service_life(
                workload, types, Task, TaskState, Service, planner, tracer,
                cs.LIFE_PARITY, sync=torch.cuda.synchronize)
        finally:
            identity.set_id_source(None)
        cs.check_life(device, store, services, nodes, stages,
                      cs.LIFE_PARITY, Task, TaskState)
        return {s: sorted((t.id, t.node_id, int(t.status.state))
                          for t in stages[s]["created"])
                for s in cs.LIFE_STAGES}, stages

    card, stages = run("cuda")
    cpu, _ = run("cpu")
    for s in cs.LIFE_STAGES:
        assert card[s] == cpu[s], f"{s}: the card places unlike the CPU"
        assert stages[s]["span_counts"]["sched.host_fallback"] == 0


def test_live_manager_on_card_matches_cpu():
    """Config 6's shape at 1,024 nodes x 2 services x 8,192 tasks through
    ``workload.live_manager`` (one pipelined tick through a single-voter
    ``RaftNode`` with a sealed WAL) on the card and through the CPU plain
    path: equal placements by creation index, both groups fused, raft
    entries applied, and K1F and K4's carry launched on the card."""
    _card()
    import chip_smoke as cs
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner, cuda

    def run(device):
        store, _, nodes, tasks = workload.live_cluster(1024, 16384)
        cuda.reset_launch_counts(K.KERNELS)
        out = workload.live_manager(store, TorchPlanner(device=device),
                                    nodes=nodes)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = cuda.launch_counts(K.KERNELS)
        return cs.placements(store, Task, tasks, nodes), out, launches

    card, out, launches = run("cuda")
    cpu, cpu_out, _ = run("cpu")
    assert card == cpu
    assert out["groups_fused"] == cpu_out["groups_fused"] == 2
    assert out["raft_entries_applied"] >= 2
    assert out["native_commit"]["fallbacks"] == 0
    assert launches[K.FUSED_FEASIBILITY.name] > 0
    assert launches[K.FUSED_CARRY.name] > 0


def test_replicated_control_on_card_matches_cpu():
    """Phase 25's script (``chip_smoke.control_script``: three raft
    members, services made through the leader's ``ControlAPI``, a
    failover, a leader deposed inside a pipelined tick, a restart from
    WALs and snapshots) at 40 nodes on the card and through the CPU plain
    path, with fixed ids: every live task on the same node in the same
    state after the create, the scale-up and the restart, and card memory
    grown by at most one resident state a leadership change."""
    _card()
    import chip_smoke as cs
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.utils import identity

    shape = dict(cs.CONTROL, n_nodes=40, snapshot_interval=8,
                 fence_tasks=200)
    card = cs.run_control(workload, identity,
                          lambda: TorchPlanner(device="cuda"), shape,
                          memory=torch.cuda.memory_allocated)
    cpu = cs.run_control(workload, identity,
                         lambda: TorchPlanner(device="cpu"), shape)
    cs.check_control_memory(card, "replicated control, 40 nodes")
    for stage in cs.CONTROL_STAGES:
        assert card["rows"][stage] == cpu["rows"][stage], stage
