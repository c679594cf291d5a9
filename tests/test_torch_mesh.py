"""The port's node-axis split on the CPU, against the reference's.

The port's ``plan_group_sharded``, ``plan_strategy_sharded`` (binpack,
weighted, learned) and ``plan_fused_sharded`` run on
``make_mesh(["cpu"] * D)`` for D in {2, 4, 8}; the reference's
``ShardedPlanFn`` runs on the first D of the eight virtual CPU devices
that ``tests/conftest.py`` sets up.  Inputs come from numpy with a seed
and go to both.  Every output is an integer, so every comparison is
bit-equal: placements, fail counts, spill and the fused carry.  Cases:
flat and two-level spread trees, a node count that no D divides (the
per-group and strategy routes pad it), equally loaded nodes on both sides
of every shard border (the global tie key decides), and capacity and load
totals near 2^24, which are held against the port's unsharded plans only
(the reference sums in float32 there; see ROADMAP queue C).

What crosses shards is held in ``test_torch_mesh_exchange.py``.

The reference is called as it stands.  jax 0.9 renamed ``shard_map``'s
``check_rep`` to ``check_vma`` and moved ``jax.experimental.enable_x64``;
the fixture below passes ``check_rep`` on as ``check_vma`` through a
wrapper around ``swarmkit_tpu.parallel.sharded.shard_map`` and aliases
``enable_x64``, each only where the running jax lacks the name and only
for the test (``monkeypatch``).  No file of the reference changes.
"""

import importlib
import inspect
import types

import numpy as np
import pytest
import torch

from chip_smoke import (
    SHARD_FILL_CASES, fill_parts, fused_inputs, headline_fill_parts,
    plan_inputs, shard_fill_inputs)
from swarmkit_tpu_torch.ops import kernel as K
from swarmkit_tpu_torch.ops.convert import (
    fused_to_device, named_to_device, to_device)
from swarmkit_tpu_torch.ops.densify import l_bucket
from swarmkit_tpu_torch.parallel import sharded as S
from swarmkit_tpu_torch.scheduler import strategy as strategy_mod

MESHES = (2, 4, 8)


@pytest.fixture
def ref(monkeypatch):
    """The reference's kernel and sharded modules, importable and callable
    on this jax: ``enable_x64`` aliased and ``shard_map(check_rep=)``
    passed on as ``check_vma``, where the running jax lacks them."""
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
    return types.SimpleNamespace(
        jax=jax, sharded=sharded,
        kernel=importlib.import_module("swarmkit_tpu.ops.kernel"),
        mesh=lambda d: sharded.make_mesh(jax.devices()[:d]))


def as_ref(obj, cls):
    """A port NamedTuple of numpy arrays as the reference's type (same
    fields, same order): the reference's shard_map specs match by type."""
    return None if obj is None else cls(*obj)


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _trim(plan, n):
    """The reference's sharded (x, fail_counts, spill) with x cut to the
    unpadded node count (its padded rows place nothing)."""
    x = np.asarray(plan[0])
    assert not x[n:].any()
    return (x[:n],) + tuple(plan[1:])


def _same(got, want, what=""):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=what)


# ------------------------------------------------------------ input maker

def group_inputs(seed, n=256, n_valid=None, L=1, levels=1, k=300,
                 border_ties=True, big=False):
    """Seeded numpy (NodeInputs, GroupInputs, L, hier) in the reference's
    layout: ``L`` leaf buckets over six racks (or one), an upper level of
    two branches with ``levels=2``, equal loads and totals around every
    shard border of every mesh size, and with ``big`` branch totals past
    2^24 (loads of SVC_CLAMP, capacities of K_CLAMP)."""
    rng = np.random.RandomState(seed)
    n_valid = n - 5 if n_valid is None else n_valid
    valid = np.arange(n) < n_valid
    svc = rng.randint(0, 4, n).astype(np.int32)
    total = rng.randint(0, 40, n).astype(np.int32)
    res_cap = rng.randint(0, 30, n).astype(np.int32)
    racks = 6 if L > 1 else 1
    leaf = rng.randint(0, racks, n).astype(np.int32)
    if border_ties:
        for frac in range(1, 8):
            b = n * frac // 8
            svc[b - 6:b + 6], total[b - 6:b + 6] = 1, 7
            res_cap[b - 6:b + 6] = 9
    if big:
        svc[:24] = K.SVC_CLAMP
        res_cap[30:36] = K.K_CLAMP
    nodes = K.NodeInputs(
        valid=valid, ready=rng.rand(n) < 0.95, res_ok=rng.rand(n) < 0.95,
        res_cap=res_cap, svc_tasks=svc, total_tasks=total,
        failures=rng.choice([0, 0, 0, 1, 5, 70], n).astype(np.int32),
        leaf=leaf, os_hash=rng.randint(0, 2, (2, n)).astype(np.int32),
        arch_hash=rng.randint(0, 2, (2, n)).astype(np.int32),
        port_conflict=rng.rand(n) < 0.05, extra_mask=rng.rand(n) < 0.97,
        quota_ok=None)
    con_hash = np.zeros((2, 2, n), np.int32)
    con_hash[0] = rng.randint(0, 3, (2, n))
    group = K.GroupInputs(
        k=np.int32(k), con_hash=con_hash,
        con_op=np.array([1, 2], np.int32),
        con_exp=np.array([[1, 1], [0, 0]], np.int32),
        plat=np.array([[0, 0, 0, 0], [1, 1, 0, 0]], np.int32),
        maxrep=np.int32(0), port_limited=np.bool_(False))
    hier = ()
    if levels == 2:
        top = (leaf % 2).astype(np.int32)
        leaf_parent = np.zeros(L, np.int32)
        leaf_parent[:racks] = np.arange(racks) % 2
        hier = (((top, np.zeros(l_bucket(2), np.int32)),), leaf_parent)
    return nodes, group, L, hier


GROUP_CASES = {
    "flat": dict(),
    "racks": dict(L=16, k=900),
    "two_level": dict(L=16, levels=2, k=700),
    "ragged_n": dict(n=251, L=16, k=500),
    "no_border_ties": dict(L=16, k=400, border_ties=False),
    "short_of_capacity": dict(L=16, k=50000),
}


def strategy_inputs(seed, n):
    rng = np.random.RandomState(seed)
    w1, b1, w2, b2 = strategy_mod.learned_params()
    return K.StrategyInputs(
        hr_cpu=rng.randint(0, 1024, n).astype(np.int32),
        hr_mem=rng.randint(0, 1024, n).astype(np.int32),
        hr_gen=np.full(n, 1023, np.int32),
        weights=np.array([2, 3, 1, 1], np.int32), w1=w1, b1=b1, w2=w2,
        b2=np.asarray(b2, np.int32))


def _unsharded_group(nodes, group, L, hier):
    return K.plan_group(*to_device(nodes, group, hier, "cpu")[:2], L,
                        to_device(nodes, group, hier, "cpu")[2])


# ---------------------------------------------- per-group spread (B12)

@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_mesh_plan_group_matches_reference(ref, case, d):
    nodes, group, L, hier = group_inputs(d * 7 + len(case),
                                         **GROUP_CASES[case])
    got = S.plan_group_sharded(nodes, group, L, S.make_mesh(["cpu"] * d),
                               hier)
    want = _trim(ref.sharded.ShardedPlanFn(ref.mesh(d))(
        as_ref(nodes, ref.kernel.NodeInputs),
        as_ref(group, ref.kernel.GroupInputs), L, hier),
        nodes.valid.shape[0])
    _same(got, want, f"{case} D={d} vs reference")
    _same(got, _unsharded_group(nodes, group, L, hier),
          f"{case} D={d} vs unsharded")
    assert int(np.asarray(got[0]).sum()) > 0


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("levels", [1, 2])
def test_mesh_plan_group_near_2p24_matches_unsharded(d, levels):
    """Branch loads and capacities past 2^24 (where the reference's
    float32 sums stop being exact): the split equals the unsharded
    plan."""
    nodes, group, L, hier = group_inputs(40 + d, n=512, L=16, levels=levels,
                                         k=K.K_CLAMP - 1, big=True)
    got = S.plan_group_sharded(nodes, group, L, S.make_mesh(["cpu"] * d),
                               hier)
    _same(got, _unsharded_group(nodes, group, L, hier))
    nodes, group, L, hier = plan_inputs(9, nb=1024, n_valid=1000,
                                        n_leaves=8, n_top=2 if levels == 2
                                        else 0, k=K.K_CLAMP - 1)
    got = S.plan_group_sharded(nodes, group, L, S.make_mesh(["cpu"] * d),
                               hier)
    _same(got, _unsharded_group(nodes, group, L, hier))


def _tpu_kernel_case(seed, n, nb, k, two_level):
    """The inputs of the reference's ``tests/test_tpu_kernel.py:312``
    (flat, 100 of 128 nodes, k = 57) and ``:417`` (dc -> rack, 96 of 128
    nodes, k = 41)."""
    rng = np.random.RandomState(seed)
    valid = np.zeros(nb, bool)
    valid[:n] = True
    cpu = np.zeros(nb, np.int64)
    leaf = np.zeros(nb, np.int32)
    hier, L = (), 1
    if two_level:
        cpu[:n] = rng.randint(2, 9, n) * 10**9
        dc = np.zeros(nb, np.int32)
        dc[:n] = rng.randint(0, 2, n)
        leaf[:n] = dc[:n] * 3 + rng.randint(0, 3, n)
        leaf_parent = np.zeros(16, np.int32)
        leaf_parent[:6] = [0, 0, 0, 1, 1, 1]
        hier, L = (((dc, np.zeros(16, np.int32)),), leaf_parent), 16
        svc = np.zeros(nb, np.int32)
    else:
        cpu[:n] = rng.randint(1, 9, n) * 10**9
        svc = np.zeros(nb, np.int32)
        svc[:n] = rng.randint(0, 4, n)
    nodes = K.NodeInputs(
        valid=valid, ready=valid.copy(), res_ok=valid & (cpu >= 10**9),
        res_cap=np.clip(cpu // 10**9, 0, K.K_CLAMP).astype(np.int32),
        svc_tasks=svc, total_tasks=(svc * 2 if not two_level else svc),
        failures=np.zeros(nb, np.int32), leaf=leaf,
        os_hash=np.zeros((2, nb), np.int32),
        arch_hash=np.zeros((2, nb), np.int32),
        port_conflict=np.zeros(nb, bool), extra_mask=np.ones(nb, bool))
    group = K.GroupInputs(
        k=np.int32(k), con_hash=np.zeros((1, 2, nb), np.int32),
        con_op=np.full(1, 2, np.int32), con_exp=np.zeros((1, 2), np.int32),
        plat=np.full((1, 4), -1, np.int32), maxrep=np.int32(0),
        port_limited=np.bool_(False))
    return nodes, group, L, hier


@pytest.mark.parametrize("two_level", [False, True],
                         ids=["flat_312", "multilevel_417"])
def test_mesh_sharded_matches_single_device(ref, two_level):
    """The reference's ``test_sharded_matches_single_device`` and
    ``test_sharded_multilevel_matches_single_device`` on eight shards: the
    port's split equals its unsharded plan and the reference's eight-device
    ``ShardedPlanFn``, and places all k tasks."""
    seed, n, k = (1, 96, 41) if two_level else (0, 100, 57)
    nodes, group, L, hier = _tpu_kernel_case(seed, n, 128, k, two_level)
    got = S.plan_group_sharded(nodes, group, L, S.make_mesh(["cpu"] * 8),
                               hier)
    _same(got, _unsharded_group(nodes, group, L, hier))
    want = ref.sharded.ShardedPlanFn(ref.mesh(8))(
        as_ref(nodes, ref.kernel.NodeInputs),
        as_ref(group, ref.kernel.GroupInputs), L, hier)
    _same(got, want)
    assert int(np.asarray(got[0]).sum()) == k


# ------------------------------------------------------ strategies (B13)

@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("sid", [1, 2, 3])
@pytest.mark.parametrize("n", [256, 251])
def test_mesh_plan_strategy_matches_reference(ref, sid, d, n):
    nodes, group, _, _ = group_inputs(sid * 11 + d, n=n, k=800)
    sin = strategy_inputs(sid, n)
    got = S.plan_strategy_sharded(nodes, group, sin, sid,
                                  S.make_mesh(["cpu"] * d))
    want = _trim(ref.sharded.ShardedPlanFn(ref.mesh(d)).strategy(
        as_ref(nodes, ref.kernel.NodeInputs),
        as_ref(group, ref.kernel.GroupInputs),
        as_ref(sin, ref.kernel.StrategyInputs), sid), n)
    _same(got[:2], want[:2], f"sid {sid} D={d}")
    nt, gt, _ = to_device(nodes, group, (), "cpu")
    _same(got, K.plan_strategy(nt, gt, named_to_device(
        K.StrategyInputs, sin, "cpu"), sid))


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("sid", [1, 2, 3])
def test_mesh_plan_strategy_near_2p24_matches_unsharded(sid, d):
    nodes, group, _, _ = group_inputs(60 + d, n=512, k=K.K_CLAMP - 1,
                                      big=True)
    sin = strategy_inputs(sid + 3, 512)
    got = S.plan_strategy_sharded(nodes, group, sin, sid,
                                  S.make_mesh(["cpu"] * d))
    nt, gt, _ = to_device(nodes, group, (), "cpu")
    _same(got, K.plan_strategy(nt, gt, named_to_device(
        K.StrategyInputs, sin, "cpu"), sid))


# ------------------------------------------------- the fused scan (B14)

def _fused(seed, strategies, quota):
    shared, groups, carry, strat, L = fused_inputs(
        seed, nb=512, n_valid=480, strategies=strategies, n_slots=4,
        n_leaves=6, quota=quota)
    rng = np.random.RandomState(seed)
    k = np.where(groups.k > 0, rng.randint(100, 900, groups.k.shape), 0)
    return shared, groups._replace(k=k.astype(np.int32)), carry, strat, L


FUSED_CASES = {
    "mixed": dict(strategies=(0, 1, 2, 3), quota=False),
    "mixed_quota": dict(strategies=(0, 2, 1, 3, 0), quota=True),
    "spread_only": dict(strategies=(0, 0, 0), quota=False),
}


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_mesh_plan_fused_matches_reference(ref, case, d):
    shared, groups, carry, strat, L = _fused(d + 3, **FUSED_CASES[case])
    spread_only = not any(int(v) for v in strat.sid)
    strat = None if spread_only else strat
    sids = [0] * groups.k.shape[0] if strat is None \
        else [int(v) for v in strat.sid]
    got = S.plan_fused_sharded(shared, groups, carry, L,
                               S.make_mesh(["cpu"] * d), strat, sids)
    jax = ref.jax
    with jax.enable_x64(True):
        rk = ref.kernel
        fn = ref.sharded.ShardedPlanFn(ref.mesh(d))
        sh, ca = fn.prepare_fused(as_ref(shared, rk.FusedShared),
                                  as_ref(carry, rk.FusedCarry))
        want = fn.fused(sh, as_ref(groups, rk.FusedGroups), ca, L,
                        as_ref(strat, rk.FusedStrategy))
        want = [np.asarray(w) for w in want[:3]] + [
            [np.asarray(c) for c in want[3]]]
    _same(got[:3], want[:3], f"{case} D={d}")
    for name, cols, w in zip(("total", "cpu", "mem", "svc_acc"),
                             zip(*got[3]), want[3]):
        np.testing.assert_array_equal(torch.cat(cols, -1).numpy(), w,
                                      err_msg=name)
    # and the port's unsharded chunk
    a = fused_to_device(shared, groups, carry, strat, "cpu")
    one = K.plan_fused(*a[:3], L, a[3], sids)
    _same(got[:3], one[:3], f"{case} D={d} vs unsharded")


# ------------------------------------------- K10 and K11 (plain, CPU)

@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("case", sorted(SHARD_FILL_CASES))
def test_mesh_shard_fill_matches_unsharded_fill(case, d):
    """K10's and K11's wrappers on CPU shards (their plain versions)
    against the unsharded fills over the whole axis with global keys."""
    kw = SHARD_FILL_CASES[case]
    arrs = shard_fill_inputs(8, nb=4096, n_valid=4000, **kw)
    parts = fill_parts(arrs, d, "cpu")
    if arrs["pack"]:
        K._shard_packfill(parts)
        want = K._packfill_plain(
            K._binpack_key(torch.from_numpy(arrs["res_cap"]),
                           torch.from_numpy(arrs["failures"])),
            torch.from_numpy(arrs["cap"]), torch.from_numpy(arrs["k"]),
            torch.zeros(4096, dtype=torch.int32), 1)
    else:
        K._shard_waterfill(parts, kw["L"])
        t = {k: torch.from_numpy(v) for k, v in arrs.items()
             if isinstance(v, np.ndarray)}
        e = t["e"] if "e" in t else K._spread_score(t["svc"], t["failures"])
        want = K._waterfill_plain(e, t["cap"],
                                  K._tie_keys(t["total"], 4096, "cpu"),
                                  t["k"], t["leaf"], kw["L"])
    _same((torch.cat([p.out for p in parts]),), (want,))


@pytest.mark.parametrize("d", MESHES)
def test_mesh_headline_fill_matches_unsharded_fill(d):
    """K10's wrapper on CPU shards at the headline path's leaf fill (256
    segments, 20 live racks; 1024 rows here) against the unsharded
    water-fill over the whole axis with global tie keys."""
    parts, L = headline_fill_parts(d, "cpu", nb=1024, n_valid=1000)
    K._shard_waterfill(parts, L)

    def cat(field):
        return torch.cat([getattr(p, field) for p in parts])

    want = K._waterfill_plain(
        K._spread_score(cat("svc_tasks"), cat("failures")), cat("cap"),
        K._tie_keys(cat("total"), 1024, "cpu"), parts[0].k, cat("seg"), L)
    assert L == 256 and int(parts[0].k.sum()) > 0
    _same((cat("out"),), (want,))


# -------------------------------------------------------- mesh and seams

def test_make_mesh_layouts():
    mesh = S.make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {S.NODE_AXIS: 4}
    assert all(d.type == "cpu" for d in mesh.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            S.make_mesh(["cuda:0"] * 4)
    with pytest.raises(ValueError):
        S.make_mesh([])


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:1"],
                                     ["cuda:0", "cuda:0", "cuda:1"],
                                     ["cpu", "cuda:0"]])
def test_make_mesh_refuses_several_cards(devices):
    """A mesh's shards share one card (or the CPU): the exchange between
    cards is not built, so such a mesh raises before any plan runs."""
    with pytest.raises(ValueError, match="one card"):
        S.make_mesh(devices)


def test_merge_shard_rows_sums_counts_and_trims():
    rows = np.zeros((4, 3, 5 + K.N_FILTERS + 1), np.int32)
    for d in range(4):
        rows[d, :, :5] = np.arange(5) + 10 * d
        rows[d, :, 5:5 + K.N_FILTERS] = d + 1
        rows[d, :, -1] = 1 if d == 0 else 0
    merged = K.merge_shard_rows(rows, 18)
    assert merged.shape == (3, 18 + K.N_FILTERS + 1)
    np.testing.assert_array_equal(
        merged[0, :18], np.concatenate([np.arange(5) + 10 * d
                                        for d in range(4)])[:18])
    assert (merged[:, 18:18 + K.N_FILTERS] == 10).all()
    assert (merged[:, -1] == 1).all()


def test_shard_to_device_pads_and_splits():
    from swarmkit_tpu_torch.ops.convert import shard_hier, shard_to_device
    nodes, group, L, hier = group_inputs(1, n=251, L=16, levels=2)
    devs = S.make_mesh(["cpu"] * 4).devices
    parts = shard_to_device(nodes, K.NodeInputs, devs)
    assert [p.valid.shape[0] for p in parts] == [63] * 4
    assert not parts[-1].valid[-1] and parts[-1].os_hash.shape == (2, 63)
    assert torch.equal(torch.cat([p.leaf for p in parts])[:251],
                       torch.from_numpy(nodes.leaf))
    groups = shard_to_device(group, K.GroupInputs, devs)
    assert groups[2].con_hash.shape == (2, 2, 63)
    assert torch.equal(groups[3].con_op, torch.from_numpy(group.con_op))
    h = shard_hier(hier, devs)
    assert h[1][0][0][0].shape == (63,) and h[1][1].shape == (L,)
