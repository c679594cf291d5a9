"""The port's kernels (plain PyTorch versions, on the CPU) against the JAX
reference kernels on JAX's CPU backend.

Inputs are made with numpy from a seed, built once in the reference's own
layout, and handed to both: the reference gets them as jax arrays, the
port through ``swarmkit_tpu_torch.ops.convert``.  Every output is integer
or boolean, so the tolerance is bit-equality: ``x``, ``fail_counts``,
``spill``, ``mask`` and ``cap`` must match exactly.  The cases include
branch totals around 2^24 (where the reference's float32 segment sums stop
being exact) and group sizes near ``K_CLAMP``.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import tensor, to_device  # noqa: E402
from swarmkit_tpu_torch.ops.densify import l_bucket  # noqa: E402


def _np(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t)


# ------------------------------------------------------------- input maker

def make_inputs(seed, n=256, n_valid=None, cc=4, p=4, k=37, maxrep=0,
                port_limited=False, quota=False, svc_hi=6, cap_hi=40,
                big_cap=False, leaf=None, selective=True):
    """Seeded NodeInputs/GroupInputs in the reference's numpy layout.
    ``selective=False`` keeps one ``!=`` constraint and a catch-all
    platform row, so most nodes stay feasible (placement cases)."""
    rng = np.random.RandomState(seed)
    n_valid = n - 7 if n_valid is None else n_valid
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    res_cap = rng.randint(0, cap_hi, n).astype(np.int32)
    if big_cap:
        res_cap[:] = ref.K_CLAMP
    svc = rng.randint(0, svc_hi, n).astype(np.int32)
    nodes = ref.NodeInputs(
        valid=valid,
        ready=rng.rand(n) < 0.9,
        res_ok=rng.rand(n) < 0.9,
        res_cap=res_cap,
        svc_tasks=svc,
        total_tasks=rng.randint(0, 1500, n).astype(np.int32),
        failures=rng.choice([0, 0, 0, 1, 5, 7, 70], n).astype(np.int32),
        leaf=(np.zeros(n, np.int32) if leaf is None else leaf),
        os_hash=rng.randint(0, 3, (2, n)).astype(np.int32),
        arch_hash=rng.randint(0, 3, (2, n)).astype(np.int32),
        port_conflict=rng.rand(n) < 0.2,
        extra_mask=rng.rand(n) < 0.95,
        quota_ok=(rng.rand(n) < 0.7) if quota else None)
    con_op = rng.randint(0, 3, cc).astype(np.int32)
    plat = np.full((p, 4), -1, np.int32)
    for pi in range(rng.randint(0, p + 1)):
        row = rng.randint(0, 3, 4)
        if rng.rand() < 0.3:
            row[2:] = 0          # any architecture
        plat[pi] = row
    if not selective:
        con_op[:] = 2
        con_op[0] = 1
        plat[:] = -1
        plat[0] = 0
    group = ref.GroupInputs(
        k=np.int32(k),
        con_hash=rng.randint(0, 2, (cc, 2, n)).astype(np.int32),
        con_op=con_op,
        con_exp=rng.randint(0, 2, (cc, 2)).astype(np.int32),
        plat=plat, maxrep=np.int32(maxrep),
        port_limited=np.bool_(port_limited))
    return nodes, group


def jax_inputs(nodes, group):
    conv = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (ref.NodeInputs(*[conv(v) for v in nodes]),
            ref.GroupInputs(*[conv(v) for v in group]))


def two_level(seed, n, a, b):
    """(leaf i32[n], hier, L) for an a-way top level with b leaves each."""
    rng = np.random.RandomState(seed + 1000)
    top = rng.randint(0, a, n).astype(np.int32)
    leaf = (top * b + rng.randint(0, b, n)).astype(np.int32)
    L0 = l_bucket(a)
    L = l_bucket(a * b)
    leaf_parent = np.zeros(L, np.int32)
    leaf_parent[:a * b] = np.arange(a * b) // b
    hier = (((top, np.zeros(L0, np.int32)),), leaf_parent)
    return leaf, hier, L


# ------------------------------------------------------- feasibility (K1)

FEAS_CASES = {
    "plain": dict(),
    "maxrep": dict(maxrep=3),
    "ports": dict(port_limited=True),
    "quota": dict(quota=True),
    "k_near_clamp": dict(k=ref.K_CLAMP + 5, big_cap=True),
    "one_slot": dict(cc=1, p=1, n=1024),
    "sixteen_constraints": dict(cc=16, seed_offset=3),
}


@pytest.mark.parametrize("case", sorted(FEAS_CASES))
def test_feasibility_and_capacity_matches_reference(case):
    kw = dict(FEAS_CASES[case])
    seed = 11 + kw.pop("seed_offset", 0)
    nodes, group = make_inputs(seed, **kw)
    mask_r, cap_r, fail_r = ref.feasibility_and_capacity(
        *jax_inputs(nodes, group))
    pn, pg, _ = to_device(nodes, group, device="cpu")
    mask_p, cap_p, fail_p = port.feasibility_and_capacity(pn, pg)
    np.testing.assert_array_equal(_np(mask_p), np.asarray(mask_r))
    np.testing.assert_array_equal(_np(cap_p), np.asarray(cap_r))
    np.testing.assert_array_equal(_np(fail_p), np.asarray(fail_r))
    assert _np(cap_p).dtype == np.int32 and _np(fail_p).dtype == np.int32


@pytest.mark.parametrize("case", ["plain", "quota", "ports"])
def test_feasibility_entry_matches_reference_jit(case):
    nodes, group = make_inputs(5, **FEAS_CASES[case])
    mask_r, cap_r, fail_r = ref.feasibility_jit(*jax_inputs(nodes, group))
    pn, pg, _ = to_device(nodes, group, device="cpu")
    mask_p, cap_p, fail_p = port.feasibility(pn, pg)
    np.testing.assert_array_equal(_np(mask_p), np.asarray(mask_r))
    np.testing.assert_array_equal(_np(cap_p), np.asarray(cap_r))
    np.testing.assert_array_equal(_np(fail_p), np.asarray(fail_r))


# ---------------------------------------------------------- waterfill (K3)

def waterfill_case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "flat":
        n, L = 300, 1
        seg = np.zeros(n, np.int32)
        e = rng.randint(0, 5, n)
        cap = rng.randint(0, 6, n)
        k_seg = np.array([400])
    elif name == "segments":
        n, L = 500, 16
        seg = rng.randint(0, 11, n)
        e = rng.randint(0, 9, n)
        cap = rng.randint(0, 4, n)
        k_seg = rng.randint(0, 120, L)
    elif name == "infeasible":
        n, L = 64, 4
        seg = rng.randint(0, 4, n)
        e = rng.randint(0, 3, n)
        cap = rng.randint(0, 2, n)
        k_seg = np.array([1000, 0, 3, 40])
    elif name == "downweighted":
        n, L = 128, 1
        seg = np.zeros(n, np.int32)
        e = rng.randint(0, 4, n) + (rng.rand(n) < 0.3) * 7 * ref.F_BIG
        cap = rng.randint(1, 5, n)
        k_seg = np.array([300])
    elif name == "totals_near_2p24":
        # capacities of 2^21 per element: segment totals straddle 2^24
        n, L = 40, 4
        seg = np.repeat(np.arange(4), 10)
        e = rng.randint(0, 3, n)
        cap = np.full(n, 1 << 21)
        cap[:7] = (1 << 21) - 1
        k_seg = np.array([ref.K_CLAMP, ref.K_CLAMP - 1, 3 * (1 << 21) + 5,
                          (1 << 22) - 17])
    elif name == "k_near_clamp":
        n, L = 2048, 1
        seg = np.zeros(n, np.int32)
        e = rng.randint(0, 50, n)
        cap = np.full(n, ref.K_CLAMP)
        k_seg = np.array([ref.K_CLAMP])
    else:
        raise KeyError(name)
    tie = rng.permutation(n)
    return (np.asarray(e, np.int32), np.asarray(cap, np.int32),
            np.asarray(tie, np.int32), np.asarray(k_seg, np.int32),
            np.asarray(seg, np.int32), L)


WATERFILL_CASES = ["flat", "segments", "infeasible", "downweighted",
                   "totals_near_2p24", "k_near_clamp"]


@pytest.mark.parametrize("case", WATERFILL_CASES)
def test_seg_waterfill_matches_reference(case):
    e, cap, tie, k_seg, seg, L = waterfill_case(case)
    x_r = ref.seg_waterfill(*map(jnp.asarray, (e, cap, tie, k_seg, seg)), L)
    x_p = port.seg_waterfill(*(tensor(a, "cpu")
                               for a in (e, cap, tie, k_seg, seg)), L)
    np.testing.assert_array_equal(_np(x_p), np.asarray(x_r))
    assert _np(x_p).dtype == np.int32


def test_seg_waterfill_reference_unit_cases():
    """The reference's own hand-checked waterfill cases, on the port."""
    def wf(e, cap, tie, k_seg, seg, L):
        return list(_np(port.seg_waterfill(
            *(tensor(np.asarray(a, np.int32), "cpu")
              for a in (e, cap, tie, k_seg, seg)), L)))
    assert wf([0] * 4, [10] * 4, [0, 1, 2, 3], [8], [0] * 4, 1) == [2] * 4
    assert wf([3, 0, 1], [10] * 3, [0, 1, 2], [5], [0] * 3, 1) == [0, 3, 2]
    assert wf([0] * 3, [5] * 3, [2, 0, 1], [2], [0] * 3, 1) == [0, 1, 1]
    assert wf([0, 0], [1, 10], [0, 1], [6], [0, 0], 1) == [1, 5]
    assert wf([0, 0], [1, 1], [0, 1], [5], [0, 0], 1) == [1, 1]
    assert wf([0] * 4, [9] * 4, [0, 1, 2, 3], [2, 4], [0, 0, 1, 1],
              2) == [1, 1, 2, 2]


# --------------------------------------------------------- plan_group (K1-3)

def plan_case(name):
    n = 512
    if name == "flat":
        nodes, group = make_inputs(21, n=n, selective=False, k=300)
        return nodes, group, 1, ()
    if name == "one_level":
        leaf = np.random.RandomState(3).randint(0, 12, n).astype(np.int32)
        nodes, group = make_inputs(22, n=n, selective=False, k=450,
                                   leaf=leaf)
        return nodes, group, l_bucket(12), ()
    if name == "one_level_maxrep":
        leaf = (np.arange(n) % 5).astype(np.int32)
        nodes, group = make_inputs(23, n=n, selective=False, k=900,
                                   maxrep=4, leaf=leaf)
        return nodes, group, l_bucket(5), ()
    if name == "two_level":
        leaf, hier, L = two_level(24, n, 3, 4)
        nodes, group = make_inputs(24, n=n, selective=False, k=700,
                                   leaf=leaf)
        return nodes, group, L, hier
    if name == "two_level_quota":
        leaf, hier, L = two_level(25, n, 5, 3)
        nodes, group = make_inputs(25, n=n, selective=False, k=200,
                                   leaf=leaf, quota=True)
        return nodes, group, L, hier
    if name == "saturating_branch":
        # branch 0 holds few nodes of tiny capacity: it saturates while the
        # others do not, so the level spills to the host path
        leaf = np.where(np.arange(n) < 8, 0, 1 + np.arange(n) % 3)
        nodes, group = make_inputs(26, n=n, selective=False, k=200,
                                   cap_hi=3, leaf=leaf.astype(np.int32))
        return nodes, group, l_bucket(4), ()
    if name == "loads_near_2p24":
        # per-branch service loads straddle 2^24: branches 1-3 hold 16
        # nodes of ~2^20 tasks each (just under), branch 0 twice that
        leaf = (np.arange(n) // 16 % 4).astype(np.int32)
        nodes, group = make_inputs(27, n=n, selective=False, k=5000,
                                   leaf=leaf, cap_hi=60)
        svc = nodes.svc_tasks.copy()
        svc[:80] = ref.SVC_CLAMP - np.arange(80) % 3
        svc[80:] = 0
        nodes = nodes._replace(svc_tasks=svc.astype(np.int32),
                               failures=np.zeros(n, np.int32))
        return nodes, group, l_bucket(4), ()
    if name == "capacity_near_2p24":
        # branch capacities around 2^24 (a few nodes of K_CLAMP = 2^22
        # each per branch) and k near K_CLAMP
        leaf = (np.arange(n) % 3).astype(np.int32)
        nodes, group = make_inputs(28, n=n, selective=False,
                                   k=ref.K_CLAMP - 3, leaf=leaf)
        res_cap = nodes.res_cap.copy()
        res_cap[:15] = ref.K_CLAMP
        res_cap[15:30:3] = ref.K_CLAMP - 1
        nodes = nodes._replace(res_cap=res_cap,
                               ready=np.ones(n, bool),
                               res_ok=np.ones(n, bool))
        return nodes, group, l_bucket(3), ()
    raise KeyError(name)


PLAN_CASES = ["flat", "one_level", "one_level_maxrep", "two_level",
              "two_level_quota", "saturating_branch", "loads_near_2p24",
              "capacity_near_2p24"]


def _ref_plan(nodes, group, L, hier):
    return ref.plan_group_jit(*jax_inputs(nodes, group), L, hier=hier)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_group_matches_reference(case):
    nodes, group, L, hier = plan_case(case)
    x_r, fail_r, spill_r = _ref_plan(nodes, group, L, hier)
    pn, pg, ph = to_device(nodes, group, hier, "cpu")
    x_p, fail_p, spill_p = port.plan_group(pn, pg, L, ph)
    np.testing.assert_array_equal(_np(x_p), np.asarray(x_r))
    np.testing.assert_array_equal(_np(fail_p), np.asarray(fail_r))
    assert bool(spill_p) == bool(spill_r)
    if case == "saturating_branch":
        assert bool(spill_p)


def test_plan_group_places_k_when_capacity_allows():
    nodes, group, L, hier = plan_case("one_level")
    pn, pg, ph = to_device(nodes, group, hier, "cpu")
    x, _, spill = port.plan_group(pn, pg, L, ph)
    assert not bool(spill)
    assert int(_np(x).sum()) == int(group.k)


def test_plan_buffer_round_trip():
    """The single-D2H seam: the packed buffer splits back into the triple
    the planner applies."""
    nodes, group, L, hier = plan_case("two_level")
    pn, pg, ph = to_device(nodes, group, hier, "cpu")
    n = nodes.valid.shape[0]
    buf = port.plan_group_packed(pn, pg, L, ph)
    x, fail, spill = port.fetch_plan(port.start_fetch(buf), n)
    x_r, fail_r, spill_r = _ref_plan(nodes, group, L, hier)
    np.testing.assert_array_equal(x, np.asarray(x_r))
    np.testing.assert_array_equal(fail, np.asarray(fail_r))
    assert spill == bool(spill_r)


def test_wrapper_refuses_mismatched_inputs():
    nodes, group = make_inputs(1, n=64)
    pn, pg, _ = to_device(nodes, group, device="cpu")
    with pytest.raises(ValueError):
        port.feasibility(pn._replace(res_cap=pn.res_cap.to(torch.int64)), pg)
    with pytest.raises(ValueError):
        port.seg_waterfill(pn.svc_tasks, pn.res_cap, pn.total_tasks,
                           torch.zeros(2, dtype=torch.int32), pn.leaf, 1)


@pytest.mark.parametrize("L", [1, 16])
def test_branch_sums_drop_out_of_range_segments(L):
    """K2's plain version, unsharded and over CPU shards, drops a row whose
    segment lies outside [0, L), as the reference's segment sums
    (``jax.ops.segment_sum``) drop it; the kernel skips such rows too."""
    rng = np.random.RandomState(L)
    n = 256
    seg = rng.randint(-3, L + 3, n).astype(np.int32)
    svc = rng.randint(-2, 9, n).astype(np.int32)
    valid = rng.rand(n) < 0.9
    cap = rng.randint(0, 9, n).astype(np.int32)
    load = jnp.where(valid, jnp.clip(svc, 0, ref.SVC_CLAMP), 0)
    want_load = np.asarray(jax.ops.segment_sum(load, seg, num_segments=L))
    want_cap = np.asarray(jax.ops.segment_sum(cap, seg, num_segments=L))
    assert ((seg < 0) | (seg >= L)).any()
    cols = [torch.from_numpy(a) for a in (svc, valid, cap, seg)]
    k = torch.tensor(port.K_CLAMP - 1, dtype=torch.int32)
    got = port.branch_sums(*cols, L, k)
    np.testing.assert_array_equal(_np(got[0]), want_load)
    np.testing.assert_array_equal(_np(got[2]), want_cap)
    parts = [tuple(c[i * 64:(i + 1) * 64] for c in cols) + (k,)
             for i in range(4)]
    for shard in port.branch_sums_sharded(parts, L):
        for a, b in zip(shard, got):
            assert torch.equal(a, b)
