"""What crosses the shards of the port's node-axis split, on the CPU.

On CPU shards the sharded compositions (``ops/kernel.py``
``plan_*_sharded_packed``) run the kernels' plain versions, and every
cross-shard sum but the fail counts' goes through their ``reduce`` (the
reference's ``psum``).  A counting ``reduce`` shows that only [2, L_d]
branch sums and [L] (or [1]) search steps cross; the fail counts cross at
the fetch (``merge_shard_rows``); stage A clamps only after the sum;
and the CPU route never fills a concatenation of the shards with the
unsharded fills.  Inputs and comparisons as in ``test_torch_mesh.py``.
"""

import pytest
import torch

from swarmkit_tpu_torch.ops import kernel as K
from swarmkit_tpu_torch.ops.convert import (
    fused_to_device, shard_to_device, to_device)
from swarmkit_tpu_torch.ops.densify import l_bucket
from swarmkit_tpu_torch.parallel import sharded as S
from test_torch_mesh import (
    FUSED_CASES, _fused, _same, group_inputs, strategy_inputs)


class CountingReduce:
    """A ``reduce`` that sums in shard order and records the shape of
    every value that crosses shards."""

    def __init__(self):
        self.shapes = []

    def __call__(self, parts):
        self.shapes.append(tuple(parts[0].shape))
        return K.sum_shards(parts)


def _merged(bufs, n):
    """The per-shard plan rows of a split as one unsharded plan, as the
    fetch merges them (the fail counts summed over the shards)."""
    return K.merge_shard_rows(torch.stack(list(bufs)).numpy(), n)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("levels", [1, 2])
def test_mesh_only_psum_operands_cross_shards_group(d, levels):
    """On CPU shards the one sharded composition sends every cross-shard
    sum through ``reduce``: per stage-A level one [2, L_d] (load,
    capacity) partial, per node-level search step one [L]; the 8 fail
    counts cross at the fetch, where merge_shard_rows sums them."""
    nodes, group, L, hier = group_inputs(5, L=16, levels=levels, k=600)
    mesh = S.make_mesh(["cpu"] * d)
    reduce = CountingReduce()
    bufs = K.plan_group_sharded_packed(
        S.shard_group(nodes, group, hier, mesh), L, reduce=reduce)
    l_top = l_bucket(2)
    allowed = {(2, L), (2, l_top), (L,)}
    assert set(reduce.shapes) <= allowed, reduce.shapes
    # one branch-sum exchange per stage-A level, 69 node-level steps
    assert len(reduce.shapes) == levels + K.WATERFILL_STEPS - 1
    assert reduce.shapes.count((L,)) == K.WATERFILL_STEPS - 1
    _same(K.unpack_plan(_merged(bufs, 256), 256),
          S.plan_group_sharded(nodes, group, L, mesh, hier))


@pytest.mark.parametrize("sid", [1, 2, 3])
def test_mesh_only_psum_operands_cross_shards_strategy(sid):
    nodes, group, _, _ = group_inputs(6, k=500)
    mesh = S.make_mesh(["cpu"] * 4)
    shards = [(nd, gd) for nd, gd, _ in S.shard_group(nodes, group, (),
                                                      mesh)]
    sins = shard_to_device(strategy_inputs(sid, 256), K.StrategyInputs,
                           mesh.devices)
    reduce = CountingReduce()
    bufs = K.plan_strategy_sharded_packed(shards, sins, sid, reduce=reduce)
    assert set(reduce.shapes) <= {(1,)}
    # the plain pack fill psums 34 threshold steps and the sum below it
    steps = K.TIE_ITERS + 1 if sid == 1 else K.WATERFILL_STEPS - 1
    assert len(reduce.shapes) == steps
    _same(K.unpack_plan(_merged(bufs, 256), 256)[:2],
          S.plan_strategy_sharded(nodes, group, strategy_inputs(sid, 256),
                                  sid, mesh)[:2])


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_mesh_only_psum_operands_cross_shards_fused(case):
    """The fused chunk over CPU shards: per slot the slot's plan sends its
    [2, L] branch sums and its [L] or [1] search steps through ``reduce``,
    and nothing else crosses; its rows equal the unsharded chunk's."""
    shared, groups, carry, strat, L = _fused(11, **FUSED_CASES[case])
    strat = None if not any(int(v) for v in strat.sid) else strat
    sids = [0] * groups.k.shape[0] if strat is None \
        else [int(v) for v in strat.sid]
    mesh = S.make_mesh(["cpu"] * 4)
    fn = S.ShardedPlanFn(mesh)
    s_shared, s_carry = fn.prepare_fused(shared, carry)
    reduce = CountingReduce()
    bufs = K.plan_fused_sharded_packed(
        s_shared, shard_to_device(groups, K.FusedGroups, mesh.devices),
        s_carry, L, None if strat is None else shard_to_device(
            strat, K.FusedStrategy, mesh.devices), sids, reduce=reduce)
    assert set(reduce.shapes) <= {(2, L), (L,), (1,)}, set(reduce.shapes)
    # per spread slot one branch-sum exchange; per slot its search steps
    steps = sum(K.TIE_ITERS + 1 if sid == 1 else
                K.WATERFILL_STEPS - 1 for sid in sids)
    assert len(reduce.shapes) == steps + sids.count(0)
    a = fused_to_device(shared, groups, carry, strat, "cpu")
    _same(K.unpack_fused(_merged(bufs, 512), 512),
          K.plan_fused(*a[:3], L, a[3], sids)[:3], case)


def test_mesh_route_never_fills_a_concatenation(monkeypatch):
    """The sharded CPU route goes through K10's and K11's plain versions
    with the exchange's fold, and never through the unsharded node-level
    fills on all N rows (stage A's water-fills over [L_d] branch vectors
    are K3 as is)."""
    calls = {"fold": 0, "waterfill_n": [], "packfill": 0}
    fold = K.sum_shards

    def counting_fold(parts):
        calls["fold"] += 1
        return fold(parts)

    orig_wf = K._waterfill_plain

    def waterfill(e, *a, **kw):
        calls["waterfill_n"].append(e.shape[0])
        return orig_wf(e, *a, **kw)

    def packfill(*a, **kw):
        calls["packfill"] += 1
        raise AssertionError("unsharded pack fill on a sharded route")

    monkeypatch.setattr(K, "sum_shards", counting_fold)
    monkeypatch.setattr(K, "_waterfill_plain", waterfill)
    monkeypatch.setattr(K, "_packfill_plain", packfill)
    nodes, group, L, hier = group_inputs(3, L=16, levels=2, k=500)
    mesh = S.make_mesh(["cpu"] * 4)
    S.plan_group_sharded(nodes, group, L, mesh, hier)
    assert calls["fold"] >= K.WATERFILL_STEPS - 1 + 2
    assert calls["waterfill_n"] and max(calls["waterfill_n"]) <= L
    calls["fold"] = 0
    S.plan_strategy_sharded(nodes, group, None, 1, mesh)
    assert calls["fold"] == K.TIE_ITERS + 1 and not calls["packfill"]


def test_seg_fold_plain_sums_in_shard_order_then_clamps():
    """The fold of a split's stage-A sums on CPU shards
    (``_seg_fold_plain``, the plain version of what one K2 launch over
    the shard table sums on the card): the shards' rows summed in int64
    before the clamps (a per-shard clamp would give a smaller load)."""
    rows = torch.zeros((4, 2, 3), dtype=torch.int64)
    rows[:, 0, 0] = K.LOAD_CLAMP // 2          # the sum passes LOAD_CLAMP
    rows[:, 1, 1] = 1 << 23                    # capacity past 2^24
    rows[2, 1, 2] = 7
    load, bcap, raw, kk = K._seg_fold_plain(
        list(rows), torch.tensor(9, dtype=torch.int32))
    assert load.tolist() == [K.LOAD_CLAMP, 0, 0]
    assert raw.tolist() == [0, 1 << 25, 7] and bcap.tolist() == [0, 9, 7]
    assert kk.tolist() == [9]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("levels", [1, 2])
def test_mesh_stage_a_sums_equal_unsharded_branch_sums(d, levels):
    """A stage-A level's branch sums over D CPU shards
    (``branch_sums_sharded``: each shard's partials, summed in shard order,
    then clamped; on the card one K2 launch over the shard table) equal
    K2 on the unsplit columns, on every shard, with the level's capacity
    past 2^24."""
    nodes, group, L, hier = group_inputs(60 + d, n=256, L=16, levels=levels,
                                         k=K.K_CLAMP - 1, big=True)
    cn, cg, ch = to_device(nodes, group, hier, "cpu")
    _, cap, _ = K._feasibility_plain(cn, cg)
    levels_segs = [(seg, parent.shape[0]) for seg, parent in ch[0]] \
        if ch else []
    levels_segs.append((cn.leaf, L))
    n = cap.shape[0] // d
    for seg, L_d in levels_segs:
        want = K.branch_sums(cn.svc_tasks, cn.valid, cap, seg, L_d, cg.k)
        parts = [tuple(t[i * n:(i + 1) * n] for t in (
            cn.svc_tasks, cn.valid, cap, seg)) + (cg.k,) for i in range(d)]
        got = K.branch_sums_sharded(parts, L_d)
        assert len(got) == d
        for shard in got:
            for a, b in zip(shard, want):
                assert torch.equal(a, b)
    assert int(want[2].sum()) > 1 << 24
