"""K10's and K11's plain versions against the reference's psum'd fills, on
the CPU, at the cases the one-launch designs turn on.

The reference runs ``seg_waterfill`` (``swarmkit_tpu/ops/kernel.py:127``)
on every shard with each [L] partial sum psummed over the node axis
(``parallel/sharded.py``).  Here that program runs under ``jax.vmap`` with
a named axis, so its psum spans D = 1, 2, 8 or 16 shards without D
devices; the port's ``_shard_waterfill`` on D CPU shards (its plain
version) must place every row exactly as it does.  Cases: one segment;
20 segments, one of which lies inside shard 0 while another spreads over
every shard, with equal levels on both sides of every border (the global
tie key decides); a level given per row; and 8,200 segments, past the
8,192 of a per-host spread's first leaf bucket.  Levels and tie keys
reach the reference as the port forms them from its inputs (spread score,
(clip(total) << 20) | global index).

The same holds for the pack fill: the reference's ``seg_packfill``
(``swarmkit_tpu/ops/kernel.py:428``) with its capacity sums psummed, on
the binpack key of the global index, against ``_shard_packfill`` on D CPU
shards and, at D = 1, ``_packfill``: k = 1, the whole capacity, past it
and 0; every row in the failure band or in one score bin; rows of
capacity 0 inside the threshold's bin; the threshold row on a shard
border.  Every output is an integer: bit-equal.
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

from chip_smoke import (  # noqa: E402
    PACK_EDGE_CASES, edge_fill_inputs, fill_parts, pack_edge_inputs)
from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu.scheduler.strategy import BP_CLAMP  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as K  # noqa: E402
from swarmkit_tpu_torch.scheduler.nodeinfo import MAX_FAILURES  # noqa: E402

CASES = {
    "L1": dict(n=4096, L=1),
    "L20": dict(n=4096, L=20),
    "L20_level": dict(n=4096, L=20, scored=True),
    "L8200": dict(n=16400, L=8200),
}


def _reference(arrs, d):
    """The reference's seg_waterfill over d shards, psum over a vmapped
    node axis; the placement of every row in global order."""
    n = arrs["cap"].shape[0]
    if arrs["e"] is not None:
        e = arrs["e"]
    else:
        f = arrs["failures"]
        down = np.where(f >= MAX_FAILURES, np.clip(f, 0, ref.FAILURE_CLAMP),
                        0)
        e = np.clip(arrs["svc"], 0, ref.SVC_CLAMP) + down * ref.F_BIG
    tie = (np.clip(arrs["total"], 0, ref.TOTAL_CLAMP) << ref.IDX_BITS) \
        | np.arange(n)
    k = jnp.asarray(arrs["k"])
    L = k.shape[0]

    def shard(e, cap, tie, seg):
        return ref.seg_waterfill(e, cap, tie, k, seg, L,
                                 reduce=lambda v: jax.lax.psum(v, "nodes"))

    cols = [np.asarray(a, np.int32).reshape(d, n // d)
            for a in (e, arrs["cap"], tie, arrs["leaf"])]
    x = jax.jit(jax.vmap(shard, axis_name="nodes"))(*cols)
    return np.asarray(x).reshape(n)


@pytest.mark.parametrize("d", [1, 2, 8, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_waterfill_plain_matches_psummed_reference(case, d):
    kw = dict(CASES[case])
    arrs = edge_fill_inputs(41, **kw)
    parts = fill_parts(arrs, d, "cpu")
    K._shard_waterfill(parts, kw["L"])
    got = np.concatenate([p.out.numpy() for p in parts])
    want = _reference(arrs, d)
    np.testing.assert_array_equal(got, want)
    # the case exercises what it names: segments filled, one infeasible
    placed = np.bincount(arrs["leaf"], weights=got, minlength=kw["L"])
    held = np.bincount(arrs["leaf"], weights=arrs["cap"], minlength=kw["L"])
    np.testing.assert_array_equal(placed, np.minimum(arrs["k"], held))
    if kw["L"] > 3:
        assert placed[3] == held[3] < arrs["k"][3]


def _binpack_keys(arrs):
    """The reference's binpack key (``plan_strategy``, kernel.py:521-526)
    on the global index."""
    f = arrs["failures"]
    score = np.where(f >= MAX_FAILURES,
                     BP_CLAMP + 1 + np.clip(f, 0, ref.FAILURE_CLAMP),
                     np.clip(arrs["res_cap"], 0, BP_CLAMP))
    return ((score << ref.IDX_BITS) | np.arange(f.shape[0])).astype(np.int32)


@jax.jit
def _psummed_packfill(key, cap, k):
    def shard(key, cap):
        seg = jnp.zeros(key.shape[0], jnp.int32)
        return ref.seg_packfill(key, cap, k, seg, 1,
                                reduce=lambda v: jax.lax.psum(v, "nodes"))
    return jax.vmap(shard, axis_name="nodes")(key, cap)


@pytest.mark.parametrize("d", [1, 2, 8, 16])
@pytest.mark.parametrize("case", PACK_EDGE_CASES)
def test_shard_packfill_plain_matches_psummed_reference(case, d):
    n = 4096
    arrs = pack_edge_inputs(47, n, case)
    parts = fill_parts(arrs, d, "cpu")
    K._shard_packfill(parts)
    got = np.concatenate([p.out.numpy() for p in parts])
    key = _binpack_keys(arrs).reshape(d, n // d)
    want = np.asarray(_psummed_packfill(
        key, arrs["cap"].reshape(d, n // d), jnp.asarray(arrs["k"])))
    np.testing.assert_array_equal(got, want.reshape(n))
    if d == 1:
        x = torch.empty(n, dtype=torch.int32)
        K._packfill(res_cap=torch.from_numpy(arrs["res_cap"]),
                    failures=torch.from_numpy(arrs["failures"]),
                    cap=torch.from_numpy(arrs["cap"]),
                    k=torch.from_numpy(arrs["k"]), out=x)
        np.testing.assert_array_equal(x.numpy(), got)
    # the case exercises what it names
    k, held = int(arrs["k"][0]), int(arrs["cap"].sum())
    assert got.sum() == min(max(k, 0), held)
    partial = np.nonzero((got > 0) & (got < arrs["cap"]))[0]
    if case == "border":
        assert list(partial) == [n // 2]
    if case == "cap0_band":
        (row,) = partial
        band = np.nonzero(arrs["res_cap"] == 480)[0]
        assert arrs["res_cap"][row] == 480
        assert (arrs["cap"][band[band < row]] == 0).any()
