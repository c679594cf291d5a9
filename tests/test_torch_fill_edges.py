"""K10's plain version against the reference's psum'd water-fill, on the
CPU, at the cases the one-launch design turns on.

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
(clip(total) << 20) | global index).  Every output is an integer:
bit-equal.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from chip_smoke import edge_fill_inputs, fill_parts  # noqa: E402
from swarmkit_tpu.ops import kernel as ref  # noqa: E402
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
