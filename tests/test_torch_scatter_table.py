"""K7 over the shard table on the CPU, against the reference.

``scatter_rows`` takes the five resident columns unsplit (D = 1) or as D
shards of nb / D rows, and one packed buffer of update slots with GLOBAL
row indices; its plain version writes each slot into the shard that owns
its row.  Held here, at D = 1, 2 and 4, with rows in every shard or in
only some, pad slots (index nb) and indices outside [0, nb):

* against the reference's donated ``_scatter_rows_jit`` on the unsplit
  columns, under x64 (``.at[idx].set(mode="drop")``: a negative index
  counts from the end, anything still outside [0, nb) drops);
* against the split's former route, rows bucketed by owning shard with
  local indices and one single-shard scatter a shard;
* through the resident tier's staging buffer: one a bucket, whatever D,
  refilled refresh after refresh.
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

from swarmkit_tpu.ops import streaming as ref_streaming  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.streaming import _ScatterStage  # noqa: E402

NAMES = ("valid", "ready", "cpu", "mem", "total")

#: (nb, rows, bucket, shards that get rows (None: every one; shard o of
#: the table is o % D), indices outside [0, nb) in the slots after the rows)
CASES = {
    "every_shard_d16": (1024, 13, 16, None, ()),
    "some_shards_d256": (4096, 120, 256, (0, 3), ()),
    "one_shard_d16": (1024, 9, 16, (1,), ()),
    "wide_d4096": (8192, 3000, 4096, None, ()),
    "out_of_range": (1024, 10, 16, None, ("nb+3", "2nb", "big")),
    "negative": (1024, 10, 16, (0,), ("-1", "-nb", "-nb-1", "min")),
}


def _columns(rng, nb):
    return (rng.rand(nb) < 0.9, rng.rand(nb) < 0.8,
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(-2**40, 2**40, nb).astype(np.int64),
            rng.randint(0, 5000, nb).astype(np.int32))


def _odd_index(word, nb):
    return {"nb+3": nb + 3, "2nb": 2 * nb, "big": 2**31 - 1, "-1": -1,
            "-nb": -nb, "-nb-1": -nb - 1, "min": -2**31}[word]


def scatter_case(case, shards, seed=0):
    """Seeded (columns [nb], idx i32[db], update slots) of ``case`` on a
    split of ``shards``: unique rows in the chosen shards, then the odd
    indices, then pads (index nb).  A negative index never lands on a row
    that another slot writes."""
    nb, d, db, owners, odd = CASES[case]
    rng = np.random.RandomState(seed + 17 * shards + nb)
    ln = nb // shards
    pool = np.arange(nb) if owners is None else np.concatenate(
        [np.arange(s * ln, (s + 1) * ln)
         for s in sorted({o % shards for o in owners})])
    rows = rng.choice(pool, d, replace=False)
    idx = np.full(db, nb, np.int32)
    idx[:d] = rows
    for j, word in enumerate(odd):
        idx[d + j] = _odd_index(word, nb)
    wrapped = {int(i) + nb for i in idx[d:d + len(odd)] if -nb <= i < 0}
    assert not wrapped & set(rows.tolist())
    upd = (rng.rand(db) < 0.5, rng.rand(db) < 0.5,
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(-2**50, 2**50, db).astype(np.int64),
           rng.randint(0, 2**31 - 1, db).astype(np.int32))
    return _columns(rng, nb), idx, upd


def split(cols, shards):
    """The columns as five tuples of ``shards`` per-shard tensors (copies)."""
    ln = cols[0].shape[0] // shards
    return tuple(tuple(torch.from_numpy(c[s * ln:(s + 1) * ln].copy())
                       for s in range(shards)) for c in cols)


def joined(split_cols):
    return [torch.cat(parts).numpy() for parts in split_cols]


def reference(cols, idx, upd):
    with jax.enable_x64(True):
        want = ref_streaming._scatter_rows_jit(
            *[jnp.asarray(c) for c in cols], jnp.asarray(idx),
            *[jnp.asarray(u) for u in upd])
        return [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_scatter_table_matches_reference_jit(shards, case):
    cols, idx, upd = scatter_case(case, shards)
    got = split(cols, shards)
    port.scatter_rows(got, torch.from_numpy(port.pack_scatter(idx, *upd)))
    for name, g, w, c in zip(NAMES, joined(got), reference(cols, idx, upd),
                             cols):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert (g != c).any(), name        # the scatter wrote rows


def parent_per_shard(split_cols, idx, upd):
    """The split's former route: the rows bucketed by owning shard with
    local indices (pad = local_n), one packed buffer and one single-shard
    scatter a shard that has rows."""
    shards = len(split_cols[0])
    ln = split_cols[0][0].shape[0]
    db = len(idx)
    for s in range(shards):
        mine = [j for j, i in enumerate(idx) if s * ln <= i < (s + 1) * ln]
        if not mine:
            continue
        local = np.full(db, ln, np.int32)
        local[:len(mine)] = idx[mine] - s * ln
        vals = [np.zeros_like(u) for u in upd]
        for v, u in zip(vals, upd):
            v[:len(mine)] = u[mine]
        port.scatter_rows(tuple(col[s] for col in split_cols),
                          torch.from_numpy(port.pack_scatter(local, *vals)))


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "negative"))
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_scatter_table_matches_per_shard_route(shards, case):
    cols, idx, upd = scatter_case(case, shards, seed=5)
    got, want = split(cols, shards), split(cols, shards)
    port.scatter_rows(got, torch.from_numpy(port.pack_scatter(idx, *upd)))
    parent_per_shard(want, idx, upd)
    for name, g, w in zip(NAMES, joined(got), joined(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_one_stage_scatters_every_shard(shards):
    """The resident tier's refresh on a split: the dirty rows staged in
    ONE buffer of the bucket with their global indices (pads at nb),
    refilled refresh after refresh, and one scatter over the shard
    table."""
    nb = 1024
    rng = np.random.RandomState(shards)
    host = _columns(rng, nb)
    dev = split(host, shards)
    stage = _ScatterStage(16, torch.device("cpu"))
    for step in range(3):
        rows = sorted(rng.choice(nb, 11, replace=False).tolist())
        for c in host:
            c[rows] = c[rows][::-1] if c.dtype == np.bool_ else c[rows] + 1
        stage.fill(rows, nb, host)
        packed = stage.upload()
        idx = port.scatter_views(packed, 16)[0].numpy()
        assert idx[:11].tolist() == rows and (idx[11:] == nb).all()
        port.scatter_rows(dev, packed)
        for name, g, h in zip(NAMES, joined(dev), host):
            np.testing.assert_array_equal(g, h, err_msg=f"{name} {step}")


def test_scatter_table_refuses_bad_tables():
    cols = split(_columns(np.random.RandomState(1), 64), 2)
    packed = torch.from_numpy(port.pack_scatter(
        np.full(16, 64, np.int32), *[np.zeros(16, t) for t in
                                     (bool, bool, np.int64, np.int64,
                                      np.int32)]))
    uneven = tuple((c[0], c[1][:-1]) for c in cols)
    with pytest.raises(ValueError, match="shape"):
        port.scatter_rows(uneven, packed)
    wrong = (cols[0], cols[1], cols[2], cols[3],
             tuple(t.to(torch.int64) for t in cols[4]))
    with pytest.raises(ValueError, match="total"):
        port.scatter_rows(wrong, packed)
    many = tuple(tuple(c[0][:2] for _ in range(port.MAX_LAUNCH_SHARDS + 1))
                 for c in cols)
    with pytest.raises(ValueError, match="shards"):
        port.scatter_rows(many, packed)
