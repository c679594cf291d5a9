"""The fused route's slot entry (K1F) on the CPU, against the reference.

``_fused_feasibility_plain`` is the plain version of the port's slot-entry
kernel: the previous slot's placements added into the carry, this slot's
resource columns derived from it, and the filter pipeline on them.  The
reference does the same inside one ``lax.scan`` step of ``plan_fused``
(``swarmkit_tpu/ops/kernel.py:669-678`` for the columns, ``:692-694`` for
the headroom, ``:715-719`` for the carry) around
``feasibility_and_capacity`` (``:190``).  Here that step runs under
``jax.jit`` and x64 on the reference's own functions, on seeded numpy
inputs handed to both (``chip_smoke.fused_entry_inputs``); mask,
capacity, fail counts, svc, res_cap, the headroom and the updated carry
must be bit-equal.  Out-of-range service slots follow the reference's jnp
indexing: a read wraps a negative slot and clamps, a scatter wraps and
drops.  A whole chunk with such slots is held to ``plan_fused_jit``.
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
    FUSED_ENTRY_CASES, fused_entry_inputs, fused_inputs)
from swarmkit_tpu.ops import kernel as ref  # noqa: E402
from swarmkit_tpu_torch.ops import kernel as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import fused_to_device  # noqa: E402


def _ref_step(shared, groups, carry, g, x_prev):
    """The reference's scan step for slot ``g`` up to the plan: slot
    g - 1's placements into the carry, then slot g's columns and
    ``feasibility_and_capacity``, as ``plan_fused``'s ``step`` writes them
    (the slots traced, as under ``lax.scan``).

    ``step`` below is a copy of the reference's lines, not a call: the
    carry update of ``swarmkit_tpu/ops/kernel.py:715-719`` and the columns
    of ``:668-677``.  ``plan_fused``'s own ``step`` is a closure that also
    runs the fill, so it cannot be called for the entry alone; a mistake
    this copy shared with the port would pass here, and the chunk tests
    against ``plan_fused_jit`` (below, and ``test_torch_fused.py``) are
    what hold the reference's own step."""

    def step(shared, gi, gp, carry, x):
        state = carry
        if x is not None:
            state = ref.FusedCarry(
                total=state.total + x,
                cpu=state.cpu - x.astype(state.cpu.dtype) * gp["cpu_d"],
                mem=state.mem - x.astype(state.mem.dtype) * gp["mem_d"],
                svc_acc=state.svc_acc.at[gp["slot"]].add(x))
        res_ok = shared.valid
        cap = jnp.full(state.cpu.shape, ref.K_CLAMP, state.cpu.dtype)
        for avail, d in ((state.cpu, gi["cpu_d"]), (state.mem, gi["mem_d"])):
            have = d > 0
            res_ok = res_ok & (~have | (avail >= d))
            cap = jnp.where(
                have, jnp.minimum(cap, avail // jnp.maximum(d, 1)), cap)
        res_cap = jnp.clip(cap, 0, ref.K_CLAMP).astype(jnp.int32)
        svc = shared.svc0[gi["slot"]] + state.svc_acc[gi["slot"]]
        nodes = ref.NodeInputs(
            valid=shared.valid, ready=shared.ready, res_ok=res_ok,
            res_cap=res_cap, svc_tasks=svc, total_tasks=state.total,
            failures=gi["failures"], leaf=gi["leaf"],
            os_hash=shared.os_hash, arch_hash=shared.arch_hash,
            port_conflict=jnp.zeros_like(shared.valid),
            extra_mask=gi["extra_mask"], quota_ok=gi["quota_ok"])
        grp = ref.GroupInputs(
            k=gi["k"], con_hash=gi["con_hash"], con_op=gi["con_op"],
            con_exp=gi["con_exp"], plat=gi["plat"], maxrep=gi["maxrep"],
            port_limited=jnp.zeros((), jnp.bool_))
        mask, cap, fail = ref.feasibility_and_capacity(nodes, grp)
        return (mask, cap, fail, res_ok, res_cap, svc,
                ref._fused_headroom(state.cpu, gi["cpu_d"]),
                ref._fused_headroom(state.mem, gi["mem_d"]), state)

    def at(i):
        return {name: getattr(groups, name)[i] for name in groups._fields}

    with jax.enable_x64(True):
        out = jax.jit(step)(
            ref.FusedShared(*shared), at(g),
            at(g - 1) if x_prev is not None else None,
            ref.FusedCarry(*carry), x_prev)
        return jax.device_get(out)


def _port_step(shared, groups, carry, g, x_prev):
    sh, gr, ca, _ = fused_to_device(shared, groups, carry, device="cpu")
    x = None if x_prev is None else torch.from_numpy(x_prev.copy())
    s = sh.svc0.shape[0]
    out = port._fused_feasibility_plain(sh, gr, ca, g, s, x)
    return out, ca


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("nb", [1024, 4096])
@pytest.mark.parametrize("case", FUSED_ENTRY_CASES)
def test_fused_feasibility_plain_matches_reference_step(case, nb):
    shared, groups, carry, g, x_prev = fused_entry_inputs(7, case, nb=nb)
    *want, want_carry = _ref_step(shared, groups, carry, g, x_prev)
    got, got_carry = _port_step(shared, groups, carry, g, x_prev)
    names = ("mask", "cap", "fail_counts", "res_ok", "res_cap", "svc",
             "hr_cpu", "hr_mem")
    for name, a, b in zip(names, got, want):
        _eq(a, b, name)
    for name, a, b in zip(port.FusedCarry._fields, got_carry, want_carry):
        _eq(a, b, f"carry.{name}")
    # the cases reach what they name
    cap, fail = want[1], want[2]
    assert int(fail.sum()) > 0
    if case == "padding_slot":
        assert int(groups.k[g]) == 0 and int(cap.sum()) == 0
    else:
        assert int(cap.sum()) > 0
    if case in ("short_of_demand", "negative_carry"):
        assert int(fail[1]) > 0                  # resources rejected nodes
    if case == "negative_carry":
        assert (want_carry.cpu < 0).any() and (want_carry.mem < 0).any()


@pytest.mark.parametrize("case", FUSED_ENTRY_CASES)
def test_fused_feasibility_wrapper_on_cpu_writes_plain(case):
    """The CPU route of the K1F wrapper writes the plain version's columns
    (capacity, fail counts into a zeroed slot, svc, res_cap, headroom) and
    updates the carry as the plain version does."""
    shared, groups, carry, g, x_prev = fused_entry_inputs(11, case)
    (want, want_carry) = _port_step(shared, groups, carry, g, x_prev)
    sh, gr, ca, _ = fused_to_device(shared, groups, carry, device="cpu")
    n = sh.valid.shape[0]
    cols = [torch.full((n,), -1, dtype=torch.int32) for _ in range(5)]
    fail = torch.zeros(port.N_FILTERS, dtype=torch.int32)
    x = None if x_prev is None else torch.from_numpy(x_prev.copy())
    port._fused_feasibility(sh, gr, ca, g, sh.svc0.shape[0], x, fail,
                            cols[0], cols[1], cols[2], cols[3], cols[4])
    for got, w in zip([cols[0], fail, cols[1], cols[2], cols[3], cols[4]],
                      [want[1], want[2], want[5], want[4], want[6],
                       want[7]]):
        _eq(got, w.numpy(), "wrapper column")
    for a, b in zip(ca, want_carry):
        _eq(a, b.numpy(), "carry")


@pytest.mark.parametrize("slots", [(7, 9, -1, -8), (-1, -1, 5, 0),
                                   (0, 0, 0, 40)])
def test_plan_fused_with_out_of_range_slots_matches_reference_jit(slots):
    """A mixed-strategy chunk whose service slots lie outside [0, S) or
    wrap from the end plans and carries as ``plan_fused_jit``."""
    shared, groups, carry, strat, L = fused_inputs(
        19, nb=1024, n_valid=1000, strategies=(0, 1, 2, 3), n_slots=6)
    groups = groups._replace(slot=np.array(slots, np.int32),
                             k=np.full(4, 900, np.int32))
    with jax.enable_x64(True):
        want = jax.device_get(ref.plan_fused_jit(
            ref.FusedShared(*shared), ref.FusedGroups(*groups),
            ref.FusedCarry(*carry), L,
            strat=ref.FusedStrategy(*strat)))
    sh, gr, ca, st = fused_to_device(shared, groups, carry, strat,
                                     device="cpu")
    x, fail, spill, got_carry = port.plan_fused(sh, gr, ca, L, st,
                                                strat.sid.tolist())
    for name, a, b in zip(("x", "fail_counts", "spill"), (x, fail, spill),
                          want[:3]):
        _eq(a, b, name)
    assert int(np.asarray(want[0]).sum()) > 0
    for name, a, b in zip(port.FusedCarry._fields, got_carry, want[3]):
        _eq(a, b, f"carry.{name}")
