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
must be bit-equal.  For a weighted or learned slot the scored launch's
level e (K6's score, the entry's epilogue) must equal the reference
step's ``strategy_score`` on the same columns (``:702-712``), for MLPs of
1, 8 and 64 hidden units, negative pre-activations, svc and headroom at
their clamps, failures at and above MAX_FAILURES and a slot repeating the
previous slot's service.  Out-of-range service slots follow the
reference's jnp indexing: a read wraps a negative slot and clamps, a
scatter wraps and drops.  A whole chunk with such slots is held to
``plan_fused_jit``.
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
from swarmkit_tpu_torch.scheduler import strategy as strategy_mod  # noqa
from swarmkit_tpu_torch.scheduler.nodeinfo import MAX_FAILURES  # noqa

WEIGHTED, LEARNED = strategy_mod.STRAT_WEIGHTED, strategy_mod.STRAT_LEARNED


def _ref_step(shared, groups, carry, g, x_prev, strat=None, sid=0):
    """The reference's scan step for slot ``g`` up to the plan: slot
    g - 1's placements into the carry, then slot g's columns and
    ``feasibility_and_capacity``, as ``plan_fused``'s ``step`` writes them
    (the slots traced, as under ``lax.scan``), and with ``strat`` the
    slot's ``strategy_score`` under strategy ``sid`` (else None).

    ``step`` below is a copy of the reference's lines, not a call: the
    carry update of ``swarmkit_tpu/ops/kernel.py:715-719``, the columns
    of ``:668-677`` and the score's inputs of ``:702-708``.
    ``plan_fused``'s own ``step`` is a closure that also runs the fill, so
    it cannot be called for the entry alone; a mistake this copy shared
    with the port would pass here, and the chunk tests against
    ``plan_fused_jit`` (below, and ``test_torch_fused.py``) are what hold
    the reference's own step."""

    def step(shared, gi, gp, carry, x, sw, sid):
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
        hr_cpu = ref._fused_headroom(state.cpu, gi["cpu_d"])
        hr_mem = ref._fused_headroom(state.mem, gi["mem_d"])
        e = None
        if sw is not None:
            sin = ref.StrategyInputs(
                hr_cpu=hr_cpu, hr_mem=hr_mem,
                hr_gen=jnp.full(res_cap.shape, ref.HR_CLAMP, jnp.int32),
                weights=sw["weights"], w1=sw["w1"], b1=sw["b1"],
                w2=sw["w2"], b2=sw["b2"])
            e = ref.strategy_score(nodes, sin, sid)
        return (mask, cap, fail, res_ok, res_cap, svc, hr_cpu, hr_mem, e,
                state)

    def at(i):
        return {name: getattr(groups, name)[i] for name in groups._fields}

    sw = None if strat is None else dict(
        weights=strat.weights[g], w1=strat.w1, b1=strat.b1, w2=strat.w2,
        b2=strat.b2)
    with jax.enable_x64(True):
        out = jax.jit(step, static_argnames=("sid",))(
            ref.FusedShared(*shared), at(g),
            at(g - 1) if x_prev is not None else None,
            ref.FusedCarry(*carry), x_prev, sw, sid=sid)
        return jax.device_get(out)


def _port_step(shared, groups, carry, g, x_prev, strat=None, sid=0):
    sh, gr, ca, st = fused_to_device(shared, groups, carry, strat,
                                     device="cpu")
    x = None if x_prev is None else torch.from_numpy(x_prev.copy())
    s = sh.svc0.shape[0]
    out = port._fused_feasibility_plain(sh, gr, ca, g, s, x, st, sid)
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
    (capacity, fail counts into a zeroed slot, svc, res_cap; a scored
    call the level e in place of res_cap) and updates the carry as the
    plain version does."""
    shared, groups, carry, g, x_prev = fused_entry_inputs(11, case)
    strat = _score_strategy(11, len(groups.k), 8)
    for sid in (strategy_mod.STRAT_BINPACK, LEARNED):
        (want, want_carry) = _port_step(shared, groups, carry, g, x_prev,
                                        strat, sid)
        sh, gr, ca, st = fused_to_device(shared, groups, carry, strat,
                                         device="cpu")
        n = sh.valid.shape[0]
        cols = [torch.full((n,), -1, dtype=torch.int32) for _ in range(3)]
        fail = torch.zeros(port.N_FILTERS, dtype=torch.int32)
        x = None if x_prev is None else torch.from_numpy(x_prev.copy())
        scored = sid == LEARNED
        port._fused_feasibility(
            sh, gr, ca, g, sh.svc0.shape[0], x, fail, cols[0], cols[1],
            None if scored else cols[2], st if scored else None, sid,
            cols[2] if scored else None)
        for got, w in zip([cols[0], fail, cols[1], cols[2]],
                          [want[1], want[2], want[5],
                           want[8] if scored else want[4]]):
            _eq(got, w.numpy(), "wrapper column")
        for a, b in zip(ca, want_carry):
            _eq(a, b.numpy(), "carry")


def _score_strategy(seed, g_count, hidden, negative=False):
    """A seeded FusedStrategy (numpy): weighted terms within W_CLAMP per
    slot and a learned scorer of ``hidden`` units within the artifact's
    clamps (``negative``: pre-activations mostly below zero)."""
    rng = np.random.RandomState(seed)
    w, f = strategy_mod.MLP_W_CLAMP, len(strategy_mod.MLP_FEATURES)
    hi = w // 3 if negative else w + 1
    return port.FusedStrategy(
        sid=np.full(g_count, WEIGHTED, np.int32),
        weights=rng.randint(0, strategy_mod.W_CLAMP + 1,
                            (g_count, 4)).astype(np.int32),
        w1=rng.randint(-w, hi, (f, hidden)).astype(np.int32),
        b1=rng.randint(-w, hi, hidden).astype(np.int32),
        w2=rng.randint(-w, w + 1, hidden).astype(np.int32),
        b2=np.int32(rng.randint(-w, w + 1)))


#: the scored slot's cases: (slot-entry case, hidden units, what it pushes)
SCORE_ENTRY_CASES = {
    "hidden1": ("carried_x", 1, None),
    "hidden8": ("carried_x", 8, None),
    "hidden64": ("carried_x", 64, None),
    "negative_preactivations": ("carried_x", 8, "negative"),
    "at_clamps": ("carried_x", 8, "clamps"),
    "failures_at_max": ("carried_x", 8, "failures"),
    "repeat_service": ("repeat_service", 8, None),
    "first_slot": ("first_slot", 8, None),
}


@pytest.mark.parametrize("sid", [WEIGHTED, LEARNED])
@pytest.mark.parametrize("case", sorted(SCORE_ENTRY_CASES))
def test_fused_score_plain_matches_reference_step(case, sid):
    """The scored slot entry's level e (plain version) against the
    reference step's ``strategy_score`` on the same columns."""
    entry_case, hidden, push = SCORE_ENTRY_CASES[case]
    shared, groups, carry, g, x_prev = fused_entry_inputs(
        13 + hidden, entry_case)
    strat = _score_strategy(17 + hidden, len(groups.k), hidden,
                            negative=push == "negative")
    rng = np.random.RandomState(23)
    nb = shared.valid.shape[0]
    if push == "clamps":
        # svc past both clamps, headroom at HR_CLAMP and at 0
        svc0 = shared.svc0.copy()
        svc0[:, ::7] = port.SVC_CLAMP + 3
        svc0[:, 3::7] = strategy_mod.FEAT_CLAMP + 1
        shared = shared._replace(svc0=svc0)
        cpu, mem = carry.cpu.copy(), carry.mem.copy()
        cpu[::5] = 5000 * groups.cpu_d[g]
        mem[1::5] = 5000 * groups.mem_d[g]
        cpu[2::5] = 0
        carry = carry._replace(cpu=cpu, mem=mem)
        strat = strat._replace(weights=np.full_like(strat.weights,
                                                    strategy_mod.W_CLAMP))
    if push == "failures":
        failures = groups.failures.copy()
        failures[g] = rng.choice(
            [0, MAX_FAILURES - 1, MAX_FAILURES, MAX_FAILURES + 1,
             port.FAILURE_CLAMP, port.FAILURE_CLAMP + 1, 500], nb)
        groups = groups._replace(failures=failures)
    want = _ref_step(shared, groups, carry, g, x_prev, strat, sid)
    got, _ = _port_step(shared, groups, carry, g, x_prev, strat, sid)
    _eq(got[8], want[8], "e")
    for name, a, b in zip(("mask", "cap", "svc"), (got[0], got[1], got[5]),
                          (want[0], want[1], want[5])):
        _eq(a, b, name)
    e = np.asarray(want[8])
    # the cases reach what they name
    if push == "clamps":
        assert (np.asarray(want[6]) == port.HR_CLAMP).any()
        assert (np.asarray(want[6]) == 0).any()
        assert (np.asarray(want[5]) > port.SVC_CLAMP).any()
    if push == "failures":
        f = groups.failures[g]
        assert ((f == MAX_FAILURES) & (e >= port.F_BIG)).any()
        assert ((f == MAX_FAILURES - 1) & (e < port.F_BIG)).any() \
            or sid == WEIGHTED
    if push == "negative" and sid == LEARNED:
        feats = strategy_mod.learned_features(
            np.asarray(want[5]), np.asarray(want[9].total),
            groups.failures[g], np.asarray(want[6]), np.asarray(want[7]),
            shared.ready)
        pre = feats @ strat.w1 + strat.b1
        assert (pre < 0).mean() > 0.5


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
