"""The port's strategy kernels (plain PyTorch versions, on the CPU) against
the JAX reference on JAX's CPU backend.

Inputs are made with numpy from a seed in the reference's own layout and
handed to both: the reference as jax arrays, the port through
``swarmkit_tpu_torch.ops.convert``.  Every output is an integer, so the
tolerance is bit-equality.  Covered: ``seg_packfill`` (the binpack fill,
including a group larger than the whole capacity and a group that ends
exactly at a node), ``strategy_score`` (weighted with weights 0 and
``W_CLAMP``, learned with the shipped scorer and with a scorer whose
pre-activations go negative) and ``plan_strategy`` for binpack, weighted
and learned.
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
from swarmkit_tpu_torch.ops.convert import (  # noqa: E402
    named_to_device, tensor, to_device,
)
from swarmkit_tpu_torch.scheduler import strategy as strategy_mod  # noqa: E402

BINPACK, WEIGHTED, LEARNED = (strategy_mod.STRAT_BINPACK,
                              strategy_mod.STRAT_WEIGHTED,
                              strategy_mod.STRAT_LEARNED)


def _np(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t)


def strategy_to_device(sin):
    return named_to_device(port.StrategyInputs, sin, "cpu")


def _jax(tup):
    return type(tup)(*[None if v is None else jnp.asarray(v) for v in tup])


# ------------------------------------------------------------- input maker

def make_inputs(seed, n=512, k=300, cap_hi=12):
    """Seeded NodeInputs/GroupInputs (reference numpy layout) with one
    != constraint and a catch-all platform row, so most nodes stay
    feasible; failures cross MAX_FAILURES on some nodes."""
    rng = np.random.RandomState(seed)
    valid = np.zeros(n, bool)
    valid[:n - 9] = True
    nodes = ref.NodeInputs(
        valid=valid,
        ready=rng.rand(n) < 0.92,
        res_ok=rng.rand(n) < 0.92,
        res_cap=rng.randint(0, cap_hi, n).astype(np.int32),
        svc_tasks=rng.randint(0, 9, n).astype(np.int32),
        total_tasks=rng.randint(0, 1500, n).astype(np.int32),
        failures=rng.choice([0, 0, 0, 1, 5, 7, 70], n).astype(np.int32),
        leaf=np.zeros(n, np.int32),
        os_hash=rng.randint(0, 3, (2, n)).astype(np.int32),
        arch_hash=rng.randint(0, 3, (2, n)).astype(np.int32),
        port_conflict=rng.rand(n) < 0.2,
        extra_mask=rng.rand(n) < 0.95,
        quota_ok=None)
    con_op = np.full(4, 2, np.int32)
    con_op[0] = 1
    plat = np.full((4, 4), -1, np.int32)
    plat[0] = 0
    group = ref.GroupInputs(
        k=np.int32(k),
        con_hash=rng.randint(0, 2, (4, 2, n)).astype(np.int32),
        con_op=con_op,
        con_exp=rng.randint(0, 2, (4, 2)).astype(np.int32),
        plat=plat, maxrep=np.int32(0), port_limited=np.bool_(False))
    return nodes, group


def make_strategy(seed, n, weights=(1, 1, 1, 1), params=None):
    """Seeded StrategyInputs: headrooms across [0, HR_CLAMP], the given
    weighted terms, and the learned scorer ``params`` (default: the
    shipped artifact)."""
    rng = np.random.RandomState(seed + 500)
    hr = strategy_mod.HR_CLAMP
    w1, b1, w2, b2 = params if params is not None \
        else strategy_mod.learned_params()
    return ref.StrategyInputs(
        hr_cpu=rng.randint(0, hr + 1, n).astype(np.int32),
        hr_mem=rng.randint(0, hr + 1, n).astype(np.int32),
        hr_gen=rng.choice([hr, 0, 7, 300], n).astype(np.int32),
        weights=np.asarray(weights, np.int32),
        w1=np.asarray(w1, np.int32), b1=np.asarray(b1, np.int32),
        w2=np.asarray(w2, np.int32), b2=np.asarray(b2, np.int32))


def negative_scorer(seed):
    """An MLP inside the artifact's clamps whose hidden pre-activations
    go negative on most nodes (so >> must shift arithmetically)."""
    rng = np.random.RandomState(seed)
    f = len(strategy_mod.MLP_FEATURES)
    w = strategy_mod.MLP_W_CLAMP
    return (rng.randint(-w, w // 3, (f, 8)).astype(np.int32),
            rng.randint(-w, w + 1, 8).astype(np.int32),
            rng.randint(-w, w + 1, 8).astype(np.int32),
            np.int32(rng.randint(-w, w + 1)))


def hidden_scorer(seed, hidden):
    """A seeded MLP of ``hidden`` units inside the artifact's clamps (the
    score epilogue stages 1..64)."""
    rng = np.random.RandomState(seed)
    f = len(strategy_mod.MLP_FEATURES)
    w = strategy_mod.MLP_W_CLAMP
    return (rng.randint(-w, w + 1, (f, hidden)).astype(np.int32),
            rng.randint(-w, w + 1, hidden).astype(np.int32),
            rng.randint(-w, w + 1, hidden).astype(np.int32),
            np.int32(rng.randint(-w, w + 1)))


# ----------------------------------------------------------- seg_packfill

def packfill_case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    n = 400
    idx = np.arange(n)
    score = rng.randint(0, strategy_mod.BP_CLAMP + 1, n)
    key = ((score << ref.IDX_BITS) | idx).astype(np.int32)
    cap = rng.randint(0, 9, n).astype(np.int32)
    seg = np.zeros(n, np.int32)
    L = 1
    if name == "small_k":
        k = [5]
    elif name == "at_threshold":
        # k ends exactly at a node: the node at the threshold takes its
        # whole capacity as the remainder
        order = np.argsort(key)
        k = [int(np.cumsum(cap[order])[57])]
    elif name == "over_capacity":
        # more than the whole capacity: thr stays 2^30, every node full
        k = [int(cap.sum()) + 11]
    elif name == "zero_k":
        k = [0]
    elif name == "segments":
        L = 3
        seg = rng.randint(0, L, n).astype(np.int32)
        total = np.bincount(seg, weights=cap, minlength=L).astype(int)
        k = [total[0] // 2, total[1] + 4, 1]
    else:
        raise KeyError(name)
    return key, cap, np.asarray(k, np.int32), seg, L


@pytest.mark.parametrize("case", ["small_k", "at_threshold", "over_capacity",
                                  "zero_k", "segments"])
def test_seg_packfill_matches_reference(case):
    key, cap, k_seg, seg, L = packfill_case(case)
    want = np.asarray(ref.seg_packfill(jnp.asarray(key), jnp.asarray(cap),
                                       jnp.asarray(k_seg), jnp.asarray(seg),
                                       L))
    got = port.seg_packfill(*(tensor(a, "cpu") for a in (key, cap, k_seg,
                                                         seg)), L)
    np.testing.assert_array_equal(_np(got), want)
    if case == "over_capacity":
        np.testing.assert_array_equal(want, cap)
    if case == "at_threshold":
        assert want.sum() == k_seg[0]


def test_binpack_key_matches_reference_formula():
    nodes, _ = make_inputs(3)
    pn, _, _ = to_device(nodes, make_inputs(3)[1], device="cpu")
    got = _np(port._binpack_key(pn.res_cap, pn.failures))
    want = strategy_mod.binpack_key(nodes.res_cap, nodes.failures,
                                    np.arange(len(nodes.res_cap)))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- strategy_score

SCORE_CASES = {
    "weighted_ones": (WEIGHTED, dict(weights=(1, 1, 1, 1))),
    "weighted_extremes": (WEIGHTED, dict(
        weights=(0, strategy_mod.W_CLAMP, strategy_mod.W_CLAMP, 0))),
    "weighted_max": (WEIGHTED, dict(weights=(strategy_mod.W_CLAMP,) * 4)),
    "learned_shipped": (LEARNED, dict()),
    "learned_negative": (LEARNED, dict(params=negative_scorer(4))),
    "spread": (strategy_mod.STRAT_SPREAD, dict()),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_strategy_score_matches_reference(case):
    strategy, kw = SCORE_CASES[case]
    nodes, group = make_inputs(21)
    if case == "weighted_max":
        nodes = nodes._replace(svc_tasks=np.full_like(
            nodes.svc_tasks, ref.SVC_CLAMP + 5))
    sin = make_strategy(21, len(nodes.valid), **kw)
    want = np.asarray(ref.strategy_score(_jax(nodes), _jax(sin), strategy))
    pn, _, _ = to_device(nodes, group, device="cpu")
    got = port.strategy_score(pn, strategy_to_device(sin), strategy)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    if strategy == LEARNED:
        feats = strategy_mod.learned_features(
            nodes.svc_tasks, nodes.total_tasks, nodes.failures, sin.hr_cpu,
            sin.hr_mem, nodes.ready)
        pre = feats @ sin.w1 + sin.b1
        assert (pre < 0).any() and (pre > 0).any(), \
            "the case must reach negative pre-activations"


def test_learned_score_matches_host_oracle():
    nodes, group = make_inputs(8)
    sin = make_strategy(8, len(nodes.valid))
    feats = strategy_mod.learned_features(
        nodes.svc_tasks, nodes.total_tasks, nodes.failures, sin.hr_cpu,
        sin.hr_mem, nodes.ready)
    want = strategy_mod.learned_score_host(feats, (sin.w1, sin.b1, sin.w2,
                                                   sin.b2))
    pn, _, _ = to_device(nodes, group, device="cpu")
    got = port._learned_score(pn, strategy_to_device(sin))
    np.testing.assert_array_equal(_np(got), want)


# ----------------------------------------------------------- plan_strategy

PLAN_CASES = {
    "binpack": (BINPACK, dict()),
    "binpack_over_capacity": (BINPACK, dict(k=100000)),
    "binpack_tight": (BINPACK, dict(k=40, cap_hi=3)),
    "weighted": (WEIGHTED, dict()),
    "weighted_cpu_heavy": (WEIGHTED, dict(weights=(1, 9, 0, 2))),
    "learned": (LEARNED, dict()),
    "learned_negative": (LEARNED, dict(params=negative_scorer(9), k=900)),
    # K1's score epilogue at the ends of its staged MLP
    "learned_hidden1": (LEARNED, dict(params=hidden_scorer(5, 1))),
    "learned_hidden64": (LEARNED, dict(params=hidden_scorer(6, 64), k=900)),
    "spread_score": (strategy_mod.STRAT_SPREAD, dict()),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_strategy_matches_reference_jit(case):
    strategy, kw = PLAN_CASES[case]
    kw = dict(kw)
    sin_kw = {key: kw.pop(key) for key in ("weights", "params") if key in kw}
    nodes, group = make_inputs(33 + len(case), **kw)
    sin = make_strategy(33, len(nodes.valid), **sin_kw)
    x_r, f_r, s_r = ref.plan_strategy_jit(_jax(nodes), _jax(group),
                                          _jax(sin), strategy)
    pn, pg, _ = to_device(nodes, group, device="cpu")
    x_p, f_p, s_p = port.plan_strategy(pn, pg, strategy_to_device(sin),
                                       strategy)
    np.testing.assert_array_equal(_np(x_p), np.asarray(x_r))
    np.testing.assert_array_equal(_np(f_p), np.asarray(f_r))
    assert bool(s_p) is bool(s_r) is False
    assert 0 < int(_np(x_p).sum()) <= int(group.k)
