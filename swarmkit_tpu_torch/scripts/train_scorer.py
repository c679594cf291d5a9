"""Offline trainer for the experimental learned placement scorer.

Produces the checked-in artifact ``swarmkit_tpu_torch/scheduler/
learned_scorer.json`` consumed by ``scheduler/strategy.learned_params``
and the device kernels (``ops/kernel.plan_strategy_packed`` and the
scored slot entry, strategy=learned).

The scorer is a tiny fixed-point MLP (6 features -> 8 hidden -> 1) whose
integer forward pass is EXACTLY the one both the host oracle and the
device kernel run (clip/shift formulas from scheduler/strategy.py) — the
trainer optimizes through that quantized forward, not a float proxy, so
what ships is what was fitted.

Training data: per-node feature rows sampled from seeded distributions
distilled from the ``sim/scenario.py`` steady-state-churn and
tenant-storm workloads (service-count geometrics under Poisson churn,
headroom profiles of the production-shaped arrival services, sparse
failure bursts).  The teacher is a robust load-balance score — spread
pressure plus saturating headroom terms plus a failure penalty — i.e.
the behavior the weighted strategy approximates linearly, with the
saturation nonlinearity the MLP's hidden layer can actually buy us.
Robust-scheduling framing per PAPERS.md 2302.05446 (GFlowNet-style
trajectory sampling is the stretch goal; this artifact is the
plumbing-complete distillation baseline).

Deterministic end to end: one seeded generator, no wall clock; re-running
with the same --seed reproduces the artifact byte for byte.

Usage:  python -m swarmkit_tpu_torch.scripts.train_scorer [--seed 7]
            [--samples 20000] [--out path.json]
"""

import argparse
import json
import os
import sys

import numpy as np

from ..scheduler.strategy import (
    FEAT_CLAMP, MLP_FEATURES, MLP_SHIFT, MLP_W_CLAMP, SCORE_CLAMP,
)

HIDDEN = 8


def sample_features(rng, n):
    """Feature rows shaped like the churn scenarios' node mirrors."""
    svc = np.minimum(rng.geometric(0.08, n) - 1, FEAT_CLAMP)
    total = np.minimum(svc + rng.geometric(0.02, n) - 1, FEAT_CLAMP)
    # failure bursts are sparse and clustered (preemption-storm shape)
    failures = np.where(rng.random(n) < 0.06,
                        rng.integers(1, 12, n), 0)
    # headroom: mixture of mostly-empty, mid-loaded and near-full nodes
    mode = rng.integers(0, 3, n)
    hr_cpu = np.select(
        [mode == 0, mode == 1],
        [rng.integers(700, FEAT_CLAMP + 1, n),
         rng.integers(100, 700, n)],
        rng.integers(0, 100, n))
    hr_mem = np.clip(hr_cpu + rng.integers(-80, 81, n), 0, FEAT_CLAMP)
    ready = np.where(rng.random(n) < 0.97, FEAT_CLAMP, 0)
    f = np.stack([svc, total, failures, hr_cpu, hr_mem, ready],
                 axis=-1).astype(np.int32)
    return np.clip(f, 0, FEAT_CLAMP)


def teacher_score(f):
    """Robust load-balance target, lower = preferred: spread pressure,
    saturating headroom preference, hard failure/not-ready penalties."""
    svc, total, failures, hr_cpu, hr_mem, ready = (
        f[:, i].astype(np.float64) for i in range(6))
    sat = lambda h: np.sqrt(np.maximum(h, 0.0) / FEAT_CLAMP)  # noqa: E731
    score = (40.0 * svc + 4.0 * total
             + 900.0 * (1.0 - sat(hr_cpu)) + 450.0 * (1.0 - sat(hr_mem))
             + 600.0 * np.minimum(failures, 8.0)
             + 4000.0 * (ready < FEAT_CLAMP / 2))
    return score


def int_forward_hidden(f, w1, b1):
    h = np.right_shift(f.astype(np.int64) @ w1 + b1, MLP_SHIFT)
    return np.clip(h, 0, FEAT_CLAMP)


def int_forward(f, w1, b1, w2, b2):
    h = int_forward_hidden(f, w1, b1)
    out = np.right_shift(h @ w2 + b2, MLP_SHIFT)
    return np.clip(out, 0, SCORE_CLAMP)


def fit(seed, n_samples):
    rng = np.random.default_rng(seed)
    f = sample_features(rng, n_samples)
    y = teacher_score(f)

    best = None
    # random-feature fit through the QUANTIZED forward: draw int8 first
    # layers, solve the second layer by least squares on the integer
    # hidden activations, quantize, keep the best candidate by Spearman
    # rank correlation (ordering is all a scorer is judged on)
    for draw in range(24):
        w1 = rng.integers(-MLP_W_CLAMP, MLP_W_CLAMP + 1,
                          (len(MLP_FEATURES), HIDDEN)).astype(np.int32)
        b1 = rng.integers(-(1 << 12), 1 << 12, HIDDEN).astype(np.int32)
        h = int_forward_hidden(f, w1, b1).astype(np.float64)
        # least squares h @ w2f ~= y * 2^SHIFT (the final shift undoes it)
        target = y * (1 << MLP_SHIFT)
        a = np.concatenate([h, np.ones((len(h), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(a, target, rcond=None)
        scale = max(np.abs(sol[:-1]).max() / MLP_W_CLAMP, 1.0)
        w2 = np.clip(np.round(sol[:-1] / scale), -MLP_W_CLAMP,
                     MLP_W_CLAMP).astype(np.int32)
        b2 = np.int32(np.clip(round(sol[-1] / scale), -(1 << 20),
                              1 << 20))
        pred = int_forward(f, w1, b1, w2, b2).astype(np.float64)
        # Spearman via rank correlation
        ra = np.argsort(np.argsort(pred))
        rb = np.argsort(np.argsort(y))
        rho = float(np.corrcoef(ra, rb)[0, 1])
        if best is None or rho > best[0]:
            best = (rho, draw, w1, b1, w2, b2)
    return f, y, best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--samples", type=int, default=20_000)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scheduler", "learned_scorer.json"))
    args = ap.parse_args(argv)

    f, y, (rho, draw, w1, b1, w2, b2) = fit(args.seed, args.samples)
    holdout = sample_features(np.random.default_rng(args.seed + 1), 4096)
    pred = int_forward(holdout, w1, b1, w2, b2).astype(np.float64)
    yh = teacher_score(holdout)
    ra = np.argsort(np.argsort(pred))
    rb = np.argsort(np.argsort(yh))
    rho_holdout = float(np.corrcoef(ra, rb)[0, 1])

    artifact = {
        "format": "swarm-learned-scorer-v1",
        "features": list(MLP_FEATURES),
        "hidden": HIDDEN,
        "shift": MLP_SHIFT,
        "w1": w1.tolist(),
        "b1": b1.tolist(),
        "w2": w2.tolist(),
        "b2": int(b2),
        "provenance": {
            # the trainer that made the shipped artifact, which both
            # packages hold byte for byte
            "trainer": "scripts/train_scorer.py",
            "seed": args.seed,
            "samples": args.samples,
            "draw": draw,
            "teacher": "spread+saturating-headroom+failure penalty "
                       "(sim/scenario.py churn-shaped distributions)",
            "spearman_train": round(rho, 4),
            "spearman_holdout": round(rho_holdout, 4),
        },
    }
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {args.out}: spearman train={rho:.4f} "
          f"holdout={rho_holdout:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
