"""Seeded distribution samplers for synthetic workloads.

One definition, so every seeded churn script draws from the same
distribution.
"""

from __future__ import annotations

import math


def poisson(rng, lam: float) -> int:
    """Knuth's inversion sampler off an injected ``random.Random`` --
    deterministic per seed, no numpy draw-order coupling."""
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1
