"""The least time a plan needs on one H100, from what it asked for.

A frozen copy of ``chip_smoke.py``'s counts (``feasibility_bytes`` and
the K2 and K3 rows of ``phase_kernels``; PERF.md's "Bytes counted"):
each column a kernel needs is read once, each result written once.  The
work is counted from the plan a tick asked for -- its nodes, constraints,
platforms, spread levels -- and not from which kernels ran, so a change
that fuses or drops a kernel is read against the same work.  ``nodes``
is the cluster's node count, not the program's padded bucket.

The peaks are NVIDIA's published H100 SXM figures at 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # device memory bandwidth
SCALAR_OPS_PER_S = 67e12       # 32-bit rate outside the tensor cores
#: the water-fill's binary searches over the level and the tie key, and
#: its two passes (``ops/kernel.py`` LEVEL_ITERS + TIE_ITERS + 2)
FILL_STEPS = 34 + 34 + 2


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def platform_bytes(platforms) -> int:
    """Bytes a node of the platform hashes: 8 for the os, 8 for the
    architecture, where some platform names one (none where one of them
    is the full wildcard)."""
    rows = [(p.get("os", ""), p.get("arch", "")) for p in platforms]
    if not rows or ("", "") in rows:
        return 0
    return 8 * any(os for os, _ in rows) + 8 * any(a for _, a in rows)


def feasibility(nodes: int, constraints: int, platforms) -> float:
    """K1: valid, ready, res_ok, extra_mask and res_cap read, capacity
    and mask written (13 B a node), each constraint's value hash (8 B),
    the platform hashes, and the eight fail counts."""
    per_node = 13 + 8 * constraints + platform_bytes(platforms)
    ops = nodes * (8 + 3 * constraints + 6 * len(platforms))
    return bound_s(nodes * per_node + 4 * 8, ops)


def branch_sums(nodes: int, leaves: int) -> float:
    """K2: a node's service count, validity, capacity and branch id read
    (13 B), a branch's four sums written (16 B)."""
    return bound_s(nodes * 13 + leaves * 16 + 4, 2 * nodes)


def water_fill(elements: int, segments: int) -> float:
    """K3: level, capacity, tie key, segment, placement and one more
    column per element (24 B), a segment's target (4 B)."""
    return bound_s(elements * 24 + segments * 4,
                   FILL_STEPS * elements * 4)


def plan_seconds(work: dict) -> float:
    """The least time of one plan: ``kind`` ``validate`` (a preassigned
    check: K1) or ``place`` (K1; per spread level the branch sums and the
    fill over its branches; the fill over the nodes of each leaf)."""
    n = work["nodes"]
    t = feasibility(n, work["constraints"], work["platforms"])
    if work["kind"] == "validate":
        return t
    parents = 1
    levels = work["levels"]
    for leaves in levels:
        t += branch_sums(n, leaves) + water_fill(leaves, parents)
        parents = leaves
    if not levels:
        t += branch_sums(n, 1)
    return t + water_fill(n, parents)
