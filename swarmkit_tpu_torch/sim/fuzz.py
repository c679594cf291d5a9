"""Randomized interleaving fuzzer.

Each seed drives the ``random-fuzz`` scenario: the entire fault
timeline — partitions, crashes (clean and truncated-WAL), leader churn,
drop bursts, agent faults, clock skew — is drawn deterministically from
that seed.  A failing seed therefore IS the counterexample: re-running
it reproduces the identical event trace byte-for-byte
(``python -m swarmkit_tpu_torch.sim --seed N --scenario random-fuzz``).
"""

from __future__ import annotations

from typing import List, Optional

from .scenario import FUZZ_POOL, SimReport, run_scenario


def fuzz(n_seeds: int, start_seed: int = 0,
         scenario: Optional[str] = "random-fuzz",
         progress=None, device=None) -> List[SimReport]:
    """Run ``n_seeds`` seeded simulations; returns every report (check
    ``.ok`` / ``.violations``).

    ``scenario=None`` rotates seeds through the whole registry pool
    (``scenario.FUZZ_POOL`` — every scenario except the documented
    exclusions, raft_cp rollout suite and legacy-rcp variants included),
    so fuzz coverage tracks the registry instead of silently lagging it;
    seed ``i`` runs ``FUZZ_POOL[i % len(FUZZ_POOL)]``, keeping each
    (scenario, seed) pair reproducible from the report alone.
    ``device`` goes to every run (None -> the card)."""
    reports = []
    for seed in range(start_seed, start_seed + n_seeds):
        name = scenario if scenario is not None \
            else FUZZ_POOL[seed % len(FUZZ_POOL)]
        report = run_scenario(name, seed, device=device)
        reports.append(report)
        if progress is not None:
            progress(report)
    return reports


def failures(reports: List[SimReport]) -> List[SimReport]:
    return [r for r in reports if not r.ok]


def pool_scenario(seed: int) -> str:
    """The scenario a pool-rotating fuzz run gives ``seed``."""
    return FUZZ_POOL[seed % len(FUZZ_POOL)]


def reproduce(seed: int, scenario: str = "random-fuzz",
              expect_hash: Optional[str] = None,
              device=None) -> SimReport:
    """Replay one seed; optionally assert the trace hash matches the
    original run (the determinism guarantee the whole subsystem rests
    on)."""
    report = run_scenario(scenario, seed, device=device)
    if expect_hash is not None and report.trace_hash != expect_hash:
        raise AssertionError(
            f"nondeterministic replay: trace hash {report.trace_hash} "
            f"!= expected {expect_hash}")
    return report
