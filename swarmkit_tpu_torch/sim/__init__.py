"""Deterministic simulation & fault injection for the swarmkit-tpu
control plane.

FoundationDB-style testing: the whole cluster — raft consensus members,
the leader's scheduler + dispatcher, and worker agents — runs inside ONE
single-threaded event loop under a virtual clock and a seeded RNG.  Every
run is a pure function of its seed: the same seed produces a
byte-identical event trace, so any invariant violation the randomized
fuzzer finds replays exactly from its printed seed.

Layout:

* ``clock``       — virtual clock installed into models.types.now()
* ``engine``      — seeded event loop with trace recording
* ``faults``      — simulated network (drop/delay/duplicate/partition)
  and the fault-op vocabulary scenarios and the fuzzer share
* ``cluster``     — SimCluster: RaftCore members with in-memory WALs +
  a control plane (real Scheduler/Dispatcher driven synchronously) +
  sim agents
* ``invariants``  — safety checkers (single-leader-per-term, no
  committed-entry loss, FSM monotonicity, assignment safety, ...)
* ``scenario``    — named scenarios + the runner producing SimReport
* ``fuzz``        — randomized fault-schedule fuzzer over seed ranges

CLI::

    python -m swarmkit_tpu_torch.sim --seed 7 --scenario partition-churn
    python -m swarmkit_tpu_torch.sim --fuzz 50
"""

from .clock import VirtualClock
from .engine import SimEngine
from .faults import SimNetwork
from .invariants import InvariantViolation
from .scenario import SCENARIOS, SimReport, run_scenario
from .fuzz import fuzz

__all__ = [
    "VirtualClock", "SimEngine", "SimNetwork", "InvariantViolation",
    "SCENARIOS", "SimReport", "run_scenario", "fuzz",
]
