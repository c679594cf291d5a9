"""The port's simulator against the reference's, scenario by scenario.

Every registry scenario but ``long-soak`` (minutes of virtual time; the
reference sweeps it in its slow tier) runs at one seed through
``swarmkit_tpu.sim.scenario.run_scenario`` and through the port's with
``device="cpu"``, in one process.  Their reports must be equal (the
engine's trace hash, the event count, the verdict, the violations, the
stats and the journey ledger's sha), and so must their span traces once
two differences by design are put aside (``workload.sim_obs_events``): the
reference records a ``plan.compile`` span for each jit compile of a
bucket, which the port records only for the first kernel build in a
process, on the card; and the port's resident state records a
``plan.refresh`` span, which the reference has none of.  The ten scenarios
that run a device planner (``workload.SIM_DEVICE_SCENARIOS``) run at a
second seed as well.  The registries must match: the scenario names, the
fuzz pool, its exclusions and every suite.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu.sim import scenario as ref  # noqa: E402
from swarmkit_tpu_torch import workload  # noqa: E402
from swarmkit_tpu_torch.sim import scenario as port  # noqa: E402

from test_torch_dispatcher import singletons_left_as_found  # noqa: E402,F401

#: the reference's own choice: long-soak is swept only in its slow tier
NOT_SWEPT = ("long-soak",)
SEED = 3
DEVICE_SEED = 5
#: the spans the two packages record differently by design
BY_DESIGN = ("plan.compile", "plan.refresh")
SUITES = ("FAILOVER_SCENARIOS", "UPDATE_SCENARIOS", "PREEMPT_SCENARIOS",
          "QOS_SCENARIOS", "GANG_SCENARIOS", "READ_SCENARIOS",
          "STREAMING_SCENARIOS", "OVERLOAD_SCENARIOS", "LEGACY_RCP_SCENARIOS",
          "FUZZ_POOL")


def report_fields(report):
    out = report.to_dict()
    del out["obs_trace_sha256"]
    return out


def assert_same_run(name, seed):
    want = ref.run_scenario(name, seed)
    got = port.run_scenario(name, seed, device="cpu")
    assert want.ok, (name, seed, want.violations)
    assert report_fields(got) == report_fields(want)
    a = workload.sim_obs_events(want.obs_trace, drop=BY_DESIGN)
    b = workload.sim_obs_events(got.obs_trace, drop=BY_DESIGN)
    assert len(a) > 1
    assert b == a
    return got


@pytest.mark.parametrize("name", [n for n in sorted(ref.SCENARIOS)
                                  if n not in NOT_SWEPT])
def test_scenario_matches_the_reference(name):
    assert_same_run(name, SEED)


@pytest.mark.parametrize("name", workload.SIM_DEVICE_SCENARIOS)
def test_device_scenario_matches_the_reference_at_a_second_seed(name):
    got = assert_same_run(name, DEVICE_SEED)
    assert any(e["name"].startswith("plan.")
               for e in workload.sim_obs_events(got.obs_trace, drop=()))


def test_device_scenarios_are_the_ones_that_build_a_planner():
    """``SIM_DEVICE_SCENARIOS`` is every scenario whose text builds a
    planner, no more: the three that build their own and the seven that
    set ``cp.planner_factory`` (directly or through a scenario maker)."""
    import inspect
    built = set()
    for name, fn in port.SCENARIOS.items():
        src = inspect.getsource(fn)
        for cell in fn.__closure__ or ():
            if callable(cell.cell_contents):
                src += inspect.getsource(cell.cell_contents)
        if "TorchPlanner(" in src or "_device_planner(" in src:
            built.add(name)
    assert built == set(workload.SIM_DEVICE_SCENARIOS)


def test_registries_match_the_reference():
    assert list(port.SCENARIOS) == list(ref.SCENARIOS)
    assert port.FUZZ_POOL == ref.FUZZ_POOL
    assert port.FUZZ_EXCLUDED == ref.FUZZ_EXCLUDED
    for suite in SUITES:
        assert getattr(port, suite) == getattr(ref, suite), suite
    for name in port.SCENARIOS:
        assert getattr(port.SCENARIOS[name], "raft_cp", False) == getattr(
            ref.SCENARIOS[name], "raft_cp", False), name


def test_obs_events_put_aside_only_the_named_spans():
    """The normalization drops the named spans and nothing else, and
    names each span's parent, so a dropped span does not shift the rest."""
    import json
    trace = json.dumps({"traceEvents": [
        {"name": "thread_name", "ph": "M", "args": {"name": "MainThread"}},
        {"name": "sched.tick", "ph": "X", "ts": 1,
         "args": {"span_id": 1, "parent_id": 0}},
        {"name": "plan.compile", "ph": "X", "ts": 1,
         "args": {"span_id": 2, "parent_id": 1}},
        {"name": "sched.commit", "ph": "X", "ts": 2,
         "args": {"span_id": 3, "parent_id": 1, "n": 4}},
    ]})
    got = workload.sim_obs_events(trace)
    assert [e["name"] for e in got] == ["thread_name", "sched.tick",
                                        "sched.commit"]
    assert got[1]["args"] == {"parent": None}
    assert got[2]["args"] == {"parent": "sched.tick", "n": 4}
    assert len(workload.sim_obs_events(trace, drop=())) == 4
