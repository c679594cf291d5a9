"""The port planner's breaker and small-group router on the CPU.

Modelled on the reference's ``tests/test_failover.py:586-723`` (the
breaker's state machine, the probe slot on a discarded plan, the trip to
the host path and the half-open recovery), ``tests/test_strategy.py:395``
(an open breaker places as the device) and ``tests/test_preemption.py:439``
(an open breaker routes the victim selection to the host).

Device faults are injected at the Python level: a plan path that raises
``KernelLaunchError`` (no test poisons a device context).  On every route
-- per group (dispatch and fetch), fused, victims, gang and preassigned --
the injected errors are counted, trip the breaker, and the group goes to
the host path, which places exactly as a run without a planner.  A
``KernelBuildError``, or any other fault of the program (a ValueError
here), raises out of every route, is not counted and leaves the breaker
as it was.  The router is off by default; with it on and both planners'
launch overhead and host cost a task pinned to one value,
``TorchPlanner`` routes small groups to the host exactly as
``TPUPlanner`` does and places the tick task for task alike.
"""


import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.models import types as mtypes  # noqa: E402
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402
from swarmkit_tpu_torch.ops import planner as planner_mod  # noqa: E402
from swarmkit_tpu_torch.ops.cuda import (  # noqa: E402
    KernelBuildError, KernelLaunchError,
)
from swarmkit_tpu_torch.ops.planner import (  # noqa: E402
    BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN, PlannerBreaker,
)
from swarmkit_tpu_torch.utils.metrics import registry  # noqa: E402

import test_torch_fused as tf  # noqa: E402
import test_torch_gang as tg  # noqa: E402
import test_torch_preempt as tp  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
GAUGE = "swarm_planner_breaker_state"


@pytest.fixture
def clock():
    """A settable model clock for the port (the breaker's cooldown)."""
    t = [1_700_000_000.0]
    mtypes.set_time_source(lambda: t[0])
    try:
        yield t
    finally:
        mtypes.set_time_source(None)
        PlannerBreaker()   # restore the exported gauge to closed


class _Inject:
    """Replace planner-module functions by stubs that raise ``exc`` on
    their first ``n`` calls (all calls with ``n=None``), then call the
    real function."""

    def __init__(self, monkeypatch, names, exc=KernelLaunchError, n=None):
        self.calls = 0
        self.raised = 0
        for name in names:
            real = getattr(planner_mod, name)

            def stub(*args, _real=real, **kw):
                self.calls += 1
                if n is None or self.raised < n:
                    self.raised += 1
                    raise exc("injected device failure")
                return _real(*args, **kw)
            monkeypatch.setattr(planner_mod, name, stub)


def _cpu_planner(**kw):
    return TorchPlanner(device="cpu", **kw)


# ----------------------------------------------------- the state machine

def test_breaker_state_machine_and_gauge(clock):
    b = PlannerBreaker(threshold=3, cooldown=10.0)
    assert registry.get_gauge(GAUGE) == BREAKER_CLOSED
    assert b.allow_device()
    b.record_failure()
    b.record_failure()
    assert b.state == BREAKER_CLOSED, "below threshold"
    trips = registry.get_counter("swarm_planner_breaker_trips")
    b.record_failure()
    assert b.state == BREAKER_OPEN and b.state_name == "open"
    assert registry.get_gauge(GAUGE) == BREAKER_OPEN
    assert registry.get_counter("swarm_planner_breaker_trips") == trips + 1
    assert not b.allow_device(), "open: host path"

    clock[0] += 10.5
    probes = registry.get_counter("swarm_planner_breaker_probes")
    assert b.allow_device(), "cooldown elapsed: half-open probe"
    assert b.state == BREAKER_HALF_OPEN
    assert registry.get_gauge(GAUGE) == BREAKER_HALF_OPEN
    assert registry.get_counter("swarm_planner_breaker_probes") \
        == probes + 1
    assert not b.allow_device(), "one probe at a time"
    b.record_failure()
    assert b.state == BREAKER_OPEN, "failed probe re-opens"

    clock[0] += 10.5
    assert not b.allow_device(), "cooldown doubled after failed probe"
    clock[0] += 10.0
    assert b.allow_device()
    b.record_success()
    assert b.state == BREAKER_CLOSED
    assert registry.get_gauge(GAUGE) == BREAKER_CLOSED
    assert b.stats["trips"] == 2 and b.stats["failures"] == 4


def test_trip_lands_in_the_flight_recorder(clock, monkeypatch):
    from swarmkit_tpu_torch.obs.flightrec import flightrec
    monkeypatch.setattr(flightrec, "enabled", True)
    b = PlannerBreaker(threshold=1, cooldown=7.0)
    b.record_failure()
    notes = [m for _t, m in flightrec.snapshot()["notes"]]
    assert "planner breaker tripped open (cooldown 7.0s)" in notes


def test_probe_slot_released_on_discarded_inflight(clock):
    """An aborted tick (discard_inflight) may drop the half-open probe
    plan before its outcome is observed: the slot must be released."""
    p = TorchPlanner(device="cpu",
                     breaker=PlannerBreaker(threshold=1, cooldown=5.0))
    p.breaker.record_failure()              # OPEN
    clock[0] += 6.0
    assert p.breaker.allow_device()         # probe admitted
    assert not p.breaker.allow_device()     # slot held
    p.discard_inflight()                    # tick aborted mid-probe
    assert p.breaker.state == BREAKER_HALF_OPEN
    assert p.breaker.allow_device(), "discard must release the probe slot"


# ------------------------------------------------- injected launch errors

# three services of 40, 45 and 50 tasks on 40 nodes: spread, binpack and
# weighted (one service a route, each a multiple of the node count or a
# strategy group, so no tie is left to a tie-break order)
SERVICES = [
    dict(tasks=40, spread=["node.labels.rack"]),
    dict(tasks=45, strategy="binpack", cpus=1),
    dict(tasks=50, strategy="weighted", weights={"spread": 2, "cpu": 3}),
    dict(tasks=40),
]


def _host_rows(services=SERVICES):
    rows, _ = tf.tick(PORT, services, None, depth=1)
    return rows


@pytest.mark.parametrize("route,names,fused", [
    ("dispatch", ["plan_group_packed", "plan_strategy_packed"], False),
    ("fetch", ["fetch_plan"], False),
    ("fused", ["plan_fused_packed", "plan_group_packed",
               "plan_strategy_packed"], True),
    ("fused-fetch", ["finish_fetch", "fetch_plan"], True),
])
@pytest.mark.parametrize("depth", [1, 2])
def test_launch_errors_trip_to_the_host_path(monkeypatch, clock, route,
                                             names, fused, depth):
    inj = _Inject(monkeypatch, names)
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=3,
                                                  cooldown=300.0))
    planner.fused_enabled = fused
    errors = registry.get_counter("swarm_planner_groups_device_error")
    rows, sched = tf.tick(PORT, SERVICES, planner, depth=depth)
    assert rows == _host_rows()
    assert all(node for _, node, _ in rows), "the host path placed all"
    stats = planner.stats
    assert inj.raised >= 1
    assert planner.breaker.state == BREAKER_OPEN
    assert registry.get_gauge(GAUGE) == BREAKER_OPEN
    assert stats["groups_device_error"] == 3          # the threshold
    assert registry.get_counter("swarm_planner_groups_device_error") \
        == errors + 3
    # fused: the run's failure, then two groups' per-group failures
    assert stats.get("groups_breaker_to_host", 0) \
        == len(SERVICES) - (2 if fused else 3)
    assert stats.get("groups_planned", 0) == 0
    assert stats.get("groups_fused", 0) == 0


def test_half_open_probe_recovers(monkeypatch, clock):
    """After the cooldown one probe group goes back to the device; a
    healthy device closes the breaker and the next groups plan there."""
    inj = _Inject(monkeypatch, ["plan_group_packed", "plan_strategy_packed"],
                  n=3)
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=3,
                                                  cooldown=5.0))
    planner.fused_enabled = False
    rows, _ = tf.tick(PORT, SERVICES, planner, depth=1)
    assert rows == _host_rows()
    assert planner.breaker.state == BREAKER_OPEN and inj.raised == 3
    clock[0] += 6.0
    want, _ = tf.tick(PORT, SERVICES, _cpu_planner(), depth=1)
    rows, _ = tf.tick(PORT, SERVICES, planner, depth=1)
    assert rows == want
    assert planner.breaker.state == BREAKER_CLOSED
    assert registry.get_gauge(GAUGE) == BREAKER_CLOSED
    assert planner.breaker.stats["probes"] == 1
    assert planner.stats["groups_planned"] == len(SERVICES)


def test_open_breaker_skips_the_fused_route(clock):
    planner = _cpu_planner()
    planner.breaker.record_failure()
    planner.breaker.record_failure()
    planner.breaker.record_failure()
    rows, _ = tf.tick(PORT, SERVICES, planner, depth=2)
    assert rows == _host_rows()
    assert planner.stats.get("groups_fused", 0) == 0
    assert planner.stats["groups_breaker_to_host"] == len(SERVICES)


def test_preassigned_launch_errors_go_to_the_host_loop(monkeypatch, clock):
    import test_torch_planner as tpl
    # every task preassigned: only the validation route is under test
    spec = dict(nodes=[dict(name=f"n{i}") for i in range(6)], tasks=8,
                preassign=["n0", "n1", "n2", "n3", "n4", "n5", "n0", "n1"])
    want = tpl.run(PORT, spec, None)[:2]
    inj = _Inject(monkeypatch, ["feasibility_packed"])
    planner = _cpu_planner()
    placed, errs, _ = tpl.run(PORT, spec, planner)
    assert (placed, errs) == want
    assert inj.raised == 1
    assert planner.stats["groups_device_error"] == 1
    assert planner.breaker.state == BREAKER_CLOSED   # below the threshold


@pytest.mark.parametrize("scenario", ["evicts_strictly_lower",
                                      "three_bands"])
def test_victim_launch_errors_go_to_the_host_oracle(monkeypatch, clock,
                                                    scenario):
    build, kw, preemptions = tp.SCENARIOS[scenario]

    def run(planner):
        _, _, Sch = tp._mods(PORT)
        store = build(PORT)
        sched = Sch.Scheduler(store, batch_planner=planner, **kw)
        store.view(sched._setup_tasks_list)
        sched.tick()
        assert sched.stats["preemptions"] == preemptions
        return tp._rows(PORT, store)

    want = run(None)
    inj = _Inject(monkeypatch, ["plan_victims"])
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=1))
    assert run(planner) == want
    assert inj.raised == 1
    assert planner.stats["preempt_device_error"] == 1
    assert planner.breaker.state == BREAKER_OPEN
    assert planner.select_victims(None, 1, 1, 0, 1, 8) is None
    assert planner.stats["preempt_breaker_to_host"] >= 1


def test_gang_launch_errors_go_to_the_host_oracle(monkeypatch, clock):
    def run(planner):
        M, _, Sch = tg._mods(PORT)
        store = tg.fleet_store(PORT, tg.FLEET)
        sched = Sch.Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        sched.tick()
        return sorted((t.id, t.node_id, int(t.status.state), t.status.err)
                      for t in store.view(lambda tx: tx.find(M.Task))), \
            sched.gang.stats

    want, want_stats = run(_cpu_planner())
    inj = _Inject(monkeypatch, ["gang_fit_packed"])
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=3))
    got, stats = run(planner)
    assert got == want and stats == want_stats
    assert stats["gangs_admitted"] == 14 and stats["rollbacks"] == 0
    assert inj.raised == 3
    assert planner.stats["gang_device_error"] == 3
    assert planner.breaker.state == BREAKER_OPEN
    # every verdict after the trip came from the host oracle
    assert planner.stats["gang_fit_host"] >= 3
    assert planner.stats.get("gang_fit_device", 0) \
        + planner.stats.get("gang_fit_fused", 0) == 0


# --------------------------------------------- a kernel that does not build

def _route_calls(planner):
    """One call into each route of the planner, on small real inputs."""
    import random
    nodes_np, group_np = planner_mod._probe_inputs()
    cand = tp.random_candidates(random.Random(0), 16, 4)
    return {
        "gang": lambda: planner._gang_fit_one(nodes_np, group_np, "b"),
        "gang_fused": lambda: planner._gang_fit_rows(
            [(nodes_np, group_np)] * 2, "b"),
        "victims": lambda: planner.select_victims(cand, 10 ** 9, 1 << 20,
                                                  0, 2, 8),
    }


@pytest.mark.parametrize("route,names,fused", [
    ("dispatch", ["plan_group_packed", "plan_strategy_packed"], False),
    ("fetch", ["fetch_plan"], False),
    ("fused", ["plan_fused_packed"], True),
    ("fused-fetch", ["finish_fetch"], True),
])
def test_build_error_raises_out_of_the_tick(monkeypatch, clock, route,
                                            names, fused):
    _Inject(monkeypatch, names, exc=KernelBuildError)
    planner = _cpu_planner()
    planner.fused_enabled = fused
    with pytest.raises(KernelBuildError):
        tf.tick(PORT, SERVICES, planner, depth=1)
    assert planner.breaker.state == BREAKER_CLOSED
    assert planner.breaker.stats["failures"] == 0
    assert planner.stats.get("groups_device_error", 0) == 0


@pytest.mark.parametrize("route", ["preassigned", "victims", "gang",
                                   "gang_fused", "probe"])
def test_build_error_raises_out_of_every_route(monkeypatch, clock, route):
    planner = _cpu_planner()
    if route == "preassigned":
        import test_torch_planner as tpl
        _Inject(monkeypatch, ["feasibility_packed"], exc=KernelBuildError)
        spec = dict(nodes=[dict(name=f"n{i}") for i in range(4)], tasks=6,
                    preassign=["n0", "n1", "n2", "n3"])
        with pytest.raises(KernelBuildError):
            tpl.run(PORT, spec, planner)
    elif route == "probe":
        # the router's launch-overhead probe: a build error is not a
        # failed measurement
        _Inject(monkeypatch, ["plan_group_packed"], exc=KernelBuildError)
        planner.enable_small_group_routing = True
        monkeypatch.setattr(TorchPlanner, "_launch_overhead_shared", {})
        with pytest.raises(KernelBuildError):
            planner._below_break_even(3)
    else:
        name = {"victims": "plan_victims"}.get(route, "gang_fit_packed")
        _Inject(monkeypatch, [name], exc=KernelBuildError)
        with pytest.raises(KernelBuildError):
            _route_calls(planner)[route]()
    assert planner.breaker.state == BREAKER_CLOSED
    assert planner.breaker.stats["failures"] == 0


@pytest.mark.parametrize("route,names,fused", [
    ("dispatch", ["plan_group_packed", "plan_strategy_packed"], False),
    ("fetch", ["fetch_plan"], False),
    ("fused", ["plan_fused_packed"], True),
    ("fused-fetch", ["finish_fetch"], True),
    ("fused-build", [], True),
])
def test_program_fault_raises_out_of_the_tick(monkeypatch, clock, route,
                                              names, fused):
    """Only a device error goes to the host path: a fault of the program
    on a device route (here a ValueError) raises, is not counted and
    leaves the breaker as it was."""
    if route == "fused-build":
        def build_run(*args, **kw):
            raise ValueError("injected fault")
        monkeypatch.setattr(planner_mod.fusedbatch, "build_run", build_run)
    else:
        _Inject(monkeypatch, names, exc=ValueError)
    planner = _cpu_planner()
    planner.fused_enabled = fused
    with pytest.raises(ValueError):
        tf.tick(PORT, SERVICES, planner, depth=1)
    assert planner.breaker.state == BREAKER_CLOSED
    assert planner.breaker.stats["failures"] == 0
    assert planner.stats.get("groups_device_error", 0) == 0


@pytest.mark.parametrize("route", ["preassigned", "victims", "gang",
                                   "gang_fused", "probe"])
def test_program_fault_raises_out_of_every_route(monkeypatch, clock, route):
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=1,
                                                  cooldown=1.0))
    # half-open: a route that raises must release the probe slot
    planner.breaker.record_failure()
    clock[0] += 2.0
    if route == "preassigned":
        import test_torch_planner as tpl
        _Inject(monkeypatch, ["feasibility_packed"], exc=ValueError)
        spec = dict(nodes=[dict(name=f"n{i}") for i in range(4)], tasks=6,
                    preassign=["n0", "n1", "n2", "n3"])
        with pytest.raises(ValueError):
            tpl.run(PORT, spec, planner)
    elif route == "probe":
        _Inject(monkeypatch, ["plan_group_packed"], exc=ValueError)
        planner.enable_small_group_routing = True
        monkeypatch.setattr(TorchPlanner, "_launch_overhead_shared", {})
        with pytest.raises(ValueError):
            planner._below_break_even(3)
        assert TorchPlanner._launch_overhead_shared == {}
        planner.breaker.allow_device()    # the probe below is the test's
        planner.breaker.abort_probe()
    else:
        name = {"victims": "plan_victims"}.get(route, "gang_fit_packed")
        _Inject(monkeypatch, [name], exc=ValueError)
        with pytest.raises(ValueError):
            _route_calls(planner)[route]()
    assert planner.breaker.stats["failures"] == 1, "only the setup's"
    if route == "gang_fused":
        # K8 over a stack is called below the breaker's gate: nothing
        # was admitted, nothing changed
        assert planner.breaker.state == BREAKER_OPEN
    else:
        assert planner.breaker.state == BREAKER_HALF_OPEN
        assert planner.breaker.allow_device(), "the probe slot was released"
    for key in ("groups_device_error", "gang_device_error",
                "preempt_device_error"):
        assert planner.stats.get(key, 0) == 0, key


def test_build_error_in_half_open_releases_the_probe(monkeypatch, clock):
    planner = _cpu_planner(breaker=PlannerBreaker(threshold=1,
                                                  cooldown=1.0))
    planner.breaker.record_failure()
    clock[0] += 2.0
    _Inject(monkeypatch, ["gang_fit_packed"], exc=KernelBuildError)
    with pytest.raises(KernelBuildError):
        _route_calls(planner)["gang"]()
    assert planner.breaker.state == BREAKER_HALF_OPEN
    assert planner.breaker.allow_device(), "the probe slot was released"


# ------------------------------------------------------------ the router

SMALL_MIX = [
    dict(tasks=3),
    dict(tasks=80, spread=["node.labels.rack"]),
    dict(tasks=45, strategy="binpack", cpus=1),
    dict(tasks=5, strategy="binpack", cpus=2),
    dict(tasks=50, strategy="weighted", weights={"spread": 2, "cpu": 3}),
    dict(tasks=40),
    dict(tasks=7, spread=["node.labels.rack"]),
    dict(tasks=37, strategy="learned"),
    dict(tasks=2, strategy="weighted"),
]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_router_matches_reference_with_pinned_overhead(depth, fused):
    """With the router on and the overhead and the host cost a task
    pinned to one value in both planners (break-even 16 tasks), small
    groups go to the host path in both and the tick places task for task
    alike."""
    from swarmkit_tpu.ops import TPUPlanner
    ref = TPUPlanner()
    ref._launch_overhead = 1e-3
    ref.fused_enabled = fused
    port = TorchPlanner(device="cpu")
    port.enable_small_group_routing = True
    port._launch_overhead = 1e-3
    port.host_cost_per_task = ref.host_cost_per_task
    port.fused_enabled = fused
    assert ref.enable_small_group_routing
    want, ref_sched = tf.tick(REF, SMALL_MIX, ref, depth)
    got, sched = tf.tick(PORT, SMALL_MIX, port, depth)
    assert got == want
    assert all(node for _, node, _ in got)
    for key in ("groups_small_to_host", "groups_planned", "groups_fused",
                "groups_fallback", "groups_spill_to_host"):
        assert port.stats.get(key, 0) == ref.stats.get(key, 0), key
    assert port.stats["groups_small_to_host"] == 4


def test_router_defaults():
    """Off by default: every group goes to the kernels."""
    port = TorchPlanner(device="cpu")
    assert port.enable_small_group_routing is False
    assert port.host_cost_per_task == planner_mod.HOST_COST_PER_TASK
    assert not port._below_break_even(1)
    port.enable_small_group_routing = True
    port._launch_overhead = 1e-3
    port.host_cost_per_task = 50e-6
    assert port._below_break_even(15) and not port._below_break_even(16)


def test_launch_overhead_measured_once_and_shared(monkeypatch):
    """On the CPU the probe times the plain path; only a successful
    measurement is shared across planners."""
    monkeypatch.setattr(TorchPlanner, "_launch_overhead_shared", {})
    a = TorchPlanner(device="cpu")
    a.enable_small_group_routing = True
    a._below_break_even(1)
    assert a._launch_overhead > 0.0
    b = TorchPlanner(device="cpu")
    b._measure_launch_overhead()
    assert b._launch_overhead == a._launch_overhead

    monkeypatch.setattr(TorchPlanner, "_launch_overhead_shared", {})
    _Inject(monkeypatch, ["plan_group_packed"])
    c = TorchPlanner(device="cpu")
    c._measure_launch_overhead()
    assert c._launch_overhead == 0.0
    assert TorchPlanner._launch_overhead_shared == {}


def test_route_counters_reach_the_registry():
    p = TorchPlanner(device="cpu")
    for key, route in (("groups_small_to_host", "host_small"),
                       ("groups_breaker_to_host", "breaker")):
        before = registry.get_counter(
            f'swarm_planner_groups{{route="{route}"}}')
        p._count(key)
        assert registry.get_counter(
            f'swarm_planner_groups{{route="{route}"}}') == before + 1
