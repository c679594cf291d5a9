"""What decides ``correct``: the plain reference agrees with the port's
placements on small clusters, and comes out not correct against the
control and against each fault a cell can have, planted under a run."""

import json

import numpy as np
import pytest

from conftest import ADDED
from portbench import bench, control, harness, run
from portbench.reference.placement import fill

#: every cell of BENCHMARK.json, and one added as a later change adds it
CELLS = [w["name"] for w in bench.load()["workloads"]] + [ADDED]


def _run(small_cell, name, seconds=0.3, trace=False):
    cell, cfg, mix = small_cell(name)
    record, check, peak = harness.run_cell(cell, 2**31 + 77, seconds, trace,
                                          "cpu", 0.0, cfg, mix)
    return cell, record, check, peak


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_port(name, small_cell):
    cell, record, check, _ = _run(small_cell, name)
    assert check["misplaced"] == 0
    assert record.placed == record.attempted > 0
    assert set(record.host_routes) == set(harness.HOST_ROUTES)
    assert not any(record.host_routes.values())
    line = run.result_line(cell, record, check, 0, {"platform": "cpu"},
                           False)
    assert line["correct"] is True


def test_a_window_planned_off_the_card_is_counted(small_cell, monkeypatch):
    from swarmkit_tpu_torch.ops.planner import PlannerBreaker
    monkeypatch.setattr(PlannerBreaker, "allow_device", lambda self: False)
    _, record, _, _ = _run(small_cell, CELLS[0])
    assert record.host_routes["groups_breaker_to_host"] > 0


def test_a_run_whose_window_left_the_card_prints_no_result(monkeypatch,
                                                           capsys):
    import torch
    for name, fn in (("is_available", lambda: True),
                     ("device_count", lambda: 1), ("init", lambda: None),
                     ("get_device_name", lambda i=0: "card")):
        monkeypatch.setattr(torch.cuda, name, fn)
    record = harness.Record()
    record.host_routes = dict.fromkeys(harness.HOST_ROUTES, 0)
    record.host_routes["groups_fallback"] = 2
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (
        record, {"misplaced": 0, "checked": 1}, 0))
    rc = run.main(["--workload", CELLS[0], "--seed", "5", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == ""
    assert "groups_fallback" in out.err


def test_the_fill_places_lowest_first_and_breaks_ties_by_rank():
    level = np.array([3, 0, 0, 5])
    room = np.array([9, 2, 9, 9])
    x = fill(level, room, np.array([0, 1, 2, 3]), 7)
    assert x.tolist() == [1, 2, 4, 0]
    x = fill(level, room, np.array([3, 0, 1, 2]), 6)
    assert x.tolist() == [0, 2, 4, 0]
    assert fill(level, room, np.arange(4), 100).tolist() == [9, 2, 9, 9]


def _break_tick(monkeypatch):
    from swarmkit_tpu_torch.scheduler import Scheduler
    monkeypatch.setattr(Scheduler, "tick", lambda self: 0)


def _drop_half(monkeypatch):
    from swarmkit_tpu_torch.ops import TorchPlanner
    orig = TorchPlanner.dispatch_group

    def dispatch(self, sched, task_group, decisions):
        for tid in list(task_group)[::2]:
            del task_group[tid]
        return orig(self, sched, task_group, decisions)
    monkeypatch.setattr(TorchPlanner, "dispatch_group", dispatch)


def _alter_one(monkeypatch):
    from swarmkit_tpu_torch.ops import planner
    orig = planner.fetch_plan

    def fetch(pending, nb):
        x, fail, spill = orig(pending, nb)
        x = np.array(x)
        i = int(np.nonzero(x)[0][0])
        x[i] -= 1
        x[(i + 1) % len(x) if x[(i + 1) % len(x)] >= 0 else 0] += 1
        return x, fail, spill
    monkeypatch.setattr(planner, "fetch_plan", fetch)


@pytest.mark.parametrize("fault", [_break_tick, _drop_half, _alter_one],
                         ids=["state_unchanged", "half_the_batch",
                              "one_answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_comes_out_not_correct(name, fault, small_cell,
                                          monkeypatch):
    fault(monkeypatch)
    cell, record, check, _ = _run(small_cell, name)
    line = run.result_line(cell, record, check, 0, {"platform": "cpu"},
                           False)
    assert check["misplaced"] > 0
    assert line["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name, small_cell):
    cell, cfg, mix = small_cell(name)
    for seed in (1, 2, 3):
        reading = control.control_reading(cfg, mix, seed, 0.3)
        assert reading["steps"] >= 1
        assert reading["misplaced"] > run.LIMITS["misplaced"]


class _Trace:
    """A device trace as a run on the card records it."""

    rows = [("k1", 10.0, 0.001), ("Memcpy HtoD", 10.0005, 0.001),
            ("k3", 12.0, 0.002)]
    window = (9.0, 14.0)
    missing = 0

    from portbench.profile import DeviceTrace as _D
    busy_intervals = _D.busy_intervals
    busy_s = _D.busy_s
    window_s = _D.window_s
    seconds_where = _D.seconds_where
    top_ops = _D.top_ops
    idle_gaps = _D.idle_gaps


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_exactly_the_contract_keys(traced, small_cell):
    cell, record, check, peak = _run(small_cell, CELLS[0], trace=traced)
    if traced:
        record.device = _Trace()
    line = run.result_line(cell, record, check, peak,
                           {"platform": "gpu", "kind": "card", "count": 1},
                           traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:-1] == keys + (["breakdown"] if traced else [])
    assert list(line)[-1] == "check"
    assert json.loads(json.dumps(line)) == line
    names = {m["name"] for m in cell.metrics(traced)}
    assert set(line["metrics"]) <= names
    if traced:
        dev = line["device"]
        assert dev["busy_s"] == pytest.approx(0.0035)
        assert dev["window_s"] == pytest.approx(5.0)
        assert [op for op, _ in line["breakdown"]["device_ops"]][0] == "k3"
        assert set(line["metrics"]) == names
    else:
        assert set(line["metrics"]) == names


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = [("portbench.step", 9.0, 14.0, "m"),
             ("sched.tick", 11.0, 13.0, "m"),
             ("plan.refresh", 11.5, 11.9, "m")]
    gaps = dict(_Trace().idle_gaps(spans))
    # idle: 9-10, 10.0015-12, 12.002-14; the refresh holds 11.5-11.9 of
    # it, the rest of the tick 11-11.5 and 11.9-12 and 12.002-13
    assert gaps == pytest.approx({
        "plan.refresh": 0.4, "sched.tick": 0.5 + 0.1 + 0.998,
        "portbench.step": 1 + (11 - 10.0015) + 1})
    # spans that start together: the one that ends first is the inner
    spans = [("portbench.step", 9.0, 14.0, "m"),
             ("portbench.write", 9.0, 9.5, "m")]
    gaps = dict(_Trace().idle_gaps(spans))
    assert gaps["portbench.write"] == pytest.approx(0.5)
