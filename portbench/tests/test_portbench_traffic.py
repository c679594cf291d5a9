"""The traffic generator and the frozen roofline counts."""

import pytest

from conftest import ADDED
from portbench import bench, generator
from portbench.metrics import roofline


def _steps(cfg, mix, seed, n):
    t = generator.Traffic(cfg, mix, seed)
    return t.nodes, t.base, [t.next_step() for _ in range(n)]


@pytest.mark.parametrize("name", [w["name"]
                                  for w in bench.load()["workloads"]])
def test_a_seed_replays_and_seeds_differ(name, small_cell):
    _, cfg, mix = small_cell(name)
    big = 2**31 + 12345
    a = _steps(cfg, mix, big, 25)
    assert a == _steps(cfg, mix, big, 25)
    assert a != _steps(cfg, mix, big + 1, 25)


def test_waves_do_the_same_work_on_every_seed(small_cell):
    _, cfg, mix = small_cell(ADDED)
    shapes = set()
    for seed in (1, 2, 3):
        _, _, steps = _steps(cfg, mix, seed, 3)
        shapes.add(tuple((len(s["create"]), sum(p >= 0 for _, _, p in
                                                  s["create"]),
                          len(s["running"]), len(s["remove"]))
                         for s in steps))
    assert len(shapes) == 1


def test_churn_exits_take_the_oldest_running_tasks(small_cell):
    _, cfg, mix = small_cell("churn8k.steady")
    t = generator.Traffic(cfg, mix, 5)
    base = [tid for tid, _, _ in t.base]
    exited, reported = [], []
    for _ in range(60):
        s = t.next_step()
        reported += s["running"]
        exited += s["exits"]
    assert exited == (base + reported)[:len(exited)]
    assert len(exited) > len(base)          # past the base, into arrivals


def test_the_counts_reproduce_the_kernel_table_bounds():
    """PERF.md's kernel table: K1 at nb 16,384 with a platform row (os
    and arch) and no constraint, K2 and K3 at L = 256."""
    n, L = 16384, 256
    plat = [{"os": "linux", "arch": "amd64"}]
    assert round(roofline.feasibility(n, 0, plat) * 1e3, 6) == 0.000142
    assert round(roofline.branch_sums(n, L) * 1e3, 7) == 0.0000648
    assert round(roofline.water_fill(n, L) * 1e3, 6) == 0.000118
    plan = roofline.plan_seconds(dict(kind="place", nodes=n, tasks=1,
                                      constraints=0, platforms=plat,
                                      levels=[L]))
    stage_a = roofline.water_fill(L, 1)
    assert round((plan - stage_a) * 1e3, 5) == 0.00032


def test_the_plan_counts_follow_the_asked_work():
    base = dict(kind="place", nodes=10000, tasks=80000, constraints=0,
                platforms=[], levels=[20])
    validate = dict(base, kind="validate")
    assert roofline.plan_seconds(validate) < roofline.plan_seconds(base)
    flat = dict(base, levels=[])
    assert roofline.plan_seconds(flat) < roofline.plan_seconds(base)
    assert roofline.plan_seconds(dict(base, constraints=2)) > \
        roofline.plan_seconds(base)
