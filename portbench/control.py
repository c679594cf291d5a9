"""The control of the check that decides ``correct``: the plain reference
put in the program's place with one guarantee the configuration states
broken, judged as a run is judged.  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

The configuration's ``control`` names the guarantee: ``preassigned`` (a
global service's task placed as a replicated one, not on its own node)
or ``constraints`` (placement constraints and platforms ignored).  As a
run does, it steps through the warm-up, then through a window of
``run_seconds`` of ``BENCHMARK.json``, the broken reference making the
steps at its own pace.  Prints one JSON line per seed with the
``misplaced`` reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import bench, generator, harness  # noqa: E402
from portbench.reference.placement import Reference  # noqa: E402


class Broken(Reference):
    """The reference with the guarantee ``guarantee`` dropped."""

    def __init__(self, *args, guarantee: str):
        super().__init__(*args)
        if guarantee not in ("preassigned", "constraints"):
            raise ValueError(f"no control breaks {guarantee!r}")
        self.guarantee = guarantee

    def step(self, remove=(), create=(), exits=(), services=None):
        if self.guarantee == "preassigned":
            create = [(tid, sid, -1) for tid, sid, _ in create]
        return super().step(remove, create, exits, services)

    def constraint_mask(self, shape_name):
        if self.guarantee == "constraints":
            return np.ones(self.n, bool)
        return super().constraint_mask(shape_name)


def control_reading(cfg: dict, mix: dict, seed: int, seconds: float) -> dict:
    """Judge the broken reference's placements over the warm-up and a
    window of ``seconds`` of ``seed``; the judgement, with ``steps``, the
    measured steps it made."""
    traffic = generator.Traffic(cfg, mix, seed)
    broken = Broken(traffic.nodes, traffic.shapes, traffic.services,
                    traffic.base, guarantee=cfg["control"])
    ids = [x["id"] for x in traffic.nodes]
    committed, steps = {}, []

    def step():
        st = traffic.next_step()
        steps.append(st)
        got = broken.step(st["remove"], st["create"], st["exits"],
                          st["services"])
        for (tid, _, _), i in zip(st["create"], got.tolist()):
            committed[tid] = (ids[i], 192) if i >= 0 else ("", 64)

    for _ in range(traffic.warmup_steps()):
        step()
    warm = len(steps)
    t0 = time.perf_counter()
    while True:
        step()
        if time.perf_counter() - t0 >= seconds:
            break
    fresh = generator.Traffic(cfg, mix, seed)
    reference = Reference(fresh.nodes, fresh.shapes, fresh.services,
                          fresh.base)
    index = {nid: i for i, nid in enumerate(ids)}
    check = harness.judge(steps, reference, committed, index, warm)
    check["steps"] = len(steps) - warm
    return check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload)
    cfg = cell.config()
    seconds = bench.load(cell.root)["run_seconds"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        check = control_reading(cfg, cell.traffic(), seed, seconds)
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              guarantee=cfg["control"], steps=check["steps"],
                              misplaced=check["misplaced"],
                              checked=check["checked"],
                              seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
