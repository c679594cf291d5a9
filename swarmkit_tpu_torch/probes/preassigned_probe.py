#!/usr/bin/env python3
"""Where the traced headline tick's ``sched.preassigned`` span spends its
time on one CUDA card.

    python3 swarmkit_tpu_torch/probes/preassigned_probe.py

Runs ``chip_smoke.py``'s main path once (the headline tick, untraced, as
the script runs it before its traced tick), then ``chip_smoke.py``'s
traced headline tick (a fresh headline cluster, its preassigned pass and
its tick under the span tracer and torch.profiler) in four variants, in
the order A B C D D C B A:

* ``as_is``: the tree as it is;
* ``native_off``: the native C commit plane off
  (``SWARMKIT_TPU_NO_NATIVE``, as ``chip_smoke.set_native(False)``),
  for the cluster's build and its tick;
* ``no_breaker``: the planner's breaker replaced by a stub whose gate
  admits every group and whose records do nothing;
* ``gc_off``: the cyclic garbage collector disabled around the
  preassigned pass (the scheduler's tick already runs with it paused).

Each run prints its wall time, the spans that fall inside the pass
(``sched.preassigned`` and the planner's spans under it) and the
collections the garbage collector made inside the pass, by generation,
with their seconds (``chip_smoke.GcClock``).  The record goes to
``chiprun_out/preassigned_probe.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys

HERE = os.path.realpath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
VARIANTS = ("as_is", "native_off", "no_breaker", "gc_off")
SPANS = ("sched.preassigned", "plan.build_inputs", "plan.feasibility",
         "plan.apply", "sched.commit", "sched.tick")


def _tools():
    """This tree's ``chip_smoke.py`` (its phases, profiler and switches)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tools", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _NoBreaker:
    """A breaker that admits every group and records nothing."""

    state = 0

    def allow_device(self):
        return True

    def abort_probe(self):
        pass

    def record_success(self):
        pass

    def record_failure(self):
        pass


def run_variant(cs, torch, mods, variant, clock):
    workload, Scheduler, TorchPlanner, tracer, card = mods
    real = Scheduler._process_preassigned_tasks

    def pass_(sched):
        clock.on = True
        if variant == "gc_off":
            gc.disable()
        try:
            real(sched)
        finally:
            if variant == "gc_off":
                gc.enable()
            clock.on = False

    def planner():
        if variant == "no_breaker":
            return TorchPlanner(breaker=_NoBreaker())
        return TorchPlanner()

    clock.runs.clear()
    cs.set_native(variant != "native_off")
    Scheduler._process_preassigned_tasks = pass_
    try:
        out = cs.phase_traced_tick(torch, workload.headline_cluster,
                                   Scheduler, planner, tracer, card,
                                   label=f"preassigned probe ({variant})")
    finally:
        Scheduler._process_preassigned_tasks = real
        cs.set_native(True)
    by_gen = clock.by_generation()
    row = dict(variant=variant, wall_s=out["wall_s"],
               spans_s={k: out["spans_s"].get(k, 0.0) for k in SPANS},
               gc_in_pass={str(g): dict(collections=n, seconds=s)
                           for g, (n, s) in by_gen.items()})
    print(f"{variant}: wall {row['wall_s']:.3f} s; "
          + ", ".join(f"{k} {v * 1e3:.1f} ms"
                      for k, v in row["spans_s"].items())
          + "; gc in the pass: "
          + (", ".join(f"gen {g} x{n} {s * 1e3:.1f} ms"
                       for g, (n, s) in by_gen.items())
             or "none")
          + f" on {card}", flush=True)
    return row


def main():
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("preassigned_probe: no CUDA device")
    cs = _tools()
    from swarmkit_tpu_torch import native, workload
    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.obs import tracer
    from swarmkit_tpu_torch.ops import TorchPlanner, cuda
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.scheduler import Scheduler
    card = cs.card_line()
    cs.set_native(True)
    cs.check(native.get() is not None, "the native plane did not build")
    cs.phase_build(cuda)
    main_path = cs.phase_main_path(torch, K, cuda, workload, Task,
                                   Scheduler, TorchPlanner, card)
    mods = (workload, Scheduler, TorchPlanner, tracer, card)
    with cs.GcClock() as clock:
        rows = [run_variant(cs, torch, mods, v, clock)
                for v in VARIANTS + VARIANTS[::-1]]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "preassigned_probe.json"),
              "w") as f:
        json.dump(dict(card=card, main_path_tick_s=main_path[0].get(
            "tick_s"), gc_threshold=gc.get_threshold(), runs=rows), f,
            indent=1)
    print(card, flush=True)


if __name__ == "__main__":
    main()
