#!/usr/bin/env python3
"""bench.py's config 13 at its full depth on one CUDA card.

    python3 swarmkit_tpu_torch/probes/million_swarm_probe.py

Runs ``workload.million_swarm`` once through ``TorchPlanner()``: 1,000
dispatcher sessions, 10 services, the pending cap 65,536, report batches
of 1,024 and 1,000,000 replicas, the shape of bench.py's defaults, which
``chip_smoke.py``'s phase 26 cuts to fit its time limit.
Prints the card's name and power limit and the same fields as phase 26
(tick, register, stream-open, fan-out and write-back seconds, write-back
rounds, time-to-running percentiles, decisions/s, sheds, the heartbeat
stretch, the tick's launches by kernel, the dispatcher and scheduler
planes); fails unless every replica is RUNNING, the shed ledger
reconciles with at least one shed, no session expired early and no
kernel was built inside the timed tick.  The record goes to
``chiprun_out/million_swarm_probe.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.realpath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("million_swarm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner

    replicas = workload.SWARM_REPLICAS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    run = workload.million_swarm(TorchPlanner, n_replicas=replicas)
    wall = time.perf_counter() - t0
    run.pop("placements")
    sheds = run["sheds"]
    ok = (run["time_to_running"]["running"] == replicas
          and sheds["dispatcher"] == sheds["client_observed"] >= 1
          and sheds["unrecovered"] == 0
          and run["premature_expirations"] == 0
          and not any(run["compiles"].values()) and run["build_s"] == 0.0)
    run["launches"] = {k: v for k, v in run["launches"].items() if v}
    run.update(card=card, wall_s=wall, ok=ok)
    for key in ("tick_s", "decisions_per_sec", "register_s",
                "stream_open_s", "fanout_s", "fanout_messages",
                "fanout_changes", "writeback_s", "writeback_rounds",
                "peak_update_depth", "hb_stretch_factor",
                "premature_expirations", "sheds", "time_to_running",
                "compiles", "launches", "planes", "wall_s"):
        print(f"{key}: {json.dumps(run[key])}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "million_swarm_probe.json"), "w") as f:
        json.dump(run, f, indent=1, default=str)
    print(json.dumps({"ok": ok, "replicas": replicas, "card": card}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
