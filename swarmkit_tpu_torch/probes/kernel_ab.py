#!/usr/bin/env python3
"""Time K9 (victim selection) and K10 (the split's water-fill) of two
trees of this repository on one CUDA card, in turns.

    python3 swarmkit_tpu_torch/probes/kernel_ab.py OLD_TREE NEW_TREE

Each tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
The trees run in the order OLD, NEW, NEW, OLD, each in a process of its
own that imports that tree's ``swarmkit_tpu_torch`` and ``chip_smoke``,
builds its kernels and measures, on the same card:

* K9 at config 8's shape: every ``select_victims`` call of bench.py's
  config 8 tick (``workload.priority_jobs``, node bucket 1024, V = 4),
  recorded and then replayed on its own inputs;
* K9 at node bucket 16384, V = 4, 16 and 64, 512 picks
  (``chip_smoke.victim_inputs``, the full run);
* K10 at the mesh headline's leaf fill (four shards, L = 256) and at one
  segment a row (four shards, L = 16,384).

Per case: the wrapper's ms (CUDA events over 20 warm calls), the
kernels' device ms (torch.profiler) and the SM clock after it
(``nvidia-smi``).  Each run prints one JSON line; the
last line is the whole record, also written to
``chiprun_out/kernel_ab.json``, with the card's name and power limit.
"""

import json
import os
import subprocess
import sys


def _clocks():
    """The card's SM clock, its maximum and the power draw now: a
    latency-bound kernel's time scales with the SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else None


def _k9_row(torch, cs, P, inp, args, pb):
    def run():
        return P.select_victims(inp, *args, pb)

    got = run()
    want = P._select_victims_plain(inp, *args, pb)
    cs.check(torch.equal(got, want), "K9 differs from its plain version")
    prefix, pick = cs.device_ms_each(
        torch, run, (("victim_prefix_kernel",), ("victim_pick_kernel",)))
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                prefix_device_ms=prefix, pick_device_ms=pick, pb=pb,
                n_picks=args[3], picks=int((got[:pb] >= 0).sum()),
                clocks=_clocks())


def _k10_row(torch, cs, K, parts, L):
    def run():
        K._shard_waterfill(parts, L)

    run()
    want = torch.cat(K._shard_waterfill_plain(parts, L))
    cs.check(torch.equal(torch.cat([p.out for p in parts]), want),
             "K10 differs from its plain version")
    before = K.SHARD_WATERFILL.launches
    run()
    launches = K.SHARD_WATERFILL.launches - before
    (dev,) = cs.device_ms_each(
        torch, run, (("shard_waterfill_kernel", "ShardElems"),))
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                device_ms=dev, launches_per_fill=launches, clocks=_clocks())


def measure(tree):
    """One tree's numbers (run in a process of its own)."""
    tree = os.path.realpath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner, cuda
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.ops import preempt as P
    from swarmkit_tpu_torch.ops.convert import victims_to_device
    from swarmkit_tpu_torch.ops.densify import n_bucket
    cs.check(os.path.realpath(cuda.__file__).startswith(tree),
             f"imported {cuda.__file__}, not the tree {tree}")
    cs.check(torch.cuda.is_available(), "no CUDA device")
    build = cuda.build()
    cuda.library()
    dev = torch.device("cuda")
    out = dict(tree=tree, build_s=build.seconds)

    planner = TorchPlanner()
    calls = cs.spy_on_victims(planner)
    store, _, _, _ = workload.priority_jobs()
    workload.preempt_tick(store, planner, workload.PRIORITY_JOBS_BUDGET)
    torch.cuda.synchronize()
    out["k9_config8"] = []
    for cand, args, _, _ in calls:
        args = tuple(int(a) for a in args)
        nb = n_bucket(max(cand.ok.shape[0], 1))
        inp = victims_to_device(cand, nb, dev)
        row = _k9_row(torch, cs, P, inp, args, P.pick_bucket(args[3]))
        out["k9_config8"].append(dict(row, nb=nb, v=int(cand.vb)))

    out["k9_nb16384"] = {}
    for v in (4, 16, 64):
        cand, args = cs.victim_inputs(900 + v, v, "full")
        inp = victims_to_device(cand, n_bucket(cand.ok.shape[0]), dev)
        out["k9_nb16384"][f"v{v}"] = _k9_row(
            torch, cs, P, inp, args, P.pick_bucket(args[3]))

    parts, L = cs.headline_fill_parts(4, dev)
    out["k10"] = {"L256": _k10_row(torch, cs, K, parts, L)}
    wide = cs.shard_fill_inputs(31, L=16384)
    out["k10"]["L16384"] = _k10_row(torch, cs, K,
                                    cs.fill_parts(wide, 4, dev), 16384)
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    old, new = sys.argv[1:]
    here = os.path.realpath(__file__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        proc = subprocess.run([sys.executable, here, "--one", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{label} run on {tree} failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["label"] = label
        runs.append(row)
        print(json.dumps(row), flush=True)
    record = dict(card=card, order=[r["label"] for r in runs], runs=runs)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card, flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
