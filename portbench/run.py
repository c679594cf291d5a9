"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's cluster from ``--seed`` on the card, warms up at the
cell's own shapes (set-up), measures a window of at least ``--seconds``
(whole steps of the closed loop), checks every placement the run
committed against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(end-to-end with ``--trace 0``, per-layer with ``--trace 1``), ``device``
and, traced, ``breakdown``; then ``check``, the numbers compared with
their limits, which are also the last lines on standard error.

Exits 2 without printing a result where CUDA is absent or has fewer cards
than the cell asks for, 3 where the process holds JAX or the JAX package
once the window has closed, and 4 where the planner sent a group of the
window to the host path (``harness.HOST_ROUTES``), so that the window did
not time the device path.
"""

from __future__ import annotations

import os
import time


def _process_seconds() -> float:
    """Seconds since this process started (/proc's 10 ms clock ticks), so
    set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_seconds()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: what decides ``correct``: the tasks placed elsewhere than the plain
#: reference places them, across every step of the run; an exact
#: comparison (PERF.md gives the readings this limit was set from)
LIMITS = {"misplaced": 0}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"


def result_line(cell, record, check, peak, device_info, traced) -> dict:
    """The run's result: the contract's keys, then ``check``."""
    from portbench import bench
    correct = all(check[k] <= v for k, v in LIMITS.items())
    line = {
        "correct": correct,
        "attempted": record.attempted,
        "failed": record.attempted - record.placed,
        "metrics": bench.read_metrics(cell, record, traced),
        "device": dict(device_info, memory_peak_bytes=int(peak),
                       host_routes=record.host_routes),
    }
    if traced and record.device is not None:
        dev = record.device
        line["device"]["busy_s"] = dev.busy_s()
        line["device"]["window_s"] = dev.window_s()
        line["device"]["launches_without_row"] = dev.missing
        line["breakdown"] = {"device_ops": dev.top_ops(),
                             "idle_gaps": dev.idle_gaps(record.spans)}
    line["check"] = {k: {"value": check[k], "limit": v}
                     for k, v in LIMITS.items()}
    line["check"]["checked"] = check["checked"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import bench
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "power_limit": power_limit()}

    from portbench import harness
    record, check, peak = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    off_card = {k: v for k, v in record.host_routes.items() if v}
    if off_card:
        print(f"portbench: the window planned off the card: {off_card}",
              file=sys.stderr)
        return 4
    t0 = time.perf_counter()
    line = result_line(cell, record, check, peak, device_info,
                       bool(args.trace))
    record.after["line_s"] = time.perf_counter() - t0
    print(f"portbench: setup {record.setup_s:.1f} s, window "
          f"{record.window_s:.1f} s, then "
          + ", ".join(f"{k} {v:.1f}" for k, v in record.after.items()),
          file=sys.stderr)
    for k, v in line["check"].items():
        if isinstance(v, dict):
            print(f"check {k} {v['value']} limit {v['limit']}",
                  file=sys.stderr)
    print(f"check checked {check['checked']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
