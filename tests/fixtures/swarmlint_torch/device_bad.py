"""Fixture: every device-path-purity shape of the port in one module (fires).

The test harness lints this file as ``swarmkit_tpu_torch/ops/fixture.py``.
"""

import os

import numpy as np
import torch

from .cuda import CudaKernel

FEAS = CudaKernel("feasibility", "sk_feasibility", "csrc/f.cu", "k.py:1")
FILL = CudaKernel("waterfill", "sk_waterfill", "csrc/w.cu", "k.py:2")


def _fill_into(cap, k, out):
    """A kernel wrapper: launch stage."""
    n = int(k)                               # int() of a tensor: a sync
    if k.any():                              # control flow on a tensor
        FILL(n, cap.data_ptr(), out.data_ptr())
    print(out)                               # print of a tensor


def _mask_of(cap):
    """Called from a launch-stage function: launch stage too."""
    live = cap > 0
    kept = cap[live]                         # boolean-mask indexing
    return kept.nonzero(), torch.unique(cap)  # data-sized results


def plan_group_packed(nodes, cap, out, dev):
    """A ``*_packed`` composition: launch stage."""
    counts = nodes.tolist()                  # D2H
    total = cap.sum().item()                 # D2H
    host = cap.cpu()                         # D2H
    arr = out.numpy()                        # D2H
    spill = float(out[0])                    # float() of a tensor
    staged = torch.from_numpy(arr).to(dev)   # blocking pageable H2D
    moved = host.cuda()                      # blocking H2D
    out.copy_(staged)                        # blocking copy
    torch.cuda.synchronize()                 # an explicit sync
    picked = torch.masked_select(cap, cap > 1)  # data-sized and a mask
    _mask_of(cap)
    FEAS.launch(staged.data_ptr(), moved.data_ptr())
    return counts, total, spill, picked


class Planner:
    def dispatch_group(self, sched, group):
        """The planner's dispatch entry: launch stage."""
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"   # every launch a sync
        torch.cuda.set_sync_debug_mode("warn")     # a debug hook
        done = torch.cuda.Event()
        done.record()
        done.synchronize()                          # a sync in dispatch
        ready = bool(group.k)                       # bool() of a tensor
        return self._stage(group, ready)

    def _stage(self, group, ready):
        return group.k[group.k < 0]                 # mask from a callee


def _fill_plain(cap, k):
    """The plain version is torch: numpy here is a host fallback."""
    order = np.argsort(cap.numpy())
    return torch.from_numpy(np.cumsum(order))


def upload_columns(cols, dev):
    """Host driver: transfers nobody notes."""
    out = [torch.from_numpy(c).to(dev) for c in cols]   # unaccounted H2D
    back = out[0].cpu()                                  # unaccounted D2H
    return out, back


def refill_in_flight(stage, dev_buf, rows):
    """A pinned staging buffer rewritten while its copy still reads it,
    and an UploadStage refilled without waiting on host_view()."""
    from ..obs import devicetelemetry
    devicetelemetry.note_h2d("rows", rows.nbytes)
    dev_buf.copy_(stage.host, non_blocking=True)
    stage.host[0] = 1                        # write while the H2D reads it
    stage.upload()
    stage.host.numpy()[1] = 2                # write before host_view()


def read_in_flight(buf):
    """The pinned result of a D2H read before its copy has landed."""
    from ..obs import devicetelemetry
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    devicetelemetry.note_d2h("fetch", host.nbytes)
    return host.numpy()                      # no event waited on


def run_chunks(carry, chunks, dev):
    """The cross-shard shapes: the carry round-trips through the host
    between dispatches, and a resident tensor is uploaded again."""
    from ..obs import devicetelemetry
    devicetelemetry.note_h2d("chunks", 0)
    for c in chunks:
        total = carry.cpu()                  # D2H of the carry...
        plan_group_packed(carry, c, total, dev)  # ...that feeds a dispatch
    resident = carry.to(dev)
    again = resident.to(dev)                 # already on the device
    return again
