"""Fixture: the corrected twin — syncs only in the fetch stage, every
transfer accounted, pinned buffers waited on before reuse.

The test harness lints this file as ``swarmkit_tpu_torch/ops/fixture.py``.
"""

import numpy as np
import torch

from ..obs import devicetelemetry as _devtel
from .cuda import CudaKernel

FEAS = CudaKernel("feasibility", "sk_feasibility", "csrc/f.cu", "k.py:1")
FILL = CudaKernel("waterfill", "sk_waterfill", "csrc/w.cu", "k.py:2")
I32 = torch.int32


def _on_cuda(t):
    return t.device.type == "cuda"


def _fill_plain(cap, k):
    """The plain version: torch only."""
    order = torch.argsort(cap)
    return torch.cumsum(order, 0).to(I32)


def _fill_into(cap, k, out, n_rows):
    """A kernel wrapper: host sizes only, the CPU twin in its own arm."""
    if not _on_cuda(cap):
        out.copy_(_fill_plain(cap, k))       # CPU tensors: no card
        return
    n = int(len(n_rows))                     # a host value
    FILL(n, cap.data_ptr(), k.data_ptr(), out.data_ptr())


def plan_group_packed(nodes, cap, k, out, sids):
    """A ``*_packed`` composition: everything stays on the card."""
    kept = torch.where(cap > 0, cap, torch.zeros_like(cap))
    strategy = sids[0]                       # the host's own copy
    _fill_into(kept, k, out, nodes)
    FEAS.launch(out.data_ptr(), strategy)
    return out


class UploadStage:
    def host_view(self):
        """The pinned result's read: waits first (the fetch stage)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def upload(self):
        _devtel.note_h2d("stage", self.host.nbytes)   # the seam notes it
        self.dev.copy_(self.host, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return self.dev


class Planner:
    def dispatch_group(self, sched, group, stage):
        """The dispatch entry: one staged non-blocking upload, launches,
        one non-blocking D2H; nothing waits."""
        _devtel.note_h2d("group_inputs", group.nbytes)
        view = stage.host_view()
        view[:] = group.packed
        dev = stage.upload()
        out = plan_group_packed(group.nodes, dev, group.k, group.out,
                                group.sids)
        return start_fetch(out)

    def fetch_group(self, pending):
        rows = finish_fetch(pending)
        _devtel.note_d2h("fetch", int(rows.nbytes))
        return np.asarray(rows).tolist()


def start_fetch(buf):
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_fetch(pending):
    host, event = pending
    event.synchronize()
    return host.numpy()


def upload_columns(cols, dev):
    """Host driver: pinned, non-blocking, and noted in the ledger."""
    _devtel.note_h2d("cold_build", sum(c.nbytes for c in cols))
    return [torch.from_numpy(c).pin_memory().to(dev, non_blocking=True)
            for c in cols]


def refill_after_wait(stage, dev_buf, rows):
    """The staging buffer is written again only after its copy's event."""
    _devtel.note_h2d("rows", rows.nbytes)
    dev_buf.copy_(stage.host, non_blocking=True)
    stage.event.synchronize()
    stage.host[0] = 1


def run_chunks(carry, chunks, dev):
    """The carry stays on the card between dispatches; one upload."""
    _devtel.note_h2d("chunks", 0)
    resident = carry.to(dev, non_blocking=True)
    for c in chunks:
        plan_group_packed(resident, c, c.k, c.out, c.sids)
    return resident
