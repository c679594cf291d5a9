"""Carry densified scheduler state onto a device.

In this system the "weights" are the densified cluster columns: the numpy
``NodeInputs`` / ``GroupInputs`` / ``hier`` that a planner's
``_build_device_inputs`` builds from the scheduler's mirror, the
``StrategyInputs`` of a strategy group, and the ``FusedShared`` /
``FusedGroups`` / ``FusedCarry`` / ``FusedStrategy`` of a fused run, and
the ``CandidateSet`` of a preempting group.  The functions here turn any
of them -- this package's own, or ones built by another implementation
with the same field names and layouts -- into this package's tensors on a
given device, which is how the tests feed two implementations the same
inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import devicetelemetry as _devtel
from .kernel import (
    FusedCarry, FusedGroups, FusedShared, FusedStrategy, GroupInputs,
    NodeInputs, PendingFetch, StrategyInputs, UploadStage, _gang_layout,
    finish_fetch, gang_stage_layout, gang_views,
)
from .preempt import VictimInputs

# the int64 columns of the fused run: resource amounts and demands
INT64_FIELDS = frozenset({"cpu", "mem", "cpu_d", "mem_d"})


def resolve_device(device) -> torch.device:
    """The device a helper or planner runs on: ``None`` means the card.
    A CUDA device without CUDA raises: nothing drops to the CPU unless the
    caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is needed and none is available "
                           "(pass device='cpu' to run the plain PyTorch "
                           "versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tensor(a, device, wide: bool = False) -> torch.Tensor:
    """One numpy array or scalar as a contiguous tensor on ``device``:
    booleans stay ``torch.bool``, integers become ``torch.int32`` (the
    kernels' integer width), or ``torch.int64`` with ``wide``."""
    arr = np.asarray(a)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype != np.bool_:
        if arr.dtype.kind not in "iu":
            raise TypeError(f"unsupported input dtype {arr.dtype}")
        arr = arr.astype(np.int64 if wide else np.int32, copy=False)
    return torch.from_numpy(arr).to(device)


def named_to_device(cls, obj, device):
    """Any NamedTuple of arrays with ``cls``'s field names as ``cls`` of
    tensors on ``device``; absent or None members stay None, the
    ``INT64_FIELDS`` are int64."""
    dev = torch.device(device)
    return cls(**{name: (None if getattr(obj, name, None) is None else
                         tensor(getattr(obj, name), dev,
                                wide=name in INT64_FIELDS))
                  for name in cls._fields})


def nodes_to_device(nodes, device) -> NodeInputs:
    fields = {}
    for name in NodeInputs._fields:
        value = getattr(nodes, name)
        fields[name] = None if value is None else tensor(value, device)
    return NodeInputs(**fields)


def group_to_device(group, device) -> GroupInputs:
    return GroupInputs(**{name: tensor(getattr(group, name), device)
                          for name in GroupInputs._fields})


def hier_to_device(hier, device) -> Tuple:
    """``((seg_nodes, parent), ...), leaf_parent`` or ``()``."""
    if not hier:
        return ()
    upper, leaf_parent = hier
    return (tuple((tensor(seg, device), tensor(parent, device))
                  for seg, parent in upper),
            None if leaf_parent is None else tensor(leaf_parent, device))


def to_device(nodes, group, hier=(), device=None):
    """(NodeInputs, GroupInputs, hier) as this package's tensors on
    ``device`` (None: the card, see :func:`resolve_device`)."""
    dev = resolve_device(device)
    return (nodes_to_device(nodes, dev), group_to_device(group, dev),
            hier_to_device(hier, dev))


def gang_stage_key(rows: Sequence[Tuple]) -> Tuple[int, int, int, int, bool]:
    """(G, n, cc, np, quota) of per-gang (NodeInputs, GroupInputs) rows of
    numpy arrays (either package's): the shape of their packed gang stage.
    ``quota_ok`` must be present in every gang or in none."""
    if not rows:
        raise ValueError("no gang to stack")
    quota = [getattr(nodes, "quota_ok", None) is not None
             for nodes, _ in rows]
    if any(quota) and not all(quota):
        raise ValueError("quota_ok must be stacked for every gang or None "
                         "for all")
    nodes, group = rows[0]
    return (len(rows), np.shape(nodes.valid)[-1], np.shape(group.con_op)[-1],
            np.shape(group.plat)[0], quota[0])


def gang_to_device(rows: Sequence[Tuple], device) -> Tuple:
    """Per-gang (NodeInputs, GroupInputs) pairs of numpy arrays (either
    package's) stacked on a leading gang axis G, as this package's
    (NodeInputs, GroupInputs) of tensors on ``device`` -- the inputs of
    :func:`kernel.gang_fit_fused`.  ``quota_ok`` must be present in every
    gang or in none."""
    quota = gang_stage_key(rows)[4]

    def stack(name, i):
        return np.stack([np.asarray(getattr(r[i], name)) for r in rows])

    nodes = NodeInputs(**{name: (None if name == "quota_ok" and not quota
                                 else stack(name, 0))
                          for name in NodeInputs._fields})
    groups = GroupInputs(**{name: stack(name, 1)
                            for name in GroupInputs._fields})
    dev = torch.device(device)
    return nodes_to_device(nodes, dev), group_to_device(groups, dev)


class GangStage(UploadStage):
    """The packed staging buffer of one gang-verdict shape (``key``, see
    :func:`gang_stage_key`): the columns K8 reads for every gang of a
    verdict (``kernel.gang_stage_layout``), filled on the host and moved
    with ONE H2D, K8 reading them in place (``dev_views``); and the pinned
    buffer that takes the verdict back with ONE D2H."""

    __slots__ = ("key", "host_views", "dev_views", "result")

    def __init__(self, key: Tuple, device: torch.device):
        super().__init__(gang_stage_layout(*key)[1], device)
        self.key = key
        self.host_views = gang_views(self.host.numpy(), *key)
        self.dev_views = gang_views(self.dev, *key)
        self.result = torch.empty(_gang_layout(key[0])[2], dtype=torch.uint8,
                                  pin_memory=True) \
            if device.type == "cuda" else None

    def fill(self, rows: Sequence[Tuple]) -> None:
        """Pack ``rows`` into the host half, once no copy reads it, and
        move the stage to the device."""
        self.host_view()
        nodes, groups = self.host_views
        for g, (row_nodes, row_group) in enumerate(rows):
            for name, view in nodes._asdict().items():
                if view is not None:
                    view[g] = np.asarray(getattr(row_nodes, name))
            for name, view in groups._asdict().items():
                view[g] = np.asarray(getattr(row_group, name))
        self.upload()

    def fetch(self, out: torch.Tensor) -> np.ndarray:
        """K8's result buffer ``out`` as a numpy array: on the card one
        non-blocking copy into the stage's pinned buffer, waited for (the
        array is that buffer: read it before the stage's next verdict)."""
        if self.result is None:
            return out.numpy()
        self.result.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return finish_fetch(PendingFetch(self.result, event))


#: the most gang stages a planner keeps pinned: the number of gangs in a
#: verdict is not bounded, so the stage used longest ago goes
GANG_STAGES_KEPT = 16


def gang_stage(rows: Sequence[Tuple], device, stages: Dict) -> GangStage:
    """The stage of ``rows``' shape from ``stages`` (made there on first
    use, on ``device``; past :data:`GANG_STAGES_KEPT` stages the one used
    longest ago is dropped), filled with ``rows`` and uploaded."""
    key = gang_stage_key(rows)
    stage = stages.pop(key, None)
    if stage is None:
        stage = GangStage(key, torch.device(device))
        while len(stages) >= GANG_STAGES_KEPT:
            stages.pop(next(iter(stages)))
    stages[key] = stage
    stage.fill(rows)
    return stage


def fused_to_device(shared, groups, carry, strat=None, device=None):
    """(FusedShared, FusedGroups, FusedCarry, FusedStrategy or None) as
    this package's tensors on ``device`` (None: the card, see
    :func:`resolve_device`).  The carry is always a fresh copy:
    :func:`kernel.plan_fused` updates it in place, and on the CPU a tensor
    made from a numpy array shares its memory."""
    device = resolve_device(device)
    carry_t = named_to_device(FusedCarry, carry, device)
    carry_t = FusedCarry(*(t.clone() if t.device.type == "cpu" else t
                           for t in carry_t))
    return (named_to_device(FusedShared, shared, device),
            named_to_device(FusedGroups, groups, device), carry_t,
            None if strat is None
            else named_to_device(FusedStrategy, strat, device))


# ------------------------------------------------------ node-axis split

#: the fields of each input type that carry the node axis (their LAST
#: axis), as the reference's PartitionSpecs split them
#: (swarmkit_tpu/parallel/sharded.py:76-81, :123-125, :167-192); every
#: other field is replicated on each shard
SPLIT_FIELDS = {
    NodeInputs: frozenset(NodeInputs._fields),
    GroupInputs: frozenset({"con_hash"}),
    StrategyInputs: frozenset({"hr_cpu", "hr_mem", "hr_gen"}),
    FusedShared: frozenset(FusedShared._fields),
    FusedGroups: frozenset({"con_hash", "failures", "leaf", "extra_mask",
                            "quota_ok"}),
    FusedCarry: frozenset(FusedCarry._fields),
    FusedStrategy: frozenset(),
}


def pad_nodes(a, d: int) -> np.ndarray:
    """A node-axis array padded with zeros (False) on its last axis to a
    multiple of ``d``: padded rows are invalid nodes (valid = False, so
    zero capacity), as the reference pads (``sharded.py:315-334``)."""
    arr = np.asarray(a)
    pad = -arr.shape[-1] % d
    if not pad:
        return arr
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, pad)])


def shard_to_device(obj, cls, devices: Sequence) -> List:
    """Any NamedTuple of numpy arrays with ``cls``'s field names (either
    package's) split on the node axis over ``devices``: one ``cls`` of
    tensors per shard, on that shard's device.  ``SPLIT_FIELDS[cls]`` are
    padded to a multiple of the shard count and cut into equal contiguous
    slices (copies, never views of the caller's arrays); the other fields
    are copied whole to every shard.  Absent or
    None members stay None; ``INT64_FIELDS`` are int64."""
    d = len(devices)
    split = SPLIT_FIELDS[cls]
    arrays = {}
    for name in cls._fields:
        v = getattr(obj, name, None)
        if v is not None and name in split:
            v = pad_nodes(v, d)
        arrays[name] = v
    out = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        fields = {}
        for name, v in arrays.items():
            if v is None:
                fields[name] = None
                continue
            if name in split:
                ln = v.shape[-1] // d
                # a copy: on the CPU a tensor made from a numpy view
                # shares its memory, and the fused carry is updated in
                # place
                v = np.array(v[..., i * ln:(i + 1) * ln])
            fields[name] = tensor(v, dev, wide=name in INT64_FIELDS)
        out.append(cls(**fields))
    return out


def shard_hier(hier, devices: Sequence) -> List[Tuple]:
    """A spread tree's ``((seg_nodes, parent), ...), leaf_parent`` per
    shard: the node-level segment columns split, the branch-level parent
    maps replicated (``sharded.py:112-115``); ``()`` stays ``()``."""
    if not hier:
        return [() for _ in devices]
    d = len(devices)
    upper, leaf_parent = hier
    segs = [pad_nodes(seg, d) for seg, _ in upper]
    out = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        levels = []
        for seg, (_, parent) in zip(segs, upper):
            ln = seg.shape[-1] // d
            levels.append((tensor(seg[i * ln:(i + 1) * ln], dev),
                           tensor(parent, dev)))
        out.append((tuple(levels), None if leaf_parent is None
                    else tensor(leaf_parent, dev)))
    return out


# victim candidates, packed: the int64 columns, then vprio (int32), then the
# two masks (bytes), so every part starts at a multiple of its item size.
# (field, item size, carries the victim axis)
VICTIM_FIELDS = (("free_cpu", 8, False), ("free_mem", 8, False),
                 ("free_gen", 8, False), ("vcpu", 8, True),
                 ("vmem", 8, True), ("vgen", 8, True), ("vprio", 4, True),
                 ("ok", 1, False), ("vvalid", 1, True))
_VICTIM_DTYPES = {8: (np.int64, torch.int64), 4: (np.int32, torch.int32),
                  1: (np.bool_, torch.bool)}


def victim_layout(nb: int, v: int):
    """([(field, byte offset, byte count, item size, shape)], total bytes)
    of the packed victim inputs: 25 nb + 29 v nb bytes in all."""
    out, off = [], 0
    for name, size, wide in VICTIM_FIELDS:
        shape = (v, nb) if wide else (nb,)
        count = size * int(np.prod(shape))
        out.append((name, off, count, size, shape))
        off += count
    return out, off


def victims_to_device(cand, nb: int, device, stages: Optional[Dict] = None):
    """A ``CandidateSet``'s arrays (either package's), padded to ``nb``
    nodes, as this package's ``ops.preempt.VictimInputs`` on ``device``:
    packed into one staging buffer and moved with ONE copy.  ``stages``
    keeps the buffers per shape across calls (None makes fresh ones); the
    tensors returned are views of the stage's device half, so they hold
    the data of the latest call on that shape."""
    dev = torch.device(device)
    v, n = np.asarray(cand.vvalid).shape
    layout, nbytes = victim_layout(nb, v)
    key = (dev, nb, v)
    stage = None if stages is None else stages.get(key)
    if stage is None:
        stage = UploadStage(nbytes, dev)
        if stages is not None:
            stages[key] = stage
    host = stage.host_view()
    for name, off, count, size, shape in layout:
        view = host[off:off + count].view(_VICTIM_DTYPES[size][0])
        view = view.reshape(shape)
        view[..., :n] = getattr(cand, name)
        view[..., n:] = 0
    _devtel.note_h2d("preempt_inputs", nbytes)
    buf = stage.upload()
    return VictimInputs(**{
        name: buf[off:off + count].view(_VICTIM_DTYPES[size][1]).view(shape)
        for name, off, count, size, shape in layout})
