"""Carry densified scheduler state onto a device.

In this system the "weights" are the densified cluster columns: the numpy
``NodeInputs`` / ``GroupInputs`` / ``hier`` that a planner's
``_build_device_inputs`` builds from the scheduler's mirror, the
``StrategyInputs`` of a strategy group, and the ``FusedShared`` /
``FusedGroups`` / ``FusedCarry`` / ``FusedStrategy`` of a fused run.  The
functions here turn any of them -- this package's own, or ones built by
another implementation with the same field names and layouts -- into this
package's tensors on a given device, which is how the tests feed two
implementations the same inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .kernel import (
    FusedCarry, FusedGroups, FusedShared, FusedStrategy, GroupInputs,
    NodeInputs,
)

# the int64 columns of the fused run: resource amounts and demands
INT64_FIELDS = frozenset({"cpu", "mem", "cpu_d", "mem_d"})


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


def to_device(nodes, group, hier=(), device="cpu"):
    """(NodeInputs, GroupInputs, hier) as this package's tensors on
    ``device``."""
    dev = torch.device(device)
    return (nodes_to_device(nodes, dev), group_to_device(group, dev),
            hier_to_device(hier, dev))


def gang_to_device(rows: Sequence[Tuple], device) -> Tuple:
    """Per-gang (NodeInputs, GroupInputs) pairs of numpy arrays (either
    package's) stacked on a leading gang axis G, as this package's
    (NodeInputs, GroupInputs) of tensors on ``device`` -- the inputs of
    :func:`kernel.gang_fit_fused`.  ``quota_ok`` must be present in every
    gang or in none."""
    if not rows:
        raise ValueError("no gang to stack")
    quota = [getattr(nodes, "quota_ok", None) is not None
             for nodes, _ in rows]
    if any(quota) and not all(quota):
        raise ValueError("quota_ok must be stacked for every gang or None "
                         "for all")

    def stack(name, i):
        return np.stack([np.asarray(getattr(r[i], name)) for r in rows])

    nodes = NodeInputs(**{name: (None if name == "quota_ok" and not quota[0]
                                 else stack(name, 0))
                          for name in NodeInputs._fields})
    groups = GroupInputs(**{name: stack(name, 1)
                            for name in GroupInputs._fields})
    dev = torch.device(device)
    return nodes_to_device(nodes, dev), group_to_device(groups, dev)


def fused_to_device(shared, groups, carry, strat=None, device="cpu"):
    """(FusedShared, FusedGroups, FusedCarry, FusedStrategy or None) as
    this package's tensors on ``device``.  The carry is always a fresh
    copy: :func:`kernel.plan_fused` updates it in place, and on the CPU a
    tensor made from a numpy array shares its memory."""
    carry_t = named_to_device(FusedCarry, carry, device)
    carry_t = FusedCarry(*(t.clone() if t.device.type == "cpu" else t
                           for t in carry_t))
    return (named_to_device(FusedShared, shared, device),
            named_to_device(FusedGroups, groups, device), carry_t,
            None if strat is None
            else named_to_device(FusedStrategy, strat, device))
