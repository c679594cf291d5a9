"""The node-axis split of the scheduling kernels over a mesh of shards.

Counterpart of the reference's ``swarmkit_tpu/parallel/sharded.py``: the
tasks x nodes problem is split on the NODE axis, each shard owning nb/D
rows of every node column.  The only cross-node dependencies of a plan are
the eight fail counts, stage A's branch sums and the steps of the
node-level binary searches (the reference's ``psum`` operands), so a
sharded plan is the unsharded plan's composition with those sums taken
over the shards: ``ops/kernel.py`` ``plan_group_sharded_packed``,
``plan_strategy_sharded_packed`` and ``plan_fused_sharded_packed`` on the
card, through K10 (``csrc/shardfill.cu``), K11 (``csrc/shardpack.cu``) and
K2's fold.  On CPU shards the same compositions run the kernels' plain
versions, and take a ``reduce`` callable (the reference's ``psum``) that
every cross-shard sum but the fail counts' goes through.

A mesh (:class:`NodeMesh`) is an ordered tuple of devices, one per shard;
one card may appear several times, so a single H100 runs a D-shard mesh
with D sets of tensors, which exchange their partial sums through one
buffer.  A mesh over several cards raises: its exchange (peer copies or
NCCL) is not built yet.

Not ported: ``mesh_from_env``.  The port has no environment knobs; a
caller passes ``TorchPlanner(mesh=make_mesh(...))``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..obs import devicetelemetry as _devtel
from ..ops import kernel as K
from ..ops.convert import shard_hier, shard_to_device
from ..ops.kernel import (
    FusedCarry, FusedGroups, FusedShared, FusedStrategy, GroupInputs,
    NodeInputs, StrategyInputs,
)
NODE_AXIS = "nodes"


class NodeMesh:
    """The counterpart of a one-axis ``jax.sharding.Mesh``: an ordered
    tuple of devices, shard d on ``devices[d]``.  A device may appear more
    than once (several shards on one card); every device is the CPU, or
    every one is the same card."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        devs = []
        for dev in devices:
            dev = torch.device(dev)
            if dev.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported mesh device {dev}")
            if dev.type == "cuda" and dev.index is None \
                    and torch.cuda.is_available():
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) > 1 and any(d.type == "cuda" for d in devs):
            raise ValueError(
                f"a mesh over {sorted(set(map(str, devs)))} is not "
                "supported: its shards must share one card (the exchange "
                "between several cards is not built); use "
                "make_mesh(['cuda:0'] * D)")
        if devs[0].type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device; none is "
                               "available")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        """``{"nodes": D}``, as a jax mesh's ``shape``."""
        return {NODE_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None) -> NodeMesh:
    """A mesh over ``devices``; None takes every visible CUDA card, and
    raises where there is none or (for now) more than one.
    ``make_mesh(["cuda:0"] * 4)`` gives four shards on one card; the CPU
    tests use ``make_mesh(["cpu"] * 4)``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a CUDA device; none is "
                               "available (pass devices=['cpu', ...] for "
                               "the plain PyTorch versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return NodeMesh(devices)


# ------------------------------------------------------ sharded resident tier
#
# The streaming planner's device tier (ops/streaming.ResidentState) on a
# mesh: each shard holds its nb/D rows of the five node-state columns on
# its device.  A refresh needs nothing of its own here: its dirty rows go
# to the card in one buffer with their global indices, and one K7 launch
# (``kernel.scatter_rows`` over the shard table, the counterpart of the
# reference's ``scatter_rows_sharded``) writes each row into the shard
# that owns it.  The node bucket must divide evenly over the mesh;
# ResidentState demotes to the single-device tier otherwise.

def put_resident(cols, mesh: NodeMesh) -> tuple:
    """Mesh placement of the five resident columns (valid, ready, cpu,
    mem, total; numpy, nb rows): a tuple of five columns, each a tuple of
    D per-shard tensors on their devices (one H2D per shard and column).
    The caller notes the bytes."""
    d = mesh.size
    out = []
    for col in cols:
        ln = col.shape[0] // d
        out.append(tuple(
            torch.from_numpy(np.ascontiguousarray(
                col[i * ln:(i + 1) * ln])).to(dev, copy=True)
            for i, dev in enumerate(mesh.devices)))
    return tuple(out)


# ---------------------------------------------------------- the plans

def shard_group(nodes, group, hier, mesh: NodeMesh) -> List[tuple]:
    """Numpy NodeInputs / GroupInputs / hier (either package's) as each
    shard's (NodeInputs, GroupInputs, hier) on its device, the node axis
    padded to a multiple of D."""
    devs = mesh.devices
    return list(zip(shard_to_device(nodes, NodeInputs, devs),
                    shard_to_device(group, GroupInputs, devs),
                    shard_hier(hier, devs)))


def plan_group_sharded(nodes, group, L: int, mesh: NodeMesh, hier=()):
    """(x np.int32[N], fail_counts np.int32[8], spill bool) of one group
    planned over ``mesh`` (reference ``plan_group_sharded``), from numpy
    inputs; waits for the result."""
    n = np.asarray(nodes.valid).shape[-1]
    pending = ShardedPlanFn(mesh)(nodes, group, L, hier)
    return K.unpack_plan(K.finish_fetch(pending), n)


def plan_strategy_sharded(nodes, group, sin, strategy: int,
                          mesh: NodeMesh):
    """(x, fail_counts, spill = False) of one non-spread group over
    ``mesh`` (reference ``plan_strategy_sharded``), from numpy inputs."""
    n = np.asarray(nodes.valid).shape[-1]
    pending = ShardedPlanFn(mesh).strategy(nodes, group, sin, strategy)
    return K.unpack_plan(K.finish_fetch(pending), n)


def plan_fused_sharded(shared, groups, carry, L: int, mesh: NodeMesh,
                       strat=None, sids=None):
    """(x [G, N], fail_counts [G, 8], spill [G], per-shard carries) of one
    fused chunk over ``mesh`` (reference ``plan_fused_sharded``), from
    numpy inputs; the node bucket must divide by D."""
    fn = ShardedPlanFn(mesh)
    s_shared, s_carry = fn.prepare_fused(shared, carry)
    arr = K.finish_fetch(fn.fused(s_shared, groups, s_carry, L, strat,
                                  sids))
    return (*K.unpack_fused(arr, np.asarray(shared.valid).shape[-1]),
            s_carry)


def _sids_of(strat, g_count: int) -> List[int]:
    return [0] * g_count if strat is None \
        else [int(v) for v in np.asarray(strat.sid)]


class ShardedPlanFn:
    """The planner's sharded plan entry (reference ``ShardedPlanFn``):
    numpy inputs in, each shard's result rows dispatched on its device and
    their D2H enqueued into one pinned buffer; nothing waits.  The
    per-group and strategy routes pad the node axis to a multiple of D
    with invalid rows; the fused route requires it to divide.  Every
    route plans every strategy, so the reference's ``supports_strategies``
    flag has no counterpart."""

    def __init__(self, mesh: Optional[NodeMesh] = None):
        self.mesh = mesh or make_mesh()

    def __call__(self, nodes, group, L: int, hier=()) -> K.PendingFetch:
        n = np.asarray(nodes.valid).shape[-1]
        bufs = K.plan_group_sharded_packed(
            shard_group(nodes, group, hier, self.mesh), L)
        return K.start_fetch_shards(bufs, n)

    def strategy(self, nodes, group, sin, sid: int) -> K.PendingFetch:
        n = np.asarray(nodes.valid).shape[-1]
        shards = [(nd, gd) for nd, gd, _ in
                  shard_group(nodes, group, (), self.mesh)]
        sins = None if sin is None else shard_to_device(
            sin, StrategyInputs, self.mesh.devices)
        return K.start_fetch_shards(
            K.plan_strategy_sharded_packed(shards, sins, sid), n)

    def prepare_fused(self, shared, carry, resident=None):
        """A fused run's node state placed on the mesh once, for every
        chunk of the run: (per-shard FusedShared, per-shard FusedCarry).
        ``resident`` (the streaming fast path): the five node-state
        columns already split over THIS mesh (``ResidentState.device``
        tier); valid and ready then alias them, the carry's total, cpu and
        mem are device-to-device clones per shard (the run updates its
        carry in place), and only the hashes and service columns move."""
        n = np.asarray(shared.valid).shape[-1]
        d = self.mesh.size
        if n % d:
            raise ValueError(f"fused node bucket {n} not divisible by mesh "
                             f"size {d}")
        devs = self.mesh.devices
        if resident is None:
            staged = [np.asarray(a) for a in (*shared, *carry)]
            _devtel.note_h2d("mesh_reshard", _devtel.tree_nbytes(staged))
            return (shard_to_device(shared, FusedShared, devs),
                    shard_to_device(carry, FusedCarry, devs))
        d_valid, d_ready, d_cpu, d_mem, d_total = resident
        extras = [np.asarray(a) for a in (shared.os_hash, shared.arch_hash,
                                          shared.svc0, carry.svc_acc)]
        _devtel.note_h2d("mesh_reshard", _devtel.tree_nbytes(extras))
        part_s = shard_to_device(shared._replace(valid=None, ready=None),
                                 FusedShared, devs)
        part_c = shard_to_device(carry._replace(total=None, cpu=None,
                                                mem=None), FusedCarry, devs)
        shareds, carries, cloned = [], [], 0
        for s in range(d):
            shareds.append(part_s[s]._replace(valid=d_valid[s],
                                              ready=d_ready[s]))
            total, cpu, mem = (d_total[s].clone(), d_cpu[s].clone(),
                               d_mem[s].clone())
            cloned += total.nbytes + cpu.nbytes + mem.nbytes
            carries.append(part_c[s]._replace(total=total, cpu=cpu,
                                              mem=mem))
        _devtel.note_d2d("resident_carry", cloned)
        return shareds, carries

    def fused(self, shared, groups, carry, L: int, strat=None,
              sids=None) -> K.PendingFetch:
        """Dispatch one chunk: ``shared`` and ``carry`` from
        :meth:`prepare_fused`, ``groups`` / ``strat`` as numpy (split and
        moved here); ``sids`` the host's strategy id per slot (default:
        ``strat.sid``).  The carry is updated in place."""
        devs = self.mesh.devices
        g_count = np.asarray(groups.k).shape[0]
        sids = _sids_of(strat, g_count) if sids is None else list(sids)
        groupss = shard_to_device(groups, FusedGroups, devs)
        strats = None if strat is None else shard_to_device(
            strat, FusedStrategy, devs)
        bufs = K.plan_fused_sharded_packed(shared, groupss, carry, L, strats,
                                           sids)
        return K.start_fetch_shards(bufs, shared[0].valid.shape[0] * len(devs))
