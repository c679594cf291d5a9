"""The scheduling kernels: batched group placement on the card.

PyTorch counterpart of ``swarmkit_tpu/ops/kernel.py``: the per-group spread
and strategy routes and the fused many-service route.  Hand-written CUDA
kernels (``csrc/``) carry them on Hopper:

* ``feasibility`` (K1, ``csrc/feasibility.cu``): the fused filter pipeline,
  per-node capacity and the eight short-circuit failure counts;
* ``seg_sum`` (K2, ``csrc/segsum.cu``): per-branch int64 load and capacity
  sums for stage A of the hierarchical water-fill, clamped in the same
  launch;
* ``waterfill`` (K3, ``csrc/waterfill.cu``): both 34-step binary searches
  of one capacity-bounded water-fill in a single launch of one
  thread-block cluster, for any number of segments;
* ``fused_feasibility`` (K1F, ``csrc/fused.cu``): the slot entry of the
  fused plan -- the previous slot's placements added into the carried
  cluster state, this slot's resource columns derived from it and K1's
  filters run on them, in one launch a slot; for a weighted or learned
  slot (``fused_feasibility_scored``) K6's score is the same launch's
  epilogue; ``fused_carry`` (K4's carry update, the same file) adds a
  chunk's last placements after its last fill;
* ``packfill`` (K5, ``csrc/packfill.cu`` + ``packfill.cuh``): the binpack
  key, threshold select and pack fill of one group over all nodes, in one
  launch of one block (a radix select of the threshold key, not a
  bisection);
* ``strategy_score`` (K6, ``csrc/score.cu``): the weighted and learned
  (fixed-point MLP) scores, in exact int32, the public scoring stage; the
  plans score in K1's and K1F's epilogue (``csrc/feasibility.cuh``);
* ``scatter_rows`` (K7, ``csrc/scatter.cu``): the streaming scheduler's
  dirty-row scatter into its five resident node columns, in place, one
  launch a refresh over a table of the columns' shards (one unsplit);
* ``gang_fit`` / ``gang_fit_fused`` (K8, ``csrc/gangfit.cu``): the gang
  all-or-nothing precheck, K1's per-node body summed per gang, for one
  gang or a stack of them, the blocks of a gang meeting in five
  self-counting atomic words;
* ``shard_waterfill`` (K10, ``csrc/shardfill.cu``): the node-level
  water-fill over a node-axis split, K3's cluster kernel over every
  shard's rows in one launch a fill;
* ``shard_packfill`` (K11, ``csrc/shardpack.cu``): the pack fill over a
  node-axis split, K5's kernel over every shard's rows in one launch a
  fill;
* ``shard_seg_sum`` (K2 over a node-axis split, ``csrc/segsum.cu``): a
  stage-A level's branch sums over every shard's rows in one launch, so
  the level's stage-A fill (K3) runs once a card.

Every wrapper below takes the kernel for tensors on a CUDA device and its
plain PyTorch version, in this module, for tensors on the CPU; on any other
device it raises.  There is no fallback from one to the other: on a CUDA
tensor a wrapper launches its kernel or raises.

Inputs keep the reference's field names, layouts and integer envelope
(``K_CLAMP``, ``IDX_BITS``, ``LOAD_CLAMP``, ``TOTAL_CLAMP``, ``F_BIG``,
``FAILURE_CLAMP``, ``SVC_CLAMP``, 34-step searches).  Segment sums are
int64 here where the reference sums in float32: exact and the same in every
order, and equal to the reference on every decision, because float32 sums
of non-negative integers are exact below 2^24 and stay >= 2^24 above it,
while every bound they are compared or clamped against (k <= K_CLAMP,
LOAD_CLAMP) lies below 2^24.

Outputs of one plan land in ONE int32 buffer ``[x (N) | fail_counts (8) |
spill (1)]`` and those of one feasibility call in one byte buffer
``[cap (N) | fail_counts (8) as int32 | mask (N) as uint8]``, so the
planner moves each result to the host with a single copy
(:func:`start_fetch` / :func:`finish_fetch`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import ctypes

import numpy as np
import torch

from ..scheduler.nodeinfo import MAX_FAILURES
from ..scheduler.strategy import (
    BP_CLAMP, FEAT_CLAMP, HR_CLAMP, MLP_FEATURES, MLP_SHIFT, SCORE_CLAMP,
    STRAT_BINPACK, STRAT_LEARNED, STRAT_SPREAD, STRAT_WEIGHTED,
)
from . import cuda as _cuda

F_BIG = 1 << 22          # failure down-weight step (dominates svc counts)
FAILURE_CLAMP = 63       # keeps e = svc + failures*F_BIG inside int32
SVC_CLAMP = (1 << 20) - 1
K_CLAMP = 1 << 22        # max group size the kernels accept
LOAD_CLAMP = (1 << 24) - 1   # branch-load clamp
LEVEL_ITERS = 34         # binary search over [0, 2^30]
TIE_ITERS = 34           # binary search over packed 31-bit tie keys
IDX_BITS = 20
TOTAL_CLAMP = (1 << 10) - 1
SEARCH_HI = 1 << 30
N_FILTERS = 8            # fail_counts rows, pipeline order

FEASIBILITY = _cuda.CudaKernel(
    "feasibility", "sk_feasibility", "swarmkit_tpu_torch/csrc/feasibility.cu",
    "swarmkit_tpu/ops/kernel.py:190")
SEG_SUM = _cuda.CudaKernel(
    "seg_sum", "sk_seg_sum", "swarmkit_tpu_torch/csrc/segsum.cu",
    "swarmkit_tpu/ops/kernel.py:305")
WATERFILL = _cuda.CudaKernel(
    "waterfill", "sk_waterfill", "swarmkit_tpu_torch/csrc/waterfill.cu",
    "swarmkit_tpu/ops/kernel.py:127")
FUSED_FEASIBILITY = _cuda.CudaKernel(
    "fused_feasibility", "sk_fused_feasibility",
    "swarmkit_tpu_torch/csrc/fused.cu", "swarmkit_tpu/ops/kernel.py:640")
FUSED_SCORED = _cuda.CudaKernel(
    "fused_feasibility_scored", "sk_fused_feasibility",
    "swarmkit_tpu_torch/csrc/fused.cu", "swarmkit_tpu/ops/kernel.py:484")
FUSED_CARRY = _cuda.CudaKernel(
    "fused_carry", "sk_fused_carry", "swarmkit_tpu_torch/csrc/fused.cu",
    "swarmkit_tpu/ops/kernel.py:715")
PACKFILL = _cuda.CudaKernel(
    "packfill", "sk_packfill", "swarmkit_tpu_torch/csrc/packfill.cu",
    "swarmkit_tpu/ops/kernel.py:428")
SCORE = _cuda.CudaKernel(
    "strategy_score", "sk_strategy_score", "swarmkit_tpu_torch/csrc/score.cu",
    "swarmkit_tpu/ops/kernel.py:484")
SCATTER = _cuda.CudaKernel(
    "scatter_rows", "sk_scatter_rows", "swarmkit_tpu_torch/csrc/scatter.cu",
    "swarmkit_tpu/ops/streaming.py:97")
GANG_FIT = _cuda.CudaKernel(
    "gang_fit", "sk_gang_fit", "swarmkit_tpu_torch/csrc/gangfit.cu",
    "swarmkit_tpu/ops/kernel.py:786")
SHARD_SEG_SUM = _cuda.CudaKernel(
    "shard_seg_sum", "sk_shard_seg_sum", "swarmkit_tpu_torch/csrc/segsum.cu",
    "swarmkit_tpu/parallel/sharded.py:95")
SHARD_WATERFILL = _cuda.CudaKernel(
    "shard_waterfill", "sk_shard_waterfill",
    "swarmkit_tpu_torch/csrc/shardfill.cu",
    "swarmkit_tpu/parallel/sharded.py:95")
SHARD_PACKFILL = _cuda.CudaKernel(
    "shard_packfill", "sk_shard_packfill",
    "swarmkit_tpu_torch/csrc/shardpack.cu",
    "swarmkit_tpu/parallel/sharded.py:137")
KERNELS = (FEASIBILITY, SEG_SUM, WATERFILL, FUSED_FEASIBILITY, FUSED_SCORED,
           FUSED_CARRY, PACKFILL, SCORE, SCATTER, GANG_FIT, SHARD_SEG_SUM,
           SHARD_WATERFILL, SHARD_PACKFILL)

# K6 and the score epilogue stage the learned scorer's hidden layer in
# shared memory
SCORE_MAX_HIDDEN = 64


class GroupInputs(NamedTuple):
    """Per-(service, spec-version) task-group inputs."""

    k: torch.Tensor              # i32 scalar: number of tasks to place
    con_hash: torch.Tensor       # i32[Cc, 2, N]: node hash (hi,lo) per slot
    con_op: torch.Tensor         # i32[Cc]: 0 ==, 1 !=, 2 disabled
    con_exp: torch.Tensor        # i32[Cc, 2]: expected (hi,lo)
    plat: torch.Tensor           # i32[P, 4]: (os_hi, os_lo, arch_hi, arch_lo);
    #                              row -1 sentinel in col 0 = unused
    maxrep: torch.Tensor         # i32 scalar: max replicas per node (0 = off)
    port_limited: torch.Tensor   # bool scalar: group publishes host ports


class NodeInputs(NamedTuple):
    """Cluster-wide node state (SoA), densified host-side."""

    valid: torch.Tensor          # bool[N] (padding mask)
    ready: torch.Tensor          # bool[N] READY && ACTIVE
    res_ok: torch.Tensor         # bool[N] node meets this group's reservations
    res_cap: torch.Tensor        # i32[N] tasks the node's resources can absorb
    svc_tasks: torch.Tensor      # i32[N] active tasks of this service
    total_tasks: torch.Tensor    # i32[N] active tasks total
    failures: torch.Tensor       # i32[N] recent failures for this service
    leaf: torch.Tensor           # i32[N] spread-preference leaf id (0 if none)
    os_hash: torch.Tensor        # i32[2, N] node platform.os hash (hi, lo)
    arch_hash: torch.Tensor      # i32[2, N] normalized arch hash (hi, lo)
    port_conflict: torch.Tensor  # bool[N] a requested host port is taken
    extra_mask: torch.Tensor     # bool[N] plugin/volume masks ANDed host-side
    # tenant-quota mask column: all-False when the group's tenant was
    # exhausted at admission; None means every node passes
    quota_ok: Optional[torch.Tensor] = None   # bool[N] or None


# ------------------------------------------------------------ input checks

def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); anything else is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cuda or cpu)")


def _check(name: str, t: Optional[torch.Tensor], dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_feasibility_inputs(nodes: NodeInputs,
                              group: GroupInputs) -> Tuple[int, int, int]:
    dev = nodes.valid.device
    n = nodes.valid.shape[0]
    cc = group.con_op.shape[0]
    npl = group.plat.shape[0]
    b, i32 = torch.bool, torch.int32
    for name in ("valid", "ready", "res_ok", "port_conflict", "extra_mask"):
        _check(name, getattr(nodes, name), b, (n,), dev)
    for name in ("res_cap", "svc_tasks", "total_tasks", "failures", "leaf"):
        _check(name, getattr(nodes, name), i32, (n,), dev)
    _check("os_hash", nodes.os_hash, i32, (2, n), dev)
    _check("arch_hash", nodes.arch_hash, i32, (2, n), dev)
    if nodes.quota_ok is not None:
        _check("quota_ok", nodes.quota_ok, b, (n,), dev)
    _check("con_hash", group.con_hash, i32, (cc, 2, n), dev)
    _check("con_op", group.con_op, i32, (cc,), dev)
    _check("con_exp", group.con_exp, i32, (cc, 2), dev)
    _check("plat", group.plat, i32, (npl, 4), dev)
    _check("k", group.k, i32, (), dev)
    _check("maxrep", group.maxrep, i32, (), dev)
    _check("port_limited", group.port_limited, b, (), dev)
    return n, cc, npl


# ------------------------------------------------- K1: feasibility/capacity

def _feasibility_plain(nodes: NodeInputs, group: GroupInputs,
                       scored: Optional[Tuple] = None):
    """Plain version of K1: (mask bool[N], cap i32[N], fail i32[8]); with
    ``scored`` = (StrategyInputs, strategy) also the level e i32[N] of the
    scored launch (:func:`_strategy_score_plain`)."""
    i32 = torch.int32
    ch = group.con_hash
    eq = (ch[:, 0, :] == group.con_exp[:, 0:1]) \
        & (ch[:, 1, :] == group.con_exp[:, 1:2])             # [Cc, N]
    op = group.con_op[:, None]
    con_ok = torch.where(op == 0, eq, torch.where(op == 1, ~eq,
                                                  torch.ones_like(eq)))
    con_m = con_ok.all(dim=0)

    row = group.plat                                         # [P, 4]
    used = row[:, 0] != -1
    os_ok = ((row[:, 0] == 0) & (row[:, 1] == 0))[:, None] | (
        (nodes.os_hash[0][None, :] == row[:, 0:1])
        & (nodes.os_hash[1][None, :] == row[:, 1:2]))
    arch_ok = ((row[:, 2] == 0) & (row[:, 3] == 0))[:, None] | (
        (nodes.arch_hash[0][None, :] == row[:, 2:3])
        & (nodes.arch_hash[1][None, :] == row[:, 3:4]))
    matched = (used[:, None] & os_ok & arch_ok).any(dim=0)
    plat_m = matched | ~used.any()

    port_m = ~(group.port_limited & nodes.port_conflict)
    rep_m = (group.maxrep == 0) | (nodes.svc_tasks < group.maxrep)
    quota_m = nodes.quota_ok if nodes.quota_ok is not None \
        else torch.ones_like(nodes.ready)

    mask = nodes.valid
    fails = []
    for m in (nodes.ready, nodes.res_ok, nodes.extra_mask, con_m, plat_m,
              port_m, rep_m, quota_m):
        fails.append((mask & ~m).sum(dtype=i32))
        mask = mask & m
    fail_counts = torch.stack(fails).to(i32)

    cap = torch.minimum(nodes.res_cap, torch.clamp(group.k, max=K_CLAMP))
    cap = torch.where(group.maxrep > 0,
                      torch.minimum(cap, torch.clamp(
                          group.maxrep - nodes.svc_tasks, min=0)), cap)
    cap = torch.where(group.port_limited, torch.clamp(cap, max=1), cap)
    cap = torch.where(mask, torch.clamp(cap, min=0),
                      torch.zeros_like(cap)).to(i32)
    if scored is None:
        return mask, cap, fail_counts
    return mask, cap, fail_counts, _strategy_score_plain(nodes, *scored)


class _ScoreTable(ctypes.Structure):
    """The score epilogue's table (``csrc/feasibility.cuh`` ScoreArgs):
    what a scored K1 or K1F reads and writes beside its filters."""

    _fields_ = [("mode", ctypes.c_int), ("hidden", ctypes.c_int),
                ("max_failures", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in (
            "weights", "w1", "b1", "w2", "b2", "failures", "hr_cpu",
            "hr_mem", "hr_gen", "e")]


def _score_table(strategy: int, failures: torch.Tensor, e: torch.Tensor,
                 params=None, hr=None) -> _ScoreTable:
    """The table of one scored launch: the group's ``failures``, the
    output ``e``, the strategy's ``params`` (weights, w1, b1, w2, b2), of
    which weighted mode reads the weights and learned mode the MLP (None
    for spread), and K1's headroom columns ``hr`` (hr_cpu, hr_mem, hr_gen;
    None where the kernel derives them, K1F)."""
    weights, w1, b1, w2, b2 = params if params is not None else (None,) * 5
    learned = strategy == STRAT_LEARNED
    mlp = (w1, b1, w2, b2) if learned else (None,) * 4
    return _ScoreTable(
        int(strategy), w1.shape[-1] if learned else 0, MAX_FAILURES,
        *map(_cuda.ptr, (weights if strategy == STRAT_WEIGHTED else None,
                         *mlp, failures, *(hr or (None,) * 3), e)))


def _feasibility_into(nodes: NodeInputs, group: GroupInputs,
                      mask_out: Optional[torch.Tensor],
                      cap_out: torch.Tensor, fail_out: torch.Tensor,
                      scored: Optional[Tuple] = None,
                      e_out: Optional[torch.Tensor] = None) -> None:
    """Write K1's results into caller-owned views.  ``fail_out`` must hold
    zeros (the kernel adds its counts); ``mask_out`` may be None.  With
    ``scored`` = (StrategyInputs, strategy) the same launch writes the
    level of :func:`strategy_score` into ``e_out`` (the score epilogue)."""
    n, cc, npl = _check_feasibility_inputs(nodes, group)
    if scored is not None:
        _check_score_inputs(nodes, *scored)
        _check("e", e_out, torch.int32, (n,), nodes.valid.device)
    if not _on_cuda(nodes.valid):
        mask, cap, fail, *e = _feasibility_plain(nodes, group, scored)
        if mask_out is not None:
            mask_out.copy_(mask)
        cap_out.copy_(cap)
        fail_out.copy_(fail)
        if e:
            e_out.copy_(e[0])
        return
    table = None
    if scored is not None:
        sin, strategy = scored
        table = ctypes.byref(_score_table(
            strategy, nodes.failures, e_out,
            (sin.weights, sin.w1, sin.b1, sin.w2, sin.b2)
            if _scored(strategy) else None,
            (sin.hr_cpu, sin.hr_mem, sin.hr_gen)
            if _scored(strategy) else None))
    FEASIBILITY(
        n, cc, npl, *map(_cuda.ptr, (
            nodes.valid, nodes.ready, nodes.res_ok, nodes.res_cap,
            nodes.svc_tasks, nodes.extra_mask, group.con_hash, group.con_op,
            group.con_exp, group.plat, nodes.os_hash, nodes.arch_hash,
            nodes.port_conflict, nodes.quota_ok, group.k, group.maxrep,
            group.port_limited, mask_out, cap_out, fail_out,
            nodes.total_tasks)), table)


def _feas_layout(n: int) -> Tuple[int, int]:
    """(bytes of the int32 part, total bytes) of a feasibility buffer."""
    head = 4 * (n + N_FILTERS)
    return head, head + n


def unpack_feasibility(buf, n: int):
    """Split a feasibility buffer (torch uint8 tensor or numpy array) into
    (mask bool[N], cap i32[N], fail_counts i32[8]) views."""
    head, _ = _feas_layout(n)
    if isinstance(buf, np.ndarray):
        ints = buf[:head].view(np.int32)
        mask = buf[head:].view(np.bool_)
    else:
        ints = buf[:head].view(torch.int32)
        mask = buf[head:].view(torch.bool)
    return mask, ints[:n], ints[n:n + N_FILTERS]


def feasibility_packed(nodes: NodeInputs,
                       group: GroupInputs) -> torch.Tensor:
    """K1 into one byte buffer ``[cap | fail_counts | mask]`` on the
    inputs' device (see :func:`unpack_feasibility`)."""
    n = nodes.valid.shape[0]
    _, total = _feas_layout(n)
    buf = torch.zeros(total, dtype=torch.uint8, device=nodes.valid.device)
    mask, cap, fail = unpack_feasibility(buf, n)
    _feasibility_into(nodes, group, mask, cap, fail)
    return buf


def feasibility_and_capacity(nodes: NodeInputs, group: GroupInputs):
    """Fused filter pipeline: (mask bool[N], cap i32[N], fail_counts
    i32[8] per filter in pipeline order -- ready, resources, plugins,
    constraints, platforms, host ports, max replicas, tenant quota).
    Counterpart of the reference's ``feasibility_and_capacity``."""
    return unpack_feasibility(feasibility_packed(nodes, group),
                              nodes.valid.shape[0])


# the entry preassigned-task validation uses (the reference's
# ``feasibility_jit``): the same function
feasibility = feasibility_and_capacity


# ---------------------------------------------------------- K2: branch sums

def _seg_sum_plain(svc_tasks, valid, cap, seg, L: int, k):
    """Plain version of K2: (load, bcap, raw_cap, kk)."""
    load_raw, raw_cap = _seg_partial_plain(svc_tasks, valid, cap, seg, L)
    return _seg_clamp(load_raw, raw_cap, k)


# K2's scratch per (device index, stream): the accumulator (int64 [2, >= L]
# sums and a uint32 ticket in its last slot), which every launch leaves
# zero, so the wrapper allocates (zeroed) only to grow it; and per L the
# outputs of the composition's calls, which each launch overwrites, with
# the launch's table of scratch and output addresses (dropped when the
# accumulator grows: they name the old one).  Calls that follow
# each other on a stream find both ready without a sync; a composition
# reads one call's outputs (stage A's water-fill) before it makes the next
# call.  The allocator hands a dropped buffer to no other stream before the
# launches queued on it ran.
_SEG_SUM_ACC: Dict[Tuple[int, int], Tuple[torch.Tensor, int, int]] = {}
_SEG_SUM_OUT: Dict[Tuple[int, int, int], tuple] = {}


def _seg_sum_acc(t: torch.Tensor, L: int, stream: int) -> Tuple[int, int]:
    """(accumulator, ticket) addresses of K2's scratch for ``stream`` on
    ``t``'s card."""
    key = (t.get_device(), stream)
    entry = _SEG_SUM_ACC.get(key)
    if entry is None or entry[0].shape[0] < 2 * L + 1:
        buf = torch.zeros(2 * max(L, 256) + 1, dtype=torch.int64,
                          device=t.device)
        base = buf.data_ptr()
        entry = (buf, base, base + 8 * (buf.shape[0] - 1))
        _SEG_SUM_ACC[key] = entry
        for out_key in [o for o in _SEG_SUM_OUT if o[:2] == key]:
            del _SEG_SUM_OUT[out_key]
    return entry[1], entry[2]


def _seg_sum_outputs(dev: torch.device, L: int):
    """Fresh (load i32[L], bcap i32[L], raw_cap i64[L], kk i32[1])."""
    i32 = torch.int32
    return (torch.empty(L, dtype=i32, device=dev),
            torch.empty(L, dtype=i32, device=dev),
            torch.empty(L, dtype=torch.int64, device=dev),
            torch.empty(1, dtype=i32, device=dev))


def _seg_sum_table(acc: int, ticket: int, outs):
    """K2's launch table (``csrc/segsum.cu`` SegSumTable): accumulator,
    ticket, load, bcap, raw_cap, kk."""
    return (ctypes.c_void_p * 6)(acc, ticket,
                                 *(t.data_ptr() for t in outs))


def _launch_seg_sum(svc_tasks, valid, cap, seg, k, L: int, table,
                    stream: int) -> None:
    SEG_SUM.launch(svc_tasks.shape[0], L, svc_tasks.data_ptr(),
                   valid.data_ptr(), cap.data_ptr(), seg.data_ptr(),
                   _cuda.ptr(k), ctypes.addressof(table), stream=stream)


def branch_sums(svc_tasks: torch.Tensor, valid: torch.Tensor,
                cap: torch.Tensor, seg: torch.Tensor, L: int,
                k: torch.Tensor):
    """Stage-A branch arrays over ``L`` segments (reference
    ``plan_group.branch_arrays``, ``kernel.py:305-312``): returns
    (load i32[L] -- valid nodes' clipped service counts, clamped to
    LOAD_CLAMP; bcap i32[L] -- capacity clamped to min(k, K_CLAMP);
    raw_cap i64[L] -- the unclamped capacity; kk i32[1] = min(k,
    K_CLAMP)).  ``kk`` stays on the device: it is the root allocation of
    the stage-A walk."""
    n = svc_tasks.shape[0]
    dev = svc_tasks.device
    i32 = torch.int32
    _check("svc_tasks", svc_tasks, i32, (n,), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    _check("cap", cap, i32, (n,), dev)
    _check("seg", seg, i32, (n,), dev)
    _check("k", k, i32, (), dev)
    if not _on_cuda(svc_tasks):
        return _seg_sum_plain(svc_tasks, valid, cap, seg, L, k)
    outs = _seg_sum_outputs(dev, L)
    stream = _cuda.stream_handle()
    _launch_seg_sum(svc_tasks, valid, cap, seg, k, L,
                    _seg_sum_table(*_seg_sum_acc(svc_tasks, L, stream),
                                   outs), stream)
    return outs


def _branch_sums(svc_tasks, valid, cap, seg, L: int, k):
    """K2 as a composition calls it, without input checks (it checked
    them): the branch arrays of :func:`branch_sums` in this stream's
    output buffers for ``L`` (valid until the next call on the stream)."""
    if not svc_tasks.is_cuda:
        return _seg_sum_plain(svc_tasks, valid, cap, seg, L, k)
    stream = _cuda.stream_handle()
    key = (svc_tasks.get_device(), stream, L)
    entry = _SEG_SUM_OUT.get(key)
    if entry is None:
        acc = _seg_sum_acc(svc_tasks, L, stream)
        outs = _seg_sum_outputs(svc_tasks.device, L)
        entry = _SEG_SUM_OUT[key] = (outs, _seg_sum_table(*acc, outs))
    _launch_seg_sum(svc_tasks, valid, cap, seg, k, L, entry[1], stream)
    return entry[0]


# -------------------------------------------------------- K3: water-filling

def _downweight(failures: torch.Tensor) -> torch.Tensor:
    return torch.where(failures >= MAX_FAILURES,
                       torch.clamp(failures, 0, FAILURE_CLAMP),
                       torch.zeros_like(failures))


def spread_score(nodes: NodeInputs) -> torch.Tensor:
    """The spread strategy's effective level: per-service count,
    failure-down-weighted (scheduler.go:708 nodeLess)."""
    return _spread_score(nodes.svc_tasks, nodes.failures)


def _spread_score(svc_tasks, failures) -> torch.Tensor:
    svc = torch.clamp(svc_tasks, 0, SVC_CLAMP)
    return (svc + _downweight(failures) * F_BIG).to(torch.int32)


def _tie_keys(total: Optional[torch.Tensor], n: int,
              device: torch.device) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if total is None:
        return idx
    return (torch.clamp(total, 0, TOTAL_CLAMP) << IDX_BITS) | idx


def _level_spill(alloc: torch.Tensor, raw_cap: torch.Tensor) -> torch.Tensor:
    """A level diverges from the host oracle only when some usable branch
    saturates (allocation == its unclamped capacity) while another usable
    branch does not (reference ``level_spill``, ``kernel.py:332``)."""
    usable = raw_cap > 0
    sat = usable & (alloc.to(torch.int64) >= raw_cap)
    return sat.any() & (usable & ~sat).any()


def _waterfill_plain(e, cap, tie, k_seg, seg, L: int) -> torch.Tensor:
    dev = e.device
    i32, i64 = torch.int32, torch.int64
    seg_l = seg.to(i64)
    k64 = k_seg.to(i64)

    def seg_sum(v):
        return torch.zeros(L, dtype=i64, device=dev).index_add_(
            0, seg_l, v.to(i64))

    def fill_at(lam_seg):
        return torch.minimum(torch.clamp(lam_seg[seg_l] - e, min=0), cap)

    lo = torch.zeros(L, dtype=i32, device=dev)
    hi = torch.full((L,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(LEVEL_ITERS):
        mid = lo + ((hi - lo) >> 1)     # floor midpoint, as the reference
        ge = seg_sum(fill_at(mid)) >= k64
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    lam = hi            # minimal level with fill >= k (2^30 if infeasible)

    x_base = fill_at(lam - 1)
    r = torch.clamp(k64 - seg_sum(x_base), min=0)
    marginal = (e <= (lam - 1)[seg_l]) & (x_base < cap)

    tlo = torch.full((L,), -1, dtype=i32, device=dev)
    thi = torch.full((L,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(TIE_ITERS):
        mid = tlo + ((thi - tlo) >> 1)
        ge = seg_sum(marginal & (tie <= mid[seg_l])) >= r
        tlo, thi = torch.where(ge, tlo, mid + 1), torch.where(ge, mid, thi)
    grant = marginal & (tie <= thi[seg_l]) & (r[seg_l] > 0)
    return (x_base + grant.to(i32)).to(i32)


def _waterfill(*, cap: torch.Tensor, k_seg: torch.Tensor, seg: torch.Tensor,
               L: int, out: torch.Tensor, e: Optional[torch.Tensor] = None,
               svc_tasks: Optional[torch.Tensor] = None,
               failures: Optional[torch.Tensor] = None,
               tie: Optional[torch.Tensor] = None,
               total: Optional[torch.Tensor] = None,
               raw_cap: Optional[torch.Tensor] = None,
               spill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 with its options: the level is ``e``, or the spread score of
    (``svc_tasks``, ``failures``); the tie key is ``tie``, or
    (clip(total) << 20) | index, or the index.  With ``raw_cap`` the
    level_spill verdict of the result is ORed into ``spill`` (int32[1]).
    Writes the placement into ``out`` (int32[n]) and returns it.  Any
    number of segments."""
    n = cap.shape[0]
    dev = cap.device
    i32 = torch.int32
    _check("cap", cap, i32, (n,), dev)
    _check("seg", seg, i32, (n,), dev)
    _check("k_seg", k_seg, i32, (L,), dev)
    _check("out", out, i32, (n,), dev)
    if e is not None:
        _check("e", e, i32, (n,), dev)
    else:
        _check("svc_tasks", svc_tasks, i32, (n,), dev)
        _check("failures", failures, i32, (n,), dev)
    if tie is not None:
        _check("tie", tie, i32, (n,), dev)
    if total is not None:
        _check("total", total, i32, (n,), dev)
    if raw_cap is not None:
        _check("raw_cap", raw_cap, torch.int64, (n,), dev)
        _check("spill", spill, i32, (1,), dev)
    return _waterfill_into(cap=cap, k_seg=k_seg, seg=seg, L=L, out=out, e=e,
                           svc_tasks=svc_tasks, failures=failures, tie=tie,
                           total=total, raw_cap=raw_cap, spill=spill)


@lru_cache(maxsize=None)
def _waterfill_scratch_bytes(L: int) -> int:
    """Global scratch K3 needs for ``L`` segments: 0 while its
    per-segment state fits the cluster's shared memory."""
    return _cuda.library().sk_waterfill_scratch_bytes(L)


def _waterfill_into(*, cap, k_seg, seg, L: int, out, e=None, svc_tasks=None,
                    failures=None, tie=None, total=None, raw_cap=None,
                    spill=None) -> torch.Tensor:
    """:func:`_waterfill` without input checks (the composition checked
    them)."""
    if not _on_cuda(cap):
        if e is None:
            e = _spread_score(svc_tasks, failures)
        if tie is None:
            tie = _tie_keys(total, cap.shape[0], cap.device)
        out.copy_(_waterfill_plain(e, cap, tie, k_seg, seg, L))
        if raw_cap is not None:
            spill |= _level_spill(out, raw_cap).to(torch.int32)
        return out
    nbytes = _waterfill_scratch_bytes(L)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=cap.device) \
        if nbytes else None
    WATERFILL(cap.shape[0], L, _cuda.ptr(e), _cuda.ptr(svc_tasks),
              _cuda.ptr(failures), MAX_FAILURES,
              *map(_cuda.ptr, (cap, tie, total, k_seg, seg, out, raw_cap,
                               spill, scratch)))
    return out


def seg_waterfill(e: torch.Tensor, cap: torch.Tensor, tie: torch.Tensor,
                  k_seg: torch.Tensor, seg: torch.Tensor,
                  L: int) -> torch.Tensor:
    """Capacity-bounded water-filling within each segment (reference
    ``seg_waterfill``): finds per-segment level lam, assigns
    x_i = clip(lam-1 - e_i, 0, cap_i), then grants the remainder one by
    one to marginal elements in ``tie`` order.

    e: i32[N] level per element (lower = preferred); cap: i32[N]; tie:
    i32[N] unique keys < 2^30; k_seg: i32[L] units per segment (each
    <= K_CLAMP); seg: i32[N] segment ids."""
    out = torch.empty(cap.shape[0], dtype=torch.int32, device=cap.device)
    return _waterfill(e=e, cap=cap, tie=tie, k_seg=k_seg, seg=seg, L=L,
                      out=out)


# ------------------------------------------------------------- plan_group

def _plan_buffer(n: int, device, out: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """A zeroed int32 ``[x (N) | fail_counts (8) | spill (1)]`` plan row:
    ``out`` (checked; the caller zeroed it), or a new one."""
    if out is None:
        return torch.zeros(n + N_FILTERS + 1, dtype=torch.int32,
                           device=device)
    _check("out", out, torch.int32, (n + N_FILTERS + 1,), device)
    return out


def plan_group_packed(nodes: NodeInputs, group: GroupInputs, L: int,
                      hier: Tuple = (),
                      out: Optional[torch.Tensor] = None,
                      cap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place one task group; returns the int32 buffer ``[x (N) |
    fail_counts (8) | spill (1)]`` on the inputs' device (``out``, a
    zeroed row of that layout, when given).

    Stage A walks the spread-preference tree top-down: K2 sums each
    level's branch loads and capacities, K3 water-fills the parent's
    allocation over its child branches and flags a saturated level
    (``spill``).  Stage B water-fills nodes inside each leaf with K3 on the
    spread score, tie-broken by total tasks then node index.  ``hier`` is
    ``((seg_nodes i32[N], parent i32[L_d]), ...)`` for the levels above the
    leaves, top level first, and ``leaf_parent i32[L]``; ``()`` for a flat
    tree.  Every intermediate stays on the device.  The inputs are
    checked once here (K1's checks and the tree's); K2 and K3 run their
    unchecked entries.

    ``cap``, when given, is the group's capacity column from K1F (the
    fused route), whose fail counts already sit in ``out``: K1 and its
    checks are skipped and ``nodes`` needs only the columns the fills read
    (valid, svc_tasks, total_tasks, failures, leaf) and ``group`` only k."""
    n = nodes.valid.shape[0]
    dev = nodes.valid.device
    buf = _plan_buffer(n, dev, out)
    x, fail, spill = buf[:n], buf[n:n + N_FILTERS], buf[n + N_FILTERS:]
    if cap is None:
        cap = torch.empty(n, dtype=torch.int32, device=dev)
        _feasibility_into(nodes, group, None, cap, fail)

    upper_levels, leaf_parent = hier if hier else ((), None)
    i32 = torch.int32
    for seg_nodes, parent in upper_levels:
        _check("seg_nodes", seg_nodes, i32, (n,), dev)
        _check("parent", parent, i32, (parent.shape[0],), dev)
    if leaf_parent is not None:
        _check("leaf_parent", leaf_parent, i32, (L,), dev)
    k_parent = None        # the root's allocation: kk from the first sums
    parent_count = 1
    for seg_nodes, parent in upper_levels:
        L_d = parent.shape[0]
        load, bcap, raw_cap, kk = _branch_sums(
            nodes.svc_tasks, nodes.valid, cap, seg_nodes, L_d, group.k)
        alloc = torch.empty(L_d, dtype=i32, device=dev)
        k_parent = _waterfill_into(
            e=load, cap=bcap, k_seg=kk if k_parent is None else k_parent,
            seg=parent, L=parent_count, out=alloc,
            raw_cap=raw_cap if L_d > 1 else None,
            spill=spill if L_d > 1 else None)
        parent_count = L_d

    load, bcap, raw_cap, kk = _branch_sums(nodes.svc_tasks, nodes.valid, cap,
                                           nodes.leaf, L, group.k)
    if L == 1 and not upper_levels:
        k_branch = bcap          # min(kk, branch capacity)
    else:
        seg = leaf_parent if leaf_parent is not None \
            else torch.zeros(L, dtype=i32, device=dev)
        k_branch = _waterfill_into(
            e=load, cap=bcap, k_seg=kk if k_parent is None else k_parent,
            seg=seg, L=parent_count,
            out=torch.empty(L, dtype=i32, device=dev),
            raw_cap=raw_cap if L > 1 else None,
            spill=spill if L > 1 else None)

    _waterfill_into(svc_tasks=nodes.svc_tasks, failures=nodes.failures,
                    total=nodes.total_tasks, cap=cap, k_seg=k_branch,
                    seg=nodes.leaf, L=L, out=x)
    return buf


def unpack_plan(buf, n: int):
    """Split a plan buffer (torch tensor or numpy array) into (x i32[N],
    fail_counts i32[8], spill bool)."""
    spill = buf[n + N_FILTERS] != 0
    return buf[:n], buf[n:n + N_FILTERS], \
        (bool(spill) if isinstance(buf, np.ndarray) else spill)


def plan_group(nodes: NodeInputs, group: GroupInputs, L: int,
               hier: Tuple = ()):
    """(x i32[N] tasks per node, fail_counts i32[8], spill bool scalar):
    the reference ``plan_group``'s triple, as tensors on the inputs'
    device."""
    return unpack_plan(plan_group_packed(nodes, group, L, hier),
                       nodes.valid.shape[0])


# ------------------------------------------------------------- strategies

class StrategyInputs(NamedTuple):
    """Per-group strategy columns and parameters (the reference's
    ``StrategyInputs``); members a strategy does not read ship as zeros."""

    hr_cpu: torch.Tensor   # i32[N] cpu headroom in demand units
    hr_mem: torch.Tensor   # i32[N] memory headroom in demand units
    hr_gen: torch.Tensor   # i32[N] generic-resource headroom (min kind)
    weights: torch.Tensor  # i32[4] weighted terms [spread, cpu, mem, gen]
    w1: torch.Tensor       # i32[F, H] learned-scorer layer 1
    b1: torch.Tensor       # i32[H]
    w2: torch.Tensor       # i32[H]
    b2: torch.Tensor       # i32[] scalar


# ------------------------------------------------------ K5: pack filling

def _binpack_key(res_cap: torch.Tensor,
                 failures: torch.Tensor) -> torch.Tensor:
    """The binpack fill order (reference ``plan_strategy``,
    ``kernel.py:521-526``): clip(res_cap, 0, BP_CLAMP), or the failure band
    above it, in the top bits; the node index below."""
    idx = torch.arange(res_cap.shape[0], dtype=torch.int32,
                       device=res_cap.device)
    score = torch.where(failures >= MAX_FAILURES,
                        BP_CLAMP + 1 + torch.clamp(failures, 0,
                                                   FAILURE_CLAMP),
                        torch.clamp(res_cap, 0, BP_CLAMP))
    return ((score << IDX_BITS) | idx).to(torch.int32)


def _packfill_plain(key, cap, k_seg, seg, L: int) -> torch.Tensor:
    dev = key.device
    i32, i64 = torch.int32, torch.int64
    seg_l = seg.to(i64)
    k64 = k_seg.to(i64)
    zero = torch.zeros_like(cap)

    def seg_sum(v):
        return torch.zeros(L, dtype=i64, device=dev).index_add_(
            0, seg_l, v.to(i64))

    lo = torch.full((L,), -1, dtype=i32, device=dev)
    hi = torch.full((L,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(TIE_ITERS):
        mid = lo + ((hi - lo) >> 1)
        ge = seg_sum(torch.where(key <= mid[seg_l], cap, zero)) >= k64
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    thr = hi[seg_l]     # least threshold with fill >= k (2^30 if short)
    x = torch.where(key < thr, cap, zero)
    r = torch.clamp(k64 - seg_sum(x), min=0)[seg_l]
    grant = (key == thr) & (r > 0)
    return (x + torch.where(grant, torch.minimum(cap.to(i64), r),
                            0).to(i32)).to(i32)


def _packfill(*, res_cap: torch.Tensor, failures: torch.Tensor,
              cap: torch.Tensor, k: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """K5: the binpack fill of one group over all nodes (one segment), in
    the order of the binpack key of (``res_cap``, ``failures``), placing
    ``k`` (int32[1]) tasks.  Writes the placement into ``out`` (int32[n])."""
    n = cap.shape[0]
    dev = cap.device
    i32 = torch.int32
    for name, t in (("res_cap", res_cap), ("failures", failures),
                    ("cap", cap), ("out", out)):
        _check(name, t, i32, (n,), dev)
    _check("k", k, i32, (1,), dev)
    if not _on_cuda(cap):
        seg = torch.zeros(n, dtype=i32, device=dev)
        out.copy_(_packfill_plain(_binpack_key(res_cap, failures), cap, k,
                                  seg, 1))
        return out
    PACKFILL(n, _cuda.ptr(res_cap), _cuda.ptr(failures), MAX_FAILURES,
             *map(_cuda.ptr, (cap, k, out)))
    return out


def seg_packfill(key: torch.Tensor, cap: torch.Tensor, k_seg: torch.Tensor,
                 seg: torch.Tensor, L: int) -> torch.Tensor:
    """Sequential (pack) fill within each segment (reference
    ``seg_packfill``): nodes take their full capacity in ascending ``key``
    order until k is placed; the node at the threshold takes the
    remainder.  Keys must be unique per segment and below 2^30, and
    ``seg`` must lie in [0, L).

    This general form (any key, any number of segments) is K5's plain
    version and takes CPU tensors only.  On the card the one form the
    planner runs -- the binpack key over one segment -- is K5 itself, through
    :func:`plan_strategy`."""
    if _on_cuda(cap):
        raise ValueError("seg_packfill: on the card K5 runs the binpack "
                         "fill of plan_strategy; this general form is "
                         "for CPU tensors")
    return _packfill_plain(key, cap, k_seg, seg, L)


# ------------------------------------------------------ K6: scoring stage

def _learned_score(nodes: NodeInputs, sin: StrategyInputs) -> torch.Tensor:
    """Plain version of K6's learned mode: the fixed-point MLP of
    ``scheduler/strategy.learned_score_host`` (int32 throughout)."""
    i32 = torch.int32
    f = torch.stack([
        torch.clamp(nodes.svc_tasks, 0, FEAT_CLAMP),
        torch.clamp(nodes.total_tasks, 0, FEAT_CLAMP),
        torch.clamp(nodes.failures, 0, FEAT_CLAMP),
        torch.clamp(sin.hr_cpu, 0, FEAT_CLAMP),
        torch.clamp(sin.hr_mem, 0, FEAT_CLAMP),
        nodes.ready.to(i32) * FEAT_CLAMP,
    ], dim=-1).to(i32)                                     # [N, F]
    h = (f[:, :, None] * sin.w1[None, :, :]).sum(dim=1, dtype=i32) + sin.b1
    h = torch.clamp(h >> MLP_SHIFT, 0, FEAT_CLAMP)
    out = (h * sin.w2[None, :]).sum(dim=1, dtype=i32) + sin.b2
    return torch.clamp(out >> MLP_SHIFT, 0, SCORE_CLAMP).to(i32)


def _strategy_score_plain(nodes: NodeInputs, sin: StrategyInputs,
                          strategy: int) -> torch.Tensor:
    down = _downweight(nodes.failures) * F_BIG
    if strategy == STRAT_WEIGHTED:
        w = sin.weights
        return (w[0] * torch.clamp(nodes.svc_tasks, 0, SVC_CLAMP)
                + w[1] * (HR_CLAMP - sin.hr_cpu)
                + w[2] * (HR_CLAMP - sin.hr_mem)
                + w[3] * (HR_CLAMP - sin.hr_gen)
                + down).to(torch.int32)
    if strategy == STRAT_LEARNED:
        return (_learned_score(nodes, sin) + down).to(torch.int32)
    return spread_score(nodes)


def _check_mlp(sin, dev) -> int:
    """Check a learned scorer's parameters; returns its hidden units."""
    i32 = torch.int32
    hidden = sin.w1.shape[-1]
    if not 0 < hidden <= SCORE_MAX_HIDDEN:
        raise ValueError(f"learned scorer: {hidden} hidden units "
                         f"(1..{SCORE_MAX_HIDDEN})")
    _check("w1", sin.w1, i32, (len(MLP_FEATURES), hidden), dev)
    _check("b1", sin.b1, i32, (hidden,), dev)
    _check("w2", sin.w2, i32, (hidden,), dev)
    _check("b2", sin.b2, i32, (), dev)
    return hidden


def _check_score_inputs(nodes: NodeInputs, sin: Optional[StrategyInputs],
                        strategy: int) -> int:
    """Check what K6 (or a scored K1) reads for ``strategy``; returns the
    learned scorer's hidden units (0 for another strategy)."""
    n = nodes.valid.shape[0]
    dev = nodes.valid.device
    i32 = torch.int32
    for name in ("svc_tasks", "total_tasks", "failures"):
        _check(name, getattr(nodes, name), i32, (n,), dev)
    _check("ready", nodes.ready, torch.bool, (n,), dev)
    if strategy in (STRAT_WEIGHTED, STRAT_LEARNED):
        for name in ("hr_cpu", "hr_mem", "hr_gen"):
            _check(name, getattr(sin, name), i32, (n,), dev)
        _check("weights", sin.weights, i32, (4,), dev)
    return _check_mlp(sin, dev) if strategy == STRAT_LEARNED else 0


def strategy_score(nodes: NodeInputs, sin: StrategyInputs,
                   strategy: int) -> torch.Tensor:
    """The pluggable scoring stage (reference ``strategy_score``): each
    node's effective level i32[N], lower preferred -- the weighted linear
    score, the learned MLP score, or (any other strategy) the spread
    score; every one failure-down-weighted.  The plans do not call it:
    K1 and K1F compute the same level as their epilogue."""
    n = nodes.valid.shape[0]
    dev = nodes.valid.device
    i32 = torch.int32
    hidden = _check_score_inputs(nodes, sin, strategy)
    if not _on_cuda(nodes.valid):
        return _strategy_score_plain(nodes, sin, strategy)
    e = torch.empty(n, dtype=i32, device=dev)
    strat_args = (sin.hr_cpu, sin.hr_mem, sin.hr_gen, sin.weights) \
        if strategy in (STRAT_WEIGHTED, STRAT_LEARNED) else (None,) * 4
    mlp_args = (sin.w1, sin.b1, sin.w2, sin.b2) \
        if strategy == STRAT_LEARNED else (None,) * 4
    SCORE(n, int(strategy), hidden, MAX_FAILURES, *map(_cuda.ptr, (
        nodes.svc_tasks, nodes.total_tasks, nodes.failures, nodes.ready,
        *strat_args, *mlp_args, e)))
    return e


# --------------------------------------------------------- plan_strategy

def _scored_entry(n: int, dev, nodes: NodeInputs, group: GroupInputs,
                  sin: Optional[StrategyInputs], strategy: int,
                  fail: torch.Tensor) -> Tuple[torch.Tensor, Optional[
                      torch.Tensor]]:
    """K1 for a strategy plan: (cap, e), the capacity into a new column
    and the fail counts into ``fail``; a non-binpack strategy's level e
    from the same launch (the score epilogue), else None."""
    cap = torch.empty(n, dtype=torch.int32, device=dev)
    if strategy == STRAT_BINPACK:
        _feasibility_into(nodes, group, None, cap, fail)
        return cap, None
    e = torch.empty(n, dtype=torch.int32, device=dev)
    _feasibility_into(nodes, group, None, cap, fail, (sin, strategy), e)
    return cap, e


def plan_strategy_packed(nodes: NodeInputs, group: GroupInputs,
                         sin: Optional[StrategyInputs], strategy: int,
                         out: Optional[torch.Tensor] = None,
                         cap: Optional[torch.Tensor] = None,
                         seg: Optional[torch.Tensor] = None,
                         e: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Place one task group under a non-spread strategy; the int32 buffer
    ``[x (N) | fail_counts (8) | spill (1)]`` of :func:`plan_group_packed`
    (spill stays 0: a strategy plans one flat segment).  K1 gives mask,
    capacity and fail counts, and for weighted and learned the nodes'
    level (K6's score, the epilogue of the same launch); binpack then
    pack-fills on its key (K5), weighted and learned water-fill the level
    (K3) with the tie key (clip(total) << 20) | index.  ``sin`` may be
    None for binpack, which reads no strategy column.  ``cap`` and ``e``:
    the capacity and level from K1F (the fused route), as ``cap`` in
    :func:`plan_group_packed` (K1 skipped; binpack also reads
    ``nodes.res_cap``; weighted and learned need ``e``).  ``seg``: the
    all-zero segment column of the one-segment water-fill, when the caller
    holds one (the fused route makes one a chunk)."""
    n = nodes.valid.shape[0]
    dev = nodes.valid.device
    buf = _plan_buffer(n, dev, out)
    x, fail = buf[:n], buf[n:n + N_FILTERS]
    if cap is None:
        cap, e = _scored_entry(n, dev, nodes, group, sin, strategy, fail)
    kk = torch.clamp(group.k, max=K_CLAMP).reshape(1)
    if strategy == STRAT_BINPACK:
        _packfill(res_cap=nodes.res_cap, failures=nodes.failures, cap=cap,
                  k=kk, out=x)
    else:
        if e is None:
            raise ValueError("a weighted or learned plan given its "
                             "capacity needs its level e too")
        if seg is None:
            seg = torch.zeros(n, dtype=torch.int32, device=dev)
        _waterfill_into(e=e, total=nodes.total_tasks, cap=cap, k_seg=kk,
                        seg=seg, L=1, out=x)
    return buf


def plan_strategy(nodes: NodeInputs, group: GroupInputs,
                  sin: Optional[StrategyInputs], strategy: int):
    """(x i32[N], fail_counts i32[8], spill bool scalar) of
    :func:`plan_strategy_packed`: the reference ``plan_strategy``'s
    triple."""
    return unpack_plan(plan_strategy_packed(nodes, group, sin, strategy),
                       nodes.valid.shape[0])


# ------------------------------------------------------- fused many-service
#
# One chunk of a fused run plans its group slots in order, each step seeing
# the cluster state the earlier steps left (reference ``plan_fused``, a
# lax.scan).  Here the scan is a host loop that only ENQUEUES work: per
# slot, K1F adds the previous slot's placements into the device carry,
# derives the group's resource columns from it and runs K1's filters on
# them, in one launch; the host picks the fill's launch sequence from the
# slot's strategy id (known on the host from the run's builder).  After the
# last slot, K4's carry update adds its placements.  Nothing in the loop
# reads the device, so a chunk is one stream of launches and one D2H of
# its result rows.

class FusedShared(NamedTuple):
    """Run-wide node state, densified once per fused run."""

    valid: torch.Tensor       # bool[N] padding mask
    ready: torch.Tensor       # bool[N] READY && ACTIVE
    os_hash: torch.Tensor     # i32[2, N] platform.os hash (hi, lo)
    arch_hash: torch.Tensor   # i32[2, N] normalized arch hash (hi, lo)
    svc0: torch.Tensor        # i32[S, N] base active tasks per service slot


class FusedGroups(NamedTuple):
    """Per-group inputs stacked over the group axis G.  Padding slots
    carry k = 0: they place nothing and leave the carry as it is."""

    k: torch.Tensor           # i32[G] tasks to place (0 = padding slot)
    slot: torch.Tensor        # i32[G] service slot into svc0/svc_acc
    maxrep: torch.Tensor      # i32[G] max replicas per node (0 = off)
    cpu_d: torch.Tensor       # i64[G] per-task nano-cpu reservation
    mem_d: torch.Tensor       # i64[G] per-task memory reservation
    con_hash: torch.Tensor    # i32[G, Cc, 2, N]
    con_op: torch.Tensor      # i32[G, Cc] 0 ==, 1 !=, 2 disabled
    con_exp: torch.Tensor     # i32[G, Cc, 2]
    plat: torch.Tensor        # i32[G, P, 4] (-1 row sentinel = unused)
    failures: torch.Tensor    # i32[G, N] recent failures for the group
    leaf: torch.Tensor        # i32[G, N] spread leaf id (0 when no prefs)
    extra_mask: torch.Tensor  # bool[G, N] plugin/volume masks
    # tenant-quota rows (all-False for a blocked group); None when no
    # group of the run is quota-blocked
    quota_ok: Optional[torch.Tensor] = None   # bool[G, N] or None


class FusedCarry(NamedTuple):
    """Cluster state carried from group slot to group slot, and from chunk
    to chunk of a run, on the device (never fetched).  :func:`plan_fused`
    updates it in place, where the reference returns a new carry."""

    total: torch.Tensor       # i32[N] active tasks total
    cpu: torch.Tensor         # i64[N] available nano-cpus
    mem: torch.Tensor         # i64[N] available memory bytes
    svc_acc: torch.Tensor     # i32[S, N] tasks placed per service slot


class FusedStrategy(NamedTuple):
    """Per-group strategy ids and weights of a mixed-strategy run, and the
    run-wide learned-scorer parameters.  Spread-only runs pass None."""

    sid: torch.Tensor         # i32[G] strategy id (0 = spread)
    weights: torch.Tensor     # i32[G, 4] weighted terms per group
    w1: torch.Tensor          # i32[F, H] learned-scorer layer 1
    b1: torch.Tensor          # i32[H]
    w2: torch.Tensor          # i32[H]
    b2: torch.Tensor          # i32[] scalar


def _check_fused_inputs(shared: FusedShared, groups: FusedGroups,
                        carry: FusedCarry,
                        strat: Optional[FusedStrategy]) -> Tuple[int, int]:
    dev = shared.valid.device
    n = shared.valid.shape[0]
    g = groups.k.shape[0]
    s = shared.svc0.shape[0]
    cc = groups.con_op.shape[-1]
    npl = groups.plat.shape[1]
    b, i32, i64 = torch.bool, torch.int32, torch.int64
    _check("valid", shared.valid, b, (n,), dev)
    _check("ready", shared.ready, b, (n,), dev)
    _check("os_hash", shared.os_hash, i32, (2, n), dev)
    _check("arch_hash", shared.arch_hash, i32, (2, n), dev)
    _check("svc0", shared.svc0, i32, (s, n), dev)
    for name in ("k", "slot", "maxrep"):
        _check(name, getattr(groups, name), i32, (g,), dev)
    _check("cpu_d", groups.cpu_d, i64, (g,), dev)
    _check("mem_d", groups.mem_d, i64, (g,), dev)
    _check("con_hash", groups.con_hash, i32, (g, cc, 2, n), dev)
    _check("con_op", groups.con_op, i32, (g, cc), dev)
    _check("con_exp", groups.con_exp, i32, (g, cc, 2), dev)
    _check("plat", groups.plat, i32, (g, npl, 4), dev)
    _check("failures", groups.failures, i32, (g, n), dev)
    _check("leaf", groups.leaf, i32, (g, n), dev)
    _check("extra_mask", groups.extra_mask, b, (g, n), dev)
    if groups.quota_ok is not None:
        _check("quota_ok", groups.quota_ok, b, (g, n), dev)
    _check("total", carry.total, i32, (n,), dev)
    _check("cpu", carry.cpu, i64, (n,), dev)
    _check("mem", carry.mem, i64, (n,), dev)
    _check("svc_acc", carry.svc_acc, i32, (s, n), dev)
    if strat is not None:
        _check("sid", strat.sid, i32, (g,), dev)
        _check("weights", strat.weights, i32, (g, 4), dev)
    return n, s


# ------------------------------------------- K1F and K4: the scan step

def _fused_prologue_plain(shared: FusedShared, carry: FusedCarry, cpu_d,
                          mem_d, slot: int):
    """The reference's in-scan resource columns (``kernel.py:669-678``):
    (res_ok, res_cap, svc) of one slot from the carry."""
    res_ok = shared.valid
    cap = torch.full_like(carry.cpu, K_CLAMP)
    for avail, d in ((carry.cpu, cpu_d), (carry.mem, mem_d)):
        have = d > 0
        res_ok = res_ok & (~have | (avail >= d))
        cap = torch.where(have, torch.minimum(cap, torch.div(
            avail, torch.clamp(d, min=1), rounding_mode="floor")), cap)
    res_cap = torch.clamp(cap, 0, K_CLAMP).to(torch.int32)
    return res_ok, res_cap, shared.svc0[slot] + carry.svc_acc[slot]


def _fused_headroom(avail: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Headroom in demand units from the carry (reference
    ``_fused_headroom``): the int64 floor division the per-group route
    densifies on the host."""
    hr = torch.clamp(torch.div(avail, torch.clamp(d, min=1),
                               rounding_mode="floor"), 0, HR_CLAMP)
    return torch.where(d > 0, hr, torch.full_like(hr, HR_CLAMP)).to(
        torch.int32)


def _slot_of(groups: FusedGroups, g: int, s: int) -> int:
    """Plain versions only (a read of the device on the card): the service
    slot group g reads, as the reference's jnp indexing reads it -- a
    negative slot counts from the end, then the slot is clamped into
    [0, S) (K1F's ``gather_slot``)."""
    v = int(groups.slot[g])
    v = v + s if v < 0 else v
    return min(max(v, 0), s - 1)


def _scatter_slot(groups: FusedGroups, g: int, s: int) -> Optional[int]:
    """Plain versions only: the service slot group g's placements are
    added into, as the reference's ``.at[slot].add`` scatters them -- a
    negative slot counts from the end, and a slot outside [0, S) is
    dropped (None; K1F's and K4's ``scatter_slot``)."""
    v = int(groups.slot[g])
    v = v + s if v < 0 else v
    return v if 0 <= v < s else None


def _fused_carry_plain(groups: FusedGroups, carry: FusedCarry, g: int,
                       s: int, x: torch.Tensor) -> None:
    x64 = x.to(torch.int64)
    carry.total.add_(x)
    carry.cpu.sub_(x64 * groups.cpu_d[g])
    carry.mem.sub_(x64 * groups.mem_d[g])
    slot = _scatter_slot(groups, g, s)
    if slot is not None:
        carry.svc_acc[slot].add_(x)


def _fused_carry(groups: FusedGroups, carry: FusedCarry, g: int, s: int,
                 x: torch.Tensor) -> None:
    """K4's carry update after group slot ``g`` placed ``x``."""
    n = x.shape[0]
    if not _on_cuda(x):
        _fused_carry_plain(groups, carry, g, s, x)
        return
    FUSED_CARRY(n, s, *map(_cuda.ptr, (
        x, groups.cpu_d[g], groups.mem_d[g], groups.slot[g], carry.total,
        carry.cpu, carry.mem, carry.svc_acc)))


def _fused_slot_inputs(shared: FusedShared, groups: FusedGroups,
                       carry: FusedCarry, g: int, res_ok, res_cap, svc
                       ) -> Tuple[NodeInputs, GroupInputs]:
    """The (NodeInputs, GroupInputs) that group slot ``g``'s filters read,
    from its derived resource columns (the reference's ``step``,
    ``kernel.py:679-690``): no host ports, never port-limited."""
    dev = shared.valid.device
    nodes = NodeInputs(
        valid=shared.valid, ready=shared.ready, res_ok=res_ok,
        res_cap=res_cap, svc_tasks=svc, total_tasks=carry.total,
        failures=groups.failures[g], leaf=groups.leaf[g],
        os_hash=shared.os_hash, arch_hash=shared.arch_hash,
        port_conflict=torch.zeros_like(shared.valid),
        extra_mask=groups.extra_mask[g],
        quota_ok=(groups.quota_ok[g] if groups.quota_ok is not None
                  else None))
    grp = GroupInputs(
        k=groups.k[g], con_hash=groups.con_hash[g], con_op=groups.con_op[g],
        con_exp=groups.con_exp[g], plat=groups.plat[g],
        maxrep=groups.maxrep[g],
        port_limited=torch.zeros((), dtype=torch.bool, device=dev))
    return nodes, grp


def _slot_score_inputs(groups: FusedGroups, carry: FusedCarry, g: int,
                       svc: torch.Tensor, ready: torch.Tensor,
                       strat: FusedStrategy) -> Tuple[NodeInputs,
                                                      StrategyInputs]:
    """What slot ``g``'s score reads (the reference's ``sin``,
    ``kernel.py:702-708``): its svc, the carry's total, the group's
    failures and the nodes' ready flags; the headroom from the carry and
    hr_gen = HR_CLAMP (a group with a generic demand never fuses)."""
    hr_gen = torch.full_like(svc, HR_CLAMP)
    nodes = NodeInputs(
        valid=None, ready=ready, res_ok=None, res_cap=None, svc_tasks=svc,
        total_tasks=carry.total, failures=groups.failures[g], leaf=None,
        os_hash=None, arch_hash=None, port_conflict=None, extra_mask=None)
    sin = StrategyInputs(
        hr_cpu=_fused_headroom(carry.cpu, groups.cpu_d[g]),
        hr_mem=_fused_headroom(carry.mem, groups.mem_d[g]), hr_gen=hr_gen,
        weights=strat.weights[g], w1=strat.w1, b1=strat.b1, w2=strat.w2,
        b2=strat.b2)
    return nodes, sin


def _fused_feasibility_plain(shared: FusedShared, groups: FusedGroups,
                             carry: FusedCarry, g: int, s: int,
                             x_prev: Optional[torch.Tensor] = None,
                             strat: Optional[FusedStrategy] = None,
                             sid: int = STRAT_SPREAD):
    """Plain version of K1F, the slot entry of group slot ``g``: slot
    ``g - 1``'s placements ``x_prev`` (None for the first slot of a chunk)
    added into ``carry`` in place (K4's carry update), then that slot's
    resource columns from the carry (the reference's ``kernel.py:669-678``)
    and K1 on them, and with ``strat`` the slot's level under strategy
    ``sid`` (:func:`_strategy_score_plain`, the scored launch's epilogue).
    Returns (mask, cap, fail_counts, res_ok, res_cap, svc, hr_cpu, hr_mem,
    e), e None without ``strat``."""
    if x_prev is not None:
        _fused_carry_plain(groups, carry, g - 1, s, x_prev)
    res_ok, res_cap, svc = _fused_prologue_plain(
        shared, carry, groups.cpu_d[g], groups.mem_d[g],
        _slot_of(groups, g, s))
    hr_cpu = _fused_headroom(carry.cpu, groups.cpu_d[g])
    hr_mem = _fused_headroom(carry.mem, groups.mem_d[g])
    mask, cap, fail = _feasibility_plain(*_fused_slot_inputs(
        shared, groups, carry, g, res_ok, res_cap, svc))
    e = None if strat is None else _strategy_score_plain(
        *_slot_score_inputs(groups, carry, g, svc, shared.ready, strat), sid)
    return mask, cap, fail, res_ok, res_cap, svc, hr_cpu, hr_mem, e


def _fused_feasibility(shared: FusedShared, groups: FusedGroups,
                       carry: FusedCarry, g: int, s: int,
                       x_prev: Optional[torch.Tensor], fail: torch.Tensor,
                       cap: torch.Tensor, svc: torch.Tensor,
                       res_cap: Optional[torch.Tensor] = None,
                       strat: Optional[FusedStrategy] = None,
                       sid: int = STRAT_SPREAD,
                       e: Optional[torch.Tensor] = None) -> None:
    """K1F for group slot ``g`` (inputs checked by the caller): adds
    ``x_prev``, slot ``g - 1``'s placements, into ``carry`` (None for the
    first slot of a chunk), then writes the slot's capacity ``cap``, its
    fail counts into ``fail`` (zeroed: the kernel adds), ``svc`` and, when
    given, ``res_cap``.  With ``e`` (and ``strat``) the launch is the
    scored one (``FUSED_SCORED``): it writes the slot's level under
    strategy ``sid`` into ``e`` in place of ``res_cap``.  One launch."""
    if e is not None and (strat is None or res_cap is not None):
        raise ValueError("a scored slot entry takes the run's strategy "
                         "parameters and writes no res_cap")
    if e is not None and sid == STRAT_LEARNED:
        _check_mlp(strat, e.device)
    if not _on_cuda(shared.valid):
        _, c, f, _, rc, sv, _, _, lv = _fused_feasibility_plain(
            shared, groups, carry, g, s, x_prev,
            strat if e is not None else None, sid)
        cap.copy_(c)
        fail.copy_(f)
        svc.copy_(sv)
        if res_cap is not None:
            res_cap.copy_(rc)
        if e is not None:
            e.copy_(lv)
        return
    table = None if e is None else ctypes.byref(_score_table(
        sid, groups.failures[g], e,
        (strat.weights[g], strat.w1, strat.b1, strat.w2, strat.b2)))
    (FUSED_FEASIBILITY if e is None else FUSED_SCORED)(
        shared.valid.shape[0], s, groups.con_op.shape[-1],
        groups.plat.shape[1], g, *map(_cuda.ptr, (
            shared.valid, shared.ready, shared.os_hash, shared.arch_hash,
            shared.svc0, groups.k, groups.slot, groups.maxrep, groups.cpu_d,
            groups.mem_d, groups.con_hash, groups.con_op, groups.con_exp,
            groups.plat, groups.extra_mask, groups.quota_ok, carry.total,
            carry.cpu, carry.mem, carry.svc_acc, x_prev, fail, cap, svc,
            res_cap)), table)


def _scored(sid: int) -> bool:
    """True for a strategy that scores with parameters (weighted, learned):
    its slot entry writes its level."""
    return sid in (STRAT_WEIGHTED, STRAT_LEARNED)


class _SlotScratch(NamedTuple):
    """The columns a chunk's slots hand from K1F to their fills, made once
    a chunk (per shard on a mesh)."""

    cap: torch.Tensor
    svc: torch.Tensor
    res_cap: Optional[torch.Tensor]   # binpack slots
    e: Optional[torch.Tensor]         # weighted and learned slots' level
    seg: Optional[torch.Tensor]       # the one-segment fill's zeros


def _slot_scratch(n: int, dev, sids: Sequence[int]) -> _SlotScratch:
    i32 = torch.int32
    scored = any(_scored(v) for v in sids)

    def col():
        return torch.empty(n, dtype=i32, device=dev)

    return _SlotScratch(
        cap=col(), svc=col(),
        res_cap=col() if STRAT_BINPACK in sids else None,
        e=col() if scored else None,
        seg=torch.zeros(n, dtype=i32, device=dev) if scored else None)


def _slot_entry(shared: FusedShared, groups: FusedGroups, carry: FusedCarry,
                g: int, s: int, sid: int, x_prev, row: torch.Tensor,
                sc: _SlotScratch, strat: Optional[FusedStrategy]):
    """K1F for slot ``g`` into ``sc`` and ``row``'s fail slot (the scored
    launch for a weighted or learned slot); returns the (NodeInputs,
    GroupInputs) its fill reads: the fill's columns and k alone (K1's other
    inputs stay unread once ``cap`` is given)."""
    n = shared.valid.shape[0]
    scored = _scored(sid)
    _fused_feasibility(
        shared, groups, carry, g, s, x_prev, row[n:n + N_FILTERS], sc.cap,
        sc.svc, sc.res_cap if sid == STRAT_BINPACK else None,
        strat if scored else None, sid, sc.e if scored else None)
    nodes = NodeInputs(
        valid=shared.valid, ready=shared.ready, res_ok=None,
        res_cap=sc.res_cap, svc_tasks=sc.svc, total_tasks=carry.total,
        failures=groups.failures[g], leaf=groups.leaf[g], os_hash=None,
        arch_hash=None, port_conflict=None, extra_mask=None)
    grp = GroupInputs(k=groups.k[g], con_hash=None, con_op=None,
                      con_exp=None, plat=None, maxrep=None,
                      port_limited=None)
    return nodes, grp


def _check_sids(sids: Sequence[int], g_count: int,
                strat) -> List[int]:
    """Strategy ids clipped to [0, 3] as the reference's switch clips
    them, checked against the slot count."""
    sids = [min(max(int(v), STRAT_SPREAD), STRAT_LEARNED) for v in sids]
    if len(sids) != g_count:
        raise ValueError(f"{len(sids)} strategy ids for {g_count} slots")
    if strat is None and any(sids):
        raise ValueError("non-spread group slots need a FusedStrategy")
    return sids


def plan_fused_packed(shared: FusedShared, groups: FusedGroups,
                      carry: FusedCarry, L: int,
                      strat: Optional[FusedStrategy], sids: Sequence[int],
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plan a chunk of group slots in order; returns the int32 rows
    ``[G, x (N) | fail_counts (8) | spill (1)]`` (``out``, zeroed, when
    given) and updates ``carry`` in place.

    ``sids`` is the host's copy of each slot's strategy id, which picks the
    slot's launch sequence without reading the device: K1F (the previous
    slot's placements into the carry, this slot's columns and K1, and for
    a weighted or learned slot K6's score in the same launch), then K2 + 2
    x K3 (spread, over the run-wide ``L`` leaves), K5 (binpack) or K3
    (weighted, learned); after the last slot, K4's carry update.  The
    inputs are checked once a chunk; each slot makes unchecked launches.
    ``sids`` equals ``strat.sid`` (all spread when ``strat`` is None).  Ids
    are clipped to [0, 3] as the reference's switch clips them; padding
    slots (k = 0) plan like any other and place nothing."""
    n, s = _check_fused_inputs(shared, groups, carry, strat)
    g_count = groups.k.shape[0]
    dev = shared.valid.device
    sids = _check_sids(sids, g_count, strat)
    if out is None:
        out = torch.zeros((g_count, n + N_FILTERS + 1), dtype=torch.int32,
                          device=dev)
    _check("out", out, torch.int32, (g_count, n + N_FILTERS + 1), dev)
    sc = _slot_scratch(n, dev, sids)
    x_prev = None
    for g, sid in enumerate(sids):
        row = out[g]
        nodes, grp = _slot_entry(shared, groups, carry, g, s, sid, x_prev,
                                 row, sc, strat)
        if sid == STRAT_SPREAD:
            plan_group_packed(nodes, grp, L, out=row, cap=sc.cap)
        else:
            plan_strategy_packed(nodes, grp, None, sid, out=row, cap=sc.cap,
                                 seg=sc.seg, e=sc.e)
        x_prev = row[:n]
    if g_count:
        _fused_carry(groups, carry, g_count - 1, s, x_prev)
    return out


def plan_fused(shared: FusedShared, groups: FusedGroups, carry: FusedCarry,
               L: int, strat: Optional[FusedStrategy], sids: Sequence[int]):
    """The reference ``plan_fused``'s outputs: (x i32[G, N], fail_counts
    i32[G, 8], spill bool[G], carry) -- the carry updated in place.
    Placements equal planning each group alone, in order, after applying
    the groups before it."""
    buf = plan_fused_packed(shared, groups, carry, L, strat, sids)
    return (*unpack_fused(buf, shared.valid.shape[0]), carry)


def unpack_fused(buf, n: int):
    """Split fused result rows (torch tensor or numpy array, [G, N + 9])
    into (x [G, N], fail_counts [G, 8], spill bool[G])."""
    return buf[:, :n], buf[:, n:n + N_FILTERS], buf[:, n + N_FILTERS] != 0


# ------------------------------------------------ K7: dirty-row scatter
#
# The streaming scheduler keeps five node columns resident on the device
# (valid, ready, cpu, mem, total) and refreshes only the rows its delta
# tracker marked dirty.  A refresh packs its update slots into one byte
# buffer -- one H2D copy, one launch -- laid out cpu i64 | mem i64 | idx i32
# | total i32 | valid u8 | ready u8, each ``db`` long, with global row
# indices.  On a node-axis split the columns are D shards of local_n rows
# each; the same buffer and the same one launch serve them through a shard
# table (global row i lives at row i % local_n of shard i // local_n).
# Pad slots carry idx = nb and are dropped, as is any index outside
# [0, nb) once a negative one is taken from the end (the reference's
# ``.at[idx].set(mode="drop")``).

#: bytes per update slot of a packed scatter buffer
SCATTER_SLOT_BYTES = 26

#: the resident columns a shard hands K7, in its table's order
SCATTER_COLUMNS = (("valid", torch.bool), ("ready", torch.bool),
                   ("cpu", torch.int64), ("mem", torch.int64),
                   ("total", torch.int32))


def scatter_views(buf, db: int):
    """(idx i32, valid bool, ready bool, cpu i64, mem i64, total i32)
    views of a packed scatter buffer of ``db`` slots (a torch uint8 tensor
    or a numpy uint8 array; ``db`` even)."""
    if buf.shape[0] != SCATTER_SLOT_BYTES * db or db % 2:
        raise ValueError(f"scatter buffer of {buf.shape[0]} bytes for "
                         f"{db} slots")
    if isinstance(buf, np.ndarray):
        i64, i32, b = np.int64, np.int32, np.bool_
    else:
        i64, i32, b = torch.int64, torch.int32, torch.bool
    cpu = buf[:8 * db].view(i64)
    mem = buf[8 * db:16 * db].view(i64)
    idx = buf[16 * db:20 * db].view(i32)
    total = buf[20 * db:24 * db].view(i32)
    valid = buf[24 * db:25 * db].view(b)
    ready = buf[25 * db:].view(b)
    return idx, valid, ready, cpu, mem, total


def pack_scatter(idx, u_valid, u_ready, u_cpu, u_mem, u_total,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack ``db`` update slots (numpy arrays or sequences, one value per
    slot) into a scatter buffer (``out`` when given)."""
    db = len(idx)
    if out is None:
        out = np.zeros(SCATTER_SLOT_BYTES * db, np.uint8)
    for view, vals in zip(scatter_views(out, db),
                          (idx, u_valid, u_ready, u_cpu, u_mem, u_total)):
        view[:] = vals
    return out


def _scatter_shards(cols) -> List[Tuple[torch.Tensor, ...]]:
    """The shard table of resident columns ``cols``: five tensors (one
    shard) or, on a node-axis split, five tuples of D per-shard tensors;
    as D (valid, ready, cpu, mem, total) rows."""
    if isinstance(cols[0], torch.Tensor):
        return [tuple(cols)]
    return [tuple(col[s] for col in cols) for s in range(len(cols[0]))]


def _scatter_rows_plain(cols, packed: torch.Tensor, db: int) -> None:
    """Plain version of K7 over the shard table: per shard, five
    ``index_copy_`` writes of the slots whose global index falls in its
    rows (a negative index counts from the end, as jnp's does; every
    other slot, pads included, is dropped)."""
    shards = _scatter_shards(cols)
    ln = shards[0][0].shape[0]
    idx, *updates = scatter_views(packed, db)
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + ln * len(shards), idx)
    for s, shard in enumerate(shards):
        keep = (idx >= s * ln) & (idx < (s + 1) * ln)
        rows = idx[keep] - s * ln
        for col, upd in zip(shard, updates):
            col.index_copy_(0, rows, upd[keep])


def scatter_rows(cols, packed: torch.Tensor) -> None:
    """Write the packed update slots into the resident columns in place
    (reference ``_scatter_rows_jit``, whose buffers are donated, and
    ``parallel/sharded.py scatter_rows_sharded``).  ``cols`` = (valid
    bool, ready bool, cpu i64, mem i64, total i32), each a tensor of nb
    rows or a tuple of D shards of nb / D rows on one device
    (:func:`_scatter_shards`); ``packed`` is a uint8 scatter buffer with
    global row indices on that device; rows must be unique.  On the card:
    ONE launch of K7 over the shard table, whatever D."""
    shards = _scatter_shards(cols)
    if len(shards) > MAX_LAUNCH_SHARDS:
        raise ValueError(f"{len(shards)} shards: one scatter carries at "
                         f"most {MAX_LAUNCH_SHARDS}")
    ln = shards[0][0].shape[0]
    dev = shards[0][0].device
    for shard in shards:
        for (name, dtype), col in zip(SCATTER_COLUMNS, shard):
            _check(name, col, dtype, (ln,), dev)
    db = packed.shape[0] // SCATTER_SLOT_BYTES
    _check("packed", packed, torch.uint8, (SCATTER_SLOT_BYTES * db,), dev)
    if not _on_cuda(packed):
        _scatter_rows_plain(cols, packed, db)
        return
    table = (ctypes.c_void_p * (5 * len(shards)))(
        *[_cuda.ptr(c) for shard in shards for c in shard])
    SCATTER(len(shards), ln, db, _cuda.ptr(packed), ctypes.addressof(table))


# ------------------------------------------------------- K8: gang fit
#
# One verdict per gang: can the cluster absorb all k members at once?
# K1's capacity column summed, compared with min(k, K_CLAMP).  The inputs
# are the per-gang NodeInputs / GroupInputs stacked on a leading gang axis
# G; every gang is judged against the same base state.  Results land in one
# byte buffer ``[total i64 (G) | fail i32 (G, 8) | fit i32 (G)]``, 44 bytes
# a gang, which the kernel writes whole, so one D2H returns them all.
# Past one block a gang, a gang's blocks meet in a workspace of five
# accumulator words a gang that K8 puts back to zero (one a device and
# stream, made zeroed once, as K2's scratch: :func:`_gang_work`).
#
# The planner's route packs only the columns K8 reads, for every gang of a
# verdict, into ONE staging buffer (:func:`gang_stage_layout`, each column
# at a 16-byte aligned offset) and moves it with one H2D; K8 reads the
# columns where they lie in its device half (:func:`gang_views`).

def _gang_layout(g: int) -> Tuple[int, int, int]:
    """Byte offsets of (fail, fit, end) in a gang-fit buffer."""
    return 8 * g, 40 * g, 44 * g


def unpack_gang(buf, g: int):
    """Split a gang-fit buffer (torch uint8 tensor or numpy array) into
    (fit bool[G], fail_counts i32[G, 8], total i64[G])."""
    o_fail, o_fit, end = _gang_layout(g)
    if isinstance(buf, np.ndarray):
        i64, i32 = np.int64, np.int32
    else:
        i64, i32 = torch.int64, torch.int32
    total = buf[:o_fail].view(i64)
    fail = buf[o_fail:o_fit].view(i32).reshape(g, N_FILTERS)
    fit = buf[o_fit:end].view(i32) != 0
    return fit, fail, total


#: the columns K8 reads, in the packed gang stage's order: (field, True
#: for a NodeInputs field, dtype, shape of one gang's slice given (n, cc,
#: np)).  K8 never reads total_tasks, failures or leaf.
_GANG_STAGE_FIELDS = (
    ("con_hash", False, torch.int32, lambda n, cc, p: (cc, 2, n)),
    ("os_hash", True, torch.int32, lambda n, cc, p: (2, n)),
    ("arch_hash", True, torch.int32, lambda n, cc, p: (2, n)),
    ("res_cap", True, torch.int32, lambda n, cc, p: (n,)),
    ("svc_tasks", True, torch.int32, lambda n, cc, p: (n,)),
    ("valid", True, torch.bool, lambda n, cc, p: (n,)),
    ("ready", True, torch.bool, lambda n, cc, p: (n,)),
    ("res_ok", True, torch.bool, lambda n, cc, p: (n,)),
    ("extra_mask", True, torch.bool, lambda n, cc, p: (n,)),
    ("port_conflict", True, torch.bool, lambda n, cc, p: (n,)),
    ("quota_ok", True, torch.bool, lambda n, cc, p: (n,)),
    ("con_op", False, torch.int32, lambda n, cc, p: (cc,)),
    ("con_exp", False, torch.int32, lambda n, cc, p: (cc, 2)),
    ("plat", False, torch.int32, lambda n, cc, p: (p, 4)),
    ("k", False, torch.int32, lambda n, cc, p: ()),
    ("maxrep", False, torch.int32, lambda n, cc, p: ()),
    ("port_limited", False, torch.bool, lambda n, cc, p: ()),
)

_NP_DTYPE = {torch.int32: np.int32, torch.bool: np.bool_}


@lru_cache(maxsize=64)
def gang_stage_layout(g: int, n: int, cc: int, npl: int, quota: bool):
    """The packed gang stage of ``g`` gangs of ``n`` nodes, ``cc``
    constraint slots and ``npl`` platform rows (``quota``: with the quota
    column): ((field, node field?, dtype, [G, ...] shape, byte offset),
    ...) with every offset 16-byte aligned, and the stage's bytes."""
    rows, off = [], 0
    for name, node, dtype, shape in _GANG_STAGE_FIELDS:
        if name == "quota_ok" and not quota:
            continue
        full = (g,) + shape(n, cc, npl)
        rows.append((name, node, dtype, full, off))
        nbytes = int(np.prod(full)) * (4 if dtype == torch.int32 else 1)
        off += -(-nbytes // 16) * 16
    return tuple(rows), off


def gang_views(buf, g: int, n: int, cc: int, npl: int, quota: bool):
    """(NodeInputs, GroupInputs) of [G, ...] views into a packed gang stage
    ``buf`` (a torch uint8 tensor, whose views K8 reads in place, or a
    numpy uint8 array, which the host fills); the fields K8 does not read
    are None."""
    layout, nbytes = gang_stage_layout(g, n, cc, npl, quota)
    if buf.shape[0] != nbytes:
        raise ValueError(f"gang stage of {buf.shape[0]} bytes, expected "
                         f"{nbytes}")
    numpy = isinstance(buf, np.ndarray)
    fields = {}
    for name, _node, dtype, shape, off in layout:
        size = int(np.prod(shape)) * (4 if dtype == torch.int32 else 1)
        part = buf[off:off + size]
        fields[name] = (part.view(_NP_DTYPE[dtype]) if numpy
                        else part.view(dtype)).reshape(shape)
    nodes = NodeInputs(**{f: fields.get(f) for f in NodeInputs._fields})
    groups = GroupInputs(**{f: fields[f] for f in GroupInputs._fields})
    return nodes, groups


def _check_gang_inputs(nodes: NodeInputs,
                       groups: GroupInputs) -> Tuple[int, int, int, int]:
    dev = nodes.valid.device
    if nodes.valid.dim() != 2:
        raise ValueError("gang inputs need a leading gang axis")
    g, n = nodes.valid.shape
    cc = groups.con_op.shape[-1]
    npl = groups.plat.shape[1]
    b, i32 = torch.bool, torch.int32
    for name in ("valid", "ready", "res_ok", "port_conflict", "extra_mask"):
        _check(name, getattr(nodes, name), b, (g, n), dev)
    for name in ("res_cap", "svc_tasks"):
        _check(name, getattr(nodes, name), i32, (g, n), dev)
    _check("os_hash", nodes.os_hash, i32, (g, 2, n), dev)
    _check("arch_hash", nodes.arch_hash, i32, (g, 2, n), dev)
    if nodes.quota_ok is not None:
        _check("quota_ok", nodes.quota_ok, b, (g, n), dev)
    _check("con_hash", groups.con_hash, i32, (g, cc, 2, n), dev)
    _check("con_op", groups.con_op, i32, (g, cc), dev)
    _check("con_exp", groups.con_exp, i32, (g, cc, 2), dev)
    _check("plat", groups.plat, i32, (g, npl, 4), dev)
    _check("k", groups.k, i32, (g,), dev)
    _check("maxrep", groups.maxrep, i32, (g,), dev)
    _check("port_limited", groups.port_limited, b, (g,), dev)
    return g, n, cc, npl


def _gang_fit_plain(nodes: NodeInputs, groups: GroupInputs):
    """Plain version of K8: per gang, K1's plain version and an int64
    sum of the capacity.  (fit bool[G], fail i32[G, 8], total i64[G])."""
    fits, fails, totals = [], [], []
    for g in range(nodes.valid.shape[0]):
        _, cap, fail = _feasibility_plain(
            NodeInputs(*[None if v is None else v[g] for v in nodes]),
            GroupInputs(*[v[g] for v in groups]))
        total = cap.sum(dtype=torch.int64)
        fits.append(total >= torch.clamp(groups.k[g], max=K_CLAMP))
        fails.append(fail)
        totals.append(total)
    return torch.stack(fits), torch.stack(fails), torch.stack(totals)


def gang_fit_blocks(n: int, g: int) -> int:
    """The blocks a gang takes in K8 for ``g`` gangs of ``n`` nodes
    (``csrc/gangfit.cu`` gang_shape)."""
    return int(_cuda.library().sk_gang_fit_blocks(n, g))


#: K8's workspace past one block a gang, one a (device, stream): made
#: zeroed, and K8 leaves every word at zero, so it is filled only to grow
_GANG_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def _gang_work(n: int, g: int, dev) -> Optional[torch.Tensor]:
    nbytes = _cuda.library().sk_gang_fit_work_bytes(n, g)
    if not nbytes:
        return None
    key = (dev.index, _cuda.stream_handle())
    work = _GANG_WORK.get(key)
    if work is None or work.numel() < nbytes:
        work = _GANG_WORK[key] = torch.zeros(nbytes, dtype=torch.uint8,
                                             device=dev)
    return work


def gang_fit_packed(nodes: NodeInputs, groups: GroupInputs) -> torch.Tensor:
    """K8 over stacked gang inputs (tensors of their own, or
    :func:`gang_views` of a packed stage) into one byte buffer on the
    inputs' device (see :func:`unpack_gang`).  On the card the buffer is
    ``torch.empty``: K8 writes every byte of it."""
    g, n, cc, npl = _check_gang_inputs(nodes, groups)
    dev = nodes.valid.device
    buf = torch.empty(_gang_layout(g)[2], dtype=torch.uint8, device=dev)
    if not _on_cuda(nodes.valid):
        _, fail, total = unpack_gang(buf, g)
        p_fit, p_fail, p_total = _gang_fit_plain(nodes, groups)
        total.copy_(p_total)
        fail.copy_(p_fail)
        buf[_gang_layout(g)[1]:].view(torch.int32).copy_(p_fit)
        return buf
    GANG_FIT(n, g, cc, npl, *map(_cuda.ptr, (
        nodes.valid, nodes.ready, nodes.res_ok, nodes.res_cap,
        nodes.svc_tasks, nodes.extra_mask, groups.con_hash, groups.con_op,
        groups.con_exp, groups.plat, nodes.os_hash, nodes.arch_hash,
        nodes.port_conflict, nodes.quota_ok, groups.k, groups.maxrep,
        groups.port_limited, buf, _gang_work(n, g, dev))))
    return buf


def gang_fit_fused(nodes: NodeInputs, groups: GroupInputs):
    """The reference ``gang_fit_fused_jit``: every field of ``nodes`` and
    ``groups`` carries a leading gang axis G (``quota_ok`` stacked for all
    gangs or None for all); returns (fit bool[G], fail_counts i32[G, 8]),
    each gang judged against its own slice of the same base state."""
    fit, fail, _ = unpack_gang(gang_fit_packed(nodes, groups),
                               nodes.valid.shape[0])
    return fit, fail


def gang_fit(nodes: NodeInputs, group: GroupInputs):
    """The reference ``gang_fit``: (fit bool scalar, fail_counts i32[8])
    -- ``fit`` is True iff the summed per-node capacity covers min(k,
    K_CLAMP).  K8 with one gang."""
    fit, fail = gang_fit_fused(
        NodeInputs(*[None if v is None else v.unsqueeze(0) for v in nodes]),
        GroupInputs(*[v.unsqueeze(0) for v in group]))
    return fit[0], fail[0]


# ------------------------------------------------------- node-axis split
#
# The counterpart of the reference's shard_map programs
# (swarmkit_tpu/parallel/sharded.py): D shards, shard d owning rows
# [d * n, (d + 1) * n) of every node column in tensors of its own, on its
# own device (one card may hold several shards).  Each shard runs the
# elementwise kernels (K1, K1F with its score epilogue, K4's carry update)
# on its rows alone.
# What crosses shards is what the reference psums, and nothing else: the 8
# fail counts (summed at the fetch, see :func:`merge_shard_rows`), stage
# A's branch sums, each step of the node-level searches and the base fill,
# and the pack fill's count.  On the card K2 sums a stage-A level over
# every shard's rows in one launch, K10 each search step inside one
# cluster launch, K11 each level of its select inside one block (int64,
# exact in any order); the plain versions sum the D shards' partials in
# shard order through ``reduce``, in int64: exact, deterministic, and the
# same on every shard.  Clamps apply to the summed sums, never per shard.
# Stage A's water-fills run on [L_d] vectors that every shard holds alike:
# on the card one K3 launch a level fills them for every shard (they share
# its output), and only shard 0's row carries the spill it flags; on CPU
# shards every shard computes them and ends with the same allocation and
# spill.  Either way :func:`merge_shard_rows` takes shard 0's spill.
#
# Every shard of a mesh lies on one card (``parallel.NodeMesh`` refuses a
# mesh over several), which is what lets K2, K10 and K11 see every shard's
# rows in one launch.  A mesh over several cards is blocked (ROADMAP.md).

#: a node-level water-fill's steps: 34 level steps, the base fill, 34 tie
#: steps, the placement (K10 runs them in one launch; the plain version's
#: psums are one fewer)
WATERFILL_STEPS = LEVEL_ITERS + TIE_ITERS + 2
#: shards one launch carries (``csrc/shard.cuh`` MAX_LAUNCH_SHARDS)
MAX_LAUNCH_SHARDS = 16
# pointer slots per shard of the launch table (``csrc/shard.cuh``)
_SHARD_SLOTS = ("e", "svc_tasks", "failures", "res_cap", "cap", "tie",
                "total", "seg", "k", "out", "valid")


class FillShard(NamedTuple):
    """One shard's inputs to a node-level fill (K10 or K11), on its own
    device.  ``offset`` is the global index of its first row."""

    cap: torch.Tensor                        # i32[n] per-node capacity
    k: torch.Tensor                          # i32[L] units per segment
    out: Optional[torch.Tensor] = None       # i32[n] placement (written)
    e: Optional[torch.Tensor] = None         # i32[n] level (K10), or the
    svc_tasks: Optional[torch.Tensor] = None  # spread score of svc_tasks
    failures: Optional[torch.Tensor] = None  # and failures (K10, K11 key)
    res_cap: Optional[torch.Tensor] = None   # i32[n] binpack key (K11)
    tie: Optional[torch.Tensor] = None       # i32[n] tie key, or from
    total: Optional[torch.Tensor] = None     # (clip(total) << 20) | idx
    seg: Optional[torch.Tensor] = None       # i32[n] segment, None: 0
    offset: int = 0
    valid: Optional[torch.Tensor] = None     # bool[n] (K2's branch loads)


def sum_shards(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The exchange's fold: the shards' partials summed in shard order, in
    int64, on the first shard's device.  The default ``reduce`` of the
    plain versions."""
    out = parts[0].to(torch.int64).clone()
    for p in parts[1:]:
        out += p.to(device=out.device, dtype=torch.int64)
    return out


def _split_route(devices: Sequence[torch.device], reduce) -> bool:
    """True when a split's shards lie on the card (launch the kernels),
    False on the CPU (the plain versions, summing through ``reduce``).
    Every shard must lie on one device type, and CUDA shards on one card;
    a custom ``reduce`` is the plain versions' alone."""
    on_cuda = devices[0].type == "cuda"
    if any((dev.type == "cuda") != on_cuda for dev in devices):
        raise ValueError("a split's shards mix CPU and CUDA tensors")
    if on_cuda:
        if any(dev != devices[0] for dev in devices):
            raise ValueError("a split's shards lie on several cards")
        if reduce is not None:
            raise ValueError("a custom reduce runs only on CPU shards")
    return on_cuda


def _check_shards(parts: Sequence[FillShard], L: int, need,
                  reduce) -> bool:
    """Check a fill's per-shard inputs; True when they lie on the card
    (launch), False on the CPU (plain version)."""
    if not parts:
        raise ValueError("a node-level fill needs at least one shard")
    on_cuda = _split_route([p.cap.device for p in parts], reduce)
    i32 = torch.int32
    for p in parts:
        n, dev = p.cap.shape[0], p.cap.device
        _check("cap", p.cap, i32, (n,), dev)
        _check("k", p.k, i32, (L,), dev)
        _check("out", p.out, i32, (n,), dev)
        for name in need:
            _check(name, getattr(p, name), i32, (n,), dev)
        for name in ("tie", "total", "seg"):
            t = getattr(p, name)
            if t is not None:
                _check(name, t, i32, (n,), dev)
    if on_cuda and len(parts) > MAX_LAUNCH_SHARDS:
        raise ValueError(f"more than {MAX_LAUNCH_SHARDS} shards on one card")
    return on_cuda


def _fill_keys(p: FillShard, i32=torch.int32) -> torch.Tensor:
    if p.tie is not None:
        return p.tie
    idx = torch.arange(p.cap.shape[0], dtype=i32, device=p.cap.device) \
        + p.offset
    if p.total is None:
        return idx
    return (torch.clamp(p.total, 0, TOTAL_CLAMP) << IDX_BITS) | idx


def _shard_waterfill_plain(parts: Sequence[FillShard], L: int,
                           reduce=None) -> List[torch.Tensor]:
    """Plain version of K10: the reference's ``seg_waterfill`` with every
    [L] partial sum taken over the shards through ``reduce`` (its psum).
    The search bounds are replicated values, computed once here.  Returns
    each shard's placement."""
    reduce = reduce or sum_shards
    i32, i64 = torch.int32, torch.int64
    es = [p.e if p.e is not None else _spread_score(p.svc_tasks, p.failures)
          for p in parts]
    ties = [_fill_keys(p) for p in parts]
    segs = [(p.seg if p.seg is not None else
             torch.zeros(p.cap.shape[0], dtype=i32, device=p.cap.device)
             ).to(i64) for p in parts]
    k64 = parts[0].k.to(i64)
    dev = k64.device

    def psum(values):
        return reduce([torch.zeros(L, dtype=i64, device=v.device).index_add_(
            0, seg, v.to(i64)) for v, seg in zip(values, segs)]).to(dev)

    def fill_at(lam):
        return [torch.minimum(torch.clamp(lam.to(e.device)[seg] - e, min=0),
                              p.cap) for p, e, seg in zip(parts, es, segs)]

    lo = torch.zeros(L, dtype=i32, device=dev)
    hi = torch.full((L,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(LEVEL_ITERS):
        mid = lo + ((hi - lo) >> 1)
        ge = psum(fill_at(mid)) >= k64
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    x_base = fill_at(hi - 1)
    r = torch.clamp(k64 - psum(x_base), min=0)
    marginal = [(e <= (hi - 1).to(e.device)[seg]) & (xb < p.cap)
                for p, e, seg, xb in zip(parts, es, segs, x_base)]
    tlo = torch.full((L,), -1, dtype=i32, device=dev)
    thi = torch.full((L,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(TIE_ITERS):
        mid = tlo + ((thi - tlo) >> 1)
        ge = psum([m & (t <= mid.to(t.device)[seg])
                   for m, t, seg in zip(marginal, ties, segs)]) >= r
        tlo, thi = torch.where(ge, tlo, mid + 1), torch.where(ge, mid, thi)
    return [(xb + (m & (t <= thi.to(t.device)[seg])
                   & (r.to(t.device)[seg] > 0)).to(i32)).to(i32)
            for xb, m, t, seg in zip(x_base, marginal, ties, segs)]


def _shard_table(parts):
    """A fill's launch table: each shard's ``_SHARD_SLOTS`` pointers and
    its (n, offset) pair, as ctypes arrays that must live until the launch
    is enqueued.  The shards must hold equal row counts."""
    n = parts[0].cap.shape[0]
    if any(p.cap.shape[0] != n for p in parts):
        raise ValueError("the shards of a fill on the card must hold equal "
                         "row counts")
    ptrs, ints = [], []
    for p in parts:
        for name in _SHARD_SLOTS:
            ptrs.append(_cuda.ptr(getattr(p, name)))
        ints += [n, p.offset]
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints))


def _shard_waterfill(parts: Sequence[FillShard], L: int,
                     reduce=None) -> None:
    """K10: the node-level water-fill of ``L`` segments over every shard
    of a node-axis split, written into each shard's ``out``.  K3's options
    per shard: the level ``e`` or the spread score of (``svc_tasks``,
    ``failures``); the tie key ``tie`` or (clip(``total``) << 20) | (index
    + offset), or the global index.  ``k`` is the same [L] on every
    shard.  On the card: one launch of K3's cluster kernel over every
    shard's rows (equal row counts, as :func:`_local_n` enforces).
    ``reduce``: the plain version's psum (CPU shards only)."""
    need = () if all(p.e is not None for p in parts) \
        else ("svc_tasks", "failures")
    for p in parts:
        if p.e is not None:
            _check("e", p.e, torch.int32, (p.cap.shape[0],), p.cap.device)
    if not _check_shards(parts, L, need, reduce):
        for p, x in zip(parts, _shard_waterfill_plain(parts, L, reduce)):
            p.out.copy_(x)
        return
    dev = parts[0].cap.device
    ptrs, ints = _shard_table(parts)
    nbytes = _waterfill_scratch_bytes(L)
    with torch.cuda.device(dev):
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) \
            if nbytes else None
        SHARD_WATERFILL(len(parts), L, ctypes.addressof(ptrs),
                        ctypes.addressof(ints), MAX_FAILURES,
                        _cuda.ptr(scratch))


def _shard_packfill_plain(parts: Sequence[FillShard],
                          reduce=None) -> List[torch.Tensor]:
    """Plain version of K11: the reference's ``seg_packfill`` over one
    segment with the binpack key of (``res_cap``, ``failures``) on the
    global index, every capacity sum taken over the shards through
    ``reduce``.  Returns each shard's placement."""
    reduce = reduce or sum_shards
    i32, i64 = torch.int32, torch.int64
    keys = []
    for p in parts:
        idx = torch.arange(p.cap.shape[0], dtype=i32,
                           device=p.cap.device) + p.offset
        score = torch.where(p.failures >= MAX_FAILURES,
                            BP_CLAMP + 1 + torch.clamp(p.failures, 0,
                                                       FAILURE_CLAMP),
                            torch.clamp(p.res_cap, 0, BP_CLAMP))
        keys.append(((score << IDX_BITS) | idx).to(i32))
    k64 = parts[0].k.to(i64)
    dev = k64.device

    def psum(values):
        return reduce([v.to(i64).sum().reshape(1) for v in values]).to(dev)

    lo = torch.full((1,), -1, dtype=i32, device=dev)
    hi = torch.full((1,), SEARCH_HI, dtype=i32, device=dev)
    for _ in range(TIE_ITERS):
        mid = lo + ((hi - lo) >> 1)
        ge = psum([torch.where(key <= mid, p.cap, 0)
                   for p, key in zip(parts, keys)]) >= k64
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    xs = [torch.where(key < hi, p.cap, 0) for p, key in zip(parts, keys)]
    r = torch.clamp(k64 - psum(xs), min=0)
    return [(x + torch.where((key == hi) & (r > 0),
                             torch.minimum(p.cap.to(i64), r), 0).to(i32)
             ).to(i32) for p, key, x in zip(parts, keys, xs)]


def _shard_packfill(parts: Sequence[FillShard], reduce=None) -> None:
    """K11: the binpack fill of one group (one segment) over every shard
    of a node-axis split, written into each shard's ``out``.  On the card:
    one launch of K5's kernel over every shard's rows (equal row counts,
    as :func:`_local_n` enforces).  ``reduce``: the plain version's psum
    (CPU shards only)."""
    if not _check_shards(parts, 1, ("res_cap", "failures"), reduce):
        for p, x in zip(parts, _shard_packfill_plain(parts, reduce)):
            p.out.copy_(x)
        return
    ptrs, ints = _shard_table(parts)
    with torch.cuda.device(parts[0].cap.device):
        SHARD_PACKFILL(len(parts), ctypes.addressof(ptrs),
                       ctypes.addressof(ints), MAX_FAILURES)


# ------------------------------------------- K2 over a node-axis split

def _seg_partial_plain(svc_tasks, valid, cap, seg, L: int) -> torch.Tensor:
    """One shard's unclamped branch sums: int64 [2, L] (load, capacity).
    A row whose segment lies outside [0, L) is dropped, as the reference's
    ``segment_sum`` drops it (and K2)."""
    i64 = torch.int64
    inside = (seg >= 0) & (seg < L)
    seg_l = torch.where(inside, seg, 0).to(i64)
    svc = torch.where(valid & inside, torch.clamp(svc_tasks, 0, SVC_CLAMP),
                      torch.zeros_like(svc_tasks))
    out = torch.zeros((2, L), dtype=i64, device=svc_tasks.device)
    out[0].index_add_(0, seg_l, svc.to(i64))
    out[1].index_add_(0, seg_l, torch.where(inside, cap, 0).to(i64))
    return out


def _seg_clamp(load_raw, raw_cap, k):
    """The reference's clamps on summed branch arrays (``kernel.py:305-312``):
    (load i32[L], bcap i32[L], raw_cap i64[L], kk i32[1])."""
    kk = torch.clamp(k, max=K_CLAMP).reshape(1).to(torch.int32)
    load = torch.clamp(load_raw, max=LOAD_CLAMP).to(torch.int32)
    bcap = torch.minimum(raw_cap, kk.to(torch.int64)).to(torch.int32)
    return load, bcap, raw_cap, kk


def _seg_fold_plain(rows: Sequence[torch.Tensor], k: torch.Tensor,
                    reduce=None):
    """Plain version of a split's stage-A sums after the shards' partials:
    the shards' unclamped [2, L] (load, capacity) rows summed through
    ``reduce`` (the reference's psum; default :func:`sum_shards`, in shard
    order, int64), then clamped as the reference clamps its psummed branch
    arrays: (load i32[L], bcap i32[L], raw_cap i64[L], kk i32[1]) on the
    sum's device."""
    total = (reduce or sum_shards)(list(rows))
    return _seg_clamp(total[0], total[1], k.to(total.device))


def _check_stage_a_parts(parts: Sequence[Tuple]) -> None:
    i32 = torch.int32
    for svc_tasks, valid, cap, seg, k in parts:
        n, dev = svc_tasks.shape[0], svc_tasks.device
        _check("svc_tasks", svc_tasks, i32, (n,), dev)
        _check("valid", valid, torch.bool, (n,), dev)
        _check("cap", cap, i32, (n,), dev)
        _check("seg", seg, i32, (n,), dev)
        _check("k", k, i32, (), dev)


def _shard_seg_sum(parts: Sequence[Tuple], L: int, outs=None):
    """K2 over a split on the card: ONE launch sums the level over every
    shard's rows (``csrc/segsum.cu`` sk_shard_seg_sum; the shards must
    hold equal row counts) and clamps.  Returns the level's (load, bcap,
    raw_cap, kk): ``outs``, fresh tensors, else this stream's output
    buffers for ``L``, valid until the next K2 call on the stream (a
    composition reads them before it makes the next call)."""
    first = parts[0][0]
    n = first.shape[0]
    if len(parts) > MAX_LAUNCH_SHARDS:
        raise ValueError(f"more than {MAX_LAUNCH_SHARDS} shards on one card")
    ptrs, ints = _shard_table([
        FillShard(cap=cap, k=None, svc_tasks=svc, seg=seg, valid=valid,
                  offset=d * n)
        for d, (svc, valid, cap, seg, _k) in enumerate(parts)])
    stream = _cuda.stream_handle()
    if outs is None:
        key = (first.get_device(), stream, L)
        entry = _SEG_SUM_OUT.get(key)
        if entry is None:
            acc = _seg_sum_acc(first, L, stream)
            outs = _seg_sum_outputs(first.device, L)
            entry = _SEG_SUM_OUT[key] = (outs, _seg_sum_table(*acc, outs))
        outs, table = entry
    else:
        table = _seg_sum_table(*_seg_sum_acc(first, L, stream), outs)
    SHARD_SEG_SUM.launch(len(parts), L, ctypes.addressof(ptrs),
                         ctypes.addressof(ints), parts[0][4].data_ptr(),
                         ctypes.addressof(table), stream=stream)
    return outs


def branch_sums_sharded(parts: Sequence[Tuple], L: int,
                        reduce=None) -> List[Tuple]:
    """Stage-A branch arrays over a node-axis split: ``parts`` holds each
    shard's (svc_tasks, valid, cap, seg, k) on its device.  Returns each
    shard's (load, bcap, raw_cap, kk), equal on every shard.  On the card
    ONE K2 launch sums every shard's rows and clamps (``shard_seg_sum``),
    and every shard's entry is that one tuple (the shards share a card).
    On CPU shards each shard's partials are summed through ``reduce``
    (the reference's psum; default :func:`sum_shards`) and clamped
    (:func:`_seg_fold_plain`)."""
    _check_stage_a_parts(parts)
    devices = [p[0].device for p in parts]
    if not _split_route(devices, reduce):
        rows = [_seg_partial_plain(svc, valid, cap, seg, L)
                for svc, valid, cap, seg, _ in parts]
        sums = _seg_fold_plain(rows, parts[0][4], reduce)
        return [tuple(t.to(dev) for t in sums) for dev in devices]
    with torch.cuda.device(devices[0]):
        sums = _shard_seg_sum(parts, L, _seg_sum_outputs(devices[0], L))
    return [sums] * len(parts)


# ---------------------------------------------- sharded plan compositions

def _shard_rows(bufs: Sequence[torch.Tensor], n: int):
    """(x, fail, spill) views of each shard's plan row."""
    return [(b[:n], b[n:n + N_FILTERS], b[n + N_FILTERS:]) for b in bufs]


def _local_n(first: torch.Tensor, shards) -> int:
    n = first.shape[0]
    for nodes in shards:
        if nodes.valid.shape[0] != n:
            raise ValueError("shards of a node-axis split must hold equal "
                             "row counts")
    return n


def plan_group_sharded_packed(shards: Sequence[Tuple], L: int,
                              outs: Optional[Sequence[torch.Tensor]] = None,
                              reduce=None,
                              caps: Optional[Sequence[torch.Tensor]] = None
                              ) -> List[torch.Tensor]:
    """:func:`plan_group_packed` over a node-axis split (reference
    ``plan_group_sharded``): ``shards`` holds each shard's (NodeInputs,
    GroupInputs, hier) on its device, rows split and group scalars
    replicated; ``hier``'s segment columns are split and its parent maps
    replicated.  Returns each shard's int32 row ``[x (n) | fail_counts (8)
    | spill (1)]`` (``outs``, zeroed, when given): its own placements and
    fail counts, and the spill.

    Per shard K1; then per stage-A level the branch sums over every shard
    and a K3 fill of the replicated branch vectors; then K10 over every
    shard.  On the card each level is ONE K2 launch over the shard table
    and ONE K3 launch, whose allocation every shard's next level (or K10)
    reads, and only shard 0's row carries the spill (the row
    :func:`merge_shard_rows` takes it from).  On CPU shards every value
    that crosses shards, except the fail counts that
    :func:`merge_shard_rows` sums at the fetch, goes through ``reduce``
    (the reference's psum; default :func:`sum_shards`), and every shard
    runs the level's fill and carries the spill.  ``caps``: each shard's
    capacity from K1F, as ``cap`` in :func:`plan_group_packed` (K1 skipped
    on every shard)."""
    n = _local_n(shards[0][0].valid, [s[0] for s in shards])
    D = len(shards)
    bufs = [_plan_buffer(n, nodes.valid.device,
                         None if outs is None else outs[d])
            for d, (nodes, _g, _h) in enumerate(shards)]
    rows = _shard_rows(bufs, n)
    if caps is None:
        caps = []
        for (nodes, group, _h), (_x, fail, _s) in zip(shards, rows):
            cap = torch.empty(n, dtype=torch.int32,
                              device=nodes.valid.device)
            _feasibility_into(nodes, group, None, cap, fail)
            caps.append(cap)
    on_cuda = _split_route([nodes.valid.device for nodes, _g, _h in shards],
                           reduce)
    # the shards whose rows run stage A's fills: one a card, else each
    fills = 1 if on_cuda else D

    uppers = [h[0] if h else () for _n, _g, h in shards]
    leaf_parents = [h[1] if h else None for _n, _g, h in shards]
    k_parent = [None] * D
    parent_count = 1

    def stage_a(segs, L_d):
        parts = [(nodes.svc_tasks, nodes.valid, cap, seg, group.k)
                 for (nodes, group, _h), cap, seg in zip(shards, caps, segs)]
        if not on_cuda:
            return branch_sums_sharded(parts, L_d, reduce)
        _check_stage_a_parts(parts)
        with torch.cuda.device(parts[0][0].device):
            return [_shard_seg_sum(parts, L_d)]

    for level in range(len(uppers[0])):
        parents = [u[level][1] for u in uppers]
        L_d = parents[0].shape[0]
        sums = stage_a([u[level][0] for u in uppers], L_d)
        new = []
        for (load, bcap, raw, kk), parent, kp, (_x, _f, spill) in zip(
                sums, parents[:fills], k_parent, rows):
            new.append(_waterfill(
                e=load, cap=bcap, k_seg=kk if kp is None else kp,
                seg=parent, L=parent_count,
                out=torch.empty(L_d, dtype=torch.int32, device=load.device),
                raw_cap=raw if L_d > 1 else None,
                spill=spill if L_d > 1 else None))
        k_parent = new * (D // fills)
        parent_count = L_d

    sums = stage_a([nodes.leaf for nodes, _g, _h in shards], L)
    k_branch = []
    for (load, bcap, raw, kk), lp, kp, (_x, _f, spill) in zip(
            sums, leaf_parents[:fills], k_parent, rows):
        if L == 1 and not uppers[0]:
            k_branch.append(bcap)
            continue
        seg = lp if lp is not None \
            else torch.zeros(L, dtype=torch.int32, device=load.device)
        k_branch.append(_waterfill(
            e=load, cap=bcap, k_seg=kk if kp is None else kp, seg=seg,
            L=parent_count,
            out=torch.empty(L, dtype=torch.int32, device=load.device),
            raw_cap=raw if L > 1 else None, spill=spill if L > 1 else None))
    k_branch = k_branch * (D // fills)

    _shard_waterfill([
        FillShard(svc_tasks=nodes.svc_tasks, failures=nodes.failures,
                  total=nodes.total_tasks, cap=cap, k=kb, seg=nodes.leaf,
                  out=x, offset=d * n)
        for d, ((nodes, _g, _h), cap, kb, (x, _f, _s)) in enumerate(
            zip(shards, caps, k_branch, rows))], L, reduce)
    return bufs


def plan_strategy_sharded_packed(shards: Sequence[Tuple],
                                 sins: Optional[Sequence], strategy: int,
                                 outs: Optional[Sequence[torch.Tensor]] = None,
                                 reduce=None,
                                 caps: Optional[Sequence[torch.Tensor]] = None,
                                 es: Optional[Sequence[torch.Tensor]] = None
                                 ) -> List[torch.Tensor]:
    """:func:`plan_strategy_packed` over a node-axis split (reference
    ``plan_strategy_sharded``): ``shards`` holds each shard's (NodeInputs,
    GroupInputs), ``sins`` each shard's StrategyInputs (headroom split,
    weights and MLP replicated; None for binpack).  Per shard K1 (for
    weighted and learned with K6's score as its epilogue); then K11
    (binpack) or K10 over every shard, on global indices.  ``reduce`` and
    ``caps`` as in :func:`plan_group_sharded_packed`; with ``caps``,
    weighted and learned take each shard's level ``es`` from K1F."""
    n = _local_n(shards[0][0].valid, [s[0] for s in shards])
    bufs = [_plan_buffer(n, nodes.valid.device,
                         None if outs is None else outs[d])
            for d, (nodes, _g) in enumerate(shards)]
    parts = []
    for d, ((nodes, group), (x, fail, _s)) in enumerate(
            zip(shards, _shard_rows(bufs, n))):
        if caps is None:
            cap, e = _scored_entry(n, nodes.valid.device, nodes, group,
                                   None if sins is None else sins[d],
                                   strategy, fail)
        else:
            cap, e = caps[d], None if es is None else es[d]
        kk = torch.clamp(group.k, max=K_CLAMP).reshape(1)
        if strategy == STRAT_BINPACK:
            parts.append(FillShard(res_cap=nodes.res_cap,
                                   failures=nodes.failures, cap=cap, k=kk,
                                   out=x, offset=d * n))
        else:
            if e is None:
                raise ValueError("a weighted or learned plan given its "
                                 "capacity needs its level e too")
            parts.append(FillShard(e=e, total=nodes.total_tasks, cap=cap,
                                   k=kk, out=x, offset=d * n))
    if strategy == STRAT_BINPACK:
        _shard_packfill(parts, reduce)
    else:
        _shard_waterfill(parts, 1, reduce)
    return bufs


def plan_fused_sharded_packed(shareds: Sequence[FusedShared],
                              groupss: Sequence[FusedGroups],
                              carries: Sequence[FusedCarry], L: int,
                              strats: Optional[Sequence[FusedStrategy]],
                              sids: Sequence[int],
                              outs: Optional[Sequence[torch.Tensor]] = None,
                              reduce=None) -> List[torch.Tensor]:
    """:func:`plan_fused_packed` over a node-axis split (reference
    ``plan_fused_sharded``): per shard its FusedShared, FusedGroups and
    FusedCarry (node columns split, group and service scalars replicated)
    and FusedStrategy (replicated, or None for a spread-only run).  The
    carry stays split and is updated in place, shard by shard.  Returns
    each shard's rows ``[G, x (n) | fail_counts (8) | spill (1)]``.  Per
    slot: K1F on every shard (scored for a weighted or learned slot), then
    the slot's sharded fill; after the last slot, K4's carry update on
    every shard.  ``reduce`` as in :func:`plan_group_sharded_packed`."""
    D = len(shareds)
    n = _local_n(shareds[0].valid, shareds)
    checked = [_check_fused_inputs(sh, gr, ca,
                                   None if strats is None else strats[d])
               for d, (sh, gr, ca) in enumerate(zip(shareds, groupss,
                                                    carries))]
    s = checked[0][1]
    g_count = groupss[0].k.shape[0]
    sids = _check_sids(sids, g_count, strats)
    i32 = torch.int32
    bufs = []
    for d, sh in enumerate(shareds):
        dev = sh.valid.device
        if outs is None:
            bufs.append(torch.zeros((g_count, n + N_FILTERS + 1), dtype=i32,
                                    device=dev))
        else:
            _check("out", outs[d], i32, (g_count, n + N_FILTERS + 1), dev)
            bufs.append(outs[d])
    scratch = [_slot_scratch(n, sh.valid.device, sids) for sh in shareds]
    x_prev = [None] * D
    for g, sid in enumerate(sids):
        rows = [b[g] for b in bufs]
        plans = []
        for d in range(D):
            nodes, grp = _slot_entry(
                shareds[d], groupss[d], carries[d], g, s, sid, x_prev[d],
                rows[d], scratch[d], None if strats is None else strats[d])
            plans.append((nodes, grp, ()) if sid == STRAT_SPREAD
                         else (nodes, grp))
        caps = [sc.cap for sc in scratch]
        if sid == STRAT_SPREAD:
            plan_group_sharded_packed(plans, L, rows, reduce, caps=caps)
        else:
            plan_strategy_sharded_packed(
                plans, None, sid, rows, reduce, caps=caps,
                es=[sc.e for sc in scratch] if _scored(sid) else None)
        x_prev = [r[:n] for r in rows]
    if g_count:
        for d in range(D):
            _fused_carry(groupss[d], carries[d], g_count - 1, s, x_prev[d])
    return bufs


def merge_shard_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Per-shard plan rows ``[D, ..., n_local + 9]`` (fetched) as one
    unsharded row ``[..., n + 9]``: the placements in shard order, cut to
    ``n``; the fail counts summed over the shards in shard order (the
    exchange of the 8 counts, which the reference psums); the spill of
    shard 0 (on the card stage A runs once and only shard 0's row carries
    its spill; on CPU shards every shard computes it alike)."""
    d = arr.shape[0]
    ln = arr.shape[-1] - N_FILTERS - 1
    x = np.moveaxis(arr[..., :ln], 0, -2)
    x = x.reshape(x.shape[:-2] + (d * ln,))[..., :n]
    fail = arr[..., ln:ln + N_FILTERS].astype(np.int64).sum(axis=0)
    spill = arr[0, ..., ln + N_FILTERS:]
    return np.concatenate([x, fail.astype(np.int32), spill], axis=-1)


# ------------------------------------------------------- H2D / D2H seams

class UploadStage:
    """A packed staging buffer moved to the device with ONE copy: a host
    half (pinned for a CUDA device) that a caller fills, a device half
    that a non-blocking copy on the current stream fills from it (on the
    CPU, the host half itself), and the event recorded after that copy.
    :meth:`host_view` waits on the event before it hands the host half out
    for a refill: an async H2D still reads the pinned buffer after the
    call that queued it returns."""

    __slots__ = ("host", "dev", "event")

    def __init__(self, nbytes: int, device: torch.device):
        on_cuda = device.type == "cuda"
        self.host = torch.zeros(nbytes, dtype=torch.uint8,
                                pin_memory=on_cuda)
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device) \
            if on_cuda else self.host
        self.event = None

    def host_view(self) -> np.ndarray:
        """The host half as a numpy array, once no copy reads it."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host.numpy()

    def upload(self) -> torch.Tensor:
        """The packed buffer on the device: one non-blocking copy on the
        current stream, then the event the next refill waits on."""
        if self.dev is self.host:
            return self.host
        self.dev.copy_(self.host, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return self.dev


class PendingFetch:
    """One result buffer on its way to the host: a pinned host copy made
    with a single non-blocking copy, and the event recorded after it.  A
    node-axis split's rows come as ``[D, ...]`` with one copy per shard,
    and ``n`` (the unsharded row count) to merge them."""

    __slots__ = ("host", "event", "n")

    def __init__(self, host: torch.Tensor, event, n: Optional[int] = None):
        self.host = host
        self.event = event
        self.n = n


def start_fetch(buf: torch.Tensor) -> PendingFetch:
    """Enqueue the copy of ``buf`` to pinned host memory behind the work
    already queued on the current stream, and record an event; nothing
    waits here."""
    if not _on_cuda(buf):
        return PendingFetch(buf, None)
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PendingFetch(host, event)


def start_fetch_shards(bufs: Sequence[torch.Tensor],
                       n: int) -> PendingFetch:
    """Enqueue the copies of each shard's result rows into ONE pinned host
    buffer ``[D, ...]`` (one copy per shard, on the card's current
    stream) and record one event; nothing waits here.
    :func:`finish_fetch` merges the rows (:func:`merge_shard_rows`) into
    the unsharded layout of ``n`` nodes."""
    if not _split_route([b.device for b in bufs], None):
        return PendingFetch(torch.stack(list(bufs)), None, n)
    host = torch.empty((len(bufs),) + tuple(bufs[0].shape),
                       dtype=bufs[0].dtype, pin_memory=True)
    with torch.cuda.device(bufs[0].device):
        for d, buf in enumerate(bufs):
            host[d].copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return PendingFetch(host, event, n)


def finish_fetch(pending: PendingFetch) -> np.ndarray:
    """Wait for the copy's event; the buffer as a numpy array, a split's
    rows merged."""
    if pending.event is not None:
        pending.event.synchronize()
    arr = pending.host.numpy()
    if pending.n is not None:
        arr = merge_shard_rows(arr, pending.n)
    return arr


def fetch_plan(pending: PendingFetch, n: int):
    """Finish one plan's single D2H and split it: (x np.int32[N],
    fail_counts np.int32[8], spill bool).  The accounted D2H seam: the
    fetched bytes land in the device-telemetry transfer ledger."""
    arr = finish_fetch(pending)
    from ..obs import devicetelemetry as _devtel
    _devtel.note_d2h("fetch", int(arr.nbytes))
    return unpack_plan(arr, n)
