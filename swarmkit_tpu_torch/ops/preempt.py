"""Victim selection on the card: priority preemption's greedy picks.

PyTorch counterpart of ``swarmkit_tpu/ops/preempt.py``.  The scheduler's
preemption pass (``scheduler/scheduler.py _preempt_pass``) densifies the
candidate victims of one pending group into a ``CandidateSet``
(``scheduler/preempt.py build_candidates``) and asks the planner for the
picks: per pending task, the node whose cheapest victim prefix frees
enough cpu, memory and generic units, cost = sum(victim priority + 1),
ties broken by victim count and then node index.  Picks run in order; a
pick marks its victims used and carries its surplus (freed - demand) into
that node's later prefixes; the first infeasible pick, or the first whose
victim count exceeds the remaining budget, stops the run.

``select_victims`` takes K9 (``csrc/victims.cu``) for CUDA tensors and
:func:`_select_victims_plain` for CPU tensors, with no fallback between
the two.  The plain version recomputes every node's prefix on every pick,
as the reference's scan does; K9 recomputes only the chosen node's, since
a pick changes no other node's state, and finds the next pick in a
tournament tree of the nodes' keys, re-minimising only that node's path.  Both return the reference's
integers packed in one int32 buffer ``[node (PB) | m (PB)]`` (so one D2H
fetches them; ``buf.view(2, -1)`` splits it), -1 / 0 for an inactive pick
(past ``n_picks``, or after a stop).

Shapes follow the reference's ladder: nodes pad to ``n_bucket``, victim
slots to ``V_BUCKETS`` (the ``CandidateSet`` arrives padded to its V),
picks to a power of two (:func:`pick_bucket`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..obs import devicetelemetry as _devtel
from ..scheduler.preempt import V_BUCKETS, CandidateSet
from . import cuda as _cuda
from .densify import n_bucket, pow2_bucket
from .kernel import _check, _on_cuda, finish_fetch, start_fetch

#: packed tie-break key layout: cost << 27 | nvict << 20 | node index --
#: cost < 2^27 (64 victims x (PRIO_CLAMP + 1)), nvict < 2^7, index < 2^20
IDX_BITS = 20
NV_BITS = 7
MAX_NODES = 1 << IDX_BITS
MAX_KEY = torch.iinfo(torch.int64).max

VICTIMS = _cuda.CudaKernel(
    "select_victims", "sk_select_victims",
    "swarmkit_tpu_torch/csrc/victims.cu", "swarmkit_tpu/ops/preempt.py:84")
KERNELS = (VICTIMS,)


class VictimInputs(NamedTuple):
    """One group's candidate arrays on a device, padded to their buckets
    (the fields of a ``CandidateSet``)."""

    ok: torch.Tensor         # bool[N]: every filter but the resource one
    free_cpu: torch.Tensor   # i64[N] (may be negative)
    free_mem: torch.Tensor   # i64[N]
    free_gen: torch.Tensor   # i64[N]: the one discrete generic kind
    vvalid: torch.Tensor     # bool[V, N]
    vprio: torch.Tensor      # i32[V, N], clamped to PRIO_CLAMP host-side
    vcpu: torch.Tensor       # i64[V, N]
    vmem: torch.Tensor       # i64[V, N]
    vgen: torch.Tensor       # i64[V, N]


def pick_bucket(n: int) -> int:
    """Pow2 pick-slot bucket (>= 1)."""
    return pow2_bucket(max(n, 1))


def _check_inputs(inp: VictimInputs) -> Tuple[int, int]:
    dev = inp.ok.device
    if inp.vvalid.dim() != 2:
        raise ValueError("vvalid must be [V, N]")
    v, n = inp.vvalid.shape
    if v > V_BUCKETS[-1]:
        raise ValueError(f"{v} victim slots; at most {V_BUCKETS[-1]}")
    if n > MAX_NODES:
        raise ValueError(f"{n} nodes; the packed key holds {MAX_NODES}")
    i64 = torch.int64
    _check("ok", inp.ok, torch.bool, (n,), dev)
    for name in ("free_cpu", "free_mem", "free_gen"):
        _check(name, getattr(inp, name), i64, (n,), dev)
    _check("vvalid", inp.vvalid, torch.bool, (v, n), dev)
    _check("vprio", inp.vprio, torch.int32, (v, n), dev)
    for name in ("vcpu", "vmem", "vgen"):
        _check(name, getattr(inp, name), i64, (v, n), dev)
    return v, n


# ------------------------------------------------------------ plain version

def _node_prefix_plain(inp: VictimInputs, ex, live, weights, demand):
    """Every node's cheapest victim prefix at once (the reference's
    ``_node_prefix`` vmapped over nodes): (feasible bool[N], m i64[N],
    cost i32[N], nvict i32[N]).  ``m`` is the first of the V + 1 prefix
    lengths, dead slots included, at which all three resources fit."""
    n = inp.ok.shape[0]
    dev = inp.ok.device
    z64 = torch.zeros((1, n), dtype=torch.int64, device=dev)
    z32 = torch.zeros((1, n), dtype=torch.int32, device=dev)
    fits = torch.ones((inp.vvalid.shape[0] + 1, n), dtype=torch.bool,
                      device=dev)
    for free, e, col, d in zip((inp.free_cpu, inp.free_mem, inp.free_gen),
                               ex, (inp.vcpu, inp.vmem, inp.vgen), demand):
        cum = torch.cat([z64, torch.cumsum(torch.where(live, col, 0), 0)])
        fits &= free + e + cum >= d
    cum_w = torch.cat([z32, torch.cumsum(torch.where(live, weights, 0), 0,
                                         dtype=torch.int32)])
    cum_n = torch.cat([z32, torch.cumsum(live.to(torch.int32), 0,
                                         dtype=torch.int32)])
    # argmax returns the first maximal index: the first fitting prefix
    m = torch.argmax(fits.to(torch.uint8), dim=0)
    feasible = inp.ok & fits.any(dim=0)
    cost = cum_w.gather(0, m[None])[0]
    nvict = cum_n.gather(0, m[None])[0]
    return feasible, m, cost, nvict


def _select_victims_plain(inp: VictimInputs, cpu_d: int, mem_d: int,
                          gen_d: int, n_picks: int, budget: int,
                          picks: int) -> torch.Tensor:
    """Plain version of K9, step for step the reference's scan: a Python
    loop over the picks, each recomputing every node's prefix.  Nothing
    here reads a tensor back to the host.  ``[node (picks) | m (picks)]``
    int32, as :func:`select_victims`."""
    v, n = inp.vvalid.shape
    dev = inp.ok.device
    weights = inp.vprio + 1
    slot_idx = torch.arange(v, device=dev)
    node_idx = torch.arange(n, dtype=torch.int64, device=dev)
    demand = (cpu_d, mem_d, gen_d)
    used = torch.zeros((v, n), dtype=torch.bool, device=dev)
    ex = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(3)]
    budget_rem = torch.tensor(budget, dtype=torch.int32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    nodes, ms = [], []
    for p in range(picks):
        live = inp.vvalid & ~used
        feasible, m, cost, nvict = _node_prefix_plain(inp, ex, live, weights,
                                                      demand)
        key = ((cost.to(torch.int64) << (IDX_BITS + NV_BITS))
               | (nvict.to(torch.int64) << IDX_BITS) | node_idx)
        key = torch.where(feasible, key, MAX_KEY)
        j = torch.argmin(key)
        any_f, m_j, nv_j = feasible[j], m[j], nvict[j]
        over = nv_j > budget_rem
        active = ~stopped if p < n_picks else torch.zeros_like(stopped)
        do = active & any_f & ~over
        sel = live[:, j] & (slot_idx < m_j) & do
        for e, col, d in zip(ex, (inp.vcpu, inp.vmem, inp.vgen), demand):
            freed = torch.where(sel, col[:, j], 0).sum()
            e[j] += torch.where(do, freed - d, 0)
        used[:, j] |= sel
        budget_rem = budget_rem - torch.where(do, nv_j, 0)
        stopped = stopped | (active & (~any_f | over))
        nodes.append(torch.where(do, j, -1))
        ms.append(torch.where(do, m_j, 0))
    if not picks:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return torch.stack(nodes + ms).to(torch.int32)


# ------------------------------------------------------------------- K9

@lru_cache(maxsize=None)
def _scratch_bytes(n: int) -> int:
    """K9's scratch for ``n`` nodes: per node its key, surpluses, used
    mask and prefix length, and the keys' first tree level."""
    return _cuda.library().sk_select_victims_scratch_bytes(n)


def select_victims(inp: VictimInputs, cpu_d: int, mem_d: int, gen_d: int,
                   n_picks: int, budget: int, picks: int) -> torch.Tensor:
    """The reference ``select_victims_jit``'s picks in ONE int32 buffer
    ``[node (picks) | m (picks)]`` on the inputs' device, -1 / 0 for an
    inactive pick, so one D2H returns them."""
    v, n = _check_inputs(inp)
    dev = inp.ok.device
    if not _on_cuda(inp.ok):
        return _select_victims_plain(inp, cpu_d, mem_d, gen_d, n_picks,
                                     budget, picks)
    out = torch.empty(2 * picks, dtype=torch.int32, device=dev)
    scratch = torch.empty(_scratch_bytes(n), dtype=torch.uint8, device=dev)
    VICTIMS(n, v, picks, n_picks, budget, cpu_d, mem_d, gen_d,
            *map(_cuda.ptr, inp), _cuda.ptr(scratch), _cuda.ptr(out))
    return out


def plan_victims(cand: CandidateSet, cpu_d: int, mem_d: int, gen_d: int,
                 n_picks: int, budget: int, device="cuda",
                 stages: Optional[Dict] = None
                 ) -> Tuple[List[Tuple[int, int]], str]:
    """Pad the host-built candidate arrays to their buckets, upload them
    in one packed copy, launch, fetch in one copy and unpad.  Returns
    (picks [(node, prefix length)], bucket label).  Synchronous: the
    preemption pass needs the picks at once.  ``stages`` caches the
    staging buffers across calls (see :func:`convert.victims_to_device`)."""
    from .convert import victims_to_device
    v, n = cand.vvalid.shape
    nb = n_bucket(max(n, 1))
    # the caller caps n_picks (supervisor: min(group size, budget)) so
    # host and device run the SAME number of pick iterations
    pb = pick_bucket(n_picks)
    inp = victims_to_device(cand, nb, device, stages)
    buf = select_victims(inp, int(cpu_d), int(mem_d), int(gen_d),
                         int(n_picks), int(budget), pb)
    arr = finish_fetch(start_fetch(buf))
    _devtel.note_d2h("preempt", int(arr.nbytes))
    out: List[Tuple[int, int]] = []
    for j, m in zip(arr[:pb].tolist(), arr[pb:].tolist()):
        if j >= 0:
            out.append((int(j), int(m)))
    return out, f"preempt_nb{nb}_v{v}_p{pb}"
