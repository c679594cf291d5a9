#!/usr/bin/env python3
"""Time K1, the fused chunk and its scored slot entry, a split's stage A,
K5 and K7-K11, a gang verdict and the ticks K7 and K8 serve, of two trees
of this repository on one CUDA card, in turns.

    python3 swarmkit_tpu_torch/probes/kernel_ab.py OLD_TREE NEW_TREE
    python3 swarmkit_tpu_torch/probes/kernel_ab.py --fills TREE
    python3 swarmkit_tpu_torch/probes/kernel_ab.py --gang OLD_TREE NEW_TREE

Each tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
The trees run in the order OLD, NEW, NEW, OLD, each in a process of its
own that imports that tree's ``swarmkit_tpu_torch``, builds its kernels
and measures, on the same card, with this script's own helpers (the
inputs and the profiler of the ``chip_smoke.py`` beside it):

* K9 at config 8's shape: every ``select_victims`` call of bench.py's
  config 8 tick (``workload.priority_jobs``, node bucket 1024, V = 4),
  recorded and then replayed on its own inputs;
* K9 at node bucket 16384, V = 4, 16 and 64, 512 picks
  (``chip_smoke.victim_inputs``, the full run);
* K1 at the headline plan's shape (``chip_smoke.plan_inputs``, nb 16384,
  10,000 nodes, four constraint slots, four platform rows) and at nb 2^20
  (the grid sized to the node count against one wave of the 132 SMs),
  K8 at G = 1 and at the gang fleet's G = 8 (``chip_smoke.gang_rows``,
  nb 16384),
  and a cfg7 fused chunk (``chip_smoke.fused_inputs``, nb 16384: spread,
  binpack, weighted, learned; each measurement on a fresh carry, checked
  to place every task on its last call) with its launches by kernel and
  the device time of its slot-entry kernels (K4's prologue, K1 and K4's
  carry update in a tree before K1F; K1F and the carry update after; K6
  in a tree whose slot entry does not score);
* a scored slot: a chunk of the cfg7 chunk's weighted slot alone, and of
  its learned slot alone, with the device time of the slot's entry (K1F
  and K6 in a tree whose entry does not score; the scored K1F after);
* B13, a weighted group's plan at D = 4 (``chip_smoke.py``'s inputs),
  with its device time by kernel;
* a split's stage A at D = 4: the mesh headline's plan
  (``chip_smoke.plan_inputs``, nb 16384, L = 256, four shards of the
  card) with the device time of its stage-A kernels (per shard K2's
  partials, ``seg_fold`` and K3 in a tree before one K2 launch over the
  shard table; that launch and one K3 after);
* K8 at the gang fleet's node bucket (1024, G = 1 and 2), at 4096 and
  8192 (G = 1: one and two clusters a gang) and at nb 16384 with G = 2, and one verdict through the planner's ``_gang_fit_rows``
  (from the numpy rows to the fetched verdict, whatever the tree's route)
  at nb 1024 (G = 1, 2) and 16384 (G = 1): its wall time over 200 warm
  verdicts and its device ops by kind (H2D, K8, D2H, fills) from one
  profiled verdict;
* K7 on a refresh's rows at 16, 256 and 4096 slots (``scatter_inputs``,
  nb 16384) through the tree's streaming route, unsplit and over four
  shards of the card: launches a refresh, device ms of every K7 row, the
  wrapper's ms (the stage fill, its H2D and the launches);
* the ticks: the gang fleet's on the card (twice) and on the host path,
  and the churn's tick median (config 10 with its burst window),
  streaming unsplit and over four shards of the card;
* ``--gang`` measures K8, the verdicts and the gang fleet's ticks alone,
  in the same turns;
* the fills (``--fills`` measures these alone, in one process): K5 on
  config 7's binpack slot (``chip_smoke.binpack_slot`` of a cfg7 chunk,
  nb 16384), K10 at the mesh headline's leaf fill (four shards, L = 256)
  and at one segment a row (four shards, L = 16,384), and K11 on four
  shards of nb 16384 (``chip_smoke.shard_fill_inputs``' pack case).

Per case: the wrapper's ms (CUDA events over 20 warm calls; 10 for the
chunk), the kernels' device ms (torch.profiler, every launch's row
counted; every device op for the chunk), the launches per call and the SM
clock after it (``nvidia-smi``).  Each run
prints one JSON line; the last line is the whole record, also written to
``chiprun_out/kernel_ab.json``, with the card's name and power limit.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.realpath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def _tools():
    """This tree's ``chip_smoke.py`` (inputs, timers, profiler), loaded
    under its own name so that the tree under test supplies the
    kernels."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tools", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
        torch, run, (("victim_prefix_kernel",), ("victim_pick_kernel",)),
        label="K9")
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                prefix_device_ms=prefix, pick_device_ms=pick, pb=pb,
                n_picks=args[3], picks=int((got[:pb] >= 0).sum()),
                clocks=_clocks())


def _fill_row(torch, cs, kern, run, plain, outs, symbols, label):
    """One fill: == plain, launches per call, wrapper and device ms."""
    run()
    torch.cuda.synchronize()
    cs.check(torch.equal(torch.cat(outs()), torch.cat(plain())),
             f"{label} differs from its plain version")
    before = kern.launches
    run()
    launches = kern.launches - before
    (dev,) = cs.device_ms_each(torch, run, (symbols,), per_call=[launches],
                               label=label)
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                device_ms=dev, launches_per_call=launches, clocks=_clocks())


def fill_rows(torch, cs, K, fused_to_device, dev):
    """K5, K10 and K11 at the shapes ``chip_smoke.py`` times them."""
    out = {}
    shared, groups, carry, _ = fused_to_device(
        *cs.fused_inputs(seed=77)[:4], device=dev)
    nodes, _, cap = cs.binpack_slot(torch, K, shared, groups, carry)
    n = cap.shape[0]
    kk = groups.k[1].reshape(1)
    x = torch.empty(n, dtype=torch.int32, device=dev)
    seg = torch.zeros(n, dtype=torch.int32, device=dev)
    out["k5"] = _fill_row(
        torch, cs, K.PACKFILL,
        lambda: K._packfill(res_cap=nodes.res_cap, failures=nodes.failures,
                            cap=cap, k=kk, out=x),
        lambda: [K._packfill_plain(K._binpack_key(nodes.res_cap,
                                                  nodes.failures),
                                   cap, kk, seg, 1)],
        lambda: [x], ("packfill_kernel",), "K5")

    def k10(parts, L, label):
        return _fill_row(
            torch, cs, K.SHARD_WATERFILL,
            lambda: K._shard_waterfill(parts, L),
            lambda: K._shard_waterfill_plain(parts, L),
            lambda: [p.out for p in parts],
            ("shard_waterfill_kernel", "ShardElems"), label)

    parts, L = cs.headline_fill_parts(4, dev)
    out["k10_L256"] = k10(parts, L, "K10 L256")
    wide = cs.shard_fill_inputs(31, L=16384)
    out["k10_L16384"] = k10(cs.fill_parts(wide, 4, dev), 16384,
                            "K10 L16384")
    pack = cs.fill_parts(cs.shard_fill_inputs(31, L=1, pack=True), 4, dev)
    out["k11"] = _fill_row(
        torch, cs, K.SHARD_PACKFILL, lambda: K._shard_packfill(pack),
        lambda: K._shard_packfill_plain(pack),
        lambda: [p.out for p in pack],
        ("shard_packfill_kernel", "ShardRows"), "K11")
    return out


#: the kernels of a fused chunk's slot entries, in either tree: launch
#: counter -> kernel symbol (K6's score moved into the scored K1F)
ENTRY_KERNELS = {"fused_prologue": "fused_prologue_kernel",
                 "feasibility": "feasibility_kernel",
                 "fused_feasibility": "fused_feasibility_kernel",
                 "fused_feasibility_scored": "fused_feasibility_kernel",
                 "fused_carry": "fused_carry_kernel",
                 "strategy_score": "score_kernel"}
#: a split's stage-A kernels, in either tree: launch counter -> symbols
#: (K3 is the water-fill over flat columns, ``Elems``; K10 is over the
#: shard table, ``ShardElems``)
STAGE_A_KERNELS = {"seg_sum": ("seg_sum_kernel",),
                   "seg_fold": ("seg_clamp_kernel",),
                   "shard_seg_sum": ("seg_sum_kernel",),
                   "waterfill": ("::Elems>", "<Elems>")}


def _launch_deltas(K, fn):
    before = {k.name: k.launches for k in K.KERNELS}
    fn()
    return {k.name: k.launches - before[k.name] for k in K.KERNELS
            if k.launches != before[k.name]}


def k8_rows(torch, cs, K, dev):
    """K8 at nb 16384, G = 1 and chip_smoke.py's gang-fleet stack of
    G = 8, checked against the CPU's plain path first."""
    from swarmkit_tpu_torch.ops.convert import gang_to_device
    out = {}
    for label, seed, g_count in (("k8_g1", 41, 1), ("k8_g8", 508, 8)):
        rows = cs.gang_rows(seed, g_count=g_count)
        gnodes, ggroups = gang_to_device(rows, dev)

        def gang():
            return K.gang_fit_packed(gnodes, ggroups)

        got = K.unpack_gang(gang().cpu(), g_count)
        want = K.unpack_gang(K.gang_fit_packed(
            *gang_to_device(rows, "cpu")), g_count)
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{label}: K8 differs from its plain version")
        (dev_ms,) = cs.device_ms_each(torch, gang, (("gang_fit_kernel",),),
                                      label=label)
        out[label] = dict(ms=cs.time_ms(torch, gang, reps=20, warmup=3),
                          device_ms=dev_ms, clocks=_clocks())
    return out


def entry_rows(torch, cs, K, to_device, fused_to_device, dev):
    """K1 at the headline plan's shape and at nb 2^20, K8 at G = 1 and 8,
    and a cfg7 fused chunk, each checked against the CPU's plain path
    first."""
    out = {}
    for label, nb, n_valid in (("k1_headline", 16384, 10000),
                               ("k1_nb2p20", 1 << 20, 1000000)):
        nodes_np, group_np, _, _ = cs.plan_inputs(
            seed=2024, nb=nb, n_valid=n_valid, n_leaves=20,
            k=K.K_CLAMP - 1, near_2p24=True)
        nodes, group, _ = to_device(nodes_np, group_np, (), dev)

        def run():
            return K.feasibility_packed(nodes, group)

        got = K.unpack_feasibility(run(), nb)
        want = K._feasibility_plain(nodes, group)
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{label}: K1 differs from its plain version")
        launches = _launch_deltas(K, run)
        (dev_ms,) = cs.device_ms_each(
            torch, run, (("feasibility_kernel",),),
            per_call=[launches["feasibility"]], label=label)
        out[label] = dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                          device_ms=dev_ms, launches=launches,
                          clocks=_clocks())

    out.update(k8_rows(torch, cs, K, dev))

    inputs = cs.fused_inputs(seed=77)
    L, sids = inputs[4], inputs[3].sid.tolist()
    shared, groups, carry, strat = fused_to_device(*inputs[:4], device=dev)
    cpu_in = fused_to_device(*inputs[:4], device="cpu")
    first = K.plan_fused_packed(shared, groups, carry, L, strat, sids)
    cs.check(torch.equal(first.cpu(), K.plan_fused_packed(
        *cpu_in[:3], L, cpu_in[3], sids)), "the fused chunk on the card "
        "differs from the CPU plain path")
    n = shared.valid.shape[0]
    placed = first[:, :n].sum(dim=1).tolist()

    def chunk_on_fresh_carry():
        """A chunk planning on a carry of its own (at most
        CHUNK_CALLS_PER_CARRY calls keep it placing every task), and its
        last rows."""
        fresh = fused_to_device(*inputs[:4], device=dev)[2]
        last = []

        def run():
            last[:] = [K.plan_fused_packed(shared, groups, fresh, L, strat,
                                           sids)]
            return last[0]
        return run, last

    def still_full(last):
        got = last[0][:, :n].sum(dim=1).tolist()
        cs.check(got == placed, f"cfg7 chunk: the last timed chunk placed "
                 f"{got}, not {placed}: its carry ran dry")

    launches = _launch_deltas(K, chunk_on_fresh_carry()[0])
    entry = sum(launches.get(name, 0) for name in ENTRY_KERNELS)
    run, last = chunk_on_fresh_carry()
    all_ms, entry_ms = cs.device_ms_each(
        torch, run, (("",), tuple(set(ENTRY_KERNELS.values()))),
        reps=5, per_call=[0, entry], label="cfg7 chunk")
    still_full(last)
    run, last = chunk_on_fresh_carry()
    ms = cs.time_ms(torch, run, reps=10, warmup=2)
    still_full(last)
    out["cfg7_chunk"] = dict(ms=ms, device_ms=all_ms, entry_device_ms=entry_ms,
                             launches=launches, clocks=_clocks())
    for label, g in (("scored_slot_weighted", 2), ("scored_slot_learned", 3)):
        out[label] = scored_slot_row(torch, cs, K, fused_to_device, dev,
                                     inputs, g, label)
    return out


def scored_slot_row(torch, cs, K, fused_to_device, dev, inputs, g, label):
    """A chunk of slot ``g`` of the cfg7 chunk alone (K1F, the fill, K4's
    carry update), each call on a fresh carry, against the CPU: the
    wrapper time, every device op, and the slot entry's kernels."""
    shared, groups, carry, strat = inputs[:4]
    one = type(groups)(*(None if v is None else v[g:g + 1]
                         for v in groups))
    strat = strat._replace(sid=strat.sid[g:g + 1],
                           weights=strat.weights[g:g + 1])
    sids = strat.sid.tolist()
    card = fused_to_device(shared, one, carry, strat, device=dev)
    cpu = fused_to_device(shared, one, carry, strat, device="cpu")
    got = K.plan_fused_packed(*card[:3], inputs[4], card[3], sids)
    cs.check(torch.equal(got.cpu(), K.plan_fused_packed(
        *cpu[:3], inputs[4], cpu[3], sids)), f"{label}: the card differs "
        "from the CPU plain path")

    def run():
        fresh = fused_to_device(shared, one, carry, strat, device=dev)[2]
        return K.plan_fused_packed(card[0], card[1], fresh, inputs[4],
                                   card[3], sids)

    launches = _launch_deltas(K, run)
    entry = sum(launches.get(name, 0) for name in ENTRY_KERNELS
                if name != "fused_carry")
    all_ms, entry_ms = cs.device_ms_each(
        torch, run, (("",), ("fused_feasibility_kernel", "score_kernel")),
        reps=10, per_call=[0, entry], label=label)
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                device_ms=all_ms, entry_device_ms=entry_ms,
                entry_launches=entry, launches=launches, clocks=_clocks())


def stage_a_row(torch, cs, K, dev, shards=4):
    """The mesh headline's plan over ``shards`` shards of the card, against
    the unsharded plan on the CPU: the wrapper time, every device op, and
    its stage-A kernels (one level: the leaves, L = 256)."""
    import numpy as np
    from swarmkit_tpu_torch.ops.convert import to_device
    from swarmkit_tpu_torch.parallel import sharded as S
    nodes_np, group_np, L, hier_np = cs.plan_inputs(
        seed=2024, nb=16384, n_valid=10000, n_leaves=20, k=80000)
    parts = S.shard_group(nodes_np, group_np, hier_np,
                          S.make_mesh(["cuda:0"] * shards))

    def run():
        return K.plan_group_sharded_packed(parts, L)

    got = K.merge_shard_rows(torch.stack(run()).cpu().numpy(), 16384)
    cn, cg, ch = to_device(nodes_np, group_np, hier_np, "cpu")
    cs.check(np.array_equal(got, K.plan_group_packed(cn, cg, L, ch)
                            .numpy()), "stage A: the split differs from "
             "the unsharded plan")
    launches = _launch_deltas(K, run)
    names = [n for n in STAGE_A_KERNELS if launches.get(n)]
    stage = sum(launches[n] for n in names)
    symbols = tuple({sym for n in names for sym in STAGE_A_KERNELS[n]})
    all_ms, stage_ms = cs.device_ms_each(
        torch, run, (("",), symbols), reps=10, per_call=[0, stage],
        label="stage A")
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                device_ms=all_ms, stage_a_device_ms=stage_ms,
                stage_a_launches={n: launches[n] for n in names},
                launches=launches, by_kernel=by_kernel(torch, cs, run),
                clocks=_clocks())


def by_kernel(torch, cs, run, reps=10):
    """Device ms a call of ``run`` by device row name (its first 60
    characters), from one profiled session."""
    run()
    rows, _ = cs.profiled(torch, lambda: [run() for _ in range(reps)])
    out = {}
    for name, us in rows:
        out[name[:60]] = out.get(name[:60], 0.0) + us / reps / 1e3
    return out


def b13_row(torch, cs, K, dev, shards=4):
    """B13, a weighted group's plan over ``shards`` shards of the card
    (``chip_smoke.phase_mesh_compositions``' inputs), against the
    unsharded plan: the wrapper time, every device op, and the device ms
    by kernel."""
    import numpy as np
    from swarmkit_tpu_torch.ops.convert import to_device
    from swarmkit_tpu_torch.parallel import sharded as S
    from swarmkit_tpu_torch.scheduler import strategy as strategy_mod
    nb = 16384
    mesh = S.make_mesh(["cuda:0"] * shards)
    nodes_np, group_np, _, _ = cs.plan_inputs(
        seed=2027, nb=nb, n_valid=10000, n_leaves=1, k=80000,
        near_2p24=False)
    rng = np.random.RandomState(2027)
    w1, b1, w2, b2 = strategy_mod.learned_params()
    sin_np = K.StrategyInputs(
        hr_cpu=rng.randint(0, 1024, nb).astype(np.int32),
        hr_mem=rng.randint(0, 1024, nb).astype(np.int32),
        hr_gen=np.full(nb, 1023, np.int32),
        weights=np.array([2, 3, 1, 1], np.int32), w1=w1, b1=b1, w2=w2,
        b2=np.asarray(b2, np.int32))
    parts = [(nd, gd) for nd, gd, _ in
             S.shard_group(nodes_np, group_np, (), mesh)]
    sins = S.shard_to_device(sin_np, K.StrategyInputs, mesh.devices)

    def run():
        return K.plan_strategy_sharded_packed(parts, sins, K.STRAT_WEIGHTED)

    nodes, group, _ = to_device(nodes_np, group_np, (), dev)
    sin = K.StrategyInputs(*(torch.from_numpy(np.asarray(a)).to(dev)
                             for a in sin_np))
    want = K.plan_strategy_packed(nodes, group, sin, K.STRAT_WEIGHTED)
    got = K.merge_shard_rows(torch.stack(run()).cpu().numpy(), nb)
    cs.check(np.array_equal(got, want.cpu().numpy()), "B13 on the shards "
             "differs from the unsharded weighted plan")
    (all_ms,) = cs.device_ms_each(torch, run, (("",),), reps=10,
                                  label="B13")
    return dict(ms=cs.time_ms(torch, run, reps=20, warmup=3),
                device_ms=all_ms, launches=_launch_deltas(K, run),
                by_kernel=by_kernel(torch, cs, run), clocks=_clocks())


#: K8 in either tree at the gang fleet's bucket and the headline's:
#: (label, seed, node bucket, gangs)
GANG_AB_SHAPES = (("k8_nb1024_g1", 41, 1024, 1),
                  ("k8_nb1024_g2", 42, 1024, 2),
                  ("k8_nb4096_g1", 45, 4096, 1),
                  ("k8_nb8192_g1", 44, 8192, 1),
                  ("k8_nb16384_g2", 43, 16384, 2))


def gang_rows_ab(torch, cs, K, dev):
    """K8 at further shapes, and one verdict through the planner's
    ``_gang_fit_rows`` (whatever route the tree takes from numpy rows to
    the verdict): its wall time (host clock, 200 warm verdicts) and its
    device ops by kind from one profiled verdict."""
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.ops.convert import gang_to_device
    import time
    out = {}
    for label, seed, nb, g_count in GANG_AB_SHAPES:
        rows = cs.gang_rows(seed, g_count=g_count, nb=nb,
                            n_valid=10000 if nb == 16384 else nb * 3 // 4)
        gnodes, ggroups = gang_to_device(rows, dev)

        def gang():
            return K.gang_fit_packed(gnodes, ggroups)

        got = K.unpack_gang(gang().cpu(), g_count)
        want = K.unpack_gang(K.gang_fit_packed(
            *gang_to_device(rows, "cpu")), g_count)
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{label}: K8 differs from its plain version")
        (dev_ms,) = cs.device_ms_each(torch, gang, (("gang_fit_kernel",),),
                                      label=label)
        out[label] = dict(ms=cs.time_ms(torch, gang, reps=20, warmup=3),
                          device_ms=dev_ms, clocks=_clocks())
    planner = TorchPlanner()
    for label, nb, g_count in (("verdict_nb1024_g1", 1024, 1),
                               ("verdict_nb1024_g2", 1024, 2),
                               ("verdict_nb16384_g1", 16384, 1)):
        rows = cs.gang_rows(90 + g_count, g_count=g_count, nb=nb,
                            n_valid=10000 if nb == 16384 else nb * 3 // 4)

        def verdict(rows=rows, label=label):
            return planner._gang_fit_rows(rows, label)

        for _ in range(5):
            verdict()
        t0 = time.perf_counter()
        for _ in range(200):
            verdict()
        wall_ms = (time.perf_counter() - t0) / 200 * 1e3
        events, session = cs.profiled(torch, verdict)
        out[label] = dict(wall_ms=wall_ms,
                          device_ops=cs.verdict_ops(n for n, _ in events),
                          device_ms=sum(us for _, us in events) / 1e3,
                          missing=session["missing"])
    return out


def scatter_rows_ab(torch, cs, K, dev, shards_list=(1, 4)):
    """A refresh's scatter through the tree's streaming route at the
    staging buckets, unsplit and over four shards of the card (one staged
    buffer and ``scatter_rows`` over the shard table, or, in a tree that
    has them, ``parallel.sharded``'s per-shard ``put_scatter_updates`` +
    ``scatter_rows_sharded``): == the host's columns, K7 launches a
    refresh, device ms of every K7 row and the wrapper's ms (the stage
    fill, its H2D and the launches)."""
    import numpy as np
    from swarmkit_tpu_torch.parallel import sharded as S
    out = {}
    for d, db in ((13, 16), (200, 256), (3000, 4096)):
        cols_np, packed_np = cs.scatter_inputs(31 + db, d=d, db=db)
        idx = K.scatter_views(packed_np, db)[0]
        rows = sorted(int(i) for i in idx[:d])
        for shards in shards_list:
            host = tuple(c.copy() for c in cols_np)
            for c in host:   # the values the refresh must write
                c[rows] = c[rows][::-1]
            mesh = S.make_mesh(["cuda:0"] * shards)
            dev_cols = S.put_resident(cols_np, mesh)
            if shards == 1:
                dev_cols = tuple(c[0] for c in dev_cols)
            stages = {}

            def refresh(dev_cols=dev_cols, mesh=mesh, stages=stages,
                        shards=shards, host=host):
                if shards > 1 and hasattr(S, "put_scatter_updates"):
                    # a tree whose split stages and scatters per shard
                    packed, _ = S.put_scatter_updates(rows, host, mesh,
                                                      stages, db)
                    S.scatter_rows_sharded(dev_cols, packed)
                    return
                stage = stages.get(db)
                if stage is None:
                    from swarmkit_tpu_torch.ops.streaming import (
                        _ScatterStage)
                    stage = stages[db] = _ScatterStage(db, dev)
                stage.fill(rows, host[0].shape[0], host)
                K.scatter_rows(dev_cols, stage.upload())

            refresh()
            torch.cuda.synchronize()
            cols = dev_cols if shards > 1 else tuple((c,) for c in dev_cols)
            cs.check(all(np.array_equal(torch.cat(c).cpu().numpy(), h)
                         for c, h in zip(cols, host)),
                     f"scatter db={db} x{shards}: columns differ from the "
                     "host's")
            launches = _launch_deltas(K, refresh)["scatter_rows"]
            (dev_ms,) = cs.device_ms_each(
                torch, refresh, (("scatter_rows_kernel",),),
                per_call=[launches], label=f"K7 db={db} x{shards}")
            out[f"k7_db{db}_x{shards}"] = dict(
                ms=cs.time_ms(torch, refresh, reps=20, warmup=3),
                device_ms=dev_ms, launches_per_refresh=launches,
                clocks=_clocks())
    return out


def tick_rows(torch, cs, churn=True):
    """The end-to-end ticks this slice could move, in the tree under
    test: the gang fleet's tick on the card (twice; the second warm) and
    on the host path, and the churn's tick median (config 10 with its
    burst window), streaming unsplit and over four shards of the card."""
    import statistics
    import time
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.parallel import make_mesh
    from swarmkit_tpu_torch.scheduler import Scheduler
    out = {}
    for label in ("gang_card", "gang_card_warm", "gang_host"):
        planner = None if label == "gang_host" else TorchPlanner()
        store, _, _, _ = workload.gang_fleet()
        sched = Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        t0 = time.perf_counter()
        decisions = sched.tick()
        torch.cuda.synchronize()
        out[label] = dict(tick_s=time.perf_counter() - t0,
                          decisions=decisions)
    for label, shards in ((("churn", 0), ("churn_mesh", cs.MESH_SHARDS))
                          if churn else ()):
        wl = workload.steady_state_churn()
        wl.script.append(cs.CHURN_BURST)
        planner = TorchPlanner(mesh=make_mesh(["cuda:0"] * shards)
                               if shards else None)
        sched = wl.attach(planner)
        sched.tick()
        torch.cuda.synchronize()
        ticks = []
        for arrivals, exits in wl.script:
            wl.feed(arrivals, exits)
            t1 = time.perf_counter()
            sched.tick()
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t1)
        wl.close()
        out[label] = dict(tick_ms_median=statistics.median(ticks) * 1e3,
                          tick_ms=[t * 1e3 for t in ticks])
    return out


def measure(tree, part="all"):
    """One tree's numbers (run in a process of its own): ``part`` "all",
    "fills" (the fills alone) or "gang" (K8, the verdicts and the gang
    fleet's ticks alone)."""
    tree = os.path.realpath(tree)
    sys.path.insert(0, tree)
    import torch

    cs = _tools()
    from swarmkit_tpu_torch.ops import cuda
    from swarmkit_tpu_torch.ops import kernel as K
    from swarmkit_tpu_torch.ops.convert import fused_to_device, to_device
    cs.check(os.path.realpath(cuda.__file__).startswith(tree),
             f"imported {cuda.__file__}, not the tree {tree}")
    cs.check(torch.cuda.is_available(), "no CUDA device")
    build = cuda.build()
    cuda.library()
    dev = torch.device("cuda")
    out = dict(tree=tree, build_s=build.seconds, card=cs.card_uuid(torch))
    if part == "gang":
        out["entry"] = k8_rows(torch, cs, K, dev)
        out["gang"] = gang_rows_ab(torch, cs, K, dev)
        out["ticks"] = tick_rows(torch, cs, churn=False)
        return out
    if part == "all":
        out["entry"] = entry_rows(torch, cs, K, to_device, fused_to_device,
                                  dev)
        out["stage_a_d4"] = stage_a_row(torch, cs, K, dev)
        out["b13_weighted_d4"] = b13_row(torch, cs, K, dev)
        out.update(_k9_rows(torch, cs, dev))
        out["gang"] = gang_rows_ab(torch, cs, K, dev)
        out["scatter"] = scatter_rows_ab(torch, cs, K, dev)
        out["ticks"] = tick_rows(torch, cs)
    out["fills"] = fill_rows(torch, cs, K, fused_to_device, dev)
    return out


def _k9_rows(torch, cs, dev):
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner
    from swarmkit_tpu_torch.ops import preempt as P
    from swarmkit_tpu_torch.ops.convert import victims_to_device
    from swarmkit_tpu_torch.ops.densify import n_bucket
    out = {}
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
    return out


def main():
    parts = {"--one": "all", "--fills": "fills", "--one-gang": "gang"}
    if len(sys.argv) == 3 and sys.argv[1] in parts:
        print(json.dumps(measure(sys.argv[2], parts[sys.argv[1]])),
              flush=True)
        return
    gang = len(sys.argv) == 4 and sys.argv[1] == "--gang"
    if len(sys.argv) != 3 and not gang:
        sys.exit(__doc__)
    old, new = sys.argv[-2:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        proc = subprocess.run([sys.executable, HERE,
                               "--one-gang" if gang else "--one", tree],
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
