"""The slice as a whole on the CPU, at small widths.

- ``workload.live_manager`` (bench.py's ``run_live_manager``: one
  pipelined tick through a single-voter ``RaftNode`` with a sealed WAL
  and the live manager's subscribers) on 256 nodes x 2 services x 4,096
  tasks through ``TorchPlanner(device="cpu")``, against the reference's
  tick through its own ``RaftNode`` with ``TPUPlanner`` on the same
  cluster: equal placements by creation index, the same raft entries
  applied, both services fused; the WAL replayed into a fresh store
  rebuilds the store byte for byte; the nil proposer places alike.
- ``chip_smoke.py``'s phase 25 script (three raft members, services made
  through the leader's ``ControlAPI``, a failover, a leader deposed
  inside a pipelined tick, a restart from WALs and snapshots) at 40 nodes
  through the port's CPU planner, against the same script on the host
  path: equal live tasks per (service, node) after the create, the
  successor's scale-up and the restart's new service.
"""

import os

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

import chip_smoke as cs  # noqa: E402
from swarmkit_tpu_torch import workload  # noqa: E402
from swarmkit_tpu_torch.models import Task  # noqa: E402
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402
from swarmkit_tpu_torch.utils import identity  # noqa: E402

NODES, TASKS = 256, 8192
#: phase 25's script at 40 nodes (two a rack, so the spread's loads stay
#: tie-free): raft entries between snapshots cut so a snapshot is taken,
#: and a fence of three services of 200 tasks
CONTROL_SMALL = dict(cs.CONTROL, n_nodes=40, snapshot_interval=8,
                     fence_tasks=200)


@pytest.fixture(autouse=True)
def registries_left_as_found():
    """Each test leaves both packages' metrics gauges and timers as it
    found them: later tests in the same process read them (the
    reference's health plane).  Counters only grow and are read as
    deltas."""
    import importlib
    regs = [importlib.import_module(f"{name}.utils.metrics").registry
            for name in ("swarmkit_tpu", "swarmkit_tpu_torch")]
    saved = [(dict(r.gauges), {k: (list(t._buf), t._i, t.count, t.total)
                               for k, t in r.timers.items()})
             for r in regs]
    yield
    for r, (gauges, timers) in zip(regs, saved):
        r.gauges.clear()
        r.gauges.update(gauges)
        for name, t in r.timers.items():
            t.reset()
            if name in timers:
                t._buf, t._i, t.count, t.total = timers[name]


def reference_live_tick(tmp_path):
    """bench.py's live-manager tick on the reference: its ``build_cluster``
    of config 6's shape, a single-voter ``RaftNode`` with a sealed WAL
    under the store, ``one_tick`` over ``TPUPlanner`` (router off).
    Returns (placements in creation order, entries applied)."""
    import time

    import bench
    from swarmkit_tpu.models import Task as RefTask
    from swarmkit_tpu.ops import TPUPlanner
    from swarmkit_tpu.state.raft import (
        KeyEncoder, LocalNetwork, RaftLogger, RaftNode,
    )

    store, _, nodes, tasks = bench.build_cluster(NODES, TASKS, n_services=2)
    rn = RaftNode("b0", ["b0"], store,
                  RaftLogger(str(tmp_path / "ref" / "b0"),
                             encoder=KeyEncoder(workload.LIVE_WAL_KEY)),
                  LocalNetwork())
    store._proposer = rn
    rn.start()
    try:
        deadline = time.time() + 15
        while not (rn.is_leader and rn.core.leader_ready):
            assert time.time() < deadline, "reference raft leader not ready"
            time.sleep(0.01)
        planner = TPUPlanner()
        planner.enable_small_group_routing = False
        _, n_dec, _ = bench.one_tick(store, planner)
        assert n_dec == TASKS
        applied = rn.stats["applied"]
    finally:
        rn.stop()
    return cs.placements(store, RefTask, tasks, nodes), applied


def test_live_manager_matches_reference(tmp_path):
    from swarmkit_tpu_torch.state import MemoryStore, serde
    from swarmkit_tpu_torch.state.raft import (
        KeyEncoder, LocalNetwork, RaftLogger, RaftNode,
    )

    store, _, nodes, tasks = workload.live_cluster(NODES, TASKS)
    built = store.save_bytes()
    wal = str(tmp_path / "port")
    out = workload.live_manager(store, TorchPlanner(device="cpu"),
                                nodes=nodes, wal_dir=wal)
    assert out["decisions"] == TASKS and out["groups_fused"] == 2
    assert out["pipeline_depth"] >= 2
    assert out["native_commit"]["fallbacks"] == 0
    port = cs.placements(store, Task, tasks, nodes)
    ref, ref_applied = reference_live_tick(tmp_path)
    assert port == ref
    assert out["raft_entries_applied"] == ref_applied

    # the store the tick started from, with the WAL replayed on it
    # (unsealed with the same key), is the store the tick left
    replayed = MemoryStore()
    replayed.restore_bytes(built)
    rn = RaftNode("b0", ["b0"], replayed,
                  RaftLogger(os.path.join(wal, "b0"),
                             encoder=KeyEncoder(workload.LIVE_WAL_KEY)),
                  LocalNetwork())
    rn.logger.close()
    assert replayed.save_bytes() == store.save_bytes()
    entries, blocks = cs.wal_entries(os.path.join(wal, "b0"), serde)
    assert blocks >= 1 and out["wal_bytes"] < 200 * TASKS

    nil_store, _, nil_nodes, nil_tasks = workload.live_cluster(NODES, TASKS)
    nil = workload.live_manager(nil_store, TorchPlanner(device="cpu"),
                                proposer=None, nodes=nil_nodes)
    assert nil["raft_entries_applied"] == 0 and nil["wal_bytes"] == 0
    assert cs.placements(nil_store, Task, nil_tasks, nil_nodes) == port


def test_replicated_control_cpu_matches_host_path():
    card = cs.run_control(workload, identity,
                          lambda: TorchPlanner(device="cpu"), CONTROL_SMALL)
    host = cs.run_control(workload, identity, lambda: None, CONTROL_SMALL,
                          fence=False)
    for stage in cs.CONTROL_STAGES:
        assert cs.control_counts(card["rows"][stage]) == \
            cs.control_counts(host["rows"][stage]), stage
    n = CONTROL_SMALL["n_nodes"]
    rows = card["rows"]
    assert len(rows["create"]) == (CONTROL_SMALL["web"] + 1) * n
    assert len(rows["scale"]) == (CONTROL_SMALL["scaled"] + 1) * n
    assert len(rows["restart"]) == \
        (CONTROL_SMALL["scaled"] + CONTROL_SMALL["batch"] + 1) * n
    assert all(state == 512 for _, state in rows["restart"].values())
    fence = card["fence"]
    assert 0 < fence["first_chunk"] < 3 * CONTROL_SMALL["fence_tasks"]
    assert all(card["snapshots"].values())
    watch = card["checks"]["watch"]
    assert watch["resumed"] == watch["events"] - watch["events"] // 2 - 1
