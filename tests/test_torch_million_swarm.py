"""Config 13 on the CPU, at 64 sessions.

``workload.million_swarm`` (bench.py's ``run_million_swarm``: real
dispatcher sessions over one threadless ``Dispatcher`` with the batched
fan-out, one tick, the fan-out, and the status write-back storm shed at
the bounded admission edge until every replica is RUNNING) through
``TorchPlanner(device="cpu")``, against ``bench.run_million_swarm`` over
the reference's ``TPUPlanner`` (router off) with its ``BENCH_CFG13_*``
variables set to the same shape: 64 sessions, 10 services of 640
replicas (ten a node, so the spread breaks no tie), a pending cap of
1,024 and report batches of 64, each package with its own id counter.
By creation index the same node for every replica, and the same shed
ledger, write-back rounds, fan-out messages and changes, exactly; the
host path (``planner_factory=lambda: None``) gives the same per-(service,
node) counts.
"""

import importlib
import itertools
from collections import Counter

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch import workload  # noqa: E402
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402

from test_torch_dispatcher import (  # noqa: E402,F401  (the fixture)
    singletons_left_as_found,
)

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
SHAPE = dict(n_agents=64, n_replicas=6400, n_services=10, pending_cap=1024,
             report_batch=64)
#: the fields both runs report that must agree exactly
SAME = ("agents", "replicas", "services", "sessions", "decisions",
        "fanout_messages", "fanout_changes", "fanout_compactions",
        "writeback_rounds", "peak_update_depth", "heartbeats", "sheds",
        "hb_stretch_factor", "premature_expirations", "expirations")


@pytest.fixture
def id_counters():
    """One id counter a package, from the same start."""
    ids = [importlib.import_module(f"{name}.utils.identity")
           for name in (REF, PORT)]
    for mod in ids:
        n = itertools.count()
        mod.set_id_source(lambda n=n: f"id{next(n):08d}")
    yield
    for mod in ids:
        mod.set_id_source(None)


def reference_run(monkeypatch):
    """``bench.run_million_swarm`` at ``SHAPE`` over ``TPUPlanner`` with
    the router off; returns its record and each replica's hostname in
    creation order (read from the store its last ``build_cluster`` made)."""
    import bench
    from swarmkit_tpu.models import Task as RefTask
    from swarmkit_tpu.ops import TPUPlanner

    for key, name in (("n_agents", "AGENTS"), ("n_replicas", "REPLICAS"),
                      ("n_services", "SERVICES"),
                      ("pending_cap", "PENDING_CAP"),
                      ("report_batch", "REPORT_BATCH")):
        monkeypatch.setenv(f"BENCH_CFG13_{name}", str(SHAPE[key]))
    built = []
    build = bench.build_cluster

    def capture(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    monkeypatch.setattr(bench, "build_cluster", capture)

    def planner():
        p = TPUPlanner()
        p.enable_small_group_routing = False
        return p

    rec = bench.run_million_swarm(planner)
    store, _, nodes, tasks = built[-1]
    host = {n.id: n.description.hostname for n in nodes}
    final = {t.id: t.node_id for t in store.view(lambda tx: tx.find(RefTask))}
    return rec, [host.get(final[t.id]) for t in tasks]


def per_service_node(placements):
    per = SHAPE["n_replicas"] // SHAPE["n_services"]
    return Counter((i // per, host) for i, host in enumerate(placements))


def test_million_swarm_matches_reference(monkeypatch, id_counters):
    port = workload.million_swarm(lambda: TorchPlanner(device="cpu"),
                                  **SHAPE)
    ref, ref_placements = reference_run(monkeypatch)
    assert port["placements"] == ref_placements
    for key in SAME:
        assert port[key] == ref[key], key
    assert port["sheds"]["dispatcher"] > 0
    assert port["sheds"]["uncounted"] == port["sheds"]["unrecovered"] == 0
    assert port["time_to_running"]["running"] == SHAPE["n_replicas"]
    assert port["planner_stats"]["groups_fused"] == SHAPE["n_services"]
    assert not any(port["compiles"].values()) and port["build_s"] == 0.0
    counts = per_service_node(port["placements"])
    assert set(counts.values()) == {10}


def test_million_swarm_host_path_matches_device_path():
    """The scheduler's host route places the same replicas per (service,
    node) and runs the same write-back as the port's planner."""
    dev = workload.million_swarm(lambda: TorchPlanner(device="cpu"),
                                 **SHAPE)
    host = workload.million_swarm(lambda: None, **SHAPE)
    assert per_service_node(dev["placements"]) \
        == per_service_node(host["placements"])
    for key in ("sheds", "writeback_rounds", "fanout_messages",
                "fanout_changes"):
        assert dev[key] == host[key], key
