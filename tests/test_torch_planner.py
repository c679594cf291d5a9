"""The port's scheduler slice end to end on the CPU, against the reference.

Each case builds the same small cluster twice: once with the reference's
models, store, scheduler and ``TPUPlanner`` (on JAX's CPU backend, small
group routing off), once with the port's own copies and
``TorchPlanner(device="cpu")`` (the kernels' plain PyTorch versions).  Ids
are minted per build, so placements are compared by task creation index ->
node hostname; they must be identical, as must the tasks' error strings.
"""

import importlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"


# ---------------------------------------------------------------- builders

def _mods(pkg):
    return (importlib.import_module(f"{pkg}.models"),
            importlib.import_module(f"{pkg}.models.types"),
            importlib.import_module(f"{pkg}.state"),
            importlib.import_module(f"{pkg}.scheduler"),
            importlib.import_module(f"{pkg}.utils"))


def build(pkg, spec):
    """A store holding ``spec``'s nodes, service and tasks, built from
    package ``pkg``'s own models."""
    M, T, S, _, U = _mods(pkg)
    nodes = []
    for nd in spec["nodes"]:
        node = M.Node(
            id=U.new_id(),
            spec=M.NodeSpec(annotations=M.Annotations(name=nd["name"]),
                            availability=(M.NodeAvailability.DRAIN
                                          if nd.get("drain")
                                          else M.NodeAvailability.ACTIVE)),
            status=M.NodeStatus(state=(M.NodeState.DOWN if nd.get("down")
                                       else M.NodeState.READY)),
            description=M.NodeDescription(
                hostname=nd["name"],
                platform=M.Platform(architecture=nd.get("arch", "amd64"),
                                    os=nd.get("os", "linux")),
                resources=M.Resources(nano_cpus=nd.get("cpus", 4) * 10**9,
                                      memory_bytes=32 << 30),
                engine=M.EngineDescription(labels={})))
        node.spec.annotations.labels.update(nd.get("labels", {}))
        nodes.append(node)
    n_tasks = spec["tasks"]
    svc = M.Service(
        id=U.new_id(),
        spec=M.ServiceSpec(annotations=M.Annotations(name="svc"),
                           mode=M.ServiceMode.REPLICATED,
                           replicated=M.ReplicatedService(replicas=n_tasks)),
        spec_version=M.Version(index=1))
    placement = M.Placement(
        constraints=list(spec.get("constraints", [])),
        preferences=[M.PlacementPreference(spread=M.SpreadOver(
            spread_descriptor=d)) for d in spec.get("spread", [])],
        platforms=[M.Platform(**p) for p in spec.get("platforms", [])],
        max_replicas=spec.get("max_replicas", 0),
        strategy=spec.get("strategy", "spread"),
        strategy_weights=dict(spec.get("strategy_weights", {})))
    cpus = spec.get("task_cpus")
    reservations = M.Resources(nano_cpus=int(cpus * 10**9)) \
        if cpus else None
    ports = []
    if spec.get("host_port"):
        ports = [M.PortConfig(protocol=T.PortProtocol.TCP, target_port=80,
                              published_port=spec["host_port"],
                              publish_mode=M.PublishMode.HOST)]
    by_name = {n.spec.annotations.name: n for n in nodes}
    preassign = spec.get("preassign", [])
    tasks = []
    for slot in range(1, n_tasks + 1):
        t = M.Task(
            id=U.new_id(), service_id=svc.id, slot=slot,
            desired_state=M.TaskState.RUNNING,
            spec=M.TaskSpec(placement=placement,
                            resources=M.ResourceRequirements(
                                reservations=reservations)),
            spec_version=M.Version(index=1),
            status=M.TaskStatus(state=M.TaskState.PENDING))
        if ports:
            t.endpoint = M.Endpoint(spec=M.EndpointSpec(ports=list(ports)),
                                    ports=list(ports))
        if slot <= len(preassign):
            t.slot = 0
            t.node_id = by_name[preassign[slot - 1]].id
        tasks.append(t)
    store = S.MemoryStore()

    def setup(tx):
        for n in nodes:
            tx.create(n)
        tx.create(svc)
        for t in tasks:
            tx.create(t)

    store.update(setup)
    return store, svc, nodes, tasks


def run(pkg, spec, planner):
    """One production tick sequence; returns (hostname of each ASSIGNED
    task by creation index -- None where not assigned --, error strings by
    creation index, scheduler)."""
    M, _, S, Sched, _ = _mods(pkg)
    store, svc, nodes, tasks = build(pkg, spec)
    sched = Sched.Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    sched._process_preassigned_tasks()
    sched.tick()
    host = {n.id: n.description.hostname for n in nodes}
    got = {t.id: t for t in store.view(
        lambda tx: tx.find(M.Task, S.ByService(svc.id)))}
    placed = [host.get(got[t.id].node_id)
              if got[t.id].status.state == M.TaskState.ASSIGNED else None
              for t in tasks]
    errs = [got[t.id].status.err for t in tasks]
    return placed, errs, sched


def ref_planner():
    from swarmkit_tpu.ops import TPUPlanner
    p = TPUPlanner()
    p.enable_small_group_routing = False   # every group on the kernel
    return p


def port_planner():
    from swarmkit_tpu_torch.ops import TorchPlanner
    return TorchPlanner(device="cpu")


# ------------------------------------------------------------------- cases

def _nodes(names, **kw):
    return [dict(name=n, **kw) for n in names]


def fuzz_spec(seed):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(int(rng.randint(8, 30))):
        nodes.append(dict(
            name=f"n{i:02d}", cpus=int(rng.randint(1, 12)),
            labels={"tier": str(rng.choice(["web", "db"])),
                    "rack": f"r{rng.randint(0, 4)}",
                    "dc": f"d{rng.randint(0, 2)}"},
            os="linux" if rng.rand() < 0.85 else "windows",
            drain=bool(rng.rand() < 0.1), down=bool(rng.rand() < 0.05)))
    spec = dict(nodes=nodes, tasks=int(rng.randint(5, 60)),
                task_cpus=float(rng.choice([0, 0.5, 1, 2])))
    if rng.rand() < 0.5:
        spec["constraints"] = ["node.labels.tier==web"]
    if rng.rand() < 0.6:
        spec["spread"] = (["node.labels.dc", "node.labels.rack"]
                          if rng.rand() < 0.5 else ["node.labels.rack"])
    if rng.rand() < 0.3:
        spec["max_replicas"] = int(rng.randint(1, 4))
    if rng.rand() < 0.3:
        spec["platforms"] = [dict(os="linux")]
    return spec


CASES = {
    "spread": dict(nodes=_nodes([f"n{i}" for i in range(5)]), tasks=10),
    "uniform": dict(nodes=_nodes([f"n{i}" for i in range(7)]), tasks=23),
    "resources": dict(
        nodes=[dict(name="big", cpus=8), dict(name="small", cpus=1)],
        tasks=6, task_cpus=1),
    "resources_mixed": dict(
        nodes=[dict(name=f"n{i}", cpus=c)
               for i, c in enumerate([7, 13, 1, 4, 9, 2, 15, 6, 3])],
        tasks=30, task_cpus=2),
    "constraints": dict(
        nodes=[dict(name="ssd1", labels={"disk": "ssd"}),
               dict(name="ssd2", labels={"disk": "ssd"}),
               dict(name="hdd1", labels={"disk": "hdd"})],
        tasks=4, constraints=["node.labels.disk==ssd"]),
    "not_constraint": dict(
        nodes=[dict(name="a", labels={"zone": "1"}),
               dict(name="b", labels={"zone": "2"})],
        tasks=2, constraints=["node.labels.zone != 1"]),
    "platform": dict(
        nodes=[dict(name="lin", os="linux"), dict(name="win", os="windows")],
        tasks=2, platforms=[dict(architecture="x86_64", os="linux")]),
    "max_replicas": dict(nodes=_nodes(["n0", "n1", "n2"]), tasks=9,
                         max_replicas=2),
    "host_ports": dict(nodes=_nodes(["n0", "n1", "n2"]), tasks=5,
                       host_port=8080),
    "drained_and_down": dict(
        nodes=[dict(name="ok"), dict(name="drained", drain=True),
               dict(name="down", down=True)], tasks=3),
    "one_level_spread": dict(
        nodes=[dict(name=f"{dc}{i}", labels={"dc": dc})
               for dc in ("east", "west", "north") for i in range(2)],
        tasks=9, spread=["node.labels.dc"]),
    "one_level_spread_uneven": dict(
        nodes=[dict(name=f"n{i}", labels={"rack": f"r{i % 3}"})
               for i in range(10)],
        tasks=12, spread=["node.labels.rack"]),
    "two_level_spread": dict(
        nodes=[dict(name=f"{dc}-r{r}-{i}",
                    labels={"dc": dc, "rack": f"{dc}-r{r}"})
               for dc in ("east", "west") for r in range(3)
               for i in range(2)],
        tasks=24, spread=["node.labels.dc", "node.labels.rack"]),
    "two_level_unbalanced": dict(
        nodes=[dict(name="solo", labels={"dc": "a", "rack": "a-r0"})]
        + [dict(name=f"b{i}", labels={"dc": "b", "rack": f"b-r{i}"})
           for i in range(3)],
        tasks=8, spread=["node.labels.dc", "node.labels.rack"]),
    "preassigned": dict(
        nodes=[dict(name="big", cpus=2), dict(name="small", cpus=1),
               dict(name="down", cpus=8, down=True)],
        tasks=6, task_cpus=1,
        preassign=["big", "big", "big", "small", "small", "down"]),
    "no_suitable_node": dict(nodes=[dict(name="tiny", cpus=1)], tasks=1,
                             task_cpus=64),
    # the per-group strategy route: K1, then K5 (binpack) or K6 + K3
    # (weighted, learned) against the reference's strategy kernels
    **{f"strategy_{name}": dict(
        nodes=[dict(name=f"n{i}", cpus=4 + (i % 5) * 4,
                    labels={"rack": f"r{i % 3}"}) for i in range(10)],
        tasks=30, task_cpus=1, strategy=name,
        strategy_weights={"cpu": 3, "spread": 1})
       for name in ("binpack", "weighted", "learned")},
    "fuzz_1": fuzz_spec(1),
    "fuzz_2": fuzz_spec(2),
    "fuzz_3": fuzz_spec(3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_placements_match_reference_planner(case):
    spec = CASES[case]
    ref_placed, ref_errs, _ = run(REF, spec, ref_planner())
    placed, errs, sched = run(PORT, spec, port_planner())
    assert placed == ref_placed
    assert errs == ref_errs
    stats = sched.batch_planner.stats
    if spec.get("strategy", "spread") != "spread":
        assert all(placed)
        # the strategy kernels planned the group on the device
        assert stats["groups_planned"] == 1, stats
        assert stats.get("groups_strategy_host", 0) == 0, stats
    elif not spec.get("preassign"):
        # the device path must at least have attempted the group; a spill
        # to the host is a legitimate outcome, then both sides ran the host
        assert stats["groups_planned"] >= 1 \
            or stats.get("groups_spill_to_host", 0) >= 1, stats
    assert stats.get("groups_device_error", 0) == 0


def test_planner_places_every_task_on_device():
    placed, _, sched = run(PORT, CASES["spread"], port_planner())
    assert sorted(placed.count(h) for h in set(placed)) == [2] * 5
    assert sched.batch_planner.stats["tasks_planned"] == 10


def test_preassigned_validated_by_feasibility_kernel():
    spec = CASES["preassigned"]
    placed, _, sched = run(PORT, spec, port_planner())
    host_placed, _, _ = run(PORT, spec, None)
    assert placed == host_placed
    assert sum(p is not None for p in placed) == 3
    assert sched.batch_planner.stats["tasks_planned"] >= 1


def test_no_suitable_node_explanation():
    _, errs, _ = run(PORT, CASES["no_suitable_node"], port_planner())
    assert errs == ["no suitable node (insufficient resources on 1 node)"]


@pytest.mark.parametrize("strategy", ["binpack", "weighted", "learned"])
def test_non_spread_strategy_goes_to_device(strategy):
    """A binpack, weighted or learned group takes the per-group strategy
    route on the device (its spread preference ignored, as the reference
    ignores it) and places exactly as ``TPUPlanner``, by creation index."""
    spec = dict(
        nodes=[dict(name=f"n{i}", cpus=2 + 3 * (i % 4),
                    labels={"rack": f"r{i % 2}"}) for i in range(12)],
        tasks=25, task_cpus=1, strategy=strategy,
        strategy_weights={"spread": 2, "cpu": 3},
        spread=["node.labels.rack"])
    ref_placed, ref_errs, ref_sched = run(REF, spec, ref_planner())
    placed, errs, sched = run(PORT, spec, port_planner())
    assert placed == ref_placed
    assert errs == ref_errs
    assert ref_sched.batch_planner.stats["groups_planned"] == 1
    stats = sched.batch_planner.stats
    assert stats["groups_planned"] == 1, stats
    assert stats.get("groups_strategy_host", 0) == 0, stats
    assert stats["tasks_planned"] == sum(p is not None for p in placed)

    # the dispatch itself: a handle on the strategy route, fetched and
    # applied like a spread plan
    from swarmkit_tpu_torch.ops import TorchPlanner
    store, _, _, tasks = build(PORT, spec)
    Sched = _mods(PORT)[3]
    planner = TorchPlanner(device="cpu")
    sched = Sched.Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    group = {t.id: t for t in tasks[:4]}
    planner.begin_tick(sched)
    handle = planner.dispatch_group(sched, group, {})
    assert handle is not None and handle.route == "strategy"
    assert planner.fetch_group(handle) is True
    planner.end_tick()
    assert not group          # all four placed
