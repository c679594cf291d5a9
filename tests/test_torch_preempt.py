"""The port's victim selection on the CPU, against the reference.

Kernel level: ``select_victims`` / ``plan_victims`` (K9's plain version: the
reference's scan as a Python loop over tensors) against the reference's
``select_victims_jit`` / ``plan_victims`` and its Python oracle
``select_victims_host``, over the reference fuzz's buckets (and V = 64,
with and without the generic column) and named cases: a budget stop, an
infeasible first pick, all-negative free pools, dead slots inside a prefix
(``m`` != victims), and a stop that no later pick undoes.  Every pick is
an integer, so the tolerance is exact equality.

Planner level: ``TorchPlanner(device="cpu").select_victims`` gives
``TPUPlanner``'s picks, and the preemption pass leaves the same store rows
under ``TorchPlanner(device="cpu")``, ``TPUPlanner()`` and the host path on
the reference's scenarios and on a 64-node config 8.

The JAX signatures stay few: node bucket 1024 and, for the kernel, one
pick bucket of 16.
"""

import importlib
import random
from collections import Counter

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from chip_smoke import VICTIM_EDGE_CASES, victim_edge_inputs  # noqa: E402
from swarmkit_tpu.ops import fusedbatch as ref_fusedbatch  # noqa: E402
from swarmkit_tpu.ops import preempt as ref  # noqa: E402
from swarmkit_tpu_torch.ops import preempt as port  # noqa: E402
from swarmkit_tpu_torch.ops.convert import victims_to_device  # noqa: E402
from swarmkit_tpu_torch.scheduler import preempt as hp  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
CPU = 2 * 10 ** 9
GB = 1 << 30
NB = 1024
PB = 16


# ------------------------------------------------------------ kernel level

def random_candidates(rng, n, V, with_gen=False):
    """The reference fuzz's candidate draw (tests/test_preemption.py)."""
    kwargs = {}
    if with_gen:
        kwargs["free_gen"] = np.array(
            [rng.randrange(0, 4) for _ in range(n)], np.int64)
        kwargs["vgen"] = np.array(
            [[rng.randrange(0, 3) for _ in range(n)] for _ in range(V)],
            np.int64)
    return hp.CandidateSet(
        infos=None,
        ok=np.array([rng.random() < 0.8 for _ in range(n)]),
        free_cpu=np.array([rng.randrange(-4, 9) * 10 ** 9
                           for _ in range(n)], np.int64),
        free_mem=np.array([rng.randrange(0, 8) * GB for _ in range(n)],
                          np.int64),
        vvalid=np.array([[rng.random() < 0.6 for _ in range(n)]
                         for _ in range(V)]),
        vprio=np.array([[rng.randrange(0, 5) for _ in range(n)]
                        for _ in range(V)], np.int32),
        vcpu=np.array([[rng.randrange(0, 5) * 10 ** 9 for _ in range(n)]
                       for _ in range(V)], np.int64),
        vmem=np.array([[rng.randrange(0, 4) * GB for _ in range(n)]
                       for _ in range(V)], np.int64),
        victims=None, vb=V, n_candidates=1, **kwargs)


def reference_rows(cand, cpu_d, mem_d, gen_d, n_picks, budget, picks=PB):
    """The reference kernel's full (node, m) rows on the padded inputs."""
    inp = victims_to_device(cand, NB, "cpu")
    arrs = [t.numpy().copy() for t in inp]
    with ref_fusedbatch.x64():
        nodes, ms = jax.device_get(ref.select_victims_jit(
            *arrs, np.int64(cpu_d), np.int64(mem_d), np.int64(gen_d),
            np.int32(n_picks), np.int32(budget), picks))
    return np.asarray(nodes), np.asarray(ms)


def port_rows(cand, cpu_d, mem_d, gen_d, n_picks, budget, picks=PB):
    inp = victims_to_device(cand, NB, "cpu")
    nodes, ms = port.select_victims(inp, cpu_d, mem_d, gen_d, n_picks,
                                    budget, picks).view(2, -1)
    return nodes.numpy(), ms.numpy()


def check_all(cand, cpu_d, mem_d, gen_d, n_picks, budget):
    """Port == reference kernel (full rows) == host oracle (the picks);
    returns the picks."""
    got = port_rows(cand, cpu_d, mem_d, gen_d, n_picks, budget)
    want = reference_rows(cand, cpu_d, mem_d, gen_d, n_picks, budget)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    host = hp.select_victims_host(cand, cpu_d, mem_d, gen_d, n_picks,
                                  budget)
    picks, label = port.plan_victims(cand, cpu_d, mem_d, gen_d, n_picks,
                                     budget, "cpu")
    assert picks == host
    assert picks == [(int(j), int(m)) for j, m in zip(*got) if j >= 0]
    v = cand.vvalid.shape[0]
    assert label == f"preempt_nb{NB}_v{v}_p{port.pick_bucket(n_picks)}"
    return picks


FUZZ = [(7, 4, False), (40, 16, False), (17, 4, False), (11, 4, True),
        (23, 16, True), (29, 64, True), (13, 64, False)]


@pytest.mark.parametrize("n,V,with_gen", FUZZ)
def test_selection_matches_reference_and_host_oracle(n, V, with_gen):
    for seed in range(25):
        rng = random.Random(seed * 1000 + n * 7 + V)
        cand = random_candidates(rng, n, V, with_gen=with_gen)
        cpu_d = rng.randrange(1, 5) * 10 ** 9
        mem_d = rng.randrange(0, 3) * GB
        gen_d = rng.randrange(1, 4) if with_gen else 0
        budget = rng.randrange(1, 20)
        n_picks = min(rng.randrange(1, 12), budget)
        check_all(cand, cpu_d, mem_d, gen_d, n_picks, budget)


def test_reference_plan_victims_agrees():
    """The reference's own entry point, at its pick bucket of 16."""
    for seed in range(6):
        rng = random.Random(seed)
        cand = random_candidates(rng, 30, 16, with_gen=seed % 2 == 1)
        args = (3 * 10 ** 9, GB, seed % 2, 12, 40)
        want, label, _ = ref.plan_victims(cand, *args)
        got, got_label = port.plan_victims(cand, *args, "cpu")
        assert got == want
        assert got_label == label


def _cand(free_cpu, vvalid, vprio, vcpu, free_mem=None, vmem=None, ok=None):
    free_cpu = np.asarray(free_cpu, np.int64) * 10 ** 9
    n = free_cpu.shape[0]
    vvalid = np.asarray(vvalid, bool)
    return hp.CandidateSet(
        infos=None,
        ok=np.ones(n, bool) if ok is None else np.asarray(ok, bool),
        free_cpu=free_cpu,
        free_mem=np.full(n, 8 * GB, np.int64) if free_mem is None
        else np.asarray(free_mem, np.int64),
        vvalid=vvalid, vprio=np.asarray(vprio, np.int32),
        vcpu=np.asarray(vcpu, np.int64) * 10 ** 9,
        vmem=np.zeros(vvalid.shape, np.int64) if vmem is None
        else np.asarray(vmem, np.int64),
        victims=None, vb=vvalid.shape[0], n_candidates=1)


def test_budget_stop():
    # every node needs two 1-CPU victims per 2-CPU pick; a budget of 5
    # pays for two picks, the third stops the run
    cand = _cand([0, 0, 0], [[1, 1, 1]] * 4, [[0, 0, 0]] * 4,
                 [[1, 1, 1]] * 4)
    picks = check_all(cand, 2 * 10 ** 9, 0, 0, 6, 5)
    assert picks == [(0, 2), (0, 4)]


def test_budget_stop_is_final():
    # node 0's prefix is cheapest (cost 3, three victims); over a budget of
    # 2 it stops the run, though node 1's one costly victim would fit
    cand = _cand([0, 0], [[1, 1], [1, 0], [1, 0]], [[0, 4], [0, 0], [0, 0]],
                 [[1, 3], [1, 0], [1, 0]])
    assert check_all(cand, 3 * 10 ** 9, 0, 0, 4, 2) == []
    assert check_all(cand, 3 * 10 ** 9, 0, 0, 4, 3) == [(0, 3)]
    assert check_all(cand, 3 * 10 ** 9, 0, 0, 4, 4) == [(0, 3), (1, 1)]


def test_infeasible_first_pick():
    cand = _cand([1, 2, -1], [[1, 1, 1], [1, 0, 1]], [[0, 0, 0], [1, 0, 1]],
                 [[1, 1, 1], [1, 0, 1]])
    assert check_all(cand, 10 * 10 ** 9, 0, 0, 5, 50) == []
    # a node that is not ok is never picked, however cheap
    cand.ok[:] = False
    assert check_all(cand, 1, 0, 0, 5, 50) == []


def test_all_negative_free_pools():
    cand = _cand([-3, -1, -2], [[1, 1, 1]] * 4,
                 [[0, 1, 0], [0, 1, 0], [1, 1, 1], [2, 0, 0]],
                 [[1, 1, 2]] * 4,
                 free_mem=[-GB, -2 * GB, 0], vmem=[[GB, GB, GB]] * 4)
    picks = check_all(cand, 10 ** 9, 0, 0, 8, 100)
    assert len(picks) >= 2
    # the first pick must evict; a later one may ride an earlier surplus
    assert picks[0][1] > 0


def test_dead_slots_inside_a_prefix():
    # node 0's slots 0 and 2 are dead: m counts slots (4), not victims (2)
    cand = _cand([0, 0], [[0, 1], [1, 1], [0, 1], [1, 1]],
                 [[0, 3], [0, 3], [0, 3], [0, 3]], [[1, 1]] * 4)
    picks = check_all(cand, 2 * 10 ** 9, 0, 0, 2, 10)
    assert picks[0] == (0, 4)
    # a second pick on node 1 after node 0 ran dry
    assert picks[1][0] == 1


def test_used_slots_count_in_m():
    # the second pick on node 0 walks past the slots the first one used
    cand = _cand([0], [[1], [1], [1], [1]], [[0], [0], [0], [0]],
                 [[1], [1], [1], [1]])
    assert check_all(cand, 2 * 10 ** 9, 0, 0, 3, 10) == [(0, 2), (0, 4)]


def test_generic_column_decides():
    # cpu and memory are free everywhere; only the generic units bind
    cand = _cand([4, 4], [[1, 1], [1, 1]], [[0, 0], [2, 0]], [[0, 0]] * 2)
    cand.free_gen = np.array([0, 1], np.int64)
    cand.vgen = np.array([[1, 0], [1, 2]], np.int64)
    picks = check_all(cand, 10 ** 9, 0, 2, 3, 10)
    assert picks[0] == (1, 2)


EDGE_PICKS = {
    # the index decides among equal keys; a chosen node is then infeasible
    "equal_keys": [(j, 2) for j in range(PB)],
    # a surplus rides two free picks; a node picked again walks past its
    # used slots
    "repick": [(3, 1), (3, 0), (3, 0)] + [(5, m) for m in range(1, 14)],
    "budget_stop_v64": [(0, 2), (0, 4)],
    # m counts the dead slots before each prefix's live victims
    "infeasible_stop_v64": [(j, m) for j in (17, 300, 599)
                            for m in (21, 64)],
}


@pytest.mark.parametrize("case", VICTIM_EDGE_CASES)
def test_edge_cases_match_reference_and_host(case):
    """The cases the device's pick order turns on (equal keys, a node
    infeasible after its pick, a node picked again, budget and infeasible
    stops at V = 64, free pools below zero): plain version == reference
    kernel == host oracle."""
    cand, args = victim_edge_inputs(case, n=600, picks=PB)
    picks = check_all(cand, *args)
    if case in EDGE_PICKS:
        assert picks == EDGE_PICKS[case]
    else:
        assert len(picks) == PB and picks[0][1] > 0


def test_plain_version_on_a_tensor_of_another_device_raises():
    cand = _cand([0], [[1]], [[0]], [[1]])
    inp = victims_to_device(cand, NB, "cpu")
    meta = port.VictimInputs(*(t.to("meta") for t in inp))
    with pytest.raises(ValueError, match="unsupported device"):
        port.select_victims(meta, 1, 0, 0, 1, 1, 1)


def test_staging_buffers_are_reused_per_shape():
    stages = {}
    rng = random.Random(3)
    a = random_candidates(rng, 9, 4)
    b = random_candidates(rng, 12, 4)
    c = random_candidates(rng, 12, 16)
    for cand in (a, b, a, c):
        got, _ = port.plan_victims(cand, CPU, GB, 0, 4, 10, "cpu", stages)
        assert got == hp.select_victims_host(cand, CPU, GB, 0, 4, 10)
    assert sorted(k[1:] for k in stages) == [(NB, 4), (NB, 16)]


# ----------------------------------------------------------- planner level

def _mods(pkg):
    return (importlib.import_module(f"{pkg}.models"),
            importlib.import_module(f"{pkg}.state"),
            importlib.import_module(f"{pkg}.scheduler"))


def _now(pkg):
    return importlib.import_module(f"{pkg}.models.types").now()


def _planner(pkg, kind):
    if kind == "host":
        return None
    if pkg == REF:
        from swarmkit_tpu.ops import TPUPlanner
        p = TPUPlanner()
        p.enable_small_group_routing = False
        return p
    from swarmkit_tpu_torch.ops import TorchPlanner
    return TorchPlanner(device="cpu")


def test_planner_select_victims_matches_reference_planner():
    from swarmkit_tpu.ops import TPUPlanner
    from swarmkit_tpu_torch.ops import TorchPlanner
    ref_planner, planner = TPUPlanner(), TorchPlanner(device="cpu")
    for seed in range(4):
        rng = random.Random(100 + seed)
        cand = random_candidates(rng, 37, 16, with_gen=True)
        args = (2 * 10 ** 9, GB, 1, 10 + seed, 30)
        want = ref_planner.select_victims(cand, *args)
        got = planner.select_victims(cand, *args)
        assert want is not None
        assert got == want == hp.select_victims_host(cand, *args)


def bands_store(pkg, n_nodes, bands, node_cpu=4 * 10 ** 9):
    """The reference tests' ``_mk_store``: bands = [(service id, priority,
    pending, running)]; running tasks round-robin over the nodes."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    ts = _now(pkg)

    def mk(tx):
        for i in range(n_nodes):
            tx.create(M.Node(
                id=f"n{i:03d}",
                spec=M.NodeSpec(annotations=M.Annotations(name=f"n{i:03d}")),
                status=M.NodeStatus(state=M.NodeState.READY),
                description=M.NodeDescription(
                    hostname=f"n{i:03d}",
                    resources=M.Resources(nano_cpus=node_cpu,
                                          memory_bytes=16 * GB))))
        for sid, prio, n_pending, n_running in bands:
            spec = M.TaskSpec(
                priority=prio,
                resources=M.ResourceRequirements(reservations=M.Resources(
                    nano_cpus=CPU, memory_bytes=GB)))
            tx.create(M.Service(
                id=sid, spec=M.ServiceSpec(
                    annotations=M.Annotations(name=sid),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(
                        replicas=n_pending + n_running),
                    task=spec),
                spec_version=M.Version(index=1)))
            for s in range(n_running):
                tx.create(M.Task(
                    id=f"{sid}-r{s:03d}", service_id=sid, slot=s + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    node_id=f"n{s % n_nodes:03d}",
                    status=M.TaskStatus(state=M.TaskState.RUNNING,
                                        timestamp=ts)))
            for s in range(n_pending):
                tx.create(M.Task(
                    id=f"{sid}-p{s:03d}", service_id=sid,
                    slot=n_running + s + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING,
                                        timestamp=ts)))
    store.update(mk)
    return store


def one_off_store(pkg):
    """The reference's one-off scenario: a priority-8 and a priority-3
    task without a spec version (each its own group) and one priority-5
    victim on a one-slot node."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    ts = _now(pkg)

    def mk(tx):
        tx.create(M.Node(
            id="n0", spec=M.NodeSpec(annotations=M.Annotations(name="n0")),
            status=M.NodeStatus(state=M.NodeState.READY),
            description=M.NodeDescription(
                hostname="n0",
                resources=M.Resources(nano_cpus=CPU, memory_bytes=16 * GB))))
        res = M.ResourceRequirements(reservations=M.Resources(
            nano_cpus=CPU, memory_bytes=GB))
        specs = {sid: M.TaskSpec(priority=prio, resources=res)
                 for sid, prio in (("vic", 5), ("one-hi", 8), ("one-lo", 3))}
        for sid, spec in specs.items():
            tx.create(M.Service(
                id=sid, spec=M.ServiceSpec(
                    annotations=M.Annotations(name=sid),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=1), task=spec),
                spec_version=M.Version(index=1)))
        tx.create(M.Task(id="vic-r0", service_id="vic", slot=1,
                         desired_state=M.TaskState.RUNNING,
                         spec=specs["vic"], spec_version=M.Version(index=1),
                         node_id="n0",
                         status=M.TaskStatus(state=M.TaskState.RUNNING,
                                             timestamp=ts)))
        for sid in ("one-lo", "one-hi"):
            tx.create(M.Task(id=f"{sid}-p0", service_id=sid, slot=1,
                             desired_state=M.TaskState.RUNNING,
                             spec=specs[sid],
                             status=M.TaskStatus(state=M.TaskState.PENDING,
                                                 timestamp=ts)))
    store.update(mk)
    return store


def generic_store(pkg):
    """The reference's generic scenario: a priority-9 task demanding two
    discrete "gpu" units evicts the priority-0 holder of both."""
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    ts = _now(pkg)

    def gpu():
        return [M.GenericResource(kind="gpu", value=2,
                                  res_type=M.GenericResourceKind.DISCRETE)]

    def mk(tx):
        tx.create(M.Node(
            id="n0", spec=M.NodeSpec(annotations=M.Annotations(name="n0")),
            status=M.NodeStatus(state=M.NodeState.READY),
            description=M.NodeDescription(
                hostname="n0", resources=M.Resources(
                    nano_cpus=8 * 10 ** 9, memory_bytes=16 * GB,
                    generic=gpu()))))
        specs = {sid: M.TaskSpec(
            priority=prio, resources=M.ResourceRequirements(
                reservations=M.Resources(nano_cpus=CPU, generic=gpu())))
            for sid, prio in (("g-lo", 0), ("g-hi", 9))}
        for sid, spec in specs.items():
            tx.create(M.Service(
                id=sid, spec=M.ServiceSpec(
                    annotations=M.Annotations(name=sid),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=1), task=spec),
                spec_version=M.Version(index=1)))
        tx.create(M.Task(id="g-lo-r0", service_id="g-lo", slot=1,
                         desired_state=M.TaskState.RUNNING,
                         spec=specs["g-lo"], spec_version=M.Version(index=1),
                         node_id="n0",
                         status=M.TaskStatus(state=M.TaskState.RUNNING,
                                             timestamp=ts)))
        tx.create(M.Task(id="g-hi-p0", service_id="g-hi", slot=1,
                         desired_state=M.TaskState.RUNNING,
                         spec=specs["g-hi"], spec_version=M.Version(index=1),
                         status=M.TaskStatus(state=M.TaskState.PENDING,
                                             timestamp=ts)))
    store.update(mk)
    return store


SCENARIOS = {
    # (store builder, scheduler keyword arguments, expected preemptions)
    "evicts_strictly_lower": (
        lambda pkg: bands_store(pkg, 3, [("lo", 0, 0, 6), ("hi", 10, 2, 0)]),
        {}, 2),
    "never_equal_or_higher": (
        lambda pkg: bands_store(pkg, 3, [("res", 10, 0, 6),
                                         ("same", 10, 2, 0),
                                         ("below", 5, 2, 0)]), {}, 0),
    "budget_bound": (
        lambda pkg: bands_store(pkg, 4, [("lo", 0, 0, 8), ("hi", 10, 6, 0)]),
        {"preempt_budget": 3}, 3),
    "three_bands": (
        lambda pkg: bands_store(pkg, 3, [("lo", 0, 0, 6), ("mid", 3, 1, 0),
                                         ("hi", 10, 2, 0)]), {}, 3),
    "one_off_singletons": (one_off_store, {}, 1),
    "generic_demand": (generic_store, {}, 1),
}


def _rows(pkg, store):
    M, _, _ = _mods(pkg)
    return sorted(
        (t.id, t.node_id, int(t.status.state), int(t.desired_state),
         t.annotations.labels.get("swarm.preempted.by.prio"))
        for t in store.view(lambda tx: tx.find(M.Task)))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_preemption_pass_matches_reference_and_host(scenario):
    build, kw, preemptions = SCENARIOS[scenario]
    rows = {}
    for pkg, kind in ((PORT, "card"), (REF, "card"), (PORT, "host")):
        _, _, Sch = _mods(pkg)
        store = build(pkg)
        planner = _planner(pkg, kind)
        if planner is not None:
            calls = []
            orig = planner.select_victims

            def spy(*args, orig=orig, calls=calls):
                picks = orig(*args)
                calls.append(picks)
                return picks
            planner.select_victims = spy
        sched = Sch.Scheduler(store, batch_planner=planner, **kw)
        store.view(sched._setup_tasks_list)
        sched.tick()
        assert sched.stats["preemptions"] == preemptions, (pkg, kind)
        if planner is not None and preemptions:
            assert calls and all(p is not None for p in calls), (pkg, kind)
        rows[(pkg, kind)] = _rows(pkg, store)
    assert rows[(PORT, "card")] == rows[(REF, "card")]
    assert rows[(PORT, "card")] == rows[(PORT, "host")]


def config8_store(pkg, n_nodes):
    """bench.py's config 8 for either package, ids as
    ``workload.priority_jobs`` makes them."""
    from swarmkit_tpu_torch import workload
    M, S, _ = _mods(pkg)
    store = S.MemoryStore()
    res = M.ResourceRequirements(reservations=M.Resources(
        nano_cpus=CPU, memory_bytes=GB))

    def mk(tx):
        for i in range(n_nodes):
            tx.create(M.Node(
                id=f"p{i:05d}",
                spec=M.NodeSpec(annotations=M.Annotations(name=f"p{i:05d}")),
                status=M.NodeStatus(state=M.NodeState.READY),
                description=M.NodeDescription(
                    hostname=f"p{i:05d}",
                    resources=M.Resources(nano_cpus=8 * 10 ** 9,
                                          memory_bytes=32 * GB))))
        for name, prio, count in workload.PRIORITY_BANDS:
            spec = M.TaskSpec(resources=res, priority=prio)
            tx.create(M.Service(
                id=f"band-{name}", spec=M.ServiceSpec(
                    annotations=M.Annotations(name=f"band-{name}"),
                    mode=M.ServiceMode.REPLICATED,
                    replicated=M.ReplicatedService(replicas=count),
                    task=spec),
                spec_version=M.Version(index=1)))
        name, prio, count = workload.PRIORITY_JOB
        spec = M.TaskSpec(resources=res, priority=prio)
        tx.create(M.Service(
            id=f"band-{name}", spec=M.ServiceSpec(
                annotations=M.Annotations(name=f"band-{name}"),
                mode=M.ServiceMode.REPLICATED_JOB,
                replicated_job=M.ReplicatedJob(total_completions=count),
                task=spec),
            spec_version=M.Version(index=1)))

    def tasks(tx):
        for name, prio, count in workload.PRIORITY_BANDS:
            spec = tx.get(M.Service, f"band-{name}").spec.task
            for s in range(count):
                t = M.Task(id=f"{name}-{s:04d}", service_id=f"band-{name}",
                           slot=s + 1, desired_state=M.TaskState.RUNNING,
                           spec=spec, spec_version=M.Version(index=1),
                           status=M.TaskStatus(state=M.TaskState.PENDING))
                if prio == 0:
                    t.node_id = f"p{s % n_nodes:05d}"
                    t.status = M.TaskStatus(state=M.TaskState.RUNNING)
                tx.create(t)
        name, prio, count = workload.PRIORITY_JOB
        spec = tx.get(M.Service, f"band-{name}").spec.task
        for s in range(count):
            tx.create(M.Task(
                id=f"{name}-{s:04d}", service_id=f"band-{name}", slot=s,
                desired_state=M.TaskState.COMPLETE, spec=spec,
                spec_version=M.Version(index=1),
                job_iteration=M.Version(index=0),
                status=M.TaskStatus(state=M.TaskState.PENDING)))
    store.update(mk)
    store.update(tasks)
    return store


def _live_and_victims(pkg, store):
    """(tasks per (service, node) that are live, sorted victim ids)."""
    M, _, _ = _mods(pkg)
    tasks = store.view(lambda tx: tx.find(M.Task))
    live = Counter((t.service_id, t.node_id) for t in tasks
                   if t.node_id and t.desired_state <= M.TaskState.COMPLETE)
    victims = sorted(t.id for t in tasks
                     if "swarm.preempted.at" in t.annotations.labels)
    return live, victims


def test_config8_matches_reference_and_host():
    """64 nodes under bench.py's band counts: the resident band overfills
    every node (free pools near -50 CPUs, 28-29 victims a node: V = 64),
    and the budget of 512 stops the pass mid-group."""
    from swarmkit_tpu_torch import workload
    n_nodes = 64
    built, _, _, _ = workload.priority_jobs(n_nodes)
    assert _rows(PORT, built) == _rows(PORT, config8_store(PORT, n_nodes))
    out = {}
    for pkg, kind in ((PORT, "card"), (REF, "card"), (PORT, "host")):
        _, _, Sch = _mods(pkg)
        store = config8_store(pkg, n_nodes)
        sched = Sch.Scheduler(store, batch_planner=_planner(pkg, kind),
                              preempt_budget=workload.PRIORITY_JOBS_BUDGET)
        store.view(sched._setup_tasks_list)
        sched.tick()
        out[(pkg, kind)] = _live_and_victims(pkg, store)
    live, victims = out[(PORT, "card")]
    assert out[(REF, "card")] == out[(PORT, "host")] == (live, victims)
    assert 0 < len(victims) <= workload.PRIORITY_JOBS_BUDGET
    assert sum(c for (sid, _), c in live.items() if sid != "band-lo") > 0


def test_priority_jobs_places_every_arrival_on_cpu():
    """Config 8 at its own 512 nodes through ``TorchPlanner(device="cpu")``:
    every arrival placed, as bench.py asserts, with 336 preemptions."""
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.models import Task, TaskState
    from swarmkit_tpu_torch.ops import TorchPlanner
    store, _, _, tasks = workload.priority_jobs()
    planner = TorchPlanner(device="cpu")
    sched, n_dec, _ = workload.preempt_tick(store, planner,
                                            workload.PRIORITY_JOBS_BUDGET)
    after = {t.id: t for t in store.view(lambda tx: tx.find(Task))}
    arrivals = [t for t in tasks if t.service_id != "band-lo"]
    assert all(after[t.id].status.state == TaskState.ASSIGNED
               and after[t.id].node_id for t in arrivals)
    assert sched.stats["preemptions"] == 336
    assert n_dec == len(arrivals) + 336


def test_priority_storm_small_places_every_arrival():
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.models import Task
    from swarmkit_tpu_torch.ops import TorchPlanner
    store, _, nodes, tasks = workload.priority_storm(n_nodes=600, seed=3)
    planner = TorchPlanner(device="cpu")
    calls = []
    orig = planner.select_victims

    def spy(cand, *args):
        picks = orig(cand, *args)
        calls.append((cand, args, picks))
        return picks
    planner.select_victims = spy
    sched, _, _ = workload.preempt_tick(store, planner,
                                        workload.STORM_BUDGET)
    placed = [t for t in store.view(lambda tx: tx.find(Task))
              if t.service_id == "band-storm" and t.node_id]
    assert len(placed) == workload.STORM_ARRIVALS
    assert len(calls) == 1
    cand, args, picks = calls[0]
    assert cand.vb == 16
    assert picks == hp.select_victims_host(cand, *args)
    # the per-node mix makes the cheapest prefix differ between nodes
    assert len({int(w) for w in (cand.vprio[:3] + 1).sum(0)}) > 1
