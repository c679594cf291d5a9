"""The port's native C commit plane on the CPU.

``swarmkit_tpu_torch/native/hotpath.c`` is the reference's C module byte
for byte; the port builds it under ``_build/native/<hash>/`` and loads it
under its own name.  Within the port, every entry point gives what the
Python loops give with the plane off (``SWARMKIT_TPU_NO_NATIVE`` /
``SWARM_NATIVE_COMMIT=0``): the planner's ``block_stage`` and
``plan_apply`` through ``_apply_assignments``, the binary block codec and
its corruption cases, the watch fan-out (``fanout_expand``,
``fanout_filter``, ``per_node_group``) and ``block_apply_follower``; and
the port's module gives what the reference's gives on the same inputs.  A
per-group tick, a fused tick, a churn run and a churn over a D = 2 mesh
give the same store rows, events and placements with the plane on and off.

Modelled on the reference's ``tests/test_store.py:335``,
``tests/test_task_block.py:324`` and ``tests/test_columnar_commit.py:74-219``.
"""

import importlib
import random
import string

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch import native  # noqa: E402
from swarmkit_tpu_torch.models import types as mtypes  # noqa: E402
from swarmkit_tpu_torch.ops import TorchPlanner  # noqa: E402
from swarmkit_tpu_torch.parallel import make_mesh  # noqa: E402
from swarmkit_tpu_torch.state import serde  # noqa: E402
from swarmkit_tpu_torch.state.events import (  # noqa: E402
    EventCommit, EventTaskBlock,
)
from swarmkit_tpu_torch.state.store import TaskBlockAction  # noqa: E402
from swarmkit_tpu_torch.utils.metrics import registry  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"


def _pkg(name):
    return (importlib.import_module(f"{name}.models"),
            importlib.import_module(f"{name}.state"),
            importlib.import_module(f"{name}.scheduler"),
            importlib.import_module(f"{name}.state.events"),
            importlib.import_module(f"{name}.state.serde"))


@pytest.fixture
def frozen_clock():
    mods = [importlib.import_module(f"{pkg}.models.types")
            for pkg in (REF, PORT)]
    for m in mods:
        m.set_time_source(lambda: 1_700_000_000.0)
    try:
        yield
    finally:
        for m in mods:
            m.set_time_source(None)


def _native(monkeypatch, on: bool):
    if on:
        monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
        monkeypatch.delenv("SWARM_NATIVE_COMMIT", raising=False)
        assert native.get() is not None
    else:
        monkeypatch.setenv("SWARMKIT_TPU_NO_NATIVE", "1")
        monkeypatch.setenv("SWARM_NATIVE_COMMIT", "0")
        assert native.get() is None and native.get_commit() is None


# ------------------------------------------------------------ the build

def test_hotpath_is_the_reference_source():
    port = importlib.resources.files("swarmkit_tpu_torch.native")
    ref = importlib.resources.files("swarmkit_tpu.native")
    assert (port / "hotpath.c").read_bytes() \
        == (ref / "hotpath.c").read_bytes()


def test_library_builds_under_build_dir_with_the_port_name(monkeypatch):
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    hp = native.get()
    assert hp is not None, "the native plane must build on this image"
    assert hp.__name__ == "swarmkit_tpu_torch.native._hotpath"
    path = native.loaded_path()
    assert path is not None
    lib = native.library_path()
    assert str(lib) == path
    assert lib.parent.parent == native.BUILD_ROOT
    assert len(lib.parent.name) == 64   # sha256 of source, compiler, flags
    assert native.BUILD_ROOT.parts[-2:] == ("_build", "native")
    # nothing built lands in the package folder
    leftovers = [p.name for p in native.NATIVE_DIR.iterdir()
                 if p.suffix in (".so", ".o", ".tmp", ".sha256")
                 or p.name == "build"]
    assert leftovers == []
    for name in ("plan_apply", "block_commit", "block_stage",
                 "block_validate", "block_apply", "commit_prepare",
                 "commit_apply", "block_decode", "block_apply_follower",
                 "fanout_expand", "fanout_filter", "per_node_group"):
        assert callable(getattr(hp, name)), name


def test_build_dir_follows_the_source_hash(monkeypatch, tmp_path):
    """A changed source names another folder, so a stale library can
    never be served; a failed compile leaves no library behind."""
    src = tmp_path / "hotpath.c"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n")
    before = native.build_dir()
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.build_dir() != before
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "b")
    src.write_bytes(b"this is not C\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    assert not native.library_path().exists()
    assert list(native.library_path().parent.iterdir()) == []


def test_switches_are_read_per_call(monkeypatch):
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("SWARM_NATIVE_COMMIT", raising=False)
    assert native.get() is not None and native.commit_enabled()
    assert native.get_commit() is native.get()
    monkeypatch.setenv("SWARM_NATIVE_COMMIT", "0")
    assert native.get() is not None and native.get_commit() is None
    monkeypatch.setenv("SWARMKIT_TPU_NO_NATIVE", "1")
    assert native.get() is None


def test_fallback_counter_counts_an_unavailable_plane(monkeypatch, tmp_path):
    """Requested but unavailable counts a fallback tick a call; the
    explicit switch does not.  Without a compiler the plane is
    unavailable, logged once, and the Python loops serve."""
    name = "swarm_native_commit_fallbacks"
    monkeypatch.setenv("SWARMKIT_TPU_NO_NATIVE", "1")
    base = registry.get_counter(name)
    assert native.get_commit() is None
    assert registry.get_counter(name) == base + 1
    monkeypatch.setenv("SWARM_NATIVE_COMMIT", "0")
    assert native.get_commit() is None
    assert registry.get_counter(name) == base + 1

    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE")
    monkeypatch.delenv("SWARM_NATIVE_COMMIT")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "compiler",
                        lambda: [str(tmp_path / "no-such-cc")])
    assert native.get() is None
    assert native.get_commit() is None
    assert registry.get_counter(name) == base + 2


# ----------------------------------------------------------- the codec

def _random_block(rng, n=None):
    n = rng.randrange(0, 60) if n is None else n
    alphabet = string.hexdigits + ",:{}~é"
    ids = tuple("".join(rng.choices(alphabet, k=rng.randrange(1, 24)))
                for _ in range(n))
    nodes = [f"node-{i}" for i in range(rng.randrange(1, 6))]
    nids = tuple(rng.choice(nodes) if rng.random() > 0.05 else ""
                 for _ in range(n))
    return TaskBlockAction(
        "task_block", ids, nids, rng.randrange(0, 1 << 40),
        rng.randrange(0, int(mtypes.TaskState.RUNNING) + 1),
        "scheduler assigned task to node"[:rng.randrange(0, 31)],
        rng.random() * 1e9)


def test_block_codec_native_matches_python_and_reference(monkeypatch):
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    hp = native.get()
    from swarmkit_tpu import native as ref_native
    from swarmkit_tpu.state.store import TaskBlockAction as RefAction
    ref_hp = ref_native.get()
    for seed in range(4):
        rng = random.Random(seed)
        for _ in range(40):
            action = _random_block(rng)
            data = serde.block_to_bytes(action)
            assert data[:4] == serde.BLOCK_ENTRY_MAGIC
            assert serde.block_from_bytes(data) == action
            assert hp.block_decode(data, TaskBlockAction) == action
            if ref_hp is not None:
                got = ref_hp.block_decode(data, RefAction)
                assert tuple(got.__dict__.values()) \
                    == tuple(action.__dict__.values())


def test_block_codec_rejects_corruption_on_both_decoders(monkeypatch):
    import struct
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    hp = native.get()
    data = serde.block_to_bytes(_random_block(random.Random(1), n=12))
    corrupt = [data[:cut] for cut in (0, 3, 17, len(data) - 1)]
    corrupt.append(data + b"x")
    hdr = struct.pack("<4sIqidI", b"SKB1", 2, 5, 2, 1.0, 1) + b"m"
    blob = b"a\x00b\x00c"
    corrupt.append(hdr + struct.pack("<I", len(blob)) + blob
                   + struct.pack("<II", 1, 2)
                   + struct.pack("<I", 2) + b"n1")
    hdr0 = struct.pack("<4sIqidI", b"SKB1", 0, 5, 2, 1.0, 0)
    corrupt.append(hdr0 + struct.pack("<I", 3) + b"xyz"
                   + struct.pack("<I", 0) + struct.pack("<I", 0))
    for bad in corrupt:
        with pytest.raises(ValueError):
            serde.block_from_bytes(bad)
        with pytest.raises(ValueError):
            hp.block_decode(bad, TaskBlockAction)


# --------------------------------------------------------- the fan-out

def _block_tasks(M, n, rng):
    out = []
    for i in range(n):
        t = M.Task(id=f"t{i:04d}", service_id="svc", slot=i + 1,
                   status=M.TaskStatus(state=M.TaskState.PENDING,
                                       message="p"),
                   desired_state=M.TaskState.RUNNING)
        t.meta.version.index = rng.randrange(50)
        t.meta.created_at = 5.0
        out.append(t)
    return out


def _event_key(ev, sd=serde):
    if isinstance(ev, EventCommit) or type(ev).__name__ == "EventCommit":
        return ("commit", ev.version)
    if hasattr(ev, "action"):
        return (ev.action, ev.version, sd.to_dict(ev.obj),
                sd.to_dict(ev.old) if ev.old is not None else None)
    return ("block", tuple(o.id for o in ev.olds), tuple(ev.node_ids),
            ev.base_version, ev.state, ev.message)


@pytest.mark.parametrize("n", [0, 1, 17, 50])
def test_fanout_expand_matches_python_and_reference(monkeypatch, n):
    M = _pkg(PORT)[0]
    RM, _, _, RE, RS = _pkg(REF)
    rng = random.Random(3 + n)
    olds = _block_tasks(M, n, rng)
    nids = [f"n{rng.randrange(3)}" for _ in range(n)]
    args = (nids, 700, int(M.TaskState.ASSIGNED), "assigned", 42.5)
    _native(monkeypatch, True)
    ev_native = EventTaskBlock(olds, *args).expand_events()
    _native(monkeypatch, False)
    ev_python = EventTaskBlock(olds, *args).expand_events()
    assert [_event_key(e) for e in ev_native] \
        == [_event_key(e) for e in ev_python]
    for a, b in zip(ev_native, ev_python):
        assert a.old is b.old
    # the reference's module on the reference's twin objects
    ref_olds = _block_tasks(RM, n, random.Random(3 + n))
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE")
    monkeypatch.delenv("SWARM_NATIVE_COMMIT")
    ev_ref = RE.EventTaskBlock(ref_olds, *args).expand_events()
    assert [_event_key(e) for e in ev_native] \
        == [_event_key(e, RS) for e in ev_ref]


def test_per_node_group_matches_python_and_reference(monkeypatch):
    M = _pkg(PORT)[0]
    RM, _, _, RE, _ = _pkg(REF)
    rng = random.Random(4)
    olds = _block_tasks(M, 40, rng)
    nids = [f"n{rng.randrange(4)}" for _ in range(40)]
    args = (nids, 100, int(M.TaskState.ASSIGNED), "m", 1.0)
    _native(monkeypatch, True)
    g_native = EventTaskBlock(olds, *args).per_node()
    _native(monkeypatch, False)
    g_python = EventTaskBlock(olds, *args).per_node()
    assert list(g_native) == list(g_python)   # insertion order too
    for k in g_native:
        assert [(o.id, v) for o, v in g_native[k]] \
            == [(o.id, v) for o, v in g_python[k]]
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE")
    monkeypatch.delenv("SWARM_NATIVE_COMMIT")
    g_ref = RE.EventTaskBlock(_block_tasks(RM, 40, random.Random(4)),
                              *args).per_node()
    assert [(k, [(o.id, v) for o, v in g]) for k, g in g_native.items()] \
        == [(k, [(o.id, v) for o, v in g]) for k, g in g_ref.items()]


def test_fanout_filter_matches_python_with_raising_predicate(monkeypatch):
    from swarmkit_tpu_torch.state import watch
    M = _pkg(PORT)[0]
    _native(monkeypatch, True)
    hp = native.get()
    events = EventTaskBlock(_block_tasks(M, 20, random.Random(5)),
                            ["n1"] * 20, 0, int(M.TaskState.ASSIGNED), "m",
                            1.0).expand_events()

    def pred(ev):
        if ev.obj.slot % 7 == 0:
            raise RuntimeError("predicate boom")
        return ev.obj.slot % 2 == 0

    oracle = []
    for e in events:
        try:
            if pred(e):
                oracle.append(e)
        except Exception:
            continue
    assert hp.fanout_filter(events, pred) == oracle
    assert oracle
    from swarmkit_tpu import native as ref_native
    ref_hp = ref_native.get()
    if ref_hp is not None:
        assert ref_hp.fanout_filter(events, pred) == oracle
    assert hasattr(watch, "Subscription")


def test_block_apply_follower_matches_python(monkeypatch):
    """apply_store_actions over one binary block entry: the native
    follower apply and the Python loop leave equal snapshots, streams,
    versions and by-node buckets."""
    M, S = _pkg(PORT)[:2]

    def build():
        store = S.MemoryStore()
        nodes = [M.Node(id=f"node-n{i}", spec=M.NodeSpec(
            annotations=M.Annotations(name=f"n{i}"))) for i in range(3)]
        tasks = [M.Task(id=f"task-{i:04d}", service_id="svc", slot=i + 1,
                        desired_state=M.TaskState.RUNNING,
                        status=M.TaskStatus(state=M.TaskState.PENDING))
                 for i in range(25)]

        def setup(tx):
            for x in nodes + tasks:
                tx.create(x)
        store.update(setup)
        return store, nodes, tasks

    mtypes.set_time_source(lambda: 2_000_000.0)
    try:
        leader, nodes, tasks = build()
        action = TaskBlockAction(
            "task_block", tuple(t.id for t in tasks),
            tuple(nodes[i % 3].id for i in range(len(tasks))),
            leader.version, int(M.TaskState.ASSIGNED), "assigned", 123.25)
        entry = serde.actions_to_entry_data([action])
        assert entry[:4] == serde.BLOCK_ENTRY_MAGIC
        out = []
        spy = _Spy(native.get())
        for on in (True, False):
            _native(monkeypatch, on)
            if on:
                monkeypatch.setattr(native, "get", lambda: spy)
            store, _n, _t = build()
            sub = store.queue.subscribe()
            store.apply_store_actions(serde.entry_to_actions(entry))
            stream = [_event_key(e) for e in sub.drain()]
            buckets = {nid: list(b) for nid, b in
                       store._tables["tasks"].by_node.items()}
            out.append((store.save_bytes(), stream, buckets, store.version))
            monkeypatch.undo()
        assert spy.calls.get("block_apply_follower") == 1, spy.calls
        assert out[0] == out[1]
        assert sum(k[0] == "update" for k in out[0][1]) == 25
    finally:
        mtypes.set_time_source(None)


# ----------------------------------------------- the planner's apply

class _Spy:
    """Forwards to the native module and counts each entry point."""

    def __init__(self, hp):
        self._hp = hp
        self.calls = {}

    def __getattr__(self, name):
        fn = getattr(self._hp, name)

        def call(*args):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)
        return call


def _cluster(P, n_nodes=9, n_tasks=23, cpus=4):
    M, S = P[0], P[1]
    store = S.MemoryStore()
    nodes = [M.Node(
        id=f"node-{i:03d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"n{i}", labels={"rack": f"r{i % 3}"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"n{i}", resources=M.Resources(
                nano_cpus=cpus * 10 ** 9, memory_bytes=8 << 30)))
        for i in range(n_nodes)]
    spec = M.TaskSpec(
        resources=M.ResourceRequirements(reservations=M.Resources(
            nano_cpus=10 ** 9 // 2)),
        placement=M.Placement(preferences=[M.PlacementPreference(
            spread=M.SpreadOver(spread_descriptor="node.labels.rack"))]))
    svc = M.Service(id="svc", spec=M.ServiceSpec(
        annotations=M.Annotations(name="svc"),
        mode=M.ServiceMode.REPLICATED,
        replicated=M.ReplicatedService(replicas=n_tasks), task=spec),
        spec_version=M.Version(index=1))
    tasks = [M.Task(id=f"task-{k:04d}", service_id="svc", slot=k + 1,
                    desired_state=M.TaskState.RUNNING, spec=spec,
                    spec_version=M.Version(index=1),
                    status=M.TaskStatus(state=M.TaskState.PENDING))
             for k in range(n_tasks)]
    # a few preassigned tasks take the validation route
    for t in tasks[:4]:
        t.slot = 0
        t.node_id = nodes[int(t.id[-1]) % n_nodes].id

    def setup(tx):
        for x in nodes + [svc] + tasks:
            tx.create(x)
    store.update(setup)
    return store


def _rows(P, store):
    M = P[0]
    return sorted((t.id, t.node_id, int(t.status.state), t.status.message,
                   t.meta.version.index)
                  for t in store.view(lambda tx: tx.find(M.Task)))


def _tick(monkeypatch, on, fused=True, spy=None):
    P = _pkg(PORT)
    _native(monkeypatch, on)
    if spy is not None:
        monkeypatch.setattr(native, "get", lambda: spy)
    store = _cluster(P)
    obs = store.queue.subscribe(accepts_blocks=True)
    planner = TorchPlanner(device="cpu")
    planner.fused_enabled = fused
    sched = P[2].Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    sched._process_preassigned_tasks()
    n = sched.tick()
    events = [_event_key(e) for e in obs.drain()]
    monkeypatch.undo()
    stats = {k: v for k, v in planner.stats.items() if k != "plan_seconds"}
    return n, _rows(P, store), events, stats


def test_block_stage_reached_and_equal_to_python_loop(monkeypatch,
                                                      frozen_clock):
    """The block-mode tick (the scheduler's default) goes through
    ``hp.block_stage`` for the preassigned batch and the group, and its
    store rows and events equal the Python loop's."""
    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    spy = _Spy(native.get())
    on = _tick(monkeypatch, True, spy=spy)
    off = _tick(monkeypatch, False)
    assert spy.calls.get("block_stage", 0) >= 2, spy.calls
    assert on[3]["tasks_planned"] == 23 and on[3]["groups_planned"] == 1
    assert on == off


def test_plan_apply_reached_and_equal_to_python_loop(monkeypatch,
                                                     frozen_clock):
    """Outside block mode the apply clones and registers the tasks with
    ``hp.plan_apply``: the decisions, the mirrors and the clones equal the
    Python loop's, and the port's module equals the reference's on the
    same inputs."""
    P = _pkg(PORT)

    def apply(on, spy=None):
        _native(monkeypatch, on)
        if spy is not None:
            monkeypatch.setattr(native, "get", lambda: spy)
        store = _cluster(P)
        planner = TorchPlanner(device="cpu")
        sched = P[2].Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        sched.block_mode = False
        group = {t.id: t for t in store.view(lambda tx: tx.find(P[0].Task))
                 if not t.node_id}
        decisions = {}
        planner.begin_tick(sched)
        assert planner.schedule_group(sched, group, decisions)
        planner.end_tick()
        monkeypatch.undo()
        out = sorted((tid, d.old.node_id, d.new.node_id,
                      int(d.new.status.state), d.new.status.message,
                      d.new.meta.version.index)
                     for tid, d in decisions.items())
        mirror = sorted((info.node.id, sorted(info.tasks))
                        for info in sched.node_set.nodes.values())
        clones = sorted(serde.to_dict(sched.all_tasks[tid])["node_id"]
                        for tid in decisions)
        return out, mirror, clones

    monkeypatch.delenv("SWARMKIT_TPU_NO_NATIVE", raising=False)
    spy = _Spy(native.get())
    got = apply(True, spy)
    assert spy.calls.get("plan_apply") == 1, spy.calls
    assert len(got[0]) == 19
    assert got == apply(False)


def test_port_and_reference_modules_stage_alike():
    """``block_stage`` and ``plan_apply`` of the port's module and the
    reference's, on twin inputs built from each package's models."""
    from swarmkit_tpu import native as ref_native
    ref_hp = ref_native.get()
    if ref_hp is None:
        pytest.skip("the reference's native module did not build")
    hp = native.get()
    outs = []
    for pkg, mod in ((PORT, hp), (REF, ref_hp)):
        M = _pkg(pkg)[0]
        Sch = importlib.import_module(f"{pkg}.scheduler.scheduler")
        tasks = _block_tasks(M, 12, random.Random(9))
        items = [(t.id, t) for t in tasks]
        slots = [i % 3 for i in range(12)]
        nids = ["na", "nb", "nc"]
        dicts = [{}, {}, {}]
        olds, out_nids = mod.block_stage(items, slots, nids, dicts)
        staged = ([o.id for o in olds], list(out_nids),
                  [sorted(d) for d in dicts])
        status = M.TaskStatus(state=M.TaskState.ASSIGNED, timestamp=7.0,
                              message="m")
        all_tasks, decisions, dicts2 = {}, {}, [{}, {}, {}]
        mod.plan_apply(items, slots, nids, dicts2, status, all_tasks,
                       decisions, Sch.SchedulingDecision)
        sd = importlib.import_module(f"{pkg}.state.serde")
        applied = [(tid, sd.to_dict(all_tasks[tid]),
                    decisions[tid].old is dict(items)[tid])
                   for tid in sorted(all_tasks)]
        outs.append((staged, applied, [sorted(d) for d in dicts2]))
    assert outs[0] == outs[1]


# --------------------------------------------------------- whole ticks

@pytest.mark.parametrize("fused", [True, False])
def test_tick_native_on_equals_off(monkeypatch, frozen_clock, fused):
    on = _tick(monkeypatch, True, fused=fused)
    off = _tick(monkeypatch, False, fused=fused)
    assert on == off
    assert on[3]["tasks_planned"] == 23


def _many_service(P, n_nodes=16):
    M, S = P[0], P[1]
    store = S.MemoryStore()
    nodes = [M.Node(
        id=f"node-{i:03d}",
        spec=M.NodeSpec(annotations=M.Annotations(
            name=f"n{i}", labels={"rack": f"r{i % 4}"})),
        status=M.NodeStatus(state=M.NodeState.READY),
        description=M.NodeDescription(
            hostname=f"n{i}", resources=M.Resources(
                nano_cpus=8 * 10 ** 9, memory_bytes=16 << 30)))
        for i in range(n_nodes)]
    objs = list(nodes)
    for s, (strategy, count) in enumerate(
            (("spread", 32), ("binpack", 20), ("spread", 16),
             ("weighted", 24))):
        prefs = [M.PlacementPreference(spread=M.SpreadOver(
            spread_descriptor="node.labels.rack"))] \
            if strategy == "spread" else []
        spec = M.TaskSpec(
            resources=M.ResourceRequirements(reservations=M.Resources(
                nano_cpus=10 ** 8, memory_bytes=64 << 20)),
            placement=M.Placement(preferences=prefs, strategy=strategy,
                                  strategy_weights={"cpu": 2, "memory": 1}
                                  if strategy == "weighted" else {}))
        svc = M.Service(id=f"svc{s}", spec=M.ServiceSpec(
            annotations=M.Annotations(name=f"svc{s}"),
            mode=M.ServiceMode.REPLICATED,
            replicated=M.ReplicatedService(replicas=count), task=spec),
            spec_version=M.Version(index=1))
        objs.append(svc)
        objs += [M.Task(id=f"svc{s}-{k:04d}", service_id=svc.id,
                        slot=k + 1, desired_state=M.TaskState.RUNNING,
                        spec=spec, spec_version=M.Version(index=1),
                        status=M.TaskStatus(state=M.TaskState.PENDING))
                 for k in range(count)]
    store.update(lambda tx: [tx.create(x) for x in objs] and None)
    return store


def test_fused_tick_native_on_equals_off(monkeypatch, frozen_clock):
    P = _pkg(PORT)

    def run(on):
        _native(monkeypatch, on)
        store = _many_service(P)
        obs = store.queue.subscribe(accepts_blocks=True)
        planner = TorchPlanner(device="cpu")
        sched = P[2].Scheduler(store, batch_planner=planner)
        store.view(sched._setup_tasks_list)
        n = sched.tick()
        events = [_event_key(e) for e in obs.drain()]
        monkeypatch.undo()
        return n, _rows(P, store), events, planner.stats.get(
            "groups_fused", 0)

    on, off = run(True), run(False)
    assert on == off
    assert on[0] == 92 and on[3] == 4


@pytest.mark.parametrize("d", [None, 2])
def test_churn_native_on_equals_off(monkeypatch, frozen_clock, d):
    """The streaming churn (arrivals, failures, a drain flip, a node join
    and a node removal, through the store watch feed), unsharded and over
    a D = 2 mesh: the same decisions, store rows and watch events with the
    plane on and off, and the resident row lists in step with the
    resident infos after every refresh path."""
    import test_torch_mesh_streaming as ms

    def run(on):
        _native(monkeypatch, on)
        planner = TorchPlanner(device="cpu", mesh=None if d is None
                               else make_mesh(["cpu"] * d))
        dec, state, events, _sched, planner = ms._churn_run(PORT, planner)
        st = planner._streaming
        assert st.node_ids == [info.node.id for info in st.infos]
        assert all(a is info.tasks
                   for a, info in zip(st.task_dicts, st.infos))
        snap = planner.streaming_snapshot()
        monkeypatch.undo()
        return dec, state, events, snap

    on, off = run(True), run(False)
    assert on == off
    snap = on[3]
    assert snap["incremental_ticks"] >= 2 and snap["fallbacks"] >= 1
    if d:
        assert snap["mesh_devices"] == d
