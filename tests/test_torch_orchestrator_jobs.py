"""The port's jobs orchestrator, enforcers, task reaper, autoscaler and
pipeline supervisor against the reference's.

The same harness as ``test_torch_orchestrator.py`` (whose ``Twin`` this
file drives): one script through both packages, threadless, one fixed
model clock and one id counter a package, every store row's
``serde.to_dict`` equal in the two packages after every step.  The
enforcers and the reaper run their event loops without their threads
(``EnforcerDriver``, ``ReaperDriver``), after the control loops in each
step.  Every comparison is exact.  Both packages' metrics registries are
left as each test found them (``registries_left_as_found``).
"""

import pytest

import test_torch_orchestrator as to
from test_torch_orchestrator import (  # noqa: F401  (the fixtures)
    Twin, clock, create, edit, exit_task, live, node,
    registries_left_as_found, replicated, run_twin,
)


def set_states(sid, from_state, to_state, n=None):
    """An operation: the ``n`` lowest-id tasks of ``sid`` in
    ``from_state`` (all with ``n=None``) report ``to_state``; returns how
    many moved."""
    def op(w):
        m = w.p.m

        def cb(tx):
            hit = sorted((t for t in tx.find(m.Task) if t.service_id == sid
                          and t.status.state == getattr(m.TaskState,
                                                        from_state)),
                         key=lambda t: t.id)[:n]
            for t in hit:
                t = t.copy()
                t.status = m.TaskStatus(state=getattr(m.TaskState, to_state),
                                        timestamp=w.p.types.now())
                tx.update(t)
            return len(hit)
        return w.store.update(cb)
    return op


def job_service(m, name, total=None, max_concurrent=0):
    spec = m.ServiceSpec(
        annotations=m.Annotations(name=name),
        task=to.task_spec(m, image="job:1", restart=m.RestartPolicy(
            condition=m.RestartCondition.ON_FAILURE, delay=0.0)))
    if total is None:
        spec.mode = m.ServiceMode.GLOBAL_JOB
        spec.global_job = m.GlobalJob()
    else:
        spec.mode = m.ServiceMode.REPLICATED_JOB
        spec.replicated_job = m.ReplicatedJob(total_completions=total,
                                              max_concurrent=max_concurrent)
    return m.Service(id=f"svc-{name}", spec=spec,
                     spec_version=m.Version(index=1))


def run_jobs(twin, sid):
    """Settle with the job's assigned tasks started after each step (the
    stub agent starts only tasks desired RUNNING)."""
    twin.settle(after_step=set_states(sid, "ASSIGNED", "RUNNING"))


def count(world, sid, state):
    m = world.p.m
    return sum(t.status.state == getattr(m.TaskState, state)
               for t in world.tasks(sid))


# ------------------------------------------------------------------- jobs

@pytest.mark.parametrize("max_concurrent", [2, 0])
def test_replicated_job_max_concurrent_window(clock, max_concurrent):
    twin = run_twin(clock)
    twin.apply(create(lambda m: job_service(m, "batch", 5,
                                            max_concurrent)))
    run_jobs(twin, "svc-batch")
    window = max_concurrent or 5
    assert count(twin.port, "svc-batch", "RUNNING") == window
    twin.apply(set_states("svc-batch", "RUNNING", "COMPLETE", 1))
    run_jobs(twin, "svc-batch")
    assert count(twin.port, "svc-batch", "RUNNING") == min(window, 4)
    twin.apply(exit_task("svc-batch", "FAILED"))      # restarts on failure
    run_jobs(twin, "svc-batch")
    assert count(twin.port, "svc-batch", "RUNNING") == min(window, 4)
    for _ in range(6):
        twin.apply(set_states("svc-batch", "RUNNING", "COMPLETE"))
        run_jobs(twin, "svc-batch")
    assert count(twin.port, "svc-batch", "COMPLETE") == 5
    assert count(twin.port, "svc-batch", "RUNNING") == 0


def test_global_job_one_completion_a_node(clock):
    twin = run_twin(clock, n_nodes=3)
    twin.apply(create(lambda m: job_service(m, "sweep")))
    run_jobs(twin, "svc-sweep")
    assert count(twin.port, "svc-sweep", "RUNNING") == 3
    twin.apply(set_states("svc-sweep", "RUNNING", "COMPLETE", 2))
    run_jobs(twin, "svc-sweep")
    twin.apply(create(lambda m: node(m, 3)))           # a node joins
    run_jobs(twin, "svc-sweep")
    twin.apply(set_states("svc-sweep", "RUNNING", "COMPLETE"))
    run_jobs(twin, "svc-sweep")
    assert count(twin.port, "svc-sweep", "COMPLETE") == 4
    assert sorted(t.node_id for t in twin.port.tasks("svc-sweep")) == \
        ["n000", "n001", "n002", "n003"]


# -------------------------------------------------------------- enforcers

def test_constraint_enforcer_after_label_change(clock):
    twin = run_twin(clock, n_nodes=3, extras=("constraint",),
                    labels=lambda i: {"disk": "ssd" if i < 2 else "hdd"})
    twin.apply(create(lambda m: replicated(
        m, "db", 4, constraints=["node.labels.disk==ssd"], cpus=3.0)))
    twin.settle()
    m = twin.port.p.m
    on = {t.id for t in twin.port.tasks("svc-db") if t.node_id == "n001"}
    assert len(on) == 2

    def drop(n, m):
        n.spec.annotations.labels = {"disk": "hdd"}
    twin.apply(edit("Node", "n001", drop))
    twin.settle()
    got = {t.id: t for t in twin.port.tasks("svc-db")}
    assert all(got[i].desired_state == m.TaskState.SHUTDOWN for i in on)
    assert all(got[i].status.state == m.TaskState.SHUTDOWN for i in on)

    def shrink(n, m):
        n.description.resources = m.Resources(nano_cpus=4 * 10**9,
                                               memory_bytes=32 << 30)
    twin.apply(edit("Node", "n000", shrink))          # over capacity
    twin.settle()
    assert len(live(twin.port, "svc-db")) == 1


def test_volume_enforcer_on_a_drained_volume(clock):
    twin = run_twin(clock, extras=("volume",))

    def setup(w):
        m = w.p.m
        svc = replicated(m, "vol", 2)

        def cb(tx):
            tx.create(m.Volume(id="vol-1", spec=m.VolumeSpec(
                annotations=m.Annotations(name="vol-1"))))
            tx.create(svc)
            for slot in (1, 2):
                tx.create(m.Task(
                    id=f"t-vol-{slot}", service_id=svc.id, slot=slot,
                    node_id=f"n00{slot}", desired_state=m.TaskState.RUNNING,
                    spec=svc.spec.task, spec_version=m.Version(index=1),
                    status=m.TaskStatus(state=m.TaskState.RUNNING),
                    volumes=[m.VolumeAttachment(id="vol-1", source="v",
                                                target="/data")]
                    if slot == 1 else []))
        w.store.update(cb)
    twin.apply(setup)
    twin.settle()

    def drain(v, m):
        v.spec.availability = m.VolumeAvailability.DRAIN
    twin.apply(edit("Volume", "vol-1", drain))
    twin.settle()
    m = twin.port.p.m
    got = {t.id: t for t in twin.port.tasks("svc-vol")}
    assert got["t-vol-1"].desired_state == m.TaskState.REMOVE
    assert got["t-vol-2"].desired_state == m.TaskState.RUNNING
    # the removed task's slot waits for the service's next reconcile
    assert [t.id for t in live(twin.port, "svc-vol")] == ["t-vol-2"]


# ---------------------------------------------------------------- reaper

@pytest.mark.parametrize("retention", [2, 0])
def test_task_reaper_retention_limit(clock, retention):
    # slot 1 fails on one node five times: the next placements avoid the
    # node its recent failures weigh down, which the reference simulator's
    # per-step resync forgets and its scheduler's event loop keeps
    twin = run_twin(clock, extras=("reaper",), retention=retention,
                    ref_feed="events")
    twin.apply(create(lambda m: replicated(m, "web", 2)))
    twin.settle()
    for _ in range(5):
        twin.apply(exit_task("svc-web", "FAILED", slot=1))
        twin.settle()
    slot1 = [t for t in twin.port.tasks("svc-web") if t.slot == 1]
    assert len(slot1) == max(retention, 1)
    assert len(live(twin.port, "svc-web")) == 2
    twin.apply(to.scale("svc-web", 0))
    twin.settle()
    twin.settle()
    assert live(twin.port, "svc-web") == []


# ------------------------------------------------------------- autoscaler

def test_autoscaler_decisions_stabilization_and_flap_breaker(clock):
    load = [6.0]
    twin = Twin(clock, sampler=lambda sid: {"load": load[0]}
                if sid == "svc-web" else None)
    twin.apply(create(lambda m: to.cluster(m),
                      *((lambda m, i=i: node(m, i)) for i in range(4))))
    twin.start()

    def svc(m):
        s = replicated(m, "web", 2)
        s.spec.autoscale = m.AutoscaleConfig(
            min_replicas=1, max_replicas=8, target_utilization=1.0,
            scale_up_step=2, stabilization_window=10.0, hysteresis=0.1,
            flap_reversals=2)
        return s
    twin.apply(create(svc))
    replicas = []

    def phase(dt, new_load=None):
        if new_load is not None:
            load[0] = new_load
        twin.tick_clock(dt)
        twin.settle()
        replicas.append(twin.port.service("svc-web").spec.replicated
                        .replicas)

    phase(0.0)            # load 6 on 2 replicas: up by the step, to 4
    phase(1.0)            # inside the stabilization window: held
    phase(10.0)           # up to 6
    phase(11.0, 1.0)      # down a step: the first reversal
    phase(11.0, 8.0)      # up again: the second reversal freezes it
    phase(11.0)           # frozen
    phase(40.0)           # the freeze over: up
    assert replicas == [4, 4, 6, 5, 5, 5, 7]
    stats = [w.loops.autoscaler.stats for w in twin.worlds]
    assert stats[0] == stats[1]
    assert stats[1]["decisions"] == 4 and stats[1]["frozen_skips"] >= 1
    assert stats[1]["rate_limited"] >= 1
    assert len(live(twin.port, "svc-web")) == 7


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize("on_failure", ["", "rollback"])
def test_pipeline_release_poison_halt_and_resume(clock, on_failure):
    twin = run_twin(clock)

    def stage(m):
        s = replicated(m, "down", 2)
        s.spec.depends_on = ["up"]
        s.spec.on_upstream_failure = on_failure
        return s
    twin.apply(create(lambda m: replicated(m, "up", 2), stage))
    twin.settle()
    twin.tick_clock(1.0)
    twin.settle()
    w = twin.port
    assert w.service("svc-down").pipeline_status.state == "released"
    assert len(live(w, "svc-down")) == 2

    for _ in range(3):                 # three failures poison "up"
        twin.apply(exit_task("svc-up", "FAILED"))
        twin.settle()
    st = w.service("svc-down").pipeline_status
    assert st.state == "halted" and "poisoned" in st.reason
    want = 0 if on_failure == "rollback" else 2
    assert w.service("svc-down").spec.replicated.replicas == want
    assert len(live(w, "svc-down")) == want

    def resume(s, m):                  # controlapi.resume_pipeline
        stamp = m.now()
        s.pipeline_status = m.PipelineStatus(
            state="waiting", reason="", updated_at=stamp, failed_ids=[],
            resumed_at=stamp)
        s.spec = s.spec.copy()
        s.spec.replicated.replicas = 2

    def forgive(s, m):
        stamp = m.now()
        st = s.pipeline_status
        s.pipeline_status = m.PipelineStatus(
            state=st.state if st else "waiting",
            reason=st.reason if st else "", updated_at=stamp,
            failed_ids=[], resumed_at=stamp)
    twin.tick_clock(1.0)
    twin.apply(edit("Service", "svc-down", resume))
    twin.apply(edit("Service", "svc-up", forgive))
    twin.settle()
    twin.tick_clock(1.0)
    twin.settle()
    assert w.service("svc-down").pipeline_status.state == "released"
    assert len(live(w, "svc-down")) == 2
    stats = [x.loops.pipeline.stats for x in twin.worlds]
    assert stats[0] == stats[1]


# --------------------------------------------- config 9, the tenant burst

def ref_tenant_storm(n_nodes):
    """``workload.tenant_storm`` over the reference's classes (the same
    objects, made in the same order)."""
    from swarmkit_tpu import models as m
    from swarmkit_tpu.scheduler.quota import TENANT_LABEL
    from swarmkit_tpu.state import MemoryStore
    from swarmkit_tpu.utils import new_id

    from swarmkit_tpu_torch.workload import TENANT_CPU, tenant_bands

    n_hi, quota, n_burst, n_blocked = tenant_bands(n_nodes)
    store = MemoryStore()
    store.update(lambda tx: tx.create(m.Cluster(
        id=new_id(), spec=m.ClusterSpec(
            annotations=m.Annotations(name="default"),
            tenants={"burst": m.TenantQuota(nano_cpus=quota * TENANT_CPU),
                     "hi": m.TenantQuota(nano_cpus=1000 * TENANT_CPU)}))))
    store.update(lambda tx: [tx.create(m.Node(
        id=new_id(), spec=m.NodeSpec(annotations=m.Annotations(
            name=f"q{i:04d}")),
        status=m.NodeStatus(state=m.NodeState.READY),
        description=m.NodeDescription(
            hostname=f"q{i:04d}", resources=m.Resources(
                nano_cpus=8 * 10**9, memory_bytes=32 << 30))))
        for i in range(n_nodes)] and None)
    res = m.ResourceRequirements(reservations=m.Resources(
        nano_cpus=TENANT_CPU, memory_bytes=1 << 30))
    plan = (("hi", "hi", 2, n_hi, None),
            ("burst", "burst", 0, n_burst,
             m.AutoscaleConfig(min_replicas=2, max_replicas=n_burst,
                               target_utilization=1.0,
                               stabilization_window=0.0)),
            ("blocked", "burst", 0, n_blocked, None))
    services = {}
    for name, tenant, prio, count, autoscale in plan:
        services[name] = m.Service(
            id=new_id(), spec=m.ServiceSpec(
                annotations=m.Annotations(name=f"t-{name}",
                                          labels={TENANT_LABEL: tenant}),
                mode=m.ServiceMode.REPLICATED,
                replicated=m.ReplicatedService(
                    replicas=2 if autoscale else count),
                task=m.TaskSpec(resources=res, priority=prio),
                autoscale=autoscale),
            spec_version=m.Version(index=1))
    store.update(lambda tx: [tx.create(s) for s in services.values()]
                 and None)

    def mk_tasks(tx):
        for name, _tenant, _prio, count, _auto in plan:
            svc = services[name]
            for s in range(count):
                tx.create(m.Task(
                    id=new_id(), service_id=svc.id, slot=s + 1,
                    desired_state=m.TaskState.RUNNING, spec=svc.spec.task,
                    spec_version=m.Version(index=1),
                    service_annotations=svc.spec.annotations,
                    status=m.TaskStatus(state=m.TaskState.PENDING)))
    store.update(mk_tasks)
    return store, services


def ref_tenant_storm_pass(store, services, planner):
    """``workload.tenant_storm_pass`` over the reference's classes."""
    from swarmkit_tpu.orchestrator.autoscaler import (
        Supervisor as AutoscaleSupervisor,
    )
    from swarmkit_tpu.scheduler import Scheduler

    burst = services["burst"]
    load = float(burst.spec.autoscale.max_replicas)
    sched = Scheduler(store, batch_planner=planner)
    store.view(sched._setup_tasks_list)
    scaler = AutoscaleSupervisor(
        store, sampler=lambda sid: {"load": load} if sid == burst.id
        else None, start_worker=False)
    scaler.drive()
    return sched, scaler, sched.tick()


@pytest.mark.parametrize("route", ["device", "host"])
def test_tenant_storm_matches_reference(clock, route):
    """bench.py's config 9 at 64 nodes: one autoscaler drive and one tick
    through ``TorchPlanner(device="cpu")`` (the quota column of the
    planner's feasibility) and ``TPUPlanner`` (router off), or through
    both host paths: every store row equal, the high band placed, the
    burst tenant clamped at its quota, the blocked service refused on
    quota."""
    from swarmkit_tpu.ops import TPUPlanner
    from swarmkit_tpu_torch import workload
    from swarmkit_tpu_torch.ops import TorchPlanner

    ref_planner = port_planner = None
    if route == "device":
        ref_planner = TPUPlanner()
        ref_planner.enable_small_group_routing = False
        port_planner = TorchPlanner(device="cpu")
    ref_store, ref_services = ref_tenant_storm(64)
    ref = ref_tenant_storm_pass(ref_store, ref_services, ref_planner)
    store, services = workload.tenant_storm(64)
    port = workload.tenant_storm_pass(store, services, port_planner)
    world = [to.World(to.PKGS[to.REF], store=ref_store),
             to.World(to.PKGS[to.PORT], store=store)]
    assert world[0].rows() == world[1].rows()
    assert ref[2] == port[2]
    assert ref[0].stats.get("quota_clamps") == \
        port[0].stats.get("quota_clamps") > 0
    assert ref[1].stats == port[1].stats and port[1].stats["decisions"] == 1
    n_hi, quota, _, _ = workload.tenant_bands(64)
    placed = {name: sum(1 for t in world[1].tasks(s.id) if t.node_id)
              for name, s in services.items()}
    assert placed["hi"] == n_hi and placed["blocked"] == 0
    assert 0 < placed["burst"] <= quota
    err = world[1].tasks(services["blocked"].id)[0].status.err
    assert "over tenant quota" in err
    if port_planner is not None:
        assert port_planner.stats["tasks_planned"] == \
            ref_planner.stats["tasks_planned"] > 0
