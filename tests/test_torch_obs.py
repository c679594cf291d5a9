"""The port's copies of the reference's ``obs/`` and ``utils/`` modules
(health, journey, lifecycle, sampler, report, debugpages, httpdebug,
volumequeue) on the CPU, against the reference's.

The same inputs go to both packages' modules, each on its own objects:
one store event stream (creations, a columnar block commit, status
updates, a delete) into ``JourneyLedger`` and ``LifecycleTracker`` gives
equal journeys, critical paths, summaries and latencies;
``HealthEvaluator`` gives the same verdicts on the same registry values;
``report.phase_table``, ``format_table`` and ``validate_chrome_trace``
give the same results on one trace; ``Sampler`` the same rows;
``VolumeQueue`` the same order; and the port's debug pages are installed
on every ``DebugServer``.
"""

import importlib
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
PKGS = (REF, PORT)
MODULES = ("obs/health.py", "obs/journey.py", "obs/lifecycle.py",
           "obs/sampler.py", "obs/report.py", "obs/debugpages.py",
           "utils/httpdebug.py", "utils/volumequeue.py")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def clock():
    """One settable model clock for both packages."""
    t = [1_700_000_000.0]
    mods = [_m(pkg, "models.types") for pkg in PKGS]
    for m in mods:
        m.set_time_source(lambda: t[0])
    try:
        yield t
    finally:
        for m in mods:
            m.set_time_source(None)


@pytest.mark.parametrize("rel", MODULES)
def test_copies_differ_only_in_the_package_name(rel):
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    ref = (root / REF / rel).read_text()
    port = (root / PORT / rel).read_text()
    assert port == ref.replace("swarmkit_tpu.", "swarmkit_tpu_torch.")


# ------------------------------------------------------- event streams

def _event_stream(pkg, clock):
    """A store's block-aware watch stream over one short task life:
    creations, a block assignment, RUNNING / FAILED updates and a
    delete, the clock moving between steps."""
    M = _m(pkg, "models")
    S = _m(pkg, "state")
    T = _m(pkg, "models.types")
    store = S.MemoryStore()
    sub = store.queue.subscribe(accepts_blocks=True)
    nodes = [M.Node(id=f"node-{i}", spec=M.NodeSpec(
        annotations=M.Annotations(name=f"n{i}"))) for i in range(3)]
    tasks = [M.Task(id=f"task-{i:03d}", service_id="svc", slot=i + 1,
                    desired_state=M.TaskState.RUNNING,
                    status=M.TaskStatus(state=M.TaskState.PENDING,
                                        timestamp=T.now()))
             for i in range(12)]
    store.update(lambda tx: [tx.create(x) for x in nodes + tasks] and None)
    clock[0] += 0.25
    stored = sorted(store.view(lambda tx: tx.find(M.Task)),
                    key=lambda t: t.id)

    def boom(*a):
        raise AssertionError("unexpected callback")

    store.commit_task_block(stored[:8], [nodes[i % 3].id for i in range(8)],
                            int(M.TaskState.ASSIGNED), "assigned", boom,
                            boom)
    clock[0] += 0.5

    def advance(state, ids):
        def cb(tx):
            for tid in ids:
                cur = tx.get(M.Task, tid).copy()
                cur.status = M.TaskStatus(state=state, timestamp=T.now(),
                                          message=state.name.lower())
                tx.update(cur)
        store.update(cb)

    advance(M.TaskState.RUNNING, [f"task-{i:03d}" for i in range(6)])
    clock[0] += 1.5
    advance(M.TaskState.FAILED, ["task-001"])
    clock[0] += 0.125
    store.update(lambda tx: tx.delete(M.Task, "task-011"))
    events = sub.drain()
    store.queue.unsubscribe(sub)
    return events


def _both_streams(clock):
    start = clock[0]
    out = []
    for pkg in PKGS:
        clock[0] = start
        out.append(_event_stream(pkg, clock))
    return out


@pytest.fixture
def fresh_devtel():
    """Each package's device-telemetry ledger, fresh for the test and put
    back after it (a journey's critical path reads it)."""
    mods = [_m(pkg, "obs.devicetelemetry") for pkg in PKGS]
    saved = [m.save_state() for m in mods]
    for m in mods:
        m.reset()
    try:
        yield
    finally:
        for m, state in zip(mods, saved):
            m.restore_state(state)


def test_journey_ledger_agrees(clock, fresh_devtel):
    results = []
    for pkg, events in zip(PKGS, _both_streams(clock)):
        J = _m(pkg, "obs.journey")
        ledger = J.JourneyLedger(sample_rate=1.0)
        ledger.enabled = True
        for ev in events:
            ledger.handle_event(ev)
        ledger.note_sent("task-002", ts=clock[0])
        results.append((ledger.journeys(), ledger.critical_path(),
                        ledger.summary(), ledger.journey_of("task-001"),
                        ledger.dump_bytes()))
    assert results[0] == results[1]
    journeys = results[1][0]
    assert len(journeys) == 12
    names = [m for m, _, _ in journeys["task-000"]]
    assert names[0] == "created"
    assert {"planned", "committed", "running"} <= set(names)


def test_journey_sampling_agrees():
    for rate in (0.0, 0.37, 1.0):
        admitted = []
        for pkg in PKGS:
            J = _m(pkg, "obs.journey")
            ledger = J.JourneyLedger(sample_rate=rate, cap=50)
            ledger.enabled = True
            for i in range(200):
                ledger.note_sent(f"t{i}", ts=float(i))
            admitted.append((sorted(ledger.journeys()), ledger.overflow,
                             ledger.refused))
        assert admitted[0] == admitted[1], rate


def test_lifecycle_tracker_agrees(clock):
    results = []
    for pkg, events in zip(PKGS, _both_streams(clock)):
        L = _m(pkg, "obs.lifecycle")
        reg = _m(pkg, "utils.metrics").Registry()
        tracker = L.LifecycleTracker(registry=reg)
        for ev in events:
            tracker.handle_event(ev)
        summary = tracker.summary()
        svc = reg.timers.get(L.service_edge_timer_name("svc"))
        results.append((summary, None if svc is None
                        else (svc.count, svc.total)))
    assert results[0] == results[1]
    summary = results[1][0]
    assert summary["pending->assigned"]["count"] == 8
    assert summary["assigned->running"]["count"] == 6
    assert summary["running->failed"]["count"] == 1


# -------------------------------------------------------------- health

def _seeded_registry(pkg):
    reg = _m(pkg, "utils.metrics").Registry()
    reg.gauge("swarm_planner_breaker_state", 2)
    reg.gauge("swarm_raft_apply_lag", 10)
    for v in (0.5, 1.5, 7.0, 40.0):
        reg.timer("swarm_scheduler_tick_latency").observe(v)
    reg.counter("swarm_planner_groups_device_error", 3)
    reg.counter('swarm_planner_groups{route="device"}', 5)
    reg.counter('swarm_planner_groups{route="breaker"}', 2)
    return reg


def test_health_verdicts_agree(clock):
    results = []
    start = clock[0]
    for pkg in PKGS:
        clock[0] = start
        H = _m(pkg, "obs.health")
        F = _m(pkg, "obs.flightrec")
        ev = H.HealthEvaluator(registry=_seeded_registry(pkg),
                               recorder=F.FlightRecorder(),
                               checks=H.default_checks())
        first = ev.evaluate()
        clock[0] += 1.0
        second = ev.evaluate()
        report = ev.report()
        results.append((first, second, ev.status(), ev.failing(),
                        json.dumps(report, sort_keys=True, default=str)))
    assert results[0] == results[1]
    assert results[1][0]["planner_breaker"] == "fail"
    assert results[1][3] is True


def test_checks_judge_alike():
    for pkg_checks in zip(*(_m(pkg, "obs.health").default_checks()
                            for pkg in PKGS)):
        a, b = pkg_checks
        assert a.name == b.name
        for v in (None, 0.0, 0.5, 1.0, 2.0, 5.0, 31.0, 1e9):
            assert a.judge(v) == b.judge(v), (a.name, v)


# -------------------------------------------------------------- report

def _trace(pkg):
    Tr = _m(pkg, "obs.trace")
    t = [0.0]
    tracer = Tr.Tracer(clock=lambda: t[0])
    tracer.enable()
    for i in range(3):
        with tracer.span("sched.tick", "sched", tick=i):
            t[0] += 0.001
            with tracer.span("plan.dispatch", "plan", tasks=10 * i):
                t[0] += 0.002
            with tracer.span("sched.commit", "sched"):
                t[0] += 0.0005
                tracer.record_complete("plan.inflight", "plan", 0.001)
                t[0] += 0.003
            with tracer.span("plan.d2h", "plan"):
                t[0] += 0.0007
    return tracer.to_chrome()


def test_report_agrees_on_one_trace():
    docs = [_trace(pkg) for pkg in PKGS]
    assert json.dumps(docs[0], sort_keys=True) \
        == json.dumps(docs[1], sort_keys=True)
    doc = docs[1]
    tables = []
    for pkg in PKGS:
        R = _m(pkg, "obs.report")
        table = R.phase_table(doc)
        tables.append((table, R.format_table(table),
                       R.validate_chrome_trace(doc),
                       R.phase_table(doc, window=(0, 4000)),
                       R.format_diff(R.diff_phase_tables(
                           table, R.phase_table(doc, window=(0, 4000))))))
    assert tables[0] == tables[1]
    assert tables[1][2] == []
    assert tables[1][0]["phases"]["sched.tick"]["count"] == 3


@pytest.mark.parametrize("bad", [
    None, {}, {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 1}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": -1, "dur": 2,
                      "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "Q"}]},
])
def test_trace_validation_agrees_on_bad_traces(bad):
    errs = [_m(pkg, "obs.report").validate_chrome_trace(bad)
            for pkg in PKGS]
    assert errs[0] == errs[1]
    assert errs[0]


def test_device_table_agrees():
    art = {"device": {"kernels": {
        "nb1024_cc1_p1_L1_h0": {"route": "group", "calls": 4,
                                "dispatch_s": 0.004, "d2h_s": 0.002,
                                "compile_s": 0.0},
        "fused_g4_nb1024": {"route": "fused", "calls": 2,
                            "dispatch_s": 0.01, "d2h_s": 0.001,
                            "compile_s": 1.5}},
        "transfers": {"h2d": {"group_inputs": 1024}, "d2h": {"fetch": 64}}}}
    out = []
    for pkg in PKGS:
        R = _m(pkg, "obs.report")
        table = R.device_table(art)
        out.append((table, None if table is None
                    else R.format_device_table(table)))
    assert out[0] == out[1]


# ------------------------------------------------------------- sampler

def test_sampler_rows_agree(clock):
    rows = []
    start = clock[0]
    for pkg in PKGS:
        clock[0] = start
        Sa = _m(pkg, "obs.sampler")
        F = _m(pkg, "obs.flightrec")
        reg = _m(pkg, "utils.metrics").Registry()
        reg.counter("swarm_a", 2)
        sampler = Sa.Sampler(registry=reg, recorder=F.FlightRecorder(),
                             deterministic=True)
        reg.counter("swarm_a", 3)
        reg.counter("swarm_b")
        reg.timer("swarm_t").observe(0.25)
        reg.counter("other_c", 9)
        first = sampler.sample()
        clock[0] += 2.0
        reg.counter("swarm_b", 4)
        rows.append((first, sampler.sample()))
    assert rows[0] == rows[1]
    assert rows[1][0]["counters"] == {"swarm_a": 3.0, "swarm_b": 1.0}


# --------------------------------------------------------- volume queue

def test_volume_queue_order_agrees():
    orders = []
    for pkg in PKGS:
        V = _m(pkg, "utils.volumequeue")
        t = [100.0]
        q = V.VolumeQueue(clock=lambda: t[0])
        for vid in ("c", "a", "b"):
            q.enqueue(vid)
        q.enqueue("a")                  # already queued sooner: kept
        q.enqueue("d", retry=True)      # backoff
        q.enqueue("b", retry=True)      # supersedes b's immediate entry?
        order = []
        for _ in range(3):
            order.append(q.wait(timeout=0))
        for step in (0.5, 1.0, 2.0, 4.0, 8.0):
            t[0] += step
            got = q.wait(timeout=0)
            order.append((step, got))
        q.forget("d")
        q.enqueue("d", retry=True)
        t[0] += 60.0
        order.append(q.wait(timeout=0))
        q.close()
        order.append(q.wait(timeout=0))
        orders.append(order)
    assert orders[0] == orders[1]
    assert orders[1][:3] == ["c", "a", "b"]
    assert orders[1][-1] is None


# -------------------------------------------------------- debug pages

def test_debug_pages_installed_on_every_server():
    from swarmkit_tpu_torch import obs
    from swarmkit_tpu_torch.obs import debugpages
    from swarmkit_tpu_torch.utils import httpdebug
    assert debugpages._install in httpdebug._default_endpoint_hooks
    assert set(obs.__all__) == set(_m(REF, "obs").__all__)
    server = httpdebug.DebugServer()
    try:
        for path in ("/debug/trace", "/debug/health", "/debug/flightrec",
                     "/debug/planes", "/debug/device", "/metrics",
                     "/healthz"):
            assert path in server.endpoints, path
            body, code, ctype = server._dispatch(path)
            assert code in (200, 503), (path, code, body[:200])
        body, code, _ = server._dispatch("/debug/trace")
        assert code == 200 and "traceEvents" in json.loads(body)
        index, code, _ = server._dispatch("/")
        assert code == 200 and b"/debug/device" in index
    finally:
        server._server.server_close()
