"""Manager composition: wires every control-plane component and drives
their lifecycle from raft leadership.

Reference: manager/manager.go — server registration :475-563, becomeLeader
:927-1147 / becomeFollower :1150, default cluster/node creation :952-1011,
role manager, cluster-spec watching :801.

All control loops (allocator, scheduler, orchestrators, reaper, enforcers,
keymanager, dispatcher) run **only on the raft leader**; followers keep
only the store + raft + serving surfaces.  In standalone mode (no raft)
the manager is always the leader.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..models.objects import Cluster, Node
from ..models.specs import ClusterSpec
from ..models.types import Annotations, NodeRole
from ..ops import TorchPlanner
from ..orchestrator import (
    ConstraintEnforcer, GlobalOrchestrator, JobsOrchestrator,
    ReplicatedOrchestrator, RestartSupervisor, TaskReaper, VolumeEnforcer,
)
from ..scheduler import Scheduler
from ..security.ca import CAServer, RootCA
from ..state.events import Event, EventSnapshotRestore
from ..state.store import ByName, MemoryStore
from ..utils import new_id
from .allocator import Allocator
from .controlapi import ControlAPI
from .dispatcher import Config_ as DispatcherConfig, Dispatcher
from .keymanager import KeyManager
from .logbroker import LogBroker
from .metrics import Collector
from .rolemanager import RoleManager
from .watchapi import WatchServer

log = logging.getLogger("manager")

DEFAULT_CLUSTER_NAME = "default"


class Manager:
    def __init__(self, store: Optional[MemoryStore] = None,
                 raft_node=None, node_id: Optional[str] = None,
                 root_ca: Optional[RootCA] = None,
                 dispatcher_config: Optional[DispatcherConfig] = None,
                 use_device_scheduler: bool = True,
                 csi_plugins: Optional[dict] = None,
                 secret_plugins: Optional[dict] = None,
                 scheduler_pipeline_depth: Optional[int] = None,
                 device=None):
        """``raft_node``: a state.raft.RaftNode already wired as the
        store's proposer, or None for standalone single-manager mode.
        ``csi_plugins``: name -> CSIPlugin for the CSI controller manager
        (an in-memory plugin named "inmem" is always available).
        ``secret_plugins``: name -> endpoint URL or callable for
        driver-backed secrets (reference: manager/drivers).
        ``scheduler_pipeline_depth``: plan/commit pipeline depth for the
        scheduler (None -> SWARM_PIPELINE_DEPTH, default 2; 1 = serial
        escape hatch).
        ``device``: where the leader's ``TorchPlanner`` runs (None -> the
        card).  It is resolved here, in the caller's thread: leadership
        builds the planner on the leadership worker, which logs a failure
        and goes on, so a missing card would otherwise leave a manager
        running with no scheduler and no loops."""
        self.node_id = node_id or new_id()
        self._scheduler_pipeline_depth = scheduler_pipeline_depth
        self.raft = raft_node
        self.store = store if store is not None else (
            raft_node.store if raft_node is not None else MemoryStore())
        self.root_ca = root_ca or RootCA()
        self.use_device_scheduler = use_device_scheduler
        self.device = device
        if use_device_scheduler:
            from ..ops.convert import resolve_device
            resolve_device(device)
        self._dispatcher_config = dispatcher_config or DispatcherConfig()

        # always-on surfaces (follower-safe; mutations go through the
        # store's proposer so they fail on non-leaders)
        self.control_api = ControlAPI(self.store)
        self.control_api.root_ca = self.root_ca
        self.control_api.health = self.health_check
        self.watch_server = WatchServer(self.store)
        from .drivers import DriverProvider
        self.driver_provider = DriverProvider(secret_plugins)
        self.logbroker = LogBroker(self.store)
        self.ca_server = CAServer(self.root_ca)
        self.collector = Collector(self.store)
        from ..obs import LifecycleTracker, Sampler
        from ..obs.health import evaluator as _health_evaluator
        self.lifecycle = LifecycleTracker(self.store)
        # health/SLO plane + black box: the sampler thread snapshots the
        # registry into the flight recorder and re-judges the SLO checks
        # every interval; /debug/health and /debug/flightrec serve the
        # same shared singletons
        self.sampler = Sampler()
        self.health = _health_evaluator
        self.obs_sample_interval = 2.0

        # leader-only loops, created on become_leader
        self.dispatcher: Optional[Dispatcher] = None
        self.allocator: Optional[Allocator] = None
        self.scheduler: Optional[Scheduler] = None
        self.replicated: Optional[ReplicatedOrchestrator] = None
        self.global_: Optional[GlobalOrchestrator] = None
        self.jobs: Optional[JobsOrchestrator] = None
        self.reaper: Optional[TaskReaper] = None
        self.constraint_enforcer: Optional[ConstraintEnforcer] = None
        self.volume_enforcer: Optional[VolumeEnforcer] = None
        self.keymanager: Optional[KeyManager] = None
        self.role_manager: Optional[RoleManager] = None
        self.csi_manager = None
        self._csi_plugins = dict(csi_plugins or {})

        self._mu = threading.Lock()
        self._running = False
        self._is_leader = False
        # advertised raft-transport addresses of known managers, exchanged
        # through the raft_join RPC so joining managers can dial peers
        self.raft_peer_addrs: dict = {}
        # this manager's own (and any locally-known) remote-API addresses;
        # merged with the raft-replicated set in manager_api_addrs()
        self.api_addrs: dict = {}
        # leadership transitions apply strictly in arrival order: raft can
        # flap faster than loops start/stop, and out-of-order application
        # would leave a live leader with its control loops stopped
        import queue as _queue
        self._leadership_q: "_queue.Queue" = _queue.Queue()
        self._leadership_worker: Optional[threading.Thread] = None
        # fires after a root rotation finalizes (swarmd re-keys the WAL)
        self.on_root_rotated = None
        self._stop_event = threading.Event()
        # fires on any cluster-object change (swarmd re-seals state when
        # the autolock flag/unlock key changes)
        self.on_cluster_changed = None
        self._rotation_thread: Optional[threading.Thread] = None
        self.ca_rotation_check_interval = 1.0

    # ------------------------------------------------------------- lifecycle

    def run(self) -> None:
        self._running = True
        self.collector.start()
        self.lifecycle.start()
        # black-box recording is always on for a live manager: recent
        # spans/samples/store events stay dumpable via /debug/flightrec
        # whatever happens later.  The crash hook turns an unhandled
        # exception in any control-loop thread into a dumped post-mortem
        # (path + sha logged) instead of a silently-dead daemon thread.
        from ..obs.flightrec import flightrec, install_crash_hook
        if not getattr(self, "_crash_hook_installed", False):
            install_crash_hook()
            self._crash_hook_installed = True
        flightrec.enabled = True
        flightrec.watch_store(self.store)
        # the journey ledger rides the recorder's store tap (one watch
        # consumer for both): every member minting milestones from
        # replicated stamps is what lets a journey survive failover
        # stitched (obs/journey.py)
        from ..obs.journey import journeys
        flightrec.journey_sink = journeys.handle_event
        journeys.enabled = True
        self.sampler.rebase()
        self.sampler.start(interval=self.obs_sample_interval,
                           on_sample=self.health.evaluate)
        if self.raft is None:
            self._ensure_cluster_object()
            self._become_leader()
        else:
            self.raft.on_leadership = self._on_leadership
            if self.raft.is_leader:
                self._on_leadership(True)
            # followers adopt replicated CA state (key + join tokens) as
            # the cluster object arrives/changes, so they can validate
            # join tokens and certs without ever having led (reference:
            # every manager loads the cluster's security config)
            self._ca_sub = self.store.queue.subscribe(
                lambda ev: isinstance(ev, EventSnapshotRestore)
                or (isinstance(ev, Event) and isinstance(ev.obj, Cluster)),
                accepts_blocks=True)   # blocks are never cluster events
            # baseline digest = the root the daemon booted with, so even
            # the FIRST adoption fires the re-key hook when the replayed
            # cluster state carries a different (rotated) root
            self._adopted_root_digest = self.root_ca.digest
            self._adopt_ca_state()
            self._ca_worker = threading.Thread(
                target=self._ca_adoption_loop, name="ca-adoption",
                daemon=True)
            self._ca_worker.start()
        self._running = True

    def _restore_root_from_state(self, state) -> None:
        """Adopt persisted trust-root material incl. any in-progress
        rotation (single source of truth for both adoption paths)."""
        self.root_ca.restore(state.ca_key, state.ca_cert)
        self.root_ca.restore_join_tokens(state.join_tokens)
        if state.root_rotation_in_progress and state.rotation_ca_key:
            self.root_ca.restore_rotation(
                state.rotation_ca_key, state.rotation_ca_cert,
                state.cross_signed_ca_cert)
        elif self.root_ca.rotation is not None:
            self.root_ca.rotation = None

    def _adopt_ca_state(self) -> None:
        clusters = self.store.view(
            lambda tx: tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)))
        if not clusters:
            return
        state = clusters[0].root_ca
        if state is not None and state.ca_key:
            # the baseline is the root the daemon BOOTED with (seeded in
            # run()): a restart that replays an already-finalized
            # rotation from the WAL must still re-key local material
            prev_digest = getattr(self, "_adopted_root_digest", None)
            self._restore_root_from_state(state)
            self._adopted_root_digest = self.root_ca.digest
            if (prev_digest is not None
                    and prev_digest != self._adopted_root_digest
                    and self.on_root_rotated is not None):
                try:
                    self.on_root_rotated()
                except Exception:
                    log.exception("root-rotation hook failed")

    def _ca_adoption_loop(self) -> None:
        while self._running:
            try:
                ev = self._ca_sub.get(timeout=0.5)
            except TimeoutError:
                continue
            except Exception:
                return   # queue closed (Closed) or shutdown
            if ev is None:
                continue
            try:
                self._adopt_ca_state()
                self._apply_ca_config()   # followers issue on renewal too
            except Exception:
                log.exception("CA state adoption failed")
            hook = self.on_cluster_changed
            if hook is not None:
                try:
                    hook()
                except Exception:
                    log.exception("cluster-change hook failed")

    def stop(self) -> None:
        self._running = False
        self._stop_event.set()
        if getattr(self, "_ca_sub", None) is not None:
            self.store.queue.unsubscribe(self._ca_sub)
            self._ca_sub = None
        self._become_follower()
        self.sampler.stop()
        from ..obs.flightrec import flightrec, uninstall_crash_hook
        # uninstall exactly the reference this instance took: a double
        # stop() (or stop() without run()) must not strip a co-resident
        # manager's hook out from under it (the ref count pairs 1:1)
        if getattr(self, "_crash_hook_installed", False):
            self._crash_hook_installed = False
            uninstall_crash_hook()
        flightrec.unwatch_store(self.store)
        self.collector.stop()
        self.lifecycle.stop()
        self.logbroker.close()

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def _on_leadership(self, leader: bool) -> None:
        """raft leadership callback (runs on the raft thread)."""
        with self._mu:
            if self._leadership_worker is None \
                    or not self._leadership_worker.is_alive():
                self._leadership_worker = threading.Thread(
                    target=self._leadership_loop, name="leadership",
                    daemon=True)
                self._leadership_worker.start()
        self._leadership_q.put(leader)

    def _leadership_loop(self) -> None:
        import queue as _queue
        while self._running or not self._leadership_q.empty():
            try:
                leader = self._leadership_q.get(timeout=0.5)
            except _queue.Empty:
                continue
            # collapse bursts to the latest state
            while True:
                try:
                    leader = self._leadership_q.get_nowait()
                except _queue.Empty:
                    break
            try:
                if leader:
                    self._become_leader_safe()
                else:
                    self._become_follower()
            except Exception:
                log.exception("leadership transition failed")

    def _become_leader_safe(self) -> None:
        try:
            self._ensure_cluster_object()
            self._become_leader()
        except Exception:
            log.exception("becoming leader failed")

    def _ensure_cluster_object(self) -> None:
        """Create the default cluster (+ its join tokens) on first
        leadership (reference: manager.go:952-1011)."""
        def cb(tx):
            existing = tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME))
            if existing:
                # adopt the persisted trust root: a fresh random RootCA
                # would invalidate every issued cert and join token
                state = existing[0].root_ca
                if state is not None and state.ca_key:
                    self._restore_root_from_state(state)
                return
            cluster = Cluster(
                id=new_id(),
                spec=ClusterSpec(annotations=Annotations(
                    name=DEFAULT_CLUSTER_NAME)))
            from ..models.objects import RootCAState
            from ..models.types import JoinTokens
            cluster.root_ca = RootCAState(
                ca_key=self.root_ca.key,
                ca_cert=self.root_ca.cert_pem,
                join_tokens=JoinTokens(
                    worker=self.root_ca.join_token(NodeRole.WORKER),
                    manager=self.root_ca.join_token(NodeRole.MANAGER)))
            tx.create(cluster)

        try:
            self.store.update(cb)
        except Exception:
            log.exception("ensuring cluster object failed")

    def _become_leader(self) -> None:
        """reference: manager.go:927 becomeLeader."""
        with self._mu:
            if self._is_leader:
                return
            self._is_leader = True
            log.info("manager %s became leader", self.node_id[:8])
            restarts = RestartSupervisor(self.store)
            self.dispatcher = Dispatcher(
                self.store, self._dispatcher_config,
                driver_provider=self.driver_provider)
            # agents publish task logs through their dispatcher surface;
            # the CLI reads them back via the control api
            self.dispatcher.log_broker = self.logbroker
            self.control_api.log_broker = self.logbroker
            self.dispatcher.run()
            self.allocator = Allocator(self.store)
            planner = (TorchPlanner(device=self.device)
                       if self.use_device_scheduler else None)
            self.scheduler = Scheduler(
                self.store, batch_planner=planner,
                pipeline_depth=self._scheduler_pipeline_depth)
            self.replicated = ReplicatedOrchestrator(self.store,
                                                     restarts=restarts)
            self.global_ = GlobalOrchestrator(self.store, restarts=restarts)
            self.jobs = JobsOrchestrator(self.store, restarts=restarts)
            self.reaper = TaskReaper(self.store)
            self.constraint_enforcer = ConstraintEnforcer(self.store)
            self.volume_enforcer = VolumeEnforcer(self.store)
            self.keymanager = KeyManager(self.store)
            self.role_manager = RoleManager(self.store,
                                            raft_node=self.raft)
            # CSI controller manager: drives volume create/publish/delete
            # from store events (reference: manager.go:1077 csi manager).
            # Plugins come from the constructor; an in-memory plugin named
            # "inmem" is always registered so volume lifecycles are
            # drivable out of the box (the image has no real CSI drivers).
            from .csi import InMemoryCSIPlugin, Manager as CSIManager
            plugins = dict(self._csi_plugins)
            plugins.setdefault("inmem", InMemoryCSIPlugin("inmem"))
            self.csi_manager = CSIManager(self.store, plugins=plugins)
            from .deallocator import Deallocator
            self.deallocator = Deallocator(self.store)
            # horizontal autoscaler: production mode wraps one thread;
            # the deterministic sim builds its own threadless supervisor
            from ..orchestrator.autoscaler import (
                Supervisor as AutoscaleSupervisor,
            )
            self.autoscaler = AutoscaleSupervisor(self.store)
            self.autoscaler.start()
            for loop in (self.allocator, self.scheduler, self.replicated,
                         self.global_, self.jobs, self.reaper,
                         self.constraint_enforcer, self.volume_enforcer,
                         self.keymanager, self.role_manager,
                         self.csi_manager, self.deallocator):
                loop.start()
            if self._rotation_thread is None \
                    or not self._rotation_thread.is_alive():
                self._rotation_thread = threading.Thread(
                    target=self._ca_rotation_loop, name="ca-rotation",
                    daemon=True)
                self._rotation_thread.start()

    def _ca_rotation_loop(self) -> None:
        """Root-rotation reconciler (reference: ca/reconciler.go): while
        a rotation is in progress, wait for every live node's cert to
        chain to the new root (issuer digests recorded from the agents'
        TLS identities at heartbeat), then finalize — new root becomes
        THE root, tokens re-derive, and persisted state flips over."""
        while self._running and self._is_leader:
            try:
                self._apply_ca_config()
                if self.root_ca.rotation is not None:
                    self._reconcile_ca_rotation()
            except Exception:
                log.exception("CA rotation reconciliation failed")
            self._stop_event.wait(self.ca_rotation_check_interval)

    def _apply_ca_config(self) -> None:
        """Live-apply ClusterSpec.ca_config to the signing CA:
        node_cert_expiry and external signer URLs (reference:
        ca/server.go UpdateRootCA reacting to CAConfig, ca/external.go)."""
        clusters = self.store.view(
            lambda tx: tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME)))
        if not clusters:
            return
        cfg = clusters[0].spec.ca_config
        expiry = cfg.node_cert_expiry
        if expiry > 0 and expiry != self.root_ca.node_cert_expiry:
            log.info("node cert expiry set to %.0fs from cluster spec",
                     expiry)
            self.root_ca.node_cert_expiry = expiry
        urls = [u for u in (cfg.external_cas or []) if u]
        current = self.ca_server.external
        current_urls = current.urls if current is not None else []
        if urls != current_urls:
            if urls:
                from ..security.external import ExternalCA
                self.ca_server.external = ExternalCA(
                    urls, org=self.root_ca.org,
                    ca_cert_pem=self.root_ca.cert_pem)
                log.info("external CA signing enabled: %s", urls)
            else:
                self.ca_server.external = None
                log.info("external CA signing disabled")

    def _reconcile_ca_rotation(self) -> None:
        from ..models.types import NodeState
        target = self.root_ca.active_digest
        nodes = self.store.view(lambda tx: tx.find(Node))
        for n in nodes:
            if n.status.state == NodeState.DOWN:
                continue   # down nodes cannot renew; operators remove them
            if n.certificate_issuer != target:
                return   # still waiting
        log.info("root CA rotation complete; finalizing")
        rotation = self.root_ca.rotation
        if rotation is None:
            return
        new_key, new_cert, _ = rotation
        # persist FIRST, then flip the in-memory root: the CA-adoption
        # thread may interleave, and it must only ever observe either
        # the in-progress state or the fully finalized one
        from ..security.ca import cert_digest
        new_digest = cert_digest(new_cert)

        def new_token(role: NodeRole) -> str:
            secret = self.root_ca._token_secrets[role]
            import base64 as _b64
            return "-".join([
                "SWMTKN-1", new_digest,
                _b64.b32encode(secret).decode("ascii")
                .strip("=").lower()])

        def cb(tx):
            clusters = tx.find(Cluster, ByName(DEFAULT_CLUSTER_NAME))
            if not clusters:
                return
            cluster = clusters[0].copy()
            state = cluster.root_ca
            if state is None:
                return
            state.ca_key = new_key
            state.ca_cert = new_cert
            state.rotation_ca_key = b""
            state.rotation_ca_cert = b""
            state.cross_signed_ca_cert = b""
            state.root_rotation_in_progress = False
            # token digests derive from the root cert: re-mint so the
            # persisted strings match what role_for_token validates
            from ..models.types import JoinTokens
            state.join_tokens = JoinTokens(
                worker=new_token(NodeRole.WORKER),
                manager=new_token(NodeRole.MANAGER))
            tx.update(cluster)

        self.store.update(cb)
        self.root_ca.finalize_rotation()
        hook = self.on_root_rotated
        if hook is not None:
            try:
                hook()
            except Exception:
                log.exception("root-rotation hook failed")

    def health_check(self, service: str = "") -> str:
        """Health RPC (reference: manager/health/health.go Check,
        api/health.proto:17): SERVING / NOT_SERVING / UNKNOWN.  The
        empty service means "the manager"; "raft" reports consensus
        membership health like the reference's Raft service."""
        if service in ("", "manager"):
            return "SERVING" if self._running else "NOT_SERVING"
        if service == "raft":
            if self.raft is None:
                return "SERVING"   # standalone: no consensus to be in
            if not self._running or self.raft.core.removed:
                return "NOT_SERVING"
            return "SERVING"
        return "UNKNOWN"

    def manager_api_addrs(self) -> list:
        """Remote-API addresses of all known managers (replicated via
        conf entries), distributed to agents in heartbeat responses so
        they can fail over (reference: session Message.Managers)."""
        addrs = {}
        if self.raft is not None:
            addrs.update(self.raft.core.api_addrs)
        addrs.update(self.api_addrs)
        return [list(a) for a in addrs.values()]

    def join_raft(self, node_id: str, addr=None, api_addr=None) -> dict:
        """Leader-side manager join: adds the caller to the raft group
        and returns the known peer transport addresses (reference:
        raft.go:926 Join RPC; called by a promoted node's manager at
        startup).  The caller must hold a MANAGER certificate — enforced
        by the network layer."""
        import base64
        if self.raft is None:
            raise RuntimeError("standalone manager has no raft group")
        if not self.raft.is_leader:
            # only the leader can change membership; hand the caller the
            # leader's API address when we know it (reference: raft.go
            # Join forwards to the leader)
            leader = self.raft.leader_id
            redirect = self.raft.core.api_addrs.get(leader)
            if redirect is not None:
                return {"redirect": list(redirect)}
            raise RuntimeError(
                "not the raft leader and the leader's API address is "
                "unknown; retry against the leader")
        # membership only changes on the hop that carries the joiner's
        # transport address: the address-less first hop (which fetches the
        # CA key before the joiner can even bind its transport) must not
        # add a member that may never start — a dead phantom peer would
        # wedge quorum permanently on small clusters
        if addr is not None and node_id not in self.raft.core.peers:
            # a still-valid MANAGER cert is not enough when the store
            # says the node is (again) a worker — a join racing a
            # demotion must not commit a phantom voter (the role manager
            # flips the role to MANAGER before a node can ever promote,
            # so a registered joiner's record always agrees)
            from ..models.objects import Node as NodeObject
            from ..models.types import NodeRole as _NR
            rec = self.store.view(lambda tx: tx.get(NodeObject, node_id))
            if rec is not None and _NR(rec.role) != _NR.MANAGER:
                raise PermissionError(
                    f"node {node_id} has role {_NR(rec.role).name}; "
                    "promote it before joining raft")
            self.raft.add_member(node_id, tuple(addr),
                                 tuple(api_addr) if api_addr else None)
        members = {k: list(v) for k, v in self.raft_peer_addrs.items()}
        # replicated addresses (conf entries/snapshots) are authoritative
        members.update({k: list(v)
                        for k, v in self.raft.core.peer_addrs.items()})
        if addr is not None:
            members[node_id] = list(addr)
            self.raft_peer_addrs[node_id] = tuple(addr)
        # managers co-hold the cluster root key (the reference ships CA
        # material to joining managers via the certificate response,
        # ca/certificates.go); the RPC is MANAGER-cert gated
        return {"members": members,
                "ca_key": base64.b64encode(self.root_ca.key).decode(),
                "ca_cert": base64.b64encode(
                    self.root_ca.cert_pem).decode()}

    def _become_follower(self) -> None:
        """reference: manager.go:1150 becomeFollower."""
        with self._mu:
            if not self._is_leader:
                return
            self._is_leader = False
            # a follower's broker receives nothing (agents publish to
            # the leader): collect_logs must fail loudly, not block then
            # return empty
            self.control_api.log_broker = None
            log.info("manager %s lost leadership", self.node_id[:8])
            loops = [getattr(self, "autoscaler", None),
                     getattr(self, "deallocator", None),
                     self.csi_manager, self.role_manager,
                     self.keymanager, self.volume_enforcer,
                     self.constraint_enforcer, self.reaper, self.jobs,
                     self.global_, self.replicated, self.scheduler,
                     self.allocator]
            for loop in loops:
                if loop is not None:
                    try:
                        loop.stop()
                    except Exception:
                        log.exception("stopping %r failed", loop)
            if self.dispatcher is not None:
                try:
                    # flush buffered agent status updates only while the
                    # proposer can still commit them: standalone always,
                    # raft only if we are STILL the leader (a graceful
                    # shutdown of a live leader must not drop reported
                    # states).  On genuine deposal the epoch is fenced
                    # and the flush would only raise — the successor's
                    # dispatcher re-learns task state from the agents'
                    # re-registration.
                    self.dispatcher.stop(
                        flush=self.raft is None or self.raft.is_leader)
                except Exception:
                    log.exception("stopping dispatcher failed")
            self.dispatcher = self.allocator = self.scheduler = None
            self.replicated = self.global_ = self.jobs = None
            self.autoscaler = None
            self.csi_manager = None
            self.deallocator = None
            self.reaper = None
            self.constraint_enforcer = self.volume_enforcer = None
            self.keymanager = None
            self.role_manager = None
