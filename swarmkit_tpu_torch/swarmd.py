"""swarmd: the node daemon — run a manager, join as a worker, or both.

Reference: swarmd/cmd/swarmd/main.go (state-dir, join-addr/token,
listen-remote-api flags; node.New/Start wiring).

    # first manager (bootstraps the cluster, prints join tokens)
    python -m swarmkit_tpu_torch.swarmd --manager --state-dir /tmp/m0 \
        --listen-remote-api 127.0.0.1:4242

    # worker joining it
    python -m swarmkit_tpu_torch.swarmd --state-dir /tmp/w0 \
        --join-addr 127.0.0.1:4242 --join-token SWMTKN-1-...

    # second manager joining the raft group (manager token)
    python -m swarmkit_tpu_torch.swarmd --manager --state-dir /tmp/m1 \
        --join-addr 127.0.0.1:4242 --join-token SWMTKN-1-<manager> \
        --listen-remote-api 127.0.0.1:4243
"""

from __future__ import annotations

import argparse
import logging
import random
import threading
import time
from typing import Optional, Tuple

from .models.types import now as _seam_now

log = logging.getLogger("swarmd")


class ManagerLockedError(Exception):
    """The manager's key material is sealed under an unlock key the
    daemon was not given (reference: autolock, manager.go:116-120)."""


def parse_addr(text: str) -> Tuple[str, int]:
    host, _, port = text.rpartition(":")
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        raise SystemExit(
            f"invalid address {text!r}: expected host:port")


class Swarmd:
    """One node process: always an agent; a manager when --manager."""

    def __init__(self, state_dir: str, hostname: str = "",
                 manager: bool = False,
                 listen_remote_api: Optional[Tuple[str, int]] = None,
                 join_addr: Optional[Tuple[str, int]] = None,
                 join_token: str = "",
                 executor=None,
                 use_device_scheduler: bool = True,
                 migrate_plaintext_wal: bool = False,
                 cert_renew_interval: float = 60.0,
                 unlock_key: str = "",
                 force_new_cluster: bool = False,
                 listen_metrics: Optional[Tuple[str, int]] = None,
                 clock=None, rng: Optional[random.Random] = None,
                 device=None):
        import os

        from .agent.testutils import TestExecutor

        self.state_dir = state_dir
        self.hostname = hostname or state_dir.rstrip("/").rsplit("/", 1)[-1]
        if executor == "process":
            from .agent.procexec import ProcessExecutor
            # task logs live under the state dir, cleaned with node state
            executor = ProcessExecutor(
                hostname=self.hostname,
                log_dir=os.path.join(state_dir, "task-logs"))
        elif executor == "test":
            executor = TestExecutor(hostname=self.hostname)
        self.is_manager = manager
        self.listen_remote_api = listen_remote_api
        self.join_addr = join_addr
        self.join_token = join_token
        self.executor = executor or TestExecutor(hostname=self.hostname)
        self.use_device_scheduler = use_device_scheduler
        # where every Manager this daemon builds runs its leader's
        # TorchPlanner (None -> the card).  Resolved here, in the caller's
        # thread: a runtime promotion builds its Manager on the role
        # watcher, which logs a failure and retries forever
        self.device = device
        if use_device_scheduler:
            from .ops.convert import resolve_device
            resolve_device(device)
        # one-time replay of a state dir written before WAL encryption
        # existed (--migrate-plaintext-wal); steady state fails closed
        self.migrate_plaintext_wal = migrate_plaintext_wal
        # how often the renewer thread re-checks cert lifetime (the
        # renewal itself triggers past half of validity)
        self.cert_renew_interval = cert_renew_interval
        # operator-held unlock key (autolock): required to open a sealed
        # manager state dir; '' means not provided
        self.unlock_key = unlock_key
        self.locked = False
        # quorum-loss recovery: rebuild a single-member raft from this
        # node's WAL/snapshot (reference: manager.go:99-101)
        self.force_new_cluster = force_new_cluster
        # operator observability HTTP listener (reference: swarmd
        # --listen-metrics, main.go:92-97)
        self.listen_metrics = listen_metrics
        self.metrics_server = None
        self._stop_event = threading.Event()
        self.manager = None
        self.server = None
        self.node = None
        self.raft_node = None
        self.raft_transport = None
        # raft member id: "m-<hostname>" for nodes started as managers; a
        # worker promoted at runtime keeps its node id (the reference uses
        # one node id for both roles, node/node.go:286)
        self.raft_id = "m-" + self.hostname
        # serializes role transitions against stop() and each other
        self._role_mu = threading.Lock()
        # injected clock/rng seams (matching Agent(rng=)): deadlines and
        # reconnect/role-retry backoff read through these so tests and
        # the simulator control them; production defaults are the
        # models.types.now() seam and a per-process unseeded rng
        self._clock = clock or _seam_now
        self._rng = rng or random.Random()

    def start(self) -> None:
        from .node import Node

        if self.listen_metrics is not None:
            from . import obs  # noqa: F401  (registers /debug/* endpoints)
            from .utils.httpdebug import DebugServer
            def health() -> str:
                if self.manager is not None:
                    return self.manager.health_check()
                if self.locked or self.is_manager:
                    return "NOT_SERVING"
                # worker: healthy only while its agent session is live
                node = self.node
                agent = node.agent if node is not None else None
                if agent is None:
                    return "NOT_SERVING"
                return ("SERVING" if agent.session_id
                        else "NOT_SERVING")

            self.metrics_server = DebugServer(
                host=self.listen_metrics[0], port=self.listen_metrics[1],
                health=health)
            self.metrics_server.start()
            log.info("metrics/debug HTTP on %s:%d",
                     *self.metrics_server.addr)

        if not self.is_manager and self.join_addr is not None:
            import os as _os
            if _os.path.exists(self._manager_state_path()):
                # promoted to manager at runtime in a previous life: come
                # back up as that manager (reference: node.go:983
                # runManager restarts from the persisted role)
                self.is_manager = True

        if self.is_manager and self.join_addr is not None:
            self._start_joining_manager()
            return

        if self.is_manager:
            from .security import RootCA

            # a manager is raft-backed from the start so later managers
            # can join its group over the raft_join RPC (reference:
            # manager.go:217 becomes the raft founder).  A restart reuses
            # the persisted CA key + raft listen port: peers know us by
            # that address, and the transport HMAC key must match theirs.
            try:
                state = self._load_manager_state()
            except ManagerLockedError as e:
                # autolock: refuse to serve anything until unlock()
                self.locked = True
                log.warning("manager locked: %s", e)
                return
            ca = (RootCA(state["ca_key"], state["ca_cert"])
                  if state else RootCA())
            self._prev_ca_key = state.get("prev_ca_key") if state else None
            raft_port = state["raft_port"] if state else 0
            api_port = state["api_port"] if state else 0
            self._build_raft_manager(ca, raft_port=raft_port)
            # fresh bootstrap (or lone survivor): we must become leader;
            # a restarted member of a larger group follows whoever leads
            if len(self.raft_node.core.peers) == 1:
                self._wait(lambda: self.raft_node.is_leader
                           and self.raft_node.core.leader_ready,
                           "bootstrap raft never elected")
                self._wait(lambda: self.manager.is_leader
                           and self.manager.dispatcher is not None,
                           "manager never took leadership")
                # restart adoption may swap in the persisted cluster's
                # trust root: re-key both the HMAC fallback and the TLS
                # identity so peers on the adopted root accept us
                self.raft_transport.auth_key = self.manager.root_ca.key
                if self.raft_transport.tls_identity is not None:
                    from .models.types import NodeRole as _NR
                    self.raft_transport.set_identity(
                        self.manager.root_ca.issue(
                            self.raft_id, _NR.MANAGER))
            self._start_remote_api(port_override=api_port)
            if self.server is not None:
                self.manager.api_addrs[self.raft_id] = self.server.addr
                if self.raft_node.is_leader:
                    # replicate our API address so agents can fail over
                    # to us and followers can redirect joins
                    self.raft_node.add_member(
                        self.raft_id, self.raft_transport.addr,
                        self.server.addr)
            self._save_manager_state()
            self._start_manager_agent()
            self._start_manager_identity_renewer()
            self._start_role_watcher()
            if self.manager.is_leader:
                log.info("manager up; worker join token: %s",
                         self.manager.root_ca.join_token(0))
                log.info("manager join token: %s",
                         self.manager.root_ca.join_token(1))
            return

        import os as _os

        from .net import issue_certificate
        from .remotes import (
            ConnectionBroker, FailoverDispatcherClient, PersistentRemotes,
        )
        from .security.ca import SecurityError

        # reuse a persisted identity when present, else join with the token
        self.node = Node(self.executor, self.state_dir)
        cert = None
        try:
            cert, _ = self.node.key_rw.read()
        except (FileNotFoundError, SecurityError):
            pass
        if cert is None and (self.join_addr is None
                             or not self.join_token):
            # restarts ride the persisted identity + remotes; a FIRST
            # join needs the operator's addr+token (reference:
            # node/node.go — JoinAddr only required without stored state)
            raise SystemExit(
                "worker mode needs --join-addr and --join-token")
        if cert is not None and self.join_addr is not None \
                and not self._cert_accepted(cert):
            # a cert from a rebuilt/foreign cluster would make every
            # register() fail with an application-level SecurityError the
            # failover client rightly never retries around — fall back to
            # the operator's join token instead (node.py load_or_join does
            # the same verify-then-rejoin dance against a local CA)
            cert = None
        if cert is None:
            if self.join_addr is None or not self.join_token:
                # the persisted cert was rejected (rebuilt/foreign
                # cluster) and there is nothing to re-join with
                raise SystemExit(
                    "worker mode needs --join-addr and --join-token")
            cert = issue_certificate(self.join_addr, self.node.node_id,
                                     self.join_token)
            self.node.key_rw.write(cert, b"")
        self.node.certificate = cert
        self.node.node_id = cert.node_id
        # weighted failover across known managers, persisted across
        # restarts (reference: node/node.go:1202 persistentRemotes) and
        # seeded with the join address; managers learned from heartbeats
        # are observed into the set and survive the next restart
        seeds = [self.join_addr] if self.join_addr is not None else []
        self.remotes = PersistentRemotes(
            _os.path.join(self.state_dir, "state.json"), *seeds)
        if not self.remotes.weights():
            # persisted identity but no persisted managers and no seed:
            # the agent could only spin on NoSuchRemote forever
            raise SystemExit(
                "no known managers: pass --join-addr (persisted remotes "
                "state.json is empty)")
        client = FailoverDispatcherClient(
            ConnectionBroker(self.remotes), cert)
        self.node.start(client, hostname=self.hostname)
        self._start_cert_renewer(client)
        self._start_role_watcher()
        log.info("worker %s joined %s", self.node.node_id[:8],
                 self.join_addr)

    def _start_cert_renewer(self, client) -> None:
        """Client-side certificate renewal loop (reference: ca/renewer.go
        + certificates.go RequestAndSaveNewCertificates): past half of
        validity, send a fresh CSR to a live manager, persist the new
        identity and swap it in for future connections."""
        from .security.ca import needs_renewal

        def loop():
            from .security.ca import signing_root_digest
            while not self._stop_event.wait(self.cert_renew_interval):
                cert = self.node.certificate
                if cert is None:
                    continue
                # renew at half-life, or immediately when the managers
                # advertise a different root (CA rotation in progress)
                advertised = getattr(client, "last_ca_digest", "") or ""
                rotated = (advertised
                           and advertised != signing_root_digest(cert))
                if not needs_renewal(cert) and not rotated:
                    continue
                fresh = self._renew_via_managers(cert)
                if fresh is not None:
                    self._swap_node_cert(fresh, client)
                    log.info("renewed certificate for %s (expires %.0f)",
                             fresh.node_id[:8], fresh.expires_at)

        threading.Thread(target=loop, name="cert-renewer",
                         daemon=True).start()

    def _renew_via_managers(self, cert):
        """One renewal pass over every reachable manager; returns the
        fresh certificate or None.  The server issues for the node's
        STORE role, so the result also carries promotions/demotions."""
        from .net.client import renew_certificate

        targets = []
        remotes = getattr(self, "remotes", None)
        if remotes is not None:
            targets += list(remotes.weights())
        if self.join_addr is not None and self.join_addr not in targets:
            targets.append(self.join_addr)
        for addr in targets:
            if self._stop_event.is_set():
                return None   # don't hold role transitions across stop()
            try:
                return renew_certificate(addr, cert)
            except Exception as e:
                log.info("cert renewal via %s failed: %s", addr, e)
        return None

    def _swap_node_cert(self, fresh, client) -> None:
        """Persist + activate a renewed identity: future connections
        present the fresh cert (the factory closes over
        client.certificate); drop the live connection so the next
        heartbeat handshakes with the new identity (the leader records
        its issuer for rotation progress)."""
        self.node.key_rw.write(fresh, b"")
        self.node.certificate = fresh
        if client is not None:
            client.certificate = fresh
            reset = getattr(client, "reset_connection", None)
            if reset is not None:
                reset()

    # ------------------------------------------------- runtime role changes

    def _start_role_watcher(self) -> None:
        """React to promotion/demotion decided by the leader's role
        manager.  The node's store-reconciled role rides on every
        heartbeat response; on a mismatch with what we are running, renew
        the certificate (the CA issues for the store role) and start or
        stop the manager component (reference: node/node.go:483
        superviseManager, :947 waitRole, :1086 role-change teardown)."""
        if getattr(self, "_role_watcher_started", False):
            return
        self._role_watcher_started = True
        from .models.types import NodeRole

        from .remotes import backoff_with_jitter

        def loop():
            attempt, next_try = 0, 0.0
            while not self._stop_event.wait(0.5):
                node = self.node
                agent = node.agent if node is not None else None
                cert = node.certificate if node is not None else None
                if agent is None or cert is None:
                    continue
                client = agent.client
                role = getattr(client, "last_role", None)
                if role is None:
                    continue
                try:
                    role = NodeRole(role)
                except ValueError:
                    continue
                wants_promote = (role == NodeRole.MANAGER
                                 and self.manager is None)
                wants_demote = (role == NodeRole.WORKER
                                and self.manager is not None)
                if not wants_promote and not wants_demote:
                    attempt, next_try = 0, 0.0   # settled: reset
                    continue
                if self._clock() < next_try:
                    continue
                try:
                    with self._role_mu:
                        if self._stop_event.is_set():
                            continue
                        if wants_promote and self.manager is None:
                            self._promote_to_manager(client)
                        elif wants_demote and self.manager is not None:
                            self._demote_to_worker(client)
                    attempt, next_try = 0, 0.0
                except Exception:
                    # a failed attempt redials managers and (for
                    # promotion) rebuilds a whole stack — back off with
                    # full jitter through the injected clock/rng seams
                    # instead of churning twice a second (and instead
                    # of a whole fleet retrying in lockstep)
                    delay = backoff_with_jitter(attempt, rng=self._rng,
                                                base=0.5, cap=30.0)
                    log.exception("role transition failed; retrying in "
                                  "%.1fs", delay)
                    next_try = self._clock() + delay
                    attempt += 1

        threading.Thread(target=loop, name="role-watcher",
                         daemon=True).start()

    def _promote_to_manager(self, client) -> None:
        """Runtime worker→manager transition: renew into a MANAGER cert,
        join the raft group under our existing node id, and start the
        Manager composition beside the running agent (reference:
        node/node.go:1099 superviseManager starting runManager)."""
        import base64

        from .models.types import NodeRole
        from .net import join_raft
        from .security import RootCA

        cert = self.node.certificate
        if NodeRole(cert.role) != NodeRole.MANAGER:
            fresh = self._renew_via_managers(cert)
            if fresh is None or NodeRole(fresh.role) != NodeRole.MANAGER:
                raise RuntimeError(
                    "could not obtain a manager certificate")
            self._swap_node_cert(fresh, client)
            cert = fresh
        self.raft_id = self.node.node_id
        boot = join_via = None
        for addr in list(self.remotes.weights()):
            if self._stop_event.is_set():
                raise RuntimeError("daemon stopping; promotion aborted")
            try:
                boot = join_raft(addr, cert, self.raft_id)
                join_via = addr
                break
            except Exception as e:
                log.info("raft bootstrap hop via %s failed: %s", addr, e)
        if boot is None:
            raise RuntimeError("no manager reachable for raft join")
        ca = RootCA(base64.b64decode(boot["ca_key"]),
                    base64.b64decode(boot["ca_cert"]))
        had_listen = self.listen_remote_api
        try:
            self._build_raft_manager(ca, raft_port=0, defer_start=True)
            if self.listen_remote_api is None:
                # a manager serves the remote API (joins/control/failover)
                self.listen_remote_api = ("127.0.0.1", 0)
            self._start_remote_api()
            self._complete_raft_join(join_via, cert)
        except Exception:
            # roll the half-built stack back so the watcher's retry gate
            # (self.manager is None) re-arms and ports don't leak.  If
            # the address-carrying hop already committed our membership,
            # the committed voter survives this rollback — the watcher's
            # retry re-adopts it (the leader's join_raft is idempotent
            # for existing members); should this node die for good
            # instead, the operator demotes it like any dead manager
            # (covered by the demote-a-downed-manager flow)
            self._teardown_manager_stack()
            self.listen_remote_api = had_listen
            raise
        if self.server is not None:
            self.manager.api_addrs[self.raft_id] = self.server.addr
        self._save_manager_state()
        self.is_manager = True
        self._start_manager_identity_renewer()
        log.info("node %s promoted to manager; raft group %s",
                 self.raft_id[:8], sorted(self.raft_node.core.peers))

    def _complete_raft_join(self, join_via, cert) -> None:
        """The address-carrying join hop plus peer seeding and startup —
        the one join protocol shared by a fresh `--manager --join-addr`
        daemon and a runtime promotion (reference: manager.go
        JoinAndStart -> Join RPC)."""
        from .net import join_raft

        resp = None
        for attempt in range(20):
            if self._stop_event.is_set():
                raise RuntimeError("daemon stopping; join aborted")
            try:
                resp = join_raft(
                    join_via, cert, self.raft_id,
                    raft_addr=self.raft_transport.addr,
                    api_addr=self.server.addr if self.server else None)
                break
            except Exception as e:
                # the leader serializes membership changes; concurrent
                # joins are a normal, momentary condition
                log.info("raft join attempt %d failed (%s); retrying",
                         attempt + 1, e)
                self._stop_event.wait(0.5)
        if resp is None:
            raise RuntimeError("could not join the raft group")
        for nid, addr in resp["members"].items():
            if nid != self.raft_id and addr is not None:
                self.raft_transport.set_peer(nid, tuple(addr))
                self.raft_node.core.peers.add(nid)
                self.raft_node.core.peer_addrs[nid] = tuple(addr)
        self.raft_node.start()
        self.manager.run()

    def _demote_to_worker(self, client) -> None:
        """Runtime manager→worker transition.  The leader's role manager
        removes us from raft BEFORE flipping the observed role
        (raft-first demotion), so by the time the heartbeat says WORKER
        our membership is already gone: tear down the manager stack, keep
        the agent running on a WORKER cert (reference: node/node.go:1086
        "role changed to worker, stopping manager")."""
        from .models.types import NodeRole

        cert = self.node.certificate
        if NodeRole(cert.role) != NodeRole.WORKER:
            fresh = self._renew_via_managers(cert)
            if fresh is None or NodeRole(fresh.role) != NodeRole.WORKER:
                raise RuntimeError("could not obtain a worker certificate")
            self._swap_node_cert(fresh, client)
        self._teardown_manager_stack()
        self.is_manager = False
        log.info("manager %s demoted; continuing as worker",
                 self.node.node_id[:8])

    def _teardown_manager_stack(self) -> None:
        """Stop and clear this daemon's manager components and drop their
        on-disk state (a restart must come back as a worker; replaying a
        stale WAL would resurrect a phantom peer)."""
        import os
        import shutil

        server, self.server = self.server, None
        manager, self.manager = self.manager, None
        raft_node, self.raft_node = self.raft_node, None
        transport, self.raft_transport = self.raft_transport, None
        if server is not None:
            server.stop()
        if manager is not None:
            manager.stop()
        if raft_node is not None:
            raft_node.stop()   # unregisters (closes) the transport too
        elif transport is not None:
            # _build_raft_manager binds the transport's listener before
            # the raft node exists; a failure between the two must not
            # leak the bound socket + accept thread
            try:
                transport.unregister(transport.node_id)
            except Exception:
                pass
        try:
            os.remove(self._manager_state_path())
        except FileNotFoundError:
            pass
        shutil.rmtree(os.path.join(self.state_dir, "raft"),
                      ignore_errors=True)

    def _start_manager_identity_renewer(self) -> None:
        """Managers hold the CA, so their serving identities (raft link,
        API server) renew by local re-issue at half of validity — without
        this a long-lived manager's certs expire and every CERT_REQUIRED
        peer handshake starts failing cluster-wide."""
        if getattr(self, "_identity_renewer_started", False):
            return   # demote→re-promote cycle: one thread is enough
        self._identity_renewer_started = True
        from .models.types import NodeRole
        from .security.ca import needs_renewal

        from .security.ca import signing_root_digest

        def stale(ca, ident) -> bool:
            return (needs_renewal(ident)
                    or signing_root_digest(ident) != ca.active_digest)

        def loop():
            while not self._stop_event.wait(self.cert_renew_interval):
                mgr = self.manager
                if mgr is None:
                    continue
                ca = mgr.root_ca
                t = self.raft_transport
                if (t is not None and t.tls_identity is not None
                        and stale(ca, t.tls_identity)):
                    t.set_identity(ca.issue(t.node_id, NodeRole.MANAGER))
                    log.info("renewed raft TLS identity for %s",
                             t.node_id)
                s = self.server
                if (s is not None and getattr(s, "tls_identity", None)
                        is not None and stale(ca, s.tls_identity)):
                    s.set_tls_identity(ca.issue(
                        s.tls_identity.node_id, NodeRole.MANAGER))
                    log.info("renewed API TLS identity")
                # this manager's own agent identity: local re-issue from
                # the CA we hold (managers never CSR themselves)
                node = self.node
                if (node is not None and node.certificate is not None
                        and stale(ca, node.certificate)):
                    fresh = ca.issue(node.certificate.node_id,
                                     NodeRole(node.certificate.role))
                    node.key_rw.write(fresh, b"")
                    node.certificate = fresh
                    agent = node.agent
                    cli = agent.client if agent is not None else None
                    if cli is not None and hasattr(cli, "certificate"):
                        cli.certificate = fresh
                        reset = getattr(cli, "reset_connection", None)
                        if reset is not None:
                            reset()
                    log.info("renewed manager-agent identity for %s",
                             fresh.node_id)

        threading.Thread(target=loop, name="manager-identity-renewer",
                         daemon=True).start()

    def _wait(self, cond, err: str, timeout: float = 20.0) -> None:
        """Poll ``cond`` until true or the injected-clock deadline
        passes.  A loop-count backstop (~10x the nominal window in real
        sleeps) guards against a frozen injected clock: a test that
        forgets to step its virtual clock gets the RuntimeError, not a
        hung harness."""
        deadline = self._clock() + timeout
        for _ in range(max(1, int(timeout / 0.02) * 10)):
            if cond():
                return
            if self._clock() > deadline:
                raise RuntimeError(err)
            time.sleep(0.02)
        raise RuntimeError(err)

    def _cert_accepted(self, cert) -> bool:
        """Probe the remote hello with the persisted cert: the server
        verifies certificates during the handshake, so a SecurityError
        here means the cert does not belong to this cluster."""
        from .net.client import RemoteDispatcherClient
        from .security.ca import SecurityError
        try:
            probe = RemoteDispatcherClient(self.join_addr, cert)
            try:
                probe.heartbeat(cert.node_id, "")
            finally:
                probe.close()
        except (SecurityError, PermissionError):
            # the wire client surfaces the server's "unauthenticated"
            # hello rejection as PermissionError (net/client.py error map)
            return False
        except Exception:
            pass   # app-level errors arrive only after an accepted hello
        return True

    def _start_joining_manager(self) -> None:
        """Join an existing cluster as an additional manager: manager
        cert via the join token, CA key + peer addresses via an
        address-less first raft_join hop, membership via the second hop
        that advertises our transport address, then a raft-backed Manager
        that follows the current leader (reference: manager.go
        JoinAndStart -> Join RPC).  A restart skips the RPCs entirely:
        membership and addresses replay from the WAL."""
        import base64

        from .net import issue_certificate, join_raft
        from .node import Node
        from .security import RootCA

        try:
            state = self._load_manager_state()
        except ManagerLockedError as e:
            self.locked = True
            log.warning("manager locked: %s", e)
            return
        # a runtime-promoted worker persisted its own node id as the raft
        # member id; _load_manager_state restored it into self.raft_id
        raft_id = self.raft_id
        if state is not None:
            # restart: peers + addresses replay from the raft WAL
            self._prev_ca_key = state.get("prev_ca_key")
            if state["api_port"] and self.listen_remote_api is None:
                # we served the remote API before the restart and its
                # address replicated cluster-wide — rebind it
                self.listen_remote_api = ("127.0.0.1", 0)
            self._build_raft_manager(
                RootCA(state["ca_key"], state["ca_cert"]),
                raft_port=state["raft_port"])
            self.node = Node(self.executor, self.state_dir,
                             node_id=raft_id)
            from .security.ca import SecurityError
            try:
                cert, _ = self.node.key_rw.read()
            except (FileNotFoundError, SecurityError) as e:
                # state file exists but the cert doesn't (crash between
                # the two writes) — re-issue with the operator's token
                # rather than crash-looping forever
                if not self.join_token:
                    raise RuntimeError(
                        "persisted manager state has no certificate and "
                        "no --join-token was given") from e
                cert = issue_certificate(self.join_addr, raft_id,
                                         self.join_token)
                self.node.key_rw.write(cert, b"")
            self._start_remote_api(port_override=state["api_port"])
        else:
            if not self.join_token:
                raise SystemExit("manager join needs --join-token")
            cert = None
            for attempt in range(10):
                try:
                    cert = issue_certificate(self.join_addr, raft_id,
                                             self.join_token)
                    break
                except PermissionError:
                    # a follower that has not yet adopted the replicated
                    # cluster state rejects fresh tokens momentarily
                    if attempt == 9:
                        raise
                    time.sleep(0.5)
            # first hop: fetch the cluster CA key (authenticates the raft
            # transport) WITHOUT advertising an address — membership only
            # changes on the second hop, so dying here leaves no phantom
            # peer wedging quorum
            boot = join_raft(self.join_addr, cert, raft_id)
            ca_key = base64.b64decode(boot["ca_key"])
            ca_cert = base64.b64decode(boot["ca_cert"])
            self._build_raft_manager(RootCA(ca_key, ca_cert), raft_port=0,
                                     defer_start=True)
            self._start_remote_api()
            self._complete_raft_join(self.join_addr, cert)
            self._save_manager_state()
        if self.server is not None:
            self.manager.api_addrs[raft_id] = self.server.addr

        # this manager's agent talks to whichever manager leads, like any
        # worker (a follower manager runs no dispatcher)
        if self.node is None:
            self.node = Node(self.executor, self.state_dir,
                             node_id=raft_id)
        self.node.certificate = cert
        self.node.node_id = cert.node_id
        self.node.key_rw.write(cert, b"")
        # seed with every manager API address we know — on a restart the
        # original join address may be long dead, but the WAL replayed
        # the current members' addresses
        extra = [tuple(a) for a in self.raft_node.core.api_addrs.values()]
        self._start_agent_with_failover(cert, self.join_addr, *extra)
        self._start_manager_identity_renewer()
        self._start_role_watcher()
        log.info("manager %s joined raft group %s", raft_id,
                 sorted(self.raft_node.core.peers))

    # ------------------------------------------------------- manager wiring

    def _start_manager_agent(self) -> None:
        """Run this manager node's own agent.  Preferred wiring is the
        failover client over the remote API (it survives leadership
        moves — the in-process dispatcher dies with leadership); only an
        API-less in-process leader binds its dispatcher directly."""
        from .node import Node
        from .security.ca import SecurityError

        # the manager node's cluster identity IS its raft member id, so
        # RoleManager can map Node records to raft voters (the reference
        # uses one node id for both)
        self.node = Node(self.executor, self.state_dir,
                         node_id=self.raft_id)
        cert = None
        try:
            cert, _ = self.node.key_rw.read()
        except (FileNotFoundError, SecurityError):
            pass
        if cert is None:
            if self.manager.dispatcher is None:
                # restarted follower with no persisted identity: nothing
                # local can issue a cert (the CA serves on the leader)
                log.warning("no persisted identity and not the leader; "
                            "manager-node agent not started")
                return
            # a MANAGER certificate: this node's store record must carry
            # the manager role or promotion/demotion can't act on it
            from .models.types import NodeRole
            token = self.manager.root_ca.join_token(NodeRole.MANAGER)
            self.node.load_or_join(self.manager.ca_server, token)
            cert = self.node.certificate
        else:
            self.node.certificate = cert
            self.node.node_id = cert.node_id
        if self.server is None:
            self.node.start(self.manager.dispatcher,
                            store=self.manager.store,
                            hostname=self.hostname)
            return
        seeds = [self.server.addr]
        seeds += [tuple(a) for a in self.raft_node.core.api_addrs.values()]
        self._start_agent_with_failover(cert, *seeds)

    def _start_agent_with_failover(self, cert, seed=None, *extra) -> None:
        import os as _os

        from .remotes import (
            ConnectionBroker, FailoverDispatcherClient, PersistentRemotes,
        )

        addrs = ([tuple(seed)] if seed else []) + [tuple(a) for a in extra]
        self.remotes = PersistentRemotes(
            _os.path.join(self.state_dir, "state.json"), *addrs)
        client = FailoverDispatcherClient(
            ConnectionBroker(self.remotes), cert)
        self.node.start(client, hostname=self.hostname)

    def _build_raft_manager(self, ca, raft_port: int = 0,
                            defer_start: bool = False) -> None:
        """Shared wiring for bootstrap and joining managers: TCP raft
        transport, raft-backed store, and the Manager composition."""
        import os

        from .manager import Manager
        from .net.raft_transport import TCPRaftTransport
        from .state import MemoryStore
        from .state.raft import KeyEncoder, RaftLogger, RaftNode

        raft_id = self.raft_id
        # raft links run mutual TLS on a manager cert self-issued from
        # the cluster CA (reference: ca/transport.go for raft peers)
        from .models.types import NodeRole
        self.raft_transport = TCPRaftTransport(
            raft_id, port=raft_port, auth_key=ca.key,
            tls_identity=ca.issue(raft_id, NodeRole.MANAGER))
        store = MemoryStore()
        prev_key = getattr(self, "_prev_ca_key", None)
        encoder = KeyEncoder(
            ca.key, allow_plaintext=self.migrate_plaintext_wal,
            fallback=KeyEncoder(prev_key) if prev_key else None)
        logger = RaftLogger(os.path.join(self.state_dir, "raft"),
                            encoder=encoder)
        if prev_key:
            # a crash interrupted the rotation re-key: converge all
            # on-disk state to the current key now (decode via fallback)
            logger.rotate_encoder(KeyEncoder(
                ca.key, allow_plaintext=self.migrate_plaintext_wal))
            self._prev_ca_key = None
        self.raft_node = RaftNode(
            raft_id, [raft_id], store, logger, self.raft_transport,
            force_new_cluster=self.force_new_cluster)
        store._proposer = self.raft_node
        self.manager = Manager(
            store=store, raft_node=self.raft_node, root_ca=ca,
            use_device_scheduler=self.use_device_scheduler,
            device=self.device)
        self.manager.raft_peer_addrs[raft_id] = self.raft_transport.addr
        # after a root rotation finalizes (or is adopted from the leader),
        # everything keyed off the CA key must re-key: the encrypted
        # WAL/snapshots, the transport HMAC fallback, persisted state
        self.manager.on_root_rotated = self._on_root_rotated
        self.manager.on_cluster_changed = self._resave_manager_state
        if not defer_start:
            self.raft_node.start()
            self.manager.run()

    def _resave_manager_state(self) -> None:
        """Cluster changed (possibly the autolock flag / unlock key):
        re-persist local state so sealing matches the cluster's will."""
        if self.manager is None or self.raft_transport is None:
            return
        try:
            self._save_manager_state()
        except Exception:
            log.exception("re-sealing manager state failed")

    def _on_root_rotated(self) -> None:
        """Re-key local material derived from the CA key after a root
        rotation (reference: manager re-encrypts the raft DEK under the
        new KEK, manager/deks.go + storage.go RotateEncryptionKey).

        Crash-safe ordering: (1) persist the state file carrying BOTH
        keys, (2) re-encrypt snapshot+WAL under the new key, (3) persist
        again without the old key.  A crash at any point leaves a state
        file whose key (plus optional prev key fallback) can decode
        everything on disk."""
        from .state.raft import KeyEncoder
        ca = self.manager.root_ca
        old_key = self.raft_transport.auth_key
        try:
            self._save_manager_state(prev_key=old_key)
            self.raft_node.logger.rotate_encoder(KeyEncoder(ca.key))
            self._save_manager_state()
        except Exception:
            log.exception("WAL re-key after CA rotation failed")
        self.raft_transport.auth_key = ca.key
        log.info("re-keyed raft storage under the rotated root CA")

    def _start_remote_api(self, port_override: int = 0) -> None:
        from .net import ManagerServer

        if self.listen_remote_api is not None:
            port = self.listen_remote_api[1] or port_override
            self.server = ManagerServer(
                self.manager, host=self.listen_remote_api[0], port=port)
            self.server.start()
            log.info("remote API on %s:%d", *self.server.addr)

    def _manager_state_path(self) -> str:
        import os
        return os.path.join(self.state_dir, "manager-state.json")

    def _load_manager_state(self):
        import json
        try:
            with open(self._manager_state_path(), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if raw.startswith(b"LOCK1"):
            # sealed under the operator's unlock key (autolock)
            from .state.raft.storage import DecryptionError, KeyEncoder
            if not self.unlock_key:
                raise ManagerLockedError(
                    "manager state is locked; provide the unlock key")
            try:
                raw = KeyEncoder(self.unlock_key.encode()).decode(raw[5:])
            except DecryptionError:
                raise ManagerLockedError("invalid unlock key")
        try:
            rec = json.loads(raw)
        except ValueError as e:
            raise RuntimeError(
                f"manager state file {self._manager_state_path()!r} is "
                f"unreadable ({e})") from e
        try:
            # restore the raft member id: "m-<hostname>" normally, the
            # node's own id for a runtime-promoted worker
            self.raft_id = rec.get("raft_id") or self.raft_id
            return {"ca_key": bytes.fromhex(rec["ca_key"]),
                    "ca_cert": bytes.fromhex(rec["ca_cert"]),
                    "prev_ca_key": bytes.fromhex(rec["prev_ca_key"])
                    if rec.get("prev_ca_key") else None,
                    "raft_port": rec["raft_port"],
                    "api_port": rec.get("api_port", 0)}
        except (KeyError, ValueError, TypeError) as e:
            # a partial/old-format state file must NOT silently bootstrap
            # a brand-new cluster (fresh CA = every cert and token in the
            # fleet invalidated); make the operator decide
            raise RuntimeError(
                f"manager state file {self._manager_state_path()!r} is "
                f"unreadable or from an incompatible version ({e}); "
                "remove it to bootstrap a new cluster") from e

    def _save_manager_state(self, prev_key: Optional[bytes] = None
                            ) -> None:
        """Persist what a restart cannot recover from the WAL: the CA
        key that authenticates the raft transport (the reference keeps CA
        material in the state dir too, node.go loadSecurityConfig) and our
        raft listen port, which peers know us by."""
        import json
        import os

        os.makedirs(self.state_dir, exist_ok=True)
        payload = json.dumps({
            "raft_id": self.raft_id,
            "ca_key": self.manager.root_ca.key.hex(),
            "ca_cert": self.manager.root_ca.cert_pem.hex(),
            # present only mid-re-key: decode fallback for a crash
            # between the WAL rewrite and this file converging
            "prev_ca_key": prev_key.hex() if prev_key else "",
            "raft_port": self.raft_transport.addr[1],
            # the API port must survive restarts too: it replicated
            # to the whole cluster via the join conf entry, and a
            # follower cannot re-propose a changed address
            "api_port": self.server.addr[1] if self.server else 0,
        }).encode()
        key = self._autolock_key()
        if key:
            # autolock: the CA key (root of every trust + encryption
            # chain) only hits disk sealed under the operator's unlock
            # key (reference: manager/deks.go KEK over the DEK)
            from .state.raft.storage import KeyEncoder
            payload = b"LOCK1" + KeyEncoder(key).encode(payload)
        tmp = self._manager_state_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._manager_state_path())

    def _autolock_key(self):
        """The cluster's manager unlock key when autolock is enabled
        (bytes), else None."""
        try:
            # unredacted read: the API projection strips unlock_keys
            cluster = self.manager.control_api._default_cluster_raw()
        except Exception:
            return None
        if not cluster.spec.encryption_config.auto_lock_managers:
            return None
        for ek in cluster.unlock_keys:
            if ek.subsystem == "manager" and ek.key:
                return ek.key
        return None

    def unlock(self, key: str) -> None:
        """Unseal a locked manager and complete startup (reference:
        swarm unlock)."""
        if not self.locked:
            return
        self.unlock_key = key
        self._load_manager_state()   # raises ManagerLockedError if wrong
        self.locked = False
        self.start()

    def stop(self) -> None:
        self._stop_event.set()
        # let an in-flight role transition finish before tearing down
        if self._role_mu.acquire(timeout=10):
            self._role_mu.release()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        if self.node is not None:
            self.node.stop()
        if self.server is not None:
            self.server.stop()
        if self.manager is not None:
            self.manager.stop()
        if self.raft_node is not None:
            self.raft_node.stop()


def main(argv=None) -> int:   # pragma: no cover - thin CLI shell
    parser = argparse.ArgumentParser(prog="swarmd")
    parser.add_argument("--state-dir", required=True)
    parser.add_argument("--hostname", default="")
    parser.add_argument("--manager", action="store_true")
    parser.add_argument("--listen-remote-api", default="")
    parser.add_argument("--join-addr", default="")
    parser.add_argument("--join-token", default="")
    parser.add_argument("--no-device-scheduler", action="store_true")
    parser.add_argument("--device", default=None,
                        help="where the leader's scheduler runs: the card "
                             "(default) or 'cpu' for the plain versions")
    parser.add_argument("--executor", default="process",
                        choices=["process", "test"],
                        help="task runtime backend: real OS processes "
                             "(default) or the in-memory test executor")
    parser.add_argument("--migrate-plaintext-wal", action="store_true",
                        help="one-time replay of a state dir written "
                             "before WAL encryption existed")
    parser.add_argument("--unlock-key", default="",
                        help="unlock key for an autolocked manager "
                             "state dir")
    parser.add_argument("--force-new-cluster", action="store_true",
                        help="recover from quorum loss: rebuild a "
                             "single-member raft from this node's state")
    parser.add_argument("--listen-metrics", default="",
                        help="serve /metrics, /healthz and /debug/stacks "
                             "over plain HTTP on host:port")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    daemon = Swarmd(
        state_dir=args.state_dir, hostname=args.hostname,
        manager=args.manager,
        listen_remote_api=parse_addr(args.listen_remote_api)
        if args.listen_remote_api else None,
        join_addr=parse_addr(args.join_addr) if args.join_addr else None,
        join_token=args.join_token,
        executor=args.executor,
        use_device_scheduler=not args.no_device_scheduler,
        migrate_plaintext_wal=args.migrate_plaintext_wal,
        unlock_key=args.unlock_key,
        force_new_cluster=args.force_new_cluster,
        listen_metrics=parse_addr(args.listen_metrics)
        if args.listen_metrics else None,
        device=args.device)
    daemon.start()
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":   # pragma: no cover
    raise SystemExit(main())
