"""Manager network server: dispatcher + control API + CA over mTLS TCP.

Reference role: the manager's gRPC servers (manager.go:475-563) — the
worker-facing Dispatcher service, the user-facing Control service, and the
NodeCA issuance service — all behind mutual TLS rooted at the cluster CA
(reference: ca/transport.go).

One thread per connection (the control plane is low-rate); the assignments
stream switches its connection into push mode.  The TLS handshake
authenticates the peer: its verified client certificate is the identity
every method is gated on.  ``fetch_root_ca``/``issue_certificate`` remain
reachable without a client cert (gated by join token instead, like the
reference's token-gated NodeCA.IssueNodeCertificate).  ``tls=False`` falls
back to hello-frame certificate attestation over plaintext — a debugging
knob only, since a bearer attestation is replayable.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import ssl
import threading
import time
from typing import Any, Dict, Optional

from ..models.objects import STORE_OBJECT_TYPES
from ..models.specs import NodeSpec, SecretSpec, ServiceSpec
from ..models.types import NodeDescription, TaskStatus
from ..security.ca import Certificate, SecurityError
from ..security.tls import peer_certificate, server_context
from ..state import serde
from ..state.watch import Closed
from ..utils.metrics import registry as metrics
from .wire import recv_frame, send_frame

log = logging.getLogger("net.server")


class NotLeaderError(Exception):
    """This manager is not the leader: the dispatcher/control surface
    lives on the leader (agents should rotate to another manager)."""

    code = "not_leader"


class ManagerServer:
    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 tls: bool = True,
                 tls_identity: Optional[Certificate] = None):
        self.manager = manager
        self.tls = tls
        if tls:
            if tls_identity is None or not tls_identity.key_pem:
                # self-issue the API server's identity from the cluster CA
                # (the reference manager serves with its own node cert)
                from ..models.types import NodeRole
                from ..utils import new_id
                tls_identity = manager.root_ca.issue(
                    "manager-api-" + new_id()[:8], NodeRole.MANAGER)
            self.tls_identity = tls_identity
            self._ssl_ctx = server_context(tls_identity)
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._handle_conn(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self.addr = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="manager-server", daemon=True)
        self._thread.start()

    def set_tls_identity(self, tls_identity: Certificate) -> None:
        """Swap the serving identity (renewal / root rotation); new
        connections handshake with the fresh cert."""
        self.tls_identity = tls_identity
        self._ssl_ctx = server_context(tls_identity)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # ---------------------------------------------------------- connections

    def _handle_conn(self, sock: socket.socket) -> None:
        cert: Optional[Certificate] = None
        try:
            if self.tls:
                try:
                    sock = self._ssl_ctx.wrap_socket(sock,
                                                     server_side=True)
                except (ssl.SSLError, ConnectionError, OSError) as e:
                    log.debug("TLS handshake failed: %s", e)
                    return
                # identity = the TLS-authenticated client cert (chain and
                # validity checked by the handshake; issuer re-checked
                # against the *current* root in case of rotation)
                cert = peer_certificate(sock)
                if cert is not None:
                    try:
                        self.manager.root_ca.verify(cert)
                    except SecurityError:
                        cert = None
            hello = recv_frame(sock)
            if hello.get("method") != "hello":
                send_frame(sock, {"id": hello.get("id"),
                                  "error": "expected hello"})
                return
            cert_data = hello.get("params", {}).get("certificate")
            if cert_data and not self.tls:
                # plaintext fallback: hello-frame attestation (replayable
                # bearer — debugging only)
                try:
                    cert = Certificate.from_bytes(cert_data.encode())
                    self.manager.root_ca.verify(cert)
                except SecurityError as e:
                    send_frame(sock, {"id": hello.get("id"),
                                      "error": str(e),
                                      "code": "unauthenticated"})
                    return
            send_frame(sock, {"id": hello.get("id"), "result": "ok"})

            while True:
                req = recv_frame(sock)
                method = req.get("method", "")
                params = req.get("params", {}) or {}
                rid = req.get("id")
                if method == "open_assignments":
                    # stream mode: this connection now only pushes
                    try:
                        self._stream_assignments(sock, cert, params, rid)
                    except (ConnectionError, OSError):
                        pass
                    except Exception as e:
                        send_frame(sock, {
                            "id": rid, "error": str(e),
                            "code": getattr(e, "code", "internal")})
                    return
                # per-RPC count + latency + error metrics, the
                # grpc-prometheus interceptor equivalent (reference:
                # manager.go:552,563); surfaced by /metrics.  The method
                # label on successes is bounded by the dispatch table
                # (unknown methods always error); error counters carry
                # only the code, so client-chosen strings can never grow
                # the registry or corrupt the exposition format.
                t0 = time.perf_counter()
                error = None
                try:
                    result = self._dispatch(method, params, cert)
                except Exception as e:
                    error = e
                metrics.timer("swarm_rpc_latency").observe(
                    time.perf_counter() - t0)
                if error is None:
                    metrics.counter(
                        f'swarm_rpc{{method="{method}"}}')
                    send_frame(sock, {"id": rid, "result": result})
                else:
                    code = getattr(error, "code", "internal")
                    metrics.counter(f'swarm_rpc_errors{{code="{code}"}}')
                    send_frame(sock, {"id": rid, "error": str(error),
                                      "code": code})
        except (ConnectionError, OSError):
            pass
        except Exception:
            log.exception("connection handler failed")
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _dispatcher(self):
        d = self.manager.dispatcher
        if d is None:
            raise NotLeaderError(
                "this manager is not the leader; retry another manager")
        return d

    @staticmethod
    def _require_cert(cert: Optional[Certificate], node_id: str = "") -> None:
        if cert is None:
            raise SecurityError("certificate required")
        if node_id and cert.node_id != node_id:
            raise SecurityError("certificate/node mismatch")

    @staticmethod
    def _require_manager_cert(cert: Optional[Certificate],
                              what: str) -> None:
        from ..models.types import NodeRole
        ManagerServer._require_cert(cert)
        if NodeRole(cert.role) != NodeRole.MANAGER:
            raise SecurityError(
                f"a manager certificate is required {what}")

    def _network_keys(self):
        """Current dataplane encryption keys + lamport clock, serialized
        for the heartbeat piggyback; cached per clock value so steady-
        state heartbeats reuse the serialized form (the key manager only
        bumps the clock on rotation)."""
        from ..models.objects import Cluster
        from ..state import serde
        try:
            cluster = self.manager.store.view(
                lambda tx: next(iter(tx.find(Cluster)), None))
        except Exception:
            return None, 0
        if cluster is None or not cluster.network_bootstrap_keys:
            return None, 0
        clock = cluster.encryption_key_lamport_clock
        cached = getattr(self, "_netkey_cache", None)
        if cached is not None and cached[0] == clock:
            return cached[1], clock
        keys = [serde.to_dict(k) for k in cluster.network_bootstrap_keys]
        self._netkey_cache = (clock, keys)
        return keys, clock

    def _store_role(self, cert: Optional[Certificate]):
        """The caller's current role per its store Node record (the role
        manager keeps this reconciled with spec.desired_role); falls back
        to the cert's role for nodes not yet registered."""
        if cert is None:
            return None
        from ..models.objects import Node as NodeObject
        try:
            node = self.manager.store.view(
                lambda tx: tx.get(NodeObject, cert.node_id))
        except Exception:
            node = None
        return node.role if node is not None else cert.role

    # -------------------------------------------------------------- methods

    def _dispatch(self, method: str, params: Dict[str, Any],
                  cert: Optional[Certificate]) -> Any:
        m = self.manager

        # ---- CA (token-gated, no client cert needed)
        if method == "fetch_root_ca":
            # bootstrap: the joiner verifies this against its token digest
            # (reference: ca.DownloadRootCA GetRootCACertificate).  The
            # bundle carries both roots during a rotation; the token
            # digest matches the FIRST (current) root.
            return {"ca_cert": m.root_ca.trust_bundle().decode()}
        if method == "issue_certificate":
            # a follower validates against replicated cluster state; pull
            # the latest adoption synchronously so a token minted on the
            # leader moments ago is honored here too
            if hasattr(m, "_adopt_ca_state"):
                m._adopt_ca_state()
            csr = params.get("csr")
            if csr:
                cert_pem = m.ca_server.issue_node_certificate(
                    params["node_id"], params["token"],
                    csr_pem=csr.encode())
                return {"cert": cert_pem.decode(),
                        "ca_cert": m.root_ca.trust_bundle().decode()}
            # certless legacy path: key generated server-side
            issued = m.ca_server.issue_node_certificate(
                params["node_id"], params["token"])
            return {"cert": issued.cert_pem.decode(),
                    "key": issued.key_pem.decode(),
                    "ca_cert": m.root_ca.trust_bundle().decode()}
        if method == "renew_certificate":
            # gated on the caller's valid cert: same identity, fresh
            # validity.  The role comes from the node's STORE record (the
            # role manager's reconciled role), not the old cert — this is
            # the channel by which promotion/demotion reaches the node
            # (reference: ca/server.go:377, role_manager.go reconcile)
            self._require_cert(cert)
            cert_pem = m.ca_server.renew(cert,
                                         csr_pem=params["csr"].encode(),
                                         role=self._store_role(cert))
            return {"cert": cert_pem.decode(),
                    "ca_cert": m.root_ca.trust_bundle().decode()}

        # ---- dispatcher surface (cert-gated to the calling node)
        if method == "register":
            self._require_cert(cert, params["node_id"])
            # leader check FIRST: the node-record write below proposes
            # through raft, and a follower would surface that as an
            # opaque internal error instead of a not_leader the client
            # can rotate on
            dispatcher = self._dispatcher()
            description = serde.from_dict(
                NodeDescription, params.get("description"))
            self._ensure_node_registered(params["node_id"], cert,
                                         description)
            session, period = dispatcher.register(
                params["node_id"], description=description)
            self._record_cert_issuer(cert)
            return {"session_id": session, "period": period}
        if method == "heartbeat":
            self._require_cert(cert, params["node_id"])
            period = self._dispatcher().heartbeat(params["node_id"],
                                                  params["session_id"])
            self._record_cert_issuer(cert)
            # the active root digest rides along so agents renew promptly
            # when a rotation begins (reference: the session stream ships
            # the RootCA; ca/renewer reacts)
            # the node's reconciled role rides along too so a promoted/
            # demoted node renews (and transitions) without waiting out
            # its cert half-life (reference: the session stream carries
            # the Node object; node.go:947 waitRole reacts)
            resp = {"period": period, "managers": m.manager_api_addrs(),
                    "ca_digest": m.root_ca.active_digest,
                    "role": self._store_role(cert)}
            # dataplane encryption keys ride along so agents pick up key-
            # manager rotations (reference: SessionMessage.
            # NetworkBootstrapKeys, api/dispatcher.proto; agent.go
            # handleSessionMessage -> executor.SetNetworkBootstrapKeys)
            keys, clock = self._network_keys()
            if keys is not None:
                resp["network_keys"] = keys
                resp["key_clock"] = clock
            return resp
        if method == "update_task_status":
            self._require_cert(cert, params["node_id"])
            updates = [(u["task_id"],
                        serde.from_dict(TaskStatus, u["status"]))
                       for u in params["updates"]]
            self._dispatcher().update_task_status(
                params["node_id"], params["session_id"], updates)
            return "ok"

        if method == "update_volume_status":
            self._require_cert(cert, params["node_id"])
            self._dispatcher().update_volume_status(
                params["node_id"], params["session_id"],
                [(u[0], u[1]) for u in params["updates"]])
            return "ok"

        if method == "publish_logs":
            self._require_cert(cert, params["node_id"])
            import base64 as _b64
            # the sender's identity is the CERT's, not whatever the
            # payload claims — prevents cross-node log spoofing
            msgs = [dict(m, data=_b64.b64decode(m["data"]),
                         node_id=params["node_id"])
                    for m in params["messages"]]
            self._dispatcher().publish_logs(
                params["node_id"], params["session_id"], msgs)
            return "ok"

        # ---- health (cert-gated; reference: authenticated Health.Check)
        if method == "health":
            self._require_cert(cert)
            return {"status": m.health_check(params.get("service", ""))}

        # ---- manager join (MANAGER-cert gated)
        if method == "raft_join":
            self._require_cert(cert, params["node_id"])
            self._require_manager_cert(cert, "to join raft")
            return m.join_raft(params["node_id"],
                               addr=params.get("addr"),
                               api_addr=params.get("api_addr"))

        # ---- control surface (MANAGER-cert gated: the reference serves the
        # control API only on the operator socket / to manager-role mTLS
        # identities — a worker cert must NOT be able to mutate cluster
        # state, or any compromised worker could promote itself)
        api = m.control_api
        if method.startswith("control."):
            self._require_manager_cert(cert, "for the control API")
            return self._dispatch_control(api, method[len("control."):],
                                          params)
        raise ValueError(f"unknown method {method!r}")

    def _record_cert_issuer(self, cert: Optional[Certificate]) -> None:
        """Track which root this node's TLS identity chains to — the
        CA-rotation reconciler's progress signal (reference:
        ca/reconciler.go watching node cert states)."""
        if cert is None:
            return
        m = self.manager
        try:
            digest = m.root_ca.issuer_digest(cert)
        except Exception:
            return
        if not digest:
            return
        from ..models.objects import Node as NodeObject
        node_id = cert.node_id
        cur = m.store.raw_get(NodeObject, node_id)
        if cur is None or cur.certificate_issuer == digest:
            return

        def cb(tx):
            n = tx.get(NodeObject, node_id)
            if n is None or n.certificate_issuer == digest:
                return
            n = n.copy()
            n.certificate = cert.cert_pem
            n.certificate_issuer = digest
            tx.update(n)

        try:
            m.store.update(cb)
        except Exception:
            log.debug("recording cert issuer failed", exc_info=True)

    def _ensure_node_registered(self, node_id: str, cert: Certificate,
                                description) -> None:
        """Self-registration of joined nodes (in-process mode does this in
        Node.start; over the network the manager does it on first
        register, reference: dispatcher register + node store)."""
        from ..models.objects import Node as NodeObject
        from ..models.types import Annotations, NodeRole

        def cb(tx):
            if tx.get(NodeObject, node_id) is not None:
                return
            name = description.hostname if description else node_id[:8]
            tx.create(NodeObject(
                id=node_id,
                spec=NodeSpec(annotations=Annotations(name=name),
                              desired_role=NodeRole(cert.role)),
                description=description,
                role=int(cert.role)))

        self.manager.store.update(cb)

    def _dispatch_control(self, api, method: str,
                          params: Dict[str, Any]) -> Any:
        def obj_out(obj):
            return None if obj is None else {
                "collection": obj.collection, "obj": serde.to_dict(obj)}

        if method == "create_service":
            return obj_out(api.create_service(
                serde.from_dict(ServiceSpec, params["spec"])))
        if method == "update_service":
            return obj_out(api.update_service(
                params["service_id"], params["version"],
                serde.from_dict(ServiceSpec, params["spec"])))
        if method == "remove_service":
            api.remove_service(params["service_id"])
            return "ok"
        if method == "get_service":
            return obj_out(api.get_service(params["service_id"]))
        if method == "collect_logs":
            import base64 as _b64
            return [dict(m, data=_b64.b64encode(m["data"]).decode())
                    for m in api.collect_logs(
                        params["service_id"],
                        duration=params.get("duration", 2.0),
                        tail=params.get("tail", -1),
                        since=params.get("since", 0.0),
                        follow=params.get("follow", True),
                        streams=params.get("streams") or [])]
        if method == "list_services":
            return [obj_out(s) for s in api.list_services(
                name_prefix=params.get("name_prefix", ""))]
        if method == "list_service_statuses":
            return api.list_service_statuses(
                list(params.get("service_ids", [])))
        if method == "list_nodes":
            return [obj_out(n) for n in api.list_nodes()]
        if method == "update_node":
            return obj_out(api.update_node(
                params["node_id"], params["version"],
                serde.from_dict(NodeSpec, params["spec"])))
        if method == "remove_node":
            api.remove_node(params["node_id"],
                            force=params.get("force", False))
            return "ok"
        if method == "list_tasks":
            return [obj_out(t) for t in api.list_tasks(
                service_id=params.get("service_id", ""),
                node_id=params.get("node_id", ""))]
        if method == "remove_task":
            api.remove_task(params["task_id"])
            return "ok"
        if method == "create_secret":
            return obj_out(api.create_secret(
                serde.from_dict(SecretSpec, params["spec"])))
        if method == "get_secret":
            return obj_out(api.get_secret(params["secret_id"]))
        if method == "get_config":
            return obj_out(api.get_config(params["config_id"]))
        if method == "list_secrets":
            return [obj_out(s) for s in api.list_secrets()]
        if method == "remove_secret":
            api.remove_secret(params["secret_id"])
            return "ok"
        if method == "create_config":
            from ..models.specs import ConfigSpec
            return obj_out(api.create_config(
                serde.from_dict(ConfigSpec, params["spec"])))
        if method == "list_configs":
            return [obj_out(c) for c in api.list_configs()]
        if method == "remove_config":
            api.remove_config(params["config_id"])
            return "ok"
        if method == "create_network":
            from ..models.specs import NetworkSpec
            return obj_out(api.create_network(
                serde.from_dict(NetworkSpec, params["spec"])))
        if method == "list_networks":
            return [obj_out(n) for n in api.list_networks()]
        if method == "remove_network":
            api.remove_network(params["network_id"])
            return "ok"
        if method == "create_volume":
            from ..models.specs import VolumeSpec
            return obj_out(api.create_volume(
                serde.from_dict(VolumeSpec, params["spec"])))
        if method == "update_volume":
            from ..models.specs import VolumeSpec
            return obj_out(api.update_volume(
                params["volume_id"], params["version"],
                serde.from_dict(VolumeSpec, params["spec"])))
        if method == "get_volume":
            return obj_out(api.get_volume(params["volume_id"]))
        if method == "list_volumes":
            return [obj_out(v) for v in api.list_volumes(
                name_prefix=params.get("name_prefix", ""))]
        if method == "remove_volume":
            api.remove_volume(params["volume_id"],
                              force=params.get("force", False))
            return "ok"
        if method == "create_extension":
            from ..models.types import Annotations
            return obj_out(api.create_extension(
                serde.from_dict(Annotations, params["annotations"]),
                params.get("description", "")))
        if method == "list_extensions":
            return [obj_out(e) for e in api.list_extensions()]
        if method == "remove_extension":
            api.remove_extension(params["extension_id"])
            return "ok"
        if method == "create_resource":
            import base64 as _b64
            from ..models.types import Annotations
            return obj_out(api.create_resource(
                serde.from_dict(Annotations, params["annotations"]),
                params["kind"],
                _b64.b64decode(params.get("payload", ""))))
        if method == "list_resources":
            return [obj_out(r) for r in api.list_resources(
                kind=params.get("kind", ""))]
        if method == "remove_resource":
            api.remove_resource(params["resource_id"])
            return "ok"
        if method == "rotate_join_token":
            return api.rotate_join_token(params["role"])
        if method == "get_default_cluster":
            return obj_out(api.get_default_cluster())
        if method == "list_clusters":
            return [obj_out(c) for c in api.list_clusters()]
        if method == "rotate_ca":
            return api.rotate_ca()
        if method == "set_autolock":
            return api.set_autolock(bool(params["enabled"]))
        if method == "get_unlock_key":
            return api.get_unlock_key()
        raise ValueError(f"unknown control method {method!r}")

    # ------------------------------------------------------------- streaming

    def _stream_assignments(self, sock: socket.socket,
                            cert: Optional[Certificate],
                            params: Dict[str, Any], rid) -> None:
        self._require_cert(cert, params["node_id"])
        stream = self._dispatcher().open_assignments(
            params["node_id"], params["session_id"])
        send_frame(sock, {"id": rid, "result": "streaming"})
        try:
            while True:
                try:
                    msg = stream.get(timeout=0.5)
                except TimeoutError:
                    # liveness probe: a vanished peer would otherwise leak
                    # this thread + its dispatcher stream until the next
                    # push attempt.  On TLS sockets a would-block read
                    # surfaces as SSLWantReadError, not BlockingIOError.
                    sock.setblocking(False)
                    try:
                        if sock.recv(1) == b"":
                            return  # peer closed
                    except (BlockingIOError, InterruptedError,
                            ssl.SSLWantReadError):
                        pass
                    finally:
                        sock.setblocking(True)
                    continue
                except Closed:
                    send_frame(sock, {"push": "closed",
                                      "error": str(stream.error or "")})
                    return
                send_frame(sock, {
                    "push": "assignments",
                    "type": msg.type,
                    "applies_to": msg.applies_to,
                    "results_in": msg.results_in,
                    "changes": [
                        {"action": action, "kind": kind,
                         "obj": serde.to_dict(obj)}
                        for action, kind, obj in msg.changes],
                })
        except (ConnectionError, OSError):
            pass
        finally:
            stream.close()
