"""Network clients: the dispatcher surface for remote agents and the
control surface for remote swarmctl.

``RemoteDispatcherClient`` implements exactly the client surface
``agent.Agent`` consumes (register / heartbeat / open_assignments /
update_task_status), so an agent runs against a remote manager unchanged.
``RemoteControlClient`` mirrors ControlAPI methods for the CLI.
"""

from __future__ import annotations

import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..manager.controlapi import (
    AlreadyExists, APIError, FailedPrecondition, InvalidArgument, NotFound,
)
from ..models.objects import STORE_OBJECT_TYPES
from ..models.types import TaskStatus
from ..security.ca import (
    Certificate, InvalidToken, SecurityError, generate_key_pem, make_csr,
)
from ..security.tls import client_context, require_server_role
from ..state import serde
from ..state.watch import Closed
from .wire import recv_frame, send_frame

_COLLECTIONS = {t.collection: t for t in STORE_OBJECT_TYPES}

class NotLeader(Exception):
    """The contacted manager is not the leader (server code
    'not_leader'); callers should rotate to another manager."""


class SessionInvalid(Exception):
    """The dispatcher no longer recognizes this session (server codes
    'session_invalid' / 'node_not_registered'): the link is healthy but
    the session is gone — re-register, preferably with a DIFFERENT
    manager (the old one may be mid-teardown)."""

    code = "session_invalid"


_ERROR_TYPES = {
    "not_leader": NotLeader,
    "invalid_argument": InvalidArgument,
    "not_found": NotFound,
    "already_exists": AlreadyExists,
    "failed_precondition": FailedPrecondition,
    "unauthenticated": PermissionError,
    "session_invalid": SessionInvalid,
    "node_not_registered": SessionInvalid,
}


class RemoteError(Exception):
    pass


def _obj_in(data):
    if data is None:
        return None
    cls = _COLLECTIONS[data["collection"]]
    return serde.from_dict(cls, data["obj"])


class _Connection:
    """One mTLS link to a manager.  With ``tls`` (default) the client
    presents its certificate in the handshake and verifies the server
    chains to the cluster root AND carries the manager role; ``tls=False``
    falls back to plaintext hello-frame attestation (debug knob);
    ``insecure=True`` skips server verification for the join bootstrap."""

    def __init__(self, addr: Tuple[str, int],
                 certificate: Optional[Certificate],
                 tls: bool = True, insecure: bool = False):
        self.addr = addr
        self.certificate = certificate
        self.tls = tls
        self.insecure = insecure
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()
        self._next_id = 0

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=10)
        cert_data = None
        if self.tls:
            identity = (self.certificate
                        if (self.certificate
                            and self.certificate.key_pem
                            and self.certificate.cert_pem) else None)
            ctx = client_context(
                identity,
                ca_cert_pem=(self.certificate.ca_cert_pem
                             if self.certificate else b""),
                insecure=self.insecure)
            try:
                sock = ctx.wrap_socket(sock)
                if not self.insecure:
                    require_server_role(sock, "swarm-manager")
            except SecurityError:
                sock.close()
                raise
            except Exception as e:
                sock.close()
                raise PermissionError(f"TLS handshake failed: {e}")
        elif self.certificate:
            cert_data = self.certificate.to_bytes().decode()
        send_frame(sock, {"id": 0, "method": "hello",
                          "params": {"certificate": cert_data}})
        resp = recv_frame(sock)
        if resp.get("error"):
            sock.close()
            raise _ERROR_TYPES.get(resp.get("code"), RemoteError)(
                resp["error"])
        # only after a successful hello: streams may then block in recv
        # for arbitrarily long idle periods (the 10s timeout still bounds
        # the connect + handshake against half-open servers)
        sock.settimeout(None)
        return sock

    def call(self, method: str, params: Dict[str, Any]) -> Any:
        with self._mu:
            if self._sock is None:
                self._sock = self._connect()
            self._next_id += 1
            rid = self._next_id
            try:
                send_frame(self._sock, {"id": rid, "method": method,
                                        "params": params})
                resp = recv_frame(self._sock)
            except (ConnectionError, OSError):
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise
            if resp.get("error"):
                raise _ERROR_TYPES.get(resp.get("code"), RemoteError)(
                    resp["error"])
            return resp.get("result")

    def close(self) -> None:
        with self._mu:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def issue_certificate(addr: Tuple[str, int], node_id: str,
                      token: str, tls: bool = True) -> Certificate:
    """Join: obtain a certificate with a join token (no cert needed).

    Bootstrap has no trust root yet, so the root fetch runs over an
    unverified connection and the downloaded root CA cert is checked
    against the digest embedded in the join token.  The secret token +
    CSR are then sent over a NEW connection with that root pinned — the
    digest check validates bytes, not the channel, so sending the token
    on the unverified link would hand it to an active MITM (reference:
    ca.DownloadRootCA then a verified NodeCA connection; the private key
    is generated locally and never travels)."""
    boot = _Connection(addr, None, tls=tls, insecure=True)
    try:
        root = boot.call("fetch_root_ca", {})
    finally:
        boot.close()
    ca_cert_pem = root["ca_cert"].encode()
    parts = token.split("-")
    if len(parts) != 4:
        raise InvalidToken("invalid join token")
    from ..security.ca import cert_digest
    if cert_digest(ca_cert_pem) != parts[2]:
        raise InvalidToken(
            "downloaded root CA does not match the join token digest")
    key_pem = generate_key_pem()
    conn = _Connection(addr, Certificate(cert_pem=b"", key_pem=b"",
                                         ca_cert_pem=ca_cert_pem),
                       tls=tls)
    try:
        resp = conn.call("issue_certificate", {
            "node_id": node_id, "token": token,
            "csr": make_csr(node_id, key_pem).decode()})
        return Certificate(cert_pem=resp["cert"].encode(),
                           key_pem=key_pem, ca_cert_pem=ca_cert_pem)
    finally:
        conn.close()


def renew_certificate(addr: Tuple[str, int],
                      certificate: Certificate,
                      tls: bool = True) -> Certificate:
    """Cert-gated renewal over the wire: fresh local key + CSR, same
    identity/role (reference: ca/renewer.go RequestAndSaveNewCertificates)."""
    conn = _Connection(addr, certificate, tls=tls)
    try:
        key_pem = generate_key_pem()
        resp = conn.call("renew_certificate", {
            "csr": make_csr(certificate.node_id, key_pem).decode()})
        return Certificate(cert_pem=resp["cert"].encode(),
                           key_pem=key_pem,
                           ca_cert_pem=resp["ca_cert"].encode())
    finally:
        conn.close()


def join_raft(addr: Tuple[str, int], certificate: Certificate,
              node_id: str, raft_addr: Optional[Tuple[str, int]] = None,
              api_addr: Optional[Tuple[str, int]] = None
              ) -> Dict[str, Any]:
    """Manager join: ask the leader to add us to the raft group; returns
    the known peer transport addresses.  A follower answers with a
    redirect to the leader's API address, which we chase (bounded)."""
    for _ in range(3):
        conn = _Connection(addr, certificate)
        try:
            resp = conn.call("raft_join", {
                "node_id": node_id,
                "addr": list(raft_addr) if raft_addr else None,
                "api_addr": list(api_addr) if api_addr else None})
        finally:
            conn.close()
        if "redirect" in resp:
            addr = tuple(resp["redirect"])
            continue
        return resp
    raise RemoteError("raft join kept getting redirected")


class RemoteAssignmentStream:
    """Client half of the assignments stream: reads pushed frames on a
    dedicated connection; same get()/close() surface as the in-process
    AssignmentStream."""

    def __init__(self, conn_factory, node_id: str, session_id: str):
        self._sock = conn_factory()
        send_frame(self._sock, {"id": 1, "method": "open_assignments",
                                "params": {"node_id": node_id,
                                           "session_id": session_id}})
        resp = recv_frame(self._sock)
        if resp.get("error"):
            self._sock.close()
            raise RemoteError(resp["error"])
        self._buf: List[Any] = []
        self._cond = threading.Condition()
        self._closed = False
        self.error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._reader,
                                        name="assignments-reader",
                                        daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        from ..manager.dispatcher import AssignmentsMessage
        try:
            while True:
                frame = recv_frame(self._sock)
                if frame.get("push") == "closed":
                    raise ConnectionError(frame.get("error")
                                          or "stream closed by server")
                changes = [
                    (c["action"], c["kind"],
                     serde.from_dict(_COLLECTIONS[
                         "tasks" if c["kind"] == "task"
                         else c["kind"] + "s"], c["obj"]))
                    for c in frame["changes"]]
                msg = AssignmentsMessage(frame["type"], frame["applies_to"],
                                         frame["results_in"], changes)
                with self._cond:
                    self._buf.append(msg)
                    self._cond.notify()
        except Exception as e:
            with self._cond:
                self.error = e
                self._closed = True
                self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            if not self._buf and not self._closed:
                self._cond.wait(timeout)
            if self._buf:
                return self._buf.pop(0)
            if self._closed:
                raise Closed()
            raise TimeoutError()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self, error: Optional[Exception] = None) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteDispatcherClient:
    """The agent's client surface over TCP."""

    def __init__(self, addr: Tuple[str, int], certificate: Certificate):
        self.addr = addr
        self.certificate = certificate
        self._conn = _Connection(addr, certificate)

    def register(self, node_id: str, description=None):
        result = self._conn.call("register", {
            "node_id": node_id,
            "description": serde.to_dict(description)
            if description is not None else None})
        return result["session_id"], result["period"]

    def heartbeat(self, node_id: str, session_id: str) -> float:
        resp = self._conn.call("heartbeat", {"node_id": node_id,
                                             "session_id": session_id})
        if isinstance(resp, dict):
            # the server piggybacks the current manager list on heartbeats
            # (reference: session Message.Managers); stash it for the
            # failover layer to feed into its Remotes tracker
            self.last_managers = [tuple(a) for a in
                                  resp.get("managers", [])]
            # ...and the active root digest, so the renewer reacts to a
            # CA rotation without waiting for cert half-life
            self.last_ca_digest = resp.get("ca_digest", "")
            # ...and the node's store-reconciled role, so promotion/
            # demotion is noticed within one heartbeat period
            self.last_role = resp.get("role")
            # ...and the dataplane encryption keys (reference:
            # SessionMessage.NetworkBootstrapKeys); the agent hands them
            # to its executor when the rotation clock advances
            if "network_keys" in resp:
                self.last_network_keys = resp["network_keys"]
                self.last_key_clock = resp.get("key_clock", 0)
            return resp["period"]
        return resp

    def publish_logs(self, node_id: str, session_id: str,
                     messages) -> None:
        import base64 as _b64
        self._conn.call("publish_logs", {
            "node_id": node_id, "session_id": session_id,
            "messages": [dict(m, data=_b64.b64encode(
                m["data"]).decode("ascii")) for m in messages]})

    def update_task_status(self, node_id: str, session_id: str,
                           updates: List[Tuple[str, TaskStatus]]) -> None:
        self._conn.call("update_task_status", {
            "node_id": node_id, "session_id": session_id,
            "updates": [{"task_id": tid, "status": serde.to_dict(st)}
                        for tid, st in updates]})

    def update_volume_status(self, node_id: str, session_id: str,
                             updates) -> None:
        self._conn.call("update_volume_status", {
            "node_id": node_id, "session_id": session_id,
            "updates": [[vid, bool(unpub)] for vid, unpub in updates]})

    def open_assignments(self, node_id: str,
                         session_id: str) -> RemoteAssignmentStream:
        return RemoteAssignmentStream(
            lambda: self._conn._connect(), node_id, session_id)

    def reset_connection(self) -> None:
        """Next call re-handshakes with the current certificate."""
        # sync a reassigned identity into the connection: it captured
        # the Certificate object at construction time
        self._conn.certificate = self.certificate
        self._conn.close()

    def close(self) -> None:
        self._conn.close()


class RemoteControlClient:
    """ControlAPI surface over TCP (for remote swarmctl)."""

    def __init__(self, addr: Tuple[str, int], certificate: Certificate):
        self._conn = _Connection(addr, certificate)

    def _call(self, method, **params):
        return self._conn.call(f"control.{method}", params)

    def create_service(self, spec):
        return _obj_in(self._call("create_service",
                                  spec=serde.to_dict(spec)))

    def update_service(self, service_id, version, spec):
        return _obj_in(self._call("update_service", service_id=service_id,
                                  version=version,
                                  spec=serde.to_dict(spec)))

    def remove_service(self, service_id):
        self._call("remove_service", service_id=service_id)

    def get_service(self, service_id):
        return _obj_in(self._call("get_service", service_id=service_id))

    def list_services(self, name_prefix: str = ""):
        return [_obj_in(o) for o in self._call(
            "list_services", name_prefix=name_prefix)]

    def list_service_statuses(self, service_ids):
        return self._call("list_service_statuses",
                          service_ids=list(service_ids))

    def list_nodes(self):
        return [_obj_in(o) for o in self._call("list_nodes")]

    def update_node(self, node_id, version, spec):
        return _obj_in(self._call("update_node", node_id=node_id,
                                  version=version,
                                  spec=serde.to_dict(spec)))

    def remove_node(self, node_id, force=False):
        self._call("remove_node", node_id=node_id, force=force)

    def list_tasks(self, service_id: str = "", node_id: str = ""):
        return [_obj_in(o) for o in self._call(
            "list_tasks", service_id=service_id, node_id=node_id)]

    def remove_task(self, task_id: str):
        self._call("remove_task", task_id=task_id)

    def collect_logs(self, service_id: str, duration: float = 2.0,
                     tail: int = -1, since: float = 0.0,
                     follow: bool = True, streams=None):
        import base64 as _b64
        return [dict(m, data=_b64.b64decode(m["data"]))
                for m in self._call("collect_logs",
                                    service_id=service_id,
                                    duration=duration, tail=tail,
                                    since=since, follow=follow,
                                    streams=list(streams or []))]

    def create_secret(self, spec):
        return _obj_in(self._call("create_secret",
                                  spec=serde.to_dict(spec)))

    def get_secret(self, secret_id):
        return _obj_in(self._call("get_secret", secret_id=secret_id))

    def get_config(self, config_id):
        return _obj_in(self._call("get_config", config_id=config_id))

    def list_secrets(self):
        return [_obj_in(o) for o in self._call("list_secrets")]

    def remove_secret(self, secret_id):
        self._call("remove_secret", secret_id=secret_id)

    def create_config(self, spec):
        return _obj_in(self._call("create_config",
                                  spec=serde.to_dict(spec)))

    def list_configs(self):
        return [_obj_in(o) for o in self._call("list_configs")]

    def remove_config(self, config_id):
        self._call("remove_config", config_id=config_id)

    def create_network(self, spec):
        return _obj_in(self._call("create_network",
                                  spec=serde.to_dict(spec)))

    def list_networks(self):
        return [_obj_in(o) for o in self._call("list_networks")]

    def remove_network(self, network_id):
        self._call("remove_network", network_id=network_id)

    def create_volume(self, spec):
        return _obj_in(self._call("create_volume",
                                  spec=serde.to_dict(spec)))

    def update_volume(self, volume_id, version, spec):
        return _obj_in(self._call("update_volume", volume_id=volume_id,
                                  version=version,
                                  spec=serde.to_dict(spec)))

    def get_volume(self, volume_id):
        return _obj_in(self._call("get_volume", volume_id=volume_id))

    def list_volumes(self, name_prefix: str = ""):
        return [_obj_in(o) for o in self._call("list_volumes",
                                               name_prefix=name_prefix)]

    def remove_volume(self, volume_id, force=False):
        self._call("remove_volume", volume_id=volume_id, force=force)

    def create_extension(self, annotations, description=""):
        return _obj_in(self._call("create_extension",
                                  annotations=serde.to_dict(annotations),
                                  description=description))

    def list_extensions(self):
        return [_obj_in(o) for o in self._call("list_extensions")]

    def remove_extension(self, extension_id):
        self._call("remove_extension", extension_id=extension_id)

    def create_resource(self, annotations, kind, payload=b""):
        import base64 as _b64
        return _obj_in(self._call(
            "create_resource", annotations=serde.to_dict(annotations),
            kind=kind, payload=_b64.b64encode(payload).decode("ascii")))

    def list_resources(self, kind: str = ""):
        return [_obj_in(o) for o in self._call("list_resources",
                                               kind=kind)]

    def remove_resource(self, resource_id):
        self._call("remove_resource", resource_id=resource_id)

    def rotate_join_token(self, role):
        return self._call("rotate_join_token", role=int(role))

    def get_default_cluster(self):
        return _obj_in(self._call("get_default_cluster"))

    def list_clusters(self):
        return [_obj_in(o) for o in self._call("list_clusters")]

    def health(self, service: str = "") -> str:
        return self._conn.call("health", {"service": service})["status"]

    def rotate_ca(self):
        return self._call("rotate_ca")

    def set_autolock(self, enabled: bool):
        return self._call("set_autolock", enabled=enabled)

    def get_unlock_key(self):
        return self._call("get_unlock_key")

    def close(self) -> None:
        self._conn.close()
