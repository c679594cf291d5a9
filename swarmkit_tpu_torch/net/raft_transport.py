"""TCP raft transport: manager↔manager consensus traffic over the network.

Reference: manager/state/raft/transport/ (per-peer gRPC streams with
ordered delivery, mTLS via ca/transport.go).  Each member listens on a
TCP port; sends go over one persistent, ordered connection per peer with
automatic reconnect.  Implements the same two-method surface as
transport.LocalNetwork, so RaftNode is transport-agnostic.

Security: with ``tls_identity`` (a manager Certificate) every link is
mutual TLS — both sides must present manager-role certs chaining to the
cluster root.  The ``auth_key`` HMAC-hello is the plaintext fallback knob.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import queue
import socket
import socketserver
import ssl
import threading
from typing import Callable, Dict, Optional, Tuple

from ..security.ca import SecurityError
from ..state import serde
from ..state.raft.core import Message
from .wire import recv_frame, send_frame

log = logging.getLogger("net.raft")


class TCPRaftTransport:
    def __init__(self, node_id: str, host: str = "127.0.0.1",
                 port: int = 0, auth_key: Optional[bytes] = None,
                 tls_identity=None):
        """``tls_identity``: this manager's Certificate (with key + trust
        root) — enables mutual TLS with CERT_REQUIRED and manager-role
        authorization both ways.  ``auth_key``: shared-secret HMAC hello,
        the plaintext fallback — consensus traffic is manager-only either
        way."""
        self.node_id = node_id
        self.auth_key = auth_key
        self.tls_identity = None
        self._server_ctx = None
        self._client_ctx = None
        if tls_identity is not None:
            self.set_identity(tls_identity)
        self._handler: Optional[Callable[[Message], None]] = None
        self._peers: Dict[str, Tuple[str, int]] = {}
        self._send_queues: Dict[str, "queue.Queue"] = {}
        self._senders: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        # live inbound connections: must be force-closed on shutdown or a
        # peer's established socket keeps feeding a DEAD transport — the
        # peer never redials, and a restarted member on the same port
        # never hears from it (no elections ever complete)
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                try:
                    ctx = outer._server_ctx
                    if ctx is not None:
                        try:
                            sock = ctx.wrap_socket(sock, server_side=True)
                            outer._authorize_peer(sock)
                        except Exception as e:
                            log.warning("rejected raft peer: %s", e)
                            return
                    elif outer.auth_key is not None:
                        hello = recv_frame(sock)
                        sig = hello.get("hello", "")
                        if not hmac.compare_digest(sig, outer._hello_sig()):
                            log.warning("rejected unauthenticated raft peer")
                            return
                    with outer._conns_mu:
                        outer._conns.add(sock)
                    while not outer._stop.is_set():
                        frame = recv_frame(sock)
                        handler = outer._handler
                        if handler is None:
                            break   # unregistered: force the peer to redial
                        handler(serde.from_dict(Message, frame))
                except (ConnectionError, OSError, ValueError):
                    pass
                finally:
                    with outer._conns_mu:
                        outer._conns.discard(sock)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)
        self.addr = self._server.server_address
        threading.Thread(target=self._server.serve_forever,
                         name=f"raft-listen-{node_id}",
                         daemon=True).start()

    def _hello_sig(self) -> str:
        return hmac.new(self.auth_key or b"", b"raft-transport-v1",
                        hashlib.sha256).hexdigest()

    def set_identity(self, tls_identity) -> None:
        """(Re)build TLS contexts — also used when a restarted bootstrap
        manager adopts the replicated cluster's CA."""
        from ..security.tls import client_context, server_context
        self.tls_identity = tls_identity
        self._server_ctx = server_context(tls_identity,
                                          require_client_cert=True)
        self._client_ctx = client_context(tls_identity)

    @staticmethod
    def _authorize_peer(ssl_sock) -> None:
        """Both raft-link directions require the manager role."""
        from ..security.tls import require_server_role
        require_server_role(ssl_sock, "swarm-manager")

    # ------------------------------------------------------------- topology

    def set_peer(self, node_id: str, addr: Tuple[str, int]) -> None:
        """reference: transport.go:157 AddPeer / UpdatePeer."""
        self._peers[node_id] = tuple(addr)

    def remove_peer(self, node_id: str) -> None:
        self._peers.pop(node_id, None)
        q = self._send_queues.pop(node_id, None)
        if q is not None:
            q.put(None)

    # ------------------------------------------------------ RaftNode surface

    def register(self, node_id: str,
                 handler: Callable[[Message], None]) -> None:
        self._handler = handler

    def unregister(self, node_id: str) -> None:
        self._handler = None
        self._stop.set()
        for q in self._send_queues.values():
            q.put(None)
        self._server.shutdown()
        self._server.server_close()
        # server_close only stops the accept loop; established inbound
        # sockets live in handler threads and must be closed too, or
        # peers keep sending into this dead transport instead of
        # redialing our successor on the same port
        with self._conns_mu:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass

    def send(self, msg: Message) -> None:
        """Ordered, best-effort delivery per peer (raft tolerates loss)."""
        q = self._send_queues.get(msg.dst)
        if q is None:
            if msg.dst not in self._peers:
                return
            q = self._send_queues.setdefault(msg.dst, queue.Queue(
                maxsize=1024))
            t = threading.Thread(target=self._sender_loop,
                                 args=(msg.dst, q),
                                 name=f"raft-send-{msg.dst}", daemon=True)
            self._senders[msg.dst] = t
            t.start()
        try:
            q.put_nowait(msg)
        except queue.Full:
            pass  # drop under backpressure; raft retries

    def _sender_loop(self, peer: str, q: "queue.Queue") -> None:
        sock: Optional[socket.socket] = None
        while not self._stop.is_set():
            msg = q.get()
            if msg is None:
                break
            addr = self._peers.get(peer)
            if addr is None:
                continue
            for attempt in (1, 2):
                try:
                    if sock is None:
                        sock = socket.create_connection(addr, timeout=5)
                        if self._client_ctx is not None:
                            sock = self._client_ctx.wrap_socket(sock)
                            self._authorize_peer(sock)
                        elif self.auth_key is not None:
                            send_frame(sock, {"hello": self._hello_sig()})
                    send_frame(sock, serde.to_dict(msg))
                    break
                except (ssl.SSLError, ConnectionError, OSError,
                        SecurityError):
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                        sock = None
                    # second attempt reconnects; then drop the message
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
