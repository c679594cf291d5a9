"""TLS transport security over the cluster CA.

Reference: ca/transport.go (NewServerTLSConfig / NewClientTLSConfig) —
every link in the reference runs mutual TLS rooted at the cluster CA.
Here the stdlib ``ssl`` module provides the handshake; certificates and
keys come from security/ca.py's x509 material.

Server contexts verify client certs against the cluster root when the
client presents one (CERT_OPTIONAL): the CA-issuance method must remain
reachable by certless token-bearing joiners on the same port, exactly
like the reference's NodeCA service; every other method is gated on the
TLS-authenticated peer identity by the server dispatch.

``ssl`` wants key material as files: contexts are built through a
private temp file that is unlinked immediately after loading.
"""

from __future__ import annotations

import os
import ssl
import tempfile
from typing import Optional

from .ca import Certificate, InvalidCertificate, SecurityError


def _load_chain(ctx: ssl.SSLContext, cert_pem: bytes,
                key_pem: bytes) -> None:
    fd, path = tempfile.mkstemp(prefix="swarm-tls-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(cert_pem + b"\n" + key_pem)
        ctx.load_cert_chain(path)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def server_context(identity: Certificate,
                   require_client_cert: bool = False) -> ssl.SSLContext:
    """mTLS server side: presents ``identity``, verifies client certs
    against the cluster root when offered (CERT_OPTIONAL — the issuance
    RPC is token-gated instead, like the reference's NodeCA).  Links that
    never serve joiners (raft peers) set ``require_client_cert``."""
    if not identity.key_pem or not identity.ca_cert_pem:
        raise SecurityError("server TLS identity needs key + trust root")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    _load_chain(ctx, identity.cert_pem, identity.key_pem)
    ctx.load_verify_locations(cadata=identity.ca_cert_pem.decode())
    ctx.verify_mode = (ssl.CERT_REQUIRED if require_client_cert
                       else ssl.CERT_OPTIONAL)
    return ctx


def client_context(identity: Optional[Certificate] = None,
                   ca_cert_pem: bytes = b"",
                   insecure: bool = False) -> ssl.SSLContext:
    """mTLS client side.  ``insecure=True`` skips server verification —
    only for the join bootstrap, where the fetched root is then checked
    against the token digest (reference: ca.DownloadRootCA)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False   # identity = cert CN (node id), not DNS
    if insecure:
        ctx.verify_mode = ssl.CERT_NONE
    else:
        ca = ca_cert_pem or (identity.ca_cert_pem if identity else b"")
        if not ca:
            raise SecurityError("client TLS needs the cluster root cert")
        ctx.load_verify_locations(cadata=ca.decode())
        ctx.verify_mode = ssl.CERT_REQUIRED
    if identity is not None and identity.key_pem:
        _load_chain(ctx, identity.cert_pem, identity.key_pem)
    return ctx


def peer_certificate(ssl_sock: ssl.SSLSocket) -> Optional[Certificate]:
    """The TLS-authenticated peer identity, or None when the peer sent no
    cert (certless joiner on a CERT_OPTIONAL server)."""
    der = ssl_sock.getpeercert(binary_form=True)
    if not der:
        return None
    return Certificate.from_der(der)


def require_server_role(ssl_sock: ssl.SSLSocket, role_ou: str) -> None:
    """Client-side authorization of the server: the chain is verified by
    the handshake, but only a manager-role cert may serve the cluster
    APIs (reference: ca/transport.go ServerName/role checks)."""
    cert = peer_certificate(ssl_sock)
    if cert is None:
        raise InvalidCertificate("server presented no certificate")
    from .ca import OU_ROLE, ROLE_OU
    from ..models.types import NodeRole
    ou = ROLE_OU.get(NodeRole(cert.role), "")
    if ou != role_ou:
        raise InvalidCertificate(
            f"server certificate role {ou!r} != required {role_ou!r}")
