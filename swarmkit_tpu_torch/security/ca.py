"""Cluster CA: real x509 node identity, join tokens, issuance/rotation.

Reference: ca/{certificates.go,server.go,keyreadwriter.go} and
manager/encryption.

Certificates are real x509 (EC P-256, ECDSA-SHA256) built with the
``cryptography`` library, mirroring the reference's layout
(ca/certificates.go:167 RootCA; signNodeCert server.go:764):

  - root: self-signed CA cert, 20y validity, CN=swarm-ca, O=<cluster id>
  - node: CN=<node id>, OU=<role: swarm-manager|swarm-worker>,
    O=<cluster id>, signed by the root, default 90d validity

The same PEM material feeds the TLS transports (security/tls.py); the
``Certificate`` dataclass carries the cert PEM (wire form) plus the
private key and trust-root PEM locally (never serialized).  Join tokens
follow the reference's SWMTKN-1-<root cert digest>-<role secret> shape,
so a joiner can bootstrap-verify the downloaded root against its token
(reference: ca.DownloadRootCA digest check).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

log = logging.getLogger("security.ca")

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # gated dependency: importable module, unusable CA
    HAVE_CRYPTOGRAPHY = False

    class _MissingCrypto:
        """Raises on first use so importing this module (and everything
        that transitively pulls it in: manager, swarmd, agent wiring)
        works without the ``cryptography`` package; only actually
        creating/parsing certificates requires it."""

        def __init__(self, name: str):
            self._name = name

        def __getattr__(self, attr: str):
            raise ImportError(
                f"the 'cryptography' package is required for "
                f"{self._name}.{attr} (CA/TLS certificate operations)")

        def __call__(self, *a, **kw):
            raise ImportError(
                "the 'cryptography' package is required for CA/TLS "
                "certificate operations")

    x509 = _MissingCrypto("x509")
    hashes = _MissingCrypto("hashes")
    serialization = _MissingCrypto("serialization")
    ec = _MissingCrypto("ec")
    NameOID = _MissingCrypto("NameOID")

from ..models.types import NodeRole

DEFAULT_NODE_CERT_EXPIRY = 90 * 24 * 3600.0  # reference: ca/certificates.go
ROOT_CA_EXPIRY = 20 * 365 * 24 * 3600.0
TOKEN_VERSION = "SWMTKN-1"

# role <-> OU mapping (reference: ca/certificates.go ManagerRole/WorkerRole)
ROLE_OU = {NodeRole.MANAGER: "swarm-manager", NodeRole.WORKER: "swarm-worker"}
OU_ROLE = {v: k for k, v in ROLE_OU.items()}


class SecurityError(Exception):
    code = "unauthenticated"   # wire-error mapping (net/client.py)


class InvalidToken(SecurityError):
    pass


class InvalidCertificate(SecurityError):
    pass


def _b32(data: bytes) -> str:
    return base64.b32encode(data).decode("ascii").strip("=").lower()


def _ts(dt: datetime.datetime) -> float:
    return dt.replace(tzinfo=datetime.timezone.utc).timestamp() \
        if dt.tzinfo is None else dt.timestamp()


def _utc(ts: float) -> datetime.datetime:
    return datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)


def cert_digest(cert_pem: bytes) -> str:
    """Digest of a certificate's DER bytes — the token-embedded root
    fingerprint (must match RootCA.digest; both sides call this)."""
    der = x509.load_pem_x509_certificate(cert_pem).public_bytes(
        serialization.Encoding.DER)
    return hashlib.sha256(der).hexdigest()[:32]


def split_pem_certs(pem: bytes) -> list:
    """Individual certificate PEM blocks from a bundle."""
    marker = b"-----BEGIN CERTIFICATE-----"
    return [marker + part.split(b"-----END CERTIFICATE-----")[0]
            + b"-----END CERTIFICATE-----\n"
            for part in pem.split(marker)[1:]]


def signing_root_digest(cert: "Certificate") -> str:
    """Digest of the root (within the cert's own trust bundle) that
    signed its leaf — how a node tells whether its identity chains to
    the root a manager currently advertises ('' when undetermined)."""
    try:
        parsed = cert._x509()
    except Exception:
        return ""
    for ca_pem in split_pem_certs(cert.ca_cert_pem):
        try:
            ca = x509.load_pem_x509_certificate(ca_pem)
            if parsed.issuer != ca.subject:
                continue
            ca.public_key().verify(
                parsed.signature, parsed.tbs_certificate_bytes,
                ec.ECDSA(parsed.signature_hash_algorithm))
            return cert_digest(ca_pem)
        except Exception:
            continue
    return ""


def generate_key_pem() -> bytes:
    key = ec.generate_private_key(ec.SECP256R1())
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())


def make_csr(node_id: str, key_pem: bytes) -> bytes:
    """Client-side CSR for network issuance: the private key never leaves
    the node (reference: ca/certificates.go CreateCSR)."""
    key = serialization.load_pem_private_key(key_pem, password=None)
    csr = x509.CertificateSigningRequestBuilder().subject_name(
        x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, node_id)])
    ).sign(key, hashes.SHA256())
    return csr.public_bytes(serialization.Encoding.PEM)


@dataclass
class Certificate:
    """A node's x509 identity.  ``cert_pem`` is the wire form; the private
    key and the cluster trust root travel only inside the process / the
    node's key file."""

    cert_pem: bytes
    key_pem: bytes = b""       # node private key (local only)
    ca_cert_pem: bytes = b""   # trust root bundle (local only)

    def _x509(self) -> x509.Certificate:
        cached = self.__dict__.get("_parsed")
        if cached is None or self.__dict__.get("_parsed_src") != self.cert_pem:
            try:
                cached = x509.load_pem_x509_certificate(self.cert_pem)
            except Exception as e:
                raise InvalidCertificate(f"bad certificate PEM: {e}")
            self.__dict__["_parsed"] = cached
            self.__dict__["_parsed_src"] = self.cert_pem
        return cached

    @staticmethod
    def _name_attr(name: x509.Name, oid) -> str:
        attrs = name.get_attributes_for_oid(oid)
        return attrs[0].value if attrs else ""

    @property
    def node_id(self) -> str:
        return self._name_attr(self._x509().subject, NameOID.COMMON_NAME)

    @property
    def role(self) -> int:
        ou = self._name_attr(self._x509().subject,
                             NameOID.ORGANIZATIONAL_UNIT_NAME)
        return int(OU_ROLE.get(ou, NodeRole.WORKER))

    @property
    def org(self) -> str:
        return self._name_attr(self._x509().subject,
                               NameOID.ORGANIZATION_NAME)

    @property
    def issued_at(self) -> float:
        return _ts(self._x509().not_valid_before_utc)

    @property
    def expires_at(self) -> float:
        return _ts(self._x509().not_valid_after_utc)

    def to_bytes(self) -> bytes:
        return self.cert_pem

    @classmethod
    def from_bytes(cls, data: bytes) -> "Certificate":
        cert = cls(cert_pem=data)
        cert._x509()   # validate eagerly: wire data may be garbage
        return cert

    @classmethod
    def from_der(cls, der: bytes) -> "Certificate":
        try:
            parsed = x509.load_der_x509_certificate(der)
        except Exception as e:
            raise InvalidCertificate(f"bad certificate DER: {e}")
        return cls(cert_pem=parsed.public_bytes(serialization.Encoding.PEM))


class RootCA:
    """Cluster trust root (reference: ca/certificates.go:167 RootCA).

    ``key`` is the CA private key PEM — also used as the cluster's opaque
    secret for the WAL DEK and HMAC-transport fallback, matching the
    reference's use of the CA key material as the root of the key
    hierarchy (KEK -> DEK chain, manager/deks.go)."""

    def __init__(self, key: Optional[bytes] = None,
                 cert: Optional[bytes] = None,
                 node_cert_expiry: float = DEFAULT_NODE_CERT_EXPIRY):
        self.node_cert_expiry = node_cert_expiry
        if key is not None and not key.lstrip().startswith(b"-----"):
            raise ValueError(
                "RootCA key must be a private-key PEM (legacy raw-secret "
                "roots are not supported)")
        if key is None:
            key = generate_key_pem()
            cert = None
        self.key = key
        self._ca_key = serialization.load_pem_private_key(key, password=None)
        if cert is None:
            cert = self._self_sign()
        self.cert_pem = cert
        self._ca_cert = x509.load_pem_x509_certificate(cert)
        # secrets from which join tokens derive; rotating tokens replaces
        # these without touching the root key (reference: JoinTokens)
        self._token_secrets = {
            NodeRole.WORKER: os.urandom(16),
            NodeRole.MANAGER: os.urandom(16),
        }
        # in-progress root rotation (reference: api.RootRotation +
        # ca/reconciler.go): (new_key_pem, new_cert_pem, cross_signed_pem)
        self.rotation: Optional[Tuple[bytes, bytes, bytes]] = None

    @staticmethod
    def _self_sign_root(key, org: str) -> bytes:
        """Self-signed root with a SubjectKeyIdentifier — rotation keeps
        the subject name stable, so chains disambiguate issuers by key
        id, not name."""
        now = time.time()
        name = x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, "swarm-ca"),
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, org),
        ])
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(_utc(now - 60))
                .not_valid_after(_utc(now + ROOT_CA_EXPIRY))
                .add_extension(x509.BasicConstraints(ca=True,
                                                     path_length=None),
                               critical=True)
                .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                    key.public_key()), critical=False)
                .sign(key, hashes.SHA256()))
        return cert.public_bytes(serialization.Encoding.PEM)

    def _self_sign(self) -> bytes:
        org = _b32(os.urandom(10))   # cluster identity, baked into certs
        return self._self_sign_root(self._ca_key, org)

    def restore(self, key: bytes, cert: bytes) -> None:
        """Adopt persisted trust-root material (cluster restart)."""
        self.key = key
        self.cert_pem = cert
        self._ca_key = serialization.load_pem_private_key(key, password=None)
        self._ca_cert = x509.load_pem_x509_certificate(cert)

    # ----------------------------------------------------------- root rotation

    def cross_sign(self, new_cert_pem: bytes) -> bytes:
        """Old root signs a CA cert carrying the NEW root's subject and
        public key: nodes that trust only the old root then accept certs
        chaining through this intermediate (reference:
        ca/certificates.go CrossSignCACertificate)."""
        new_cert = x509.load_pem_x509_certificate(new_cert_pem)
        now_ts = time.time()
        cross = (x509.CertificateBuilder()
                 .subject_name(new_cert.subject)
                 .issuer_name(self._ca_cert.subject)
                 .public_key(new_cert.public_key())
                 .serial_number(x509.random_serial_number())
                 .not_valid_before(_utc(now_ts - 60))
                 .not_valid_after(new_cert.not_valid_after_utc)
                 .add_extension(x509.BasicConstraints(ca=True,
                                                      path_length=None),
                                critical=True)
                 .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                     new_cert.public_key()), critical=False)
                 .add_extension(
                     x509.AuthorityKeyIdentifier.from_issuer_public_key(
                         self._ca_cert.public_key()), critical=False)
                 .sign(self._ca_key, hashes.SHA256()))
        return cross.public_bytes(serialization.Encoding.PEM)

    def begin_rotation(self, new_key_pem: Optional[bytes] = None,
                       new_cert_pem: Optional[bytes] = None
                       ) -> Tuple[bytes, bytes, bytes]:
        """Start a root rotation: mint (or adopt) a new root and a
        cross-signed intermediate.  Issuance immediately switches to the
        new key; verification accepts both roots until finalize
        (reference: controlapi/ca_rotation.go newRootRotationObject)."""
        if new_key_pem is None:
            new_key_pem = generate_key_pem()
        if new_cert_pem is None:
            # same org (cluster identity), fresh root key + serial
            new_key = serialization.load_pem_private_key(new_key_pem,
                                                         password=None)
            new_cert_pem = self._self_sign_root(new_key, self.org)
        cross = self.cross_sign(new_cert_pem)
        self.rotation = (new_key_pem, new_cert_pem, cross)
        return self.rotation

    def restore_rotation(self, new_key_pem: bytes, new_cert_pem: bytes,
                         cross_pem: bytes) -> None:
        self.rotation = (new_key_pem, new_cert_pem, cross_pem)

    def finalize_rotation(self) -> None:
        """The new root becomes THE root; old-root certs stop verifying
        (the reconciler only finalizes once no node uses them)."""
        if self.rotation is None:
            return
        new_key, new_cert, _ = self.rotation
        self.rotation = None
        self.restore(new_key, new_cert)

    @property
    def active_digest(self) -> str:
        """Digest of the root nodes should be chaining to — the rotation
        target while one is in progress."""
        if self.rotation is not None:
            return cert_digest(self.rotation[1])
        return self.digest

    def trust_bundle(self) -> bytes:
        """PEM bundle clients should trust: both roots during rotation."""
        if self.rotation is not None:
            return self.cert_pem + self.rotation[1]
        return self.cert_pem

    def issuer_digest(self, cert: "Certificate") -> str:
        """Which root a node cert chains to ('' if neither)."""
        parsed = cert._x509()
        for ca_pem in ([self.cert_pem]
                       + ([self.rotation[1]] if self.rotation else [])):
            ca = x509.load_pem_x509_certificate(ca_pem)
            if parsed.issuer == ca.subject:
                try:
                    ca.public_key().verify(
                        parsed.signature, parsed.tbs_certificate_bytes,
                        ec.ECDSA(parsed.signature_hash_algorithm))
                    return cert_digest(ca_pem)
                except Exception:
                    continue
        return ""

    @property
    def org(self) -> str:
        attrs = self._ca_cert.subject.get_attributes_for_oid(
            NameOID.ORGANIZATION_NAME)
        return attrs[0].value if attrs else ""

    @property
    def digest(self) -> str:
        """Digest of the root certificate (token-embedded so joiners can
        verify a downloaded root, reference: ca/certificates.go digests)."""
        return cert_digest(self.cert_pem)

    # ---------------------------------------------------------- join tokens

    def join_token(self, role: NodeRole) -> str:
        """reference token shape: SWMTKN-1-<root digest>-<role secret>."""
        return "-".join([
            TOKEN_VERSION, self.digest,
            _b32(self._token_secrets[NodeRole(role)])])

    def restore_join_tokens(self, join_tokens) -> None:
        """Adopt previously issued tokens (cluster restart): the role
        secrets are recovered from the stored token strings."""
        for role, token in ((NodeRole.WORKER, join_tokens.worker),
                            (NodeRole.MANAGER, join_tokens.manager)):
            if not token:
                continue
            parts = token.split("-")
            if len(parts) != 4:
                continue
            pad = "=" * (-len(parts[3]) % 8)
            try:
                self._token_secrets[role] = base64.b32decode(
                    parts[3].upper() + pad)
            except Exception:
                pass

    def rotate_join_token(self, role: NodeRole) -> str:
        self._token_secrets[NodeRole(role)] = os.urandom(16)
        return self.join_token(role)

    def role_for_token(self, token: str) -> NodeRole:
        parts = token.split("-")
        if len(parts) != 4 or parts[0] + "-" + parts[1] != TOKEN_VERSION:
            raise InvalidToken("invalid join token")
        if parts[2] != self.digest:
            raise InvalidToken("join token is for a different cluster")
        for role, secret in self._token_secrets.items():
            if hmac.compare_digest(parts[3], _b32(secret)):
                return role
        raise InvalidToken("invalid join token")

    # --------------------------------------------------------- certificates

    def _build_cert(self, node_id: str, role: int, public_key,
                    expiry: Optional[float]) -> bytes:
        """Node cert under the active signer.  During a rotation the NEW
        key signs and the cross-signed intermediate travels appended in
        the PEM bundle, so peers trusting only the old root still verify
        the chain (reference: ca/certificates.go intermediates)."""
        now = time.time()
        signing_key, signing_cert, chain = self._ca_key, self._ca_cert, b""
        if self.rotation is not None:
            new_key_pem, new_cert_pem, cross = self.rotation
            signing_key = serialization.load_pem_private_key(
                new_key_pem, password=None)
            signing_cert = x509.load_pem_x509_certificate(new_cert_pem)
            chain = cross
        subject = x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, node_id),
            x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME,
                               ROLE_OU[NodeRole(role)]),
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, self.org),
        ])
        cert = (x509.CertificateBuilder()
                .subject_name(subject)
                .issuer_name(signing_cert.subject)
                .public_key(public_key)
                .serial_number(x509.random_serial_number())
                .not_valid_before(_utc(now - 60))
                .not_valid_after(_utc(now + (expiry
                                             or self.node_cert_expiry)))
                .add_extension(x509.BasicConstraints(ca=False,
                                                     path_length=None),
                               critical=True)
                .add_extension(
                    x509.AuthorityKeyIdentifier.from_issuer_public_key(
                        signing_cert.public_key()), critical=False)
                .sign(signing_key, hashes.SHA256()))
        return cert.public_bytes(serialization.Encoding.PEM) + chain

    def issue(self, node_id: str, role: int,
              expiry: Optional[float] = None) -> Certificate:
        """In-process issuance: keypair generated here (reference:
        ca/server.go:234 IssueNodeCertificate + signNodeCert :764; network
        joiners instead send a CSR so their key never travels)."""
        key_pem = generate_key_pem()
        key = serialization.load_pem_private_key(key_pem, password=None)
        cert_pem = self._build_cert(node_id, role, key.public_key(), expiry)
        return Certificate(cert_pem=cert_pem, key_pem=key_pem,
                           ca_cert_pem=self.trust_bundle())

    def sign_csr(self, csr_pem: bytes, node_id: str, role: int,
                 expiry: Optional[float] = None) -> bytes:
        """Sign a joiner's CSR.  The CN/OU are chosen by the CA (from the
        validated token/identity), never trusted from the CSR subject."""
        try:
            csr = x509.load_pem_x509_csr(csr_pem)
        except Exception as e:
            raise InvalidCertificate(f"bad CSR: {e}")
        return self._build_cert(node_id, role, csr.public_key(), expiry)

    def verify(self, cert: Certificate) -> None:
        parsed = cert._x509()
        roots = [self._ca_cert]
        if self.rotation is not None:
            roots.append(x509.load_pem_x509_certificate(self.rotation[1]))
        ok = False
        for root in roots:
            if parsed.issuer != root.subject:
                continue
            try:
                root.public_key().verify(
                    parsed.signature, parsed.tbs_certificate_bytes,
                    ec.ECDSA(parsed.signature_hash_algorithm))
                ok = True
                break
            except Exception:
                continue
        if not ok:
            raise InvalidCertificate(
                "certificate does not chain to a cluster root")
        now = time.time()
        if _ts(parsed.not_valid_after_utc) < now:
            raise InvalidCertificate("certificate expired")
        if _ts(parsed.not_valid_before_utc) > now + 300:
            raise InvalidCertificate("certificate not yet valid")

    def needs_renewal(self, cert: Certificate,
                      threshold: float = 0.5) -> bool:
        return needs_renewal(cert, threshold)


def needs_renewal(cert: Certificate, threshold: float = 0.5) -> bool:
    """Renew past half of validity (the reference renews in a jittered
    window before expiry, ca/renewer.go).  Needs no CA material, so
    nodes can decide locally."""
    lifetime = cert.expires_at - cert.issued_at
    return time.time() > cert.issued_at + lifetime * threshold


class KeyReadWriter:
    """Node key-material persistence with a KEK encryption seam
    (reference: ca/keyreadwriter.go; encryption: manager/encryption).
    Sealed with the same nonce + encrypt-then-MAC construction the raft
    WAL uses (state/raft/storage.KeyEncoder) — a fixed-pad XOR would leak
    plaintext across rewrites and allow undetected tampering."""

    def __init__(self, path: str, kek: Optional[bytes] = None):
        self.path = path
        self.kek = kek

    def _encoder(self, kek: bytes):
        from ..state.raft.storage import KeyEncoder
        return KeyEncoder(kek)

    def write(self, cert: Certificate, ca_key: bytes) -> None:
        payload = json.dumps({
            "cert": cert.cert_pem.decode(),
            "node_key": cert.key_pem.decode(),
            "ca_cert": cert.ca_cert_pem.decode(),
            "key": base64.b64encode(ca_key).decode(),
        }).encode()
        if self.kek:
            payload = b"ENC2" + self._encoder(self.kek).encode(payload)
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self.path)

    def read(self) -> Tuple[Certificate, bytes]:
        with open(self.path, "rb") as f:
            payload = f.read()
        if payload.startswith(b"ENC2"):
            if not self.kek:
                raise SecurityError("key material is locked (no KEK)")
            from ..state.raft.storage import DecryptionError
            try:
                payload = self._encoder(self.kek).decode(payload[4:])
            except DecryptionError:
                raise SecurityError(
                    "key material is corrupt or KEK is wrong")
        try:
            d = json.loads(payload)
        except Exception:
            raise SecurityError("key material is corrupt or KEK is wrong")
        cert = Certificate(
            cert_pem=d["cert"].encode(),
            key_pem=d.get("node_key", "").encode(),
            ca_cert_pem=d.get("ca_cert", "").encode())
        return cert, base64.b64decode(d["key"])

    def rotate_kek(self, new_kek: Optional[bytes]) -> None:
        cert, key = self.read()
        self.kek = new_kek
        self.write(cert, key)


class CAServer:
    """Issues certificates to token-bearing joiners
    (reference: ca/server.go:420 Run / :234 IssueNodeCertificate).

    When ``external`` is set (ClusterSpec.ca_config.external_cas), CSR
    signing is delegated to the CFSSL-style endpoint(s) instead of the
    local root key (reference: ca/external.go); unreachable signers fall
    back to local signing with a warning (documented deviation —
    security/external.py)."""

    def __init__(self, root_ca: RootCA):
        self.root_ca = root_ca
        self.external = None   # security.external.ExternalCA when set

    def _sign(self, csr_pem: bytes, node_id: str, role: int) -> bytes:
        ext = self.external   # snapshot: the config daemon may swap it
        if ext is not None:
            from .external import ExternalSigningError
            try:
                pem = ext.sign_csr(csr_pem, node_id, role)
                self._check_external_cert(pem, csr_pem)
                return pem
            except ExternalSigningError as e:
                log.warning("external CA signing failed (%s); "
                            "falling back to local root", e)
        return self.root_ca.sign_csr(csr_pem, node_id, role)

    def _check_external_cert(self, cert_pem: bytes,
                             csr_pem: bytes) -> None:
        """A signer that 'succeeds' with a bad certificate must not
        poison node identity: the result has to parse, chain to the
        cluster root, and carry the CSR's public key — anything else is
        a signing failure (and engages the local fallback)."""
        from .external import ExternalSigningError
        try:
            cert = Certificate(cert_pem=cert_pem,
                               ca_cert_pem=self.root_ca.trust_bundle())
            self.root_ca.verify(cert)
            csr = x509.load_pem_x509_csr(csr_pem)
            cert_key = cert._x509().public_key().public_bytes(
                serialization.Encoding.DER,
                serialization.PublicFormat.SubjectPublicKeyInfo)
            csr_key = csr.public_key().public_bytes(
                serialization.Encoding.DER,
                serialization.PublicFormat.SubjectPublicKeyInfo)
            if cert_key != csr_key:
                raise ExternalSigningError(
                    "signer returned a certificate for a different key")
        except ExternalSigningError:
            raise
        except Exception as e:
            raise ExternalSigningError(
                f"signer returned an invalid certificate: {e}") from e

    def issue_node_certificate(self, node_id: str, token: str,
                               csr_pem: Optional[bytes] = None):
        """Token-gated issuance.  With a CSR (network join) returns the
        signed cert PEM; without (in-process) returns a full Certificate
        incl. a server-generated key."""
        role = self.root_ca.role_for_token(token)
        if csr_pem is not None:
            return self._sign(csr_pem, node_id, role)
        return self.root_ca.issue(node_id, role)

    def renew(self, cert: Certificate,
              csr_pem: Optional[bytes] = None,
              role: Optional[int] = None):
        """Cert-gated renewal: same identity, fresh validity.  ``role``
        overrides the cert's role — the caller passes the node's current
        role from the store, so a node promoted/demoted by the role
        manager picks up its new role on renewal (reference:
        ca/server.go:377 issues for the store's node.Role, which is how
        role changes reach the node)."""
        self.root_ca.verify(cert)
        if role is None:
            role = cert.role
        if csr_pem is not None:
            return self._sign(csr_pem, cert.node_id, role)
        return self.root_ca.issue(cert.node_id, role)
