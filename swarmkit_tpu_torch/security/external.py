"""External CA: delegate node-certificate signing to a CFSSL-style
HTTP(S) endpoint instead of the local root key.

Reference: ca/external.go:1 (ExternalCA.Sign posting a CFSSL sign
request), ca/certificates.go request shape.  The operator configures
signer URLs in ClusterSpec.ca_config.external_cas; the manager then
POSTs each CSR as ``{"certificate_request": <pem>, "subject": {...}}``
to ``<url>`` and uses the returned certificate.

Deviation (documented): the reference can run managers that never hold
the root key at all; here the cluster root key stays with the managers
(it also seals the raft WAL), and the external signer is a signing
*policy*.  When every configured signer is unreachable the manager falls
back to local signing with a warning rather than refusing certs —
availability over purity; the fallback is visible in logs and counters.
"""

from __future__ import annotations

import json
import logging
import ssl
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

log = logging.getLogger("security.external")


class ExternalSigningError(Exception):
    """No configured external signer produced a certificate."""


# OU strings must match the local CA's role mapping (security/ca.py)
_ROLE_OU = {0: "swarm-worker", 1: "swarm-manager"}


class ExternalCA:
    """CFSSL-compatible signer client (reference: ca/external.go).

    ``urls``: signer endpoints, tried in order.  ``org``: the cluster id,
    carried in the subject override so the signer mints certs the
    cluster's authorization checks accept.  ``tls_identity``: optional
    manager Certificate for mutual TLS towards an https signer.
    ``ca_cert_pem``: trust anchor for verifying the signer's server cert.
    """

    def __init__(self, urls: Sequence[str], org: str = "",
                 tls_identity=None, ca_cert_pem: bytes = b"",
                 timeout: float = 5.0):
        self.urls: List[str] = [u for u in urls if u]
        self.org = org
        self.timeout = timeout
        self.stats = {"signed": 0, "errors": 0}
        self._ctx: Optional[ssl.SSLContext] = None
        if any(u.startswith("https") for u in self.urls):
            ctx = ssl.create_default_context()
            if ca_cert_pem:
                ctx.load_verify_locations(cadata=ca_cert_pem.decode())
                ctx.check_hostname = False
            if tls_identity is not None and tls_identity.key_pem:
                from .tls import _load_chain   # shared temp-file seam
                _load_chain(ctx, tls_identity.cert_pem,
                            tls_identity.key_pem)
            self._ctx = ctx

    def sign_csr(self, csr_pem: bytes, node_id: str, role: int) -> bytes:
        """POST the CSR to each signer until one returns a certificate
        (reference: external.go Sign + makeExternalSignRequest)."""
        payload = json.dumps({
            "certificate_request": csr_pem.decode(),
            "subject": {
                "CN": node_id,
                "names": [{"OU": _ROLE_OU.get(int(role), "swarm-worker"),
                           "O": self.org}],
            },
        }).encode()
        last: Optional[Exception] = None
        for url in self.urls:
            req = urllib.request.Request(
                url, data=payload,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout,
                        context=self._ctx if url.startswith("https")
                        else None) as resp:
                    body = json.loads(resp.read())
            except (urllib.error.URLError, OSError, ValueError) as e:
                log.warning("external CA %s failed: %s", url, e)
                self.stats["errors"] += 1
                last = e
                continue
            if not body.get("success", False):
                self.stats["errors"] += 1
                last = ExternalSigningError(str(body.get("errors")))
                continue
            cert = body.get("result", {}).get("certificate", "")
            if not cert:
                self.stats["errors"] += 1
                last = ExternalSigningError("signer returned no certificate")
                continue
            self.stats["signed"] += 1
            return cert.encode()
        raise ExternalSigningError(
            f"all external CAs failed (last: {last})")
