"""``tests/test_external_ca.py`` on the port: a CFSSL-style signer backed
by the cluster root signs joins and renewals of the port's daemons, and a
bad signer falls back to the local root.  Every daemon gets
``device="cpu"``.  Each case gets one
retry after a failure, as ``tests/conftest.py`` gives the reference's
file (threads, TCP links, heartbeats and elections on a loaded runner).
"""

import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

from swarmkit_tpu_torch.models import Cluster
from swarmkit_tpu_torch.security.ca import RootCA, signing_root_digest
from swarmkit_tpu_torch.security.external import (
    ExternalCA, ExternalSigningError,
)
from swarmkit_tpu_torch.state.store import ByName
from swarmkit_tpu_torch.swarmd import Swarmd

import pytest

pytest.importorskip(
    "cryptography", reason="CA/TLS tests require the cryptography package")

from test_torch_raft import retried
from test_torch_dispatcher import (  # noqa: F401  (the fixture)
    poll, singletons_left_as_found,
)


class CFSSLServer:
    """Minimal cfssl 'sign' endpoint backed by a RootCA instance."""

    def __init__(self, root_ca: RootCA):
        outer = self
        self.root_ca = root_ca
        self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                outer.requests.append(body)
                csr = body["certificate_request"].encode()
                subject = body.get("subject", {})
                node_id = subject.get("CN", "")
                names = subject.get("names") or [{}]
                ou = names[0].get("OU", "swarm-worker")
                role = 1 if ou == "swarm-manager" else 0
                cert_pem = outer.root_ca.sign_csr(csr, node_id, role)
                resp = {"success": True,
                        "result": {"certificate": cert_pem.decode()}}
                payload = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@retried
def test_external_ca_unit_sign_and_failover():
    root = RootCA()
    good = CFSSLServer(root)
    try:
        from swarmkit_tpu_torch.security.ca import generate_key_pem, make_csr
        key_pem = generate_key_pem()
        csr = make_csr("node-1", key_pem)
        # a dead URL first: the client must fail over to the live one
        ext = ExternalCA(["http://127.0.0.1:1", good.url], org=root.org)
        cert_pem = ext.sign_csr(csr, "node-1", 0)
        from swarmkit_tpu_torch.security.ca import Certificate
        cert = Certificate(cert_pem=cert_pem, key_pem=key_pem,
                           ca_cert_pem=root.trust_bundle())
        root.verify(cert)
        assert cert.node_id == "node-1" and cert.role == 0
        assert ext.stats["signed"] == 1 and ext.stats["errors"] == 1

        ext_dead = ExternalCA(["http://127.0.0.1:1"], org=root.org)
        try:
            ext_dead.sign_csr(csr, "node-1", 0)
            raise AssertionError("dead signer should raise")
        except ExternalSigningError:
            pass
    finally:
        good.stop()


@retried
def test_external_ca_signs_cluster_joins_and_renewals():
    m0 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="m0", manager=True,
                listen_remote_api=("127.0.0.1", 0),
                use_device_scheduler=False, device="cpu")
    m0.start()
    signer = CFSSLServer(m0.manager.root_ca)
    w = None
    try:
        api = m0.manager.control_api
        c = api.store.view(
            lambda tx: tx.find(Cluster, ByName("default")))[0].copy()
        c.spec.ca_config.node_cert_expiry = 10.0   # force fast renewal
        api.store.update(lambda tx: tx.update(c))
        # the operator surface: swarmctl cluster external-ca <url>
        from swarmkit_tpu_torch.cli import run_command
        out = run_command(["cluster", "external-ca", signer.url], api)
        assert signer.url in out
        poll(lambda: m0.manager.ca_server.external is not None,
             msg="manager wires the external signer from the spec")

        w = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w0",
                   join_addr=m0.server.addr,
                   join_token=m0.manager.root_ca.join_token(0),
                   cert_renew_interval=0.5, device="cpu")
        w.start()
        assert len(signer.requests) >= 1, \
            "the join CSR must be signed externally"
        cert0 = w.node.certificate
        m0.manager.root_ca.verify(cert0)
        assert signing_root_digest(cert0) == m0.manager.root_ca.digest

        # renewal also routes through the external signer
        n_before = len(signer.requests)
        poll(lambda: w.node.certificate.expires_at > cert0.expires_at,
             timeout=20, msg="renewal happens")
        assert len(signer.requests) > n_before, \
            "the renewal CSR must be signed externally"

        # signer dies: issuance falls back to the local root (documented
        # deviation) and the cluster keeps admitting nodes
        signer.stop()
        w2 = Swarmd(state_dir=tempfile.mkdtemp(), hostname="w1",
                    join_addr=m0.server.addr,
                    join_token=m0.manager.root_ca.join_token(0), device="cpu")
        w2.start()
        try:
            m0.manager.root_ca.verify(w2.node.certificate)
        finally:
            w2.stop()
    finally:
        if w is not None:
            w.stop()
        try:
            signer.stop()
        except Exception:
            pass
        m0.stop()


@retried
def test_external_ca_bad_signer_falls_back_to_local():
    """A signer that 'succeeds' with a cert from the WRONG root must not
    poison node identity: validation rejects it and the local root
    signs."""
    from swarmkit_tpu_torch.security.ca import (
        CAServer, generate_key_pem, make_csr,
    )

    cluster_root = RootCA()
    foreign_root = RootCA()          # evil/misconfigured signer backing
    bad = CFSSLServer(foreign_root)
    try:
        server = CAServer(cluster_root)
        server.external = ExternalCA([bad.url], org=cluster_root.org)
        key_pem = generate_key_pem()
        csr = make_csr("node-x", key_pem)
        token = cluster_root.join_token(0)
        cert_pem = server.issue_node_certificate("node-x", token,
                                                 csr_pem=csr)
        assert len(bad.requests) == 1, "the bad signer was consulted"
        from swarmkit_tpu_torch.security.ca import Certificate
        cert = Certificate(cert_pem=cert_pem, key_pem=key_pem,
                           ca_cert_pem=cluster_root.trust_bundle())
        cluster_root.verify(cert)    # locally-signed fallback chains
    finally:
        bad.stop()
