"""The port's ``security/`` against the reference's, on the CPU: one trust
root shared by both packages gives the same digests, join tokens and
sealed key material either way, and the port's certificates build TLS
contexts that complete a handshake.  Every case needs the
``cryptography`` package and is gated on ``HAVE_CRYPTOGRAPHY``, as the
reference gates its CA cases."""

import importlib
import socket
import threading

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # jax 0.9 moved the scoped x64 switch; the reference imports the old name
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from swarmkit_tpu_torch.security.ca import HAVE_CRYPTOGRAPHY  # noqa: E402

REF, PORT = "swarmkit_tpu", "swarmkit_tpu_torch"
BOTH_WAYS = [(REF, PORT), (PORT, REF)]

pytestmark = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY, reason="requires the 'cryptography' package")


def _ca(pkg):
    return importlib.import_module(f"{pkg}.security.ca")


def _types(pkg):
    return importlib.import_module(f"{pkg}.models.types")


@pytest.fixture(scope="module")
def root():
    """One trust root (key and certificate PEM), made by the reference."""
    ca = _ca(REF).RootCA()
    return ca.key, ca.cert_pem


@pytest.mark.parametrize("issuer", [REF, PORT])
def test_digests_agree_for_one_key(root, issuer):
    """Both packages' ``RootCA`` over one key give one digest, and a
    certificate issued by either has the same ``cert_digest`` and
    ``signing_root_digest`` in both."""
    key, cert = root
    cas = {pkg: _ca(pkg).RootCA(key=key, cert=cert) for pkg in (REF, PORT)}
    assert cas[REF].digest == cas[PORT].digest
    issued = cas[issuer].issue("node-1", 0)
    for pkg in (REF, PORT):
        ca = _ca(pkg)
        c = ca.Certificate(cert_pem=issued.cert_pem, key_pem=issued.key_pem,
                           ca_cert_pem=issued.ca_cert_pem)
        assert ca.cert_digest(issued.cert_pem) == \
            _ca(REF).cert_digest(issued.cert_pem)
        assert ca.cert_digest(cert) == cas[REF].digest
        assert ca.signing_root_digest(c) == cas[REF].digest
        cas[pkg].verify(c)


@pytest.mark.parametrize("maker,checker", BOTH_WAYS)
def test_join_tokens_verify_across_packages(root, maker, checker):
    """A join token made by one package's ``RootCA`` verifies with the
    other's once both hold the same token secrets; a rotated token from
    the maker does not."""
    key, cert = root
    a = _ca(maker).RootCA(key=key, cert=cert)
    b = _ca(checker).RootCA(key=key, cert=cert)
    roles = _types(maker).NodeRole
    tokens = _types(checker).JoinTokens(
        worker=a.join_token(roles.WORKER),
        manager=a.join_token(roles.MANAGER))
    b.restore_join_tokens(tokens)
    want = _types(checker).NodeRole
    assert b.role_for_token(tokens.worker) == want.WORKER
    assert b.role_for_token(tokens.manager) == want.MANAGER
    assert b.join_token(want.WORKER) == tokens.worker
    rotated = a.rotate_join_token(roles.WORKER)
    with pytest.raises(_ca(checker).InvalidToken):
        b.role_for_token(rotated)


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_key_material_unseals_across_packages(tmp_path, root, writer,
                                              reader):
    """``KeyReadWriter`` output sealed under a KEK by one package unseals
    in the other; a wrong KEK or none fails."""
    key, cert = root
    issued = _ca(writer).RootCA(key=key, cert=cert).issue("node-2", 1)
    path = str(tmp_path / "node.key")
    _ca(writer).KeyReadWriter(path, kek=b"kek-1").write(issued, key)
    got, ca_key = _ca(reader).KeyReadWriter(path, kek=b"kek-1").read()
    assert ca_key == key
    assert (got.cert_pem, got.key_pem, got.ca_cert_pem) == \
        (issued.cert_pem, issued.key_pem, issued.ca_cert_pem)
    assert got.node_id == "node-2" and got.role == 1
    for kek in (b"kek-2", None):
        with pytest.raises(_ca(reader).SecurityError):
            _ca(reader).KeyReadWriter(path, kek=kek).read()


def test_port_certificates_complete_a_tls_handshake(root):
    """``tls.server_context`` and ``tls.client_context`` build from
    certificates the port's ``CAServer`` issues (a joiner's CSR signed
    under a join token), and the two complete a mutual TLS handshake over
    a local socket pair; the server sees the client's identity."""
    from swarmkit_tpu_torch.models.types import NodeRole
    from swarmkit_tpu_torch.security import (
        CAServer, Certificate, RootCA, client_context, generate_key_pem,
        make_csr, peer_certificate, server_context,
    )
    key, cert = root
    ca = RootCA(key=key, cert=cert)
    server_id = ca.issue("manager-1", int(NodeRole.MANAGER))
    node_key = generate_key_pem()
    pem = CAServer(ca).issue_node_certificate(
        "worker-1", ca.join_token(NodeRole.WORKER),
        csr_pem=make_csr("worker-1", node_key))
    client_id = Certificate(cert_pem=pem, key_pem=node_key,
                            ca_cert_pem=ca.cert_pem)
    ca.verify(client_id)
    _ca(REF).RootCA(key=key, cert=cert).verify(
        _ca(REF).Certificate(cert_pem=pem, key_pem=node_key,
                             ca_cert_pem=ca.cert_pem))
    srv_ctx = server_context(server_id, require_client_cert=True)
    cli_ctx = client_context(client_id)
    a, b = socket.socketpair()
    seen = {}

    def serve():
        with srv_ctx.wrap_socket(a, server_side=True) as s:
            seen["peer"] = peer_certificate(s)
            s.sendall(s.recv(5))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with cli_ctx.wrap_socket(b) as c:
        c.sendall(b"hello")
        assert c.recv(5) == b"hello"
    t.join(timeout=10)
    assert seen["peer"].node_id == "worker-1"
    assert seen["peer"].role == int(NodeRole.WORKER)
