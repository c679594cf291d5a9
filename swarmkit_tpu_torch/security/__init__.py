from .ca import (
    CAServer, Certificate, InvalidCertificate, InvalidToken, KeyReadWriter,
    RootCA, SecurityError, generate_key_pem, make_csr,
)
from .tls import client_context, peer_certificate, server_context

__all__ = ["CAServer", "Certificate", "InvalidCertificate", "InvalidToken",
           "KeyReadWriter", "RootCA", "SecurityError", "generate_key_pem",
           "make_csr", "client_context", "peer_certificate",
           "server_context"]
