"""Wire protocol: length-prefixed JSON frames over TCP.

Reference role: the gRPC/mTLS links of the reference (api/*.proto services
over DCN).  Framing is 4-byte big-endian length + UTF-8 JSON; every
connection opens with a ``hello`` frame carrying the peer's certificate
attestation, which the server verifies against the cluster root CA — the
mTLS handshake stand-in (see security/ca.py's scope note).

Frame shapes:
  request:  {"id": n, "method": str, "params": {...}}
  response: {"id": n, "result": ...} | {"id": n, "error", "code"}
  push:     {"push": ..., ...}      (server-initiated, streams)
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Optional

MAX_FRAME = 64 << 20


class WireError(Exception):
    pass


def send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(data) > MAX_FRAME:
        raise WireError("frame too large")
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_frame(sock: socket.socket) -> Any:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise WireError("frame too large")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)
