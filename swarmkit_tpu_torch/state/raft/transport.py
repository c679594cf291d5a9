"""Raft message transport.

Reference: manager/state/raft/transport/ (per-peer gRPC streams).  The
in-process implementation routes messages between nodes in one process and
supports pausing/partitioning links — the test capability the reference
gets from its WrappedListener (testutils.go:31).  A network transport
implements the same two-method surface.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Set, Tuple

from .core import Message


class LocalNetwork:
    """Message router for in-process clusters, with fault injection."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._handlers: Dict[str, Callable[[Message], None]] = {}
        self._paused: Set[str] = set()
        self._cut: Set[Tuple[str, str]] = set()

    def register(self, node_id: str,
                 handler: Callable[[Message], None]) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)

    # ------------------------------------------------------- fault injection

    def pause(self, node_id: str) -> None:
        """Isolate a node entirely (both directions)."""
        with self._lock:
            self._paused.add(node_id)

    def resume(self, node_id: str) -> None:
        with self._lock:
            self._paused.discard(node_id)

    def cut(self, a: str, b: str) -> None:
        """Sever the link between two nodes (both directions)."""
        with self._lock:
            self._cut.add((a, b))
            self._cut.add((b, a))

    def heal(self, a: str, b: str) -> None:
        with self._lock:
            self._cut.discard((a, b))
            self._cut.discard((b, a))

    # --------------------------------------------------------------- sending

    def send(self, msg: Message) -> None:
        with self._lock:
            if msg.src in self._paused or msg.dst in self._paused:
                return
            if (msg.src, msg.dst) in self._cut:
                return
            handler = self._handlers.get(msg.dst)
        if handler is not None:
            handler(msg)
