"""Node: the deployable unit — always an agent, optionally a manager.

Reference: node/node.go (run :286, runAgent :576, runManager :983,
loadSecurityConfig :799).

Joins a cluster via a join token presented to the CA server, persists its
certificate through the KeyReadWriter, registers itself in the cluster
store, and supervises agent (+ manager) lifecycles.  Transport is the
in-process dispatcher surface; a network client with the same methods
slots in unchanged.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from .agent import Agent
from .agent.exec import Executor
from .models.objects import Node as NodeObject
from .models.specs import NodeSpec
from .models.types import Annotations, NodeDescription, NodeRole
from .security.ca import CAServer, Certificate, KeyReadWriter, SecurityError
from .utils import new_id

log = logging.getLogger("node")


class LocalDispatcherClient:
    """In-process agent→dispatcher adapter.

    Same surface as the wire dispatcher client, plus the heartbeat
    piggyback the wire path gets from the server — network bootstrap keys
    (reference: SessionMessage.NetworkBootstrapKeys) read straight from
    the co-located store, so a manager's own agent follows key-manager
    rotations exactly like remote workers do."""

    def __init__(self, dispatcher):
        self._dispatcher = dispatcher
        self.last_network_keys = None
        self.last_key_clock = None

    def __getattr__(self, name):
        return getattr(self._dispatcher, name)

    def heartbeat(self, node_id: str, session_id: str) -> float:
        period = self._dispatcher.heartbeat(node_id, session_id)
        try:
            from .models.objects import Cluster
            cluster = self._dispatcher.store.view(
                lambda tx: next(iter(tx.find(Cluster)), None))
            if cluster is not None and cluster.network_bootstrap_keys:
                self.last_network_keys = list(
                    cluster.network_bootstrap_keys)
                self.last_key_clock = \
                    cluster.encryption_key_lamport_clock
        except Exception:
            log.exception("reading network bootstrap keys failed")
        return period


class Node:
    def __init__(self, executor: Executor, state_dir: str,
                 node_id: Optional[str] = None,
                 kek: Optional[bytes] = None):
        self.executor = executor
        self.state_dir = state_dir
        self.node_id = node_id or new_id()
        self.certificate: Optional[Certificate] = None
        self.key_rw = KeyReadWriter(
            os.path.join(state_dir, "certificates", "node.key"), kek=kek)
        self.agent: Optional[Agent] = None
        self.manager = None

    # ---------------------------------------------------------------- joining

    def load_or_join(self, ca_server: CAServer, join_token: str) -> None:
        """Obtain (or reload) this node's identity
        (reference: node.go:799 loadSecurityConfig)."""
        try:
            cert, _ = self.key_rw.read()
            ca_server.root_ca.verify(cert)
            self.certificate = cert
            self.node_id = cert.node_id
            if ca_server.root_ca.needs_renewal(cert):
                self.certificate = ca_server.renew(cert)
                self.key_rw.write(self.certificate, b"")
            return
        except (FileNotFoundError, SecurityError):
            pass
        cert = ca_server.issue_node_certificate(self.node_id, join_token)
        self.key_rw.write(cert, b"")
        self.certificate = cert

    @property
    def role(self) -> NodeRole:
        if self.certificate is None:
            return NodeRole.WORKER
        return NodeRole(self.certificate.role)

    # ------------------------------------------------------------- lifecycle

    def start(self, dispatcher_client, store=None,
              hostname: str = "") -> None:
        """Register in the cluster and run the agent; ``store`` is the
        manager-side store for self-registration (in-process mode)."""
        if store is not None:
            desc = None
            try:
                desc = self.executor.describe()
            except Exception:
                desc = NodeDescription(hostname=hostname or self.node_id[:8])
            node_obj = NodeObject(
                id=self.node_id,
                spec=NodeSpec(
                    annotations=Annotations(name=hostname or
                                            self.node_id[:8]),
                    desired_role=self.role),
                description=desc,
                role=int(self.role))

            def cb(tx):
                if tx.get(NodeObject, self.node_id) is None:
                    tx.create(node_obj)

            store.update(cb)
        if hasattr(dispatcher_client, "store"):
            # a bare in-process Dispatcher: wrap it so the heartbeat
            # piggyback (network bootstrap keys) works like the wire path
            dispatcher_client = LocalDispatcherClient(dispatcher_client)
        self.agent = Agent(
            self.node_id, self.executor, dispatcher_client,
            task_db_path=os.path.join(self.state_dir, "worker", "tasks.db"))
        self.agent.start()

    def stop(self) -> None:
        if self.agent is not None:
            self.agent.stop()
            self.agent = None
