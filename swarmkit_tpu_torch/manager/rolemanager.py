"""Role manager: reconciles node desired_role changes with raft membership
and certificates.

Reference: manager/role_manager.go — promotion adds the node to the raft
cluster; demotion removes it from raft FIRST and only then changes the
observed role (design/raft.md:136-158: removing before demoting avoids a
window where a manager holds raft state it should not).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..models.objects import Node
from ..models.types import NodeRole
from ..state.events import Event
from ..state.store import MemoryStore
from ..state.watch import Closed

log = logging.getLogger("rolemanager")


RECONCILE_INTERVAL = 5.0   # periodic pass so transient failures retry


class RoleManager:
    def __init__(self, store: MemoryStore, raft_node=None,
                 reconcile_interval: float = RECONCILE_INTERVAL):
        self.store = store
        self.raft = raft_node
        self.reconcile_interval = reconcile_interval
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="rolemanager",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # must outlast a membership proposal in flight (10s wait in
        # _propose_conf) so no orphaned thread acts after leadership loss
        self._done.wait(timeout=15)

    def run(self) -> None:
        try:
            def pred(ev):
                return (isinstance(ev, Event)
                        and isinstance(ev.obj, Node))

            def init(tx):
                return tx.find(Node)

            nodes, sub = self.store.view_and_watch(init, predicate=pred,
                                                   accepts_blocks=True)
            try:
                for n in nodes:
                    self._reconcile(n)
                from ..models.types import now as _now
                next_pass = _now() + self.reconcile_interval
                while not self._stop.is_set():
                    try:
                        ev = sub.get(timeout=0.2)
                    except TimeoutError:
                        ev = None
                    except Closed:
                        return
                    if ev is not None and ev.action != "delete":
                        self._reconcile(ev.obj)
                    if _now() >= next_pass:
                        # ticker: retry transiently-failed transitions
                        # (reference: role_manager.go's ticker)
                        next_pass = _now() + self.reconcile_interval
                        for n in self.store.view(
                                lambda tx: tx.find(Node)):
                            self._reconcile(n)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _reconcile(self, node: Node) -> None:
        desired = NodeRole(node.spec.desired_role)
        observed = NodeRole(node.role)
        if desired == observed:
            if (desired == NodeRole.WORKER and self.raft is not None
                    and node.id != self.raft.id
                    and node.id in getattr(self.raft.core, "peers", set())):
                # phantom voter: a raft join racing a demotion can land
                # AFTER the observed role flipped to worker (the join RPC
                # is gated on the still-valid manager cert).  The ticker
                # re-runs this sweep, so the dead member cannot inflate
                # quorum forever.
                try:
                    self.raft.remove_member(node.id)
                    log.info("removed phantom raft member %s "
                             "(role is worker)", node.id[:8])
                except Exception:
                    log.exception("removing phantom member %s failed",
                                  node.id)
            return
        if desired == NodeRole.WORKER:
            # demotion: leave raft BEFORE flipping the observed role
            # (design/raft.md:136-158)
            if self.raft is not None and \
                    node.id in getattr(self.raft.core, "peers", set()):
                if node.id == self.raft.id and self.raft.is_leader:
                    # demoting ourselves: hand leadership off first; the
                    # next leader's role manager performs the removal
                    # (reference: TransferLeadership before self-demotion)
                    log.info("stepping down before self-demotion")
                    self.raft.step_down()
                    return
                try:
                    self.raft.remove_member(node.id)
                except Exception:
                    log.exception("removing %s from raft failed", node.id)
                    return  # the ticker retries
            self._set_observed_role(node.id, NodeRole.WORKER)
        else:
            # promotion: flip the observed role only — raft membership is
            # added when the promoted node's manager process actually
            # joins via the raft_join RPC (net/server.py; reference:
            # JoinAndStart -> Join RPC on the leader).  Adding a
            # not-yet-running member here would inflate quorum with a dead
            # peer and can wedge small clusters.
            self._set_observed_role(node.id, NodeRole.MANAGER)

    def _set_observed_role(self, node_id: str, role: NodeRole) -> None:
        def cb(tx):
            n = tx.get(Node, node_id)
            if n is None or n.role == int(role):
                return
            n = n.copy()
            n.role = int(role)
            tx.update(n)

        try:
            self.store.update(cb)
            log.info("node %s role reconciled to %s", node_id[:8],
                     role.name)
        except Exception:
            log.exception("setting observed role failed")
