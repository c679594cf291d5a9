"""Resource API: agent-initiated network attachments.

Reference: manager/resourceapi/allocator.go — AttachNetwork creates a
network-attachment pseudo-task bound to the calling node (used for
``docker run --net=<swarm overlay>``), DetachNetwork removes it.
"""

from __future__ import annotations

from typing import List, Optional

from ..models.objects import Network, Node, Task
from ..models.specs import NetworkAttachmentSpec, TaskSpec
from ..models.types import (
    NetworkAttachment, TaskState, TaskStatus, now,
)
from ..state.store import MemoryStore
from ..utils import new_id
from .controlapi import InvalidArgument, NotFound


class ResourceAPI:
    def __init__(self, store: MemoryStore):
        self.store = store

    def attach_network(self, node_id: str, network_id: str,
                       container_id: str = "",
                       addresses: Optional[List[str]] = None) -> str:
        """Create an attachment task for the node; returns the attachment
        (task) id (reference: allocator.go AttachNetwork)."""
        def cb(tx):
            if tx.get(Node, node_id) is None:
                raise NotFound(f"node {node_id} not found")
            network = tx.get(Network, network_id)
            if network is None:
                raise NotFound(f"network {network_id} not found")
            if not network.spec.attachable:
                raise InvalidArgument(
                    "network is not attachable")
            task = Task(
                id=new_id(),
                node_id=node_id,
                spec=TaskSpec(attachment=NetworkAttachmentSpec(
                    container_id=container_id)),
                status=TaskStatus(state=TaskState.NEW, timestamp=now(),
                                  message="created"),
                desired_state=TaskState.RUNNING,
                networks=[NetworkAttachment(
                    network_id=network_id,
                    addresses=list(addresses or []))])
            tx.create(task)
            return task.id

        return self.store.update(cb)

    def detach_network(self, node_id: str, attachment_id: str) -> None:
        """reference: allocator.go DetachNetwork."""
        def cb(tx):
            t = tx.get(Task, attachment_id)
            if t is None or t.spec.attachment is None:
                raise NotFound(
                    f"attachment {attachment_id} not found")
            if t.node_id != node_id:
                raise InvalidArgument(
                    "attachment belongs to a different node")
            tx.delete(Task, attachment_id)

        self.store.update(cb)
