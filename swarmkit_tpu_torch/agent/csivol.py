"""Node-side CSI: stage/publish volumes on the worker before tasks run.

Reference: agent/csi/volumes.go (volumes manager: Add/Remove/Get with a
retry queue, publishVolume = NodeStage + NodePublish, unpublishVolume =
NodeUnpublish + NodeUnstage) and agent/csi/plugin.go (node plugin iface).

Volumes arrive as assignment dependencies from the dispatcher (alongside
secrets/configs); the worker adds them here before starting tasks that
mount them, and removes them when the dependency is released.  Removal
completion is reported back through the dispatcher's
``update_volume_status`` so the control plane can advance the volume from
PENDING_NODE_UNPUBLISH to PENDING_UNPUBLISH (dispatcher.go:682).
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Callable, Dict, Optional

log = logging.getLogger("agent.csivol")


class NodeCSIPlugin:
    """Node half of a CSI plugin (reference: agent/csi/plugin.go
    NodePlugin: NodeStageVolume/NodePublishVolume and inverses)."""

    def node_stage(self, volume) -> None:
        raise NotImplementedError

    def node_publish(self, volume) -> str:
        """Make the volume available; returns the node-local path."""
        raise NotImplementedError

    def node_unpublish(self, volume) -> None:
        raise NotImplementedError

    def node_unstage(self, volume) -> None:
        raise NotImplementedError


class FSNodePlugin(NodeCSIPlugin):
    """Filesystem-backed node plugin: volumes are directories under a
    staging root — the real-runtime analogue for the process executor
    (no block devices or kernel mounts in this environment)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def _staging(self, volume) -> str:
        return os.path.join(self.base_dir, "staging", volume.id)

    def _publish_path(self, volume) -> str:
        return os.path.join(self.base_dir, "published", volume.id)

    def node_stage(self, volume) -> None:
        os.makedirs(self._staging(volume), exist_ok=True)

    def node_publish(self, volume) -> str:
        path = self._publish_path(volume)
        os.makedirs(path, exist_ok=True)
        return path

    def node_unpublish(self, volume) -> None:
        shutil.rmtree(self._publish_path(volume), ignore_errors=True)

    def node_unstage(self, volume) -> None:
        shutil.rmtree(self._staging(volume), ignore_errors=True)


class NodeVolumesManager:
    """Worker-side volume state (reference: agent/csi/volumes.go:48).

    ``add`` stages+publishes; ``remove`` unpublishes+unstages and calls
    ``on_unpublished(volume_id)`` so the agent can report completion.
    Plugins are looked up by the volume spec's driver name; a filesystem
    plugin handles drivers with no registered node plugin, so in-memory
    control-plane drivers ("inmem") still get a real local path."""

    def __init__(self, base_dir: str,
                 plugins: Optional[Dict[str, NodeCSIPlugin]] = None,
                 on_unpublished: Optional[Callable[[str], None]] = None):
        self._mu = threading.Lock()
        self._default = FSNodePlugin(base_dir)
        self.plugins: Dict[str, NodeCSIPlugin] = dict(plugins or {})
        self.on_unpublished = on_unpublished
        self._paths: Dict[str, str] = {}     # volume_id -> published path
        self._volumes: Dict[str, object] = {}
        self._pending: Dict[str, object] = {}   # failed adds, retried

    def _plugin_for(self, volume) -> NodeCSIPlugin:
        name = volume.spec.driver.name if volume.spec.driver else ""
        return self.plugins.get(name, self._default)

    # ------------------------------------------------------------- lifecycle

    def add(self, volume) -> None:
        """Stage + node-publish (idempotent).  Failures park the volume
        in a pending set retried by ``retry_pending`` — the reference
        drives the same loop through its volumequeue
        (agent/csi/volumes.go:60 retryVolumes)."""
        with self._mu:
            plugin = self._plugin_for(volume)
            try:
                plugin.node_stage(volume)
                path = plugin.node_publish(volume)
            except Exception:
                log.exception("node publish of volume %s failed; will "
                              "retry", volume.id)
                self._pending[volume.id] = volume
                return
            self._pending.pop(volume.id, None)
            self._paths[volume.id] = path
            self._volumes[volume.id] = volume

    def retry_pending(self) -> None:
        """Re-attempt failed stage/publish calls (driven from the agent's
        session loop)."""
        with self._mu:
            pending = list(self._pending.values())
        for volume in pending:
            self.add(volume)

    def remove(self, volume_id: str) -> None:
        """Node-unpublish + unstage, then report completion."""
        with self._mu:
            self._pending.pop(volume_id, None)
            volume = self._volumes.pop(volume_id, None)
            self._paths.pop(volume_id, None)
            if volume is not None:
                plugin = self._plugin_for(volume)
                try:
                    plugin.node_unpublish(volume)
                    plugin.node_unstage(volume)
                except Exception:
                    log.exception("node unpublish of volume %s failed",
                                  volume_id)
        cb = self.on_unpublished
        if cb is not None:
            try:
                cb(volume_id)
            except Exception:
                log.exception("unpublish report for %s failed", volume_id)

    # ----------------------------------------------------------------- reads

    def get(self, volume_id: str) -> Optional[str]:
        """Node-local path of a published volume (reference:
        volumes.go:128 Get), or None when not (yet) published."""
        with self._mu:
            return self._paths.get(volume_id)

    def ready(self, volume_id: str) -> bool:
        with self._mu:
            return volume_id in self._paths
