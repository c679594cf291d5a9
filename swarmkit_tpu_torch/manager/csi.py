"""CSI manager: cluster-side volume lifecycle against storage plugins.

Reference: manager/csi/{manager.go,plugin.go,convert.go}.

Watches volume objects and drives them through the controller-side CSI
lifecycle with retry/backoff (utils/volumequeue):

* created volume, no ``volume_info``    → plugin.create_volume
* publish_status PENDING_PUBLISH        → plugin.controller_publish
* publish_status PENDING_UNPUBLISH      → plugin.controller_unpublish
* pending_delete with no publishes      → plugin.delete_volume + remove

The plugin interface mirrors the CSI controller RPCs; tests use the
in-memory fake (reference: manager/csi/fakes_test.go).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from ..models.objects import Volume, VolumeInfo
from ..models.types import VolumePublishStatus
from ..state.events import Event
from ..state.store import MemoryStore
from ..state.watch import Closed
from ..utils import new_id
from ..utils.volumequeue import VolumeQueue

log = logging.getLogger("csi")


class CSIPlugin:
    """Controller-side plugin surface (reference: plugin.go / CSI spec)."""

    def create_volume(self, volume: Volume) -> VolumeInfo:
        raise NotImplementedError

    def delete_volume(self, volume: Volume) -> None:
        raise NotImplementedError

    def controller_publish(self, volume: Volume,
                           node_id: str) -> Dict[str, str]:
        """Returns the publish context."""
        raise NotImplementedError

    def controller_unpublish(self, volume: Volume, node_id: str) -> None:
        raise NotImplementedError


class InMemoryCSIPlugin(CSIPlugin):
    """Test/dev plugin (reference: fakes_test.go)."""

    def __init__(self, name: str = "inmem"):
        self.name = name
        self.volumes: Dict[str, dict] = {}
        self.published: Dict[str, set] = {}
        self.fail_next: Optional[str] = None

    def _maybe_fail(self, op: str) -> None:
        if self.fail_next == op:
            self.fail_next = None
            raise RuntimeError(f"induced {op} failure")

    def create_volume(self, volume: Volume) -> VolumeInfo:
        self._maybe_fail("create")
        vid = f"csi-{new_id()[:8]}"
        self.volumes[vid] = {"name": volume.spec.annotations.name}
        self.published[vid] = set()
        return VolumeInfo(volume_id=vid, capacity_bytes=volume.spec.capacity_min)

    def delete_volume(self, volume: Volume) -> None:
        self._maybe_fail("delete")
        vid = volume.volume_info.volume_id if volume.volume_info else ""
        self.volumes.pop(vid, None)
        self.published.pop(vid, None)

    def controller_publish(self, volume: Volume,
                           node_id: str) -> Dict[str, str]:
        self._maybe_fail("publish")
        vid = volume.volume_info.volume_id
        self.published.setdefault(vid, set()).add(node_id)
        return {"device": f"/dev/{vid}"}

    def controller_unpublish(self, volume: Volume, node_id: str) -> None:
        self._maybe_fail("unpublish")
        vid = volume.volume_info.volume_id
        self.published.get(vid, set()).discard(node_id)


class Manager:
    """reference: manager/csi/manager.go:31."""

    def __init__(self, store: MemoryStore,
                 plugins: Optional[Dict[str, CSIPlugin]] = None):
        self.store = store
        self.plugins = plugins or {}
        self.queue = VolumeQueue()
        self._stop = threading.Event()
        self._threads = []

    def register_plugin(self, name: str, plugin: CSIPlugin) -> None:
        self.plugins[name] = plugin

    def start(self) -> None:
        for target, name in ((self._watch_loop, "csi-watch"),
                             (self._work_loop, "csi-work")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        for t in self._threads:
            t.join(timeout=5)

    # ----------------------------------------------------------------- loops

    def _watch_loop(self) -> None:
        def pred(ev):
            return isinstance(ev, Event) and isinstance(ev.obj, Volume)

        def init(tx):
            for v in tx.find(Volume):
                self.queue.enqueue(v.id)

        _, sub = self.store.view_and_watch(init, predicate=pred,
                                           accepts_blocks=True)
        try:
            while not self._stop.is_set():
                try:
                    ev = sub.get(timeout=0.2)
                except TimeoutError:
                    continue
                except Closed:
                    return
                if ev.action != "delete":
                    self.queue.enqueue(ev.obj.id)
        finally:
            self.store.queue.unsubscribe(sub)

    def _work_loop(self) -> None:
        while not self._stop.is_set():
            volume_id = self.queue.wait(timeout=0.5)
            if volume_id is None:
                continue
            try:
                done = self._process(volume_id)
                if done:
                    self.queue.forget(volume_id)
                else:
                    # more pending steps, no failure: immediate pass
                    self.queue.enqueue(volume_id)
            except Exception:
                log.exception("processing volume %s failed", volume_id)
                self.queue.enqueue(volume_id, retry=True)

    # ------------------------------------------------------------ processing

    def _plugin_for(self, volume: Volume) -> Optional[CSIPlugin]:
        name = volume.spec.driver.name if volume.spec.driver else ""
        return self.plugins.get(name)

    def _process(self, volume_id: str) -> bool:
        """One reconciliation step; returns True when nothing is pending."""
        volume = self.store.raw_get(Volume, volume_id)
        if volume is None:
            return True
        plugin = self._plugin_for(volume)
        if plugin is None:
            log.warning("no CSI plugin %r for volume %s",
                        volume.spec.driver.name if volume.spec.driver
                        else "", volume_id)
            return True  # nothing we can do; don't spin

        # 1. deletion of a never-created volume needs no backend call
        if volume.pending_delete and (volume.volume_info is None
                                      or not volume.volume_info.volume_id):
            def drop(tx):
                if tx.get(Volume, volume_id) is not None:
                    tx.delete(Volume, volume_id)

            self.store.update(drop)
            return True

        # 2. creation
        if volume.volume_info is None or not volume.volume_info.volume_id:
            info = plugin.create_volume(volume)

            def set_info(tx):
                cur = tx.get(Volume, volume_id)
                if cur is None or cur.volume_info:
                    return
                cur = cur.copy()
                cur.volume_info = info
                tx.update(cur)

            self.store.update(set_info)
            return False  # re-check for publishes next pass

        # 3. deletion
        if volume.pending_delete and not volume.publish_status:
            plugin.delete_volume(volume)

            def delete(tx):
                if tx.get(Volume, volume_id) is not None:
                    tx.delete(Volume, volume_id)

            self.store.update(delete)
            return True

        # 4. publish / unpublish transitions
        changed = False
        for status in volume.publish_status:
            if status.state == VolumePublishStatus.State.PENDING_PUBLISH:
                context = plugin.controller_publish(volume, status.node_id)

                def publish(tx, node_id=status.node_id, context=context):
                    cur = tx.get(Volume, volume_id)
                    if cur is None:
                        return
                    cur = cur.copy()
                    for ps in cur.publish_status:
                        if ps.node_id == node_id and ps.state == \
                                VolumePublishStatus.State.PENDING_PUBLISH:
                            ps.state = VolumePublishStatus.State.PUBLISHED
                            ps.publish_context = dict(context)
                    tx.update(cur)

                self.store.update(publish)
                changed = True
            elif status.state == \
                    VolumePublishStatus.State.PENDING_UNPUBLISH:
                plugin.controller_unpublish(volume, status.node_id)

                def unpublish(tx, node_id=status.node_id):
                    cur = tx.get(Volume, volume_id)
                    if cur is None:
                        return
                    cur = cur.copy()
                    cur.publish_status = [
                        ps for ps in cur.publish_status
                        if not (ps.node_id == node_id and ps.state ==
                                VolumePublishStatus.State
                                .PENDING_UNPUBLISH)]
                    tx.update(cur)

                self.store.update(unpublish)
                changed = True
        if changed:
            return False  # re-check (e.g. deletion may now be unblocked)
        return True
