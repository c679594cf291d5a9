"""Deallocator: graceful teardown of user-facing objects.

Reference: manager/deallocator/deallocator.go:33 — waits for services
marked ``pending_delete`` to fully shut down (no tasks left), then
deletes the service record and deallocates service-level resources
(networks also marked ``pending_delete`` that no other service still
references).  Like the reference, this is the one place pending-delete
services/networks are ever actually removed.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

from ..models.objects import Network, Service, Task
from ..state.events import Event
from ..state.store import ByService, MemoryStore
from ..state.watch import Closed

log = logging.getLogger("deallocator")


class Deallocator:
    def __init__(self, store: MemoryStore):
        self.store = store
        # services shutting down -> remaining task count
        self._services: Dict[str, int] = {}
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name="deallocator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=5)

    def run(self) -> None:
        try:
            def pred(ev):
                return isinstance(ev, Event) and isinstance(
                    ev.obj, (Service, Network, Task))

            def init(tx):
                # task counts for pending-delete services come from the
                # SAME transaction that anchors the subscription, so
                # task-delete events queued behind the snapshot can't
                # double-count against a stale view
                services = tx.find(Service)
                counts = {s.id: len(tx.find(Task, ByService(s.id)))
                          for s in services if s.pending_delete}
                return services, tx.find(Network), counts

            (services, networks, counts), sub = self.store.view_and_watch(
                init, predicate=pred, accepts_blocks=True)
            try:
                for s in services:
                    if not s.pending_delete:
                        continue
                    if counts.get(s.id, 0) == 0:
                        self._deallocate_service(s)
                    else:
                        self._services[s.id] = counts[s.id]
                for n in networks:
                    self._process_network(n)
                while not self._stop.is_set():
                    try:
                        ev = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if ev is None:
                        continue
                    obj = ev.obj
                    if isinstance(obj, Service):
                        if ev.action == "delete":
                            self._services.pop(obj.id, None)
                        else:
                            self._process_service(obj)
                    elif isinstance(obj, Network) \
                            and ev.action != "delete":
                        self._process_network(obj)
                    elif isinstance(obj, Task) and ev.action == "delete":
                        self._on_task_delete(obj.service_id)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    # ------------------------------------------------------------- services

    def _process_service(self, service: Service) -> None:
        """reference: deallocator.go:162 processService."""
        if not service.pending_delete:
            return
        tasks = self.store.view(
            lambda tx: tx.find(Task, ByService(service.id)))
        if not tasks:
            self._services.pop(service.id, None)
            self._deallocate_service(service)
        else:
            self._services[service.id] = len(tasks)

    def _on_task_delete(self, sid: str) -> None:
        """A tracked service lost a task: RECOUNT from the store rather
        than decrementing (events may replay adds/removes the tracked
        number never saw)."""
        if sid not in self._services:
            return
        remaining = len(self.store.view(
            lambda tx: tx.find(Task, ByService(sid))))
        if remaining > 0:
            self._services[sid] = remaining
            return
        del self._services[sid]
        svc = self.store.view(lambda tx: tx.get(Service, sid))
        if svc is not None and svc.pending_delete:
            self._deallocate_service(svc)

    def _deallocate_service(self, service: Service) -> None:
        """Delete the drained service, then any of its pending-delete
        networks no other service still uses
        (reference: deallocator.go:191 deallocateService)."""
        nets = [nc.target for nc in (service.spec.task.networks
                                     or service.spec.networks or [])]

        def cb(tx):
            if tx.get(Service, service.id) is not None:
                tx.delete(Service, service.id)
            for nid in nets:
                network = tx.get(Network, nid)
                if network is not None:
                    self._maybe_delete_network(
                        tx, network, ignore_service=service.id)

        try:
            self.store.update(cb)
            log.info("deallocated service %s", service.id[:8])
        except Exception:
            log.exception("deallocating service %s failed", service.id)

    # ------------------------------------------------------------- networks

    def _process_network(self, network: Network) -> None:
        """reference: deallocator.go:230 processNetwork (event path)."""
        if not network.pending_delete:
            return

        def cb(tx):
            cur = tx.get(Network, network.id)
            if cur is not None:
                self._maybe_delete_network(tx, cur)

        try:
            self.store.update(cb)
        except Exception:
            log.exception("deallocating network %s failed", network.id)

    @staticmethod
    def _maybe_delete_network(tx, network: Network,
                              ignore_service: str = "") -> None:
        if not network.pending_delete:
            return
        for s in tx.find(Service):
            if s.id == ignore_service:
                continue
            refs = [nc.target for nc in (s.spec.task.networks
                                         or s.spec.networks or [])]
            if network.id in refs:
                return   # still in use
        tx.delete(Network, network.id)
        log.info("deallocated network %s", network.id[:8])
