"""Object-count metrics collector.

Reference: manager/metrics/collector.go:41-80 — gauges for nodes (by
state), tasks (by state), services, networks, secrets, configs, updated
from store events.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Optional

from ..models.objects import (
    Config, Network, Node, Secret, Service, Task,
)
from ..state.events import Event, EventSnapshotRestore, EventTaskBlock
from ..state.store import MemoryStore
from ..state.watch import Closed
from ..utils.metrics import registry


class Collector:
    KINDS = (Node, Service, Task, Network, Secret, Config)

    def __init__(self, store: MemoryStore):
        self.store = store
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._counts: Dict[str, int] = defaultdict(int)
        self._task_states: Dict[int, int] = defaultdict(int)
        self._node_states: Dict[int, int] = defaultdict(int)
        # every state label ever exported: a state whose count drops to
        # zero (or vanishes across an EventSnapshotRestore recount) must
        # keep exporting 0, not linger at its stale pre-restore value
        self._exported_task_states: set = set()
        self._exported_node_states: set = set()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="metrics",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait(timeout=5)

    def run(self) -> None:
        try:
            def init(tx):
                for kind in self.KINDS:
                    objs = tx.find(kind)
                    self._counts[kind.collection] = len(objs)
                    if kind is Task:
                        for t in objs:
                            self._task_states[int(t.status.state)] += 1
                    elif kind is Node:
                        for n in objs:
                            self._node_states[int(n.status.state)] += 1

            _, sub = self.store.view_and_watch(init, accepts_blocks=True)
            self._export()
            try:
                while not self._stop.is_set():
                    try:
                        ev = sub.get(timeout=0.2)
                    except TimeoutError:
                        continue
                    except Closed:
                        return
                    if isinstance(ev, EventSnapshotRestore):
                        self._recount()
                    elif isinstance(ev, EventTaskBlock):
                        # n state transitions in one event: shift the
                        # histogram from the pre-assignment states (the
                        # olds arrays, no materialization needed)
                        for old in ev.olds:
                            self._task_states[int(old.status.state)] -= 1
                        self._task_states[int(ev.state)] += len(ev)
                        self._export()
                    elif isinstance(ev, Event):
                        self._handle(ev)
            finally:
                self.store.queue.unsubscribe(sub)
        finally:
            self._done.set()

    def _recount(self) -> None:
        self._counts.clear()
        self._task_states.clear()
        self._node_states.clear()

        def init(tx):
            for kind in self.KINDS:
                objs = tx.find(kind)
                self._counts[kind.collection] = len(objs)
                if kind is Task:
                    for t in objs:
                        self._task_states[int(t.status.state)] += 1
                elif kind is Node:
                    for n in objs:
                        self._node_states[int(n.status.state)] += 1

        self.store.view(init)
        self._export()

    def _handle(self, ev: Event) -> None:
        obj = ev.obj
        coll = getattr(obj, "collection", None)
        if coll is None:
            return
        if ev.action == "create":
            self._counts[coll] += 1
        elif ev.action == "delete":
            self._counts[coll] -= 1
        if isinstance(obj, Task):
            if ev.action == "delete":
                self._task_states[int(obj.status.state)] -= 1
            else:
                if ev.action == "update" and ev.old is not None:
                    self._task_states[int(ev.old.status.state)] -= 1
                self._task_states[int(obj.status.state)] += 1
        elif isinstance(obj, Node):
            if ev.action == "delete":
                self._node_states[int(obj.status.state)] -= 1
            else:
                if ev.action == "update" and ev.old is not None:
                    self._node_states[int(ev.old.status.state)] -= 1
                self._node_states[int(obj.status.state)] += 1
        self._export()

    def _export(self) -> None:
        from ..models.types import NodeState, TaskState
        for coll, n in self._counts.items():
            registry.gauge(f"swarm_manager_{coll}", n)
        # labeled exposition (reference: collector.go's
        # {state="running"}-style gauge vectors).  States seen earlier but
        # absent now export 0 so scrapes never read a stale count.
        self._exported_task_states.update(self._task_states)
        for state in self._exported_task_states:
            registry.gauge(
                f'swarm_manager_tasks{{state='
                f'"{TaskState(state).name.lower()}"}}',
                self._task_states.get(state, 0))
        self._exported_node_states.update(self._node_states)
        for state in self._exported_node_states:
            registry.gauge(
                f'swarm_manager_nodes{{state='
                f'"{NodeState(state).name.lower()}"}}',
                self._node_states.get(state, 0))
