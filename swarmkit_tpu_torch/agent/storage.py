"""Agent-side task database: assigned tasks persisted across restarts.

Reference: agent/storage.go (bbolt buckets for task data / status /
assigned flag).

One JSON file per node, written atomically; tasks-per-node counts are tens,
so full-file rewrites are cheap and keep the format trivially inspectable.
On agent restart the worker reloads assigned tasks and resumes supervising
them before the dispatcher connection is back (the reference's
worker.Init).
"""

from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..models.objects import Task
from ..models.types import TaskStatus
from ..state import serde


class TaskDB:
    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()
        self._tasks: Dict[str, dict] = {}      # id -> serialized task
        self._statuses: Dict[str, dict] = {}   # id -> serialized status
        self._assigned: Dict[str, bool] = {}
        self._defer = 0
        self._load()

    # ------------------------------------------------------------------ disk

    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                data = json.loads(f.read())
            self._tasks = data.get("tasks", {})
            self._statuses = data.get("statuses", {})
            self._assigned = data.get("assigned", {})
        except FileNotFoundError:
            pass
        except Exception:
            # a torn write loses local supervision state only; the
            # dispatcher's COMPLETE assignment set rebuilds it
            self._tasks = {}
            self._statuses = {}
            self._assigned = {}

    @contextmanager
    def batch(self):
        """Defer flushing while applying a whole assignment set: one
        file rewrite instead of one per task."""
        with self._mu:
            self._defer += 1
        try:
            yield self
        finally:
            with self._mu:
                self._defer -= 1
                if self._defer == 0:
                    self._flush_locked()

    def _flush_locked(self) -> None:
        if self._defer:
            return
        payload = json.dumps({
            "tasks": self._tasks,
            "statuses": self._statuses,
            "assigned": self._assigned,
        }, sort_keys=True).encode()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self.path)

    # ------------------------------------------------------------------- api

    def put_task(self, t: Task, assigned: bool = True) -> None:
        with self._mu:
            self._tasks[t.id] = serde.to_dict(t)
            self._assigned[t.id] = assigned
            self._flush_locked()

    def put_status(self, task_id: str, status: TaskStatus) -> None:
        with self._mu:
            if task_id not in self._tasks:
                return
            self._statuses[task_id] = serde.to_dict(status)
            self._flush_locked()

    def get_status(self, task_id: str) -> Optional[TaskStatus]:
        with self._mu:
            d = self._statuses.get(task_id)
        return serde.from_dict(TaskStatus, d) if d else None

    def remove(self, task_id: str) -> None:
        with self._mu:
            self._tasks.pop(task_id, None)
            self._statuses.pop(task_id, None)
            self._assigned.pop(task_id, None)
            self._flush_locked()

    def assigned_tasks(self) -> List[Task]:
        """Tasks to resume supervising, with their last reported status
        folded in."""
        with self._mu:
            items = [(tid, dict(d)) for tid, d in self._tasks.items()
                     if self._assigned.get(tid)]
            statuses = dict(self._statuses)
        out = []
        for tid, d in items:
            t = serde.from_dict(Task, d)
            st = statuses.get(tid)
            if st:
                t.status = serde.from_dict(TaskStatus, st)
            out.append(t)
        return out
