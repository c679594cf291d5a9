"""Worker: applies assignment sets and supervises per-task managers.

Reference: agent/{worker.go,task.go} plus the dependency stores in
agent/dependency.go.

The worker holds the node's view of its assigned tasks (plus the secrets/
configs they reference) and runs one TaskManager per task.  A TaskManager
drives the Controller FSM via exec.do_task in its own thread and reports
every status change through the agent's reporter.  Assigned tasks persist
in the agent task DB (storage.py) so supervision survives daemon restarts,
like the reference's bbolt store (agent/storage.go).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..models.objects import Config, Secret, Task
from ..models.types import TaskState, TaskStatus, now
from . import exec as exec_mod

log = logging.getLogger("agent.worker")

Reporter = Callable[[str, TaskStatus], None]


class TaskManager:
    """Supervises one task: drives the controller FSM and pushes status
    (reference: agent/task.go:16)."""

    RETRY_BACKOFF = 0.1

    def __init__(self, task: Task, ctlr: exec_mod.Controller,
                 reporter: Reporter, on_exit=None):
        self.task = task.copy()
        self.ctlr = ctlr
        self.reporter = reporter
        self.on_exit = on_exit   # fires after ctlr.close() completes
        self._update_cond = threading.Condition()
        self._pending_update: Optional[Task] = None
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"taskmanager-{task.id[:8]}", daemon=True)
        self._thread.start()

    def update(self, t: Task) -> None:
        with self._update_cond:
            desired_changed = t.desired_state != self.task.desired_state
            self._pending_update = t.copy()
            self._update_cond.notify()
        if desired_changed:
            # pop the manager thread out of a blocking controller call so
            # it can act on the new desired state (e.g. shut down a task
            # that is blocked in wait())
            try:
                self.ctlr.interrupt()
            except Exception:
                log.exception("controller interrupt failed")

    def close(self) -> None:
        self._closed.set()
        with self._update_cond:
            self._update_cond.notify()
        try:
            self.ctlr.interrupt()
        except Exception:
            pass

    def join(self, timeout=5) -> None:
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._closed.is_set():
            with self._update_cond:
                if self._pending_update is not None:
                    update = self._pending_update
                    self._pending_update = None
                    self.task.desired_state = update.desired_state
                    self.task.spec = update.spec
                    try:
                        self.ctlr.update(self.task)
                    except Exception:
                        log.exception("controller update failed")

            status, flag = exec_mod.do_task(self.task, self.ctlr)
            changed = (status.state != self.task.status.state
                       or status.message != self.task.status.message
                       or status.err != self.task.status.err)
            self.task.status = status
            if changed:
                try:
                    self.reporter(self.task.id, status.copy())
                except Exception:
                    log.exception("status report failed")

            if flag is exec_mod.ErrTaskNoop:
                # nothing to do until the task definition changes
                with self._update_cond:
                    if self._pending_update is None \
                            and not self._closed.is_set():
                        self._update_cond.wait(timeout=0.5)
            elif flag is exec_mod.ErrTaskRetry:
                self._closed.wait(timeout=self.RETRY_BACKOFF)
        try:
            self.ctlr.close()
        except Exception:
            pass
        if self.on_exit is not None:
            try:
                self.on_exit(self.task.id)
            except Exception:
                log.exception("task-manager exit hook failed")


class Worker:
    """reference: agent/worker.go:30."""

    def __init__(self, executor: exec_mod.Executor, reporter: Reporter,
                 db=None, volumes=None):
        self.executor = executor
        self.reporter = reporter
        self.db = db   # agent/storage.py TaskDB (optional persistence)
        # node-side CSI manager (agent/csivol.py); volumes ship as
        # assignment dependencies like secrets/configs
        self.volumes = volumes
        if volumes is not None:
            # executors read published volume paths from here (the
            # reference hands controllers a restricted volume getter)
            executor.volumes = volumes
        # executors resolve secret/config dependencies through the worker
        # (reference: agent/dependency.go dependencyManager handed to
        # controllers as a restricted getter)
        if hasattr(executor, "dependencies"):
            executor.dependencies = self
        self._mu = threading.Lock()
        self.task_managers: Dict[str, TaskManager] = {}
        self.secrets: Dict[str, Secret] = {}
        self.configs: Dict[str, Config] = {}
        # volume removals wait until no live/closing task references the
        # volume: unstaging under a running process would rip its data
        # directory away mid-write
        self._pending_volume_removals: set = set()
        self._closing_tasks: Dict[str, Task] = {}
        self._closed = False

    # ------------------------------------------------- dependency getters

    def secret_for(self, task_id: str, secret_id: str):
        """Resolve a task's secret: task-specific id first (driver-backed
        DoNotReuse values ship as '<secret_id>.<task_id>'), then the
        shared id (reference: agent/secrets.go taskRestrictedSecrets +
        identity.CombineTwoIDs naming)."""
        return (self.secrets.get(f"{secret_id}.{task_id}")
                or self.secrets.get(secret_id))

    def config_for(self, task_id: str, config_id: str):
        return self.configs.get(config_id)

    def init_from_db(self) -> None:
        """Resume supervision of persisted assigned tasks before the
        dispatcher reconnects (reference: worker.go:82 Init)."""
        if self.db is None:
            return
        with self._mu:
            for t in self.db.assigned_tasks():
                if t.id not in self.task_managers:
                    self._start_task(t)

    # ------------------------------------------------------------- applying

    def assign(self, changes: List[tuple]) -> None:
        """Apply a COMPLETE assignment set (reference: worker.go:129)."""
        with self._mu:
            if self._closed:
                return
            self._reconcile_deps(changes, full=True)
            self._reconcile_tasks(changes, full=True)
            self._process_volume_removals_locked()

    def update(self, changes: List[tuple]) -> None:
        """Apply an INCREMENTAL assignment set
        (reference: worker.go:168)."""
        with self._mu:
            if self._closed:
                return
            self._reconcile_deps(changes, full=False)
            self._reconcile_tasks(changes, full=False)
            self._process_volume_removals_locked()

    def _process_volume_removals_locked(self) -> None:
        if self.volumes is None or not self._pending_volume_removals:
            return
        referenced = set()
        for holder in (self.task_managers, self._closing_tasks):
            for mgr_or_task in holder.values():
                t = getattr(mgr_or_task, "task", mgr_or_task)
                for va in t.volumes:
                    referenced.add(va.id)
        for vid in list(self._pending_volume_removals):
            if vid in referenced:
                continue
            self._pending_volume_removals.discard(vid)
            self.volumes.remove(vid)

    def _on_manager_exit(self, task_id: str) -> None:
        """Runs on the task manager's thread once its controller has
        fully closed (the process is gone): deferred volume removals for
        volumes this task referenced can proceed now."""
        with self._mu:
            self._closing_tasks.pop(task_id, None)
            self._process_volume_removals_locked()

    def _reconcile_deps(self, changes: List[tuple], full: bool) -> None:
        seen_secrets, seen_configs, seen_volumes = set(), set(), set()
        for action, kind, obj in changes:
            if kind == "secret":
                if action == "update":
                    self.secrets[obj.id] = obj
                    seen_secrets.add(obj.id)
                else:
                    self.secrets.pop(obj.id, None)
            elif kind == "config":
                if action == "update":
                    self.configs[obj.id] = obj
                    seen_configs.add(obj.id)
                else:
                    self.configs.pop(obj.id, None)
            elif kind == "volume" and self.volumes is not None:
                # adds stage+publish before tasks in the same message
                # start (deps precede task changes); removals defer until
                # no referencing task is live (_process_volume_removals)
                if action == "update":
                    self.volumes.add(obj)
                    seen_volumes.add(obj.id)
                else:
                    self._pending_volume_removals.add(obj.id)
        if full:
            for sid in list(self.secrets):
                if sid not in seen_secrets:
                    del self.secrets[sid]
            for cid in list(self.configs):
                if cid not in seen_configs:
                    del self.configs[cid]
            if self.volumes is not None:
                for vid in list(self.volumes._paths):
                    if vid not in seen_volumes:
                        self._pending_volume_removals.add(vid)

    def _reconcile_tasks(self, changes: List[tuple], full: bool) -> None:
        updated: List[Task] = []
        removed: List[Task] = []
        for action, kind, obj in changes:
            if kind != "task":
                continue
            (updated if action == "update" else removed).append(obj)

        assigned = set()
        db_batch = self.db.batch() if self.db is not None \
            else contextlib.nullcontext()
        with db_batch:
            for t in updated:
                assigned.add(t.id)
                if self.db is not None:
                    # fold our last reported status back in so a restarted
                    # agent does not re-run earlier lifecycle steps; DB
                    # errors must never block task execution
                    try:
                        st = self.db.get_status(t.id)
                        if st is not None and st.state > t.status.state:
                            t = t.copy()
                            t.status = st
                        self.db.put_task(t)
                    except Exception:
                        log.exception("task DB write failed")
                mgr = self.task_managers.get(t.id)
                if mgr is not None:
                    mgr.update(t)
                else:
                    self._start_task(t)

            if full:
                for task_id in list(self.task_managers):
                    if task_id not in assigned:
                        self._close_manager(task_id)
                if self.db is not None:
                    # also sweep persisted tasks that never got a manager
                    # (e.g. controller resolution failed): a COMPLETE set
                    # is the full truth
                    try:
                        for t in self.db.assigned_tasks():
                            if t.id not in assigned:
                                self.db.remove(t.id)
                    except Exception:
                        log.exception("task DB sweep failed")
            for t in removed:
                self._close_manager(t.id)

    def _start_task(self, t: Task) -> None:
        try:
            ctlr = self.executor.controller(t)
        except Exception:
            log.exception("controller resolution failed")
            self.reporter(t.id, TaskStatus(
                state=TaskState.REJECTED, timestamp=now(),
                err="controller resolution failed"))
            return
        self.task_managers[t.id] = TaskManager(
            t, ctlr, self.reporter, on_exit=self._on_manager_exit)

    def _close_manager(self, task_id: str) -> None:
        mgr = self.task_managers.pop(task_id, None)
        if mgr is not None:
            # keep the task visible to volume-removal gating until the
            # controller has fully closed (on_exit fires)
            self._closing_tasks[task_id] = mgr.task
            mgr.close()
        if self.db is not None:
            self.db.remove(task_id)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            managers = list(self.task_managers.values())
            self.task_managers.clear()
        for mgr in managers:
            mgr.close()
