"""Agent: the node-side runtime connecting a worker to the dispatcher.

Reference: agent/{agent.go,session.go,reporter.go}.

One session loop: register → heartbeat keepalive → assignments stream →
worker; status changes flow back through a batching reporter.  On any
session failure the agent backs off exponentially and re-registers — the
dispatcher sends a fresh COMPLETE set on reconnect (session.go:120,
agent.go:179).

The ``client`` is anything with the dispatcher's surface (register /
heartbeat / open_assignments / update_task_status); in-process that is the
Dispatcher object itself, over the network a gRPC client wrapper.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict, List, Optional, Tuple

from ..models.types import TaskStatus
from ..remotes import backoff_with_jitter
from ..state.watch import Closed
from .exec import Executor
from .worker import Worker

log = logging.getLogger("agent")


class Agent:
    def __init__(self, node_id: str, executor: Executor, client,
                 description=None, task_db_path=None,
                 rng: Optional[random.Random] = None):
        self.node_id = node_id
        self.executor = executor
        self.client = client
        self.description = description
        # reconnect-jitter rng: injectable so the simulator's reconnect
        # storms stay deterministic per seed (see remotes.backoff_with_jitter)
        self._rng = rng or random.Random()
        db = None
        if task_db_path:
            from .storage import TaskDB
            db = TaskDB(task_db_path)
        # node-side CSI: volumes arrive as assignment dependencies; they
        # stage/publish under a local dir and unpublish reports flow back
        # through the dispatcher (reference: agent/csi/volumes.go)
        import os as _os
        import tempfile as _tempfile
        vol_dir = (_os.path.join(_os.path.dirname(task_db_path), "csi")
                   if task_db_path else
                   _tempfile.mkdtemp(prefix="swarm-csi-"))
        from .csivol import NodeVolumesManager
        self.volumes = NodeVolumesManager(
            vol_dir, on_unpublished=self._report_volume_unpublished)
        self._unpublished_mu = threading.Lock()
        self._unpublished: list = []
        self.worker = Worker(executor, self._report, db=db,
                             volumes=self.volumes)
        self.session_id: Optional[str] = None
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # status reporter batching (reference: reporter.go)
        self._statuses_mu = threading.Lock()
        self._statuses: Dict[str, TaskStatus] = {}
        self._statuses_cond = threading.Condition(self._statuses_mu)
        self._reporter_thread: Optional[threading.Thread] = None
        self._log_thread: Optional[threading.Thread] = None
        self._log_offsets: Dict[str, int] = {}
        self.log_ship_interval = 0.5
        self.stats = {"sessions": 0, "reports": 0, "log_batches": 0}
        self._applied_key_clock = 0

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name="agent",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._statuses_cond:
            self._statuses_cond.notify_all()
        self.worker.close()
        self._done.wait(timeout=10)

    def _log_shipper(self) -> None:
        """Ship new task-log bytes to the manager's log broker
        (reference: agent/reporter + log publisher; executors that expose
        per-task ``read_logs`` — e.g. the process executor — feed it).
        Offsets are tracked per task so only deltas travel."""
        while not self._stop.wait(self.log_ship_interval):
            try:
                self._ship_logs_once()
            except Exception:
                # nothing here may kill the shipper thread: a transient
                # error just means this interval's batch waits
                log.exception("log shipping pass failed")

    def _ship_logs_once(self) -> None:
        publish = getattr(self.client, "publish_logs", None)
        controllers = getattr(self.executor, "controllers", None)
        if publish is None or not controllers:
            return
        snapshot = dict(controllers)   # racing the worker thread is fine;
        # a task missed this pass ships next interval
        batch = []
        for task_id, ctlr in snapshot.items():
            read = getattr(ctlr, "read_logs", None)
            if read is None:
                continue
            data = read()
            start = self._log_offsets.get(task_id, 0)
            if len(data) > start:
                batch.append({"task_id": task_id,
                              "node_id": self.node_id,
                              "stream": "stdout",
                              "data": data[start:]})
                self._log_offsets[task_id] = len(data)
        # prune offsets for tasks the executor no longer tracks, or a
        # long-lived agent grows one entry per historical task forever
        for task_id in list(self._log_offsets):
            if task_id not in snapshot:
                del self._log_offsets[task_id]
        if not batch:
            return
        try:
            publish(self.node_id, self.session_id or "", batch)
            self.stats["log_batches"] += 1
        except Exception:
            # transient transport trouble: offsets were advanced, so
            # roll them back for a retry next interval (at-least-once)
            for m in batch:
                self._log_offsets[m["task_id"]] -= len(m["data"])

    def run(self) -> None:
        attempt = 0
        try:
            self._log_thread = threading.Thread(
                target=self._log_shipper, name="agent-logs", daemon=True)
            self._log_thread.start()
            self._reporter_thread = threading.Thread(
                target=self._reporter_loop, name="agent-reporter",
                daemon=True)
            self._reporter_thread.start()
            # resume persisted tasks only once the reporter machinery is
            # fully constructed and running
            try:
                self.worker.init_from_db()
            except Exception:
                log.exception("resuming persisted tasks failed")
            while not self._stop.is_set():
                try:
                    self._session()
                    attempt = 0
                except Exception as e:
                    if self._stop.is_set():
                        return
                    # session failover: count the cause and make sure the
                    # re-register targets a DIFFERENT manager — an
                    # invalidated session or a closed assignment stream
                    # usually means THIS manager is mid-teardown, and
                    # hammering it just races the teardown
                    from ..remotes import SESSION_ERROR_CODES, \
                        count_reconnect
                    reason = (
                        "session_invalid"
                        if getattr(e, "code", "") in SESSION_ERROR_CODES
                        else "stream_closed"
                        if isinstance(e, ConnectionError)
                        else "transport"
                        if isinstance(e, (OSError, TimeoutError))
                        else "error")
                    count_reconnect(reason)
                    rotate = getattr(self.client,
                                     "note_session_failure", None)
                    if rotate is not None:
                        rotate()
                    # jittered exponential backoff: the ceiling doubles
                    # per consecutive failure (capped), the actual sleep
                    # is drawn uniformly below it so a manager failover
                    # does not produce a synchronized re-register storm
                    delay = backoff_with_jitter(attempt, self._rng)
                    log.info("agent session failed (%s); backing off "
                             "%.2fs (attempt %d)", e, delay, attempt + 1)
                    self._stop.wait(timeout=delay)
                    attempt += 1
        finally:
            self._done.set()

    # --------------------------------------------------------------- session

    def _session(self) -> None:
        description = self.description
        if description is None:
            try:
                description = self.executor.describe()
            except Exception:
                description = None
        session_id, period = self.client.register(
            self.node_id, description=description)
        self.session_id = session_id
        self.stats["sessions"] += 1
        log.info("agent session established (%s)", session_id[:8])

        failed = threading.Event()

        def heartbeat_loop():
            p = period
            while not self._stop.is_set() and not failed.is_set():
                if self._stop.wait(timeout=p):
                    return
                try:
                    p = self.client.heartbeat(self.node_id, session_id)
                except Exception:
                    failed.set()
                    return
                self._apply_network_keys()

        hb = threading.Thread(target=heartbeat_loop, name="agent-heartbeat",
                              daemon=True)
        hb.start()

        stream = self.client.open_assignments(self.node_id, session_id)
        try:
            while not self._stop.is_set() and not failed.is_set():
                self._flush_volume_reports(session_id)
                self.volumes.retry_pending()
                try:
                    msg = stream.get(timeout=0.2)
                except TimeoutError:
                    continue
                except Closed:
                    raise stream.error or ConnectionError("stream closed")
                if msg.type == "complete":
                    self.worker.assign(msg.changes)
                else:
                    self.worker.update(msg.changes)
                self._flush_volume_reports(session_id)
            if failed.is_set():
                raise ConnectionError("heartbeat failed")
        finally:
            stream.close()
            failed.set()
            hb.join(timeout=2)

    def _apply_network_keys(self) -> None:
        """Hand rotated dataplane keys to the executor (reference:
        agent.go handleSessionMessage -> SetNetworkBootstrapKeys).  The
        wire client stashes the heartbeat piggyback; the lamport clock
        gates re-delivery so the executor sees each rotation once."""
        delivery = getattr(self.client, "network_key_delivery", None)
        if delivery is not None:
            clock, raw = delivery          # atomic pair (failover client)
        else:
            clock = getattr(self.client, "last_key_clock", None)
            raw = getattr(self.client, "last_network_keys", None)
        if clock is None or raw is None or clock == self._applied_key_clock:
            return
        from ..models.types import EncryptionKey
        from ..state import serde
        try:
            keys = [k if isinstance(k, EncryptionKey)
                    else serde.from_dict(EncryptionKey, k) for k in raw]
            self.executor.set_network_bootstrap_keys(keys)
            self._applied_key_clock = clock
        except Exception:
            log.exception("applying network bootstrap keys failed")

    # -------------------------------------------------------------- reporter

    def _report_volume_unpublished(self, volume_id: str) -> None:
        with self._unpublished_mu:
            self._unpublished.append(volume_id)

    def _flush_volume_reports(self, session_id: str) -> None:
        with self._unpublished_mu:
            pending, self._unpublished = self._unpublished, []
        if not pending:
            return
        update = getattr(self.client, "update_volume_status", None)
        if update is None:
            return
        try:
            update(self.node_id, session_id,
                   [(vid, True) for vid in pending])
        except Exception:
            # report again on the next heartbeat; unpublish is idempotent
            with self._unpublished_mu:
                self._unpublished = pending + self._unpublished

    def _report(self, task_id: str, status: TaskStatus) -> None:
        if self.worker.db is not None:
            try:
                self.worker.db.put_status(task_id, status)
            except Exception:
                log.exception("persisting task status failed")
        with self._statuses_cond:
            self._statuses[task_id] = status
            self._statuses_cond.notify()

    def _reporter_loop(self) -> None:
        while not self._stop.is_set():
            with self._statuses_cond:
                if not self._statuses:
                    self._statuses_cond.wait(timeout=0.2)
                batch, self._statuses = self._statuses, {}
            if not batch:
                continue
            session_id = self.session_id
            if session_id is None:
                self._requeue(batch)
                continue
            try:
                self.client.update_task_status(
                    self.node_id, session_id, list(batch.items()))
                self.stats["reports"] += len(batch)
            except Exception:
                # retry on next session; newer statuses win
                self._requeue(batch)
                self._stop.wait(timeout=0.2)

    def _requeue(self, batch: Dict[str, TaskStatus]) -> None:
        with self._statuses_cond:
            for task_id, status in batch.items():
                cur = self._statuses.get(task_id)
                if cur is None or cur.state < status.state:
                    self._statuses[task_id] = status
