"""Log broker: connects log subscribers (users) to log publishers (agents).

Reference: manager/logbroker/{broker.go,subscription.go}.

``subscribe_logs`` registers a selector (services/tasks/nodes) and returns
a stream; agents listening via ``listen_subscriptions`` are told which
tasks to start publishing for, and push messages through ``publish_logs``,
which the broker fans out to matching subscribers.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..models.objects import Task
from ..state.store import ByNode, ByService, MemoryStore
from ..state.watch import Closed, Queue, Subscription
from ..utils import new_id

log = logging.getLogger("logbroker")


@dataclass
class LogSelector:
    """reference: api/logbroker.proto LogSelector."""

    service_ids: List[str] = field(default_factory=list)
    task_ids: List[str] = field(default_factory=list)
    node_ids: List[str] = field(default_factory=list)


@dataclass
class LogMessage:
    task_id: str
    node_id: str
    stream: str       # "stdout" | "stderr"
    data: bytes
    timestamp: float = 0.0


@dataclass
class LogSubscriptionOptions:
    """reference: api/logbroker.proto:26 LogSubscriptionOptions.

    ``tail``: <0 = whole history, 0 = no history (follow only), N>0 =
    last N messages per task.  ``since``: unix seconds; only messages
    stamped at/after it replay.  ``streams``: restrict to stdout/stderr.
    """

    streams: List[str] = field(default_factory=list)
    follow: bool = True
    tail: int = -1
    since: float = 0.0


@dataclass
class SubscriptionMessage:
    """Told to agents: start/stop publishing for these tasks."""

    id: str
    selector: LogSelector
    close: bool = False


class _LogSubscription:
    def __init__(self, broker: "LogBroker", selector: LogSelector,
                 options: LogSubscriptionOptions):
        self.id = new_id()
        self.broker = broker
        self.selector = selector
        self.options = options
        self.stream = Queue()
        self._sub = self.stream.subscribe()
        # number of history-replay messages queued at subscribe time;
        # consumers drain exactly this many before the live window so a
        # fast producer can't extend the drain phase unboundedly
        self.backlog_count = 0

    def matches(self, msg: LogMessage, task: Optional[Task]) -> bool:
        opts = self.options
        if opts.streams and msg.stream not in opts.streams:
            return False
        sel = self.selector
        if msg.task_id in sel.task_ids:
            return True
        if msg.node_id in sel.node_ids:
            return True
        if task is not None and task.service_id in sel.service_ids:
            return True
        return False

    def get(self, timeout: Optional[float] = None) -> LogMessage:
        return self._sub.get(timeout=timeout)

    def close(self) -> None:
        self.broker._remove_subscription(self)


class LogBroker:
    """reference: broker.go:52."""

    #: per-task history budget for tail/since replay (bytes of log data)
    HISTORY_BYTES_PER_TASK = 256 << 10

    def __init__(self, store: MemoryStore):
        self.store = store
        self._mu = threading.Lock()
        self._subscriptions: Dict[str, _LogSubscription] = {}
        self._listeners = Queue()   # agents following subscription changes
        # bounded per-task message history so tail/since subscriptions
        # can replay recent output.  The reference reads history from the
        # source (the container runtime's log storage, dockerexec
        # controller); here agents ship from task start and the broker
        # retains a byte-budgeted ring per task — same operator-visible
        # semantics within the budget, bounded memory on the manager
        self._history: Dict[str, List[LogMessage]] = {}
        self._history_bytes: Dict[str, int] = {}
        self._prune_tick = 0

    # ------------------------------------------------------------- consumers

    def subscribe_logs(self, selector: LogSelector,
                       follow: bool = True,
                       options: Optional[LogSubscriptionOptions] = None
                       ) -> _LogSubscription:
        """reference: broker.go:223 SubscribeLogs.  Holds the broker lock
        across backlog replay + registration so a concurrent
        publish_logs can neither be missed nor duplicated."""
        if options is None:
            options = LogSubscriptionOptions(follow=follow)
        sub = _LogSubscription(self, selector, options)
        with self._mu:
            backlog = self._backlog_locked(sub)
            sub.backlog_count = len(backlog)
            for msg in backlog:
                sub.stream.publish(msg)
            if options.follow:
                self._subscriptions[sub.id] = sub
            else:
                sub.stream.close()
        if options.follow:
            self._listeners.publish(SubscriptionMessage(sub.id, selector))
        return sub

    def _backlog_locked(self, sub: _LogSubscription) -> List[LogMessage]:
        """History replay per the subscription's options (tail/since/
        streams), grouped per task in arrival order."""
        opts = sub.options
        if opts.tail == 0:
            return []
        out: List[LogMessage] = []
        for task_id, msgs in self._history.items():
            task = self.store.raw_get(Task, task_id)
            picked = [m for m in msgs if sub.matches(m, task)
                      and (opts.since <= 0
                           or m.timestamp >= opts.since)]
            if opts.tail > 0:
                picked = picked[-opts.tail:]
            out.extend(picked)
        return out

    def _remove_subscription(self, sub: _LogSubscription) -> None:
        with self._mu:
            self._subscriptions.pop(sub.id, None)
        self._listeners.publish(
            SubscriptionMessage(sub.id, sub.selector, close=True))
        sub.stream.close()

    # -------------------------------------------------------------- agents

    def listen_subscriptions(self) -> Subscription:
        """Agents follow this to learn what to publish
        (reference: broker.go:305); current subscriptions are replayed."""
        listener = self._listeners.subscribe()
        with self._mu:
            current = list(self._subscriptions.values())
        for sub in current:
            listener._publish(SubscriptionMessage(sub.id, sub.selector))
        return listener

    def stop_listening(self, listener: Subscription) -> None:
        self._listeners.unsubscribe(listener)

    def publish_logs(self, messages: List[LogMessage]) -> None:
        """Agent-side ingest (reference: broker.go:379 PublishLogs)."""
        from ..models.types import now
        with self._mu:
            subs = list(self._subscriptions.values())
            for msg in messages:
                if not msg.timestamp:
                    msg.timestamp = now()
                ring = self._history.setdefault(msg.task_id, [])
                ring.append(msg)
                used = self._history_bytes.get(msg.task_id, 0) \
                    + len(msg.data)
                while used > self.HISTORY_BYTES_PER_TASK and ring:
                    used -= len(ring.pop(0).data)
                self._history_bytes[msg.task_id] = used
            self._prune_tick += 1
            if self._prune_tick >= 256:
                # long-lived managers: drop rings for tasks the store no
                # longer knows (reaped); active tasks keep their history.
                # Interval-gated (every 256 ingests) so the scan doesn't
                # rerun on every batch under the lock; unconditional on
                # ring count — ≤1024 dead rings still pin up to 256MiB
                self._prune_tick = 0
                for tid in list(self._history):
                    if self.store.raw_get(Task, tid) is None:
                        del self._history[tid]
                        self._history_bytes.pop(tid, None)
        for msg in messages:
            task = self.store.raw_get(Task, msg.task_id)
            for sub in subs:
                if sub.matches(msg, task):
                    sub.stream.publish(msg)

    def close(self) -> None:
        with self._mu:
            subs = list(self._subscriptions.values())
            self._subscriptions.clear()
        for sub in subs:
            sub.stream.close()
        self._listeners.close()
