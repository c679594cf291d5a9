"""Executor/Controller interfaces and the task state advancer.

Reference: agent/exec/{executor.go,controller.go,errors.go}.

``Controller`` controls one task's runtime (prepare/start/wait/shutdown/
terminate/remove); ``do_task`` is the state machine that advances a task's
observed state toward its desired state by calling controller methods —
the direct counterpart of exec.Do (controller.go:142).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

from ..models.objects import Task
from ..models.types import TaskState, TaskStatus, now

log = logging.getLogger("exec")


class TaskError(Exception):
    pass


class ErrTaskNoop(TaskError):
    """A second call to do_task would result in no change."""


class ErrTaskRetry(TaskError):
    """Transient failure; retry after backoff."""


class ErrTaskPrepared(TaskError):
    """Prepare was called on an already-prepared task."""


class ErrTaskStarted(TaskError):
    """Start was called on an already-started task."""


class TemporaryError(TaskError):
    """Failure that should be retried rather than failing the task."""


class Controller:
    """Per-task runtime controller (reference: controller.go:16)."""

    def update(self, t: Task) -> None:
        """The task definition changed (mainly desired state)."""

    def prepare(self) -> None:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def wait(self) -> None:
        """Block until the task exits; raise to report failure.  Must
        return or raise TemporaryError promptly after ``interrupt()``."""
        raise NotImplementedError

    def interrupt(self) -> None:
        """Cancel an in-flight blocking call (wait/start/prepare) so the
        task manager can act on an updated task definition — the Python
        equivalent of the reference's context cancellation in
        agent/task.go (blocked Do is cancelled when an update arrives)."""

    def shutdown(self) -> None:
        raise NotImplementedError

    def terminate(self) -> None:
        raise NotImplementedError

    def remove(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Executor:
    """Node-level runtime backend (reference: executor.go:10)."""

    def describe(self):
        """Return a NodeDescription for this node."""
        raise NotImplementedError

    def configure(self, node) -> None:
        """Apply node object changes (labels etc.)."""

    def set_network_bootstrap_keys(self, keys) -> None:
        """Receive the cluster's dataplane encryption keys (gossip/IPSec)
        when the key manager rotates them (reference:
        agent/exec/executor.go:30 SetNetworkBootstrapKeys, delivered via
        the session stream's SessionMessage.NetworkBootstrapKeys).
        Executors without a dataplane ignore them."""

    def controller(self, t: Task) -> Controller:
        raise NotImplementedError


def do_task(t: Task, ctlr: Controller) -> Tuple[TaskStatus, Optional[type]]:
    """Advance the task one state toward its desired state.

    Returns (new_status, flag) where flag is ErrTaskNoop when nothing more
    can be done without external change, ErrTaskRetry for transient
    failures, or None when a transition was made (reference:
    controller.go:142 Do).
    """
    status = t.status.copy()

    def noop():
        return status, ErrTaskNoop

    def retry():
        return status, ErrTaskRetry

    def transition(state: TaskState, msg: str):
        assert status.state <= state, "invalid state transition"
        status.state = state
        status.message = msg
        status.err = ""
        status.timestamp = now()
        return status, None

    def fatal(e: Exception):
        status.err = str(e)
        if isinstance(e, TemporaryError):
            return retry()
        status.timestamp = now()
        # terminal failure state depends on how far the task got
        if status.state < TaskState.STARTING:
            status.state = TaskState.REJECTED
        else:
            status.state = TaskState.FAILED
        return status, None

    # the agent's ceiling is SHUTDOWN: desired REMOVE also means "stop it"
    if t.desired_state >= TaskState.SHUTDOWN:
        if status.state >= TaskState.COMPLETE:
            return noop()
        try:
            ctlr.shutdown()
        except Exception as e:
            return fatal(e)
        return transition(TaskState.SHUTDOWN, "shutdown")

    if status.state > t.desired_state:
        return noop()  # way beyond desired state, pause

    # states that may proceed past the desired state
    if status.state == TaskState.PREPARING:
        try:
            ctlr.prepare()
        except ErrTaskPrepared:
            pass
        except Exception as e:
            return fatal(e)
        return transition(TaskState.READY, "prepared")
    if status.state == TaskState.STARTING:
        try:
            ctlr.start()
        except ErrTaskStarted:
            pass
        except Exception as e:
            return fatal(e)
        return transition(TaskState.RUNNING, "started")
    if status.state == TaskState.RUNNING:
        try:
            ctlr.wait()
        except Exception as e:
            return fatal(e)
        return transition(TaskState.COMPLETE, "finished")

    # pause states: proceed only when desired state is beyond current
    if status.state >= t.desired_state:
        return noop()
    if status.state in (TaskState.NEW, TaskState.PENDING,
                        TaskState.ASSIGNED):
        return transition(TaskState.ACCEPTED, "accepted")
    if status.state == TaskState.ACCEPTED:
        return transition(TaskState.PREPARING, "preparing")
    if status.state == TaskState.READY:
        return transition(TaskState.STARTING, "starting")
    return noop()
