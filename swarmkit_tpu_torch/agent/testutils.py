"""Test executor/controller fakes (reference: agent/testutils/fakes.go).

TestController runs tasks without any real runtime: prepare/start succeed
instantly, wait blocks until shutdown (long-running service semantics) or
completes/fails on cue.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..models.objects import Task
from ..models.types import NodeDescription
from .exec import Controller, Executor, TaskError


class TestController(Controller):
    __test__ = False  # not a pytest class
    def __init__(self, fail_on_start: bool = False,
                 exit_after: Optional[float] = None,
                 exit_error: Optional[str] = None):
        self.task: Optional[Task] = None
        self.prepared = threading.Event()
        self.started = threading.Event()
        self.stopped = threading.Event()
        self.interrupted = threading.Event()
        self.fail_on_start = fail_on_start
        self.exit_after = exit_after
        self.exit_error = exit_error

    def update(self, t: Task) -> None:
        self.task = t

    def interrupt(self) -> None:
        self.interrupted.set()

    def prepare(self) -> None:
        self.prepared.set()

    def start(self) -> None:
        if self.fail_on_start:
            raise TaskError("TestController told to fail on start")
        self.started.set()

    def wait(self) -> None:
        from .exec import TemporaryError
        deadline = None
        if self.exit_after is not None:
            import time
            deadline = time.monotonic() + self.exit_after
        while True:
            if self.stopped.wait(timeout=0.02):
                return
            if self.interrupted.is_set():
                self.interrupted.clear()
                raise TemporaryError("wait interrupted by task update")
            if deadline is not None:
                import time
                if time.monotonic() >= deadline:
                    if self.exit_error:
                        raise TaskError(self.exit_error)
                    return  # ran to completion

    def shutdown(self) -> None:
        self.stopped.set()

    def terminate(self) -> None:
        self.stopped.set()

    def remove(self) -> None:
        pass

    def close(self) -> None:
        self.stopped.set()


class TestExecutor(Executor):
    __test__ = False  # not a pytest class
    def __init__(self, hostname: str = "test-node", resources=None,
                 **controller_kwargs):
        self.hostname = hostname
        # reported in describe(): without it a registration overwrites
        # the node's description and zeroes its capacity, starving any
        # reservation-carrying workload (None keeps legacy behavior)
        self.resources = resources
        self.controller_kwargs = controller_kwargs
        self.controllers: Dict[str, TestController] = {}
        self._mu = threading.Lock()

    def describe(self) -> NodeDescription:
        return NodeDescription(hostname=self.hostname,
                               resources=self.resources)

    def set_network_bootstrap_keys(self, keys) -> None:
        # recorded for tests asserting key-manager rotations reach agents
        self.network_keys = list(keys)

    def controller(self, t: Task) -> TestController:
        ctlr = TestController(**self.controller_kwargs)
        ctlr.task = t
        with self._mu:
            self.controllers[t.id] = ctlr
        return ctlr
