"""Process executor: runs tasks as real OS processes.

Reference role: swarmd's container executor (agent/exec/dockerapi/
controller.go, executor.go) — the production runtime backend behind the
Executor/Controller seam.  This image has no container runtime, so the
native backend supervises plain processes instead: ``ContainerSpec.command
+ args`` become the argv, ``env`` is merged over the parent environment,
``dir`` is the working directory, and the "image" is informational.

Lifecycle mapping (controller.go:142 Do):
  prepare  -> resolve argv + stage a log file
  start    -> subprocess.Popen (new session, so shutdown can signal the
              whole process group)
  wait     -> poll the process (interruptible, like a cancelled context)
  shutdown -> SIGTERM to the group, escalating to SIGKILL after a grace
              period (dockerapi stop-grace equivalent)
  terminate-> SIGKILL immediately
  remove   -> delete the log file

Exit status: code 0 completes the task; non-zero raises with the tail of
the captured output as the error message (surfacing in Task.status.err,
like the reference's exit-code ExitError).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import threading
import time
from typing import Dict, Optional

from ..models.objects import Task
from ..models.types import NodeDescription, Platform, Resources
from .exec import (Controller, ErrTaskRetry, Executor, TaskError,
                   TemporaryError)

log = logging.getLogger("procexec")

STOP_GRACE_PERIOD = 10.0     # SIGTERM -> SIGKILL escalation
WAIT_POLL_INTERVAL = 0.05
ERR_TAIL_BYTES = 512


class ProcessController(Controller):
    """Supervises one task's process (reference: dockerapi/controller.go)."""

    def __init__(self, task: Task, log_dir: str,
                 stop_grace: float = STOP_GRACE_PERIOD, volumes=None,
                 dependencies=None):
        self.task = task
        self.log_dir = log_dir
        self.stop_grace = stop_grace
        self.volumes = volumes   # node-side CSI manager (paths by id)
        # worker-backed secret/config getter (secret_for/config_for)
        self.dependencies = dependencies
        self.proc: Optional[subprocess.Popen] = None
        self.log_path = os.path.join(log_dir, f"{task.id}.log")
        # secrets/configs materialize as files here (the process
        # equivalent of the reference's /run/secrets mounts)
        self.deps_dir = os.path.join(log_dir, f"{task.id}.deps")
        self._argv: Optional[list] = None
        self._env: Optional[dict] = None
        self._cwd: Optional[str] = None
        self._interrupted = threading.Event()
        self._log_file = None
        self._health_failures = 0
        self._next_health_check: Optional[float] = None

    # ----------------------------------------------------------- lifecycle

    def update(self, t: Task) -> None:
        self.task = t

    def interrupt(self) -> None:
        self._interrupted.set()

    def prepare(self) -> None:
        spec = self.task.spec.container
        if spec is None:
            raise TaskError("task has no container spec")
        argv = list(spec.command) + list(spec.args)
        if not argv:
            raise TaskError("no command to run (container.command/args)")
        env = dict(os.environ)
        for kv in spec.env:
            key, _, value = kv.partition("=")
            env[key] = value
        # published CSI volume paths surface as SWARM_VOLUME_<TARGET>
        # env vars (process tasks have no mount namespace to bind into);
        # a task with an unpublished volume must not start yet
        used_keys = set()
        if self.volumes is not None:
            for va in self.task.volumes:
                path = self.volumes.get(va.id)
                if path is None:
                    # TemporaryError: do_task retries with backoff, the
                    # task stays PREPARING until the volume publishes
                    raise TemporaryError(
                        f"volume {va.id[:8]} not yet published on node")
                key = self._dep_env_key("SWARM_VOLUME_", va.target,
                                        va.id, used_keys)
                env[key] = path
        # secrets/configs materialize as files under a per-task dir;
        # their paths surface as SWARM_SECRET_<NAME> / SWARM_CONFIG_<NAME>
        # env vars (the reference bind-mounts them at /run/secrets — a
        # process task has no mount namespace, so files + env it is).
        # A referenced-but-undelivered dependency delays the start: the
        # dispatcher ships deps before tasks, but a driver-backed secret
        # whose provider is down arrives late (reference: the container
        # waits in PREPARING until its secrets resolve)
        if self.dependencies is not None:
            for ref in spec.secrets:
                obj = self.dependencies.secret_for(self.task.id,
                                                   ref.secret_id)
                if obj is None:
                    # TemporaryError: retried with backoff — a driver-
                    # backed secret whose provider was down arrives late
                    raise TemporaryError(
                        f"secret {ref.secret_name or ref.secret_id[:8]} "
                        "not yet delivered to this node")
                key = self._dep_env_key("SWARM_SECRET_",
                                        ref.target or ref.secret_name,
                                        ref.secret_id, used_keys)
                env[key] = self._write_dep(
                    "secrets", ref.target or ref.secret_name
                    or ref.secret_id, obj.spec.data, 0o600)
            for ref in spec.configs:
                obj = self.dependencies.config_for(self.task.id,
                                                   ref.config_id)
                if obj is None:
                    raise TemporaryError(
                        f"config {ref.config_name or ref.config_id[:8]} "
                        "not yet delivered to this node")
                key = self._dep_env_key("SWARM_CONFIG_",
                                        ref.target or ref.config_name,
                                        ref.config_id, used_keys)
                env[key] = self._write_dep(
                    "configs", ref.target or ref.config_name
                    or ref.config_id, obj.spec.data, 0o644)
        self._argv = argv
        self._env = env
        self._cwd = spec.dir or None
        os.makedirs(self.log_dir, exist_ok=True)

    @staticmethod
    def _dep_env_key(prefix: str, name: str, obj_id: str,
                     used_keys: set) -> str:
        """One mangle for every dependency kind; distinct names can
        mangle identically (db-pass vs db.pass), so collisions
        disambiguate by object id."""
        mangled = "".join(ch if ch.isalnum() else "_"
                          for ch in (name or "").strip("/")).upper()
        key = prefix + (mangled or "UNNAMED")
        if key in used_keys:
            key = f"{key}_{obj_id[:6].upper()}"
        used_keys.add(key)
        return key

    def _write_dep(self, kind: str, name: str, data: bytes,
                   mode: int) -> str:
        """Secrets and configs live in separate subdirs so same-named
        targets cannot overwrite each other across kinds."""
        d = os.path.join(self.deps_dir, kind)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name.strip("/").replace("/", "_") or "dep")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        os.fchmod(fd, mode)   # O_CREAT mode only applies to new files
        with os.fdopen(fd, "wb") as f:
            f.write(data or b"")
        return path

    def start(self) -> None:
        if self.proc is not None:
            return
        assert self._argv is not None, "start before prepare"
        self._close_log()   # a failed spawn retry must not leak the fd
        self._log_file = open(self.log_path, "ab")
        try:
            # own session: signals reach the whole process group, so a
            # task that spawns children cannot leak them past shutdown
            self.proc = subprocess.Popen(
                self._argv, env=self._env, cwd=self._cwd,
                stdout=self._log_file, stderr=subprocess.STDOUT,
                start_new_session=True)
        except FileNotFoundError as e:
            raise TaskError(f"executable not found: {e.filename}")
        except OSError as e:
            raise TemporaryError(f"spawn failed: {e}")
        # health state lives on the controller, not in wait(): an
        # interrupt-triggered wait() retry must neither reset the
        # consecutive-failure count nor re-apply start_period
        argv, hc = self._health_argv()
        self._health_failures = 0
        self._next_health_check = None
        self._health_grace_until = 0.0
        if argv is not None:
            # probes run on the normal interval from the start;
            # start_period only suppresses failure COUNTING, it does not
            # delay probing (reference: dockerd health.go — probes during
            # the start period run but failures don't count, and one
            # success ends the period early)
            self._next_health_check = time.monotonic() + \
                (hc.interval or 30.0)
            self._health_grace_until = time.monotonic() + \
                (hc.start_period or 0.0)

    def _health_argv(self):
        """Health probe argv from the spec, or None when disabled
        (reference: api/types.proto HealthConfig.Test — ["NONE"]
        disables, ["CMD", ...] is exec form, ["CMD-SHELL", s] runs via
        the shell; dockerapi executes these inside the container, here
        they run as host probes beside the process)."""
        c = self.task.spec.container
        hc = c.healthcheck if c is not None else None
        if hc is None or not hc.test:
            return None, None
        test = list(hc.test)
        if test[0] == "NONE":
            return None, None
        if test[0] == "CMD":
            argv = test[1:]
        elif test[0] == "CMD-SHELL":
            argv = ["sh", "-c", " ".join(test[1:])]
        else:
            argv = test
        return (argv or None), hc

    def wait(self) -> None:
        proc = self.proc
        if proc is None:
            raise TaskError("wait before start")
        health_argv, hc = self._health_argv()
        while proc.poll() is None:
            if self._interrupted.is_set():
                # one-shot: the retried wait() must be able to block again
                # (a sticky event would spin the task in retries forever)
                self._interrupted.clear()
                raise TemporaryError("wait interrupted by task update")
            if self._next_health_check is not None \
                    and time.monotonic() >= self._next_health_check:
                # reference defaults (dockerd): interval/timeout 30s,
                # 3 retries; start_period delays the first verdict
                self._next_health_check = \
                    time.monotonic() + (hc.interval or 30.0)
                failed = self._health_probe_failed(health_argv, hc)
                if self._interrupted.is_set():
                    continue   # probe aborted: verdict is inconclusive
                if failed:
                    if time.monotonic() < self._health_grace_until:
                        continue   # start period: failures don't count
                    self._health_failures += 1
                    if self._health_failures >= (hc.retries or 3):
                        # unhealthy: stop the task so the restart policy
                        # takes over (reference: dockerapi controller
                        # Wait returns when the container turns
                        # unhealthy -> task fails -> orchestrator heals)
                        self.shutdown()
                        raise TaskError(
                            f"task failed health check "
                            f"({self._health_failures} consecutive "
                            f"failures): {' '.join(health_argv)}")
                else:
                    self._health_failures = 0
                    # a success ends the start period early: later
                    # failures count from here on
                    self._health_grace_until = 0.0
            time.sleep(WAIT_POLL_INTERVAL)
        code = proc.returncode
        if code != 0:
            raise TaskError(
                f"process exited with {code}: {self._err_tail()}")

    def _health_probe_failed(self, argv, hc) -> bool:
        """Run one probe in its own process group, polling so an
        interrupt() aborts promptly (the Controller.wait contract) and a
        timed-out shell pipeline cannot leak children past the kill."""
        try:
            p = subprocess.Popen(
                argv, env=self._env, cwd=self._cwd,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
        except OSError:
            return True
        deadline = time.monotonic() + (hc.timeout or 30.0)
        while p.poll() is None:
            timed_out = time.monotonic() >= deadline
            if timed_out or self._interrupted.is_set():
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                p.wait()
                return timed_out   # interrupt: inconclusive, not a fail
            time.sleep(WAIT_POLL_INTERVAL)
        return p.returncode != 0

    def _err_tail(self) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - ERR_TAIL_BYTES))
                return f.read().decode("utf-8", "replace").strip()
        except OSError:
            return ""

    def _signal_group(self, sig: int) -> bool:
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return False
        try:
            os.killpg(os.getpgid(proc.pid), sig)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def shutdown(self) -> None:
        """Graceful stop: SIGTERM, then SIGKILL after the grace period."""
        if self._signal_group(signal.SIGTERM):
            deadline = time.monotonic() + self.stop_grace
            proc = self.proc
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(WAIT_POLL_INTERVAL)
            if proc.poll() is None:
                self._signal_group(signal.SIGKILL)
                proc.wait(timeout=self.stop_grace)
        self._close_log()

    def terminate(self) -> None:
        if self._signal_group(signal.SIGKILL):
            self.proc.wait(timeout=self.stop_grace)
        self._close_log()

    def remove(self) -> None:
        self._close_log()
        try:
            os.unlink(self.log_path)
        except OSError:
            pass
        import shutil
        shutil.rmtree(self.deps_dir, ignore_errors=True)

    def close(self) -> None:
        self._close_log()
        # plaintext secret material must not outlive the task's
        # controller (remove() has no caller in the task lifecycle;
        # close() always runs when the manager winds down)
        import shutil
        shutil.rmtree(self.deps_dir, ignore_errors=True)

    def _close_log(self) -> None:
        if self._log_file is not None:
            try:
                self._log_file.close()
            except OSError:
                pass
            self._log_file = None

    # -------------------------------------------------------------- logs

    def read_logs(self) -> bytes:
        try:
            with open(self.log_path, "rb") as f:
                return f.read()
        except OSError:
            return b""


class ProcessExecutor(Executor):
    """Runtime backend running tasks as supervised OS processes."""

    def __init__(self, hostname: str = "", log_dir: str = "",
                 stop_grace: float = STOP_GRACE_PERIOD):
        import socket
        import tempfile
        # node-side CSI manager, injected by the Worker so controllers
        # can hand tasks their published volume paths
        self.volumes = None
        # worker-backed secret/config getter, injected by the Worker
        self.dependencies = None
        self.hostname = hostname or socket.gethostname()
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), "swarmkit-tpu-tasks")
        self.stop_grace = stop_grace
        self.controllers: Dict[str, ProcessController] = {}
        self._mu = threading.Lock()

    def describe(self) -> NodeDescription:
        cpus = os.cpu_count() or 1
        mem = 0
        try:
            mem = (os.sysconf("SC_PAGE_SIZE")
                   * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError):
            pass
        uname = os.uname()
        return NodeDescription(
            hostname=self.hostname,
            platform=Platform(architecture=uname.machine,
                              os=uname.sysname.lower()),
            resources=Resources(nano_cpus=cpus * 10 ** 9,
                                memory_bytes=mem))

    MAX_EXITED_CONTROLLERS = 256

    def controller(self, t: Task) -> ProcessController:
        ctlr = ProcessController(t, self.log_dir,
                                 stop_grace=self.stop_grace,
                                 volumes=self.volumes,
                                 dependencies=self.dependencies)
        with self._mu:
            self.controllers[t.id] = ctlr
            self._sweep_locked()
        return ctlr

    def _sweep_locked(self) -> None:
        """Drop the oldest exited controllers beyond a bound (a long-
        running daemon must not grow memory/log references linearly with
        every task ever run; recent ones stay reachable for log reads)."""
        exited = [tid for tid, c in self.controllers.items()
                  if c.proc is not None and c.proc.poll() is not None]
        for tid in exited[:max(0, len(exited)
                               - self.MAX_EXITED_CONTROLLERS)]:
            self.controllers.pop(tid).close()
