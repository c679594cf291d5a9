"""Native hot-path loader: the C commit plane.

``hotpath.c`` is a byte-for-byte copy of the reference's C module (plan
apply, block stage, block decode, follower apply, watch fan-out): it is
duck-typed, takes every class it builds as an argument and names no Python
package, so the port's models and store drive it unchanged.

The module is compiled at first use with the interpreter's own C compiler
(``sysconfig``'s ``CC``, ``-O2 -shared -fPIC``, the interpreter's include
directory) into ``swarmkit_tpu_torch/_build/native/<sha256>/``, where the
hash covers the source, the compiler and the flags: a changed source can
never be served by a stale library.  The build writes to a temporary name
and moves it into place with ``os.replace``, so concurrent builds (test
workers) see all of it or none.  The library is loaded under the name
``swarmkit_tpu_torch.native._hotpath``.

Where no compiler exists or the build fails, every accessor returns None
and the store, events, watch, serde and planner take their pure-Python
loops (logged once).  ``SWARMKIT_TPU_NO_NATIVE=1`` forces the Python paths;
``SWARM_NATIVE_COMMIT=0`` turns off the columnar commit plane alone.  Both
are read on every call.  ``get_commit()`` is the accessor of the commit
plane's call sites: when the native module is unavailable while the plane
is not explicitly disabled, each call counts a
``swarm_native_commit_fallbacks`` tick, so a run can prove the native path
ran.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import shlex
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

log = logging.getLogger("native")

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "hotpath.c"
BUILD_ROOT = NATIVE_DIR.parent / "_build" / "native"
MODULE_NAME = __name__ + "._hotpath"
CFLAGS = ("-O2", "-shared", "-fPIC")

_mod = None
_tried = False
_mu = threading.Lock()


def compiler() -> List[str]:
    """The interpreter's C compiler command (``sysconfig``'s ``CC``, which
    may carry flags), else ``cc``."""
    cc = sysconfig.get_config_var("CC") or "cc"
    return shlex.split(cc)


def build_dir() -> Path:
    """``_build/native/<sha256 of the source, compiler and flags>``."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(compiler() + list(CFLAGS)).encode())
    h.update(sysconfig.get_paths()["include"].encode())
    return BUILD_ROOT / h.hexdigest()


def library_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return build_dir() / ("_hotpath" + suffix)


def build() -> Path:
    """Compile ``hotpath.c`` into its hash folder (a no-op when it is
    there); raises on a missing compiler or a failed build."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    cmd = compiler() + list(CFLAGS) + [f"-I{include}", str(SOURCE), "-o",
                                       str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(
            f"native hotpath build failed to start: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native hotpath build failed:\n$ "
                           f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    return lib


def _load(path: Path):
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, str(path),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    sys.modules[MODULE_NAME] = mod
    return mod


def get():
    """The ``_hotpath`` C module, or None when disabled or unavailable."""
    global _mod, _tried
    if os.environ.get("SWARMKIT_TPU_NO_NATIVE"):
        return None
    if _tried:
        return _mod
    with _mu:
        if not _tried:
            try:
                _mod = _load(build())
            except Exception as e:   # no compiler, no headers: run Python
                log.warning("native hotpath unavailable (%s); using Python "
                            "paths", e)
                _mod = None
            _tried = True
    return _mod


def commit_enabled() -> bool:
    """The columnar-commit-plane switch, read per call so tests can flip
    it without reimporting."""
    return os.environ.get("SWARM_NATIVE_COMMIT", "1") != "0"


def get_commit():
    """The native module for the columnar commit plane (block decode,
    follower apply, watch fan-out), or None when disabled
    (``SWARM_NATIVE_COMMIT=0``) or unavailable.  An unavailable but
    requested native plane counts a fallback tick per call."""
    if not commit_enabled():
        return None
    mod = get()
    if mod is None:
        from ..utils.metrics import registry as _metrics
        _metrics.counter("swarm_native_commit_fallbacks")
    return mod


def loaded_path() -> Optional[str]:
    """Where the loaded module came from (None before a load)."""
    return getattr(_mod, "__file__", None)
