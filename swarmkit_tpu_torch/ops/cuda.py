"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file,
all sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``swarmkit_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a changed
source is never served by a stale library.

Every entry point takes its pointers and the CUDA stream as ``c_void_p``
and returns ``cudaGetLastError()``; :class:`CudaKernel` raises
:class:`KernelLaunchError` when that is not 0 and counts the launch
otherwise.  A library that cannot be built or loaded (no ``nvcc``, a
failed compile or link, a missing symbol) raises :class:`KernelBuildError`.
Both subclass ``RuntimeError``; the planner's breaker sends a group to the
host path on a launch error (:data:`DEVICE_ERRORS`), never on a build
error.  Nothing here runs at
import time: the CPU tests import every module of the package on a machine
without a card or ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("feasibility.cu", "segsum.cu", "waterfill.cu", "packfill.cu",
           "score.cu", "fused.cu", "scatter.cu", "gangfit.cu", "victims.cu",
           "shardfill.cu", "shardpack.cu")
HEADERS = ("common.cuh", "feasibility.cuh", "packfill.cuh",
           "shard.cuh", "waterfill.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: symbol -> (argtypes, restype); the stream is the last
# pointer of each launching entry
SIGNATURES = {
    "sk_feasibility": ([_I, _I, _I] + [_P] * 23, _I),
    "sk_seg_sum": ([_I, _I] + [_P] * 7, _I),
    "sk_shard_seg_sum": ([_I, _I] + [_P] * 5, _I),
    "sk_waterfill": ([_I, _I, _P, _P, _P, _I] + [_P] * 10, _I),
    "sk_waterfill_scratch_bytes": ([_I], ctypes.c_longlong),
    "sk_packfill": ([_I, _P, _P, _I] + [_P] * 4, _I),
    "sk_strategy_score": ([_I] * 4 + [_P] * 14, _I),
    "sk_fused_feasibility": ([_I] * 5 + [_P] * 27, _I),
    "sk_fused_carry": ([_I, _I] + [_P] * 9, _I),
    "sk_scatter_rows": ([_I, _I, _I] + [_P] * 3, _I),
    "sk_gang_fit": ([_I] * 4 + [_P] * 20, _I),
    "sk_gang_fit_blocks": ([_I, _I], _I),
    "sk_gang_fit_work_bytes": ([_I, _I], ctypes.c_longlong),
    "sk_select_victims": ([_I] * 5 + [_L] * 3 + [_P] * 12, _I),
    "sk_select_victims_scratch_bytes": ([_I], ctypes.c_longlong),
    "sk_shard_waterfill": ([_I, _I, _P, _P, _I, _P, _P], _I),
    "sk_shard_packfill": ([_I, _P, _P, _I, _P], _I),
    "sk_error_string": ([_I], ctypes.c_char_p),
}


class KernelBuildError(RuntimeError):
    """The kernel library cannot be built or loaded: no ``nvcc``, a failed
    compile or link, a missing symbol.  Never routed around."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch."""


#: the errors the planner's breaker routes to the host path: a refused
#: launch, and the CUDA runtime's own error, which torch raises where an
#: asynchronous fault surfaces (a copy, an event's synchronize).  Anything
#: else a plan path raises is a fault of the program and propagates.
DEVICE_ERRORS = (KernelLaunchError,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


class BuildResult:
    """Where the library is, how long its build took (0 when it was
    already built for these sources) and what ``ptxas -v`` reported."""

    __slots__ = ("path", "seconds", "ptxas")

    def __init__(self, path: Path, seconds: float, ptxas: str):
        self.path = path
        self.seconds = seconds
        self.ptxas = ptxas


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on the PATH)")


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[List[str]]) -> List[str]:
    """Run commands in parallel; wait for every one; raise with the
    compiler's output if any failed.  Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        outs.append(err)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise KernelBuildError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return outs


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into ``_build/libswarmkernels-<hash>.so``."""
    digest = source_digest()
    lib = BUILD_DIR / f"libswarmkernels-{digest}.so"
    log = BUILD_DIR / f"libswarmkernels-{digest}.ptxas.txt"
    if lib.exists():
        ptxas = log.read_text() if log.exists() else ""
        return BuildResult(lib, 0.0, ptxas)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    compile_cmds = [
        [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c",
         str(CSRC_DIR / src), "-o", str(obj)]
        for src, obj in zip(SOURCES, objs)]
    errs = _run_all(compile_cmds)
    tmp = BUILD_DIR / f"libswarmkernels.{tag}.so"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    seconds = time.perf_counter() - t0
    ptxas = "".join(f"== {src}\n{err}" for src, err in zip(SOURCES, errs))
    log.write_text(ptxas)
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    for obj in objs:
        obj.unlink(missing_ok=True)
    return BuildResult(lib, seconds, ptxas)


_lib: Optional[ctypes.CDLL] = None
_lib_mu = threading.Lock()
# seconds of this process's library build not yet charged to a launch
_unclaimed_build_s = 0.0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (the lock is taken
    only until it is loaded)."""
    global _lib, _unclaimed_build_s
    if _lib is not None:
        return _lib
    with _lib_mu:
        if _lib is None:
            built = build()
            try:
                lib = ctypes.CDLL(str(built.path))
                for sym, (argtypes, restype) in SIGNATURES.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = restype
            except (OSError, AttributeError) as e:
                raise KernelBuildError(
                    f"CUDA kernel library {built.path} unusable: {e}") from e
            _unclaimed_build_s = built.seconds
            _lib = lib
        return _lib


def take_build_seconds() -> float:
    """The seconds this process spent building the kernel library, once:
    the first caller after the build gets them, every later one 0.0 (the
    planner charges them to the first launch of a bucket)."""
    global _unclaimed_build_s
    s, _unclaimed_build_s = _unclaimed_build_s, 0.0
    return s


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a ``c_void_p`` argument (None for
    an absent optional input: NULL on the C side)."""
    return None if t is None else t.data_ptr()


# the current stream's raw handle for a device index, without building a
# torch.cuda.Stream object per launch (absent from CPU builds of torch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice", None)


def stream_handle() -> int:
    """The current CUDA stream of the current device, as a pointer-sized
    int."""
    if _raw_stream is None or _current_device is None:
        return torch.cuda.current_stream().cuda_stream
    return _raw_stream(_current_device())


class CudaKernel:
    """One hand-written kernel's C entry, with its launch count.

    ``launches`` goes up by one for each launch that the CUDA runtime
    accepted, and nowhere else, so a run can show that its main path went
    through the kernel."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None     # the C entry, resolved once the library loads

    def __call__(self, *args) -> None:
        self.launch(*args)

    def launch(self, *args, stream: Optional[int] = None) -> None:
        """Call the entry on ``stream`` (default: the current stream), which
        launches the kernel once, and count that launch."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.symbol)
        code = fn(*args, stream_handle() if stream is None else stream)
        if code != 0:
            msg = library().sk_error_string(code).decode(errors="replace")
            raise KernelLaunchError(f"{self.name} kernel launch failed: "
                                    f"CUDA error {code} ({msg})")
        self.launches += 1


def launch_counts(kernels) -> Dict[str, int]:
    return {k.name: k.launches for k in kernels}


def reset_launch_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
