"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc for `sm_90a` into an object,
all sources in parallel, and the objects link into one shared library
with a plain C interface (`build/floria_tpu_torch/libfloria_tpu_torch.so`
under the repository root), loaded with ctypes. The build runs at first
use, never at import, and is redone whenever a source is newer than the
library. A failed build raises. Processes that start together (pytest
workers, the ranks of a multi-process run) build once: the staleness
check and the build run under an exclusive `fcntl.flock` on a lock file
in the build directory, and the library is linked to a per-process name
that `os.replace` moves into place.

`-fmad=false` keeps every multiply and add separately rounded, as
PyTorch's elementwise kernels round them, so the kernels' f64 prune
arithmetic (K1) and MEC sum (K6) match the plain PyTorch versions on the
same card.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "floria_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libfloria_tpu_torch.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's -Xptxas -v report of the last build (registers, shared memory,
# spills per kernel); empty when the library was current.
build_log: str = ""


# Plain-integer launch counts by kernel name. A wrapper adds one
# (count_launch) where it launches its kernel and nowhere else; the
# shards of a block mesh launch from several threads at once.
LAUNCHES: "collections.Counter[str]" = collections.Counter()
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "floria_tpu_torch cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    lib_t = os.path.getmtime(lib_path)
    deps = _sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > lib_t for p in deps)


def build(force: bool = False, build_dir: str = BUILD_DIR) -> float:
    """Compile the kernels into `build_dir` if needed, under the
    directory's lock; returns the seconds spent (0.0 when the library was
    current). Raises on a failed build."""
    global build_log
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, os.path.basename(LIB_PATH))
    with open(os.path.join(build_dir, "libfloria_tpu_torch.lock"),
              "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not force and not _stale(lib_path):
            return 0.0
        nvcc = _nvcc()
        tag = f".tmp{os.getpid()}"
        t0 = time.time()
        compiles = []
        for src in _sources():
            obj = os.path.join(build_dir,
                               os.path.basename(src) + tag + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            compiles.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = [proc.communicate()[1] for _cmd, _obj, proc in compiles]
        for (cmd, _obj, proc), err in zip(compiles, logs):
            _raise_if_failed(proc.returncode, cmd, err)
        tmp = lib_path + tag
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(obj for _cmd, obj, _proc in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _raise_if_failed(proc.returncode, cmd, proc.stderr)
        os.replace(tmp, lib_path)
        for _cmd, obj, _proc in compiles:
            os.remove(obj)
        build_log = "".join(logs)
        return time.time() - t0


def _raise_if_failed(rc: int, cmd, stderr: str) -> None:
    if rc != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
            rc, " ".join(cmd), stderr[-8000:]))


def _bind(lib: ctypes.CDLL) -> None:
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.floria_beam_scan.restype = ctypes.c_int
    lib.floria_beam_scan.argtypes = (
        [P] * 11         # alleles .. gmix
        + [P]            # counts scratch
        + [P] * 7        # records, scores, live, assign
        + [I] * 9        # G R S P A W T1 dedup rec16
        + [D, P])        # cutoff, stream
    lib.floria_beam_cluster.restype = ctypes.c_int
    lib.floria_beam_cluster.argtypes = [I]
    lib.floria_upem_moves.restype = ctypes.c_int
    lib.floria_upem_moves.argtypes = (
        [P] * 6          # assign, diff, num_reads, active, proposal, scratch
        + [ctypes.c_longlong]  # scratch stride
        + [I] * 6        # G R P cap head smem
        + [P])           # stream
    lib.floria_upem_eval.restype = ctypes.c_int
    lib.floria_upem_eval.argtypes = (
        [I]              # mode
        + [P] * 10       # alleles weights assign epsilon best score diff
                         # active mec scratch
        + [P]            # layout (9 int64, host)
        + [I] * 8        # G R S P A Sc vec smem_max
        + [P])           # stream
    lib.floria_upem_climb.restype = ctypes.c_int
    lib.floria_upem_climb.argtypes = (
        [P] * 9          # alleles weights assign0 num_reads epsilon best
                         # diff mec scratch
        + [P]            # layout (9 int64, host)
        + [I] * 9        # G R S P A Sc vec cluster smem_max
        + [P])           # stream
    lib.floria_nw_best.restype = ctypes.c_int
    lib.floria_nw_best.argtypes = [P] * 7 + [ctypes.c_longlong, I, I, P]


def get_lib() -> ctypes.CDLL:
    """The bound kernel library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            _bind(lib)
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error (its
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
