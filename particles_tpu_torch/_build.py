"""Build the CUDA kernels of ``csrc/`` with nvcc, and the host helpers of
``native/src/`` with g++, and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>.so``, compiled for Hopper (``sm_90a``) at first use and
again whenever a source in ``csrc/`` is newer than the library; a host
C++ source ``<name>.cpp`` becomes ``_build/lib<name>.so`` the same way
(:func:`build_host`).  Each library is built into a per-process temporary
file, then ``os.replace``d into place, so that concurrent processes never
load a half-written library.

Nothing here runs at import: the CPU tests import every module of the
package on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "CXX", "CXX_FLAGS", "build",
           "build_host", "load", "build_seconds", "build_log"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the host compiler and its flags: no -march=native, and no contraction of
# a * b - c into a fused multiply-add, so that the helpers round as a plain
# float64 version of the same formula does
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

# seconds each nvcc or g++ run of this process took, and what it printed
# (nvcc: the -Xptxas -v register and shared-memory report)
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of particles_tpu_torch cannot be built")


def _paths(name):
    return SRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name):
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *SRC_DIR.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names=None):
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    missing or stale, all nvcc processes at once, and wait for all of them.
    Raises RuntimeError with nvcc's output if any compile fails."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for name in todo:
        src, lib = _paths(name)
        tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_host(src):
    """Compile the C++ source ``src`` (a plain C interface) with ``CXX``
    into ``BUILD_DIR/lib<stem>.so`` when the library is missing or older
    than the source, and return the library's path.  Raises RuntimeError
    with the compiler's output when it fails or cannot be run: nothing
    falls back to another implementation."""
    src = Path(src)
    lib = BUILD_DIR / f"lib{src.stem}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"{CXX} could not be run for {src.name}: "
                           f"{exc}") from exc
    build_seconds[src.stem] = time.perf_counter() - t0
    build_log[src.stem] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _libs[name] = lib
    return lib
