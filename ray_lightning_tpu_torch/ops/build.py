"""Build and load the hand-written CUDA kernels (`ops/csrc/*.cu`).

Each source compiles at first use, with ``nvcc`` for Hopper (``sm_90a``),
into a shared library with a plain C interface under
``ray_lightning_tpu_torch/ops/build/`` (git-ignored), and is loaded with
`ctypes`. Each library file name carries a digest of its source, the
shared headers and the flags, so an edited kernel is never served from a
stale build. A failed build raises with the compiler's output; nothing
falls back.

`build_all` starts one ``nvcc`` per source at once and waits for all, so
a fresh checkout pays the longest single build, not the sum.
`set_build_dir` moves the build directory (the persistent kernel cache
of `pipeline.compile_cache.enable_persistent_cache`); `build_seconds`
is the time this process spent building and loading libraries.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = san_lock("ops.build")
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: Dict[str, str] = {}
#: seconds this process spent in `load` building and loading libraries
_build_s = 0.0


def set_build_dir(path: str) -> None:
    """Build and load libraries under ``path`` from now on (libraries
    already loaded stay loaded)."""
    global BUILD
    BUILD = os.path.abspath(path)


def build_seconds() -> float:
    return _build_s


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source at first use")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[Tuple[str, str, str, subprocess.Popen]]:
    """Start compiling ``csrc/<name>.cu`` unless a current build
    exists; returns (name, temp path, final path, compiler) or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, tmp, out, proc


def _finish(name: str, tmp: str, out: str,
            proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_logs[name] = log


def build_all(names: Iterable[str]) -> None:
    """Compile every named source concurrently (one nvcc each)."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    errors = []
    for job in jobs:
        try:
            _finish(*job)
        except RuntimeError as e:  # collect, so no compiler is orphaned
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    global _build_s
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            # held through the build, deliberately: a second caller waits
            # for this nvcc rather than start its own of the same source
            # and load a library that is not yet in place
            t0 = time.perf_counter()
            build_all([name])  # rlt: disable=RLT705
            lib = ctypes.CDLL(_lib_path(name))  # rlt: disable=RLT705
            _libs[name] = lib
            _build_s += time.perf_counter() - t0
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point
    (a refused launch never runs, and a later synchronize would not
    report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
