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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: Dict[str, str] = {}


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
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point
    (a refused launch never runs, and a later synchronize would not
    report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
