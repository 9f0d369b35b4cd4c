"""The native (C++) batch assembler and its ctypes binding (twin of
`ray_lightning_tpu/native/`).

``batcher.cpp`` is the JAX package's source, copied: a pool of worker
threads gathers shuffled rows into contiguous batch buffers, a ring of
``depth`` slots ahead of the training loop, so batch assembly overlaps
the step. It is built on first use with the system toolchain (``g++ -O3
-shared``, a plain C ABI, no pybind11) into ``native/build/`` (git
ignored), through a temp file and an atomic rename: several processes
may race to build it, and none may load a half-written library.
Importing this module builds nothing.

Where the toolchain or the build fails, `load_library` returns None
(logged once) and `DataLoader(prefetch=True)` falls back to the numpy
path, which it records in ``DataLoader.native``.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "batcher.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "librlt_batcher.so")

_lib_lock = san_lock("native.lib")
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _compile() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        log.warning("native batcher build unavailable: %s", exc)
        return False
    if out.returncode != 0:
        log.warning("native batcher build failed:\n%s", out.stderr[-2000:])
        return False
    try:
        os.replace(tmp, _LIB_PATH)
    except OSError as exc:
        log.warning("native batcher install failed: %s", exc)
        return False
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """Build (when missing or older than the source) and load the
    library; None when either fails."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            stale = (not os.path.exists(_LIB_PATH)
                     or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))
            # Once-only init lock, deliberately held through the build:
            # the first caller compiles while every other caller WANTS
            # to wait rather than dlopen a torn .so.
            if stale and not _compile():  # rlt: disable=RLT705
                _lib_failed = True
                return None
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as exc:
            log.warning("native batcher load failed: %s", exc)
            _lib_failed = True
            return None
        lib.rlt_loader_create.restype = ctypes.c_void_p
        lib.rlt_loader_create.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rlt_loader_set_epoch.restype = None
        lib.rlt_loader_set_epoch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.rlt_loader_next.restype = ctypes.c_int
        lib.rlt_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64)]
        lib.rlt_loader_release.restype = None
        lib.rlt_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rlt_loader_destroy.restype = None
        lib.rlt_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


class SlotBatch(dict):
    """A zero-copy batch: numpy views into one of the batcher's slot
    buffers, valid until the next batch is pulled from the batcher. A
    consumer that keeps the batch past that copies it first
    (`pipeline.prefetch.DevicePrefetcher` does)."""

    zero_copy = True


class NativeBatcher:
    """Prefetching batch iterator over a flat dict of numpy arrays.

    Yields dicts of numpy arrays shaped like the numpy loader's batches.
    By default each batch is a copy, safe to hold. ``zero_copy=True``
    yields `SlotBatch` views into the slot buffer, which the batcher
    takes back when the next batch is requested."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 drop_last: bool = True, depth: int = 3,
                 n_threads: int = 2, zero_copy: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native batcher unavailable")
        self._lib = lib
        self.keys: List[str] = list(data.keys())
        self.arrays = [np.ascontiguousarray(data[k]) for k in self.keys]
        n = len(self.arrays[0])
        for a in self.arrays:
            if len(a) != n:
                raise ValueError("all arrays must share the leading dim")
        self.n_rows = n
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.zero_copy = zero_copy
        self._row_shapes = [a.shape[1:] for a in self.arrays]
        self._dtypes = [a.dtype for a in self.arrays]
        row_bytes = (ctypes.c_int64 * len(self.arrays))(
            *[a.strides[0] if a.ndim > 1 else a.itemsize
              for a in self.arrays])
        ptrs = (ctypes.c_void_p * len(self.arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        self._handle = lib.rlt_loader_create(
            len(self.arrays), ptrs, row_bytes, n, batch_size,
            int(drop_last), depth, n_threads)
        if not self._handle:
            raise RuntimeError("rlt_loader_create failed")
        self._pending_slot = -1
        #: batches this batcher has yielded
        self.batches = 0

    def set_epoch(self, order: np.ndarray) -> None:
        """Start an epoch over the rows ``order`` (shuffled, sharded)."""
        order = np.ascontiguousarray(order, dtype=np.int64)
        self._order = order  # alive while the workers read it
        self._lib.rlt_loader_set_epoch(
            self._handle,
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(order))
        self._pending_slot = -1

    def __iter__(self):
        out_ptrs = (ctypes.c_void_p * len(self.arrays))()
        out_rows = ctypes.c_int64()
        while True:
            if self._pending_slot >= 0:
                self._lib.rlt_loader_release(self._handle, self._pending_slot)
                self._pending_slot = -1
            slot = self._lib.rlt_loader_next(self._handle, out_ptrs,
                                             ctypes.byref(out_rows))
            if slot < 0:
                return
            rows = out_rows.value
            batch = SlotBatch() if self.zero_copy else {}
            for i, key in enumerate(self.keys):
                shape = (rows,) + self._row_shapes[i]
                count = int(np.prod(shape))
                buf = (ctypes.c_char * (count * self._dtypes[i].itemsize)
                       ).from_address(out_ptrs[i])
                arr = np.frombuffer(buf, dtype=self._dtypes[i],
                                    count=count).reshape(shape)
                batch[key] = arr if self.zero_copy else arr.copy()
            self.batches += 1
            if self.zero_copy:
                self._pending_slot = slot  # taken back on the next pull
            else:
                self._lib.rlt_loader_release(self._handle, slot)
            yield batch

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rlt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter-teardown best effort
            pass


__all__ = ["NativeBatcher", "SlotBatch", "available", "load_library"]
