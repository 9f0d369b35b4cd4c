"""Sharded checkpoint I/O on `torch.distributed.checkpoint` (twin of
`ray_lightning_tpu/checkpoint/io.py`, which stands on orbax).

Every process writes its own shards in place (DCP's collective save);
only paths and small metadata travel between processes. A small-model
convenience path (`load_checkpoint`) reads everything into one process
for `load_from_checkpoint`.

Layout of a checkpoint directory, as in the JAX package:
    <path>/state/     the DCP checkpoint of the state dict
                      ({"params", "opt_state", "step", ...})
    <path>/meta.json  {epoch, global_step, mid_epoch, epoch_batch,
                       module_class, hparams_pickle_hex, ckpt_digest,
                       ckpt_files, ckpt_digest_mode, provenance stamps}

Atomicity and verification: meta.json, the "checkpoint is complete"
marker, is written by rank 0 alone after every rank's share of the state
is on disk, to a temp file and `os.replace` (atomic on POSIX), with a
content digest of the state files. ``latest_checkpoint(dir)`` walks the
candidates newest first and returns the first that verifies: torn
directories (no meta), partial ones (file-set mismatch) and corrupt ones
(digest mismatch) are skipped.

``block=False`` stages the state on the host (`dcp.async_save`) and
writes it on a background thread; a finalizer thread publishes meta.json
once the write has committed. The background write's own collectives run
on a gloo group made for them, beside the training group (NCCL on the
card), as DCP requires of a write from another thread.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock

log = logging.getLogger(__name__)

_STATE_DIR = "state"
_META_FILE = "meta.json"

# meta.json writes deferred until their async state write commits;
# _META_LOCK guards the list.
_PENDING_META: List[Tuple[str, Dict[str, Any]]] = []
_META_LOCK = san_lock("checkpoint.io.meta")

#: paths whose meta/digest the finalizer thread is writing right now:
#: pruning must not remove such a directory mid-digest. Guarded by
#: _META_LOCK through the condition below.
_FINALIZING: set = set()
_FIN_CV = threading.Condition(_META_LOCK)

#: async-write failures recorded by the finalizer thread; surfaced (and
#: cleared) by the next wait_for_checkpoints()/save_checkpoint().
_ASYNC_ERRORS: List[BaseException] = []

#: (path, future) of each async save, drained by the finalizer thread
_FIN_QUEUE: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
_FIN_THREAD: Optional[threading.Thread] = None
#: futures of async writes not yet joined by the training thread
_INFLIGHT: List[Any] = []

_STATS = {"async_saves": 0, "blocking_saves": 0,
          "stall_s": 0.0, "last_stall_s": 0.0}

#: (default group, the gloo group async writes coordinate over): made
#: again when the default group is another (a strategy's one-rank group
#: is destroyed at its teardown)
_ASYNC_GROUP: List[Any] = [None, None]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def io_stats() -> Dict[str, float]:
    """Checkpoint-overlap counters: cumulative seconds the training
    thread spent blocked waiting for earlier checkpoint writes
    (``ckpt_stall_s``) and the save counts."""
    return {
        "ckpt_async_saves": float(_STATS["async_saves"]),
        "ckpt_blocking_saves": float(_STATS["blocking_saves"]),
        "ckpt_stall_s": _STATS["stall_s"],
        "ckpt_last_stall_s": _STATS["last_stall_s"],
    }


def _timed_drain() -> None:
    """Join any in-flight write on the calling (training) thread and
    account the wait as checkpoint stall."""
    t0 = time.perf_counter()
    while _INFLIGHT:
        fut = _INFLIGHT.pop(0)
        try:
            fut.result()
        except Exception as exc:  # noqa: BLE001 — recorded, surfaced below
            with _META_LOCK:
                _ASYNC_ERRORS.append(exc)
    stall = time.perf_counter() - t0
    _STATS["stall_s"] += stall
    _STATS["last_stall_s"] = stall


def _raise_recorded_errors() -> None:
    """Surface (once) any failure the background machinery recorded; a
    failed write drops ALL deferred metas — an un-finalized dir reads as
    no checkpoint."""
    with _META_LOCK:
        if not _ASYNC_ERRORS:
            return
        errors, _ASYNC_ERRORS[:] = list(_ASYNC_ERRORS), []
        _PENDING_META.clear()
    raise errors[0]


def _async_group():
    dist = _dist()
    if dist is None:
        return None
    default = dist.distributed_c10d._get_default_group()
    if _ASYNC_GROUP[0] is not default:
        _ASYNC_GROUP[:] = [default, dist.new_group(backend="gloo")]
    return _ASYNC_GROUP[1]


def save_checkpoint(path: str, state: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None,
                    block: bool = True) -> str:
    """Write ``state`` (a state dict of tensors, DTensors and small
    python values) and its metadata. Every process of the group calls
    this (DCP's save is collective); rank 0 writes meta.json.

    ``block=False`` stages the state on the host and writes it on a
    background thread, so the trainer may update the live tensors at
    once; a finalizer thread publishes meta.json and the digest when the
    write commits. Join with `wait_for_checkpoints()` before reading the
    files or exiting; time spent here waiting for a previous in-flight
    write is accounted as ``ckpt_stall_s`` (`io_stats`)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = dict(meta or {})
    hparams = meta.pop("hparams", None)
    if hparams is not None:
        meta["hparams_pickle_hex"] = pickle.dumps(hparams).hex()
    _timed_drain()
    _raise_recorded_errors()
    state_dir = os.path.join(path, _STATE_DIR)
    if block:
        _STATS["blocking_saves"] += 1
        dcp.save(state, storage_writer=dcp.FileSystemWriter(
            state_dir, thread_count=_write_threads(state)))
        # the drain above finished every earlier async write: publish
        # their deferred metas too, then ours once every rank is done
        _flush_pending_meta()
        dist = _dist()
        if dist is not None:
            dist.barrier()
        _write_meta(path, meta)
    else:
        _STATS["async_saves"] += 1
        fut = dcp.async_save(state, checkpoint_id=state_dir,
                             process_group=_async_group())
        _INFLIGHT.append(fut)
        with _META_LOCK:
            _PENDING_META.append((path, meta))
        _ensure_finalizer()
        _FIN_QUEUE.put((path, fut))
    return path


#: a blocking save writes a rank's items from one thread a GiB of its
#: share, at most eight (DCP's ``FileSystemWriter(thread_count=)``, each
#: thread its own file); a small state stays one file a rank. The restore
#: reads any such layout.
_BYTES_A_THREAD = 1 << 30
_MAX_WRITE_THREADS = 8


def _write_threads(state: Any) -> int:
    return max(1, min(_MAX_WRITE_THREADS,
                      _local_bytes(state) // _BYTES_A_THREAD))


def _local_bytes(tree: Any) -> int:
    """Bytes of this rank's tensors in ``tree`` (a DTensor's local shard)."""
    import torch

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        return local.numel() * local.element_size()
    return 0


#: digest policy (env RLT_CKPT_DIGEST): "full" hashes file contents (the
#: default, what corrupt-checkpoint detection needs); "size" hashes only
#: (relpath, size), cheap at 8B scale and still catches torn and
#: truncated files; "off" records no digest.
_DIGEST_MODE_ENV = "RLT_CKPT_DIGEST"


def _digest_mode() -> str:
    mode = os.environ.get(_DIGEST_MODE_ENV, "full")
    return mode if mode in ("full", "size", "off") else "full"


def compute_state_digest(path: str, mode: str = "full") -> Tuple[str, int]:
    """(sha256 hexdigest, file count) over the finalized state dir —
    deterministic: files visited in sorted relpath order."""
    state_dir = os.path.join(os.path.abspath(path), _STATE_DIR)
    h = hashlib.sha256()
    count = 0
    entries = []
    for root, dirs, files in os.walk(state_dir):
        dirs.sort()
        for f in sorted(files):
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, state_dir), full))
    for rel, full in sorted(entries):
        size = os.path.getsize(full)
        h.update(f"{rel}\x00{size}\x00".encode())
        count += 1
        if mode == "full":
            with open(full, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 20), b""):
                    h.update(chunk)
    return h.hexdigest(), count


def _write_meta(path: str, meta: Dict[str, Any]) -> None:
    if _rank() != 0:
        return
    meta = dict(meta)
    mode = _digest_mode()
    meta["ckpt_digest_mode"] = mode
    if mode != "off":
        try:
            digest, count = compute_state_digest(path, mode)
            meta["ckpt_digest"] = digest
            meta["ckpt_files"] = count
        except OSError:
            # a digest failure must not lose the checkpoint itself; the
            # meta lands digest-less and verification degrades to
            # presence checks
            log.exception("could not digest checkpoint %s", path)
    meta_path = os.path.join(path, _META_FILE)
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def sharding_provenance(mesh, params: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The topology-provenance stamps for a checkpoint's meta: which
    mesh wrote it and how each parameter was laid out.

      mesh_spec     {axis: size} of the writing mesh
      topology      n_devices / process_count / platform at write time
      param_specs   {name: per-dim spec} of every parameter: a DTensor's
                    shard placements as axis names (None = unsharded
                    dim); [] for a replicated tensor

    No mesh (`SingleDevice`) gives no stamps."""
    if mesh is None:
        return {}
    from ray_lightning_tpu_torch.parallel.mesh import (
        mesh_sizes,
        process_count,
    )

    out: Dict[str, Any] = {"mesh_spec": {
        str(k): int(v) for k, v in mesh_sizes(mesh).items()}}
    n_devices = 1
    for v in out["mesh_spec"].values():
        n_devices *= v
    out["topology"] = {"n_devices": n_devices,
                       "process_count": process_count(),
                       "platform": mesh.device_type}
    if params:
        names = list(mesh.mesh_dim_names)
        specs: Dict[str, Any] = {}
        for name, p in params.items():
            placements = getattr(p, "placements", None)
            if placements is None:
                specs[name] = []
                continue
            dims: List[Any] = [None] * p.dim()
            # the parameter's own mesh (under the tensor axis, FSDP2's
            # data-parallel dims with the tensor dim)
            own = getattr(getattr(p, "device_mesh", None),
                          "mesh_dim_names", None) or names
            for axis, pl in zip(own, placements):
                if pl.is_shard():
                    # two axes on one dimension (fsdp over tensor) list
                    # both, outer first
                    dims[pl.dim] = axis if dims[pl.dim] is None else [
                        dims[pl.dim], axis]
            specs[name] = dims
        out["param_specs"] = specs
    return out


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """Is this directory a complete, uncorrupted checkpoint?
    Returns (ok, reason) — reason names the first failed check."""
    path = os.path.abspath(path)
    state_dir = os.path.join(path, _STATE_DIR)
    if not os.path.isdir(state_dir):
        return False, "no state dir (write never started or was removed)"
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        return False, "no meta.json (write never finalized — torn)"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as exc:
        return False, f"unreadable meta.json ({exc})"
    recorded = meta.get("ckpt_digest")
    mode = meta.get("ckpt_digest_mode", "off")
    if recorded and mode in ("full", "size"):
        try:
            digest, count = compute_state_digest(path, mode)
        except OSError as exc:
            return False, f"state unreadable ({exc})"
        if count != meta.get("ckpt_files", count):
            return False, (f"partial state: {count} files on disk vs "
                           f"{meta.get('ckpt_files')} recorded")
        if digest != recorded:
            return False, "digest mismatch (corrupt or tampered state)"
    return _verify_provenance(meta)


def _verify_provenance(meta: Dict[str, Any]) -> Tuple[bool, str]:
    """Internal consistency of the provenance stamps (when present): the
    mesh axis product equals the recorded device count, and every axis a
    param spec names exists in the writing mesh."""
    mesh_spec = meta.get("mesh_spec")
    if mesh_spec is None:
        return True, "ok"
    if not isinstance(mesh_spec, dict) or not all(
            isinstance(v, int) and v >= 1 for v in mesh_spec.values()):
        return False, "malformed mesh_spec provenance (non-integer axes)"
    n = 1
    for v in mesh_spec.values():
        n *= v
    rec_n = (meta.get("topology") or {}).get("n_devices")
    if rec_n is not None and int(rec_n) != n:
        return False, (f"provenance mismatch: mesh_spec covers {n} "
                       f"devices but topology records {rec_n}")
    for p, spec in (meta.get("param_specs") or {}).items():
        for dim in spec or ():
            names = dim if isinstance(dim, list) else \
                [dim] if dim is not None else []
            for name in names:
                if name not in mesh_spec:
                    return False, (
                        f"provenance mismatch: param_specs[{p!r}] names "
                        f"mesh axis {name!r} absent from mesh_spec "
                        f"{sorted(mesh_spec)}")
    return True, "ok"


def latest_checkpoint(directory: str, *, good_only: bool = False,
                      max_step: Optional[int] = None) -> Optional[str]:
    """Newest VALID checkpoint under ``directory`` (the dir itself is
    also considered). Candidates ordered by recorded global_step (mtime
    breaks ties), newest first; torn/partial/corrupt candidates are
    skipped with a logged reason. None when nothing valid exists.

    ``good_only=True`` also requires ``meta["blessed"]`` not False;
    ``max_step`` caps the candidate's recorded global_step."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    candidates = []
    names = [directory] + [
        os.path.join(directory, d) for d in os.listdir(directory)
        if os.path.isdir(os.path.join(directory, d))
    ]
    for cand in names:
        if not os.path.isdir(os.path.join(cand, _STATE_DIR)):
            continue
        step = -1
        blessed = None
        try:
            with open(os.path.join(cand, _META_FILE)) as f:
                meta = json.load(f)
            step = int(meta.get("global_step", -1))
            blessed = meta.get("blessed")
        except (OSError, ValueError, TypeError):
            pass  # still a candidate; verify_checkpoint rejects it below
        if good_only and blessed is False:
            log.info("skipping unblessed checkpoint %s", cand)
            continue
        if max_step is not None and step > max_step:
            log.info("skipping checkpoint %s: step %d is past %d", cand,
                     step, max_step)
            continue
        try:
            mtime = os.path.getmtime(cand)
        except OSError:
            continue
        candidates.append((step, mtime, cand))
    for _, _, cand in sorted(candidates, reverse=True):
        ok, reason = verify_checkpoint(cand)
        if ok:
            return cand
        log.warning("skipping invalid checkpoint %s: %s", cand, reason)
    return None


def _ensure_finalizer() -> None:
    """Start the per-process finalizer thread (idempotent)."""
    global _FIN_THREAD
    if _FIN_THREAD is not None and _FIN_THREAD.is_alive():
        return
    _FIN_THREAD = threading.Thread(
        target=_finalizer_loop, name="rlt-ckpt-finalize", daemon=True)
    _FIN_THREAD.start()


def _finalizer_loop() -> None:
    """Publish each async save's meta/digest as soon as its write
    commits. Each entry carries its own future, so publishing its meta
    can never mark a later, still-streaming checkpoint complete."""
    while True:
        path, fut = _FIN_QUEUE.get()
        try:
            try:
                fut.result()
            except Exception as exc:  # noqa: BLE001 — surfaced on next join
                with _META_LOCK:
                    _ASYNC_ERRORS.append(exc)
                    # the torn write must never gain a completeness marker
                    _discard_locked(path)
                continue
            # take-and-mark atomically: once marked, a concurrent
            # discard_pending_meta (pruning about to remove this dir)
            # blocks until the meta/digest write is off the directory
            with _FIN_CV:
                meta = _take_pending_locked(path)
                if meta is not None:
                    _FINALIZING.add(path)
            if meta is not None:
                try:
                    _write_meta(path, meta)
                finally:
                    with _FIN_CV:
                        _FINALIZING.discard(path)
                        _FIN_CV.notify_all()
        except Exception as exc:  # noqa: BLE001 — never kill the thread
            with _META_LOCK:
                _ASYNC_ERRORS.append(exc)
        finally:
            _FIN_QUEUE.task_done()


def _take_pending_locked(path: str) -> Optional[Dict[str, Any]]:
    for i, (pp, meta) in enumerate(_PENDING_META):
        if pp == path:
            del _PENDING_META[i]
            return meta
    return None


def _flush_pending_meta() -> None:
    while True:
        with _META_LOCK:
            if not _PENDING_META:
                return
            path, meta = _PENDING_META.pop(0)
        _write_meta(path, meta)


def _discard_locked(path: str) -> bool:
    p = os.path.abspath(path)
    had = any(pp == p for pp, _ in _PENDING_META)
    if had:
        _PENDING_META[:] = [(pp, m) for pp, m in _PENDING_META if pp != p]
    return had


def pending_meta_for(path: str) -> Optional[Dict[str, Any]]:
    """The deferred meta of an in-flight async save of `path`, if one is
    queued (a copy; the real one is published by the finalizer)."""
    p = os.path.abspath(path)
    with _META_LOCK:
        for pp, meta in _PENDING_META:
            if pp == p:
                return dict(meta)
    return None


def discard_pending_meta(path: str) -> bool:
    """Forget the deferred meta for `path` (its checkpoint dir is being
    deleted). Returns True if an entry existed, i.e. the write may still
    be streaming into that dir, so callers should join in-flight writes
    before removing it. Blocks (bounded) while the finalizer is writing
    this path's meta."""
    p = os.path.abspath(path)
    with _FIN_CV:
        had = _discard_locked(p)
        deadline = time.monotonic() + 60.0
        while p in _FINALIZING:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                log.warning("finalizer still writing %s after 60s; "
                            "proceeding with deletion", p)
                break
            _FIN_CV.wait(timeout=min(remaining, 1.0))
        return had


def wait_for_checkpoints() -> None:
    """Join all in-flight async checkpoint writes (no-op when none) and
    their meta.json finalizations. If any write failed, NO deferred meta
    is written and the first recorded error propagates."""
    if _FIN_THREAD is not None and _FIN_THREAD.is_alive():
        _FIN_QUEUE.join()
    _timed_drain()
    _raise_recorded_errors()
    _flush_pending_meta()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Small-model convenience: read the whole state into this process's
    host memory (no collective; any process may call it alone). Returns
    the state dict merged with the parsed metadata (incl. "hparams")."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.default_planner import (
        _EmptyStateDictLoadPlanner,
    )
    from torch.distributed.checkpoint.state_dict_loader import (
        _load_state_dict,
    )

    path = os.path.abspath(path)
    state: Dict[str, Any] = {}
    # what torch's own dcp_to_torch_save does: an empty state dict that
    # the planner fills from the checkpoint's metadata, in this process
    _load_state_dict(state, storage_reader=dcp.FileSystemReader(
        os.path.join(path, _STATE_DIR)),
        planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    out = dict(state)
    out.update(_read_meta(path))
    return out


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Sharding-preserving restore: ``target`` is a state dict whose
    tensors and DTensors give the layout to restore into (each process
    reads only its shards; collective across the group). Loaded in
    place; returns ``target``."""
    import torch.distributed.checkpoint as dcp

    dcp.load(target,
             checkpoint_id=os.path.join(os.path.abspath(path), _STATE_DIR))
    return target


def read_meta(path: str) -> Dict[str, Any]:
    return _read_meta(os.path.abspath(path))


def _read_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        meta = json.load(f)
    hex_ = meta.pop("hparams_pickle_hex", None)
    if hex_:
        meta["hparams"] = pickle.loads(bytes.fromhex(hex_))
    return meta
