"""Serving front end: request streams multiplexed over replica groups
(twin of `ray_lightning_tpu/serve/driver.py`).

A **replica** is one model copy behind one `DecodeEngine` + `Scheduler`
pair. Two backends share one driver surface:

  * ``backend="inline"`` — engines in this process over one shared
    `models.llama.Llama`, ticked round-robin (deterministic);
  * ``backend="process"`` — each replica is a `runtime.WorkerGroup` of
    one worker process, streaming tokens back over the group's side
    channel. A death is classified by `resilience.policy.
    classify_failure` and, within the restart budget, the driver
    **respawns** the replica: the worker reloads the weights from the
    params file, loads the kernel libraries from the persistent build
    directory (`pipeline.compile_cache`: a respawn runs no ``nvcc``),
    warms the step, announces itself live, and REPLAYS the requests the
    dead replica had not finished. Per-request seeds make a decoded
    stream a pure function of its request, so the replayed streams are
    bitwise what the dead replica would have produced, and the
    survivors never notice.

Replicas run on the CUDA card unless ``device="cpu"`` is asked for; a
process replica sees the driver's card (``CUDA_VISIBLE_DEVICES``) and
raises where it finds none.

Telemetry: each replica owns a `telemetry.TelemetryRecorder` and records
the serving spans (queue_wait / prefill / decode, `spans.SERVE_PHASES`)
per COMPLETED request, with the TTFT/TPOT meta the ``report`` CLI reads.
PREEMPTED requests get REPLAYED-tagged spans for their discarded prefix
and whatever is in flight at drain time INFLIGHT-tagged spans. Each
replica also owns a `MetricsRegistry` and a `FlightRecorder`; the driver
merges the per-replica streams into ``serving.json``, finalizes a dead
replica's flight ring into ``<run_dir>/flight.json`` stamped with its
classification, and exposes `load_signal(run_dir)`. The files are the
JAX package's formats: either package's ``report`` reads either's run.

The live session (`start` / `submit` / `tick` / `add_replica` /
`remove_replica(graceful=)` / `stop`) is the autoscale actuation seam;
process replicas there are fed over the request channel
(`serve/channel.py`).

Differences from the JAX driver, by design:

  * the params file stores torch leaves whose dtype numpy lacks (bf16)
    as same-width integers, their dtypes recorded in the file, so the
    exact bits round-trip without JAX or ``ml_dtypes``; a JAX-written
    file (a flax tree) is read through `models.llama.params_from_jax`;
  * there is no compiled step to count: the stats carry
    ``compile_count: -1``, and request churn is pinned instead by
    `ops.build.build_seconds` (no kernel built) and the kernels' launch
    counters;
  * a tensor-parallel replica (``tp > 1``, process replicas of a live
    session) is a `WorkerGroup` of ``tp`` ranks joined in a gloo group
    on the driver's card (the ranks share it); rank 0 leads and
    journals each iteration, the followers replay the journal;
  * a speculative replica's draft (``draft_model_cfg`` with
    ``ServeDriver(draft_params=)``) is a `Llama` the inline replicas
    share, as they share the target.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig
from ray_lightning_tpu_torch.serve.scheduler import (
    Completion,
    Request,
    Scheduler,
    SLOConfig,
)
from ray_lightning_tpu_torch.utils.locks import san_lock

log = logging.getLogger(__name__)

#: spans are flushed every this many completions (and at shutdown)
FLUSH_EVERY_N_COMPLETIONS = 16

#: stats value standing in for the JAX engine's compile count: an eager
#: engine compiles no step program (the JAX serving gate accepts -1)
NO_COMPILE_COUNT = -1


# ---- params serialization (the replica weight-reload path) ----------------

#: the entry of a port-written params file that records each leaf's
#: torch dtype
_DTYPES_KEY = "__torch_dtypes__"
#: the integer a leaf is stored as when numpy has no dtype for it (bf16,
#: float8), by element size
_BITS_AS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _named_leaves(params, prefix: str = ""):
    """(name, leaf) pairs: a module's state dict, or a nested mapping
    flattened with ``/`` (the JAX file's keys)."""
    import torch

    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    for key, leaf in params.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            yield from _named_leaves(leaf, f"{name}/")
        else:
            yield name, leaf


def save_params_npz(params, path: str) -> None:
    """Write the weights a (re)spawned replica loads: ``params`` is a
    state dict (or a module, whose state dict is written), or a nested
    mapping of numpy leaves. Exact round-trip: each tensor at its stored
    dtype; one numpy lacks (bf16) is written as the same bits in an
    integer of its width, and the file records every tensor's dtype."""
    import torch

    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for name, leaf in _named_leaves(params):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            dtypes[name] = str(t.dtype).removeprefix("torch.")
            try:
                flat[name] = t.numpy()
            except TypeError:
                flat[name] = t.view(
                    getattr(torch, _BITS_AS[t.element_size()])).numpy()
        else:
            flat[name] = np.asarray(leaf)
    if dtypes:
        flat[_DTYPES_KEY] = np.array(json.dumps(dtypes))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str):
    """Read a `save_params_npz` file: a port-written one gives back its
    state dict of tensors, bit for bit; a JAX-written one its nested
    dict of numpy leaves (`models.llama.params_from_jax` reads that)."""
    import torch

    out: Dict[str, Any] = {}
    with np.load(path) as data:
        dtypes = (json.loads(str(data[_DTYPES_KEY]))
                  if _DTYPES_KEY in data.files else {})
        for key in data.files:
            if key == _DTYPES_KEY:
                continue
            leaf = data[key]
            if key in dtypes:
                leaf = torch.from_numpy(leaf).view(getattr(torch,
                                                           dtypes[key]))
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
    return out


def _state_dict(params, model_cfg) -> Dict[str, Any]:
    """The port's state dict from a params file path, a state dict or a
    JAX-layout tree (``tok_embed`` a mapping)."""
    from ray_lightning_tpu_torch.models.llama import params_from_jax

    if isinstance(params, (str, os.PathLike)):
        params = load_params_npz(os.fspath(params))
    if isinstance(params.get("tok_embed"), Mapping):
        return params_from_jax(params, model_cfg)
    return params


def _build_model(model_cfg, params, device):
    """A serving `Llama` on ``device`` holding ``params``; a `Llama`
    passed in is served as it is (inline replicas share it)."""
    from ray_lightning_tpu_torch.models.llama import Llama

    if isinstance(params, Llama):
        if params.device.type != device.type:
            raise ValueError(f"the model lives on {params.device}, the "
                             f"replicas were asked for {device}")
        return params
    model = Llama(model_cfg, device=device)
    model.load_state_dict(_state_dict(params, model_cfg))
    return model


# ---- configuration --------------------------------------------------------

@dataclasses.dataclass
class ReplicaGroupConfig:
    """How the driver runs its replicas."""

    n_replicas: int = 1
    backend: str = "inline"              # "inline" | "process"
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    reserve: str = "worst_case"
    #: run dir: telemetry spans + serving.json summary land here
    run_dir: Optional[str] = None
    #: persistent kernel build directory (`pipeline.compile_cache`):
    #: every replica worker builds and loads its kernel libraries there,
    #: so a respawned one runs no nvcc
    compile_cache_dir: Optional[str] = None
    max_restarts: int = 2
    #: extra environment for process replicas
    env: Optional[Dict[str, str]] = None
    start_timeout: float = 180.0
    #: tensor-parallel degree of each replica: tp > 1 makes every
    #: PROCESS replica of a live session a `WorkerGroup` of tp ranks in
    #: one gloo group on the driver's card; the pool shards over KV
    #: heads, every rank runs the scheduler in lockstep off the request
    #: channel, rank 0 owns the replica's results and telemetry
    tp: int = 1
    #: where the replicas run: None = the CUDA card, "cpu" = the CPU
    #: (the JAX ``platform`` / ``cpu_devices_per_rank``)
    device: Optional[str] = None
    #: the engines' lanes (`DecodeEngine(use_kernels=)`, the JAX
    #: engine's ``use_pallas``): None follows the dispatch policy (the
    #: kernel lanes on the card), True the kernel lanes (on the CPU
    #: their wrappers run the plain versions), False the reference lanes
    use_kernels: Optional[bool] = None
    #: live metrics + flight recorder — armed only when ``run_dir`` is
    #: set; False turns both off even then
    metrics: bool = True
    #: metrics JSONL flush cadence in engine ticks
    metrics_flush_every_n_ticks: int = 32
    #: flight-recorder ring length (recent ticks + scheduler events)
    flight_ring: int = 256
    #: flight ring persist cadence in recorded events
    flight_persist_every: int = 16
    #: draft model config (`models.llama.LlamaConfig`) for speculative
    #: decoding: arms together with ``engine.draft``; inline replicas
    #: only (a process replica reloads ONE params file, which carries
    #: no draft weights)
    draft_model_cfg: Optional[Any] = None
    #: traffic classes + graceful-overload policy (scheduler.SLOConfig);
    #: None keeps the single-class scheduler
    slo: Optional[SLOConfig] = None

    def __post_init__(self):
        if self.backend not in ("inline", "process"):
            raise ValueError(f"backend={self.backend!r}")
        if self.backend == "process" and (
                self.engine.draft is not None
                or self.draft_model_cfg is not None):
            raise ValueError(
                "speculative decoding is inline-only: a process "
                "replica (re)spawns from the params .npz, which "
                "carries no draft weights")
        if (self.engine.draft is None) != (self.draft_model_cfg is None):
            raise ValueError(
                "engine.draft and draft_model_cfg arm together — set "
                "both (speculative) or neither")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.tp < 1:
            raise ValueError("tp must be >= 1")
        if self.tp > 1 and self.backend != "process":
            raise ValueError(
                "tp > 1 needs backend='process': a sharded replica is "
                "a WorkerGroup of tp rank processes")


@dataclasses.dataclass
class ServeResult:
    #: rid -> emitted token ids
    outputs: Dict[str, List[int]]
    #: rid -> completion metadata (ttft_s, tpot_s, queue_wait_s, ...)
    meta: Dict[str, dict]
    #: replica_id -> restarts performed
    restarts: Dict[int, int]
    #: aggregate serving stats (decode_tokens_per_s, slot_occupancy, ...)
    stats: dict


# ---- per-request telemetry -------------------------------------------------

def _completion_meta(comp: Completion) -> dict:
    return {"finish_reason": comp.finish_reason,
            "queue_wait_s": comp.queue_wait_s,
            "ttft_s": comp.ttft_s, "tpot_s": comp.tpot_s,
            "decode_s": comp.decode_s, "preempted": comp.preempted,
            "n_tokens": len(comp.tokens), "priority": comp.priority}


def _record_completion(recorder, comp: Completion, replica: int) -> None:
    """Emit the request's serving spans from the scheduler's measured
    host times, back-dated: the spans were over when it completed."""
    from ray_lightning_tpu_torch.telemetry.spans import (
        PH_DECODE,
        PH_PREFILL,
        PH_QUEUE_WAIT,
    )

    decode_start = time.perf_counter() - comp.decode_s   # first token
    prefill_start = decode_start - comp.ttft_s           # admission
    meta = {"rid": comp.rid, "replica": replica,
            "tokens": len(comp.tokens), "ttft_s": round(comp.ttft_s, 6),
            "tpot_s": round(comp.tpot_s, 6),
            "finish": comp.finish_reason, "preempted": comp.preempted}
    recorder.record(PH_QUEUE_WAIT, prefill_start - comp.queue_wait_s,
                    comp.queue_wait_s, meta={"rid": comp.rid})
    recorder.record(PH_PREFILL, prefill_start, comp.ttft_s,
                    meta={"rid": comp.rid})
    recorder.record(PH_DECODE, decode_start, comp.decode_s, meta=meta)


def _record_partial_spans(recorder, info: dict, meta: dict) -> None:
    """Back-dated spans for a request's PARTIAL progress
    (`Scheduler._partial_timing`). ``meta`` carries the tag (``replayed``
    / ``inflight``) and no ``ttft_s``, so the report never counts these
    as completed requests."""
    from ray_lightning_tpu_torch.telemetry.spans import (
        PH_DECODE,
        PH_PREFILL,
        PH_QUEUE_WAIT,
    )

    now = time.perf_counter()
    decode_start = now - info["decode_s"]
    prefill_start = decode_start - info["prefill_s"]
    recorder.record(PH_QUEUE_WAIT, prefill_start - info["queue_wait_s"],
                    info["queue_wait_s"], meta=meta)
    if info["prefill_s"] > 0:
        recorder.record(PH_PREFILL, prefill_start, info["prefill_s"],
                        meta=meta)
    if info["decode_s"] > 0:
        recorder.record(PH_DECODE, decode_start, info["decode_s"],
                        meta=meta)


def _record_preemption(recorder, detail: dict, replica: int) -> None:
    """Spans for the DISCARDED prefix of a just-preempted request, tagged
    ``replayed``."""
    _record_partial_spans(recorder, detail, {
        "rid": detail["rid"], "replica": replica, "replayed": True,
        "emitted": detail["emitted"], "preempted": detail["preempted"]})


def _record_drain(recorder, sched, replica: int) -> None:
    """Spans for requests STILL IN FLIGHT when serving stops (death,
    shutdown), tagged ``inflight``."""
    for info in sched.inflight_snapshot():
        _record_partial_spans(recorder, info, {
            "rid": info["rid"], "replica": replica, "inflight": True,
            "state": info["state"], "emitted": info["emitted"],
            "preempted": info["preempted"]})


def _make_recorder(run_dir: Optional[str], replica: int):
    from ray_lightning_tpu_torch.telemetry.spans import (
        NULL_RECORDER,
        TelemetryRecorder,
    )

    if run_dir is None:
        return NULL_RECORDER
    return TelemetryRecorder(os.path.join(run_dir, "telemetry"),
                             rank=replica)


def _make_metrics(run_dir: Optional[str], replica: int, mc: dict):
    from ray_lightning_tpu_torch.telemetry.metrics import (
        NULL_METRICS,
        MetricsRegistry,
    )

    if run_dir is None or not mc.get("enabled", True):
        return NULL_METRICS
    return MetricsRegistry(os.path.join(run_dir, "telemetry"),
                           replica=replica,
                           flush_every_n_ticks=mc.get("flush_every", 32))


def _make_flight(run_dir: Optional[str], replica: int, mc: dict):
    from ray_lightning_tpu_torch.telemetry.metrics import (
        NULL_FLIGHT,
        FlightRecorder,
        flight_path,
    )

    if run_dir is None or not mc.get("enabled", True):
        return NULL_FLIGHT
    return FlightRecorder(
        flight_path(os.path.join(run_dir, "telemetry"), replica),
        replica=replica, maxlen=mc.get("flight_ring", 256),
        persist_every=mc.get("flight_persist_every", 16))


def _kill_once(marker: Optional[str], kill_after: int, emitted: int,
               recorder, sched, replica: int) -> None:
    """The injected mid-stream death: SIGKILL this process once the
    replica has emitted ``kill_after`` tokens, once across respawns (the
    marker file outlives the process). Drain-time spans and a final
    metrics/flight flush land first, so the drill leaves an exact
    postmortem (a real SIGKILL leaves the last cadence-persisted ring)."""
    if not (kill_after and emitted >= kill_after and marker
            and not os.path.exists(marker)):
        return
    with open(marker, "w") as f:
        f.write(str(emitted))
    _record_drain(recorder, sched, replica)
    recorder.flush()
    sched.metrics.flush()
    sched.flight.persist()
    os.kill(os.getpid(), signal.SIGKILL)


# ---- one replica's serving loop (runs in-process or in the worker) --------

def _serve_loop(engine: DecodeEngine, reserve: str,
                requests: Sequence[Request], replica: int,
                run_dir: Optional[str] = None,
                on_token=None, on_completion=None, on_preempt=None,
                fault: Optional[dict] = None,
                fault_dir: Optional[str] = None,
                metrics_cfg: Optional[dict] = None,
                slo: Optional[SLOConfig] = None, on_shed=None):
    """Drain ``requests`` through one replica. ``on_token(rid, tok)``
    streams tokens as they are emitted; ``on_completion(comp)`` fires at
    retirement. ``fault={"kill_after_tokens": n}`` SIGKILLs this process
    after the n-th emitted token, once per ``fault_dir`` marker."""
    mc = metrics_cfg or {}
    recorder = _make_recorder(run_dir, replica)
    metrics = _make_metrics(run_dir, replica, mc)
    flight = _make_flight(run_dir, replica, mc)
    engine.metrics = metrics
    sched = Scheduler(engine, reserve=reserve, metrics=metrics,
                      flight=flight, slo=slo)

    def drain_sheds():
        # typed shed records are terminal statuses, never silence
        for rec in sched.take_sheds():
            if on_shed is not None:
                on_shed(rec)

    for req in requests:
        sched.submit(req)
    drain_sheds()  # enqueue-time budget sheds fire before any tick
    emitted_total = 0
    kill_after = int((fault or {}).get("kill_after_tokens", 0))
    marker = (os.path.join(fault_dir, f"replica{replica}.killed")
              if fault_dir else None)
    done: List[Completion] = []
    while sched.busy():
        completions = sched.tick()
        for detail in sched.last_preemption_details:
            # the replay regenerates the stream bitwise: a consumer
            # keeping the prefix would duplicate tokens
            _record_preemption(recorder, detail, replica)
            if on_preempt is not None:
                on_preempt(detail["rid"])
        for rid, tok in sched.last_emissions:
            emitted_total += 1
            if on_token is not None:
                on_token(rid, tok)
        for comp in completions:
            done.append(comp)
            _record_completion(recorder, comp, replica)
            if on_completion is not None:
                on_completion(comp)
            if len(done) % FLUSH_EVERY_N_COMPLETIONS == 0:
                recorder.flush()
        drain_sheds()
        _kill_once(marker, kill_after, emitted_total, recorder, sched,
                   replica)
    _record_drain(recorder, sched, replica)
    recorder.flush()
    recorder.close()
    metrics.close()
    flight.close()
    return done, sched


# ---- process-replica worker mains ------------------------------------------

def _join_tensor_group(rank: int, tp: int, rendezvous):
    """One rank of a tensor-parallel replica joins its group: gloo, on
    the CPU and on the card alike (the ranks of a replica share the
    driver's card, where NCCL refuses two ranks). Returns the rank's
    `parallel.tensor.TensorParallel`."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.parallel.tensor import TensorParallel
    from ray_lightning_tpu_torch.runtime.launch import join_group

    join_group("gloo", rank, tp, rendezvous)
    return TensorParallel(dist.group.WORLD, tp, rank)


def _start_replica(model_cfg, params_path: str, engine_cfg: EngineConfig,
                   compile_cache_dir: Optional[str], device: str,
                   use_kernels: Optional[bool], mesh=None):
    """In a replica worker: load the weights, warm the step, and time
    each part. Returns ``(engine, timing)``; ``timing`` is the "live"
    item's payload: ``import_s`` (process start to here), ``load_s``
    (model build + params file), ``warmup_s`` (the first tick) and
    ``build_s`` (the kernel libraries built or loaded in it). ``mesh``
    (a rank's tensor group) makes the engine that rank of a
    tensor-parallel replica."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.runtime import session
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    sess = session.get_session()
    started = sess.started_at if sess is not None else None
    import_s = time.time() - started if started else 0.0
    if compile_cache_dir:
        from ray_lightning_tpu_torch.pipeline.compile_cache import (
            enable_persistent_cache,
        )

        enable_persistent_cache(compile_cache_dir)
    # raises where this process sees no card: a replica never falls back
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model = _build_model(model_cfg, params_path, dev)
    load_s = time.perf_counter() - t0
    built0 = build.build_seconds()
    t0 = time.perf_counter()
    engine = DecodeEngine(model, engine_cfg, use_kernels=use_kernels,
                          device=dev, mesh=mesh)
    engine.warmup()
    warm_s = time.perf_counter() - t0
    return engine, {"warmup_s": round(warm_s, 4),
                    "load_s": round(load_s, 4),
                    "import_s": round(import_s, 4),
                    "build_s": round(build.build_seconds() - built0, 4)}


def _replica_worker_main(model_cfg, params_path: str,
                         engine_cfg: EngineConfig, reserve: str,
                         request_dicts: List[dict], replica: int,
                         run_dir: Optional[str],
                         compile_cache_dir: Optional[str],
                         fault: Optional[dict],
                         fault_dir: Optional[str],
                         metrics_cfg: Optional[dict],
                         slo_kw: Optional[dict],
                         device: str,
                         use_kernels: Optional[bool]) -> dict:
    """Runs inside the WorkerGroup worker process: rebuild the model,
    reload the weights, warm the step, announce live, then serve —
    streaming every token over the side channel so the driver holds
    partial streams when this process dies mid-request."""
    from ray_lightning_tpu_torch.runtime import session

    engine, timing = _start_replica(model_cfg, params_path, engine_cfg,
                                    compile_cache_dir, device, use_kernels)
    session.put_queue(("live", replica, timing))
    requests = [Request(**d) for d in request_dicts]

    def on_token(rid, tok):
        session.put_queue(("tok", replica, rid, tok))

    def on_preempt(rid):
        session.put_queue(("preempt", replica, rid))

    def on_completion(comp):
        session.put_queue(("done", replica, comp.rid,
                           _completion_meta(comp)))

    def on_shed(rec):
        session.put_queue(("shed", replica, rec["rid"], rec))

    done, sched = _serve_loop(engine, reserve, requests, replica,
                              run_dir=run_dir, on_token=on_token,
                              on_completion=on_completion,
                              on_preempt=on_preempt, fault=fault,
                              fault_dir=fault_dir,
                              metrics_cfg=metrics_cfg,
                              slo=SLOConfig.from_wire(slo_kw),
                              on_shed=on_shed)
    return {"replica": replica, "completed": len(done),
            "steps": engine.steps, "warmup_s": timing["warmup_s"],
            "compile_count": NO_COMPILE_COUNT,
            "occupancy": sched.slot_occupancy}


def _replica_session_main(model_cfg, params_path: str,
                          engine_cfg: EngineConfig, reserve: str,
                          replica: int, run_dir: Optional[str],
                          session_dir: str,
                          compile_cache_dir: Optional[str],
                          fault: Optional[dict],
                          fault_dir: Optional[str],
                          metrics_cfg: Optional[dict],
                          channel_epoch: int,
                          slo_kw: Optional[dict],
                          device: str,
                          use_kernels: Optional[bool],
                          tp: int = 1, rendezvous=None,
                          rank: int = 0) -> dict:
    """One rank of a live-session replica (`serve/channel.py`): work
    arrives over the replica's command log, and results go back over the
    side channel BATCHED, one item per loop iteration (tokens,
    preemptions, completions, the command ack and evictions together).

    With ``tp > 1`` the replica is a group of ``tp`` ranks, each running
    the whole host-side scheduler in lockstep over its shard of the
    model. Rank 0 LEADS: it alone reads the commands at its own pace,
    journals each iteration to the cursor log (before the tick, whose
    collectives wait for the followers), emits the results and owns the
    replica's telemetry. The followers replay the journal; the
    scheduler's determinism makes their state the leader's, so every
    rank enters each tick with the same inputs."""
    from ray_lightning_tpu_torch.runtime import session
    from ray_lightning_tpu_torch.serve.channel import (
        ChannelReader,
        CursorReader,
        CursorWriter,
        request_from_wire,
        request_to_wire,
    )

    mesh = _join_tensor_group(rank, tp, rendezvous) if tp > 1 else None
    engine, timing = _start_replica(model_cfg, params_path, engine_cfg,
                                    compile_cache_dir, device, use_kernels,
                                    mesh=mesh)
    leader = rank == 0
    mc = metrics_cfg or {}
    tdir = run_dir if leader else None
    recorder = _make_recorder(tdir, replica)
    metrics = _make_metrics(tdir, replica, mc)
    flight = _make_flight(tdir, replica, mc)
    engine.metrics = metrics
    sched = Scheduler(engine, reserve=reserve, metrics=metrics,
                      flight=flight, slo=SLOConfig.from_wire(slo_kw))
    reader = ChannelReader(session_dir, replica, channel_epoch)
    cursor_w = (CursorWriter(session_dir, replica, channel_epoch)
                if leader and tp > 1 else None)
    cursor_r = (CursorReader(session_dir, replica, channel_epoch)
                if not leader else None)
    if leader:
        session.put_queue(("live", replica, timing))
    kill_after = int((fault or {}).get("kill_after_tokens", 0))
    marker = (os.path.join(fault_dir, f"replica{replica}.killed")
              if fault_dir else None)
    emitted_total = 0
    state = {"draining": False, "paused": False, "stop": None}

    def apply(cmd) -> List:
        """Apply one command; returns the requests it evicts (the same
        on every rank; only the leader wires them back)."""
        op = cmd["op"]
        ev: List = []
        if op == "submit":
            sched.enqueue(request_from_wire(cmd["req"]),
                          int(cmd.get("preempts", 0)))
        elif op == "drain":
            state["draining"] = True
            sched.begin_drain()
            ev = sched.evict_queued()
        elif op == "stop":
            mode = cmd.get("mode", "finish")
            state["stop"] = mode
            if mode == "hard":
                sched.begin_drain()
                ev = sched.evict_queued() + sched.evict_slotted()
        elif op == "pause":
            state["paused"] = True
        elif op == "resume":
            state["paused"] = False
        return ev

    def run_tick():
        completions = sched.tick()
        toks = [[rid, int(tok)] for rid, tok in sched.last_emissions]
        preempts = list(sched.last_preemptions)
        for detail in sched.last_preemption_details:
            _record_preemption(recorder, detail, replica)
        dones = []
        for comp in completions:
            _record_completion(recorder, comp, replica)
            dones.append([comp.rid, _completion_meta(comp)])
            if len(sched.completions) % FLUSH_EVERY_N_COMPLETIONS == 0:
                recorder.flush()
        # mid-drain growth-stall preemptions land back in the closed
        # queue: evict them for the survivors
        ev = sched.evict_queued() if state["draining"] else []
        return toks, preempts, dones, ev

    while leader:
        cmds = reader.poll()
        evicted: List = []
        starts: List = []
        for cmd in cmds:
            if cmd["op"] == "submit":
                # the driver resets the stream's output on this: a no-op
                # for fresh work, the stale-prefix drop for an epoch
                # replay after a respawn
                starts.append(cmd["req"]["rid"])
            evicted.extend(apply(cmd))
        sheds = sched.take_sheds()
        if state["stop"] in ("hard", "abort"):
            if cursor_w is not None and cmds:
                cursor_w.advance(reader.last_seq, False)
            payload: Dict[str, Any] = {"ack": reader.last_seq}
            if evicted:
                payload["evicted"] = [[request_to_wire(q), p]
                                      for q, p in evicted]
            if sheds:
                payload["sheds"] = sheds
            if cmds or evicted or sheds:
                session.put_queue(("batch", replica, payload))
            break
        do_tick = not state["paused"] and sched.busy()
        if cursor_w is not None and (cmds or do_tick):
            # journal BEFORE the tick: its collectives wait until the
            # followers join, and they join by reading this record
            cursor_w.advance(reader.last_seq, do_tick)
        toks, preempts, dones, ev2 = (run_tick() if do_tick
                                      else ([], [], [], []))
        evicted.extend(ev2)
        sheds.extend(sched.take_sheds())
        emitted_total += len(toks)
        if cmds or toks or preempts or dones or evicted or sheds:
            payload = {}
            if starts:
                payload["starts"] = starts
            if toks:
                payload["toks"] = toks
            if preempts:
                payload["preempts"] = preempts
            if dones:
                payload["dones"] = dones
            if evicted:
                payload["evicted"] = [[request_to_wire(q), p]
                                      for q, p in evicted]
            if sheds:
                payload["sheds"] = sheds
            if cmds:
                payload["ack"] = reader.last_seq
            session.put_queue(("batch", replica, payload))
        _kill_once(marker, kill_after, emitted_total, recorder, sched,
                   replica)
        if ((state["draining"] or state["stop"] == "finish")
                and not sched.busy()):
            break
        if not do_tick and not cmds:
            time.sleep(0.004)
    if cursor_w is not None:
        cursor_w.end()
        cursor_w.close()
    while not leader:
        # a follower replays the leader's journal: no policy, no
        # emissions, only the lockstep state and the tick's collectives
        rec = cursor_r.next()
        if rec is None:
            time.sleep(0.004)
            continue
        if rec.get("end"):
            break
        target = int(rec["seq"])
        cmds = reader.take_upto(target)
        while reader.last_seq < target:
            # the command file is written before the cursor record, but
            # a reader can still lag: wait it out
            time.sleep(0.002)
            cmds.extend(reader.take_upto(target))
        for cmd in cmds:
            apply(cmd)
        if rec.get("tick"):
            run_tick()
        # the leader owns the shed records; a follower drops its copies
        sched.take_sheds()
    _record_drain(recorder, sched, replica)
    recorder.flush()
    recorder.close()
    if metrics.enabled:
        # stamp the stream retired so the load signal stops pooling this
        # replica's stale window into live pressure
        metrics.gauge("retired", 1)
        metrics.tick_end()
    metrics.close()
    flight.close()
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    from ray_lightning_tpu_torch.ops.kernels import launch_counts

    return {"replica": replica, "rank": rank,
            "completed": len(sched.completions),
            "steps": engine.steps, "warmup_s": timing["warmup_s"],
            "compile_count": NO_COMPILE_COUNT,
            "occupancy": sched.slot_occupancy,
            "launches": launch_counts(), "live_bytes": engine.live_bytes()}


def _card_env(device) -> Dict[str, str]:
    """The environment that shows a process replica the driver's card
    (``CUDA_VISIBLE_DEVICES`` naming it alone); nothing for the CPU."""
    import torch

    if device.type != "cuda":
        return {}
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v.strip() for v in visible.split(",")] if visible
           else [str(i) for i in range(torch.cuda.device_count())])
    return {"CUDA_VISIBLE_DEVICES": ids[idx]}


# ---- the driver ------------------------------------------------------------

class _Replica:
    """One inline replica in a live session: engine + scheduler +
    recorder and a three-state lifecycle (live -> draining -> stopped)."""

    __slots__ = ("id", "engine", "sched", "recorder", "state",
                 "spawned_at", "warm_s")

    def __init__(self, rid: int, engine, sched, recorder, warm_s: float):
        self.id = rid
        self.engine = engine
        self.sched = sched
        self.recorder = recorder
        self.state = "live"
        self.spawned_at = time.perf_counter()
        self.warm_s = warm_s


class _ProcessReplica:
    """One PROCESS replica in a live session: a spawn/respawn thread
    around a `runtime.WorkerGroup`, the `serve.channel.ChannelWriter`
    its commands flow in over, and the driver's assignment ledger the
    respawn replay is computed from."""

    __slots__ = ("id", "state", "spawned_at", "warm_s", "writer",
                 "assigned", "live_evt", "thread", "attempts",
                 "restarts", "error", "acked", "warmups", "ranks")

    def __init__(self, rid: int, writer):
        self.id = rid
        self.writer = writer
        self.state = "live"
        self.spawned_at = time.perf_counter()
        self.warm_s = None
        #: requests this replica owns, in submission order, minus
        #: completions and evictions: the respawn replay set
        self.assigned: List[Request] = []
        self.live_evt = threading.Event()
        self.thread = None
        self.attempts = 0
        self.restarts = 0
        self.error: Optional[BaseException] = None
        #: highest command seq the worker acked
        self.acked = 0
        self.warmups: List[dict] = []
        #: every rank's result of the last group to finish (rank 0's
        #: stands for the replica)
        self.ranks: List[dict] = []


class ServeDriver:
    """Multiplex request streams over ``cfg.n_replicas`` replicas.

    ``model_cfg`` is a `models.llama.LlamaConfig`. ``params`` holds the
    weights: a `Llama` (inline replicas share it), a state dict (or a
    JAX-layout tree of numpy leaves), or a params file path from
    `save_params_npz` (process replicas need one: reloading it IS the
    respawn path). Requests are assigned round-robin at submission; on a
    replica's death the unfinished remainder replays on the respawned
    replica.
    """

    def __init__(self, model_cfg, params, cfg: ReplicaGroupConfig,
                 draft_params=None):
        from ray_lightning_tpu_torch.utils.devices import resolve_device

        if (cfg.draft_model_cfg is not None) != (draft_params is not None):
            raise ValueError(
                "cfg.draft_model_cfg and draft_params arm together — "
                "pass both (speculative inline replicas) or neither")
        #: the draft's weights, in any form ``params`` takes
        self.draft_params = draft_params
        self._draft = None
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.params = params
        self.params_path = (os.fspath(params)
                            if isinstance(params, (str, os.PathLike))
                            else None)
        if cfg.backend == "process" and self.params_path is None:
            raise ValueError(
                "process replicas need a params .npz path "
                "(save_params_npz) — the respawn path reloads from it")
        # the card unless the CPU is asked for; raises without one
        self.device = resolve_device(cfg.device)
        self._model = None
        # ---- live session state ----
        self._session_active = False
        self.replicas: Dict[int, Any] = {}
        self._next_replica = 0
        self._rr = 0
        #: requests with no live replica to route to (the deferral queue)
        self.pending: Optional[deque] = None
        self.outputs: Dict[str, List[int]] = {}
        self.meta: Dict[str, dict] = {}
        self.last_deferral: Optional[dict] = None
        self._spawn_faults: List[dict] = []
        self.last_spawn_s: Optional[float] = None
        self.driver_metrics = None
        self.driver_flight = None

    def _metrics_cfg(self) -> dict:
        return {"enabled": self.cfg.metrics,
                "flush_every": self.cfg.metrics_flush_every_n_ticks,
                "flight_ring": self.cfg.flight_ring,
                "flight_persist_every": self.cfg.flight_persist_every}

    def _slo_kw(self) -> Optional[dict]:
        return (self.cfg.slo.to_wire()
                if self.cfg.slo is not None else None)

    def _worker_device(self) -> str:
        # a process replica sees only the driver's card, as its cuda:0
        return "cpu" if self.device.type == "cpu" else "cuda"

    def _worker_env(self) -> Dict[str, str]:
        return {**_card_env(self.device), **(self.cfg.env or {})}

    def _serving_model(self):
        """The inline replicas' shared model, built once."""
        if self._model is None:
            self._model = _build_model(self.model_cfg, self.params,
                                       self.device)
        return self._model

    def _draft_model(self):
        """The inline replicas' shared draft model, built once (None
        without a draft)."""
        if self._draft is None and self.cfg.draft_model_cfg is not None:
            self._draft = _build_model(self.cfg.draft_model_cfg,
                                       self.draft_params, self.device)
        return self._draft

    def _new_engine(self, metrics):
        engine = DecodeEngine(self._serving_model(), self.cfg.engine,
                              use_kernels=self.cfg.use_kernels,
                              device=self.device, metrics=metrics,
                              draft_model=self._draft_model())
        engine.warmup()
        return engine

    # ---- inline ----------------------------------------------------------

    def _run_inline(self, requests: Sequence[Request]) -> ServeResult:
        outputs: Dict[str, List[int]] = {}
        meta: Dict[str, dict] = {}
        t0 = time.perf_counter()
        n_tokens = 0
        scheds = []
        recorders = []
        mc = self._metrics_cfg()
        for r in range(self.cfg.n_replicas):
            metrics = _make_metrics(self.cfg.run_dir, r, mc)
            flight = _make_flight(self.cfg.run_dir, r, mc)
            sched = Scheduler(self._new_engine(metrics),
                              reserve=self.cfg.reserve, metrics=metrics,
                              flight=flight, slo=self.cfg.slo)
            scheds.append(sched)
            recorders.append(_make_recorder(self.cfg.run_dir, r))

        def note_sheds(r: int, sched) -> None:
            # a shed request is never silently absent from the result
            for rec in sched.take_sheds():
                meta[rec["rid"]] = {
                    "replica": r, "finish_reason": "shed",
                    **{k: v for k, v in rec.items() if k != "rid"}}

        for i, req in enumerate(requests):
            scheds[i % len(scheds)].submit(req)
            outputs[req.rid] = []
        for r, sched in enumerate(scheds):
            note_sheds(r, sched)
        # round-robin ticks until every replica drains: the inline
        # analog of replicas running concurrently
        while any(s.busy() for s in scheds):
            for r, sched in enumerate(scheds):
                if not sched.busy():
                    continue
                completions = sched.tick()
                for detail in sched.last_preemption_details:
                    # the replay resends from scratch
                    outputs[detail["rid"]] = []
                    _record_preemption(recorders[r], detail, r)
                for rid, tok in sched.last_emissions:
                    outputs[rid].append(tok)
                    n_tokens += 1
                for comp in completions:
                    _record_completion(recorders[r], comp, r)
                    meta[comp.rid] = {"replica": r,
                                      **_completion_meta(comp)}
                note_sheds(r, sched)
        wall = time.perf_counter() - t0
        for r, sched in enumerate(scheds):
            _record_drain(recorders[r], sched, r)
            recorders[r].flush()
            recorders[r].close()
            sched.metrics.close()
            sched.flight.close()
        stats = {
            "decode_tokens_per_s": n_tokens / max(wall, 1e-9),
            "slot_occupancy": float(np.mean([s.slot_occupancy
                                             for s in scheds])),
            "n_requests": len(requests), "n_tokens": n_tokens,
            "wall_s": wall,
            "compile_count": NO_COMPILE_COUNT,
            "engine_steps": {r: s.engine.steps
                             for r, s in enumerate(scheds)},
            "requests_shed": sum(
                1 for m in meta.values()
                if m.get("finish_reason") == "shed"),
        }
        result = ServeResult(outputs=outputs, meta=meta,
                             restarts={r: 0 for r in
                                       range(self.cfg.n_replicas)},
                             stats=stats)
        self._write_summary(result)
        return result

    # ---- process replicas ------------------------------------------------

    def _finalize_death(self, replica: int, fc, restarts_so_far: int,
                        respawning: bool) -> None:
        """The flight-recorder postmortem: the dead worker's last
        persisted ring, stamped with its classification, appended to
        ``<run_dir>/flight.json``."""
        if not (self.cfg.run_dir and self.cfg.metrics):
            return
        from ray_lightning_tpu_torch.telemetry.metrics import (
            finalize_flight,
        )

        finalize_flight(
            os.path.join(self.cfg.run_dir, "telemetry"), replica,
            {"kind": fc.kind, "cause": fc.cause, "detail": fc.detail,
             "restartable": fc.restartable,
             "restarts_so_far": restarts_so_far,
             "respawning": respawning},
            os.path.join(self.cfg.run_dir, "flight.json"))

    def _run_process(self, requests: Sequence[Request],
                     fault: Optional[dict]) -> ServeResult:
        from ray_lightning_tpu_torch.resilience.policy import (
            classify_failure,
        )
        from ray_lightning_tpu_torch.runtime.group import WorkerGroup

        n = self.cfg.n_replicas
        assign: List[List[Request]] = [[] for _ in range(n)]
        outputs: Dict[str, List[int]] = {}
        meta: Dict[str, dict] = {}
        for i, req in enumerate(requests):
            assign[i % n].append(req)
            outputs[req.rid] = []
        restarts = {r: 0 for r in range(n)}
        errors: List[BaseException] = []
        lock = san_lock("serve.driver.batch")
        fault_dir = self.cfg.run_dir or os.path.join(
            os.getcwd(), "rlt_logs", "serve")
        os.makedirs(fault_dir, exist_ok=True)
        t0 = time.perf_counter()
        token_count = [0]
        starts: List[dict] = []
        spawn_t0: Dict[int, float] = {}
        occupancy: Dict[int, float] = {}
        steps: Dict[int, int] = {}

        def on_queue_item(_rank, item):
            kind = item[0]
            with lock:
                if kind == "tok":
                    _, _rep, rid, tok = item
                    outputs[rid].append(tok)
                    token_count[0] += 1
                elif kind == "preempt":
                    # the replay resends the stream from scratch
                    outputs[item[2]] = []
                elif kind == "done":
                    _, rep, rid, m = item
                    meta[rid] = {"replica": rep, **m}
                elif kind == "shed":
                    _, rep, rid, rec = item
                    meta[rid] = {
                        "replica": rep, "finish_reason": "shed",
                        **{k: v for k, v in rec.items() if k != "rid"}}
                    outputs[rid] = []
                elif kind == "live":
                    rep = item[1]
                    starts.append({
                        "replica": rep, "attempt": restarts[rep],
                        "spawn_s": round(time.perf_counter()
                                         - spawn_t0[rep], 4),
                        **item[2]})

        def run_replica(r: int) -> None:
            remaining = list(assign[r])
            rep_fault = (fault if fault and
                         fault.get("replica", 0) == r else None)
            while True:
                with lock:
                    remaining = [q for q in remaining
                                 if q.rid not in meta]
                    for q in remaining:
                        # drop the partial streams of requests the dead
                        # replica had in flight: the replay regenerates
                        # them bitwise from their seeds
                        outputs[q.rid] = []
                    spawn_t0[r] = time.perf_counter()
                if not remaining:
                    return
                group = WorkerGroup(
                    num_workers=1, env=self._worker_env(),
                    log_dir=os.path.join(fault_dir, f"replica{r}"),
                    start_timeout=self.cfg.start_timeout)
                try:
                    group.start()
                    res = group.run(
                        _replica_worker_main,
                        shared_args=(
                            self.model_cfg, self.params_path,
                            self.cfg.engine, self.cfg.reserve,
                            [_req_dict(q) for q in remaining], r,
                            self.cfg.run_dir, self.cfg.compile_cache_dir,
                            rep_fault, fault_dir, self._metrics_cfg(),
                            self._slo_kw(), self._worker_device(),
                            self.cfg.use_kernels),
                        on_queue_item=on_queue_item)
                    with lock:
                        occupancy[r] = res[0]["occupancy"]
                        steps[r] = res[0]["steps"]
                    return
                except Exception as exc:  # noqa: BLE001 — classified below
                    fc = classify_failure(exc)
                    log.warning("serve replica %d died (%s/%s): %s", r,
                                fc.kind, fc.cause, fc.detail)
                    respawning = (fc.restartable
                                  and restarts[r] < self.cfg.max_restarts)
                    self._finalize_death(r, fc, restarts[r], respawning)
                    if not respawning:
                        with lock:
                            errors.append(exc)
                        return
                    with lock:
                        restarts[r] += 1
                finally:
                    group.shutdown()

        threads = [threading.Thread(target=run_replica, args=(r,),
                                    daemon=True) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0
        warm_all = [s["warmup_s"] for s in starts]
        stats = {
            "decode_tokens_per_s": token_count[0] / max(wall, 1e-9),
            "slot_occupancy": (float(np.mean(list(occupancy.values())))
                               if occupancy else None),
            "n_requests": len(requests), "n_tokens": token_count[0],
            "wall_s": wall,
            "warmup_cold_s": warm_all[0] if warm_all else None,
            "warmup_respawn_s": (max(s["warmup_s"] for s in starts
                                     if s["attempt"] > 0)
                                 if any(s["attempt"] for s in starts)
                                 else None),
            "replica_starts": starts,
            "compile_count": NO_COMPILE_COUNT,
            "engine_steps": steps,
            "restarts_total": sum(restarts.values()),
            "requests_shed": sum(
                1 for m in meta.values()
                if m.get("finish_reason") == "shed"),
        }
        result = ServeResult(outputs=outputs, meta=meta,
                             restarts=restarts, stats=stats)
        self._write_summary(result)
        return result

    # ---- entry -----------------------------------------------------------

    def run(self, requests: Sequence[Request],
            fault: Optional[dict] = None) -> ServeResult:
        """Serve ``requests`` to completion. ``fault`` (process backend
        only): ``{"replica": r, "kill_after_tokens": n}`` SIGKILLs
        replica ``r`` once, mid-stream — the recovery drill."""
        if self.cfg.tp > 1:
            raise ValueError(
                "tp > 1 replicas are dynamic-session only (start()/"
                "submit()/stop()): the fixed-batch run() ships its "
                "request list at spawn and stays tp=1")
        # COPY before stamping: a reused request list must not carry
        # this run's arrival stamps into the next one
        requests = [dataclasses.replace(r) for r in requests]
        now = time.perf_counter()
        for req in requests:
            if req.arrival == 0.0:
                req.arrival = now
        if self.cfg.backend == "inline":
            if fault:
                raise ValueError("fault injection needs "
                                 "backend='process' — a replica must "
                                 "die for real to drill recovery")
            return self._run_inline(requests)
        return self._run_process(requests, fault)

    # ---- the live session: the autoscale actuation seams -----------------

    def _require_session(self) -> None:
        if not self._session_active:
            raise RuntimeError(
                "no serving session — call ServeDriver.start() first "
                "(run() is the fixed-batch mode and has no scaling "
                "seams)")

    @property
    def live_ids(self) -> List[int]:
        return sorted(r.id for r in self.replicas.values()
                      if r.state == "live")

    @property
    def n_live(self) -> int:
        return len(self.live_ids)

    @property
    def n_draining(self) -> int:
        return sum(1 for r in self.replicas.values()
                   if r.state == "draining")

    def start(self, fault: Optional[dict] = None) -> "ServeDriver":
        """Open a live session with ``cfg.n_replicas`` replicas (each
        through `add_replica`: the scale-up path is the boot path).
        Requests then arrive via `submit()`, the caller drives `tick()`,
        and `stop()` drains and writes serving.json. ``fault`` (process
        only): ``{"replica": r, "kill_after_tokens": n}`` SIGKILLs
        replica ``r`` once, mid-stream."""
        if self._session_active:
            raise RuntimeError("session already started")
        if fault and self.cfg.backend != "process":
            raise ValueError("fault injection needs backend='process' "
                             "— a replica must die for real to drill "
                             "recovery")
        if self.cfg.compile_cache_dir:
            from ray_lightning_tpu_torch.pipeline.compile_cache import (
                enable_persistent_cache,
            )

            enable_persistent_cache(self.cfg.compile_cache_dir)
        if self.cfg.backend == "process":
            self._session_dir = self.cfg.run_dir or os.path.join(
                os.getcwd(), "rlt_logs", "serve")
            os.makedirs(self._session_dir, exist_ok=True)
            self._session_fault = fault
            self._proc_lock = san_lock("serve.driver.session")
        self._session_active = True
        self.replicas = {}
        self._next_replica = 0
        self._rr = 0
        self.pending = deque()
        self.outputs = {}
        self.meta = {}
        self.last_deferral = None
        self.last_spawn_s = None
        self._session_t0 = time.perf_counter()
        self._session_tokens = 0
        self._session_ticks = 0
        mc = self._metrics_cfg()
        from ray_lightning_tpu_torch.telemetry.metrics import (
            NULL_FLIGHT,
            NULL_METRICS,
            FlightRecorder,
            MetricsRegistry,
        )

        if self.cfg.run_dir is not None and mc["enabled"]:
            tdir = os.path.join(self.cfg.run_dir, "telemetry")
            self.driver_metrics = MetricsRegistry(
                tdir, replica=0, prefix="driver",
                flush_every_n_ticks=mc["flush_every"])
            self.driver_flight = FlightRecorder(
                os.path.join(tdir, "driver.flight.json"), replica=-1,
                maxlen=mc["flight_ring"],
                persist_every=mc["flight_persist_every"])
        else:
            self.driver_metrics = NULL_METRICS
            self.driver_flight = NULL_FLIGHT
        for _ in range(self.cfg.n_replicas):
            self.add_replica()
        return self

    def inject_spawn_faults(self, count: int = 1,
                            signal_name: str = "SIGKILL") -> None:
        """Drill seam: the next ``count`` `add_replica` calls die with a
        real `runtime.WorkerError` carrying ``signal_name`` death
        metadata, exactly what a worker killed during its warm-up
        surfaces."""
        self._spawn_faults.extend(
            {"signal_name": signal_name} for _ in range(count))

    def add_replica(self) -> int:
        """Spawn one replica NOW, exactly the respawn path (weights from
        the params file when serving from one, the kernel libraries from
        the persistent build directory armed at `start()`), then it is
        live and routable. Returns the replica id. Raises whatever the
        spawn raised (a `WorkerError` for worker-shaped deaths)."""
        self._require_session()
        r = self._next_replica
        if self._spawn_faults:
            fault = self._spawn_faults.pop(0)
            from ray_lightning_tpu_torch.runtime.group import WorkerError

            self.driver_flight.record("spawn_fault", replica=r, **fault)
            raise WorkerError(
                r, "injected spawn fault: replica worker killed "
                   "during warmup (autoscale drill)",
                signal_name=fault["signal_name"], cause="signal")
        if self.cfg.backend == "process":
            return self._add_replica_process(r)
        t0 = time.perf_counter()
        mc = self._metrics_cfg()
        metrics = _make_metrics(self.cfg.run_dir, r, mc)
        flight = _make_flight(self.cfg.run_dir, r, mc)
        sched = Scheduler(self._new_engine(metrics),
                          reserve=self.cfg.reserve, metrics=metrics,
                          flight=flight, slo=self.cfg.slo)
        recorder = _make_recorder(self.cfg.run_dir, r)
        warm_s = time.perf_counter() - t0
        self._next_replica += 1
        self.replicas[r] = _Replica(r, sched.engine, sched, recorder,
                                    warm_s)
        self.last_spawn_s = warm_s
        self.driver_metrics.count("replicas_spawned")
        self.driver_flight.record("spawn", replica=r,
                                  warm_s=round(warm_s, 4),
                                  live=self.n_live)
        # give already-queued backlog to the new replica: queued work has
        # no partial state, so redistribution is bitwise-neutral
        self._rebalance()
        return r

    def remove_replica(self, replica: Optional[int] = None,
                       graceful: bool = True) -> int:
        """Retire one replica. ``graceful`` (the default): stop
        admissions to it, requeue its queued work onto survivors, and
        let its decoding slots drain to retirement over later `tick()`s.
        ``graceful=False``: also evict the slotted requests for replay
        elsewhere (partial streams dropped) and stop now. Returns the
        victim id (default: the newest live replica)."""
        self._require_session()
        if self.cfg.backend == "process":
            sends: list = []
            with self._proc_lock:
                victim = self._remove_replica_process(replica, graceful,
                                                      sends)
            self._flush_sends(sends)
            return victim
        rep = self._victim(replica)
        rep.state = "draining"
        rep.sched.begin_drain()
        self.driver_metrics.count("replicas_drain_begun")
        self.driver_flight.record(
            "drain_begin", replica=rep.id, graceful=graceful,
            queued=len(rep.sched.queue), slotted=len(rep.sched.slots))
        self._requeue_from(rep)
        if not graceful:
            # account the partial wall first (inflight-tagged spans),
            # then evict: the replayed streams regenerate bitwise
            _record_drain(rep.recorder, rep.sched, rep.id)
            for req, preempts in rep.sched.evict_slotted():
                self.outputs[req.rid] = []
                self._route(req, preempts)
            self._stop_replica(rep)
        return rep.id

    def _victim(self, replica: Optional[int]):
        if replica is None:
            live = self.live_ids
            if not live:
                raise RuntimeError("no live replica to remove")
            replica = live[-1]
        rep = self.replicas.get(replica)
        if rep is None or rep.state != "live":
            raise ValueError(
                f"replica {replica} is "
                f"{'unknown' if rep is None else rep.state} — only a "
                "live replica can be removed")
        return rep

    def submit(self, req: Request) -> Optional[int]:
        """Route one request to a live replica (round-robin). When every
        replica is draining or dead the request defers with a structured
        reason (`last_deferral`, the ``submit_deferrals`` counter, a
        flight event) and re-routes at the next `tick()` that finds a
        live replica. Returns the replica id, or None when deferred."""
        self._require_session()
        from ray_lightning_tpu_torch.serve.scheduler import (
            validate_request,
        )

        # validate before routing or deferring: an unsatisfiable span
        # would head-of-line-block its replica forever
        validate_request(self.cfg.engine, self.cfg.engine.pool_spec, req)
        req = dataclasses.replace(req)
        if req.arrival == 0.0:
            req.arrival = time.perf_counter()
        if self.cfg.backend == "process":
            # the fan-in threads mutate outputs/assigned under the same
            # lock; the channel append happens after the lock drops
            sends: list = []
            with self._proc_lock:
                self.outputs.setdefault(req.rid, [])
                target = self._route(req, 0, sends)
            self._flush_sends(sends)
            return target
        self.outputs.setdefault(req.rid, [])
        return self._route(req, 0)

    def _stamp_driver_gauges(self) -> None:
        self._session_ticks += 1
        dm = self.driver_metrics
        if dm.enabled:
            dm.gauge("replicas_live", self.n_live)
            dm.gauge("replicas_draining", self.n_draining)
            dm.gauge("pending_requests", len(self.pending))
            dm.tick_end()

    def tick(self) -> List[Completion]:
        """One serving tick across the replica set: flush deferred
        requests to a live replica, move draining replicas' queues onto
        survivors, tick every non-stopped replica, retire finished
        drains. Process backend: the replicas tick themselves; this
        flushes deferred requests, raises a replica's terminal error and
        stamps the driver gauges, and returns nothing (completions land
        in ``.meta``/``.outputs``)."""
        self._require_session()
        if self.cfg.backend == "process":
            sends: list = []
            with self._proc_lock:
                for rep in self.replicas.values():
                    if rep.error is not None:
                        raise rep.error
                self._route_pending(sends)
                self._stamp_driver_gauges()
            self._flush_sends(sends)
            return []
        self._route_pending()
        done: List[Completion] = []
        for r in sorted(self.replicas):
            rep = self.replicas[r]
            if rep.state == "stopped":
                continue
            if rep.state == "draining":
                # growth-stall preemptions land back in its closed queue
                self._requeue_from(rep)
                if not rep.sched.slots and not rep.sched.queue:
                    self._stop_replica(rep)
                    continue
            completions = rep.sched.tick()
            for detail in rep.sched.last_preemption_details:
                self.outputs[detail["rid"]] = []
                _record_preemption(rep.recorder, detail, r)
            if rep.state == "draining":
                self._requeue_from(rep)
            for rid, tok in rep.sched.last_emissions:
                self.outputs[rid].append(tok)
                self._session_tokens += 1
            for comp in completions:
                _record_completion(rep.recorder, comp, r)
                self.meta[comp.rid] = {"replica": r,
                                       **_completion_meta(comp)}
                if len(rep.sched.completions) % \
                        FLUSH_EVERY_N_COMPLETIONS == 0:
                    rep.recorder.flush()
            self._drain_sheds(r, rep.sched)
            done.extend(completions)
        self._stamp_driver_gauges()
        return done

    def busy(self) -> bool:
        self._require_session()
        if self.cfg.backend == "process":
            with self._proc_lock:
                return bool(self.pending) or any(
                    rep.assigned for rep in self.replicas.values()
                    if rep.state != "stopped")
        return bool(self.pending) or any(
            rep.sched.busy() for rep in self.replicas.values()
            if rep.state != "stopped")

    def force_flight_persist(self) -> int:
        """Persist every non-stopped inline replica's flight ring and the
        driver's ring now (the incident-capture seam); returns how many
        landed. Process replicas persist on their own cadence."""
        persisted = 0
        for rep in self.replicas.values():
            sched = getattr(rep, "sched", None)
            if rep.state == "stopped" or sched is None:
                continue
            if sched.flight.enabled:
                sched.flight.persist()
                persisted += 1
        fl = self.driver_flight
        if fl is not None and fl.enabled:
            fl.persist()
            persisted += 1
        return persisted

    def _check_pending_reachable(self, others_busy: bool) -> None:
        """A drain that could only tick forever: deferred work with no
        replica that can ever take it."""
        if self.pending and self.n_live == 0 and not others_busy:
            raise RuntimeError(
                f"{len(self.pending)} deferred request(s) with no live "
                "replica — add_replica() before stop(), or "
                "stop(drain=False) to abandon them")

    def stop(self, drain: bool = True) -> ServeResult:
        """End the session. ``drain`` ticks until every stream completes
        first; ``drain=False`` accounts in-flight work as inflight-tagged
        spans and stops cold. Writes serving.json and returns the
        session's ServeResult."""
        self._require_session()
        if self.cfg.backend == "process":
            return self._stop_process(drain)
        if drain:
            while self.busy():
                self._check_pending_reachable(any(
                    rep.sched.busy() for rep in self.replicas.values()
                    if rep.state != "stopped"))
                self.tick()
        final_replicas = self.n_live
        for rep in self.replicas.values():
            if rep.state == "stopped":
                continue
            # enqueue-time sheds on an idle session never saw a tick
            self._drain_sheds(rep.id, rep.sched)
            _record_drain(rep.recorder, rep.sched, rep.id)
            self._stop_replica(rep)
        occ = [rep.sched.slot_occupancy for rep in self.replicas.values()]
        stats = self._session_stats(final_replicas, occ)
        stats["engine_steps"] = {rep.id: rep.engine.steps
                                 for rep in self.replicas.values()}
        return self._end_session(
            ServeResult(outputs=self.outputs, meta=self.meta,
                        restarts={r: 0 for r in self.replicas},
                        stats=stats))

    def _session_stats(self, final_replicas: int, occ: List[float]) -> dict:
        wall = time.perf_counter() - self._session_t0
        counters = self.driver_metrics.counters()
        return {
            "decode_tokens_per_s": self._session_tokens / max(wall, 1e-9),
            "slot_occupancy": float(np.mean(occ)) if occ else None,
            "n_requests": len(self.outputs),
            "n_tokens": self._session_tokens,
            "wall_s": wall,
            "ticks": self._session_ticks,
            "compile_count": NO_COMPILE_COUNT,
            "replicas_spawned": self._next_replica,
            "final_replicas": final_replicas,
            "submit_deferrals": counters.get("submit_deferrals", 0),
            "requests_shed": counters.get("requests_shed", 0),
            "last_spawn_s": self.last_spawn_s,
        }

    def _end_session(self, result: ServeResult) -> ServeResult:
        self.driver_metrics.close()
        self.driver_flight.close()
        self._write_summary(result)
        self._session_active = False
        return result

    # ---- session internals ----------------------------------------------

    def _drain_sheds(self, r: int, sched) -> None:
        """A scheduler's typed shed records as terminal stream statuses
        (finish_reason "shed" + retry-after hint): shed work is
        answered, never silently dropped."""
        for rec in sched.take_sheds():
            rid = rec["rid"]
            self.meta[rid] = {
                "replica": r, "finish_reason": "shed",
                **{k: v for k, v in rec.items() if k != "rid"}}
            self.outputs[rid] = []
            self.driver_metrics.count("requests_shed")

    def _pick_replica(self) -> Optional[int]:
        live = self.live_ids
        if not live:
            return None
        target = live[self._rr % len(live)]
        self._rr += 1
        return target

    def _route(self, req: Request, preempts: int,
               sends: Optional[list] = None) -> Optional[int]:
        target = self._pick_replica()
        if target is None:
            self.pending.append((req, preempts))
            self.last_deferral = {
                "rid": req.rid,
                "reason": "no live replica: all replicas draining "
                          "or dead",
                "draining": self.n_draining,
                "pending": len(self.pending),
                "at": time.perf_counter(),
            }
            self.driver_metrics.count("submit_deferrals")
            self.driver_flight.record("submit_deferral", rid=req.rid,
                                      draining=self.n_draining,
                                      pending=len(self.pending))
            return None
        rep = self.replicas[target]
        if isinstance(rep, _ProcessReplica):
            from ray_lightning_tpu_torch.serve.channel import (
                request_to_wire,
            )

            # the command log IS the enqueue; the assignment ledger is
            # what a respawn replays. The send happens after the session
            # lock drops (_flush_sends)
            rep.assigned.append(req)
            sends.append((rep.writer, rep.writer.epoch, "submit",
                          {"req": request_to_wire(req),
                           "preempts": preempts}))
        else:
            rep.sched.enqueue(req, preempts)
        return target

    def _route_pending(self, sends: Optional[list] = None) -> None:
        while self.pending and self.live_ids:
            req, preempts = self.pending.popleft()
            self._route(req, preempts, sends)

    @staticmethod
    def _flush_sends(sends: list) -> None:
        """Channel sends decided under the session lock, made outside it
        (each append fsyncs). Each is epoch-guarded: if its replica
        respawned in between, the fresh epoch's replay already carries
        the command and `send_at` drops it."""
        for writer, epoch, op, payload in sends:
            writer.send_at(epoch, op, **payload)

    def _requeue_from(self, rep: _Replica) -> None:
        for req, preempts in rep.sched.evict_queued():
            self._route(req, preempts)

    def _rebalance(self) -> None:
        """Even out queued (never admitted) backlog across live replicas
        after a scale-up, FIFO by arrival; bitwise-neutral (queued work
        has no partial state; streams are seed-pure)."""
        live = [self.replicas[r] for r in self.live_ids]
        if len(live) < 2:
            return
        backlog: List = []
        for rep in live:
            backlog.extend(rep.sched.evict_queued())
        if not backlog:
            return
        backlog.sort(key=lambda item: item[0].arrival)
        for i, (req, preempts) in enumerate(backlog):
            live[i % len(live)].sched.enqueue(req, preempts)

    def _stop_replica(self, rep: _Replica) -> None:
        rep.state = "stopped"
        rep.recorder.flush()
        rep.recorder.close()
        m = rep.sched.metrics
        if m.enabled:
            # stamp the stream retired so the load signal stops pooling
            # this replica's stale window into live pressure
            m.gauge("retired", 1)
            m.tick_end()
        m.close()
        rep.sched.flight.record("drain_end", replica=rep.id)
        rep.sched.flight.close()
        self.driver_metrics.count("replicas_stopped")
        self.driver_flight.record("drain_end", replica=rep.id,
                                  live=self.n_live)

    # ---- process-session internals (the request channel) -------------------

    def _add_replica_process(self, r: int) -> int:
        """Spawn one PROCESS replica: open its command log, start its
        spawn/respawn thread, and block until the worker reports live
        (or the spawn classifies terminal)."""
        from ray_lightning_tpu_torch.serve.channel import ChannelWriter

        with self._proc_lock:
            writer = ChannelWriter(self._session_dir, r)
            rep = _ProcessReplica(r, writer)
            self._next_replica += 1
            self.replicas[r] = rep
            rep.thread = threading.Thread(
                target=self._run_session_replica, args=(rep,),
                daemon=True, name=f"serve-replica-{r}")
            rep.thread.start()
        if not rep.live_evt.wait(self.cfg.start_timeout):
            with self._proc_lock:
                rep.state = "stopped"
            raise RuntimeError(
                f"replica {r} did not report live within "
                f"{self.cfg.start_timeout:.0f}s (spawn/warmup hang) — "
                f"worker logs under {self._session_dir}/replica{r}")
        with self._proc_lock:
            if rep.error is not None:
                raise rep.error
            self.driver_metrics.count("replicas_spawned")
            self.driver_flight.record(
                "spawn", replica=r,
                warm_s=round(rep.warm_s or 0.0, 4), live=self.n_live)
        # no rebalance across process replicas: work already shipped over
        # a channel cannot be pulled back; new submissions round-robin
        # onto the grown set
        return r

    def _remove_replica_process(self, replica: Optional[int],
                                graceful: bool, sends: list) -> int:
        """Caller holds ``_proc_lock``. The worker evicts what the
        survivors should replay (its queue; its slots too when not
        graceful), wires it back and exits; the spawn thread then marks
        the replica stopped."""
        rep = self._victim(replica)
        rep.state = "draining"
        self.driver_metrics.count("replicas_drain_begun")
        self.driver_flight.record(
            "drain_begin", replica=rep.id, graceful=graceful,
            outstanding=len(rep.assigned))
        if graceful:
            sends.append((rep.writer, rep.writer.epoch, "drain", {}))
        else:
            sends.append((rep.writer, rep.writer.epoch, "stop",
                          {"mode": "hard"}))
        return rep.id

    def _run_session_replica(self, rep: _ProcessReplica) -> None:
        """One replica's spawn/respawn loop (its own thread): compute the
        channel-epoch replay, run the WorkerGroup, classify deaths and
        respawn within the restart budget."""
        from ray_lightning_tpu_torch.resilience.policy import (
            classify_failure,
        )
        from ray_lightning_tpu_torch.runtime.group import WorkerGroup
        from ray_lightning_tpu_torch.runtime.launch import _open_store
        from ray_lightning_tpu_torch.serve.channel import request_to_wire

        fault = getattr(self, "_session_fault", None)
        rep_fault = (fault if fault and
                     fault.get("replica", 0) == rep.id else None)
        while True:
            with self._proc_lock:
                if rep.attempts > 0:
                    # respawn: a FRESH epoch replaying the unfinished
                    # assignment + control state. The worker announces
                    # each replayed submit it admits ("starts") and the
                    # fan-in resets that stream's stale prefix there
                    rep.assigned = [q for q in rep.assigned
                                    if q.rid not in self.meta]
                    replay = [{"op": "submit", "req": request_to_wire(q)}
                              for q in rep.assigned]
                    if rep.state == "draining":
                        replay.append({"op": "drain"})
                    rep.writer.begin_epoch(replay)
                epoch = rep.writer.epoch
            tp = self.cfg.tp
            group = WorkerGroup(
                num_workers=tp, env=self._worker_env(),
                log_dir=os.path.join(self._session_dir,
                                     f"replica{rep.id}"),
                start_timeout=self.cfg.start_timeout)
            try:
                group.start()
                # rank 0 serves the tensor group's rendezvous store
                rendezvous = (("127.0.0.1", group.run_single(
                    0, _open_store, tp, timeout=60)) if tp > 1 else None)
                res = group.run(
                    _replica_session_main,
                    shared_args=(
                        self.model_cfg, self.params_path, self.cfg.engine,
                        self.cfg.reserve, rep.id, self.cfg.run_dir,
                        self._session_dir, self.cfg.compile_cache_dir,
                        rep_fault, self._session_dir,
                        self._metrics_cfg(), epoch, self._slo_kw(),
                        self._worker_device(), self.cfg.use_kernels, tp,
                        rendezvous),
                    per_rank_args=[(k,) for k in range(tp)],
                    on_queue_item=self._on_session_item)
                with self._proc_lock:
                    rep.ranks = res
                    if rep.state != "stopped":
                        self._finalize_process_replica(rep)
                return
            except Exception as exc:  # noqa: BLE001 — classified below
                fc = classify_failure(exc)
                log.warning("session replica %d died (%s/%s): %s",
                            rep.id, fc.kind, fc.cause, fc.detail)
                with self._proc_lock:
                    respawning = (fc.restartable
                                  and rep.restarts < self.cfg.max_restarts
                                  and rep.state != "stopped")
                    self._finalize_death(rep.id, fc, rep.restarts,
                                         respawning)
                    rep.attempts += 1
                    if not respawning:
                        rep.error = exc
                        rep.state = "stopped"
                        rep.live_evt.set()
                        return
                    rep.restarts += 1
                    rep.live_evt.clear()
            finally:
                group.shutdown()

    def _on_session_item(self, _rank, item) -> None:
        """Side-channel fan-in for every session replica (called from
        their spawn threads): one batched item per worker iteration."""
        from ray_lightning_tpu_torch.serve.channel import request_from_wire

        kind = item[0]
        sends: list = []
        with self._proc_lock:
            rep = self.replicas.get(item[1])
            if rep is None:
                return
            if kind == "live":
                rep.warm_s = item[2]["warmup_s"]
                rep.warmups.append(dict(item[2]))
                rep.spawned_at = time.perf_counter()
                self.last_spawn_s = rep.warm_s
                rep.live_evt.set()
                return
            if kind != "batch":
                return
            payload = item[2]
            if "ack" in payload:
                rep.acked = max(rep.acked, int(payload["ack"]))
            for rid in payload.get("starts", ()):
                # admitted afresh: a no-op reset for a normal submit, the
                # stale-prefix drop for an epoch replay (ordered before
                # toks: a replayed stream's first tokens can share this
                # batch)
                self.outputs[rid] = []
            for rid in payload.get("preempts", ()):
                self.outputs[rid] = []
            for rid, tok in payload.get("toks", ()):
                self.outputs[rid].append(int(tok))
                self._session_tokens += 1
            for rid, m in payload.get("dones", ()):
                self.meta[rid] = {"replica": rep.id, **m}
                rep.assigned = [q for q in rep.assigned if q.rid != rid]
            for rec in payload.get("sheds", ()):
                # idempotent across epoch rolls: a rid already shed is
                # not re-counted, and leaving the assignment ledger keeps
                # a respawn from resubmitting it
                rid = rec["rid"]
                if (self.meta.get(rid, {}).get("finish_reason")
                        != "shed"):
                    self.driver_metrics.count("requests_shed")
                self.meta[rid] = {
                    "replica": rep.id, "finish_reason": "shed",
                    **{k: v for k, v in rec.items() if k != "rid"}}
                self.outputs[rid] = []
                rep.assigned = [q for q in rep.assigned if q.rid != rid]
            for wire, preempts in payload.get("evicted", ()):
                # a draining/stopping replica handing work back for the
                # survivors (the bitwise replay seam)
                req = request_from_wire(wire)
                rep.assigned = [q for q in rep.assigned
                                if q.rid != req.rid]
                self.outputs[req.rid] = []
                self._route(req, int(preempts), sends)
        self._flush_sends(sends)

    def _finalize_process_replica(self, rep: _ProcessReplica) -> None:
        """The worker exited cleanly (caller holds ``_proc_lock``); it
        owned and closed the replica's telemetry streams."""
        rep.state = "stopped"
        self.driver_metrics.count("replicas_stopped")
        self.driver_flight.record("drain_end", replica=rep.id,
                                  live=self.n_live)

    def _stop_process(self, drain: bool) -> ServeResult:
        if drain:
            while self.busy():
                with self._proc_lock:
                    self._check_pending_reachable(any(
                        rep.assigned for rep in self.replicas.values()
                        if rep.state != "stopped"))
                self.tick()
                time.sleep(0.01)
        sends: list = []
        with self._proc_lock:
            final_replicas = self.n_live
            for rep in self.replicas.values():
                if rep.state != "stopped":
                    # "finish": serve out everything assigned, then exit;
                    # "abort": account in-flight work and exit now
                    sends.append(
                        (rep.writer, rep.writer.epoch, "stop",
                         {"mode": "finish" if drain else "abort"}))
        self._flush_sends(sends)
        for rep in self.replicas.values():
            if rep.thread is not None:
                rep.thread.join(self.cfg.start_timeout)
        for rep in self.replicas.values():
            if rep.error is not None:
                raise rep.error
        # the leader's (rank 0's) result stands for its replica
        results = [rep.ranks[0] for rep in self.replicas.values()
                   if rep.ranks]
        starts = [{"replica": rep.id, "attempt": i, **w}
                  for rep in self.replicas.values()
                  for i, w in enumerate(rep.warmups)]
        stats = self._session_stats(final_replicas,
                                    [res["occupancy"] for res in results])
        stats.update({
            "warmup_cold_s": starts[0]["warmup_s"] if starts else None,
            "warmup_respawn_s": max(
                (s["warmup_s"] for s in starts if s["attempt"] > 0),
                default=None),
            "replica_starts": starts,
            "engine_steps": {res["replica"]: res["steps"]
                             for res in results},
            "restarts_total": sum(rep.restarts
                                  for rep in self.replicas.values()),
            # each rank's kernel launches and device bytes, by replica
            "replica_ranks": {
                rep.id: [{k: r[k] for k in ("rank", "steps", "launches",
                                            "live_bytes")}
                         for r in rep.ranks]
                for rep in self.replicas.values() if rep.ranks},
        })
        result = ServeResult(
            outputs=self.outputs, meta=self.meta,
            restarts={rep.id: rep.restarts
                      for rep in self.replicas.values()}, stats=stats)
        for rep in self.replicas.values():
            rep.writer.close()
        return self._end_session(result)

    def _write_summary(self, result: ServeResult) -> None:
        if self.cfg.run_dir is None:
            return
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        from ray_lightning_tpu_torch.telemetry.metrics import (
            aggregate_from_parsed,
            load_signal_from_parsed,
            newest_from_parsed,
            read_all_metrics,
        )

        doc = {"stats": result.stats, "meta": result.meta,
               "restarts": result.restarts}
        tdir = _serve_metrics_dir(self.cfg.run_dir)
        parsed = read_all_metrics(tdir)  # one pass feeds both rollups
        agg = aggregate_from_parsed(parsed)
        if agg is not None:
            # the run-level rollup: quantiles from merged buckets (exact
            # across replicas and attempts), counters summed, and the
            # load summary the autoscale oracle reads
            doc["metrics"] = agg
            doc["load"] = load_signal_from_parsed(
                newest_from_parsed(parsed), where=tdir)
        path = os.path.join(self.cfg.run_dir, "serving.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)


# ---- run-level metric aggregation + the autoscale load signal -------------


def _serve_metrics_dir(run_dir: str) -> str:
    tdir = os.path.join(run_dir, "telemetry")
    return tdir if os.path.isdir(tdir) else run_dir


def aggregate_serve_metrics(run_dir: str) -> Optional[dict]:
    """Merge every per-replica metrics JSONL under ``<run_dir>/telemetry``
    into one run-level view: summed counters, exactly-merged latency
    histograms, per-replica tick/attempt counts and queue-depth/
    occupancy series stats. None when the run recorded no metrics."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        aggregate_metrics_dir,
    )

    return aggregate_metrics_dir(_serve_metrics_dir(run_dir))


def load_signal(run_dir: str, window: Optional[int] = None) -> dict:
    """The queue-depth/occupancy input of replica autoscale: the newest
    metrics file per replica under ``<run_dir>/telemetry``, summarized
    over the last ``window`` flushed tick samples (``available`` False
    when no metrics exist yet — "no signal", never zero load). It lags
    live state by at most one flush cadence."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        LOAD_SIGNAL_WINDOW,
        load_signal_from_dir,
    )

    return load_signal_from_dir(
        _serve_metrics_dir(run_dir),
        window=window if window is not None else LOAD_SIGNAL_WINDOW)


def _req_dict(req: Request) -> dict:
    return {"rid": req.rid, "prompt": np.asarray(req.prompt).tolist(),
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature, "top_k": req.top_k,
            "seed": req.seed, "eos_id": req.eos_id,
            "priority": req.priority}
