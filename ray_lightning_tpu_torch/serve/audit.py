"""The static serving plan (twin of the plan half of
`ray_lightning_tpu/serve/audit.py`): a replica's bytes on the card,
priced before anything is allocated, for ``plan --serve`` and
``serve llama3-8b``.

  * `serve_memory_summary` — weights + the paged pool + the attention
    lanes' surviving gathered view + the carried ``last_logits``,
    against the card's memory (`parallel.plan.hbm_bytes_for_kind`; the
    H100's 79 GiB by default), with ``tp`` pricing one rank of a
    tensor-parallel replica;
  * `speculative_plan` — the draft's and the k-wide verify's cost;
  * `shared_prefix_plan` — what prefix sharing saves;
  * `format_serve_summary` — the table ``plan --serve`` prints;
  * `trace_decode_step` / `audit_decode_step` — the engine's step
    (`serve.engine.DecodeEngine`) on fake tensors: the ``rltt`` kernel
    operators it runs, the dense views of the pool it gathers (RLT307,
    RLT308), its peak, and under ``tp > 1`` its collectives.

The model is built on the meta device (shapes and dtypes, no storage),
so a term is the live engine's bytes exactly: the serving model stores
its matmul weights and embedding in ``cfg.dtype`` and its norm gains in
f32, where the JAX plan counts every parameter in its param dtype.
"""
from __future__ import annotations

from typing import Optional

from ray_lightning_tpu_torch.analysis.costmodel import (  # noqa: F401
    paged_decode_traffic_bytes,
    paged_prefill_traffic_bytes,
)
from ray_lightning_tpu_torch.serve.engine import (
    EngineConfig,
    serving_param_specs,
)
from ray_lightning_tpu_torch.serve.kv_cache import (
    _itemsize,
    gathered_view_bytes,
    pool_bytes,
    serve_kv_plan_bytes,
    validate_pool_tp,
)

#: the fraction of the card's memory a serving replica plans to fill
#: (the JAX plan's: allocator fragmentation and the step's transients
#: live in the rest)
USABLE_FRACTION = 0.90


def _meta_model(model_cfg):
    from ray_lightning_tpu_torch.models.llama import Llama

    return Llama(model_cfg, device="meta")


def _shapes(model_cfg, engine_cfg: EngineConfig, tp: int):
    spec = engine_cfg.pool_spec
    pool = (spec.n_blocks, spec.block_size, model_cfg.n_kv_heads // tp,
            model_cfg.head_dim)
    return model_cfg.n_heads // tp, pool


def _shape_fused_available(model_cfg, engine_cfg: EngineConfig,
                           tp: int = 1) -> bool:
    """Would the paged decode kernel take this (model, engine) shape, at a
    rank's heads? Shape support only, whatever this host's device: the
    planner prices the lanes the card will run."""
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_shapes_supported,
    )

    h, pool = _shapes(model_cfg, engine_cfg, tp)
    return (engine_cfg.draft is None and paged_shapes_supported(
        (engine_cfg.capacity, h, model_cfg.head_dim), pool))


def _shape_fused_prefill_available(model_cfg, engine_cfg: EngineConfig,
                                   tp: int = 1) -> bool:
    """The prefill twin of `_shape_fused_available`."""
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_shapes_supported,
    )

    h, pool = _shapes(model_cfg, engine_cfg, tp)
    return (engine_cfg.draft is None and paged_prefill_shapes_supported(
        (engine_cfg.prefill_batch, engine_cfg.prefill_chunk, h,
         model_cfg.head_dim), pool))


def serving_params_bytes(model_cfg, tp: int = 1) -> int:
    """The bytes of one rank's serving weights: each weight in its stored
    dtype, divided by ``tp`` where `engine.serving_param_specs` splits it
    (replicated leaves, the norm gains, stay whole)."""
    model = _meta_model(model_cfg)
    named = dict(model.named_parameters())
    total = 0
    for name, spec in serving_param_specs(model):
        p = named[name]
        b = p.numel() * p.element_size()
        if tp > 1 and "tensor" in spec:
            b //= tp
        total += b
    return total


def serve_memory_summary(model_cfg, engine_cfg: EngineConfig,
                         device_kind: Optional[str] = None,
                         hbm_bytes: Optional[int] = None,
                         fused: Optional[bool] = None,
                         fused_prefill: Optional[bool] = None,
                         tp: int = 1) -> dict:
    """A serving replica's bytes, itemized (no optimizer: weights, the
    paged pool, the attention lanes' surviving gathered view, the carried
    logits), with a fits verdict against the card's memory
    (``device_kind``, default the H100; ``hbm_bytes`` overrides).

    ``fused=None`` / ``fused_prefill=None`` pick the lanes by shape
    support, as the engine on the card picks them; a speculative engine
    (``engine_cfg.draft``) runs the reference lanes. ``tp > 1`` prices
    ONE RANK of a tensor-parallel replica: the split weights, the pool
    and every view divide by ``tp``; ``last_logits`` is replicated."""
    from ray_lightning_tpu_torch.parallel.plan import (
        H100_KIND,
        hbm_bytes_for_kind,
    )

    validate_pool_tp(model_cfg, tp)
    if fused is None:
        fused = _shape_fused_available(model_cfg, engine_cfg, tp)
    if fused_prefill is None:
        fused_prefill = _shape_fused_prefill_available(model_cfg,
                                                       engine_cfg, tp)
    params_bytes = serving_params_bytes(model_cfg, tp)
    spec = engine_cfg.pool_spec
    kv = serve_kv_plan_bytes(model_cfg, spec, engine_cfg.capacity,
                             fused=fused,
                             prefill_batch=engine_cfg.prefill_batch,
                             fused_prefill=fused_prefill, tp=tp)
    budget = hbm_bytes_for_kind(device_kind or H100_KIND, hbm_bytes)
    usable = int(budget * USABLE_FRACTION)
    # the retired term is reporting, and the prefill gather an
    # itemization of the surviving view: neither is an extra buffer
    resident = {k: v for k, v in kv.items()
                if k not in ("gathered_view_retired_bytes",
                             "prefill_gather_bytes")}
    total = params_bytes + sum(resident.values())
    group_span = gathered_view_bytes(
        model_cfg, spec, min(engine_cfg.prefill_batch,
                             engine_cfg.capacity)) // tp
    chunk_bytes = (2 * model_cfg.n_layers * engine_cfg.prefill_batch
                   * engine_cfg.prefill_chunk * model_cfg.n_kv_heads
                   * model_cfg.head_dim * _itemsize(model_cfg.dtype)) // tp
    return {
        "params_bytes": int(params_bytes),
        **kv,
        "tp": tp,
        "attention_path": "paged-kernel" if fused else "reference-gather",
        "prefill_attention_path": ("paged-kernel" if fused_prefill
                                   else "reference-gather"),
        "decode_kv_traffic_bytes_per_tick": paged_decode_traffic_bytes(
            kv["pool_bytes"], serve_kv_plan_bytes(
                model_cfg, spec, engine_cfg.capacity, fused=False,
                tp=tp)["gathered_view_bytes"], fused),
        "prefill_kv_traffic_bytes_per_chunk":
            paged_prefill_traffic_bytes(group_span, chunk_bytes,
                                        fused_prefill),
        "capacity": engine_cfg.capacity,
        "block_size": spec.block_size,
        "n_blocks": spec.n_blocks,
        "max_slot_len": engine_cfg.max_slot_len,
        "per_device_bytes": int(total),
        "budget_bytes": usable,
        "fits": total <= usable,
    }


def _param_count(model_cfg) -> int:
    """Parameter count, from the meta model."""
    return sum(p.numel() for p in _meta_model(model_cfg).parameters())


def speculative_plan(model_cfg, draft_cfg, engine_cfg: EngineConfig,
                     accept_rate: float = 0.6) -> dict:
    """The cost of speculative decoding at this (target, draft, engine)
    shape (the JAX cost model): one tick is ONE k-wide verify of the
    target (k token-forwards of compute, one sweep of its weights and
    pool) plus ``k`` single-token draft trips, and emits ``1 +
    accept_rate * (k - 1)`` tokens in expectation. ``memory_bound_
    speedup_x`` is the ratio of bytes read a token against plain decode;
    ``flops_overhead_x`` the price. Byte terms are the serving model's
    stored bytes (`serving_params_bytes`, `kv_cache.pool_bytes`), so
    ``draft_params_bytes`` and ``draft_pool_bytes`` equal a live draft's
    and its pool's."""
    k = engine_cfg.draft.k if engine_cfg.draft is not None else 4
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate {accept_rate} not in [0, 1]")
    n_t, n_d = _param_count(model_cfg), _param_count(draft_cfg)
    spec = engine_cfg.pool_spec
    flops_per_token = 2 * n_t
    verify_step_flops = k * flops_per_token
    draft_flops_per_tick = k * 2 * n_d
    expected = 1.0 + accept_rate * (k - 1)
    params_bytes = serving_params_bytes(model_cfg)
    draft_params_bytes = serving_params_bytes(draft_cfg)
    pool = pool_bytes(model_cfg, spec)
    draft_pool = pool_bytes(draft_cfg, spec)
    base_reads = params_bytes + pool
    spec_reads = base_reads + k * (draft_params_bytes + draft_pool)
    return {
        "k": k,
        "accept_rate": accept_rate,
        "target_params": n_t,
        "draft_params": n_d,
        "draft_params_bytes": int(draft_params_bytes),
        "draft_pool_bytes": int(draft_pool),
        "verify_step_flops": int(verify_step_flops),
        "draft_flops_per_tick": int(draft_flops_per_tick),
        "base_decode_flops_per_token": int(flops_per_token),
        "expected_tokens_per_tick": expected,
        "flops_per_emitted_token": int(
            (verify_step_flops + draft_flops_per_tick) / expected),
        "flops_overhead_x": (verify_step_flops + draft_flops_per_tick)
        / (expected * flops_per_token),
        "hbm_read_bytes_per_tick_base": int(base_reads),
        "hbm_read_bytes_per_tick_spec": int(spec_reads),
        "memory_bound_speedup_x": expected * base_reads / spec_reads,
    }


def shared_prefix_plan(model_cfg, engine_cfg: EngineConfig,
                       n_streams: int = 8,
                       prefix_tokens: Optional[int] = None) -> dict:
    """What prefix sharing saves for ``n_streams`` requests over a common
    ``prefix_tokens``-token prefix (default: half the slot): only FULL
    blocks share, so the other ``n_streams - 1`` requests never spend
    those blocks' pool bytes or prefill tokens."""
    spec = engine_cfg.pool_spec
    P = spec.block_size
    if prefix_tokens is None:
        prefix_tokens = engine_cfg.max_slot_len // 2
    if n_streams < 1:
        raise ValueError(f"n_streams {n_streams} < 1")
    full = min(prefix_tokens, engine_cfg.max_slot_len) // P
    block_bytes = (2 * model_cfg.n_layers * P * model_cfg.n_kv_heads
                   * model_cfg.head_dim * _itemsize(model_cfg.dtype))
    return {
        "n_streams": n_streams,
        "prefix_tokens": int(prefix_tokens),
        "shared_full_blocks": int(full),
        "block_bytes": int(block_bytes),
        "pool_bytes_without_sharing": int(n_streams * full * block_bytes),
        "pool_bytes_with_sharing": int(full * block_bytes),
        "shared_pool_bytes_saved": int(
            (n_streams - 1) * full * block_bytes),
        "prefill_tokens_saved": int((n_streams - 1) * full * P),
    }


def format_serve_summary(s: dict) -> str:
    """`serve_memory_summary`'s table, as ``plan --serve`` prints it."""
    gib = 1024**3
    fused = s.get("attention_path") == "paged-kernel"
    fused_pf = s.get("prefill_attention_path") == "paged-kernel"
    if fused and fused_pf:
        view_line = (
            f"  gathered view    {s['gathered_view_bytes'] / gib:7.2f} "
            "GiB  (prefill gather itemized at "
            f"{s.get('prefill_gather_bytes', 0) / gib:.2f} GiB; the "
            f"{s['gathered_view_retired_bytes'] / gib:.2f} GiB dense "
            "views are RETIRED by the paged decode + prefill kernels — "
            "no dense gather remains)")
    elif fused:
        view_line = (
            f"  prefill gather   {s['gathered_view_bytes'] / gib:7.2f} "
            "GiB  (per-group prefill copy; the decode lane's "
            f"{s['gathered_view_retired_bytes'] / gib:.2f} GiB dense "
            "view is RETIRED by the paged decode kernel, and the paged "
            "prefill kernel retires this remainder)")
    else:
        view_line = (
            f"  gathered view    {s['gathered_view_bytes'] / gib:7.2f} "
            "GiB  (reference lanes' dense copy; the paged decode + "
            "prefill kernels retire it)")
    traffic_tail = ")" if fused else " + dense-view write+read)"
    pf_traffic = s.get("prefill_kv_traffic_bytes_per_chunk")
    tp = s.get("tp", 1)
    tp_tag = (f", tp={tp} (per-shard bytes, one rank of the replica "
              "group)" if tp > 1 else "")
    lines = [
        f"serve plan: {s['capacity']} slots x {s['max_slot_len']} "
        f"tokens, pool {s['n_blocks']} x {s['block_size']}-token "
        f"blocks, attention path: {s.get('attention_path', '?')}, "
        f"prefill path: {s.get('prefill_attention_path', '?')}"
        + tp_tag,
        f"  params           {s['params_bytes'] / gib:7.2f} GiB",
        f"  kv pool          {s['pool_bytes'] / gib:7.2f} GiB",
        view_line,
        f"  carried logits   {s['last_logits_bytes'] / gib:7.2f} GiB",
        f"  decode KV traffic "
        f"{s['decode_kv_traffic_bytes_per_tick'] / gib:6.2f}"
        " GiB/tick (cost model: pool read" + traffic_tail,
    ]
    if pf_traffic is not None:
        lines.append(
            f"  prefill KV traffic {pf_traffic / gib:5.2f} GiB/chunk "
            "(cost model: group-block reads + chunk write"
            + (")" if fused_pf else " + group-view write+read)"))
    lines.append(
        f"  total {s['per_device_bytes'] / gib:.2f} GiB vs budget "
        f"{s['budget_bytes'] / gib:.2f} GiB — "
        f"{'fits' if s['fits'] else 'DOES NOT FIT'}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# the decode-step audit
# --------------------------------------------------------------------------


def _pool_views(events, pool_shape) -> list:
    """Shapes of the dense slot views the stream gathered from a pool
    ``[L, N, P, Hkv, hd]``: ``[L, rows, M, P, Hkv, hd]`` (the decode
    lane's capacity-wide view, the prefill lane's group view)."""
    L, _, P, HKV, HD = pool_shape
    hits = []
    for ev in events:
        if ev.name != "aten.index" or not ev.in_shapes or \
                tuple(ev.in_shapes[0]) != tuple(pool_shape):
            continue
        out = tuple(ev.out_shapes[0]) if ev.out_shapes else ()
        if len(out) == 6 and out[0] == L and out[3:] == (P, HKV, HD):
            hits.append(out)
    return hits


def trace_decode_step(model_cfg, engine_cfg: EngineConfig,
                      fused: bool = False,
                      fused_prefill: Optional[bool] = None, tp: int = 1,
                      device="cpu"):
    """``(recorder, meta)`` of the engine's continuous-batching step on
    fake tensors: a `DecodeEngine` built over a meta-built model given
    fake storage, then two ticks of its own step, one where every slot
    decodes and one where a prefill group's chunk runs, each recorded
    (`analysis.tracecheck.record_ops`). ``fused`` picks the decode lane
    (the engine's ``use_kernels``), ``fused_prefill`` the prefill lane;
    None follows ``fused`` where the prefill kernel's gate takes the
    shape, as the engine decides it. ``tp > 1`` traces rank 0 of a
    tensor-parallel replica over a fake group of ``tp``. ``meta`` holds
    ``kernels`` (the ``rltt`` kernel operators of each tick) and the
    gathered views: ``dense_paged_gathers`` (decode tick, RLT307's
    evidence) and ``prefill_paged_gathers`` (prefill tick, RLT308's)."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.analysis.tracecheck import (
        Recorder,
        fake_world,
        kernel_calls,
        record_ops,
    )
    from ray_lightning_tpu_torch.models.llama import Llama
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    if fused_prefill is None:
        fused_prefill = fused and _shape_fused_prefill_available(
            model_cfg, engine_cfg, tp)
    validate_pool_tp(model_cfg, tp)
    dev = torch.device(device)
    model = Llama(model_cfg, device="meta")
    C, B, CH = (engine_cfg.capacity, engine_cfg.prefill_batch,
                engine_cfg.prefill_chunk)
    spec = engine_cfg.pool_spec
    M = spec.blocks_per_slot
    with fake_world(tp) as fake, fake:
        model.to_empty(device=dev)
        model.reset_rope_(dev)
        mesh = None
        if tp > 1:
            import torch.distributed as dist

            from ray_lightning_tpu_torch.parallel.tensor import (
                TensorParallel,
            )

            mesh = TensorParallel(group=dist.group.WORLD, size=tp, rank=0)
        engine = DecodeEngine(model, engine_cfg, use_kernels=bool(fused),
                              device=dev, mesh=mesh,
                              max_seq_len_check=False)
        # the lanes as the engine decided them, then the prefill lane as
        # asked (the engine keys both on `use_kernels`)
        if engine.fused_prefill != bool(fused_prefill):
            from ray_lightning_tpu_torch.serve.engine import build_step

            engine.fused_prefill = bool(fused_prefill)
            engine._step = build_step(engine.model, engine_cfg,
                                      fused=engine.fused,
                                      fused_prefill=engine.fused_prefill)
        tables = (1 + np.arange(C * M, dtype=np.int32) % max(
            1, spec.n_blocks - 1)).reshape(C, M)
        pos = np.full(C, M * spec.block_size // 2, np.int32)  # mid-slot
        zeros_f = np.zeros(C, np.float32)
        zeros_i = np.zeros(C, np.int32)
        rngs = np.zeros((C, 2), np.uint32)
        decode_rec, prefill_rec = Recorder(), Recorder()
        for t in (engine.pool_k, engine.pool_v, engine.last_logits,
                  *engine.model.parameters()):
            decode_rec.track(t)
            prefill_rec.track(t)
        from ray_lightning_tpu_torch.serve.engine import idle_prefill

        with torch.no_grad():
            with record_ops(decode_rec):
                engine._step(engine.pool_k, engine.pool_v,
                             engine.last_logits, tables, pos,
                             np.ones(C, bool), zeros_f, zeros_i, rngs,
                             idle_prefill(engine_cfg),
                             zeros_i if B > 1 else None)
            if B > 1:
                prefill = (np.arange(B, dtype=np.int32) % C,
                           np.zeros((B, CH), np.int32), np.int32(0),
                           np.int32(CH - 1), np.zeros(B, np.int32))
            else:
                prefill = (np.int32(0), np.zeros(CH, np.int32),
                           np.int32(0), np.int32(CH - 1))
            with record_ops(prefill_rec):
                engine._step(engine.pool_k, engine.pool_v,
                             engine.last_logits, tables, pos,
                             np.zeros(C, bool), zeros_f, zeros_i, rngs,
                             prefill, zeros_i if B > 1 else None)
        pool_shape = tuple(engine.pool_k.shape)
        dense = _pool_views(decode_rec.events, pool_shape)
        params_by: dict = {}
        for p in engine.model.parameters():
            dt = str(p.dtype).replace("torch.", "")
            params_by[dt] = params_by.get(dt, 0) + p.numel() * \
                p.element_size()
        pool_by = {str(engine.pool_k.dtype).replace("torch.", ""):
                   2 * engine.pool_k.numel() * engine.pool_k.element_size()}
        meta = {
            "fused": engine.fused,
            "fused_prefill": engine.fused_prefill,
            "pool_shape": pool_shape,
            "params_bytes": sum(params_by.values()),
            "params_by": params_by,
            "pool_by": pool_by,
            "kernels": kernel_calls(decode_rec.events
                                    + prefill_rec.events),
            "dense_paged_gathers": dense,
            # the prefill tick runs the decode lane first (every step
            # does): its views are the decode's, the rest the prefill's
            "prefill_paged_gathers": _pool_views(
                prefill_rec.events, pool_shape)[len(dense):],
            "tp": tp,
            "groups": ({} if tp == 1 else {str(dist.group.WORLD.group_name):
                                           ("tensor",)}),
            "mesh_sizes": {"tensor": tp},
        }
    return (decode_rec, prefill_rec), meta


def audit_decode_step(model_cfg, engine_cfg: EngineConfig,
                      topology="h100-1", reserve_fraction: float = 0.10,
                      label: str = "serve decode step",
                      fused: bool = False,
                      fused_prefill: Optional[bool] = None,
                      traced=None, numerics: bool = True, tp: int = 1,
                      device="cpu"):
    """The decode-step audit (the JAX `audit_decode_step`'s rules) as a
    `tracecheck.TraceReport`: the ``rltt`` kernels the step runs, its
    collectives under ``tp > 1`` (the row-parallel all-reduces a tick),
    RLT302 (the traced peak against the device's memory), RLT307 (the
    decode lane gathers a dense capacity-wide view of the pool on a shape
    the paged decode kernel's gate takes) and RLT308 (the prefill lane's
    dense group view on a shape the paged prefill kernel takes). The
    kernel lanes have neither view; shapes the kernels do not take are
    sanctioned. ``traced`` reuses a `trace_decode_step` result with the
    same configuration and lanes."""
    from ray_lightning_tpu_torch.analysis.costmodel import (
        Topology,
        parse_topology,
    )
    from ray_lightning_tpu_torch.analysis.findings import Finding
    from ray_lightning_tpu_torch.analysis.tracecheck import Recorder, audit_ops

    topo = (topology if isinstance(topology, Topology)
            else parse_topology(topology))
    (dec, pre), meta = traced if traced is not None else trace_decode_step(
        model_cfg, engine_cfg, fused=fused, fused_prefill=fused_prefill,
        tp=tp, device=device)
    merged = Recorder()
    merged.events = list(dec.events) + list(pre.events)
    merged.peak = max(dec.peak, pre.peak)
    merged.peak_by = dict(dec.peak_by if dec.peak >= pre.peak
                          else pre.peak_by)
    precision = None
    found = []
    if numerics:
        from ray_lightning_tpu_torch.analysis.numcheck import numcheck_stream

        found += numcheck_stream(dec.events)[0]
        found += numcheck_stream(pre.events)[0]
        params_by, pool_by = meta["params_by"], meta["pool_by"]
        act_by = {dt: b - params_by.get(dt, 0) - pool_by.get(dt, 0)
                  for dt, b in merged.peak_by.items()
                  if b - params_by.get(dt, 0) - pool_by.get(dt, 0) > 0}
        precision = {"params": params_by, "opt_state": {},
                     "activations": act_by, "kv_pool": pool_by,
                     "loss_widest_dtype": None}
    report = audit_ops(
        merged, {**meta, "named_params": {}, "n_devices": tp}, topo,
        params_bytes=meta["params_bytes"], opt_bytes=0,
        reserve_fraction=reserve_fraction, label=label,
        mesh_axes={"tensor": tp} if tp > 1 else {}, precision=precision)
    gib = 1024**3
    itemsize = _itemsize(model_cfg.dtype)

    def view_gib(shape) -> float:
        n = 2 * itemsize
        for d in shape:
            n *= d
        return n / gib

    if meta["dense_paged_gathers"] and _shape_fused_available(
            model_cfg, engine_cfg, tp):
        shape = meta["dense_paged_gathers"][0]
        report.findings.append(Finding(
            "RLT307",
            f"the decode lane gathers a dense {list(shape)} slot view of "
            f"the paged pool every tick (~{view_gib(shape):.2f} GiB of "
            "memory + a full copy of traffic) on a shape the paged "
            "decode kernel (rltt::paged_decode) takes: the kernel reads "
            "the pool through the block tables and retires the view "
            "(DecodeEngine(use_kernels=True), the default on the card)",
            symbol=label))
    if meta["prefill_paged_gathers"] and _shape_fused_prefill_available(
            model_cfg, engine_cfg, tp):
        shape = meta["prefill_paged_gathers"][0]
        report.findings.append(Finding(
            "RLT308",
            f"the prefill lane gathers a dense {list(shape)} group view "
            f"of the paged pool every chunk (~{view_gib(shape):.2f} GiB "
            "of memory + a copy of traffic a chunk) on a shape the paged "
            "prefill kernel (rltt::paged_prefill) takes: the kernel "
            "attends causally through the block tables and retires the "
            "view", symbol=label))
    report.findings.extend(found)
    report.kernels = dict(meta["kernels"])
    return report
