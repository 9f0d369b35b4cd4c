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
  * `format_serve_summary` — the table ``plan --serve`` prints.

The model is built on the meta device (shapes and dtypes, no storage),
so a term is the live engine's bytes exactly: the serving model stores
its matmul weights and embedding in ``cfg.dtype`` and its norm gains in
f32, where the JAX plan counts every parameter in its param dtype. The
JAX module's decode-step audit (``trace_decode_step``,
``audit_decode_step``, jaxpr walks) waits for ROADMAP Queue 1 item 13
(f).
"""
from __future__ import annotations

from typing import Optional

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


def paged_decode_traffic_bytes(pool_bytes: int, gathered_view_bytes: int,
                               fused: bool) -> int:
    """The decode lane's KV bytes moved a tick (the JAX cost model's): the
    paged kernel reads the pool once; the reference lane also writes the
    dense gathered view and reads it back. Conservative: the whole pool
    is charged even when slots are idle."""
    if fused:
        return int(pool_bytes)
    return int(pool_bytes + 2 * gathered_view_bytes)


def paged_prefill_traffic_bytes(group_view_bytes: int, chunk_bytes: int,
                                fused: bool) -> int:
    """The prefill lane's KV bytes moved a chunk: the group's blocks read
    once and the chunk's K/V written; the reference lane also writes the
    group's view and reads it back."""
    if fused:
        return int(group_view_bytes + chunk_bytes)
    return int(3 * group_view_bytes + chunk_bytes)


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
