"""Block-size autotune for both paged kernels (twin of
`ray_lightning_tpu/serve/sweep.py`).

The pool's ``block_size`` is the granularity at which both kernels look a
cache position's block up in the slot's table, and (through
``blocks_per_slot = span / block_size``) the tables' width: what runs
fastest is a question of the card, so this module measures it.

  * **correctness** — every candidate geometry runs both kernels'
    wrappers on a seeded random case (ragged lengths and pads, a table
    tail past the written length, a forked table whose slots alias one
    prefix chain, and the speculative verify's k-wide chunk) and holds
    each against a version it does not share code with: on the card the
    CUDA kernel against its plain PyTorch version, in the model's dtype,
    under the element rule ``|a - b| <= 2e-2 * rms(b's row) + 2e-2 *
    |b|``; on the CPU, where the wrapper runs the plain version, that
    against the gathered reference (`ops.attention.paged_*_reference`)
    in f32 within 2e-5, the JAX sweep's bound;
  * **timing** — on CUDA only, each correct candidate's kernels are
    timed with CUDA events (median of ``repeats`` calls, a 64 MiB buffer
    rewritten before each so L2 starts cold, and the card held busy by a
    sleep kernel while the host enqueues the call, so the events time
    the device and not the wrapper's host work). Elsewhere the entry
    records why it was not timed, as the JAX sweep records its
    off-TPU skip: no number is invented.

The result is a JSON artifact keyed by the model's attention shape that
`apply_autotune(engine_cfg, artifact)` turns into an `EngineConfig` at
the winning geometry (the per-slot span held constant).
``python -m ray_lightning_tpu_torch serve <preset> --autotune out.json``
writes one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Optional, Sequence

__all__ = [
    "DEFAULT_BLOCK_SIZES", "SweepCandidate", "candidate_grid",
    "model_fingerprint", "sweep_paged_kernels", "save_artifact",
    "load_artifact", "apply_autotune",
]

#: candidate block widths in tokens (the JAX sweep's: 8 is its sublane
#: floor; the CUDA kernels take any width, so the grid is kept for a
#: like-for-like sweep)
DEFAULT_BLOCK_SIZES = (8, 16, 32, 64, 128, 256)

#: the speculative verify's chunk width in the shared-prefix cell
#: (`engine.DraftConfig`'s default k)
VERIFY_K = 4
#: the card's element rule (the bf16 kernels against their plain
#: versions; `chip_smoke.py` holds every kernel to it)
RTOL = ATOL_RMS = 2e-2
#: the CPU's bound (f32 plain version against the gathered reference)
F32_ATOL = 2e-5
#: the L2-flush buffer rewritten before each timed call
_FLUSH_BYTES = 64 << 20
#: cycles of the sleep kernel that holds the card busy while the host
#: enqueues a timed call (about 10 ms)
_SLEEP_CYCLES = 20_000_000


@dataclasses.dataclass(frozen=True)
class SweepCandidate:
    """One pool geometry under test; the per-slot span (``block_size *
    blocks_per_slot``) is the same for every candidate."""

    block_size: int
    blocks_per_slot: int

    @property
    def span(self) -> int:
        return self.block_size * self.blocks_per_slot


def candidate_grid(engine_cfg,
                   block_sizes: Optional[Sequence[int]] = None) -> list:
    """Candidate geometries keeping ``engine_cfg``'s per-slot span: a
    block size qualifies when it divides the span and is a multiple of 8
    (the JAX grid's rule, kept so both packages sweep the same
    geometries). The incumbent is always in the grid."""
    span = engine_cfg.block_size * engine_cfg.blocks_per_slot
    sizes = sorted(set(block_sizes or DEFAULT_BLOCK_SIZES)
                   | {engine_cfg.block_size})
    return [SweepCandidate(block_size=bs, blocks_per_slot=span // bs)
            for bs in sizes
            if bs >= 8 and bs % 8 == 0 and bs <= span
            and span % bs == 0]


def model_fingerprint(model_cfg) -> str:
    """The attention shape an artifact is valid for (the JAX string: the
    dtype by its numpy name)."""
    dtype = str(model_cfg.dtype).removeprefix("torch.")
    return (f"L{model_cfg.n_layers}-H{model_cfg.n_heads}"
            f"-KV{model_cfg.n_kv_heads}-hd{model_cfg.head_dim}-{dtype}")


def case_inputs(model_cfg, engine_cfg, cand: SweepCandidate, device,
                dtype, seed: int = 0, full: bool = False) -> dict:
    """The seeded inputs of one candidate's case on ``device`` in
    ``dtype``: a pool whose slots own distinct blocks, decode queries
    with ragged lengths (``full``: every slot at the whole span, the
    timing case) and a CH-wide prefill chunk mid-slot with ragged pads
    (``full``: ending at the span), a table whose slots alias slot 0's
    first half (the prefix cache's fork) and a k-wide verify chunk."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    H, HKV, HD = (model_cfg.n_heads, model_cfg.n_kv_heads,
                  model_cfg.head_dim)
    P, M = cand.block_size, cand.blocks_per_slot
    C = engine_cfg.capacity if full else min(engine_cfg.capacity, 4)
    B = min(engine_cfg.prefill_batch, C)
    CH = min(engine_cfg.prefill_chunk, cand.span)
    n_blocks = 1 + C * M

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)

    i32 = torch.int32
    tables = (1 + (np.arange(C * M) % (n_blocks - 1))).reshape(C, M)
    forked = tables.copy()
    forked[:, :max(1, M // 2)] = forked[0, :max(1, M // 2)]
    lengths = (np.full(C, cand.span) if full
               else rng.integers(1, cand.span + 1, size=C))
    pos = (max(0, cand.span - CH) if full
           else max(0, min(cand.span - CH, cand.span // 2)))
    vpos = max(0, min(cand.span - VERIFY_K, cand.span // 2))
    return dict(
        pool_k=t(rng.normal(size=(n_blocks, P, HKV, HD))),
        pool_v=t(rng.normal(size=(n_blocks, P, HKV, HD))),
        tables=t(tables, i32), forked=t(forked, i32),
        q1=t(rng.normal(size=(C, H, HD))), lengths=t(lengths, i32),
        pads=t(np.zeros(C), i32),
        qc=t(rng.normal(size=(B, CH, H, HD))), pos=pos,
        pad=t([0 if full else min(i * 2, max(pos - 1, 0))
               for i in range(B)], i32),
        qk=t(rng.normal(size=(B, VERIFY_K, H, HD))), vpos=vpos,
        vpad=t(np.zeros(B), i32))


def kernel_calls(x: dict, use_kernel: bool = True) -> dict:
    """The case's four calls, ``{name: thunk}``: the kernel wrappers
    (``use_kernel``) or their plain versions."""
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as pa
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as pp

    dec = pa.paged_attention_kernel if use_kernel else \
        pa.paged_attention_plain
    pre = pp.paged_prefill_kernel if use_kernel else \
        pp.paged_prefill_plain
    B = x["qc"].shape[0]
    return {
        "decode": lambda: dec(x["q1"], x["pool_k"], x["pool_v"],
                              x["tables"], x["lengths"], pad=x["pads"]),
        "prefill": lambda: pre(x["qc"], x["pool_k"], x["pool_v"],
                               x["tables"][:B].contiguous(), x["pos"],
                               pad=x["pad"]),
        "shared": lambda: dec(x["q1"], x["pool_k"], x["pool_v"],
                              x["forked"], x["lengths"], pad=x["pads"]),
        "verify_chunk": lambda: pre(x["qk"], x["pool_k"], x["pool_v"],
                                    x["forked"][:B].contiguous(),
                                    x["vpos"], pad=x["vpad"]),
    }


def _references(x: dict) -> dict:
    """The gathered-SDPA references of the case's four calls."""
    from ray_lightning_tpu_torch.ops.attention import (
        paged_attention_reference,
        paged_prefill_reference,
    )

    B = x["qc"].shape[0]
    return {
        "decode": paged_attention_reference(
            x["q1"], x["pool_k"], x["pool_v"], x["tables"], x["lengths"],
            x["pads"]),
        "prefill": paged_prefill_reference(
            x["qc"], x["pool_k"], x["pool_v"], x["tables"][:B], x["pos"],
            pad=x["pad"]),
        "shared": paged_attention_reference(
            x["q1"], x["pool_k"], x["pool_v"], x["forked"], x["lengths"],
            x["pads"]),
        "verify_chunk": paged_prefill_reference(
            x["qk"], x["pool_k"], x["pool_v"], x["forked"][:B], x["vpos"],
            pad=x["vpad"]),
    }


def element_share(got, want) -> float:
    """The largest share of its allowance any element of ``got`` uses
    under the card's element rule (a row: the last dimension); infinite
    for a non-finite output."""
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    share = torch.where(err == 0, torch.zeros_like(err),
                        err / (ATOL_RMS * rms + RTOL * want.abs()))
    return share.max().item()


def _correctness_case(model_cfg, engine_cfg, cand: SweepCandidate,
                      device, seed: int = 0) -> dict:
    """Both kernels on this candidate's geometry (module docstring).
    Returns ``{"decode", "prefill", "shared_spec"}``, each ``{"ok",
    "max_err"}`` (the shared cell with its ``verify_chunk``), or
    ``{"ok": False, "error"}`` when a call fails."""
    import torch

    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_shapes_supported,
    )
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_shapes_supported,
    )

    on_card = torch.device(device).type == "cuda"
    dtype = model_cfg.dtype if on_card else torch.float32
    x = case_inputs(model_cfg, engine_cfg, cand, device, dtype, seed)
    pool = tuple(x["pool_k"].shape)
    supported = {
        "decode": paged_shapes_supported(tuple(x["q1"].shape), pool),
        "prefill": paged_prefill_shapes_supported(tuple(x["qc"].shape),
                                                  pool),
    }
    supported["shared"] = supported["decode"]
    supported["verify_chunk"] = paged_prefill_shapes_supported(
        tuple(x["qk"].shape), pool)
    got = kernel_calls(x)
    want = kernel_calls(x, use_kernel=False) if on_card else None
    refs = None if on_card else _references(x)
    cells = {}
    for name, call in got.items():
        if not supported[name]:
            cells[name] = {"ok": False,
                           "error": "shape not supported by the kernel"}
            continue
        try:
            with torch.no_grad():
                out = call()
                ref = want[name]() if on_card else refs[name]
            err = float((out.float() - ref.float()).abs().max())
            ok = (element_share(out, ref) <= 1.0 if on_card
                  else err < F32_ATOL)
            cells[name] = {"ok": bool(ok), "max_err": err}
        except Exception as exc:  # noqa: BLE001 — recorded, not raised
            cells[name] = {"ok": False, "error": f"{type(exc).__name__}: "
                                                 f"{str(exc)[:160]}"}
    shared = dict(cells["shared"])
    shared["verify_chunk"] = cells["verify_chunk"]
    shared["ok"] = bool(shared["ok"] and cells["verify_chunk"]["ok"])
    return {"decode": cells["decode"], "prefill": cells["prefill"],
            "shared_spec": shared}


def _time_candidate(model_cfg, engine_cfg, cand: SweepCandidate, device,
                    repeats: int = 5) -> dict:
    """The median device ms of each kernel at this candidate over the
    engine's whole capacity, every slot at the full span, CUDA events
    around each call, L2 flushed before it and the call enqueued behind
    a sleep kernel. CUDA only."""
    import torch

    x = case_inputs(model_cfg, engine_cfg, cand, device, model_cfg.dtype,
                    seed=1, full=True)
    calls = kernel_calls(x)
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=device)

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(repeats):
            flush.zero_()
            torch.cuda._sleep(_SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    with torch.no_grad():
        return {"decode_ms": median_ms(calls["decode"]),
                "prefill_ms": median_ms(calls["prefill"])}


def _device_name(device) -> str:
    import torch

    dev = torch.device(device)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def sweep_paged_kernels(model_cfg, engine_cfg, *,
                        block_sizes: Optional[Sequence[int]] = None,
                        device=None, repeats: int = 5) -> dict:
    """Run the sweep on ``device`` (default the CUDA card; ``"cpu"`` for
    the correctness leg only) and return the artifact. The winner is the
    fastest candidate whose every cell passed (decode + prefill ms);
    without timing the incumbent wins, labelled ``winner_source:
    "default-untimed"``."""
    import torch

    from ray_lightning_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    timed = dev.type == "cuda"
    results = []
    for cand in candidate_grid(engine_cfg, block_sizes):
        entry = {"block_size": cand.block_size,
                 "blocks_per_slot": cand.blocks_per_slot,
                 **_correctness_case(model_cfg, engine_cfg, cand, dev)}
        ok = all(entry[k].get("ok")
                 for k in ("decode", "prefill", "shared_spec"))
        if timed and ok:
            try:
                entry["timing"] = _time_candidate(
                    model_cfg, engine_cfg, cand, dev, repeats=repeats)
            except Exception as exc:  # noqa: BLE001 — recorded
                entry["timing"] = {
                    "error": f"{type(exc).__name__}: {str(exc)[:160]}"}
        elif not timed:
            entry["timing"] = {
                "skipped": f"no CUDA device ({dev.type}): the kernels "
                           "are timed on the card only"}
        else:
            entry["timing"] = {"skipped": "failed correctness"}
        results.append(entry)
    passing = [r for r in results
               if all(r[k].get("ok")
                      for k in ("decode", "prefill", "shared_spec"))]
    measured = [r for r in passing if "decode_ms" in r["timing"]]
    winner = source = None
    if measured:
        best = min(measured, key=lambda r: (r["timing"]["decode_ms"]
                                            + r["timing"]["prefill_ms"]))
        source = "measured"
    elif passing:
        incumbent = [r for r in passing
                     if r["block_size"] == engine_cfg.block_size]
        best = incumbent[0] if incumbent else passing[0]
        source = "default-untimed"
    if source is not None:
        winner = {"block_size": best["block_size"],
                  "blocks_per_slot": best["blocks_per_slot"]}
    return {
        "kind": "rlt-paged-kernel-autotune",
        "model": model_fingerprint(model_cfg),
        "device": _device_name(dev),
        "torch": torch.__version__,
        "span": engine_cfg.block_size * engine_cfg.blocks_per_slot,
        "capacity": engine_cfg.capacity,
        "prefill_chunk": engine_cfg.prefill_chunk,
        "prefill_batch": engine_cfg.prefill_batch,
        "results": results,
        "winner": winner,
        "winner_source": source,
    }


def save_artifact(artifact: dict, path: str) -> None:
    """Atomic JSON write (a temporary file, then a rename): a killed sweep
    never leaves a torn artifact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_artifact(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "rlt-paged-kernel-autotune":
        raise ValueError(
            f"{path} is not a paged-kernel autotune artifact "
            f"(kind={doc.get('kind')!r})")
    return doc


def apply_autotune(engine_cfg, artifact: dict, *, model_cfg=None):
    """``engine_cfg`` at the artifact's winning geometry. Refuses an
    artifact with no winner, a per-slot span other than the config's,
    or (given ``model_cfg``) another model's attention shape."""
    winner = artifact.get("winner")
    if not winner:
        raise ValueError(
            "autotune artifact has no winner (no candidate passed "
            "correctness) — refusing to re-geometry the engine")
    if model_cfg is not None:
        want = model_fingerprint(model_cfg)
        if artifact.get("model") != want:
            raise ValueError(
                f"autotune artifact was swept for model "
                f"{artifact.get('model')!r}, not {want!r}")
    span = engine_cfg.block_size * engine_cfg.blocks_per_slot
    if artifact.get("span") != span:
        raise ValueError(
            f"autotune artifact span {artifact.get('span')} != engine "
            f"span {span} — swept for a different slot geometry")
    return dataclasses.replace(
        engine_cfg, block_size=winner["block_size"],
        blocks_per_slot=winner["blocks_per_slot"])
