"""The continuous-batching decode engine (twin of
`ray_lightning_tpu/serve/engine.py`).

One tick does two things over fixed shapes, exactly as the JAX step:

  * **decode lane** — for every slot: advance its RNG, sample the next
    token from the slot's carried ``last_logits`` (greedy / temperature
    / top-k by per-slot runtime values), run the model's single-token
    cache path on it, and write its K/V into the pool at ``pos``. Slots
    not in the decode phase are redirected to the scratch block and
    their state is masked through unchanged.
  * **prefill lane** — the head prefill group advances its prompt by one
    fixed-width chunk. The final chunk projects each row's last real
    prompt token through the lm_head into ``last_logits``.

Each lane is picked at build time: the kernel lanes (the model's paged
branches; `ops.attention.paged_attention` / `paged_prefill` consume the
pool through the block tables) or the reference lanes (the model's dense
cache path over a gathered per-slot view — the copy the kernels retire).

Where JAX jits one step and donates the pool through it, this engine
runs eagerly and updates the pool and ``last_logits`` in place. The JAX
step's ``lax.cond`` prefill gate becomes a host ``if``: its inputs are
host numpy. Sampling draws from a per-slot `torch.Generator` seeded from
the slot's [2] uint32 key state, which advances once per emitted token,
so a request's sampled stream depends only on its seed (JAX's threefry
bits are not reproduced; greedy streams match the JAX engine).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
    paged_attention_uses_kernel,
    paged_prefill_uses_kernel,
)
from ray_lightning_tpu_torch.serve.kv_cache import PagedPoolSpec, init_pool
from ray_lightning_tpu_torch.telemetry.metrics import NULL_METRICS
from ray_lightning_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape of one serving replica's step."""

    #: concurrent request slots (the decode lane's fixed batch)
    capacity: int = 8
    #: tokens per pool block
    block_size: int = 16
    #: per-slot block-table width — caps prompt + generation length at
    #: ``blocks_per_slot * block_size``
    blocks_per_slot: int = 8
    #: pool blocks (None = dense worst case: capacity * blocks_per_slot
    #: + scratch). Smaller oversubscribes — the paged bet.
    n_blocks: Optional[int] = None
    #: prefill chunk width: the prefill lane advances this many prompt
    #: tokens per tick
    prefill_chunk: int = 32
    #: prefill lane batch: up to this many queued prompts advance
    #: together, left-padded and right-aligned to a shared chunk-multiple
    #: width. 1 runs the single-slot lane with no pad inputs.
    prefill_batch: int = 1

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if not 1 <= self.prefill_batch <= self.capacity:
            raise ValueError(
                f"prefill_batch {self.prefill_batch} must be within "
                f"[1, capacity={self.capacity}]")
        if self.prefill_chunk > self.blocks_per_slot * self.block_size:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} exceeds "
                f"max_slot_len "
                f"{self.blocks_per_slot * self.block_size}")

    @property
    def pool_spec(self) -> PagedPoolSpec:
        n = self.n_blocks
        if n is None:
            n = 1 + self.capacity * self.blocks_per_slot
        return PagedPoolSpec(n_blocks=n, block_size=self.block_size,
                             blocks_per_slot=self.blocks_per_slot)

    @property
    def max_slot_len(self) -> int:
        return self.pool_spec.gathered_len


# ---- per-slot RNG: [2] uint32 key state, split once per emitted token ----

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _split_key(key: np.ndarray):
    """(next state, draw seed) from one [2] uint32 key state."""
    x = (int(key[0]) << 32) | int(key[1])
    nxt = _mix64(x)
    return (np.array([nxt >> 32, nxt & 0xFFFFFFFF], np.uint32),
            _mix64(x ^ 0xD1B54A32D192ED03) >> 1)


def _sample_one(logits: torch.Tensor, seed: int, temp: float,
                top_k: int) -> torch.Tensor:
    """One sampled token from f32 ``logits [V]`` (temp > 0): temperature
    scaling, an optional k-th-largest threshold filter, then a Gumbel-max
    draw from a generator seeded with ``seed``."""
    scaled = logits / max(temp, float(np.finfo(np.float32).tiny))
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[0])).values[-1]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    g = torch.Generator(device=logits.device)
    g.manual_seed(seed)
    u = torch.rand(scaled.shape, generator=g, device=logits.device,
                   dtype=torch.float32)
    return torch.argmax(scaled - torch.log(-torch.log(u)))


def _sample(last_logits, decoding, temp, top_k, rngs):
    """Emit one token per slot: argmax where temp == 0, a draw from the
    slot's key state elsewhere. The key state advances only for decoding
    slots (idle and prefilling slots hold still)."""
    emitted = torch.argmax(last_logits, dim=-1)
    new_rngs = rngs.copy()
    for s in np.flatnonzero(decoding):
        new_rngs[s], seed = _split_key(rngs[s])
        if temp[s] != 0.0:
            emitted[s] = _sample_one(last_logits[s], seed, float(temp[s]),
                                     int(top_k[s]))
    return emitted, new_rngs


def build_step(model, cfg: EngineConfig, fused: bool = False,
               fused_prefill: bool = False):
    """The continuous-batching step for ``model`` (a `models.llama.Llama`)
    under ``cfg``; lanes fixed at build time:

      * ``fused`` — decode: True runs ONE batched model call whose cache
        is the pool itself (the paged branch + `paged_attention`); False
        the reference lane over a dense gathered view of each slot's
        blocks.
      * ``fused_prefill`` — prefill: True scatters the chunk's K/V into
        owned pool blocks and attends through the tables
        (`paged_prefill`); False gathers the group's blocks into a dense
        view and runs the model's chunked cache path over it.

    The returned ``step(pool_k, pool_v, last_logits, tables, pos,
    decoding, temp, top_k, rngs, prefill, slot_pad)`` updates the pool
    and ``last_logits`` in place and returns ``(emitted [C] device
    tensor, rngs' [C, 2] uint32)``. ``prefill`` is `idle_prefill`'s
    tuple shape; ``slot_pad`` ([C] int32 per-slot left pad) is read on
    the batched lane only."""
    mcfg = model.cfg
    spec = cfg.pool_spec
    L, HKV, HD = mcfg.n_layers, mcfg.n_kv_heads, mcfg.head_dim
    C, P, G, CH = cfg.capacity, spec.block_size, spec.gathered_len, \
        cfg.prefill_chunk
    M = spec.blocks_per_slot
    padded = cfg.prefill_batch > 1
    dev = model.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def write_index(tables, pos, decoding):
        # where this tick's K/V token lands; slots not in the decode
        # phase are redirected to the scratch block
        blk = tables[np.arange(C), np.minimum(pos // P, M - 1)]
        return (np.where(decoding, blk, 0), np.where(decoding, pos % P, 0))

    def decode(pool_k, pool_v, tables, tables_d, pos, decoding, emitted,
               slot_pad):
        bi, off = write_index(tables, pos, decoding)
        pos_d = put(pos)
        if fused:
            # the pool IS the cache: the model's paged branch writes the
            # new K/V at the (scratch-redirected) write index and the
            # kernel reads table-named blocks; no [L, C, G] copy exists
            view = PagedDecodeView(tables=tables_d, lengths=put(pos + 1),
                                   write_block=put(bi),
                                   write_offset=put(off), use_kernel=True)
            return model(emitted[:, None], (pool_k, pool_v), pos_d,
                         pad=slot_pad, paged=view)[:, 0]
        # one dense gathered view per tick — the copy the kernel retires;
        # the reference lane runs every op's plain version
        idx = tables_d.long()
        gk = pool_k[:, idx].reshape(L, C, G, HKV, HD)
        gv = pool_v[:, idx].reshape(L, C, G, HKV, HD)
        with dispatch.force_reference():
            logits = model(emitted[:, None], (gk, gv), pos_d, pad=slot_pad)
        rows = torch.arange(C, device=dev)
        bi_d, off_d = put(bi).long(), put(off).long()
        pool_k[:, bi_d, off_d] = gk[:, rows, pos_d.long()]
        pool_v[:, bi_d, off_d] = gv[:, rows, pos_d.long()]
        return logits[:, 0]

    def do_prefill(pool_k, pool_v, last_logits, tables, prefill):
        if padded:
            slots, toks, ppos, last_row, ppad = prefill
            active = slots >= 0
            rows = np.where(active[:, None], tables[np.maximum(slots, 0)],
                            0)
            pad = put(ppad)
        else:
            slot, toks, ppos, last_row = prefill
            slots, active = np.array([slot]), np.array([True])
            rows, toks, pad = tables[slot][None], toks[None], None
        ppos, last_row = int(ppos), int(last_row)
        nb = rows.shape[0]
        wpos = ppos + np.arange(CH)
        wbi = rows[:, wpos // P]
        woff = np.broadcast_to(wpos % P, (nb, CH))
        rows_d, toks_d = put(rows), put(toks)
        if fused_prefill:
            # the pool IS the cache: the chunk is written into owned
            # blocks (vacant rows carry all-scratch tables) and the
            # kernel attends causally through the tables. The full
            # CH-wide write is safe past a partial tail chunk: tail
            # garbage lands in owned blocks and is overwritten before
            # any mask exposes it.
            view = PagedPrefillView(tables=rows_d, write_block=put(wbi),
                                    write_offset=put(woff), use_kernel=True)
            h = model.hidden(toks_d, (pool_k, pool_v), ppos, pad=pad,
                             paged=view)
        else:
            idx = rows_d.long()
            kc = pool_k[:, idx].reshape(L, nb, G, HKV, HD)
            vc = pool_v[:, idx].reshape(L, nb, G, HKV, HD)
            with dispatch.force_reference():  # incl. flash at pos 0
                h = model.hidden(toks_d, (kc, vc), ppos, pad=pad)
            wbi_d, woff_d = put(wbi).long(), put(woff).long()
            pool_k[:, wbi_d, woff_d] = kc[:, :, ppos:ppos + CH]
            pool_v[:, wbi_d, woff_d] = vc[:, :, ppos:ppos + CH]
        if last_row >= 0:
            # the chunk that ends every row's prompt: project the last
            # real token of each active row into its slot's logits
            done = model.logits(h[:, last_row])
            for r in np.flatnonzero(active):
                last_logits[int(slots[r])] = done[r]

    def step(pool_k, pool_v, last_logits, tables, pos, decoding, temp,
             top_k, rngs, prefill, slot_pad=None):
        tables_d = put(tables)
        # ---- decode lane: sample, then advance every slot ------------
        emitted, new_rngs = _sample(last_logits, decoding, temp, top_k,
                                    rngs)
        logits2 = decode(pool_k, pool_v, tables, tables_d, pos, decoding,
                         emitted, put(slot_pad) if padded else None)
        dec = torch.from_numpy(np.asarray(decoding, bool)).to(dev)
        last_logits.copy_(torch.where(dec[:, None], logits2, last_logits))
        # ---- prefill lane: one chunk for the head group --------------
        if (np.asarray(prefill[0]) >= 0).any():
            do_prefill(pool_k, pool_v, last_logits, tables, prefill)
        return emitted, new_rngs

    return step


def _copy_pool_block(pool_k, pool_v, src: int, dst: int) -> None:
    """Copy one block's K/V in place — the copy-on-write fork primitive
    (the JAX twin returns new pools through a donated jit)."""
    pool_k[:, dst] = pool_k[:, src]
    pool_v[:, dst] = pool_v[:, src]


def idle_prefill(cfg: EngineConfig):
    """The step's no-prefill sentinel: (slot, tokens, pos, last_row) for
    the single-slot lane, (slots, tokens, pos, last_row, pads) for the
    batched lane."""
    if cfg.prefill_batch == 1:
        return (np.int32(-1), np.zeros(cfg.prefill_chunk, np.int32),
                np.int32(0), np.int32(-1))
    B = cfg.prefill_batch
    return (np.full(B, -1, np.int32),
            np.zeros((B, cfg.prefill_chunk), np.int32),
            np.int32(0), np.int32(-1), np.zeros(B, np.int32))


class DecodeEngine:
    """One replica's step + its device-resident buffers (``pool_k``,
    ``pool_v``, ``last_logits``). The host-side request state lives in
    `serve.scheduler`.

    ``use_kernels`` picks the lanes once, here: None follows the
    dispatch policy for the device (the kernel lanes on CUDA unless a
    `dispatch.force_reference` context is active), True the kernel lanes
    (on the CPU their wrappers run the plain versions), False the
    reference lanes — the twin of the JAX engine's ``use_pallas``. A
    kernel lane also needs the kernel's shape gate to pass: on the CPU a
    refused shape takes the reference lane, on CUDA it raises (the card
    runs the reference lanes only when ``use_kernels=False`` or a
    `dispatch.force_reference` context asks for them)."""

    def __init__(self, model, cfg: EngineConfig,
                 use_kernels: Optional[bool] = None, device=None,
                 metrics=None, mesh=None, draft_model=None,
                 draft_params=None, max_seq_len_check: bool = True):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel replicas (mesh=) are not ported yet "
                "(ROADMAP Queue 1 items 4 and 8)")
        if draft_model is not None or draft_params is not None:
            raise NotImplementedError(
                "speculative decoding (draft=) is not ported yet "
                "(ROADMAP Queue 1 item 8)")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"asked for {dev}")
        if max_seq_len_check and cfg.max_slot_len > model.cfg.max_seq_len:
            raise ValueError(
                f"engine max_slot_len {cfg.max_slot_len} exceeds the "
                f"model's max_seq_len {model.cfg.max_seq_len} — RoPE "
                "tables would be read out of range")
        self.model = model
        self.cfg = cfg
        self.spec = cfg.pool_spec
        mcfg = model.cfg
        if use_kernels is None:
            use_kernels = dispatch.use_kernel(dev)
        pool_shape = (self.spec.n_blocks, self.spec.block_size,
                      mcfg.n_kv_heads, mcfg.head_dim)
        self.fused = paged_attention_uses_kernel(
            (cfg.capacity, mcfg.n_heads, mcfg.head_dim), pool_shape,
            use_kernels, dev)
        self.fused_prefill = paged_prefill_uses_kernel(
            (cfg.prefill_batch, cfg.prefill_chunk, mcfg.n_heads,
             mcfg.head_dim), pool_shape, use_kernels, dev)
        self._step = build_step(model, cfg, fused=self.fused,
                                fused_prefill=self.fused_prefill)
        self.pool_k, self.pool_v = init_pool(mcfg, self.spec,
                                             model.device)
        self.last_logits = torch.zeros((cfg.capacity, mcfg.vocab_size),
                                       dtype=torch.float32,
                                       device=model.device)
        self.steps = 0
        self.metrics = metrics if metrics is not None else NULL_METRICS

    @property
    def attention_path(self) -> str:
        """Which decode attention this replica runs."""
        return "paged-kernel" if self.fused else "reference-gather"

    @property
    def prefill_path(self) -> str:
        """Which prefill attention this replica runs."""
        return "paged-kernel" if self.fused_prefill else "reference-gather"

    def warmup(self) -> None:
        """One idle tick on the zero pool (first-call set-up: kernel
        builds, allocator growth) before the replica is marked live."""
        C = self.cfg.capacity
        self.tick(
            tables=np.zeros((C, self.spec.blocks_per_slot), np.int32),
            pos=np.zeros(C, np.int32),
            decoding=np.zeros(C, bool),
            temp=np.zeros(C, np.float32),
            top_k=np.zeros(C, np.int32),
            rngs=np.zeros((C, 2), np.uint32),
            prefill=idle_prefill(self.cfg),
            pad=np.zeros(C, np.int32),
        )

    def copy_block(self, src: int, dst: int) -> None:
        """Copy pool block ``src`` into ``dst`` (K and V): the
        scheduler's copy-on-write fork."""
        with torch.no_grad():
            _copy_pool_block(self.pool_k, self.pool_v, int(src), int(dst))

    def tick(self, tables, pos, decoding, temp, top_k, rngs, prefill,
             pad=None):
        """Run one step; returns ``(toks [C, 1] i32 np, n_emit [C] i32
        np, rngs' [C, 2] u32 np)``: ``toks[s, 0]`` is slot s's token
        this tick where ``n_emit[s]`` (the decoding mask). ``pad`` ([C]
        per-slot left pad) is read on the batched-prefill lane only."""
        decoding = np.asarray(decoding, bool)
        if self.cfg.prefill_batch > 1 and pad is None:
            pad = np.zeros(self.cfg.capacity, np.int32)
        with torch.no_grad():
            emitted, new_rngs = self._step(
                self.pool_k, self.pool_v, self.last_logits,
                np.asarray(tables, np.int32), np.asarray(pos, np.int32),
                decoding, np.asarray(temp, np.float32),
                np.asarray(top_k, np.int32), np.asarray(rngs, np.uint32),
                prefill, pad)
        emitted = emitted.to(torch.int32).cpu().numpy()
        self.steps += 1
        m = self.metrics
        if m.enabled:
            n_dec = int(decoding.sum())
            n_pf_rows = int(np.sum(np.asarray(prefill[0]) >= 0))
            if n_dec:
                m.count("decode_tokens", n_dec)
            if n_pf_rows:
                m.count("prefill_tokens",
                        n_pf_rows * self.cfg.prefill_chunk)
            m.gauge("engine_steps", self.steps)
        return emitted[:, None], decoding.astype(np.int32), new_rngs
