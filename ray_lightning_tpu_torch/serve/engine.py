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

Speculative decoding (``EngineConfig(draft=DraftConfig(k))``,
`build_spec_step`) and tensor-parallel replicas (``DecodeEngine(mesh=)``,
`serving_param_shardings`) are the JAX engine's, with the same gates.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
    paged_attention_uses_kernel,
    paged_prefill_uses_kernel,
)
from ray_lightning_tpu_torch.serve.kv_cache import (
    PagedPoolSpec,
    init_pool,
    validate_pool_tp,
)
from ray_lightning_tpu_torch.telemetry.metrics import NULL_METRICS
from ray_lightning_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """Speculative decoding: a small DRAFT model proposes ``k - 1`` greedy
    tokens a tick and the target verifies all ``k`` (the carried token
    plus the proposals) in ONE k-wide chunk. Greedy accept keeps the
    stream token for token that of plain greedy decode; ``k = 1`` is the
    base engine's arithmetic (no proposals, one verify row)."""

    #: tokens verified a tick (1 carried + k-1 draft proposals)
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"draft k must be >= 1, got {self.k}")


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
    #: speculative decoding (None = the base single-token step). Set, the
    #: engine needs a draft model at construction and runs
    #: `build_spec_step`; the scheduler admits greedy requests only and
    #: charges the k-1 slot headroom (`scheduler.validate_request`)
    draft: Optional[DraftConfig] = None

    def __post_init__(self):
        if isinstance(self.draft, dict):
            # the dataclasses.asdict round trip a config takes to a
            # process replica
            object.__setattr__(self, "draft", DraftConfig(**self.draft))
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
        if self.draft is not None and self.prefill_batch != 1:
            raise ValueError(
                "speculative decoding (draft=...) requires "
                "prefill_batch == 1 — the verify chunk rides the "
                "single-slot program")
        if self.draft is not None and \
                self.draft.k > self.blocks_per_slot * self.block_size:
            raise ValueError(
                f"draft k {self.draft.k} exceeds max_slot_len "
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
    L, HKV, HD = mcfg.n_layers, _local_kv_heads(model), mcfg.head_dim
    C, P, G, CH = cfg.capacity, spec.block_size, spec.gathered_len, \
        cfg.prefill_chunk
    M = spec.blocks_per_slot
    padded = cfg.prefill_batch > 1
    dev = model.device
    put = _putter(dev)

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


def _local_kv_heads(model) -> int:
    """The KV heads a rank's pool holds: all of them off the tensor axis,
    ``Hkv / tp`` on it."""
    tp = model.tp
    return model.cfg.n_kv_heads // (tp.size if tp is not None else 1)


def _putter(dev):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return put


def build_spec_step(model, draft_model, cfg: EngineConfig,
                    reference: bool = False):
    """The speculative twin of `build_step` (JAX `build_spec_step`):
    single-slot prefill lane, reference attention lanes. Per tick, per
    decoding slot, with ``k = cfg.draft.k``:

      1. ``t0`` is sampled from ``last_logits`` exactly as the base step
         samples (the scheduler admits greedy requests only);
      2. the DRAFT runs ``k`` single-token trips over its own paged pool
         (the same block tables), fed ``[t0, d1..d_{k-1}]``, writing its
         K/V at ``pos..pos+k-1``; the k-th proposal is discarded;
      3. the TARGET verifies the chunk ``[t0, d1..d_{k-1}]`` in ONE
         k-wide call through its dense cache path, writing its K/V at
         ``pos..pos+k-1``; ``g_{j+1} = argmax(l_j)`` is what plain greedy
         decode would emit after position ``pos+j``;
      4. greedy accept: ``m`` is the longest prefix with ``d_j == g_j``
         (the cumprod of the matches); the slot emits ``[t0, g_1..g_m]``
         (``n_emit = 1 + m``) and carries ``last_logits = l_m``, so
         ``g_{m+1}`` is the next tick's ``t0``. K/V written past
         ``pos+m`` came from rejected tokens: causally masked and
         overwritten before the stream reaches it.

    The prefill lane runs the chunk through the target AND the draft, so
    the draft's cache tracks the target position for position.

    The lanes are the JAX engine's: the verify chunk, the draft trips and
    the prefill chunk take the dense cache path's masked attention over
    a gathered view (every row at its own ``pos``), because the paged
    kernels take one token a slot or one ``pos`` a chunk. This is the
    design, not a fallback; what the lanes cost is priced by
    `serve.audit.speculative_plan`. The other kernels (RMSNorm in every
    model call on the card) run as dispatch decides, unless
    ``reference`` forces the plain versions (the engine's
    ``use_kernels=False``).

    The returned ``step(pool_k, pool_v, dpool_k, dpool_v, last_logits,
    tables, pos, decoding, temp, top_k, rngs, prefill)`` updates both
    pools and ``last_logits`` in place and returns ``(toks [C, k],
    n_emit [C], rngs' [C, 2])``, the first two on the device."""
    if cfg.prefill_batch != 1 or cfg.draft is None:
        raise ValueError("build_spec_step needs cfg.draft and "
                         "prefill_batch == 1")
    mcfg, dcfg = model.cfg, draft_model.cfg
    spec = cfg.pool_spec
    C, P, G, CH = cfg.capacity, spec.block_size, spec.gathered_len, \
        cfg.prefill_chunk
    M, K = spec.blocks_per_slot, cfg.draft.k
    dev = model.device
    put = _putter(dev)
    policy = dispatch.force_reference if reference else contextlib.nullcontext
    rows = torch.arange(C, device=dev)

    def gather(pool_k, pool_v, idx, mc):
        n = idx.shape[0]
        shape = (mc.n_layers, n, G, mc.n_kv_heads, mc.head_dim)
        return (pool_k[:, idx].reshape(shape),
                pool_v[:, idx].reshape(shape))

    def scatter(pool_k, pool_v, view, bi, off, at):
        # the view's positions ``at`` [n, w] land at pool (bi, off)
        r = torch.arange(at.shape[0], device=dev)[:, None]
        pool_k[:, bi, off] = view[0][:, r, at]
        pool_v[:, bi, off] = view[1][:, r, at]

    def step(pool_k, pool_v, dpool_k, dpool_v, last_logits, tables, pos,
             decoding, temp, top_k, rngs, prefill):
        idx = put(tables).long()
        dec = torch.from_numpy(np.asarray(decoding, bool)).to(dev)
        # rows not decoding run at position 0 and write the scratch block
        at = np.where(decoding, pos, 0)
        wp = at[:, None] + np.arange(K)[None, :]
        bi = put(np.where(decoding[:, None], np.take_along_axis(
            tables, np.minimum(wp // P, M - 1), axis=1), 0)).long()
        off = put(np.where(decoding[:, None], wp % P, 0)).long()
        wp_d = put(wp).long()
        # ---- t0: the carried token, sampled as the base step does -----
        t0, new_rngs = _sample(last_logits, decoding, temp, top_k, rngs)
        with policy():
            # ---- draft lane: K single-token trips, one gathered view -
            dview = gather(dpool_k, dpool_v, idx, dcfg)
            tok, chunk = t0, []
            for j in range(K):
                chunk.append(tok)
                dlogits = draft_model(tok[:, None], dview, wp_d[:, j])
                tok = torch.argmax(dlogits[:, 0], dim=-1)
            scatter(dpool_k, dpool_v, dview, bi, off, wp_d)
            chunk = torch.stack(chunk, dim=1)          # [C, K]
            # ---- verify lane: ONE K-wide target chunk a slot ---------
            view = gather(pool_k, pool_v, idx, mcfg)
            vlogits = model(chunk, view, wp_d[:, 0])  # [C, K, V]
            scatter(pool_k, pool_v, view, bi, off, wp_d)
        # ---- greedy accept -------------------------------------------
        g = torch.argmax(vlogits, dim=-1)               # [C, K]
        ok = torch.cumprod((chunk[:, 1:] == g[:, :-1]).long(), dim=1)
        m = ok.sum(dim=1)
        n_emit = torch.where(dec, 1 + m, torch.zeros_like(m))
        toks = torch.cat([t0[:, None], g[:, :-1]], dim=1)
        picked = vlogits[rows, m]
        last_logits.copy_(torch.where(dec[:, None], picked, last_logits))
        # ---- prefill lane: the chunk through target AND draft --------
        slot, ptoks, ppos, last_row = prefill
        slot, ppos, last_row = int(slot), int(ppos), int(last_row)
        if slot >= 0:
            row = idx[slot:slot + 1]
            wpos = ppos + np.arange(CH)
            wbi = row[0, put(wpos // P).long()][None]
            woff = put(wpos % P).long()[None]
            at_d = put(wpos[None]).long()
            toks_d = put(np.asarray(ptoks)[None])
            pos_d = put([ppos]).long()
            with policy():
                tview = gather(pool_k, pool_v, row, mcfg)
                h = model.hidden(toks_d, tview, pos_d)
                scatter(pool_k, pool_v, tview, wbi, woff, at_d)
                # the draft's logits are unused here: its first proposal
                # each tick is fed t0
                dview = gather(dpool_k, dpool_v, row, dcfg)
                draft_model.hidden(toks_d, dview, pos_d)
                scatter(dpool_k, dpool_v, dview, wbi, woff, at_d)
                if last_row >= 0:
                    last_logits[slot] = model.logits(h[:, last_row])[0]
        return toks, n_emit, new_rngs

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


def serving_param_specs(model, params=None,
                        axis_names=("tensor",)) -> List[Tuple[str, tuple]]:
    """``(name, spec)`` for each of the serving model's weights, in state
    dict order (twin of the JAX `serving_param_specs`): the published
    placement of `models.llama.llama_param_specs` (per-dimension mesh
    axes, ``()`` replicated), every unknown leaf and every spec naming an
    axis outside ``axis_names`` replicated: serving meshes are
    tensor-only. ``params`` (a state dict) defaults to the model's."""
    from ray_lightning_tpu_torch.models.llama import llama_param_specs

    specs = llama_param_specs(model.cfg)
    axes = set(axis_names)
    out = []
    for name in (params if params is not None else model.state_dict()):
        spec = specs.get(name, ())
        if any(ax is not None and ax not in axes for ax in spec):
            spec = ()
        out.append((name, spec))
    return out


def serving_param_shardings(model, params, mesh) -> Dict[str, torch.Tensor]:
    """This rank's piece of each weight of ``params`` (a state dict with
    every weight whole) under `serving_param_specs`, for the tensor group
    ``mesh`` (a `parallel.tensor.TensorParallel`): a split dimension is
    chunked as `parallel.strategy.ShardedMesh` chunks it, the fused
    weights (``wqkv``, ``w_gate_up``) first put rank-major by
    `parallel.tensor.fused_row_permutation` so each rank holds its own q
    heads with their KV groups; replicated leaves stay whole. Views:
    clone to own them."""
    from ray_lightning_tpu_torch.models.llama import llama_fused_rows
    from ray_lightning_tpu_torch.parallel.tensor import (
        fused_row_permutation,
    )

    fused = llama_fused_rows(model.cfg)
    out = {}
    for name, spec in serving_param_specs(model, params):
        value = params[name]
        if "tensor" in spec:
            dim = spec.index("tensor")
            if name in fused:
                value = value[fused_row_permutation(fused[name], mesh.size)
                              .to(value.device)]
            value = value.chunk(mesh.size, dim=dim)[mesh.rank]
        out[name] = value
    return out


class DecodeEngine:
    """One replica's step + its device-resident buffers (``pool_k``,
    ``pool_v``, ``last_logits``; ``dpool_k``/``dpool_v`` under a draft).
    The host-side request state lives in `serve.scheduler`.

    ``use_kernels`` picks the lanes once, here: None follows the
    dispatch policy for the device (the kernel lanes on CUDA unless a
    `dispatch.force_reference` context is active), True the kernel lanes
    (on the CPU their wrappers run the plain versions), False the
    reference lanes — the twin of the JAX engine's ``use_pallas``. A
    kernel lane also needs the kernel's shape gate to pass: on the CPU a
    refused shape takes the reference lane, on CUDA it raises (the card
    runs the reference lanes only when ``use_kernels=False`` or a
    `dispatch.force_reference` context asks for them).

    ``cfg.draft`` arms speculative decoding: ``draft_model`` (a `Llama`
    holding the draft's weights; ``draft_params``, its state dict, is
    loaded into it when given) runs `build_spec_step`'s lanes. The draft
    must share the target's vocabulary and cover the slot, and the
    engine must be unsharded.

    ``mesh`` (a `parallel.tensor.TensorParallel`: this rank's tensor
    group) makes the engine one rank of a tensor-parallel replica: the
    model's weights are replaced by this rank's pieces
    (`serving_param_shardings`) and `Llama.enable_tensor_parallel` is
    turned on, so attention runs ``H/tp`` q heads over ``Hkv/tp`` KV
    heads (the paged kernels at those shapes), the pool holds ``Hkv/tp``
    heads, and the row-parallel projections all-reduce over the group.
    ``last_logits`` is replicated (the vocab-parallel head gathers it),
    so every rank samples the same tokens and the scheduler on each rank,
    fed the same inputs, stays tp-oblivious."""

    def __init__(self, model, cfg: EngineConfig,
                 use_kernels: Optional[bool] = None, device=None,
                 metrics=None, mesh=None, draft_model=None,
                 draft_params=None, max_seq_len_check: bool = True):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"asked for {dev}")
        if max_seq_len_check and cfg.max_slot_len > model.cfg.max_seq_len:
            raise ValueError(
                f"engine max_slot_len {cfg.max_slot_len} exceeds the "
                f"model's max_seq_len {model.cfg.max_seq_len} — RoPE "
                "tables would be read out of range")
        if cfg.draft is not None:
            if draft_model is None:
                raise ValueError(
                    "cfg.draft is set but no draft model/params were "
                    "given — pass draft_model= (and draft_params=)")
            if mesh is not None:
                raise ValueError(
                    "speculative decoding requires an unsharded replica "
                    "(mesh=None)")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.cfg.vocab_size} != target "
                    f"vocab {model.cfg.vocab_size} — greedy verify "
                    "compares token ids across the two models")
            if max_seq_len_check and \
                    cfg.max_slot_len > draft_model.cfg.max_seq_len:
                raise ValueError(
                    f"engine max_slot_len {cfg.max_slot_len} exceeds the "
                    f"DRAFT model's max_seq_len "
                    f"{draft_model.cfg.max_seq_len}")
            if draft_model.device.type != dev.type:
                raise ValueError(f"draft model lives on "
                                 f"{draft_model.device}, engine asked "
                                 f"for {dev}")
            if draft_params is not None:
                draft_model.load_state_dict(draft_params)
        self.model = model
        self.cfg = cfg
        self.spec = cfg.pool_spec
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.size
        mcfg = model.cfg
        if mesh is not None:
            validate_pool_tp(mcfg, self.tp)
            self._shard_weights(mesh)
        if use_kernels is None:
            use_kernels = dispatch.use_kernel(dev)
        n_q, n_kv = mcfg.n_heads // self.tp, mcfg.n_kv_heads // self.tp
        pool_shape = (self.spec.n_blocks, self.spec.block_size, n_kv,
                      mcfg.head_dim)
        self.draft_model = draft_model
        self.dpool_k = self.dpool_v = None
        if cfg.draft is not None:
            # the verify chunk, the draft trips and the prefill chunk run
            # the reference attention lanes (`build_spec_step`)
            self.fused = self.fused_prefill = False
            self._step = build_spec_step(model, draft_model, cfg,
                                         reference=not use_kernels)
            self.dpool_k, self.dpool_v = init_pool(draft_model.cfg,
                                                   self.spec, dev)
        else:
            self.fused = paged_attention_uses_kernel(
                (cfg.capacity, n_q, mcfg.head_dim), pool_shape,
                use_kernels, dev)
            self.fused_prefill = paged_prefill_uses_kernel(
                (cfg.prefill_batch, cfg.prefill_chunk, n_q,
                 mcfg.head_dim), pool_shape, use_kernels, dev)
            self._step = build_step(model, cfg, fused=self.fused,
                                    fused_prefill=self.fused_prefill)
        self.pool_k, self.pool_v = init_pool(mcfg, self.spec, dev,
                                             tp=self.tp)
        self.last_logits = torch.zeros((cfg.capacity, mcfg.vocab_size),
                                       dtype=torch.float32, device=dev)
        self.steps = 0
        self.metrics = metrics if metrics is not None else NULL_METRICS

    def _shard_weights(self, mesh) -> None:
        """Keep only this rank's piece of each weight, then run the
        model's tensor-parallel forward."""
        from torch import nn

        model = self.model
        if model.tp is not None:
            raise ValueError("the model already runs on a tensor group")
        with torch.no_grad():
            pieces = serving_param_shardings(model, model.state_dict(),
                                             mesh)
            for name, piece in pieces.items():
                owner, _, attr = name.rpartition(".")
                mod = model.get_submodule(owner) if owner else model
                setattr(mod, attr, nn.Parameter(piece.clone(),
                                                requires_grad=False))
        model.enable_tensor_parallel(mesh)

    def live_bytes(self) -> dict:
        """The bytes this engine holds on its device, by the terms of
        `serve.audit.serve_memory_summary` and `speculative_plan`: the
        (rank's) weights, the pool, ``last_logits``, and under a draft its
        weights and pool."""
        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        out = {"params_bytes": nbytes(*self.model.parameters()),
               "pool_bytes": nbytes(self.pool_k, self.pool_v),
               "last_logits_bytes": nbytes(self.last_logits)}
        if self.dpool_k is not None:
            out["draft_params_bytes"] = nbytes(
                *self.draft_model.parameters())
            out["draft_pool_bytes"] = nbytes(self.dpool_k, self.dpool_v)
        return out

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
        """Copy pool block ``src`` into ``dst`` (K and V; the draft's pool
        too under speculative decoding): the scheduler's copy-on-write
        fork."""
        with torch.no_grad():
            _copy_pool_block(self.pool_k, self.pool_v, int(src), int(dst))
            if self.dpool_k is not None:
                _copy_pool_block(self.dpool_k, self.dpool_v, int(src),
                                 int(dst))

    def tick(self, tables, pos, decoding, temp, top_k, rngs, prefill,
             pad=None):
        """Run one step; returns ``(toks [C, W] i32 np, n_emit [C] i32
        np, rngs' [C, 2] u32 np)``: ``toks[s, :n_emit[s]]`` are slot s's
        tokens this tick, oldest first. W is 1 on the base step
        (``n_emit`` is the decoding mask) and ``cfg.draft.k`` under
        speculative decoding, where ``n_emit`` counts the carried token
        plus the accepted proposals. ``pad`` ([C] per-slot left pad) is
        read on the batched-prefill lane only."""
        decoding = np.asarray(decoding, bool)
        args = (np.asarray(tables, np.int32), np.asarray(pos, np.int32),
                decoding, np.asarray(temp, np.float32),
                np.asarray(top_k, np.int32), np.asarray(rngs, np.uint32),
                prefill)
        spec_mode = self.cfg.draft is not None
        with torch.no_grad():
            if spec_mode:
                toks, n_emit, new_rngs = self._step(
                    self.pool_k, self.pool_v, self.dpool_k, self.dpool_v,
                    self.last_logits, *args)
                toks = toks.to(torch.int32).cpu().numpy()
                n_emit = n_emit.to(torch.int32).cpu().numpy()
            else:
                if self.cfg.prefill_batch > 1 and pad is None:
                    pad = np.zeros(self.cfg.capacity, np.int32)
                emitted, new_rngs = self._step(
                    self.pool_k, self.pool_v, self.last_logits, *args, pad)
                toks = emitted.to(torch.int32).cpu().numpy()[:, None]
                n_emit = decoding.astype(np.int32)
        self.steps += 1
        m = self.metrics
        if m.enabled:
            n_dec = int(n_emit.sum())
            n_pf_rows = int(np.sum(np.asarray(prefill[0]) >= 0))
            if n_dec:
                m.count("decode_tokens", n_dec)
            if n_pf_rows:
                m.count("prefill_tokens",
                        n_pf_rows * self.cfg.prefill_chunk)
            m.gauge("engine_steps", self.steps)
        return toks, n_emit, new_rngs
