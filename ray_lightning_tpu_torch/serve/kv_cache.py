"""Block-paged KV cache: a shared block pool + per-slot block tables
(twin of `ray_lightning_tpu/serve/kv_cache.py`; the host-side
bookkeeping is a copy, kept here so the port imports nothing of the
JAX package).

    pool_k, pool_v : [L, n_blocks, block_size, Hkv, hd]   (device tensors)
    block_table    : [capacity, blocks_per_slot] int32    (host-owned)

A slot's logical cache position ``p`` lives at pool block
``table[slot, p // block_size]``, offset ``p % block_size``. Block 0 is
the **scratch block**: never allocated; every write the step must not
really make (idle slots, vacant prefill rows) is redirected there, and
every read of it is masked by position before it can influence
attention.

The byte helpers (`pool_bytes`, `gathered_view_bytes`,
`serve_kv_plan_bytes`) are the JAX package's arithmetic; with ``tp`` they
price one rank of a tensor-parallel replica, whose pool holds ``Hkv/tp``
KV heads (`pool_partition_spec`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PagedPoolSpec:
    """Shape of the paged pool for one model config.

    ``gathered_len = blocks_per_slot * block_size`` is the per-slot
    maximum of ``prompt_len + max_new_tokens`` the scheduler admits."""

    n_blocks: int
    block_size: int
    blocks_per_slot: int

    def __post_init__(self):
        if self.block_size < 1 or self.blocks_per_slot < 1:
            raise ValueError("block_size and blocks_per_slot must be >= 1")
        if self.n_blocks < 2:
            # block 0 is reserved scratch — a pool of 1 block can hold
            # no request at all
            raise ValueError("n_blocks must be >= 2 (block 0 is scratch)")

    @property
    def gathered_len(self) -> int:
        return self.blocks_per_slot * self.block_size

    @classmethod
    def for_capacity(cls, capacity: int, max_len: int,
                     block_size: int = 16,
                     oversubscribe: float = 1.0) -> "PagedPoolSpec":
        """A spec sized so ``capacity`` slots of up to ``max_len`` tokens
        fit; ``oversubscribe < 1`` shrinks the pool below the dense
        worst case."""
        bps = -(-max_len // block_size)
        blocks = max(2, 1 + int(round(capacity * bps * oversubscribe)))
        return cls(n_blocks=blocks, block_size=block_size,
                   blocks_per_slot=bps)


def init_pool(cfg, spec: PagedPoolSpec, device, tp: int = 1):
    """Zeroed (pool_k, pool_v), leaves
    ``[n_layers, n_blocks, block_size, n_kv_heads / tp, head_dim]`` in
    the model's dtype on ``device``: with ``tp > 1``, one rank's slice of
    a tensor-parallel replica's pool (`pool_partition_spec`)."""
    validate_pool_tp(cfg, tp)
    shape = (cfg.n_layers, spec.n_blocks, spec.block_size,
             cfg.n_kv_heads // tp, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def validate_pool_tp(cfg, tp: int) -> None:
    """A tensor-parallel replica splits the pool over the KV-head axis
    (the one axis every pool consumer, the gathers, the scatters and both
    paged kernels, treats as independent), so ``tp`` must divide the KV
    heads: an uneven split would give the ranks pools of other shapes."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide n_kv_heads "
            f"{cfg.n_kv_heads}: the paged pool shards over the KV-head "
            "axis")


def pool_partition_spec(tp: int = 1) -> tuple:
    """Per-dimension mesh axes of one pool leaf ``[L, n_blocks,
    block_size, Hkv, hd]`` (the convention of
    `models.llama.llama_param_specs`; ``()`` replicated): the KV heads
    over ``tensor``, so each rank holds ``[L, n_blocks, P, Hkv/tp, hd]``.
    Block identity is untouched: one host-side block table drives every
    rank, and the allocator and the scheduler stay tp-oblivious."""
    if tp <= 1:
        return ()
    return (None, None, None, "tensor", None)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def pool_shard_bytes(cfg, spec: PagedPoolSpec, tp: int = 1) -> int:
    """One rank's pool bytes (k + v): the head axis divides by ``tp``."""
    validate_pool_tp(cfg, tp)
    return pool_bytes(cfg, spec) // tp


def pool_bytes(cfg, spec: PagedPoolSpec) -> int:
    """Bytes held by the pool itself (k + v)."""
    per = (cfg.n_layers * spec.n_blocks * spec.block_size
           * cfg.n_kv_heads * cfg.head_dim)
    return 2 * per * _itemsize(cfg.dtype)


def gathered_view_bytes(cfg, spec: PagedPoolSpec, capacity: int) -> int:
    """Bytes of the dense per-slot view the REFERENCE decode lane gathers
    (k + v), ``[L, capacity, gathered_len, Hkv, hd]``; the paged decode
    kernel reads the pool through the block tables and this copy goes."""
    per = (cfg.n_layers * capacity * spec.gathered_len
           * cfg.n_kv_heads * cfg.head_dim)
    return 2 * per * _itemsize(cfg.dtype)


def serve_kv_plan_bytes(cfg, spec: PagedPoolSpec, capacity: int,
                        fused: bool = False, prefill_batch: int = 1,
                        fused_prefill: bool = False, tp: int = 1) -> dict:
    """The serving cache's bytes for ``plan --serve``: the pool, the
    attention lanes' surviving gathered view and the f32 ``last_logits``
    the engine keeps between ticks.

    ``fused`` prices the paged decode kernel's lane (the capacity-wide
    view goes; the prefill lane's per-group gather, ``prefill_gather_
    bytes``, is what survives), ``fused_prefill`` the paged prefill
    kernel's (that last view goes too). The retired bytes are itemized.
    ``tp > 1`` prices ONE RANK of a tensor-parallel replica: the pool and
    every view carry the KV-head axis and divide by ``tp``;
    ``last_logits`` is replicated on every rank and does not."""
    validate_pool_tp(cfg, tp)
    logits = capacity * cfg.vocab_size * 4
    dense = gathered_view_bytes(cfg, spec, capacity) // tp
    prefill_gather = gathered_view_bytes(
        cfg, spec, min(prefill_batch, capacity)) // tp
    if fused_prefill:
        prefill_gather = 0
    if fused:
        view = prefill_gather
    else:
        # the reference decode lane's capacity-wide copy dominates; the
        # group-sized prefill gather is a slice of the same story
        view = dense
        prefill_gather = min(prefill_gather, view)
    return {
        "pool_bytes": pool_bytes(cfg, spec) // tp,
        "gathered_view_bytes": view,
        "gathered_view_retired_bytes": dense - view,
        "prefill_gather_bytes": prefill_gather,
        "last_logits_bytes": logits,
    }


class BlockAllocator:
    """Host-side free-list over the pool's blocks, with per-block
    REFCOUNTS so prefix sharing can map one physical block into many
    slot tables. Block 0 (scratch) is never handed out.

    ``alloc`` grants blocks at refcount 1; ``incref`` adds a sharer;
    ``decref`` (and its alias ``free``) drops one reference and returns
    the block to the free list when the LAST reference dies. A decref of
    a free block raises "double free"."""

    def __init__(self, spec: PagedPoolSpec):
        self.spec = spec
        self._free: List[int] = list(range(1, spec.n_blocks))
        #: block id -> live reference count (allocated blocks only)
        self._refs: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, b: int) -> int:
        """Live references on block ``b`` (0 when free)."""
        return self._refs.get(int(b), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids at refcount 1, or None when the pool cannot
        satisfy the request (never a partial grant)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids, self._free = self._free[:n], self._free[n:]
        for b in ids:
            self._refs[b] = 1
        return ids

    def incref(self, ids) -> None:
        """Add one reference per id (prefix sharing)."""
        for b in ids:
            b = int(b)
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"incref of unallocated block {b}")
            self._refs[b] += 1

    def decref(self, ids) -> List[int]:
        """Drop one reference per id; returns the ids whose LAST
        reference died (now back on the free list)."""
        freed: List[int] = []
        for b in ids:
            b = int(b)
            if b <= 0 or b >= self.spec.n_blocks:
                raise ValueError(f"freeing invalid block {b}")
            rc = self._refs.get(b, 0)
            if rc < 1:
                raise ValueError(f"double free of block {b}")
            if rc == 1:
                del self._refs[b]
                self._free.append(b)
                freed.append(b)
            else:
                self._refs[b] = rc - 1
        return freed

    def free(self, ids) -> None:
        """Alias for :meth:`decref`."""
        self.decref(ids)


def prefix_block_hashes(tokens, block_size: int) -> List[bytes]:
    """Cumulative digest per FULL block of ``tokens``: digest ``i``
    identifies tokens ``0 .. (i+1)*block_size`` as a chain (K/V at a
    position depends on every earlier token)."""
    toks = np.asarray(tokens, dtype=np.int32).reshape(-1)
    out: List[bytes] = []
    h = b""
    for i in range(toks.size // block_size):
        chunk = toks[i * block_size:(i + 1) * block_size].tobytes()
        h = hashlib.sha1(h + chunk).digest()
        out.append(h)
    return out


class PrefixCache:
    """Prompt-prefix -> block-chain cache over one `BlockAllocator`.

    Maps the cumulative token-hash of each FULL prompt block to the
    pool block holding its K/V, holding ONE reference per cached block.
    Entries are LRU-ordered; eviction frees only blocks at refcount 1."""

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        #: digest -> block id, oldest-touched first (LRU order)
        self._chain: "OrderedDict[bytes, int]" = OrderedDict()
        self.shared_tokens = 0
        self.prompt_tokens = 0

    def __len__(self) -> int:
        return len(self._chain)

    def match(self, hashes: Sequence[bytes],
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest cached chain prefix of ``hashes`` (block ids, in
        chain order), capped at ``max_blocks``. Touches hits for LRU."""
        blocks: List[int] = []
        limit = len(hashes) if max_blocks is None else min(
            max_blocks, len(hashes))
        for h in hashes[:limit]:
            b = self._chain.get(h)
            if b is None:
                break
            self._chain.move_to_end(h)
            blocks.append(b)
        return blocks

    def register(self, hashes: Sequence[bytes], blocks: Sequence[int]
                 ) -> None:
        """Publish a prefilled chain, one reference per newly cached
        block; a digest already cached keeps its first publication."""
        for h, b in zip(hashes, blocks):
            if h in self._chain:
                self._chain.move_to_end(h)
                continue
            self.alloc.incref([b])
            self._chain[h] = int(b)

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU entries
        the cache alone holds. Returns blocks actually freed."""
        freed = 0
        for h in list(self._chain):
            if freed >= n_blocks:
                break
            b = self._chain[h]
            if self.alloc.refcount(b) == 1:
                del self._chain[h]
                self.alloc.decref([b])
                freed += 1
        return freed

    @property
    def shared_block_fraction(self) -> float:
        """Fraction of admitted prompt tokens served from cached chains."""
        if not self.prompt_tokens:
            return 0.0
        return self.shared_tokens / self.prompt_tokens


def new_block_table(spec: PagedPoolSpec, capacity: int) -> np.ndarray:
    """All-scratch table: every entry points at block 0 until the
    scheduler assigns real blocks on admission."""
    return np.zeros((capacity, spec.blocks_per_slot), np.int32)
