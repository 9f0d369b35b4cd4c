"""Host-side slot lifecycle: admission, prefill interleaving, block
reservation/growth, retirement, preemption (twin of
`ray_lightning_tpu/serve/scheduler.py`; framework-free, so it is the
JAX package's policy line for line, the speculative-decoding admission
and growth included).

The scheduler owns every mutable serving decision and keeps it in plain
numpy — the compiled step only ever sees fixed-shape arrays built here.
One `tick()` = admit what fits, pick the next prefill chunk, run the
engine once, account emissions. Determinism: given the same request
stream (ids, seeds, arrival order) the schedule — and therefore every
emitted token — is a pure function of the inputs, which is what lets a
respawned replica REPLAY lost requests to bitwise-identical streams
(driver.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ray_lightning_tpu_torch.serve.engine import DecodeEngine, idle_prefill
from ray_lightning_tpu_torch.serve.kv_cache import (
    BlockAllocator,
    PrefixCache,
    new_block_table,
    prefix_block_hashes,
)
from ray_lightning_tpu_torch.telemetry.metrics import (
    NULL_FLIGHT,
    NULL_METRICS,
)


#: traffic classes, best first — the index is the preemption rank
#: (lower outranks higher; docs/SERVING.md "traffic & SLO classes")
PRIORITIES = ("latency_critical", "standard", "best_effort")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` drives the slot's private RNG —
    sampling is per-request reproducible and batch-order invariant
    (test-pinned)."""

    rid: str
    prompt: np.ndarray              # [l] int32 token ids
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    eos_id: Optional[int] = None
    #: host wall time the request entered the queue (queue_wait span)
    arrival: float = 0.0
    #: traffic class (PRIORITIES). Inert unless the scheduler is built
    #: with an SLOConfig — priority-off runs the historical FIFO/age
    #: policy no matter what the label says (test-pinned)
    priority: str = "standard"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.priority not in _PRIORITY_RANK:
            raise ValueError(
                f"request {self.rid}: priority {self.priority!r} not in "
                f"{PRIORITIES}")


@dataclasses.dataclass
class Completion:
    rid: str
    tokens: List[int]
    finish_reason: str              # "eos" | "length"
    queue_wait_s: float
    ttft_s: float                   # admission -> first token (host wall)
    decode_s: float                 # first token -> completion
    preempted: int = 0              # times this request was re-queued
    priority: str = "standard"      # the request's traffic class

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first."""
        n = max(1, len(self.tokens) - 1)
        return self.decode_s / n


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """Per-class service targets + admission budget.

    ``queue_budget`` is the class's admission budget: with an SLOConfig
    armed, a new arrival in a SHED class whose class queue already
    holds this many requests is rejected with a typed shed record
    instead of queueing unboundedly behind traffic it can never
    outrank. ``None`` = unlimited."""

    ttft_p95_s: float = 2.0
    tpot_p95_s: float = 0.5
    queue_budget: Optional[int] = None


def _default_classes() -> Dict[str, ClassSLO]:
    return {
        "latency_critical": ClassSLO(ttft_p95_s=0.5, tpot_p95_s=0.2),
        "standard": ClassSLO(ttft_p95_s=2.0, tpot_p95_s=0.5),
        "best_effort": ClassSLO(ttft_p95_s=30.0, tpot_p95_s=2.0),
    }


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Arms traffic-aware scheduling (docs/SERVING.md "traffic & SLO
    classes"). With ``slo=None`` (the default everywhere) the scheduler
    runs the byte-identical historical policy: FIFO admission,
    oldest-preempts-youngest growth, no shedding, no class-keyed
    metrics — the priority label on a Request is inert.

    Armed, three seams change, all host-side (the compiled step never
    sees a priority):

    * admission order becomes (class rank, FIFO) — stable within a
      class, so the anti-livelock age ordering survives;
    * the growth-stall seam preempts by (class rank, age): a grower may
      evict strictly-lower-class slots of ANY age, same-class slots
      only if strictly younger — never peers-or-better; a blocked
      higher-class ARRIVAL may preempt a strictly-lower-class slot
      (`preempt_on_admit`);
    * overload sheds ``shed_classes`` load explicitly: a breached
      class ``queue_budget`` or a dry pool blocking a higher class
      produces a typed shed record with a capped-exponential
      ``retry_after_s`` hint — never silence.
    """

    classes: Dict[str, ClassSLO] = dataclasses.field(
        default_factory=_default_classes)
    #: classes eligible for load shedding under overload
    shed_classes: Tuple[str, ...] = ("best_effort",)
    #: shed queued shed-class work when a dry pool blocks the
    #: admission of a strictly higher class
    shed_on_dry_pool: bool = True
    #: a blocked higher-class arrival may preempt a strictly-lower-
    #: class slot to take its blocks (never a peer)
    preempt_on_admit: bool = True
    #: capped-exponential retry-after hint: base * 2^(sheds-1), capped
    retry_after_base_s: float = 0.5
    retry_after_cap_s: float = 30.0

    def __post_init__(self):
        for name in self.classes:
            if name not in _PRIORITY_RANK:
                raise ValueError(f"SLOConfig: unknown class {name!r}")
        for name in self.shed_classes:
            if name not in _PRIORITY_RANK:
                raise ValueError(
                    f"SLOConfig: unknown shed class {name!r}")

    def slo_for(self, priority: str) -> ClassSLO:
        return self.classes.get(priority, ClassSLO())

    def retry_after(self, n_sheds: int) -> float:
        """Capped-exponential backoff hint for the n-th shed of one
        request (n_sheds >= 1)."""
        return min(self.retry_after_cap_s,
                   self.retry_after_base_s * (2.0 ** max(0, n_sheds - 1)))

    def to_wire(self) -> dict:
        """JSON-safe payload (process-backend worker spawn)."""
        return {
            "classes": {k: dataclasses.asdict(v)
                        for k, v in self.classes.items()},
            "shed_classes": list(self.shed_classes),
            "shed_on_dry_pool": self.shed_on_dry_pool,
            "preempt_on_admit": self.preempt_on_admit,
            "retry_after_base_s": self.retry_after_base_s,
            "retry_after_cap_s": self.retry_after_cap_s,
        }

    @staticmethod
    def from_wire(d: Optional[dict]) -> Optional["SLOConfig"]:
        if d is None:
            return None
        return SLOConfig(
            classes={k: ClassSLO(**v)
                     for k, v in d.get("classes", {}).items()},
            shed_classes=tuple(d.get("shed_classes", ("best_effort",))),
            shed_on_dry_pool=d.get("shed_on_dry_pool", True),
            preempt_on_admit=d.get("preempt_on_admit", True),
            retry_after_base_s=d.get("retry_after_base_s", 0.5),
            retry_after_cap_s=d.get("retry_after_cap_s", 30.0),
        )


class _Slot:
    __slots__ = ("req", "blocks", "emitted", "prefill_next",
                 "admitted_at", "first_token_at", "preempted", "seq",
                 "shared_blocks", "hashes")

    def __init__(self, req: Request, blocks: List[int], preempted: int,
                 seq: int):
        self.req = req
        self.blocks = blocks            # allocated pool block ids
        self.emitted: List[int] = []
        self.prefill_next = 0           # prompt tokens already chunked
        self.admitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.preempted = preempted
        #: admission order — the preemption policy's age (monotonic,
        #: tie-free where wall clocks are not)
        self.seq = seq
        #: leading blocks mapped from the prefix cache at admission
        #: (their prefill was skipped); shrinks if a fork copies one
        self.shared_blocks = 0
        #: cumulative prompt-block digests (prefix_block_hashes) —
        #: kept for registration when prefill completes
        self.hashes: List[bytes] = []


@dataclasses.dataclass
class _PrefillGroup:
    """One FIFO prefill unit. Single-slot engines (prefill_batch == 1)
    run groups of one with ``width`` = the raw prompt length (the
    historical slide-back chunk discipline). Batched engines admit up
    to ``prefill_batch`` requests into one group, every row RIGHT-
    ALIGNED to the shared chunk-multiple ``width`` (the model's
    left-pad cache path — `generate(prompt_lengths=...)`): rows advance
    in lockstep at the shared write offset ``next`` and all finish on
    the same chunk, where the last real token of every row sits in the
    same in-chunk column."""

    slots: List[int]
    width: int
    next: int = 0


def validate_request(cfg, spec, req: Request) -> None:
    """The admission-time span checks EVERY submission path must pass
    — `Scheduler.submit` and the driver's dynamic-session `submit()`
    (which may have to defer a request before any scheduler sees it;
    an unvalidated oversize request would sit at a FIFO head forever,
    head-of-line-blocking the replica — review finding, test-pinned).
    ``cfg`` is the `EngineConfig`, ``spec`` its pool spec."""
    total = req.prompt.size + req.max_new_tokens
    if cfg.draft is not None:
        if req.temperature != 0.0:
            raise ValueError(
                f"request {req.rid}: speculative decoding is "
                f"greedy-only (temperature 0), got "
                f"{req.temperature}")
        # the verify chunk writes k positions from the LAST decode pos
        # — k-1 headroom keeps the window inside the slot
        total += cfg.draft.k - 1
    padded = ""
    if cfg.prefill_batch > 1:
        # batched prefill right-aligns the prompt to a chunk multiple
        # even when the request is admitted alone — the admission-time
        # span must cover that pad
        ch = cfg.prefill_chunk
        total = -(-req.prompt.size // ch) * ch + req.max_new_tokens
        padded = " (chunk-padded)"
    if total > cfg.max_slot_len:
        raise ValueError(
            f"request {req.rid}: prompt {req.prompt.size}{padded} + "
            f"max_new_tokens {req.max_new_tokens} exceeds the "
            f"engine's max_slot_len {cfg.max_slot_len}")
    if -(-total // spec.block_size) > spec.n_blocks - 1:
        # even with the pool to itself this request cannot finish —
        # admitting it would preempt-loop forever in on_demand mode
        raise ValueError(
            f"request {req.rid}: span {total} needs more blocks "
            f"than the whole pool holds "
            f"({spec.n_blocks - 1} usable)")


def _key_data(seed: int) -> np.ndarray:
    """A request's initial [2] uint32 RNG state: the key data of
    ``jax.random.key(seed)`` (threefry, 32-bit seeds: ``[0, seed mod
    2**32]``), computed without JAX."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


class Scheduler:
    """Continuous-batching policy over one `DecodeEngine`.

    ``reserve="worst_case"`` (default) allocates every block a request
    could ever need at admission — no mid-stream surprises, admission
    defers while the pool is short. ``reserve="on_demand"`` allocates
    for the prompt only and grows per block boundary during decode;
    when the pool runs dry at a growth point the OLDEST slot preempts
    the YOUNGEST one back to the queue and takes its blocks —
    oldest-first progress guarantees the system drains, and replay is
    deterministic (same seed, same tokens), so a preempted stream is
    delayed, never corrupted.
    """

    def __init__(self, engine: DecodeEngine, reserve: str = "worst_case",
                 metrics=None, flight=None, prefix_cache: bool = False,
                 slo: Optional[SLOConfig] = None):
        if reserve not in ("worst_case", "on_demand"):
            raise ValueError(f"reserve={reserve!r}")
        if prefix_cache and engine.cfg.prefill_batch != 1:
            raise ValueError(
                "prefix_cache=True requires prefill_batch == 1 — the "
                "batched lane's left-pad alignment shifts block "
                "boundaries per group, so chains never line up")
        if prefix_cache and engine.mesh is not None:
            raise ValueError(
                "prefix_cache=True requires an unsharded replica "
                "(mesh=None), as in the JAX scheduler")
        #: live metrics (telemetry/metrics.py): per-tick gauges + event
        #: counters + completion latency histograms — every recorded
        #: value is a plain host scalar the tick computed anyway, so
        #: metrics on/off never changes the engine program or adds a
        #: host sync (test-pinned)
        self.metrics = metrics if metrics is not None else NULL_METRICS
        #: flight recorder: bounded ring of recent ticks + scheduler
        #: events, cadence-persisted — the postmortem a dead replica
        #: leaves behind (docs/OBSERVABILITY.md "flight recorder")
        self.flight = flight if flight is not None else NULL_FLIGHT
        self.engine = engine
        self.cfg = engine.cfg
        self.spec = engine.spec
        self.reserve = reserve
        self.alloc = BlockAllocator(self.spec)
        #: prompt-prefix -> block-chain cache (docs/SERVING.md "prefix
        #: sharing"): admission maps a matched chain into the slot's
        #: table by incref and prefills only the divergent tail
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.alloc) if prefix_cache else None)
        #: REAL prompt positions advanced through the prefill lane —
        #: the prefill-once assertion's counter (shared prefixes are
        #: admitted at pos > 0 and never re-issued)
        self.prefill_tokens_issued = 0
        #: tokens the verify chunk advances per tick (1 = base engine)
        self._spec_k = (self.cfg.draft.k
                        if self.cfg.draft is not None else 1)
        self._emitted_total = 0
        self._decode_slot_steps = 0
        C = self.cfg.capacity
        self.tables = new_block_table(self.spec, C)
        self.pos = np.zeros(C, np.int32)
        self.decoding = np.zeros(C, bool)
        self.temp = np.zeros(C, np.float32)
        self.top_k = np.zeros(C, np.int32)
        self.rngs = np.zeros((C, 2), np.uint32)
        #: per-slot left pad (batched prefill admits left-padded rows;
        #: 0 everywhere on single-slot engines) — the decode lanes mask
        #: pad columns exactly like generate(prompt_lengths=...)
        self.pad = np.zeros(C, np.int32)
        self.slots: Dict[int, _Slot] = {}
        self.free_slots: List[int] = list(range(C))
        self.queue: Deque[Tuple[Request, int]] = deque()  # (req, preempts)
        self.prefill_groups: Deque[_PrefillGroup] = deque()  # FIFO
        self.completions: List[Completion] = []
        #: (rid, token) pairs emitted by the MOST RECENT tick — the
        #: driver's streaming hook
        self.last_emissions: List[Tuple[str, int]] = []
        #: rids preempted by the MOST RECENT tick: a streaming consumer
        #: must DISCARD its partial stream for these (the replay
        #: regenerates it bitwise; keeping the prefix would duplicate
        #: tokens — review finding, regression-pinned)
        self.last_preemptions: List[str] = []
        #: partial-progress timing for the MOST RECENT tick's
        #: preemptions — the driver records these as REPLAYED-tagged
        #: spans so a preempt-heavy run stops under-reporting
        #: queue_wait without double-counting the replayed prefix
        self.last_preemption_details: List[dict] = []
        #: traffic-aware policy (None = the byte-identical historical
        #: scheduler: FIFO + oldest-preempts-youngest, no shedding, no
        #: class-keyed metrics — test-pinned)
        self.slo = slo
        #: typed shed records since the last `take_sheds()` — every
        #: rejected/deferred request leaves one; a consumer that drops
        #: them ships silent request loss (lint rule RLT505)
        self.last_sheds: List[dict] = []
        #: per-rid shed count (drives the capped-exponential
        #: retry_after_s hint across resubmissions)
        self._shed_counts: Dict[str, int] = {}
        self._seq = 0
        self._queue_wait: Dict[str, float] = {}
        #: running occupancy: decoding-slot fraction summed over ticks
        self._occupancy_sum = 0.0
        self._ticks = 0
        #: drain mode (autoscale scale-down, docs/AUTOSCALE.md):
        #: admissions stop, already-slotted work decodes to retirement,
        #: and the driver evicts whatever lands back in the queue
        self.draining = False

    # ---- submission ------------------------------------------------------

    def submit(self, req: Request) -> None:
        validate_request(self.cfg, self.spec, req)
        if req.arrival == 0.0:
            req.arrival = time.perf_counter()
        self.enqueue(req, 0)

    def enqueue(self, req: Request, preempts: int) -> None:
        """Queue a validated request carrying its prior preemption
        count — the requeue path a scale-down/eviction uses so a
        request bounced between replicas keeps honest `preempted`
        accounting. External submissions go through `submit()` (which
        validates the span against THIS engine's pool first)."""
        if self.draining:
            raise RuntimeError(
                f"scheduler is draining — request {req.rid} must route "
                "to a live replica (driver bug: admissions are closed "
                "here)")
        if self.slo is None:
            self.queue.append((req, preempts))
            return
        budget = self.slo.slo_for(req.priority).queue_budget
        if (req.priority in self.slo.shed_classes
                and budget is not None
                and self._queued_in_class(req.priority) >= budget):
            self._shed(req, preempts, "queue_budget")
            return
        self._insert_by_class(req, preempts, front_of_class=False)

    def take_sheds(self) -> List[dict]:
        """Drain the typed shed records (explicit rejection/deferral —
        each carries rid, priority, reason, retry_after_s). The driver
        turns every record into a terminal status on the stream; a
        consumer that drops them ships silent request loss (RLT505)."""
        out, self.last_sheds = self.last_sheds, []
        return out

    # ---- traffic-aware policy helpers (no-ops with slo=None) -------------

    def _queued_in_class(self, priority: str) -> int:
        return sum(1 for q, _ in self.queue if q.priority == priority)

    def _insert_by_class(self, req: Request, preempts: int,
                         front_of_class: bool) -> None:
        """Class-ordered queue insert, FIFO-stable within a class. A
        new arrival goes BEHIND its class peers (front_of_class=False);
        a preempted requeue goes AHEAD of them (it is the oldest of its
        class — the anti-livelock age ordering the historical
        appendleft encoded, scoped to the class)."""
        r = _PRIORITY_RANK[req.priority]
        i = len(self.queue)
        for j, (q, _) in enumerate(self.queue):
            rq = _PRIORITY_RANK[q.priority]
            if rq > r or (front_of_class and rq == r):
                i = j
                break
        self.queue.insert(i, (req, preempts))

    def _shed(self, req: Request, preempts: int, reason: str) -> None:
        """Reject/defer one request with a typed record — the explicit
        overload paper trail (never silence). retry_after_s is
        capped-exponential in this rid's shed count."""
        n = self._shed_counts.get(req.rid, 0) + 1
        self._shed_counts[req.rid] = n
        rec = {
            "rid": req.rid,
            "priority": req.priority,
            "reason": reason,
            "retry_after_s": self.slo.retry_after(n),
            "sheds": n,
            "preempted": preempts,
        }
        self.last_sheds.append(rec)
        self._queue_wait.pop(req.rid, None)
        self.metrics.count("sheds")
        self.metrics.count(f"sheds_{req.priority}")
        self.flight.record("shed", rid=req.rid, priority=req.priority,
                           reason=reason,
                           retry_after_s=rec["retry_after_s"])

    def _shed_starved(self) -> None:
        """Dry pool blocking the queue head: queued shed-class work of
        STRICTLY lower class than the blocked head is shed with
        explicit records — it sits behind traffic it can never outrank,
        so leaving it queued is silent starvation."""
        if self.slo is None or not self.slo.shed_on_dry_pool:
            return
        head, _ = self.queue[0]
        r = _PRIORITY_RANK[head.priority]
        keep: Deque[Tuple[Request, int]] = deque()
        for req, preempts in self.queue:
            if (req.priority in self.slo.shed_classes
                    and _PRIORITY_RANK[req.priority] > r):
                self._shed(req, preempts, "dry_pool")
            else:
                keep.append((req, preempts))
        self.queue = keep

    def _admit_preempt(self) -> bool:
        """A blocked higher-class ARRIVAL preempts ONE strictly-lower-
        class slot (lowest class first, youngest within it) to take its
        slot + blocks — never a peer, so within-class age ordering (and
        with it the drain guarantee) is untouched. False when the
        policy is off or no strictly-lower-class victim exists."""
        if self.slo is None or not self.slo.preempt_on_admit:
            return False
        if not self.queue:
            return False
        head, _ = self.queue[0]
        r = _PRIORITY_RANK[head.priority]
        victims = [s for s in self.slots
                   if _PRIORITY_RANK[self.slots[s].req.priority] > r]
        if not victims:
            return False
        victim = max(victims, key=lambda s: (
            _PRIORITY_RANK[self.slots[s].req.priority],
            self.slots[s].seq))
        self.metrics.count("admit_preemptions")
        self._preempt(victim)
        return True

    def busy(self) -> bool:
        return bool(self.queue or self.slots)

    # ---- drain / eviction (the scale-down seams, docs/AUTOSCALE.md) ------

    def begin_drain(self) -> None:
        """Stop admissions for good: queued work must be evicted onto
        survivors (`evict_queued`), slotted work decodes to retirement
        under further `tick()`s. Idempotent."""
        if not self.draining:
            self.draining = True
            self.flight.record("drain_begin", queued=len(self.queue),
                               slotted=len(self.slots))

    def evict_queued(self) -> List[Tuple[Request, int]]:
        """Pop every still-queued (never admitted, or preempted-back)
        request for requeue on another replica. No partial state exists
        for these — replay elsewhere is bitwise by construction (same
        seed, same stream)."""
        out = list(self.queue)
        self.queue.clear()
        for req, preempts in out:
            self.flight.record("evict", rid=req.rid, state="queued",
                               preempted=preempts)
        return out

    def evict_slotted(self) -> List[Tuple[Request, int]]:
        """Forced (non-graceful) drain: tear every slot down, free its
        blocks, and return the requests with their preemption count
        bumped — the existing bitwise replay seam: a consumer discards
        the partial stream and the re-decode regenerates it identically
        from the seed (exactly what replica-death replay does)."""
        out: List[Tuple[Request, int]] = []
        for s in sorted(self.slots):
            slot = self.slots.pop(s)
            self.alloc.free(slot.blocks)
            self.tables[s, :] = 0
            self.decoding[s] = False
            self.pos[s] = 0
            self.pad[s] = 0
            self.free_slots.append(s)
            self.flight.record("evict", rid=slot.req.rid,
                               state="slotted",
                               emitted=len(slot.emitted),
                               preempted=slot.preempted + 1)
            out.append((slot.req, slot.preempted + 1))
        self.prefill_groups.clear()
        return out

    # ---- internals -------------------------------------------------------

    def _blocks_needed_at_admit(self, req: Request,
                                width: Optional[int] = None) -> int:
        """``width`` is the (padded) prefill width the slot will hold —
        the raw prompt length on single-slot engines."""
        if width is None:
            width = req.prompt.size
        if self.reserve == "worst_case":
            span = width + req.max_new_tokens
        elif self.cfg.prefill_batch > 1:
            # batched prefill writes exactly [0, width) — width is
            # already a chunk multiple; growth per decode boundary
            span = width
        else:
            # prefill writes full chunks: cover the prompt rounded up
            # to the chunk width (tail-chunk garbage lands in owned
            # blocks), growth happens per decode block boundary
            ch = self.cfg.prefill_chunk
            span = min(-(-width // ch) * ch, self.cfg.max_slot_len)
        return -(-span // self.spec.block_size)

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        """`BlockAllocator.alloc` with the prefix cache as the relief
        valve: when the free list is short, LRU cache entries whose
        block nothing else holds (refcount 1) are evicted to cover the
        shortfall before the caller defers or preempts."""
        if n <= 0:
            return []
        got = self.alloc.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict(n - self.alloc.free_blocks)
            got = self.alloc.alloc(n)
        return got

    def _admit_one(self, width: int) -> Optional[int]:
        """Admit the queue head into a free slot with blocks reserved
        for ``width`` prefill positions. Returns the slot id, or None
        when the pool is short (FIFO holds).

        With the prefix cache armed, the prompt's cumulative block
        digests are matched against cached chains first: matched FULL
        blocks map into the slot's table by incref (their prefill is
        skipped — ``pos`` starts past them), capped one block short of
        the prompt end so the slot's OWN final chunk always runs and
        computes ``last_logits``. A failed owned-tail allocation
        decrefs the held match exactly — a deferred admission leaks
        nothing."""
        req, preempts = self.queue[0]
        matched: List[int] = []
        hashes: List[bytes] = []
        if self.prefix is not None:
            P = self.spec.block_size
            hashes = prefix_block_hashes(req.prompt, P)
            cap = (req.prompt.size - 1) // P
            matched = self.prefix.match(hashes, max_blocks=cap)
        n_need = self._blocks_needed_at_admit(req, width) - len(matched)
        # hold the matched chain (incref) BEFORE the tail allocation:
        # the allocation may evict LRU cache entries, and an unheld
        # match at refcount 1 would be evictable out from under us
        if matched:
            self.alloc.incref(matched)
        blocks = self._alloc_or_evict(n_need)
        if blocks is None:
            if matched:
                self.alloc.decref(matched)
            return None  # pool short: keep FIFO order, retry next tick
        n_shared = len(matched) * self.spec.block_size
        blocks = matched + blocks
        self.queue.popleft()
        s = self.free_slots.pop(0)
        self._seq += 1
        slot = _Slot(req, blocks, preempts, self._seq)
        slot.shared_blocks = len(matched)
        slot.hashes = hashes
        slot.prefill_next = n_shared
        self.slots[s] = slot
        self.tables[s, :] = 0
        self.tables[s, :len(blocks)] = blocks
        self.pos[s] = n_shared
        self.decoding[s] = False
        self.pad[s] = width - req.prompt.size
        self.temp[s] = req.temperature
        self.top_k[s] = req.top_k or 0
        self.rngs[s] = _key_data(req.seed)
        self._queue_wait[req.rid] = (
            slot.admitted_at - req.arrival if req.arrival else 0.0)
        if self.prefix is not None:
            self.prefix.prompt_tokens += int(req.prompt.size)
            self.prefix.shared_tokens += n_shared
            if n_shared:
                self.metrics.count("prefix_hits")
                self.metrics.count("shared_prompt_tokens", n_shared)
        self.metrics.count("admissions")
        self.flight.record("admit", rid=req.rid, slot=s,
                           blocks=len(blocks), preempted=preempts,
                           shared=len(matched))
        return s

    def _admit(self) -> None:
        if self.draining:
            # admissions are closed: anything in the queue (including a
            # request a growth stall just preempted back) waits for the
            # driver's eviction pass, never re-admits here
            return
        if self.cfg.prefill_batch == 1:
            # slo=None: `_admit_preempt()` is a constant False, so this
            # is exactly the historical free-slot FIFO loop
            while self.queue and (self.free_slots
                                  or self._admit_preempt()):
                s = self._admit_one(self.queue[0][0].prompt.size)
                if s is None:
                    # pool short: try taking a strictly-lower-class
                    # slot's blocks; otherwise shed starved shed-class
                    # work behind the blocked head and defer
                    if self._admit_preempt():
                        continue
                    self._shed_starved()
                    self.metrics.count("admission_deferrals")
                    return
                self.prefill_groups.append(
                    _PrefillGroup([s], self.slots[s].req.prompt.size))
            return
        # batched admission: FIFO groups of up to prefill_batch
        # requests, every member right-aligned to the group width W =
        # the HEAD request's chunk-rounded prompt length. A longer
        # prompt at the queue head ends the group and heads the next
        # one (W never grows after member 1, so earlier members' block
        # reservations stay valid) — no request is ever skipped past.
        ch = self.cfg.prefill_chunk
        while self.queue and self.free_slots:
            group: List[int] = []
            width = 0
            while (self.queue and self.free_slots
                   and len(group) < self.cfg.prefill_batch):
                req, _ = self.queue[0]
                solo_w = -(-req.prompt.size // ch) * ch
                if not group:
                    width = solo_w
                elif (solo_w > width
                      or width + req.max_new_tokens
                      > self.cfg.max_slot_len):
                    break  # heads the next group instead
                s = self._admit_one(width)
                if s is None:
                    self.metrics.count("admission_deferrals")
                    break  # pool short
                group.append(s)
            if not group:
                return
            self.prefill_groups.append(_PrefillGroup(group, width))

    def _policy_key(self, slot: _Slot) -> Tuple[int, int]:
        """Preemption/growth policy order: (class rank, admission age).
        With slo=None every rank is 0, so the order — and every
        decision derived from it — is the historical seq-only age
        ordering (test-pinned)."""
        if self.slo is None:
            return (0, slot.seq)
        return (_PRIORITY_RANK[slot.req.priority], slot.seq)

    def _grow(self, s: int, slot: _Slot) -> bool:
        """Ensure every block a decode write can touch this tick
        exists: positions ``pos .. pos + spec_k - 1`` (k == 1 on the
        base engine). True = ok, False = pool empty (caller preempts)."""
        idx = (int(self.pos[s]) + self._spec_k - 1) \
            // self.spec.block_size
        while len(slot.blocks) <= idx:
            got = self._alloc_or_evict(1)
            if got is None:
                return False
            self.tables[s, len(slot.blocks)] = got[0]
            slot.blocks.extend(got)
        return True

    def _fork_for_window(self, s: int, slot: _Slot, start: int) -> bool:
        """Copy-on-write: before the prefill chunk's FULL ``ch``-wide
        window ``[start, start + ch)`` is written, any block in the
        window with refcount > 1 (shared with the prefix cache or a
        sibling slot) is forked — copied into a fresh block the slot
        repoints its table at — so a non-exclusive block is never
        written. Reached only when the window slides back across the
        shared prefix (prompt near the slot end); the rewrite is
        value-identical on the reference path, but forking keeps the
        invariant robust on every path. True = ok, False = pool dry
        (caller preempts the prefilling slot)."""
        P = self.spec.block_size
        lo = start // P
        hi = min((start + self.cfg.prefill_chunk - 1) // P,
                 len(slot.blocks) - 1)
        for bi in range(lo, hi + 1):
            b = slot.blocks[bi]
            if self.alloc.refcount(b) <= 1:
                continue
            got = self._alloc_or_evict(1)
            if got is None:
                return False
            self.engine.copy_block(b, got[0])
            slot.blocks[bi] = got[0]
            self.tables[s, bi] = got[0]
            self.alloc.decref([b])
            if bi < slot.shared_blocks:
                slot.shared_blocks = bi
            self.metrics.count("block_forks")
            self.flight.record("fork", rid=slot.req.rid, slot=s,
                               block=int(b), copy=int(got[0]))
        return True

    def _preempt(self, s: int) -> None:
        """Return a slot's request to the queue head for deterministic
        replay from scratch (same seed -> same tokens; emitted-so-far
        is discarded, the stream restarts delayed but identical)."""
        slot = self.slots.pop(s)
        self.last_preemptions.append(slot.req.rid)
        self.last_preemption_details.append(self._partial_timing(
            slot, time.perf_counter(), preempted=slot.preempted + 1))
        self.metrics.count("preemptions")
        self.flight.record("preempt", rid=slot.req.rid, slot=s,
                           emitted=len(slot.emitted),
                           preempted=slot.preempted + 1)
        self.alloc.free(slot.blocks)
        self.tables[s, :] = 0
        self.decoding[s] = False
        self.pos[s] = 0
        self.pad[s] = 0
        for g in list(self.prefill_groups):
            if s in g.slots:
                g.slots.remove(s)
                if not g.slots:  # group emptied mid-prefill
                    self.prefill_groups.remove(g)
                break
        self.free_slots.append(s)
        if self.slo is None:
            self.queue.appendleft((slot.req, slot.preempted + 1))
        else:
            # front of its CLASS, not of the whole queue — a preempted
            # best-effort request must not jump a latency-critical one
            self._insert_by_class(slot.req, slot.preempted + 1,
                                  front_of_class=True)

    def _retire(self, s: int, reason: str) -> Completion:
        slot = self.slots.pop(s)
        now = time.perf_counter()
        first = slot.first_token_at or now
        comp = Completion(
            rid=slot.req.rid,
            tokens=list(slot.emitted),
            finish_reason=reason,
            queue_wait_s=self._queue_wait.pop(slot.req.rid, 0.0),
            ttft_s=first - slot.admitted_at,
            decode_s=now - first,
            preempted=slot.preempted,
            priority=slot.req.priority,
        )
        self.alloc.free(slot.blocks)
        self.tables[s, :] = 0
        self.decoding[s] = False
        self.pos[s] = 0
        self.pad[s] = 0
        self.free_slots.append(s)
        self.completions.append(comp)
        m = self.metrics
        if m.enabled:
            m.count("completions")
            m.observe("queue_wait_s", comp.queue_wait_s)
            m.observe("ttft_s", comp.ttft_s)
            m.observe("tpot_s", comp.tpot_s)
            m.observe("decode_s", comp.decode_s)
            if self.slo is not None:
                # class-keyed twins: `observe()` auto-creates the
                # histogram, so `serving.ttft_<class>_p95_s` watch
                # selectors resolve with zero grammar change
                p = comp.priority
                m.count(f"completions_{p}")
                m.observe(f"ttft_{p}_s", comp.ttft_s)
                m.observe(f"tpot_{p}_s", comp.tpot_s)
                m.observe(f"queue_wait_{p}_s", comp.queue_wait_s)
        self.flight.record("retire", rid=comp.rid, slot=s, reason=reason,
                           tokens=len(comp.tokens),
                           preempted=comp.preempted)
        return comp

    # ---- the tick --------------------------------------------------------

    def tick(self) -> List[Completion]:
        """Admit -> prefill-chunk pick -> engine step -> account.
        Returns the requests that COMPLETED this tick."""
        self.last_preemptions = []
        self.last_preemption_details = []
        self._admit()
        # growth check before the step: every decoding slot must own
        # the block its write lands in. On a dry pool a grower may only
        # evict slots STRICTLY AFTER itself in policy order (decoding
        # or prefilling — a re-admitted request is always the
        # youngest); with no victim it preempts ITSELF. Policy order is
        # (class rank, admission seq): with slo=None every rank is 0
        # and this is the byte-identical historical age ordering; armed,
        # a grower may evict strictly-lower-class slots of ANY age and
        # same-class slots only if strictly younger — never peers. The
        # policy-minimal slot is therefore never evicted and strictly
        # progresses every tick, so the system drains — any policy that
        # lets a later grower evict an earlier slot (or the grower
        # evict itself while holding victims) lets two oversubscribed
        # requests cycle forever (observed livelock, test-pinned
        # against).
        for s in sorted([s for s in self.slots if self.decoding[s]],
                        key=lambda s: self._policy_key(self.slots[s])):
            if s not in self.slots:
                continue  # preempted as a victim earlier this tick
            me = self.slots[s]
            me_key = self._policy_key(me)
            while not self._grow(s, me):
                # a dry pool at a growth boundary: the signal item 1(c)
                # autoscale watches — every stall is one eviction (or a
                # self-preempt) the pool's size forced
                self.metrics.count("growth_stalls")
                victims = [v for v in self.slots
                           if self._policy_key(self.slots[v]) > me_key]
                if victims:
                    self._preempt(max(
                        victims,
                        key=lambda v: self._policy_key(self.slots[v])))
                elif len(self.slots) > 1:
                    # s is the youngest: yield its blocks to its elders
                    self._preempt(s)
                    break
                else:
                    # alone and still dry — unreachable when submit()
                    # holds its pool-size invariant (a lone slot's span
                    # fits the pool); requeueing would re-admit into
                    # the same state forever, so fail loudly instead
                    raise RuntimeError(
                        f"request {me.req.rid} cannot grow with the "
                        "pool to itself — engine pool is smaller than "
                        "one request's span")
        # one prefill chunk, FIFO over admitted-but-not-decoding groups
        prefill = idle_prefill(self.cfg)
        pf_group = self.prefill_groups[0] if self.prefill_groups else None
        ch = self.cfg.prefill_chunk
        if pf_group is not None and self.cfg.prefill_batch == 1:
            pf_slot = pf_group.slots[0]
            slot = self.slots[pf_slot]
            ptoks = slot.req.prompt
            ppos = slot.prefill_next
            chunk_len = min(ch, ptoks.size - ppos)
            # the engine writes the FULL ch-wide window: slide the
            # window start back so it never crosses the slot end —
            # otherwise the model's in-cache update and the pool
            # scatter both clamp and scribble real prompt entries
            # (review finding, regression-pinned). Re-sent rows
            # recompute bitwise-identical K/V: each row's causal mask
            # restricts it to the same context as its original pass.
            start = min(ppos, self.cfg.max_slot_len - ch)
            if self.prefix is not None and not self._fork_for_window(
                    pf_slot, slot, start):
                # pool dry under a copy-on-write fork: bounce the
                # prefilling request back to the queue (deterministic
                # replay) and run this tick without a prefill chunk
                self._preempt(pf_slot)
                pf_group = None
            else:
                n_win = min(ch, ptoks.size - start)
                chunk = np.zeros(ch, np.int32)
                chunk[:n_win] = ptoks[start:start + n_win]
                finished = ppos + chunk_len >= ptoks.size
                last_row = (ptoks.size - 1 - start) if finished else -1
                prefill = (np.int32(pf_slot), chunk, np.int32(start),
                           np.int32(last_row))
        elif pf_group is not None:
            # batched lane: the head group advances one shared chunk;
            # every row's LEFT-padded prompt is right-aligned to the
            # group width, so the final chunk's last real token sits in
            # the same column for every row (no window sliding: the
            # width is a chunk multiple by construction)
            B = self.cfg.prefill_batch
            start = pf_group.next
            toks = np.zeros((B, ch), np.int32)
            slots_arr = np.full(B, -1, np.int32)
            pads = np.zeros(B, np.int32)
            for r, s in enumerate(pf_group.slots):
                req = self.slots[s].req
                pad = int(self.pad[s])
                slots_arr[r] = s
                pads[r] = pad
                # padded row: pad zeros then the prompt; this chunk is
                # padded_row[start : start + ch]
                p = start - pad + np.arange(ch)
                valid = (p >= 0) & (p < req.prompt.size)
                toks[r, valid] = req.prompt[p[valid]]
            finished = start + ch >= pf_group.width
            last_row = (pf_group.width - 1 - start) if finished else -1
            prefill = (slots_arr, toks, np.int32(start),
                       np.int32(last_row), pads)
        was_decoding = self.decoding.copy()
        emitted, n_emit, self.rngs = self.engine.tick(
            self.tables, self.pos, self.decoding, self.temp, self.top_k,
            self.rngs, prefill,
            pad=self.pad if self.cfg.prefill_batch > 1 else None)
        self._occupancy_sum += float(was_decoding.mean())
        self._ticks += 1
        # prefill accounting
        if pf_group is not None and self.cfg.prefill_batch == 1:
            pf_slot = pf_group.slots[0]
            slot = self.slots[pf_slot]
            chunk_len = min(ch, slot.req.prompt.size - slot.prefill_next)
            slot.prefill_next += chunk_len
            self.pos[pf_slot] += chunk_len
            self.prefill_tokens_issued += chunk_len
            if slot.prefill_next >= slot.req.prompt.size:
                self.prefill_groups.popleft()
                self.decoding[pf_slot] = True
                if self.prefix is not None:
                    # publish the fully prefilled chain: every FULL
                    # prompt block becomes matchable for later admits
                    n_full = (slot.req.prompt.size
                              // self.spec.block_size)
                    self.prefix.register(slot.hashes[:n_full],
                                         slot.blocks[:n_full])
        elif pf_group is not None:
            pf_group.next += ch
            for s in pf_group.slots:
                self.pos[s] += ch  # cache positions incl. pad columns
            self.prefill_tokens_issued += ch * len(pf_group.slots)
            if pf_group.next >= pf_group.width:
                self.prefill_groups.popleft()
                for s in pf_group.slots:
                    self.decoding[s] = True
        # decode accounting — the engine hands back up to W tokens per
        # slot (W == 1 on the base step): append in order, truncating
        # at eos / max_new exactly where plain greedy decode stops
        done: List[Completion] = []
        self.last_emissions = []
        n_active = int(was_decoding.sum())
        if n_active:
            self._decode_slot_steps += n_active
            self._emitted_total += int(n_emit[was_decoding].sum())
        for s in list(self.slots):
            if not was_decoding[s]:
                continue
            slot = self.slots[s]
            if slot.first_token_at is None:
                slot.first_token_at = time.perf_counter()
            req = slot.req
            for _j in range(int(n_emit[s])):
                tok = int(emitted[s, _j])
                slot.emitted.append(tok)
                self.last_emissions.append((req.rid, tok))
                self.pos[s] += 1
                if req.eos_id is not None and tok == req.eos_id:
                    done.append(self._retire(s, "eos"))
                    break
                if len(slot.emitted) >= req.max_new_tokens:
                    done.append(self._retire(s, "length"))
                    break
        m = self.metrics
        if m.enabled or self.flight.enabled:
            # every value below is host bookkeeping the tick already
            # holds in plain python/numpy — no device array is touched
            queue_depth = len(self.queue)
            decoding = int(self.decoding.sum())
            prefilling = sum(len(g.slots) for g in self.prefill_groups)
            free = self.alloc.free_blocks
            total = self.spec.n_blocks - 1  # block 0 is scratch
            if m.enabled:
                m.gauge("queue_depth", queue_depth)
                m.gauge("decoding_slots", decoding)
                m.gauge("prefilling_slots", prefilling)
                m.gauge("free_slots", len(self.free_slots))
                m.gauge("blocks_free", free)
                m.gauge("blocks_in_use", total - free)
                m.gauge("slot_occupancy", float(was_decoding.mean()))
                if self.slo is not None:
                    # per-class pressure feeds `load_signal()`'s
                    # pressure_<class> fields (autoscale + watch);
                    # emitted only when the policy is armed so a
                    # priority-off run's metrics stream is unchanged
                    for p in PRIORITIES:
                        m.gauge(f"queue_depth_{p}",
                                self._queued_in_class(p))
            self.flight.record("tick", tick=self._ticks,
                               queue_depth=queue_depth,
                               decoding=decoding, prefilling=prefilling,
                               blocks_free=free,
                               completed=len(done))
            m.tick_end()
        return done

    # ---- metrics ---------------------------------------------------------

    @property
    def slot_occupancy(self) -> float:
        """Mean decoding-slot fraction over all ticks so far."""
        return self._occupancy_sum / max(1, self._ticks)

    @property
    def shared_block_fraction(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache instead of the prefill lane (0.0 with the cache off or
        when no prompts shared a prefix)."""
        return (self.prefix.shared_block_fraction
                if self.prefix is not None else 0.0)

    @property
    def accepted_tokens_per_step(self) -> float:
        """Mean tokens emitted per decoding slot per engine tick —
        exactly 1.0 on the base engine, ``1 + mean accepted
        proposals`` under speculative decoding (the throughput
        multiplier the draft buys)."""
        if not self._decode_slot_steps:
            return 1.0
        return self._emitted_total / self._decode_slot_steps

    def _partial_timing(self, slot: _Slot, now: float,
                        preempted: int) -> dict:
        """One request's partial-progress timing — the shared shape
        behind `last_preemption_details` and `inflight_snapshot` (the
        driver back-dates spans from exactly these fields, so the two
        accountings can never drift apart)."""
        first = slot.first_token_at
        return {
            "rid": slot.req.rid,
            "queue_wait_s": self._queue_wait.get(slot.req.rid, 0.0),
            "prefill_s": (first if first is not None else now)
            - slot.admitted_at,
            "decode_s": (now - first) if first is not None else 0.0,
            "emitted": len(slot.emitted),
            "preempted": preempted,
        }

    def inflight_snapshot(self) -> List[dict]:
        """Partial-progress timing for every request the scheduler
        still holds — slotted (prefilling/decoding) and queued. The
        driver records these as INFLIGHT-tagged serving spans at drain
        time, so a run that stops mid-flight (replica death, shutdown)
        accounts the wall its unfinished requests already spent instead
        of dropping it (docs/OBSERVABILITY.md "serving spans")."""
        now = time.perf_counter()
        out: List[dict] = []
        for s, slot in self.slots.items():
            out.append({
                **self._partial_timing(slot, now,
                                       preempted=slot.preempted),
                "state": "decoding" if self.decoding[s]
                else "prefilling",
            })
        for req, preempts in self.queue:
            out.append({
                "rid": req.rid, "state": "queued",
                "queue_wait_s": (now - req.arrival) if req.arrival
                else 0.0,
                "prefill_s": 0.0, "decode_s": 0.0, "emitted": 0,
                "preempted": preempts,
            })
        return out
