"""Finding/rule vocabulary shared by the port's analysis engines (twin of
`ray_lightning_tpu/analysis/findings.py`).

One `Finding` type and one rule registry serve the AST linter
(analysis/linter.py), threadcheck (analysis/concurrency.py), the runtime
lock-order watcher (analysis/lockwatch.py) and the plan checker
(analysis/plan_checker.py), so the CLI, the JSON report and the
suppression syntax (``# rlt: disable=RULE``) are engine-agnostic.

The registry is the JAX package's row for row: the same ids, names,
default severities and summaries. A summary differs only where the port
flags the torch defect of the rule's class (RLT201, RLT202, RLT204,
RLT304, RLT402, RLT502). A rule the port does not flag keeps its row and
carries the reason in `Rule.not_flagged`: the JAX idioms it reads have
no torch counterpart (RLT106, RLT203, RLT205). tracecheck flags RLT301-303
and RLT305-308, numcheck RLT801-805 (`tracecheck.py`, `numcheck.py`,
`serve/audit.py`). ``lint --list-rules`` prints the reason.

Severity contract:
  error   — the training job will fail, silently mis-shard, or stall the
            device every step at scale; the lint CLI's default fail gate
  warning — a footgun that costs memory/determinism but may be intended
  note    — informational

Imports neither torch nor numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: severity name -> rank, for threshold comparisons
SEVERITY_RANK: Dict[str, int] = {"note": 0, "warning": 1, "error": 2}

#: the TpuModule hooks the Trainer runs once a batch: the linter's seed
#: of step code (the JAX package's jit-traced hooks)
TRACED_STEP_HOOKS: Tuple[str, ...] = (
    "training_step", "validation_step", "test_step", "predict_step",
)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str  # default severity; findings may not override upward
    summary: str
    #: why the port does not flag this rule (None: it does)
    not_flagged: Optional[str] = None


#: every rule of the JAX registry, in its order
_ROWS = (
    Rule("RLT001", "parse-error", "error",
         "target file does not parse; nothing else can be checked"),
    Rule("RLT101", "unknown-mesh-axis", "error",
         "PartitionSpec names a mesh axis that does not exist (typo'd "
         "axes are silently dropped -> the leaf replicates -> OOM at "
         "scale)"),
    Rule("RLT102", "uneven-shard", "error",
         "a sharded dim is not divisible by its mesh axis product; the "
         "leaf cannot be partitioned evenly"),
    Rule("RLT103", "duplicate-mesh-axis", "error",
         "the same mesh axis appears twice in one PartitionSpec"),
    Rule("RLT104", "spec-rank-mismatch", "error",
         "PartitionSpec has more entries than the parameter has dims"),
    Rule("RLT105", "opt-dtype-widening", "warning",
         "optimizer-state leaf stored wider than its parameter "
         "(silent multi-x optimizer HBM)"),
    Rule("RLT106", "donation-mismatch", "error",
         "a donated input buffer has no output with matching "
         "shape/dtype/sharding to alias; the donation is wasted"),
    Rule("RLT107", "stale-spec-path", "warning",
         "param_specs path matches no parameter (renamed layer? the "
         "spec silently does nothing)"),
    Rule("RLT201", "host-transfer-in-step", "error",
         "host transfer (.item()/.tolist()/.cpu()/.numpy()/np.asarray/"
         "torch.cuda.synchronize()/...) inside a training step forces "
         "a device sync per step"),
    Rule("RLT202", "python-rng-in-step", "error",
         "Python/numpy RNG, or a torch sampling call given no "
         "generator=, inside a training step is not drawn from the "
         "module's seeded torch.Generator: the draws differ across "
         "ranks and resumes; pass the module's generator"),
    Rule("RLT203", "wallclock-in-step", "warning",
         "time.time()/datetime.now() inside traced code runs at trace "
         "time only, not per step"),
    Rule("RLT204", "print-in-step", "warning",
         "print() inside a training step runs every step: formatting a "
         "tensor argument copies it to the host (a device sync per "
         "step) and puts console I/O on the hot path; log through "
         "self.log or on the log cadence"),
    Rule("RLT205", "unhashable-static-arg", "error",
         "static argument of a jitted function is unhashable (or names "
         "a parameter that does not exist) — TypeError or a recompile "
         "per call"),
    Rule("RLT206", "unordered-iteration", "warning",
         "iteration over an unordered collection (set/vars()) while "
         "building traced structure; pytree order can differ across "
         "processes"),
    # RLT3xx — tracecheck (a graph walk of the real train step; not
    # ported yet: NOT_FLAGGED) but for RLT304 and RLT309, which the
    # linter flags from source.
    Rule("RLT301", "reshard-implicit", "error",
         "in/out sharding mismatch makes XLA insert a collective the "
         "plan never asked for (an activation all-gather or a reshard "
         "between mesh axes) — silent ICI traffic every step"),
    Rule("RLT302", "hbm-overcommit", "error",
         "the traced step's estimated peak HBM (params + opt state + "
         "activation high-water mark) exceeds the target chip's budget; "
         "the job will OOM at compile or at runtime"),
    Rule("RLT304", "host-sync-in-hot-loop", "warning",
         "a per-batch training loop synchronizes with the device every "
         "step (float()/int()/np.asarray()/.item()/.tolist()/.cpu() on "
         "step outputs, or torch.cuda.synchronize(), outside the log "
         "cadence) or places batches with an un-prefetched .cuda()/"
         ".to(device) on the critical path — each one drains the "
         "device's queue of launched work; fetch on a cadence and use "
         "the device prefetch pipeline (pipeline.DevicePrefetcher)"),
    Rule("RLT305", "exposed-collective-in-scan", "warning",
         "a blocking collective inside a scanned layer body whose "
         "operand is loop-invariant (a ZeRO/FSDP weight gather of a "
         "parameter slice — prefetchable one trip ahead) sits exposed "
         "on the critical path every trip; enable the sharding plan's "
         "overlap knob (FSDP/ShardedMesh(overlap='on')) to hide it "
         "behind the previous layer's compute "
         "(docs/PERFORMANCE.md 'collective overlap')"),
    Rule("RLT306", "dcn-crossing-shard-axis", "warning",
         "a tensor/fsdp/seq/expert/pipe mesh axis spans DCN slices on a "
         "multi-slice topology: its per-layer collectives (weight "
         "gathers, tensor psums, ring permutes) would ride the slow "
         "inter-slice network every step — an order-of-magnitude "
         "performance cliff. Only the `data` axis belongs across "
         "slices (hierarchical gradient reduction, docs/ELASTIC.md "
         "'DCN cost model'); re-shape the mesh so the crossing axis "
         "fits inside one slice"),
    Rule("RLT307", "dense-paged-gather", "warning",
         "a serving decode step materializes a dense slot-gathered KV "
         "view of the block-paged pool ([L, capacity, gathered_len, "
         "Hkv, hd] per tick — ~half the replica's serving HBM and a "
         "full pool copy of traffic) although the fused paged-attention "
         "kernel supports the shape: the kernel consumes the pool "
         "directly through the block tables and retires the copy "
         "(ops/pallas/paged_attention.py; selected automatically on "
         "TPU — docs/SERVING.md 'paged-attention kernel'). The "
         "cond-nested prefill gather is RLT308's domain"),
    Rule("RLT308", "dense-paged-prefill-gather", "warning",
         "a serving step's PREFILL lane materializes a dense "
         "group-sized KV view of the block-paged pool ([L, "
         "prefill_batch, gathered_len, Hkv, hd] per chunk — the last "
         "dense gather on the serving hot path, a per-chunk copy of "
         "HBM traffic) although the fused paged-prefill kernel "
         "supports the shape: the kernel attends causally through the "
         "block tables with the chunk's K/V scattered straight into "
         "owned pool blocks, and the gather never exists "
         "(ops/pallas/paged_prefill.py; selected automatically on TPU "
         "— docs/SERVING.md 'paged prefill kernel'). Shapes the "
         "kernel cannot tile keep the historical sanction"),
    Rule("RLT309", "redundant-prefix-prefill", "warning",
         "a serve-side loop submits one request per iteration whose "
         "prompt prepends a LOOP-INVARIANT prefix (a shared system "
         "prompt) without prefix_cache=True anywhere in the file: "
         "every request re-prefills the identical prefix tokens and "
         "pins its own pool copy of those blocks, so prefill compute "
         "and KV HBM both scale with the stream count instead of "
         "once. Arm the scheduler's prefix cache — the common prefix "
         "prefills ONCE and its full blocks map into every table by "
         "refcount, copy-on-write on divergence (serve/kv_cache.py "
         "PrefixCache, docs/SERVING.md 'prefix cache')"),
    Rule("RLT303", "ring-deadlock", "error",
         "a ppermute permutation is not a valid schedule (duplicate "
         "source/destination, out-of-range rank, a full permutation "
         "that is not a single cycle) or collective sequences diverge "
         "across cond branches — SPMD ranks deadlock or exchange "
         "garbage"),
    # RLT4xx — resilience anti-patterns: code shapes that defeat the
    # supervision layer's failure classification.
    Rule("RLT402", "nan-through-where", "warning",
         "torch.where(cond, f(x), safe) with f in log/sqrt/div/pow "
         "evaluates BOTH branches: the untaken branch's NaN/inf flows "
         "back through its gradient and poisons the whole gradient "
         "(the trap the trainguard then has to skip at runtime). Mask "
         "the INPUT (torch.where(cond, x, 1.0) inside f), not the "
         "output. Also fires on unguarded torch.log/torch.sqrt of raw "
         "batch values in a training step"),
    Rule("RLT401", "unsupervised-worker-failure", "warning",
         "a bare/broad except silently swallows worker-group failures "
         "(WorkerError never reaches the supervisor, so a dead rank "
         "looks like success), or a started WorkerGroup has no "
         "shutdown() in a finally / context manager (a failure leaks "
         "worker processes and their hosts' chips)"),
    # RLT5xx — telemetry and serving misuse: instrumentation that
    # becomes the overhead it measures, requests dropped untyped.
    Rule("RLT501", "telemetry-misuse", "warning",
         "telemetry emission (TelemetryRecorder span/record/flush, "
         "profiler start/stop) inside a per-batch loop without a "
         "cadence guard — per-step file flushes/captures stall the hot "
         "loop the spans exist to measure (buffer in the bounded ring, "
         "flush on `if step %% N == 0`) — or an unbounded event-list "
         "append in a per-batch Callback hook with no ring/truncation/"
         "flush anywhere in the class (the list grows for the life of "
         "the run; use a deque(maxlen=...) or truncate)"),
    Rule("RLT502", "serve-loop-recompile", "warning",
         "a decode/serve loop calls a torch.compile'd function with a "
         "Python-varying shape (a sequence buffer grown by torch.cat "
         "every iteration, or an argument sliced to an un-bucketed "
         "per-iteration length): every new shape silently recompiles, "
         "turning request churn into a compile storm. Keep device "
         "shapes fixed — decode into a position-indexed KV cache, pad "
         "prompts to buckets, or use the fixed-capacity slot engine "
         "(serve.DecodeEngine)"),
    Rule("RLT503", "unbounded-ledger-read", "warning",
         "a cadence-polled code path (a sleep-loop — monitor --follow, "
         "a controller poll, watch evaluation) parses an ENTIRE *.jsonl "
         "evidence ledger into memory every poll: the ledger grows for "
         "the life of the run, so the poll cost grows without bound "
         "and the live view eventually spends its whole interval "
         "re-parsing history it already saw. Thread a tail/window "
         "bound (read_spans/read_metrics tail_bytes=, load_signal "
         "window=) — the readers keep the clock-alignment header and "
         "the newest entries, which is all a live view needs"),
    Rule("RLT504", "per-token-channel-chatter", "warning",
         "a per-decode-tick loop does an unbatched channel send/recv "
         "PER TOKEN (a queue put / channel send / reader poll inside a "
         "for-loop over the tick's emissions): every emitted token "
         "pays a syscall + fsync + wakeup, so the wire chatter scales "
         "with tokens/tick instead of ticks, and the worker loop "
         "stalls on I/O the engine tick already amortized. Batch the "
         "tick's emissions into ONE side-channel item and ack ONE "
         "highest-seq per poll batch (serve/channel.py, "
         "docs/SERVING.md 'the request channel')"),
    Rule("RLT505", "silent-request-drop", "error",
         "serving code makes a request disappear without a typed "
         "record: a broad except whose body only passes wrapped "
         "around a submit()/enqueue() call, or take_sheds() drained "
         "as a bare statement (/ a last_sheds/last_preemptions "
         "buffer cleared unread) — the stream never gets a terminal "
         "status, the client retries blind, and the loss is "
         "invisible to watch/metrics. The graceful-overload contract "
         "is EXPLICIT degradation: every rejected rid ends with a "
         "reason + capped-exponential retry-after hint "
         "(docs/SERVING.md 'traffic & SLO classes')"),
    # RLT6xx — elasticity anti-patterns: code that pins a job to one
    # world size for life.
    Rule("RLT601", "pinned-world-size", "warning",
         "batch/rank math hardcodes a device count (a `batch // 8` / "
         "`world % 16` against an integer literal, or an ==/!= assert "
         "pinning jax.device_count()/len(jax.devices()) to a specific "
         "N): the code breaks the moment the elastic supervisor "
         "reshards the job onto a different world size. Derive the "
         "divisor from the mesh (parallel.mesh.batch_size_divisor, "
         "plan.dp_degree, MeshSpec.resolve) and gate on capability "
         "(> 1), not on a pinned count (docs/ELASTIC.md)"),
    # RLT7xx — threadcheck (analysis/concurrency.py): host-side
    # concurrency. RLT702/RLT705 are also emitted at run time by the
    # lock-order watcher (analysis/lockwatch.py) — same id, proven by
    # observation instead of from source text.
    Rule("RLT701", "unguarded-shared-mutation", "error",
         "an instance attribute is WRITTEN in thread-reachable code "
         "(the body of a threading.Thread target, or anything it calls "
         "in-file) and read or written outside it with no common lock "
         "held at both sites — a data race on host state. Guard both "
         "sides with one lock, or hand the value over through a "
         "synchronized carrier (queue.Queue, threading.Event, "
         "deque(maxlen=...) — their receivers are sanctioned as their "
         "own synchronization)"),
    Rule("RLT702", "lock-order-inversion", "error",
         "the package-wide lock-acquisition graph (lock B acquired "
         "while lock A is held, from nested `with` chains and "
         "cross-function calls) contains a cycle: two threads taking "
         "the locks in opposite orders can deadlock. Impose one global "
         "order, or narrow one critical section so the locks are never "
         "held together"),
    Rule("RLT703", "thread-leak", "warning",
         "a started non-daemon thread has no join() on any path (not "
         "joined in the spawning scope, a finally, or a close/shutdown "
         "method of the owning class): process exit blocks on it "
         "forever. Join it on the exit path, or mark it daemon=True if "
         "abandoning mid-work is genuinely safe"),
    Rule("RLT704", "signal-unsafe-handler", "warning",
         "a signal.signal handler does more than flag-and-return "
         "(set a flag/Event, os.write to a raw fd, os._exit) — locks, "
         "print/logging, file I/O, or queue ops inside a handler can "
         "deadlock on the interrupted thread's own held resources. "
         "The bench.py/preempt.py discipline: the handler records, the "
         "loop reacts at the next batch boundary"),
    Rule("RLT705", "blocking-call-under-lock", "warning",
         "a blocking call (sleep, thread join, subprocess, untimed "
         "queue.get/put, file/socket I/O) runs while a lock is held, "
         "stalling every thread contending for it. Copy state out "
         "under the lock and do the slow work outside. A lock whose "
         "EVERY critical section is the same I/O (a dedicated "
         "append-serialization lock) is sanctioned — the hazard is a "
         "lock that also guards in-memory state"),
    # RLT8xx — numcheck (a dtype walk of the train step's operator
    # stream).
    Rule("RLT801", "low-precision-accumulation", "error",
         "a dot_general or reduce-sum accumulates in bf16/f16 over a "
         "large contraction extent (missing "
         "preferred_element_type=f32): each bf16 add keeps 8 mantissa "
         "bits, so a K-term sum loses ~log2(K) of them — at K=4096 "
         "half the mantissa is noise. Small extents are sanctioned "
         "(the error is bounded by the extent)"),
    Rule("RLT802", "unstable-primitive-in-low-precision", "warning",
         "exp/log/rsqrt (the softmax/logsumexp/variance building "
         "blocks) computed on a bf16/f16 value with no f32 upcast: "
         "exp overflows bf16 at x>88 unless the operand is max-"
         "subtracted (sub-max inputs are sanctioned), log/rsqrt lose "
         "their low-order bits exactly where the result is largest. "
         "The pallas kernels' f32 scratch is sanctioned by "
         "construction (their operands are already f32)"),
    Rule("RLT803", "cast-churn", "warning",
         "an f32 value is rounded to bf16/f16 and converted straight "
         "back to f32 with no compute in between (only layout ops or "
         "a scan carry boundary): the round trip buys nothing, costs "
         "a rounding, and writes both copies through HBM"),
    Rule("RLT804", "low-precision-gradient-collective", "error",
         "a gradient psum/reduce_scatter runs on a bf16/f16 payload "
         "whose optimizer state is stored wider (f32): the ring "
         "reduction accumulates in the wire dtype, so the N-shard sum "
         "loses precision BEFORE the optimizer ever sees it — widen "
         "the gradient (preferred_element_type=f32 on the backward "
         "matmuls) so the reduction rides f32"),
    Rule("RLT805", "quant-contract", "error",
         "an int8/int4-origin value is consumed by float arithmetic "
         "with no dequantization scale applied (no multiply by an "
         "f32 scale between the int load and the math), or its scale "
         "is itself narrower than f32: the quantized payload is "
         "garbage without its scale, and a bf16 scale re-quantizes "
         "the error the int8 encoding already paid for"),
)


#: rule id -> why the port does not flag it
NOT_FLAGGED: Dict[str, str] = {
    "RLT106": ("not flagged in the port: a torch step updates parameters "
               "and optimizer state in place, so there are no donated "
               "buffers to alias; check_plan reports the rule as not "
               "checked"),
    "RLT203": ("not flagged in the port: its steps run eagerly, so "
               "time.time() in a step runs every step as written; no "
               "trace-time value is baked in"),
    "RLT205": ("not flagged in the port: torch.compile takes no static "
               "arguments and the port compiles nothing, so there is no "
               "jit static-argument contract to break"),
}

#: every rule, by id
RULES: Dict[str, Rule] = {
    r.id: dataclasses.replace(r, not_flagged=NOT_FLAGGED.get(r.id))
    for r in _ROWS}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect, pointing either at source (file/line/col) or at a
    named location (symbol: a parameter, a lock)."""

    rule: str
    message: str
    severity: Optional[str] = None  # default: the rule's severity
    file: Optional[str] = None
    line: Optional[int] = None
    col: Optional[int] = None
    symbol: Optional[str] = None

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        if self.severity is None:
            object.__setattr__(self, "severity", RULES[self.rule].severity)
        elif self.severity not in SEVERITY_RANK:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "name": RULES[self.rule].name,
             "severity": self.severity, "message": self.message}
        for k in ("file", "line", "col", "symbol"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    def format(self) -> str:
        loc = ""
        if self.file is not None:
            loc = self.file
            if self.line is not None:
                loc += f":{self.line}"
                if self.col is not None:
                    loc += f":{self.col}"
            loc += ": "
        elif self.symbol is not None:
            loc = f"{self.symbol}: "
        tail = f" [{self.symbol}]" if self.file and self.symbol else ""
        return (f"{loc}{self.severity} {self.rule} "
                f"({RULES[self.rule].name}): {self.message}{tail}")


def max_severity(findings) -> int:
    """Highest severity rank present (-1 when clean)."""
    return max((SEVERITY_RANK[f.severity] for f in findings), default=-1)


def meets(findings, threshold: str) -> bool:
    """True when any finding is at or above `threshold`."""
    return max_severity(findings) >= SEVERITY_RANK[threshold]
