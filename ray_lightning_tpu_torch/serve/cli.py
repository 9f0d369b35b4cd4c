"""``python -m ray_lightning_tpu_torch serve``: the serving front end and
its smoke gate (twin of `ray_lightning_tpu/serve/cli.py`).

    python -m ray_lightning_tpu_torch serve example          # the card
    python -m ray_lightning_tpu_torch serve example --replicas 2 \\
        --backend process [--device cpu]                  # process replicas
    python -m ray_lightning_tpu_torch serve --smoke --device cpu  # the gate
    python -m ray_lightning_tpu_torch serve llama3-8b          # the plan
    python -m ray_lightning_tpu_torch serve llama3-8b --autotune out.json

``example`` serves 8 synthetic requests on a small kernel-tiling Llama
(head_dim 64, GQA 2:1; bf16 on the card, f32 on the CPU) through the
driver. ``--smoke`` is the CPU gate, in f32 where its oracles are
bitwise; it exits 1 unless ALL of:

  * inline churn: 8 staggered streams (ragged prompts, greedy and
    sampled, per-request seeds) through one replica's kernel lanes equal
    8 independent `generate` runs; the churn builds no kernel library
    (`ops.build.build_seconds` unchanged) and every tick calls each
    kernel wrapper the count `chip_smoke.py` phase 4 holds its launches
    to (the JAX gate's compile-count pin has no twin in an eager engine:
    ``compile_count`` is -1);
  * two process replicas, one SIGKILL'd mid-stream: classified,
    respawned, the lost streams replayed bitwise, the survivor
    untouched;
  * the metrics legs: the churn run's metrics JSONL counts every
    completion, the histogram merge across the two process replicas is
    exact and order-free, the SIGKILL leaves a ``flight.json`` with the
    final ticks and the classification, and `load_signal` reports;
  * the paged decode and the paged prefill: the kernel lanes (on the
    CPU, the wrappers' plain versions) serve 8 streams token for token
    equal to the reference lanes;
  * prefix sharing: a fleet behind one system prompt equals per-stream
    `generate` with fewer prefill tokens than without the cache;
  * speculative decoding: greedy streams through a draft-armed engine
    (an independent draft, k 3) equal plain greedy `generate`, at one
    token or more a slot-step.

``llama3-8b`` is the static serve plan (`serve/audit.py`) of the
flagship configuration on the card's memory; exit 1 when it does not
fit. ``--autotune OUT.json`` sweeps the paged kernels' block size at the
preset's shape (`serve/sweep.py`; timed on the card only) and writes the
artifact `serve.sweep.apply_autotune` reads. Both report the decode-step
audit (`serve.audit.audit_decode_step`: the engine's step on fake
tensors): ``serve --smoke``'s ``audit`` leg holds the kernel lanes clean
and listing the paged decode, paged prefill and RMSNorm operators, and
the reference lanes flagging RLT307 and RLT308; ``serve llama3-8b``
audits the flagship's kernel lanes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

#: the kernel operators a kernel-lane decode step must run
AUDIT_KERNELS = ("rltt.paged_decode", "rltt.paged_prefill", "rltt.rms_norm")


def audit_lanes(cfg, ecfg) -> dict:
    """The decode-step audit of both lanes: ``{"kernel": ..., "reference":
    ...}``, each the rules fired and the ``rltt`` kernels run."""
    from ray_lightning_tpu_torch.serve.audit import audit_decode_step

    out = {}
    for lane, fused in (("kernel", True), ("reference", False)):
        report = audit_decode_step(cfg, ecfg, fused=fused,
                                   label=f"serve {lane} lane")
        out[lane] = {"rules": sorted({f.rule for f in report.findings}),
                     "kernels": dict(report.kernels),
                     "peak_bytes": report.peak_hbm_bytes}
    return out


def add_serve_parser(sub) -> None:
    p = sub.add_parser(
        "serve",
        help="continuous-batching inference: serve a demo through the "
             "replica driver, or the smoke gate")
    p.add_argument("preset", nargs="?", default="example",
                   choices=("example", "llama3-8b"),
                   help="example = a small kernel-tiling Llama served "
                        "through the driver; llama3-8b = the static serve "
                        "plan")
    p.add_argument("--smoke", action="store_true",
                   help="the CPU gate (see the module docstring); exit 1 "
                        "on any failed leg")
    p.add_argument("--device", default=None,
                   help="where the replicas run (default: the CUDA card)")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--backend", choices=("inline", "process"),
                   default="inline")
    p.add_argument("--requests", type=int, default=8,
                   help="synthetic demo requests")
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--slots", type=int, default=4,
                   help="engine slot capacity per replica")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--blocks-per-slot", type=int, default=None,
                   help="default: 8")
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="queued prompts admitted per tick through the "
                        "left-padded batched prefill lane")
    p.add_argument("--seq-budget", type=int, default=4096,
                   help="llama3-8b: the per-slot token span")
    p.add_argument("--run-dir", default=None,
                   help="telemetry spans + serving.json land here")
    p.add_argument("--autotune", metavar="OUT.json", default=None,
                   help="sweep the paged kernels' block size at the "
                        "preset's shape and write the artifact")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _tiny_cfg(device):
    """The kernel-tiling tiny Llama (the JAX gate's fused legs' config:
    head_dim 64, GQA 2:1; bf16 on the card, where the kernels take bf16,
    f32 on the CPU)."""
    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=2,
                       n_kv_heads=1, hidden_dim=256, max_seq_len=128,
                       remat=False,
                       dtype=(torch.float32 if device.type == "cpu"
                              else torch.bfloat16))


def _tiny_model(device, seed: int):
    import torch

    from ray_lightning_tpu_torch.models.llama import init_weights

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_weights(_tiny_cfg(device), gen, device=device)


def _tiny_setup(n_requests: int, max_new: int, device, seed: int = 1):
    """Seeded tiny model + a ragged mixed-sampling request set: the
    inputs the smoke legs and the demo serve."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import Request

    model = _tiny_model(device, seed)
    rng = np.random.default_rng(100 + seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, 3 + i % 5)
               .astype(np.int32) for i in range(n_requests)]
    reqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=max_new,
                    temperature=0.8 if i % 2 else 0.0,
                    top_k=5 if i % 2 else None, seed=31 + i)
            for i, p in enumerate(prompts)]
    return model, reqs


def _references(model, reqs):
    """Independent single-stream `generate` runs: the bitwise oracle."""
    from ray_lightning_tpu_torch.models.llama import generate

    return {r.rid: generate(model, r.prompt[None], r.max_new_tokens,
                            temperature=r.temperature, top_k=r.top_k,
                            seed=r.seed)[0].tolist()
            for r in reqs}


def _check_outputs(outputs, refs) -> list:
    return [rid for rid, ref in refs.items()
            if list(outputs.get(rid, [])) != ref]


class _Counted:
    """A kernel wrapper that counts its calls. Attributes read and set
    reach the wrapper itself: a wrapper bumps its own ``launches``
    through its module's global name, which this stands in for."""

    def __init__(self, fn, bump):
        self.__dict__.update(_fn=fn, _bump=bump)

    def __call__(self, *args, **kwargs):
        self._bump()
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class KernelCalls:
    """Counts, while active, the engine's ticks and prefill chunks and
    the calls of each hand-written kernel's wrapper (on the card each
    call is one launch; on the CPU it runs the plain version)."""

    WRAPPERS = (("ray_lightning_tpu_torch.ops.kernels.paged_attention",
                 "paged_attention_kernel"),
                ("ray_lightning_tpu_torch.ops.kernels.paged_prefill",
                 "paged_prefill_kernel"),
                ("ray_lightning_tpu_torch.ops.attention",
                 "flash_attention_kernel"),
                ("ray_lightning_tpu_torch.ops.kernels.rmsnorm",
                 "rms_norm_kernel"))

    def __init__(self):
        self.calls = {name: 0 for _, name in self.WRAPPERS}
        self.ticks = self.chunks = 0

    @contextlib.contextmanager
    def active(self):
        import importlib

        import numpy as np

        from ray_lightning_tpu_torch.serve.engine import DecodeEngine

        saved = []

        def bump(name):
            def count():
                self.calls[name] += 1
            return count

        for mod_name, name in self.WRAPPERS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, _Counted(getattr(mod, name), bump(name)))
        tick = DecodeEngine.tick

        def counted_tick(engine, tables, pos, decoding, temp, top_k, rngs,
                         prefill, pad=None):
            self.ticks += 1
            self.chunks += bool((np.asarray(prefill[0]) >= 0).any())
            return tick(engine, tables, pos, decoding, temp, top_k, rngs,
                        prefill, pad=pad)

        DecodeEngine.tick = counted_tick
        try:
            yield self
        finally:
            DecodeEngine.tick = tick
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def expected(self, n_layers: int) -> dict:
        """`chip_smoke.py` phase 4's formula: the decode L a tick, the
        prefill L a chunk, RMSNorm 2L+1 a model call."""
        return {"paged_attention_kernel": n_layers * self.ticks,
                "paged_prefill_kernel": n_layers * self.chunks,
                "flash_attention_kernel": 0,
                "rms_norm_kernel": (2 * n_layers + 1)
                * (self.ticks + self.chunks)}


def run_smoke(args) -> int:
    """The CPU gate (module docstring for the leg list)."""
    from ray_lightning_tpu_torch.serve.engine import EngineConfig
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    if device.type != "cpu":
        print("serve --smoke is the CPU gate (f32, where its oracles are "
              "bitwise): pass --device cpu. On the card, chip_smoke.py "
              "phase 11 holds the driver", file=sys.stderr)
        return 2
    legs: dict = {}
    failures: list = []

    def leg(name, fn, *a, **kw):
        n = len(failures)
        legs[name] = fn(failures, *a, **kw)
        legs[name]["status"] = "passed" if len(failures) == n else "failed"

    ecfg = EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                        prefill_chunk=4)
    model, reqs = _tiny_setup(8, 8, device)
    refs = _references(model, reqs)
    with tempfile.TemporaryDirectory(prefix="rlt-serve-smoke-") as tmp:
        run1, run2 = os.path.join(tmp, "run1"), os.path.join(tmp, "run2")
        leg("inline_churn", _smoke_churn_leg, model, reqs, refs, ecfg,
            run1)
        leg("metrics_emission", _smoke_metrics_emission, run1,
            expected_completions=len(reqs))
        leg("replica_kill", _smoke_kill_leg, model, reqs, refs, ecfg,
            run2, tmp)
        leg("metrics_merge", _smoke_metrics_merge, run2)
        leg("flight_recorder", _smoke_flight, run2)
    leg("fused_paged", _smoke_lanes_leg,
        EngineConfig(capacity=4, block_size=8, blocks_per_slot=4,
                     prefill_chunk=4, prefill_batch=2),
        seed=7, temp=0.8, top_k=5, seed_base=61, prompt_floor=3,
        prompt_mod=5)
    # chunk 12 does not divide the 32-token slot: the slid-back tail
    # window runs on the kernel lane too
    leg("fused_prefill", _smoke_lanes_leg,
        EngineConfig(capacity=4, block_size=8, blocks_per_slot=4,
                     prefill_chunk=12, prefill_batch=2),
        seed=9, temp=0.6, top_k=4, seed_base=91, prompt_floor=2,
        prompt_mod=7)
    leg("prefix_sharing", _smoke_prefix_leg, model)
    leg("speculative", _smoke_spec_leg, model, reqs[:6], device)
    leg("audit", _smoke_audit_leg, device)
    verdict = {"legs": legs, "ok": not failures}
    if failures:
        verdict["failures"] = failures
    print(json.dumps(verdict))
    for f in failures:
        print(f"serve --smoke FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def _smoke_churn_leg(failures: list, model, reqs, refs, ecfg,
                     run_dir: str) -> dict:
    """Leg 1: 8 staggered streams through 4 slots of one inline
    replica's kernel lanes, metrics armed: bitwise `generate`, no kernel
    built, each tick's wrapper calls by the phase-4 formula."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )

    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, reserve="on_demand",
        run_dir=run_dir, device="cpu", use_kernels=True,
        metrics_flush_every_n_ticks=4))
    counts = KernelCalls()
    built0 = build.build_seconds()
    with counts.active():
        res = drv.run(list(reqs))
    built = build.build_seconds() - built0
    bad = _check_outputs(res.outputs, refs)
    want = counts.expected(model.cfg.n_layers)
    if bad:
        failures.append(f"inline streams diverge from generate(): {bad}")
    if built != 0.0:
        failures.append(f"request churn built kernel libraries for "
                        f"{built:.3f}s")
    if counts.calls != want:
        failures.append(f"kernel wrapper calls {counts.calls} != {want} "
                        f"({counts.ticks} ticks, {counts.chunks} chunks)")
    return {"bitwise_mismatches": bad,
            "compile_count": res.stats.get("compile_count"),
            "kernel_build_s": built, "ticks": counts.ticks,
            "prefill_chunks": counts.chunks, "kernel_calls": counts.calls,
            "slot_occupancy": round(res.stats.get("slot_occupancy")
                                    or 0, 3)}


def _smoke_kill_leg(failures: list, model, reqs, refs, ecfg,
                    run_dir: str, tmp: str) -> dict:
    """Leg 2: two process replicas, replica 1 SIGKILL'd after 6 tokens:
    respawned, its streams replayed bitwise, replica 0 untouched."""
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
        save_params_npz,
    )

    pp = os.path.join(tmp, "params.npz")
    save_params_npz(model, pp)
    drv = ServeDriver(model.cfg, pp, ReplicaGroupConfig(
        n_replicas=2, backend="process", engine=ecfg, run_dir=run_dir,
        compile_cache_dir=os.path.join(tmp, "kernel_cache"),
        device="cpu", use_kernels=True, metrics_flush_every_n_ticks=4,
        flight_persist_every=4))
    # the driver copies requests before stamping, so the same list
    # serves both legs
    res = drv.run(list(reqs), fault={"replica": 1,
                                     "kill_after_tokens": 6})
    bad = _check_outputs(res.outputs, refs)
    if bad:
        failures.append(f"streams diverge after replica kill: {bad}")
    if res.restarts.get(1, 0) < 1:
        failures.append("the injected SIGKILL did not produce a replica "
                        "restart — the drill did not run")
    if res.restarts.get(0, 0) != 0:
        failures.append("the SURVIVING replica restarted too")
    return {"bitwise_mismatches": bad, "restarts": res.restarts,
            "compile_count": res.stats.get("compile_count"),
            "warmup_respawn_s": res.stats.get("warmup_respawn_s")}


def _smoke_metrics_emission(failures: list, run_dir: str,
                            expected_completions: int) -> dict:
    """The churn run must leave per-replica metrics JSONL on the tick
    cadence whose completion-histogram counts equal the completed
    requests, and `load_signal()` must report."""
    from ray_lightning_tpu_torch.serve.driver import load_signal
    from ray_lightning_tpu_torch.telemetry.metrics import (
        metrics_paths,
        read_metrics,
    )

    paths = metrics_paths(os.path.join(run_dir, "telemetry"))
    leg: dict = {"files": [os.path.basename(p) for p in paths]}
    if not paths:
        failures.append("serving left no per-replica metrics JSONL")
        return leg
    ticks = completions = 0
    hist_ns: dict = {}
    for p in paths:
        parsed = read_metrics(p)
        ticks += len(parsed["ticks"])
        completions += int(parsed["counters"].get("completions", 0))
        for name, h in parsed["hists"].items():
            hist_ns[name] = hist_ns.get(name, 0) + h.n
    leg.update({"ticks": ticks, "completions": completions,
                "hist_counts": hist_ns})
    if ticks < 1:
        failures.append("metrics JSONL holds no tick samples — the "
                        "tick-cadence flush never fired")
    for name in ("ttft_s", "tpot_s", "queue_wait_s"):
        if hist_ns.get(name) != expected_completions:
            failures.append(
                f"histogram {name} counts {hist_ns.get(name)} != "
                f"completed-request count {expected_completions}")
    if completions != expected_completions:
        failures.append(f"completions counter {completions} != "
                        f"{expected_completions}")
    sig = load_signal(run_dir)
    leg["load_signal"] = {k: sig.get(k) for k in
                          ("available", "queue_depth_p50", "occupancy",
                           "pressure")}
    if not sig.get("available"):
        failures.append("load_signal() reports unavailable on a run that "
                        "just served")
    return leg


def _smoke_metrics_merge(failures: list, run_dir: str) -> dict:
    """The histogram merge across the two process replicas must be
    exact: counts sum, and the quantiles of the merged buckets do not
    depend on the merge order."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        merge_histograms,
        metrics_paths,
        read_metrics,
    )

    paths = metrics_paths(os.path.join(run_dir, "telemetry"))
    leg: dict = {"files": [os.path.basename(p) for p in paths]}
    parts = [h for h in (read_metrics(p)["hists"].get("ttft_s")
                         for p in paths) if h is not None]
    leg["parts"] = len(parts)
    if len(parts) < 2:
        failures.append("metrics merge leg needs ttft_s histograms from "
                        f">= 2 replica files, found {len(parts)}")
        return leg
    fwd = merge_histograms(parts)
    rev = merge_histograms(list(reversed(parts)))
    leg.update({"merged_n": fwd.n, "sum_of_parts": sum(h.n for h in parts),
                "p99_fwd": fwd.quantile(0.99),
                "p99_rev": rev.quantile(0.99)})
    if fwd.n != leg["sum_of_parts"]:
        failures.append(f"merged histogram count {fwd.n} != sum of "
                        f"per-replica counts {leg['sum_of_parts']}")
    if fwd.counts != rev.counts or any(
            fwd.quantile(q) != rev.quantile(q) for q in (0.5, 0.95, 0.99)):
        failures.append("histogram merge is order-dependent")
    return leg


def _smoke_flight(failures: list, run_dir: str) -> dict:
    """The SIGKILL must leave a parseable ``flight.json`` carrying the
    dead replica's final ticks and the classification."""
    path = os.path.join(run_dir, "flight.json")
    leg: dict = {"path": os.path.basename(path)}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        failures.append(f"no parseable flight.json after the SIGKILL "
                        f"drill: {type(exc).__name__}: {exc}")
        return leg
    dumps = doc.get("dumps") or []
    leg["dumps"] = len(dumps)
    if not dumps:
        failures.append("flight.json holds no dumps")
        return leg
    dump = dumps[0]
    events = dump.get("events") or []
    tick_events = [e for e in events if e.get("kind") == "tick"]
    leg.update({"replica": dump.get("replica"), "events": len(events),
                "tick_events": len(tick_events),
                "last_tick": (tick_events[-1].get("tick")
                              if tick_events else None),
                "death": dump.get("death")})
    if not tick_events:
        failures.append("flight dump carries no tick events")
    if not (dump.get("death") or {}).get("kind"):
        failures.append("flight dump is missing the resilience "
                        "classification (death.kind)")
    return leg


def _smoke_audit_leg(failures: list, device) -> dict:
    """The decode-step audit on a kernel-tiling tiny shape (head_dim 64):
    the kernel lanes run the paged decode, paged prefill and RMSNorm
    operators and gather no dense view; the reference lanes flag RLT307
    and RLT308."""
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    lanes = audit_lanes(_tiny_cfg(device),
                        EngineConfig(capacity=4, block_size=8,
                                     blocks_per_slot=4, prefill_chunk=8,
                                     prefill_batch=2))
    kern, ref = lanes["kernel"], lanes["reference"]
    missing = [k for k in AUDIT_KERNELS if k not in kern["kernels"]]
    if missing or {"RLT307", "RLT308"} & set(kern["rules"]):
        failures.append(f"audit: kernel lane runs {kern['kernels']}, "
                        f"rules {kern['rules']}")
    if not {"RLT307", "RLT308"} <= set(ref["rules"]):
        failures.append(f"audit: reference lane rules {ref['rules']}")
    return lanes


def _smoke_lanes_leg(failures: list, ecfg, *, seed: int, temp: float,
                     top_k: int, seed_base: int, prompt_floor: int,
                     prompt_mod: int) -> dict:
    """The paged kernel lanes (on the CPU, the wrappers' plain versions)
    serve 8 staggered ragged streams token for token equal to the
    reference lanes, with the kernels selected for both lanes."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

    dev = torch.device("cpu")
    model = _tiny_model(dev, seed)
    rng = np.random.default_rng(seed_base)
    prompts = [rng.integers(0, model.cfg.vocab_size,
                            prompt_floor + i % prompt_mod).astype(np.int32)
               for i in range(8)]

    def run(engine):
        sched = Scheduler(engine, reserve="on_demand")
        pend = [Request(rid=f"s{i}", prompt=p, max_new_tokens=8,
                        temperature=temp if i % 2 else 0.0,
                        top_k=top_k if i % 2 else None, seed=seed_base + i)
                for i, p in enumerate(prompts)]
        out = {}
        while sched.busy() or pend:
            if pend:
                sched.submit(pend.pop(0))
            for comp in sched.tick():
                out[comp.rid] = comp.tokens
        return out

    ref = DecodeEngine(model, ecfg, use_kernels=False, device=dev)
    kern = DecodeEngine(model, ecfg, use_kernels=True, device=dev)
    out_ref, out_kern = run(ref), run(kern)
    mismatched = [rid for rid in out_ref if out_kern.get(rid) !=
                  out_ref[rid]]
    leg = {"attention_path": kern.attention_path,
           "prefill_path": kern.prefill_path,
           "stream_mismatches": mismatched}
    if (kern.attention_path, kern.prefill_path) != ("paged-kernel",
                                                    "paged-kernel"):
        failures.append(f"the kernel lanes were not selected: "
                        f"{kern.attention_path}/{kern.prefill_path}")
    if mismatched:
        failures.append(f"kernel-lane streams diverge from the reference "
                        f"lanes: {mismatched}")
    return leg


def _smoke_prefix_leg(failures: list, model) -> dict:
    """An 8-stream fleet behind ONE system prompt equals per-stream
    `generate`, with fewer prefill tokens than without the cache and
    ``shared_block_fraction`` > 0."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import generate
    from ray_lightning_tpu_torch.serve.engine import (
        DecodeEngine,
        EngineConfig,
    )
    from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, model.cfg.vocab_size, 9).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, model.cfg.vocab_size, 2 + i % 3).astype(np.int32)])
        for i in range(8)]
    ecfg = EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                        prefill_chunk=4)

    def fleet(prefix_cache: bool):
        eng = DecodeEngine(model, ecfg, use_kernels=True,
                           device=model.device)
        eng.warmup()
        sched = Scheduler(eng, prefix_cache=prefix_cache)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=f"p{i}", prompt=p, max_new_tokens=6,
                                 seed=41 + i))
        outputs = {}
        while sched.busy():
            for comp in sched.tick():
                outputs[comp.rid] = list(comp.tokens)
        return outputs, sched

    outputs, sched = fleet(prefix_cache=True)
    _, sched_cold = fleet(prefix_cache=False)
    bad = [f"p{i}" for i, p in enumerate(prompts)
           if generate(model, p[None], 6, seed=41 + i)[0].tolist()
           != outputs.get(f"p{i}")]
    leg = {"bitwise_mismatches": bad,
           "shared_block_fraction": round(sched.shared_block_fraction, 4),
           "prefill_tokens_issued": sched.prefill_tokens_issued,
           "prefill_tokens_no_sharing": sched_cold.prefill_tokens_issued}
    if bad:
        failures.append(f"prefix-shared streams diverge from generate(): "
                        f"{bad}")
    if sched.shared_block_fraction <= 0.0:
        failures.append("the common system prompt produced no shared "
                        "blocks")
    if not sched.prefill_tokens_issued < sched_cold.prefill_tokens_issued:
        failures.append(
            f"prefix cache did not reduce prefill work: "
            f"{sched.prefill_tokens_issued} issued vs "
            f"{sched_cold.prefill_tokens_issued} without sharing")
    return leg


def _smoke_spec_leg(failures: list, model, prompts_from, device) -> dict:
    """Speculative decoding: an INDEPENDENT draft (another seed, so the
    reject path runs) at k 3; the greedy streams equal plain greedy
    `generate` token for token, at one token or more a slot-step."""
    from ray_lightning_tpu_torch.serve.engine import (
        DecodeEngine,
        DraftConfig,
        EngineConfig,
    )
    from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

    reqs = [Request(rid=f"s{i}", prompt=r.prompt, max_new_tokens=6,
                    seed=61 + i) for i, r in enumerate(prompts_from)]
    ecfg = EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                        prefill_chunk=4, draft=DraftConfig(k=3))
    eng = DecodeEngine(model, ecfg, device=device,
                       draft_model=_tiny_model(device, seed=97))
    eng.warmup()
    sched = Scheduler(eng)
    for r in reqs:
        sched.submit(r)
    outputs = {}
    while sched.busy():
        for comp in sched.tick():
            outputs[comp.rid] = list(comp.tokens)
    bad = _check_outputs(outputs, _references(model, reqs))
    leg = {"bitwise_mismatches": bad, "k": ecfg.draft.k,
           "accepted_tokens_per_step": round(
               sched.accepted_tokens_per_step, 4),
           "compile_count": -1}
    if bad:
        failures.append(f"speculative greedy decode diverges from plain "
                        f"greedy: {bad}")
    if sched.accepted_tokens_per_step < 1.0:
        failures.append(
            f"speculative decode emitted fewer than one token per "
            f"slot-step ({sched.accepted_tokens_per_step})")
    return leg


def _flagship(args):
    """llama3-8b at the per-slot span ``--seq-budget`` (bf16 weights, as
    the card serves them) and its engine: ``--slots`` slots, the span in
    ``--block-size`` blocks, chunks of at least 128 tokens."""
    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaConfig
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    cfg = LlamaConfig.llama3_8b(max_seq_len=args.seq_budget,
                                dtype=torch.bfloat16)
    bps = args.blocks_per_slot or -(-args.seq_budget // args.block_size)
    return cfg, EngineConfig(capacity=args.slots,
                             block_size=args.block_size,
                             blocks_per_slot=bps,
                             prefill_chunk=max(args.prefill_chunk, 128),
                             prefill_batch=args.prefill_batch)


def _run_flagship(args) -> int:
    """``serve llama3-8b``: the static plan of the flagship configuration
    against the card's memory (no weights ship with the repo; with a
    params file this configuration serves through the same driver), and
    the decode-step audit of its kernel lanes."""
    from ray_lightning_tpu_torch.serve.audit import (
        format_serve_summary,
        serve_memory_summary,
    )

    cfg, ecfg = _flagship(args)
    from ray_lightning_tpu_torch.serve.audit import audit_decode_step

    summary = serve_memory_summary(cfg, ecfg)
    report = audit_decode_step(
        cfg, ecfg, fused=summary["attention_path"] == "paged-kernel",
        label="llama3-8b serve")
    audit = {"attention_path": summary["attention_path"],
             "kernels": dict(report.kernels),
             "peak_hbm_bytes": report.peak_hbm_bytes,
             "findings": [f.to_dict() for f in report.findings]}
    if getattr(args, "as_json", False):
        print(json.dumps({"preset": "llama3-8b", "plan": summary,
                          "audit": audit}))
    else:
        print(format_serve_summary(summary))
        print(f"decode-step audit: kernels "
              + ", ".join(f"{k} x{n}" for k, n in audit["kernels"].items())
              + f"; est. peak {report.peak_hbm_bytes / 1024**3:.2f} GiB; "
              f"{len(report.findings)} finding(s)")
        for f in report.findings:
            print("  " + f.format())
    return 0 if summary["fits"] else 1


def _run_autotune(args) -> int:
    """``serve <preset> --autotune out.json``: the block-size sweep of
    both paged kernels at the preset's shape (`serve/sweep.py`)."""
    from ray_lightning_tpu_torch.serve.engine import EngineConfig
    from ray_lightning_tpu_torch.serve.sweep import (
        save_artifact,
        sweep_paged_kernels,
    )
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    if args.preset == "llama3-8b":
        cfg, ecfg = _flagship(args)
    else:
        # the kernel-tiling tiny shape: head_dim 64, which both kernels
        # take
        cfg = _tiny_cfg(device)
        ecfg = EngineConfig(capacity=args.slots, block_size=args.block_size,
                            blocks_per_slot=args.blocks_per_slot or 8,
                            prefill_chunk=args.prefill_chunk,
                            prefill_batch=args.prefill_batch)
    artifact = sweep_paged_kernels(cfg, ecfg, device=device)
    save_artifact(artifact, args.autotune)
    if getattr(args, "as_json", False):
        print(json.dumps(artifact))
    else:
        n_ok = sum(1 for r in artifact["results"]
                   if r["decode"].get("ok") and r["prefill"].get("ok"))
        print(f"swept {len(artifact['results'])} geometries ({n_ok} "
              f"passed both kernels' correctness) on "
              f"{artifact['device']}")
        for r in artifact["results"]:
            t = r["timing"]
            print(f"  block {r['block_size']:4d} x {r['blocks_per_slot']}: "
                  + (f"decode {t['decode_ms']:.4f} ms, prefill "
                     f"{t['prefill_ms']:.4f} ms" if "decode_ms" in t
                     else next(iter(t.values()))))
        if artifact["winner"]:
            print(f"winner ({artifact['winner_source']}): block_size="
                  f"{artifact['winner']['block_size']} blocks_per_slot="
                  f"{artifact['winner']['blocks_per_slot']} -> "
                  f"{args.autotune}")
        else:
            print(f"no candidate passed correctness -> {args.autotune} "
                  "(winner: null)")
    return 0 if artifact["winner"] else 1


def _run_example(args) -> int:
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
        save_params_npz,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    ecfg = EngineConfig(capacity=args.slots, block_size=args.block_size,
                        blocks_per_slot=args.blocks_per_slot or 8,
                        prefill_chunk=args.prefill_chunk,
                        prefill_batch=args.prefill_batch)
    model, reqs = _tiny_setup(args.requests, args.max_new, device)
    with contextlib.ExitStack() as stack:
        params = model
        if args.backend == "process":
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="rlt-serve-"))
            params = os.path.join(tmp, "params.npz")
            save_params_npz(model, params)
        drv = ServeDriver(model.cfg, params, ReplicaGroupConfig(
            n_replicas=args.replicas, backend=args.backend, engine=ecfg,
            run_dir=args.run_dir, device=args.device))
        res = drv.run(reqs)
    ttfts = sorted(m["ttft_s"] for m in res.meta.values())
    line = {
        "preset": "example",
        "device": str(device),
        "n_requests": len(reqs),
        "decode_tokens_per_s": round(res.stats["decode_tokens_per_s"], 2),
        "slot_occupancy": res.stats.get("slot_occupancy"),
        "ttft_p50_s": round(ttfts[len(ttfts) // 2], 4),
        "ttft_max_s": round(ttfts[-1], 4),
        "compile_count": res.stats.get("compile_count"),
        "restarts": res.restarts,
    }
    if getattr(args, "as_json", False):
        print(json.dumps(line))
    else:
        print(f"served {line['n_requests']} requests on {device}: "
              f"{line['decode_tokens_per_s']} tok/s decode, "
              f"occupancy {line['slot_occupancy']:.2f}, "
              f"TTFT p50 {line['ttft_p50_s']}s")
        if args.run_dir:
            print(f"telemetry: {args.run_dir} (python -m "
                  f"ray_lightning_tpu_torch report {args.run_dir})")
    return 0


def run_serve(args) -> int:
    if args.smoke:
        return run_smoke(args)
    if args.autotune:
        return _run_autotune(args)
    if args.preset == "llama3-8b":
        return _run_flagship(args)
    return _run_example(args)
