"""``python -m ray_lightning_tpu_torch loadgen``: the trace-driven load
harness CLI and its smoke gate (twin of `ray_lightning_tpu/loadgen/cli.py`).

    python -m ray_lightning_tpu_torch loadgen --out trace.jsonl --seed 7
    python -m ray_lightning_tpu_torch loadgen --trace trace.jsonl --device cpu
    python -m ray_lightning_tpu_torch loadgen --smoke --device cpu

``--out`` generates a versioned workload trace (seeded Poisson/MMPP
arrivals, heavy-tailed lengths, traffic-class mix). ``--trace``
replays one through a REAL inline `ServeDriver` session with the SLO
machinery armed and prints the per-class outcome. ``--smoke`` is the
CPU gate (f32, where its oracles are bitwise; on the card
``chip_smoke.py`` phase 14 drives a trace through the autoscaled
driver). It runs three legs and exits 1 unless ALL hold:

  * **trace leg** — the generator is byte-deterministic (same seed =>
    identical canonical trace twice, different seed => different), a
    write/read round-trip re-serializes identically, and an unknown
    trace version is refused, never misread;
  * **replay leg** — a seeded bursty mixed-class MMPP trace drives an
    inline session TWICE on the virtual clock: identical token
    streams, identical per-class completion/shed accounting, and an
    identical shed-rid set both runs; every completed stream is
    bitwise-identical to single-stream `generate()`; the burst
    demonstrably starves best-effort (typed shed records with
    retry-after hints, ZERO latency-critical sheds) while
    latency-critical p95 TTFT meets its SLO; preemption fires; every
    trace rid ends terminal (completed or shed — zero silent drops,
    RLT505); churn + preemption build no kernel library and every
    tick calls each kernel wrapper the count `chip_smoke.py` phase 4
    holds its launches to (the JAX gate pins "the decode step compiles
    exactly once"; the port's engine is eager and reports
    ``compile_count`` -1); and a `class_slo_rules` watch poll lands
    the class-scoped
    ``shed_best_effort`` incident in incidents.jsonl without paging
    latency-critical;
  * **process leg** — a mixed-class trace against a REAL worker
    process, best-effort admission budget 0: every best-effort rid
    sheds with a typed record fanned in over the channel, survivors
    land bitwise, the shed counter matches the meta ledger exactly,
    and the compile count stays 1 (-1 in the port: eager).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np


def add_loadgen_parser(sub) -> None:
    p = sub.add_parser(
        "loadgen",
        help="trace-driven load harness: generate/replay seeded "
             "workload traces against the serving stack, or the "
             "smoke gate")
    p.add_argument("--smoke", action="store_true",
                   help="gate mode (see module docstring); exit 1 on "
                        "any failed leg")
    p.add_argument("--out", default=None,
                   help="generate a workload trace to this path")
    p.add_argument("--trace", default=None,
                   help="replay a trace file through an inline "
                        "serving session (SLO machinery armed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--process", choices=("poisson", "mmpp"),
                   default="poisson", dest="arrival_process")
    p.add_argument("--rate", type=float, default=2.0,
                   help="mean arrivals per virtual tick (calm state)")
    p.add_argument("--burst-rate", type=float, default=8.0,
                   help="MMPP burst-state mean arrivals per tick")
    p.add_argument("--device", default=None,
                   help="'cpu' serves replays and the gate on the CPU "
                        "(the gate's device)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=False)


def _mixed_slo(be_budget=1):
    """CI-safe targets: generous enough that a loaded CPU box cannot
    flake the attainment check, tight enough that the per-class story
    (best-effort sheds, latency-critical holds) is real."""
    from ray_lightning_tpu_torch.serve.scheduler import ClassSLO, SLOConfig

    return SLOConfig(classes={
        "latency_critical": ClassSLO(ttft_p95_s=10.0, tpot_p95_s=5.0),
        "standard": ClassSLO(ttft_p95_s=30.0, tpot_p95_s=10.0),
        "best_effort": ClassSLO(ttft_p95_s=60.0, tpot_p95_s=20.0,
                                queue_budget=be_budget),
    })


def _burst_workload(seed: int = 7, n: int = 18):
    from ray_lightning_tpu_torch.loadgen.generator import WorkloadConfig

    return WorkloadConfig(
        seed=seed, n_requests=n, process="mmpp", rate=0.5,
        burst_rate=6.0, p_enter_burst=0.25, p_exit_burst=0.25,
        prompt_len_min=3, prompt_len_max=10, prompt_len_alpha=1.5,
        max_new_min=3, max_new_max=10, max_new_alpha=1.2,
        class_mix={"latency_critical": 0.3, "standard": 0.3,
                   "best_effort": 0.4})


def _setup_model(device, seed: int = 1):
    """The serve gate's kernel-tiling tiny Llama (head_dim 64, GQA 2:1,
    f32 on the CPU), seeded — the oracle is the same `generate()` the
    serving gate pins against, and its kernel lanes run the wrappers
    (the JAX gate's `LlamaConfig.tiny` has head_dim 16, under the paged
    kernels' tile)."""
    from ray_lightning_tpu_torch.serve.cli import _tiny_model

    return _tiny_model(device, seed)


def _trace_refs(model, events):
    """generate() oracle for a trace's requests (completed streams
    must match bitwise; shed streams are excluded by the caller)."""
    from ray_lightning_tpu_torch.loadgen.trace import to_request
    from ray_lightning_tpu_torch.serve.cli import _references

    return _references(model, [to_request(ev) for ev in events])


def _run_trace_inline(model, events, slo, run_dir, ecfg=None,
                      use_kernels=None):
    """One virtual-clock replay through a fresh inline session."""
    from ray_lightning_tpu_torch.loadgen.runner import run_trace
    from ray_lightning_tpu_torch.loadgen.trace import arrivals_by_tick
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    ecfg = ecfg or EngineConfig(capacity=2, block_size=4,
                                blocks_per_slot=8, prefill_chunk=4)
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device=model.device.type, use_kernels=use_kernels,
        metrics_flush_every_n_ticks=2, slo=slo))
    drv.start()
    sim = run_trace(drv, arrivals_by_tick(events),
                    idle_ticks_after_drain=4)
    return drv, sim


def _per_class(meta: dict) -> dict:
    """The per-class accounting the determinism pin compares."""
    out: dict = {}
    for m in meta.values():
        cls = m.get("priority", "standard")
        kind = "sheds" if m.get("finish_reason") == "shed" \
            else "completions"
        c = out.setdefault(cls, {"completions": 0, "sheds": 0})
        c[kind] += 1
    return out


def _shed_rids(meta: dict) -> list:
    return sorted(r for r, m in meta.items()
                  if m.get("finish_reason") == "shed")


def _p95(values) -> float:
    vals = sorted(values)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1,
                    max(0, int(np.ceil(0.95 * len(vals))) - 1))]


def _smoke_trace_leg(failures: list) -> dict:
    from ray_lightning_tpu_torch.loadgen.generator import generate_events
    from ray_lightning_tpu_torch.loadgen.trace import (
        dump_trace, read_trace, write_trace,
    )

    wl = _burst_workload()
    a = dump_trace(generate_events(wl), wl.meta())
    b = dump_trace(generate_events(wl), wl.meta())
    wl2 = _burst_workload(seed=wl.seed + 1)
    c = dump_trace(generate_events(wl2), wl2.meta())
    leg = {"bytes": len(a), "deterministic": a == b,
           "seed_sensitive": a != c}
    if a != b:
        failures.append(
            "generator is not byte-deterministic: same config "
            "produced two different canonical traces")
    if a == c:
        failures.append(
            "generator ignored the seed: seeds "
            f"{wl.seed}/{wl2.seed} produced the identical trace")
    with tempfile.TemporaryDirectory(prefix="rlt-loadgen-") as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        events = generate_events(wl)
        write_trace(path, events, wl.meta())
        header, back = read_trace(path)
        leg["events"] = len(back)
        if dump_trace(back, header["meta"]) != a:
            failures.append(
                "trace write/read round-trip did not re-serialize "
                "byte-identically")
        # version refusal: a future trace must error, never misread
        with open(path) as f:
            lines = f.read().splitlines()
        doc = json.loads(lines[0])
        doc["version"] = 999
        with open(path, "w") as f:
            f.write("\n".join([json.dumps(doc)] + lines[1:]) + "\n")
        try:
            read_trace(path)
            failures.append(
                "a version-999 trace was read instead of refused")
            leg["version_refused"] = False
        except ValueError:
            leg["version_refused"] = True
    return leg


def _smoke_replay_leg(failures: list, model) -> dict:
    from ray_lightning_tpu_torch.loadgen.generator import generate_events
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.cli import KernelCalls, _check_outputs
    from ray_lightning_tpu_torch.telemetry.watch import (
        WatchConfig, WatchEngine, class_slo_rules,
    )

    wl = _burst_workload()
    events = generate_events(wl)
    slo = _mixed_slo(be_budget=1)
    refs = _trace_refs(model, events)
    runs = []
    incidents = []
    counts = KernelCalls()
    built0 = build.build_seconds()
    for attempt in range(2):
        with tempfile.TemporaryDirectory(prefix="rlt-loadgen-") as tmp:
            run_dir = os.path.join(tmp, "run")
            with counts.active():
                drv, sim = _run_trace_inline(model, events, slo, run_dir,
                                             use_kernels=True)
            if attempt == 0:
                # poll the class-scoped SLO rules against the run's
                # OWN flushed metrics before the session retires its
                # replica from the live load signal
                eng = WatchEngine(run_dir, WatchConfig(
                    rules=class_slo_rules(slo), capture=False))
                eng.poll(now=1.0)
                incidents = list(eng.incidents)
            with counts.active():
                result = drv.stop()
            runs.append((sim, result))
    built = build.build_seconds() - built0
    want_calls = counts.expected(model.cfg.n_layers)
    (sim0, res0), (sim1, res1) = runs
    per_class = _per_class(res0.meta)
    sheds0 = _shed_rids(res0.meta)
    done = {r: m for r, m in res0.meta.items()
            if m["finish_reason"] != "shed"}
    lc_ttft = [m["ttft_s"] for m in done.values()
               if m["priority"] == "latency_critical"]
    preempted = sum(m.get("preempted", 0)
                    for m in res0.meta.values())
    bad = _check_outputs(res0.outputs,
                         {r: refs[r] for r in done})
    leg = {
        "requests": len(events),
        "ticks": (sim0["ticks"], sim1["ticks"]),
        "per_class": per_class,
        "sheds": sheds0,
        "preempted_resumes": preempted,
        "lc_ttft_p95_s": round(_p95(lc_ttft), 4),
        "bitwise_mismatches": bad,
        "compile_count": res0.stats["compile_count"],
        "kernel_build_s": built,
        "kernel_calls": counts.calls,
        "incidents": [i["rule"] for i in incidents],
    }
    if res0.outputs != res1.outputs:
        failures.append(
            "replay is not deterministic: the same trace produced "
            "different token streams across two runs")
    acct = [(r, m["finish_reason"], m["priority"])
            for r, m in sorted(res0.meta.items())]
    acct1 = [(r, m["finish_reason"], m["priority"])
             for r, m in sorted(res1.meta.items())]
    if acct != acct1 or _per_class(res1.meta) != per_class:
        failures.append(
            "per-class accounting diverged across two replays of the "
            "same trace")
    if sheds0 != _shed_rids(res1.meta):
        failures.append(
            f"shed-rid set diverged across replays: {sheds0} vs "
            f"{_shed_rids(res1.meta)}")
    if bad:
        failures.append(
            f"completed streams diverge from generate() under "
            f"mixed-class churn + preemption: {bad}")
    missing = sorted({e.rid for e in events} - set(res0.meta))
    odd = [r for r, m in res0.meta.items()
           if m["finish_reason"] not in ("eos", "length", "shed")]
    if missing or odd:
        failures.append(
            f"silent request drop (RLT505): rids without a terminal "
            f"record {missing}, non-terminal reasons {odd}")
    be = per_class.get("best_effort", {})
    lc = per_class.get("latency_critical", {})
    if not be.get("sheds"):
        failures.append(
            "the burst did not shed best-effort — the overload leg "
            f"is not exercising degradation (per-class {per_class})")
    if lc.get("sheds"):
        failures.append(
            f"latency-critical was shed ({lc['sheds']} records) — "
            "shedding must never reach a non-shed class")
    shed_meta = [res0.meta[r] for r in sheds0]
    unhinted = [m for m in shed_meta
                if not (m.get("reason") and
                        m.get("retry_after_s", 0) > 0)]
    if unhinted:
        failures.append(
            f"shed records missing reason/retry-after hints: "
            f"{unhinted[:3]}")
    if not lc_ttft or _p95(lc_ttft) > 10.0:
        failures.append(
            f"latency-critical p95 TTFT {_p95(lc_ttft):.3f}s missed "
            "its 10s SLO under the burst (or no latency-critical "
            "stream completed)")
    if preempted < 1:
        failures.append(
            "no preemption under the burst — the policy-ordered "
            "preemption seam was not exercised")
    if built != 0.0:
        failures.append(f"mixed-class churn + preemption built kernel "
                        f"libraries for {built:.3f}s")
    if counts.calls != want_calls:
        failures.append(
            f"kernel wrapper calls {counts.calls} != {want_calls} "
            f"({counts.ticks} ticks, {counts.chunks} chunks over both "
            "replays)")
    fired = [i["rule"] for i in incidents]
    if fired.count("shed_best_effort") != 1:
        failures.append(
            f"expected exactly one class-scoped shed_best_effort "
            f"incident in incidents.jsonl, watch fired {fired}")
    if "slo_ttft_latency_critical" in fired:
        failures.append(
            "latency-critical paged its TTFT SLO rule during the "
            "burst — degradation is not graceful")
    return leg


def _smoke_process_leg(failures: list, model) -> dict:
    import time

    from ray_lightning_tpu_torch.loadgen.trace import TraceEvent, to_request
    from ray_lightning_tpu_torch.serve.cli import _check_outputs
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver, save_params_npz,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    cfg = model.cfg
    rng = np.random.Generator(np.random.PCG64(77))
    classes = ["latency_critical", "standard", "best_effort",
               "standard", "latency_critical", "best_effort",
               "standard", "latency_critical"]
    events = [TraceEvent(
        tick=i // 3, rid=f"pg{i:02d}",
        prompt=tuple(int(t) for t in rng.integers(
            0, cfg.vocab_size, size=3 + i % 4)),
        max_new_tokens=6, priority=classes[i],
        temperature=0.8 if i % 2 else 0.0,
        top_k=5 if i % 2 else None, seed=31 + i)
        for i in range(len(classes))]
    # budget 0: EVERY best-effort arrival sheds at enqueue — the shed
    # set is deterministic even against a free-running worker process
    slo = _mixed_slo(be_budget=0)
    survivors = [e for e in events if e.priority != "best_effort"]
    refs = _trace_refs(model, survivors)
    with tempfile.TemporaryDirectory(prefix="rlt-loadgen-") as tmp:
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir, exist_ok=True)
        ppath = os.path.join(run_dir, "params.npz")
        save_params_npz(model, ppath)
        drv = ServeDriver(cfg, ppath, ReplicaGroupConfig(
            n_replicas=1, backend="process",
            engine=EngineConfig(capacity=2, block_size=4,
                                blocks_per_slot=8, prefill_chunk=4),
            run_dir=run_dir, device=model.device.type,
            metrics_flush_every_n_ticks=2, slo=slo))
        drv.start()
        for ev in events:
            drv.submit(to_request(ev))
        while drv.busy():
            drv.tick()
            time.sleep(0.01)
        result = drv.stop()
    sheds = _shed_rids(result.meta)
    want_shed = sorted(e.rid for e in events
                       if e.priority == "best_effort")
    bad = _check_outputs(result.outputs, refs)
    leg = {
        "requests": len(events), "sheds": sheds,
        "bitwise_mismatches": bad,
        "requests_shed_counter": result.stats.get("requests_shed"),
        "compile_count": result.stats["compile_count"],
    }
    if sheds != want_shed:
        failures.append(
            f"process-backend shed set {sheds} != every best-effort "
            f"rid {want_shed} (admission budget 0 must shed "
            "deterministically over the channel)")
    if bad:
        failures.append(
            f"process-backend survivor streams diverge from "
            f"generate() around the sheds: {bad}")
    if result.stats.get("requests_shed") != len(want_shed):
        failures.append(
            f"driver shed counter {result.stats.get('requests_shed')} "
            f"!= {len(want_shed)} shed meta records — the typed "
            "records and the counter must agree")
    missing = sorted({e.rid for e in events} - set(result.meta))
    if missing:
        failures.append(
            f"silent request drop over the channel (RLT505): "
            f"{missing}")
    if result.stats["compile_count"] not in (1, -1):
        failures.append(
            f"process-backend compile_count="
            f"{result.stats['compile_count']}, want 1")
    return leg


def run_smoke(args) -> int:
    """The CPU gate (module docstring for the leg list)."""
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    if device.type != "cpu":
        print("loadgen --smoke is the CPU gate (f32, where its oracles "
              "are bitwise): pass --device cpu. On the card, "
              "chip_smoke.py phase 14 drives a trace through the "
              "autoscaled driver", file=sys.stderr)
        return 2
    verdict: dict = {"legs": {}}
    failures: list = []
    verdict["legs"]["trace"] = _smoke_trace_leg(failures)
    model = _setup_model(device)
    verdict["legs"]["replay"] = _smoke_replay_leg(failures, model)
    verdict["legs"]["process"] = _smoke_process_leg(failures, model)
    verdict["ok"] = not failures
    if failures:
        verdict["failures"] = failures
    print(json.dumps(verdict))
    if failures:
        for f in failures:
            print(f"loadgen --smoke FAILED: {f}", file=sys.stderr)
        return 1
    return 0


def _run_generate(args) -> int:
    from ray_lightning_tpu_torch.loadgen.generator import (
        WorkloadConfig, generate_events,
    )
    from ray_lightning_tpu_torch.loadgen.trace import write_trace

    wl = WorkloadConfig(seed=args.seed, n_requests=args.requests,
                        process=args.arrival_process, rate=args.rate,
                        burst_rate=args.burst_rate)
    events = generate_events(wl)
    write_trace(args.out, events, wl.meta())
    by_class: dict = {}
    for e in events:
        by_class[e.priority] = by_class.get(e.priority, 0) + 1
    line = {"trace": args.out, "events": len(events),
            "ticks": max(e.tick for e in events) + 1,
            "by_class": by_class}
    print(json.dumps(line) if args.as_json else
          f"wrote {line['events']} events over {line['ticks']} ticks "
          f"to {args.out} ({by_class})")
    return 0


def _run_replay(args) -> int:
    from ray_lightning_tpu_torch.loadgen.trace import read_trace
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    header, events = read_trace(args.trace)
    model = _setup_model(resolve_device(args.device))
    cfg = model.cfg
    over = [e.rid for e in events
            if e.prompt and max(e.prompt) >= cfg.vocab_size]
    if over:
        print(f"error: trace tokens exceed the tiny model's vocab "
              f"({cfg.vocab_size}): {over[:5]}", file=sys.stderr)
        return 2
    slo = _mixed_slo()
    with tempfile.TemporaryDirectory(prefix="rlt-loadgen-") as tmp:
        drv, sim = _run_trace_inline(model, events, slo,
                                     os.path.join(tmp, "run"))
        result = drv.stop()
    per_class = _per_class(result.meta)
    done = [m for m in result.meta.values()
            if m["finish_reason"] != "shed"]
    attain = {}
    for cls, spec in sorted(slo.classes.items()):
        ttfts = [m["ttft_s"] for m in done if m["priority"] == cls]
        if ttfts:
            attain[cls] = {
                "ttft_p95_s": round(_p95(ttfts), 4),
                "slo_met": _p95(ttfts) <= spec.ttft_p95_s}
    line = {"trace": args.trace, "events": len(events),
            "ticks": sim["ticks"], "per_class": per_class,
            "slo_attainment": attain,
            "compile_count": result.stats["compile_count"]}
    print(json.dumps(line) if args.as_json else
          f"replayed {len(events)} events over {sim['ticks']} ticks: "
          f"{per_class} attainment {attain}")
    return 0


def run_loadgen(args) -> int:
    if args.smoke:
        return run_smoke(args)
    if args.out:
        return _run_generate(args)
    if args.trace:
        return _run_replay(args)
    print("loadgen: one of --smoke / --out / --trace required",
          file=sys.stderr)
    return 2
