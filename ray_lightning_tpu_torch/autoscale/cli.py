"""``python -m ray_lightning_tpu_torch autoscale``: the closed-loop
serving autoscaler's demo and its smoke gate (twin of
`ray_lightning_tpu/autoscale/cli.py`).

    python -m ray_lightning_tpu_torch autoscale --device cpu   # demo
    python -m ray_lightning_tpu_torch autoscale --smoke --device cpu

``--smoke`` is the CPU gate (f32, where its oracles are bitwise; on the
card ``chip_smoke.py`` phase 14 drives the controller). It runs four
legs —
three on the deterministic scripted-load harness (`autoscale/sim.py` —
the driver tick counter is the clock, so nothing there is wall-clock
sensitive) plus a process-backend ramp — and exits 1 unless ALL hold:

  * **ramp leg** — under a scripted load ramp the controller scales
    1 -> 2 on sustained pressure and back to 1 on idle, exactly once
    each (cooldowns + hysteresis honored: many polls, two scale
    events); every decision lands in ``autoscale.jsonl`` with its
    signal snapshot; and every stream completes **bitwise-identical**
    to independent single-stream `generate()` runs — a graceful drain
    drops zero streams and corrupts none; the churn builds no kernel
    library (`ops.build.build_seconds` unchanged) and every tick of
    either replica calls each kernel wrapper the count
    `chip_smoke.py` phase 4 holds its launches to (the JAX gate pins
    "the decode step compiles once"; the port's engine is eager and
    reports ``compile_count`` -1);
  * **drill leg** — a capacity-oracle probe file at 1 world CLAMPS the
    wanted scale-up (ledger records the clamp + the oracle's answer);
    capacity returns (file -> 2) and the spawn is hit by an injected
    SIGKILL-class `WorkerError` mid-scale-up: the controller
    classifies it via `resilience.policy`, retries within budget, and
    lands the target — absorbed without dropping it;
  * **deferral leg** — with every replica draining, `submit()` defers
    with a structured reason (driver ``submit_deferrals`` counter)
    instead of round-robining onto a stopping replica, and the
    deferred stream completes bitwise once a replica is live again;
  * **process-ramp leg** — the same 1 -> 2 -> 1 ramp against REAL
    worker processes, every command flowing over the request channel
    (serve/channel.py): `add_replica` spawns a process replica
    mid-session, `remove_replica(graceful=True)` drains it over the
    channel, an injected mid-stream SIGKILL is classified and absorbed
    by the channel-epoch respawn replay, and every stream still lands
    bitwise — the leg that retired the old "dynamic sessions are
    inline-backend only" limit (docs/SERVING.md "request channel").
"""
from __future__ import annotations

import json
import os
import sys
import tempfile


def add_autoscale_parser(sub) -> None:
    p = sub.add_parser(
        "autoscale",
        help="closed-loop serving autoscaler: scripted-load demo or "
             "its smoke gate")
    p.add_argument("--smoke", action="store_true",
                   help="gate mode (see module docstring); exit 1 on "
                        "any failed leg")
    p.add_argument("--requests", type=int, default=12,
                   help="synthetic demo requests in the scripted ramp")
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--max-replicas", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the demo and the gate on the CPU "
                        "(the gate's device)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=False)


def _ramp_setup(n_requests: int, max_new: int, device):
    """Tiny model + requests + bitwise references — reuses the serve
    smoke's deterministic setup so the oracle is the same
    `generate()` the serving gate pins against."""
    from ray_lightning_tpu_torch.serve.cli import _references, _tiny_setup
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    ecfg = EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                        prefill_chunk=4)
    model, reqs = _tiny_setup(n_requests, max_new, device)
    refs = _references(model, reqs)
    return model, ecfg, reqs, refs


def _ramp_policy(max_replicas: int = 2):
    from ray_lightning_tpu_torch.autoscale.policy import PolicyConfig

    # cooldowns are in VIRTUAL seconds (driver ticks): 4 ticks after a
    # scale-up, 8 after any event before scaling down
    return PolicyConfig(min_replicas=1, max_replicas=max_replicas,
                        high_pressure=0.5, low_pressure=0.05,
                        idle_occupancy=0.25, sustain_polls=2,
                        up_cooldown_s=4.0, down_cooldown_s=8.0)


def _run_ramp(model, ecfg, reqs, run_dir: str, max_replicas: int = 2):
    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController, ControllerConfig, ScriptedLoad,
        run_scripted,
    )
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver,
    )

    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device=str(model.device.type), use_kernels=True,
        metrics_flush_every_n_ticks=2))
    drv.start()
    ctl = AutoscaleController(drv, ControllerConfig(
        policy=_ramp_policy(max_replicas), signal_window=8))
    third = max(1, len(reqs) // 3)
    load = ScriptedLoad(arrivals={
        0: reqs[:2 * third], 2: reqs[2 * third:2 * third + third // 2],
        4: reqs[2 * third + third // 2:]})
    sim = run_scripted(drv, ctl, load, poll_every_ticks=2)
    result = drv.stop()
    return drv, ctl, sim, result


def _check_streams(outputs, refs) -> list:
    return [rid for rid, ref in refs.items()
            if list(outputs.get(rid, [])) != list(ref)]


def _scale_events(entries):
    return [e for e in entries
            if e["decision"]["action"] in ("scale_up", "scale_down")
            and e["outcome"].get("ok")]


def run_smoke(args) -> int:
    """The CPU gate (module docstring for the leg list)."""
    from ray_lightning_tpu_torch.autoscale.controller import read_ledger
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.cli import KernelCalls
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    if device.type != "cpu":
        print("autoscale --smoke is the CPU gate (f32, where its oracles "
              "are bitwise): pass --device cpu. On the card, "
              "chip_smoke.py phase 14 drives the controller",
              file=sys.stderr)
        return 2
    verdict = {"legs": {}}
    failures = []
    model, ecfg, reqs, refs = _ramp_setup(args.requests, args.max_new,
                                          device)

    # ---- leg 1: the scripted ramp -------------------------------------
    with tempfile.TemporaryDirectory(prefix="rlt-autoscale-") as tmp:
        run_dir = os.path.join(tmp, "run")
        counts = KernelCalls()
        built0 = build.build_seconds()
        with counts.active():
            drv, ctl, sim, result = _run_ramp(model, ecfg, reqs, run_dir)
        built = build.build_seconds() - built0
        want_calls = counts.expected(model.cfg.n_layers)
        ledger = read_ledger(run_dir)
        events = _scale_events(ledger)
        bad = _check_streams(result.outputs, refs)
        incomplete = [rid for rid, m in result.meta.items()
                      if m["finish_reason"] not in ("eos", "length")]
        leg = {
            "decisions": ctl.decisions,
            "ledger_lines": len(ledger),
            "scale_ups": ctl.scale_ups,
            "scale_downs": ctl.scale_downs,
            "final_replicas": result.stats["final_replicas"],
            "bitwise_mismatches": bad,
            "completed": len(result.meta),
            "compile_count": result.stats["compile_count"],
            "kernel_build_s": built,
            "ticks": counts.ticks, "prefill_chunks": counts.chunks,
            "kernel_calls": counts.calls,
            "events": [{"now": e["now"],
                        "action": e["decision"]["action"],
                        "target": e["decision"]["target"]}
                       for e in events],
        }
        verdict["legs"]["ramp"] = leg
        if ctl.scale_ups != 1 or ctl.scale_downs != 1:
            failures.append(
                f"expected exactly one scale-up and one scale-down "
                f"under the ramp (cooldowns+hysteresis must stop "
                f"flapping), got {ctl.scale_ups} up / "
                f"{ctl.scale_downs} down over {ctl.decisions} polls")
        if result.stats["final_replicas"] != 1:
            failures.append(
                f"ramp must end back at 1 replica, ended at "
                f"{result.stats['final_replicas']}")
        if bad:
            failures.append(
                f"streams diverge from generate() across the "
                f"scale-up/drain: {bad}")
        if len(result.meta) != len(reqs) or incomplete:
            failures.append(
                f"dropped streams: {len(result.meta)}/{len(reqs)} "
                f"completed (incomplete: {incomplete})")
        if len(ledger) != ctl.decisions or not ledger:
            failures.append(
                f"ledger holds {len(ledger)} parseable lines for "
                f"{ctl.decisions} decisions — every decision must "
                "land")
        missing = [i for i, e in enumerate(ledger)
                   if not ("signal" in e and "decision" in e
                           and "outcome" in e and "duration_s" in e)]
        if missing:
            failures.append(
                f"ledger entries missing required fields at lines "
                f"{missing[:5]}")
        if built != 0.0:
            failures.append(f"the ramp's churn built kernel libraries for "
                            f"{built:.3f}s")
        if counts.calls != want_calls:
            failures.append(
                f"kernel wrapper calls {counts.calls} != {want_calls} "
                f"({counts.ticks} ticks, {counts.chunks} chunks over both "
                "replicas)")
        if len(events) >= 2:
            gap = events[1]["now"] - events[0]["now"]
            if gap < 8.0:  # the down-cooldown in virtual seconds
                failures.append(
                    f"scale events {gap:g} virtual seconds apart — "
                    "the down-cooldown (8) was not honored")

    # ---- leg 2: capacity clamp + SIGKILL-during-scale-up drill --------
    with tempfile.TemporaryDirectory(prefix="rlt-autoscale-") as tmp:
        verdict["legs"]["drill"] = _smoke_drill(
            failures, model, ecfg, os.path.join(tmp, "run"),
            os.path.join(tmp, "capacity"))

    # ---- leg 3: all-draining submit deferral --------------------------
    with tempfile.TemporaryDirectory(prefix="rlt-autoscale-") as tmp:
        verdict["legs"]["deferral"] = _smoke_deferral(
            failures, model, ecfg, reqs, refs, os.path.join(tmp, "run"))

    # ---- leg 4: process-backend ramp over the request channel ---------
    with tempfile.TemporaryDirectory(prefix="rlt-autoscale-") as tmp:
        verdict["legs"]["process_ramp"] = _smoke_process_ramp(
            failures, ecfg, os.path.join(tmp, "run"), device)

    verdict["ok"] = not failures
    if failures:
        verdict["failures"] = failures
    print(json.dumps(verdict))
    if failures:
        for f in failures:
            print(f"autoscale --smoke FAILED: {f}", file=sys.stderr)
        return 1
    return 0


def _smoke_drill(failures: list, model, ecfg, run_dir: str,
                 cap_file: str) -> dict:
    """Capacity clamp then SIGKILL-absorbing scale-up: the oracle file
    says 1 world -> the wanted scale-up HOLDS with the capacity clamp
    in the ledger; the file flips to 2 and the spawn dies with a
    SIGKILL-class WorkerError -> classified RETRYABLE, retried within
    budget, target landed."""
    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController, CapacityOracle, ControllerConfig,
        PolicyConfig,
    )
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver,
    )

    with open(cap_file, "w") as f:
        f.write("1")
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device=str(model.device.type), metrics_flush_every_n_ticks=2))
    drv.start()
    # a fabricated sustained-high signal isolates the drill from the
    # ramp: this leg tests the ACTUATION path, not signal plumbing
    high = {"available": True, "pressure": 2.0, "queue_depth_now": 8.0,
            "queue_depth_p50": 8.0, "occupancy": 1.0, "total_slots": 4.0}
    ctl = AutoscaleController(
        drv,
        ControllerConfig(
            policy=PolicyConfig(min_replicas=1, max_replicas=2,
                                sustain_polls=1, up_cooldown_s=1.0),
            oracle=CapacityOracle(probe_file=cap_file),
            max_spawn_retries=2),
        run_dir=run_dir, signal_fn=lambda: dict(high))
    clamped = ctl.step(now=0.0)
    leg = {"clamped": clamped["decision"]}
    if not (clamped["decision"]["action"] == "hold"
            and "capacity" in clamped["decision"]["clamps"]):
        failures.append(
            f"capacity 1 did not clamp the scale-up: {clamped['decision']}")
    if clamped.get("capacity", {}).get("source") != "file":
        failures.append(
            "ledger entry is missing the capacity oracle's file answer")
    with open(cap_file, "w") as f:
        f.write(json.dumps({"capacity": 2}))
    drv.inject_spawn_faults(1, signal_name="SIGKILL")
    scaled = ctl.step(now=2.0)
    leg["scaled"] = {"decision": scaled["decision"],
                     "outcome": scaled["outcome"],
                     "n_live": drv.n_live}
    out = scaled["outcome"]
    if not (scaled["decision"]["action"] == "scale_up"
            and out.get("ok") and out.get("retries") == 1):
        failures.append(
            f"SIGKILL-during-scale-up was not absorbed by one "
            f"classified retry: {out}")
    if drv.n_live != 2:
        failures.append(
            f"scale target dropped after the spawn SIGKILL: "
            f"{drv.n_live} live replicas (want 2)")
    kinds = [f_["kind"] for f_ in out.get("failures", [])]
    if kinds != ["retryable"]:
        failures.append(
            f"spawn death classification not recorded as retryable: "
            f"{out.get('failures')}")
    drv.stop()
    return leg


def _smoke_deferral(failures: list, model, ecfg, reqs, refs,
                    run_dir: str) -> dict:
    """Every replica draining -> submit() defers with a structured
    reason and the metrics counter; once a replica is live again the
    deferred stream routes, completes, and matches generate()."""
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver,
    )

    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device=str(model.device.type), metrics_flush_every_n_ticks=2))
    drv.start()
    drv.remove_replica(graceful=True)   # the only replica drains
    target = drv.submit(reqs[0])
    leg = {"deferred_target": target,
           "last_deferral": drv.last_deferral}
    if target is not None or drv.last_deferral is None:
        failures.append(
            "submit() with every replica draining routed onto a "
            f"stopping replica (target={target}) instead of deferring")
    counters = drv.driver_metrics.counters()
    leg["submit_deferrals"] = counters.get("submit_deferrals", 0)
    if counters.get("submit_deferrals", 0) != 1:
        failures.append(
            f"deferral counter reads "
            f"{counters.get('submit_deferrals', 0)}, want 1")
    drv.add_replica()
    result = drv.stop()   # drains: the deferred request must complete
    bad = _check_streams(result.outputs,
                         {reqs[0].rid: refs[reqs[0].rid]})
    leg["bitwise_mismatches"] = bad
    if bad:
        failures.append(
            f"deferred stream diverged after re-routing: {bad}")
    return leg


def _smoke_process_ramp(failures: list, ecfg, run_dir: str, device,
                        n_requests: int = 6, max_new: int = 8) -> dict:
    """The process-backend ramp: 1 -> 2 -> 1 REAL worker processes,
    every command flowing over the request channel (serve/channel.py),
    with an injected mid-stream SIGKILL absorbed by the classified
    respawn + channel-epoch replay. This is the leg that retired
    docs/AUTOSCALE.md's old "dynamic sessions are inline-backend only"
    limit: the same `add_replica`/`remove_replica(graceful=True)` seams
    the controller actuates, against spawned processes instead of
    inline engines. Scripted actuation (not policy polling) keeps the
    leg deterministic — the policy's signal loop is leg 1's job; this
    leg pins the ACTUATION seams the controller calls."""
    from ray_lightning_tpu_torch.serve.cli import _references, _tiny_setup
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver, save_params_npz,
    )

    model, reqs = _tiny_setup(n_requests, max_new, device)
    refs = _references(model, reqs)
    ppath = os.path.join(run_dir, "params.npz")
    os.makedirs(run_dir, exist_ok=True)
    save_params_npz(model, ppath)
    drv = ServeDriver(model.cfg, ppath, ReplicaGroupConfig(
        n_replicas=1, backend="process", engine=ecfg,
        run_dir=run_dir, device=device.type,
        max_restarts=2, metrics_flush_every_n_ticks=2))
    # the SIGKILL lands mid-stream on replica 0 after a few emitted
    # tokens: the session thread classifies the death (retryable /
    # worker-signal), respawns the replica on a fresh channel epoch,
    # and the replayed commands regenerate every stream bitwise
    drv.start(fault={"replica": 0, "kill_after_tokens": 6})
    half = max(1, len(reqs) // 2)
    for r in reqs[:half]:
        drv.submit(r)
    added = drv.add_replica()          # scale 1 -> 2, over the channel
    for r in reqs[half:]:
        drv.submit(r)
    import time as _time
    while drv.busy():
        drv.tick()
        _time.sleep(0.01)
    victim = drv.remove_replica(graceful=True)   # scale 2 -> 1: drain op
    result = drv.stop()
    bad = _check_streams(result.outputs, refs)
    leg = {
        "added": added, "removed": victim,
        "replicas_spawned": result.stats["replicas_spawned"],
        "final_replicas": result.stats["final_replicas"],
        "restarts": {str(k): v for k, v in result.restarts.items()},
        "bitwise_mismatches": bad,
        "completed": len(result.meta),
    }
    if bad:
        failures.append(
            f"process-backend streams diverge from generate() across "
            f"the ramp + SIGKILL respawn: {bad}")
    if result.stats["replicas_spawned"] != 2:
        failures.append(
            f"process ramp spawned {result.stats['replicas_spawned']} "
            "replicas, want 2 (1 -> 2 via the channel)")
    if result.stats["final_replicas"] != 1:
        failures.append(
            f"process ramp must end back at 1 replica, ended at "
            f"{result.stats['final_replicas']}")
    if result.restarts.get(0, 0) < 1:
        failures.append(
            "the injected mid-stream SIGKILL was not absorbed by a "
            f"classified respawn (restarts: {result.restarts})")
    if len(result.meta) != len(reqs):
        failures.append(
            f"process ramp dropped streams: {len(result.meta)}/"
            f"{len(reqs)} completed")
    return leg


def _run_demo(args) -> int:
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    model, ecfg, reqs, refs = _ramp_setup(args.requests, args.max_new,
                                          resolve_device(args.device))
    with tempfile.TemporaryDirectory(prefix="rlt-autoscale-") as tmp:
        run_dir = os.path.join(tmp, "run")
        drv, ctl, sim, result = _run_ramp(model, ecfg, reqs, run_dir,
                                          max_replicas=args.max_replicas)
        bad = _check_streams(result.outputs, refs)
        line = {
            "requests": len(reqs),
            "ticks": sim["ticks"],
            "decisions": ctl.decisions,
            "scale_ups": ctl.scale_ups,
            "scale_downs": ctl.scale_downs,
            "scale_up_s": round(max(ctl.scale_up_s), 4)
            if ctl.scale_up_s else None,
            "final_replicas": result.stats["final_replicas"],
            "decode_tokens_per_s": round(
                result.stats["decode_tokens_per_s"], 2),
            "bitwise_ok": not bad,
        }
    if args.as_json:
        print(json.dumps(line))
    else:
        print(f"autoscale demo: {line['requests']} requests over "
              f"{line['ticks']} ticks, {line['decisions']} decisions "
              f"-> {line['scale_ups']} up / {line['scale_downs']} "
              f"down, spawn {line['scale_up_s']}s, streams "
              f"{'bitwise-identical' if line['bitwise_ok'] else 'DIVERGED'}")
    return 0 if not bad else 1


def run_autoscale(args) -> int:
    if args.smoke:
        return run_smoke(args)
    return _run_demo(args)
