"""The port's closed-loop serving autoscaler (`autoscale/`) against the
JAX package's (the cases of tests/test_autoscale.py), on the CPU.

`decide` runs every signal script of the JAX decision-table tests
through both packages' policy cores: the `Decision` dicts and the
policy state after every poll must agree. The capacity oracle's source
chain, the ledger (its header, its schema, and `read_ledger` over
ledgers either package wrote), the scripted ramp 1 -> 2 -> 1 with every
stream bitwise `generate`, the spawn drill (a probe-file clamp, a
SIGKILL-class spawn failure retried within budget, budget exhaustion
re-proposed at the next poll), the all-draining deferral and a
one-process-replica ramp run on the port's driver.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from ray_lightning_tpu.autoscale import policy as jpol
from ray_lightning_tpu_torch.autoscale import policy as ppol
from ray_lightning_tpu_torch.autoscale.capacity import (
    CapacityAnswer,
    CapacityOracle,
    spawn_probe,
)
from ray_lightning_tpu_torch.autoscale.controller import (
    LEDGER_NAME,
    LEDGER_VERSION,
    AutoscaleController,
    ControllerConfig,
    read_ledger,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- decide: every script of the JAX decision table ------------------------


def _sig(pressure=0.0, queue=0.0, occ=0.0, available=True, slots=4.0):
    return {"available": available, "pressure": pressure,
            "queue_depth_now": queue, "occupancy": occ,
            "total_slots": slots}


CFG = dict(min_replicas=1, max_replicas=4, high_pressure=0.5,
           low_pressure=0.05, idle_occupancy=0.5, sustain_polls=2,
           up_cooldown_s=10.0, down_cooldown_s=20.0)
HIGH = _sig(pressure=1.0)
NONE_Q = {"available": True, "pressure": None, "queue_depth_now": 3.0,
          "occupancy": 0.0}
NONE_E = {"available": True, "pressure": None, "queue_depth_now": 0.0,
          "occupancy": 0.0}

#: name -> (config overrides, initial PolicyState kwargs, steps). A step
#: is ("decide", signal, now, capacity) or ("apply", now): commit the
#: previous decision (the controller's PolicyState.applied)
SCRIPTS = {
    "no_signal": ({}, dict(replicas=1, high_streak=5), [
        ("decide", {"available": False}, 0.0, None),
        ("decide", None, 1.0, None)]),
    "sustained_up": ({}, dict(replicas=1), [
        ("decide", HIGH, 0.0, None), ("decide", HIGH, 1.0, None)]),
    "idle_down": ({}, dict(replicas=2), [
        ("decide", _sig(occ=0.9), 0.0, None),
        ("decide", _sig(queue=1.0), 1.0, None),
        ("decide", _sig(), 2.0, None), ("decide", _sig(), 3.0, None)]),
    "in_band_reset": ({}, dict(replicas=1), [
        ("decide", HIGH, 0.0, None),
        ("decide", _sig(pressure=0.2), 1.0, None)]),
    "flapping": ({}, dict(replicas=2), [
        ("decide", _sig(pressure=1.0 if i % 2 == 0 else 0.2), float(i),
         None) for i in range(20)]),
    "up_cooldown": ({}, dict(replicas=1), [
        ("decide", HIGH, 0.0, None), ("decide", HIGH, 1.0, None),
        ("apply", 1.0), ("decide", HIGH, 2.0, None),
        ("decide", HIGH, 3.0, None), ("decide", HIGH, 12.0, None)]),
    "down_cooldown": ({}, dict(replicas=3, last_scale_up_t=100.0), [
        ("decide", _sig(), 105.0, None), ("decide", _sig(), 106.0, None),
        ("decide", _sig(), 121.0, None)]),
    "max_clamp": ({}, dict(replicas=4, high_streak=1), [
        ("decide", _sig(pressure=2.0), 0.0, None)]),
    "min_clamp": ({}, dict(replicas=1, low_streak=1), [
        ("decide", _sig(), 0.0, None)]),
    "capacity_holds": ({}, dict(replicas=2, high_streak=1), [
        ("decide", _sig(pressure=2.0), 0.0, 2)]),
    "capacity_allows": ({}, dict(replicas=2, high_streak=1), [
        ("decide", _sig(pressure=2.0), 0.0, 3)]),
    "none_pressure_queued": ({}, dict(replicas=1, high_streak=1), [
        ("decide", NONE_Q, 0.0, None)]),
    "none_pressure_empty": ({}, dict(replicas=2, low_streak=1), [
        ("decide", NONE_E, 0.0, None)]),
    "below_floor_no_signal": ({}, dict(replicas=0, last_scale_up_t=0.0), [
        ("decide", {"available": False}, 1.0, None)]),
    "below_floor_idle": ({}, dict(replicas=0), [
        ("decide", _sig(), 0.0, None)]),
    "below_floor_capacity": ({}, dict(replicas=0), [
        ("decide", _sig(), 0.0, 0)]),
    "max_step_two": (dict(max_step=2), dict(replicas=1), [
        ("decide", HIGH, 0.0, None), ("decide", HIGH, 1.0, None),
        ("apply", 1.0), ("decide", _sig(), 40.0, None),
        ("decide", _sig(), 41.0, None)]),
    "pressure_class": (dict(pressure_class="latency_critical"),
                       dict(replicas=1), [
        ("decide", {**_sig(pressure=0.0),
                    "pressure_latency_critical": 2.0,
                    "queue_depth_now_latency_critical": 3.0}, 0.0, None),
        ("decide", {**_sig(pressure=0.0),
                    "pressure_latency_critical": 2.0,
                    "queue_depth_now_latency_critical": 3.0}, 1.0, None),
        ("decide", _sig(pressure=2.0), 2.0, None)]),
}


def _run_script(pol, name):
    over, init, steps = SCRIPTS[name]
    cfg = pol.PolicyConfig(**{**CFG, **over})
    st = pol.PolicyState(**init)
    out, last = [], None
    for step in steps:
        if step[0] == "apply":
            st.applied(last, now=step[1])
        else:
            _, sig, now, cap = step
            last = pol.decide(cfg, st, sig, now=now, capacity=cap)
            out.append(last.to_dict())
        out.append(dataclasses.asdict(st))
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_decide_equals_jax_on_every_script(script):
    got = _run_script(ppol, script)
    assert got == _run_script(jpol, script)
    # the script exercised more than holds, where it should have
    actions = {d["action"] for d in got if "action" in d}
    assert actions


@pytest.mark.parametrize("bad", [
    dict(min_replicas=3, max_replicas=2),
    dict(low_pressure=0.9, high_pressure=0.5),
    dict(sustain_polls=0),
    dict(max_step=0),
    dict(min_replicas=0),
])
def test_policy_config_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as pe:
        ppol.PolicyConfig(**bad)
    with pytest.raises(ValueError) as je:
        jpol.PolicyConfig(**bad)
    assert str(pe.value) == str(je.value)


# ---- the capacity oracle ---------------------------------------------------


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv("RLT_CAPACITY", raising=False)
    monkeypatch.delenv("RLT_CAPACITY_FILE", raising=False)
    return monkeypatch


def test_oracle_chain(no_env, tmp_path):
    from ray_lightning_tpu.autoscale.capacity import (
        CapacityOracle as JaxOracle,
    )

    p = tmp_path / "cap"

    def both(**kw):
        a = CapacityOracle(**kw).query(assume=8).to_dict()
        assert a == JaxOracle(**kw).query(assume=8).to_dict()
        return a

    assert both() == {"worlds": 8, "source": "assumed",
                      "detail": both()["detail"]}
    assert CapacityOracle().query().to_dict() == {
        "worlds": None, "source": "none",
        "detail": "no capacity source configured"}
    p.write_text("2")
    assert both(probe_file=str(p))["worlds"] == 2
    p.write_text(json.dumps({"capacity": 5}))
    assert both(probe_file=str(p))["source"] == "file"
    p.write_text("not a number {")
    assert both(probe_file=str(p))["source"] == "assumed"
    no_env.setenv("RLT_CAPACITY_FILE", str(tmp_path / "cap2"))
    (tmp_path / "cap2").write_text("3")
    assert both()["worlds"] == 3
    no_env.setenv("RLT_CAPACITY", "1")
    assert both(probe_file=str(p)) == {"worlds": 1, "source": "env",
                                       "detail": "RLT_CAPACITY=1"}
    no_env.setenv("RLT_CAPACITY", "-3")
    assert both()["worlds"] == 0
    assert CapacityOracle().capacity_fn(assume=6)() == 0
    no_env.delenv("RLT_CAPACITY")
    no_env.delenv("RLT_CAPACITY_FILE")
    assert CapacityOracle().capacity_fn(assume=6)() == 6
    assert CapacityOracle().capacity_fn()() == 0
    assert CapacityAnswer(2, "env").to_dict() == {"worlds": 2,
                                                  "source": "env"}


def test_budget_capacity_fn_source(no_env):
    from ray_lightning_tpu_torch.elastic import ElasticBudget

    ans = ElasticBudget(capacity_fn=lambda: 3).capacity_answer(8)
    assert (ans.worlds, ans.source) == (3, "capacity_fn")

    def broken():
        raise RuntimeError("scheduler down")

    ans = ElasticBudget(capacity_fn=broken).capacity_answer(8)
    assert ans.worlds == 0 and "scheduler down" in ans.detail


def test_spawn_probe_counts_the_workers(no_env, tmp_path):
    """Two trivial workers through the port's `WorkerGroup`: nothing
    touches a device; the verdict is cached for the TTL."""
    oracle = CapacityOracle(spawn_probe_world=2, spawn_timeout_s=60.0)
    ans = oracle.query(assume=8)
    assert (ans.worlds, ans.source) == (2, "spawn_probe")
    assert ans.detail == "2/2 workers answered"
    assert oracle.query() is ans    # cached
    one = spawn_probe(1, timeout_s=60.0, log_dir=str(tmp_path / "probe"))
    assert one.to_dict() == {"worlds": 1, "source": "spawn_probe",
                             "detail": "1/1 workers answered"}


# ---- the ledger ------------------------------------------------------------


def _entry(i, action="hold", **outcome):
    return {"decision_index": i, "now": float(i), "t": 0.1 * i,
            "signal": {"available": True, "pressure": 0.0},
            "decision": {"action": action, "target": 1, "delta": 0,
                         "reason": "x", "clamps": []},
            "outcome": {"ok": True, "action": action, **outcome},
            "replicas": 1, "duration_s": 0.0}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_read_ledger_reads_either_package(tmp_path, writer):
    from ray_lightning_tpu.autoscale import controller as jctl
    from ray_lightning_tpu_torch.autoscale import controller as pctl

    mod = jctl if writer == "jax" else pctl
    assert mod.LEDGER_NAME == LEDGER_NAME
    assert mod.LEDGER_VERSION == LEDGER_VERSION

    class _Drv:
        n_live = 1
        driver_metrics = driver_flight = None
        cfg = None

    ctl = mod.AutoscaleController(_Drv(), run_dir=str(tmp_path),
                                  signal_fn=lambda: {"available": False})
    for i in range(3):
        ctl._append_ledger(_entry(i))
    with open(tmp_path / LEDGER_NAME, "a") as f:
        f.write("{torn\n")
    lines = (tmp_path / LEDGER_NAME).read_text().splitlines()
    head = json.loads(lines[0])
    assert head["version"] == LEDGER_VERSION
    assert {"t0_wall", "t0_perf", "pid"} <= set(head)
    assert read_ledger(str(tmp_path)) == jctl.read_ledger(str(tmp_path))
    assert [e["decision_index"] for e in read_ledger(str(tmp_path))] == [
        0, 1, 2]
    assert read_ledger(str(tmp_path / "missing")) == []
    # the report's autoscale section and both packages' timelines
    from ray_lightning_tpu.telemetry import timeline as jtl
    from ray_lightning_tpu_torch.telemetry import timeline as ptl
    from ray_lightning_tpu_torch.telemetry.report import (
        build_autoscale_section,
    )

    ctl._append_ledger(_entry(3, "scale_up", added=[1], retries=1))
    sec = build_autoscale_section(str(tmp_path), str(tmp_path / "telemetry"))
    assert (sec["decisions"], sec["scale_ups"], sec["spawn_retries"]) == (
        4, 1, 1)
    os.makedirs(tmp_path / "telemetry")
    mine = [e.to_dict() for e in ptl.load_timeline_events(
        str(tmp_path))["events"] if e.source == "autoscale"]
    assert mine == [e.to_dict() for e in jtl.load_timeline_events(
        str(tmp_path))["events"] if e.source == "autoscale"]
    assert len(mine) == 4


# ---- the driver legs (the kernel-tiling tiny Llama on the CPU) ------------


@pytest.fixture(scope="module")
def session():
    import torch

    from ray_lightning_tpu_torch.autoscale.cli import _ramp_setup

    return _ramp_setup(12, 8, torch.device("cpu"))


def _driver(model, ecfg, run_dir, **kw):
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )

    return ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device="cpu", metrics_flush_every_n_ticks=2, **kw))


HIGH_SIG = {"available": True, "pressure": 2.0, "queue_depth_now": 8.0,
            "queue_depth_p50": 8.0, "occupancy": 1.0, "total_slots": 4.0}


def test_scripted_ramp_scales_up_and_down_bitwise(session, tmp_path):
    """The closed loop on the real signal path (flushed metrics ->
    load_signal -> policy -> seams): 1 -> 2 on sustained pressure,
    2 -> 1 on idle, every stream bitwise `generate`, each decision in
    the ledger with its signal, and the report's autoscale section."""
    from ray_lightning_tpu_torch.autoscale.cli import (
        _check_streams,
        _run_ramp,
    )
    from ray_lightning_tpu_torch.telemetry.report import (
        build_serving_section,
    )

    model, ecfg, reqs, refs = session
    run_dir = str(tmp_path / "run")
    drv, ctl, sim, result = _run_ramp(model, ecfg, reqs, run_dir)
    assert (ctl.scale_ups, ctl.scale_downs) == (1, 1)
    assert result.stats["final_replicas"] == 1
    assert _check_streams(result.outputs, refs) == []
    assert len(result.meta) == len(reqs)
    entries = read_ledger(run_dir)
    assert len(entries) == ctl.decisions >= 10
    assert entries == sim["entries"]
    events = [e for e in entries if e["decision"]["action"] != "hold"
              and e["outcome"]["ok"]]
    assert [e["decision"]["action"] for e in events] == [
        "scale_up", "scale_down"]
    assert events[1]["now"] - events[0]["now"] >= 8.0
    assert all(e["signal"]["available"] for e in events)
    asc = build_serving_section(run_dir)["autoscale"]
    assert (asc["scale_ups"], asc["scale_downs"]) == (1, 1)
    assert asc["decisions"] == ctl.decisions
    counters = drv.driver_metrics.counters()
    assert counters["autoscale_scale_ups"] == 1
    assert counters["autoscale_decisions"] == ctl.decisions


def test_run_trace_and_run_scripted_drive_the_same_schedule(session,
                                                            tmp_path):
    """`run_scripted` is a shim over `run_trace`: the same arrivals,
    polled on the same ticks, give the same decisions and streams; the
    recorder lifts the schedule into a trace that replays it."""
    from ray_lightning_tpu_torch.autoscale import ScriptedLoad, run_scripted
    from ray_lightning_tpu_torch.autoscale.cli import _ramp_policy
    from ray_lightning_tpu_torch.loadgen import (
        TraceRecorder,
        arrivals_by_tick,
        run_trace,
    )

    model, ecfg, reqs, _ = session
    arrivals = {0: reqs[:4], 3: reqs[4:6]}
    outs = []
    for mode in ("scripted", "trace"):
        run_dir = str(tmp_path / mode)
        drv = _driver(model, ecfg, run_dir).start()
        ctl = AutoscaleController(drv, ControllerConfig(
            policy=_ramp_policy(2), signal_window=8))
        if mode == "scripted":
            sim = run_scripted(drv, ctl, ScriptedLoad(
                arrivals=arrivals, idle_ticks_after_drain=16))
            events = ScriptedLoad(arrivals=arrivals).to_events()
        else:
            rec = TraceRecorder()
            sim = run_trace(drv, events, controller=ctl,
                            idle_ticks_after_drain=16, recorder=rec)
            assert sim["submitted"] == 6
            assert [e.to_dict() for e in rec.events] == [
                e.to_dict() for e in events]
        res = drv.stop()
        outs.append(([e["decision"] for e in sim["entries"]],
                     sim["ticks"], res.outputs))
    assert outs[0] == outs[1]
    assert sorted(arrivals_by_tick(events)) == [0, 3]


def test_drill_clamp_then_sigkill_retried(session, tmp_path):
    """A probe file at 1 clamps the scale-up (the ledger names the clamp
    and the file's answer); at 2 the spawn dies SIGKILL-class, is
    classified retryable and retried within budget: target landed."""
    from ray_lightning_tpu_torch.autoscale.cli import _smoke_drill

    model, ecfg, _, _ = session
    failures: list = []
    leg = _smoke_drill(failures, model, ecfg, str(tmp_path / "run"),
                       str(tmp_path / "cap"))
    assert failures == []
    assert leg["clamped"]["clamps"] == ["capacity"]
    assert leg["scaled"]["outcome"]["retries"] == 1
    ledger = read_ledger(str(tmp_path / "run"))
    assert [e["capacity"]["source"] for e in ledger] == ["file", "file"]


def test_spawn_budget_exhaustion_reproposes_next_poll(session, tmp_path):
    from ray_lightning_tpu_torch.autoscale.policy import PolicyConfig

    model, ecfg, _, _ = session
    run_dir = str(tmp_path / "run")
    drv = _driver(model, ecfg, run_dir).start()
    ctl = AutoscaleController(
        drv, ControllerConfig(policy=PolicyConfig(
            min_replicas=1, max_replicas=2, sustain_polls=1,
            up_cooldown_s=0.0), max_spawn_retries=0),
        run_dir=run_dir, signal_fn=lambda: dict(HIGH_SIG))
    drv.inject_spawn_faults(1, signal_name="SIGKILL")
    entry = ctl.step(now=0.0)
    assert not entry["outcome"]["ok"] and drv.n_live == 1
    assert entry["outcome"]["failures"][0]["cause"] == \
        "worker-signal:SIGKILL"
    # the streak survived the failure: the next poll re-proposes
    entry = ctl.step(now=1.0)
    assert entry["outcome"]["ok"] and drv.n_live == 2
    drv.stop()


def test_scale_up_aborts_whole_delta_on_exhausted_budget(session,
                                                         tmp_path):
    from ray_lightning_tpu_torch.autoscale.policy import PolicyConfig

    model, ecfg, _, _ = session
    run_dir = str(tmp_path / "run")
    drv = _driver(model, ecfg, run_dir).start()
    ctl = AutoscaleController(
        drv, ControllerConfig(policy=PolicyConfig(
            min_replicas=1, max_replicas=3, sustain_polls=1, max_step=2),
            max_spawn_retries=0),
        run_dir=run_dir, signal_fn=lambda: dict(HIGH_SIG))
    drv.inject_spawn_faults(1, signal_name="SIGKILL")
    out = ctl.step(now=0.0)["outcome"]
    assert not out["ok"] and out["added"] == []
    assert len(out["failures"]) == 1 and drv.n_live == 1
    drv.stop()


def test_deferral_while_every_replica_drains(session, tmp_path):
    from ray_lightning_tpu_torch.autoscale.cli import _smoke_deferral

    model, ecfg, reqs, refs = session
    failures: list = []
    leg = _smoke_deferral(failures, model, ecfg, reqs, refs,
                          str(tmp_path / "run"))
    assert failures == []
    assert leg["deferred_target"] is None
    assert leg["last_deferral"]["reason"].startswith("no live replica")
    assert leg["submit_deferrals"] == 1


def test_one_process_replica_ramp(tmp_path):
    """1 -> 2 -> 1 process replicas over the request channel, a
    mid-stream SIGKILL absorbed by the respawn replay, every stream
    bitwise `generate`."""
    import torch

    from ray_lightning_tpu_torch.autoscale.cli import _smoke_process_ramp
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    failures: list = []
    leg = _smoke_process_ramp(
        failures, EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                               prefill_chunk=4),
        str(tmp_path / "run"), torch.device("cpu"))
    assert failures == []
    assert leg["replicas_spawned"] == 2 and leg["final_replicas"] == 1
    assert leg["restarts"]["0"] >= 1


def test_autoscale_smoke_cli():
    """``python -m ray_lightning_tpu_torch autoscale --smoke --device
    cpu`` exits 0 with ``"ok": true``; without a device it is the CPU
    gate's refusal (2) on a box with no card."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "autoscale",
         "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True
    ramp = verdict["legs"]["ramp"]
    assert ramp["kernel_build_s"] == 0.0
    assert ramp["kernel_calls"]["paged_attention_kernel"] == \
        2 * ramp["ticks"]
