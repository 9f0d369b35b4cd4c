"""The port's SLO watch and incident capture (`telemetry/watch.py`,
`telemetry/incidents.py`) against the JAX package's (`tests/test_watch.py`),
on the CPU.

Rule validation, sustain, burn-rate windows and episodes run the same
scripted surfaces through both packages' `WatchEngine`: the polls that
fire must be the same, and so must the records. The metric surfaces
read the same persisted files to the same values in both. An incident
lands in the JAX format, and its profiler marker is what the port's
`ProfilerController` captures on. A supervised two-process run with a
killed worker fires the restart rule into `SupervisedResult.incidents`.
"""
from __future__ import annotations

import json
import os
import time

import pytest

from ray_lightning_tpu.telemetry import incidents as jinc
from ray_lightning_tpu.telemetry import watch as jwatch
from ray_lightning_tpu_torch.telemetry import goodput as pgoodput
from ray_lightning_tpu_torch.telemetry import incidents as pinc
from ray_lightning_tpu_torch.telemetry import metrics as pmetrics
from ray_lightning_tpu_torch.telemetry import profiler as pprofiler
from ray_lightning_tpu_torch.telemetry import watch as pwatch

WATCH = {"jax": jwatch, "torch": pwatch}


def _tdir(run):
    return os.path.join(run, "telemetry")


def _rule_fields(rule):
    return (rule.name, rule.metric, rule.op, rule.threshold, rule.sustain,
            rule.window, rule.severity)


# ---- rules --------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    ("r", "load.pressure", "~", 1.0, {}),
    ("r", "load.pressure", ">", 1.0, {"sustain": 0}),
    ("r", "load.pressure", ">", 1.0, {"sustain": 3, "window": 2}),
    ("r", "load.pressure", ">", 1.0, {"severity": "meh"}),
])
def test_rule_validation_matches_jax(spec):
    *args, kw = spec
    messages = []
    for mod in WATCH.values():
        with pytest.raises(ValueError) as err:
            mod.WatchRule(*args, **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("op", [">", ">=", "<", "<="])
def test_breached_matches_jax(op):
    for value in (1.9, 2.0, 2.1):
        assert pwatch.WatchRule("r", "m.x", op, 2.0).breached(value) == \
            jwatch.WatchRule("r", "m.x", op, 2.0).breached(value)


def test_builtin_rules_and_config_coerce_match_jax():
    assert [_rule_fields(r) for r in pwatch.BUILTIN_RULES] == \
        [_rule_fields(r) for r in jwatch.BUILTIN_RULES]
    assert pwatch.WatchConfig.coerce(None) is None
    assert pwatch.WatchConfig.coerce(False) is None
    assert pwatch.WatchConfig.coerce(True).rules == pwatch.BUILTIN_RULES
    rules = (pwatch.WatchRule("r", "load.pressure", ">", 1.0),)
    assert pwatch.WatchConfig.coerce(rules).rules == rules
    cfg = pwatch.WatchConfig(excerpt_events=3)
    assert pwatch.WatchConfig.coerce(cfg) is cfg
    with pytest.raises(TypeError):
        pwatch.WatchConfig.coerce("yes")


# ---- engine semantics on scripted surfaces ----------------------------------


def _scripted(script):
    class Surfaces:
        """MetricSurfaces stand-in: one scripted value per poll."""

        def __init__(self, run_dir, tail_bytes=0, telemetry_dir=None):
            pass

        def value(self, selector):
            seq = script.get(selector)
            return seq.pop(0) if seq else None

        def evidence(self, selector):
            return {"scripted": True}

    return Surfaces


SCRIPTS = {
    # name: (values, sustain, window, polls that fire)
    "sustain": ([3.0, 1.0, 3.0, 3.0, 3.0], 2, 0, [0, 0, 0, 1, 0]),
    "burn_rate": ([3.0, 1.0, 3.0], 2, 4, [0, 0, 1]),
    "episode": ([3.0, 3.0, 3.0, 1.0, 3.0], 1, 0, [1, 0, 0, 0, 1]),
    "no_signal_holds": ([3.0, None, 3.0], 2, 0, [0, 0, 1]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_engine_fires_where_jax_fires(tmp_path, monkeypatch, name):
    values, sustain, window, want = SCRIPTS[name]
    out = {}
    for pkg, mod in WATCH.items():
        monkeypatch.setattr(mod, "MetricSurfaces",
                            _scripted({"load.pressure": list(values)}))
        run = str(tmp_path / pkg)
        rule = mod.WatchRule("qp", "load.pressure", ">", 2.0,
                             sustain=sustain, window=window)
        eng = mod.WatchEngine(run, mod.WatchConfig(rules=(rule,),
                                                   capture=False),
                              clock=lambda: 1000.0)
        fired = [len(eng.poll()) for _ in values]
        incidents = [{k: v for k, v in i.items()
                      if k != "timeline_excerpt"} for i in eng.incidents]
        out[pkg] = (fired, incidents, eng.summary())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == want


# ---- metric surfaces over persisted files -------------------------------------


def _serving(run, ttft=(0.01, 0.02, 3.0)):
    reg = pmetrics.MetricsRegistry(_tdir(run), replica=0,
                                   flush_every_n_ticks=1)
    for v in ttft:
        reg.observe("ttft_s", v)
    reg.gauge("queue_depth", 8.0)
    reg.gauge("decoding_slots", 2.0)
    reg.gauge("free_slots", 0.0)
    reg.gauge("blocks_free", 3.0)
    reg.gauge("blocks_in_use", 5.0)
    reg.tick_end()
    reg.close()


def _goodput(run):
    pgoodput.write_goodput(_tdir(run), {
        "wall_s": 10.0, "goodput_fraction": 0.4,
        "buckets": {"backoff_s": 2.0}, "events": {"restarts": 2}})


def _guard(run):
    for step, streak in ((10, 1), (20, 4)):
        d = os.path.join(run, f"step={step}")
        os.makedirs(os.path.join(d, "state"))
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"global_step": step, "blessed": streak < 3,
                       "guard": {"skipped_steps": streak, "streak": streak,
                                 "last_anomaly": step,
                                 "updates": step - streak}}, f)


def _restarts(run):
    os.makedirs(_tdir(run), exist_ok=True)
    for uid in ("100-0", "101-0", "102-0"):
        with open(os.path.join(_tdir(run), f"ledger.rank0.{uid}.json"),
                  "w") as f:
            json.dump({"version": "rlt-ledger-v1", "rank": 0}, f)
    with open(os.path.join(run, "flight.json"), "w") as f:
        json.dump({"version": "rlt-flight-v1",
                   "dumps": [{"replica": 0, "death": {}}]}, f)


SURFACES = {
    "serving": (_serving, ["serving.ttft_p99_s", "serving.ttft_p50_s",
                           "serving.nosuch_p99_s", "serving.ttft_pxx_s"]),
    "load": (_serving, ["load.queue_depth_p50", "load.pressure",
                        "load.blocks_free_fraction", "load.occupancy"]),
    "goodput": (_goodput, ["goodput.goodput_fraction", "goodput.backoff_s",
                           "goodput.restarts", "goodput.nosuch"]),
    "guard": (_guard, ["guard.streak", "guard.skipped_steps",
                       "guard.global_step"]),
    "restarts": (_restarts, ["restarts.count", "restarts.replica_deaths",
                             "restarts.attempts"]),
    "empty": (lambda run: None, ["serving.ttft_p99_s", "load.pressure",
                                 "goodput.goodput_fraction", "guard.streak",
                                 "restarts.count", "bogus.x"]),
}


@pytest.mark.parametrize("name", list(SURFACES))
def test_surfaces_read_the_values_jax_reads(tmp_path, name):
    write, selectors = SURFACES[name]
    run = str(tmp_path)
    write(run)
    got, want = pwatch.MetricSurfaces(run), jwatch.MetricSurfaces(run)
    for sel in selectors:
        assert got.value(sel) == want.value(sel), sel
        assert got.evidence(sel) == want.evidence(sel), sel
    if name == "serving":
        assert got.value("serving.ttft_p99_s") == pytest.approx(3.0,
                                                                 rel=0.25)
    elif name == "guard":
        assert got.value("guard.streak") == 4.0
    elif name == "restarts":
        assert got.value("restarts.count") == 3.0


# ---- incidents -------------------------------------------------------------------


def test_incident_record_contract_and_the_profiler_marker(tmp_path,
                                                         monkeypatch):
    """A TTFT breach over a served run dir fires once an episode, lands
    a record the JAX reader reads equal, and drops the capture marker
    that the port's profiler controller turns into one capture."""
    run = str(tmp_path)
    _serving(run)
    rule = next(r for r in pwatch.BUILTIN_RULES if r.name == "ttft_p99")
    eng = pwatch.WatchEngine(run, pwatch.WatchConfig(rules=(rule,)))
    assert [i["rule"] for i in eng.poll()] == ["ttft_p99"]
    assert eng.poll() == []
    parsed = pinc.read_incidents(run)
    assert parsed == jinc.read_incidents(run)
    assert parsed["header"]["version"] == jinc.INCIDENTS_VERSION
    [inc] = parsed["incidents"]
    ev = inc["evidence"]
    assert ev["metric"] == "serving.ttft_p99_s" and ev["sketch"]
    assert ev["value"] > rule.threshold and inc["window"]
    assert inc["severity"] == "page"
    assert any(e["source"] == "metrics" for e in inc["timeline_excerpt"])
    marker = inc["actions"]["profiler_marker"]
    assert os.path.basename(marker) == pprofiler.DEFAULT_MARKER

    started = []

    class _Session:
        def start(self):
            started.append(True)

        def step(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            open(path, "w").close()

    monkeypatch.setattr(pprofiler, "_session", lambda on_card: _Session())
    ctl = pprofiler.ProfilerController(pprofiler.ProfileConfig(
        dir=os.path.dirname(marker), num_steps=1, poll_every_n_steps=1))
    for step in (1, 2, 3):
        ctl.on_step(step)
    assert started == [True] and ctl.captures == 1
    assert not os.path.exists(marker)  # one marker, one capture


def test_capture_marker_once_and_forced_flight_persist(tmp_path):
    run = str(tmp_path)
    a1 = pinc.capture_evidence(run)
    assert os.path.exists(a1["profiler_marker"])
    a2 = pinc.capture_evidence(run)
    assert a2 == {"profiler_marker_pending": a1["profiler_marker"]}

    class _Drv:
        persisted = 0

        def force_flight_persist(self):
            self.persisted += 1
            return 2

    drv = _Drv()
    assert pinc.capture_evidence(run, driver=drv)["flight_persisted"] == 2

    class _Broken:
        def force_flight_persist(self):
            raise RuntimeError("dead")

    assert "flight_persist_error" in pinc.capture_evidence(
        run, driver=_Broken())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_incident_ledger_cross_read_with_garbage(tmp_path, writer):
    mod = jinc if writer == "jax" else pinc
    run = str(tmp_path)
    mod.append_incident(run, {"rule": "a", "severity": "warn", "wall": 1.0})
    mod.append_incident(run, {"rule": "b", "severity": "page", "wall": 2.0})
    with open(os.path.join(run, "incidents.jsonl"), "a") as f:
        f.write("{torn")
    parsed = pinc.read_incidents(run)
    assert parsed == jinc.read_incidents(run)
    assert [i["rule"] for i in parsed["incidents"]] == ["a", "b"]
    assert parsed["unparseable_lines"] == 1
    assert pinc.read_incidents(run, tail_bytes=40) == \
        jinc.read_incidents(run, tail_bytes=40)


def test_watch_cli_one_shot(tmp_path, capsys):
    from ray_lightning_tpu_torch.__main__ import main

    run = str(tmp_path)
    _serving(run)
    assert main(["watch", run, "--ttft-max", "0.001", "--no-capture"]) == 0
    out = capsys.readouterr().out
    assert "ttft_p99" in out and "1 new incident" in out
    [inc] = pinc.read_incidents(run)["incidents"]
    assert "actions" not in inc
    assert main(["watch", run, "--json"]) == 0
    view = json.loads(capsys.readouterr().out.strip())
    assert view["polls"] == 1 and "ttft_p99" in view["rules"]
    assert main(["watch", str(tmp_path / "missing")]) == 2


def test_supervised_watch_fires_the_restart_rule(tmp_path):
    """Two gloo ranks under `fit_supervised` with ``watch=`` and rank 0
    SIGKILL'd: the restart rule fires into SupervisedResult.incidents
    and <checkpoint_dir>/incidents.jsonl (the JAX package's
    `test_supervisor_watch_arming`)."""
    from ray_lightning_tpu_torch.resilience import (
        ResilienceConfig,
        RetryPolicy,
        fit_supervised,
    )
    from tests import torch_jobs

    base = str(tmp_path / "ckpts")
    rule = pwatch.WatchRule("restart_rate", "restarts.count", ">=", 1,
                            severity="warn")
    cfg = ResilienceConfig(
        checkpoint_dir=base,
        policy=RetryPolicy(max_restarts=2, backoff_base_s=0.2, jitter=0.0),
        save_every_n_steps=2, heartbeat_interval_s=1.0, stall_timeout_s=0.0,
        faults="kill:rank=0,step=3", watch=pwatch.WatchConfig(rules=(rule,)))
    t0 = time.monotonic()
    sup = fit_supervised(torch_jobs.sup_module, torch_jobs.sup_trainer,
                         torch_jobs.sup_data, 2, resilience=cfg,
                         device="cpu", timeout=120,
                         log_dir=str(tmp_path / "logs"))
    assert time.monotonic() - t0 < 120
    assert sup.restarts == 1
    assert [i["rule"] for i in sup.incidents] == ["restart_rate"]
    [inc] = pinc.read_incidents(base)["incidents"]
    assert inc["evidence"]["restarts"]["attempts"] >= 2
    assert sup.goodput is not None


def test_controller_watch_polls_on_its_cadence(tmp_path):
    """`ControllerConfig(watch=)`: the controller's poll is the watch's
    cadence for a serving session. A queue-pressure signal past the
    rule's bound, flushed by the driver, fires once per episode into
    ``<run_dir>/incidents.jsonl``."""
    import torch

    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController,
        ControllerConfig,
        PolicyConfig,
    )
    from ray_lightning_tpu_torch.serve.cli import _tiny_setup
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    model, reqs = _tiny_setup(8, 6, torch.device("cpu"))
    run_dir = str(tmp_path / "run")
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        engine=EngineConfig(capacity=2, block_size=4, blocks_per_slot=8,
                            prefill_chunk=4),
        run_dir=run_dir, device="cpu", metrics_flush_every_n_ticks=1))
    drv.start()
    rule = pwatch.WatchRule("queue_deep", "load.queue_depth_now", ">=", 2.0,
                            sustain=1, severity="warn")
    ctl = AutoscaleController(drv, ControllerConfig(
        policy=PolicyConfig(min_replicas=1, max_replicas=1),
        watch=pwatch.WatchConfig(rules=(rule,), capture=False)))
    assert ctl.watch is not None and ctl.watch.driver is drv
    for r in reqs:
        drv.submit(r)
    fired_at = []
    tick = 0
    while drv.busy():
        drv.tick()
        tick += 1
        ctl.step(now=float(tick))
        fired_at.extend(i["wall"] for i in ctl.watch.incidents[
            len(fired_at):])
    drv.stop()
    assert ctl.watch.polls == ctl.decisions == tick
    parsed = pinc.read_incidents(run_dir)
    assert [i["rule"] for i in parsed["incidents"]] == ["queue_deep"]
    assert parsed["incidents"][0]["evidence"]["value"] >= 2.0
    # the JAX reader reads the port's ledger
    assert [i["rule"] for i in jinc.read_incidents(run_dir)["incidents"]] \
        == ["queue_deep"]


def test_watch_smoke_cli():
    """``python -m ray_lightning_tpu_torch watch --smoke --device cpu``:
    an injected serving stall fires ttft_p99 once, the incident record
    is auditable, and the run's timeline exports valid Chrome JSON from
    at least four sources (the autoscale ledger among them)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "watch",
         "--smoke", "--device", "cpu", "--json"],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True
    assert out["watch"]["fired_first_poll"] == ["ttft_p99"]
    assert out["watch"]["fired_later_polls"] == []
    assert "autoscale" in out["timeline"]["sources"]
    assert len(out["timeline"]["sources"]) >= 4
    assert out["incident"]["value"] > 0.125
