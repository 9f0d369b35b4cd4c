"""The port's unified timeline (`telemetry/timeline.py`) and report
against the JAX package's (`tests/test_timeline.py`), on the CPU.

Every ledger kind a run leaves is written by one package and read by
both: spans, goodput attempt ledgers, serving metrics, flight rings and
the run-level postmortem, the autoscale and reshard ledgers (written by
the JAX package's own writers: the port has no autoscaler or elastic
layer, but it reads their files) and incidents. The events, their
order, the garbage-line counts and the Chrome trace must be EQUAL
whichever package wrote and whichever reads; the trace passes the
validator of both.
"""
from __future__ import annotations

import json
import os
import time

import pytest

from ray_lightning_tpu.telemetry import goodput as jgoodput
from ray_lightning_tpu.telemetry import incidents as jincidents
from ray_lightning_tpu.telemetry import metrics as jmetrics
from ray_lightning_tpu.telemetry import report as jreport
from ray_lightning_tpu.telemetry import spans as jspans
from ray_lightning_tpu.telemetry import timeline as jtimeline
from ray_lightning_tpu_torch.telemetry import goodput as pgoodput
from ray_lightning_tpu_torch.telemetry import incidents as pincidents
from ray_lightning_tpu_torch.telemetry import metrics as pmetrics
from ray_lightning_tpu_torch.telemetry import report as preport
from ray_lightning_tpu_torch.telemetry import spans as pspans
from ray_lightning_tpu_torch.telemetry import timeline as ptimeline

#: each package's writers, by the name of the package
WRITERS = {
    "jax": (jspans, jgoodput, jmetrics, jincidents),
    "torch": (pspans, pgoodput, pmetrics, pincidents),
}
KINDS = ("spans", "goodput", "metrics", "flight", "autoscale", "reshard",
         "incident")


def _tdir(run):
    return os.path.join(run, "telemetry")


def _write(run, kind, writer):
    """One ledger of ``kind`` under the run dir ``run``."""
    spans, goodput, metrics, incidents = WRITERS[writer]
    if kind == "spans":
        rec = spans.TelemetryRecorder(_tdir(run), rank=0)
        rec.record("dispatch", rec.t0_perf + 0.001, 0.002, step=0)
        rec.record("step", rec.t0_perf + 0.004, 0.003, step=1)
        rec.record("h2d", rec.t0_perf + 0.002, 0.001, step=1,
                   thread=spans.THREAD_PRODUCER, meta={"bytes": 64})
        rec.close()
    elif kind == "goodput":
        led = goodput.worker_ledger(spans.NULL_RECORDER, 2.0, rank=0,
                                    start_step=0, end_step=10,
                                    launch_s=1.5)
        goodput.write_ledger(_tdir(run), led, uid="1-0")
    elif kind == "metrics":
        reg = metrics.MetricsRegistry(_tdir(run), replica=1,
                                      flush_every_n_ticks=1)
        for i in range(3):
            reg.gauge("queue_depth", float(i))
            reg.gauge("slot_occupancy", 0.5)
            reg.observe("ttft_s", 0.01 * (i + 1))
            reg.tick_end()
        reg.close()
    elif kind == "flight":
        fr = metrics.FlightRecorder(metrics.flight_path(_tdir(run), 0),
                                    replica=0, persist_every=1)
        fr.record("admit", rid="r0", slot=0)
        fr.record("tick", tick=1, queue_depth=0)
        fr.close()
        metrics.finalize_flight(_tdir(run), 0, {
            "kind": "retryable", "cause": "worker-signal:SIGKILL"},
            os.path.join(run, "flight.json"))
    elif kind == "autoscale":
        from ray_lightning_tpu.autoscale.controller import (
            AutoscaleController,
            ControllerConfig,
        )

        class _Drv:
            n_live = 1
            driver_metrics = None
            driver_flight = None

        ctl = AutoscaleController(
            _Drv(), ControllerConfig(), run_dir=run,
            signal_fn=lambda: {"available": False, "reason": "test"})
        ctl.step(now=0.0)
        ctl.step(now=1.0)
    elif kind == "reshard":
        from ray_lightning_tpu.resilience.supervisor import (
            _append_reshard_ledger,
        )

        _append_reshard_ledger(run, {
            "from_world": 2, "to_world": 1, "reason": "shrink",
            "attempt": 2, "at": time.time()})
    else:
        incidents.append_incident(run, {
            "rule": "ttft_p99", "severity": "page", "wall": time.time(),
            "evidence": {"metric": "serving.ttft_p99_s", "value": 3.0,
                         "op": ">", "threshold": 2.0},
            "actions": {"profiler_marker": "m"},
            "timeline_excerpt": [{"source": "spans"}]})


def _events(mod, run, **kw):
    tl = mod.load_timeline_events(run, **kw)
    return tl, [e.to_dict() for e in tl["events"]]


def _same_timeline(run, **kw):
    ptl, pev = _events(ptimeline, run, **kw)
    jtl, jev = _events(jtimeline, run, **kw)
    assert pev == jev
    for key in ("sources", "unaligned", "garbage_lines", "telemetry_dir"):
        assert ptl[key] == jtl[key], key
    return ptl, pev


@pytest.mark.parametrize("writer", list(WRITERS))
@pytest.mark.parametrize("kind", KINDS)
def test_each_ledger_reads_equal_in_both_packages(tmp_path, kind, writer):
    run = str(tmp_path)
    _write(run, kind, writer)
    tl, events = _same_timeline(run)
    source = "incident" if kind == "incident" else kind
    assert tl["sources"].get(source, 0) >= 1
    assert all(e["source"] == source for e in events)
    assert tl["unaligned"] == 0 and tl["garbage_lines"] == 0


@pytest.mark.parametrize("kind", ["spans", "goodput", "metrics", "flight",
                                  "incident"])
def test_the_port_writes_what_jax_writes(tmp_path, kind):
    """The same ledger written by each package gives the same events
    (walls and process ids aside)."""
    out = {}
    for writer in WRITERS:
        run = str(tmp_path / writer)
        os.makedirs(run)
        _write(run, kind, writer)
        _, events = _events(ptimeline, run)
        for e in events:
            e.pop("wall")
            for key in ("pid", "uid", "dumped_at_wall", "t0_wall"):
                e.get("payload", {}).pop(key, None)
        out[writer] = events
    assert out["torch"] == out["jax"] and out["torch"]


def _every_ledger(run, writer):
    for kind in KINDS:
        _write(run, kind, writer)
    return run


@pytest.mark.parametrize("writer", list(WRITERS))
def test_merged_timeline_and_chrome_trace_equal(tmp_path, writer):
    run = _every_ledger(str(tmp_path), writer)
    tl, events = _same_timeline(run)
    assert set(tl["sources"]) == set(ptimeline.TIMELINE_SOURCES)
    walls = [e["wall"] for e in events]
    assert walls == sorted(walls)
    doc = ptimeline.to_chrome_trace(tl["events"])
    jdoc = jtimeline.to_chrome_trace(jtimeline.load_timeline_events(
        run)["events"])
    assert doc["traceEvents"] == jdoc["traceEvents"]
    assert ptimeline.validate_chrome_trace(doc) == []
    assert jtimeline.validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "spans"]
    assert spans and all(e["ph"] == "X" and e["dur"] > 0 for e in spans)
    mid = tl["events"][len(tl["events"]) // 2].wall
    assert ptimeline.timeline_excerpt(tl["events"], mid, n=2) == \
        jtimeline.timeline_excerpt(jtimeline.load_timeline_events(
            run)["events"], mid, n=2)
    _same_timeline(run, tail_bytes=300)


def test_garbage_and_legacy_headerless_ledgers(tmp_path):
    """Torn lines are skipped and counted; a headerless autoscale
    ledger ingests as unaligned events after the aligned stream."""
    run = str(tmp_path)
    _write(run, "spans", "torch")
    span_file = next(os.path.join(_tdir(run), f)
                     for f in os.listdir(_tdir(run))
                     if f.endswith(".spans.jsonl"))
    with open(span_file, "a") as f:
        f.write('{"phase": "step", "t": 0.5, "du')
    with open(os.path.join(run, "autoscale.jsonl"), "w") as f:
        for now in (4.0, 6.0):
            f.write(json.dumps({
                "decision_index": 0, "now": now,
                "decision": {"action": "scale_up", "target": 2,
                             "delta": 1, "reason": "legacy"},
                "outcome": {"ok": True}, "replicas": 2}) + "\n")
        f.write("not json\n")
    tl, events = _same_timeline(run)
    assert tl["garbage_lines"] == 2 and tl["unaligned"] == 2
    assert [e["wall"] for e in events[-2:]] == [4.0, 6.0]
    assert preport.read_autoscale_ledger(run) == \
        __import__("ray_lightning_tpu.autoscale.controller",
                   fromlist=["read_ledger"]).read_ledger(run)


@pytest.mark.parametrize("doc", [
    {"nope": 1},
    {"traceEvents": [{"name": "x", "ph": "i"}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                      "ts": 1.0}]},
    {"traceEvents": [{"name": "x", "ph": "i", "pid": 0, "tid": 0,
                      "ts": -1.0}]},
    {"traceEvents": [{"name": "x", "ph": "i", "pid": 0, "tid": 0,
                      "ts": 1.0, "s": "g"}]},
])
def test_chrome_trace_validator_matches_jax(doc):
    assert ptimeline.validate_chrome_trace(doc) == \
        jtimeline.validate_chrome_trace(doc)


def test_empty_dir_is_partial_not_fatal(tmp_path):
    tl, events = _same_timeline(str(tmp_path))
    assert events == [] and tl["sources"] == {}
    assert ptimeline.render_text(tl).startswith("timeline:")


def test_timeline_cli(tmp_path, capsys):
    from ray_lightning_tpu_torch.__main__ import main

    run = _every_ledger(str(tmp_path / "run"), "torch")
    out = str(tmp_path / "trace.json")
    assert main(["timeline", run, "--chrome", out]) == 0
    with open(out) as f:
        assert jtimeline.validate_chrome_trace(json.load(f)) == []
    capsys.readouterr()
    assert main(["timeline", run, "--json", "--source", "spans"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["events"] and all(e["source"] == "spans"
                                 for e in doc["events"])
    assert main(["timeline", run, "--limit", "5"]) == 0
    assert "timeline:" in capsys.readouterr().out
    assert main(["timeline", str(tmp_path / "nope")]) == 2


def _report_equal(run):
    got, want = preport.build_report(run), jreport.build_report(run)
    for key in ("ranks", "step_stats", "phase_totals", "goodput",
                "streams", "incidents"):
        assert got.get(key) == want.get(key), key
    got_sv, want_sv = got.get("serving"), want.get("serving")
    assert (got_sv is None) == (want_sv is None)
    if got_sv:
        assert got_sv == want_sv
    return got


def test_report_over_every_ledger_equals_jax(tmp_path, capsys):
    """The port's report over a run dir with every ledger (and each
    partial subset of it) equals the JAX one, section for section,
    incidents and the autoscale summary included."""
    from ray_lightning_tpu_torch.__main__ import main

    run = str(tmp_path / "full")
    os.makedirs(run)
    assert _report_equal(run)["streams"]["present"] == []
    for kind in KINDS:
        _write(run, kind, "torch")
        _report_equal(run)
    pgoodput.write_goodput(_tdir(run), pgoodput.assemble_goodput(
        _tdir(run), 3.0, backoff_s=0.5, restarts=1))
    out = _report_equal(run)
    assert out["goodput"]["buckets"]["backoff_s"] == 0.5
    assert out["incidents"]["count"] == 1
    assert out["serving"]["autoscale"]["decisions"] == 2
    assert set(out["streams"]["present"]) >= {"spans", "goodput",
                                              "metrics", "flight",
                                              "autoscale", "reshard",
                                              "incidents"}
    assert main(["report", run]) == 0
    text = capsys.readouterr().out
    assert "incidents: 1" in text and "autoscale" in text
    assert main(["report", str(tmp_path / "nope")]) == 2


def test_monitor_partial_dirs_do_not_raise(tmp_path):
    empty = str(tmp_path)
    view = preport._monitor_once(empty)
    assert view == jreport._monitor_once(empty)
    assert view["ranks"] == {} and view["goodput"] is None
    sview = preport._monitor_serve_once(empty, tail_bytes=4096)
    assert sview == jreport._monitor_serve_once(empty, tail_bytes=4096)
    assert sview["load_signal"]["available"] is False


def test_report_prints_a_run_without_tpot(tmp_path, capsys):
    """A served run whose requests all ended at their first token has a
    TTFT histogram and no TPOT one. The JAX printer raises KeyError on
    it; the port's prints the TTFT line and says no TPOT was seen."""
    reg = pmetrics.MetricsRegistry(_tdir(str(tmp_path)),
                                   flush_every_n_ticks=1)
    reg.observe("ttft_s", 0.02)
    reg.tick_end()
    reg.close()
    out = preport.build_report(str(tmp_path))
    assert out["serving"] == jreport.build_report(str(tmp_path))["serving"]
    with pytest.raises(KeyError, match="tpot"):
        jreport._print_report(out)
    capsys.readouterr()
    preport._print_report(out)
    assert "no TPOT observed" in capsys.readouterr().out
