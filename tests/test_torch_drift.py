"""The drift section and ``monitor --smoke`` (`ray_lightning_tpu_torch/
telemetry/report.py`): `build_drift`'s verdicts and flags equal to the
JAX function's on the same inputs, the prediction from tracecheck, the
``report --preset`` section, and the three-leg gate on the CPU."""
import json
import os
import subprocess
import sys

import pytest

from ray_lightning_tpu.telemetry import report as jreport
from ray_lightning_tpu_torch.telemetry import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRED = {"label": "x", "topology": "h100-8", "ici_time_us": 900.0,
        "ici_exposed_us": 400.0, "ici_hidden_us": 500.0,
        "overlap_hidden_fraction": 0.5, "compute_us": 9600.0,
        "step_us": 10000.0}


@pytest.mark.parametrize("predicted,p50_s", [
    (PRED, 0.0101), (PRED, 0.02), (PRED, 0.005), (PRED, None),
    ({"label": "x", "error": "boom"}, 0.01),
    ({**PRED, "step_us": None, "compute_us": None}, 0.01),
])
def test_build_drift_equals_jax(predicted, p50_s):
    timeline = None if p50_s is None else {
        "step_stats": {"p50_s": p50_s, "mean_s": p50_s * 1.1, "steps": 5}}
    assert report.DRIFT_THRESHOLD == jreport.DRIFT_THRESHOLD == 0.25
    got = report.build_drift(dict(predicted), timeline)
    want = jreport.build_drift(dict(predicted), timeline)
    assert got == want


def test_prediction_from_tracecheck_and_the_report_section(tmp_path):
    pred = report.predicted_step_composition("llama_fsdp_example.py",
                                             "cpu-2")
    assert "error" not in pred, pred
    assert pred["step_us"] >= pred["compute_us"] > 0
    assert pred["ici_time_us"] >= pred["ici_exposed_us"] >= 0
    assert 0 <= pred["overlap_hidden_fraction"] <= 1
    assert report.predicted_step_composition("nope", "cpu-2") == {
        "error": "unknown preset 'nope'"}
    out = report.build_report(str(tmp_path), preset="llama_fsdp_example.py",
                              topo="cpu-2")
    assert out["drift"]["verdict"] == "not-measured"
    assert out["drift"]["predicted"]["step_us"] == pytest.approx(
        pred["step_us"])


def test_monitor_smoke_on_the_cpu():
    """The three legs: the telemetry-off pin (bitwise fits, identical
    traced op streams), a supervised kill's goodput (one process here, to
    keep the suite cheap; the CLI's default is two), the drift section
    (the tiny Llama's topology: the flagship's trace runs in
    `test_torch_trace_cli.py`)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "monitor",
         "--smoke", "--device", "cpu", "--processes", "1",
         "--flagship-topo", "cpu-4", "--json"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["ok"] and not verdict.get("errors")
    pin = verdict["off_pin"]
    assert pin["params_bitwise_identical"] and pin["op_stream_identical"]
    assert pin["ops"] > 0
    g = verdict["goodput_leg"]["goodput"]
    assert verdict["goodput_leg"]["restarts"] >= 1
    assert g["buckets"]["backoff_s"] > 0
    assert g["buckets"]["rollback_replay_s"] > 0
    assert verdict["flagship_drift"]["verdict"] == "not-measured"
    assert verdict["flagship_drift"]["predicted"]["step_us"] > 0


def test_monitor_without_run_dir_or_smoke_is_invalid(capsys):
    from ray_lightning_tpu_torch.__main__ import main

    assert main(["monitor"]) == 2
    assert "run dir" in capsys.readouterr().err
