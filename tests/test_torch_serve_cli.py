"""``python -m ray_lightning_tpu_torch serve`` on the CPU: the smoke gate
passes with every ported leg passed (the speculative leg among them) and
every left-out leg reported ``not_ported`` with its ROADMAP item (never
as passed), the example serves through inline and process replicas, and
the card stays the default."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORTED = ("inline_churn", "metrics_emission", "replica_kill",
          "metrics_merge", "flight_recorder", "fused_paged",
          "fused_prefill", "prefix_sharing", "speculative", "audit")
LEFT_OUT = {}


def _serve(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "serve", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_smoke_gate_passes_on_the_cpu():
    out = _serve("--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True and "failures" not in verdict
    legs = verdict["legs"]
    assert set(legs) == set(PORTED) | set(LEFT_OUT)
    for name in PORTED:
        assert legs[name]["status"] == "passed", name
    for name, item in LEFT_OUT.items():
        assert legs[name]["status"] == "not_ported", name
        assert item in legs[name]["item"], name
    audit = legs["audit"]  # the decode-step audit, both lanes
    assert set(audit["kernel"]["kernels"]) >= {
        "rltt.paged_decode", "rltt.paged_prefill", "rltt.rms_norm"}
    assert not {"RLT307", "RLT308"} & set(audit["kernel"]["rules"])
    assert {"RLT307", "RLT308"} <= set(audit["reference"]["rules"])
    churn = legs["inline_churn"]
    assert churn["bitwise_mismatches"] == []
    assert churn["compile_count"] == -1 and churn["kernel_build_s"] == 0.0
    assert churn["kernel_calls"]["paged_attention_kernel"] == \
        2 * churn["ticks"]
    assert churn["kernel_calls"]["paged_prefill_kernel"] == \
        2 * churn["prefill_chunks"] > 0
    assert legs["replica_kill"]["restarts"] == {"0": 0, "1": 1}
    assert legs["flight_recorder"]["death"]["kind"] == "retryable"
    assert legs["prefix_sharing"]["shared_block_fraction"] > 0
    assert legs["speculative"]["bitwise_mismatches"] == []
    assert legs["speculative"]["accepted_tokens_per_step"] >= 1.0


@pytest.mark.parametrize("argv", [
    (), ("--replicas", "2", "--backend", "process")])
def test_example_serves(argv, tmp_path):
    run_dir = str(tmp_path / "run")
    out = _serve("example", "--device", "cpu", "--json", "--run-dir",
                 run_dir, *argv)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["n_requests"] == 8 and line["device"] == "cpu"
    assert line["decode_tokens_per_s"] > 0
    assert line["compile_count"] == -1
    assert os.path.exists(os.path.join(run_dir, "serving.json"))


def test_left_out_presets_and_the_card_default():
    from ray_lightning_tpu_torch.__main__ import main

    # the flagship preset is the static plan (no device), and only its
    # decode-step audit is left out (item 13)
    assert main(["serve", "llama3-8b", "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        # the card is the default: no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "example"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "--smoke"])


def test_kernel_calls_keep_the_wrappers_launch_counters():
    """While counted, a wrapper that bumps its own ``launches`` through
    its module's global name (as each does when it launches on the card)
    still bumps the wrapper's counter, which the card's gate reads."""
    from ray_lightning_tpu_torch.ops.kernels import rmsnorm
    from ray_lightning_tpu_torch.serve.cli import KernelCalls

    wrapper = rmsnorm.rms_norm_kernel
    before = wrapper.launches
    counts = KernelCalls()
    with counts.active():
        assert rmsnorm.rms_norm_kernel is not wrapper
        rmsnorm.rms_norm_kernel.launches += 1
        x, w = torch.ones(2, 8), torch.ones(8)
        torch.testing.assert_close(rmsnorm.rms_norm_kernel(x, w),
                                   rmsnorm.rms_norm_plain(x, w))
    assert rmsnorm.rms_norm_kernel is wrapper
    assert wrapper.launches == before + 1
    assert counts.calls["rms_norm_kernel"] == 1
