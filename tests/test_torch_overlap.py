"""The port's collective-overlap schedule (``FSDP(overlap=)``,
`pipeline/collective_overlap.py`) and the ``perf`` CLI, against
`tests/test_overlap.py`.

Two gloo processes fit the tiny Llama under ``FSDP(overlap="on")``,
``"serial"`` and ``"off"``: prefetching moves when the all-gathers are
issued, never a value, so the three agree bitwise, and ``"on"`` agrees
with the JAX ``FSDP(num_workers=2, overlap="on")`` fit at the tolerance
of tests/test_torch_fit_distributed.py. The schedule itself is read
back from the units' prefetch lists (the port's stand-in for the JAX
package's tracecheck proof, which waits for ROADMAP Queue 1 item 13);
`DataParallel` accepts the knob and changes nothing; the throttled
interleave beats serial; ``python -m ray_lightning_tpu_torch perf
--smoke --device cpu`` exits 0 with the JAX CLI's keys.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_lightning_tpu.parallel.strategy import DataParallel as JaxDP
from ray_lightning_tpu.parallel.strategy import FSDP as JaxFSDP
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import LlamaConfig, params_from_jax
from ray_lightning_tpu_torch.pipeline import collective_overlap as co
from ray_lightning_tpu_torch.pipeline.overlap import measure_prefetch_overlap
from tests import torch_jobs
from tests.test_torch_fit_distributed import (
    _case,
    _close,
    _global_batches,
    _jax_fit,
    _port_fit,
)

CASE = "fused_clip_unequal_masks"
_RUNS = {}


def _fsdp(overlap, tmp_path):
    """The two-process FSDP fit of CASE under ``overlap`` (cached)."""
    if overlap not in _RUNS:
        _, params, toks, mask, cfg_kw, clip = _case(CASE)
        _RUNS[overlap] = _port_fit(
            "fsdp", params, toks, mask, cfg_kw, clip, tmp_path / overlap,
            trainer_kw={"overlap": overlap})
    return _RUNS[overlap]


def test_fsdp_overlap_schedules_are_bitwise_equal(tmp_path):
    rows_off, res_off = _fsdp("off", tmp_path)
    assert len(rows_off) == 4
    for overlap in ("on", "serial"):
        rows, res = _fsdp(overlap, tmp_path)
        assert rows == rows_off, overlap
        assert set(res.state_dict) == set(res_off.state_dict)
        for k, v in res_off.state_dict.items():
            assert torch.equal(res.state_dict[k], v), (overlap, k)


def test_fsdp_overlap_on_matches_jax(tmp_path):
    """``"on"`` against the JAX package's FSDP(num_workers=2,
    overlap="on") fit of the same weights and global batches: rows at
    2e-5, weights at 2e-5 plus the JAX pair's (overlapped FSDP and
    DataParallel) own spread."""
    jcfg, params, toks, mask, _, clip = _case(CASE)
    batches = _global_batches(toks, mask)
    pcfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
    runs = {}
    for name, cls in (("fsdp_on", lambda num_workers: JaxFSDP(
            num_workers=num_workers, overlap="on")), ("ddp", JaxDP)):
        jrows, jparams = _jax_fit(jcfg, params, batches, clip, cls)
        runs[name] = (jrows, params_from_jax(jparams, pcfg,
                                             dtype=torch.float32))
    spread = {k: (runs["ddp"][1][k] - runs["fsdp_on"][1][k]).abs()
              for k in runs["ddp"][1]}
    rows, res = _fsdp("on", tmp_path)
    jrows, want = runs["fsdp_on"]
    np.testing.assert_allclose(rows, jrows, rtol=2e-5, atol=2e-5)
    assert max(g for _, g in rows) > clip  # the clip bites
    _close(res.state_dict, want, "against JAX overlap=on", spread)


def test_overlap_prefetch_lists():
    """The schedule read back from the units: under "on" unit i's forward
    list names unit i+1 and its backward list unit i-1; under "serial"
    no forward list names anything and each backward list names only
    its own unit (which turns FSDP2's implicit backward prefetch off);
    "off" sets nothing."""
    check = co.check_overlap_schedule(device="cpu")
    n = check["units"]
    assert n == 4
    assert check["forward_on"] == [[i + 1] for i in range(n - 1)] + [[]]
    assert check["backward_on"] == [[]] + [[i - 1] for i in range(1, n)]
    assert check["forward_serial"] == [[]] * n
    assert check["backward_serial"] == [[i] for i in range(n)]
    assert check["scheduled"] and not check["serial_scheduled"]
    assert not check["off_scheduled"]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("overlap", ["on", "serial"])
def test_ddp_overlap_is_accepted_and_changes_nothing(overlap):
    """DDP's gradient buckets already overlap with the backward: the
    knob is accepted and the fit is bitwise that of "off" (a difference
    by design from the JAX package, whose data-parallel strategy has no
    such schedule either)."""
    toks = torch_jobs.tokens(8, 12, seed=4)
    out = {}
    for o in ("off", overlap):
        rec = torch_jobs.StepRecorder()
        module = torch_jobs.llama_module(None)
        trainer = Trainer(strategy=torch_jobs.make_strategy("ddp", overlap=o),
                          max_steps=4, log_every_n_steps=1, seed=0,
                          enable_checkpointing=False,
                          enable_progress_bar=False, callbacks=[rec])
        try:
            trainer.fit(module, torch_jobs.llama_data(toks))
            out[o] = (rec.rows, {k: v.detach().clone()
                                 for k, v in module.params.items()})
        finally:
            trainer.strategy.teardown()
    assert out[overlap][0] == out["off"][0] and len(out["off"][0]) == 4
    for k, v in out["off"][1].items():
        assert torch.equal(out[overlap][1][k], v), k


def test_simulate_overlap_schedule_beats_serial():
    """The double-buffered schedule of fake 50 ms gathers against 20 ms
    of real matmuls beats the serial one by at least half its ideal gain
    (the perf CLI's floor). The gather is the longer of the two, so on a
    busy host the overlapped schedule's own costs (a thread a layer, its
    wake-up) hide under it."""
    r = co.simulate_overlap_schedule(n_layers=8, t_comm_s=0.05,
                                     compute_ms_target=20.0, device="cpu")
    assert r["serial_s"] > r["overlapped_s"] > 0
    floor = min(1.15, 1 + 0.5 * (r["ideal_speedup"] - 1))
    assert r["overlap_speedup"] >= floor, r


def test_trace_overlap_schedule_names_its_item():
    """The traced proof (the JAX `trace_overlap_schedule`): tracecheck of
    the tiny Llama's step under overlap "on" carries the prefetch
    fingerprint and no RLT305; under "off" neither fingerprint nor
    hiding, and RLT305 flags the exposed gathers."""
    r = co.trace_overlap_schedule()
    assert r["scheduled"] is True and r["off_scheduled"] is False
    assert r["exposed_findings_on"] == 0 and r["exposed_findings_off"] == 1
    assert r["hidden_fraction_on"] > r["hidden_fraction_off"] == 0.0
    assert [s["scheduled"] for s in r["per_scope_on"]] == [True] * 4


def test_perf_smoke_cli_on_cpu(tmp_path):
    """``perf --smoke --device cpu`` exits 0 and prints one JSON line
    with the JAX CLI's prefetch and interleave keys (its tracecheck
    block replaced by the prefetch-list check). The fake gather is 50
    ms, as in the test above."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "perf", "--smoke",
         "--device", "cpu", "--steps", "24", "--overlap-comm-ms", "50"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_keys = {
        "metric", "value", "unit", "steps", "prefetch_depth",
        "loader_delay_ms", "calibrated_step_ms", "steps_per_sec_sync",
        "steps_per_sec_prefetch", "pipeline_occupancy", "prefetch_wait_s",
        "compile_cold_s", "compile_warm_s", "compile_cache_dir",
        "n_layers", "t_comm_ms", "t_compute_ms", "serial_s", "overlapped_s",
        "overlap_speedup", "ideal_speedup", "overlap_schedule_ok"}
    assert jax_keys <= set(out), jax_keys - set(out)
    assert out["pipeline_occupancy"] > 0 and out["overlap_schedule_ok"]
    assert out["device"] == "cpu"


def test_prefetch_overlap_restores_the_build_dir(tmp_path, monkeypatch):
    """``cache_dir=`` builds the legs' kernels there and gives the
    process-global build directory back afterwards."""
    from ray_lightning_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD", build.BUILD)
    before = build.BUILD
    r = measure_prefetch_overlap(steps=6, batch=16, dim=32, hidden=32,
                                 delay_s=0.002, cache_dir=str(tmp_path),
                                 device="cpu")
    assert build.BUILD == before
    assert r["compile_cache_dir"] == str(tmp_path)
    assert r["steps_per_sec_prefetch"] > 0
