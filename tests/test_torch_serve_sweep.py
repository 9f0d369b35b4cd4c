"""The paged kernels' block-size autotune (`serve/sweep.py`, ``serve
--autotune``) against the JAX package's `serve/sweep.py`, on the CPU.

The candidate grid, the model fingerprint, the artifact's format and
`apply_autotune` (its geometry and its refusals) are the JAX sweep's on
the same inputs; each package reads the other's artifact. On the CPU the
wrappers run their plain versions, held against the gathered reference
within the JAX sweep's 2e-5, and every entry says why it was not timed.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import pytest
import torch

from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.serve import sweep as jsweep
from ray_lightning_tpu.serve.engine import EngineConfig as JaxEngineConfig
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.serve import sweep
from ray_lightning_tpu_torch.serve.engine import EngineConfig

TILE = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
            hidden_dim=256, max_seq_len=128, remat=False)
GEOMS = [dict(capacity=4, block_size=16, blocks_per_slot=8,
              prefill_chunk=32),
         dict(capacity=2, block_size=8, blocks_per_slot=12,
              prefill_chunk=16),
         dict(capacity=4, block_size=12, blocks_per_slot=4,
              prefill_chunk=8),
         dict(capacity=4, block_size=16, blocks_per_slot=256,
              prefill_chunk=128)]


@pytest.mark.parametrize("geom", GEOMS,
                         ids=lambda g: f"P{g['block_size']}"
                                       f"xM{g['blocks_per_slot']}")
@pytest.mark.parametrize("sizes", [None, (4, 8, 24, 48, 96)])
def test_candidate_grid_equals_jax(geom, sizes):
    got = sweep.candidate_grid(EngineConfig(**geom), sizes)
    want = jsweep.candidate_grid(JaxEngineConfig(**geom), sizes)
    assert [(c.block_size, c.blocks_per_slot, c.span) for c in got] == \
        [(c.block_size, c.blocks_per_slot, c.span) for c in want]


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_model_fingerprint_equals_jax(dtype, jdtype):
    assert sweep.model_fingerprint(LlamaConfig.llama3_8b(dtype=dtype)) == \
        jsweep.model_fingerprint(JaxConfig.llama3_8b(dtype=jdtype))


@pytest.fixture(scope="module")
def artifact():
    cfg = LlamaConfig(**TILE, dtype=torch.float32)
    return sweep.sweep_paged_kernels(cfg, EngineConfig(**GEOMS[0]),
                                     device="cpu")


def test_cpu_sweep_checks_every_candidate_untimed(artifact):
    assert artifact["device"] == "cpu"
    assert [r["block_size"] for r in artifact["results"]] == \
        [8, 16, 32, 64, 128]
    for r in artifact["results"]:
        for cell in (r["decode"], r["prefill"], r["shared_spec"],
                     r["shared_spec"]["verify_chunk"]):
            assert cell["ok"] and cell["max_err"] < sweep.F32_ATOL
        assert "card only" in r["timing"]["skipped"]
    assert artifact["winner"] == {"block_size": 16, "blocks_per_slot": 8}
    assert artifact["winner_source"] == "default-untimed"


def test_a_broken_kernel_fails_its_cell(monkeypatch):
    """The correctness case is not vacuous: a decode that drops the last
    visible position fails the decode and shared cells, and no candidate
    wins."""
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as pa

    plain = pa.paged_attention_plain

    def dropped(q, pool_k, pool_v, tables, lengths, pad=None, scale=None):
        return plain(q, pool_k, pool_v, tables, (lengths - 1).clamp_min(1),
                     pad=pad, scale=scale)

    monkeypatch.setattr(pa, "paged_attention_plain", dropped)
    cfg = LlamaConfig(**TILE, dtype=torch.float32)
    out = sweep.sweep_paged_kernels(cfg, EngineConfig(**GEOMS[0]),
                                    block_sizes=(16,), device="cpu")
    (r,) = out["results"]
    assert not r["decode"]["ok"] and not r["shared_spec"]["ok"]
    assert r["prefill"]["ok"]
    assert out["winner"] is None


def test_artifact_round_trips_and_crosses_packages(artifact, tmp_path):
    """Each package reads the other's artifact, and `apply_autotune`
    gives the same geometry in both, with the same refusals."""
    cfg = LlamaConfig(**TILE, dtype=torch.float32)
    jcfg = JaxConfig(**TILE, dtype=jnp.float32)
    path = str(tmp_path / "a.json")
    sweep.save_artifact(artifact, path)
    assert sweep.load_artifact(path) == json.loads(json.dumps(artifact))
    jart = jsweep.load_artifact(path)
    won = dict(artifact, winner={"block_size": 32, "blocks_per_slot": 4})
    ecfg, jecfg = EngineConfig(**GEOMS[0]), JaxEngineConfig(**GEOMS[0])
    got = sweep.apply_autotune(ecfg, won, model_cfg=cfg)
    want = jsweep.apply_autotune(jecfg, won, model_cfg=jcfg)
    assert (got.block_size, got.blocks_per_slot) == \
        (want.block_size, want.blocks_per_slot) == (32, 4)
    assert sweep.apply_autotune(ecfg, jart).block_size == 16
    # an artifact the JAX sweep writes is read by the port
    jpath = str(tmp_path / "j.json")
    jsweep.save_artifact(dict(jart, backend="cpu"), jpath)
    assert sweep.load_artifact(jpath)["winner"] == artifact["winner"]
    for bad, match in (
            (dict(artifact, winner=None), "no winner"),
            (dict(artifact, span=64), "span"),
            (dict(artifact, model="L9-H1-KV1-hd64-float32"),
             "swept for model")):
        for fn, e, m in ((sweep.apply_autotune, ecfg, cfg),
                         (jsweep.apply_autotune, jecfg, jcfg)):
            with pytest.raises(ValueError, match=match):
                fn(e, bad, model_cfg=m)
    (tmp_path / "x.json").write_text(json.dumps({"kind": "other"}))
    for load in (sweep.load_artifact, jsweep.load_artifact):
        with pytest.raises(ValueError, match="not a paged-kernel"):
            load(str(tmp_path / "x.json"))


def test_serve_autotune_cli_on_the_cpu(tmp_path, capsys):
    """``serve --autotune`` writes an artifact whose every entry says why
    it was not timed; the incumbent wins, untimed."""
    from ray_lightning_tpu_torch.__main__ import main

    out = str(tmp_path / "tune.json")
    assert main(["serve", "--autotune", out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "winner (default-untimed)" in text
    art = sweep.load_artifact(out)
    assert art["model"] == "L2-H2-KV1-hd64-float32"
    assert all("skipped" in r["timing"] for r in art["results"])
    assert sweep.apply_autotune(
        EngineConfig(capacity=4, block_size=16, blocks_per_slot=8,
                     prefill_chunk=32), art).block_size == 16
