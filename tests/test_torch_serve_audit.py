"""The port's static serving plan (`serve/audit.py`, ``plan --serve``,
``serve llama3-8b``) against the JAX package's, on the CPU.

Every byte term of `serve_memory_summary`, `shared_prefix_plan` and the
``plan --serve`` JSON equals the JAX plan's on the same configurations
(tiny and Llama-3-8B, on the meta device), with one difference by
design: the port's serving model stores its matmul weights and embedding
in ``cfg.dtype`` (bf16 on the card) and its norm gains in f32, where the
JAX plan counts every parameter in its f32 param dtype, so
``params_bytes`` (and the totals built on it) differ by exactly that.
The lanes are named for the port (``paged-kernel``). The terms equal a
CPU engine's live bytes, and ``plan --serve`` keeps the JAX CLI's exit
contract.
"""
from __future__ import annotations

import dataclasses
import json
import re

import jax.numpy as jnp
import pytest
import torch

from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.serve import audit as jaudit
from ray_lightning_tpu.serve.engine import EngineConfig as JaxEngineConfig
from ray_lightning_tpu_torch.models.llama import Llama, LlamaConfig
from ray_lightning_tpu_torch.serve import audit
from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig

GEOMS = {
    "tiny": dict(capacity=4, block_size=4, blocks_per_slot=8,
                 prefill_chunk=4, prefill_batch=2),
    "llama3-8b": dict(capacity=4, block_size=16, blocks_per_slot=256,
                      prefill_chunk=128),
}


def _cfgs(preset, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    if preset == "tiny":
        return LlamaConfig.tiny(dtype=dtype), JaxConfig.tiny(dtype=jdt)
    return (LlamaConfig.llama3_8b(max_seq_len=4096, dtype=dtype),
            JaxConfig.llama3_8b(max_seq_len=4096, dtype=jdt))


def _f32_param_bytes(cfg, tp=1):
    """The JAX plan's weights: every parameter at 4 bytes."""
    model = Llama(dataclasses.replace(cfg, dtype=torch.float32),
                  device="meta")
    specs = dict(audit.serving_param_specs(model))
    return sum(p.numel() * 4 // (tp if "tensor" in specs[n] else 1)
               for n, p in model.named_parameters())


@pytest.mark.parametrize("preset", list(GEOMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tp", [1, 2])
def test_serve_memory_summary_equals_jax(preset, dtype, tp):
    cfg, jcfg = _cfgs(preset, dtype)
    geom = GEOMS[preset]
    for fused in (False, True):
        for fused_prefill in (False, True):
            got = audit.serve_memory_summary(
                cfg, EngineConfig(**geom), device_kind="TPU v5p",
                fused=fused, fused_prefill=fused_prefill, tp=tp)
            want = jaudit.serve_memory_summary(
                jcfg, JaxEngineConfig(**geom), device_kind="TPU v5p",
                fused=fused, fused_prefill=fused_prefill, tp=tp)
            assert set(got) == set(want)
            # the one difference by design: the weights' stored bytes
            assert want["params_bytes"] == _f32_param_bytes(cfg, tp)
            delta = got["params_bytes"] - want["params_bytes"]
            assert delta == 0 if dtype == torch.float32 else delta < 0
            assert got["params_bytes"] == audit.serving_params_bytes(cfg,
                                                                      tp)
            for key, v in want.items():
                if key in ("attention_path", "prefill_attention_path"):
                    assert got[key] == v.replace("pallas", "kernel")
                elif key == "per_device_bytes":
                    assert got[key] - v == delta
                elif key == "fits":
                    assert got[key] == (got["per_device_bytes"]
                                        <= got["budget_bytes"])
                elif key != "params_bytes":
                    assert got[key] == v, key


def test_flagship_lanes_by_shape_on_the_card():
    """Auto lane selection at Llama-3-8B's serving shape: both paged
    kernels, as on the JAX plan; a draft runs the reference lanes."""
    cfg, jcfg = _cfgs("llama3-8b", torch.bfloat16)
    got = audit.serve_memory_summary(cfg, EngineConfig(
        **GEOMS["llama3-8b"]))
    want = jaudit.serve_memory_summary(jcfg, JaxEngineConfig(
        **GEOMS["llama3-8b"]))
    assert got["attention_path"] == got["prefill_attention_path"] == \
        "paged-kernel"
    assert want["attention_path"] == "paged-pallas"
    assert got["budget_bytes"] == int(79 * 1024**3 * 0.9)
    assert got["gathered_view_bytes"] == want["gathered_view_bytes"] == 0
    from ray_lightning_tpu_torch.serve.engine import DraftConfig

    spec = audit.serve_memory_summary(cfg, EngineConfig(
        **GEOMS["llama3-8b"], draft=DraftConfig(k=4)))
    assert spec["attention_path"] == "reference-gather"


@pytest.mark.parametrize("preset", list(GEOMS))
def test_shared_prefix_plan_and_summary_text_equal_jax(preset):
    cfg, jcfg = _cfgs(preset, torch.bfloat16)
    geom = GEOMS[preset]
    for n in (1, 4):
        assert audit.shared_prefix_plan(cfg, EngineConfig(**geom), n) == \
            jaudit.shared_prefix_plan(jcfg, JaxEngineConfig(**geom), n)
    with pytest.raises(ValueError, match="n_streams"):
        audit.shared_prefix_plan(cfg, EngineConfig(**geom), 0)
    # the same table: every number of the JAX text in the port's, in
    # order, but the params line (the stored weights' bytes) and the
    # total built on it
    for fused in (False, True):
        got = audit.serve_memory_summary(cfg, EngineConfig(**geom),
                                         device_kind="TPU v5p",
                                         fused=fused, fused_prefill=fused)
        want = jaudit.serve_memory_summary(jcfg, JaxEngineConfig(**geom),
                                           device_kind="TPU v5p",
                                           fused=fused, fused_prefill=fused)
        got["params_bytes"] = want["params_bytes"]
        got["per_device_bytes"] = want["per_device_bytes"]
        nums = re.compile(r"\d+(?:\.\d+)?")
        assert nums.findall(audit.format_serve_summary(got)) == \
            nums.findall(jaudit.format_serve_summary(want))
        assert ("RETIRED" in audit.format_serve_summary(got)) == fused


@pytest.mark.parametrize("use_kernels", [True, False])
def test_summary_terms_equal_a_cpu_engines_live_bytes(use_kernels):
    """The kernel-tiling tiny model's engine on the CPU (the kernel lanes'
    wrappers run their plain versions): parameters, pool and the carried
    logits are the summary's terms, byte for byte, on either lane."""
    cfg = LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=2,
                      n_kv_heads=1, hidden_dim=256, max_seq_len=128,
                      dtype=torch.float32)
    ecfg = EngineConfig(capacity=4, block_size=8, blocks_per_slot=4,
                        prefill_chunk=4)
    model = Llama(cfg, device="cpu")
    eng = DecodeEngine(model, ecfg, use_kernels=use_kernels, device="cpu")
    s = audit.serve_memory_summary(cfg, ecfg, fused=eng.fused,
                                   fused_prefill=eng.fused_prefill)
    assert s["attention_path"] == eng.attention_path
    assert s["params_bytes"] == sum(p.numel() * p.element_size()
                                    for p in model.parameters())
    assert s["pool_bytes"] == sum(t.numel() * t.element_size()
                                  for t in (eng.pool_k, eng.pool_v))
    assert s["last_logits_bytes"] == \
        eng.last_logits.numel() * eng.last_logits.element_size()


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip()
    return rc, (json.loads(out.splitlines()[-1]) if out.startswith("{")
                else out)


@pytest.mark.parametrize("argv,rc", [
    (["--preset", "tiny", "--seq", "64", "--serve-slots", "2"], 0),
    (["--preset", "llama3-8b", "--seq", "8192", "--serve-slots", "64",
      "--hbm-bytes", str(2 * 1024**3)], 1),
    (["--preset", "llama3-8b", "--seq", "4096", "--serve-slots", "4",
      "--tp", "2"], 0),
    (["--preset", "tiny", "--seq", "64", "--tp", "3"], 2),
    (["--preset", "tiny", "--seq", "64", "--serve-slots", "0"], 2),
], ids=lambda v: " ".join(v) if isinstance(v, list) else str(v))
def test_plan_serve_cli_matches_the_jax_cli(capsys, argv, rc):
    """Exit codes (0 fits, 1 does not, 2 invalid) and the JSON sections
    are the JAX CLI's (both plan the same TPU kind); the prefix and
    speculative blocks price alike. The trace section (the decode-step
    audit on fake tensors) runs on the tiny preset; the 8B cases skip it
    (``--no-trace``), as the JAX side does."""
    from ray_lightning_tpu.__main__ import main as jmain
    from ray_lightning_tpu_torch.__main__ import main as pmain

    args = ["plan", "--serve", *argv, "--device-kind", "TPU v5p",
            "--json"]
    traced = "tiny" in argv
    if not traced:
        args.append("--no-trace")
    got_rc, got = _cli(pmain, args, capsys)
    want_rc, want = _cli(jmain, [*args, "--no-trace"], capsys)
    assert got_rc == want_rc == rc
    assert set(got) - {"trace"} == set(want)
    if rc == 2:
        return
    assert got["fits"] == want["fits"]
    if traced:
        trace = got["trace"]
        assert "trace_error" not in trace, trace
        assert trace["attention_path"] == got["serve"]["attention_path"]
        assert trace["peak_hbm_bytes"] > 0
    else:
        assert "trace" not in got
    assert got["prefix_sharing"] == want["prefix_sharing"]
    assert got["serve"]["pool_bytes"] == want["serve"]["pool_bytes"]
    for key in ("verify_step_flops", "k", "expected_tokens_per_tick",
                "draft_pool_bytes"):
        assert got["speculative"][key] == want["speculative"][key], key
    _, text = _cli(pmain, [a for a in args if a != "--json"], capsys)
    assert "serve plan:" in text
    assert ("tracecheck" in text) == traced


def test_serve_llama3_8b_prints_the_plan(capsys):
    from ray_lightning_tpu_torch.__main__ import main

    rc, out = _cli(main, ["serve", "llama3-8b", "--json"], capsys)
    assert rc == 0 and out["preset"] == "llama3-8b"
    assert out["plan"]["fits"] is True
    assert out["plan"]["attention_path"] == "paged-kernel"
    audit = out["audit"]  # the flagship's kernel lanes, traced
    assert audit["attention_path"] == "paged-kernel"
    assert set(audit["kernels"]) >= {"rltt.paged_decode",
                                     "rltt.paged_prefill", "rltt.rms_norm"}
    assert not {f["rule"] for f in audit["findings"]} & {"RLT307",
                                                         "RLT308"}
    rc, text = _cli(main, ["serve", "llama3-8b", "--slots", "256",
                           "--seq-budget", "8192"], capsys)
    assert rc == 1 and "DOES NOT FIT" in text
