"""The planner (`parallel/plan.py`) and the `plan` CLI against the JAX
package's (`tests/test_llama8b_plan.py`, less its AOT compile), on the
CPU.

The 8B's parameter and optimizer bytes equal the JAX planner's on the
same mesh where the placements agree; where FSDP2 shards a leaf the JAX
rule replicates, they differ by that leaf's bytes x (1 - 1/fsdp), which
the test computes. The optimizer's scalars differ by design: the fused
AdamW keeps an f32 ``step`` a parameter, optax a few counters. Then the
plan against the live bytes of a wrapped model after its optimizer's
steps, in two gloo processes under `FSDP` and four under
`ShardedMesh(fsdp=2, tensor=2)`.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxModule
from ray_lightning_tpu.parallel import plan as jplan
from ray_lightning_tpu.parallel.strategy import ShardedMesh as JaxSharded
from ray_lightning_tpu.parallel.strategy import (
    fsdp_auto_spec as jax_fsdp_auto_spec,
)
from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
from ray_lightning_tpu_torch.parallel import plan
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.parallel.strategy import (
    FSDP,
    DataParallel,
    ShardedMesh,
    SingleDevice,
)
from ray_lightning_tpu_torch.runtime import fit_distributed
from tests import torch_jobs

GIB = 1024**3
T = 180


def _cfg_8b(**kw):
    return LlamaConfig.llama3_8b(**{**dict(remat=True, fused_ce=True), **kw})


def _jcfg_8b(**kw):
    return JaxConfig.llama3_8b(**{**dict(remat=True, scan_layers=True,
                                         fused_ce=True), **kw})


def _batch(batch, seq):
    return {"tokens": np.zeros((batch, seq + 1), np.int32)}


def _jax_plan(cfg, n, **mesh):
    return jplan.plan_train_memory(
        JaxModule(cfg), JaxSharded(**mesh), n_devices=n,
        example_batch=_batch(n, 256), device_kind="TPU v5p")


def _port_plan(cfg, n, **mesh):
    return plan.plan_train_memory(
        LlamaModule(cfg), ShardedMesh(**mesh), n_devices=n,
        example_batch=None, device_kind="TPU v5p")


def _n_leaves(cfg) -> int:
    return 3 + cfg.n_layers * 6


def _jax_scalars(p) -> int:
    """optax's counters: what the JAX optimizer holds beyond mu and nu."""
    return p.opt_bytes_global - 2 * p.params_bytes_global


def test_hbm_table_and_override():
    """The TPU rows are the JAX table's; the card's row is the H100's and
    lies under the 85,017,755,648 bytes its ``total_memory`` reports; an
    unknown kind errors listing the known ones; the override plans
    hardware the table doesn't know."""
    for kind, nbytes in jplan.HBM_BYTES_BY_KIND.items():
        assert plan.hbm_bytes_for_kind(kind) == nbytes
    assert plan.hbm_bytes_for_kind(plan.H100_KIND) == 79 * GIB
    assert plan.hbm_bytes_for_kind(plan.H100_KIND) <= 85_017_755_648
    with pytest.raises(ValueError, match="known"):
        plan.hbm_bytes_for_kind("TPU v99")
    with pytest.raises(ValueError, match="positive"):
        plan.hbm_bytes_for_kind("TPU v99", hbm_bytes=0)
    assert plan.hbm_bytes_for_kind("TPU v99", 7 * GIB) == 7 * GIB
    p = plan.plan_train_memory(
        LlamaModule(LlamaConfig.tiny()), ShardedMesh(fsdp=8), n_devices=8,
        example_batch=_batch(8, 256), device_kind="research-chip-x1",
        hbm_bytes_per_device=8 * GIB)
    assert p.hbm_bytes_per_device == 8 * GIB and p.fits


@pytest.mark.parametrize("mesh", [dict(fsdp=64), dict(tensor=8),
                                  dict(fsdp=4, tensor=2), dict(data=8)],
                         ids=str)
def test_8b_bytes_equal_jax(mesh):
    """Llama-3-8B: per-device and global parameter bytes equal the JAX
    planner's (every leaf of the 8B divides, so FSDP2 and the JAX rule
    place it alike), and the moments equal mu and nu; the scalars are
    each optimizer's own."""
    n = int(np.prod(list(mesh.values())))
    cfg = _cfg_8b(max_seq_len=8192)
    p = _port_plan(cfg, n, **mesh)
    j = _jax_plan(_jcfg_8b(max_seq_len=8192), n, **mesh)
    assert p.params_bytes_global == j.params_bytes_global
    assert p.params_bytes_per_device == j.params_bytes_per_device
    assert p.grads_bytes_per_device == j.grads_bytes_per_device
    assert p.opt_bytes_per_device - 4 * _n_leaves(cfg) == \
        j.opt_bytes_per_device - _jax_scalars(j)
    assert p.opt_bytes_global - 4 * _n_leaves(cfg) == \
        j.opt_bytes_global - _jax_scalars(j)
    assert 7.9e9 < p.params_bytes_global / 4 < 8.1e9


def test_fsdp2_shards_what_jax_replicates():
    """The tiny model at fsdp=8: the norm gains (64 elements, under the
    JAX rule's 1024) are replicated by JAX and sharded on dim 0 by FSDP2;
    the plans differ by exactly those leaves' bytes x (1 - 1/8)."""
    cfg = LlamaConfig.tiny()
    jcfg = JaxConfig.tiny(remat=True, scan_layers=True, fused_ce=True)
    p = plan.plan_train_memory(LlamaModule(cfg), FSDP(), 8, None)
    j = jplan.plan_train_memory(JaxModule(jcfg), JaxSharded(fsdp=8), 8,
                                _batch(8, 64), device_kind="TPU v5p")
    module = LlamaModule(cfg)
    module.device = torch.device("meta")
    module.setup()
    replicated = [p_ for p_ in module.model.parameters()
                  if "fsdp" not in jax_fsdp_auto_spec(tuple(p_.shape), 8,
                                                      2**10)]
    assert replicated and all(p_.dim() == 1 for p_ in replicated)
    extra = sum(p_.numel() * 4 for p_ in replicated)
    assert j.params_bytes_per_device - p.params_bytes_per_device == \
        extra - extra // 8
    assert p.params_bytes_global == j.params_bytes_global


def test_8b_fits_64_cards_and_refuses_8_small_ones():
    cfg = _cfg_8b(max_seq_len=8192)
    fits = plan.plan_train_memory(
        LlamaModule(cfg), ShardedMesh(fsdp=64), n_devices=64,
        example_batch=None,
        activation_bytes_per_device=plan.llama_activation_bytes(cfg, 1,
                                                                8192))
    assert fits.fits, fits.summary()
    assert fits.params_bytes_per_device < fits.params_bytes_global / 48
    small = plan.plan_train_memory(
        LlamaModule(cfg), ShardedMesh(fsdp=8), n_devices=8,
        example_batch=None,
        activation_bytes_per_device=plan.llama_activation_bytes(cfg, 1,
                                                                8192),
        device_kind="TPU v5e")
    assert not small.fits, small.summary()
    # the whole 8B on one card does not fit either (128 GB of f32
    # masters, moments and gradients)
    one = plan.plan_train_memory(LlamaModule(cfg), SingleDevice(), 1, None)
    assert not one.fits


def test_tensor_split_is_honoured():
    """A tensor=8 mesh splits every matmul weight and the vocabulary
    8 ways (the gains stay whole); pure data parallelism replicates."""
    cfg = _cfg_8b(max_seq_len=2048)
    t = plan.plan_train_memory(LlamaModule(cfg), ShardedMesh(tensor=8), 8,
                               None)
    r = plan.plan_train_memory(LlamaModule(cfg), ShardedMesh(data=8), 8,
                               None)
    assert r.params_bytes_per_device == r.params_bytes_global
    gains = (2 * cfg.n_layers + 1) * cfg.dim * 4
    assert t.params_bytes_per_device == \
        (t.params_bytes_global - gains) // 8 + gains


def test_input_errors_match_jax():
    cfg = LlamaConfig.tiny()
    with pytest.raises(ValueError, match="hbm_bytes_per_device"):
        plan.plan_train_memory(LlamaModule(cfg), ShardedMesh(fsdp=8), 8,
                               None, device_kind="TPU v99")
    assert plan.dp_degree(MeshSpec(data=2, fsdp=4, tensor=2)) == 8
    with pytest.raises(ValueError, match="resolved"):
        plan.dp_degree(MeshSpec(fsdp=-1))
    with pytest.raises(ValueError, match="tensor=3 does not divide "
                                         "n_kv_heads"):
        plan.plan_train_memory(LlamaModule(cfg), ShardedMesh(tensor=3), 3,
                               None)


def test_planner_touches_no_card_and_no_group():
    """The twin of the JAX planner's no-backend contract, in a fresh
    interpreter: nothing on the card, no process group, a meta model."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch, torch.distributed as dist\n"
        "from ray_lightning_tpu_torch.models.llama import LlamaConfig, "
        "LlamaModule\n"
        "from ray_lightning_tpu_torch.parallel.plan import "
        "plan_train_memory\n"
        "from ray_lightning_tpu_torch.parallel.strategy import "
        "ShardedMesh\n"
        "m = LlamaModule(LlamaConfig.tiny(remat=True, fused_ce=True))\n"
        "p = plan_train_memory(m, ShardedMesh(fsdp=2, tensor=2), 4, None)\n"
        "assert p.fits\n"
        "assert not torch.cuda.is_initialized(), 'the card was touched'\n"
        "assert not dist.is_initialized(), 'a group was started'\n"
        "assert all(t.device.type == 'meta' for t in "
        "m.model.parameters())\n"
        "print('NO-CARD-OK')\n")
    env = {**os.environ,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO-CARD-OK" in out.stdout


@pytest.mark.parametrize("case", ["base", "attn_out", "attn_out_f32",
                                  "no_remat", "inline_ce"])
@pytest.mark.parametrize("batch,seq,degree", [(1, 8192, 1), (4, 2048, 64)])
def test_activation_bound_equals_jax(case, batch, seq, degree):
    import jax.numpy as jnp

    kw = {"base": {}, "attn_out": dict(remat_policy="attn_out"),
          "attn_out_f32": dict(remat_policy="attn_out"),
          "no_remat": dict(remat=False, remat_policy="attn_out"),
          "inline_ce": dict(ce_inline_bwd=True)}[case]
    pdt = torch.float32 if case == "attn_out_f32" else torch.bfloat16
    jdt = jnp.float32 if case == "attn_out_f32" else jnp.bfloat16
    want = jplan.llama_activation_bytes(
        _jcfg_8b(dtype=jdt, **kw), batch, seq, weight_shard_degree=degree)
    got = plan.llama_activation_bytes(
        _cfg_8b(dtype=pdt, **kw), batch, seq, weight_shard_degree=degree)
    assert got == want


@pytest.mark.parametrize("mode", ["off", "on", "serial"])
@pytest.mark.parametrize("fsdp,tensor", [(1, 1), (8, 1), (4, 2), (64, 1)])
def test_overlap_buffers_are_jax_less_the_rolled_copy(mode, fsdp, tensor):
    """FSDP2's prefetch holds JAX's charge less the rolled copy of the
    stacked layers (a scan artifact the port has no twin of)."""
    cfg = _cfg_8b()
    want = jplan.llama_overlap_buffer_bytes(_jcfg_8b(), fsdp, tensor, mode)
    got = plan.llama_overlap_buffer_bytes(cfg, fsdp, tensor, mode)
    rolled = 0
    if mode == "on" and fsdp > 1:
        d, f, hd = cfg.dim, cfg.hidden_dim, cfg.head_dim
        layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * d + 3 * d * f + 2 * d) * 4
        rolled = cfg.n_layers * (layer // (fsdp * tensor))
    assert got == want - rolled


def test_find_max_local_batch_cases():
    """The exact boundary (a non-power-of-2 optimum), no fit at all, and
    the ceiling, as the JAX tests pin them."""
    cfg = LlamaConfig.tiny()
    per = 64 * 1024**2
    local, p = plan.find_max_local_batch(
        LlamaModule(cfg), ShardedMesh(data=8), 8, None, lambda b: b * per,
        device_kind="TPU v5e")
    head = p.headroom_bytes + p.activation_bytes_per_device
    assert local * per <= head < (local + 1) * per
    assert p.activation_bytes_per_device == local * per and p.fits
    assert local not in (0, 1)
    jlocal, _ = jplan.find_max_local_batch(
        JaxModule(JaxConfig.tiny()), JaxSharded(data=8), 8, _batch(8, 64),
        lambda b: b * per, device_kind="TPU v5e")
    # the port's optimizer scalars differ by a few bytes: the same batch
    assert local == jlocal
    zero, p0 = plan.find_max_local_batch(
        LlamaModule(cfg), SingleDevice(), 1, None, lambda b: 10**15)
    assert zero == 0 and p0.activation_bytes_per_device == 0
    top, _ = plan.find_max_local_batch(
        LlamaModule(cfg), SingleDevice(), 1, None, lambda b: 0, ceiling=100)
    assert top == 100


def test_find_max_batch_on_the_card():
    """Phase 5's model (8B width, 4 layers) at S 2048 on one H100: the
    batch `chip_smoke.py` phase 12 (b) trains."""
    cfg = LlamaConfig.llama3_8b(n_layers=4, max_seq_len=2048)
    local, p = plan.find_max_local_batch(
        LlamaModule(cfg), SingleDevice(), 1, None,
        lambda b: plan.llama_activation_bytes(cfg, b, 2048))
    assert local == 50 and p.fits
    assert p.params_bytes_per_device == 7692500992
    assert p.opt_bytes_per_device == 2 * 7692500992 + 4 * (3 + 4 * 6)


@pytest.mark.parametrize("sizes,slices", [
    (dict(data=4, fsdp=2), 2), (dict(data=2, fsdp=2, tensor=2), 2),
    (dict(fsdp=8), 2), (dict(data=8), 4), (dict(fsdp=4, tensor=2), 1)],
    ids=str)
def test_dcn_queries_equal_jax(sizes, slices):
    assert plan.dcn_crossing_axes(sizes, slices) == \
        jplan.dcn_crossing_axes(sizes, slices)
    for axes in (("data",), ("fsdp",), ("tensor",), ("data", "fsdp")):
        assert plan.group_dcn_span(axes, sizes, slices) == \
            jplan.group_dcn_span(axes, sizes, slices)


@pytest.mark.parametrize("strategy,sizes,n", [
    ("fsdp", {}, 2), ("sharded", dict(fsdp=2, tensor=2), 4)], ids=str)
def test_plan_equals_live_bytes(tmp_path, strategy, sizes, n):
    """Each rank's parameter storage and optimizer state after the fit's
    steps equal the plan to the byte."""
    live = []
    params = None
    fit_distributed(
        functools.partial(torch_jobs.llama_module, params),
        functools.partial(torch_jobs.trainer, strategy=strategy,
                          extra=("LiveBytes",), max_steps=2, **sizes),
        functools.partial(torch_jobs.llama_data,
                          torch_jobs.tokens(8, 12, seed=1), None, 2), n,
        device="cpu", timeout=T, log_dir=str(tmp_path / "logs"),
        return_weights=False,
        on_queue_item=lambda rank, item: live.append(item)
        if item[0] == "live" else None)
    cfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
    strat = FSDP() if strategy == "fsdp" else ShardedMesh(**sizes)
    p = plan.plan_train_memory(LlamaModule(cfg), strat, n, None)
    assert sorted(r for _, r, _, _ in live) == list(range(n))
    for _, rank, params_bytes, opt_bytes in live:
        assert params_bytes == p.params_bytes_per_device, rank
        assert opt_bytes == p.opt_bytes_per_device, rank


@pytest.mark.parametrize("sizes,cfg_kw", [
    (dict(seq=2), dict(seq_parallel=True)),
    (dict(pipe=2), dict(pipeline_microbatches=2))], ids=str)
def test_plan_equals_live_bytes_on_the_new_axes(tmp_path, sizes, cfg_kw):
    """Under ``ShardedMesh(seq=2)`` every rank holds the whole model,
    under ``ShardedMesh(pipe=2)`` its stage's layers and the replicated
    embedding, norm and head: each rank's bytes after the fit's steps
    equal the plan's (rank 0's; the stages hold equal layers)."""
    live = []
    fit_distributed(
        functools.partial(torch_jobs.llama_module, None, **cfg_kw),
        functools.partial(torch_jobs.trainer, strategy="sharded",
                          extra=("LiveBytes",), max_steps=2, **sizes),
        functools.partial(torch_jobs.llama_data,
                          torch_jobs.tokens(8, 12, seed=1), None, 2), 2,
        device="cpu", timeout=T, log_dir=str(tmp_path / "logs"),
        return_weights=False,
        on_queue_item=lambda rank, item: live.append(item)
        if item[0] == "live" else None)
    cfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32, **cfg_kw)
    p = plan.plan_train_memory(LlamaModule(cfg), ShardedMesh(**sizes), 2,
                               None)
    whole = plan.plan_train_memory(LlamaModule(cfg), SingleDevice(), 1,
                                   None)
    assert sorted(r for _, r, _, _ in live) == [0, 1]
    for _, rank, params_bytes, opt_bytes in live:
        assert params_bytes == p.params_bytes_per_device, rank
        assert opt_bytes == p.opt_bytes_per_device, rank
    if "seq" in sizes:
        assert p.params_bytes_per_device == whole.params_bytes_per_device
    else:
        assert p.params_bytes_per_device < whole.params_bytes_per_device


def test_data_parallel_plan_replicates():
    cfg = LlamaConfig.tiny()
    p = plan.plan_train_memory(LlamaModule(cfg), DataParallel(), 4, None)
    assert p.params_bytes_per_device == p.params_bytes_global
    assert p.mesh_axes == {"data": 4}


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip()
    return rc, (json.loads(out.splitlines()[-1]) if out.startswith("{")
                else out)


@pytest.mark.parametrize("argv,rc", [
    (["--preset", "tiny", "--fsdp", "8", "--batch", "8", "--seq", "128"],
     0),
    (["--preset", "llama3-8b", "--fsdp", "1", "--batch", "64", "--seq",
      "8192"], 1),
    (["--preset", "tiny", "--fsdp", "8", "--batch", "7", "--seq", "128"],
     2),
    (["--preset", "tiny", "--fsdp", "0", "--batch", "8", "--seq", "128"],
     2),
    (["--preset", "tiny", "--fsdp", "8", "--batch", "8", "--seq", "128",
      "--device-kind", "research-chip-x1"], 2),
    (["--preset", "tiny", "--fsdp", "8", "--batch", "8", "--seq", "128",
      "--device-kind", "research-chip-x1", "--hbm-bytes",
      str(8 * GIB)], 0),
    (["--preset", "llama3-8b", "--fsdp", "8", "--seq", "2048",
      "--find-max-batch"], 0),
    (["--preset", "llama3-8b", "--fsdp", "1", "--seq", "2048",
      "--find-max-batch"], 1),
], ids=lambda v: " ".join(v) if isinstance(v, list) else str(v))
def test_plan_cli_matches_the_jax_cli(capsys, argv, rc):
    """Exit codes (0 fits, 1 does not, 2 invalid) and the JSON fields are
    the JAX CLI's; the port's trace section says it is not ported. Both
    plan the same TPU kind, so the verdicts agree."""
    from ray_lightning_tpu.__main__ import main as jmain
    from ray_lightning_tpu_torch.__main__ import main as pmain

    kind = [] if "--device-kind" in argv else ["--device-kind", "TPU v5p"]
    got_rc, got = _cli(pmain, ["plan", *argv, *kind, "--json"], capsys)
    want_rc, want = _cli(jmain, ["plan", *argv, *kind, "--json",
                                 "--no-trace"], capsys)
    assert got_rc == want_rc == rc
    assert set(got) - {"trace"} == set(want)
    if rc != 2:
        assert got["trace"] == {"not_ported": "ROADMAP Queue 1 item 13 "
                                "(analysis/tracecheck.py as a torch.fx "
                                "walk)"}
        assert got["fits"] == want["fits"]
    _, bare = _cli(pmain, ["plan", *argv, *kind, "--json", "--no-trace"],
                   capsys)
    assert "trace" not in bare


@pytest.mark.parametrize("flag,item", [("--mu-bf16", "item 3"),
                                       ("--ce-inline-bwd", "item 3")])
def test_plan_cli_legs_not_ported(capsys, flag, item):
    """The legs item 3 ported give a plan: at fsdp 1 (both packages keep
    every leaf whole) each flag moves the port's bytes as it moves the
    JAX CLI's, byte for byte (the bf16 first moment takes 2 bytes a
    parameter off, the inline CE adds its residuals to the bound), with
    the same verdict; both together too."""
    from ray_lightning_tpu.__main__ import main as jmain
    from ray_lightning_tpu_torch.__main__ import main as pmain

    base = ["plan", "--preset", "llama3-8b", "--fsdp", "1", "--batch", "2",
            "--seq", "2048", "--device-kind", "TPU v5p", "--json",
            "--no-trace"]
    got = {}
    for main in (pmain, jmain):
        for extra in ([], [flag], ["--mu-bf16", "--ce-inline-bwd"]):
            rc, out = _cli(main, base + extra, capsys)
            assert rc == 1 and "not_ported" not in out
            got[main, tuple(extra)] = out["per_device_bytes"]
    for extra in ([flag], ["--mu-bf16", "--ce-inline-bwd"]):
        delta = [got[m, tuple(extra)] - got[m, ()] for m in (pmain, jmain)]
        assert delta[0] == delta[1] != 0, (extra, delta)
    # the tiny preset fits either way
    rc, out = _cli(pmain, ["plan", "--preset", "tiny", flag, "--json"],
                   capsys)
    assert rc == 0 and out["fits"] and item == "item 3"


@pytest.mark.parametrize("policy", ["nothing", "dots", "attn_out"])
def test_plan_cli_remat_policy(capsys, policy):
    """``--remat-policy`` (the port's own flag) charges "attn_out"'s saved
    residuals in the activation bound and nothing for the others, as
    `llama_activation_bytes` does."""
    from ray_lightning_tpu_torch.__main__ import main

    argv = ["plan", "--preset", "llama3-8b", "--fsdp", "1", "--batch", "2",
            "--seq", "2048", "--json", "--no-trace"]
    rc0, base = _cli(main, argv, capsys)
    rc, out = _cli(main, argv + ["--remat-policy", policy], capsys)
    cfg = _cfg_8b(max_seq_len=2048)
    extra = (plan.llama_activation_bytes(
        dataclasses.replace(cfg, remat_policy=policy), 2, 2048)
        - plan.llama_activation_bytes(cfg, 2, 2048))
    assert rc == rc0 == 1
    assert out["per_device_bytes"] - base["per_device_bytes"] == extra
    assert (extra > 0) == (policy == "attn_out")
