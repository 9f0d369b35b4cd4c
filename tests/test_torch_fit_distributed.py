"""`fit_distributed` of the port in two CPU processes over gloo against
the JAX trainer, mirroring `tests/test_fit_distributed.py` and
`tests/test_dp.py`.

The tiny Llama in f32, with the JAX model's own initial weights
(`params_from_jax`), trains 4 steps under `DataParallel` and `FSDP` in
two worker processes, each on its shard of the data. The JAX
`Trainer(strategy=DataParallel(num_workers=2))` / `FSDP(num_workers=2)`
runs in this process on the virtual CPU mesh, fed the global batches the
two ranks see together (rank 0's rows, then rank 1's: what a JAX
multi-process job assembles). Per-step loss and grad_norm and the final
weights agree at 2e-5, with the fused CE on and off, a clip that bites,
and masks that keep different numbers of tokens on the two ranks (the
loss is the token mean over the global batch). The same port run is held
to the port's own single-process `SingleDevice` run at 2e-5.

The final weights are held at 2e-5 of each tensor's largest entry, plus,
element by element, however far the JAX package's own `DataParallel` and
`FSDP` runs of the same fit lie apart. An Adam update divides by
``sqrt(v) + eps``, so an element whose gradient is near zero (at eps's
scale) turns the rounding of a reduction order into a visible step: in
the masked case the JAX package's two strategies differ by 6.7e-5 on one
element of the embedding. No more elements may go past 2e-5 than go past
it between the JAX package's two runs.

Then: a two-process FSDP fit resumed from its step-2 checkpoint trains
the uninterrupted fit's steps 3-4 exactly; and the reference's canonical
matrix (train with checkpoints, validate and predict from the best one,
load it in the driver) on the MNIST classifier.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import DataParallel as JaxDP
from ray_lightning_tpu.parallel.strategy import FSDP as JaxFSDP
from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
from ray_lightning_tpu_torch.checkpoint.io import read_meta
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import LlamaConfig, params_from_jax
from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.runtime import fit as fit_mod
from ray_lightning_tpu_torch.runtime import fit_distributed
from tests import torch_jobs

T = 180  # seconds one distributed run may take before the test fails
N, S, B = 16, 12, 2  # rows, sequence, per-rank batch: 4 steps

#: name: (fused_ce, remat, gradient_clip_val, unequal masks)
CASES = {
    "fused_clip_unequal_masks": (True, True, 0.5, True),
    "materialized_unmasked": (False, False, None, False),
}


def _case(name):
    fused, remat, clip, masked = CASES[name]
    jcfg = JaxConfig(**torch_jobs.TINY, dtype=jnp.float32, remat=False,
                     fused_ce=fused, ce_chunk_tokens=16)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    toks = torch_jobs.tokens(N, S, seed=4)
    mask = None
    if masked:
        mask = (np.random.default_rng(6).random((N, S)) > 0.1).astype(
            np.float32)
        mask[N // 2:, 4:] = 0.0  # rank 1 keeps a third of its tokens
    return jcfg, params, toks, mask, dict(fused_ce=fused, remat=remat,
                                          ce_chunk_tokens=16), clip


def _global_batches(toks, mask):
    """Step k's global batch: rank 0's rows of it, then rank 1's (the
    port's loader gives rank r the contiguous half r)."""
    half = N // 2
    out = []
    for k in range(half // B):
        rows = np.r_[k * B:(k + 1) * B, half + k * B:half + (k + 1) * B]
        batch = {"tokens": toks[rows]}
        if mask is not None:
            batch["mask"] = mask[rows]
        out.append(batch)
    return out


class _JaxRecorder(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def _jax_fit(jcfg, params, batches, clip, strategy_cls):
    rec = _JaxRecorder()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=4)
    jm.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=strategy_cls(num_workers=2), callbacks=[rec],
               max_steps=4, log_every_n_steps=1, gradient_clip_val=clip,
               enable_checkpointing=False, enable_progress_bar=False,
               seed=0).fit(jm, [dict(b) for b in batches])
    return rec.rows, jax.tree.map(np.asarray, jm.params)


def _port_fit(strategy, params, toks, mask, cfg_kw, clip, tmp_path, **kw):
    rows = []

    def collect(rank, item):
        assert rank == 0 and item[0] == "row"
        rows.append(item[2:])

    res = fit_distributed(
        functools.partial(torch_jobs.llama_module, params, **cfg_kw),
        functools.partial(torch_jobs.trainer, strategy=strategy, clip=clip,
                          **kw.pop("trainer_kw", {})),
        functools.partial(torch_jobs.llama_data, toks, mask, B), 2,
        device="cpu", on_queue_item=collect, timeout=T,
        log_dir=str(tmp_path / "logs"), **kw)
    return rows, res


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, what, spread=None):
    """``got`` against ``want`` at 2e-5 of each tensor's largest entry
    and 2e-5 of each element (`assert_allclose`'s atol and rtol), plus
    ``spread`` (the reference's own spread) element by element."""
    past = past_ref = 0
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        tol = 2e-5 * (max(float(np.abs(w).max()), 1e-6) + np.abs(w))
        extra = 0.0 if spread is None else _np(spread[k])
        assert np.all(np.abs(g - w) <= tol + extra), (
            f"{what}: {k} max diff {float(np.abs(g - w).max())}")
        past += int(np.sum(np.abs(g - w) > tol))
        past_ref += int(np.sum(extra > tol))
    assert past <= past_ref, f"{what}: {past} elements past 2e-5"


_JAX = {}


def _jax_runs(case):
    """The JAX package's DataParallel and FSDP fits of ``case`` (rows,
    port-layout weights), and their elementwise spread."""
    if case not in _JAX:
        jcfg, params, toks, mask, _, clip = _case(case)
        batches = _global_batches(toks, mask)
        pcfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
        runs = {}
        for name, cls in (("ddp", JaxDP), ("fsdp", JaxFSDP)):
            rows, jparams = _jax_fit(jcfg, params, batches, clip, cls)
            runs[name] = (rows, params_from_jax(jparams, pcfg,
                                                dtype=torch.float32))
        spread = {k: (runs["ddp"][1][k] - runs["fsdp"][1][k]).abs()
                  for k in runs["ddp"][1]}
        _JAX[case] = (runs, spread)
    return _JAX[case]


#: the uninterrupted two-process FSDP fit of the masked case, shared by
#: the comparison and the resume test
_RUNS = {}


def _fsdp_reference(tmp_path):
    if "fsdp" not in _RUNS:
        _, params, toks, mask, cfg_kw, clip = _case(
            "fused_clip_unequal_masks")
        _RUNS["fsdp"] = _port_fit("fsdp", params, toks, mask, cfg_kw, clip,
                                  tmp_path)
    return _RUNS["fsdp"]


@pytest.mark.parametrize("strategy,case", [
    ("ddp", "fused_clip_unequal_masks"),
    ("fsdp", "fused_clip_unequal_masks"),
    ("fsdp", "materialized_unmasked"),
])
def test_fit_distributed_matches_jax(tmp_path, strategy, case):
    jcfg, params, toks, mask, cfg_kw, clip = _case(case)
    batches = _global_batches(toks, mask)
    if strategy == "fsdp" and case == "fused_clip_unequal_masks":
        rows, res = _fsdp_reference(tmp_path)
    else:
        rows, res = _port_fit(strategy, params, toks, mask, cfg_kw, clip,
                              tmp_path)
    runs, spread = _jax_runs(case)
    jrows, want = runs[strategy]
    assert len(rows) == 4
    np.testing.assert_allclose(rows, jrows, rtol=2e-5, atol=2e-5)
    if clip:
        assert max(g for _, g in rows) > clip  # the clip bites
    assert set(res.state_dict) == set(want)
    _close(res.state_dict, want, "against JAX", spread)
    assert res.metrics["loss"] == pytest.approx(rows[-1][0], abs=0)

    # the port's own single-process run on the global batches
    rec = torch_jobs.StepRecorder()
    single = torch_jobs.llama_module(params, **cfg_kw)
    Trainer(strategy=SingleDevice(device="cpu"), max_steps=4,
            gradient_clip_val=clip, log_every_n_steps=1, seed=0,
            enable_checkpointing=False, enable_progress_bar=False,
            callbacks=[rec]).fit(single, batches)
    np.testing.assert_allclose(rows, rec.rows, rtol=2e-5, atol=2e-5)
    _close(res.state_dict, single.params, "against SingleDevice")


def test_fsdp_resume_across_processes(tmp_path):
    """Two processes under FSDP save at step 2 (each rank its shards) and
    a fresh two-process job resumes from it: steps 3-4 and the final
    weights equal the uninterrupted fit's, bitwise."""
    want_rows, want = _fsdp_reference(tmp_path)
    _, params, toks, mask, cfg_kw, clip = _case("fused_clip_unequal_masks")
    ckdir = str(tmp_path / "ck")
    first_rows, first = _port_fit(
        "fsdp", params, toks, mask, cfg_kw, clip, tmp_path,
        trainer_kw=dict(max_steps=2, ckpt_dir=ckdir, every_n_train_steps=2),
        return_weights=False)
    path = first.best_model_path
    assert path == os.path.join(ckdir, "step=2") and first_rows == \
        want_rows[:2]
    assert verify_checkpoint(path) == (True, "ok")
    meta = read_meta(path)
    assert meta["mesh_spec"] == {"fsdp": 2}
    assert meta["topology"]["process_count"] == 2
    # each weight sharded on the dimension the JAX rule picks
    assert meta["param_specs"]["lm_head"] == ["fsdp", None]
    assert meta["param_specs"]["layers.0.w_down"] == [None, "fsdp"]
    assert len([f for f in os.listdir(os.path.join(path, "state"))
                if f.endswith(".distcp")]) == 2
    rows, res = _port_fit("fsdp", params, toks, mask, cfg_kw, clip, tmp_path,
                          ckpt_path=path)
    assert rows == want_rows[2:]
    for k, v in want.state_dict.items():
        assert torch.equal(res.state_dict[k], v), k


def test_distributed_train_load_predict_matrix(tmp_path):
    """The reference's canonical matrix over two processes: fit with a
    monitored ModelCheckpoint and EarlyStopping, validate and predict from
    the best checkpoint in fresh jobs, and load it in the driver."""
    ckdir = str(tmp_path / "ck")
    spmd = dict(device="cpu", timeout=T, log_dir=str(tmp_path / "logs"))
    module = torch_jobs.mnist_module()
    res = fit_distributed(torch_jobs.mnist_module,
                          functools.partial(torch_jobs.mnist_trainer, ckdir),
                          torch_jobs.mnist_data, 2, module=module, **spmd)
    assert res.best_model_path.startswith(ckdir)
    assert res.metrics["ptl/val_accuracy"] > 0.9
    # the driver's module was built on the job's device
    assert module.device == torch.device("cpu")
    # the driver's module holds the trained weights (reference
    # ray_ddp.py:190) and runs on them
    logits = module(torch.zeros(2, 64))
    assert logits.shape == (2, 10)
    for k, v in res.state_dict.items():
        assert torch.equal(module.params[k].detach(), v)

    val = fit_mod.validate_distributed(
        torch_jobs.mnist_module, torch_jobs.mnist_trainer,
        torch_jobs.mnist_eval_data, 2, ckpt_path=res.best_model_path,
        **spmd)
    assert val.metrics["ptl/val_accuracy"] > 0.9
    pred = fit_mod.predict_distributed(
        torch_jobs.mnist_module, torch_jobs.mnist_trainer,
        torch_jobs.mnist_eval_data, 2, ckpt_path=res.best_model_path,
        **spmd)
    y = torch_jobs.mnist_eval_data().data["y"]
    # unshuffled contiguous shards: global batch b is rank 0's rows
    # [16b, 16b + 16) then rank 1's [128 + 16b, 128 + 16b + 16)
    order = np.concatenate([np.r_[16 * b:16 * b + 16,
                                  128 + 16 * b:128 + 16 * b + 16]
                            for b in range(8)])
    got = np.concatenate(pred.predictions)
    assert got.shape == (256,)
    assert np.mean(got == y[order]) > 0.9

    loaded = MNISTClassifier.load_from_checkpoint(res.best_model_path,
                                                  device="cpu")
    local = Trainer(strategy=SingleDevice(device="cpu"),
                    enable_checkpointing=False,
                    enable_progress_bar=False).predict(
        loaded, torch_jobs.mnist_eval_data())
    np.testing.assert_array_equal(np.concatenate(local)[order], got)
