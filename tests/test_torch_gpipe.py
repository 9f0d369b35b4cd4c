"""The pipeline axis: GPipe (`ops/pipeline.py`) and the Llama's pipeline
path against the JAX package (`tests/test_pipeline.py`'s cases), on the
CPU.

Over four gloo processes (one group for the whole file,
`tests/torch_axis_jobs.py` `pipe_job`): `gpipe_apply` against the
sequential layers and the JAX `gpipe_apply` at pipe 4 with 2 and 4
microbatches, also over the all-to-all route the card's gloo lanes take;
several layers a stage on a data x pipe mesh; pipe 1 as the plain loop;
the gradients, with and without remat, against `jax.grad` of the
sequential layers; the divisibility errors; the tiny Llama's pipeline
path under ``ShardedMesh(pipe=4)`` against the JAX scan path (loss and
every gradient, with and without the fused CE; tied bf16 at the JAX
test's 2e-2), each stage holding only its own layer; a 2-step fit under
``ShardedMesh(data=2, pipe=2)`` against the JAX fit; the pipelined
classifier trained through the Trainer with its layer stack sharded over
``pipe``. f32, 2e-5 unless stated.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.models.pipelined import (
    PipelinedMLPModule as JaxPipelinedMLP,
)
from ray_lightning_tpu.ops import gpipe_apply as jax_gpipe
from ray_lightning_tpu.parallel.mesh import make_mesh
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.models.llama import (
    params_from_jax as llama_from_jax,
)
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_axis_jobs

T = 240
#: the JAX test's Llama (`tests/test_pipeline.py` `_llama_cfg`)
LLAMA_KW = dict(vocab_size=128, dim=32, n_layers=4, n_heads=2, n_kv_heads=1,
                hidden_dim=64, max_seq_len=64, remat=False)
#: name: (port config, ShardedMesh sizes)
LLAMA = {
    "plain": (dict(LLAMA_KW, pipeline_microbatches=2, fused_ce=False),
              dict(pipe=4)),
    "fused": (dict(LLAMA_KW, pipeline_microbatches=2, fused_ce=True,
                   ce_chunk_tokens=16), dict(pipe=4)),
    "tied_bf16": (dict(LLAMA_KW, pipeline_microbatches=2, fused_ce=False,
                       tie_embeddings=True, dtype=torch.bfloat16),
                  dict(pipe=4)),
}


def _stack(L, d=16, seed=0, batch=8):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((L, d, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((L, d)) * 0.1).astype(np.float32),
            rng.standard_normal((batch, d)).astype(np.float32))


def _jax_cfg(kw):
    kw = {k: v for k, v in kw.items() if k != "pipeline_microbatches"}
    dtype = jnp.bfloat16 if kw.pop("dtype", None) is torch.bfloat16 \
        else jnp.float32
    return JaxConfig(**kw, use_flash=False, dtype=dtype)


def _jax_params(cfg):
    jm = JaxLlamaModule(cfg)
    jm.setup()
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(0), {"tokens": np.zeros((1, 17), np.int32)}))


def _mlp_data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 8)) * 3
    y = rng.integers(0, 4, size=128)
    x = (centers[y] + rng.normal(size=(128, 8)) * 0.1).astype(np.float32)
    return {"x": x, "y": y.astype(np.int32)}


def _inputs():
    data = _mlp_data()
    mlp = JaxPipelinedMLP(d=16, n_layers=4, microbatches=2)
    mlp_params = jax.tree.map(np.asarray, mlp.init_params(
        jax.random.key(0), {"x": data["x"][:2]}))
    rng = np.random.default_rng(5)
    return {
        "stack4": _stack(4), "stack8": _stack(8, seed=2, batch=4),
        "stack3": _stack(3, seed=3),
        "params": {n: _jax_params(_jax_cfg(kw))
                   for n, (kw, _) in LLAMA.items()},
        "llama": LLAMA,
        "tokens": (np.arange(8 * 17, dtype=np.int32).reshape(8, 17) % 128),
        "fit_tokens": rng.integers(0, 128, (16, 17)).astype(np.int32),
        "mlp_data": data, "mlp_params": mlp_params,
    }


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    return inp, launch(torch_axis_jobs.pipe_job, 4, device="cpu",
                       args=(inp,), timeout=T)


def _sequential(params, x):
    def body(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]), None

    return jax.lax.scan(body, x, params)[0]


def _want(w, b, x):
    """The sequential layers' output and the gradients of mean(out**2)
    by JAX."""
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    out = np.asarray(_sequential(params, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, x: (_sequential(p, x) ** 2).mean(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    return out, np.asarray(gp["w"]), np.asarray(gp["b"]), np.asarray(gx)


def _got(ranks, key, n_rows):
    """The output and x's gradient assembled by data rows, the stacked
    weights' gradients summed over the data ranks."""
    out = np.zeros((n_rows,) + ranks[0][key]["out"].shape[1:], np.float32)
    dx = np.zeros_like(out)
    seen, dw, db = set(), 0.0, 0.0
    for r in ranks:
        c = r[key]
        rows = tuple(c["rows"])
        out[list(rows)] = c["out"]
        dx[list(rows)] = c["dx"]
        if rows not in seen:
            seen.add(rows)
            dw, db = dw + c["dw"], db + c["db"]
    return out, dw, db, dx


@pytest.mark.parametrize("case", ["pipe4_m2", "pipe4_m4", "pipe4_all_to_all",
                                  "grads_rematFalse", "grads_rematTrue",
                                  "data2_pipe2_l8", "data4_l3"])
def test_gpipe_matches_sequential(run, case):
    inp, ranks = run
    stack = {"data2_pipe2_l8": "stack8", "data4_l3": "stack3"}.get(
        case, "stack4")
    w, b, x = inp[stack]
    want = _want(w, b, x)
    got = _got(ranks, case, len(x))
    for name, a, e in zip(("out", "dw", "db", "dx"), got, want):
        np.testing.assert_allclose(a, e, rtol=2e-5, atol=1e-6, err_msg=name)
    # every pipe rank of a data row holds the same replicated output
    for r in ranks:
        c = r[case]
        np.testing.assert_array_equal(c["out"], got[0][list(c["rows"])])


def test_gpipe_matches_jax_gpipe(run, devices8):
    inp, ranks = run
    w, b, x = inp["stack4"]
    mesh = make_mesh(data=2, pipe=4, devices=devices8)
    with mesh:
        want = np.asarray(jax_gpipe(
            lambda lp, h: jnp.tanh(h @ lp["w"] + lp["b"]),
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            mesh, microbatches=4))
    np.testing.assert_allclose(_got(ranks, "pipe4_m4", len(x))[0], want,
                               rtol=2e-5, atol=1e-6)


def test_gpipe_validates_divisibility(run):
    _, ranks = run
    layers, batch = ranks[0]["errors"]
    assert layers == "3 layers not divisible by pipe=4"
    assert "per-shard batch 6 not divisible by microbatches=4" in batch


def _jax_scan_loss(cfg, params, toks):
    jm = JaxLlamaModule(cfg)
    jm.setup()
    i, t, m = jm._split({"tokens": jnp.asarray(toks)})
    loss, grads = jax.value_and_grad(lambda p: jm._loss(p, i, t, m))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", ["plain", "fused", "tied_bf16"])
def test_llama_pipeline_matches_scan_path(run, name):
    """The GPipe decoder path trains the same weights as the JAX scan
    path: loss and every gradient (stage-owned layers on their stage,
    the replicated embedding, norm and head on every stage). Tied bf16 is
    held as the JAX test holds it, the loss at 2e-2."""
    inp, ranks = run
    kw, _ = LLAMA[name]
    loss, jgrads = _jax_scan_loss(_jax_cfg(kw), inp["params"][name],
                                  inp["tokens"])
    key = f"llama_{name}"
    if name == "tied_bf16":
        for r in ranks:
            assert r[key]["loss"] == pytest.approx(loss, rel=2e-2)
        return
    want = {k: v.numpy() for k, v in llama_from_jax(
        jgrads, LlamaConfig(**kw, dtype=torch.float32),
        dtype=torch.float32).items()}
    for stage, r in enumerate(ranks):
        got = r[key]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        # each stage holds and trains its own layer alone
        assert got["owned"] == [stage] and got["layers"] == [str(stage)]
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g, want[n], rtol=2e-5,
                                       atol=2e-5 * float(
                                           np.abs(want[n]).max()),
                                       err_msg=n)


class _Rows(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def test_llama_pipeline_fit_matches_jax(run):
    inp, ranks = run
    kw, _ = LLAMA["fused"]
    toks = inp["fit_tokens"]
    rec = _Rows()
    jm = JaxLlamaModule(_jax_cfg(kw), lr=1e-2, warmup_steps=1,
                        total_steps=4)
    jm.params = jax.tree.map(jnp.asarray, inp["params"]["fused"])
    # each data rank's k-th batch of its half, in rank order
    batches = [{"tokens": toks[np.r_[4 * k:4 * k + 4, 8 + 4 * k:12 + 4 * k]]}
               for k in range(2)]
    JaxTrainer(strategy=JaxSingle(), callbacks=[rec], max_steps=2,
               log_every_n_steps=1, enable_checkpointing=False,
               enable_progress_bar=False, seed=0).fit(jm, batches)
    for r in ranks:
        assert r["fit_init_path"] == "eager"
        np.testing.assert_allclose(np.asarray(r["fit_data2_pipe2"]),
                                   np.asarray(rec.rows), rtol=2e-5,
                                   atol=2e-5)


def test_pipelined_classifier_trains_through_trainer(run):
    inp, ranks = run
    data, p = inp["mlp_data"], inp["mlp_params"]
    # step 0's loss: the JAX module's arithmetic on the global first batch
    # (each data rank's first 16 rows of its half)
    rows = np.r_[0:16, 64:80]
    h = data["x"][rows] @ p["inp"]
    for i in range(4):
        h = np.tanh(h @ p["layers"]["w"][i] + p["layers"]["b"][i])
    logits = (h @ p["head"]).astype(np.float64)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = -logp[np.arange(32), data["y"][rows]].mean()
    for r in ranks:
        mlp = r["mlp"]
        assert mlp["rows"][0][0] == pytest.approx(want, rel=2e-5)
        assert mlp["val_acc"] > 0.9
        assert "Shard(dim=0)" in mlp["placements"]
        assert mlp["local_layers"] == 2


def test_llama_pipeline_config_validation():
    """The JAX exclusions: the pipeline and seq_parallel in one config,
    the pipeline path beside the tensor or seq axis, a pipe that does not
    divide the layers, and no pipeline path at all under pipe > 1."""
    from ray_lightning_tpu_torch.models.llama import LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    with pytest.raises(ValueError, match="mutually exclusive"):
        LlamaConfig(**LLAMA_KW, pipeline_microbatches=2, seq_parallel=True)
    module = LlamaModule(LlamaConfig(**LLAMA_KW, pipeline_microbatches=2))
    for sizes, match in ((dict(pipe=2, tensor=2), "data/fsdp only"),
                         (dict(pipe=2, seq=2), "data/fsdp only"),
                         (dict(pipe=3), "not divisible by pipe=3")):
        strategy = ShardedMesh(**sizes, device="cpu")
        strategy.shape_only(math.prod(sizes.values()), module)
        with pytest.raises(ValueError, match=match):
            strategy.bind_module(module)
    strategy = ShardedMesh(pipe=2, device="cpu")
    strategy.shape_only(2, None)
    with pytest.raises(ValueError, match="pipeline_microbatches=M"):
        strategy.bind_module(LlamaModule(LlamaConfig(**LLAMA_KW)))


def test_pipeline_checkpoint_is_canonical_and_crosses_layouts(tmp_path):
    """A ``ShardedMesh(pipe=2)`` fit's DCP checkpoint holds every layer
    under its canonical name (each stage wrote its own), its weights are
    a one-card fit's of the same steps, and a `SingleDevice` fit resumes
    from it."""
    import functools

    from ray_lightning_tpu_torch.checkpoint import load_checkpoint
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.runtime import fit_distributed
    from tests import torch_jobs

    toks = torch_jobs.tokens(8, 16, seed=4)
    kw = dict(fused_ce=True, ce_chunk_tokens=16)
    res = fit_distributed(
        functools.partial(torch_jobs.llama_module, None,
                          pipeline_microbatches=2, **kw),
        functools.partial(torch_jobs.trainer, strategy="sharded", pipe=2,
                          max_steps=2, ckpt_dir=str(tmp_path / "ck"),
                          every_n_train_steps=2),
        functools.partial(torch_jobs.llama_data, toks, None, 2), 2,
        device="cpu", timeout=T, return_weights=False,
        log_dir=str(tmp_path / "logs"))
    ck = load_checkpoint(res.best_model_path)

    def fit(steps, **fit_kw):
        module = torch_jobs.llama_module(None, **kw)
        trainer = Trainer(strategy=torch_jobs.make_strategy("single"),
                          max_steps=steps, enable_checkpointing=False,
                          enable_progress_bar=False, seed=0)
        trainer.fit(module, torch_jobs.llama_data(toks, None, 2), **fit_kw)
        return trainer, module

    _, single = fit(2)
    want = single.model.state_dict()
    assert set(ck["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(torch.as_tensor(ck["params"][k]).numpy(),
                                   v.detach().numpy(), rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    trainer, _ = fit(3, ckpt_path=res.best_model_path)
    assert trainer.global_step == 3
