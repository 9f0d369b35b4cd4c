"""BERT under the tensor axis: `ShardedMesh(tensor=2)` and
`ShardedMesh(fsdp=2, tensor=2)` in two and four CPU processes over gloo
(one group a mesh for the whole file, `tests/torch_axis_jobs.py`
`bert_tensor_job`), against the port's `SingleDevice` and the JAX
package's `ShardedMesh` fit of the same batches on its virtual CPU mesh.

The tiny BERT at head dim 64 (`tests/test_torch_bert.py`'s ``FLASH64``),
f32, no dropout, with the JAX init's weights (`params_from_jax`; every
bias and LayerNorm parameter moved off its init so the biases' paths
carry values) trains 3 steps on unmasked batches, so attention takes
the flash path (the kernels' plain versions here). The per-step loss
and grad_norm are held at 2e-5 and the final weights at
`tests/test_torch_fit_distributed.py`'s `_close` (2e-5) plus the
reference spread of `tests/test_torch_tensor_parallel.py`, but for the
k third of each ``wqkv`` bias: softmax is invariant to a shift that
every key of a row shares, so that bias's gradient is zero but for each
implementation's own rounding (about 2e-9 here, held under 1e-6 of the
largest gradient), which Adam normalises into a step of up to the
learning rate; those elements are held within the learning rate of
each update taken (``NOISE_TOL``). One loss and backward is held
gradient by gradient at 2e-5, the biases of ``wqkv``, ``wo``, ``w_up``
and ``w_down`` included. A ``tensor=2`` DCP checkpoint
restores bitwise into `SingleDevice`, whose next step is the tensor
lane's (so the checkpoint holds the canonical ``wqkv`` rows and bias),
and a `SingleDevice` checkpoint restores bitwise into ``tensor=2``. A
``tensor=2`` fit at dropout 0.5 equals `SingleDevice`'s at the same
seed: every mask is drawn on a replicated tensor. ``tensor=3`` and
``tensor=4`` (BERT-base's vocabulary of 30522) raise naming the
dimension.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models import bert as jbert
from ray_lightning_tpu.parallel.strategy import ShardedMesh as JaxSharded
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.checkpoint import load_checkpoint
from ray_lightning_tpu_torch.checkpoint.io import read_meta
from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import bert
from ray_lightning_tpu_torch.parallel import plan
from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh, SingleDevice
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_axis_jobs, torch_jobs
from tests.test_torch_bert import FLASH64, _JaxRows, synthetic_text
from tests.test_torch_fit_distributed import _close, _np
from tests.test_torch_tensor_parallel import _tol

T = 240
STEPS, B = 3, 8
#: name: (ShardedMesh sizes, processes)
MESHES = {"tensor2": (dict(tensor=2), 2),
          "fsdp2_tensor2": (dict(fsdp=2, tensor=2), 4)}
MODULE_KW = dict(num_classes=2, lr=1e-3, weight_decay=0.01, warmup_steps=1,
                 total_steps=STEPS)
COMMON = dict(log_every_n_steps=1, enable_checkpointing=False,
              enable_progress_bar=False, seed=0)
#: the k bias's bound: the learning rate for each of the fit's updates
#: (step 0 runs at learning rate 0)
NOISE_TOL = (STEPS - 1) * MODULE_KW["lr"]
DIM = FLASH64["dim"]


def _k_bias(state):
    """``state`` with the k third of each ``wqkv`` bias taken out, and
    those thirds: (rest, {name: k bias})."""
    rest, ks = {}, {}
    for k, v in state.items():
        v = _np(v)
        if k.endswith("wqkv.bias"):
            ks[k] = v[DIM:2 * DIM]
            v = np.concatenate([v[:DIM], v[2 * DIM:]])
        rest[k] = torch.from_numpy(np.ascontiguousarray(v))
    return rest, ks


def _inputs(tmp_path):
    jc = jbert.BertConfig.tiny(dtype=jnp.float32, scan_layers=False,
                               dropout=0.0, **FLASH64)
    data = synthetic_text(n=STEPS * B, seq=16)
    del data["attention_mask"]
    batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()}
               for i in range(STEPS)]
    jm = jbert.BertClassifierModule(jc, **MODULE_KW)
    jm.setup()
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1),
                                                     batches[0]))
    rng = np.random.default_rng(7)

    def move(path, leaf):
        # the biases and LayerNorm parameters off their zeros and ones
        if path[-1].key in ("bias", "scale"):
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(move, params)
    return {"params": params, "cfg_kw": dict(FLASH64),
            "module_kw": MODULE_KW, "batches": batches, "steps": STEPS,
            "grad_batch": batches[0], "ckpt_dir": str(tmp_path / "tp_ck"),
            "single_ckpt": str(tmp_path / "single_ck" / "step=2")}, jc


def _single_fit(inp, steps=STEPS, dropout=0.0, callbacks=(), **fit_kw):
    """The port's `SingleDevice` fit of the same global batches: (rows,
    final state dict)."""
    module = torch_axis_jobs.bert_module(inp, dropout)
    rec = torch_jobs.StepRecorder()
    Trainer(strategy=SingleDevice(device="cpu"), max_steps=steps,
            callbacks=[rec, *callbacks], **COMMON).fit(
        module, inp["batches"], **fit_kw)
    return rec.rows, {k: v.detach().clone()
                      for k, v in module.model.state_dict().items()}


def _jax_fit(inp, jc, strategy):
    rec = _JaxRows()
    jm = jbert.BertClassifierModule(jc, **MODULE_KW)
    jm.params = jax.tree.map(jnp.asarray, inp["params"])
    JaxTrainer(strategy=strategy, callbacks=[rec], max_steps=STEPS,
               **COMMON).fit(jm, [dict(b) for b in inp["batches"]])
    return rec.rows, bert.params_from_jax(jax.tree.map(np.asarray,
                                                       jm.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' groups, the port's one-card fit (and the one-card
    checkpoint the tensor group restores, written first) and the JAX
    package's ShardedMesh and one-card fits."""
    tmp_path = tmp_path_factory.mktemp("bert_tensor")
    inp, jc = _inputs(tmp_path)
    _single_fit(inp, steps=2, callbacks=[ModelCheckpoint(
        dirpath=str(tmp_path / "single_ck"), every_n_train_steps=2,
        save_top_k=-1)])
    out = {"inp": inp, "single": _single_fit(inp),
           "jax_single": _jax_fit(inp, jc, JaxSingle())}
    for mesh, (sizes, n) in MESHES.items():
        out[mesh] = launch(torch_axis_jobs.bert_tensor_job, n, device="cpu",
                           args=({**inp, "sizes": sizes},), timeout=T)
        out[f"jax_{mesh}"] = _jax_fit(inp, jc, JaxSharded(
            **sizes, num_workers=n, min_shard_size=1))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_matches_single_device_and_jax(runs, mesh):
    single_rows, single_params = runs["single"]
    jrows, want = runs[f"jax_{mesh}"]
    _, jsingle = runs["jax_single"]
    single_params, single_k = _k_bias(single_params)
    want, want_k = _k_bias(want)
    jsingle, _ = _k_bias(jsingle)
    sizes, n = MESHES[mesh]
    for r in runs[mesh]:
        fit = r["fit"]
        rows, (state, state_k) = fit["rows"], _k_bias(fit["state"])
        for k, v in state_k.items():
            assert np.abs(v - want_k[k]).max() <= NOISE_TOL, k
            assert np.abs(v - single_k[k]).max() <= NOISE_TOL, k
        assert len(rows) == STEPS
        # a rank's q|k|v rows: one of the two heads each
        assert fit["tp"] == 2 and fit["wqkv_local"][0] == 3 * 128 // 2
        np.testing.assert_allclose(rows, single_rows, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(rows, jrows, rtol=2e-5, atol=2e-5)
        # the reference spread: the port's one-card fit against the JAX
        # one-card fit, plus the JAX ShardedMesh fit against that one
        spread = {k: (single_params[k] - jsingle[k]).abs()
                  + (want[k] - jsingle[k]).abs() for k in want}
        assert set(state) == set(want)
        _close(state, want, "against the JAX ShardedMesh", spread)
        allowed = sum(int((np.abs(_np(want[k]) - _np(jsingle[k]))
                           > _tol(jsingle[k])).sum()) for k in want)
        past = sum(int((np.abs(_np(state[k]) - _np(single_params[k]))
                        > _tol(single_params[k]) + _np(spread[k])).sum())
                   for k in want)
        assert past <= allowed, (past, allowed)
        # each rank's bytes are the planner's, from the meta device
        p = plan.plan_train_memory(
            torch_axis_jobs.bert_module(runs["inp"]),
            ShardedMesh(**sizes, device="cpu"), n, None)
        assert fit["bytes"] == (p.params_bytes_per_device,
                                     p.opt_bytes_per_device)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_gradient_matches_single_device(runs, mesh):
    inp = runs["inp"]
    module = torch_axis_jobs.bert_module(inp)
    module.device = torch.device("cpu")
    module.setup()
    with torch.no_grad():
        module.model.load_state_dict(module.params)
    params = dict(module.model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in inp["grad_batch"].items()}
    want, _ = module._loss_acc(module.model(batch["input_ids"]),
                               batch["labels"])
    want.backward()
    got = runs[mesh][0]["grads"]
    assert got["loss"] == pytest.approx(float(want), rel=2e-5, abs=2e-5)
    assert set(got["grads"]) == set(params)
    for name in ("wqkv", "wo", "w_up", "w_down"):
        g = got["grads"][f"encoder.layers.0.{name}.bias"]
        assert np.abs(g).max() > 0, name
    for k, g in got["grads"].items():
        if k.endswith("wqkv.bias"):  # the k third: rounding alone
            bound = 1e-6 * np.abs(g).max()
            assert np.abs(g[DIM:2 * DIM]).max() < bound, k
            assert np.abs(params[k].grad[DIM:2 * DIM]).max() < bound, k
    for k, p in params.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(got["grads"][k], g, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(g).max()),
                                   err_msg=k)


def _bitwise(state, ck):
    params, opt = state
    for k, v in ck["params"].items():
        assert np.array_equal(params[k], _np(v)), k
    for name, entry in ck["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(opt[name][key], _np(entry[key])), name


def test_checkpoints_cross_layouts_bitwise(runs):
    """tensor=2 → SingleDevice and SingleDevice → tensor=2: every weight
    and moment bit for bit; the restored one-card fit's next step is the
    tensor lane's, so the checkpoint's fused rows are canonical."""
    inp = runs["inp"]
    rank0 = runs["tensor2"][0]
    path = rank0["ckpt"]["path"]
    meta = read_meta(path)
    assert meta["mesh_spec"] == {"tensor": 2}
    specs = meta["param_specs"]
    assert specs["encoder.layers.0.wqkv.weight"] == ["tensor", None]
    assert specs["encoder.layers.0.wqkv.bias"] == ["tensor"]
    assert specs["encoder.layers.0.wo.weight"] == [None, "tensor"]
    ck = load_checkpoint(path)
    for r in runs["tensor2"]:
        _bitwise(r["ckpt"]["state"], ck)
    keep = torch_axis_jobs.AtStart()
    rows, _ = _single_fit(inp, callbacks=[keep.callback], ckpt_path=path)
    _bitwise(keep.state, ck)
    assert len(rows) == 1
    np.testing.assert_allclose(rows[0], rank0["fit"]["rows"][2], rtol=2e-5,
                               atol=2e-5)
    single_ck = load_checkpoint(inp["single_ckpt"])
    for r in runs["tensor2"]:
        _bitwise(r["restored"], single_ck)


def test_dropout_fit_equals_single_device(runs):
    """At dropout 0.5 every tensor rank draws the one-card fit's masks
    (from the step's generator, on replicated tensors)."""
    rows, _ = _single_fit(runs["inp"], dropout=0.5)
    assert rows != runs["single"][0]  # the masks bite
    for r in runs["tensor2"]:
        np.testing.assert_allclose(r["dropout_rows"], rows, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("tensor,cfg,what", [
    (3, bert.BertConfig.tiny(**FLASH64), "n_heads=2"),
    (4, bert.BertConfig.base(), "vocab_size=30522")], ids=["3", "4"])
def test_bad_tensor_sizes_raise(tensor, cfg, what):
    module = bert.BertClassifierModule(cfg)
    strategy = ShardedMesh(tensor=tensor, device="cpu")
    strategy.shape_only(tensor, module)
    with pytest.raises(ValueError, match=f"tensor={tensor} does not divide "
                                         f"{what}"):
        strategy.bind_module(module)
