"""The expert axis: `models/moe.py` against the JAX package
(`tests/test_moe.py`'s cases), on the CPU.

In one process: one expert with ample capacity is the dense SwiGLU, and
the routed bank's output and aux loss equal the JAX layer's on the same
weights, with ample and with starved capacity. Over four gloo processes
(one group for the whole file, `tests/torch_axis_jobs.py` `moe_job`):
the classifier's loss (its aux loss taken over the global batch),
logits, every gradient and the global norm under
``ShardedMesh(data=2, expert=2)`` and ``ShardedMesh(expert=4)`` against
`jax.grad` of the JAX module on the whole batch, each rank holding
E / expert of the experts; and a 3-step fit under
``ShardedMesh(data=2, expert=2)`` against the JAX fit. f32, 2e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.moe import MoEClassifierModule as JaxMoEModule
from ray_lightning_tpu.models.moe import MoEMLP as JaxMoEMLP
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.models.moe import (
    MoEMLP,
    _MoENet,
    params_from_jax,
)
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_axis_jobs

T = 240
TOL = dict(rtol=2e-5, atol=2e-5)
#: the JAX test's classifier (`tests/test_moe.py`)
MODULE_KW = dict(dim=64, n_experts=4, hidden_dim=128, num_classes=4,
                 lr=3e-3)


def _port_layer(jparams, **kw):
    layer = MoEMLP(jparams["router"].shape[0], dtype=torch.float32, **kw)
    with torch.no_grad():
        for name in ("router", "w_gate_up", "w_down"):
            getattr(layer, name).copy_(torch.tensor(np.asarray(
                jparams[name])))
    return layer


def _layer_pair(x, **kw):
    jl = JaxMoEMLP(dtype=jnp.float32, **kw)
    params = jl.init(jax.random.key(0), jnp.asarray(x))["params"]
    y, aux = jl.apply({"params": params}, jnp.asarray(x))
    port = _port_layer(params, **kw)
    with torch.no_grad():
        py, paux = port(torch.tensor(x))
    return (np.asarray(y), float(aux)), (py.numpy(), float(paux)), params


def test_single_expert_equals_dense_swiglu():
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(
        np.float32)
    (jy, jaux), (y, aux), params = _layer_pair(
        x, n_experts=1, hidden_dim=32, top_k=1, capacity_factor=2.0)
    h = x.reshape(-1, 16) @ np.asarray(params["w_gate_up"][0])
    gate, up = np.split(h, 2, axis=-1)
    ref = (gate / (1 + np.exp(-gate)) * up) @ np.asarray(
        params["w_down"][0])
    np.testing.assert_allclose(y.reshape(-1, 16), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, jy, **TOL)
    assert aux == jaux == 1.0


@pytest.mark.parametrize("capacity_factor", [1.5, 0.1])
def test_combine_weights_and_capacity_match_jax(capacity_factor):
    x = np.random.default_rng(1).standard_normal((4, 16, 32)).astype(
        np.float32)
    (jy, jaux), (y, aux), _ = _layer_pair(
        x, n_experts=4, hidden_dim=64, top_k=2,
        capacity_factor=capacity_factor)
    np.testing.assert_allclose(y, jy, **TOL)
    assert aux == pytest.approx(jaux, rel=2e-5)
    assert np.isfinite(y).all() and 0.5 < aux < 4.0
    if capacity_factor < 1:
        # starved capacity drops most tokens: zero outputs, never NaNs
        assert (np.abs(y) < 1e-6).mean() > 0.5


def _data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, n).astype(np.int32)
    centers = rng.standard_normal((4, 32)).astype(np.float32) * 3
    x = centers[y] + rng.standard_normal((n, 32)).astype(np.float32)
    return {"x": x, "y": y}


def _inputs():
    jm = JaxMoEModule(**MODULE_KW)
    jm.setup()
    data = _data()
    params = jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(3), {"x": data["x"][:2], "y": data["y"][:2]}))
    return {"module_kw": dict(MODULE_KW, in_features=32), "params": params,
            "batch": {k: v[:32] for k, v in data.items()},
            "fit_data": {k: v[:96] for k, v in data.items()},
            "fit_batch": 32}


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    return inp, launch(torch_axis_jobs.moe_job, 4, device="cpu",
                       args=(inp,), timeout=T)


def _jax_loss_grads(params, batch):
    jm = JaxMoEModule(**MODULE_KW)
    jm.setup()

    def loss_fn(p):
        logits, aux = jm.apply(p, jnp.asarray(batch["x"]))
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch["y"])).mean()
        return ce + jm.aux_weight * aux, (logits, aux)

    (loss, (logits, aux)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))
    return (float(loss), np.asarray(logits), float(aux),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("mesh", ["data2_expert2", "expert4"])
def test_expert_parallel_step_matches_jax(run, mesh):
    inp, ranks = run
    loss, logits, aux, jgrads = _jax_loss_grads(inp["params"], inp["batch"])
    want = {k: v.numpy() for k, v in params_from_jax(jgrads).items()}
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in want.values())))
    n_expert = 2 if mesh == "data2_expert2" else 4
    for r in ranks:
        got = r[mesh]
        assert got["loss"] == pytest.approx(loss, rel=2e-5, abs=2e-5)
        # the aux loss over the global batch, on every rank
        assert got["aux"] == pytest.approx(aux, rel=2e-5, abs=2e-5)
        rows = np.array_split(np.arange(32), 4)[got["index"]]
        np.testing.assert_allclose(got["logits"], logits[rows], **TOL)
        assert got["local_experts"] == MODULE_KW["n_experts"] // n_expert
        for name, g in want.items():
            np.testing.assert_allclose(
                got["grads"][name], g, rtol=2e-5,
                atol=2e-5 * float(np.abs(g).max()), err_msg=name)
        assert got["norm"] == pytest.approx(norm, rel=2e-5)


class _Rows(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def test_expert_parallel_fit_matches_jax(run):
    inp, ranks = run
    data, b = inp["fit_data"], inp["fit_batch"]
    share = len(data["y"]) // 4
    per = b // 4
    batches = []
    for k in range(3):
        rows = np.concatenate([np.arange(r * share + k * per,
                                         r * share + (k + 1) * per)
                               for r in range(4)])
        batches.append({n: v[rows] for n, v in data.items()})
    rec = _Rows()
    jm = JaxMoEModule(**MODULE_KW)
    jm.params = jax.tree.map(jnp.asarray, inp["params"])
    JaxTrainer(strategy=JaxSingle(), callbacks=[rec], max_steps=3,
               log_every_n_steps=1, enable_checkpointing=False,
               enable_progress_bar=False, seed=0).fit(jm, batches)
    for r in ranks:
        fit = r["fit"]
        np.testing.assert_allclose(np.asarray(fit["rows"]),
                                   np.asarray(rec.rows), **TOL)
        assert "Shard(dim=0)" in fit["placements"]
        assert fit["mesh"] == {"data": 2, "fsdp": 1, "expert": 2}


def test_params_from_jax_round_trip():
    """`params_from_jax` lays the JAX tree out as `_MoENet`'s state dict,
    key for key and shape for shape."""
    jm = JaxMoEModule(**MODULE_KW)
    jm.setup()
    data = _data(8)
    params = jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(0), {"x": data["x"], "y": data["y"]}))
    net = _MoENet(32, 64, 4, 128, 2, 4, torch.float32)
    sd = params_from_jax(params)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    logits, aux = net(torch.tensor(data["x"]))
    jl, jaux = jm.apply(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(data["x"]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               **TOL)
    assert float(aux.detach()) == pytest.approx(float(jaux), rel=2e-5)
