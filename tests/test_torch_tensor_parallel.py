"""The tensor axis: `ShardedMesh(tensor=2)` and `ShardedMesh(fsdp=2,
tensor=2)` in two and four CPU processes over gloo, against the port's
`SingleDevice` and the JAX `ShardedMesh` fit on the virtual CPU mesh
(`tests/test_llama.py:226`).

The tiny Llama in f32 with the JAX model's own weights
(`params_from_jax`) trains 4 steps; the per-step loss and grad_norm and
the final weights are held at the fit tolerance of
`tests/test_torch_fit_distributed.py`: 2e-5, plus, against JAX, element
by element, how far the port's one-card fit lies from the JAX one-card
fit and the JAX `ShardedMesh` fit from that one; against the port's
one-card fit with the same spread, and no more elements beyond it than
the JAX package's own `ShardedMesh` and one-card fits have beyond 2e-5
(at fsdp=2 x tensor=2 one embedding element, the same one in both
pairs: an Adam step on a gradient at eps's scale). One loss and
backward is held gradient by gradient at 2e-5, and so is a loss of the
gathered logits of ``model(tokens)``. Then: a ``tensor=2`` DCP
checkpoint restored bitwise into a `SingleDevice` fit and a two-process
FSDP fit, and a `SingleDevice` checkpoint restored bitwise into a
``tensor=2`` fit
(state dicts and checkpoints keep the canonical fused row order); the
vocab-split CE against the plain one at 2e-5; a global norm that counts
replicated gains once; the ranks of a tensor group reading the same
rows; ``tensor=3`` and a typo'd axis raising with the JAX messages'
codes.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.parallel.strategy import ShardedMesh as JaxSharded
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.checkpoint import load_checkpoint
from ray_lightning_tpu_torch.checkpoint.io import read_meta
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    params_from_jax,
    token_loss_sum,
)
from ray_lightning_tpu_torch.ops.fused_ce import fused_cross_entropy_sum
from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh, SingleDevice
from ray_lightning_tpu_torch.runtime import fit_distributed
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_jobs
from tests.test_torch_fit_distributed import _close, _jax_fit, _np

T = 180
N, S, B = 16, 12, 2

#: name: (ShardedMesh sizes, processes)
MESHES = {"tensor2": (dict(tensor=2), 2),
          "fsdp2_tensor2": (dict(fsdp=2, tensor=2), 4)}
#: the gradient's meshes: also HSDP (data replicas) under the tensor axis
GRAD_MESHES = {**MESHES, "data2_tensor2": (dict(data=2, tensor=2), 4)}
#: the fit: fused CE with a clip that bites and unequal masks
CFG_KW = dict(fused_ce=True, remat=True, ce_chunk_tokens=16)
CLIP = 0.5


def _tol(w):
    """The fit tolerance of one tensor: 2e-5 of its largest entry and of
    each element (`tests/test_torch_fit_distributed.py` `_close`)."""
    w = _np(w)
    return 2e-5 * (max(float(np.abs(w).max()), 1e-6) + np.abs(w))


def _inputs():
    jcfg = JaxConfig(**torch_jobs.TINY, dtype=jnp.float32, remat=False,
                     fused_ce=True, ce_chunk_tokens=16)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    toks = torch_jobs.tokens(N, S, seed=4)
    mask = (np.random.default_rng(6).random((N, S)) > 0.1).astype(
        np.float32)
    mask[N // 2:, 4:] = 0.0
    return jcfg, params, toks, mask


def _batches(toks, mask, dp):
    """Step k's global batch: each data-parallel rank's k-th batch of its
    contiguous share of the rows, in rank order."""
    share = N // dp
    out = []
    for k in range(4):
        rows = np.concatenate([np.arange(r * share + k * B,
                                         r * share + (k + 1) * B)
                               for r in range(dp)])
        out.append({"tokens": toks[rows], "mask": mask[rows]})
    return out


def _port_fit(mesh, params, toks, mask, tmp_path, extra=(), **kw):
    sizes, n = MESHES[mesh]
    rows, init, live = [], [], []

    def collect(rank, item):
        if item[0] == "row":
            rows.append(item[2:])
        elif item[0] == "init":
            init.append(item[1:])
        elif item[0] == "live":
            live.append(item[1:])

    trainer_kw = dict(strategy="sharded", clip=CLIP, extra=extra,
                      **sizes, **kw.pop("trainer_kw", {}))
    res = fit_distributed(
        functools.partial(torch_jobs.llama_module, params, **CFG_KW),
        functools.partial(torch_jobs.trainer, **trainer_kw),
        functools.partial(torch_jobs.llama_data, toks, mask, B), n,
        device="cpu", on_queue_item=collect, timeout=T,
        log_dir=str(tmp_path / "logs"), **kw)
    return rows, res, init, live


_RUNS = {}


def _fits(mesh, tmp_path):
    """The port's run of ``mesh``, its SingleDevice twin on the same
    global batches, and the JAX package's ShardedMesh and SingleDevice
    fits (rows, port-layout weights)."""
    if mesh not in _RUNS:
        jcfg, params, toks, mask = _inputs()
        sizes, n = MESHES[mesh]
        dp = n // sizes["tensor"]
        batches = _batches(toks, mask, dp)
        port = _port_fit(mesh, params, toks, mask, tmp_path)
        rec = torch_jobs.StepRecorder()
        single = torch_jobs.llama_module(params, **CFG_KW)
        Trainer(strategy=SingleDevice(device="cpu"), max_steps=4,
                gradient_clip_val=CLIP, log_every_n_steps=1, seed=0,
                enable_checkpointing=False, enable_progress_bar=False,
                callbacks=[rec]).fit(single, batches)
        pcfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
        jax_runs = {}
        for name, make in (
                # min_shard_size=1, as tests/test_llama.py's 3-D mesh fit
                # (the JAX fit refuses its own default's layout of the
                # small gains at fsdp=2 x tensor=2)
                ("sharded", lambda: JaxSharded(**sizes, num_workers=n,
                                               min_shard_size=1)),
                ("single", lambda: JaxSingle())):
            jrows, jparams = _jax_fit(jcfg, params, batches, CLIP,
                                      lambda num_workers: make())
            jax_runs[name] = (jrows, params_from_jax(jparams, pcfg,
                                                     dtype=torch.float32))
        _RUNS[mesh] = (port, (rec.rows, single.params), jax_runs)
    return _RUNS[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_matches_single_device_and_jax(tmp_path, mesh):
    (rows, res, _, _), (single_rows, single_params), jax_runs = _fits(
        mesh, tmp_path)
    assert len(rows) == 4
    assert max(g for _, g in rows) > CLIP  # the clip bites
    np.testing.assert_allclose(rows, single_rows, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(rows, jax_runs["sharded"][0], rtol=2e-5,
                               atol=2e-5)
    want = jax_runs["sharded"][1]
    # the reference spread: how far the port's one-card fit lies from the
    # JAX one-card fit (an Adam step on a near-zero gradient turns the
    # reduction order's rounding into a visible update, 6.8e-5 on one
    # embedding element), plus the JAX package's own ShardedMesh against
    # its one-card fit
    jsingle = jax_runs["single"][1]
    spread = {k: (single_params[k].detach() - jsingle[k]).abs()
              + (want[k] - jsingle[k]).abs() for k in want}
    assert set(res.state_dict) == set(want)
    _close(res.state_dict, want, "against the JAX ShardedMesh", spread)
    # against the port's one-card fit: the same spread, and no more
    # elements beyond it than the JAX package's own ShardedMesh and
    # one-card fits have beyond 2e-5 (an Adam step on a gradient at eps's
    # scale, left by cancellation, moves with any order of the sums)
    allowed = sum(int((np.abs(_np(want[k]) - _np(jsingle[k]))
                       > _tol(jsingle[k])).sum()) for k in want)
    past = sum(int((np.abs(_np(res.state_dict[k])
                           - _np(single_params[k]))
                    > _tol(single_params[k]) + _np(spread[k])).sum())
               for k in want)
    assert past <= allowed, (past, allowed)


@pytest.mark.parametrize("mesh", list(GRAD_MESHES))
def test_every_gradient_matches_single_device(mesh):
    jcfg, params, toks, mask = _inputs()
    sizes, n = GRAD_MESHES[mesh]
    dp = n // sizes["tensor"]
    batch = _batches(toks, mask, dp)[0]
    loss, grads, logits = launch(torch_jobs.tp_grads, n, device="cpu",
                                 args=(params, batch["tokens"],
                                       batch["mask"], CFG_KW, sizes),
                                 timeout=T)[0]
    single = _single_module(params)
    t = torch.from_numpy(batch["tokens"])
    want = single.apply(single.params, t[:, :-1], targets=t[:, 1:],
                        mask=torch.from_numpy(batch["mask"]))
    want.backward()
    assert loss == pytest.approx(float(want), rel=2e-5, abs=2e-5)
    # the vocab-split logits, gathered (predict's path): rank 0's rows
    rows = len(batch["tokens"]) // (n // sizes["tensor"])
    with torch.no_grad():
        want_logits = single.apply(single.params, t[:rows, :-1]).numpy()
    np.testing.assert_allclose(logits, want_logits, rtol=2e-5, atol=2e-5)
    _hold_grads(grads, single)


def _single_module(params):
    """The tiny Llama with ``params`` on one CPU process, unwrapped."""
    single = torch_jobs.llama_module(params, **CFG_KW)
    single.device = torch.device("cpu")
    single.setup()
    with torch.no_grad():
        single.model.load_state_dict(single.params)
    single.params = dict(single.model.named_parameters())
    return single


def _hold_grads(grads, single):
    assert set(grads) == set(single.params)
    for k, p in single.params.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(grads[k], g, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(g).max()),
                                   err_msg=k)


def test_gradient_through_the_gathered_logits(tmp_path):
    """``model(tokens)`` without targets under tensor=2 returns the
    gathered vocab-split logits with their gradient: a loss of them
    trains the head and the trunk as on one card."""
    _, params, toks, _ = _inputs()
    t = toks[:4]
    loss, grads = launch(torch_jobs.tp_logit_grads, 2, device="cpu",
                         args=(params, t, CFG_KW, dict(tensor=2), 11),
                         timeout=T)[0]
    single = _single_module(params)
    tt = torch.from_numpy(t)
    want = torch_jobs.logits_loss(single.apply(single.params, tt[:, :-1]), 11)
    want.backward()
    assert loss == pytest.approx(float(want), rel=2e-5, abs=2e-5)
    assert np.abs(grads["lm_head"]).max() > 0
    _hold_grads(grads, single)


def test_checkpoints_cross_layouts_bitwise(tmp_path):
    """tensor=2 → SingleDevice and FSDP, and SingleDevice → tensor=2:
    every weight and moment equal bit for bit, in the canonical rows."""
    _, params, toks, mask = _inputs()
    ckdir = str(tmp_path / "ck")
    _, first, _, _ = _port_fit(
        "tensor2", params, toks, mask, tmp_path, return_weights=False,
        trainer_kw=dict(max_steps=2, ckpt_dir=ckdir, every_n_train_steps=2))
    path = first.best_model_path
    meta = read_meta(path)
    assert meta["mesh_spec"] == {"tensor": 2}
    assert meta["param_specs"]["layers.0.wqkv"] == ["tensor", None]
    assert meta["param_specs"]["layers.0.wo"] == [None, "tensor"]
    assert meta["param_specs"]["layers.0.attn_norm"] == [None]
    ck = load_checkpoint(path)

    # into FSDP over two processes: the restored state, gathered
    _, _, init, _ = _port_fit_fsdp(params, toks, mask, tmp_path, path)
    got_p, got_o = init[0][0], init[0][1]
    for k, v in ck["params"].items():
        assert np.array_equal(got_p[k], _np(v)), k
    for name, entry in ck["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(got_o[name][key], _np(entry[key])), name

    # SingleDevice restores it (held at the fit's start), trains on and
    # writes its own; tensor=2 restores that one
    from ray_lightning_tpu_torch.core.callbacks import (
        Callback,
        ModelCheckpoint,
    )
    from ray_lightning_tpu_torch.core.data import DataLoader

    class Restored(Callback):
        def on_fit_start(self, trainer, module):
            self.state = torch_jobs.full_state(trainer, module)

    restored = Restored()
    single = torch_jobs.llama_module(None, **CFG_KW)
    sdir = str(tmp_path / "single")
    trainer = Trainer(strategy=SingleDevice(device="cpu"), max_steps=3,
                      gradient_clip_val=CLIP, seed=0,
                      enable_progress_bar=False, log_every_n_steps=1,
                      callbacks=[restored, ModelCheckpoint(
                          dirpath=sdir, every_n_train_steps=3,
                          save_top_k=-1)])
    trainer.fit(single, DataLoader({"tokens": toks, "mask": mask},
                                   batch_size=B), ckpt_path=path)
    assert trainer.global_step == 3
    got_p, got_o = restored.state
    for k, v in ck["params"].items():
        assert np.array_equal(got_p[k], _np(v)), k
    for name, entry in ck["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(got_o[name][key], _np(entry[key])), name
    spath = os.path.join(sdir, "step=3")
    sck = load_checkpoint(spath)
    _, _, init, _ = _port_fit("tensor2", params, toks, mask, tmp_path,
                              extra=("InitState",), ckpt_path=spath,
                              return_weights=False,
                              trainer_kw=dict(max_steps=4))
    got_p, got_o, rope, path_kind, _ = init[0]
    assert rope and path_kind == "eager"  # the module's weights are given
    for k, v in sck["params"].items():
        assert np.array_equal(got_p[k], _np(v)), k
    for name, entry in sck["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(got_o[name][key], _np(entry[key])), name


def _port_fit_fsdp(params, toks, mask, tmp_path, path):
    init = []

    def collect(rank, item):
        if item[0] == "init":
            init.append(item[1:])

    fit_distributed(
        functools.partial(torch_jobs.llama_module, params, **CFG_KW),
        functools.partial(torch_jobs.trainer, strategy="fsdp", clip=CLIP,
                          extra=("InitState",), max_steps=4),
        functools.partial(torch_jobs.llama_data, toks, mask, B), 2,
        device="cpu", on_queue_item=collect, timeout=T,
        log_dir=str(tmp_path / "logs_fsdp"), ckpt_path=path,
        return_weights=False)
    return None, None, init, None


def test_vocab_parallel_ce_equals_the_plain_ce():
    n, vocab, dim = 24, 64, 16
    loss, count, gh, gw = launch(torch_jobs.vocab_parallel_ce, 2,
                                 device="cpu", args=(3, n, vocab, dim, 8),
                                 timeout=T)[0]
    rng = np.random.default_rng(3)
    h = torch.tensor(rng.standard_normal((2, n // 2, dim)),
                     dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.standard_normal((vocab, dim)) / dim ** 0.5,
                     dtype=torch.float32, requires_grad=True)
    t = torch.tensor(rng.integers(0, vocab, (2, n // 2)))
    m = torch.tensor((rng.random((2, n // 2)) > 0.2).astype(np.float32))
    want, want_count = token_loss_sum(h @ w.T, t, m)
    want.backward()
    assert count == float(want_count)
    assert loss == pytest.approx(float(want.detach()), rel=2e-5, abs=2e-5)
    np.testing.assert_allclose(gh, h.grad.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gw, w.grad.numpy(), rtol=2e-5, atol=2e-5)
    # and the port's one-card chunked CE on the same inputs
    chunked, _ = fused_cross_entropy_sum(h.detach(), w.detach(), t, m, 8,
                                         torch.float32)
    assert loss == pytest.approx(float(chunked), rel=2e-5, abs=2e-5)


def test_global_norm_counts_replicated_gains_once(tmp_path):
    """The fit's grad_norm under tensor=2 is the one-process norm of the
    same gradients, not the norm with the replicated gains counted twice:
    the tensor=2 and SingleDevice rows agree, and doubling the gains'
    squares would move them."""
    (rows, _, _, _), (single_rows, _), _ = _fits("tensor2", tmp_path)
    np.testing.assert_allclose([r[1] for r in rows],
                               [r[1] for r in single_rows], rtol=2e-5)
    _, params, toks, mask = _inputs()
    batch = _batches(toks, mask, 1)[0]
    _, grads, _ = launch(torch_jobs.tp_grads, 2, device="cpu",
                         args=(params, batch["tokens"], batch["mask"],
                               CFG_KW, dict(tensor=2)), timeout=T)[0]
    gains = sum(float(np.square(g).sum()) for k, g in grads.items()
                if g.ndim == 1)
    total = sum(float(np.square(g).sum()) for g in grads.values())
    assert gains > 1e-4 * total  # counting them twice would show
    assert rows[0][1] == pytest.approx(total ** 0.5, rel=2e-5)


def test_tensor_group_reads_the_same_rows():
    strategy = ShardedMesh(fsdp=2, tensor=2, device="cpu")
    assert [strategy.data_shard(r, 4) for r in range(4)] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]
    assert ShardedMesh(tensor=2, device="cpu").data_shard(1, 2) == (0, 1)
    assert ShardedMesh(data=2, device="cpu").data_shard(1, 2) == (1, 2)


def test_bad_tensor_sizes_and_axes_raise():
    from ray_lightning_tpu_torch.models.llama import LlamaModule

    module = LlamaModule(LlamaConfig.tiny())
    strategy = ShardedMesh(tensor=3, device="cpu")
    with pytest.raises(ValueError, match="tensor=3 does not divide "
                                         "n_kv_heads=2"):
        strategy.shape_only(3, module)
        strategy.bind_module(module)

    class Raw:
        """A module whose param_specs names a typo'd axis (RLT101) or
        splits a leaf unevenly (RLT102)."""

        def __init__(self, specs):
            self.specs = specs
            self.device = None

        def param_specs(self, params=None):
            return self.specs

    for specs, shape, code in (({"w": ("fdsp", None)}, (64, 64), "RLT101"),
                               ({"w": ("fsdp", None)}, (6, 4), "RLT102"),
                               ({"w": ("fsdp", "fsdp")}, (64, 64), "RLT103"),
                               ({"w": (None, None, "tensor")}, (64, 64),
                                "RLT104")):
        strategy = ShardedMesh(fsdp=8, tensor=2, device="cpu")
        strategy.shape_only(16, Raw(specs))
        with pytest.raises(ValueError, match=code) as err:
            strategy.leaf_spec("w", shape)
        assert "'w'" in str(err.value) or "w:" in str(err.value)
    strategy = ShardedMesh(fsdp=8, device="cpu")
    strategy.shape_only(8, Raw({"w": ("fsdp", None)}))
    assert strategy.leaf_spec("w", (64, 64)) == ("fsdp",)
    # the typo raises at setup already, before the model has shapes
    strategy = ShardedMesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="RLT101") as err:
            strategy.setup(Raw({"layers.0.w": (None, "tensr")}))
        assert "'layers.0.w'" in str(err.value)
    finally:
        strategy.teardown()
