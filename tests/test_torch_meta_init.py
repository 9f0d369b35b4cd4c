"""Meta-device init: under `FSDP` and `ShardedMesh` the trainer builds the
model on the meta device, wraps it, and fills each rank's shards from
the full values drawn leaf by leaf. The weights equal the eager init's
bit for bit (in one process, in two under FSDP, in two under
``tensor=2``, in four under ``fsdp=2 x tensor=2``, also with FSDP2's
strided shards of the tensor-split rows), the RoPE tables are recomputed, and the path taken is
recorded on the trainer: ``"meta"``, or ``"eager"`` with the reason
(strategies that hold whole weights, given weights, a module whose
``init_params`` takes no ``place=``).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import Llama, LlamaConfig
from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
from ray_lightning_tpu_torch.ops.rope import rope_frequencies
from ray_lightning_tpu_torch.parallel.strategy import (
    FSDP,
    DataParallel,
    SingleDevice,
)
from ray_lightning_tpu_torch.runtime import fit_distributed
from tests import torch_jobs

T = 180
TOKS = torch_jobs.tokens(8, 12, seed=5)


class _Initial(Callback):
    """The whole weights at the fit's start, in this process."""

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.parallel.tensor import local

        self.params = {k: torch_jobs._np_full(v) if hasattr(v, "full_tensor")
                       else local(v).detach().numpy().copy()
                       for k, v in module.model.state_dict().items()}
        self.path = (trainer.init_path, trainer.init_path_reason)


def _fit(strategy, module=None, max_steps=1):
    rec = _Initial()
    module = module or torch_jobs.llama_module(None)
    try:
        Trainer(strategy=strategy, max_steps=max_steps, seed=0,
                enable_checkpointing=False, enable_progress_bar=False,
                callbacks=[rec]).fit(module, DataLoader({"tokens": TOKS},
                                                        batch_size=2))
    finally:
        strategy.teardown()  # the one-rank group the strategy started
    return rec


_EAGER = {}


def _eager():
    if "single" not in _EAGER:
        _EAGER["single"] = _fit(SingleDevice(device="cpu"))
    return _EAGER["single"]


def test_fsdp_in_one_process_initialises_bitwise_the_eager_init():
    eager = _eager()
    meta = _fit(FSDP(device="cpu"))
    assert not dist.is_initialized()
    assert meta.path == ("meta", None)
    assert set(meta.params) == set(eager.params)
    for k, v in eager.params.items():
        assert np.array_equal(meta.params[k], v), k


@pytest.mark.parametrize("strategy,sizes,procs", [
    ("fsdp", {}, 2),
    ("sharded", dict(tensor=2), 2),
    ("sharded", dict(fsdp=2, tensor=2), 4),
    # every leaf too small for the fsdp rule: FSDP2 shards dimension 0,
    # where the tensor split already is, as a strided shard
    ("sharded", dict(fsdp=2, tensor=2, min_shard_size=2**30), 4)],
    ids=str)
def test_two_processes_initialise_bitwise_the_eager_init(tmp_path, strategy,
                                                         sizes, procs):
    init, placements = [], []

    def collect(rank, item):
        if item[0] == "init":
            init.append(item[1:])
        elif item[0] == "placements":
            placements.append(item[1])

    fit_distributed(
        functools.partial(torch_jobs.llama_module, None),
        functools.partial(torch_jobs.trainer, strategy=strategy,
                          extra=("InitState", "Placements"), max_steps=1,
                          **sizes),
        functools.partial(torch_jobs.llama_data, TOKS, None, 2), procs,
        device="cpu", timeout=T, log_dir=str(tmp_path / "logs"),
        return_weights=False, on_queue_item=collect)
    params, opt, rope, path, reason = init[0]
    assert (path, reason) == ("meta", None)
    assert rope, "the RoPE tables were not recomputed after to_empty"
    # no optimizer step before the fit's start: the moments are zeros
    assert all(not np.any(v) for entry in opt.values()
               for v in entry.values())
    for k, v in _eager().params.items():
        assert np.array_equal(params[k], v), k
    strided = sorted(k for k, pl in placements[0].items()
                     if "_StridedShard" in pl)
    if sizes.get("min_shard_size"):
        # the tensor-split leaves on dimension 0: the fused weights, the
        # embedding and the head
        assert {"tok_embed", "lm_head", "layers.0.wqkv",
                "layers.0.w_gate_up"} <= set(strided), placements[0]
    else:
        assert not strided, strided


def test_rope_tables_are_recomputed():
    cfg = LlamaConfig.tiny()
    model = Llama(cfg, device="meta")
    assert model.cos.device.type == "meta"
    model.to_empty(device="cpu")
    model.reset_rope_(torch.device("cpu"))
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta)
    assert torch.equal(model.cos, cos) and torch.equal(model.sin, sin)


def test_the_init_path_is_recorded():
    """Which path ran, and why not meta, for each case."""
    assert _eager().path == (
        "eager", "SingleDevice holds whole weights")
    ddp = _fit(DataParallel(device="cpu"))
    assert ddp.path == ("eager", "DataParallel holds whole weights")
    given = _fit(FSDP(device="cpu"),
                 module=torch_jobs.llama_module(
                     {k: v for k, v in _jax_like_params().items()}))
    assert given.path == ("eager", "the module's weights are given")
    for k, v in _jax_like_params_torch().items():
        assert np.array_equal(given.params[k], v.numpy()), k


def test_a_module_that_cannot_fill_shards_is_built_eagerly():
    """`MNISTClassifier.init_params` fills whole weights in place: under
    FSDP it is built on the card's (here the CPU's) device and wrapped
    after its init, as before, and the trainer says so."""
    module = MNISTClassifier()
    rec = _Initial()
    x = np.random.default_rng(0).random((16, 64)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int64)
    strategy = FSDP(device="cpu")
    trainer = Trainer(strategy=strategy, max_steps=1, seed=0,
                      enable_checkpointing=False, enable_progress_bar=False,
                      callbacks=[rec])
    try:
        trainer.fit(module, DataLoader({"x": x, "y": y}, batch_size=8))
    finally:
        strategy.teardown()
    assert trainer.init_path == "eager"
    assert "init_params takes no place=" in trainer.init_path_reason
    assert rec.path == (trainer.init_path, trainer.init_path_reason)


def _jax_like_params():
    """A flax-layout tree of the tiny model (stacked layers) from a seed,
    the shape `params_from_jax` reads."""
    cfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
    rng = np.random.default_rng(7)
    d, hd, f, v, L = (cfg.dim, cfg.head_dim, cfg.hidden_dim, cfg.vocab_size,
                      cfg.n_layers)
    nq = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.05

    return {"tok_embed": {"embedding": r(v, d)},
            "final_norm": np.ones(d, np.float32),
            "lm_head": {"kernel": r(d, v)},
            "layers": {"attn_norm": np.ones((L, d), np.float32),
                       "mlp_norm": np.ones((L, d), np.float32),
                       "wqkv": {"kernel": r(L, d, nq)},
                       "wo": {"kernel": r(L, cfg.n_heads * hd, d)},
                       "w_gate_up": {"kernel": r(L, d, 2 * f)},
                       "w_down": {"kernel": r(L, f, d)}}}


def _jax_like_params_torch():
    from ray_lightning_tpu_torch.models.llama import params_from_jax

    cfg = LlamaConfig(**torch_jobs.TINY, dtype=torch.float32)
    return params_from_jax(_jax_like_params(), cfg, dtype=torch.float32)
