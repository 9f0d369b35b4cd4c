"""The port's mesh and strategies against the JAX package's, on the CPU.

  * `MeshSpec.resolve`, `fsdp_auto_spec`, `dp_axis_names` and
    `batch_size_divisor` against the JAX functions over a matrix of
    shapes and sizes (results and errors alike);
  * `DataParallel` and `FSDP` in one process (a one-rank gloo group the
    strategy starts itself and destroys at teardown) against
    `SingleDevice`: the same fit step for step, bitwise;
  * the strategies' refusals (unported axes, knobs and strategies,
    ``num_workers > devices``, `RayXlaPlugin(use_gpu=False)` without the
    CPU) and their env injection;
  * no module of the port, and no ``chip_*.py`` script, imports JAX or
    the JAX package.
"""
from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_lightning_tpu.parallel import mesh as jax_mesh
from ray_lightning_tpu.parallel.strategy import (
    fsdp_auto_spec as jax_fsdp_auto_spec,
)
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.parallel import mesh
from ray_lightning_tpu_torch.parallel.strategy import (
    FSDP,
    DataParallel,
    RayXlaPlugin,
    ShardedMesh,
    SingleDevice,
    fsdp_auto_spec,
)
from ray_lightning_tpu_torch.utils import devices
from tests import torch_jobs

SPECS = [dict(), dict(data=-1), dict(fsdp=-1), dict(data=2, fsdp=-1),
         dict(data=-1, tensor=2), dict(data=3), dict(data=2, fsdp=2),
         dict(data=-1, fsdp=-1), dict(seq=2, tensor=-1), dict(pipe=2)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_meshspec_resolve_matches_jax(spec, n):
    def run(cls):
        try:
            return cls(**spec).resolve(n).sizes()
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(mesh.MeshSpec) == run(jax_mesh.MeshSpec)


SHAPES = [(), (7,), (1024,), (4096,), (6, 1024), (1024, 6), (3, 5),
          (128256, 4096), (4096, 14336), (28672, 4096), (2, 3, 512),
          (64, 64), (1023,)]


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("min_size", [1, 2**10])
def test_fsdp_auto_spec_matches_jax(size, min_size):
    for shape in SHAPES:
        want = tuple(jax_fsdp_auto_spec(shape, size, min_size))
        assert fsdp_auto_spec(shape, size, min_size) == want, shape


@pytest.mark.parametrize("sizes", [dict(), dict(data=4), dict(fsdp=2),
                                   dict(data=2, fsdp=2, tensor=2),
                                   dict(tensor=4), dict(expert=2, seq=2)],
                         ids=str)
def test_dp_axes_match_jax(sizes):
    fake = types.SimpleNamespace(shape=sizes)
    assert mesh.dp_axis_names(sizes) == jax_mesh.dp_axis_names(fake)
    assert mesh.batch_size_divisor(sizes) == jax_mesh.batch_size_divisor(fake)


def test_topology_without_a_group():
    assert not dist.is_initialized()
    assert (mesh.process_index(), mesh.process_count(),
            mesh.global_device_count()) == (0, 1, 1)
    assert mesh.local_device_count() >= 1


@pytest.mark.parametrize("axis,item", [("tensor", "item 4"),
                                       ("seq", "item 13"),
                                       ("expert", "item 13"),
                                       ("pipe", "item 13")])
def test_unported_mesh_axes_raise(axis, item):
    """The seq, expert and pipe axes raise naming item 13. Item 4 brought
    the tensor axis: a mesh with it builds (here in a one-rank gloo
    group, kept at size one), and one the group cannot form raises."""
    if axis == "tensor":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            built = mesh.MeshSpec(tensor=-1).build("cpu", keep=("tensor",))
            assert built.mesh_dim_names == ("tensor",)
            assert mesh.batch_size_divisor(built) == 1
            with pytest.raises(ValueError, match="covers 2 devices"):
                mesh.MeshSpec(tensor=2).build("cpu")
        finally:
            dist.destroy_process_group()
        return
    with pytest.raises(NotImplementedError, match=item):
        mesh.MeshSpec(**{axis: 2}).build("cpu")
    with pytest.raises(NotImplementedError, match=item):
        mesh.make_mesh(device_type="cpu", **{axis: -1})


def _sharding_outcome(mod, loader, n, i, stage="train"):
    try:
        out = mod.ensure_sharded(loader, n, i, stage=stage)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e).split(".")[0].split(" (got")[0]
    if out is None or not hasattr(out, "num_shards"):
        return out
    return out.num_shards, out.shard_index


@pytest.mark.parametrize("case", [
    "unsharded", "same_shards", "other_shards", "stream", "stream_external",
    "external", "plain_list", "none", "one_process"])
def test_ensure_sharded_matches_jax(case):
    """The port's `ensure_sharded` injects, accepts and refuses what the
    JAX one does, with the same errors (up to the package name)."""
    from ray_lightning_tpu.core import data as jax_data
    from ray_lightning_tpu_torch.core import data as port_data

    arrays = {"x": np.arange(8)}

    def make(mod):
        return {
            "unsharded": (mod.DataLoader(arrays), 2, 1),
            "same_shards": (mod.DataLoader(arrays, num_shards=2,
                                           shard_index=1), 2, 1),
            "other_shards": (mod.DataLoader(arrays, num_shards=4,
                                            shard_index=1), 2, 1),
            "stream": (mod.DataLoader(lambda epoch: iter([arrays])), 2, 0),
            "stream_external": (mod.DataLoader(
                lambda epoch: iter([arrays]), sharded_externally=True), 2, 0),
            "external": (mod.DataLoader(arrays, sharded_externally=True),
                         2, 0),
            "plain_list": ([arrays], 2, 0),
            "none": (None, 2, 0),
            "one_process": ([arrays], 1, 0),
        }[case]

    got = _sharding_outcome(port_data, *make(port_data))
    want = _sharding_outcome(jax_data, *make(jax_data))
    if isinstance(want, tuple) and isinstance(want[1], str):
        # the messages name each package's own loader and rank query
        want = (want[0], want[1].replace(
            "ray_lightning_tpu ", "ray_lightning_tpu_torch ").replace(
            "jax.process_index()", "torch.distributed.get_rank()"))
    assert str(got) == str(want)


def test_resolve_loaders():
    from ray_lightning_tpu_torch.core.data import (
        DataLoader,
        DataModule,
        resolve_loaders,
    )

    class DM(DataModule):
        def train_dataloader(self):
            return "train"

        def val_dataloader(self):
            return "val"

    assert resolve_loaders(None, DM()) == ("train", "val")
    loader = DataLoader({"x": np.zeros(2)})
    assert resolve_loaders(None, loader) == (loader, None)


def test_unported_strategy_knobs_raise():
    """``overlap=`` is ported (FSDP2 prefetch; held bitwise by
    tests/test_torch_overlap.py); an unknown schedule raises. `ShardedMesh`
    is ported with its tensor axis (item 4); its seq axis still raises,
    naming item 13."""
    assert FSDP(overlap="on", device="cpu").overlap == "on"
    assert DataParallel(overlap="serial", device="cpu").overlap == "serial"
    with pytest.raises(ValueError, match="overlap"):
        DataParallel(overlap="sometimes")
    assert ShardedMesh(data=2, tensor=2).build_spec(4).sizes()["tensor"] == 2
    for axis in ("seq", "pipe", "expert"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            ShardedMesh(**{axis: 2}, device="cpu")
    assert not dist.is_initialized()


def test_num_workers_beyond_devices_raise(monkeypatch):
    # one process drives one device: two workers need two processes
    with pytest.raises(ValueError, match="num_workers > devices"):
        DataParallel(num_workers=2, device="cpu").setup()
    assert not dist.is_initialized()
    # on a host with one card, a second process has none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="num_workers > devices"):
        devices.rank_device(None, 0, num_processes=2)
    assert devices.rank_device(None, 0, 1) == torch.device("cuda", 0)
    monkeypatch.setenv(devices.LOCAL_RANK_ENV, "3")
    assert devices.rank_device("cuda", None, 1) == torch.device("cuda", 3)
    assert devices.rank_device("cpu", 5, 8) == torch.device("cpu")


def test_ray_xla_plugin_device_rule_and_env(monkeypatch):
    monkeypatch.delenv("RLT_NUM_CPUS_PER_WORKER", raising=False)
    with pytest.raises(ValueError, match="use_gpu=False"):
        RayXlaPlugin(num_workers=1, use_gpu=False)
    with pytest.raises(ValueError, match="both"):
        RayXlaPlugin(use_gpu=True, device="cpu")
    hook_ran = []
    p = RayXlaPlugin(num_workers=1, num_cpus_per_worker=3, use_gpu=False,
                     device="cpu", init_hook=lambda: hook_ran.append(1))
    assert isinstance(p, DataParallel) and p.num_cpus_per_worker == 3
    try:
        assert p.setup() == torch.device("cpu")
        # recorded only: nothing in the port reads it yet
        assert "RLT_NUM_CPUS_PER_WORKER" not in os.environ
        assert hook_ran == [1]
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert p.mesh_shape == {"data": 1} and p.world_size == 1
    finally:
        p.teardown()
    assert not dist.is_initialized()


def _fit(strategy, params_np, toks, mask, **kw):
    rec = torch_jobs.StepRecorder()
    module = torch_jobs.llama_module(params_np, **kw)
    trainer = Trainer(strategy=strategy, max_steps=4, gradient_clip_val=0.5,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, callbacks=[rec], seed=0)
    try:
        trainer.fit(module, torch_jobs.llama_data(toks, mask, 2))
        params = {k: v.detach().clone() for k, v in
                  trainer.strategy.unwrap(module.model).state_dict().items()}
        wrapped = type(module.model).__name__
    finally:
        strategy.teardown()
    return rec.rows, params, wrapped


@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_group_strategies_in_process_match_single_device(name):
    """`DataParallel` / `FSDP` in one process (the one-rank gloo group the
    strategy starts) give `SingleDevice`'s fit bitwise: at world size 1
    the collectives move nothing and the arithmetic is the same."""
    params_np = None  # the port's own seeded initialisation
    toks = torch_jobs.tokens(8, 12, seed=4)
    mask = (np.random.default_rng(5).random((8, 12)) > 0.3).astype(
        np.float32)
    kw = dict(fused_ce=True, ce_chunk_tokens=16, remat=True)
    ref_rows, ref_params, _ = _fit(SingleDevice(device="cpu"), params_np,
                                   toks, mask, **kw)
    strategy = torch_jobs.make_strategy(name)
    rows, params, wrapped = _fit(strategy, params_np, toks, mask, **kw)
    assert not dist.is_initialized()  # teardown destroyed the group
    assert wrapped == ("DistributedDataParallel" if name == "ddp"
                       else "FSDPLlama")
    assert rows == ref_rows and len(rows) == 4
    assert max(g for _, g in rows) > 0.5  # the clip bites
    for k, v in ref_params.items():
        got = params[k]
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        assert torch.equal(got, v), k


def test_fsdp_placement_follows_the_jax_rule():
    """The placement callback shards each parameter on the dimension
    `fsdp_auto_spec` picks for its shape; where the JAX rule replicates,
    FSDP2 (which has no replicated placement) shards dimension 0."""
    strategy = FSDP(device="cpu", min_shard_size=64)
    strategy.mesh = types.SimpleNamespace(mesh_dim_names=("fsdp",),
                                          shape=(4,))
    for shape, dim in (((8, 100), 1), ((100, 8), 0), ((3, 5), None),
                       ((12,), None), ((256,), 0), ((6, 30), None)):
        placement = strategy._placement(torch.empty(shape))
        assert (placement.dim if placement is not None else None) == dim
