"""The port's resharding restore (`elastic/reshard.py`, the trainer's
cross-mesh resume) against the JAX package's (the cases of
tests/test_reshard.py), on the CPU.

`validate_reshard` gives the JAX summary (and the JAX refusal) on the
same meta dicts. A checkpoint written by a two-process ``FSDP`` fit
(fsdp=2) of the tiny Llama restores bitwise — parameters, AdamW moments
and step counts, the scheduler and the trainer's step — onto one
process (world 1), and through ``ShardedMesh(tensor=2)`` and back to
fsdp=2: the fused QKV and gate-up rows are permuted head-aligned inside
the tensor ranks and canonical in every checkpoint, so the round trip
undoes the permutation exactly. A ``DataParallel`` (data=2) checkpoint
restores bitwise onto fsdp=2. Each move is the trainer's own
(`Trainer._reshard_move`), recorded as a `reshard` span. The world-1
resume trains on within 2e-5 of the JAX package's cross-mesh resume
(fsdp=2 -> 1) at the same seed, the skipped batches counted as the JAX
trainer counts them (the saved epoch offset, in the new loader's
batches).
"""
from __future__ import annotations

import functools
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.callbacks import ModelCheckpoint as JaxCkpt
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.elastic import reshard as jreshard
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import FSDP as JaxFSDP
from ray_lightning_tpu_torch.checkpoint.io import (
    read_meta,
    verify_checkpoint,
)
from ray_lightning_tpu_torch.elastic import (
    ReshardError,
    checkpoint_provenance,
    reshard_restore,
    validate_reshard,
)
from ray_lightning_tpu_torch.runtime import fit_distributed, launch
from tests import torch_jobs

T = 180          # seconds one distributed run may take
N, S, B = 16, 12, 2   # rows, sequence, per-rank batch

# ---- validate_reshard: the JAX summaries on the same meta dicts -------------

META_8 = {"mesh_spec": {"data": 1, "fsdp": 8, "tensor": 1},
          "topology": {"n_devices": 8},
          "param_specs": {"w": [None, "fsdp"]}}
META_2 = {"mesh_spec": {"fsdp": 2}, "topology": {"n_devices": 2},
          "param_specs": {"lm_head": ["fsdp", None], "norm": []}}
META_TP = {"mesh_spec": {"data": 1, "fsdp": 1, "tensor": 2},
           "topology": {"n_devices": 2, "process_count": 2},
           "param_specs": {"layers.0.wqkv": ["tensor", None],
                           "layers.0.wo": [None, "tensor"]}}

MOVES = {
    "fsdp8_to_data2_fsdp2": (META_8, {"data": 2, "fsdp": 2}),
    "fsdp8_unchanged": (META_8, {"fsdp": 8}),
    "fsdp2_to_world1": (META_2, {"fsdp": 1}),
    "fsdp2_to_single": (META_2, {}),
    "fsdp2_to_tensor2": (META_2, {"data": 1, "fsdp": 1, "tensor": 2}),
    "tensor2_to_fsdp2": (META_TP, {"fsdp": 2}),
    "tensor2_to_data2": (META_TP, {"data": 2, "fsdp": 1, "tensor": 1}),
    "fsdp2_to_fsdp2_tensor2": (META_2, {"fsdp": 2, "tensor": 2}),
    # refusals: no provenance, contradictory provenance, an alien axis,
    # malformed targets
    "legacy": ({"global_step": 3}, {"fsdp": 2}),
    "contradictory": ({**META_2, "topology": {"n_devices": 3}},
                      {"fsdp": 1}),
    "alien_axis": ({**META_2, "param_specs": {"w": [None, "bogus"]}},
                   {"fsdp": 1}),
    "zero_axis": (META_2, {"fsdp": 0}),
    "non_integer": (META_2, {"fsdp": "two"}),
}


@pytest.mark.parametrize("move", sorted(MOVES))
def test_validate_reshard_equals_jax(move):
    meta, target = MOVES[move]
    try:
        want = jreshard.validate_reshard(meta, target)
    except jreshard.ReshardError as exc:
        with pytest.raises(ReshardError) as pe:
            validate_reshard(meta, target)
        assert str(pe.value) == str(exc)
        return
    assert validate_reshard(meta, target) == want


# ---- the two-process checkpoints -------------------------------------------


def _params():
    jcfg = JaxConfig(**torch_jobs.TINY, dtype=jnp.float32, remat=False,
                     fused_ce=False, ce_chunk_tokens=16)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    return jcfg, params


CFG_KW = dict(fused_ce=False, remat=False, ce_chunk_tokens=16)


def _fit(strategy, world, tmp, *, ckpt_path=None, max_steps=2,
         ckpt_dir=None, every=None, extra=("FitStartState", "FitEndState"),
         telemetry=None, **strategy_kw):
    """One port fit in ``world`` gloo processes; returns
    ({tag: {rank: payload}}, rows, FitResult)."""
    _, params = _params()
    toks = torch_jobs.tokens(N, S, seed=4)
    got: dict = {}
    rows: list = []

    def collect(rank, item):
        if item[0] == "row":
            rows.append(item[1:])
        else:
            got.setdefault(item[0], {})[item[1]] = item[2:]

    res = fit_distributed(
        functools.partial(torch_jobs.llama_module, params, **CFG_KW),
        functools.partial(torch_jobs.trainer, strategy=strategy,
                          max_steps=max_steps, ckpt_dir=ckpt_dir,
                          every_n_train_steps=every, extra=extra,
                          telemetry=telemetry, **strategy_kw),
        functools.partial(torch_jobs.llama_data, toks, None, B), world,
        device="cpu", on_queue_item=collect, timeout=T,
        ckpt_path=ckpt_path, return_weights=False,
        log_dir=os.path.join(tmp, "logs"))
    return got, rows, res


#: a fresh fit's probes: only the end state (reading the optimizer's
#: state dict before its first step would build that state with a step)
_FRESH = ("FitEndState",)


def _same(a, b, where=""):
    """Bitwise equality of two `torch_jobs.resume_state` payloads."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def fsdp_ckpt(tmp_path_factory):
    """Two ranks under FSDP train 2 steps (mid-epoch: 4 batches a rank)
    and save at step 2: the checkpoint, the saved state, the rows."""
    tmp = str(tmp_path_factory.mktemp("fsdp2"))
    got, rows, res = _fit("fsdp", 2, tmp, ckpt_dir=os.path.join(tmp, "ck"),
                          every=2, extra=_FRESH)
    return res.best_model_path, got["end"][0][0], rows, tmp


def test_provenance_stamped_and_verified(fsdp_ckpt):
    path = fsdp_ckpt[0]
    meta = read_meta(path)
    assert meta["mesh_spec"] == {"fsdp": 2}
    assert meta["topology"]["n_devices"] == 2
    assert meta["topology"]["process_count"] == 2
    assert meta["param_specs"]["lm_head"] == ["fsdp", None]
    prov = checkpoint_provenance(path)
    assert set(prov) == {"mesh_spec", "topology", "param_specs"}
    assert prov == jreshard.checkpoint_provenance(path)
    assert verify_checkpoint(path) == (True, "ok")
    assert meta["mid_epoch"] is True and meta["epoch_batch"] == 2


def _copy_with_meta(src, dst, **edit):
    shutil.copytree(src, dst)
    mp = os.path.join(dst, "meta.json")
    with open(mp) as f:
        meta = json.load(f)
    for k, v in edit.items():
        if v is None:
            meta.pop(k, None)
        else:
            meta[k] = v
    with open(mp, "w") as f:
        json.dump(meta, f)
    return dst


def test_provenance_tampering_and_legacy_refused(fsdp_ckpt, tmp_path):
    path = fsdp_ckpt[0]
    bad = _copy_with_meta(path, str(tmp_path / "bad"),
                          topology={"n_devices": 3})
    ok, reason = verify_checkpoint(bad)
    assert not ok and "provenance mismatch" in reason
    with pytest.raises(ReshardError, match="invalid checkpoint"):
        reshard_restore(bad, {}, mesh={})
    alien = _copy_with_meta(path, str(tmp_path / "alien"),
                            param_specs={"w": [None, "bogus_axis"]})
    ok, reason = verify_checkpoint(alien)
    assert not ok and "bogus_axis" in reason
    legacy = _copy_with_meta(path, str(tmp_path / "legacy"),
                             mesh_spec=None, topology=None,
                             param_specs=None)
    assert verify_checkpoint(legacy) == (True, "ok")
    assert checkpoint_provenance(legacy) == {}
    with pytest.raises(ReshardError, match="no sharding provenance"):
        reshard_restore(legacy, {}, mesh={"fsdp": 1})
    # no layout to restore into: named, not guessed
    with pytest.raises(ReshardError, match="holds no DTensor"):
        reshard_restore(path, {"params": {}})


def test_torn_checkpoint_refused(fsdp_ckpt, tmp_path):
    torn = str(tmp_path / "torn")
    shutil.copytree(fsdp_ckpt[0], torn)
    os.remove(os.path.join(torn, "meta.json"))
    with pytest.raises(ReshardError, match="invalid checkpoint"):
        reshard_restore(torn, {}, mesh={})
    partial = str(tmp_path / "partial")
    shutil.copytree(fsdp_ckpt[0], partial)
    os.remove(sorted(glob.glob(os.path.join(partial, "state",
                                            "*.distcp")))[0])
    if read_meta(partial).get("ckpt_digest"):
        with pytest.raises(ReshardError, match="invalid checkpoint"):
            reshard_restore(partial, {}, mesh={})


class _JaxRows(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((trainer.global_step, float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def _jax_cross_mesh_rows(tmp):
    """The JAX package's fsdp=2 fit saved at step 2 and resumed on one
    device (its `_reshard_move`), fed what the port's ranks see: the
    global batches of the two ranks, then the world-1 loader's batches
    (the resume skips the saved epoch offset, 2, of them)."""
    jcfg, params = _params()
    toks = torch_jobs.tokens(N, S, seed=4)
    half = N // 2
    first = [{"tokens": toks[np.r_[k * B:(k + 1) * B,
                                   half + k * B:half + (k + 1) * B]]}
             for k in range(half // B)]
    rec = _JaxRows()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=4)
    jm.params = jax.tree.map(jnp.asarray, params)
    ckdir = os.path.join(tmp, "jax_ck")
    JaxTrainer(strategy=JaxFSDP(num_workers=2),
               callbacks=[rec, JaxCkpt(dirpath=ckdir, every_n_train_steps=2,
                                       save_top_k=-1)],
               max_steps=2, log_every_n_steps=1,
               enable_checkpointing=False, enable_progress_bar=False,
               seed=0).fit(jm, first)
    path = sorted(glob.glob(os.path.join(ckdir, "*")))[-1]
    second = [{"tokens": toks[k * B:(k + 1) * B]} for k in range(N // B)]
    rec2 = _JaxRows()
    t2 = JaxTrainer(strategy=JaxFSDP(num_workers=1), callbacks=[rec2],
                    max_steps=4, log_every_n_steps=1,
                    enable_checkpointing=False, enable_progress_bar=False,
                    seed=0)
    t2.fit(JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=4),
           second, ckpt_path=path)
    return rec.rows, rec2.rows, jax.tree.map(np.asarray, jm.params)


def test_fsdp2_to_world1_bitwise_and_trains_as_jax(fsdp_ckpt, tmp_path):
    """The trainer's own cross-mesh resume: every leaf bitwise the saved
    state, the move recorded as a `reshard` span and in the goodput
    ledger, and steps 3-4 within 2e-5 of the JAX cross-mesh resume."""
    path, saved, rows_a, _ = fsdp_ckpt
    tdir = str(tmp_path / "telemetry")
    got, rows, _ = _fit("fsdp", 1, str(tmp_path), ckpt_path=path,
                        max_steps=4, telemetry=tdir)
    state, move = got["start"][0]
    _same(saved, state)
    assert move["from_mesh"] == {"fsdp": 2} and move["to_mesh"] == {}
    assert move["changed_axes"] == ["fsdp"]
    assert (move["from_world"], move["to_world"]) == (2, 1)
    spans = [json.loads(ln) for f in glob.glob(
        os.path.join(tdir, "rank*.spans.jsonl")) for ln in open(f)]
    reshard = [s for s in spans if s.get("phase") == "reshard"]
    assert len(reshard) == 1
    assert reshard[0]["meta"]["changed_axes"] == ["fsdp"]
    ledgers = glob.glob(os.path.join(tdir, "ledger.rank0.*.json"))
    assert len(ledgers) == 1
    assert json.load(open(ledgers[0]))["buckets"]["reshard_s"] > 0
    jrows_a, jrows, _ = _jax_cross_mesh_rows(str(tmp_path))
    assert [r[0] for r in rows] == [3, 4] == [r[0] for r in jrows]
    np.testing.assert_allclose([r[1:] for r in rows_a],
                               [r[1:] for r in jrows_a],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose([r[1:] for r in rows],
                               [r[1:] for r in jrows],
                               rtol=2e-5, atol=2e-5)


def test_fsdp2_tensor2_fsdp2_round_trip_bitwise(fsdp_ckpt, tmp_path):
    """fsdp=2 -> ShardedMesh(tensor=2): each rank restores its heads of
    the canonical rows (every leaf, gathered canonical, bitwise the
    saved state); one step there; its step-3 checkpoint back on fsdp=2
    restores bitwise what the tensor ranks held: the permutation undone
    both ways."""
    path, saved, _, _ = fsdp_ckpt
    ck = str(tmp_path / "tp_ck")
    got, _, res = _fit("sharded", 2, str(tmp_path), ckpt_path=path,
                       max_steps=3, ckpt_dir=ck, every=1, tensor=2)
    for rank in (0, 1):
        state, move = got["start"][rank]
        _same(saved, state)
        assert move["changed_axes"] == ["fsdp", "tensor"]
        assert move["world_change"] is False
    tp_end = got["end"][0][0]
    assert tp_end[3] == 3
    tp_path = os.path.join(ck, "step=3")
    assert read_meta(tp_path)["mesh_spec"]["tensor"] == 2
    back, _, _ = _fit("fsdp", 2, str(tmp_path / "back"), ckpt_path=tp_path,
                      max_steps=3)
    for rank in (0, 1):
        state, move = back["start"][rank]
        _same(tp_end, state)
        assert move["changed_axes"] == ["fsdp", "tensor"]


def test_data2_to_fsdp2_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    got, _, res = _fit("ddp", 2, str(tmp_path), ckpt_dir=ck, every=2,
                       extra=_FRESH)
    saved = got["end"][0][0]
    path = res.best_model_path
    assert read_meta(path)["mesh_spec"] == {"data": 2}
    moved, _, _ = _fit("fsdp", 2, str(tmp_path / "fsdp"), ckpt_path=path,
                       max_steps=2)
    for rank in (0, 1):
        state, move = moved["start"][rank]
        _same(saved, state)
        assert move["changed_axes"] == ["data", "fsdp"]


def test_reshard_arrays_in_memory(tmp_path):
    out = launch(torch_jobs.reshard_arrays_job, 2, device="cpu", timeout=T,
                 log_dir=str(tmp_path / "logs"))
    for verdict in out:
        assert verdict == {k: True for k in verdict}, verdict


@pytest.mark.parametrize("strategy_kw", [dict(tensor=2),
                                         dict(fsdp=2, tensor=2)],
                         ids=["tensor2", "fsdp2_tensor2"])
def test_restore_target_is_the_canonical_layout_without_a_gather(
        strategy_kw, tmp_path):
    """`ShardedMesh.restore_target` against `state_dicts` after a step:
    the same keys and layouts, the unfused leaves the live storage, and
    no fused row gathered to build it."""
    _, params = _params()
    world = 2 * strategy_kw.get("fsdp", 1)
    out = launch(torch_jobs.restore_target_job, world,
                 args=(params, torch_jobs.tokens(N, S, seed=4)[:2 * world],
                       CFG_KW, strategy_kw),
                 device="cpu", timeout=T, log_dir=str(tmp_path / "logs"))
    for verdict in out:
        assert verdict == {k: True for k in verdict}, \
            {k: v for k, v in verdict.items() if v is not True}


def test_full_value_gathers_as_full_tensor(tmp_path):
    """`parallel.tensor.full_value` (c10d's all-gather, which gloo
    carries for CUDA tensors where DTensor's functional collectives
    crash) equals ``full_tensor`` on four ranks: uneven shards, two mesh
    dimensions on one tensor dimension, replicated dimensions."""
    out = launch(torch_jobs.full_value_job, 4, device="cpu", timeout=T,
                 log_dir=str(tmp_path / "logs"))
    for verdict in out:
        assert verdict == {k: True for k in verdict}, verdict
