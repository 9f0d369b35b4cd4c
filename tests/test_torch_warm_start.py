"""The port's warm start and kernel cache (`pipeline/compile_cache.py`,
``Trainer(warm_start=, compile_cache_dir=)``) against
`tests/test_warm_start.py`'s contracts and the JAX ledger.

With ``warm_start=True`` both packages put a ``compile`` span before the
first step into the span file and the warm start's seconds into the
goodput ledger's ``compile_s``; the port's warm-up (one forward and
backward of the first batch, its gradients dropped) leaves the weights,
the optimizer and schedule state, the trainguard's statistics, the step
counters and the random streams as they were, so a warm-started fit is
bitwise the fit without. `plan_cache_key`/`plan_cache_dir` equal the
JAX functions; ``compile_cache_dir`` moves the kernel build directory.
Differences by design: a failing warm-up raises (JAX falls back to lazy
jit) and a later batch of another shape needs nothing.
"""
from __future__ import annotations

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu.pipeline import compile_cache as jcc
from ray_lightning_tpu.telemetry import goodput as jgoodput
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.ops import build
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.pipeline import compile_cache as pcc
from ray_lightning_tpu_torch.resilience.guard import GuardConfig
from ray_lightning_tpu_torch.telemetry import goodput as pgoodput
from ray_lightning_tpu_torch.telemetry import spans as pspans
from tests import torch_jobs

STEPS = 4
COMMON = dict(max_steps=STEPS, log_every_n_steps=1,
              enable_checkpointing=False, enable_progress_bar=False, seed=0)


def _jax_params():
    jcfg = JaxConfig(**torch_jobs.TINY, dtype=jnp.float32, remat=False)
    params = JaxLlama(jcfg).init(jax.random.key(2),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
    return jcfg, jax.tree.map(np.asarray, params)


def _fit(root, *, warm_start=True, guard=None, toks=None, drop_last=True,
         callbacks=(), **kw):
    _, params = _jax_params()
    rec = torch_jobs.StepRecorder()
    module = torch_jobs.llama_module(params, total_steps=STEPS)
    trainer = Trainer(strategy=SingleDevice(device="cpu"),
                      callbacks=[rec, *callbacks], warm_start=warm_start,
                      default_root_dir=str(root), guard=guard,
                      **{**COMMON, **kw})
    toks = torch_jobs.tokens(8, 12, seed=4) if toks is None else toks
    trainer.fit(module, DataLoader({"tokens": toks}, batch_size=2,
                                   drop_last=drop_last))
    return trainer, module, rec.rows


def _compile_then_steps(tdir):
    [path] = glob.glob(os.path.join(tdir, "rank0.*.spans.jsonl"))
    spans = pspans.read_spans(path)["spans"]
    [warm] = [s for s in spans if s["phase"] == "compile"]
    first = min(s["t"] for s in spans if s["phase"] == "dispatch")
    return warm, first


def test_compile_span_before_the_first_step_in_both_ledgers(tmp_path):
    """The same fit in both packages with telemetry and the warm start
    on: each span file holds one compile span ending before the first
    dispatch, and each ledger books it as compile_s (> 0)."""
    jcfg, params = _jax_params()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=STEPS)
    jm.params = jax.tree.map(jnp.asarray, params)
    toks = torch_jobs.tokens(8, 12, seed=4)
    JaxTrainer(strategy=JaxSingle(), telemetry=True, warm_start=True,
               default_root_dir=str(tmp_path / "jax"), **COMMON).fit(
        jm, JaxDataLoader({"tokens": toks}, batch_size=2))
    trainer, _, _ = _fit(tmp_path / "torch", telemetry=True)
    for name in ("jax", "torch"):
        tdir = str(tmp_path / name / "telemetry")
        warm, first = _compile_then_steps(tdir)
        assert warm["t"] + warm["dur"] <= first, name
        assert warm["meta"] == {"label": "train_step"}, name
        [led] = jgoodput.read_ledgers(tdir)
        assert led == pgoodput.read_ledgers(tdir)[0]
        assert led["buckets"]["compile_s"] > 0, name
    m = trainer.callback_metrics
    assert m["compile_time_s"] == pytest.approx(
        m["compile_build_s"] + m["compile_warm_s"])
    assert m["compile_time_s"] > 0 and m["compile_build_s"] == 0.0


def test_warm_and_cold_fits_are_bitwise_equal(tmp_path):
    """Warm start on or off (the prefetcher on in both): the same
    per-step rows and bit-identical weights, guard on and off."""
    for guard in (None, GuardConfig()):
        _, m_warm, rows_warm = _fit(tmp_path / "w", guard=guard)
        _, m_cold, rows_cold = _fit(tmp_path / "c", warm_start=False,
                                    guard=guard)
        assert rows_warm == rows_cold and len(rows_warm) == STEPS
        for k, v in m_warm.params.items():
            assert torch.equal(v, m_cold.params[k]), k


def _snapshot(trainer):
    state = trainer.state
    snap = {
        "params": {k: v.detach().clone()
                   for k, v in trainer.module.params.items()},
        "param_groups": copy.deepcopy(
            state.optimizer.state_dict()["param_groups"]),
        "scheduler": copy.deepcopy(state.scheduler.state_dict()),
        "step": state.step,
        "global_step": trainer.global_step,
        "rec_step": trainer.telemetry_recorder._step,
        "rng": torch.get_rng_state(),
        "guard": {k: v.clone() for k, v in vars(state.guard).items()
                  if isinstance(v, torch.Tensor)},
        "updates": state.updates.clone(),
    }
    return snap


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_warm_up_leaves_the_state_untouched(tmp_path, monkeypatch):
    """Around the warm-up itself: the parameters, the optimizer's
    hyperparameters, `DeviceLambdaLR`'s position, the guard's
    statistics, the step counters (trainer, state, telemetry) and the
    global random state are as they were, and no gradient is left
    behind; the module's logged metrics of the warm-up are dropped. The
    fused AdamW's state is built, as its lazy first step builds it: a
    zero step count and zero moments."""
    seen = {}
    orig = Trainer._warm_start_train_step

    def wrapped(self, example_batch):
        before = _snapshot(self)
        assert not self.state.optimizer.state
        orig(self, example_batch)
        after = _snapshot(self)
        _assert_same(before, after)
        opt = self.state.optimizer
        assert "found_inf" not in vars(opt)
        assert len(opt.state) == len(self.module.params)
        for st in opt.state.values():
            assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
            assert all(not v.any() for v in st.values())
        assert all(p.grad is None for p in self.module.params.values())
        assert self.module.pop_logged() == {}
        seen["ok"] = self.callback_metrics["compile_time_s"]

    monkeypatch.setattr(Trainer, "_warm_start_train_step", wrapped)
    _fit(tmp_path, guard=GuardConfig(), telemetry=True)
    assert seen["ok"] > 0


def test_plan_cache_key_and_dir_match_jax(tmp_path):
    for parts in ((), ("FSDP", [("fsdp", 2)], "cuda"),
                  ("DataParallel", 1, "LlamaModule")):
        assert pcc.plan_cache_key(*parts) == jcc.plan_cache_key(*parts)
        assert pcc.plan_cache_dir(str(tmp_path), *parts) == \
            jcc.plan_cache_dir(str(tmp_path), *parts)
    assert len(pcc.plan_cache_key("x")) == 16


def test_compile_cache_dir_moves_the_kernel_build_dir(tmp_path,
                                                      monkeypatch):
    """`enable_persistent_cache` points the nvcc build-and-load directory
    at the caller's (created; the last caller wins); a library's file
    name keeps its source digest."""
    monkeypatch.setattr(build, "BUILD", build.BUILD)
    name = "rmsnorm"
    digest = os.path.basename(build._lib_path(name))
    for sub in ("a", "b"):
        d = pcc.enable_persistent_cache(str(tmp_path / sub))
        assert d == str(tmp_path / sub) and os.path.isdir(d)
        assert pcc.active_cache_dir() == d
        assert build._lib_path(name) == os.path.join(d, digest)


def test_failing_warm_up_raises(tmp_path, monkeypatch):
    """No fallback: a warm-up that fails fails the fit (the JAX package
    falls back to lazy jit; the port has no other path that would not
    fail the same way), and the loop never starts."""
    class Boom(RuntimeError):
        pass

    def boom(self, batch):
        raise Boom("warm-up failed")

    monkeypatch.setattr(Trainer, "_warm_up", boom)
    with pytest.raises(Boom, match="warm-up failed"):
        trainer, _, rows = _fit(tmp_path)
    trainer, _, rows = _fit(tmp_path, warm_start=False)
    assert len(rows) == STEPS


def test_a_ragged_batch_after_the_warm_up_needs_nothing(tmp_path):
    """Shape drift: the warm-up ran at the first batch's shape, a ragged
    last batch then just runs (nothing was compiled for one shape);
    bitwise the fit without a warm start."""
    toks = torch_jobs.tokens(7, 12, seed=4)  # 3 full batches and a 1
    kw = dict(toks=toks, drop_last=False, max_steps=-1)
    _, m_warm, rows_warm = _fit(tmp_path / "w", **kw)
    _, m_cold, rows_cold = _fit(tmp_path / "c", warm_start=False, **kw)
    assert rows_warm == rows_cold and len(rows_warm) == 4
    for k, v in m_warm.params.items():
        assert torch.equal(v, m_cold.params[k]), k


def test_warm_step_records_a_compile_span_and_the_build_split(monkeypatch):
    """`WarmStep`: calls pass through to the step; ``warm`` runs the
    warm-up once under a compile span and splits its seconds into the
    kernel libraries' build and load and the rest."""
    rec = pspans.TelemetryRecorder()
    calls = []
    clock = iter([0.0, 0.25])
    monkeypatch.setattr(build, "build_seconds", lambda: next(clock))
    ws = pcc.WarmStep(lambda x: calls.append(("step", x)) or x * 2,
                      warm_up=lambda x: calls.append(("warm", x)),
                      label="train_step", recorder=rec)
    assert not ws.warmed
    stats = ws.warm(3)
    assert ws.warmed and calls == [("warm", 3)]
    assert stats.build_s == 0.25
    assert stats.warm_s == max(0.0, stats.total_s - 0.25)
    assert rec.phase_totals()["compile"] > 0
    assert ws(5) == 10 and calls[-1] == ("step", 5)
    m = stats.to_metrics("val_")
    assert set(m) == {"val_compile_time_s", "val_compile_build_s",
                      "val_compile_warm_s"}
