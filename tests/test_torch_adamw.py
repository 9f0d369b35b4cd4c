"""The port's AdamW with a narrow first moment (`core.optim.MuAdamW`, the
plain version of `ops/kernels/adamw.py`) against optax's
``adamw(mu_dtype=...)``, the JAX `LlamaModule(mu_dtype=...)`'s optimizer,
on the CPU.

  * five steps of the plain version against optax on the same seeded
    parameters and gradients: parameters and the second moment within
    1e-6 relative (the bias corrections' powers are the only operations
    computed differently: XLA's and torch's f32 ``pow`` part by one ulp
    near 1), the first moment within one bf16 ulp (it is the rounding of
    values that agree to 1e-6);
  * the ``found_inf`` skip leaves parameters, moments and step counts
    bitwise as they were; the tensor lr is the one the step takes;
  * the wrapper runs the plain version on CPU tensors and counts no
    launch; `MuAdamW`'s state keeps its first moment in bf16 through a
    state-dict round trip; the trainguard accepts it under
    `DeviceLambdaLR`;
  * `LlamaModule(mu_dtype=)` fits the tiny Llama as the JAX module does:
    at 2e-5 with an f32 moment (torch's fused AdamW), at the bound of
    bf16 rounding flips with a bf16 one (`MU_FIT_CASES`), its ``exp_avg``
    bf16 and half the bytes;
  * a two-process gloo `fit_distributed` under FSDP with the bf16 moment,
    saved at step 2 and resumed bitwise.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 15.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.optim import MuAdamW
from ray_lightning_tpu_torch.core.schedule import DeviceLambdaLR
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    params_from_jax,
)
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.kernels import launch_counts
from ray_lightning_tpu_torch.ops.kernels.adamw import (
    adamw_bytes,
    adamw_step_kernel,
    adamw_step_plain,
)
from ray_lightning_tpu_torch.parallel.plan import optimizer_state_bytes
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience.guard import check_guardable
from ray_lightning_tpu_torch.runtime.fit import fit_distributed
from tests import torch_jobs

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
SHAPES = [(33, 7), (4096,), (5, 3, 11)]


def _state(seed: int, mu_dtype):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -k
              for s in SHAPES] for k in range(5)]
    return params, grads


def _plain_run(params, grads, mu_dtype, lrs, found=None):
    p = [torch.tensor(x) for x in params]
    m = [torch.zeros_like(x, dtype=mu_dtype) for x in p]
    v = [torch.zeros_like(x) for x in p]
    s = [torch.zeros(()) for _ in p]
    for k, (g, lr) in enumerate(zip(grads, lrs)):
        fi = None if found is None else torch.tensor(float(found[k]))
        adamw_step_plain(p, [torch.tensor(x) for x in g], m, v, s,
                         torch.tensor(lr, dtype=torch.float32), fi, B1, B2,
                         EPS, WD)
    return p, m, v, s


@pytest.mark.parametrize("mu", ["bfloat16", "float32"])
def test_plain_matches_optax_adamw(mu):
    """Five steps at lrs 1e-3..5e-3 (a schedule: optax reads the step's
    lr, the port its tensor lr) against ``optax.adamw(mu_dtype=)``."""
    params, grads = _state(0, mu)
    lrs = [1e-3 * (k + 1) for k in range(5)]
    tx = optax.adamw(lambda c: jnp.asarray(lrs)[c], b1=B1, b2=B2, eps=EPS,
                     weight_decay=WD, mu_dtype=getattr(jnp, mu))
    jp = [jnp.asarray(x) for x in params]
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
    adam = st[0]
    p, m, v, s = _plain_run(params, grads, getattr(torch, mu), lrs)
    for i in range(len(SHAPES)):
        np.testing.assert_allclose(p[i].numpy(), np.asarray(jp[i]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(v[i].numpy(), np.asarray(adam.nu[i]),
                                   rtol=1e-6, atol=0)
        jm = np.asarray(adam.mu[i].astype(jnp.float32))
        assert m[i].dtype == getattr(torch, mu)
        got = m[i].float().numpy()
        # one ulp of the stored dtype at each element's magnitude
        ulp = np.abs(jm) * (2.0 ** -7 if mu == "bfloat16" else 2.0 ** -23)
        assert np.all(np.abs(got - jm) <= ulp), (
            i, float(np.abs(got - jm).max()))
        assert float(s[i]) == 5.0


def test_found_inf_skips_bitwise_and_lr_tensor_is_read():
    params, grads = _state(1, "bfloat16")
    lrs = [2e-3] * 5
    ref = _plain_run(params, grads[:3], torch.bfloat16, lrs[:3])
    # steps 0, 1, skip, 2: the skipped step's gradient leaves no trace
    skipped = _plain_run(params, grads[:2] + [grads[4], grads[2]],
                         torch.bfloat16, lrs[:4], found=[0, 0, 1, 0])
    for a, b in zip(ref, skipped):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # the lr is read from its tensor: lr 0 moves nothing but the moments
    p0, _, _, _ = _plain_run(params, grads[:1], torch.bfloat16, [0.0])
    for x, y in zip(p0, params):
        assert torch.equal(x, torch.tensor(y))
    p1, _, _, _ = _plain_run(params, grads[:1], torch.bfloat16, [1e-2])
    p2, _, _, _ = _plain_run(params, grads[:1], torch.bfloat16, [2e-2])
    d1 = (p1[0] - torch.tensor(params[0])).abs().max()
    d2 = (p2[0] - torch.tensor(params[0])).abs().max()
    assert float(d2) == pytest.approx(2 * float(d1), rel=1e-3)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    params, grads = _state(2, "bfloat16")
    adamw_step_kernel.launches = 0
    a = _plain_run(params, grads[:2], torch.bfloat16, [1e-3, 1e-3])
    p = [torch.tensor(x) for x in params]
    m = [torch.zeros_like(x, dtype=torch.bfloat16) for x in p]
    v = [torch.zeros_like(x) for x in p]
    s = [torch.zeros(()) for _ in p]
    for g in grads[:2]:
        adamw_step_kernel(p, [torch.tensor(x) for x in g], m, v, s,
                          torch.tensor(1e-3), None, B1, B2, EPS, WD)
    for x, y in zip(a[0] + a[1] + a[2], p + m + v):
        assert torch.equal(x, y)
    assert adamw_step_kernel.launches == 0
    assert launch_counts()["adamw_step_kernel"] == 0
    # 24 bytes an element with a bf16 moment, 28 with an f32 one
    n = sum(x.numel() for x in p)
    assert adamw_bytes(p, m) == 24 * n
    assert adamw_bytes(p, v) == 28 * n


def test_mu_adamw_state_round_trip_and_guard():
    lin = torch.nn.Linear(6, 5)
    lr = torch.tensor(1e-2)
    opt = MuAdamW(lin.parameters(), lr=lr, betas=(B1, B2), eps=EPS,
                  weight_decay=WD)
    sched = DeviceLambdaLR(opt, lambda c: (c + 1).double())
    check_guardable(opt, sched)  # fused, found_inf on the device
    lin(torch.ones(2, 6)).sum().backward()
    opt.step()
    st = opt.state[lin.weight]
    assert st["exp_avg"].dtype == torch.bfloat16
    assert st["exp_avg_sq"].dtype == torch.float32
    assert st["step"].dtype == torch.float32 and float(st["step"]) == 1.0
    sd = opt.state_dict()
    fresh = MuAdamW(lin.parameters(), lr=torch.tensor(1e-2))
    fresh.load_state_dict(sd)
    got = fresh.state[lin.weight]
    assert got["exp_avg"].dtype == torch.bfloat16
    assert torch.equal(got["exp_avg"], st["exp_avg"])
    # the planner charges each moment at its stored dtype
    shapes = {id(p): tuple(p.shape) for p in lin.parameters()}
    n = sum(p.numel() for p in lin.parameters())
    assert optimizer_state_bytes(opt, shapes) == 6 * n + 4 * 2
    f32 = torch.optim.AdamW(lin.parameters(), lr=torch.tensor(1e-2),
                            fused=True)
    assert optimizer_state_bytes(f32, shapes) == 8 * n + 4 * 2


# ---- LlamaModule(mu_dtype=bf16) against the JAX module ----------------------

TINY = torch_jobs.TINY


class _Rows(Callback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


class _JaxRows(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


#: (first-moment dtype, force_reference): the rows' and weights'
#: tolerance. An f32 moment is torch's fused AdamW, and the fit is JAX's
#: to 2e-5, as the f32 fit. With a bf16 one, the two packages' gradients, which differ at
#: 1e-7, round a few moments to neighbouring bf16 values (2**-8 apart),
#: and each such element's update moves by up to 0.4%: over three real
#: updates at lr 1e-2 the rows part by at most 1.3e-4 relative and the
#: weights by 7e-4 of a tensor's largest entry (the worst of lr 1e-2 and
#: 1e-3 on this box), so 1e-3 and 5e-3.
MU_FIT_CASES = {
    "f32": (torch.float32, False, 2e-5, 2e-5),
    "bf16": (torch.bfloat16, False, 1e-3, 5e-3),
    "bf16_reference": (torch.bfloat16, True, 1e-3, 5e-3),
}


@pytest.mark.parametrize("case", list(MU_FIT_CASES))
def test_llama_module_mu_bf16_fit_matches_jax(case):
    """Four steps of the tiny Llama (fused CE, remat), lr 1e-2, against
    the JAX module with the same ``mu_dtype``: per-step loss and
    grad_norm and the final weights (tolerances in `MU_FIT_CASES`),
    under the dispatch default and `force_reference`. The first moment is
    stored in ``mu_dtype``, the second in f32 (a bf16 first moment is half
    the second's bytes), as `test_llama.py::
    test_mu_dtype_bf16_trains_and_halves_mu` checks on the JAX side."""
    mu, reference, rows_tol, w_tol = MU_FIT_CASES[case]
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False, fused_ce=True,
                     ce_chunk_tokens=16)
    pcfg = LlamaConfig(**TINY, dtype=torch.float32, remat=True,
                       fused_ce=True, ce_chunk_tokens=16)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    toks = torch_jobs.tokens(8, 12, seed=4).astype(np.int32)
    batches = [{"tokens": toks[2 * k:2 * k + 2]} for k in range(4)]
    common = dict(max_steps=4, log_every_n_steps=1,
                  enable_checkpointing=False, enable_progress_bar=False,
                  seed=0)

    jrec = _JaxRows()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=4,
                        mu_dtype=getattr(jnp, str(mu).split(".")[1]))
    jm.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=JaxSingle(), callbacks=[jrec], **common).fit(
        jm, [dict(b) for b in batches])

    rec = _Rows()
    pm = LlamaModule(pcfg, lr=1e-2, warmup_steps=1, total_steps=4,
                     mu_dtype=mu)
    pm.params = params_from_jax(params, pcfg, dtype=torch.float32)
    trainer = Trainer(strategy=SingleDevice(device="cpu"), callbacks=[rec],
                      **common)
    if reference:
        with dispatch.force_reference():
            trainer.fit(pm, batches)
    else:
        trainer.fit(pm, batches)
    np.testing.assert_allclose(rec.rows, jrec.rows, rtol=rows_tol, atol=0)
    want = params_from_jax(jax.tree.map(np.asarray, jm.params), pcfg,
                           dtype=torch.float32)
    for k, p in pm.params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=w_tol,
            atol=w_tol * max(float(np.abs(w).max()), 1e-6), err_msg=k)
    opt = trainer.state.optimizer
    assert isinstance(opt, MuAdamW if mu == torch.bfloat16
                      else torch.optim.AdamW)
    assert all(s["exp_avg"].dtype == mu and s["exp_avg_sq"].dtype
               == torch.float32 for s in opt.state.values())
    mu_bytes = sum(s["exp_avg"].nbytes for s in opt.state.values())
    nu_bytes = sum(s["exp_avg_sq"].nbytes for s in opt.state.values())
    assert mu_bytes * 4 == nu_bytes * mu.itemsize


def test_mu_bf16_fsdp_two_processes_resume_bitwise(tmp_path):
    """Two gloo processes under FSDP with the bf16 first moment: a fit of
    4 steps, and a fit saved at step 2 then resumed in a fresh job from
    that checkpoint; steps 3-4 and the final weights bitwise the
    uninterrupted fit's (a first moment restored in f32 would take the
    decay product in f32 and part from it)."""
    toks = torch_jobs.tokens(16, 12, seed=4)
    cfg_kw = dict(fused_ce=True, ce_chunk_tokens=16, remat=True)
    params = jax.tree.map(np.asarray, JaxLlama(JaxConfig(
        **TINY, dtype=jnp.float32)).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])

    def run(**kw):
        rows = []
        trainer_kw = kw.pop("trainer_kw", {})
        res = fit_distributed(
            functools.partial(torch_jobs.llama_module, params,
                              mu_dtype=torch.bfloat16, **cfg_kw),
            functools.partial(torch_jobs.trainer, strategy="fsdp",
                              **trainer_kw),
            functools.partial(torch_jobs.llama_data, toks, None, 2), 2,
            device="cpu", on_queue_item=lambda r, it: rows.append(it[2:]),
            timeout=240, log_dir=str(tmp_path / "logs"), **kw)
        return rows, res

    want_rows, want = run()
    ckdir = str(tmp_path / "ck")
    first_rows, first = run(trainer_kw=dict(
        max_steps=2, ckpt_dir=ckdir, every_n_train_steps=2),
        return_weights=False)
    path = first.best_model_path
    assert path == os.path.join(ckdir, "step=2")
    assert first_rows == want_rows[:2]
    rows, res = run(ckpt_path=path)
    assert rows == want_rows[2:]
    for k, v in want.state_dict.items():
        assert torch.equal(res.state_dict[k], v), k
