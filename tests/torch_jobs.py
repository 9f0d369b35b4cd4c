"""Jobs and factories that the port's multi-process tests ship to worker
processes. Workers import this module by name (the standard pickle sends
functions by reference), so it imports no JAX and nothing of the JAX
package: a worker stays as light as its job.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np

from ray_lightning_tpu_torch.core.callbacks import Callback

#: the tiny Llama config shared with the JAX side of the tests
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=64)


# ---- runtime jobs ------------------------------------------------------------


def rank_and_world():
    from ray_lightning_tpu_torch.runtime import session

    return session.get_actor_rank(), session.get_world_size()


def read_env(key):
    return os.environ.get(key)


def write_marker(path, text):
    """Runs where it is called: in a worker as a job, in the driver as a
    side-channel item."""
    with open(path, "a") as f:
        f.write(f"{text} {os.getpid()}\n")


def queue_marker(path):
    """Puts a callable on the side channel; the driver runs it."""
    import functools

    from ray_lightning_tpu_torch.runtime import session

    rank = session.get_actor_rank()
    session.put_queue(functools.partial(write_marker, path, f"rank{rank}"))
    session.put_queue({"rank": rank, "pid": os.getpid()})
    return os.getpid()


def fail_on(rank_to_fail):
    from ray_lightning_tpu_torch.runtime import session

    if session.get_actor_rank() == rank_to_fail:
        raise ValueError(f"boom from rank {rank_to_fail}")
    time.sleep(30)
    return "survived"


def sleep_for(seconds):
    time.sleep(seconds)
    return seconds


def my_pid():
    return os.getpid()


def all_reduce_rank():
    """A collective over the launch's process group: the sum of ranks."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), float(t)


# ---- Llama fit ---------------------------------------------------------------


class StepRows(Callback):
    """Sends rank 0's per-step (step, loss, grad_norm) over the side
    channel."""

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_tpu_torch.runtime import session

        if session.get_actor_rank() == 0:
            session.put_queue(("row", trainer.global_step,
                               float(metrics["loss"]),
                               float(metrics["grad_norm"])))


class StepRecorder(Callback):
    """Per-step (loss, grad_norm) of a fit in this process."""

    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def tokens(n, s, seed=0, vocab=256):
    """[n, s + 1] seeded token ids."""
    return np.random.default_rng(seed).integers(0, vocab, (n, s + 1))


def llama_module(params_np=None, lr=1e-2, warmup_steps=1, total_steps=4,
                 mu_dtype=None, **cfg_kw):
    import torch

    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        params_from_jax,
    )

    cfg = LlamaConfig(**TINY, dtype=torch.float32, **cfg_kw)
    m = LlamaModule(cfg, lr=lr, warmup_steps=warmup_steps,
                    total_steps=total_steps, mu_dtype=mu_dtype)
    if params_np is not None:
        m.params = params_from_jax(params_np, cfg, dtype=torch.float32)
    return m


def make_strategy(name, **kw):
    from ray_lightning_tpu_torch.parallel.strategy import (
        FSDP,
        DataParallel,
        ShardedMesh,
        SingleDevice,
    )

    return {"ddp": DataParallel, "fsdp": FSDP, "sharded": ShardedMesh,
            "single": SingleDevice}[name](device="cpu", **kw)


def trainer(strategy="ddp", max_steps=4, clip=None, ckpt_dir=None,
            every_n_train_steps=None, extra=(), telemetry=None,
            **strategy_kw):
    """A Llama trainer that reports rank 0's steps over the side channel,
    with a step-cadence `ModelCheckpoint` into ``ckpt_dir`` if given, the
    callbacks named in ``extra`` (classes of this module) and
    ``telemetry`` (`Trainer(telemetry=)`)."""
    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.core.trainer import Trainer

    callbacks = [StepRows(), *(globals()[name]() for name in extra)]
    if ckpt_dir is not None:
        callbacks.append(ModelCheckpoint(
            dirpath=ckpt_dir, every_n_train_steps=every_n_train_steps,
            save_top_k=-1))
    return Trainer(strategy=make_strategy(strategy, **strategy_kw),
                   max_steps=max_steps,
                   gradient_clip_val=clip, log_every_n_steps=1,
                   enable_checkpointing=False, enable_progress_bar=False,
                   callbacks=callbacks, seed=0, telemetry=telemetry)


def _np_full(t):
    """A (DTensor) tensor's whole value as numpy."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.float().numpy().copy()


def full_state(trainer, module):
    """Every rank together: the model's and the optimizer's whole state in
    the canonical layout ({name: array}, {name: {key: array}}); the
    step counts are left out."""
    params, opt = trainer.strategy.state_dicts(module.model,
                                               trainer.state.optimizer)
    return ({k: _np_full(v) for k, v in params.items()},
            {name: {k: _np_full(v) for k, v in entry.items()
                    if k != "step"}
             for name, entry in opt["state"].items()})


def resume_state(trainer, module):
    """Every rank together: the whole training state in the canonical
    layout — parameters, the optimizer's state with its step counts, the
    scheduler's state and the trainer's step — as
    ``(params, opt, scheduler, step)``; what a checkpoint holds."""
    params, opt = trainer.strategy.state_dicts(module.model,
                                               trainer.state.optimizer)
    sched = trainer.state.scheduler
    return ({k: _np_full(v) for k, v in params.items()},
            {name: {k: _np_full(v) for k, v in entry.items()}
             for name, entry in opt["state"].items()},
            sched.state_dict() if sched is not None else None,
            int(trainer.state.step))


class FitStartState(Callback):
    """At the fit's start (after the restore) every rank sends
    ("start", rank, `resume_state`, the trainer's move summary)."""

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.runtime import session

        session.put_queue(("start", session.get_actor_rank(),
                           resume_state(trainer, module),
                           trainer.last_reshard))


class FitEndState(Callback):
    """At the fit's end every rank sends ("end", rank, `resume_state`)."""

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch.runtime import session

        session.put_queue(("end", session.get_actor_rank(),
                           resume_state(trainer, module)))


def reshard_arrays_job():
    """Two ranks: `elastic.reshard_arrays` moves a Shard(0) DTensor to
    Replicate on its mesh, a plain tensor onto Shard(1), a DTensor onto
    another mesh of the same ranks, and one back to a plain tensor.
    Returns each move's verdict."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )

    from ray_lightning_tpu_torch.elastic.reshard import reshard_arrays

    rank = dist.get_rank()
    fsdp = init_device_mesh("cpu", (2,), mesh_dim_names=("fsdp",))
    tensor = init_device_mesh("cpu", (2,), mesh_dim_names=("tensor",))
    full = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    tree = {"w": distribute_tensor(full, fsdp, [Shard(0)]),
            "deep": {"b": full * 2, "k": distribute_tensor(
                full * 3, fsdp, [Shard(1)])},
            "gone": distribute_tensor(full * 4, fsdp, [Shard(0)])}
    moved = reshard_arrays(tree, {
        "w": (fsdp, [Replicate()]),
        "deep": {"b": (fsdp, [Shard(1)]), "k": (tensor, [Shard(0)])},
        "gone": None})
    one = reshard_arrays({"x": full}, (tensor, [Shard(0)]))
    return {
        "replicated": bool(torch.equal(moved["w"].to_local(), full)),
        "plain_sharded": bool(torch.equal(
            moved["deep"]["b"].to_local(),
            (full * 2)[:, 4 * rank:4 * rank + 4])),
        "cross_mesh": (moved["deep"]["k"].device_mesh.mesh_dim_names
                       == ("tensor",) and bool(torch.equal(
                           moved["deep"]["k"].to_local(),
                           (full * 3)[2 * rank:2 * rank + 2]))),
        "to_plain": (not isinstance(moved["gone"], DTensor)
                     and bool(torch.equal(moved["gone"], full * 4))),
        "one_spec": bool(torch.equal(one["x"].full_tensor(), full)),
    }


def full_value_job():
    """Four ranks: `parallel.tensor.full_value` against
    ``DTensor.full_tensor`` on a (2, 2) mesh and on each of its rows, with
    uneven shards (torch.chunk's), two mesh dimensions sharding one
    tensor dimension, and replicated ones. Returns the cases' verdicts."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ray_lightning_tpu_torch.parallel.tensor import full_value

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "tensor"))
    full = torch.arange(7 * 5 * 3, dtype=torch.float32).reshape(7, 5, 3)
    cases = {
        "shard0_shard0": [Shard(0), Shard(0)],
        "shard1_shard0": [Shard(1), Shard(0)],
        "replicate_shard2": [Replicate(), Shard(2)],
        "shard0_replicate": [Shard(0), Replicate()],
        "replicate": [Replicate(), Replicate()],
    }
    out = {}
    for name, placements in cases.items():
        dt = distribute_tensor(full, mesh, placements)
        got = full_value(dt)
        out[name] = bool(torch.equal(got, full)
                         and torch.equal(got, dt.full_tensor()))
    one = distribute_tensor(full, mesh["tensor"], [Shard(1)])
    out["one_dim_uneven"] = bool(torch.equal(full_value(one), full))
    out["plain"] = full_value(full) is full
    return out


class LiveBytes(Callback):
    """At the fit's end every rank sends ("live", rank, its parameters'
    storage bytes, its optimizer state's): what the planner plans."""

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch.parallel.tensor import local
        from ray_lightning_tpu_torch.runtime import session

        opt = trainer.state.optimizer
        session.put_queue((
            "live", session.get_actor_rank(),
            sum(local(p).untyped_storage().nbytes()
                for p in module.params.values()),
            sum(local(t).untyped_storage().nbytes()
                for st in opt.state.values() for t in st.values())))


class InitState(Callback):
    """At the fit's start (after the init or the restore): rank 0 sends
    ("init", params, optimizer state, RoPE tables recomputed?, init path,
    reason), gathered by every rank in the canonical layout."""

    def on_fit_start(self, trainer, module):
        import torch

        from ray_lightning_tpu_torch.ops.rope import rope_frequencies
        from ray_lightning_tpu_torch.runtime import session

        params, opt = full_state(trainer, module)
        model = trainer.strategy.unwrap(module.model)
        cfg = model.cfg
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta)
        rope = bool(torch.equal(model.cos, cos) and torch.equal(model.sin,
                                                                sin))
        if session.get_actor_rank() == 0:
            session.put_queue(("init", params, opt, rope, trainer.init_path,
                               trainer.init_path_reason))


class Placements(Callback):
    """At the fit's start rank 0 sends ("placements", {name: the class
    names of its parameter's DTensor placements})."""

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.runtime import session

        if session.get_actor_rank() == 0:
            session.put_queue(("placements", {
                n: [type(pl).__name__ for pl in getattr(p, "placements", ())]
                for n, p in module.params.items()}))


def _tp_rank_setup(params_np, toks, mask, cfg_kw, strategy_kw):
    """The tiny Llama with ``params_np`` wrapped under ``ShardedMesh(
    **strategy_kw)``, and this rank's data-parallel rows of the global
    batch: (module, strategy, tokens, mask or None)."""
    import types

    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    module = llama_module(params_np, **cfg_kw)
    strategy = make_strategy("sharded", **strategy_kw)
    strategy.setup(module)
    module.setup()
    with torch.no_grad():
        module.model.load_state_dict(module.params)
    module.model = strategy.wrap_model(module.model)
    model = strategy.unwrap(module.model)
    module.params = dict(model.named_parameters())
    module.trainer = types.SimpleNamespace(strategy=strategy)
    index, count = strategy.data_shard(rank, world)
    rows = np.array_split(np.arange(len(toks)), count)[index]
    t = torch.from_numpy(np.asarray(toks)[rows])
    m = None if mask is None else torch.from_numpy(np.asarray(mask)[rows])
    return module, strategy, t, m


def restore_target_job(params_np, toks, cfg_kw, strategy_kw):
    """One AdamW step of the tiny Llama under ``ShardedMesh(
    **strategy_kw)``, then the strategy's restore target against its
    canonical ``state_dicts``: the same keys, and each value the same
    kind, global shape, placements and local shape; the unfused leaves
    the live storage a restore writes into; no gather (the calls to
    `full_value`) while the target is built. Returns the verdicts."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_lightning_tpu_torch.parallel import strategy as strategy_mod

    module, strategy, t, _ = _tp_rank_setup(params_np, toks, None, cfg_kw,
                                            strategy_kw)
    opt = module.configure_optimizers()
    opt = opt[0] if isinstance(opt, tuple) else opt
    module._loss(module.params, t[:, :-1], t[:, 1:], None).backward()
    opt.step()
    gathers = []
    full_value = strategy_mod.full_value
    strategy_mod.full_value = lambda v: gathers.append(1) or full_value(v)
    try:
        params, osd = strategy.restore_target(module.model, opt)
        n_target = len(gathers)
        canon_params, canon_osd = strategy.state_dicts(module.model, opt)
    finally:
        strategy_mod.full_value = full_value

    def leaves(p, o):
        out = {f"params/{k}": v for k, v in p.items()}
        for name, st in o["state"].items():
            out.update({f"opt/{name}/{k}": v for k, v in st.items()})
        return out

    got, want = leaves(params, osd), leaves(canon_params, canon_osd)
    out = {"keys": set(got) == set(want),
           "param_groups": osd["param_groups"] == canon_osd["param_groups"],
           "no_gather": n_target == 0, "gathered_after": len(gathers) > 0}
    for k in sorted(set(got) & set(want)):
        a, b = got[k], want[k]
        if not torch.is_tensor(b):
            out[k] = a == b
            continue
        same = (type(a) is type(b) and a.shape == b.shape
                and a.dtype == b.dtype)
        if isinstance(b, DTensor):
            same = same and a.placements == b.placements and \
                a.to_local().shape == b.to_local().shape
        fused = strategy._perm(k.split("/")[1]) is not None
        if not fused:
            same = same and (a.to_local() if isinstance(a, DTensor) else
                             a).data_ptr() == (b.to_local() if isinstance(
                                 b, DTensor) else b).data_ptr()
        out[k] = bool(same)
    return out


def _canonical_grads(module, strategy):
    return {n: _np_full(strategy.canonical_value(n, p.grad))
            for n, p in module.params.items()}


def tp_grads(params_np, toks, mask, cfg_kw, strategy_kw):
    """One loss and backward of the tiny Llama under ``ShardedMesh(
    **strategy_kw)`` on this rank's data-parallel rows of the global
    batch (``toks``, ``mask``): rank 0 returns (loss, {name: the whole
    gradient in the canonical layout}, the logits of its rows, gathered
    over the tensor group)."""
    import torch

    module, strategy, t, m = _tp_rank_setup(params_np, toks, mask, cfg_kw,
                                            strategy_kw)
    loss = module._loss(module.params, t[:, :-1], t[:, 1:], m)
    loss.backward()
    grads = _canonical_grads(module, strategy)
    loss = strategy.reduce_mean({"loss": loss.detach()})["loss"]
    with torch.no_grad():
        logits = module.apply(module.params, t[:, :-1])
    return float(loss), grads, logits.numpy()


def logits_loss(logits, seed):
    """A loss of the whole logits [B, S, V] that reads every vocabulary
    column: the seeded weighted sum of their log-softmax."""
    import torch

    w = np.random.default_rng(seed).standard_normal(tuple(logits.shape))
    return (logits.log_softmax(-1) * torch.from_numpy(w).to(logits.dtype)
            ).sum() / logits.shape[0]


def tp_logit_grads(params_np, toks, cfg_kw, strategy_kw, seed):
    """The gradient of `logits_loss` of ``model(tokens)`` (the gathered
    logits, no targets) under ``ShardedMesh(**strategy_kw)``: rank 0
    returns (loss, {name: the whole gradient in the canonical layout})."""
    module, strategy, t, _ = _tp_rank_setup(params_np, toks, None, cfg_kw,
                                            strategy_kw)
    loss = logits_loss(module.apply(module.params, t[:, :-1]), seed)
    loss.backward()
    return float(loss), _canonical_grads(module, strategy)


def vocab_parallel_ce(seed, n_tokens, vocab, dim, chunk, inline=False):
    """The vocab-split chunked CE of seeded inputs over this rank's
    vocabulary rows, and its gradients: rank 0 returns (loss sum, the
    hidden states' gradient, the whole lm_head gradient). ``inline``:
    the inline-backward CE over a denominator of 1 (the same sum)."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.fused_ce import (
        inline_cross_entropy,
        vocab_parallel_cross_entropy_sum,
    )
    from ray_lightning_tpu_torch.parallel.tensor import TensorParallel

    rank, world = dist.get_rank(), dist.get_world_size()
    tp = TensorParallel(dist.group.WORLD, world, rank)
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.standard_normal((2, n_tokens // 2, dim)),
                     dtype=torch.float32, requires_grad=True)
    w_full = torch.tensor(rng.standard_normal((vocab, dim)) / dim ** 0.5,
                          dtype=torch.float32)
    t = torch.tensor(rng.integers(0, vocab, (2, n_tokens // 2)))
    m = torch.tensor((rng.random((2, n_tokens // 2)) > 0.2)
                     .astype(np.float32))
    w = w_full.chunk(world)[rank].clone().requires_grad_(True)
    if inline:
        count = m.sum()
        loss = inline_cross_entropy(h, w, t, m, torch.ones(()), chunk,
                                    torch.float32, tp=tp)
    else:
        loss, count = vocab_parallel_cross_entropy_sum(
            h, w, t, tp, m, chunk_tokens=chunk, compute_dtype=torch.float32)
    loss.backward()
    parts = [torch.empty_like(w.grad) for _ in range(world)]
    dist.all_gather(parts, w.grad)
    return (float(loss), float(count), h.grad.numpy(),
            torch.cat(parts).numpy())


def llama_data(toks, mask=None, batch_size=2):
    from ray_lightning_tpu_torch.core.data import DataLoader

    data = {"tokens": toks}
    if mask is not None:
        data["mask"] = mask
    return DataLoader(data, batch_size=batch_size)


# ---- the MNIST classifier matrix ----------------------------------------------


def mnist_module(lr=1e-2):
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier

    return MNISTClassifier(lr=lr, layer_1=32, layer_2=32)


def mnist_trainer(ckpt_dir=None):
    """`RayXlaPlugin` on the CPU; with ``ckpt_dir``, `EarlyStopping` and a
    `ModelCheckpoint` monitoring the validation accuracy."""
    from ray_lightning_tpu_torch.core.callbacks import (
        EarlyStopping,
        ModelCheckpoint,
    )
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin

    callbacks = []
    if ckpt_dir is not None:
        callbacks = [ModelCheckpoint(dirpath=ckpt_dir,
                                     monitor="ptl/val_accuracy", mode="max"),
                     EarlyStopping(monitor="ptl/val_accuracy", mode="max",
                                   patience=2)]
    return Trainer(strategy=RayXlaPlugin(device="cpu"), max_epochs=2,
                   enable_progress_bar=False, enable_checkpointing=False,
                   callbacks=callbacks, seed=0)


def mnist_data(rows=256, batch_size=16):
    """(shuffled train, unshuffled val) loaders over `synthetic_mnist`."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    data = synthetic_mnist(rows)
    return (DataLoader(data, batch_size=batch_size, shuffle=True, seed=0),
            DataLoader(data, batch_size=batch_size))


def mnist_eval_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    return DataLoader(synthetic_mnist(256), batch_size=16)


# ---- sweep trainables ----------------------------------------------------------
#
# Trial processes import this module by name: each trainable is a
# module-level function, configured through its config dict or a
# functools.partial.


def constant_trainable(config):
    """Reports ``loss = config["q"]`` twelve times."""
    from ray_lightning_tpu_torch import sweep

    for _ in range(12):
        sweep.report(loss=float(config["q"]))
    return "done"


def card_trainable(config, rendezvous_dir, timeout_s=60.0):
    """Writes its start into ``rendezvous_dir``, then waits until every
    trial of the sweep (``config["n"]``) has written one, so it ends only
    if they all ran at once; returns the ``CUDA_VISIBLE_DEVICES`` its
    process saw."""
    from ray_lightning_tpu_torch import sweep

    with open(os.path.join(rendezvous_dir, sweep.get_trial_id()), "w") as f:
        f.write(str(os.getpid()))
    deadline = time.monotonic() + timeout_s
    while len(os.listdir(rendezvous_dir)) < config["n"]:
        if time.monotonic() > deadline:
            raise TimeoutError("the other trials never started")
        time.sleep(0.05)
    sweep.report(loss=float(config["i"]))
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid()}


def failing_trainable(config):
    raise ValueError("process kaboom")


class _CrashAfterEpoch(Callback):
    """Kills its process at the end of epoch ``epoch`` (a mid-sweep
    preemption), unless the fit resumed from a checkpoint."""

    def __init__(self, epoch, resumed):
        self.epoch, self.resumed = epoch, resumed

    def on_train_epoch_end(self, trainer, module):
        if not self.resumed and trainer.current_epoch >= self.epoch:
            os._exit(1)


def resumable_trainable(config, runs_file):
    """Four epochs of the small MNIST classifier on the CPU, a checkpoint
    registered every epoch; the process dies after epoch 1 unless it
    resumed from the sweep's checkpoint. Appends a line to ``runs_file``
    each time it starts."""
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    ckpt = sweep.get_checkpoint()
    with open(runs_file, "a") as f:
        f.write(f"{os.getpid()} {ckpt}\n")
    trainer = Trainer(
        strategy=SingleDevice(device="cpu"), max_epochs=4,
        callbacks=[
            # fires before the crash: epochs 0-1 get registered
            sweep.TuneReportCheckpointCallback(on="train_epoch_end"),
            _CrashAfterEpoch(1, ckpt is not None)],
        enable_checkpointing=False, enable_progress_bar=False, seed=0)
    train, _ = mnist_data(rows=64, batch_size=32)
    trainer.fit(mnist_module(), train, ckpt_path=ckpt)
    return {"final_step": trainer.global_step, "resumed": ckpt is not None}


class _WorkerPid(Callback):
    """Leaves this worker's pid in its trial's dir (``RLT_TRIAL_DIR``,
    which a trial's `fit_distributed` workers inherit)."""

    def on_fit_start(self, trainer, module):
        d = os.path.join(os.environ["RLT_TRIAL_DIR"], "worker_pids")
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, str(os.getpid())), "w").close()


def live_worker_pids(trial_dir):
    """The pids `_WorkerPid` left in ``trial_dir`` whose processes still
    run."""
    d = os.path.join(trial_dir, "worker_pids")
    live = []
    for name in (os.listdir(d) if os.path.isdir(d) else ()):
        try:
            os.kill(int(name), 0)
        except ProcessLookupError:
            continue
        live.append(int(name))
    return live


def sweep_mnist_trainer(max_epochs, device="cpu"):
    """`RayXlaPlugin` with `TuneReportCheckpointCallback` reporting the
    validation loss and accuracy each epoch; each worker leaves its pid
    in the trial's dir."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin
    from ray_lightning_tpu_torch.sweep import TuneReportCheckpointCallback

    return Trainer(
        strategy=RayXlaPlugin(device=device), max_epochs=max_epochs,
        callbacks=[_WorkerPid(), TuneReportCheckpointCallback(
            metrics={"loss": "ptl/val_loss", "acc": "ptl/val_accuracy"})],
        enable_progress_bar=False, enable_checkpointing=False, seed=0)


#: what `nested_mnist_trainable` leaves in its trial dir: the pids of its
#: workers still running as it returns (a stopped trial returns nothing)
WORKERS_ALIVE = "workers_alive.json"


def nested_mnist_trainable(config, log_dir):
    """A trial that fits the MNIST classifier through
    `fit_distributed(num_processes=2, device="cpu")`: the workers' rank 0
    reports over the side channel, through this trial process, to the
    sweep. A stop verdict raises in this process's pump, and the worker
    group must be down when it reaches here: the trial leaves the
    workers still running in ``WORKERS_ALIVE``."""
    import functools
    import json

    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.runtime import fit_distributed

    try:
        res = fit_distributed(
            functools.partial(mnist_module, config["lr"]),
            functools.partial(sweep_mnist_trainer, config["max_epochs"]),
            mnist_data, num_processes=2, device="cpu", return_weights=False,
            log_dir=log_dir, timeout=120)
        return res.metrics["ptl/val_accuracy"]
    finally:
        trial_dir = sweep.get_trial_dir()
        with open(os.path.join(trial_dir, WORKERS_ALIVE), "w") as f:
            json.dump(live_worker_pids(trial_dir), f)


# ---- supervised runs (resilience) ----------------------------------------------
#
# A small MLP classifier under DataParallel on the CPU: at two ranks, two
# epochs of four steps (8 rows a rank a step), so every step a fault plan
# names exists.

SUP_ROWS, SUP_CLASSES, SUP_FEATURES = 64, 4, 8


def sup_module():
    from ray_lightning_tpu_torch.models.mlp import MLPClassifier

    return MLPClassifier(features=(16,), num_classes=SUP_CLASSES, lr=5e-2,
                         in_features=SUP_FEATURES)


def sup_trainer(max_epochs=2, log_every_n_steps=1, telemetry=None):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    return Trainer(strategy=DataParallel(device="cpu"), max_epochs=max_epochs,
                   enable_progress_bar=False, enable_checkpointing=False,
                   seed=0, log_every_n_steps=log_every_n_steps,
                   callbacks=[StartStep()], telemetry=telemetry)


def sup_data(rows=SUP_ROWS):
    from ray_lightning_tpu_torch.core.data import DataLoader

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(SUP_CLASSES, SUP_FEATURES)) * 3
    y = rng.integers(0, SUP_CLASSES, size=rows)
    x = (centers[y] + rng.normal(size=(rows, SUP_FEATURES)) * 0.1
         ).astype(np.float32)
    return DataLoader({"x": x, "y": y}, batch_size=8, shuffle=True, seed=3)


class StartStep(Callback):
    """Rank 0 sends ("start", global_step, pid) over the side channel at
    each fit start: where each supervised attempt resumed."""

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.runtime import session

        if session.is_session_enabled() and session.get_actor_rank() == 0:
            session.put_queue(("start", trainer.global_step, os.getpid()))


# ---- the cross-host runtime ---------------------------------------------------


def die_behind_queue(driver_sleep_s, survivor_delay_s):
    """Rank 0 sends a callable that keeps the driver's pump busy for
    ``driver_sleep_s``, one more item, and is SIGKILL'd; rank 1, like a
    survivor whose collective lost its peer, raises ``survivor_delay_s``
    later. When the driver next looks, rank 0's channel still holds an
    item ahead of its EOF while rank 1's error is ready."""
    import signal

    from ray_lightning_tpu_torch.runtime import session

    if session.get_actor_rank() == 0:
        session.put_queue(functools.partial(time.sleep, driver_sleep_s))
        session.put_queue("last words")
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(survivor_delay_s)
    raise ConnectionError("the collective's peer rank 0 went away")


def device_and_env(keys):
    """The job's card as `rank_device` picks it, and ``keys`` of its
    environment (None where unset)."""
    from ray_lightning_tpu_torch.utils.devices import local_rank

    return local_rank(), {k: os.environ.get(k) for k in keys}


def hosts_aware_trainable(config):
    """Reports once; returns the trial's borrowed hosts and what its
    environment says of its cards and of the driver's own variables."""
    from ray_lightning_tpu_torch import sweep

    sweep.report(loss=float(config.get("q", 0.0)))
    return {"hosts": sweep.get_trial_hosts(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "driver_only": os.environ.get("RLT_DRIVER_ONLY")}


def rendezvous_seen():
    """(rank, MASTER_ADDR, MASTER_PORT, the port rank 0's store is bound
    to, or None on the other ranks)."""
    import importlib

    from ray_lightning_tpu_torch.runtime import session

    # the package exports the function `launch` under the module's name
    store = importlib.import_module(
        "ray_lightning_tpu_torch.runtime.launch")._STORE
    return (session.get_actor_rank(), os.environ["MASTER_ADDR"],
            int(os.environ["MASTER_PORT"]),
            store.port if store is not None else None)


# ---- tensor-parallel serving -------------------------------------------------


def serve_tp_rank(state_dict, cfg_kw, engine_kw, requests):
    """One rank of a tensor-parallel replica in the launched gloo group:
    the engine on this rank's shard of ``state_dict`` (`DecodeEngine(
    mesh=)`), every request served; returns the streams, the rank's live
    parameter and pool bytes and its heads a pool holds."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_lightning_tpu_torch.parallel.tensor import TensorParallel
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    cfg = LlamaConfig(**cfg_kw, dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(state_dict)
    tp = TensorParallel(dist.group.WORLD, dist.get_world_size(),
                        dist.get_rank())
    eng = DecodeEngine(model, EngineConfig(**engine_kw), device="cpu",
                       mesh=tp)
    eng.warmup()
    sched = Scheduler(eng)
    for r in requests:
        sched.submit(r)
    out = {}
    while sched.busy():
        for c in sched.tick():
            out[c.rid] = list(c.tokens)
    return {"outputs": out,
            "params_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
            "pool_bytes": (eng.pool_k.numel() * eng.pool_k.element_size()
                           + eng.pool_v.numel() * eng.pool_v.element_size()),
            "last_logits_bytes": (eng.last_logits.numel()
                                  * eng.last_logits.element_size()),
            "pool_kv_heads": eng.pool_k.shape[3]}
