"""Worker jobs of the sequence, pipeline and expert axes' tests
(`tests/test_torch_ring_attention.py`, `test_torch_gpipe.py`,
`test_torch_moe.py`) and of BERT under the tensor axis
(`test_torch_bert_tensor.py`). Each file spawns one gloo group of CPU
processes a mesh and runs every case of its file in one job, which
returns this rank's readings; the tests assemble the ranks' pieces.
Workers import this module by name, so it imports no JAX.
"""
from __future__ import annotations

import contextlib
import types

import numpy as np

from tests import torch_jobs


def _t(a, grad=False):
    import torch

    t = torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
    return t.requires_grad_(grad)


def _np(t):
    if hasattr(t, "full_tensor"):
        from ray_lightning_tpu_torch.parallel.tensor import full_value

        t = full_value(t)
    return t.detach().float().numpy()


def _mesh(**sizes):
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(sizes)
    return init_device_mesh("cpu", tuple(sizes[n] for n in names),
                            mesh_dim_names=names)


def _coord(mesh, axis):
    return mesh[axis].get_local_rank() if axis in mesh.mesh_dim_names else 0


def _rows(mesh, n):
    """This rank's rows of an n-row batch split over the mesh's data
    axis."""
    size = mesh["data"].size() if "data" in mesh.mesh_dim_names else 1
    return np.array_split(np.arange(n), size)[_coord(mesh, "data")]


@contextlib.contextmanager
def _all_to_all_route():
    """The shift's route under gloo with CUDA tensors, forced on the
    CPU."""
    from ray_lightning_tpu_torch.parallel import comm

    old = comm.shift_route
    comm.shift_route = lambda group, device: "all_to_all"
    try:
        yield
    finally:
        comm.shift_route = old


def _module(params_np, cfg_kw, strategy_kw, lr=1e-2):
    """The Llama module with ``params_np`` (JAX tree, numpy) wrapped under
    ``ShardedMesh(**strategy_kw)``, as the trainer wraps it; its trainer
    is a stand-in holding the strategy."""
    import torch

    module = llama_module(params_np, cfg_kw, lr=lr)
    strategy = torch_jobs.make_strategy("sharded", **strategy_kw)
    strategy.setup(module)
    module.setup()
    with torch.no_grad():
        module.model.load_state_dict(module.params)
    module.model = strategy.wrap_model(module.model)
    module.params = dict(strategy.unwrap(module.model).named_parameters())
    module.trainer = types.SimpleNamespace(strategy=strategy)
    return module, strategy


def llama_module(params_np, cfg_kw, lr=1e-2, warmup_steps=1, total_steps=4):
    import torch

    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        params_from_jax,
    )

    cfg = LlamaConfig(**{**dict(dtype=torch.float32), **cfg_kw})
    m = LlamaModule(cfg, lr=lr, warmup_steps=warmup_steps,
                    total_steps=total_steps)
    if params_np is not None:
        m.params = params_from_jax(params_np, cfg, dtype=torch.float32)
    return m


def _loss_and_grads(module, strategy, toks, mask=None):
    """One loss and backward on this rank's batch rows, the gradients
    finished as the trainer finishes them: (mean loss, {name: whole
    gradient})."""
    import torch
    import torch.distributed as dist

    index, count = strategy.data_shard(dist.get_rank(),
                                       dist.get_world_size())
    rows = np.array_split(np.arange(len(toks)), count)[index]
    t = torch.from_numpy(np.asarray(toks)[rows])
    m = None if mask is None else torch.from_numpy(np.asarray(mask)[rows])
    loss = module._loss(module.params, t[:, :-1], t[:, 1:], m)
    loss.backward()
    strategy.finish_grads([(n, p.grad) for n, p in module.params.items()])
    loss = strategy.reduce_mean({"loss": loss.detach()})["loss"]
    return float(loss), {n: _np(p.grad) for n, p in module.params.items()}


def _fit_rows(module, strategy_kw, toks, batch_size, steps, clip=None):
    """(loss, grad_norm) of each step of a fit under ``ShardedMesh(
    **strategy_kw)`` on this rank's share of ``toks``."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.trainer import Trainer

    rec = torch_jobs.StepRecorder()
    trainer = Trainer(
        strategy=torch_jobs.make_strategy("sharded", **strategy_kw),
        max_steps=steps, gradient_clip_val=clip, log_every_n_steps=1,
        enable_checkpointing=False, enable_progress_bar=False,
        callbacks=[rec], seed=0)
    index, count = trainer.strategy.data_shard(dist.get_rank(),
                                               dist.get_world_size())
    rows = np.array_split(np.arange(len(toks)), count)[index]
    trainer.fit(module, torch_jobs.llama_data(np.asarray(toks)[rows],
                                              None, batch_size))
    return rec.rows, trainer


# ---- the sequence axis ------------------------------------------------------


def _ring_case(mesh, q, k, v, g, causal, kind="ring"):
    """This rank's rows of the output and of the gradients of
    ``sum(out * g)``: ring or Ulysses attention over the mesh's seq axis
    on the rank's shards of the global q, k, v [B, S, H, D]."""
    from ray_lightning_tpu_torch.ops.ring_attention import ring_attention
    from ray_lightning_tpu_torch.ops.ulysses import ulysses_attention

    n = mesh["seq"].size()
    r = _coord(mesh, "seq")
    rows = _rows(mesh, q.shape[0])

    def shard(a, grad=True):
        return _t(np.array_split(a[rows], n, axis=1)[r], grad)

    qs, ks, vs = shard(q), shard(k), shard(v)
    fn = ring_attention if kind == "ring" else ulysses_attention
    out = fn(qs, ks, vs, mesh, causal=causal)
    (out * shard(g, False)).sum().backward()
    return {"rows": rows, "seq": r, "out": _np(out), "dq": _np(qs.grad),
            "dk": _np(ks.grad), "dv": _np(vs.grad)}


def seq_job(inp):
    """Every multi-process case of `tests/test_torch_ring_attention.py`
    on four ranks."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.ulysses import ulysses_attention

    out = {}
    seq4 = _mesh(seq=4)
    q, k, v, g = inp["mha"]
    for causal in (True, False):
        out[f"ring_seq4_{causal}"] = _ring_case(seq4, q, k, v, g, causal)
        out[f"ulysses_seq4_{causal}"] = _ring_case(seq4, q, k, v, g, causal,
                                                   kind="ulysses")
    with _all_to_all_route():
        out["ring_seq4_all_to_all"] = _ring_case(seq4, q, k, v, g, True)
    mixed = _mesh(data=2, seq=2)
    q, k, v, g = inp["gqa"]
    out["ring_gqa_data2_seq2"] = _ring_case(mixed, q, k, v, g, True)
    try:
        ulysses_attention(_t(q[:, :8]), _t(k[:, :8]), _t(v[:, :8]), seq4)
        out["ulysses_error"] = None
    except ValueError as e:
        out["ulysses_error"] = str(e)

    # the Llama: one loss and backward, and the logits of the rank's chunk
    for name, (cfg_kw, sizes) in inp["llama"].items():
        module, strategy = _module(inp["params"][name], cfg_kw, sizes)
        toks = inp["tokens"]
        loss, grads = _loss_and_grads(module, strategy, toks)
        model = strategy.unwrap(module.model)
        index, count = strategy.data_shard(dist.get_rank(),
                                           dist.get_world_size())
        rows = np.array_split(np.arange(len(toks)), count)[index]
        with torch.no_grad():
            t = model.seq_chunk(torch.from_numpy(toks[rows, :-1]))
            logits = module.apply(module.params, t)
        out[f"llama_{name}"] = {"loss": loss, "grads": grads,
                                "rows": rows, "seq": model.sp.rank,
                                "logits": _np(logits)}
    # a fit through the Trainer
    module = llama_module(inp["params"]["ring"], inp["llama"]["ring"][0])
    rows, _ = _fit_rows(module, dict(seq=2, data=2), inp["fit_tokens"],
                        batch_size=2, steps=2)
    out["fit_data2_seq2"] = rows
    module = llama_module(inp["params"]["ring"], inp["llama"]["ring"][0])
    rows, _ = _fit_rows(module, dict(seq=4), inp["fit_tokens"],
                        batch_size=4, steps=2, clip=0.5)
    out["fit_seq4"] = rows
    return out


# ---- the pipeline axis -----------------------------------------------------


def _gpipe_case(mesh, w, b, x, m, remat=False):
    """gpipe_apply on this rank's data rows: the output, and the
    gradients of mean(out**2) (the stacked weights' summed over pipe)."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.pipeline import gpipe_apply

    rows = _rows(mesh, x.shape[0])
    W, B_, X = _t(w, True), _t(b, True), _t(x[rows], True)

    def f(lp, h):
        import torch

        return torch.tanh(h @ lp["w"] + lp["b"])

    out = gpipe_apply(f, {"w": W, "b": B_}, X, mesh, microbatches=m,
                      remat=remat)
    # the mean over the global batch: this rank's share of it
    n_data = len(x) // len(rows)
    ((out ** 2).sum() / (out.numel() * n_data)).backward()
    gw, gb = W.grad.clone(), B_.grad.clone()
    if "pipe" in mesh.mesh_dim_names:
        dist.all_reduce(gw, group=mesh["pipe"].get_group())
        dist.all_reduce(gb, group=mesh["pipe"].get_group())
    return {"rows": rows, "out": _np(out), "dw": _np(gw), "db": _np(gb),
            "dx": _np(X.grad)}


def pipe_job(inp):
    """Every multi-process case of `tests/test_torch_gpipe.py` on four
    ranks."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.pipeline import gpipe_apply

    out = {}
    w, b, x = inp["stack4"]
    pipe4 = _mesh(pipe=4)
    for m in (2, 4):
        out[f"pipe4_m{m}"] = _gpipe_case(pipe4, w, b, x, m)
    for remat in (False, True):
        out[f"grads_remat{remat}"] = _gpipe_case(pipe4, w, b, x, 4, remat)
    with _all_to_all_route():
        out["pipe4_all_to_all"] = _gpipe_case(pipe4, w, b, x, 4)
    w8, b8, x8 = inp["stack8"]
    out["data2_pipe2_l8"] = _gpipe_case(_mesh(data=2, pipe=2), w8, b8, x8, 2)
    w3, b3, x3 = inp["stack3"]
    out["data4_l3"] = _gpipe_case(_mesh(data=4), w3, b3, x3, 2)
    errors = []
    for args in ((w3, b3, np.ones((8, 16)), 2), (w, b, np.ones((6, 16)), 4)):
        try:
            gpipe_apply(lambda lp, h: h, {"w": _t(args[0]),
                                          "b": _t(args[1])},
                        _t(args[2]), pipe4, microbatches=args[3])
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors

    # the Llama pipeline: one loss and backward against the dense path
    for name, (cfg_kw, sizes) in inp["llama"].items():
        module, strategy = _module(inp["params"][name], cfg_kw, sizes)
        loss, grads = _loss_and_grads(module, strategy, inp["tokens"])
        model = strategy.unwrap(module.model)
        out[f"llama_{name}"] = {
            "loss": loss, "grads": grads,
            "layers": sorted({n.split(".")[1] for n in grads
                              if n.startswith("layers.")}),
            "owned": [i for i, layer in enumerate(model.layers)
                      if any(True for _ in layer.parameters())]}
    module = llama_module(inp["params"]["fused"], inp["llama"]["fused"][0])
    rows, trainer = _fit_rows(module, dict(data=2, pipe=2),
                              inp["fit_tokens"], batch_size=4, steps=2)
    out["fit_data2_pipe2"] = rows
    out["fit_init_path"] = trainer.init_path

    # the pipelined classifier through the Trainer
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.pipelined import (
        PipelinedMLPModule,
        params_from_jax,
    )

    data = inp["mlp_data"]
    mod = PipelinedMLPModule(d=16, n_layers=4, microbatches=2,
                             in_features=8)
    mod.params = params_from_jax(inp["mlp_params"])
    rec = torch_jobs.StepRecorder()
    trainer = Trainer(strategy=torch_jobs.make_strategy(
        "sharded", data=2, pipe=2), max_epochs=6, callbacks=[rec],
        log_every_n_steps=1, enable_checkpointing=False,
        enable_progress_bar=False, seed=0)
    index, count = trainer.strategy.data_shard(dist.get_rank(),
                                               dist.get_world_size())
    half = {k: np.array_split(v, count)[index] for k, v in data.items()}
    trainer.fit(mod, DataLoader(half, batch_size=16),
                DataLoader(half, batch_size=16))
    w_param = dict(trainer.strategy.unwrap(mod.model).named_parameters())[
        "layers_w"]
    out["mlp"] = {"rows": rec.rows,
                  "val_acc": float(trainer.callback_metrics["val_acc"]),
                  "placements": str(w_param.placements),
                  "local_layers": w_param.to_local().shape[0]}
    return out


# ---- the expert axis -------------------------------------------------------



#: `moe_job`'s meshes for one loss and backward, by name
MOE_MESHES = {"data2_expert2": dict(data=2, expert=2),
              "expert4": dict(expert=4),
              "expert2_tensor2": dict(expert=2, tensor=2),
              "tensor2_data2": dict(tensor=2, data=2)}
#: those `moe_job` also fits 3 steps
MOE_FITS = ("data2_expert2", "expert2_tensor2", "tensor2_data2")


def _wrap(module, sizes):
    """``module`` with its ``params`` wrapped under ``ShardedMesh(
    **sizes)``, as the trainer wraps it (its trainer a stand-in holding
    the strategy): returns the strategy."""
    import torch

    strategy = torch_jobs.make_strategy("sharded", **sizes)
    strategy.setup(module)
    module.setup()
    with torch.no_grad():
        module.model.load_state_dict(module.params)
    module.model = strategy.wrap_model(module.model)
    module.params = dict(strategy.unwrap(module.model).named_parameters())
    module.trainer = types.SimpleNamespace(strategy=strategy)
    return strategy


def moe_job(inp):
    """Every multi-process case of `tests/test_torch_moe.py` on four
    ranks: the classifier's loss and gradients under each of
    ``MOE_MESHES``, its 3-step fit under each of ``MOE_FITS``, a
    checkpoint written by a fit under ``ShardedMesh(expert=2, tensor=2)``
    with that fit's whole state, that checkpoint restored under
    ``ShardedMesh(data=2, expert=2)`` and the one-rank checkpoint
    ``inp["single_ckpt"]`` under ``ShardedMesh(expert=2, tensor=2)``."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.moe import (
        MoEClassifierModule,
        params_from_jax,
    )

    out = {}
    # the classifier's loss and gradients, one step, and a fit
    for name, sizes in MOE_MESHES.items():
        mod = MoEClassifierModule(**inp["module_kw"])
        mod.params = params_from_jax(inp["params"])
        strategy = _wrap(mod, sizes)
        index, count = strategy.data_shard(dist.get_rank(),
                                           dist.get_world_size())
        x, y = (np.array_split(inp["batch"][k], count)[index]
                for k in ("x", "y"))
        logits, aux = mod.apply(mod.params, _t(x))
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long()) + mod.aux_weight * aux
        loss.backward()
        strategy.finish_grads([(n, p.grad) for n, p in mod.params.items()])
        w = mod.params["moe.w_gate_up"]
        out[name] = {
            "loss": float(strategy.reduce_mean(
                {"loss": loss.detach()})["loss"]),
            "aux": float(aux), "index": index, "count": count,
            "logits": _np(logits),
            "grads": {n: _np(strategy.canonical_value(n, p.grad))
                      for n, p in mod.params.items()},
            "norm": float(strategy.global_norm(
                [p.grad for p in mod.params.values()])),
            "local_experts": w.to_local().shape[0],
            "local_columns": w.to_local().shape[2]}

    def fit(sizes, steps, callbacks=(), **fit_kw):
        mod = MoEClassifierModule(**inp["module_kw"])
        mod.params = params_from_jax(inp["params"])
        rec = torch_jobs.StepRecorder()
        trainer = Trainer(strategy=torch_jobs.make_strategy(
            "sharded", **sizes), max_steps=steps, callbacks=[rec, *callbacks],
            log_every_n_steps=1, enable_checkpointing=False,
            enable_progress_bar=False, seed=0)
        index, count = trainer.strategy.data_shard(dist.get_rank(),
                                                   dist.get_world_size())
        share = {k: np.array_split(v, count)[index]
                 for k, v in inp["fit_data"].items()}
        trainer.fit(mod, DataLoader(share,
                                    batch_size=inp["fit_batch"] // count),
                    **fit_kw)
        w = dict(trainer.strategy.unwrap(mod.model).named_parameters())[
            "moe.w_gate_up"]
        return rec.rows, trainer, mod, w

    out["fit"] = {}
    for name in MOE_FITS:
        rows, trainer, _, w = fit(MOE_MESHES[name], 3)
        out["fit"][name] = {"rows": rows, "placements": str(w.placements),
                            "mesh": trainer.strategy.mesh_shape}
    # a checkpoint of the expert bank split over expert and tensor, and
    # the fit's state at its end, gathered in the canonical layout
    _, trainer, mod, w = fit(dict(expert=2, tensor=2), 2, [ModelCheckpoint(
        dirpath=inp["ckpt_dir"], every_n_train_steps=2, save_top_k=-1)])
    path = trainer.checkpoint_callback.best_model_path
    out["ckpt"] = {"path": path,
                   "state": torch_jobs.full_state(trainer, mod),
                   "placements": str(w.placements),
                   "local_shape": tuple(w.to_local().shape)}
    # the layouts crossed: that checkpoint restored under expert=2 alone,
    # and the one-rank checkpoint under expert=2 x tensor=2, each state as
    # the restore left it
    for key, sizes, ck in (("into_expert2", dict(data=2, expert=2), path),
                           ("single_into_expert2_tensor2",
                            dict(expert=2, tensor=2), inp["single_ckpt"])):
        keep = AtStart()
        fit(sizes, 3, [keep.callback], ckpt_path=ck)
        out[key] = keep.state
    return out


# ---- BERT under the tensor axis --------------------------------------------


def bert_module(inp, dropout=0.0):
    """The tiny BERT classifier of `tests/test_torch_bert_tensor.py` with
    the JAX init's weights (``inp["params"]``) and ``dropout``."""
    import torch

    from ray_lightning_tpu_torch.models.bert import (
        BertClassifierModule,
        BertConfig,
        params_from_jax,
    )

    cfg = BertConfig.tiny(dtype=torch.float32, dropout=dropout,
                          **inp["cfg_kw"])
    module = BertClassifierModule(cfg, **inp["module_kw"])
    if inp.get("params") is not None:
        module.params = params_from_jax(inp["params"])
    return module


class AtStart:
    """Keeps `torch_jobs.full_state` at the fit's start (after a
    restore) in ``state``; ``callback`` is the trainer's callback."""

    def __init__(self):
        from ray_lightning_tpu_torch.core.callbacks import Callback

        keep = self

        class Keep(Callback):
            def on_fit_start(self, trainer, module):
                keep.state = torch_jobs.full_state(trainer, module)

        self.callback = Keep()


def _bert_fit(inp, sizes, steps, dropout=0.0, callbacks=(), **fit_kw):
    """A fit of `bert_module` under ``ShardedMesh(**sizes)`` on this
    rank's share of each of ``inp["batches"]``: (rows, trainer,
    module)."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.trainer import Trainer

    module = bert_module(inp, dropout)
    rec = torch_jobs.StepRecorder()
    trainer = Trainer(strategy=torch_jobs.make_strategy("sharded", **sizes),
                      max_steps=steps, log_every_n_steps=1,
                      enable_checkpointing=False, enable_progress_bar=False,
                      seed=0, callbacks=[rec, *callbacks])
    index, count = trainer.strategy.data_shard(dist.get_rank(),
                                               dist.get_world_size())
    shares = [{k: np.array_split(v, count)[index] for k, v in b.items()}
              for b in inp["batches"]]
    trainer.fit(module, shares, **fit_kw)
    return rec.rows, trainer, module


def _live_bytes(trainer, module):
    """(parameter, optimizer state) storage bytes this rank holds: what
    the planner plans."""
    from ray_lightning_tpu_torch.parallel.tensor import local

    opt = trainer.state.optimizer
    return (sum(local(p).untyped_storage().nbytes()
                for p in module.params.values()),
            sum(local(t).untyped_storage().nbytes()
                for st in opt.state.values() for t in st.values()))


def bert_tensor_job(inp):
    """Every multi-process case of `tests/test_torch_bert_tensor.py` for
    the mesh ``inp["sizes"]``: the fit (its rows, final state and bytes)
    and one loss and backward (every gradient in the canonical layout);
    on the ``tensor=2`` mesh also a checkpoint written at step 2, the
    restore of the `SingleDevice` checkpoint ``inp["single_ckpt"]``, and
    the fit at dropout 0.5."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint

    sizes = inp["sizes"]
    out = {}
    rows, trainer, module = _bert_fit(inp, sizes, inp["steps"])
    layer = trainer.strategy.unwrap(module.model).encoder.layers[0]
    out["fit"] = {"rows": rows,
                  "state": torch_jobs.full_state(trainer, module)[0],
                  "tp": layer.tp.size,
                  "wqkv_local": tuple(layer.wqkv.weight.to_local().shape),
                  "bytes": _live_bytes(trainer, module)}

    module = bert_module(inp)
    strategy = _wrap(module, sizes)
    index, count = strategy.data_shard(dist.get_rank(),
                                       dist.get_world_size())
    batch = {k: torch.from_numpy(np.array_split(v, count)[index])
             for k, v in inp["grad_batch"].items()}
    loss, _ = module._loss_acc(module._forward(module.params, batch),
                               batch["labels"])
    loss.backward()
    strategy.finish_grads([(n, p.grad) for n, p in module.params.items()])
    out["grads"] = {
        "loss": float(strategy.reduce_mean({"loss": loss.detach()})["loss"]),
        "grads": {n: _np(strategy.canonical_value(n, p.grad))
                  for n, p in module.params.items()}}
    if sizes != {"tensor": 2}:
        return out

    _, trainer, module = _bert_fit(inp, sizes, 2, callbacks=[
        ModelCheckpoint(dirpath=inp["ckpt_dir"], every_n_train_steps=2,
                        save_top_k=-1)])
    out["ckpt"] = {"path": trainer.checkpoint_callback.best_model_path,
                   "state": torch_jobs.full_state(trainer, module)}
    keep = AtStart()
    _bert_fit(inp, sizes, 3, callbacks=[keep.callback],
              ckpt_path=inp["single_ckpt"])
    out["restored"] = keep.state
    rows, _, _ = _bert_fit(inp, sizes, inp["steps"], dropout=0.5)
    out["dropout_rows"] = rows
    return out


def live_bytes_job(inp):
    """`tests/test_torch_plan.py`'s four ranks: each of ``inp``'s fits
    ({name: (module kind, ShardedMesh sizes, rows)}), 2 steps, and this
    rank's parameter and optimizer bytes after them, by name."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.moe import MoEClassifierModule

    out = {}
    for name, (kind, sizes, batches) in inp.items():
        module = (bert_module(dict(cfg_kw={}, module_kw={}))
                  if kind == "bert" else MoEClassifierModule(in_features=16))
        trainer = Trainer(
            strategy=torch_jobs.make_strategy("sharded", **sizes),
            max_steps=2, enable_checkpointing=False,
            enable_progress_bar=False, seed=0)
        index, count = trainer.strategy.data_shard(dist.get_rank(),
                                                   dist.get_world_size())
        trainer.fit(module, [{k: np.array_split(v, count)[index]
                              for k, v in b.items()} for b in batches])
        out[name] = _live_bytes(trainer, module)
    return out
