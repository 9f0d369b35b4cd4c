"""``python -m ray_lightning_tpu_torch elastic``: the elastic-training
smoke gate (twin of `ray_lightning_tpu/elastic/cli.py`).

``--smoke --device cpu`` runs two legs over gloo on the CPU:

  reshard   a two-process ``FSDP`` run (fsdp=2) saves a
            provenance-stamped checkpoint; one process then resumes a
            fresh ``FSDP`` trainer from it at world 1 (the trainer's own
            cross-topology restore, `Trainer._reshard_move`, recorded as
            a `reshard` span), every parameter and AdamW leaf restored
            BITWISE the checkpoint's, both through the resume and
            through `reshard_restore` onto the strategy's state dicts;
            the resumed run still converges. The JAX gate moves 8
            virtual devices of one process to 4; the port drives one
            device a process, so its move is two gloo processes to one.
  shrink    a two-process supervised run with an injected worker kill
            and a retry policy that refuses any same-size relaunch
            (max_restarts=0) must consult its ElasticBudget, reshard the
            latest valid checkpoint onto the survivor world (2 -> 1),
            resume and converge — with the world change in
            `SupervisedResult.reshards` and the `reshard_s` goodput
            bucket present.

On the card the same moves run in ``chip_smoke.py`` phase 14 (two
tensor ranks sharing the one card over gloo); a supervised world change
needs a second card, which the one-card machine does not have.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from ray_lightning_tpu_torch.core.callbacks import Callback

# ---- smoke factories: module-level, so workers import this module by
# name and the standard pickle sends them by reference ----

_SMOKE_CLASSES = 4
_SMOKE_ROWS = 256
_SMOKE_BATCH = 16


def _smoke_module():
    from ray_lightning_tpu_torch.models.mlp import MLPClassifier

    return MLPClassifier(features=(32,), num_classes=_SMOKE_CLASSES,
                         lr=5e-2, in_features=8)


def _smoke_trainer(device=None, max_epochs: int = 2):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import FSDP

    return Trainer(
        # FSDP (not DP) on purpose: the world change then moves REAL
        # shards, not replicated copies — min_shard_size lowered so the
        # smoke MLP's small leaves shard
        strategy=FSDP(min_shard_size=8, device=device),
        max_epochs=max_epochs,
        enable_progress_bar=False,
        enable_checkpointing=False,  # the supervisor adds its own cadence
        seed=0,
        log_every_n_steps=1,
    )


def _smoke_data():
    import numpy as np

    from ray_lightning_tpu_torch.core.data import DataLoader

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(_SMOKE_CLASSES, 8)) * 3
    y = rng.integers(0, _SMOKE_CLASSES, size=_SMOKE_ROWS)
    x = (centers[y] + rng.normal(size=(_SMOKE_ROWS, 8)) * 0.1).astype(
        np.float32)
    train = DataLoader({"x": x, "y": y}, batch_size=_SMOKE_BATCH,
                       shuffle=True)
    val = DataLoader({"x": x, "y": y}, batch_size=_SMOKE_BATCH)
    return train, val


def flat_state(tree, prefix: str = ""):
    """``{path: tensor}`` of a (nested) state dict, DTensors as their
    full values and scalars as tensors: the form two layouts of one
    state compare in."""
    import torch

    from ray_lightning_tpu_torch.parallel.tensor import full_value

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_state(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_state(v, f"{prefix}{i}/"))
        return out
    tree = full_value(tree)
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree.detach().cpu()}
    if isinstance(tree, (int, float)):
        return {prefix.rstrip("/"): torch.tensor(tree)}
    return {}


def state_mismatches(a: dict, b: dict) -> list:
    """Paths whose tensors differ in dtype, shape or any bit (or are
    missing on one side)."""
    import torch

    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if (x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(x, y)):
            bad.append(k)
    return bad


def _reshard_save_remote(ck: str, device: str):
    """Rank r of the fsdp=2 world: fit, then save the checkpoint (every
    rank writes its own pieces)."""
    trainer = _smoke_trainer(device)
    train, val = _smoke_data()
    trainer.fit(_smoke_module(), train, val)
    trainer.save_checkpoint(ck)
    return trainer.strategy.mesh_shape


class _RestoreCheck(Callback):
    """The resumed state against the checkpoint's bytes, right after the
    trainer's restore and before its first step."""

    def __init__(self, ck: str):
        self.ck = ck
        self.mismatches = None
        self.leaves = 0

    def on_load_checkpoint(self, trainer, module, restored) -> None:
        from ray_lightning_tpu_torch.checkpoint.io import load_checkpoint

        src = load_checkpoint(self.ck)
        want = flat_state({k: src[k] for k in ("params", "opt_state")})
        got = flat_state({k: restored[k] for k in ("params", "opt_state")})
        self.leaves = len(want)
        self.mismatches = state_mismatches(want, got)


def _reshard_resume_remote(ck: str, device: str):
    """One process: resume at world 1 from the fsdp=2 checkpoint through
    the trainer's cross-mesh restore, then `reshard_restore` the same
    checkpoint onto the strategy's state dicts."""
    from ray_lightning_tpu_torch.checkpoint.io import (
        load_checkpoint,
        read_meta,
    )
    from ray_lightning_tpu_torch.elastic.reshard import reshard_restore

    out: dict = {"ok": False}
    out["provenance"] = sorted(
        k for k in read_meta(ck) if k in ("mesh_spec", "topology",
                                          "param_specs"))
    check = _RestoreCheck(ck)
    trainer = _smoke_trainer(device, max_epochs=3)
    trainer.callbacks.append(check)
    train, val = _smoke_data()
    module = _smoke_module()
    metrics = trainer.fit(module, train, val, ckpt_path=ck)
    out["move"] = trainer.last_reshard
    out["leaves"] = check.leaves
    out["resume_mismatches"] = check.mismatches
    # the library call: the checkpoint onto this strategy's layout
    params, osd = trainer.strategy.state_dicts(module.model,
                                               trainer.state.optimizer)
    target = {"params": params, "opt_state": osd, "step": 0}
    restored = reshard_restore(ck, target, mesh=trainer.strategy.mesh)
    src = load_checkpoint(ck)
    out["restore_mismatches"] = state_mismatches(
        flat_state({k: src[k] for k in ("params", "opt_state")}),
        flat_state({k: restored[k] for k in ("params", "opt_state")}))
    out["bitwise_equal"] = (check.mismatches == []
                            and out["restore_mismatches"] == [])
    acc = metrics.get("ptl/val_accuracy")
    out["continued_val_accuracy"] = float(acc) if acc is not None else None
    out["continued"] = acc is not None and float(acc) > 0.8
    out["ok"] = bool(out["bitwise_equal"] and out["continued"]
                     and out["leaves"] > 0
                     and (out["move"] or {}).get("changed_axes") == ["fsdp"]
                     and len(out["provenance"]) == 3)
    return out


def add_elastic_parser(sub) -> None:
    p = sub.add_parser(
        "elastic",
        help="elastic-training smoke gate: cross-topology reshard "
             "restore (bitwise) + supervised shrink-on-failure")
    p.add_argument("--smoke", action="store_true",
                   help="run the gate: the fsdp=2 -> world 1 "
                        "reshard-bitwise leg and the world 2 -> 1 "
                        "supervised shrink leg")
    p.add_argument("--processes", type=int, default=2,
                   help="shrink leg's launch world size")
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo on the CPU (the gate's device); "
                        "the card's lanes are chip_smoke.py phase 14")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _reshard_leg(args, base_dir: str) -> dict:
    from ray_lightning_tpu_torch.runtime.launch import launch

    ck = os.path.join(base_dir, "reshard", "ck")
    logs = os.path.join(base_dir, "reshard", "workers")
    src = launch(_reshard_save_remote, 2, args=(ck, args.device),
                 device=args.device, timeout=args.timeout, log_dir=logs)
    leg = launch(_reshard_resume_remote, 1, args=(ck, args.device),
                 device=args.device, timeout=args.timeout, log_dir=logs)[0]
    leg["src_mesh"] = src[0]
    if not leg["ok"]:
        leg["error"] = (
            f"reshard leg failed: move={leg.get('move')}, "
            f"resume_mismatches={leg.get('resume_mismatches')}, "
            f"restore_mismatches={leg.get('restore_mismatches')}, "
            f"acc={leg.get('continued_val_accuracy')}")
    return leg


def _shrink_leg(args, base_dir: str) -> dict:
    from ray_lightning_tpu_torch.elastic.budget import ElasticBudget
    from ray_lightning_tpu_torch.resilience.policy import RetryPolicy
    from ray_lightning_tpu_torch.resilience.supervisor import (
        ResilienceConfig,
        SupervisedFailure,
        fit_supervised,
    )

    cfg = ResilienceConfig(
        checkpoint_dir=os.path.join(base_dir, "shrink"),
        # max_restarts=0: the same-size relaunch is REFUSED, so the kill
        # can only be survived by the elastic shrink
        policy=RetryPolicy(max_restarts=0, backoff_base_s=0.2,
                           jitter=0.0),
        save_every_n_steps=1,
        stall_timeout_s=0.0,
        heartbeat_interval_s=1.0,
        elastic=ElasticBudget(min_world=1, max_reshards=2),
        faults=f"kill:rank={min(1, args.processes - 1)},step=3",
    )
    leg: dict = {"ok": False}
    try:
        supervised = fit_supervised(
            _smoke_module, functools.partial(_smoke_trainer, args.device),
            _smoke_data, args.processes, resilience=cfg,
            device=args.device, return_weights=False, timeout=args.timeout,
            log_dir=os.path.join(cfg.checkpoint_dir, "workers"))
    except SupervisedFailure as exc:
        leg["error"] = str(exc)
        return leg
    acc = supervised.result.metrics.get("ptl/val_accuracy")
    buckets = ((supervised.goodput or {}).get("buckets") or {})
    leg.update({
        "reshards": supervised.reshards,
        "final_world": supervised.final_world,
        "val_accuracy": float(acc) if acc is not None else None,
        "reshard_bucket_present": "reshard_s" in buckets,
        "reshard_s": buckets.get("reshard_s"),
    })
    shrunk = (len(supervised.reshards) >= 1
              and supervised.final_world == 1
              and supervised.reshards[0]["reason"] == "shrink")
    converged = acc is not None and float(acc) > 0.8
    leg["ok"] = bool(shrunk and converged
                     and leg["reshard_bucket_present"])
    if not leg["ok"]:
        leg["error"] = (
            f"shrink leg failed: reshards={supervised.reshards}, "
            f"final_world={supervised.final_world}, acc={acc}, "
            f"reshard_bucket={leg['reshard_bucket_present']}")
    return leg


def run_elastic(args) -> int:
    import tempfile

    from ray_lightning_tpu_torch.utils.devices import resolve_device

    if not args.smoke:
        print("error: only --smoke is implemented; the library API is "
              "elastic.reshard_restore and "
              "ResilienceConfig(elastic=ElasticBudget(...))",
              file=sys.stderr)
        return 2
    if resolve_device(args.device).type != "cpu":
        print("elastic --smoke is the CPU gate (two gloo processes): pass "
              "--device cpu. On the card, chip_smoke.py phase 14 holds "
              "the resharding restores", file=sys.stderr)
        return 2
    out: dict = {}
    base = args.checkpoint_dir or tempfile.mkdtemp(
        prefix="rlt_elastic_smoke_")
    out["checkpoint_dir"] = base
    try:
        out["reshard"] = _reshard_leg(args, base)
    except Exception as exc:  # noqa: BLE001 — the gate must report,
        # not traceback
        out["reshard"] = {"ok": False,
                          "error": f"{type(exc).__name__}: {exc}"}
    out["shrink"] = _shrink_leg(args, base)
    out["ok"] = bool(out["reshard"].get("ok") and out["shrink"].get("ok"))
    if getattr(args, "as_json", False):
        print(json.dumps(out, default=str))
    else:
        r, s = out["reshard"], out["shrink"]
        print(f"elastic {'ok' if out['ok'] else 'FAILED'}:")
        print(f"  reshard: {'ok' if r.get('ok') else 'FAILED'} "
              f"bitwise_equal={r.get('bitwise_equal')} "
              f"leaves={r.get('leaves')} "
              f"continued_acc={r.get('continued_val_accuracy')}")
        print(f"  shrink:  {'ok' if s.get('ok') else 'FAILED'} "
              f"reshards={[(e['from_world'], e.get('to_world')) for e in s.get('reshards') or []]} "
              f"acc={s.get('val_accuracy')} "
              f"reshard_bucket={s.get('reshard_bucket_present')}")
        for leg in ("reshard", "shrink"):
            if out[leg].get("error"):
                print(f"  {leg} error: {out[leg]['error']}",
                      file=sys.stderr)
    return 0 if out["ok"] else 1
