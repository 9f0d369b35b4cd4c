"""``python -m ray_lightning_tpu_torch supervise``: a training job under
the resilience supervisor, from the command line (twin of
`ray_lightning_tpu/resilience/cli.py`).

Two modes:

  --smoke         the fault-injection gate, three supervised legs of a
                  small MLP classifier under DataParallel:
                    kill      an injected worker kill must resume from
                              the step-cadence checkpoint and converge;
                    guard-nan an injected NaN batch must be SKIPPED by
                              the trainguard on the device (no restart)
                              and the run converge;
                    guard-sdc an injected parameter bit flip on rank 1
                              must be caught by the fingerprint probe
                              within one cadence, rank 1 quarantined, and
                              the run roll back to a blessed checkpoint
                              and converge. A process drives one device,
                              so this leg runs at least three processes:
                              with two replicas a mismatch cannot name
                              the liar.
                  ``--device cpu`` runs it over gloo on the CPU; without
                  it the workers take the cards (one a process).
                  ``--no-guard`` drops the two guard legs.

  <target>        ``pkg.mod:factory`` where factory() returns a dict with
                  module_factory / trainer_factory / data_factory, the
                  triple fit_distributed takes (by reference: module
                  level callables or partials). The supervision knobs
                  (--max-restarts, --faults, --checkpoint-dir) apply.

Fault specs (--faults / RLT_FAULTS) are documented in
resilience/faults.py.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import tempfile

# ---- the smoke job: module-level factories (workers import this module
# by name; the standard pickle sends them by reference) ----

_SMOKE_CLASSES = 4
_SMOKE_ROWS = 256
_SMOKE_BATCH = 16


def _smoke_module():
    from ray_lightning_tpu_torch.models.mlp import MLPClassifier

    return MLPClassifier(features=(32,), num_classes=_SMOKE_CLASSES,
                         lr=5e-2, in_features=8)


def _smoke_trainer(device=None):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    return Trainer(
        strategy=DataParallel(device=device),
        max_epochs=2,
        enable_progress_bar=False,
        enable_checkpointing=False,  # the supervisor adds its own cadence
        seed=0,
        # every step's metrics on the host: the guard legs' escalation
        # check rides the fetch cadence, and the job is tiny
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


def add_supervise_parser(sub) -> None:
    p = sub.add_parser(
        "supervise",
        help="run a distributed fit under the resilience supervisor "
             "(restart and resume on transient failures)")
    p.add_argument("target", nargs="?", default=None,
                   help="pkg.mod:factory returning {module_factory, "
                        "trainer_factory, data_factory}; omit with --smoke")
    p.add_argument("--smoke", action="store_true",
                   help="built-in gate: an injected worker kill and the "
                        "trainguard legs (an injected NaN must be skipped "
                        "on the device; an injected bit flip must "
                        "quarantine its rank)")
    p.add_argument("--no-guard", action="store_true",
                   help="with --smoke: drop the two trainguard legs")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo on the CPU; default: the cards")
    p.add_argument("--faults", default=None,
                   help="fault-injection plan, e.g. 'kill:rank=1,step=3' "
                        "(default for --smoke: exactly that)")
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--save-every", type=int, default=1,
                   help="step-cadence checkpoint interval the resume "
                        "rides on")
    p.add_argument("--checkpoint-dir", default=None,
                   help="supervisor checkpoint dir (default: a temp dir "
                        "for --smoke, ./rlt_logs/supervise otherwise)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="silent-heartbeat budget in seconds "
                        "(0 disables the stall watchdog)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-attempt wall-clock budget")
    p.add_argument("--json", action="store_true", dest="as_json")


def _load_target(spec: str):
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"error: target must be pkg.mod:factory, "
                         f"got {spec!r}")
    job = getattr(importlib.import_module(mod_name), attr)()
    missing = {"module_factory", "trainer_factory", "data_factory"} - set(job)
    if missing:
        raise SystemExit(
            f"error: {spec} returned no {sorted(missing)} "
            "(need module_factory/trainer_factory/data_factory)")
    return job


def _run_supervised_job(job, cfg, args, processes=None):
    """One supervised fit under the CLI's knobs. Returns
    ``(supervised_or_None, out_fields)``."""
    from ray_lightning_tpu_torch.resilience.supervisor import (
        SupervisedFailure,
        fit_supervised,
    )

    try:
        supervised = fit_supervised(
            job["module_factory"], job["trainer_factory"],
            job["data_factory"], processes or args.processes,
            resilience=cfg, device=args.device, return_weights=False,
            timeout=args.timeout,
            log_dir=os.path.join(cfg.checkpoint_dir, "workers"))
    except SupervisedFailure as exc:
        return None, {"ok": False, "error": str(exc),
                      "classified": exc.classified.to_dict()}
    metrics = supervised.result.metrics
    acc = metrics.get("ptl/val_accuracy")
    return supervised, {
        "ok": True,
        "restarts": supervised.restarts,
        "preemptions": supervised.preemptions,
        "rollbacks": supervised.rollbacks,
        "quarantined": supervised.quarantined,
        "attempts": supervised.total_attempts,
        "failures": supervised.failures,
        "val_accuracy": float(acc) if acc is not None else None,
        "metrics": {k: v for k, v in metrics.items()
                    if isinstance(v, (int, float))},
    }


def _smoke_job(args):
    return {"module_factory": _smoke_module,
            "trainer_factory": functools.partial(_smoke_trainer,
                                                 args.device),
            "data_factory": _smoke_data}


def _smoke_guard_legs(args, base_dir) -> dict:
    """The trainguard legs of --smoke: an injected NaN batch skipped on
    the device (no restart) and the run converged; an injected bit flip
    caught by the probe, its rank quarantined, the rolled-back run
    converged."""
    from ray_lightning_tpu_torch.resilience.guard import GuardConfig
    from ray_lightning_tpu_torch.resilience.policy import RetryPolicy
    from ray_lightning_tpu_torch.resilience.supervisor import (
        ResilienceConfig,
    )

    job = _smoke_job(args)

    def _cfg(name, guard, faults):
        return ResilienceConfig(
            checkpoint_dir=os.path.join(base_dir, name),
            policy=RetryPolicy(max_restarts=args.max_restarts,
                               backoff_base_s=0.5, jitter=0.0),
            save_every_n_steps=args.save_every,
            stall_timeout_s=args.stall_timeout,
            heartbeat_interval_s=1.0, guard=guard, faults=faults)

    legs: dict = {}
    _, out = _run_supervised_job(
        job, _cfg("guard_nan", GuardConfig(warmup_steps=2),
                  "nan_loss:rank=0,step=3"), args)
    skipped = (out.get("metrics") or {}).get("guard_skipped_steps", 0)
    acc = out.get("val_accuracy")
    ok = (out["ok"] and out.get("attempts") == 1 and skipped >= 1
          and acc is not None and acc > 0.8)
    legs["guard_nan"] = {"ok": bool(ok), "attempts": out.get("attempts"),
                         "guard_skipped_steps": skipped,
                         "val_accuracy": acc}
    if not ok:
        legs["guard_nan"]["error"] = (
            out.get("error")
            or "injected NaN was not skipped on the device without a "
               f"restart (attempts={out.get('attempts')}, "
               f"skipped={skipped}, acc={acc})")

    # at least three replicas: the flipped rank is outvoted and named
    _, out = _run_supervised_job(
        job, _cfg("guard_sdc", GuardConfig(sdc_every_n_steps=2),
                  "bitflip_param:rank=1,step=3"), args,
        processes=max(3, args.processes))
    acc = out.get("val_accuracy")
    ok = (out["ok"] and out.get("rollbacks", 0) >= 1
          and out.get("quarantined") == [1]
          and acc is not None and acc > 0.8)
    legs["guard_sdc"] = {"ok": bool(ok), "rollbacks": out.get("rollbacks"),
                         "quarantined": out.get("quarantined"),
                         "val_accuracy": acc}
    if not ok:
        legs["guard_sdc"]["error"] = (
            out.get("error")
            or "injected bit flip was not caught and quarantined "
               f"(rollbacks={out.get('rollbacks')}, "
               f"quarantined={out.get('quarantined')}, acc={acc})")
    return legs


def run_supervise(args) -> int:
    from ray_lightning_tpu_torch.resilience.policy import RetryPolicy
    from ray_lightning_tpu_torch.resilience.supervisor import (
        ResilienceConfig,
    )

    if not args.smoke and not args.target:
        print("error: pass a pkg.mod:factory target or --smoke",
              file=sys.stderr)
        return 2
    if args.smoke:
        job = _smoke_job(args)
        faults = args.faults if args.faults is not None else (
            f"kill:rank={min(1, args.processes - 1)},step=3")
    else:
        job = _load_target(args.target)
        faults = args.faults

    ckpt_base = args.checkpoint_dir or (
        tempfile.mkdtemp(prefix="rlt_supervise_smoke_") if args.smoke
        else os.path.join(os.getcwd(), "rlt_logs", "supervise"))
    cfg = ResilienceConfig(
        checkpoint_dir=(os.path.join(ckpt_base, "kill") if args.smoke
                        else ckpt_base),
        policy=RetryPolicy(max_restarts=args.max_restarts,
                           backoff_base_s=0.5 if args.smoke else 2.0),
        save_every_n_steps=args.save_every,
        stall_timeout_s=args.stall_timeout,
        heartbeat_interval_s=1.0 if args.smoke else 5.0,
        faults=faults,
    )
    out: dict = {"checkpoint_dir": ckpt_base, "faults": faults}
    supervised, fields = _run_supervised_job(job, cfg, args)
    out.update(fields)
    if supervised is None:
        if args.as_json:
            print(json.dumps(out))
        else:
            print(f"supervise FAILED: {out.get('error')}", file=sys.stderr)
        return 1
    acc = out.get("val_accuracy")
    if args.smoke:
        # the gate: the kill FIRED (else the run proved nothing) and the
        # resumed run still converged
        recovered = supervised.total_attempts >= 2
        converged = acc is not None and acc > 0.8
        out["ok"] = recovered and converged
        if not recovered:
            out["error"] = ("injected fault never fired: the smoke run "
                            "exercised nothing")
        elif not converged:
            out["error"] = f"resumed run did not converge (acc={acc})"
        if not args.no_guard:
            legs = _smoke_guard_legs(args, ckpt_base)
            out["guard_legs"] = legs
            if not all(leg["ok"] for leg in legs.values()):
                out["ok"] = False
                out.setdefault("error", "; ".join(
                    f"{name}: {leg.get('error')}"
                    for name, leg in legs.items() if not leg["ok"]))
    if args.as_json:
        print(json.dumps(out))
    else:
        status = "ok" if out["ok"] else "FAILED"
        print(f"supervise {status}: attempts={out['attempts']} "
              f"restarts={out['restarts']} "
              f"preemptions={out['preemptions']} "
              f"rollbacks={out['rollbacks']} "
              + (f"val_accuracy={acc:.3f}" if acc is not None else ""))
        for f in supervised.failures:
            print(f"  attempt {f['attempt']}: [{f['kind']}/{f['cause']}"
                  + (f" rank {f['rank']}" if f.get("rank") is not None
                     else "") + f"] {f['detail']}")
        for name, leg in (out.get("guard_legs") or {}).items():
            print(f"  {name}: {'ok' if leg['ok'] else 'FAILED'} "
                  + " ".join(f"{k}={v}" for k, v in leg.items()
                             if k != "ok"))
        if not out["ok"]:
            print(f"error: {out.get('error')}", file=sys.stderr)
    return 0 if out["ok"] else 1

