"""The port's resilience layer (`ray_lightning_tpu_torch.resilience`)
held against the JAX package's, in one process on the CPU: the fault
grammar and its errors, fire-once markers across restarts, checkpoint
corruption and the validity filter, the preemption flag and drain, the
heartbeat and the stall monitor, a kill-at-step-J resume that is
bitwise the straight run, the supervisor's worker-side wiring and its
knobs that wait for later items. The process-level drills are in
`test_torch_resilience_process.py`.
"""
from __future__ import annotations

import os
import signal as _signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.resilience as jres
from ray_lightning_tpu.resilience import faults as jfaults
from ray_lightning_tpu.resilience import health as jhealth
from ray_lightning_tpu.resilience.policy import (
    classify_failure as jax_classify,
)
from ray_lightning_tpu_torch import resilience as pres
from ray_lightning_tpu_torch.checkpoint import (
    latest_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.mlp import MLPClassifier
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience import faults as pfaults
from ray_lightning_tpu_torch.resilience import health as phealth
from ray_lightning_tpu_torch.resilience.policy import (
    FailureKind,
    StallError,
    classify_failure,
)
from ray_lightning_tpu_torch.resilience.preempt import (
    PreemptedError,
    PreemptionGuard,
    install_preemption_handlers,
    preemption_requested,
    reset_preemption,
)
from ray_lightning_tpu_torch.runtime.group import WorkerError
from tests import torch_jobs

# ---------------------------------------------------------------- faults

SPECS = [
    "kill:rank=1,step=3; preempt:rank=*,step=2;"
    "corrupt_latest:rank=0,step=4,dir=/tmp/ck",
    "nan_loss:rank=0,step=3,count=5; grad_blowup:rank=*,step=2",
    "bitflip_param:rank=1,step=4,bit=7,device=1,element=3",
    "exit:rank=1,step=3,rc=7;hang:rank=0,step=6,secs=20;raise:step=9",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_jax(spec):
    """The same plan parses to the same faults (kind, rank, step, args,
    index), with the same markers and the same matching."""
    mine, theirs = pfaults.parse_faults(spec), jfaults.parse_faults(spec)
    assert [dataclass_fields(f) for f in mine] == \
        [dataclass_fields(f) for f in theirs]
    for a, b in zip(mine, theirs):
        assert a.marker(1) == b.marker(1)
        for rank in (0, 1, 2):
            for step in (1, 3, 5, 9):
                assert a.matches(rank, step) == b.matches(rank, step)


def dataclass_fields(f):
    return (f.kind, f.rank, f.step, dict(f.args), f.index)


@pytest.mark.parametrize("spec", ["explode:rank=0,step=1", "kill:rank",
                                  "kill:rank=0,step=x"])
def test_parse_faults_errors_match_jax(spec):
    with pytest.raises(ValueError) as mine:
        pfaults.parse_faults(spec)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_faults(spec)
    assert str(mine.value) == str(theirs.value)


def test_fault_injector_fires_once_across_restarts(tmp_path):
    """The marker lands BEFORE the fault fires, so a restarted run
    (same state dir) sails past the step that killed its predecessor."""
    state = str(tmp_path / "fault_state")

    class _T:
        global_step = 3

    fault = pfaults.Fault("raise", None, 3, {}, index=0)
    with pytest.raises(RuntimeError, match="injected fatal failure"):
        pfaults.FaultInjector([fault], state).on_train_batch_end(
            _T(), None, {}, 0)
    # a FRESH injector (a new process after the restart) sees the marker
    pfaults.FaultInjector([fault], state).on_train_batch_end(_T(), None, {},
                                                             0)
    assert os.listdir(state) == [fault.marker(0)]


def _ckpt(path, step, n=1024):
    return save_checkpoint(str(path), {"w": torch.arange(n, dtype=torch.float32)
                                       + step}, {"global_step": step})


def test_corrupt_checkpoint_flips_state_not_meta(tmp_path):
    path = _ckpt(tmp_path / "ck", 5)
    assert verify_checkpoint(path)[0]
    meta = open(os.path.join(path, "meta.json")).read()
    assert pfaults.corrupt_checkpoint(path)
    ok, reason = verify_checkpoint(path)
    assert not ok and "digest mismatch" in reason
    # meta.json survived: the checkpoint looks FINISHED but damaged
    assert open(os.path.join(path, "meta.json")).read() == meta
    assert not pfaults.corrupt_checkpoint(str(tmp_path / "empty"))


def test_latest_checkpoint_skips_torn_and_corrupt(tmp_path):
    root = tmp_path / "ckpts"
    for step in (1, 2, 3):
        _ckpt(root / f"step={step}", step, n=16)
    pfaults.corrupt_checkpoint(str(root / "step=3"))
    os.remove(root / "step=2" / "meta.json")  # torn
    assert latest_checkpoint(str(root)) == str(root / "step=1")
    pfaults.corrupt_checkpoint(str(root / "step=1"))
    assert latest_checkpoint(str(root)) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_corrupt_latest_targets_checkpoints_not_marker_dirs(tmp_path):
    """The injector corrupts the newest CHECKPOINT: the fault markers'
    own dir, written just before the fault fires, is newer and is no
    candidate."""
    root = tmp_path / "ck"
    _ckpt(root / "step=1", 1, n=16)
    _ckpt(root / "step=2", 2, n=16)
    fault = pfaults.Fault("corrupt_latest", None, 2, {"dir": str(root)})

    class _T:
        global_step = 2
        callbacks = []

    inj = pfaults.FaultInjector([fault], str(root / ".fault_state"))
    inj.on_train_batch_end(_T(), None, {}, 0)
    assert not verify_checkpoint(str(root / "step=2"))[0]
    assert latest_checkpoint(str(root)) == str(root / "step=1")


def test_poison_batch_matches_jax():
    """nan_loss puts a NaN in element 0 of each float leaf, grad_blowup
    scales them; integer leaves pass through, as in the JAX package."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 3)).astype(np.float32),
             "y": np.arange(4, dtype=np.int32)}
    for kind in ("nan_loss", "grad_blowup"):
        mine = pfaults._poison_batch(
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, kind,
            1e3)
        theirs = jfaults._poison_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, kind, 1e3)
        for k in batch:
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(theirs[k]))


@pytest.mark.parametrize("bit", [12, 31])
def test_bitflip_matches_jax(bit):
    """One bit of one f32 element flips: the JAX flip of the same leaf
    gives the same bytes."""
    import jax

    x = np.random.default_rng(1).standard_normal(10).astype(np.float32)
    tx = torch.from_numpy(x.copy())
    flipped = jfaults._bitflip_param_tree(
        {"w": jnp.asarray(x)}, 0, element=13, bit=bit,
        device=jax.devices()[0])["w"]
    assert pfaults._flip_bit(tx, element=13, bit=bit)
    np.testing.assert_array_equal(tx.numpy().view(np.uint32),
                                  np.asarray(flipped).view(np.uint32))


@pytest.mark.parametrize("dtype,view", [("bfloat16", np.uint16),
                                        ("float16", np.uint16),
                                        ("float64", np.uint64)])
def test_bitflip_at_each_width(dtype, view):
    """At 16 and 64 bits the flip is the XOR of one bit of the element's
    own word (the sign bit included)."""
    t = torch.linspace(-2, 2, 9).to(getattr(torch, dtype))
    width = t.element_size() * 8
    for bit in (3, width - 1):
        before = t.view({2: torch.int16, 8: torch.int64}[t.element_size()]
                        ).numpy().view(view).copy()
        assert pfaults._flip_bit(t, element=4, bit=bit)
        after = t.view({2: torch.int16, 8: torch.int64}[t.element_size()]
                       ).numpy().view(view)
        want = before.copy()
        want[4] ^= view(1 << bit)
        np.testing.assert_array_equal(after, want)


# -------------------------------------------------------------- preempt


def _mlp_loader():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = rng.integers(0, 4, 64).astype(np.int32)
    return DataLoader({"x": x, "y": y}, batch_size=8, shuffle=True, seed=3)


def _mlp():
    return MLPClassifier(features=(16,), num_classes=4, lr=1e-2,
                         in_features=8)


def test_preemption_flag_and_guard_drain(tmp_path):
    """SIGTERM sets only a flag; the guard drains at the next batch
    boundary: a valid emergency checkpoint, then PreemptedError, which
    classifies PREEMPTION in both packages."""
    old = _signal.getsignal(_signal.SIGTERM)
    try:
        install_preemption_handlers()
        assert preemption_requested() is None
        os.kill(os.getpid(), _signal.SIGTERM)
        assert preemption_requested() == "SIGTERM"
        ck = str(tmp_path / "ck")
        trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=1,
                          enable_checkpointing=False,
                          enable_progress_bar=False,
                          callbacks=[PreemptionGuard(ck, install=False)],
                          default_root_dir=str(tmp_path), seed=0)
        with pytest.raises(PreemptedError) as exc_info:
            trainer.fit(_mlp(), _mlp_loader())
        err = exc_info.value
        assert trainer.global_step == 1
        assert err.checkpoint_path.endswith("preempt-step=1")
        ok, reason = verify_checkpoint(err.checkpoint_path)
        assert ok, reason
        assert latest_checkpoint(ck) == err.checkpoint_path
        fc = classify_failure(err)
        assert fc.kind == FailureKind.PREEMPTION
        assert fc.to_dict() == jax_classify(err).to_dict()
        tb = WorkerError(1, "Traceback ...\nray_lightning_tpu_torch."
                            f"resilience.preempt.PreemptedError: {err}")
        assert classify_failure(tb).kind == FailureKind.PREEMPTION
    finally:
        reset_preemption()
        _signal.signal(_signal.SIGTERM, old)


# --------------------------------------------------------------- health


@pytest.mark.parametrize("mod", [phealth, jhealth], ids=["port", "jax"])
def test_health_monitor_distinguishes_slow_from_hung(mod):
    """The same heartbeat sequence gives the same verdicts in both
    packages: a live channel with a frozen step is not a stall, a
    silent one past the budget is."""
    mon = mod.HealthMonitor(num_workers=2, stall_timeout_s=10.0,
                            startup_grace_s=30.0, step_stall_note_s=5.0)
    now = time.monotonic()
    assert mon.consume(0, mod.make_heartbeat(0, step=1))
    assert mon.consume(1, mod.make_heartbeat(1, step=1))
    assert not mon.consume(0, {"some": "other item"})
    mon.check(now)
    mon.consume(0, mod.make_heartbeat(0, step=1))
    mon.check(now + 8.0)  # live channel, frozen step: slow, not hung
    with pytest.raises(mod.StallError, match="rank 0"):
        mon.check(now + 11.0)
    assert set(mon.snapshot()) == {0, 1}


@pytest.mark.parametrize("mod", [phealth, jhealth], ids=["port", "jax"])
def test_health_monitor_startup_grace(mod):
    mon = mod.HealthMonitor(num_workers=2, stall_timeout_s=30.0,
                            startup_grace_s=20.0)
    now = time.monotonic()
    mon.consume(0, mod.make_heartbeat(0, step=0))
    mon.check(now + 19.0)  # rank 1 silent but inside the startup grace
    with pytest.raises(mod.StallError, match="never reached"):
        mon.check(now + 21.0)


def test_heartbeat_payload_matches_jax():
    mine = phealth.make_heartbeat(2, 7, "step", span={"phase": "x",
                                                      "dur": 1.0, "step": 7})
    theirs = jhealth.make_heartbeat(2, 7, "step", span={"phase": "x",
                                                        "dur": 1.0,
                                                        "step": 7})
    mine.pop("sent_at"), theirs.pop("sent_at")
    assert mine == theirs and phealth.HEARTBEAT_KIND == jhealth.HEARTBEAT_KIND


def test_heartbeat_first_beat_is_sent_before_fit_start_returns():
    """The beat that ends the monitor's startup grace leaves on the
    caller's thread, before the first step can run: a rank that hangs in
    its first steps is then judged by the stall budget, never by the
    startup grace."""
    from ray_lightning_tpu_torch.runtime import session

    senders = []

    class _Q:
        def put_queue(self, item):
            senders.append((threading.current_thread(), item))

    session.init_session(rank=0, world_size=1, queue=_Q())
    try:
        class _T:
            global_step = 4

        cb = phealth.HeartbeatCallback(interval_s=60.0)
        cb.on_fit_start(_T(), None)
        assert len(senders) == 1
        thread, item = senders[0]
        assert thread is threading.current_thread()
        assert phealth.is_heartbeat(item) and item["step"] == 4
        cb.on_fit_end(_T(), None)
    finally:
        session.reset_session()


def test_heartbeat_callback_beats_at_once_and_mutes(monkeypatch):
    """In a worker session the sender beats at fit start (ending the
    monitor's startup grace) and then every interval; `mute` (the hang
    fault) silences it while the thread lives; fit end stops it."""
    from ray_lightning_tpu_torch.runtime import session

    items = []

    class _Q:
        def put_queue(self, item):
            items.append(item)

    session.init_session(rank=0, world_size=1, queue=_Q())
    try:
        class _T:
            global_step = 0

        cb = phealth.HeartbeatCallback(interval_s=0.05)
        cb.on_fit_start(_T(), None)
        time.sleep(0.3)
        assert len(items) >= 3 and all(map(phealth.is_heartbeat, items))
        assert items[0]["phase"] == "setup"
        cb.mute()
        time.sleep(0.1)
        n = len(items)
        time.sleep(0.3)
        assert len(items) == n
        cb.on_fit_end(_T(), None)
    finally:
        session.reset_session()


def test_stall_error_classifies_retryable_in_both():
    from ray_lightning_tpu.resilience.policy import StallError as JaxStall

    err = StallError(1, 200.0, phase="step", step=12)
    assert str(err) == str(JaxStall(1, 200.0, phase="step", step=12))
    assert classify_failure(err).to_dict() == \
        jax_classify(JaxStall(1, 200.0, phase="step", step=12)).to_dict()
    assert classify_failure(err).kind == FailureKind.RETRYABLE


# --------------------------------------- deterministic resume (in-process)


class _Rows(Callback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((trainer.global_step, float(metrics["loss"])))


def test_kill_at_step_j_resume_is_deterministic(tmp_path):
    """16 steps straight, against a raise at step 3 (the injector) and a
    resume from latest_checkpoint: the same per-step losses, every batch
    once, and BITWISE equal final params (fused Adam's state included)."""

    def trainer(root, extra):
        return Trainer(strategy=SingleDevice(device="cpu"), max_epochs=2,
                       enable_checkpointing=False, enable_progress_bar=False,
                       seed=7, log_every_n_steps=1,
                       default_root_dir=str(root), callbacks=extra)

    rec_a, mod_a = _Rows(), _mlp()
    trainer(tmp_path / "a", [rec_a]).fit(mod_a, _mlp_loader())
    assert len(rec_a.rows) == 16

    ck, state = str(tmp_path / "ck"), str(tmp_path / "fault_state")
    fault = pfaults.Fault("raise", None, 3, {}, index=0)
    rec_b = _Rows()
    mc = ModelCheckpoint(dirpath=ck, every_n_train_steps=1, save_top_k=-1)
    with pytest.raises(RuntimeError, match="injected fatal failure"):
        trainer(tmp_path / "b1", [mc, rec_b, pfaults.FaultInjector(
            [fault], state)]).fit(_mlp(), _mlp_loader())
    resume_from = latest_checkpoint(ck)
    assert resume_from.endswith("step=3")
    mod_b = _mlp()
    t_b = trainer(tmp_path / "b2",
                  [rec_b, pfaults.FaultInjector([fault], state)])
    t_b.fit(mod_b, _mlp_loader(), ckpt_path=resume_from)
    assert rec_b.rows == rec_a.rows and t_b.global_step == 16
    for k, v in mod_a.params.items():
        assert torch.equal(v, mod_b.params[k]), k


# ------------------------------------------------- the supervisor's seams


def test_resilience_exports_match_jax():
    import ray_lightning_tpu as jtop
    import ray_lightning_tpu_torch as ptop

    assert sorted(pres.__all__) == sorted(jres.__all__)
    for name in pres.__all__:
        assert getattr(pres, name) is not None
    for name in ("GuardCallback", "GuardConfig", "ResilienceConfig",
                 "RetryPolicy", "SupervisedResult", "fit_supervised",
                 "supervise"):
        assert hasattr(jtop, name)
        assert getattr(ptop, name) is getattr(pres, name)


@pytest.mark.parametrize("knob,item", [
    ("elastic", "Queue 1 item 12"), ("compile_cache_dir", "Queue 1 item 7"),
])
def test_unported_resilience_knobs_raise(tmp_path, monkeypatch, knob, item):
    """Both knobs are ported now, each with its item. ``elastic`` (item
    12) takes an `ElasticBudget`: the driver keeps the ladder, and the
    config the workers' trainer factory gets carries none.
    ``compile_cache_dir`` (the hot loop's item 7): a directory becomes
    the workers' kernel cache, one plan a subdirectory, and None or
    "off" keep the package's own build directory."""
    if knob == "elastic":
        import functools

        from ray_lightning_tpu_torch.elastic import ElasticBudget

        assert item == "Queue 1 item 12"
        budget = ElasticBudget(min_world=1, max_reshards=2)
        cfg = pres.ResilienceConfig(str(tmp_path), **{knob: budget})
        assert cfg.elastic is budget
        shipped = []

        def fake_run(kind, mf, tf, df, n, **kw):
            shipped.append((n, tf))
            return "done"

        # supervise() imports run_distributed per call, from runtime.fit
        import ray_lightning_tpu_torch.runtime.fit as fit_mod

        monkeypatch.setattr(fit_mod, "run_distributed", fake_run)
        out = pres.fit_supervised(
            torch_jobs.sup_module, torch_jobs.sup_trainer,
            torch_jobs.sup_data, 2, resilience=cfg)
        assert out.result == "done" and out.reshards == []
        assert out.final_world is None
        (n, tf), = shipped
        assert n == 2 and isinstance(tf, functools.partial)
        assert tf.args[1].elastic is None
    else:
        from ray_lightning_tpu_torch.pipeline.compile_cache import (
            plan_cache_dir,
        )
        from ray_lightning_tpu_torch.resilience.supervisor import (
            _wrapped_trainer_factory,
        )

        cache = str(tmp_path / "cache")
        cfg = pres.ResilienceConfig(str(tmp_path), **{knob: cache})
        assert cfg.resolved_compile_cache_dir() == cache
        trainer = _wrapped_trainer_factory(torch_jobs.sup_trainer, cfg)
        assert trainer.compile_cache_dir == plan_cache_dir(
            cache, "DataParallel", 1)
        for off in (None, "off"):
            assert pres.ResilienceConfig(
                str(tmp_path), **{knob: off}).resolved_compile_cache_dir() \
                is None
    cfg = pres.ResilienceConfig(str(tmp_path))
    assert cfg.telemetry is True and cfg.elastic is None


def test_wrapped_trainer_factory_attaches_supervision(tmp_path, monkeypatch):
    """What each worker's trainer gets: the step-cadence checkpoint into
    the supervisor's dir (async in a one-process job), the heartbeat,
    the SIGTERM drain, the trainguard with the rollback marker as its
    data-order skip, and the fault plan with its markers beside the
    checkpoints."""
    import functools

    from ray_lightning_tpu_torch.resilience.guard import (
        GuardCallback,
        GuardConfig,
        write_rollback_marker,
    )
    from ray_lightning_tpu_torch.resilience.supervisor import (
        _wrapped_trainer_factory,
    )

    d = str(tmp_path / "sup")
    write_rollback_marker(d, {"detected_step": 6, "epoch": 0,
                              "epoch_batch": 6})
    cfg = pres.ResilienceConfig(d, save_every_n_steps=3, guard=GuardConfig(),
                                faults="kill:rank=1,step=2")
    monkeypatch.delenv(pfaults.FAULT_STATE_ENV, raising=False)
    factory = functools.partial(
        Trainer, strategy=SingleDevice(device="cpu"),
        enable_checkpointing=False, enable_progress_bar=False)
    t = _wrapped_trainer_factory(factory, cfg)
    kinds = {type(c).__name__: c for c in t.callbacks}
    mc = kinds["ModelCheckpoint"]
    assert (mc.dirpath, mc.every_n_train_steps, mc.save_top_k,
            mc.async_save) == (d, 3, 2, True)
    assert "HeartbeatCallback" in kinds and "PreemptionGuard" in kinds
    assert isinstance(kinds["GuardCallback"], GuardCallback)
    assert t.resume_skip_past["epoch_batch"] == 6
    inj = kinds["FaultInjector"]
    assert inj.state_dir == os.path.join(d, ".fault_state")
    assert [f.kind for f in inj.faults] == ["kill"]
    # telemetry on by default, into the run's shared dir
    assert t.telemetry.dir == os.path.join(d, "telemetry")


def test_telemetry_and_watch_knobs(tmp_path):
    """``telemetry`` defaults to True as in the JAX package and resolves
    to the same dir; False turns it off; a trainer's own telemetry
    wins; ``watch`` takes what the JAX knob takes."""
    import functools

    from ray_lightning_tpu.resilience.supervisor import (
        ResilienceConfig as JaxConfig,
    )
    from ray_lightning_tpu_torch.resilience.supervisor import (
        _wrapped_trainer_factory,
    )
    from ray_lightning_tpu_torch.telemetry import TelemetryConfig
    from ray_lightning_tpu_torch.telemetry.watch import (
        BUILTIN_RULES,
        WatchConfig,
    )

    d = str(tmp_path)
    for value in (True, False, str(tmp_path / "elsewhere")):
        assert pres.ResilienceConfig(d, telemetry=value).\
            resolved_telemetry_dir() == JaxConfig(
                d, telemetry=value).resolved_telemetry_dir()
    assert JaxConfig(d).telemetry is pres.ResilienceConfig(d).telemetry
    factory = functools.partial(
        Trainer, strategy=SingleDevice(device="cpu"),
        enable_checkpointing=False, enable_progress_bar=False)
    off = _wrapped_trainer_factory(
        factory, pres.ResilienceConfig(d, telemetry=False))
    assert off.telemetry is None
    own = _wrapped_trainer_factory(functools.partial(factory, telemetry="mine"),
                                   pres.ResilienceConfig(d))
    assert own.telemetry == "mine"
    # a config's flush cadence reaches the workers (the JAX wrapper
    # keeps only its dir)
    cadenced = _wrapped_trainer_factory(factory, pres.ResilienceConfig(
        d, telemetry=TelemetryConfig(flush_every_n_steps=1)))
    assert (cadenced.telemetry.dir, cadenced.telemetry.flush_every_n_steps) \
        == (os.path.join(d, "telemetry"), 1)
    cfg = pres.ResilienceConfig(d, watch=True)
    assert WatchConfig.coerce(cfg.watch).rules == BUILTIN_RULES
    assert pres.SupervisedResult(None, 0, 0, []).incidents == []


def test_maybe_install_faults_reads_the_environment(monkeypatch, tmp_path):
    t = Trainer(strategy=SingleDevice(device="cpu"),
                enable_checkpointing=False, enable_progress_bar=False)
    monkeypatch.delenv(pfaults.FAULTS_ENV, raising=False)
    assert pfaults.maybe_install_faults(t) is None
    monkeypatch.setenv(pfaults.FAULTS_ENV, "preempt:rank=0,step=2")
    monkeypatch.setenv(pfaults.FAULT_STATE_ENV, str(tmp_path))
    inj = pfaults.maybe_install_faults(t)
    assert inj in t.callbacks and inj.state_dir == str(tmp_path)
    assert [f.kind for f in pfaults.faults_from_env()] == ["preempt"]
