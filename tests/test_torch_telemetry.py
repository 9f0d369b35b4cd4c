"""The port's telemetry (`ray_lightning_tpu_torch/telemetry/`) against
the JAX package's (`tests/test_telemetry.py`), on the CPU.

The file formats are the JAX package's own, so the parity harness is
cross-reading: spans and goodput ledgers the port writes read equal
through the JAX readers and the port's, and the reverse. Also held
against the JAX package on the same inputs: the recorder's totals, ring
and exclusive nesting, `TelemetryConfig.coerce`, `assemble_goodput`,
`build_drift`, the profiler's trigger state machine (fake backends on
both sides), heartbeats and stall errors. The tiny-Llama fit with
telemetry on is bitwise the fit with it off, reads nothing more on the
host, and agrees with the JAX fit to 2e-5.
"""
from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu.resilience import health as jhealth
from ray_lightning_tpu.telemetry import goodput as jgoodput
from ray_lightning_tpu.telemetry import profiler as jprofiler
from ray_lightning_tpu.telemetry import report as jreport
from ray_lightning_tpu.telemetry import spans as jspans
from ray_lightning_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    params_from_jax,
)
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience import health as phealth
from ray_lightning_tpu_torch.resilience.policy import StallError
from ray_lightning_tpu_torch.runtime import session
from ray_lightning_tpu_torch.telemetry import (
    ProfileConfig,
    TelemetryConfig,
    TelemetryRecorder,
)
from ray_lightning_tpu_torch.telemetry import goodput as pgoodput
from ray_lightning_tpu_torch.telemetry import profiler as pprofiler
from ray_lightning_tpu_torch.telemetry import report as preport
from ray_lightning_tpu_torch.telemetry import spans as pspans

#: the two packages' span modules, for tests that run both
SPANS = {"jax": jspans, "torch": pspans}


@contextlib.contextmanager
def _capture_logs(name):
    records = []

    class _H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _H()
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def _script(rec, mod):
    """One fixed sequence of spans into ``rec``, with start times set
    from its own clock origin, so both packages' files match."""
    t0 = rec.t0_perf
    rec.record(mod.PH_DISPATCH, t0 + 0.5, 0.25, step=1)
    rec.record(mod.PH_STEP, t0 + 0.25, 0.75, step=1)
    rec.record("h2d", t0 + 0.125, 0.5, step=1, thread=mod.THREAD_PRODUCER)
    rec.record(mod.PH_METRICS, t0 + 1.0, 0.0625, step=1,
               meta={"why": "cadence"})
    for i in range(12):
        rec.record("x", t0 + 2.0 + i, 0.001, step=i)


def _only(pattern):
    [path] = glob.glob(pattern)
    return path


# ---- recorder ----------------------------------------------------------------


def test_span_totals_ring_and_files_match_jax(tmp_path):
    """The same spans into a size-8 ring in both packages: equal totals,
    counts and drops; each file reads equal through both readers."""
    recs = {}
    for name, mod in SPANS.items():
        rec = mod.TelemetryRecorder(directory=str(tmp_path / name), rank=3,
                                    ring_size=8)
        _script(rec, mod)
        rec.close()
        recs[name] = rec
    assert recs["torch"].phase_totals() == recs["jax"].phase_totals()
    assert recs["torch"].phase_counts() == recs["jax"].phase_counts()
    assert recs["torch"].dropped == recs["jax"].dropped == 16 - 8
    assert "h2d" not in recs["torch"].phase_totals()
    parsed = {}
    for writer in SPANS:
        path = _only(str(tmp_path / writer / "rank3.*.spans.jsonl"))
        both = [mod.read_spans(path) for mod in SPANS.values()]
        assert both[0] == both[1]
        parsed[writer] = both[0]
    assert parsed["torch"]["spans"] == parsed["jax"]["spans"]
    assert len(parsed["torch"]["spans"]) == 8
    assert parsed["torch"]["dropped"] == 8
    header = parsed["torch"]["header"]
    assert header["version"] == jspans.SPANS_VERSION == pspans.SPANS_VERSION
    assert set(header) == set(parsed["jax"]["header"])


@pytest.mark.parametrize("tail", [None, 64, 400])
def test_ledger_tail_lines_match_jax(tmp_path, tail):
    rec = TelemetryRecorder(directory=str(tmp_path), rank=0)
    _script(rec, pspans)
    rec.close()
    path = _only(str(tmp_path / "rank0.*.spans.jsonl"))
    assert pspans.ledger_tail_lines(path, tail) == \
        jspans.ledger_tail_lines(path, tail)
    assert pspans.read_spans(path, tail) == jspans.read_spans(path, tail)


@pytest.mark.parametrize("name", list(SPANS))
def test_current_phase_and_exclusive_nesting(name):
    """Main-thread spans nest exclusively (a child's time is taken off
    its parent's total); producer spans never move the phase."""
    mod = SPANS[name]
    rec = mod.TelemetryRecorder()
    assert rec.current_phase() == "setup"
    with rec.span(mod.PH_EVAL):
        with rec.span(mod.PH_CKPT):
            assert rec.current_phase() == mod.PH_CKPT
            with rec.span("h2d", thread=mod.THREAD_PRODUCER):
                assert rec.current_phase() == mod.PH_CKPT
            time.sleep(0.05)
        assert rec.current_phase() == mod.PH_EVAL
    assert rec.current_phase() == mod.PH_STEP
    assert rec.last_span()["phase"] == mod.PH_EVAL
    totals = rec.phase_totals()
    assert totals[mod.PH_CKPT] >= 0.05
    assert totals[mod.PH_EVAL] < totals[mod.PH_CKPT]
    evals = [s for s in rec._ring if s["phase"] == mod.PH_EVAL]
    assert evals[0]["dur"] >= 0.05 and "excl" in evals[0]


def test_null_recorder_is_inert():
    null = pspans.NULL_RECORDER
    with null.span("anything"):
        pass
    null.record("x", 0.0, 1.0)
    assert null.phase_totals() == {} and null.flush() == 0
    assert not null.enabled and null.last_span() is None
    assert null.current_phase() == jspans.NULL_RECORDER.current_phase()


def test_vocabulary_matches_jax():
    assert pspans.PHASES == jspans.PHASES
    assert pspans.SERVE_PHASES == jspans.SERVE_PHASES
    assert pgoodput.GOODPUT_BUCKETS == jgoodput.GOODPUT_BUCKETS
    assert pgoodput.GOODPUT_SCHEMA == jgoodput.GOODPUT_SCHEMA


@pytest.mark.parametrize("value", [None, False, True, "some/dir", 3])
def test_config_coerce_matches_jax(value):
    def coerce(cls):
        try:
            cfg = cls.coerce(value)
        except TypeError:
            return "TypeError"
        return None if cfg is None else (cfg.dir, cfg.ring_size,
                                          cfg.flush_every_n_steps,
                                          cfg.resolved_dir("/r"))

    assert coerce(TelemetryConfig) == coerce(JaxTelemetryConfig)


# ---- goodput ------------------------------------------------------------------


class _Totals:
    def __init__(self, totals):
        self.totals = totals

    def phase_totals(self):
        return dict(self.totals)


def test_ledger_books_close_exactly_as_jax():
    rec = _Totals({"data_wait": 0.5, "ckpt_stall": 1.25, "eval": 0.75,
                   "metrics_fetch": 0.125, "dispatch": 9.0, "step": 9.0})
    args = dict(rank=0, start_step=3, end_step=9, launch_s=2.0,
                completed=False)
    got = pgoodput.worker_ledger(rec, 10.0, **args)
    want = jgoodput.worker_ledger(rec, 10.0, **args)
    got.pop("t0_wall"), want.pop("t0_wall")
    assert got == want
    assert sum(got["buckets"].values()) == 10.0
    assert got["buckets"]["productive_s"] == 10.0 - 2.625


def _write_attempts(directory, mod):
    """Three attempts of one rank: 0-8, a resume at 6 reaching 12, a
    rollback resume at 10 reaching 16 (replays 2 steps each)."""
    for i, (start, end, wall) in enumerate(((0, 8, 4.0), (6, 12, 3.0),
                                            (10, 16, 3.5))):
        rec = _Totals({"data_wait": 0.25 * (i + 1), "ckpt_stall": 0.5})
        led = mod.worker_ledger(rec, wall, rank=0, start_step=start,
                                end_step=end, launch_s=1.0 + i,
                                completed=i == 2)
        led["t0_wall"] = 1000.0 + 10 * i
        mod.write_ledger(directory, led, uid=f"{i}")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_assemble_goodput_equal_in_both_packages(tmp_path, writer):
    mod = jgoodput if writer == "jax" else pgoodput
    _write_attempts(str(tmp_path), mod)
    kw = dict(backoff_s=1.5, restarts=1, rollbacks=1, preemptions=0)
    got = pgoodput.assemble_goodput(str(tmp_path), 20.0, **kw)
    want = jgoodput.assemble_goodput(str(tmp_path), 20.0, **kw)
    assert got == want
    assert got["buckets"]["rollback_replay_s"] > 0
    assert [a["replay_steps"] for a in got["attempts"]] == [0, 2, 2]
    assert pgoodput.buckets_consistent(got) and \
        jgoodput.buckets_consistent(got)
    assert pgoodput.read_ledgers(str(tmp_path)) == \
        jgoodput.read_ledgers(str(tmp_path))
    pgoodput.write_goodput(str(tmp_path), got)
    assert jgoodput.read_goodput(str(tmp_path)) == got


@pytest.mark.parametrize("report", [
    {"wall_s": 10.0, "buckets": {"a": 9.0}},
    {"wall_s": 10.0, "buckets": {"a": 9.6}},
    {"wall_s": 0.0, "buckets": {}},
    {"wall_s": 10.0, "buckets": {"a": 10.4, "b": 0.2}},
])
def test_buckets_consistent_matches_jax(report):
    assert pgoodput.buckets_consistent(report) == \
        jgoodput.buckets_consistent(report)


def test_assemble_with_no_ledgers_still_structured(tmp_path):
    got = pgoodput.assemble_goodput(str(tmp_path), 5.0, backoff_s=1.0)
    assert got == jgoodput.assemble_goodput(str(tmp_path), 5.0,
                                            backoff_s=1.0)
    assert got["buckets"]["other_s"] == 4.0 and got["ledgers"] == 0


# ---- profiler -------------------------------------------------------------------


class _FakeSession:
    """Stands in for a `torch.profiler.profile` session."""

    def __init__(self, log, events=(), fail=False):
        self.log, self.events, self.fail = log, events, fail

    def start(self):
        if self.fail:
            raise RuntimeError("another profiler is running")
        self.log.append("start")

    def step(self):
        self.log.append("step")

    def stop(self):
        self.log.append("stop")

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)

    def key_averages(self):
        return self.events


class _Evt:
    def __init__(self, key, count, device_type):
        self.key, self.count, self.device_type = key, count, device_type


class _FakeJaxProfiler:
    def __init__(self, log):
        self.log = log

    def start_trace(self, d):
        self.log.append("start")

    def stop_trace(self):
        self.log.append("stop")


def _patch_backends(monkeypatch, events=(), fail=False):
    import jax.profiler

    jlog, plog = [], []
    fake = _FakeJaxProfiler(jlog)
    monkeypatch.setattr(jax.profiler, "start_trace", fake.start_trace)
    monkeypatch.setattr(jax.profiler, "stop_trace", fake.stop_trace)
    monkeypatch.setattr(pprofiler, "_session", lambda on_card: _FakeSession(
        plog, events, fail))
    monkeypatch.setattr(pprofiler, "_prime", lambda: plog.append("prime"))
    return jlog, plog


def _drive(ctl, steps, marker=None, at=None):
    starts = []
    for step in steps:
        if marker is not None and step == at:
            open(marker, "w").close()
        was = ctl.capturing
        ctl.on_step(step)
        if ctl.capturing and not was:
            starts.append(step)
    return starts


@pytest.mark.parametrize("case", ["window", "marker", "other_rank"])
def test_profiler_state_machine_matches_jax(tmp_path, monkeypatch, case):
    """Step window, marker file (consumed: one touch, one capture) and
    rank scope: the port's controller starts and stops where the JAX
    one does, on the same step sequence."""
    jlog, plog = _patch_backends(monkeypatch)
    out = {}
    for name, mod in (("jax", jprofiler), ("torch", pprofiler)):
        d = tmp_path / name
        d.mkdir()
        if case == "window":
            cfg = mod.ProfileConfig(dir=str(d), start_step=3, num_steps=2)
        else:
            cfg = mod.ProfileConfig(dir=str(d), num_steps=2,
                                    poll_every_n_steps=2)
        ctl = mod.ProfilerController(cfg, rank=1 if case == "other_rank"
                                     else 0)
        starts = _drive(ctl, range(1, 12), marker=str(d / "CAPTURE"),
                        at=None if case == "window" else 5)
        ctl.close()
        out[name] = (starts, ctl.captures, ctl.capturing,
                     os.path.exists(d / "CAPTURE"))
    assert out["torch"] == out["jax"]
    # the port's session records from its step() on, after a warm-up
    assert [e for e in plog if e != "step"] == jlog
    if case == "other_rank":
        assert plog == [] and out["torch"][0] == []
    else:
        assert out["torch"][0] == ([3] if case == "window" else [6])
        assert plog == ["start", "step", "stop"]


def test_profiler_failure_disables_loudly(tmp_path, monkeypatch):
    _, plog = _patch_backends(monkeypatch, fail=True)
    ctl = pprofiler.ProfilerController(pprofiler.ProfileConfig(
        dir=str(tmp_path), start_step=1, num_steps=1))
    with _capture_logs("ray_lightning_tpu_torch.telemetry.profiler") as logs:
        ctl.on_step(1)
    assert ctl.disabled_reason and any("DISABLED" in m for m in logs)
    ctl.on_step(1)
    assert plog == [] and ctl.captures == 0


def test_empty_capture_on_card_is_a_failure(tmp_path, monkeypatch):
    """A capture on a card whose session holds no device event is
    counted in empty_captures and logged as failed; one whose every
    kernel launch has its kernel event is a capture; one that lost some
    is incomplete."""
    from torch.autograd import DeviceType

    _, plog = _patch_backends(monkeypatch, events=[
        _Evt("aten::mm", 4, DeviceType.CPU)])
    cfg = pprofiler.ProfileConfig(dir=str(tmp_path), start_step=1,
                                  num_steps=1)
    ctl = pprofiler.ProfilerController(cfg, on_card=True)
    with _capture_logs("ray_lightning_tpu_torch.telemetry.profiler") as logs:
        _drive(ctl, range(1, 4))
    # on a card the warm-up runs the primer kernels before recording
    assert plog[:3] == ["start", "prime", "step"]
    assert (ctl.captures, ctl.empty_captures) == (0, 1)
    assert ctl.records[0]["empty"] and any("FAILED" in m for m in logs)
    assert os.path.exists(ctl.records[0]["trace"])

    # every launch seen on the host has its kernel: a capture
    _patch_backends(monkeypatch, events=[
        _Evt("aten::mm", 4, DeviceType.CPU),
        _Evt("cudaLaunchKernel", 6, DeviceType.CPU),
        _Evt("cuLaunchKernelEx", 2, DeviceType.CPU),
        _Evt("flash_fwd_kernel", 8, DeviceType.CUDA),
        _Evt("Memcpy HtoD (Pageable -> Device)", 1, DeviceType.CUDA)])
    ctl = pprofiler.ProfilerController(cfg, on_card=True)
    _drive(ctl, range(1, 4))
    assert (ctl.captures, ctl.empty_captures,
            ctl.incomplete_captures) == (1, 0, 0)
    assert ctl.records[0]["device_events"]["flash_fwd_kernel"] == 8
    assert ctl.records[0]["kernel_launches"] == 8

    # one launch without its kernel: an incomplete capture
    _patch_backends(monkeypatch, events=[
        _Evt("cudaLaunchKernel", 9, DeviceType.CPU),
        _Evt("flash_fwd_kernel", 8, DeviceType.CUDA)])
    ctl = pprofiler.ProfilerController(cfg, on_card=True)
    with _capture_logs("ray_lightning_tpu_torch.telemetry.profiler") as logs:
        _drive(ctl, range(1, 4))
    assert (ctl.captures, ctl.incomplete_captures) == (0, 1)
    assert ctl.records[0]["lost_kernel_events"] == 1
    assert any("INCOMPLETE" in m for m in logs)


def test_profile_config_coerce_matches_jax():
    for value in (None, False, True, "d"):
        got, want = (pprofiler.ProfileConfig.coerce(value),
                     jprofiler.ProfileConfig.coerce(value))
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.dir, got.start_step, got.num_steps, got.ranks) == \
                (want.dir, want.start_step, want.num_steps, want.ranks)
    with pytest.raises(TypeError):
        pprofiler.ProfileConfig.coerce(3)


# ---- heartbeat phase and stall naming -----------------------------------------


def test_heartbeat_carries_phase_and_span_as_jax():
    span = {"phase": "ckpt_stall", "dur": 1.5, "step": 12, "t": 9.0}
    got = phealth.make_heartbeat(1, step=12, phase="ckpt_stall", span=span)
    want = jhealth.make_heartbeat(1, step=12, phase="ckpt_stall", span=span)
    got.pop("sent_at"), want.pop("sent_at")
    assert got["span"] == {"phase": "ckpt_stall", "dur": 1.5, "step": 12}
    assert {k: v for k, v in got.items() if k != "kind"} == \
        {k: v for k, v in want.items() if k != "kind"}


def test_stall_error_names_phase_and_step():
    mon = phealth.HealthMonitor(num_workers=1, stall_timeout_s=5.0,
                                startup_grace_s=1.0)
    mon.consume(0, phealth.make_heartbeat(0, step=42, phase="ckpt_stall"))
    with pytest.raises(StallError) as err:
        mon.check(now=time.monotonic() + 60.0)
    assert "ckpt_stall" in str(err.value) and "42" in str(err.value)
    assert err.value.phase == "ckpt_stall" and err.value.step == 42
    assert mon.snapshot()[0]["phase"] == "ckpt_stall"


class _Queue:
    def __init__(self):
        self.items = []
        self.got = threading.Event()

    def put_queue(self, item):
        self.items.append(item)
        self.got.set()


@pytest.mark.parametrize("telemetry", [True, False])
def test_heartbeat_sender_reports_the_recorder_phase(telemetry):
    """Inside a worker the heartbeat's phase is the recorder's open span
    (here a checkpoint stall at step 5) and carries the last span; with
    telemetry off it falls back to the step counter."""

    class _Trainer:
        global_step = 5
        telemetry_recorder = (TelemetryRecorder() if telemetry
                              else pspans.NULL_RECORDER)

    trainer = _Trainer()
    rec = trainer.telemetry_recorder
    rec.record(pspans.PH_DISPATCH, time.perf_counter(), 0.01, step=4)
    queue = _Queue()
    session.init_session(0, 1, queue)
    cb = phealth.HeartbeatCallback(interval_s=60.0)
    try:
        with rec.span(pspans.PH_CKPT):
            cb.on_fit_start(trainer, None)
            assert queue.got.wait(10)
    finally:
        cb.on_fit_end(trainer, None)
        session.reset_session()
    [hb] = queue.items
    if telemetry:
        assert hb["phase"] == pspans.PH_CKPT
        assert hb["span"]["phase"] == pspans.PH_DISPATCH
    else:
        assert hb["phase"] == "step" and "span" not in hb


# ---- the trainer ------------------------------------------------------------------

#: the tiny Llama both packages fit (head_dim 16, GQA 2:1)
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=64)
STEPS = 6


def _tokens():
    return np.random.default_rng(4).integers(0, 256, (16, 13)).astype(
        np.int32)


def _jax_params():
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False)
    params = JaxLlama(jcfg).init(jax.random.key(2),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
    return jcfg, jax.tree.map(np.asarray, params)


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


COMMON = dict(max_steps=STEPS, log_every_n_steps=2, enable_checkpointing=False,
              enable_progress_bar=False, seed=0)


def _port_fit(root, telemetry, profile=None, profiler_dir=None, params=None,
              val=False):
    _, jparams = _jax_params() if params is None else (None, params)
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    module = LlamaModule(cfg, lr=1e-2, warmup_steps=1, total_steps=STEPS)
    module.params = params_from_jax(jparams, cfg, dtype=torch.float32)
    rows = _Rows()
    trainer = Trainer(strategy=SingleDevice(device="cpu"), callbacks=[rows],
                      default_root_dir=str(root), telemetry=telemetry,
                      profile=profile, profiler_dir=profiler_dir,
                      val_check_interval=3 if val else None, **COMMON)
    toks = _tokens()
    trainer.fit(module, DataLoader({"tokens": toks}, batch_size=2,
                                   shuffle=True, seed=0),
                DataLoader({"tokens": toks[:4]}, batch_size=2)
                if val else None)
    return trainer, module, rows.rows


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fits")
    on = _port_fit(root / "on", True, val=True)
    off = _port_fit(root / "off", False, val=True)
    return root, on, off


def test_fit_with_telemetry_is_bitwise_the_fit_without(fits):
    _, (t_on, m_on, rows_on), (t_off, m_off, rows_off) = fits
    assert rows_on == rows_off and len(rows_on) == STEPS
    assert set(m_on.params) == set(m_off.params)
    for k, p in m_on.params.items():
        assert torch.equal(p, m_off.params[k]), k
    assert t_off.telemetry is None and not t_off.telemetry_recorder.enabled
    assert "goodput_fraction" not in t_off.callback_metrics


def test_fit_writes_spans_and_a_closed_ledger(fits):
    """On the main thread: the warm start's compile span before the
    first step, one dispatch and one step span a step, a metrics fetch
    on the logging cadence, the validations' eval spans (and data_wait
    spans where the step found no batch ready, as many as the
    prefetcher's misses); on the producer thread an h2d span for each
    batch placed. The ledger's buckets sum to its wall, with the warm
    start in compile_s; the port's files read equal through both
    packages' readers and the report."""
    root, (trainer, _, _), _ = fits
    tdir = str(root / "on" / "telemetry")
    path = _only(os.path.join(tdir, "rank0.*.spans.jsonl"))
    parsed = pspans.read_spans(path)
    assert parsed == jspans.read_spans(path)
    count, producer = {}, 0
    for s in parsed["spans"]:
        if s.get("thread", "main") != "main":
            assert (s["thread"], s["phase"]) == ("producer", "h2d")
            producer += 1
        elif s["phase"] != "data_wait":
            count[s["phase"]] = count.get(s["phase"], 0) + 1
    assert count == {"compile": 1, "dispatch": STEPS, "step": STEPS,
                     "metrics_fetch": STEPS // 2, "eval": 2}
    first = min(s["t"] for s in parsed["spans"]
                if s["phase"] == "dispatch")
    [warm] = [s for s in parsed["spans"] if s["phase"] == "compile"]
    assert warm["t"] + warm["dur"] <= first
    # every step's batch and the validations' (2 batches each, twice)
    assert producer >= STEPS + 4
    assert [s["step"] for s in parsed["spans"]
            if s["phase"] == "dispatch"] == list(range(STEPS))
    [led] = pgoodput.read_ledgers(tdir)
    assert led == jgoodput.read_ledgers(tdir)[0]
    assert led["completed"] and (led["start_step"], led["end_step"]) == \
        (0, STEPS)
    assert sum(led["buckets"].values()) == pytest.approx(led["wall_s"],
                                                         rel=1e-12)
    assert led["buckets"]["eval_s"] > 0 and led["buckets"]["compile_s"] > 0
    m = trainer.callback_metrics
    assert m["telemetry_compile_s"] == pytest.approx(
        led["buckets"]["compile_s"], rel=1e-6)
    assert m["compile_time_s"] >= m["compile_warm_s"] >= 0
    assert 0 < m["goodput_fraction"] <= 1 and m["telemetry_eval_s"] > 0
    assert m["telemetry_spans_dropped"] == 0
    got = preport.build_report(str(root / "on"))
    want = jreport.build_report(str(root / "on"))
    for key in ("ranks", "step_stats", "phase_totals", "streams"):
        assert got[key] == want[key], key
    assert got["step_stats"]["steps"] == STEPS - 1


class _HostReads:
    """Counts the calls that read a tensor's value on the host."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
             "__int__")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, **k):
                self.count += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, wrapped)
        sync = torch.cuda.synchronize

        def counted_sync(*a, **k):
            self.count += 1
            return sync(*a, **k)

        monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)


def test_telemetry_adds_no_host_reads(tmp_path, monkeypatch):
    """The whole fit, metric fetches included: telemetry and a profile
    window on take exactly as many host reads as telemetry off."""
    counts = {}
    for name, tel, prof in (("off", False, None), ("on", True,
                                                     ProfileConfig(
                                                         dir=str(tmp_path / "p"),
                                                         start_step=2,
                                                         num_steps=2))):
        with monkeypatch.context() as mp:
            reads = _HostReads(mp)
            _port_fit(tmp_path / name, tel, profile=prof)
            counts[name] = reads.count
    assert counts["on"] == counts["off"] > 0


def test_profile_window_and_whole_fit_capture_on_cpu(tmp_path):
    """Real torch.profiler sessions on the CPU: the step window exports
    one Chrome trace of steps 2-4 and profiler_dir one of the fit; on
    the CPU no device event is owed, so neither is empty."""
    trainer, _, _ = _port_fit(
        tmp_path, False, profile=ProfileConfig(dir=str(tmp_path / "win"),
                                               start_step=2, num_steps=2))
    ctl = trainer._profiler
    assert (ctl.captures, ctl.empty_captures, ctl.disabled_reason) == \
        (1, 0, None)
    [rec] = ctl.records
    assert (rec["start_step"], rec["end_step"], rec["empty"]) == (2, 4,
                                                                  False)
    with open(rec["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    trainer, _, _ = _port_fit(tmp_path / "fit", False,
                              profiler_dir=str(tmp_path / "whole"))
    assert os.path.exists(trainer.fit_capture["trace"])
    assert not trainer.fit_capture["empty"]


def test_fit_with_telemetry_matches_jax(tmp_path):
    """Both packages fit the tiny Llama with telemetry on, from the same
    weights over the same batches: per-step loss and grad_norm agree to
    2e-5 and both write the same span phases and a closed ledger."""
    jcfg, params = _jax_params()
    jrows = _JaxRows()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=STEPS)
    jm.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=JaxSingle(), callbacks=[jrows], telemetry=True,
               default_root_dir=str(tmp_path / "jax"), **COMMON).fit(
        jm, JaxDataLoader({"tokens": _tokens()}, batch_size=2, shuffle=True,
                          seed=0))
    _, _, rows = _port_fit(tmp_path / "torch", True, params=params)
    np.testing.assert_allclose(rows, jrows.rows, rtol=2e-5, atol=2e-5)
    phases = {}
    for name in ("jax", "torch"):
        tdir = str(tmp_path / name / "telemetry")
        spans = pspans.read_spans(_only(os.path.join(
            tdir, "rank0.*.spans.jsonl")))["spans"]
        phases[name] = {s["phase"] for s in spans
                        if s.get("thread", "main") == "main"}
        [led] = jgoodput.read_ledgers(tdir)
        assert led["end_step"] == STEPS and led["completed"]
    # both warm-start the step under a compile span and prefetch; a
    # data_wait span appears only where a step found no batch ready
    assert "compile" in phases["torch"] and "compile" in phases["jax"]
    assert phases["torch"] - {"data_wait"} == phases["jax"] - {"data_wait"}


# ---- report, CLI, drift -----------------------------------------------------------


@pytest.mark.parametrize("case", ["unmeasured", "slow", "ok"])
def test_build_drift_matches_jax(case):
    timeline = {
        "unmeasured": None,
        "slow": {"step_stats": {"steps": 10, "mean_s": 2e-3,
                                "p50_s": 2e-3, "max_s": 2e-3}},
        "ok": {"step_stats": {"steps": 10, "mean_s": 1.1e-3,
                              "p50_s": 1.1e-3, "max_s": 1.2e-3}},
    }[case]
    predicted = {"step_us": 1000.0, "overlap_hidden_fraction": 0.9}
    got = preport.build_drift(predicted, timeline)
    assert got == jreport.build_drift(predicted, timeline)
    assert got["verdict"] == {"unmeasured": "not-measured", "slow": "drift",
                              "ok": "ok"}[case]


def test_report_and_monitor_cli(fits, capsys):
    """``report --preset`` carries the drift section: the measured step
    against tracecheck's prediction for the preset (here the tiny Llama
    of the example on ``cpu-2``, cheap to trace), its ratio and verdict;
    ``monitor`` shows rank 0's last phase."""
    from ray_lightning_tpu_torch.__main__ import main

    run = str(fits[0] / "on")
    assert main(["report", run, "--json", "--preset",
                 "llama_fsdp_example.py", "--topo", "cpu-2"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["step_stats"]["steps"] == STEPS - 1
    drift = out["drift"]
    assert drift["measured"]["steps"] == STEPS - 1
    assert drift["predicted"]["step_us"] > 0
    assert drift["step_time_ratio"] == pytest.approx(
        drift["measured"]["step_us"] / drift["predicted"]["step_us"],
        rel=1e-2)
    assert drift["verdict"] in ("ok", "drift")
    assert (drift["verdict"] == "drift") == bool(drift["flags"])
    assert main(["report", run]) == 0
    assert "warm step time" in capsys.readouterr().out
    assert main(["monitor", run, "--json"]) == 0
    view = json.loads(capsys.readouterr().out.strip())
    assert view["ranks"]["0"]["phase"] in pspans.PHASES


def test_probe_cli_on_cpu(capsys):
    from ray_lightning_tpu_torch.__main__ import main
    from ray_lightning_tpu_torch.utils import probe

    assert main(["--probe", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["device"] == "cpu" and out["matmul_tflops"] > 0
    assert out["peak_tflops"] is None
    assert probe.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
