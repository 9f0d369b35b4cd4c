"""The port's live serving metrics (`telemetry/metrics.py` and the serve
path's call sites) against the JAX package's (`tests/test_serve_metrics.py`),
on the CPU.

Histograms are held to the JAX `Histogram` on the same seeded samples:
buckets, quantiles, sketch, merge and the dict round trip are EQUAL, not
close (both are exact integer bucket counts over the same layout).
Metrics files, flight rings and their postmortems cross-read equal
through both packages' readers. The port's scheduler and engine on the
tiny model count what happened (ground truth from the completions) and
record the same counter names and values as the JAX engine serving the
same requests; with metrics off the streams are identical token for
token and every kernel wrapper is called as often.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_lightning_tpu.serve.engine import EngineConfig as JaxEngineConfig
from ray_lightning_tpu.serve.scheduler import Request as JaxRequest
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu.telemetry import metrics as jm
from ray_lightning_tpu.telemetry import report as jreport
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    params_from_jax,
)
from ray_lightning_tpu_torch.ops.kernels import paged_attention as k_decode
from ray_lightning_tpu_torch.ops.kernels import paged_prefill as k_prefill
from ray_lightning_tpu_torch.ops.kernels import rmsnorm as k_rms
from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler
from ray_lightning_tpu_torch.telemetry import metrics as pm
from ray_lightning_tpu_torch.telemetry import report as preport

#: the serve tests' tiny model (head_dim 64, GQA 2:1)
COMMON = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
              hidden_dim=256, max_seq_len=128)
ENGINE = dict(capacity=2, block_size=4, blocks_per_slot=8, prefill_chunk=4)


def _samples(n=300, seed=0):
    return np.random.default_rng(seed).lognormal(mean=-4, sigma=2, size=n)


def _hist(mod, values):
    h = mod.Histogram()
    for v in values:
        h.observe(v)
    return h


def _same_hist(a, b):
    assert a.to_dict() == b.to_dict()
    assert a.sketch() == b.sketch()
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q), q


# ---- histograms ------------------------------------------------------------------


def test_histogram_layout_matches_jax():
    assert (pm.HIST_LO, pm.HIST_GROWTH, pm.HIST_BUCKETS) == (
        jm.HIST_LO, jm.HIST_GROWTH, jm.HIST_BUCKETS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_equal_jax(seed):
    values = _samples(seed=seed)
    got, want = _hist(pm, values), _hist(jm, values)
    _same_hist(got, want)
    assert got.n == 300 and sum(got.counts.values()) == 300
    assert got.quantile(1.0) == values.max()
    assert got.mean() == pytest.approx(want.mean(), rel=0, abs=0)


def test_histogram_edge_buckets_equal_jax():
    values = (0.0, -1.0, pm.HIST_LO / 2, pm.HIST_LO, 1e12, 0.003)
    got, want = _hist(pm, values), _hist(jm, values)
    _same_hist(got, want)
    assert got.counts[0] == 3 and got.counts[got.n_buckets + 1] == 1
    assert got.quantile(1.0) == 1e12


def test_histogram_merge_exact_and_order_independent():
    values = _samples(seed=5)
    whole = _hist(pm, values)
    parts = [_hist(pm, values[i::3]) for i in range(3)]
    fwd = pm.merge_histograms(parts)
    rev = pm.merge_histograms(list(reversed(parts)))
    _same_hist(fwd, whole)
    _same_hist(rev, whole)
    jparts = [_hist(jm, values[i::3]) for i in range(3)]
    _same_hist(fwd, jm.merge_histograms(jparts))
    assert pm.merge_histograms([]) is None
    with pytest.raises(ValueError, match="layout mismatch"):
        pm.Histogram().merge(pm.Histogram(lo=1e-3))


def test_histogram_round_trip_across_packages():
    h = _hist(pm, (0.01, 0.02, 3.0, 0.0))
    doc = json.loads(json.dumps(h.to_dict()))
    _same_hist(pm.Histogram.from_dict(doc), h)
    _same_hist(jm.Histogram.from_dict(doc), _hist(jm, (0.01, 0.02, 3.0,
                                                       0.0)))
    jdoc = json.loads(json.dumps(_hist(jm, (0.5,)).to_dict()))
    _same_hist(pm.Histogram.from_dict(jdoc), _hist(pm, (0.5,)))


# ---- the registry and its files -------------------------------------------------


def _script(reg):
    for i in range(10):
        reg.count("admissions")
        reg.count("decode_tokens", 3)
        reg.gauge("queue_depth", i % 4)
        reg.gauge("slot_occupancy", 0.5)
        reg.observe("ttft_s", 0.01 * (i + 1))
        reg.tick_end()


def _parsed_equal(a, b):
    a, b = dict(a), dict(b)
    ha, hb = a.pop("hists"), b.pop("hists")
    assert a == b
    assert set(ha) == set(hb)
    for name in ha:
        assert ha[name].to_dict() == hb[name].to_dict()


def test_registry_ring_and_drops_match_jax():
    regs = [mod.MetricsRegistry(ring_size=4) for mod in (pm, jm)]
    for reg in regs:
        _script(reg)
    got, want = regs
    assert got.ticks == want.ticks == 10 and got.dropped == want.dropped == 6
    assert [s["g"] for s in got.ring()] == [s["g"] for s in want.ring()]
    assert got.counters() == want.counters()
    assert got.histogram("ttft_s").to_dict() == \
        want.histogram("ttft_s").to_dict()


def test_registry_flush_cadence_and_cross_read(tmp_path):
    reg = pm.MetricsRegistry(str(tmp_path), replica=3, flush_every_n_ticks=4)
    path = reg._path
    for _ in range(3):
        reg.count("admissions")
        reg.tick_end()
    assert sum(1 for _ in open(path)) == 1  # the header only
    _script(reg)
    reg.close()
    got = pm.read_metrics(path)
    _parsed_equal(got, jm.read_metrics(path))
    assert got["header"]["replica"] == 3 and len(got["ticks"]) == 13
    assert got["counters"]["admissions"] == 13
    assert got["hists"]["ttft_s"].n == 10
    for tail in (200, 4096):
        _parsed_equal(pm.read_metrics(path, tail), jm.read_metrics(path,
                                                                    tail))
    assert pm.metrics_paths(str(tmp_path)) == jm.metrics_paths(
        str(tmp_path)) == [path]


def test_jax_metrics_files_read_equal_through_the_port(tmp_path):
    for replica, mod in enumerate((jm, pm)):
        reg = mod.MetricsRegistry(str(tmp_path), replica=replica,
                                  flush_every_n_ticks=2)
        _script(reg)
        reg.close()
    with open(pm.metrics_paths(str(tmp_path))[0], "a") as f:
        f.write("{torn line\n")
    for path in pm.metrics_paths(str(tmp_path)):
        _parsed_equal(pm.read_metrics(path), jm.read_metrics(path))
    got = pm.aggregate_metrics_dir(str(tmp_path))
    assert got == jm.aggregate_metrics_dir(str(tmp_path))
    assert got["counters"]["admissions"] == 20
    assert got["latency"]["ttft_s"]["n"] == 20
    assert pm.load_signal_from_dir(str(tmp_path)) == \
        jm.load_signal_from_dir(str(tmp_path))


def test_null_objects_are_inert():
    null = pm.NULL_METRICS
    null.count("x")
    null.gauge("y", 1.0)
    null.observe("z", 2.0)
    null.tick_end()
    assert null.counters() == {} and null.histogram("z") is None
    assert null.flush() == 0 and not null.enabled
    pm.NULL_FLIGHT.record("tick", tick=1)
    assert not pm.NULL_FLIGHT.enabled and pm.NULL_FLIGHT.path is None


# ---- the flight recorder --------------------------------------------------------


def test_flight_ring_persisted_bounded_and_cross_read(tmp_path):
    path = pm.flight_path(str(tmp_path), 0)
    fr = pm.FlightRecorder(path, replica=0, maxlen=8, persist_every=4)
    assert pm.read_flight(path)["events"] == []  # persisted at once
    for i in range(20):
        fr.record("tick", tick=i, queue_depth=i % 3)
    assert len(pm.read_flight(path)["events"]) <= 8
    fr.close()
    doc = pm.read_flight(path)
    assert doc == jm.read_flight(path)
    assert [e["tick"] for e in doc["events"]] == list(range(12, 20))
    assert doc["version"] == jm.FLIGHT_VERSION


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_finalize_flight_matches_jax(tmp_path, writer):
    mod = jm if writer == "jax" else pm
    tdir = str(tmp_path)
    fr = mod.FlightRecorder(mod.flight_path(tdir, 1), replica=1,
                            persist_every=1)
    fr.record("tick", tick=1)
    fr.record("preempt", rid="r0")
    death = {"kind": "retryable", "cause": "worker-signal:SIGKILL",
             "restartable": True}
    dumps = {}
    for name, fin in (("torch", pm), ("jax", jm)):
        out = str(tmp_path / f"flight.{name}.json")
        fin.finalize_flight(tdir, 1, death, out)
        fin.finalize_flight(tdir, 7, dict(death, kind="fatal"), out)
        with open(out) as f:
            doc = json.load(f)
        for d in doc["dumps"]:
            d.pop("dumped_at_wall")
        dumps[name] = doc
    assert dumps["torch"] == dumps["jax"]
    first, missing = dumps["torch"]["dumps"]
    assert [e["kind"] for e in first["events"]] == ["tick", "preempt"]
    assert missing["events"] == [] and "note" in missing


# ---- the scheduler and the engine ---------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLlama(JaxConfig(**COMMON, remat=False, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.key(1),
                                  jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = LlamaConfig(**COMMON, dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, 256, 3 + i % 5).astype(np.int32)
               for i in range(8)]
    return jmodel, params, model, prompts


class _Recording(pm.MetricsRegistry):
    """A registry that also keeps every value that was not a host
    scalar: a tensor here would mean the call site read the device."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.not_host = []

    def _check(self, value):
        if not isinstance(value, (int, float, np.integer, np.floating)):
            self.not_host.append(value)

    def count(self, name, n=1):
        self._check(n)
        super().count(name, n)

    def gauge(self, name, value):
        self._check(value)
        super().gauge(name, value)

    def observe(self, name, value):
        self._check(value)
        super().observe(name, value)


def _requests(cls, prompts, n=4, max_new=5, sampled=False):
    return [cls(rid=f"g{i}", prompt=prompts[i], max_new_tokens=max_new,
                temperature=0.7 if sampled and i % 2 else 0.0,
                top_k=3 if sampled and i % 2 else None, seed=i)
            for i in range(n)]


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    done, ticks = {}, 0
    while sched.busy():
        for c in sched.tick():
            done[c.rid] = c
        ticks += 1
    return done, ticks


def _port_run(model, reqs, metrics=None, flight=None, **ecfg):
    eng = DecodeEngine(model, EngineConfig(**{**ENGINE, **ecfg}),
                       device="cpu", metrics=metrics, use_kernels=True)
    assert (eng.attention_path, eng.prefill_path) == ("paged-kernel",
                                                      "paged-kernel")
    eng.warmup()
    sched = Scheduler(eng, metrics=metrics, flight=flight,
                      reserve="on_demand" if "n_blocks" in ecfg
                      else "worst_case")
    return _serve(sched, reqs)


def _jax_run(jmodel, params, reqs, metrics, **ecfg):
    eng = JaxEngine(jmodel, params, JaxEngineConfig(**{**ENGINE, **ecfg}),
                    metrics=metrics)
    eng.warmup()
    sched = JaxScheduler(eng, metrics=metrics,
                         reserve="on_demand" if "n_blocks" in ecfg
                         else "worst_case")
    return _serve(sched, reqs)


@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_counts_equal_ground_truth_and_the_jax_engine(tiny, tmp_path, pool):
    """Greedy requests through both packages (``tight``: a pool that
    forces growth stalls and preemptions): the counters equal ground
    truth from the completions and the JAX engine's, name for name and
    value for value; so do the gauges the JAX scheduler records; every
    recorded value is a host scalar; the latency histograms hold one
    sample a request."""
    jmodel, params, model, prompts = tiny
    ecfg = {} if pool == "roomy" else dict(n_blocks=9)
    max_new = 5 if pool == "roomy" else 20
    prompt_ids = range(4) if pool == "roomy" else [4, 4]
    reqs = [Request(rid=f"g{n}", prompt=prompts[i], max_new_tokens=max_new,
                    seed=n) for n, i in enumerate(prompt_ids)]
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=max_new,
                        seed=r.seed) for r in reqs]
    reg = _Recording(str(tmp_path), flush_every_n_ticks=3)
    done, ticks = _port_run(model, reqs, metrics=reg, **ecfg)
    jreg = jm.MetricsRegistry()
    jdone, jticks = _jax_run(jmodel, params, jreqs, jreg, **ecfg)
    assert {k: v.tokens for k, v in done.items()} == \
        {k: v.tokens for k, v in jdone.items()}
    c = reg.counters()
    assert c == jreg.counters()
    preempted = sum(d.preempted for d in done.values())
    assert c.get("preemptions", 0) == preempted
    # a preempted request is admitted again when it resumes
    assert c["admissions"] == len(reqs) + preempted
    assert c["completions"] == len(reqs)
    delivered = sum(len(d.tokens) for d in done.values())
    # tokens a preemption discarded were decoded, and are decoded again
    assert c["decode_tokens"] == delivered if not preempted \
        else c["decode_tokens"] > delivered
    assert c["prefill_tokens"] > 0 and c["prefill_tokens"] % 4 == 0
    if pool == "tight":
        assert c["preemptions"] >= 1
        assert c["growth_stalls"] >= c["preemptions"]
    gauges, jgauges = reg.gauges(), jreg.gauges()
    # the JAX engine's compile_count counts compiled step programs; the
    # eager port compiles none and records no such gauge
    assert gauges == {k: v for k, v in jgauges.items()
                      if k != "compile_count"}
    assert gauges["queue_depth"] == 0
    assert reg.ticks == ticks == jticks and reg.not_host == []
    for name in ("queue_wait_s", "ttft_s", "tpot_s", "decode_s"):
        assert reg.histogram(name).n == len(reqs), name
    reg.close()
    agg = pm.aggregate_metrics_dir(str(tmp_path))
    assert agg == jm.aggregate_metrics_dir(str(tmp_path))
    assert agg["counters"] == c


class _Calls:
    """Counts the kernel wrappers' calls (on CPU tensors they run their
    plain versions, whose module globals are patched here)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for mod, name in ((k_decode, "paged_attention_plain"),
                          (k_prefill, "paged_prefill_plain"),
                          (k_rms, "rms_norm_plain")):
            orig = getattr(mod, name)

            def counted(*a, _orig=orig, _name=name, **k):
                self.n[_name] = self.n.get(_name, 0) + 1
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, counted)


def test_metrics_off_streams_and_calls_identical(tiny, tmp_path,
                                                 monkeypatch):
    """Greedy and sampled streams with a live registry and flight
    recorder equal those with metrics off, token for token, over the
    same ticks and kernel-wrapper calls."""
    _, _, model, prompts = tiny
    runs = {}
    for name in ("off", "on"):
        with monkeypatch.context() as mp:
            calls = _Calls(mp)
            reqs = _requests(Request, prompts, max_new=6, sampled=True)
            if name == "on":
                reg = pm.MetricsRegistry(str(tmp_path))
                fr = pm.FlightRecorder(pm.flight_path(str(tmp_path), 0))
                done, ticks = _port_run(model, reqs, metrics=reg, flight=fr)
            else:
                done, ticks = _port_run(model, reqs)
            runs[name] = ({k: v.tokens for k, v in done.items()}, ticks,
                          calls.n)
    assert runs["on"] == runs["off"]
    assert runs["on"][2]["paged_attention_plain"] > 0
    fr.close()
    ring = pm.read_flight(pm.flight_path(str(tmp_path), 0))
    kinds = {e["kind"] for e in ring["events"]}
    assert {"admit", "tick", "retire"} <= kinds
    assert ring["events"][-1]["kind"] == "tick"


def test_report_serving_section_and_monitor_serve(tiny, tmp_path, capsys):
    """A served run dir: the port's serving section equals the JAX
    one's (p99 and sketch from merged buckets), and ``monitor --serve``
    shows the replica's last tick."""
    from ray_lightning_tpu_torch.__main__ import main

    _, _, model, prompts = tiny
    tdir = tmp_path / "telemetry"
    reg = pm.MetricsRegistry(str(tdir), flush_every_n_ticks=4)
    _port_run(model, _requests(Request, prompts), metrics=reg)
    reg.close()
    got = preport.build_serving_section(str(tmp_path))
    assert got == jreport.build_serving_section(str(tmp_path))
    assert got["ttft_n"] == 4 and got["ttft_p99_s"] >= got["ttft_p50_s"]
    assert sum(c for _, c in got["ttft_sketch"]) == 4
    assert main(["monitor", str(tmp_path), "--serve", "--json"]) == 0
    view = json.loads(capsys.readouterr().out.strip())
    assert view["replicas"]["0"]["queue_depth"] == 0
    assert view["load_signal"]["available"]
