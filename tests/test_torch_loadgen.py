"""The port's trace-driven load harness (`loadgen/`) against the JAX
package's (the cases of tests/test_loadgen.py), on the CPU.

The same `WorkloadConfig` gives the same trace BYTES in both packages
(seeds 0-3, Poisson and MMPP, with and without a class mix), and a trace
written by either package reads, and replays, in the other. The replay
leg serves one bursty mixed-class trace through the port's driver on the
suite's tiny Llama (`params_from_jax` of the JAX build): two runs give
identical streams and per-class accounting, every completed greedy
stream equals the JAX driver's for the same trace token for token,
best-effort sheds carry retry-after hints, and latency-critical is never
shed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.loadgen import cli as jcli
from ray_lightning_tpu.loadgen import generator as jgen
from ray_lightning_tpu.loadgen import trace as jtrace
from ray_lightning_tpu_torch.loadgen import cli as pcli
from ray_lightning_tpu_torch.loadgen.generator import (
    WorkloadConfig,
    generate_events,
)
from ray_lightning_tpu_torch.loadgen.trace import (
    TRACE_KIND,
    TRACE_VERSION,
    TraceEvent,
    arrivals_by_tick,
    dump_trace,
    events_from_arrivals,
    read_trace,
    to_request,
    write_trace,
)
from ray_lightning_tpu_torch.serve.scheduler import Request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = {"latency_critical": 0.3, "standard": 0.3, "best_effort": 0.4}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("process", ["poisson", "mmpp"])
@pytest.mark.parametrize("mix", [None, MIX], ids=["default_mix", "mix"])
def test_trace_bytes_equal_jax(seed, process, mix):
    kw = dict(seed=seed, n_requests=24, process=process, rate=1.5,
              burst_rate=6.0, prompt_len_max=40, class_mix=mix,
              vocab_size=128256)
    wl, jwl = WorkloadConfig(**kw), jgen.WorkloadConfig(**kw)
    assert wl.meta() == jwl.meta()
    mine = dump_trace(generate_events(wl), wl.meta())
    assert mine == jtrace.dump_trace(jgen.generate_events(jwl),
                                     jwl.meta())
    assert mine != dump_trace(generate_events(
        WorkloadConfig(**{**kw, "seed": seed + 10})))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trace_written_by_either_package_reads_in_both(tmp_path, writer):
    wl = WorkloadConfig(seed=5, n_requests=12, process="mmpp",
                        class_mix=MIX)
    path = str(tmp_path / "trace.jsonl")
    if writer == "jax":
        jtrace.write_trace(path, jgen.generate_events(
            jgen.WorkloadConfig(**vars(wl))), wl.meta())
    else:
        write_trace(path, generate_events(wl), wl.meta())
    header, events = read_trace(path)
    jheader, jevents = jtrace.read_trace(path)
    assert header == jheader
    assert header["kind"] == TRACE_KIND and header["version"] == 1
    assert [e.to_dict() for e in events] == [e.to_dict() for e in jevents]
    assert dump_trace(events, header["meta"]) == open(path).read()


def test_version_kind_and_truncation_refused(tmp_path):
    path = str(tmp_path / "t.jsonl")
    write_trace(path, generate_events(WorkloadConfig(n_requests=4)))
    lines = open(path).read().splitlines()
    for field, value, match in (("version", 999, "version"),
                                ("kind", "other", "not a"),
                                ("events", 9, "truncated")):
        head = json.loads(lines[0])
        head[field] = value
        with open(path, "w") as f:
            f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
        with pytest.raises(ValueError, match=match) as pe:
            read_trace(path)
        with pytest.raises(ValueError) as je:
            jtrace.read_trace(path)
        assert str(pe.value) == str(je.value)
    open(path, "w").close()
    with pytest.raises(ValueError, match="empty"):
        read_trace(path)
    assert TRACE_VERSION == jtrace.TRACE_VERSION


def test_to_request_and_arrivals():
    ev = TraceEvent(tick=2, rid="x", prompt=(1, 2, 3), max_new_tokens=4,
                    priority="latency_critical", temperature=0.5,
                    top_k=3, seed=9)
    req = to_request(ev)
    assert isinstance(req, Request)
    assert req.prompt.dtype == np.int32
    assert req.prompt.tolist() == [1, 2, 3]
    assert (req.priority, req.seed, req.top_k, req.temperature) == (
        "latency_critical", 9, 3, 0.5)
    d = ev.to_dict()
    del d["priority"]
    assert TraceEvent.from_dict(d).priority == "standard"
    with pytest.raises(ValueError):
        to_request(TraceEvent(tick=0, rid="y", prompt=(1,),
                              max_new_tokens=1, priority="vip"))
    evs = generate_events(WorkloadConfig(seed=1, n_requests=5))
    assert events_from_arrivals(arrivals_by_tick(evs)) == \
        sorted(evs, key=lambda e: (e.tick, e.rid))
    with pytest.raises(ValueError) as pe:
        WorkloadConfig(class_mix={"vip": 1.0}).mix()
    with pytest.raises(ValueError) as je:
        jgen.WorkloadConfig(class_mix={"vip": 1.0}).mix()
    assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError):
        WorkloadConfig(process="weibull")


class _StubDriver:
    """Records the runner's submit/tick schedule; drains after a fixed
    number of ticks per outstanding request."""

    def __init__(self):
        self.submitted = []
        self.ticks = 0
        self._outstanding = 0

    def submit(self, req):
        self.submitted.append((self.ticks, req.rid))
        self._outstanding += 1

    def tick(self):
        self.ticks += 1
        if self._outstanding and self.ticks % 2 == 0:
            self._outstanding -= 1

    def busy(self):
        return self._outstanding > 0


class _StubController:
    def __init__(self):
        self.polls = []

    def step(self, now):
        self.polls.append(now)
        return {"now": now}


def test_run_trace_and_run_scripted_drive_the_same_schedule():
    """`autoscale.sim.run_scripted` is a shim over `run_trace`: the same
    arrivals give the same submit/tick schedule and polls, in both
    packages."""
    from ray_lightning_tpu.autoscale.sim import ScriptedLoad as JLoad
    from ray_lightning_tpu.autoscale.sim import run_scripted as jscripted
    from ray_lightning_tpu.loadgen.runner import run_trace as jrun
    from ray_lightning_tpu_torch.autoscale.sim import (
        ScriptedLoad,
        run_scripted,
    )
    from ray_lightning_tpu_torch.loadgen import TraceRecorder, run_trace

    events = generate_events(WorkloadConfig(seed=3, n_requests=10,
                                            process="mmpp"))
    runs = []
    for fn in ("trace", "scripted", "jax_trace", "jax_scripted"):
        drv, ctl = _StubDriver(), _StubController()
        if fn == "trace":
            rec = TraceRecorder(meta={"m": 1})
            out = run_trace(drv, events, controller=ctl,
                            idle_ticks_after_drain=4, recorder=rec)
            assert rec.dump() == dump_trace(events, {"m": 1})
        elif fn == "scripted":
            load = ScriptedLoad(arrivals=arrivals_by_tick(events),
                                idle_ticks_after_drain=4)
            assert dump_trace(load.to_events()) == dump_trace(events)
            out = run_scripted(drv, ctl, load)
        elif fn == "jax_trace":
            out = jrun(drv, [jtrace.TraceEvent(**e.to_dict())
                             for e in events], controller=ctl,
                       idle_ticks_after_drain=4)
        else:
            out = jscripted(drv, ctl, JLoad(
                arrivals=arrivals_by_tick(events),
                idle_ticks_after_drain=4))
        runs.append((drv.submitted, ctl.polls, out["ticks"],
                     out["drained_at"], out["entries"]))
    assert all(r == runs[0] for r in runs[1:])
    assert len(runs[0][0]) == 10


def test_class_slo_rules_shapes_equal_jax():
    from ray_lightning_tpu.serve.scheduler import SLOConfig as JaxSLO
    from ray_lightning_tpu.telemetry.watch import class_slo_rules as jrules
    from ray_lightning_tpu_torch.serve.scheduler import SLOConfig
    from ray_lightning_tpu_torch.telemetry.watch import class_slo_rules

    for slo, jslo in ((SLOConfig(), JaxSLO()),
                      (pcli._mixed_slo(0), jcli._mixed_slo(0))):
        mine = [r.to_dict() for r in class_slo_rules(slo, sustain=2)]
        assert mine == [r.to_dict() for r in jrules(jslo, sustain=2)]
    rules = {r.name: r for r in class_slo_rules(SLOConfig())}
    assert rules["slo_ttft_latency_critical"].severity == "page"
    assert rules["shed_best_effort"].metric == "load.sheds_best_effort"


# ---- the replay leg on the suite's tiny Llama --------------------------------


@pytest.fixture(scope="module")
def twins(tiny_llama_f32):
    from ray_lightning_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        params_from_jax,
    )

    _, jmodel, params, _ = tiny_llama_f32
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model


def _accounting(meta):
    return sorted((r, m["finish_reason"], m["priority"])
                  for r, m in meta.items())


def test_replay_deterministic_and_equal_to_the_jax_driver(twins,
                                                          tmp_path):
    jmodel, params, model = twins
    wl = pcli._burst_workload()
    events = generate_events(wl)
    slo = pcli._mixed_slo(be_budget=1)
    runs = []
    for i in range(2):
        drv, sim = pcli._run_trace_inline(model, events, slo,
                                          str(tmp_path / f"run{i}"))
        runs.append((sim, drv.stop()))
    (sim0, res0), (sim1, res1) = runs
    assert res0.outputs == res1.outputs
    assert _accounting(res0.meta) == _accounting(res1.meta)
    assert sim0["ticks"] == sim1["ticks"]
    assert pcli._per_class(res0.meta) == pcli._per_class(res1.meta)
    # every rid terminal: completed or shed, nothing silent
    assert set(res0.meta) == {e.rid for e in events}
    assert {m["finish_reason"] for m in res0.meta.values()} <= {
        "eos", "length", "shed"}
    per_class = pcli._per_class(res0.meta)
    assert per_class["best_effort"]["sheds"] >= 1
    assert per_class.get("latency_critical", {}).get("sheds", 0) == 0
    for rid in pcli._shed_rids(res0.meta):
        m = res0.meta[rid]
        assert m["priority"] == "best_effort"
        assert m["reason"] and m["retry_after_s"] > 0
    # the JAX driver on the same trace and weights
    jdrv, _ = jcli._run_trace_inline(jmodel.cfg, params,
                                     jgen.generate_events(
                                         jcli._burst_workload()),
                                     jcli._mixed_slo(be_budget=1),
                                     str(tmp_path / "jax"))
    jres = jdrv.stop()
    assert _accounting(jres.meta) == _accounting(res0.meta)
    greedy = [e.rid for e in events if e.temperature == 0.0
              and res0.meta[e.rid]["finish_reason"] != "shed"]
    assert greedy
    for rid in greedy:
        assert res0.outputs[rid] == [int(t) for t in jres.outputs[rid]], rid
    # every completed stream, greedy or sampled, equals `generate`
    refs = pcli._trace_refs(model, [e for e in events
                                    if e.rid not in pcli._shed_rids(
                                        res0.meta)])
    assert [r for r, ref in refs.items() if res0.outputs[r] != ref] == []


def test_jax_written_trace_replays_through_the_port(twins, tmp_path):
    """A trace file the JAX package wrote drives the port's driver, and
    the port's recorder writes it back byte for byte."""
    from ray_lightning_tpu_torch.loadgen import TraceRecorder, run_trace
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    _, _, model = twins
    jwl = jgen.WorkloadConfig(seed=2, n_requests=6, rate=1.0)
    path = str(tmp_path / "jax_trace.jsonl")
    jtrace.write_trace(path, jgen.generate_events(jwl), jwl.meta())
    header, events = read_trace(path)
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        engine=EngineConfig(capacity=2, block_size=4, blocks_per_slot=8,
                            prefill_chunk=4), device="cpu")).start()
    rec = TraceRecorder(meta=header["meta"])
    out = run_trace(drv, events, idle_ticks_after_drain=0, recorder=rec)
    res = drv.stop()
    assert out["submitted"] == 6 and len(res.meta) == 6
    assert rec.dump() == open(path).read()


def test_loadgen_cli_generate_replay_and_smoke(tmp_path):
    """``loadgen --out`` writes the JAX CLI's bytes; ``--trace`` replays
    the file on the CPU; ``--smoke --device cpu`` exits 0 with ``"ok":
    true``."""
    env = {**os.environ, "PYTHONPATH": ROOT}

    def run(*argv, timeout=120):
        return subprocess.run(
            [sys.executable, "-m", "ray_lightning_tpu_torch", "loadgen",
             *argv], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=timeout)

    out = str(tmp_path / "trace.jsonl")
    proc = run("--out", out, "--seed", "7", "--process", "mmpp", "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    wl = jgen.WorkloadConfig(seed=7, n_requests=32, process="mmpp",
                             rate=2.0, burst_rate=8.0)
    assert open(out).read() == jtrace.dump_trace(
        jgen.generate_events(wl), wl.meta())
    proc = run("--trace", out, "--device", "cpu", "--json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["events"] == 32
    proc = run("--smoke", "--device", "cpu", timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True
    assert verdict["legs"]["replay"]["incidents"] == ["shed_best_effort"]
