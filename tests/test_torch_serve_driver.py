"""The port's replica driver (`serve/driver.py`) against the JAX
package's (the cases of tests/test_serve_driver.py and the live-session
half of tests/test_serve_session.py), on the CPU.

The same weights (`params_from_jax` of the suite's canonical tiny-Llama
build, f32) serve the same requests through the JAX driver and the
port's: greedy outputs must agree token for token. Every stream the
port's driver serves, greedy or sampled, must equal the port's
`generate` for its request: through two inline replicas, through the
live session's add and graceful remove, and through two process
replicas one of which is SIGKILL'd mid-stream and replayed. Run dirs
and params files are read across packages.
"""
from __future__ import annotations

import glob
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve import driver as jdrv
from ray_lightning_tpu.serve.engine import EngineConfig as JaxEngineConfig
from ray_lightning_tpu.serve.scheduler import Request as JaxRequest
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    generate,
    init_weights,
    params_from_jax,
)
from ray_lightning_tpu_torch.serve.channel import channel_dir
from ray_lightning_tpu_torch.serve.driver import (
    ReplicaGroupConfig,
    ServeDriver,
    _start_replica,
    aggregate_serve_metrics,
    load_params_npz,
    load_signal,
    save_params_npz,
)
from ray_lightning_tpu_torch.serve.engine import EngineConfig
from ray_lightning_tpu_torch.serve.scheduler import Request

ENGINE = dict(capacity=2, block_size=4, blocks_per_slot=8, prefill_chunk=4)
ECFG = EngineConfig(**ENGINE)


@pytest.fixture(scope="module")
def setup(tiny_llama_f32):
    """(JAX model, JAX params, the port's twin, 8 ragged prompts)."""
    _, jmodel, params, _ = tiny_llama_f32
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(60)
    prompts = [rng.integers(0, cfg.vocab_size, 3 + i % 4).astype(np.int32)
               for i in range(8)]
    return jmodel, params, model, prompts


def _requests(prompts, max_new=6, cls=Request, sampled=True):
    return [cls(rid=f"r{i}", prompt=p, max_new_tokens=max_new,
                temperature=0.6 if sampled and i % 2 else 0.0,
                top_k=3 if sampled and i % 2 else None, seed=5 + i)
            for i, p in enumerate(prompts)]


def _refs(model, reqs):
    return {r.rid: generate(model, r.prompt[None], r.max_new_tokens,
                            temperature=r.temperature, top_k=r.top_k,
                            seed=r.seed)[0].tolist() for r in reqs}


def _cfg(**kw):
    return ReplicaGroupConfig(**{"engine": ECFG, "device": "cpu", **kw})


def test_params_file_roundtrips_exact_bits(setup, tmp_path):
    """f32 and bf16 leaves come back bit for bit with their dtypes, with
    no JAX and no bf16 type in numpy."""
    _, _, model, _ = setup
    path = str(tmp_path / "p.npz")
    save_params_npz(model, path)
    loaded = load_params_npz(path)
    assert loaded.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    gen = torch.Generator()
    gen.manual_seed(2)
    bf = init_weights(LlamaConfig.tiny(), gen, device="cpu")
    save_params_npz(bf.state_dict(), str(tmp_path / "b.npz"))
    back = load_params_npz(str(tmp_path / "b.npz"))
    for k, v in bf.state_dict().items():
        assert back[k].dtype == v.dtype, k
        bits = (lambda t: t.view(torch.int16)
                if t.dtype == torch.bfloat16 else t)
        assert torch.equal(bits(back[k]), bits(v)), k
    assert any(v.dtype == torch.bfloat16 for v in back.values())
    with np.load(str(tmp_path / "b.npz")) as data:
        assert data["lm_head"].dtype == np.int16


def test_jax_written_params_file_is_read(setup, tmp_path):
    """A file the JAX driver wrote is read through `params_from_jax`, and
    a port driver serves from it directly."""
    jmodel, params, model, prompts = setup
    path = str(tmp_path / "jax.npz")
    jdrv.save_params_npz(params, path)
    sd = params_from_jax(load_params_npz(path), model.cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    reqs = _requests(prompts[:2], max_new=3)
    res = ServeDriver(model.cfg, path, _cfg()).run(reqs)
    assert res.outputs == _refs(model, reqs)


def test_inline_two_replicas_parity_and_summary(setup, tmp_path):
    _, _, model, prompts = setup
    reqs = _requests(prompts)
    run_dir = str(tmp_path / "run")
    res = ServeDriver(model.cfg, model, _cfg(n_replicas=2,
                                             run_dir=run_dir)).run(reqs)
    assert res.outputs == _refs(model, reqs)
    assert res.stats["n_tokens"] == sum(map(len, res.outputs.values()))
    assert res.stats["compile_count"] == -1
    assert res.restarts == {0: 0, 1: 0}
    assert {m["replica"] for m in res.meta.values()} == {0, 1}
    with open(os.path.join(run_dir, "serving.json")) as f:
        summary = json.load(f)
    assert summary["stats"]["n_requests"] == 8
    # both packages' report reads the port's run dir
    from ray_lightning_tpu.telemetry.report import (
        build_serving_section as jax_section,
    )
    from ray_lightning_tpu_torch.telemetry.report import (
        build_serving_section,
    )

    for section in (build_serving_section(run_dir), jax_section(run_dir)):
        assert section is not None and section["requests"] == 8
        assert section["ttft_p95_s"] >= section["ttft_p50_s"] >= 0


def test_jax_driver_greedy_outputs_equal_the_ports(setup, tmp_path):
    """The JAX driver and the port's serve the same greedy requests over
    two inline replicas on the same weights: token for token."""
    jmodel, params, model, prompts = setup
    jres = jdrv.ServeDriver(jmodel.cfg, params, jdrv.ReplicaGroupConfig(
        n_replicas=2, backend="inline", engine=JaxEngineConfig(**ENGINE))
    ).run(_requests(prompts, cls=JaxRequest, sampled=False))
    res = ServeDriver(model.cfg, model, _cfg(n_replicas=2)).run(
        _requests(prompts, sampled=False))
    assert res.outputs == {k: [int(t) for t in v]
                           for k, v in jres.outputs.items()}


def test_run_does_not_mutate_caller_requests(setup):
    _, _, model, prompts = setup
    reqs = _requests(prompts[:2], max_new=3)
    drv = ServeDriver(model.cfg, model, _cfg())
    res1 = drv.run(reqs)
    assert all(r.arrival == 0.0 for r in reqs), "caller objects mutated"
    res2 = drv.run(reqs)
    assert res1.outputs == res2.outputs
    for rid in res1.outputs:
        assert (0.0 <= res2.meta[rid]["queue_wait_s"]
                <= res2.stats["wall_s"] + 0.5)


def test_refusals(setup):
    _, _, model, prompts = setup
    with pytest.raises(ValueError, match="process"):
        ServeDriver(model.cfg, model, _cfg()).run(
            _requests(prompts[:1]), fault={"replica": 0,
                                           "kill_after_tokens": 1})
    with pytest.raises(ValueError, match="npz"):
        ServeDriver(model.cfg, model, _cfg(backend="process"))
    with pytest.raises(NotImplementedError,
                       match="item 8: tensor-parallel replicas"):
        _cfg(backend="process", tp=2)
    with pytest.raises(NotImplementedError, match="speculative"):
        _cfg(draft_model_cfg=model.cfg)
    with pytest.raises(NotImplementedError, match="speculative"):
        ServeDriver(model.cfg, model, _cfg(), draft_params={})


def test_no_card_raises(setup, tmp_path):
    """The driver and a process replica run on the card unless asked for
    the CPU: with no card both raise, neither falls back."""
    _, _, model, _ = setup
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeDriver(model.cfg, model, ReplicaGroupConfig(engine=ECFG))
    path = str(tmp_path / "p.npz")
    save_params_npz(model, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _start_replica(model.cfg, path, ECFG, None, "cuda", None)


def test_serving_spans_flushed(setup, tmp_path):
    from ray_lightning_tpu_torch.telemetry.spans import (
        PH_DECODE,
        PH_PREFILL,
        PH_QUEUE_WAIT,
        read_spans,
    )

    _, _, model, prompts = setup
    run_dir = str(tmp_path / "run")
    ServeDriver(model.cfg, model, _cfg(run_dir=run_dir)).run(
        _requests(prompts[:3], max_new=4))
    files = glob.glob(os.path.join(run_dir, "telemetry",
                                   "rank*.spans.jsonl"))
    spans = [s for f in files for s in read_spans(f)["spans"]]
    assert {PH_QUEUE_WAIT, PH_PREFILL, PH_DECODE} <= {s["phase"]
                                                      for s in spans}
    decode = [s for s in spans if s["phase"] == PH_DECODE]
    assert len(decode) == 3
    assert all("ttft_s" in (s.get("meta") or {}) for s in decode)


def test_metrics_rollups_equal_jax_on_the_same_files(setup, tmp_path):
    """`load_signal` and `aggregate_serve_metrics` of either package read
    the same numbers from the port's run dir and from the JAX driver's."""
    jmodel, params, model, prompts = setup
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    ServeDriver(model.cfg, model, _cfg(
        n_replicas=2, run_dir=port_dir,
        metrics_flush_every_n_ticks=4)).run(_requests(prompts))
    jdrv.ServeDriver(jmodel.cfg, params, jdrv.ReplicaGroupConfig(
        n_replicas=2, backend="inline", engine=JaxEngineConfig(**ENGINE),
        run_dir=jax_dir, metrics_flush_every_n_ticks=4)).run(
        _requests(prompts, cls=JaxRequest))
    for run_dir in (port_dir, jax_dir):
        sig, agg = load_signal(run_dir), aggregate_serve_metrics(run_dir)
        assert sig["available"] and agg is not None
        assert sig == jdrv.load_signal(run_dir)
        assert agg == jdrv.aggregate_serve_metrics(run_dir)
        assert agg["counters"]["completions"] == 8


def test_session_add_and_graceful_remove(setup, tmp_path):
    """start with one replica, submit half, add a replica, submit the
    rest, remove replica 0 gracefully while it holds work, stop: every
    stream equals `generate`, and the drained replica finished its own
    slotted work."""
    _, _, model, prompts = setup
    reqs = _requests(prompts)
    drv = ServeDriver(model.cfg, model, _cfg(run_dir=str(tmp_path / "r")))
    drv.start()
    for r in reqs[:4]:
        drv.submit(r)
    assert drv.add_replica() == 1
    for r in reqs[4:]:
        drv.submit(r)
    drv.tick()
    assert drv.replicas[0].sched.slots, "replica 0 holds no work"
    assert drv.remove_replica(0, graceful=True) == 0
    assert drv.live_ids == [1] and drv.n_draining == 1
    res = drv.stop()
    assert res.outputs == _refs(model, reqs)
    assert res.stats["replicas_spawned"] == 2
    assert res.stats["final_replicas"] == 1
    assert {m["replica"] for m in res.meta.values()} == {0, 1}
    with pytest.raises(RuntimeError, match="start"):
        drv.submit(reqs[0])


def test_session_defers_without_a_live_replica(setup):
    _, _, model, prompts = setup
    reqs = _requests(prompts[:3], max_new=3)
    drv = ServeDriver(model.cfg, model, _cfg()).start()
    drv.remove_replica(graceful=False)
    assert drv.submit(reqs[0]) is None
    assert drv.last_deferral["rid"] == "r0"
    with pytest.raises(RuntimeError, match="deferred"):
        drv.stop()
    drv.add_replica()
    for r in reqs[1:]:
        drv.submit(r)
    assert drv.stop().outputs == _refs(model, reqs)


def test_process_replica_kill_respawns_and_replays(setup, tmp_path):
    """Two process replicas, replica 1 SIGKILL'd after 6 tokens: the
    death is classified retryable, the replica respawns from the params
    file and its streams replay bitwise; replica 0 never restarts; the
    flight recorder's postmortem carries the classification."""
    _, _, model, prompts = setup
    reqs = _requests(prompts)
    pp = str(tmp_path / "params.npz")
    save_params_npz(model, pp)
    run_dir = tmp_path / "run"
    res = ServeDriver(model.cfg, pp, _cfg(
        n_replicas=2, backend="process", run_dir=str(run_dir),
        compile_cache_dir=str(tmp_path / "kc"),
        flight_persist_every=4)).run(
        reqs, fault={"replica": 1, "kill_after_tokens": 6})
    assert res.restarts == {0: 0, 1: 1}
    assert res.outputs == _refs(model, reqs)
    starts = res.stats["replica_starts"]
    assert sorted((s["replica"], s["attempt"]) for s in starts) == [
        (0, 0), (1, 0), (1, 1)]
    assert res.stats["warmup_respawn_s"] is not None
    assert all(s["build_s"] == 0.0 for s in starts)  # no kernel on a CPU
    with open(run_dir / "flight.json") as f:
        dump = json.load(f)["dumps"][0]
    assert dump["replica"] == 1
    assert dump["death"]["kind"] == "retryable"
    assert dump["death"]["cause"] == "worker-signal:SIGKILL"
    assert dump["death"]["respawning"] is True
    assert any(e.get("kind") == "tick" for e in dump["events"])


def test_process_session_kill_replays_on_a_fresh_epoch(setup, tmp_path):
    """A live session over process replicas fed by the request channel:
    replica 0's worker is SIGKILL'd mid-stream, respawns on a fresh
    channel epoch whose replay re-serves its unfinished work; replica 1
    is added mid-session and replica 0 drained gracefully at the end."""
    _, _, model, prompts = setup
    reqs = _requests(prompts, max_new=8)
    pp = str(tmp_path / "params.npz")
    save_params_npz(model, pp)
    run_dir = str(tmp_path / "run")
    drv = ServeDriver(model.cfg, pp, _cfg(backend="process",
                                          run_dir=run_dir))
    drv.start(fault={"replica": 0, "kill_after_tokens": 10})
    for r in reqs[:4]:
        drv.submit(r)
    drv.add_replica()
    for r in reqs[4:]:
        drv.submit(r)
    deadline = time.time() + 120
    while drv.busy():
        assert time.time() < deadline, "session did not drain"
        drv.tick()
        time.sleep(0.01)
    drv.remove_replica(0, graceful=True)
    res = drv.stop()
    assert res.restarts[0] >= 1, "kill did not trigger a respawn"
    assert res.outputs == _refs(model, reqs)
    assert "epoch1.jsonl" in {p.name for p in
                              channel_dir(run_dir, 0).iterdir()}


def test_injected_spawn_fault_classifies_like_the_jax_one(setup):
    """The autoscale drill's seam: the next `add_replica` dies with a
    worker-shaped SIGKILL that both packages' `classify_failure` read as
    retryable, and the session carries on."""
    from ray_lightning_tpu.resilience.policy import (
        classify_failure as jax_classify,
    )
    from ray_lightning_tpu_torch.resilience.policy import classify_failure
    from ray_lightning_tpu_torch.runtime.group import WorkerError

    _, _, model, prompts = setup
    drv = ServeDriver(model.cfg, model, _cfg()).start()
    drv.inject_spawn_faults(1)
    with pytest.raises(WorkerError) as info:
        drv.add_replica()
    for classify in (classify_failure, jax_classify):
        fc = classify(info.value)
        assert (fc.kind, fc.cause) == ("retryable", "worker-signal:SIGKILL")
    assert drv.add_replica() == 1
    reqs = _requests(prompts[:2], max_new=3)
    for r in reqs:
        drv.submit(r)
    assert drv.stop().outputs == _refs(model, reqs)
