"""The port's elastic supervision (`elastic/budget.py`, the supervisor's
elastic loop) against the JAX package's (the cases of
tests/test_elastic.py and the elastic half of tests/test_autoscale.py),
on the CPU.

`ElasticBudget`'s ladder (`legal`, `legal_worlds`, `largest_legal`,
`batch_plan`) equals the JAX budget's over a grid of mesh templates,
worlds and global batches, and `_elastic_decision` the JAX decision over
a grid of world, launch world, allowed, spent and capacity, also for
templates asking for the sequence, pipeline and expert axes.
`_begin_reshard` refuses a legacy checkpoint and checks the move
against the budget's real template; the reshard ledger is the JAX
file, read by both packages' timeline and report. The supervised shrink
(two gloo processes, rank 1 killed at step 3 under ``max_restarts=0``,
the run shrinking to world 1 and converging with its `reshard_s`
bucket) runs as the ``elastic --smoke --device cpu`` gate, once, and is
asserted from its verdict.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import pytest

from ray_lightning_tpu.elastic import budget as jbudget
from ray_lightning_tpu.parallel import mesh as jmesh
from ray_lightning_tpu.resilience import supervisor as jsup
from ray_lightning_tpu_torch.elastic.budget import ElasticBudget
from ray_lightning_tpu_torch.elastic.reshard import ReshardError
from ray_lightning_tpu_torch.parallel import mesh as pmesh
from ray_lightning_tpu_torch.resilience import supervisor as psup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: template name -> axis sizes at world w (the port builds data, fsdp and
#: tensor; -1 is "all remaining")
TEMPLATES = {
    "data": lambda w: dict(data=w),
    "fsdp": lambda w: dict(fsdp=w),
    "data_x_tensor2": lambda w: dict(data=-1, tensor=2),
    "fsdp_x_tensor4": lambda w: dict(fsdp=-1, tensor=4),
    "data2_x_fsdp": lambda w: dict(data=2, fsdp=-1),
}


def _budgets(template, **kw):
    def spec(mod, w):
        return mod.MeshSpec(**TEMPLATES[template](w))

    return (ElasticBudget(spec_for=lambda w: spec(pmesh, w), **kw),
            jbudget.ElasticBudget(spec_for=lambda w: spec(jmesh, w), **kw))


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("knobs", [
    dict(), dict(min_world=2), dict(min_world=1, max_world=6),
    dict(divisible_by=4), dict(global_batch=48), dict(global_batch=64,
                                                      min_world=2),
], ids=["default", "min2", "max6", "div4", "gb48", "gb64_min2"])
def test_budget_ladder_equals_jax(template, knobs):
    mine, ref = _budgets(template, **knobs)
    for launch in (1, 2, 4, 8, 12):
        assert mine.legal_worlds(launch) == ref.legal_worlds(launch)
        for w in range(0, launch + 3):
            assert mine.legal(w, launch) == ref.legal(w, launch)
            assert mine.largest_legal(w, launch) == \
                ref.largest_legal(w, launch)
    for old, new in itertools.product((1, 2, 3, 4, 6, 8), repeat=2):
        assert mine.batch_plan(old, new) == ref.batch_plan(old, new)


def test_unported_axis_names_its_item():
    """A template that asks for seq, pipe or expert now builds: its
    ladder and batch plan equal the JAX budget's (the batch rides data
    and expert, not seq or pipe), and a world at which the template does
    not resolve is illegal, as in JAX."""
    for sizes in (dict(data=-1, seq=2), dict(data=-1, pipe=2),
                  dict(data=-1, expert=2)):
        mine = ElasticBudget(spec_for=lambda w: pmesh.MeshSpec(**sizes))
        ref = jbudget.ElasticBudget(
            spec_for=lambda w: jmesh.MeshSpec(**sizes))
        for launch in (2, 4, 8):
            assert mine.legal_worlds(launch) == ref.legal_worlds(launch)
            for w in range(0, launch + 3):
                assert mine.legal(w, launch) == ref.legal(w, launch)
        for old, new in itertools.product((2, 4, 8), repeat=2):
            assert mine.batch_plan(old, new) == ref.batch_plan(old, new)
        assert mine.legal(3, 8) is False


@pytest.fixture
def cap_env(monkeypatch):
    monkeypatch.delenv("RLT_CAPACITY", raising=False)
    monkeypatch.delenv("RLT_CAPACITY_FILE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("capacity", [None, 0, 1, 2, 3, 4, 16])
def test_elastic_decision_equals_jax(cap_env, capacity):
    if capacity is not None:
        cap_env.setenv("RLT_CAPACITY", str(capacity))
    for kw in (dict(), dict(min_world=2), dict(max_reshards=1),
               dict(divisible_by=2), dict(max_world=3)):
        mine = ElasticBudget(**kw)
        ref = jbudget.ElasticBudget(**kw)
        for world, launch, allowed, spent in itertools.product(
                (1, 2, 3, 4), (2, 4), (True, False), (0, 1, 2)):
            got = psup._elastic_decision(mine, world, launch, allowed,
                                         spent)
            assert got == jsup._elastic_decision(ref, world, launch,
                                                 allowed, spent)
            assert psup._elastic_target_world(
                mine, world, launch, allowed, spent) == got[0]


def test_refused_grow_names_the_oracle(cap_env, tmp_path):
    from ray_lightning_tpu_torch.autoscale.capacity import CapacityOracle

    p = tmp_path / "cap"
    p.write_text("1")
    b = ElasticBudget(oracle=CapacityOracle(probe_file=str(p)))
    target, refusal = psup._elastic_decision(b, 1, 4, True, 1)
    assert target is None
    assert refusal == {"reason": "grow_refused", "from_world": 1,
                       "resolved_max": 4, "capacity": 1,
                       "capacity_source": "file",
                       "capacity_detail": str(p)}
    p.write_text("4")
    assert psup._elastic_decision(b, 1, 4, True, 1) == (4, None)


def _meta_dir(tmp_path, name, meta):
    d = tmp_path / name
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(meta))
    return str(d)


def test_begin_reshard_checks_provenance_against_the_template(tmp_path):
    legacy = _meta_dir(tmp_path, "legacy", {"global_step": 3})
    stamped = _meta_dir(tmp_path, "stamped", {
        "global_step": 3, "mesh_spec": {"fsdp": 4},
        "topology": {"n_devices": 4}, "param_specs": {"w": ["fsdp"]}})
    bad = _meta_dir(tmp_path, "bad", {
        "mesh_spec": {"fsdp": 4}, "topology": {"n_devices": 3}})
    budget = ElasticBudget(spec_for=lambda w: pmesh.MeshSpec(fsdp=w))
    jb = jbudget.ElasticBudget(spec_for=lambda w: jmesh.MeshSpec(fsdp=w))
    cfg = psup.ResilienceConfig(str(tmp_path), elastic=budget)
    jcfg = jsup.ResilienceConfig(str(tmp_path), elastic=jb)
    with pytest.raises(ReshardError, match="no sharding provenance"):
        psup._begin_reshard(cfg, 4, 2, legacy, 1, None)
    with pytest.raises(ReshardError, match="provenance is invalid"):
        psup._begin_reshard(cfg, 4, 2, bad, 1, None)
    entry = psup._begin_reshard(cfg, 4, 2, stamped, 1, None)
    want = jsup._begin_reshard(jcfg, 4, 2, stamped, 1, None)
    assert abs(entry.pop("at") - want.pop("at")) < 60
    assert entry == want
    assert entry["from_mesh"] == {"fsdp": 4}
    assert entry["batch_plan"]["grad_accum_to_preserve"] == 2
    # the real template: a tensor=4 template cannot resolve at 2
    tp4 = psup.ResilienceConfig(str(tmp_path), elastic=ElasticBudget(
        spec_for=lambda w: pmesh.MeshSpec(data=-1, tensor=4)))
    with pytest.raises(ValueError):
        psup._begin_reshard(tp4, 4, 2, stamped, 1, None)
    # a scratch resume (no checkpoint yet) records no source mesh
    assert psup._begin_reshard(cfg, 4, 2, None, 1, None)["from_mesh"] \
        is None


def test_resilience_config_ships_no_ladder_to_the_workers(tmp_path):
    """The budget stays with the driver: the workers' trainer factory
    gets the config without it (its mesh template may be a lambda,
    which the standard pickle refuses)."""
    import pickle

    cfg = psup.ResilienceConfig(str(tmp_path), elastic=ElasticBudget(
        spec_for=lambda w: pmesh.MeshSpec(fsdp=w)))
    with pytest.raises(Exception):
        pickle.dumps(cfg)
    import dataclasses

    pickle.dumps(dataclasses.replace(cfg, elastic=None))


def test_final_world_skips_grow_refused():
    r = psup.SupervisedResult(
        result=None, restarts=1, preemptions=0, failures=[],
        reshards=[{"reason": "shrink", "from_world": 4, "to_world": 1},
                  {"reason": "grow_refused", "from_world": 1,
                   "resolved_max": 4, "capacity": 1,
                   "capacity_source": "env"}])
    assert r.final_world == 1
    assert psup.SupervisedResult(None, 0, 0, []).final_world is None
    assert [f.name for f in __import__("dataclasses").fields(
        psup.SupervisedResult)] == [
        f.name for f in __import__("dataclasses").fields(
            jsup.SupervisedResult)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_reshard_ledger_read_by_both_timelines_and_reports(tmp_path,
                                                          writer):
    """``reshards.jsonl`` with its clock-alignment header, written by
    either package, merges into both packages' timelines and shows in
    the port's report."""
    from ray_lightning_tpu.telemetry import timeline as jtl
    from ray_lightning_tpu_torch.telemetry import report as prep
    from ray_lightning_tpu_torch.telemetry import timeline as ptl

    mod = jsup if writer == "jax" else psup
    assert mod.RESHARD_LEDGER == psup.RESHARD_LEDGER == "reshards.jsonl"
    assert mod.RESHARD_LEDGER_VERSION == psup.RESHARD_LEDGER_VERSION
    now = time.time()
    mod._append_reshard_ledger(str(tmp_path), {
        "from_world": 2, "to_world": 1, "reason": "shrink", "attempt": 1,
        "at": now})
    mod._append_reshard_ledger(str(tmp_path), {
        "reason": "grow_refused", "from_world": 1, "resolved_max": 2,
        "capacity": 1, "capacity_source": "file", "attempt": 2,
        "at": now + 1})
    lines = (tmp_path / "reshards.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["version"] == "rlt-reshards-v1"
    os.makedirs(tmp_path / "telemetry")
    mine = [e for e in ptl.load_timeline_events(str(tmp_path))["events"]
            if e.source == "reshard"]
    ref = [e for e in jtl.load_timeline_events(str(tmp_path))["events"]
           if e.source == "reshard"]
    assert [e.to_dict() for e in mine] == [e.to_dict() for e in ref]
    assert len(mine) == 2
    sec = prep.build_report(str(tmp_path))["reshards"]
    assert sec["changes"] == [{"from_world": 2, "to_world": 1,
                               "reason": "shrink", "attempt": 1}]
    assert sec["grow_refused"] == [{"from_world": 1, "resolved_max": 2,
                                    "capacity": 1,
                                    "capacity_source": "file",
                                    "attempt": 2}]
    assert sec["final_world"] == 1


# ---- the supervised shrink and the CLI gate ---------------------------------


@pytest.fixture(scope="module")
def elastic_smoke(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("elastic"))
    env = {**os.environ, "PYTHONPATH": ROOT}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "elastic",
         "--smoke", "--device", "cpu", "--json", "--timeout", "120",
         "--checkpoint-dir", base],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    return proc, time.perf_counter() - t0, base


def test_supervised_shrink_two_to_one_converges(elastic_smoke):
    """Rank 1 killed at step 3 under max_restarts=0: the same-size
    relaunch is refused, the budget shrinks the run to world 1 on the
    latest checkpoint (fsdp=2 -> one process), and it converges, with
    the `reshard_s` goodput bucket present and the ledger on disk."""
    proc, _, base = elastic_smoke
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    shrink = out["shrink"]
    assert shrink["ok"], shrink
    assert shrink["reshards"][0]["reason"] == "shrink"
    assert (shrink["reshards"][0]["from_world"],
            shrink["reshards"][0]["to_world"]) == (2, 1)
    assert shrink["reshards"][0]["from_mesh"] == {"fsdp": 2}
    assert shrink["final_world"] == 1
    assert shrink["val_accuracy"] > 0.8
    assert shrink["reshard_bucket_present"] and shrink["reshard_s"] > 0
    ledger = [json.loads(ln) for ln in open(
        os.path.join(base, "shrink", "reshards.jsonl"))]
    assert ledger[0]["version"] == "rlt-reshards-v1"
    assert [e["reason"] for e in ledger[1:]] == ["shrink"]


def test_elastic_smoke_cli(elastic_smoke):
    proc, seconds, _ = elastic_smoke
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True
    reshard = out["reshard"]
    assert reshard["bitwise_equal"] and reshard["leaves"] > 0
    assert reshard["move"]["changed_axes"] == ["fsdp"]
    assert seconds < 150
