"""``python -m ray_lightning_tpu_torch trace`` (`analysis/cli.py`
`run_trace`): the flagship traced once at full width (Llama-3-8B, 32
layers, FSDP over ``h100-8``, one 8192-token row a GPU) with JAX blocked:
its JSON lists, per FSDP unit, one all-gather in the forward, one in the
backward and one reduce-scatter, the kernel operators it ran, and
parameter and optimizer bytes equal to `plan_train_memory`'s; exit 2 on
an unknown target or topology; RLT306 on ``2xh100-8`` with fsdp across
the nodes (a tiny model through a ``pkg.mod:factory`` target).

Held against the JAX CLI: an unknown target exits 2 with an error in
both (JAX's `test_trace_cli_unknown_target_exits_2`); the examples'
audits are held in `test_torch_trace_examples.py`. JAX's flagship tests
(`test_llama_fsdp_v5p64_hbm_estimate_sane`, `test_trace_cli_json_llama`)
are red on this CPU; `test_flagship_trace_json_without_jax` holds the
port to their intent: the ZeRO schedule, bytes and peak within the
card's memory."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_fsdp_across():
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    return (LlamaModule(LlamaConfig.tiny(n_layers=1)),
            ShardedMesh(fsdp=16, device="cpu"),
            {"tokens": np.zeros((16, 65), np.int64)}, "tiny fsdp=16")


def test_flagship_trace_json_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "from ray_lightning_tpu_torch.__main__ import main; "
            "sys.exit(main(['trace', 'llama3-8b', '--topo', 'h100-8', "
            "'--json']))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["topology"]["name"] == "h100-8"
    assert rep["mesh"] == {"fsdp": 8}
    for i in range(32):
        mine = [c for c in rep["collectives"]
                if c["param_path"] == f"params/layers.{i}"]
        kinds = sorted((c["kind"], c["count"]) for c in mine)
        assert kinds == [("all_gather", 1), ("all_gather", 1),
                         ("reduce_scatter", 1)], (i, kinds)
    totals = rep["totals_by_kind"]
    assert totals["all_gather"]["count"] == 65
    assert totals["reduce_scatter"]["count"] == 33
    assert set(rep["kernels"]) == {"rltt.flash_fwd", "rltt.flash_bwd_dkv",
                                   "rltt.flash_bwd_dq", "rltt.rms_norm"}
    assert rep["kernels"]["rltt.flash_fwd"] == 64  # forward + recompute
    assert {f["rule"] for f in rep["findings"]} == {"RLT305"}
    from ray_lightning_tpu_torch.analysis.cli import TRACE_BUILDERS
    from ray_lightning_tpu_torch.analysis.costmodel import parse_topology
    from ray_lightning_tpu_torch.parallel.plan import plan_train_memory

    module, strategy, batch, _ = TRACE_BUILDERS["llama3-8b"](
        parse_topology("h100-8"))
    plan = plan_train_memory(module, strategy, 8, batch)
    assert rep["params_bytes_per_device"] == plan.params_bytes_per_device
    assert rep["opt_bytes_per_device"] == plan.opt_bytes_per_device
    assert rep["peak_hbm_bytes"] <= rep["hbm_budget_bytes"]


@pytest.mark.parametrize("argv,msg", [
    (["trace", "no_such_example.py"], "unknown trace target"),
    (["trace", "llama3-8b", "--topo", "v5p-8"], "unknown topology family"),
    (["trace", "llama3-8b", "--topo", "h100-16"], "at most 8"),
])
def test_invalid_invocations_exit_2(argv, msg, capsys):
    from ray_lightning_tpu_torch.__main__ import main

    assert main([*argv, "--json"]) == 2
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert msg in out["error"]


def test_fsdp_across_nodes_flags_rlt306(capsys):
    from ray_lightning_tpu_torch.__main__ import main

    target = f"{__name__}:tiny_fsdp_across"
    rc = main(["trace", target, "--topo", "2xh100-8", "--json",
               "--fail-on", "warning", "--disable", "RLT305",
               "--no-numerics"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not rep["ok"]
    assert "RLT306" in {f["rule"] for f in rep["findings"]}
    assert rep["topology"]["n_slices"] == 2
    # --disable drops the rule and the gate opens
    assert main(["trace", target, "--topo", "2xh100-8", "--json",
                 "--fail-on", "warning", "--disable", "RLT306,RLT305",
                 "--no-numerics"]) == 0
    capsys.readouterr()


def test_text_report_names_kernels_and_schedule(capsys):
    from ray_lightning_tpu_torch.__main__ import main

    assert main(["trace", "llama_fsdp_example.py", "--topo",
                 "cpu-2", "--overlap", "on"]) == 0
    text = capsys.readouterr().out
    assert "kernels: rltt.rms_norm" in text
    assert "prefetch schedule detected" in text
    assert "peak memory estimate" in text


def test_unknown_target_exits_2_as_jax(capsys):
    from ray_lightning_tpu.__main__ import main as jax_main
    from ray_lightning_tpu_torch.__main__ import main

    for entry in (jax_main, main):
        assert entry(["trace", "no_such_example.py", "--json"]) == 2
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "unknown trace target" in out["error"]
