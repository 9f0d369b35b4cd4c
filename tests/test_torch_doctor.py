"""``python -m ray_lightning_tpu_torch`` with no subcommand: the doctor
(twin of tests/test_doctor.py's topology cases). The bare command exits
0 and prints the process's topology; ``--json`` prints the same dict;
``--device cpu`` lists no CUDA device; the rank, world size and local
rank come from the environment; each CUDA device is listed with its
index, name, memory and compute capability (a stand-in card here)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import torch

from ray_lightning_tpu_torch import __main__ as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, env=None):
    env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    return subprocess.run([sys.executable, "-m", "ray_lightning_tpu_torch",
                           *args], capture_output=True, text=True,
                          timeout=120, env=env, cwd=ROOT)


def test_bare_command_exits_0_and_prints_topology():
    out = _run()
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ray_lightning_tpu_torch" in out.stdout
    assert f"torch {torch.__version__}" in out.stdout
    assert "rank 0/1" in out.stdout
    if not torch.cuda.is_available():
        assert "no CUDA device" in out.stdout


def test_json_parses_and_reads_the_environment():
    out = _run("--json", "--device", "cpu",
               env={"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["package"].startswith("ray_lightning_tpu_torch ")
    assert info["torch"] == torch.__version__
    assert (info["rank"], info["world_size"], info["local_rank"]) == (1, 2, 1)
    assert info["device_count"] == 0 and info["devices"] == []
    assert "matmul_tflops" not in info


def test_collect_lists_each_cuda_device(monkeypatch, capsys):
    """Each visible device with its index, name, memory and capability,
    in the dict and in the printed view."""
    card = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                 total_memory=85 * 2**30, major=9, minor=0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: card)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    info = cli.collect()
    assert info["device_count"] == 2
    assert info["devices"][1] == {
        "index": 1, "name": "NVIDIA H100 80GB HBM3",
        "total_memory_bytes": 85 * 2**30, "total_memory_gib": 85.0,
        "capability": "9.0"}
    assert info["cuda_visible_devices"] == "2,3"
    assert cli.main([]) == 0
    text = capsys.readouterr().out
    assert "[1] NVIDIA H100 80GB HBM3  85.0 GiB  sm_90" in text
    assert "CUDA_VISIBLE_DEVICES=2,3" in text
    # --device cpu lists none, whatever the machine has
    assert cli.collect(device="cpu")["devices"] == []


def test_probe_adds_the_matmul_rate(capsys):
    assert cli.main(["--probe", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "no CUDA device" in text and "probe: cpu:" in text
    assert cli.main(["--probe", "--device", "cpu", "--json"]) == 0
    info = json.loads(capsys.readouterr().out.strip())
    assert info["matmul_tflops"] > 0 and info["devices"] == []
