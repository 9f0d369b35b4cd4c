"""The port's examples with ``--smoke-test --device cpu``, each in a
subprocess, as tests/test_examples.py runs the JAX ones.

`ray_lightning_tpu_torch.examples.llama_fsdp_example`: the tiny config, 4
steps on synthetic numpy tokens, once per knob of the Llama training
path (the bf16 first moment, each remat policy, the inline CE, tied
embeddings) and once across two gloo processes; each must end with a
finite loss after 4 steps, and its JSON line must say what ran.
``--pipe 2`` runs the GPipe path across two gloo processes (with
``--no-scan-layers`` it is refused, as in JAX), ``--no-scan-layers``
alone is accepted and documented as changing nothing.

The other five (`mnist_dp_example` also with ``--tune`` and across two
gloo processes, `mnist_sweep_example`, `pod_launch_example`,
`cifar_resnet_example --prefetch`, `bert_finetune_example`), each with
``--smoke-test --device cpu`` on its synthetic data, must print the
final line its JAX twin prints; the CIFAR one must say the native
batcher made its batches.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "ray_lightning_tpu_torch.examples.llama_fsdp_example"


def _run(args, cwd, timeout=240, module=MODULE):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


KNOBS = {
    "default": [],
    "mu_bf16": ["--mu-bf16"],
    "dots": ["--remat-policy", "dots"],
    "attn_out": ["--remat-policy", "attn_out", "--no-scan-layers"],
    "inline_ce": ["--ce-inline-bwd", "--fused-ce", "on"],
    "tied": ["--tie-embeddings", "--fused-ce", "on"],
    "no_remat": ["--no-remat"],
    "fsdp2_mu_bf16": ["--fsdp", "2", "--mu-bf16", "--remat-policy",
                      "attn_out"],
    "pipe2": ["--pipe", "2", "--microbatches", "2"],
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_llama_fsdp_example_smoke(knob, tmp_path):
    out = _run(["--smoke-test", "--device", "cpu", *KNOBS[knob]],
               str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 4 and np.isfinite(summary["loss"])
    assert out.stdout.strip().splitlines()[-2].startswith("mesh=")
    args = KNOBS[knob]
    assert summary["world"] == (2 if "--fsdp" in args or "--pipe" in args
                                else 1)
    assert summary["mesh"]["pipe"] == (2 if "--pipe" in args else 1)
    if summary["world"] == 1:
        assert summary["exp_avg_dtype"] == ("torch.bfloat16"
                                            if "--mu-bf16" in args
                                            else "torch.float32")
    assert summary["ce_inline_bwd"] == ("--ce-inline-bwd" in args)
    assert summary["tie_embeddings"] == ("--tie-embeddings" in args)


def test_llama_fsdp_example_refusals_and_help(tmp_path):
    out = _run(["--smoke-test", "--device", "cpu", "--pipe", "2",
                "--no-scan-layers"], str(tmp_path))
    assert out.returncode == 2 and "conflicts with --pipe" in out.stderr
    # the inline CE needs the fused CE, as in the JAX config
    out = _run(["--smoke-test", "--device", "cpu", "--ce-inline-bwd"],
               str(tmp_path))
    assert out.returncode != 0 and "fused CE" in out.stderr
    out = _run(["--help"], str(tmp_path))
    assert out.returncode == 0
    text = " ".join(out.stdout.split())
    assert "--no-scan-layers changes nothing" in text
    for flag in ("--mu-bf16", "--remat-policy", "--ce-inline-bwd",
                 "--tie-embeddings", "--device"):
        assert flag in text


#: example -> (extra flags, the final line's start)
EXAMPLES = {
    "mnist_dp": ("mnist_dp_example", [], "final val accuracy: "),
    "mnist_dp_tune": ("mnist_dp_example", ["--tune"],
                      "Best hyperparameters: "),
    "mnist_dp_two_workers": ("mnist_dp_example", ["--num-workers", "2"],
                             "final val accuracy: "),
    "mnist_sweep": ("mnist_sweep_example", [], None),
    "pod_launch": ("pod_launch_example", [], "pod launch round-trip OK"),
    "cifar_resnet_prefetch": ("cifar_resnet_example", ["--prefetch"],
                              "val_acc="),
    "bert_finetune": ("bert_finetune_example", [], "val_acc="),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_smoke(name, tmp_path):
    script, extra, last = EXAMPLES[name]
    out = _run(["--smoke-test", "--device", "cpu", *extra], str(tmp_path),
               timeout=180,
               module=f"ray_lightning_tpu_torch.examples.{script}")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    if name == "mnist_sweep":
        # the JAX example's lines, then a row per trial
        assert any(line.startswith("Best hyperparameters: ")
                   for line in lines)
        best = [line for line in lines if line.startswith(
            "Best checkpoint: ")]
        assert best and os.path.isdir(best[0].split(": ", 1)[1])
        assert sum(line.startswith("{'trial_id'") for line in lines) == 2
        return
    assert lines[-1].startswith(last), lines[-3:]
    if name.startswith("mnist_dp") and not name.endswith("tune"):
        assert float(lines[-1].split(": ")[1]) > 0.5
    if script in ("cifar_resnet_example", "bert_finetune_example"):
        summary = json.loads(lines[-2])
        assert np.isfinite(summary["loss"]) and summary["device"] == "cpu"
        if script == "cifar_resnet_example":
            # 7 batches an epoch, two epochs (and the fit's example batch)
            assert summary["steps"] == 14
            assert summary["native_batches"] >= 14


def test_examples_refuse_a_missing_card(tmp_path):
    """Without ``--device cpu`` on a machine with no card, each example
    says so instead of training somewhere else."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for script in ("mnist_dp_example", "cifar_resnet_example",
                   "bert_finetune_example", "mnist_sweep_example"):
        out = _run(["--smoke-test"], str(tmp_path),
                   module=f"ray_lightning_tpu_torch.examples.{script}")
        assert out.returncode == 2 and "--device cpu" in out.stderr, script
