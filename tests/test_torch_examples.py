"""The port's examples with ``--smoke-test --device cpu``, each in a
subprocess, as tests/test_examples.py runs the JAX ones.

`ray_lightning_tpu_torch.examples.llama_fsdp_example`: the tiny config, 4
steps on synthetic numpy tokens, once per knob of the Llama training
path (the bf16 first moment, each remat policy, the inline CE, tied
embeddings) and once across two gloo processes; each must end with a
finite loss after 4 steps, and its JSON line must say what ran.
``--pipe > 1`` is refused naming its ROADMAP item, ``--no-scan-layers``
is accepted and documented as changing nothing.
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


def _run(args, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", MODULE, *args], cwd=cwd,
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
    assert summary["world"] == (2 if "--fsdp" in args else 1)
    if summary["world"] == 1:
        assert summary["exp_avg_dtype"] == ("torch.bfloat16"
                                            if "--mu-bf16" in args
                                            else "torch.float32")
    assert summary["ce_inline_bwd"] == ("--ce-inline-bwd" in args)
    assert summary["tie_embeddings"] == ("--tie-embeddings" in args)


def test_llama_fsdp_example_refusals_and_help(tmp_path):
    out = _run(["--smoke-test", "--device", "cpu", "--pipe", "2"],
               str(tmp_path))
    assert out.returncode == 2 and "item 13 (b)" in out.stderr
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
