"""The port's package surface against the JAX package's.

`ray_lightning_tpu_torch` mirrors ``ray_lightning_tpu.__all__`` name for
name, and each subpackage the public names of its JAX counterpart's
``__init__``, less a listed set: names that are JAX-only or wait for a
ROADMAP item, each of which raises `NotPortedError` (an AttributeError
and a NotImplementedError) naming its item or its reason. Importing the
package, in a fresh interpreter, imports neither torch nor JAX.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys

import pytest

import ray_lightning_tpu as jax_pkg
import ray_lightning_tpu_torch as rlt
from ray_lightning_tpu_torch._lazy import NotPortedError

#: the JAX names the port leaves out, with what their error must name
ITEM = {
    "": {"launch_cpu_spmd": "gloo", "simulate_cpu_devices": "JAX-only",
         "elastic": "item 12", "ElasticBudget": "item 12",
         "reshard_restore": "item 12"},
    "core": {n: "item 2" for n in (
        "chunk_tokens", "pack_sequences", "tokenize_and_pack")},
    # item 4 brought the planner (parallel/plan.py): every name resolves
    "parallel": {},
    "runtime": {"launch_cpu_spmd": "gloo"},
    "serve": {"serve_kv_plan_bytes": "item 8"},
    "models": {**{n: "item 13" for n in (
        "BertClassifierModule", "BertConfig", "BertEncoder",
        "BertForSequenceClassification", "bert_classifier_params_from_hf",
        "bert_params_from_hf", "MoEClassifierModule", "MoEMLP",
        "moe_param_specs", "ResNet", "ResNetModule", "resnet18",
        "resnet34", "resnet50")},
        "llama_params_from_hf": "item 3"},
    "ops": {n: "item 13" for n in (
        "ulysses_attention", "ulysses_attention_local", "ring_attention",
        "ring_attention_local", "gpipe_apply", "pipeline_param_spec")},
    "pipeline": {},
    "sweep": {"TpuResources": "GpuResources"},
    "resilience": {},
}


def _pair(sub):
    jmod = importlib.import_module(
        "ray_lightning_tpu" + (f".{sub}" if sub else ""))
    pmod = importlib.import_module(
        "ray_lightning_tpu_torch" + (f".{sub}" if sub else ""))
    return jmod, pmod


@pytest.mark.parametrize("sub", list(ITEM))
def test_every_jax_name_resolves_or_names_its_item(sub):
    jmod, pmod = _pair(sub)
    missing = ITEM[sub]
    for name in jmod.__all__:
        if name in missing:
            with pytest.raises(NotImplementedError, match=missing[name]):
                getattr(pmod, name)
            assert not hasattr(pmod, name)
            assert name not in pmod.__all__
        else:
            assert getattr(pmod, name) is not None, name
            assert name in pmod.__all__ or name == "__version__", name
    # nothing listed that the JAX package does not have
    assert set(missing) <= set(jmod.__all__)


def test_serving_front_end_names_resolve():
    """The serving front end ported with item 8: the driver, its params
    file, its rollups and the request channel resolve from
    ``ray_lightning_tpu_torch.serve``, and `generate` / `init_cache`
    from ``models``, as the objects their modules define."""
    from ray_lightning_tpu_torch import models, serve
    from ray_lightning_tpu_torch.models import llama
    from ray_lightning_tpu_torch.serve import channel, driver

    for name in ("ServeDriver", "ReplicaGroupConfig", "ServeResult",
                 "save_params_npz", "load_params_npz",
                 "aggregate_serve_metrics", "load_signal"):
        assert getattr(serve, name) is getattr(driver, name), name
        assert name in serve.__all__
    for name in ("ChannelWriter", "ChannelReader", "CursorWriter",
                 "CursorReader", "request_to_wire", "request_from_wire"):
        assert getattr(serve, name) is getattr(channel, name), name
    assert models.generate is llama.generate
    assert models.init_cache is llama.init_cache


def test_top_level_names_are_the_subpackages_objects():
    """The top level re-exports, it does not copy: the same objects as
    the modules that define them, the subpackages themselves for
    ``sweep``, ``pipeline`` and ``telemetry``."""
    from ray_lightning_tpu_torch import pipeline, sweep, telemetry
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import FSDP
    from ray_lightning_tpu_torch.pipeline.prefetch import DevicePrefetcher
    from ray_lightning_tpu_torch.runtime.group import WorkerGroup

    assert rlt.Trainer is Trainer and rlt.FSDP is FSDP
    assert rlt.WorkerGroup is WorkerGroup
    assert rlt.DevicePrefetcher is DevicePrefetcher
    assert (rlt.sweep, rlt.pipeline, rlt.telemetry) == (sweep, pipeline,
                                                        telemetry)
    assert rlt.__version__ == jax_pkg.__version__
    assert rlt.core.Trainer is Trainer and rlt.parallel.FSDP is FSDP
    with pytest.raises(AttributeError, match="no attribute"):
        rlt.not_a_name
    assert issubclass(NotPortedError, AttributeError)
    assert set(dir(rlt)) >= set(rlt.__all__)


def test_a_script_switches_packages_with_its_import():
    """The README's script against the port: the same names build a
    FSDP trainer (on the CPU here)."""
    t = rlt.Trainer(strategy=rlt.FSDP(device="cpu"), max_steps=1,
                    callbacks=[rlt.ModelCheckpoint(dirpath=None)],
                    enable_progress_bar=False)
    assert isinstance(t.strategy, rlt.Strategy)
    assert isinstance(rlt.sweep.GpuResources(), rlt.sweep.GpuResources)
    assert rlt.pipeline.plan_cache_dir("/x", "a") == \
        jax_pkg.pipeline.plan_cache_dir("/x", "a")


@pytest.mark.parametrize("module", [
    "ray_lightning_tpu_torch", "ray_lightning_tpu_torch.core",
    "ray_lightning_tpu_torch.parallel", "ray_lightning_tpu_torch.models",
    "ray_lightning_tpu_torch.ops", "ray_lightning_tpu_torch.serve",
    "ray_lightning_tpu_torch.pipeline", "ray_lightning_tpu_torch.runtime"])
def test_import_loads_no_torch_and_no_jax(module):
    code = (f"import sys, {module}, ray_lightning_tpu_torch as r; "
            "r.__all__; "
            "print(sorted(m for m in ('torch', 'jax', 'flax', 'optax', "
            "'ray_lightning_tpu') if m in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
