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
    # item 12 brought elastic/: every top-level name resolves
    "": {"launch_cpu_spmd": "gloo", "simulate_cpu_devices": "JAX-only"},
    # item 2 brought core/text.py: every name resolves
    "core": {},
    # item 4 brought the planner (parallel/plan.py): every name resolves
    "parallel": {},
    "runtime": {"launch_cpu_spmd": "gloo"},
    # item 8's remainder brought the serving plan: every name resolves
    "serve": {},
    # item 13 (d) brought BERT, ResNet and hf_interop's BERT half, item
    # 13 (c) MoE: every name resolves
    "models": {},
    # item 13 (a)-(b): ring, Ulysses and the GPipe pipeline
    "ops": {},
    "pipeline": {},
    "sweep": {"TpuResources": "GpuResources"},
    "resilience": {},
    # item 12: elastic, autoscale and loadgen, every name
    "elastic": {},
    "autoscale": {},
    "loadgen": {},
    # item 13 (e) brought the framework-free analysis and the plan
    # checker, item 13 (f) tracecheck, numcheck and the cost model: every
    # name resolves
    "analysis": {},
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


def test_rest_of_serving_names_resolve():
    """Item 8's remainder: the byte plan, the draft config, the static
    serving plan and the autotune resolve from
    ``ray_lightning_tpu_torch.serve`` as their modules' objects."""
    from ray_lightning_tpu_torch import serve
    from ray_lightning_tpu_torch.serve import audit, engine, kv_cache, sweep

    for mod, names in ((kv_cache, ("serve_kv_plan_bytes", "pool_bytes",
                                   "validate_pool_tp")),
                       (engine, ("DraftConfig",)),
                       (audit, ("serve_memory_summary", "speculative_plan",
                                "shared_prefix_plan",
                                "format_serve_summary")),
                       (sweep, ("sweep_paged_kernels", "apply_autotune"))):
        for name in names:
            assert getattr(serve, name) is getattr(mod, name), name
            assert name in serve.__all__


def test_slice_13_names_resolve():
    """Item 2 and item 13 (d): `core/text.py`, BERT, ResNet and the BERT
    half of `hf_interop` resolve from their subpackages as the objects
    their modules define; so do item 13 (a)-(c)'s ring, Ulysses, GPipe
    and MoE names."""
    from ray_lightning_tpu_torch import core, models
    from ray_lightning_tpu_torch.core import text
    from ray_lightning_tpu_torch.models import bert, hf_interop, resnet

    for pkg, mod, names in (
            (core, text, ("chunk_tokens", "pack_sequences",
                          "tokenize_and_pack")),
            (models, bert, ("BertClassifierModule", "BertConfig",
                            "BertEncoder", "BertForSequenceClassification")),
            (models, resnet, ("ResNet", "ResNetModule", "resnet18",
                              "resnet34", "resnet50")),
            (models, hf_interop, ("bert_params_from_hf",
                                  "bert_classifier_params_from_hf"))):
        for name in names:
            assert getattr(pkg, name) is getattr(mod, name), name
            assert name in pkg.__all__
    from ray_lightning_tpu_torch import ops
    from ray_lightning_tpu_torch.models import moe

    # the modules (the package's names of the same spelling are functions)
    pipeline, ring_attention, ulysses = (
        importlib.import_module(f"ray_lightning_tpu_torch.ops.{m}")
        for m in ("pipeline", "ring_attention", "ulysses"))

    for pkg, mod, names in (
            (models, moe, ("MoEMLP", "MoEClassifierModule",
                           "moe_param_specs")),
            (ops, ring_attention, ("ring_attention",
                                   "ring_attention_local")),
            (ops, ulysses, ("ulysses_attention", "ulysses_attention_local")),
            (ops, pipeline, ("gpipe_apply", "pipeline_param_spec"))):
        for name in names:
            assert getattr(pkg, name) is getattr(mod, name), name
            assert name in pkg.__all__


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
    "ray_lightning_tpu_torch.pipeline", "ray_lightning_tpu_torch.runtime",
    "ray_lightning_tpu_torch.native", "ray_lightning_tpu_torch.analysis"])
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


def test_ring_attention_name_survives_its_submodule_import():
    """``ops.ring_attention`` is the function, as in JAX, also when the
    submodule of that name is imported first (the import system binds a
    submodule onto its package), in a fresh interpreter."""
    code = ("import ray_lightning_tpu_torch.ops.ring_attention, sys; "
            "from ray_lightning_tpu_torch import ops; "
            "m = sys.modules['ray_lightning_tpu_torch.ops.ring_attention']; "
            "print(ops.ring_attention is m.ring_attention)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"


def test_analysis_names_resolve_and_its_engines_import_light():
    """Items 13 (e)-(f): the analysis names resolve from
    ``ray_lightning_tpu_torch.analysis`` as their modules' objects (the
    graph walks' too); and the linter, threadcheck, the watcher, the CLI,
    the cost model and numcheck (``lint --numerics``) import neither
    torch nor numpy (nor JAX), in a fresh interpreter."""
    from ray_lightning_tpu_torch import analysis
    from ray_lightning_tpu_torch.analysis import (
        costmodel,
        findings,
        linter,
        numcheck,
        plan_checker,
        tracecheck,
    )

    for mod, names in ((findings, ("RULES", "SEVERITY_RANK", "Finding",
                                   "Rule", "max_severity", "meets")),
                       (linter, ("KNOWN_MESH_AXES", "TRACED_STEP_HOOKS",
                                 "lint_paths", "lint_source")),
                       (plan_checker, ("check_donation", "check_plan",
                                       "check_opt_state_dtypes",
                                       "check_param_specs",
                                       "spec_findings"))):
        for name in names:
            assert getattr(analysis, name) is getattr(mod, name), name
    for mod, names in ((numcheck, ("numcheck_jaxpr",
                                   "check_numerics_paths",
                                   "LOW_PRECISION_EXTENT")),
                       (tracecheck, ("classify_overlap", "audit_step",
                                     "trace_step")),
                       (costmodel, ("Topology", "parse_topology"))):
        for name in names:
            assert getattr(analysis, name) is getattr(mod, name), name
    code = ("import sys; sys.modules['jax'] = None; "
            "import ray_lightning_tpu_torch.analysis.linter, "
            "ray_lightning_tpu_torch.analysis.costmodel, "
            "ray_lightning_tpu_torch.analysis.numcheck, "
            "ray_lightning_tpu_torch.analysis.concurrency, "
            "ray_lightning_tpu_torch.analysis.lockwatch, "
            "ray_lightning_tpu_torch.analysis.cli; "
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if sys.modules.get(m) is not None))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
