"""The bundled examples' trace targets against the JAX package's (twin
of `tests/test_tracecheck_examples.py` `test_example_step_audits_clean`):
each example but the flagship, built by both packages'
``resolve_trace_target`` for the same topology, fires the same rule set
in both and nothing of RLT301 or RLT303. The flagship is traced once,
in `test_torch_trace_cli.py`."""
import pytest


EXAMPLES = ["bert_finetune_example.py", "cifar_resnet_example.py",
            "mnist_dp_example.py", "mnist_sweep_example.py",
            "pod_launch_example.py"]


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_rules_equal_jax(example):
    from ray_lightning_tpu.analysis import cli as jcli
    from ray_lightning_tpu.analysis import costmodel as jcm
    from ray_lightning_tpu.analysis import tracecheck as jtc
    from ray_lightning_tpu_torch.analysis.cli import resolve_trace_target
    from ray_lightning_tpu_torch.analysis.costmodel import parse_topology
    from ray_lightning_tpu_torch.analysis.tracecheck import audit_step

    rules = []
    for resolve, parse, audit in (
            (jcli.resolve_trace_target, jcm.parse_topology, jtc.audit_step),
            (resolve_trace_target, parse_topology, audit_step)):
        topo = parse("cpu-2")
        module, strategy, batch, label = resolve(example, topo)
        rep = audit(module, strategy, batch, topology=topo, label=label)
        rules.append({f.rule for f in rep.findings})
    assert rules[1] == rules[0]
    assert not rules[1] & {"RLT301", "RLT303"}
