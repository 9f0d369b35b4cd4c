"""The serve decode-step audit (`ray_lightning_tpu_torch/serve/audit.py`
`trace_decode_step`, `audit_decode_step`): the engine's own step on fake
tensors, both lanes, held against the JAX audit's verdicts on the same
shapes (the audit cases of `tests/test_paged_attention.py` and
`test_paged_prefill.py`): the kernel lanes run the ``rltt`` paged decode,
paged prefill and RMSNorm operators and gather no dense view; the
reference lanes' views flag RLT307 and RLT308 where the kernels' gates
take the shape, and are sanctioned where they do not."""
import jax.numpy as jnp
import pytest
import torch

from ray_lightning_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_lightning_tpu.serve.audit import (
    audit_decode_step as jaudit_decode_step,
)
from ray_lightning_tpu.serve.engine import EngineConfig as JEngineConfig
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.serve.audit import (
    audit_decode_step,
    trace_decode_step,
)
from ray_lightning_tpu_torch.serve.engine import EngineConfig

#: the JAX suite's kernel-tiling tiny model (head_dim 64, GQA 2:1)
TINY = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
            hidden_dim=256, max_seq_len=128)
ENGINE = dict(capacity=4, block_size=8, blocks_per_slot=4, prefill_chunk=4)


def _rules(rep):
    return {f.rule for f in rep.findings} & {"RLT301", "RLT303", "RLT307",
                                             "RLT308"}


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_both_lanes_against_the_jax_audit(prefill_batch):
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    ecfg = EngineConfig(**ENGINE, prefill_batch=prefill_batch)
    ref = audit_decode_step(cfg, ecfg, fused=False)
    ker = audit_decode_step(cfg, ecfg, fused=True)
    assert _rules(ref) == {"RLT307", "RLT308"}
    assert _rules(ker) == set()
    assert set(ker.kernels) >= {"rltt.paged_decode", "rltt.paged_prefill",
                                "rltt.rms_norm"}
    assert "rltt.paged_decode" not in ref.kernels
    jcfg = JLlamaConfig(**TINY, remat=False, dtype=jnp.float32)
    jecfg = JEngineConfig(**ENGINE, prefill_batch=prefill_batch)
    jref = jaudit_decode_step(jcfg, jecfg, fused=False)
    jker = jaudit_decode_step(jcfg, jecfg, fused=True)
    # the intent of the JAX audit (two of its cases are red on this
    # jax): the reference lane's views are flagged, the kernel lane is
    # clean of them
    assert _rules(ref) >= _rules(jref) & {"RLT307", "RLT308"}
    assert not _rules(jker) & {"RLT307", "RLT308"}
    # the kernel lane holds no dense view: its peak is the lower
    assert ker.peak_hbm_bytes < ref.peak_hbm_bytes
    assert ker.precision["kv_pool"] == ref.precision["kv_pool"]


def test_views_are_the_engines_and_the_gates_decide():
    """The evidence is the engine's own gathers ([L, C, M, P, Hkv, hd] on
    the decode tick, [L, B, M, ...] on the prefill tick); a shape the
    kernels do not take (head_dim 16) keeps the views unflagged."""
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    ecfg = EngineConfig(**ENGINE, prefill_batch=2)
    (dec, pre), meta = trace_decode_step(cfg, ecfg, fused=False)
    L, M, P = cfg.n_layers, ecfg.blocks_per_slot, ecfg.block_size
    assert meta["dense_paged_gathers"][0] == (L, 4, M, P, 1, 64)
    assert meta["prefill_paged_gathers"][0] == (L, 2, M, P, 1, 64)
    _, kmeta = trace_decode_step(cfg, ecfg, fused=True)
    assert not kmeta["dense_paged_gathers"]
    assert not kmeta["prefill_paged_gathers"]
    small = LlamaConfig.tiny(dtype=torch.float32)  # head_dim 16
    rep = audit_decode_step(small, EngineConfig(capacity=4, block_size=4,
                                                blocks_per_slot=8,
                                                prefill_chunk=4),
                            fused=False)
    assert not _rules(rep)


def test_tensor_parallel_rank_prices_its_all_reduces():
    """``tp=2``: rank 0 of a tensor-parallel replica over a fake group of
    two: the row-parallel all-reduces a tick are recorded over
    ``tensor`` and the kernel lane still runs the paged operators."""
    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=256, max_seq_len=128,
                      dtype=torch.float32)
    rep = audit_decode_step(cfg, EngineConfig(**ENGINE), fused=True, tp=2,
                            topology="h100-2")
    ar = [e for e in rep.collectives if e.kind == "all_reduce"]
    assert ar and all(e.axes == ("tensor",) for e in ar)
    assert rep.mesh_axes == {"tensor": 2}
    assert set(rep.kernels) >= {"rltt.paged_decode", "rltt.paged_prefill"}
    assert not _rules(rep)


def test_tiny_budget_flags_rlt302():
    from ray_lightning_tpu_torch.analysis.costmodel import parse_topology

    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    rep = audit_decode_step(cfg, EngineConfig(**ENGINE), fused=True,
                            topology=parse_topology("cpu-1",
                                                    hbm_bytes=4096))
    assert "RLT302" in {f.rule for f in rep.findings}
