"""tracecheck (`ray_lightning_tpu_torch/analysis/tracecheck.py`): the
trainer's own step on fake tensors over a fake process group.

Held against the JAX package (`test_rule_verdicts_equal_jax`): the same
model, mesh, batch and budget go through JAX's `audit_step` and the
port's, and both must fire the same rule set, case for case with the
JAX tests that pass on this CPU: `test_hbm_overcommit_flagged_on_tiny_
budget` (RLT302), `test_fsdp_weight_gathers_and_grad_reduce_scatters`,
`test_report_to_dict_roundtrips_json`, `test_tracecheck_dcn.py`'s
`test_fsdp_across_slices_flags_rlt306`, `test_hsdp_placement_keeps_fsdp_
on_ici` and `test_single_slice_reports_zero_dcn` (on JAX's own
``2xcpu-2`` and ``cpu-4``), and `test_overlap.py`'s `test_on_is_
scheduled_and_hides` (the prefetch schedule detected, nothing flagged);
and two steps no JAX test audits, BERT under ``tensor=2`` (RLT803, the
GELU's round trip, as on one card) and the MoE bank under ``expert=2 x
tensor=2`` (nothing flagged).

The JAX tests that are red on this CPU, and what holds the port to
their intent instead:

  * `test_dp_gradient_psums_detected` (JAX finds no psum) —
    `test_dp_gradient_all_reduce_recorded`;
  * `test_correct_tensor_plan_is_clean` (no psum) —
    `test_tensor_axis_all_reduce_recorded_and_clean`;
  * `test_dropped_output_spec_flags_reshard_implicit` (nothing flagged)
    — the port's test of that name, on a tensor plan that leaves its
    output sharded;
  * `test_data_across_slices_audits_clean_with_dcn_bytes` (no
    cross-slice bytes) — the ``dp-across-slices`` case: the same rule
    set, and the port's gradient all-reduce itemizes InfiniBand bytes;
  * `test_overlap.py` `test_off_flags_rlt305` (nothing flagged) —
    `test_exposed_gathers_off_against_on`.

`test_broken_ring_flags_deadlock` has no twin step: the port's shifts
(`parallel.comm`) are ``rank + 1`` rotations by construction, so no
step can issue JAX's two-cycle ``ppermute``. `check_permutation` gives
JAX's verdicts on the same permutations (`test_torch_costmodel.py`) and
RLT303 is traced across pipeline stages
(`test_pipeline_stages_pair_their_shifts`).

The port's own checks: the FSDP schedule counted, the traced parameter
and optimizer bytes equal to the byte to `plan_train_memory`'s terms,
RLT305 off against on, RLT306 on ``2xh100-8``, the ring's blocks traced
as the flash operators, and a live real process group refused."""
import numpy as np
import pytest
import torch
from torch import nn

from ray_lightning_tpu.analysis import costmodel as jcm
from ray_lightning_tpu.analysis import tracecheck as jtc
from ray_lightning_tpu.models import bert as jbert
from ray_lightning_tpu.models import llama as jllama
from ray_lightning_tpu.models import mlp as jmlp
from ray_lightning_tpu.models import moe as jmoe
from ray_lightning_tpu.parallel import strategy as js
from ray_lightning_tpu_torch.analysis.costmodel import (
    parse_topology,
    topology_for_kind,
)
from ray_lightning_tpu_torch.analysis.tracecheck import (
    audit_step,
    trace_step,
)
from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.models.bert import BertClassifierModule, BertConfig
from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
from ray_lightning_tpu_torch.models.mlp import MLPClassifier
from ray_lightning_tpu_torch.models.moe import MoEClassifierModule
from ray_lightning_tpu_torch.parallel.plan import plan_train_memory
from ray_lightning_tpu_torch.parallel.strategy import (
    FSDP,
    DataParallel,
    ShardedMesh,
    SingleDevice,
)

CPU = dict(device="cpu")


def _tokens(rows, seq=64):
    return {"tokens": np.zeros((rows, seq + 1), np.int64)}


def _mlp_batch(b=32):
    return {"x": np.zeros((b, 784), np.float32),
            "y": np.zeros((b,), np.int64)}


@pytest.mark.parametrize("n_layers,world", [(2, 8), (3, 2)])
def test_fsdp_gathers_reduce_scatters_and_plan_bytes(n_layers, world):
    """Per FSDP unit one all-gather in the forward, one more in the
    backward (the unit is resharded after its forward; the root is not)
    and one reduce-scatter; the traced parameter and optimizer bytes are
    `plan_train_memory`'s, byte for byte."""
    cfg = LlamaConfig.tiny(n_layers=n_layers)
    rep = audit_step(LlamaModule(cfg), FSDP(**CPU), _tokens(2 * world),
                     topology=f"cpu-{world}")
    ag = [e for e in rep.collectives if e.kind == "all_gather"]
    rs = [e for e in rep.collectives if e.kind == "reduce_scatter"]
    assert sum(e.count for e in ag) == 2 * n_layers + 1
    assert sum(e.count for e in rs) == n_layers + 1
    assert all(e.axes == ("fsdp",) and e.prefetchable for e in ag + rs)
    for i in range(n_layers):
        mine = [e for e in ag if e.param_path == f"params/layers.{i}"]
        assert sum(e.count for e in mine) == 2
    plan = plan_train_memory(LlamaModule(cfg), FSDP(**CPU), world,
                             _tokens(2 * world))
    assert rep.params_bytes_per_device == plan.params_bytes_per_device
    assert rep.opt_bytes_per_device == plan.opt_bytes_per_device
    assert {"rltt.flash_fwd", "rltt.flash_bwd_dkv", "rltt.flash_bwd_dq",
            "rltt.rms_norm"} <= set(rep.kernels)
    assert rep.peak_hbm_bytes >= (rep.params_bytes_per_device
                                  + rep.opt_bytes_per_device)
    assert rep.flops > 0 and rep.step_us > 0


def test_dp_gradient_all_reduce_recorded():
    """The intent of JAX's red `test_dp_gradient_psums_detected`: the DDP
    bucket all-reduce of the gradients is recorded over ``data``, the
    [784, 128] f32 kernel's gradient inside it."""
    rep = audit_step(MLPClassifier(features=(128,), num_classes=10,
                                   in_features=784), DataParallel(**CPU),
                     _mlp_batch(), topology="cpu-8", label="mlp")
    assert not [f for f in rep.findings if f.severity == "error"]
    ar = [e for e in rep.collectives if e.kind == "all_reduce"]
    assert ar and all(e.axes == ("data",) for e in ar)
    assert max(e.payload_bytes for e in ar) >= 784 * 128 * 4
    assert rep.ici_bytes_per_step > 0 and rep.fits


def test_tensor_axis_all_reduce_recorded_and_clean():
    """The intent of JAX's red `test_correct_tensor_plan_is_clean`: the
    Megatron plan's row-parallel all-reduces are recorded over
    ``tensor`` (explicit: `parallel.tensor` issues them) and nothing is
    flagged."""
    cfg = LlamaConfig.tiny(n_layers=2)
    rep = audit_step(LlamaModule(cfg), ShardedMesh(fsdp=2, tensor=2, **CPU),
                     _tokens(4), topology="cpu-4", label="tp-ok")
    assert rep.findings == [] or {f.rule for f in rep.findings} == {
        "RLT305"}
    tp = [e for e in rep.collectives if e.kind == "all_reduce"
          and "tensor" in e.axes]
    assert tp and not any(e.implicit for e in tp)
    # FSDP2 over the 2-D mesh's fsdp axis gathers and reduces too
    assert {e.kind for e in rep.collectives if e.axes == ("fsdp",)} >= {
        "all_gather", "reduce_scatter"}
    plan = plan_train_memory(LlamaModule(cfg),
                             ShardedMesh(fsdp=2, tensor=2, **CPU), 4,
                             _tokens(4))
    assert rep.params_bytes_per_device == plan.params_bytes_per_device
    assert rep.opt_bytes_per_device == plan.opt_bytes_per_device


class _TPNet(nn.Sequential):
    def enable_tensor_parallel(self, tp) -> None:
        self.tp = tp


class _TPModule(TpuModule):
    """Two linears under the tensor axis; ``drop`` leaves the first
    one's output sharded for DTensor to gather (the plan's output spec
    dropped), the other form keeps a replicated output."""

    def __init__(self, drop: bool):
        super().__init__()
        self.drop = drop

    def configure_model(self):
        return _TPNet(nn.Linear(256, 512, bias=False, device=self.device),
                      nn.Linear(512, 8, bias=False, device=self.device))

    def param_specs(self, params=None):
        return {"0.weight": ("tensor", None) if self.drop else (None, None),
                "1.weight": (None, None)}

    def check_tensor_parallel(self, tensor: int) -> None:
        pass

    @torch.no_grad()
    def init_params(self, generator, batch=None, place=None):
        for name, p in self.model.named_parameters():
            full = torch.zeros(p.shape, device=generator.device)
            if place is not None:
                place(name, p, full)
        return dict(self.model.named_parameters())

    def configure_optimizers(self):
        return torch.optim.SGD(self.model.parameters(), lr=0.1)

    def training_step(self, params, batch, rng):
        from torch.distributed.tensor import DTensor, Replicate

        w0 = self.model[0].weight
        x = batch["x"]
        if isinstance(w0, DTensor):
            x = DTensor.from_local(x, w0.device_mesh,
                                   [Replicate()] * w0.device_mesh.ndim)
        h = torch.nn.functional.linear(x, w0)
        out = torch.nn.functional.linear(h, self.model[1].weight)
        loss = out.float().pow(2).mean()
        return loss.full_tensor() if isinstance(loss, DTensor) else loss


def test_dropped_output_spec_flags_reshard_implicit():
    rep = audit_step(_TPModule(True), ShardedMesh(tensor=2, **CPU),
                     {"x": np.zeros((32, 256), np.float32)},
                     topology="cpu-2", label="tp-bad")
    assert any(f.rule == "RLT301" for f in rep.findings), rep.summary()
    assert any(e.implicit and e.param_path is None
               for e in rep.collectives)


def test_hbm_overcommit_flagged_on_tiny_budget():
    topo = parse_topology("cpu-4", hbm_bytes=1024**2)  # 1 MiB devices
    rep = audit_step(MLPClassifier(features=(512, 512), num_classes=10,
                                   in_features=784), DataParallel(**CPU),
                     _mlp_batch(), topology=topo, label="mlp-tiny-hbm")
    assert any(f.rule == "RLT302" for f in rep.findings)
    assert not rep.fits


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_exposed_gathers_off_against_on(overlap):
    """RLT305 reads the stream's order: under "off" each unit's forward
    all-gather is issued by its own pre-forward hook; under "on" the unit
    before it prefetches it, the schedule is detected and nothing is
    flagged."""
    rep = audit_step(LlamaModule(LlamaConfig.tiny(n_layers=3)),
                     FSDP(overlap=overlap, **CPU), _tokens(8),
                     topology="h100-4", numerics=False)
    flagged = [f for f in rep.findings if f.rule == "RLT305"]
    assert bool(rep.overlap["scheduled"]) == (overlap == "on")
    assert len(flagged) == (overlap == "off")
    if overlap == "off":
        assert "layers.0 .. layers.2 (3 units)" in flagged[0].message


@pytest.mark.parametrize("data,fsdp,flagged", [(1, 16, True),
                                               (2, 8, False)])
def test_fsdp_across_nodes_flags_rlt306(data, fsdp, flagged):
    """On ``2xh100-8`` an fsdp axis of 16 spans both nodes (RLT306); HSDP,
    data across the nodes and fsdp within one, is clean, with the
    gradient all-reduce's inter-node bytes itemized."""
    rep = audit_step(LlamaModule(LlamaConfig.tiny(n_layers=1)),
                     ShardedMesh(data=data, fsdp=fsdp, **CPU),
                     _tokens(16), topology="2xh100-8", numerics=False)
    assert any(f.rule == "RLT306" for f in rep.findings) == flagged
    if not flagged:
        assert rep.dcn_bytes_per_step > 0
        assert "InfiniBand total" in rep.summary()


def test_report_to_dict_is_json_and_wrappers():
    import json

    rep = FSDP(**CPU).audit_step(MLPClassifier(features=(64,),
                                               num_classes=4,
                                               in_features=784),
                                 _mlp_batch(16), topology="cpu-2")
    assert rep.label == "MLPClassifier FSDP"
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["params_bytes_per_device"] == rep.params_bytes_per_device
    rep2 = MLPClassifier(features=(64,), num_classes=4,
                         in_features=784).audit_step(
        DataParallel(**CPU), _mlp_batch(16), topology="cpu-2")
    assert rep2.mesh_axes == {"data": 2}
    assert "tracecheck" in rep2.summary()


def test_single_device_trace_is_the_kernel_lane_with_no_collectives():
    rec, meta = trace_step(LlamaModule(LlamaConfig.tiny(n_layers=1)),
                           SingleDevice(**CPU), 1, _tokens(2))
    names = {e.name for e in rec.events}
    assert {"rltt.flash_fwd", "rltt.flash_bwd_dkv", "rltt.flash_bwd_dq",
            "rltt.rms_norm"} <= names
    assert not [e for e in rec.events if e.kind is not None]
    # the optimizer's state exists after the traced step, on fake storage
    assert meta["named_opt"] and meta["named_params"]
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.backends.cuda.is_built():
            trace_step(LlamaModule(LlamaConfig.tiny(n_layers=1)),
                       SingleDevice(**CPU), 1, _tokens(2), device="cuda")
        else:
            raise RuntimeError("CUDA built: the CUDA form is phase 19's")


def test_pipeline_stages_pair_their_shifts(monkeypatch):
    """RLT303 under ``pipe=2``: each stage traced on its own rank, the
    activations' sends met by the next stage's receives and the
    gradients' the other way; a stage that misses a receive (planted in
    its recorded sequence) leaves a send unmatched."""
    from ray_lightning_tpu_torch.analysis import tracecheck as tc

    def audit():
        cfg = LlamaConfig.tiny(n_layers=2, pipeline_microbatches=2)
        return audit_step(LlamaModule(cfg), ShardedMesh(pipe=2, **CPU),
                          _tokens(4), topology="cpu-2", numerics=False)

    rep = audit()
    assert not [f for f in rep.findings if f.rule == "RLT303"]
    shifts = [e for e in rep.collectives if e.kind == "send_recv"]
    assert shifts and all(e.axes == ("pipe",) for e in shifts)
    real, calls = tc._shifts, []

    def lossy(rec):
        sends, recvs = real(rec)
        calls.append(rec)
        return (sends, recvs[1:]) if len(calls) == 2 else (sends, recvs)

    monkeypatch.setattr(tc, "_shifts", lossy)
    assert "RLT303" in {f.rule for f in audit().findings}


# ---- the same audit in both packages --------------------------------------


def _mlp_twin(features, num_classes, strategies, topo, rows, width=784,
              hbm_bytes=None):
    """(JAX, port) audit inputs of one MLP case: the same features,
    classes, batch and topology; ``strategies`` = (JAX, port)."""
    jtopo = jcm.parse_topology(topo, hbm_bytes=hbm_bytes)
    ptopo = parse_topology(topo, hbm_bytes=hbm_bytes)
    x = np.zeros((rows, width), np.float32)
    return ((jmlp.MLPClassifier(features=features, num_classes=num_classes),
             strategies[0], {"x": x, "y": np.zeros((rows,), np.int32)},
             jtopo),
            (MLPClassifier(features=features, num_classes=num_classes,
                           in_features=width),
             strategies[1], {"x": x, "y": np.zeros((rows,), np.int64)},
             ptopo))


_TINY = dict(dim=256, n_layers=4, n_heads=8, n_kv_heads=4, hidden_dim=1024,
             max_seq_len=512)

TWINS = {
    "hbm-tiny": lambda: _mlp_twin((512, 512), 10, (js.DataParallel(),
                                                   DataParallel(**CPU)),
                                  "cpu-4", 32, hbm_bytes=1024**2),
    "fsdp-gathers": lambda: _mlp_twin(
        (512,), 16, (js.ShardedMesh(fsdp=4), ShardedMesh(fsdp=4, **CPU)),
        "cpu-4", 16),
    "dp-report": lambda: _mlp_twin((16,), 4, (js.DataParallel(),
                                              DataParallel(**CPU)),
                                   "cpu-4", 16),
    "fsdp-across-slices": lambda: _mlp_twin(
        (32,), 4, (js.FSDP(min_shard_size=8),
                   FSDP(min_shard_size=8, **CPU)), "2xcpu-2", 16, width=8),
    "hsdp": lambda: _mlp_twin(
        (32,), 4, (js.ShardedMesh(data=2, fsdp=2, min_shard_size=8),
                   ShardedMesh(data=2, fsdp=2, min_shard_size=8, **CPU)),
        "2xcpu-2", 16, width=8),
    "single-slice": lambda: _mlp_twin((32,), 4, (js.DataParallel(),
                                                 DataParallel(**CPU)),
                                      "cpu-4", 16, width=8),
    "dp-across-slices": lambda: _mlp_twin((32,), 4, (js.DataParallel(),
                                                     DataParallel(**CPU)),
                                          "2xcpu-2", 16, width=8),
    "overlap-on": lambda: (
        (jllama.LlamaModule(jllama.LlamaConfig.tiny(use_flash=False,
                                                    **_TINY)),
         js.ShardedMesh(fsdp=8, overlap="on"),
         {"tokens": np.zeros((8, 513), np.int32)},
         jcm.topology_for_kind("TPU v5e", 8)),
        (LlamaModule(LlamaConfig.tiny(**_TINY)),
         ShardedMesh(fsdp=8, overlap="on", **CPU),
         {"tokens": np.zeros((8, 513), np.int64)},
         topology_for_kind("NVIDIA H100 80GB HBM3", 8))),
    "bert-tensor": lambda: (
        (jbert.BertClassifierModule(jbert.BertConfig.tiny(dropout=0.0),
                                    num_classes=2),
         js.ShardedMesh(tensor=2),
         {"input_ids": np.ones((8, 16), np.int32),
          "labels": np.zeros(8, np.int32)}, jcm.parse_topology("cpu-2")),
        (BertClassifierModule(BertConfig.tiny(dropout=0.0), num_classes=2),
         ShardedMesh(tensor=2, **CPU),
         {"input_ids": np.ones((8, 16), np.int64),
          "labels": np.zeros(8, np.int64)}, parse_topology("cpu-2"))),
    "moe-expert-tensor": lambda: (
        (jmoe.MoEClassifierModule(), js.ShardedMesh(expert=2, tensor=2),
         {"x": np.zeros((8, 16), np.float32), "y": np.zeros(8, np.int32)},
         jcm.parse_topology("cpu-4")),
        (MoEClassifierModule(in_features=16),
         ShardedMesh(expert=2, tensor=2, **CPU),
         {"x": np.zeros((8, 16), np.float32), "y": np.zeros(8, np.int64)},
         parse_topology("cpu-4"))),
}


@pytest.mark.parametrize("case", sorted(TWINS))
def test_rule_verdicts_equal_jax(case):
    (jm, jstrat, jbatch, jtopo), (pm, pstrat, pbatch, ptopo) = TWINS[case]()
    numerics = case != "overlap-on"
    theirs = jtc.audit_step(jm, jstrat, jbatch, topology=jtopo,
                            label=case, numerics=numerics)
    mine = audit_step(pm, pstrat, pbatch, topology=ptopo, label=case,
                      numerics=numerics)
    assert {f.rule for f in mine.findings} == {
        f.rule for f in theirs.findings}, (mine.summary(),
                                           theirs.summary())
    assert mine.fits == theirs.fits
    assert mine.topology.n_slices == theirs.topology.n_slices
    if case == "hbm-tiny":
        assert "RLT302" in {f.rule for f in mine.findings}
    elif case == "fsdp-gathers":
        for rep in (mine, theirs):
            assert ("all_gather", ("fsdp",)) in {
                (e.kind, e.axes) for e in rep.collectives}
    elif case == "dp-report":
        import json

        d = json.loads(json.dumps(mine.to_dict()))
        assert d["fits"] is theirs.to_dict()["fits"] is True
        assert d["topology"]["name"] == theirs.to_dict()[
            "topology"]["name"] == "cpu-4"
    elif case == "fsdp-across-slices":
        for rep in (mine, theirs):
            msg = [f.message for f in rep.findings if f.rule == "RLT306"][0]
            assert "fsdp" in msg and "data" in msg
    elif case == "hsdp":
        for rep in (mine, theirs):
            assert all(e.dcn_bytes == 0 for e in rep.collectives
                       if e.axes == ("fsdp",))
    elif case == "single-slice":
        assert mine.dcn_bytes_per_step == theirs.dcn_bytes_per_step == 0
        assert "InfiniBand total" not in mine.summary()
    elif case == "dp-across-slices":
        # JAX's red test's intent: the gradient all-reduce crosses nodes
        assert mine.dcn_bytes_per_step > 0
        assert "InfiniBand total" in mine.summary()
    elif case == "overlap-on":
        assert mine.overlap["scheduled"] is theirs.overlap["scheduled"] \
            is True
        assert mine.overlap_hidden_fraction > 0
        assert theirs.overlap_hidden_fraction > 0


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_axis_traces_the_flash_operators(mode):
    """Under ``seq=2`` the ring's blocks and Ulysses' heads run through
    the ``rltt`` flash operators, so the trace lists the kernels the card
    runs (rank 0 of the causal ring sees one block a layer) and no S x S
    score buffer is counted in the peak."""
    cfg = LlamaConfig.tiny(n_layers=2, seq_parallel=True,
                           seq_parallel_mode=mode)
    rep = audit_step(LlamaModule(cfg), ShardedMesh(seq=2, **CPU),
                     _tokens(2), topology="cpu-2", numerics=False)
    assert rep.kernels["rltt.flash_fwd"] == 2
    assert rep.kernels["rltt.flash_bwd_dkv"] == 2
    assert rep.kernels["rltt.flash_bwd_dq"] == 2
    assert not [f for f in rep.findings if f.severity == "error"]
    hop = "send_recv" if mode == "ring" else "all_to_all"
    assert hop in {e.kind for e in rep.collectives
                   if e.axes == ("seq",)}


def test_live_process_group_is_refused():
    """A trace inside a live gloo job would issue the step's collectives
    on its backend with fake tensors: refused, and the group is left as
    it was."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group is live"):
            audit_step(MLPClassifier(features=(16,), num_classes=4,
                                     in_features=784),
                       DataParallel(**CPU), _mlp_batch(16),
                       topology="cpu-2")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
