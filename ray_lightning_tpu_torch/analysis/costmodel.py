"""The cost model of the graph walks (twin of
`ray_lightning_tpu/analysis/costmodel.py`): a named H100 deployment's
interconnect and memory figures, the ring algebra that prices one
collective on them, and the FLOP and byte formulas of every ``rltt``
operator. Zero hardware: the numbers are a model, not a measurement.

The families are the card's:

  * ``h100-<n>`` (n <= 8) — one node, its GPUs joined all to all by
    NVLink 4 (NVIDIA H100 Tensor Core GPU data sheet, SXM5: 900 GB/s
    of NVLink bandwidth a GPU, both directions together; a ring sends
    and receives at once, so each direction's 450 GB/s is charged);
  * ``<k>xh100-8`` — k such nodes joined over InfiniBand NDR, the second
    network tier where the JAX model has DCN: one 400 Gb/s ConnectX-7
    port a GPU (the DGX H100 layout), 50 GB/s a GPU;
  * ``cpu-<n>`` — the CI pseudo-family, as the JAX model has ``cpu``.

Memory comes from `parallel.plan.hbm_bytes_for_kind` (one source of
truth); the compute side from `utils.probe.PEAK_TFLOPS` (989 TFLOP/s,
the data sheet's dense bf16 peak) derated by `MATMUL_EFFICIENCY`. The
per-hop latencies are modelling figures, not data-sheet numbers: the
data sheet states none.

Model assumptions, as in the JAX model: wire cost a chip follows the
ring algebra over the group size n (all-gather, reduce-scatter and
all-to-all move (n-1)/n of the payload, an all-reduce 2(n-1)/n, a
point-to-point send its payload once); latency = hops x hop latency +
wire bytes / bandwidth; a group that spans nodes is priced as the
hierarchical two-level ring (the intra-node stage over NVLink on the
whole payload, the inter-node stage over InfiniBand on the intra-reduced
1/n_intra share). Contention is not modelled.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

#: the card's kind as `torch.cuda.get_device_name` spells it
#: (`parallel.plan.H100_KIND`; this module imports no torch, so that
#: ``lint --numerics`` stays torch-free)
H100_KIND = "NVIDIA H100 80GB HBM3"

__all__ = [
    "Topology", "CollectiveCost", "ICI_SPECS", "DCN_SPECS",
    "MATMUL_EFFICIENCY", "DTYPE_WIDTHS", "dtype_width",
    "parse_topology", "topology_for_kind",
    "collective_cost", "compute_time_us", "memory_time_us",
    "paged_decode_traffic_bytes", "paged_prefill_traffic_bytes",
    "op_cost", "OP_COSTS",
]

#: storage width in bytes per dtype name: the ONE table the plan
#: checker's RLT105 and numcheck's RLT804 read, so the two rules cannot
#: drift. Names are torch's without the ``torch.`` prefix (which are
#: numpy's and jax's spellings too).
DTYPE_WIDTHS: Dict[str, float] = {
    "float64": 8.0, "int64": 8.0, "uint64": 8.0, "complex64": 8.0,
    "float32": 4.0, "int32": 4.0, "uint32": 4.0,
    "bfloat16": 2.0, "float16": 2.0, "int16": 2.0, "uint16": 2.0,
    "float8_e4m3fn": 1.0, "float8_e5m2": 1.0, "float8_e4m3b11fnuz": 1.0,
    "int8": 1.0, "uint8": 1.0, "bool": 1.0,
    "int4": 0.5, "uint4": 0.5,
}


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16``, ``np.dtype("bfloat16")`` or
    the string itself."""
    name = getattr(dtype, "name", None)
    if not isinstance(name, str):
        name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def dtype_width(dtype) -> Optional[float]:
    """Storage width in bytes of a dtype (a torch or numpy dtype, or its
    name); None when unknown. Names outside the table fall back to
    numpy's itemsize."""
    name = dtype_name(dtype)
    w = DTYPE_WIDTHS.get(name)
    if w is not None:
        return w
    itemsize = getattr(dtype, "itemsize", None)
    if isinstance(itemsize, int):
        return float(itemsize)
    try:
        import numpy as np

        return float(np.dtype(name).itemsize)
    except TypeError:
        return None


#: the first network tier per family: (device kind for the memory table,
#: GB/s a GPU in one direction, per-hop latency in microseconds)
ICI_SPECS: Dict[str, Tuple[str, float, float]] = {
    "h100": (H100_KIND, 450.0, 1.0),
    "cpu": ("cpu", 10.0, 10.0),
}

#: the second tier (between nodes): (GB/s a GPU, per-hop latency in us)
DCN_SPECS: Dict[str, Tuple[float, float]] = {
    "h100": (50.0, 5.0),
    "cpu": (1.0, 100.0),
}

#: GPUs a node of each family holds (one NVLink domain)
NODE_SIZE: Dict[str, Optional[int]] = {"h100": 8, "cpu": None}

_KIND_TO_FAMILY = {kind: fam for fam, (kind, _, _) in ICI_SPECS.items()}

#: memory of the "cpu" pseudo-family: enough to trace, small enough that
#: a real model's RLT302 check still runs on CI
_CPU_HBM_BYTES = 16 * 1024**3

#: HBM3 bandwidth of the H100 SXM5 (data sheet: 3.35 TB/s); the cpu
#: pseudo-family gets a visible-but-small figure
HBM_GBPS: Dict[str, float] = {"h100": 3350.0, "cpu": 50.0}


@dataclasses.dataclass(frozen=True)
class Topology:
    """One named deployment: device kind, count and interconnect.
    ``n_slices > 1`` is a multi-node deployment (``"2xh100-8"``):
    ``n_devices`` counts every GPU, NVLink spans one node, nodes talk
    over InfiniBand at the ``dcn_*`` figures (the JAX field names are
    kept: ``ici`` is the first tier, ``dcn`` the second)."""

    name: str
    device_kind: str
    n_devices: int
    ici_gbps: float
    ici_hop_latency_us: float
    hbm_bytes: int
    #: dense bf16 peak TFLOP/s a device; None resolves from device_kind
    peak_tflops: Optional[float] = None
    n_slices: int = 1
    dcn_gbps: Optional[float] = None
    dcn_hop_latency_us: Optional[float] = None

    def __post_init__(self) -> None:
        if self.peak_tflops is None:
            object.__setattr__(self, "peak_tflops",
                               _peak_tflops(self.device_kind))
        if self.dcn_gbps is None or self.dcn_hop_latency_us is None:
            fam = _KIND_TO_FAMILY.get(self.device_kind, "cpu")
            gbps, lat = DCN_SPECS.get(fam, DCN_SPECS["cpu"])
            if self.dcn_gbps is None:
                object.__setattr__(self, "dcn_gbps", gbps)
            if self.dcn_hop_latency_us is None:
                object.__setattr__(self, "dcn_hop_latency_us", lat)
        if self.n_slices < 1 or self.n_devices % self.n_slices:
            raise ValueError(
                f"topology {self.name!r}: {self.n_devices} devices do "
                f"not split into {self.n_slices} equal nodes")

    @property
    def hbm_gib(self) -> float:
        return self.hbm_bytes / 1024**3

    @property
    def devices_per_slice(self) -> int:
        return self.n_devices // self.n_slices

    @property
    def hbm_gbps(self) -> float:
        return HBM_GBPS.get(_KIND_TO_FAMILY.get(self.device_kind, "cpu"),
                            HBM_GBPS["cpu"])

    def describe(self) -> str:
        base = (f"{self.name}: {self.n_devices}x {self.device_kind} "
                f"({self.hbm_gib:.0f} GiB HBM, {self.ici_gbps:.0f} GB/s "
                "NVLink per GPU)")
        if self.n_slices > 1:
            base += (f" in {self.n_slices} nodes of "
                     f"{self.devices_per_slice} over InfiniBand "
                     f"({self.dcn_gbps:.1f} GB/s per GPU)")
        return base


def _family_hbm(kind: str, hbm_bytes: Optional[int]) -> int:
    from ray_lightning_tpu_torch.parallel.plan import hbm_bytes_for_kind

    if hbm_bytes is not None:
        return int(hbm_bytes)
    try:
        return hbm_bytes_for_kind(kind)
    except ValueError:
        return _CPU_HBM_BYTES


def parse_topology(name: str, *,
                   hbm_bytes: Optional[int] = None) -> Topology:
    """``"h100-8"`` -> one node of 8; ``"2xh100-8"`` -> two nodes joined
    over InfiniBand (16 GPUs, ``n_slices=2``); ``"cpu-4"`` the CI
    pseudo-family. The count after the dash is per node; an H100 node
    holds at most 8. Unknown families raise listing the known ones."""
    m = re.fullmatch(r"(?:(\d+)x)?([a-z][a-z0-9]*?)-(\d+)",
                     name.strip().lower())
    if not m:
        raise ValueError(
            f"cannot parse topology {name!r}; expected <family>-<gpus> "
            "like 'h100-8', or <nodes>x<family>-<gpus> like '2xh100-8' "
            f"(families: {sorted(ICI_SPECS)})")
    slices = int(m.group(1) or 1)
    family, count = m.group(2), int(m.group(3))
    if family not in ICI_SPECS:
        raise ValueError(
            f"unknown topology family {family!r} (known: "
            f"{sorted(ICI_SPECS)}); pass hbm_bytes= and use "
            "topology_for_kind for other hardware")
    if count < 1:
        raise ValueError(f"topology {name!r} must have >= 1 device")
    if slices < 1:
        raise ValueError(f"topology {name!r} must have >= 1 node")
    node = NODE_SIZE[family]
    if node is not None and count > node:
        raise ValueError(
            f"topology {name!r}: an {family} node holds at most {node} "
            f"GPUs over NVLink; name more nodes ('{-(-count // node)}x"
            f"{family}-{node}')")
    kind, gbps, lat = ICI_SPECS[family]
    return Topology(name=name, device_kind=kind, n_devices=slices * count,
                    ici_gbps=gbps, ici_hop_latency_us=lat,
                    hbm_bytes=_family_hbm(kind, hbm_bytes),
                    n_slices=slices)


def topology_for_kind(device_kind: str, n_devices: int, *,
                      hbm_bytes: Optional[int] = None) -> Topology:
    """Topology from a device kind as `torch.cuda.get_device_name` spells
    it (the planner's ``--device-kind`` vocabulary). Unknown kinds get
    the cpu pseudo-family's figures; memory still honours ``hbm_bytes``
    or the planner's table."""
    family = _KIND_TO_FAMILY.get(device_kind, "cpu")
    _, gbps, lat = ICI_SPECS[family]
    return Topology(name=f"{family}-{n_devices}", device_kind=device_kind,
                    n_devices=n_devices, ici_gbps=gbps,
                    ici_hop_latency_us=lat,
                    hbm_bytes=_family_hbm(device_kind, hbm_bytes))


def _peak_tflops(device_kind: str) -> float:
    """The spec-sheet peak (`utils.probe.PEAK_TFLOPS`, the doctor's table);
    kinds it does not hold (the cpu pseudo-family) get 1 TFLOP/s."""
    from ray_lightning_tpu_torch.utils.probe import device_peak_tflops

    return float(device_peak_tflops(device_kind) or 1.0)


#: the share of the spec-sheet peak a matmul-bound step sustains: the
#: doctor's bf16 matmul probe read 820.6 of 989 TFLOP/s (83%) on an
#: NVIDIA H100 80GB HBM3 at 700 W (`python -m ray_lightning_tpu_torch
#: --probe`). A higher figure shrinks the compute window and claims
#: less hiding, a lower one claims more.
MATMUL_EFFICIENCY = 820.6 / 989.0


def compute_time_us(flops: float, topo: Topology) -> float:
    """Time of ``flops`` on one device of ``topo`` at the derated peak."""
    if flops <= 0:
        return 0.0
    return flops / (topo.peak_tflops * 1e12 * MATMUL_EFFICIENCY) * 1e6


def memory_time_us(nbytes: float, topo: Topology) -> float:
    """Time to move ``nbytes`` through one device's memory at its
    spec-sheet bandwidth."""
    if nbytes <= 0:
        return 0.0
    return nbytes / (topo.hbm_gbps * 1e3)


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    wire_bytes: int   # bytes each GPU puts on the first tier
    time_us: float    # ring-model latency (both tiers, serial)
    dcn_bytes: int = 0
    dcn_time_us: float = 0.0


def _ring(kind: str, payload: float, n: int) -> Tuple[float, int]:
    """(wire bytes a device, ring hops) for one single-tier collective
    over a group of ``n``."""
    if n <= 1:
        return 0.0, 0
    frac = (n - 1) / n
    if kind in ("all_gather", "reduce_scatter", "all_to_all"):
        return payload * frac, n - 1
    if kind in ("ppermute", "send_recv"):
        return float(payload), 1
    # all_reduce (JAX psum) and the like
    return 2.0 * payload * frac, 2 * (n - 1)


def collective_cost(
    kind: str,
    payload_bytes: int,
    axis_sizes: Mapping[str, int],
    topo: Topology,
    *,
    dcn_group: int = 1,
) -> CollectiveCost:
    """Ring-model wire bytes and latency of ONE collective (the JAX
    algebra unchanged). ``payload_bytes`` is a device's payload: the
    local operand for all-reduce, send and all-to-all and reduce-scatter,
    the gathered bytes for all-gather. ``dcn_group`` is the number of
    nodes the group spans (`parallel.plan.group_dcn_span`)."""
    n = max(1, math.prod(axis_sizes.values()))
    if n == 1:
        return CollectiveCost(0, 0.0)
    s = max(1, min(int(dcn_group), n))
    if n % s:
        s = n
    n_intra = n // s
    if kind in ("ppermute", "send_recv") and s > 1:
        dcn_wire, dcn_hops = float(payload_bytes), 1
        ici_wire, ici_hops = 0.0, 0
    elif kind == "all_to_all" and s > 1:
        ici_wire = payload_bytes * (n_intra - 1) / n
        ici_hops = max(0, n_intra - 1)
        dcn_wire = payload_bytes * (s - 1) / s
        dcn_hops = s - 1
    else:
        ici_wire, ici_hops = _ring(kind, payload_bytes, n_intra)
        dcn_wire, dcn_hops = _ring(kind, payload_bytes / n_intra, s)
    ici_time = (ici_wire / (topo.ici_gbps * 1e3)
                + ici_hops * topo.ici_hop_latency_us)
    dcn_time = 0.0
    if s > 1:
        dcn_time = (dcn_wire / (topo.dcn_gbps * 1e3)
                    + dcn_hops * topo.dcn_hop_latency_us)
    else:
        dcn_wire = 0.0
    return CollectiveCost(int(ici_wire), ici_time + dcn_time,
                          dcn_bytes=int(dcn_wire), dcn_time_us=dcn_time)


def paged_decode_traffic_bytes(pool_bytes: int, gathered_view_bytes: int,
                               fused: bool) -> int:
    """The decode lane's KV bytes moved a tick: the paged kernel reads the
    pool once; the reference lane also writes the dense gathered view and
    reads it back. Conservative: the whole pool is charged even when
    slots are idle."""
    if fused:
        return int(pool_bytes)
    return int(pool_bytes + 2 * gathered_view_bytes)


def paged_prefill_traffic_bytes(group_view_bytes: int, chunk_bytes: int,
                                fused: bool) -> int:
    """The prefill lane's KV bytes moved a chunk: the group's blocks read
    once and the chunk's K/V written; the reference lane also writes the
    group's view and reads it back."""
    if fused:
        return int(group_view_bytes + chunk_bytes)
    return int(3 * group_view_bytes + chunk_bytes)


# ---- the rltt operators' FLOPs and bytes --------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if t is not None else 0


def _attn_flops(b, sq, sk, h, hd, causal: bool, products: int) -> float:
    """``products`` attention GEMMs of 2*b*h*sq*sk*hd each, as
    `torch.utils.flop_counter` counts SDPA's, halved for causal."""
    f = products * 2.0 * b * h * sq * sk * hd
    return f / 2 if causal else f


def _flash_fwd(args, out):
    q, k = args[0], args[1]
    b, sq, h, hd = q.shape
    flops = _attn_flops(b, sq, k.shape[1], h, hd, bool(args[3]), 2)
    return flops, sum(_nbytes(t) for t in args[:3]) + sum(
        _nbytes(t) for t in out)


def _flash_bwd(products: int):
    def cost(args, out):
        q, k = args[0], args[1]
        b, sq, h, hd = q.shape
        flops = _attn_flops(b, sq, k.shape[1], h, hd, bool(args[6]),
                            products)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return flops, sum(_nbytes(t) for t in args[:6]) + sum(
            _nbytes(t) for t in outs)
    return cost


def _rms_norm(args, out):
    x, w = args[0], args[1]
    return 4.0 * x.numel(), _nbytes(x) + _nbytes(w) + _nbytes(out)


def _kv_bytes(pool_k, tables) -> int:
    """The pool bytes (K and V) the tables can name, at most the pool."""
    _, p, hkv, hd = pool_k.shape
    named = tables.numel() * p * hkv * hd * pool_k.element_size()
    return 2 * min(named, _nbytes(pool_k))


def _paged_decode(args, out):
    q, pool_k, tables = args[0], args[1], args[3]
    c, h, hd = q.shape
    span = tables.shape[1] * pool_k.shape[1]
    flops = 4.0 * c * h * span * hd
    return flops, paged_decode_traffic_bytes(
        _kv_bytes(pool_k, tables), 0, True) + _nbytes(q) + _nbytes(out)


def _paged_prefill(args, out):
    q, pool_k, tables, pos = args[0], args[1], args[3], int(args[4])
    b, ch, h, hd = q.shape
    _, _, hkv, _ = pool_k.shape
    flops = 4.0 * b * ch * h * hd * (pos + (ch + 1) / 2)
    chunk = 2 * b * ch * hkv * hd * pool_k.element_size()
    return flops, paged_prefill_traffic_bytes(
        _kv_bytes(pool_k, tables), chunk, True) + _nbytes(q) + _nbytes(out)


def _adamw_step(args, out):
    params, exp_avgs = args[0], args[2]
    n = sum(p.numel() for p in params)
    moved = sum(p.numel() * (4 * 5 + 2 * m.element_size())
                for p, m in zip(params, exp_avgs))
    return 16.0 * n, moved


#: ``rltt`` operator -> (args, out) -> (FLOPs, bytes moved). Attention is
#: counted as `torch.utils.flop_counter` counts SDPA (forward: QK and PV;
#: backward: dV, dK and dP in the dK/dV pass, dQ in the dQ pass, which
#: sum to SDPA's backward), halved for causal; the paged kernels move
#: `paged_*_traffic_bytes`; RMSNorm and AdamW are priced by their bytes.
OP_COSTS: Dict[str, Callable[[Any, Any], Tuple[float, int]]] = {
    "rltt.flash_fwd": _flash_fwd,
    "rltt.flash_bwd_dkv": _flash_bwd(3),
    "rltt.flash_bwd_dq": _flash_bwd(1),
    "rltt.rms_norm": _rms_norm,
    "rltt.paged_decode": _paged_decode,
    "rltt.paged_prefill": _paged_prefill,
    "rltt.adamw_step": _adamw_step,
}

_FLOP_FORMULAS_REGISTERED = []


def _register_flop_formulas() -> None:
    """Teach `torch.utils.flop_counter.FlopCounterMode` the ``rltt``
    operators' FLOPs (the same formulas as `OP_COSTS`). Idempotent."""
    if _FLOP_FORMULAS_REGISTERED:
        return
    import torch
    from torch.utils.flop_counter import register_flop_formula

    from ray_lightning_tpu_torch.ops.kernels import (  # noqa: F401
        adamw,
        flash,
        paged_attention,
        paged_prefill,
        rmsnorm,
    )

    def shaped(name):
        cost = OP_COSTS[name]

        def formula(*args, out_shape=None, **kwargs):
            class _S:  # a shape standing in for the tensor
                def __init__(self, shape):
                    self.shape = tuple(shape)

                def numel(self):
                    return math.prod(self.shape)

                def element_size(self):
                    return 2

            def wrap(a):
                if isinstance(a, (tuple, list)) and a and \
                        isinstance(a[0], (tuple, list)):
                    return [wrap(x) for x in a]
                if isinstance(a, (tuple, torch.Size)) and all(
                        isinstance(d, int) for d in a):
                    return _S(a)
                return a
            outs = out_shape
            if isinstance(outs, (tuple, list)) and outs and isinstance(
                    outs[0], (tuple, list, torch.Size)):
                outs = [_S(o) for o in outs]
            elif outs is not None:
                outs = _S(outs)
            return int(cost([wrap(a) for a in args], outs)[0])
        return formula

    for name in OP_COSTS:
        ns, op = name.split(".")
        register_flop_formula(getattr(getattr(torch.ops, ns), op))(
            shaped(name))
    _FLOP_FORMULAS_REGISTERED.append(True)


def op_cost(name: str, args, out) -> Optional[Tuple[float, int]]:
    """(FLOPs, bytes moved) of one call of the operator ``name``
    (``"rltt.flash_fwd"``), or None when the table has no formula."""
    cost = OP_COSTS.get(name)
    return None if cost is None else cost(args, out)
