"""tracecheck (twin of `ray_lightning_tpu/analysis/tracecheck.py`): the
collective and memory audit of the REAL train step, on fake tensors.

The JAX module traces the step with `jax.make_jaxpr` and models GSPMD:
it infers which collectives XLA would insert. In the port nothing is
inferred: FSDP2, DDP, DTensor and `parallel/comm.py` issue every
collective themselves. So this module records what happens instead of
modelling it. `trace_step` starts a fake process group
(`torch.testing._internal.distributed.fake_pg`) of the deployment's
world at rank 0 and runs the trainer's own ``_init_state`` and
``_train_step`` (`core/trainer.py`) under `FakeTensorMode`: forward,
backward, ``finish_grads``, the norm and the optimizer step, with no
storage anywhere. A `TorchDispatchMode` records one event stream:

  * every aten and ``rltt`` operator with its FLOPs (the ``rltt``
    kernels by `costmodel.OP_COSTS`, the GEMMs and SDPA by
    `torch.utils.flop_counter`), its dtypes and shapes;
  * every c10d or functional collective with its payload bytes, its
    mesh axes (by its group) and the FSDP unit whose hook issued it
    (FSDP2's ``record_function`` labels);
  * every storage as it is made, resized and freed, for the peak.

The kernel lane is the one the card runs: every hand-written kernel is
an ``rltt`` operator with a Meta implementation, and the dispatch sends
CUDA tensors through them, and CPU tensors too (whose wrappers run the
plain versions). The trace runs on fake tensors of the host's device
(``device="cpu"``, the default: like the planner it touches no card)
or of the card (``device="cuda"``, on a torch built with CUDA). A torch
without CUDA cannot differentiate a fake CUDA tensor (autograd asks
CUDA's device guard for the node's stream), so there the CPU form is
the only one.

Where the trainer touches the device, the trace steps round it, and
says so here: the model is built on the meta device outside the fake
mode (`FakeTensorMode` cannot convert a module's parameters in place)
and moved to fake storage with ``to_empty`` before ``_init_state``
fills it; the strategy's process group is the fake one; DDP's
cross-rank shape check, which reads storage, is skipped
(`_ddp_shape_check_skipped`) and its bucket all-reduce is issued by a
comm hook that completes at once (`_hook_ddp_buckets`); a truncated
normal initialiser that samples by rejection draws once and clamps
(`_trunc_normal_unsampled`); a `DeviceMesh`
FSDP2 slices during the step is built with the fake mode unset (its
rank map is host metadata, `_device_meshes_real`); the batch is
placed by the trainer's own ``_place_train_batch`` before the fake mode
starts (placing pins host memory, which a fake tensor has none of).

The rules, each the port's form of the JAX one:

  * RLT301 — a collective of DTensor's redistribution (the functional
    collectives: the port's own paths issue c10d ones) on a payload
    shaped like no parameter: an activation reshard the plan never
    asked for;
  * RLT302 — the traced peak above the topology's memory;
  * RLT303 — `check_permutation` over `parallel.comm`'s shifts
    (`check_shift_schedule`), and, under ``pipe > 1``, one trace a stage
    whose send and receive sequences do not pair up;
  * RLT305 — an FSDP unit's forward all-gather issued by its own
    pre-forward hook, not one unit ahead (`classify_overlap` reads the
    stream's order under ``FSDP(overlap="off"|"on")``);
  * RLT306 — a mesh axis other than ``data`` whose group spans nodes on
    a ``<k>xh100-8`` topology.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.analysis.costmodel import (
    Topology,
    collective_cost,
    compute_time_us,
    dtype_name,
    memory_time_us,
    op_cost,
    parse_topology,
)
from ray_lightning_tpu_torch.analysis.findings import Finding

__all__ = [
    "CollectiveEvent", "TraceReport", "audit_step", "classify_overlap",
    "trace_step", "check_permutation", "check_shift_schedule",
    "record_ops", "fake_world",
]


@dataclasses.dataclass
class CollectiveEvent:
    """One collective site of the traced step (its calls folded into
    ``count``). ``payload_bytes`` follows the cost model's contract;
    ``wire_bytes``/``time_us`` are count-weighted totals. ``implicit``
    marks a collective DTensor's redistribution issued (the port's
    counterpart of a GSPMD-inserted one). ``prefetchable`` marks FSDP's
    weight gathers and gradient reduce-scatters (their operands are
    known ahead of use); ``scope`` is the index of the FSDP unit whose
    hook issued it; ``hidden_us`` is the share of ``time_us`` the overlap
    classification proved hideable."""

    kind: str
    axes: Tuple[str, ...]
    payload_bytes: int
    count: int
    wire_bytes: int
    time_us: float
    implicit: bool
    source: str
    param_path: Optional[str] = None
    unbounded: bool = False
    prefetchable: bool = False
    scope: Optional[int] = None
    hidden_us: float = 0.0
    dcn_bytes: int = 0
    dtype: Optional[str] = None

    @property
    def exposed_us(self) -> float:
        return max(0.0, self.time_us - self.hidden_us)

    def describe(self) -> str:
        tag = "implicit" if self.implicit else "explicit"
        extra = ""
        if self.hidden_us > 0 and self.time_us > 0:
            extra += f" {self.hidden_us / self.time_us:.0%}-hidden"
        elif self.prefetchable and self.scope is not None:
            extra += " exposed"
        who = f"  <{self.param_path}>" if self.param_path else ""
        dcn = (f" +{_fmt_bytes(self.dcn_bytes).strip()} IB"
               if self.dcn_bytes else "")
        dt = f" {self.dtype}" if self.dtype else ""
        return (f"{self.kind:<14} axes={','.join(self.axes) or '-'} "
                f"x{self.count:<4} {_fmt_bytes(self.wire_bytes)} wire"
                f"{dcn}{dt} {self.time_us:9.1f} us  [{tag}{extra}] "
                f"{self.source}{who}")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:7.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


@dataclasses.dataclass
class TraceReport:
    """What tracecheck found for one (module, strategy, topology)."""

    topology: Topology
    mesh_axes: Dict[str, int]
    collectives: List[CollectiveEvent]
    findings: List[Finding]
    params_bytes_per_device: int
    opt_bytes_per_device: int
    peak_hbm_bytes: int
    hbm_budget_bytes: int
    label: str = ""
    overlap: Optional[Dict[str, Any]] = None
    #: ``rltt`` kernel operators the step ran, {name: calls}, in order
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    precision: Optional[Dict[str, Any]] = None
    #: FLOPs a device, all operators, and the modelled step
    flops: float = 0.0
    bytes_moved: int = 0
    compute_us: float = 0.0

    @property
    def ici_bytes_per_step(self) -> int:
        return sum(e.wire_bytes for e in self.collectives)

    @property
    def dcn_bytes_per_step(self) -> int:
        return sum(e.dcn_bytes for e in self.collectives)

    @property
    def ici_time_us(self) -> float:
        return sum(e.time_us for e in self.collectives)

    @property
    def ici_hidden_us(self) -> float:
        return sum(e.hidden_us for e in self.collectives)

    @property
    def ici_exposed_us(self) -> float:
        return sum(e.exposed_us for e in self.collectives)

    @property
    def overlap_hidden_fraction(self) -> float:
        pref = sum(e.time_us for e in self.collectives if e.prefetchable)
        if pref <= 0:
            return 0.0
        return sum(e.hidden_us for e in self.collectives
                   if e.prefetchable) / pref

    @property
    def step_us(self) -> float:
        """The modelled step: each operator at its roofline (its FLOPs at
        the derated peak or its bytes at the memory rate, the longer),
        summed, plus the collective time not hidden behind it."""
        return self.compute_us + self.ici_exposed_us

    @property
    def fits(self) -> bool:
        return self.peak_hbm_bytes <= self.hbm_budget_bytes

    def totals_by_kind(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for e in self.collectives:
            t = out.setdefault(e.kind, {"count": 0, "wire_bytes": 0,
                                        "time_us": 0.0})
            t["count"] += e.count
            t["wire_bytes"] += e.wire_bytes
            t["time_us"] += e.time_us
        return out

    def summary(self) -> str:
        gib = 1024**3
        lines = [f"tracecheck: {self.label or 'step'} on "
                 f"{self.topology.describe()}", f"mesh {self.mesh_axes}"]
        if self.kernels:
            lines.append("kernels: " + ", ".join(
                f"{k} x{n}" for k, n in self.kernels.items()))
        if self.collectives:
            lines.append("collective schedule (per train step):")
            for e in sorted(self.collectives, key=lambda e: -e.wire_bytes):
                lines.append("  " + e.describe())
            lines.append(
                f"NVLink total: {self.ici_bytes_per_step / gib:.3f} "
                f"GiB/step on the wire, ~{self.ici_time_us / 1e3:.2f} ms "
                f"serialized ({self.topology.ici_gbps:.0f} GB/s per GPU)")
            if self.topology.n_slices > 1:
                lines.append(
                    f"InfiniBand total: {self.dcn_bytes_per_step / gib:.3f}"
                    f" GiB/step per GPU across {self.topology.n_slices} "
                    f"nodes ({self.topology.dcn_gbps:.1f} GB/s per GPU)")
            ov = self.overlap or {}
            lines.append(
                "overlap: " + ("prefetch schedule detected"
                               if ov.get("scheduled")
                               else "no prefetch schedule (overlap=off)")
                + f" — {self.overlap_hidden_fraction:.0%} of prefetchable "
                f"collective time hidden ({self.ici_hidden_us / 1e3:.2f} "
                f"ms hidden, {self.ici_exposed_us / 1e3:.2f} ms exposed)")
        else:
            lines.append("collective schedule: none (single-device or "
                         "fully replicated step)")
        lines.append(
            f"compute: {self.flops / 1e12:.2f} TFLOP a device, "
            f"~{self.compute_us / 1e3:.2f} ms at the derated peak; "
            f"modelled step {self.step_us / 1e3:.2f} ms")
        lines.append(
            f"peak memory estimate: {self.peak_hbm_bytes / gib:.2f} GiB "
            f"per device (params {self.params_bytes_per_device / gib:.2f} "
            f"+ opt {self.opt_bytes_per_device / gib:.2f} + live "
            f"intermediates) vs budget {self.hbm_budget_bytes / gib:.2f} "
            f"GiB — {'FITS' if self.fits else 'DOES NOT FIT'}")
        if self.precision:
            lines.append("precision ledger (per device):")
            for cls in ("params", "opt_state", "activations", "kv_pool"):
                by = self.precision.get(cls) or {}
                if by:
                    lines.append(f"  {cls:<12}: " + " + ".join(
                        f"{dt} {b / gib:.3f} GiB" for dt, b in sorted(
                            by.items(), key=lambda kv: -kv[1])))
            widest = self.precision.get("loss_widest_dtype")
            if widest:
                lines.append(f"  loss widest-path dtype: {widest}")
        if self.findings:
            lines.append(f"findings ({len(self.findings)}):")
            lines.extend("  " + f.format() for f in self.findings)
        else:
            lines.append("findings: none")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "topology": {
                "name": self.topology.name,
                "device_kind": self.topology.device_kind,
                "n_devices": self.topology.n_devices,
                "ici_gbps": self.topology.ici_gbps,
                "hbm_bytes": self.topology.hbm_bytes,
                "n_slices": self.topology.n_slices,
                "dcn_gbps": self.topology.dcn_gbps,
            },
            "mesh": self.mesh_axes,
            "ici_bytes_per_step": self.ici_bytes_per_step,
            "dcn_bytes_per_step": self.dcn_bytes_per_step,
            "ici_time_us": round(self.ici_time_us, 1),
            "ici_hidden_us": round(self.ici_hidden_us, 1),
            "ici_exposed_us": round(self.ici_exposed_us, 1),
            "overlap_hidden_fraction": round(
                self.overlap_hidden_fraction, 4),
            "overlap": self.overlap,
            "collectives": [
                {"kind": e.kind, "axes": list(e.axes),
                 "payload_bytes": e.payload_bytes, "count": e.count,
                 "wire_bytes": e.wire_bytes, "dcn_bytes": e.dcn_bytes,
                 "time_us": round(e.time_us, 1), "implicit": e.implicit,
                 "source": e.source, "param_path": e.param_path,
                 "unbounded": e.unbounded,
                 "prefetchable": e.prefetchable, "scope": e.scope,
                 "hidden_us": round(e.hidden_us, 1), "dtype": e.dtype}
                for e in sorted(self.collectives,
                                key=lambda e: -e.wire_bytes)],
            "totals_by_kind": self.totals_by_kind(),
            "params_bytes_per_device": self.params_bytes_per_device,
            "opt_bytes_per_device": self.opt_bytes_per_device,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "fits": self.fits,
            "kernels": dict(self.kernels),
            "flops": self.flops,
            "bytes_moved": self.bytes_moved,
            "compute_us": round(self.compute_us, 1),
            "step_us": round(self.step_us, 1),
            "precision": self.precision,
            "findings": [f.to_dict() for f in self.findings],
        }


# --------------------------------------------------------------------------
# permutation checks (RLT303)
# --------------------------------------------------------------------------


def check_permutation(perm: Sequence[Tuple[int, int]], axis_size: int,
                      *, source: str = "<shift>") -> List[Finding]:
    """Validate one point-to-point schedule of (source, destination)
    ranks (the JAX check on a ppermute, unchanged): unique sources,
    unique destinations, ranks in range, and a full permutation must be
    a single cycle (two disjoint rings each wait on the other's data).
    Partial permutations (open chains, a pipeline's stages) are legal."""
    findings: List[Finding] = []
    perm = [(int(s), int(d)) for s, d in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    bad_rank = sorted({r for r in srcs + dsts if r < 0 or r >= axis_size})
    if bad_rank:
        findings.append(Finding(
            "RLT303",
            f"shift names rank(s) {bad_rank} outside the axis "
            f"(size {axis_size}) — the schedule cannot execute",
            file=None, symbol=source))
    dup_s = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_d = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_s:
        findings.append(Finding(
            "RLT303",
            f"shift has duplicate source rank(s) {dup_s}: a rank cannot "
            "send two different payloads in one shift", symbol=source))
    if dup_d:
        findings.append(Finding(
            "RLT303",
            f"shift has duplicate destination rank(s) {dup_d}: "
            "mismatched send/recv pairing — one recv gets two sends",
            symbol=source))
    if (not bad_rank and not dup_s and not dup_d
            and len(perm) == axis_size and axis_size > 1):
        nxt = dict(perm)
        if set(nxt) == set(range(axis_size)):
            seen, r = set(), 0
            while r not in seen:
                seen.add(r)
                r = nxt[r]
            if len(seen) != axis_size:
                findings.append(Finding(
                    "RLT303",
                    f"full shift permutation over {axis_size} ranks "
                    f"decomposes into {_count_cycles(nxt)} disjoint "
                    "cycles, not one ring — each sub-ring waits forever "
                    "on data the others hold (use parallel.comm's "
                    "ring_perm / pipeline_perm)", symbol=source))
    return findings


def _count_cycles(nxt: Dict[int, int]) -> int:
    left, n = set(nxt), 0
    while left:
        n += 1
        r = next(iter(left))
        while r in left:
            left.remove(r)
            r = nxt[r]
    return n


def check_shift_schedule(sends: Mapping[int, Sequence[Tuple[str, int]]],
                         recvs: Mapping[int, Sequence[Tuple[str, int]]],
                         *, source: str = "<pipeline>") -> List[Finding]:
    """RLT303 across ranks: ``sends[r]`` is rank r's ordered (tag, peer)
    sends and ``recvs[r]`` its (tag, peer) receives, one trace a stage.
    Every send must be met by the peer's receive from r in the same
    position of their exchange, else the ranks wait on each other."""
    findings: List[Finding] = []
    for mine, theirs, verb in ((sends, recvs, "send"), (recvs, sends,
                                                        "receive")):
        other = "receive" if verb == "send" else "send"
        for r, seq in sorted(mine.items()):
            nth: Dict[int, int] = {}
            for i, (tag, peer) in enumerate(seq):
                j = nth.get(peer, 0)
                nth[peer] = j + 1
                match = [t for t, p in theirs.get(peer, ()) if p == r]
                if j >= len(match) or match[j] != tag:
                    findings.append(Finding(
                        "RLT303",
                        f"rank {r}'s {verb} #{i} ({tag}) with rank {peer} "
                        f"has no matching {other} on rank {peer}: the "
                        "exchange deadlocks", symbol=source))
    return findings


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

#: collective operators -> the cost model's kind
_COLLECTIVE_KINDS = {
    "c10d._allgather_base_": "all_gather",
    "c10d.allgather_": "all_gather",
    "c10d.allgather_into_tensor_coalesced_": "all_gather",
    "c10d._reduce_scatter_base_": "reduce_scatter",
    "c10d.reduce_scatter_": "reduce_scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "c10d.allreduce_": "all_reduce",
    "c10d.allreduce_coalesced_": "all_reduce",
    "c10d.alltoall_base_": "all_to_all",
    "c10d.alltoall_": "all_to_all",
    "c10d.broadcast_": "broadcast",
    "c10d.send": "send_recv",
    "c10d.recv_": "send_recv",
    "_c10d_functional.all_gather_into_tensor": "all_gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all_gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce_scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce_scatter",
    "_c10d_functional.all_reduce": "all_reduce",
    "_c10d_functional.all_reduce_": "all_reduce",
    "_c10d_functional.all_reduce_coalesced": "all_reduce",
    "_c10d_functional.all_to_all_single": "all_to_all",
    "_c10d_functional.broadcast": "broadcast",
}

#: operators that only relabel bytes (views: no data moved)
_LAYOUT = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.permute",
    "aten.transpose", "aten.t", "aten.expand", "aten.slice",
    "aten.select", "aten.unsqueeze", "aten.squeeze", "aten.alias",
    "aten.detach", "aten.as_strided", "aten.split", "aten.unbind",
    "aten.split_with_sizes", "aten.chunk", "aten.narrow",
    "aten.lift_fresh",
})

#: c10d operators whose arguments are (output, input, ...)
_OUT_IN = frozenset({"c10d._allgather_base_", "c10d._reduce_scatter_base_",
                     "c10d.alltoall_base_"})

#: the GEMMs (numcheck's RLT801 reads the reduced-precision setting)
_GEMMS = frozenset({"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
                    "aten.matmul", "aten.dot", "aten.linear"})

_UNIT = re.compile(r"\((?P<unit>[^()]+)\)\s*$")


@dataclasses.dataclass
class OpEvent:
    """One operator call of the stream."""

    name: str
    flops: float
    nbytes: int
    in_dtypes: Tuple[Optional[str], ...]
    out_dtypes: Tuple[Optional[str], ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    context: Tuple[str, ...]
    unit: Optional[str]
    #: ids of the input / output tensors (numcheck's provenance keys)
    in_ids: Tuple[int, ...] = ()
    out_ids: Tuple[int, ...] = ()
    #: collective fields
    kind: Optional[str] = None
    group: Optional[str] = None
    group_size: int = 1
    payload_bytes: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _flat(x, out):
    import torch

    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _group_of(args) -> Tuple[Optional[str], int]:
    """(group name, size) of a collective call's process group."""
    import torch.distributed as dist

    for a in args:
        if type(a).__name__ == "ScriptObject":
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
            return str(pg.group_name), int(pg.size())
    strs = [a for a in args if isinstance(a, str)]
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    if strs:
        name = strs[-1]
        try:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )

            return name, int(_resolve_process_group(name).size())
        except Exception:  # noqa: BLE001 — an unknown group: its size
            return name, int(ints[0]) if ints else 1
    return None, 1


class Recorder:
    """The `TorchDispatchMode` body of the trace: every operator call as
    an `OpEvent`, and the live storage bytes for the peak. Use
    `record_ops` to run it."""

    def __init__(self):
        self.events: List[OpEvent] = []
        self.context: List[str] = []
        self.unit: Optional[str] = None
        self.live = 0
        self.peak = 0
        self.peak_by: Dict[str, int] = {}
        self._by: Dict[str, int] = {}
        self._sizes: Dict[int, Tuple[int, str]] = {}
        self._refs: Dict[int, Any] = {}
        #: record what a DTensor's own dispatch runs (its local operators
        #: and the collectives of its redistribution): on under a tensor
        #: axis, where a DTensor activation can need one; FSDP's DTensor
        #: parameters are gathered by FSDP's own hooks, recorded anyway
        self.expand_subclasses = False

    # ---- storage accounting ----------------------------------------------

    def track(self, t) -> None:
        """Count ``t``'s storage as live until it is freed (a DTensor's:
        its local shard's)."""
        t = getattr(t, "_local_tensor", t)
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._sizes:
            return
        n = int(st.nbytes())
        dt = dtype_name(t.dtype)
        self._sizes[key] = (n, dt)
        self._add(n, dt)
        self._refs[key] = weakref.ref(st, lambda _r, key=key: self._free(key))

    def _add(self, n: int, dt: str) -> None:
        self.live += n
        self._by[dt] = self._by.get(dt, 0) + n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = dict(self._by)

    def _free(self, key: int) -> None:
        n, dt = self._sizes.pop(key, (0, ""))
        self._refs.pop(key, None)
        self.live -= n
        if dt:
            self._by[dt] = self._by.get(dt, 0) - n

    def resized(self, st, new_bytes: int) -> None:
        """A storage resized in place (FSDP2 frees and refills its
        unsharded parameters so)."""
        key = st._cdata
        old, dt = self._sizes.get(key, (0, "unknown"))
        if key not in self._refs:
            self._refs[key] = weakref.ref(
                st, lambda _r, key=key: self._free(key))
        self._sizes[key] = (int(new_bytes), dt)
        self.live += int(new_bytes) - old
        self._by[dt] = self._by.get(dt, 0) + int(new_bytes) - old
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = dict(self._by)

    # ---- events -------------------------------------------------------------

    def marker(self, name: str, enter: bool) -> None:
        if not enter:
            if self.context:
                self.context.pop()
            return
        self.context.append(name)
        m = _UNIT.search(name)
        if name.startswith(("FSDP::pre_forward", "FSDP::pre_backward")):
            self.unit = m.group("unit") if m else None
        elif name.startswith("FSDP::post_forward") and m:
            self.unit = None

    def op(self, func, args, kwargs, out) -> None:
        import torch

        name = str(getattr(func, "overloadpacket", func))
        if name.startswith("profiler._record_function_enter"):
            self.marker(str(args[0]), True)
            return
        if name.startswith("profiler._record_function_exit"):
            self.marker("", False)
            return
        if name == "prim.device":
            return
        ins = _flat(list(args) + list((kwargs or {}).values()), [])
        outs = _flat(out, [])
        for t in outs:
            self.track(t)
        flops, nbytes = 0.0, 0
        cost = op_cost(name, args, out)
        if cost is not None:
            flops, nbytes = cost
        else:
            formula = _flop_registry().get(func.overloadpacket)
            if formula is not None:
                try:
                    flops = float(formula(*args, **(kwargs or {}),
                                          out_val=out))
                except Exception:  # noqa: BLE001 — an operator whose
                    # formula cannot read this call costs no FLOPs here
                    flops = 0.0
            if name not in _LAYOUT and name not in _COLLECTIVE_KINDS:
                # what the operator reads and writes, each tensor once
                seen = {}
                for t in ins + outs:
                    seen.setdefault(id(t), t.numel() * t.element_size())
                nbytes = sum(seen.values())
        ev = OpEvent(
            name=name, flops=flops, nbytes=nbytes,
            in_dtypes=tuple(dtype_name(t.dtype) for t in ins),
            out_dtypes=tuple(dtype_name(t.dtype) for t in outs),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            context=tuple(self.context), unit=self.unit,
            in_ids=tuple(id(t) for t in ins),
            out_ids=tuple(id(t) for t in outs))
        bwd = torch._C._current_graph_task_id() >= 0
        ev.extra["bwd"] = bwd
        if name in _GEMMS:
            ev.extra["reduced"] = bool(
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction)
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is not None:
            ev.kind = kind
            ev.group, ev.group_size = _group_of(args)
            # c10d's (output, input) operators read their operand second
            src = ins[1] if name in _OUT_IN and len(ins) > 1 else (
                ins[0] if ins else None)
            if kind == "all_gather":
                # the cost model's payload: the gathered bytes
                whole = ins[0] if name.startswith("c10d.") else (
                    outs[0] if outs else None)
                ev.payload_bytes = (whole.numel() * whole.element_size()
                                    if whole is not None else 0)
            elif src is not None:
                ev.payload_bytes = src.numel() * src.element_size()
            ev.extra["phase"] = "backward" if bwd else "forward"
            ev.extra["dtype"] = (dtype_name(src.dtype)
                                 if src is not None else None)
            ev.extra["shape"] = tuple(src.shape) if src is not None else ()
            if name in ("c10d.send", "c10d.recv_"):
                # (peer, tag): the group-local rank and the message's tag
                ev.extra["peer"], ev.extra["tag"] = int(args[2]), int(args[3])
        self.events.append(ev)


_REGISTRY: List[Any] = []


def _flop_registry():
    if not _REGISTRY:
        from torch.utils.flop_counter import flop_registry

        from ray_lightning_tpu_torch.analysis.costmodel import (
            _register_flop_formulas,
        )

        _register_flop_formulas()
        _REGISTRY.append(flop_registry)
    return _REGISTRY[0]


@contextlib.contextmanager
def record_ops(recorder: Optional[Recorder] = None):
    """Record every operator call on this thread (and on autograd's
    threads, which inherit the mode) into ``recorder``; yields it. Storage
    resizes are reported to it while active."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    rec = recorder if recorder is not None else Recorder()
    _flop_registry()

    from torch._subclasses.fake_tensor import FakeTensor

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if rec.expand_subclasses and any(
                    not issubclass(t, FakeTensor) and t is not torch.Tensor
                    for t in types):
                # a tensor subclass (DTensor) first: its dispatch runs its
                # local operators and its redistribution's collectives
                # with this mode still active, so they are recorded
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            rec.op(func, args, kwargs, out)
            return out

    storage_cls = torch.UntypedStorage
    resize = storage_cls.resize_

    def resize_(st, size):
        result = resize(st, size)
        rec.resized(st, size)
        return result

    storage_cls.resize_ = resize_
    try:
        with _Mode():
            yield rec
    finally:
        storage_cls.resize_ = resize


@contextlib.contextmanager
def fake_world(n_devices: int, rank: int = 0):
    """A fake process group of ``n_devices`` at ``rank`` and a
    `FakeTensorMode`; yields the mode. A fake group of that world and
    rank that is already live is used as it is; any other live group
    (a real NCCL or gloo job) is refused: the step's collectives would
    go to its backend with fake tensors, at its world and rank."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world, rank = max(1, int(n_devices)), int(rank)
    started = False
    if not (dist.is_available() and dist.is_initialized()):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        started = True
    elif (dist.get_backend(), dist.get_world_size(),
          dist.get_rank()) != ("fake", world, rank):
        raise RuntimeError(
            f"a process group is live (backend {dist.get_backend()!r}, "
            f"world {dist.get_world_size()}, rank {dist.get_rank()}): the "
            f"trace needs a fake one of world {world} at rank {rank}; "
            "trace in a process with no group (e.g. before "
            "init_process_group, or in a child process)")
    try:
        yield FakeTensorMode(allow_non_fake_inputs=True)
    finally:
        if started:
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# tracing the trainer's step
# --------------------------------------------------------------------------


def _host_batch(batch):
    import numpy as np

    if isinstance(batch, dict):
        return {k: _host_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_host_batch(v) for v in batch)
    return np.asarray(batch)


def trace_step(module, strategy, n_devices: int, example_batch: Any, *,
               device: Any = "cpu", trainer_kwargs=None, rank: int = 0):
    """Run one train step of ``module`` under ``strategy`` on ``rank``
    (rank 0 by default) of a fake world of ``n_devices`` and return
    ``(recorder, meta)``: the
    event stream and the state the audit reads (the trainer, the local
    parameter and optimizer tensors by name, the mesh's axis groups).
    ``example_batch`` is the GLOBAL batch (host arrays); each rank's
    share is what the strategy gives it. The strategy and module are
    consumed: pass fresh ones."""
    import torch

    from ray_lightning_tpu_torch.core.trainer import Trainer

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "trace_step(device='cuda') needs a torch built with CUDA: a "
            "CUDA-less torch cannot differentiate a fake CUDA tensor; "
            "trace on device='cpu' (the same operators)")
    if strategy._device_arg is None:
        strategy._device_arg = dev
    world = max(1, int(n_devices))
    with fake_world(world, rank) as fake:
        trainer = Trainer(strategy=strategy, max_steps=1,
                          **(trainer_kwargs or {}))
        trainer.module = module
        module.trainer = trainer
        trainer._seed = 0
        strategy.setup(module)
        local = _local_batch(strategy, _host_batch(example_batch), world,
                             rank)
        why = trainer._meta_refusal(module)
        if why is None:
            trainer._build_model(module)
        else:
            # the eager path's model, built on the meta device and
            # given fake storage below (the module's own setup)
            real = module.device
            module.device = torch.device("meta")
            try:
                module.setup()
            finally:
                module.device = real
            trainer.init_path, trainer.init_path_reason = "eager", why
        rec = Recorder()
        rec.expand_subclasses = strategy.spec.sizes().get("tensor", 1) > 1 \
            if getattr(strategy, "spec", None) is not None else False
        # the batch is placed for real before the fake mode (a few
        # kilobytes of token ids): the placement pins host memory, which
        # a fake tensor has none of
        placed = trainer._place(local)
        _, batch = trainer._place_train_batch(local)
        with fake, _ddp_shape_check_skipped(), _device_meshes_real(), \
                _trunc_normal_unsampled():
            if trainer.init_path == "eager":
                module.model.to_empty(device=strategy.device)
            trainer.state = trainer._init_state(module, placed)
            _hook_ddp_buckets(module.model)
            for t in _resident(trainer, batch):
                rec.track(t)
            with record_ops(rec):
                trainer._train_step(batch)
            meta = _state_meta(trainer, strategy)
        meta["trainer"] = trainer
        meta["n_devices"] = world
        meta["device"] = dev
    return rec, meta


@contextlib.contextmanager
def _ddp_shape_check_skipped():
    """`DistributedDataParallel`'s constructor compares every rank's
    parameter shapes by reading their storage (`torch.distributed.utils.
    _verify_param_shape_across_processes`), which a fake tensor has none
    of; in a fake world of one process there is nothing to compare, so
    the trace skips that check and only it."""
    from torch.nn.parallel import distributed as ddp

    saved = ddp._verify_param_shape_across_processes
    ddp._verify_param_shape_across_processes = lambda *a, **k: None
    try:
        yield
    finally:
        ddp._verify_param_shape_across_processes = saved


@contextlib.contextmanager
def _trunc_normal_unsampled():
    """`nn.init.trunc_normal_` (the BERT and ResNet initialisers) draws by
    rejection on some torch versions: it loops until no value lies out
    of bounds, which reads values a fake tensor has none of. While the
    trace initialises, it draws one normal and clamps it to the bounds:
    the same tensor, filled by a loop-free form."""
    import torch
    from torch import nn

    saved = nn.init.trunc_normal_

    def unsampled(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0,
                  generator=None):
        with torch.no_grad():
            return tensor.normal_(mean, std, generator=generator).clamp_(
                a, b)

    nn.init.trunc_normal_ = unsampled
    try:
        yield
    finally:
        nn.init.trunc_normal_ = saved


@contextlib.contextmanager
def _device_meshes_real():
    """A `DeviceMesh` made while the trace runs (FSDP2 slices the mesh of
    a 2-D `ShardedMesh`) is built with the fake mode unset: its rank map
    is host metadata, and finding this rank's coordinates in it reads
    values, which a fake tensor has none of."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import DeviceMesh

    init = DeviceMesh.__init__

    def real_init(self, *args, **kwargs):
        with unset_fake_temporarily():
            init(self, *args, **kwargs)

    DeviceMesh.__init__ = real_init
    try:
        yield
    finally:
        DeviceMesh.__init__ = init


def _hook_ddp_buckets(model) -> None:
    """A DDP bucket's all-reduce, issued by a comm hook: DDP's reducer
    reads the fake process group's result as a tensor and finds none, so
    the trace gives DDP the hook its default is (`dist.all_reduce` of the
    bucket, divided by the world), which completes at once."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if not isinstance(model, DistributedDataParallel):
        return

    def allreduce(group, bucket):
        buf = bucket.buffer()
        dist.all_reduce(buf, group=group)
        buf.div_(dist.get_world_size(group))
        fut = torch.futures.Future()
        fut.set_result(buf)
        return fut

    model.register_comm_hook(model.process_group, allreduce)


def _local_batch(strategy, batch, world: int, rank: int = 0):
    """A rank's share of the global batch (the rows its data shard
    reads)."""
    shard, count = strategy.data_shard(rank, world)
    if count <= 1:
        return batch

    def cut(a):
        n = a.shape[0] // count
        return a[shard * n:(shard + 1) * n]

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(cut(v) for v in batch)


def _resident(trainer, batch) -> List[Any]:
    """Every tensor alive as the step starts: parameters, buffers, the
    optimizer's state and scalars, the batch."""
    import torch

    from ray_lightning_tpu_torch.parallel.tensor import local

    out = [local(p) for p in trainer.module.model.parameters()]
    out += list(trainer.module.model.buffers())
    opt = trainer.state.optimizer
    for st in opt.state.values():
        out += [local(v) for v in st.values() if isinstance(v, torch.Tensor)]
    for g in opt.param_groups:
        if isinstance(g.get("lr"), torch.Tensor):
            out.append(g["lr"])
    out += _flat(batch, [])
    return out


def _state_meta(trainer, strategy) -> dict:
    """The local parameter and optimizer tensors by name, after the
    step, and the mesh's groups."""
    import torch

    from ray_lightning_tpu_torch.parallel.tensor import local

    model = strategy.unwrap(trainer.module.model)
    named = {n: local(p) for n, p in model.named_parameters()}
    opt = trainer.state.optimizer
    ids = {id(p): n for n, p in model.named_parameters()}
    named_opt: Dict[str, Any] = {}
    for p, st in opt.state.items():
        pname = ids.get(id(p), f"param{len(named_opt)}")
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                named_opt[f"{k}/{pname}"] = local(v)
    sizes = {k: v for k, v in strategy.spec.sizes().items()} \
        if getattr(strategy, "spec", None) is not None else {}
    groups: Dict[str, Tuple[str, ...]] = {}
    members: Dict[str, List[int]] = {}
    mesh = getattr(strategy, "mesh", None)
    if mesh is not None and mesh.mesh_dim_names:
        import torch.distributed as dist

        for dim in mesh.mesh_dim_names:
            try:
                group = mesh.get_group(dim)
            except (RuntimeError, KeyError):
                continue
            groups[str(group.group_name)] = (dim,)
            members[dim] = list(dist.get_process_group_ranks(group))
    try:
        import torch.distributed as dist

        world = dist.distributed_c10d._get_default_group()
        live = tuple(ax for ax, s in sizes.items() if s > 1)
        groups.setdefault(str(world.group_name), live)
    except (RuntimeError, ValueError):
        pass
    return {"named_params": named, "named_opt": named_opt,
            "mesh_sizes": sizes, "groups": groups, "members": members}


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += int(st.nbytes())
    return total


def _by_dtype(tensors) -> Dict[str, int]:
    by: Dict[str, int] = {}
    seen = set()
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        dt = dtype_name(t.dtype)
        by[dt] = by.get(dt, 0) + int(st.nbytes())
    return by


# --------------------------------------------------------------------------
# the audit
# --------------------------------------------------------------------------


def collective_events(ops: Sequence[OpEvent], groups: Mapping[str, tuple],
                      mesh_sizes: Mapping[str, int], topo: Topology,
                      named_params: Mapping[str, Any],
                      units: Sequence[str] = ()) -> List[CollectiveEvent]:
    """The stream's collectives as `CollectiveEvent`s, one a site (kind,
    axes, payload, source), priced on ``topo``."""
    from ray_lightning_tpu_torch.parallel.plan import group_dcn_span

    shapes = set()
    for p in named_params.values():
        shapes.add(tuple(p.shape))
    scope_of = {u: i for i, u in enumerate(units)}
    sites: Dict[tuple, CollectiveEvent] = {}
    costs: Dict[tuple, Any] = {}
    for ev in ops:
        if ev.kind is None:
            continue
        axes = tuple(groups.get(ev.group, ()))
        if not axes and ev.group_size > 1:
            axes = (f"group{ev.group}",)
        sizes = {ax: int(mesh_sizes.get(ax, ev.group_size))
                 for ax in axes}
        if axes and math.prod(sizes.values()) != ev.group_size:
            sizes = {axes[0]: ev.group_size}
        ctx = next((c for c in reversed(ev.context)
                    if c.startswith("FSDP::")), None)
        unit = None
        if ctx is not None:
            m = _UNIT.search(ctx)
            unit = m.group("unit") if m else None
            if ctx.startswith("FSDP::forward_prefetch for ") or \
                    ctx.startswith("FSDP::backward_prefetch for "):
                unit = ctx.split(" for ", 1)[1].strip()
        fsdp = ctx is not None and ev.kind in ("all_gather",
                                               "reduce_scatter")
        implicit = ev.name.startswith("_c10d_functional")
        source = ctx or ev.name
        if implicit:
            source = f"DTensor redistribute ({ev.name.split('.')[-1]})"
        param_path = None
        if fsdp:
            param_path = "params/" + (unit or "<root>")
        elif tuple(ev.extra.get("shape", ())) in shapes:
            param_path = "params/" + next(
                n for n, p in named_params.items()
                if tuple(p.shape) == tuple(ev.extra.get("shape", ())))
        key = (ev.kind, axes, ev.payload_bytes, source, param_path,
               ev.extra.get("phase"))
        site = sites.get(key)
        if site is None:
            costs[key] = collective_cost(
                ev.kind, ev.payload_bytes, sizes, topo,
                dcn_group=group_dcn_span(axes, mesh_sizes, topo.n_slices)
                if topo.n_slices > 1 and len(axes) and all(
                    ax in mesh_sizes for ax in axes) else 1)
            site = sites[key] = CollectiveEvent(
                kind=ev.kind, axes=axes, payload_bytes=ev.payload_bytes,
                count=0, wire_bytes=0, time_us=0.0, implicit=implicit,
                source=source, param_path=param_path,
                prefetchable=fsdp, scope=scope_of.get(unit),
                dtype=ev.extra.get("dtype"))
        cost = costs[key]
        site.count += 1
        site.wire_bytes += cost.wire_bytes
        site.dcn_bytes += cost.dcn_bytes
        site.time_us += cost.time_us
    return list(sites.values())


def fsdp_units(ops: Sequence[OpEvent]) -> List[str]:
    """The FSDP units of the stream, in forward order."""
    units: List[str] = []
    for ev in ops:
        for c in ev.context:
            if c.startswith("FSDP::pre_forward ("):
                u = _UNIT.search(c).group("unit")
                if u not in units:
                    units.append(u)
    return units


def overlap_scopes(ops: Sequence[OpEvent], units: Sequence[str]
                   ) -> Dict[int, Dict[str, Any]]:
    """One scope an FSDP unit: the FLOPs of its compute (forward and
    backward) and whether a prefetch (the overlap schedule's marker)
    issued its weight gather."""
    scopes: Dict[int, Dict[str, Any]] = {
        i: {"source": u, "trips": 1, "flops": 0.0, "marker": False}
        for i, u in enumerate(units)}
    idx = {u: i for i, u in enumerate(units)}
    for ev in ops:
        if ev.unit in idx:
            scopes[idx[ev.unit]]["flops"] += ev.flops
        for c in ev.context:
            if c.startswith(("FSDP::forward_prefetch for ",
                             "FSDP::backward_prefetch for ")):
                u = c.split(" for ", 1)[1].strip()
                if u in idx and c.startswith("FSDP::forward_prefetch"):
                    scopes[idx[u]]["marker"] = True
    return scopes


def classify_overlap(
    events: Sequence[CollectiveEvent],
    scopes: Mapping[int, Mapping[str, Any]],
    topo: Topology,
    scheduled: Optional[bool] = None,
) -> Dict[str, Any]:
    """Classify each collective as hidden behind compute or exposed and
    annotate ``events`` in place (``hidden_us``); the JAX model with an
    FSDP unit as the scope. Only prefetchable collectives of a scope are
    hideable; a scope earns credit only when the stream carries the
    prefetch schedule for it (its all-gather issued one unit ahead); the
    window is the scope's FLOPs at the derated peak; per scope the
    hidden fraction is min(1, window / prefetchable comm)."""
    if scheduled is None:
        scheduled = any(s.get("marker") for s in scopes.values())
    for e in events:
        e.hidden_us = 0.0
    per_scope: List[Dict[str, Any]] = []
    for sid in sorted(scopes):
        sc = scopes[sid]
        evs = [e for e in events if e.scope == sid and e.prefetchable]
        if not evs:
            continue
        trips = max(1, int(sc.get("trips", 1)))
        comm = sum(e.time_us for e in evs)
        comm_trip = comm / trips
        window = compute_time_us(float(sc.get("flops", 0.0)), topo)
        frac = 0.0
        if scheduled and sc.get("marker") and comm_trip > 0:
            frac = min(1.0, window / comm_trip)
        for e in evs:
            e.hidden_us = e.time_us * frac
        per_scope.append({
            "source": str(sc.get("source", f"unit#{sid}")),
            "trips": trips,
            "scheduled": bool(sc.get("marker")),
            "compute_us_per_trip": round(window, 1),
            "prefetch_comm_us_per_trip": round(comm_trip, 1),
            "hidden_fraction": round(frac, 4),
        })
    pref = sum(e.time_us for e in events if e.prefetchable)
    hidden = sum(e.hidden_us for e in events)
    total = sum(e.time_us for e in events)
    return {
        "scheduled": bool(scheduled),
        "overlap_hidden_fraction": round(hidden / pref, 4) if pref else 0.0,
        "ici_hidden_us": round(hidden, 1),
        "ici_exposed_us": round(total - hidden, 1),
        "prefetchable_time_us": round(pref, 1),
        "per_scope": per_scope,
    }


def exposed_gathers(ops: Sequence[OpEvent]) -> List[Tuple[str, int]]:
    """RLT305's evidence: (unit, bytes) of each FSDP layer unit whose
    forward all-gather its own pre-forward hook issued (no unit ahead
    prefetched it)."""
    out: List[Tuple[str, int]] = []
    seen = set()
    for ev in ops:
        if ev.kind != "all_gather" or ev.extra.get("phase") != "forward":
            continue
        ctx = [c for c in ev.context if c.startswith("FSDP::")]
        if any(c.startswith("FSDP::forward_prefetch for ") for c in ctx):
            continue
        own = next((c for c in reversed(ctx)
                    if c.startswith("FSDP::pre_forward (")), None)
        if own is None:
            continue  # the root's gather: nothing runs ahead of it
        unit = _UNIT.search(own).group("unit")
        if unit not in seen:
            seen.add(unit)
            out.append((unit, ev.payload_bytes))
    return out


def kernel_calls(ops: Sequence[OpEvent]) -> Dict[str, int]:
    """{``rltt`` kernel operator: calls}, in order of first call (the
    fused QKV + RoPE operator is torch code, not a kernel)."""
    out: Dict[str, int] = {}
    for ev in ops:
        if ev.name.startswith("rltt.") and ev.name != "rltt.qkv_rope":
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


def audit_ops(rec: Recorder, meta: Mapping[str, Any], topo: Topology, *,
              params_bytes: int, opt_bytes: int,
              reserve_fraction: float = 0.10, label: str = "",
              mesh_axes: Optional[Dict[str, int]] = None,
              precision: Optional[Dict[str, Any]] = None) -> TraceReport:
    """The audit of a recorded stream: the collective schedule priced
    on ``topo``, the overlap classification, RLT301/302/305/306, the
    compute window and the peak."""
    ops = rec.events
    sizes = dict(meta.get("mesh_sizes", {}))
    units = fsdp_units(ops)
    events = collective_events(ops, meta.get("groups", {}), sizes, topo,
                               meta.get("named_params", {}), units)
    scopes = overlap_scopes(ops, units)
    overlap = classify_overlap(events, scopes, topo)
    findings: List[Finding] = []
    for e in events:
        if e.implicit and e.param_path is None:
            findings.append(Finding(
                "RLT301",
                f"DTensor redistributes an activation ({e.kind} of "
                f"{_fmt_bytes(e.payload_bytes).strip()} over "
                f"{'x'.join(e.axes) or 'the world'}, x{e.count}): a "
                "reshard the plan never asked for — the module's specs "
                "leave a DTensor's placement for the next operator to "
                "fix", symbol=label or e.source))
    exposed = exposed_gathers(ops) if not overlap["scheduled"] else []
    if exposed:
        # one finding for the schedule, as the JAX walk gives one for
        # the scanned layer body
        names = [u for u, _ in exposed]
        span = names[0] if len(names) == 1 else \
            f"{names[0]} .. {names[-1]} ({len(names)} units)"
        findings.append(Finding(
            "RLT305",
            f"the weight all-gathers of FSDP units {span}, "
            f"{_fmt_bytes(max(b for _, b in exposed)).strip()} each, are "
            "issued by each unit's own pre-forward hook, when its compute "
            "starts: no unit ahead prefetches them — set the strategy's "
            "overlap knob (FSDP/ShardedMesh(overlap='on')) to gather each "
            "behind the previous unit's compute",
            symbol=f"params/{names[0]}"))
    n_devices = int(meta.get("n_devices", topo.n_devices))
    if topo.n_slices > 1 and n_devices == topo.n_devices:
        from ray_lightning_tpu_torch.parallel.plan import dcn_crossing_axes

        for ax, span in sorted(
                dcn_crossing_axes(sizes, topo.n_slices).items()):
            if ax == "data":
                continue
            findings.append(Finding(
                "RLT306",
                f"mesh axis '{ax}' (size {sizes.get(ax)}) spans {span} "
                f"nodes on {topo.name}: its collectives ride InfiniBand "
                f"({topo.dcn_gbps:.1f} GB/s per GPU against "
                f"{topo.ici_gbps:.0f} GB/s NVLink) every step — place "
                f"only `data` across nodes and keep '{ax}' within a node "
                f"(<= {topo.devices_per_slice} GPUs)",
                symbol=label or topo.name))
    peak = int(rec.peak)
    budget = int(topo.hbm_bytes * (1 - reserve_fraction))
    if peak > budget:
        gib = 1024**3
        findings.append(Finding(
            "RLT302",
            f"estimated peak memory {peak / gib:.2f} GiB/device exceeds "
            f"the {topo.device_kind} budget {budget / gib:.2f} GiB "
            f"({topo.hbm_gib:.0f} GiB x {1 - reserve_fraction:.0%} "
            "usable): the step will run out of memory on this topology",
            symbol=label or topo.name))
    flops = sum(ev.flops for ev in ops)
    moved = sum(ev.nbytes for ev in ops)
    # a roofline an operator: its FLOPs at the derated peak or its bytes
    # at the memory rate, whichever is longer, summed over the stream
    compute = sum(max(compute_time_us(ev.flops, topo),
                      memory_time_us(ev.nbytes, topo)) for ev in ops)
    return TraceReport(
        topology=topo,
        mesh_axes=mesh_axes if mesh_axes is not None else
        {k: v for k, v in sizes.items() if v > 1},
        collectives=events, findings=findings,
        params_bytes_per_device=int(params_bytes),
        opt_bytes_per_device=int(opt_bytes),
        peak_hbm_bytes=peak, hbm_budget_bytes=budget, label=label,
        overlap=overlap, kernels=kernel_calls(ops), precision=precision,
        flops=flops, bytes_moved=moved, compute_us=compute)


def audit_step(
    module,
    strategy,
    example_batch: Any,
    *,
    topology="h100-8",
    n_devices: Optional[int] = None,
    reserve_fraction: float = 0.10,
    label: str = "",
    numerics: bool = True,
    device: Any = "cpu",
    traced=None,
) -> TraceReport:
    """Full tracecheck audit: trace the real train step of ``module``
    under ``strategy`` on rank 0 of ``topology`` (a name like "h100-8" or
    a `costmodel.Topology`) and return the `TraceReport`: the kernels
    the step ran, the collective schedule, RLT301/302/305/306, the peak
    against the device's memory, the modelled step. Consumes the
    strategy. ``numerics`` runs numcheck (RLT801-805) over the same
    stream and fills the precision ledger. ``traced`` reuses a
    ``(recorder, meta)`` pair from `trace_step`. A live process group
    other than the trace's own fake one raises (`fake_world`)."""
    topo = (topology if isinstance(topology, Topology)
            else parse_topology(topology))
    if n_devices is None:
        n_devices = topo.n_devices
    label = label or f"{type(module).__name__} {type(strategy).__name__}"
    import copy

    stages = []
    if traced is None and strategy.build_spec(n_devices).resolve(
            n_devices).sizes().get("pipe", 1) > 1:
        # one trace a pipeline stage, for RLT303's pairing; the module and
        # strategy are consumed, so each stage traces its own copies
        stages = [copy.deepcopy((module, strategy)) for _ in range(
            strategy.build_spec(n_devices).resolve(n_devices).sizes()[
                "pipe"] - 1)]
    rec, meta = traced if traced is not None else trace_step(
        module, strategy, n_devices, example_batch, device=device)
    named = meta["named_params"]
    named_opt = meta["named_opt"]
    params_bytes = _storage_bytes(named.values())
    opt_bytes = _storage_bytes(named_opt.values())
    precision = None
    extra: List[Finding] = []
    if numerics:
        from ray_lightning_tpu_torch.analysis import numcheck as _numcheck

        found, info = _numcheck.numcheck_stream(rec.events)
        extra += found
        params_by = _by_dtype(named.values())
        opt_by = _by_dtype(named_opt.values())
        act_by = {dt: b - params_by.get(dt, 0) - opt_by.get(dt, 0)
                  for dt, b in rec.peak_by.items()
                  if b - params_by.get(dt, 0) - opt_by.get(dt, 0) > 0}
        precision = {"params": params_by, "opt_state": opt_by,
                     "activations": act_by, "kv_pool": {},
                     "loss_widest_dtype": info.get("loss_widest_dtype")}
    report = audit_ops(rec, meta, topo, params_bytes=params_bytes,
                       opt_bytes=opt_bytes,
                       reserve_fraction=reserve_fraction, label=label,
                       precision=precision)
    if numerics:
        from ray_lightning_tpu_torch.analysis import numcheck as _numcheck

        extra += _numcheck.check_gradient_collectives(
            report.collectives, named, named_opt)
    if stages:
        report.findings.extend(_pipeline_pairing(
            rec, meta, stages, n_devices, example_batch, device, label))
    report.findings.extend(extra)
    return report


def _shifts(rec: Recorder) -> Tuple[list, list]:
    """A rank's point-to-point sends and receives, in order, as (tag,
    group-local peer)."""
    sends = [(e.extra["tag"], e.extra["peer"]) for e in rec.events
             if e.name == "c10d.send"]
    recvs = [(e.extra["tag"], e.extra["peer"]) for e in rec.events
             if e.name == "c10d.recv_"]
    return sends, recvs


def _pipeline_pairing(rec, meta, stages, n_devices, example_batch, device,
                      label) -> List[Finding]:
    """RLT303 across the pipeline: each stage of rank 0's ``pipe`` group
    traced on its own rank, their send and receive sequences paired
    (`check_shift_schedule`)."""
    ranks = meta.get("members", {}).get("pipe") or list(range(
        len(stages) + 1))
    sends, recvs = {}, {}
    sends[0], recvs[0] = _shifts(rec)
    for i, (mod, strat) in enumerate(stages, start=1):
        r, _ = trace_step(mod, strat, n_devices, example_batch,
                          device=device, rank=ranks[i])
        sends[i], recvs[i] = _shifts(r)
    return check_shift_schedule(sends, recvs, source=label or "pipeline")
