"""Pre-flight memory planner (twin of `ray_lightning_tpu/parallel/plan.py`):
prove a training configuration fits the card BEFORE allocating it.

  * parameter, optimizer-state and gradient bytes are computed EXACTLY:
    the model is built on ``torch.device("meta")`` (the twin of
    `jax.eval_shape`: shapes and dtypes, no storage), and each rank's
    part of each parameter comes from the strategy's own placement rule
    (`Strategy.planned_shard`, the code `wrap_model` lays the shards out
    with) over a shape-only mesh (axis sizes, no process group). That
    includes FSDP2's ``Shard(0)`` with its ceil-padded storage where the
    JAX rule replicates a leaf. The optimizer's bytes are what torch's
    fused AdamW holds after its first step: two moments shaped and
    sharded like the parameters, and one f32 ``step`` scalar a
    parameter;
  * activations are an analytic bound (`llama_activation_bytes`, the JAX
    formula unchanged).

The planner runs on the meta device by design: it never touches the card
or a process group (``torch.cuda.is_initialized()`` stays False), so it
answers "does this fit?" on a host whose card is busy or absent::

    plan = plan_train_memory(
        LlamaModule(LlamaConfig.llama3_8b(n_layers=4)), SingleDevice(),
        n_devices=1, example_batch={"tokens": np.zeros((2, 2049))},
        activation_bytes_per_device=llama_activation_bytes(cfg, 2, 2048))
    assert plan.fits, plan.summary()

The TPU rows of the HBM table are the JAX package's, so its plans can be
held equal; the card's row is the H100's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from ray_lightning_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

#: the card's kind, as `torch.cuda.get_device_name()` spells it
H100_KIND = "NVIDIA H100 80GB HBM3"

#: usable memory per device, by device kind. The TPU rows are the JAX
#: package's (public spec sheets); the H100's is 79 GiB, under the
#: 85,017,755,648 bytes (79.18 GiB) that torch reports as the card's
#: ``total_memory``
HBM_BYTES_BY_KIND: Dict[str, int] = {
    "TPU v3": 16 * 1024**3,
    "TPU v4": 32 * 1024**3,
    "TPU v5 lite": 16 * 1024**3,
    "TPU v5e": 16 * 1024**3,
    "TPU v5": 95 * 1024**3,
    "TPU v5p": 95 * 1024**3,
    "TPU v6 lite": 32 * 1024**3,
    "TPU v6e": 32 * 1024**3,
    H100_KIND: 79 * 1024**3,
}


def hbm_bytes_for_kind(device_kind: str,
                       hbm_bytes: Optional[int] = None) -> int:
    """Usable memory per device for ``device_kind`` — or the explicit
    ``hbm_bytes`` override for hardware the table doesn't know. An
    unknown kind without an override raises a ValueError LISTING the
    known kinds (never a bare KeyError)."""
    if hbm_bytes is not None:
        if hbm_bytes <= 0:
            raise ValueError(f"hbm_bytes must be positive, got {hbm_bytes}")
        return int(hbm_bytes)
    if device_kind not in HBM_BYTES_BY_KIND:
        raise ValueError(
            f"unknown device_kind {device_kind!r} (known: "
            f"{sorted(HBM_BYTES_BY_KIND)}); pass hbm_bytes_per_device= "
            "(plan_train_memory) / hbm_bytes= (this helper; CLI "
            "--hbm-bytes) explicitly for other hardware"
        )
    return HBM_BYTES_BY_KIND[device_kind]


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    mesh_axes: Dict[str, int]
    n_devices: int
    hbm_bytes_per_device: int
    params_bytes_global: int
    opt_bytes_global: int
    params_bytes_per_device: int
    opt_bytes_per_device: int
    grads_bytes_per_device: int
    activation_bytes_per_device: int
    #: fraction of the memory the plan refuses to allocate (the caching
    #: allocator's fragmentation, library workspaces)
    reserve_fraction: float = 0.10

    @property
    def per_device_total(self) -> int:
        return (self.params_bytes_per_device + self.opt_bytes_per_device
                + self.grads_bytes_per_device
                + self.activation_bytes_per_device)

    @property
    def budget(self) -> int:
        return int(self.hbm_bytes_per_device * (1 - self.reserve_fraction))

    @property
    def fits(self) -> bool:
        return self.per_device_total <= self.budget

    @property
    def headroom_bytes(self) -> int:
        return self.budget - self.per_device_total

    def summary(self) -> str:
        gib = 1024**3
        return (
            f"mesh {self.mesh_axes} x{self.n_devices} devices: "
            f"params {self.params_bytes_per_device / gib:.2f} + "
            f"opt {self.opt_bytes_per_device / gib:.2f} + "
            f"grads {self.grads_bytes_per_device / gib:.2f} + "
            f"acts {self.activation_bytes_per_device / gib:.2f} = "
            f"{self.per_device_total / gib:.2f} GiB/device vs budget "
            f"{self.budget / gib:.2f} GiB "
            f"({'FITS' if self.fits else 'DOES NOT FIT'}; global params "
            f"{self.params_bytes_global / gib:.2f} GiB, opt "
            f"{self.opt_bytes_global / gib:.2f} GiB)"
        )


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def optimizer_state_bytes(optimizer, shapes: Mapping[int, tuple]) -> int:
    """The device bytes ``optimizer`` holds after its first step, for
    parameters of the given (per-device) shapes, keyed by ``id(param)``:
    Adam and AdamW keep two moments (three with amsgrad) shaped like each
    parameter and, fused or capturable, an f32 ``step`` scalar on the
    device (else on the host). Other optimizers raise."""
    total = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            n = _nbytes(shapes[id(p)], p.dtype)
            if not isinstance(optimizer, (torch.optim.Adam,
                                          torch.optim.AdamW)):
                raise NotImplementedError(
                    f"the planner counts Adam and AdamW state, not "
                    f"{type(optimizer).__name__}")
            total += n * (3 if group.get("amsgrad") else 2)
            if group.get("fused") or group.get("capturable"):
                total += torch.float32.itemsize
    return total


def plan_train_memory(
    module,
    strategy,
    n_devices: int,
    example_batch: Any,
    *,
    activation_bytes_per_device: int = 0,
    device_kind: str = H100_KIND,
    hbm_bytes_per_device: Optional[int] = None,
    reserve_fraction: float = 0.10,
) -> MemoryPlan:
    """Exact per-device parameter/optimizer/gradient bytes for ``module``
    trained under ``strategy`` on ``n_devices``, plus the caller's
    activation estimate.

    Builds NOTHING on a device: the model exists on the meta device, the
    strategy is laid on a shape-only mesh (`Strategy.shape_only`) and
    each parameter's part is its `planned_shard`, the layout
    `wrap_model` gives it. Gradients are counted at the parameters'
    size, as the JAX planner counts them. ``example_batch`` is accepted
    for the JAX signature (the port's shapes do not depend on it). The
    ``strategy`` and ``module`` are consumed: pass fresh ones, not those a
    Trainer will use."""
    del example_batch
    strategy.shape_only(n_devices, module)
    spec = strategy.spec
    strategy.bind_module(module)
    module.device = torch.device("meta")
    module.setup()
    model = module.model
    named = dict(model.named_parameters())
    local: Dict[int, tuple] = {}
    params_dev = 0
    for name, p in named.items():
        storage, shape = strategy.planned_shard(name, tuple(p.shape))
        local[id(p)] = shape
        params_dev += _nbytes(storage, p.dtype)
    # the optimizer over the meta parameters (its tensor lr on the host:
    # nothing lands on the card)
    module.device = torch.device("cpu")
    out = module.configure_optimizers()
    opt = out[0] if isinstance(out, tuple) else out
    full = {id(p): tuple(p.shape) for p in named.values()}
    hbm_bytes_per_device = hbm_bytes_for_kind(
        device_kind, hbm_bytes_per_device)
    return MemoryPlan(
        mesh_axes={k: v for k, v in spec.sizes().items() if v > 1},
        n_devices=n_devices,
        hbm_bytes_per_device=hbm_bytes_per_device,
        params_bytes_global=sum(_nbytes(p.shape, p.dtype)
                                for p in named.values()),
        opt_bytes_global=optimizer_state_bytes(opt, full),
        params_bytes_per_device=params_dev,
        opt_bytes_per_device=optimizer_state_bytes(opt, local),
        grads_bytes_per_device=params_dev,
        activation_bytes_per_device=activation_bytes_per_device,
        reserve_fraction=reserve_fraction,
    )


def llama_activation_bytes(cfg, local_batch: int, seq: int,
                           weight_shard_degree: int = 1) -> int:
    """Activation-footprint bound for the flagship train step (the JAX
    formula, unchanged) — remat (policy "nothing") + the fused CE:

      * saved residuals: each block's input, L x [B, S, D] bf16;
      * one layer's live recompute set during its backward: qkv
        [B,S,(H+2Hkv)hd], two norms / residual adds [B,S,D] each, and the
        SwiGLU pair [B,S,3F], with gradient buffers alongside — 2x;
      * loss tail: embedding output + final hidden [B,S,D] (bf16 + f32
        copy) and the fused-CE live tile, chunk x V logits x2;
      * ce_inline_bwd adds its residuals: dx [B·S, D] and the f32 dW
        accumulator [D, V] / ``weight_shard_degree``;
      * 1.5x slack for allocator fragmentation and temporaries.

    Deliberately an over-estimate; exactness lives in the params/opt
    terms."""
    bs = local_batch * seq
    hd = cfg.head_dim
    saved = cfg.n_layers * bs * cfg.dim * 2
    if (getattr(cfg, "remat", True)
            and getattr(cfg, "remat_policy", "nothing") == "attn_out"):
        elem = cfg.dtype.itemsize if getattr(
            cfg, "dtype", None) is not None else 2
        saved += cfg.n_layers * bs * (
            (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd * elem
            + cfg.n_heads * 4)
    live = bs * (
        2 * cfg.dim
        + (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        + 3 * cfg.hidden_dim
    ) * 2 * 2
    ce = (cfg.ce_chunk_tokens * cfg.vocab_size * 2 * 2
          + bs * cfg.dim * (2 + 4))
    if getattr(cfg, "ce_inline_bwd", False):
        ce += (cfg.ce_chunk_tokens * cfg.vocab_size * 2
               + bs * cfg.dim * 2
               + cfg.dim * cfg.vocab_size * 4 // max(1, weight_shard_degree))
    return int(1.5 * (saved + live + ce))


def llama_overlap_buffer_bytes(cfg, fsdp: int = 1, tensor: int = 1,
                               mode: str = "on") -> int:
    """Extra per-device bytes FSDP2's prefetch holds under ``overlap=``
    beyond the default schedule (`parallel.strategy.FSDP`):

      * ``"on"``: ONE extra unit gathered over ``fsdp`` (the next block's
        weights, still split over ``tensor``; f32 masters), plus the
        in-flight gradient shard of the block being reduce-scattered;
      * ``"serial"``: the in-flight gradient shard only;
      * ``"off"``, ``fsdp == 1`` or fewer than two blocks: 0.

    The JAX schedule also holds a rolled copy of the stacked layer
    weights (a scan artifact, one layer-stack shard); the port has no
    scan, so its value is JAX's less that term."""
    if mode == "off" or fsdp <= 1 or cfg.n_layers < 2:
        return 0
    d, f, hd = cfg.dim, cfg.hidden_dim, cfg.head_dim
    layer_params = (
        d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd   # wqkv
        + cfg.n_heads * hd * d                        # wo
        + d * 2 * f                                   # w_gate_up
        + f * d                                       # w_down
        + 2 * d                                       # the two norm gains
    )
    layer_bytes = layer_params * 4  # the masters are f32
    gathered = layer_bytes // max(1, tensor)
    shard = layer_bytes // max(1, fsdp * tensor)
    if mode == "serial":
        return int(shard)
    return int(gathered + shard)


def find_max_local_batch(
    module,
    strategy,
    n_devices: int,
    example_batch: Any,
    activation_bytes_fn,
    *,
    device_kind: str = H100_KIND,
    hbm_bytes_per_device: Optional[int] = None,
    reserve_fraction: float = 0.10,
    ceiling: int = 65536,
) -> tuple:
    """Largest per-device batch that fits, found at plan time (PTL's
    ``auto_scale_batch_size`` without an OOM probe): the weight-side
    costs are planned once and the analytic activation bound is
    binary-searched against the remaining memory. Nothing touched.

    ``activation_bytes_fn(local_batch) -> int`` must be monotone
    non-decreasing. Returns ``(local_batch, plan)`` where ``plan``
    charges the found batch's activations; ``(0, plan)`` with the
    activation-free plan when even ``local_batch=1`` does not fit. The
    global batch is ``local_batch * dp_degree(spec)``."""
    base = plan_train_memory(
        module, strategy, n_devices, example_batch,
        activation_bytes_per_device=0, device_kind=device_kind,
        hbm_bytes_per_device=hbm_bytes_per_device,
        reserve_fraction=reserve_fraction,
    )
    avail = base.headroom_bytes

    def fits(b: int) -> bool:
        return activation_bytes_fn(b) <= avail

    if not fits(1):
        return 0, base
    lo, hi = 1, 2
    while hi <= ceiling and fits(hi):
        lo, hi = hi, hi * 2
    hi = min(hi, ceiling + 1)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    best = dataclasses.replace(
        base, activation_bytes_per_device=int(activation_bytes_fn(lo)))
    return lo, best


# ---- multi-slice layout queries (the JAX package's, unchanged) -------------


def group_dcn_span(axes: Sequence[str], mesh_sizes: Mapping[str, int],
                   n_slices: int) -> int:
    """Number of distinct slices a collective group varying exactly
    ``axes`` touches (1 = the group lives inside one slice), from the
    mixed-radix AXIS_ORDER-major layout with slice-major device order."""
    sizes = {ax: int(mesh_sizes.get(ax, 1)) for ax in AXIS_ORDER}
    total = math.prod(sizes.values())
    if n_slices <= 1 or total % n_slices:
        return 1
    per_slice = total // n_slices
    strides: Dict[str, int] = {}
    st = 1
    for ax in reversed(AXIS_ORDER):
        strides[ax] = st
        st *= sizes[ax]
    group_axes = [ax for ax in AXIS_ORDER
                  if ax in tuple(axes) and sizes[ax] > 1]
    members = {0}
    for ax in group_axes:
        members = {
            base + k * strides[ax]
            for base in members for k in range(sizes[ax])
        }
    return len({idx // per_slice for idx in members})


def dcn_crossing_axes(mesh_sizes: Mapping[str, int],
                      n_slices: int) -> Dict[str, int]:
    """Per non-trivial mesh axis: how many slices a group varying only
    that axis spans (entries only for axes that DO cross, span > 1)."""
    out: Dict[str, int] = {}
    for ax in AXIS_ORDER:
        if int(mesh_sizes.get(ax, 1)) <= 1:
            continue
        span = group_dcn_span((ax,), mesh_sizes, n_slices)
        if span > 1:
            out[ax] = span
    return out


def dp_degree(spec: MeshSpec) -> int:
    """Batch divisor of a spec (mirrors `mesh.dp_axis_names`). Requires a
    RESOLVED spec — a -1 wildcard would silently undercount."""
    sizes = spec.sizes()
    if any(s == -1 for s in sizes.values()):
        raise ValueError(
            f"dp_degree needs a resolved spec (call spec.resolve(n) "
            f"first); got {sizes}"
        )
    return math.prod(sizes[ax] for ax in ("data", "fsdp", "expert"))
