"""Hand-written Hopper kernels, one module per kernel: the wrapper (which
launches the kernel on CUDA tensors and counts its launches), the plain
PyTorch version the wrapper runs on CPU tensors, and the shape gate."""


def launch_counts() -> dict:
    """``{wrapper name: kernel launches since its counter was last reset}``
    for every hand-written kernel of this process (a wrapper counts its
    own launches on the card; every count stays 0 on the CPU)."""
    from ray_lightning_tpu_torch.ops.kernels import (
        adamw,
        flash,
        paged_attention,
        paged_prefill,
        rmsnorm,
    )

    return {fn.__name__: fn.launches for fn in (
        paged_attention.paged_attention_kernel,
        paged_prefill.paged_prefill_kernel, rmsnorm.rms_norm_kernel,
        flash.flash_fwd_kernel, flash.flash_bwd_dkv_kernel,
        flash.flash_bwd_dq_kernel, adamw.adamw_step_kernel)}
