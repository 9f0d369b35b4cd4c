"""Evidence for the FSDP all-gather overlap schedule (twin of
`ray_lightning_tpu/pipeline/collective_overlap.py`).

The perf CLI's overlap leg proves the schedule two ways:

  1. **Structurally, on the real model** (`check_overlap_schedule`): a
     tiny Llama wrapped by ``FSDP(overlap=...)`` in a one-rank process
     group, its units' explicit prefetch lists read back: under ``"on"``
     unit i's forward list names unit i+1, under ``"serial"`` and
     ``"off"`` no forward list names anything. The JAX package proves
     this with tracecheck over the jaxpr (`trace_overlap_schedule`),
     which the port has not yet (ROADMAP Queue 1 item 13).

  2. **A throttled interleave** (`simulate_overlap_schedule`): the same
     double-buffer discipline run on the host with a fake collective (a
     timed sleep on a thread, standing in for the copy engine) against
     real torch matmuls. The serial schedule pays gather + compute a
     layer, the double-buffered one max(gather, compute) after the
     prologue: the measured speedup converges to
     ``(t_g + t_c) / max(t_g, t_c)``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict

__all__ = ["trace_overlap_schedule", "check_overlap_schedule",
           "simulate_overlap_schedule", "measure_collective_overlap"]


def trace_overlap_schedule(n_devices: int = 8) -> Dict[str, Any]:
    """The JAX proof walks the traced program with tracecheck, which is
    not ported; `check_overlap_schedule` reads the schedule instead."""
    raise NotImplementedError(
        "trace_overlap_schedule needs tracecheck, which is not ported yet "
        "(ROADMAP Queue 1 item 13); check_overlap_schedule reads the FSDP "
        "strategy's prefetch lists instead")


def _schedule(overlap: str, device: Any) -> Dict[str, list]:
    """The explicit prefetch lists of a tiny Llama's FSDP units."""
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import FSDP

    strategy = FSDP(device=device, overlap=overlap)
    module = LlamaModule(LlamaConfig.tiny(n_layers=4))
    try:
        strategy.setup(module)
        module.setup()
        strategy.wrap_model(module.model)
        return strategy.overlap_schedule()
    finally:
        strategy.teardown()


def check_overlap_schedule(device: Any = None) -> Dict[str, Any]:
    """The structural verdict over ``"on"``, ``"serial"`` and ``"off"``
    (``device``: None is the card)."""
    sched = {o: _schedule(o, device) for o in ("on", "serial", "off")}
    on = sched["on"]["forward"]
    n = len(on)
    chained = n > 1 and all(on[i] == [i + 1] for i in range(n - 1))
    return {
        "units": n,
        "forward_on": on,
        "backward_on": sched["on"]["backward"],
        "forward_serial": sched["serial"]["forward"],
        "backward_serial": sched["serial"]["backward"],
        "scheduled": chained,
        "serial_scheduled": any(sched["serial"]["forward"]),
        "off_scheduled": any(sched["off"]["forward"]),
    }


def simulate_overlap_schedule(n_layers: int = 8, t_comm_s: float = 0.02,
                              compute_ms_target: float = 20.0,
                              device: Any = None,
                              repeats: int = 3) -> Dict[str, Any]:
    """Run the double-buffer discipline on the host: a throttled fake
    collective (a sleep on a thread) against torch matmuls on ``device``
    (None: the card).

        serial:      for i: gather(i); compute(i)
        overlapped:  gather(0); for i: start gather(i+1); compute(i); join

    ``ideal_speedup`` is the roofline ``(t_g + t_c) / max(t_g, t_c)`` the
    schedule converges to as ``n_layers`` grows. Each time is the least
    of ``repeats`` runs, so a busy host's spikes do not decide it."""
    import torch

    from ray_lightning_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    n = 256
    x = torch.ones((n, n), dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def mm():
        torch.mm(x, x)
        sync()

    loops = 1

    def compute():
        for _ in range(loops):
            mm()

    # a matmul chain whose wall time is near the target: a first guess
    # from single products, then scaled by one timed chain
    mm()
    target = compute_ms_target / 1e3
    loops = max(1, int(target / max(min(timed(mm) for _ in range(3)),
                                    1e-6)))
    loops = max(1, round(loops * target / max(timed(compute), 1e-6)))

    def fake_gather():
        time.sleep(t_comm_s)

    def serial():
        for _ in range(n_layers):
            fake_gather()
            compute()

    def overlapped():
        fake_gather()  # the prologue: layer 0's gather is exposed
        for i in range(n_layers):
            th = None
            if i + 1 < n_layers:
                # layer i+1's gather is issued BEFORE layer i's compute
                th = threading.Thread(target=fake_gather)
                th.start()
            compute()
            if th is not None:
                th.join()

    t_c = serial_s = overlapped_s = float("inf")
    for _ in range(max(1, repeats)):
        t_c = min(t_c, timed(compute))
        serial_s = min(serial_s, timed(serial))
        overlapped_s = min(overlapped_s, timed(overlapped))

    ideal = (t_comm_s + t_c) / max(t_comm_s, t_c)
    return {
        "n_layers": n_layers,
        "t_comm_ms": round(t_comm_s * 1e3, 2),
        "t_compute_ms": round(t_c * 1e3, 2),
        "serial_s": round(serial_s, 4),
        "overlapped_s": round(overlapped_s, 4),
        "overlap_speedup": round(serial_s / max(overlapped_s, 1e-9), 3),
        "ideal_speedup": round(ideal, 3),
    }


def measure_collective_overlap(n_layers: int = 8, t_comm_s: float = 0.02,
                               device: Any = None) -> Dict[str, Any]:
    """The perf CLI's overlap leg: the structural check and the throttled
    interleave, one dict."""
    out: Dict[str, Any] = {}
    check = check_overlap_schedule(device)
    out["overlap_schedule"] = check
    out.update(simulate_overlap_schedule(n_layers=n_layers,
                                         t_comm_s=t_comm_s, device=device))
    out["overlap_schedule_ok"] = bool(
        check["scheduled"] and not check["serial_scheduled"]
        and not check["off_scheduled"])
    return out
