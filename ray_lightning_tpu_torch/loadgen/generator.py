"""Seeded synthetic workload generation (twin of
`ray_lightning_tpu/loadgen/generator.py`: the same draws in the same
order, so the same `WorkloadConfig` gives the JAX package's trace byte
for byte).

Arrival processes (per virtual tick):

* ``poisson`` — homogeneous: arrivals/tick ~ Poisson(``rate``);
* ``mmpp`` — a 2-state Markov-modulated Poisson process: a calm state
  at ``rate`` and a burst state at ``burst_rate``, with geometric
  dwell times (``p_enter_burst`` / ``p_exit_burst``). The bursts are
  what the SLO machinery is FOR — a burst deeper than capacity is the
  overload that sheds best-effort while latency-critical holds its
  TTFT (docs/SERVING.md "traffic & SLO classes").

Lengths are heavy-tailed: prompt length and ``max_new_tokens`` draw
from a bounded Pareto (inverse-CDF transform), so a few long requests
dominate pool pressure the way production traces do — uniform lengths
hide exactly the preemption/shedding behavior this harness exists to
exercise.

Every draw comes from ONE ``np.random.Generator(PCG64(seed))`` in a
fixed order, so the same config yields the byte-identical trace
(`trace.dump_trace` canonical form) on every run — the ``--smoke``
determinism pin.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_lightning_tpu_torch.loadgen.trace import TraceEvent

__all__ = ["WorkloadConfig", "generate_events"]


def _default_mix() -> Dict[str, float]:
    return {"latency_critical": 0.2, "standard": 0.5,
            "best_effort": 0.3}


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Everything the generator draws from, and nothing else — the
    config IS the trace identity (it lands in the trace header's
    ``meta`` so a replayer can see what produced the file)."""

    seed: int = 0
    n_requests: int = 32
    #: "poisson" | "mmpp"
    process: str = "poisson"
    #: mean arrivals per tick (calm state)
    rate: float = 2.0
    #: MMPP burst-state mean arrivals per tick
    burst_rate: float = 8.0
    p_enter_burst: float = 0.1
    p_exit_burst: float = 0.3
    #: bounded-Pareto prompt length: [min, max], tail index alpha
    prompt_len_min: int = 3
    prompt_len_max: int = 24
    prompt_len_alpha: float = 1.5
    #: bounded-Pareto output budget
    max_new_min: int = 4
    max_new_max: int = 32
    max_new_alpha: float = 1.2
    #: traffic-class weights (normalized; keys sorted for determinism)
    class_mix: Optional[Dict[str, float]] = None
    #: fraction of requests using temperature/top-k sampling (the
    #: rest decode greedily — both paths stay on the bitwise oracle)
    sampled_fraction: float = 0.5
    temperature: float = 0.8
    top_k: int = 5
    vocab_size: int = 256
    #: per-request sampling seed = seed_base + index
    seed_base: int = 1000

    def __post_init__(self):
        if self.process not in ("poisson", "mmpp"):
            raise ValueError(
                f"process {self.process!r} not in ('poisson', 'mmpp')")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")

    def mix(self) -> Dict[str, float]:
        from ray_lightning_tpu_torch.serve.scheduler import PRIORITIES

        mix = self.class_mix if self.class_mix is not None \
            else _default_mix()
        bad = sorted(set(mix) - set(PRIORITIES))
        if bad:
            raise ValueError(
                f"class_mix names unknown classes {bad} "
                f"(known: {PRIORITIES})")
        total = float(sum(mix.values()))
        if total <= 0:
            raise ValueError("class_mix weights must sum > 0")
        return {k: v / total for k, v in sorted(mix.items())}

    def meta(self) -> dict:
        d = dataclasses.asdict(self)
        d["class_mix"] = self.mix()
        return d


def _bounded_pareto(u: float, lo: int, hi: int, alpha: float) -> int:
    """Inverse CDF of the Pareto truncated to [lo, hi]."""
    if hi <= lo:
        return lo
    ratio = (lo / hi) ** alpha
    x = lo * (1.0 - u * (1.0 - ratio)) ** (-1.0 / alpha)
    return int(min(hi, max(lo, x)))


def generate_events(cfg: WorkloadConfig) -> List[TraceEvent]:
    """The deterministic draw loop. The rng consumption ORDER is part
    of the format contract: per tick one arrival-count draw (plus one
    state draw under mmpp), then per request priority, prompt length,
    prompt tokens, output budget, sampling coin."""
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    mix = cfg.mix()
    classes: Tuple[str, ...] = tuple(mix)
    weights = np.asarray([mix[c] for c in classes], np.float64)
    events: List[TraceEvent] = []
    tick = 0
    burst = False
    while len(events) < cfg.n_requests:
        if cfg.process == "mmpp":
            # geometric state dwell: one transition draw per tick
            flip = float(rng.random())
            burst = (flip < cfg.p_enter_burst) if not burst \
                else (flip >= cfg.p_exit_burst)
            lam = cfg.burst_rate if burst else cfg.rate
        else:
            lam = cfg.rate
        n = int(rng.poisson(lam))
        for _ in range(min(n, cfg.n_requests - len(events))):
            i = len(events)
            priority = classes[int(rng.choice(len(classes),
                                              p=weights))]
            plen = _bounded_pareto(float(rng.random()),
                                   cfg.prompt_len_min,
                                   cfg.prompt_len_max,
                                   cfg.prompt_len_alpha)
            prompt = tuple(int(t) for t in rng.integers(
                0, cfg.vocab_size, size=plen))
            max_new = _bounded_pareto(float(rng.random()),
                                      cfg.max_new_min,
                                      cfg.max_new_max,
                                      cfg.max_new_alpha)
            sampled = float(rng.random()) < cfg.sampled_fraction
            events.append(TraceEvent(
                tick=tick, rid=f"lg{i:04d}", prompt=prompt,
                max_new_tokens=max_new, priority=priority,
                temperature=cfg.temperature if sampled else 0.0,
                top_k=cfg.top_k if sampled else None,
                seed=cfg.seed_base + i))
        tick += 1
    return events
