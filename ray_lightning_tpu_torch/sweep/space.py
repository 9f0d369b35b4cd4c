"""Search-space primitives and config sampling for HPO sweeps (twin of
`ray_lightning_tpu/sweep/space.py`, kept as the port's own copy).

The reference delegated search spaces to Ray Tune (``tune.choice`` /
``tune.loguniform`` / ``tune.grid_search`` used in its examples,
reference examples/ray_ddp_example.py:95-99, ray_ddp_tune.py:90-94).
A space is a plain dict whose leaves may be samplers; ``expand()`` turns
it into the concrete trial-config list: grid entries cross-product,
samplers draw per sample from numpy's ``default_rng(seed)`` in the JAX
package's order, so both packages give the same configs for one seed.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np


class Sampler:
    """A randomly-drawn hyperparameter leaf."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


@dataclass(frozen=True)
class Choice(Sampler):
    values: tuple

    def sample(self, rng: np.random.Generator) -> Any:
        return self.values[int(rng.integers(0, len(self.values)))]


@dataclass(frozen=True)
class Uniform(Sampler):
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.low, self.high))


@dataclass(frozen=True)
class LogUniform(Sampler):
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclass(frozen=True)
class RandInt(Sampler):
    low: int
    high: int  # exclusive, numpy convention

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.low, self.high))


@dataclass(frozen=True)
class GridSearch:
    """Exhaustive axis: the config list is the cross-product of all grid
    axes, repeated ``num_samples`` times (Ray Tune semantics)."""

    values: tuple


def choice(values: Sequence[Any]) -> Choice:
    return Choice(tuple(values))


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(tuple(values))


def expand(
    space: Dict[str, Any], num_samples: int = 1, seed: int = 0
) -> List[Dict[str, Any]]:
    """Materialize a space into concrete trial configs.

    Count = (product of grid axis lengths) x num_samples; sampler leaves
    are drawn independently per config; plain values pass through.
    """
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    grid_axes = [space[k].values for k in grid_keys]
    rng = np.random.default_rng(seed)

    configs: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in itertools.product(*grid_axes) if grid_keys else [()]:
            cfg: Dict[str, Any] = {}
            for k, v in space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Sampler):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    return configs
