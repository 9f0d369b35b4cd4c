"""Structural checks of one sharding spec (the port's copy of
`ray_lightning_tpu/analysis/plan_checker.py`'s `spec_entries` and
`spec_findings`, with the `Finding` fields and the four rules they use).

`parallel.strategy.ShardedMesh` runs them on every composed spec and
raises on an error, so a typo'd axis or an uneven split fails at setup
with the leaf's name, as the JAX strategies do. A spec is a tuple of
per-dimension entries: None, an axis name, or a tuple of axis names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: rule id -> (name, severity), the JAX registry's rows for these checks
RULES: Dict[str, Tuple[str, str]] = {
    "RLT101": ("unknown-mesh-axis", "error"),
    "RLT102": ("uneven-shard", "error"),
    "RLT103": ("duplicate-mesh-axis", "error"),
    "RLT104": ("spec-rank-mismatch", "error"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect at a parameter (``symbol``)."""

    rule: str
    message: str
    symbol: Optional[str] = None

    @property
    def severity(self) -> str:
        return RULES[self.rule][1]

    def format(self) -> str:
        loc = f"{self.symbol}: " if self.symbol is not None else ""
        return (f"{loc}{self.severity} {self.rule} "
                f"({RULES[self.rule][0]}): {self.message}")


def spec_entries(spec) -> List[Tuple[int, Tuple[str, ...]]]:
    """Flatten a spec into (dim_index, axis_names) pairs; unsharded dims
    yield empty tuples."""
    out: List[Tuple[int, Tuple[str, ...]]] = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None:
            out.append((i, ()))
        elif isinstance(entry, (tuple, list)):
            out.append((i, tuple(entry)))
        else:
            out.append((i, (entry,)))
    return out


def spec_findings(spec, shape: Sequence[int], mesh_sizes: Mapping[str, int],
                  *, path: str = "<leaf>") -> List[Finding]:
    """Validate ONE spec against one leaf shape and a mesh: unknown axes
    (RLT101), duplicate axes (RLT103), rank overflow (RLT104), uneven
    shard dims (RLT102)."""
    findings: List[Finding] = []
    entries = spec_entries(spec)
    seen: Dict[str, int] = {}
    for i, names in entries:
        for ax in names:
            if ax not in mesh_sizes:
                findings.append(Finding(
                    "RLT101",
                    f"spec for {path} names mesh axis {ax!r} which does "
                    f"not exist (mesh axes: {sorted(mesh_sizes)}); the "
                    "composition logic would silently drop it and "
                    "replicate the leaf", symbol=path))
            if ax in seen:
                findings.append(Finding(
                    "RLT103",
                    f"spec for {path} uses mesh axis {ax!r} on dims "
                    f"{seen[ax]} and {i}; an axis can shard at most one "
                    "dim", symbol=path))
            seen.setdefault(ax, i)
    rank = len(shape)
    if len(entries) > rank:
        findings.append(Finding(
            "RLT104",
            f"spec for {path} has {len(entries)} entries but the leaf "
            f"has rank {rank} (shape {tuple(shape)})", symbol=path))
        return findings
    for i, names in entries:
        divisor = math.prod(mesh_sizes.get(ax, 1) for ax in names)
        if divisor > 1 and shape[i] % divisor != 0:
            findings.append(Finding(
                "RLT102",
                f"dim {i} of {path} (size {shape[i]}, shape "
                f"{tuple(shape)}) cannot be partitioned evenly by "
                f"{'x'.join(names)} (={divisor})", symbol=path))
    return findings
