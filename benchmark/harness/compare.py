"""The numbers that decide `correct`, each beside its limit."""

from __future__ import annotations

import math
import statistics

import torch


def scaled_gap(a: torch.Tensor, b: torch.Tensor, scale) -> float:
    """max |a - b| / scale (scale broadcasts against the last axis)."""
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs() / torch.as_tensor(scale, dtype=torch.float64,
                                                            device=a.device)
    return float(d.max())


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / (1 + |b|): relative where b is large, absolute near 0."""
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def change_gap(pre: dict, got: dict, ref: dict, keys) -> float:
    """The worst leaf's |got - ref| over the reference's change of that leaf,
    |ref - pre|, or the median leaf's change where that is larger (norms
    over the leaf). Leaves that the reference moves by under a thousandth
    of the median leaf's change are left out: their change is rounding."""
    moved = {k: float((ref[k].double() - pre[k].double()).norm()) for k in keys}
    med = statistics.median(moved.values())
    gaps = [float((got[k].double() - ref[k].double()).norm()) / max(moved[k], med)
            for k in keys if moved[k] > 0.0 and moved[k] >= 1e-3 * med]
    return max(gaps, default=0.0)


class Checks:
    """Named readings with their limits; `correct` when every reading is
    finite and at or under its limit."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = max(float(value), self.values.get(name, -math.inf))

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits)
                and all(math.isfinite(v) and v <= self.limits[n] for n, v in self.values.items()))

    def as_dict(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": lim} for n, lim in self.limits.items()}

    def lines(self) -> list:
        return [f"check {n}: {self.values.get(n)!r} (limit {lim!r})"
                for n, lim in self.limits.items()]
