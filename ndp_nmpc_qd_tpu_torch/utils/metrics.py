"""Observability: latency histograms, solve-health counters, profiler hooks.

Port of `ndp_nmpc_qd_tpu/utils/metrics.py`. The reference's observability is
a per-tick overrun warning (`nmpc_node.py:216-220`), throttled logging and
offline rosbag analysis. Here:

- `LatencyRecorder`: wall-clock per-step latencies with a p50/p90/p99
  summary and the overrun count against the 20 ms budget.
- `HealthCounter`: running counts of per-scenario solver health flags.
- `trace`: `torch.profiler` (CPU and CUDA activities) around a code region,
  writing a Chrome trace into `log_dir`.

The two counters are the JAX package's, numpy as they are, so the same
samples give the same summary in both packages.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class LatencyRecorder:
    budget_s: float = 0.02  # the reference's real-time budget (ts_nmpc)
    samples: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def record(self, seconds: float):
        self.samples.append(seconds)

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        a = np.sort(np.asarray(self.samples))
        pct = lambda q: float(a[min(len(a) - 1, int(len(a) * q))])
        return {
            "count": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": pct(0.50) * 1e3,
            "p90_ms": pct(0.90) * 1e3,
            "p99_ms": pct(0.99) * 1e3,
            "max_ms": float(a[-1] * 1e3),
            "overruns": int(np.sum(a > self.budget_s)),
            "budget_ms": self.budget_s * 1e3,
        }


@dataclass
class HealthCounter:
    total: int = 0
    unhealthy: int = 0
    consecutive_unhealthy: int = 0
    worst_streak: int = 0

    def update(self, ok_flags) -> None:
        ok = np.asarray(ok_flags)
        self.total += ok.size
        bad = int(ok.size - ok.sum())
        self.unhealthy += bad
        if bad:
            self.consecutive_unhealthy += 1
            self.worst_streak = max(self.worst_streak, self.consecutive_unhealthy)
        else:
            self.consecutive_unhealthy = 0

    def summary(self) -> dict:
        return {
            "solves": self.total,
            "unhealthy": self.unhealthy,
            "unhealthy_rate": self.unhealthy / max(self.total, 1),
            "worst_streak": self.worst_streak,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a code region with `torch.profiler` (the CPU, and the card
    where there is one) and write its Chrome trace to
    `log_dir/trace.json`. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
