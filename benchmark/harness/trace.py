"""Reading a profiler trace: kernels on the device clock, the host spans
the benchmark records around its calls into each layer, and the
arithmetic that turns them into per-layer numbers.

The trace is the profiler's Chrome trace (`torch.profiler`, CPU and CUDA
activities). A device event (`kernel`, `gpu_memcpy`, `gpu_memset`) carries
the correlation id of the host call that launched it (`cuda_runtime` or
`cuda_driver`); a span is a `user_annotation` event of the benchmark's own
`record_function`. A kernel belongs to every span whose host interval holds
its launch. Every kernel falls in exactly one bucket by its name; idle is
the traced window less the union of the kernels' intervals.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
TICK = "tick"  # the span around one whole tick of a traced stretch

# the port's hand-written CUDA kernels, by the names their sources give them
PORT_KERNELS = {
    "step_whole_kernel": "step_whole_kernel",  # K1
    "ipm_whole_kernel": "ipm_kernel",  # K2
    "linearize_kernel": "linearize_kernel",  # K3
    "riccati_": "ipm_kernel",  # K4-K9
}
NCCL_MARKS = ("nccl",)
GEMM_MARKS = ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet", "splitkreduce")
COPY_MARKS = ("copy", "memcpy", "transpose", "catarray")
GLUE_MARKS = ("elementwise", "reduce", "index", "scatter", "gather", "fill", "memset",
              "at::native", "at_cuda_detail", "cub::", "sort", "scan")
BUCKETS = ("step_whole_kernel", "ipm_kernel", "linearize_kernel", "nccl", "gemm",
           "layout_copies", "torch_glue", "other")


def bucket_of(name: str) -> str:
    """The one bucket of a device event, by its name."""
    n = name.lower()
    for mark, bucket in PORT_KERNELS.items():
        if mark in n:
            return bucket
    for marks, bucket in ((NCCL_MARKS, "nccl"), (GEMM_MARKS, "gemm"),
                          (COPY_MARKS, "layout_copies"), (GLUE_MARKS, "torch_glue")):
        if any(k in n for k in marks):
            return bucket
    return "other"


def is_port_kernel(name: str) -> bool:
    return bucket_of(name) in ("step_whole_kernel", "ipm_kernel", "linearize_kernel")


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclass
class Kernel:
    name: str
    start: float  # us, the trace's clock
    end: float
    corr: int | None
    launch: float | None = None  # host time of its launch, where the trace has it


@dataclass
class Trace:
    """One traced stretch of `n_ticks` ticks: its kernels and spans (us)."""

    kernels: list
    spans: list  # (name, start, end) on the host
    n_ticks: int
    window: tuple = field(default=(0.0, 0.0))

    @classmethod
    def from_events(cls, events, n_ticks: int) -> "Trace":
        launches, kernels, spans = {}, [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, args = ev.get("cat", ""), ev.get("args") or {}
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                if dur > 0:
                    kernels.append(Kernel(ev["name"], ts, ts + dur, args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat == SPAN_CAT:
                spans.append((ev["name"], ts, ts + dur))
        for k in kernels:
            k.launch = launches.get(k.corr)
        ticks = [s for s in spans if s[0] == TICK]
        if ticks:
            start = min(s for _, s, _ in ticks)
            end = max([e for _, _, e in ticks] + [k.end for k in kernels])
        elif kernels:
            start, end = min(k.start for k in kernels), max(k.end for k in kernels)
        else:
            start = end = 0.0
        return cls(kernels, spans, n_ticks, (start, end))

    # --- the window and the device ---------------------------------------
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        return union_length((k.start, k.end) for k in self.kernels)

    def idle_pct(self) -> float | None:
        w = self.window_us()
        return None if w <= 0 or not self.kernels else 100.0 * (w - self.busy_us()) / w

    # --- kernels by name, bucket and span --------------------------------
    def in_span(self, name: str) -> list:
        """The kernels launched inside any span called `name`."""
        ivs = [(s, e) for n, s, e in self.spans if n == name]
        return [k for k in self.kernels if k.launch is not None
                and any(s <= k.launch <= e for s, e in ivs)]

    def per_tick_ms(self, kernels) -> float:
        return sum(k.end - k.start for k in kernels) / 1e3 / self.n_ticks

    def by_bucket_ms(self) -> dict:
        out = dict.fromkeys(BUCKETS, 0.0)
        for k in self.kernels:
            out[bucket_of(k.name)] += (k.end - k.start) / 1e3
        return {b: v / self.n_ticks for b, v in out.items()}

    def device_ops(self, top: int = 10) -> list:
        """[[kernel name, seconds]] of the kernels that took most device
        time in the stretch, most first."""
        tot = {}
        for k in self.kernels:
            tot[k.name] = tot.get(k.name, 0.0) + (k.end - k.start) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]]: the device's idle time in
        the window, summed by the innermost span that held the host at the
        start of each gap, most first."""
        gaps, cur = [], self.window[0]
        for k in sorted(self.kernels, key=lambda k: k.start):
            if k.start > cur:
                gaps.append((cur, k.start))
            cur = max(cur, k.end)
        if self.window[1] > cur:
            gaps.append((cur, self.window[1]))
        tot = {}
        for s, e in gaps:
            inner = [(se - ss, n) for n, ss, se in self.spans if ss <= s <= se]
            label = min(inner)[1] if inner else "outside every span"
            tot[label] = tot.get(label, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def capture(run_ticks, n_ticks: int) -> Trace:
    """Profile `run_ticks(n_ticks)` (which wraps each tick in a `tick` span
    and synchronizes at its end) and read its Chrome trace, written to a
    temporary file under TMPDIR and deleted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_ticks(n_ticks)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return Trace.from_events(events, n_ticks)


def span(name: str, on: bool):
    """A host span around a call into one layer, recorded only when on."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
