"""Run one cell of the port's benchmark once and print one JSON result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`) names
a configuration (`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`, whose `driver` runs it); the limits of
the numbers that decide `correct` are `benchmark/limits/<workload>.json`;
each metric is read by `benchmark/metrics/<metric>.py`.

A run: set-up (import, the card, the kernels' libraries, the port's
controller or episode, the traffic from the seed, the warm-up ticks), the
measured window of `--seconds`, with `--trace 1` a short traced stretch
after it, then the port's state is freed and the sampled outputs are
compared with the plain reference. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics. The numbers compared are the last
lines of standard error and the last key of the result.

It exits non-zero and prints no result without a card (or with fewer than
the cell asks for), or when JAX or the JAX package is loaded once the window
has closed, in this process or in any rank of the cell. `--control 1` (not part of a measured run) prints the readings of
the control, the reference in the next lower precision, in place of the
port's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def cache_dirs(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["NDP_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             overrides=None, config_overrides=None, control=False, fault=None, chips=None):
    """One run of one cell; returns (result dict, check lines). `device`
    "cpu" skips the look for a card; `overrides` replace traffic parameters
    and `config_overrides` groups' entries of the configuration; `fault`
    wraps the cell's `program`; `chips` replaces the cell's count of ranks
    (these four for tests at a small size)."""
    import torch

    from benchmark.harness import guard, spec
    from benchmark.harness.program import synchronize

    s = spec.load_spec()
    w = spec.workload(s, workload)
    cfg, mix = spec.config(w["config"]), dict(spec.traffic(w["traffic"]), **(overrides or {}))
    for group, entries in (config_overrides or {}).items():
        cfg[group] = dict(cfg[group], **entries)
    with open(spec.BENCH / "limits" / f"{workload}.json") as fh:
        limits = json.load(fh)
    if device is None:
        if not torch.cuda.is_available():
            fail("no CUDA device")
        if torch.cuda.device_count() < int(w["chips"]):
            fail(f"the cell asks for {w['chips']} cards, {torch.cuda.device_count()} present")
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    else:
        dev = torch.device(device)
    weights = str(spec.BENCH / "configs" / cfg["forecast"]["weights"])
    start_wall = time.time() - (time.perf_counter() - T_START)
    cell = spec.driver(mix).setup(cfg, mix, seed, dev, weights, trace=trace,
                                  chips=int(chips or w["chips"]), limits=limits,
                                  start_wall=start_wall, control=control)
    if fault is not None and hasattr(cell, "set_fault"):
        cell.set_fault(fault)  # the cell's ranks plant it
    elif fault is not None:
        cell.program = fault(cell, cell.program)
    setup_s = time.perf_counter() - T_START
    rec = cell.window(seconds)
    setup_s = rec.pop("setup_s", setup_s)  # ranks of their own report theirs
    tr = cell.traced(int(mix["trace_ticks"])) if trace else None
    synchronize(dev)
    if hasattr(cell, "memory_peak"):
        peak = cell.memory_peak()
    else:
        peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    facts = cell.facts()
    cell.release()
    checks, cmp_facts = cell.check(limits, control=control)
    found = guard.forbidden_modules()
    if hasattr(cell, "rank_modules"):
        found += cell.rank_modules()  # what the cell's ranks loaded
    if found:
        fail(f"forbidden modules loaded: {', '.join(found)}", 3)
    run = dict(setup_s=setup_s, trace=tr, cfg=cfg, mix=mix, **rec, **facts)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(s, workload, kind):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       count=int(chips or w["chips"]), memory_peak_bytes=peak)
    result = dict(correct=bool(checks.correct), attempted=int(rec["attempted"]),
                  failed=int(rec["failed"]), metrics=metrics, device=device_info)
    if tr is not None:
        busy, window = (cell.trace_device() if hasattr(cell, "trace_device")
                        else (tr.busy_us() / 1e6, tr.window_us() / 1e6))
        device_info.update(busy_s=busy, window_s=window)
        result["breakdown"] = dict(device_ops=tr.device_ops(), idle_gaps=tr.idle_gaps())
    result["compared"] = cmp_facts
    result["checks"] = checks.as_dict()
    return result, checks.lines()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             control=bool(args.control))
    for ln in lines:
        print(ln, file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
