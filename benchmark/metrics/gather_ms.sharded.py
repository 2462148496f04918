"""Device ms a tick of the NCCL kernels (the all-gathers of the drones'
states and horizons, the re-seed count's all-reduce) on the slowest rank."""

from benchmark.harness.trace import bucket_of


def read(run):
    tr = run["trace"]
    ks = [k for k in tr.kernels if bucket_of(k.name) == "nccl"] if tr is not None else []
    return tr.per_tick_ms(ks) if ks else None
