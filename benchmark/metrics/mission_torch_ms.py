"""Device ms a tick of every kernel that is not one of the port's CUDA
kernels: the plant, references, exchange, forecast, recovery and metrics."""

from benchmark.harness.trace import is_port_kernel


def read(run):
    tr = run["trace"]
    if tr is None or not tr.kernels:
        return None
    return tr.per_tick_ms([k for k in tr.kernels if not is_port_kernel(k.name)])
