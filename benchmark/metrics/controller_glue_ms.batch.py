"""Device ms a tick of the kernels launched in the `controller` span,
other than the one-kernel step (K1)."""

from benchmark.harness.trace import bucket_of


def read(run):
    tr = run["trace"]
    ks = tr.in_span("controller") if tr is not None else []
    if not ks:
        return None
    return tr.per_tick_ms([k for k in ks if bucket_of(k.name) != "step_whole_kernel"])
