"""Device ms a tick of the kernels launched in the `forecast` span."""


def read(run):
    tr = run["trace"]
    ks = tr.in_span("forecast") if tr is not None else []
    return tr.per_tick_ms(ks) if ks else None
