"""The traced stretch less the union of its kernels, as a share of it."""


def read(run):
    tr = run["trace"]
    return tr.idle_pct() if tr is not None else None
