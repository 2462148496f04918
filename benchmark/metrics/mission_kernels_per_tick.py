"""Device kernels a tick in the traced stretch."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.n_ticks
