"""The window over the ticks it completed, in ms (host clock; the window
ends when its last tick is complete on the device)."""


def read(run):
    return run["window_s"] * 1e3 / run["n_ticks"]
