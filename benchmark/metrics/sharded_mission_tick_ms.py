"""The slowest rank's window over the ticks every rank completed, in ms
(host clock; the window ends when its last tick is complete on the card)."""


def read(run):
    return run["window_s"] * 1e3 / run["n_ticks"]
