"""The 95th percentile of every tick of the window, in ms (host clock, from
the inputs handed over to u0 and `ok` on the host)."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile(run["tick_ms"], 95)
