"""Seconds from process start to the first timed tick (host clock)."""


def read(run):
    return run["setup_s"]
