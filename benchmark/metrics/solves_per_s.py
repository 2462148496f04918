"""Scenario-ticks solved in the window over the window's seconds."""


def read(run):
    return run["solves"] / run["window_s"]
