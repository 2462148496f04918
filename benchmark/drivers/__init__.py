"""One module a kind of traffic; a traffic file names its driver. A driver
has `setup(cfg, mix, seed, dev) -> cell`, and the cell `window(seconds)`,
`traced(n_ticks)`, `release()`, `check(limits, control=False)` and
`run_facts()`."""
