"""The port's benchmark (`run.py`): cells of `BENCHMARK.json` built from the
files under `configs/`, `traffic/`, `limits/` and `metrics/`, the shared
arithmetic under `harness/`, the drivers of each kind of traffic under
`drivers/`, and the plain reference under `reference/`."""
