"""On the card: a short run of the scenario batch at a reduced batch reads
correct, and its control does not (`python -m pytest -m gpu benchmark/tests`)."""

import pytest
import torch

from benchmark.run import run_cell


@pytest.mark.gpu
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = dict(overrides=dict(batch=4096, warmup_ticks=4, sample_every_ticks=4), device="cuda")
    res, lines = run_cell("scenario_batch.b65536", 2**31 + 11, 1.0, True, **kw)
    assert res["correct"], lines
    assert res["device"]["busy_s"] > 0
    res, lines = run_cell("scenario_batch.b65536", 2**31 + 11, 1.0, False, control=True, **kw)
    assert not res["correct"], lines
