"""The roofline's count reads the configuration, not the path flags."""

import copy

import pytest

from benchmark.harness import roofline, spec


def test_count_ignores_the_path_flags():
    cfg = spec.config("ndp_scenario_batch")
    base = roofline.step_counts(cfg)
    other = copy.deepcopy(cfg)
    other["controller"].update(whole_step=False, packed_state=False, whole_ipm=False,
                               lqr_start=True)
    assert roofline.step_counts(other) == base
    assert roofline.step_counts(spec.config("ndp_formation"))["step_ops"] == base["step_ops"]


def test_counts_and_bound():
    c = roofline.step_counts(spec.config("ndp_scenario_batch"))
    assert c["step_ops"] == 391069
    assert c["step_bytes"] == 6072
    assert c["forecast_flops"] == 2 * 21 * (6 * 128 + 128 * 64 + 64 * 128 + 128 * 3)
    ms, by = roofline.bound_ms(c["step_ops"] * 65536, c["step_bytes"] * 65536)
    assert by == "operations" and ms == pytest.approx(0.3825, abs=5e-4)


def test_count_follows_the_iterations():
    cfg = copy.deepcopy(spec.config("ndp_scenario_batch"))
    cfg["controller"]["qp_iters"] = 4
    assert roofline.step_counts(cfg)["step_ops"] > 391069
