"""The whole step's share of the chip's peak: the least time for the
step's counted work (the controller's f32 operations against the f32 peak,
the forecast's bf16 GEMMs against the bf16 peak) over the window's time a
tick."""

from benchmark.harness import roofline


def read(run):
    if run.get("trace") is None or not run["n_ticks"]:
        return None
    c = roofline.step_counts(run["cfg"])
    B = run["batch"]
    least_s = (c["step_ops"] * B / roofline.PEAK_F32_FLOPS
               + c["forecast_flops"] * B / roofline.PEAK_BF16_FLOPS)
    return 100.0 * least_s / (run["window_s"] / run["n_ticks"])
