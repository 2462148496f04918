"""Small runs of the cells on the CPU (the port's plain versions stand in
for its kernels there)."""

from benchmark.run import run_cell

SMALL = {
    "scenario_batch.b65536": dict(
        overrides=dict(batch=8, warmup_ticks=2, sample_every_ticks=1, sample_scenarios=4,
                       trace_ticks=2)),
    "formation.f65536": dict(
        overrides=dict(formations=2, sample_every_ticks=1, sample_formations=2,
                       max_sampled_ticks=3, warmup_tracking_ticks=1, trace_ticks=1),
        config_overrides=dict(mission=dict(hold_ticks=2))),
    "formation.f262144.w4": dict(
        overrides=dict(formations=4, sample_every_ticks=1, sample_formations=2,
                       max_sampled_ticks=3, warmup_tracking_ticks=1, trace_ticks=1,
                       launch_timeout_s=300),
        config_overrides=dict(mission=dict(hold_ticks=2)), chips=2),
}


def small_run(cell, seed=1234567890123, seconds=0.5, trace=False, **kw):
    return run_cell(cell, seed, seconds, trace, device="cpu", **dict(SMALL[cell], **kw))
