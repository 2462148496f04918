"""The traffic repeats under the same seed and changes with it."""

import torch

from benchmark.drivers import formation, scenario_batch
from benchmark.harness import spec
from benchmark.harness.program import Sync
from benchmark.tests.helpers import SMALL


def batch_traffic(seed, ticks=6):
    mix = dict(spec.traffic("scenario_batch_b65536"), batch=16, setpoint_period_ticks=3)
    c = scenario_batch.ScenarioBatch.__new__(scenario_batch.ScenarioBatch)
    c.mix, c.B, c.N, c.dev = mix, 16, 20, torch.device("cpu")
    c.gravity, c.mass, c.ts, c.spans, c.k = 9.81, 1.4844, 0.02, False, 0
    c.ready = Sync(c.dev)
    c._traffic_init(seed)
    u0 = torch.zeros(16, 4)
    u0[:, 3] = 9.81
    out = []
    for _ in range(ticks):
        c._advance(u0)
        c.k += 1
        out.append(torch.cat([c.x.reshape(-1), c.xr.reshape(-1), c.other.reshape(-1)]).clone())
    return torch.stack(out)


def test_scenario_batch_traffic_repeats():
    a, b, other = batch_traffic(2**31 + 77), batch_traffic(2**31 + 77), batch_traffic(5)
    assert torch.equal(a, b)
    assert not torch.equal(a, other)
    assert a.shape == other.shape


def formation_setup(seed):
    cfg = spec.config("ndp_formation")
    cfg["mission"] = dict(cfg["mission"], hold_ticks=1)
    mix = dict(spec.traffic("formation_f65536"), **SMALL["formation.f65536"]["overrides"])
    mix["warmup_tracking_ticks"] = 0
    weights = str(spec.BENCH / "configs" / cfg["forecast"]["weights"])
    return formation.setup(cfg, mix, seed, torch.device("cpu"), weights)


def test_formation_traffic_repeats():
    a, b, c = formation_setup(2**31 + 5), formation_setup(2**31 + 5), formation_setup(9)
    assert torch.equal(a.jitter, b.jitter) and not torch.equal(a.jitter, c.jitter)
    assert all(torch.equal(p[1], q[1]) for p, q in zip(a.picks, b.picks))
    assert torch.equal(a.st.plant.x, b.st.plant.x)
