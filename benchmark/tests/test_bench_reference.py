"""The frozen reference against the port's plain path, at a tiny size on
the CPU, where the port runs its kernels' plain versions: the same
arithmetic, so the same numbers."""

import torch

from benchmark.harness import spec
from benchmark.harness.program import port_config
from benchmark.reference import controller as ref_ctl
from benchmark.reference import forecast as ref_fc
from benchmark.tests.helpers import small_run


def test_controller_and_forecast_match_the_port():
    from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz, predict_downwash
    from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller

    cfg = spec.config("ndp_scenario_batch")
    pc = port_config(cfg)
    weights = str(spec.BENCH / "configs" / cfg["forecast"]["weights"])
    flags = {k: v for k, v in cfg["controller"].items() if k != "eq_tol"}
    ctl = make_batched_rti_controller(pc.ocp, pc.vehicle, device="cpu",
                                      eq_tol=cfg["controller"]["eq_tol"], **flags)
    g = torch.Generator().manual_seed(3)
    B, N = 6, pc.ocp.N_node
    xr, ur = ref_ctl.hover_refs(torch.rand(B, 3, generator=g), pc, torch.float32)
    other = xr.clone()
    other[..., 2] += 0.9
    x0 = xr[:, 0] + 0.3 * torch.randn(B, 10, generator=g) * torch.tensor([1.] * 3 + [0.] * 7)
    st_p, st_r = ctl.reset(xr, ur), ref_ctl.reset(xr, ur)
    mlp, layers = load_npz(weights, device="cpu"), ref_fc.load_layers(weights, "cpu")
    for dt in (torch.bfloat16, None):
        a = predict_downwash(mlp, other, xr, r_horiz=1.0, ego_gate_pos=x0, compute_dtype=dt)
        b = ref_fc.predict_downwash(layers, other, xr, r_horiz=1.0, ego_gate_pos=x0,
                                    compute_dtype=dt)
        assert torch.equal(a, b)
    for _ in range(2):
        f = ref_fc.predict_downwash(layers, other, xr, r_horiz=1.0, ego_gate_pos=x0,
                                    compute_dtype=torch.bfloat16)
        u_p, st_p, info = ctl.update(st_p, x0, xr, ur, f)
        u_r, st_r, ok_r, _ = ref_ctl.update(cfg, st_r, x0, xr, ur, f)
        assert torch.equal(u_p, u_r) and torch.equal(info.ok, ok_r)
        assert torch.equal(st_p.x_bar, st_r.x_bar) and torch.equal(st_p.u_bar, st_r.u_bar)
        assert all(torch.equal(a, b) for a, b in zip(st_p.ipm, st_r.ipm))


def test_cells_read_no_gap_against_the_plain_path():
    for cell in ("scenario_batch.b65536", "formation.f65536", "formation.f262144.w4"):
        res, lines = small_run(cell)
        assert res["correct"], lines
        # the same arithmetic: no gap but the round-off of the norms' own sums
        assert all(c["value"] <= 1e-12 for c in res["checks"].values()), res["checks"]
        assert res["compared"]["sampled_ticks"] >= 2
