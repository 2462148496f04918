"""The CUDA kernels vs their plain versions, on the card.

Marked `gpu`: it skips where no card is present (decided inside the test).
Run on the card with `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(the repo's conftest sets up JAX, which the card's machine need not have).
Tolerances as in chip_smoke.py. f32 payload: iterates atol 1e-4, duals and
mu rtol 1e-3 at their own scale (atol 1e-3 max|ref|, so warm-tick duals
near mu ~ 1e-11 are held too), since nvcc contracts mul+add into FMA and
torch rounds each op, over 3 IPM iterations. bf16 payload: u0 atol 1e-3,
iterates within 2^-8 of each tensor's largest entry, duals and mu rtol 2^-8
at their own scale (one bf16 ulp of a Jacobian entry may flip). Both: `ok`
identical.

K1 and K2 run a team of lanes a scenario with the scenario's working set
in shared memory, K8, K4 and K6 the same one stage at a time (the rows
staged by tensor copies where B allows them; otherwise K8 copies element by
element and K4 and K6 run their one-thread sweeps); K3 a warp for each
tangent column, a block for a stage of 32 scenarios. B=1 and B=301 leave a
ragged last block whatever the geometry, B=304 takes the tensor copies,
B=65535 is the swarms' batch, and a NaN in one scenario's input must stay in
that scenario.

The two-kernel path's kernels (K3 linearization, K2 whole IPM with and
without the folded axpy, K4/K5 one glue-fused IPM iteration), K6/K7 and the
legacy dense path's K8/K9 are held at the tolerances of
`ndp_nmpc_qd_tpu_torch/testing.py`: iterates, directions,
gains and the f32 payload atol 1e-4 of max(1, max|ref|); duals, their
directions, mu and comp4 rtol 1e-3 at their own scale; eq_res and res2
rtol 1e-3 above a floor 1e-6; the bf16 curvature payload within 2^-8 of
its largest entry.

The runtime layer: a live mission of the plant and controller daemons on
the card at the JAX live test's 0.25 m bound; the deployed `update` at B=1
and 64 with no host sync (`torch.cuda.set_sync_debug_mode("error")`); and
4 deployed ticks captured in a CUDA graph, replayed bitwise equal to the
same ticks run eagerly.
"""

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu_torch import testing
from ndp_nmpc_qd_tpu_torch.ops.kernels import (
    ipm_whole, linearize, riccati, riccati_sparse, step_whole,
)
from ndp_nmpc_qd_tpu_torch.ops.layout import pack
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, lin_consts, whole_step_consts
from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import cold_warm
from ndp_nmpc_qd_tpu_torch.solver.rti import first_control_and_health


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BF16_ULP = 2.0 ** -8


def assert_at_own_scale(got, ref, rtol, msg):
    """|got - ref| <= rtol |ref| + rtol max|ref|."""
    scale = ref.abs().max()
    err = float(((got - ref).abs() / (scale + ref.abs()).clamp_min(1e-30)).max())
    assert err <= rtol, f"{msg}: {err} > {rtol} (max|ref| {float(scale):.3g})"


def hover_step_inputs(cfg, B, dev, seed=1):
    """(xr, ur, fd, x0) in kernel layout and a cold state [xb, ub, *duals]:
    hover references, x0 at random offsets in [-1, 1] m, a forecast force of
    scale 0.3."""
    N = cfg.ocp.N_node
    rng = np.random.default_rng(seed)
    xr = torch.zeros(B, N + 1, 10, device=dev)
    xr[..., 6] = 1.0
    x0 = xr[:, 0].clone()
    x0[:, 0:3] += torch.as_tensor(rng.uniform(-1, 1, (B, 3)), dtype=torch.float32, device=dev)
    ur = torch.zeros(B, N, 4, device=dev)
    ur[..., 3] = cfg.vehicle.gravity
    fd = torch.as_tensor(0.3 * rng.standard_normal((B, N + 1, 3)), dtype=torch.float32, device=dev)
    ins = (pack(xr), pack(ur), pack(fd), pack(x0[:, None]))
    return ins, [pack(xr).clone(), pack(ur).clone(), *cold_warm(N, B, torch.float32, dev)]


def assert_step_close(cfg, state_k, eq_k, state_p, eq_p, jac_bf16, msg):
    """K1's state [xb, ub, *duals] and eq_res against the plain version's."""
    u0_k, ok_k = first_control_and_health(cfg.ocp, state_k[0], state_k[1], eq_k)
    u0_p, ok_p = first_control_and_health(cfg.ocp, state_p[0], state_p[1], eq_p)
    if jac_bf16:
        torch.testing.assert_close(u0_k, u0_p, rtol=0, atol=1e-3, msg=msg)
        for got, ref in zip(state_k[:2], state_p[:2]):
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= BF16_ULP, f"{msg}: iterates off by {err} of their largest entry"
        for got, ref in zip(state_k[2:], state_p[2:]):
            assert_at_own_scale(got, ref, BF16_ULP, msg)
    else:
        for got, ref in zip(state_k[:2], state_p[:2]):
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-4, msg=msg)
        for got, ref in zip(state_k[2:], state_p[2:]):
            assert_at_own_scale(got, ref, 1e-3, msg)
    assert torch.equal(ok_k, ok_p), msg


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 301])  # 301: a ragged last block for any team geometry
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_kernel_matches_plain_on_the_card(jac_bf16, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    consts = whole_step_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16, num_iters=3)
    ins, state_k = hover_step_inputs(cfg, B, dev)
    state_p = [t.clone() for t in state_k]
    before = step_whole.control_step_whole.launches
    for tick in range(3):
        eq_k = step_whole.control_step_whole(state_k[0], state_k[1], *ins, *state_k[2:], **consts)
        outs = step_whole.control_step_whole_plain(state_p[0], state_p[1], *ins, *state_p[2:], **consts)
        for dst, src in zip(state_p, outs[:7]):
            dst.copy_(src)
        torch.cuda.synchronize()
        assert_step_close(cfg, state_k, eq_k, state_p, outs[7], jac_bf16, f"tick {tick}")
    assert step_whole.control_step_whole.launches == before + 3


@pytest.mark.gpu
# 301: a ragged last block for any geometry; 65535: the swarms' batch
@pytest.mark.parametrize("B", [1, 301, 65535])
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_two_kernel_path_kernels_match_plain_on_the_card(jac_bf16, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
    ic = ipm_consts(cfg.ocp, num_iters=3)
    ins = testing.kernel_inputs(B, N, dev, seed=2)
    counts = lambda: (linearize.linearize_stage_data.launches,
                      ipm_whole.riccati_ipm_whole.launches,
                      riccati_sparse.riccati_backward_glue.launches,
                      riccati_sparse.riccati_forward_glue.launches)
    before = counts()

    errs, bad, qp = testing.check_linearize(ins, lc)
    assert not bad, f"K3: {bad} out of tolerance: {testing.describe(errs)}"

    for xu in (None, ins[:2]):
        errs, bad = testing.check_ipm_whole(qp, cold_warm(N, B, torch.float32, dev), ic, xu=xu)
        assert not bad, f"K2 (fold {xu is not None}): {bad}: {testing.describe(errs)}"

    errs, bad = testing.check_iter(testing.iter_args(qp, ic), ic)
    assert not bad, f"K4/K5: {bad} out of tolerance: {testing.describe(errs)}"
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 6, before[2] + 1, before[3] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_team_kernels_keep_a_nan_in_its_scenario(jac_bf16):
    """K1 and K2 with one scenario's x0 NaN: the kernels return, that
    scenario's results are NaN where the plain version's are, and every
    other scenario matches its plain value at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    N, B, bad_b = cfg.ocp.N_node, 301, 150
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[bad_b] = False
    consts = whole_step_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16, num_iters=3)
    ins, state_k = hover_step_inputs(cfg, B, dev, seed=5)
    ins[3][0, 0, bad_b] = float("nan")
    state_p = [t.clone() for t in state_k]
    eq_k = step_whole.control_step_whole(state_k[0], state_k[1], *ins, *state_k[2:], **consts)
    outs = step_whole.control_step_whole_plain(state_p[0], state_p[1], *ins, *state_p[2:], **consts)
    torch.cuda.synchronize()
    for got, ref in zip((*state_k, eq_k), outs):
        assert torch.equal(got[..., bad_b].isnan(), ref[..., bad_b].isnan())
    assert bool(eq_k[bad_b].isnan())
    assert_step_close(cfg, [t[..., keep] for t in state_k], eq_k[keep],
                      [t[..., keep] for t in outs[:7]], outs[7][keep], jac_bf16,
                      "K1 off the NaN scenario")

    xb, ub, xr, ur, fd, x0 = testing.kernel_inputs(B, N, dev, seed=5)
    x0[0, 0, bad_b] = float("nan")
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
    qp = linearize.linearize_stage_data_plain(xb, ub, xr, ur, fd, x0, **lc)
    duals = cold_warm(N, B, torch.float32, dev)
    ic = ipm_consts(cfg.ocp, num_iters=3)
    got = ipm_whole.riccati_ipm_whole(*qp[:11], *[t.clone() for t in duals], qp[11], **ic)
    ref = ipm_whole.riccati_ipm_whole_plain(*qp[:11], *duals, qp[11], **ic)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g[..., bad_b].isnan(), r[..., bad_b].isnan())
    errs, bad = testing.compare({
        n: ("primal" if i < 2 else "resid" if n == "eq" else "dual", g[..., keep], r[..., keep])
        for i, (n, g, r) in enumerate(zip(("zx", "zu") + testing.DUAL_NAMES + ("eq",), got, ref))})
    assert not bad, f"K2 off the NaN scenario: {bad}: {testing.describe(errs)}"


@pytest.mark.gpu
# 300: not a multiple of the 128-thread block; 304: K6's tensor copies
@pytest.mark.parametrize("B", [1, 300, 301, 304])
@pytest.mark.parametrize("call", ["lqr_start", "unfused_glue"])
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_sweep_kernels_match_plain_on_the_card(jac_bf16, call, B):
    """K6 and K7 (`riccati_sweep_sparse`) in both ways the IPM calls them,
    with both payloads, at the tolerances of `testing.check_sweep`, K6 on
    the route its batch takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    N = cfg.ocp.N_node
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
    ic = ipm_consts(cfg.ocp, num_iters=3)
    qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, dev, seed=3), **lc)
    counts = lambda: (riccati_sparse.riccati_sweep_backward.launches,
                      riccati_sparse.riccati_sweep_forward.launches)
    before = counts()
    args, hold = testing.sweep_args(qp, ic, call)
    errs, bad = testing.check_sweep(args, hold, ic)
    torch.cuda.synchronize()
    assert not bad, f"K6/K7 ({call}): {bad} out of tolerance: {testing.describe(errs)}"
    assert counts() == (before[0] + 1, before[1] + 1)
    assert riccati_sparse.last_sweep_route() == (
        "tensor copies" if B % 8 == 0 else "one-thread sweep")


@pytest.mark.gpu
@pytest.mark.parametrize("call", ["lqr_start", "newton"])
def test_packed_kernels_match_plain_on_the_card(call):
    """K8 and K9 (`riccati_sweep_packed`, f32) in both ways `ipm_packed`
    calls them, on the dense payload of the legacy packed path, at the
    tolerances of `testing.check_packed`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    B = 300  # not a multiple of the 128-thread block
    p, dx0 = testing.dense_payload(cfg, B, dev, seed=4)
    counts = lambda: (riccati.riccati_backward_packed.launches,
                      riccati.riccati_forward_packed.launches)
    before = counts()
    errs, bad = testing.check_packed(testing.packed_args(p, dx0, call))
    torch.cuda.synchronize()
    assert not bad, f"K8/K9 ({call}): {bad} out of tolerance: {testing.describe(errs)}"
    assert counts() == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 301, 304])  # 304: the tensor copies (B a multiple of 8)
@pytest.mark.parametrize("call", ["lqr_start", "newton"])
def test_streamed_dense_sweep_k8_matches_plain(call, B):
    """K8 against its plain version at `testing.check_packed`'s tolerance
    (K9 rides along on the plain gains)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    p, dx0 = testing.dense_payload(NdpNmpcConfig(), B, dev, seed=6)
    before = riccati.riccati_backward_packed.launches
    errs, bad = testing.check_packed(testing.packed_args(p, dx0, call))
    torch.cuda.synchronize()
    assert not bad, f"K8/K9 ({call}, B={B}): {bad} out of tolerance: {testing.describe(errs)}"
    assert riccati.riccati_backward_packed.launches == before + 1
    assert riccati.last_route() == ("tensor copies" if B % 4 == 0 else "element copies")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 301, 304])
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_streamed_glue_sweep_k4_matches_plain(jac_bf16, B):
    """K4 against its plain version at `testing.check_iter`'s tolerances
    (K5 rides along on the plain gains)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
    ic = ipm_consts(cfg.ocp, num_iters=3)
    qp = linearize.linearize_stage_data_plain(
        *testing.kernel_inputs(B, cfg.ocp.N_node, dev, seed=7), **lc)
    before = riccati_sparse.riccati_backward_glue.launches
    errs, bad = testing.check_iter(testing.iter_args(qp, ic), ic)
    torch.cuda.synchronize()
    assert not bad, f"K4/K5 (B={B}): {bad} out of tolerance: {testing.describe(errs)}"
    assert riccati_sparse.riccati_backward_glue.launches == before + 1
    assert riccati_sparse.last_route() == ("tensor copies" if B % 8 == 0 else "one-thread sweep")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [301, 304])
def test_streamed_sweeps_keep_a_nan_in_its_scenario(B):
    """K8 with one scenario's A NaN, K4 and K6 (both payloads, K6 in both
    ways the IPM calls it) with one scenario's iterate NaN: that scenario's
    outputs are NaN where the plain version's are, and every other scenario
    matches its plain value at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = NdpNmpcConfig()
    N, bad_b = cfg.ocp.N_node, 150
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[bad_b] = False

    def held(named):
        for name, (_, got, ref) in named.items():
            assert torch.equal(got[..., bad_b].isnan(), ref[..., bad_b].isnan()), name
        assert any(bool(got[..., bad_b].isnan().any()) for _, got, _ in named.values())
        errs, bad = testing.compare({n: (kind, g[..., keep], r[..., keep])
                                     for n, (kind, g, r) in named.items()})
        assert not bad, f"off the NaN scenario: {bad}: {testing.describe(errs)}"

    p, dx0 = testing.dense_payload(cfg, B, dev, seed=8)
    bwd = [t.clone() for t in testing.packed_args(p, dx0, "newton")[:9]]
    bwd[6][3, 5, bad_b] = float("nan")
    got = riccati.riccati_backward_packed(*bwd)
    ref = riccati.riccati_backward_packed_plain(*bwd)
    torch.cuda.synchronize()
    held({n: ("primal", g, r) for n, g, r in zip(("K", "kf"), got, ref)})

    ic = ipm_consts(cfg.ocp, num_iters=3)
    kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    for jac_bf16 in (False, True):
        lc = lin_consts(cfg.ocp, cfg.vehicle, True, jac_bf16=jac_bf16)
        qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, dev, 9), **lc)
        args = [t.clone() for t in testing.iter_args(qp, ic)[:22]]
        args[7][4, 2, bad_b] = float("nan")
        got = riccati_sparse.riccati_backward_glue(*args, **kw)
        ref = riccati_sparse.riccati_backward_glue_plain(*args, **kw)
        torch.cuda.synchronize()
        held({n: (kind, g, r) for (n, kind), g, r in zip(
            (("K", "primal"), ("kf", "primal"), ("rhat", "primal"), ("res2", "resid")), got, ref)})
        for call in ("lqr_start", "unfused_glue"):
            args = [t.clone() for t in testing.sweep_args(qp, ic, call)[0][:13]]
            args[7][4, 2, bad_b] = float("nan")
            got = riccati_sparse.riccati_sweep_backward(*args, **kw)
            ref = riccati_sparse.riccati_sweep_backward_plain(*args, **kw)
            torch.cuda.synchronize()
            held({n: ("primal", g, r) for n, g, r in zip(("K", "kf", "rhat"), got, ref)})


# ---- the runtime daemons and the bench's step on the card ----


def _bench():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "bench_torch.py"
    spec = importlib.util.spec_from_file_location("bench_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_live_mission_on_the_card():
    """The plant and the controller daemon (the defaults: the deployed
    one-kernel step at B=1, pipelined) as threads on the card, the JAX
    live test's goal (`tests/test_runtime.py:215-224`) and its bound:
    status 1, pos RMSE < 0.25 m, more than 3 feedback messages; one K1
    launch a tick plus the warm-up's one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import gc
    import threading
    import uuid

    from ndp_nmpc_qd_tpu_torch.runtime.nodes import (
        ControllerDaemon, NodeTopics, PlantDaemon, send_trajectory,
    )
    from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints

    ns = f"gpu_{uuid.uuid4().hex[:8]}"
    plant, ctl = PlantDaemon(ns), ControllerDaemon(ns)
    assert ctl.solver == "packed" and ctl.pipeline is True
    stop, out = threading.Event(), {}
    pr, cr = threading.Event(), threading.Event()
    threads = [
        threading.Thread(target=lambda: out.setdefault("plant", plant.run(
            ready_event=pr, stop_event=stop))),
        threading.Thread(target=lambda: out.setdefault("ctl", ctl.run(
            ready_event=cr, stop_event=stop))),
    ]
    before = step_whole.control_step_whole.launches
    try:
        threads[0].start()
        assert pr.wait(60)
        threads[1].start()
        assert cr.wait(300)
        wpts = np.stack([[0, 0.5, 1.0, 0.5, 0.0], [0, 0.5, 0, -0.5, 0], np.ones(5)], axis=-1)
        res, feedback = send_trajectory(ns, fit_waypoints(wpts, np.full(4, 2.0)), goal_id=3,
                                        timeout_s=30)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
        NodeTopics.unlink(ns)
    assert not any(th.is_alive() for th in threads)
    assert int(res["status"]) == 1
    assert float(res["pos_rmse"]) < 0.25, float(res["pos_rmse"])
    assert len(feedback) > 3
    assert out["ctl"]["recoveries"] == 0 and gc.isenabled()
    assert step_whole.control_step_whole.launches - before == out["ctl"]["ticks"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
def test_deployed_update_makes_no_host_sync(B):
    """`update` of the deployed controller queues its work and never waits
    for the card (no `.item()`, no pageable copy, no `nonzero`): what the
    daemon's dispatch-ahead ticks and the CUDA-graph row rely on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bt = _bench()
    dev = torch.device("cuda")
    ctl = bt.make_batched_rti_controller(bt.CFG.ocp, bt.CFG.vehicle, device=dev,
                                         **bt.deployed_flags())
    x0, xr, ur, other = bt.inputs(B, dev, seed=2)
    f = torch.zeros(B, bt.N + 1, 3, device=dev)
    st = ctl.reset(xr, ur)
    _, st, _ = ctl.update(st, x0, xr, ur, f)  # the first call caches the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u0, st, info = ctl.update(st, x0, xr, ur, f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(info.ok.all()) and bool(torch.isfinite(u0).all())


@pytest.mark.gpu
def test_cuda_graph_replay_equals_eager():
    """4 deployed ticks (the bf16 forecast and one K1 launch each) captured
    in a CUDA graph: the replay equals the same ticks run eagerly from a
    copy of the state, bitwise; the capture counted 4 K1 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bt = _bench()
    dev = torch.device("cuda")
    ctl = bt.make_batched_rti_controller(bt.CFG.ocp, bt.CFG.vehicle, device=dev,
                                         **bt.deployed_flags())
    ins = bt.inputs(301, dev, seed=3)
    step = bt.control_step(ctl, bt.load_npz(bt.ASSET, device=dev), True)
    row, _ = bt.row_multitick(step, ctl.reset(ins[1], ins[2]), ins, K=4, reps=1)
    assert row["replay_vs_eager_max_abs_diff"] == 0.0, row
    assert row["k1_launches_per_replay"] == 4 and row["ok_last_tick"] == 301
