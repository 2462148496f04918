"""Independent single-drone scenarios in one batch, in closed loop.

Each tick hands the port x0, the hover references and the other drone's
horizon; the port runs the deployed step (the bf16 forecast, then one RTI
update) and the tick ends when u0 and `ok` are on the host (pinned copy,
event waited). Then the benchmark's own plant (a frozen copy of the
body-rate dynamics, RK4 over one control period, on the card) steps every
scenario from the returned command under a seeded disturbance force, and
the traffic moves: each scenario's hover setpoint jumps by up to `setpoint_jump_m` in
each axis (kept within `offset_m` of the origin in each axis) every
`setpoint_period_ticks` ticks (staggered, so every tick carries the same
share of jumps), and the other drone's horizon, `other_dz_m` above the
setpoint, drifts by a mean-reverting walk in the plane.

Every draw comes from one generator on the device seeded with the run's
seed, so the same seed gives the same traffic; every seed gives the same
sizes. A seeded sample of (tick, scenario) pairs is kept for the
comparison with the reference: the port's state before the tick, the
tick's inputs, and its outputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.program import Sync, dtype_of, port_config, synchronize
from benchmark.harness.trace import TICK, capture, span
from benchmark.reference import controller as ref_ctl
from benchmark.reference import forecast as ref_fc
from benchmark.reference.integrators import rk4_step
from benchmark.reference.params import from_config
from benchmark.reference.quadrotor import body_rate_dynamics
from benchmark.reference.quat import normalize

# the traffic's draws are made this many ticks at a time
NOISE_BLOCK_TICKS = 64


def setup(cfg, mix, seed, dev, weights, **_):
    return ScenarioBatch(cfg, mix, seed, dev, weights)


class ScenarioBatch:
    def __init__(self, cfg, mix, seed, dev, weights):
        from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz, predict_downwash
        from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller

        self.cfg, self.mix, self.dev, self.weights = cfg, mix, dev, weights
        pc = port_config(cfg)
        self.N, self.B = pc.ocp.N_node, int(mix["batch"])
        self.r_horiz = pc.downwash.r_horiz
        self.fc_dtype = dtype_of(cfg["forecast"]["compute_dtype"])
        ctl = {k: v for k, v in cfg["controller"].items() if k != "eq_tol"}
        self.ctl = make_batched_rti_controller(pc.ocp, pc.vehicle, device=dev,
                                               eq_tol=cfg["controller"]["eq_tol"], **ctl)
        self.mlp = load_npz(weights, device=dev)
        self.predict = predict_downwash
        self.mass, self.gravity = pc.vehicle.mass, pc.vehicle.gravity
        self.ts = pc.ocp.ts_nmpc
        self._traffic_init(seed)
        self.state = self.ctl.reset(self.xr, self.ur)
        # two pinned pairs, used in turns: the host counts a tick's failures
        # while the next tick's work runs on the card
        pin = dev.type == "cuda"
        self.out_h = [(torch.empty(self.B, 4, pin_memory=pin),
                       torch.empty(self.B, dtype=torch.bool, pin_memory=pin)) for _ in range(2)]
        self.pending = None
        self.done, self.ready = Sync(dev), Sync(dev)
        self.sample_rng = np.random.default_rng([seed, 1])
        self.samples, self.k = [], 0
        self.spans, self.sampling = False, True
        for _ in range(int(mix["warmup_ticks"])):
            self.step()
        synchronize(dev)

    # --- the traffic -------------------------------------------------------
    def _traffic_init(self, seed):
        m, B, N, dev = self.mix, self.B, self.N, self.dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        rand = lambda *s: torch.rand(*s, generator=self.gen, device=dev)
        randn = lambda *s: torch.randn(*s, generator=self.gen, device=dev)
        a = float(m["offset_m"])
        pos0 = (rand(B, 3) * 2.0 - 1.0) * a
        self.phase = torch.randint(0, int(m["setpoint_period_ticks"]), (B,), generator=self.gen,
                                   device=dev)
        self.f_const = randn(B, 3) * float(m["disturbance_sigma_n"])
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self.x = torch.cat([pos0, torch.zeros(B, 3, device=dev), q.expand(B, 4)], dim=-1)
        self.setpoint = torch.zeros(B, 3, device=dev)
        hover = torch.cat([torch.zeros(6, device=dev), q])
        self.xr = hover.expand(B, N + 1, 10).clone()
        self.ur = torch.zeros(B, N, 4, device=dev)
        self.ur[..., 3] = self.gravity
        self.walk = torch.zeros(B, 2, device=dev)
        self.other = self.xr.clone()
        self.gust = torch.zeros(B, 3, device=dev)
        self.u_cmd = torch.zeros(B, 4, device=dev)
        self.noise_now = torch.zeros(B, 8, device=dev)
        self.k_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._place_other()
        self.graph = None
        if dev.type == "cuda":
            # the plant and the traffic as one replay a tick, so that the
            # benchmark's own host work stays out of the port's way
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                saved = [t.clone() for t in self._advanced()]
                self._advance_body()
                for t, s in zip(self._advanced(), saved):
                    t.copy_(s)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._advance_body()

    def _advanced(self):
        """The tensors that the plant and the traffic update in place."""
        return (self.x, self.setpoint, self.xr, self.walk, self.other, self.gust, self.k_dev)

    def _place_other(self):
        self.other.copy_(self.xr)
        self.other[..., 0:2] += self.walk[:, None, :]
        self.other[..., 2] += float(self.mix["other_dz_m"])

    def _advance_body(self):
        """The plant steps every scenario from the command under its
        disturbance force; then the setpoints that are due jump, the other
        drone's walk moves and the next gust is drawn (from `noise_now`)."""
        m = self.mix
        f_ext = self.f_const + self.gust

        def f(x, u):
            return body_rate_dynamics(x, u, f_ext, mass=self.mass, gravity=self.gravity)

        x = rk4_step(f, self.x, self.u_cmd, self.ts)
        self.x.copy_(torch.cat([x[:, 0:6], normalize(x[:, 6:10])], dim=-1))
        jump = ((self.phase + self.k_dev) % int(m["setpoint_period_ticks"])) == 0
        a = float(m["offset_m"])
        fresh = torch.clamp(self.setpoint + (self.noise_now[:, 0:3] * 2.0 - 1.0)
                            * float(m["setpoint_jump_m"]), -a, a)
        self.setpoint.copy_(torch.where(jump[:, None], fresh, self.setpoint))
        self.xr[..., 0:3] = self.setpoint[:, None, :]
        rho = float(m["walk_rho"])
        self.walk.copy_(rho * self.walk + float(m["walk_sigma_m"]) * self.noise_now[:, 3:5])
        self._place_other()
        self.gust.copy_(self.noise_now[:, 5:8] * float(m["gust_sigma_n"]))
        self.k_dev += 1

    def _advance(self, u0):
        """The plant from the returned command, then the traffic's next tick.
        The draws come in blocks of `NOISE_BLOCK_TICKS` ticks from the seeded
        generator: uniform for the setpoints, normal for the walk and gusts."""
        B, dev = self.B, self.dev
        with span("plant", self.spans):
            blk = NOISE_BLOCK_TICKS
            if self.k % blk == 0:
                self.noise = torch.cat([
                    torch.rand(blk, B, 3, generator=self.gen, device=dev),
                    torch.randn(blk, B, 5, generator=self.gen, device=dev)], dim=-1)
            self.noise_now.copy_(self.noise[self.k % blk])
            self.u_cmd.copy_(u0)
            if self.graph is not None:
                self.graph.replay()
            else:
                self._advance_body()
        self.ready.record()

    # --- one tick of the port ------------------------------------------------
    def program(self, x0, xr, ur, other):
        """The deployed step, composed as the port's `deployed.control_step`."""
        with torch.no_grad():
            with span("forecast", self.spans):
                f = self.predict(self.mlp, other, xr, r_horiz=self.r_horiz,
                                 ego_gate_pos=x0[..., 0:3], compute_dtype=self.fc_dtype)
            with span("controller", self.spans):
                u0, self.state, info = self.ctl.update(self.state, x0, xr, ur, f)
        return u0, info.ok

    def _sampled(self):
        m = self.mix
        if not self.sampling:
            return False
        if self.k == 0:
            return True
        return self.k % int(m["sample_every_ticks"]) == 0

    def _gather_state(self, idx):
        st = self.state
        return dict(x_bar=st.x_bar[..., idx], u_bar=st.u_bar[..., idx],
                    ipm=tuple(t[..., idx] for t in st.ipm) if st.ipm is not None else None)

    def step(self):
        """One tick: returns its latency in ms."""
        self.ready.wait()
        rec = None
        if self._sampled():
            idx = torch.as_tensor(
                self.sample_rng.choice(self.B, size=min(int(self.mix["sample_scenarios"]), self.B),
                                       replace=False), device=self.dev)
            rec = dict(tick=self.k, idx=idx, pre=self._gather_state(idx),
                       x0=self.x[idx], xr=self.xr[idx], ur=self.ur[idx], other=self.other[idx])
            synchronize(self.dev)
        t_in = time.perf_counter()
        u0, ok = self.program(self.x, self.xr, self.ur, self.other)
        self.last_failed = self._count_failed()
        u0_h, ok_h = self.out_h[self.k % 2]
        with span("fetch", self.spans):
            u0_h.copy_(u0, non_blocking=True)
            ok_h.copy_(ok, non_blocking=True)
            self.done.record()
            self.done.wait()
        t_out = time.perf_counter()
        self.pending = (u0_h, ok_h)
        if rec is not None:
            rec.update(u0=u0[rec["idx"]].clone(), ok=ok[rec["idx"]].clone(),
                       post=self._gather_state(rec["idx"]))
            self.samples.append(rec)
        self._advance(u0)
        self.k += 1
        return (t_out - t_in) * 1e3

    def _count_failed(self):
        """Scenarios of the previous tick flagged not ok or with a command
        that is not finite (0 before the first)."""
        if self.pending is None:
            return 0
        u0_np, ok_np = self.pending[0].numpy(), self.pending[1].numpy()
        self.pending = None
        return int(np.count_nonzero(~ok_np | ~np.isfinite(u0_np).all(axis=1)))

    # --- the measured window and the traced stretch -----------------------
    def window(self, seconds):
        lat, failed = [], 0
        self.pending = None  # the warm-up's last tick is not the window's
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            lat.append(self.step())
            failed += self.last_failed
            end = time.perf_counter()
        failed += self._count_failed()
        synchronize(self.dev)
        n = len(lat)
        return dict(window_s=end - t0, n_ticks=n, tick_ms=lat, attempted=n * self.B,
                    failed=failed, solves=n * self.B)

    def traced(self, n_ticks):
        synchronize(self.dev)

        def run(n):
            self.spans, self.sampling = True, False
            try:
                for _ in range(n):
                    with span(TICK, True):
                        self.step()
                synchronize(self.dev)
            finally:
                self.spans, self.sampling = False, True

        return capture(run, n_ticks)

    def release(self):
        """Free the port's state before the reference runs."""
        for name in ("ctl", "state", "mlp", "x", "xr", "ur", "other", "out_h", "graph",
                     "noise"):
            setattr(self, name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the comparison with the reference ---------------------------------
    def check(self, limits, control=False):
        """The port's sampled ticks against the reference, which recomputes
        each from the port's state before it (the first tick from its own
        reset): the command, the new iterates, the IPM's carried duals and
        the health flags; with `control`, the reference's lower-precision twin against
        the reference instead."""
        cfg, s = self.cfg, self.samples
        checks = compare.Checks(limits)
        start = s[0]
        assert start["tick"] == 0
        ref0 = ref_ctl.reset(start["xr"], start["ur"])
        reset_gap = max(compare.rel_gap(start["pre"]["x_bar"], ref0.x_bar),
                        compare.rel_gap(start["pre"]["u_bar"], ref0.u_bar),
                        *(compare.rel_gap(a, b) for a, b in zip(start["pre"]["ipm"], ref0.ipm)))
        cat = lambda key: torch.cat([r[key] for r in s], dim=0)
        catl = lambda part, key: torch.cat(
            [ref0._asdict()[key] if (r is start and part == "pre") else r[part][key] for r in s],
            dim=-1)
        pre = ref_ctl.RtiState(catl("pre", "x_bar"), catl("pre", "u_bar"),
                               tuple(torch.cat([ref0.ipm[i] if r is start else r["pre"]["ipm"][i]
                                                for r in s], dim=-1) for i in range(5)))
        x0, xr, ur, other = cat("x0"), cat("xr"), cat("ur"), cat("other")
        layers = ref_fc.load_layers(self.weights, self.dev)
        r_horiz = from_config(cfg).downwash.r_horiz
        fc_dtype = dtype_of(cfg["forecast"]["compute_dtype"])

        def reference(state_dtype, operand_dtype):
            with torch.no_grad():
                f = ref_fc.predict_downwash(layers, other, xr, r_horiz=r_horiz, ego_gate_pos=x0,
                                            compute_dtype=fc_dtype, operand_dtype=operand_dtype)
                st = ref_ctl.RtiState(pre.x_bar.to(state_dtype), pre.u_bar.to(state_dtype),
                                      tuple(t.to(state_dtype) for t in pre.ipm))
                u0, new, ok, _ = ref_ctl.update(cfg, st, x0, xr, ur, f)
            return (u0.float(), new.x_bar.float(), new.u_bar.float(), ok,
                    tuple(t.float() for t in new.ipm))

        ref = reference(torch.float32, None)
        if control:
            c = cfg["control"]
            got = reference(dtype_of(c["state_dtype"]), dtype_of(c["forecast_operand_dtype"]))
            reset_gap = 0.0
        else:
            got = (cat("u0"), catl("post", "x_bar"), catl("post", "u_bar"), cat("ok"),
                   tuple(torch.cat([r["post"]["ipm"][i] for r in s], dim=-1) for i in range(5)))
        u_rng = [hi - lo for lo, hi in zip(step_box(cfg)[0], step_box(cfg)[1])]
        checks.add("u0_gap", compare.scaled_gap(got[0], ref[0], u_rng))
        checks.add("iterate_gap", max(compare.rel_gap(got[1], ref[1]),
                                      compare.rel_gap(got[2], ref[2])))
        checks.add("dual_gap", dual_gap(s, pre.ipm, got[4], ref[4]))
        checks.add("ok_mismatch", int((got[3] != ref[3]).sum()))
        checks.add("reset_gap", reset_gap)
        return checks, dict(compared=int(x0.shape[0]), sampled_ticks=len(s))

    def facts(self):
        return dict(batch=self.B)


def dual_gap(samples, pre, got, ref) -> float:
    """The duals' change gap (`compare.change_gap` over the five carried
    duals), sampled tick by sampled tick: the reference's change from the
    duals the tick started from against the gap between the two new ones."""
    keys, gap, off = range(5), 0.0, 0
    for r in samples:
        sl = slice(off, off + int(r["idx"].numel()))
        off = sl.stop
        gap = max(gap, compare.change_gap(*([t[..., sl] for t in d] for d in (pre, got, ref)),
                                          keys))
    return gap


def step_box(cfg):
    ocp = from_config(cfg).ocp
    return ocp.u_lower(), ocp.u_upper()
