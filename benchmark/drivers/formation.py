"""Formations of the three-drone NDP mission, many at once, as a Monte
Carlo campaign flies them: the port's episode (`sim/swarm_scale.
make_formation_swarm`) steps every formation a tick at a time, with ticks
dispatched ahead as the program allows (its step never waits for the card).

Set-up builds the episode, puts each drone at its start plus a seeded
jitter, and flies the hold ticks and a few tracking ticks; the window then
lies in the tracking phase of an eight laid out over enough laps that it
ends inside tracking. A seeded sample of formations is kept at the start
and at every `sample_every_ticks`-th tick for the comparison with the
reference: their rows of the state before the tick and after it, with the
tick's command and throttle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.program import dtype_of, port_config, synchronize
from benchmark.harness.trace import TICK, capture, span
from benchmark.reference import episode as ref_ep
from benchmark.reference import forecast as ref_fc
from benchmark.reference.filters import DifferentiatorState
from benchmark.reference.hover_throttle import HoverThrottleState
from benchmark.reference.params import from_config


def setup(cfg, mix, seed, dev, weights, **_):
    return Formation(cfg, mix, seed, dev, weights)


class Formation:
    def __init__(self, cfg, mix, seed, dev, weights):
        from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints

        self.cfg, self.mix, self.dev, self.weights = cfg, mix, dev, weights
        ms = cfg["mission"]
        self.S, self.G = int(mix["formations"]), int(ms["drones_per_formation"])
        self.D = self.S * self.G
        self.laps = int(mix["laps"])
        wpts, t_seg, yaw = ref_ep.eight_waypoints(ms["eight"], self.laps)
        traj = fit_waypoints(wpts, t_seg, yaw, dtype=torch.float32, device=dev)
        self.anchors = ref_ep.grid_placement(self.S, float(ms["spacing_m"]))
        self.hold = int(ms["hold_ticks"])
        init_fn, self.step_fn, _ = self._build(traj, weights)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.jitter = (torch.rand(self.D, 3, generator=gen, device=dev) * 2.0 - 1.0) \
            * float(mix["start_jitter_m"])
        st = self._local(init_fn(torch.float32))
        Sl, f0 = self._pick_range()
        x = st.plant.x
        jit = self.jitter[f0 * self.G:(f0 + Sl) * self.G]
        self.st = st._replace(plant=st.plant._replace(
            x=torch.cat([x[:, 0:3] + jit, x[:, 3:]], dim=-1)))
        # the sampled formations of every sampled tick (this rank's own),
        # drawn now so that no host-to-card copy waits for the queue inside
        # the window
        rng = np.random.default_rng([seed, 2, f0])
        n_s = min(int(mix["sample_formations"]), Sl)
        self.picks = []
        for _ in range(int(mix["max_sampled_ticks"])):
            f = np.sort(rng.choice(Sl, size=n_s, replace=False))
            d = (f[:, None] * self.G + np.arange(self.G)[None]).reshape(-1)
            self.picks.append((torch.as_tensor(f + f0), torch.as_tensor(d, device=dev)))
        self.samples = []
        self.spans, self.sampling = False, True
        self.k = 0
        for _ in range(self.hold + int(mix["warmup_tracking_ticks"])):
            self.step()
        synchronize(dev)

    def _build(self, traj, weights):
        """The port's episode: (init_fn, step_fn, run_fn)."""
        from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz
        from ndp_nmpc_qd_tpu_torch.sim.swarm_scale import make_formation_swarm

        ms, c = self.cfg["mission"], self.cfg["controller"]
        return make_formation_swarm(
            port_config(self.cfg), traj, n_swarms=self.S, drones_per_swarm=self.G,
            use_ndp=ms["use_ndp"], downwash_params=load_npz(weights, device=self.dev),
            true_downwash=ms["true_downwash"], qp_iters=c["qp_iters"], hold_ticks=self.hold,
            placement=self.anchors, solver_backend="pallas", solver_warm_start=c["warm_start"],
            solver_jac_bf16=c["jac_bf16"], solver_lqr_start=c["lqr_start"],
            solver_whole_ipm=c["whole_ipm"], solver_packed_state=c["packed_state"],
            solver_whole_step=c["whole_step"], recover=ms["recover"], record_traces=True,
            device=self.dev)

    def _local(self, st):
        """The rows of the initial state this process flies (all of them)."""
        return st

    def _pick_range(self):
        """(formations flown here, the first one's global index)."""
        return self.S, 0

    def _rti(self, rti, d):
        """Rows `d` of the controller state in kernel layout."""
        return dict(x_bar=rti.x_bar[..., d], u_bar=rti.u_bar[..., d],
                    ipm=tuple(t[..., d] for t in rti.ipm))

    def _sampled(self):
        if not self.sampling or len(self.samples) >= len(self.picks):
            return False
        return self.k == 0 or (self.k >= self.hold
                               and (self.k - self.hold) % int(self.mix["sample_every_ticks"]) == 0)

    def _gather(self, st, d):
        est = st.est
        return dict(
            x=st.plant.x[d], w_act=st.plant.w_act[d], c_act=st.plant.c_act[d],
            **self._rti(st.rti, d),
            est=(est.x[d], est.P[d], est.diff.x_prev[d], est.diff.xdot_prev[d]),
            lpf_offset=st.lpf_offset[d], prev_ref_x=st.prev_ref_x[d],
            prev_ref_u=st.prev_ref_u[d], hold_xr=st.hold_xr[d], hold_ur=st.hold_ur[d],
            pos_err2=st.pos_err2[d], yaw_err2=st.yaw_err2[d], form_err2=st.form_err2[d],
            ok_all=st.ok_all[d])

    def program(self, st):
        return self.step_fn(st)

    def step(self):
        rec = None
        if self._sampled():
            f, d = self.picks[len(self.samples)]
            rec = dict(tick=self.k, formations=f, pre=self._gather(self.st, d))
        with span("episode", self.spans):
            new, (_, u0, throttle) = self.program(self.st)
        if rec is not None:
            d = self.picks[len(self.samples)][1]
            rec["post"] = self._gather(new, d)
            rec["post"].update(u0=u0[d], throttle=throttle[d])
            self.samples.append(rec)
        self.st = new
        self.k += 1

    def window(self, seconds, over=None):
        """Ticks until `seconds` have passed (`over(t0)` decides where
        given), then until the card has finished them."""
        over = over or (lambda t0: time.perf_counter() - t0 >= seconds)
        self.recovered_at_start = int(self.st.recovered)
        synchronize(self.dev)
        t0 = time.perf_counter()
        n = 0
        while not over(t0):
            self.step()
            n += 1
        synchronize(self.dev)
        end = time.perf_counter()
        return dict(window_s=end - t0, n_ticks=n, attempted=n * self.D,
                    failed=self._failed_since(n), solves=n * self.D)

    def _failed_since(self, n):
        # the episode keeps the last tick's health (recover=True), and the
        # re-seed count over every tick: the window's re-seeds are its fails
        return int(self.st.recovered) - self.recovered_at_start

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
        self.st = None
        self.step_fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def facts(self):
        return dict(batch=self.D)

    # --- the comparison with the reference ---------------------------------
    def check(self, limits, control=False):
        cfg, dev = self.cfg, self.dev
        checks = compare.Checks(limits)
        traj = ref_ep.fit_eight(cfg["mission"]["eight"], self.laps, torch.float32, dev)
        layers = ref_fc.load_layers(self.weights, dev)
        ctl_c = cfg["control"]
        sd = dtype_of(ctl_c["state_dtype"]) if control else torch.float32
        start_gap = 0.0
        for rec in self.samples:
            f = rec["formations"]
            anch = torch.as_tensor(self.anchors[f.numpy()], dtype=torch.float32, device=dev)
            pre = rec["pre"]
            if rec["tick"] == 0:
                rows = (f[:, None] * self.G + torch.arange(self.G)[None]).reshape(-1)
                own = ref_ep.init_state(cfg, traj, anch, self.jitter[rows.to(dev)])
                fp, fo = flat(pre), flat(own)
                start_gap = max(compare.rel_gap(fp[k], fo[k]) for k in STATE_KEYS)
                pre = own
            ref = ref_ep.tick(cfg, traj, layers, as_ref_state(pre, torch.float32), k=rec["tick"],
                              anchors=anch)
            if control:
                got = ref_ep.tick(cfg, traj, layers, as_ref_state(pre, sd), k=rec["tick"],
                                  anchors=anch, forecast_tf32=bool(ctl_c["forecast_tf32"]))
                got = {k: (v if not torch.is_tensor(v) else v.float() if v.is_floating_point()
                           else v) for k, v in flat(got).items()}
            else:
                got = flat(dict(rec["post"], ok_tick=rec["post"]["ok_all"]))
            ref, pre = flat(ref), flat(pre)
            u_lo, u_hi = from_config(cfg).ocp.u_lower(), from_config(cfg).ocp.u_upper()
            checks.add("u0_gap", compare.scaled_gap(got["u0"], ref["u0"],
                                                    [h - lo for lo, h in zip(u_lo, u_hi)]))
            checks.add("state_gap", max(compare.rel_gap(got[k], ref[k])
                                        for k in STATE_KEYS + ("throttle",)))
            checks.add("step_gap", compare.change_gap(pre, got, ref, STATE_KEYS))
            checks.add("ok_mismatch", int((got["ok_tick"] != ref["ok_tick"]).sum()))
        checks.add("start_gap", start_gap)
        return checks, dict(compared=sum(len(r["formations"]) for r in self.samples),
                            sampled_ticks=len(self.samples))


STATE_KEYS = ("x", "w_act", "c_act", "x_bar", "u_bar", "ipm0", "ipm1", "ipm2", "ipm3", "ipm4",
              "est_x", "est_P", "est_xp", "est_xd", "lpf_offset", "prev_ref_x", "prev_ref_u",
              "pos_err2", "yaw_err2", "form_err2")


def flat(s: dict) -> dict:
    """The state with its duals and estimator split into named tensors."""
    out = {k: v for k, v in s.items() if k not in ("ipm", "est")}
    for i, t in enumerate(s["ipm"]):
        out[f"ipm{i}"] = t
    est = s["est"]
    if isinstance(est, HoverThrottleState):
        est = (est.x, est.P, est.diff.x_prev, est.diff.xdot_prev)
    out.update(est_x=est[0], est_P=est[1], est_xp=est[2], est_xd=est[3])
    return out


def as_ref_state(s: dict, dtype) -> dict:
    """A gathered (or reference-built) state in the reference's types and
    in `dtype`."""
    f = flat(s)
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    return dict(
        x=cast(f["x"]), w_act=cast(f["w_act"]), c_act=cast(f["c_act"]),
        x_bar=cast(f["x_bar"]), u_bar=cast(f["u_bar"]),
        ipm=tuple(cast(f[f"ipm{i}"]) for i in range(5)),
        est=HoverThrottleState(cast(f["est_x"]), cast(f["est_P"]),
                               DifferentiatorState(cast(f["est_xp"]), cast(f["est_xd"]))),
        lpf_offset=cast(f["lpf_offset"]), prev_ref_x=cast(f["prev_ref_x"]),
        prev_ref_u=cast(f["prev_ref_u"]), hold_xr=cast(f["hold_xr"]),
        hold_ur=cast(f["hold_ur"]), pos_err2=cast(f["pos_err2"]),
        yaw_err2=cast(f["yaw_err2"]), form_err2=cast(f["form_err2"]))
