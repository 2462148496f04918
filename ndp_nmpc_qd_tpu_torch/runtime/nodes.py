"""Process-level nodes over the qdio bus: the interactive/hardware-facing
runtime (the reference's L4 node layer).

Port of `ndp_nmpc_qd_tpu/runtime/nodes.py`, with the same topics, protocol
and results, mirroring the reference topology one-to-one:

  ControllerDaemon  <->  ControllerNode (nmpc_node.py): odom in, body-rate
                         command out, PredXU horizon out, TrackTraj
                         goal/feedback/result protocol, hover-throttle
                         estimator gating, hold-point idle behavior.
  PlantDaemon       <->  dop_sim: integrates the quadrotor at a fixed rate,
                         publishes odometry, consumes AttitudeTarget.
  send_trajectory   <->  cmd_pc's action client: publish a TrajCoefficients
                         goal, stream feedback, collect the RMSE result.

Topics per namespace `ns` (shared-memory, latest-value):
  <ns>/odom, <ns>/attitude_target, <ns>/ref_x_u, <ns>/traj_goal,
  <ns>/traj_feedback, <ns>/traj_result, <ns>/formation_ref

The daemons run on the card unless given `device="cpu"`. On the card the
controller is the deployed one-kernel step at B=1 (one K1 launch a tick)
and its ticks are pipelined: a tick queues its solve and publishes the
previous tick's command, whose values come back by copies that never wait
for the card (`HostLink`).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.metrics import LatencyRecorder
from . import bus as qb

# Interpreter-wide GC policy refcount: gc.disable() is global, so co-hosted
# daemons (threads in one process, as the tests run them) must not re-enable
# collection underneath each other. The first daemon in disables, the last
# one out restores the state observed at first entry.
_GC_LOCK = threading.Lock()
_GC_DEPTH = 0
_GC_WAS_ENABLED = False


def _gc_policy_enter() -> None:
    global _GC_DEPTH, _GC_WAS_ENABLED
    with _GC_LOCK:
        if _GC_DEPTH == 0:
            _GC_WAS_ENABLED = gc.isenabled()
            gc.collect()
            gc.disable()
        _GC_DEPTH += 1


def _gc_policy_exit() -> None:
    global _GC_DEPTH
    with _GC_LOCK:
        _GC_DEPTH -= 1
        if _GC_DEPTH == 0 and _GC_WAS_ENABLED:
            gc.enable()


@dataclass
class NodeTopics:
    ns: str

    def __post_init__(self):
        self.odom = qb.Topic(f"{self.ns}/odom", qb.ODOMETRY)
        self.att = qb.Topic(f"{self.ns}/attitude_target", qb.ATTITUDE_TARGET)
        self.ref_x_u = qb.Topic(f"{self.ns}/ref_x_u", qb.PRED_XU)
        self.viz_pred = qb.Topic(f"{self.ns}/viz_pred", qb.PRED_XU)
        self.goal = qb.Topic(f"{self.ns}/traj_goal", qb.TRAJ_COEFF)
        self.cancel = qb.Topic(f"{self.ns}/traj_cancel", qb.TRAJ_CANCEL)
        self.feedback = qb.Topic(f"{self.ns}/traj_feedback", qb.TRACK_FEEDBACK)
        self.result = qb.Topic(f"{self.ns}/traj_result", qb.TRACK_RESULT)
        self.formation_ref = qb.Topic(f"{self.ns}/formation_ref", qb.POINT)
        self.formation_err = qb.Topic(f"{self.ns}/formation_err", qb.FORM_ERROR)
        self.pose = qb.Topic(f"{self.ns}/pose", qb.POSE)

    @staticmethod
    def unlink(ns: str):
        for t in (
            "odom", "attitude_target", "ref_x_u", "viz_pred", "traj_goal",
            "traj_cancel", "traj_feedback", "traj_result", "formation_ref",
            "formation_err", "pose",
        ):
            qb.Topic.unlink(f"{ns}/{t}")


def _odom_to_x(m) -> np.ndarray:
    return np.concatenate([m["pos"], m["vel"], m["quat"]])


def _own_stream(device):
    """A CUDA stream of the daemon's own on the card, so that daemons that
    share a process (threads) do not wait for each other's work; nothing on
    the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


class Pending(NamedTuple):
    """Device tensors on their way to pinned host buffers; `wait` waits for
    the event recorded after the copies (not for the device) and returns
    them as numpy arrays, valid until the same slot is fetched again."""

    host: dict
    event: object

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class HostLink:
    """Copies between the host and `device` that never wait for the device.

    - `upload(name, array)`: a host array to a new device tensor, through a
      pinned host buffer (a non_blocking copy).
    - `fetch(tag, **tensors)`: non_blocking copies of device tensors into
      pinned host buffers, then an event: a `Pending`.

    The buffers of each name and tag alternate between two slots, so a
    tick may write while the previous tick's copies are still queued. A
    slot is written again two calls later: by then the caller must have
    waited for a `Pending` fetched after the first write's copy (the
    daemons wait every tick for one fetched that tick or the tick before).
    On the CPU both are plain copies and `Pending.wait` returns at once.
    """

    def __init__(self, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.pinned = self.device.type == "cuda"
        self._buf: dict = {}
        self._slot: dict = {}

    def _host(self, key, shape, dtype):
        buf = self._buf.get(key)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = self._buf[key] = torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
        return buf

    def _next(self, key) -> int:
        slot = self._slot[key] = 1 - self._slot.get(key, 1)
        return slot

    def upload(self, name: str, array) -> torch.Tensor:
        a = np.asarray(array)
        if not self.pinned:
            return torch.tensor(a, dtype=self.dtype, device=self.device)
        buf = self._host(("up", name, self._next(("up", name))), a.shape, self.dtype)
        buf.numpy()[...] = a
        return buf.to(self.device, non_blocking=True)

    def fetch(self, tag: str, **tensors) -> Pending:
        slot = self._next(tag)
        host = {}
        for name, t in tensors.items():
            buf = self._host((tag, name, slot), t.shape, t.dtype)
            buf.copy_(t, non_blocking=self.pinned)
            host[name] = buf
        event = None
        if self.pinned:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return Pending(host, event)


def _unbatched_packed(bctl):
    """The unbatched controller contract (reset / update / iterates of
    `make_rti_controller`) over the deployed batched controller at B=1."""
    from ..solver.rti import RtiInfo, unpack_iterates

    class UnbatchedPacked:
        @staticmethod
        def reset(xr, ur):
            return bctl.reset(xr[None], ur[None])

        @staticmethod
        def update(st, x, xr, ur, f):
            u0, st, info = bctl.update(st, x[None], xr[None], ur[None], f[None])
            return u0[0], st, RtiInfo(*(t[0] for t in info))

        @staticmethod
        def iterates(st):
            xb, ub = unpack_iterates(st, 1)
            return xb[0], ub[0]

    return UnbatchedPacked()


def _scan(ctl):
    class Scan:
        reset = staticmethod(ctl.reset)
        update = staticmethod(ctl.update)

        @staticmethod
        def iterates(st):
            return st.x_bar, st.u_bar

    return Scan()


def default_downwash_asset() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets",
                        "downwash_analytic_sn4.npz")


class ControllerDaemon:
    """One quadrotor's NMPC controller over the bus (single scenario).

    run(max_ticks) executes the 50 Hz loop; designed to be started in its
    own process per namespace, like the reference's one-node-per-drone
    launch files.
    """

    def __init__(
        self,
        ns: str,
        cfg=None,
        *,
        leader_ns: str | None = None,
        use_ndp: bool = False,
        companion_ns: str | None = None,
        downwash_params=None,
        pipeline: bool | None = None,
        solver: str | None = None,
        device=None,
    ):
        """`leader_ns` makes this a follower of that namespace's horizon.
        `use_ndp` + `companion_ns` makes this an NDP leader forecasting the
        downwash force from `companion_ns`'s published horizon (the
        `NDPLeaderNode.sub_xf_pred_callback` role,
        `ndp_nmpc_leader_node.py:60-76`); `downwash_params` is the port's
        `DownwashMlp` (default: `assets/downwash_analytic_sn4.npz`).

        `device`: the card by default (raises without one); the tests pass
        "cpu". `solver`: "packed" (the default on the card) is the deployed
        batched controller at B=1 (warm@3, bf16 Jacobians, the one-kernel
        step: one K1 launch a tick; on the CPU K1's plain version); "scan"
        (the default on the CPU) is `make_rti_controller`, cold@12. The
        controller runs in float32, except the scan controller on the CPU,
        which runs in the odometry's float64.

        `pipeline` enables dispatch-ahead: each tick enqueues its solve and
        publishes the PREVIOUS tick's command instead of blocking on its own
        — one-tick-stale output, the same asynchrony class the reference
        already tolerates between its reference-producer and control-timer
        threads (`nmpc_node.py:160-162`). Default: on for the card, off on
        the CPU, where nothing is queued."""
        from ..estimators.hover_throttle import (
            hover_throttle_init,
            hover_throttle_update,
            throttle_from_collective,
        )
        from ..params import NdpNmpcConfig
        from ..solver.rti import make_batched_rti_controller, make_rti_controller
        from ..swarm.formation import rate_converted_alpha
        from ..traj.polyopt import pad_traj
        from ..traj.refgen import gen_fix_pt_ref, nmpc_refs

        self.cfg = cfg or NdpNmpcConfig()
        self.ns = ns
        self.leader_ns = leader_ns
        self.use_ndp = use_ndp
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.pipeline = on_card if pipeline is None else pipeline
        self.t = NodeTopics(ns)
        self.leader_ref = qb.Topic(f"{leader_ns}/ref_x_u", qb.PRED_XU) if leader_ns else None
        ocp, veh = self.cfg.ocp, self.cfg.vehicle

        if solver is None:
            solver = "packed" if on_card else "scan"
        self.solver = solver
        if solver == "packed":
            self.dtype = torch.float32
            self.ctl = _unbatched_packed(make_batched_rti_controller(
                ocp, veh, with_disturbance=True, qp_iters=3, warm_start=True,
                jac_bf16=True, lqr_start=False, whole_ipm=True, packed_state=True,
                whole_step=True, device=self.device,
            ))
        elif solver == "scan":
            self.dtype = torch.float32 if on_card else torch.float64
            self.ctl = _scan(make_rti_controller(ocp, veh, with_disturbance=True,
                                                 device=self.device))
        else:
            raise ValueError(f"unknown solver {solver!r}")
        self.link = HostLink(self.device, self.dtype)
        # The references are host data: made from the host clock, published
        # every tick, and ~240 small ops that cost less on the CPU than
        # launched one by one on the card. They are made in float64 on the
        # CPU and uploaded for the solve. Goals are padded to MAX_SEG
        # segments, as the JAX daemon pads them for its one compiled
        # reference function (`nodes.py:234-239`).
        self._gen_fix = lambda x: tuple(
            t.numpy() for t in gen_fix_pt_ref(torch.from_numpy(x), ocp, veh))
        self._pad = lambda traj: pad_traj(traj, qb.MAX_SEG)
        self._refs = lambda tr, tt: tuple(t.numpy() for t in nmpc_refs(tr, tt, ocp, veh))
        self.last = None
        self.goal_to_first_cmd_s = None  # measured per goal
        # The hover-throttle estimator is the daemon's host bookkeeping: fed
        # host values (v_z, the last thrust) and read on the host every tick
        # (the throttle conversion), it runs on the CPU in float64 whatever
        # the controller's device, so that no tick waits for the card on it.
        self._hv_init = lambda: hover_throttle_init(self.cfg.estimator, dtype=torch.float64)
        self._hv_update = lambda st, vz, th: hover_throttle_update(
            st, torch.tensor(vz, dtype=torch.float64), torch.tensor(th, dtype=torch.float64),
            self.cfg.estimator)
        self._throttle = lambda c, k: float(throttle_from_collective(
            torch.tensor(c, dtype=torch.float64), torch.tensor(k, dtype=torch.float64),
            veh.mass))
        self._alpha = rate_converted_alpha(0.8, 0.05, ocp.ts_nmpc)

        self.companion_ref = (
            qb.Topic(f"{companion_ns}/ref_x_u", qb.PRED_XU) if (use_ndp and companion_ns) else None
        )
        if use_ndp:
            from ..models.downwash_mlp import load_npz, predict_downwash

            if downwash_params is None:
                downwash_params = load_npz(default_downwash_asset(), dtype=self.dtype,
                                           device=self.device)
            mlp = downwash_params

            def predict(other, ego, gate):
                with torch.no_grad():
                    return predict_downwash(mlp, other, ego, r_horiz=self.cfg.downwash.r_horiz,
                                            ego_gate_pos=gate)

            self._predict = predict

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _warmup(self):
        """Run every function of the loop once on its shapes, so that the
        control loop and goal intake never stall on a first call: the kernel
        build (nvcc at first use), the update, the references of a padded
        goal, the estimator, the forecast and the host link's buffers."""
        from ..traj.polyopt import fit_waypoints

        N = self.cfg.ocp.N_node
        x_h = np.zeros(10)
        x_h[6] = 1.0
        link = self.link
        x = link.upload("x", x_h)
        xr, ur = (link.upload(n, a) for n, a in zip(("xr", "ur"), self._gen_fix(x_h)))
        state = self.ctl.reset(xr, ur)
        u0, state, info = self.ctl.update(state, x, xr, ur, self._zeros(N + 1, 3))
        xb, ub = self.ctl.iterates(state)
        link.fetch("out", u0=u0, ok=info.ok, xb=xb, ub=ub).wait()
        est = self._hv_init()
        self._hv_update(est, 0.0, 0.5)
        wpts = np.stack([np.linspace(0, 1, 3), np.zeros(3), np.ones(3)], -1)
        self._refs(self._pad(fit_waypoints(wpts, np.full(2, 2.0))), 0.0)
        if self.companion_ref is not None:
            self._predict(link.upload("other", np.zeros((N + 1, 10))), xr, x[0:3])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_ticks: int = 0, ready_event=None, stop_event=None):
        """The control loop: `max_ticks` ticks (0 = until `stop_event` is
        set, or forever), on a stream of its own on the card. Returns ticks,
        overruns, recoveries, the goal-to-first-command latency of the last
        goal and the summary of each tick's time after its sleep
        (`tick_latency`, against the 20 ms period). Afterwards `last` holds
        the controller state the loop left and its last tick's inputs
        (state, x0, xr, ur, f)."""
        with _own_stream(self.device):
            try:
                return self._run(max_ticks, ready_event, stop_event)
            finally:  # the queued tick ends before the daemon returns
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()

    def _run(self, max_ticks, ready_event, stop_event):
        from ..traj.polyopt import eval_traj

        ocp, veh = self.cfg.ocp, self.cfg.vehicle
        N = ocp.N_node
        stopped = lambda: stop_event is not None and stop_event.is_set()

        self._warmup()

        # wait for first odometry (the FC-connection gate, nmpc_node.py:77-80)
        while True:
            seq, odom = self.t.odom.read_latest()
            if seq > 0:
                break
            if stopped():
                return dict(ticks=0, overruns=0, recoveries=0, goal_to_first_cmd_s=None,
                            tick_latency={"count": 0})
            time.sleep(0.05)

        link = self.link
        x_now = _odom_to_x(odom)
        x_dev = link.upload("x", x_now)
        xr_h, ur_h = self._gen_fix(x_now)
        xr, ur = link.upload("xr", xr_h), link.upload("ur", ur_h)
        state = self.ctl.reset(xr, ur)
        est = self._hv_init()
        est_active = True
        lpf_off = None

        traj = None  # the goal, padded, on the host (float64)
        traj_t0 = 0.0
        goal_id = -1
        goal_seq_seen = self.t.goal.count
        cancel_seq_seen = self.t.cancel.count
        err2 = np.zeros(2)
        n_err = 0
        form_err2 = 0.0
        n_form = 0
        last_thrust = 0.0
        f_dist = self._zeros(N + 1, 3)
        inflight = None  # dispatch-ahead pipeline slot: the queued tick's Pending
        new_goal = False

        def publish_result(status: int):
            """TrackTraj result record (status 1 = succeeded, 2 = preempted,
            `action/TrackTraj.action:1-11`) with the RMSE accumulated so far."""
            res = np.zeros((), qb.TRACK_RESULT)
            res["goal_id"] = goal_id
            res["status"] = status
            res["pos_rmse"] = np.sqrt(err2[0] / max(n_err, 1))
            res["yaw_rmse"] = np.sqrt(err2[1] / max(n_err, 1))
            res["t"] = qb.now()
            self.t.result.publish(res)

        # Real-time GC policy: CPython's cyclic collector pauses the loop for
        # milliseconds at unpredictable ticks. Per-tick garbage here is
        # acyclic, so the loop runs with automatic collection disabled and
        # collects explicitly only while truly idle (hold, no goal, not a
        # follower). Entry/exit is refcounted for co-hosted daemons.
        tick = 0
        n_recover = 0
        latency = LatencyRecorder(budget_s=ocp.ts_nmpc)  # each tick's work, after its sleep
        _gc_policy_enter()
        try:
            rate = qb.Rate(ocp.ts_nmpc)
            if ready_event is not None:
                ready_event.set()
            while (max_ticks == 0 or tick < max_ticks) and not stopped():
                tick += 1
                if tick % 250 == 0 and traj is None and self.leader_ref is None:
                    gc.collect()
                rate.sleep()
                t_tick = time.perf_counter()

                seq, odom = self.t.odom.read_latest()
                x_now = _odom_to_x(odom)
                x_dev = link.upload("x", x_now)

                # --- preempt check (the actionlib cancel channel,
                # `nmpc_node.py:165-168`): the references stop advancing and
                # the estimator timer restarts ---
                if self.t.cancel.count > cancel_seq_seen:
                    cancel_seq_seen = self.t.cancel.count
                    _, cmsg = self.t.cancel.read_latest()
                    cancel_id = int(cmsg["goal_id"])
                    if traj is not None and cancel_id in (-1, goal_id):
                        publish_result(2)
                        traj = None
                        est_active = True

                # --- goal intake (the action server role). A new goal while one
                # is active SUPERSEDES it: the old goal gets a status=2 result. ---
                if self.t.goal.count > goal_seq_seen:
                    goal_seq_seen = self.t.goal.count
                    _, gmsg = self.t.goal.read_latest()
                    if traj is not None:
                        publish_result(2)
                    traj = self._pad(qb.msg_to_traj(gmsg))
                    goal_id = int(gmsg["goal_id"])
                    err2[:] = 0.0
                    n_err = 0
                    est_active = False  # estimator frozen while tracking
                    # the controller resets from the new references below
                    # (anti warm start); the padded reference function ran in
                    # the warm-up, so the mission clock starts at once
                    goal_rx_t = qb.now()
                    new_goal = True
                    traj_t0 = qb.now()
                    self.goal_to_first_cmd_s = -goal_rx_t  # completed post-publish

                # --- reference selection ---
                if traj is not None:
                    tt = qb.now() - traj_t0
                    t_all = float(traj.t_cum[-1])
                    xr_h, ur_h = self._refs(traj, float(tt))
                    if tt >= t_all:  # finished: result + back to hold
                        publish_result(1)
                        traj = None
                        est_active = True
                        gc.collect()  # safe: tracking over, back to hold
                elif self.leader_ref is not None:
                    lseq, lmsg = self.leader_ref.read_latest()
                    fseq, fmsg = self.t.formation_ref.read_latest()
                    off = fmsg["xyz"] if fseq > 0 else np.zeros(3)
                    lpf_off = (
                        off if lpf_off is None
                        else self._alpha * lpf_off + (1 - self._alpha) * off
                    )
                    if lseq > 0:
                        xr_h = lmsg["x"].copy()
                        xr_h[:, 0:3] += lpf_off
                        ur_h = lmsg["u"]
                        # online formation-error feedback
                        # (`nmpc_follower_node.py:79-94`)
                        fe2 = float(np.sum((lmsg["x"][0, 0:3] + lpf_off - x_now[0:3]) ** 2))
                        form_err2 += fe2
                        n_form += 1
                        fm = np.zeros((), qb.FORM_ERROR)
                        fm["t"] = qb.now()
                        fm["err2"] = fe2
                        fm["rmse"] = np.sqrt(form_err2 / n_form)
                        fm["n"] = n_form
                        self.t.formation_err.publish(fm)

                xr, ur = link.upload("xr", xr_h), link.upload("ur", ur_h)
                if new_goal:
                    state = self.ctl.reset(xr, ur)
                    new_goal = False

                # --- NDP disturbance forecast from the companion's horizon ---
                if self.companion_ref is not None:
                    cseq, cmsg = self.companion_ref.read_latest()
                    if cseq > 0:
                        f_dist = self._predict(link.upload("other", cmsg["x"]), xr, x_dev[0:3])
                    else:
                        f_dist = self._zeros(N + 1, 3)

                # --- solve + publish --- with pipeline=True the tick publishes
                # the PREVIOUS tick's command and leaves its own solve queued:
                # one-tick-stale output, the reference's own asynchrony class
                # (`nmpc_node.py:160-162`).
                u0_dev, state, info = self.ctl.update(state, x_dev, xr, ur, f_dist)
                out = dict(u0=u0_dev, ok=info.ok)
                if tick % 3 == 0:  # the predicted-horizon viz, every third tick
                    out["xb"], out["ub"] = self.ctl.iterates(state)
                pending = link.fetch("out", **out)
                if self.pipeline:
                    published = inflight if inflight is not None else pending
                    inflight = pending
                else:
                    published = pending
                res = published.wait()
                u0 = res["u0"].astype(np.float64)

                # --- health response (the live respawn analog,
                # `nmpc_body_rate_ctl.py:109-110`): an unhealthy or non-finite
                # solve never reaches the vehicle: publish the hold command and
                # re-seed the iterates from the reference; the queued solve
                # used the poisoned state and is dropped ---
                if not (bool(res["ok"]) and np.isfinite(u0).all()):
                    n_recover += 1
                    state = self.ctl.reset(xr, ur)
                    inflight = None
                    u0 = np.array([0.0, 0.0, 0.0, veh.gravity])
                thrust = self._throttle(u0[3], float(est.x[1]))
                att = np.zeros((), qb.ATTITUDE_TARGET)
                att["t"] = qb.now()
                att["body_rate"] = u0[0:3]
                att["thrust"] = thrust
                att["type_mask"] = 128  # IGNORE_ATTITUDE
                self.t.att.publish(att)
                last_thrust = thrust
                if self.goal_to_first_cmd_s is not None and self.goal_to_first_cmd_s < 0:
                    self.goal_to_first_cmd_s += qb.now()

                pred = np.zeros((), qb.PRED_XU)
                pred["t"] = qb.now()
                pred["x"] = xr_h
                pred["u"] = ur_h
                self.t.ref_x_u.publish(pred)

                # the solver's iterates with normalized quaternions
                # (viz_nmpc_pred_callback, nmpc_node.py:233-249), from the tick
                # whose command was published
                if "xb" in res:
                    xb = res["xb"].astype(np.float64)
                    qn = np.linalg.norm(xb[:, 6:10], axis=-1, keepdims=True)
                    viz = np.zeros((), qb.PRED_XU)
                    viz["t"] = qb.now()
                    viz["x"] = np.concatenate(
                        [xb[:, 0:6], xb[:, 6:10] / np.maximum(qn, 1e-9)], axis=-1)
                    viz["u"] = res["ub"]
                    self.t.viz_pred.publish(viz)
                if tick % 3 == 0:
                    # pose broadcast: the tf2 TransformBroadcaster role
                    ps = np.zeros((), qb.POSE)
                    ps["t"] = qb.now()
                    ps["pos"] = x_now[0:3]
                    ps["quat"] = x_now[6:10]
                    self.t.pose.publish(ps)

                # --- estimator tick (gated like the reference timer) ---
                if est_active:
                    est, _ = self._hv_update(est, float(x_now[5]), last_thrust)

                # --- tracking error + feedback ---
                if traj is not None:
                    fo = eval_traj(traj, qb.now() - traj_t0)
                    pe = float(np.sum((fo.pos.numpy() - x_now[0:3]) ** 2))
                    q = x_now[6:10]
                    yaw_now = np.arctan2(
                        2 * (q[0] * q[3] + q[1] * q[2]), 1 - 2 * (q[2] ** 2 + q[3] ** 2))
                    ye = float(np.degrees(float(fo.yaw) - yaw_now) ** 2)
                    err2 += [pe, ye]
                    n_err += 1
                    fb = np.zeros((), qb.TRACK_FEEDBACK)
                    fb["t"] = qb.now()
                    fb["goal_id"] = goal_id
                    fb["percent_complete"] = min(
                        (qb.now() - traj_t0) / float(traj.t_cum[-1]), 1.0)
                    fb["pos_error"] = pe
                    fb["yaw_error"] = ye
                    self.t.feedback.publish(fb)
                latency.record(time.perf_counter() - t_tick)
        finally:
            _gc_policy_exit()

        self.last = dict(state=state, x0=x_dev, xr=xr, ur=ur, f=f_dist)
        return dict(
            ticks=rate.ticks,
            overruns=rate.overruns,
            recoveries=n_recover,
            goal_to_first_cmd_s=self.goal_to_first_cmd_s,
            tick_latency=latency.summary(),
        )


def _plant_tick(st, cmd, f_ext, dt, veh, sim):
    """One plant step of `dt` from the command tensor `cmd` (body rates,
    throttle), writing the state `st` in place. On the card the step's ~150
    small launches are captured once in a CUDA graph and each tick replays
    it: launched one by one they took the interpreter a few ms a tick at
    200 Hz, which daemons sharing the process (threads) then wait for."""
    from ..sim.plant import plant_step

    def step():
        for dst, src in zip(st, plant_step(st, cmd[0:3], cmd[3], f_ext, dt, veh, sim)):
            dst.copy_(src)

    if st.x.device.type != "cuda":
        return step
    saved = [t.clone() for t in st]
    step()  # the first call makes the step's constants; captured, they are read
    for dst, src in zip(st, saved):
        dst.copy_(src)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a co-hosted daemon's thread may allocate during the capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    return graph.replay


class PlantDaemon:
    """The dop_sim role: integrates one quadrotor, bridges the bus. Runs
    `sim.plant.plant_step` in float64 on `device` (the card by default: one
    CUDA graph replay a tick)."""

    def __init__(self, ns: str, cfg=None, x0=None, device=None):
        from ..params import NdpNmpcConfig

        self.cfg = cfg or NdpNmpcConfig()
        self.ns = ns
        self.device = resolve_device(device)
        self.t = NodeTopics(ns)
        self.x0 = x0 if x0 is not None else np.array(
            [0, 0, 1, 0, 0, 0, 1, 0, 0, 0], dtype=np.float64
        )

    def run(self, max_ticks: int = 0, rate_hz: float = 200.0, ready_event=None,
            stop_event=None):
        with _own_stream(self.device):
            return self._run(max_ticks, rate_hz, ready_event, stop_event)

    def _run(self, max_ticks, rate_hz, ready_event, stop_event):
        from ..sim.plant import plant_init

        veh, sim = self.cfg.vehicle, self.cfg.sim
        dt = 1.0 / rate_hz
        link = HostLink(self.device, torch.float64)
        f_ext = torch.zeros(3, dtype=torch.float64, device=self.device)
        st = plant_init(link.upload("x0", self.x0), veh)
        hover_th = veh.mass * veh.gravity / sim.k_throttle_true
        cmd = torch.tensor([0.0, 0.0, 0.0, hover_th], dtype=torch.float64, device=self.device)
        tick_fn = _plant_tick(st, cmd, f_ext, dt, veh, sim)

        rate = qb.Rate(dt)
        if ready_event is not None:
            ready_event.set()
        tick = 0
        while (max_ticks == 0 or tick < max_ticks) and not (
                stop_event is not None and stop_event.is_set()):
            tick += 1
            rate.sleep()
            seq, att = self.t.att.read_latest()
            if seq > 0:
                cmd.copy_(link.upload("cmd", np.r_[att["body_rate"], att["thrust"]]))
            tick_fn()
            x = link.fetch("x", x=st.x).wait()["x"]
            m = np.zeros((), qb.ODOMETRY)
            m["t"] = qb.now()
            m["pos"] = x[0:3]
            m["vel"] = x[3:6]
            m["quat"] = x[6:10]
            self.t.odom.publish(m)
        return dict(ticks=rate.ticks, overruns=rate.overruns)


def send_trajectory(
    ns: str,
    traj,
    goal_id: int = 1,
    timeout_s: float = 60.0,
    cancel_after_s: float | None = None,
):
    """cmd_pc action-client role: send a goal (the port's `PiecewisePoly`),
    stream feedback, return the result record (blocks until the controller
    reports done or timeout).

    `cancel_after_s` requests preemption that long after the goal is sent
    (the actionlib cancel path) — the returned result then carries status=2.
    """
    topics = NodeTopics(ns)
    topics.goal.publish(qb.traj_to_msg(traj, goal_id))
    t0 = qb.now()
    result_count0 = topics.result.count
    feedback = []
    cancelled = False
    while qb.now() - t0 < timeout_s:
        if cancel_after_s is not None and not cancelled and qb.now() - t0 >= cancel_after_s:
            cancel_trajectory(ns, goal_id)
            cancelled = True
        if topics.result.count > result_count0:
            _, res = topics.result.read_latest()
            if int(res["goal_id"]) == goal_id:
                return res, feedback
        fseq, fb = topics.feedback.read_latest()
        if fseq > 0 and int(fb["goal_id"]) == goal_id:
            feedback.append(fb.copy())
        time.sleep(0.05)
    raise TimeoutError(f"no result from {ns} within {timeout_s}s")


def cancel_trajectory(ns: str, goal_id: int = -1) -> None:
    """Publish a TrackTraj preempt request (goal_id = -1 cancels whatever
    goal is active) — `set_preempted` semantics, `nmpc_node.py:165-168`."""
    m = np.zeros((), qb.TRAJ_CANCEL)
    m["t"] = qb.now()
    m["goal_id"] = goal_id
    qb.Topic(f"{ns}/traj_cancel", qb.TRAJ_CANCEL).publish(m)
