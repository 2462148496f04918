"""Typed configuration tree of the PyTorch port.

A copy of `ndp_nmpc_qd_tpu/params.py` (the port imports nothing of the JAX
package). It replaces the reference's import-time constant modules
(`ndp_nmpc/scripts/params/{fhnp,nmpc,estimator,downwash}_params.py`) with
frozen dataclasses whose defaults reproduce the reference values exactly:

- vehicle constants: reference `params/fhnp_params.py:9-43`
- OCP / controller:  reference `params/nmpc_params.py:8-43`
- estimator:         reference `params/estimator_params.py:13-18`
- downwash gating:   reference `params/downwash_params.py:10`

All fields are plain Python floats/ints, so instances hash and the kernel
constants derived from them are fixed per controller.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

GRAVITY = 9.81  # m/s^2 (reference fhnp_params.py:12)


@dataclass(frozen=True)
class VehicleParams:
    """Quadrotor physical constants (reference `params/fhnp_params.py`)."""

    mass: float = 1.4844  # kg (fhnp_params.py:9)
    gravity: float = GRAVITY
    l_frame: float = 0.1372  # m (fhnp_params.py:10)
    alpha_frame: float = 45.0 * np.pi / 180.0  # rad (fhnp_params.py:11)
    Jx: float = 0.0094  # kg m^2 (fhnp_params.py:13)
    Jy: float = 0.0134
    Jz: float = 0.0145
    Jxz: float = 0.0
    # max collective acceleration: gravity / 0.36 (fhnp_params.py:19)
    c_max: float = GRAVITY / 0.36
    o_max: float = 24.0  # kRPM (fhnp_params.py:23)
    o_min: float = 2.6  # kRPM
    c_q: float = 3.7611e-10  # Nm/RPM^2
    c_t: float = 2.8158e-08  # N/RPM^2
    t_w_r: float = 4.31  # thrust-to-weight ratio (fhnp_params.py:29)


@dataclass(frozen=True)
class OcpParams:
    """NMPC OCP shape, bounds, and weights (reference `params/nmpc_params.py`).

    The reference builds an acados OCP with N_node=20 shooting intervals over a
    T_horizon=2 s horizon, NONLINEAR_LS cost with weights Q/R below, box bounds
    on the body rates / collective acceleration and on velocity
    (`nmpc_ctl/nmpc_body_rate_ctl.py:44-61`).
    """

    N_node: int = 20  # nmpc_params.py:9
    T_horizon: float = 2.0  # nmpc_params.py:10
    ts_nmpc: float = 0.02  # control period (nmpc_params.py:11)

    n_states: int = 10
    n_controls: int = 4

    # input / state bounds (nmpc_params.py:19-25)
    w_max: float = 6.0
    w_min: float = -6.0
    c_max: float = GRAVITY / 0.36
    c_min: float = 0.0
    v_max: float = 20.0
    v_min: float = -20.0

    # cost weights (nmpc_params.py:28-35)
    Qp_xy: float = 300.0
    Qp_z: float = 400.0
    Qv_xy: float = 10.0
    Qv_z: float = 10.0
    Qq_xy: float = 10.0
    Qq_z: float = 100.0
    Rw: float = 10.0
    Rc: float = 5.0

    # ERK integrator stages per shooting interval (acados sim_method defaults:
    # 4-stage RK, 1 step — `nmpc_body_rate_ctl.py:74` selects "ERK")
    erk_substeps: int = 1

    # acados scales intermediate-stage LS costs by the interval length
    # (cost_scaling defaults to [dt,...,dt,1]); keep that semantic.
    scale_stage_cost_by_dt: bool = True

    @property
    def th_pred(self) -> float:
        """Shooting-interval length: T_horizon / N_node (nmpc_params.py:12)."""
        return self.T_horizon / self.N_node

    @property
    def nodes_per_tick(self) -> int:
        """Control ticks per shooting interval: th_pred / ts_nmpc."""
        r = self.th_pred / self.ts_nmpc
        assert abs(r - round(r)) < 1e-9, "th_pred must be an integer multiple of ts_nmpc"
        return int(round(r))

    def q_diag(self) -> np.ndarray:
        """State weight diagonal; index 6 (qw residual slot) is zero
        (`nmpc_body_rate_ctl.py:48`)."""
        return np.array(
            [
                self.Qp_xy, self.Qp_xy, self.Qp_z,
                self.Qv_xy, self.Qv_xy, self.Qv_z,
                0.0, self.Qq_xy, self.Qq_xy, self.Qq_z,
            ]
        )

    def r_diag(self) -> np.ndarray:
        return np.array([self.Rw, self.Rw, self.Rw, self.Rc])

    def u_lower(self) -> np.ndarray:
        return np.array([self.w_min, self.w_min, self.w_min, self.c_min])

    def u_upper(self) -> np.ndarray:
        return np.array([self.w_max, self.w_max, self.w_max, self.c_max])

    def v_lower(self) -> np.ndarray:
        return np.array([self.v_min] * 3)

    def v_upper(self) -> np.ndarray:
        return np.array([self.v_max] * 3)


@dataclass(frozen=True)
class EstimatorParams:
    """Hover-throttle Kalman filter (reference `params/estimator_params.py`)."""

    k_throttle_init: float = 50.0  # estimator_params.py:13 (sim value)
    ts_est: float = 0.02  # 50 Hz (estimator_params.py:15)
    R: float = 1.225  # measurement noise (estimator_params.py:17)
    Q_diag: tuple = (0.1, 0.1)  # process noise diag (estimator_params.py:18)
    diff_tau: float = 0.05  # dirty-derivative time constant (differentiator.py:15)
    mass: float = 1.4844
    gravity: float = GRAVITY


@dataclass(frozen=True)
class DownwashParams:
    """Downwash NN observer gating (reference `params/downwash_params.py:10`)."""

    r_horiz: float = 1.0  # meters; horizontal activation radius
    hidden: tuple = (128, 64, 128)  # MLP width (dnwash_nn_est/nn_net.py:7-18)
    n_in: int = 6
    n_out: int = 3


@dataclass(frozen=True)
class SimParams:
    """In-graph plant (dop_sim role) configuration."""

    ts_sim: float = 0.005  # plant integration step (4x control rate)
    rate_tau: float = 0.0  # first-order body-rate tracking lag; 0 = ideal
    thrust_tau: float = 0.0  # first-order thrust lag; 0 = ideal
    k_throttle_true: float = 50.0  # plant's true throttle->force gain


@dataclass(frozen=True)
class NdpNmpcConfig:
    """Top-level config bundle."""

    vehicle: VehicleParams = dataclasses.field(default_factory=VehicleParams)
    ocp: OcpParams = dataclasses.field(default_factory=OcpParams)
    estimator: EstimatorParams = dataclasses.field(default_factory=EstimatorParams)
    downwash: DownwashParams = dataclasses.field(default_factory=DownwashParams)
    sim: SimParams = dataclasses.field(default_factory=SimParams)


def default_config() -> NdpNmpcConfig:
    return NdpNmpcConfig()
