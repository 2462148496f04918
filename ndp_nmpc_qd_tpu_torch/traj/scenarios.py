"""Scenario loading: yaml waypoint files -> fitted trajectories.

Port of `ndp_nmpc_qd_tpu/traj/scenarios.py`; the repo's `configs/*.yaml`
are the data. Schema:

    name: eight_high_dyn
    xyz_method: snap | jerk | acceleration | velocity
    yaw_method: acceleration
    t_segment: 2.0            # uniform, OR
    t_segments: [2.0, 1.5]    # per-segment
    waypoints: [[x, y, z, yaw], ...]

`yaml` (pyyaml) is imported when a file is read: it is needed for
`--scenario` only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .polyopt import MinMethod, PiecewisePoly, fit_waypoints

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs")

_METHODS = {m.value: m for m in MinMethod}


def load_scenario(path_or_name: str, dtype=torch.float64, device="cpu") -> PiecewisePoly:
    """Load a scenario yaml by path, or by name from configs/."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            "--scenario reads a yaml file and needs pyyaml, which is not installed here; "
            "run without --scenario for the built-in figure-eight"
        ) from e
    path = path_or_name
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, path_or_name)
        if not path.endswith(".yaml"):
            path += ".yaml"
    with open(path) as f:
        spec = yaml.safe_load(f)

    wpts = np.asarray(spec["waypoints"], dtype=np.float64)
    assert wpts.ndim == 2 and wpts.shape[1] in (3, 4), wpts.shape
    m = len(wpts) - 1
    if "t_segments" in spec:
        t_seg = np.asarray(spec["t_segments"], dtype=np.float64)
        assert len(t_seg) == m, (len(t_seg), m)
    else:
        t_seg = np.full(m, float(spec.get("t_segment", 2.0)))
    return fit_waypoints(
        wpts[:, 0:3], t_seg, wpts[:, 3] if wpts.shape[1] == 4 else None,
        xyz_method=_METHODS[spec.get("xyz_method", "snap")],
        yaw_method=_METHODS[spec.get("yaw_method", "acceleration")],
        dtype=dtype, device=device,
    )


def list_scenarios() -> list:
    if not os.path.isdir(CONFIG_DIR):
        return []
    return sorted(f[:-5] for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml"))
