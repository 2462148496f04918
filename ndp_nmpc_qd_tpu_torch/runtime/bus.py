"""Python bindings for the qdio native bus + the message schema layer.

Port of `ndp_nmpc_qd_tpu/runtime/bus.py`. Message dtypes mirror the
reference's ROS IDL (`ndp_nmpc/msg/*.msg`, `ndp_nmpc/action/TrackTraj.action`)
as fixed-size numpy records, byte for byte the JAX package's, and topics live
in the same POSIX shared-memory segments (`/qdio_<topic>`): a process of
either package reads the other's topics.

- ODOMETRY          <- nav_msgs/Odometry (the fields the controller reads)
- ATTITUDE_TARGET   <- mavros_msgs/AttitudeTarget (body rate + thrust)
- PRED_XU           <- ndp_nmpc/PredXU (the inter-drone horizon exchange)
- TRAJ_COEFF        <- ndp_nmpc/TrajCoefficients (piecewise polynomial goal)
- TRACK_FEEDBACK / TRACK_RESULT <- TrackTraj.action feedback/result

The native library is the port's own copy of `qdio.cpp`, compiled with g++ at
first use into `build/qdio/` beside the package and named by a hash of its
source (plain ctypes over an extern-C API). `msg_to_traj` builds the port's
`PiecewisePoly` of torch tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

N_NODE = 20  # horizon nodes; PredXU carries N+1 states / N controls
MAX_SEG = 16  # max piecewise-polynomial segments in a TrajCoefficients


ODOMETRY = np.dtype(
    [
        ("t", "f8"),
        ("pos", "f8", 3),
        ("vel", "f8", 3),
        ("quat", "f8", 4),  # wxyz
        ("omega", "f8", 3),
    ]
)

ATTITUDE_TARGET = np.dtype(
    [
        ("t", "f8"),
        ("body_rate", "f8", 3),
        ("thrust", "f8"),
        ("type_mask", "u1"),
        ("_pad", "u1", 7),
    ]
)

PRED_XU = np.dtype(
    [
        ("t", "f8"),
        ("x", "f8", (N_NODE + 1, 10)),
        ("u", "f8", (N_NODE, 4)),
    ]
)

TRAJ_COEFF = np.dtype(
    [
        ("t", "f8"),
        ("n_seg", "i4"),
        ("goal_id", "i4"),
        ("coeff_x", "f8", (MAX_SEG, 8)),
        ("coeff_y", "f8", (MAX_SEG, 8)),
        ("coeff_z", "f8", (MAX_SEG, 8)),
        ("coeff_yaw", "f8", (MAX_SEG, 4)),
        ("t_seg", "f8", MAX_SEG),
        ("final_pt", "f8", 3),
    ]
)

TRACK_FEEDBACK = np.dtype(
    [
        ("t", "f8"),
        ("goal_id", "i4"),
        ("_pad", "i4"),
        ("percent_complete", "f8"),
        ("pos_error", "f8"),
        ("yaw_error", "f8"),
    ]
)

TRACK_RESULT = np.dtype(
    [
        ("t", "f8"),
        ("goal_id", "i4"),
        ("status", "i4"),  # 0 running, 1 succeeded, 2 preempted
        ("pos_rmse", "f8"),
        ("yaw_rmse", "f8"),
    ]
)

POINT = np.dtype([("t", "f8"), ("xyz", "f8", 3)])

# preemption request for the TrackTraj protocol (the actionlib cancel
# channel; the reference checks is_preempt_requested each loop,
# `nmpc_node.py:165-168`). goal_id = -1 cancels whatever is active.
TRAJ_CANCEL = np.dtype([("t", "f8"), ("goal_id", "i4"), ("_pad", "i4")])

# pose broadcast (the tf2 TransformBroadcaster role in `nmpc_node.py`)
POSE = np.dtype([("t", "f8"), ("pos", "f8", 3), ("quat", "f8", 4)])

# follower formation-error feedback (`nmpc_follower_node.py:79-94`)
FORM_ERROR = np.dtype(
    [("t", "f8"), ("err2", "f8"), ("rmse", "f8"), ("n", "i8")]
)


SOURCE = Path(__file__).resolve().parent / "qdio.cpp"
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
_LIB = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """`build/qdio/libqdio-<hash>.so` beside the package, the hash of the
    source and flags: an edited source builds a library of its own."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return Path(__file__).resolve().parents[2] / "build" / "qdio" / f"libqdio-{h}.so"


def build_library() -> Path:
    """Compile qdio.cpp unless built. Daemons started together (processes,
    or threads of one process) may build at once: each compiles to a temp
    file of its own process and thread and renames it into place, so none
    ever loads a partly written library. A failed build raises."""
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lrt", "-pthread"],
                       check=True)
        os.replace(tmp, so)
    return so


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_library()))
        lib.qdio_topic_open.restype = ctypes.c_void_p
        lib.qdio_topic_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.qdio_topic_close.argtypes = [ctypes.c_void_p]
        lib.qdio_topic_unlink.argtypes = [ctypes.c_char_p]
        lib.qdio_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.qdio_read_latest.restype = ctypes.c_int64
        lib.qdio_read_latest.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.qdio_message_count.restype = ctypes.c_uint64
        lib.qdio_message_count.argtypes = [ctypes.c_void_p]
        lib.qdio_rate_create.restype = ctypes.c_void_p
        lib.qdio_rate_create.argtypes = [ctypes.c_double]
        lib.qdio_rate_sleep.restype = ctypes.c_long
        lib.qdio_rate_sleep.argtypes = [ctypes.c_void_p]
        lib.qdio_rate_ticks.restype = ctypes.c_uint64
        lib.qdio_rate_ticks.argtypes = [ctypes.c_void_p]
        lib.qdio_rate_overruns.restype = ctypes.c_uint64
        lib.qdio_rate_overruns.argtypes = [ctypes.c_void_p]
        lib.qdio_rate_destroy.argtypes = [ctypes.c_void_p]
        lib.qdio_monotonic_now.restype = ctypes.c_double
        lib.qdio_monotonic_now.argtypes = []
        _LIB = lib
        return lib


def _shm_name(topic: str) -> bytes:
    return ("/qdio_" + topic.strip("/").replace("/", ".")).encode()


class Topic:
    """One named shared-memory topic of a fixed dtype."""

    def __init__(self, name: str, dtype: np.dtype, capacity: int = 8):
        self._lib = _load()
        self.name = name
        self.dtype = np.dtype(dtype)
        self._h = self._lib.qdio_topic_open(_shm_name(name), self.dtype.itemsize, capacity)
        if not self._h:
            raise OSError(f"qdio_topic_open failed for {name}")
        self._buf = np.zeros((), self.dtype)

    def publish(self, msg: np.ndarray | np.void) -> None:
        arr = np.asarray(msg, self.dtype).reshape(())
        self._lib.qdio_publish(self._h, arr.ctypes.data_as(ctypes.c_void_p))

    def read_latest(self):
        """Returns (seq, msg) — seq == 0 means nothing published yet."""
        seq = self._lib.qdio_read_latest(self._h, self._buf.ctypes.data_as(ctypes.c_void_p))
        return int(seq), self._buf.copy()

    @property
    def count(self) -> int:
        return int(self._lib.qdio_message_count(self._h))

    def close(self):
        if self._h:
            self._lib.qdio_topic_close(self._h)
            self._h = None

    @staticmethod
    def unlink(name: str):
        _load().qdio_topic_unlink(_shm_name(name))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Rate:
    """Absolute-deadline rate loop with overrun accounting (native)."""

    def __init__(self, period_s: float):
        self._lib = _load()
        self._h = self._lib.qdio_rate_create(period_s)
        self.period_s = period_s

    def sleep(self) -> float:
        """Sleep to the next deadline; returns previous-period overrun [s]."""
        return self._lib.qdio_rate_sleep(self._h) * 1e-9

    @property
    def ticks(self) -> int:
        return int(self._lib.qdio_rate_ticks(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.qdio_rate_overruns(self._h))

    def __del__(self):
        try:
            self._lib.qdio_rate_destroy(self._h)
        except Exception:
            pass


def now() -> float:
    return float(_load().qdio_monotonic_now())


def traj_to_msg(traj, goal_id: int = 0) -> np.ndarray:
    """PiecewisePoly (tensors, any device) -> TRAJ_COEFF record."""
    host = lambda t: t.detach().to("cpu", torch.float64).numpy()
    m = np.zeros((), TRAJ_COEFF)
    n = traj.t_seg.shape[0]
    if n > MAX_SEG:
        raise ValueError(f"trajectory has {n} > MAX_SEG segments")
    m["n_seg"] = n
    m["goal_id"] = goal_id
    m["coeff_x"][:n] = host(traj.coeff_xyz[..., 0])
    m["coeff_y"][:n] = host(traj.coeff_xyz[..., 1])
    m["coeff_z"][:n] = host(traj.coeff_xyz[..., 2])
    m["coeff_yaw"][:n] = host(traj.coeff_yaw)
    m["t_seg"][:n] = host(traj.t_seg)
    m["final_pt"] = host(traj.final_pt)
    return m


def msg_to_traj(m: np.ndarray, dtype=torch.float64, device="cpu"):
    """TRAJ_COEFF record -> PiecewisePoly of `dtype` tensors on `device`."""
    from ..traj.polyopt import PiecewisePoly

    n = int(m["n_seg"])
    cxyz = np.stack([m["coeff_x"][:n], m["coeff_y"][:n], m["coeff_z"][:n]], axis=-1)
    t_seg = m["t_seg"][:n]
    t_cum = np.concatenate([[0.0], np.cumsum(t_seg)])
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return PiecewisePoly(
        coeff_xyz=t(cxyz), coeff_yaw=t(m["coeff_yaw"][:n]), t_seg=t(t_seg),
        t_cum=t(t_cum), final_pt=t(m["final_pt"]),
    )
