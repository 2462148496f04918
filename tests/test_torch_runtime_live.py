"""The port's runtime daemons live on the CPU: the plant and the controller
(`device="cpu"`, the scan controller) as threads of this process over the
shared-memory bus, the TrackTraj protocol driven as `tests/test_runtime.py`
drives the JAX daemons: one goal, preempt then resume, a goal superseded.

They hold the protocol: each goal's result and status, feedback, a finite
RMSE, the pose published, the GC restored. They do not hold the JAX
tests' 0.25 m RMSE bound, nor that no solve recovers: on the CPU the
port's scan tick takes longer than the 20 ms period (its overruns are
printed), so the loop runs late, the later the busier the machine; the
bound and no recovery are held on the card (`chip_smoke.py` phase 10,
`tests/test_torch_gpu.py`). The trajectories are short (2-4 s) to keep the
file's time down; nothing here bounds a wall-clock latency.
"""

import gc
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu_torch.runtime import bus as qb
from ndp_nmpc_qd_tpu_torch.runtime.nodes import (
    ControllerDaemon, NodeTopics, PlantDaemon, send_trajectory,
)
from ndp_nmpc_qd_tpu_torch.traj.polyopt import fit_waypoints

WPTS = np.stack([[0, 0.5, 1.0], [0, 0.5, 0], np.ones(3)], axis=-1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def live():
    """A plant and a controller daemon in threads on a fresh namespace;
    yields (controller, results); stops and joins both after the test."""
    ns = f"tlive_{uuid.uuid4().hex[:8]}"
    plant = PlantDaemon(ns, device="cpu")
    ctl = ControllerDaemon(ns, device="cpu")
    assert ctl.solver == "scan" and ctl.pipeline is False
    stop = threading.Event()
    results = {}

    def run(name, fn, **kw):
        results[name] = fn(stop_event=stop, **kw)

    pr, cr = threading.Event(), threading.Event()
    threads = [threading.Thread(target=run, args=("plant", plant.run), kwargs=dict(ready_event=pr)),
               threading.Thread(target=run, args=("ctl", ctl.run), kwargs=dict(ready_event=cr))]
    threads[0].start()
    assert pr.wait(30)
    threads[1].start()
    assert cr.wait(60)
    try:
        yield ctl, results
    finally:
        stop.set()
        for th in threads:
            th.join(30)
        NodeTopics.unlink(ns)
    assert not any(th.is_alive() for th in threads)
    print(f"controller {results['ctl']}, plant {results['plant']}")
    assert gc.isenabled()  # the real-time GC policy restored on exit
    pseq, pose = ctl.t.pose.read_latest()  # the tf2-role pose broadcast ran
    assert pseq > 0 and np.isfinite(pose["pos"]).all() and np.isfinite(pose["quat"]).all()


def test_live_mission_one_goal(live):
    ctl, _ = live
    res, feedback = send_trajectory(ctl.ns, fit_waypoints(WPTS, np.full(2, 1.0)), goal_id=3,
                                    timeout_s=30)
    assert int(res["goal_id"]) == 3 and int(res["status"]) == 1
    assert np.isfinite(res["pos_rmse"]) and np.isfinite(res["yaw_rmse"])
    assert len(feedback) > 3
    assert all(int(f["goal_id"]) == 3 for f in feedback)
    assert ctl.goal_to_first_cmd_s is not None and ctl.goal_to_first_cmd_s >= 0
    print(f"pos_rmse {float(res['pos_rmse']):.4f} m")


def test_live_preempt_then_resume(live):
    ctl, _ = live
    long_traj = fit_waypoints(WPTS, np.full(2, 2.0))
    res, feedback = send_trajectory(ctl.ns, long_traj, goal_id=11, timeout_s=30,
                                    cancel_after_s=0.6)
    assert int(res["goal_id"]) == 11 and int(res["status"]) == 2, res  # preempted
    assert len(feedback) >= 1 and np.isfinite(res["pos_rmse"])  # the partial RMSE
    res2, _ = send_trajectory(ctl.ns, fit_waypoints(WPTS, np.full(2, 1.0)), goal_id=12,
                              timeout_s=30)
    assert int(res2["goal_id"]) == 12 and int(res2["status"]) == 1, res2
    assert np.isfinite(res2["pos_rmse"])


def test_live_new_goal_supersedes_active(live):
    """A new goal while one is active: the old goal's result is status 2,
    then the new goal completes."""
    ctl, _ = live
    topics = ctl.t
    count0 = topics.result.count
    topics.goal.publish(qb.traj_to_msg(fit_waypoints(WPTS, np.full(2, 2.0)), goal_id=21))
    time.sleep(0.6)
    topics.goal.publish(qb.traj_to_msg(fit_waypoints(WPTS, np.full(2, 1.0)), goal_id=22))
    results = {}
    seen = count0
    t_end = time.time() + 30
    while time.time() < t_end and len(results) < 2:
        if topics.result.count > seen:
            seen = topics.result.count
            _, res = topics.result.read_latest()
            results[int(res["goal_id"])] = int(res["status"])
        time.sleep(0.01)
    assert results == {21: 2, 22: 1}, results
