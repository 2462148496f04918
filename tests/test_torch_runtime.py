"""PyTorch port vs JAX: the runtime layer on the CPU, no live plant.

- The bus: the six smoke tests of `tests/test_runtime.py:27-150` on the
  port's own `qdio.cpp` (round trip, latest value, no torn read, the rate
  executor, overrun detection, the trajectory message).
- Across the packages: the record dtypes are the JAX package's byte for
  byte; a record published by either package's `Topic` is read
  byte-identical by the other's on the same name; `traj_to_msg` of the same
  waypoints gives identical bytes; the port's `msg_to_traj` -> `nmpc_refs`
  equals the JAX one's at 5 times (atol 1e-12, f64).
- `LatencyRecorder` and `HealthCounter` on `tests/test_utils.py:69-81`'s
  values, summaries equal to the JAX package's.
- Daemon parity: one fixed odometry off the hold point, no plant; the JAX
  and the port `ControllerDaemon(solver="scan")` (CPU, f64) each run 13
  ticks on their own namespace, holding, as an NDP leader (a companion's
  horizon 0.9 m above, the forecast active) and as a follower (a leader's
  horizon and a formation offset). The last command and viz horizon (and
  the follower's formation error) agree at
  `tests/test_torch_scan_controller.py:86-87`'s tolerance, rtol 1e-8 and
  atol 1e-10 of the value's scale: the same algorithm rounded in another
  order.
- `solver="packed"` on the CPU (K1's plain version) for 3 ticks
  (`test_runtime.py:420-442`'s checks).
- The CLI: `serve --cpu` runs; `serve`, `simnode`, `send` and
  `bench_torch.py` without a card fail with "no CUDA device".
- `bench_torch.py`'s row functions on CPU tensors at B=8, 3 ticks each (the
  CUDA-graph row needs the card: `tests/test_torch_gpu.py`).
"""

import importlib.util
import json
import pathlib
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.params import NdpNmpcConfig as JaxConfig
from ndp_nmpc_qd_tpu.runtime import bus as jb
from ndp_nmpc_qd_tpu.runtime import nodes as jn
from ndp_nmpc_qd_tpu.traj import polyopt as j_poly
from ndp_nmpc_qd_tpu.traj import refgen as j_refgen
from ndp_nmpc_qd_tpu.utils import metrics as j_metrics
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.runtime import bus as qb
from ndp_nmpc_qd_tpu_torch.runtime import nodes as tn
from ndp_nmpc_qd_tpu_torch.traj import polyopt as t_poly
from ndp_nmpc_qd_tpu_torch.traj import refgen as t_refgen
from ndp_nmpc_qd_tpu_torch.utils import metrics as t_metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = NdpNmpcConfig()
RECORDS = ("ODOMETRY", "ATTITUDE_TARGET", "PRED_XU", "TRAJ_COEFF", "TRACK_FEEDBACK",
           "TRACK_RESULT", "POINT", "TRAJ_CANCEL", "POSE", "FORM_ERROR")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ns():
    name = f"ttest_{uuid.uuid4().hex[:8]}"
    yield name
    for n in (name, name + "_comp", name + "_lead"):
        tn.NodeTopics.unlink(n)


def bench_module():
    spec = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the bus (tests/test_runtime.py:27-150 on the port's library) ----


def test_pub_sub_roundtrip(ns):
    t = qb.Topic(f"{ns}/odom", qb.ODOMETRY)
    seq, _ = t.read_latest()
    assert seq == 0  # nothing yet
    m = np.zeros((), qb.ODOMETRY)
    m["pos"] = [1.0, 2.0, 3.0]
    m["quat"] = [1.0, 0, 0, 0]
    t.publish(m)
    seq, got = t.read_latest()
    assert seq == 1
    np.testing.assert_array_equal(got["pos"], [1.0, 2.0, 3.0])
    t2 = qb.Topic(f"{ns}/odom", qb.ODOMETRY)  # a second reader of the same segment
    seq, got = t2.read_latest()
    assert seq == 1
    np.testing.assert_array_equal(got["pos"], [1.0, 2.0, 3.0])
    t.close()
    t2.close()


def test_latest_value_semantics(ns):
    t = qb.Topic(f"{ns}/x", qb.POINT)
    for k in range(20):
        m = np.zeros((), qb.POINT)
        m["xyz"] = [k, 0, 0]
        t.publish(m)
    seq, got = t.read_latest()
    assert seq == 20
    assert got["xyz"][0] == 19.0
    t.close()
    qb.Topic.unlink(f"{ns}/x")


def test_seqlock_no_torn_reads(ns):
    """A writer thread hammers a topic; every read is one message's
    snapshot (all lanes equal), never a torn mix of two."""
    t_w = qb.Topic(f"{ns}/big", qb.PRED_XU)
    t_r = qb.Topic(f"{ns}/big", qb.PRED_XU)
    stop = threading.Event()

    def writer():
        k = 0
        m = np.zeros((), qb.PRED_XU)
        while not stop.is_set():
            k += 1
            m["x"][:] = float(k)
            m["u"][:] = float(k)
            t_w.publish(m)

    th = threading.Thread(target=writer)
    th.start()
    torn = reads = 0
    t_end = time.time() + 2.0
    try:
        while time.time() < t_end:
            seq, got = t_r.read_latest()
            if seq <= 0:
                continue
            reads += 1
            if len(set(np.unique(got["x"])) | set(np.unique(got["u"]))) != 1:
                torn += 1
    finally:
        stop.set()
        th.join(10)
    assert not th.is_alive()
    assert reads > 200, reads
    assert torn == 0, f"{torn}/{reads} torn reads"
    t_w.close()
    t_r.close()
    qb.Topic.unlink(f"{ns}/big")


def test_rate_executor_timing():
    r = qb.Rate(0.005)
    t0 = qb.now()
    for _ in range(40):
        r.sleep()
    elapsed = qb.now() - t0
    assert elapsed > 0.18, elapsed  # it cannot undersleep
    assert elapsed < 5.0, elapsed  # hung-clock guard only
    assert r.ticks == 40


def test_rate_overrun_detection():
    r = qb.Rate(0.002)
    r.sleep()
    time.sleep(0.02)  # blow the deadline
    overrun = r.sleep()
    assert overrun > 0.01
    assert r.overruns >= 1


def test_traj_msg_roundtrip():
    wpts = np.stack([np.linspace(0, 1, 4), np.zeros(4), np.ones(4)], axis=-1)
    traj = t_poly.fit_waypoints(wpts, np.full(3, 2.0))
    back = qb.msg_to_traj(qb.traj_to_msg(traj, goal_id=7))
    for f in ("coeff_xyz", "coeff_yaw", "t_seg", "t_cum", "final_pt"):
        torch.testing.assert_close(getattr(back, f), getattr(traj, f), rtol=0, atol=1e-12)
    assert back.coeff_xyz.dtype == torch.float64 and back.coeff_xyz.device.type == "cpu"


def test_the_library_is_the_ports_own_build():
    """The port builds its own copy of qdio.cpp into build/qdio/, named by
    the source's hash, and never loads the JAX package's libqdio.so."""
    path = qb.library_path()
    assert path.parent == ROOT / "build" / "qdio" and path.name.startswith("libqdio-")
    qb.now()  # loads it
    loaded = qb._load()._name
    assert pathlib.Path(loaded) == path and "ndp_nmpc_qd_tpu/runtime" not in loaded


# ---- across the packages ----


def test_record_dtypes_match_the_jax_package():
    assert qb.N_NODE == jb.N_NODE and qb.MAX_SEG == jb.MAX_SEG
    for name in RECORDS:
        assert getattr(qb, name) == getattr(jb, name), name
        assert getattr(qb, name).itemsize == getattr(jb, name).itemsize, name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_the_packages_byte_identical(ns, writer):
    """A record of each type published by one package's Topic is read by the
    other's, on the same name, with the same bytes."""
    rng = np.random.default_rng(3)
    pub, sub = (jb, qb) if writer == "jax" else (qb, jb)
    for name in RECORDS:
        dt = getattr(qb, name)
        m = rng.integers(0, 256, dt.itemsize, dtype=np.uint8).view(dt).reshape(())
        topic = f"{ns}/{name.lower()}"
        w, r = pub.Topic(topic, dt), sub.Topic(topic, dt)
        w.publish(m)
        seq, got = r.read_latest()
        assert seq == 1, name
        assert got.tobytes() == m.tobytes(), name
        w.close()
        r.close()
        qb.Topic.unlink(topic)


def test_traj_messages_identical_and_references_equal():
    wpts = np.stack([[0, 0.5, 1.0, 0.5, 0.0], [0, 0.5, 0, -0.5, 0], np.ones(5)], axis=-1)
    yaw = np.array([0.0, 0.3, -0.2, 0.1, 0.0])
    m_j = jb.traj_to_msg(j_poly.fit_waypoints(wpts, np.full(4, 2.0), yaw), goal_id=9)
    m_t = qb.traj_to_msg(t_poly.fit_waypoints(wpts, np.full(4, 2.0), yaw), goal_id=9)
    assert m_t.tobytes() == m_j.tobytes()

    jc = JaxConfig()
    tr_j, tr_t = jb.msg_to_traj(m_j), qb.msg_to_traj(m_t)
    for tt in (0.0, 1.3, 4.0, 7.9, 9.5):  # through every segment and past the end
        xr_j, ur_j = j_refgen.nmpc_refs(tr_j, tt, jc.ocp, jc.vehicle)
        xr_t, ur_t = t_refgen.nmpc_refs(tr_t, tt, CFG.ocp, CFG.vehicle)
        for g, r in ((xr_t, xr_j), (ur_t, ur_j)):
            torch.testing.assert_close(g, torch.tensor(np.asarray(r)), rtol=0, atol=1e-12)


def test_latency_recorder_and_health_counter():
    """`tests/test_utils.py:69-81`'s values, and the JAX package's
    summaries."""
    recs = [t_metrics.LatencyRecorder(budget_s=0.02), j_metrics.LatencyRecorder(budget_s=0.02)]
    hcs = [t_metrics.HealthCounter(), j_metrics.HealthCounter()]
    for rec in recs:
        for v in [0.001, 0.002, 0.05]:
            rec.record(v)
    for hc in hcs:
        hc.update(np.asarray([True, True, False]))
        hc.update(np.asarray([True, True, True]))
    s = recs[0].summary()
    assert s["count"] == 3 and s["overruns"] == 1
    assert s["p99_ms"] >= s["p50_ms"]
    assert s == recs[1].summary()
    h = hcs[0].summary()
    assert h["solves"] == 6 and h["unhealthy"] == 1 and h["worst_streak"] == 1
    assert h == hcs[1].summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_metrics.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


# ---- daemon parity ----


def odometry():
    """One fixed odometry off the hold point: moving, tilted and yawed."""
    m = np.zeros((), qb.ODOMETRY)
    m["pos"] = [0.3, -0.2, 1.1]
    m["vel"] = [0.2, 0.1, -0.1]
    q = np.array([1.0, 0.05, -0.03, 0.1])
    m["quat"] = q / np.linalg.norm(q)
    return m


def set_up(ns, mode):
    """Publish the daemon's inputs on `ns` and return its extra arguments."""
    qb.Topic(f"{ns}/odom", qb.ODOMETRY).publish(odometry())
    if mode == "ndp":
        c = np.zeros((), qb.PRED_XU)
        c["x"][:, 0] = 0.2
        c["x"][:, 2] = 1.9  # 0.8 m above: the forecast active
        c["x"][:, 6] = 1.0
        qb.Topic(f"{ns}_comp/ref_x_u", qb.PRED_XU).publish(c)
        return dict(use_ndp=True, companion_ns=ns + "_comp")
    if mode == "follower":
        lead = np.zeros((), qb.PRED_XU)
        lead["x"][:, 2] = 1.0
        lead["x"][:, 6] = 1.0
        lead["u"][:, 3] = CFG.vehicle.gravity
        qb.Topic(f"{ns}_lead/ref_x_u", qb.PRED_XU).publish(lead)
        off = np.zeros((), qb.POINT)
        off["xyz"] = [0.0, 1.0, 0.0]
        qb.Topic(f"{ns}/formation_ref", qb.POINT).publish(off)
        return dict(leader_ns=ns + "_lead")
    return {}


def assert_close_at_scale(got, want, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * scale, err_msg=msg)


@pytest.mark.parametrize("mode", ["hold", "ndp", "follower"])
def test_daemon_matches_jax_daemon(mode):
    ns_j, ns_t = f"pj_{uuid.uuid4().hex[:8]}", f"pt_{uuid.uuid4().hex[:8]}"
    try:
        dj = jn.ControllerDaemon(ns_j, solver="scan", **set_up(ns_j, mode))
        kw = set_up(ns_t, mode)
        if mode == "ndp":
            kw["downwash_params"] = load_npz(tn.default_downwash_asset(), dtype=torch.float64,
                                             device="cpu")
        dt = tn.ControllerDaemon(ns_t, solver="scan", device="cpu", **kw)
        assert dt.pipeline is False and dt.dtype == torch.float64
        assert dj.run(max_ticks=13)["ticks"] == 13
        res = dt.run(max_ticks=13)
        assert res["ticks"] == 13 and res["recoveries"] == 0
        pairs = [(dt.t.att, dj.t.att, ("body_rate", "thrust")),
                 (dt.t.viz_pred, dj.t.viz_pred, ("x", "u")),
                 (dt.t.ref_x_u, dj.t.ref_x_u, ("x", "u"))]
        if mode == "follower":
            pairs.append((dt.t.formation_err, dj.t.formation_err, ("err2", "rmse", "n")))
        for t_topic, j_topic, fields in pairs:
            (seq_t, m_t), (seq_j, m_j) = t_topic.read_latest(), j_topic.read_latest()
            assert seq_t == seq_j > 0, (t_topic.name, seq_t, seq_j)
            for f in fields:
                assert_close_at_scale(m_t[f], m_j[f], f"{mode}: {t_topic.name} {f}")
        if mode == "ndp":  # the forecast moved the command away from the hold's
            hold = tn.ControllerDaemon(f"ph_{uuid.uuid4().hex[:8]}", solver="scan", device="cpu")
            try:
                set_up(hold.ns, "hold")
                hold.run(max_ticks=13)
                _, a_hold = hold.t.att.read_latest()
                _, a_ndp = dt.t.att.read_latest()
                assert abs(float(a_ndp["thrust"]) - float(a_hold["thrust"])) > 1e-3
            finally:
                tn.NodeTopics.unlink(hold.ns)
    finally:
        for n in (ns_j, ns_t):
            for suffix in ("", "_comp", "_lead"):
                tn.NodeTopics.unlink(n + suffix)


def test_daemon_packed_solver_on_the_cpu(ns):
    """`solver="packed"`: the deployed controller at B=1 on K1's plain
    version, kernel-layout state; finite commands, viz published."""
    qb.Topic(f"{ns}/odom", qb.ODOMETRY).publish(odometry())
    ctl = tn.ControllerDaemon(ns, solver="packed", device="cpu")
    assert ctl.solver == "packed" and ctl.dtype == torch.float32 and ctl.pipeline is False
    res = ctl.run(max_ticks=3)
    assert res["ticks"] == 3
    _, att = ctl.t.att.read_latest()
    assert np.isfinite(att["body_rate"]).all() and np.isfinite(att["thrust"])
    vseq, viz = ctl.t.viz_pred.read_latest()
    assert vseq > 0
    assert np.isfinite(viz["x"]).all()
    np.testing.assert_allclose(np.linalg.norm(viz["x"][:, 6:10], axis=-1), 1.0, atol=1e-12)


def test_daemon_stops_on_its_event_before_odometry(ns):
    ctl = tn.ControllerDaemon(ns, device="cpu")
    stop = threading.Event()
    stop.set()
    assert ctl.run(stop_event=stop)["ticks"] == 0


# ---- the CLI and the bench ----


def test_serve_cli_on_the_cpu(ns, capsys):
    from ndp_nmpc_qd_tpu_torch.cli import main

    qb.Topic(f"{ns}/odom", qb.ODOMETRY).publish(odometry())
    main(["serve", "--ns", ns, "--max-ticks", "5", "--cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ticks"] == 5 and out["recoveries"] == 0
    _, att = qb.Topic(f"{ns}/attitude_target", qb.ATTITUDE_TARGET).read_latest()
    assert np.isfinite(att["body_rate"]).all()


@pytest.mark.parametrize("cmd", ["serve", "simnode", "send", "bench"])
def test_without_a_card_and_without_cpu_it_fails(cmd, monkeypatch, ns):
    from ndp_nmpc_qd_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cmd == "bench":
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench_module().main([])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([cmd, "--ns", ns, "--max-ticks", "1"])


def test_bench_rows_on_cpu_tensors():
    """Every row function but the CUDA graph's, at B=8 (the scan row at
    B=1 as the daemon runs it), 3 ticks each: the row schema, finite and
    healthy."""
    bt = bench_module()
    dev = torch.device("cpu")
    ins = bt.inputs(8, dev, seed=0)
    flags = bt.deployed_flags()
    assert flags["whole_step"] and flags["warm_start"] and flags["qp_iters"] == 3
    ctl = bt.make_batched_rti_controller(bt.CFG.ocp, bt.CFG.vehicle, device=dev, **flags)
    step = bt.control_step(ctl, bt.load_npz(bt.ASSET, device=dev), True)
    row, _ = bt.row_throughput(step, ctl.reset(ins[1], ins[2]), ins, iters=3, lat_ticks=3)
    assert row["B"] == 8 and row["ok"] == 8 and row["u0_finite"]
    assert row["device_step_ms"] is None and row["wall_step_ms"] > 0  # no device time off the card
    assert row["solves_per_s"] == pytest.approx(8e3 / row["wall_step_ms"])

    rows = bt.interactive_rows(ins, Bs=(1,), packed=False, warm=1, ticks=3)
    rows |= bt.rows_interactive("interactive_B8_packed", ctl, ins[0], ins[1], ins[2],
                                torch.zeros(8, bt.N + 1, 3), "cuda_whole_step", "deployed",
                                warm=1, ticks=3)
    assert set(rows) == {"interactive_B1", "interactive_B1_pipelined", "interactive_B8_packed",
                         "interactive_B8_packed_pipelined"}
    for tag, r in rows.items():
        assert r["p99_ms"] >= r["p50_ms"] > 0, tag
        assert r["meets_deadline_p99"] == (r["p99_ms"] < 20.0)
        assert r["samples"] == 3 and r["device"] == "cpu" and r["backend"] and r["config"]
        assert r["B"] == (1 if "B1" in tag else 8)
        assert ("staleness_ticks" in r) == tag.endswith("_pipelined")

    cpu = bt.row_cpu_daemon(ins, warm=3, ticks=3)
    assert cpu["ok"] and cpu["dtype"] == "float64" and cpu["p99_ms"] >= cpu["p50_ms"] > 0
