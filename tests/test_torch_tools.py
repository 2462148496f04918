"""The port's tools (`tools/*_torch.py`) on the CPU, at a few ticks or a
small batch.

The envelope sweep on the scan controller is held against the JAX tool's
JSON line on the same sweep (float64): the same `n_ok` and
`first_not_ok_m`, `max_eq_res` within 1e-12 (both are rounding noise of a
dynamics-exact iterate). The kernel paths run their plain versions here;
on the card `chip_smoke.py` runs the tools' sweeps and validations.
"""

import importlib.util
import json
import os
import sys
import threading
import uuid

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the suite's latency-bound JAX daemon
    tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_tool(name):
    """`tools/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_qp_envelope_matches_the_jax_tool(capsys, monkeypatch):
    argv = ["--iters", "12", "--max-d", "12", "--step", "3"]
    got = load_tool("qp_envelope_torch").main(argv + ["--cpu"])
    assert got["dtype"] == "float64" and got["device"] == "cpu"
    monkeypatch.setattr(sys, "argv", ["qp_envelope.py"] + argv)
    capsys.readouterr()
    load_tool("qp_envelope").main()
    want = last_json(capsys.readouterr().out)
    for key in ("iters", "backend", "warm", "lqr_start", "whole_ipm", "bf16", "mehrotra",
                "dtype", "n_ok", "n", "first_not_ok_m"):
        assert got[key] == want[key], key
    assert got["n_ok"] == 4
    np.testing.assert_allclose(got["max_eq_res"], want["max_eq_res"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("flags", [["--whole-ipm", "--bf16", "--warm"], ["--no-lqr-start"], []])
def test_qp_envelope_kernel_paths(flags, capsys):
    """The kernel flags as the JAX tool maps them: K3 + K2; K3, K4 + K5;
    K3, K6 + K7, K4 + K5 (their plain versions on the CPU)."""
    tool = load_tool("qp_envelope_torch")
    got = tool.main(["--cpu", "--backend", "pallas", "--iters", "3", "--max-d", "20", "--step",
                     "5"] + flags)
    line = last_json(capsys.readouterr().out)
    assert line == {k: v for k, v in got.items() if k != "lines"}
    assert got["n_ok"] == got["n"] == 4 and got["first_not_ok_m"] is None
    assert got["lqr_start"] == (flags == []) and got["whole_ipm"] == ("--whole-ipm" in flags)


def test_qp_envelope_sweep_takes_any_controller():
    """`sweep` runs on a built controller: the deployed one-kernel step
    (K1's plain version), float32."""
    from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
    from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller

    tool = load_tool("qp_envelope_torch")
    cfg = NdpNmpcConfig()
    ctl = make_batched_rti_controller(cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=3,
                                      warm_start=True, jac_bf16=True, packed_state=True,
                                      whole_step=True, device="cpu")
    ds = tool.offsets(10.0, 5.0)
    res = tool.sweep(ctl, ds, torch.float32, "cpu")
    s = tool.summary(ds, res)
    assert s["n"] == 2 and s["n_ok"] == 2 and res["u0"].shape == (2, 4)
    assert np.isfinite(res["u0"]).all()


def test_validate_backends_on_the_cpu(capsys):
    out = load_tool("validate_backends_torch").main(
        ["--cpu", "--ticks", "2", "--hold-ticks", "1", "--whole-step"])
    assert last_json(capsys.readouterr().out) == out
    assert set(out) >= {"pallas", "whole_step_bf16"} and out["pass"] and out["ticks"] == 2
    for name in ("pallas", "whole_step_bf16"):
        assert out[name]["max_control_deviation"] < 1e-3


def test_bench_points_on_the_cpu(capsys):
    rows = load_tool("bench_points_torch").run([8], torch.device("cpu"), iters=1, blocking=1)
    assert [last_json(capsys.readouterr().out)] == rows
    (row,) = rows
    assert row["B"] == 8 and row["ok"] == 8 and row["device_step_ms"] is None
    assert row["whole_step"] and row["qp_iters"] == 3 and row["card"] == "cpu"


def test_bench_ipm_whole_on_the_cpu():
    res = load_tool("bench_ipm_whole_torch").run(8, 2, 1, torch.device("cpu"))
    assert res["bad"] == [] and res["card"] == "cpu" and res["whole_ms"] > 0


def test_live_plot_reads_the_ports_bus(tmp_path):
    from ndp_nmpc_qd_tpu_torch.runtime import bus as qb

    tool = load_tool("live_plot_torch")
    ns, quiet = (f"lp_{uuid.uuid4().hex[:8]}" for _ in range(2))
    names = [f"{n}/{t}" for n in (ns, quiet) for t in ("odom", "attitude_target", "ref_x_u")]
    odom = qb.Topic(names[0], qb.ODOMETRY)
    att = qb.Topic(names[1], qb.ATTITUDE_TARGET)
    stop = threading.Event()

    def publish():
        m, a = np.zeros((), qb.ODOMETRY), np.zeros((), qb.ATTITUDE_TARGET)
        k = 0
        while not stop.is_set():
            m["pos"], m["quat"] = [0.01 * k, 0.0, 1.0], [1.0, 0.0, 0.0, 0.0]
            a["body_rate"], a["thrust"] = [0.1, 0.0, 0.0], 0.5
            odom.publish(m)
            att.publish(a)
            k += 1
            stop.wait(0.005)

    th = threading.Thread(target=publish)
    th.start()
    try:
        out = str(tmp_path / "dash.png")
        a = tool.main(["--cpu", "--ns", ns, "--secs", "0.3", "--rate", "50", "--out", out])
        assert os.path.getsize(out) > 0
        assert a.shape[1] == 14 and len(a) >= 5
        assert np.isnan(a[:, 7:10]).all()  # no reference horizon was published
        np.testing.assert_array_equal(a[:, 10:13], np.tile([0.1, 0.0, 0.0], (len(a), 1)))
        with pytest.raises(SystemExit):
            tool.main(["--cpu", "--ns", quiet, "--secs", "0.05", "--out", out])
    finally:
        stop.set()
        th.join()
        for t in (odom, att):
            t.close()
        for name in names:
            qb.Topic.unlink(name)

