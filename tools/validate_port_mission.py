"""The mission deviation between the PyTorch port and the JAX package.

BASELINE.md's acceptance bound is a max control deviation < 1e-3 against
the reference controller over a flight. The JAX package is this repo's
reference, so the port is held against it over two missions, each as its
CLI resolves it on the CPU (f32):
- `three_qd_ndp` (leader NDP forecast, two followers, plant-side downwash,
  live recovery, 200 hold ticks then 16 s of the figure-eight, k_true 46):
  the scan controller, cold, 12 QP iterations; u0 (T, 3, 4), x (T, 3, 10)
  and throttle (T, 3) per tick, in assets/mission_golden_three_qd_ndp.npz;
- `one_qd --controller thrust --track-secs 8` (the motor-thrust NMPC, 200
  hold ticks then 8 s of the figure-eight): its dense controller, cold, 12
  QP iterations; the rotor thrusts u0 (T, 1, 4) [N] and x (T, 1, 13) per
  tick, in assets/mission_golden_one_qd_thrust.npz.
Each golden also holds the mission's metrics, its config and the CLI argv
it was recorded with.

  python tools/validate_port_mission.py [--mission thrust] --golden
      Runs the JAX mission on the CPU and writes its golden.
      `chip_smoke.py` holds the port's mission on the card against it.
  python tools/validate_port_mission.py [--mission thrust] [--ticks 4]
      Runs the first ticks of the mission on the CPU in both packages and
      against the golden, and prints the max control deviation beside the
      1e-3 bound (in the controls' own units: the thrust mission's are
      rotor thrusts in N, hover m g / 4 ~ 3.64 N). Exits non-zero past the
      bound.

On the card the port's CLI resolves three_qd_ndp to its scan controller
too, so `chip_smoke.py` holds like against like. The JAX package's own
cross-backend check (`tools/validate_backends.py`) found 2.9e-6 between
its scan and kernel controllers over three_qd_ndp.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

ASSET = os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz")
MISSIONS = {
    "three_qd_ndp": dict(
        golden=os.path.join(ROOT, "assets", "mission_golden_three_qd_ndp.npz"),
        config=dict(topology="three_qd_ndp", hold_ticks=200, track_secs=16.0, k_true=46.0,
                    qp_iters=12, recover=True, dtype="float32"),
        argv=["mission", "three_qd_ndp", "--hold-ticks", "200", "--track-secs", "16.0",
              "--k-true", "46.0"],
        traces=("x", "u0", "throttle"),
    ),
    "thrust": dict(
        golden=os.path.join(ROOT, "assets", "mission_golden_one_qd_thrust.npz"),
        config=dict(topology="one_qd", controller="thrust", hold_ticks=200, track_secs=8.0,
                    qp_iters=12, dtype="float32"),
        argv=["mission", "one_qd", "--controller", "thrust", "--track-secs", "8"],
        traces=("x", "u0"),
    ),
}
BOUND = 1e-3


def jax_three_qd_ndp(n_ticks):
    """The JAX mission's traces (x, u0, throttle) and metrics over n_ticks,
    as the JAX CLI builds it on the CPU (f32, the scan controller)."""
    import jax

    from ndp_nmpc_qd_tpu.cli import build_eight
    from ndp_nmpc_qd_tpu.models.downwash_mlp import load_npz
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig, SimParams
    from ndp_nmpc_qd_tpu.sim.closed_loop import make_episode

    config = MISSIONS["three_qd_ndp"]["config"]
    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=config["k_true"]))
    init_fn, _, run_fn = make_episode(
        cfg, build_eight(), n_drones=3, use_ndp=True, true_downwash=True,
        downwash_params=load_npz(ASSET), qp_iters=config["qp_iters"],
        hold_ticks=config["hold_ticks"], recover=config["recover"], record_traces=True,
    )
    st, metrics, traces = jax.jit(lambda s: run_fn(s, n_ticks))(init_fn())
    x, u0, throttle = (np.asarray(a) for a in traces)
    return dict(x=x, u0=u0, throttle=throttle,
                **{k: np.asarray(getattr(metrics, k)) for k in metrics._fields})


def jax_thrust(n_ticks):
    """The JAX thrust mission over n_ticks as the JAX CLI builds it on the
    CPU (f32, `cli.py:133-145`): its metrics from the CLI's `run_fn`, and
    its traces from the same `step_fn` under a scan, x before each tick and
    u0 read from the plant's actual rotor thrusts after it (the command
    itself: `SimParams.thrust_tau` is 0, no rotor lag)."""
    import jax

    from ndp_nmpc_qd_tpu.cli import build_eight
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig, SimParams
    from ndp_nmpc_qd_tpu.sim.thrust_loop import make_thrust_episode

    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=46.0))
    assert cfg.sim.thrust_tau == 0.0
    config = MISSIONS["thrust"]["config"]
    init_fn, step_fn, run_fn = make_thrust_episode(
        cfg, build_eight(), n_drones=1, hold_ticks=config["hold_ticks"],
        qp_iters=config["qp_iters"])
    st, metrics = jax.jit(lambda s: run_fn(s, n_ticks)[:2])(init_fn())

    def body(s, _):
        new, _ = step_fn(s)
        return new, (s.plant.x, new.plant.f_act)

    st2, (x, u0) = jax.jit(lambda s: jax.lax.scan(body, s, None, length=n_ticks))(init_fn())
    assert np.array_equal(np.asarray(st.plant.x), np.asarray(st2.plant.x))
    return dict(x=np.asarray(x), u0=np.asarray(u0),
                **{k: np.asarray(getattr(metrics, k)) for k in metrics._fields})


def port_mission(name, n_ticks):
    """The port's mission through its CLI on the CPU: (result, traces)."""
    import torch

    from ndp_nmpc_qd_tpu_torch import cli

    m = MISSIONS[name]
    args = cli.make_parser().parse_args(m["argv"] + ["--cpu"])
    torch.set_num_threads(1)
    result, run = cli.run_mission(args, record_traces=True, n_ticks=n_ticks)
    return result, {k: t.numpy() for k, t in zip(m["traces"], run["traces"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mission", choices=tuple(MISSIONS), default="three_qd_ndp")
    ap.add_argument("--golden", action="store_true", help="write the JAX golden and exit")
    ap.add_argument("--ticks", type=int, default=4, help="ticks of the port-vs-JAX check")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    m = MISSIONS[args.mission]
    jax_mission = jax_thrust if args.mission == "thrust" else jax_three_qd_ndp
    n_full = m["config"]["hold_ticks"] + int(m["config"]["track_secs"] / 0.02)
    if args.golden:
        t0 = time.perf_counter()
        g = jax_mission(n_full)
        extra = dict(argv=json.dumps(m["argv"])) if args.mission == "thrust" else {}
        np.savez_compressed(m["golden"], **g, config=json.dumps(m["config"]), **extra)
        print(f"wrote {m['golden']} ({os.path.getsize(m['golden'])} bytes, {n_full} ticks, "
              f"{time.perf_counter() - t0:.1f} s): pos_rmse {g['pos_rmse']}, "
              f"form_rmse {g['form_rmse']}, ok {g['ok']}, recovered {g['recovered']}")
        return
    t0 = time.perf_counter()
    _, port = port_mission(args.mission, args.ticks)
    jx = jax_mission(args.ticks)
    dev = {k: float(np.abs(port[k] - jx[k]).max()) for k in m["traces"]}
    line = dict(mission=args.mission, ticks=args.ticks, bound=BOUND,
                seconds=round(time.perf_counter() - t0, 1),
                **{f"max_{k}_dev_vs_jax": v for k, v in dev.items()})
    if os.path.exists(m["golden"]):
        with np.load(m["golden"]) as g:
            line["max_u0_dev_vs_golden"] = float(np.abs(port["u0"] - g["u0"][:args.ticks]).max())
    print(json.dumps(line))
    worst = max(line["max_u0_dev_vs_jax"], line.get("max_u0_dev_vs_golden", 0.0))
    if not worst < BOUND:
        sys.exit(f"max control deviation {worst} is not below {BOUND}")


if __name__ == "__main__":
    main()
