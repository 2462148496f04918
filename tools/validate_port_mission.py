"""The mission deviation between the PyTorch port and the JAX package.

BASELINE.md's acceptance bound is a max control deviation < 1e-3 against
the reference controller over a flight. The JAX package is this repo's
reference, so the port is held against it over the `three_qd_ndp` mission
(leader NDP forecast, two followers, plant-side downwash, live recovery,
200 hold ticks then 16 s of the figure-eight, k_true 46) as each CLI
resolves it.

  python tools/validate_port_mission.py --golden
      Runs the JAX mission on the CPU as its CLI resolves a 3-drone
      topology there (the scan controller, cold, 12 QP iterations, f32) and
      writes assets/mission_golden_three_qd_ndp.npz: u0 (T, 3, 4), x
      (T, 3, 10) and throttle (T, 3) per tick, the metrics and the config.
      `chip_smoke.py` holds the port's mission on the card against it.
  python tools/validate_port_mission.py [--ticks 4]
      Runs the first ticks of the same mission on the CPU in both packages
      (each CLI resolves a 3-drone topology to its scan controller) and
      against the golden, and prints the max control deviation beside the
      1e-3 bound. Exits non-zero past the bound.

On the card the port's CLI resolves this topology to its scan controller
too, so `chip_smoke.py` holds like against like. The JAX package's own
cross-backend check (`tools/validate_backends.py`) found 2.9e-6 between
its scan and kernel controllers over this mission.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

GOLDEN = os.path.join(ROOT, "assets", "mission_golden_three_qd_ndp.npz")
ASSET = os.path.join(ROOT, "assets", "downwash_analytic_sn4.npz")
CONFIG = dict(topology="three_qd_ndp", hold_ticks=200, track_secs=16.0, k_true=46.0,
              qp_iters=12, recover=True, dtype="float32")
BOUND = 1e-3


def jax_mission(n_ticks):
    """The JAX mission's traces (x, u0, throttle) and metrics over n_ticks,
    as the JAX CLI builds it on the CPU (f32, the scan controller)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ndp_nmpc_qd_tpu.cli import build_eight
    from ndp_nmpc_qd_tpu.models.downwash_mlp import load_npz
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig, SimParams
    from ndp_nmpc_qd_tpu.sim.closed_loop import make_episode

    cfg = NdpNmpcConfig(sim=SimParams(k_throttle_true=CONFIG["k_true"]))
    init_fn, _, run_fn = make_episode(
        cfg, build_eight(), n_drones=3, use_ndp=True, true_downwash=True,
        downwash_params=load_npz(ASSET), qp_iters=CONFIG["qp_iters"],
        hold_ticks=CONFIG["hold_ticks"], recover=CONFIG["recover"], record_traces=True,
    )
    st, metrics, traces = jax.jit(lambda s: run_fn(s, n_ticks))(init_fn())
    x, u0, throttle = (np.asarray(a) for a in traces)
    return dict(x=x, u0=u0, throttle=throttle,
                **{k: np.asarray(getattr(metrics, k)) for k in metrics._fields})


def port_mission(n_ticks, track_secs):
    """The port's mission through its CLI on the CPU (its scan controller):
    (result, traces)."""
    import torch

    from ndp_nmpc_qd_tpu_torch import cli

    args = cli.make_parser().parse_args([
        "mission", CONFIG["topology"], "--cpu", "--hold-ticks", str(CONFIG["hold_ticks"]),
        "--track-secs", str(track_secs), "--k-true", str(CONFIG["k_true"]),
    ])
    torch.set_num_threads(1)
    result, run = cli.run_mission(args, record_traces=True, n_ticks=n_ticks)
    x, u0, throttle = (t.numpy() for t in run["traces"])
    return result, dict(x=x, u0=u0, throttle=throttle)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", action="store_true", help="write the JAX golden and exit")
    ap.add_argument("--ticks", type=int, default=4, help="ticks of the port-vs-JAX check")
    args = ap.parse_args()
    n_full = CONFIG["hold_ticks"] + int(CONFIG["track_secs"] / 0.02)
    if args.golden:
        t0 = time.perf_counter()
        g = jax_mission(n_full)
        np.savez_compressed(GOLDEN, **g, config=json.dumps(CONFIG))
        print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes, {n_full} ticks, "
              f"{time.perf_counter() - t0:.1f} s): pos_rmse {g['pos_rmse']}, "
              f"form_rmse {g['form_rmse']}, ok {g['ok']}, recovered {g['recovered']}")
        return
    t0 = time.perf_counter()
    _, port = port_mission(args.ticks, CONFIG["track_secs"])
    jx = jax_mission(args.ticks)
    dev = {k: float(np.abs(port[k] - jx[k]).max()) for k in ("u0", "throttle", "x")}
    line = dict(ticks=args.ticks, max_u0_dev_vs_jax=dev["u0"],
                max_throttle_dev_vs_jax=dev["throttle"], max_x_dev_vs_jax=dev["x"],
                bound=BOUND, seconds=round(time.perf_counter() - t0, 1))
    if os.path.exists(GOLDEN):
        with np.load(GOLDEN) as g:
            line["max_u0_dev_vs_golden"] = float(np.abs(port["u0"] - g["u0"][:args.ticks]).max())
    print(json.dumps(line))
    worst = max(line["max_u0_dev_vs_jax"], line.get("max_u0_dev_vs_golden", 0.0))
    if not worst < BOUND:
        sys.exit(f"max control deviation {worst} is not below {BOUND}")


if __name__ == "__main__":
    main()
