"""The PyTorch port over the cards of one host, one process a card.

For each world size W (default 1, 2 and 4, those above the card count
left out), one launch of W processes (`parallel/launch.spawn`, NCCL) runs
on every rank, in this order (`entry.multichip_rank`, then the episode):
1. `entry.dryrun_multichip` on its default mesh (data W/2 x swarm 2 at an
   even W): every drone `ok`, the data-parallel training step (its
   averaged gradients, loss and weights) against the one-process step on
   the whole batch (`entry.train_step_diff`, here);
2. `bench_torch.py`'s sharded row (`deployed.sharded_row_rank`: the
   deployed step at B=65536 on this rank's block of the scenarios over the
   1-D data mesh, 30 chained ticks, the slowest rank's time), its scaling
   efficiency against one card's step measured first in this process
   (`bench_torch.row_throughput`, CUDA events);
3. the formation swarm (21844 three-drone NDP formations, 65532 drones,
   so that the drones split evenly over 1, 2 and 4 ranks) as a sharded
   episode with the drones over the swarm axis (mesh
   data 1 x swarm W: three all_gathers of the horizons a tick), the
   deployed flags with batch-first state (K3 + K2 a tick), `--ticks` ticks
   with half of them holding, after a 2-tick warm-up run: ms a tick (host
   clock between synchronisations, the slowest rank), `ok`, and the
   positions' RMSE and final plant state against world 1's.

    python tools/multicard_torch.py [--worlds 1,2,4] [--ticks 100]
        [--out build/multicard_torch.json]

Prints the card's name and power limit, a line per world, and writes every
row to `--out`. Runs on the cards only: without one it fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from ndp_nmpc_qd_tpu_torch import cli, resolve_device  # noqa: E402
from ndp_nmpc_qd_tpu_torch.deployed import (  # noqa: E402
    ASSET, CFG, FLAGS, card_line, control_step, inputs,
)
from ndp_nmpc_qd_tpu_torch.entry import multichip_rank, train_step_diff  # noqa: E402
from ndp_nmpc_qd_tpu_torch.models.downwash_mlp import load_npz  # noqa: E402
from ndp_nmpc_qd_tpu_torch.ops.kernels import ipm_whole, linearize  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel import distributed  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel.episode import make_sharded_episode  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel.launch import spawn  # noqa: E402
from ndp_nmpc_qd_tpu_torch.parallel.mesh import all_reduce, barrier, make_mesh  # noqa: E402
from ndp_nmpc_qd_tpu_torch.sim.swarm_scale import grid_placement  # noqa: E402
from ndp_nmpc_qd_tpu_torch.solver.rti import make_batched_rti_controller  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 65536
GROUPS = 21844
SEED = 0


def episode_rank(ticks):
    """The formation swarm sharded over the swarm axis of every rank; this
    rank's drones. Returns host values."""
    world = distributed.process_count()
    mesh = make_mesh(world, swarm_axis=world)
    dev = mesh.device
    kw = dict(n_groups=GROUPS, anchors=grid_placement(GROUPS), use_ndp=True,
              downwash_params=load_npz(ASSET, device=dev), true_downwash=True,
              qp_iters=3, solver_warm_start=True, solver_whole_ipm=True, solver_jac_bf16=True,
              solver_packed_state=False, solver_whole_step=True, solver_backend="pallas",
              recover=True, hold_ticks=ticks // 2)
    init, run = make_sharded_episode(CFG, cli.build_eight(device=dev), mesh,
                                     n_drones=3 * GROUPS, scenario_batch=1, **kw)
    run(init(dtype=torch.float32), 2)  # the group's first collectives, the kernels' first launch
    st0 = init(dtype=torch.float32)
    torch.cuda.synchronize(dev)
    barrier(mesh, "swarm")
    linearize.linearize_stage_data.launches = ipm_whole.riccati_ipm_whole.launches = 0
    t0 = time.perf_counter()
    st, m, _ = run(st0, ticks)
    torch.cuda.synchronize(dev)
    elapsed = torch.tensor(time.perf_counter() - t0, dtype=torch.float64, device=dev)
    all_reduce(mesh, "swarm", elapsed, op=dist.ReduceOp.MAX)
    return {"ms_per_tick": float(elapsed) * 1e3 / ticks, "ok": m.ok.cpu().numpy(),
            "pos_rmse": m.pos_rmse.cpu().numpy(), "x": st.plant.x.cpu().numpy(),
            "launches": {"K3": linearize.linearize_stage_data.launches,
                         "K2": ipm_whole.riccati_ipm_whole.launches}}


def world_rank(single_sps, ticks):
    """One rank of a world: the dry run and the row, then the episode."""
    res = multichip_rank(B, SEED, single_sps)
    res["episode"] = episode_rank(ticks)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "multicard_torch.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cards = torch.cuda.device_count()
    every = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{cards} card(s): {every}", flush=True)
    worlds = [w for w in (int(v) for v in args.worlds.split(",")) if w <= cards]

    ctl = make_batched_rti_controller(CFG.ocp, CFG.vehicle, device=dev, **FLAGS)
    step = control_step(ctl, load_npz(ASSET, device=dev), True)
    ins = inputs(B, dev, SEED)
    single, _ = bench_torch.row_throughput(step, ctl.reset(ins[1], ins[2]), ins)
    single_sps = single["solves_per_s"]
    print(f"one card: B={B} device step {single['device_step_ms']:.3f} ms, {single_sps:.1f} "
          f"solves/s", flush=True)
    del ctl, step, ins
    torch.cuda.empty_cache()

    out = {"card": card, "cards": cards, "every_card": every, "single": single, "worlds": {}}
    ref = None
    for w in worlds:
        t0 = time.perf_counter()
        res = spawn(world_rank, w, args=(single_sps, args.ticks), timeout_s=900)
        t_launch = time.perf_counter() - t0
        row = res[0]["row"]
        assert res[0]["skip"] is None and all(r["row"] == row for r in res), res[0]["skip"]
        ep = [r["episode"] for r in res]
        pos = np.concatenate([e["pos_rmse"] for e in ep], axis=1)
        x = np.concatenate([e["x"] for e in ep], axis=1)
        ok = np.concatenate([e["ok"] for e in ep], axis=1)
        if ref is None:
            ref = (pos, x)
        dry = [r["dry"] for r in res]
        rec = {"row": row, "k1_per_rank": [r["k1"] for r in res],
               "dryrun": [{"mesh": d["mesh"], "loss": d["loss"],
                           "ok": int(np.sum(d["episode"]["ok"]) + np.sum(d["formation"]["ok"])),
                           "drones": int(np.size(d["episode"]["ok"])
                                         + np.size(d["formation"]["ok"]))} for d in dry],
               "train_step_vs_one_process": train_step_diff(dry, dev),
               "episode": {"ms_per_tick": ep[0]["ms_per_tick"], "ok": int(ok.sum()),
                           "drones": int(ok.size), "launches_per_rank": [e["launches"] for e in ep],
                           "pos_rmse_max_diff_vs_world1": float(np.abs(pos - ref[0]).max()),
                           "x_max_diff_vs_world1": float(np.abs(x - ref[1]).max())},
               "launch_s": t_launch}
        out["worlds"][str(w)] = rec
        print(f"world {w}: {json.dumps(rec)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    for w, rec in out["worlds"].items():
        e = rec["episode"]
        print(f"summary world {w} ({card}): row {rec['row']['solves_per_s']} solves/s, efficiency "
              f"{rec['row']['scaling_efficiency_vs_single']}, ok {rec['row']['ok']}; dry run ok "
              f"{sum(d['ok'] for d in rec['dryrun'])}/{sum(d['drones'] for d in rec['dryrun'])}, "
              f"training step {json.dumps(rec['train_step_vs_one_process'])}; "
              f"episode {e['ms_per_tick']:.3f} ms a tick, ok {e['ok']}/{e['drones']}, against "
              f"world 1 pos RMSE {e['pos_rmse_max_diff_vs_world1']:.3g}, x "
              f"{e['x_max_diff_vs_world1']:.3g}")
    return out


if __name__ == "__main__":
    main()
