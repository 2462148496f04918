"""Interactive 3D mission viewer on the PyTorch port: `tools/viz3d.py` (the
rviz role, dependency-free).

Flies a mission through the port's CLI (`cli.run_mission(args,
record_traces=True)`, the true throttle gain 50) and writes a
self-contained interactive HTML scene: orbit (drag), zoom (wheel), and
play/scrub the mission timeline. No network, no JS dependencies (a
hand-rolled perspective projection on a 2D canvas); the page is the JAX
tool's. Its flags are the JAX tool's (`--topology`, `--track-secs`,
`--hold-ticks`, `--stride`, `--out`, `--cpu`); the default `--out` is
`build/mission3d.html`. The mission runs as the port's CLI resolves it (the
scan controller for these topologies) on the card, or with `--cpu` on the
CPU, in float32 as the JAX tool's; without a card and without `--cpu` the
tool fails.

Colors follow the validated dark-surface categorical palette (fixed slot
order, identity also carried by direct labels, never color alone); text
uses text tokens, not series colors.

  python tools/viz3d_torch.py --topology three_qd_ndp --out build/mission3d.html
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ndp_nmpc_qd_tpu_torch import cli  # noqa: E402
from ndp_nmpc_qd_tpu_torch.params import OcpParams  # noqa: E402
from ndp_nmpc_qd_tpu_torch.traj.polyopt import eval_traj  # noqa: E402

# validated dark-mode categorical palette (fixed order, see dataviz palette)
SERIES_DARK = [
    "#3987e5", "#d95926", "#199e70", "#c98500",
    "#d55181", "#008300", "#9085e9", "#e66767",
]
SURFACE = "#1a1a19"
TEXT_PRIMARY = "#ffffff"
TEXT_SECONDARY = "#c3c2b7"
GRID = "#3a3a38"
REF_PATH = "#6b6a63"  # recessive reference path


def collect_traces(topology: str, track_secs: float, hold_ticks: int, cpu: bool, stride: int):
    """Fly the mission; return the page's data (every `stride`-th tick)."""
    argv = ["mission", topology, "--track-secs", str(track_secs), "--hold-ticks",
            str(hold_ticks), "--k-true", "50"] + (["--cpu"] if cpu else [])
    result, run = cli.run_mission(cli.make_parser().parse_args(argv), record_traces=True)
    xs = run["traces"][0].detach().double().cpu().numpy()[::stride]  # (T, D, 10)
    ts_nmpc = OcpParams().ts_nmpc
    ts = np.arange(0, result["ticks"], stride) * ts_nmpc
    # leader reference path over the tracking phase
    traj = cli.build_eight(dtype=torch.float64)
    t_ref = torch.linspace(0.0, float(traj.t_cum[-1]), 200, dtype=torch.float64)
    ref = eval_traj(traj, t_ref).pos.numpy()
    m = run["metrics"]
    return {
        "topology": topology,
        "dt": float(ts_nmpc) * stride,
        "times": ts.round(3).tolist(),
        "drones": xs[:, :, 0:3].round(4).tolist(),  # (T, D, 3)
        "ref": ref.round(4).tolist(),
        "pos_rmse_m": [round(float(v), 5) for v in m.pos_rmse.cpu()],
        "ok": [bool(v) for v in m.ok.cpu()],
    }


HTML = """<!doctype html>
<meta charset="utf-8">
<title>ndp_nmpc_qd_tpu_torch — 3D mission viewer</title>
<style>
  body {{ margin:0; background:{surface}; color:{text}; font:13px system-ui, sans-serif; }}
  #bar {{ display:flex; gap:12px; align-items:center; padding:8px 14px; }}
  #bar b {{ color:{text}; font-weight:600; }}
  #legend span.sw {{ display:inline-block; width:10px; height:10px; border-radius:2px;
                    margin:0 4px 0 10px; vertical-align:-1px; }}
  #legend {{ color:{text2}; }}
  #hud {{ color:{text2}; margin-left:auto; }}
  canvas {{ display:block; cursor:grab; }}
  button {{ background:#2a2a28; color:{text}; border:1px solid {grid};
            border-radius:4px; padding:3px 10px; cursor:pointer; }}
  input[type=range] {{ width:180px; }}
</style>
<div id="bar">
  <b>{title}</b>
  <button id="play">pause</button>
  <input id="scrub" type="range" min="0" value="0" step="1">
  <span id="legend"></span>
  <span id="hud"></span>
</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const COLORS = {colors};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize() {{ W = cv.width = innerWidth; H = cv.height = innerHeight - 44; }}
resize(); addEventListener('resize', () => {{ resize(); draw(); }});
let yaw = 0.7, pitch = 0.42, zoom = 1.0, tick = 0, playing = true;
const T = DATA.drones.length, D = DATA.drones[0].length;
document.getElementById('scrub').max = T - 1;
// center/scale the scene
let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
for (const f of DATA.drones) for (const p of f) for (let i = 0; i < 3; i++) {{
  mn[i] = Math.min(mn[i], p[i]); mx[i] = Math.max(mx[i], p[i]); }}
const C = [0,1,2].map(i => (mn[i]+mx[i])/2);
const R = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 1);
function proj(p) {{
  let x = p[0]-C[0], y = p[1]-C[1], z = p[2]-C[2];
  let x1 = x*Math.cos(yaw) - y*Math.sin(yaw);
  let y1 = x*Math.sin(yaw) + y*Math.cos(yaw);
  let y2 = y1*Math.cos(pitch) - z*Math.sin(pitch);
  let z2 = y1*Math.sin(pitch) + z*Math.cos(pitch);
  const s = zoom * Math.min(W, H) * 0.42 / R;
  const d = 4*R, f = d/(d + y2*0.4);
  return [W/2 + x1*s*f, H*0.52 - z2*s*f];
}}
function line(pts, color, width, dash) {{
  ctx.strokeStyle = color; ctx.lineWidth = width; ctx.setLineDash(dash||[]);
  ctx.beginPath();
  pts.forEach((p, i) => {{ const q = proj(p); i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]); }});
  ctx.stroke(); ctx.setLineDash([]);
}}
function draw() {{
  ctx.fillStyle = '{surface}'; ctx.fillRect(0, 0, W, H);
  // recessive ground grid at z = min
  const g = 1.0, z0 = mn[2];
  ctx.strokeStyle = '{grid}'; ctx.lineWidth = 1;
  for (let gx = Math.floor(mn[0]-1); gx <= mx[0]+1; gx += g)
    line([[gx, mn[1]-1, z0], [gx, mx[1]+1, z0]], '{grid}', 1);
  for (let gy = Math.floor(mn[1]-1); gy <= mx[1]+1; gy += g)
    line([[mn[0]-1, gy, z0], [mx[0]+1, gy, z0]], '{grid}', 1);
  // reference path (recessive, dashed)
  line(DATA.ref, '{refc}', 1.5, [6, 5]);
  // trails up to current tick + markers (2px lines, >=8px markers)
  for (let d = 0; d < D; d++) {{
    const trail = [];
    for (let t = 0; t <= tick; t++) trail.push(DATA.drones[t][d]);
    line(trail, COLORS[d % COLORS.length], 2);
    const p = proj(DATA.drones[tick][d]);
    ctx.fillStyle = COLORS[d % COLORS.length];
    ctx.beginPath(); ctx.arc(p[0], p[1], 5, 0, 7); ctx.fill();
    ctx.strokeStyle = '{surface}'; ctx.lineWidth = 2; ctx.stroke();  // surface ring
    ctx.fillStyle = '{text}';
    ctx.fillText('qd' + d, p[0] + 9, p[1] - 7);  // direct label, text token
  }}
  document.getElementById('hud').textContent =
    't = ' + DATA.times[tick].toFixed(2) + ' s   alt ' +
    DATA.drones[tick].map(p => p[2].toFixed(2)).join(' / ') + ' m';
  document.getElementById('scrub').value = tick;
}}
const leg = document.getElementById('legend');
leg.innerHTML = Array.from({{length: D}}, (_, d) =>
  `<span class="sw" style="background:${{COLORS[d % COLORS.length]}}"></span>qd${{d}}` +
  ` (rmse ${{DATA.pos_rmse_m[d]*1000|0}} mm)`).join('') +
  `<span class="sw" style="background:{refc}"></span>reference`;
let dragging = false, px = 0, py = 0;
cv.onmousedown = e => {{ dragging = true; px = e.clientX; py = e.clientY; }};
onmouseup = () => dragging = false;
onmousemove = e => {{ if (!dragging) return;
  yaw += (e.clientX - px) * 0.008; pitch += (e.clientY - py) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch)); px = e.clientX; py = e.clientY; draw(); }};
cv.onwheel = e => {{ zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw(); e.preventDefault(); }};
document.getElementById('play').onclick = function () {{
  playing = !playing; this.textContent = playing ? 'pause' : 'play'; }};
document.getElementById('scrub').oninput = function () {{
  tick = +this.value; draw(); }};
setInterval(() => {{ if (playing) {{ tick = (tick + 1) % T; draw(); }} }}, 40);
draw();
</script>
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology", default="three_qd_ndp",
                    choices=["one_qd", "three_qd", "three_qd_ndp", "four_qd"])
    ap.add_argument("--track-secs", type=float, default=16.0)
    ap.add_argument("--hold-ticks", type=int, default=100)
    ap.add_argument("--stride", type=int, default=2, help="keep every Nth tick in the export")
    ap.add_argument("--cpu", action="store_true", help="fly on the CPU")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mission3d.html"))
    args = ap.parse_args(argv)

    data = collect_traces(args.topology, args.track_secs, args.hold_ticks, args.cpu,
                          args.stride)
    html = HTML.format(
        title=f"{data['topology']} mission",
        data=json.dumps(data),
        colors=json.dumps(SERIES_DARK),
        surface=SURFACE, text=TEXT_PRIMARY, text2=TEXT_SECONDARY,
        grid=GRID, refc=REF_PATH,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(html)
    print(f"wrote {args.out}: {len(data['times'])} frames, "
          f"{len(data['drones'][0])} drones, rmse {data['pos_rmse_m']}", file=sys.stderr)
    return data


if __name__ == "__main__":
    main()
