"""Records the JAX side of the port's parity tests against JAX Pallas paths.

These tests (`tests/jax_refs.py`'s STEMS) hold the port's plain versions
against the JAX package's kernels in interpret mode. The JAX side's outputs
for the tests' fixed inputs are the same numbers in every run while the
JAX package and the installed JAX stay as they are, so this tool runs it
once, exactly as the tests built it (the same controllers and kernels, the
same flags with `interpret=True`, the same inputs, seeds, ticks and
iterations, from each test module's own case functions), and writes
`assets/jax_refs/<test file stem>.npz`: every array the test reads, as
the JAX package returns it; a SHA-256 digest of each input handed to the
JAX call, or a fingerprint where the port's code computed that input; the
JAX version and a hash of the sources of `ndp_nmpc_qd_tpu/`.

  python tools/record_jax_refs.py [stem ...]
      Recomputes the recordings (all by default) from the live JAX package
      and compares every array bitwise with the file. Prints the largest
      difference of each array that differs, and exits 1 on any difference.
  python tools/record_jax_refs.py --write [stem ...]
      Rewrites the named recordings, or all of them.

Each file is computed in a process of its own, as many at a time as there
are CPUs (all 11 files: ~4-6 min on 8 CPUs).

Rewrite a recording after a JAX upgrade, or after a meant change to the
port's code whose output feeds a JAX input (the test then fails its input
check, naming this command). Never rewrite one to make a port regression
pass: the input check tells a changed input from a changed result, and the
check mode shows whether the JAX side itself still gives the recorded
numbers.
"""

import argparse
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed
from multiprocessing import get_context

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TESTS = os.path.join(ROOT, "tests")
sys.path[:0] = [ROOT, TESTS]

import conftest  # noqa: E402,F401 (the tests' JAX set-up: CPU, 8 host devices, x64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax_refs  # noqa: E402


def lanes(a, B):
    """A JAX array with the (nb, SUB, 128) batch tail as (..., B), f32."""
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return a.reshape(a.shape[:-3] + (-1,))[..., :B]


class Out(dict):
    def put(self, case, inputs=None, computed=None, **arrays):
        """Records a case's input digests (inputs made by numpy or the JAX
        package), fingerprints (inputs the port's code computed) and its
        arrays."""
        self.update(jax_refs.input_entries(case, inputs or {}, computed or {}))
        for name, a in arrays.items():
            self[f"{case}/{name}"] = np.asarray(a)


def solution(out_j, lane_fn):
    """An `ipm_sparse` result (zx, zu, mu, eq_res, duals) as the tests read
    it, the duals under `warm_` and the port's IpmWarm field names."""
    from ndp_nmpc_qd_tpu_torch.solver.qp_ipm_sparse import IpmWarm

    zx, zu, mu, eq, w = out_j
    return dict(zx=lane_fn(zx), zu=lane_fn(zu), mu=lane_fn(mu), eq_res=lane_fn(eq),
                **{f"warm_{name}": lane_fn(r) for name, r in zip(IpmWarm._fields, w)})


def assert_bitwise(got, want, what):
    """Fails unless the two dicts of arrays are bitwise equal."""
    assert got.keys() == want.keys(), what
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), (
            f"{what}: {k} differs from what the test derives it from")


def jax_rti_controller(qp_iters, **flags):
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
    from ndp_nmpc_qd_tpu.solver import rti as j_rti

    cfg = NdpNmpcConfig()
    return j_rti.make_batched_rti_controller(
        cfg.ocp, cfg.vehicle, with_disturbance=True, qp_iters=qp_iters, backend="pallas",
        interpret=True, lqr_start=False, **flags)


def raw_state(st_j):
    """A kernel-layout `RtiState` as the JAX controller returns it (the
    tests carry it over with `convert.rti_state_from_numpy`)."""
    return dict(state_x_bar=st_j.x_bar, state_u_bar=st_j.u_bar,
                **{f"state_ipm{k}": a for k, a in enumerate(st_j.ipm)})


def packed_tick(u_j, st_j, info_j, B, state=True):
    """A kernel-layout controller tick as the tests read it: u0, the info,
    the iterates (`unpack_iterates`) and the state."""
    from ndp_nmpc_qd_tpu.solver import rti as j_rti

    out = dict(u0=u_j, eq_res=info_j.eq_res, ok=info_j.ok, mu=info_j.mu)
    if state:
        xb, ub = j_rti.unpack_iterates(st_j, B)
        out.update(x_bar=xb, u_bar=ub, **raw_state(st_j))
    return out


def rec_episode():
    import test_torch_episode as T

    traj_j, (init_j, _, run_j) = T.jax_episode()
    st0 = jax.tree.map(np.asarray, init_j())
    st_j, m_j, tr_j = jax.jit(lambda s: run_j(s, T.TICKS))(init_j())
    out = Out()
    out.put("run", T.run_inputs(st0, traj_j), x=tr_j[0], u0=tr_j[1], throttle=tr_j[2],
            pos_rmse=m_j.pos_rmse, yaw_rmse_deg=m_j.yaw_rmse_deg, form_rmse=m_j.form_rmse,
            ok=m_j.ok, recovered=m_j.recovered, tick=st_j.tick, n_track=st_j.n_track,
            plant_x=st_j.plant.x, est_x=st_j.est.x, x_bar=st_j.rti.x_bar, u_bar=st_j.rti.u_bar,
            **{f"ipm{k}": a for k, a in enumerate(st_j.rti.ipm)})
    return out


def rec_glue_fused():
    import test_torch_glue_fused as T
    import test_torch_ipm_whole as W
    from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import ipm_sparse as j_ipm

    qp, consts, dx0 = W.jax_payload(T.SEED)
    payload = W.port_payload(qp, dx0)
    solve = lambda warm: j_ipm(qp, consts, dx0, num_iters=4, interpret=True, warm=warm,
                               lqr_start=False, fuse_glue=True)
    cold = solve(None)
    warm = solve(cold[4])
    out = Out()
    out.put("cold", dict(payload=payload), **solution(cold, lambda a: lanes(a, W.B)))
    out.put("warm", dict(payload=payload), **solution(warm, lambda a: lanes(a, W.B)))
    return out


def rec_ipm_whole():
    import test_torch_ipm_whole as T
    from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import IpmWarm as JWarm
    from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import ipm_sparse as j_ipm

    qp, consts, dx0 = T.jax_payload()
    payload = T.port_payload(qp, dx0)
    N = qp.gu.shape[0]
    tail = qp.gx.shape[2:]
    z = lambda d, s: jnp.zeros((s, d) + tail, jnp.float32)
    jax_cold = JWarm(z(4, N), z(4, N), z(3, N + 1), z(3, N + 1), jnp.full(tail, -1.0, jnp.float32))
    solve = lambda warm, q=qp: j_ipm(q, consts, dx0, num_iters=T.ITERS, interpret=True, warm=warm,
                                     lqr_start=False, fuse_glue=True, whole_kernel=True)
    out = Out()
    cold_j = solve(jax_cold)
    cold = solution(cold_j, T.lanes)
    out.put("cold", dict(payload=payload), **cold)
    w_j = cold_j[4]
    warm = solution(solve(w_j), T.lanes)
    out.put("warm", dict(payload=payload), **warm)
    # mixed and warm=None are not stored: the test reads them from these
    mu_j = jnp.where(jnp.asarray(T.RESET).reshape(w_j.mu.shape), -1.0, w_j.mu)
    mixed = solution(solve(w_j._replace(mu=mu_j)), T.lanes)
    assert_bitwise(mixed, {k: T.mixed_reference(cold[k], warm[k]) for k in cold}, "mixed")
    out.put("mixed", dict(payload=payload, reset=T.RESET))
    assert_bitwise(solution(solve(None), T.lanes), cold, "warm_none")
    out.put("warm_none", dict(payload=payload))
    qp16 = qp._replace(**{n: getattr(qp, n).astype(jnp.bfloat16) for n in ("hq", "a", "b")})
    out.put("bf16", dict(payload=payload), **solution(solve(jax_cold, qp16), T.lanes))
    return out


def rec_riccati_iter():
    import test_torch_ipm_whole as W
    import test_torch_riccati_iter as T
    from ndp_nmpc_qd_tpu.ops.pallas.riccati_sparse import riccati_iter_fused as j_iter
    from ndp_nmpc_qd_tpu_torch import testing
    from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
    from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts

    qp, _, dx0 = W.jax_payload(T.SEED)
    qp_t, dx0_t = W.port_payload(qp, dx0)
    ic = ipm_consts(PortConfig().ocp)
    args = testing.iter_args(tuple(qp_t) + (dx0_t,), ic)  # the port's start
    tail = qp.gx.shape[2:]
    to_j = lambda t: jnp.asarray(t.numpy().reshape(t.shape[:-1] + tail))
    kw = dict(h=ic["h"], diag6_stage=ic["diag6_stage"], diag6_term=ic["diag6_term"],
              rdiag_stage=ic["rdiag_stage"], tau=ic["tau"])
    ref = j_iter(*(to_j(t) for t in args), **kw, interpret=True)
    assert len(ref) == len(T.OUTS)
    out = Out()
    out.put("iter", computed=dict(args=args), **{n: lanes(r, W.B) for n, r in zip(T.OUTS, ref)})
    return out


def rec_riccati_packed():
    import test_torch_riccati_packed as T
    from ndp_nmpc_qd_tpu.ops.pallas.riccati import BLOCK, SUB
    from ndp_nmpc_qd_tpu.ops.pallas.riccati import riccati_sweep_packed as j_sweep

    B = T.BLOCK
    assert B == BLOCK
    args, (lo, hi) = T.clipped_args(B)

    def to_jax(t):
        s, d = t.shape[:2]
        return jnp.asarray(t.numpy().reshape(s, d, B // BLOCK, SUB, BLOCK // SUB))

    from_jax = lambda a: np.asarray(a).reshape(a.shape[0], a.shape[1], -1)
    dx_j, du_j = j_sweep(*(to_jax(t) for t in args), clip_lo=to_jax(lo), clip_hi=to_jax(hi),
                         interpret=True)
    out = Out()
    out.put("clipped", computed=dict(args=args, clip=(lo, hi)), dx=from_jax(dx_j),
            du=from_jax(du_j))
    return out


def rec_riccati_sweep():
    import test_torch_riccati_sweep as T
    from ndp_nmpc_qd_tpu.ops.pallas.riccati import LANE, SUB
    from ndp_nmpc_qd_tpu.ops.pallas.riccati_sparse import riccati_sweep_sparse as j_sweep
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig
    from ndp_nmpc_qd_tpu.solver.ocp_sparse import SparseQp as JSparseQp
    from ndp_nmpc_qd_tpu.solver.ocp_sparse import make_ocp_functions_sparse
    from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import IpmWarm as JWarm
    from ndp_nmpc_qd_tpu.solver.qp_ipm_sparse import ipm_sparse as j_ipm
    from ndp_nmpc_qd_tpu_torch import testing
    from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig as PortConfig
    from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts

    B = T.B
    tail = (B // (SUB * LANE), SUB, LANE)

    def to_j(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(t.float().numpy().reshape(t.shape[:-1] + tail), dt)

    def payload_j(qp_t):
        cfg = NdpNmpcConfig()
        _, consts, _ = make_ocp_functions_sparse(cfg.ocp, cfg.vehicle, True)
        return JSparseQp(*(to_j(t) for t in qp_t[:11])), consts, to_j(qp_t[11])

    lane_fn = lambda a: lanes(a, B)
    ic = ipm_consts(PortConfig().ocp)
    out = Out()

    # K6 + K7 as the clipped-LQR start calls them, f32
    qp_t = T.payload(False)
    qp, consts, dx0 = payload_j(qp_t)
    N = qp.gu.shape[0]
    z = lambda d, n: jnp.zeros((n, d) + tail, jnp.float32)
    margin = 1e-3 * (qp.uu - qp.lu)
    ref = j_sweep(
        qp.hq, qp.gx, qp.gu, qp.a, qp.b, qp.bc, qp.r, z(10, N + 1), z(4, N), z(4, N),
        z(3, N + 1), z(4, N), z(3, N + 1), dx0, clip_lo=qp.lu + margin, clip_hi=qp.uu - margin,
        h=consts.h, diag6_stage=consts.diag6_stage, diag6_term=consts.diag6_term,
        rdiag_stage=consts.rdiag_stage, interpret=True, with_hold=True,
    )
    assert len(ref) == len(T.SWEEP)
    out.put("lqr_sweep", computed=dict(payload=qp_t),
            **{n: lane_fn(r) for n, r in zip(T.SWEEP, ref)})

    # K6 + K7 as the unfused glue calls them, bf16 curvature payload
    qp_b = T.payload(True)
    qpj_b = payload_j(qp_b)[0]
    assert qpj_b.a.dtype == jnp.bfloat16
    args, _ = testing.sweep_args(qp_b, ic, "unfused_glue")
    jargs = [to_j(t) for t in args[:14]]
    jargs[0], jargs[3], jargs[4] = qpj_b.hq, qpj_b.a, qpj_b.b
    ref = j_sweep(*jargs, **T.sweep_kw(ic), interpret=True)
    assert len(ref) == 3
    out.put("unfused_sweep_bf16", computed=dict(payload=qp_b, args=args[:14]),
            **{n: lane_fn(r) for n, r in zip(T.SWEEP, ref)})

    # the IPM from the clipped-LQR start: cold, fused glue; warm with the
    # port's cold duals, unfused glue
    cold = j_ipm(qp, consts, dx0, num_iters=4, interpret=True, warm=None, lqr_start=True,
                 fuse_glue=True)
    out.put("ipm_cold", computed=dict(payload=qp_t), **solution(cold, lane_fn))
    w = T.solve(T.port_case(qp_t), None, fuse_glue=False)[4]
    warm = j_ipm(qp, consts, dx0, num_iters=4, interpret=True, warm=JWarm(*(to_j(t) for t in w)),
                 lqr_start=True, fuse_glue=False)
    out.put("ipm_warm", computed=dict(payload=qp_t, warm=w), **solution(warm, lane_fn))
    return out


def rec_step_whole():
    import test_torch_step_whole as T
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig

    N, B = NdpNmpcConfig().ocp.N_node, 8
    x0, xr, ur, other = T.make_case(B, N)
    f_j = T.jax_forecast(x0, xr, other)
    ctl_j = jax_rti_controller(3, warm_start=True, whole_ipm=True, packed_state=True,
                               whole_step=True, jac_bf16=False)
    st_j = ctl_j.reset(jnp.asarray(xr), jnp.asarray(ur))
    out = Out()
    out.put("whole_step", dict(x0=x0, xr=xr, ur=ur, f=f_j, qp_iters=3))
    for tick in range(T.TICKS):
        u_j, st_j, info_j = ctl_j.update(
            st_j, jnp.asarray(x0), jnp.asarray(xr), jnp.asarray(ur), jnp.asarray(f_j))
        out.put(f"whole_step/tick{tick}", **packed_tick(u_j, st_j, info_j, B))
    return out


def rec_step_whole_bf16():
    import test_torch_step_whole as T
    from ndp_nmpc_qd_tpu.params import NdpNmpcConfig

    N, B = NdpNmpcConfig().ocp.N_node, 8
    x0, xr, ur, other = T.make_case(B, N)
    f = T.jax_forecast(x0, xr, other)
    ctl_j = jax_rti_controller(3, warm_start=True, whole_ipm=True, packed_state=True,
                               whole_step=True, jac_bf16=True)
    st_j = ctl_j.reset(jnp.asarray(xr), jnp.asarray(ur))
    args_j = (jnp.asarray(x0), jnp.asarray(xr), jnp.asarray(ur), jnp.asarray(f))
    out = Out()
    out.put("bf16", dict(x0=x0, xr=xr, ur=ur, f=f, qp_iters=3))
    u_j, st_j, info_j = ctl_j.update(st_j, *args_j)
    out.put("bf16/tick0", **packed_tick(u_j, st_j, info_j, B, state=False))
    out.put("bf16/carried", **raw_state(st_j))
    u_j, st_j, info_j = ctl_j.update(st_j, *args_j)
    out.put("bf16/tick1", **packed_tick(u_j, st_j, info_j, B, state=False))
    return out


def rec_two_kernel(jac_bf16):
    import test_torch_two_kernel as T

    ins = T.inputs()
    args_j = tuple(jnp.asarray(ins[k]) for k in ("x0", "xr", "ur", "f"))
    out = Out()
    for whole_ipm in (True, False):
        case = f"whole_ipm={whole_ipm}"
        out.put(case, dict(**ins, qp_iters=T.QP_ITERS))
        ctl_j = jax_rti_controller(T.QP_ITERS, warm_start=True, whole_ipm=whole_ipm,
                                   packed_state=True, whole_step=False, jac_bf16=jac_bf16)
        update_j = jax.jit(ctl_j.update)
        st_j = ctl_j.reset(args_j[1], args_j[2])
        for tick in range(T.TICKS):
            u_j, st_j, info_j = update_j(st_j, *args_j)
            out.put(f"{case}/tick{tick}", **packed_tick(u_j, st_j, info_j, T.B))
    return out


def rec_two_kernel_layout():
    import test_torch_two_kernel as K
    import test_torch_two_kernel_layout as T

    ins = K.inputs()
    args_j = tuple(jnp.asarray(ins[k]) for k in ("x0", "xr", "ur", "f"))
    ctl_j = jax_rti_controller(K.QP_ITERS, warm_start=False, whole_ipm=False,
                               packed_state=False, whole_step=False, jac_bf16=False)
    update_j = jax.jit(ctl_j.update)
    st_j = ctl_j.reset(args_j[1], args_j[2])
    out = Out()
    out.put("cold", dict(**ins, qp_iters=K.QP_ITERS))
    for tick in range(T.COLD_TICKS):
        u_j, st_j, info_j = update_j(st_j, *args_j)
        assert st_j.ipm is None  # no duals are carried without warm start
        out.put(f"cold/tick{tick}", u0=u_j, eq_res=info_j.eq_res, ok=info_j.ok,
                x_bar=st_j.x_bar, u_bar=st_j.u_bar)
    return out


RECORDERS = {
    "test_torch_episode": rec_episode,
    "test_torch_glue_fused": rec_glue_fused,
    "test_torch_ipm_whole": rec_ipm_whole,
    "test_torch_riccati_iter": rec_riccati_iter,
    "test_torch_riccati_packed": rec_riccati_packed,
    "test_torch_riccati_sweep": rec_riccati_sweep,
    "test_torch_step_whole": rec_step_whole,
    "test_torch_step_whole_bf16": rec_step_whole_bf16,
    "test_torch_two_kernel": lambda: rec_two_kernel(False),
    "test_torch_two_kernel_bf16": lambda: rec_two_kernel(True),
    "test_torch_two_kernel_layout": rec_two_kernel_layout,
}
assert tuple(sorted(RECORDERS)) == tuple(sorted(jax_refs.STEMS))


def compute(stem):
    """The recording of one test file, as (seconds, {key: array})."""
    torch.set_num_threads(1)  # as the tests' one_torch_thread fixtures
    t0 = time.perf_counter()
    out = dict(RECORDERS[stem]())
    out["meta/jax_version"] = np.array(jax_refs.jax_version())
    out["meta/jax_source"] = np.array(jax_refs.source_hash())
    return time.perf_counter() - t0, out


def compare(stem, out):
    """Prints how the live JAX side compares with the recording; True if
    every array and input digest is bitwise equal and every fingerprint
    within its tolerance."""
    path = jax_refs.REF_DIR / f"{stem}.npz"
    if not path.exists():
        print(f"{stem}: no recording at {path}")
        return False
    with np.load(path) as z:
        rec = dict(z)
    same = True
    for key in sorted(set(rec) | set(out)):
        if key not in rec or key not in out:
            print(f"{stem}: {key} only in the {'recording' if key in rec else 'live run'}")
            same = False
            continue
        a, b = rec[key], out[key]
        if a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes():
            continue
        if "/fp/" in key and not jax_refs.fingerprint_mismatch(b, a):
            continue  # an input the port computed, within its fingerprint's tolerance
        same = False
        if a.dtype.kind in "fiub" and a.shape == b.shape:
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            print(f"{stem}: {key} differs, largest difference {np.nanmax(d) if d.size else 0:.3e}")
        else:
            print(f"{stem}: {key} differs: {a!r} recorded, {b!r} live")
    n = sum(1 for k in out if "/in/" not in k and "/fp/" not in k and not k.startswith("meta/"))
    print(f"{stem}: {'all ' + str(n) + ' arrays bitwise equal' if same else 'DIFFERS'}")
    return same


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stems", nargs="*", help="test file stems (default: all recorded ones)")
    ap.add_argument("--write", action="store_true", help="rewrite the recordings")
    args = ap.parse_args()
    stems = args.stems or list(jax_refs.STEMS)
    unknown = sorted(set(stems) - set(RECORDERS))
    if unknown:
        ap.error(f"no recorder for {unknown}; known: {', '.join(jax_refs.STEMS)}")
    ok = True
    jobs = min(len(stems), os.cpu_count() or 1)
    with ProcessPoolExecutor(jobs, mp_context=get_context("spawn")) as pool:
        futures = {pool.submit(compute, stem): stem for stem in stems}
        for fut in as_completed(futures):
            stem = futures[fut]
            try:
                secs, out = fut.result()
            except Exception:  # report it, and go on with the other files
                print(f"{stem}: the JAX side failed\n{traceback.format_exc()}")
                ok = False
                continue
            if args.write:
                jax_refs.REF_DIR.mkdir(parents=True, exist_ok=True)
                path = jax_refs.REF_DIR / f"{stem}.npz"
                np.savez_compressed(path, **out)
                print(f"{stem}: wrote {path.relative_to(jax_refs.ROOT)} "
                      f"({path.stat().st_size} bytes, {len(out)} entries, {secs:.1f} s)")
            else:
                ok &= compare(stem, out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
