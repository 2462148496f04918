"""PyTorch port vs JAX: the per-stage helpers of the fused control step.

The JAX side calls the Pallas kernels' pure helpers directly on (B,) f64
`jnp` arrays (one array per matrix element, as the kernels use one tile),
outside any Pallas call; plain lists stand in for the `P_scr`/`p_scr` VMEM
scratch. The port's plain versions get the same numpy inputs as (B,)
tensors. Tolerance rtol 1e-10 (atol 1e-13 for entries that are exact zeros
on one side): same formulas in f64, only the summation order of the hand
forward mode differs from `jax.linearize`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndp_nmpc_qd_tpu.ops.pallas import ipm_whole as j_ipm
from ndp_nmpc_qd_tpu.ops.pallas import linearize as j_lin
from ndp_nmpc_qd_tpu.ops.pallas import riccati as j_ric
from ndp_nmpc_qd_tpu.ops.pallas import riccati_sparse as j_rs
from ndp_nmpc_qd_tpu_torch.ops.kernels import ipm_whole as t_ipm
from ndp_nmpc_qd_tpu_torch.ops.kernels import linearize as t_lin
from ndp_nmpc_qd_tpu_torch.ops.kernels import riccati_sparse as t_rs
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import whole_step_consts


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's ops here are small, and the
    suite's latency-bound JAX daemon tests need the other CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B = 16
CONSTS = whole_step_consts(NdpNmpcConfig().ocp, NdpNmpcConfig().vehicle, True)


def _close(port, ref, what=""):
    """Nested lists of (B,) tensors vs nested lists of jnp arrays."""
    if isinstance(port, (list, tuple)):
        assert len(port) == len(ref), what
        for i, (p, r) in enumerate(zip(port, ref)):
            _close(p, r, f"{what}[{i}]")
        return
    if ref is None:  # unused upper triangle of a Cholesky factor
        assert port is None, what
        return
    np.testing.assert_allclose(
        port.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-13, err_msg=what
    )


def _both(a):
    """numpy (n, ..., B) -> (jnp nested list, torch nested list)."""
    if a.ndim == 1:
        return jnp.asarray(a), torch.as_tensor(a)
    pairs = [_both(row) for row in a]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _state(rng):
    x = rng.standard_normal((10, B))
    x[6:10] /= np.linalg.norm(x[6:10], axis=0)
    return x


def _lin_kw(c):
    keys = ("h", "substeps", "mass", "gravity", "stage_scale", "q_diag", "r_diag")
    return {k: c[k] for k in keys}


def test_lin_stage_and_terminal_terms(rng):
    x, x1, xr = _state(rng), _state(rng), _state(rng)
    u = rng.standard_normal((4, B)) + np.array([0, 0, 0, 9.81])[:, None]
    ur = rng.standard_normal((4, B))
    fd = rng.standard_normal((3, B))
    (jx, tx), (jx1, tx1), (jxr, txr) = _both(x), _both(x1), _both(xr)
    (ju, tu), (jur, tur), (jfd, tfd) = _both(u), _both(ur), _both(fd)
    for j_fd, t_fd in ((jfd, tfd), (None, None)):
        ref = j_lin._lin_stage_terms(
            tuple(jx), tuple(jx1), tuple(ju), tuple(jxr), tuple(jur),
            None if j_fd is None else tuple(j_fd), **_lin_kw(CONSTS),
        )
        port = t_lin.lin_stage_terms(
            tuple(tx), tuple(tx1), tuple(tu), tuple(txr), tuple(tur),
            None if t_fd is None else tuple(t_fd), **_lin_kw(CONSTS),
        )
        for name, p, r in zip(("hq", "gx", "gu", "a40", "b30", "bc6", "r"), port, ref):
            _close(p, r, name)
    _close(
        t_lin.lin_terminal_terms(tuple(tx1), tuple(txr), q_diag=CONSTS["q_diag"]),
        j_lin._lin_terminal_terms(tuple(jx1), tuple(jxr), q_diag=CONSTS["q_diag"]),
    )


def _spd(rng, n):
    m = rng.standard_normal((n, n, B))
    return np.einsum("ikb,jkb->ijb", m, m) + n * np.eye(n)[:, :, None]


def _blocks(rng):
    a40 = 0.1 * rng.standard_normal((40, B))
    b30 = 0.1 * rng.standard_normal((30, B))
    bc6 = 0.1 * rng.standard_normal((6, B))
    (ja, ta), (jb, tb), (jc, tc) = _both(a40), _both(b30), _both(bc6)
    return (
        j_ipm._load_blocks_at(
            jnp.asarray(a40)[None, :, None], jnp.asarray(b30)[None, :, None],
            jnp.asarray(bc6)[None, :, None], 0, jnp.float64,
        ),
        t_rs.load_blocks(ta, tb, tc),
    )


def test_chol4_and_solve(rng):
    jR, tR = _both(_spd(rng, 4))
    jL, tL = j_ric._chol4(jR), t_rs.chol4(tR)
    _close(tL, jL)
    jc, tc = _both(rng.standard_normal((3, 4, B)))
    _close(t_rs.chol4_solve(tL, tc), j_ric._chol4_solve(jL, jc))


def test_glue_bound_and_slack_rows(rng):
    v, lo, hi = rng.standard_normal((3, B))
    lo, hi = -2.0 - np.abs(lo), 2.0 + np.abs(hi)
    s_lo, s_up, l_lo, l_up = rng.uniform(0.1, 2.0, (4, B))
    mu = rng.uniform(0.01, 1.0, B)
    args = [v, lo, hi, s_lo, s_up, l_lo, l_up, mu]
    jg = j_rs._glue_pair(*(jnp.asarray(a) for a in args))
    tg = t_rs.glue_pair(*(torch.as_tensor(a) for a in args))
    _close(list(tg), list(jg), "glue")
    d = rng.standard_normal(B)
    bargs = [d, *[np.array(t) for t in jg[2:]], s_lo, s_up, l_lo, l_up]
    _close(
        list(t_rs.bound_steps(*(torch.as_tensor(a) for a in bargs), 0.95)),
        list(j_rs._bound_steps(*(jnp.asarray(a) for a in bargs), 0.95)),
        "bound_steps",
    )
    _close(
        list(t_ipm.slack_init_pair(*(torch.as_tensor(a) for a in (lo, hi, v)), 1e-3)),
        list(j_ipm._slack_init_pair(*(jnp.asarray(a) for a in (lo, hi, v)), 1e-3)),
        "slack_init",
    )


def test_dyn_step(rng):
    jblk, tblk = _blocks(rng)
    (jrh, trh), (jdx, tdx), (jdu, tdu) = (
        _both(rng.standard_normal((n, B))) for n in (10, 10, 4)
    )
    h = CONSTS["h"]
    _close(t_rs.dyn_step(*tblk, trh, h, tdx, tdu), j_rs._dyn_step(*jblk, jrh, h, jdx, jdu))
    _close(t_rs.dyn_step(*tblk, trh, h, tdx, None), j_rs._dyn_step(*jblk, jrh, h, jdx, None))


def test_terminal_init_and_riccati_stage_core(rng):
    (jhq, thq), (jgx, tgx), (jz, tz), (js, ts), (jc, tc) = (
        _both(a) for a in (
            0.5 * rng.standard_normal((16, B)), rng.standard_normal((10, B)),
            rng.standard_normal((10, B)), rng.uniform(0.1, 1.0, (3, B)),
            rng.standard_normal((3, B)),
        )
    )
    P_scr, p_scr = [None] * 100, [None] * 10
    j_rs._terminal_init_core(P_scr, p_scr, jhq, jgx, jz, js, jc,
                             diag6_term=CONSTS["diag6_term"])
    tP, tp = t_rs.terminal_init_core(thq, tgx, tz, ts, tc,
                                     diag6_term=CONSTS["diag6_term"])
    _close([t for row in tP for t in row], P_scr, "P_T")
    _close(tp, p_scr, "p_T")

    jblk, tblk = _blocks(rng)
    arrays = {
        "P": _spd(rng, 10), "p": rng.standard_normal((10, B)),
        "Hq": _spd(rng, 4), "gx": rng.standard_normal((10, B)),
        "gu": rng.standard_normal((4, B)), "r": rng.standard_normal((10, B)),
        "zx": rng.standard_normal((10, B)), "zx1": rng.standard_normal((10, B)),
        "zu": rng.standard_normal((4, B)),
        "sig_u": rng.uniform(0.1, 1.0, (4, B)), "sig_x": rng.uniform(0.1, 1.0, (3, B)),
        "corr_u": rng.standard_normal((4, B)), "corr_x": rng.standard_normal((3, B)),
    }
    j, t = {}, {}
    for k, a in arrays.items():
        j[k], t[k] = _both(a)
    kw = dict(h=CONSTS["h"], diag6_stage=CONSTS["diag6_stage"],
              rdiag_stage=CONSTS["rdiag_stage"])
    P_scr, p_scr = [None] * 100, [None] * 10
    rest = ("r", "zx", "zx1", "zu", "sig_u", "sig_x", "corr_u", "corr_x")
    jK, jkf, jrh = j_rs._riccati_stage_core(
        j["P"], j["p"], P_scr, p_scr, j["Hq"], j["gx"], j["gu"], *jblk,
        *(j[k] for k in rest), **kw,
    )
    tK, tkf, trh, tPn, tpn = t_rs.riccati_stage_core(
        t["P"], t["p"], t["Hq"], t["gx"], t["gu"], *tblk,
        *(t[k] for k in rest), **kw,
    )
    _close(tK, jK, "K")
    _close(tkf, jkf, "kf")
    _close(trh, jrh, "rh")
    _close([x for row in tPn for x in row], P_scr, "P_new")
    _close(tpn, p_scr, "p_new")
