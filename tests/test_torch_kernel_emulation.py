"""The streamed sweeps K8, K4 and K6 (csrc/riccati_packed.cu,
csrc/riccati_iter.cu, csrc/riccati_sweep.cu), the dense rollout K9 and the
linearization K3 (csrc/linearize.cu) built as host C++ and run on the CPU
(`ndp_nmpc_qd_tpu_torch.emulate`: each CUDA thread a host thread, the
block's and the lanes' barriers real barriers, tensor copies as plain
copies), held against their plain versions.

The builds cap the compute threads a block (NDP_K8_THREADS=64,
NDP_K4_THREADS=64, NDP_K6_THREADS=64: at most 16 scenarios a block), so B =
23, 24, 27 run two blocks, the last ragged. B = 24 takes the tensor copies;
at B = 1, 23 and 27 (not a multiple of the rows' 16 bytes) K8 copies
element by element and K4 and K6 run their one-thread sweeps; each launch's
route is checked. K3 (128 scenarios of one stage a block) runs its default
build at B = 1 and 23, with and without the forecast, with 1 and 2 RK4
substeps.
One scenario's input is NaN (B > 1): it must stay in that scenario. The
kernel and the plain version sum in the same order, so they are held within
1e-6 (`testing.err_of`'s measures; the plain dense sweep contracts with
einsum, whose order differs, which leaves ~7e-7). The C launch geometry of
the default builds is held against its Python mirror. Skips, saying so,
only where no C++20 compiler (g++) is found.
"""

import pytest
import torch

from ndp_nmpc_qd_tpu_torch import emulate, testing
from ndp_nmpc_qd_tpu_torch.ops.kernels import _cuda, linearize, riccati
from ndp_nmpc_qd_tpu_torch.ops.kernels import riccati_sparse as rs
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig
from ndp_nmpc_qd_tpu_torch.solver.ocp_sparse import ipm_consts, lin_consts

CFG = NdpNmpcConfig()
N = CFG.ocp.N_node
CPU = torch.device("cpu")
K8_BUILD = ("NDP_K8_THREADS=64",)
K4_BUILD = ("NDP_K4_THREADS=64",)
K6_BUILD = ("NDP_K6_THREADS=64",)
PAYLOAD = ("hq", "gx", "gu", "a", "b", "bc", "r")
TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cxx():
    if emulate.compiler() is None:
        pytest.skip("no C++20 compiler (g++) to build the kernels as host code")


def held(named, nan_b=None):
    """name -> (kind, got, ref): every error within TOL, the NaNs where the
    plain version's are, and scenario nan_b's outputs NaN somewhere."""
    for name, (kind, got, ref) in named.items():
        assert torch.equal(got.isnan(), ref.isnan()), f"{name}: NaN pattern differs"
        keep = ~ref.isnan()
        err = testing.err_of(kind, got[keep], ref[keep])
        assert err <= TOL, f"{name}: {err} > {TOL}"
    if nan_b is not None:
        assert any(bool(got[..., nan_b].isnan().any()) for _, got, _ in named.values())


@pytest.mark.parametrize("B", [1, 23, 24, 27])
@pytest.mark.parametrize("call", ["lqr_start", "newton"])
def test_dense_sweep_k8_emulated_matches_plain(cxx, call, B):
    lib = riccati._lib(emulate.load("riccati_packed", K8_BUILD))
    p, dx0 = testing.dense_payload(CFG, B, CPU, seed=4)
    bwd = [t.clone().contiguous() for t in testing.packed_args(p, dx0, call)[:9]]
    nan_b = B // 2 if B > 1 else None
    if nan_b is not None:
        bwd[6][3, 5, nan_b] = float("nan")  # A of stage 3
    K = torch.empty(N, 40, B)
    kf = torch.empty(N, 4, B)
    names = ("hxx", "sig_x", "huu", "sig_u", "gx", "gu", "a", "b", "r")
    ptrs = riccati._PackedPtrs(**{n: t.data_ptr() for n, t in zip(names, bwd)},
                               K=K.data_ptr(), kf=kf.data_ptr())
    emulate.launch(lib.riccati_packed_backward_launch, False,
                   _cuda.step_consts(N, dict(h=0.0)), ptrs, B)
    assert riccati.last_route(lib) == ("tensor copies" if B % 4 == 0 else "element copies")
    K_ref, kf_ref = riccati.riccati_backward_packed_plain(*bwd)
    held({"K": ("primal", K, K_ref), "kf": ("primal", kf, kf_ref)}, nan_b)


@pytest.mark.parametrize("call", ["lqr_start", "newton"])
def test_dense_rollout_k9_emulated_matches_plain(cxx, call):
    """K9 (the dense rollout, one thread a scenario, its inputs read through
    the read-only path) on the plain gains, with the clip at the clipped-LQR
    start and without it in a Newton iteration; B=23 leaves a ragged block."""
    B = 23
    lib = riccati._lib(emulate.load("riccati_packed", K8_BUILD))
    p, dx0 = testing.dense_payload(CFG, B, CPU, seed=5)
    args = testing.packed_args(p, dx0, call)
    K, kf = riccati.riccati_backward_packed_plain(*args[:9])
    a, b, r, x0, lo, hi = args[6], args[7], args[8], args[9], args[10], args[11]
    fwd = [None if t is None else t.contiguous() for t in (a, b, r, K, kf, x0, lo, hi)]
    dx = torch.empty(N + 1, 10, B)
    du = torch.empty(N, 4, B)
    names = ("a", "b", "r", "K", "kf", "dx0", "clip_lo", "clip_hi")
    ptrs = riccati._PackedPtrs(**{n: None if t is None else t.data_ptr()
                                  for n, t in zip(names, fwd)}, dx=dx.data_ptr(), du=du.data_ptr())
    emulate.launch(lib.riccati_packed_forward_launch, False,
                   _cuda.step_consts(N, dict(h=0.0)), ptrs, B)
    dx_ref, du_ref = riccati.riccati_forward_packed_plain(*fwd)
    held({"dx": ("primal", dx, dx_ref), "du": ("primal", du, du_ref)})


@pytest.mark.parametrize("B", [1, 23, 24, 27])
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_glue_sweep_k4_emulated_matches_plain(cxx, jac_bf16, B):
    lib = rs._lib(emulate.load("riccati_iter", K4_BUILD))
    lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
    ic = ipm_consts(CFG.ocp, num_iters=3)
    kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, CPU, 2), **lc)
    args = [t.clone().contiguous() for t in testing.iter_args(qp, ic)[:22]]
    nan_b = B // 2 if B > 1 else None
    if nan_b is not None:
        args[7][4, 2, nan_b] = float("nan")  # zx at node 4
    out = {n: torch.empty(s) for n, s in rs._state_shapes(N, B).items()
           if n in ("K", "kf", "rh", "res2")}
    payload = dict(zip(("hq", "gx", "gu", "a", "b", "bc", "r"), args[:7]),
                   lub=args[17], uub=args[18], lxb=args[19], uxb=args[20])
    ptrs = rs._IterPtrs(q=_cuda.QpPtrs(**{n: t.data_ptr() for n, t in payload.items()}),
                        **{n: t.data_ptr() for n, t in zip(rs._STATE, args[7:17])},
                        mu=args[21].data_ptr(), **{n: t.data_ptr() for n, t in out.items()})
    emulate.launch(lib.riccati_backward_launch, jac_bf16, _cuda.step_consts(N, kw), ptrs, B)
    assert rs.last_route(lib) == ("tensor copies" if B % 8 == 0 else "one-thread sweep")
    ref = rs.riccati_backward_glue_plain(*args, **kw)
    held({n: (kind, out[o], r) for (n, kind, o), r in zip(
        (("K", "primal", "K"), ("kf", "primal", "kf"), ("rhat", "primal", "rh"),
         ("res2", "resid", "res2")), ref)}, nan_b)


@pytest.mark.parametrize("B", [1, 23, 24, 27])
@pytest.mark.parametrize("call", ["lqr_start", "unfused_glue"])
@pytest.mark.parametrize("jac_bf16", [False, True])
def test_given_sweep_k6_emulated_matches_plain(cxx, jac_bf16, call, B):
    """K6 (`riccati_sweep_backward`) in both ways the IPM calls it
    (`testing.sweep_args`), on both routes."""
    lib = rs._sweep_lib(emulate.load("riccati_sweep", K6_BUILD))
    lc = lin_consts(CFG.ocp, CFG.vehicle, True, jac_bf16=jac_bf16)
    ic = ipm_consts(CFG.ocp, num_iters=3)
    kw = {k: ic[k] for k in ("h", "diag6_stage", "diag6_term", "rdiag_stage")}
    qp = linearize.linearize_stage_data_plain(*testing.kernel_inputs(B, N, CPU, 3), **lc)
    args = [t.clone().contiguous() for t in testing.sweep_args(qp, ic, call)[0][:13]]
    nan_b = B // 2 if B > 1 else None
    if nan_b is not None:
        args[7][4, 2, nan_b] = float("nan")  # zx at node 4
    out = dict(K=torch.empty(N, 40, B), kf=torch.empty(N, 4, B), rh=torch.empty(N, 10, B))
    rows = ("zx", "zu", "sig_u", "sig_x", "corr_u", "corr_x")
    ptrs = rs._SweepPtrs(q=_cuda.QpPtrs(**{n: t.data_ptr() for n, t in zip(PAYLOAD, args)}),
                         **{n: t.data_ptr() for n, t in zip(rows, args[7:13])},
                         **{n: t.data_ptr() for n, t in out.items()})
    emulate.launch(lib.riccati_sweep_backward_launch, jac_bf16, _cuda.step_consts(N, kw), ptrs, B)
    assert rs.last_sweep_route(lib) == ("tensor copies" if B % 8 == 0 else "one-thread sweep")
    ref = rs.riccati_sweep_backward_plain(*args, **kw)
    held({n: ("primal", out[o], r) for (n, o), r in zip(
        (("K", "K"), ("kf", "kf"), ("rhat", "rh")), ref)}, nan_b)


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("with_dist", [False, True])
@pytest.mark.parametrize("jac_bf16", [False, True])
@pytest.mark.parametrize("B", [1, 23])
def test_linearization_k3_emulated_matches_plain(cxx, B, jac_bf16, with_dist, substeps):
    """K3 (`linearize_stage_data`): every payload entry written (the outputs
    start at 7) and equal to the plain version's; a NaN position of one
    scenario's iterate stays in its gx and r. With 2 substeps it runs its
    other instantiation, where each column replays the later substeps'
    points."""
    lib = linearize._lib(emulate.load("linearize"))
    lc = dict(lin_consts(CFG.ocp, CFG.vehicle, with_dist, jac_bf16=jac_bf16), substeps=substeps)
    ins = [t.clone().contiguous() for t in testing.kernel_inputs(B, N, CPU, 3)]
    nan_b = B // 2 if B > 1 else None
    if nan_b is not None:
        ins[0][4, 2, nan_b] = float("nan")  # xb at node 4
    jd = torch.bfloat16 if jac_bf16 else torch.float32
    out = {n: torch.full(s, 7.0, dtype=jd if n in _cuda.JAC_FIELDS else torch.float32)
           for n, s in _cuda.qp_shapes(N, B).items()}
    ptrs = linearize._LinPtrs(
        **{n: t.data_ptr() for n, t in zip(("xb", "ub", "xr", "ur", "x0"), ins[:4] + ins[5:])},
        fd=ins[4].data_ptr() if with_dist else None,
        q=_cuda.QpPtrs(**{n: t.data_ptr() for n, t in out.items()}))
    emulate.launch(lib.linearize_launch, jac_bf16, _cuda.step_consts(N, lc), ptrs, B)
    ref = linearize.linearize_stage_data_plain(*ins, **lc)
    held({n: ("primal", out[n], r) for n, r in zip(_cuda.QP_FIELDS, ref)}, nan_b)


def test_emulated_geometry_matches_the_python_mirror(cxx):
    """The default builds' C geometry exports equal `_cuda.sweep_geometry`
    and `_cuda.lin_geometry`."""
    k8 = emulate.load("riccati_packed")
    k4 = emulate.load("riccati_iter")
    k6 = emulate.load("riccati_sweep")
    k3 = emulate.load("linearize")
    for B in (1, 7, 8, 301, 4096, 65535, 65536):
        assert riccati.geometry(B, lib=k8) == _cuda.sweep_geometry("packed", B)
        for jac_bf16 in (False, True):
            assert rs.geometry(B, jac_bf16, lib=k4) == _cuda.sweep_geometry("glue", B, jac_bf16)
            assert rs.sweep_geometry(B, jac_bf16, lib=k6) == _cuda.sweep_geometry(
                "given", B, jac_bf16)
        assert linearize.geometry(B, N, lib=k3) == _cuda.lin_geometry(B, N)
