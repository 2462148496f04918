"""Dense Riccati sweep of the legacy packed path: CUDA kernel wrappers and
plain versions.

Port of `ndp_nmpc_qd_tpu/ops/pallas/riccati.py` (`riccati_sweep_packed` and
its 4x4 Cholesky helpers `_chol4`, `_chol4_solve`, which the sparse sweeps of
`riccati_sparse.py` share).

- `riccati_sweep_packed` is one dense tv-LQR sweep in two launches:
  `riccati_backward_packed` (K8, the TPU's `_backward_kernel`) and
  `riccati_forward_packed` (K9, `_forward_kernel`), CUDA in
  `csrc/riccati_packed.cu`.
- For CUDA tensors each wrapper launches its hand-written kernel (built at
  first use) or raises, and counts its launches in `.launches`; for CPU
  tensors each runs its plain version (f32 or f64).
- Layout (stage, element, B) with the batch innermost: a 10x10 block is
  100 elements in row-major order, the gains K (N, 40, B) are K[l][j] at
  l * 10 + j. The TPU's SUB/LANE blocking and block padding are not carried
  over.

The dense sweep takes Hxx, Huu, A and B exactly as given (no sparse
structure) and assumes Hxu == 0, which holds for this OCP (diagonal W, no
state/control coupling in the residual), as the TPU kernels do.

The plain versions contract the stage matrices with `torch.einsum` where the
kernels sum element by element; the two differ by the order of the sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

NX = 10
NU = 4


def chol4(R):
    """Cholesky of a 4x4 SPD matrix; returns (lower L, reciprocal diagonal).
    R is indexed R[i][j]; its entries may be tensors of any one shape."""
    L = [[None] * 4 for _ in range(4)]
    Ld = [None] * 4
    for i in range(4):
        for j in range(i + 1):
            s = R[i][j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            if i == j:
                L[i][j] = torch.sqrt(s)
                Ld[i] = 1.0 / L[i][j]
            else:
                L[i][j] = s * Ld[j]
    return L, Ld


def chol4_solve(L_Ld, rhs_cols):
    """Solve (L L^T) X = rhs for each column (list of 4 elements; an element
    may carry extra leading dimensions, so one call solves many columns)."""
    L, Ld = L_Ld
    out = []
    for col in rhs_cols:
        y = [None] * 4
        for i in range(4):
            s = col[i]
            for t in range(i):
                s = s - L[i][t] * y[t]
            y[i] = s * Ld[i]
        x = [None] * 4
        for i in reversed(range(4)):
            s = y[i]
            for t in range(i + 1, 4):
                s = s - L[t][i] * x[t]
            x[i] = s * Ld[i]
        out.append(x)
    return out


def _plus_diag(M, d):
    """M (n, n, B) with d (n, B) added on its diagonal (a new tensor)."""
    M = M.clone()
    M.diagonal(dim1=0, dim2=1).add_(d.T)
    return M


def riccati_backward_packed_plain(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r):
    """The same function as the K8 kernel: the backward Riccati sweep of the
    equality-constrained tv-LQR, stages N-1..0, from P = Hxx_N +
    diag(sig_x,N), p = ghat_x,N. Per stage: Prp = P r + p, PA, PB,
    Qh = Hxx + diag(sig_x) + A^T PA, S = B^T PA, Rh = Huu + diag(sig_u) +
    B^T PB, qv = ghat_x + A^T Prp, rv = ghat_u + B^T Prp; the gains
    K = -Rh^-1 S, k = -Rh^-1 rv by a 4x4 Cholesky with reciprocal pivots;
    P <- sym(Qh + S^T K), p <- qv + S^T k.

    Shapes: hxx (N+1,100,B), sig_x (N+1,10,B), huu (N,16,B), sig_u (N,4,B),
    ghat_x (N+1,10,B), ghat_u (N,4,B), a (N,100,B), b (N,40,B), r
    (N,10,B). Returns (K (N,40,B), kf (N,4,B))."""
    N, _, B = a.shape
    ein = torch.einsum
    P = _plus_diag(hxx[N].reshape(NX, NX, B), sig_x[N])
    p = ghat_x[N]
    K = torch.empty((N, NU * NX, B), dtype=a.dtype, device=a.device)
    kf = torch.empty((N, NU, B), dtype=a.dtype, device=a.device)
    for k in reversed(range(N)):
        A = a[k].reshape(NX, NX, B)
        Bm = b[k].reshape(NX, NU, B)
        Prp = ein("ijb,jb->ib", P, r[k]) + p
        PA = ein("ijb,jkb->ikb", P, A)
        PB = ein("ijb,jlb->ilb", P, Bm)
        Qh = _plus_diag(ein("jib,jkb->ikb", A, PA) + hxx[k].reshape(NX, NX, B), sig_x[k])
        S = ein("jlb,jkb->lkb", Bm, PA)
        Rh = _plus_diag(ein("jlb,jmb->lmb", Bm, PB) + huu[k].reshape(NU, NU, B), sig_u[k])
        qv = ghat_x[k] + ein("jib,jb->ib", A, Prp)
        rv = ghat_u[k] + ein("jlb,jb->lb", Bm, Prp)
        # the 10 columns of S and rv, solved together: entries (11, B)
        sol = torch.stack(chol4_solve(chol4(Rh), [torch.cat([S, rv[:, None]], dim=1)])[0])
        Kk, kk = -sol[:, :NX], -sol[:, NX]
        Pn = Qh + ein("lib,ljb->ijb", S, Kk)
        P = 0.5 * (Pn + Pn.transpose(0, 1))
        p = qv + ein("lib,lb->ib", S, kk)
        K[k] = Kk.reshape(NU * NX, B)
        kf[k] = kk
    return K, kf


def riccati_forward_packed_plain(a, b, r, K, kf, dx0, clip_lo=None, clip_hi=None):
    """The same function as the K9 kernel: the rollout du = K dx + k, clipped
    to [clip_lo, clip_hi] (N,4,B) where given (NaN propagates), then
    dx' = A dx + B du + r, from dx0 (1,10,B). Returns (dx (N+1,10,B),
    du (N,4,B))."""
    N, _, B = a.shape
    ein = torch.einsum
    dx = dx0[0]
    dxs, dus = [dx], []
    for k in range(N):
        du = ein("ljb,jb->lb", K[k].reshape(NU, NX, B), dx) + kf[k]
        if clip_lo is not None:
            du = torch.minimum(torch.maximum(du, clip_lo[k]), clip_hi[k])
        dx = (ein("ijb,jb->ib", a[k].reshape(NX, NX, B), dx)
              + ein("ilb,lb->ib", b[k].reshape(NX, NU, B), du) + r[k])
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs), torch.stack(dus)


# ---- the kernels ----

class _PackedPtrs(ctypes.Structure):
    """Mirror of `ndp::PackedPtrs` (csrc/riccati_packed.cu)."""

    _fields_ = _cuda.pointers((
        "hxx", "sig_x", "huu", "sig_u", "gx", "gu", "a", "b", "r", "K", "kf",
        "dx0", "clip_lo", "clip_hi", "dx", "du",
    ))


def _lib(lib=None):
    return _cuda.bind(
        "riccati_packed", _PackedPtrs,
        ("riccati_packed_backward_launch", "riccati_packed_forward_launch"),
        "riccati_packed_backward_geometry", lib=lib,
    )


def geometry(B: int, lib=None) -> dict:
    """K8's launch geometry as its library computes it (mirrored by
    `_cuda.sweep_geometry("packed", B)`)."""
    return _cuda.c_geometry(_lib(lib).riccati_packed_backward_geometry, B, 0, False)


ROUTES = ("element copies", "tensor copies")  # K8's staging, by its C route code


def last_route(lib=None) -> str:
    """How K8's last launch from `lib` (None: the default build) moved its
    rows: "tensor copies" (B a multiple of 4, every tensor on 16 bytes) or
    "element copies" (every thread, element by element)."""
    code = _lib(lib).riccati_packed_backward_route()
    return ROUTES[code] if code >= 0 else "none"


def _launch(fn_name, tensors: dict, a, lib=None):
    """Check every tensor (f32, contiguous, on a's card) and launch from
    `lib` (a build of csrc/riccati_packed.cu; None: the default build)."""
    _cuda.need_cuda("riccati_sweep_packed", a)
    N, _, B = a.shape
    shapes = dict(
        hxx=(N + 1, NX * NX, B), sig_x=(N + 1, NX, B), huu=(N, NU * NU, B), sig_u=(N, NU, B),
        gx=(N + 1, NX, B), gu=(N, NU, B), a=(N, NX * NX, B), b=(N, NX * NU, B), r=(N, NX, B),
        K=(N, NU * NX, B), kf=(N, NU, B), dx0=(1, NX, B),
        clip_lo=(N, NU, B), clip_hi=(N, NU, B), dx=(N + 1, NX, B), du=(N, NU, B),
    )
    for name, t in tensors.items():
        if t is not None:
            _cuda.check(name, t, shapes[name], a.device)
    ptrs = _PackedPtrs(**{n: _cuda.ptr(t) for n, t in tensors.items()})
    _cuda.launch(getattr(_lib(lib), fn_name), False, _cuda.step_consts(N, dict(h=0.0)), ptrs, B,
                 a.device)


def riccati_backward_packed(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r):
    """K8, the dense backward sweep, one kernel launch; arguments and
    results as `riccati_backward_packed_plain`, f32 on the card. Counts its
    launches in `riccati_backward_packed.launches`."""
    if a.device.type == "cpu":
        return riccati_backward_packed_plain(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r)
    out = backward_packed_launch(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r)
    riccati_backward_packed.launches += 1
    return out


def backward_packed_launch(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r, lib=None):
    """Launch K8 from `lib` (a build of csrc/riccati_packed.cu, such as a
    variant of `_build.load`; None: the default build) on CUDA tensors and
    return (K, kf); counts nothing."""
    N, _, B = a.shape
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=a.device)
    K, kf = new(N, NU * NX, B), new(N, NU, B)
    _launch("riccati_packed_backward_launch", dict(
        hxx=hxx, sig_x=sig_x, huu=huu, sig_u=sig_u, gx=ghat_x, gu=ghat_u, a=a, b=b, r=r,
        K=K, kf=kf), a, lib)
    return K, kf


def riccati_forward_packed(a, b, r, K, kf, dx0, clip_lo=None, clip_hi=None):
    """K9, the rollout with the optional clip, one kernel launch; arguments
    and results as `riccati_forward_packed_plain`. Without a clip no bound
    is read (null pointers). Counts its launches in
    `riccati_forward_packed.launches`."""
    if a.device.type == "cpu":
        return riccati_forward_packed_plain(a, b, r, K, kf, dx0, clip_lo, clip_hi)
    if (clip_lo is None) != (clip_hi is None):
        raise ValueError("riccati_forward_packed: give both clip bounds or neither")
    N, _, B = a.shape
    dx = torch.empty((N + 1, NX, B), dtype=torch.float32, device=a.device)
    du = torch.empty((N, NU, B), dtype=torch.float32, device=a.device)
    _launch("riccati_packed_forward_launch", dict(
        a=a, b=b, r=r, K=K, kf=kf, dx0=dx0, clip_lo=clip_lo, clip_hi=clip_hi, dx=dx, du=du), a)
    riccati_forward_packed.launches += 1
    return dx, du


riccati_backward_packed.launches = 0
riccati_forward_packed.launches = 0


def riccati_sweep_packed(
    hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r, dx0, clip_lo=None, clip_hi=None,
):
    """One dense tv-LQR sweep (two launches on CUDA tensors: K8, K9).

    Shapes: hxx (N+1,100,B), sig_x (N+1,10,B) full-state diagonal additions,
    huu (N,16,B), sig_u (N,4,B), ghat_x (N+1,10,B), ghat_u (N,4,B), a
    (N,100,B), b (N,40,B), r (N,10,B), dx0 (1,10,B), clip_lo/hi (N,4,B) or
    None. Returns (dx (N+1,10,B), du (N,4,B))."""
    K, kf = riccati_backward_packed(hxx, sig_x, huu, sig_u, ghat_x, ghat_u, a, b, r)
    return riccati_forward_packed(a, b, r, K, kf, dx0, clip_lo, clip_hi)
