// Dense Riccati sweep of the legacy packed path for Hopper (sm_90a), in two
// launches. Replaces the TPU kernels of
// `ops/pallas/riccati.py:riccati_sweep_packed`: the backward sweep
// (`_backward_kernel`, K8) and the forward rollout with its optional control
// clip (`_forward_kernel`, K9). The packed IPM (`solver/qp_ipm_packed.py`)
// calls them once for its clipped-LQR start (zero sig, clip) and once per
// iteration for the Newton direction (sig and the defects rhat, no clip).
//
// The sweep is dense: Hxx, Huu, A and B are read exactly as given (no sparse
// structure), and Hxu is taken as zero, as the TPU kernels take it.
//
// Design: one thread per scenario (128 threads a block, masked at b < B). The
// TPU grid's sequential stage axis, over which the Pallas kernel carried the
// cost-to-go P in VMEM scratch, is the loop inside the thread. P (10x10) and
// the products PA (10x10) and PB (10x4) do not fit in registers beside A, so
// they live in a per-scenario scratch of 240 planes of B floats (batch
// innermost, so neighbouring threads touch neighbouring addresses and the
// traffic stays in L1/L2), in place of the TPU's P_scr. A stage loads A
// once into registers and streams P by rows: PA and PB by rows, then Qh by
// the columns of PA into P's planes (P is dead by then), then S = B^T PA and
// Rh = B^T PB with B reloaded once A is dead, the 4x4 Cholesky with
// reciprocal pivots (`ndp::chol4`) and the 11 solves (`ndp::chol4_solve`),
// and last P <- sym(Qh + S^T K) in place. The forward kernel keeps dx and du
// in registers and reads each stage's A, B, r, K and k once.
//
// NaN: the clip is nmax then nmin (jnp.minimum(jnp.maximum(du, lo), hi)
// propagates NaN; fminf/fmaxf would drop it and let a poisoned solve look
// healthy). Without a clip the bound pointers are null and never read.
//
// What bounds it on this card: bytes. The backward kernel reads the dense
// stage data (Hxx and A are 100 floats a stage) and the barrier terms, about
// 24 KB a scenario, and writes the gains, 3.5 KB; its 20 stages of 10x10
// products are about 150 kflop a scenario, under a third of the time the
// bytes take at f32 rate. The forward kernel reads A, B, r, K, k and the clip
// bounds and writes the rollout, about 17 KB a scenario. The scratch traffic
// (about 3 KB a stage) is not counted in the bound: it is what keeping P out
// of registers costs.
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of both launches, f32, layout (stage, element, B); each kernel
// reads and writes its own subset. Shared with Python (ctypes).
struct PackedPtrs {
  float* hxx;      // (N+1, 100) backward in
  float* sig_x;    // (N+1, 10) full-state diagonal additions
  float* huu;      // (N, 16)
  float* sig_u;    // (N, 4)
  float* gx;       // (N+1, 10) ghat_x
  float* gu;       // (N, 4) ghat_u
  float* a;        // (N, 100) both
  float* b;        // (N, 40) both
  float* r;        // (N, 10) both
  float* K;        // (N, 40) backward out, forward in: K[l][j] at l * 10 + j
  float* kf;       // (N, 4)
  float* ws;       // (240) backward scratch: P, PA, PB
  float* dx0;      // (1, 10) forward in
  float* clip_lo;  // (N, 4) or null: no clip
  float* clip_hi;
  float* dx;       // (N+1, 10) forward out
  float* du;       // (N, 4)
};

constexpr int WS_P = 0, WS_PA = NX * NX, WS_PB = 2 * NX * NX, WS_PLANES = WS_PB + NX * NU;

}  // namespace ndp

__global__ void __launch_bounds__(128)
    riccati_packed_backward_kernel(ndp::PackedPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  const View<float> hxx = at(p.hxx, NX * NX, B, b), sx = at(p.sig_x, NX, B, b);
  const View<float> huu = at(p.huu, NU * NU, B, b), su = at(p.sig_u, NU, B, b);
  const View<float> gx = at(p.gx, NX, B, b), gu = at(p.gu, NU, B, b);
  const View<float> av = at(p.a, NX * NX, B, b), bv = at(p.b, NX * NU, B, b);
  const View<float> rv_ = at(p.r, NX, B, b), Ko = at(p.K, NU * NX, B, b);
  const View<float> ko = at(p.kf, NU, B, b), W = at(p.ws, WS_PLANES, B, b);

  // terminal cost-to-go: P = Hxx_N + diag(sig_N), p = ghat_N
  float pv[NX];
  for (int i = 0; i < NX; ++i) {
    for (int j = 0; j < NX; ++j) {
      float v = hxx(N, i * NX + j);
      if (i == j) v = v + sx(N, i);
      W(0, WS_P + i * NX + j) = v;
    }
    pv[i] = gx(N, i);
  }

  for (int k = N - 1; k >= 0; --k) {
    float Prp[NX];
    {
      // Prp = P r + p; PA = P A and PB = P B by rows of P
      float A[NX][NX], Bm[NX][NU], r[NX];
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) A[i][j] = av(k, i * NX + j);
        for (int l = 0; l < NU; ++l) Bm[i][l] = bv(k, i * NU + l);
        r[i] = rv_(k, i);
      }
      for (int i = 0; i < NX; ++i) {
        float Pi[NX];
        for (int j = 0; j < NX; ++j) Pi[j] = W(0, WS_P + i * NX + j);
        float s = Pi[0] * r[0];
        for (int j = 1; j < NX; ++j) s = s + Pi[j] * r[j];
        Prp[i] = s + pv[i];
        for (int kk = 0; kk < NX; ++kk) {
          float t = Pi[0] * A[0][kk];
          for (int j = 1; j < NX; ++j) t = t + Pi[j] * A[j][kk];
          W(0, WS_PA + i * NX + kk) = t;
        }
        for (int l = 0; l < NU; ++l) {
          float t = Pi[0] * Bm[0][l];
          for (int j = 1; j < NX; ++j) t = t + Pi[j] * Bm[j][l];
          W(0, WS_PB + i * NU + l) = t;
        }
      }
      // Qh = A^T PA + Hxx + diag(sig_x) by columns of PA, into P's planes;
      // qv = ghat_x + A^T Prp (carried in pv, whose old values are spent)
      for (int kk = 0; kk < NX; ++kk) {
        float PAc[NX];
        for (int j = 0; j < NX; ++j) PAc[j] = W(0, WS_PA + j * NX + kk);
        for (int i = 0; i < NX; ++i) {
          float s = A[0][i] * PAc[0];
          for (int j = 1; j < NX; ++j) s = s + A[j][i] * PAc[j];
          float v = s + hxx(k, i * NX + kk);
          if (i == kk) v = v + sx(k, i);
          W(0, WS_P + i * NX + kk) = v;
        }
      }
      for (int i = 0; i < NX; ++i) {
        float s = A[0][i] * Prp[0];
        for (int j = 1; j < NX; ++j) s = s + A[j][i] * Prp[j];
        pv[i] = gx(k, i) + s;
      }
    }

    // S = B^T PA, Rh = B^T PB + Huu + diag(sig_u), rv = ghat_u + B^T Prp
    float S[NU][NX], Rh[4][4], rv[NU];
    {
      float Bm[NX][NU];
      for (int i = 0; i < NX; ++i)
        for (int l = 0; l < NU; ++l) Bm[i][l] = bv(k, i * NU + l);
      for (int kk = 0; kk < NX; ++kk) {
        float PAc[NX];
        for (int j = 0; j < NX; ++j) PAc[j] = W(0, WS_PA + j * NX + kk);
        for (int l = 0; l < NU; ++l) {
          float s = Bm[0][l] * PAc[0];
          for (int j = 1; j < NX; ++j) s = s + Bm[j][l] * PAc[j];
          S[l][kk] = s;
        }
      }
      for (int m = 0; m < NU; ++m) {
        float PBc[NX];
        for (int j = 0; j < NX; ++j) PBc[j] = W(0, WS_PB + j * NU + m);
        for (int l = 0; l < NU; ++l) {
          float s = Bm[0][l] * PBc[0];
          for (int j = 1; j < NX; ++j) s = s + Bm[j][l] * PBc[j];
          float v = s + huu(k, l * NU + m);
          if (l == m) v = v + su(k, l);
          Rh[l][m] = v;
        }
      }
      for (int l = 0; l < NU; ++l) {
        float s = Bm[0][l] * Prp[0];
        for (int j = 1; j < NX; ++j) s = s + Bm[j][l] * Prp[j];
        rv[l] = gu(k, l) + s;
      }
    }

    // K = -Rh^-1 S, k = -Rh^-1 rv
    float L[4][4], Ld[4], rhs[4], sol[4], K[NU][NX], kf[NU];
    chol4(Rh, L, Ld);
    for (int kk = 0; kk < NX; ++kk) {
      for (int l = 0; l < NU; ++l) rhs[l] = S[l][kk];
      chol4_solve(L, Ld, rhs, sol);
      for (int l = 0; l < NU; ++l) K[l][kk] = -sol[l];
    }
    chol4_solve(L, Ld, rv, sol);
    for (int l = 0; l < NU; ++l) kf[l] = -sol[l];
    for (int l = 0; l < NU; ++l) {
      for (int kk = 0; kk < NX; ++kk) Ko(k, l * NX + kk) = K[l][kk];
      ko(k, l) = kf[l];
    }

    // P <- sym(Qh + S^T K) in place; p <- qv + S^T k
    for (int i = 0; i < NX; ++i)
      for (int j = i; j < NX; ++j) {
        const float pij = W(0, WS_P + i * NX + j) +
                          (S[0][i] * K[0][j] + S[1][i] * K[1][j] + S[2][i] * K[2][j] +
                           S[3][i] * K[3][j]);
        const float pji = W(0, WS_P + j * NX + i) +
                          (S[0][j] * K[0][i] + S[1][j] * K[1][i] + S[2][j] * K[2][i] +
                           S[3][j] * K[3][i]);
        const float v = 0.5f * (pij + pji);
        W(0, WS_P + i * NX + j) = v;
        W(0, WS_P + j * NX + i) = v;
      }
    for (int i = 0; i < NX; ++i)
      pv[i] = pv[i] + (S[0][i] * kf[0] + S[1][i] * kf[1] + S[2][i] * kf[2] + S[3][i] * kf[3]);
  }
}

__global__ void __launch_bounds__(128)
    riccati_packed_forward_kernel(ndp::PackedPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  const View<float> av = at(p.a, NX * NX, B, b), bv = at(p.b, NX * NU, B, b);
  const View<float> rv = at(p.r, NX, B, b), Kv = at(p.K, NU * NX, B, b);
  const View<float> kv = at(p.kf, NU, B, b);
  const View<float> lo = at(p.clip_lo, NU, B, b), hi = at(p.clip_hi, NU, B, b);
  const View<float> dxo = at(p.dx, NX, B, b), duo = at(p.du, NU, B, b);
  float dx[NX], du[NU], nxt[NX];
  for (int i = 0; i < NX; ++i) dx[i] = p.dx0[i * B + b];
  for (int k = 0; k < N; ++k) {
    for (int l = 0; l < NU; ++l) {
      float s = Kv(k, l * NX) * dx[0];
      for (int j = 1; j < NX; ++j) s = s + Kv(k, l * NX + j) * dx[j];
      du[l] = s + kv(k, l);
      if (lo.p) du[l] = nmin(nmax(du[l], lo(k, l)), hi(k, l));
    }
    for (int i = 0; i < NX; ++i) dxo(k, i) = dx[i];
    for (int l = 0; l < NU; ++l) duo(k, l) = du[l];
    for (int i = 0; i < NX; ++i) {
      float s = av(k, i * NX) * dx[0];
      for (int j = 1; j < NX; ++j) s = s + av(k, i * NX + j) * dx[j];
      float t = bv(k, i * NU) * du[0];
      for (int l = 1; l < NU; ++l) t = t + bv(k, i * NU + l) * du[l];
      nxt[i] = s + t + rv(k, i);
    }
    for (int i = 0; i < NX; ++i) dx[i] = nxt[i];
  }
  for (int i = 0; i < NX; ++i) dxo(N, i) = dx[i];
}

extern "C" {

int riccati_packed_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_packed_ptrs_size() { return (int)sizeof(ndp::PackedPtrs); }

// Launch the backward / forward kernel on `stream`; return cudaGetLastError().
// f32 only: `jac_bf16` must be 0 (the packed path has no bf16 payload).
int riccati_packed_backward_launch(int jac_bf16, const ndp::StepConsts* c,
                                   const ndp::PackedPtrs* p, long long B, void* stream) {
  if (jac_bf16) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  riccati_packed_backward_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, *c, B);
  return (int)cudaGetLastError();
}

int riccati_packed_forward_launch(int jac_bf16, const ndp::StepConsts* c,
                                  const ndp::PackedPtrs* p, long long B, void* stream) {
  if (jac_bf16) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  riccati_packed_forward_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
