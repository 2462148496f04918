// One Newton sweep of the structure-sparse Riccati recursion for Hopper
// (sm_90a), in two launches. Replaces the TPU kernels of
// `ops/pallas/riccati_sparse.py:riccati_sweep_sparse`: the backward sweep
// (`_backward_kernel`, K6) with the box rows' Hessian additions sig and
// gradient corrections corr GIVEN as tensors, and the forward rollout
// (`_forward_kernel`, K7) with its optional control clip and its optional
// zero-control ("hold") rollout in the same pass. The IPM calls them for the
// clipped-LQR start (zero iterate, zero sig/corr, clip and hold) and for the
// unfused glue (`fuse_glue=False`: sig/corr from `ipm_corr_terms`).
//
// Design: one thread per scenario (128 threads a block, masked at b < B), as
// K4/K5. The backward kernel runs `ndp::backward_sweep` with the
// `GivenRows` source, the same code K4 runs with `GlueRows`; the forward
// kernel runs `ndp::rollout`, which K5's `forward_pass` runs too. The TPU
// grid's sequential stage axis, over which the Pallas kernels carried P and
// dx in VMEM scratch, is the loop inside the thread.
//
// NaN: the clip is nmax then nmin (jnp.minimum(jnp.maximum(du, lo), hi)
// propagates NaN; fminf/fmaxf would drop it and let a poisoned solve look
// healthy to the recovery screen). `with_hold` is only meaningful at the
// zero iterate, where the defects rh the backward kernel writes equal r;
// nothing here checks that.
//
// What bounds it on this card: bytes. The backward kernel reads the payload,
// the iterate and sig/corr and writes the gains and defects (about 14 KB a
// scenario with the bf16 payload); the forward kernel reads the blocks,
// defects, gains and the clip bounds and writes the rollout (about 10 KB).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of both launches; each kernel reads and writes its own subset.
struct SweepPtrs {
  QpPtrs q;        // payload: hq gx gu a b bc r (backward), a b bc (forward)
  float* zx;       // (N+1, 10, B) iterate
  float* zu;       // (N, 4, B)
  float* sig_u;    // (N, 4, B) box rows' Hessian additions
  float* sig_x;    // (N+1, 3, B)
  float* corr_u;   // (N, 4, B) and gradient corrections
  float* corr_x;   // (N+1, 3, B)
  float* K;        // (N, 40, B) backward out, forward in
  float* kf;       // (N, 4, B)
  float* rh;       // (N, 10, B)
  float* dx0_res;  // (1, 10, B) forward: the initial-state residual
  float* clip_lo;  // (N, 4, B) or null: no clip
  float* clip_hi;
  float* dx;       // (N+1, 10, B) forward out
  float* du;       // (N, 4, B)
  float* dx_hold;  // (N+1, 10, B) or null: no hold rollout
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_sweep_backward_kernel(ndp::SweepPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const GivenRows rows{at(p.sig_u, NU, B, b), at(p.corr_u, NU, B, b), at(p.sig_x, 3, B, b),
                       at(p.corr_x, 3, B, b)};
  backward_sweep<JT>(payload_at<JT>(p.q, B, b), at(p.zx, NX, B, b), at(p.zu, NU, B, b), rows,
                     at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b), c);
}

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_sweep_forward_kernel(ndp::SweepPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  const View<float> lo = at(p.clip_lo, NU, B, b), hi = at(p.clip_hi, NU, B, b);
  const View<float> dxo = at(p.dx, NX, B, b), duo = at(p.du, NU, B, b);
  const View<float> dxho = at(p.dx_hold, NX, B, b);
  const bool hold = dxho.p != nullptr;
  float dx[NX], dxh[NX];
  for (int i = 0; i < NX; ++i) {
    dx[i] = p.dx0_res[i * B + b];
    dxh[i] = dx[i];
  }
  rollout(
      payload_at<JT>(p.q, B, b), at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
      dx, c,
      [&](int k, const float* x, float* du) {
        if (lo.p)
          for (int l = 0; l < NU; ++l) du[l] = nmin(nmax(du[l], lo(k, l)), hi(k, l));
        for (int i = 0; i < NX; ++i) dxo(k, i) = x[i];
        for (int l = 0; l < NU; ++l) duo(k, l) = du[l];
      },
      [&](int k, const Blocks& m, const float* rk) {
        if (!hold) return;
        float nxt[NX];
        for (int i = 0; i < NX; ++i) dxho(k, i) = dxh[i];
        dyn_step(m, rk, c.h, dxh, nullptr, nxt);
        for (int i = 0; i < NX; ++i) dxh[i] = nxt[i];
      });
  for (int i = 0; i < NX; ++i) dxo(N, i) = dx[i];
  if (hold)
    for (int i = 0; i < NX; ++i) dxho(N, i) = dxh[i];
}

extern "C" {

int riccati_sweep_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_sweep_ptrs_size() { return (int)sizeof(ndp::SweepPtrs); }

// Launch the backward / forward kernel on `stream`; return cudaGetLastError().
int riccati_sweep_backward_launch(int jac_bf16, const ndp::StepConsts* c,
                                  const ndp::SweepPtrs* p, long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    NDP_LAUNCH(riccati_sweep_backward_kernel<__nv_bfloat16>, blocks, threads, 0, s, *p, *c, B);
  else
    NDP_LAUNCH(riccati_sweep_backward_kernel<float>, blocks, threads, 0, s, *p, *c, B);
  return (int)cudaGetLastError();
}

int riccati_sweep_forward_launch(int jac_bf16, const ndp::StepConsts* c,
                                 const ndp::SweepPtrs* p, long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    NDP_LAUNCH(riccati_sweep_forward_kernel<__nv_bfloat16>, blocks, threads, 0, s, *p, *c, B);
  else
    NDP_LAUNCH(riccati_sweep_forward_kernel<float>, blocks, threads, 0, s, *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
