// One glue-fused interior-point iteration for Hopper (sm_90a), in two
// launches. Replaces the TPU kernels of
// `ops/pallas/riccati_sparse.py:riccati_iter_fused`: the backward sweep
// (`_backward_kernel_glue`) and the forward rollout (`_forward_kernel_glue`).
//
// Design: one thread per scenario (128 threads a block, masked at b < B) in
// each kernel. The TPU grid's sequential stage axis, over which the Pallas
// kernels carried P and dx in VMEM scratch, becomes a loop inside the
// thread: the backward kernel holds P and p in local arrays over k = N-1..0,
// the forward kernel holds dx over k = 0..N-1 and the terminal node. No
// block depends on another's order. Each thread holds the whole stage sum,
// so the kernels write what `riccati_iter_fused` returns: res2 summed over
// the stages, a_p/a_d min-reduced (2.0 sentinel, NaN-propagating) and
// clamped at 1, comp4 summed over every box row, where the TPU wrapper
// reduced per-stage partial tensors outside its kernels.
//
// What bounds it on this card: bytes, in both kernels. The backward kernel
// does about 88k scalar f32 operations a scenario against about 14.8 KB read
// (payload, iterate, slacks, duals) and written (gains, defects); the
// forward kernel about 14k against about 15.7 KB (payload, gains and state
// in, every direction out). The backward kernel spills P and the stage
// temporaries to local memory (mostly L1/L2) as K1 does; the forward kernel
// does not spill. Loads and stores of both are coalesced across the warp
// (batch innermost).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of both launches; each kernel reads and writes its own subset.
struct IterPtrs {
  QpPtrs q;      // payload (dx0 unused; the forward kernel reads a, b, bc and
                 // the bounds only)
  float* zx;     // (N+1, 10, B) current iterate
  float* zu;     // (N, 4, B)
  float* su_lo;  // (N, 4, B) slacks of the u rows
  float* su_up;
  float* sx_lo;  // (N+1, 3, B) slacks of the v rows
  float* sx_up;
  float* lu_lo;  // (N, 4, B) duals of the u rows
  float* lu_up;
  float* lx_lo;  // (N+1, 3, B) duals of the v rows
  float* lx_up;
  float* mu;       // (B,) barrier weight
  float* dx0_res;  // (1, 10, B) forward: the initial-state residual
  float* K;        // (N, 40, B) backward out, forward in
  float* kf;       // (N, 4, B)
  float* rh;       // (N, 10, B)
  float* res2;     // (B,) backward out: sum of rh^2
  float* dx;       // (N+1, 10, B) forward out
  float* du;       // (N, 4, B)
  float* dsu_lo;   // (N, 4, B)
  float* dsu_up;
  float* dlu_lo;
  float* dlu_up;
  float* dsx_lo;   // (N+1, 3, B)
  float* dsx_up;
  float* dlx_lo;
  float* dlx_up;
  float* ap;       // (B,) step sizes, clamped at 1
  float* ad;
  float* comp4;    // (4, B) complementarity partials
};

__device__ inline Bounds bounds_at(const IterPtrs& p, long long B, long long b) {
  return Bounds{at(p.su_lo, NU, B, b), at(p.su_up, NU, B, b), at(p.sx_lo, 3, B, b),
                at(p.sx_up, 3, B, b),  at(p.lu_lo, NU, B, b), at(p.lu_up, NU, B, b),
                at(p.lx_lo, 3, B, b),  at(p.lx_up, 3, B, b)};
}

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_backward_kernel(ndp::IterPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  p.res2[b] = backward_sweep<JT>(payload_at<JT>(p.q, B, b), at(p.zx, NX, B, b),
                                 at(p.zu, NU, B, b), bounds_at(p, B, b), p.mu[b],
                                 at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
                                 c);
}

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_forward_kernel(ndp::IterPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float dx[NX];
  for (int i = 0; i < NX; ++i) dx[i] = p.dx0_res[i * B + b];
  const Dirs dirs{at(p.dsu_lo, NU, B, b), at(p.dsu_up, NU, B, b), at(p.dlu_lo, NU, B, b),
                  at(p.dlu_up, NU, B, b), at(p.dsx_lo, 3, B, b),  at(p.dsx_up, 3, B, b),
                  at(p.dlx_lo, 3, B, b),  at(p.dlx_up, 3, B, b)};
  const StepAcc acc = forward_pass<JT>(
      payload_at<JT>(p.q, B, b), at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
      at(p.zx, NX, B, b), at(p.zu, NU, B, b), bounds_at(p, B, b), p.mu[b], dx,
      at(p.dx, NX, B, b), at(p.du, NU, B, b), dirs, c);
  p.ap[b] = nmin(acc.ap, 1.0f);
  p.ad[b] = nmin(acc.ad, 1.0f);
  p.comp4[b] = acc.c1;
  p.comp4[B + b] = acc.c2;
  p.comp4[2 * B + b] = acc.c3;
  p.comp4[3 * B + b] = acc.c4;
}

extern "C" {

int riccati_iter_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_iter_ptrs_size() { return (int)sizeof(ndp::IterPtrs); }

// Launch the backward / forward kernel on `stream`; return cudaGetLastError().
int riccati_backward_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IterPtrs* p,
                            long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    riccati_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(*p, *c, B);
  else
    riccati_backward_kernel<float><<<blocks, threads, 0, s>>>(*p, *c, B);
  return (int)cudaGetLastError();
}

int riccati_forward_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IterPtrs* p,
                           long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    riccati_forward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(*p, *c, B);
  else
    riccati_forward_kernel<float><<<blocks, threads, 0, s>>>(*p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
