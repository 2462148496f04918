// The whole warm-started interior-point QP for Hopper (sm_90a), over a
// stored SparseQp payload. Replaces the TPU kernel
// `ops/pallas/ipm_whole.py:riccati_ipm_whole` (body `_ipm_whole_kernel`).
//
// Design: one thread per scenario (128 threads a block, masked at b < B)
// runs `ndp::ipm_whole` (ndp.cuh), the body K1 runs after its
// linearization: zero-control start, slack init and dual warm mixing, then
// per iteration a backward Riccati sweep and the two forward passes, all in
// loops inside the thread. The payload views point at the caller's tensors;
// the IPM scratch (gains, slacks, directions) and the primal deltas live in a
// workspace of `ipm_whole_ws_planes(N)` planes of B floats allocated once per
// batch size by the caller. The carried duals and mu update in place, as the
// TPU kernel's input/output aliases do. With xb/ub the SQP axpy is folded
// into them (in place); without them the deltas go to zx/zu.
//
// What bounds it on this card: operations. A scenario's solve (3 iterations)
// costs about 330k scalar f32 operations, mostly the Riccati stage core,
// against about 11.7 KB of payload, duals and iterates read and written once.
// This first version is latency-bound far above that: P and the stage
// temporaries spill to local memory and the scratch round-trips through
// global memory (coalesced, mostly L2), where the TPU kept it in VMEM.
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of one launch.
struct IpmPtrs {
  QpPtrs q;      // payload in
  float* lu_lo;  // (N, 4, B) carried duals, in place
  float* lu_up;
  float* lx_lo;  // (N+1, 3, B)
  float* lx_up;
  float* mu;     // (B,) barrier weight, < 0 = cold; in place
  float* xb;     // (N+1, 10, B) iterates, in place; null: no fold
  float* ub;     // (N, 4, B)
  float* zx;     // (N+1, 10, B) out without the fold
  float* zu;     // (N, 4, B)
  float* eq;     // (B,) out: equality residual
  float* ws;     // ipm_ws_planes(N) planes of B floats
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(128)
    ipm_whole_kernel(ndp::IpmPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  Carver<float> cv{p.ws, B, b};
  IpmScratch s = carve_ipm(cv, N);
  if (!p.xb) {
    s.zx = at(p.zx, NX, B, b);
    s.zu = at(p.zu, NU, B, b);
  }
  ipm_whole<JT>(payload_at<JT>(p.q, B, b), s, at(p.lu_lo, NU, B, b), at(p.lu_up, NU, B, b),
                at(p.lx_lo, 3, B, b), at(p.lx_up, 3, B, b), p.mu + b, p.eq + b,
                at(p.xb, NX, B, b), at(p.ub, NU, B, b), c);
}

extern "C" {

int ipm_whole_ws_planes(int n_stages) { return ndp::ipm_ws_planes(n_stages); }
int ipm_whole_consts_size() { return (int)sizeof(ndp::StepConsts); }
int ipm_whole_ptrs_size() { return (int)sizeof(ndp::IpmPtrs); }

// Launches the solve on `stream`; returns cudaGetLastError().
int ipm_whole_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IpmPtrs* p, long long B,
                     void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    ipm_whole_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(*p, *c, B);
  else
    ipm_whole_kernel<float><<<blocks, threads, 0, s>>>(*p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
