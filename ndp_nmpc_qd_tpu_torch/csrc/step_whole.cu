// Fused NDP-NMPC control step for Hopper (sm_90a): linearization of all N
// stages, the whole warm-started interior-point QP and the SQP axpy in one
// launch. Replaces the TPU kernel `ops/pallas/step_whole.py:control_step_whole`
// (body `_step_whole_kernel`).
//
// Design: one thread per scenario (128 threads a block, ceil(B/128) blocks,
// masked at b < B), each walking the stages in loops as the TPU kernel's
// fori_loops do. The recursion is sequential per scenario (stages x IPM
// iterations), so the batch is the only parallel axis.
//
// What bounds it on this card: operations. Per scenario the step does about
// 0.3 MFLOP of scalar f32 work (the Riccati stage core x N x iterations
// dominates) against about 6 KB of unavoidable traffic (state in and out
// plus the tick's inputs), far above the card's 20 FLOP/byte f32 balance.
// This first version is latency-bound below that: each thread holds P (100
// floats) and the stage temporaries in local arrays that spill, and it keeps
// the stage payload and the IPM scratch in a global workspace in
// (stage, element, B) layout, where the TPU kept them in VMEM. Coalesced
// addressing (neighbouring threads, neighbouring scenarios) keeps that
// traffic in wide transactions, mostly served from L2. Moving the payload
// on-chip is the work of a later version.
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of one launch. State tensors update in place.
struct StepPtrs {
  float* xb;         // (N+1, 10, B) iterates
  float* ub;         // (N, 4, B)
  const float* xr;   // (N+1, 10, B) reference
  const float* ur;   // (N, 4, B)
  const float* fd;   // (N+1, 3, B) downwash forecast, null without it
  const float* x0;   // (1, 10, B) measured state
  float* lu_lo;      // (N, 4, B) carried duals
  float* lu_up;
  float* lx_lo;      // (N+1, 3, B)
  float* lx_up;
  float* mu;         // (B,) barrier weight, < 0 = cold
  float* eq;         // (B,) out: equality residual
  float* ws;         // ws_f32_planes(N) planes of B floats
  void* wj;          // ws_jac_planes(N) planes of B jac-dtype values
};

// The workspace: the payload's f32 fields, then the IPM scratch; the
// curvature fields in the jac dtype.
__host__ __device__ inline int ws_f32_planes(int N) {
  return (N + 1) * NX      // gx
         + N * NU          // gu
         + N * 6           // bc
         + N * NX          // r
         + 2 * N * NU      // lub, uub
         + 2 * (N + 1) * 3 // lxb, uxb
         + NX              // dx0
         + ipm_ws_planes(N);
}

__host__ __device__ inline int ws_jac_planes(int N) {
  return (N + 1) * 16 + N * 40 + N * 30;  // hq, a, b
}

template <typename JT>
__device__ void step_whole_scenario(const StepPtrs& a, const StepConsts& c, long long B,
                                    long long b) {
  const int N = c.n_stages;
  Payload<JT> q;
  Carver<float> cv{a.ws, B, b};
  q.gx = cv.take(N + 1, NX);
  q.gu = cv.take(N, NU);
  q.bc = cv.take(N, 6);
  q.r = cv.take(N, NX);
  q.lub = cv.take(N, NU);
  q.uub = cv.take(N, NU);
  q.lxb = cv.take(N + 1, 3);
  q.uxb = cv.take(N + 1, 3);
  q.dx0 = cv.take(1, NX);
  const IpmScratch s = carve_ipm(cv, N);
  Carver<JT> cj{static_cast<JT*>(a.wj), B, b};
  q.hq = cj.take(N + 1, 16);
  q.a = cj.take(N, 40);
  q.b = cj.take(N, 30);

  // phase 1: linearize every stage into the workspace
  linearize_scenario<JT>(View<const float>{a.xb + b, NX, B}, View<const float>{a.ub + b, NU, B},
                         at(a.xr, NX, B, b), at(a.ur, NU, B, b),
                         at(c.with_dist ? a.fd : nullptr, 3, B, b), at(a.x0, NX, B, b), q, c);

  // phases 2+3: the whole IPM over the workspace payload, axpy folded
  ipm_whole<JT>(q, s, at(a.lu_lo, NU, B, b), at(a.lu_up, NU, B, b), at(a.lx_lo, 3, B, b),
                at(a.lx_up, 3, B, b), a.mu + b, a.eq + b, at(a.xb, NX, B, b),
                at(a.ub, NU, B, b), c);
}

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(128)
    step_whole_kernel(ndp::StepPtrs p, ndp::StepConsts c, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) ndp::step_whole_scenario<JT>(p, c, B, b);
}

extern "C" {

// Workspace planes per scenario: f32 planes of B floats, jac planes of B
// values in the jac dtype.
int step_whole_ws_planes(int n_stages) { return ndp::ws_f32_planes(n_stages); }
int step_whole_jac_planes(int n_stages) { return ndp::ws_jac_planes(n_stages); }

// Layout check for the ctypes mirrors.
int step_whole_consts_size() { return (int)sizeof(ndp::StepConsts); }
int step_whole_ptrs_size() { return (int)sizeof(ndp::StepPtrs); }

// Launches the step on `stream`; returns cudaGetLastError() after the launch.
int step_whole_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::StepPtrs* p,
                      long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    step_whole_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(*p, *c, B);
  else
    step_whole_kernel<float><<<blocks, threads, 0, s>>>(*p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
