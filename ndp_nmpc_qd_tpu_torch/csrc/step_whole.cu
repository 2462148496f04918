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

#include "step_whole.cuh"

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
