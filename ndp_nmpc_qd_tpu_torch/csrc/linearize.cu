// Stage linearization for Hopper (sm_90a): the SparseQp payload of every
// scenario at its RTI iterates. Replaces the TPU kernel
// `ops/pallas/linearize.py:linearize_stage_data` (body `_lin_kernel`).
//
// Design: one thread per scenario (128 threads a block, masked at b < B)
// walks the N stages in a loop (the TPU kernel's sequential stage grid axis)
// and writes the full (N+1, ., B) tensors itself: the terminal hq/gx and the
// +-big velocity rows of nodes 0 and N, which the TPU wrapper concatenated
// outside its kernel. The arithmetic is K1's phase 1 (`linearize_scenario`
// in ndp.cuh), so K1 and K3 compute the same payload.
//
// What bounds it on this card: bytes. A scenario costs about 59k scalar f32
// operations (the RK4 step and its 8 tangent columns, ~3k a stage) against
// about 9.7 KB of inputs read and payload written (bf16 curvature): at
// B=65536, ~0.19 ms of memory traffic against ~0.06 ms of arithmetic. The
// thread keeps its tangents (80 floats) and RK4 points in registers without
// spilling; every load and store is coalesced across the warp (batch
// innermost).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of one launch: the iterates and the tick's inputs in, the payload
// out.
struct LinPtrs {
  const float* xb;  // (N+1, 10, B)
  const float* ub;  // (N, 4, B)
  const float* xr;  // (N+1, 10, B)
  const float* ur;  // (N, 4, B)
  const float* fd;  // (N+1, 3, B) downwash forecast, null without it
  const float* x0;  // (1, 10, B)
  QpPtrs q;         // out
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(128)
    linearize_kernel(ndp::LinPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  linearize_scenario<JT>(at(p.xb, NX, B, b), at(p.ub, NU, B, b), at(p.xr, NX, B, b),
                         at(p.ur, NU, B, b), at(c.with_dist ? p.fd : nullptr, 3, B, b),
                         at(p.x0, NX, B, b), payload_at<JT>(p.q, B, b), c);
}

extern "C" {

int linearize_consts_size() { return (int)sizeof(ndp::StepConsts); }
int linearize_ptrs_size() { return (int)sizeof(ndp::LinPtrs); }

// Launches the linearization on `stream`; returns cudaGetLastError().
int linearize_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::LinPtrs* p, long long B,
                     void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    NDP_LAUNCH(linearize_kernel<__nv_bfloat16>, blocks, threads, 0, s, *p, *c, B);
  else
    NDP_LAUNCH(linearize_kernel<float>, blocks, threads, 0, s, *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
