// Fused NDP-NMPC control step for Hopper (sm_90a): linearization of all N
// stages, the whole warm-started interior-point QP and the SQP axpy in one
// launch. Replaces the TPU kernel `ops/pallas/step_whole.py:control_step_whole`
// (body `_step_whole_kernel`).
//
// What bounds it on this card: operations. The step does about 0.39 MFLOP of
// scalar f32 work a scenario (~25.7 GFLOP at B=65536; the Riccati stage core
// x N x 3 iterations dominates) against about 6 KB of unavoidable traffic
// (state in and out plus the tick's inputs), far above the card's 20
// FLOP/byte f32 balance. The work is a recursion of short dependent steps
// per scenario, so the design keeps every intermediate on the SM and gives
// the parallel work inside a scenario to several lanes; measured, the SM
// then runs near its instruction-issue limit, so the code keeps one path per
// phase where it can (tools/time_team_kernels.py reads the phases' cycles).
// No tensor cores: the products are 10x10 f32 per scenario, and TF32 (~10
// mantissa bits) could not hold the f32-payload check's 1e-4 on the iterates
// against f32 arithmetic.
//
// Design: a team of TEAM = 16 lanes (half a warp) a scenario, S scenarios a
// block (ndp_team.cuh). The block copies its S consecutive scenarios'
// inputs (xb, ub, xr, ur, fd, x0, the carried duals and mu) into shared
// memory row by row with cp.async, lanes across scenarios, so every row is
// one contiguous run; each team linearizes its scenario stage-parallel
// straight into its slot (the payload never reaches global memory), runs
// the whole IPM there, and the block writes the duals, mu and eq_res out and
// folds the deltas into xb/ub in place, again row by row. No global
// workspace.
//
// Shared memory: a slot holds the payload (hq, a, b in the jac dtype; the
// rest f32), the IPM scratch (K, kf, rh, slacks, zx, zu), the carried duals,
// the backward stage's work area (P, PA/Qh, PB, S and vectors, which also
// holds dx and du from the rollout to pass B) and the scalars; the region of
// K also holds the step inputs while the linearization runs and the box
// rows' directions from the rollout to pass B. At N=20 that is 16,352 bytes
// a scenario with the bf16 payload (16,448 with the padding that puts
// neighbouring slots 16 banks apart), so S = 14: 224 threads and 230,272
// bytes a block, one block an SM. With the f32 payload 19,824 (19,904): S =
// 11. TEAM = 16 covers the ten rows of a stage's products in one pass;
// TEAM = 8 (NDP_TEAM=8) keeps the same slots a block with half the warps
// and measured slower.
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp_team.cuh"

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
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(ndp::MAX_THREADS, 1)
    step_whole_kernel(const __grid_constant__ ndp::StepPtrs p,
                      const __grid_constant__ ndp::StepConsts c, long long B, int S) {
  using namespace ndp;
  extern __shared__ float4 ndp_smem[];
  team_clock(-1);
  float* const base = reinterpret_cast<float*>(ndp_smem);
  const int N = c.n_stages;
  const TeamLayout L = team_layout(N, (int)sizeof(JT));
  const int st = L.stride;
  const long long b0 = (long long)blockIdx.x * S;
  const bool with_dist = c.with_dist && p.fd;

  const int nx1 = (N + 1) * NX, nu = N * NU, nv = (N + 1) * 3;
  const int k0 = L.K;  // the step inputs, in region K (StepIn's order)
  const Seg<float> in[] = {
      {const_cast<float*>(p.xb), k0, nx1, false},
      {const_cast<float*>(p.ub), k0 + nx1, nu, false},
      {const_cast<float*>(p.xr), k0 + nx1 + nu, nx1, false},
      {const_cast<float*>(p.ur), k0 + 2 * nx1 + nu, nu, false},
      {const_cast<float*>(p.fd), k0 + 2 * nx1 + 2 * nu, with_dist ? nv : 0, false},
      {const_cast<float*>(p.x0), k0 + 2 * nx1 + 2 * nu + nv, NX, false},
      {p.lu_lo, L.lul, nu, false}, {p.lu_up, L.luu, nu, false},
      {p.lx_lo, L.lxl, nv, false}, {p.lx_up, L.lxu, nv, false},
      {p.mu, L.sc + SC_MUW, 1, false},
  };
  stage_in_async(base, st, in, S, b0, B);
  cp_async_wait_all();
  __syncthreads();
  team_clock(CK_STAGE_IN);

  {
    float* slot = base + (threadIdx.x / TEAM) * st;
    const Team<JT> tm = team_at<JT>(slot, L, N);
    team_linearize(tm, step_in(slot + L.K, N), with_dist, c);
    team_ipm(tm, c);
  }
  __syncthreads();

  const Seg<float> out[] = {
      {p.xb, L.zx, nx1, true}, {p.ub, L.zu, nu, true},  // the SQP axpy, in place
      {p.lu_lo, L.lul, nu, false}, {p.lu_up, L.luu, nu, false},
      {p.lx_lo, L.lxl, nv, false}, {p.lx_up, L.lxu, nv, false},
      {p.mu, L.sc + SC_MU, 1, false}, {p.eq, L.sc + SC_EQ, 1, false},
  };
  stage_out(base, st, out, S, b0, B);
  team_clock(CK_STAGE_OUT);
}

template <typename JT>
static int step_whole_launch_t(const ndp::StepConsts* c, const ndp::StepPtrs* p, long long B,
                               cudaStream_t s) {
  const ndp::TeamGeom g = ndp::team_geometry(c->n_stages, (int)sizeof(JT), B);
  if (g.S < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      step_whole_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)g.blocks;
  NDP_LAUNCH(step_whole_kernel<JT>, blocks, g.threads, g.smem, s, *p, *c, B, g.S);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch geometry for the ctypes mirror (ndp::team_geometry_out).
void step_whole_geometry(int n_stages, int jac_bf16, long long B, long long* out) {
  ndp::team_geometry_out(n_stages, jac_bf16, B, out);
}

// Layout check for the ctypes mirrors.
int step_whole_consts_size() { return (int)sizeof(ndp::StepConsts); }
int step_whole_ptrs_size() { return (int)sizeof(ndp::StepPtrs); }

// Launches the step on `stream`; returns the error of the shared-memory
// attribute or cudaGetLastError() after the launch.
int step_whole_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::StepPtrs* p,
                      long long B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return jac_bf16 ? step_whole_launch_t<__nv_bfloat16>(c, p, B, s)
                  : step_whole_launch_t<float>(c, p, B, s);
}

#ifdef NDP_TEAM_CLOCKS
// The phase cycle counts since the last call (ndp::ClockPhase order).
int step_whole_clocks(long long* out) { return ndp::team_clocks_take(out); }
#endif
}  // extern "C"
